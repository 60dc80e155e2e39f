"""The process metrics registry: counters, gauges, histograms
(counterpart of ``lightgbm_tpu/obs/metrics.py``).

One instrument model for training, serving and the data plane:

- serving keeps a registry per ``Server`` (tests read per-server
  counters), and each server attaches it to the process registry as a
  named component (``attach_child``), so a process-wide snapshot sees
  it;
- training's gauges and counters (trees/s, the resolved arm, the
  planner's predicted peak and budget, chunk sizes, collective
  payloads) and the data plane's (stream passes and blocks, bulk
  blocks) land directly on ``global_registry``.

Two export formats, both the JAX package's byte for byte: ``to_dict()``
(``counters``/``gauges``/``histograms``, plus ``components`` when
children are attached) and ``to_prometheus()`` (the text exposition
format, cumulative buckets), so a dashboard or scraper built for
``lightgbm_tpu`` reads the port's output unchanged.

Instruments are deliberately simple: a histogram is fixed upper-bound
buckets plus count/sum/min/max.  Every mutation takes the owning
registry's single lock; nothing here touches a torch tensor.  Stdlib
only.
"""

from __future__ import annotations

import json
import math
import re
import threading
from typing import Dict, List, Optional, Sequence

# default latency bucket upper bounds, milliseconds (log-ish ladder)
LATENCY_BUCKETS_MS = (0.5, 1.0, 2.0, 5.0, 10.0, 20.0, 50.0, 100.0,
                      200.0, 500.0, 1000.0, 2000.0, 5000.0, math.inf)
# fill-ratio buckets: deciles of rows / bucket_capacity
RATIO_BUCKETS = (0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9, 1.0)


class Counter:
    """Monotonic counter."""

    def __init__(self, lock: threading.Lock):
        self._lock = lock
        self._value = 0

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self) -> int:
        with self._lock:
            return self._value


class Gauge:
    """Last-set value (numeric or short string, e.g. a model digest)."""

    def __init__(self, lock: threading.Lock):
        self._lock = lock
        self._value = 0

    def set(self, v) -> None:
        with self._lock:
            self._value = v

    @property
    def value(self):
        with self._lock:
            return self._value


class Histogram:
    """Fixed-bucket histogram with count/sum/min/max.

    ``buckets`` are inclusive upper bounds in ascending order; the last
    bound may be +inf (it is reported as the string "inf" in JSON).
    """

    def __init__(self, lock: threading.Lock,
                 buckets: Sequence[float] = LATENCY_BUCKETS_MS):
        self._lock = lock
        self.bounds: List[float] = list(buckets)
        if self.bounds[-1] != math.inf:
            self.bounds.append(math.inf)
        self._counts = [0] * len(self.bounds)
        self._count = 0
        self._sum = 0.0
        self._min = math.inf
        self._max = -math.inf

    def observe(self, v: float) -> None:
        with self._lock:
            self._count += 1
            self._sum += v
            if v < self._min:
                self._min = v
            if v > self._max:
                self._max = v
            for i, b in enumerate(self.bounds):
                if v <= b:
                    self._counts[i] += 1
                    break

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    def snapshot(self) -> dict:
        with self._lock:
            if self._count == 0:
                return {"count": 0, "sum": 0.0}
            return {
                "count": self._count,
                "sum": round(self._sum, 6),
                "mean": round(self._sum / self._count, 6),
                "min": round(self._min, 6),
                "max": round(self._max, 6),
                "buckets": {
                    ("inf" if math.isinf(b) else repr(b)): c
                    for b, c in zip(self.bounds, self._counts) if c
                },
            }

    def cumulative(self) -> tuple:
        """(list of (upper_bound, cumulative_count), sum, count) — the
        Prometheus exposition shape (buckets are cumulative there)."""
        with self._lock:
            out, running = [], 0
            for b, c in zip(self.bounds, self._counts):
                running += c
                out.append((b, running))
            return out, self._sum, self._count


def _prom_name(name: str, prefix: str = "") -> str:
    """Sanitize an instrument name into a legal Prometheus metric name."""
    s = re.sub(r"[^a-zA-Z0-9_:]", "_", name)
    if prefix:
        s = f"{prefix}_{s}"
    if s and s[0].isdigit():
        s = "_" + s
    return s


def _esc_label(v) -> str:
    # Prometheus text format: backslash, quote AND line feed must be
    # escaped in label values or one bad value splits the sample across
    # lines and the scraper rejects the whole exposition
    return (str(v).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _labels_suffix(labels: Optional[dict]) -> str:
    """Canonical ``{k="v",...}`` series suffix (sorted keys) — also the
    instrument-key suffix, so the same (name, labels) pair always
    resolves to the same instrument."""
    if not labels:
        return ""
    inner = ",".join(f'{k}="{_esc_label(v)}"'
                     for k, v in sorted(labels.items()))
    return "{" + inner + "}"


def _series(name: str, labels: Optional[dict],
            extra: Optional[dict] = None) -> str:
    """One exposition sample name: metric name + merged label set
    (instrument labels first, then per-sample ones like ``le``)."""
    merged = dict(labels or {})
    if extra:
        merged.update(extra)
    return name + _labels_suffix(merged)


class MetricsRegistry:
    """Named instrument registry; ``counter``/``gauge``/``histogram`` are
    get-or-create so call sites never race on registration.  Child
    registries (``attach_child``) appear in snapshots as components.

    ``labels={"model": "ranker"}`` creates a LABELLED series of the same
    metric (the serving fleet's per-model instruments): distinct label
    values are distinct instruments, keyed ``name{k="v"}``.  Unlabelled
    instruments keep their exact historical keys in ``to_dict`` — the
    labelled series appear ADDITIVELY under their suffixed keys — and
    ``to_prometheus`` emits proper label sets (one # TYPE line per
    metric name, per-sample labels like ``le`` merged in)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._reg_lock = threading.Lock()
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._histograms: Dict[str, Histogram] = {}
        self._children: Dict[str, "MetricsRegistry"] = {}
        # key -> (bare name, labels dict) for labelled series only
        self._meta: Dict[str, tuple] = {}

    def _key(self, name: str, labels: Optional[dict]) -> str:
        if not labels:
            return name
        key = name + _labels_suffix(labels)
        self._meta.setdefault(key, (name, dict(labels)))
        return key

    def counter(self, name: str, labels: Optional[dict] = None) -> Counter:
        with self._reg_lock:
            key = self._key(name, labels)
            if key not in self._counters:
                self._counters[key] = Counter(self._lock)
            return self._counters[key]

    def gauge(self, name: str, labels: Optional[dict] = None) -> Gauge:
        with self._reg_lock:
            key = self._key(name, labels)
            if key not in self._gauges:
                self._gauges[key] = Gauge(self._lock)
            return self._gauges[key]

    def histogram(self, name: str,
                  buckets: Sequence[float] = LATENCY_BUCKETS_MS,
                  labels: Optional[dict] = None) -> Histogram:
        with self._reg_lock:
            key = self._key(name, labels)
            if key not in self._histograms:
                self._histograms[key] = Histogram(self._lock, buckets)
            return self._histograms[key]

    # ----------------------------------------------------------- components

    def attach_child(self, name: str, child: "MetricsRegistry") -> str:
        """Register a component registry (e.g. one serving Server) under
        ``name``; a taken name gets a numeric suffix.  Returns the name
        actually used (pass it to ``detach_child``)."""
        with self._reg_lock:
            key, i = name, 1
            while key in self._children:
                i += 1
                key = f"{name}_{i}"
            self._children[key] = child
            return key

    def detach_child(self, name: str) -> None:
        with self._reg_lock:
            self._children.pop(name, None)

    def children(self) -> Dict[str, "MetricsRegistry"]:
        with self._reg_lock:
            return dict(self._children)

    # -------------------------------------------------------------- export

    def to_dict(self) -> dict:
        """JSON-ready snapshot (the JAX package's layout: ``components``
        appears only when child registries are attached)."""
        with self._reg_lock:
            counters = dict(self._counters)
            gauges = dict(self._gauges)
            hists = dict(self._histograms)
            children = dict(self._children)
        out = {
            "counters": {k: c.value for k, c in sorted(counters.items())},
            "gauges": {k: g.value for k, g in sorted(gauges.items())},
            "histograms": {k: h.snapshot() for k, h in sorted(hists.items())},
        }
        if children:
            out["components"] = {k: c.to_dict()
                                 for k, c in sorted(children.items())}
        return out

    def dump_json(self, path: Optional[str] = None, indent: int = 1) -> str:
        s = json.dumps(self.to_dict(), indent=indent, sort_keys=True)
        if path is not None:
            # operators read these snapshots back; the atomic seam means
            # a scrape never sees a half-written one
            from ..utils.file_io import write_atomic
            write_atomic(path, s)
        return s

    def to_prometheus(self, prefix: str = "lgbt") -> str:
        """Prometheus text exposition (version 0.0.4) of every instrument,
        children included (component name joins the prefix).  Non-numeric
        gauges (model digests) export as ``<name>_info{value="..."} 1``.
        """
        with self._reg_lock:
            counters = dict(self._counters)
            gauges = dict(self._gauges)
            hists = dict(self._histograms)
            children = dict(self._children)
            meta = dict(self._meta)
        lines: List[str] = []
        typed: set = set()      # one # TYPE line per metric name

        def head(key):
            name, labels = meta.get(key, (key, None))
            return _prom_name(name, prefix), labels

        def declare(n, kind):
            if n not in typed:
                typed.add(n)
                lines.append(f"# TYPE {n} {kind}")

        for k, c in sorted(counters.items()):
            n, labels = head(k)
            declare(n, "counter")
            lines.append(f"{_series(n, labels)} {c.value}")
        for k, g in sorted(gauges.items()):
            n, labels = head(k)
            v = g.value
            if isinstance(v, bool):
                v = int(v)
            if isinstance(v, (int, float)) and math.isfinite(v):
                declare(n, "gauge")
                lines.append(f"{_series(n, labels)} {v}")
            else:
                declare(f"{n}_info", "gauge")
                lines.append(
                    f"{_series(n + '_info', labels, {'value': v})} 1")
        for k, h in sorted(hists.items()):
            n, labels = head(k)
            cum, total, count = h.cumulative()
            declare(n, "histogram")
            for bound, c in cum:
                le = "+Inf" if math.isinf(bound) else repr(float(bound))
                lines.append(
                    f"{_series(n + '_bucket', labels, {'le': le})} {c}")
            lines.append(f"{_series(n + '_sum', labels)} {total}")
            lines.append(f"{_series(n + '_count', labels)} {count}")
        for name, child in sorted(children.items()):
            lines.append(child.to_prometheus(
                prefix=_prom_name(name, prefix)).rstrip("\n"))
        return "\n".join(lines) + "\n"


# THE process registry: training and data-plane instruments land here and
# serving Servers attach their per-server registries as components.
global_registry = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    return global_registry
