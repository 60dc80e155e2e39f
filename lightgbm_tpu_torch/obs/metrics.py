"""Counters, gauges and histograms for the serving path (counterpart of
the ``Counter``/``Gauge``/``Histogram``/``MetricsRegistry`` surface of
``lightgbm_tpu/obs/metrics.py``).

``MetricsRegistry.to_dict()`` keeps the JAX package's key layout
(``counters``/``gauges``/``histograms``), so a dashboard reads either
package's snapshot the same way.  A histogram is fixed upper-bound
buckets plus count/sum/min/max; every mutation takes the owning
registry's single lock.  Stdlib only.
"""

from __future__ import annotations

import json
import math
import os
import tempfile
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


class MetricsRegistry:
    """Named instrument registry; ``counter``/``gauge``/``histogram`` are
    get-or-create so call sites never race on registration."""

    def __init__(self):
        self._lock = threading.Lock()
        self._reg_lock = threading.Lock()
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._histograms: Dict[str, Histogram] = {}

    def counter(self, name: str) -> Counter:
        with self._reg_lock:
            if name not in self._counters:
                self._counters[name] = Counter(self._lock)
            return self._counters[name]

    def gauge(self, name: str) -> Gauge:
        with self._reg_lock:
            if name not in self._gauges:
                self._gauges[name] = Gauge(self._lock)
            return self._gauges[name]

    def histogram(self, name: str,
                  buckets: Sequence[float] = LATENCY_BUCKETS_MS) -> Histogram:
        with self._reg_lock:
            if name not in self._histograms:
                self._histograms[name] = Histogram(self._lock, buckets)
            return self._histograms[name]

    def to_dict(self) -> dict:
        """JSON-ready snapshot: ``counters``/``gauges``/``histograms``."""
        with self._reg_lock:
            counters = dict(self._counters)
            gauges = dict(self._gauges)
            hists = dict(self._histograms)
        return {
            "counters": {k: c.value for k, c in sorted(counters.items())},
            "gauges": {k: g.value for k, g in sorted(gauges.items())},
            "histograms": {k: h.snapshot() for k, h in sorted(hists.items())},
        }

    def dump_json(self, path: Optional[str] = None, indent: int = 1) -> str:
        """The snapshot as JSON; with ``path``, also written atomically
        (temp sibling + ``os.replace``) so a reader never sees half."""
        s = json.dumps(self.to_dict(), indent=indent, sort_keys=True)
        if path is not None:
            d = os.path.dirname(os.path.abspath(path))
            fd, tmp = tempfile.mkstemp(dir=d, prefix=".metrics.")
            try:
                with os.fdopen(fd, "w") as fh:
                    fh.write(s)
                os.replace(tmp, path)
            except BaseException:
                os.unlink(tmp)
                raise
        return s
