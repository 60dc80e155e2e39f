"""Hierarchical wall-clock timing (counterpart of
``lightgbm_tpu/utils/timer.py``), and the port's syncing section timer.

reference: Common::Timer + RAII FunctionTimer (include/LightGBM/utils/
common.h:1026-1110), dumped at exit through the single ``global_timer``.

``Timer``/``global_timer``: the gate is runtime, as in the JAX package:
``LIGHTGBM_TPU_TIMETAG=1`` in the environment (or
``global_timer.enable()``) makes every tagged section accumulate (count,
total seconds) under its name (``Dataset::Construct``,
``GBDT::TrainOneIter``, ``TreeLearner::Train(dispatch)``,
``GBDT::FinishIter(host trees)``, ``GBDT::EvalMetrics``,
``Booster::Predict``, ...), and the table prints at interpreter exit
sorted by total time; ``json`` emits a JSON object to stderr instead and
``json:<path>`` writes it to ``<path>``.  Disabled, a tagged section
costs one attribute check.  ``publish()`` mirrors the totals into the
process registry (``obs.metrics``) as ``timer.<name>.{calls,total_s}``
gauges.  These sections measure HOST time: work on the card is
asynchronous and lands in the section that first waits on it; no
section synchronises the card.

``SectionTimer``: the port's breakdown of training time.  With
``cuda=True`` it synchronises the card on entering and leaving a
section, so device work is charged to the section that queued it; the
synchronisation itself slows the run, so the trainer keeps no such
timer unless a caller sets one (``GBDT.timer``).
"""

from __future__ import annotations

import atexit
import contextlib
import sys
import threading
import time
from collections import defaultdict

from . import envflags

_TIMETAG_ENV = "LIGHTGBM_TPU_TIMETAG"


class SectionTimer:
    def __init__(self, cuda: bool = False):
        self.cuda = cuda
        self.seconds = defaultdict(float)

    def _sync(self) -> None:
        if self.cuda:
            import torch
            torch.cuda.synchronize()

    @contextlib.contextmanager
    def section(self, name: str):
        self._sync()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._sync()
            self.seconds[name] += time.perf_counter() - t0


class Timer:
    """Accumulating named wall-clock sections (thread-safe)."""

    def __init__(self, enabled: bool | None = None):
        if enabled is None:
            # any non-empty value but "0" enables ("1" = table at exit,
            # "json"/"json:<path>" = machine-readable exit dump)
            enabled = envflags.get(_TIMETAG_ENV) not in ("", "0")
        self.enabled = enabled
        self._acc: dict = {}          # name -> [count, total_seconds]
        self._lock = threading.Lock()

    def enable(self) -> None:
        self.enabled = True

    def disable(self) -> None:
        self.enabled = False

    def reset(self) -> None:
        with self._lock:
            self._acc.clear()

    def add(self, name: str, seconds: float) -> None:
        with self._lock:
            slot = self._acc.setdefault(name, [0, 0.0])
            slot[0] += 1
            slot[1] += seconds

    @contextlib.contextmanager
    def section(self, name: str):
        """``with global_timer.section("GBDT::TrainOneIter"): ...``
        (reference: FunctionTimer RAII guard, common.h:1091-1110)."""
        if not self.enabled:
            yield
            return
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.add(name, time.perf_counter() - t0)

    def items(self):
        with self._lock:
            return {k: tuple(v) for k, v in self._acc.items()}

    def to_dict(self) -> dict:
        """JSON-ready totals: name -> {calls, total_s, mean_ms}."""
        return {
            name: {"calls": cnt, "total_s": round(total, 6),
                   "mean_ms": round(total / cnt * 1e3, 6) if cnt else 0.0}
            for name, (cnt, total) in self.items().items()
        }

    def dump_json(self, path=None) -> str:
        """The machine-readable form of ``print``; writes to ``path``
        (atomically) when given, returns the JSON string either way."""
        import json
        s = json.dumps({"timers": self.to_dict()}, indent=1, sort_keys=True)
        if path:
            from .file_io import write_atomic
            write_atomic(path, s)
        return s

    def publish(self, registry=None) -> dict:
        """Mirror the totals into the process metrics registry (default:
        ``obs.metrics.global_registry``) as ``timer.<name>.calls`` /
        ``timer.<name>.total_s`` gauges.  Returns the mirrored totals."""
        if registry is None:
            from ..obs.metrics import global_registry as registry
        items = self.items()
        for name, (cnt, total) in items.items():
            registry.gauge(f"timer.{name}.calls").set(cnt)
            registry.gauge(f"timer.{name}.total_s").set(round(total, 6))
        return items

    def print(self, file=None) -> None:
        """reference: Timer::Print (common.h:1054-1070)."""
        if file is None:
            file = sys.stderr
        rows = sorted(self.items().items(), key=lambda kv: -kv[1][1])
        if not rows:
            return
        width = max(len(k) for k, _ in rows)
        print("LightGBM-TPU timers (name, calls, total s, mean ms):",
              file=file)
        for name, (cnt, total) in rows:
            print(f"  {name:<{width}}  {cnt:>8}  {total:>10.3f}  "
                  f"{total / cnt * 1e3:>10.3f}", file=file)


global_timer = Timer()


def function_timer(name: str, timer: Timer = global_timer):
    """Decorator form (reference FunctionTimer wraps whole functions)."""

    def wrap(fn):
        import functools

        @functools.wraps(fn)
        def inner(*args, **kwargs):
            if not timer.enabled:
                return fn(*args, **kwargs)
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                timer.add(name, time.perf_counter() - t0)

        return inner

    return wrap


@atexit.register
def _print_at_exit() -> None:
    if not global_timer.enabled:
        return
    mode = envflags.get(_TIMETAG_ENV)
    if mode == "json" or mode.startswith("json:"):
        # an empty path ("json:") falls back to stderr, never silence
        path = (mode[5:] or None) if mode.startswith("json:") else None
        try:
            s = global_timer.dump_json(path)
            if path is None:
                print(s, file=sys.stderr)
        except OSError:
            global_timer.print()
    else:
        global_timer.print()
