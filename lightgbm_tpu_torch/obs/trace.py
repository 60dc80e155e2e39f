"""Structured tracing: a thread-safe span recorder emitting Chrome
trace-event / Perfetto-compatible JSON (counterpart of
``lightgbm_tpu/obs/trace.py``).

``utils/timer.py`` answers "how much total time went into section X";
this module answers "WHEN did each occurrence run, on which thread,
nested under what".  Spans are recorded through the seams of the port's
training and serving paths (the engine loop, chunk dispatch and the
host tree fetch, each tree's growth, the data plane's passes and
blocks, collective sums, the serving batcher's admission, dispatch and
completion) under the JAX package's event names, and dump as one JSON
file that chrome://tracing or ui.perfetto.dev loads directly.

Gate: ``LIGHTGBM_TPU_TRACE``: unset/"0" disables (a disabled call site
costs one attribute check and returns a shared null context manager);
"1" enables recording; any other value enables AND names the file the
trace is dumped to at interpreter exit.  ``global_tracer.dump(path)``
dumps on demand.  ``LIGHTGBM_TPU_TRACE_MAX_EVENTS`` caps the in-process
event list; events beyond the cap are dropped and counted.

Event format (Chrome trace-event "JSON object format"): complete events
``{"name", "ph": "X", "ts", "dur", "pid", "tid", "args"}`` with ``ts``/
``dur`` in microseconds since the tracer's epoch, plus instant events
(``"ph": "i"``) for point-in-time facts (planner verdicts, request
admissions).  Events are timestamp-sorted at dump time.

Spans measure HOST time.  Work on the card is asynchronous: a kernel's
time lands in whichever span first waits on it (the round loop's lagged
stop flag, the host tree fetch), and no span synchronises the card.  A
caller who wants device time by section uses the syncing
``utils.timer.SectionTimer``.  No event argument may be a device value
read to the host: call sites pass host ints, floats and strings only.
Stdlib only; no torch import.
"""

from __future__ import annotations

import atexit
import json
import os
import threading
import time
from typing import List, Optional

from ..utils import envflags

_TRACE_ENV = "LIGHTGBM_TPU_TRACE"
_MAX_EVENTS_ENV = "LIGHTGBM_TPU_TRACE_MAX_EVENTS"
# generous default: ~1M events is hundreds of MB of JSON before a long
# run would hit it, but it IS a bound (drops are counted, never silent)
_DEFAULT_MAX_EVENTS = 1_000_000

# the flight recorder's ring sink (obs/flight.py installs itself via
# set_flight_sink at import).  Kept as a module global so trace.py never
# imports flight.py (no cycle); None = no recorder armed.
_flight_sink = None


def set_flight_sink(sink) -> None:
    """Install (or clear, with None) the flight-recorder ring that tees
    recorded span/instant events.  Called by obs/flight.py."""
    global _flight_sink
    _flight_sink = sink


def _max_events_env() -> int:
    try:
        v = int(envflags.get(_MAX_EVENTS_ENV))
    except ValueError:
        return _DEFAULT_MAX_EVENTS
    return v if v > 0 else _DEFAULT_MAX_EVENTS


class _NullSpan:
    """Shared no-op context manager for the disabled path (one instance
    for the whole process: disabled tracing never allocates)."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **args):
        return self


_NULL_SPAN = _NullSpan()


class _Span:
    """One live span; records a complete event on ``__exit__`` (always —
    an exception inside the span closes it and tags ``args["error"]``,
    so span trees stay well-nested under raises)."""

    __slots__ = ("_tracer", "name", "args", "_t0")

    def __init__(self, tracer: "Tracer", name: str, args: dict):
        self._tracer = tracer
        self.name = name
        self.args = args

    def set(self, **args) -> "_Span":
        """Attach attributes mid-span (e.g. a result size known late)."""
        self.args.update(args)
        return self

    def __enter__(self) -> "_Span":
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        t1 = time.perf_counter()
        if exc_type is not None:
            self.args["error"] = exc_type.__name__
        self._tracer._record(self.name, self._t0, t1, self.args)
        return False


class Tracer:
    """Thread-safe span/instant recorder with Chrome-trace export."""

    def __init__(self, enabled: Optional[bool] = None,
                 max_events: Optional[int] = None):
        if enabled is None:
            v = envflags.get(_TRACE_ENV)
            enabled = bool(v) and v != "0"
        self.enabled = enabled
        # bounded in-process event list (LIGHTGBM_TPU_TRACE_MAX_EVENTS):
        # beyond the cap new events are DROPPED and counted, so a long
        # run cannot grow the span list without bound
        self.max_events = (int(max_events) if max_events is not None
                           else _max_events_env())
        self.dropped = 0
        self._events: List[dict] = []
        self._lock = threading.Lock()
        self._pid = os.getpid()
        self._epoch = time.perf_counter()
        # only the process tracer tees into the flight ring (scratch
        # tracers in tests must not pollute the process forensics)
        self._flight_tee = False

    # ------------------------------------------------------------- control

    def enable(self) -> None:
        self.enabled = True

    def disable(self) -> None:
        self.enabled = False

    def reset(self) -> None:
        with self._lock:
            self._events.clear()
            self.dropped = 0

    # ----------------------------------------------------------- recording

    def span(self, name: str, **args):
        """``with tracer.span("grow_tree", leaves=255): ...`` — returns
        the shared null context manager when disabled."""
        if not self.enabled:
            return _NULL_SPAN
        return _Span(self, name, args)

    def instant(self, name: str, **args) -> None:
        """Point-in-time event (Chrome "i" phase, thread scope)."""
        if not self.enabled:
            return
        ev = {"name": name, "ph": "i", "s": "t", "pid": self._pid,
              "tid": threading.get_ident(),
              "ts": (time.perf_counter() - self._epoch) * 1e6}
        if args:
            ev["args"] = args
        self._append(ev)

    def _record(self, name: str, t0: float, t1: float, args: dict) -> None:
        ev = {"name": name, "ph": "X", "pid": self._pid,
              "tid": threading.get_ident(),
              "ts": (t0 - self._epoch) * 1e6,
              "dur": (t1 - t0) * 1e6}
        if args:
            ev["args"] = args
        self._append(ev)

    def _append(self, ev: dict) -> None:
        dropped_now = None
        with self._lock:
            if len(self._events) >= self.max_events:
                self.dropped += 1
                dropped_now = self.dropped
            else:
                self._events.append(ev)
        sink = _flight_sink
        if sink is not None and self._flight_tee:
            # the flight ring is bounded by construction, so it still
            # sees events the capped span list dropped
            sink.feed(ev)
        if dropped_now is not None:
            # visible both process-wide (gauge) and in the trace dump
            # (an instant is appended at export, see to_chrome_trace)
            from .metrics import global_registry
            global_registry.gauge("trace_events_dropped").set(dropped_now)

    # -------------------------------------------------------------- export

    def events(self) -> List[dict]:
        with self._lock:
            return list(self._events)

    def to_chrome_trace(self, events: Optional[List[dict]] = None) -> dict:
        """Loadable-by-chrome://tracing dict: timestamp-sorted events plus
        a process-name metadata record.  ``events`` restricts the export
        to a subset (e.g. one phase's slice of a shared tracer)."""
        evs = sorted(self.events() if events is None else events,
                     key=lambda e: e.get("ts", 0.0))
        meta = [{"name": "process_name", "ph": "M", "pid": self._pid,
                 "tid": 0, "ts": 0.0,
                 "args": {"name": "lightgbm-tpu-torch"}}]
        if self.dropped:
            evs = evs + [{
                "name": "trace_events_dropped", "ph": "i", "s": "p",
                "pid": self._pid, "tid": 0,
                "ts": (evs[-1]["ts"] if evs else 0.0),
                "args": {"dropped": self.dropped,
                         "max_events": self.max_events}}]
        return {"traceEvents": meta + evs, "displayTimeUnit": "ms"}

    def dump(self, path: str, events: Optional[List[dict]] = None) -> str:
        """Write the Chrome-trace JSON to ``path`` (atomic); returns it."""
        from ..utils.file_io import write_atomic
        write_atomic(path, json.dumps(self.to_chrome_trace(events)))
        return str(path)

    def mark(self) -> int:
        """Current event count: pass the returned mark to ``since`` to
        slice later events (per-phase export from a shared tracer)."""
        with self._lock:
            return len(self._events)

    def since(self, mark: int) -> List[dict]:
        with self._lock:
            return list(self._events[mark:])


global_tracer = Tracer()
global_tracer._flight_tee = True


def span(name: str, **args):
    """Module-level span against the process tracer, the instrumentation
    entry point: ``with span("engine.step", i=i): ...``."""
    if not global_tracer.enabled:
        return _NULL_SPAN
    return _Span(global_tracer, name, args)


def instant(name: str, **args) -> None:
    global_tracer.instant(name, **args)
    if not global_tracer.enabled and _flight_sink is not None:
        # instants are rare (planner verdicts, admissions) and exactly the
        # point-in-time facts a forensic bundle needs: keep feeding the
        # always-on flight ring with tracing off
        _flight_sink.note_instant(name, args)


def trace_enabled() -> bool:
    return global_tracer.enabled


def trace_path() -> Optional[str]:
    """The exit-dump path named by ``LIGHTGBM_TPU_TRACE``, if any."""
    v = envflags.get(_TRACE_ENV)
    if v and v.lower() not in ("0", "1", "on", "true"):
        return v
    return None


def span_coverage(events: List[dict], root_name: str) -> Optional[float]:
    """Fraction of the longest ``root_name`` span's wall-clock covered by
    the union of every other span overlapping it: the "does the span
    tree account for the run?" number."""
    roots = [e for e in events
             if e.get("name") == root_name and e.get("ph") == "X"]
    if not roots:
        return None
    root = max(roots, key=lambda e: e.get("dur", 0.0))
    lo, hi = root["ts"], root["ts"] + root["dur"]
    if hi <= lo:
        return None
    ivals = []
    for e in events:
        if e is root or e.get("ph") != "X":
            continue
        s = max(e["ts"], lo)
        t = min(e["ts"] + e.get("dur", 0.0), hi)
        if t > s:
            ivals.append((s, t))
    ivals.sort()
    covered, cur_s, cur_t = 0.0, None, None
    for s, t in ivals:
        if cur_t is None or s > cur_t:
            if cur_t is not None:
                covered += cur_t - cur_s
            cur_s, cur_t = s, t
        else:
            cur_t = max(cur_t, t)
    if cur_t is not None:
        covered += cur_t - cur_s
    return covered / (hi - lo)


@atexit.register
def _dump_at_exit() -> None:
    p = trace_path()
    if p and global_tracer.enabled and global_tracer.events():
        try:
            global_tracer.dump(p)
        except OSError:
            pass
