"""Flight recorder: an always-on, bounded ring buffer of recent
observability events that dumps an atomic forensic bundle when a run
dies (counterpart of ``lightgbm_tpu/obs/flight.py``).

Tracing (``obs/trace.py``) answers "show me the timeline I asked for";
the flight recorder answers "what were the last N things that happened
before the crash", without anyone having asked in advance.  It is armed
by default (``LIGHTGBM_TPU_FLIGHT=0`` disarms) and costs one bounded
``deque.append`` per fed event:

- **ring**: a ``collections.deque(maxlen=...)`` of Chrome-trace-shaped
  events: every span and instant the tracer records is teed in when
  tracing is on, and the instrumented seams (the engine's step boundary,
  collective routes, serving batches, planner verdicts) feed it directly
  through ``note``/``note_instant`` with tracing off, so the ring is
  never empty when it matters.  O(1) memory, no numerics touched:
  recorder-on training is byte-identical by construction;
- **metric marks**: a small deque of periodic counter/gauge snapshots
  (``sample_metrics``), so a bundle shows metric deltas across the
  final minutes, not just the terminal values;
- **dump triggers**: an unhandled engine-loop exception, a failed
  collective, a quarantined serving swap (``SwapQuarantined`` /
  ``LowPrecisionQuarantined``) or a watchdog SLO breach each call
  ``on_exception``/``dump``, writing ONE atomic JSON bundle (through
  ``utils.file_io.write_atomic``): the ring as a loadable Chrome trace,
  a full metrics snapshot with deltas, and a config/env/device
  fingerprint.  Dumping never raises into the failing caller and is
  rate-limited (``max_dumps``), so a crash loop cannot fill a disk.

The bundle's format is the JAX package's.  Two things differ because
the port runs on CUDA: a torch tensor among a note's arguments is
written as its shape, dtype and device, never read (``float(t)`` or
``repr(t)`` of a CUDA tensor copies it to the host: a hidden
synchronisation, and an error inside a CUDA-graph capture); and the
fingerprint reports torch's and CUDA's versions, the card's name and
count only where CUDA is already initialised, and the rank and world
size only under an initialised process group: a crash path never starts
a CUDA context.

Env knobs: ``LIGHTGBM_TPU_FLIGHT`` (unset/1 = armed, 0 = off),
``LIGHTGBM_TPU_FLIGHT_EVENTS`` (ring capacity, default 2048),
``LIGHTGBM_TPU_FLIGHT_DIR`` (bundle directory, default cwd),
``LIGHTGBM_TPU_FLIGHT_MAX_DUMPS`` (default 8 per process).  Stdlib only;
torch is only READ from ``sys.modules``.
"""

from __future__ import annotations

import collections
import json
import numbers
import os
import platform as _platform
import sys
import threading
import time
import traceback
from typing import Optional

from ..utils import envflags
from . import trace as _trace

_FLIGHT_ENV = "LIGHTGBM_TPU_FLIGHT"
_EVENTS_ENV = "LIGHTGBM_TPU_FLIGHT_EVENTS"
_DIR_ENV = "LIGHTGBM_TPU_FLIGHT_DIR"
_MAX_DUMPS_ENV = "LIGHTGBM_TPU_FLIGHT_MAX_DUMPS"
_DEFAULT_RING = 2048
BUNDLE_VERSION = 1

# env prefixes worth fingerprinting in a bundle (the knobs that decide
# the streaming election, chunking, tracing, and the CUDA and collective
# runtimes)
_ENV_PREFIXES = ("LGBM_TPU", "LIGHTGBM_TPU", "CUDA_", "PYTORCH_",
                 "TORCH_", "NCCL_")

# the registry's gauges a bundle's fingerprint repeats (the ring may
# have rolled past the planner's instants when a long run dies)
_PLAN_GAUGES = ("train_hist_method", "train_hist_predicted_peak_bytes",
                "train_hbm_budget_bytes", "train_psum_payload_bytes",
                "train_num_slices", "train_hier_reduce",
                "train_ici_payload_bytes", "train_dcn_payload_bytes")


def _env_int(name: str, default: int) -> int:
    try:
        v = int(envflags.get(name))
    except ValueError:
        return default
    return v if v > 0 else default


def _tensor_summary(v) -> Optional[dict]:
    """A torch tensor's shape, dtype and device (its values unread), or
    None when ``v`` is not a tensor.  torch is looked up, not imported."""
    torch = sys.modules.get("torch")
    if torch is None or not isinstance(v, torch.Tensor):
        return None
    return {"tensor": list(v.shape), "dtype": str(v.dtype),
            "device": str(v.device)}


def _json_safe(v, depth: int = 0):
    """Clamp arbitrary note args into JSON-serializable primitives (a
    forensic bundle that fails to serialize is worse than a lossy one).
    A tensor becomes its shape, dtype and device at any depth: its
    values are never read, so a CUDA tensor costs no host copy."""
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    t = _tensor_summary(v)
    if t is not None:
        return t
    if depth >= 3:
        return repr(v)[:200]
    if isinstance(v, dict):
        return {str(k)[:80]: _json_safe(x, depth + 1)
                for k, x in list(v.items())[:64]}
    if isinstance(v, (list, tuple, set, frozenset)):
        return [_json_safe(x, depth + 1) for x in list(v)[:64]]
    if isinstance(v, numbers.Number):
        try:
            return float(v)          # numpy scalars and friends
        except (TypeError, ValueError):
            pass
    return repr(v)[:200]


class FlightRecorder:
    """Bounded ring of recent events + atomic forensic bundle dumps."""

    def __init__(self, max_events: Optional[int] = None,
                 enabled: Optional[bool] = None,
                 out_dir: Optional[str] = None,
                 max_dumps: Optional[int] = None):
        if enabled is None:
            enabled = envflags.get(_FLIGHT_ENV) != "0"
        self.enabled = enabled
        cap = (int(max_events) if max_events is not None
               else _env_int(_EVENTS_ENV, _DEFAULT_RING))
        self._ring: "collections.deque" = collections.deque(maxlen=cap)
        # (ts_unix, counters+numeric gauges) marks for delta reporting
        self._marks: "collections.deque" = collections.deque(maxlen=8)
        self._lock = threading.Lock()
        self._out_dir = out_dir
        self.max_dumps = (int(max_dumps) if max_dumps is not None
                          else _env_int(_MAX_DUMPS_ENV, 8))
        self.dumps = 0
        self._seq = 0
        self._last_sample = 0.0
        self._context: dict = {}
        self._pid = os.getpid()

    # ------------------------------------------------------------- feeding

    def feed(self, ev: dict) -> None:
        """Tee one already-formatted trace event into the ring (called by
        the tracer on every recorded span/instant)."""
        if self.enabled:
            self._ring.append(ev)

    def note(self, name: str, **args) -> None:
        """Record a complete-style event directly (instrumented seams:
        engine step, collective route, serving batch).  Cheap: one dict
        build + one bounded append; a no-op when disarmed."""
        if not self.enabled:
            return
        ev = {"name": name, "ph": "X", "pid": self._pid,
              "tid": threading.get_ident(),
              "ts": (time.perf_counter() - _trace.global_tracer._epoch)
              * 1e6,
              "dur": float(args.pop("dur_us", 0.0))}
        if args:
            ev["args"] = args
        self._ring.append(ev)

    def note_instant(self, name: str, args: dict) -> None:
        """Point-in-time twin of ``note`` (trace.instant tees here when
        tracing is disabled, so planner verdicts always reach the ring)."""
        if not self.enabled:
            return
        ev = {"name": name, "ph": "i", "s": "t", "pid": self._pid,
              "tid": threading.get_ident(),
              "ts": (time.perf_counter() - _trace.global_tracer._epoch)
              * 1e6}
        if args:
            ev["args"] = dict(args)
        self._ring.append(ev)

    def set_context(self, **ctx) -> None:
        """Attach run context (training params, the planner's verdict)
        included verbatim in every bundle's fingerprint."""
        with self._lock:
            self._context.update(
                {k: _json_safe(v) for k, v in ctx.items()})

    def sample_metrics(self, registry=None,
                       min_interval_s: float = 5.0) -> None:
        """Snapshot counters + numeric gauges into the bounded marks
        deque (rate-limited); bundles report first-vs-last deltas."""
        if not self.enabled:
            return
        now = time.monotonic()
        if now - self._last_sample < min_interval_s and self._marks:
            return
        self._last_sample = now
        try:
            if registry is None:
                from .metrics import global_registry as registry
            d = registry.to_dict()
            nums = dict(d.get("counters", {}))
            nums.update({k: v for k, v in d.get("gauges", {}).items()
                         if isinstance(v, (int, float))
                         and not isinstance(v, bool)})
            self._marks.append((time.time(), nums))
        except Exception:  # noqa: BLE001 — telemetry never breaks callers
            pass

    # ------------------------------------------------------------- dumping

    def ring_events(self) -> list:
        return list(self._ring)

    def _metric_deltas(self) -> dict:
        if len(self._marks) < 2:
            return {}
        (t0, a), (t1, b) = self._marks[0], self._marks[-1]
        out = {}
        for k, v in b.items():
            d = v - a.get(k, 0)
            if d:
                out[k] = d
        return {"window_s": round(t1 - t0, 3), "deltas": out}

    def fingerprint(self) -> dict:
        """Config/env/device identity of THIS process: enough to answer
        "what exact setup died" without a live debugger.  Starts no CUDA
        context: the card is named only where CUDA is initialised."""
        fp = {
            "pid": self._pid,
            "time_unix": time.time(),
            "argv": [str(a)[:200] for a in sys.argv[:8]],
            "python": sys.version.split()[0],
            "platform": _platform.platform(),
            "env": {k: os.environ[k] for k in sorted(os.environ)
                    if k.startswith(_ENV_PREFIXES)},
            "context": dict(self._context),
        }
        torch = sys.modules.get("torch")
        if torch is not None:
            try:
                fp["torch_version"] = str(torch.__version__)
                fp["cuda_version"] = torch.version.cuda
                # get_device_name initialises CUDA when nothing has:
                # report the card only where a context already exists
                if torch.cuda.is_initialized():
                    idx = torch.cuda.current_device()
                    fp["backend"] = "cuda"
                    fp["device_kind"] = torch.cuda.get_device_name(idx)
                    fp["n_devices"] = torch.cuda.device_count()
                else:
                    fp["backend"] = "cpu"
            except Exception:  # noqa: BLE001 — a broken runtime
                pass
            dist = sys.modules.get("torch.distributed")
            try:
                if dist is not None and dist.is_available() \
                        and dist.is_initialized():
                    fp["process_index"] = dist.get_rank()
                    fp["process_count"] = dist.get_world_size()
            except Exception:  # noqa: BLE001
                pass
        try:
            from .metrics import global_registry
            g = global_registry.to_dict().get("gauges", {})
            fp["mesh"] = {k: g[k] for k in _PLAN_GAUGES if k in g}
        except Exception:  # noqa: BLE001
            pass
        return fp

    def bundle(self, trigger: str, exc: Optional[BaseException] = None,
               extra: Optional[dict] = None) -> dict:
        """The forensic bundle dict (``dump`` writes it atomically)."""
        evs = sorted(self.ring_events(), key=lambda e: e.get("ts", 0.0))
        ring = {"traceEvents": [
            {"name": "process_name", "ph": "M", "pid": self._pid,
             "tid": 0, "ts": 0.0,
             "args": {"name": f"lightgbm-tpu flight [{trigger}]"}}] + evs,
            "displayTimeUnit": "ms"}
        out = {
            "flight_bundle": BUNDLE_VERSION,
            "trigger": trigger,
            "ring": ring,
            "ring_events": len(evs),
            "metric_deltas": self._metric_deltas(),
            "fingerprint": self.fingerprint(),
        }
        if exc is not None:
            out["exception"] = {
                "type": type(exc).__name__,
                "message": str(exc)[:2000],
                "traceback_tail": "".join(traceback.format_exception(
                    type(exc), exc, exc.__traceback__))[-4000:],
            }
        try:
            from .metrics import global_registry
            out["metrics"] = global_registry.to_dict()
        except Exception:  # noqa: BLE001
            out["metrics"] = {}
        if extra:
            out["extra"] = _json_safe(extra)
        return out

    def out_dir(self) -> str:
        return (self._out_dir or envflags.get(_DIR_ENV) or os.getcwd())

    def dump(self, trigger: str, exc: Optional[BaseException] = None,
             extra: Optional[dict] = None) -> Optional[str]:
        """Write one atomic forensic bundle; returns its path, or None
        (disarmed / rate-limited / write failed).  NEVER raises — the
        recorder must not turn a failing run into a failing-worse run."""
        if not self.enabled:
            return None
        with self._lock:
            if self.dumps >= self.max_dumps:
                return None
            self.dumps += 1
            self._seq += 1
            seq = self._seq
        try:
            safe = "".join(c if c.isalnum() or c in "-_." else "_"
                           for c in trigger)[:60] or "trigger"
            path = os.path.join(
                self.out_dir(),
                f"flight_{safe}_{self._pid}_{seq}.json")
            payload = json.dumps(self.bundle(trigger, exc=exc, extra=extra),
                                 default=lambda v: _json_safe(v))
            from ..utils.file_io import write_atomic
            write_atomic(path, payload)
        except Exception as e:  # noqa: BLE001 — forensics must not crash
            try:
                from ..utils.log import log_warning
                log_warning(f"flight recorder: bundle write failed ({e!r})")
            except Exception:  # noqa: BLE001
                pass
            return None
        try:
            from .metrics import global_registry
            global_registry.counter(
                "flight_dumps_total", labels={"trigger": safe}).inc()
            from ..utils.log import log_warning
            log_warning(f"flight recorder: forensic bundle -> {path} "
                        f"(trigger={trigger})")
        except Exception:  # noqa: BLE001
            pass
        return path

    def on_exception(self, site: str,
                     exc: BaseException) -> Optional[str]:
        """Dump with a ``<site>:<ExcType>`` trigger: the one-liner the
        raise sites (engine loop, collectives) call on their way out."""
        return self.dump(f"{site}:{type(exc).__name__}", exc=exc)


# THE process flight recorder: armed unless LIGHTGBM_TPU_FLIGHT=0.
global_flight = FlightRecorder()

# tee tracer-recorded events into the ring (trace.py holds only a weak
# seam: no import cycle)
_trace.set_flight_sink(global_flight)


def note(name: str, **args) -> None:
    """Module-level ``global_flight.note`` (instrumentation entry)."""
    global_flight.note(name, **args)
