"""SLO watchdog: a heartbeat-based stall/SLO sentry over the long-lived
loops (counterpart of ``lightgbm_tpu/obs/watchdog.py``): the engine's
iterations, the data plane's pumps, the serving batcher.

The passive plane (spans, metrics) records what happened; this module
watches it happen and raises the alarm when it stops or degrades:

- **heartbeats**: instrumented loops call ``beat(name[, count])`` (one
  dict store, always cheap).  A heartbeat registered for watching
  (``watch_heartbeat``) that goes stale past its threshold is a
  ``stall:<name>`` breach.  Registration is scoped to the activity: the
  engine registers its beat on loop entry and unregisters on exit, so a
  heartbeat that stopped because training FINISHED never breaches;
- **rate floors**: a counted heartbeat (``beat(name, count=...)``)
  checked against a floor (the trees/s SLO): the watchdog
  differentiates the count between checks, so a loop that still beats
  but crawls breaches ``slo:<name>``;
- **latency ceilings**: ``watch_histogram_p99`` holds a latency
  histogram's estimated p99 (from its cumulative buckets) to a ceiling:
  the serving-p99 SLO;
- **model freshness** (``watch_freshness``/``mark_fresh``) and
  **availability** (``watch_availability``): the JAX package's watches
  of a deployed model's age and windowed availability, ported whole for
  the fleet and lifecycle tiers that will arm them.

Every breach increments ``slo_breach_total{slo=...}`` on the process
registry, logs, and on the rising edge only triggers a flight-recorder
bundle (``obs/flight.py``).

The sentry is a daemon host thread, OPT-IN (``start()``, or
``LIGHTGBM_TPU_WATCHDOG=1`` / any ``LIGHTGBM_TPU_SLO_*`` knob through
``maybe_start_from_env``, checked at engine and server init), and
``stop()`` ends it.  It reads beats, histograms and the registry only:
it never touches a torch tensor or a CUDA stream.  ``check_once`` runs
one synchronous sweep for tests and tools.  Stdlib only.
"""

from __future__ import annotations

import math
import threading
import time
from dataclasses import dataclass
from typing import Optional

from ..utils import envflags

_WATCHDOG_ENV = "LIGHTGBM_TPU_WATCHDOG"
_SLO_TPS_ENV = "LIGHTGBM_TPU_SLO_TREES_PER_SEC"
_SLO_P99_ENV = "LIGHTGBM_TPU_SLO_SERVING_P99_MS"
_SLO_STALE_ENV = "LIGHTGBM_TPU_SLO_HEARTBEAT_S"
_SLO_AGE_ENV = "LIGHTGBM_TPU_SLO_MODEL_AGE_S"
_SLO_AVAIL_ENV = "LIGHTGBM_TPU_SLO_AVAILABILITY"
_INTERVAL_ENV = "LIGHTGBM_TPU_WATCHDOG_INTERVAL_S"


def _env_float(name: str) -> Optional[float]:
    v = (envflags.read(name) or "").strip()
    if not v:
        return None
    try:
        return float(v)
    except ValueError:
        return None


@dataclass
class SLOConfig:
    """The service-level objectives the sentry enforces.  ``None``
    disables that check; the heartbeat staleness default is deliberately
    generous — a compile can legitimately take minutes."""

    heartbeat_stale_s: float = 300.0
    trees_per_sec_floor: Optional[float] = None
    serving_p99_ms: Optional[float] = None
    model_age_max_s: Optional[float] = None
    availability_floor: Optional[float] = None
    check_interval_s: float = 5.0

    @classmethod
    def from_env(cls) -> "SLOConfig":
        cfg = cls()
        v = _env_float(_SLO_STALE_ENV)
        if v is not None:
            cfg.heartbeat_stale_s = v
        cfg.trees_per_sec_floor = _env_float(_SLO_TPS_ENV)
        cfg.serving_p99_ms = _env_float(_SLO_P99_ENV)
        cfg.model_age_max_s = _env_float(_SLO_AGE_ENV)
        cfg.availability_floor = _env_float(_SLO_AVAIL_ENV)
        v = _env_float(_INTERVAL_ENV)
        if v is not None and v > 0:
            cfg.check_interval_s = v
        return cfg


def histogram_p99_ms(hist) -> Optional[float]:
    """Upper-bound p99 estimate from a metrics Histogram's cumulative
    buckets (the smallest bound covering >= 99% of observations; the
    histogram max when that bound is +inf).  None with no samples."""
    cum, _total, count = hist.cumulative()
    if count == 0:
        return None
    target = 0.99 * count
    for bound, c in cum:
        if c >= target:
            if math.isinf(bound):
                snap = hist.snapshot()
                return float(snap.get("max", 0.0))
            return float(bound)
    return None


class Watchdog:
    """Heartbeat registry + SLO sentry; one instance per process
    (``global_watchdog``), scratch instances for tests."""

    def __init__(self, config: Optional[SLOConfig] = None,
                 registry=None, flight=None):
        self.config = config or SLOConfig()
        self._registry = registry
        self._flight = flight
        self._beats: dict = {}        # name -> (monotonic ts, count|None)
        self._watched: dict = {}      # name -> stale threshold seconds
        self._floors: dict = {}       # name -> rate floor (units/sec)
        self._rate_state: dict = {}   # guarded-by: _lock (ts, count)/name
        self._hists: dict = {}        # name -> (Histogram, ceiling_ms,
        #                               windowed)
        self._hist_state: dict = {}   # guarded-by: _lock — windowed p99:
        #                               name -> (bucket counts, count)
        self._fresh: dict = {}        # guarded-by: _lock
        #                               name -> (fresh_ts, max_age_s|None)
        self._avail: dict = {}        # guarded-by: _lock
        #                               name -> (sample_fn, floor|None)
        self._avail_state: dict = {}  # guarded-by: _lock
        #                               name -> (completed, failed) last sweep
        self._breached: set = set()   # guarded-by: _lock (edge detection)
        self._listeners: list = []    # guarded-by: _lock (breach hooks)
        self._lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    def _reg(self):
        if self._registry is None:
            from .metrics import global_registry
            self._registry = global_registry
        return self._registry

    def _fl(self):
        if self._flight is None:
            from .flight import global_flight
            self._flight = global_flight
        return self._flight

    # ----------------------------------------------------------- heartbeats

    def beat(self, name: str, count: Optional[float] = None) -> None:
        """Record liveness (and optionally progress) of ``name``.  One
        dict store — safe on any hot loop, watched or not."""
        self._beats[name] = (time.monotonic(), count)

    def beat_age(self, name: str,
                 now: Optional[float] = None) -> Optional[float]:
        """Seconds since ``name`` last beat, or None when it never has (a
        serving batcher that stops beating is wedged, whatever its queue
        says)."""
        ts_count = self._beats.get(name)
        if ts_count is None:
            return None
        return (time.monotonic() if now is None else now) - ts_count[0]

    def watch_heartbeat(self, name: str, stale_s: Optional[float] = None,
                        floor: Optional[float] = None) -> None:
        """Arm staleness (and optionally rate-floor) checking for
        ``name``.  Call on activity START; ``unwatch`` on clean exit."""
        with self._lock:
            self._watched[name] = (stale_s if stale_s is not None
                                   else self.config.heartbeat_stale_s)
            if floor is not None:
                self._floors[name] = floor
            self._rate_state.pop(name, None)
        self.beat(name)       # arming is itself proof of life

    def unwatch(self, name: str) -> None:
        with self._lock:
            self._watched.pop(name, None)
            self._floors.pop(name, None)
            self._rate_state.pop(name, None)
            self._breached = {b for b in self._breached
                              if not b.endswith(":" + name)}

    def watch_histogram_p99(self, name: str, hist,
                            ceiling_ms: Optional[float] = None,
                            windowed: bool = False) -> None:
        """Hold ``hist``'s estimated p99 to ``ceiling_ms`` (defaults to
        the config's serving_p99_ms; never breaches while both are
        None).

        ``windowed=True`` estimates the p99 over the samples observed
        SINCE THE LAST SWEEP (differencing the cumulative buckets, like
        the availability watch) instead of over the histogram's whole
        cumulative history.  A cumulative p99 is sticky — one latency
        spike breaches it for the process lifetime — so windowed is the
        mode brownout controllers use: the breach clears once the
        current traffic is back under the ceiling."""
        with self._lock:
            self._hists[name] = (hist, ceiling_ms, bool(windowed))
            self._hist_state.pop(name, None)

    def unwatch_histogram(self, name: str) -> None:
        with self._lock:
            self._hists.pop(name, None)
            self._hist_state.pop(name, None)
            # a re-registered same-name watch must get a fresh rising
            # edge (its dump would otherwise be suppressed forever)
            self._breached.discard(f"slo:{name}")

    # ----------------------------------------------------------- freshness

    def watch_freshness(self, name: str,
                        max_age_s: Optional[float] = None) -> None:
        """Hold ``name``'s model age (seconds since the last
        ``mark_fresh``) to ``max_age_s`` (default: the config's
        ``model_age_max_s``; never breaches while both are None).  The
        age is published as ``model_age_seconds{model=...}`` either way
        (a deployment that stops refreshing breaches
        ``freshness:<name>`` and dumps a forensic bundle)."""
        with self._lock:
            prev = self._fresh.get(name)
            self._fresh[name] = (prev[0] if prev is not None
                                 else time.monotonic(), max_age_s)

    def mark_fresh(self, name: str) -> None:
        """Reset ``name``'s model age to zero (called at promotion)."""
        with self._lock:
            entry = self._fresh.get(name)
            self._fresh[name] = (time.monotonic(),
                                 entry[1] if entry is not None else None)

    def unwatch_freshness(self, name: str) -> None:
        with self._lock:
            self._fresh.pop(name, None)
            self._breached.discard(f"freshness:{name}")

    def model_age_s(self, name: str) -> Optional[float]:
        with self._lock:
            entry = self._fresh.get(name)
        return None if entry is None else time.monotonic() - entry[0]

    # --------------------------------------------------------- availability

    def watch_availability(self, name: str, sample_fn,
                           floor: Optional[float] = None) -> None:
        """Hold ``name``'s windowed availability to ``floor`` (default:
        the config's ``availability_floor``, i.e.
        ``LIGHTGBM_TPU_SLO_AVAILABILITY``; never breaches while both are
        None).  ``sample_fn() -> (completed, failed)`` returns CUMULATIVE
        per-model outcome counts (typed shed/expired excluded from both
        — they are correct overload behavior, not unavailability); each
        sweep differentiates the window exactly like the rate floors, so
        one bad minute breaches even after a long clean run.  Breaches
        count ``slo_breach_total{slo="availability:<name>"}`` and
        flight-dump on the rising edge, mirroring the p99 ceiling."""
        with self._lock:
            self._avail[name] = (sample_fn, floor)
            self._avail_state.pop(name, None)

    def unwatch_availability(self, name: str) -> None:
        with self._lock:
            self._avail.pop(name, None)
            self._avail_state.pop(name, None)
            self._breached.discard(f"availability:{name}")

    # -------------------------------------------------------------- checks

    def active_breaches(self) -> list:
        """Sorted snapshot of the currently UN-RECOVERED breach names:
        what /healthz reports as degraded (obs/http.py)."""
        with self._lock:
            return sorted(self._breached)

    def add_breach_listener(self, fn) -> None:
        """Register ``fn(slo, evidence, rising)`` to be called on EVERY
        breach occurrence (not just the rising edge — a throttle
        controller needs the repeat signal to know the brownout
        persists).  Exceptions from listeners are swallowed: a broken
        hook must never kill the sentry sweep."""
        with self._lock:
            if fn not in self._listeners:
                self._listeners.append(fn)

    def remove_breach_listener(self, fn) -> None:
        with self._lock:
            if fn in self._listeners:
                self._listeners.remove(fn)

    def _windowed_p99(self, name: str, hist) -> Optional[float]:
        """p99 estimate over the samples since the LAST sweep (delta of
        the cumulative buckets).  None on the arming sweep or an empty
        window."""
        cum, _total, count = hist.cumulative()
        counts = [c for _b, c in cum]
        with self._lock:
            prev = self._hist_state.get(name)
            self._hist_state[name] = (counts, count)
        if prev is None:
            return None
        dcount = count - prev[1]
        if dcount <= 0:
            return None
        target = 0.99 * dcount
        for (bound, c), pc in zip(cum, prev[0]):
            if c - pc >= target:
                if math.isinf(bound):
                    snap = hist.snapshot()
                    return float(snap.get("max", 0.0))
                return float(bound)
        return None

    def _breach(self, slo: str, evidence: dict) -> None:
        # the sentry thread and a caller's unwatch() both touch the
        # breach set; the rising-edge read must pair with the add, and a
        # breach computed from a pre-unwatch snapshot must not re-enter
        # the set after unwatch cleared it (that would both alarm for an
        # activity that exited cleanly and suppress the NEXT watch's
        # rising-edge dump)
        name = slo.split(":", 1)[-1]
        with self._lock:
            if name not in self._watched and name not in self._floors \
                    and name not in self._hists \
                    and name not in self._fresh \
                    and name not in self._avail:
                return
            rising = slo not in self._breached
            self._breached.add(slo)
        try:
            self._reg().counter("slo_breach_total",
                                labels={"slo": slo}).inc()
        except Exception:  # noqa: BLE001
            pass
        from ..utils.log import log_warning
        log_warning(f"watchdog: SLO breach [{slo}] {evidence}")
        if rising:
            # rising edge only: a persistent breach must not dump-storm
            self._fl().dump(f"watchdog:{slo}", extra=evidence)
        with self._lock:
            listeners = list(self._listeners)
        for fn in listeners:
            try:
                fn(slo, evidence, rising)
            except Exception:  # noqa: BLE001 — hooks never kill the sweep
                pass

    def _clear(self, slo: str) -> None:
        with self._lock:
            self._breached.discard(slo)

    def check_once(self, now: Optional[float] = None) -> list:
        """One synchronous sweep; returns the list of (slo, evidence)
        breaches found THIS sweep (tests drive this without the thread)."""
        now = time.monotonic() if now is None else now
        breaches = []
        with self._lock:
            watched = dict(self._watched)
            floors = dict(self._floors)
            hists = dict(self._hists)
            fresh = dict(self._fresh)
            avail = dict(self._avail)
        for name, stale_s in watched.items():
            ts_count = self._beats.get(name)
            if ts_count is None:
                continue
            age = now - ts_count[0]
            if age > stale_s:
                breaches.append((f"stall:{name}", {
                    "heartbeat_age_s": round(age, 3),
                    "stale_threshold_s": stale_s}))
            else:
                self._clear(f"stall:{name}")
        for name, floor in floors.items():
            ts_count = self._beats.get(name)
            if ts_count is None or ts_count[1] is None:
                continue
            ts, count = ts_count
            with self._lock:    # watch/unwatch reset this concurrently
                prev = self._rate_state.get(name)
                self._rate_state[name] = (ts, count)
            if prev is None or ts <= prev[0]:
                continue
            rate = (count - prev[1]) / (ts - prev[0])
            self._reg().gauge(f"watchdog_rate_{name}").set(round(rate, 4))
            if rate < floor:
                breaches.append((f"slo:{name}", {
                    "rate": round(rate, 4), "floor": floor}))
            else:
                self._clear(f"slo:{name}")
        for name, (hist, ceiling, windowed) in hists.items():
            if ceiling is None:
                ceiling = self.config.serving_p99_ms
            if ceiling is None:
                continue
            p99 = (self._windowed_p99(name, hist) if windowed
                   else histogram_p99_ms(hist))
            if p99 is None:
                continue
            self._reg().gauge(f"watchdog_p99_{name}").set(p99)
            if p99 > ceiling:
                breaches.append((f"slo:{name}", {
                    "p99_ms": p99, "ceiling_ms": ceiling}))
            else:
                self._clear(f"slo:{name}")
        for name, (fresh_ts, max_age) in fresh.items():
            age = now - fresh_ts
            self._reg().gauge("model_age_seconds",
                              labels={"model": name}).set(round(age, 3))
            if max_age is None:
                max_age = self.config.model_age_max_s
            if max_age is None:
                continue
            if age > max_age:
                breaches.append((f"freshness:{name}", {
                    "model_age_s": round(age, 3),
                    "max_age_s": max_age}))
            else:
                self._clear(f"freshness:{name}")
        for name, (sample_fn, floor) in avail.items():
            if floor is None:
                floor = self.config.availability_floor
            try:
                completed, failed = sample_fn()
            except Exception:  # noqa: BLE001 — a dead sampler never kills
                continue       # the sweep (the fleet may be closing)
            with self._lock:    # watch/unwatch reset this concurrently
                prev = self._avail_state.get(name)
                self._avail_state[name] = (completed, failed)
            if prev is None:
                continue
            dc, df = completed - prev[0], failed - prev[1]
            if dc + df <= 0:
                continue
            a = dc / (dc + df)
            self._reg().gauge("fleet_availability",
                              labels={"model": name}).set(round(a, 6))
            if floor is None:
                continue
            if a < floor:
                breaches.append((f"availability:{name}", {
                    "availability": round(a, 6), "floor": floor,
                    "window_completed": dc, "window_failed": df}))
            else:
                self._clear(f"availability:{name}")
        for slo, evidence in breaches:
            self._breach(slo, evidence)
        return breaches

    # -------------------------------------------------------------- sentry

    @property
    def running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def start(self) -> None:
        if self.running:
            return
        self._stop.clear()

        def loop():
            while not self._stop.wait(self.config.check_interval_s):
                try:
                    self.check_once()
                except Exception:  # noqa: BLE001 — the sentry never dies
                    pass

        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="lgbt-slo-watchdog")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=2.0)
        self._thread = None


global_watchdog = Watchdog()


def beat(name: str, count: Optional[float] = None) -> None:
    """Module-level heartbeat against the process watchdog."""
    global_watchdog._beats[name] = (time.monotonic(), count)


def maybe_start_from_env() -> bool:
    """Start the process watchdog when env opts in
    (``LIGHTGBM_TPU_WATCHDOG=1`` or any ``LIGHTGBM_TPU_SLO_*`` set);
    idempotent.  Returns whether the sentry is running."""
    if global_watchdog.running:
        return True
    opted = (envflags.read(_WATCHDOG_ENV) or "") not in ("", "0")
    cfg = SLOConfig.from_env()
    if not opted and cfg.trees_per_sec_floor is None \
            and cfg.serving_p99_ms is None \
            and cfg.model_age_max_s is None \
            and cfg.availability_floor is None \
            and _env_float(_SLO_STALE_ENV) is None:
        return False
    global_watchdog.config = cfg
    global_watchdog.start()
    return True
