"""Fault-aware pod router: replicated serving over logical devices with
health-checked failover, hedged retries and brownout degradation
(counterpart of ``lightgbm_tpu/fleet/router.py``).

``PodFleet`` is the multi-device front door: N logical serving devices,
each running its own one-device ``Fleet`` (weighted admission,
shared-memory residency, its own AOT store), with the placement planner
(``fleet/topology.py``) deciding which device hosts which replica and
this router deciding which replica serves which request.  As in the JAX
package, the N devices are simulated: N per-device fleets on one
backend, the caller's device (the CUDA card by default; a host without
CUDA refuses the default).  Placing replicas on distinct cards is not
part of it.

Replicas serve bit-identical raw scores, so retrying, hedging and
failing over never change an answer:

* **health-scored routing**: every replica is scored from the
  watchdog's signals: its batcher's liveness-beat staleness, its
  request-latency p99 against the configured ceiling, and its windowed
  error rate.  A replica stale for ``dead_strikes`` consecutive sweeps
  is declared dead and its device drained; degraded replicas are routed
  around, not killed.
* **device-local dispatch, then spillover**: requests go to the
  model's primary replica first; when it is sick or saturated they
  spill to a same-slice replica before a cross-slice one
  (``fleet_spillover_total{tier="ici"|"dcn"}``, the JAX package's
  labels; the port's devices are all in one slice).
* **hedged retries**: an interactive-class request not done by its
  hedge deadline (``hedge_ms``, else ``hedge_fraction`` of its deadline)
  is duplicated onto a second replica; the first completion wins.
* **brownout degradation**: pressure on a model's replica set degrades
  in tiers: shed the batch class (typed), prefer its low-precision twin
  where an ``accuracy_budget`` admitted one, and finally shed every
  class (``QueueFull``).  A pod on the CPU serves that last tier through
  the bit-identical host path in the caller's thread instead.
* **failover**: a lost device (the chaos ``device`` site: wedge / error
  / vanish; or ``kill_device``) is drained: routing stops, its
  in-flight requests are re-dispatched to surviving replicas, a flight
  bundle is dumped (``flight_fleet_device_lost_*``), and the replan
  re-places the topology over the survivors.  A request that finds no
  replica left fails typed: ``QueueFull`` where every replica it tried
  was full, else ``DeviceLost``.

The host path serves a pod's requests only where it cannot hide the
card: on a pod whose device is the CPU, and for a model the topology
plan placed no replica of (the one-device fleet's evicted-model path).
A pod on the card never moves a placed model's work to the host.

Availability is a first-class number: per-model
``fleet_completed_total`` / ``fleet_failed_total`` counters feed the
watchdog's ``LIGHTGBM_TPU_SLO_AVAILABILITY`` floor, and typed
shed/expired outcomes never count as failures.
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from concurrent.futures import Future, InvalidStateError, ThreadPoolExecutor
from concurrent.futures import TimeoutError as FuturesTimeoutError
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..obs.metrics import global_registry as _obs_registry
from ..obs.trace import instant as _instant
from ..obs.watchdog import global_watchdog, histogram_p99_ms
from ..ops.planner import FleetModelShape
from ..serving.batcher import BucketLadder
from ..serving.errors import (DeadlineExceeded, DeviceLost, ModelNotFound,
                              QueueFull, ServerClosed, ServingError)
from ..serving.metrics import MetricsRegistry
from ..serving.registry import CompiledModel
from ..serving.server import Server, as_booster
from .registry import DEFAULT_DEADLINE_CLASSES, Fleet, FleetConfig
from .topology import DeviceSpec, TopologyPlan, plan_devices, plan_topology

# router-retriable failures: the replica (or its device) is the problem,
# not the request — a surviving replica serves the same bits
_RETRIABLE = (DeviceLost, ServerClosed, OSError)


@dataclass
class RouterConfig:
    """Routing / health / brownout knobs; defaults are serving-sane and
    every threshold is a plain float a test can pin."""

    # hedging: interactive-class requests duplicate onto a second
    # replica after hedge_ms (else hedge_fraction of the deadline)
    hedge_ms: Optional[float] = None
    hedge_fraction: float = 0.5
    hedge_classes: tuple = ("interactive",)
    # health scoring (fed by the watchdog; module docstring)
    stale_beat_s: float = 5.0           # beat older than this = a strike
    dead_strikes: int = 3               # consecutive strikes = device dead
    p99_ceiling_ms: Optional[float] = None      # degraded above this
    error_window_s: float = 30.0
    error_rate_degraded: float = 0.25   # window error share -> degraded
    health_interval_s: float = 0.5      # health-sweep thread period
    # spillover / brownout pressure thresholds (queued / queue capacity
    # over a model's live replica set)
    saturation: float = 0.60            # spill off a loaded primary
    brownout_shed: float = 0.75         # tier >= 1: shed batch class
    brownout_lowprec: float = 0.85      # tier >= 2: prefer lowprec twin
    brownout_host: float = 0.95         # tier >= 3: shed every class
    #                                     (a CPU pod: the host path)


class ReplicaHealth:
    """Windowed health state of one replica; scored on demand from the
    watchdog beat age, the replica's latency histogram, and the
    outcome window this object accumulates."""

    __slots__ = ("beat_name", "_window", "_lock", "strikes", "dead",
                 "degraded", "score")

    def __init__(self, beat_name: str):
        self.beat_name = beat_name
        self._window: deque = deque(maxlen=256)   # guarded-by: _lock
        self._lock = threading.Lock()
        self.strikes = 0
        self.dead = False
        self.degraded = False
        self.score = 1.0

    def record(self, ok: bool) -> None:
        with self._lock:
            self._window.append((time.monotonic(), bool(ok)))

    def error_rate(self, now: float, window_s: float) -> float:
        with self._lock:
            recent = [ok for ts, ok in self._window if now - ts <= window_s]
        if not recent:
            return 0.0
        return 1.0 - sum(recent) / len(recent)

    def assess(self, server, cfg: RouterConfig,
               now: Optional[float] = None) -> float:
        """Recompute ``score``/``degraded``/``strikes`` from the three
        watchdog-fed signals; the caller (the router's health sweep)
        declares death from the strike count."""
        now = time.monotonic() if now is None else now
        score = 1.0
        age = global_watchdog.beat_age(self.beat_name, now)
        if age is not None and age > cfg.stale_beat_s:
            self.strikes += 1
            score = 0.0
        else:
            self.strikes = 0
        degraded = False
        if cfg.p99_ceiling_ms is not None:
            p99 = histogram_p99_ms(
                server.metrics.histogram("request_latency_ms"))
            if p99 is not None and p99 > cfg.p99_ceiling_ms:
                degraded = True
                score = min(score, 0.5)
        if self.error_rate(now, cfg.error_window_s) \
                >= cfg.error_rate_degraded:
            degraded = True
            score = min(score, 0.5)
        self.degraded = degraded
        self.score = 0.0 if self.dead else score
        return self.score


class Replica:
    """One (model, device) serving replica: the device fleet entry it
    lives in, its health state, and the routed requests currently
    riding it (the re-dispatch set when its device dies)."""

    __slots__ = ("name", "inner_name", "device_id", "slice_id", "fleet",
                 "lowprec", "health", "inflight", "primary")

    def __init__(self, name: str, inner_name: str, device_id: int,
                 slice_id: int, dev_fleet: Fleet, lowprec: bool,
                 primary: bool):
        self.name = name
        self.inner_name = inner_name
        self.device_id = device_id
        self.slice_id = slice_id
        self.fleet = dev_fleet
        self.lowprec = lowprec
        self.primary = primary
        self.health = ReplicaHealth(f"fleet.d{device_id}.{inner_name}")
        self.inflight: set = set()      # GIL-atomic add/discard; snapshots
        #                                 via list() (re-dispatch on death)

    @property
    def server(self) -> Server:
        return self.fleet.entry(self.inner_name).server

    def fill(self) -> float:
        """Queue pressure of this replica in [0, 1].  A replica whose
        entry vanished mid-read (a replan dropped it between the table
        snapshot and this call) reads as fully saturated — the router
        routes around it and the next sweep forgets it."""
        try:
            s = self.server
        except (ModelNotFound, ServerClosed):
            return 1.0
        cap = max(s.config.max_queue_rows, 1)
        return s._batcher.queued_rows() / cap


class _ModelSpec:
    """Everything the pod needs to (re)place one model."""

    __slots__ = ("name", "booster", "weight", "deadline_class",
                 "precision", "accuracy_budget", "probe_X",
                 "brownout_precision", "overrides", "host_model",
                 "buckets")

    def __init__(self, name, booster, weight, deadline_class, precision,
                 accuracy_budget, probe_X, brownout_precision, overrides,
                 buckets):
        self.name = name
        self.booster = booster
        self.weight = weight
        self.deadline_class = deadline_class
        self.precision = precision
        self.accuracy_budget = accuracy_budget
        self.probe_X = probe_X
        self.brownout_precision = brownout_precision
        self.overrides = overrides
        self.buckets = buckets
        # the always-there fallback: host-path serving is bit-identical
        # to the device path, so "every replica is gone" degrades to
        # latency, never to unavailability
        self.host_model = CompiledModel(booster, backend="host",
                                        precision=precision)

    @property
    def model(self) -> CompiledModel:
        # loadgen and smoke tools read entry(name).model.num_features /
        # .num_class — same surface as a single-device FleetEntry
        return self.host_model

    def shape(self) -> FleetModelShape:
        f = self.host_model.forest
        return FleetModelShape(
            name=self.name, num_trees=f.num_trees,
            nodes_dim=f.split_feature.shape[1],
            leaves_dim=f.leaf_value.shape[1],
            features=self.host_model.num_features,
            num_class=self.host_model.num_class,
            buckets=self.buckets, weight=self.weight,
            age_s=0.0, precision=self.precision,
            cat_words=(f.cat_words.size if f.has_cat else 0))


class _RoutedRequest:
    """One pod-level request: the outer future the caller holds, the
    devices already tried, and the settle-once accounting that makes
    hedges / failover re-dispatches race-free (whichever attempt
    finishes first wins; the rest are ignored)."""

    __slots__ = ("name", "X", "cls", "deadline_end", "future", "tried",
                 "hedge_timer", "t0", "_lock", "_settled",
                 "prefer_lowprec", "shed")

    def __init__(self, name: str, X: np.ndarray, cls: str,
                 deadline_ms: Optional[float], prefer_lowprec: bool):
        self.name = name
        self.X = X
        self.cls = cls
        self.t0 = time.monotonic()
        self.deadline_end = (self.t0 + deadline_ms / 1e3
                             if deadline_ms is not None else None)
        self.future: Future = Future()
        self.tried: set = set()
        self.hedge_timer: Optional[threading.Timer] = None
        self.prefer_lowprec = prefer_lowprec
        # the last replica's QueueFull: the typed outcome when every
        # replica tried was full
        self.shed: Optional[QueueFull] = None
        self._lock = threading.Lock()
        self._settled = False           # guarded-by: _lock

    def remaining_ms(self) -> Optional[float]:
        if self.deadline_end is None:
            return None
        return (self.deadline_end - time.monotonic()) * 1e3

    def settled(self) -> bool:
        with self._lock:
            if not self._settled and self.future.cancelled():
                self._settled = True
            return self._settled

    def _claim(self) -> bool:
        with self._lock:
            if self._settled:
                return False
            self._settled = True
        return True

    def settle_result(self, result) -> bool:
        if not self._claim():
            return False
        t = self.hedge_timer
        if t is not None:
            t.cancel()
        try:
            self.future.set_result(result)
            return True
        except InvalidStateError:       # cancelled under our feet
            return False

    def settle_failure(self, exc: Exception) -> bool:
        if not self._claim():
            return False
        t = self.hedge_timer
        if t is not None:
            t.cancel()
        try:
            self.future.set_exception(exc)
            return True
        except InvalidStateError:
            return False


class PodFleet:
    """Replicated multi-device serving fleet behind one fault-aware
    router (module docstring).

    Drop-in surface for ``Fleet`` callers: ``add_model`` / ``submit`` /
    ``predict`` / ``swap_model`` / ``remove_model`` / ``warm`` /
    ``export_aot`` / ``close`` plus ``entry(name)`` for
    ``serving.loadgen``.  ``devices=N`` stands up N per-device ``Fleet`` instances
    on ``device`` (the CUDA card unless ``device="cpu"``) whose slice
    layout follows the mesh-plan seam; ``chaos`` attaches a
    ``resilience.faults.ChaosRegistry`` whose ``device`` fault site can
    wedge / error / vanish any device mid-run."""

    def __init__(self, devices: int = 2,
                 device_budget_bytes: Optional[int] = None,
                 router: Optional[RouterConfig] = None,
                 chaos=None, aot_dir: Optional[str] = None,
                 device=None, **fleet_overrides):
        from ..basic import resolve_device
        self.device = resolve_device(device)
        # the host path may serve placed models only off the card
        self._host_ok = self.device.type == "cpu"
        self.router = router or RouterConfig()
        self.chaos = chaos
        self.metrics = MetricsRegistry()
        self._aot_dir = aot_dir
        self._devices: Tuple[DeviceSpec, ...] = plan_devices(
            devices, device_budget_bytes)
        self._slice_of = {d.device_id: d.slice_id for d in self._devices}
        self._fleet_overrides = dict(fleet_overrides)
        self.deadline_classes = dict(
            self._fleet_overrides.pop("deadline_classes", None)
            or DEFAULT_DEADLINE_CLASSES)
        self._device_fleets: Dict[int, Fleet] = {}  # guarded-by: _table_lock
        for d in self._devices:
            self._device_fleets[d.device_id] = self._make_device_fleet(d)
        self._specs: Dict[str, _ModelSpec] = {}     # guarded-by: _table_lock
        self._replicas: Dict[str, List[Replica]] = {}  # guarded-by: _table_lock
        self._dead: set = set()                     # guarded-by: _table_lock
        self._device_lost_listeners: list = []      # guarded-by: _table_lock
        self._topology: Optional[TopologyPlan] = None  # guarded-by: _table_lock
        self._admissions = 0                        # guarded-by: _table_lock
        self._replan_every = int(
            self._fleet_overrides.get("replan_every", 256))
        self._closed = False
        self._table_lock = threading.Lock()
        self._replan_lock = threading.Lock()    # serializes plan application
        self._obs_component = _obs_registry.attach_child(
            "pod_fleet", self.metrics)
        self.metrics.gauge("fleet_live_devices").set(len(self._devices))
        # retry-path host fallbacks (a CPU pod, an unplaced model) run
        # here, never on the batcher or drain thread that observed the
        # failure (a full host-path
        # predict on a device's batcher thread would stall every queued
        # batch on that device); bounded, so a fallback storm queues
        # instead of spawning unbounded threads
        self._fallback_pool = ThreadPoolExecutor(
            max_workers=2, thread_name_prefix="lgbt-pod-hostfb")
        self._health_stop = threading.Event()
        self._health_thread = threading.Thread(
            target=self._health_loop, name="lgbt-pod-health", daemon=True)
        self._health_thread.start()

    # ----------------------------------------------------------- plumbing

    def _make_device_fleet(self, d: DeviceSpec) -> Fleet:
        aot = (os.path.join(self._aot_dir, f"dev{d.device_id}")
               if self._aot_dir else None)
        cfg = dict(self._fleet_overrides)
        cfg.setdefault("hbm_budget_bytes", d.hbm_budget_bytes)
        cfg.setdefault("aot_dir", aot)
        cfg.setdefault("deadline_classes", dict(self.deadline_classes))
        cfg["device"] = str(self.device)
        return Fleet(FleetConfig(**cfg))


    def entry(self, name: str) -> _ModelSpec:
        with self._table_lock:
            spec = self._specs.get(name)
        if spec is None:
            raise ModelNotFound(
                f"pod fleet has no model {name!r}; registered: "
                f"{self.models()}")
        return spec

    def models(self) -> list:
        with self._table_lock:
            return sorted(self._specs)

    @property
    def topology(self) -> Optional[TopologyPlan]:
        return self._topology

    def live_devices(self) -> list:
        with self._table_lock:
            return [d.device_id for d in self._devices
                    if d.device_id not in self._dead]

    def latency_histograms(self) -> dict:
        """``{(model, device_id): request_latency_ms Histogram}`` for
        every live full-precision replica (what a co-resident
        scheduler's brownout guards watch).  Replicas whose entry
        vanished mid-read are skipped, like ``fill()``."""
        with self._table_lock:
            reps = [(name, r) for name, rs in self._replicas.items()
                    for r in rs
                    if not r.lowprec and r.device_id not in self._dead]
        out = {}
        for name, r in reps:
            try:
                hist = r.server.metrics.histogram("request_latency_ms")
            except (ModelNotFound, ServerClosed):
                continue
            out[(name, r.device_id)] = hist
        return out

    # ----------------------------------------------------------- registry

    def add_model(self, name: str, booster_or_path, weight: float = 1.0,
                  deadline_class: str = "standard", precision: str = "f32",
                  accuracy_budget: Optional[float] = None,
                  probe_X=None, brownout_precision: Optional[str] = None,
                  **server_overrides) -> _ModelSpec:
        """Register ``booster_or_path`` pod-wide: the topology planner
        places its replicas, every placed device fleet gets an entry.
        ``brownout_precision`` ("bf16"/"int8") additionally registers a
        low-precision twin wherever the base model lands — admitted only
        under a declared ``accuracy_budget`` — which tier-2 brownout
        prefers under pressure."""
        if self._closed:
            raise ServerClosed("pod fleet is shut down")
        if deadline_class not in self.deadline_classes:
            raise ValueError(
                f"unknown deadline class {deadline_class!r}; configured: "
                f"{sorted(self.deadline_classes)}")
        if weight <= 0:
            raise ValueError("model weight must be positive")
        if brownout_precision is not None and accuracy_budget is None:
            raise ValueError(
                "brownout_precision needs accuracy_budget: an unbudgeted "
                "lowprec twin could serve arbitrarily wrong scores")
        booster = as_booster(booster_or_path, self.device)
        ladder = BucketLadder(
            self._fleet_overrides.get("min_bucket_rows", 8),
            self._fleet_overrides.get("max_batch_rows", 1024))
        spec = _ModelSpec(name, booster, float(weight), deadline_class,
                          precision, accuracy_budget, probe_X,
                          brownout_precision, dict(server_overrides),
                          tuple(ladder.buckets))
        with self._table_lock:
            if name in self._specs:
                raise ValueError(f"model {name!r} already registered; "
                                 "use swap_model to replace it")
            self._specs[name] = spec
        c = self.metrics.counter("fleet_completed_total",
                                 labels={"model": name})
        fcnt = self.metrics.counter("fleet_failed_total",
                                    labels={"model": name})
        global_watchdog.watch_availability(
            name, lambda c=c, f=fcnt: (c.value, f.value))
        try:
            self.replan()
        except ServingError:
            # a base replica that cannot serve (quarantined probe, over
            # its accuracy budget) fails the REGISTRATION, exactly like
            # the single-device Fleet: no spec, no replicas, no watch
            with self._table_lock:
                self._specs.pop(name, None)
                leftovers = self._replicas.pop(name, [])
            global_watchdog.unwatch_availability(name)
            for r in leftovers:
                try:
                    r.fleet.remove_model(r.inner_name, drain=False)
                except ModelNotFound:
                    pass
            raise
        return spec

    def swap_model(self, name: str, booster_or_path, **kw):
        """Hot-swap every replica of ``name`` (per-device Server swap
        semantics: warm, probe, quarantine, atomic flip).  Low-precision
        twins re-quantize and re-probe their accuracy budget against the
        NEW model; a twin that no longer fits its budget is dropped to
        the f32 path (a lost optimization, never a serving failure)."""
        spec = self.entry(name)
        booster = as_booster(booster_or_path, self.device)
        from ..serving.errors import SwapQuarantined
        # under _replan_lock: a replan racing the rolling flip would
        # read spec.booster and could place a replica serving the OLD
        # model next to already-swapped siblings — a persistent bit
        # divergence the hedging/failover design cannot tolerate.  The
        # spec flips FIRST so any replan after the lock releases places
        # the new model only.
        with self._replan_lock:
            spec.booster = booster
            spec.host_model = CompiledModel(booster, backend="host",
                                            precision=spec.precision)
            with self._table_lock:
                replicas = list(self._replicas.get(name, ()))
            for r in replicas:
                if not r.lowprec:
                    r.fleet.swap_model(r.inner_name, booster, **kw)
        for r in replicas:
            if r.lowprec:
                try:
                    r.fleet.swap_model(r.inner_name, booster, **kw)
                except SwapQuarantined as e:
                    from ..utils.log import log_warning
                    log_warning(
                        f"pod fleet: lowprec twin {r.inner_name!r} on "
                        f"device {r.device_id} quarantined against the "
                        f"new model and dropped: {e}")
                    self._drop_replica(name, r.device_id, lowprec=True)

    def remove_model(self, name: str, drain: bool = True) -> None:
        """Unregister ``name`` pod-wide.  The routing table entry is
        removed FIRST (no new dispatch can pick a dying replica), then
        in-flight routed requests drain, then each device fleet removes
        its entry — a replan racing this sees either the full replica
        set or none of it, never a half-closed server."""
        with self._replan_lock:     # a concurrent replan must not re-place
            with self._table_lock:  # or restore what we are removing
                spec = self._specs.pop(name, None)
                replicas = self._replicas.pop(name, [])
            if spec is None:
                raise ModelNotFound(f"pod fleet has no model {name!r}")
            global_watchdog.unwatch_availability(name)
            for r in replicas:
                for req in list(r.inflight):
                    try:
                        req.future.result(timeout=5.0)
                    except Exception:  # noqa: BLE001 — outcome is theirs
                        pass
            for r in replicas:
                try:
                    r.fleet.remove_model(r.inner_name, drain=drain,
                                         timeout=5.0)
                except ModelNotFound:
                    pass
        self.metrics.counter("fleet_models_removed").inc()

    # ----------------------------------------------------------- topology

    def replan(self) -> TopologyPlan:
        """Re-run the placement election over the LIVE devices and apply
        the diff: place missing replicas, drain dropped ones, let each
        device fleet re-elect its own residency.  Called on add/remove,
        every ``replan_every`` admissions, and on device loss — the
        existing tick IS the recovery path."""
        with self._replan_lock:
            with self._table_lock:
                live = [d for d in self._devices
                        if d.device_id not in self._dead]
                specs = dict(self._specs)
                current = {(n, r.device_id, r.lowprec)
                           for n, rs in self._replicas.items() for r in rs}
            if not live:
                raise DeviceLost("every serving device is gone; the pod "
                                 "fleet serves host-path only")
            plan = plan_topology([s.shape() for s in specs.values()], live,
                                 device=self.device)
            wanted = set()
            for pname, dids in plan.replicas.items():
                spec = specs[pname]
                for did in dids:
                    wanted.add((pname, did, False))
                    if spec.brownout_precision is not None:
                        wanted.add((pname, did, True))
            for key in sorted(wanted - current):
                self._place_replica(specs[key[0]], key[1], lowprec=key[2])
            for key in sorted(current - wanted):
                self._drop_replica(*key)
            with self._table_lock:
                self._topology = plan
                for pname, dids in plan.replicas.items():
                    rs = self._replicas.get(pname, [])
                    order = {d: i for i, d in enumerate(dids)}
                    rs.sort(key=lambda r: (order.get(r.device_id, 99),
                                           r.lowprec))
                    for r in rs:
                        r.primary = (not r.lowprec
                                     and bool(dids)
                                     and r.device_id == dids[0])
        self.metrics.counter("fleet_replans_total").inc()
        self.metrics.gauge("fleet_live_devices").set(len(live))
        _instant("fleet.topology", **plan.summary())
        from ..obs.flight import global_flight
        global_flight.set_context(fleet_topology=plan.summary())
        return plan

    def _place_replica(self, spec: _ModelSpec, device_id: int,
                       lowprec: bool) -> None:
        with self._table_lock:
            dev_fleet = self._device_fleets.get(device_id)
        if dev_fleet is None:
            return
        inner = spec.name + ("!lp" if lowprec else "")
        precision = (spec.brownout_precision if lowprec
                     else spec.precision)
        try:
            dev_fleet.add_model(
                inner, spec.booster, weight=spec.weight,
                deadline_class=spec.deadline_class, precision=precision,
                # the declared budget guards EVERY low-precision serving
                # path — a lowprec twin AND a base model registered with
                # precision="bf16"/"int8" (same quarantine a
                # single-device Fleet would apply)
                accuracy_budget=(spec.accuracy_budget
                                 if precision != "f32" else None),
                probe_X=spec.probe_X,
                heartbeat_name=f"fleet.d{device_id}.{inner}",
                **spec.overrides)
        except ServingError as e:
            # a quarantined lowprec TWIN (over its budget) is a skipped
            # OPTIMIZATION, never a failed placement; a base replica
            # that cannot serve (e.g. a low-precision base model over
            # its declared budget) must surface exactly as the
            # single-device Fleet would raise it
            if not lowprec:
                raise
            from ..utils.log import log_warning
            log_warning(f"pod fleet: lowprec twin {inner!r} on device "
                        f"{device_id} not placed: {e}")
            return
        entry = dev_fleet.entry(inner)
        if self.chaos is not None:
            b = entry.server._batcher
            b.run_batch = self.chaos.wrap_device_batch(
                device_id, b.run_batch)
        rep = Replica(spec.name, inner, device_id,
                      self._slice_of[device_id], dev_fleet, lowprec,
                      primary=False)
        with self._table_lock:
            self._replicas.setdefault(spec.name, []).append(rep)
        self.metrics.gauge("replica_health", labels={
            "model": spec.name, "device": device_id}).set(1.0)

    def _drop_replica(self, name: str, device_id: int,
                      lowprec: bool) -> None:
        with self._table_lock:
            rs = self._replicas.get(name, [])
            victim = next((r for r in rs if r.device_id == device_id
                           and r.lowprec == lowprec), None)
            if victim is not None:
                rs.remove(victim)
        if victim is None:
            return
        for req in list(victim.inflight):
            if not req.settled():
                self._route_and_dispatch(req)
        try:
            # bounded join: this can run under _replan_lock, and a
            # wedged-but-not-yet-dead batcher (chaos wedge before the
            # health sweep strikes out) must not freeze every replan
            victim.fleet.remove_model(victim.inner_name, drain=True,
                                      timeout=2.0)
        except ModelNotFound:
            pass

    # ------------------------------------------------------------ serving

    def _pressure(self, name: str) -> Optional[float]:
        """Mean queue fill of ``name``'s live replicas; None with none
        live."""
        with self._table_lock:
            rs = [r for r in self._replicas.get(name, ())
                  if r.device_id not in self._dead]
        if not rs:
            return None
        return sum(r.fill() for r in rs) / len(rs)

    def _tier(self, name: str) -> int:
        p = self._pressure(name)
        if p is None:
            # no live replica: a CPU pod serves on the host (tier 3); on
            # the card routing finds none and fails typed (DeviceLost)
            p = 1.0 if self._host_ok else 0.0
        cfg = self.router
        tier = (3 if p >= cfg.brownout_host else
                2 if p >= cfg.brownout_lowprec else
                1 if p >= cfg.brownout_shed else 0)
        self.metrics.gauge("fleet_brownout_tier",
                           labels={"model": name}).set(tier)
        return tier

    def _pick(self, req: _RoutedRequest) -> Optional[Replica]:
        """Elect the next replica for ``req``: device-local first, then
        same-slice (ICI), then cross-slice (DCN, counted as spillover);
        dead/downed/tried replicas never, degraded and saturated ones
        only when nothing better lives."""
        cfg = self.router
        with self._table_lock:
            rs = [r for r in self._replicas.get(req.name, ())
                  if r.device_id not in self._dead
                  and r.device_id not in req.tried
                  and not r.health.dead]
        if self.chaos is not None:
            rs = [r for r in rs
                  if self.chaos.device_down(r.device_id) is None]
        if req.prefer_lowprec and any(r.lowprec for r in rs):
            rs = [r for r in rs if r.lowprec]
        else:
            rs = [r for r in rs if not r.lowprec]
        if not rs:
            return None
        primary = next((r for r in rs if r.primary), rs[0])
        # one fill() read per replica per pick: each read takes the
        # device fleet's entry lock, so the sort key must not re-read
        fills = {id(r): r.fill() for r in rs}

        def group(r: Replica) -> int:
            if r.device_id == primary.device_id:
                return 0
            return 1 if r.slice_id == primary.slice_id else 2

        best = min(rs, key=lambda r: (
            group(r), r.health.degraded,
            fills[id(r)] >= cfg.saturation, fills[id(r)], r.device_id))
        g = group(best)
        if g > 0:
            self.metrics.counter(
                "fleet_spillover_total",
                labels={"tier": "ici" if g == 1 else "dcn"}).inc()
        return best

    def submit(self, name: str, X, deadline_ms: Optional[float] = None,
               request_class: Optional[str] = None) -> Future:
        """Route one predict request; returns the pod-level Future.
        Typed outcomes: ``QueueFull`` (brownout shed / every replica
        over its share), ``DeadlineExceeded`` (budget spent in queue),
        ``DeviceLost`` (no replica left).  Replica failures are the
        ROUTER's problem — retried on another replica or hedged, not
        surfaced while one lives."""
        if self._closed:
            raise ServerClosed("pod fleet is shut down")
        spec = self.entry(name)
        cls = request_class or spec.deadline_class
        tier = self._tier(name)
        if tier >= 1 and cls == "batch":
            self.metrics.counter("fleet_brownout_shed_total",
                                 labels={"model": name}).inc()
            raise QueueFull(
                f"brownout tier {tier}: batch-class request to {name!r} "
                "shed to protect interactive traffic")
        host = tier >= 3 and self._host_ok
        if tier >= 3 and not host:
            self.metrics.counter("fleet_brownout_shed_total",
                                 labels={"model": name}).inc()
            raise QueueFull(
                f"brownout tier {tier}: {name!r}'s replicas are saturated; "
                "request shed")
        if deadline_ms is None:
            deadline_ms = self.deadline_classes.get(cls)
        X = np.array(X, np.float64, order="C")
        if X.ndim == 1:
            X = X[None, :]
        req = _RoutedRequest(name, X, cls, deadline_ms,
                             prefer_lowprec=tier >= 2)
        self.metrics.counter("fleet_requests_total",
                             labels={"model": name}).inc()
        fut = req.future
        fut.add_done_callback(lambda f: self._account(name, f))
        self._maybe_hedge_later(req)
        if host:
            self._host_fallback(req, spec, sync=True)
        else:
            self._route_and_dispatch(req, sync=True)
        with self._table_lock:  # plain += from N submit threads loses
            self._admissions += 1      # updates and skips the tick
            due = (self._replan_every > 0
                   and self._admissions % self._replan_every == 0)
        if due:
            self.replan()
        return fut

    def predict(self, name: str, X, deadline_ms: Optional[float] = None,
                timeout: Optional[float] = None,
                request_class: Optional[str] = None) -> np.ndarray:
        fut = self.submit(name, X, deadline_ms=deadline_ms,
                          request_class=request_class)
        try:
            return fut.result(timeout)
        except FuturesTimeoutError:
            fut.cancel()
            raise

    def _account(self, name: str, f: Future) -> None:
        m = self.metrics
        try:
            if f.cancelled():
                # a caller-cancelled request (predict wait timeout) is
                # work the pod failed to settle in time — invisible to
                # typed outcomes, so it MUST count against availability
                # or a hang-style failure never breaches the SLO
                m.counter("fleet_cancelled_total",
                          labels={"model": name}).inc()
                m.counter("fleet_failed_total",
                          labels={"model": name}).inc()
                return
            exc = f.exception()
        except Exception:  # noqa: BLE001
            return
        if exc is None:
            m.counter("fleet_completed_total",
                      labels={"model": name}).inc()
        elif isinstance(exc, QueueFull):
            m.counter("fleet_shed_total", labels={"model": name}).inc()
        elif isinstance(exc, DeadlineExceeded):
            m.counter("fleet_expired_total", labels={"model": name}).inc()
        else:
            m.counter("fleet_failed_total", labels={"model": name}).inc()

    # ----------------------------------------------------------- dispatch

    def _route_and_dispatch(self, req: _RoutedRequest,
                            hedged: bool = False,
                            sync: bool = False) -> None:
        if req.settled():
            return
        rem = req.remaining_ms()
        if rem is not None and rem <= 0:
            req.settle_failure(DeadlineExceeded(
                f"deadline budget spent after trying devices "
                f"{sorted(req.tried)}"))
            return
        replica = self._pick(req)
        if replica is None:
            # this can run inside a Future done-callback, where a raise
            # would be swallowed and the outer future never settle: a
            # model removed mid-flight must FAIL the request typed
            try:
                spec = self.entry(req.name)
            except ModelNotFound as e:
                req.settle_failure(e)
                return
            with self._table_lock:
                topo = self._topology
                placed = topo is not None and bool(
                    topo.replicas.get(req.name))
                pending = any(req in r.inflight
                              for r in self._replicas.get(req.name, ()))
            if pending:
                # already re-dispatched (a drain raced this replica's
                # failure) or a hedge with nowhere to go: that try runs
                return
            if self._host_ok or not placed:
                self._host_fallback(req, spec, sync=sync)
            elif req.shed is not None:
                req.settle_failure(req.shed)
            else:
                req.settle_failure(DeviceLost(
                    f"no live replica of {req.name!r} left (devices "
                    f"tried: {sorted(req.tried)})"))
            return
        self._dispatch(req, replica, hedged=hedged)

    def _dispatch(self, req: _RoutedRequest, replica: Replica,
                  hedged: bool) -> None:
        req.tried.add(replica.device_id)
        # in flight from before the submit: a failure path racing this
        # dispatch sees the request pending and leaves it alone
        replica.inflight.add(req)
        try:
            inner = replica.fleet.submit(replica.inner_name, req.X,
                                         deadline_ms=req.remaining_ms())
        except (QueueFull, ModelNotFound) as e:
            # ModelNotFound: a replan dropped this replica between the
            # table snapshot and the submit — the device is fine, the
            # request is routable; try the next replica, never surface
            # a non-typed failure for a transient placement move
            replica.inflight.discard(req)
            if isinstance(e, QueueFull):
                req.shed = e
            self._route_and_dispatch(req, hedged=hedged)
            return
        except _RETRIABLE as e:
            replica.inflight.discard(req)
            self._replica_failed(req, replica, e, hedged)
            return
        inner.add_done_callback(
            lambda f: self._on_done(req, replica, f, hedged))

    def _on_done(self, req: _RoutedRequest, replica: Replica, f: Future,
                 hedged: bool) -> None:
        replica.inflight.discard(req)
        if req.settled():
            return
        try:
            if f.cancelled():
                return
            exc = f.exception()
        except Exception:  # noqa: BLE001 — cancelled between the checks
            return
        if exc is None:
            out = np.asarray(f.result())
            if not np.isfinite(out).all():
                self.metrics.counter("fleet_nonfinite_total",
                                     labels={"model": req.name}).inc()
                self._replica_failed(req, replica, ServingError(
                    f"replica on device {replica.device_id} returned "
                    "non-finite scores"), hedged)
                return
            replica.health.record(True)
            if req.settle_result(f.result()) and hedged:
                self.metrics.counter("fleet_hedge_wins_total",
                                     labels={"model": req.name}).inc()
            return
        if isinstance(exc, DeadlineExceeded):
            req.settle_failure(exc)
            return
        if isinstance(exc, QueueFull):
            req.shed = exc
            self._route_and_dispatch(req, hedged=hedged)
            return
        if isinstance(exc, _RETRIABLE):
            self._replica_failed(req, replica, exc, hedged)
            return
        replica.health.record(False)
        req.settle_failure(exc)

    def _replica_failed(self, req: _RoutedRequest, replica: Replica,
                        exc: Exception, hedged: bool) -> None:
        replica.health.record(False)
        if isinstance(exc, DeviceLost):
            self._device_lost(replica.device_id, str(exc))
        self.metrics.counter("fleet_failover_redispatch_total",
                             labels={"model": req.name}).inc()
        self._route_and_dispatch(req, hedged=hedged)

    def _host_fallback(self, req: _RoutedRequest, spec: _ModelSpec,
                       sync: bool = True) -> None:
        """The bit-identical host path, for a CPU pod's last resort and a
        model placed on no device.  ``sync`` (the submit-time tier-3
        brownout, or a submit that found no replica) computes in the
        CALLER's thread — the latency is the backpressure; retry paths
        (which run on batcher / drain / timer threads that must not
        stall) hand the compute to the bounded fallback pool."""
        self.metrics.counter("fleet_host_fallback_total",
                             labels={"model": req.name}).inc()
        if not sync:
            try:
                self._fallback_pool.submit(self._host_fallback_run,
                                           req, spec)
                return
            except RuntimeError:    # pool shut down mid-close: inline
                pass
        self._host_fallback_run(req, spec)

    def _host_fallback_run(self, req: _RoutedRequest,
                           spec: _ModelSpec) -> None:
        try:
            K = spec.host_model.num_class
            raw = spec.host_model.forest.predict_raw(req.X, num_class=K)
            raw = spec.host_model.scale_raw(np.asarray(raw, np.float64))
            req.settle_result(raw[0] if K == 1 else raw.T)
        except Exception as e:  # noqa: BLE001 — surface, nothing left
            req.settle_failure(e)

    # ------------------------------------------------------------ hedging

    def _maybe_hedge_later(self, req: _RoutedRequest) -> None:
        cfg = self.router
        if req.cls not in cfg.hedge_classes:
            return
        if cfg.hedge_ms is not None:
            delay = cfg.hedge_ms / 1e3
        elif req.deadline_end is not None:
            delay = max(req.deadline_end - req.t0, 0.0) \
                * cfg.hedge_fraction
        else:
            return

        def fire():
            if req.settled():
                return
            self.metrics.counter("fleet_hedges_total",
                                 labels={"model": req.name}).inc()
            self._route_and_dispatch(req, hedged=True)

        t = threading.Timer(delay, fire)
        t.daemon = True
        req.hedge_timer = t
        t.start()

    # ------------------------------------------------------------- health

    def check_health(self, now: Optional[float] = None) -> dict:
        """One synchronous health sweep over every live replica (the
        sentry thread calls this every ``health_interval_s``; tests call
        it directly).  Returns {(model, device): score}."""
        cfg = self.router
        with self._table_lock:
            replicas = [r for rs in self._replicas.values() for r in rs
                        if r.device_id not in self._dead]
        scores = {}
        doomed = set()
        for r in replicas:
            try:
                score = r.health.assess(r.server, cfg, now)
            except ModelNotFound:       # mid-drop: next sweep is clean
                continue
            scores[(r.name, r.device_id)] = score
            self.metrics.gauge("replica_health", labels={
                "model": r.name, "device": r.device_id}).set(score)
            if r.health.strikes >= cfg.dead_strikes:
                doomed.add(r.device_id)
            if self.chaos is not None and \
                    self.chaos.device_down(r.device_id) == "vanish":
                doomed.add(r.device_id)
        for did in doomed:
            self._device_lost(did, "health: stale heartbeat")
        return scores

    def _health_loop(self) -> None:
        while not self._health_stop.wait(self.router.health_interval_s):
            try:
                self.check_health()
            except Exception:  # noqa: BLE001 — the sweep never dies
                pass

    # ------------------------------------------------------------ failover

    def kill_device(self, device_id: int,
                    reason: str = "operator kill") -> None:
        """Declare ``device_id`` dead NOW (drills, orchestration): drain
        it, re-dispatch its in-flight requests, replan the topology."""
        self._device_lost(device_id, reason, wait=True)

    def add_device_lost_listener(self, fn) -> None:
        """Register ``fn(device_id, reason, recovered)`` to run after a
        lost device's drain settles (serving replan done or abandoned).
        A co-resident training scheduler hooks here, so that a device
        loss shrinks its world in the same replan that drained the
        serving replicas.  Exceptions are swallowed: a broken hook never
        blocks the drain."""
        with self._table_lock:
            if fn not in self._device_lost_listeners:
                self._device_lost_listeners.append(fn)

    def remove_device_lost_listener(self, fn) -> None:
        with self._table_lock:
            if fn in self._device_lost_listeners:
                self._device_lost_listeners.remove(fn)

    def _notify_device_lost(self, device_id: int, reason: str,
                            recovered: bool) -> None:
        with self._table_lock:
            listeners = list(self._device_lost_listeners)
        for fn in listeners:
            try:
                fn(device_id, reason, recovered)
            except Exception:  # noqa: BLE001 — hooks never block the drain
                pass

    def _device_lost(self, device_id: int, reason: str,
                     wait: bool = False) -> None:
        with self._table_lock:
            if device_id in self._dead:
                return
            self._dead.add(device_id)
        self.metrics.counter("fleet_devices_lost_total").inc()
        # the drain runs off-thread: a DeviceLost often surfaces INSIDE
        # the dying device's own batcher thread, which must not try to
        # join itself through Fleet.close
        t = threading.Thread(target=self._drain_device,
                             args=(device_id, reason),
                             name=f"lgbt-pod-drain-{device_id}",
                             daemon=True)
        t.start()
        if wait:
            t.join()

    def _drain_device(self, device_id: int, reason: str) -> None:
        with self._table_lock:
            victims = [r for rs in self._replicas.values() for r in rs
                       if r.device_id == device_id]
            for name in list(self._replicas):
                self._replicas[name] = [
                    r for r in self._replicas[name]
                    if r.device_id != device_id]
            dev_fleet = self._device_fleets.get(device_id)
        for r in victims:
            r.health.dead = True
            self.metrics.gauge("replica_health", labels={
                "model": r.name, "device": device_id}).set(0.0)
        redispatched = 0
        for r in victims:
            for req in list(r.inflight):
                r.inflight.discard(req)
                if not req.settled():
                    redispatched += 1
                    self.metrics.counter(
                        "fleet_failover_redispatch_total",
                        labels={"model": req.name}).inc()
                    self._route_and_dispatch(req)
        if dev_fleet is not None:
            try:
                dev_fleet.close(drain=False, timeout=1.0)
            except Exception:  # noqa: BLE001 — a wedged batcher must not
                pass           # block the drain of everyone else
        from ..obs.flight import global_flight
        global_flight.dump("fleet:device_lost", extra={
            "device": device_id, "reason": reason,
            "redispatched_inflight": redispatched,
            "models": sorted({r.name for r in victims})})
        _instant("fleet.failover", device=device_id, reason=reason,
                 redispatched=redispatched)
        try:
            plan = self.replan()
        except DeviceLost:
            # every device gone: a CPU pod serves on the host from here,
            # a pod on the card fails requests with DeviceLost
            self._notify_device_lost(device_id, reason, recovered=False)
            return
        except ServingError as e:  # a replacement replica quarantined:
            from ..utils.log import log_warning   # recovery is partial,
            log_warning(                          # the drain lives on
                f"pod fleet: replan after losing device {device_id} "
                f"failed: {e}")
            self._notify_device_lost(device_id, reason, recovered=False)
            return
        # the acceptance bar: the FIRST replan after a loss restores
        # every model's replica coverage — recovery within one tick
        with self._table_lock:
            ok = all(len(plan.replicas.get(n, ())) > 0
                     for n in self._specs)
        self.metrics.gauge("fleet_recovered_one_tick").set(int(ok))
        self._notify_device_lost(device_id, reason, recovered=bool(ok))

    # ----------------------------------------------------------- warm/aot

    def warm(self) -> int:
        n = 0
        with self._table_lock:
            fleets = [f for d, f in self._device_fleets.items()
                      if d not in self._dead]
        for f in fleets:
            n += f.warm()
        return n

    def export_aot(self, path: Optional[str] = None) -> int:
        """Per-device AOT export: each device fleet serializes into its
        OWN subdirectory (``dev<id>/``) so a replacement device restores
        exactly the programs its residency plan warmed."""
        base = path or self._aot_dir
        if base is None:
            raise ServingError("no AOT directory configured: pass path= "
                               "or construct with aot_dir=")
        n = 0
        with self._table_lock:
            items = [(d, f) for d, f in self._device_fleets.items()
                     if d not in self._dead]
        for did, f in items:
            n += f.export_aot(os.path.join(base, f"dev{did}"))
        return n

    # ---------------------------------------------------------- lifecycle

    def close(self, drain: bool = True,
              timeout: Optional[float] = None) -> None:
        if self._closed:
            return
        self._closed = True
        self._health_stop.set()
        self._health_thread.join(timeout=2.0)
        self._fallback_pool.shutdown(wait=False)
        with self._table_lock:
            names = sorted(self._specs)
            fleets = list(self._device_fleets.values())
        for name in names:
            global_watchdog.unwatch_availability(name)
        for f in fleets:
            try:
                f.close(drain=drain, timeout=timeout)
            except Exception:  # noqa: BLE001 — close everything we can
                pass
        _obs_registry.detach_child(self._obs_component)

    def __enter__(self) -> "PodFleet":
        return self

    def __exit__(self, *exc) -> None:
        self.close(drain=True)

    # ------------------------------------------------------------ metrics

    def metrics_dict(self) -> dict:
        out = self.metrics.to_dict()
        with self._table_lock:
            fleets = {d: f for d, f in self._device_fleets.items()
                      if d not in self._dead}
        out["devices"] = {str(d): f.metrics_dict()
                          for d, f in sorted(fleets.items())}
        return out

    def availability(self, name: str) -> Optional[float]:
        """Cumulative availability of ``name``: completed / (completed +
        non-typed failed); None before any outcome.  Typed shed/expired
        are excluded — they are correct overload behavior."""
        c = self.metrics.counter("fleet_completed_total",
                                 labels={"model": name}).value
        f = self.metrics.counter("fleet_failed_total",
                                 labels={"model": name}).value
        if c + f <= 0:
            return None
        return c / (c + f)

    def prometheus_text(self, prefix: str = "lgbt_pod") -> str:
        parts = [self.metrics.to_prometheus(prefix=prefix)]
        with self._table_lock:
            fleets = {d: f for d, f in self._device_fleets.items()
                      if d not in self._dead}
        for d, f in sorted(fleets.items()):
            parts.append(f.prometheus_text(prefix=f"{prefix}_dev{d}"))
        return "".join(parts)
