"""The serving fleet: one front door over N hot-swappable models that
share one card's memory (counterpart of ``lightgbm_tpu/fleet/registry.py``).

Each named model gets its own ``serving.Server`` (bucket ladder,
micro-batcher, program LRU, hot-swap: every single-model rule carries
over), and the fleet adds three policies on top:

* **Shared-memory residency** (``ops.planner.plan_fleet``): the planner
  counts every model's ``DeviceForest`` bytes and the bytes of its
  warmed bucket programs against the card's budget and elects which
  models stay on the card; the rest are evicted (their device tensors
  and programs released, ``CompiledModel.drop_device``) and serve
  through the bit-identical host path until a replan readmits them.
* **Weighted admission**: one fleet-wide queue-row budget.  Under it
  every request is admitted; over it, a model is admitted only up to its
  weight's share, so heavy traffic to one model sheds its own overflow
  (typed ``QueueFull``), never a lighter model's share.  Deadline
  classes give each model a default deadline.
* **Stored programs** (``fleet/aot.py``): ``export_aot`` stores every
  resident bucket program; a fresh fleet pointed at the store restores
  them (``aot_program_loads``) and builds none (``compile_events``).

A model given as a path is loaded onto the fleet's device: the CUDA card
unless ``device="cpu"``; a host without CUDA refuses the default.  The
per-model series ride the process registry (``obs.metrics``) with
``model="<name>"`` labels, and every replan records a ``fleet.plan``
instant and puts the plan into the flight recorder's context.
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import TimeoutError as FuturesTimeoutError
from dataclasses import dataclass, field
from typing import Dict, Optional

import numpy as np

from ..obs.metrics import global_registry as _obs_registry
from ..obs.trace import instant as _instant
from ..obs.watchdog import beat as _beat
from ..ops.planner import FleetModelShape, FleetPlan, plan_fleet
from ..serving.errors import ModelNotFound, QueueFull, ServerClosed
from ..serving.metrics import MetricsRegistry
from ..serving.server import Server, ServingConfig, as_booster

# deadline classes: per-model default deadline when a request names none
# (None = no deadline).  Values are milliseconds.
DEFAULT_DEADLINE_CLASSES = {
    "interactive": 50.0,
    "standard": 250.0,
    "batch": None,
}


@dataclass
class FleetConfig:
    """Fleet-wide knobs; per-model Server knobs ride ``add_model``."""

    max_queue_rows: int = 1 << 16       # fleet-wide admission budget
    hbm_budget_bytes: Optional[int] = None   # None = the card's limit
    aot_dir: Optional[str] = None       # None = LGBM_TPU_COMPILE_CACHE/serving
    backend: str = "device"             # default per-model backend
    min_bucket_rows: int = 8            # default per-model ladder
    max_batch_rows: int = 1024
    batch_window_ms: float = 2.0
    max_programs: int = 64
    replan_every: int = 256             # admissions between auto replans
    deadline_classes: Dict[str, Optional[float]] = field(
        default_factory=lambda: dict(DEFAULT_DEADLINE_CLASSES))
    # where model paths load and whose memory the plan budgets: None is
    # the CUDA card
    device: Optional[str] = None

    def __post_init__(self):
        if self.backend not in ("device", "host"):
            raise ValueError(f"unknown fleet backend {self.backend!r}")


class FleetEntry:
    """One registered model: its server plus the fleet-side policy state."""

    __slots__ = ("name", "server", "weight", "deadline_class", "precision",
                 "resident", "resident_buckets", "last_used")

    def __init__(self, name: str, server: Server, weight: float,
                 deadline_class: str, precision: str):
        self.name = name
        self.server = server
        self.weight = weight
        self.deadline_class = deadline_class
        self.precision = precision
        self.resident = server.config.backend == "device"
        self.resident_buckets = tuple(server.ladder.buckets)
        self.last_used = time.monotonic()

    @property
    def model(self):
        return self.server.models.active

    def queued_rows(self) -> int:
        return self.server._batcher.queued_rows()


class Fleet:
    """Multi-model registry, planner-driven residency and a weighted
    front door (module docstring)."""

    def __init__(self, config: Optional[FleetConfig] = None, **overrides):
        if config is None:
            config = FleetConfig(**overrides)
        elif overrides:
            raise ValueError("pass either config or keyword overrides")
        from ..basic import resolve_device
        self.config = config
        self.device = resolve_device(config.device)
        self.metrics = MetricsRegistry()
        self._entries: Dict[str, FleetEntry] = {}   # guarded-by: _lock
        self._lock = threading.Lock()       # entry map + counters (cheap ops)
        self._replan_lock = threading.Lock()    # serializes plan application
        self._admissions = 0                        # guarded-by: _lock
        self._closed = False
        self._plan: Optional[FleetPlan] = None      # guarded-by: _lock
        self._obs_component = _obs_registry.attach_child(
            "fleet", self.metrics)

    # ------------------------------------------------------------ registry

    def models(self) -> list:
        with self._lock:
            return sorted(self._entries)

    def entry(self, name: str) -> FleetEntry:
        with self._lock:
            e = self._entries.get(name)
        if e is None:
            raise ModelNotFound(
                f"fleet has no model {name!r}; registered: "
                f"{self.models()}")
        return e

    def add_model(self, name: str, booster_or_path, weight: float = 1.0,
                  deadline_class: str = "standard",
                  precision: str = "f32",
                  accuracy_budget: Optional[float] = None,
                  probe_X=None, replan: bool = True,
                  **server_overrides) -> FleetEntry:
        """Register ``booster_or_path`` under ``name`` and replan
        residency.

        ``precision`` opts the model into bf16/int8 serving held to
        ``accuracy_budget`` on a probe batch — a candidate over its
        budget raises ``LowPrecisionQuarantined`` and is NOT registered.
        ``weight`` scales both its admission share and its residency
        priority; ``deadline_class`` names its default deadline
        (config.deadline_classes)."""
        if self._closed:
            raise ServerClosed("fleet is shut down")
        if deadline_class not in self.config.deadline_classes:
            raise ValueError(
                f"unknown deadline class {deadline_class!r}; configured: "
                f"{sorted(self.config.deadline_classes)}")
        if weight <= 0:
            raise ValueError("model weight must be positive")
        with self._lock:
            if name in self._entries:
                raise ValueError(f"model {name!r} already registered; use "
                                 "swap_model to replace it")
        cfg = dict(
            backend=self.config.backend,
            min_bucket_rows=self.config.min_bucket_rows,
            max_batch_rows=self.config.max_batch_rows,
            batch_window_ms=self.config.batch_window_ms,
            max_programs=self.config.max_programs,
            # each server gets the WHOLE fleet budget: the fleet-level
            # weighted check is the binding one under contention
            max_queue_rows=self.config.max_queue_rows,
            precision=precision, accuracy_budget=accuracy_budget,
            probe_X=probe_X, aot_dir=self.config.aot_dir)
        cfg.update(server_overrides)
        booster = as_booster(booster_or_path, self.device)
        server = Server(booster, ServingConfig(**cfg))   # may quarantine
        entry = FleetEntry(name, server, weight, deadline_class, precision)
        with self._lock:
            if name in self._entries:       # lost a registration race
                server.close(drain=False)
                raise ValueError(f"model {name!r} already registered")
            self._entries[name] = entry
        m = self.metrics
        m.counter("fleet_models_added").inc()
        m.gauge("model_weight", labels={"model": name}).set(weight)
        m.gauge("model_digest", labels={"model": name}).set(
            entry.model.digest)
        m.gauge("model_precision", labels={"model": name}).set(precision)
        if entry.precision != "f32":
            m.gauge("lowprec_accuracy_delta", labels={"model": name}).set(
                server.metrics.gauge("lowprec_accuracy_delta").value)
        if replan:
            self.replan()
        return entry

    def remove_model(self, name: str, drain: bool = True,
                     timeout: Optional[float] = None) -> None:
        """Unregister ``name``: DRAIN it, then replan — never race a
        replan in flight.  ``replan`` applies residency under
        ``_replan_lock`` while reading each entry's server; closing one
        mid-apply would restore/drop device arrays on a dying server
        (and an eviction landing between the pop and the close could
        resurrect its programs).  Holding the same lock makes removal
        atomic with respect to plan application: a concurrent replan
        sees the entry either fully alive or fully gone.  ``timeout``
        bounds the batcher-thread join (the pod router passes one so a
        wedged-but-not-yet-dead device can never freeze a replan)."""
        e = self.entry(name)
        with self._replan_lock:
            with self._lock:
                self._entries.pop(name, None)
            e.server.close(drain=drain, timeout=timeout)
        self.metrics.counter("fleet_models_removed").inc()
        self.replan()

    def set_weight(self, name: str, weight: float) -> None:
        """Re-weight one fleet member (admission share + residency
        priority) and replan — the lifecycle canary ramp drives this at
        every step in the JAX package's lifecycle module)."""
        if weight <= 0:
            raise ValueError("model weight must be positive")
        e = self.entry(name)
        e.weight = float(weight)
        self.metrics.gauge("model_weight", labels={"model": name}).set(
            float(weight))
        self.replan()

    def swap_model(self, name: str, booster_or_path, **kw):
        """Hot-swap one fleet member (Server.swap_model semantics: warm,
        probe, quarantine, atomic flip) and replan residency for the new
        shape."""
        e = self.entry(name)
        out = e.server.swap_model(booster_or_path, **kw)
        self.metrics.gauge("model_digest", labels={"model": name}).set(
            e.model.digest)
        self.replan()
        return out

    # ------------------------------------------------------------- serving

    def _class_deadline(self, entry: FleetEntry) -> Optional[float]:
        return self.config.deadline_classes.get(entry.deadline_class)

    def _admit(self, entry: FleetEntry, n: int) -> None:
        """Weighted admission: under the fleet budget everyone is
        admitted; over it, a model may only occupy its weight's share of
        the queue — overflow traffic to one model sheds ITS requests
        (typed QueueFull), never a lighter model's protected share."""
        with self._lock:
            live = list(self._entries.values())
        total = sum(e.queued_rows() for e in live)
        cap = self.config.max_queue_rows
        if total + n <= cap:
            return
        wsum = sum(e.weight for e in live) or 1.0
        share = entry.weight / wsum * cap
        if entry.queued_rows() + n <= share:
            return
        self.metrics.counter("fleet_shed_total",
                             labels={"model": entry.name}).inc()
        raise QueueFull(
            f"fleet queue at {total} rows (cap {cap}); model "
            f"{entry.name!r} is over its weighted share of "
            f"{share:.0f} rows — shed")

    def submit(self, name: str, X, deadline_ms: Optional[float] = None):
        """Enqueue a predict request for model ``name``; returns the
        Future.  ``deadline_ms`` defaults to the model's deadline class;
        sheds with ``QueueFull`` when the model exceeds its weighted
        share of a contended fleet queue."""
        if self._closed:
            raise ServerClosed("fleet is shut down")
        entry = self.entry(name)
        entry.last_used = time.monotonic()
        X = np.asarray(X)
        n = X.shape[0] if X.ndim >= 2 else 1
        self._admit(entry, n)
        if deadline_ms is None:
            deadline_ms = self._class_deadline(entry)
        m = self.metrics
        m.counter("fleet_requests_total", labels={"model": name}).inc()
        _beat("fleet.submit")
        t0 = time.monotonic()
        fut = entry.server.submit(X, deadline_ms=deadline_ms)
        hist = m.histogram("request_latency_ms", labels={"model": name})

        def _record(f):
            try:
                if f.cancelled() or f.exception() is not None:
                    return
            except Exception:      # cancelled between the two checks
                return
            hist.observe((time.monotonic() - t0) * 1e3)

        fut.add_done_callback(_record)
        with self._lock:        # plain += from N submit threads loses
            self._admissions += 1      # updates and can skip the trigger
            due = (self.config.replan_every > 0
                   and self._admissions % self.config.replan_every == 0)
        if due:
            self.replan()
        return fut

    def predict(self, name: str, X, deadline_ms: Optional[float] = None,
                timeout: Optional[float] = None) -> np.ndarray:
        """Synchronous submit + wait (Server.predict semantics)."""
        fut = self.submit(name, X, deadline_ms=deadline_ms)
        try:
            return fut.result(timeout)
        except FuturesTimeoutError:
            fut.cancel()
            raise

    # ----------------------------------------------------------- residency

    def _shapes(self) -> list:
        now = time.monotonic()
        shapes = []
        with self._lock:
            entries = list(self._entries.values())
        for e in entries:
            f = e.model.forest
            shapes.append(FleetModelShape(
                name=e.name,
                num_trees=f.num_trees,
                nodes_dim=f.split_feature.shape[1],
                leaves_dim=f.leaf_value.shape[1],
                features=e.model.num_features,
                num_class=e.model.num_class,
                buckets=tuple(e.server.ladder.buckets),
                weight=e.weight,
                age_s=max(now - e.last_used, 0.0),
                precision=e.precision,
                cat_words=(f.cat_words.size if f.has_cat else 0)))
        return shapes

    def replan(self) -> FleetPlan:
        """Re-run the shared-memory residency election and apply it: evict
        the device tensors and programs of models the plan demotes,
        restore models it readmits.  Cheap enough to call per-swap and
        every ``replan_every`` admissions."""
        plan = plan_fleet(self._shapes(),
                          budget_bytes=self.config.hbm_budget_bytes,
                          device=self.device)
        # apply OUTSIDE self._lock: restore_device is a full device upload
        # and must not stall the submit path's admission check.  Programs
        # read the device pointer at call time, so flipping residency
        # mid-flight is safe; _replan_lock keeps two replans from
        # interleaving their drop/restore sequences.
        with self._replan_lock:
            for mp in plan.models:
                with self._lock:
                    e = self._entries.get(mp.name)
                if e is None or e.server.config.backend != "device":
                    continue
                am = e.model
                if mp.resident and am.device_forest is None:
                    am.restore_device()
                    e.server.programs.evict_model(am.digest)
                    self.metrics.counter(
                        "fleet_restores", labels={"model": mp.name}).inc()
                elif not mp.resident and am.device_forest is not None:
                    am.drop_device()
                    e.server.programs.evict_model(am.digest)
                    self.metrics.counter(
                        "fleet_evictions", labels={"model": mp.name}).inc()
                e.resident = mp.resident
                e.resident_buckets = mp.resident_buckets
                self.metrics.gauge(
                    "model_resident", labels={"model": mp.name}).set(
                    int(mp.resident))
            with self._lock:
                self._plan = plan
        m = self.metrics
        m.gauge("fleet_models").set(len(plan.models))
        m.gauge("fleet_resident_bytes").set(plan.total_resident_bytes)
        m.gauge("fleet_budget_bytes").set(plan.budget_bytes)
        m.gauge("fleet_evicted_models").set(len(plan.evicted))
        _instant("fleet.plan", **plan.summary())
        # the instant above also feeds the flight ring (trace.py tee);
        # the fingerprint additionally carries the CURRENT plan so a
        # bundle shows residency state even after the ring rolled over
        from ..obs.flight import global_flight
        global_flight.set_context(fleet_plan=plan.summary())
        return plan

    @property
    def plan(self) -> Optional[FleetPlan]:
        return self._plan

    def warm(self) -> int:
        """Build (or restore from the AOT store) every resident model's
        resident bucket programs and run each once, so first requests pay
        no build; returns buckets warmed."""
        n = 0
        with self._lock:
            entries = list(self._entries.values())
        for e in entries:
            if e.resident and e.resident_buckets:
                n += e.server.warm(e.resident_buckets)
            elif e.resident:
                n += e.server.warm()
        return n

    # ------------------------------------------------------------- AOT

    def export_aot(self, path: Optional[str] = None) -> int:
        """Store every device-resident model's resident bucket programs
        in the AOT store (``fleet/aot.py``) at ``path`` (else each
        server's configured store), so a fresh replica restores them;
        returns the entries written."""
        n = 0
        with self._lock:
            entries = list(self._entries.values())
        for e in entries:
            if e.model.device_forest is None:
                continue
            buckets = e.resident_buckets or tuple(e.server.ladder.buckets)
            n += e.server.export_aot(path=path, buckets=buckets)
        self.metrics.counter("fleet_aot_exports").inc(n)
        return n

    # ----------------------------------------------------------- lifecycle

    def close(self, drain: bool = True,
              timeout: Optional[float] = None) -> None:
        if self._closed:
            return
        self._closed = True
        with self._lock:
            entries = list(self._entries.values())
        for e in entries:
            e.server.close(drain=drain, timeout=timeout)
        _obs_registry.detach_child(self._obs_component)

    def __enter__(self) -> "Fleet":
        return self

    def __exit__(self, *exc) -> None:
        self.close(drain=True)

    # ------------------------------------------------------------- metrics

    def metrics_dict(self) -> dict:
        """Fleet-level instruments plus every member server's snapshot
        under ``servers.<name>`` (each server's own layout unchanged)."""
        out = self.metrics.to_dict()
        with self._lock:
            entries = dict(self._entries)
        out["servers"] = {n: e.server.metrics_dict()
                          for n, e in sorted(entries.items())}
        return out

    def prometheus_text(self, prefix: str = "lgbt_fleet") -> str:
        """Fleet instruments (``model=\"name\"``-labelled) + per-server
        exposition under ``<prefix>_server_<name>``."""
        parts = [self.metrics.to_prometheus(prefix=prefix)]
        with self._lock:
            entries = dict(self._entries)
        for n, e in sorted(entries.items()):
            parts.append(e.server.prometheus_text(
                prefix=f"{prefix}_server_{n}"))
        return "".join(parts)
