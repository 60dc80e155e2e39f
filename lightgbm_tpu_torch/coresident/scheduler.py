"""Co-resident train and serve: training refreshes in the serving troughs
of the same card, behind the shared residency ledger (counterpart of
``lightgbm_tpu/coresident/scheduler.py``).

- **budget**: a refresh plans with ``ops.planner.plan_stream(ledger=)``
  against the ledger's remainder (serving's residency leased first):
  resident training where the remainder holds the resident peak, else
  row-block streaming, else ``CoresidencyInfeasible``, which carries the
  lease table, not an out-of-memory error.  The JAX package plans with
  its TPU tile walk (``plan_histograms``), which the port skips; the
  card's degradation is residency before streaming.  The Dataset is
  constructed with the training parameters under
  ``ResidencyLedger.train_env()``, and the booster trained under
  ``train_env`` of both of the refresh's leases, so the construct's
  streaming election, the plan's and the booster's see the same budget
  and the same peak.
- **leases**: the refresh leases the plan's
  ``predicted_device_peak_bytes`` in two parts: the bytes the Dataset
  keeps on the card (its binned matrix and row fields, non-preemptible:
  a pause does not free them) and the rest, preemptible, which a pause
  gives back to serving (ROADMAP C-26: the JAX scheduler releases its
  whole lease on a pause).
- **troughs**: the chunk cap comes from the serving p99's headroom
  under the brownout ceiling (``negotiate_chunk_cap``): a loaded fleet
  gets small chunks that fit between batcher deadlines, an idle one the
  whole cap.
- **brownout**: windowed p99 watches over the serving latency
  histograms at ``brownout_fraction`` of the serving SLO
  (``guard_latency``/``guard_fleet``) feed the watchdog's breach stream:
  a breach throttles training (halved chunks and a host-side yield a
  consult), a persistent one pauses it through the engine's
  ``pause_control`` (state in a checkpoint bundle; the resumed refresh
  is byte-identical), and ``recovery_s`` of quiet resumes it.
- **a lost device**: hooked on ``PodFleet.add_device_lost_listener``,
  one replan drains serving's replicas and shrinks the training world
  (``resilience.elastic.plan_shrunk_world`` and ``apply_world``), with a
  ``coresident:device_lost`` flight bundle naming both planes.

Telemetry (the JAX package's names): the ``coresident_throttle_total``,
``coresident_pause_total`` and ``coresident_device_lost_total``
counters, ``coresident.pause`` spans and the ``coresident.throttle``,
``coresident.pause_requested``, ``coresident.recover``,
``coresident.resume`` and ``coresident.refresh`` instants.  Knobs:
``LGBM_TPU_CORESIDENT_CHUNK_CAP``, ``LGBM_TPU_CORESIDENT_THROTTLE_S``
and ``LGBM_TPU_CORESIDENT_RECOVERY_S`` (``CoresidentConfig.from_env``).
"""

from __future__ import annotations

import os
import threading
import time
from dataclasses import dataclass
from typing import Optional

from ..obs.metrics import global_registry as _obs_registry
from ..obs.trace import instant as _instant
from ..obs.trace import span as _span
from ..obs.watchdog import global_watchdog, histogram_p99_ms
from ..ops.planner import (LedgerError, ResidencyLedger, active_ledger,
                           set_active_ledger)
from ..utils import envflags
from .control import PauseControl

_CHUNK_CAP_ENV = "LGBM_TPU_CORESIDENT_CHUNK_CAP"
_THROTTLE_ENV = "LGBM_TPU_CORESIDENT_THROTTLE_S"
_RECOVERY_ENV = "LGBM_TPU_CORESIDENT_RECOVERY_S"


class CoresidencyInfeasible(RuntimeError):
    """Training cannot fit beside the current serving residency: refused
    rather than run out of memory.  Carries the plan's summary and the
    ledger's lease table."""


def _env_float(name: str) -> Optional[float]:
    v = (envflags.read(name) or "").strip()
    if not v:
        return None
    try:
        return float(v)
    except ValueError:
        return None


@dataclass
class CoresidentConfig:
    """The brownout policy's knobs (``from_env`` reads the overrides)."""

    # brownout ceiling = fraction * the serving p99 SLO: throttling must
    # engage before the real SLO breaches
    brownout_fraction: float = 0.6
    # an explicit brownout ceiling (ms); wins over the fraction
    brownout_p99_ms: Optional[float] = None
    # host-side yield a consult while throttled
    # (LGBM_TPU_CORESIDENT_THROTTLE_S)
    throttle_delay_s: float = 0.02
    # breaches that persist this long escalate throttle -> pause
    escalate_s: float = 0.25
    # this long without a breach de-escalates to run
    # (LGBM_TPU_CORESIDENT_RECOVERY_S)
    recovery_s: float = 1.0
    # the chunk cap's ceiling (LGBM_TPU_CORESIDENT_CHUNK_CAP; None:
    # boosting.macro.chunk_cap())
    chunk_cap: Optional[int] = None
    # a paused refresh's poll cadence and how long it may stay paused
    poll_interval_s: float = 0.05
    max_pause_s: float = 120.0

    @classmethod
    def from_env(cls) -> "CoresidentConfig":
        cfg = cls()
        v = _env_float(_CHUNK_CAP_ENV)
        if v is not None and v >= 1:
            cfg.chunk_cap = int(v)
        v = _env_float(_THROTTLE_ENV)
        if v is not None:
            cfg.throttle_delay_s = max(v, 0.0)
        v = _env_float(_RECOVERY_ENV)
        if v is not None:
            cfg.recovery_s = max(v, 0.0)
        return cfg


def dataset_card_bytes(train_set) -> int:
    """The bytes a constructed Dataset's own tensors hold on its device
    (the binned matrix and the row fields): what stays allocated while a
    paused refresh waits."""
    import torch
    return int(sum(t.numel() * t.element_size()
                   for t in vars(train_set).values()
                   if isinstance(t, torch.Tensor)))


class Scheduler:
    """Guarded refreshes beside serving, on one card.

    ``fleet`` is a ``PodFleet`` (or None: the ledger and the guards
    alone); ``ledger`` defaults to a ``ResidencyLedger`` of the card
    (``ops.planner.ledger_limit_bytes``); ``world`` carries the training
    mesh as ``{"num_slices": s, "devices_per_slice": d}`` for the
    two-plane shrink; ``workdir`` holds the pause bundles."""

    def __init__(self, fleet=None, ledger: Optional[ResidencyLedger] = None,
                 config: Optional[CoresidentConfig] = None,
                 watchdog=None, world: Optional[dict] = None,
                 workdir: Optional[str] = None):
        self.fleet = fleet
        self.ledger = ledger if ledger is not None else ResidencyLedger()
        self.config = config or CoresidentConfig.from_env()
        self.world = dict(world) if world else None
        self.workdir = workdir or "coresident_work"
        self._wd = watchdog or global_watchdog
        self._lock = threading.Lock()
        self._guards: dict = {}       # guarded-by: _lock
        #                               watch name -> (hist, ceiling_ms)
        self._last_ping = 0.0         # guarded-by: _lock
        self._first_ping = 0.0        # guarded-by: _lock
        self._last_sweep = 0.0        # guarded-by: _lock
        self._throttles = 0           # guarded-by: _lock
        self._pauses = 0              # guarded-by: _lock
        self._device_losses = 0       # guarded-by: _lock
        self._closed = False          # guarded-by: _lock
        self.control = PauseControl(
            base_chunk_cap=self.config.chunk_cap or 32,
            throttle_delay_s=self.config.throttle_delay_s,
            on_step=self._on_step)
        self._prev_ledger = set_active_ledger(self.ledger)
        self._wd.add_breach_listener(self._on_breach)
        if fleet is not None and hasattr(fleet, "add_device_lost_listener"):
            fleet.add_device_lost_listener(self._on_device_lost)

    # ----------------------------------------------------------- guards

    def _brownout_ceiling_ms(self,
                             slo_ms: Optional[float]) -> Optional[float]:
        if self.config.brownout_p99_ms is not None:
            return float(self.config.brownout_p99_ms)
        slo = slo_ms if slo_ms is not None else self._wd.config.serving_p99_ms
        if slo is None:
            return None
        return float(slo) * float(self.config.brownout_fraction)

    def guard_latency(self, name: str, hist,
                      slo_ms: Optional[float] = None) -> Optional[str]:
        """Watch ``hist``'s windowed p99 at the brownout ceiling (a share
        of the serving SLO ``slo_ms``); its breaches throttle and pause
        training.  Returns the watch's name, or None where no ceiling can
        be derived (no SLO configured anywhere)."""
        ceiling = self._brownout_ceiling_ms(slo_ms)
        if ceiling is None:
            return None
        wname = f"coresident:{name}"
        self._wd.watch_histogram_p99(wname, hist, ceiling_ms=ceiling,
                                     windowed=True)
        with self._lock:
            self._guards[wname] = (hist, ceiling)
        return wname

    def guard_fleet(self, slo_ms: Optional[float] = None) -> list:
        """Guard the request-latency histogram of every live replica of
        the attached pod fleet; returns the watches' names."""
        if self.fleet is None:
            return []
        names = []
        for (model, device), hist in \
                self.fleet.latency_histograms().items():
            w = self.guard_latency(f"{model}:d{device}", hist, slo_ms)
            if w is not None:
                names.append(w)
        return names

    def lease_serving_residency(self):
        """Lease serving's planned resident bytes (the busiest device of
        the pod's topology), so that training plans against what is
        really left.  Returns the lease, or None without a planned
        fleet."""
        if self.fleet is None:
            return None
        topo = getattr(self.fleet, "topology", None)
        if topo is None:
            return None
        resident = max((p.total_resident_bytes
                        for p in topo.device_plans.values()), default=0)
        if resident <= 0:
            resident = max(topo.device_load_bytes.values(), default=0)
        if resident <= 0:
            return None
        return self.ledger.lease("fleet:resident", resident,
                                 plane="serving", preemptible=False)

    # ------------------------------------------------- brownout machine

    def _on_breach(self, slo: str, evidence: dict, rising: bool) -> None:
        # the signals that mean "serving hurts on our card": our own
        # windowed brownout guards, the server's serving-p99 SLO and the
        # fleet's availability
        if not (slo.startswith("slo:coresident:")
                or slo.startswith("slo:serving_p99:")
                or slo.startswith("availability:")):
            return
        now = time.monotonic()
        with self._lock:
            if self._closed:
                return
            self._last_ping = now
            if self.control.state == PauseControl.RUN:
                self._first_ping = now
            escalate = (self.control.state == PauseControl.THROTTLE
                        and now - self._first_ping
                        >= self.config.escalate_s)
        if self.control.request_throttle():
            with self._lock:
                self._throttles += 1
            _obs_registry.counter("coresident_throttle_total").inc()
            _instant("coresident.throttle", slo=slo, **{
                k: v for k, v in evidence.items()
                if isinstance(v, (int, float, str))})
        elif escalate and self.control.request_pause():
            with self._lock:
                self._pauses += 1
            _obs_registry.counter("coresident_pause_total").inc()
            _instant("coresident.pause_requested", slo=slo)

    def _on_step(self, iteration: int) -> None:
        """The engine's check-in at a chunk boundary (PauseControl's
        ``on_step``)."""
        self._tick()

    def _tick(self) -> None:
        """One turn of the brownout machine: sweep the watchdog (where no
        sentry thread owns the cadence) and de-escalate after quiet."""
        now = time.monotonic()
        with self._lock:
            if self._closed:
                return
            sweep = (now - self._last_sweep
                     >= max(self.config.poll_interval_s, 0.0))
            if sweep:
                self._last_sweep = now
        if sweep and not self._wd.running:
            try:
                self._wd.check_once()
            except Exception:  # noqa: BLE001 - the tick never kills
                pass           # training
        with self._lock:
            last = self._last_ping
        if self.control.state != PauseControl.RUN and last > 0 and \
                time.monotonic() - last >= self.config.recovery_s:
            if self.control.request_run():
                _instant("coresident.recover",
                         quiet_s=round(time.monotonic() - last, 3))

    def negotiate_chunk_cap(self) -> int:
        """The chunk cap from the watched p99s' headroom under their
        ceilings: the whole cap with ample headroom (or no data), down
        to 1 as a p99 nears its ceiling."""
        from ..boosting.macro import chunk_cap as _env_cap, pow2_chunk
        base = max(int(self.config.chunk_cap or _env_cap()), 1)
        with self._lock:
            guards = dict(self._guards)
        fracs = []
        for _wname, (hist, ceiling) in guards.items():
            p99 = histogram_p99_ms(hist)
            if p99 is None or ceiling <= 0:
                continue
            fracs.append(max(1.0 - p99 / ceiling, 0.0))
        if not fracs:
            return base
        want = max(int(base * min(fracs)), 1)
        return pow2_chunk(want, base)

    # ------------------------------------------------------ the refresh

    def refresh(self, name: str, train_set, params: dict,
                num_boost_round: int, init_model=None, swap: bool = True,
                **train_kw):
        """One guarded refresh beside live serving: plan against the
        ledger's remainder (``CoresidencyInfeasible`` where nothing
        fits), lease the plan's peak (module docstring), train with the
        brownout ``pause_control`` under ``ResidencyLedger.train_env``
        through any number of pauses, each resumed byte-identically,
        then hot-swap the fleet's model and mark it fresh.  Returns
        ``(booster, stats)``."""
        from ..config import Config
        from ..engine import TrainingPaused, train
        from ..ops.planner import plan_stream

        # the construct's streaming election sees the remainder and the
        # training parameters, as the plan below and the booster's (under
        # both of the refresh's leases) do
        cfg = Config.from_params(dict(params))
        if not train_set.constructed:
            train_set.params.update(
                num_leaves=cfg.num_leaves, num_class=cfg.num_class,
                use_quantized_grad=cfg.use_quantized_grad,
                tpu_round_width=cfg.tpu_round_width)
        with self.ledger.train_env():
            train_set.construct()
        rows, groups = train_set.binned_shape()
        plan = plan_stream(
            rows=rows, features=groups, num_bins=train_set.max_group_bin,
            num_leaves=cfg.num_leaves, num_class=max(cfg.num_class, 1),
            quant=bool(cfg.use_quantized_grad),
            round_width=cfg.tpu_round_width, device=train_set.device,
            ledger=self.ledger)
        peak = int(plan.predicted_device_peak_bytes)
        if not plan.feasible:
            raise CoresidencyInfeasible(
                f"refresh {name!r} cannot fit beside serving residency: "
                f"predicted peak {peak} bytes "
                f"({'streamed' if plan.stream else 'resident'}) > "
                f"remaining {self.ledger.available_bytes()} of the "
                f"{self.ledger.budget_bytes}-byte budget; plan="
                f"{plan.summary()}; leases={self.ledger.table()}")
        held = min(dataset_card_bytes(train_set), peak)
        try:
            data_lease = self.ledger.lease(f"refresh:{name}:data", held,
                                           plane="train")
        except LedgerError as e:
            raise CoresidencyInfeasible(str(e)) from e
        try:
            lease = self.ledger.lease(f"refresh:{name}", peak - held,
                                      plane="train", preemptible=True)
        except LedgerError as e:
            self.ledger.release(data_lease)
            raise CoresidencyInfeasible(str(e)) from e

        cap = self.negotiate_chunk_cap()
        self.control.set_base_cap(cap)
        self.control.request_run()
        os.makedirs(self.workdir, exist_ok=True)
        train_kw.setdefault("snapshot_out",
                            os.path.join(self.workdir, f"{name}.txt"))
        with self._lock:
            throttles0, pauses0 = self._throttles, self._pauses
        resume_from = train_kw.pop("resume_from", None)
        pauses = 0
        t0 = time.monotonic()
        try:
            while True:
                paused = None
                try:
                    with self.ledger.train_env(lease, data_lease):
                        booster = train(dict(params), train_set,
                                        num_boost_round,
                                        init_model=init_model,
                                        verbose_eval=False,
                                        resume_from=resume_from,
                                        pause_control=self.control,
                                        **train_kw)
                    break
                except TrainingPaused as e:
                    # leave the handler first: its traceback holds the
                    # paused booster, whose card memory the pause frees
                    paused = (e.iteration, e.bundle_path)
                pauses += 1
                iteration, resume_from = paused
                # the training state lives in the bundle now: its bytes
                # go back to serving for the brownout
                self.ledger.release(lease)
                with _span("coresident.pause", model=name,
                           iteration=iteration, pauses=pauses):
                    lease = self._await_resume(name, peak - held)
                _instant("coresident.resume", model=name,
                         iteration=iteration, pauses=pauses)
        finally:
            self.ledger.release(lease)
            self.ledger.release(data_lease)
        if swap and self.fleet is not None:
            self.fleet.swap_model(name, booster)
        # the refresh is the promotion: the model's age resets only now,
        # never during a pause
        self._wd.mark_fresh(name)
        with self._lock:
            throttled = self._throttles - throttles0
            paused_total = self._pauses - pauses0
        stats = {"model": name, "rows": int(rows),
                 "num_boost_round": int(num_boost_round),
                 "chunk_cap": cap, "pauses": pauses,
                 "throttles": throttled,
                 "pause_requests": paused_total,
                 "stream": bool(plan.stream),
                 "block_rows": int(plan.block_rows),
                 "predicted_peak_bytes": peak,
                 "held_bytes": int(held),
                 "wall_s": round(time.monotonic() - t0, 3)}
        _instant("coresident.refresh", **stats)
        return booster, stats

    def _await_resume(self, name: str, want_bytes: int):
        """Wait until the brownout clears and the training bytes can be
        leased again; a RuntimeError past ``max_pause_s`` (a refresh never
        waits forever in silence)."""
        deadline = time.monotonic() + max(self.config.max_pause_s, 0.0)
        while True:
            self._tick()
            if self.control.state != PauseControl.PAUSE:
                lease = self.ledger.try_lease(
                    f"refresh:{name}", want_bytes, plane="train",
                    preemptible=True)
                if lease is not None:
                    return lease
            if time.monotonic() > deadline:
                raise RuntimeError(
                    f"coresident refresh {name!r}: paused longer than "
                    f"max_pause_s={self.config.max_pause_s}s (state="
                    f"{self.control.state}, leases="
                    f"{self.ledger.table()}); refusing to wait forever")
            time.sleep(max(self.config.poll_interval_s, 0.005))

    # ------------------------------------------------- a lost device

    def _on_device_lost(self, device_id: int, reason: str,
                        recovered: bool) -> None:
        """The pod's drain hook: shrink the training world in the replan
        that drained serving's replicas, and bundle both planes'
        outcomes."""
        with self._lock:
            if self._closed:
                return
            self._device_losses += 1
        world_before = dict(self.world) if self.world else None
        world_after = world_before
        # a running refresh re-plans onto the shrunk world: pause it (its
        # state rides a bundle), re-plan, resume; the resumed train()
        # builds its mesh from the new environment
        was_training = self.control.state != PauseControl.PAUSE
        self.control.request_pause()
        if self.world and int(self.world.get("num_slices", 1)) > 1:
            from ..resilience.elastic import apply_world, plan_shrunk_world
            mp = plan_shrunk_world(
                int(self.world["num_slices"]),
                int(self.world.get("devices_per_slice", 1)),
                lost_slices=1)
            apply_world(mp)
            self.world = {"num_slices": mp.num_slices,
                          "devices_per_slice": mp.devices_per_slice}
            world_after = dict(self.world)
        serving = {"device": device_id, "reason": reason,
                   "replanned": True, "recovered_one_tick": bool(recovered)}
        if self.fleet is not None:
            try:
                serving["live_devices"] = self.fleet.live_devices()
                serving["models"] = self.fleet.models()
            except Exception:  # noqa: BLE001 - forensics never fail the
                pass           # replan
        training = {"world_before": world_before,
                    "world_after": world_after,
                    "was_training": was_training,
                    "state": self.control.state}
        from ..obs.flight import global_flight
        global_flight.dump("coresident:device_lost", extra={
            "serving": serving, "training": training,
            "ledger": self.ledger.table()})
        _obs_registry.counter("coresident_device_lost_total").inc()
        # both planes replanned: lift the brownout hold, so the paused
        # refresh leases again and resumes on the shrunk world
        with self._lock:
            self._last_ping = 0.0
        self.control.request_run()

    # ------------------------------------------------------------ teardown

    def stats(self) -> dict:
        with self._lock:
            return {"throttles": self._throttles, "pauses": self._pauses,
                    "device_losses": self._device_losses,
                    "state": self.control.state,
                    "ledger": self.ledger.summary()}

    def close(self) -> None:
        with self._lock:
            if self._closed:
                return
            self._closed = True
            guards = list(self._guards)
            self._guards.clear()
        self._wd.remove_breach_listener(self._on_breach)
        for wname in guards:
            self._wd.unwatch_histogram(wname)
        if self.fleet is not None and \
                hasattr(self.fleet, "remove_device_lost_listener"):
            self.fleet.remove_device_lost_listener(self._on_device_lost)
        if active_ledger() is self.ledger:
            set_active_ledger(self._prev_ledger)
