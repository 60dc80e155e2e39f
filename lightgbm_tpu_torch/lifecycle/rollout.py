"""Guarded rollout: probe quarantine -> shadow traffic -> staged canary
ramp -> cutover, with automated rollback to the previous verified
bundle on any gate breach (counterpart of
``lightgbm_tpu/lifecycle/rollout.py``).

``LifecycleController`` owns one live model name inside a serving
``Fleet`` and drives a candidate bundle through the promotion pipeline
(docs/LIFECYCLE.md).  Every transition is journaled atomically BEFORE
its side effects (journal.py), the live serving pointer only moves at
the final cutover swap (which itself re-probes and flips atomically,
serving/server.py), and every breach — raw-score drift over budget,
candidate p99 over budget, candidate error rate, non-finite outputs, a
corrupt bundle, a failed cutover probe — rolls the fleet back to the
previous verified model and dumps a flight-recorder bundle NAMING the
gate (``lifecycle:<gate>``).  A crashed pipeline is resumed with
``resume()``: a journaled cutover whose flip committed is finished
idempotently; anything earlier rolls back.  It can never
double-promote.

The controller serves through the port's ``Fleet`` on its device: the
probe, the shadow mirror, the canary ramp and the cutover all route
rows through the traversal kernel (B1) on the card.  Nothing on the
serving side calls a device-wide ``torch.cuda.synchronize()`` (ROADMAP
ground rule 6), so a refresh's round-graph capture beside the serving
threads is safe.

Chaos seams: the candidate's serving path accepts a
``resilience.faults.ChaosRegistry`` (site ``serving``: delay / nan /
error), and the journal + bundles ride the ``chaos://`` filesystem
through the ``open_file`` seam — the chaos matrix in
tests/test_torch_lifecycle.py injects a fault at every gate and asserts
the fleet's served output stays byte-identical to the pre-promotion
model.
"""

from __future__ import annotations

import os
import threading
import time
from dataclasses import dataclass
from typing import Callable, Optional, Tuple

import numpy as np

from ..obs.metrics import global_registry as _obs_registry
from ..obs.trace import instant as _instant
from ..obs.trace import span as _span
from ..resilience.checkpoint import (CheckpointError, CheckpointManager,
                                     load_checkpoint)
from ..serving.errors import ModelNotFound
from ..utils import envflags
from ..utils.log import log_info, log_warning
from .journal import RolloutJournal
from .refresh import booster_digest, fresh_dataset, save_candidate, \
    train_candidate

_DRIFT_ENV = "LGBM_TPU_LIFECYCLE_DRIFT_BUDGET"
_P99_ENV = "LGBM_TPU_LIFECYCLE_P99_MS"
_MIRROR_ENV = "LGBM_TPU_LIFECYCLE_MIRROR"
_RAMP_ENV = "LGBM_TPU_LIFECYCLE_RAMP"
_DIR_ENV = "LGBM_TPU_LIFECYCLE_DIR"

CANARY_SUFFIX = "!canary"


class LifecycleError(RuntimeError):
    """Base class for lifecycle pipeline failures."""


class RollbackFailed(LifecycleError):
    """The rollback itself could not restore the previous model — the
    one failure the pipeline cannot degrade through; loud by design."""


@dataclass
class LifecycleConfig:
    """Promotion budgets and ramp schedule; every knob has an env twin
    (README.md, the port's environment table) so a deployment tunes
    gates without code."""

    drift_budget: float = 10.0          # max |cand - live| raw score
    p99_budget_ms: Optional[float] = None   # candidate p99 ceiling
    error_budget: float = 0.0           # allowed candidate error fraction
    mirror_fraction: float = 0.25       # shadow mirror probability
    ramp: Tuple[float, ...] = (0.05, 0.25, 0.5)
    min_mirrored: int = 4               # drift verdict needs a sample
    canary_weight: float = 0.1          # fleet admission weight floor
    keep_bundles: int = 4               # CheckpointManager retention
    freshness_max_age_s: Optional[float] = None  # watchdog freshness SLO

    def __post_init__(self):
        # a directly-passed config must obey the same bounds as the env
        # path: an empty ramp would skip every canary stage and cut
        # over with zero gated exposure
        if not self.ramp or not all(0.0 < float(f) <= 1.0
                                    for f in self.ramp):
            raise ValueError(
                f"ramp fractions must be in (0, 1]: {self.ramp}")
        if not 0.0 <= float(self.mirror_fraction) <= 1.0:
            raise ValueError(
                f"mirror_fraction must be in [0, 1]: "
                f"{self.mirror_fraction}")

    @classmethod
    def from_env(cls, **overrides) -> "LifecycleConfig":
        cfg = cls(**overrides)

        def env(name):
            return (envflags.read(name) or "").strip()
        v = env(_DRIFT_ENV)
        if v and "drift_budget" not in overrides:
            cfg.drift_budget = float(v)
        v = env(_P99_ENV)
        if v and "p99_budget_ms" not in overrides:
            cfg.p99_budget_ms = float(v)
        v = env(_MIRROR_ENV)
        if v and "mirror_fraction" not in overrides:
            cfg.mirror_fraction = float(v)
        v = env(_RAMP_ENV)
        if v and "ramp" not in overrides:
            cfg.ramp = tuple(float(t) for t in v.split(",") if t.strip())
        if not cfg.ramp or not all(0.0 < f <= 1.0 for f in cfg.ramp):
            raise ValueError(f"ramp fractions must be in (0, 1]: "
                             f"{cfg.ramp}")
        return cfg


class _ArmStats:
    """Client-measured accounting for one serving arm in one phase."""

    __slots__ = ("lat_ms", "requests", "errors", "nonfinite")

    def __init__(self):
        self.lat_ms: list = []
        self.requests = 0
        self.errors = 0
        self.nonfinite = 0

    def p99(self) -> Optional[float]:
        if not self.lat_ms:
            return None
        return float(np.percentile(np.asarray(self.lat_ms, np.float64),
                                   99))

    def summary(self) -> dict:
        return {"requests": self.requests, "errors": self.errors,
                "nonfinite": self.nonfinite,
                "p99_ms": (round(self.p99(), 3)
                           if self.lat_ms else None)}


class _TrafficStats:
    """One phase window of live/candidate traffic measurements; appended
    under the controller's stats lock (loadgen fires from threads)."""

    def __init__(self):
        self.live = _ArmStats()
        self.cand = _ArmStats()
        self.drift: list = []           # per-mirrored max |delta|
        self.mirrored = 0

    def drift_max(self) -> Optional[float]:
        return float(max(self.drift)) if self.drift else None

    def summary(self) -> dict:
        return {"live": self.live.summary(),
                "candidate": self.cand.summary(),
                "mirrored": self.mirrored,
                "drift_max": (round(self.drift_max(), 6)
                              if self.drift else None)}


def replay_traffic(X, requests: int = 32, rows: int = 16,
                   seed: int = 7) -> Callable:
    """A synchronous traffic driver replaying row windows of ``X``
    through ``controller.predict`` — the zero-dependency default for
    tests and the smoke; real deployments pass their own driver (e.g.
    serving/loadgen threads)."""
    X = np.asarray(X, np.float64)

    def drive(controller, phase: str, fraction: float) -> None:
        r = np.random.RandomState(seed)
        for _ in range(requests):
            i = int(r.randint(0, max(X.shape[0] - rows, 1)))
            controller.predict(X[i:i + rows])

    return drive


class LifecycleController:
    """One live model's guarded lifecycle: refresh -> promote ->
    rollback, over a serving Fleet (module docstring).  ``device``: the
    device of the candidates it trains and loads, the CUDA card unless
    ``device="cpu"``; it must be the fleet's (a host without CUDA
    raises, it never falls back)."""

    def __init__(self, fleet, live_name: str,
                 directory: Optional[str] = None,
                 config: Optional[LifecycleConfig] = None,
                 chaos=None, seed: int = 0, device=None, **overrides):
        from ..basic import resolve_device
        self.device = resolve_device(device)
        if self.device != fleet.device:
            raise ValueError(
                f"the controller's device {self.device} is not the "
                f"fleet's ({fleet.device}); pass device={str(fleet.device)!r}")
        if directory is None:
            directory = (envflags.read(_DIR_ENV) or "").strip()
            if not directory:
                raise ValueError("pass directory= or set "
                                 f"{_DIR_ENV} (bundle + journal home)")
        self.fleet = fleet
        self.live_name = live_name
        self.config = config if config is not None \
            else LifecycleConfig.from_env(**overrides)
        if config is not None and overrides:
            raise ValueError("pass either config or keyword overrides")
        self.directory = str(directory).rstrip("/")
        self.manager = CheckpointManager(
            self.directory, prefix="lifecycle",
            keep_last=self.config.keep_bundles)
        self.journal = RolloutJournal(
            f"{self.directory}/rollout.json")
        self.canary_name = live_name + CANARY_SUFFIX
        self._chaos = chaos
        self._cand_call: Optional[Callable] = None
        self._rng = np.random.RandomState(seed)
        self._phase = "idle"
        self._fraction = 0.0
        self._stats = _TrafficStats()
        self._lock = threading.Lock()   # stats + rng (loadgen threads)
        # the frozen-bin-grid Dataset and params of the LAST refresh:
        # a promoted candidate is reloaded from bundle model text (no
        # train_set), so successive refreshes keep binning fresh rows
        # on the original deployed grid
        self._base = None
        self._params: Optional[dict] = None
        self._rec: Optional[dict] = None    # latest journal record
        # the pre-promotion live booster: the in-process rollback anchor
        # when no verified bundle older than the candidate exists (a
        # FIRST promotion under a fresh manager directory)
        self._prev_booster = None
        # freshness is a first-class SLO (obs/watchdog.py): the live
        # model's age is measured from the last promotion; a stale model
        # past the ceiling breaches ``freshness:<name>`` and dumps
        from ..obs.watchdog import global_watchdog
        global_watchdog.watch_freshness(
            live_name, max_age_s=self.config.freshness_max_age_s)
        global_watchdog.mark_fresh(live_name)

    # ----------------------------------------------------------- refresh

    def refresh(self, X=None, y=None, chunks=None,
                num_rows: Optional[int] = None,
                params: Optional[dict] = None,
                num_boost_round: int = 10, base=None) -> Tuple[str, object]:
        """Continual-training step: warm-start ``num_boost_round``
        rounds from the DEPLOYED model over fresh rows (resident ``X, y``
        or streamed ``chunks``; refresh.py bins them on the deployed
        training set's frozen bin grid) and bank the candidate as an
        atomic sha256-manifested bundle.  Returns ``(bundle_path,
        candidate_booster)`` — ``promote`` takes it from there."""
        deployed = self.fleet.entry(self.live_name).model.booster
        if base is None:
            base = (deployed.train_set if deployed.train_set is not None
                    else self._base)
        if base is None:
            raise LifecycleError(
                "refresh needs the deployed model's training Dataset "
                "(frozen bin mappers): pass base= or serve a booster "
                "that retains train_set")
        if params is None:
            params = self._params if self._params is not None \
                else (dict(deployed.params) or None)
        if params is None:
            raise LifecycleError(
                "refresh: the deployed booster carries no params; pass "
                "params= explicitly")
        params = {k: v for k, v in dict(params).items()
                  if k not in ("num_iterations",)}
        self._base, self._params = base, dict(params)
        with _span("lifecycle.refresh", rounds=num_boost_round):
            ds = fresh_dataset(base, X, y, chunks=chunks,
                               num_rows=num_rows, predictor=deployed,
                               params={k: v for k, v in params.items()
                                       if k != "verbosity"})
            cand = train_candidate(deployed, ds, params, num_boost_round)
            bundle = save_candidate(cand, self.manager)
        _obs_registry.counter("lifecycle_refreshes_total").inc()
        return bundle, cand

    # ------------------------------------------------------------ routing

    def predict(self, X, deadline_ms: Optional[float] = None,
                timeout: Optional[float] = None) -> np.ndarray:
        """The traffic front door while a rollout is active: routes the
        request live-vs-candidate by the current ramp fraction, mirrors
        a ``mirror_fraction`` sample of live requests to the candidate
        for drift/latency comparison, and records client-measured
        per-arm stats the gates judge.  Candidate failures NEVER fail
        the caller — they are recorded and the request degrades to the
        live model."""
        with self._lock:
            phase = self._phase
            take_cand = (phase == "ramp"
                         and self._rng.rand() < self._fraction)
            mirror = (phase in ("shadow", "ramp") and not take_cand
                      and self._rng.rand() < self.config.mirror_fraction)
        out = None
        if take_cand:
            out = self._candidate_request(X, deadline_ms, timeout)
        if out is None:
            t0 = time.perf_counter()
            out = self.fleet.predict(self.live_name, X,
                                     deadline_ms=deadline_ms,
                                     timeout=timeout)
            lat = (time.perf_counter() - t0) * 1e3
            with self._lock:
                self._stats.live.requests += 1
                self._stats.live.lat_ms.append(lat)
        if mirror:
            self._mirror(X, out, deadline_ms, timeout)
        return out

    def _candidate_request(self, X, deadline_ms, timeout):
        """Serve one request from the canary; None on failure (the
        caller degrades to the live arm)."""
        t0 = time.perf_counter()
        try:
            out = self._call_candidate(X, deadline_ms, timeout)
        except Exception as e:  # noqa: BLE001 — recorded, degraded
            with self._lock:
                self._stats.cand.errors += 1
            log_warning(f"lifecycle: candidate request failed "
                        f"({type(e).__name__}: {str(e)[:120]}); "
                        "degrading to live")
            return None
        lat = (time.perf_counter() - t0) * 1e3
        finite = bool(np.isfinite(out).all())
        with self._lock:
            self._stats.cand.requests += 1
            self._stats.cand.lat_ms.append(lat)
            if not finite:
                self._stats.cand.nonfinite += 1
        if not finite:
            return None                 # never hand a NaN to a caller
        return out

    def _mirror(self, X, live_out, deadline_ms, timeout) -> None:
        """Shadow one live request onto the candidate and record the
        raw-score drift + candidate latency; mirror failures are
        candidate evidence, never caller failures."""
        t0 = time.perf_counter()
        try:
            cand = self._call_candidate(X, deadline_ms, timeout)
        except Exception as e:  # noqa: BLE001
            with self._lock:
                self._stats.cand.errors += 1
                self._stats.mirrored += 1
            log_warning(f"lifecycle: shadow mirror failed "
                        f"({type(e).__name__}: {str(e)[:120]})")
            return
        lat = (time.perf_counter() - t0) * 1e3
        cand = np.asarray(cand, np.float64)
        finite = bool(np.isfinite(cand).all())
        drift = (float(np.max(np.abs(cand - np.asarray(live_out,
                                                       np.float64))))
                 if finite else float("inf"))
        with self._lock:
            self._stats.mirrored += 1
            self._stats.cand.requests += 1
            self._stats.cand.lat_ms.append(lat)
            if not finite:
                self._stats.cand.nonfinite += 1
            else:
                self._stats.drift.append(drift)
        _obs_registry.counter("lifecycle_mirrored_total").inc()

    def _call_candidate(self, X, deadline_ms, timeout):
        call = self._cand_call
        if call is None:
            raise ModelNotFound("no candidate is registered")
        return call(X, deadline_ms, timeout)

    # -------------------------------------------------------------- gates

    def _check_gates(self, phase: str) -> Optional[Tuple[str, dict]]:
        """Judge the CURRENT phase window against the declared budgets;
        returns (gate, evidence) on the first breach, None when clean."""
        with self._lock:
            st = self._stats
            drift_max = st.drift_max()
            cand_p99 = st.cand.p99()
            cand_req = st.cand.requests
            cand_err = st.cand.errors
            nonfinite = st.cand.nonfinite
            mirrored = st.mirrored
        if drift_max is not None:
            _obs_registry.gauge("lifecycle_drift_max").set(
                round(drift_max, 6))
        if cand_p99 is not None:
            _obs_registry.gauge("lifecycle_candidate_p99_ms").set(
                round(cand_p99, 3))
        if nonfinite:
            return "nonfinite", {"phase": phase, "nonfinite": nonfinite,
                                 "candidate_requests": cand_req}
        total = cand_req + cand_err
        if total and cand_err / total > self.config.error_budget:
            return "error-rate", {
                "phase": phase, "errors": cand_err, "requests": cand_req,
                "error_rate": round(cand_err / total, 4),
                "budget": self.config.error_budget}
        if mirrored >= self.config.min_mirrored and drift_max is not None \
                and drift_max > self.config.drift_budget:
            return "drift", {"phase": phase, "drift_max": drift_max,
                             "budget": self.config.drift_budget,
                             "mirrored": mirrored}
        if self.config.p99_budget_ms is not None and cand_p99 is not None \
                and cand_p99 > self.config.p99_budget_ms:
            return "latency", {"phase": phase,
                               "candidate_p99_ms": round(cand_p99, 3),
                               "budget_ms": self.config.p99_budget_ms}
        return None

    def _enter_phase(self, phase: str, fraction: float) -> None:
        with self._lock:
            self._phase = phase
            self._fraction = fraction
            self._stats = _TrafficStats()
        _obs_registry.gauge("lifecycle_phase").set(phase)
        _obs_registry.gauge("lifecycle_canary_fraction").set(fraction)
        _instant("lifecycle.phase", phase=phase, fraction=fraction)

    # ------------------------------------------------------------ promote

    def promote(self, bundle_path: str, probe_X=None,
                traffic: Optional[Callable] = None) -> dict:
        """Drive ``bundle_path`` through the guarded rollout.  Returns a
        summary dict with ``status`` ``"promoted"`` or
        ``"rolled_back"`` (+ the breached ``gate``); unexpected
        exceptions roll back first, then re-raise.

        ``traffic`` is called as ``traffic(controller, phase, fraction)``
        for the shadow phase and each ramp step, and must drive requests
        through ``controller.predict`` so the gates have a measured
        sample; defaults to ``replay_traffic(probe_X)``."""
        if traffic is None:
            if probe_X is None:
                raise ValueError("promote needs traffic= or probe_X=")
            traffic = replay_traffic(probe_X)
        live = self.fleet.entry(self.live_name)
        prev_digest = live.model.digest
        self._prev_booster = live.model.booster
        cand_name = os.path.basename(str(bundle_path))
        prev_names = [n for n in self.manager.bundles() if n < cand_name]
        rec = self.journal.begin(
            self.live_name, str(bundle_path), "",
            prev_names[-1] if prev_names else None, prev_digest,
            self.config.ramp)
        # the LATEST journal record: _promote_inner rebinds its local
        # through every phase, and the outer handler must roll back with
        # the real phase/digest (a post-flip failure can only un-flip
        # when the candidate digest is present)
        self._rec = rec
        summary = {"bundle": str(bundle_path), "phases": {},
                   "previous_digest": prev_digest}
        with _span("lifecycle.promote", bundle=str(bundle_path)):
            try:
                return self._promote_inner(rec, bundle_path, probe_X,
                                           traffic, live, summary)
            except LifecycleError:
                raise
            except Exception as e:
                # an unexpected pipeline failure is itself a gate: the
                # fleet must come back to the previous verified model
                self._rollback(self._rec, "pipeline-error", {
                    "error": f"{type(e).__name__}: {str(e)[:400]}"},
                    summary)
                raise

    def _promote_inner(self, rec, bundle_path, probe_X, traffic, live,
                       summary) -> dict:
        from ..basic import Booster
        cfg = self.config

        # ---- verify: the manifest checksums are the corruption gate
        try:
            ck = load_checkpoint(str(bundle_path))
            candidate = Booster(model_str=ck.model_str,
                                params={"verbosity": -1},
                                device=self.device)
        except Exception as e:  # noqa: BLE001 — CheckpointError or ANY
            # decode failure: the bundle cannot be trusted
            return self._rollback(rec, "bundle-verify", {
                "bundle": str(bundle_path),
                "error": f"{type(e).__name__}: {str(e)[:400]}"}, summary)
        cand_digest = booster_digest(candidate)
        rec = self._journal_phase(
            dict(rec, candidate_digest=cand_digest), "verify")
        summary["candidate_digest"] = cand_digest
        summary["phases"]["verify"] = {"iteration": ck.iteration}

        # ---- quarantine: probe batch before the candidate ever serves
        rec = self._journal_phase(rec, "quarantine")
        probe = self._probe_rows(probe_X, candidate)
        try:
            raw = np.asarray(candidate.predict(probe, raw_score=True),
                             np.float64)
        except Exception as e:  # noqa: BLE001 — any probe failure gates
            return self._rollback(rec, "probe", {
                "error": f"{type(e).__name__}: {str(e)[:400]}"}, summary)
        if not np.isfinite(raw).all():
            return self._rollback(rec, "probe", {
                "nonfinite_outputs": int((~np.isfinite(raw)).sum()),
                "probe_rows": int(probe.shape[0])}, summary)
        summary["phases"]["quarantine"] = {
            "probe_rows": int(probe.shape[0]), "finite": True}

        # ---- register the canary entry (its own Server; the live
        # pointer is untouched until cutover)
        self._remove_canary()
        self.fleet.add_model(self.canary_name, candidate,
                             weight=cfg.canary_weight,
                             deadline_class=self.fleet.entry(
                                 self.live_name).deadline_class)
        # warm the canary's bucket programs: the latency gate must judge
        # steady-state serving, not first requests (the same reason
        # swap_model warms before flipping)
        self.fleet.entry(self.canary_name).server.warm()
        self._arm_candidate_call()

        # ---- shadow: mirrored traffic, zero user exposure
        rec = self._journal_phase(rec, "shadow")
        self._enter_phase("shadow", 0.0)
        traffic(self, "shadow", 0.0)
        summary["phases"]["shadow"] = self._stats.summary()
        breach = self._check_gates("shadow")
        if breach:
            return self._rollback(rec, *breach, summary)

        # ---- ramp: staged canary exposure through the fleet
        live_weight = live.weight
        steps = []
        for i, f in enumerate(cfg.ramp):
            rec = self._journal_phase(rec, "ramp", ramp_step=i)
            self.fleet.set_weight(
                self.canary_name,
                max(f * live_weight, cfg.canary_weight))
            self._enter_phase("ramp", f)
            traffic(self, "ramp", f)
            steps.append(dict(self._stats.summary(), fraction=f))
            summary["phases"]["ramp"] = steps
            breach = self._check_gates(f"ramp[{i}]")
            if breach:
                return self._rollback(rec, *breach, summary)

        # ---- cutover: journal the intent, then the atomic probed swap
        rec = self._journal_phase(rec, "cutover")
        self._enter_phase("idle", 0.0)
        try:
            live.server.swap_model(candidate, probe=True)
        except Exception as e:  # noqa: BLE001 — quarantined swap gates
            return self._rollback(rec, "cutover-probe", {
                "error": f"{type(e).__name__}: {str(e)[:400]}"}, summary)
        self._finish_promotion(rec)
        summary["status"] = "promoted"
        summary["live_digest"] = self.fleet.entry(
            self.live_name).model.digest
        return summary

    def _journal_phase(self, rec, phase, ramp_step: int = -1) -> dict:
        rec = self.journal.phase(rec, phase, ramp_step=ramp_step)
        self._rec = rec
        return rec

    def _probe_rows(self, probe_X, candidate) -> np.ndarray:
        if probe_X is not None:
            return np.asarray(probe_X, np.float64)
        rng = np.random.RandomState(0x11FE)
        return rng.randn(64, candidate.num_features()) \
            .astype(np.float32).astype(np.float64)

    def _arm_candidate_call(self) -> None:
        def call(X, deadline_ms, timeout):
            return self.fleet.predict(self.canary_name, X,
                                      deadline_ms=deadline_ms,
                                      timeout=timeout)

        if self._chaos is not None:
            self._cand_call = self._chaos.wrap_predict(call)
        else:
            self._cand_call = call

    def _remove_canary(self) -> None:
        self._cand_call = None
        try:
            self.fleet.remove_model(self.canary_name, drain=False)
        except ModelNotFound:
            pass

    def _finish_promotion(self, rec) -> None:
        """Post-flip bookkeeping — idempotent, so a crash-resume that
        finds the flip committed can finish it again safely."""
        self._remove_canary()
        self._enter_phase("idle", 0.0)
        self.journal.promoted(rec)
        self._prev_booster = None       # release the rollback anchor
        _obs_registry.counter("lifecycle_promotions_total").inc()
        from ..obs.watchdog import global_watchdog
        global_watchdog.mark_fresh(self.live_name)
        _instant("lifecycle.promoted",
                 model=self.live_name,
                 digest=rec.get("candidate_digest"))
        log_info(f"lifecycle: promoted {rec.get('candidate_bundle')} "
                 f"as {self.live_name!r}")

    # ----------------------------------------------------------- rollback

    def _rollback(self, rec: dict, gate: str, evidence: dict,
                  summary: Optional[dict] = None) -> dict:
        """Degrade to the previous verified model: unregister the
        canary, un-flip the live pointer if (and only if) the cutover
        committed, journal the verdict, and dump a forensic bundle
        naming the breached gate."""
        self._enter_phase("idle", 0.0)
        self._remove_canary()
        restored = False
        live = self.fleet.entry(self.live_name)
        cand_digest = rec.get("candidate_digest") or None
        if cand_digest and live.model.digest == cand_digest:
            # the flip landed before the breach/crash: pin the newest
            # verified bundle OLDER than the failed candidate (a
            # concurrent refresh may have saved a newer one); a first
            # promotion with no older bundle falls back to the
            # in-memory pre-promotion booster
            from ..basic import Booster
            try:
                try:
                    prev = self.manager.latest_verified(
                        before=rec.get("candidate_bundle"))
                    prev_booster = Booster(model_str=prev.model_str,
                                           params={"verbosity": -1},
                                           device=self.device)
                except CheckpointError:
                    if self._prev_booster is None:
                        raise
                    prev_booster = self._prev_booster
                live.server.swap_model(prev_booster, probe=True)
                restored = True
            except Exception as e:
                raise RollbackFailed(
                    f"lifecycle rollback [{gate}] could not restore the "
                    f"previous verified bundle: {e}") from e
        rec = self.journal.rolled_back(rec, gate, evidence)
        _obs_registry.counter("lifecycle_rollbacks_total",
                              labels={"gate": gate}).inc()
        _instant("lifecycle.rollback", gate=gate)
        from ..obs.flight import global_flight
        global_flight.dump(f"lifecycle:{gate}", extra={
            "gate": gate, "evidence": evidence,
            "candidate_bundle": rec.get("candidate_bundle"),
            "candidate_digest": cand_digest,
            "previous_digest": rec.get("previous_digest"),
            "live_pointer_restored": restored})
        log_warning(f"lifecycle: ROLLED BACK [{gate}] {evidence}")
        out = dict(summary or {}, status="rolled_back", gate=gate,
                   evidence=evidence,
                   live_digest=self.fleet.entry(
                       self.live_name).model.digest)
        return out

    # ------------------------------------------------------------- resume

    def resume(self) -> dict:
        """Recover from a crashed pipeline using the journal alone.
        A journaled cutover whose flip committed (the live digest IS the
        candidate digest) finishes its bookkeeping; every other
        in-progress state rolls back to the previous verified model.
        Never double-promotes: the candidate digest was durable before
        the flip, and this check is idempotent."""
        rec = self.journal.in_progress()
        if rec is None:
            return {"status": "idle"}
        live = self.fleet.entry(self.live_name)
        if rec.get("phase") == "cutover" \
                and rec.get("candidate_digest") \
                and live.model.digest == rec["candidate_digest"]:
            self._finish_promotion(rec)
            return {"status": "promoted", "resumed": True,
                    "live_digest": live.model.digest}
        out = self._rollback(rec, "crash-resume", {
            "phase": rec.get("phase"), "ramp_step": rec.get("ramp_step")})
        out["resumed"] = True
        return out
