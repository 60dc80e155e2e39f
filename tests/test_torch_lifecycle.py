"""The guarded model lifecycle in the port (``lightgbm_tpu_torch/
lifecycle/``) on the CPU, mirroring tests/test_lifecycle.py test for
test.

The claims are the JAX package's:

* a clean promotion serves the candidate bit-identically and resets
  ``model_age_seconds``;
* EVERY gate breach (drift, latency, error rate, non-finite outputs, a
  corrupt bundle, a crash) leaves the fleet serving the previous model
  BYTE-identically and dumps a flight bundle naming the gate;
* a restarted pipeline resumes a committed cutover or rolls back, and
  never promotes twice;
* fresh rows are binned on the deployed model's frozen bin grid, so a
  streamed (chunked) refresh is byte-identical to a resident one.

Beside them, the port's promoted and rolled-back fleets against the JAX
package's controller on the same data and configs: served scores to
f32 tolerance, the candidate's leaf indices exactly.
"""

import json
import os

import numpy as np
import pytest

import lightgbm_tpu as lgb

import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch.engine import InitModelCompatibilityError
from lightgbm_tpu_torch.lifecycle import (CANARY_SUFFIX, LifecycleConfig,
                                          LifecycleController,
                                          booster_digest, fresh_dataset,
                                          replay_traffic)
from lightgbm_tpu_torch.lifecycle.journal import (RolloutJournal,
                                                  RolloutJournalError)
from lightgbm_tpu_torch.obs.flight import FlightRecorder, global_flight
from lightgbm_tpu_torch.obs.metrics import MetricsRegistry
from lightgbm_tpu_torch.obs.watchdog import (SLOConfig, Watchdog,
                                             global_watchdog)
from lightgbm_tpu_torch.resilience.checkpoint import (
    CheckpointManager, CheckpointNotFoundError)
from lightgbm_tpu_torch.resilience.faults import ChaosRegistry
from lightgbm_tpu_torch.testing import one_thread  # noqa: F401

F = 8
CPU = "cpu"


@pytest.fixture(autouse=True)
def _flight_tmp(tmp_path, monkeypatch):
    """Every test gets its own flight-bundle directory and a fresh dump
    budget (rollbacks dump on purpose)."""
    monkeypatch.setattr(global_flight, "_out_dir", str(tmp_path))
    monkeypatch.setattr(global_flight, "dumps", 0)
    monkeypatch.setattr(global_flight, "max_dumps", 1 << 20)
    yield


def _data(seed, n, f=F):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, f).astype(np.float32).astype(np.float64)
    y = (X[:, 0] + X[:, 1] * X[:, 2] > 0).astype(float)
    return X, y


PARAMS = {"objective": "binary", "verbosity": -1, "num_leaves": 15}


def _ds(X, y):
    return lt.Dataset(X, label=y, free_raw_data=False, device=CPU)


@pytest.fixture(scope="module")
def deployed():
    """One deployed model shared by every test: promotions swap FLEET
    entries, never this booster, and refreshed candidates copy its tree
    list (``engine._apply_init_model``)."""
    X, y = _data(0, 2000)
    ds = _ds(X, y)
    b = lt.train(PARAMS, ds, 6, verbose_eval=False)
    return b, ds, X


def _fleet(booster):
    # a short bucket ladder (8/16/32): the canary's warm() builds every
    # bucket per candidate
    fl = lt.Fleet(max_batch_rows=32, device=CPU)
    # the gates judge latency themselves; a loaded test host must not
    # expire a request in the queue
    fl.config.deadline_classes["standard"] = 60_000.0
    fl.add_model("live", booster)
    return fl


def _controller(fleet, tmp_path, chaos=None, **cfg):
    cfg.setdefault("drift_budget", 50.0)
    cfg.setdefault("mirror_fraction", 0.5)
    cfg.setdefault("ramp", (0.25, 0.5))
    return LifecycleController(
        fleet, "live", directory=str(tmp_path / "lc"),
        config=LifecycleConfig(**cfg), chaos=chaos, device=CPU)


def _dumps_named(tmp_path, token):
    return [d for d in os.listdir(tmp_path)
            if d.startswith("flight_lifecycle") and token in d]


def _served(fleet, X):
    return fleet.predict("live", X[:32], timeout=120)


def _host(booster, X):
    """The serving contract: the host float64 sums."""
    return booster.predict(X[:32], raw_score=True, device=False)


# --------------------------------------------------------------- full cycle


def test_full_cycle_promotion_bit_parity(deployed, tmp_path):
    b, ds, X = deployed
    fleet = _fleet(b)
    try:
        ctl = _controller(fleet, tmp_path)
        Xf, yf = _data(1, 1000)
        bundle, cand = ctl.refresh(Xf, yf, params=PARAMS,
                                   num_boost_round=3)
        assert cand.current_iteration() == 9       # 6 warm + 3 fresh
        res = ctl.promote(bundle, probe_X=X[:64],
                          traffic=replay_traffic(X, requests=24))
        assert res["status"] == "promoted"
        # the fleet now serves the candidate bit-identically
        assert np.array_equal(_served(fleet, X), _host(cand, X))
        assert fleet.entry("live").model.digest == booster_digest(cand)
        assert fleet.models() == ["live"]
        age = global_watchdog.model_age_s("live")
        assert age is not None and age < 60.0
        rec = ctl.journal.load()
        assert rec["status"] == "promoted"
        assert rec["candidate_digest"] == booster_digest(cand)
        assert res["phases"]["shadow"]["mirrored"] > 0
        assert len(res["phases"]["ramp"]) == 2
    finally:
        fleet.close()


def test_second_refresh_after_promotion(deployed, tmp_path):
    """A promoted candidate is reloaded from model text; later refreshes
    keep binning on the ORIGINAL frozen grid."""
    b, ds, X = deployed
    fleet = _fleet(b)
    try:
        ctl = _controller(fleet, tmp_path)
        Xf, yf = _data(1, 1000)
        bundle, _ = ctl.refresh(Xf, yf, params=PARAMS, num_boost_round=3)
        res = ctl.promote(bundle, probe_X=X[:64],
                          traffic=replay_traffic(X, requests=16))
        assert res["status"] == "promoted"
        Xg, yg = _data(2, 1000)
        bundle2, cand2 = ctl.refresh(Xg, yg, num_boost_round=3)
        assert cand2.current_iteration() == 12     # 6 + 3 + 3
        res2 = ctl.promote(bundle2, probe_X=X[:64],
                           traffic=replay_traffic(X, requests=16))
        assert res2["status"] == "promoted"
        assert fleet.entry("live").model.digest == booster_digest(cand2)
    finally:
        fleet.close()


def test_streamed_chunked_refresh_byte_identical(deployed):
    """Fresh rows pushed chunk by chunk (frozen-grid binning, push-time
    init scores) train the SAME candidate as a resident refresh."""
    b, ds, X = deployed
    Xf, yf = _data(3, 1400)
    res_ds = fresh_dataset(ds, Xf, yf)
    cand_res = lt.train(PARAMS, res_ds, 3, init_model=b,
                        verbose_eval=False)
    chunks = [(Xf[i:i + 500], yf[i:i + 500])      # a ragged last chunk
              for i in range(0, 1400, 500)]
    str_ds = fresh_dataset(ds, chunks=iter(chunks), num_rows=1400,
                           predictor=b)
    assert str_ds.raw_data is None
    cand_str = lt.train(PARAMS, str_ds, 3, init_model=b,
                        verbose_eval=False)
    assert cand_res.model_to_string() == cand_str.model_to_string()


# ------------------------------------------------------------ gate breaches


def test_drift_gate_rolls_back_bit_identical(deployed, tmp_path):
    b, ds, X = deployed
    fleet = _fleet(b)
    try:
        ctl = _controller(fleet, tmp_path, drift_budget=1e-12,
                          mirror_fraction=1.0)
        Xf, yf = _data(1, 1000)
        bundle, _ = ctl.refresh(Xf, yf, params=PARAMS, num_boost_round=3)
        pre = _served(fleet, X)
        res = ctl.promote(bundle, probe_X=X[:64],
                          traffic=replay_traffic(X, requests=16))
        assert res["status"] == "rolled_back" and res["gate"] == "drift"
        assert np.array_equal(pre, _served(fleet, X))
        assert fleet.models() == ["live"]
        assert ctl.journal.load()["status"] == "rolled_back"
        dumps = _dumps_named(tmp_path, "drift")
        assert dumps, os.listdir(tmp_path)
        with open(tmp_path / dumps[0]) as fh:
            bundle_json = json.load(fh)
        assert bundle_json["trigger"] == "lifecycle:drift"
        assert bundle_json["extra"]["gate"] == "drift"
        assert "traceEvents" in bundle_json["ring"]
    finally:
        fleet.close()


def test_chaos_corrupt_bundle_gate(deployed, tmp_path):
    """A candidate bundle torn by a chaos:// partial write fails its
    manifest check and rolls back before the candidate ever serves."""
    b, ds, X = deployed
    fleet = _fleet(b)
    chaos = ChaosRegistry("fs.partial@0", seed=0)
    chaos.install_filesystem()
    try:
        ctl = LifecycleController(
            fleet, "live", directory=f"chaos://{tmp_path}/lc",
            config=LifecycleConfig(drift_budget=50.0), device=CPU)
        Xf, yf = _data(1, 1000)
        # op 0 = the bundle write itself: silently half-persisted
        bundle, _ = ctl.refresh(Xf, yf, params=PARAMS, num_boost_round=3)
        pre = _served(fleet, X)
        res = ctl.promote(bundle, probe_X=X[:64],
                          traffic=replay_traffic(X, requests=8))
        assert res["status"] == "rolled_back"
        assert res["gate"] == "bundle-verify"
        assert np.array_equal(pre, _served(fleet, X))
        assert _dumps_named(tmp_path, "bundle-verify")
    finally:
        chaos.uninstall_filesystem()
        fleet.close()


def test_chaos_nan_candidate_gate(deployed, tmp_path):
    """NaN candidate outputs during shadow breach the nonfinite gate;
    callers never see the NaN."""
    b, ds, X = deployed
    fleet = _fleet(b)
    chaos = ChaosRegistry(
        ",".join(f"serving.nan@{i}" for i in range(16)), seed=0)
    try:
        ctl = _controller(fleet, tmp_path, chaos=chaos,
                          mirror_fraction=1.0)
        Xf, yf = _data(1, 1000)
        bundle, _ = ctl.refresh(Xf, yf, params=PARAMS, num_boost_round=3)
        pre = _served(fleet, X)
        res = ctl.promote(bundle, probe_X=X[:64],
                          traffic=replay_traffic(X, requests=12))
        assert res["status"] == "rolled_back"
        assert res["gate"] == "nonfinite"
        assert np.array_equal(pre, _served(fleet, X))
        assert _dumps_named(tmp_path, "nonfinite")
    finally:
        fleet.close()


def test_chaos_latency_spike_mid_ramp(deployed, tmp_path):
    """A latency spike that begins mid-ramp (the shadow window was
    clean) breaches the p99 gate at that ramp step and rolls back."""
    b, ds, X = deployed
    fleet = _fleet(b)
    chaos = ChaosRegistry(
        ",".join(f"serving.delay@{i}:sec=0.25" for i in range(14, 90)),
        seed=0)
    try:
        ctl = _controller(fleet, tmp_path, chaos=chaos,
                          mirror_fraction=0.5, p99_budget_ms=100.0,
                          ramp=(0.5,))
        Xf, yf = _data(1, 1000)
        bundle, _ = ctl.refresh(Xf, yf, params=PARAMS, num_boost_round=3)
        pre = _served(fleet, X)
        res = ctl.promote(bundle, probe_X=X[:64],
                          traffic=replay_traffic(X, requests=24))
        assert res["status"] == "rolled_back"
        assert res["gate"] == "latency"
        assert res["evidence"]["phase"].startswith("ramp")
        assert np.array_equal(pre, _served(fleet, X))
        assert _dumps_named(tmp_path, "latency")
    finally:
        fleet.close()


def test_chaos_error_gate_degrades_to_live(deployed, tmp_path):
    """Hard candidate failures breach the error-rate gate, and every
    canary-routed request degraded to the live model."""
    b, ds, X = deployed
    fleet = _fleet(b)
    chaos = ChaosRegistry(
        ",".join(f"serving.error@{i}" for i in range(64)), seed=0)
    try:
        ctl = _controller(fleet, tmp_path, chaos=chaos,
                          mirror_fraction=1.0)
        Xf, yf = _data(1, 1000)
        bundle, _ = ctl.refresh(Xf, yf, params=PARAMS, num_boost_round=3)
        pre = _served(fleet, X)
        res = ctl.promote(bundle, probe_X=X[:64],
                          traffic=replay_traffic(X, requests=12))
        assert res["status"] == "rolled_back"
        assert res["gate"] == "error-rate"
        assert np.array_equal(pre, _served(fleet, X))
    finally:
        fleet.close()


def test_probe_gate_never_registers_nan_candidate(deployed, tmp_path):
    """A candidate whose own predictions are non-finite is quarantined
    at the probe, before a canary entry ever exists."""
    b, ds, X = deployed
    fleet = _fleet(b)
    try:
        ctl = _controller(fleet, tmp_path)
        Xf, yf = _data(1, 1000)
        bundle, cand = ctl.refresh(Xf, yf, params=PARAMS,
                                   num_boost_round=3)
        # poison the banked bundle's leaf values: the reloaded candidate
        # predicts NaN on every row
        from lightgbm_tpu_torch.resilience.checkpoint import (
            build_bundle_bytes, load_checkpoint)
        from lightgbm_tpu_torch.utils.file_io import write_atomic
        ck = load_checkpoint(bundle)
        cand.boosting.models[-1].leaf_value[:] = np.nan
        write_atomic(bundle, build_bundle_bytes(
            cand, cand.current_iteration()))
        pre = _served(fleet, X)
        res = ctl.promote(bundle, probe_X=X[:64],
                          traffic=replay_traffic(X, requests=8))
        assert res["status"] == "rolled_back" and res["gate"] == "probe"
        assert np.array_equal(pre, _served(fleet, X))
        assert fleet.models() == ["live"]
        assert ck.iteration == 9
    finally:
        fleet.close()


# ------------------------------------------------------------- crash/resume


def _banked_candidate(deployed, tmp_path, ramp, phase, step=-1):
    """A candidate banked and a journal parked in ``phase``: the state
    a pipeline killed there leaves."""
    b, ds, X = deployed
    Xf, yf = _data(1, 1000)
    cand = lt.train(PARAMS, fresh_dataset(ds, Xf, yf), 4,
                    init_model=b, verbose_eval=False)
    mgr = CheckpointManager(str(tmp_path / "lc"), prefix="lifecycle")
    bundle = mgr.save(cand, iteration=cand.current_iteration())
    j = RolloutJournal(str(tmp_path / "lc" / "rollout.json"))
    rec = j.begin("live", bundle, booster_digest(cand), None,
                  booster_digest(b), ramp)
    j.phase(rec, phase, step)
    return cand


def test_crash_resume_mid_ramp_rolls_back(deployed, tmp_path):
    """A pipeline killed between ramp steps leaves an in_progress
    journal and a stale canary; resume() cleans both up and the fleet
    serves the old model bit-identically."""
    b, ds, X = deployed
    cand = _banked_candidate(deployed, tmp_path, (0.25, 0.5), "ramp", 0)
    fleet = _fleet(b)
    fleet.add_model("live" + CANARY_SUFFIX, cand, weight=0.1)
    try:
        pre = _host(b, X)
        ctl = _controller(fleet, tmp_path)
        out = ctl.resume()
        assert out["status"] == "rolled_back"
        assert out["gate"] == "crash-resume"
        assert fleet.models() == ["live"]
        assert np.array_equal(pre, _served(fleet, X))
        assert ctl.journal.load()["status"] == "rolled_back"
        assert ctl.resume()["status"] == "idle"     # idempotent
    finally:
        fleet.close()


def test_resume_finishes_committed_cutover(deployed, tmp_path):
    """A crash AFTER the swap landed but BEFORE the journal recorded
    ``promoted``: resume() finishes the promotion (the live digest is
    the commit witness) and never swaps again."""
    b, ds, X = deployed
    cand = _banked_candidate(deployed, tmp_path, (0.25,), "cutover")
    fleet = _fleet(cand)           # the flip already landed
    try:
        ctl = _controller(fleet, tmp_path)
        swaps_before = fleet.entry("live").server.metrics.to_dict()[
            "counters"].get("hot_swaps", 0)
        out = ctl.resume()
        assert out["status"] == "promoted" and out["resumed"]
        assert ctl.journal.load()["status"] == "promoted"
        swaps_after = fleet.entry("live").server.metrics.to_dict()[
            "counters"].get("hot_swaps", 0)
        assert swaps_after == swaps_before     # no double promotion
        assert np.array_equal(_served(fleet, X), _host(cand, X))
    finally:
        fleet.close()


def test_resume_uncommitted_cutover_restores_previous(deployed, tmp_path):
    """A crash after journaling the cutover intent but BEFORE the flip:
    the live digest is not the candidate's, so resume() rolls back."""
    b, ds, X = deployed
    _banked_candidate(deployed, tmp_path, (0.25,), "cutover")
    fleet = _fleet(b)              # the flip never landed
    try:
        pre = _served(fleet, X)
        ctl = _controller(fleet, tmp_path)
        out = ctl.resume()
        assert out["status"] == "rolled_back"
        assert np.array_equal(pre, _served(fleet, X))
    finally:
        fleet.close()


def test_pipeline_error_after_flip_unflips(deployed, tmp_path):
    """A failure AFTER the cutover swap committed (the journal's
    promoted write dies) still rolls the live pointer back, with the
    real candidate digest, and the in-memory pre-promotion booster as
    the anchor when no older verified bundle exists."""
    b, ds, X = deployed
    fleet = _fleet(b)
    try:
        ctl = _controller(fleet, tmp_path)
        Xf, yf = _data(1, 1000)
        bundle, _ = ctl.refresh(Xf, yf, params=PARAMS, num_boost_round=3)
        pre = _served(fleet, X)

        def boom(rec):
            raise RuntimeError("journal write died post-flip")

        ctl.journal.promoted = boom
        with pytest.raises(RuntimeError, match="post-flip"):
            ctl.promote(bundle, probe_X=X[:64],
                        traffic=replay_traffic(X, requests=12))
        rec = ctl.journal.load()
        assert rec["status"] == "rolled_back"
        assert rec["gate"] == "pipeline-error"
        assert rec["candidate_digest"]
        assert rec["phase"] == "cutover"
        assert np.array_equal(pre, _served(fleet, X))
        assert fleet.models() == ["live"]
    finally:
        fleet.close()


def test_config_rejects_degenerate_ramp(monkeypatch):
    with pytest.raises(ValueError, match="ramp fractions"):
        LifecycleConfig(ramp=())
    with pytest.raises(ValueError, match="ramp fractions"):
        LifecycleConfig(ramp=(1.5,))
    with pytest.raises(ValueError, match="mirror_fraction"):
        LifecycleConfig(mirror_fraction=1.5)
    # the environment twins, an explicit override winning
    monkeypatch.setenv("LGBM_TPU_LIFECYCLE_DRIFT_BUDGET", "3.5")
    monkeypatch.setenv("LGBM_TPU_LIFECYCLE_P99_MS", "40")
    monkeypatch.setenv("LGBM_TPU_LIFECYCLE_MIRROR", "0.75")
    monkeypatch.setenv("LGBM_TPU_LIFECYCLE_RAMP", "0.1,0.6")
    cfg = LifecycleConfig.from_env(mirror_fraction=0.3)
    assert (cfg.drift_budget, cfg.p99_budget_ms, cfg.mirror_fraction,
            cfg.ramp) == (3.5, 40.0, 0.3, (0.1, 0.6))
    monkeypatch.setenv("LGBM_TPU_LIFECYCLE_RAMP", "0,0.5")
    with pytest.raises(ValueError, match="ramp fractions"):
        LifecycleConfig.from_env()


def test_journal_refuses_concurrent_rollout(tmp_path):
    j = RolloutJournal(str(tmp_path / "rollout.json"))
    rec = j.begin("live", "b1", "d1", None, "d0", (0.5,))
    with pytest.raises(RolloutJournalError, match="in_progress"):
        j.begin("live", "b2", "d2", None, "d0", (0.5,))
    j.rolled_back(rec, "drift", {})
    j.begin("live", "b2", "d2", None, "d0", (0.5,))   # now fine
    # the record format is the JAX package's: journals read both ways
    from lightgbm_tpu.lifecycle.journal import RolloutJournal as JJournal
    assert JJournal(j.path).load()["candidate_bundle"] == "b2"


# ------------------------------------------------- rollback pin (before=)


def test_latest_verified_before_pins_older_bundle(deployed, tmp_path):
    b, ds, X = deployed
    mgr = CheckpointManager(str(tmp_path / "ck"), prefix="lifecycle",
                            keep_last=5)
    p1 = mgr.save(b, iteration=8)
    Xf, yf = _data(1, 1000)
    cand = lt.train(PARAMS, fresh_dataset(ds, Xf, yf), 2,
                    init_model=b, verbose_eval=False)
    p2 = mgr.save(cand, iteration=10)
    cand2 = lt.train(PARAMS, fresh_dataset(ds, Xf, yf), 4,
                     init_model=b, verbose_eval=False)
    p3 = mgr.save(cand2, iteration=12)
    assert mgr.latest_verified().iteration == 12
    assert mgr.latest_verified(before=p2).iteration == 8
    assert mgr.latest_verified(before=os.path.basename(p2)).iteration == 8
    assert mgr.latest_verified(before=12).iteration == 10
    with pytest.raises(CheckpointNotFoundError):
        mgr.latest_verified(before=p1)
    assert p3.endswith(".lgbckpt")


# --------------------------------------------------------------- freshness


def test_freshness_slo_breach_dumps(tmp_path):
    reg = MetricsRegistry()
    fl = FlightRecorder(enabled=True, out_dir=str(tmp_path / "fd"),
                        max_dumps=4)
    os.makedirs(tmp_path / "fd", exist_ok=True)
    wd = Watchdog(SLOConfig(model_age_max_s=0.005), registry=reg,
                  flight=fl)
    wd.watch_freshness("m")
    import time
    time.sleep(0.02)
    breaches = wd.check_once()
    assert [s for s, _ in breaches] == ["freshness:m"]
    d = reg.to_dict()
    assert d["gauges"]['model_age_seconds{model="m"}'] > 0
    assert d["counters"]['slo_breach_total{slo="freshness:m"}'] == 1
    dumps = os.listdir(tmp_path / "fd")
    assert len(dumps) == 1 and "freshness" in dumps[0]
    wd.check_once()                  # edge-triggered: no dump storm
    assert len(os.listdir(tmp_path / "fd")) == 1
    wd.mark_fresh("m")
    assert wd.check_once() == []
    assert wd.model_age_s("m") < 1.0
    wd.unwatch_freshness("m")
    assert wd.check_once() == []


def test_freshness_age_resets_on_promotion(deployed, tmp_path):
    b, ds, X = deployed
    fleet = _fleet(b)
    try:
        ctl = _controller(fleet, tmp_path)
        with global_watchdog._lock:
            ts, cap = global_watchdog._fresh["live"]
            global_watchdog._fresh["live"] = (ts - 10_000.0, cap)
        assert global_watchdog.model_age_s("live") > 9_000
        Xf, yf = _data(1, 1000)
        bundle, _ = ctl.refresh(Xf, yf, params=PARAMS, num_boost_round=3)
        res = ctl.promote(bundle, probe_X=X[:64],
                          traffic=replay_traffic(X, requests=12))
        assert res["status"] == "promoted"
        assert global_watchdog.model_age_s("live") < 60.0
    finally:
        fleet.close()


# ----------------------------------------------------- init-model satellite


def test_init_model_feature_mismatch_named_error(deployed):
    b, ds, X = deployed
    Xw, yw = _data(1, 400, f=F + 2)
    with pytest.raises(InitModelCompatibilityError, match="features"):
        lt.train(PARAMS, _ds(Xw, yw), 2, init_model=b, verbose_eval=False)


def test_init_model_class_mismatch_named_error(deployed):
    b, ds, X = deployed
    rng = np.random.RandomState(2)
    ym = rng.randint(0, 3, 400).astype(float)
    with pytest.raises(InitModelCompatibilityError, match="per iteration"):
        lt.train({"objective": "multiclass", "num_class": 3,
                  "verbosity": -1}, _ds(_data(1, 400)[0], ym), 2,
                 init_model=b, verbose_eval=False)


def test_init_model_cross_load_from_model_text(deployed, tmp_path):
    """Warm-starting from saved model TEXT matches warm-starting from the
    in-process Booster byte for byte."""
    b, ds, X = deployed
    path = str(tmp_path / "deployed.txt")
    b.save_model(path)
    Xf, yf = _data(1, 1000)
    from_obj = lt.train(PARAMS, _ds(Xf, yf), 3, init_model=b,
                        verbose_eval=False)
    from_txt = lt.train(PARAMS, _ds(Xf, yf), 3, init_model=path,
                        verbose_eval=False)
    assert from_obj.current_iteration() == 9
    assert from_txt.model_to_string() == from_obj.model_to_string()


# ------------------------------------------------------- loadgen satellite


def test_loadgen_shadow_mode_summary(deployed):
    from lightgbm_tpu_torch.serving.loadgen import fire_requests
    b, ds, X = deployed
    Xf, yf = _data(1, 1000)
    cand = lt.train(PARAMS, fresh_dataset(ds, Xf, yf), 4,
                    init_model=b, verbose_eval=False)
    live = b.serve(max_batch_rows=128)
    shadow = cand.serve(max_batch_rows=128)
    try:
        storm = fire_requests(live, 40, 4, 32, F, timeout=120,
                              shadow_server=shadow, mirror_fraction=0.5)
        assert storm["requests"] == storm["requests_planned"] == 40
        assert storm["shed"] == 0 and storm["expired"] == 0
        assert not storm["errors"]
        assert storm["latency_ms"]["count"] == 40
        sh = storm["shadow"]
        assert 0 < sh["mirrored"] < 40
        assert sh["drift_max"] is not None and sh["drift_max"] > 0
        assert sh["nonfinite"] == 0 and not sh["errors"]
        assert sh["latency_ms"]["count"] == sh["mirrored"]
        assert sh["latency_delta_ms"]["count"] == sh["mirrored"]
    finally:
        live.close()
        shadow.close()


def test_loadgen_without_shadow_unchanged(deployed):
    from lightgbm_tpu_torch.serving.loadgen import fire_requests
    b, ds, X = deployed
    n_iter = len(b.models) // b.num_tree_per_iteration
    live = b.serve(max_batch_rows=128)
    try:
        storm = fire_requests(live, 20, 4, 32, F, timeout=120,
                              verify_forest=b._forest(0, n_iter))
        assert storm["requests"] == storm["requests_planned"]
        assert storm["mismatches"] == []
        assert "shadow" not in storm
    finally:
        live.close()


# ------------------------------------------------------------- smoke driver


def test_lifecycle_smoke_tool(tmp_path):
    """The CLI twin at a small size: a clean promotion, a drift rollback
    with its flight bundle, shadow accounting; one JSON last line."""
    from lightgbm_tpu_torch.tools.torch_lifecycle_smoke import run_smoke
    summary = run_smoke(rows=1500, trees=4, refresh_trees=2, requests=16,
                        threads=2, directory=str(tmp_path / "smoke"),
                        device=CPU)
    assert not summary["failed"], summary["phase_ok"]


def test_coresident_smoke_tool(tmp_path):
    """The co-residency CLI twin at a small size: traffic and a refresh
    on one device set, the brownout throttle, the swap bit-equal."""
    from lightgbm_tpu_torch.tools.torch_coresident_smoke import run_smoke
    summary = run_smoke(rows=1500, trees=4, refresh_trees=3, requests=48,
                        threads=2, directory=str(tmp_path / "smoke"),
                        device=CPU)
    assert not summary["failed"], summary["phase_ok"]


# ------------------------------------------------- against the JAX package


JAX_PARAMS = dict(PARAMS, tpu_tree_growth="rounds", tpu_hist_method="fused")


def _cycle(lib, tmp, kw):
    """Deploy, refresh and promote (clean), then refresh and promote
    under an impossible drift budget (rolled back), on ``lib``; returns
    the served scores after each, the candidates' leaf indices and the
    two results."""
    X, y = _data(0, 2000)
    ds = lib.Dataset(X, label=y, free_raw_data=False, **kw)
    b = lib.train(JAX_PARAMS, ds, 6, verbose_eval=False)
    fleet = lib.Fleet(max_batch_rows=8, **kw)
    # first requests compile on the JAX side: no deadline to miss
    fleet.config.deadline_classes["standard"] = 60_000.0
    fleet.add_model("live", b)
    try:
        ctl = lib.LifecycleController(
            fleet, "live", directory=f"{tmp}/ok", **kw,
            config=lib.lifecycle.LifecycleConfig(
                drift_budget=50.0, mirror_fraction=0.5, ramp=(0.5,)))
        Xf, yf = _data(1, 1000)
        bundle, cand = ctl.refresh(Xf, yf, params=JAX_PARAMS,
                                   num_boost_round=3)
        ok = ctl.promote(bundle, probe_X=X[:64],
                         traffic=lib.lifecycle.replay_traffic(
                             X, requests=8))
        promoted = fleet.predict("live", X[:32], timeout=120)
        leaves = cand.predict(X[:32], pred_leaf=True)
        bad = lib.LifecycleController(
            fleet, "live", directory=f"{tmp}/bad", **kw,
            config=lib.lifecycle.LifecycleConfig(
                drift_budget=1e-12, mirror_fraction=1.0, ramp=(0.5,)))
        Xg, yg = _data(2, 1000)
        bundle2, _ = bad.refresh(Xg, yg, params=JAX_PARAMS,
                                 num_boost_round=3, base=ds)
        rb = bad.promote(bundle2, probe_X=X[:64],
                         traffic=lib.lifecycle.replay_traffic(
                             X, requests=8))
        rolled = fleet.predict("live", X[:32], timeout=120)
    finally:
        fleet.close()
    return promoted, rolled, leaves, ok, rb


def test_promoted_and_rolled_back_outputs_match_the_jax_package(tmp_path):
    jp, jr, jl, jok, jrb = _cycle(lgb, str(tmp_path / "jax"), {})
    tp, tr, tl, tok, trb = _cycle(lt, str(tmp_path / "port"),
                                  {"device": CPU})
    assert jok["status"] == tok["status"] == "promoted"
    assert (jrb["status"], jrb["gate"]) == (trb["status"], trb["gate"]) \
        == ("rolled_back", "drift")
    np.testing.assert_allclose(tp, jp, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tr, jr, rtol=1e-5, atol=1e-6)
    # the rollback serves the promoted model on both, byte for byte here
    assert np.array_equal(tr, tp) and np.array_equal(jr, jp)
    assert np.array_equal(np.asarray(tl), np.asarray(jl))
