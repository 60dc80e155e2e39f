"""Co-resident train and serve on the port (``lightgbm_tpu_torch/
coresident/``, ``ops/planner.py``'s ``ResidencyLedger``) against the JAX
package's (``tests/test_coresident.py``), on the CPU.

Every non-slow case of ``tests/test_coresident.py`` is mirrored here,
with ``plan_histograms(ledger=)`` (the TPU tile walk the port skips)
replaced by ``plan_stream(ledger=)``: the planners elect against the
ledger's remainder, an infeasible co-residency is a loud verdict that
carries the lease table, a paused refresh resumes byte-identically,
brownouts throttle then pause then recover, and a lost device replans
both planes.  Against the JAX package on the same inputs: the ledger's
table and summary after the same lease sequence, and a refresh's trees
(to ``tests/test_torch_train.py``'s tolerance).  The port's own design:
a pause gives back only the preemptible part of the training lease,
the bytes the Dataset keeps on its device stay leased (ROADMAP C-26).
"""

import json
import os
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

import lightgbm_tpu as lgb
from lightgbm_tpu.coresident import Scheduler as JScheduler
from lightgbm_tpu.obs.watchdog import Watchdog as JWatchdog
from lightgbm_tpu.ops.planner import ResidencyLedger as JResidencyLedger

import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch.coresident import (CoresidencyInfeasible,
                                           CoresidentConfig, PauseControl,
                                           Scheduler)
from lightgbm_tpu_torch.coresident.scheduler import dataset_card_bytes
from lightgbm_tpu_torch.engine import TrainingPaused
from lightgbm_tpu_torch.fleet import PodFleet
from lightgbm_tpu_torch.model_text import load_model_from_string
from lightgbm_tpu_torch.obs.flight import global_flight
from lightgbm_tpu_torch.obs.metrics import MetricsRegistry, global_registry
from lightgbm_tpu_torch.obs.watchdog import Watchdog, global_watchdog
from lightgbm_tpu_torch.ops import planner
from lightgbm_tpu_torch.ops.planner import (HEADROOM, FleetModelShape,
                                            LedgerError, ResidencyLedger,
                                            active_ledger, plan_fleet,
                                            plan_stream, set_active_ledger)
from lightgbm_tpu_torch.resilience.faults import ChaosRegistry, FaultSpec
from lightgbm_tpu_torch.testing import one_thread  # noqa: F401

F = 8
PARAMS = {"objective": "binary", "verbosity": -1, "num_leaves": 15}


@pytest.fixture(autouse=True)
def _flight_tmp(tmp_path, monkeypatch):
    """Own flight directory and a fresh dump budget for each test (breach
    dumps are the point here)."""
    monkeypatch.setattr(global_flight, "_out_dir", str(tmp_path))
    monkeypatch.setattr(global_flight, "dumps", 0)
    monkeypatch.setattr(global_flight, "max_dumps", 1 << 20)
    yield


def _data(seed, n, f=F):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, f).astype(np.float32).astype(np.float64)
    y = (X[:, 0] + X[:, 1] * X[:, 2] > 0).astype(float)
    return X, y


def _ds(X, y):
    return lt.Dataset(X, label=y, free_raw_data=False, device="cpu")


def _dumps(sub=""):
    safe = "".join(c if c.isalnum() or c in "-_." else "_" for c in sub)
    try:
        return [d for d in os.listdir(global_flight.out_dir())
                if d.startswith("flight_") and safe in d]
    except OSError:
        return []


# ======================================================== ResidencyLedger


def test_ledger_lease_release_accounting():
    lg = ResidencyLedger(limit_bytes=1_000_000)
    assert lg.budget_bytes == int(1_000_000 * HEADROOM)
    assert lg.available_bytes() == lg.budget_bytes
    a = lg.lease("serve:m", 300_000, plane="serving")
    b = lg.lease("refresh:m", 200_000, plane="train", preemptible=True)
    assert lg.leased_bytes() == 500_000
    assert lg.leased_bytes(plane="serving") == 300_000
    assert lg.available_bytes() == lg.budget_bytes - 500_000
    s = lg.summary()
    assert s["num_leases"] == 2
    assert s["leased_by_plane"] == {"serving": 300_000, "train": 200_000}
    lg.release(b)
    lg.release(b)                       # idempotent
    assert lg.leased_bytes() == 300_000
    lg.release(a.lease_id)              # by id too
    assert lg.leased_bytes() == 0
    assert not lg.table()


def test_ledger_denial_is_loud_with_lease_table():
    lg = ResidencyLedger(limit_bytes=1_000_000)
    lg.lease("serve:hot", 700_000, plane="serving")
    with pytest.raises(LedgerError) as ei:
        lg.lease("refresh:big", 500_000, plane="train")
    msg = str(ei.value)
    assert "serve:hot" in msg and "refresh:big" in msg
    assert lg.try_lease("refresh:big", 500_000, plane="train") is None
    assert lg.leased_bytes() == 700_000


def test_ledger_preempt_evicts_only_preemptible():
    lg = ResidencyLedger(limit_bytes=1_000_000)
    lg.lease("serve:m", 300_000, plane="serving", preemptible=False)
    lg.lease("refresh:a", 100_000, plane="train", preemptible=True)
    lg.lease("refresh:b", 150_000, plane="train", preemptible=True)
    assert lg.preempt(plane="train") == 250_000
    assert lg.leased_bytes() == 300_000
    assert [e["owner"] for e in lg.table()] == ["serve:m"]


def test_ledger_gauges_published():
    lg = ResidencyLedger(limit_bytes=2_000_000)
    lease = lg.lease("serve:m", 500_000, plane="serving")
    g = global_registry.to_dict()["gauges"]
    assert g["ledger_budget_bytes"] == lg.budget_bytes
    assert g["ledger_available_bytes"] == lg.available_bytes()
    leased = [v for k, v in g.items()
              if k.startswith("ledger_leased_bytes") and "serving" in k]
    assert leased and leased[0] == 500_000
    lg.release(lease)


def test_active_ledger_registration():
    prev = set_active_ledger(None)
    try:
        lg = ResidencyLedger(limit_bytes=1 << 20)
        assert set_active_ledger(lg) is None
        assert active_ledger() is lg
    finally:
        set_active_ledger(prev)


def _lease_sequence(lg):
    a = lg.lease("fleet:resident", 300_000, plane="serving")
    b = lg.lease("refresh:m", 200_000, plane="train", preemptible=True)
    lg.lease("bulk:abc", 50_000, plane="serving")
    lg.try_lease("refresh:big", 10 ** 9)
    lg.release(a)
    lg.lease("refresh:n", 120_000, plane="train", preemptible=True)
    lg.release(b.lease_id)
    return lg


def test_ledger_table_and_summary_equal_the_jax_ledger():
    port = _lease_sequence(ResidencyLedger(limit_bytes=1_000_000))
    jax = _lease_sequence(JResidencyLedger(limit_bytes=1_000_000))
    assert port.table() == jax.table()
    assert port.summary() == jax.summary()
    assert port.train_limit_bytes() == jax.train_limit_bytes()
    port.preempt("train")
    jax.preempt("train")
    assert port.table() == jax.table()


def test_ledger_limit_is_the_cards_total_or_the_knob(monkeypatch):
    monkeypatch.delenv("LGBM_TPU_HBM_BYTES", raising=False)
    lg = ResidencyLedger(device="cpu")
    assert lg.limit_source == "none"
    assert lg.limit_bytes == planner.NO_DEVICE_LIMIT
    monkeypatch.setenv("LGBM_TPU_HBM_BYTES", "4000000")
    lg = ResidencyLedger(device="cpu")
    assert (lg.limit_bytes, lg.limit_source) == (4_000_000, "env")
    assert ResidencyLedger(limit_bytes=10, device="cpu").limit_source \
        == "caller"
    # train_env pins the knob to the envelope and restores it
    lease = lg.lease("refresh:m", 1_000_000)
    with lg.train_env(lease):
        assert os.environ["LGBM_TPU_HBM_BYTES"] == str(
            lg.train_limit_bytes(lease))
        assert planner.device_limit_bytes("cpu")[1] == "env"
    assert os.environ["LGBM_TPU_HBM_BYTES"] == "4000000"


# =============================================== planners lease the budget


def test_plan_stream_respects_ledger_remainder():
    limit = 64 << 20
    solo = plan_stream(200_000, 28, 64, num_leaves=255, device="cpu",
                       device_budget_bytes=limit)
    assert solo.feasible
    lg = ResidencyLedger(limit_bytes=limit)
    lg.lease("serve:m", int(lg.budget_bytes * 0.7), plane="serving")
    co = plan_stream(200_000, 28, 64, num_leaves=255, device="cpu",
                     ledger=lg)
    assert co.device_budget_bytes == lg.available_bytes()
    if co.feasible:
        assert co.predicted_device_peak_bytes <= lg.available_bytes()
        assert co.predicted_device_peak_bytes + lg.leased_bytes() \
            <= lg.budget_bytes
    # the remainder degrades residency to streaming, never serving
    assert co.stream and not solo.stream
    # a ledger with nothing leased plans like the caller's budget
    free = plan_stream(200_000, 28, 64, num_leaves=255, device="cpu",
                       ledger=ResidencyLedger(limit_bytes=limit))
    assert free.summary() == solo.summary()


def test_plan_stream_ledger_infeasible_is_verdict_not_oom():
    lg = ResidencyLedger(limit_bytes=4 << 20)
    lg.lease("serve:m", lg.budget_bytes - 1024, plane="serving")
    plan = plan_stream(5_000_000, 28, 64, num_leaves=255, device="cpu",
                       ledger=lg)
    assert not plan.feasible            # refused, and nothing raised


def test_plan_fleet_respects_ledger_remainder():
    limit = 32 << 20
    shapes = [FleetModelShape("hot", 400, 255, 256, F, buckets=(8, 64),
                              weight=4.0),
              FleetModelShape("cold", 400, 255, 256, F, buckets=(8, 64),
                              weight=0.1, age_s=500.0)]
    solo = plan_fleet(shapes, budget_bytes=limit)
    lg = ResidencyLedger(limit_bytes=limit)
    lg.lease("refresh:m", int(lg.budget_bytes * 0.9), plane="train")
    co = plan_fleet(shapes, ledger=lg)
    assert co.limit_source == "ledger"
    assert co.budget_bytes == lg.available_bytes()
    assert co.total_resident_bytes <= lg.available_bytes()
    assert co.total_resident_bytes <= solo.total_resident_bytes
    assert len([m for m in co.models if m.resident]) <= \
        len([m for m in solo.models if m.resident])


def test_plan_topology_with_per_device_ledgers():
    from lightgbm_tpu_torch.fleet.topology import plan_devices, plan_topology
    devices = plan_devices(2, budget_bytes_per_device=32 << 20)
    shapes = [FleetModelShape("m", 200, 63, 64, F, buckets=(8,))]
    lg = ResidencyLedger(limit_bytes=32 << 20)
    lg.lease("refresh:m", int(lg.budget_bytes * 0.95), plane="train")
    topo = plan_topology(shapes, devices, ledgers={0: lg})
    assert topo.device_plans[0].total_resident_bytes <= \
        lg.available_bytes()
    assert topo.device_plans[1].total_resident_bytes >= \
        topo.device_plans[0].total_resident_bytes


# ================================================= engine pause seam


class _PauseAt:
    """A duck-typed pause_control: chunk cap 1, a pause at iteration
    ``at`` (None: never)."""

    def __init__(self, at):
        self.at = at
        self.consults = 0

    def consult(self, i):
        self.consults += 1
        return "pause" if self.at is not None and i >= self.at else "run"

    def chunk_cap(self):
        return 1


def test_pause_resume_bit_parity(tmp_path):
    X, y = _data(0, 1200)
    ref = lt.train(dict(PARAMS), _ds(X, y), 10, verbose_eval=False)
    snap = str(tmp_path / "paused.txt")
    with pytest.raises(TrainingPaused) as ei:
        lt.train(dict(PARAMS), _ds(X, y), 10, verbose_eval=False,
                 snapshot_out=snap, pause_control=_PauseAt(4))
    assert ei.value.iteration == 4
    assert os.path.exists(ei.value.bundle_path)
    resumed = lt.train(dict(PARAMS), _ds(X, y), 10, verbose_eval=False,
                       snapshot_out=snap, resume_from=ei.value.bundle_path,
                       pause_control=_PauseAt(None))
    assert resumed.current_iteration() == 10
    assert resumed.model_to_string() == ref.model_to_string()


def test_pause_is_not_a_failure_dump(tmp_path):
    X, y = _data(1, 800)
    snap_dir = tmp_path / "snap"
    snap_dir.mkdir()
    before = set(_dumps())
    with pytest.raises(TrainingPaused):
        lt.train(dict(PARAMS), _ds(X, y), 8, verbose_eval=False,
                 snapshot_out=str(snap_dir / "p.txt"),
                 pause_control=_PauseAt(2))
    assert set(_dumps()) == before


def test_pause_control_throttle_halves_chunk_cap():
    pc = PauseControl(base_chunk_cap=16, throttle_delay_s=0.0)
    assert pc.chunk_cap() == 16
    assert pc.request_throttle()
    assert pc.state == PauseControl.THROTTLE
    assert pc.chunk_cap() == 8
    assert not pc.request_throttle()
    assert pc.request_pause()
    assert pc.consult(0) == "pause"
    assert not pc.request_throttle()            # a pause never downgrades
    assert pc.request_run()
    assert pc.consult(1) == "run"
    assert pc.consults == 2


# ====================================== watchdog: windowed p99 + listeners


def test_windowed_p99_clears_after_brownout():
    wd = Watchdog()
    h = MetricsRegistry().histogram("lat_ms")
    wd.watch_histogram_p99("w", h, ceiling_ms=10.0, windowed=True)
    assert wd.check_once() == []                # the arming sweep
    for _ in range(50):
        h.observe(200.0)
    assert any(s == "slo:w" for s, _ in wd.check_once())
    assert "slo:w" in wd.active_breaches()
    for _ in range(200):
        h.observe(1.0)
    assert wd.check_once() == []
    assert "slo:w" not in wd.active_breaches()


def test_breach_listeners_fire_on_every_occurrence():
    wd = Watchdog()
    h = MetricsRegistry().histogram("lat_ms")
    calls = []
    wd.add_breach_listener(lambda slo, ev, rising: calls.append(
        (slo, rising)))
    wd.watch_histogram_p99("w", h, ceiling_ms=10.0, windowed=True)
    wd.check_once()
    for _ in range(3):
        for _ in range(30):
            h.observe(100.0)
        wd.check_once()
    assert [c for c in calls if c[0] == "slo:w"] == [
        ("slo:w", True), ("slo:w", False), ("slo:w", False)]
    assert len(_dumps("slo:w")) == 1


# ============================================== scheduler brownout machine


def test_scheduler_brownout_throttle_pause_recover():
    wd = Watchdog()
    h = MetricsRegistry().histogram("lat_ms")
    cfg = CoresidentConfig(brownout_fraction=0.6, escalate_s=0.05,
                           recovery_s=0.05, poll_interval_s=0.01)
    sched = Scheduler(ledger=ResidencyLedger(limit_bytes=1 << 30),
                      config=cfg, watchdog=wd)
    try:
        wname = sched.guard_latency("m", h, slo_ms=100.0)
        assert wname == "coresident:m"
        assert wd._hists[wname][1] == pytest.approx(60.0)
        wd.check_once()
        for _ in range(30):
            h.observe(80.0)                      # > brownout, < SLO
        wd.check_once()
        assert sched.control.state == PauseControl.THROTTLE
        assert sched.stats()["throttles"] == 1
        time.sleep(0.06)
        for _ in range(30):
            h.observe(80.0)
        wd.check_once()
        assert sched.control.state == PauseControl.PAUSE
        assert sched.stats()["pauses"] == 1
        time.sleep(0.06)
        sched._tick()
        assert sched.control.state == PauseControl.RUN
    finally:
        sched.close()
    assert wname not in wd._hists


def test_scheduler_negotiated_chunk_cap_shrinks_with_pressure():
    wd = Watchdog()
    h = MetricsRegistry().histogram("lat_ms")
    cfg = CoresidentConfig(chunk_cap=32, brownout_p99_ms=100.0)
    sched = Scheduler(ledger=ResidencyLedger(limit_bytes=1 << 30),
                      config=cfg, watchdog=wd)
    try:
        sched.guard_latency("m", h)
        assert sched.negotiate_chunk_cap() == 32
        for _ in range(100):
            h.observe(90.0)
        cap = sched.negotiate_chunk_cap()
        assert 1 <= cap <= 4 and (cap & (cap - 1)) == 0
    finally:
        sched.close()


def test_scheduler_refresh_infeasible_is_loud(tmp_path):
    X, y = _data(2, 400)
    lg = ResidencyLedger(limit_bytes=1 << 20)
    lg.lease("serve:m", lg.budget_bytes - 512, plane="serving")
    sched = Scheduler(ledger=lg, watchdog=Watchdog(),
                      workdir=str(tmp_path))
    try:
        with pytest.raises(CoresidencyInfeasible) as ei:
            sched.refresh("m", _ds(X, y), PARAMS, 4)
        assert "serve:m" in str(ei.value)
    finally:
        sched.close()
    assert lg.leased_bytes(plane="train") == 0


def test_scheduler_refresh_trains_and_marks_fresh(tmp_path):
    X, y = _data(3, 1200)
    wd = Watchdog()
    sched = Scheduler(ledger=ResidencyLedger(limit_bytes=1 << 30),
                      watchdog=wd, workdir=str(tmp_path))
    try:
        wd.watch_freshness("m")
        booster, stats = sched.refresh("m", _ds(X, y), PARAMS, 6)
        assert booster.current_iteration() == 6
        assert stats["pauses"] == 0 and not stats["stream"]
        assert 0 < stats["held_bytes"] < stats["predicted_peak_bytes"]
        age = wd.model_age_s("m")
        assert age is not None and age < 60.0
        assert sched.ledger.leased_bytes() == 0
    finally:
        sched.close()


def _pausing_refresh(tmp_path, X, y, rounds, at, seen=None):
    """A refresh through a scheduler whose control is paused once at
    iteration ``at`` (None: never) and resumed 50 ms later; ``seen``
    collects the lease table while paused."""
    cfg = CoresidentConfig(recovery_s=0.05, poll_interval_s=0.01,
                           max_pause_s=30.0, chunk_cap=1)
    sched = Scheduler(ledger=ResidencyLedger(limit_bytes=1 << 30),
                      config=cfg, watchdog=Watchdog(),
                      workdir=str(tmp_path))
    fired = threading.Event()
    orig_consult = sched.control.consult

    def pausing_consult(i):
        if at is not None and i >= at and not fired.is_set():
            fired.set()
            sched.control.request_pause()
        return orig_consult(i)

    sched.control.consult = pausing_consult

    def unpause():
        if not fired.wait(timeout=30):
            return
        time.sleep(0.05)
        if seen is not None:
            seen.append(sched.ledger.table())
        sched.control.request_run()

    t = threading.Thread(target=unpause)
    t.start()
    try:
        return sched.refresh("m", _ds(X, y), PARAMS, rounds)
    finally:
        fired.set()
        t.join()
        sched.close()


def test_scheduler_refresh_rides_out_pause_byte_identical(tmp_path):
    X, y = _data(4, 1200)
    ref = lt.train(dict(PARAMS), _ds(X, y), 8, verbose_eval=False)
    booster, stats = _pausing_refresh(tmp_path, X, y, 8, at=3)
    assert stats["pauses"] >= 1
    assert booster.model_to_string() == ref.model_to_string()


def test_paused_refresh_text_equals_the_unpaused_refresh(tmp_path):
    X, y = _data(7, 1500)
    seen = []
    paused, ps = _pausing_refresh(tmp_path / "a", X, y, 9, at=5, seen=seen)
    plain, us = _pausing_refresh(tmp_path / "b", X, y, 9, at=None)
    assert ps["pauses"] == 1 and us["pauses"] == 0
    assert paused.model_to_string() == plain.model_to_string()
    # while paused only the Dataset's bytes stay leased (ROADMAP C-26)
    (table,) = seen
    assert [(e["owner"], e["preemptible"]) for e in table] == [
        ("refresh:m:data", False)]
    assert table[0]["bytes"] == ps["held_bytes"]


def test_refresh_holds_the_datasets_bytes(tmp_path):
    X, y = _data(8, 1000)
    ds = _ds(X, y).construct()
    held = dataset_card_bytes(ds)
    n, G = ds.binned_shape()
    assert held >= G * n                 # the binned matrix at least
    booster, stats = _pausing_refresh(tmp_path, X, y, 3, at=None)
    assert stats["held_bytes"] == held


def test_booster_elects_as_the_refresh_plans_under_both_leases(tmp_path):
    # a remainder that holds the resident peak but not the peak beside
    # the Dataset's bytes once more: the booster, which counts the
    # Dataset in its peak, must see both leases added back to elect as
    # the refresh's plan does
    X, y = _data(9, 1200)
    probe = Scheduler(ledger=ResidencyLedger(limit_bytes=1 << 30),
                      watchdog=Watchdog(), workdir=str(tmp_path / "a"))
    try:
        _, s0 = probe.refresh("m", _ds(X, y), PARAMS, 2, swap=False)
    finally:
        probe.close()
    peak, held = s0["predicted_peak_bytes"], s0["held_bytes"]
    assert 0 < held < peak
    lg = ResidencyLedger(limit_bytes=1 << 30)
    lg.lease("fleet:resident", lg.budget_bytes - (peak + held // 2),
             plane="serving")
    sched = Scheduler(ledger=lg, watchdog=Watchdog(),
                      workdir=str(tmp_path / "b"))
    try:
        booster, stats = sched.refresh("m", _ds(X, y), PARAMS, 2,
                                       swap=False)
    finally:
        sched.close()
    assert stats["predicted_peak_bytes"] == peak and not stats["stream"]
    assert not booster.boosting.stream_election.stream
    assert booster.model_to_string() == lt.train(
        dict(PARAMS), _ds(X, y), 2, verbose_eval=False).model_to_string()


def test_paused_refresh_no_freshness_breach_storm():
    wd = Watchdog()
    wd.watch_freshness("fr", max_age_s=0.05)
    wd.mark_fresh("fr")
    time.sleep(0.08)
    ages = []
    for _ in range(4):
        wd.check_once()
        ages.append(global_registry.gauge(
            "model_age_seconds", labels={"model": "fr"}).value)
        time.sleep(0.02)
    assert len(_dumps("freshness:fr")) == 1
    assert ages == sorted(ages)
    wd.mark_fresh("fr")
    wd.check_once()
    assert "freshness:fr" not in wd.active_breaches()
    assert global_registry.gauge(
        "model_age_seconds", labels={"model": "fr"}).value < ages[0]


# ======================================== a refresh against the JAX package

RPARAMS = dict(PARAMS, min_data_in_leaf=5, max_bin=63,
               tpu_tree_growth="rounds", tpu_hist_method="fused")
TREE_EXACT = ("split_feature", "threshold", "decision_type", "left_child",
              "right_child", "leaf_count")


def test_refresh_trees_equal_the_jax_schedulers(tmp_path):
    X, y = _data(9, 1500)
    X = X.astype(np.float32)
    js = JScheduler(ledger=JResidencyLedger(limit_bytes=1 << 30),
                    watchdog=JWatchdog(), workdir=str(tmp_path / "j"))
    try:
        jb, jstats = js.refresh(
            "m", lgb.Dataset(X, label=y, free_raw_data=False),
            dict(RPARAMS), 5)
    finally:
        js.close()
    ts = Scheduler(ledger=ResidencyLedger(limit_bytes=1 << 30),
                   watchdog=Watchdog(), workdir=str(tmp_path / "t"))
    try:
        tb, tstats = ts.refresh("m", _ds(X, y), dict(RPARAMS), 5)
    finally:
        ts.close()
    assert (jstats["pauses"], tstats["pauses"]) == (0, 0)
    jm = load_model_from_string(jb.model_to_string())
    tm = load_model_from_string(tb.model_to_string())
    assert len(jm["models"]) == len(tm["models"]) == 5
    for j, t in zip(jm["models"], tm["models"]):
        assert j.num_leaves == t.num_leaves
        for f in TREE_EXACT:
            assert np.array_equal(getattr(j, f), getattr(t, f)), f
        np.testing.assert_allclose(t.leaf_value, j.leaf_value, rtol=1e-4,
                                   atol=1e-6)


def test_constructed_dataset_rebins_under_a_boosters_max_bin():
    """A refresh constructs its Dataset before the booster merges the
    training parameters; a ``max_bin`` that differs rebins it, with the
    new bins' tables (ROADMAP C-27: the old tables were kept)."""
    X, y = _data(9, 1500)
    X = X.astype(np.float32)
    fresh = lt.train(dict(RPARAMS), _ds(X, y), 2, verbose_eval=False)
    ds = _ds(X, y).construct()
    assert ds.max_group_bin > 64
    again = lt.train(dict(RPARAMS), ds, 2, verbose_eval=False)
    assert ds.max_group_bin <= 64
    assert again.model_to_string() == fresh.model_to_string()


# ==================================================== a lost device


@pytest.mark.chaos
def test_device_loss_replans_both_planes(tmp_path, monkeypatch):
    for k in ("LGBM_TPU_NUM_SLICES", "LGBM_TPU_SLICE_DEVICES"):
        monkeypatch.setenv(k, "")
        monkeypatch.delenv(k)
    X, y = _data(5, 1500)
    deployed = lt.train(dict(PARAMS), _ds(X, y), 4, verbose_eval=False)
    fleet = PodFleet(devices=2, max_batch_rows=128, device="cpu")
    fleet.add_model("live", deployed)
    fleet.warm()
    cfg = CoresidentConfig(recovery_s=0.05, poll_interval_s=0.01,
                           chunk_cap=1, max_pause_s=30.0)
    sched = Scheduler(fleet=fleet, ledger=ResidencyLedger(
        limit_bytes=1 << 30), config=cfg, watchdog=Watchdog(),
        world={"num_slices": 2, "devices_per_slice": 1},
        workdir=str(tmp_path))
    result = {}

    def run_refresh():
        result["out"] = sched.refresh("live", _ds(X, y), PARAMS, 20,
                                      init_model=deployed, swap=True)

    t = threading.Thread(target=run_refresh)
    t.start()
    try:
        deadline = time.monotonic() + 30
        while sched.control.consults < 2 and time.monotonic() < deadline:
            time.sleep(0.005)
        assert sched.control.consults >= 2
        fleet.kill_device(0)
        t.join(timeout=120)
        assert not t.is_alive()
        booster, stats = result["out"]
        assert booster.current_iteration() == 24
        assert fleet.live_devices() == [1]
        probe = X[:64]
        served = fleet.predict("live", probe, timeout=120)
        assert np.array_equal(served, booster.predict(probe, raw_score=True,
                                                      device=False))
        assert sched.world == {"num_slices": 1, "devices_per_slice": 1}
        assert sched.stats()["device_losses"] == 1
        bundles = _dumps("coresident:device_lost")
        assert len(bundles) == 1
        with open(os.path.join(global_flight.out_dir(), bundles[0])) as f:
            blob = f.read()
        assert "serving" in blob and "training" in blob
    finally:
        sched.close()
        fleet.close()


# =============================================== contention verdict + healthz


def test_contention_verdict_from_brownout_counters():
    from lightgbm_tpu_torch.obs.diagnose import collect_signals, diagnose
    reg = MetricsRegistry()
    reg.counter("coresident_throttle_total").inc(3)
    reg.counter("coresident_pause_total").inc(1)
    reg.gauge("ledger_available_bytes").set(1000.0)
    prev = set_active_ledger(None)
    lg = ResidencyLedger(limit_bytes=1 << 20)
    lease = lg.lease("serve:m", 1000, plane="serving")
    set_active_ledger(lg)
    try:
        sig = collect_signals(registry=reg)
        assert sig["coresident_throttle_total"] == 3
        assert sig["coresident_pause_total"] == 1
        assert sig["ledger_lease_table"][0]["owner"] == "serve:m"
        verdicts = diagnose(sig)
        names = [v.name for v in verdicts]
        assert "contention" in names
        v = verdicts[names.index("contention")]
        assert v.evidence["coresident_throttle_total"] == 3
        assert v.evidence["ledger_lease_table"][0]["owner"] == "serve:m"
        assert 0.4 <= v.score <= 0.9
    finally:
        lg.release(lease)
        set_active_ledger(prev)


def test_no_contention_verdict_without_events():
    from lightgbm_tpu_torch.obs.diagnose import collect_signals, diagnose
    sig = collect_signals(registry=MetricsRegistry())
    assert "contention" not in [v.name for v in diagnose(sig)]


def test_healthz_degrades_on_active_breach():
    from lightgbm_tpu_torch.obs.http import MetricsHTTPServer
    reg = MetricsRegistry()
    h = reg.histogram("lat_ms")
    srv = MetricsHTTPServer(registry=reg, port=0)
    try:
        port = srv.start()
        base = f"http://127.0.0.1:{port}"
        assert urllib.request.urlopen(
            f"{base}/healthz", timeout=5).read() == b"ok\n"
        h.observe(500.0)
        global_watchdog.watch_histogram_p99("hz_probe", h, ceiling_ms=1.0)
        global_watchdog.check_once()
        assert "slo:hz_probe" in global_watchdog.active_breaches()
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(f"{base}/healthz", timeout=5)
        assert ei.value.code == 503
        body = json.loads(ei.value.read())
        assert body["status"] == "degraded"
        assert "slo:hz_probe" in body["breaches"]
        global_watchdog.unwatch_histogram("hz_probe")
        assert urllib.request.urlopen(
            f"{base}/healthz", timeout=5).read() == b"ok\n"
    finally:
        global_watchdog.unwatch_histogram("hz_probe")
        srv.stop()


@pytest.mark.chaos
def test_device_delay_inflates_latency_without_failures():
    X, y = _data(6, 800)
    deployed = lt.train(dict(PARAMS), _ds(X, y), 4, verbose_eval=False)
    chaos = ChaosRegistry([FaultSpec(site="device", kind="delay", at=i,
                                     arg=0.05) for i in range(2, 6)])
    fleet = PodFleet(devices=1, chaos=chaos, max_batch_rows=64,
                     device="cpu")
    fleet.add_model("live", deployed)
    fleet.warm()
    try:
        lats = []
        for _ in range(8):
            t0 = time.perf_counter()
            fleet.predict("live", X[:16], timeout=60)
            lats.append(time.perf_counter() - t0)
        assert max(lats) >= 0.05
        assert any("delay" in line for line in chaos.log)
    finally:
        fleet.close()
