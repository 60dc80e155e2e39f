"""The model axis in the port (``lightgbm_tpu_torch/multi/``) on the CPU,
mirroring tests/test_multi.py case for case.

The contract is the JAX package's: every booster ``train_many`` returns
is BYTE-IDENTICAL in model text to the same config trained alone by the
port, in every mode (gbdt, bagging, GOSS, multiclass, quantized, a
learning-rate schedule), on thread ranks (data-parallel), through
per-lane round budgets, early stopping and checkpoint bundles; and
``cv(fused=True)`` returns the serial ``cv`` dict bit for bit.  On the
CPU the group's rounds run eagerly, each lane's body in turn
(``grower_rounds.RoundGroup``): the bits are the card's, the graph is
not (``chip_smoke.py``'s ``multi_train`` holds the card's graph).
Beside the mirrored tests: each lane runs exactly its solo rounds; a
lane sitting through extra dead rounds keeps its text; the port's
``train_many`` against the JAX package's (tree structure, leaf values
to the solo comparison's tolerance); no CUDA, no fallback.
"""

import numpy as np
import pytest
import torch

import lightgbm_tpu as lgb

import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch import grower_rounds
from lightgbm_tpu_torch.multi import (batch, expand_param_grid,
                                      group_boosters)
from lightgbm_tpu_torch.testing import one_thread  # noqa: F401
from lightgbm_tpu_torch.testing import thread_ranks

from test_torch_objectives import assert_same_trees

RNG = np.random.RandomState(7)
N, F = 700, 10
X = RNG.randn(N, F)
Y_BIN = (X[:, 0] + 0.5 * X[:, 1] * X[:, 2] + 0.2 * RNG.randn(N)
         > 0).astype(float)
Y_MC = np.digitize(X[:, 0] + X[:, 1], [-0.5, 0.5]).astype(float)

XV = RNG.randn(300, F)
YV_BIN = (XV[:, 0] + 0.5 * XV[:, 1] * XV[:, 2] + 0.2 * RNG.randn(300)
          > 0).astype(float)

BASE = {"verbosity": -1, "num_leaves": 7, "learning_rate": 0.1}


def _lr_sched():
    return lt.reset_parameter(learning_rate=lambda i: 0.2 * 0.95 ** i)


# tests/test_multi.py's matrix: mode -> (two lane configs that differ
# only in runtime fields, labels, a per-lane callback factory)
PARITY_CASES = {
    "gbdt": ([dict(BASE, objective="binary"),
              dict(BASE, objective="binary", learning_rate=0.23)],
             Y_BIN, None),
    "bagging": ([dict(BASE, objective="binary", bagging_fraction=0.7,
                      bagging_freq=2, bagging_seed=11),
                 dict(BASE, objective="binary", bagging_fraction=0.5,
                      bagging_freq=1, bagging_seed=3)],
                Y_BIN, None),
    "goss": ([dict(BASE, objective="binary", boosting="goss"),
              dict(BASE, objective="binary", boosting="goss",
                   learning_rate=0.3)],
             Y_BIN, None),
    "multiclass": ([dict(BASE, objective="multiclass", num_class=3),
                    dict(BASE, objective="multiclass", num_class=3,
                         learning_rate=0.2)],
                   Y_MC, None),
    "quant": ([dict(BASE, objective="binary", use_quantized_grad=True),
               dict(BASE, objective="binary", use_quantized_grad=True,
                    learning_rate=0.17)],
              Y_BIN, None),
    "lr_schedule": ([dict(BASE, objective="binary"),
                     dict(BASE, objective="binary")],
                    Y_BIN, _lr_sched),
}


def _ds(y=Y_BIN, x=X):
    return lt.Dataset(x, label=y, free_raw_data=False, device="cpu")


def _solo_bst(params, y, rounds=8, cb=None):
    return lt.train(dict(params), _ds(y), num_boost_round=rounds,
                    verbose_eval=False, callbacks=[cb()] if cb else None)


def _solo(params, y, rounds=8, cb=None):
    return _solo_bst(params, y, rounds, cb).model_to_string()


def _many(params_list, y, cb=None, rounds=8):
    return lt.train_many(
        [dict(p) for p in params_list], _ds(y), num_boost_round=rounds,
        callbacks=[[cb()] for _ in params_list] if cb else None)


@pytest.mark.parametrize("case", sorted(PARITY_CASES))
def test_train_many_matches_solo(case):
    params_list, y, cb = PARITY_CASES[case]
    solos = [_solo_bst(p, y, cb=cb) for p in params_list]
    many = _many(params_list, y, cb)
    for i, bst in enumerate(many):
        assert bst.model_to_string() == solos[i].model_to_string(), \
            f"{case} lane {i}: batched != solo"
        # each lane ran exactly its solo rounds: the same launches
        assert [r for r, _ in bst.boosting.grower.round_counts] == \
            [r for r, _ in solos[i].boosting.grower.round_counts]


def test_train_many_data_parallel_matches_solo():
    """The gbdt case with ``tree_learner="data"`` on 2 thread ranks:
    each rank's lanes run their bodies (and their collectives) in lane
    order; every lane's text is the data-parallel solo text."""
    params_list, y, _ = PARITY_CASES["gbdt"]
    params_list = [dict(p, tree_learner="data") for p in params_list]

    def run(rank, group):
        solos = [_solo(p, y) for p in params_list]
        many = [b.model_to_string() for b in _many(params_list, y)]
        return solos, many

    for solos, many in thread_ranks(2, run, timeout=120):
        assert many == solos


def test_heterogeneous_configs_one_call():
    """Configs of different structure in one call form several groups;
    each lane still lands byte-identical."""
    p0 = dict(BASE, objective="binary")
    p1 = dict(BASE, objective="binary", boosting="goss", num_leaves=15)
    p2 = dict(BASE, objective="binary", bagging_fraction=0.6,
              bagging_freq=1)
    solos = [_solo(p, Y_BIN) for p in (p0, p1, p2)]
    many = lt.train_many([dict(p0), dict(p1), dict(p2)], _ds(),
                         num_boost_round=8)
    assert [b.model_to_string() for b in many] == solos


def test_per_lane_round_budgets():
    """A lane whose num_iterations ends mid-group leaves the group (no
    RNG draw, no state change) while its neighbour trains on."""
    p_short = dict(BASE, objective="binary", num_iterations=5)
    p_long = dict(BASE, objective="binary", learning_rate=0.2)
    solo_short = _solo(p_short, Y_BIN, rounds=11)
    solo_long = _solo(p_long, Y_BIN, rounds=11)
    many = lt.train_many([dict(p_short), dict(p_long)], _ds(),
                         num_boost_round=11)
    assert many[0].current_iteration() == 5
    assert many[0].model_to_string() == solo_short
    assert many[1].current_iteration() == 11
    assert many[1].model_to_string() == solo_long


def test_early_stopping_mid_batch():
    """One lane stops early (best_iteration, its eval history and all)
    while the other lane's bytes are untouched."""
    vs = lt.Dataset(XV, label=YV_BIN, free_raw_data=False, device="cpu")
    p_es = dict(BASE, objective="binary", metric="binary_logloss",
                learning_rate=0.3)
    p_go = dict(BASE, objective="binary", metric="binary_logloss",
                learning_rate=0.02)
    er_solo = {}
    solo = lt.train(dict(p_es), _ds(), num_boost_round=30,
                    valid_sets=[vs], early_stopping_rounds=2,
                    evals_result=er_solo, verbose_eval=False)
    solo_go = lt.train(dict(p_go), _ds(), num_boost_round=30,
                       valid_sets=[vs], early_stopping_rounds=2,
                       verbose_eval=False)
    er_many = [{}, {}]
    many = lt.train_many([dict(p_es), dict(p_go)], _ds(),
                         num_boost_round=30, valid_sets=[vs],
                         early_stopping_rounds=2, evals_results=er_many)
    assert many[0].model_to_string() == solo.model_to_string()
    assert many[0].best_iteration == solo.best_iteration
    assert many[0].current_iteration() < 30 == many[1].current_iteration()
    assert er_many[0] == er_solo
    assert many[1].model_to_string() == solo_go.model_to_string()


def test_cv_fused_matches_serial():
    params = dict(BASE, objective="binary", metric="binary_logloss")
    kw = dict(num_boost_round=8, nfold=3, stratified=False, shuffle=False,
              verbose_eval=False)
    r_serial = lt.cv(dict(params), _ds(), **kw)
    r_fused = lt.cv(dict(params), _ds(), fused=True, **kw)
    assert sorted(r_serial) == sorted(r_fused)
    for k in r_serial:
        assert r_serial[k] == r_fused[k], f"cv key {k} diverged"


def test_cv_fused_custom_fobj_falls_back(capsys):
    """A custom fobj is not chunk-supported: fused cv steps the folds
    serially (with a warning) and returns the same results."""

    def fobj(preds, ds):
        lab = ds.get_label()
        p = 1.0 / (1.0 + np.exp(-preds))
        return p - lab, p * (1.0 - p)

    params = dict(BASE, objective="binary", metric="binary_logloss")
    kw = dict(num_boost_round=6, nfold=3, stratified=False, shuffle=False,
              verbose_eval=False, fobj=fobj)
    r_serial = lt.cv(dict(params), _ds(), **kw)
    r_fused = lt.cv(dict(params), _ds(), fused=True, **kw)
    assert r_serial == r_fused


def test_checkpoint_from_batched_run_resumes(tmp_path):
    """A bundle snapshotted mid-group carries the whole solo training
    state: ``train(resume_from=...)`` finishes the run to the
    byte-identical model."""
    p0 = dict(BASE, objective="binary", bagging_fraction=0.7,
              bagging_freq=1)
    p1 = dict(BASE, objective="binary", learning_rate=0.25)
    full = [_solo(p0, Y_BIN, rounds=14), _solo(p1, Y_BIN, rounds=14)]
    snaps = [str(tmp_path / "lane0.txt"), str(tmp_path / "lane1.txt")]
    many = lt.train_many([dict(p0), dict(p1)], _ds(), num_boost_round=14,
                         snapshot_freq=5, snapshot_outs=snaps)
    assert [b.model_to_string() for b in many] == full
    for p, snap, want in zip((p0, p1), snaps, full):
        resumed = lt.train(dict(p), _ds(), num_boost_round=14,
                           verbose_eval=False,
                           resume_from=snap + ".ckpt").model_to_string()
        assert resumed == want


def test_expand_param_grid():
    grid = {"objective": "binary", "learning_rate": [0.1, 0.2],
            "num_leaves": [7, 15], "verbosity": -1}
    cfgs = expand_param_grid(grid)
    assert len(cfgs) == 4
    assert sorted((c["learning_rate"], c["num_leaves"]) for c in cfgs) == \
        [(0.1, 7), (0.1, 15), (0.2, 7), (0.2, 15)]
    assert all(c["objective"] == "binary" for c in cfgs)
    assert cfgs == lgb.multi.expand_param_grid(grid)


def test_train_many_grid_dict_matches_solo():
    grid = {"objective": "binary", "verbosity": -1, "num_leaves": 7,
            "learning_rate": [0.1, 0.3]}
    many = lt.train_many(grid, _ds(), num_boost_round=6)
    for lr, bst in zip((0.1, 0.3), many):
        assert bst.model_to_string() == _solo(
            {"objective": "binary", "verbosity": -1, "num_leaves": 7,
             "learning_rate": lr}, Y_BIN, rounds=6)


def _shared_boosters(lib, ds, params):
    return [lib.Booster(params=dict(p, verbosity=-1),
                        train_set=ds).boosting for p in params]


def test_structural_grouping():
    """Runtime fields share a group, structural ones do not, and
    unbatchable modes are solo groups; the JAX package's grouping of
    the same configs is the same partition."""
    params = [dict(BASE, objective="binary"),
              dict(BASE, objective="binary", learning_rate=0.3,
                   bagging_fraction=0.5, bagging_freq=1),
              dict(BASE, objective="binary", num_leaves=15),
              dict(BASE, objective="binary", boosting="dart"),
              dict(BASE, objective="binary", cegb_penalty_split=1e-3)]
    bs = _shared_boosters(lt, _ds(), params)
    groups = group_boosters(bs, stacked=False)
    sizes = sorted(len(g.boosters) for g in groups)
    assert sizes == [1, 1, 1, 2]
    batched = [g for g in groups if len(g.boosters) == 2][0]
    assert batched.key is not None
    assert {id(b) for b in batched.boosters} == {id(bs[0]), id(bs[1])}
    for solo in (bs[3], bs[4]):      # DART; CEGB's serial grower
        g = [g for g in groups if g.boosters[0] is solo][0]
        assert g.key is None
    # the JAX package: the same partition of the same configs (its CEGB
    # config has no chunk support either)
    from lightgbm_tpu.multi import group_boosters as jgroup
    jds = lgb.Dataset(X, label=Y_BIN, free_raw_data=False)
    jbs = _shared_boosters(lgb, jds, params)
    part = sorted(sorted(bs.index(b) for b in g.boosters) for g in groups)
    jpart = sorted(sorted(jbs.index(b) for b in g.boosters)
                   for g in jgroup(jbs, stacked=False))
    assert part == jpart


def test_plan_model_batch_budget_degrades():
    from lightgbm_tpu_torch.ops.planner import (plan_model_batch,
                                                predict_peak_bytes,
                                                round_graph_bytes)
    roomy = plan_model_batch(b_total=8, rows=200_000, features=28,
                             num_bins=64, num_leaves=31,
                             budget_bytes=1 << 34)
    assert roomy.b_chunk == 8 and roomy.num_dispatch_groups == 1
    assert not roomy.degraded and roomy.feasible
    # the model: the shared matrix once, a lane its solo peak without the
    # matrix plus one captured round body
    peak, bd = predict_peak_bytes(200_000, 28, 64, 31)
    assert roomy.shared_bytes == bd["binned"]
    assert roomy.per_lane_bytes == peak - bd["binned"] + round_graph_bytes(
        200_000, 28, 64, 31)
    tight = plan_model_batch(b_total=8, rows=200_000, features=28,
                             num_bins=64, num_leaves=31,
                             budget_bytes=3 * roomy.per_lane_bytes
                             + roomy.shared_bytes)
    assert 1 <= tight.b_chunk < 8
    assert tight.degraded
    assert tight.num_dispatch_groups == -(-8 // tight.b_chunk)
    assert tight.predicted_peak_bytes <= tight.budget_bytes
    # stacked: every lane its own matrix
    st = plan_model_batch(b_total=5, rows=200_000, features=28,
                          num_bins=64, num_leaves=31, stacked=True,
                          budget_bytes=1 << 34)
    assert st.shared_bytes == 0
    assert st.per_lane_bytes == roomy.per_lane_bytes + bd["binned"]
    # a ledger budgets from what it has left, HEADROOM applied once
    from lightgbm_tpu_torch.ops.planner import ResidencyLedger
    lg = ResidencyLedger(limit_bytes=1 << 34)
    lg.lease("fleet:m", lg.budget_bytes - 2 * roomy.per_lane_bytes
             - roomy.shared_bytes, plane="serving")
    led = plan_model_batch(b_total=8, rows=200_000, features=28,
                           num_bins=64, num_leaves=31, ledger=lg)
    assert led.limit_source == "ledger" and led.b_chunk == 2
    assert led.budget_bytes == lg.available_bytes()


def test_plan_model_batch_env_override(monkeypatch):
    from lightgbm_tpu_torch.ops.planner import plan_model_batch
    monkeypatch.setenv("LGBM_TPU_MODEL_BATCH", "2")
    plan = plan_model_batch(b_total=8, rows=10_000, features=10,
                            num_bins=64, budget_bytes=1 << 34)
    assert plan.b_chunk == 2 and plan.forced
    monkeypatch.setenv("LGBM_TPU_MODEL_BATCH", "off")
    plan = plan_model_batch(b_total=8, rows=10_000, features=10,
                            num_bins=64, budget_bytes=1 << 34)
    assert plan.b_chunk == 1


def test_model_batch_env_caps_grouping(monkeypatch):
    """LGBM_TPU_MODEL_BATCH=0 trains every lane solo, to the same bytes;
    a cap of 2 splits three lanes into groups of 2 and 1."""
    made = []
    orig = batch.BatchedChunkProgram.__init__

    def spy(self, group):
        made.append(len(group))
        orig(self, group)
    monkeypatch.setattr(batch.BatchedChunkProgram, "__init__", spy)
    p = [dict(BASE, objective="binary", learning_rate=lr)
         for lr in (0.1, 0.3, 0.2)]
    monkeypatch.setenv("LGBM_TPU_MODEL_BATCH", "0")
    many = lt.train_many([dict(q) for q in p[:2]], _ds(), num_boost_round=6)
    assert made == []
    monkeypatch.setenv("LGBM_TPU_MODEL_BATCH", "2")
    capped = lt.train_many([dict(q) for q in p], _ds(), num_boost_round=6)
    assert made == [2]
    monkeypatch.delenv("LGBM_TPU_MODEL_BATCH")
    solos = [_solo(q, Y_BIN, rounds=6) for q in p]
    assert [b.model_to_string() for b in many] == solos[:2]
    assert [b.model_to_string() for b in capped] == solos


def test_refresh_many_matches_serial_candidates():
    """Stacked mode: a per-segment family warm-starts from its deployed
    models in one call, each candidate byte-identical to its solo
    ``train_candidate``."""
    from lightgbm_tpu_torch.lifecycle.refresh import (fresh_dataset,
                                                      refresh_many,
                                                      train_candidate)
    rng = np.random.RandomState(21)
    params = [dict(BASE, objective="binary"),
              dict(BASE, objective="binary", learning_rate=0.2)]
    seg_x = [rng.randn(500, F), rng.randn(640, F)]
    seg_y = [(x[:, 0] + 0.3 * x[:, 1] > 0).astype(float) for x in seg_x]
    fresh_x = [x + 0.01 * np.random.RandomState(9).randn(*x.shape)
               for x in seg_x]
    deployed = [lt.train(dict(p), _ds(y, x), num_boost_round=5,
                         verbose_eval=False)
                for p, x, y in zip(params, seg_x, seg_y)]

    def fresh_sets():
        return [fresh_dataset(_ds(y, x), fx, y)
                for x, y, fx in zip(seg_x, seg_y, fresh_x)]

    solos = [train_candidate(d, t, dict(p), 6).model_to_string()
             for d, t, p in zip(deployed, fresh_sets(), params)]
    cands = refresh_many(deployed, fresh_sets(), params, 6)
    assert [c.model_to_string() for c in cands] == solos
    assert all(c.current_iteration() == 11 for c in cands)


def test_sweep_probe_reports():
    from lightgbm_tpu_torch.tools.torch_sweep_probe import run_probe
    out = run_probe(rows=2000, features=6, max_bin=15, leaves=7, chunk=2,
                    reps=1, widths=(1, 2), device="cpu")
    for B in (1, 2):
        row = out[f"B{B}"]
        assert row["iters_per_sec"] > 0
        assert row["s_per_tree_batched"] > 0
        assert row["s_per_tree_sequential"] > 0
        assert row["texts_equal"]
    assert out["model_batch_plan"]["b_total"] == 2
    assert out["aggregate_speedup_vs_b1"] > 0
    assert out["accel"] is False


def test_devprof_batched_row():
    from lightgbm_tpu_torch.obs.devprof import histogram_utilization_table
    t = histogram_utilization_table(rows=1500, features=4, num_bins=8,
                                    reps=1, quant=False, device="cpu")
    row = t["f32/scatter_batched8"]
    assert "error" not in row
    assert row["seconds_per_call"] > 0
    assert row["lanes"] == 8 and row["kernel"] == "B6"


def test_fleet_swaps_sweep_winner():
    """The sweep's winner hot-swaps into a serving Fleet through the
    probe-quarantine path and serves its exact raw scores (the serving
    contract: the host float64 sums of ``predict(device=False)``)."""
    vs = lt.Dataset(XV, label=YV_BIN, free_raw_data=False, device="cpu")
    evals = [{}, {}, {}]
    grid = {"objective": "binary", "verbosity": -1, "num_leaves": 7,
            "metric": "binary_logloss", "learning_rate": [0.05, 0.1, 0.2]}
    many = lt.train_many(grid, _ds(), num_boost_round=8,
                         valid_sets=[vs], evals_results=evals)
    winner = min(
        range(3), key=lambda i: evals[i]["valid_0"]["binary_logloss"][-1])
    fleet = lt.Fleet(max_batch_rows=128, device="cpu")
    fleet.config.deadline_classes["interactive"] = 10_000.0
    try:
        fleet.add_model("seg", many[(winner + 1) % 3], weight=1.0)
        fleet.swap_model("seg", many[winner])
        q = np.asarray(XV[:16], np.float32)
        assert np.array_equal(
            fleet.predict("seg", q, timeout=60),
            many[winner].predict(q, raw_score=True, device=False))
    finally:
        fleet.close()


# ----------------------------------------------------- beside the mirror

def test_dead_rounds_leave_a_lane_unchanged(monkeypatch):
    """Every lane sits through every round of the group (STOP_LAG past
    any tree's end), so lanes whose trees finish early ride many dead
    rounds of the group's round loop; each lane's text is its solo
    text all the same, and every round ran as one group round."""
    groups = []
    orig = batch.BatchedChunkProgram.__init__

    def spy(self, group):
        orig(self, group)
        groups.append(self)
    monkeypatch.setattr(batch.BatchedChunkProgram, "__init__", spy)
    params = [dict(BASE, objective="binary", num_leaves=15),
              dict(BASE, objective="binary", num_leaves=15,
                   learning_rate=0.3, bagging_fraction=0.5,
                   bagging_freq=1)]
    solos = [_solo_bst(p, Y_BIN, rounds=4) for p in params]
    monkeypatch.setattr(grower_rounds, "STOP_LAG", 1 << 20)
    many = lt.train_many([dict(p) for p in params], _ds(),
                         num_boost_round=4)
    for bst, solo in zip(many, solos):
        assert bst.model_to_string() == solo.model_to_string()
        # every tree ran all num_leaves - 1 rounds, most of them dead
        assert [r for r, _ in bst.boosting.grower.round_counts] == [14] * 4
        live = [int(n) for _, n in bst.boosting.grower.round_counts]
        assert max(live) < 14               # every tree done before then
    assert len(groups) == 1
    rg = groups[0].rounds
    assert rg.group_rounds == 4 * 14 and rg.lane_rounds == 0


def test_round_group_replays_only_the_growers_it_captured(monkeypatch):
    """A group graph replays only for the very grower objects it was
    captured from, and keeps them alive until it captures again: a
    grower rebuilt in place of a freed one (which may get the freed
    one's address) is captured anew, never replayed onto."""
    import gc
    import weakref

    class Graph:
        def replay(self):
            pass

    class Lane:
        device = torch.device("cpu")
        _section = None

        def __init__(self):
            self.bodies = 0

        def _round(self, section):
            self.bodies += 1

    monkeypatch.setattr(grower_rounds, "capture_rounds",
                        lambda growers, device: (Graph(), ({}, {}, {}), 0.0))
    rg = grower_rounds.RoundGroup()
    a, b = Lane(), Lane()
    rg._step_all([a, b], True)
    rg._step_all([a, b], True)
    assert (rg.captures, rg.replays, a.bodies) == (1, 1, 1)
    held = weakref.ref(b)
    del b
    gc.collect()
    assert held() is not None           # the captured lane stays alive
    c = Lane()
    rg._step_all([a, c], True)
    assert (rg.captures, rg.replays, c.bodies) == (2, 1, 1)
    gc.collect()
    assert held() is None               # released with its graph


def test_train_many_agrees_with_the_jax_package():
    """The port's ``train_many`` against the JAX package's on the same
    configs (its rounds grower and fused arm, as the solo comparisons
    run it): the same tree structure, leaf values to the solo
    comparison's tolerance (C-3)."""
    extra = {"tpu_tree_growth": "rounds", "tpu_hist_method": "fused"}
    params = [dict(BASE, objective="binary", **extra),
              dict(BASE, objective="binary", learning_rate=0.23,
                   bagging_fraction=0.7, bagging_freq=1, **extra)]
    jmany = lgb.train_many([dict(p) for p in params],
                           lgb.Dataset(X, label=Y_BIN, free_raw_data=False),
                           num_boost_round=8)
    tmany = lt.train_many([dict(p) for p in params], _ds(),
                          num_boost_round=8)
    for jb, tb in zip(jmany, tmany):
        assert_same_trees(jb, tb, 8)


def test_no_cuda_no_fallback(tmp_path):
    """On a host without CUDA, the entry points without ``device="cpu"``
    raise; they never fall back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA; the refusal needs a host without")
    with pytest.raises(RuntimeError, match="CUDA"):
        lt.train_many([dict(BASE, objective="binary")], _ds(),
                      num_boost_round=2, device="cuda")
    fleet = lt.Fleet(max_batch_rows=32, device="cpu")
    try:
        fleet.add_model("live", _solo_bst(dict(BASE, objective="binary"),
                                          Y_BIN, rounds=2))
        with pytest.raises(RuntimeError, match="CUDA"):
            lt.LifecycleController(fleet, "live",
                                   directory=str(tmp_path / "lc"))
        ctl = lt.LifecycleController(fleet, "live", device="cpu",
                                     directory=str(tmp_path / "lc"))
        assert ctl.device.type == "cpu"
    finally:
        fleet.close()
