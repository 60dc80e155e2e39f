"""Sharded training in the port (``lightgbm_tpu_torch/parallel/``) on
the CPU: W ranks are threads of this process, each with its own gloo
process group (``lightgbm_tpu_torch.testing.thread_ranks``).

The cases of tests/test_parallel.py, on the port: the data- and
feature-parallel growers against the serial grower, and data-, feature-
and voting-parallel training through ``lt.train`` against serial
training.  The port's histograms are exact integers, so a data-parallel
tree is the serial tree and the model text is byte-identical (the JAX
package holds its f32 psum to rtol=1e-4); feature-parallel and voting at
full top-k also give the serial text, and ranking keeps every query on
one rank.  Then the port against the JAX package's data-, feature- and
voting-parallel runs on its 8 CPU devices (tests/conftest.py) at W = 8,
quantized data-parallel included (both fold the rank into the
quantization key): equal structure, leaf values to ROADMAP queue C's
C-3 tolerances.  Then the per-rank kernel launches (counting stubs in
place of the CUDA wrappers) and the collectives of each tree, counted
exactly, and the "fused does not apply" warning.
"""

import json
import os

import numpy as np
import pytest
import torch

import lightgbm_tpu as lgb

import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch.dataset import FeatureMeta
from lightgbm_tpu_torch.grower import GrowerConfig, SerialGrower
from lightgbm_tpu_torch.ops import fused, histogram
from lightgbm_tpu_torch.ops.split import SplitHyperparams
from lightgbm_tpu_torch.parallel import collectives, learners
from lightgbm_tpu_torch.testing import thread_ranks
from lightgbm_tpu_torch.testing import one_thread  # noqa: F401

from test_torch_objectives import assert_same_trees

N = 2000
BASE = {"num_leaves": 15, "min_data_in_leaf": 20, "verbose": -1}
BINARY = dict(BASE, objective="binary")


def _binary_xy(n=N, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, 8).astype(np.float32)
    X[:, 4] = np.round(X[:, 4] * 2)
    z = X[:, 0] + 0.5 * X[:, 1] * X[:, 2] - 0.4 * X[:, 4] \
        + 0.3 * rng.randn(n)
    return X, (z > 0).astype(np.float32)


def _efb_xy(n=600, seed=0):
    rng = np.random.RandomState(seed)
    groups = rng.randint(0, 8, size=n)
    X = np.zeros((n, 8), np.float32)
    X[np.arange(n), groups] = rng.rand(n) + 0.5
    X = np.concatenate([X, rng.rand(n, 4).astype(np.float32)], axis=1)
    y = ((groups % 2) ^ (X[:, 8] > 0.5)).astype(np.float32)
    return X, y


def _ranking_xy(n_queries=60, seed=7):
    rng = np.random.RandomState(seed)
    sizes = rng.randint(5, 40, n_queries)
    X = rng.rand(int(sizes.sum()), 6).astype(np.float32)
    rel = 2.0 * X[:, 0] + X[:, 1] + 0.3 * rng.randn(len(X))
    y = np.clip(np.digitize(rel, [0.8, 1.5, 2.2]), 0, 3)
    return X, y.astype(np.float32), sizes.astype(np.int64)


def _body(text: str) -> str:
    """The trees of a model text (its parameters name the learner)."""
    return text.partition("parameters:")[0]


def _train(params, X, y, rounds, valid=None, **ds_kw):
    ds = lt.Dataset(X, label=y, device="cpu", **ds_kw)
    ev = {}
    vs = ([ds.create_valid(valid[0], label=valid[1])]
          if valid is not None else None)
    bst = lt.train(dict(params), ds, rounds, valid_sets=vs,
                   evals_result=ev, verbose_eval=False)
    return bst, ev


def _ranks(world, params, X, y, rounds, valid=None, **ds_kw):
    """Train on ``world`` thread ranks; returns each rank's (booster,
    evals)."""
    return thread_ranks(world, lambda rank, group: _train(
        params, X, y, rounds, valid, **ds_kw))


def _assert_serial(params, X, y, rounds, world, serial_extra=None,
                   valid=None, **ds_kw):
    """Every rank's model text is the serial model's, byte for byte (the
    trees; and the evaluations are equal); returns the serial booster and
    the ranks' boosters."""
    sp = {k: v for k, v in params.items() if k not in ("tree_learner",
                                                       "top_k")}
    sp.update(serial_extra or {})
    ser, ev_s = _train(sp, X, y, rounds, valid, **ds_kw)
    want = _body(ser.model_to_string())
    out = _ranks(world, params, X, y, rounds, valid, **ds_kw)
    for bst, ev in out:
        assert _body(bst.model_to_string()) == want
        assert ev == ev_s
    return ser, [b for b, _ in out]


# ---------------------------------------------------------------------------
# the growers (tests/test_parallel.py's first three cases)

@pytest.fixture(scope="module")
def problem():
    rng = np.random.RandomState(0)
    n, F, B = 1024, 8, 16
    binned = rng.randint(0, B, size=(n, F)).astype(np.uint8)
    grad = (rng.randn(n) + 0.5 * (binned[:, 1] > 8)).astype(np.float32)
    hess = np.ones(n, np.float32)
    return binned, grad, hess, B, F


def _meta(B, F):
    return FeatureMeta(
        num_bin=np.full(F, B, np.int32), missing_type=np.zeros(F, np.int32),
        default_bin=np.zeros(F, np.int32),
        most_freq_bin=np.zeros(F, np.int32),
        is_categorical=np.zeros(F, bool), max_num_bin=B).resolved()


def _cfg(B):
    return GrowerConfig(num_leaves=15, num_bins=B,
                        hp=SplitHyperparams(min_data_in_leaf=10))


def _serial_tree(problem):
    binned, grad, hess, B, F = problem
    g = SerialGrower(torch.as_tensor(np.ascontiguousarray(binned.T)),
                     _meta(B, F), _cfg(B))
    tree, leaf = g.grow(torch.as_tensor(grad), torch.as_tensor(hess),
                        torch.ones(len(grad)))
    return tree.to_numpy(), leaf.numpy()


def _same_tree(a: dict, b: dict):
    for f, v in a.items():
        np.testing.assert_array_equal(np.asarray(b[f]), np.asarray(v),
                                      err_msg=f)


def test_data_parallel_matches_serial(problem):
    binned, grad, hess, B, F = problem
    ref_tree, ref_leaf = _serial_tree(problem)

    def fn(rank, group):
        (b, g, h, m), n_pad = learners.shard_dataset(
            group, binned, grad, hess, np.ones(len(grad), np.float32),
            device="cpu")
        grower = learners.create_parallel_grower(
            "data", group, torch.as_tensor(np.ascontiguousarray(binned.T)),
            _meta(B, F), _cfg(B))
        # the factory's share (the booster's) is shard_dataset's block
        assert torch.equal(grower.binned_t, b)
        tree, leaf = grower.grow(g, h, m)
        return tree.to_numpy(), leaf.numpy(), n_pad
    out = thread_ranks(4, fn)
    leaf = np.concatenate([o[1] for o in out])
    for tree, _, n_pad in out:
        assert n_pad % 4 == 0
        _same_tree(ref_tree, tree)
    np.testing.assert_array_equal(leaf[:len(ref_leaf)], ref_leaf)


def test_feature_parallel_matches_serial(problem):
    binned, grad, hess, B, F = problem
    ref_tree, ref_leaf = _serial_tree(problem)

    def fn(rank, group):
        grower = learners.create_parallel_grower(
            "feature", group, torch.as_tensor(np.ascontiguousarray(binned.T)),
            _meta(B, F), _cfg(B))
        assert grower.binned_t.shape[0] == F // 4
        tree, leaf = grower.grow(torch.as_tensor(grad),
                                 torch.as_tensor(hess), torch.ones(len(grad)))
        return tree.to_numpy(), leaf.numpy()
    for tree, leaf in thread_ranks(4, fn):
        _same_tree(ref_tree, tree)
        np.testing.assert_array_equal(leaf, ref_leaf)


def test_2d_mesh_matches_serial(problem):
    """tests/test_parallel.py's 2-D case on a (4, 2) mesh of 8 thread
    ranks: rank (i, j) holds row block i and feature share j; the
    histograms are summed over the data axis and the candidates gathered
    over the feature axis.  The sums are exact, so the tree is the serial
    grower's, byte for byte, and so are the row blocks' leaf ids."""
    binned, grad, hess, B, F = problem
    ref_tree, ref_leaf = _serial_tree(problem)

    def fn(rank, group):
        mesh = learners.make_mesh(group, (learners.DATA_AXIS,
                                          learners.FEATURE_AXIS), (4, 2))
        i, j = mesh.coords["data"], mesh.coords["feature"]
        rows = learners.contiguous_layout(len(grad), 4).rows(i)
        grower = learners.create_parallel_grower(
            "data_feature", mesh,
            torch.as_tensor(np.ascontiguousarray(binned.T)), _meta(B, F),
            _cfg(B))
        assert grower.binned_t.shape == (F // 2, len(rows))
        tree, leaf = grower.grow(torch.as_tensor(grad[rows]),
                                 torch.as_tensor(hess[rows]),
                                 torch.ones(len(rows)))
        return tree.to_numpy(), leaf.numpy(), j
    out = thread_ranks(8, fn)
    for tree, _, _ in out:
        _same_tree(ref_tree, tree)
    leaf = np.concatenate([lf for _, lf, j in out if j == 0])
    np.testing.assert_array_equal(leaf, ref_leaf)


def test_booster_refuses_the_2d_layout():
    """The JAX booster takes serial, data, feature and voting and raises
    ``ValueError("unknown tree_learner ...")`` for the 2-D names
    (lightgbm_tpu/boosting/gbdt.py:362-367); so does the port's, which
    builds the 2-D layout only through ``create_parallel_grower``."""
    X, y = _binary_xy(300)
    for tl in ("data_feature", "2d"):
        with pytest.raises(ValueError, match=f"unknown tree_learner '{tl}'"):
            lgb.train(dict(BINARY, tree_learner=tl), lgb.Dataset(X, label=y),
                      1)
        with pytest.raises(ValueError, match=f"unknown tree_learner '{tl}'"):
            lt.train(dict(BINARY, tree_learner=tl),
                     lt.Dataset(X, label=y, device="cpu"), 1)
    assert learners.resolve_tree_learner("2d") == "data_feature"
    assert not hasattr(learners, "shrink_and_resume")


# ---------------------------------------------------------------------------
# through lt.train

@pytest.mark.parametrize("world", [2, 4, 8])
def test_engine_data_parallel_end_to_end(world):
    X, y = _binary_xy()
    Xv, yv = _binary_xy(500, seed=1)
    params = dict(BINARY, tree_learner="data", metric="auc")
    _, ranks = _assert_serial(params, X, y, 3, world, valid=(Xv, yv))
    b = ranks[-1].boosting
    assert b.tree_learner_type == "data" and b.world == world
    n_shard = learners.pad_rows_to(N, world) // world
    assert b._n_shard == n_shard
    assert b.grower.binned_t.shape[1] == N - (world - 1) * n_shard


def test_engine_feature_parallel_end_to_end():
    X, y = _binary_xy()
    _assert_serial(dict(BINARY, tree_learner="feature"), X, y, 6, 3)


def test_engine_feature_parallel_with_efb_matches_serial():
    """Whole EFB bundles per rank (reference: feature_parallel_tree_
    learner.cpp:33-52), packed as the JAX package packs them."""
    X, y = _efb_xy()
    ds = lt.Dataset(X, label=y, device="cpu").construct()
    assert ds.feature_meta().has_bundles, "test premise: EFB fires"
    params = dict(BASE, objective="binary", min_data_in_leaf=5,
                  tree_learner="feature")
    _assert_serial(params, X, y, 5, 3, {"tpu_tree_growth": "serial"})
    lay = learners.feature_layout(ds.feature_meta(), 3)
    assert sorted(np.concatenate(lay.features).tolist()) == \
        list(range(len(ds.used_features)))


@pytest.mark.parametrize("extra", [
    {"bagging_freq": 1, "bagging_fraction": 0.7},
    {"boosting": "goss", "learning_rate": 0.5},
    {"objective": "regression_l1"},
], ids=["bagging", "goss", "l1"])
def test_engine_data_parallel_bagging_goss_l1(extra):
    X, y = _binary_xy()
    _assert_serial(dict(BINARY, tree_learner="data", **extra), X, y, 5, 2)


def test_engine_voting_parallel_matches_serial_at_full_topk():
    X, y = _binary_xy()
    params = dict(BINARY, tree_learner="voting", top_k=X.shape[1])
    _, ranks = _assert_serial(params, X, y, 5, 2,
                              {"tpu_tree_growth": "serial"})
    assert ranks[0].boosting.grower_cfg.voting_top_k == X.shape[1]


def test_engine_voting_parallel_small_topk_trains():
    X, y = _binary_xy()
    Xv, yv = _binary_xy(500, seed=1)
    params = dict(BINARY, tree_learner="voting", top_k=3, metric="auc")
    out = _ranks(2, params, X, y, 6, valid=(Xv, yv))
    assert out[0][0].model_to_string() == out[1][0].model_to_string()
    ser, ev = _train(dict(BINARY, metric="auc"), X, y, 6, (Xv, yv))
    auc_v = out[0][1]["valid_0"]["auc"][-1]
    assert auc_v > 0.85 and abs(auc_v - ev["valid_0"]["auc"][-1]) < 0.03


def test_voting_parallel_reduces_histogram_traffic():
    """The vote sums [top_k, B] histograms instead of [F, B]: fewer bytes
    by ``hist_payload_bytes`` and on the wire."""
    X, y = _binary_xy()

    def fn(tl, **kw):
        def run(rank, group):
            collectives.reset_op_counts()
            lt.train(dict(BINARY, tree_learner=tl, num_leaves=7, **kw),
                     lt.Dataset(X, label=y, device="cpu"), 2)
            return dict(collectives.thread_op_counts())
        return thread_ranks(2, run)[0]
    data, vote = fn("data", tpu_tree_growth="serial"), fn("voting", top_k=2)
    assert vote["all_reduce_bytes"] < data["all_reduce_bytes"]
    B = 64
    assert histogram.hist_payload_bytes(2, B) < histogram.hist_payload_bytes(
        8, B)
    assert histogram.hist_payload_bytes(8, B) == 3 * 8 * B * 8
    assert histogram.hist_payload_bytes(8, B, quant=True) == 2 * 8 * B * 4
    assert learners.fused_best_payload_bytes(8) == 6 * 8 * 4


def test_engine_feature_parallel_monotone_matches_serial():
    X, y = _binary_xy()
    params = dict(BINARY, tree_learner="feature",
                  monotone_constraints=[1, -1] * 4)
    _assert_serial(params, X, y, 5, 2, {"tpu_tree_growth": "serial"})


@pytest.mark.parametrize("objective", ["lambdarank", "rank_xendcg"])
def test_engine_data_parallel_ranking_matches_serial(objective):
    """Whole queries per rank (reference: Metadata::CheckOrPartition,
    src/io/metadata.cpp:141)."""
    X, y, group = _ranking_xy()
    params = dict(BASE, objective=objective, min_data_in_leaf=10,
                  objective_seed=11, tree_learner="data")
    _, ranks = _assert_serial(params, X, y, 3, 3, group=group)
    lay = ranks[0].boosting.layout
    qb = np.concatenate([[0], np.cumsum(group)])
    owner = np.full(len(y), -1)
    for r in range(3):
        owner[lay.rows(r)] = r
    assert (owner >= 0).all()
    for q in range(len(group)):
        assert len(set(owner[qb[q]:qb[q + 1]])) == 1


def test_network_machine_list_mapping():
    import socket
    from lightgbm_tpu_torch.parallel.network import (init_network,
                                                     parse_machine_list,
                                                     resolve_rank)
    ml = parse_machine_list("10.0.0.1:12400,10.0.0.2:12401")
    assert ml == [("10.0.0.1", 12400), ("10.0.0.2", 12401)]
    host = socket.gethostname()
    assert resolve_rank(parse_machine_list(f"10.0.0.1:12400,{host}:12401")) \
        == 1
    assert init_network(machines=f"10.0.0.1:12400,{host}:12401",
                        num_machines=2, dry_run=True) == \
        ("10.0.0.1:12400", 2, 1)
    assert resolve_rank(parse_machine_list(f"{host}:12400,{host}:12401"),
                        local_listen_port=12401) == 1
    with pytest.raises(ValueError):
        resolve_rank([("10.9.9.9", 1)])


# ---------------------------------------------------------------------------
# CEGB and forced splits with the sharded learners

def test_cegb_feature_parallel_matches_serial():
    X, y = _binary_xy()
    params = dict(BINARY, tree_learner="feature", cegb_penalty_split=0.002,
                  cegb_penalty_feature_coupled=[0.3] * 8)
    ser, _ = _assert_serial(params, X, y, 5, 2)
    plain, _ = _train(BINARY, X, y, 5)
    assert _body(plain.model_to_string()) != _body(ser.model_to_string())


def test_cegb_lazy_feature_parallel_matches_serial():
    X, y = _binary_xy()
    _assert_serial(dict(BINARY, tree_learner="feature",
                        cegb_penalty_feature_lazy=[0.004] * 8), X, y, 4, 2)


def test_cegb_feature_parallel_with_efb_matches_serial():
    X, y = _efb_xy()
    params = dict(BASE, objective="binary", min_data_in_leaf=5,
                  tree_learner="feature",
                  cegb_penalty_feature_coupled=[0.2] * X.shape[1])
    _assert_serial(params, X, y, 4, 3)


def test_cegb_data_parallel_matches_serial():
    X, y = _binary_xy()
    _assert_serial(dict(BINARY, tree_learner="data", cegb_penalty_split=0.002,
                        cegb_penalty_feature_lazy=[0.002] * 8), X, y, 4, 3)


def _forced_json(tmp_path, spec):
    fn = os.path.join(str(tmp_path), "forced.json")
    with open(fn, "w") as f:
        json.dump(spec, f)
    return fn


def test_forced_splits_feature_parallel_matches_serial(tmp_path):
    X, y = _binary_xy()
    fn = _forced_json(tmp_path, {"feature": 3, "threshold": 0.5,
                                 "left": {"feature": 1, "threshold": 0.4}})
    ser, _ = _assert_serial(dict(BINARY, tree_learner="feature",
                                 forcedsplits_filename=fn), X, y, 4, 2)
    for m in ser.boosting.models:
        assert int(m.split_feature[0]) == 3


def test_forced_splits_voting_parallel_matches_serial(tmp_path):
    X, y = _binary_xy()
    fn = _forced_json(tmp_path, {"feature": 2, "threshold": 0.6})
    ser, _ = _assert_serial(dict(BINARY, tree_learner="voting", top_k=8,
                                 forcedsplits_filename=fn), X, y, 4, 2)
    for m in ser.boosting.models:
        assert int(m.split_feature[0]) == 2


def test_cegb_voting_raises_with_rationale():
    X, y = _binary_xy(400)
    with pytest.raises(NotImplementedError, match="tree_learner=data"):
        _ranks(2, dict(BASE, objective="binary", num_leaves=7,
                       tree_learner="voting", top_k=3,
                       cegb_penalty_split=0.01), X, y, 1)


def test_ranks_with_different_training_sets_raise():
    """Each rank's own rows as its Dataset (``pre_partition``'s layout)
    would be sliced again as if they were every row: the booster
    refuses, naming the ROADMAP item."""
    X, y = _binary_xy(600)

    def run(rank, group):
        rows = slice(rank * 300, (rank + 1) * 300)
        with pytest.raises(ValueError, match="pre-partitioned rows"):
            _train(dict(BINARY, tree_learner="data"), X[rows], y[rows], 1)
        return True
    assert thread_ranks(2, run) == [True, True]


def test_shard_dataset_places_on_the_card_by_default(monkeypatch):
    """``shard_dataset`` resolves ``device=None`` as every entry point
    of the port does (``basic.resolve_device``: the current card)."""
    from lightgbm_tpu_torch import basic
    seen = []
    monkeypatch.setattr(basic, "resolve_device", lambda d=None: seen.append(
        d) or torch.device("cpu"))
    (b, g), n_pad = learners.shard_dataset(None, np.ones((5, 2), np.uint8),
                                           np.arange(5.0))
    assert seen == [None] and b.shape == (2, 5) and n_pad == 5
    assert g.tolist() == list(range(5))


def test_one_rank_trains_serially():
    """Without a group of two or more ranks every learner is serial (the
    JAX package with one device), whatever ``num_machines`` says."""
    X, y = _binary_xy(600)
    want = _body(_train(BINARY, X, y, 3)[0].model_to_string())
    for extra in ({"tree_learner": "data"}, {"tree_learner": "feature"},
                  {"tree_learner": "voting"}, {"num_machines": 2}):
        bst, _ = _train(dict(BINARY, **extra), X, y, 3)
        assert bst.boosting.tree_learner_type == "serial"
        assert _body(bst.model_to_string()) == want


# ---------------------------------------------------------------------------
# against the JAX package's sharded runs (8 CPU devices)

JAX_BASE = dict(BASE, min_data_in_leaf=5, num_leaves=7, max_bin=63)


def _vote_xy(n=1000, F=16, seed=3):
    """Sixteen features of near-equal weight under heavy noise: each
    rank's local bests disagree, so a vote of 2 or 3 of 16 elects other
    features than the global best and the trees differ from the serial
    (= data-parallel) ones."""
    rng = np.random.RandomState(seed)
    X = rng.randn(n, F).astype(np.float32)
    z = X @ np.linspace(1.0, 0.6, F) + 1.5 * rng.randn(n)
    return X, (z > 0).astype(np.float32)


# (params, W, data): f32 data and full-top-k voting sum histograms, so
# the JAX package's 8 shards and the port's 2 ranks grow the same trees;
# its feature mode takes num_machines shards; quantized data-parallel
# folds the rank into the rounding key, and voting below full top-k
# scales its local constraints and weights by the shard count, so those
# run 8 ranks
JAX_CASES = {
    "data": (dict(JAX_BASE, objective="binary", tree_learner="data",
                  tpu_tree_growth="rounds"), 2, _binary_xy),
    "data_quant": (dict(JAX_BASE, objective="binary", tree_learner="data",
                        tpu_tree_growth="rounds", use_quantized_grad=True,
                        num_grad_quant_bins=16), 8, _binary_xy),
    "feature": (dict(JAX_BASE, objective="binary", tree_learner="feature",
                     tpu_tree_growth="serial", num_machines=2), 2,
                _binary_xy),
    "voting": (dict(JAX_BASE, objective="binary", tree_learner="voting",
                    top_k=8, tpu_tree_growth="serial"), 2, _binary_xy),
    "voting_top2": (dict(JAX_BASE, objective="binary", tree_learner="voting",
                         top_k=2, tpu_tree_growth="serial"), 8, _vote_xy),
    "voting_top3_quant": (dict(JAX_BASE, objective="binary",
                               tree_learner="voting", top_k=3,
                               tpu_tree_growth="serial",
                               use_quantized_grad=True,
                               num_grad_quant_bins=16), 8, _vote_xy),
}
JAX_ROUNDS = 2


@pytest.fixture(scope="session")
def jax_sharded():
    import jax
    assert jax.device_count() >= 8, "conftest must give 8 CPU devices"
    out = {}
    for name, (params, _, data) in JAX_CASES.items():
        X, y = data(1000)
        bst = lgb.train(dict(params), lgb.Dataset(X, label=y), JAX_ROUNDS)
        assert bst.boosting._mesh is not None
        out[name] = bst
    return out


@pytest.mark.parametrize("name", list(JAX_CASES))
def test_sharded_runs_match_the_jax_package(jax_sharded, name):
    """Equal structure; leaf values to 1e-4 (f32: the JAX package's f32
    psum against exact sums, C-3) or 1e-5 plus 1e-5 of the tree's
    largest leaf (quantized, as tests/test_torch_quantized.py holds the
    serial runs).  Below full top-k the vote must have left the serial
    tree, or a wrong weighting or election would pass unseen."""
    params, world, data = JAX_CASES[name]
    X, y = data(1000)
    out = _ranks(world, params, X, y, JAX_ROUNDS)
    for bst, _ in out:
        assert bst.boosting.world == world
        if name.endswith("quant"):
            assert_same_trees(jax_sharded[name], bst, JAX_ROUNDS, rtol=1e-5,
                              atol=1e-5, atol_of_largest=1e-5)
        else:
            assert_same_trees(jax_sharded[name], bst, JAX_ROUNDS)
    texts = {_body(b.model_to_string()) for b, _ in out}
    assert len(texts) == 1
    if name == "voting_top2":
        # (the quantized case's serial twin differs by the rank fold
        # alone, so only the f32 case can show the premise)
        serial = {k: v for k, v in params.items()
                  if k not in ("tree_learner", "top_k")}
        assert texts != {_body(_train(serial, X, y, JAX_ROUNDS)[0]
                               .model_to_string())}


# ---------------------------------------------------------------------------
# per-rank launches and collectives

def _counting_kernels(monkeypatch):
    """The CUDA wrappers' places taken by counting plain versions, so
    the CPU run counts launches as the card does."""
    from lightgbm_tpu_torch import grower as grower_mod
    from lightgbm_tpu_torch import grower_rounds

    monkeypatch.setattr(fused, "_check_device", lambda *ts: "cuda")

    def acc(binned_t, vals_t, slot, num_slots, num_bins, scales):
        fused._count("fused_frontier_accumulate",
                     vals_t.dtype == torch.int8)
        return histogram.accumulate_plain(binned_t, vals_t, slot, num_slots,
                                          num_bins, scales)

    def scan(small, scales, sums, nb, mt, db, hp, small_left, parent, mono,
             bounds, thr, pair=False, groups=None, plan=None):
        quant = isinstance(scales, fused.QuantScales)
        fused._count("fused_sibling_scan", quant)
        if pair:
            fused._count("fused_frontier_splits", quant)
        return fused.scan_plain(small, scales, sums, nb, mt, db, hp,
                                small_left, parent, mono, bounds, thr,
                                groups=groups)

    def hist6(binned_t, vals_t, num_bins, scales):
        histogram._count("histogram_pallas")
        return histogram.histogram_plain(binned_t, vals_t, num_bins, scales)
    monkeypatch.setattr(fused, "_accumulate_cuda", acc)
    monkeypatch.setattr(fused, "_scan_cuda", scan)
    for mod in (grower_mod, grower_rounds):
        monkeypatch.setattr(mod, "histogram_fixed", hist6)


@pytest.mark.parametrize("arm", ["fused", "staged"])
def test_per_rank_launch_counts_equal_a_lone_ranks(monkeypatch, arm):
    """Each thread rank counts its own launches (``thread_launch_counts``):
    a data-parallel rank launches B4, B5 and B6 as often as the lone
    serial run does (the same trees, round for round; the seam runs B4
    and B5 apart, so no B2 pair is counted), and the process-wide counts
    are the ranks' sum.  Each tree all-reduces once for the fixed-point
    peaks, once for the root and once a round, and gathers the leaf
    ids once; the booster gathers once as it is built (the ranks'
    training sets agree)."""
    _counting_kernels(monkeypatch)
    X, y = (_binary_xy() if arm == "fused" else _efb_xy())
    params = dict(BASE, objective="binary", min_data_in_leaf=5)
    kernels = ("fused_frontier_accumulate", "fused_sibling_scan",
               "histogram_pallas")

    def counts():
        c = dict(fused.thread_launch_counts())
        c.update(histogram.thread_launch_counts())
        return {k: c.get(k, 0) for k in kernels + ("fused_frontier_splits",)}
    fused.reset_launch_counts()
    histogram.reset_launch_counts()
    _train(params, X, y, 3)
    lone = counts()
    assert lone["fused_frontier_accumulate"] > 0
    assert lone["histogram_pallas"] == (3 if arm == "staged" else 0)

    def run(rank, group):
        fused.reset_launch_counts()
        histogram.reset_launch_counts()
        collectives.reset_op_counts()
        bst, _ = _train(dict(params, tree_learner="data"), X, y, 3)
        return counts(), dict(collectives.thread_op_counts()), bst
    out = thread_ranks(3, run)
    for mine, ops, bst in out:
        for k in kernels:
            assert mine[k] == lone[k], k
        assert mine["fused_frontier_splits"] == 0
        rounds = sum(r for r, _ in bst.boosting.grower.round_counts)
        trees = len(bst.boosting.models)
        assert ops["all_reduce"] == 2 * trees + rounds
        assert ops["all_gather"] == trees + 1


def test_fused_warning_fires_once_for_sharding(monkeypatch):
    """The JAX package's "tpu_hist_method=fused does not apply" warning
    (boosting/gbdt.py:719-731): once a booster, for feature sharding and
    for data-parallel training on the serial grower."""
    import threading

    from lightgbm_tpu_torch.boosting import gbdt as tgbdt
    X, y = _binary_xy(600)
    seen = {}
    monkeypatch.setattr(tgbdt, "log_warning", lambda m: seen.setdefault(
        threading.get_ident(), []).append(m))

    def warned(extra):
        def run(rank, group):
            seen[threading.get_ident()] = []
            lt.train(dict(BINARY, tpu_hist_method="fused", **extra),
                     lt.Dataset(X, label=y, device="cpu"), 2)
            return [w for w in seen[threading.get_ident()]
                    if "does not apply" in w]
        return thread_ranks(2, run)
    for extra in ({"tree_learner": "feature"},
                  {"tree_learner": "data", "tpu_tree_growth": "serial"}):
        for msgs in warned(extra):
            assert len(msgs) == 1 and "feature/voting sharding" in msgs[0]
    assert warned({"tree_learner": "data"}) == [[], []]
