"""Chunked iterations in the port (``lightgbm_tpu_torch/boosting/macro.py``,
``Booster.update_chunk``, the engine's chunk scheduler) and
``rollback_one_iter``, on the CPU; tests/test_macro.py's cases.

- Every ``PARITY_CASES`` entry of tests/test_macro.py (here five,
  ``test_torch_macro_quant.py`` the other five) trained over 12
  iterations in the reference's chunk plans, ``[8, 4]`` and ``[2, 1, 4,
  2, 2, 1]``, gives model text byte-identical to twelve ``update()``
  calls; the first four iterations of the ``[8, 4]`` run give the trees
  of the JAX package's ``update_chunk(4)`` (its rounds grower; the comparator
  and tolerances of tests/test_torch_objectives.py: rtol 1e-4, and for
  quantized training 1e-5 of the tree's largest leaf, as
  tests/test_torch_quantized.py holds it).
- Through ``train``: a learning-rate schedule, early stopping, RF's
  valid scores and ``metric_freq`` give the same model, evaluations and
  best iteration whether the engine chunks or trains one iteration at a
  time (a callback that is not ``_chunk_safe`` forces that); the engine
  does chunk where it may.
- DART and a custom objective are not chunk-supported: ``update_chunk``
  refuses, the engine trains them one iteration at a time.
- A chunk whose first iteration cannot split stops there, as
  per-iteration training does.
- ``rollback_one_iter``: ``test_torch_macro_quant.py``.
"""

import numpy as np
import pytest
import torch

import lightgbm_tpu as lgb

import lightgbm_tpu_torch as lt

from lightgbm_tpu_torch.model_text import load_model_from_string

from test_macro import N, PARITY_CASES, X, XV, Y_BIN, YV_BIN
from test_torch_objectives import TREE_EXACT, assert_same_trees
from lightgbm_tpu_torch.testing import one_thread  # noqa: F401


PLANS = ([8, 4], [2, 1, 4, 2, 2, 1])
JAX_ITERS = 4
QUANT_CASES = ("quant", "quant_renew", "fused_quant")
# the parity cases of this file; test_torch_macro_quant.py holds the rest
# (one file a worker: the port's CPU trainings are the cost)
CASES = ("bagging", "gbdt", "goss", "monotone", "rf")


def _port(params, y, chunks):
    ds = lt.Dataset(X, label=y, device="cpu")
    b = lt.Booster(dict(params, verbose=-1), train_set=ds)
    for c in chunks:
        if c > 1:
            b.update_chunk(c)
        else:
            b.update()
    return b


def port_runs(cases) -> dict:
    """case -> {plan: booster} for twelve ``update()`` calls ("per
    iteration") and each of ``PLANS``."""
    out = {}
    for case in cases:
        params, y = PARITY_CASES[case]
        out[case] = {"per iteration": _port(params, y, [1] * 12)}
        for plan in PLANS:
            out[case][str(plan)] = _port(params, y, plan)
    return out


def jax_runs(cases) -> dict:
    """case -> the JAX package's booster after ``update_chunk(4)``."""
    out = {}
    for case in cases:
        params, y = PARITY_CASES[case]
        p = dict(params, verbosity=-1, tpu_tree_growth="rounds")
        p.setdefault("tpu_hist_method", "fused")
        b = lgb.Booster(params=p, train_set=lgb.Dataset(
            X, label=y, free_raw_data=False))
        b.update_chunk(JAX_ITERS)
        out[case] = b
    return out


class FirstIterations:
    """A booster's model text cut to its first ``n`` iterations."""

    def __init__(self, bst, n: int):
        self.text = bst.model_to_string(num_iteration=n)

    def model_to_string(self) -> str:
        return self.text


def check_chunked_equals_per_iteration(runs):
    per_iter = runs["per iteration"].model_to_string()
    for plan in PLANS:
        assert runs[str(plan)].model_to_string() == per_iter, plan


def check_trees_match_the_jax_package(case, runs, bj):
    """The port's first four iterations of the [8, 4] chunk plan against
    the JAX package's ``update_chunk(4)``."""
    bt = runs[str(PLANS[0])]
    K = bt.num_tree_per_iteration
    first = FirstIterations(bt, JAX_ITERS)
    if case == "rf":
        assert_same_rf_trees(bj, first, JAX_ITERS)
        return
    kw = ({"atol_of_largest": 1e-5} if case in QUANT_CASES else {})
    assert_same_trees(bj, first, JAX_ITERS * K, **kw)


@pytest.fixture(scope="module")
def trained():
    return port_runs(CASES)


@pytest.fixture(scope="module")
def jax_chunked():
    return jax_runs(CASES)


@pytest.mark.parametrize("case", CASES)
def test_chunked_equals_per_iteration(case, trained):
    check_chunked_equals_per_iteration(trained[case])


def assert_same_rf_trees(bj, bt, num_trees):
    """RF's trees grow from the same constant gradients, each on its own
    bag, so a split that ties in f32 changes only its own tree: trees are
    compared whole (``assert_same_trees``'s bars), except that at a node
    where the two packages take different splits their gains must tie
    (rtol 1e-6), every node before it must be equal, and the tree must
    have as many leaves.  (On this data the second tree's last split ties
    at 2.76132 between features 3 and 7: ROADMAP queue C-18.)"""
    jm = load_model_from_string(bj.model_to_string())["models"]
    tm = load_model_from_string(bt.model_to_string())["models"]
    assert len(jm) == len(tm) == num_trees
    for j, t in zip(jm, tm):
        assert j.num_leaves == t.num_leaves
        nodes = j.num_leaves - 1
        differ = np.nonzero((j.split_feature != t.split_feature)
                            | (j.threshold != t.threshold))[0]
        if differ.size == 0:
            for f in TREE_EXACT:
                assert np.array_equal(getattr(j, f), getattr(t, f)), f
            np.testing.assert_allclose(t.leaf_value, j.leaf_value,
                                       rtol=1e-4, atol=1e-6)
            continue
        d = int(differ[0])
        np.testing.assert_allclose(t.split_gain[d], j.split_gain[d],
                                   rtol=1e-6)
        for f in ("split_feature", "threshold", "decision_type",
                  "left_child", "right_child"):
            assert np.array_equal(getattr(j, f)[:d], getattr(t, f)[:d]), f
        assert d < nodes


@pytest.mark.parametrize("case", CASES)
def test_chunk_trees_match_the_jax_package(case, trained, jax_chunked):
    check_trees_match_the_jax_package(case, trained[case],
                                      jax_chunked[case])


def _engine(params, rounds, *, per_iteration=False, valid=False, **kw):
    """``lt.train`` chunked, or one iteration at a time (a callback that
    is not chunk-safe); returns (booster, evals, chunk sizes used)."""
    ds = lt.Dataset(X, label=Y_BIN, device="cpu")
    sizes = []
    real = lt.Booster.update_chunk

    def spy(self, c, lrs=None):
        sizes.append(c)
        return real(self, c, lrs)
    cbs = [lambda env: None] if per_iteration else []
    evals = {}
    lt.Booster.update_chunk = spy
    try:
        bst = lt.train(dict(params, verbose=-1), ds, rounds,
                       valid_sets=([ds.create_valid(XV, label=YV_BIN)]
                                   if valid else None),
                       evals_result=evals, verbose_eval=False,
                       callbacks=cbs, **kw)
    finally:
        lt.Booster.update_chunk = real
    return bst, evals, sizes


def test_lr_schedule_parity_via_engine():
    sched = [0.1 * (0.97 ** i) for i in range(16)]
    params = {"objective": "binary", "num_leaves": 15}
    on, _, sizes = _engine(params, 16, learning_rates=sched)
    off, _, none = _engine(params, 16, per_iteration=True,
                           learning_rates=sched)
    assert sizes == [16] and none == []
    assert on.model_to_string() == off.model_to_string()
    assert on.boosting.shrinkage_rate == off.boosting.shrinkage_rate


def test_early_stopping_parity_via_engine():
    params = {"objective": "binary", "num_leaves": 15,
              "metric": "binary_logloss", "metric_freq": 2}
    on, ev_on, sizes = _engine(params, 60, valid=True,
                               early_stopping_rounds=4)
    off, ev_off, _ = _engine(params, 60, valid=True, per_iteration=True,
                             early_stopping_rounds=4)
    assert sizes and set(sizes) == {2}
    assert on.best_iteration == off.best_iteration
    assert on.model_to_string() == off.model_to_string()
    assert ev_on == ev_off


def test_rf_valid_scores_parity_via_engine():
    params = {"objective": "binary", "boosting": "rf", "num_leaves": 15,
              "bagging_fraction": 0.6, "bagging_freq": 1,
              "metric": "binary_logloss", "metric_freq": 4}
    on, ev_on, sizes = _engine(params, 8, valid=True)
    off, ev_off, _ = _engine(params, 8, valid=True, per_iteration=True)
    assert sizes == [4, 4]
    assert on.model_to_string() == off.model_to_string()
    assert ev_on == ev_off


def test_metric_freq_gates_eval():
    _, evals, sizes = _engine({"objective": "binary", "num_leaves": 15,
                               "metric": "binary_logloss",
                               "output_freq": 3}, 12, valid=True)
    assert len(evals["valid_0"]["binary_logloss"]) == 4
    assert sizes == [2] * 4


def test_c1_fallback_modes():
    """DART drops and rescales trees every iteration on the host:
    chunk_supported is False, update_chunk refuses, and the engine trains
    it one iteration at a time."""
    params = {"objective": "binary", "boosting": "dart", "num_leaves": 15}
    b = _port(params, Y_BIN, [])
    assert not b.boosting.chunk_supported()
    with pytest.raises(RuntimeError, match="per-iteration"):
        b.update_chunk(4)
    bst, _, sizes = _engine(params, 4)
    assert bst.current_iteration() == 4 and sizes == []


def test_custom_fobj_not_chunk_supported():
    ds = lt.Dataset(X, label=Y_BIN, device="cpu")
    bst = lt.train({"num_leaves": 15, "verbose": -1}, ds, 3,
                   verbose_eval=False,
                   fobj=lambda preds, d: (
                       1.0 / (1.0 + np.exp(-preds)) - d.get_label(),
                       np.full(len(preds), 0.25)))
    assert bst.num_trees() == 3
    assert not bst.boosting.chunk_supported()


def test_chunk_stop_on_unsplittable():
    """Constant labels stop at iteration 0 with the boost-from-average
    constant tree, in a chunk as one iteration at a time."""
    params = {"objective": "regression", "num_leaves": 15, "verbose": -1}
    ds = lt.Dataset(X, label=np.full(N, 3.25), device="cpu")
    b = lt.Booster(params, train_set=ds)
    assert b.update_chunk(4)
    assert b.current_iteration() == 0
    assert b.num_trees() == 1
    np.testing.assert_allclose(b.predict(X[:5]), 3.25, rtol=1e-6)


def test_mid_chunk_stop_truncates_like_per_iteration():
    """A chunk that runs out of splits part way keeps the iterations
    before the stop and the stopping one's score update, as per-iteration
    training does."""
    rng = np.random.RandomState(3)
    Xs = rng.randn(400, 3)
    y = (Xs[:, 0] > 0).astype(float)
    params = {"objective": "regression", "num_leaves": 3,
              "min_data_in_leaf": 150, "learning_rate": 1.0,
              "verbose": -1}

    def run(chunks):
        b = lt.Booster(params, train_set=lt.Dataset(Xs, label=y,
                                                    device="cpu"))
        stops = [b.update_chunk(c) if c > 1 else b.update()
                 for c in chunks]
        return b, stops
    per, stops = run([1] * 8)
    assert any(stops)
    chunked, cstops = run([8])
    assert cstops == [True]
    assert chunked.current_iteration() == per.current_iteration() < 8
    assert chunked.model_to_string() == per.model_to_string()
    assert np.array_equal(chunked.boosting.train_score.numpy(),
                          per.boosting.train_score.numpy())
