"""Quantized-gradient training (``use_quantized_grad``) in the port held
against the JAX package: ``quantize_gradients``, the integer histogram
family, ``quant_rescale_hist``, leaf renewal and trained models
(``lightgbm_tpu.train`` with the rounds grower, the Pallas kernels in
interpret mode; the port on the CPU runs its kernels' plain versions).

Bars and their reasons:

- ``quantize_gradients``: levels and scales bit-equal (the threefry
  draws are bit-equal, tests/test_torch_threefry.py, and the arithmetic
  is the same f32 steps).
- Integer histograms and ``quant_rescale_hist``: equal (integer sums;
  the rescale is f32 elementwise).
- Leaf renewal sums: the port's are the f32 of the exact sums; the JAX
  package adds f32 in row order, held to the recursive-summation bound
  (m - 1) * 2**-24 * sum|x| of a leaf of m rows.
- Trained models at 16 and 64 bins: equal tree structure; leaf values to
  rtol=1e-5 plus 1e-5 of the tree's largest leaf value, predictions to
  1e-5 and metrics to 1e-4.  The split sums of the JAX package are f32
  sums of per-bin values ``fl(q_b * s)``, the port's are exact integer
  prefixes rounded once (measured: at most 3.9e-6 of the tree's largest
  leaf).
- On bundled data (staged arm) the per-leaf counts are estimates from
  the hess channel in both packages, and bin 0 of a bundled feature is
  rebuilt differently (ROADMAP queue C): leaf counts are held to equal
  totals per tree, every other structural field exactly.
- The dyadic construction (l2, two bins, labels +-1 with mean 0: every
  level and scale is exact) gives a byte-identical first tree.
- At the default 4 bins ties between candidates are common; the trees
  must be equal up to the first divergent node, and there the two
  packages' candidates must tie in exact arithmetic (the port breaks an
  exact tie by the lower index; the JAX package's f32 sums may not).
"""

from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lightgbm_tpu as lgb
from lightgbm_tpu.ops import histogram as JH
from lightgbm_tpu.ops import renew as JR
from lightgbm_tpu.ops import split as JS

import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch.model_text import load_model_from_string
from lightgbm_tpu_torch.ops import histogram as TH
from lightgbm_tpu_torch.ops import renew as TR
from lightgbm_tpu_torch.ops import split as TS
from lightgbm_tpu_torch.testing import AIRLINE_CATEGORICAL, airline_like
from lightgbm_tpu_torch.utils import threefry

from test_torch_train import _data
from test_torch_train_onehot import _onehot_data
from lightgbm_tpu_torch.testing import one_thread  # noqa: F401

ROUNDS = 4
BASE = {"num_leaves": 15, "min_data_in_leaf": 5, "verbose": -1,
        "tpu_tree_growth": "rounds", "max_bin": 63,
        "use_quantized_grad": True}
BINARY = {"objective": "binary", "metric": ["binary_logloss", "auc"]}
CONFIGS = {
    "fused_16_bagged": (dict(BASE, **BINARY, tpu_hist_method="fused",
                             num_grad_quant_bins=16, bagging_fraction=0.8,
                             bagging_freq=1), "numeric"),
    "fused_64_l2_renew": (dict(BASE, objective="regression", metric=["l2"],
                               tpu_hist_method="fused",
                               num_grad_quant_bins=64,
                               quant_train_renew_leaf=True), "numeric"),
    "staged_onehot_16": (dict(BASE, **BINARY, tpu_hist_method="pallas",
                              num_grad_quant_bins=16), "onehot"),
    "cat_fused_16": (dict(BASE, **BINARY, tpu_hist_method="fused",
                          num_grad_quant_bins=16, max_cat_threshold=3),
                     "categorical"),
    "fused_4": (dict(BASE, **BINARY, tpu_hist_method="fused"), "numeric"),
}
TREE_EXACT = ("split_feature", "threshold", "decision_type", "left_child",
              "right_child", "cat_boundaries", "cat_threshold")


def _dataset(kind, n, seed, objective):
    if kind == "numeric":
        return (*_data(seed, n, objective), [])
    if kind == "onehot":
        return (*_onehot_data(seed + 10, n, objective), [])
    X, y = airline_like(n, seed)
    return X, y, list(AIRLINE_CATEGORICAL)


def _train(name):
    params, kind = CONFIGS[name]
    X, y, cats = _dataset(kind, 2000, 1, params["objective"])
    Xv, yv, _ = _dataset(kind, 500, 2, params["objective"])
    ev_j, ev_t = {}, {}
    ds = lgb.Dataset(X, label=y, categorical_feature=cats)
    bj = lgb.train(dict(params), ds, ROUNDS,
                   valid_sets=[ds.create_valid(Xv, label=yv)],
                   evals_result=ev_j, verbose_eval=False)
    dt = lt.Dataset(X, label=y, device="cpu", categorical_feature=cats)
    bt = lt.train(dict(params), dt, ROUNDS,
                  valid_sets=[dt.create_valid(Xv, label=yv)],
                  evals_result=ev_t, verbose_eval=False)
    return {"jax": bj, "port": bt, "ev_j": ev_j, "ev_t": ev_t, "X": X,
            "y": y, "Xv": Xv, "cats": cats, "meta": dt.feature_meta()}


@pytest.fixture(scope="module")
def trained():
    torch.exp(torch.randn(1 << 20))      # see ROADMAP queue C (CPU exp)
    return {name: _train(name) for name in CONFIGS}


def _models(r):
    return (load_model_from_string(r["jax"].model_to_string())["models"],
            load_model_from_string(r["port"].model_to_string())["models"])


# ----------------------------------------------------------------------
# quantize_gradients and the integer family
# ----------------------------------------------------------------------

def _grads(n, seed, zero=False):
    rng = np.random.RandomState(seed)
    g = np.zeros(n, np.float32) if zero else rng.randn(n).astype(np.float32)
    h = (np.zeros(n, np.float32) if zero
         else (rng.rand(n) * 0.25).astype(np.float32))
    w = np.where(rng.rand(n) < 0.2, 0.0, rng.choice([1.0, 0.5, 2.0], n))
    return g, h, w.astype(np.float32)


@pytest.mark.parametrize("bins", [2, 4, 16, 64])
@pytest.mark.parametrize("stochastic", [True, False])
def test_quantize_gradients_bit_equal(bins, stochastic):
    g, h, w = _grads(1000, bins)
    jkey = jax.random.fold_in(jax.random.PRNGKey(6), 7)
    jq = JH.quantize_gradients(jnp.asarray(g), jnp.asarray(h),
                               jnp.asarray(w), bins, jkey,
                               stochastic=stochastic)
    tq = TH.quantize_gradients(torch.from_numpy(g), torch.from_numpy(h),
                               torch.from_numpy(w), bins,
                               threefry.fold_in(threefry.prng_key(6), 7),
                               stochastic=stochastic)
    for a, b in zip(jq[:2], tq[:2]):
        assert b.dtype == torch.int8
        assert np.array_equal(np.asarray(a), b.numpy())
    for a, b in zip(jq[2:], tq[2:]):
        assert np.float32(a).tobytes() == np.float32(b.item()).tobytes()
    assert (tq[0][torch.from_numpy(w) == 0] == 0).all()


def test_all_zero_gradients_take_the_floor():
    g, h, w = _grads(500, 1, zero=True)
    jq = JH.quantize_gradients(jnp.asarray(g), jnp.asarray(h),
                               jnp.asarray(w), 4, jax.random.PRNGKey(0))
    tq = TH.quantize_gradients(torch.from_numpy(g), torch.from_numpy(h),
                               torch.from_numpy(w), 4,
                               threefry.prng_key(0))
    assert float(tq[2]) == float(jq[2]) == float(np.float32(1e-30))
    assert not tq[0].any() and not tq[1].any()
    assert np.array_equal(np.asarray(jq[1]), tq[1].numpy())


def _levels(seed, n=3000, F=5, B=20):
    rng = np.random.RandomState(seed)
    binned = rng.randint(0, B, (F, n)).astype(np.uint8)
    gq = rng.randint(-7, 8, n).astype(np.int8)
    hq = rng.randint(0, 16, n).astype(np.int8)
    member = rng.rand(n) < 0.8
    slot = rng.randint(0, 5, n).astype(np.int32)
    return binned, gq, hq, member, slot, B


def test_integer_histograms_equal():
    binned, gq, hq, member, slot, B = _levels(3)
    j = JH.build_histogram_int(jnp.asarray(binned), jnp.asarray(gq),
                               jnp.asarray(hq), jnp.asarray(member), B)
    t = TH.build_histogram_int(*(torch.from_numpy(a) for a in
                                 (binned, gq, hq, member)), B)
    assert t.dtype == torch.int32 and t.shape == (2, 5, B)
    assert np.array_equal(np.asarray(j), t.numpy())
    j = JH.segment_histogram_int(jnp.asarray(binned), jnp.asarray(gq),
                                 jnp.asarray(hq), jnp.asarray(member),
                                 jnp.asarray(slot), 4, B)
    t = TH.segment_histogram_int(*(torch.from_numpy(a) for a in
                                   (binned, gq, hq, member, slot)), 4, B)
    assert t.dtype == torch.int32 and t.shape == (4, 2, 5, B)
    assert np.array_equal(np.asarray(j), t.numpy())
    sib = TH.subtract_histogram(t[0], t[1])
    assert sib.dtype == torch.int32
    assert np.array_equal(sib.numpy(), np.asarray(j)[0] - np.asarray(j)[1])


def test_quant_rescale_hist_bit_equal():
    binned, gq, hq, member, slot, B = _levels(4)
    seg = TH.segment_histogram_int(*(torch.from_numpy(a) for a in
                                     (binned, gq, hq, member, slot)), 4, B)
    cnt = np.array([410.0, 377.0, 0.0, 505.0], np.float32)
    gs, hs = np.float32(0.0371), np.float32(0.0123)
    j = np.asarray(JS.quant_rescale_hist(jnp.asarray(seg.numpy()), gs, hs,
                                         jnp.asarray(cnt)[:, None, None]
                                         [:, 0, 0]))
    t = TS.quant_rescale_hist(seg, gs, hs, torch.from_numpy(cnt)).numpy()
    assert t.shape == (4, 3, 5, B)
    for c in range(3):
        assert np.array_equal(j[:, c].view(np.int32), t[:, c].view(np.int32))
    # the count channel of quant_count_hist is the same integers
    c3 = TS.quant_count_hist(seg, torch.from_numpy(cnt))
    assert np.array_equal(c3[:, 2].numpy().astype(np.float32), t[:, 2])


def test_int32_guard():
    from lightgbm_tpu_torch.ops import fused
    n = TH.INT32_SAFE_ROWS + 1
    binned = torch.zeros((1, n), dtype=torch.uint8)
    with pytest.raises(ValueError, match="int32"):
        fused.accumulate(binned, torch.zeros((2, n), dtype=torch.int8),
                         torch.zeros(n, dtype=torch.int32), 1, 4)


def test_renew_sums_match():
    rng = np.random.RandomState(8)
    n, L = 2000, 7
    leaf = rng.randint(0, L, n).astype(np.int32)
    g, h = rng.randn(n).astype(np.float32), rng.rand(n).astype(np.float32)
    w = (rng.rand(n) < 0.8).astype(np.float32)
    js, jh = JR.quant_train_renew_leaf(*(jnp.asarray(a) for a in
                                         (leaf, g, h, w)), L)
    ts, th = TR.quant_train_renew_leaf(*(torch.from_numpy(a) for a in
                                         (leaf, g, h, w)), L)
    for t, j, v in ((ts, js, g), (th, jh, h)):
        vw = (v * w).astype(np.float64)
        # the JAX package's row-order f32 sum of m rows errs by at most
        # (m - 1) * 2**-24 * sum|x| (recursive summation; measured: 6.4e-6
        # on a grad leaf of 2.58, 5.3e-5 on a hess leaf of 116)
        m = np.bincount(leaf, minlength=L)
        bound = m * 2.0 ** -24 * np.bincount(leaf, weights=np.abs(vw),
                                             minlength=L)
        assert (np.abs(t.numpy() - np.asarray(j)) <= bound).all()
        # the port rounds the exact sum once
        exact = np.bincount(leaf, weights=vw, minlength=L)
        assert np.array_equal(t.numpy(), exact.astype(np.float32))


# ----------------------------------------------------------------------
# trained models against lightgbm_tpu.train
# ----------------------------------------------------------------------

def test_the_cases_cover_both_arms(trained):
    assert trained["staged_onehot_16"]["meta"].has_bundles
    assert trained["cat_fused_16"]["meta"].is_categorical.sum() == 6
    for r in trained.values():
        assert r["jax"].boosting._quant_on and r["port"].boosting._quant_on


@pytest.mark.parametrize("name", ["fused_16_bagged", "fused_64_l2_renew",
                                  "staged_onehot_16", "cat_fused_16"])
def test_trees_match(trained, name):
    r = trained[name]
    jms, tms = _models(r)
    assert len(jms) == len(tms) == ROUNDS
    for j, t in zip(jms, tms):
        assert j.num_leaves == t.num_leaves
        for f in TREE_EXACT:
            assert np.array_equal(getattr(j, f), getattr(t, f)), f
        if r["meta"].has_bundles:
            assert j.leaf_count.sum() == t.leaf_count.sum()
        else:
            assert np.array_equal(j.leaf_count, t.leaf_count)
        np.testing.assert_allclose(
            t.leaf_value, j.leaf_value, rtol=1e-5,
            atol=1e-5 * float(np.abs(j.leaf_value).max()))


@pytest.mark.parametrize("name", ["fused_16_bagged", "fused_64_l2_renew",
                                  "staged_onehot_16", "cat_fused_16"])
def test_predictions_and_metrics_match(trained, name):
    r = trained[name]
    np.testing.assert_allclose(r["port"].predict(r["Xv"]),
                               r["jax"].predict(r["Xv"]), rtol=1e-5,
                               atol=1e-6)
    for metric, vals in r["ev_j"]["valid_0"].items():
        np.testing.assert_allclose(r["ev_t"]["valid_0"][metric], vals,
                                   rtol=1e-4, atol=1e-6)


def _node_rows(tree, X, node):
    """Rows of ``X`` that reach internal node ``node``."""
    parent = {}
    for s in range(tree.num_leaves - 1):
        for side, child in ((True, tree.left_child[s]),
                            (False, tree.right_child[s])):
            if child >= 0:
                parent[int(child)] = (s, side)
    rows = np.ones(len(X), bool)
    while node in parent:
        s, side = parent[node]
        gl = tree._decide(X[:, tree.split_feature[s]].astype(np.float64), s)
        rows &= gl == side
        node = s
    return rows


def _exact_gain(G, H, gs, hs, l2):
    return Fraction(G) ** 2 * gs ** 2 / (Fraction(H) * hs + l2)


def test_default_bins_follow_the_tie_rule(trained):
    """4 bins: trees equal up to the first divergent node; there the two
    candidates tie in exact arithmetic on the iteration's levels."""
    r = trained["fused_4"]
    params = CONFIGS["fused_4"][0]
    jms, tms = _models(r)
    first = None
    for i, (j, t) in enumerate(zip(jms, tms)):
        for s in range(min(j.num_leaves, t.num_leaves) - 1):
            if any(getattr(j, f)[s] != getattr(t, f)[s] for f in
                   ("split_feature", "threshold", "decision_type",
                    "left_child", "right_child")):
                first = (i, s)
                break
        if first is not None:
            break
        assert j.num_leaves == t.num_leaves
        np.testing.assert_allclose(
            t.leaf_value, j.leaf_value, rtol=1e-5,
            atol=1e-5 * float(np.abs(j.leaf_value).max()))
    if first is None:
        return
    i, s = first
    X = r["X"]
    rows = _node_rows(tms[i], X, s)
    bst = lt.Booster(dict(params), train_set=lt.Dataset(X, label=r["y"],
                                                        device="cpu"))
    for _ in range(i):
        bst.update()
    gb = bst.boosting
    grad, hess = gb.objective.get_gradients(gb.train_score[0])
    qkey = threefry.fold_in(threefry.fold_in(gb._node_key(), 0x51475442), 0)
    gq, hq, gs, hs = TH.quantize_gradients(grad, hess, gb._bagging_mask(i),
                                           4, qkey)
    gq = gq.numpy().astype(np.int64)[rows]
    hq = hq.numpy().astype(np.int64)[rows]
    gains = []
    for tree in (jms[i], tms[i]):
        gl = tree._decide(X[rows, tree.split_feature[s]].astype(np.float64),
                          s)
        fgs, fhs = Fraction(float(gs)), Fraction(float(hs))
        gains.append(_exact_gain(gq[gl].sum(), hq[gl].sum(), fgs, fhs, 0)
                     + _exact_gain(gq[~gl].sum(), hq[~gl].sum(), fgs, fhs,
                                   0))
    assert gains[0] == gains[1]


def test_dyadic_first_tree_is_byte_identical():
    """l2, two bins, labels +-1 with mean 0: the levels are exactly
    -label and 1 at scales 1 and 1, so every sum, count and gain is exact
    in both packages."""
    rng = np.random.RandomState(1)
    X = rng.randn(2400, 5).astype(np.float32)
    y = np.where(X[:, 0] + 0.5 * rng.randn(2400) > 0, 1.0, -1.0)
    pos, neg = np.nonzero(y > 0)[0], np.nonzero(y < 0)[0]
    k = min(len(pos), len(neg))
    keep = np.sort(np.concatenate([pos[:k], neg[:k]]))
    X, y = X[keep], y[keep].astype(np.float32)
    params = dict(BASE, objective="regression", tpu_hist_method="fused",
                  num_grad_quant_bins=2)
    bj = lgb.train(dict(params), lgb.Dataset(X, label=y), 1)
    bt = lt.train(dict(params), lt.Dataset(X, label=y, device="cpu"), 1)

    def tree0(b):
        return b.model_to_string().split("Tree=0")[1].split("end of trees")[0]
    assert bt.num_trees() == 1 and tree0(bt).count("\n") > 10
    assert tree0(bt) == tree0(bj)


# ----------------------------------------------------------------------
# within the port
# ----------------------------------------------------------------------

def _port_text(params, X, y, rounds=3):
    bst = lt.train(dict(params), lt.Dataset(X, label=y, device="cpu"),
                   rounds)
    return "\n".join(ln for ln in bst.model_to_string().splitlines()
                     if not ln.startswith("[tpu_hist_method:"))


def test_fused_and_staged_arms_give_the_same_model():
    X, y = _data(4, 2000, "binary")
    params = dict(BASE, **BINARY)
    fused = _port_text(dict(params, tpu_hist_method="fused"), X, y)
    assert fused == _port_text(dict(params, tpu_hist_method="fused"), X, y)
    assert fused == _port_text(dict(params, tpu_hist_method="pallas"), X, y)
    assert "[tpu_hist_method:" not in fused


def test_zero_monotone_constraints_fall_back_to_f32():
    """The JAX package's blocker list: a monotone_constraints list, even
    all zeros, turns quantization off with a warning."""
    X, y = _data(4, 1000, "binary")
    params = dict(BASE, **BINARY, tpu_hist_method="fused")
    bst = lt.Booster(dict(params, monotone_constraints=[0] * 6),
                     train_set=lt.Dataset(X, label=y, device="cpu"))
    assert not bst.boosting._quant_on and not bst.boosting.grower_cfg.quant
    jb = lgb.Booster(dict(params, monotone_constraints=[0] * 6),
                     train_set=lgb.Dataset(X, label=y))
    assert not jb.boosting._quant_on


@pytest.mark.parametrize("params,blocker", [
    ({"monotone_constraints": [1, 0, 0, 0, 0, 0]}, "monotone_constraints"),
    ({"extra_trees": True}, "extra_trees"),
    ({"cegb_penalty_split": 1e-3, "tpu_tree_growth": "auto"}, "CEGB"),
], ids=["monotone", "extra_trees", "cegb"])
def test_quantized_blockers_fall_back_to_f32(params, blocker, monkeypatch):
    """Quantization with monotone constraints, extra trees or CEGB (on
    the serial grower) trains f32 histograms, with the JAX package's
    warning, once; the trees are the f32 run's.  Extra trees and CEGB
    also take ``tpu_hist_method=fused`` off the fused arm, and that
    warning (the JAX package's too) comes once beside it."""
    from lightgbm_tpu_torch.boosting import gbdt as tgbdt
    warnings = []
    monkeypatch.setattr(tgbdt, "log_warning", warnings.append)
    X, y = _data(5, 1000, "binary")
    p = {**BASE, **BINARY, "tpu_hist_method": "fused", **params}
    bt = lt.train(dict(p), lt.Dataset(X, label=y, device="cpu"), 2)
    assert not bt.boosting._quant_on and not bt.boosting.grower_cfg.quant
    fused_off = [w for w in warnings if "does not apply" in w]
    assert len(fused_off) == (0 if blocker == "monotone_constraints"
                              else 1)
    warnings = [w for w in warnings if w not in fused_off]
    assert len(warnings) == 1 and blocker in warnings[0]
    assert "falling back to f32" in warnings[0]
    jb = lgb.Booster(dict(p), train_set=lgb.Dataset(X, label=y))
    assert not jb.boosting._quant_on
    f32 = lt.train(dict(p, use_quantized_grad=False),
                   lt.Dataset(X, label=y, device="cpu"), 2)
    assert f32.model_to_string().partition("parameters:")[0] == \
        bt.model_to_string().partition("parameters:")[0]


@pytest.mark.parametrize("params", [{"tree_learner": "data"}])
def test_unported_combinations_raise(params):
    """Once refused as "sharded training": quantized data-parallel
    training on two thread ranks.  Each rank folds its index into the
    rounding key, so the trees are not the serial run's; they are the
    same on both ranks and on a second run, and the fit is the serial
    run's to 1e-2 in training logloss."""
    from lightgbm_tpu_torch.testing import thread_ranks
    X, y = _data(5, 300, "binary")
    p = {**BASE, **BINARY, **params}

    def run(rank, group):
        ev = {}
        ds = lt.Dataset(X, label=y, device="cpu")
        bst = lt.train(dict(p), ds, 3, valid_sets=[ds], evals_result=ev,
                       verbose_eval=False)
        assert bst.boosting._quant_on and bst.boosting.world == 2
        return bst.model_to_string(), ev["training"]["binary_logloss"][-1]
    first, second = thread_ranks(2, run), thread_ranks(2, run)
    assert first[0] == first[1] == second[0] == second[1]
    ev = {}
    ds = lt.Dataset(X, label=y, device="cpu")
    lt.train({**BASE, **BINARY}, ds, 3, valid_sets=[ds], evals_result=ev,
             verbose_eval=False)
    assert abs(first[0][1] - ev["training"]["binary_logloss"][-1]) < 1e-2
