"""The port's serial grower (``lightgbm_tpu_torch/grower.py``
``SerialGrower``/``grow_tree``) held against the JAX package's
``grow_tree`` (``hist_method="scatter"``, its staged arm on the CPU),
called directly on the same binned matrix, gradients, hessians and row
mask, all made with NumPy from a seed.

- Dyadic gradients (g = k/8, h in {1, k/4}) make every sum exact in both
  packages, so the tree arrays and each row's leaf are equal bit for
  bit: numeric data with NaN and zero missing values, EFB bundles, native
  categorical features, quantized gradients with
  and without leaf renewal, ``max_depth`` with ``min_data_in_leaf`` and
  a bagging mask, CEGB and a forced plan.
- Random f32 gradients and per-node randomness (``extra_trees`` with
  ``feature_fraction_bynode``, threefry keys bit-equal to JAX's) keep
  the structure equal; values agree to rtol=3e-5 (the JAX package sums
  f32 in its order, the port exactly: ROADMAP queue C, C-3).  So do
  monotone constraints on dyadic data, whose gains the JAX package
  takes in a fused XLA program a few ulps off (C-10).
- The port's fused arm (B2 with one slot) grows the staged arm's tree.

Then the six tests of tests/test_split_and_grower.py on the port, and
the port's serial grower against its rounds grower on the cases of
tests/test_rounds.py (``test_rounds_equals_serial*``): both sum exactly,
so every array is equal, where the JAX package holds its two growers
only to f32 order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightgbm_tpu.dataset import FeatureMeta as JMeta
from lightgbm_tpu.grower import GrowerConfig as JConfig
from lightgbm_tpu.grower import grow_tree as jgrow
from lightgbm_tpu.ops.split import SplitHyperparams as JHP

import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch.dataset import FeatureMeta as TMeta
from lightgbm_tpu_torch.grower import GrowerConfig as TConfig
from lightgbm_tpu_torch.grower import (SerialGrower,
                                       predict_leaf_index_binned,
                                       predict_tree_binned)
from lightgbm_tpu_torch.grower import grow_tree as tgrow
from lightgbm_tpu_torch.grower_rounds import grow_tree_rounds
from lightgbm_tpu_torch.ops.histogram import (_vals_t, fixed_point_scales,
                                              histogram_fixed)
from lightgbm_tpu_torch.ops.split import SplitHyperparams as THP
from lightgbm_tpu_torch.ops.split import best_split_for_leaf
from lightgbm_tpu_torch.testing import AIRLINE_CATEGORICAL, airline_like
from lightgbm_tpu_torch.testing import one_thread  # noqa: F401
from lightgbm_tpu_torch.utils import threefry

N, F, B, LEAVES = 2000, 6, 32, 15
STRUCTURE = ("split_feature", "threshold_bin", "default_left",
             "is_categorical", "left_child", "right_child", "leaf_parent",
             "leaf_depth")
VALUES = ("split_gain", "internal_value", "internal_weight", "internal_count",
          "leaf_value", "leaf_weight", "leaf_count")

CASES = {
    "missing": dict(seed=5, missing=(0, 2, 1, 0, 2, 1)),
    "random": dict(seed=4, dyadic=False),
    "depth_min_data_bagged": dict(seed=6, missing=(2, 0, 1, 2, 0, 1),
                                  bag=0.7, max_depth=3,
                                  hp=dict(min_data_in_leaf=40)),
    # the monotone gain of a fused XLA program is ulps off the op-by-op
    # one (ROADMAP queue C, C-10): structure exact, values to rtol
    "monotone": dict(seed=7, mc=(1, 0, -1, 0, 0, 1), exact=False),
    "rand": dict(seed=8, dyadic=False, rng=42,
                 hp=dict(extra_trees=True), bynode=3),
    "quantized": dict(seed=9, quant=True),
    "quantized_renew": dict(seed=10, quant=True, renew=True),
    "cegb": dict(seed=11, cfg=dict(cegb_penalty_split=2e-3,
                                   cegb_coupled=True, cegb_lazy=True)),
    "forced": dict(seed=12, missing=(0, 2, 1, 0, 2, 1),
                   forced=((0, 1, 0), (2, 0, 3), (20, 10, 5))),
    "forced_parity": dict(seed=12, forced=((0, 1), (2, 0), (20, 10)),
                          cfg=dict(forced_exact_parity=True)),
}
EXACT = [c for c in CASES
         if CASES[c].get("exact", CASES[c].get("dyadic", True))]


def _meta(missing, mod):
    nb = np.full(F, B, np.int32)
    nb[5] = 9
    db = np.where(np.asarray(missing) == 1, 3, 0).astype(np.int32)
    return mod(num_bin=nb, missing_type=np.asarray(missing, np.int32),
               default_bin=db, most_freq_bin=np.zeros(F, np.int32),
               is_categorical=np.zeros(F, bool), max_num_bin=B)


def _inputs(seed, dyadic=True, bag=None):
    rng = np.random.RandomState(seed)
    binned = np.stack([rng.randint(0, 9 if f == 5 else B, N)
                       for f in range(F)]).astype(np.uint8)
    y = (np.sin(binned[0] * 0.3) + 0.2 * binned[1] - 0.1 * binned[3]
         + (binned[2] > 20) * 1.5 + rng.randn(N) * 0.3)
    if dyadic:
        grad = np.round(-y * 8) / 8
        hess = np.where(rng.rand(N) < 0.5, 1.0, rng.randint(1, 9, N) / 4.0)
    else:
        grad, hess = -y, 0.5 + rng.rand(N)
    mask = np.ones(N)
    if bag is not None:
        mask = (rng.rand(N) < bag).astype(np.float64)
    return (binned, grad.astype(np.float32), hess.astype(np.float32),
            mask.astype(np.float32))


def _quant_vals(grad, hess, mask, seed):
    """int8 levels and power-of-two scales, the same for both packages."""
    rng = np.random.RandomState(seed)
    gq = np.clip(np.round(grad * 2), -8, 8).astype(np.int8)
    hq = rng.randint(1, 5, N).astype(np.int8)
    return gq * (mask > 0), hq * (mask > 0), 0.5, 0.25


def _pair_kwargs(c, mod):
    """The JAX (``mod`` jnp) or port (``mod`` torch) keyword arguments of
    a case."""
    kw = {}
    if c.get("mc") is not None:
        kw["monotone_constraints"] = (jnp.asarray(c["mc"], jnp.int32)
                                      if mod is jnp else
                                      torch.tensor(c["mc"], dtype=torch.int32))
    if c.get("rng") is not None:
        kw["rng_key"] = (jax.random.PRNGKey(c["rng"]) if mod is jnp
                         else threefry.prng_key(c["rng"]))
    cfg = c.get("cfg", {})
    if cfg.get("cegb_coupled"):
        kw["cegb_coupled_penalty"] = np.asarray(
            [3.0, 0.5, 2.0, 0.1, 1.0, 4.0], np.float32)
        kw["cegb_lazy_penalty"] = np.asarray(
            [1e-3, 2e-3, 5e-4, 1e-3, 3e-3, 1e-4], np.float32)
        if mod is jnp:
            kw = {k: jnp.asarray(v) if k.startswith("cegb") else v
                  for k, v in kw.items()}
    if c.get("forced") is not None:
        kw["forced_plan"] = tuple(np.asarray(a, np.int32)
                                  for a in c["forced"])
    return kw


def _grow(case):
    c = CASES[case]
    binned, grad, hess, mask = _inputs(c["seed"], c.get("dyadic", True),
                                       c.get("bag"))
    missing = c.get("missing", (0,) * F)
    common = dict(num_leaves=LEAVES, max_depth=c.get("max_depth", -1),
                  num_bins=B, bynode_feature_cnt=c.get("bynode", 0),
                  quant=c.get("quant", False),
                  quant_renew=c.get("renew", False),
                  n_forced=len(c["forced"][0]) if c.get("forced") else 0,
                  **c.get("cfg", {}))
    hp = {"min_data_in_leaf": 5, "lambda_l2": 1.0, **c.get("hp", {})}
    jq = tq = None
    if c.get("quant"):
        gq, hq, gs, hs = _quant_vals(grad, hess, mask, c["seed"])
        jq = (jnp.asarray(gq), jnp.asarray(hq), jnp.float32(gs),
              jnp.float32(hs))
        tq = (torch.from_numpy(gq), torch.from_numpy(hq),
              torch.tensor(gs), torch.tensor(hs))
    jout = jgrow(jnp.asarray(binned), jnp.asarray(grad), jnp.asarray(hess),
                 jnp.asarray(mask), _meta(missing, JMeta),
                 JConfig(hp=JHP(**hp), hist_method="scatter", **common),
                 quant_vals=jq, **_pair_kwargs(c, jnp))
    tout = tgrow(torch.from_numpy(binned), torch.from_numpy(grad),
                 torch.from_numpy(hess), torch.from_numpy(mask),
                 _meta(missing, TMeta), TConfig(hp=THP(**hp), **common),
                 quant_vals=tq, **_pair_kwargs(c, torch))
    return jout, tout


@pytest.fixture(scope="module")
def grown():
    assert threefry.PARTITIONABLE == jax.config.jax_threefry_partitionable
    return {case: _grow(case) for case in CASES}


def _check(jt, jl, tt, tl, exact):
    tt = tt.to_numpy()
    assert int(jt.num_leaves) == tt["num_leaves"]
    for name in STRUCTURE:
        assert np.array_equal(np.asarray(getattr(jt, name)), tt[name]), name
    assert np.array_equal(np.asarray(jl), tl.numpy())
    if exact:
        for name in VALUES:
            assert np.array_equal(np.asarray(getattr(jt, name)),
                                  tt[name]), name
    else:
        for name in VALUES:
            np.testing.assert_allclose(tt[name], np.asarray(getattr(jt, name)),
                                       rtol=3e-5, atol=1e-6, err_msg=name)
    return tt


@pytest.mark.parametrize("case", list(CASES))
def test_serial_tree_matches_the_jax_package(grown, case):
    (jt, jl, *jst), (tt, tl, *tst) = grown[case]
    t = _check(jt, jl, tt, tl, case in EXACT)
    assert t["num_leaves"] > 4
    if case == "depth_min_data_bagged":
        assert t["leaf_depth"][:t["num_leaves"]].max() <= 3
        assert (t["leaf_count"][:t["num_leaves"]] >= 40).all()
    if jst:       # CEGB: the state after the tree
        for a, b in zip(jst[0], tst[0]):
            assert np.array_equal(np.asarray(a), b.numpy())


def test_forced_plan_heads_the_tree(grown):
    _, (tt, _) = grown["forced"]
    feats, thrs = CASES["forced"]["forced"][1:]
    assert tt.split_feature[:3].tolist() == list(feats)
    assert tt.threshold_bin[:3].tolist() == list(thrs)


def _dataset_case(onehot: bool, quant: bool = False):
    """A tree on airline rows (EFB bundles of one-hot columns, or native
    categorical columns) from dyadic gradients in both packages."""
    import lightgbm_tpu as lgb
    from test_torch_categorical import _onehot_cat
    X, _ = airline_like(3000, 4)
    if onehot:
        X, cats = _onehot_cat(X)
    else:
        cats = list(AIRLINE_CATEGORICAL)
    params = {"max_bin": 63, "min_data_in_leaf": 5, "verbose": -1}
    td = lt.Dataset(X, device="cpu", params=params,
                    categorical_feature=cats).construct()
    jd = lgb.Dataset(X, params=params, categorical_feature=cats).construct()
    meta_t, meta_j = td.feature_meta(), jd.feature_meta()
    assert meta_t.has_bundles == onehot
    binned = td.host_binned().T.copy()
    rng = np.random.RandomState(5)
    n = X.shape[0]
    grad = (rng.randint(-64, 65, n) / 8.0).astype(np.float32)
    hess = np.where(rng.rand(n) < 0.5, 1.0,
                    rng.randint(1, 9, n) / 4.0).astype(np.float32)
    mask = (rng.rand(n) < 0.9).astype(np.float32)
    hp = dict(min_data_in_leaf=5, lambda_l2=1.0, max_cat_threshold=3,
              min_data_per_group=20)
    Bm = int(meta_t.max_num_bin)
    jt, jl = jgrow(jnp.asarray(binned), jnp.asarray(grad), jnp.asarray(hess),
                   jnp.asarray(mask), meta_j,
                   JConfig(num_leaves=LEAVES, hp=JHP(**hp), num_bins=Bm,
                           hist_method="scatter"))
    tt, tl = tgrow(td.binned_t, torch.from_numpy(grad),
                   torch.from_numpy(hess), torch.from_numpy(mask), meta_t,
                   TConfig(num_leaves=LEAVES, hp=THP(**hp), num_bins=Bm))
    return jt, jl, tt, tl


@pytest.mark.parametrize("onehot", [True, False], ids=["efb", "categorical"])
def test_bundled_and_categorical_trees_match(onehot):
    jt, jl, tt, tl = _dataset_case(onehot)
    t = _check(jt, jl, tt, tl, exact=True)
    nn = t["num_leaves"] - 1
    if not onehot:
        cat = t["is_categorical"][:nn]
        assert cat.any()
        assert np.array_equal(np.asarray(jt.cat_bitset)[:nn][cat],
                              t["cat_bitset"][:nn][cat])


def test_fused_arm_grows_the_staged_tree():
    """``hist_method="fused"`` elects B2 with one slot a split, and grows
    the staged arm's tree (both exact)."""
    binned, grad, hess, mask = _inputs(13, bag=0.8)
    args = (torch.from_numpy(binned), torch.from_numpy(grad),
            torch.from_numpy(hess), torch.from_numpy(mask))
    trees = {}
    for method in ("fused", "auto"):
        g = SerialGrower(args[0], _meta((0, 2, 1, 0, 2, 1), TMeta),
                         TConfig(num_leaves=LEAVES, num_bins=B,
                                 hist_method=method,
                                 hp=THP(min_data_in_leaf=5)))
        assert g.fused_arm == (method == "fused")
        tree, leaf = g.grow(*args[1:])
        trees[method] = (tree.to_numpy(), leaf.numpy())
        assert len(g.host_reads) == 1
        assert g.host_reads[0] == 1 + g.steps[0] + (g.steps[0] < LEAVES - 1)
    (a, la), (b, lb) = trees.values()
    assert a["num_leaves"] == LEAVES
    for name in STRUCTURE + VALUES:
        assert np.array_equal(a[name], b[name]), name
    assert np.array_equal(la, lb)


# ----------------------------------------------------------------------
# tests/test_split_and_grower.py on the port
# ----------------------------------------------------------------------

def _plain_meta(num_bins, nf):
    return TMeta(num_bin=np.full(nf, num_bins, np.int32),
                 missing_type=np.zeros(nf, np.int32),
                 default_bin=np.zeros(nf, np.int32),
                 most_freq_bin=np.zeros(nf, np.int32),
                 is_categorical=np.zeros(nf, bool), max_num_bin=num_bins)


def _brute_force_best_split(binned, grad, hess, hp):
    n, nf = binned.shape
    G, H = grad.sum(), hess.sum()
    best = (-np.inf, -1, -1)
    for f in range(nf):
        for t in range(binned[:, f].max()):
            left = binned[:, f] <= t
            gl, hl = grad[left].sum(), hess[left].sum()
            gr, hr = G - gl, H - hl
            nl, nr = left.sum(), n - left.sum()
            if nl < hp.min_data_in_leaf or nr < hp.min_data_in_leaf:
                continue
            if (hl < hp.min_sum_hessian_in_leaf
                    or hr < hp.min_sum_hessian_in_leaf):
                continue
            gain = (gl * gl / (hl + hp.lambda_l2 + 1e-15)
                    + gr * gr / (hr + hp.lambda_l2 + 1e-15))
            if gain > best[0] + 1e-9:
                best = (gain, f, t)
    return best


def _grow_plain(seed, n, nf, nb, leaves, hp, max_depth=-1):
    rng = np.random.RandomState(seed)
    binned = rng.randint(0, nb, size=(n, nf)).astype(np.uint8)
    grad = rng.randn(n).astype(np.float32)
    if seed == 2:
        grad = (grad + binned[:, 0] / nb).astype(np.float32)
    hess = np.ones(n, np.float32)
    bt = torch.from_numpy(binned.T.copy())
    tree, leaf_id = tgrow(bt, torch.from_numpy(grad), torch.from_numpy(hess),
                          torch.ones(n), _plain_meta(nb, nf),
                          TConfig(num_leaves=leaves, max_depth=max_depth,
                                  hp=hp, num_bins=nb))
    return binned, bt, grad, hess, tree, leaf_id


def test_best_split_matches_brute_force():
    rng = np.random.RandomState(0)
    n, nf, nb = 800, 5, 16
    binned = rng.randint(0, nb, size=(n, nf)).astype(np.uint8)
    grad = (rng.randn(n) + 0.3 * (binned[:, 2] > 7)).astype(np.float32)
    hess = np.ones(n, np.float32)
    hp = THP(min_data_in_leaf=20, min_sum_hessian_in_leaf=1e-3)
    vals = _vals_t(torch.from_numpy(grad), torch.from_numpy(hess),
                   torch.ones(n))
    scales = fixed_point_scales(vals)
    hist = histogram_fixed(torch.from_numpy(binned.T.copy()), vals, nb,
                           scales)
    meta = _plain_meta(nb, nf).tensors("cpu")
    r = best_split_for_leaf(
        hist[None], scales, torch.tensor([grad.sum()]),
        torch.tensor([float(n)]), torch.tensor([float(n)]), meta["num_bin"],
        meta["missing_type"], meta["default_bin"],
        torch.zeros(nf, dtype=torch.bool), hp)
    bf_gain, bf_f, bf_t = _brute_force_best_split(
        binned, grad.astype(np.float64), hess.astype(np.float64), hp)
    assert int(r.feature[0]) == bf_f
    assert int(r.threshold[0]) == bf_t
    parent_gain = grad.sum() ** 2 / (hess.sum() + 2e-15)
    np.testing.assert_allclose(float(r.gain[0]), bf_gain - parent_gain,
                               rtol=1e-3)


def test_min_data_in_leaf_enforced():
    *_, tree, _ = _grow_plain(1, 100, 3, 8, 31, THP(min_data_in_leaf=30))
    nl = int(tree.num_leaves)
    assert (tree.leaf_count[:nl].numpy() >= 30).all()


def test_grower_leaf_ids_match_traversal():
    binned, bt, _, _, tree, leaf_id = _grow_plain(
        2, 600, 6, 32, 15, THP(min_data_in_leaf=5))
    routed = predict_leaf_index_binned(tree, bt,
                                       _plain_meta(32, 6).tensors("cpu"))
    assert np.array_equal(leaf_id.numpy(), routed.numpy())


def test_leaf_values_are_newton_steps():
    lam = 0.5
    _, _, grad, hess, tree, leaf_id = _grow_plain(
        3, 500, 4, 16, 8, THP(min_data_in_leaf=10, lambda_l2=lam))
    lid = leaf_id.numpy()
    for leaf in range(int(tree.num_leaves)):
        rows = lid == leaf
        if rows.sum() == 0:
            continue
        expect = -grad[rows].sum() / (hess[rows].sum() + lam)
        np.testing.assert_allclose(float(tree.leaf_value[leaf]), expect,
                                   rtol=2e-3, atol=2e-4)


def test_max_depth_limit():
    *_, tree, _ = _grow_plain(4, 500, 5, 16, 31, THP(min_data_in_leaf=1),
                              max_depth=2)
    nl = int(tree.num_leaves)
    assert nl <= 4
    assert int(tree.leaf_depth[:nl].max()) <= 2


def test_predict_tree_binned_values():
    _, bt, _, _, tree, leaf_id = _grow_plain(
        5, 300, 3, 8, 6, THP(min_data_in_leaf=10))
    vals = predict_tree_binned(tree, bt, _plain_meta(8, 3).tensors("cpu"))
    np.testing.assert_allclose(vals.numpy(),
                               tree.leaf_value[leaf_id].numpy(), rtol=1e-6)


# ----------------------------------------------------------------------
# the port's serial grower against its rounds grower (tests/test_rounds.py)
# ----------------------------------------------------------------------

def _problem():
    rng = np.random.RandomState(7)
    n, nf, nb = 4096, 10, 32
    binned = rng.randint(0, nb, size=(n, nf)).astype(np.uint8)
    grad = (rng.randn(n) + 0.7 * (binned[:, 1] > 16)
            - 0.4 * (binned[:, 3] < 5)).astype(np.float32)
    return binned, grad, np.ones(n, np.float32), nb, nf


def _xor():
    rng = np.random.RandomState(0)
    n, nf, nb = 4096, 6, 16
    binned = rng.randint(0, nb, size=(n, nf)).astype(np.uint8)
    a, b = binned[:, 0] >= 8, binned[:, 1] >= 8
    grad = (np.where(a ^ b, 1.0, -1.0) + 0.01 * rng.randn(n)
            ).astype(np.float32)
    return binned, grad, np.ones(n, np.float32), nb, nf


ROUNDS_CASES = {
    **{f"leaves{k}": dict(leaves=k) for k in (2, 7, 31, 64)},
    "bagging_and_depth": dict(leaves=31, max_depth=4, bag=True,
                              hp=dict(min_data_in_leaf=40)),
    "monotone": dict(leaves=31, mc=True),
    **{f"xor{k}": dict(leaves=k, xor=True) for k in (4, 9, 31)},
    "extra_trees_bynode": dict(leaves=31, rand=True),
}


@pytest.mark.parametrize("case", list(ROUNDS_CASES))
def test_serial_equals_rounds(case):
    c = ROUNDS_CASES[case]
    binned, grad, hess, nb, nf = _xor() if c.get("xor") else _problem()
    mask = np.ones(len(grad), np.float32)
    if c.get("bag"):
        rng = np.random.RandomState(3)
        mask = (rng.rand(len(grad)) < 0.7).astype(np.float32) * 2.0
    cfg = TConfig(num_leaves=c["leaves"], max_depth=c.get("max_depth", -1),
                  num_bins=nb, hp=THP(extra_trees=c.get("rand", False),
                                      **c.get("hp", {})),
                  bynode_feature_cnt=5 if c.get("rand") else 0)
    kw = {}
    if c.get("mc"):
        mc = np.zeros(nf, np.int32)
        mc[1], mc[3] = 1, -1
        kw["monotone_constraints"] = torch.from_numpy(mc)
    if c.get("rand"):
        kw["rng_key"] = threefry.prng_key(42)
    args = (torch.from_numpy(binned.T.copy()), torch.from_numpy(grad),
            torch.from_numpy(hess), torch.from_numpy(mask),
            _plain_meta(nb, nf), cfg)
    ts, ls = tgrow(*args, **kw)
    tr, lr = grow_tree_rounds(*args, **kw)
    a, b = ts.to_numpy(), tr.to_numpy()
    assert a["num_leaves"] == int(b["num_leaves"])
    for name in STRUCTURE + VALUES + ("cat_bitset",):
        assert np.array_equal(a[name], b[name]), name
    assert np.array_equal(ls.numpy(), lr.numpy())


def test_serial_equals_rounds_model_text():
    """Trained through ``lt.train``: ``tpu_tree_growth="serial"`` and
    ``"rounds"`` give the same model text, byte for byte, on categorical
    data (test_rounds.py's categorical case)."""
    rng = np.random.RandomState(9)
    n = 2000
    cat1, cat2 = rng.randint(0, 12, n), rng.randint(0, 5, n)
    X = np.column_stack([rng.rand(n, 4), cat1, cat2]).astype(np.float32)
    eff = rng.randn(12)
    y = ((X[:, 0] + eff[cat1] + 0.3 * (cat2 == 2) + 0.15 * rng.randn(n))
         > 0.5).astype(np.float32)
    texts = {}
    for mode in ("serial", "rounds"):
        params = {"objective": "binary", "num_leaves": 15, "max_bin": 32,
                  "verbose": -1, "tpu_tree_growth": mode,
                  "min_data_per_group": 10, "cat_smooth": 5.0}
        bst = lt.train(params, lt.Dataset(X, label=y, device="cpu",
                                          categorical_feature=[4, 5]), 4,
                       verbose_eval=False)
        texts[mode] = bst.model_to_string().partition("parameters:")[0]
        assert type(bst.boosting.grower).__name__ == (
            "SerialGrower" if mode == "serial" else "RoundGrower")
    assert "num_cat=0" not in texts["serial"]
    assert texts["serial"] == texts["rounds"]


def test_c20_the_jax_serial_grower_breaks_an_exact_tie_otherwise():
    """ROADMAP queue C, C-20: on tests/test_torch_train.py's binary data
    the first tree's ninth split ties exactly between features 1 and 3
    (the same gain, 3.2679749).  The port's growers and the JAX
    package's rounds grower take the smaller feature; the JAX package's
    serial grower, whose f32 sums run in another order, takes 3."""
    import lightgbm_tpu as lgb
    from test_torch_train import BASE as TRAIN_BASE
    from test_torch_train import _data as train_data
    X, y = train_data(5, 300, "binary")
    got = {}
    for growth in ("serial", "rounds"):
        p = {**TRAIN_BASE, "objective": "binary", "tpu_tree_growth": growth}
        bt = lt.train(dict(p), lt.Dataset(X, label=y, device="cpu"), 1,
                      verbose_eval=False)
        bj = lgb.train(dict(p), lgb.Dataset(X, label=y), 1,
                       verbose_eval=False)
        for name, b in (("port", bt), ("jax", bj)):
            m = b.boosting.models[0]
            got[(name, growth)] = (int(m.split_feature[8]),
                                   np.float32(m.split_gain[8]))
    assert got[("port", "serial")][0] == got[("port", "rounds")][0] == 1
    assert got[("jax", "rounds")][0] == 1
    assert got[("jax", "serial")][0] == 3
    assert len({g for _, g in got.values()}) == 1


@pytest.mark.parametrize("case", ["missing", "quantized", "cegb", "forced",
                                  "monotone", "rand", "fused", "efb",
                                  "categorical"])
def test_a_split_step_reads_nothing_on_the_host(case, monkeypatch):
    """Every split step runs under tests/test_torch_round_device.py's
    ``NoHostRead`` guard (no device value copied to the host, no
    boolean-mask indexing, no tensor made from host data): the loop's
    stop test, read between steps, is the only host read of a split."""
    from test_torch_round_device import NoHostRead
    step = SerialGrower._step
    steps = []

    def guarded(self, section):
        with NoHostRead():
            step(self, section)
        steps.append(1)
    monkeypatch.setattr(SerialGrower, "_step", guarded)
    if case in ("efb", "categorical"):
        _dataset_case(case == "efb")
    elif case == "fused":
        binned, grad, hess, mask = _inputs(13, bag=0.8)
        g = SerialGrower(torch.from_numpy(binned),
                         _meta((0, 2, 1, 0, 2, 1), TMeta),
                         TConfig(num_leaves=LEAVES, num_bins=B,
                                 hist_method="fused",
                                 hp=THP(min_data_in_leaf=5)))
        assert g.fused_arm
        g.grow(torch.from_numpy(grad), torch.from_numpy(hess),
               torch.from_numpy(mask))
    else:
        _grow(case)
    assert len(steps) >= LEAVES - 1
