"""Training on categorical data with ``lightgbm_tpu_torch`` on the CPU
(the kernels' plain versions), held against ``lightgbm_tpu.train`` with
the rounds grower: native ``categorical_feature`` on the fused arm
(``tpu_hist_method="fused"``) and on the staged arm (``"pallas"``), and
one-hot columns that EFB bundles next to native categorical ones (the
staged arm).  Data: ``testing.airline_like`` rows (the airline on-time
schema, Zipf-skewed airports).

Bars, as in tests/test_torch_train.py: tree structure equal (split
features, thresholds, decision types, children, leaf counts, and the
categorical bitsets ``cat_boundaries``/``cat_threshold``); leaf values,
predictions and metrics to rtol=1e-4; the port's model text loads in
``lightgbm_tpu.Booster`` and predicts the same.

The exact-structure cases set ``max_cat_threshold=3``, so no feature can
reach one category partition from both ends of the sorted scan (each
many-vs-many feature here has more than 6 usable categories).  Where
both ends reach the same partition, with its sides swapped, the two
gains are equal but for f32 rounding, and the JAX package's f32 sums and
the port's exact ones break that tie differently (ROADMAP queue C).  The
``default_threshold`` case (``max_cat_threshold=32``) is held to that:
every tree splits the training rows into the same leaves, and
predictions and metrics agree.

Grower-level cases grow one tree from dyadic gradients (every sum exact
in both packages) on a dataset with EFB bundles and categorical features
and compare every array of the tree, bitsets included, bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lightgbm_tpu as lgb
from lightgbm_tpu.grower import GrowerConfig as JConfig
from lightgbm_tpu.grower import row_goes_left as j_goes_left
from lightgbm_tpu.grower_rounds import grow_tree_rounds as jgrow
from lightgbm_tpu.ops.split import SplitHyperparams as JHP

import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch.grower import GrowerConfig as TConfig
from lightgbm_tpu_torch.grower import row_goes_left as t_goes_left
from lightgbm_tpu_torch.grower_rounds import grow_tree_rounds as tgrow
from lightgbm_tpu_torch.model_text import load_model_from_string
from lightgbm_tpu_torch.ops.split import SplitHyperparams as THP
from lightgbm_tpu_torch.testing import (AIRLINE_CATEGORICAL, airline_like,
                                        one_hot)
from lightgbm_tpu_torch.testing import one_thread  # noqa: F401

ROUNDS = 4
BASE = {"objective": "binary", "num_leaves": 15, "min_data_in_leaf": 5,
        "verbose": -1, "tpu_tree_growth": "rounds", "max_bin": 63,
        "metric": ["binary_logloss", "auc"], "max_cat_threshold": 3}
CONFIGS = {
    "cat_fused": dict(BASE, tpu_hist_method="fused"),
    "cat_staged": dict(BASE, tpu_hist_method="pallas"),
    "onehot_cat": dict(BASE, tpu_hist_method="pallas"),
    "default_threshold": dict(BASE, tpu_hist_method="fused",
                              max_cat_threshold=32),
}
EXACT = ("cat_fused", "cat_staged", "onehot_cat")
TREE_EXACT = ("split_feature", "threshold", "decision_type", "left_child",
              "right_child", "leaf_count", "cat_boundaries", "cat_threshold")
# onehot_cat: Month, DayOfWeek and UniqueCarrier one-hot (they bundle);
# DayofMonth, Origin and Dest native categorical
ONEHOT_COLS = (0, 2, 4)


def _onehot_cat(X):
    """One-hot blocks of ``ONEHOT_COLS`` followed by the other columns;
    returns (matrix, categorical column indices)."""
    blocks, cats = [], []
    for j in ONEHOT_COLS:
        codes = X[:, j].astype(np.int64)
        lo = codes.min()
        blk = np.zeros((len(X), int(codes.max() - lo) + 1), np.float32)
        blk[np.arange(len(X)), codes - lo] = 1.0
        blocks.append(blk)
    width = sum(b.shape[1] for b in blocks)
    rest = [j for j in range(X.shape[1]) if j not in ONEHOT_COLS]
    for i, j in enumerate(rest):
        if j in AIRLINE_CATEGORICAL:
            cats.append(width + i)
    return np.concatenate(blocks + [X[:, rest]], axis=1), cats


def _data(name, n, seed):
    X, y = airline_like(n, seed)
    if name == "onehot_cat":
        return (*_onehot_cat(X), y)
    return X, list(AIRLINE_CATEGORICAL), y


def _train(name):
    params = CONFIGS[name]
    X, cats, y = _data(name, 2000, 1)
    Xv, _, yv = _data(name, 500, 2)
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
            "Xv": Xv, "meta": dt.feature_meta()}


@pytest.fixture(scope="module")
def trained():
    torch.exp(torch.randn(1 << 20))      # see ROADMAP queue C (CPU exp)
    return {name: _train(name) for name in CONFIGS}


def test_the_cases_cover_both_arms_and_bundles(trained):
    assert not trained["cat_fused"]["meta"].has_bundles
    assert trained["onehot_cat"]["meta"].has_bundles
    for name in CONFIGS:
        assert trained[name]["meta"].is_categorical.any()
        models = load_model_from_string(
            trained[name]["port"].model_to_string())["models"]
        assert sum(int((m.decision_type & 1).sum()) for m in models) > 0


@pytest.mark.parametrize("name", EXACT)
def test_model_text_trees_match(trained, name):
    r = trained[name]
    jm = load_model_from_string(r["jax"].model_to_string())
    tm = load_model_from_string(r["port"].model_to_string())
    assert jm["feature_infos"] == tm["feature_infos"]
    assert len(jm["models"]) == len(tm["models"]) == ROUNDS
    for j, t in zip(jm["models"], tm["models"]):
        assert j.num_leaves == t.num_leaves
        for f in TREE_EXACT:
            assert np.array_equal(getattr(j, f), getattr(t, f)), f
        np.testing.assert_allclose(t.leaf_value, j.leaf_value, rtol=1e-4,
                                   atol=1e-6)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_predictions_and_metrics_match(trained, name):
    r = trained[name]
    Xv = r["Xv"]
    want = r["jax"].predict(Xv)
    np.testing.assert_allclose(r["port"].predict(Xv), want, rtol=1e-4,
                               atol=1e-6)
    np.testing.assert_allclose(r["port"].predict(Xv, device=False), want,
                               rtol=1e-4, atol=1e-6)
    for data, metrics in r["ev_j"].items():
        for metric, vals in metrics.items():
            np.testing.assert_allclose(r["ev_t"][data][metric], vals,
                                       rtol=1e-4)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_port_model_text_loads_in_the_jax_package(trained, name):
    r = trained[name]
    loaded = lgb.Booster(model_str=r["port"].model_to_string())
    np.testing.assert_allclose(
        loaded.predict(r["Xv"], raw_score=True),
        r["port"].predict(r["Xv"], raw_score=True, device=False),
        rtol=1e-6, atol=1e-7)


def _leaf_partition(tree, X):
    leaves = tree.predict_leaf_np(X.astype(np.float64))
    return {tuple(np.nonzero(leaves == v)[0]) for v in np.unique(leaves)}


def test_default_threshold_same_leaves(trained):
    """At ``max_cat_threshold=32`` a categorical split may keep its
    categories on the other side (the tie of the two scan ends): each
    tree still splits the training rows into the same leaves."""
    r = trained["default_threshold"]
    jm = load_model_from_string(r["jax"].model_to_string())["models"]
    tm = load_model_from_string(r["port"].model_to_string())["models"]
    for j, t in zip(jm, tm):
        assert j.num_leaves == t.num_leaves
        assert np.array_equal(j.split_feature, t.split_feature)
        assert np.array_equal(j.internal_count, t.internal_count)
        assert _leaf_partition(j, r["X"]) == _leaf_partition(t, r["X"])


def test_bin_mappers_match_the_jax_package():
    """Categorical bins (count-sorted codes, the 99% cut at 255 bins) and
    the EFB layout of the one-hot table are the JAX package's, and the
    binned bytes are equal."""
    X, y = airline_like(20000, 3)
    for M, cats in ((X, list(AIRLINE_CATEGORICAL)), (one_hot(X), "auto")):
        jd = lgb.Dataset(M, label=y, categorical_feature=cats).construct()
        td = lt.Dataset(M, label=y, device="cpu",
                        categorical_feature=cats).construct()
        assert jd.used_features == td.used_features
        for f in td.used_features:
            jm, tm = jd.bin_mappers[f], td.bin_mappers[f]
            assert jm.num_bin == tm.num_bin <= 256
            assert list(jm.bin_2_categorical) == list(tm.bin_2_categorical)
        assert np.array_equal(np.asarray(jd.feat_group), td.feat_group)
        assert np.array_equal(np.asarray(jd.feat_start), td.feat_start)
        assert np.array_equal(np.asarray(jd.host_binned()),
                              td.host_binned())
    assert td.feature_meta().has_bundles
    assert td.num_groups < 0.1 * len(td.used_features)


def test_row_goes_left_categorical_matches():
    """The bitset test per row (words past the first, the NaN bin, a
    numeric node beside it) against the JAX package's rule."""
    rng = np.random.RandomState(9)
    n = 3000
    col = rng.randint(0, 200, n).astype(np.int32)
    bits = rng.randint(0, 2 ** 32, (n, 8), dtype=np.uint64)
    is_cat = rng.rand(n) < 0.7
    thr = rng.randint(0, 200, n).astype(np.int32)
    dl = rng.rand(n) < 0.5
    mt = rng.randint(0, 3, n).astype(np.int32)
    db = rng.randint(0, 200, n).astype(np.int32)
    nb = np.full(n, 200, np.int32)
    want = j_goes_left(jnp.asarray(col), jnp.asarray(thr), jnp.asarray(dl),
                       jnp.asarray(is_cat),
                       jnp.asarray(bits.astype(np.uint32)), jnp.asarray(mt),
                       jnp.asarray(db), jnp.asarray(nb))
    got = t_goes_left(torch.from_numpy(col), torch.from_numpy(thr),
                      torch.from_numpy(dl), torch.from_numpy(mt),
                      torch.from_numpy(db), torch.from_numpy(nb),
                      torch.from_numpy(is_cat),
                      torch.from_numpy(bits.astype(np.int64)))
    assert np.array_equal(got.numpy(), np.asarray(want))


GROW = {
    # (one-hot columns, hist_method): staged with bundles, fused without
    "staged_bundled": (ONEHOT_COLS, "pallas"),
    "fused_categorical": ((), "fused"),
}
STRUCTURE = ("split_feature", "threshold_bin", "default_left",
             "is_categorical", "left_child", "right_child", "leaf_parent",
             "leaf_depth", "split_gain", "internal_value", "internal_weight",
             "internal_count", "leaf_value", "leaf_weight", "leaf_count")


@pytest.mark.parametrize("case", list(GROW))
def test_dyadic_tree_is_equal(case):
    cols, method = GROW[case]
    X, _ = airline_like(3000, 4)
    if cols:
        X, cats = _onehot_cat(X)
    else:
        cats = list(AIRLINE_CATEGORICAL)
    params = {"max_bin": 63, "min_data_in_leaf": 5, "verbose": -1}
    td = lt.Dataset(X, device="cpu", params=params,
                    categorical_feature=cats).construct()
    jd = lgb.Dataset(X, params=params, categorical_feature=cats).construct()
    meta_t, meta_j = td.feature_meta(), jd.feature_meta()
    assert meta_t.has_bundles == bool(cols)
    binned = td.host_binned().T.copy()
    assert np.array_equal(binned, np.asarray(jd.host_binned()).T)
    rng = np.random.RandomState(5)
    n = X.shape[0]
    grad = (rng.randint(-64, 65, n) / 8.0).astype(np.float32)
    hess = np.where(rng.rand(n) < 0.5, 1.0,
                    rng.randint(1, 9, n) / 4.0).astype(np.float32)
    mask = (rng.rand(n) < 0.9).astype(np.float32)
    hp = dict(min_data_in_leaf=5, lambda_l2=1.0, max_cat_threshold=3,
              min_data_per_group=20)
    B = int(meta_t.max_num_bin)
    jt, jl = jgrow(jnp.asarray(binned), jnp.asarray(grad), jnp.asarray(hess),
                   jnp.asarray(mask), meta_j,
                   JConfig(num_leaves=15, hp=JHP(**hp), num_bins=B,
                           round_width=8, hist_method=method))
    tt, tl = tgrow(td.binned_t, torch.from_numpy(grad),
                   torch.from_numpy(hess), torch.from_numpy(mask), meta_t,
                   TConfig(num_leaves=15, hp=THP(**hp), num_bins=B,
                           round_width=8, hist_method=method))
    tt = tt.to_numpy()
    assert int(jt.num_leaves) == tt["num_leaves"] == 15
    for name in STRUCTURE:
        assert np.array_equal(np.asarray(getattr(jt, name)), tt[name]), name
    cat = tt["is_categorical"][:14]
    assert cat.any()
    assert np.array_equal(np.asarray(jt.cat_bitset)[:14][cat],
                          tt["cat_bitset"][:14][cat])
    assert np.array_equal(np.asarray(jl), tl.numpy())


def test_categorical_feature_past_the_bitset_raises():
    """A categorical feature of more than 256 bins cannot be split by a
    ``MAX_CAT_WORDS``-word bitset: the trainer refuses it up front."""
    rng = np.random.RandomState(10)
    X = np.stack([rng.randint(0, 300, 3000), rng.randn(3000)], axis=1)
    y = (rng.rand(3000) < 0.5).astype(np.float32)
    ds = lt.Dataset(X.astype(np.float32), label=y, device="cpu",
                    categorical_feature=[0], params={"max_bin": 511})
    with pytest.raises(ValueError, match="256 bins"):
        lt.train(dict(BASE, max_bin=511), ds, 1, verbose_eval=False)
