"""One-hot data that EFB bundles, trained on the staged arm
(``tpu_hist_method="pallas"``) by ``lightgbm_tpu_torch.train`` on the CPU
and held against ``lightgbm_tpu.train`` to test_torch_train.py's bars:
``binary`` and ``regression``, and with bagging, ``feature_fraction``
and a valid set; every other ``tpu_hist_method`` name gives the same
trees.  (Moved out of test_torch_train.py so that parallel test workers
take the two files apart.)
"""

import numpy as np
import pytest

import lightgbm_tpu as lgb

import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch.model_text import load_model_from_string
from lightgbm_tpu_torch.testing import one_thread  # noqa: F401

from test_torch_train import BASE, ROUNDS, TREE_EXACT


def _onehot_data(seed, n, objective):
    """Rows whose one-hot columns EFB bundles: three exclusive one-hot
    blocks (5, 9 and 40 columns) with label effects, a sparse numeric
    column and two dense ones."""
    rng = np.random.RandomState(seed)
    blocks, z = [], 0.3 * rng.randn(n)
    for k in (5, 9, 40):
        code = rng.randint(0, k, n)
        blk = np.zeros((n, k), np.float32)
        blk[np.arange(n), code] = 1.0
        blocks.append(blk)
        z += np.random.RandomState(k).randn(k)[code] * 0.6
    sparse = np.where(rng.rand(n) < 0.15, rng.randn(n) * 2, 0.0)
    dense = rng.randn(n, 2)
    z += 0.5 * sparse + dense[:, 0] - 0.3 * dense[:, 1] ** 2
    X = np.concatenate(blocks + [sparse[:, None], dense], axis=1)
    y = (z > 0).astype(np.float32) if objective == "binary" else z
    return X.astype(np.float32), y.astype(np.float32)


STAGED = dict(BASE, tpu_hist_method="pallas", min_data_in_leaf=20)
# The JAX package rebuilds a bundled feature's bin 0 as the leaf's f32
# total minus its other bins (grower_rounds.py:202-211), the port from
# exact int64 totals.  The f32 subtraction costs the JAX package up to a
# few 1e-6 of a leaf value here (measured: 4.1e-6 on a leaf of 0.0118,
# 3.5e-4 relative, at min_data_in_leaf=20; 7e-5 on a leaf of 0.51 of 17
# rows at min_data_in_leaf=5, where the port was within 3e-8 of the
# float64 leaf output), so leaf values and predictions of the bundled
# cases take an absolute bar of 1e-4 beside rtol=1e-4;
# test_bundled_first_tree_leaves_are_exact holds the port to the float64
# leaf outputs.
BIN0_ATOL = 1e-4
ONEHOT_CONFIGS = {
    "onehot_binary": dict(STAGED, objective="binary",
                          metric=["binary_logloss", "auc"]),
    "onehot_regression": dict(STAGED, objective="regression", metric=["l2"]),
    "onehot_bagged": dict(STAGED, objective="binary", bagging_fraction=0.8,
                          bagging_freq=1, feature_fraction=0.8,
                          metric=["auc"]),
}


@pytest.fixture(scope="module")
def onehot_trained():
    out = {}
    for name, params in ONEHOT_CONFIGS.items():
        X, y = _onehot_data(11, 2000, params["objective"])
        Xv, yv = _onehot_data(12, 500, params["objective"])
        ev_j, ev_t = {}, {}
        ds = lgb.Dataset(X, label=y)
        bj = lgb.train(dict(params), ds, ROUNDS,
                       valid_sets=[ds.create_valid(Xv, label=yv)],
                       evals_result=ev_j, verbose_eval=False)
        dt = lt.Dataset(X, label=y, device="cpu")
        bt = lt.train(dict(params), dt, ROUNDS,
                      valid_sets=[dt.create_valid(Xv, label=yv)],
                      evals_result=ev_t, verbose_eval=False)
        out[name] = {"jax": bj, "port": bt, "ev_j": ev_j, "ev_t": ev_t,
                     "Xv": Xv, "X": X, "y": y, "meta": dt.feature_meta()}
    return out


@pytest.mark.parametrize("name", list(ONEHOT_CONFIGS))
def test_bundled_data_trains_like_the_jax_package(onehot_trained, name):
    """One-hot columns that EFB bundles, on the staged arm (B6 root, B4
    segment histograms, the int64 expansion, B5 in leaf mode): the trees
    of the model texts are equal, leaf values, predictions and metrics
    agree to rtol=1e-4, and the model text loads in the JAX package."""
    r = onehot_trained[name]
    assert r["meta"].has_bundles
    jm = load_model_from_string(r["jax"].model_to_string())
    tm = load_model_from_string(r["port"].model_to_string())
    assert jm["feature_infos"] == tm["feature_infos"]
    assert len(jm["models"]) == len(tm["models"]) == ROUNDS
    for j, t in zip(jm["models"], tm["models"]):
        assert j.num_leaves == t.num_leaves
        for f in TREE_EXACT:
            assert np.array_equal(getattr(j, f), getattr(t, f)), f
        np.testing.assert_allclose(t.leaf_value, j.leaf_value, rtol=1e-4,
                                   atol=BIN0_ATOL)
    Xv = r["Xv"]
    np.testing.assert_allclose(r["port"].predict(Xv), r["jax"].predict(Xv),
                               rtol=1e-4, atol=BIN0_ATOL)
    for data, metrics in r["ev_j"].items():
        for metric, vals in metrics.items():
            np.testing.assert_allclose(r["ev_t"][data][metric], vals,
                                       rtol=1e-4)
    loaded = lgb.Booster(model_str=r["port"].model_to_string())
    np.testing.assert_allclose(loaded.predict(Xv, raw_score=True),
                               r["port"].predict(Xv, raw_score=True,
                                                 device=False),
                               rtol=1e-6, atol=1e-7)


def test_bundled_first_tree_leaves_are_exact(onehot_trained):
    """The port's first-tree leaf values on bundled data equal the leaf
    outputs computed in float64 from the rows each leaf holds (the f32
    leaf value's own rounding aside): its bin-0 reconstruction is exact."""
    r = onehot_trained["onehot_regression"]
    X, y = r["X"], r["y"].astype(np.float64)
    tree = load_model_from_string(r["port"].model_to_string())["models"][0]
    init = float(np.float32(y.mean()))
    leaves = tree.predict_leaf_np(X.astype(np.float64))
    for leaf in range(tree.num_leaves):
        rows = leaves == leaf
        out = (y[rows] - init).sum() / rows.sum() * 0.1 + init
        np.testing.assert_allclose(tree.leaf_value[leaf], out, rtol=1e-6)


@pytest.mark.parametrize("method", ["auto", "fused", "scatter", "matmul",
                                    "matmul_f32"])
def test_every_staged_method_name_gives_the_same_trees(onehot_trained,
                                                       method):
    """Every ``tpu_hist_method`` name trains the bundled data on the staged
    arm (``fused`` and ``auto`` too: the fused arm takes no bundles) and
    gives the trees of ``pallas``."""
    r = onehot_trained["onehot_binary"]
    params = dict(ONEHOT_CONFIGS["onehot_binary"], tpu_hist_method=method)
    bt = lt.train(params, lt.Dataset(r["X"], label=r["y"], device="cpu"),
                  ROUNDS, verbose_eval=False)
    trees = r["port"].model_to_string().partition("end of trees")[0]
    assert bt.model_to_string().partition("end of trees")[0] == trees
