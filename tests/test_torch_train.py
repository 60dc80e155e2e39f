"""``lightgbm_tpu_torch.train`` on the CPU (the kernels' plain versions)
held against ``lightgbm_tpu.train`` with the same rounds grower and fused
histogram arm (``tpu_tree_growth="rounds"``, ``tpu_hist_method="fused"``).

- Tree structure in the model texts is equal: split features, double
  thresholds, decision types, children, leaf counts.
- Leaf values, predictions and the eval metrics agree to rtol=1e-4 (the
  two packages sum f32 histograms in different orders; the port's sums
  are exact); a leaf value near zero, where the gradient sum cancels,
  gets atol=1e-6 (measured: 3.2e-7 on a leaf of 0.002).
- The port's model text loads in ``lightgbm_tpu.Booster`` and predicts
  the same.
- l2 gradients are bit-equal; binary gradients go through ``exp``, whose
  last bit may differ between XLA and torch: they agree within 2 ulps
  (measured: 2).  The hessian |r| (1 - |r|) cancels where |r| nears 1,
  so it is held to an absolute 4 * 2**-23 (measured: at most 13 ulps
  and 9.7e-8).
- Sharded training, outside the port, raises ``NotImplementedError``;
  what it once refused follows the JAX package: CEGB and forced splits
  with this file's ``tpu_tree_growth="rounds"`` raise the JAX package's
  ``ValueError`` (a missing forced-splits file its ``OSError``), and
  ``tpu_tree_growth="serial"`` trains its trees (tests/
  test_torch_cegb_forced.py and tests/test_torch_serial_grower.py hold
  the serial grower); monotone constraints, extra trees and bynode
  sampling train the JAX package's trees, and multiclass, the other
  objectives, GOSS, DART and RF are held in the ``test_torch_*`` files
  of their own.

One-hot data that EFB bundles trains on the staged arm to the same
bars in tests/test_torch_train_onehot.py; the configurations the port
once refused are in tests/test_torch_train_lifted.py.

The data of the configurations above has no missing values.  A binary
run on data with NaN in two features is held to the same bars with one
exception: where no NaN row reaches a node, the port's exact sibling
histogram has a zero NaN bin and ties the two missing directions
(missing goes left), while the JAX package's f32 ``parent - small`` can
leave a residue that breaks the tie the other way (ROADMAP queue C).
There the default-left bit of ``decision_type`` is not compared; every
other bit is, and every node that NaN rows reach is compared whole.
Predictions and metrics are taken on the training rows, which no such
bit can route differently.  (Measured on this data: 18 NaN-type nodes
that NaN rows reach, compared whole; 15 that none reach; no bit
differs.)
"""

import numpy as np
import pytest
import torch

import lightgbm_tpu as lgb
from lightgbm_tpu.config import Config as JConfig
from lightgbm_tpu.objectives import create_objective as jcreate

import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch.config import Config as TConfig
from lightgbm_tpu_torch.model_text import load_model_from_string
from lightgbm_tpu_torch.objectives import create_objective as tcreate
from lightgbm_tpu_torch.testing import one_thread  # noqa: F401

ROUNDS = 5
BASE = {"num_leaves": 15, "min_data_in_leaf": 5, "verbose": -1,
        "tpu_tree_growth": "rounds", "tpu_hist_method": "fused",
        "max_bin": 63}
CONFIGS = {
    "binary": dict(BASE, objective="binary",
                   metric=["binary_logloss", "auc"]),
    "regression": dict(BASE, objective="regression", metric=["l2"]),
    "binary_bagged": dict(BASE, objective="binary", bagging_fraction=0.8,
                          bagging_freq=1, feature_fraction=0.8,
                          metric=["auc"]),
}
TREE_EXACT = ("split_feature", "threshold", "decision_type", "left_child",
              "right_child", "leaf_count")


def _data(seed, n, objective):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, 6).astype(np.float32)
    X[:, 4] = np.round(X[:, 4] * 2)
    z = X[:, 0] + 0.5 * X[:, 1] * X[:, 2] - 0.4 * X[:, 4] \
        + 0.3 * rng.randn(n)
    y = (z > 0).astype(np.float32) if objective == "binary" else z
    return X, y.astype(np.float32)


def _train(name):
    params = CONFIGS[name]
    X, y = _data(1, 2000, params["objective"])
    Xv, yv = _data(2, 500, params["objective"])
    ev_j, ev_t = {}, {}
    ds = lgb.Dataset(X, label=y)
    bj = lgb.train(dict(params), ds, ROUNDS,
                   valid_sets=[ds.create_valid(Xv, label=yv)],
                   evals_result=ev_j, verbose_eval=False)
    dt = lt.Dataset(X, label=y, device="cpu")
    bt = lt.train(dict(params), dt, ROUNDS,
                  valid_sets=[dt.create_valid(Xv, label=yv)],
                  evals_result=ev_t, verbose_eval=False)
    return {"jax": bj, "port": bt, "ev_j": ev_j, "ev_t": ev_t, "Xv": Xv}


@pytest.fixture(scope="module")
def trained():
    return {name: _train(name) for name in CONFIGS}


@pytest.mark.parametrize("name", list(CONFIGS))
def test_model_text_trees_match(trained, name):
    r = trained[name]
    jm = load_model_from_string(r["jax"].model_to_string())
    tm = load_model_from_string(r["port"].model_to_string())
    assert jm["objective_name"] == tm["objective_name"]
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
    np.testing.assert_allclose(r["port"].predict(Xv), r["jax"].predict(Xv),
                               rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(r["port"].predict(Xv, device=False),
                               r["jax"].predict(Xv), rtol=1e-4, atol=1e-6)
    for data, metrics in r["ev_j"].items():
        for metric, vals in metrics.items():
            np.testing.assert_allclose(r["ev_t"][data][metric], vals,
                                       rtol=1e-4)


def _nan_data():
    X, y = _data(1, 2000, "binary")
    rng = np.random.RandomState(8)
    X[rng.rand(len(X)) < 0.1, 0] = np.nan
    X[rng.rand(len(X)) < 0.05, 3] = np.nan
    return X, y


@pytest.fixture(scope="module")
def nan_trained():
    X, y = _nan_data()
    params = CONFIGS["binary"]
    ev_j, ev_t = {}, {}
    ds = lgb.Dataset(X, label=y)
    bj = lgb.train(dict(params), ds, ROUNDS,
                   valid_sets=[ds.create_valid(X, label=y)],
                   evals_result=ev_j, verbose_eval=False)
    dt = lt.Dataset(X, label=y, device="cpu")
    bt = lt.train(dict(params), dt, ROUNDS,
                  valid_sets=[dt.create_valid(X, label=y)],
                  evals_result=ev_t, verbose_eval=False)
    return {"jax": bj, "port": bt, "ev_j": ev_j, "ev_t": ev_t, "X": X}


def _nan_reaches(tree, X):
    """Per internal node: does a row with NaN in the node's split feature
    reach it?  Rows route as the model text's decision types say."""
    reach = np.zeros(tree.num_leaves - 1, bool)
    stack = [(0, np.arange(len(X)))]
    while stack:
        node, rows = stack.pop()
        v = X[rows, tree.split_feature[node]]
        nan = np.isnan(v)
        reach[node] = nan.any()
        dt = int(tree.decision_type[node])
        mt = (dt >> 2) & 3
        if mt == 2:
            missing = nan
        else:
            v = np.where(nan, 0.0, v)
            missing = (mt == 1) & (np.abs(v) <= 1e-35)
        left = np.where(missing, bool(dt & 2), v <= tree.threshold[node])
        for child, sel in ((tree.left_child[node], left),
                           (tree.right_child[node], ~left)):
            if child >= 0:
                stack.append((child, rows[sel]))
    return reach


def test_nan_missing_values_match(nan_trained):
    r = nan_trained
    X = r["X"]
    jm = load_model_from_string(r["jax"].model_to_string())
    tm = load_model_from_string(r["port"].model_to_string())
    assert jm["feature_infos"] == tm["feature_infos"]
    reached_nan_nodes = 0
    for j, t in zip(jm["models"], tm["models"]):
        assert j.num_leaves == t.num_leaves
        for f in ("split_feature", "threshold", "left_child", "right_child",
                  "leaf_count"):
            assert np.array_equal(getattr(j, f), getattr(t, f)), f
        reach = _nan_reaches(t, X)
        nan_type = ((t.decision_type >> 2) & 3) == 2
        loose = nan_type & ~reach
        assert np.array_equal(j.decision_type[~loose], t.decision_type[~loose])
        assert np.array_equal(j.decision_type[loose] & ~2,
                              t.decision_type[loose] & ~2)
        reached_nan_nodes += int((nan_type & reach).sum())
        np.testing.assert_allclose(t.leaf_value, j.leaf_value, rtol=1e-4,
                                   atol=1e-6)
    assert reached_nan_nodes > 0
    np.testing.assert_allclose(r["port"].predict(X), r["jax"].predict(X),
                               rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(r["port"].predict(X, device=False),
                               r["jax"].predict(X), rtol=1e-4, atol=1e-6)
    loaded = lgb.Booster(model_str=r["port"].model_to_string())
    np.testing.assert_allclose(loaded.predict(X, raw_score=True),
                               r["port"].predict(X, raw_score=True,
                                                 device=False),
                               rtol=1e-6, atol=1e-7)
    for data, metrics in r["ev_j"].items():
        for metric, vals in metrics.items():
            np.testing.assert_allclose(r["ev_t"][data][metric], vals,
                                       rtol=1e-4)


def test_valid_metric_falls(trained):
    ll = trained["binary"]["ev_t"]["valid_0"]["binary_logloss"]
    assert all(b < a for a, b in zip(ll, ll[1:]))


@pytest.mark.parametrize("name", list(CONFIGS))
def test_port_model_text_loads_in_the_jax_package(trained, name):
    r = trained[name]
    text = r["port"].model_to_string()
    loaded = lgb.Booster(model_str=text)
    Xv = r["Xv"]
    np.testing.assert_allclose(loaded.predict(Xv, raw_score=True),
                               r["port"].predict(Xv, raw_score=True,
                                                 device=False),
                               rtol=1e-6, atol=1e-7)


def _gradients(objective, score, y):
    from lightgbm_tpu.dataset import Metadata as JMeta
    from lightgbm_tpu_torch.dataset import Metadata as TMeta
    jo = jcreate(JConfig.from_params({"objective": objective}))
    to = tcreate(TConfig.from_params({"objective": objective}))
    jo.init(JMeta(label=y), len(y))
    to.init(TMeta(label=y), len(y), "cpu")
    import jax.numpy as jnp
    jg, jh = jo.get_gradients(jnp.asarray(score))
    tg, th = to.get_gradients(torch.from_numpy(score))
    return (np.asarray(jg), np.asarray(jh)), (tg.numpy(), th.numpy())


def _ulps(a, b):
    return np.abs(a.view(np.int32).astype(np.int64)
                  - b.view(np.int32).astype(np.int64))


def test_l2_gradients_are_bit_equal():
    rng = np.random.RandomState(3)
    score = rng.randn(4000).astype(np.float32)
    y = rng.randn(4000).astype(np.float32)
    (jg, jh), (tg, th) = _gradients("regression", score, y)
    assert jg.tobytes() == tg.tobytes() and jh.tobytes() == th.tobytes()


def test_binary_gradients_within_two_ulps():
    rng = np.random.RandomState(4)
    score = (rng.randn(4000) * 4).astype(np.float32)
    y = (rng.rand(4000) < 0.4).astype(np.float32)
    (jg, jh), (tg, th) = _gradients("binary", score, y)
    assert np.array_equal(np.sign(jg), np.sign(tg))
    assert _ulps(jg, tg).max() <= 2
    np.testing.assert_allclose(th, jh, rtol=0, atol=4 * 2.0 ** -23)


@pytest.mark.parametrize("params", [
    {"tree_learner": "data"},
    {"tree_learner": "voting"},
    {"num_machines": 2},
])
def test_out_of_slice_configurations_raise(params):
    """Once refused as "sharded training": each now trains on two thread
    ranks (``num_machines`` alone keeps the serial learner; voting's
    default top_k of 20 elects all six features) and every rank's trees
    are the serial grower's, byte for byte."""
    from lightgbm_tpu_torch.testing import thread_ranks
    X, y = _data(5, 300, "binary")
    p = {**BASE, "objective": "binary", "tpu_tree_growth": "serial"}

    def text(bst):
        return bst.model_to_string().partition("parameters:")[0]
    want = text(lt.train(dict(p), lt.Dataset(X, label=y, device="cpu"), 3))
    texts = thread_ranks(2, lambda rank, group: text(lt.train(
        {**p, **params}, lt.Dataset(X, label=y, device="cpu"), 3,
        verbose_eval=False)))
    assert texts == [want, want]


@pytest.mark.parametrize("params,raises", [
    ({"cegb_penalty_split": 0.5}, ValueError),
    ({"forcedsplits_filename": "splits.json"}, OSError),
    ({"tpu_tree_growth": "serial"}, None),
])
def test_once_refused_configurations_follow_the_jax_package(params, raises):
    """CEGB and forced splits on this file's rounds growth raise what the
    JAX package raises (the forced-splits file here does not exist).
    The serial growth trains the rounds growth's model text, byte for
    byte, and so the JAX package's rounds trees; the JAX package's own
    serial grower breaks an exact tie of this data differently (ROADMAP
    queue C, C-20: tests/test_torch_serial_grower.py)."""
    X, y = _data(5, 300, "binary")
    p = {**BASE, "objective": "binary", **params}
    if raises is not None:
        msgs = []
        for mod, kw in ((lt, {"device": "cpu"}), (lgb, {})):
            with pytest.raises(raises) as err:
                mod.train(dict(p), mod.Dataset(X, label=y, **kw), 1,
                          verbose_eval=False)
            msgs.append(str(err.value))
        assert msgs[0] == msgs[1]
        return
    texts = {}
    for growth in ("serial", "rounds"):
        bt = lt.train(dict(p, tpu_tree_growth=growth),
                      lt.Dataset(X, label=y, device="cpu"), 2,
                      verbose_eval=False)
        texts[growth] = bt.model_to_string().partition("end of trees")[0]
    assert type(bt.boosting.grower).__name__ == "RoundGrower"
    assert texts["serial"] == texts["rounds"]
    bj = lgb.train(dict(p, tpu_tree_growth="rounds"), lgb.Dataset(X, label=y),
                   2, verbose_eval=False)
    jm = load_model_from_string(bj.model_to_string())["models"]
    tm = load_model_from_string(texts["serial"] + "end of trees\n")["models"]
    assert len(jm) == len(tm) == 2
    for j, t in zip(jm, tm):
        for f in TREE_EXACT:
            assert np.array_equal(getattr(j, f), getattr(t, f)), f
        np.testing.assert_allclose(t.leaf_value, j.leaf_value, rtol=1e-4,
                                   atol=1e-6)


def test_staged_method_on_unbundled_data_matches_the_fused_arm(trained):
    """On data without bundles a staged name runs the staged arm (B6 root,
    B4 + expansion-free B5 search) and grows the fused arm's trees."""
    r = trained["binary"]
    X, y = _data(1, 2000, "binary")
    bt = lt.train(dict(CONFIGS["binary"], tpu_hist_method="scatter"),
                  lt.Dataset(X, label=y, device="cpu"), ROUNDS,
                  verbose_eval=False)
    trees = r["port"].model_to_string().partition("end of trees")[0]
    got = bt.model_to_string().partition("end of trees")[0]
    jm = load_model_from_string(trees + "end of trees\n")
    tm = load_model_from_string(got + "end of trees\n")
    for j, t in zip(jm["models"], tm["models"]):
        for f in TREE_EXACT:
            assert np.array_equal(getattr(j, f), getattr(t, f)), f


def test_unknown_hist_method_raises():
    X, y = _data(5, 300, "binary")
    with pytest.raises(ValueError, match="tpu_hist_method"):
        lt.train(dict(BASE, objective="binary", tpu_hist_method="onehot"),
                 lt.Dataset(X, label=y, device="cpu"), 1,
                 verbose_eval=False)


def test_default_device_is_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA; the refusal needs a host without")
    X, y = _data(5, 100, "binary")
    with pytest.raises(RuntimeError, match="CUDA"):
        lt.Dataset(X, label=y)
