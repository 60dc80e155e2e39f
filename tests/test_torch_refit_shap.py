"""Continued training, ``refit``, ``pred_contrib`` and the rest of the
Booster API held against ``lightgbm_tpu`` on the CPU.

- ``train(init_model=)`` from a model file the JAX package wrote grows
  the trees of ``lightgbm_tpu.train(init_model=...)``: the same
  structure, leaf values and valid metrics to test_torch_train.py's
  rtol=1e-4 (atol=1e-6 for a leaf near zero); the init scores come from
  the traversal kernel's scores mode (its plain version here).
- ``refit`` of one model text loaded into both packages gives leaf
  values within 1e-6 relative of the JAX package's (measured: equal;
  both sum f32 gradients in float64 in row order).
- ``pred_contrib`` of one model text equals the JAX package's within
  1e-12 absolute (both host float64; measured: equal); each row's
  contributions sum to its raw score within 1e-9 relative.
- ``dump_model``, ``trees_to_dataframe``, ``shuffle_models``,
  ``get_split_value_histogram`` and the bounds equal the JAX
  package's.
- ``reset_parameter`` beyond the learning rate, ``update(train_set=)``,
  pickling and copies are the port's own; tests/test_engine.py's
  continued-training and refit cases are mirrored on synthetic rows.
"""

import copy
import pickle

import numpy as np
import pytest

import lightgbm_tpu as lgb

import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch import testing
from lightgbm_tpu_torch.model_text import load_model_from_string
from lightgbm_tpu_torch.testing import one_thread  # noqa: F401

BASE = {"num_leaves": 7, "min_data_in_leaf": 10, "verbose": -1,
        "tpu_tree_growth": "rounds", "tpu_hist_method": "fused",
        "max_bin": 63}
BINARY = dict(BASE, objective="binary", metric=["binary_logloss", "auc"])
TREE_EXACT = ("split_feature", "threshold", "decision_type", "left_child",
              "right_child", "leaf_count")


def _data(seed, n=1500):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, 6).astype(np.float32)
    z = X[:, 0] + 0.5 * X[:, 1] * X[:, 2] - 0.3 * X[:, 4] + 0.4 * rng.randn(n)
    return X, (z > 0).astype(np.float32)


X, Y = _data(1)
XV, YV = _data(2, 400)


def _models(text):
    return load_model_from_string(text)["models"]


def _assert_same_trees(jtext, ttext, atol=1e-6):
    jm, tm = _models(jtext), _models(ttext)
    assert len(jm) == len(tm)
    for j, t in zip(jm, tm):
        assert j.num_leaves == t.num_leaves
        for f in TREE_EXACT:
            assert np.array_equal(getattr(j, f), getattr(t, f)), f
        np.testing.assert_allclose(t.leaf_value, j.leaf_value, rtol=1e-4,
                                   atol=atol)


@pytest.fixture(scope="session")
def jax_continued(tmp_path_factory):
    """A 2-round JAX model on file, then 2 more JAX rounds from it (one
    chunk size: the JAX package compiles its chunk program once)."""
    path = str(tmp_path_factory.mktemp("init") / "init.txt")
    lgb.train(dict(BINARY), lgb.Dataset(X, label=Y), 2,
              verbose_eval=False).save_model(path)
    ds = lgb.Dataset(X, label=Y, free_raw_data=False)
    ev = {}
    bst = lgb.train(dict(BINARY), ds, 2, init_model=path,
                    valid_sets=[ds.create_valid(XV, label=YV)],
                    evals_result=ev, verbose_eval=False)
    return {"path": path, "text": bst.model_to_string(), "ev": ev}


def test_continued_training_matches_the_jax_package(jax_continued):
    ds = lt.Dataset(X, label=Y, free_raw_data=False, device="cpu")
    ev = {}
    bst = lt.train(dict(BINARY), ds, 2, init_model=jax_continued["path"],
                   valid_sets=[ds.create_valid(XV, label=YV)],
                   evals_result=ev, verbose_eval=False)
    assert bst.num_trees() == 4 and bst.current_iteration() == 4
    _assert_same_trees(jax_continued["text"], bst.model_to_string())
    for data, metrics in jax_continued["ev"].items():
        for metric, vals in metrics.items():
            np.testing.assert_allclose(ev[data][metric], vals, rtol=1e-4)
    init = lt.Booster(model_file=jax_continued["path"], device="cpu")
    np.testing.assert_allclose(
        bst.predict(XV, raw_score=True, device=False),
        lgb.Booster(model_str=jax_continued["text"]).predict(
            XV, raw_score=True), rtol=1e-4, atol=1e-6)
    # the init scores are the old model's raw scores (f32, pinned order)
    ds2 = lt.Dataset(X, label=Y, free_raw_data=False, device="cpu")
    b2 = lt.train(dict(BINARY), ds2, 1, init_model=init, verbose_eval=False)
    first = b2.boosting.tree_history[0][0]
    from lightgbm_tpu_torch.grower import predict_leaf_index_binned
    tree_out = first.leaf_value[predict_leaf_index_binned(
        first, ds2.binned_t, b2.boosting.meta_t)]
    np.testing.assert_allclose(
        (b2.boosting.train_score[0] - tree_out).numpy(),
        init.predict(X, raw_score=True), rtol=1e-6, atol=1e-6)


def test_continued_training_checks_its_init_model():
    from lightgbm_tpu_torch.engine import InitModelCompatibilityError
    small = lt.train(dict(BINARY), lt.Dataset(X[:, :5], label=Y,
                                              device="cpu"), 1,
                     verbose_eval=False)
    with pytest.raises(InitModelCompatibilityError, match="features"):
        lt.train(dict(BINARY), lt.Dataset(X, label=Y, free_raw_data=False,
                                          device="cpu"), 1,
                 init_model=small, verbose_eval=False)
    same = lt.train(dict(BINARY), lt.Dataset(X, label=Y, device="cpu"), 1,
                    verbose_eval=False)
    with pytest.raises(ValueError, match="free_raw_data=False"):
        lt.train(dict(BINARY), lt.Dataset(X, label=Y, params=dict(BINARY),
                                          device="cpu").construct(), 1,
                 init_model=same, verbose_eval=False)
    with pytest.raises(NotImplementedError, match="A8"):
        lt.train(dict(BINARY), lt.Dataset(X, label=Y, device="cpu"), 1,
                 resume_from="ckpt", verbose_eval=False)


def test_continue_train_mirrors_test_engine():
    """tests/test_engine.py::test_continue_train on synthetic rows."""
    params = {"objective": "binary", "metric": "auc", "verbosity": -1}
    b1 = lt.train(params, lt.Dataset(X, label=Y, device="cpu"), 5,
                  verbose_eval=False)
    b2 = lt.train(params, lt.Dataset(X, label=Y, free_raw_data=False,
                                     device="cpu"), 5, init_model=b1,
                  verbose_eval=False)
    from sklearn.metrics import roc_auc_score
    assert b2.num_trees() == 10
    assert roc_auc_score(YV, b2.predict(XV)) >= \
        roc_auc_score(YV, b1.predict(XV)) - 0.005


@pytest.fixture(scope="module")
def port_model():
    """A port-trained model's text (the refit and SHAP cases load it into
    both packages)."""
    return lt.train(dict(BINARY), lt.Dataset(X, label=Y, device="cpu"), 4,
                    verbose_eval=False).model_to_string()


@pytest.mark.parametrize("decay", [0.0, 0.9])
def test_refit_matches_the_jax_package(port_model, decay):
    jb = lgb.Booster(model_str=port_model).refit(XV, YV, decay_rate=decay)
    tb = lt.Booster(model_str=port_model, device="cpu").refit(
        XV, YV, decay_rate=decay)
    assert len(jb.models) == len(tb.models) == 4
    for j, t in zip(jb.models, tb.models):
        np.testing.assert_array_equal(j.split_feature, t.split_feature)
        np.testing.assert_allclose(t.leaf_value, j.leaf_value, rtol=1e-6)


def test_refit_mirrors_test_engine():
    """tests/test_engine.py::test_refit on synthetic rows."""
    params = {"objective": "binary", "metric": "binary_logloss",
              "verbosity": -1, "num_leaves": 15, "min_data_in_leaf": 20}
    bst = lt.train(params, lt.Dataset(X, label=Y, device="cpu"), 5,
                   verbose_eval=False)
    err_orig = float(np.mean((bst.predict(XV) > 0.5) != YV))
    refitted = bst.refit(XV, YV, decay_rate=0.0)
    err_refit = float(np.mean((refitted.predict(XV) > 0.5) != YV))
    assert err_refit < err_orig
    for m0, m1 in zip(bst.models, refitted.models):
        np.testing.assert_array_equal(m0.split_feature, m1.split_feature)
        np.testing.assert_array_equal(m0.threshold_in_bin,
                                      m1.threshold_in_bin)
        assert not np.allclose(m0.leaf_value, m1.leaf_value)
    kept = bst.refit(XV, YV, decay_rate=1.0)
    for m0, m1 in zip(bst.models, kept.models):
        np.testing.assert_allclose(m0.leaf_value, m1.leaf_value, rtol=1e-12)


@pytest.mark.parametrize("num_class", [1, 3])
def test_pred_contrib_matches_the_jax_package(num_class):
    text = testing.synthetic_model_text(6, 6, 15, num_class=num_class,
                                        cat_features=(5,), seed=4)
    rows = testing.salt_rows(testing.synthetic_rows(6, 300, (5,), seed=4))
    j = lgb.Booster(model_str=text).predict(rows, pred_contrib=True)
    t = lt.Booster(model_str=text, device="cpu").predict(rows,
                                                         pred_contrib=True)
    assert t.shape == j.shape == (300, num_class * 7)
    np.testing.assert_allclose(t, j, rtol=0, atol=1e-12)


def test_pred_contrib_sums_to_the_raw_score(port_model):
    import scipy.sparse as sps
    bst = lt.Booster(model_str=port_model, device="cpu")
    Xs = XV.copy()
    Xs[Xs < 0.3] = 0.0
    contrib = bst.predict(sps.csr_matrix(Xs), pred_contrib=True)
    raw = bst.predict(Xs.astype(np.float64), raw_score=True, device=False)
    np.testing.assert_allclose(contrib.sum(axis=1), raw, rtol=1e-9)


def test_dump_and_dataframe_match_the_jax_package(port_model):
    jb = lgb.Booster(model_str=port_model)
    tb = lt.Booster(model_str=port_model, device="cpu")
    assert tb.dump_model() == jb.dump_model()
    assert tb.trees_to_dataframe().equals(jb.trees_to_dataframe())
    assert tb.upper_bound() == jb.upper_bound()
    assert tb.lower_bound() == jb.lower_bound()
    assert tb.get_leaf_output(2, 1) == jb.get_leaf_output(2, 1)
    for style in (False, True):
        a = jb.get_split_value_histogram(0, xgboost_style=style)
        b = tb.get_split_value_histogram("Column_0", xgboost_style=style)
        if style:
            assert a.equals(b)
        else:
            assert all(np.array_equal(x, y) for x, y in zip(a, b))
    jb.shuffle_models(1)
    tb.shuffle_models(1)
    assert tb.model_to_string() == jb.model_to_string()
    np.testing.assert_allclose(tb.predict(XV, device=False), jb.predict(XV),
                               rtol=1e-12)


def test_booster_copies_pickles_and_attributes(port_model):
    bst = lt.train(dict(BINARY), lt.Dataset(X, label=Y, device="cpu"), 2,
                   verbose_eval=False)
    bst.set_attr(run="a")
    assert bst.attr("run") == "a" and bst.attr("other") is None
    with pytest.raises(ValueError):
        bst.set_attr(run=1)
    want = bst.predict(XV, device=False)
    for other in (copy.copy(bst), copy.deepcopy(bst),
                  pickle.loads(pickle.dumps(bst))):
        np.testing.assert_array_equal(other.predict(XV, device=False), want)
    back = pickle.loads(pickle.dumps(bst))
    assert back.attr("run") == "a" and back.device == bst.device
    assert bst.num_data() == len(X)
    bst.model_from_string(port_model)
    assert bst.num_trees() == 4 and bst.num_data() == 0


def test_eval_and_train_data_name():
    ds = lt.Dataset(X, label=Y, device="cpu")
    vs = ds.create_valid(XV, label=YV)
    bst = lt.train(dict(BINARY), ds, 2, valid_sets=[vs],
                   verbose_eval=False)
    assert [r[0] for r in bst.eval(vs, "holdout")] == ["holdout"] * 2
    assert bst.eval(vs, "h")[0][2] == bst.eval_valid()[0][2]
    bst.set_train_data_name("fit")
    assert bst.eval_train()[0][0] == "fit"
    with pytest.raises(ValueError):
        bst.eval(lt.Dataset(XV, label=YV, device="cpu"), "x")


def test_reset_parameter_rebuilds_the_grower():
    bst = lt.Booster(dict(BINARY), lt.Dataset(X, label=Y, device="cpu"))
    bst.update()
    bst.reset_parameter({"num_leaves": 3, "metric": "auc",
                         "lambda_l2": 1.0})
    bst.update()
    assert bst.models[0].num_leaves == 7 and bst.models[1].num_leaves == 3
    assert [r[1] for r in bst.eval_train()] == ["auc"]
    with pytest.raises(Exception):
        bst.reset_parameter({"num_leaves": 3, "tree_learner": "voting"})
    assert bst.config.num_leaves == 3 and bst.params["num_leaves"] == 3


def test_update_with_a_new_train_set():
    ds = lt.Dataset(X, label=Y, device="cpu")
    bst = lt.Booster(dict(BINARY), ds)
    bst.update()
    bst.update()
    X2, Y2 = _data(7, 900)
    new = lt.Dataset(X2, label=Y2, device="cpu")
    bst.update(train_set=new)
    assert bst.train_set is new and new.bin_mappers is ds.bin_mappers
    assert bst.num_trees() == 3
    score = bst.boosting.train_score[0].numpy()
    two = lt.Booster(model_str=bst.model_to_string(num_iteration=2),
                     device="cpu")
    # the new rows' scores before the third tree, plus the third tree
    third = bst.boosting.tree_history[2][0]
    from lightgbm_tpu_torch.grower import predict_leaf_index_binned
    out = third.leaf_value[predict_leaf_index_binned(
        third, new.binned_t, bst.boosting.meta_t)].numpy()
    np.testing.assert_allclose(score - out,
                               two.predict(X2, raw_score=True, device=False),
                               rtol=1e-5, atol=1e-6)
