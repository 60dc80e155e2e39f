"""The port's Booster, StackedForest and DeviceForest
(lightgbm_tpu_torch/basic.py, predict.py) held against the JAX package's
on the same model text and rows.

Every comparison is exact: host float64 raw scores, leaf ids, float32
pinned-order scores, transformed outputs (the same NumPy transform of
equal raw scores) and the model text itself.
"""

import numpy as np
import pytest

import lightgbm_tpu as lgb
from lightgbm_tpu.predict import DeviceForest as JaxDeviceForest

import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch.convert import stacked_forest_from_numpy
from lightgbm_tpu_torch.ops import planner
from lightgbm_tpu_torch.predict import DeviceForest
from lightgbm_tpu_torch.testing import (salt_rows, synthetic_model_text,
                                        synthetic_rows)

ROWS = 400


def _bits(a):
    return np.ascontiguousarray(a, np.float64).view(np.uint64)


@pytest.fixture(scope="module")
def trained():
    """One tiny model trained by lightgbm_tpu: a categorical feature,
    NaN-missing values, 7 leaves, 4 rounds."""
    rng = np.random.RandomState(5)
    n = 600
    cat = rng.randint(0, 40, n).astype(np.float64)
    dense = rng.randn(n)
    dense[rng.rand(n) < 0.2] = np.nan
    X = np.column_stack([cat, dense, rng.randn(n)]).astype(np.float32) \
        .astype(np.float64)
    y = (np.isin(cat, [1, 4, 9, 33]) | (np.nan_to_num(dense) > 0.7)) \
        .astype(float)
    ds = lgb.Dataset(X, label=y, categorical_feature=[0])
    bst = lgb.train({"objective": "binary", "num_leaves": 7, "verbosity": -1,
                     "min_data_in_leaf": 5}, ds, num_boost_round=4,
                    verbose_eval=False)
    Xe = X[:ROWS].copy()
    Xe[0:4, 0] = [np.nan, -1e30, 1e30, 35.5]
    return bst.model_to_string(), salt_rows(Xe)


def _synthetic(F, iters, leaves, K, cats, **kw):
    text = synthetic_model_text(F, iters, leaves, K, cat_features=cats,
                                seed=23, **kw)
    return text, salt_rows(synthetic_rows(F, ROWS, cats, seed=23))


MODELS = {
    "trained": None,
    "binary_cat": (9, 30, 31, (1, 4), {}),
    "multiclass": (6, 10, 15, (2,), {"num_class": 3}),
    "dyadic": (5, 20, 15, (), {"dyadic_leaves": True}),
}


@pytest.fixture(scope="module", params=sorted(MODELS))
def model(request, trained):
    spec = MODELS[request.param]
    if spec is None:
        text, X = trained
    else:
        F, iters, leaves, cats, kw = spec
        kw = dict(kw)
        K = kw.pop("num_class", 1)
        text, X = _synthetic(F, iters, leaves, K, cats, **kw)
    jb = lgb.Booster(model_str=text)
    tb = lt.Booster(model_str=text, device="cpu")
    return request.param, text, jb, tb, X


def _jax_device_forest(jb):
    K = jb.num_tree_per_iteration
    return JaxDeviceForest(jb._forest(0, len(jb.models) // K),
                           chunk_rows=4096, variant="fused", tile_rows=128)


def _port_device_forest(tb):
    K = tb.num_tree_per_iteration
    return tb._device_forest(tb._forest(0, len(tb.models) // K))


def test_host_raw_bit_exact(model):
    _name, _text, jb, tb, X = model
    want = jb.predict(X, raw_score=True)
    got = tb.predict(X, raw_score=True, device=False)
    assert np.array_equal(_bits(got), _bits(want))
    # iteration slicing
    want = jb.predict(X, raw_score=True, start_iteration=1, num_iteration=2)
    got = tb.predict(X, raw_score=True, device=False, start_iteration=1,
                     num_iteration=2)
    assert np.array_equal(_bits(got), _bits(want))


def test_transformed_bit_exact(model):
    _name, _text, jb, tb, X = model
    assert np.array_equal(_bits(tb.predict(X, device=False)),
                          _bits(jb.predict(X)))


def test_pred_leaf_exact(model):
    _name, _text, jb, tb, X = model
    want = jb.predict(X, pred_leaf=True)
    assert np.array_equal(tb.predict(X, pred_leaf=True, device=False), want)
    assert np.array_equal(tb.predict(X, pred_leaf=True), want)


def test_early_stop_host_path(model):
    name, _text, jb, tb, X = model
    kw = dict(pred_early_stop=True, pred_early_stop_freq=2,
              pred_early_stop_margin=0.3)
    want = jb.predict(X, raw_score=True, **kw)
    got = tb.predict(X, raw_score=True, device=False, **kw)
    assert np.array_equal(_bits(got), _bits(want))


def test_device_forest_chunks_are_seamless(model, monkeypatch):
    _name, _text, _jb, tb, X = model
    K = tb.num_tree_per_iteration
    dev = _port_device_forest(tb)
    whole_raw = dev.predict_raw(X, num_class=K)
    whole_leaf = dev.predict_leaf(X)
    # a chunk that does not divide the rows leaves a ragged last call
    monkeypatch.setattr(planner, "PREDICT_CHUNK_ROWS", 37)
    assert np.array_equal(_bits(dev.predict_raw(X, num_class=K)),
                          _bits(whole_raw))
    assert np.array_equal(dev.predict_leaf(X), whole_leaf)


def test_early_stop_refuses_device_path(model):
    _name, _text, _jb, tb, X = model
    with pytest.raises(lt.LightGBMError, match="device=False"):
        tb.predict(X, raw_score=True, pred_early_stop=True)


def test_device_forest_predict_raw_padded(model):
    name, _text, jb, tb, X = model
    K = jb.num_tree_per_iteration
    jdev, tdev = _jax_device_forest(jb), _port_device_forest(tb)
    assert tdev._epilogue_verified(K) == jdev._epilogue_verified(K)
    # dyadic leaf values sum exactly in f32: the kernel's scores mode
    # serves the batch; every other forest gathers on the host in f64
    assert tdev._epilogue_verified(K) == (name == "dyadic")
    want = jdev.predict_raw_padded(X, num_class=K)
    got = tdev.predict_raw_padded(X, num_class=K)
    assert np.array_equal(_bits(got), _bits(want))
    host = tb._forest(0, len(tb.models) // K).predict_raw(X, num_class=K)
    assert np.array_equal(_bits(got), _bits(host))


def test_device_forest_predict_raw_f32(model):
    _name, _text, jb, tb, X = model
    K = jb.num_tree_per_iteration
    want = _jax_device_forest(jb).predict_raw(X, num_class=K)
    got = _port_device_forest(tb).predict_raw(X, num_class=K)
    assert np.array_equal(_bits(got), _bits(want))
    # Booster.predict defaults to this device path
    raw = tb.predict(X, raw_score=True)
    assert np.array_equal(_bits(raw), _bits(got[0] if K == 1 else got.T))


def test_stacked_forest_from_numpy(model):
    _name, _text, jb, tb, X = model
    K = jb.num_tree_per_iteration
    jforest = jb._forest(0, len(jb.models) // K)
    arrays = {k: np.asarray(getattr(jforest, k)) for k in (
        "split_feature", "threshold", "left", "right", "is_cat",
        "default_left", "missing_type", "leaf_value", "depth", "cat_offset",
        "cat_nwords", "cat_words")}
    arrays.update(has_cat=jforest.has_cat, max_depth=jforest.max_depth)
    forest = stacked_forest_from_numpy(arrays)
    want = jforest.predict_leaf(X)
    assert np.array_equal(forest.predict_leaf(X), want)
    assert np.array_equal(DeviceForest(forest, "cpu").predict_leaf(X), want)
    with pytest.raises(KeyError):
        stacked_forest_from_numpy({"split_feature": arrays["split_feature"]})


def test_model_text_round_trip(model, tmp_path):
    _name, text, jb, tb, _X = model
    assert tb.model_to_string() == jb.model_to_string()
    path = tmp_path / "model.txt"
    tb.save_model(str(path))
    again = lt.Booster(model_file=str(path), device="cpu")
    assert again.model_to_string() == jb.model_to_string()
    assert np.array_equal(tb.feature_importance(), jb.feature_importance())
    assert np.array_equal(tb.feature_importance("gain"),
                          jb.feature_importance("gain"))
    assert tb.num_trees() == jb.num_trees()
    assert tb.num_feature() == jb.num_feature()


def test_host_tree_methods(model):
    """HostTree's own per-tree host prediction equals the JAX HostTree's."""
    _name, _text, jb, tb, X = model
    for jt, tt in zip(jb.models[:6], tb.models[:6]):
        assert tt.max_depth() == jt.max_depth()
        assert np.array_equal(tt.predict_leaf_np(X), jt.predict_leaf_np(X))
        assert np.array_equal(_bits(tt.predict_np(X)),
                              _bits(jt.predict_np(X)))


def test_shape_check(model):
    _name, _text, _jb, tb, X = model
    with pytest.raises(lt.LightGBMError, match="number of features"):
        tb.predict(X[:, :-1])
