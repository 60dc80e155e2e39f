"""The port's native host library (``lightgbm_tpu_torch/native``): its
build beside the package, and its two routes held against the NumPy
routes and the JAX package (mirrors tests/test_binning.py's native
``GreedyFindBin`` case and tests/test_predict.py's native-against-NumPy
case, on synthetic rows).

- ``greedy_find_bin`` above 512 distinct values: the native bounds are
  the same list of floats as the Python body's and the JAX package's;
- ``StackedForest.predict_raw`` (with and without early stop, binary and
  multiclass, categorical splits and the routing edge cases included)
  and ``predict_leaf``: the native route gives the NumPy route's bits
  and the JAX package's;
- where the library cannot be built, the NumPy route runs, and
  ``native.route_counts`` tells the two apart.
"""

import numpy as np
import pytest

import lightgbm_tpu as lgb
from lightgbm_tpu import binning as jax_binning
from lightgbm_tpu.predict import make_early_stop as jax_make_early_stop

import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch import binning, native
from lightgbm_tpu_torch.native import build as nbuild
from lightgbm_tpu_torch.predict import make_early_stop
from lightgbm_tpu_torch.testing import (salt_rows, synthetic_model_text,
                                        synthetic_rows)
from lightgbm_tpu_torch.testing import one_thread  # noqa: F401

F = 8
CATS = (2, 5)


@pytest.fixture(scope="module")
def lib():
    return native.load_native_lib()


@pytest.fixture
def numpy_route(monkeypatch):
    """The native library as unavailable (the loader's cached answer)."""
    monkeypatch.setattr(nbuild, "_lib", None)
    monkeypatch.setattr(nbuild, "_tried", True)


@pytest.fixture(scope="module")
def models():
    out = {}
    for K, seed in ((1, 61), (3, 62)):
        text = synthetic_model_text(F, 24 if K == 1 else 8, 31,
                                    num_class=K, cat_features=CATS,
                                    seed=seed)
        X = salt_rows(synthetic_rows(F, 3000, CATS, seed=seed, row_seed=5))
        out[K] = (lgb.Booster(model_str=text),
                  lt.Booster(model_str=text, device="cpu"), X)
    return out


def test_library_builds_beside_the_package(lib, monkeypatch):
    assert lib is not None
    path = nbuild.library_path()
    assert path.exists() and path.parent == nbuild.BUILD_DIR
    assert path.parent.parts[-2:] == ("build", "lightgbm_tpu_torch")
    assert path.name.startswith("liblgbt-") and path.suffix == ".so"
    assert not list(nbuild.SRC_DIR.glob("*.so"))
    # another CPU keys another library
    monkeypatch.setattr(nbuild, "host_tag", lambda: "another|cpu")
    assert nbuild.library_path() != path


def test_greedy_find_bin_native_equals_python_and_jax(lib, monkeypatch):
    rng = np.random.RandomState(0)
    for trial in range(30):
        nd = rng.randint(600, 5000)       # above the native-dispatch gate
        dv = np.unique(np.sort(rng.randn(nd) * 10 ** rng.randint(-2, 3)))
        ct = rng.randint(1, 50, size=len(dv)).astype(np.int64)
        ct[rng.randint(0, len(dv), 5)] += rng.randint(100, 10000)
        total = int(ct.sum())
        mb = int(rng.choice([15, 63, 255]))
        mdib = int(rng.choice([0, 1, 3, 20]))
        before = dict(native.route_counts)
        nat = binning.greedy_find_bin(dv, ct, mb, total, mdib)
        assert native.route_counts["find_bin[native]"] == \
            before["find_bin[native]"] + 1
        with monkeypatch.context() as m:
            m.setattr(binning, "_greedy_find_bin_native", lambda *a: None)
            py = binning.greedy_find_bin(dv, ct, mb, total, mdib)
        jax = jax_binning.greedy_find_bin(dv, ct, mb, total, mdib)
        assert isinstance(nat, list) and nat[-1] == np.inf
        assert nat == py == list(jax), trial


def test_construct_bins_as_the_jax_package(lib):
    rng = np.random.RandomState(3)
    X = rng.randn(3000, 4)
    X[:, 1] = np.round(X[:, 1], 1)          # few distinct values
    y = (X[:, 0] > 0).astype(float)
    before = native.route_counts["find_bin[native]"]
    ds = lt.Dataset(X, label=y, device="cpu").construct()
    assert native.route_counts["find_bin[native]"] > before
    jds = lgb.Dataset(X, label=y).construct()
    for a, b in zip(ds.bin_mappers, jds.bin_mappers):
        assert list(a.bin_upper_bound) == list(b.bin_upper_bound)


def _early_stops(K):
    if K == 1:
        return [None, ("binary", 0.5, 3), ("binary", 2.0, 1)]
    return [None, ("multiclass", 0.3, 2), ("multiclass", 1.0, 1)]


@pytest.mark.parametrize("K", (1, 3))
def test_predict_raw_native_equals_numpy_and_jax(lib, models, K):
    jb, tb, X = models[K]
    n_iter = len(tb.models) // K
    tf, jf = tb._forest(0, n_iter), jb._forest(0, n_iter)
    assert tf.has_cat
    for es in _early_stops(K):
        port_es = make_early_stop(*es) if es else None
        before = native.route_counts["predict[native]"]
        nat = tf.predict_raw(X, num_class=K, early_stop=port_es)
        assert native.route_counts["predict[native]"] == before + 1
        tf._native_lib = None
        try:
            py = tf.predict_raw(X, num_class=K, early_stop=port_es)
        finally:
            del tf._native_lib
        jax = jf.predict_raw(X, num_class=K,
                             early_stop=jax_make_early_stop(*es) if es
                             else None)
        assert np.array_equal(nat.view(np.uint64), py.view(np.uint64)), es
        assert np.array_equal(nat.view(np.uint64),
                              np.asarray(jax).view(np.uint64)), es
        if es is not None:
            full = tf.predict_raw(X, num_class=K)
            assert not np.array_equal(nat, full)     # some rows stopped


@pytest.mark.parametrize("K", (1, 3))
def test_predict_leaf_native_equals_numpy_and_jax(lib, models, K):
    jb, tb, X = models[K]
    n_iter = len(tb.models) // K
    tf, jf = tb._forest(0, n_iter), jb._forest(0, n_iter)
    nat = tf.predict_leaf(X)
    tf._native_lib = None
    try:
        py = tf.predict_leaf(X)
    finally:
        del tf._native_lib
    assert nat.dtype == py.dtype == np.int32
    assert np.array_equal(nat, py)
    assert np.array_equal(nat, jf.predict_leaf(X))
    assert np.array_equal(tb.predict(X, pred_leaf=True, device=False), nat)


def test_numpy_route_without_the_library(models, numpy_route, monkeypatch):
    jb, tb, X = models[1]
    before = dict(native.route_counts)
    tf = lt.Booster(model_str=tb.model_to_string(), device="cpu")
    got = tf.predict(X, raw_score=True, device=False)
    assert native.route_counts["predict[numpy]"] == \
        before["predict[numpy]"] + 1
    assert native.route_counts["predict[native]"] == \
        before["predict[native]"]
    assert np.array_equal(got, jb.predict(X, raw_score=True))
    dv = np.arange(1000, dtype=np.float64)
    bounds = binning.greedy_find_bin(dv, np.ones(1000, np.int64), 63,
                                     1000, 3)
    assert native.route_counts["find_bin[numpy]"] == \
        before["find_bin[numpy]"] + 1
    assert bounds == list(jax_binning.greedy_find_bin(
        dv, np.ones(1000, np.int64), 63, 1000, 3))


def test_failed_build_gives_none_once(monkeypatch):
    monkeypatch.setattr(nbuild, "_lib", None)
    monkeypatch.setattr(nbuild, "_tried", False)

    def fail():
        raise RuntimeError("no compiler")

    monkeypatch.setattr(nbuild, "build", fail)
    assert nbuild.load_native_lib() is None
    assert nbuild._tried
    monkeypatch.setattr(nbuild, "build", lambda: pytest.fail("rebuilt"))
    assert nbuild.load_native_lib() is None        # tried once


def test_route_counts_reset():
    native.count_route("predict", "native")
    native.reset_route_counts()
    assert set(native.route_counts.values()) == {0}


def test_rows_narrower_than_the_forest_take_the_numpy_route(lib, models):
    _jb, tb, X = models[1]
    tf = tb._forest(0, len(tb.models))
    before = dict(native.route_counts)
    with pytest.raises(IndexError):
        tf.predict_raw(X[:, :2])
    assert native.route_counts["predict[numpy]"] == \
        before["predict[numpy]"] + 1
    assert native.route_counts["predict[native]"] == \
        before["predict[native]"]
