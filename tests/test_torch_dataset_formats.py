"""The port's Dataset inputs held against ``lightgbm_tpu.Dataset`` on the
CPU: one seeded table as a dense matrix, CSR, CSC, a pandas DataFrame
with a category column, a CSV file with a header and a label column, a
TSV file read in two rounds, a LibSVM file and a binary cache gives the
JAX package's binned bytes, bin mappers, EFB layout and feature names
byte for byte (exact: both bin on the host or through the binning
kernel's plain version, which equals the host bytes).  Binary caches
load across the two packages with the same bytes and metadata;
``subset`` equals the JAX package's; the Dataset field API and
``add_features_from`` behave as the JAX package's.  The synthetic cases
of tests/test_binary_cache.py and tests/test_binning.py are mirrored on
the port.
"""

import json
import os

import numpy as np
import pandas as pd
import pytest
import scipy.sparse as sps

import lightgbm_tpu as lgb
from lightgbm_tpu.binning import BinMapper as JBinMapper

import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch.binning import BinMapper
from lightgbm_tpu_torch.testing import one_thread  # noqa: F401
from lightgbm_tpu_torch.utils.log import LightGBMError

N = 2000
NAMES = [f"f{i}" for i in range(7)] + ["cat"]


def _table():
    rng = np.random.RandomState(21)
    X = rng.randn(N, 8).astype(np.float32)
    X[rng.rand(N, 8) < 0.55] = 0.0           # sparse numeric columns
    X[:, 3] = np.eye(4, dtype=np.float32)[rng.randint(0, 4, N)][:, 0]
    X[rng.rand(N) < 0.05, 5] = np.nan
    X[:, 7] = rng.randint(0, 6, N)
    y = ((X[:, 0] + 0.5 * (X[:, 7] == 2)) > 0).astype(np.float32)
    w = rng.uniform(0.5, 2.0, N).astype(np.float32)
    group = np.full(N // 50, 50)
    init = rng.randn(N) * 0.1
    return X, y, w, group, init


X, Y, W, GROUP, INIT = _table()
PARAMS = {"max_bin": 63, "min_data_in_bin": 3}


def _write_inputs(d):
    names = ["label"] + NAMES
    np.savetxt(os.path.join(d, "t.csv"), np.column_stack([Y, X]),
               delimiter=",", header=",".join(names), comments="",
               fmt="%.9g")
    np.savetxt(os.path.join(d, "t.tsv"), np.column_stack([Y, X]),
               delimiter="\t", fmt="%.9g")
    with open(os.path.join(d, "t.svm"), "w") as fh:
        for i in range(N):
            fh.write(f"{Y[i]:g} " + " ".join(
                f"{j}:{X[i, j]:.9g}" for j in range(8)
                if X[i, j] != 0 and not np.isnan(X[i, j])) + "\n")
    np.savetxt(os.path.join(d, "t.csv.weight"), W, fmt="%.9g")


def _frame():
    df = pd.DataFrame(X[:, :7], columns=NAMES[:7])
    df["cat"] = pd.Categorical(np.array(list("uvwxyz"))[X[:, 7].astype(int)])
    return df


def _inputs(d):
    """kind -> (data, Dataset keyword arguments)."""
    return {
        "dense": (X, {"label": Y}),
        "dense_f64": (X.astype(np.float64), {"label": Y}),
        "csr": (sps.csr_matrix(np.nan_to_num(X)), {"label": Y}),
        "csc": (sps.csc_matrix(np.nan_to_num(X).astype(np.float64)),
                {"label": Y}),
        "pandas": (_frame(), {"label": Y}),
        "csv": (os.path.join(d, "t.csv"),
                {"params": dict(PARAMS, header=True)}),
        "tsv_two_round": (os.path.join(d, "t.tsv"),
                          {"params": dict(PARAMS, two_round=True)}),
        "libsvm": (os.path.join(d, "t.svm"), {}),
    }


KINDS = ("dense", "dense_f64", "csr", "csc", "pandas", "csv",
         "tsv_two_round", "libsvm")


def _mappers(ds):
    """The bin mappers as JSON (NaN bounds compare equal as text)."""
    return json.dumps([m.to_dict() for m in ds.bin_mappers])


def _layout(ds, binned):
    return {"binned": binned, "names": list(ds.feature_names),
            "used": list(ds.used_features),
            "feat_group": np.asarray(ds.feat_group),
            "feat_start": np.asarray(ds.feat_start),
            "mappers": _mappers(ds),
            "label": ds.get_label(), "weight": ds.get_weight()}


@pytest.fixture(scope="session")
def files(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("formats"))
    _write_inputs(d)
    return d


@pytest.fixture(scope="session")
def jax_layouts(files):
    out = {}
    for kind, (data, kw) in _inputs(files).items():
        kw = dict(kw)
        kw["params"] = dict(PARAMS, **kw.get("params", {}))
        ds = lgb.Dataset(data, **kw).construct()
        out[kind] = _layout(ds, ds.binned)
    return out


def _port(data, **kw):
    kw["params"] = dict(PARAMS, **kw.get("params", {}))
    return lt.Dataset(data, device="cpu", **kw).construct()


def _assert_same(j, t):
    assert j["binned"].dtype == t["binned"].dtype
    assert j["binned"].tobytes() == t["binned"].tobytes()
    assert j["names"] == t["names"]
    assert j["used"] == t["used"]
    assert np.array_equal(j["feat_group"], t["feat_group"])
    assert np.array_equal(j["feat_start"], t["feat_start"])
    assert j["mappers"] == t["mappers"]
    for f in ("label", "weight"):
        if j[f] is None:
            assert t[f] is None
        else:
            assert j[f].tobytes() == t[f].tobytes()


@pytest.mark.parametrize("kind", KINDS)
def test_binned_bytes_equal_the_jax_package(files, jax_layouts, kind):
    data, kw = _inputs(files)[kind]
    ds = _port(data, **kw)
    _assert_same(jax_layouts[kind], _layout(ds, ds.host_binned()))


def test_sparse_and_dense_input_bin_alike():
    """One table as CSR and as a dense f32 matrix: the same bin mappers,
    EFB groups and [G, n] bytes (the sparse rows bin in chunks)."""
    from lightgbm_tpu_torch import dataset as D
    Xz = np.nan_to_num(X)
    dense = _port(Xz, label=Y)
    old = D.SPARSE_CHUNK_ROWS
    D.SPARSE_CHUNK_ROWS = 300          # several chunks, a ragged last one
    try:
        csr = _port(sps.csr_matrix(Xz), label=Y)
    finally:
        D.SPARSE_CHUNK_ROWS = old
    assert csr.bin_route == dense.bin_route == "kernel"
    _assert_same(_layout(dense, dense.host_binned()),
                 _layout(csr, csr.host_binned()))


def test_pandas_categories_recorded_and_reapplied():
    df = _frame()
    ds = _port(df, label=Y)
    assert ds.pandas_categorical == [list("uvwxyz")]
    assert ds._resolve_categorical() == {7}
    shuffled = df.copy()
    shuffled["cat"] = shuffled["cat"].cat.reorder_categories(list("zyxwvu"))
    vs = ds.create_valid(shuffled, label=Y).construct()
    assert vs.host_binned().tobytes() == ds.host_binned().tobytes()
    bst = lt.train({"objective": "binary", "num_leaves": 7, "verbose": -1,
                    "min_data_in_leaf": 20}, _port(df, label=Y), 2,
                   verbose_eval=False)
    assert bst.pandas_categorical == [list("uvwxyz")]
    np.testing.assert_array_equal(bst.predict(shuffled), bst.predict(df))
    loaded = lt.Booster(model_str=bst.model_to_string(), device="cpu")
    np.testing.assert_array_equal(loaded.predict(shuffled, device=False),
                                  bst.predict(df, device=False))


def _with_metadata(pkg, grouped=True, **extra):
    kw = dict(label=Y, weight=W, group=GROUP if grouped else None,
              init_score=INIT, params=dict(PARAMS))
    return pkg.Dataset(X, **kw, **extra).construct()


def _metadata(ds):
    md = ds.metadata
    return [None if a is None else a.tobytes() for a in
            (md.label, md.weight, md.query_boundaries, md.init_score)]


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_binary_caches_cross_the_packages(tmp_path, direction):
    path = str(tmp_path / "cache.bin")
    j = _with_metadata(lgb)
    t = _with_metadata(lt, device="cpu")
    if direction == "jax_to_port":
        j.save_binary(path)
        loaded = lt.Dataset(path, device="cpu").construct()
        got, want = loaded.host_binned(), j.binned
        assert _metadata(loaded) == _metadata(j)
    else:
        t.save_binary(path)
        loaded = lgb.Dataset(path).construct()
        got, want = loaded.binned, t.host_binned()
        assert _metadata(loaded) == _metadata(t)
    assert got.tobytes() == want.tobytes()
    assert loaded.params == j.params
    assert _mappers(loaded) == _mappers(j)
    other = tmp_path / "other.bin"
    (j if direction == "port_to_jax" else t).save_binary(str(other))
    assert other.read_bytes() == open(path, "rb").read()


@pytest.mark.parametrize("grouped", [False, True])
def test_subset_equals_the_jax_package(grouped):
    rng = np.random.RandomState(3)
    if grouped:
        qs = np.sort(rng.choice(len(GROUP), 15, replace=False))
        idx = np.concatenate([np.arange(q * 50, q * 50 + 50) for q in qs])
    else:
        idx = rng.permutation(N)[:700]
    j = _with_metadata(lgb, grouped).subset(idx).construct()
    t = _with_metadata(lt, grouped, device="cpu").subset(idx)
    assert t.host_binned().tobytes() == j.binned.tobytes()
    assert _metadata(t) == _metadata(j)
    assert t.num_data == j.num_data == len(idx)
    assert t.feature_names == j.feature_names
    if grouped:
        with pytest.raises(ValueError, match="contiguous"):
            _with_metadata(lt, device="cpu").subset(idx[::-1])


def test_fields_and_feature_api_match_the_jax_package():
    j = lgb.Dataset(X, label=Y, params=dict(PARAMS)).construct()
    t = lt.Dataset(X, label=Y, params=dict(PARAMS), device="cpu").construct()
    for ds in (j, t):
        ds.set_field("weight", W)
        ds.set_group(GROUP)
        ds.set_init_score(INIT)
        ds.set_label(1.0 - Y)
    for f in ("label", "weight", "init_score", "group"):
        assert np.array_equal(j.get_field(f), t.get_field(f)), f
    assert np.array_equal(j.get_group(), t.get_group())
    assert j.num_feature() == t.num_feature() == 8
    assert j.num_features() == t.num_features()
    with pytest.raises(ValueError):
        t.set_field("bogus", W)
    t.set_feature_name([f"n{i}" for i in range(8)])
    assert t.get_feature_names()[0] == "n0"
    with pytest.raises(RuntimeError):
        t.set_categorical_feature([7])
    with pytest.raises(RuntimeError, match="freed"):
        t.get_data()
    kept = lt.Dataset(X, label=Y, free_raw_data=False, device="cpu")
    assert kept.construct().get_data() is X


def test_add_features_from_matches_the_jax_package():
    a, b = X[:, :4], X[:, 4:]
    j = lgb.Dataset(a, label=Y).construct()
    j.add_features_from(lgb.Dataset(b, label=Y).construct())
    t = lt.Dataset(a, label=Y, device="cpu").construct()
    t.add_features_from(lt.Dataset(b, label=Y, device="cpu").construct())
    assert t.host_binned().tobytes() == j.binned.tobytes()
    assert np.array_equal(t.feat_group, j.feat_group)
    assert t.used_features == j.used_features
    assert t.num_total_features == j.num_total_features == 8
    with pytest.raises(LightGBMError):
        t.add_features_from(
            lt.Dataset(b[:10], label=Y[:10], device="cpu").construct())


# ---- tests/test_binary_cache.py, on the port ------------------------------

@pytest.fixture()
def problem():
    rng = np.random.RandomState(0)
    Xp = rng.rand(600, 5)
    y = (Xp[:, 0] * 3 + 0.01 * rng.randn(600)).astype(np.float64)
    return Xp, y


def test_construct_routes_binary_by_magic(tmp_path, problem):
    Xp, y = problem
    p = str(tmp_path / "cache.weird_extension")
    lt.Dataset(Xp, y, params={"max_bin": 63}, device="cpu").construct() \
        .save_binary(p)
    loaded = lt.Dataset(p, device="cpu").construct()
    assert loaded.num_data == len(Xp)
    assert loaded.params.get("max_bin") == 63
    np.testing.assert_allclose(loaded.get_label(), y.astype(np.float32))
    sub = lt.Dataset(p, device="cpu").subset(np.arange(100))
    assert sub.num_data == 100


def test_binary_cache_param_conflicts(tmp_path, problem):
    Xp, y = problem
    p = str(tmp_path / "t.bin")
    lt.Dataset(Xp, y, params={"max_bin": 63, "min_data_in_leaf": 20},
               device="cpu").construct().save_binary(p)
    lt.train({"objective": "regression", "min_data_in_leaf": 50,
              "verbose": -1}, lt.Dataset(p, device="cpu"), 2,
             verbose_eval=False)
    with pytest.raises(LightGBMError, match="Cannot change max_bin"):
        lt.train({"objective": "regression", "max_bin": 128, "verbose": -1},
                 lt.Dataset(p, device="cpu"), 1, verbose_eval=False)


def test_binary_cache_valid_set_mapper_alignment(tmp_path, problem):
    Xp, y = problem
    rng = np.random.RandomState(7)
    tr = lt.Dataset(Xp, y, device="cpu").construct()
    pv = str(tmp_path / "v.bin")
    lt.Dataset(Xp[:200], y[:200], reference=tr).construct().save_binary(pv)
    ev = {}
    lt.train({"objective": "regression", "verbose": -1}, tr, 2,
             valid_sets=[lt.Dataset(pv, reference=tr)], evals_result=ev,
             verbose_eval=False)
    assert "valid_0" in ev
    pv2 = str(tmp_path / "v2.bin")
    lt.Dataset(rng.rand(300, 5) * 2.0, y[:300], device="cpu").construct() \
        .save_binary(pv2)
    with pytest.raises(LightGBMError, match="different bin mappers"):
        lt.train({"objective": "regression", "verbose": -1}, tr, 1,
                 valid_sets=[lt.Dataset(pv2, reference=tr)],
                 verbose_eval=False)


def test_metadata_avoid_inf(problem):
    Xp, y = problem
    seq = np.ones(len(y))
    seq[0] = np.nan
    seq[1] = np.inf
    d = lt.Dataset(Xp, seq, weight=seq, init_score=seq,
                   device="cpu").construct()
    assert d.label[0] == 0.0 and not np.isinf(d.label[1])
    assert d.weight[0] == 0.0 and not np.isinf(d.weight[1])
    assert d.init_score[0] == 0.0 and not np.isinf(d.init_score[1])
    assert d.label[1] == d.weight[1]
    d2 = lt.Dataset(Xp, y, device="cpu").construct()
    d2.set_label(seq)
    d2.set_weight(seq)
    d2.set_init_score(seq)
    assert not np.isnan(d2.label[0])
    assert not np.isinf(d2.weight[1])
    assert not np.isinf(d2.init_score[1])


# ---- tests/test_binning.py's synthetic cases, on the port ------------------

def test_serialization_roundtrip():
    rng = np.random.RandomState(1)
    vals = np.concatenate([rng.randn(500), [np.nan] * 20])
    m = BinMapper()
    m.find_bin(vals, total_sample_cnt=600, max_bin=32, min_data_in_bin=3)
    m2 = BinMapper.from_dict(m.to_dict())
    jm = JBinMapper()
    jm.find_bin(vals, total_sample_cnt=600, max_bin=32, min_data_in_bin=3)
    assert json.dumps(m.to_dict()) == json.dumps(jm.to_dict())
    test_vals = np.concatenate([rng.randn(100), [np.nan, 0.0]])
    np.testing.assert_array_equal(m.value_to_bin(test_vals),
                                  m2.value_to_bin(test_vals))


def test_efb_binary_cache_roundtrip(tmp_path):
    rng = np.random.RandomState(1)
    n = 500
    onehot = np.eye(8)[rng.randint(0, 8, n)]
    Xe = np.column_stack([onehot, rng.randn(n, 2)])
    y = (onehot[:, 0] + rng.randn(n) * 0.1 > 0.5).astype(np.float64)
    ds = lt.Dataset(sps.csr_matrix(Xe.astype(np.float32)), label=y,
                    params={"min_data_in_leaf": 5}, device="cpu").construct()
    assert ds.num_groups < len(ds.used_features)
    path = str(tmp_path / "efb.bin")
    ds.save_binary(path)
    ds2 = lt.Dataset.load_binary(path, device="cpu")
    np.testing.assert_array_equal(ds.host_binned(), ds2.host_binned())
    np.testing.assert_array_equal(ds.feat_group, ds2.feat_group)
    np.testing.assert_array_equal(ds.feat_start, ds2.feat_start)
    bst = lt.train({"objective": "binary", "verbosity": -1, "num_leaves": 7,
                    "min_data_in_leaf": 5}, ds2, 3, verbose_eval=False)
    assert bst.num_trees() == 3


def test_text_prediction_input(files):
    """A training-style CSV (label column first) and a LibSVM file
    predict as their feature matrices."""
    bst = lt.train({"objective": "binary", "num_leaves": 7, "verbose": -1},
                   lt.Dataset(X, label=Y, device="cpu"), 2,
                   verbose_eval=False)
    want = bst.predict(X, device=False)
    got = bst.predict(os.path.join(files, "t.csv"), device=False)
    np.testing.assert_allclose(got, want, rtol=1e-12)
    svm = bst.predict(os.path.join(files, "t.svm"), device=False)
    np.testing.assert_allclose(svm, bst.predict(np.nan_to_num(X),
                                                device=False), rtol=1e-12)
    np.testing.assert_allclose(
        bst.predict(sps.csr_matrix(np.nan_to_num(X))),
        bst.predict(np.nan_to_num(X)), rtol=0)
