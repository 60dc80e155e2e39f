"""The port's configuration, bin mappers, Dataset and binning kernel
(plain version) held against the JAX package's.

``Config`` and ``BinMapper`` are copies and must resolve to the same
values; the Dataset's binned matrix, EFB layout and ``FeatureMeta`` must
be the same bytes; the plain version of the binning kernel
(``lightgbm_tpu_torch/ops/ingest.py``) must give the bytes of the JAX
``DeviceBinner`` in Pallas interpret mode and of the host oracle
``_bin_block``.  The CUDA kernel is held against the same oracle on the
card by chip_smoke.py.
"""

import dataclasses

import numpy as np
import pytest
import torch

import lightgbm_tpu as lgb
from lightgbm_tpu import binning as jbin
from lightgbm_tpu.config import Config as JConfig
from lightgbm_tpu.ops import ingest as jing

import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch import binning as tbin
from lightgbm_tpu_torch.config import Config as TConfig
from lightgbm_tpu_torch.ops import ingest as ting

PARAMS = [
    {},
    {"objective": "binary", "num_leaves": 255, "max_bin": 255,
     "learning_rate": 0.1, "metric": "auc,binary_logloss"},
    {"application": "regression", "num_iterations": 7, "bagging_fraction":
     0.8, "bagging_freq": 1, "feature_fraction": 0.8, "min_data": 5},
    {"objective": "binary", "is_unbalance": True, "lambda_l1": 0.5,
     "reg_lambda": 2.0, "min_sum_hessian_in_leaf": 1.0,
     "tpu_round_width": 16, "tpu_hist_method": "fused",
     "tpu_tree_growth": "rounds", "zero_as_missing": True},
    {"boosting_type": "goss", "num_class": 1, "max_depth": 5,
     "metric": ["l2", "l1"], "use_missing": False, "seed": 3},
]


@pytest.mark.parametrize("params", PARAMS)
def test_config_resolves_like_the_jax_package(params):
    j = dataclasses.asdict(JConfig.from_params(dict(params)))
    t = dataclasses.asdict(TConfig.from_params(dict(params)))
    assert t == j
    assert (TConfig.from_params(dict(params)).split_hyperparams()._asdict()
            == JConfig.from_params(dict(params)).split_hyperparams()
            ._asdict())


def _columns(seed=0, n=1500):
    rng = np.random.RandomState(seed)
    normal = rng.randn(n)
    nan = rng.randn(n) * 3
    nan[rng.rand(n) < 0.1] = np.nan
    zeros = np.where(rng.rand(n) < 0.4, 0.0, rng.exponential(2.0, n))
    return {
        "normal": normal, "nan": nan, "zeros": zeros,
        "constant": np.full(n, 1.5),
        "few_unique": rng.choice([-1.0, 0.0, 2.5], n),
        "integers": rng.randint(0, 40, n).astype(np.float64),
        "f32_grid": rng.randn(n).astype(np.float32).astype(np.float64),
    }


@pytest.mark.parametrize("max_bin", [15, 63, 255])
@pytest.mark.parametrize("zero_as_missing", [False, True])
def test_bin_mappers_match(max_bin, zero_as_missing):
    for name, col in _columns().items():
        keep = np.isnan(col) | (np.abs(col) > 1e-35)
        out = []
        for mod in (jbin, tbin):
            m = mod.BinMapper()
            m.find_bin(col[keep], len(col), max_bin, min_data_in_bin=3,
                       min_split_data=20, pre_filter=True,
                       zero_as_missing=zero_as_missing)
            out.append(m)
        j, t = out
        jb = np.asarray(j.bin_upper_bound, np.float64)
        tb = np.asarray(t.bin_upper_bound, np.float64)
        assert jb.tobytes() == tb.tobytes(), name
        for attr in ("num_bin", "missing_type", "default_bin",
                     "most_freq_bin", "is_trivial", "min_val", "max_val"):
            assert np.asarray(getattr(j, attr)).tobytes() == \
                np.asarray(getattr(t, attr)).tobytes(), (name, attr)


def _matrix(seed=1, n=1500, dtype=np.float32):
    cols = _columns(seed, n)
    return np.stack(list(cols.values()), axis=1).astype(dtype)


def _pair(X, params):
    y = np.arange(len(X)) % 2
    j = lgb.Dataset(X, label=y, params=dict(params)).construct()
    t = lt.Dataset(X, label=y, params=dict(params), device="cpu").construct()
    return j, t


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("params", [
    {"max_bin": 63}, {"max_bin": 255, "zero_as_missing": True},
    {"max_bin": 31, "enable_bundle": False}])
def test_dataset_bytes_match(dtype, params):
    X = _matrix(dtype=dtype)
    j, t = _pair(X, params)
    assert t.used_features == j.used_features
    assert np.array_equal(t.feat_group, j.feat_group)
    assert np.array_equal(t.feat_start, j.feat_start)
    assert t.binned_dtype() == j.binned_dtype()
    assert t.binned_shape() == j.binned_shape()
    hb = t.host_binned()
    assert hb.dtype == j.binned.dtype
    assert np.array_equal(hb, j.binned)
    jm, tm = j.feature_meta(), t.feature_meta()
    for f in ("num_bin", "missing_type", "default_bin", "most_freq_bin",
              "is_categorical", "feat_group", "feat_start"):
        assert np.array_equal(getattr(jm, f), getattr(tm, f)), f
    for f in ("max_num_bin", "num_groups", "max_group_bin"):
        assert getattr(jm, f) == getattr(tm, f), f


def test_efb_groups_match():
    """Sparse, mutually exclusive columns bundle the same way."""
    rng = np.random.RandomState(4)
    n = 2000
    X = np.zeros((n, 8), np.float32)
    owner = rng.randint(0, 8, n)
    X[np.arange(n), owner] = rng.rand(n).astype(np.float32) + 0.5
    j, t = _pair(X, {"max_bin": 15})
    assert j.num_groups < 8          # the columns did bundle
    assert np.array_equal(t.feat_group, j.feat_group)
    assert np.array_equal(t.feat_start, j.feat_start)
    assert np.array_equal(t.host_binned(), j.binned)


def test_create_valid_bins_with_the_reference_mappers():
    X = _matrix()
    j, t = _pair(X, {"max_bin": 63})
    Xv = _matrix(seed=9, n=400)
    jv = j.create_valid(Xv, label=np.zeros(400)).construct()
    tv = t.create_valid(Xv, label=np.zeros(400)).construct()
    assert tv.device == t.device
    assert np.array_equal(tv.host_binned(), jv.binned)


@pytest.mark.parametrize("params", [{"max_bin": 63},
                                    {"max_bin": 15, "zero_as_missing": True}])
def test_binning_plain_version_matches_jax_kernel_and_oracle(params):
    X = _matrix()
    X[:, 5] = np.floor(np.abs(X[:, 5]))        # a categorical column
    params = dict(params, categorical_feature=[5], enable_bundle=False)
    j, t = _pair(X, params)
    rows = np.concatenate([
        jing.salt_rows(X.shape[1], X), ting.salt_rows(X.shape[1], X),
        _matrix(seed=7, n=700)]).astype(np.float32)
    rows[-50:, 5] = np.array([-3.0, 1e9, 7.7, -0.5, 2 ** 31] * 10,
                             np.float32)
    jt = jing.build_ingest_tables(j)
    tt = ting.build_ingest_tables(t)
    assert np.array_equal(jt.bounds, tt.bounds)
    assert np.array_equal(jt.cats, tt.cats)
    got = ting.DeviceBinner(tt, "cpu")(torch.from_numpy(rows))
    assert got.dtype == torch.uint8 and got.shape == (t.num_groups,
                                                       len(rows))
    jax_out = np.asarray(jing.DeviceBinner(jt, tile_rows=256,
                                           interpret=True)(rows))
    oracle = np.zeros((len(rows), t.num_groups), np.uint8)
    with np.errstate(invalid="ignore"):
        t._bin_block(rows.astype(np.float64), oracle)
    assert np.array_equal(got.numpy().T, jax_out)
    assert np.array_equal(got.numpy().T, oracle)


def test_binner_refuses_bad_input():
    X = _matrix()
    _, t = _pair(X, {"max_bin": 15, "enable_bundle": False})
    binner = ting.DeviceBinner(ting.build_ingest_tables(t), "cpu")
    with pytest.raises(ValueError):
        binner(torch.zeros((4, X.shape[1]), dtype=torch.float64))
    with pytest.raises(ValueError):
        binner(torch.zeros((4, X.shape[1] + 1), dtype=torch.float32))


def test_dataset_refuses_input_it_does_not_bin():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        lt.Dataset("train.csv", device="cpu").construct()
