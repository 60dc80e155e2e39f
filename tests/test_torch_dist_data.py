"""The port's distributed Dataset construction (``lightgbm_tpu_torch/
parallel/dist_data.py``; reference: DatasetLoader::
ConstructBinMappersFromTextData, distributed branch,
src/io/dataset_loader.cpp:913-1000): tests/test_dist_data.py's cases on
the port, over four simulated ranks (``make_fake_allgather``), and once
over a real gloo group (``lightgbm_tpu_torch.testing.thread_ranks``) on
float32 rows, which each rank bins through B3's plain version."""
import threading

import numpy as np

import lightgbm_tpu as lgb

import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch.dataset import Dataset
from lightgbm_tpu_torch.parallel.dist_data import (construct_distributed,
                                                   make_fake_allgather)
from lightgbm_tpu_torch.testing import thread_ranks
from lightgbm_tpu_torch.testing import one_thread  # noqa: F401

WORLD = 4


def _global_data(n=6000, f=7, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.rand(n, f)
    X[:, 3] = np.where(rng.rand(n) < 0.6, 0.0, X[:, 3])   # sparse-ish col
    y = (X[:, 0] + X[:, 1] > 1.0).astype(np.float32)
    return X, y


def _bounds(n, world=WORLD):
    return np.linspace(0, n, world + 1).astype(int)


def _run_ranks(X, y, world=WORLD, params=None):
    """Each rank holds a contiguous row slice; returns the ranks'
    Datasets (every join has a timeout)."""
    fn_for = make_fake_allgather(world, timeout=120)
    b = _bounds(len(X), world)
    out, errs = [None] * world, []

    def runner(r):
        try:
            out[r] = construct_distributed(
                X[b[r]:b[r + 1]], label=y[b[r]:b[r + 1]],
                params=params or {}, rank=r, world=world,
                allgather_bytes=fn_for(r), device="cpu")
        except Exception as e:       # pragma: no cover - surfaced below
            errs.append((r, e))

    threads = [threading.Thread(target=runner, args=(r,))
               for r in range(world)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not errs, errs
    assert not any(t.is_alive() for t in threads)
    return out


def test_all_ranks_agree_on_mappers_and_layout():
    X, y = _global_data()
    parts = _run_ranks(X, y)
    ref = parts[0]
    for ds in parts[1:]:
        assert ds.used_features == ref.used_features
        assert ds.num_groups == ref.num_groups
        np.testing.assert_array_equal(ds.feat_group, ref.feat_group)
        np.testing.assert_array_equal(ds.feat_start, ref.feat_start)
        for ma, mb in zip(ds.bin_mappers, ref.bin_mappers):
            assert ma.num_bin == mb.num_bin
            np.testing.assert_array_equal(ma.bin_upper_bound,
                                          mb.bin_upper_bound)


def test_local_binned_matches_global_construct():
    """The ranks' binned rows, stacked, equal a one-process construct
    that samples every row (each rank samples all its rows too), and
    the JAX package's; over a gloo group, f32 rows bin through B3."""
    X, y = _global_data()
    parts = _run_ranks(X, y)
    stacked = np.concatenate([ds.host_binned() for ds in parts], axis=0)
    params = {"bin_construct_sample_cnt": 10 ** 9}
    bulk = Dataset(X, label=y, params=params, device="cpu").construct()
    assert parts[0].used_features == bulk.used_features
    np.testing.assert_array_equal(stacked, bulk.host_binned())
    jax_bulk = lgb.Dataset(X, label=y, params=params).construct()
    np.testing.assert_array_equal(stacked, jax_bulk.binned)

    X32 = X.astype(np.float32)
    b = _bounds(len(X))

    def rank(r, group):
        return construct_distributed(X32[b[r]:b[r + 1]],
                                     label=y[b[r]:b[r + 1]], device="cpu")
    parts32 = thread_ranks(WORLD, rank)
    assert {ds.bin_route for ds in parts32} == {"kernel"}
    bulk32 = Dataset(X32, label=y, params=params, device="cpu").construct()
    np.testing.assert_array_equal(
        np.concatenate([ds.host_binned() for ds in parts32]),
        bulk32.host_binned())


def test_distributed_parts_train():
    """A rank's local Dataset trains through the normal engine."""
    X, y = _global_data()
    parts = _run_ranks(X, y, params={"min_data_in_leaf": 5})
    bst = lt.train({"objective": "binary", "num_leaves": 7,
                    "verbosity": -1, "min_data_in_leaf": 5},
                   parts[0], num_boost_round=3)
    assert bst.predict(X[:10]).shape == (10,)
