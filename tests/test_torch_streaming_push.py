"""Streamed Dataset construction in the port (``Dataset.from_sample`` +
``push_rows``, ``from_reference_streaming``, spill stores, the
construct-time spill) held against the JAX package's
(tests/test_streaming_push.py, tests/test_stream.py's push cases) on the
CPU, where B3 runs as its plain version.

- The binned bytes equal the JAX package's and a bulk construct's, for
  dense, CSR, ragged and out-of-order pushes, f32 and f64 rows.
- The overlap, spill-gap and "first unpushed row" errors carry the JAX
  package's messages; the guards raise as there.
- A spilled Dataset's store holds the resident matrix's bytes block by
  block, opens in the JAX package with the same bytes and manifest, and
  trains to the resident model text.
"""

import json
import os

import numpy as np
import pytest

import lightgbm_tpu as lgb
from lightgbm_tpu.data.blockstore import BlockStore as JBlockStore
from lightgbm_tpu.dataset import Dataset as JDataset

import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch.data import BlockStore
from lightgbm_tpu_torch.dataset import Dataset
from lightgbm_tpu_torch.ops import planner
from lightgbm_tpu_torch.testing import one_thread  # noqa: F401

PARAMS = {"objective": "binary", "num_leaves": 7, "verbosity": -1,
          "tpu_tree_growth": "rounds"}


def _xy(n=4000, f=6, seed=0, dtype=np.float64):
    rng = np.random.RandomState(seed)
    X = rng.rand(n, f)
    X[rng.rand(n, f) < 0.1] = np.nan          # missing bins
    y = (np.nan_to_num(X[:, 0]) + np.nan_to_num(X[:, 1])
         > 1.0).astype(np.float32)
    return X.astype(dtype), y


def _jax_pushed(sample, X, pushes, **kw):
    ds = JDataset.from_sample(sample, len(X), **kw)
    for lo, hi in pushes:
        ds.push_rows(X[lo:hi], start_row=lo)
    return ds


def _port_pushed(sample, X, pushes, **kw):
    ds = Dataset.from_sample(sample, len(X), device="cpu", **kw)
    for lo, hi in pushes:
        ds.push_rows(X[lo:hi], start_row=lo)
    return ds


UNEVEN = [(lo, min(lo + 700, 4000)) for lo in range(0, 4000, 700)]
OUT_OF_ORDER = [(2500, 4000), (0, 900), (900, 2500)]


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("pushes", [UNEVEN, OUT_OF_ORDER],
                         ids=["ragged", "out_of_order"])
def test_pushed_bytes_equal_the_jax_package_and_a_bulk_construct(dtype,
                                                                 pushes):
    X, y = _xy(dtype=dtype)
    jds = _jax_pushed(X[:1000], X, pushes)
    tds = _port_pushed(X[:1000], X, pushes)
    assert tds.constructed and jds.constructed
    assert tds.used_features == jds.used_features
    np.testing.assert_array_equal(tds.host_binned(), jds.binned)
    assert tds.bin_route == ("kernel" if dtype == np.float32 else "host")
    # the sample equal to every row: the bulk construct's bytes
    bulk = lt.Dataset(X, label=y, device="cpu",
                      params={"bin_construct_sample_cnt": 10 ** 9})
    full = _port_pushed(X, X, pushes)
    np.testing.assert_array_equal(full.host_binned(),
                                  bulk.construct().host_binned())
    assert full.used_features == bulk.used_features


def test_csr_and_dense_chunks_bin_alike():
    sps = pytest.importorskip("scipy.sparse")
    n, f = 2000, 20
    Xs = sps.random(n, f, density=0.1, random_state=0, format="csr",
                    dtype=np.float32)
    Xd = Xs.toarray()
    params = {"min_data_in_leaf": 5}
    tds = Dataset.from_sample(Xd[:500], n, params=params, device="cpu")
    tds.push_rows(Xs[:1200])                   # a sparse chunk
    tds.push_rows(Xd[1200:])                   # a dense chunk
    jds = JDataset.from_sample(Xd[:500], n, params=params)
    jds.push_rows(Xs[:1200])
    jds.push_rows(Xd[1200:])
    np.testing.assert_array_equal(tds.host_binned(), jds.binned)
    dense = Dataset.from_sample(Xd[:500], n, params=params, device="cpu")
    dense.push_rows(Xd)
    np.testing.assert_array_equal(tds.host_binned(), dense.host_binned())
    # the sample equal to every row: a bulk CSR construct's bytes
    full = Dataset.from_sample(Xd, n, params=params, device="cpu")
    full.push_rows(Xs[:700])
    full.push_rows(Xs[700:])
    bulk = lt.Dataset(Xs, device="cpu",
                      params=dict(params, bin_construct_sample_cnt=10 ** 9))
    np.testing.assert_array_equal(full.host_binned(),
                                  bulk.construct().host_binned())


def _message(fn):
    with pytest.raises((ValueError, RuntimeError)) as e:
        fn()
    return type(e.value), str(e.value)


def _errors(ds, X) -> dict:
    ds.push_rows(X[:400])
    return {"overlap": _message(lambda: ds.push_rows(X[300:600],
                                                     start_row=300)),
            "gap": _message(ds.construct),
            "past": _message(lambda: ds.push_rows(X[:1000],
                                                  start_row=900))}


def test_errors_carry_the_jax_package_messages(tmp_path):
    X, _ = _xy(n=1200, dtype=np.float32)
    port = _errors(Dataset.from_sample(X[:300], 1200, device="cpu"), X)
    jax_ = _errors(JDataset.from_sample(X[:300], 1200), X)
    assert port == jax_
    assert "first unpushed row: 400" in port["gap"][1]
    spills = []
    for ds in (JDataset.from_sample(X[:300], 1200, spill=str(tmp_path / "j"),
                                    spill_block_rows=256),
               Dataset.from_sample(X[:300], 1200, spill=str(tmp_path / "t"),
                                   spill_block_rows=256, device="cpu")):
        ds.push_rows(X[:400])
        spills.append(_message(lambda: ds.push_rows(X[600:],
                                                    start_row=600)))
    assert spills[0] == spills[1]
    assert "append in order" in spills[1][1]


def test_push_guards():
    X, y = _xy(n=100)
    ds = Dataset.from_sample(X, 100, device="cpu")
    with pytest.raises(ValueError, match="push past the end"):
        ds.push_rows(np.random.rand(200, X.shape[1]))
    ds.push_rows(X)
    with pytest.raises(RuntimeError, match="already finished"):
        ds.push_rows(X[:1])
    with pytest.raises(RuntimeError, match="from_sample"):
        lt.Dataset(X, label=y, device="cpu").push_rows(X[:1])


def test_from_reference_streaming_bins_with_the_reference():
    X, y = _xy()
    ref = lt.Dataset(X[:3000], label=y[:3000], device="cpu").construct()
    vs = Dataset.from_reference_streaming(ref, 1000)
    vs.push_rows(X[3000:3500])
    vs.push_rows(X[3500:])
    assert vs.constructed and vs.device == ref.device
    want = ref.create_valid(X[3000:], label=y[3000:]).construct()
    np.testing.assert_array_equal(vs.host_binned(), want.host_binned())
    jref = JDataset(X[:3000], label=y[:3000]).construct()
    jvs = JDataset.from_reference_streaming(jref, 1000)
    jvs.push_rows(X[3000:])
    np.testing.assert_array_equal(vs.host_binned(), jvs.binned)


def test_spilled_dataset_matches_resident_and_trains_alike(tmp_path):
    X, y = _xy(dtype=np.float32)
    pushes = [(lo, min(lo + 700, 4000)) for lo in range(0, 4000, 700)]
    spilled = _port_pushed(X[:1000], X, pushes,
                           spill=str(tmp_path / "st"), spill_block_rows=512)
    assert spilled.constructed and spilled.binned_t is None
    store = spilled._block_store
    assert store.num_blocks == 8
    assert spilled.binned_shape() == (4000, spilled.num_groups)
    with pytest.raises(RuntimeError, match="block store"):
        spilled.host_binned()
    resident = _port_pushed(X[:1000], X, pushes)
    whole = resident.host_binned()
    for i in range(store.num_blocks):
        s, r = store.block_bounds(i)
        np.testing.assert_array_equal(np.asarray(store.read_block(i)),
                                      whole[s:s + r].T)
    # the JAX package's push of the same rows spills the same store
    jds = _jax_pushed(X[:1000], X, pushes, spill=str(tmp_path / "jst"),
                      spill_block_rows=512)
    jstore = jds._block_store
    for name in ["manifest.json"] + [f"block_{i:05d}.bin"
                                     for i in range(8)]:
        with open(os.path.join(store.path, name), "rb") as a, \
                open(os.path.join(jstore.path, name), "rb") as b:
            assert a.read() == b.read(), name
    spilled.set_label(y)
    resident.set_label(y)
    bs = lt.Booster(params=PARAMS, train_set=spilled)
    assert bs.boosting._stream is not None
    br = lt.Booster(params=PARAMS, train_set=resident)
    assert br.boosting._stream is None
    for _ in range(5):
        bs.update()
        br.update()
    assert bs.model_to_string() == br.model_to_string()


def test_construct_spills_when_the_card_cannot_hold_the_matrix(monkeypatch):
    X, y = _xy(n=3000, dtype=np.float32)
    params = dict(PARAMS, num_leaves=15)
    resident = lt.Dataset(X, label=y, device="cpu", params=params)
    br = lt.Booster(params=params, train_set=resident)
    # a card of 64 KiB: training resident does not fit
    monkeypatch.setattr(planner, "device_limit_bytes",
                        lambda device: (1 << 16, "test"))
    monkeypatch.setattr(planner, "INGEST_CHUNK_ROWS", 700)
    ds = lt.Dataset(X, label=y, device="cpu", params=params).construct()
    assert ds.binned_t is None and ds._block_store is not None
    assert ds.bin_route == "kernel"
    np.testing.assert_array_equal(
        np.concatenate([np.asarray(ds._block_store.read_block(i)).T
                        for i in range(ds._block_store.num_blocks)]),
        resident.host_binned())
    bs = lt.Booster(params=params, train_set=ds)
    assert bs.boosting._stream is not None
    for _ in range(4):
        bs.update()
        br.update()
    assert bs.model_to_string() == br.model_to_string()


def test_stale_store_is_dropped_when_the_dataset_rebins():
    X, y = _xy(n=1500, dtype=np.float32)
    ds = lt.Dataset(X, label=y, device="cpu", free_raw_data=False)
    with planner.stream_override(force=True, block_rows=512):
        lt.Booster(params=PARAMS, train_set=ds)
    store = ds._block_store
    assert store is not None and ds.binned_t is not None
    assert os.path.isdir(store.path)
    lt.Booster(params=dict(PARAMS, max_bin=31), train_set=ds)
    assert ds._block_store is None and not os.path.isdir(store.path)
    assert json.loads(json.dumps(ds.params))["max_bin"] == 31
