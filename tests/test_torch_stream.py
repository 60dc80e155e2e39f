"""Out-of-core streamed training in the port (``lightgbm_tpu_torch/data``)
held against its own resident training and against the JAX package's
streamed training (tests/test_stream.py), on the CPU (the kernels' plain
versions).

- Streamed equals resident BYTE for byte (model text) for every case of
  tests/test_stream.py's ``PARITY_CASES``, f32 included, at blocks of
  256 and 500 rows and at 333 (three blocks and a ragged 201): histogram
  sums are exact integers at scales taken over all rows, so no block
  partition can change a bit.
- The port's streamed text is held to the JAX package's streamed text
  (``LGBM_TPU_STREAM=1``, 256-row blocks, for the JAX side only) as
  tests/test_torch_train.py holds the resident runs (C-3): equal
  structure, leaf values to rtol 1e-4.
- The engine with a valid set, the blockers (the JAX package's warning
  and error texts), DART and rollback, ``update_chunk``, the spill
  store (both ways between the packages, corruption, short reads, an
  unfinalized store), ``BlockPump`` over every block and over a list, and
  the
  planner's verdicts (tests/test_stream.py:367-421, on the port's
  device model) and host model (the JAX package's numbers).
"""

import os

import numpy as np
import pytest

import lightgbm_tpu as lgb
from lightgbm_tpu.config import LightGBMError as JLightGBMError
from lightgbm_tpu.data.blockstore import (BlockStore as JBlockStore,
                                          BlockStoreCorruptError as JCorrupt)
from lightgbm_tpu.dataset import Dataset as JDataset
from lightgbm_tpu.ops.planner import \
    predict_host_peak_bytes as jpredict_host_peak_bytes

import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch.data import (BlockPump, BlockStore,
                                     BlockStoreCorruptError)
from lightgbm_tpu_torch.dataset import Dataset
from lightgbm_tpu_torch.ops.planner import (plan_stream,
                                            predict_host_peak_bytes,
                                            predict_peak_bytes,
                                            stream_override)
from lightgbm_tpu_torch.testing import one_thread  # noqa: F401
from lightgbm_tpu_torch.utils.log import LightGBMError
from test_stream import BASE, F, N, PARITY_CASES, X, XV, Y_BIN, YV_BIN
from test_torch_objectives import assert_same_trees

ROUNDS = 12
PARTITIONS = (256, 500, 333)
Y_MULTI = np.digitize(X[:, 0] + X[:, 1], [-0.5, 0.5]).astype(float)


def _label(case):
    return Y_MULTI if case == "multiclass" else Y_BIN


def _train(params, y, block=None, rounds=ROUNDS):
    """Train on the CPU; ``block``: the streamed block rows (None:
    resident)."""
    ds = lt.Dataset(X, label=y, free_raw_data=False, device="cpu")
    with stream_override(force=block is not None, block_rows=block):
        b = lt.Booster(params=dict(BASE, **params), train_set=ds)
    assert (b.boosting._stream is not None) == (block is not None)
    for _ in range(rounds):
        b.update()
    return b


_resident = {}


def _resident_text(case):
    if case not in _resident:
        _resident[case] = _train(PARITY_CASES[case],
                                 _label(case)).model_to_string()
    return _resident[case]


@pytest.mark.parametrize("block", PARTITIONS)
@pytest.mark.parametrize("case", sorted(PARITY_CASES))
def test_streamed_equals_resident(case, block):
    b = _train(PARITY_CASES[case], _label(case), block)
    g = b.boosting.grower
    assert type(g).__name__ == "StreamGrower"
    nb = g.store.num_blocks
    assert nb == -(-N // block)
    trees = ROUNDS * b.num_tree_per_iteration
    # a pass a tree for the root, one a round; one stop read a round and
    # one after the last (none after a tree's L - 1st round)
    rounds = sum(int(r[1]) for r in g.round_counts)
    assert g.pump.passes == trees + rounds
    assert g.pump.blocks == g.pump.passes * nb
    assert rounds <= g.host_reads <= rounds + trees
    assert b.model_to_string() == _resident_text(case), \
        f"{case}: streamed != resident at {block}-row blocks"


@pytest.fixture(scope="module")
def jax_streamed():
    """The JAX package's streamed runs (its own environment knobs)."""
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("LGBM_TPU_STREAM", "1")
        mp.setenv("LGBM_TPU_STREAM_BLOCK_ROWS", "256")
        for case in ("f32", "quant", "multiclass"):
            ds = lgb.Dataset(X, label=_label(case), free_raw_data=False)
            b = lgb.Booster(params=dict(BASE, **PARITY_CASES[case]),
                            train_set=ds)
            assert b.boosting._stream is not None
            for _ in range(ROUNDS):
                b.update()
            out[case] = b
    return out


@pytest.mark.parametrize("case", ["f32", "quant", "multiclass"])
def test_streamed_matches_the_jax_package(jax_streamed, case):
    bj = jax_streamed[case]
    bt = _train(PARITY_CASES[case], _label(case), 256)
    assert_same_trees(bj, bt, ROUNDS * bt.num_tree_per_iteration)
    np.testing.assert_allclose(bt.predict(XV), bj.predict(XV), rtol=1e-4,
                               atol=1e-6)


def test_engine_train_with_valid_set():
    def run(block):
        ds = lt.Dataset(X, label=Y_BIN, free_raw_data=False, device="cpu")
        vs = ds.create_valid(XV, label=YV_BIN)
        evals = {}
        with stream_override(force=block is not None, block_rows=block):
            bst = lt.train(dict(BASE, metric="binary_logloss"), ds,
                           num_boost_round=10, valid_sets=[vs],
                           evals_result=evals, verbose_eval=False)
        assert (bst.boosting._stream is not None) == (block is not None)
        return bst.model_to_string(), evals

    m_r, ev_r = run(None)
    m_s, ev_s = run(300)
    assert m_s == m_r
    assert ev_s == ev_r


def test_update_chunk_trains_one_iteration_at_a_time():
    ds = lt.Dataset(X, label=Y_BIN, free_raw_data=False, device="cpu")
    with stream_override(force=True, block_rows=256):
        b = lt.Booster(params=dict(BASE), train_set=ds)
    assert not b.boosting.chunk_supported()
    b.update_chunk(4)
    assert b.current_iteration() == 4
    assert b.model_to_string() == _train({}, Y_BIN, None, 4) \
        .model_to_string()


def test_rollback_refuses():
    b = _train({}, Y_BIN, 256, rounds=2)
    with pytest.raises(RuntimeError, match="out-of-core streamed booster"):
        b.rollback_one_iter()


def _pushed(rows, labels, spill=None):
    """``from_sample`` on the first 600 rows of X (so every such set has
    the same bin mappers) and one ``push_rows`` of ``rows``; ``spill``:
    its store's directory (256-row blocks), else resident."""
    ds = Dataset.from_sample(X[:600], len(rows), spill=spill,
                             spill_block_rows=256, device="cpu")
    ds.push_rows(rows)
    ds.set_label(labels)
    return ds


@pytest.mark.parametrize("rows", ["permuted", "fewer"])
@pytest.mark.parametrize("new", ["resident", "block_backed"])
def test_update_with_a_new_train_set_on_a_streamed_booster(rows, new,
                                                           tmp_path):
    """``update(train_set=)`` on a streamed booster elects again for the
    new set and trains on ITS bins: the text of a resident booster given
    the same sets (new rows under the old labels, so that the old bins
    would give other trees; or fewer rows)."""
    X2 = (X[np.random.RandomState(7).permutation(N)] if rows == "permuted"
          else X[:900])
    y2 = Y_BIN[:len(X2)]

    def run(stream):
        spill = (str(tmp_path / f"new_{stream}")
                 if stream and new == "block_backed" else None)
        with stream_override(force=stream, block_rows=256):
            bst = lt.Booster(params=dict(BASE),
                             train_set=_pushed(X, Y_BIN))
            for _ in range(3):
                bst.update()
            ds2 = _pushed(X2, y2, spill)
            bst.update(train_set=ds2)
            bst.update()
        g = bst.boosting
        assert (g._stream is not None) == stream
        if stream:
            assert g.grower.store is ds2._block_store
            assert g.grower.store.num_rows == len(X2)
        return bst.model_to_string()

    assert run(True) == run(False)


def test_reset_parameter_on_a_streamed_booster():
    """A reset to a config the streamed grower does not cover raises
    the blocker and leaves the booster as it was; another reset rebuilds
    the streamed grower."""
    y = X[:, 0]
    params = {"objective": "regression"}
    b = _train(params, y, 256, rounds=2)
    with pytest.raises(LightGBMError, match="monotone_constraints"):
        b.reset_parameter({"monotone_constraints": [1] + [0] * (F - 1)})
    b.reset_parameter({"lambda_l2": 1.0})
    assert type(b.boosting.grower).__name__ == "StreamGrower"
    ref = _train(params, y, None, rounds=2)
    ref.reset_parameter({"lambda_l2": 1.0})
    for bst in (b, ref):
        bst.update()
        bst.update()
    assert b.model_to_string() == ref.model_to_string()


# ------------------------------------------------------------ blockers

X_CAT = X.copy()
X_CAT[:, 2] = np.abs(np.round(X[:, 2] * 2))      # codes 0..6
BLOCKED = {
    "monotone": ({"objective": "regression",
                  "monotone_constraints": [1] + [0] * (F - 1)}, X[:, 0]),
    "categorical": ({"categorical_feature": "2"}, Y_BIN),
    "forced": ({"forcedsplits_filename": "<forced>"}, Y_BIN),
    "extra_trees": ({"extra_trees": True}, Y_BIN),
    "bynode": ({"feature_fraction_bynode": 0.5}, Y_BIN),
    "cegb": ({"cegb_penalty_split": 0.1, "tpu_tree_growth": "auto"},
             Y_BIN),
    "dart": ({"boosting": "dart"}, Y_BIN),
    "rf": ({"boosting": "rf", "bagging_fraction": 0.5, "bagging_freq": 1},
           Y_BIN),
}


def _warning(err: str) -> str:
    """The blocker part of the fallback warning (the reason and the knob
    differ: an environment variable there, ``stream_override`` here)."""
    line = [ln for ln in err.splitlines() if "out-of-core streaming" in ln]
    assert len(line) == 1, err
    return line[0].split("but not supported with ")[1].split(" (")[0]


def _blocked(name, tmp_path):
    params, y = BLOCKED[name]
    params = dict(BASE, verbosity=0, **params)
    if name == "forced":
        path = tmp_path / "forced.json"
        path.write_text('{"feature": 0, "threshold": 0.0}')
        params.update(forcedsplits_filename=str(path),
                      tpu_tree_growth="auto")
    return params, y, (X_CAT if name == "categorical" else X)


@pytest.mark.parametrize("name", sorted(BLOCKED))
def test_blocked_configs_train_resident_with_the_jax_warning(
        name, capsys, monkeypatch, tmp_path):
    params, y, X = _blocked(name, tmp_path)
    ds = lt.Dataset(X, label=y, free_raw_data=False, device="cpu")
    with stream_override(force=True, block_rows=256):
        b = lt.Booster(params=params, train_set=ds)
    assert b.boosting._stream is None and ds._block_store is None
    b.update()
    b.update()
    assert b.num_trees() == 2 * b.num_tree_per_iteration
    port = _warning(capsys.readouterr().err)
    monkeypatch.setenv("LGBM_TPU_STREAM", "1")
    monkeypatch.setenv("LGBM_TPU_STREAM_BLOCK_ROWS", "256")
    lgb.Booster(params=params,
                train_set=lgb.Dataset(X, label=y, free_raw_data=False))
    assert port == _warning(capsys.readouterr().err)


def _spilled(root, lib_dataset, **kw):
    ds = lib_dataset.from_sample(X[:600], N, spill=str(root),
                                 spill_block_rows=256, **kw)
    ds.push_rows(X)
    ds.set_label(Y_BIN)
    return ds


@pytest.mark.parametrize("name", ["monotone", "dart", "extra_trees",
                                  "forced"])
def test_blocked_configs_on_a_block_backed_dataset_raise(name, tmp_path):
    params = _blocked(name, tmp_path)[0]
    with pytest.raises(LightGBMError) as port:
        lt.Booster(params=params, train_set=_spilled(
            tmp_path / "t", Dataset, device="cpu"))
    with pytest.raises(JLightGBMError) as jax_:
        lgb.Booster(params=params, train_set=_spilled(tmp_path / "j",
                                                      JDataset))
    assert str(port.value) == str(jax_.value)
    assert "block-backed" in str(port.value)


def test_block_backed_dataset_streams_and_frees_its_matrix():
    ds = lt.Dataset(X, label=Y_BIN, device="cpu")
    with stream_override(force=True, block_rows=256):
        lt.Booster(params=dict(BASE), train_set=ds)
    # free_raw_data (the default) frees binned_t once it is spilled
    assert ds.binned_t is None and ds._block_store is not None
    assert ds.binned_shape() == (N, ds.num_groups)
    with pytest.raises(RuntimeError, match="block store"):
        ds.host_binned()
    # a later booster streams the store even where residency fits
    b = lt.Booster(params=dict(BASE), train_set=ds)
    assert b.boosting._stream is not None
    assert "block-backed" in b.boosting.stream_plan.reason
    kept = lt.Dataset(X, label=Y_BIN, device="cpu", free_raw_data=False)
    with stream_override(force=True, block_rows=256):
        lt.Booster(params=dict(BASE), train_set=kept)
    assert kept.binned_t is not None and kept._block_store is not None


def test_corrupt_block_fails_training_loudly():
    ds = lt.Dataset(X, label=Y_BIN, free_raw_data=False, device="cpu")
    with stream_override(force=True, block_rows=256):
        b = lt.Booster(params=dict(BASE), train_set=ds)
    b.update()
    store = ds._block_store
    victim = os.path.join(store.path, "block_00002.bin")
    raw = bytearray(open(victim, "rb").read())
    raw[3] ^= 0x40
    with open(victim, "wb") as fh:
        fh.write(raw)
    store._verified.discard(2)                     # a fresh process's read
    with pytest.raises(BlockStoreCorruptError, match="checksum"):
        b.update()


# ---------------------------------------------------------- block store

def _rows(seed, n, g):
    return np.random.RandomState(seed).randint(0, 255, (n, g),
                                               dtype=np.uint8)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_stores_pass_both_ways(tmp_path, writer):
    arr = _rows(0, 1000, 7)
    W, R = (BlockStore, JBlockStore) if writer == "port" \
        else (JBlockStore, BlockStore)
    st = W.create(str(tmp_path / "st"), 1000, 7, np.uint8, 256)
    for lo, hi in ((0, 50), (50, 600), (600, 1000)):     # uneven appends
        st.append_rows(arr[lo:hi])
    st.finalize()
    other = R.open(str(tmp_path / "st"))
    assert (other.num_blocks, other.block_rows, other.nbytes()) == (
        4, 256, 7000)
    got = np.concatenate([np.asarray(other.read_block(i)).T
                          for i in range(other.num_blocks)])
    np.testing.assert_array_equal(got, arr)
    assert other._blocks == st._blocks               # the manifest
    ref = W.from_array(str(tmp_path / "again"), arr, 256)
    for i in range(4):
        with open(os.path.join(ref.path, f"block_{i:05d}.bin"), "rb") as a, \
                open(os.path.join(st.path, f"block_{i:05d}.bin"), "rb") as b:
            assert a.read() == b.read()


def _corrupt(path):
    victim = os.path.join(path, "block_00001.bin")
    raw = bytearray(open(victim, "rb").read())
    raw[17] ^= 0xFF
    with open(victim, "wb") as fh:
        fh.write(raw)


def _truncate(path):
    victim = os.path.join(path, "block_00001.bin")
    raw = open(victim, "rb").read()
    with open(victim, "wb") as fh:
        fh.write(raw[:-9])


@pytest.mark.parametrize("damage", [_corrupt, _truncate],
                         ids=["checksum", "short"])
def test_damaged_store_raises_in_both_packages(tmp_path, damage):
    arr = _rows(2, 600, 5)
    path = str(tmp_path / "st")
    BlockStore.from_array(path, arr, 256)
    damage(path)
    for Store, Err in ((BlockStore, BlockStoreCorruptError),
                       (JBlockStore, JCorrupt)):
        st = Store.open(path)
        st.read_block(0)                            # an intact block
        buf = np.empty((5, st.block_rows), np.uint8)
        with pytest.raises(Err):
            st.read_block(1, out=buf, verify=True)
        with pytest.raises(Err):
            Store.open(path).read_block(1)
    with pytest.raises(BlockStoreCorruptError):
        for _ in BlockPump(BlockStore.open(path), device="cpu"):
            pass


def test_unfinalized_store_is_refused_in_both_packages(tmp_path):
    st = BlockStore.create(str(tmp_path / "st"), 100, 3, np.uint8, 64)
    st.append_rows(np.zeros((100, 3), np.uint8))
    for Store, Err in ((BlockStore, BlockStoreCorruptError),
                       (JBlockStore, JCorrupt)):
        with pytest.raises(Err, match="manifest"):
            Store.open(str(tmp_path / "st"))
    with pytest.raises(RuntimeError, match="not finalized"):
        st.read_block(0)
    st.finalize()
    assert JBlockStore.open(str(tmp_path / "st")).num_blocks == 2


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
def test_block_pump_reads_the_blocks_asked_for(tmp_path, dtype):
    """A pass yields every block's [G, rows] transpose in order (uint16
    widened to int32); ``blocks=`` yields exactly those blocks, equal to
    the full pass's."""
    arr = np.random.RandomState(4).randint(0, 1000 if dtype == np.uint16
                                           else 255, (1000, 6)).astype(dtype)
    st = BlockStore.from_array(str(tmp_path / "st"), arr, 128)
    pump = BlockPump(st, device="cpu")
    full = [(i, s, r, blk.numpy()) for (i, s, r, blk) in pump]
    assert pump.blocks == 8 and pump.passes == 1
    assert [x[:3] for x in full] == [(i, 128 * i, min(128, 1000 - 128 * i))
                                     for i in range(8)]
    for _, s, r, a in full:
        np.testing.assert_array_equal(a, arr[s:s + r].T)
        assert a.dtype == (np.uint8 if dtype == np.uint8 else np.int32)
    some = BlockPump(st, device="cpu", blocks=[1, 4, 7])
    got = [(i, s, r, blk.numpy()) for (i, s, r, blk) in some]
    assert [x[:3] for x in got] == [full[i][:3] for i in (1, 4, 7)]
    for (i, _, _, a) in got:
        np.testing.assert_array_equal(a, full[i][3])
    assert some.blocks == 3 and some.passes == 1


# -------------------------------------------------------------- planner

def test_plan_stream_resident_when_both_fit():
    p = plan_stream(rows=10_000, features=8, num_bins=64,
                    device_budget_bytes=1 << 33, host_budget_bytes=1 << 33)
    assert not p.stream and p.feasible
    assert p.resident_device_ok and p.resident_host_ok
    assert p.reason == "resident fits both budgets"


def test_plan_stream_elects_on_device_budget():
    # 50 M rows: the resident peak on the port's model is 7.35 GB, the
    # streamed one 5.22 GB at 2**24-row blocks; a 6 GiB card (5.48 GB
    # after the headroom) holds only the streamed run
    assert predict_peak_bytes(50_000_000, 28, 64)[0] > 6 << 30
    p = plan_stream(rows=50_000_000, features=28, num_bins=64,
                    device_budget_bytes=6 << 30, host_budget_bytes=1 << 40)
    assert p.stream and not p.resident_device_ok and p.resident_host_ok
    assert "device" in p.reason
    assert p.block_rows > 0 and p.num_blocks >= 2
    assert p.predicted_device_peak_bytes <= p.device_budget_bytes


def test_plan_stream_elects_on_host_budget():
    p = plan_stream(rows=50_000_000, features=28, num_bins=64,
                    device_budget_bytes=1 << 40, host_budget_bytes=2 << 30)
    assert p.stream and p.resident_device_ok and not p.resident_host_ok
    assert "host" in p.reason
    assert p.predicted_host_peak_bytes <= p.host_budget_bytes


def test_plan_stream_infeasible_verdict():
    p = plan_stream(rows=1_000_000_000, features=28, num_bins=64,
                    device_budget_bytes=1 << 26, host_budget_bytes=1 << 26)
    assert p.stream and not p.feasible


def test_plan_stream_override():
    with stream_override(force=False):
        p = plan_stream(rows=50_000_000, features=28, num_bins=64,
                        device_budget_bytes=1 << 28,
                        host_budget_bytes=1 << 28)
    assert not p.stream and "disabled" in p.reason
    with stream_override(force=True, block_rows=4096):
        p = plan_stream(rows=100_000, features=8, num_bins=64,
                        device_budget_bytes=1 << 33,
                        host_budget_bytes=1 << 33)
    assert p.stream and p.block_rows == 4096 and p.num_blocks == 25
    # the override ends with its block
    assert not plan_stream(rows=100_000, features=8, num_bins=64,
                           device_budget_bytes=1 << 33,
                           host_budget_bytes=1 << 33).stream


def test_host_peak_model_is_the_jax_packages():
    for args in ((100_000_000, 28, 1), (100_000_000, 28, 1, 1 << 20),
                 (100_000_000, 28, 1, 1 << 16), (5_000, 674, 2, 4096)):
        assert predict_host_peak_bytes(*args) == \
            jpredict_host_peak_bytes(*args)
    res = predict_host_peak_bytes(100_000_000, 28, 1)[0]
    stream = predict_host_peak_bytes(100_000_000, 28, 1, 1 << 20)[0]
    assert stream < res / 4
    assert predict_host_peak_bytes(100_000_000, 28, 1, 1 << 16)[0] < stream


def test_ingest_pump_over_two_devices_stores_the_same_bytes():
    """``IngestPump(devices=)``: chunks dealt over the devices as the JAX
    package deals them (``plan_devices`` + ``plan_block_shards``,
    round-robin here), each binned on its device (B3's plain version on
    the CPU), and the binned matrix is the one-device pump's, byte for
    byte."""
    from lightgbm_tpu.data.score import plan_block_shards as jshards
    from lightgbm_tpu.fleet.topology import plan_devices as jplan
    from lightgbm_tpu_torch.data import IngestPump
    X32 = X.astype(np.float32)
    ds = Dataset(X32, label=Y_BIN, device="cpu").construct()

    def binned(pump):
        parts = {}
        for i, s, r, chunk in pump:
            assert chunk.device.type == "cpu" and chunk.shape[0] == r
            parts[s] = ds._bin_rows(chunk).numpy()
        return np.concatenate([parts[s] for s in sorted(parts)], axis=1)

    one = IngestPump(X32, 256, device="cpu")
    two = IngestPump(X32, 256, devices=["cpu", "cpu"])
    assert two.owner == list(jshards(two.num_chunks, jplan(2)))
    assert set(two.owner) == {0, 1}
    got = binned(two)
    assert np.array_equal(got, binned(one))
    assert np.array_equal(got, ds.binned_t.numpy())
    assert two.blocks == two.num_chunks
    with pytest.raises(ValueError, match="one type"):
        IngestPump(X32, 256, devices=["cpu", "meta"])
