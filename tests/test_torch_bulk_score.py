"""Bulk offline scoring in the port (``lightgbm_tpu_torch/data/score.py``)
held against the JAX package's (tests/test_bulk_score.py) on the CPU,
where B1 runs as its plain version.

- ``ScoreSink`` round-trips, resumes, and refuses a foreign geometry, a
  corrupt block and a wrong shape; a sink written by either package
  opens in the other.
- Banked scores equal ``predict_raw_padded`` and ``Booster.predict
  (raw_score=True)`` on the path the serving epilogue elects (the host
  float64 path for these real-valued forests) bit for bit, and the JAX
  package's ``BulkScorer`` on the same store byte for byte (the score
  files and the manifest).
- A run stopped after some blocks and resumed by a fresh scorer banks
  byte-identical files; two specs each bank only their own blocks; a
  non-f32 store and the arguments of other queues raise.
"""

import filecmp
import os

import numpy as np
import pytest

import lightgbm_tpu as lgb
from lightgbm_tpu.data.blockstore import BlockStore as JBlockStore
from lightgbm_tpu.data.score import BulkScorer as JBulkScorer
from lightgbm_tpu.data.score import ScoreSink as JScoreSink
from lightgbm_tpu.predict import DeviceForest as JDeviceForest

import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch.data import (BlockStore, BulkScorer, DeviceSpec,
                                     ScoreSink, ScoreSinkError,
                                     plan_block_shards)
from lightgbm_tpu_torch.ops import predict_kernels as pk
from lightgbm_tpu_torch.predict import DeviceForest
from lightgbm_tpu_torch.testing import one_thread  # noqa: F401

BLOCK_ROWS = 512
ROWS = 2200           # 5 blocks, a ragged last one (2200 = 4 * 512 + 152)


def _mk_sink(path, num_blocks=3, num_class=1, lib=ScoreSink):
    return lib.open_or_create(
        str(path), num_rows=num_blocks * BLOCK_ROWS, num_class=num_class,
        block_rows=BLOCK_ROWS, num_blocks=num_blocks, model_digest="d1")


def test_sink_write_read_roundtrip(tmp_path):
    sink = _mk_sink(tmp_path / "s")
    b0 = np.random.RandomState(0).randn(1, BLOCK_ROWS)
    sink.write_block(0, b0)
    assert sink.banked() == {0} and not sink.complete
    np.testing.assert_array_equal(sink.read_block(0), b0)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_sinks_pass_both_ways_and_resume(tmp_path, writer):
    W, R = (ScoreSink, JScoreSink) if writer == "port" \
        else (JScoreSink, ScoreSink)
    sink = _mk_sink(tmp_path / "s", lib=W)
    blocks = {1: np.arange(BLOCK_ROWS, dtype=np.float64)[None],
              2: np.full((1, 152), 0.25)}
    sink.write_block(1, blocks[1])
    again = _mk_sink(tmp_path / "s", lib=R)          # reopen = resume
    assert again.banked() == {1}
    again.write_block(2, blocks[2])
    back = _mk_sink(tmp_path / "s", lib=W)
    assert back.banked() == {1, 2} and not back.complete
    for i, b in blocks.items():
        np.testing.assert_array_equal(back.read_block(i), b)
    back.write_block(0, np.zeros((1, BLOCK_ROWS)))
    assert _mk_sink(tmp_path / "s", lib=R).complete


def test_sink_rejects_foreign_geometry(tmp_path):
    _mk_sink(tmp_path / "s")
    with pytest.raises(ScoreSinkError, match="disagrees"):
        ScoreSink.open_or_create(str(tmp_path / "s"), 3 * BLOCK_ROWS, 1,
                                 BLOCK_ROWS, 3, "another-model")
    with pytest.raises(ScoreSinkError, match="disagrees"):
        ScoreSink.open_or_create(str(tmp_path / "s"), 3 * BLOCK_ROWS, 2,
                                 BLOCK_ROWS, 3, "d1")


def test_sink_detects_corrupt_block(tmp_path):
    sink = _mk_sink(tmp_path / "s")
    sink.write_block(0, np.ones((1, BLOCK_ROWS)))
    fp = os.path.join(str(tmp_path / "s"), "scores_00000.bin")
    raw = bytearray(open(fp, "rb").read())
    raw[5] ^= 0x10
    with open(fp, "wb") as fh:
        fh.write(raw)
    with pytest.raises(ScoreSinkError, match="checksum"):
        _mk_sink(tmp_path / "s").read_block(0)


def test_sink_rejects_wrong_shape(tmp_path):
    sink = _mk_sink(tmp_path / "s", num_class=3)
    with pytest.raises(ValueError, match="rows"):
        sink.write_block(0, np.zeros((1, BLOCK_ROWS)))
    with pytest.raises(ScoreSinkError, match="not banked"):
        sink.read_block(1)


def test_shards():
    assert plan_block_shards(4, [DeviceSpec(0, 7)]) == (7, 7, 7, 7)
    devs = [DeviceSpec(1, 10), DeviceSpec(2, 20), DeviceSpec(1, 11)]
    assert plan_block_shards(6, devs) == (10, 11, 20, 10, 11, 20)
    with pytest.raises(ValueError):
        plan_block_shards(3, [])


# ----------------------------------------------------------------------
# BulkScorer end to end
# ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def scoring_setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("bulk")
    rng = np.random.RandomState(5)
    X = rng.randn(ROWS, 6).astype(np.float32)
    X[rng.rand(ROWS) < 0.1, 1] = np.nan
    y = (X[:, 0] + X[:, 2] > 0).astype(float)
    bst = lt.train({"objective": "binary", "verbosity": -1,
                    "num_leaves": 15, "min_data_in_leaf": 5},
                   lt.Dataset(X.astype(np.float64), label=y, device="cpu"),
                   num_boost_round=6, verbose_eval=False)
    forest = bst._forest(0, bst.num_trees())
    store = BlockStore.from_array(str(root / "features"), X,
                                  block_rows=BLOCK_ROWS)
    return root, bst, forest, store, X


def _banked(path, store, digest):
    sink = ScoreSink.open_or_create(path, ROWS, 1, BLOCK_ROWS,
                                    store.num_blocks, digest)
    return np.concatenate([sink.read_block(i)
                           for i in range(store.num_blocks)], axis=1)


def test_bulk_scores_match_the_booster_and_the_jax_package(scoring_setup):
    root, bst, forest, store, X = scoring_setup
    dev = DeviceForest(forest, "cpu")
    pk.reset_launch_counts()
    scorer = BulkScorer(dev, store, str(root / "sink_full"))
    stats = scorer.run()
    assert pk.launch_counts == {"fused_traverse": 0,
                                "fused_traverse[leaves]": 0,
                                "fused_traverse[scores]": 0}
    assert stats["complete"] and stats["blocks_scored"] == store.num_blocks
    assert stats["rows_scored"] == ROWS and stats["epilogue"] == "host"
    got = _banked(str(root / "sink_full"), store, scorer.digest)
    X64 = X.astype(np.float64)
    assert np.array_equal(got[0], bst.predict(X64, raw_score=True,
                                              device=False))
    for i in range(store.num_blocks):
        s, r = store.block_bounds(i)
        pad = np.zeros((BLOCK_ROWS, X.shape[1]), np.float32)
        pad[:r] = X[s:s + r]
        assert np.array_equal(got[:, s:s + r],
                              dev.predict_raw_padded(pad)[:, :r])
    # the device f32 path sums in another order: close, not bit-equal
    np.testing.assert_allclose(got[0], bst.predict(X64, raw_score=True),
                               rtol=1e-6, atol=1e-6)
    # the JAX package's scorer on the same store and model: the same files
    jb = lgb.Booster(model_str=bst.model_to_string())
    jdev = JDeviceForest(jb._forest(0, len(jb.models)), variant="fori")
    jstore = JBlockStore.open(store.path)
    JBulkScorer(jdev, jstore, str(root / "sink_jax")).run()
    for f in sorted(os.listdir(str(root / "sink_full"))):
        assert filecmp.cmp(os.path.join(str(root / "sink_full"), f),
                           os.path.join(str(root / "sink_jax"), f),
                           shallow=False), f


def test_bulk_crash_resume_byte_identical(scoring_setup):
    root, bst, forest, store, X = scoring_setup
    dev = DeviceForest(forest, "cpu")
    a, b = str(root / "sink_a"), str(root / "sink_b")
    BulkScorer(dev, store, a).run()
    cut = 2
    partial = BulkScorer(dev, store, b).run(max_blocks=cut)
    assert partial["blocks_scored"] == cut and not partial["complete"]
    resumed = BulkScorer(dev, store, b).run()       # a fresh scorer
    assert resumed["skipped_blocks"] == cut
    assert resumed["blocks_scored"] == store.num_blocks - cut
    assert resumed["complete"]
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b))
    for f in names:
        assert filecmp.cmp(os.path.join(a, f), os.path.join(b, f),
                           shallow=False), f"resumed {f} diverged"


def test_bulk_refuses_non_f32_store_and_other_queues(tmp_path,
                                                     scoring_setup, capsys):
    _, _, forest, store, _ = scoring_setup
    dev = DeviceForest(forest, "cpu")
    q = BlockStore.from_array(str(tmp_path / "u8"),
                              np.zeros((64, 3), np.uint8), block_rows=32)
    with pytest.raises(ValueError, match="float32"):
        BulkScorer(dev, q, str(tmp_path / "sink"))
    # a residency ledger: the run leases its predicted card peak on the
    # serving plane and releases it after; a denial warns and scores
    # every block anyway, as the JAX package's scorer does
    from lightgbm_tpu_torch.ops.planner import ResidencyLedger
    lg = ResidencyLedger(limit_bytes=1 << 30)
    s = BulkScorer(dev, store, str(tmp_path / "leased"), ledger=lg)
    peak = s._predicted_peaks()[0]
    events = []
    orig = lg._emit
    lg._emit = lambda ev, **kw: (events.append((ev, kw.get("bytes"))),
                                 orig(ev, **kw))
    stats = s.run()
    assert stats["complete"] and lg.leased_bytes() == 0
    assert events == [("lease", peak), ("release", peak)]
    small = ResidencyLedger(limit_bytes=1 << 30)
    small.lease("fleet:resident", small.budget_bytes - peak + 1,
                plane="serving")
    capsys.readouterr()
    denied = BulkScorer(dev, store, str(tmp_path / "denied"),
                        ledger=small).run()
    err = capsys.readouterr().err
    assert "residency ledger denied a" in err and "scoring anyway" in err
    assert denied["complete"]
    assert denied["blocks_scored"] == store.num_blocks
    assert denied["rows_scored"] == store.num_rows
    # the other lease is untouched and the denied run holds none
    assert small.table() == [{"lease_id": 1, "owner": "fleet:resident",
                              "plane": "serving",
                              "bytes": small.budget_bytes - peak + 1,
                              "preemptible": False}]
    # the denied run banked every block: a second run skips them all
    again = BulkScorer(dev, store, str(tmp_path / "denied"), ledger=lg).run()
    assert again["skipped_blocks"] == store.num_blocks
    assert again["blocks_scored"] == 0
    # a device count is planned through fleet.topology (the JAX package's
    # plan_devices), and a store is taken (fleet.aot)
    from lightgbm_tpu_torch.fleet import AOTStore, plan_devices
    s = BulkScorer(dev, store, str(tmp_path / "sink"), devices=2,
                   aot_store=AOTStore(str(tmp_path / "aot")))
    assert s.devices == plan_devices(2)


def test_bulk_sharded_run_scores_only_its_blocks(scoring_setup):
    root, bst, forest, store, X = scoring_setup
    dev = DeviceForest(forest, "cpu")
    devs = [DeviceSpec(0, 0), DeviceSpec(0, 1)]
    sink = str(root / "sink_sharded")
    s0 = BulkScorer(dev, store, sink, devices=devs, local_device_id=0).run()
    assert not s0["complete"]
    assert s0["blocks_scored"] == (store.num_blocks + 1) // 2
    digest = BulkScorer(dev, store, sink).digest
    banked = ScoreSink.open_or_create(sink, ROWS, 1, BLOCK_ROWS,
                                      store.num_blocks, digest)
    assert banked.banked() == {0, 2, 4}
    s1 = BulkScorer(dev, store, sink, devices=devs, local_device_id=1).run()
    assert s1["complete"]
    assert s0["blocks_scored"] + s1["blocks_scored"] == store.num_blocks


def test_denied_lease_scores_every_block_in_both_packages(scoring_setup,
                                                         tmp_path, capsys):
    """The same denial through both packages' scorers: each warns that
    the ledger denied the serving lease, scores every row, and leaves
    the lease that filled the ledger as it was."""
    from lightgbm_tpu.ops.planner import ResidencyLedger as JLedger
    from lightgbm_tpu_torch.ops.planner import ResidencyLedger
    _, bst, forest, store, _ = scoring_setup
    jb = lgb.Booster(model_str=bst.model_to_string())
    scorers = (
        ("port", ResidencyLedger(limit_bytes=1 << 20),
         lambda lg, path: BulkScorer(DeviceForest(forest, "cpu"), store,
                                     path, ledger=lg)),
        ("jax", JLedger(limit_bytes=1 << 20),
         lambda lg, path: JBulkScorer(
             JDeviceForest(jb._forest(0, len(jb.models)), variant="fori"),
             JBlockStore.open(store.path), path, ledger=lg)))
    seen = {}
    for name, lg, make in scorers:
        held = lg.lease("fleet:resident", lg.budget_bytes, plane="serving")
        capsys.readouterr()
        stats = make(lg, str(tmp_path / name)).run()
        err = capsys.readouterr().err
        warned = [ln.split("] ", 2)[-1] for ln in err.splitlines()
                  if "residency ledger denied" in ln]
        assert len(warned) == 1, err
        assert lg.leased_bytes() == held.nbytes == lg.budget_bytes
        assert [t["owner"] for t in lg.table()] == ["fleet:resident"]
        # each package's own predicted peak is the lease it asked for
        peak = stats["predicted_device_peak_bytes"]
        assert f"denied a {peak}-byte serving lease" in warned[0]
        seen[name] = (stats["rows_scored"], stats["blocks_scored"],
                      stats["complete"],
                      warned[0].replace(f"{peak}-byte", "<peak>-byte"))
    assert seen["port"] == seen["jax"]
    assert seen["port"][:3] == (store.num_rows, store.num_blocks, True)


def test_plan_block_shards_equals_the_jax_package():
    from lightgbm_tpu.data.score import plan_block_shards as jshards
    from lightgbm_tpu.fleet.topology import plan_devices as jplan
    from lightgbm_tpu_torch.fleet import plan_devices
    for n in range(1, 6):
        for blocks in (0, 1, 7, 12):
            assert plan_block_shards(blocks, plan_devices(n)) == \
                jshards(blocks, jplan(n))
    mixed = [(1, 10), (0, 20), (1, 11), (2, 5)]      # (slice, device)
    want = jshards(9, [_jax_spec(sl, d) for sl, d in mixed])
    assert plan_block_shards(9, [DeviceSpec(sl, d) for sl, d in mixed]) \
        == want


def _jax_spec(slice_id, device_id):
    from lightgbm_tpu.fleet.topology import DeviceSpec as JDeviceSpec
    return JDeviceSpec(device_id, slice_id)


def test_bulk_two_devices_restore_the_stored_program_bit_for_bit(
        scoring_setup, tmp_path):
    """``BulkScorer(devices=2, aot_store=)``: the first run scores live
    and stores the block bucket's program, the resumed runs restore it
    ("aot", the epilogue verdict taken from the store on a fresh
    forest), the two participants together complete the sink, and every
    block equals an uninterrupted live run and
    ``Booster.predict(raw_score=True, device=False)``."""
    from lightgbm_tpu_torch.fleet import AOTStore
    root, bst, forest, store, X = scoring_setup
    dev = DeviceForest(forest, "cpu")
    aot = AOTStore(str(tmp_path / "aot"))
    live = str(tmp_path / "live")
    BulkScorer(dev, store, live).run()
    sink = str(tmp_path / "sharded")
    s0 = BulkScorer(dev, store, sink, devices=2, local_device_id=0,
                    aot_store=aot).run(max_blocks=1)
    digest = BulkScorer(dev, store, sink).digest
    assert s0["program_source"] == "live"
    assert aot.buckets_for(digest) == [BLOCK_ROWS]
    from lightgbm_tpu_torch.fleet.aot import make_bulk_program
    fresh = DeviceForest(forest, "cpu")
    _prog, source = make_bulk_program(fresh, store.num_cols, BLOCK_ROWS,
                                      digest, aot)
    assert source == "aot" and fresh._epilogue_ok == dev._epilogue_ok
    s0b = BulkScorer(DeviceForest(forest, "cpu"), store, sink, devices=2,
                     local_device_id=0, aot_store=aot).run()
    s1 = BulkScorer(DeviceForest(forest, "cpu"), store, sink, devices=2,
                    local_device_id=1, aot_store=aot).run()
    assert s0b["program_source"] == s1["program_source"] == "aot"
    assert s0b["skipped_blocks"] == 1 and s1["complete"]
    assert s0["blocks_scored"] + s0b["blocks_scored"] + \
        s1["blocks_scored"] == store.num_blocks
    for f in sorted(os.listdir(live)):
        assert filecmp.cmp(os.path.join(live, f), os.path.join(sink, f),
                           shallow=False), f
    got = _banked(sink, store, digest)
    assert np.array_equal(got[0], bst.predict(X.astype(np.float64),
                                              raw_score=True, device=False))

