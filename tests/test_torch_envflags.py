"""The port's environment registry (``lightgbm_tpu_torch/utils/
envflags.py``) against the JAX package's (``lightgbm_tpu/utils/
envflags.py``), and the knobs it maps onto the port's seams.

- Every flag the port registers has the JAX package's name and default.
- Every JAX flag is registered in the port or named below with why it is
  not: TPU-only, ``bench.py``'s, or a module the port has not ported
  (with its ROADMAP queue item).
- No ``LGBM_TPU_*`` / ``LIGHTGBM_TPU_*`` name in the port's source is
  missing from its registry (the repo's lint, ``tools/lint``, does not
  cover the port), and every registered flag is read by its consumer
  and named in README.md.
- An explicit argument wins over its knob, and an unset knob leaves the
  port as it is without it.
"""

import os
import re

import numpy as np
import pytest

from lightgbm_tpu.utils import envflags as jflags

import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch.boosting import macro
from lightgbm_tpu_torch.data import stream as port_stream
from lightgbm_tpu_torch.ops import planner
from lightgbm_tpu_torch.utils import envflags
from lightgbm_tpu_torch.testing import one_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "lightgbm_tpu_torch")

_TPU = "TPU-only"
_BENCH = "bench.py"

# every JAX flag the port does not read, with why
SKIPPED = {
    "LGBM_TPU_FUSED": (_TPU, "the fused Pallas megakernel's gate; the "
                       "card's arm is the config's tpu_hist_method"),
    "LGBM_TPU_SHARED_FRONTIER": (_TPU, "one XLA accumulate program for "
                                 "the sharded frontier"),
    "LGBM_TPU_AUTOTUNE": (_TPU, "the planner's measured autotuner "
                          "(skipped on purpose)"),
    "LGBM_TPU_AUTOTUNE_DIR": (_TPU, "the autotuner's timing store"),
    "LGBM_TPU_SHAPE_BUCKETS": (_TPU, "static-shape row buckets; the card "
                               "launches on unpadded rows"),
    "LGBM_TPU_SEGHIST": (_TPU, "the TPU histogram kernel families"),
    "LGBM_TPU_TABLE_MATMUL": (_TPU, "take_from_table's matmul gather"),
    "LGBM_TPU_SMALL_ROUNDS": (_TPU, "a small-frontier XLA kernel"),
    "LGBM_TPU_PACK": (_TPU, "the packed per-level rounds program"),
    "LGBM_TPU_ROUTER": (_TPU, "the in-program XLA row router"),
    "LGBM_TPU_VMEM_BYTES": (_TPU, "the fused kernel's VMEM budget"),
    "LGBM_TPU_TILE_ROWS": (_TPU, "the histogram row tile"),
    "LGBM_TPU_PREDICT_KERNEL": (_TPU, "the XLA traversal variants; the "
                                "card runs B1"),
    "LGBM_TPU_PREDICT_CHUNK": (_TPU, "the planner's predict plan; the "
                               "card's chunk is PREDICT_CHUNK_ROWS"),
    "LGBM_TPU_PREDICT_EPILOGUE": (_TPU, "pins the XLA epilogue's host "
                                  "fallback; the port's probe decides"),
    "LGBM_TPU_INGEST_KERNEL": (_TPU, "the ingest election between XLA "
                               "host binning and Pallas; the card bins "
                               "f32 through B3"),
    "LGBM_TPU_INGEST_CHUNK": (_TPU, "the Pallas ingest chunk; the card's "
                              "is INGEST_CHUNK_ROWS"),
    "LGBM_TPU_FREE_BINNED": (_TPU, "frees the host binned copy; the port "
                             "keeps none"),
    "LGBM_TPU_PINNED_REDUCE": (_TPU, "pins the order of the JAX package's "
                               "float sums; the port's are exact "
                               "integers: every route gives the same "
                               "bits"),
    "LGBT_DEFER_HOST_TREES": ("unported", "the deferred host-tree fetch: "
                              "ROADMAP P1 (step 3)"),
    "LGBM_TPU_MODEL_BATCH": ("unported", "multi/ (the model axis): "
                             "ROADMAP queue A12"),
    "LGBM_TPU_LIFECYCLE_DIR": ("unported", "lifecycle/: ROADMAP queue A12"),
    "LGBM_TPU_LIFECYCLE_DRIFT_BUDGET": ("unported",
                                        "lifecycle/: ROADMAP queue A12"),
    "LGBM_TPU_LIFECYCLE_P99_MS": ("unported",
                                  "lifecycle/: ROADMAP queue A12"),
    "LGBM_TPU_LIFECYCLE_MIRROR": ("unported",
                                  "lifecycle/: ROADMAP queue A12"),
    "LGBM_TPU_LIFECYCLE_RAMP": ("unported", "lifecycle/: ROADMAP queue A12"),
}
# the JAX package's bench.py knobs: all of them BENCH_*
_BENCH_PREFIX = "BENCH_"

_NAME = re.compile(r"\b((?:LGBM|LIGHTGBM)_TPU_[A-Z0-9_]*[A-Z0-9])(_?\*)?")


def _port_sources():
    for root, _dirs, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)


def test_shared_flags_have_the_jax_name_and_default():
    for f in envflags.all_flags():
        j = jflags.lookup(f.name)
        assert j is not None, f"{f.name} is not a JAX package flag"
        assert f.default == j.default, f.name
        assert os.path.exists(os.path.join(PKG, f.consumer)), f.consumer


def test_every_jax_flag_is_registered_or_skipped_with_a_reason():
    port = {f.name for f in envflags.all_flags()}
    for f in jflags.all_flags():
        if f.name in port:
            assert f.name not in SKIPPED, f.name
            continue
        if f.name.startswith(_BENCH_PREFIX):
            assert f.consumer == _BENCH, f.name
            continue
        assert f.name in SKIPPED, f"{f.name}: registered nor skipped"
        kind, why = SKIPPED[f.name]
        assert kind in (_TPU, "unported") and why
        if kind == "unported":
            assert "ROADMAP" in why, f.name
    # the table names no flag the JAX package lacks
    assert not set(SKIPPED) - {f.name for f in jflags.all_flags()}


def test_no_unregistered_flag_literal_in_the_port():
    names = {f.name for f in envflags.all_flags()}
    for path in _port_sources():
        with open(path) as fh:
            text = fh.read()
        for m in _NAME.finditer(text):
            name, star = m.group(1), m.group(2)
            if star:
                assert any(n.startswith(name) for n in names), (path, name)
                continue
            assert name in names, f"{path}: {name} is not registered"
    # every registered flag is read somewhere in its consumer
    for f in envflags.all_flags():
        with open(os.path.join(PKG, f.consumer)) as fh:
            assert f.name in fh.read(), (f.name, f.consumer)


def test_every_flag_is_documented_in_the_readme():
    with open(os.path.join(REPO, "README.md")) as fh:
        readme = fh.read()
    for f in envflags.all_flags():
        assert f.docfile == "README.md"
        assert f.name in readme, f.name


def test_get_and_read_refuse_unknown_names(monkeypatch):
    with pytest.raises(KeyError):
        envflags.get("LGBM_TPU_NOT_A_FLAG")
    with pytest.raises(KeyError):
        envflags.read("LGBM_TPU_NOT_A_FLAG")
    monkeypatch.delenv("LIGHTGBM_TPU_FLIGHT_EVENTS", raising=False)
    assert envflags.get("LIGHTGBM_TPU_FLIGHT_EVENTS") == "2048"
    assert envflags.read("LIGHTGBM_TPU_FLIGHT_EVENTS") is None
    monkeypatch.setenv("LIGHTGBM_TPU_FLIGHT_EVENTS", "64")
    assert envflags.get("LIGHTGBM_TPU_FLIGHT_EVENTS") == "64"


# ------------------------------------------------------------- the knobs

KNOBS = ("LGBM_TPU_STREAM", "LGBM_TPU_STREAM_BLOCK_ROWS",
         "LGBM_TPU_HOST_BYTES", "LGBM_TPU_HBM_BYTES",
         "LGBM_TPU_STREAM_DIR", "LGBM_TPU_CHUNK")


@pytest.fixture
def unset(monkeypatch):
    for k in KNOBS:
        monkeypatch.delenv(k, raising=False)
    return monkeypatch


def test_unset_knobs_leave_the_planner_and_the_chunk_cap(unset):
    assert planner._stream_force() == (None, "")
    assert planner._stream_block_rows() is None
    assert planner.host_limit_bytes()[1] in ("meminfo", "default")
    assert planner.device_limit_bytes("cpu") == (None, "none")
    assert macro.chunk_cap() == macro.DEFAULT_CHUNK_CAP
    p = planner.plan_stream(100_000, 28, 255, device="cpu")
    assert not p.stream and p.reason == "resident fits both budgets"
    d = port_stream.default_spill_dir()
    try:
        assert os.path.basename(d).startswith("lgbm_tpu_stream_")
    finally:
        os.rmdir(d)


def test_stream_knobs_steer_the_election(unset):
    unset.setenv("LGBM_TPU_STREAM", "1")
    unset.setenv("LGBM_TPU_STREAM_BLOCK_ROWS", "4096")
    p = planner.plan_stream(100_000, 28, 255, device="cpu")
    assert p.stream and p.block_rows == 4096
    assert p.reason.startswith("forced by LGBM_TPU_STREAM=1")
    # the argument (stream_override) wins over the environment
    with planner.stream_override(force=False):
        p = planner.plan_stream(100_000, 28, 255, device="cpu")
    assert not p.stream and "stream_override" in p.reason
    with planner.stream_override(force=True, block_rows=512):
        assert planner.plan_stream(100_000, 28, 255,
                                   device="cpu").block_rows == 512
    unset.setenv("LGBM_TPU_STREAM", "0")
    p = planner.plan_stream(100_000, 28, 255, device="cpu",
                            device_budget_bytes=1)
    assert not p.stream and p.reason == "disabled by LGBM_TPU_STREAM=0"


def test_budget_knobs_and_their_arguments(unset):
    unset.setenv("LGBM_TPU_HOST_BYTES", str(1 << 20))
    assert planner.host_limit_bytes() == (1 << 20, "env")
    p = planner.plan_stream(100_000, 28, 255, device="cpu")
    assert p.stream and p.host_limit_source == "env"
    # host_budget_bytes= wins over the knob
    p = planner.plan_stream(100_000, 28, 255, device="cpu",
                            host_budget_bytes=1 << 40)
    assert not p.stream and p.host_limit_source == "caller"
    unset.delenv("LGBM_TPU_HOST_BYTES")
    unset.setenv("LGBM_TPU_HBM_BYTES", str(1 << 20))
    assert planner.device_limit_bytes("cpu") == (1 << 20, "env")
    p = planner.plan_stream(100_000, 28, 255, device="cpu")
    assert p.stream and not p.resident_device_ok
    p = planner.plan_stream(100_000, 28, 255, device="cpu",
                            device_budget_bytes=1 << 40)
    assert not p.stream


def test_spill_dir_knob_and_the_dataset_argument(unset, tmp_path):
    unset.setenv("LGBM_TPU_STREAM_DIR", str(tmp_path / "spills"))
    d = port_stream.default_spill_dir()
    assert os.path.dirname(d) == str(tmp_path / "spills")
    X = np.random.RandomState(0).rand(600, 3).astype(np.float32)
    ds = lt.Dataset.from_sample(X, 600, spill=True, spill_block_rows=256,
                                device="cpu")
    assert os.path.dirname(ds._block_store.path) == str(tmp_path / "spills")
    # spill=<path> wins over the knob
    mine = str(tmp_path / "mine")
    ds2 = lt.Dataset.from_sample(X, 600, spill=mine, spill_block_rows=256,
                                 device="cpu")
    assert ds2._block_store.path == mine


@pytest.mark.parametrize("value,cap", [("0", 0), ("off", 0), ("4", 4),
                                       ("", macro.DEFAULT_CHUNK_CAP),
                                       ("auto", macro.DEFAULT_CHUNK_CAP),
                                       ("junk", macro.DEFAULT_CHUNK_CAP)])
def test_chunk_knob(unset, value, cap):
    unset.setenv("LGBM_TPU_CHUNK", value)
    assert macro.chunk_cap() == cap


def test_chunk_knob_moves_the_engine_not_the_model(unset):
    """LGBM_TPU_CHUNK=0 trains one update() a round and 2 caps chunks at
    2, each the same model text; update_chunk(c) (the argument) takes c
    whatever the knob says."""
    rng = np.random.RandomState(3)
    X = rng.rand(800, 5).astype(np.float32)
    y = (X[:, 0] + 0.3 * rng.rand(800) > 0.6).astype(np.float32)
    P = {"objective": "binary", "num_leaves": 7, "verbose": -1}
    from lightgbm_tpu_torch.obs import global_registry

    def run(value):
        if value is None:
            unset.delenv("LGBM_TPU_CHUNK", raising=False)
        else:
            unset.setenv("LGBM_TPU_CHUNK", value)
        before = global_registry.counter("train_chunk_dispatches").value
        b = lt.train(P, lt.Dataset(X, label=y, device="cpu"), 4,
                     verbose_eval=False)
        return (b.model_to_string().partition("end of trees")[0],
                global_registry.counter("train_chunk_dispatches").value
                - before)

    text, n_default = run(None)
    assert n_default == 1                      # one chunk of 4
    for value, n in (("0", 4), ("2", 2)):
        t, dispatches = run(value)
        assert t == text and dispatches == n, value
    unset.setenv("LGBM_TPU_CHUNK", "0")
    b = lt.Booster(P, train_set=lt.Dataset(X, label=y, device="cpu"))
    before = global_registry.counter("train_chunk_dispatches").value
    b.update_chunk(4)
    assert global_registry.counter("train_chunk_dispatches").value \
        == before + 1
    assert b.model_to_string().partition("end of trees")[0] == text


def test_two_tier_knobs_steer_the_mesh_plan_and_the_election(monkeypatch):
    """``LGBM_TPU_NUM_SLICES`` / ``LGBM_TPU_SLICE_DEVICES`` simulate
    slices in ``mesh_plan``; ``LGBM_TPU_HIER_REDUCE`` forces the route,
    ``LGBM_TPU_ICI_GBPS`` / ``LGBM_TPU_DCN_GBPS`` move the link model
    (``LGBM_TPU_PINNED_REDUCE`` is the JAX package's alone and changes
    nothing here); an argument wins, and
    unset knobs leave one tier and the planner's own election."""
    from lightgbm_tpu_torch.parallel.network import mesh_plan
    for k in ("LGBM_TPU_NUM_SLICES", "LGBM_TPU_SLICE_DEVICES",
              "LGBM_TPU_HIER_REDUCE", "LGBM_TPU_PINNED_REDUCE",
              "LGBM_TPU_ICI_GBPS", "LGBM_TPU_DCN_GBPS"):
        monkeypatch.delenv(k, raising=False)
    assert mesh_plan(8).num_slices == 1
    kw = dict(features=28, num_bins=64, num_slices=2, devices_per_slice=4)
    p = planner.plan_collectives(**kw)
    assert p.hierarchical
    assert (p.ici_gbps, p.dcn_gbps) == (planner.DEFAULT_ICI_GBPS,
                                        planner.DEFAULT_DCN_GBPS)
    monkeypatch.setenv("LGBM_TPU_NUM_SLICES", "4")
    assert (mesh_plan(8).num_slices, mesh_plan(8).source) == (4, "env")
    monkeypatch.setenv("LGBM_TPU_SLICE_DEVICES", "1")
    assert mesh_plan(8).total_shards == 4
    monkeypatch.setenv("LGBM_TPU_HIER_REDUCE", "0")
    monkeypatch.setenv("LGBM_TPU_PINNED_REDUCE", "1")
    monkeypatch.setenv("LGBM_TPU_ICI_GBPS", "10")
    monkeypatch.setenv("LGBM_TPU_DCN_GBPS", "1")
    p = planner.plan_collectives(**kw)
    assert not p.hierarchical and p.elected == "flat"
    assert "pinned" not in p.summary()
    assert (p.ici_gbps, p.dcn_gbps) == (10.0, 1.0)
    assert planner.plan_collectives(ici_gbps=5.0, **kw).ici_gbps == 5.0
    monkeypatch.delenv("LGBM_TPU_HIER_REDUCE")
    assert planner.plan_collectives(**kw).hierarchical


def test_coresident_knobs_steer_the_config(monkeypatch):
    from lightgbm_tpu_torch.coresident import CoresidentConfig
    for k in ("LGBM_TPU_CORESIDENT_CHUNK_CAP",
              "LGBM_TPU_CORESIDENT_THROTTLE_S",
              "LGBM_TPU_CORESIDENT_RECOVERY_S"):
        monkeypatch.delenv(k, raising=False)
    assert CoresidentConfig.from_env() == CoresidentConfig()
    monkeypatch.setenv("LGBM_TPU_CORESIDENT_CHUNK_CAP", "8")
    monkeypatch.setenv("LGBM_TPU_CORESIDENT_THROTTLE_S", "0.5")
    monkeypatch.setenv("LGBM_TPU_CORESIDENT_RECOVERY_S", "-1")
    cfg = CoresidentConfig.from_env()
    assert (cfg.chunk_cap, cfg.throttle_delay_s, cfg.recovery_s) == \
        (8, 0.5, 0.0)
    # an explicit config wins over the knobs
    assert CoresidentConfig(chunk_cap=2).chunk_cap == 2
