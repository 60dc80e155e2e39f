"""The port's device profiling (``lightgbm_tpu_torch/obs/devprof.py``),
on the CPU: the JAX package's devprof cases (``tests/test_obs.py``'s
``measure_program`` and small histogram table), the predict and ingest
tables, and the cost counts.

``kernel_cost`` must give, at each shape of ``chip_smoke.py``'s kernel
table, the bytes and operations that script printed on an NVIDIA H100
80GB HBM3 at 700 W (1 M x 28 rows, 255 bins, K = 128 with the slotted
rows of that run's frontier; the 500-tree HIGGS-width forest at 65,536
rows): the counts moved into the package, unchanged to the byte.  On
the CPU a row times the plain version and says so; no peak is known
there, so no ``mfu`` or ``hbm_util`` is reported.
"""

import numpy as np
import pytest
import torch

import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch.obs import devprof as D
from lightgbm_tpu_torch.obs.metrics import global_registry
from lightgbm_tpu_torch.testing import one_thread  # noqa: F401

M = 1_000_000
HIGGS_ENTRIES = {"sf": 82849, "thr": 82215, "left": 75377, "right": 75599,
                 "mt": 82849, "dl": 43007, "ic": 0, "co": 0, "cn": 0}

# (kernel, shape, bytes, ops) as chip_smoke.py printed them on the card
CARD_TABLE = [
    ("B4", dict(rows=M, features=28, bins=255, slots=128,
                slotted_rows=499824), 45927040, 41985216),
    ("B4", dict(rows=M, features=28, bins=255, slots=1, slotted_rows=M),
     44171360, 84000000),
    ("B4", dict(rows=M, features=28, bins=255, slots=128,
                slotted_rows=49685), 27921480, 4173540),
    ("B4_sort", dict(rows=M, slots=128, slotted_rows=499824), 25994696, M),
    ("B5", dict(children=256, features=28, bins=255), 44044112, 73113600),
    ("B5", dict(children=256, features=28, bins=255, monotone=True,
                bounds=True), 44046272, 127948800),
    ("B5", dict(children=256, features=28, bins=255, leaf_mode=True,
                rand_thr=True), 44072272, 73113600),
    ("B2", dict(rows=M, features=28, bins=255, slots=128,
                slotted_rows=499824), 68037072, 115098816),
    ("B4", dict(rows=M, features=28, bins=255, slots=128,
                slotted_rows=499273, quant=True), 26289550, 27959288),
    ("B4_sort", dict(rows=M, slots=128, slotted_rows=499273, quant=True),
     9998124, M),
    ("B5", dict(children=256, features=28, bins=255, quant=True),
     14798672, 78597120),
    ("B5", dict(children=256, features=28, bins=255, quant=True,
                monotone=True, bounds=True), 14800832, 133432320),
    ("B2", dict(rows=M, features=28, bins=255, slots=128,
                slotted_rows=499273, quant=True), 33776862, 106556408),
    ("B6", dict(rows=M, features=28, bins=255), 40171360, 84000000),
    ("B6", dict(rows=M, features=9, bins=256), 21055296, 27000000),
    ("B3", dict(rows=M, columns=28, groups=28,
                steps_per_row=D.ingest_steps_per_row(28, 255)),
     140000000, 336000000),
    ("B1", dict(rows=65536, features=28, num_trees=500,
                plane_entries=HIGGS_ENTRIES, bitset_words=0, leaves=0,
                visits=754793760 // 4), 140179616, 754793760),
]


@pytest.mark.parametrize("kernel,shape,nbytes,ops", CARD_TABLE)
def test_kernel_cost_is_the_cards_kernel_table(kernel, shape, nbytes, ops):
    assert D.kernel_cost(kernel, **shape) == {"bytes": nbytes, "ops": ops}


def test_roofline_is_the_bound_printed_on_the_card():
    r = D.roofline(40171360, 84000000)
    assert r["bound_ms"] == 0.011991450746268657
    assert r["bound_by"] == "bytes"
    r = D.roofline(9644268, 787561760)       # B1 scores, 65,536 rows
    assert r["bound_ms"] == 0.01175465313432836
    assert r["bound_by"] == "operations"
    with pytest.raises(KeyError):
        D.kernel_cost("B7", rows=1)


def test_b2_is_b4_then_b5_less_one_histogram_pass():
    shape = dict(rows=5000, features=6, bins=16, slots=4, slotted_rows=2500)
    for quant in (False, True):
        b2 = D.kernel_cost("B2", quant=quant, **shape)
        b4 = D.kernel_cost("B4", quant=quant, **shape)
        b5 = D.kernel_cost("B5", children=8, features=6, bins=16,
                           quant=quant)
        C, cell = (2, 4) if quant else (3, 8)
        assert b2["ops"] == b4["ops"] + b5["ops"]
        assert b2["bytes"] == b4["bytes"] + b5["bytes"] - 4 * C * 6 * 16 * cell


def test_peaks_by_card_name(monkeypatch):
    assert D.peak_flops_for("cpu") is None
    assert D.peak_hbm_bw_for("cpu") is None
    monkeypatch.setattr(D, "_device_kind",
                        lambda device=None: "nvidia h100 80gb hbm3")
    assert D.peak_flops_for() == 67e12
    assert D.peak_hbm_bw_for() == 3.35e12
    monkeypatch.setattr(D, "_device_kind",
                        lambda device=None: "nvidia a100-sxm4-80gb")
    assert D.peak_flops_for() is None and D.peak_hbm_bw_for() is None


def test_devprof_measures_a_program():
    a = torch.ones((128, 128), dtype=torch.float32)
    m = D.measure_program(lambda x: x @ x, (a,), reps=1,
                          cost={"bytes": 3 * 128 * 128 * 4,
                                "ops": 2 * 128 ** 3})
    assert m["seconds_per_call"] > 0
    assert m["flops"] == 2 * 128 ** 3
    assert m["hbm_gbps"] > 0
    # the CPU has no published peak: no utilization is claimed
    for k in ("mfu", "hbm_util", "peak_flops", "peak_hbm_bw"):
        assert k not in m
    assert "flops" not in D.measure_program(lambda: None, reps=1)


def test_devprof_histogram_table_small():
    t = D.histogram_utilization_table(rows=2000, features=6, num_bins=16,
                                      slots=4, reps=1, quant=True,
                                      device="cpu")
    keys = [k for k in t if "/" in k]
    assert sorted(keys) == sorted([
        "f32/pallas", "f32/fused", "f32/fused_sharded_flat",
        "f32/scatter_batched8",
        "quant/pallas", "quant/fused", "quant/fused_sharded_flat"])
    kinds = {"f32/pallas": "B6", "f32/fused": "B2", "quant/fused": "B2",
             "quant/pallas": "B4", "f32/fused_sharded_flat": "B4+B5",
             "f32/scatter_batched8": "B6"}
    for k in keys:
        v = t[k]
        assert v["seconds_per_call"] > 0, k
        assert v["route"] == "plain"
        assert kinds.get(k, v["kernel"]) == v["kernel"]
    m = t["slotted_rows"]
    assert t["f32/fused"]["bytes_accessed"] == D.kernel_cost(
        "B2", rows=2000, features=6, bins=16, slots=4,
        slotted_rows=m)["bytes"]
    assert t["f32/pallas"]["flops"] == 3 * 2000 * 6
    # the model axis' row: 8 lanes, each its own B6 over the one matrix
    b8 = t["f32/scatter_batched8"]
    assert b8["lanes"] == 8
    assert b8["flops"] == 8 * t["f32/pallas"]["flops"]
    assert b8["bytes_accessed"] == 8 * t["f32/pallas"]["bytes_accessed"]
    only_f32 = D.histogram_utilization_table(
        rows=500, features=3, num_bins=8, slots=2, reps=1, quant=False,
        device="cpu")
    assert not any(k.startswith("quant/") for k in only_f32)


def test_devprof_histogram_table_at_a_given_frontier():
    import torch
    n, K = 1000, 4
    slot = torch.full((n,), K, dtype=torch.int32)
    slot[:300] = torch.arange(300, dtype=torch.int32) % K
    t = D.histogram_utilization_table(rows=n, features=5, num_bins=16,
                                      slots=K, reps=1, quant=True,
                                      device="cpu", slot=slot)
    assert t["slotted_rows"] == 300
    shape = dict(rows=n, features=5, bins=16, slots=K, slotted_rows=300)
    assert t["quant/fused"]["bytes_accessed"] == D.kernel_cost(
        "B2", quant=True, **shape)["bytes"]
    b4, b5 = (D.kernel_cost("B4", **shape),
              D.kernel_cost("B5", children=2 * K, features=5, bins=16))
    assert t["f32/fused_sharded_flat"]["flops"] == b4["ops"] + b5["ops"]


def test_devprof_predict_table():
    from lightgbm_tpu_torch.testing import synthetic_model_text
    bst = lt.Booster(model_str=synthetic_model_text(8, 10, 15, seed=3),
                     device="cpu")
    dev = bst._device_forest(bst._forest(0, 10))
    t = D.predict_utilization_table(dev, rows=300, reps=1)
    assert t["num_trees"] == 10 and t["rows"] == 300
    for name in ("fused", "fused_scores"):
        assert t[name]["kernel"] == "B1" and t[name]["route"] == "plain"
        assert t[name]["seconds_per_call"] > 0
    X = np.random.RandomState(0).randn(300, t["features"]).astype(
        np.float32)
    leaves = D.traverse_cost(dev, torch.from_numpy(X))
    again = D.predict_utilization_table(dev, reps=1, X=X)
    assert again["fused"]["bytes_accessed"] == leaves["bytes"]
    assert sum(again["fused"]["plane_entries"].values()) == sum(
        leaves["plane_entries"].values())


def test_devprof_ingest_table():
    rng = np.random.RandomState(1)
    X = rng.randn(4000, 6).astype(np.float32)
    ds = lt.Dataset(X, label=(X[:, 0] > 0).astype(float),
                    device="cpu").construct()
    t = D.ingest_utilization_table(ds, X[:2000], reps=1)
    row = t["kernel/plain"]
    assert row["kernel"] == "B3" and row["route"] == "plain"
    assert row["bytes_accessed"] == 4 * 2000 * 6 + 2000 * t["num_groups"]
    assert t["host"]["seconds_per_call"] > 0
    assert t["bin_rows_per_sec"] > 0 and t["kernel_speedup_vs_host"] > 0


def test_mfu_gauge_keeps_the_best_row(monkeypatch):
    global_registry.gauge("mfu_measured_best").set(0)
    D._publish_best({"a": {"mfu": 0.002}, "b": {"mfu": 0.004}, "c": {}})
    assert global_registry.gauge("mfu_measured_best").value == 0.004
    D._publish_best({"a": {"mfu": 0.001}})
    assert global_registry.gauge("mfu_measured_best").value == 0.004


def test_profiler_trace_writes_a_chrome_trace(tmp_path):
    with D.profiler_trace(str(tmp_path / "prof")):
        torch.ones(64).sum()
    assert (tmp_path / "prof" / "trace.json").stat().st_size > 0
