"""Pod telemetry and the bottleneck diagnosis on the port
(``lightgbm_tpu_torch/obs/aggregate.py``, ``obs/diagnose.py``,
``tools/obs_doctor.py``) against the JAX package's, on the CPU.

The cases of ``tests/test_flight.py``'s pod aggregation and diagnosis
sections, on the port: the frame round trip, a four-rank gather through
the resilient fake transport, the engine's eval-boundary hook, each
verdict, the ranking, journal stages and the doctor's command line.
Against the JAX package on the same inputs: the packed frames byte for
byte (and each package reads the other's), the derived pod views, and
the verdict lists of every signal dict those cases use.
"""

import json
import os
import subprocess
import sys
import threading

import numpy as np
import pytest

from lightgbm_tpu.obs import aggregate as jagg
from lightgbm_tpu.obs import diagnose as jdiag

import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch.obs import aggregate
from lightgbm_tpu_torch.obs.diagnose import diagnose, run_doctor
from lightgbm_tpu_torch.obs.metrics import MetricsRegistry, global_registry
from lightgbm_tpu_torch.testing import one_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the signal dicts of tests/test_flight.py's diagnosis cases
SIGNALS = [
    {"train_dcn_payload_bytes": 2e9, "train_num_slices": 4,
     "train_hier_reduce": 1, "train_iter_seconds": 1.0, "dcn_gbps": 6.25},
    {"compile_seconds": 130.0, "train_seconds": 25.0,
     "compile_cache_warm": 0},
    {"stream_blocks_total": 64, "overlap_efficiency": 1.0},
    {"pod_straggler_skew": 1.8, "pod_straggler_slice": 2},
    {"mfu_measured_best": 0.0005},
    {},
    {"compile_seconds": 130.0, "train_seconds": 25.0,
     "train_dcn_payload_bytes": 3e8, "train_num_slices": 2,
     "train_iter_seconds": 0.15, "dcn_gbps": 6.25},
    {"coresident_throttle_total": 3, "coresident_pause_total": 1,
     "ledger_leased_bytes": 1000.0, "watchdog_p99_ms_max": 80.0,
     "ledger_lease_table": [{"lease_id": 1, "owner": "serve:m",
                             "plane": "serving", "bytes": 1000,
                             "preemptible": False}]},
    {"bin_seconds": 12.0, "train_seconds": 10.0, "bin_rows_per_sec": 5e5},
]


# ----------------------------------------------------- pod aggregation


def test_pod_vector_roundtrip():
    rank, vals = aggregate.unpack_rank_vector(aggregate.pack_rank_vector(
        {"iter_seconds": 1.5, "dcn_payload_bytes": 4096.0}, rank=3))
    assert rank == 3
    assert vals["iter_seconds"] == 1.5
    assert vals["dcn_payload_bytes"] == 4096.0
    assert vals["mfu"] == 0.0
    with pytest.raises(ValueError):
        aggregate.unpack_rank_vector(b"garbage-frame-bytes")


@pytest.mark.parametrize("rank", [0, 3, 17])
def test_pod_frames_equal_the_jax_packages(rank):
    vals = {"iter_seconds": 1.25, "trees_per_sec": 40.0,
            "ici_payload_bytes": 1e6, "dcn_payload_bytes": 2.5e5,
            "mfu": 0.0031, "host_rss_peak_bytes": 3e9,
            "compile_cache_warm": 1.0, "slo_breach_total": 2.0,
            "not_a_slot": 9.0}
    frame = aggregate.pack_rank_vector(vals, rank)
    assert frame == jagg.pack_rank_vector(vals, rank)
    assert aggregate.unpack_rank_vector(frame) == \
        jagg.unpack_rank_vector(frame)
    assert aggregate.METRIC_LAYOUT == jagg.METRIC_LAYOUT


@pytest.mark.parametrize("world,slices", [(4, 2), (8, 2), (6, 3), (1, 1)])
def test_pod_view_equals_the_jax_packages(world, slices):
    rng = np.random.RandomState(world)
    per_rank = [{"iter_seconds": float(rng.rand() + 0.5),
                 "ici_payload_bytes": float(rng.randint(1, 1000)),
                 "dcn_payload_bytes": float(rng.randint(1, 100)),
                 "mfu": float(rng.rand() * 0.01)} for _ in range(world)]
    port = aggregate.derive_pod_view(per_rank, slices)
    jax = jagg.derive_pod_view(per_rank, slices)
    assert port.summary() == jax.summary()
    assert port.slice_iter_seconds == jax.slice_iter_seconds


def test_pod_gather_derives_straggler_and_sums():
    """4 ranks / 2 slices through the resilient fake transport: every
    rank derives the same view; slice 1 (ranks 2, 3) is the straggler."""
    from lightgbm_tpu_torch.parallel.dist_data import make_fake_allgather
    from lightgbm_tpu_torch.resilience import ResilienceConfig
    world = 4
    fake = make_fake_allgather(world, timeout=5.0)
    regs = [MetricsRegistry() for _ in range(world)]
    views, errs = [None] * world, [None] * world

    def runner(k):
        try:
            views[k] = aggregate.gather_pod_metrics(
                fake(k), world=world, rank=k, num_slices=2,
                registry=regs[k],
                config=ResilienceConfig(deadline_s=10.0, max_retries=2),
                values={"iter_seconds": 1.0 if k < 2 else 2.0,
                        "ici_payload_bytes": 100.0,
                        "dcn_payload_bytes": 10.0, "mfu": 0.004})
        except Exception as e:  # noqa: BLE001
            errs[k] = e

    threads = [threading.Thread(target=runner, args=(k,))
               for k in range(world)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30)
    assert errs == [None] * world
    for k, v in enumerate(views):
        assert v.world == 4 and v.num_slices == 2
        assert v.straggler_slice == 1
        assert v.straggler_skew == pytest.approx(2.0)
        assert v.pod_ici_payload_bytes == 400.0
        assert v.pod_dcn_payload_bytes == 40.0
        assert v.pod_mfu == pytest.approx(0.004)
        g = regs[k].to_dict()["gauges"]
        assert g["pod_straggler_slice"] == 1
        assert g["pod_straggler_skew"] == 2.0
        assert g["pod_world"] == 4


def test_engine_eval_boundary_gathers_when_transport_registered():
    """``engine.train`` runs a telemetry round at each evaluation when a
    transport is registered (a world of 1 here), and none otherwise."""
    from lightgbm_tpu_torch.parallel.dist_data import make_fake_allgather
    rng = np.random.RandomState(0)
    X = rng.rand(400, 4)
    y = (X[:, 0] > 0.5).astype(np.float32)
    params = {"objective": "binary", "num_leaves": 7, "verbosity": -1,
              "metric": "binary_logloss"}
    assert aggregate.maybe_gather_at_eval() is None
    global_registry.gauge("pod_world").set(0)
    ds = lt.Dataset(X, label=y, device="cpu")
    lt.train(params, ds, 2, valid_sets=[ds], verbose_eval=False)
    assert global_registry.gauge("pod_world").value == 0
    fake = make_fake_allgather(1, timeout=5.0)
    aggregate.register_pod_transport(fake(0), world=1, rank=0,
                                     num_slices=1)
    try:
        ds = lt.Dataset(X, label=y, device="cpu")
        lt.train(params, ds, 2, valid_sets=[ds], verbose_eval=False)
        g = global_registry.to_dict()["gauges"]
        assert g.get("pod_world") == 1
    finally:
        aggregate.clear_pod_transport()
    assert aggregate.maybe_gather_at_eval() is None


def test_pod_transport_over_a_process_group():
    """The port's transport: ``parallel.collectives.all_gather_bytes``
    over a gloo group of two thread ranks."""
    from lightgbm_tpu_torch.parallel.collectives import all_gather_bytes
    from lightgbm_tpu_torch.testing import thread_ranks

    def rank_fn(rank, group):
        return aggregate.gather_pod_metrics(
            lambda b: all_gather_bytes(b, group), world=2, rank=rank,
            registry=MetricsRegistry(),
            values={"iter_seconds": 1.0 + rank}).summary()

    views = thread_ranks(2, rank_fn)
    assert views[0] == views[1]
    assert views[0]["straggler_skew"] == 1.0 and views[0]["world"] == 2


# ----------------------------------------------------------- diagnosis


def _diag_top(signals):
    return diagnose(signals)[0]


def test_doctor_names_dcn_bound():
    v = _diag_top(SIGNALS[0])
    assert v.name == "dcn-bound"
    assert v.evidence["num_slices"] == 4
    assert v.evidence["fraction"] > 0.25


def test_doctor_names_compile_bound():
    v = _diag_top(SIGNALS[1])
    assert v.name == "compile-bound"
    assert v.evidence["compile_cache_warm"] is False
    assert v.score > 0.8


def test_doctor_names_input_bound():
    v = _diag_top(SIGNALS[2])
    assert v.name == "input-bound"
    assert v.evidence["overlap_efficiency"] == 1.0


def test_doctor_names_straggler_and_kernel():
    v = _diag_top(SIGNALS[3])
    assert v.name == "straggler" and v.evidence["straggler_slice"] == 2
    assert _diag_top(SIGNALS[4]).name == "kernel-underutilized"
    assert _diag_top(SIGNALS[5]).name == "healthy"


def test_doctor_ranks_verdicts():
    vs = diagnose(SIGNALS[6])
    assert {v.name for v in vs} == {"compile-bound", "dcn-bound"}
    assert [v.score for v in vs] == sorted((v.score for v in vs),
                                           reverse=True)


@pytest.mark.parametrize("i", range(len(SIGNALS)))
def test_verdicts_equal_the_jax_packages(i):
    port = [v.to_dict() for v in diagnose(SIGNALS[i])]
    jax = [v.to_dict() for v in jdiag.diagnose(SIGNALS[i])]
    assert port == jax


def test_doctor_collects_from_journal_stages():
    stages = {
        "full@200000": {"sec_per_tree": 0.5, "value": 25.0,
                        "compile_seconds": 130.0, "trees": 50,
                        "compile_cache": {"warm_start": False},
                        "mfu_measured": {"f32/fused":
                                         {"mfu": 0.002}}},
        "stream_probe": {"overlap_efficiency": 1.0},
    }
    report = run_doctor(registry=MetricsRegistry(), stages=stages)
    assert report["top_verdict"] == "compile-bound"
    names = [v["name"] for v in report["verdicts"]]
    assert "input-bound" in names
    assert report["signals"]["mfu_measured_best"] == 0.002
    json.dumps(report)
    jreport = jdiag.run_doctor(registry=MetricsRegistry(), stages=stages)
    assert [v["name"] for v in jreport["verdicts"]] == names


def test_obs_doctor_tool(tmp_path):
    journal = tmp_path / "j.json"
    journal.write_text(json.dumps({
        "fingerprint": "t", "stages": {
            "full": {"compile_seconds": 130.0, "value": 25.0,
                     "compile_cache": {"warm_start": False}}}}))
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-m", "lightgbm_tpu_torch.tools.obs_doctor",
         "--journal", str(journal), "--metrics", str(tmp_path / "no")],
        capture_output=True, text=True, timeout=120, cwd=str(tmp_path),
        env=env)
    assert proc.returncode == 0, proc.stderr[-1000:]
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    assert report["top_verdict"] == "compile-bound"
    assert "compile-bound" in proc.stdout
    bad = tmp_path / "bad.json"
    bad.write_text("{not json")
    proc = subprocess.run(
        [sys.executable, "-m", "lightgbm_tpu_torch.tools.obs_doctor",
         "--journal", str(bad), "--json-only"],
        capture_output=True, text=True, timeout=120, cwd=str(tmp_path),
        env=env)
    assert proc.returncode == 2
    assert "unreadable" in proc.stdout


def test_obs_doctor_reads_a_metrics_snapshot(tmp_path):
    from lightgbm_tpu_torch.tools import obs_doctor
    reg = MetricsRegistry()
    reg.counter("coresident_throttle_total").inc(2)
    reg.gauge("mfu_measured_best").set(0.0004)
    path = tmp_path / "snap.json"
    path.write_text(reg.dump_json())
    report = obs_doctor.run_doctor(
        stages={}, registry=obs_doctor.load_metrics_snapshot(str(path)))
    assert report["top_verdict"] == "contention"
    assert "kernel-underutilized" not in [v["name"]
                                          for v in report["verdicts"]]
    assert obs_doctor.load_journal_stages(str(tmp_path / "none")) == {}
    assert obs_doctor.main(["--journal", str(tmp_path / "none"),
                            "--metrics", str(path), "--json-only"]) == 0
