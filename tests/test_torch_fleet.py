"""The serving fleet on the port (lightgbm_tpu_torch.fleet): every non-slow
case of tests/test_fleet.py, on the CPU.

The models are the JAX package's: trained by ``lightgbm_tpu`` (the JAX
test's module fixture) and carried to the port through their model
text.  Data is float32-precise, so the device backend's routing is
exact: every fleet answer (resident, evicted, restored from the AOT
store) must be bit-equal to the JAX package's
``Booster.predict(raw_score=True)`` on the same model text.
"""

import gc
import json
import os
import threading
import weakref

import numpy as np
import pytest
import torch

import lightgbm_tpu as lgb
from lightgbm_tpu.fleet import quantize_forest as jquantize_forest

import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch.fleet import AOTStore, Fleet, quantize_forest
from lightgbm_tpu_torch.fleet.aot import make_aot_program
from lightgbm_tpu_torch.fleet.lowprec import int8_rows, measure_accuracy_delta
from lightgbm_tpu_torch.ops import predict_kernels as pk
from lightgbm_tpu_torch.ops.planner import (HEADROOM, FleetModelShape,
                                            plan_fleet, predict_forest_bytes,
                                            predict_program_bytes)
from lightgbm_tpu_torch.serving import (LowPrecisionQuarantined,
                                        ModelNotFound, QueueFull)
from lightgbm_tpu_torch.testing import one_thread  # noqa: F401

F = 10
NAMES = ("m0", "m1", "m2")


def _f32_data(rng, n, f=F):
    return rng.randn(n, f).astype(np.float32).astype(np.float64)


def _jax_train(n=1200, rounds=10, leaves=15, seed=0, num_class=None):
    rng = np.random.RandomState(seed)
    X = _f32_data(rng, n)
    params = {"objective": "binary", "verbosity": -1, "num_leaves": leaves}
    if num_class:
        params = {"objective": "multiclass", "num_class": num_class,
                  "verbosity": -1, "num_leaves": leaves}
        y = rng.randint(0, num_class, n).astype(float)
    else:
        y = (X[:, 0] + X[:, 1] * X[:, 2] > 0).astype(float)
    return lgb.train(params, lgb.Dataset(X, label=y),
                     num_boost_round=rounds, verbose_eval=False)


@pytest.fixture(scope="module")
def jax_boosters():
    return [_jax_train(seed=0), _jax_train(seed=1),
            _jax_train(seed=2, num_class=3)]


@pytest.fixture(scope="module")
def boosters(jax_boosters):
    return [lt.Booster(model_str=b.model_to_string(), device="cpu")
            for b in jax_boosters]


def _fleet3(boosters, **kw):
    kw.setdefault("max_batch_rows", 128)
    fleet = Fleet(device="cpu", **kw)
    fleet.config.deadline_classes["interactive"] = 10_000.0
    fleet.add_model("m0", boosters[0], weight=3.0,
                    deadline_class="interactive")
    fleet.add_model("m1", boosters[1], weight=1.0)
    fleet.add_model("m2", boosters[2], weight=1.0, deadline_class="batch")
    return fleet


def _hot_only_budget(fleet, hot="m0"):
    """A caller budget that fits exactly the hottest model's residency."""
    plan = fleet.replan()
    mp = next(m for m in plan.models if m.name == hot)
    return int((mp.forest_bytes + mp.program_bytes + 1024) / HEADROOM)


# ------------------------------------------------------------- planner


def test_plan_fleet_budget_election():
    shapes = [
        FleetModelShape("hot", 100, 30, 31, F, buckets=(8, 64), weight=4.0),
        FleetModelShape("cold", 100, 30, 31, F, buckets=(8, 64),
                        weight=1.0, age_s=300.0),
    ]
    big = plan_fleet(shapes, budget_bytes=1 << 30)
    assert big.feasible and big.evicted == ()
    assert all(m.resident_buckets == (8, 64) for m in big.models)
    hot_cost = (big.models[0].forest_bytes + big.models[0].program_bytes)
    small = plan_fleet(shapes, budget_bytes=int((hot_cost + 512) / HEADROOM))
    assert small.evicted == ("cold",)
    assert not small.feasible
    assert small.models[0].resident
    assert [m.name for m in small.models] == ["hot", "cold"]
    shapes2 = [
        FleetModelShape("stale", 100, 30, 31, F, buckets=(8,), weight=4.0,
                        age_s=1e6),
        FleetModelShape("fresh", 100, 30, 31, F, buckets=(8,), weight=1.0),
    ]
    one_cost = (predict_forest_bytes(100, 30, 31)
                + predict_program_bytes(100, 8, F, emit_scores=True))
    one = plan_fleet(shapes2, budget_bytes=int((one_cost + 512) / HEADROOM))
    assert one.evicted == ("stale",)


def test_plan_fleet_partial_bucket_residency():
    shapes = [FleetModelShape("m", 200, 60, 61, F,
                              buckets=(8, 512, 4096), weight=1.0)]
    fb = predict_forest_bytes(200, 60, 61)
    small_prog = predict_program_bytes(200, 8, F, emit_scores=True)
    mid_prog = predict_program_bytes(200, 512, F, emit_scores=True)
    plan = plan_fleet(shapes, budget_bytes=int(
        (fb + small_prog + mid_prog + 256) / HEADROOM))
    (mp,) = plan.models
    assert mp.resident
    assert mp.resident_buckets == (8, 512)
    assert plan.feasible


def test_predict_forest_bytes_precision_ladder():
    """The card's order, not the JAX package's f32 > bf16 > int8: a
    routing-only int8 forest holds its codes, fix mask and f32 fix values
    beside the plain planes and the packed records (ROADMAP C-24)."""
    f32 = predict_forest_bytes(100, 30, 31, "f32")
    bf16 = predict_forest_bytes(100, 30, 31, "bf16", routing_only=True)
    int8 = predict_forest_bytes(100, 30, 31, "int8", routing_only=True)
    assert f32 > int8 > bf16
    assert predict_forest_bytes(200, 30, 31) > f32
    assert predict_program_bytes(100, 64, F) > \
        predict_program_bytes(100, 8, F)


# ------------------------------------------------------- default parity


def test_fleet_default_bit_parity(boosters, jax_boosters):
    fleet = _fleet3(boosters)
    try:
        rng = np.random.RandomState(5)
        for name, b in zip(NAMES, jax_boosters):
            X = _f32_data(rng, 33)
            out = fleet.predict(name, X, timeout=60)
            assert np.array_equal(out, b.predict(X, raw_score=True)), name
    finally:
        fleet.close()


def test_fleet_unknown_model_and_classes(boosters):
    fleet = _fleet3(boosters)
    try:
        with pytest.raises(ModelNotFound):
            fleet.predict("nope", np.zeros((1, F)))
        with pytest.raises(ValueError):
            fleet.add_model("bad_class", boosters[0],
                            deadline_class="warp-speed")
        with pytest.raises(ValueError):
            fleet.add_model("m0", boosters[0])     # duplicate name
        with pytest.raises(ValueError):
            fleet.add_model("w", boosters[0], weight=0.0)
    finally:
        fleet.close()


def test_fleet_traffic_mix_loadgen(boosters):
    from lightgbm_tpu_torch.serving.loadgen import fire_fleet_requests
    fleet = _fleet3(boosters)
    try:
        verify = {}
        for name, b in zip(NAMES, boosters):
            n_iter = len(b.models) // b.num_tree_per_iteration
            verify[name] = b._forest(0, n_iter)
        storm = fire_fleet_requests(
            fleet, {"m0": 3.0, "m1": 1.0, "m2": 1.0}, n_requests=60,
            n_threads=4, max_request_rows=100, verify=verify, timeout=60)
        assert storm["errors"] == []
        assert storm["mismatches"] == 0
        assert storm["requests"] + storm["shed"] + storm["expired"] \
            == storm["requests_planned"]
        for name in NAMES:
            s = storm["models"][name]
            if s["requests"]:
                assert set(s["latency_ms"]) >= {"p50", "p90", "p99"}
        assert storm["models"]["m0"]["requests"] >= \
            storm["models"]["m1"]["requests"]
    finally:
        fleet.close()


# ------------------------------------------------------------- eviction


def test_fleet_eviction_keeps_models_servable(boosters, jax_boosters):
    fleet = _fleet3(boosters)
    try:
        fleet.config.hbm_budget_bytes = _hot_only_budget(fleet)
        plan = fleet.replan()
        assert len(plan.evicted) >= 1 and "m0" not in plan.evicted
        rng = np.random.RandomState(6)
        for name, b in zip(NAMES, jax_boosters):
            X = _f32_data(rng, 21)
            out = fleet.predict(name, X, timeout=60)
            assert np.array_equal(out, b.predict(X, raw_score=True)), name
        for name in plan.evicted:
            e = fleet.entry(name)
            assert e.model.device_forest is None
            assert not e.resident
        c = fleet.metrics_dict()["counters"]
        assert sum(v for k, v in c.items()
                   if k.startswith("fleet_evictions")) == len(plan.evicted)
    finally:
        fleet.close()


def test_fleet_evict_then_restore_round_trip(boosters, jax_boosters):
    fleet = _fleet3(boosters)
    try:
        fleet.config.hbm_budget_bytes = _hot_only_budget(fleet)
        plan = fleet.replan()
        evicted = plan.evicted
        assert evicted
        fleet.config.hbm_budget_bytes = None
        plan2 = fleet.replan()
        assert plan2.evicted == ()
        rng = np.random.RandomState(7)
        for name in evicted:
            e = fleet.entry(name)
            assert e.model.device_forest is not None and e.resident
            b = jax_boosters[int(name[1:])]
            X = _f32_data(rng, 17)
            assert np.array_equal(fleet.predict(name, X, timeout=60),
                                  b.predict(X, raw_score=True))
        c = fleet.metrics_dict()["counters"]
        assert sum(v for k, v in c.items()
                   if k.startswith("fleet_restores")) == len(evicted)
    finally:
        fleet.close()


def test_fleet_eviction_under_load(boosters, jax_boosters):
    """Replanning back and forth while requests are in flight: no errors,
    every answer bit-equal (programs read the device pointer at call
    time; the host path is bit-identical)."""
    fleet = _fleet3(boosters)
    tiny = _hot_only_budget(fleet)
    stop = threading.Event()
    flips = [0]

    def churn():
        while not stop.is_set():
            fleet.config.hbm_budget_bytes = \
                tiny if flips[0] % 2 == 0 else None
            fleet.replan()
            flips[0] += 1

    t = threading.Thread(target=churn, daemon=True)
    t.start()
    try:
        rng = np.random.RandomState(8)
        for i in range(30):
            name = f"m{i % 3}"
            b = jax_boosters[i % 3]
            X = _f32_data(rng, 1 + (i * 7) % 64)
            out = fleet.predict(name, X, timeout=60)
            assert np.array_equal(out, b.predict(X, raw_score=True))
    finally:
        stop.set()
        t.join(timeout=10)
        fleet.close()
    assert flips[0] >= 1


def test_dropped_model_program_takes_the_host_path(boosters, jax_boosters,
                                                   monkeypatch):
    """The closure repair: a program built while the model was resident
    reads the device pointer at call time, so after ``drop_device`` it
    routes on the host, never reaches the dropped ``DeviceForest``, and
    holds none of it (the forest is freed)."""
    from lightgbm_tpu_torch.predict import DeviceForest
    fleet = _fleet3(boosters)
    try:
        e = fleet.entry("m1")
        prog = e.server.programs.get(e.model, 16)
        dev_ref = weakref.ref(e.model.device_forest)
        e.model.drop_device()
        assert e.model.device_forest is None
        assert e.model.booster._device_forest_cache is None
        gc.collect()        # earlier tests' closed fleets shared the forest
        assert dev_ref() is None, "the program kept the dropped forest"

        def no_device(*a, **k):
            raise AssertionError("a dropped model reached DeviceForest")

        monkeypatch.setattr(DeviceForest, "predict_raw_padded", no_device)
        X = _f32_data(np.random.RandomState(9), 16)
        raw = prog(X)
        assert np.array_equal(raw[0], jax_boosters[1].predict(
            X, raw_score=True))
        # a program built while evicted counts as a host-path build
        prog2 = e.server.programs.get(e.model, 32)
        assert getattr(prog2, "host_fallback", False)
        c = e.server.metrics_dict()["counters"]
        assert c["host_fallback_builds"] == 1
    finally:
        fleet.close()


# ---------------------------------------------------- weighted admission


def test_weighted_admission_sheds_over_share(boosters):
    fleet = _fleet3(boosters, max_queue_rows=1000)
    try:
        heavy, light = fleet.entry("m0"), fleet.entry("m1")
        heavy.server._batcher._queued_rows = 900
        light.server._batcher._queued_rows = 90
        try:
            with pytest.raises(QueueFull):
                fleet._admit(heavy, 50)
            fleet._admit(light, 50)
            c = fleet.metrics_dict()["counters"]
            assert c['fleet_shed_total{model="m0"}'] == 1
            assert 'fleet_shed_total{model="m1"}' not in c
        finally:
            heavy.server._batcher._queued_rows = 0
            light.server._batcher._queued_rows = 0
    finally:
        fleet.close()


def test_deadline_class_applies_default_deadline(boosters):
    fleet = _fleet3(boosters)
    try:
        fleet.config.deadline_classes["interactive"] = 1e-7
        from lightgbm_tpu_torch.serving import DeadlineExceeded
        with pytest.raises(DeadlineExceeded):
            fleet.predict("m0", np.zeros((4, F)), timeout=60)
        out = fleet.predict("m0", np.zeros((4, F)), deadline_ms=60_000,
                            timeout=60)
        assert out.shape == (4,)
        assert fleet.predict("m2", np.zeros((4, F)), timeout=60) is not None
    finally:
        fleet.close()


# ------------------------------------------------------------------ AOT


def _tensors(obj) -> dict:
    return {k: v for k, v in vars(obj).items()
            if isinstance(v, torch.Tensor)}


def test_aot_store_roundtrip(tmp_path, boosters, monkeypatch):
    srv = boosters[0].serve(max_batch_rows=64)
    try:
        n = srv.export_aot(path=str(tmp_path))
        assert n == len(srv.ladder.buckets)
        store = AOTStore(str(tmp_path))
        model = srv.models.active
        assert store.buckets_for(model.digest) == srv.ladder.buckets
        live = model.device_forest
        verdict = live._epilogue_verified(1)

        def no_pack(_dev):
            raise AssertionError("a restore packed the records")

        monkeypatch.setattr(pk, "pack_nodes", no_pack)
        restored = store.restore_device_forest(model.forest, model.digest,
                                               "cpu")
        monkeypatch.undo()
        # the same tensors as the live forest, the verdict not probed
        assert restored.aot_records_sha is not None
        assert restored._epilogue_ok == {1: verdict}
        want = _tensors(live)
        got = _tensors(restored)
        assert sorted(got) == sorted(want)
        for k, t in want.items():
            assert torch.equal(got[k], t), k
        # a restored bucket program is the live program at the stored
        # launch plans
        prog = make_aot_program(store, model, 16)
        assert prog.aot and not prog.host_fallback
        X = _f32_data(np.random.RandomState(3), 16)
        assert np.array_equal(prog(X), model.program()(X))
        assert store.load_program(model.digest, 4096, "cpu") is None
        assert store.load_program("feedface00000000", 16, "cpu") is None
        assert make_aot_program(store, model, 4096) is None
        assert store.restore_device_forest(model.forest, "feedface00000000",
                                           "cpu") is None
    finally:
        srv.close()


def test_aot_restore_keeps_one_device_forest_a_model(tmp_path, boosters,
                                                     jax_boosters):
    """A model restored from the store holds one ``DeviceForest`` (the
    stored records'), shared with its Booster, whose tensor bytes are the
    byte model's, however many buckets it serves."""
    path = str(tmp_path / "m.txt")
    boosters[0].save_model(path)
    store_dir = str(tmp_path / "aot")
    with boosters[0].serve(max_batch_rows=64) as srv:
        srv.export_aot(path=store_dir)
    fleet = Fleet(max_batch_rows=64, device="cpu", aot_dir=store_dir)
    try:
        e = fleet.add_model("p", path)
        fleet.warm()
        rng = np.random.RandomState(6)
        for rows in (3, 20, 64):
            X = _f32_data(rng, rows)
            assert np.array_equal(fleet.predict("p", X, timeout=60),
                                  jax_boosters[0].predict(X, raw_score=True))
        m = e.model
        dev = m.device_forest
        assert dev.aot_records_sha is not None
        assert m.booster._device_forest_cache[1] is dev
        gc.collect()
        forests = [o for o in gc.get_objects()
                   if type(o).__name__ == "DeviceForest"
                   and getattr(o, "forest", None) is m.forest]
        assert forests == [dev]
        T, I = m.forest.split_feature.shape
        assert sum(t.nbytes for t in _tensors(dev).values()) == \
            predict_forest_bytes(T, I, m.forest.leaf_value.shape[1])
        c = e.server.metrics_dict()["counters"]
        assert c.get("compile_events", 0) == 0
        assert c.get("aot_program_loads", 0) >= 3
    finally:
        fleet.close()


def test_aot_replica_first_request_zero_compiles(tmp_path, boosters,
                                                  jax_boosters):
    fleet = _fleet3(boosters)
    exported = fleet.export_aot(str(tmp_path))
    fleet.close()
    assert exported == 3 * 5            # 3 models x ladder 8..128
    replica = _fleet3(boosters, aot_dir=str(tmp_path))
    try:
        replica.warm()
        rng = np.random.RandomState(4)
        for name, b in zip(NAMES, jax_boosters):
            X = _f32_data(rng, 40)
            out = replica.predict(name, X, timeout=60)
            assert np.array_equal(out, b.predict(X, raw_score=True)), name
        for name in NAMES:
            c = replica.entry(name).server.metrics_dict()["counters"]
            assert c.get("compile_events", 0) == 0, name
            assert c.get("aot_program_loads", 0) >= 1, name
    finally:
        replica.close()


def test_aot_corrupt_entry_is_a_miss_not_a_failure(tmp_path, boosters,
                                                   jax_boosters):
    srv = boosters[0].serve(max_batch_rows=64)
    digest = srv.models.active.digest
    srv.export_aot(path=str(tmp_path))
    srv.close()
    with open(os.path.join(str(tmp_path), f"{digest}-b16.bin"), "wb") as fh:
        fh.write(b"not a stored program")
    with open(os.path.join(str(tmp_path), f"{digest}-b32.json"), "w") as fh:
        fh.write("{")
    srv2 = lt.serve(boosters[0], max_batch_rows=64, aot_dir=str(tmp_path))
    try:
        rng = np.random.RandomState(5)
        for rows in (16, 32, 8):
            X = _f32_data(rng, rows)
            out = srv2.predict(X, timeout=60)
            assert np.array_equal(out,
                                  jax_boosters[0].predict(X, raw_score=True))
        c = srv2.metrics_dict()["counters"]
        assert c.get("compile_events", 0) >= 2
        assert c.get("aot_program_loads", 0) >= 1
    finally:
        srv2.close()


def test_aot_version_and_platform_gate(tmp_path, boosters):
    srv = boosters[0].serve(max_batch_rows=64)
    digest = srv.models.active.digest
    srv.export_aot(path=str(tmp_path))
    srv.close()
    store = AOTStore(str(tmp_path))
    meta_path = os.path.join(str(tmp_path), f"{digest}-b16.json")
    with open(meta_path) as fh:
        meta = json.load(fh)
    for key, value in (("platform", "tpu_v9"), ("version", 999),
                       ("torch", "0.0.0"), ("kernel", "0" * 16)):
        bad = dict(meta, **{key: value})
        with open(meta_path, "w") as fh:
            json.dump(bad, fh)
        assert store.load_program(digest, 16, "cpu") is None, key
    assert store.load_program(digest, 8, "cpu") is not None
    forest = boosters[0]._forest(0, len(boosters[0].models))
    assert store.restore_device_forest(forest, digest, "cpu") is not None
    # the records are checked against their checksum too
    with open(os.path.join(str(tmp_path), f"{digest}.npz"), "r+b") as fh:
        fh.seek(100)
        fh.write(b"\xff\xff\xff\xff")
    assert store.restore_device_forest(forest, digest, "cpu") is None


# ------------------------------------------------------- low precision


def test_quantize_forest_grids(boosters, jax_boosters):
    """The port's bf16 and int8 grids are the JAX package's, array for
    array, on the JAX-trained forest."""
    b, jb = boosters[0], jax_boosters[0]
    n_iter = len(b.models) // b.num_tree_per_iteration
    forest, jforest = b._forest(0, n_iter), jb._forest(0, n_iter)
    for prec in ("bf16", "int8"):
        qf, jqf = quantize_forest(forest, prec), jquantize_forest(jforest,
                                                                  prec)
        assert np.array_equal(qf.threshold, jqf.threshold), prec
        assert np.array_equal(qf.leaf_value, jqf.leaf_value), prec
    q8 = quantize_forest(forest, "int8")
    for t in range(q8.leaf_value.shape[0]):
        assert len(np.unique(q8.leaf_value[t])) <= 255
    assert q8.threshold_q.dtype == np.int8
    deq = (q8.threshold_q.astype(np.float32)
           * q8.threshold_scale[:, None]).astype(np.float64)
    assert np.array_equal(deq[~q8.threshold_skip],
                          q8.threshold[~q8.threshold_skip])
    with pytest.raises(ValueError):
        quantize_forest(forest, "fp4")


def test_int8_rows_skip_mask():
    a = np.array([[1.0, -2.0, np.inf], [0.0, 0.0, 0.0]])
    q, scale, deq = int8_rows(a)
    assert q[0, 2] == 0 and deq[0, 2] == np.inf
    assert np.all(q[1] == 0) and np.all(deq[1] == 0.0)
    assert abs(deq[0, 1] - (-2.0)) <= 2.0 / 127


def test_lowprec_serves_quantized_forest_bitwise(boosters, jax_boosters):
    b, jb = boosters[0], jax_boosters[0]
    fleet = Fleet(max_batch_rows=128, device="cpu")
    try:
        fleet.add_model("full", b)
        for prec in ("bf16", "int8"):
            e = fleet.add_model(prec, b, precision=prec,
                                accuracy_budget=1.0)
            delta = e.server.metrics.gauge("lowprec_accuracy_delta").value
            assert 0 < delta <= 1.0
            rng = np.random.RandomState(11)
            X = _f32_data(rng, 50)
            out = fleet.predict(prec, X, timeout=60)
            qf = e.model.forest
            assert np.array_equal(out, qf.predict_raw(X)[0]), prec
            assert np.array_equal(fleet.predict("full", X, timeout=60),
                                  jb.predict(X, raw_score=True))
            drift = np.max(np.abs(out - jb.predict(X, raw_score=True)))
            assert drift <= 1.0
    finally:
        fleet.close()


def test_lowprec_budget_quarantines_add_and_swap(boosters):
    fleet = Fleet(max_batch_rows=128, device="cpu")
    try:
        fleet.add_model("m", boosters[0])
        with pytest.raises(LowPrecisionQuarantined):
            fleet.add_model("tight", boosters[0], precision="int8",
                            accuracy_budget=0.0)
        assert fleet.models() == ["m"]
        e = fleet.add_model("lp", boosters[0], precision="bf16",
                            accuracy_budget=1.0)
        old_digest = e.model.digest
        e.server.models.accuracy_budget = 1e-12
        with pytest.raises(LowPrecisionQuarantined):
            fleet.swap_model("lp", boosters[1])
        assert e.model.digest == old_digest
        c = e.server.metrics_dict()["counters"]
        assert c.get("lowprec_quarantines", 0) >= 1
        assert c.get("swap_quarantines", 0) >= 1
        X = _f32_data(np.random.RandomState(2), 9)
        assert fleet.predict("lp", X, timeout=60) is not None
    finally:
        fleet.close()


def test_lowprec_caller_probe_batch(boosters):
    b = boosters[0]
    rng = np.random.RandomState(13)
    probe = _f32_data(rng, 64)
    n_iter = len(b.models) // b.num_tree_per_iteration
    forest = b._forest(0, n_iter)
    expected = measure_accuracy_delta(forest,
                                      quantize_forest(forest, "bf16"), probe)
    srv = lt.serve(b, max_batch_rows=64, precision="bf16",
                   accuracy_budget=1.0, probe_X=probe)
    try:
        assert srv.metrics.gauge("lowprec_accuracy_delta").value == expected
    finally:
        srv.close()


# ------------------------------------------------------------- metrics


def test_fleet_prometheus_labels(boosters):
    fleet = _fleet3(boosters)
    try:
        fleet.predict("m0", np.zeros((3, F)), timeout=60)
        text = fleet.prometheus_text()
        assert 'lgbt_fleet_fleet_requests_total{model="m0"} 1' in text
        assert 'lgbt_fleet_model_weight{model="m0"} 3.0' in text
        assert 'lgbt_fleet_model_resident{model="m1"} 1' in text
        d0 = fleet.entry("m0").model.digest
        assert f'lgbt_fleet_model_digest_info{{model="m0",value="{d0}"}} 1' \
            in text
        assert 'lgbt_fleet_request_latency_ms_bucket{le="+Inf",model="m0"}' \
            in text
        for line in text.strip().splitlines():
            if not line.startswith("#"):
                float(line.rsplit(" ", 1)[1])
        d = fleet.metrics_dict()
        assert d["counters"]['fleet_requests_total{model="m0"}'] == 1
        assert "servers" in d and set(d["servers"]) == set(NAMES)
        assert "requests_total" in d["servers"]["m0"]["counters"]
    finally:
        fleet.close()


def test_fleet_joins_process_registry(boosters):
    from lightgbm_tpu_torch.obs.metrics import global_registry
    fleet = _fleet3(boosters)
    try:
        comp = global_registry.to_dict().get("components", {})
        assert any(k.startswith("fleet") for k in comp)
    finally:
        fleet.close()
    comp = global_registry.to_dict().get("components", {})
    assert not any(k.startswith("fleet") for k in comp)


# ------------------------------------------------------------- lifecycle


def test_remove_and_swap_replan(boosters, jax_boosters):
    fleet = _fleet3(boosters)
    try:
        fleet.remove_model("m2")
        assert fleet.models() == ["m0", "m1"]
        with pytest.raises(ModelNotFound):
            fleet.predict("m2", np.zeros((1, F)))
        fleet.swap_model("m1", boosters[2])     # class-count change
        X = _f32_data(np.random.RandomState(3), 12)
        assert np.array_equal(fleet.predict("m1", X, timeout=60),
                              jax_boosters[2].predict(X, raw_score=True))
        assert len(fleet.plan.models) == 2
    finally:
        fleet.close()


def test_model_path_loads_on_the_fleets_device(tmp_path, boosters,
                                               jax_boosters):
    path = str(tmp_path / "m.txt")
    boosters[0].save_model(path)
    fleet = Fleet(max_batch_rows=64, device="cpu")
    try:
        e = fleet.add_model("p", path)
        assert e.model.booster.device.type == "cpu"
        X = _f32_data(np.random.RandomState(4), 10)
        assert np.array_equal(fleet.predict("p", X, timeout=60),
                              jax_boosters[0].predict(X, raw_score=True))
    finally:
        fleet.close()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            Fleet()


def test_aot_records_written_again_keep_earlier_entries(tmp_path,
                                                        boosters):
    """A model's records are written once a digest: storing another
    bucket later rewrites the same bytes, so the entries stored before
    still restore."""
    srv = boosters[0].serve(max_batch_rows=64)
    try:
        digest = srv.models.active.digest
        assert srv.export_aot(path=str(tmp_path), buckets=[8, 16]) == 2
        npz = os.path.join(str(tmp_path), f"{digest}.npz")
        with open(npz, "rb") as fh:
            first = fh.read()
        assert srv.export_aot(path=str(tmp_path), buckets=[64]) == 1
        with open(npz, "rb") as fh:
            assert fh.read() == first
        store = AOTStore(str(tmp_path))
        assert store.buckets_for(digest) == [8, 16, 64]
        for b in (8, 16, 64):
            assert store.load_program(digest, b, "cpu") is not None, b
        model = srv.models.active
        assert store.restore_device_forest(model.forest, digest,
                                           "cpu") is not None
    finally:
        srv.close()
