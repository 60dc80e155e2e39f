"""Hot-swap, the program LRU, probe and quarantine, and async predict of
the port's serving path, on the CPU (mirrors tests/test_serving.py's
bucket-reuse, hot-swap, async and probe cases).

The boosters are trained by the port at the JAX tests' sizes (1,500
rows, 12 rounds, 15 leaves); every answer is held bit for bit against
the host float64 path (``StackedForest.predict_raw``) of the model its
request was admitted against, and the binary model's answers also
against ``lightgbm_tpu``'s prediction of the same model text.  Every
future, thread and ``apredict`` waits with a timeout.
"""

import asyncio
import threading
import time

import numpy as np
import pytest

import lightgbm_tpu as lgb

import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch.serving import (LowPrecisionQuarantined, ServingError,
                                        SwapQuarantined, loadgen)
from lightgbm_tpu_torch.serving.registry import CompiledModel
from lightgbm_tpu_torch.testing import one_thread  # noqa: F401

F = 10
WAIT = 60


def _f32_data(rng, n, f=F):
    """float64 rows whose values are exactly float32-representable."""
    return rng.randn(n, f).astype(np.float32).astype(np.float64)


def _train(n=1500, rounds=12, leaves=15, seed=0, num_class=None, f=F):
    rng = np.random.RandomState(seed)
    X = _f32_data(rng, n, f)
    params = {"objective": "binary", "verbosity": -1, "num_leaves": leaves}
    if num_class:
        params.update({"objective": "multiclass", "num_class": num_class})
        y = rng.randint(0, num_class, n).astype(float)
    else:
        y = (X[:, 0] + X[:, 1] * X[:, 2] > 0).astype(float)
    return lt.train(params, lt.Dataset(X, label=y, device="cpu"),
                    num_boost_round=rounds)


@pytest.fixture(scope="module")
def binary_booster():
    return _train()


def test_served_answers_equal_the_jax_package(binary_booster):
    rng = np.random.RandomState(1)
    X = _f32_data(rng, 300)
    jb = lgb.Booster(model_str=binary_booster.model_to_string())
    with binary_booster.serve(max_batch_rows=128) as srv:
        got = srv.predict(X, timeout=WAIT)
    assert np.array_equal(got, jb.predict(X, raw_score=True))


def test_bucket_reuse_and_lru_eviction(binary_booster):
    """Repeat shapes hit the program LRU: the miss counter freezes after
    warm-up while hits climb; a two-program LRU evicts and rebuilds."""
    rng = np.random.RandomState(3)
    sizes = [5, 20, 70, 200]
    srv = binary_booster.serve(max_batch_rows=256, batch_window_ms=0.5)
    for m in sizes:
        srv.predict(_f32_data(rng, m), timeout=WAIT)
    misses = srv.metrics_dict()["counters"]["bucket_misses"]
    assert misses <= len(sizes)
    for _ in range(3):
        for m in sizes:
            srv.predict(_f32_data(rng, m), timeout=WAIT)
    md = srv.metrics_dict()
    srv.close()
    assert md["counters"]["bucket_misses"] == misses
    assert md["counters"]["bucket_hits"] >= 3 * len(sizes)
    assert md["counters"].get("program_evictions", 0) == 0

    sf = binary_booster._forest(0, 12)
    with binary_booster.serve(max_batch_rows=256, batch_window_ms=0.5,
                              max_programs=2) as small:
        for m in sizes + sizes:
            Xr = _f32_data(rng, m)
            assert np.array_equal(small.predict(Xr, timeout=WAIT),
                                  sf.predict_raw(Xr)[0])
        c = small.metrics_dict()["counters"]
        assert len(small.programs._lru) == 2
        assert c["program_evictions"] == c["bucket_misses"] - 2 >= 4
        assert {b for b, _k in small.programs.seen_buckets} == \
            {8, 32, 128, 256}
        assert small.programs.evict_model(
            small.models.active.digest) == 2
        assert len(small.programs._lru) == 0


def test_hot_swap_under_load(binary_booster):
    """Swap while traffic flows: no failed request, every answer is the
    host path of the model it was admitted against, and the post-swap
    answers are the new model's."""
    b1 = binary_booster
    b2 = _train(rounds=9, leaves=7, seed=4)
    m1, m2 = (CompiledModel(b, backend="host") for b in (b1, b2))
    srv = b1.serve(max_batch_rows=128, batch_window_ms=1.0)
    res = {}
    t = threading.Thread(target=lambda: res.update(loadgen.fire_requests(
        srv, 96, 4, 100, F, verify_models=[m1, m2], timeout=WAIT)))
    t.start()
    time.sleep(0.05)
    srv.swap_model(b2, warm=True, block=True)
    t.join(4 * WAIT)
    assert not t.is_alive()
    rng = np.random.RandomState(11)
    Xq = _f32_data(rng, 40)
    post = srv.predict(Xq, timeout=WAIT)
    md = srv.metrics_dict()
    srv.close()
    assert res["errors"] == [] and res["mismatches"] == []
    assert res["requests"] == 96
    assert set(res["model_digests"]) <= {m1.digest, m2.digest}
    assert np.array_equal(post, m2.forest.predict_raw(Xq)[0])
    assert md["counters"]["hot_swaps"] == 1
    assert md["gauges"]["model_generation"] == 1
    assert md["gauges"]["active_model_digest"] == m2.digest != m1.digest


def test_swap_pins_in_flight_requests(binary_booster):
    """A request admitted before the flip completes on the model it was
    validated against, even when the new model expects another feature
    count and the request still sits in the queue."""
    rng = np.random.RandomState(7)
    b_wide = _train(n=1200, rounds=8, seed=13, f=F + 3)
    sf_old = binary_booster._forest(0, 12)
    sf_wide = b_wide._forest(0, 8)
    # a long coalescing window keeps the request queued through the swap
    srv = binary_booster.serve(max_batch_rows=64, batch_window_ms=300.0)
    Xq = _f32_data(rng, 16)
    fut = srv.submit(Xq)
    srv.swap_model(b_wide, warm=False, block=True)
    assert np.array_equal(fut.result(WAIT), sf_old.predict_raw(Xq)[0])
    Xw = _f32_data(rng, 10, f=F + 3)
    assert np.array_equal(srv.predict(Xw, timeout=WAIT),
                          sf_wide.predict_raw(Xw)[0])
    with pytest.raises(ServingError):
        srv.submit(Xq)                    # the old feature count
    srv.close()


def test_swap_across_num_class_and_from_a_path(binary_booster, tmp_path):
    """warm=True builds the seen buckets for the new model even when the
    swap changes num_class; a model file swaps in on the server's
    device."""
    b3 = _train(num_class=3, rounds=4, seed=9)
    sf3 = b3._forest(0, 4)
    path = tmp_path / "m3.txt"
    b3.save_model(str(path))
    srv = binary_booster.serve(max_batch_rows=64)
    rng = np.random.RandomState(5)
    srv.predict(_f32_data(rng, 10), timeout=WAIT)     # bucket 16
    srv.swap_model(str(path), warm=True, block=True)
    assert srv.models.active.booster.device.type == "cpu"
    misses = srv.metrics_dict()["counters"]["bucket_misses"]
    Xq = _f32_data(rng, 10)
    out = srv.predict(Xq, timeout=WAIT)
    md = srv.metrics_dict()
    srv.close()
    assert out.shape == (10, 3)
    assert np.array_equal(out, sf3.predict_raw(Xq, num_class=3).T)
    assert md["counters"]["bucket_misses"] == misses
    assert (16, 3) in srv.programs.seen_buckets


def test_swap_nonblocking(binary_booster):
    b2 = _train(rounds=5, leaves=7, seed=6)
    sf2 = b2._forest(0, 5)
    srv = binary_booster.serve(max_batch_rows=64)
    rng = np.random.RandomState(2)
    srv.predict(_f32_data(rng, 10), timeout=WAIT)
    t = srv.swap_model(b2, warm=True, block=False)
    assert t is not None
    t.join(WAIT)
    assert not t.is_alive() and t.exception is None
    Xq = _f32_data(rng, 10)
    out = srv.predict(Xq, timeout=WAIT)
    srv.close()
    assert np.array_equal(out, sf2.predict_raw(Xq)[0])
    assert srv.metrics_dict()["gauges"]["model_generation"] == 1


def test_async_predict(binary_booster):
    sf = binary_booster._forest(0, 12)
    rng = np.random.RandomState(12)
    Xq = _f32_data(rng, 25)

    async def go(srv):
        return await asyncio.wait_for(
            asyncio.gather(*[srv.apredict(Xq) for _ in range(4)]), WAIT)

    with binary_booster.serve(max_batch_rows=128) as srv:
        outs = asyncio.run(go(srv))
    ref = sf.predict_raw(Xq)[0]
    for out in outs:
        assert np.array_equal(out, ref)


def test_cancelled_future_does_not_wedge_scheduler(binary_booster):
    rng = np.random.RandomState(21)
    sf = binary_booster._forest(0, 12)
    srv = binary_booster.serve(max_batch_rows=64, batch_window_ms=100.0)
    for _ in range(3):
        srv.submit(_f32_data(rng, 8)).cancel()
    Xq = _f32_data(rng, 12)
    out = srv.predict(Xq, timeout=WAIT)
    srv.close()
    assert np.array_equal(out, sf.predict_raw(Xq)[0])


@pytest.mark.parametrize("backend", ["device", "host"])
def test_serving_stress(binary_booster, backend):
    """Mixed-shape requests from 8 threads through the load generator,
    each bit-equal to the host path; batches coalesce submitters."""
    model = CompiledModel(binary_booster, backend="host")
    srv = binary_booster.serve(backend=backend, max_batch_rows=512,
                               batch_window_ms=2.0)
    res = loadgen.fire_requests(srv, 160, 8, 700, F, verify_models=[model],
                                verify_forest=model.forest, timeout=WAIT)
    md = srv.metrics_dict()
    srv.close()
    assert res["errors"] == [] and res["mismatches"] == []
    assert res["requests"] == 160 and res["shed"] == res["expired"] == 0
    assert res["latency_ms"]["count"] == 160
    assert md["counters"]["requests_completed"] == 160
    assert md["counters"]["multi_submitter_batches"] >= 1


def test_shadow_mode_reports_drift(binary_booster):
    b2 = _train(rounds=5, leaves=7, seed=6)
    live, cand = binary_booster.serve(), b2.serve()
    res = loadgen.fire_requests(live, 24, 2, 50, F, shadow_server=cand,
                                mirror_fraction=1.0, timeout=WAIT)
    live.close()
    cand.close()
    sh = res["shadow"]
    assert sh["mirrored"] == 24 and sh["errors"] == []
    assert sh["drift_max"] > 0 and sh["nonfinite"] == 0


# ------------------------------------------------- swap probe / quarantine


def test_swap_probe_quarantines_poisoned_model(binary_booster):
    """A candidate with non-finite output is rejected before promotion:
    SwapQuarantined, generation unchanged, counted, old model serving
    the same bytes."""
    rng = np.random.RandomState(5)
    X = _f32_data(rng, 32)
    for backend in ("host", "device"):
        srv = binary_booster.serve(backend=backend)
        try:
            before = srv.predict(X, timeout=WAIT)
            digest = srv.models.active.digest
            poisoned = _train(rounds=4, seed=9)
            poisoned.models[0].leaf_value[:] = np.nan
            with pytest.raises(SwapQuarantined):
                srv.swap_model(poisoned)
            assert srv.metrics.gauge("model_generation").value == 0
            assert srv.metrics.gauge("active_model_digest").value == digest
            assert srv.metrics.counter("swap_quarantines").value == 1
            assert srv.metrics.counter("swap_failures").value == 1
            np.testing.assert_array_equal(srv.predict(X, timeout=WAIT),
                                          before)
            # the background swap parks the same error on its thread
            t = srv.swap_model(poisoned, block=False)
            t.join(WAIT)
            assert isinstance(t.exception, SwapQuarantined)
            assert srv.metrics.counter("swap_failures").value == 2
        finally:
            srv.close()


def test_swap_probe_quarantines_raising_model(binary_booster):
    srv = binary_booster.serve(backend="host")
    try:
        bad = _train(rounds=4, seed=11)

        class _Exploding:
            num_trees = 0

            def predict_raw(self, Xpad, num_class=1):
                raise RuntimeError("boom")

        new = CompiledModel(bad, backend="host")
        new.forest = _Exploding()
        new.make_program(8)        # building the callable is fine
        with pytest.raises(SwapQuarantined, match="boom"):
            srv.models._probe(new)
        assert srv.metrics.counter("swap_quarantines").value == 1
        assert srv.metrics.gauge("model_generation").value == 0
    finally:
        srv.close()


def test_swap_healthy_model_passes_probe(binary_booster):
    srv = binary_booster.serve(backend="host")
    try:
        srv.swap_model(_train(rounds=6, seed=13))
        assert srv.metrics.gauge("model_generation").value == 1
        assert srv.metrics.counter("swap_quarantines").value == 0
        text = srv.prometheus_text()
        assert "# TYPE lgbt_serving_hot_swaps counter\n" \
               "lgbt_serving_hot_swaps 1\n" in text
        assert 'lgbt_serving_active_model_digest_info{value="' in text
        assert "lgbt_serving_model_generation 1\n" in text
    finally:
        srv.close()


def test_prometheus_text_equals_the_jax_rendering():
    from lightgbm_tpu.obs.metrics import MetricsRegistry as JaxRegistry

    from lightgbm_tpu_torch.obs.metrics import MetricsRegistry
    texts = []
    for reg in (MetricsRegistry(), JaxRegistry()):
        reg.counter("hot_swaps").inc(2)
        reg.gauge("active_model_digest").set('ab"c\\d\ne')
        reg.gauge("lowprec_accuracy_delta").set(0.125)
        reg.gauge("flag").set(True)
        reg.gauge("nan_gauge").set(float("nan"))
        for v in (0.2, 3.0, 7e3):
            reg.histogram("request_latency_ms").observe(v)
        texts.append(reg.to_prometheus(prefix="lgbt_serving"))
    assert texts[0] == texts[1]


def test_unported_config_fields_raise(binary_booster, tmp_path):
    # the AOT store is ported (fleet.aot): an absent directory is a miss
    with binary_booster.serve(aot_dir=str(tmp_path / "none")) as srv:
        assert srv.aot is not None and srv.aot.entries() == []
        srv.predict(np.zeros((2, srv.models.active.num_features)),
                    timeout=30)
        assert srv.metrics_dict()["counters"]["compile_events"] == 1
    # the batcher's heartbeat is ported (obs.watchdog): the name is taken
    from lightgbm_tpu_torch.obs import global_watchdog
    with binary_booster.serve(heartbeat_name="replica0") as srv:
        srv.predict(np.zeros((2, srv.models.active.num_features)),
                    timeout=30)
        assert global_watchdog.beat_age("replica0") is not None
    # a store switched off has nowhere to export to
    with binary_booster.serve(aot_dir="off") as srv:
        assert srv.aot is None
        with pytest.raises(ServingError, match="no AOT store"):
            srv.export_aot()
    with pytest.raises(ValueError, match="precision"):
        binary_booster.serve(precision="fp4")


def test_lowprec_budget_on_admission(binary_booster):
    with pytest.raises(LowPrecisionQuarantined):
        binary_booster.serve(precision="int8", accuracy_budget=0.0)
