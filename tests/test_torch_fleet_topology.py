"""Pod-scale serving on the port (lightgbm_tpu_torch.fleet.topology and
fleet.router): every non-slow case of tests/test_fleet_topology.py, on
the CPU, with the port's ``ChaosRegistry``.

The models are the JAX package's, carried to the port through their
model text; every replica, hedged, failed-over and host-fallback answer
must be bit-equal to the JAX package's ``Booster.predict(raw_score=True)``
on the same text.  The pod's devices are logical devices on the CPU
backend (``device="cpu"``).
"""

import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest

import lightgbm_tpu as lgb

import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch.fleet import (DeviceSpec, Fleet, PodFleet,
                                      RouterConfig, plan_devices,
                                      plan_topology)
from lightgbm_tpu_torch.obs.metrics import MetricsRegistry
from lightgbm_tpu_torch.obs.watchdog import (SLOConfig, Watchdog,
                                             global_watchdog)
from lightgbm_tpu_torch.ops.planner import (FleetModelShape,
                                            fleet_replica_bytes)
from lightgbm_tpu_torch.resilience.faults import ChaosRegistry
from lightgbm_tpu_torch.serving import QueueFull
from lightgbm_tpu_torch.serving.loadgen import fire_fleet_requests
from lightgbm_tpu_torch.testing import one_thread  # noqa: F401

F = 10


@pytest.fixture
def flight_dir(tmp_path, monkeypatch):
    from lightgbm_tpu_torch.obs.flight import global_flight
    monkeypatch.setattr(global_flight, "_out_dir", str(tmp_path))
    monkeypatch.setattr(global_flight, "dumps", 0)
    monkeypatch.setattr(global_flight, "enabled", True)
    return tmp_path


def _jax_train(n=900, rounds=6, leaves=15, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, F).astype(np.float32).astype(np.float64)
    y = (X[:, 0] + X[:, 1] * X[:, 2] > 0).astype(float)
    return lgb.train({"objective": "binary", "verbosity": -1,
                      "num_leaves": leaves},
                     lgb.Dataset(X, label=y), num_boost_round=rounds,
                     verbose_eval=False)


def _port(jb):
    return lt.Booster(model_str=jb.model_to_string(), device="cpu")


@pytest.fixture(scope="module")
def jax_booster():
    return _jax_train(seed=0)


@pytest.fixture(scope="module")
def booster(jax_booster):
    return _port(jax_booster)


def _pod(booster, devices=3, chaos=None, router=None, name="m",
         weight=2.0, deadline_class="interactive", **kw):
    pod = PodFleet(devices=devices, chaos=chaos,
                   router=router or RouterConfig(),
                   max_batch_rows=128, device="cpu", **kw)
    for cls in list(pod.deadline_classes):
        pod.deadline_classes[cls] = 60_000.0
    pod.add_model(name, booster, weight=weight,
                  deadline_class=deadline_class)
    return pod


def _f32_rows(rng, n):
    return rng.randn(n, F).astype(np.float32).astype(np.float64)


def _wait_for(cond, timeout=15.0, interval=0.05):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(interval)
    return cond()


# ------------------------------------------------------------ topology


def test_plan_devices_mesh_seam(monkeypatch):
    monkeypatch.delenv("LGBM_TPU_NUM_SLICES", raising=False)
    flat = plan_devices(4)
    assert [d.device_id for d in flat] == [0, 1, 2, 3]
    assert {d.slice_id for d in flat} == {0}
    # simulated slices (LGBM_TPU_NUM_SLICES), as in the JAX package
    monkeypatch.setenv("LGBM_TPU_NUM_SLICES", "2")
    assert [d.slice_id for d in plan_devices(4)] == [0, 0, 1, 1]


def _shapes():
    return [
        FleetModelShape("hot", 100, 30, 31, F, buckets=(8, 64),
                        weight=8.0),
        FleetModelShape("warm", 100, 30, 31, F, buckets=(8, 64),
                        weight=2.0),
        FleetModelShape("cold", 100, 30, 31, F, buckets=(8, 64),
                        weight=1.0, age_s=300.0),
    ]


def test_plan_topology_replication_election():
    shapes = _shapes()
    fb, prog = fleet_replica_bytes(shapes[0])
    one = fb + sum(prog.values())
    # each device fits ~1.5 replicas: the hot model must be replicated,
    # the cold tail partitioned one-per-device for capacity
    devs = [DeviceSpec(i, 0, int(one * 1.5 / 0.9)) for i in range(4)]
    tp = plan_topology(shapes, devs)
    assert tp.feasible and tp.unplaced == ()
    assert len(tp.replicas["hot"]) > len(tp.replicas["cold"])
    assert all(len(ids) >= 1 for ids in tp.replicas.values())
    # every model's replica devices are distinct
    for ids in tp.replicas.values():
        assert len(set(ids)) == len(ids)
    # per-device residency plans cover exactly the placed replicas
    for d in tp.devices:
        placed = sorted(p.name for p in tp.placements
                        if p.device_id == d.device_id)
        assert sorted(m.name for m in
                      tp.device_plans[d.device_id].models) == placed
    # deterministic for identical inputs
    tp2 = plan_topology(_shapes(), devs)
    assert tp2.replicas == tp.replicas
    import json
    json.dumps(tp.summary())        # JSON-able for journals


def test_plan_topology_ample_budget_replicates_everywhere():
    devs = [DeviceSpec(i, i // 2, 1 << 30) for i in range(4)]
    tp = plan_topology(_shapes(), devs)
    assert all(len(ids) == 4 for ids in tp.replicas.values())


def test_plan_topology_unplaced_is_a_verdict_not_a_crash():
    devs = [DeviceSpec(0, 0, 1024)]     # fits nothing
    tp = plan_topology(_shapes(), devs)
    assert not tp.feasible
    assert set(tp.unplaced) == {"hot", "warm", "cold"}


# ------------------------------------------------------- replica parity


def test_replica_bit_parity_and_pod_routing(booster, jax_booster,
                                          flight_dir):
    rng = np.random.RandomState(7)
    with _pod(booster, devices=3) as pod:
        pod.warm()
        assert len(pod.topology.replicas["m"]) == 3
        X = _f32_rows(rng, 40)
        expect = jax_booster.predict(X, raw_score=True)
        # the routed path
        assert np.array_equal(pod.predict("m", X, timeout=60), expect)
        # every replica individually serves the same bits
        for r in list(pod._replicas["m"]):
            out = r.fleet.predict(r.inner_name, X, timeout=60)
            assert np.array_equal(out, expect)
        assert pod.availability("m") == 1.0


def test_pod_export_aot_per_device(booster, tmp_path, flight_dir):
    with _pod(booster, devices=2, aot_dir=str(tmp_path)) as pod:
        pod.warm()
        n = pod.export_aot()
        assert n > 0
        for did in pod.live_devices():
            sub = tmp_path / f"dev{did}"
            assert sub.is_dir() and any(sub.iterdir())


def test_pod_remove_model_drains_routing_table(booster, flight_dir):
    with _pod(booster, devices=2) as pod:
        rng = np.random.RandomState(3)
        X = _f32_rows(rng, 8)
        pod.predict("m", X, timeout=60)
        pod.remove_model("m")
        assert pod.models() == []
        from lightgbm_tpu_torch.serving import ModelNotFound
        with pytest.raises(ModelNotFound):
            pod.predict("m", X, timeout=10)
        # the availability watch went with it
        assert "m" not in global_watchdog._avail


# ------------------------------------------------------------- hedging


def test_hedge_fires_only_after_hedge_deadline(booster, jax_booster,
                                              flight_dir):
    rng = np.random.RandomState(11)
    X = _f32_rows(rng, 8)
    expect = jax_booster.predict(X, raw_score=True)
    # healthy pod: a fast request must NOT hedge even with hedging armed
    with _pod(booster, devices=2,
              router=RouterConfig(hedge_ms=2000.0)) as pod:
        pod.warm()
        assert np.array_equal(pod.predict("m", X, timeout=60), expect)
        assert pod.metrics.counter("fleet_hedges_total",
                                   labels={"model": "m"}).value == 0
    # wedged primary: the hedge fires at ~hedge_ms and the second
    # replica wins with identical bits
    chaos = ChaosRegistry("device.wedge@0:rank=0:sec=8")
    with _pod(booster, devices=2, chaos=chaos,
              router=RouterConfig(hedge_ms=150.0)) as pod:
        pod.warm()
        assert pod.topology.replicas["m"][0] == 0
        t0 = time.monotonic()
        out = pod.predict("m", X, timeout=30)
        lat_ms = (time.monotonic() - t0) * 1e3
        assert np.array_equal(out, expect)
        assert lat_ms >= 140.0, f"hedge fired early: {lat_ms:.1f} ms"
        assert pod.metrics.counter("fleet_hedges_total",
                                   labels={"model": "m"}).value == 1
        assert pod.metrics.counter("fleet_hedge_wins_total",
                                   labels={"model": "m"}).value == 1
        pod.close(drain=False, timeout=1.0)


# ------------------------------------------------------------ brownout


def test_brownout_tier_order(booster, jax_booster, flight_dir):
    rng = np.random.RandomState(5)
    X = _f32_rows(rng, 8)
    expect = jax_booster.predict(X, raw_score=True)
    pod = PodFleet(devices=2, max_batch_rows=128, device="cpu")
    for cls in list(pod.deadline_classes):
        pod.deadline_classes[cls] = 60_000.0
    pod.add_model("m", booster, weight=1.0, deadline_class="batch",
                  brownout_precision="bf16", accuracy_budget=1.0)
    try:
        pod.warm()
        # tier 0: batch class serves normally, full precision
        assert np.array_equal(pod.predict("m", X, timeout=60), expect)
        # tier 1 (pinned pressure): batch class sheds TYPED
        pod._pressure = lambda name: 0.80
        with pytest.raises(QueueFull):
            pod.predict("m", X, timeout=10)
        assert pod.metrics.counter(
            "fleet_brownout_shed_total", labels={"model": "m"}).value == 1
        # tier 2: interactive-class traffic prefers the budgeted
        # lowprec twin (drift bounded by the declared accuracy budget)
        pod._pressure = lambda name: 0.88
        out = pod.predict("m", X, timeout=60,
                          request_class="interactive")
        assert np.max(np.abs(out - expect)) <= 1.0
        lp_requests = sum(
            r.fleet.metrics.counter("fleet_requests_total",
                                    labels={"model": "m!lp"}).value
            for r in pod._replicas["m"] if r.lowprec)
        assert lp_requests >= 1
        # tier 3: host-path fallback instead of cliff-edge QueueFull —
        # still bit-identical
        pod._pressure = lambda name: 0.97
        out3 = pod.predict("m", X, timeout=60,
                           request_class="interactive")
        assert np.array_equal(out3, expect)
        assert pod.metrics.counter(
            "fleet_host_fallback_total", labels={"model": "m"}).value >= 1
    finally:
        pod.close(drain=False, timeout=1.0)


def test_card_pod_sheds_or_fails_typed_never_on_the_host(
        booster, jax_booster, flight_dir):
    """A pod on the card never moves a placed model's work to the host:
    tier 3 sheds with ``QueueFull`` and a request with no replica left
    fails with ``DeviceLost``; only a CPU pod (``test_brownout_tier_order``)
    takes the host path.  The card's rule runs here on a CPU pod with
    ``_host_ok`` cleared, as ``PodFleet`` sets it for a CUDA device."""
    from lightgbm_tpu_torch.serving import DeviceLost
    X = _f32_rows(np.random.RandomState(21), 8)
    expect = jax_booster.predict(X, raw_score=True)
    with _pod(booster, devices=2) as pod:
        pod._host_ok = False
        pod.warm()
        assert np.array_equal(pod.predict("m", X, timeout=60), expect)
        real_pressure = pod._pressure
        pod._pressure = lambda name: 0.97
        with pytest.raises(QueueFull):
            pod.predict("m", X, timeout=10, request_class="interactive")
        pod._pressure = real_pressure
        for d in (0, 1):
            pod.kill_device(d)
        with pytest.raises(DeviceLost):
            pod.predict("m", X, timeout=10)
        assert pod.metrics.counter(
            "fleet_host_fallback_total", labels={"model": "m"}).value == 0
        pod.close(drain=False, timeout=1.0)


# ------------------------------------------------------------ failover


def test_chaos_wedged_device_drains_with_inflight_redispatch(
        booster, jax_booster, flight_dir):
    rng = np.random.RandomState(13)
    X = _f32_rows(rng, 8)
    expect = jax_booster.predict(X, raw_score=True)
    chaos = ChaosRegistry("device.wedge@0:rank=0:sec=6")
    router = RouterConfig(stale_beat_s=0.4, dead_strikes=2,
                          health_interval_s=0.1,
                          hedge_classes=())     # failover, not hedging
    with _pod(booster, devices=2, chaos=chaos, router=router) as pod:
        pod.warm()
        assert pod.topology.replicas["m"][0] == 0
        fut = pod.submit("m", X)        # lands on device 0, then wedges
        assert _wait_for(lambda: pod.metrics.counter(
            "fleet_devices_lost_total").value == 1, timeout=15.0), \
            "health sweep never declared the wedged device dead"
        # the stuck in-flight request was RE-DISPATCHED, not failed
        out = fut.result(timeout=15)
        assert np.array_equal(out, expect)
        assert pod.metrics.counter(
            "fleet_failover_redispatch_total",
            labels={"model": "m"}).value >= 1
        assert _wait_for(lambda: 0 not in pod.live_devices())
        # forensic bundle on failover (the drain thread writes it after
        # closing the dead device's servers — give it a moment)
        assert _wait_for(lambda: list(
            flight_dir.glob("flight_fleet_device_lost_*.json")))
        # new traffic keeps serving, bit-identical
        assert np.array_equal(pod.predict("m", X, timeout=30), expect)
        assert pod.availability("m") == 1.0
        pod.close(drain=False, timeout=1.0)


def test_chaos_vanished_device_is_a_replan_not_an_outage(
        booster, jax_booster, flight_dir):
    rng = np.random.RandomState(17)
    X = _f32_rows(rng, 16)
    expect = jax_booster.predict(X, raw_score=True)
    chaos = ChaosRegistry()
    with _pod(booster, devices=3, chaos=chaos,
              router=RouterConfig(health_interval_s=0.1)) as pod:
        pod.warm()
        victim = pod.topology.replicas["m"][0]
        replans0 = pod.metrics.counter("fleet_replans_total").value
        chaos.down_device(victim, "vanish")
        # routing skips the vanished device immediately; health declares
        # it dead and the drain replans the topology over the survivors
        assert np.array_equal(pod.predict("m", X, timeout=30), expect)
        assert _wait_for(lambda: victim not in pod.live_devices())
        assert _wait_for(
            lambda: pod.topology is not None
            and victim not in pod.topology.replicas["m"]
            and len(pod.topology.replicas["m"]) >= 1)
        assert pod.metrics.counter(
            "fleet_replans_total").value > replans0
        assert pod.metrics.gauge("fleet_recovered_one_tick").value == 1
        assert np.array_equal(pod.predict("m", X, timeout=30), expect)
        pod.close(drain=False, timeout=1.0)


def test_fleet_remove_model_vs_replan_race(booster, jax_booster):
    """Bugfix audit: Fleet.remove_model drains under the replan lock, so
    hammering replan from threads while models churn never restores or
    drops arrays on a dying server."""
    fleet = Fleet(max_batch_rows=64, device="cpu")
    fleet.add_model("keep", booster)
    stop = threading.Event()
    errors = []

    def churn_replans():
        while not stop.is_set():
            try:
                fleet.replan()
            except Exception as e:  # noqa: BLE001
                errors.append(repr(e))
                return

    threads = [threading.Thread(target=churn_replans) for _ in range(3)]
    for t in threads:
        t.start()
    try:
        for i in range(8):
            fleet.add_model(f"m{i}", booster)
            fleet.remove_model(f"m{i}")
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=10)
    assert not errors
    rng = np.random.RandomState(1)
    X = _f32_rows(rng, 8)
    assert np.array_equal(fleet.predict("keep", X, timeout=60),
                          jax_booster.predict(X, raw_score=True))
    fleet.close()


def test_pod_swap_model_flips_every_replica(booster, jax_booster,
                                           flight_dir):
    jnew = _jax_train(seed=99, rounds=5)
    new = _port(jnew)
    rng = np.random.RandomState(23)
    X = _f32_rows(rng, 12)
    pod = PodFleet(devices=2, max_batch_rows=128, device="cpu")
    for cls in list(pod.deadline_classes):
        pod.deadline_classes[cls] = 60_000.0
    pod.add_model("m", booster, weight=1.0,
                  brownout_precision="bf16", accuracy_budget=10.0)
    try:
        pod.warm()
        assert np.array_equal(pod.predict("m", X, timeout=60),
                              jax_booster.predict(X, raw_score=True))
        pod.swap_model("m", new)
        expect = jnew.predict(X, raw_score=True)
        assert np.array_equal(pod.predict("m", X, timeout=60), expect)
        # every replica (and the host fallback model) flipped
        for r in list(pod._replicas["m"]):
            if not r.lowprec:
                out = r.fleet.predict(r.inner_name, X, timeout=60)
                assert np.array_equal(out, expect)
        assert np.array_equal(
            pod.entry("m").host_model.forest.predict_raw(X)[0], expect)
    finally:
        pod.close(drain=False, timeout=1.0)


# ------------------------------------------------ availability plumbing


def test_watchdog_availability_breach_and_rising_edge():
    dumps = []
    flight = SimpleNamespace(
        dump=lambda trigger, exc=None, extra=None: dumps.append(trigger))
    wd = Watchdog(config=SLOConfig(availability_floor=0.999),
                  registry=MetricsRegistry(), flight=flight)
    state = {"c": 10, "f": 0}
    wd.watch_availability("m0", lambda: (state["c"], state["f"]))
    assert wd.check_once() == []        # first sweep only banks state
    state.update(c=30)
    assert wd.check_once() == []        # clean window
    state.update(c=35, f=5)             # 5/10 failed this window
    breaches = wd.check_once()
    assert [b[0] for b in breaches] == ["availability:m0"]
    assert dumps == ["watchdog:availability:m0"]
    state.update(c=36, f=10)            # still breaching: no dump storm
    assert wd.check_once()
    assert len(dumps) == 1
    state.update(c=100, f=10)           # recovered: edge re-arms
    assert wd.check_once() == []
    state.update(c=101, f=20)
    assert wd.check_once()
    assert len(dumps) == 2
    wd.unwatch_availability("m0")
    assert wd.check_once() == []


def test_loadgen_availability_accounting():
    class StubFleet:
        def entry(self, name):
            return SimpleNamespace(
                model=SimpleNamespace(num_features=4, num_class=1))

        def predict(self, name, X, timeout=None):
            if name == "bad":
                raise RuntimeError("boom")
            return np.zeros(len(X))

    storm = fire_fleet_requests(StubFleet(), {"good": 1.0, "bad": 1.0},
                                60, 3, 5, timeout=5)
    o = storm["outcomes"]
    assert o["failed"] > 0 and o["completed"] > 0
    assert o["completed"] + o["shed"] + o["expired"] + o["failed"] \
        == storm["requests_planned"]
    assert storm["availability"] == pytest.approx(
        1.0 - o["failed"] / (o["completed"] + o["failed"]), abs=1e-6)
    assert storm["models"]["good"]["availability"] == 1.0
    assert storm["models"]["bad"]["availability"] == 0.0
    assert storm["models"]["bad"]["failed"] == o["failed"]
    assert not storm["errors"]          # failures are outcomes, not
    assert storm["failures"]            # dead threads
