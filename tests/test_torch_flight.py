"""The port's active observability (``lightgbm_tpu_torch/obs/flight.py``,
``obs/watchdog.py``, ``obs/http.py``) against the JAX package's
(``tests/test_flight.py``), on the CPU: the flight ring, bundles, the
dump budget, metric deltas, the failure triggers (an engine-loop
exception, a failed collective, a quarantined serving swap), the
watchdog, the HTTP endpoint and the tracer's event cap.

Parity with ``lightgbm_tpu``: a bundle from each package has the same
top-level keys, and its ring, metrics and fingerprint sections the same
shape; the port's recorder on and off give the same model text.  The
aggregate and doctor cases of tests/test_flight.py are in
tests/test_torch_diagnose.py; its slice-lost and bench cases belong to
the JAX package's bench and its multi-host launcher.
"""

import glob
import json
import os
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from lightgbm_tpu.obs.flight import FlightRecorder as JFlightRecorder

import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch.obs.flight import FlightRecorder, global_flight
from lightgbm_tpu_torch.obs.metrics import MetricsRegistry, global_registry
from lightgbm_tpu_torch.obs.watchdog import (SLOConfig, Watchdog,
                                             global_watchdog,
                                             histogram_p99_ms)
from lightgbm_tpu_torch.testing import one_thread  # noqa: F401


@pytest.fixture
def flight_dir(tmp_path, monkeypatch):
    """The process recorder pointed at a scratch directory with a fresh
    dump budget."""
    monkeypatch.setattr(global_flight, "_out_dir", str(tmp_path))
    monkeypatch.setattr(global_flight, "dumps", 0)
    monkeypatch.setattr(global_flight, "enabled", True)
    return tmp_path


def _bundles(d, pat="flight_*.json"):
    return sorted(glob.glob(os.path.join(str(d), pat)))


def _check_bundle(path):
    with open(path) as fh:
        b = json.load(fh)
    assert b["flight_bundle"] >= 1
    evs = b["ring"]["traceEvents"]
    assert isinstance(evs, list) and evs
    assert evs[0]["ph"] == "M"
    ts = [e["ts"] for e in evs[1:]]
    assert ts == sorted(ts)
    for e in evs[1:]:
        assert e["ph"] in ("X", "i") and "pid" in e and "tid" in e
    assert "counters" in b["metrics"] and "gauges" in b["metrics"]
    fp = b["fingerprint"]
    assert fp["pid"] == os.getpid()
    assert "env" in fp and "python" in fp
    assert fp["torch_version"] == torch.__version__
    return b


def _data(n=400, f=5, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.rand(n, f).astype(np.float32)
    y = (X[:, 0] + 0.2 * rng.rand(n) > 0.6).astype(np.float32)
    return X, y


# ------------------------------------------------------------ ring basics


def test_flight_ring_is_bounded():
    fr = FlightRecorder(max_events=64, enabled=True, max_dumps=0)
    for i in range(1000):
        fr.note("tick", i=i)
    evs = fr.ring_events()
    assert len(evs) == 64
    assert evs[-1]["args"]["i"] == 999


def test_flight_disabled_records_and_dumps_nothing(tmp_path):
    fr = FlightRecorder(enabled=False, out_dir=str(tmp_path))
    fr.note("x")
    fr.feed({"name": "y", "ph": "i", "ts": 0.0})
    assert fr.ring_events() == []
    assert fr.dump("manual") is None
    assert _bundles(tmp_path) == []


def test_flight_env_knobs(monkeypatch, tmp_path):
    monkeypatch.setenv("LIGHTGBM_TPU_FLIGHT", "0")
    monkeypatch.setenv("LIGHTGBM_TPU_FLIGHT_EVENTS", "16")
    monkeypatch.setenv("LIGHTGBM_TPU_FLIGHT_MAX_DUMPS", "3")
    monkeypatch.setenv("LIGHTGBM_TPU_FLIGHT_DIR", str(tmp_path))
    fr = FlightRecorder()
    assert not fr.enabled and fr._ring.maxlen == 16 and fr.max_dumps == 3
    assert fr.out_dir() == str(tmp_path)
    monkeypatch.setenv("LIGHTGBM_TPU_FLIGHT", "1")
    monkeypatch.setenv("LIGHTGBM_TPU_FLIGHT_EVENTS", "junk")
    assert FlightRecorder().enabled
    assert FlightRecorder()._ring.maxlen == 2048


def test_flight_manual_dump_bundle(tmp_path):
    fr = FlightRecorder(max_events=32, enabled=True, out_dir=str(tmp_path))
    fr.set_context(phase="test", rows=123)
    for i in range(5):
        fr.note("step", i=i, dur_us=10.0)
    fr.note_instant("planner.plan", {"variant": "fused"})
    p = fr.dump("manual", extra={"note": "hello"})
    assert p is not None and os.path.exists(p)
    b = _check_bundle(p)
    assert b["trigger"] == "manual"
    assert b["fingerprint"]["context"]["phase"] == "test"
    assert b["extra"]["note"] == "hello"
    names = [e["name"] for e in b["ring"]["traceEvents"]]
    assert "step" in names and "planner.plan" in names


def test_bundle_keys_match_the_jax_package(tmp_path):
    """The same notes, context, exception and extra through both
    packages' recorders give bundles with the same top-level keys and
    the same keys in their ring, exception and metrics sections."""
    def make(cls, sub):
        fr = cls(max_events=32, enabled=True, out_dir=str(tmp_path / sub))
        os.makedirs(str(tmp_path / sub))
        fr.set_context(phase="train", rows=10)
        rng = np.random.RandomState(0)
        for i in range(4):
            fr.note("engine.step", i=i, dur_us=float(rng.rand()))
        fr.note_instant("planner.plan", {"rows": 10})
        fr.sample_metrics(min_interval_s=0.0)
        try:
            raise RuntimeError("boom")
        except RuntimeError as e:
            path = fr.dump("engine.train:RuntimeError", exc=e,
                           extra={"k": 1})
        with open(path) as fh:
            return json.load(fh)

    j, p = make(JFlightRecorder, "jax"), make(FlightRecorder, "port")
    assert set(p) == set(j)
    assert set(p["ring"]) == set(j["ring"])
    assert set(p["exception"]) == set(j["exception"])
    assert set(p["metrics"]) <= {"counters", "gauges", "histograms",
                                 "components"}
    assert [e["name"] for e in p["ring"]["traceEvents"]] == \
        [e["name"] for e in j["ring"]["traceEvents"]]
    shared = {"pid", "time_unix", "argv", "python", "platform", "env",
              "context", "mesh"}
    assert shared <= set(p["fingerprint"]) and shared <= set(j["fingerprint"])


def test_flight_dump_rate_limit(tmp_path):
    fr = FlightRecorder(enabled=True, out_dir=str(tmp_path), max_dumps=2)
    assert fr.dump("a") and fr.dump("b")
    assert fr.dump("c") is None
    assert len(_bundles(tmp_path)) == 2


def test_flight_metric_deltas():
    fr = FlightRecorder(enabled=True, max_dumps=0)
    reg = MetricsRegistry()
    reg.counter("widgets_total").inc(3)
    fr.sample_metrics(reg, min_interval_s=0.0)
    reg.counter("widgets_total").inc(4)
    fr.sample_metrics(reg, min_interval_s=0.0)
    assert fr._metric_deltas()["deltas"]["widgets_total"] == 4


# ------------------------------------------------- failure-trigger dumps


class _FailingGroup:
    """A two-rank group whose collectives fail when waited on (a peer
    that vanished)."""

    def size(self):
        return 2

    def rank(self):
        return 0

    def name(self):
        return "gloo"

    def _work(self, *_a):
        class Work:
            def wait(self):
                raise RuntimeError("connection closed by peer")
        return Work()

    allreduce = allgather = _work


def test_collective_error_dumps_forensic_bundle(flight_dir):
    """A collective that fails leaves a parseable bundle and raises to
    its caller; the ring shows the route noted before it."""
    from lightgbm_tpu_torch.parallel.collectives import (all_gather_tiered,
                                                         psum_tiered)
    grp = _FailingGroup()
    with pytest.raises(RuntimeError):
        psum_tiered(torch.ones(4, dtype=torch.int64), grp)
    with pytest.raises(RuntimeError):
        all_gather_tiered(torch.ones(4), grp)
    bundles = _bundles(flight_dir, "flight_collective_*.json")
    assert len(bundles) == 2
    b = _check_bundle(bundles[0])
    assert b["exception"]["type"] == "RuntimeError"
    routes = [e for e in b["ring"]["traceEvents"]
              if e["name"] == "collective.route"]
    assert routes and routes[-1]["args"]["bytes"] == 32


def test_collective_spans_on_thread_ranks():
    """Two gloo thread ranks training data-parallel: every sum is a
    ``collective.reduce`` span with its bytes, and the histogram payload
    gauge is set."""
    from lightgbm_tpu_torch.obs.trace import global_tracer
    from lightgbm_tpu_torch.testing import thread_ranks
    X, y = _data(600, 4)
    P = {"objective": "binary", "num_leaves": 7, "verbose": -1,
         "tree_learner": "data"}
    global_tracer.reset()
    global_tracer.enable()
    try:
        thread_ranks(2, lambda rank, pg: lt.train(
            P, lt.Dataset(X, label=y, device="cpu"), 2))
        red = [e for e in global_tracer.events()
               if e["name"] == "collective.reduce"]
    finally:
        global_tracer.disable()
        global_tracer.reset()
    assert red and all(e["args"]["bytes"] > 0 for e in red)
    assert global_registry.to_dict()["gauges"][
        "train_psum_payload_bytes"] > 0


def test_serving_quarantine_dumps_forensic_bundle(flight_dir):
    """A low-precision model over its accuracy budget is quarantined at
    admission, and a swap to a NaN-leaf model at its probe: each leaves
    a bundle and the caller gets the typed error."""
    from lightgbm_tpu_torch.serving.errors import (LowPrecisionQuarantined,
                                                   SwapQuarantined)
    X, y = _data()
    bst = lt.train({"objective": "binary", "num_leaves": 15,
                    "verbosity": -1}, lt.Dataset(X, label=y, device="cpu"),
                   5)
    with pytest.raises(LowPrecisionQuarantined):
        bst.serve(backend="host", precision="int8", accuracy_budget=0.0)
    b = _check_bundle(_bundles(flight_dir, "flight_serving.swap_*.json")[0])
    assert b["exception"]["type"] == "LowPrecisionQuarantined"
    assert b["extra"]["precision"] == "int8"
    bad = lt.Booster(model_str=bst.model_to_string(), device="cpu")
    bad.models[0].leaf_value[0] = np.nan
    with bst.serve(backend="host") as srv:
        with pytest.raises(SwapQuarantined):
            srv.swap_model(bad)
    found = _bundles(flight_dir, "flight_serving.swap_SwapQuarantined_*")
    assert found
    assert _check_bundle(found[0])["extra"]["digest"]


def test_engine_loop_exception_dumps_bundle(flight_dir):
    X, y = _data(300, 4)

    def exploding_fobj(preds, ds):
        raise RuntimeError("boom at iteration 0")

    with pytest.raises(RuntimeError):
        lt.train({"objective": "binary", "num_leaves": 7, "verbosity": -1},
                 lt.Dataset(X, label=y, device="cpu"), 3,
                 fobj=exploding_fobj)
    b = _check_bundle(_bundles(flight_dir, "flight_engine.train_*.json")[0])
    assert b["exception"]["type"] == "RuntimeError"
    assert b["fingerprint"]["context"]["phase"] == "train"
    assert b["fingerprint"]["backend"] == "cpu"
    # the loop's watch ended with it: a stalled beat cannot breach
    assert "engine.step" not in global_watchdog._watched


# --------------------------------------------------------------- watchdog


def test_watchdog_stall_breach_and_dump(tmp_path):
    fl = FlightRecorder(enabled=True, out_dir=str(tmp_path))
    reg = MetricsRegistry()
    wd = Watchdog(SLOConfig(heartbeat_stale_s=0.05), registry=reg,
                  flight=fl)
    wd.watch_heartbeat("engine.step")
    time.sleep(0.12)
    assert [b[0] for b in wd.check_once()] == ["stall:engine.step"]
    key = 'slo_breach_total{slo="stall:engine.step"}'
    assert reg.to_dict()["counters"][key] == 1
    assert _bundles(tmp_path, "flight_watchdog_*.json")
    n = len(_bundles(tmp_path))
    wd.check_once()
    assert reg.to_dict()["counters"][key] == 2
    assert len(_bundles(tmp_path)) == n
    wd.beat("engine.step")
    assert wd.check_once() == []


def test_watchdog_unwatch_stops_stall_checks():
    wd = Watchdog(SLOConfig(heartbeat_stale_s=0.01),
                  registry=MetricsRegistry(),
                  flight=FlightRecorder(enabled=False))
    wd.watch_heartbeat("loop")
    wd.unwatch("loop")
    time.sleep(0.03)
    assert wd.check_once() == []


def test_watchdog_rate_floor():
    reg = MetricsRegistry()
    wd = Watchdog(SLOConfig(heartbeat_stale_s=100.0,
                            trees_per_sec_floor=50.0),
                  registry=reg, flight=FlightRecorder(enabled=False))
    wd.watch_heartbeat("engine.step", floor=50.0)
    wd._beats["engine.step"] = (100.0, 0)
    wd._rate_state["engine.step"] = (100.0, 0)
    wd._beats["engine.step"] = (101.0, 10)
    breaches = wd.check_once(now=101.0)
    assert [b[0] for b in breaches] == ["slo:engine.step"]
    assert breaches[0][1]["rate"] == 10.0
    wd._beats["engine.step"] = (102.0, 110)
    assert wd.check_once(now=102.0) == []


def test_watchdog_serving_p99_ceiling():
    reg = MetricsRegistry()
    hist = reg.histogram("request_latency_ms")
    for _ in range(100):
        hist.observe(3.0)
    assert histogram_p99_ms(hist) == 5.0
    wd = Watchdog(SLOConfig(serving_p99_ms=100.0), registry=reg,
                  flight=FlightRecorder(enabled=False))
    wd.watch_histogram_p99("serving", hist)
    assert wd.check_once() == []
    for _ in range(100):
        hist.observe(900.0)
    breaches = wd.check_once()
    assert [b[0] for b in breaches] == ["slo:serving"]
    assert breaches[0][1]["p99_ms"] > 100.0


def test_watchdog_sentry_thread_runs_checks(tmp_path):
    fl = FlightRecorder(enabled=True, out_dir=str(tmp_path))
    wd = Watchdog(SLOConfig(heartbeat_stale_s=0.03, check_interval_s=0.01),
                  registry=MetricsRegistry(), flight=fl)
    wd.watch_heartbeat("x")
    wd.start()
    try:
        deadline = time.time() + 5.0
        while time.time() < deadline and not _bundles(tmp_path):
            time.sleep(0.02)
    finally:
        wd.stop()
    assert not wd.running
    assert _bundles(tmp_path, "flight_watchdog_stall_x*.json")


def test_slo_config_from_env(monkeypatch):
    from lightgbm_tpu_torch.obs import watchdog as wd_mod
    for k in ("WATCHDOG", "SLO_TREES_PER_SEC", "SLO_SERVING_P99_MS",
              "SLO_MODEL_AGE_S", "SLO_AVAILABILITY", "SLO_HEARTBEAT_S",
              "WATCHDOG_INTERVAL_S"):
        monkeypatch.delenv("LIGHTGBM_TPU_" + k, raising=False)
    assert not wd_mod.maybe_start_from_env()        # opt-in only
    monkeypatch.setenv("LIGHTGBM_TPU_SLO_TREES_PER_SEC", "12.5")
    monkeypatch.setenv("LIGHTGBM_TPU_SLO_HEARTBEAT_S", "7")
    monkeypatch.setenv("LIGHTGBM_TPU_WATCHDOG_INTERVAL_S", "0.5")
    cfg = SLOConfig.from_env()
    assert cfg.trees_per_sec_floor == 12.5
    assert cfg.heartbeat_stale_s == 7.0 and cfg.check_interval_s == 0.5


def test_server_batcher_beats_its_heartbeat_name():
    """``ServingConfig(heartbeat_name=)`` is accepted and the batcher
    beats under that name while it runs."""
    X, y = _data()
    bst = lt.train({"objective": "binary", "num_leaves": 7,
                    "verbosity": -1}, lt.Dataset(X, label=y, device="cpu"),
                   2)
    with bst.serve(backend="host", heartbeat_name="serving.replica7") as srv:
        srv.predict(X[:4], timeout=30)
        age = global_watchdog.beat_age("serving.replica7")
        assert age is not None and age < 1.0
        assert srv.config.heartbeat_name == "serving.replica7"
        watched = [k for k in global_watchdog._hists
                   if k.startswith("serving_p99:")]
        assert watched
    assert not [k for k in global_watchdog._hists
                if k == f"serving_p99:{srv._obs_component}"]


# --------------------------------------------------- A/B recorder guard


def test_recorder_on_model_byte_identical_and_cheap():
    X, y = _data(2000, 6, seed=7)
    P = {"objective": "binary", "num_leaves": 15, "verbosity": -1,
         "deterministic": True}

    def run(enabled):
        was = global_flight.enabled
        global_flight.enabled = enabled
        try:
            return lt.train(P, lt.Dataset(X, label=y, device="cpu"), 5,
                            verbose_eval=False).model_to_string()
        finally:
            global_flight.enabled = was

    assert run(True) == run(False)
    fr = FlightRecorder(max_events=2048, enabled=True, max_dumps=0)
    t0 = time.perf_counter()
    for i in range(10_000):
        fr.note("engine.step", i=i, dur_us=1.0)
    per_note_s = (time.perf_counter() - t0) / 10_000
    assert per_note_s < 50e-6, f"note() costs {per_note_s * 1e6:.1f}us"


def test_flight_ring_sees_training_without_tracing(flight_dir):
    from lightgbm_tpu_torch.obs.trace import global_tracer
    assert not global_tracer.enabled
    X, y = _data(400, 4)
    lt.train({"objective": "binary", "num_leaves": 7, "verbosity": -1},
             lt.Dataset(X, label=y, device="cpu"), 3)
    assert global_tracer.events() == []
    names = {e["name"] for e in global_flight.ring_events()}
    assert "engine.step" in names and "planner.plan" in names


# -------------------------------------------------------- HTTP endpoint


def test_metrics_http_endpoint():
    from lightgbm_tpu_torch.obs.http import MetricsHTTPServer
    reg = MetricsRegistry()
    reg.counter("requests_total").inc(7)
    reg.gauge("depth").set(3)
    reg.histogram("lat_ms").observe(2.0)
    srv = MetricsHTTPServer(registry=reg, port=0)
    try:
        base = f"http://127.0.0.1:{srv.start()}"
        prom = urllib.request.urlopen(f"{base}/metrics",
                                      timeout=5).read().decode()
        assert "# TYPE lgbt_requests_total counter" in prom
        assert "lgbt_requests_total 7" in prom
        snap = json.loads(urllib.request.urlopen(
            f"{base}/metrics.json", timeout=5).read())
        assert snap["counters"]["requests_total"] == 7
        assert snap["gauges"]["depth"] == 3
        assert urllib.request.urlopen(f"{base}/healthz",
                                      timeout=5).read() == b"ok\n"
        with pytest.raises(urllib.error.HTTPError):
            urllib.request.urlopen(f"{base}/nope", timeout=5)
    finally:
        srv.stop()


def test_metrics_http_env_gate(monkeypatch):
    from lightgbm_tpu_torch.obs import http as obs_http
    monkeypatch.delenv("LIGHTGBM_TPU_METRICS_PORT", raising=False)
    obs_http.stop_process_server()
    assert obs_http.maybe_start_from_env() is None
    monkeypatch.setenv("LIGHTGBM_TPU_METRICS_PORT", "0")
    try:
        srv = obs_http.maybe_start_from_env()
        assert srv is not None and srv.port > 0
        assert obs_http.maybe_start_from_env() is srv
        prom = urllib.request.urlopen(
            f"http://127.0.0.1:{srv.port}/metrics", timeout=5
        ).read().decode()
        assert "# TYPE" in prom or prom == "\n"
    finally:
        obs_http.stop_process_server()


# ------------------------------------------------------ trace event cap


def test_tracer_caps_events_and_counts_drops():
    from lightgbm_tpu_torch.obs.trace import Tracer
    t = Tracer(enabled=True, max_events=10)
    for i in range(25):
        with t.span("s", i=i):
            pass
    assert len(t.events()) == 10 and t.dropped == 15
    tail = t.to_chrome_trace()["traceEvents"][-1]
    assert tail["name"] == "trace_events_dropped"
    assert tail["args"]["dropped"] == 15
    assert global_registry.to_dict()["gauges"]["trace_events_dropped"] >= 15
    t.reset()
    assert t.dropped == 0 and t.events() == []


def test_tracer_cap_env(monkeypatch):
    from lightgbm_tpu_torch.obs.trace import Tracer
    monkeypatch.setenv("LIGHTGBM_TPU_TRACE_MAX_EVENTS", "5")
    assert Tracer(enabled=True).max_events == 5
    monkeypatch.setenv("LIGHTGBM_TPU_TRACE_MAX_EVENTS", "junk")
    assert Tracer(enabled=True).max_events > 5

