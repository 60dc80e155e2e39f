"""The port's observability plane (``lightgbm_tpu_torch/obs/``,
``utils/timer.py``) against the JAX package's (``tests/test_obs.py``):
the tracer, the process registry and its Prometheus text, the timer,
and the training and serving call sites, on the CPU.

Parity with ``lightgbm_tpu``, on the same inputs made from a NumPy seed:

- the same registry contents give byte-equal ``to_prometheus()`` and
  equal ``to_dict()`` in both packages (labelled series and child
  registries included);
- the same 3-round training with tracing on records the same set of
  span and instant names in both, minus ``ONE_PACKAGE`` (names that
  belong to one package only, each with why).

The card's constraint is held here on the CPU's eager round body: a
tree is one ``trace.grow_tree_rounds`` span and no event is recorded a
round (the round body is a captured CUDA graph on the card, where an
event would record once, at capture).  The devprof, checkpoint and
chaos cases of tests/test_obs.py belong to modules the port has not
ported (ROADMAP queue A8 and A11 rest).
"""

import json
import threading
import time
from collections import Counter

import numpy as np
import pytest

import lightgbm_tpu as lgb
from lightgbm_tpu.obs import metrics as jmetrics
from lightgbm_tpu.obs.trace import global_tracer as jtracer

import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch.obs.metrics import MetricsRegistry, global_registry
from lightgbm_tpu_torch.obs.trace import (Tracer, _NULL_SPAN, global_tracer,
                                          span, span_coverage)
from lightgbm_tpu_torch.utils.timer import Timer, global_timer
from lightgbm_tpu_torch.testing import one_thread  # noqa: F401

# span and instant names one package records and the other does not
ONE_PACKAGE = {
    # the port bins f32 rows through B3 (its plain version on the CPU);
    # the JAX package bins on the host off an accelerator
    "ingest.device_bin",
    # a Pallas bit-exactness probe, skipped on purpose in the port
    "ingest.parity_probe",
}

P = {"objective": "binary", "num_leaves": 7, "verbosity": -1,
     "tpu_tree_growth": "rounds", "tpu_hist_method": "fused"}


def _data(n=500, f=4, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.rand(n, f).astype(np.float32)
    y = (X[:, 0] + 0.2 * rng.rand(n) > 0.6).astype(np.float32)
    return X, y


@pytest.fixture
def tracing():
    global_tracer.reset()
    global_tracer.enable()
    try:
        yield global_tracer
    finally:
        global_tracer.disable()
        global_tracer.reset()


# -------------------------------------------------------------- trace core


def test_spans_record_and_nest():
    t = Tracer(enabled=True)
    with t.span("outer", kind="test"):
        with t.span("inner"):
            pass
    evs = t.events()
    assert [e["name"] for e in evs] == ["inner", "outer"]
    inner, outer = evs
    assert outer["ts"] <= inner["ts"]
    assert inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"] + 1e-6
    for e in evs:
        assert e["ph"] == "X" and "pid" in e and "tid" in e
    assert outer["args"]["kind"] == "test"


def test_span_closes_under_exception():
    t = Tracer(enabled=True)
    with pytest.raises(ValueError):
        with t.span("outer"):
            with t.span("boom"):
                raise ValueError("x")
    evs = {e["name"]: e for e in t.events()}
    assert set(evs) == {"outer", "boom"}
    assert evs["boom"]["args"]["error"] == "ValueError"
    assert evs["outer"]["args"]["error"] == "ValueError"


def test_disabled_mode_is_shared_null_span():
    t = Tracer(enabled=False)
    cm = t.span("x", a=1)
    assert cm is _NULL_SPAN
    with cm:
        pass
    t.instant("y")
    assert t.events() == []
    was = global_tracer.enabled
    global_tracer.disable()
    try:
        assert span("z") is _NULL_SPAN
    finally:
        global_tracer.enabled = was


def test_chrome_trace_json_validates():
    t = Tracer(enabled=True)

    def worker():
        with t.span("thread_span"):
            pass

    th = threading.Thread(target=worker)
    with t.span("main_span"):
        th.start()
        th.join(10)
    t.instant("marker", note=1)
    doc = json.loads(json.dumps(t.to_chrome_trace()))
    evs = doc["traceEvents"]
    assert len(evs) == 4
    ts = [e["ts"] for e in evs]
    assert ts == sorted(ts)
    for e in evs:
        assert "pid" in e and "tid" in e and "ts" in e
        assert e["ph"] in ("X", "i", "M")
    assert len({e["tid"] for e in evs if e["ph"] == "X"}) == 2


def test_dump_and_coverage(tmp_path):
    t = Tracer(enabled=True)
    with t.span("root"):
        with t.span("a"):
            time.sleep(0.02)
        with t.span("b"):
            time.sleep(0.02)
    cov = span_coverage(t.events(), "root")
    assert cov is not None and cov > 0.9
    p = t.dump(str(tmp_path / "trace.json"))
    with open(p) as fh:
        assert "traceEvents" in json.load(fh)


def test_trace_env_gate_and_exit_path(monkeypatch, tmp_path):
    from lightgbm_tpu_torch.obs import trace as tr
    monkeypatch.delenv("LIGHTGBM_TPU_TRACE", raising=False)
    assert not Tracer().enabled and tr.trace_path() is None
    monkeypatch.setenv("LIGHTGBM_TPU_TRACE", "1")
    assert Tracer().enabled and tr.trace_path() is None
    out = str(tmp_path / "t.json")
    monkeypatch.setenv("LIGHTGBM_TPU_TRACE", out)
    assert Tracer().enabled and tr.trace_path() == out


# ------------------------------------------------ training and serving


def test_training_emits_spans_and_registry_instruments(tracing):
    X, y = _data()
    lt.train({"objective": "binary", "num_leaves": 7, "verbosity": -1},
             lt.Dataset(X, label=y, device="cpu"), num_boost_round=3)
    names = {e["name"] for e in tracing.events()}
    for name in ("engine.train", "engine.step", "planner.plan",
                 "planner.plan_stream", "trace.grow_tree_rounds"):
        assert name in names, name
    assert names & {"macro.dispatch", "gbdt.dispatch"}
    assert names & {"macro.host_fetch", "gbdt.finish_iter"}
    cov = span_coverage(tracing.events(), "engine.train")
    assert cov is not None and cov > 0.9
    d = global_registry.to_dict()
    assert d["counters"].get("train_iterations_total", 0) >= 3
    assert d["gauges"]["train_hist_method"] == "fused"
    assert d["gauges"].get("train_hist_predicted_peak_bytes", 0) > 0
    # the CPU has no card limit: no budget gauge from this run
    plan = [e for e in tracing.events() if e["name"] == "planner.plan"][-1]
    assert plan["args"]["budget_bytes"] is None
    assert plan["args"]["growth"] == "rounds" and plan["args"]["kcap"] == 6


def test_training_disabled_trace_stays_empty():
    global_tracer.reset()
    assert not global_tracer.enabled
    X, y = _data(300)
    lt.train({"objective": "binary", "num_leaves": 7, "verbosity": -1},
             lt.Dataset(X, label=y, device="cpu"), num_boost_round=2)
    assert global_tracer.events() == []


def test_one_grow_span_a_tree_and_no_event_a_round(tracing):
    """A tree is one ``trace.grow_tree_rounds`` span, and the number of
    events does not depend on the rounds a tree takes: a 31-leaf model
    (more rounds a tree) records what a 3-leaf one does."""
    X, y = _data(800)
    counts = {}
    for leaves in (3, 31):
        tracing.reset()
        b = lt.train(dict(P, num_leaves=leaves), lt.Dataset(
            X, label=y, device="cpu"), 4, verbose_eval=False)
        c = Counter(e["name"] for e in tracing.events())
        assert c["trace.grow_tree_rounds"] == b.num_trees() == 4
        counts[leaves] = c
    rounds = [r for r, _live in b.boosting.grower.round_counts]
    assert max(rounds) > 3            # the 31-leaf trees took more rounds
    assert counts[3] == counts[31]


def test_serial_and_streamed_growers_name_their_trees(tracing):
    X, y = _data(600)
    lt.train(dict(P, tpu_tree_growth="serial"),
             lt.Dataset(X, label=y, device="cpu"), 2, verbose_eval=False)
    c = Counter(e["name"] for e in tracing.events())
    assert c["trace.grow_tree"] == 2 and not c["trace.grow_tree_rounds"]
    tracing.reset()
    from lightgbm_tpu_torch.data import stream_override
    with stream_override(force=True, block_rows=256):
        b = lt.Booster(P, train_set=lt.Dataset(X, label=y, device="cpu"))
    for _ in range(2):
        b.update()
    c = Counter(e["name"] for e in tracing.events())
    assert c["stream.tree"] == 2 and c["stream.iteration"] == 2
    assert c["gbdt.finish_iter"] == 2 and c["stream.root_pass"] == 2
    assert c["stream.round_pass"] == sum(
        r for r, _ in b.boosting.grower.round_counts)
    assert c["stream.block_put"] == 3 * (c["stream.root_pass"]
                                         + c["stream.round_pass"])
    assert c["planner.plan_stream"] == 1 and c["stream.spill"] == 1
    g = global_registry.to_dict()["gauges"]
    assert g["stream_num_blocks"] == 3 and g["stream_block_rows"] == 256
    assert g["host_rss_peak_bytes"] > 0


@pytest.fixture(scope="session")
def jax_trace_names():
    """The JAX package's 3-round training's event names (tracing on)."""
    X, y = _data()
    jtracer.reset()
    jtracer.enable()
    try:
        lgb.train(P, lgb.Dataset(X, label=y), 3,
                  valid_sets=[lgb.Dataset(X[:100], label=y[:100])],
                  verbose_eval=False)
        return {e["name"] for e in jtracer.events()}
    finally:
        jtracer.disable()
        jtracer.reset()


def test_training_event_names_match_the_jax_package(jax_trace_names,
                                                    tracing):
    X, y = _data()
    lt.train(P, lt.Dataset(X, label=y, device="cpu"), 3,
             valid_sets=[lt.Dataset(X[:100], label=y[:100], device="cpu")],
             verbose_eval=False)
    port = {e["name"] for e in tracing.events()}
    assert port - ONE_PACKAGE == jax_trace_names - ONE_PACKAGE
    assert "gbdt.eval" in port and "engine.eval" in port


def test_server_joins_process_registry_and_prometheus(tracing):
    X, y = _data(300, 5)
    bst = lt.train({"objective": "binary", "num_leaves": 7,
                    "verbosity": -1}, lt.Dataset(X, label=y, device="cpu"),
                   3)
    srv = bst.serve(max_batch_rows=64, backend="host")
    try:
        srv.predict(X[:16], timeout=30)
        comp = global_registry.to_dict().get("components", {})
        assert any(k.startswith("serving") for k in comp)
        assert "lgbt_serving_requests_total 1" in srv.prometheus_text()
        assert "lgbt_serving_requests_total 1" in \
            global_registry.to_prometheus()
    finally:
        srv.close()
    comp = global_registry.to_dict().get("components", {})
    assert not any(v is srv.metrics for v in comp.values())
    names = Counter(e["name"] for e in tracing.events())
    for name in ("serving.admit", "serving.complete", "serving.batch",
                 "serving.dispatch"):
        assert names[name] >= 1, name


# ------------------------------------------------- the process registry


def test_serving_metrics_shim_is_the_obs_registry():
    from lightgbm_tpu_torch.serving.metrics import (LATENCY_BUCKETS_MS,
                                                    MetricsRegistry as Shim)
    assert Shim is MetricsRegistry
    assert LATENCY_BUCKETS_MS[-1] == float("inf")
    r = Shim()
    r.counter("requests_total").inc(2)
    r.gauge("queue_depth_rows").set(5)
    r.histogram("request_latency_ms").observe(3.0)
    d = r.to_dict()
    assert sorted(d.keys()) == ["counters", "gauges", "histograms"]
    assert d["counters"] == {"requests_total": 2}
    assert d["gauges"] == {"queue_depth_rows": 5}
    h = d["histograms"]["request_latency_ms"]
    assert h["count"] == 1 and h["buckets"] == {"5.0": 1}
    json.loads(r.dump_json())


def test_registry_components():
    root = MetricsRegistry()
    child = MetricsRegistry()
    child.counter("x").inc()
    assert root.attach_child("serving", child) == "serving"
    assert root.attach_child("serving", MetricsRegistry()) == "serving_2"
    assert set(root.children()) == {"serving", "serving_2"}
    d = root.to_dict()
    assert d["components"]["serving"]["counters"]["x"] == 1
    root.detach_child("serving")
    root.detach_child("serving_2")
    assert "components" not in root.to_dict()


def test_prometheus_exposition():
    r = MetricsRegistry()
    r.counter("requests_total").inc(7)
    r.gauge("queue_depth").set(3)
    r.gauge("active_model_digest").set("abc123")
    h = r.histogram("latency_ms", buckets=(1.0, 10.0))
    for v in (0.5, 5.0, 100.0):
        h.observe(v)
    child = MetricsRegistry()
    child.counter("hits").inc()
    r.attach_child("serving", child)
    text = r.to_prometheus(prefix="lgbt")
    assert "# TYPE lgbt_requests_total counter\nlgbt_requests_total 7" in text
    assert "lgbt_queue_depth 3" in text
    assert 'lgbt_active_model_digest_info{value="abc123"} 1' in text
    assert 'lgbt_latency_ms_bucket{le="1.0"} 1' in text
    assert 'lgbt_latency_ms_bucket{le="10.0"} 2' in text
    assert 'lgbt_latency_ms_bucket{le="+Inf"} 3' in text
    assert "lgbt_latency_ms_count 3" in text
    assert "lgbt_serving_hits 1" in text
    for line in text.strip().splitlines():
        if not line.startswith("#"):
            float(line.rsplit(" ", 1)[1])


def _fill(reg, rng):
    """The same random contents into a registry of either package:
    counters, numeric and string gauges, histograms, labelled series
    (label values with the characters Prometheus escapes) and a child."""
    for i in range(3):
        reg.counter(f"c{i}_total").inc(int(rng.randint(0, 100)))
        reg.gauge(f"g{i}").set(float(rng.rand()))
    reg.gauge("digest").set("d" + str(rng.randint(1000)))
    reg.gauge("flag").set(True)
    h = reg.histogram("lat_ms")
    for v in rng.exponential(20.0, 50):
        h.observe(float(v))
    r = reg.histogram("ratio", buckets=(0.25, 0.5, 1.0))
    for v in rng.rand(10):
        r.observe(float(v))
    for model in ("a", 'q"uote', "new\nline", "back\\slash"):
        reg.counter("requests_total", labels={"model": model}).inc(
            int(rng.randint(1, 9)))
        reg.gauge("age_s", labels={"model": model, "z": "1"}).set(
            float(rng.rand()))
        reg.histogram("model_lat_ms", labels={"model": model}).observe(
            float(rng.rand() * 100))
    return reg


@pytest.mark.parametrize("seed", [0, 1])
def test_registry_output_equals_the_jax_package(seed):
    jreg = _fill(jmetrics.MetricsRegistry(), np.random.RandomState(seed))
    preg = _fill(MetricsRegistry(), np.random.RandomState(seed))
    jchild = _fill(jmetrics.MetricsRegistry(), np.random.RandomState(9))
    pchild = _fill(MetricsRegistry(), np.random.RandomState(9))
    jreg.attach_child("serving", jchild)
    preg.attach_child("serving", pchild)
    assert preg.to_prometheus() == jreg.to_prometheus()
    assert preg.to_prometheus(prefix="x") == jreg.to_prometheus(prefix="x")
    assert preg.to_dict() == jreg.to_dict()
    assert preg.dump_json() == jreg.dump_json()


def test_global_registry_and_get_registry():
    from lightgbm_tpu_torch import obs
    assert obs.get_registry() is obs.global_registry is global_registry
    for name in ("span", "instant", "trace_enabled", "trace_path",
                 "span_coverage", "Tracer", "global_tracer",
                 "MetricsRegistry", "global_registry", "get_registry",
                 "Counter", "Gauge", "Histogram", "LATENCY_BUCKETS_MS",
                 "RATIO_BUCKETS", "FlightRecorder", "global_flight",
                 "Watchdog", "SLOConfig", "global_watchdog"):
        assert hasattr(obs, name), name
    import lightgbm_tpu.obs as jobs
    assert set(obs.__all__) == set(jobs.__all__)


# ------------------------------------------------------------ the timer


def test_timer_accumulates_and_function_timer():
    from lightgbm_tpu_torch.utils.timer import function_timer
    t = Timer(enabled=True)
    with t.section("A::B"):
        pass
    with t.section("A::B"):
        pass

    @function_timer("fn", timer=t)
    def f(x):
        return x + 1

    assert f(1) == 2
    assert t.items()["A::B"][0] == 2 and t.items()["fn"][0] == 1
    off = Timer(enabled=False)
    with off.section("x"):
        pass
    assert off.items() == {}


def test_timer_json_dump(tmp_path):
    t = Timer(enabled=True)
    for _ in range(2):
        with t.section("A::B"):
            pass
    d = t.to_dict()
    assert d["A::B"]["calls"] == 2 and d["A::B"]["total_s"] >= 0
    p = tmp_path / "timers.json"
    s = t.dump_json(str(p))
    loaded = json.loads(p.read_text())
    assert loaded == json.loads(s)
    assert loaded["timers"]["A::B"]["calls"] == 2


def test_timer_env_json_mode(tmp_path, monkeypatch):
    out = tmp_path / "t.json"
    monkeypatch.setenv("LIGHTGBM_TPU_TIMETAG", f"json:{out}")
    from lightgbm_tpu_torch.utils import timer as timer_mod
    assert Timer().enabled
    was = global_timer.enabled
    global_timer.enable()
    try:
        with global_timer.section("ExitDump::Test"):
            pass
        timer_mod._print_at_exit()
    finally:
        global_timer.enabled = was
    assert "ExitDump::Test" in json.loads(out.read_text())["timers"]


def test_timer_publish_mirrors_registry():
    t = Timer(enabled=True)
    with t.section("Pub::X"):
        pass
    reg = MetricsRegistry()
    t.publish(reg)
    g = reg.to_dict()["gauges"]
    assert g["timer.Pub::X.calls"] == 1 and g["timer.Pub::X.total_s"] >= 0


def test_training_tags_hot_paths(monkeypatch):
    """The JAX package's timer tags on the port's per-iteration path
    (LGBM_TPU_CHUNK=0: one update() a round)."""
    monkeypatch.setenv("LGBM_TPU_CHUNK", "0")
    global_timer.reset()
    global_timer.enable()
    try:
        X, y = _data()
        bst = lt.train({"objective": "binary", "num_leaves": 7,
                        "verbosity": -1},
                       lt.Dataset(X, label=y, device="cpu"), 3)
        bst.predict(X[:10])
        items = global_timer.items()
        for key in ("Dataset::Construct", "GBDT::TrainOneIter",
                    "TreeLearner::Train(dispatch)",
                    "GBDT::FinishIter(host trees)", "Booster::Predict"):
            assert key in items, (key, sorted(items))
        assert items["GBDT::TrainOneIter"][0] == 3
    finally:
        global_timer.disable()
        global_timer.reset()


def test_training_tags_chunked():
    """3 rounds under the default chunk cap: a chunk of 2 and one of 1,
    each one dispatch and one host fetch."""
    global_timer.reset()
    global_timer.enable()
    try:
        X, y = _data()
        lt.train({"objective": "binary", "num_leaves": 7, "verbosity": -1},
                 lt.Dataset(X, label=y, device="cpu"), 3)
        items = global_timer.items()
        assert items["TreeLearner::Train(dispatch)"][0] == 2
        assert items["GBDT::FinishIter(host trees)"][0] == 2
    finally:
        global_timer.disable()
        global_timer.reset()
