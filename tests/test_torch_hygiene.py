"""Hygiene of the port package lightgbm_tpu_torch: it imports neither JAX
nor the JAX package, its entry points never fall back to the CPU
quietly, its threads are daemons that end with their owner, and its
observability never starts a CUDA context or reads a tensor's values."""

import json
import os
import subprocess
import sys

import pytest

import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch.testing import synthetic_model_text
from lightgbm_tpu_torch.testing import one_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r"""
import importlib, json, pkgutil, sys
import lightgbm_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "lightgbm_tpu"))
print(json.dumps({"modules": names, "bad": bad}))
"""


def test_import_pulls_in_no_jax():
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["bad"] == []
    for mod in ("basic", "convert", "model_text", "predict", "testing",
                "tree", "obs.metrics", "ops._build", "ops.planner",
                "ops.predict_kernels", "serving.batcher", "serving.errors",
                "serving.registry", "serving.server", "utils.log",
                "binning", "dataset", "engine", "grower", "grower_rounds",
                "boosting.gbdt", "ops.fused", "ops.histogram", "ops.ingest",
                "ops.split", "tools.torch_ingest_compare", "compat",
                "io_utils", "sklearn", "utils.file_io", "utils.shap",
                "fleet", "fleet.lowprec", "native", "native.build",
                "serving.loadgen", "plotting", "parallel",
                "parallel.collectives", "parallel.network",
                "parallel.learners", "parallel.dist_data",
                "tools.torch_dist_check", "data", "data.blockstore",
                "data.stream", "data.score", "obs", "obs.trace",
                "obs.flight", "obs.watchdog", "obs.http",
                "serving.metrics", "utils.envflags", "utils.timer",
                "fleet.aot", "fleet.registry", "fleet.router",
                "fleet.topology", "resilience", "resilience.faults",
                "resilience.checkpoint", "resilience.retry", "capi",
                "application", "resilience.elastic",
                "tools.torch_collective_probe", "obs.aggregate",
                "obs.devprof", "obs.diagnose", "coresident",
                "coresident.control", "coresident.scheduler",
                "tools.obs_doctor"):
        assert f"lightgbm_tpu_torch.{mod}" in res["modules"]


def test_default_device_is_cuda_and_never_falls_back():
    import torch
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA; the refusal needs a host without")
    text = synthetic_model_text(3, 2, 4, seed=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        lt.Booster(model_str=text)
    with pytest.raises(RuntimeError, match="CUDA"):
        lt.Booster(model_str=text, device="cuda")
    assert lt.Booster(model_str=text, device="cpu").device.type == "cpu"
    # the serving fleet's default device is the card too
    for make in (lt.Fleet, lt.PodFleet):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()


def test_data_plane_never_falls_back_to_the_cpu(tmp_path):
    import numpy as np
    import torch
    from lightgbm_tpu_torch.data import BlockPump, BlockStore, IngestPump
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA; the refusal needs a host without")
    X = np.zeros((10, 3), np.float32)
    store = BlockStore.from_array(str(tmp_path / "st"), X, 4)
    for make in (lambda: BlockPump(store), lambda: IngestPump(X, 4),
                 lambda: lt.Dataset.from_sample(X, 10)):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()


@pytest.mark.parametrize("kind", ["block", "ingest"])
def test_pumps_start_no_thread_and_stop_with_the_consumer(tmp_path, kind):
    """A pump reads each item in its consumer's thread: it starts no
    thread, a consumer that stops early leaves nothing running, and the
    next pass starts again at the first item."""
    import threading

    import numpy as np
    from lightgbm_tpu_torch.data import BlockPump, BlockStore, IngestPump
    X = np.arange(4000 * 3, dtype=np.float32).reshape(4000, 3)
    if kind == "block":
        pump = BlockPump(BlockStore.from_array(str(tmp_path / "st"), X, 100),
                         device="cpu")
    else:
        pump = IngestPump(X, 100, device="cpu")
    before = threading.active_count()
    it = iter(pump)
    first = next(it)
    assert first[:3] == (0, 0, 100)
    assert threading.active_count() == before
    it.close()                        # the consumer stops after one item
    assert threading.active_count() == before
    assert pump.blocks == 1 and pump.passes == 1
    assert next(iter(pump))[:3] == (0, 0, 100)
    assert pump.passes == 2


@pytest.mark.parametrize("kind", ["block", "ingest"])
def test_read_ahead_thread_is_a_daemon_that_stops_with_the_consumer(
        tmp_path, kind):
    """``ReadAhead`` (bulk scoring's reader thread) runs its pump in a
    daemon thread, yields the pump's items in order (the blocks of a
    pass without it), and ends that thread when the consumer stops
    early."""
    import numpy as np
    import torch
    from lightgbm_tpu_torch.data import (BlockPump, BlockStore, IngestPump,
                                         ReadAhead)
    X = np.arange(4000 * 3, dtype=np.float32).reshape(4000, 3)
    if kind == "block":
        pump = BlockPump(BlockStore.from_array(str(tmp_path / "st"), X, 100),
                         device="cpu")
    else:
        pump = IngestPump(X, 100, device="cpu")
    plain = [(i, s, r, t.clone()) for i, s, r, t in pump]
    ahead = ReadAhead(pump, depth=2)
    got = list(ahead)
    assert [g[:3] for g in got] == [(i, 100 * i, 100) for i in range(40)]
    for (_, _, _, a), (_, _, _, b) in zip(got, plain):
        assert torch.equal(a, b)
    assert not ahead.thread.is_alive() and ahead.passes == 2
    it = iter(ahead)
    assert next(it)[:3] == (0, 0, 100)
    t = ahead.thread
    assert t.daemon and t.is_alive()
    it.close()                        # the consumer stops after one item
    assert not t.is_alive()
    assert ahead.passes == 3 and ahead.blocks <= 80 + 1 + 3


def test_sentry_and_http_threads_are_daemons_that_end_on_stop():
    """The watchdog's sentry and the metrics endpoint are host threads:
    daemons, named, ended (and joined) by ``stop()``."""
    import threading

    from lightgbm_tpu_torch.obs.flight import FlightRecorder
    from lightgbm_tpu_torch.obs.http import MetricsHTTPServer
    from lightgbm_tpu_torch.obs.metrics import MetricsRegistry
    from lightgbm_tpu_torch.obs.watchdog import SLOConfig, Watchdog
    before = threading.active_count()
    wd = Watchdog(SLOConfig(check_interval_s=0.01),
                  registry=MetricsRegistry(),
                  flight=FlightRecorder(enabled=False))
    wd.start()
    srv = MetricsHTTPServer(registry=MetricsRegistry(), port=0)
    srv.start()
    threads = [wd._thread, srv._thread]
    assert all(t.daemon and t.is_alive() for t in threads)
    assert {t.name for t in threads} == {"lgbt-slo-watchdog",
                                         "lgbt-metrics-http"}
    wd.stop()
    srv.stop()
    assert not any(t.is_alive() for t in threads) and not wd.running
    assert threading.active_count() == before


def test_pod_fleet_threads_are_daemons_that_end_on_close():
    """A ``PodFleet``'s health sweep is a daemon thread, its host-path
    fallback pool and its device fleets' batchers are host threads, and
    ``close()`` ends every one of them within a timeout."""
    import threading
    import time

    import numpy as np
    before = {t.ident for t in threading.enumerate()}
    pod = lt.PodFleet(devices=2, device="cpu", max_batch_rows=16)
    b = lt.Booster(model_str=synthetic_model_text(4, 3, 6, seed=2),
                   device="cpu")
    pod.add_model("m", b)
    assert pod.predict("m", np.zeros((3, 4)), timeout=30).shape == (3,)
    pod._fallback_pool.submit(lambda: None).result(timeout=30)
    health = pod._health_thread
    pool = list(pod._fallback_pool._threads)
    assert health.daemon and health.is_alive()
    assert health.name == "lgbt-pod-health" and pool
    started = [t for t in threading.enumerate() if t.ident not in before]
    assert health in started and set(pool) <= set(started)
    pod.close(timeout=10)
    deadline = time.monotonic() + 10
    while any(t.is_alive() for t in started) and \
            time.monotonic() < deadline:
        time.sleep(0.02)
    assert not any(t.is_alive() for t in started), \
        [t.name for t in started if t.is_alive()]


def test_fingerprint_starts_no_cuda_context(monkeypatch):
    """``flight.fingerprint()`` leaves ``torch.cuda.is_initialized()`` as
    it found it: it names the card only where CUDA is initialised, and
    never calls the lazy initialiser."""
    import torch
    from lightgbm_tpu_torch.obs.flight import FlightRecorder
    was = torch.cuda.is_initialized()
    inits = []
    monkeypatch.setattr(torch.cuda, "_lazy_init",
                        lambda *a, **k: inits.append(1))
    fp = FlightRecorder(enabled=True).fingerprint()
    assert torch.cuda.is_initialized() == was and inits == []
    assert fp["torch_version"] == torch.__version__
    assert fp["cuda_version"] == torch.version.cuda
    if not was:
        assert fp["backend"] == "cpu" and "device_kind" not in fp
    # where a context exists, the card is named
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda i=None: "Example Card")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    fp = FlightRecorder(enabled=True).fingerprint()
    assert fp["backend"] == "cuda" and fp["device_kind"] == "Example Card"
    assert fp["n_devices"] == 1 and inits == []


def test_flight_never_reads_a_tensors_values(tmp_path):
    """A tensor among a note's arguments becomes its shape, dtype and
    device: no ATen op runs on it (``float(t)``, ``repr(t)`` or
    ``t.tolist()`` of a CUDA tensor would copy it to the host), and a
    meta tensor, which has no values to read, dumps fine."""
    import json

    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from lightgbm_tpu_torch.obs.flight import FlightRecorder, _json_safe

    class Ops(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.ops.append(str(func))
            return func(*args, **(kwargs or {}))

    t = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    scalar = torch.tensor(1.5)
    with Ops() as mode:
        got = _json_safe({"t": t, "s": scalar, "deep": [[[[t]]]],
                          "pair": (t, 3)})
    assert mode.ops == []
    assert got["t"] == {"tensor": [2, 3], "dtype": "torch.float32",
                        "device": "cpu"}
    assert got["s"]["tensor"] == [] and got["pair"][1] == 3
    fr = FlightRecorder(enabled=True, out_dir=str(tmp_path))
    meta = torch.empty((4, 5), device="meta")
    fr.note("x", peak=meta, k=torch.zeros((), device="meta"))
    with Ops() as mode:
        path = fr.dump("manual", extra={"leaf": meta})
    assert mode.ops == []
    with open(path) as fh:
        b = json.load(fh)
    ev = [e for e in b["ring"]["traceEvents"] if e["name"] == "x"][0]
    assert ev["args"]["peak"]["device"] == "meta"
    assert b["extra"]["leaf"]["tensor"] == [4, 5]


_NO_OPTIONAL = r"""
import json, sys
for name in ("pandas", "sklearn", "matplotlib"):
    sys.modules[name] = None          # import raises ImportError
import numpy as np
import scipy.sparse as sps
import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch import compat
rng = np.random.RandomState(0)
X = rng.randn(600, 5).astype(np.float32)
X[X < 0.2] = 0.0
y = (X[:, 0] + 0.3 * rng.randn(600) > 0.1).astype(np.float32)
params = {"objective": "binary", "num_leaves": 5, "verbose": -1,
          "min_data_in_leaf": 10}
ds = lt.Dataset(sps.csr_matrix(X), label=y, device="cpu")
res = lt.cv(params, ds, 2, nfold=3, stratified=False)
try:
    lt.cv(params, lt.Dataset(X, label=y, device="cpu"), 1, nfold=3)
    strat = "ran"
except ImportError:
    strat = "ImportError"
bst = lt.train(params, lt.Dataset(sps.csr_matrix(X), label=y, device="cpu"),
               2, verbose_eval=False)
refit = bst.refit(X, y, decay_rate=0.5)
contrib = bst.predict(sps.csr_matrix(X), pred_contrib=True)
raw = bst.predict(X, raw_score=True, device=False)
from lightgbm_tpu_torch import sklearn as sk
est = sk.LGBMRegressor(device="cpu", n_estimators=2).fit(X, y)
try:
    lt.plot_importance(bst)
    plot = "ran"
except ImportError:
    plot = "ImportError"
bad = sorted(m for m in sys.modules if sys.modules[m] is not None
             and m.split(".")[0] in ("jax", "jaxlib", "lightgbm_tpu",
                                     "pandas", "sklearn", "matplotlib"))
print(json.dumps({
    "flags": [compat.PANDAS_INSTALLED, compat.SKLEARN_INSTALLED,
              compat.MATPLOTLIB_INSTALLED],
    "cv_keys": sorted(res), "stratified": strat,
    "refit_trees": refit.num_trees(),
    "contrib_ok": bool(np.allclose(contrib.sum(axis=1), raw, rtol=1e-9)),
    "sk_pred": int(len(est.predict(X))), "plot": plot, "bad": bad}))
"""


def test_optional_packages_stay_optional():
    """With pandas, scikit-learn and matplotlib unimportable, the package
    imports, bins CSR input, cross-validates without stratification
    (stratified folds raise ImportError, as the JAX package's do), refits,
    gives SHAP contributions and fits the stand-in estimators, on the
    CPU, and a plotting call raises ImportError; none of its modules
    pulls in JAX or the JAX package."""
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", _NO_OPTIONAL], cwd=REPO,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["flags"] == [False, False, False]
    assert res["cv_keys"] == ["binary_logloss-mean", "binary_logloss-stdv"]
    assert res["stratified"] == "ImportError"
    assert res["refit_trees"] == 2 and res["contrib_ok"]
    assert res["sk_pred"] == 600
    assert res["plot"] == "ImportError"
    assert res["bad"] == []
