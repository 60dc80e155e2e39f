"""The port's serving path (lightgbm_tpu_torch/serving/) on the CPU,
held against the JAX package's ``Booster.predict``.

The Server runs on ``device="cpu"``: routing goes through the traversal
kernel's plain version and leaf values are summed on the host in
float64, so every answer equals ``lightgbm_tpu``'s bit for bit.
"""

import json
import threading

import numpy as np
import pytest

import lightgbm_tpu as lgb

import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch.serving import (DeadlineExceeded, QueueFull,
                                        ServerClosed, ServingError)
from lightgbm_tpu_torch.testing import synthetic_model_text, synthetic_rows

F = 8
CATS = (2,)


@pytest.fixture(scope="module")
def models():
    text = synthetic_model_text(F, 25, 31, cat_features=CATS, seed=41)
    text3 = synthetic_model_text(F, 8, 15, num_class=3, cat_features=CATS,
                                 seed=42)
    return {
        1: (lgb.Booster(model_str=text),
            lt.Booster(model_str=text, device="cpu")),
        3: (lgb.Booster(model_str=text3),
            lt.Booster(model_str=text3, device="cpu")),
    }


def _bits(a):
    return np.ascontiguousarray(a, np.float64).view(np.uint64)


@pytest.mark.parametrize("backend", ["device", "host"])
def test_concurrent_mixed_sizes_bit_equal(models, backend):
    """~200 concurrent requests of 1-1500 rows (past max_batch_rows, so
    some split) from 8 threads; every answer equals lightgbm_tpu's."""
    jb, tb = models[1]
    rng = np.random.RandomState(3)
    sizes = np.minimum(np.exp(rng.uniform(0, np.log(1500), 200)).astype(int),
                       1500)
    sizes[:3] = [1, 1024, 1500]
    X = synthetic_rows(F, int(sizes.sum()), CATS, seed=41, row_seed=9)
    bounds = np.concatenate([[0], np.cumsum(sizes)])
    want = jb.predict(X, raw_score=True)
    srv = tb.serve(backend=backend, max_batch_rows=512, batch_window_ms=1.0)
    results = {}

    def client(ids):
        futs = [(i, srv.submit(X[bounds[i]:bounds[i + 1]])) for i in ids]
        for i, f in futs:
            results[i] = f.result(120)

    threads = [threading.Thread(target=client, args=(range(k, 200, 8),))
               for k in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(300)
        assert not t.is_alive()
    md = srv.metrics_dict()
    srv.close()
    assert len(results) == 200
    for i in range(200):
        assert np.array_equal(_bits(results[i]),
                              _bits(want[bounds[i]:bounds[i + 1]])), i
    assert md["counters"]["requests_completed"] == 200
    assert md["counters"]["rows_total"] == int(sizes.sum())
    assert md["histograms"]["request_latency_ms"]["count"] == 200
    assert md["counters"]["batches_total"] >= int(sizes.sum()) // 512


def test_transformed_and_multiclass(models):
    for K, (jb, tb) in models.items():
        X = synthetic_rows(F, 700, CATS, seed=41 if K == 1 else 42)
        with tb.serve(raw_score=False, max_batch_rows=256) as srv:
            futs = [srv.submit(X[s:s + 100]) for s in range(0, 700, 100)]
            got = np.concatenate([f.result(60) for f in futs])
        want = jb.predict(X)
        assert got.shape == want.shape
        assert np.array_equal(_bits(got), _bits(want))
        with tb.serve() as srv:
            raw = srv.predict(X[:5], timeout=60)
        assert np.array_equal(_bits(raw), _bits(jb.predict(X[:5],
                                                           raw_score=True)))


def test_deadline_rejection(models):
    _jb, tb = models[1]
    X = synthetic_rows(F, 8, CATS, seed=41)
    srv = tb.serve(max_batch_rows=64, batch_window_ms=0.5)
    fut = srv.submit(X, deadline_ms=1e-4)
    with pytest.raises(DeadlineExceeded):
        fut.result(10)
    out = srv.submit(X, deadline_ms=30_000).result(30)
    assert out.shape == (8,)
    md = srv.metrics_dict()
    srv.close()
    assert md["counters"]["requests_rejected_deadline"] >= 1


def test_queue_backpressure(models):
    _jb, tb = models[1]
    srv = tb.serve(max_batch_rows=64, max_queue_rows=128,
                   batch_window_ms=200.0)
    X = synthetic_rows(F, 64, CATS, seed=41)
    accepted = []
    with pytest.raises(QueueFull):
        for _ in range(64):                    # far beyond 128 queued rows
            accepted.append(srv.submit(X))
    assert srv.metrics_dict()["counters"]["requests_rejected_queue_full"] >= 1
    for fut in accepted:                       # reject-new, not drop-old
        assert fut.result(30).shape == (64,)
    # a request that can NEVER fit is not a retryable QueueFull
    with pytest.raises(ServingError) as ei:
        srv.submit(synthetic_rows(F, 129, CATS, seed=41))
    assert not isinstance(ei.value, QueueFull)
    with pytest.raises(ServingError, match="features"):
        srv.submit(X[:, :-1])
    srv.close()


def test_close_drains(models):
    _jb, tb = models[1]
    X = synthetic_rows(F, 16, CATS, seed=41)
    srv = tb.serve(max_batch_rows=64, batch_window_ms=100.0)
    futs = [srv.submit(X) for _ in range(4)]
    srv.close(drain=True, timeout=30)          # graceful: all served
    for f in futs:
        assert f.result(0).shape == (16,)
    with pytest.raises(ServerClosed):
        srv.submit(X)
    srv2 = tb.serve(max_batch_rows=64, batch_window_ms=500.0)
    futs2 = [srv2.submit(X) for _ in range(8)]
    srv2.close(drain=False, timeout=30)
    closed = 0
    for f in futs2:
        try:
            f.result(5)
        except ServerClosed:
            closed += 1
    assert closed >= 1                         # tail of the queue was failed
    assert not srv2._batcher._thread.is_alive()


def test_warm_and_module_serve(models, tmp_path):
    jb, tb = models[1]
    path = tmp_path / "m.txt"
    tb.save_model(str(path))
    with lt.serve(str(path), device="cpu", max_batch_rows=128) as srv:
        assert srv.warm() == len(srv.ladder.buckets)
        X = synthetic_rows(F, 3, CATS, seed=41)
        got = srv.predict(X, timeout=30)
        assert srv.metrics_dict()["counters"]["bucket_hits"] >= 1
        dumped = json.loads(srv.metrics_json(str(tmp_path / "m.json")))
        assert dumped == json.loads((tmp_path / "m.json").read_text())
        assert set(dumped) == {"counters", "gauges", "histograms"}
    assert np.array_equal(_bits(got), _bits(jb.predict(X, raw_score=True)))
