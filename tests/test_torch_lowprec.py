"""Low-precision serving in the port (``fleet/lowprec.py``, the bf16 and
int8 threshold planes of ``DeviceForest`` and ``predict_kernels``, and
the registry's accuracy budget), held against the JAX package (mirrors
tests/test_fleet.py's quantization and low-precision cases).

- ``quantize_forest`` gives the JAX package's bytes for bf16 and int8,
  and ``forest_digest`` its hex;
- ``torch.bfloat16`` rounds as ``ml_dtypes.bfloat16`` does on exact
  halfway points (built from the bf16 bit patterns) and their
  neighbours;
- the plain B1 on the bf16 and int8 planes routes as the JAX
  ``DeviceForest(precision=...)`` and as the quantised forest's host
  path, on rows that sit exactly on the grid's thresholds too;
- served answers equal the quantised forest's host path bit for bit,
  the budget quarantines on admission and on swap, and the caller's
  probe batch is the one measured.
"""

import numpy as np
import pytest
import torch

import lightgbm_tpu as lgb
from lightgbm_tpu.fleet.lowprec import quantize_forest as jax_quantize
from lightgbm_tpu.ops import predict_kernels as jax_pk
from lightgbm_tpu.predict import DeviceForest as JaxDeviceForest
from lightgbm_tpu.serving.registry import forest_digest as jax_digest

import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch.fleet import lowprec
from lightgbm_tpu_torch.ops import predict_kernels as pk
from lightgbm_tpu_torch.predict import DeviceForest
from lightgbm_tpu_torch.serving import LowPrecisionQuarantined
from lightgbm_tpu_torch.serving.registry import forest_digest
from lightgbm_tpu_torch.testing import (salt_rows, synthetic_model_text,
                                        synthetic_rows)
from lightgbm_tpu_torch.testing import one_thread  # noqa: F401

F = 8
CATS = (2,)
WAIT = 60
PRECISIONS = ("bf16", "int8")


@pytest.fixture(scope="module")
def models():
    text = synthetic_model_text(F, 30, 31, cat_features=CATS, seed=51)
    text3 = synthetic_model_text(F, 6, 15, num_class=3, cat_features=CATS,
                                 seed=52)
    out = {}
    for K, t in ((1, text), (3, text3)):
        jb = lgb.Booster(model_str=t)
        tb = lt.Booster(model_str=t, device="cpu")
        n_iter = len(tb.models) // K
        out[K] = (jb, tb, jb._forest(0, n_iter), tb._forest(0, n_iter))
    return out


def _rows(K, n=600):
    return salt_rows(synthetic_rows(F, n, CATS, seed=51 if K == 1 else 52,
                                    row_seed=7))


@pytest.mark.parametrize("precision", ("f32",) + PRECISIONS)
@pytest.mark.parametrize("K", (1, 3))
def test_quantize_forest_bytes_and_digest(models, precision, K):
    _jb, _tb, jf, tf = models[K]
    jq, tq = jax_quantize(jf, precision), lowprec.quantize_forest(tf,
                                                                   precision)
    names = ["threshold", "leaf_value"]
    if precision == "int8":
        names += ["threshold_q", "threshold_scale", "threshold_skip"]
    for name in names:
        a, b = np.asarray(getattr(jq, name)), getattr(tq, name)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert a.tobytes() == b.tobytes(), name
    assert forest_digest(tq) == jax_digest(jq)
    if precision != "f32":
        assert forest_digest(tq) != forest_digest(tf)
        # categorical indices and the +inf padding are kept verbatim
        skip = ~np.isfinite(tf.threshold) | tf.is_cat
        assert np.array_equal(tq.threshold[skip], tf.threshold[skip])


def test_quantize_refuses_unknown_precision(models):
    with pytest.raises(ValueError, match="fp4"):
        lowprec.quantize_forest(models[1][3], "fp4")
    assert lowprec.quantize_forest(models[1][3], "f32") is models[1][3]


def test_int8_rows_skip_mask():
    a = np.array([[1.0, -2.0, np.inf], [0.0, 0.0, 0.0]])
    q, scale, deq = lowprec.int8_rows(a)
    assert q[0, 2] == 0 and deq[0, 2] == np.inf
    assert np.all(q[1] == 0) and np.all(deq[1] == 0.0)
    assert abs(deq[0, 1] - (-2.0)) <= 2.0 / 127
    q, scale, deq = lowprec.int8_rows(a, skip=np.array([[0, 1, 0], [0] * 3],
                                                       bool))
    assert q[0, 1] == 0 and deq[0, 1] == -2.0 and q[0, 0] == 127
    assert scale.dtype == np.float32 and scale[0] == np.float32(1) / 127


def test_bf16_rounding_equals_ml_dtypes():
    import ml_dtypes
    bits = np.arange(1 << 16, dtype=np.uint32).astype(np.uint16)
    with np.errstate(invalid="ignore"):         # the NaN patterns
        lo = bits.view(ml_dtypes.bfloat16).astype(np.float64)
        hi = (bits.astype(np.uint32) + 1).astype(np.uint16) \
            .view(ml_dtypes.bfloat16).astype(np.float64)
    ok = (np.isfinite(lo) & np.isfinite(hi) & (bits != 0x7FFF)
          & (bits != 0xFFFF) & (np.sign(lo) == np.sign(hi)))
    lo, hi = lo[ok], hi[ok]
    mid = (lo + hi) / 2                 # exact halfway points
    step = hi - lo
    vals = np.concatenate([
        mid, np.nextafter(mid, np.inf), np.nextafter(mid, -np.inf),
        mid + step * 2.0 ** -20, mid - step * 2.0 ** -20, lo, hi,
        [0.0, -0.0, np.inf, -np.inf]])
    want = vals.astype(ml_dtypes.bfloat16).astype(np.float64)
    got = lowprec.bf16_round(vals)
    assert np.array_equal(got.view(np.uint64), want.view(np.uint64))


@pytest.mark.parametrize("precision", PRECISIONS)
@pytest.mark.parametrize("K", (1, 3))
def test_plain_b1_routes_as_the_jax_device_forest(models, precision, K):
    _jb, _tb, jf, tf = models[K]
    jq, tq = jax_quantize(jf, precision), lowprec.quantize_forest(tf,
                                                                   precision)
    dev = DeviceForest(tq, "cpu", precision=precision, routing_only=True)
    jdev = JaxDeviceForest(jq, precision=precision, routing_only=True)
    # the widened plane is the JAX one and the host grid, bit for bit
    plane = pk.full_threshold_f32(dev).numpy()
    assert np.array_equal(plane.view(np.int32),
                          np.asarray(jax_pk.full_threshold_f32(jdev))
                          .view(np.int32))
    assert np.array_equal(plane.astype(np.float64), tq.threshold)
    assert dev.threshold.dtype == {"bf16": torch.bfloat16,
                                   "int8": torch.int8}[precision]
    # rows on the grid's thresholds route as the f64 host compare does
    X = _rows(K)
    for f in (0, 1):
        sel = (tq.split_feature == f) & np.isfinite(tq.threshold) \
            & ~tq.is_cat
        on_grid = tq.threshold[sel][:len(X) // 4]
        X[f * len(X) // 4:f * len(X) // 4 + len(on_grid), f] = on_grid
    leaves = dev.predict_leaf(X)
    assert np.array_equal(leaves, jdev.predict_leaf(X))
    assert np.array_equal(leaves, tq.predict_leaf(X))
    # the host path of the quantised forest and the served answer agree
    raw = dev.predict_raw_padded(X, num_class=K)
    assert np.array_equal(raw, tq.predict_raw(X, num_class=K))
    with pytest.raises(ValueError, match="routing-only"):
        dev.predict_raw(X, num_class=K)
    with pytest.raises(ValueError, match="routing-only"):
        pk.fused_traverse(dev, dev._to_device(X), K, emit_scores=True)


def test_device_forest_needs_the_grid(models):
    tf = models[1][3]
    with pytest.raises(ValueError, match="grid"):
        DeviceForest(tf, "cpu", precision="bf16")
    with pytest.raises(ValueError, match="threshold_q"):
        DeviceForest(lowprec.quantize_forest(tf, "bf16"), "cpu",
                     precision="int8")
    with pytest.raises(ValueError, match="precision"):
        DeviceForest(tf, "cpu", precision="fp8")


@pytest.mark.parametrize("precision", PRECISIONS)
@pytest.mark.parametrize("backend", ["device", "host"])
def test_lowprec_serves_the_quantized_forest_bitwise(models, precision,
                                                     backend):
    for K in (1, 3):
        _jb, tb, _jf, tf = models[K]
        X = _rows(K, 300)
        with tb.serve(precision=precision, accuracy_budget=10.0,
                      backend=backend, max_batch_rows=128) as srv:
            delta = srv.metrics.gauge("lowprec_accuracy_delta").value
            assert 0 < delta <= 10.0
            assert srv.metrics.gauge("lowprec_precision").value == precision
            m = srv.models.active
            assert m.forest is not m.forest_full
            if backend == "device":
                assert m.device_forest.routing_only
                assert m.device_forest.leaf_value is None
            got = srv.predict(X, timeout=WAIT)
        want = m.forest.predict_raw(X, num_class=K)
        assert np.array_equal(got, want[0] if K == 1 else want.T)
        drift = np.max(np.abs(got - tb.predict(X, raw_score=True,
                                               device=False)))
        assert 0 < drift


def test_lowprec_budget_quarantines_add_and_swap(models):
    tb, tb3 = models[1][1], lt.Booster(model_str=synthetic_model_text(
        F, 12, 31, cat_features=CATS, seed=53), device="cpu")
    with pytest.raises(LowPrecisionQuarantined):
        tb.serve(precision="int8", accuracy_budget=0.0)
    with tb.serve(precision="bf16", accuracy_budget=10.0) as srv:
        old = srv.models.active.digest
        srv.models.accuracy_budget = 1e-12
        with pytest.raises(LowPrecisionQuarantined):
            srv.swap_model(tb3)
        assert srv.models.active.digest == old
        c = srv.metrics_dict()["counters"]
        assert c["lowprec_quarantines"] == 1 == c["swap_quarantines"]
        assert srv.metrics.gauge("model_generation").value == 0
        assert srv.predict(_rows(1, 9), timeout=WAIT).shape == (9,)
        srv.models.accuracy_budget = 10.0
        srv.swap_model(tb3)
        assert srv.metrics.gauge("model_generation").value == 1


def test_lowprec_caller_probe_batch(models):
    _jb, tb, _jf, tf = models[1]
    probe = _rows(1, 64)
    with tb.serve(precision="int8", accuracy_budget=10.0,
                  probe_X=probe) as srv:
        delta = srv.metrics.gauge("lowprec_accuracy_delta").value
        m = srv.models.active
    assert delta == lowprec.measure_accuracy_delta(tf, m.forest, probe)
    assert delta == m.measure_accuracy(probe)
    rng = np.random.RandomState(0x1F1EE7)
    noise = rng.randn(256, F).astype(np.float32).astype(np.float64)
    with tb.serve(precision="int8", accuracy_budget=10.0) as srv:
        assert srv.metrics.gauge("lowprec_accuracy_delta").value == \
            lowprec.measure_accuracy_delta(tf, m.forest, noise)


def test_forest_precision_bytes_ladder(models):
    tf = models[1][3]
    sizes = {p: lowprec.forest_precision_bytes(tf, p)
             for p in ("f32", "bf16", "int8")}
    assert sizes["f32"]["threshold_bytes"] > \
        sizes["bf16"]["threshold_bytes"] > sizes["int8"]["threshold_bytes"]
    assert sizes["bf16"]["leaf_bytes"] == 0 < sizes["f32"]["leaf_bytes"]
    T, I = tf.threshold.shape
    assert sizes["int8"]["threshold_bytes"] == T * I + 4 * T
