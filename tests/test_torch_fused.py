"""The port's fused histogram -> split functions (lightgbm_tpu_torch/
ops/fused.py) held against the JAX package's Pallas megakernel
(lightgbm_tpu/ops/fused.py) in interpret mode: the functions named after
the JAX package's (f32 histograms at the interface), and the fixed-point
entries the grower calls (``frontier_splits``; ``accumulate`` then
``sibling_scan`` in leaf mode, as at the root) at the scales the grower
uses, ``fixed_point_scales(vals)``.

On the CPU the port runs the plain versions of its kernels: exact int64
fixed-point histograms (ops/histogram.py) and the f32 gain scan
(ops/split.py).  Tolerances:

- dyadic values (g = k/8 with |k| <= 64, h in {1, k/4}, 0/1 weights):
  every f32 sum is exact in both packages, so the histograms and all six
  per-feature-best tuples are equal (``np.array_equal``: +0.0 == -0.0);
- random f32 values: counts are exact; grad/hess cells agree to
  rtol=1e-5, atol=1e-6 * max|v| over the channel's per-row values (the
  reference's own f32 rounding of its sums; measured: 1.9e-6 on grad
  cells up to 38.7 and 3.1e-5 on hess cells up to 386, at most 0.064 of
  the bound); thresholds and default_left are equal; gains agree to
  rtol=1e-5.

The meta vector covers the missing types NONE / ZERO / NaN, features
with num_bin <= 2, a one-bin feature, bins past num_bin and a padded
(num_bin 0) feature.  The CUDA kernels are held against the plain
versions bit for bit on the card by chip_smoke.py.
"""

import contextlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightgbm_tpu.ops import fused as JFU
from lightgbm_tpu.ops.split import SplitHyperparams as JHP

from lightgbm_tpu_torch.ops import fused as TFU
from lightgbm_tpu_torch.ops import planner
from lightgbm_tpu_torch.ops.histogram import (_vals_t, accumulate_plain,
                                              fixed_point_scales, to_fixed)
from lightgbm_tpu_torch.ops.split import SplitHyperparams as THP
from lightgbm_tpu_torch.ops.split import fixed_to_f32
from lightgbm_tpu_torch.testing import one_thread  # noqa: F401

N, F, B, K = 2000, 8, 16, 3
NUM_BIN = np.array([16, 16, 16, 2, 9, 1, 0, 12], np.int32)
MISSING = np.array([0, 2, 1, 2, 1, 0, 0, 2], np.int32)
DEFAULT = np.array([0, 0, 4, 0, 0, 0, 0, 3], np.int32)
HP = dict(min_data_in_leaf=5, lambda_l2=0.5, min_sum_hessian_in_leaf=0.01)
FIELDS = ("gain", "threshold", "default_left", "left_sum_grad",
          "left_sum_hess", "left_count")


def _data(seed: int, dyadic: bool, drop_all: bool = False):
    rng = np.random.RandomState(seed)
    binned = np.stack([rng.randint(0, max(nb, 1), N) for nb in NUM_BIN]
                      ).astype(np.uint8)
    if dyadic:
        g = rng.randint(-64, 65, N) / 8.0
        h = np.where(rng.rand(N) < 0.5, 1.0, rng.randint(1, 9, N) / 4.0)
        w = (rng.rand(N) > 0.2).astype(np.float64)
    else:
        g = rng.randn(N)
        h = np.abs(rng.randn(N)) + 0.1
        w = (rng.rand(N) > 0.2).astype(np.float64)
    vals = (np.stack([g, h, np.ones(N)]) * w).astype(np.float32)
    slot = np.where(rng.rand(N) < 0.7, rng.randint(0, K, N), K)
    if drop_all:
        slot[:] = K
    more = np.where(rng.rand(N) < 0.6, rng.randint(0, K, N), K)
    slot_parent = np.where(slot < K, slot, more)
    small_left = rng.rand(K) < 0.5
    return binned, vals, slot.astype(np.int32), slot_parent, small_left


def _hist64(binned, vals, slot):
    """[K, 3, F, B] float64 sums (exact for the dyadic data)."""
    out = np.zeros((K, 3, F, B))
    rows = np.nonzero(slot < K)[0]
    for f in range(F):
        for c in range(3):
            np.add.at(out[:, c, f], (slot[rows], binned[f, rows]),
                      vals[c, rows].astype(np.float64))
    return out


def _children_sums(small, parent, small_left):
    sl = small_left[:, None, None, None]
    left = np.where(sl, small, parent - small)
    kids = np.concatenate([left, parent - left])
    # feature 0's bins partition every child's rows
    return kids[:, :, 0, :].sum(-1).T.astype(np.float32)      # [3, 2K]


def _meta_j():
    return jnp.asarray(NUM_BIN), jnp.asarray(MISSING), jnp.asarray(DEFAULT)


def _meta_t():
    return (torch.from_numpy(NUM_BIN), torch.from_numpy(MISSING),
            torch.from_numpy(DEFAULT))


def _run(seed, dyadic, drop_all=False):
    binned, vals, slot, slot_parent, small_left = _data(seed, dyadic,
                                                        drop_all)
    small64 = _hist64(binned, vals, slot)
    parent = _hist64(binned, vals, slot_parent).astype(np.float32)
    csums = _children_sums(small64, parent.astype(np.float64), small_left)
    ssums = small64[:, :, 0, :].sum(-1).T.astype(np.float32)   # [3, K]
    jb, jv, js = jnp.asarray(binned), jnp.asarray(vals), jnp.asarray(slot)
    tb, tv, ts = (torch.from_numpy(binned), torch.from_numpy(vals),
                  torch.from_numpy(slot))
    jhp, thp = JHP(**HP), THP(**HP)
    out = {}
    out["frontier"] = (
        JFU.fused_frontier_splits(jb, jv, js, K, B, jnp.asarray(csums),
                                  jnp.asarray(small_left),
                                  jnp.asarray(parent), *_meta_j(), jhp,
                                  interpret=True),
        TFU.fused_frontier_splits(tb, tv, ts, K, B, torch.from_numpy(csums),
                                  torch.from_numpy(small_left),
                                  torch.from_numpy(parent), *_meta_t(), thp))
    out["segment"] = (
        JFU.fused_segment_splits(jb, jv, js, K, B, jnp.asarray(ssums),
                                 *_meta_j(), jhp, interpret=True),
        TFU.fused_segment_splits(tb, tv, ts, K, B, torch.from_numpy(ssums),
                                 *_meta_t(), thp))
    out["accumulate"] = (
        JFU.fused_frontier_accumulate(jb, jv, js, K, B, interpret=True),
        TFU.fused_frontier_accumulate(tb, tv, ts, K, B))
    small32 = small64.astype(np.float32)
    out["scan_parent"] = (
        JFU.fused_sibling_scan(jnp.asarray(small32), jnp.asarray(csums),
                               *_meta_j(), jhp,
                               small_left=jnp.asarray(small_left),
                               parent_hist=jnp.asarray(parent),
                               interpret=True),
        TFU.fused_sibling_scan(torch.from_numpy(small32),
                               torch.from_numpy(csums), *_meta_t(), thp,
                               small_left=torch.from_numpy(small_left),
                               parent_hist=torch.from_numpy(parent)))
    out["scan_leaf"] = (
        JFU.fused_sibling_scan(jnp.asarray(small32), jnp.asarray(ssums),
                               *_meta_j(), jhp, interpret=True),
        TFU.fused_sibling_scan(torch.from_numpy(small32),
                               torch.from_numpy(ssums), *_meta_t(), thp))
    # the grower's entries, at the grower's scales
    scales = fixed_point_scales(tv)
    parent_q = accumulate_plain(tb, tv, torch.from_numpy(
        slot_parent.astype(np.int32)), K, B, scales)
    seg, best = TFU.frontier_splits(
        tb, tv, ts, K, B, scales, torch.from_numpy(csums),
        torch.from_numpy(small_left), parent_q, *_meta_t(), thp)
    out["frontier_direct"] = (out["frontier"][0],
                              (fixed_to_f32(seg, scales, 1), best))
    hist = TFU.accumulate(tb, tv, ts, K, B, scales)
    best = TFU.sibling_scan(hist, scales, torch.from_numpy(ssums),
                            *_meta_t(), thp)
    out["segment_direct"] = (out["segment"][0],
                             (fixed_to_f32(hist, scales, 1), best))
    out["max_v"] = np.abs(vals).max(axis=1)
    return out


@pytest.fixture(scope="module")
def dyadic():
    return _run(seed=3, dyadic=True)


@pytest.fixture(scope="module")
def random_f32():
    return _run(seed=5, dyadic=False)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _split(pair):
    j, t = pair
    if isinstance(j, tuple) and len(j) == 2:     # (hist, best)
        return (j[0], j[1]), (t[0], t[1])
    if hasattr(j, "_fields"):                     # best only
        return (None, j), (None, t)
    return (j, None), (t, None)                  # hist only


FUNCTIONS = ["frontier", "segment", "accumulate", "scan_parent", "scan_leaf",
             "frontier_direct", "segment_direct"]


@pytest.mark.parametrize("fn", FUNCTIONS)
def test_dyadic_values_are_equal(dyadic, fn):
    (jh, jbest), (th, tbest) = _split(dyadic[fn])
    if jh is not None:
        assert np.array_equal(_np(jh), _np(th))
    if jbest is not None:
        for name in FIELDS:
            assert np.array_equal(_np(getattr(jbest, name)),
                                  _np(getattr(tbest, name))), name


@pytest.mark.parametrize("fn", FUNCTIONS)
def test_random_values_within_f32_rounding(random_f32, fn):
    (jh, jbest), (th, tbest) = _split(random_f32[fn])
    if jh is not None:
        jh, th = _np(jh), _np(th)
        assert np.array_equal(jh[:, 2], th[:, 2])          # counts exact
        for c in (0, 1):
            atol = 1e-6 * float(random_f32["max_v"][c])
            np.testing.assert_allclose(th[:, c], jh[:, c], rtol=1e-5,
                                       atol=atol)
    if jbest is not None:
        for name in ("threshold", "default_left"):
            assert np.array_equal(_np(getattr(jbest, name)),
                                  _np(getattr(tbest, name))), name
        jg, tg = _np(jbest.gain), _np(tbest.gain)
        assert np.array_equal(np.isfinite(jg), np.isfinite(tg))
        fin = np.isfinite(jg)
        assert fin.any()
        np.testing.assert_allclose(tg[fin], jg[fin], rtol=1e-5)


def test_missing_rules_and_dead_features(dyadic):
    """One-bin and padded features never split; a num_bin <= 2 NaN
    feature gets default_left = False (plain scan), features without a
    missing type default_left = True."""
    _, best = dyadic["frontier"][1]
    gain = best.gain.numpy()
    assert np.isneginf(gain[:, 5]).all()          # every row in one bin
    assert np.isneginf(gain[:, 6]).all()          # num_bin 0
    dl = best.default_left.numpy()
    assert not dl[:, 3].any()                     # NaN type, num_bin 2
    assert dl[:, 0].all() and dl[:, 5].all()      # MissingType NONE


def test_all_rows_dropped():
    out = _run(seed=7, dyadic=True, drop_all=True)
    (jh, jbest), (th, tbest) = _split(out["segment"])
    assert not _np(th).any()
    assert np.array_equal(_np(jh), _np(th))
    assert np.isneginf(_np(tbest.gain)).all()
    for name in FIELDS:
        assert np.array_equal(_np(getattr(jbest, name)),
                              _np(getattr(tbest, name))), name


def test_fixed_point_round_trip_is_exact():
    """A prefix exactly representable in f32 converts exactly at 2**-s,
    and dyadic values scale to integers with no rounding."""
    s = 20
    exact = np.array([3 * 2.0 ** 20, -5 * 2.0 ** -10, 2.0 ** 23 + 1,
                      -(2.0 ** 24), 0.125, 0.0], np.float32)
    p = to_fixed(torch.from_numpy(exact)[None, :], [s], 0)
    assert np.array_equal((p.numpy()[0].astype(np.float64)
                           * 2.0 ** -s), exact.astype(np.float64))
    back = fixed_to_f32(p, [s], 0).numpy()[0]
    assert back.tobytes() == exact.tobytes()


def test_scales_bound_every_sum():
    rng = np.random.RandomState(0)
    vals = torch.from_numpy((rng.randn(3, 5000) * [[3.0], [0.2], [1.0]])
                            .astype(np.float32))
    scales = fixed_point_scales(vals)
    for c, s in enumerate(scales):
        m = float(vals[c].abs().max()) * vals.shape[1]
        assert m * 2.0 ** s < 2.0 ** 62 <= 2 * (m + 1) * 2.0 ** s
    q = to_fixed(vals, scales, 0)
    err = (q.double() * torch.tensor([2.0 ** -s for s in scales],
                                     dtype=torch.float64)[:, None]
           - vals.double()).abs().max(dim=1).values
    for c, s in enumerate(scales):
        assert float(err[c]) <= 2.0 ** -(s + 1)


def test_plain_accumulate_is_order_free():
    """Integer sums: shuffling the rows leaves every bit in place."""
    binned, vals, slot, _, _ = _data(11, dyadic=False)
    perm = np.random.RandomState(1).permutation(N)
    tv = torch.from_numpy(vals)
    sc = fixed_point_scales(tv)
    a = accumulate_plain(torch.from_numpy(binned), tv,
                         torch.from_numpy(slot), K, B, sc)
    b = accumulate_plain(torch.from_numpy(binned[:, perm].copy()),
                         torch.from_numpy(vals[:, perm].copy()),
                         torch.from_numpy(slot[perm].copy()), K, B, sc)
    assert torch.equal(a, b)
    # the count channel of every feature holds the slotted member rows
    members = int(((slot < K) & (vals[2] > 0)).sum())
    assert (a[:, 2].sum(dim=(0, 2)) == members << sc[2]).all()


def test_vals_block():
    g = torch.tensor([1.0, -2.0, 3.0])
    h = torch.tensor([0.5, 0.25, 1.0])
    w = torch.tensor([1.0, 0.0, 2.0])
    v = _vals_t(g, h, w)
    assert v.tolist() == [[1.0, -0.0, 6.0], [0.5, 0.0, 2.0],
                          [1.0, 0.0, 2.0]]


def test_counts_rise_only_where_a_kernel_launches(monkeypatch):
    """Each launch count rises where its kernel is launched, a B2 at the
    scan launch that completes its pair; with the launchers replaced by
    their plain versions no count rises.  (The CUDA library is faked,
    so the test needs no card.)"""
    calls = {}

    class Lib:
        def fused_slot_order(self, *args):
            calls["sort"] = args
            return 0

        def fused_accumulate(self, *args):
            calls["accumulate"] = args
            return 0

        def fused_scan(self, *args):
            return 0

    monkeypatch.setattr(TFU, "_lib", Lib)
    monkeypatch.setattr(TFU, "_check_device", lambda *ts: "cuda")
    monkeypatch.setattr(TFU, "_stream", lambda t: 0)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    binned, vals, slot, slot_parent, small_left = _data(3, dyadic=True)
    tb, tv, ts = (torch.from_numpy(binned), torch.from_numpy(vals),
                  torch.from_numpy(slot))
    scales = fixed_point_scales(tv)
    parent = accumulate_plain(tb, tv, torch.from_numpy(
        slot_parent.astype(np.int32)), K, B, scales)
    csums = torch.ones((3, 2 * K))
    sl = torch.from_numpy(small_left)

    def pair():
        return TFU.frontier_splits(tb, tv, ts, K, B, scales, csums, sl,
                                   parent, *_meta_t(), THP(**HP))

    TFU.reset_launch_counts()
    seg, _ = pair()
    assert TFU.launch_counts == {"fused_frontier_splits": 1,
                                 "fused_frontier_accumulate": 1,
                                 "fused_sibling_scan": 1,
                                 "fused_slot_order": 1,
                                 "fused_frontier_splits_int8": 0,
                                 "fused_frontier_accumulate_int8": 0,
                                 "fused_sibling_scan_int8": 0,
                                 "fused_slot_order_int8": 0}
    TFU.sibling_scan(seg, scales, csums, *_meta_t(), THP(**HP),
                     small_left=sl, parent=parent)
    assert TFU.launch_counts["fused_sibling_scan"] == 2
    assert TFU.launch_counts["fused_frontier_splits"] == 1
    # the grids launched are the planner's: sort blocks, segments
    n = ts.shape[0]
    assert calls["sort"][3] == planner.sort_blocks(n)
    assert calls["accumulate"][11:13] == (planner.acc_seg_rows(n),
                                          planner.acc_segments(n, K))
    TFU._slot_order_cuda(ts, K, tv, scales)   # counts under its own key
    assert TFU.launch_counts["fused_slot_order"] == 2
    assert TFU.launch_counts["fused_frontier_accumulate"] == 1
    monkeypatch.setattr(TFU, "_accumulate_cuda", TFU.accumulate_plain)
    monkeypatch.setattr(TFU, "_scan_cuda",
                        lambda *args, pair=False, plan=None, **kw:
                        TFU.scan_plain(*args, **kw))
    TFU.reset_launch_counts()
    pair()
    assert not any(TFU.launch_counts.values())


# ----------------------------------------------------------------------
# the quantized (int8 / int32) mode
# ----------------------------------------------------------------------
# Levels as quantize_gradients makes them: grad in [-qg, qg], hess in
# [0, qh], zero for non-member rows.  "dyadic": num_grad_quant_bins = 2
# (qg = qh = 1) at the power-of-two scales max|g| = 0.5 and max|h| = 0.25
# (g_scale 0.5, h_scale 0.25): every f32 value and sum is exact in both
# packages, so the tuples are bit-identical.  "random": 16 bins (qg 7,
# qh 15) at scales that are not powers of two: the JAX package sums the
# f32 per-bin values fl(q_b * s), the port rounds each exact integer
# prefix once, so gains agree to rtol=1e-5 and the structure (threshold,
# default_left) and the estimated counts (exact integers in both) are
# equal.  The histograms are int32 sums and equal in both cases.
QSCALES = {True: (2, 0.5, 0.25), False: (16, 0.0371, 0.0123)}


def _hist_int(binned, vq, slot):
    out = np.zeros((K, 2, F, B), np.int64)
    rows = np.nonzero(slot < K)[0]
    for f in range(F):
        for c in range(2):
            np.add.at(out[:, c, f], (slot[rows], binned[f, rows]),
                      vq[c, rows].astype(np.int64))
    return out.astype(np.int32)


def _qsums(hist, gs, hs, counts):
    tot = hist[:, :, 0, :].astype(np.int64).sum(-1)          # [NC, 2]
    return np.stack([tot[:, 0].astype(np.float32) * np.float32(gs),
                     tot[:, 1].astype(np.float32) * np.float32(hs),
                     counts.astype(np.float32)])


def _run_quant(seed, dyadic):
    from lightgbm_tpu_torch.ops.split import QuantScales
    binned, vals, slot, slot_parent, small_left = _data(seed, True)
    bins, gs, hs = QSCALES[dyadic]
    qg, qh = max(bins // 2 - 1, 1), bins - 1
    rng = np.random.RandomState(seed + 100)
    member = vals[2] > 0
    vq = (np.stack([rng.randint(-qg, qg + 1, N), rng.randint(0, qh + 1, N)])
          * member).astype(np.int8)
    small = _hist_int(binned, vq, slot)
    parent = _hist_int(binned, vq, slot_parent.astype(np.int32))
    sl = small_left[:, None, None, None]
    left = np.where(sl, small, parent - small)
    kids = np.concatenate([left, parent - left])
    ones = np.stack([member, member]).astype(np.int8)
    n_small = _hist_int(binned, ones, slot)[:, 0, 0].sum(-1)
    n_par = _hist_int(binned, ones, slot_parent.astype(np.int32))[:, 0, 0]
    n_par = n_par.sum(-1)
    n_left = np.where(small_left, n_small, n_par - n_small)
    csums = _qsums(kids, gs, hs, np.concatenate([n_left, n_par - n_left]))
    ssums = _qsums(small, gs, hs, n_small)
    jq = (np.float32(gs), np.float32(hs))
    ts_ = QuantScales(float(np.float32(gs)), float(np.float32(hs)))
    jb, jv, js = jnp.asarray(binned), jnp.asarray(vq), jnp.asarray(slot)
    tb, tv, ts = (torch.from_numpy(binned), torch.from_numpy(vq),
                  torch.from_numpy(slot))
    jhp, thp = JHP(**HP), THP(**HP)
    out = {}
    out["frontier"] = (
        JFU.fused_frontier_splits(jb, jv, js, K, B, jnp.asarray(csums),
                                  jnp.asarray(small_left),
                                  jnp.asarray(parent), *_meta_j(), jhp,
                                  quant_scales=jq, interpret=True),
        TFU.fused_frontier_splits(tb, tv, ts, K, B, torch.from_numpy(csums),
                                  torch.from_numpy(small_left),
                                  torch.from_numpy(parent), *_meta_t(), thp,
                                  quant_scales=jq))
    out["segment"] = (
        JFU.fused_segment_splits(jb, jv, js, K, B, jnp.asarray(ssums),
                                 *_meta_j(), jhp, quant_scales=jq,
                                 interpret=True),
        TFU.fused_segment_splits(tb, tv, ts, K, B, torch.from_numpy(ssums),
                                 *_meta_t(), thp, quant_scales=jq))
    out["accumulate"] = (
        JFU.fused_frontier_accumulate(jb, jv, js, K, B, interpret=True),
        TFU.fused_frontier_accumulate(tb, tv, ts, K, B))
    out["scan_parent"] = (
        JFU.fused_sibling_scan(jnp.asarray(small), jnp.asarray(csums),
                               *_meta_j(), jhp,
                               small_left=jnp.asarray(small_left),
                               parent_hist=jnp.asarray(parent),
                               quant_scales=jq, interpret=True),
        TFU.fused_sibling_scan(torch.from_numpy(small),
                               torch.from_numpy(csums), *_meta_t(), thp,
                               small_left=torch.from_numpy(small_left),
                               parent_hist=torch.from_numpy(parent),
                               quant_scales=jq))
    out["scan_leaf"] = (
        JFU.fused_sibling_scan(jnp.asarray(small), jnp.asarray(ssums),
                               *_meta_j(), jhp, quant_scales=jq,
                               interpret=True),
        TFU.fused_sibling_scan(torch.from_numpy(small),
                               torch.from_numpy(ssums), *_meta_t(), thp,
                               quant_scales=jq))
    # the grower's entries: B2 and B4 + B5 (leaf mode) with QuantScales
    seg, best = TFU.frontier_splits(
        tb, tv, ts, K, B, ts_, torch.from_numpy(csums),
        torch.from_numpy(small_left), torch.from_numpy(parent), *_meta_t(),
        thp)
    out["frontier_direct"] = (out["frontier"][0], (seg, best))
    hist = TFU.accumulate(tb, tv, ts, K, B)
    out["segment_direct"] = (out["segment"][0], (hist, TFU.sibling_scan(
        hist, ts_, torch.from_numpy(ssums), *_meta_t(), thp)))
    return out


@pytest.fixture(scope="module")
def quant_dyadic():
    return _run_quant(seed=3, dyadic=True)


@pytest.fixture(scope="module")
def quant_random():
    return _run_quant(seed=5, dyadic=False)


@pytest.mark.parametrize("fn", FUNCTIONS)
def test_quantized_dyadic_scales_are_bit_identical(quant_dyadic, fn):
    (jh, jbest), (th, tbest) = _split(quant_dyadic[fn])
    if jh is not None:
        assert _np(th).dtype == np.int32
        assert np.array_equal(_np(jh), _np(th))
    if jbest is not None:
        assert np.isfinite(_np(tbest.gain)).any()
        for name in FIELDS:
            j, t = _np(getattr(jbest, name)), _np(getattr(tbest, name))
            if j.dtype == np.float32:
                j, t = j.view(np.int32), t.view(np.int32)
            assert np.array_equal(j, t), name


@pytest.mark.parametrize("fn", FUNCTIONS)
def test_quantized_random_scales_same_structure(quant_random, fn):
    (jh, jbest), (th, tbest) = _split(quant_random[fn])
    if jh is not None:
        assert np.array_equal(_np(jh), _np(th))
    if jbest is not None:
        for name in ("threshold", "default_left", "left_count"):
            assert np.array_equal(_np(getattr(jbest, name)),
                                  _np(getattr(tbest, name))), name
        jg, tg = _np(jbest.gain), _np(tbest.gain)
        assert np.array_equal(np.isfinite(jg), np.isfinite(tg))
        fin = np.isfinite(jg)
        assert fin.any()
        np.testing.assert_allclose(tg[fin], jg[fin], rtol=1e-5)
        for name in ("left_sum_grad", "left_sum_hess"):
            np.testing.assert_allclose(_np(getattr(tbest, name))[fin],
                                       _np(getattr(jbest, name))[fin],
                                       rtol=1e-5, atol=1e-5)


def test_quantized_scan_needs_scales():
    binned, vals, slot, _, _ = _data(3, True)
    vq = np.zeros((2, N), np.int8)
    with pytest.raises(ValueError, match="quant_scales"):
        TFU.fused_segment_splits(torch.from_numpy(binned),
                                 torch.from_numpy(vq), torch.from_numpy(slot),
                                 K, B, torch.ones((3, K)), *_meta_t(),
                                 THP(**HP))


# ----------------------------------------------------------------------
# B4's redesign: the sort by slot, the hi/lo split of the f32 arena, and
# the planner's tiles.  Each holds a plain model of what the kernels do
# (they run only on the card, where chip_smoke.py holds them against
# accumulate_plain and slot_order_plain bit for bit).
# ----------------------------------------------------------------------

SORT_CASES = {
    "random": (5000, 7, 0.6),
    "root": (3000, 1, 1.0),
    "all_dropped": (2000, 5, 0.0),
    "empty_slots": (4000, 9, 0.8),
    "many_slots": (6000, 128, 0.5),
}


@pytest.mark.parametrize("case", sorted(SORT_CASES))
def test_slot_order_plain_is_a_stable_sort(case):
    n, K, frac = SORT_CASES[case]
    rng = np.random.RandomState(len(case))
    slot = np.where(rng.rand(n) < frac, rng.randint(0, K, n),
                    rng.choice([K, K + 4, -1], n)).astype(np.int32)
    if case == "empty_slots":
        slot[np.isin(slot, [0, 3, 8])] = K
    key = np.where((slot >= 0) & (slot < K), slot, K)
    order, offsets = TFU.slot_order_plain(torch.from_numpy(slot), K)
    assert order.dtype == torch.int32 and offsets.dtype == torch.int32
    assert np.array_equal(order.numpy(), np.argsort(key, kind="stable"))
    want = np.concatenate([[0], np.cumsum(np.bincount(key,
                                                      minlength=K + 1)[:K])])
    assert np.array_equal(offsets.numpy(), want)
    # the values laid out beside the order: each slotted row's fixed-
    # point values (f32 mode) or levels (int8 mode) at its sorted position
    v = rng.randn(3, n).astype(np.float32)
    scales = fixed_point_scales(torch.from_numpy(v))
    q = to_fixed(torch.from_numpy(v), scales, 0).numpy()
    m = int(offsets[-1])
    rows = np.argsort(key, kind="stable")[:m]
    sv = TFU.sorted_values_plain(torch.from_numpy(v), order, offsets, scales)
    assert sv.dtype == torch.int64 and np.array_equal(sv.numpy(), q[:, rows].T)
    lv = rng.randint(-31, 32, (2, n)).astype(np.int8)
    sl = TFU.sorted_values_plain(torch.from_numpy(lv), order, offsets)
    assert sl.dtype == torch.int8 and np.array_equal(sl.numpy(), lv[:, rows].T)


def _split_sum(q: np.ndarray) -> np.int64:
    """The f32 arena's arithmetic on one cell: each int64 value split as
    hi * 2^32 + lo, lo added into a uint32 cell whose old value tells
    whether the add wrapped, hi + carry into a second uint32 cell, and
    the two recombined mod 2^64 at the flush."""
    u = q.view(np.uint64)
    lo = u & np.uint64(0xffffffff)
    hi = u >> np.uint64(32)                      # the arithmetic shift's bits
    old = (np.cumsum(lo) - lo) & np.uint64(0xffffffff)
    carry = ((old + lo) >> np.uint64(32)).astype(np.uint64)
    hi_acc = (hi + carry).sum() & np.uint64(0xffffffff)
    lo_acc = lo.sum() & np.uint64(0xffffffff)
    with np.errstate(over="ignore"):
        return np.array([(hi_acc << np.uint64(32)) + lo_acc],
                        np.uint64).view(np.int64)[0]


@pytest.mark.parametrize("kind", ["random", "negative", "near_limit",
                                  "tiny"])
def test_hi_lo_split_sums_are_the_int64_sums(kind):
    rng = np.random.RandomState(3)
    n = 4096
    if kind == "random":
        v = rng.randn(3, n) * [[3.0], [0.2], [1.0]]
    elif kind == "negative":
        v = -np.abs(rng.randn(3, n)) - 1e-3
    elif kind == "near_limit":
        # every value at the channel's maximum: sums reach 2^62 - O(2^s)
        v = np.sign(rng.randn(3, n)) * 7.5
        v[:, : n // 2] = 7.5
    else:
        v = rng.randn(3, n) * 1e-30
    vals = torch.from_numpy(v.astype(np.float32))
    scales = fixed_point_scales(vals)
    q = to_fixed(vals, scales, 0).numpy()
    cells = rng.randint(0, 5, n)                 # five arena cells a channel
    for c in range(3):
        for cell in range(5):
            qc = q[c, cells == cell]
            want = int(torch.from_numpy(qc).sum())
            assert _split_sum(qc) == want
            assert _split_sum(qc[::-1].copy()) == want   # any add order
    if kind == "near_limit":
        assert abs(int(torch.from_numpy(q[0, : n // 2]).sum())) > 2 ** 60


@pytest.mark.parametrize("F,B,quant", [(28, 255, False), (28, 255, True),
                                       (28, 1023, False), (28, 1023, True),
                                       (1, 255, False), (674, 256, False),
                                       (9, 4096, True)])
def test_accumulate_tiles_fit_the_card(F, B, quant):
    ft = planner.acc_feat_tile(F, B, quant)
    assert 1 <= ft <= min(F, planner.ACC_MAX_FEAT_TILE)
    arena = planner.acc_arena_bytes(ft, B, quant)
    assert arena <= planner.SMEM_MAX_BYTES
    if planner.acc_arena_bytes(1, B, quant) <= planner.ACC_ARENA_BYTES:
        assert arena <= planner.ACC_ARENA_BYTES
    tiles = -(-F // ft)
    assert (tiles - 1) * ft < F <= tiles * ft    # balanced, no empty tile
    with pytest.raises(ValueError):
        planner.acc_feat_tile(F, 10 ** 5, quant)


@pytest.mark.parametrize("n", [1, 1000, 4096, 4097, 1_000_000, 10_000_037])
def test_accumulate_segments_cover_every_slot_layout(n):
    """The grid's ceil(n / S) + K segments cover any split of the slotted
    rows over K slots: one slot holding every row, every slot one row
    (or S + 1 rows), random sizes; and the sort scratch covers its
    blocks."""
    S = planner.acc_seg_rows(n)
    assert S % 32 == 0 and S >= planner.ACC_MIN_SEG_ROWS
    rng = np.random.RandomState(n % 1000)
    for K in (1, 7, 128):
        layouts = [np.array([n] + [0] * (K - 1)),
                   np.minimum(1, np.maximum(n - np.arange(K), 0)),
                   np.bincount(rng.randint(0, K, n), minlength=K)]
        if n >= K * (S + 1):
            layouts.append(np.full(K, S + 1))
        for m in layouts:
            assert m.sum() <= n
            need = int(np.sum(-(-m // S)))
            assert need <= planner.acc_segments(n, K)
        assert planner.sort_blocks(n) * planner.SORT_BLOCK_ROWS >= n
