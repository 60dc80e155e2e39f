"""The port's staged histogram family (lightgbm_tpu_torch/ops/histogram.py)
held against the JAX package's (lightgbm_tpu/ops/histogram.py): kernel
B6's plain version against ``histogram_pallas`` (the Pallas kernel in
interpret mode) and ``histogram_scatter``; ``segment_histogram``,
``subtract_histogram`` and ``build_histogram``; and the staged arm's
expansion of group histograms (``expand_groups``,
lightgbm_tpu_torch/ops/fused.py) against the JAX package's per-feature
histogram of the same rows.

On the CPU the port runs the plain versions: exact int64 fixed-point
sums, each cell converted once to f32.  Tolerances:

- dyadic values (g = k/8, h in {1, k/4}, masks in {0, 1/4, ..., 1}):
  every f32 sum is exact in both packages, so the histograms are equal
  bit for bit;
- random f32 values: cells agree to rtol=1e-5, atol=1e-6 * max|v| over
  the channel's per-row values (the JAX package's own f32 rounding of its
  sums; the bar of tests/test_torch_fused.py).

Shapes cover F in {1, 7, 9, 28} (one feature, tiles of eight and a
ragged one) and n in {1, 511, 513, 5000} (row blocks of 512 and a ragged
one), the uint8 layout and the wide one (more than 256 bins: int32 in
the port, uint16 in the JAX package), with zero, one and fractional
masks.  The CUDA kernel is held against the plain version bit for bit
on the card by chip_smoke.py (phase ``hist6``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightgbm_tpu.ops import histogram as JH

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch.grower_rounds import group_layout
from lightgbm_tpu_torch.ops.fused import expand_groups
from lightgbm_tpu_torch.ops import histogram as TH
from lightgbm_tpu_torch.ops.split import fixed_to_f32
from lightgbm_tpu_torch.testing import one_thread  # noqa: F401

SHAPES = [(1, 1), (7, 511), (9, 513), (28, 5000)]
# compiled once per shape (interpret mode runs the Pallas grid in XLA)
_jax_pallas = jax.jit(JH.histogram_pallas, static_argnums=2)
_jax_scatter = jax.jit(JH.histogram_scatter, static_argnums=2)
MASKS = ("zero", "one", "fractional")


def _inputs(F, n, wide, dyadic, mask, seed=0):
    rng = np.random.RandomState(seed + 31 * F + n)
    B = 300 if wide else 64
    binned = rng.randint(0, B, (F, n))
    if dyadic:
        g = rng.randint(-64, 65, n) / 8.0
        h = np.where(rng.rand(n) < 0.5, 1.0, rng.randint(1, 9, n) / 4.0)
        frac = rng.randint(0, 5, n) / 4.0
    else:
        g = rng.randn(n) * 3.0
        h = np.abs(rng.randn(n)) + 0.1
        frac = rng.rand(n) * (rng.rand(n) > 0.2)
    w = {"zero": np.zeros(n), "one": np.ones(n), "fractional": frac}[mask]
    vals = (np.stack([g, h, np.ones(n)]) * w).astype(np.float32)
    port_b = torch.from_numpy(binned.astype(np.int32 if wide else np.uint8))
    jax_b = jnp.asarray(binned.astype(np.uint16 if wide else np.uint8))
    return port_b, jax_b, vals, B


def _check(got, want, vals, exact):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    if exact:
        assert np.array_equal(got, want)
        return
    for c in range(3):
        atol = 1e-6 * max(float(np.abs(vals[c]).max()), 1e-30)
        np.testing.assert_allclose(got[c], want[c], rtol=1e-5, atol=atol)


@pytest.mark.parametrize("wide", [False, True], ids=["u8", "wide"])
@pytest.mark.parametrize("F,n", SHAPES)
def test_histogram_pallas_matches(F, n, wide):
    """B6's plain version against the Pallas kernel (interpret mode) and
    the XLA scatter, every mask, dyadic and random values."""
    for mask in MASKS:
        for dyadic in (True, False):
            tb, jb, vals, B = _inputs(F, n, wide, dyadic, mask)
            got = TH.histogram_pallas(tb, torch.from_numpy(vals), B).numpy()
            _check(got, _jax_pallas(jb, jnp.asarray(vals), B),
                   vals, dyadic)
            _check(got, _jax_scatter(jb, jnp.asarray(vals), B),
                   vals, dyadic)


@pytest.mark.parametrize("F,n", SHAPES)
def test_histogram_scatter_matches(F, n):
    """The port's f32 scatter (tests and CPU only) against the JAX
    package's XLA scatter."""
    for dyadic in (True, False):
        tb, jb, vals, B = _inputs(F, n, False, dyadic, "fractional", seed=3)
        _check(TH.histogram_scatter(tb, torch.from_numpy(vals), B).numpy(),
               _jax_scatter(jb, jnp.asarray(vals), B), vals, dyadic)


def test_fixed_entry_is_exact_and_order_free():
    """``histogram_fixed`` is the int64 sum at the given scales, equal to
    the one-slot accumulate and unchanged by any row permutation."""
    tb, _, vals, B = _inputs(9, 5000, False, False, "fractional")
    v = torch.from_numpy(vals)
    scales = TH.fixed_point_scales(v)
    h = TH.histogram_fixed(tb, v, B, scales)
    assert h.dtype == torch.int64 and h.shape == (3, 9, B)
    perm = torch.from_numpy(np.random.RandomState(1).permutation(5000))
    assert torch.equal(h, TH.histogram_fixed(tb[:, perm].contiguous(),
                                             v[:, perm].contiguous(), B,
                                             scales))
    slot = torch.zeros(5000, dtype=torch.int32)
    assert torch.equal(h, TH.accumulate_plain(tb, v, slot, 1, B, scales)[0])
    assert torch.equal(fixed_to_f32(h, scales, 0),
                       TH.histogram_pallas(tb, v, B))


@pytest.mark.parametrize("method", TH.HIST_METHODS)
def test_build_histogram_every_method(method):
    """Every name the JAX package takes runs B6 (its plain version on the
    CPU) and matches the JAX package's exact scatter."""
    rng = np.random.RandomState(4)
    n, F, B = 1000, 5, 32
    binned = rng.randint(0, B, (F, n)).astype(np.uint8)
    g = (rng.randint(-64, 65, n) / 8.0).astype(np.float32)
    h = np.ones(n, np.float32)
    m = (rng.rand(n) < 0.7).astype(np.float32)
    got = TH.build_histogram(torch.from_numpy(binned), torch.from_numpy(g),
                             torch.from_numpy(h), torch.from_numpy(m), B,
                             method=method)
    want = JH.build_histogram(jnp.asarray(binned), jnp.asarray(g),
                              jnp.asarray(h), jnp.asarray(m), B,
                              method="scatter")
    assert np.array_equal(got.numpy(), np.asarray(want))


def test_build_histogram_refuses_unknown_method():
    z = torch.zeros(4)
    with pytest.raises(ValueError, match="unknown histogram method"):
        TH.build_histogram(torch.zeros((1, 4), dtype=torch.uint8), z, z, z,
                           4, method="onehot")


def test_histogram_scatter_is_cpu_only():
    meta = torch.zeros((1, 4), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="CPU reference"):
        TH.histogram_scatter(meta, torch.zeros((3, 4), device="meta"), 4)


@pytest.mark.parametrize("dyadic", [True, False], ids=["dyadic", "random"])
def test_segment_and_subtract_match(dyadic):
    """Per-slot histograms (B4's plain version) against the JAX package's
    ``segment_histogram``; the sibling ``parent - child`` exact in int64
    and equal to the JAX package's f32 subtraction where that is exact."""
    rng = np.random.RandomState(5)
    n, F, B, S = 3000, 6, 20, 4
    binned = rng.randint(0, B, (F, n)).astype(np.uint8)
    if dyadic:
        g = rng.randint(-64, 65, n) / 8.0
        h = np.where(rng.rand(n) < 0.5, 1.0, rng.randint(1, 9, n) / 4.0)
    else:
        g, h = rng.randn(n), np.abs(rng.randn(n)) + 0.1
    g, h = g.astype(np.float32), h.astype(np.float32)
    w = (rng.rand(n) < 0.8).astype(np.float32)
    slot = np.where(rng.rand(n) < 0.7, rng.randint(0, S, n), S)
    args_t = [torch.from_numpy(a) for a in (binned, g, h, w)]
    args_j = [jnp.asarray(a) for a in (binned, g, h, w)]
    got = TH.segment_histogram(*args_t, torch.from_numpy(slot), S, B).numpy()
    want = np.asarray(JH.segment_histogram(*args_j, jnp.asarray(slot), S, B))
    vals = np.stack([g * w, h * w, w])
    for s in range(S):
        _check(got[s], want[s], vals, dyadic)
    parent = TH.histogram_fixed(args_t[0], TH._vals_t(*args_t[1:]), B,
                                (40, 40, 40))
    child = TH.histogram_fixed(
        args_t[0], TH._vals_t(args_t[1], args_t[2],
                              args_t[3] * torch.from_numpy(
                                  (slot == 0).astype(np.float32))),
        B, (40, 40, 40))
    sib = TH.subtract_histogram(parent, child)
    assert torch.equal(sib + child, parent)
    if dyadic:
        jsib = JH.subtract_histogram(jnp.asarray(fixed_to_f32(
            parent, (40, 40, 40), 0).numpy()), jnp.asarray(fixed_to_f32(
                child, (40, 40, 40), 0).numpy()))
        assert np.array_equal(fixed_to_f32(sib, (40, 40, 40), 0).numpy(),
                              np.asarray(jsib))


def _onehot_rows(n, seed):
    """A table that bundles: three one-hot blocks (exclusive within each
    block), a sparse numeric column and a dense one."""
    rng = np.random.RandomState(seed)
    cols = []
    for k in (5, 9, 40):
        c = np.zeros((n, k), np.float32)
        c[np.arange(n), rng.randint(0, k, n)] = 1.0
        cols.append(c)
    sparse = np.where(rng.rand(n) < 0.1, rng.randn(n) * 3, 0.0)
    dense = rng.randn(n)
    X = np.concatenate(cols + [sparse[:, None], dense[:, None]], axis=1)
    return X.astype(np.float32)


def test_expand_hist_matches_per_feature_histograms():
    """The group histogram of a bundled dataset, expanded in int64,
    equals the JAX package's histogram of each feature's own bins (every
    one-hot block is exclusive, so the bundles have no conflicts), bin 0
    included (rebuilt from the totals)."""
    X = _onehot_rows(3000, 6)
    params = {"max_bin": 63, "min_data_in_leaf": 5, "verbose": -1}
    ds = lt.Dataset(X, device="cpu", params=params).construct()
    meta = ds.feature_meta()
    assert meta.has_bundles
    jds = lgb.Dataset(X, params=params).construct()
    assert jds.used_features == ds.used_features
    assert np.array_equal(np.asarray(jds.feat_group), meta.feat_group)
    rng = np.random.RandomState(7)
    n = X.shape[0]
    g = (rng.randint(-64, 65, n) / 8.0).astype(np.float32)
    h = np.ones(n, np.float32)
    w = (rng.rand(n) < 0.9).astype(np.float32)
    vals = TH._vals_t(torch.from_numpy(g), torch.from_numpy(h),
                      torch.from_numpy(w)).contiguous()
    scales = TH.fixed_point_scales(vals)
    B, Bg = int(meta.max_num_bin), int(meta.max_group_bin)
    ghist = TH.histogram_fixed(ds.binned_t, vals, Bg, scales)
    assert ghist.shape[-1] == Bg
    mt = meta.tensors("cpu")
    got = fixed_to_f32(expand_groups(ghist[None], group_layout(mt, B),
                                     mt["num_bin"])[0], scales, 0).numpy()
    # every feature's own bins, from its bin mapper, through the JAX
    # package's scatter
    per_feature = np.stack([
        ds.bin_mappers[f].value_to_bin(X[:, f].astype(np.float64))
        for f in ds.used_features]).astype(np.uint8)
    want = np.asarray(JH.histogram_scatter(
        jnp.asarray(per_feature), jnp.asarray(vals.numpy()), B))
    assert np.array_equal(got, want)
