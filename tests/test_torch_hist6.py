"""The design of the port's root histogram kernel B6 (csrc/histogram.cu)
held on the CPU against its plain version and the JAX package.

The CUDA kernel runs only on the card (chip_smoke.py's ``hist6`` phase
holds it there, bit for bit, against ``histogram_plain``).  Here a model
of its arithmetic, block by block, is held against ``histogram_plain``
bit for bit:

- each arena cell is two uint32 halves, added with 32-bit atomics and
  the exact carry (fixed_point.cuh ``add_fixed_split``), joined mod 2^64
  at the flush into the int64 output;
- a thread takes 4 consecutive rows, row chunks start on a multiple of
  4, the features are cut by ``planner.hist_feat_tile``; rows whose
  three values are 0 and bins past B add nothing.

Cases: one feature whose every row sits in one bin, negative gradients,
masked rows, scales at which the lo half wraps on every add, uint8 and
int32 bins; and dyadic values against the JAX package's Pallas kernel
(interpret mode).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightgbm_tpu.ops import histogram as JH

from lightgbm_tpu_torch.ops import histogram as TH
from lightgbm_tpu_torch.ops import planner
from lightgbm_tpu_torch.ops.split import fixed_to_f32
from lightgbm_tpu_torch.testing import one_thread  # noqa: F401

M32 = (1 << 32) - 1
M64 = (1 << 64) - 1
ROWS_PER_THREAD = planner.HIST_ROWS_PER_THREAD


class Arena:
    """A block's [ft, 3, B] cells as uint32 lo and hi halves."""

    def __init__(self, cells):
        self.lo = [0] * cells
        self.hi = [0] * cells
        self.adds = 0
        self.wraps = 0

    def add(self, cell, q):
        """fixed_point.cuh add_fixed_split (q an int64, or its bits)."""
        lo, hi = q & M32, (q >> 32) & M32
        if lo:
            old = self.lo[cell]
            self.lo[cell] = (old + lo) & M32
            self.adds += 1
            if self.lo[cell] < old:
                hi = (hi + 1) & M32
                self.wraps += 1
        if hi:
            self.hi[cell] = (self.hi[cell] + hi) & M32

    def join(self, cell):
        return ((self.hi[cell] << 32) + self.lo[cell]) & M64


def b6_model(binned, q, B, stats=None):
    """The kernel's arithmetic: ``binned`` [F, n] ints, ``q`` [3][n]
    fixed-point ints; blocks of ``planner.hist_feat_tile`` features and
    ``planner.hist_row_chunks`` row chunks (rounded up to a multiple of
    4 rows), each with its own arena, flushed into the output mod 2^64.
    Returns [3, F, B] int64."""
    F, n = binned.shape
    ft = planner.hist_feat_tile(F, B)
    chunks = planner.hist_row_chunks(n, F, ft)
    rpc = -(-n // chunks)
    rpc = -(-rpc // ROWS_PER_THREAD) * ROWS_PER_THREAD
    out = [[[0] * B for _ in range(F)] for _ in range(3)]
    stats = {} if stats is None else stats
    stats.setdefault("wraps", 0)
    stats.setdefault("adds", 0)
    for c0 in range(0, n, rpc):
        c1 = min(n, c0 + rpc)
        for f0 in range(0, F, ft):
            fts = min(ft, F - f0)
            ar = Arena(fts * 3 * B)
            for r in range(c0, c1):
                if not (q[0][r] | q[1][r] | q[2][r]):
                    continue                   # a masked-out row
                for j in range(fts):
                    b = int(binned[f0 + j, r])
                    if not 0 <= b < B:
                        continue               # the one-hot drops it
                    for c in range(3):
                        if q[c][r]:
                            ar.add((j * 3 + c) * B + b, q[c][r])
            stats["wraps"] += ar.wraps
            stats["adds"] += ar.adds
            for j in range(fts):
                for c in range(3):
                    for b in range(B):
                        v = ar.join((j * 3 + c) * B + b)
                        if v:
                            cell = out[c][f0 + j]
                            cell[b] = (cell[b] + v) & M64
    signed = [[[v - (1 << 64) if v >> 63 else v for v in row] for row in ch]
              for ch in out]
    return torch.tensor(signed, dtype=torch.int64)


def _skewed(F, n, B, dtype, seed):
    """Bins with one feature holding every row in one bin, a bundle-like
    feature holding most rows in bin 0, bins past B (dropped), and
    signed gradients with a quarter of the rows masked out."""
    rng = np.random.RandomState(seed)
    binned = rng.randint(0, B + 3, (F, n))
    binned[0] = B // 2                               # the single hot bin
    if F > 1:
        binned[1] = np.where(rng.rand(n) < 0.8, 0, binned[1])
    g = rng.randn(n) * 4.0
    h = rng.rand(n) + 0.05
    mask = (rng.rand(n) > 0.25).astype(np.float64)
    vals = (np.stack([g, h, np.ones(n)]) * mask).astype(np.float32)
    return torch.from_numpy(binned.astype(dtype)), torch.from_numpy(vals)


def _fixed(vals, scales):
    return TH.to_fixed(vals, scales, 0).tolist()


@pytest.mark.parametrize("dtype,B", [(np.uint8, 255), (np.int32, 300)],
                         ids=["uint8", "int32"])
@pytest.mark.parametrize("n", [2051, 9000])
def test_model_matches_plain_on_skewed_bins(dtype, B, n):
    binned, vals = _skewed(5, n, B, dtype, seed=7)
    scales = TH.fixed_point_scales(vals)
    got = b6_model(binned.numpy(), _fixed(vals, scales), B)
    want = TH.histogram_plain(binned, vals, B, scales)
    assert torch.equal(got, want)
    assert bool((want[0] < 0).any())           # negative sums too
    # the hot bin really holds every live row of feature 0
    live = int((vals.abs().sum(0) > 0).sum())
    assert int(TH.histogram_plain(binned[:1], torch.ones_like(vals), B,
                                  (0, 0, 0))[2, 0, B // 2]) == n >= live


def test_model_wraps_the_lo_half_on_every_add():
    """Values whose lo half is near 2^32 (and negative ones, whose lo is
    2^32 - |q|): after a cell's first add, every add wraps, and the carry
    keeps the sum exact."""
    n, B = 1500, 4
    rng = np.random.RandomState(3)
    binned = torch.from_numpy(rng.randint(0, B, (2, n)).astype(np.uint8))
    big = np.float32(np.nextafter(np.float32(1.0), np.float32(0.0)))
    vals = torch.from_numpy(np.stack([np.full(n, big), np.full(n, big),
                                      -np.ones(n)]).astype(np.float32))
    scales = (32, 32, 5)            # q = +-(2^32 - 256): lo near 2^32
    q = _fixed(vals, scales)
    assert all((x & M32) >= M32 - 256 for x in q[0] + q[1])
    assert all(x < 0 for x in q[2])
    stats = {}
    got = b6_model(binned.numpy(), q, B, stats=stats)
    assert torch.equal(got, TH.histogram_plain(binned, vals, B, scales))
    cells = 2 * 3 * B * planner.hist_row_chunks(
        n, 2, planner.hist_feat_tile(2, B))
    assert stats["wraps"] >= stats["adds"] - cells > 0


def test_model_matches_jax_on_a_single_hot_bin():
    """Dyadic values (every f32 sum exact in both packages): the model's
    sums, each cell converted once to f32, equal the JAX package's
    Pallas kernel (interpret mode) bit for bit, one feature's every row
    in one bin."""
    rng = np.random.RandomState(11)
    F, n, B = 3, 1025, 64
    binned = rng.randint(0, B, (F, n))
    binned[1] = 37
    g = rng.randint(-64, 65, n) / 8.0
    h = rng.randint(1, 9, n) / 4.0
    w = rng.randint(0, 5, n) / 4.0
    vals = (np.stack([g, h, np.ones(n)]) * w).astype(np.float32)
    vt = torch.from_numpy(vals)
    scales = TH.fixed_point_scales(vt)
    got = b6_model(binned, _fixed(vt, scales), B)
    want = jax.jit(JH.histogram_pallas, static_argnums=2)(
        jnp.asarray(binned.astype(np.uint8)), jnp.asarray(vals), B)
    got_f32 = fixed_to_f32(got, scales, 0).numpy()
    assert np.array_equal(got_f32.view(np.uint32),
                          np.asarray(want).view(np.uint32))


@pytest.mark.parametrize("F,B,tile,tiles", [
    (9, 256, 9, 1),       # onehot's 9 bundle columns: one tile, no tail
    (28, 255, 14, 2),     # higgs / rand: two tiles of 14
    (674, 256, 18, 38),   # the one-hot table unbundled
    (674, 2, 674, 1),     # ... at 2 bins a column
    (1, 4096, 1, 1),
])
def test_feature_tiles(F, B, tile, tiles):
    ft = planner.hist_feat_tile(F, B)
    assert ft == tile and -(-F // ft) == tiles
    assert ft * 3 * B * 8 <= max(planner.HIST_ARENA_BYTES, 3 * B * 8)
    last = F - (tiles - 1) * ft
    assert last >= 1 and (F == 1 or last > 1)      # no 1-feature tail
    most = max(1, planner.HIST_ARENA_BYTES // (3 * B * 8))
    assert tiles == -(-F // most)                  # as few tiles as fit
    chunks = planner.hist_row_chunks(1_000_000, F, ft)
    assert 1 <= chunks * tiles <= 2 * planner.HIST_TARGET_BLOCKS
    assert planner.hist_row_chunks(2 * planner.HIST_MIN_CHUNK_ROWS - 1, F,
                                   ft) == 1


def test_feature_tile_refuses_an_arena_past_the_card():
    with pytest.raises(ValueError, match="bins"):
        planner.hist_feat_tile(1, 20_000)
