"""Histogram helpers (counterpart of the parts of
``lightgbm_tpu/ops/histogram.py`` the fused training path reads).

The port accumulates histograms in exact fixed point: channel ``c`` of
a row's value block enters as ``round(v * 2**s_c)`` in int64, with one
power-of-two scale per channel and per tree (``fixed_point_scales``).
Integer sums are associative, so the CUDA kernel (``csrc/fused.cu``)
and the plain version here give the same bits in any order.

The JAX package's staged histogram family (``histogram_matmul*``,
``segment_histogram*``, ``pack_cols_u32*``, ``take_from_table``) is TPU
layout work and has no counterpart here.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

# every sum of up to n scaled values stays below 2**62 in magnitude
FIXED_POINT_BITS = 62


def _vals_t(grad: torch.Tensor, hess: torch.Tensor,
            mask: torch.Tensor) -> torch.Tensor:
    """[3, n] f32 value block (g, h, 1) * mask."""
    return torch.stack([grad, hess, torch.ones_like(grad)]) * mask[None, :]


def fixed_point_scales(vals_t: torch.Tensor) -> Tuple[int, int, int]:
    """Per-channel power-of-two scales ``s_c = 62 - ceil(log2(max_i
    |v_c,i| * n + 1))``: any sum of at most n scaled values fits in
    int64, and rounding a value to an integer at that scale costs at
    most 2**-(s_c + 1) (dyadic values like k/8 convert exactly)."""
    n = max(int(vals_t.shape[1]), 1)
    peak = vals_t.abs().amax(dim=1).to(torch.float64).cpu().tolist()
    return tuple(_scale_for(m * n) for m in peak)


def _scale_for(bound: float) -> int:
    if not math.isfinite(bound):
        raise ValueError("gradients or hessians are not finite")
    return FIXED_POINT_BITS - math.ceil(math.log2(bound + 1.0))


def hist_scales(*hists: torch.Tensor) -> Tuple[int, int, int]:
    """Scales for converting given f32 histograms [..., 3, F, B] to
    fixed point: prefix sums over B bins of a sibling (|parent| +
    |small| per cell) must stay below 2**62."""
    B = int(hists[0].shape[-1])
    peak = torch.stack([h.abs().transpose(0, -3).reshape(3, -1).amax(1)
                        for h in hists]).amax(0)
    return tuple(_scale_for(m * 2 * B)
                 for m in peak.to(torch.float64).cpu().tolist())


def to_fixed(x: torch.Tensor, scales, channel_dim: int) -> torch.Tensor:
    """f32 values -> int64 ``round_half_even(x * 2**s_c)`` (the f64
    product is exact; the kernel's ``llrint(ldexp((double)v, s))``)."""
    shape = [1] * x.dim()
    shape[channel_dim] = len(scales)
    mul = torch.tensor([math.ldexp(1.0, int(s)) for s in scales],
                       dtype=torch.float64, device=x.device).view(shape)
    return torch.round(x.to(torch.float64) * mul).to(torch.int64)


def accumulate_plain(binned_t: torch.Tensor, vals_t: torch.Tensor,
                     slot: torch.Tensor, num_slots: int, num_bins: int,
                     scales) -> torch.Tensor:
    """The accumulate kernel's function in plain torch: per (slot,
    channel, feature, bin) int64 sums of the fixed-point values of the
    rows with ``slot`` in [0, num_slots) (``slot == num_slots`` drops a
    row).  ``binned_t`` [F, n] uint8/int32; returns [K, 3, F, B]."""
    F, n = binned_t.shape
    K, B = int(num_slots), int(num_bins)
    out = torch.zeros(K * 3 * F * B, dtype=torch.int64,
                      device=binned_t.device)
    keep = (slot >= 0) & (slot < K)
    rows = torch.nonzero(keep).flatten()
    if rows.numel() == 0:
        return out.view(K, 3, F, B)
    q = to_fixed(vals_t[:, rows], scales, 0)                # [3, m]
    s = slot[rows].to(torch.int64)
    for f in range(F):
        b = binned_t[f, rows].to(torch.int64)
        inb = b < B                                         # one-hot drops
        base = (s * 3 * F + f) * B + b
        for c in range(3):
            out.index_add_(0, (base + c * F * B)[inb], q[c][inb])
    return out.view(K, 3, F, B)
