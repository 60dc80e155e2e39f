"""Best-split search over histograms (counterpart of the numeric half of
``lightgbm_tpu/ops/split.py``).

reference: src/treelearner/feature_histogram.hpp:782
FindBestThresholdSequentially.  Both missing-direction variants are
evaluated for every (feature, threshold) cell at once: prefix sums along
the bin axis, L1/L2-thresholded gains, masked argmax.  The semantics are
the JAX package's ``numeric_feature_scan`` (minimum-data checks on exact
counts, reverse direction winning ties, ``default_left`` rules for
features without a missing direction).

The port's histograms are exact integers: every value ``v`` of channel
``c`` enters as ``round(v * 2**s_c)`` in int64 (``ops/fused.py``), so a
histogram cell, a sibling ``parent - small`` and a prefix over bins are
exact whatever order they are summed in.  ``numeric_feature_scan`` takes
such an int64 histogram and its three scales, converts each prefix to
f32 as ``float((double)p * 2**-s_c)``, and from there runs the f32 gain
formulas elementwise.  It is the plain version of the scan half of the
CUDA kernel in ``csrc/fused.cu``, which takes the same steps in the same
order, so the two agree bit for bit.  Monotone constraints and
extra-trees thresholds are not ported (the trainer refuses them).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Sequence

import numpy as np
import torch

from ..binning import MissingType

K_EPSILON = 1e-15
K_MIN_SCORE = -math.inf
# the f32 constants the JAX package's weakly typed arithmetic rounds to
_EPS32 = float(np.float32(K_EPSILON))
_TWO_EPS32 = float(np.float32(2 * K_EPSILON))


class SplitHyperparams(NamedTuple):
    """Split hyper-parameters (the JAX package's field set)."""

    lambda_l1: float = 0.0
    lambda_l2: float = 0.0
    min_gain_to_split: float = 0.0
    min_data_in_leaf: int = 20
    min_sum_hessian_in_leaf: float = 1e-3
    max_delta_step: float = 0.0
    max_cat_threshold: int = 32
    cat_l2: float = 10.0
    cat_smooth: float = 10.0
    max_cat_to_onehot: int = 4
    min_data_per_group: int = 100
    extra_trees: bool = False


def f32(x: float) -> float:
    """``x`` rounded to the nearest f32 (as a Python float), the value a
    weakly typed constant takes in the JAX package's f32 arithmetic."""
    return float(np.float32(x))


class SplitResult(NamedTuple):
    """Per-leaf best split; every field [...] (numeric splits only)."""

    gain: torch.Tensor          # shifted gain (minus parent gain + min gain)
    feature: torch.Tensor       # int64 used-feature index
    threshold: torch.Tensor     # int32 bin threshold
    default_left: torch.Tensor  # bool
    left_sum_grad: torch.Tensor
    left_sum_hess: torch.Tensor
    left_count: torch.Tensor
    right_sum_grad: torch.Tensor
    right_sum_hess: torch.Tensor
    right_count: torch.Tensor


class NumericFeatureBest(NamedTuple):
    """Per-feature best numeric split candidates ([..., F] tensors);
    ``gain`` is already shifted by the leaf's parent gain + min gain."""

    gain: torch.Tensor
    threshold: torch.Tensor      # int32
    default_left: torch.Tensor   # bool
    left_sum_grad: torch.Tensor
    left_sum_hess: torch.Tensor
    left_count: torch.Tensor


def threshold_l1(s: torch.Tensor, l1: float) -> torch.Tensor:
    """reference: ThresholdL1 (feature_histogram.hpp:661)."""
    if l1 <= 0.0:
        return s
    return torch.sign(s) * torch.clamp_min(s.abs() - f32(l1), 0.0)


def leaf_gain(g: torch.Tensor, h: torch.Tensor, l1: float,
              l2: float) -> torch.Tensor:
    """reference: GetLeafGain (feature_histogram.hpp:712)."""
    sg = threshold_l1(g, l1)
    return (sg * sg) / (h + f32(l2))


def leaf_output(g: torch.Tensor, h: torch.Tensor, l1: float, l2: float,
                max_delta_step: float = 0.0) -> torch.Tensor:
    """reference: CalculateSplittedLeafOutput (feature_histogram.hpp:669)."""
    out = -threshold_l1(g, l1) / (h + f32(l2))
    if max_delta_step > 0.0:
        m = f32(max_delta_step)
        out = out.clamp(-m, m)
    return out


def leaf_gain_given_output(g: torch.Tensor, h: torch.Tensor, l1: float,
                           l2: float, out: torch.Tensor) -> torch.Tensor:
    """reference: GetLeafGainGivenOutput (feature_histogram.hpp:760)."""
    sg = threshold_l1(g, l1)
    return -(2.0 * sg * out + (h + f32(l2)) * out * out)


def fixed_to_f32(p: torch.Tensor, scales: Sequence[int],
                 channel_dim: int) -> torch.Tensor:
    """int64 fixed-point sums -> f32: ``float((double)p * 2**-s_c)`` with
    ``s_c`` the scale of the channel along ``channel_dim`` (the int64 ->
    f64 conversion rounds to nearest, the scaling is exact, the f64 ->
    f32 conversion rounds to nearest — the kernel's two steps)."""
    shape = [1] * p.dim()
    shape[channel_dim] = len(scales)
    inv = torch.tensor([math.ldexp(1.0, -int(s)) for s in scales],
                       dtype=torch.float64, device=p.device).view(shape)
    return (p.to(torch.float64) * inv).to(torch.float32)


def numeric_feature_scan(hist: torch.Tensor, scales: Sequence[int],
                         sum_grad: torch.Tensor, sum_hess: torch.Tensor,
                         num_data: torch.Tensor, num_bin: torch.Tensor,
                         missing_type: torch.Tensor,
                         default_bin: torch.Tensor,
                         hp: SplitHyperparams) -> NumericFeatureBest:
    """Per-feature best numeric split of each child.

    ``hist`` [NC, 3, F, B] int64 fixed-point (grad, hess, count) with
    ``scales`` (s_grad, s_hess, s_count); ``sum_*`` [NC] f32 child
    totals; ``num_bin``/``missing_type``/``default_bin`` [F] int32.
    A feature with ``num_bin`` 0 (padding) has no valid bin: gain -inf.
    """
    F, B = hist.shape[-2], hist.shape[-1]
    dev = hist.device
    bins = torch.arange(B, device=dev, dtype=torch.int32)[None, :]  # [1, B]
    nb = num_bin.to(torch.int32)[:, None]
    mt = missing_type.to(torch.int32)
    has_md = (mt != MissingType.NONE) & (num_bin > 2)               # [F]
    miss_bin = torch.where(
        mt == MissingType.NAN, num_bin - 1,
        torch.where(mt == MissingType.ZERO, default_bin.to(num_bin.dtype),
                    torch.full_like(num_bin, -1)))
    miss_bin = torch.where(has_md, miss_bin, torch.full_like(miss_bin, -1))
    is_miss = bins == miss_bin.to(torch.int32)[:, None]             # [F, B]
    valid = bins < nb
    drop = is_miss | ~valid

    prefix = hist.masked_fill(drop, 0).cumsum(-1)                   # exact
    miss = hist.masked_fill(~is_miss, 0).sum(-1)                    # [NC,3,F]
    pf = fixed_to_f32(prefix, scales, -3)
    ms = fixed_to_f32(miss, scales, -2)

    sum_grad = sum_grad.to(torch.float32)
    sum_hess = sum_hess.to(torch.float32)
    num_data = num_data.to(torch.float32)
    parent_gain = leaf_gain(sum_grad, sum_hess + _TWO_EPS32,
                            hp.lambda_l1, hp.lambda_l2)            # [NC]
    mgs = parent_gain + f32(hp.min_gain_to_split)
    total_g = sum_grad[:, None, None]
    total_h = (sum_hess + _TWO_EPS32)[:, None, None]
    nd = num_data[:, None, None]
    min_data = f32(hp.min_data_in_leaf)
    min_hess = f32(hp.min_sum_hessian_in_leaf)
    neg_inf = torch.tensor(K_MIN_SCORE, dtype=torch.float32, device=dev)

    def eval_dir(missing_left: bool):
        if missing_left:
            lg = pf[:, 0] + ms[:, 0, :, None]
            lh = (pf[:, 1] + ms[:, 1, :, None]) + _EPS32
            lc = pf[:, 2] + ms[:, 2, :, None]
        else:
            lg = pf[:, 0]
            lh = pf[:, 1] + _EPS32
            lc = pf[:, 2]
        rg = total_g - lg
        rh = total_h - lh
        rc = nd - lc
        ok = ((lc >= min_data) & (rc >= min_data)
              & (lh >= min_hess) & (rh >= min_hess))
        gain = (leaf_gain(lg, lh, hp.lambda_l1, hp.lambda_l2)
                + leaf_gain(rg, rh, hp.lambda_l1, hp.lambda_l2))
        gain = torch.where(ok & (gain > mgs[:, None, None]), gain, neg_inf)
        return gain, (lg, lh - _EPS32, lc)

    na_dir = has_md & (mt == MissingType.NAN)
    t_valid = (bins < (nb - 1 - na_dir.to(torch.int32)[:, None])) & valid
    t_valid &= ~((mt[:, None] == MissingType.ZERO) & is_miss)

    gain_r, left_r = eval_dir(False)
    gain_l, left_l = eval_dir(True)
    gain_r = torch.where(t_valid & has_md[:, None], gain_r, neg_inf)
    gain_l = torch.where(t_valid, gain_l, neg_inf)

    # reverse (missing -> left) scan: the LAST threshold of the maximum;
    # forward: the first; ties between the two go to missing -> left
    t_l = (B - 1) - torch.argmax(gain_l.flip(-1), dim=-1)
    t_r = torch.argmax(gain_r, dim=-1)
    g_l = gain_l.gather(-1, t_l[..., None])[..., 0]
    g_r = gain_r.gather(-1, t_r[..., None])[..., 0]
    use_left = g_l >= g_r
    num_gain = torch.where(use_left, g_l, g_r)
    num_thr = torch.where(use_left, t_l, t_r).to(torch.int32)

    def pick(a, b):
        return torch.where(use_left, a.gather(-1, t_l[..., None])[..., 0],
                           b.gather(-1, t_r[..., None])[..., 0])

    num_dl = torch.where(has_md, use_left, mt != MissingType.NAN)
    num_gain = torch.where(torch.isfinite(num_gain),
                           num_gain - mgs[:, None], neg_inf)
    return NumericFeatureBest(
        gain=num_gain, threshold=num_thr, default_left=num_dl,
        left_sum_grad=pick(left_l[0], left_r[0]),
        left_sum_hess=pick(left_l[1], left_r[1]),
        left_count=pick(left_l[2], left_r[2]))
