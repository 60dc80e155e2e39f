"""Best-split search over histograms (counterpart of
``lightgbm_tpu/ops/split.py``).

reference: src/treelearner/feature_histogram.hpp:782
FindBestThresholdSequentially (numeric) and :259-460
FindBestThresholdCategoricalInner (categorical).  Both missing-direction
variants are evaluated for every (feature, threshold) cell at once:
prefix sums along the bin axis, L1/L2-thresholded gains, masked argmax.
The semantics are the JAX package's ``numeric_feature_scan`` (minimum-data
checks on exact counts, reverse direction winning ties, ``default_left``
rules for features without a missing direction) and ``_best_categorical``
(one-hot mode up to ``max_cat_to_onehot`` bins, otherwise many-vs-many
over categories sorted by ``sum_grad / (sum_hess + cat_smooth)``).

The port's histograms are exact integers: every value ``v`` of channel
``c`` enters as ``round(v * 2**s_c)`` in int64 (``ops/histogram.py``), so
a histogram cell, a sibling ``parent - small`` and a prefix over bins
are exact whatever order they are summed in.  ``numeric_feature_scan``
takes such an int64 histogram and its three scales, converts each prefix
to f32 as ``float((double)p * 2**-s_c)``, and from there runs the f32
gain formulas elementwise.  It is the plain version of the scan kernel
B5 in ``csrc/fused.cu``, which takes the same steps in the same order, so
the two agree bit for bit.  ``_best_categorical`` converts the same way
(cells, and prefixes over the sorted categories); it is plain torch on
every device, as the JAX package's is XLA.

Quantized training (``use_quantized_grad``) feeds the same scans.  Its
histograms hold integer levels [.., 2, F, B] (grad, hess) with one f32
scale per channel (``QuantScales``); ``quant_count_hist`` adds the
per-bin count channel ``round_half_even(f32(H_b) * cf)``, ``cf =
f32(num_data) / max(f32(sum_b H_b), 1)`` (reference: the count factor
of feature_histogram.hpp:813, in the JAX package's f32 arithmetic:
x64 is never enabled there), so the scans take an int64 (G, H, C)
histogram and the channel multipliers ``(g_scale, h_scale, 1)`` where
the f32 mode takes ``2**-s_c``: ``fixed_to_f32`` converts a prefix as
``float((double)p * m_c)`` in both modes, and one scan body, in plain
torch and in kernel B5, serves both.  The count channel equals the JAX
package's bit for bit; grad and hess prefixes are exact integers
rounded to f32 once, where the JAX package sums f32 per-bin values
``fl(q_b * s)``, so tuples are bit-identical where those sums are exact
(power-of-two scales) and otherwise tie-break alike only where exact
arithmetic does not tie.

The staged search (``feature_best_splits``, ``best_split_for_leaf``,
``pick_best_feature``) runs the numeric scan through
``ops.fused.sibling_scan`` in leaf mode (B5 on the card, reading the
staged arm's group histograms where the dataset has bundles) and merges
the categorical tuples over it.  Categorical bitsets cover ``MAX_CAT_WORDS``
32-bit words (256 bins), held in int64 tensors (torch has no shifts on
uint32).

Monotone constraints (``monotone_constraints`` [F], with each child's
output bounds ``leaf_output_bounds``) switch the scan to the JAX
package's monotone form: both sides' outputs are clamped to the child's
bounds, the gain is taken from the clamped outputs
(``leaf_gain_given_output``), and a split against the feature's
direction is rejected.  Extra trees give each (child, feature) one
random threshold (``rand_thr`` [NC, F], ``random_thresholds``) and each
categorical feature one random category or sorted position (``rand_u``
of ``_best_categorical``).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..binning import MissingType
from .histogram import exponent_tensor, host_constant, pow2

K_EPSILON = 1e-15
K_MIN_SCORE = -math.inf
MAX_CAT_WORDS = 8  # categorical bitsets cover up to 256 bins
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
    """Per-leaf best split; every field [...]."""

    gain: torch.Tensor          # shifted gain (minus parent gain + min gain)
    feature: torch.Tensor       # int64 used-feature index
    threshold: torch.Tensor     # int32 bin threshold (categorical: set size)
    default_left: torch.Tensor  # bool
    left_sum_grad: torch.Tensor
    left_sum_hess: torch.Tensor
    left_count: torch.Tensor
    right_sum_grad: torch.Tensor
    right_sum_hess: torch.Tensor
    right_count: torch.Tensor
    is_categorical: torch.Tensor  # bool
    cat_bitset: torch.Tensor    # [..., MAX_CAT_WORDS] int64: bins going left


class PerFeatureBest(NamedTuple):
    """Per-feature best split candidates ([..., F] tensors; the bitset
    [..., F, MAX_CAT_WORDS] int64)."""

    gain: torch.Tensor
    threshold: torch.Tensor      # int32
    default_left: torch.Tensor   # bool
    left_sum_grad: torch.Tensor
    left_sum_hess: torch.Tensor
    left_count: torch.Tensor
    is_categorical: torch.Tensor
    cat_bitset: torch.Tensor


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


class QuantScales(NamedTuple):
    """The f32 scales of quantized gradients and hessians: a level q of
    channel c stands for ``q * scale_c`` (``ops.histogram.
    quantize_gradients``).  Passed where the f32 mode passes its
    fixed-point exponents, it selects the scans' quantized mode.  Each
    field is a float or a 0-dim f32 tensor (the grower passes views of
    a device buffer, so nothing is read on the host)."""

    g: float
    h: float


def channel_multipliers(scales) -> tuple:
    """Per-channel multipliers that turn integer sums into values, on
    the host: the f32 mode's ``2**-s_c`` for fixed-point exponents
    ``s_c``; ``(g_scale, h_scale, 1)`` for ``QuantScales`` (grad, hess,
    estimated count).  The scans take ``scale_tensor`` instead."""
    if isinstance(scales, QuantScales):
        return float(scales.g), float(scales.h), 1.0
    return tuple(math.ldexp(1.0, -int(s)) for s in scales)


def scale_tensor(scales, device) -> torch.Tensor:
    """The scales as kernels B4 and B5 read them from the device, with
    no host read: the f32 mode's exponents as int32 [C] (a sequence of
    ints or a tensor; ``ops.histogram.exponent_tensor``), ``QuantScales``
    as f64 [2] (0-dim f32 tensors, each exact in f64, or floats, copied
    once a distinct pair, ``ops.histogram.host_constant``)."""
    if isinstance(scales, QuantScales):
        if not any(isinstance(v, torch.Tensor) for v in scales):
            return host_constant(tuple(float(v) for v in scales), "float64",
                                 str(torch.device(device)))
        return torch.stack([torch.as_tensor(
            v, dtype=torch.float64, device=device).reshape(())
            for v in scales])
    return exponent_tensor(scales, device)


def multiplier_tensor(scales, device) -> torch.Tensor:
    """``channel_multipliers`` as an f64 tensor on ``device``, computed
    there from ``scale_tensor`` (``2**-s_c`` built exactly from its
    bits)."""
    t = scale_tensor(scales, device)
    if isinstance(scales, QuantScales):
        return torch.cat([t, torch.ones(1, dtype=torch.float64,
                                        device=device)])
    return pow2(-t.to(torch.int64))


def fixed_to_f32(p: torch.Tensor, scales, channel_dim: int) -> torch.Tensor:
    """Integer sums -> f32: ``float((double)p * m_c)`` with ``m_c`` the
    multiplier of the channel along ``channel_dim``
    (``multiplier_tensor``).  The int64 -> f64 conversion is exact
    below 2**53; in the f32 mode the scaling by 2**-s_c is exact too,
    and the f64 -> f32 conversion rounds to nearest — the kernel's
    steps.  A quantized sum below 2**24 times an f32 scale is exact in
    f64, so it rounds once, as the JAX package's f32 product does."""
    m = multiplier_tensor(scales, p.device)[:p.shape[channel_dim]]
    shape = [1] * p.dim()
    shape[channel_dim] = m.numel()
    return (p.to(torch.float64) * m.view(shape)).to(torch.float32)


def quant_count_hist(hist_int: torch.Tensor, num_data: torch.Tensor,
                     cnt_factor: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
    """Integer histogram [..., 2, F, B] (grad, hess levels) -> int64
    [..., 3, F, B] with the estimated count channel ``C_b =
    round_half_even(f32(H_b) * cf)``.  ``num_data`` [...] f32 is each
    histogram's row count; ``cnt_factor`` [...] defaults to each
    FEATURE's own ``f32(num_data) / max(f32(sum_b H_b), 1)``, which is
    what kernel B5 computes in its block (any feature's bins partition
    the leaf's rows, so every feature gives the factor the JAX package
    reads from feature 0)."""
    hi = hist_int.to(torch.int64)
    h = hi[..., 1, :, :]                                        # [..., F, B]
    if cnt_factor is None:
        tot = h.sum(-1).to(torch.float32)                       # [..., F]
        cf = (num_data.to(torch.float32)[..., None]
              / torch.clamp_min(tot, 1.0))[..., None]
    else:
        cf = cnt_factor.to(torch.float32)[..., None, None]
    c = torch.round(h.to(torch.float32) * cf).to(torch.int64)
    return torch.stack([hi[..., 0, :, :], h, c], dim=-3)


def quant_rescale_hist(hist_int: torch.Tensor, g_scale, h_scale,
                       num_data, cnt_factor=None) -> torch.Tensor:
    """The JAX function (``lightgbm_tpu/ops/split.py:585``): integer
    [..., 2, F, B] -> f32 [..., 3, F, B] ``(f32(G) * g_scale, f32(H) *
    h_scale, round(f32(H) * cf))``, ``cf`` from feature 0's hess total
    unless given.  The scans take ``quant_count_hist``'s integers
    instead; this is their f32 image, cell for cell."""
    num_data = torch.as_tensor(num_data, dtype=torch.float32,
                               device=hist_int.device)
    if cnt_factor is None:
        tot = hist_int[..., 1, 0, :].to(torch.int64).sum(-1).to(
            torch.float32)
        cnt_factor = num_data / torch.clamp_min(tot, 1.0)
    h3 = quant_count_hist(hist_int, num_data,
                          torch.as_tensor(cnt_factor, dtype=torch.float32,
                                          device=hist_int.device))
    return fixed_to_f32(h3, QuantScales(float(g_scale), float(h_scale)),
                        -3)


def random_thresholds(u: torch.Tensor, num_bin: torch.Tensor
                      ) -> torch.Tensor:
    """Extra trees' numeric thresholds (the JAX package's ``rand_t``):
    ``floor(u * max(num_bin - 1, 1))`` in f32, int32; ``u`` [..., F]
    uniforms, ``num_bin`` [F]."""
    span = torch.clamp_min(num_bin.to(torch.int32) - 1, 1).to(torch.float32)
    return torch.floor(u.to(torch.float32) * span).to(torch.int32)


def clip(x: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """``jnp.clip(x, lo, hi)``: ``minimum(hi, maximum(lo, x))``."""
    return torch.minimum(hi, torch.maximum(lo, x))


def numeric_feature_scan(hist: torch.Tensor, scales: Sequence[int],
                         sum_grad: torch.Tensor, sum_hess: torch.Tensor,
                         num_data: torch.Tensor, num_bin: torch.Tensor,
                         missing_type: torch.Tensor,
                         default_bin: torch.Tensor,
                         hp: SplitHyperparams,
                         monotone_constraints: Optional[torch.Tensor] = None,
                         leaf_output_bounds: Optional[tuple] = None,
                         rand_thr: Optional[torch.Tensor] = None
                         ) -> NumericFeatureBest:
    """Per-feature best numeric split of each child.

    ``hist`` [NC, 3, F, B] int64 fixed-point (grad, hess, count) with
    ``scales`` (s_grad, s_hess, s_count), or the (G, H, C) integers of
    ``quant_count_hist`` with ``QuantScales``; ``sum_*`` [NC] f32 child
    totals; ``num_bin``/``missing_type``/``default_bin`` [F] int32.
    A feature with ``num_bin`` 0 (padding) has no valid bin: gain -inf.
    ``monotone_constraints`` [F] int32 in {-1, 0, 1} selects the
    monotone form (reference: GetSplitGains USE_MC,
    feature_histogram.hpp:714-747), with ``leaf_output_bounds`` ([NC],
    [NC]) f32 the children's output clamp; ``rand_thr`` [NC, F] int32
    leaves one valid threshold per (child, feature) (extra trees).
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
    neg_inf = torch.full((), K_MIN_SCORE, dtype=torch.float32, device=dev)

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
        if monotone_constraints is None:
            gain = (leaf_gain(lg, lh, hp.lambda_l1, hp.lambda_l2)
                    + leaf_gain(rg, rh, hp.lambda_l1, hp.lambda_l2))
        else:
            lo = leaf_output(lg, lh, hp.lambda_l1, hp.lambda_l2,
                             hp.max_delta_step)
            ro = leaf_output(rg, rh, hp.lambda_l1, hp.lambda_l2,
                             hp.max_delta_step)
            if leaf_output_bounds is not None:
                lob = leaf_output_bounds[0].to(torch.float32)[:, None, None]
                upb = leaf_output_bounds[1].to(torch.float32)[:, None, None]
                lo, ro = clip(lo, lob, upb), clip(ro, lob, upb)
            mc = monotone_constraints.to(torch.int32)[:, None]
            bad = ((mc > 0) & (lo > ro)) | ((mc < 0) & (lo < ro))
            gain = (leaf_gain_given_output(lg, lh, hp.lambda_l1,
                                           hp.lambda_l2, lo)
                    + leaf_gain_given_output(rg, rh, hp.lambda_l1,
                                             hp.lambda_l2, ro))
            gain = torch.where(bad, neg_inf, gain)
        gain = torch.where(ok & (gain > mgs[:, None, None]), gain, neg_inf)
        return gain, (lg, lh - _EPS32, lc)

    na_dir = has_md & (mt == MissingType.NAN)
    t_valid = (bins < (nb - 1 - na_dir.to(torch.int32)[:, None])) & valid
    t_valid &= ~((mt[:, None] == MissingType.ZERO) & is_miss)
    if rand_thr is not None:
        t_valid = t_valid & (bins == rand_thr.to(torch.int32)[..., None])

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


# ----------------------------------------------------------------------
# categorical search and the staged per-feature search
# ----------------------------------------------------------------------

def _take(a: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``a[..., idx[...]]`` along the last axis (idx one fewer dim)."""
    return a.gather(-1, idx[..., None])[..., 0]


def _best_categorical(hist: torch.Tensor, scales: Sequence[int],
                      sum_grad: torch.Tensor, sum_hess: torch.Tensor,
                      num_data: torch.Tensor, num_bin: torch.Tensor,
                      missing_type: torch.Tensor,
                      hp: SplitHyperparams,
                      rand_u: Optional[torch.Tensor] = None
                      ) -> PerFeatureBest:
    """Categorical split search, vectorized over children and features.

    ``hist`` [NC, 3, F, B] int64 fixed point at ``scales``; ``sum_*``
    [NC] f32 child totals; ``num_bin``/``missing_type`` [F].  One-hot mode
    (``num_bin <= max_cat_to_onehot``): the best single category against
    the rest.  Otherwise categories with at least ``min_data_per_group //
    4`` rows are sorted by ``g / (h + cat_smooth)`` and scanned from both
    ends, at most ``max_cat_threshold`` categories on the left;
    ``lambda_l2 += cat_l2``.  Returns per-feature tuples whose threshold
    is the many-vs-many split position and whose bitset holds the bins
    going left (never the NaN bin).  Extra trees' ``rand_u`` [NC, F]
    uniforms keep one category (one-hot mode, ``floor(u * num_bin)``)
    or one sorted position (``floor(u * usable categories)``) per
    feature."""
    NC, _, F, B = hist.shape
    dev = hist.device
    l1, l2 = hp.lambda_l1, hp.lambda_l2 + hp.cat_l2
    neg_inf = torch.full((), K_MIN_SCORE, dtype=torch.float32, device=dev)
    cells = fixed_to_f32(hist, scales, -3)
    g, h, c = cells[:, 0], cells[:, 1], cells[:, 2]               # [NC,F,B]
    sg = sum_grad.to(torch.float32)[:, None]
    sh = sum_hess.to(torch.float32)[:, None]
    nd = num_data.to(torch.float32)[:, None]
    total_g, total_h = sg[..., None], (sh + _TWO_EPS32)[..., None]
    n3 = nd[..., None]
    parent_gain = leaf_gain(sg, sh + _TWO_EPS32, l1, l2)           # [NC, 1]
    mgs = parent_gain + f32(hp.min_gain_to_split)
    mgs3 = mgs[..., None]
    min_data = f32(hp.min_data_in_leaf)
    min_hess = f32(hp.min_sum_hessian_in_leaf)
    bins = torch.arange(B, device=dev)
    valid_bin = bins[None, :] < num_bin.to(torch.int64)[:, None]   # [F, B]

    def gains(lg, lh, lc, ok):
        rg, rh, rc = total_g - lg, total_h - lh, n3 - lc
        ok = (ok & (lc >= min_data) & (rc >= min_data)
              & (lh >= min_hess) & (rh >= min_hess))
        gn = leaf_gain(lg, lh, l1, l2) + leaf_gain(rg, rh, l1, l2)
        return torch.where(ok & (gn > mgs3), gn, neg_inf)

    # --- one-hot mode: each category against the rest
    oh_lh = h + _EPS32
    onehot = gains(g, oh_lh, c, valid_bin)
    if rand_u is not None:
        rand_u = rand_u.to(torch.float32)
        rand_cat = torch.floor(rand_u * num_bin.to(torch.float32)).to(
            torch.int64)
        onehot = torch.where(bins == rand_cat[..., None], onehot, neg_inf)
    oh_k = torch.argmax(onehot, dim=-1)                           # [NC, F]
    oh_gain = _take(onehot, oh_k)

    # --- many-vs-many over the sorted usable categories
    usable = valid_bin & (c >= float(max(1, hp.min_data_per_group // 4)))
    ratio = torch.where(usable, g / (h + f32(hp.cat_smooth)),
                        torch.full_like(g, math.inf))
    order = torch.argsort(ratio, dim=-1, stable=True)             # [NC,F,B]
    s_usable = usable.gather(-1, order)
    sorted_hist = hist.gather(-1, order[:, None].expand(-1, 3, -1, -1))
    prefix = sorted_hist.masked_fill(~s_usable[:, None], 0).cumsum(-1)
    tot = prefix[..., -1:]
    pg, ph, pc = fixed_to_f32(prefix, scales, -3).unbind(1)
    qg, qh, qc = fixed_to_f32(tot - prefix, scales, -3).unbind(1)
    k_idx = bins.view(1, 1, B)
    max_k = min(hp.max_cat_threshold, B)
    n_usable = s_usable.sum(-1, keepdim=True)

    if rand_u is not None:
        rand_pos = torch.floor(
            rand_u * n_usable[..., 0].to(torch.float32)).to(torch.int64)

    def scan_dir(lg, lh, lc, size_ok):
        gn = gains(lg, lh, lc, size_ok)
        if rand_u is not None:
            gn = torch.where(k_idx == rand_pos[..., None], gn, neg_inf)
        kk = torch.argmax(gn, dim=-1)
        return (_take(gn, kk), kk,
                (_take(lg, kk), _take(lh - _EPS32, kk), _take(lc, kk)))

    lo_gain, lo_k, lo_sums = scan_dir(pg, ph + _EPS32, pc, k_idx < max_k)
    left_size = n_usable - 1 - k_idx
    hi_gain, hi_k, hi_sums = scan_dir(qg, qh + _EPS32, qc,
                                      (left_size <= max_k) & (left_size >= 1))
    use_lo = lo_gain >= hi_gain
    mm_gain = torch.where(use_lo, lo_gain, hi_gain)
    mm_k = torch.where(use_lo, lo_k, hi_k)
    mm = [torch.where(use_lo, a, b) for a, b in zip(lo_sums, hi_sums)]

    is_onehot = (num_bin <= hp.max_cat_to_onehot)[None, :]        # [1, F]
    cat_gain = torch.where(is_onehot, oh_gain, mm_gain)
    cat_gain = torch.where(torch.isfinite(cat_gain), cat_gain - mgs, neg_inf)
    cat_lg = torch.where(is_onehot, _take(g, oh_k), mm[0])
    cat_lh = torch.where(is_onehot, _take(oh_lh, oh_k) - _EPS32, mm[1])
    cat_lc = torch.where(is_onehot, _take(c, oh_k), mm[2])

    # bins going left: one-hot {oh_k}; low side sorted[0..k]; high side
    # sorted[k+1..]
    in_left = torch.where(use_lo[..., None], k_idx <= mm_k[..., None],
                          (k_idx > mm_k[..., None]) & s_usable)
    member = torch.zeros_like(s_usable).scatter(-1, order,
                                                in_left & s_usable)
    member = torch.where(is_onehot[..., None], k_idx == oh_k[..., None],
                         member)
    # the NaN category never sits in the stored left set: swap the sides
    # (the same partition) where it would
    is_nan_bin = ((k_idx == (num_bin.to(torch.int64) - 1)[None, :, None])
                  & (missing_type == MissingType.NAN)[None, :, None])
    nan_left = (member & is_nan_bin).any(-1)
    member = torch.where(nan_left[..., None], valid_bin & ~member & ~is_nan_bin,
                         member)
    cat_lg = torch.where(nan_left, sg - cat_lg, cat_lg)
    cat_lh = torch.where(nan_left, sh - cat_lh, cat_lh)
    cat_lc = torch.where(nan_left, nd - cat_lc, cat_lc)
    return PerFeatureBest(
        gain=cat_gain, threshold=mm_k.to(torch.int32),
        default_left=torch.zeros_like(nan_left),
        left_sum_grad=cat_lg, left_sum_hess=cat_lh, left_count=cat_lc,
        is_categorical=torch.ones_like(nan_left),
        cat_bitset=member_bitset(member))


def member_bitset(member: torch.Tensor) -> torch.Tensor:
    """[..., B] bool bin membership -> [..., MAX_CAT_WORDS] int64 words
    (bin b is bit b % 32 of word b // 32; bins past 256 are dropped)."""
    B = member.shape[-1]
    nb = min(B, 32 * MAX_CAT_WORDS)
    bits = torch.zeros(member.shape[:-1] + (32 * MAX_CAT_WORDS,),
                       dtype=torch.int64, device=member.device)
    bits[..., :nb] = member[..., :nb].to(torch.int64)
    weight = torch.bitwise_left_shift(
        torch.ones(32, dtype=torch.int64, device=member.device),
        torch.arange(32, device=member.device))
    return (bits.view(member.shape[:-1] + (MAX_CAT_WORDS, 32))
            * weight).sum(-1)


def merge_categorical(best: NumericFeatureBest,
                      cat_best: Optional[PerFeatureBest] = None,
                      cat_idx: Optional[torch.Tensor] = None
                      ) -> PerFeatureBest:
    """Per-feature tuples of every feature: the numeric scan's, with the
    categorical columns ``cat_idx`` overwritten by ``cat_best`` (the JAX
    package's ``where(is_categorical, cat, numeric)``)."""
    shape = best.gain.shape
    dev = best.gain.device
    out = PerFeatureBest(
        gain=best.gain, threshold=best.threshold,
        default_left=best.default_left, left_sum_grad=best.left_sum_grad,
        left_sum_hess=best.left_sum_hess, left_count=best.left_count,
        is_categorical=torch.zeros(shape, dtype=torch.bool, device=dev),
        cat_bitset=torch.zeros(shape + (MAX_CAT_WORDS,), dtype=torch.int64,
                               device=dev))
    if cat_best is None:
        return out
    merged = []
    for name in PerFeatureBest._fields:
        a = getattr(out, name).clone()
        if name == "cat_bitset":
            a[..., cat_idx, :] = cat_best.cat_bitset
        else:
            a[..., cat_idx] = getattr(cat_best, name).to(a.dtype)
        merged.append(a)
    return PerFeatureBest(*merged)


def pick_best_feature(pf: PerFeatureBest, sum_grad, sum_hess, num_data,
                      feature_mask: Optional[torch.Tensor] = None
                      ) -> SplitResult:
    """argmax over features (the last axis; ties -> smaller feature
    index, reference: SplitInfo::operator>, split_info.hpp:126-155).  The
    feature mask applies here, as ``feature_best_splits`` applies it."""
    gain = pf.gain
    if feature_mask is not None:
        gain = torch.where(feature_mask.to(torch.bool), gain,
                           torch.full_like(gain, K_MIN_SCORE))
    f = torch.argmax(gain, dim=-1)
    blg, blh, blc = (_take(pf.left_sum_grad, f), _take(pf.left_sum_hess, f),
                     _take(pf.left_count, f))
    bitset = pf.cat_bitset.gather(
        -2, f[..., None, None].expand(f.shape + (1, MAX_CAT_WORDS)))[..., 0, :]
    return SplitResult(
        gain=_take(gain, f), feature=f, threshold=_take(pf.threshold, f),
        default_left=_take(pf.default_left, f),
        left_sum_grad=blg, left_sum_hess=blh, left_count=blc,
        right_sum_grad=sum_grad - blg, right_sum_hess=sum_hess - blh,
        right_count=num_data.to(torch.float32) - blc,
        is_categorical=_take(pf.is_categorical, f), cat_bitset=bitset)


def feature_best_splits(hist: torch.Tensor, scales: Sequence[int],
                        sum_grad: torch.Tensor, sum_hess: torch.Tensor,
                        num_data: torch.Tensor, num_bin: torch.Tensor,
                        missing_type: torch.Tensor,
                        default_bin: torch.Tensor,
                        is_categorical: torch.Tensor, hp: SplitHyperparams,
                        feature_mask: Optional[torch.Tensor] = None,
                        monotone_constraints: Optional[torch.Tensor] = None,
                        leaf_output_bounds: Optional[tuple] = None,
                        extra_rand_u: Optional[torch.Tensor] = None,
                        groups=None,
                        scan_plan: Optional[torch.Tensor] = None,
                        cat_idx: Optional[torch.Tensor] = None
                        ) -> PerFeatureBest:
    """Best split PER FEATURE of each child.

    ``hist`` [NC, 3, F, B] int64 fixed point at ``scales`` (or [NC, 2, F,
    B] integer levels with ``QuantScales``), or, with ``groups`` (an
    ``ops.fused.GroupLayout``), the staged arm's group histograms [NC, C,
    G, Bg]; ``sum_*`` [NC] f32 child totals; meta [F].  The numeric scan
    is B5 in leaf mode (``ops.fused.sibling_scan``: the kernel on the
    card, its plain version on the CPU), on the group histograms where
    given; the categorical columns are searched by ``_best_categorical``
    on their slice (expanded from the groups, ``ops.fused.expand_groups``
    restricted to them) and merged over it.  The
    feature mask ([F], or [NC, F] per child) sets a masked feature's
    gain to -inf.  ``monotone_constraints``/``leaf_output_bounds`` go to
    the numeric scan; extra trees' ``extra_rand_u`` [NC, F, 2] uniforms
    give the numeric scan its thresholds (column 0,
    ``random_thresholds``) and the categorical search its draws (column
    1).  ``scan_plan``: B5's warp tasks for ``num_bin``
    (``ops.fused.scan_tasks``), planned by the scan where None.
    ``cat_idx``: the categorical columns (int64 [Fc], maybe empty), found
    from ``is_categorical`` (a host read) where None."""
    from .fused import expand_groups, sibling_scan
    sums = torch.stack([sum_grad.to(torch.float32),
                        sum_hess.to(torch.float32),
                        num_data.to(torch.float32)])
    rand_thr = (random_thresholds(extra_rand_u[..., 0], num_bin)
                if extra_rand_u is not None else None)
    nfb = sibling_scan(hist, scales, sums, num_bin, missing_type,
                       default_bin, hp,
                       monotone_constraints=monotone_constraints,
                       child_bounds=leaf_output_bounds, rand_thr=rand_thr,
                       groups=groups, plan=scan_plan)
    if cat_idx is None:
        cat_idx = torch.nonzero(is_categorical.to(torch.bool)).flatten()
    cat_best = None
    if cat_idx.numel():
        cat_idx = cat_idx.to(hist.device)
        ch = (hist[:, :, cat_idx] if groups is None
              else expand_groups(hist, groups, num_bin, cat_idx))
        if isinstance(scales, QuantScales):
            ch = quant_count_hist(ch, sums[2])
        cat_best = _best_categorical(
            ch, scales, sum_grad, sum_hess, num_data, num_bin[cat_idx],
            missing_type[cat_idx], hp,
            rand_u=(extra_rand_u[..., cat_idx, 1]
                    if extra_rand_u is not None else None))
    pf = merge_categorical(nfb, cat_best, cat_idx)
    if feature_mask is not None:
        pf = pf._replace(gain=torch.where(
            feature_mask.to(torch.bool), pf.gain,
            torch.full_like(pf.gain, K_MIN_SCORE)))
    return pf


def best_split_for_leaf(hist: torch.Tensor, scales: Sequence[int],
                        sum_grad, sum_hess, num_data, num_bin, missing_type,
                        default_bin, is_categorical, hp: SplitHyperparams,
                        feature_mask: Optional[torch.Tensor] = None,
                        monotone_constraints: Optional[torch.Tensor] = None,
                        leaf_output_bounds: Optional[tuple] = None,
                        extra_rand_u: Optional[torch.Tensor] = None,
                        groups=None,
                        scan_plan: Optional[torch.Tensor] = None,
                        cat_idx: Optional[torch.Tensor] = None
                        ) -> SplitResult:
    """Best split over all features of each child (see
    ``feature_best_splits``); [NC] fields."""
    pf = feature_best_splits(hist, scales, sum_grad, sum_hess, num_data,
                             num_bin, missing_type, default_bin,
                             is_categorical, hp, feature_mask,
                             monotone_constraints, leaf_output_bounds,
                             extra_rand_u, groups, scan_plan, cat_idx)
    return pick_best_feature(pf, sum_grad, sum_hess, num_data)
