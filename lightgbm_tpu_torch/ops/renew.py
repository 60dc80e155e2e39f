"""Leaf renewal of quantized training (counterpart of the
``quant_train_renew_leaf`` half of ``lightgbm_tpu/ops/renew.py``).

reference: GradientDiscretizer::RenewIntGradTreeOutput — with
``use_quantized_grad`` the tree structure comes from the integer
histograms, and with ``quant_train_renew_leaf`` the leaf outputs are
re-fit from the true f32 gradient sums of each leaf's rows.

The JAX package sums with ``segment_sum``.  A float ``index_add_`` on the
card sums through unordered atomics, so its bits would change from run
to run; the port sums exactly instead: the leaf id is the bin of a
one-feature binned matrix, and the accumulate kernel B4
(``ops/fused.py::accumulate``, one slot) adds the rows' fixed-point
values (``ops/histogram.py``), each leaf's sum rounded to f32 once.
The percentile renewal of the L1-family objectives (``leaf_percentile``)
comes with those objectives.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .histogram import _vals_t, fixed_point_scales
from .split import fixed_to_f32


def quant_train_renew_leaf(leaf_id: torch.Tensor, grad: torch.Tensor,
                           hess: torch.Tensor, weight: torch.Tensor,
                           num_leaves: int, group=None,
                           rows: Optional[int] = None,
                           hierarchical: bool = False
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """True per-leaf sums ``(sum g * w, sum h * w)``, each [num_leaves]
    f32: the f32 of the exact sum of each leaf's rows (under a process
    ``group`` or mesh, of every rank's rows: the scales take the group's
    peak and ``rows``, the integer sums are summed over the group by the
    route ``hierarchical`` names)."""
    from ..parallel.collectives import psum_tiered
    from . import fused
    vals = _vals_t(grad, hess, weight).contiguous()
    scales = fixed_point_scales(vals, group, rows)
    leaf = leaf_id.to(torch.int32)[None, :].contiguous()
    slot = torch.zeros(leaf.shape[1], dtype=torch.int32, device=leaf.device)
    sums = psum_tiered(fused.accumulate(leaf, vals, slot, 1, num_leaves,
                                        scales)[0, :, 0], group,
                       hierarchical=hierarchical)
    out = fixed_to_f32(sums, scales, 0)                      # [3, L]
    return out[0], out[1]


def leaf_percentile(leaf_id: torch.Tensor, residual: torch.Tensor,
                    weight: torch.Tensor, num_leaves: int,
                    alpha: float) -> torch.Tensor:
    """Weighted ``alpha``-percentile of the residuals of each leaf, [L]
    f32 (reference: RegressionL1loss::RenewTreeOutput,
    regression_objective.hpp:250, through Common::WeightedPercentile; the
    JAX package's ``leaf_percentile``, ops/renew.py:20-80).

    Rows of zero weight leave their leaf (key L).  The rows are sorted
    by (leaf, residual): a stable sort by residual, then a stable sort by
    leaf.  A row's position is ``(cw - w / 2) / W`` with ``cw`` the
    leaf-local cumulative weight (the global f32 cumsum less the
    leaf's start) and ``W`` the leaf's total; the percentile interpolates
    between the two rows that bracket ``alpha``, or takes the last row
    where no row reaches it.  The cumsum runs in torch's order, not
    ``jnp.cumsum``'s: equal bits for integer weights (ROADMAP queue C).
    The leaf totals are summed leaf by leaf in row order
    (``segment_reduce``), the same bits on every run of the card."""
    L = int(num_leaves)
    dev = residual.device
    seg = torch.where(weight > 0, leaf_id.to(torch.int64),
                      torch.full_like(leaf_id, L, dtype=torch.int64))
    o1 = torch.argsort(residual, stable=True)
    o2 = torch.argsort(seg[o1], stable=True)
    order = o1[o2]
    seg_s, res_s, w_s = seg[order], residual[order], weight[order]
    cw = torch.cumsum(w_s, 0)
    counts = torch.bincount(seg_s, minlength=L + 1)
    seg_total = torch.segment_reduce(w_s, "sum", lengths=counts,
                                     initial=0.0)
    seg_start = torch.cat([seg_total.new_zeros(1),
                           torch.cumsum(seg_total, 0)[:-1]])
    local_cw = cw - seg_start[seg_s]
    tot = seg_total[seg_s]
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    p = torch.where(tot > 0, (local_cw - w_s / 2.0) / tot, zero)
    a = torch.tensor(alpha, dtype=torch.float32, device=dev)
    # the previous row's position in the same leaf (else -inf)
    same = torch.cat([torch.zeros(1, dtype=torch.bool, device=dev),
                      seg_s[1:] == seg_s[:-1]])
    p_prev = torch.where(same, torch.cat([zero[None], p[:-1]]),
                         torch.tensor(-float("inf"), device=dev))
    r_prev = torch.cat([zero[None], res_s[:-1]])
    # the first row of its leaf at or past alpha
    crossing = (p >= a) & (p_prev < a)
    frac = torch.where(p > p_prev,
                       (a - p_prev) / (p - p_prev).clamp_min(1e-30), zero)
    frac = frac.clamp(0.0, 1.0)
    interp = torch.where(torch.isfinite(p_prev),
                         r_prev * (1 - frac) + res_s * frac, res_s)
    out = torch.zeros(L + 1, dtype=torch.float32, device=dev)
    sink = torch.full_like(seg_s, L)
    out.scatter_(0, torch.where(crossing, seg_s, sink), interp)
    # leaves whose last row stays below alpha take that row's residual
    is_last = torch.cat([seg_s[1:] != seg_s[:-1],
                         torch.ones(1, dtype=torch.bool, device=dev)])
    need_last = is_last & (p < a)
    out.scatter_(0, torch.where(need_last, seg_s, sink),
                 torch.where(need_last, res_s, zero))
    return out[:L]
