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

from typing import Tuple

import torch

from .histogram import _vals_t, fixed_point_scales
from .split import fixed_to_f32


def quant_train_renew_leaf(leaf_id: torch.Tensor, grad: torch.Tensor,
                           hess: torch.Tensor, weight: torch.Tensor,
                           num_leaves: int
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """True per-leaf sums ``(sum g * w, sum h * w)``, each [num_leaves]
    f32: the f32 of the exact sum of each leaf's rows."""
    from . import fused
    vals = _vals_t(grad, hess, weight).contiguous()
    scales = fixed_point_scales(vals)
    leaf = leaf_id.to(torch.int32)[None, :].contiguous()
    slot = torch.zeros(leaf.shape[1], dtype=torch.int32, device=leaf.device)
    sums = fused.accumulate(leaf, vals, slot, 1, num_leaves, scales)[0, :, 0]
    out = fixed_to_f32(sums, scales, 0)                      # [3, L]
    return out[0], out[1]
