"""The serving fleet's low-precision models (counterpart of
``lightgbm_tpu/fleet``): ``lowprec`` moves a forest onto a bf16 or int8
grid and measures what that costs.  The fleet's multi-model registry,
router, topology planner and AOT programs are ROADMAP queue A6; the
single-model serving path is ``lightgbm_tpu_torch.serving``.
"""

from .lowprec import (PRECISIONS, bf16_round, forest_precision_bytes,
                      int8_rows, measure_accuracy_delta, quantize_forest)

__all__ = ["PRECISIONS", "bf16_round", "int8_rows", "quantize_forest",
           "forest_precision_bytes", "measure_accuracy_delta"]
