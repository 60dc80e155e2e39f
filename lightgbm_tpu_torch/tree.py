"""Host-side tree: raw-feature prediction (counterpart of
``lightgbm_tpu/tree.py``).

reference: include/LightGBM/tree.h + src/io/tree.cpp.  A loaded model's
trees carry REAL feature indices and DOUBLE thresholds, so they are
self-contained and text-serializable in the reference's model format.

decision_type bit layout matches the reference exactly (tree.h:19-20,214-233):
bit0 = categorical, bit1 = default_left, bits2-3 = missing type
(0 none, 1 zero, 2 nan).  The port keeps its own copy of these constants
instead of importing the JAX package's binning enums.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

K_CATEGORICAL_MASK = 1
K_DEFAULT_LEFT_MASK = 2
K_ZERO_THRESHOLD = 1e-35

# missing types (bits 2-3 of decision_type)
MISSING_NONE = 0
MISSING_ZERO = 1
MISSING_NAN = 2


@dataclass
class HostTree:
    """Flat-array tree with real feature indices and double thresholds."""

    num_leaves: int
    # internal nodes [num_leaves-1]
    split_feature: np.ndarray        # real (original) feature index
    split_feature_inner: np.ndarray  # used-feature index (training order)
    threshold: np.ndarray            # double threshold (numerical) / cat idx
    threshold_in_bin: np.ndarray     # bin threshold
    decision_type: np.ndarray        # int8 bitfield
    left_child: np.ndarray
    right_child: np.ndarray
    split_gain: np.ndarray
    internal_value: np.ndarray
    internal_weight: np.ndarray
    internal_count: np.ndarray
    # leaves [num_leaves]
    leaf_value: np.ndarray
    leaf_weight: np.ndarray
    leaf_count: np.ndarray
    # categorical storage (reference: tree.h cat_boundaries_/cat_threshold_)
    num_cat: int = 0
    cat_boundaries: np.ndarray = field(default_factory=lambda: np.zeros(1, np.int32))
    cat_threshold: np.ndarray = field(default_factory=lambda: np.zeros(0, np.uint32))
    shrinkage: float = 1.0
    real_feature_index: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int32))

    # ------------------------------------------------------------- prediction

    def _decide(self, fval: np.ndarray, node: int) -> np.ndarray:
        """Vectorized decision; returns bool go-left. reference: tree.h:244-300."""
        dt = int(self.decision_type[node])
        if dt & K_CATEGORICAL_MASK:
            cat_idx = int(self.threshold[node])
            lo, hi = self.cat_boundaries[cat_idx], self.cat_boundaries[cat_idx + 1]
            bitset = self.cat_threshold[lo:hi]
            with np.errstate(invalid="ignore"):     # +-1e30: invalid anyway
                iv = np.where(np.isnan(fval), -1, fval).astype(np.int64)
            valid = (iv >= 0) & (iv < (hi - lo) * 32)
            ivc = np.clip(iv, 0, max((hi - lo) * 32 - 1, 0))
            inset = (bitset[ivc // 32] >> (ivc % 32).astype(np.uint32)) & 1
            return valid & (inset == 1)
        missing_type = (dt >> 2) & 3
        nan_mask = np.isnan(fval)
        if missing_type != MISSING_NAN:
            fval = np.where(nan_mask, 0.0, fval)
            nan_mask = np.zeros_like(nan_mask)
        is_missing = ((missing_type == MISSING_ZERO)
                      & (np.abs(fval) <= K_ZERO_THRESHOLD)) | \
                     ((missing_type == MISSING_NAN) & nan_mask)
        default_left = bool(dt & K_DEFAULT_LEFT_MASK)
        return np.where(is_missing, default_left, fval <= self.threshold[node])

    def predict_leaf_np(self, X: np.ndarray) -> np.ndarray:
        """Leaf index per row [n] (one tree, host float64)."""
        n = X.shape[0]
        if self.num_leaves <= 1:
            return np.zeros(n, np.int32)
        node = np.zeros(n, np.int32)
        active = node >= 0
        while active.any():
            for nd in np.unique(node[active]):
                rows = active & (node == nd)
                gl = self._decide(X[rows, self.split_feature[nd]], nd)
                node[rows] = np.where(gl, self.left_child[nd], self.right_child[nd])
            active = active & (node >= 0)
        return (~node).astype(np.int32)

    def predict_np(self, X: np.ndarray) -> np.ndarray:
        """Raw-feature batch prediction (host)."""
        if self.num_leaves <= 1:
            return np.full(X.shape[0],
                           self.leaf_value[0] if len(self.leaf_value) else 0.0)
        return self.leaf_value[self.predict_leaf_np(X)]

    def max_depth(self) -> int:
        """Decisions on the deepest root-to-leaf path (0 for one leaf)."""
        if self.num_leaves <= 1:
            return 0
        depth = {0: 1}
        md = 1
        for nd in range(self.num_leaves - 1):
            d = depth.get(nd, 1)
            for ch in (self.left_child[nd], self.right_child[nd]):
                if ch >= 0:
                    depth[int(ch)] = d + 1
                    md = max(md, d + 1)
                else:
                    md = max(md, d)
        return md
