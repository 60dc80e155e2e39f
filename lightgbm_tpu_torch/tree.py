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

    # ------------------------------------------------------------- transforms

    def add_bias(self, val: float) -> None:
        """reference: Tree::AddBias (tree.h:169)."""
        self.leaf_value = self.leaf_value + val
        self.internal_value = self.internal_value + val

    def scale(self, rate: float) -> None:
        """reference: Tree::Shrinkage (tree.h:158)."""
        self.leaf_value = self.leaf_value * rate
        self.internal_value = self.internal_value * rate
        self.shrinkage *= rate

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

    def expected_value(self) -> float:
        """reference: Tree::ExpectedValue: the leaves' outputs weighted by
        their counts."""
        if self.num_leaves <= 1:
            return float(self.leaf_value[0]) if len(self.leaf_value) else 0.0
        tot = float(self.internal_count[0]) if len(self.internal_count) else 0.0
        if tot <= 0:
            return 0.0
        return float((self.leaf_value * self.leaf_count).sum() / tot)

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


def tree_to_host(tree_arrays, train_set, shrinkage: float) -> HostTree:
    """Trained ``TreeArrays`` (bin thresholds over used features, on any
    device; or its fields already on the host, a dict of arrays) -> a
    self-contained HostTree (double thresholds, real feature indices).
    A categorical split's bin bitset becomes a bitset over category
    values (``cat_boundaries``/``cat_threshold``, the node's threshold
    its index), as the JAX package's ``tree_to_host`` does."""
    ta = (tree_arrays if isinstance(tree_arrays, dict)
          else tree_arrays.to_numpy())
    nl = int(ta["num_leaves"])
    ns = max(nl - 1, 0)
    used = train_set.used_features
    mappers = train_set.bin_mappers
    split_feature_inner = np.asarray(ta["split_feature"][:ns], np.int32)
    real_feat = np.array([used[f] for f in split_feature_inner], np.int32) \
        if ns else np.zeros(0, np.int32)
    thr_bin = np.asarray(ta["threshold_bin"][:ns], np.int32)
    dl = np.asarray(ta["default_left"][:ns], bool)
    is_cat = np.asarray(ta["is_categorical"][:ns], bool)
    threshold = np.zeros(ns, np.float64)
    decision_type = np.zeros(ns, np.int8)
    cat_boundaries = [0]
    cat_threshold = []
    for s in range(ns):
        m = mappers[used[split_feature_inner[s]]]
        if is_cat[s]:
            # bin bitset -> category-value bitset
            bin_bits = np.asarray(ta["cat_bitset"][s], np.uint32)
            cats = [m.bin_2_categorical[b] for b in range(m.num_bin)
                    if (bin_bits[b // 32] >> (b % 32)) & 1
                    and b < len(m.bin_2_categorical)
                    and m.bin_2_categorical[b] >= 0]
            words = np.zeros((max(cats) if cats else 0) // 32 + 1, np.uint32)
            for cv in cats:
                words[cv // 32] |= np.uint32(1) << np.uint32(cv % 32)
            threshold[s] = len(cat_boundaries) - 1
            cat_boundaries.append(cat_boundaries[-1] + len(words))
            cat_threshold.extend(words.tolist())
            decision_type[s] = K_CATEGORICAL_MASK | ((m.missing_type & 3) << 2)
            continue
        dt = K_DEFAULT_LEFT_MASK if dl[s] else 0
        dt |= (m.missing_type & 3) << 2
        r = m.num_bin - 1 - (1 if m.missing_type == MISSING_NAN else 0)
        tb = min(int(thr_bin[s]), max(r - 1, 0))
        threshold[s] = m.bin_upper_bound[tb]
        decision_type[s] = dt

    def f64(name, k):
        return np.asarray(ta[name][:k], np.float64)
    return HostTree(
        num_leaves=nl, split_feature=real_feat,
        split_feature_inner=split_feature_inner, threshold=threshold,
        threshold_in_bin=thr_bin, decision_type=decision_type,
        left_child=np.asarray(ta["left_child"][:ns], np.int32),
        right_child=np.asarray(ta["right_child"][:ns], np.int32),
        split_gain=f64("split_gain", ns),
        internal_value=f64("internal_value", ns),
        internal_weight=f64("internal_weight", ns),
        internal_count=f64("internal_count", ns),
        leaf_value=f64("leaf_value", nl), leaf_weight=f64("leaf_weight", nl),
        leaf_count=f64("leaf_count", nl),
        num_cat=len(cat_boundaries) - 1,
        cat_boundaries=np.asarray(cat_boundaries, np.int32),
        cat_threshold=np.asarray(cat_threshold, np.uint32),
        shrinkage=shrinkage, real_feature_index=real_feat)
