"""Synthetic models and rows for the tests and the chip smoke run (not
public API).

``synthetic_model_text`` writes reference-format model text for random,
valid leaf-wise trees over a seeded feature distribution:

- numeric thresholds are drawn from the quantiles of each feature's
  distribution, as midpoints of adjacent sample values (half of them
  rounded to float32, half left in float64 so the device path's threshold
  round-down is exercised);
- ``decision_type`` bits cover the missing types none/zero/NaN (one per
  numeric feature, cycling through ``missing_types``) and both
  ``default_left`` values;
- categorical features get bitsets, some wider than one 32-bit word;
- about one tree in twenty is a single leaf.

``synthetic_rows`` draws rows from the same distribution, rounded to
float32 precision (the device path's exactness domain), with NaNs,
zeros and out-of-range categories planted; ``salt_rows`` overwrites the
first rows with the routing edge cases.
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import Sequence

import numpy as np

from .model_text import save_model_to_string
from .tree import HostTree, MISSING_NAN, MISSING_NONE, MISSING_ZERO

_SAMPLE = 4096
ALL_MISSING = (MISSING_NONE, MISSING_ZERO, MISSING_NAN)
SALT_VALUES = (0.0, np.nan, -1e30, 1e30, 2.5, -0.5)


def _feature_specs(num_features: int, cat_features: Sequence[int],
                   seed: int, missing_types: Sequence[int]) -> list:
    rng = np.random.RandomState(seed)
    cats = set(int(c) for c in cat_features)
    specs = []
    numeric_i = 0
    for f in range(num_features):
        if f in cats:
            # 8..100 categories: bitsets of one to four words
            specs.append({"cat": True, "ncat": int(rng.randint(8, 101)),
                          "mt": MISSING_NAN})
            continue
        mt = int(missing_types[numeric_i % len(missing_types)])
        numeric_i += 1
        loc, scale = rng.normal(0.0, 2.0), rng.uniform(0.5, 3.0)
        sample = rng.normal(loc, scale, _SAMPLE)
        if mt == MISSING_ZERO:
            sample[rng.rand(_SAMPLE) < 0.2] = 0.0
        specs.append({"cat": False, "loc": loc, "scale": scale, "mt": mt,
                      "sample": np.sort(sample)})
    return specs


def synthetic_rows(num_features: int, n: int, cat_features=(),
                   seed: int = 0, row_seed: int = 1,
                   missing_types: Sequence[int] = ALL_MISSING) -> np.ndarray:
    """[n, F] float64 rows of float32 precision from the distribution of
    ``synthetic_model_text`` with the same features, seed and missing
    types."""
    specs = _feature_specs(num_features, cat_features, seed, missing_types)
    rng = np.random.RandomState(row_seed)
    X = np.empty((n, num_features), np.float64)
    for f, s in enumerate(specs):
        if s["cat"]:
            col = rng.randint(0, s["ncat"], n).astype(np.float64)
            odd = rng.rand(n)
            col[odd < 0.03] = s["ncat"] + 40          # past the bitset
            col[(odd >= 0.03) & (odd < 0.05)] = -3.0  # negative category
            col[(odd >= 0.05) & (odd < 0.08)] = np.nan
        else:
            col = rng.normal(s["loc"], s["scale"], n)
            col[rng.rand(n) < 0.1] = np.nan
            if s["mt"] == MISSING_ZERO:
                col[rng.rand(n) < 0.2] = 0.0
        X[:, f] = col
    return X.astype(np.float32).astype(np.float64)


def salt_rows(X: np.ndarray) -> np.ndarray:
    """A copy of ``X`` whose first rows are all 0, all NaN, all -1e30,
    all 1e30, all 2.5 and all -0.5 (float32 precision)."""
    Xs = np.array(X, np.float64)
    for i, v in enumerate(SALT_VALUES[:Xs.shape[0]]):
        Xs[i, :] = v
    return Xs.astype(np.float32).astype(np.float64)


def _tree(rng, specs, nl: int, dyadic_leaves: bool) -> HostTree:
    def leaf_values(k):
        if dyadic_leaves:
            return rng.randint(-64, 65, k) / 64.0
        return rng.normal(0.0, 0.1, k)

    if nl <= 1:
        z = np.zeros(0)
        return HostTree(
            num_leaves=1, split_feature=np.zeros(0, np.int32),
            split_feature_inner=np.zeros(0, np.int32), threshold=z,
            threshold_in_bin=np.zeros(0, np.int32),
            decision_type=np.zeros(0, np.int8),
            left_child=np.zeros(0, np.int32),
            right_child=np.zeros(0, np.int32), split_gain=z,
            internal_value=z, internal_weight=z, internal_count=z,
            leaf_value=leaf_values(1), leaf_weight=np.ones(1),
            leaf_count=np.full(1, 100.0), shrinkage=0.1)
    ns = nl - 1
    left = np.zeros(ns, np.int32)
    right = np.zeros(ns, np.int32)
    parent = {0: (-1, None)}            # leaf -> (internal node, side)
    for s in range(ns):
        leaf = int(rng.randint(0, s + 1))   # leaf-wise: grow any leaf
        p, side = parent[leaf]
        if p >= 0:
            (left if side == "L" else right)[p] = s
        left[s], right[s] = ~leaf, ~(s + 1)
        parent[leaf] = (s, "L")
        parent[s + 1] = (s, "R")
    split_feature = np.zeros(ns, np.int32)
    threshold = np.zeros(ns, np.float64)
    decision_type = np.zeros(ns, np.int8)
    cat_boundaries = [0]
    cat_threshold = []
    for s in range(ns):
        f = int(rng.randint(0, len(specs)))
        spec = specs[f]
        split_feature[s] = f
        if spec["cat"]:
            k = int(rng.randint(1, spec["ncat"]))
            chosen = rng.choice(spec["ncat"], size=k, replace=False)
            words = np.zeros(int(chosen.max()) // 32 + 1, np.uint32)
            for c in chosen:
                words[c // 32] |= np.uint32(1) << np.uint32(c % 32)
            threshold[s] = len(cat_boundaries) - 1
            cat_boundaries.append(cat_boundaries[-1] + len(words))
            cat_threshold.extend(int(w) for w in words)
            decision_type[s] = 1 | (spec["mt"] << 2)
        else:
            # a bin upper bound: the midpoint of two adjacent sample values
            srt = spec["sample"]
            i = int(rng.uniform(0.05, 0.95) * (srt.size - 1))
            thr = (srt[i] + srt[i + 1]) / 2.0
            if rng.rand() < 0.5:
                thr = float(np.float32(thr))
            threshold[s] = thr
            decision_type[s] = (spec["mt"] << 2) | (int(rng.rand() < 0.5) << 1)
    counts = rng.randint(20, 2000, ns).astype(np.float64)
    return HostTree(
        num_leaves=nl, split_feature=split_feature,
        split_feature_inner=split_feature.copy(), threshold=threshold,
        threshold_in_bin=np.zeros(ns, np.int32),
        decision_type=decision_type, left_child=left, right_child=right,
        split_gain=np.round(rng.exponential(5.0, ns), 3),
        internal_value=np.round(rng.normal(0.0, 0.1, ns), 6),
        internal_weight=np.round(counts * 0.25, 3), internal_count=counts,
        leaf_value=leaf_values(nl), leaf_weight=np.round(
            rng.uniform(1.0, 50.0, nl), 3),
        leaf_count=rng.randint(10, 1000, nl).astype(np.float64),
        num_cat=len(cat_boundaries) - 1,
        cat_boundaries=np.asarray(cat_boundaries, np.int32),
        cat_threshold=np.asarray(cat_threshold, np.uint32),
        shrinkage=0.1, real_feature_index=split_feature.copy())


def synthetic_model_text(num_features: int, num_trees: int,
                         num_leaves: int, num_class: int = 1,
                         cat_features: Sequence[int] = (), seed: int = 0,
                         dyadic_leaves: bool = False,
                         missing_types: Sequence[int] = ALL_MISSING) -> str:
    """Reference-format model text: ``num_trees`` boosting iterations of
    ``num_class`` trees each, up to ``num_leaves`` leaves per tree.

    ``missing_types`` are the missing types the numeric features cycle
    through.  ``dyadic_leaves`` draws leaf values from multiples of 1/64,
    whose float32 pinned-order sums equal the float64 host sums (the
    device leaf-sum epilogue then verifies)."""
    specs = _feature_specs(num_features, cat_features, seed, missing_types)
    rng = np.random.RandomState(seed + 1)
    K = max(int(num_class), 1)
    trees = []
    for _ in range(num_trees * K):
        u = rng.rand()
        if u < 0.05:
            nl = 1
        elif u < 0.15:
            nl = int(rng.randint(2, num_leaves + 1))
        else:
            nl = num_leaves
        trees.append(_tree(rng, specs, nl, dyadic_leaves))
    names = [f"Column_{f}" for f in range(num_features)]
    infos = [":".join(str(c) for c in range(s["ncat"])) if s["cat"]
             else f"[{s['sample'].min():g}:{s['sample'].max():g}]"
             for s in specs]
    imp = np.zeros(num_features, np.int64)
    for t in trees:
        np.add.at(imp, t.split_feature, 1)
    model = SimpleNamespace(
        models=trees, num_tree_per_iteration=K, num_class=K,
        sub_model_name="tree", label_index=0,
        max_feature_idx=num_features - 1,
        objective_name=("binary sigmoid:1" if K == 1
                        else f"multiclass num_class:{K}"),
        average_output=False, feature_names=names, feature_infos=infos,
        params_str="",
        feature_importance_int=lambda: list(zip(names, imp.tolist())))
    return save_model_to_string(model) + "\npandas_categorical:null\n"
