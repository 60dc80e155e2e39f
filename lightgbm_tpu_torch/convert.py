"""Carry a forest across from the JAX package as plain arrays.

Model text is one carrier (text saved by ``lightgbm_tpu`` loads in
``basic.Booster``).  The other is the JAX ``StackedForest``'s own arrays,
handed over as numpy: ``stacked_forest_from_numpy`` rebuilds the port's
``StackedForest`` from them without touching the trees, so the device
planes match the JAX ``DeviceForest``'s element for element.
"""

from __future__ import annotations

import numpy as np

from .predict import StackedForest

# name -> (dtype, rank) of each array a StackedForest carries
_FIELDS = {
    "split_feature": (np.int32, 2),
    "threshold": (np.float64, 2),
    "left": (np.int32, 2),
    "right": (np.int32, 2),
    "is_cat": (np.bool_, 2),
    "default_left": (np.bool_, 2),
    "missing_type": (np.int8, 2),
    "leaf_value": (np.float64, 2),
    "depth": (np.int32, 1),
    "cat_offset": (np.int64, 2),
    "cat_nwords": (np.int32, 2),
    "cat_words": (np.uint32, 1),
}


def stacked_forest_from_numpy(arrays: dict) -> StackedForest:
    """The port's ``StackedForest`` from the arrays of a JAX one:
    ``split_feature``, ``threshold``, ``left``, ``right``, ``is_cat``,
    ``default_left``, ``missing_type``, ``leaf_value``, ``depth``,
    ``cat_offset``, ``cat_nwords``, ``cat_words``, ``has_cat`` and
    ``max_depth``.  Values are checked to survive the cast to the port's
    dtypes, and the node planes to share one [T, I] shape."""
    missing = (set(_FIELDS) | {"has_cat", "max_depth"}) - set(arrays)
    if missing:
        raise KeyError(f"missing forest arrays: {sorted(missing)}")
    f = StackedForest.__new__(StackedForest)
    for name, (dtype, rank) in _FIELDS.items():
        a = np.asarray(arrays[name])
        if a.ndim != rank:
            raise ValueError(f"{name} has rank {a.ndim}, expected {rank}")
        cast = np.ascontiguousarray(a, dtype)
        if not np.array_equal(cast, a):
            raise ValueError(f"{name} does not survive the cast to {dtype}")
        setattr(f, name, cast)
    T, I = f.split_feature.shape
    for name in ("threshold", "left", "right", "is_cat", "default_left",
                 "missing_type", "cat_offset", "cat_nwords"):
        if getattr(f, name).shape != (T, I):
            raise ValueError(f"{name} is not [{T}, {I}]")
    if f.leaf_value.shape[0] != T or f.depth.shape != (T,):
        raise ValueError("leaf_value/depth disagree with the node planes")
    f.num_trees = T
    f.has_cat = bool(arrays["has_cat"])
    f.max_depth = int(arrays["max_depth"])
    return f
