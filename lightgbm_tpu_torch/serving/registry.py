"""Program + model registry: one predict callable per
(model digest, row bucket, num_class) (counterpart of
``lightgbm_tpu/serving/registry.py``).

``ProgramRegistry`` caches predict callables keyed
``(digest, bucket_rows, num_class)``; a miss builds the callable and
counts a ``bucket_misses`` metric, a hit counts ``bucket_hits``.  PyTorch
runs eagerly, so a program is a closure over the model's
``DeviceForest``: building one compiles and allocates nothing, and the
cache needs no bound (one entry per ladder rung).  The CUDA kernel
itself is built once per process at its first launch.
``ModelRegistry`` holds the active model.
"""

from __future__ import annotations

import hashlib
import threading
from typing import Callable, Dict, Optional, Tuple

import numpy as np


def forest_digest(forest) -> str:
    """Stable content hash of a StackedForest's semantic arrays."""
    h = hashlib.sha256()
    for a in (forest.split_feature, forest.threshold, forest.left,
              forest.right, forest.leaf_value, forest.is_cat,
              forest.default_left, forest.missing_type,
              forest.cat_offset, forest.cat_nwords, forest.cat_words):
        h.update(np.ascontiguousarray(a).tobytes())
    h.update(np.int64([forest.num_trees]).tobytes())
    return h.hexdigest()[:16]


class CompiledModel:
    """One immutable loaded model: booster + host forest (+ device forest
    for the "device" backend), its digest, and its output transform."""

    def __init__(self, booster, backend: str = "device",
                 num_iteration: Optional[int] = None,
                 start_iteration: int = 0):
        self.booster = booster
        self.backend = backend
        K = max(booster.num_tree_per_iteration, 1)
        self.num_class = K
        n_total_iter = len(booster.models) // K
        if num_iteration is None or num_iteration < 0:
            num_iteration = (booster.best_iteration
                             if booster.best_iteration > 0 else n_total_iter)
        stop_iter = min(start_iteration + num_iteration, n_total_iter)
        self.num_iterations = stop_iter - start_iteration
        self.forest = booster._forest(start_iteration, stop_iter)
        self.num_features = booster.num_features()
        # share Booster.predict's cached DeviceForest: one upload per model
        self.device_forest = (booster._device_forest(self.forest)
                              if backend == "device" else None)
        self.digest = forest_digest(self.forest)
        self.average_output = bool(booster.average_output)

    def make_program(self, bucket_rows: int) -> Callable:
        """Predict callable for one bucket shape: [bucket, F] float64
        padded batch -> raw scores [K, bucket] float64.

        Both backends are bit-identical to ``StackedForest.predict_raw``
        per row — "host" unconditionally (it IS predict_raw on the padded
        batch), "device" for float32-precision feature values (the
        DeviceForest's routing-exactness domain; leaf values are summed on
        the host in float64 in the order of predict_raw).
        """
        K = self.num_class
        if self.backend == "host":
            forest = self.forest

            def run(Xpad: np.ndarray) -> np.ndarray:
                return forest.predict_raw(Xpad, num_class=K)

            return run
        dev = self.device_forest

        def run(Xpad: np.ndarray) -> np.ndarray:
            return dev.predict_raw_padded(Xpad, num_class=K)

        return run

    def scale_raw(self, raw: np.ndarray) -> np.ndarray:
        """The average_output division Booster.predict applies to BOTH
        raw and transformed output — identity for every boosting mode
        but rf."""
        if self.average_output and self.num_iterations > 0:
            raw = raw / self.num_iterations
        return raw

    def transform_raw(self, raw: np.ndarray) -> np.ndarray:
        """predict()'s objective transform for ALREADY-SCALED raw
        [K, n]; returns [K, n]."""
        return self.booster._convert_output(raw)


class ProgramRegistry:
    """Predict programs keyed (digest, bucket_rows, num_class)."""

    def __init__(self, metrics):
        self.metrics = metrics
        self._lock = threading.Lock()
        self._programs: Dict[Tuple[str, int, int], Callable] = {}

    def get(self, model: CompiledModel, bucket_rows: int) -> Callable:
        key = (model.digest, bucket_rows, model.num_class)
        with self._lock:
            prog = self._programs.get(key)
            if prog is not None:
                self.metrics.counter("bucket_hits").inc()
                return prog
            prog = self._programs[key] = model.make_program(bucket_rows)
            self.metrics.counter("bucket_misses").inc()
        return prog

    def warm(self, model: CompiledModel, buckets) -> int:
        """Run ``model``'s program on zeros once for every row count in
        ``buckets``, so the kernel build and first launches happen before
        traffic arrives.  Returns the number of buckets warmed."""
        todo = sorted(set(buckets))
        for bucket_rows in todo:
            prog = self.get(model, bucket_rows)
            prog(np.zeros((bucket_rows, model.num_features), np.float64))
        return len(todo)


class ModelRegistry:
    """The serving pointer.  Without model hot-swap it holds one model."""

    def __init__(self, booster, metrics, backend: str = "device",
                 num_iteration: Optional[int] = None,
                 start_iteration: int = 0):
        self._active = CompiledModel(booster, backend=backend,
                                     num_iteration=num_iteration,
                                     start_iteration=start_iteration)
        metrics.gauge("active_model_digest").set(self._active.digest)
        metrics.gauge("model_generation").set(0)

    @property
    def active(self) -> CompiledModel:
        return self._active
