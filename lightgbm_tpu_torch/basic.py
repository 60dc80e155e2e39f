"""Booster: the user-facing handle of a loaded model (counterpart of the
loaded-model half of ``lightgbm_tpu/basic.py``).

reference: python-package/lightgbm/basic.py:1704 (class Booster).  The
Booster owns one torch device.  ``device=None`` means the CUDA card, and
a host without one raises instead of quietly running on the CPU; the
CPU is used only when the caller asks for it (``device="cpu"``).
"""

from __future__ import annotations

import json
import os
import tempfile
from typing import List, Optional

import numpy as np
import torch

from .model_text import load_model_from_string, save_model_to_string
from .tree import HostTree
from .utils.log import LightGBMError


def resolve_device(device=None) -> torch.device:
    """``None`` -> the current CUDA device; a CUDA device on a host
    without CUDA raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "lightgbm_tpu_torch runs on a CUDA device by default and "
            "torch.cuda.is_available() is False; pass device='cpu' to run "
            "on the CPU")
    return dev


class Booster:
    def __init__(self, params: Optional[dict] = None, *,
                 model_file: Optional[str] = None,
                 model_str: Optional[str] = None, device=None):
        self.params = dict(params or {})
        self.device = resolve_device(device)
        self.best_iteration = -1
        if model_file is not None:
            with open(model_file) as fh:
                model_str = fh.read()
        if model_str is None:
            raise ValueError("need model_file or model_str")
        self._loaded = load_model_from_string(model_str)
        self.pandas_categorical = self._loaded.get("pandas_categorical")

    # ------------------------------------------------------------- structure

    @property
    def models(self) -> List[HostTree]:
        return self._loaded["models"]

    @property
    def num_tree_per_iteration(self) -> int:
        return self._loaded["num_tree_per_iteration"]

    @property
    def num_class(self) -> int:
        return self._loaded["num_class"]

    def num_trees(self) -> int:
        return len(self.models)

    def num_features(self) -> int:
        return self._loaded["max_feature_idx"] + 1

    def num_feature(self) -> int:
        return self.num_features()

    def feature_name(self) -> List[str]:
        return self._loaded["feature_names"]

    # ------------------------------------------------------------- inference

    def _forest(self, start_iter: int, stop_iter: int):
        """StackedForest over models[start*K : stop*K], cached per range."""
        from .predict import StackedForest
        K = self.num_tree_per_iteration
        key = (start_iter, stop_iter, len(self.models))
        cached = getattr(self, "_forest_cache", None)
        if cached is not None and cached[0] == key:
            return cached[1]
        forest = StackedForest(self.models[start_iter * K:stop_iter * K])
        self._forest_cache = (key, forest)
        return forest

    def _device_forest(self, forest):
        """DeviceForest for ``forest`` on this Booster's device, cached
        alongside the host cache."""
        from .predict import DeviceForest
        cached = getattr(self, "_device_forest_cache", None)
        if cached is not None and cached[0] is forest:
            return cached[1]
        dev = DeviceForest(forest, self.device)
        self._device_forest_cache = (forest, dev)
        return dev

    def predict(self, data, num_iteration: Optional[int] = None,
                raw_score: bool = False, pred_leaf: bool = False,
                start_iteration: int = 0, device: bool = True,
                **kwargs) -> np.ndarray:
        """reference: basic.py:2281 Booster.predict.

        ``device=True`` (default) routes rows on this Booster's device
        (float32 scores summed in the pinned tree order); ``device=False``
        runs the host float64 NumPy path.  ``pred_early_stop`` /
        ``pred_early_stop_freq`` / ``pred_early_stop_margin`` mirror the
        reference (src/boosting/prediction_early_stop.cpp) and run only on
        the host path: with ``device=True`` they raise.
        """
        X = np.ascontiguousarray(np.asarray(data, np.float64))
        if X.ndim == 1:
            X = X[None, :]
        disable_check = kwargs.get(
            "predict_disable_shape_check",
            self.params.get("predict_disable_shape_check", False))
        if X.shape[1] != self.num_features() and not disable_check:
            raise LightGBMError(
                f"The number of features in data ({X.shape[1]}) is not the "
                f"same as it was in training data ({self.num_features()}).\n"
                "You can set ``predict_disable_shape_check=true`` to discard "
                "this error, but please be aware what you are doing.")
        K = self.num_tree_per_iteration
        n_total_iter = len(self.models) // max(K, 1)
        if num_iteration is None or num_iteration < 0:
            # best_iteration is already a 1-based count of iterations to keep
            num_iteration = (self.best_iteration
                             if self.best_iteration > 0 else n_total_iter)
        stop_iter = min(start_iteration + num_iteration, n_total_iter)
        forest = self._forest(start_iteration, stop_iter)

        if pred_leaf:
            if device:
                return self._device_forest(forest).predict_leaf(X)
            return forest.predict_leaf(X)

        early_stop = None
        if kwargs.get("pred_early_stop"):
            if device:
                raise LightGBMError(
                    "pred_early_stop runs on the host path only; pass "
                    "device=False to predict with early stop")
            from .predict import make_early_stop
            obj = (self.objective_name or "").split(" ")[0]
            kind = ("binary" if obj == "binary"
                    else "multiclass" if obj in ("multiclass", "softmax",
                                                 "multiclassova", "ova")
                    else "none")
            early_stop = make_early_stop(
                kind,
                float(kwargs.get("pred_early_stop_margin", 10.0)),
                int(kwargs.get("pred_early_stop_freq", 10)))

        if device:
            raw = self._device_forest(forest).predict_raw(X, num_class=K)
        else:
            raw = forest.predict_raw(X, num_class=K, early_stop=early_stop)
        if self.average_output and stop_iter > start_iteration:
            raw /= (stop_iter - start_iteration)
        if raw_score:
            return raw[0] if K == 1 else raw.T
        conv = self._convert_output(raw)
        return conv[0] if (K == 1 and conv.shape[0] == 1) else conv.T

    def serve(self, config=None, **overrides):
        """In-process inference server over this model: thread-safe
        ``submit``/``predict`` with micro-batching into power-of-two
        shape buckets, per-request deadlines, queue backpressure, a
        JSON-dumpable metrics registry, and graceful drain on
        ``close()``.  Keyword overrides populate a
        ``serving.ServingConfig`` (e.g. ``max_batch_rows=512,
        backend="host"``)."""
        from .serving import Server
        return Server(self, config=config, **overrides)

    def _convert_output(self, raw: np.ndarray) -> np.ndarray:
        obj = self.objective_name.split(" ")[0] if self.objective_name else ""
        if obj == "binary":
            sig = self._objective_param("sigmoid", 1.0)
            return 1.0 / (1.0 + np.exp(-sig * raw))
        if obj in ("multiclass", "softmax"):
            e = np.exp(raw - raw.max(axis=0, keepdims=True))
            return e / e.sum(axis=0, keepdims=True)
        if obj in ("multiclassova", "ova"):
            sig = self._objective_param("sigmoid", 1.0)
            return 1.0 / (1.0 + np.exp(-sig * raw))
        if obj in ("poisson", "gamma", "tweedie"):
            return np.exp(raw)
        if obj in ("cross_entropy_lambda", "xentlambda"):
            return np.log1p(np.exp(raw))
        if obj in ("cross_entropy", "xentropy"):
            return 1.0 / (1.0 + np.exp(-raw))
        if obj == "regression" and self._objective_param_flag("sqrt"):
            return np.sign(raw) * raw * raw
        return raw

    def _objective_param(self, key: str, default: float) -> float:
        for tok in (self.objective_name or "").split(" ")[1:]:
            if tok.startswith(f"{key}:"):
                return float(tok.split(":", 1)[1])
        return default

    def _objective_param_flag(self, key: str) -> bool:
        return key in (self.objective_name or "").split(" ")[1:]

    def feature_importance(self, importance_type: str = "split",
                           iteration: Optional[int] = None) -> np.ndarray:
        imp = np.zeros(self.num_features(), np.float64)
        K = self.num_tree_per_iteration
        if iteration is None:
            # reference: Booster.feature_importance defaults to
            # best_iteration (basic.py:2744)
            iteration = self.best_iteration
        stop = len(self.models) if iteration <= 0 else iteration * K
        for ht in self.models[:stop]:
            for s in range(ht.num_leaves - 1):
                f = int(ht.split_feature[s])
                if importance_type == "split":
                    imp[f] += 1
                else:
                    imp[f] += max(float(ht.split_gain[s]), 0.0)
        if importance_type == "split":
            return imp.astype(np.int64)
        return imp

    # -------------------------------------------------------------- model IO

    @property
    def sub_model_name(self) -> str:
        return self._loaded["sub_model_name"]

    @property
    def average_output(self) -> bool:
        return self._loaded["average_output"]

    @property
    def objective_name(self) -> str:
        return self._loaded["objective_name"]

    @property
    def label_index(self) -> int:
        return 0

    @property
    def max_feature_idx(self) -> int:
        return self.num_features() - 1

    @property
    def feature_names(self) -> List[str]:
        return self.feature_name()

    @property
    def feature_infos(self) -> List[str]:
        return self._loaded["feature_infos"]

    @property
    def params_str(self) -> str:
        return "\n".join(f"[{k}: {v}]" for k, v in sorted(self.params.items()))

    def feature_importance_int(self):
        imp = self.feature_importance("split")
        names = self.feature_name()
        return [(names[i], int(imp[i])) for i in range(len(imp))]

    def model_to_string(self, num_iteration: Optional[int] = None,
                        start_iteration: int = 0) -> str:
        # reference: num_iteration defaults to best_iteration
        # (basic.py:2407,2490)
        if num_iteration is None:
            num_iteration = self.best_iteration
        out = save_model_to_string(self, num_iteration, start_iteration)

        # category value lists ride in the model file (reference:
        # _dump_pandas_categorical, basic.py:385)
        def _default(o):
            if isinstance(o, np.generic):
                return o.item()
            raise TypeError(f"not JSON serializable: {type(o)}")

        out += ("\npandas_categorical:"
                + json.dumps(self.pandas_categorical, default=_default)
                + "\n")
        return out

    def save_model(self, filename: str, num_iteration: Optional[int] = None,
                   start_iteration: int = 0) -> "Booster":
        """Write the model text atomically (temp sibling + os.replace), so
        a crash mid-write never leaves a truncated model."""
        text = self.model_to_string(num_iteration, start_iteration)
        d = os.path.dirname(os.path.abspath(filename))
        os.makedirs(d, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=d, prefix=".model.")
        try:
            with os.fdopen(fd, "w") as fh:
                fh.write(text)
            os.replace(tmp, filename)
        except BaseException:
            os.unlink(tmp)
            raise
        return self
