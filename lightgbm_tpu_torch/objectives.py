"""Objective functions: gradients and hessians in torch (counterpart of
``lightgbm_tpu/objectives.py`` for ``regression`` (l2) and ``binary``).

reference: src/objective/ — ObjectiveFunction (objective_function.h:19)
and its factory (objective_function.cpp:17-47).  Gradients run on the
score tensor's device in f32, with the JAX package's operation order
(l2 is one subtraction, bit-equal to it; the binary gradient goes
through ``exp``, whose last bit may differ between libraries).  Every
other objective raises ``NotImplementedError``.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

from .config import Config
from .dataset import Metadata
from .ops.split import f32


class ObjectiveFunction:
    name = "none"
    num_model_per_iteration = 1
    is_constant_hessian = False
    renew_percentile: Optional[float] = None
    need_group = False

    def __init__(self, config: Config):
        self.config = config

    def init(self, metadata: Metadata, num_data: int,
             device=None) -> None:
        dev = torch.device("cpu" if device is None else device)
        self.num_data = num_data
        self.device = dev
        self.label = torch.as_tensor(
            np.asarray(metadata.label, np.float32), device=dev)
        self.weight = (torch.as_tensor(np.asarray(metadata.weight,
                                                  np.float32), device=dev)
                       if metadata.weight is not None else None)
        self.metadata = metadata

    def _w(self, g, h):
        if self.weight is not None:
            return g * self.weight, h * self.weight
        return g, h

    def get_gradients(self, score: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        raise NotImplementedError

    def boost_from_score(self, class_id: int = 0) -> float:
        return 0.0

    def convert_output(self, score: torch.Tensor) -> torch.Tensor:
        return score

    def _weighted_mean_label(self) -> float:
        lbl = np.asarray(self.metadata.label, np.float32).astype(np.float64)
        if self.weight is not None:
            w = np.asarray(self.metadata.weight,
                           np.float32).astype(np.float64)
            return float((lbl * w).sum() / w.sum())
        return float(lbl.mean())


class RegressionL2(ObjectiveFunction):
    """reference: RegressionL2loss (regression_objective.hpp:93)."""

    name = "regression"
    is_constant_hessian = True

    def init(self, metadata, num_data, device=None):
        super().init(metadata, num_data, device)
        if self.config.reg_sqrt:
            raise NotImplementedError(
                "reg_sqrt waits for ROADMAP queue A (objectives)")

    def get_gradients(self, score):
        return self._w(score - self.label, torch.ones_like(score))

    def boost_from_score(self, class_id=0):
        return self._weighted_mean_label()


class BinaryLogloss(ObjectiveFunction):
    """reference: BinaryLogloss (binary_objective.hpp:21)."""

    name = "binary"

    def init(self, metadata, num_data, device=None):
        super().init(metadata, num_data, device)
        lbl = np.asarray(metadata.label, np.float64)
        # reference: is_pos = label > 0 (binary_objective.hpp:35)
        self.label_sign = torch.as_tensor(
            np.where(lbl > 0, 1.0, -1.0).astype(np.float32),
            device=self.device)
        cnt_pos = float((lbl > 0).sum())
        cnt_neg = float(len(lbl) - cnt_pos)
        c = self.config
        if c.is_unbalance and cnt_pos > 0 and cnt_neg > 0:
            if cnt_pos > cnt_neg:
                self.label_weight_pos = 1.0
                self.label_weight_neg = cnt_pos / cnt_neg
            else:
                self.label_weight_pos = cnt_neg / cnt_pos
                self.label_weight_neg = 1.0
        else:
            self.label_weight_pos, self.label_weight_neg = \
                c.scale_pos_weight, 1.0
        self._pavg = None
        if cnt_pos + cnt_neg > 0:
            if self.weight is not None:
                w = np.asarray(metadata.weight, np.float32).astype(np.float64)
                self._pavg = float((w * (lbl > 0)).sum()) / w.sum()
            else:
                self._pavg = cnt_pos / (cnt_pos + cnt_neg)

    def get_gradients(self, score):
        sig = f32(self.config.sigmoid)
        lb = self.label_sign
        lw = torch.where(lb > 0, f32(self.label_weight_pos),
                         f32(self.label_weight_neg))
        response = (-lb * sig) / (1.0 + torch.exp((lb * sig) * score))
        abs_resp = response.abs()
        g = response * lw
        h = (abs_resp * (sig - abs_resp)) * lw
        return self._w(g, h)

    def boost_from_score(self, class_id=0):
        if not self.config.boost_from_average or self._pavg is None:
            return 0.0
        pavg = min(max(self._pavg, 1e-15), 1.0 - 1e-15)
        return math.log(pavg / (1.0 - pavg)) / self.config.sigmoid

    def convert_output(self, score):
        return 1.0 / (1.0 + torch.exp(-f32(self.config.sigmoid) * score))


_REGISTRY = {c.name: c for c in (RegressionL2, BinaryLogloss)}


def create_objective(config: Config) -> Optional[ObjectiveFunction]:
    """reference: ObjectiveFunction::CreateObjectiveFunction
    (objective_function.cpp:17-47), for the slice's two objectives."""
    name = config.objective
    if name in _REGISTRY:
        return _REGISTRY[name](config)
    if name in ("multiclass", "multiclassova"):
        raise NotImplementedError(
            f"objective {name!r} waits for ROADMAP queue A (multiclass)")
    raise NotImplementedError(
        f"objective {name!r} waits for ROADMAP queue A (objectives); the "
        "port trains 'regression' and 'binary'")
