"""Evaluation metrics on the host (counterpart of ``lightgbm_tpu/metrics.py``
for ``l2``, ``binary_logloss`` and ``auc``).

reference: src/metric/ — Metric (metric.h:24), factory (metric.cpp:17-56),
regression_metric.hpp, binary_metric.hpp.  Scores come to the host once
per evaluation; the objective's output transform runs in f32 in torch,
as the JAX package runs it in f32, and the metric in f64 NumPy.  Every
other metric raises ``NotImplementedError``.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from .config import Config
from .dataset import Metadata


class Metric:
    name = "none"
    higher_better = False

    def __init__(self, config: Config):
        self.config = config

    def init(self, metadata: Metadata, num_data: int) -> None:
        self.metadata = metadata
        self.label = np.asarray(metadata.label, np.float64)
        self.weight = (np.asarray(metadata.weight, np.float64)
                       if metadata.weight is not None else None)
        self.sum_weight = (float(self.weight.sum()) if self.weight is not None
                           else float(num_data))
        self.num_data = num_data

    def eval(self, score: np.ndarray,
             objective) -> List[Tuple[str, float, bool]]:
        raise NotImplementedError

    def _avg(self, pointwise: np.ndarray) -> float:
        if self.weight is not None:
            return float((pointwise * self.weight).sum() / self.sum_weight)
        return float(pointwise.mean()) if len(pointwise) else 0.0


class _PointwiseMetric(Metric):
    """reference: RegressionMetric template (regression_metric.hpp:18)."""

    def point_loss(self, score: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    def eval(self, score, objective):
        if objective is not None:
            out = objective.convert_output(torch.as_tensor(
                np.asarray(score, np.float32)))
            score = out.cpu().numpy().astype(np.float64)
        else:
            score = np.asarray(score, np.float64)
        return [(self.name, self._avg(self.point_loss(score)),
                 self.higher_better)]


class L2Metric(_PointwiseMetric):
    name = "l2"

    def point_loss(self, s):
        return (s - self.label) ** 2


class BinaryLoglossMetric(_PointwiseMetric):
    """reference: binary_metric.hpp:115."""

    name = "binary_logloss"

    def point_loss(self, p):
        eps = 1e-15
        p = np.clip(p, eps, 1 - eps)
        return -(self.label * np.log(p) + (1 - self.label) * np.log(1 - p))


class AUCMetric(Metric):
    """reference: binary_metric.hpp:159 (rank-based with weights)."""

    name = "auc"
    higher_better = True

    def eval(self, score, objective):
        score = np.asarray(score, np.float64).reshape(-1)
        w = self.weight if self.weight is not None else np.ones_like(score)
        order = np.argsort(-score, kind="mergesort")
        s, lbl, ww = score[order], self.label[order], w[order]
        pos_w = ww * (lbl > 0)
        neg_w = ww * (lbl <= 0)
        boundaries = np.nonzero(np.diff(s))[0] + 1
        if not len(s):
            return [(self.name, 1.0, True)]
        pos_g = np.add.reduceat(pos_w, np.r_[0, boundaries])
        neg_g = np.add.reduceat(neg_w, np.r_[0, boundaries])
        cum_neg = np.cumsum(neg_g) - neg_g
        auc_sum = float((pos_g * (cum_neg + neg_g * 0.5)).sum())
        tot_pos, tot_neg = float(pos_w.sum()), float(neg_w.sum())
        if tot_pos == 0 or tot_neg == 0:
            return [(self.name, 1.0, True)]
        return [(self.name, 1.0 - auc_sum / (tot_pos * tot_neg), True)]


_REGISTRY = {c.name: c for c in (L2Metric, BinaryLoglossMetric, AUCMetric)}


def create_metric(name: str, config: Config) -> Optional[Metric]:
    """reference: Metric::CreateMetric (metric.cpp:17), for the slice's
    three metrics; "none"/"na"/"null"/"custom" disable metrics."""
    from .config import _METRIC_ALIASES
    name = _METRIC_ALIASES.get(name, name)
    if name.lower() in ("none", "na", "null", "custom"):
        return None
    if name not in _REGISTRY:
        raise NotImplementedError(
            f"metric {name!r} waits for ROADMAP queue A (metrics); the port "
            "evaluates l2, binary_logloss and auc")
    return _REGISTRY[name](config)
