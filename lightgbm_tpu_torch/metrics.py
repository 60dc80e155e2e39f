"""Evaluation metrics on the host (counterpart of ``lightgbm_tpu/metrics.py``).

reference: src/metric/ — Metric (metric.h:24), factory (metric.cpp:17-56),
regression_metric.hpp, binary_metric.hpp, multiclass_metric.hpp,
rank_metric.hpp, map_metric.hpp, xentropy_metric.hpp,
dcg_calculator.cpp.  Scores come to the host once per evaluation; the
objective's output transform runs in f32 in torch, as the JAX package
runs it in f32, and every metric in f64 NumPy, the JAX package's
formulas line for line.  Each metric returns (name, value,
higher_better); multiclass metrics take [K, n] scores.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .config import Config
from .dataset import Metadata
from .utils.log import log_warning


def _converted(objective, score) -> np.ndarray:
    """``objective.convert_output`` of the f32 scores, in f64."""
    out = objective.convert_output(torch.as_tensor(
        np.asarray(score, np.float32)))
    return out.cpu().numpy().astype(np.float64)


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

    def eval(self, score: np.ndarray, objective) -> List[Tuple[str, float, bool]]:
        raise NotImplementedError

    def names(self) -> List[str]:
        """Names this metric will emit from :meth:`eval`, derivable without
        an evaluation pass (reference: Metric::GetName, metric.h:40)."""
        return [self.name]

    def _avg(self, pointwise: np.ndarray) -> float:
        if self.weight is not None:
            return float((pointwise * self.weight).sum() / self.sum_weight)
        return float(pointwise.mean()) if len(pointwise) else 0.0


class _PointwiseRegressionMetric(Metric):
    """reference: RegressionMetric template (regression_metric.hpp:18)."""

    convert = True  # apply objective's ConvertOutput (AverageIfNonEmpty style)

    def point_loss(self, score: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    def transform(self, v: float) -> float:
        return v

    def eval(self, score, objective):
        if self.convert and objective is not None:
            score = _converted(objective, score)
        else:
            # custom objective (objective None): raw scores stand in for
            # outputs (reference metric Eval with objective==nullptr)
            score = np.asarray(score, np.float64)
        return [(self.name, self.transform(self._avg(self.point_loss(score))), self.higher_better)]


class L2Metric(_PointwiseRegressionMetric):
    name = "l2"

    def point_loss(self, s):
        return (s - self.label) ** 2


class RMSEMetric(L2Metric):
    name = "rmse"

    def transform(self, v):
        return math.sqrt(v)


class L1Metric(_PointwiseRegressionMetric):
    name = "l1"

    def point_loss(self, s):
        return np.abs(s - self.label)


class QuantileMetric(_PointwiseRegressionMetric):
    name = "quantile"

    def point_loss(self, s):
        a = self.config.alpha
        d = self.label - s
        return np.where(d >= 0, a * d, (a - 1) * d)


class HuberMetric(_PointwiseRegressionMetric):
    name = "huber"

    def point_loss(self, s):
        a = self.config.alpha
        d = np.abs(s - self.label)
        return np.where(d <= a, 0.5 * d * d, a * (d - 0.5 * a))


class FairMetric(_PointwiseRegressionMetric):
    name = "fair"

    def point_loss(self, s):
        c = self.config.fair_c
        x = np.abs(s - self.label)
        return c * x - c * c * np.log1p(x / c)


class PoissonMetric(_PointwiseRegressionMetric):
    name = "poisson"

    def point_loss(self, s):
        eps = 1e-10
        s = np.maximum(s, eps)
        return s - self.label * np.log(s)


class MAPEMetric(_PointwiseRegressionMetric):
    name = "mape"

    def point_loss(self, s):
        return np.abs((self.label - s)) / np.maximum(1.0, np.abs(self.label))


class GammaMetric(_PointwiseRegressionMetric):
    name = "gamma"

    def point_loss(self, s):
        # negative gamma log-likelihood with shape=1 (reference: GammaMetric)
        eps = 1e-10
        s = np.maximum(s, eps)
        return self.label / s + np.log(s)


class GammaDevianceMetric(_PointwiseRegressionMetric):
    name = "gamma_deviance"

    def point_loss(self, s):
        eps = 1e-10
        r = self.label / np.maximum(s, eps)
        return 2.0 * (np.log(np.maximum(1.0 / np.maximum(r, eps), eps)) + r - 1.0)


class TweedieMetric(_PointwiseRegressionMetric):
    name = "tweedie"

    def point_loss(self, s):
        rho = self.config.tweedie_variance_power
        eps = 1e-10
        s = np.maximum(s, eps)
        a = self.label * np.power(s, 1.0 - rho) / (1.0 - rho)
        b = np.power(s, 2.0 - rho) / (2.0 - rho)
        return -a + b


class BinaryLoglossMetric(_PointwiseRegressionMetric):
    """reference: binary_metric.hpp:115 (prob via objective ConvertOutput)."""

    name = "binary_logloss"

    def point_loss(self, p):
        eps = 1e-15
        p = np.clip(p, eps, 1 - eps)
        return -(self.label * np.log(p) + (1 - self.label) * np.log(1 - p))


class BinaryErrorMetric(_PointwiseRegressionMetric):
    name = "binary_error"

    def point_loss(self, p):
        pred = (p > 0.5).astype(np.float64)
        return (pred != self.label).astype(np.float64)


class AUCMetric(Metric):
    """reference: binary_metric.hpp:159 (rank-based with weights)."""

    name = "auc"
    higher_better = True

    def eval(self, score, objective):
        score = np.asarray(score, np.float64).reshape(-1)
        w = self.weight if self.weight is not None else np.ones_like(score)
        order = np.argsort(-score, kind="mergesort")
        s, lbl, ww = score[order], self.label[order], w[order]
        # group tied scores
        pos_w = ww * (lbl > 0)
        neg_w = ww * (lbl <= 0)
        # unique score groups
        boundaries = np.nonzero(np.diff(s))[0] + 1
        pos_g = np.add.reduceat(pos_w, np.r_[0, boundaries]) if len(s) else np.array([])
        neg_g = np.add.reduceat(neg_w, np.r_[0, boundaries]) if len(s) else np.array([])
        cum_neg = np.cumsum(neg_g) - neg_g
        auc_sum = float((pos_g * (cum_neg + neg_g * 0.5)).sum())
        tot_pos, tot_neg = float(pos_w.sum()), float(neg_w.sum())
        if tot_pos == 0 or tot_neg == 0:
            return [(self.name, 1.0, True)]
        auc = 1.0 - auc_sum / (tot_pos * tot_neg)
        return [(self.name, auc, True)]


class MultiLoglossMetric(Metric):
    """reference: multiclass_metric.hpp (softmax probabilities)."""

    name = "multi_logloss"

    def eval(self, score, objective):
        p = (_converted(objective, score) if objective is not None
             else np.asarray(score, np.float64))  # [K, n]
        eps = 1e-15
        idx = self.label.astype(np.int64)
        pt = np.clip(p[idx, np.arange(p.shape[1])], eps, 1.0)
        return [(self.name, self._avg(-np.log(pt)), False)]


class MultiErrorMetric(Metric):
    name = "multi_error"

    def eval(self, score, objective):
        p = np.asarray(score, np.float64)  # [K, n]
        k = self.config.multi_error_top_k
        idx = self.label.astype(np.int64)
        true_score = p[idx, np.arange(p.shape[1])]
        # reference (multiclass_metric.hpp MultiErrorMetric): a row is
        # CORRECT iff #(scores >= true score, ties included) <= top_k,
        # and the emitted name is multi_error@k for k > 1
        num_larger = (p >= true_score[None, :]).sum(axis=0)
        err = (num_larger > k).astype(np.float64)
        name = self.name if k <= 1 else f"{self.name}@{k}"
        return [(name, self._avg(err), False)]

    def names(self):
        k = self.config.multi_error_top_k
        return [self.name if k <= 1 else f"{self.name}@{k}"]


class AucMuMetric(Metric):
    """reference: multiclass_metric.hpp auc_mu (average pairwise class AUC)."""

    name = "auc_mu"
    higher_better = True

    def eval(self, score, objective):
        p = np.asarray(score, np.float64)  # [K, n]
        K = p.shape[0]
        lbl = self.label.astype(np.int64)
        w = self.weight if self.weight is not None else np.ones(p.shape[1])
        total = 0.0
        cnt = 0
        for a in range(K):
            for b in range(a + 1, K):
                mask = (lbl == a) | (lbl == b)
                if mask.sum() == 0:
                    continue
                s = p[a, mask] - p[b, mask]
                y = (lbl[mask] == a).astype(np.float64)
                ww = w[mask]
                total += _weighted_auc(s, y, ww)
                cnt += 1
        return [(self.name, total / max(cnt, 1), True)]


def _weighted_auc(score, label, weight):
    order = np.argsort(-score, kind="mergesort")
    s, lbl, ww = score[order], label[order], weight[order]
    pos_w = ww * (lbl > 0)
    neg_w = ww * (lbl <= 0)
    boundaries = np.nonzero(np.diff(s))[0] + 1
    pos_g = np.add.reduceat(pos_w, np.r_[0, boundaries])
    neg_g = np.add.reduceat(neg_w, np.r_[0, boundaries])
    cum_neg = np.cumsum(neg_g) - neg_g
    auc_sum = float((pos_g * (cum_neg + neg_g * 0.5)).sum())
    tot_pos, tot_neg = float(pos_w.sum()), float(neg_w.sum())
    if tot_pos == 0 or tot_neg == 0:
        return 1.0
    return 1.0 - auc_sum / (tot_pos * tot_neg)


class DCGCalculator:
    """reference: include/LightGBM/metric.h:63-137, src/metric/dcg_calculator.cpp."""

    def __init__(self, label_gain: Optional[Sequence[float]] = None):
        if not label_gain:
            label_gain = [(1 << i) - 1 for i in range(31)]
        self.label_gain = np.asarray(label_gain, np.float64)

    def dcg_at_k(self, k: int, label: np.ndarray, score: np.ndarray) -> float:
        order = np.argsort(-score, kind="mergesort")
        top = label[order[:k]].astype(np.int64)
        discounts = 1.0 / np.log2(np.arange(len(top)) + 2.0)
        return float((self.label_gain[top] * discounts).sum())

    def max_dcg_at_k(self, k: int, label: np.ndarray) -> float:
        top = np.sort(label.astype(np.int64))[::-1][:k]
        discounts = 1.0 / np.log2(np.arange(len(top)) + 2.0)
        return float((self.label_gain[top] * discounts).sum())


class NDCGMetric(Metric):
    """reference: rank_metric.hpp:19 NDCGMetric."""

    name = "ndcg"
    higher_better = True

    def init(self, metadata, num_data):
        super().init(metadata, num_data)
        if metadata.query_boundaries is None:
            raise ValueError("ndcg metric requires query information")
        self.qb = np.asarray(metadata.query_boundaries)
        self.calc = DCGCalculator(self.config.label_gain)
        self.eval_at = list(self.config.eval_at)

    def eval(self, score, objective):
        score = np.asarray(score, np.float64).reshape(-1)
        results = []
        nq = len(self.qb) - 1
        # per-query weights (reference: query_weights)
        for k in self.eval_at:
            vals = np.empty(nq)
            for q in range(nq):
                lo, hi = self.qb[q], self.qb[q + 1]
                lbl = self.label[lo:hi]
                maxdcg = self.calc.max_dcg_at_k(k, lbl)
                if maxdcg <= 0:
                    vals[q] = 1.0
                else:
                    vals[q] = self.calc.dcg_at_k(k, lbl, score[lo:hi]) / maxdcg
            results.append((f"ndcg@{k}", float(vals.mean()), True))
        return results

    def names(self):
        # the same eval_at snapshot eval() iterates (taken at init), so
        # GetEvalNames/GetEvalCounts always agree with the emitted values
        ks = getattr(self, "eval_at", self.config.eval_at)
        return [f"ndcg@{k}" for k in ks]


class MapMetric(Metric):
    """reference: map_metric.hpp MAP@k."""

    name = "map"
    higher_better = True

    def init(self, metadata, num_data):
        super().init(metadata, num_data)
        if metadata.query_boundaries is None:
            raise ValueError("map metric requires query information")
        self.qb = np.asarray(metadata.query_boundaries)
        self.eval_at = list(self.config.eval_at)

    def eval(self, score, objective):
        score = np.asarray(score, np.float64).reshape(-1)
        results = []
        nq = len(self.qb) - 1
        for k in self.eval_at:
            vals = np.empty(nq)
            for q in range(nq):
                lo, hi = self.qb[q], self.qb[q + 1]
                lbl = (self.label[lo:hi] > 0).astype(np.float64)
                order = np.argsort(-score[lo:hi], kind="mergesort")
                rel = lbl[order[:k]]
                hits = np.cumsum(rel)
                prec = hits / (np.arange(len(rel)) + 1.0)
                npos = min(int(lbl.sum()), k)
                vals[q] = float((prec * rel).sum() / npos) if npos > 0 else 1.0
            results.append((f"map@{k}", float(vals.mean()), True))
        return results

    def names(self):
        ks = getattr(self, "eval_at", self.config.eval_at)
        return [f"map@{k}" for k in ks]


class CrossEntropyMetric(_PointwiseRegressionMetric):
    """reference: xentropy_metric.hpp (labels in [0,1], prob input)."""

    name = "cross_entropy"

    def point_loss(self, p):
        eps = 1e-15
        p = np.clip(p, eps, 1 - eps)
        y = self.label
        return -(y * np.log(p) + (1 - y) * np.log(1 - p))


class CrossEntropyLambdaMetric(Metric):
    name = "cross_entropy_lambda"

    def eval(self, score, objective):
        score = np.asarray(score, np.float64).reshape(-1)
        hhat = np.log1p(np.exp(score))
        y = self.label
        w = self.weight if self.weight is not None else np.ones_like(y)
        loss = -y * np.log(np.maximum(1.0 - np.exp(-w * hhat), 1e-15)) + (1.0 - y) * w * hhat
        return [(self.name, float(loss.mean()), False)]


class KLDivMetric(_PointwiseRegressionMetric):
    name = "kullback_leibler"

    def point_loss(self, p):
        eps = 1e-15
        p = np.clip(p, eps, 1 - eps)
        y = np.clip(self.label, eps, 1 - eps)
        return (y * np.log(y / p) + (1 - y) * np.log((1 - y) / (1 - p)))


_REGISTRY = {c.name: c for c in (
    L2Metric, RMSEMetric, L1Metric, QuantileMetric, HuberMetric, FairMetric,
    PoissonMetric, MAPEMetric, GammaMetric, GammaDevianceMetric, TweedieMetric,
    BinaryLoglossMetric, BinaryErrorMetric, AUCMetric, MultiLoglossMetric,
    MultiErrorMetric, AucMuMetric, NDCGMetric, MapMetric, CrossEntropyMetric,
    CrossEntropyLambdaMetric, KLDivMetric,
)}


def create_metric(name: str, config: Config) -> Optional[Metric]:
    """reference: Metric::CreateMetric (src/metric/metric.cpp:17)."""
    from .config import _METRIC_ALIASES
    name = _METRIC_ALIASES.get(name, name)
    # reference: "na"/"null"/"custom" disable built-in metrics (metric.cpp:17)
    if name.lower() in ("none", "na", "null", "custom"):
        return None
    if name not in _REGISTRY:
        # reference: Metric::CreateMetric returns nullptr for unknown
        # names and training proceeds without it (src/metric/metric.cpp)
        log_warning(f"Unknown metric {name!r} (ignored)")
        return None
    return _REGISTRY[name](config)
