"""Objective functions: gradients and hessians in torch (counterpart of
``lightgbm_tpu/objectives.py``; the ranking objectives are in
``objective_rank.py``).

reference: src/objective/ — ObjectiveFunction (objective_function.h:19)
and its factory (objective_function.cpp:17-47).  Gradients run on the
score tensor's device in f32, with the JAX package's operation order and
its constants: a Python float that meets an f32 array there is rounded
to f32 (``f32``), and a product of two Python floats is taken in f64
first, as Python evaluates it.  l2 and l1 are bit-equal to the JAX
package; whatever goes through ``exp`` may differ in the last bits
(ROADMAP queue C).  Multiclass scores and gradients are [K, n]
(class-major, as the reference's num_data * k + i).
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
        self.label = self._tensor(metadata.label)
        self.weight = (self._tensor(metadata.weight)
                       if metadata.weight is not None else None)
        self.metadata = metadata

    def _tensor(self, values) -> torch.Tensor:
        return torch.as_tensor(np.asarray(values, np.float32),
                               device=self.device)

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

    def _label64(self) -> np.ndarray:
        """The f32 label the gradients see (``reg_sqrt``'s root
        included), in f64."""
        return self.label.cpu().numpy().astype(np.float64)

    def _weight64(self) -> Optional[np.ndarray]:
        if self.weight is None:
            return None
        return self.weight.cpu().numpy().astype(np.float64)

    def _weighted_mean_label(self) -> float:
        lbl, w = self._label64(), self._weight64()
        if w is not None:
            return float((lbl * w).sum() / w.sum())
        return float(lbl.mean())


def _sigmoid(score: torch.Tensor) -> torch.Tensor:
    return 1.0 / (1.0 + torch.exp(-score))


# ---------------------------------------------------------------------------
# Regression family (reference: src/objective/regression_objective.hpp)
# ---------------------------------------------------------------------------

class RegressionL2(ObjectiveFunction):
    """reference: RegressionL2loss (regression_objective.hpp:93)."""

    name = "regression"
    is_constant_hessian = True

    def init(self, metadata, num_data, device=None):
        super().init(metadata, num_data, device)
        if self.config.reg_sqrt:
            lbl = np.asarray(metadata.label, np.float64)
            self.label = self._tensor(np.sign(lbl) * np.sqrt(np.abs(lbl)))

    def get_gradients(self, score):
        return self._w(score - self.label, torch.ones_like(score))

    def boost_from_score(self, class_id=0):
        return self._weighted_mean_label()

    def convert_output(self, score):
        if self.config.reg_sqrt:
            return torch.sign(score) * score * score
        return score


class RegressionL1(RegressionL2):
    """reference: RegressionL1loss (regression_objective.hpp:204)."""

    name = "regression_l1"
    renew_percentile = 0.5

    def get_gradients(self, score):
        return self._w(torch.sign(score - self.label),
                       torch.ones_like(score))

    def boost_from_score(self, class_id=0):
        return _percentile(self._label64(), self._weight64(), 0.5)


class RegressionHuber(RegressionL2):
    """reference: RegressionHuberLoss (regression_objective.hpp:290)."""

    name = "huber"
    renew_percentile = 0.5

    def get_gradients(self, score):
        diff = score - self.label
        a = f32(self.config.alpha)
        g = torch.where(diff.abs() <= a, diff, torch.sign(diff) * a)
        return self._w(g, torch.ones_like(score))


class RegressionFair(ObjectiveFunction):
    """reference: RegressionFairLoss (regression_objective.hpp:352)."""

    name = "fair"

    def get_gradients(self, score):
        c = self.config.fair_c
        x = score - self.label
        d = x.abs() + f32(c)
        g = f32(c) * x / d
        h = f32(c * c) / (d * d)
        return self._w(g, h)


class RegressionPoisson(ObjectiveFunction):
    """reference: RegressionPoissonLoss (regression_objective.hpp:399)."""

    name = "poisson"

    def get_gradients(self, score):
        g = torch.exp(score) - self.label
        h = torch.exp(score + f32(self.config.poisson_max_delta_step))
        return self._w(g, h)

    def boost_from_score(self, class_id=0):
        return math.log(max(self._weighted_mean_label(), 1e-20))

    def convert_output(self, score):
        return torch.exp(score)


class RegressionQuantile(ObjectiveFunction):
    """reference: RegressionQuantileloss (regression_objective.hpp:480)."""

    name = "quantile"
    is_constant_hessian = True

    @property
    def renew_percentile(self):
        return self.config.alpha

    def get_gradients(self, score):
        a = self.config.alpha
        g = torch.where(score > self.label,
                        torch.tensor(f32(1.0 - a), device=score.device),
                        torch.tensor(f32(-a), device=score.device))
        return self._w(g, torch.ones_like(score))

    def boost_from_score(self, class_id=0):
        return _percentile(self._label64(), self._weight64(),
                           self.config.alpha)


class RegressionMAPE(ObjectiveFunction):
    """reference: RegressionMAPELOSS (regression_objective.hpp:579)."""

    name = "mape"
    renew_percentile = 0.5

    def init(self, metadata, num_data, device=None):
        super().init(metadata, num_data, device)
        lw = 1.0 / np.maximum(1.0, np.abs(np.asarray(metadata.label,
                                                      np.float64)))
        self.label_weight = self._tensor(lw)

    def get_gradients(self, score):
        g = torch.sign(score - self.label) * self.label_weight
        if self.weight is None:
            return g, torch.ones_like(score)
        return g * self.weight, self.weight

    def boost_from_score(self, class_id=0):
        w = self.label_weight.cpu().numpy().astype(np.float64)
        if self.weight is not None:
            w = w * self._weight64()
        return _percentile(self._label64(), w, 0.5)


class RegressionGamma(RegressionPoisson):
    """reference: RegressionGammaLoss (regression_objective.hpp:674)."""

    name = "gamma"

    def get_gradients(self, score):
        e = torch.exp(-score)
        return self._w(1.0 - self.label * e, self.label * e)


class RegressionTweedie(RegressionPoisson):
    """reference: RegressionTweedieLoss (regression_objective.hpp:711)."""

    name = "tweedie"

    def get_gradients(self, score):
        rho = self.config.tweedie_variance_power
        e1 = torch.exp(f32(1.0 - rho) * score)
        e2 = torch.exp(f32(2.0 - rho) * score)
        g = -self.label * e1 + e2
        h = (-self.label * f32(1.0 - rho)) * e1 + f32(2.0 - rho) * e2
        return self._w(g, h)


# ---------------------------------------------------------------------------
# Binary (reference: src/objective/binary_objective.hpp:21)
# ---------------------------------------------------------------------------

class BinaryLogloss(ObjectiveFunction):
    """reference: BinaryLogloss (binary_objective.hpp:21)."""

    name = "binary"

    def init(self, metadata, num_data, device=None):
        super().init(metadata, num_data, device)
        lbl = np.asarray(metadata.label, np.float64)
        # reference: is_pos = label > 0 (binary_objective.hpp:35)
        self.label_sign = self._tensor(np.where(lbl > 0, 1.0, -1.0))
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
                w = self._weight64()
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


# ---------------------------------------------------------------------------
# Multiclass (reference: src/objective/multiclass_objective.hpp:24,180)
# ---------------------------------------------------------------------------

def softmax0(score: torch.Tensor) -> torch.Tensor:
    """Softmax over the class axis 0.  Against XLA's ``jax.nn.softmax``
    on the CPU, ``torch.softmax`` differs in fewer elements (0.8%, at
    most 3 ulps) than the explicit ``exp(x - max) / sum`` (8%, 4 ulps;
    ROADMAP queue C)."""
    return torch.softmax(score, dim=0)


class MulticlassSoftmax(ObjectiveFunction):
    """reference: MulticlassSoftmax (multiclass_objective.hpp:24)."""

    name = "multiclass"

    def __init__(self, config: Config):
        super().__init__(config)
        self.num_class = config.num_class
        self.num_model_per_iteration = config.num_class

    def init(self, metadata, num_data, device=None):
        super().init(metadata, num_data, device)
        lbl = np.asarray(metadata.label, np.int32)
        if lbl.min() < 0 or lbl.max() >= self.num_class:
            raise ValueError("multiclass labels must be in [0, num_class)")
        onehot = np.zeros((self.num_class, len(lbl)), np.float32)
        onehot[lbl, np.arange(len(lbl))] = 1.0
        self.label_onehot = self._tensor(onehot)
        w = (np.asarray(metadata.weight, np.float64)
             if metadata.weight is not None else np.ones(len(lbl)))
        probs = np.array([(w * (lbl == k)).sum()
                          for k in range(self.num_class)])
        self.class_init_probs = probs / w.sum()

    def get_gradients(self, score):
        p = softmax0(score)
        g = p - self.label_onehot
        # the reference's flat factor 2 (multiclass_objective.hpp:100)
        h = 2.0 * p * (1.0 - p)
        if self.weight is not None:
            g = g * self.weight[None, :]
            h = h * self.weight[None, :]
        return g, h

    def boost_from_score(self, class_id=0):
        if not self.config.boost_from_average:
            return 0.0
        return math.log(max(float(self.class_init_probs[class_id]), 1e-15))

    def convert_output(self, score):
        return softmax0(score)


class MulticlassOVA(ObjectiveFunction):
    """One-vs-all: K binary objectives (multiclass_objective.hpp:180)."""

    name = "multiclassova"

    def __init__(self, config: Config):
        super().__init__(config)
        self.num_class = config.num_class
        self.num_model_per_iteration = config.num_class

    def init(self, metadata, num_data, device=None):
        super().init(metadata, num_data, device)
        lbl = np.asarray(metadata.label, np.int32)
        self.binary_objs = []
        for k in range(self.num_class):
            sub = BinaryLogloss(self.config)
            sub.init(Metadata(label=(lbl == k).astype(np.float32),
                              weight=metadata.weight), num_data, device)
            self.binary_objs.append(sub)

    def get_gradients(self, score):
        gs, hs = zip(*(obj.get_gradients(score[k])
                       for k, obj in enumerate(self.binary_objs)))
        return torch.stack(gs), torch.stack(hs)

    def boost_from_score(self, class_id=0):
        return self.binary_objs[class_id].boost_from_score()

    def convert_output(self, score):
        return 1.0 / (1.0 + torch.exp(-f32(self.config.sigmoid) * score))


# ---------------------------------------------------------------------------
# Cross-entropy (reference: src/objective/xentropy_objective.hpp:44,148)
# ---------------------------------------------------------------------------

class CrossEntropy(ObjectiveFunction):
    """reference: CrossEntropy (xentropy_objective.hpp:44)."""

    name = "cross_entropy"

    def init(self, metadata, num_data, device=None):
        super().init(metadata, num_data, device)
        lbl = np.asarray(metadata.label, np.float64)
        if lbl.min() < 0 or lbl.max() > 1:
            raise ValueError("cross_entropy labels must be in [0, 1]")

    def get_gradients(self, score):
        z = _sigmoid(score)
        return self._w(z - self.label, z * (1.0 - z))

    def boost_from_score(self, class_id=0):
        pavg = min(max(self._weighted_mean_label(), 1e-15), 1 - 1e-15)
        return math.log(pavg / (1.0 - pavg))

    def convert_output(self, score):
        return _sigmoid(score)


class CrossEntropyLambda(ObjectiveFunction):
    """reference: CrossEntropyLambda (xentropy_objective.hpp:148)."""

    name = "cross_entropy_lambda"

    def get_gradients(self, score):
        # reference: xentropy_objective.hpp:185-212 (the unweighted branch
        # is plain sigmoid cross-entropy)
        if self.weight is None:
            z = _sigmoid(score)
            return z - self.label, z * (1.0 - z)
        w, y = self.weight, self.label
        epf = torch.exp(score)
        hhat = torch.log1p(epf)
        z = torch.clamp_min(1.0 - torch.exp(-w * hhat), f32(1e-15))
        enf = 1.0 / epf
        g = (1.0 - y / z) * w / (1.0 + enf)
        c = 1.0 / (1.0 - z)
        a = w * epf / ((1.0 + epf) * (1.0 + epf))
        d = c - 1.0
        b = (c / (d * d)) * (1.0 + w * epf - c)
        return g, a * (1.0 + y * b)

    def boost_from_score(self, class_id=0):
        havg = self._weighted_mean_label()
        return math.log(max(math.expm1(max(havg, 1e-15)), 1e-15))

    def convert_output(self, score):
        return torch.log1p(torch.exp(score))


def _percentile(values: np.ndarray, weights: Optional[np.ndarray],
                alpha: float) -> float:
    """Weighted percentile (reference: Common::*Percentile,
    regression_objective.hpp:23-82), on the host in f64."""
    if len(values) == 0:
        return 0.0
    order = np.argsort(values, kind="stable")
    v = values[order]
    if weights is None:
        pos = alpha * (len(v) - 1)
        lo = int(math.floor(pos))
        hi = min(lo + 1, len(v) - 1)
        frac = pos - lo
        return float(v[lo] * (1 - frac) + v[hi] * frac)
    w = weights[order]
    p = (np.cumsum(w) - w / 2.0) / w.sum()
    idx = np.searchsorted(p, alpha)
    if idx <= 0:
        return float(v[0])
    if idx >= len(v):
        return float(v[-1])
    p0, p1 = p[idx - 1], p[idx]
    frac = 0.0 if p1 == p0 else (alpha - p0) / (p1 - p0)
    return float(v[idx - 1] * (1 - frac) + v[idx] * frac)


_REGISTRY = {c.name: c for c in (
    RegressionL2, RegressionL1, RegressionHuber, RegressionFair,
    RegressionPoisson, RegressionQuantile, RegressionMAPE, RegressionGamma,
    RegressionTweedie, BinaryLogloss, MulticlassSoftmax, MulticlassOVA,
    CrossEntropy, CrossEntropyLambda)}


def create_objective(config: Config) -> Optional[ObjectiveFunction]:
    """reference: ObjectiveFunction::CreateObjectiveFunction
    (objective_function.cpp:17-47); ``None`` for ``objective="none"``
    (gradients come from a custom ``fobj``)."""
    name = config.objective
    if name == "none":
        return None
    if name in ("lambdarank", "rank_xendcg"):
        from .objective_rank import LambdarankNDCG, RankXENDCG
        return (LambdarankNDCG(config) if name == "lambdarank"
                else RankXENDCG(config))
    if name not in _REGISTRY:
        raise ValueError(f"unknown objective {name!r}")
    return _REGISTRY[name](config)
