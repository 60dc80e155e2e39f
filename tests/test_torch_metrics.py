"""Every metric name of the JAX package's factory evaluates in the port
to the JAX package's value.

Both packages evaluate metrics in f64 NumPy on the host, so on the same
scores (no objective: the scores are the outputs) every value agrees to
1e-12 relative.  Through an objective's ``convert_output`` (f32, torch
against XLA; within 4 ulps, tests/test_torch_objectives.py) the values
agree to 1e-6.
"""

import numpy as np
import pytest

import lightgbm_tpu as lgb
from lightgbm_tpu.config import Config as JConfig
from lightgbm_tpu.dataset import Metadata as JMeta
from lightgbm_tpu.metrics import _REGISTRY as J_REGISTRY
from lightgbm_tpu.metrics import create_metric as jmetric

import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch.config import Config as TConfig
from lightgbm_tpu_torch.dataset import Metadata as TMeta
from lightgbm_tpu_torch.metrics import create_metric as tmetric

from test_torch_objectives import objective_pair
from lightgbm_tpu_torch.testing import one_thread  # noqa: F401

N = 3000
K = 4
# metric -> (params, label kind, score kind, objective for the converted
# case or None)
METRICS = {
    "l2": ({}, "real", "real", "regression"),
    "rmse": ({}, "real", "real", "regression"),
    "l1": ({}, "real", "real", "regression_l1"),
    "quantile": ({"alpha": 0.3}, "real", "real", "quantile"),
    "huber": ({"alpha": 0.8}, "real", "real", "huber"),
    "fair": ({"fair_c": 0.7}, "real", "real", "fair"),
    "poisson": ({}, "positive", "positive", "poisson"),
    "mape": ({}, "real", "real", "mape"),
    "gamma": ({}, "positive", "positive", "gamma"),
    "gamma_deviance": ({}, "positive", "positive", "gamma"),
    "tweedie": ({"tweedie_variance_power": 1.3}, "positive", "positive",
                "tweedie"),
    "binary_logloss": ({}, "binary", "unit", "binary"),
    "binary_error": ({}, "binary", "unit", "binary"),
    "auc": ({}, "binary", "real", None),
    "multi_logloss": ({"num_class": K}, "class", "probs", "multiclass"),
    "multi_error": ({"num_class": K}, "class", "class_scores", None),
    "multi_error@2": ({"num_class": K, "multi_error_top_k": 2}, "class",
                      "class_scores", None),
    "auc_mu": ({"num_class": K}, "class", "class_scores", None),
    "ndcg": ({"eval_at": [1, 3, 5, 10]}, "grade", "real", None),
    "ndcg_gain": ({"eval_at": [2, 4], "label_gain": [0, 1, 3, 7, 20]},
                  "grade", "real", None),
    "map": ({"eval_at": [1, 3, 5]}, "grade", "real", None),
    "cross_entropy": ({}, "unit", "unit", "cross_entropy"),
    "cross_entropy_lambda": ({}, "unit", "real", None),
    "kullback_leibler": ({}, "unit", "unit", "cross_entropy"),
}
NAME = {"multi_error@2": "multi_error", "ndcg_gain": "ndcg"}


def _data(case, weighted, seed=0):
    params, lkind, skind, _ = METRICS[case]
    rng = np.random.RandomState(seed)
    y = {"real": lambda: rng.randn(N) * 3,
         "positive": lambda: rng.gamma(2.0, 1.5, N),
         "binary": lambda: (rng.rand(N) < 0.4) * 1.0,
         "unit": lambda: rng.rand(N),
         "class": lambda: rng.randint(0, K, N) * 1.0,
         "grade": lambda: rng.randint(0, 5, N) * 1.0}[lkind]()
    s = {"real": lambda: rng.randn(N) * 2,
         "positive": lambda: rng.gamma(2.0, 1.5, N) + 0.01,
         "unit": lambda: rng.rand(N) * 0.98 + 0.01,
         "probs": lambda: rng.dirichlet(np.ones(K), N).T,
         "class_scores": lambda: np.round(rng.randn(K, N), 1)}[skind]()
    w = (rng.rand(N) + 0.5).astype(np.float32) if weighted else None
    group = None
    if lkind == "grade":
        group = np.full(N // 30, 30)
        group[:10] = 25
        group[-1] += N - group.sum()
    return (params, y.astype(np.float32), s.astype(np.float32), w, group)


def _pair(case, y, w, group, params):
    name = NAME.get(case, case)
    if "num_class" in params:
        params = {"objective": "multiclass", **params}
    jm, tm = JMeta(label=y, weight=w), TMeta(label=y, weight=w)
    if group is not None:
        jm.set_group(group)
        tm.set_group(group)
    j = jmetric(name, JConfig.from_params(dict(params)))
    t = tmetric(name, TConfig.from_params(dict(params)))
    j.init(jm, len(y))
    t.init(tm, len(y))
    return j, t


def test_every_factory_name_is_covered():
    assert set(J_REGISTRY) == {NAME.get(c, c) for c in METRICS}


@pytest.mark.parametrize("weighted", [False, True], ids=["plain",
                                                          "weighted"])
@pytest.mark.parametrize("case", list(METRICS))
def test_metric_values_match(case, weighted):
    params, y, s, w, group = _data(case, weighted)
    j, t = _pair(case, y, w, group, params)
    jv, tv = j.eval(s, None), t.eval(s, None)
    assert [(n, h) for n, _, h in jv] == [(n, h) for n, _, h in tv]
    np.testing.assert_allclose([v for _, v, _ in tv], [v for _, v, _ in jv],
                               rtol=1e-12)
    assert t.names() == j.names()


@pytest.mark.parametrize("case", [c for c, v in METRICS.items() if v[3]])
def test_metric_values_through_the_objective(case):
    params, y, s, w, group = _data(case, True, seed=1)
    obj_params = {"objective": METRICS[case][3], **params}
    raw = np.log(s) if METRICS[case][2] in ("positive", "probs") else s
    if METRICS[case][2] == "unit":
        raw = np.log(s / (1.0 - s))
    raw = raw.astype(np.float32)
    jo, to = objective_pair(obj_params, y, w)
    j, t = _pair(case, y, w, group, params)
    jv, tv = j.eval(raw, jo), t.eval(raw, to)
    np.testing.assert_allclose([v for _, v, _ in tv], [v for _, v, _ in jv],
                               rtol=1e-6)


def test_unknown_and_disabled_metrics():
    cfg = TConfig.from_params({})
    for name in ("none", "na", "null", "custom"):
        assert tmetric(name, cfg) is None
    assert tmetric("no_such_metric", cfg) is None


@pytest.mark.parametrize("params,match", [
    ({"objective": "binary", "metric": "multi_logloss"}, "Number of classes"),
    ({"objective": "multiclass", "num_class": 3, "metric": "binary_error"},
     "don't match"),
])
def test_metric_objective_conflicts_raise(params, match):
    """The JAX package's metric/objective checks, the same errors."""
    X = np.random.RandomState(0).randn(60, 3).astype(np.float32)
    y = np.arange(60, dtype=np.float32) % 2
    with pytest.raises(lgb.basic.LightGBMError, match=match):
        lgb.Booster(dict(params, verbose=-1), train_set=lgb.Dataset(X, label=y))
    with pytest.raises(lt.LightGBMError, match=match):
        lt.Booster(dict(params, verbose=-1),
                   train_set=lt.Dataset(X, label=y, device="cpu"))
