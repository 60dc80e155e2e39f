"""Random forest mode in the port held against ``lightgbm_tpu``:
bagging required (``bagging_freq=1``, ``bagging_fraction=0.632``),
gradients once from the constant boost-from-average score, every tree
carrying the init score as a bias, train and valid scores the running
mean of the trees, ``average_output`` in the model text.

Bars: tree structure equal, leaf values, scores and metrics to rtol
1e-4; predictions (averaged) carried both ways, through the text and
``stacked_forest_from_numpy``.  Without bagging, or with a custom
objective, RF refuses as the JAX package does.
"""

import numpy as np
import pytest
import torch

import lightgbm_tpu_torch as lt

from test_torch_objectives import (BASE, assert_predictions_carry,
                                   assert_same_metrics, assert_same_trees,
                                   table, train_both)
from lightgbm_tpu_torch.testing import one_thread  # noqa: F401

ROUNDS = 4
PARAMS = dict(BASE, objective="binary", boosting="rf", bagging_freq=1,
              bagging_fraction=0.632, feature_fraction=0.8,
              metric=["binary_logloss", "auc"])


@pytest.fixture(scope="module")
def trained():
    torch.exp(torch.randn(1 << 20))      # ROADMAP queue C (CPU exp)
    X, y = table(14, 2000, "binary")
    Xv, yv = table(15, 500, "binary")
    return (*train_both(PARAMS, X, y, Xv, yv, ROUNDS), Xv)


def test_trees_match(trained):
    bj, bt = trained[0], trained[1]
    text = bt.model_to_string()
    assert "\naverage_output\n" in text
    assert_same_trees(bj, bt, ROUNDS)


def test_scores_and_metrics_match(trained):
    bj, bt = trained[0], trained[1]
    np.testing.assert_allclose(bt.boosting.train_score.numpy(),
                               np.asarray(bj.boosting.train_score),
                               rtol=1e-4, atol=1e-6)
    assert_same_metrics(trained[2], trained[3])


def test_predictions_carry_across(trained):
    bj, bt, Xv = trained[0], trained[1], trained[4]
    assert_predictions_carry(bj, bt, Xv)
    p = bt.predict(Xv)
    assert np.isfinite(p).all() and 0 <= p.min() and p.max() <= 1


def test_rf_refuses_without_bagging_or_with_fobj():
    X, y = table(16, 300, "binary")
    with pytest.raises(ValueError, match="bagging"):
        lt.train({**BASE, "objective": "binary", "boosting": "rf"},
                 lt.Dataset(X, label=y, device="cpu"), 1)
    with pytest.raises(ValueError, match="custom objective"):
        lt.train(dict(PARAMS), lt.Dataset(X, label=y, device="cpu"), 1,
                 fobj=lambda s, d: (s, np.ones_like(s)))
