"""``quantile`` (alpha 0.3; the percentile renewal at alpha) trained by
``lt.train`` on the CPU against ``lightgbm_tpu.train``, with row
weights: tree structure equal, renewed leaf values, predictions and the
quantile metric to rtol 1e-4, predictions carried both ways.  The
boost-from-score is the weighted 0.3-percentile of the labels (host
f64, equal).
"""

import numpy as np
import pytest
import torch

import lightgbm_tpu as lgb

import lightgbm_tpu_torch as lt

from test_torch_objectives import (BASE, assert_predictions_carry,
                                   assert_same_trees, table)
from lightgbm_tpu_torch.testing import one_thread  # noqa: F401

ROUNDS = 4
PARAMS = dict(BASE, objective="quantile", alpha=0.3, metric=["quantile"])


@pytest.fixture(scope="module")
def trained():
    torch.exp(torch.randn(1 << 20))      # ROADMAP queue C (CPU exp)
    X, y = table(19, 2000, "regression")
    Xv, yv = table(20, 500, "regression")
    w = np.random.RandomState(21).randint(1, 4, len(y)).astype(np.float32)
    ev_j, ev_t = {}, {}
    dj = lgb.Dataset(X, label=y, weight=w)
    bj = lgb.train(dict(PARAMS), dj, ROUNDS,
                   valid_sets=[lgb.Dataset(Xv, label=yv, reference=dj)],
                   evals_result=ev_j, verbose_eval=False)
    dt = lt.Dataset(X, label=y, weight=w, device="cpu")
    bt = lt.train(dict(PARAMS), dt, ROUNDS,
                  valid_sets=[dt.create_valid(Xv, label=yv)],
                  evals_result=ev_t, verbose_eval=False)
    return bj, bt, ev_j, ev_t, Xv


def test_trees_match(trained):
    bj, bt = trained[0], trained[1]
    assert bt.boosting.init_scores == bj.boosting.init_scores
    assert_same_trees(bj, bt, ROUNDS)


def test_metric_matches(trained):
    np.testing.assert_allclose(trained[3]["valid_0"]["quantile"],
                               trained[2]["valid_0"]["quantile"], rtol=1e-4)


def test_predictions_carry_across(trained):
    assert_predictions_carry(trained[0], trained[1], trained[4])
