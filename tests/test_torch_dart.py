"""DART in the port held against ``lightgbm_tpu``.

- The drops: the iterations each call drops and the new tree's
  shrinkage come from ``RandomState(drop_seed)`` in the JAX package's
  order, equal call for call (replayed against the JAX ``DART``'s own
  ``_dropping_trees`` on the same state).
- Training (regression, ``drop_rate=0.5``, ``skip_drop=0``, weighted
  drops): tree structure equal, each tree's ``shrinkage`` (its
  normalisation) to 1e-12, leaf values, scores and l2 to rtol 1e-4;
  the dropped trees' outputs come from the device trees times their
  scale in f32, as there.  Predictions carried both ways.
- Quantized gradients fall back to f32 with the JAX package's warning.
"""

import numpy as np
import pytest
import torch

import lightgbm_tpu as lgb

import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch.boosting import gbdt as tgbdt

from test_torch_objectives import (BASE, assert_predictions_carry,
                                   assert_same_metrics, assert_same_trees,
                                   table, train_both)
from lightgbm_tpu_torch.testing import one_thread  # noqa: F401

ROUNDS = 4
PARAMS = dict(BASE, objective="regression", boosting="dart",
              drop_rate=0.5, skip_drop=0.0, metric=["l2"])


@pytest.fixture(scope="module")
def trained():
    torch.exp(torch.randn(1 << 20))      # ROADMAP queue C (CPU exp)
    X, y = table(11, 2000, "regression")
    Xv, yv = table(12, 500, "regression")
    return (*train_both(PARAMS, X, y, Xv, yv, ROUNDS), Xv)


def test_drops_and_shrinkage_match(trained):
    bj, bt = trained[0], trained[1]
    gb = bt.boosting
    assert any(gb.drops), gb.drops
    jb = bj.boosting
    assert gb.tree_weight == pytest.approx(jb.tree_weight, rel=1e-12)
    assert gb.sum_weight == pytest.approx(jb.sum_weight, rel=1e-12)
    assert gb._drop_rng.get_state()[1].tolist() == \
        jb._drop_rng.get_state()[1].tolist()
    # replay: the same state draws the same drops on both sides
    for _ in range(3):
        assert gb._dropping_trees() == jb._dropping_trees()
        assert gb.shrinkage_rate == jb.shrinkage_rate


def test_trees_match(trained):
    assert_same_trees(trained[0], trained[1], ROUNDS)


def test_scores_and_metrics_match(trained):
    bj, bt = trained[0], trained[1]
    np.testing.assert_allclose(bt.boosting.train_score.numpy(),
                               np.asarray(bj.boosting.train_score),
                               rtol=1e-4, atol=1e-5)
    assert_same_metrics(trained[2], trained[3])


def test_predictions_carry_across(trained):
    assert_predictions_carry(trained[0], trained[1], trained[4])


def test_quantized_dart_falls_back_to_f32(monkeypatch):
    warnings = []
    monkeypatch.setattr(tgbdt, "log_warning", warnings.append)
    X, y = table(13, 500, "regression")
    p = dict(PARAMS, use_quantized_grad=True)
    bt = lt.Booster(dict(p), train_set=lt.Dataset(X, label=y, device="cpu"))
    assert not bt.boosting._quant_on
    assert len(warnings) == 1 and "boosting=dart" in warnings[0]
    jb = lgb.Booster(dict(p), train_set=lgb.Dataset(X, label=y))
    assert not jb.boosting._quant_on
