"""``multiclass`` (softmax, K = 3) trained by ``lt.train`` on the CPU
against ``lightgbm_tpu.train`` (the rounds grower, fused arm): K trees
an iteration, class k's tree grown from class k's gradients and
feature mask.

Bars (tests/test_torch_objectives.py helpers): the model text's header
(``multiclass num_class:3``, ``num_tree_per_iteration=3``) and tree
structure equal; leaf values, predictions and the metrics
(multi_logloss, multi_error, auc_mu) to rtol 1e-4 (f32 histogram sums
in different orders; softmax within 4 ulps of XLA's); the port's model
text loads in ``lightgbm_tpu.Booster`` and predicts the same, and the
JAX model loads in the port (text and ``stacked_forest_from_numpy``).
Column sampling by tree (``feature_fraction``) draws the [K, F] masks
class by class from one stream, as the JAX package does.
"""

import numpy as np
import pytest
import torch

from test_torch_objectives import (BASE, assert_predictions_carry,
                                   assert_same_metrics, assert_same_trees,
                                   table, train_both)
from lightgbm_tpu_torch.testing import one_thread  # noqa: F401

ROUNDS = 4
PARAMS = dict(BASE, objective="multiclass", num_class=3,
              feature_fraction=0.8,
              metric=["multi_logloss", "multi_error", "auc_mu"])


@pytest.fixture(scope="module")
def trained():
    torch.exp(torch.randn(1 << 20))      # ROADMAP queue C (CPU exp)
    X, y = table(1, 2000, "class")
    Xv, yv = table(2, 500, "class")
    return (*train_both(PARAMS, X, y, Xv, yv, ROUNDS), Xv)


def test_trees_match(trained):
    bj, bt, _, _, _ = trained
    assert bt.num_tree_per_iteration == 3
    assert bt.model_to_string().startswith(
        "tree\nversion=v3\nnum_class=3\nnum_tree_per_iteration=3")
    assert_same_trees(bj, bt, 3 * ROUNDS)


def test_metrics_match(trained):
    _, _, ev_j, ev_t, _ = trained
    assert set(ev_t["valid_0"]) == {"multi_logloss", "multi_error",
                                    "auc_mu"}
    assert_same_metrics(ev_j, ev_t)


def test_predictions_carry_across(trained):
    bj, bt, _, _, Xv = trained
    assert_predictions_carry(bj, bt, Xv)
    p = bt.predict(Xv)
    assert p.shape == (len(Xv), 3)
    np.testing.assert_allclose(p.sum(axis=1), 1.0, rtol=1e-5)
