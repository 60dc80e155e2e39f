"""``multiclassova`` (K = 3 binary objectives, one a class) trained by
``lt.train`` on the CPU against ``lightgbm_tpu.train`` (rounds grower,
fused arm).  Bars as in
tests/test_torch_multiclass.py; the model text's objective is
``multiclassova num_class:3 sigmoid:1``, and predictions are per-class
sigmoids.
"""

import numpy as np
import pytest
import torch

from test_torch_objectives import (BASE, assert_predictions_carry,
                                   assert_same_metrics, assert_same_trees,
                                   table, train_both)
from lightgbm_tpu_torch.testing import one_thread  # noqa: F401

ROUNDS = 4
PARAMS = dict(BASE, objective="multiclassova", num_class=3,
              metric=["multi_logloss", "multi_error"])


@pytest.fixture(scope="module")
def trained():
    torch.exp(torch.randn(1 << 20))      # ROADMAP queue C (CPU exp)
    X, y = table(3, 2000, "class")
    Xv, yv = table(4, 500, "class")
    return (*train_both(PARAMS, X, y, Xv, yv, ROUNDS), Xv)


def test_trees_match(trained):
    bj, bt, _, _, _ = trained
    assert "objective=multiclassova num_class:3 sigmoid:1\n" in \
        bt.model_to_string()
    assert_same_trees(bj, bt, 3 * ROUNDS)


def test_metrics_match(trained):
    assert_same_metrics(trained[2], trained[3])


def test_predictions_carry_across(trained):
    bj, bt, _, _, Xv = trained
    assert_predictions_carry(bj, bt, Xv)
    raw = bt.predict(Xv, raw_score=True)
    np.testing.assert_allclose(bt.predict(Xv), 1.0 / (1.0 + np.exp(-raw)),
                               rtol=1e-6)
