"""``multiclass`` (K = 3) on categorical data: the airline table's six
categorical columns native, on the staged arm (``tpu_hist_method=
"pallas"``: B6 roots, B4 segments, B5 in leaf mode, the categorical
search per class), ``lt.train`` on the CPU against
``lightgbm_tpu.train``.  ``max_cat_threshold=3`` keeps each categorical
search away from the ties of its two scan ends (ROADMAP queue C-3; the
default is held in tests/test_torch_c11.py).  Bars as in
tests/test_torch_multiclass.py, the categorical bitsets included.
"""

import numpy as np
import pytest
import torch

from lightgbm_tpu_torch.testing import (AIRLINE_CATEGORICAL,
                                        airline_multiclass_like)

from test_torch_objectives import (BASE, assert_predictions_carry,
                                   assert_same_metrics, assert_same_trees,
                                   train_both)
from lightgbm_tpu_torch.testing import one_thread  # noqa: F401

ROUNDS = 3
PARAMS = dict(BASE, objective="multiclass", num_class=3,
              tpu_hist_method="pallas", max_cat_threshold=3,
              metric=["multi_logloss", "multi_error"])


def _data(seed, n):
    X, y = airline_multiclass_like(n, seed)
    return X, np.minimum(y, 2).astype(np.float32)   # 3 bands


@pytest.fixture(scope="module")
def trained():
    torch.exp(torch.randn(1 << 20))      # ROADMAP queue C (CPU exp)
    X, y = _data(1, 2000)
    Xv, yv = _data(2, 500)
    return (*train_both(PARAMS, X, y, Xv, yv, ROUNDS,
                        categorical=list(AIRLINE_CATEGORICAL)), Xv)


def test_trees_match(trained):
    bj, bt, _, _, _ = trained
    assert_same_trees(bj, bt, 3 * ROUNDS)
    cats = sum(int((m.decision_type[:m.num_leaves - 1] & 1).sum())
               for m in bt.models)
    assert cats > 0


def test_metrics_match(trained):
    assert_same_metrics(trained[2], trained[3])


def test_predictions_carry_across(trained):
    bj, bt, _, _, Xv = trained
    assert_predictions_carry(bj, bt, Xv)
