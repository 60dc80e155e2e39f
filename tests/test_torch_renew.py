"""The percentile leaf renewal of the L1 family in the port held against
``lightgbm_tpu``: ``ops.renew.leaf_percentile`` and ``regression_l1``
training.

- ``leaf_percentile``: bit-equal to the JAX function on integer weights
  (bagging masks times unit row weights: every f32 cumulative sum is
  exact); on random weights to 2e-5 absolute (values ~1; measured
  9.1e-6: ``jnp.cumsum``'s order against torch's, ROADMAP queue C).
- ``regression_l1`` training (5% of the labels outliers; bagging, so
  the renewal sees zero weights): tree structure equal, renewed leaf
  values, predictions and l1 to rtol 1e-4; the leaf values are the
  weighted medians of the residuals ``label - score``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightgbm_tpu.ops.renew import leaf_percentile as j_pct

from lightgbm_tpu_torch.ops.renew import leaf_percentile as t_pct

from test_torch_objectives import (BASE, assert_predictions_carry,
                                   assert_same_metrics, assert_same_trees,
                                   table, train_both)
from lightgbm_tpu_torch.testing import one_thread  # noqa: F401

ROUNDS = 4
PARAMS = dict(BASE, objective="regression_l1", bagging_freq=1,
              bagging_fraction=0.8, metric=["l1"])


def _case(seed, integer, L=7, n=3000):
    rng = np.random.RandomState(seed)
    leaf = rng.randint(0, L - 1, n).astype(np.int32)   # one leaf empty
    res = rng.randn(n).astype(np.float32)
    res[rng.rand(n) < 0.05] = 0.5                       # repeated values
    keep = rng.rand(n) < 0.8
    w = (rng.randint(1, 3, n) if integer else rng.rand(n) * 2) * keep
    return leaf, res, w.astype(np.float32), L


@pytest.mark.parametrize("alpha", [0.5, 0.1, 0.9])
@pytest.mark.parametrize("integer", [True, False],
                         ids=["integer_weights", "random_weights"])
def test_leaf_percentile_matches(alpha, integer):
    for seed in range(3):
        leaf, res, w, L = _case(seed, integer)
        j = np.asarray(j_pct(jnp.asarray(leaf), jnp.asarray(res),
                             jnp.asarray(w), L, alpha))
        t = t_pct(torch.as_tensor(leaf), torch.as_tensor(res),
                  torch.as_tensor(w), L, alpha).numpy()
        if integer:
            assert t.tobytes() == j.tobytes()
        else:
            np.testing.assert_allclose(t, j, rtol=0, atol=2e-5)


@pytest.fixture(scope="module")
def trained():
    torch.exp(torch.randn(1 << 20))      # ROADMAP queue C (CPU exp)
    X, y = table(17, 2000, "regression")
    y[::20] += 25.0
    Xv, yv = table(18, 500, "regression")
    return (*train_both(PARAMS, X, y, Xv, yv, ROUNDS), Xv)


def test_trees_match(trained):
    assert_same_trees(trained[0], trained[1], ROUNDS)


def test_metrics_match(trained):
    assert_same_metrics(trained[2], trained[3])


def test_predictions_carry_across(trained):
    assert_predictions_carry(trained[0], trained[1], trained[4])
