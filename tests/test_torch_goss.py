"""GOSS in the port held against ``lightgbm_tpu``.

- The weight mask (1 for the top ``top_rate`` rows by ``sum_k |g h|``,
  the amplified weight for the sampled rest, 0 otherwise) is bit-equal
  to the JAX package's on the same gradients and key at K = 1, at the
  default and at non-dyadic rates.  At K > 1 the f32 sum over classes
  runs in torch's order: every row equal except where a row's score
  sits within 2 ulps of the top-k threshold (measured: none at K = 3).
- The key stream: ``split`` once a sampled iteration from
  ``PRNGKey(bagging_seed)``, none in the 1 / learning_rate warm-up.
- Training (binary, lr 0.5: iterations 0-1 warm up, 2-3 sample): tree
  structure equal, leaf values and metrics to rtol 1e-4 (f32 histogram
  sums of weights 1, 8 and 0 in different orders), predictions carried
  both ways.  Four rounds: on this data the fifth tree meets two
  candidates whose gains agree to 6 digits (45.927), which the two
  packages' f32 sums order differently (ROADMAP queue C-3).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightgbm_tpu_torch.boosting.goss import goss_mask
from lightgbm_tpu_torch.utils import threefry

from test_torch_objectives import (BASE, assert_predictions_carry,
                                   assert_same_metrics, assert_same_trees,
                                   table, train_both)
from lightgbm_tpu_torch.testing import one_thread  # noqa: F401

ROUNDS = 4
PARAMS = dict(BASE, objective="binary", boosting="goss", learning_rate=0.5,
              metric=["binary_logloss", "auc"])


@pytest.fixture(scope="module")
def trained():
    torch.exp(torch.randn(1 << 20))      # ROADMAP queue C (CPU exp)
    X, y = table(1, 2000, "binary")
    Xv, yv = table(2, 500, "binary")
    return (*train_both(PARAMS, X, y, Xv, yv, ROUNDS), Xv)


def _reference_mask(bj, g, h, key):
    gb = bj.boosting
    return np.asarray(gb._macro_goss_mask(jnp.asarray(g), jnp.asarray(h),
                                          jnp.asarray(np.asarray(
                                              key, np.uint32)),
                                          gb._row_valid))


@pytest.mark.parametrize("rates", [(0.2, 0.1), (0.3, 0.17), (0.05, 0.6)],
                         ids=["default", "non_dyadic", "wide"])
def test_mask_is_bit_equal(trained, rates):
    bj = trained[0]
    rng = np.random.RandomState(4)
    g = rng.randn(1, 2000).astype(np.float32)
    h = (rng.rand(1, 2000) + 0.1).astype(np.float32)
    key = threefry.split(threefry.prng_key(3))[1]
    gb = bj.boosting
    top, other = gb.config.top_rate, gb.config.other_rate
    try:
        gb.config.top_rate, gb.config.other_rate = rates
        from lightgbm_tpu.boosting.goss import GOSS
        fresh = GOSS(gb.config, gb.train_set, gb.objective)
        want = np.asarray(fresh._macro_goss_mask(
            jnp.asarray(g), jnp.asarray(h),
            jnp.asarray(np.asarray(key, np.uint32)), fresh._row_valid))
    finally:
        gb.config.top_rate, gb.config.other_rate = top, other
    got = goss_mask(torch.as_tensor(g), torch.as_tensor(h), key, *rates)
    assert got.numpy().tobytes() == want.tobytes()
    assert set(np.unique(want)) <= {0.0, 1.0,
                                    np.float32((1 - rates[0]) / rates[1])}


def test_mask_at_three_classes(trained):
    rng = np.random.RandomState(5)
    g = rng.randn(3, 2000).astype(np.float32)
    h = (rng.rand(3, 2000) + 0.1).astype(np.float32)
    key = threefry.split(threefry.prng_key(3))[1]
    want = _reference_mask(trained[0], g, h, key)
    got = goss_mask(torch.as_tensor(g), torch.as_tensor(h), key, 0.2, 0.1)
    assert np.array_equal(got.numpy(), want)


def test_key_stream_and_sampled_rounds(trained):
    bj, bt = trained[0], trained[1]
    gb = bt.boosting
    assert gb.sampled_iters == ROUNDS - 2
    k = threefry.prng_key(gb.config.bagging_seed)
    for _ in range(ROUNDS - 2):
        k, _ = threefry.split(k)
    assert gb._goss_key == k
    jk = jax.random.PRNGKey(gb.config.bagging_seed)
    for _ in range(ROUNDS - 2):
        jk, _ = jax.random.split(jk)
    assert (np.asarray(bj.boosting._goss_rng_key).tolist()
            == np.asarray(jk).tolist() == list(k))
    assert all(0.25 < float(s) < 0.35 for s in gb.kept_share)


def test_trees_match(trained):
    assert_same_trees(trained[0], trained[1], ROUNDS)


def test_metrics_match(trained):
    assert_same_metrics(trained[2], trained[3])


def test_predictions_carry_across(trained):
    assert_predictions_carry(trained[0], trained[1], trained[4])
