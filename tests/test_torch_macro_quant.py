"""The other five of tests/test_macro.py's parity cases (quantized,
the fused hist method, multiclass; ``test_torch_macro.py`` holds the
rest and the helpers), and ``rollback_one_iter``, on the CPU.

- Each case trained over 12 iterations in the reference's chunk plans
  gives model text byte-identical to twelve ``update()`` calls, and its
  first four iterations the trees of the JAX package's
  ``update_chunk(4)`` (``test_torch_macro.py``'s bars).
- ``rollback_one_iter`` then one more ``update()`` gives the JAX
  package's trees and train and valid scores (tests/
  test_deferred_finish.py's ``test_deferred_rollback_and_continue``).
"""

import numpy as np
import pytest

import lightgbm_tpu as lgb

import lightgbm_tpu_torch as lt

from test_macro import PARITY_CASES
from test_torch_macro import (check_chunked_equals_per_iteration,
                              check_trees_match_the_jax_package, jax_runs,
                              port_runs)
from test_torch_objectives import BASE, assert_same_trees, table
from lightgbm_tpu_torch.testing import one_thread  # noqa: F401

CASES = ("fused", "fused_quant", "multiclass", "quant", "quant_renew")


@pytest.fixture(scope="module")
def trained():
    return port_runs(CASES)


@pytest.fixture(scope="module")
def jax_chunked():
    return jax_runs(CASES)


def test_the_two_files_cover_every_parity_case():
    from test_torch_macro import CASES as OTHERS
    assert sorted(CASES + OTHERS) == sorted(PARITY_CASES)


@pytest.mark.parametrize("case", CASES)
def test_chunked_equals_per_iteration(case, trained):
    check_chunked_equals_per_iteration(trained[case])


@pytest.mark.parametrize("case", CASES)
def test_chunk_trees_match_the_jax_package(case, trained, jax_chunked):
    check_trees_match_the_jax_package(case, trained[case],
                                      jax_chunked[case])


def test_rollback_and_continue_matches_the_jax_package():
    """Six iterations, a rollback, one more: the JAX package's trees and
    train and valid scores (the training tests' settings and data,
    tests/test_torch_objectives.py); the rolled-back booster is the
    five-iteration one, its train scores within f32 rounding of them."""
    X6, y6 = table(21, 1200, "binary")
    Xv, yv = table(22, 400, "binary")
    params = dict(BASE, objective="binary")
    dj = lgb.Dataset(X6, label=y6)
    bj = lgb.Booster(params=dict(params), train_set=dj)
    bj.add_valid(lgb.Dataset(Xv, label=yv, reference=dj), "v")
    dt = lt.Dataset(X6, label=y6, device="cpu")
    bt = lt.Booster(dict(params), train_set=dt)
    bt.add_valid(dt.create_valid(Xv, label=yv), "v")
    five = lt.Booster(dict(params), train_set=lt.Dataset(X6, label=y6,
                                                         device="cpu"))
    for b in (bj, bt):
        for _ in range(6):
            b.update()
        b.rollback_one_iter()
    for _ in range(5):
        five.update()
    assert bj.num_trees() == bt.num_trees() == 5
    assert bt.current_iteration() == 5
    assert bt.model_to_string() == five.model_to_string()
    np.testing.assert_allclose(bt.boosting.train_score.numpy(),
                               five.boosting.train_score.numpy(),
                               rtol=1e-5, atol=1e-6)
    assert_same_trees(bj, bt, 5)
    for b in (bj, bt):
        b.update()
    assert_same_trees(bj, bt, 6)
    n, nv = len(y6), len(yv)
    np.testing.assert_allclose(
        bt.boosting.train_score.numpy(),
        np.asarray(bj.boosting.train_score)[..., :n], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(
        bt.boosting.valid_scores[0].numpy(),
        np.asarray(bj.boosting.valid_scores[0])[..., :nv], rtol=1e-4,
        atol=1e-5)
