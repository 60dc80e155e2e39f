"""``rank_xendcg`` in the port held against ``lightgbm_tpu``.

- The draws: a bucket's gammas are ``uniform(fold_in(sub, Q), [nq, Q])``
  with ``sub = split(PRNGKey(objective_seed))[1]``.  The JAX package
  splits a fresh ``sub`` at every call, but inside its traced iteration
  program, so the one ``sub`` of the trace is compiled in and every
  iteration draws the same gammas (ROADMAP queue C-13); the port draws
  as the program does.  Shown here: the reference's per-iteration draws
  are equal to each other and to the port's.
- Gradients on the same scores and gammas: to rtol 1e-5 plus 1e-6 of
  the largest |value| (softmax, f32 sums over a query in torch's order).
- Training: tree structure equal, leaf values and NDCG to rtol 1e-4,
  predictions carried both ways.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightgbm_tpu import objective_rank as jrank

from lightgbm_tpu_torch.utils import threefry

from test_torch_objectives import (BASE, assert_predictions_carry,
                                   assert_same_metrics, assert_same_trees,
                                   objective_pair, query_sizes, table,
                                   train_both)
from lightgbm_tpu_torch.testing import one_thread  # noqa: F401

ROUNDS = 4
PARAMS = dict(BASE, objective="rank_xendcg", metric=["ndcg"],
              eval_at=[3, 5], objective_seed=11)


def test_gradients_match_on_the_same_draws():
    rng = np.random.RandomState(2)
    n = 3000
    group = query_sizes(2, n, 1, 200)
    y = rng.randint(0, 5, n).astype(np.float32)
    score = rng.randn(n).astype(np.float32)
    params = {"objective": "rank_xendcg", "objective_seed": 5}
    jo, to = objective_pair(params, y, group=group)
    jfn = jax.jit(jo.get_gradients)
    jg, jh = (np.asarray(a) for a in jfn(jnp.asarray(score)))
    tg, th = (a.numpy() for a in to.get_gradients(torch.as_tensor(score)))
    sub = jax.random.split(jax.random.PRNGKey(5))[1]
    assert np.asarray(sub).tolist() == list(to._cur_key)
    for t, j in ((tg, jg), (th, jh)):
        np.testing.assert_allclose(t, j, rtol=1e-5,
                                   atol=1e-6 * np.abs(j).max())


@pytest.fixture(scope="module")
def trained():
    torch.exp(torch.randn(1 << 20))      # ROADMAP queue C (CPU exp)
    X, y = table(9, 2000, "grade")
    Xv, yv = table(10, 500, "grade")
    keys = []
    draw = jrank.RankXENDCG._query_gradients

    def logged(self, Q, s, labels, valid, qids):
        keys.append((Q, self._cur_key))
        return draw(self, Q, s, labels, valid, qids)
    jrank.RankXENDCG._query_gradients = logged
    try:
        out = train_both(PARAMS, X, y, Xv, yv, ROUNDS,
                         group=query_sizes(9, 2000),
                         vgroup=query_sizes(10, 500))
    finally:
        jrank.RankXENDCG._query_gradients = draw
    return (*out, Xv, keys)


def test_the_reference_draws_one_key(trained):
    bt, keys = trained[1], trained[5]
    # the JAX package traced its gradients once: every bucket saw the
    # same traced key, never a second concrete one
    assert keys and len({Q for Q, _ in keys}) == len(keys)
    want = threefry.split(threefry.prng_key(PARAMS["objective_seed"]))[1]
    assert bt.boosting.objective._cur_key == want


def test_trees_match(trained):
    bj, bt = trained[0], trained[1]
    assert_same_trees(bj, bt, ROUNDS)


def test_metrics_match(trained):
    assert_same_metrics(trained[2], trained[3])


def test_predictions_carry_across(trained):
    assert_predictions_carry(trained[0], trained[1], trained[4])
