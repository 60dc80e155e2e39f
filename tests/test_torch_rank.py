"""``lambdarank`` in the port held against ``lightgbm_tpu``: the query
buckets, the gradients, and training.

- Buckets: queries grouped by padded size (the next power of two, at
  least 8) in the order each size is first seen, the [nq, Q] row-index
  blocks equal.
- Gradients: on scores without near-ties, to rtol 1e-5 plus 1e-6 of
  the largest |value| (measured: 2.4e-7 relative).  The pairwise sums
  over [chunk, Q, Q] run in torch's order, not XLA's (ROADMAP queue C),
  and ``argsort(stable=True)`` breaks equal scores as
  ``jnp.argsort(stable=True)`` does (the tied case is held on its own).
- Training (a few dozen queries of 3 to 39 documents, grades 0-4,
  ``eval_at`` 1, 3, 5): tree structure equal, leaf values and NDCG to
  rtol 1e-4, the model text's objective ``lambdarank``, predictions
  carried both ways (tests/test_torch_objectives.py helpers).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightgbm_tpu.objective_rank import _bucket_queries as j_buckets

from lightgbm_tpu_torch.objective_rank import _bucket_queries as t_buckets

from test_torch_objectives import (BASE, assert_predictions_carry,
                                   assert_same_metrics, assert_same_trees,
                                   objective_pair, query_sizes, table,
                                   train_both)
from lightgbm_tpu_torch.testing import one_thread  # noqa: F401

ROUNDS = 4
PARAMS = dict(BASE, objective="lambdarank", metric=["ndcg", "map"],
              eval_at=[1, 3, 5])


def _grad_case(seed, n=3000, norm=True, ties=False):
    rng = np.random.RandomState(seed)
    group = query_sizes(seed, n, 1, 300)
    y = rng.randint(0, 5, n).astype(np.float32)
    score = rng.randn(n).astype(np.float32)
    if ties:
        score = np.round(score * 2) / 2
    params = {"objective": "lambdarank", "lambdarank_norm": norm}
    return params, y, group, score


def test_buckets_match():
    group = query_sizes(0, 3000, 1, 300)
    qb = np.concatenate([[0], np.cumsum(group)])
    jb, tb = j_buckets(qb), t_buckets(qb)
    assert list(jb) == list(tb)
    for Q in jb:
        assert np.array_equal(jb[Q], tb[Q])
    params, y, group, _ = _grad_case(0)
    jo, to = objective_pair(params, y, group=group)
    for Q, (idx, lbl, _) in jo.bucket_data.items():
        tidx, tlbl, _ = to.bucket_data[Q]
        assert np.array_equal(np.asarray(idx), tidx.numpy())
        assert np.array_equal(np.asarray(lbl), tlbl.numpy())


@pytest.mark.parametrize("norm", [True, False], ids=["norm", "no_norm"])
@pytest.mark.parametrize("ties", [False, True], ids=["distinct", "ties"])
def test_gradients_match(norm, ties):
    params, y, group, score = _grad_case(1, norm=norm, ties=ties)
    jo, to = objective_pair(params, y, group=group)
    jg, jh = (np.asarray(a) for a in jo.get_gradients(jnp.asarray(score)))
    tg, th = (a.numpy() for a in to.get_gradients(torch.as_tensor(score)))
    for t, j in ((tg, jg), (th, jh)):
        np.testing.assert_allclose(t, j, rtol=1e-5,
                                   atol=1e-6 * np.abs(j).max())


@pytest.fixture(scope="module")
def trained():
    torch.exp(torch.randn(1 << 20))      # ROADMAP queue C (CPU exp)
    X, y = table(7, 2000, "grade")
    Xv, yv = table(8, 500, "grade")
    return (*train_both(PARAMS, X, y, Xv, yv, ROUNDS,
                        group=query_sizes(7, 2000),
                        vgroup=query_sizes(8, 500)), Xv)


def test_trees_match(trained):
    bj, bt, _, _, _ = trained
    assert "\nobjective=lambdarank\n" in bt.model_to_string()
    assert len(bt.boosting.objective.buckets) > 1
    assert_same_trees(bj, bt, ROUNDS)


def test_metrics_match(trained):
    _, _, ev_j, ev_t, _ = trained
    assert set(ev_t["valid_0"]) == {"ndcg@1", "ndcg@3", "ndcg@5", "map@1",
                                    "map@3", "map@5"}
    assert_same_metrics(ev_j, ev_t)


def test_predictions_carry_across(trained):
    bj, bt, _, _, Xv = trained
    assert_predictions_carry(bj, bt, Xv)
