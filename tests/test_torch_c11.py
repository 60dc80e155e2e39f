"""ROADMAP queue C-11: small integer-coded categorical columns (12 codes)
at the default ``max_cat_threshold=32``, the port against
``lightgbm_tpu.train(..., tpu_tree_growth="rounds")`` on the fused arm
and on the staged arm.

What diverges first: a categorical node where both ends of the sorted
many-vs-many scan reach the same partition ({one category} against the
rest) with its sides swapped.  The port's exact sums give the two ends
the same two f32 side sums, so their gains tie exactly and the low end
wins (``use_lo = lo_gain >= hi_gain``, as in the JAX package).  The JAX
package takes the high end's left sums as ``pg[-1] - pg[k]`` from an f32
``jnp.cumsum`` and its right sums from the leaf total, so the two ends'
gains differ by rounding: on random 12-category histograms in 91% of
cases, by up to 45 ulps (``test_the_two_ends_differ_in_the_reference``
measures it with the JAX package's own ``leaf_gain``).  Where its high
end rounds higher, the JAX tree keeps the complement bitset, the node's
children swap, and the leaves and later nodes are numbered differently.
The reference's f32 order is at fault (as in C-3); the port is not.

So the test holds what is the same: every tree splits the training rows
into the same leaves with the same values (rtol 1e-4), uses the same
split features, and at the first divergent node the two bitsets are
complements over the feature's categories; predictions and metrics
agree to rtol 1e-4.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lightgbm_tpu as lgb
from lightgbm_tpu.ops.split import K_EPSILON, leaf_gain

import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch.model_text import load_model_from_string
from lightgbm_tpu_torch.testing import one_thread  # noqa: F401

ROUNDS = 4
PARAMS = {"objective": "binary", "num_leaves": 7, "min_data_in_leaf": 5,
          "verbose": -1, "tpu_tree_growth": "rounds", "max_bin": 63,
          "metric": ["binary_logloss"], "max_cat_threshold": 32}
ARMS = ("fused", "pallas")


def _data(seed, n):
    """Three 12-code integer categorical columns and two numeric ones."""
    rng = np.random.RandomState(seed)
    C = rng.randint(0, 12, (n, 3)).astype(np.float32)
    N = rng.randn(n, 2).astype(np.float32)
    eff = np.random.RandomState(99).randn(3, 12)
    z = (eff[0][C[:, 0].astype(int)] + 0.7 * eff[1][C[:, 1].astype(int)]
         + 0.5 * eff[2][C[:, 2].astype(int)] + N[:, 0]
         + 0.3 * rng.randn(n))
    return np.concatenate([C, N], 1), (z > 0).astype(np.float32)


@pytest.fixture(scope="module")
def trained():
    torch.exp(torch.randn(1 << 20))      # ROADMAP queue C (CPU exp)
    X, y = _data(1, 2000)
    Xv, yv = _data(2, 500)
    out = {}
    for arm in ARMS:
        p = dict(PARAMS, tpu_hist_method=arm)
        ev_j, ev_t = {}, {}
        dj = lgb.Dataset(X, label=y, categorical_feature=[0, 1, 2])
        bj = lgb.train(dict(p), dj, ROUNDS,
                       valid_sets=[lgb.Dataset(Xv, label=yv, reference=dj)],
                       evals_result=ev_j, verbose_eval=False)
        dt = lt.Dataset(X, label=y, categorical_feature=[0, 1, 2],
                        device="cpu")
        bt = lt.train(dict(p), dt, ROUNDS,
                      valid_sets=[dt.create_valid(Xv, label=yv)],
                      evals_result=ev_t, verbose_eval=False)
        out[arm] = (bj, bt, ev_j, ev_t)
    return out, X, Xv


def _models(b):
    return load_model_from_string(b.model_to_string())["models"]


@pytest.mark.parametrize("arm", ARMS)
def test_the_divergence_reproduces(trained, arm):
    """The first divergent node of the first differing tree splits a
    categorical feature with complementary bitsets."""
    (bj, bt, _, _), X = trained[0][arm], trained[1]
    for j, t in zip(_models(bj), _models(bt)):
        if np.array_equal(j.cat_threshold, t.cat_threshold):
            continue
        node = next(i for i in range(j.num_leaves - 1)
                    if j.decision_type[i] & 1 and not np.array_equal(
                        _bitset(j, i), _bitset(t, i)))
        assert j.split_feature[node] == t.split_feature[node]
        cats = set(np.unique(X[:, j.split_feature[node]]).astype(int))
        a, b = _cats(j, node), _cats(t, node)
        assert a.isdisjoint(b) and (a | b) >= cats
        return
    pytest.fail("no tree differs: the tie did not show")


def _bitset(tree, node):
    k = int(tree.threshold[node])
    return tree.cat_threshold[tree.cat_boundaries[k]:
                              tree.cat_boundaries[k + 1]]


def _cats(tree, node):
    words = _bitset(tree, node)
    return {32 * w + b for w, word in enumerate(words) for b in range(32)
            if (int(word) >> b) & 1}


@pytest.mark.parametrize("arm", ARMS)
def test_same_leaves_and_split_features(trained, arm):
    (bj, bt, _, _), X = trained[0][arm], trained[1]
    Xd = X.astype(np.float64)
    for j, t in zip(_models(bj), _models(bt)):
        assert j.num_leaves == t.num_leaves
        assert sorted(j.split_feature) == sorted(t.split_feature)
        lj, lt_ = j.predict_leaf_np(Xd), t.predict_leaf_np(Xd)
        pairs = set(zip(lj.tolist(), lt_.tolist()))
        assert len(pairs) == len(set(lj.tolist())) == len(set(lt_.tolist()))
        for a, b in pairs:
            np.testing.assert_allclose(t.leaf_value[b], j.leaf_value[a],
                                       rtol=1e-4, atol=1e-6)
            assert j.leaf_count[a] == t.leaf_count[b]


@pytest.mark.parametrize("arm", ARMS)
def test_predictions_and_metrics_match(trained, arm):
    (bj, bt, ev_j, ev_t), Xv = trained[0][arm], trained[2]
    np.testing.assert_allclose(bt.predict(Xv), bj.predict(Xv), rtol=1e-4,
                               atol=1e-6)
    np.testing.assert_allclose(ev_t["valid_0"]["binary_logloss"],
                               ev_j["valid_0"]["binary_logloss"], rtol=1e-4)


def test_the_two_ends_differ_in_the_reference():
    """The JAX package's arithmetic for one partition reached from both
    ends (left = the first sorted category at the low end; left = the
    rest at the high end), on random 12-category f32 histograms: the two
    gains differ in most cases, by up to tens of ulps."""
    rng = np.random.RandomState(0)
    ulps = []
    l2 = 10.0          # lambda_l2 + cat_l2 at the defaults
    for _ in range(300):
        g = (rng.randn(12) * rng.rand() * 50).astype(np.float32)
        h = (rng.rand(12) * 30 + 1).astype(np.float32)
        order = np.argsort(g / (h + 10.0))
        pg = jnp.cumsum(jnp.asarray(g[order]))
        ph = jnp.cumsum(jnp.asarray(h[order]))
        tg = jnp.sum(jnp.asarray(g))
        th = jnp.sum(jnp.asarray(h)) + 2 * K_EPSILON

        def gain(clg, clh):
            return (leaf_gain(clg, clh, 0.0, l2)
                    + leaf_gain(tg - clg, th - clh, 0.0, l2))
        lo = gain(pg[0], ph[0] + K_EPSILON)
        hi = gain(pg[-1] - pg[0], ph[-1] - ph[0] + K_EPSILON)
        a, b = (np.float32(v).view(np.int32).astype(np.int64)
                for v in (lo, hi))
        ulps.append(abs(int(a) - int(b)))
    ulps = np.asarray(ulps)
    assert (ulps > 0).mean() > 0.5
    assert 0 < ulps.max() <= 64
