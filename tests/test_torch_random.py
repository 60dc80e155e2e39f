"""Per-node randomness in the port (``extra_trees``,
``feature_fraction_bynode``) held against the JAX package, on the CPU.

- The batched threefry ``fold_in``/``uniform`` over a tensor of keys
  against ``jax.random`` for a vector of node ids, under both
  ``jax_threefry_partitionable`` settings: bit-equal.
- The grower's per-node draws (``grower_rounds.node_draws``): the bynode
  mask and the extra-trees uniforms, and the numeric thresholds
  ``ops.split.random_thresholds``, against the JAX package's
  ``one_leaf_best`` draws: equal.
- Trees of ``lt.train`` against ``lightgbm_tpu.train`` with
  ``extra_trees``, with ``feature_fraction_bynode`` and with both, on
  the airline table's categorical features (extra trees' second draw,
  one-hot and many-vs-many; ``max_cat_threshold=3`` as in
  tests/test_torch_categorical.py, whose docstring gives the reason):
  equal structure, leaf values and predictions within 1e-5 (the two
  packages sum f32 histograms in different orders; measured: 9.9e-6 on
  a leaf of 0.31); the same for
  ``grow_tree_rounds`` with both (tests/test_rounds.py's case), and for
  quantized training with bynode at 16 bins (leaf values within 1e-5 of
  the tree's largest, tests/test_torch_quantized.py's bar).
- The arm election: per-node randomness runs the staged arm (its root a
  whole-dataset histogram) even where the fused one is asked for.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lightgbm_tpu as lgb
from lightgbm_tpu.dataset import FeatureMeta as JMeta
from lightgbm_tpu.grower import GrowerConfig as JConfig
from lightgbm_tpu.grower_rounds import grow_tree_rounds as jgrow
from lightgbm_tpu.ops.split import SplitHyperparams as JHP

import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch import grower_rounds
from lightgbm_tpu_torch.dataset import FeatureMeta as TMeta
from lightgbm_tpu_torch.grower import GrowerConfig as TConfig
from lightgbm_tpu_torch.model_text import load_model_from_string
from lightgbm_tpu_torch.ops.split import SplitHyperparams as THP
from lightgbm_tpu_torch.ops.split import random_thresholds
from lightgbm_tpu_torch.testing import AIRLINE_CATEGORICAL, airline_like
from lightgbm_tpu_torch.utils import threefry
from lightgbm_tpu_torch.testing import one_thread  # noqa: F401

TREE_EXACT = ("split_feature", "threshold", "decision_type", "left_child",
              "right_child", "leaf_count", "cat_boundaries", "cat_threshold")


@pytest.fixture
def partitionable(request):
    """Sets both packages' threefry variant for one test."""
    saved_j = jax.config.jax_threefry_partitionable
    saved_t = threefry.PARTITIONABLE
    jax.config.update("jax_threefry_partitionable", request.param)
    threefry.PARTITIONABLE = request.param
    yield request.param
    jax.config.update("jax_threefry_partitionable", saved_j)
    threefry.PARTITIONABLE = saved_t


def _node_keys_jax(rng, parents, sides):
    return [jax.random.fold_in(jax.random.fold_in(rng, int(p) + 1), int(s))
            for p, s in zip(parents, sides)]


@pytest.mark.parametrize("partitionable", [True, False], indirect=True)
def test_batched_keys_and_uniforms_match_jax(partitionable):
    rng = jax.random.fold_in(jax.random.PRNGKey(77), 3)
    key = tuple(int(x) for x in np.asarray(rng))
    parents = np.array([-1, 0, 1, 2, 5, 17, 200, 253], np.int64)
    sides = np.array([0, 0, 1, 0, 1, 1, 0, 1], np.int64)
    want = _node_keys_jax(rng, parents, sides)
    keys = threefry.fold_in(threefry.fold_in(
        threefry.key_tensor(key), torch.from_numpy(parents + 1)),
        torch.from_numpy(sides))
    assert np.array_equal(keys.numpy(),
                          np.stack([np.asarray(k) for k in want]))
    for shape in [(28,), (9, 2), (5,)]:
        got = threefry.uniform(threefry.fold_in(keys, 1), shape).numpy()
        ref = np.stack([np.asarray(jax.random.uniform(
            jax.random.fold_in(k, 1), shape)) for k in want])
        assert got.tobytes() == ref.tobytes()
    # one key as a batch of one gives the single-key draw
    one = threefry.uniform(threefry.key_tensor(key), (11,))[0]
    assert one.numpy().tobytes() == threefry.uniform(key, (11,)) \
        .numpy().tobytes()


def test_node_draws_match_the_reference():
    """The JAX package's one_leaf_best draws: the bynode mask (the cnt
    smallest of u), the extra-trees uniforms and rand_t."""
    F, cnt = 13, 5
    rng = jax.random.fold_in(jax.random.PRNGKey(5), 0)
    key = tuple(int(x) for x in np.asarray(rng))
    parents = np.array([-1, 3, 3, 8, 9], np.int64)
    sides = np.array([0, 0, 1, 0, 1], np.int64)
    num_bin = np.array([2, 3, 16, 63, 1, 64, 9, 9, 9, 200, 17, 4, 5],
                       np.int32)
    mask, eru = grower_rounds.node_draws(
        key, torch.from_numpy(parents), torch.from_numpy(sides), F, cnt,
        True)
    rand_t = random_thresholds(eru[..., 0], torch.from_numpy(num_bin))
    for i, k in enumerate(_node_keys_jax(rng, parents, sides)):
        u = jax.random.uniform(jax.random.fold_in(k, 0), (F,))
        kth = -jax.lax.top_k(-u, cnt)[0][-1]
        want_mask = np.asarray((u <= kth).astype(jnp.float32))
        assert np.array_equal(mask[i].numpy(), want_mask)
        assert want_mask.sum() == cnt
        e = jax.random.uniform(jax.random.fold_in(k, 1), (F, 2))
        assert eru[i].numpy().tobytes() == np.asarray(e).tobytes()
        want_t = np.asarray(jnp.floor(e[:, 0] * jnp.maximum(
            jnp.asarray(num_bin) - 1, 1).astype(jnp.float32)
        ).astype(jnp.int32))
        assert np.array_equal(rand_t[i].numpy(), want_t)
        assert (rand_t[i].numpy() <= np.maximum(num_bin - 2, 0)).all()


# ----------------------------------------------------------------------
# trees
# ----------------------------------------------------------------------

BASE = {"num_leaves": 15, "min_data_in_leaf": 5, "verbose": -1,
        "tpu_tree_growth": "rounds", "tpu_hist_method": "fused",
        "max_bin": 63, "objective": "binary", "max_cat_threshold": 3}
RANDOM = {
    "extra_trees": {"extra_trees": True},
    "bynode": {"feature_fraction_bynode": 0.5},
    "both": {"extra_trees": True, "feature_fraction_bynode": 0.6,
             "extra_trees_seed": 11},
}


def _cat_data(seed, n):
    """The airline table (``testing.airline_like``): six categorical
    columns (7 to 300 codes) and two numeric ones."""
    return airline_like(n, seed)


def _models(params, X, y, rounds, cats=AIRLINE_CATEGORICAL):
    bj = lgb.train(dict(params), lgb.Dataset(X, label=y,
                                             categorical_feature=list(cats)),
                   rounds, verbose_eval=False)
    bt = lt.train(dict(params), lt.Dataset(X, label=y, device="cpu",
                                           categorical_feature=list(cats)),
                  rounds, verbose_eval=False)
    return (bj, bt, load_model_from_string(bj.model_to_string())["models"],
            load_model_from_string(bt.model_to_string())["models"])


@pytest.mark.parametrize("name", list(RANDOM))
def test_random_trees_match_reference(name):
    X, y = _cat_data(3, 2000)
    bj, bt, jms, tms = _models(dict(BASE, **RANDOM[name]), X, y, 5)
    assert len(jms) == len(tms) == 5
    for j, t in zip(jms, tms):
        assert j.num_leaves == t.num_leaves
        for f in TREE_EXACT:
            assert np.array_equal(getattr(j, f), getattr(t, f)), f
        np.testing.assert_allclose(t.leaf_value, j.leaf_value, rtol=1e-5,
                                   atol=1e-5)
    Xv, _ = _cat_data(4, 300)
    np.testing.assert_allclose(bt.predict(Xv), bj.predict(Xv), rtol=1e-5,
                               atol=1e-5)
    if "feature_fraction_bynode" in RANDOM[name]:
        assert bt.boosting.grower_cfg.bynode_feature_cnt > 0
    # the randomness bites: the trees differ from the plain run's
    plain = lt.train(dict(BASE), lt.Dataset(
        X, label=y, device="cpu",
        categorical_feature=list(AIRLINE_CATEGORICAL)), 5,
        verbose_eval=False)
    assert plain.model_to_string() != bt.model_to_string()


def test_extra_trees_reaches_the_categorical_draw():
    """With extra trees a categorical split takes its random category:
    the model has categorical splits (column 1 of the draws ran)."""
    X, y = _cat_data(3, 2000)
    _, bt, _, tms = _models(dict(BASE, extra_trees=True,
                                 max_cat_to_onehot=8), X, y, 5)
    assert any((t.decision_type[:t.num_leaves - 1] & 1).any() for t in tms)


def test_grower_random_matches_reference():
    """tests/test_rounds.py's extra-trees + bynode case on the port's
    grower, the tree key given."""
    rng = np.random.RandomState(0)
    n, F, B = 3000, 8, 32
    binned = rng.randint(0, B, (F, n)).astype(np.uint8)
    y = (np.sin(binned[0] * 0.3) + 0.2 * binned[1] - 0.1 * binned[3]
         + (binned[2] > 20) * 1.5 + rng.randn(n) * 0.3)
    grad, hess = (-y).astype(np.float32), (0.5 + rng.rand(n)).astype(
        np.float32)
    mask = np.ones(n, np.float32)

    def meta(mod):
        return mod(num_bin=np.full(F, B, np.int32),
                   missing_type=np.zeros(F, np.int32),
                   default_bin=np.zeros(F, np.int32),
                   most_freq_bin=np.zeros(F, np.int32),
                   is_categorical=np.zeros(F, bool), max_num_bin=B)
    key = jax.random.PRNGKey(42)
    jt, jl = jgrow(jnp.asarray(binned), jnp.asarray(grad), jnp.asarray(hess),
                   jnp.asarray(mask), meta(JMeta),
                   JConfig(num_leaves=31, num_bins=B,
                           hp=JHP(extra_trees=True), bynode_feature_cnt=5,
                           hist_method="fused"), rng_key=key)
    tt, tl = grower_rounds.grow_tree_rounds(
        torch.from_numpy(binned), torch.from_numpy(grad),
        torch.from_numpy(hess), torch.from_numpy(mask), meta(TMeta),
        TConfig(num_leaves=31, num_bins=B, hp=THP(extra_trees=True),
                bynode_feature_cnt=5, hist_method="fused"),
        rng_key=tuple(int(x) for x in np.asarray(key)))
    tt = tt.to_numpy()
    assert int(jt.num_leaves) == tt["num_leaves"] > 10
    for name in ("split_feature", "threshold_bin", "default_left",
                 "left_child", "right_child", "leaf_parent", "leaf_depth"):
        assert np.array_equal(np.asarray(getattr(jt, name)), tt[name]), name
    assert np.array_equal(np.asarray(jl), tl.numpy())
    np.testing.assert_allclose(tt["leaf_value"], np.asarray(jt.leaf_value),
                               rtol=3e-5, atol=1e-7)


def test_quantized_bynode_matches_reference():
    """Quantized training with bynode trains int8 on the staged arm in
    both packages (no f32 fallback)."""
    torch.exp(torch.randn(1 << 20))      # see ROADMAP queue C (CPU exp)
    X, y = _cat_data(5, 2000)
    params = dict(BASE, use_quantized_grad=True, num_grad_quant_bins=16,
                  feature_fraction_bynode=0.5)
    bj, bt, jms, tms = _models(params, X, y, 4, cats=())
    assert bj.boosting._quant_on and bt.boosting._quant_on
    for j, t in zip(jms, tms):
        assert j.num_leaves == t.num_leaves
        for f in TREE_EXACT:
            assert np.array_equal(getattr(j, f), getattr(t, f)), f
        np.testing.assert_allclose(
            t.leaf_value, j.leaf_value, rtol=1e-5,
            atol=1e-5 * float(np.abs(j.leaf_value).max()))


@pytest.mark.parametrize("params,staged", [
    ({}, False), ({"extra_trees": True}, True),
    ({"feature_fraction_bynode": 0.5}, True)])
def test_randomness_elects_the_staged_arm(params, staged, monkeypatch):
    calls = {"pair": 0, "whole": 0}
    pair, whole = (grower_rounds.fused.frontier_splits,
                   grower_rounds.histogram_fixed)

    def count_pair(*a, **k):
        calls["pair"] += 1
        return pair(*a, **k)

    def count_whole(*a, **k):
        calls["whole"] += 1
        return whole(*a, **k)
    monkeypatch.setattr(grower_rounds.fused, "frontier_splits", count_pair)
    monkeypatch.setattr(grower_rounds, "histogram_fixed", count_whole)
    X, y = _cat_data(6, 800)
    lt.train(dict(BASE, **params), lt.Dataset(X, label=y, device="cpu"), 2,
             verbose_eval=False)
    assert (calls["pair"] == 0) == staged
    assert calls["whole"] == (2 if staged else 0)
