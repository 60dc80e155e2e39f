"""The port's batched-frontier grower (lightgbm_tpu_torch/grower_rounds.py)
held against the JAX package's ``grow_tree_rounds`` with
``hist_method="fused"`` (the Pallas megakernel in interpret mode).

- With random f32 gradients the trees have the same structure (split
  features, bin thresholds, default_left, children, leaf count, leaf ids
  of every row) and leaf values agree to rtol=3e-5, as
  tests/test_fused.py holds the JAX package's fused arm to its staged
  one: the two sum in different orders.
- With dyadic gradients (g = k/8, h in {1, k/4}) every sum is exact in
  both packages, so the whole first tree's arrays are equal.

The cases cover the three missing types, bagging weights of 0, a
per-tree feature mask, max_depth, and rounds that roll back to the exact
best-first prefix (checked through the grower's round log).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightgbm_tpu.dataset import FeatureMeta as JMeta
from lightgbm_tpu.grower import GrowerConfig as JConfig
from lightgbm_tpu.grower_rounds import grow_tree_rounds as jgrow
from lightgbm_tpu.ops.split import SplitHyperparams as JHP

from lightgbm_tpu_torch.dataset import FeatureMeta as TMeta
from lightgbm_tpu_torch.grower import GrowerConfig as TConfig
from lightgbm_tpu_torch.grower_rounds import grow_tree_rounds as tgrow
from lightgbm_tpu_torch.ops.split import SplitHyperparams as THP
from lightgbm_tpu_torch.testing import one_thread  # noqa: F401

N, F, B, LEAVES, WIDTH = 2000, 6, 32, 15, 8
HP = dict(min_data_in_leaf=5, lambda_l2=1.0)
STRUCTURE = ("split_feature", "threshold_bin", "default_left", "left_child",
             "right_child", "leaf_parent", "leaf_depth")
VALUES = ("split_gain", "internal_value", "internal_weight", "internal_count",
          "leaf_value", "leaf_weight", "leaf_count")

CASES = {
    "random": dict(seed=4, dyadic=False, missing=(0,) * F),
    "dyadic": dict(seed=5, dyadic=True, missing=(0, 2, 1, 0, 2, 1)),
    "dyadic_bagged": dict(seed=6, dyadic=True, missing=(2, 0, 1, 2, 0, 1),
                          bag=0.7),
    "dyadic_masked_depth": dict(seed=7, dyadic=True, missing=(0,) * F,
                                fmask=(1, 0, 1, 1, 0, 1), max_depth=3),
}


def _meta(missing, mod):
    nb = np.full(F, B, np.int32)
    nb[5] = 9                                    # bins past num_bin
    db = np.where(np.asarray(missing) == 1, 3, 0).astype(np.int32)
    return mod(num_bin=nb, missing_type=np.asarray(missing, np.int32),
               default_bin=db, most_freq_bin=np.zeros(F, np.int32),
               is_categorical=np.zeros(F, bool), max_num_bin=B)


def _inputs(seed, dyadic, bag=None):
    rng = np.random.RandomState(seed)
    binned = np.stack([rng.randint(0, 9 if f == 5 else B, N)
                       for f in range(F)]).astype(np.uint8)
    y = (np.sin(binned[0] * 0.3) + 0.2 * binned[1] - 0.1 * binned[3]
         + (binned[2] > 20) * 1.5 + rng.randn(N) * 0.3)
    if dyadic:
        grad = np.round(-y * 8) / 8
        hess = np.where(rng.rand(N) < 0.5, 1.0, rng.randint(1, 9, N) / 4.0)
    else:
        grad, hess = -y, 0.5 + rng.rand(N)
    mask = np.ones(N)
    if bag is not None:
        mask = (rng.rand(N) < bag).astype(np.float64)
    return (binned, grad.astype(np.float32), hess.astype(np.float32),
            mask.astype(np.float32))


def _grow(case):
    c = CASES[case]
    binned, grad, hess, mask = _inputs(c["seed"], c["dyadic"], c.get("bag"))
    fmask = c.get("fmask")
    depth = c.get("max_depth", -1)
    jt, jl = jgrow(jnp.asarray(binned), jnp.asarray(grad), jnp.asarray(hess),
                   jnp.asarray(mask), _meta(c["missing"], JMeta),
                   JConfig(num_leaves=LEAVES, max_depth=depth, hp=JHP(**HP),
                           num_bins=B, round_width=WIDTH,
                           hist_method="fused"),
                   feature_mask=(None if fmask is None
                                 else jnp.asarray(fmask, jnp.float32)))
    rounds = []
    tt, tl = tgrow(torch.from_numpy(binned), torch.from_numpy(grad),
                   torch.from_numpy(hess), torch.from_numpy(mask),
                   _meta(c["missing"], TMeta),
                   TConfig(num_leaves=LEAVES, max_depth=depth, hp=THP(**HP),
                           num_bins=B, round_width=WIDTH),
                   feature_mask=(None if fmask is None
                                 else torch.tensor(fmask,
                                                   dtype=torch.float32)),
                   rounds=rounds)
    return jt, np.asarray(jl), tt.to_numpy(), tl.numpy(), rounds


@pytest.fixture(scope="module")
def grown():
    return {case: _grow(case) for case in CASES}


@pytest.mark.parametrize("case", list(CASES))
def test_same_structure(grown, case):
    jt, jl, tt, tl, _ = grown[case]
    assert int(jt.num_leaves) == tt["num_leaves"]
    for name in STRUCTURE:
        assert np.array_equal(np.asarray(getattr(jt, name)), tt[name]), name
    assert np.array_equal(jl, tl)
    np.testing.assert_allclose(tt["leaf_value"], np.asarray(jt.leaf_value),
                               rtol=3e-5, atol=1e-7)


@pytest.mark.parametrize("case", [c for c in CASES if CASES[c]["dyadic"]])
def test_dyadic_tree_is_equal(grown, case):
    jt, _, tt, _, _ = grown[case]
    for name in STRUCTURE + VALUES:
        assert np.array_equal(np.asarray(getattr(jt, name)), tt[name]), name


def test_rounds_roll_back_to_the_exact_prefix(grown):
    """Rounds where a child outranks the round's weakest candidate commit
    only the best-first prefix; the trees above still match."""
    logs = [grown[c][4] for c in CASES]
    assert any(m < k for log in logs for k, m in log)
    for log in logs:
        assert all(1 <= m <= k <= WIDTH for k, m in log)
        assert sum(m for _, m in log) <= LEAVES - 1


def test_bagged_rows_still_route(grown):
    """Rows with weight 0 add nothing to any histogram but still get a
    leaf (their scores are updated too)."""
    _, jl, tt, tl, _ = grown["dyadic_bagged"]
    assert tt["num_leaves"] > 1
    assert np.array_equal(jl, tl)
    assert tl.min() >= 0 and tl.max() < tt["num_leaves"]


def test_masked_features_never_split(grown):
    _, _, tt, _, _ = grown["dyadic_masked_depth"]
    used = tt["split_feature"][:tt["num_leaves"] - 1]
    assert not np.isin(used, [1, 4]).any()
    assert tt["leaf_depth"][:tt["num_leaves"]].max() <= 3
