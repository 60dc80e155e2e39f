"""The port's traversal (lightgbm_tpu_torch/ops/predict_kernels.py) held
against the JAX package's (lightgbm_tpu/ops/predict_kernels.py).

On the CPU ``fused_traverse`` runs its plain torch version; the JAX
``fused_traverse`` runs its Pallas kernel in interpret mode.  Both must
give the same leaf ids exactly and the same float32 scores bit for bit:
the two sum leaf values in the same pinned tree order with adds only.
The CUDA kernel itself is held against the plain version on the card by
chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lightgbm_tpu as lgb
from lightgbm_tpu.ops import predict_kernels as jpk
from lightgbm_tpu.predict import DeviceForest as JaxDeviceForest

import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch.convert import stacked_forest_from_numpy
from lightgbm_tpu_torch.ops import planner as tplanner
from lightgbm_tpu_torch.ops import predict_kernels as tpk
from lightgbm_tpu_torch.predict import DeviceForest
from lightgbm_tpu_torch.testing import (salt_rows, synthetic_model_text,
                                        synthetic_rows)
from lightgbm_tpu_torch.testing import one_thread  # noqa: F401

# 300 rows: the JAX kernel's last 128-row tile is ragged
ROWS = 300
TILE = 128

# name -> (features, iterations, leaves, classes, categorical, missing)
FORESTS = {
    "cat_nan": (6, 12, 15, 1, (0, 3), (2,)),
    "zero_missing": (5, 12, 15, 1, (), (1,)),
    "no_missing": (5, 12, 15, 1, (), (0,)),
    "multiclass": (7, 8, 31, 3, (2,), (0, 1, 2)),
}


def _pair(name):
    F, iters, leaves, K, cats, mts = FORESTS[name]
    text = synthetic_model_text(F, iters, leaves, K, cat_features=cats,
                                seed=11, missing_types=mts)
    X = salt_rows(synthetic_rows(F, ROWS, cats, seed=11, missing_types=mts))
    jb = lgb.Booster(model_str=text)
    tb = lt.Booster(model_str=text, device="cpu")
    jdev = JaxDeviceForest(jb._forest(0, iters), chunk_rows=4096,
                           variant="fused", tile_rows=TILE)
    tdev = tb._device_forest(tb._forest(0, iters))
    return jdev, tdev, X.astype(np.float32), K


@pytest.fixture(scope="module", params=sorted(FORESTS))
def pair(request):
    return _pair(request.param)


def test_leaves_match_jax(pair):
    jdev, tdev, X, _K = pair
    want = np.asarray(jpk.fused_traverse(jdev, X, tile_rows=TILE,
                                         interpret=True))
    assert np.array_equal(want, np.asarray(jpk.leaves_while(
        jdev, jnp.asarray(X))))
    Xt = torch.from_numpy(X)
    for got in (tpk.fused_traverse(tdev, Xt), tpk.leaves_fori(tdev, Xt),
                tpk.leaves_while(tdev, Xt)):
        assert got.dtype == torch.int32
        assert np.array_equal(got.numpy(), want)


def test_scores_match_jax_bitwise(pair):
    jdev, tdev, X, K = pair
    want = np.asarray(jpk.fused_traverse(jdev, X, tile_rows=TILE,
                                         num_class=K, emit_scores=True,
                                         interpret=True))
    got = tpk.fused_traverse(tdev, torch.from_numpy(X), K,
                             emit_scores=True).numpy()
    assert got.shape == (K, ROWS) and got.dtype == np.float32
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))


def _one_cat_split_text(words):
    """One categorical split (feature 0, bitset ``words``) + one numeric
    zero-missing split on feature 1, three leaves."""
    cat_thr = " ".join(str(int(w)) for w in words)
    return (
        "tree\nversion=v3\nnum_class=1\nnum_tree_per_iteration=1\n"
        "label_index=0\nmax_feature_idx=1\nobjective=binary sigmoid:1\n"
        "feature_names=c x\nfeature_infos=0:1 [-1:1]\ntree_sizes=1\n\n"
        "Tree=0\nnum_leaves=3\nnum_cat=1\nsplit_feature=0 1\n"
        "split_gain=1 1\nthreshold=0 0.25\ndecision_type=9 6\n"
        "left_child=-1 -2\nright_child=1 -3\nleaf_value=0.5 -0.25 1\n"
        "leaf_weight=1 1 1\nleaf_count=1 1 1\ninternal_value=0 0\n"
        "internal_weight=1 1\ninternal_count=3 2\n"
        f"cat_boundaries=0 {len(words)}\ncat_threshold={cat_thr}\n"
        "shrinkage=1\n\nend of trees\n")


def test_categorical_cast_and_high_bits():
    """Values the int32 cast cannot hold (torch's cast is undefined on
    the CPU, XLA saturates: the port clamps first) and bitset words with
    bit 31 set (negative as int32, shifted logically in int64)."""
    words = [(1 << 31) | 1, 1 << 31, 5]         # categories 0, 31, 63, 64, 66
    text = _one_cat_split_text(words)
    special = [1e30, -1e30, 3e9, -3e9, np.inf, -np.inf, 2147483647.0,
               np.nan, -0.9, 31.9, 32.0, 63.0, 64.0, 66.0, 95.0, 96.0]
    cat = np.array(special + list(range(0, 100)), np.float64)
    X = np.column_stack([cat, np.resize([0.0, 1e-36, 0.3, np.nan, -2.0],
                                        cat.size)]).astype(np.float32)
    jb = lgb.Booster(model_str=text)
    tb = lt.Booster(model_str=text, device="cpu")
    jdev = JaxDeviceForest(jb._forest(0, 1), chunk_rows=4096,
                           variant="fused", tile_rows=TILE)
    tdev = tb._device_forest(tb._forest(0, 1))
    want = np.asarray(jpk.fused_traverse(jdev, X, tile_rows=TILE,
                                         interpret=True))
    got = tpk.fused_traverse(tdev, torch.from_numpy(X)).numpy()
    assert np.array_equal(got, want)
    # and the host float64 path agrees on the same rows
    host = tb.predict(X.astype(np.float64), pred_leaf=True, device=False)
    assert np.array_equal(host.T, want)
    in_set = {0, 31, 63, 64, 66}
    for i, v in enumerate(cat):
        iv = int(np.trunc(v)) if np.isfinite(v) else -1
        if iv in in_set and v > -1:
            assert got[0, i] == 0, v            # categorical split: left
        else:
            assert got[0, i] != 0, v


def test_threshold_round_down_at_the_boundary():
    """Rows sitting exactly on the float32 neighbours of float64
    thresholds: routing on f32 thresholds rounded DOWN matches the host
    float64 path (rounding to nearest would send x == f32(t) > t left)."""
    F, iters, leaves, K, cats, mts = FORESTS["no_missing"]
    text = synthetic_model_text(F, iters, leaves, K, cat_features=cats,
                                seed=11, missing_types=mts)
    tb = lt.Booster(model_str=text, device="cpu")
    forest = tb._forest(0, iters)
    num = ~forest.is_cat & np.isfinite(forest.threshold)
    thr = forest.threshold[num]
    feat = forest.split_feature[num]
    near = thr.astype(np.float32)
    assert (near.astype(np.float64) > thr).any()   # the case that matters
    rng = np.random.RandomState(0)
    X = synthetic_rows(F, 256, cats, seed=11, missing_types=mts)
    for i in range(X.shape[0]):
        for f in range(F):
            cand = near[feat == f]
            if cand.size:
                v = cand[rng.randint(cand.size)]
                X[i, f] = np.nextafter(v, np.float32(rng.choice(
                    [-np.inf, np.inf])), dtype=np.float32) if i % 3 == 0 else v
    host = forest.predict_leaf(X)
    got = tb._device_forest(forest).predict_leaf(X)
    assert np.array_equal(got, host)


def test_cat_offset_int64_to_int32_planes():
    """``cat_offset`` is int64 in StackedForest and int32 in the kernel
    planes: values carry over exactly, and one past int32 is refused."""
    F, iters, leaves, K, cats, mts = FORESTS["multiclass"]
    text = synthetic_model_text(F, iters, leaves, K, cat_features=cats,
                                seed=11, missing_types=mts)
    forest = lgb.Booster(model_str=text)._forest(0, iters)
    assert forest.cat_offset.dtype == np.int64
    arrays = {k: getattr(forest, k) for k in (
        "split_feature", "threshold", "left", "right", "is_cat",
        "default_left", "missing_type", "leaf_value", "depth", "cat_offset",
        "cat_nwords", "cat_words", "has_cat", "max_depth")}
    tdev = DeviceForest(stacked_forest_from_numpy(arrays), "cpu")
    assert tdev.cat_offset.dtype == torch.int32
    assert np.array_equal(tdev.cat_offset.numpy(), forest.cat_offset)
    assert tdev.cat_words.dtype == torch.int32
    assert np.array_equal(tdev.cat_words.numpy().view(np.uint32),
                          forest.cat_words)
    arrays["cat_offset"] = forest.cat_offset.copy()
    arrays["cat_offset"][0, 0] = 2 ** 31
    with pytest.raises(ValueError, match="int32"):
        DeviceForest(stacked_forest_from_numpy(arrays), "cpu")


def test_wrapper_checks_its_input(pair):
    _jdev, tdev, X, K = pair
    Xt = torch.from_numpy(X)
    with pytest.raises(ValueError, match="float32"):
        tpk.fused_traverse(tdev, Xt.double())
    with pytest.raises(ValueError, match="contiguous"):
        tpk.fused_traverse(tdev, torch.from_numpy(np.asfortranarray(X)))
    with pytest.raises(ValueError, match="features"):
        tpk.fused_traverse(tdev, Xt[:, :1].contiguous())
    before = dict(tpk.launch_counts)
    tpk.fused_traverse(tdev, Xt, K, emit_scores=True)
    tpk.fused_traverse(tdev, Xt, K)
    # the plain version on the CPU is not a kernel launch, in either mode
    assert tpk.launch_counts == before
    assert set(before) == {"fused_traverse", "fused_traverse[leaves]",
                           "fused_traverse[scores]"}


def test_planner_tiles():
    """The traversal block's X tile: 128 rows of 28 features, halved
    until it fits ``TRAV_X_BYTES`` (64 rows of 136), and refused when one
    row exceeds the card's per-block maximum."""
    assert tplanner.traverse_plan(28, 254, 500, 4096).rows == 128
    assert tplanner.traverse_plan(136, 254, 500, 4096).rows == 64
    with pytest.raises(ValueError):
        tplanner.traverse_plan(100_000, 254, 500, 4096)
