"""The design of the port's traversal kernel B1 (csrc/traverse.cu) held
on the CPU against its plain version and the JAX package.

The CUDA kernel runs only on the card (chip_smoke.py holds it there, bit
for bit, against ``traverse_plain``).  These tests hold what it is built
from:

- ``pack_nodes``: the 16-byte node records round-trip every plane;
- a model of the kernel's descent over the packed records (one record a
  level, the flags decoded from the first word, the categorical record
  read only for a categorical node, the early stop at a leaf) gives the
  leaf ids of ``traverse_plain`` and of the JAX package's
  ``fused_traverse`` in interpret mode, exactly;
- a model of the two-phase scores mode (per-(tree, row) leaf values, then
  per (class, row) a t-ordered f32 sum, tree chunk by tree chunk, with
  the kernel's loop bounds) equals ``pinned_leaf_sum`` and the JAX
  package's scores bit for bit, at K = 1 and K = 5;
- ``planner.traverse_plan``: the budgets, and the global-record path
  where the trees do not fit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lightgbm_tpu as lgb
from lightgbm_tpu.ops import predict_kernels as jpk
from lightgbm_tpu.predict import DeviceForest as JaxDeviceForest

import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch.ops import planner
from lightgbm_tpu_torch.ops import predict_kernels as tpk
from lightgbm_tpu_torch.testing import (salt_rows, synthetic_model_text,
                                        synthetic_rows)
from lightgbm_tpu_torch.testing import one_thread  # noqa: F401

ROWS = 300
TILE = 128
MASK32 = 0xFFFFFFFF

# name -> (features, iterations, leaves, classes, categorical, missing)
FORESTS = {
    "numeric": (6, 40, 15, 1, (), (0, 1, 2)),
    "categorical": (6, 40, 15, 1, (0, 3), (2, 1)),
    "multiclass5": (7, 8, 31, 5, (2,), (0, 1, 2)),
}
# values the categorical cast and the bitset test must survive
EDGE_VALUES = (1e30, -1e30, 2147483520.0, -2147483520.0, 3e9, np.inf,
               -np.inf, np.nan, -0.9, 31.9, 32.0, 1e-36, -1e-36)


def _case(name):
    F, iters, leaves, K, cats, mts = FORESTS[name]
    text = synthetic_model_text(F, iters, leaves, K, cat_features=cats,
                                seed=13, missing_types=mts)
    X = salt_rows(synthetic_rows(F, ROWS, cats, seed=13, missing_types=mts))
    rng = np.random.RandomState(5)
    for i in range(6, 6 + 3 * len(EDGE_VALUES)):    # edge values, mixed in
        X[i, rng.randint(F)] = EDGE_VALUES[i % len(EDGE_VALUES)]
    X = X.astype(np.float32)
    jb = lgb.Booster(model_str=text)
    tb = lt.Booster(model_str=text, device="cpu")
    jdev = JaxDeviceForest(jb._forest(0, iters), chunk_rows=4096,
                           variant="fused", tile_rows=TILE)
    tdev = tb._device_forest(tb._forest(0, iters))
    want = np.asarray(jpk.fused_traverse(jdev, X, tile_rows=TILE,
                                         interpret=True))
    want_s = np.asarray(jpk.fused_traverse(jdev, X, tile_rows=TILE,
                                           num_class=K, emit_scores=True,
                                           interpret=True))
    return tdev, X, K, want, want_s


@pytest.fixture(scope="module", params=sorted(FORESTS))
def case(request):
    return _case(request.param)


def _unpack(nodes, cats):
    """The planes back from the records (the kernel's decoding)."""
    x = nodes[..., 0].to(torch.int64) & MASK32
    planes = {
        "split_feature": x & ((1 << tpk.FEATURE_BITS) - 1),
        "missing_type": (x >> 28) & 3,
        "default_left": (x >> 30) & 1,
        "is_cat": (x >> 31) & 1,
        "threshold": nodes[..., 1].contiguous().view(torch.float32),
        "left": nodes[..., 2],
        "right": nodes[..., 3],
    }
    if cats.shape[:2] == nodes.shape[:2]:
        planes["cat_offset"] = cats[..., 0]
        planes["cat_nwords"] = cats[..., 1]
    return planes


def descend_packed(nodes, cats, cw, X, depth):
    """Model of ``descend`` in csrc/traverse.cu over every (tree, row)
    pair: one record a level, decoded from its first word; a categorical
    node reads its (offset, words) record and one bitset word; a pair
    stops at its leaf.  Returns leaf ids [T, n]."""
    T = nodes.shape[0]
    n = X.shape[0]
    t = torch.arange(T)[:, None].expand(T, n)
    r = torch.arange(n)[None, :].expand(T, n)
    node = torch.zeros((T, n), dtype=torch.int64)
    words = cw.to(torch.int64) & MASK32
    for _ in range(max(depth, 1)):
        live = node >= 0
        if not bool(live.any()):
            break
        nd = node.clamp_min(0)
        rec = nodes[t, nd].to(torch.int64)                     # [T, n, 4]
        x = rec[..., 0] & MASK32
        m = (x >> 28) & 3
        v = X[r, x & ((1 << tpk.FEATURE_BITS) - 1)]
        nan = torch.isnan(v)
        fz = torch.where(nan & (m != 2), torch.zeros_like(v), v)
        missing = ((m == 1) & (fz.abs() <= tpk.K_ZERO_F32)) | ((m == 2) & nan)
        thr = nodes[t, nd, 1].contiguous().view(torch.float32)
        go_left = torch.where(missing, ((x >> 30) & 1) != 0, fz <= thr)
        cat = (x >> 31) == 1
        if bool((cat & live).any()):
            c = cats[t, nd].to(torch.int64)
            tv = torch.where(nan, torch.full_like(v, -1.0), v).trunc()
            iv = tv.clamp(-1.0, 2147483520.0).to(torch.int64)
            nw = c[..., 1]
            valid = (iv >= 0) & (iv < nw * 32)
            ivc = iv.clamp_min(0)
            widx = c[..., 0] + torch.minimum(ivc >> 5, (nw - 1).clamp_min(0))
            widx = widx.clamp(0, words.numel() - 1)
            bit = (words[widx] >> (ivc & 31)) & 1
            go_left = torch.where(cat, valid & (bit == 1), go_left)
        nxt = torch.where(go_left, rec[..., 2], rec[..., 3])
        node = torch.where(live, nxt, node)
    return (~node).to(torch.int32)


def sum_two_phase(leaf_value, leaves, K, chunk):
    """Model of scores mode: the descents' leaf values [T, n] (the
    scratch), then ordered_sum_kernel's thread (k, r) adds the trees of
    class k of each chunk of ``chunk`` trees in ascending order, from the
    kernel's first index
    ``c0 + (k - c0 % K + K) % K`` in steps of K, into an f32
    accumulator."""
    T, n = leaves.shape
    vals = leaf_value[torch.arange(T)[:, None], leaves.long()]
    acc = torch.zeros((K, n), dtype=torch.float32)
    for c0 in range(0, T, chunk):
        c = min(chunk, T - c0)
        for k in range(K):
            t = c0 + (k - c0 % K + K) % K
            while t < c0 + c:
                acc[k] = acc[k] + vals[t]
                t += K
    return acc


def test_pack_nodes_round_trips_every_plane(case):
    dev = case[0]
    nodes, cats = tpk.pack_nodes(dev)
    T, I = dev.split_feature.shape
    assert nodes.dtype == torch.int32 and nodes.shape == (T, I, 4)
    assert torch.equal(nodes, dev.nodes) and torch.equal(cats,
                                                         dev.cat_records)
    planes = _unpack(nodes, cats)
    for name, got in planes.items():
        want = getattr(dev, name)
        if name == "threshold":
            assert torch.equal(got.view(torch.int32), want.view(torch.int32))
        else:
            assert torch.equal(got.to(torch.int64), want.to(torch.int64)), \
                name
    assert ("cat_offset" in planes) == bool(dev.forest.has_cat)
    # the forest has what the records must carry
    mts = set(dev.missing_type.unique().tolist())
    assert {0, 1, 2} & mts and int(dev.default_left.sum()) > 0
    assert bool(((dev.left == -1) & (dev.right == -1)).any()), \
        "no single-leaf sentinel in the forest"


def test_pack_nodes_refuses_unpackable_planes(case):
    dev = case[0]

    class Wide:
        pass
    w = Wide()
    for k in ("split_feature", "missing_type", "default_left", "is_cat",
              "left", "right", "cat_offset", "cat_nwords", "threshold",
              "forest"):
        setattr(w, k, getattr(dev, k))
    w.split_feature = dev.split_feature.clone()
    w.split_feature[0, 0] = 1 << tpk.FEATURE_BITS
    with pytest.raises(ValueError, match="split features"):
        tpk.pack_nodes(w)
    w.split_feature = dev.split_feature
    w.missing_type = dev.missing_type.clone()
    w.missing_type[0, 0] = 4
    with pytest.raises(ValueError, match="missing types"):
        tpk.pack_nodes(w)


def test_packed_descent_matches_plain_and_jax(case):
    dev, X, _K, want, _ = case
    Xt = torch.from_numpy(X)
    got = descend_packed(dev.nodes, dev.cat_records, dev.cat_words, Xt,
                         int(dev.forest.max_depth))
    assert np.array_equal(got.numpy(), want)
    assert torch.equal(got, tpk.traverse_plain(dev, Xt))


def test_packed_descent_categorical_edges():
    """Categorical values at the 2**31 scale, infinities, NaN and
    negatives, through the packed records, against the JAX package."""
    words = [(1 << 31) | 1, 1 << 31, 5]
    cat_thr = " ".join(str(int(w)) for w in words)
    text = (
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
    cat = np.array(list(EDGE_VALUES) + [2147483647.0, -3e9, 63.0, 64.0,
                                        66.0, 95.0] + list(range(100)),
                   np.float64)
    X = np.column_stack([cat, np.resize([0.0, 1e-36, 0.3, np.nan, -2.0],
                                        cat.size)]).astype(np.float32)
    jdev = JaxDeviceForest(lgb.Booster(model_str=text)._forest(0, 1),
                           chunk_rows=4096, variant="fused", tile_rows=TILE)
    tb = lt.Booster(model_str=text, device="cpu")
    dev = tb._device_forest(tb._forest(0, 1))
    want = np.asarray(jpk.fused_traverse(jdev, X, tile_rows=TILE,
                                         interpret=True))
    got = descend_packed(dev.nodes, dev.cat_records, dev.cat_words,
                         torch.from_numpy(X), int(dev.forest.max_depth))
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("chunk", [1, 7, 18, 64, 1000])
def test_two_phase_scores_bitwise(case, chunk):
    """The descents' leaf values summed per (class, row) in tree order,
    chunk by chunk, are ``pinned_leaf_sum`` and the JAX scores, bit for
    bit (K = 1, and K = 5 with T/K iterations, class t % K)."""
    dev, X, K, want, want_s = case
    leaves = torch.from_numpy(want)
    got = sum_two_phase(dev.leaf_value, leaves, K, chunk)
    pinned = tpk.pinned_leaf_sum(dev.leaf_value, leaves, K)
    assert got.shape == (K, X.shape[0])
    assert torch.equal(got.view(torch.int32), pinned.view(torch.int32))
    assert np.array_equal(got.numpy().view(np.uint32), want_s.view(np.uint32))


def test_scores_are_not_a_reassociated_sum(case):
    """The pinned order matters: a pairwise (tree-parallel) sum of the
    same leaf values differs in bits somewhere, so the check above has
    teeth."""
    dev, X, K, want, _ = case
    T = want.shape[0]
    vals = dev.leaf_value[torch.arange(T)[:, None],
                          torch.from_numpy(want).long()]
    pairwise = vals.view(T // K, K, -1).sum(0)
    pinned = tpk.pinned_leaf_sum(dev.leaf_value, torch.from_numpy(want), K)
    assert not torch.equal(pairwise.view(torch.int32),
                           pinned.view(torch.int32))


# (features, leaves): the HIGGS width, a wide table, and 2,000 features
@pytest.mark.parametrize("F", [28, 400, 2000])
@pytest.mark.parametrize("leaves", [31, 255, 4095])
@pytest.mark.parametrize("has_cat", [False, True])
def test_traverse_plan_budgets(F, leaves, has_cat):
    I = leaves - 1
    rec = planner.NODE_RECORD_BYTES + (planner.CAT_RECORD_BYTES
                                       if has_cat else 0)
    for n in (1, 8, 64, 101, 1024, 65536):
        for scores in (False, True):
            K = 5 if scores else 1
            p = planner.traverse_plan(F, I, 500, n, has_cat, K, scores)
            R, G = p.rows, p.trees
            tiles = -(-n // R)
            large = tiles >= planner.TRAV_LARGE_TILES
            assert p.scores == scores
            assert R & (R - 1) == 0 and R <= planner.TRAV_TILE_ROWS
            assert R <= max(1, 1 << (n - 1).bit_length())
            assert R * F * 4 <= planner.TRAV_X_BYTES
            assert 1 <= G <= 500
            assert p.threads % 32 == 0 and 32 <= p.threads <= 256
            assert p.smem_bytes == R * F * 4 + (G * I * rec if p.stage
                                                else 0)
            if p.stage:
                assert p.smem_bytes <= planner.TRAV_SMEM_BYTES
            else:
                # a block holds at least a warp of (row, tree) pairs
                assert min(R, n) * G >= min(32, min(R, n) * 500)
            # about the target's blocks over the tree groups
            groups = -(-500 // G)
            target = (planner.TRAV_LARGE_TARGET_BLOCKS if large
                      else planner.TRAV_TARGET_BLOCKS)
            assert p.row_tiles >= 1
            assert -(-tiles // p.row_tiles) * groups <= target + groups
            if scores:
                assert p.sum_rows <= planner.SUM_ROWS
                assert p.sum_trees * p.sum_rows * 4 <= planner.SUM_TILE_BYTES
                assert (K + p.sum_trees) * p.sum_rows * 4 <= \
                    planner.SMEM_MAX_BYTES
            else:
                assert p.sum_rows == p.sum_trees == 0


def test_traverse_plan_paths():
    """Records are staged where the trees fit beside the X tile (at
    least two; for a large batch, all the block wants); trees of 4,095
    leaves and the HIGGS forest at a 65,536-row chunk read them from
    global memory; a forced staging that cannot fit raises."""
    p = planner.traverse_plan(28, 254, 500, 1024)
    assert p.stage and p.rows == 128 and p.trees == 8 and p.row_tiles == 1
    assert planner.traverse_plan(28, 254, 500, 8).stage
    assert not planner.traverse_plan(28, 4094, 500, 1024).stage
    assert not planner.traverse_plan(28, 4094, 500, 65536).stage
    big = planner.traverse_plan(28, 254, 500, 65536)
    assert not big.stage and big.trees == 30 and big.row_tiles == 2
    assert planner.traverse_plan(28, 30, 500, 65536, True).stage  # 31 leaves
    wide = planner.traverse_plan(400, 14, 10, 65536, True)
    assert wide.rows == 16 and wide.stage
    assert not planner.traverse_plan(400, 14, 10, 65536, stage=False).stage
    with pytest.raises(ValueError, match="fits"):
        planner.traverse_plan(28, 65534, 500, 1024, stage=True)
    # scores: a small batch spreads its descents over many blocks
    small = planner.traverse_plan(28, 254, 500, 8, scores=True)
    assert small.scores and small.trees == 4 and small.sum_trees == 500
    assert -(-500 // small.trees) >= planner.SM_COUNT // 2


def test_wrapper_checks_the_plan(case):
    """A plan of the other mode is refused; on the CPU the wrapper runs
    the plain version whatever plan it is given."""
    dev, X, K, _, _ = case
    Xt = torch.from_numpy(X)
    F, I, T, n = X.shape[1], dev.split_feature.shape[1], dev.num_trees, \
        X.shape[0]
    leaves_plan = planner.traverse_plan(F, I, T, n)
    scores_plan = planner.traverse_plan(F, I, T, n, False, K, True)
    assert not leaves_plan.scores and scores_plan.scores
    assert torch.equal(tpk.fused_traverse(dev, Xt, plan=leaves_plan),
                       tpk.traverse_plain(dev, Xt))
    assert torch.equal(
        tpk.fused_traverse(dev, Xt, K, emit_scores=True, plan=scores_plan),
        tpk.traverse_plain(dev, Xt, K, emit_scores=True))
    with pytest.raises(ValueError, match="does not emit scores"):
        tpk.fused_traverse(dev, Xt, K, emit_scores=True, plan=leaves_plan)
    with pytest.raises(ValueError, match="does not emit leaf ids"):
        tpk.fused_traverse(dev, Xt, plan=scores_plan)
