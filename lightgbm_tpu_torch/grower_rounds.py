"""Batched-frontier leaf-wise tree growth (counterpart of the unsharded
arms of ``lightgbm_tpu/grower_rounds.py``).

Same semantics as LightGBM's best-first growth (reference:
src/treelearner/serial_tree_learner.cpp:149-193), a ROUND of splits at a
time: each round applies the top ``k = min(#positive-gain leaves, leaf
budget, KCAP)`` candidates in (gain desc, leaf asc) order, which is the
sequence best-first would produce provided no child created by the round
outranks the round's weakest applied candidate.  That proviso is checked
after the children's best splits are known; the round commits only the
maximal exact prefix (at least one split: the single best-first step).
Trees, node and leaf numbering included, are those of the serial grower.

The JAX package runs this as a ``lax.while_loop``; here it is a Python
loop that reads ``k`` and the committed prefix ``m`` on the host once per
round.  Per round: candidate ranking, row routing (one gather of each
row's split-feature bin, the EFB decode, the bitset test of categorical
splits), the smaller-child slot of every row, the histogram and split
search of both children of every candidate, the feature pick, the
exact-prefix check and the commit.  Two arms, as in the JAX package:

- **fused** (no EFB bundles, ``hist_method`` ``auto`` or ``fused``): the
  histogram -> split pair ``ops.fused.frontier_splits`` (B4 then B5) on
  the [F, n] matrix.  The root histogram is B4 with slot 0 for every
  member row.  Categorical columns are searched on their slice of the
  derived children (``ops.split._best_categorical``) and merged over the
  kernel's numeric tuples (``pick_fused_best``).
- **staged** (bundles, or any other ``hist_method`` name): histograms of
  the [G, n] group matrix at the group bin axis Bg; the root is B6
  (``ops.histogram.histogram_fixed``), each round's smaller children B4
  (the segment histogram); siblings are ``parent - small`` in int64;
  ``ops.split.best_split_for_leaf`` searches the children's group
  histograms: B5 in leaf mode reads each feature's bins from them (bin
  0 rebuilt from the exact totals; ``ops.fused.GroupLayout``), and only
  the categorical columns are expanded to [3, Fc, B] per-feature
  histograms for the categorical search (``ops.fused.expand_groups``).

Histograms are exact int64 fixed point at one scale per channel and tree
(``ops/histogram.py``); the cache [L, 3, G, Bg] stays in int64, so every
sibling ``parent - small`` is exact.  Leaf sums and gains are f32 from
the scans, as in the JAX package.

Quantized training (``cfg.quant``, ``quant_vals`` from
``ops.histogram.quantize_gradients``): histograms hold the int32 sums
of the int8 (grad, hess) levels, [.., 2, G, Bg], and the scans take
``ops.split.QuantScales``, estimating each bin's count from its hess
sum.  The root is B4 in int8 mode with one slot for the member rows on
both arms (root sums ``f32(sum q) * scale``, root count the member
rows); the fused arm runs B2 in int8 mode, and its categorical merge
adds the estimated counts to the categorical slices first; the staged
arm runs B4 int8 for the segments and B5 in leaf mode on the integer
group histograms (bin 0 rebuilt in integers, before the count estimate:
the JAX package rebuilds it after its f32 rescale, ROADMAP queue C).
``cfg.quant_renew`` re-fits the leaf outputs from the true gradient
sums (``ops.renew.quant_train_renew_leaf``).

Monotone constraints (``monotone_constraints`` [F]) ride both arms, as
in the JAX package: every leaf carries output bounds ``leaf_min`` /
``leaf_max`` (from -inf/+inf); a candidate's children inherit them,
narrowed at the midpoint of the candidate's clamped child outputs on a
numeric split of a constrained feature (``child_bounds``); the scans
(B5 on both arms, B2 on the fused one) take the constraints and the
children's bounds, and the final leaf values are clamped to the bounds.

Per-node randomness (``hp.extra_trees``, ``cfg.bynode_feature_cnt``)
elects the staged arm, as in the JAX package; its root is then B6 even
without bundles.  Each searched node draws from its own threefry key,
``fold_in(fold_in(rng_key, parent + 1), side)`` with the node's parent
id and side (the root: parent -1, side 0; a round's candidate i:
``split_idx + i``, side 0 for its left child and 1 for its right): the
bynode feature mask from ``uniform(fold_in(key, 0), (F,))`` and the
extra-trees uniforms ``uniform(fold_in(key, 1), (F, 2))`` (column 0 the
numeric threshold B5 takes in leaf mode, column 1 the categorical
draw).  A node's id is at most ``num_leaves - 2``, so the draws of every
node a tree can search are made in one vectorised call when the tree
starts (``node_draws``, ~1,000 tensor operations of threefry) and each
search gathers its nodes' rows (a call a round cost 1.12 s of launches
a 255-leaf tree: ``chip_smoke.py`` ``rand_train``, NVIDIA H100 80GB
HBM3, 700.00 W).
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch

from .grower import (GrowerConfig, TreeArrays, _LeafBest, feature_bin,
                     row_goes_left)
from .ops import fused
from .ops.histogram import (_vals_t, _vals_t_int, fixed_point_scales,
                            histogram_fixed)
from .ops.split import (QuantScales, SplitResult, _best_categorical,
                        best_split_for_leaf, clip, fixed_to_f32, leaf_output,
                        quant_count_hist)
from .utils import threefry


def group_layout(meta_t: dict, num_bins: int) -> fused.GroupLayout:
    """Where the dataset's group histograms keep each feature, for B5's
    grouped leaf mode and ``ops.fused.expand_groups``."""
    return fused.GroupLayout(meta_t["feat_group"], meta_t["feat_start"],
                             int(num_bins))


def _rows(r: SplitResult, sl) -> SplitResult:
    return SplitResult(*(getattr(r, f)[sl] for f in r._fields))


def node_draws(rng_key, parents: torch.Tensor, sides: torch.Tensor,
               num_features: int, bynode_cnt: int, extra_trees: bool):
    """Per-node randomness of the searched nodes (reference:
    grower_rounds.py one_leaf_best): the node keys
    ``fold_in(fold_in(rng_key, parent + 1), side)``, then the bynode
    mask [N, F] f32 (the ``bynode_cnt`` smallest of ``uniform(fold_in(key,
    0), (F,))``, ties kept) and the extra-trees uniforms [N, F, 2]
    (``uniform(fold_in(key, 1), (F, 2))``); None for a mode that is
    off."""
    F = int(num_features)
    keys = threefry.fold_in(threefry.fold_in(
        threefry.key_tensor(rng_key, parents.device),
        parents.to(torch.int64) + 1), sides.to(torch.int64))
    mask = eru = None
    if bynode_cnt > 0:
        u = threefry.uniform(threefry.fold_in(keys, 0), (F,))
        kth = torch.kthvalue(u, min(int(bynode_cnt), F), dim=-1).values
        mask = (u <= kth[:, None]).to(torch.float32)
    if extra_trees:
        eru = threefry.uniform(threefry.fold_in(keys, 1), (F, 2))
    return mask, eru


def grow_tree_rounds(binned_t: torch.Tensor, grad: torch.Tensor,
                     hess: torch.Tensor, row_mask: torch.Tensor, meta,
                     cfg: GrowerConfig,
                     feature_mask: Optional[torch.Tensor] = None,
                     meta_t: Optional[dict] = None, timer=None,
                     rounds: Optional[list] = None,
                     quant_vals: Optional[tuple] = None,
                     monotone_constraints: Optional[torch.Tensor] = None,
                     rng_key=None):
    """Grow one tree.  ``binned_t`` [G, n] uint8/int32 (the EFB group
    matrix), ``grad``/``hess``/``row_mask`` [n] f32 on the same device;
    ``feature_mask`` [F] (0 = feature not sampled); ``timer`` a
    ``utils.timer.SectionTimer``; ``rounds``, when given, gets one
    ``(k, m)`` per round: candidates, and splits committed (m < k is a
    rollback to the exact prefix); ``quant_vals`` (``cfg.quant``): ``(gq,
    hq, g_scale, h_scale)`` from ``ops.histogram.quantize_gradients``;
    ``monotone_constraints`` [F] int32 in {-1, 0, 1} (used features);
    ``rng_key`` the tree's threefry key (a pair of ints) for per-node
    randomness, ``PRNGKey(0)`` when that is on and no key is given.
    Returns (TreeArrays, leaf_id [n] int64)."""
    meta = meta.resolved()
    dev = binned_t.device
    G, n = binned_t.shape
    L = cfg.num_leaves
    B = cfg.num_bins
    hp = cfg.hp
    F = len(meta.num_bin)
    use_mc = monotone_constraints is not None
    use_rng = hp.extra_trees or cfg.bynode_feature_cnt > 0
    if use_rng and rng_key is None:
        rng_key = threefry.prng_key(0)
    # the JAX trainer's arm election (boosting/gbdt.py:690-707,
    # grower_rounds.py:168) for the configurations the port trains
    fused_arm = (cfg.hist_method in ("auto", "fused")
                 and not meta.has_bundles and not use_rng)
    Bg = meta.max_group_bin if meta.has_bundles else B
    KCAP = min(max(L - 1, 1), max(1, cfg.round_width))
    mt = meta_t if meta_t is not None else meta.tensors(dev)
    num_bin, missing_type, default_bin = (
        mt["num_bin"], mt["missing_type"], mt["default_bin"])
    is_cat = torch.as_tensor(meta.is_categorical, device=dev)
    cat_idx = torch.nonzero(is_cat).flatten() if is_cat.any() else None
    groups = group_layout(mt, B) if meta.has_bundles else None
    # B5's warp tasks, planned once a tree from the host meta
    scan_plan = fused.scan_tasks(meta.num_bin, B, dev)
    if timer is None:
        def section(_name):
            return contextlib.nullcontext()
    else:
        section = timer.section
    neg_inf = torch.tensor(-float("inf"), dtype=torch.float32, device=dev)
    mc = (monotone_constraints.to(device=dev, dtype=torch.int32)
          if use_mc else None)
    if use_rng:
        with section("draws"):
            # every (parent, side) a tree can search: parent -1 (the
            # root) .. L - 2, row (parent + 1) * 2 + side
            ids = torch.arange(-1, L - 1, device=dev).repeat_interleave(2)
            all_mask, all_eru = node_draws(
                rng_key, ids, torch.arange(2, device=dev).repeat(L), F,
                cfg.bynode_feature_cnt, hp.extra_trees)

    def search(ghist: torch.Tensor, sums: torch.Tensor, bounds=None,
               parents=None, sides=None) -> SplitResult:
        """Best splits of children given their group histograms
        [NC, 3, G, Bg] int64 and totals [3, NC] f32 (the staged arm's
        search, and both arms' root; B5 reads the groups themselves);
        ``bounds`` ([NC], [NC]) their output bounds (monotone
        constraints), ``parents``/``sides`` [NC] their node ids (per-node
        randomness)."""
        fm, eru = feature_mask, None
        if use_rng:
            with section("draws"):
                row = (parents + 1) * 2 + sides
                if all_mask is not None:
                    fm = all_mask[row] if fm is None else \
                        fm[None, :] * all_mask[row]
                if all_eru is not None:
                    eru = all_eru[row]
        with section("kernels"):
            return best_split_for_leaf(ghist, scales, sums[0], sums[1],
                                       sums[2], num_bin, missing_type,
                                       default_bin, is_cat, hp, fm, mc,
                                       bounds, eru, groups, scan_plan)

    with section("kernels"):
        member = row_mask > 0
        slot0 = torch.where(member, 0, 1).to(torch.int32)
        if cfg.quant:
            if quant_vals is None:
                raise ValueError("cfg.quant needs quant_vals=(gq, hq, "
                                 "g_scale, h_scale)")
            gq, hq, g_scale, h_scale = quant_vals
            vals = _vals_t_int(gq, hq, member).contiguous()
            scales = QuantScales(float(g_scale), float(h_scale))
            # B4 in int8 mode, slot 0 for every member row, on both arms
            root = fused.accumulate(binned_t, vals, slot0, 1, Bg)[0]
            qsum = vals.to(torch.int64).sum(1).to(torch.float32)
            root_sums = torch.stack([qsum[0] * g_scale, qsum[1] * h_scale,
                                     member.sum().to(torch.float32)])
        else:
            vals = _vals_t(grad, hess, row_mask).contiguous()
            scales = fixed_point_scales(vals)
            if fused_arm:
                # the accumulate kernel with slot 0 for every member row
                root = fused.accumulate(binned_t, vals, slot0, 1, B,
                                        scales)[0]
            else:
                root = histogram_fixed(binned_t, vals, Bg, scales)
            # group 0's bins partition the member rows: exact totals
            root_sums = fixed_to_f32(root[:, 0, :].sum(-1), scales, 0)
    leaf_min = torch.full((L,), -float("inf"), dtype=torch.float32,
                          device=dev)
    leaf_max = torch.full_like(leaf_min, float("inf"))
    root_ids = torch.tensor([-1], dtype=torch.int64, device=dev)
    r0 = search(root[None], root_sums[:, None],
                (leaf_min[:1], leaf_max[:1]) if use_mc else None,
                root_ids, torch.zeros_like(root_ids))

    tree = TreeArrays.empty(L, dev)
    best = _LeafBest.empty(L, dev)
    best.store(torch.zeros(1, dtype=torch.int64, device=dev), r0)
    hist = torch.zeros((L,) + tuple(root.shape), dtype=root.dtype,
                       device=dev)
    hist[0] = root
    leaf_sg = torch.zeros(L, dtype=torch.float32, device=dev)
    leaf_sh = torch.zeros_like(leaf_sg)
    leaf_cnt = torch.zeros_like(leaf_sg)
    leaf_sg[0], leaf_sh[0], leaf_cnt[0] = root_sums[0], root_sums[1], \
        root_sums[2]
    leaf_parent_side = torch.zeros(L, dtype=torch.int32, device=dev)
    leaf_id = torch.zeros(n, dtype=torch.int64, device=dev)
    iota_L = torch.arange(L, device=dev)
    num_leaves, split_idx = 1, 0

    def child_bounds(ids: torch.Tensor):
        """The bounds the two children of each leaf ``ids``' cached split
        inherit (reference: grower_rounds.py child_bounds): the parent's,
        narrowed at the midpoint of the clamped child outputs on a
        numeric split of a constrained feature."""
        b = best
        p_min, p_max = leaf_min[ids], leaf_max[ids]
        l_out = clip(leaf_output(b.left_sum_grad[ids], b.left_sum_hess[ids],
                                 hp.lambda_l1, hp.lambda_l2,
                                 hp.max_delta_step), p_min, p_max)
        r_out = clip(leaf_output(b.right_sum_grad[ids],
                                 b.right_sum_hess[ids], hp.lambda_l1,
                                 hp.lambda_l2, hp.max_delta_step),
                     p_min, p_max)
        mid = (l_out + r_out) * 0.5
        mc_f = mc[b.feature[ids].clamp(0, F - 1)]
        upd = ~b.is_categorical[ids] & (mc_f != 0)
        lo, hi = torch.maximum(p_min, mid), torch.minimum(p_max, mid)
        return (torch.where(upd & (mc_f < 0), lo, p_min),
                torch.where(upd & (mc_f > 0), hi, p_max),
                torch.where(upd & (mc_f > 0), lo, p_min),
                torch.where(upd & (mc_f < 0), hi, p_max))

    while split_idx < L - 1:
        with section("routing"):
            gains = torch.where(iota_L < num_leaves, best.gain, neg_inf)
            pos = gains > 0.0
            npos = int(pos.sum())
            if npos == 0:
                break
            k = min(npos, L - num_leaves, KCAP)
            # total order (gain desc, leaf asc) = successive best-first picks
            order = torch.argsort(-gains, stable=True)
            idl = order[:k]
            crank_leaf = torch.full((L,), k, dtype=torch.int64, device=dev)
            crank_leaf[idl] = torch.arange(k, device=dev)
            small_left_l = best.left_count <= best.right_count
            # every row's goes-left bit under its leaf's cached split
            crank = crank_leaf[leaf_id]
            f_r = best.feature[leaf_id]
            binf = feature_bin(binned_t, f_r, mt)
            gl = row_goes_left(binf, best.threshold[leaf_id],
                               best.default_left[leaf_id], missing_type[f_r],
                               default_bin[f_r], num_bin[f_r],
                               *((best.is_categorical[leaf_id],
                                  best.cat_bitset[leaf_id])
                                 if cat_idx is not None else ()))
            row_small = gl == small_left_l[leaf_id]
            slot = torch.where(row_small & (crank < k) & member, crank,
                               k).to(torch.int32)
            ph = hist[idl]
            b = best
            csums = torch.stack([
                torch.cat([b.left_sum_grad[idl], b.right_sum_grad[idl]]),
                torch.cat([b.left_sum_hess[idl], b.right_sum_hess[idl]]),
                torch.cat([b.left_count[idl], b.right_count[idl]])])
            cbounds = cb = None
            if use_mc:
                cb = child_bounds(idl)     # l_min, l_max, r_min, r_max
                cbounds = (torch.cat([cb[0], cb[2]]),
                           torch.cat([cb[1], cb[3]]))

        sl = small_left_l[idl]
        if fused_arm:
            with section("kernels"):
                seg, nfb = fused.frontier_splits(
                    binned_t, vals, slot, k, B, scales, csums, sl, ph,
                    num_bin, missing_type, default_bin, hp,
                    monotone_constraints=mc, child_bounds=cbounds,
                    plan=scan_plan)
                cat_best = None
                if cat_idx is not None:
                    # the categorical columns of both children, derived
                    # from the cached parents and the smaller children
                    sm_c, ph_c = seg[:, :, cat_idx], ph[:, :, cat_idx]
                    hl_c = torch.where(sl[:, None, None, None], sm_c,
                                       ph_c - sm_c)
                    chc = torch.cat([hl_c, ph_c - hl_c])
                    if cfg.quant:
                        chc = quant_count_hist(chc, csums[2])
                    cat_best = _best_categorical(
                        chc, scales, csums[0], csums[1], csums[2],
                        num_bin[cat_idx], missing_type[cat_idx], hp)
                res = fused.pick_fused_best(nfb, csums[0], csums[1],
                                            csums[2], feature_mask,
                                            cat_best, cat_idx)
        else:
            with section("kernels"):
                # the smaller children's segment histograms (B4)
                seg = fused.accumulate(binned_t, vals, slot, k, Bg, scales)
            with section("siblings"):
                h_left = torch.where(sl[:, None, None, None], seg, ph - seg)
                children = torch.cat([h_left, ph - h_left])
            node_k = split_idx + torch.arange(k, device=dev)
            res = search(children, csums, cbounds,
                         torch.cat([node_k, node_k]),
                         torch.cat([torch.zeros_like(node_k),
                                    torch.ones_like(node_k)]))

        with section("routing"):
            if cfg.max_depth > 0:
                depth_c = tree.leaf_depth[idl] + 1
                dd = torch.cat([depth_c, depth_c])
                res = res._replace(gain=torch.where(dd >= cfg.max_depth,
                                                    neg_inf, res.gain))
            # maximal exact prefix: candidate i is the best-first pop at
            # step i iff its gain >= every child of candidates 0..i-1
            cg = torch.where(torch.isnan(res.gain), neg_inf, res.gain)
            pcm = torch.cummax(torch.maximum(cg[:k], cg[k:]), dim=0).values
            prev = torch.cat([neg_inf[None], pcm[:-1]])
            follow = gains[idl] >= prev
            follow[0] = True
            m = min(k, int(torch.cumprod(follow.to(torch.int64),
                                         dim=0).sum()))
            if rounds is not None:
                rounds.append((k, m))

            # -- commit the first m candidates
            ids = idl[:m]
            r_ = torch.arange(m, device=dev)
            node_of = split_idx + r_
            newleaf = num_leaves + r_
            par = tree.leaf_parent[ids]
            side = leaf_parent_side[ids]
            lfix = (par >= 0) & (side == 0)
            rfix = (par >= 0) & (side == 1)
            tree.left_child[par[lfix]] = node_of[lfix].to(torch.int32)
            tree.right_child[par[rfix]] = node_of[rfix].to(torch.int32)
            tree.split_feature[node_of] = b.feature[ids]
            tree.threshold_bin[node_of] = b.threshold[ids]
            tree.default_left[node_of] = b.default_left[ids]
            tree.is_categorical[node_of] = b.is_categorical[ids]
            tree.cat_bitset[node_of] = b.cat_bitset[ids]
            tree.left_child[node_of] = (~ids).to(torch.int32)
            tree.right_child[node_of] = (~newleaf).to(torch.int32)
            tree.split_gain[node_of] = b.gain[ids]
            tree.internal_value[node_of] = leaf_output(
                leaf_sg[ids], leaf_sh[ids], hp.lambda_l1, hp.lambda_l2,
                hp.max_delta_step)
            tree.internal_weight[node_of] = leaf_sh[ids]
            tree.internal_count[node_of] = leaf_cnt[ids]
            depth = tree.leaf_depth[ids] + 1
            tree.leaf_parent[ids] = node_of
            tree.leaf_parent[newleaf] = node_of
            tree.leaf_depth[ids] = depth
            tree.leaf_depth[newleaf] = depth
            leaf_parent_side[ids] = 0
            leaf_parent_side[newleaf] = 1
            if use_mc:
                leaf_min[ids], leaf_max[ids] = cb[0][:m], cb[1][:m]
                leaf_min[newleaf], leaf_max[newleaf] = cb[2][:m], cb[3][:m]
            # rows of a split leaf that go right take the new leaf
            leaf_id = torch.where((crank < m) & ~gl, num_leaves + crank,
                                  leaf_id)
            leaf_sg[newleaf] = b.right_sum_grad[ids]
            leaf_sh[newleaf] = b.right_sum_hess[ids]
            leaf_cnt[newleaf] = b.right_count[ids]
            leaf_sg[ids] = b.left_sum_grad[ids]
            leaf_sh[ids] = b.left_sum_hess[ids]
            leaf_cnt[ids] = b.left_count[ids]
            small = seg[:m]
            h_par = hist[ids]
            h_left = torch.where(small_left_l[ids][:, None, None, None],
                                 small, h_par - small)
            hist[ids] = h_left
            hist[newleaf] = h_par - h_left
            best.store(ids, _rows(res, slice(0, m)))
            best.store(newleaf, _rows(res, slice(k, k + m)))
            num_leaves += m
            split_idx += m

    if cfg.quant and cfg.quant_renew:
        # leaf outputs from the true gradient sums of each leaf's rows
        from .ops.renew import quant_train_renew_leaf
        with section("kernels"):
            leaf_sg, leaf_sh = quant_train_renew_leaf(leaf_id, grad, hess,
                                                      row_mask, L)
    lv = leaf_output(leaf_sg, leaf_sh, hp.lambda_l1, hp.lambda_l2,
                     hp.max_delta_step)
    if use_mc:
        lv = clip(lv, leaf_min, leaf_max)      # the output clamp
    active = iota_L < num_leaves
    zero = torch.zeros_like(lv)
    tree = tree._replace(
        leaf_value=torch.where(active, lv, zero),
        leaf_weight=torch.where(active, leaf_sh, zero),
        leaf_count=torch.where(active, leaf_cnt, zero),
        num_leaves=num_leaves)
    return tree, leaf_id
