"""Batched-frontier leaf-wise tree growth (counterpart of
``lightgbm_tpu/grower_rounds.py``, its serial and data-parallel arms).

Same semantics as LightGBM's best-first growth (reference:
src/treelearner/serial_tree_learner.cpp:149-193), a ROUND of splits at a
time: each round applies the top ``k = min(#positive-gain leaves, leaf
budget, KCAP)`` candidates in (gain desc, leaf asc) order, which is the
sequence best-first would produce provided no child created by the round
outranks the round's weakest applied candidate.  That proviso is checked
after the children's best splits are known; the round commits only the
maximal exact prefix (at least one split: the single best-first step).
Trees, node and leaf numbering included, are those of the serial grower.

The JAX package runs this as a ``lax.while_loop``; here the round body
has fixed shapes and keeps its scalars on the device, so the host reads
nothing while a tree grows.  The candidate list is always the first
``KCAP`` leaves of the (gain desc, leaf asc) order, a lane mask ``lane <
k`` marks the live ones, every commit is a masked scatter whose dead
lanes write a spare row past the end of each array (``_pad_scatter``),
and a round once the tree is done (``k`` = 0) changes nothing.  The
round log ``(k, m)`` stays on the device and is read once a tree.  The
host learns that a tree is done from a flag copied after each round and
read ``STOP_LAG`` rounds later, so a tree runs up to ``STOP_LAG`` dead
rounds past its end (``RoundGrower.dead_rounds``).  On the card the body
is captured once per grower as a CUDA graph and replayed every round
(``RoundGrower``); the CPU, a ``SectionTimer`` run and the kernels'
plain versions (``USE_GRAPHS`` off) run the same body eagerly.  A tree
is begun (``begin``: its inputs, root and carry), its rounds run, and
it is ended (``end``); the model axis (``multi/``) runs the rounds of
several boosters' begun trees together (``RoundGroup``: one graph of
every lane's body, replayed once a round, each lane stopping where its
own loop would).  Per
round: candidate ranking, row routing (one gather of each row's
split-feature bin, the EFB decode, the bitset test of categorical
splits), the smaller-child slot of every row, the histogram and split
search of both children of every candidate lane, the feature pick, the
exact-prefix check and the commit.  ``tpu_tree_growth="fast"``
(``cfg.rounds_relaxed``) commits every candidate of a round (``m =
k``), as the JAX package's fast mode does.  Two arms, as in the JAX
package:

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

Data-parallel (a ``parallel.learners.ShardSpec`` of mode "data"): the
grower holds a rank's rows.  The root histogram is summed over the
group, and each round's smaller children too, between the kernels: the
fused arm runs B4 (``fused.accumulate``), the group's exact integer
sum of the [KCAP, C, F, B] arena, then B5 (``fused.sibling_scan``) on
the summed arena, where the serial run launches the pair as B2; the
staged arm sums B4's segment histograms before the siblings.  On a
two-tier mesh each sum takes the route the config elects
(``parallel.collectives.psum_tiered``: flat, or the fast tier then the
slow one).  The body runs eagerly under a group (a CUDA graph cannot
capture gloo's host round-trip).

The body reads the binned matrix in two places only, the root's
histogram (``_root_fixed``/``_root_levels``) and each round's pass over
the rows (``_row_pass``: the routing and B4); the streamed grower
(``data.stream.StreamGrower``) runs those a row block at a time and
sums the blocks' arenas exactly, as the data-parallel seam sums the
ranks'.
"""


from __future__ import annotations

import time
from typing import Optional

import torch

from .grower import (GrowerConfig, _GrowerCommon, _LeafBest, _NullTimer,
                     _pad_scatter, child_bounds, feature_bin, row_goes_left)
# the per-node draws and the group layout live beside the serial grower;
# callers of this module still find them here
from .grower import group_layout, node_draws  # noqa: F401
from .ops import fused
from .ops.histogram import histogram_fixed
from .ops.split import _best_categorical, leaf_output, quant_count_hist

# the host reads the flag "this tree is done" STOP_LAG rounds after the
# round that wrote it, so rounds stay queued on the card; a tree runs up
# to STOP_LAG dead rounds (no-ops) past its end
STOP_LAG = 2
# on the card the round body is replayed as a CUDA graph; False runs it
# eagerly there too (the kernels' plain versions read the host, so a run
# that swaps them in sets it)
USE_GRAPHS = True

class RoundGrower(_GrowerCommon):
    """Grows the trees of one booster (or one ``grow_tree_rounds`` call).

    Built once: the hoisted constants (the arm, ``KCAP``, the meta
    tensors, the categorical columns, B5's warp tasks, the group layout,
    the monotone constraints), the static input buffers each tree copies
    its values, scales, masks and draws into, and the carry buffers the
    round body updates in place (each with a spare last row for
    ``_pad_scatter``).  On a CUDA device the body is captured once, after
    the first eager round, as a CUDA graph and replayed every round after
    that; a capture failure raises.  ``capture_ms`` is the capture's
    wall time, ``round_counts`` gets (rounds run, live-round count as a
    device scalar) of every tree, ``flag_waits`` counts the host's waits
    on a stop flag."""

    # a booster's trees may run their rounds beside other boosters'
    # (``begin``/``end`` around ``RoundGroup.run``)
    lane_steps = True

    def __init__(self, binned_t: torch.Tensor, meta, cfg: GrowerConfig,
                 meta_t: Optional[dict] = None,
                 monotone_constraints: Optional[torch.Tensor] = None,
                 shard=None):
        super().__init__(binned_t, meta, cfg, meta_t, monotone_constraints,
                         shard)
        if self.mode not in ("serial", "data"):
            raise ValueError(
                f"the rounds grower runs serial and data-parallel growth, "
                f"not {self.mode}-parallel (the serial grower does)")
        meta, dev, L = self.meta, self.device, self.L
        # the JAX trainer's arm election (boosting/gbdt.py:690-707,
        # grower_rounds.py:168) for the configurations the port trains
        self.fused_arm = (cfg.hist_method in ("auto", "fused")
                          and not meta.has_bundles and not self.use_rng)
        # B2 takes each round's accumulate -> scan pair, unless the
        # arena is summed over row shares first (data-parallel ranks,
        # streamed blocks): then B4, the sum, B5
        self.split_pair = self.fused_arm and self.row_group is None
        K = self.KCAP = min(max(L - 1, 1), max(1, cfg.round_width))
        self.cat_idx = self.cat_cols if len(self.cat_cols) else None
        self.iota_K = torch.arange(K, device=dev)
        # a graph cannot capture the group's sums (gloo stages them on
        # the host): a sharded body runs eagerly
        self.graphs = dev.type == "cuda" and self.row_group is None
        self.graph = None
        self._graph_counts = None
        self.capture_ms = None
        self.round_counts: list = []
        self.flag_waits = 0       # host waits on a round's stop flag
        self.best = _LeafBest.empty(L + 1, dev)
        self.nround = torch.zeros((), dtype=torch.int64, device=dev)
        self.round_log = torch.zeros((self.Lm1 + 1, 2), dtype=torch.int32,
                                     device=dev)
        self.done = torch.zeros((), dtype=torch.bool, device=dev)
        # "done" after the root (row 0) and after each round
        pin = dev.type == "cuda"
        self.flags = torch.zeros(self.Lm1 + 1, dtype=torch.bool,
                                 pin_memory=pin)
        self.flags_np = self.flags.numpy()
        self.events = ([torch.cuda.Event() for _ in range(self.Lm1 + 1)]
                       if pin else None)

    def _whole_histogram(self, vals: torch.Tensor) -> torch.Tensor:
        # this module's name, so a caller can route it
        return histogram_fixed(self.binned_t, vals, self.Bg,
                               self.host_scales)

    def _row_pass(self, section, route, K: int, Bx: int, scales):
        """A round's pass over the rows, the one step of the body that
        reads the binned matrix: each row's candidate rank, goes-left bit
        and smaller-child slot (``route(binned, leaf_id, member)``) and,
        unless B2 takes the pair (``split_pair``), the smaller children's
        B4 arena [K, C, F, Bx] summed over the row group.  Returns
        (crank, gl, slot, arena or None); the streamed grower runs it a
        row block at a time."""
        with section("routing"):
            crank, gl, slot = route(self.binned_t, self.leaf_id, self.member)
        if self.split_pair:
            return crank, gl, slot, None
        with section("kernels"):
            seg = fused.accumulate(self.binned_t, self.vals, slot, K, Bx,
                                   scales)
        with section("collectives"):
            seg = self._sync_hist(seg)
        return crank, gl, slot, seg

    # ------------------------------------------------------------ helpers

    def _child_bounds(self, ids: torch.Tensor):
        """The bounds the two children of each leaf ``ids``' cached split
        inherit (reference: grower_rounds.py child_bounds)."""
        b = self.best
        return child_bounds(self.cfg.hp, self.mc, b.left_sum_grad[ids],
                            b.left_sum_hess[ids], b.right_sum_grad[ids],
                            b.right_sum_hess[ids], self.leaf_min[ids],
                            self.leaf_max[ids], b.feature[ids],
                            b.is_categorical[ids])

    def _set_done(self) -> None:
        """``done`` = not the reference's loop condition, ``split_idx <
        L - 1 & max(active gains) > 0`` (grower_rounds.py:364-365)."""
        L = self.L
        gains = torch.where(self.iota_L < self.num_leaves,
                            self.best.gain[:L], self.neg_inf)
        self.done.copy_(~((self.split_idx < L - 1)
                          & (gains.max() > 0.0)))

    # --------------------------------------------------------------- body

    def _round(self, section) -> None:
        """One round at fixed shapes, every update in place; no host
        read.  A round after the tree is done has k = 0 and writes only
        spare rows."""
        cfg, hp = self.cfg, self.cfg.hp
        L, K, F = self.L, self.KCAP, self.F
        dev = self.device
        b = _LeafBest(*(f[:L] for f in self.best))
        tree = self.tree
        nl, si = self.num_leaves, self.split_idx
        iota_K, neg_inf = self.iota_K, self.neg_inf
        with section("routing"):
            gains = torch.where(self.iota_L < nl, b.gain, neg_inf)
            npos = (gains > 0.0).sum()
            k = torch.minimum(torch.minimum(npos, L - nl),
                              torch.full_like(npos, K))
            live = iota_K < k
            # total order (gain desc, leaf asc) = successive best-first
            # picks; the candidates are its first KCAP entries
            order = torch.argsort(-gains, stable=True)
            idl = order[:K]
            crank_leaf = torch.full((L,), K, dtype=torch.int64,
                                    device=dev).scatter(
                0, idl, torch.where(live, iota_K, K))
            small_left_l = b.left_count <= b.right_count
            ph = self.hist[idl]
            csums = torch.stack([
                torch.cat([b.left_sum_grad[idl], b.right_sum_grad[idl]]),
                torch.cat([b.left_sum_hess[idl], b.right_sum_hess[idl]]),
                torch.cat([b.left_count[idl], b.right_count[idl]])])
            cbounds = cb = None
            if self.use_mc:
                cb = self._child_bounds(idl)   # l_min, l_max, r_min, r_max
                cbounds = (torch.cat([cb[0], cb[2]]),
                           torch.cat([cb[1], cb[3]]))
            sl = small_left_l[idl]
            slb = sl[:, None, None, None]

        def route(binned, leaf_id, member):
            """The rows' candidate rank, goes-left bit under their leaf's
            cached split, and smaller-child slot (``K``: none)."""
            crank = crank_leaf[leaf_id]
            f_r = b.feature[leaf_id]
            binf = feature_bin(binned, f_r, self.mt)
            gl = row_goes_left(binf, b.threshold[leaf_id],
                               b.default_left[leaf_id],
                               self.missing_type[f_r], self.default_bin[f_r],
                               self.num_bin[f_r],
                               *((b.is_categorical[leaf_id],
                                  b.cat_bitset[leaf_id])
                                 if self.cat_idx is not None else ()))
            row_small = gl == small_left_l[leaf_id]
            slot = torch.where(row_small & (crank < K) & member, crank,
                               K).to(torch.int32)
            return crank, gl, slot

        scales = self._scales()
        crank, gl, slot, seg = self._row_pass(
            section, route, K, self.B if self.fused_arm else self.Bg,
            scales)
        if self.fused_arm and not self.split_pair:
            # the smaller children summed over the rows' shares (B4 a
            # rank or a block, then their exact sum), then the scan of
            # the summed arena (B5), as the JAX package splits its
            # megakernel
            with section("kernels"):
                nfb = fused.sibling_scan(
                    seg, scales, csums, self.num_bin, self.missing_type,
                    self.default_bin, hp, small_left=sl, parent=ph,
                    monotone_constraints=self.mc, child_bounds=cbounds,
                    plan=self.scan_plan)
        elif self.fused_arm:
            with section("kernels"):
                seg, nfb = fused.frontier_splits(
                    self.binned_t, self.vals, slot, K, self.B, scales,
                    csums, sl, ph, self.num_bin, self.missing_type,
                    self.default_bin, hp, monotone_constraints=self.mc,
                    child_bounds=cbounds, plan=self.scan_plan)
        if self.fused_arm:
            with section("kernels"):
                h_left = torch.where(slb, seg, ph - seg)
                cat_best = None
                if self.cat_idx is not None:
                    # the categorical columns of both children, derived
                    # from the cached parents and the smaller children
                    ci = self.cat_idx
                    hl_c = h_left[:, :, ci]
                    chc = torch.cat([hl_c, ph[:, :, ci] - hl_c])
                    if cfg.quant:
                        chc = quant_count_hist(chc, csums[2])
                    cat_best = _best_categorical(
                        chc, scales, csums[0], csums[1], csums[2],
                        self.num_bin[ci], self.missing_type[ci], hp)
                res = fused.pick_fused_best(nfb, csums[0], csums[1],
                                            csums[2], self.fmask, cat_best,
                                            self.cat_idx)
        else:
            with section("siblings"):
                h_left = torch.where(slb, seg, ph - seg)
                children = torch.cat([h_left, ph - h_left])
            node_k = si + iota_K
            res = self._search(section, children, csums, cbounds,
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
            if cfg.rounds_relaxed:
                m = k        # "fast": commit the whole batch
            else:
                cg = torch.where(torch.isnan(res.gain), neg_inf, res.gain)
                pair = torch.where(live, torch.maximum(cg[:K], cg[K:]),
                                   neg_inf)
                pcm = torch.cummax(pair, dim=0).values
                prev = torch.cat([neg_inf[None], pcm[:-1]])
                follow = (iota_K == 0) | (gains[idl] >= prev)
                m = torch.minimum(k, torch.cumprod(
                    follow.to(torch.int64), dim=0).sum())
            went = k > 0
            _pad_scatter(self.round_log, self.nround[None],
                         torch.stack([k, m]).to(torch.int32)[None],
                         went[None])
            self.nround.add_(went.to(torch.int64))

            # -- commit the first m candidates
            sel = iota_K < m
            node_of = si + iota_K
            newleaf = nl + iota_K
            par = tree.leaf_parent[idl]
            side = self.leaf_parent_side[idl]
            pc = par.clamp_min(0)
            lfix = sel & (par >= 0) & (side == 0)
            rfix = sel & (par >= 0) & (side == 1)
            sg, sh, cnt = (self.leaf_sg[idl], self.leaf_sh[idl],
                           self.leaf_cnt[idl])
            depth = tree.leaf_depth[idl] + 1
            _pad_scatter(tree.left_child, pc, node_of, lfix)
            _pad_scatter(tree.right_child, pc, node_of, rfix)
            for field, val in (
                    ("split_feature", b.feature[idl]),
                    ("threshold_bin", b.threshold[idl]),
                    ("default_left", b.default_left[idl]),
                    ("is_categorical", b.is_categorical[idl]),
                    ("cat_bitset", b.cat_bitset[idl]),
                    ("left_child", ~idl),
                    ("right_child", ~newleaf),
                    ("split_gain", b.gain[idl]),
                    ("internal_value", leaf_output(
                        sg, sh, hp.lambda_l1, hp.lambda_l2,
                        hp.max_delta_step)),
                    ("internal_weight", sh),
                    ("internal_count", cnt)):
                _pad_scatter(getattr(tree, field), node_of, val, sel)
            for buf, left, right in (
                    (tree.leaf_parent, node_of, node_of),
                    (tree.leaf_depth, depth, depth),
                    (self.leaf_parent_side, torch.zeros_like(iota_K),
                     torch.ones_like(iota_K)),
                    (self.leaf_sg, b.left_sum_grad[idl],
                     b.right_sum_grad[idl]),
                    (self.leaf_sh, b.left_sum_hess[idl],
                     b.right_sum_hess[idl]),
                    (self.leaf_cnt, b.left_count[idl], b.right_count[idl]),
                    *(((self.leaf_min, cb[0], cb[2]),
                       (self.leaf_max, cb[1], cb[3])) if self.use_mc
                      else ()),
                    (self.hist, h_left, ph - h_left)):
                _pad_scatter(buf, idl, left, sel)
                _pad_scatter(buf, newleaf, right, sel)
            # rows of a split leaf that go right take the new leaf
            self.leaf_id.copy_(torch.where((crank < m) & ~gl, nl + crank,
                                           self.leaf_id))
            for name in _LeafBest._fields:
                buf, val = getattr(self.best, name), getattr(res, name)
                _pad_scatter(buf, idl, val[:K], sel)
                _pad_scatter(buf, newleaf, val[K:], sel)
            nl.add_(m)
            si.add_(m)
            self._set_done()

    # --------------------------------------------------------------- tree

    grow_span = "trace.grow_tree_rounds"

    def _grow(self, grad, hess, row_mask, feature_mask, quant_vals,
              rng_key, timer, rounds):
        """One tree (see ``grow_tree_rounds``); ``grow`` wraps it."""
        self.begin(grad, hess, row_mask, feature_mask, quant_vals, rng_key,
                   timer)
        replays = self._run_rounds(self._section, self._use_graph)
        return self.end(replays, grad, hess, row_mask, rounds)

    def begin(self, grad, hess, row_mask, feature_mask=None,
              quant_vals=None, rng_key=None, timer=None) -> None:
        """Everything of a tree before its rounds: the inputs, the root
        and the carry.  The rounds then run alone (``_run_rounds``) or
        beside other growers' (``RoundGroup.run``), and ``end`` finishes
        the tree."""
        self._section = (timer or _NullTimer).section
        self._use_graph = self.graphs and USE_GRAPHS and timer is None
        root, root_sums = self._tree_inputs(self._section, grad, hess,
                                            row_mask, feature_mask,
                                            quant_vals, rng_key)
        self._init_carry(self._section, root, root_sums)

    def end(self, replays: int, grad, hess, row_mask, rounds=None):
        """Finish the tree ``begin`` started, after ``replays`` rounds;
        returns (TreeArrays, leaf_id) as ``grow`` does."""
        self.round_counts.append((replays, self.nround.clone()))
        if rounds is not None:
            nr = int(self.nround)
            rounds.extend(tuple(r) for r in self.round_log[:nr].tolist())
        return self._finish(grad, hess, row_mask)

    def _init_carry(self, section, root, root_sums) -> None:
        self._reset_carry(root, root_sums)
        self.nround.zero_()
        self.round_log.zero_()
        r0 = self._root_search(section, root, root_sums)
        zero = torch.zeros(1, dtype=torch.int64, device=self.device)
        for name in _LeafBest._fields:
            getattr(self.best, name)[zero] = getattr(r0, name).to(
                getattr(self.best, name).dtype)
        self._set_done()

    def _flag(self, i: int) -> None:
        """Copy ``done`` into host flag ``i`` (non-blocking on the card,
        with an event to wait on)."""
        self.flags[i].copy_(self.done, non_blocking=True)
        if self.events is not None:
            self.events[i].record()

    def _flag_set(self, i: int) -> bool:
        self.flag_waits += 1
        if self.events is not None:
            self.events[i].synchronize()
        return bool(self.flags_np[i])

    def _run_rounds(self, section, use_graph: bool) -> int:
        """The rounds of one tree, each replayed (or run eagerly) without
        a host read; flag r + 1 says the tree was done after round r,
        and is read STOP_LAG rounds later.  Returns the rounds run."""
        self._flag(0)
        r = 0
        while r < self.Lm1 and not self._stops_at(r):
            self._step(section, use_graph)
            self._flag(r + 1)
            r += 1
        return r

    def _stops_at(self, r: int) -> bool:
        """True when the tree's round loop ends before round ``r``: the
        flag written after round ``r - STOP_LAG`` says it was done."""
        return r >= STOP_LAG and self._flag_set(r - STOP_LAG)

    def _step(self, section, use_graph: bool) -> None:
        """One round: a replay of the captured body, or the body eagerly
        (on the card, then captured for the rounds after it)."""
        if use_graph and self.graph is not None:
            self.graph.replay()
            fused.add_launch_counts(self._graph_counts)
        else:
            self._round(section)
            if use_graph:
                self._capture()

    def _capture(self) -> None:
        """Capture the round body as a CUDA graph (after an eager round
        has warmed up every kernel and buffer; ``capture_rounds``)."""
        self.graph, self._graph_counts, self.capture_ms = capture_rounds(
            [self], self.device)


def capture_rounds(growers, device) -> tuple:
    """Capture the round bodies of ``growers``, in turn, as one CUDA
    graph; returns (graph, the launches one replay makes, the capture's
    wall ms).  The launches recorded are counted once per replay, not
    at capture.  Only this thread's calls may break the capture: other
    threads of the process (a co-resident fleet's batchers and clients)
    go on allocating, copying and synchronising on their own streams
    meanwhile."""
    before = fused.launch_count_snapshot()
    graph = torch.cuda.CUDAGraph()
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    with torch.cuda.graph(graph, capture_error_mode="thread_local"):
        for g in growers:
            g._round(_NullTimer.section)
    torch.cuda.synchronize(device)
    ms = (time.perf_counter() - t0) * 1e3
    counts = fused.launch_count_delta(before)
    fused.restore_launch_counts(before)
    return graph, counts, ms


def run_alone(steps):
    """Drive a generator of lane steps (``GBDT._grow_steps``) by itself:
    each grower it yields, its tree begun, runs its own rounds, and the
    rounds run are sent back.  Returns the generator's value."""
    try:
        g = next(steps)
        while True:
            g = steps.send(g._run_rounds(g._section, g._use_graph))
    except StopIteration as e:
        return e.value


class RoundGroup:
    """The rounds of several growers' current trees, run as one loop:
    the lanes of a model-axis group (``multi.batch``).

    Each lane's tree is begun (``RoundGrower.begin``) before ``run`` and
    ended after it.  A round runs every lane whose own loop would still
    run it: lane i stops where its solo ``_run_rounds`` stops, at the
    first round ``r`` whose flag ``r - STOP_LAG`` says its tree was
    done (or at ``Lm1``).  While every lane runs, a round is ONE replay
    of the group's graph, which holds each lane's round body in lane
    order; once some lanes have stopped, the others replay their own
    graphs (``RoundGrower._step``).  So each lane runs exactly its solo
    rounds and launches: a lane whose tree is done rides at most
    ``STOP_LAG`` dead rounds, as it does alone, and never launches B4/B5
    for rounds its solo loop would skip.  The graph is captured after
    the first eager round of a lane set and captured again when the set
    of lanes changes (a lane that stopped training leaves the group for
    good, so a run captures at most once a lane).  A replay needs the
    very grower objects the graph was captured from (``is``), and the
    group holds them until it captures again: a grower rebuilt by a
    parameter reset is a new object with buffers the graph never saw,
    and the old one's buffers (which the graph writes) stay alive while
    the graph does.  A group of lanes
    that cannot be captured (a data-parallel lane's collectives stage
    on the host) runs the bodies eagerly, in lane order, on every rank.

    Counts: ``replays`` of the group graph, ``group_rounds`` (rounds
    every lane ran together: the eager ones and the replays) and
    ``lane_rounds`` (rounds a lane ran alone), ``captures`` and
    ``capture_ms``."""

    def __init__(self):
        self.graph = None
        self._growers = ()
        self._graph_counts = None
        self.replays = 0
        self.group_rounds = 0
        self.lane_rounds = 0
        self.captures = 0
        self.capture_ms = 0.0

    def run(self, growers) -> list:
        """The rounds of every grower's begun tree; returns the rounds
        each ran."""
        n = len(growers)
        use_graph = all(g._use_graph for g in growers)
        for g in growers:
            g._flag(0)
        rounds = [None] * n
        r = 0
        while True:
            running = []
            for i, g in enumerate(growers):
                if rounds[i] is None:
                    if r >= g.Lm1 or g._stops_at(r):
                        rounds[i] = r
                    else:
                        running.append(i)
            if not running:
                return rounds
            if len(running) == n and n > 1:
                self._step_all(growers, use_graph)
                self.group_rounds += 1
            else:
                for i in running:
                    growers[i]._step(growers[i]._section, use_graph)
                self.lane_rounds += len(running)
            for i in running:
                growers[i]._flag(r + 1)
            r += 1

    def _step_all(self, growers, use_graph: bool) -> None:
        if (use_graph and self.graph is not None
                and len(self._growers) == len(growers)
                and all(a is b for a, b in zip(self._growers, growers))):
            self.graph.replay()
            fused.add_launch_counts(self._graph_counts)
            self.replays += 1
            return
        for g in growers:
            g._round(g._section)
        if use_graph:
            self.graph = None          # its pool goes before the next one
            self._growers = ()
            self.graph, self._graph_counts, ms = capture_rounds(
                growers, growers[0].device)
            self._growers = tuple(growers)
            self.captures += 1
            self.capture_ms += ms


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
    ``utils.timer.SectionTimer`` (the body then runs eagerly);
    ``rounds``, when given, gets one ``(k, m)`` per live round:
    candidates, and splits committed (m < k is a rollback to the exact
    prefix), read once after the tree; ``quant_vals`` (``cfg.quant``):
    ``(gq, hq, g_scale, h_scale)`` from
    ``ops.histogram.quantize_gradients``; ``monotone_constraints`` [F]
    int32 in {-1, 0, 1} (used features); ``rng_key`` the tree's threefry
    key (a pair of ints) for per-node randomness, ``PRNGKey(0)`` when
    that is on and no key is given.  Builds a ``RoundGrower`` for the
    one tree (a trainer keeps one per booster).  Returns (TreeArrays
    with ``num_leaves`` a 0-dim device tensor, leaf_id [n] int64)."""
    grower = RoundGrower(binned_t, meta, cfg, meta_t, monotone_constraints)
    return grower.grow(grad, hess, row_mask, feature_mask, quant_vals,
                       rng_key, timer, rounds)
