"""Tree arrays, grower configuration, the bin-space decision rule and
the serial (leaf-wise, one split at a time) grower (counterpart of
``lightgbm_tpu/grower.py``).

Node numbering matches the reference Tree (include/LightGBM/tree.h:60-85):
internal node s = s-th split; child pointers >= 0 are internal nodes,
negative values are leaves encoded as ``~leaf_index``; the left child
keeps the parent's leaf index, the right child gets leaf index
``num_leaves``.  A categorical split keeps the bins that go left in a
bitset of ``MAX_CAT_WORDS`` words (int64 tensors holding uint32 values).

``SerialGrower`` grows a tree one best-first split at a time (reference:
SerialTreeLearner::Train, serial_tree_learner.cpp:149-193), as the JAX
package's ``grow_tree`` does; the trainer elects it for
``tpu_tree_growth="serial"`` and for the two features that run only on
it, CEGB and forced splits (``boosting/gbdt.py``).  Each split is one
step of device tensors, with no host read inside it:

- selection: the leaf of the largest cached gain (ties: the smaller
  leaf; under CEGB the largest penalized per-(leaf, feature) candidate,
  ties: the smaller leaf, then the smaller feature), or, while a forced
  plan lasts, the planned split (``_forced_result``); a planned split
  without positive gain abandons the rest of the plan;
- the node write, the partition of the leaf's rows (the split feature's
  bin decoded from its EFB group), the monotone bounds of both children;
- the smaller child's histogram by one masked pass over every row, the
  sibling as ``parent - small`` in exact integers;
- the search of both children, their per-node draws from node identity
  ``(s + 1, side)`` (``node_draws``), and the ``max_depth`` gate.

Every write is a masked scatter whose masked-off lanes write a spare row
(``_pad_scatter``), so a step that does not split changes nothing.  The
host reads the loop's stop test once before each step (at most
``num_leaves - 1`` reads a tree) and, in f32 training, the tree's
fixed-point scales once; ``host_reads`` keeps each tree's count.

Three arms, as in the JAX package:

- **staged** (the default, and ``auto``): the root and each smaller
  child are B6 (``ops.histogram.histogram_fixed``) on the masked [3, n]
  values at the tree's scales; quantized, B4 in int8 mode with one slot
  (``ops.fused.accumulate``).  The search is B5 in leaf mode on the
  group histograms (``ops.split.best_split_for_leaf``, or
  ``feature_best_splits`` for CEGB's per-feature candidates).
- **fused**, only for an explicit ``hist_method="fused"`` on numeric
  data without bundles, per-node randomness, CEGB or forced splits: the
  root is B4 with one slot, each split one B2 with one slot
  (``ops.fused.frontier_splits``), then ``pick_fused_best``.

The histogram cache is [L + 1, 3, G, Bg] int64 fixed point at one scale
per channel and tree, or [L + 1, 2, G, Bg] int32 levels when quantized,
so every sibling is exact; the JAX package keeps an f32 cache and
subtracts in f32 (the differences are ROADMAP queue C's C-3).

CEGB (reference: cost_effective_gradient_boosting.hpp): each leaf caches
its per-feature candidates penalty-free (``_LeafFeatBest``), with the
lazy penalty of the rows then in the leaf; the split penalty times the
leaf's count, the coupled penalty of a feature no split has used yet
and the cached lazy penalty are subtracted at selection time.  The
cross-tree state, the used-feature flags [F] and (lazy mode) the paid
(feature, row) bitmap [F, n], lives in the grower (``cegb_state``) and
carries from tree to tree.  The lazy penalty's row count is an integer
count.

Sharded (``shard``, a ``parallel.learners.ShardSpec``; the JAX package's
``axis_name`` and ``feature_axis_name`` branches, grower.py:332-760):

- **data**: the grower holds a rank's rows; the root and every smaller
  child's histogram are summed over the group (``_sync_hist``: exact
  integers, so every rank finds the serial split), as are the root
  totals of quantized training, the lazy CEGB counts and the leaf
  renewal's sums; the fixed-point and quantization scales take the
  group's peaks and its row count;
- **feature**: the grower holds every row and a rank's EFB groups; each
  search runs on them and one all-gather gives every rank every
  feature's candidates in the global order (``_gather_features``), so
  the pick, the CEGB cache and the forced plan see every feature; the
  rank that owns a split's feature sends the rows' sides
  (``_goes_left``) and a forced split's left sums;
- **voting**: rows as in data, histograms kept local; each search votes
  (``_vote``) and sums only the elected features' histograms;
- **data_feature** (the 2-D mesh): a rank's rows and its features; the
  histograms are summed over the data axis (``row_group``), the
  candidates gathered and the row sides sent over the feature axis
  (``group``).

Every sum over the rows takes the config's route (``hier_reduce``:
``parallel.collectives.psum_tiered``); on a two-tier
mesh under hierarchical sums the vote is per slice.  Under a group the
serial grower takes the staged family (the JAX
package's "fused does not apply"); the rounds grower runs data-parallel
only (``grower_rounds.py``).
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple, Optional

import numpy as np
import torch

from .binning import MissingType
from .obs.trace import span as _span
from .ops import fused
from .ops.histogram import (_vals_t, _vals_t_int, fixed_point_scales,
                            histogram_fixed)
from .ops.split import (_EPS32, _TWO_EPS32, MAX_CAT_WORDS,
                        PerFeatureBest, QuantScales, SplitHyperparams,
                        SplitResult, clip, best_split_for_leaf, f32,
                        feature_best_splits, fixed_to_f32, leaf_gain,
                        leaf_output, pick_best_feature, quant_count_hist)
from .parallel.collectives import (DCN_AXIS, HYBRID_AXES, ICI_AXIS,
                                   ProcessMesh, all_gather_tiered, axis_size,
                                   psum_tiered)
from .utils import threefry


class TreeArrays(NamedTuple):
    """Flat-array tree on the device; L leaves, L-1 internal nodes."""

    split_feature: torch.Tensor    # [L-1] int64 (index into used features)
    threshold_bin: torch.Tensor    # [L-1] int32
    default_left: torch.Tensor     # [L-1] bool
    is_categorical: torch.Tensor   # [L-1] bool
    cat_bitset: torch.Tensor       # [L-1, MAX_CAT_WORDS] int64 (bins left)
    left_child: torch.Tensor       # [L-1] int32 (>= 0 node, < 0 ~leaf)
    right_child: torch.Tensor      # [L-1] int32
    split_gain: torch.Tensor       # [L-1] f32
    internal_value: torch.Tensor   # [L-1] f32
    internal_weight: torch.Tensor  # [L-1] f32
    internal_count: torch.Tensor   # [L-1] f32
    leaf_value: torch.Tensor       # [L] f32
    leaf_weight: torch.Tensor      # [L] f32
    leaf_count: torch.Tensor       # [L] f32
    leaf_parent: torch.Tensor      # [L] int64
    leaf_depth: torch.Tensor       # [L] int32
    num_leaves: int                # or a 0-dim int64 device tensor

    @staticmethod
    def empty(L: int, device) -> "TreeArrays":
        n = max(L - 1, 1)

        def z(k, dt):
            return torch.zeros(k, dtype=dt, device=device)
        return TreeArrays(
            split_feature=z(n, torch.int64), threshold_bin=z(n, torch.int32),
            default_left=z(n, torch.bool), is_categorical=z(n, torch.bool),
            cat_bitset=torch.zeros((n, MAX_CAT_WORDS), dtype=torch.int64,
                                   device=device),
            left_child=z(n, torch.int32),
            right_child=z(n, torch.int32), split_gain=z(n, torch.float32),
            internal_value=z(n, torch.float32),
            internal_weight=z(n, torch.float32),
            internal_count=z(n, torch.float32),
            leaf_value=z(L, torch.float32), leaf_weight=z(L, torch.float32),
            leaf_count=z(L, torch.float32),
            leaf_parent=torch.full((L,), -1, dtype=torch.int64,
                                   device=device),
            leaf_depth=z(L, torch.int32), num_leaves=1)

    def to_numpy(self) -> dict:
        return {k: (v.cpu().numpy() if isinstance(v, torch.Tensor) else v)
                for k, v in self._asdict().items()}


class _LeafBest(NamedTuple):
    """Per-leaf cached best split (structure of arrays over leaves)."""

    gain: torch.Tensor
    feature: torch.Tensor
    threshold: torch.Tensor
    default_left: torch.Tensor
    left_sum_grad: torch.Tensor
    left_sum_hess: torch.Tensor
    left_count: torch.Tensor
    right_sum_grad: torch.Tensor
    right_sum_hess: torch.Tensor
    right_count: torch.Tensor
    is_categorical: torch.Tensor
    cat_bitset: torch.Tensor

    @staticmethod
    def empty(L: int, device) -> "_LeafBest":
        def z(dt):
            return torch.zeros(L, dtype=dt, device=device)
        return _LeafBest(
            gain=torch.full((L,), -float("inf"), dtype=torch.float32,
                            device=device),
            feature=z(torch.int64), threshold=z(torch.int32),
            default_left=z(torch.bool), left_sum_grad=z(torch.float32),
            left_sum_hess=z(torch.float32), left_count=z(torch.float32),
            right_sum_grad=z(torch.float32), right_sum_hess=z(torch.float32),
            right_count=z(torch.float32), is_categorical=z(torch.bool),
            cat_bitset=torch.zeros((L, MAX_CAT_WORDS), dtype=torch.int64,
                                   device=device))

    def store(self, ids: torch.Tensor, r) -> None:
        """``self[ids] = r`` field by field, in place."""
        for name in self._fields:
            getattr(self, name)[ids] = getattr(r, name).to(
                getattr(self, name).dtype)


class GrowerConfig(NamedTuple):
    """Grower configuration (the fields the two growers read).
    ``hist_method`` elects the arm: the fused one for ``auto``/``fused``
    on a dataset without bundles, the staged one otherwise.  ``quant``:
    quantized-gradient training (``use_quantized_grad``), int32 level
    histograms from the int8 values of ``ops.histogram.
    quantize_gradients``; ``quant_bins`` is ``num_grad_quant_bins``;
    ``quant_renew`` re-fits the leaf outputs from the true gradient sums
    (``quant_train_renew_leaf``).  ``bynode_feature_cnt`` > 0 samples
    that many features per node (``feature_fraction_bynode``); it and
    ``hp.extra_trees`` draw per-node randomness and elect the staged
    arm.  ``rounds_relaxed`` (``tpu_tree_growth="fast"``) commits every
    candidate of a round instead of its exact best-first prefix.  The
    serial grower's: CEGB's ``cegb_tradeoff`` and ``cegb_penalty_split``,
    ``cegb_coupled``/``cegb_lazy`` (penalty lists given), ``n_forced``
    (splits in the forced plan) and ``forced_exact_parity``
    (``tpu_forced_split_parity``: a forced split's sums take the
    reference's GatherInfoForThreshold convention, the threshold bin
    on the right); voting-parallel's ``voting_top_k``.  On a two-tier
    mesh (``parallel.learners._hybrid_cfg``): its ``num_slices`` and the
    planner's ``hier_reduce``, the route of every sum over the rows."""

    num_leaves: int = 31
    max_depth: int = -1
    hp: SplitHyperparams = SplitHyperparams()
    num_bins: int = 255            # padded bin axis B
    round_width: int = 128         # max splits committed per round
    hist_method: str = "auto"
    quant: bool = False
    quant_bins: int = 4
    quant_renew: bool = False
    bynode_feature_cnt: int = 0
    rounds_relaxed: bool = False
    cegb_tradeoff: float = 1.0
    cegb_penalty_split: float = 0.0
    cegb_coupled: bool = False
    cegb_lazy: bool = False
    n_forced: int = 0
    forced_exact_parity: bool = False
    voting_top_k: int = 0          # voting-parallel: features each rank
    #                                votes and the group elects
    num_slices: int = 1            # slices of the two-tier mesh: a
    #                                hierarchical vote is per slice
    hier_reduce: bool = False      # sums the fast tier first, then the
    #                                slow one (collectives.psum_tiered)


def row_goes_left(col: torch.Tensor, node_thr, node_dl, missing_type,
                  default_bin, num_bin, node_cat=None,
                  node_bitset=None) -> torch.Tensor:
    """Decision rule in bin space (reference: DenseBin::SplitInner,
    src/io/dense_bin.hpp): missing rows follow ``default_left``, others
    compare ``bin <= threshold``; categorical rows (``node_cat``) go left
    when their bin is in the node's bitset, ``node_bitset`` [8] or one
    bitset per row [n, 8].  Every other argument broadcasts per row."""
    col = col.to(torch.int32)
    is_missing = (((missing_type == MissingType.NAN) & (col == num_bin - 1))
                  | ((missing_type == MissingType.ZERO)
                     & (col == default_bin)))
    num_left = torch.where(is_missing, node_dl, col <= node_thr)
    if node_bitset is None:
        return num_left
    word = (col >> 5).clamp(0, MAX_CAT_WORDS - 1).to(torch.int64)
    if node_bitset.dim() == 2:
        w = node_bitset.gather(1, word[:, None])[:, 0]
    else:
        w = node_bitset[word]
    cat_left = ((w >> (col & 31).to(torch.int64)) & 1) == 1
    return torch.where(node_cat, cat_left, num_left)


def feature_bin(binned_t: torch.Tensor, feat: torch.Tensor,
                meta_t: dict) -> torch.Tensor:
    """Each row's bin of feature ``feat[row]`` (a per-row used-feature
    index) from the [G, n] group matrix: one gather along the group axis,
    then the EFB decode (singleton groups decode to themselves)."""
    grp = meta_t["feat_group"][feat]
    col = binned_t.gather(0, grp.to(torch.int64)[None, :])[0].to(torch.int32)
    dec = col - meta_t["feat_start"][feat] + 1
    nb = meta_t["num_bin"][feat]
    return torch.where((dec >= 1) & (dec < nb), dec, torch.zeros_like(dec))


def predict_leaf_index_binned(tree: TreeArrays, binned_t: torch.Tensor,
                              meta_t: dict, depth=None,
                              has_cat=None) -> torch.Tensor:
    """Route binned rows ([G, n] feature-major) to leaf indices, all rows
    one level per step (reference: Tree::Predict, tree.h:190).  Given the
    tree's ``depth`` (and ``has_cat``, whether it has a categorical
    split), known on the host, it takes exactly ``depth`` steps and reads
    nothing from the device; else it reads the leaf count and each
    level's "any row still routing" on the host."""
    n = binned_t.shape[1]
    dev = binned_t.device
    if depth is None and tree.num_leaves <= 1 or depth == 0:
        return torch.zeros(n, dtype=torch.int64, device=dev)
    node = torch.zeros(n, dtype=torch.int64, device=dev)
    if has_cat is None:
        has_cat = bool(tree.is_categorical.any())
    step = 0
    while True:
        live = node >= 0
        if depth is None:
            if not bool(live.any()):
                break
        elif step == depth:
            break
        step += 1
        nd = node.clamp_min(0)
        feat = tree.split_feature[nd]
        binf = feature_bin(binned_t, feat, meta_t)
        gl = row_goes_left(binf, tree.threshold_bin[nd],
                           tree.default_left[nd],
                           meta_t["missing_type"][feat],
                           meta_t["default_bin"][feat],
                           meta_t["num_bin"][feat],
                           *((tree.is_categorical[nd], tree.cat_bitset[nd])
                             if has_cat else ()))
        nxt = torch.where(gl, tree.left_child[nd], tree.right_child[nd])
        node = torch.where(live, nxt.to(torch.int64), node)
    return ~node


def predict_tree_binned(tree: TreeArrays, binned_t: torch.Tensor,
                        meta_t: dict, depth=None,
                        has_cat=None) -> torch.Tensor:
    """Each binned row's leaf value (reference: the JAX package's
    ``predict_tree_binned``)."""
    return tree.leaf_value[predict_leaf_index_binned(tree, binned_t, meta_t,
                                                     depth, has_cat)]


# ----------------------------------------------------------------------
# what both growers share
# ----------------------------------------------------------------------

def group_layout(meta_t: dict, num_bins: int) -> fused.GroupLayout:
    """Where the dataset's group histograms keep each feature, for B5's
    grouped leaf mode and ``ops.fused.expand_groups``."""
    return fused.GroupLayout(meta_t["feat_group"], meta_t["feat_start"],
                             int(num_bins))


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


def _pad_scatter(buf: torch.Tensor, idx: torch.Tensor, val: torch.Tensor,
                 sel: torch.Tensor) -> None:
    """``buf[idx] = val`` in place on the lanes where ``sel``; the other
    lanes write ``buf``'s last row, a spare that nothing reads
    (reference: grower_rounds.py _pad_scatter)."""
    spare = torch.full_like(idx, buf.shape[0] - 1)
    buf[torch.where(sel, idx, spare)] = val.to(buf.dtype)


class _NullTimer:
    @staticmethod
    def section(_name):
        return contextlib.nullcontext()


def child_bounds(hp: SplitHyperparams, mc: torch.Tensor, lg, lh, rg, rh,
                 p_min, p_max, feat, is_cat):
    """The output bounds two children inherit from a split of a leaf
    bounded by ``p_min``/``p_max`` (reference: UpdateConstraints,
    monotone_constraints.hpp:44; the JAX package's apply_split): the
    parent's, narrowed at the midpoint of the clamped child outputs on a
    numeric split of a constrained feature.  Returns (l_min, l_max,
    r_min, r_max)."""
    l_out = clip(leaf_output(lg, lh, hp.lambda_l1, hp.lambda_l2,
                             hp.max_delta_step), p_min, p_max)
    r_out = clip(leaf_output(rg, rh, hp.lambda_l1, hp.lambda_l2,
                             hp.max_delta_step), p_min, p_max)
    mid = (l_out + r_out) * 0.5
    mc_f = mc[feat.clamp(0, mc.shape[0] - 1)]
    upd = ~is_cat & (mc_f != 0)
    lo, hi = torch.maximum(p_min, mid), torch.minimum(p_max, mid)
    return (torch.where(upd & (mc_f < 0), lo, p_min),
            torch.where(upd & (mc_f > 0), hi, p_max),
            torch.where(upd & (mc_f > 0), lo, p_min),
            torch.where(upd & (mc_f < 0), hi, p_max))


class _GrowerCommon:
    """What both growers share: the hoisted constants (the meta tensors,
    the categorical columns, B5's warp tasks, the group layout, the
    monotone constraints), the static inputs each tree copies its values,
    scales, masks and draws into, the carry buffers (each with a spare
    last row for ``_pad_scatter``), the tree's inputs and root, the
    search and the leaf finish.  A subclass sets ``fused_arm`` and
    ``best``, and grows a tree in ``_grow``; ``grow`` records the tree
    as one ``grow_span`` span (the JAX package's ``trace.grow_tree`` and
    ``trace.grow_tree_rounds``), outside any captured body."""

    grow_span = "trace.grow_tree"

    def grow(self, grad: torch.Tensor, hess: torch.Tensor,
             row_mask: torch.Tensor,
             feature_mask: Optional[torch.Tensor] = None,
             quant_vals: Optional[tuple] = None, rng_key=None, timer=None,
             rounds: Optional[list] = None):
        """Grow one tree; returns (TreeArrays, leaf_id [n] int64), both
        the caller's own tensors."""
        with _span(self.grow_span, rows=self.n):
            return self._grow(grad, hess, row_mask, feature_mask,
                              quant_vals, rng_key, timer, rounds)

    def __init__(self, binned_t: torch.Tensor, meta, cfg: GrowerConfig,
                 meta_t: Optional[dict] = None,
                 monotone_constraints: Optional[torch.Tensor] = None,
                 shard=None):
        meta = self.meta = meta.resolved()
        dev = self.device = binned_t.device
        self.binned_t = binned_t
        self.cfg = cfg
        G, n = binned_t.shape
        self.n = n
        # sharded training (parallel/learners.py): the mode, the group
        # the features are sharded over, the group (or mesh) the rows are
        # summed over (data, voting, 2-D) and the rows over every rank
        self.shard = shard
        self.mode = "serial" if shard is None else shard.mode
        self.group = None if shard is None else shard.group
        self.row_group = None if shard is None else shard.row_group
        self.rows_global = (shard.rows_global if self.row_group is not None
                            else n)
        L = self.L = cfg.num_leaves
        self.Lm1 = max(L - 1, 1)
        B = self.B = cfg.num_bins
        F = self.F = len(meta.num_bin)
        self.use_mc = monotone_constraints is not None
        self.use_rng = cfg.hp.extra_trees or cfg.bynode_feature_cnt > 0
        self.Bg = meta.max_group_bin if meta.has_bundles else B
        mt = self.mt = (meta_t if meta_t is not None
                        else meta.tensors(dev))
        self.num_bin, self.missing_type, self.default_bin = (
            mt["num_bin"], mt["missing_type"], mt["default_bin"])
        self.is_cat = torch.as_tensor(meta.is_categorical, device=dev)
        cat = [f for f in range(F) if meta.is_categorical[f]]
        # the categorical columns, found once (the search takes them)
        self.cat_cols = torch.tensor(cat, dtype=torch.int64, device=dev)
        self.groups = group_layout(mt, B) if meta.has_bundles else None
        # B5's warp tasks, planned once from the host meta
        self.scan_plan = fused.scan_tasks(meta.num_bin, B, dev)
        self.mc = (monotone_constraints.to(device=dev, dtype=torch.int32)
                   if self.use_mc else None)
        # what splits and routing read by used feature: every feature's
        # (``g_*``, [gF]); in feature mode the rank searches only its own
        # features (``local_ids``: their global ids; ``local_index``: a
        # global feature's local index, -1 where another rank owns it)
        self.gF = F
        self.g_num_bin, self.g_missing_type, self.g_default_bin = (
            self.num_bin, self.missing_type, self.default_bin)
        self.g_is_cat, self.g_mc = self.is_cat, self.mc
        self.local_ids = None
        if shard is not None and shard.local_features is not None:
            gm = shard.global_meta
            self.gF = len(gm.num_bin)
            gt = gm.tensors(dev)
            self.g_num_bin, self.g_missing_type, self.g_default_bin = (
                gt["num_bin"], gt["missing_type"], gt["default_bin"])
            self.g_is_cat = torch.as_tensor(gm.is_categorical, device=dev)
            ids = np.asarray(shard.local_features, np.int64)
            self.local_ids = torch.as_tensor(ids, device=dev)
            li = np.full(self.gF, -1, np.int64)
            li[ids] = np.arange(len(ids))
            self.local_index = torch.as_tensor(li, device=dev)
            self.gather_order = torch.as_tensor(shard.gather_order,
                                                device=dev)
            if self.use_mc:
                self.g_mc = self.mc
                self.mc = self.g_mc[self.local_ids]
        self.iota_L = torch.arange(L, device=dev)
        self.neg_inf = torch.tensor(-float("inf"), dtype=torch.float32,
                                    device=dev)

        # static inputs, written by each tree
        C = 2 if cfg.quant else 3
        self.vals = torch.zeros((C, n), device=dev, dtype=(
            torch.int8 if cfg.quant else torch.float32))
        self.member = torch.zeros(n, dtype=torch.bool, device=dev)
        self.exps = torch.zeros(3, dtype=torch.int32, device=dev)
        self.host_scales = (0, 0, 0)
        self.qscales = torch.ones(2, dtype=torch.float64, device=dev)
        self.fmask = torch.ones(F, dtype=torch.float32, device=dev)
        self.draw_mask = self.draw_eru = None
        if self.use_rng:
            # every (parent, side) a tree can search: parent -1 (the
            # root) .. L - 2, row (parent + 1) * 2 + side
            self.draw_parents = torch.arange(
                -1, L - 1, device=dev).repeat_interleave(2)
            self.draw_sides = torch.arange(2, device=dev).repeat(L)
            if cfg.bynode_feature_cnt > 0:
                self.draw_mask = torch.zeros((2 * L, F), device=dev)
            if cfg.hp.extra_trees:
                self.draw_eru = torch.zeros((2 * L, F, 2), device=dev)

        # the carry: node arrays [L - 1 + 1], leaf arrays [L + 1]
        leaves = TreeArrays.empty(L + 1, dev)
        self.tree = TreeArrays.empty(self.Lm1 + 2, dev)._replace(
            **{f: getattr(leaves, f) for f in _LEAF_FIELDS})
        self.hist = torch.zeros((L + 1, C, G, self.Bg), device=dev,
                                dtype=torch.int32 if cfg.quant
                                else torch.int64)
        z = torch.zeros(L + 1, dtype=torch.float32, device=dev)
        self.leaf_sg, self.leaf_sh, self.leaf_cnt = z, z.clone(), z.clone()
        self.leaf_min, self.leaf_max = z.clone(), z.clone()
        self.leaf_parent_side = torch.zeros(L + 1, dtype=torch.int32,
                                            device=dev)
        self.leaf_id = torch.zeros(n, dtype=torch.int64, device=dev)
        self.num_leaves = torch.ones((), dtype=torch.int64, device=dev)
        self.split_idx = torch.zeros((), dtype=torch.int64, device=dev)

    def _whole_histogram(self, vals: torch.Tensor) -> torch.Tensor:
        """B6 over every row of ``vals`` at the tree's scales."""
        return histogram_fixed(self.binned_t, vals, self.Bg,
                               self.host_scales)

    def _root_levels(self, slot0: torch.Tensor) -> torch.Tensor:
        """The root's int32 sums of the quantized levels: B4 in int8
        mode, slot 0 for every member row (``slot0``), on both arms."""
        return fused.accumulate(self.binned_t, self.vals, slot0, 1,
                                self.Bg)[0]

    def _root_fixed(self, slot0: torch.Tensor) -> torch.Tensor:
        """The root's int64 fixed-point sums at the tree's scales: B4
        with slot 0 for every member row on the fused arm, B6 over every
        row (the others' values are 0) on the staged one."""
        if self.fused_arm:
            return fused.accumulate(self.binned_t, self.vals, slot0, 1,
                                    self.B, self.exps)[0]
        return self._whole_histogram(self.vals)

    def _tree_inputs(self, section, grad, hess, row_mask, feature_mask,
                     quant_vals, rng_key):
        """Copy one tree's values, scales, feature mask and node draws
        into the static inputs; returns the root histogram and its
        totals [3].  In f32 training this reads the tree's fixed-point
        scales on the host (``host_scales``), once."""
        cfg, hp = self.cfg, self.cfg.hp
        if self.use_rng and rng_key is None:
            rng_key = threefry.prng_key(0)
        with section("kernels"):
            member = row_mask > 0
            self.member.copy_(member)
            slot0 = torch.where(member, 0, 1).to(torch.int32)
            if cfg.quant:
                if quant_vals is None:
                    raise ValueError("cfg.quant needs quant_vals=(gq, hq, "
                                     "g_scale, h_scale)")
                gq, hq, g_scale, h_scale = quant_vals
                self.vals.copy_(_vals_t_int(gq, hq, member))
                self.qscales.copy_(torch.stack([
                    torch.as_tensor(g_scale), torch.as_tensor(h_scale)]))
                # B4 in int8 mode, slot 0 for every member row, on both
                # arms
                root = self._sync_hist(self._root_levels(slot0))
                tot = self._psum_rows(torch.cat([
                    self.vals.to(torch.int64).sum(1),
                    member.sum().reshape(1)]))
                qsum = tot[:2].to(torch.float32)
                root_sums = torch.stack([qsum[0] * g_scale,
                                         qsum[1] * h_scale,
                                         tot[2].to(torch.float32)])
            else:
                self.vals.copy_(_vals_t(grad, hess, row_mask))
                # the tree's one host read before its splits (the peaks
                # over the row group: every rank scales alike)
                self.host_scales = fixed_point_scales(
                    self.vals, self.row_group, self.rows_global)
                self.exps.copy_(torch.tensor(self.host_scales,
                                             dtype=torch.int32))
                root = self._sync_hist(self._root_fixed(slot0))
                # group 0's bins partition the member rows: exact totals
                root_sums = fixed_to_f32(
                    self._psum_rows(root[:, 0, :].sum(-1))
                    if self.mode == "voting" else root[:, 0, :].sum(-1),
                    self.exps, 0)
            if feature_mask is None:
                self.fmask.fill_(1.0)
            elif self.local_ids is not None:
                self.fmask.copy_(feature_mask[self.local_ids])
            else:
                self.fmask.copy_(feature_mask)
        if self.use_rng:
            with section("draws"):
                # drawn over every feature (the bynode sample counts
                # them all), then this rank's columns
                mask, eru = node_draws(rng_key, self.draw_parents,
                                       self.draw_sides, self.gF,
                                       cfg.bynode_feature_cnt,
                                       hp.extra_trees)
                if self.local_ids is not None:
                    mask = None if mask is None else mask[:, self.local_ids]
                    eru = None if eru is None else eru[:, self.local_ids]
                if mask is not None:
                    self.draw_mask.copy_(mask)
                if eru is not None:
                    self.draw_eru.copy_(eru)
        return root, root_sums

    def _sync_hist(self, h: torch.Tensor) -> torch.Tensor:
        """A histogram of this rank's rows -> of every rank's rows (data
        and 2-D modes: the exact integer sum over the row group, int64
        fixed point or int32 levels); unchanged in the other modes
        (voting sums only what the vote elects)."""
        if self.mode not in ("data", "data_feature"):
            return h
        return self._psum_rows(h)

    def _psum_rows(self, x: torch.Tensor, axis=None) -> torch.Tensor:
        """Integer totals of this rank's rows -> of every rank's (or of
        the ranks of ``axis`` of a two-tier mesh), by the route the
        config elected."""
        return psum_tiered(x, self.row_group, axis,
                           hierarchical=self.cfg.hier_reduce)

    def _reset_carry(self, root, root_sums) -> None:
        """The carry of a new tree: one leaf holding every row, its
        histogram and totals, no cached split."""
        for f in _NODE_FIELDS + _LEAF_FIELDS:
            getattr(self.tree, f).zero_()
        self.tree.leaf_parent.fill_(-1)
        for f in self.best:
            f.zero_()
        self.best.gain.fill_(-float("inf"))
        self.hist.zero_()
        self.hist[0] = root
        for t in (self.leaf_sg, self.leaf_sh, self.leaf_cnt,
                  self.leaf_parent_side, self.leaf_id, self.split_idx):
            t.zero_()
        self.leaf_min.fill_(-float("inf"))
        self.leaf_max.fill_(float("inf"))
        self.num_leaves.fill_(1)
        self.leaf_sg[0], self.leaf_sh[0], self.leaf_cnt[0] = (
            root_sums[0], root_sums[1], root_sums[2])

    def _root_search(self, section, root, root_sums, per_feature=False):
        """The root's search (node id -1, side 0)."""
        root_ids = torch.tensor([-1], dtype=torch.int64, device=self.device)
        return self._search(section, root[None], root_sums[:, None],
                            (self.leaf_min[:1], self.leaf_max[:1])
                            if self.use_mc else None,
                            root_ids, torch.zeros_like(root_ids),
                            per_feature=per_feature)

    def _scales(self):
        return (QuantScales(self.qscales[0], self.qscales[1])
                if self.cfg.quant else self.exps)

    def _search(self, section, ghist, sums, bounds=None, parents=None,
                sides=None, per_feature: bool = False):
        """Best splits of children given their group histograms
        [NC, C, G, Bg] and totals [3, NC] f32 (B5 reads the groups
        themselves); ``bounds`` ([NC], [NC]) their output bounds
        (monotone constraints), ``parents``/``sides`` [NC] their node
        ids (per-node randomness).  ``per_feature``: each feature's best
        (``PerFeatureBest`` [NC, F], CEGB's candidates) instead of the
        best over features (``SplitResult`` [NC])."""
        fm, eru = self.fmask, None
        if self.use_rng:
            with section("draws"):
                row = ((parents + 1) * 2 + sides).clamp(0, 2 * self.L - 1)
                if self.draw_mask is not None:
                    fm = fm[None, :] * self.draw_mask[row]
                if self.draw_eru is not None:
                    eru = self.draw_eru[row]
        if self.mode == "voting":
            return self._vote(section, ghist, sums, bounds, fm, eru)
        feature_mode = self.local_ids is not None
        search = (feature_best_splits if per_feature or feature_mode
                  else best_split_for_leaf)
        with section("kernels"):
            out = search(
                ghist, self._scales(), sums[0], sums[1], sums[2],
                self.num_bin, self.missing_type, self.default_bin,
                self.is_cat, self.cfg.hp, fm, self.mc, bounds, eru,
                self.groups, self.scan_plan, cat_idx=self.cat_cols)
        if not feature_mode:
            return out
        # feature mode: every feature's candidates, in the global order,
        # then the serial pick (ties -> the smaller feature)
        with section("collectives"):
            pf = self._gather_features(out)
        return pf if per_feature else pick_best_feature(pf, sums[0], sums[1],
                                                        sums[2])

    def _gather_features(self, pf: PerFeatureBest) -> PerFeatureBest:
        """This rank's per-feature candidates [NC, F_local] -> every
        feature's [NC, gF], by one all-gather of the fields packed as f64
        (each value is exact there: f32 sums and gains, int32 bins,
        flags, uint32 bitset words)."""
        NC, Fl = pf.gain.shape
        Fs = self.shard.feature_shard
        cols = [pf.gain, pf.threshold, pf.default_left, pf.left_sum_grad,
                pf.left_sum_hess, pf.left_count, pf.is_categorical]
        packed = torch.cat([torch.stack([c.to(torch.float64) for c in cols],
                                        -1),
                            pf.cat_bitset.to(torch.float64)], -1)
        pad = packed.new_zeros((NC, Fs, packed.shape[-1]))
        pad[:, :, 0] = -float("inf")
        pad[:, :Fl] = packed
        allp = all_gather_tiered(pad, self.group)        # [W, NC, Fs, C]
        allp = allp.permute(1, 0, 2, 3).reshape(NC, -1, packed.shape[-1])
        g = allp[:, self.gather_order]                   # [NC, gF, C]
        return PerFeatureBest(
            gain=g[..., 0].to(torch.float32),
            threshold=g[..., 1].to(torch.int32),
            default_left=g[..., 2] != 0,
            left_sum_grad=g[..., 3].to(torch.float32),
            left_sum_hess=g[..., 4].to(torch.float32),
            left_count=g[..., 5].to(torch.float32),
            is_categorical=g[..., 6] != 0,
            cat_bitset=g[..., 7:].to(torch.int64))

    def _vote(self, section, ghist, sums, bounds, fm, eru) -> SplitResult:
        """Voting-parallel (PV-Tree) best splits of children whose group
        histograms ``ghist`` hold this rank's rows (the JAX package's
        ``leaf_best_voting``; reference: voting_parallel_tree_learner.
        cpp): each rank searches its local histograms with the
        constraints scaled by the rank count (:57-59) and ranks its
        features by gain weighted with its share of the leaf's rows
        (GlobalVoting, :153-182); the ranks' top-k lists are gathered,
        each feature takes its best vote, the top-k of the votes are
        elected (stable: ties -> the smaller feature, as ``lax.top_k``),
        and only the elected features' histograms are summed over the
        group and searched, in ascending feature order (so that with
        ``voting_top_k`` >= F the pick is the serial one).

        Per slice (the JAX package's hierarchical voting, grower.py:
        690-760): on a two-tier mesh under hierarchical sums the whole
        histogram is first summed over the fast tier, so each slice is
        one voter: its constraints scale by the slice count, its top-k
        is gathered over the slow tier, and only the elected features'
        histograms cross it.  The trees then differ from flat voting's."""
        cfg, hp = self.cfg, self.cfg.hp
        rg = self.row_group
        per_slice = (cfg.hier_reduce and isinstance(rg, ProcessMesh)
                     and rg.axis_names == HYBRID_AXES)
        vote_axis = DCN_AXIS if per_slice else None
        if per_slice:
            with section("collectives"):
                ghist = self._psum_rows(ghist, ICI_AXIS)
        W = max(cfg.num_slices, 1) if per_slice else axis_size(rg)
        F = self.F
        k = min(int(cfg.voting_top_k), F)
        NC = ghist.shape[0]
        scales = self._scales()
        with section("kernels"):
            tot = ghist[:, :, 0, :].sum(-1).to(torch.int64)   # [NC, C]
            if cfg.quant:
                gs, hs = self.qscales.to(torch.float32)
                tf = tot.to(torch.float32)
                cnt_f = sums[2] / torch.clamp_min(torch.round(sums[1] / hs),
                                                  1.0)
                loc = (tf[:, 0] * gs, tf[:, 1] * hs, tf[:, 1] * cnt_f)
            else:
                lf = fixed_to_f32(tot, self.exps, 1)
                loc = (lf[:, 0], lf[:, 1], lf[:, 2])
            hp_local = hp._replace(
                min_data_in_leaf=max(1, hp.min_data_in_leaf // W),
                min_sum_hessian_in_leaf=hp.min_sum_hessian_in_leaf / W)
            pf = feature_best_splits(
                ghist, scales, loc[0], loc[1], loc[2], self.num_bin,
                self.missing_type, self.default_bin, self.is_cat, hp_local,
                fm, self.mc, bounds, eru, self.groups, self.scan_plan,
                cat_idx=self.cat_cols)
            mean_cnt = torch.clamp_min(sums[2] / W, 1.0)[:, None]
            rc_loc = loc[2][:, None] - pf.left_count
            ninf = torch.full_like(pf.gain, -float("inf"))
            wgain = torch.where(torch.isfinite(pf.gain),
                                pf.gain * (pf.left_count + rc_loc) / mean_cnt,
                                ninf)
            top = torch.sort(wgain, dim=1, descending=True,
                             stable=True).indices[:, :k]
            top_g = wgain.gather(1, top)
        with section("collectives"):
            all_i = all_gather_tiered(top, rg, vote_axis)      # [W, NC, k]
            all_g = all_gather_tiered(top_g, rg, vote_axis)
        with section("kernels"):
            all_i = all_i.permute(1, 0, 2).reshape(NC, -1)
            all_g = all_g.permute(1, 0, 2).reshape(NC, -1)
            votes = ninf.scatter_reduce(1, all_i, all_g, "amax")
            elected = torch.sort(torch.sort(
                votes, dim=1, descending=True, stable=True).indices[:, :k],
                dim=1).values                                  # [NC, k]
        out = []
        for c in range(NC):
            e = elected[c]
            with section("kernels"):
                sub = (fused.expand_groups(ghist[c:c + 1], self.groups,
                                           self.num_bin, e)
                       if self.groups is not None else ghist[c:c + 1][:, :, e])
            with section("collectives"):
                sub = psum_tiered(sub, rg, vote_axis)
            fm_c = None if fm is None else (fm[c] if fm.dim() == 2 else fm)
            with section("kernels"):
                r = best_split_for_leaf(
                    sub, scales, sums[0][c:c + 1], sums[1][c:c + 1],
                    sums[2][c:c + 1], self.num_bin[e], self.missing_type[e],
                    self.default_bin[e], self.is_cat[e], hp,
                    None if fm_c is None else fm_c[e],
                    None if self.mc is None else self.mc[e],
                    None if bounds is None else (bounds[0][c:c + 1],
                                                 bounds[1][c:c + 1]),
                    None if eru is None else eru[c:c + 1][:, e])
            out.append(r._replace(feature=e[r.feature]))
        return SplitResult(*(torch.cat([getattr(r, f) for r in out])
                             for f in SplitResult._fields))

    def _finish(self, grad, hess, row_mask):
        cfg, hp = self.cfg, self.cfg.hp
        L, Lm1 = self.L, self.Lm1
        leaf_sg, leaf_sh = self.leaf_sg[:L], self.leaf_sh[:L]
        leaf_id = self.leaf_id.clone()
        if cfg.quant and cfg.quant_renew:
            # leaf outputs from the true gradient sums of each leaf's rows
            from .ops.renew import quant_train_renew_leaf
            leaf_sg, leaf_sh = quant_train_renew_leaf(
                leaf_id, grad, hess, row_mask, L, self.row_group,
                self.rows_global, hierarchical=cfg.hier_reduce)
        lv = leaf_output(leaf_sg, leaf_sh, hp.lambda_l1, hp.lambda_l2,
                         hp.max_delta_step)
        if self.use_mc:
            lv = clip(lv, self.leaf_min[:L], self.leaf_max[:L])  # the clamp
        active = self.iota_L < self.num_leaves
        zero = torch.zeros_like(lv)
        t = self.tree
        tree = TreeArrays(
            **{f: getattr(t, f)[:Lm1].clone() for f in _NODE_FIELDS},
            leaf_value=torch.where(active, lv, zero),
            leaf_weight=torch.where(active, leaf_sh, zero),
            leaf_count=torch.where(active, self.leaf_cnt[:L], zero),
            leaf_parent=t.leaf_parent[:L].clone(),
            leaf_depth=t.leaf_depth[:L].clone(),
            num_leaves=self.num_leaves.clone())
        return tree, leaf_id


# TreeArrays' fields indexed by node ([L - 1]) and by leaf ([L])
_NODE_FIELDS = ("split_feature", "threshold_bin", "default_left",
                "is_categorical", "cat_bitset", "left_child", "right_child",
                "split_gain", "internal_value", "internal_weight",
                "internal_count")
_LEAF_FIELDS = ("leaf_value", "leaf_weight", "leaf_count", "leaf_parent",
                "leaf_depth")


# ----------------------------------------------------------------------
# the serial grower
# ----------------------------------------------------------------------

class _LeafFeatBest(NamedTuple):
    """Per-(leaf, feature) split candidates of CEGB mode (structure of
    arrays [L, F]; reference: the JAX package's ``_LeafFeatBest``).  The
    gains are penalty-free, so the coupled penalty, applied at selection
    time from the used-feature flags, vanishes for every cached
    candidate the moment a split first uses the feature (the reference's
    UpdateLeafBestSplits, made exact); the lazy penalty is cached with
    the candidates, since it depends on the rows in the leaf then."""

    gain: torch.Tensor           # f32, without CEGB penalties
    threshold: torch.Tensor      # int32
    default_left: torch.Tensor   # bool
    left_sum_grad: torch.Tensor
    left_sum_hess: torch.Tensor
    left_count: torch.Tensor
    cat_bitset: torch.Tensor     # [L, F, MAX_CAT_WORDS] int64
    lazy_pen: torch.Tensor       # f32 cached on-demand penalties

    @staticmethod
    def empty(L: int, F: int, device) -> "_LeafFeatBest":
        def z(dt):
            return torch.zeros((L, F), dtype=dt, device=device)
        return _LeafFeatBest(
            gain=torch.full((L, F), -float("inf"), dtype=torch.float32,
                            device=device),
            threshold=z(torch.int32), default_left=z(torch.bool),
            left_sum_grad=z(torch.float32), left_sum_hess=z(torch.float32),
            left_count=z(torch.float32),
            cat_bitset=torch.zeros((L, F, MAX_CAT_WORDS), dtype=torch.int64,
                                   device=device),
            lazy_pen=z(torch.float32))


class SerialGrower(_GrowerCommon):
    """Grows the trees of one booster one best-first split at a time
    (see the module docstring); the same call as
    ``grower_rounds.RoundGrower.grow``.

    Built once: the arm, the meta tensors, B5's warp tasks, the group
    layout, the monotone constraints, the CEGB penalties (f32 [F] per
    used feature, ``cegb_coupled``/``cegb_lazy``), the forced plan
    (``forced_plan``: (leaf, used feature, threshold bin) int arrays
    [cfg.n_forced], ``GBDT._build_forced_plan``), the static input
    buffers and the carry buffers (each with a spare last row for
    ``_pad_scatter``).  ``cegb_state`` is the cross-tree CEGB state
    (used-feature flags [F] bool, and the lazy paid bitmap [F, n] bool
    or None), updated in place by every split; ``host_reads`` gets each
    tree's host reads, ``steps`` each tree's split steps."""

    def __init__(self, binned_t: torch.Tensor, meta, cfg: GrowerConfig,
                 meta_t: Optional[dict] = None,
                 monotone_constraints: Optional[torch.Tensor] = None,
                 cegb_coupled: Optional[np.ndarray] = None,
                 cegb_lazy: Optional[np.ndarray] = None,
                 forced_plan: Optional[tuple] = None, shard=None):
        super().__init__(binned_t, meta, cfg, meta_t, monotone_constraints,
                         shard)
        meta, dev, F = self.meta, self.device, self.gF
        self.cegb_on = (cfg.cegb_penalty_split > 0.0 or cfg.cegb_coupled
                        or cfg.cegb_lazy)
        if cfg.quant and self.cegb_on:
            raise NotImplementedError(
                "quantized-gradient training does not support CEGB; the "
                "booster falls back to f32 histograms for this combination")
        if self.mode == "voting" and cfg.voting_top_k <= 0:
            raise ValueError("voting-parallel needs voting_top_k > 0 (the "
                             f"reference's top_k), got {cfg.voting_top_k}")
        if self.mode == "voting" and shard.local_features is not None:
            # the JAX package's refusal (grower.py:538-553)
            raise NotImplementedError(
                "voting-parallel is a data-axis mode; combining it with "
                "feature sharding is contradictory (the vote needs all-"
                "feature local histograms) — use a data x feature mesh "
                "without voting")
        if self.cegb_on and self.mode == "voting":
            # the JAX package's refusal (grower.py:572-585): exact CEGB
            # needs every feature's global candidates, which voting
            # exists not to build
            raise NotImplementedError(
                "CEGB needs global per-feature candidates; voting-parallel "
                "exists to avoid building exactly those — use "
                "tree_learner=data with CEGB instead")
        self.n_forced = int(cfg.n_forced)
        self.has_cat = bool(self.g_is_cat.any())
        # the JAX package's serial arm election (grower.py:659-662); a
        # sharded grower takes the staged family
        self.fused_arm = (cfg.hist_method == "fused"
                          and not meta.has_bundles and not self.has_cat
                          and not self.use_rng and not self.cegb_on
                          and self.n_forced == 0 and self.mode == "serial")
        self.sides = torch.arange(2, device=dev)
        self.bins = torch.arange(self.B, device=dev)
        self.words = torch.arange(MAX_CAT_WORDS, device=dev)
        self.host_reads: list = []
        self.steps: list = []

        # CEGB: the penalties in the JAX package's f32 arithmetic
        # (f32(tradeoff) * penalty; f32(tradeoff * split penalty))
        t32 = np.float32(cfg.cegb_tradeoff)

        def coef(p):
            return torch.as_tensor(t32 * np.asarray(p, np.float32),
                                   device=dev)
        self.coupled_coef = coef(cegb_coupled) if cfg.cegb_coupled else None
        self.lazy_coef = coef(cegb_lazy) if cfg.cegb_lazy else None
        self.split_coef = f32(cfg.cegb_tradeoff * cfg.cegb_penalty_split)
        self.cegb_state = None
        if self.cegb_on:
            self.cegb_state = (
                torch.zeros(F, dtype=torch.bool, device=dev),
                torch.zeros((F, binned_t.shape[1]), dtype=torch.bool,
                            device=dev) if cfg.cegb_lazy else None)
        if self.n_forced:
            self.fp_leaf, self.fp_feat, self.fp_thr = (
                torch.as_tensor(np.asarray(a, np.int64), device=dev)
                for a in forced_plan)
        self.aborted = torch.zeros((), dtype=torch.bool, device=dev)
        self.best = (_LeafFeatBest.empty(self.L + 1, F, dev) if self.cegb_on
                     else _LeafBest.empty(self.L + 1, dev))

    # ------------------------------------------------------------ helpers

    def _cegb_gains(self) -> torch.Tensor:
        """[L, F] penalized gains of the cached candidates (reference:
        DetlaGain, cost_effective_gradient_boosting.hpp:50), from the
        current state, in the JAX package's order of f32 sums."""
        L, fb = self.L, self.best
        pen = None
        if self.cfg.cegb_penalty_split > 0.0:
            pen = self.split_coef * self.leaf_cnt[:L, None]
        if self.coupled_coef is not None:
            c = torch.where(self.cegb_state[0][None, :],
                            torch.zeros_like(self.coupled_coef)[None, :],
                            self.coupled_coef[None, :])
            pen = c if pen is None else pen + c
        if self.lazy_coef is not None:
            lp = fb.lazy_pen[:L]
            pen = lp if pen is None else pen + lp
        g = fb.gain[:L]
        if pen is not None:
            g = torch.where(torch.isfinite(g), g - pen, self.neg_inf)
        return g

    def _gains(self) -> torch.Tensor:
        """The active leaves' gains ([L], or [L, F] under CEGB), -inf
        elsewhere."""
        active = self.iota_L < self.num_leaves
        if self.cegb_on:
            return torch.where(active[:, None], self._cegb_gains(),
                               self.neg_inf)
        return torch.where(active, self.best.gain[:self.L], self.neg_inf)

    def _lazy_row(self, in_leaf: torch.Tensor) -> torch.Tensor:
        """[F] on-demand penalty of one leaf's rows (reference:
        CalculateOndemandCosts, cost_effective_gradient_boosting.hpp:93):
        the penalty times the leaf's rows that have not paid for the
        feature yet, counted as integers (over every rank's rows)."""
        if self.lazy_coef is None:
            return torch.zeros(self.gF, dtype=torch.float32,
                               device=self.device)
        cnt = self._psum_rows((~self.cegb_state[1] & in_leaf[None, :]).sum(1))
        return self.lazy_coef * cnt.to(torch.float32)

    def _more(self) -> torch.Tensor:
        """The loop's condition (the JAX package's ``cond``): a split is
        left and some active leaf has a positive gain, or the forced
        plan lasts."""
        more = self._gains().max() > 0.0
        if self.n_forced:
            more = more | ((self.split_idx < self.n_forced) & ~self.aborted)
        return (self.split_idx < self.L - 1) & more

    # A leaf, a feature or a node is a one-element index tensor ([1])
    # throughout the step: indexing with a 0-dim tensor reads it on the
    # host, indexing with a [1] tensor gathers on the device.

    def _goes_left(self, feat: torch.Tensor, r) -> torch.Tensor:
        """Every row's side under split ``r`` of used feature ``feat``
        ([1]).  In feature mode the rank that owns the feature decides
        and the group sums its answer (the others add zeros): the
        reference's partition broadcast."""
        cat = ((r.is_categorical, r.cat_bitset[0]) if self.has_cat else ())
        if self.local_ids is None:
            return row_goes_left(self._column(feat), r.threshold,
                                 r.default_left, self.missing_type[feat],
                                 self.default_bin[feat], self.num_bin[feat],
                                 *cat)
        li = self.local_index[feat]
        lf = li.clamp_min(0)
        gl = row_goes_left(self._column(lf), r.threshold, r.default_left,
                           self.missing_type[lf], self.default_bin[lf],
                           self.num_bin[lf], *cat)
        return psum_tiered((gl & (li >= 0)).to(torch.uint8), self.group) > 0

    def _column(self, feat: torch.Tensor) -> torch.Tensor:
        """Every row's bin of local used feature ``feat`` ([1]): its
        group's column, EFB-decoded."""
        mt = self.mt
        g = mt["feat_group"][feat].to(torch.int64)
        col = self.binned_t.index_select(0, g)[0].to(torch.int32)
        dec = col - mt["feat_start"][feat] + 1
        return torch.where((dec >= 1) & (dec < self.num_bin[feat]), dec,
                           torch.zeros_like(dec))

    def _feature_hist(self, h: torch.Tensor, feat: torch.Tensor
                      ) -> torch.Tensor:
        """Feature ``feat``'s [C, B] histogram from a leaf's group
        histogram [C, G, Bg] (bin 0 rebuilt from the exact totals where
        the feature is bundled)."""
        if self.groups is None:
            return h.index_select(1, feat)[:, 0]
        return fused.expand_groups(h[None], self.groups, self.num_bin,
                                   feat)[0, :, 0]

    def _forced_result(self):
        """(leaf, SplitResult) of the forced plan's current step, [1]
        fields (reference: GatherInfoForThreshold,
        feature_histogram.hpp:486; the JAX package's
        ``forced_split_result``): the left sums are the bins at or below
        the threshold and the missing bin (with ``forced_exact_parity``,
        below it), summed exactly; a categorical forced split sends its
        one bin left."""
        hp = self.cfg.hp
        s = self.split_idx.clamp(max=self.n_forced - 1).reshape(1)
        leaf, feat, thr = self.fp_leaf[s], self.fp_feat[s], self.fp_thr[s]
        sg, sh, cnt = (self.leaf_sg[leaf], self.leaf_sh[leaf],
                       self.leaf_cnt[leaf])
        if self.local_ids is not None:
            # feature mode: the owner's histogram, summed with zeros
            li = self.local_index[feat]
            hf = self._feature_hist(self.hist[leaf][0], li.clamp_min(0))
            hf = psum_tiered(hf * (li >= 0).to(hf.dtype), self.group)
        else:
            hf = self._feature_hist(self.hist[leaf][0], feat)  # [C, B]
            if self.mode == "voting":
                # local histograms: this one is summed over the group
                hf = self._psum_rows(hf)
        if self.cfg.quant:
            hf = quant_count_hist(hf[None, :, None], cnt)[0, :, 0]
        b, nb = self.bins, self.g_num_bin[feat]
        mtp, cat = self.g_missing_type[feat], self.g_is_cat[feat]
        valid = b < nb
        miss_bin = torch.where(
            mtp == MissingType.NAN, nb - 1,
            torch.where(mtp == MissingType.ZERO, self.g_default_bin[feat],
                        torch.full_like(nb, -1)))
        below = (b < thr) if self.cfg.forced_exact_parity else (b <= thr)
        sel = torch.where(cat, valid & (b == thr),
                          valid & (below | (b == miss_bin)))
        lsum = fixed_to_f32((hf * sel.to(hf.dtype)).sum(1), self._scales(),
                            0)
        lg, lh, lc = lsum[0:1], lsum[1:2], lsum[2:3]
        rg, rh, rc = sg - lg, sh - lh, cnt - lc
        parent_gain = leaf_gain(sg, sh + _TWO_EPS32, hp.lambda_l1,
                                hp.lambda_l2)
        gain = (leaf_gain(lg, lh + _EPS32, hp.lambda_l1, hp.lambda_l2)
                + leaf_gain(rg, rh + _EPS32, hp.lambda_l1, hp.lambda_l2)
                - parent_gain - f32(hp.min_gain_to_split))
        gain = torch.where(torch.isnan(gain), self.neg_inf, gain)
        bit = torch.bitwise_left_shift(torch.ones_like(thr), thr % 32)
        bitset = torch.where(cat[:, None] & (self.words == thr[:, None] // 32),
                             bit[:, None], torch.zeros_like(bit)[:, None])
        return leaf, SplitResult(
            gain=gain, feature=feat, threshold=thr.to(torch.int32),
            default_left=~cat, left_sum_grad=lg, left_sum_hess=lh,
            left_count=lc, right_sum_grad=rg, right_sum_hess=rh,
            right_count=rc, is_categorical=cat, cat_bitset=bitset)

    def _selection(self):
        """(leaf, SplitResult) of the best-first choice, [1] fields
        (reference: the JAX package's ``current_selection``)."""
        g = self._gains()
        b = self.best
        if not self.cegb_on:
            leaf = torch.argmax(g).reshape(1)
            return leaf, SplitResult(*(getattr(b, name)[leaf]
                                       for name in SplitResult._fields))
        leaf = torch.argmax(g.max(1).values).reshape(1)
        f = torch.argmax(g[leaf], dim=1)       # ties -> smaller feature
        lg, lh, lc = (b.left_sum_grad[leaf, f], b.left_sum_hess[leaf, f],
                      b.left_count[leaf, f])
        return leaf, SplitResult(
            gain=g[leaf, f], feature=f, threshold=b.threshold[leaf, f],
            default_left=b.default_left[leaf, f], left_sum_grad=lg,
            left_sum_hess=lh, left_count=lc,
            right_sum_grad=self.leaf_sg[leaf] - lg,
            right_sum_hess=self.leaf_sh[leaf] - lh,
            right_count=self.leaf_cnt[leaf] - lc,
            is_categorical=self.g_is_cat[f],
            cat_bitset=b.cat_bitset[leaf, f])

    # --------------------------------------------------------------- step

    def _step(self, section) -> None:
        """One split (the JAX package's ``body`` and ``apply_split``), every
        update in place and masked by ``do``; no host read."""
        cfg, hp = self.cfg, self.cfg.hp
        tree = self.tree
        s = self.split_idx.reshape(1).clone()
        new_leaf = self.num_leaves.reshape(1).clone()
        with section("routing"):
            leaf, r = self._selection()
            if self.n_forced:
                in_forced = (s < self.n_forced) & ~self.aborted
                f_leaf, f_r = self._forced_result()
                ok = f_r.gain > 0.0
                apply_forced = in_forced & ok
                self.aborted |= (in_forced & ~ok)[0]
                leaf = torch.where(apply_forced, f_leaf, leaf)
                r = SplitResult(*(torch.where(
                    apply_forced if a.dim() == 1 else apply_forced[:, None],
                    a, b_.to(a.dtype)) for a, b_ in zip(f_r, r)))
                do = apply_forced | (r.gain > 0.0)
            else:
                do = r.gain > 0.0
            two = do.expand(2)
            pair = torch.cat([leaf, new_leaf])
            feat, lg, lh, lc = (r.feature, r.left_sum_grad, r.left_sum_hess,
                                r.left_count)
            rg, rh, rc = r.right_sum_grad, r.right_sum_hess, r.right_count

            # the node (fix the parent's dangling child pointer first)
            par = tree.leaf_parent[leaf]
            side = self.leaf_parent_side[leaf]
            pc = par.clamp_min(0)
            _pad_scatter(tree.left_child, pc, s, do & (par >= 0) & (side == 0))
            _pad_scatter(tree.right_child, pc, s,
                         do & (par >= 0) & (side == 1))
            depth = tree.leaf_depth[leaf] + 1
            for field, val in (
                    ("split_feature", feat), ("threshold_bin", r.threshold),
                    ("default_left", r.default_left),
                    ("is_categorical", r.is_categorical),
                    ("cat_bitset", r.cat_bitset), ("left_child", ~leaf),
                    ("right_child", ~new_leaf), ("split_gain", r.gain),
                    ("internal_value", leaf_output(
                        self.leaf_sg[leaf], self.leaf_sh[leaf],
                        hp.lambda_l1, hp.lambda_l2, hp.max_delta_step)),
                    ("internal_weight", self.leaf_sh[leaf]),
                    ("internal_count", self.leaf_cnt[leaf])):
                _pad_scatter(getattr(tree, field), s, val, do)
            bounds = None
            if self.use_mc:
                bounds = child_bounds(hp, self.g_mc, lg, lh, rg, rh,
                                      self.leaf_min[leaf],
                                      self.leaf_max[leaf], feat,
                                      r.is_categorical)
            for buf, left, right in (
                    (tree.leaf_parent, s, s), (tree.leaf_depth, depth, depth),
                    (self.leaf_parent_side, torch.zeros_like(side),
                     torch.ones_like(side)),
                    (self.leaf_sg, lg, rg), (self.leaf_sh, lh, rh),
                    (self.leaf_cnt, lc, rc),
                    *(((self.leaf_min, bounds[0], bounds[2]),
                       (self.leaf_max, bounds[1], bounds[3]))
                      if self.use_mc else ())):
                _pad_scatter(buf, pair, torch.cat([left, right]), two)

            # partition the leaf's rows (reference: DataPartition::Split)
            gl = self._goes_left(feat, r)
            in_leaf = self.leaf_id == leaf
            self.leaf_id.copy_(torch.where(in_leaf & ~gl & do, new_leaf,
                                           self.leaf_id))
            if self.cegb_on:
                # the feature is used; lazy: the parent's rows have paid
                # (reference: serial_tree_learner.cpp:529-532)
                used, rows = self.cegb_state
                used.index_copy_(0, feat, used[feat] | do)
                if rows is not None:
                    paid = rows.index_select(0, feat)[0] | (
                        in_leaf & self.member & do)
                    rows.index_copy_(0, feat, paid[None])

        # the smaller child by a masked pass, the sibling by subtraction
        left_smaller = lc <= rc
        small_leaf = torch.where(left_smaller, leaf, new_leaf)
        small = (self.leaf_id == small_leaf) & self.member
        parent = self.hist[leaf][0]
        csums = torch.stack([torch.cat([lg, rg]), torch.cat([lh, rh]),
                             torch.cat([lc, rc])])
        cbounds = (None if bounds is None else
                   (torch.cat([bounds[0], bounds[2]]),
                    torch.cat([bounds[1], bounds[3]])))
        scales = self._scales()
        res = None
        with section("kernels"):
            slot = torch.where(small, 0, 1).to(torch.int32)
            if self.fused_arm:
                seg, nfb = fused.frontier_splits(
                    self.binned_t, self.vals, slot, 1, self.B, scales, csums,
                    left_smaller, parent[None], self.num_bin,
                    self.missing_type, self.default_bin, hp,
                    monotone_constraints=self.mc, child_bounds=cbounds,
                    plan=self.scan_plan)
                small_hist = seg[0]
                res = fused.pick_fused_best(nfb, csums[0], csums[1],
                                            csums[2], self.fmask)
            elif cfg.quant:
                small_hist = fused.accumulate(self.binned_t, self.vals, slot,
                                              1, self.Bg)[0]
            else:
                small_hist = self._whole_histogram(
                    (self.vals * small).contiguous())
        with section("collectives"):
            small_hist = self._sync_hist(small_hist)
        with section("siblings"):
            large = parent - small_hist
            hist_l = torch.where(left_smaller, small_hist, large)
            hist_r = torch.where(left_smaller, large, small_hist)
            children = torch.stack([hist_l, hist_r])
            _pad_scatter(self.hist, pair, children, two)
        if res is None:
            res = self._search(section, children, csums, cbounds,
                               torch.cat([s, s]), self.sides,
                               per_feature=self.cegb_on)
        with section("routing"):
            if cfg.max_depth > 0:
                gate = depth >= cfg.max_depth
                res = res._replace(gain=torch.where(
                    gate if res.gain.dim() == 1 else gate[:, None],
                    self.neg_inf, res.gain))
            if self.cegb_on:
                lazy = torch.stack([
                    self._lazy_row((self.leaf_id == lf) & self.member)
                    for lf in (leaf, new_leaf)])
                for name in _LeafFeatBest._fields:
                    val = (lazy if name == "lazy_pen"
                           else getattr(res, name))
                    _pad_scatter(getattr(self.best, name), pair, val, two)
            else:
                for name in _LeafBest._fields:
                    _pad_scatter(getattr(self.best, name), pair,
                                 getattr(res, name), two)
            grew = do.to(torch.int64)[0]
            self.num_leaves.add_(grew)
            self.split_idx.add_(grew)

    # --------------------------------------------------------------- tree

    def _grow(self, grad, hess, row_mask, feature_mask, quant_vals,
              rng_key, timer, rounds):
        """One tree (see ``grow_tree``); ``rounds``, when given, gets a
        ``(1, 1)`` per split (one candidate, committed), from one host
        read after the tree."""
        section = (timer or _NullTimer).section
        root, root_sums = self._tree_inputs(section, grad, hess, row_mask,
                                            feature_mask, quant_vals,
                                            rng_key)
        reads = 0 if self.cfg.quant else 1    # the scales
        self._init_carry(section, root, root_sums)
        steps = 0
        while steps < self.L - 1:
            reads += 1           # the stop test, read before each step
            if not bool(self._more()):
                break
            self._step(section)
            steps += 1
        self.host_reads.append(reads)
        self.steps.append(steps)
        if rounds is not None:
            rounds.extend([(1, 1)] * int(self.split_idx))
        return self._finish(grad, hess, row_mask)

    def _init_carry(self, section, root, root_sums) -> None:
        self._reset_carry(root, root_sums)
        self.aborted.zero_()
        r0 = self._root_search(section, root, root_sums,
                               per_feature=self.cegb_on)._asdict()
        fields = _LeafBest._fields
        if self.cegb_on:
            r0["lazy_pen"] = self._lazy_row(self.member)[None]
            fields = _LeafFeatBest._fields
        for name in fields:
            getattr(self.best, name)[:1] = r0[name].to(
                getattr(self.best, name).dtype)


def grow_tree(binned_t: torch.Tensor, grad: torch.Tensor,
              hess: torch.Tensor, row_mask: torch.Tensor, meta,
              cfg: GrowerConfig, feature_mask: Optional[torch.Tensor] = None,
              monotone_constraints: Optional[torch.Tensor] = None,
              rng_key=None, cegb_coupled_penalty=None,
              cegb_lazy_penalty=None,
              cegb_feat_used: Optional[torch.Tensor] = None,
              cegb_used_rows: Optional[torch.Tensor] = None,
              forced_plan: Optional[tuple] = None,
              meta_t: Optional[dict] = None,
              quant_vals: Optional[tuple] = None, timer=None):
    """Grow one tree one split at a time (reference: the JAX package's
    ``grow_tree``; its sharded modes are ``parallel.learners.
    create_parallel_grower``'s).  ``binned_t`` [G, n]
    uint8/int32 (the EFB group matrix), ``grad``/``hess``/``row_mask``
    [n] f32 on the same device; ``feature_mask`` [F]; ``monotone_
    constraints`` [F] int32; ``rng_key`` the tree's threefry key for
    per-node randomness; ``cegb_coupled_penalty``/``cegb_lazy_penalty``
    [F] penalties per used feature, ``cegb_feat_used`` [F] bool and
    ``cegb_used_rows`` [F, n] bool the state carried in from earlier
    trees; ``forced_plan`` (leaf, feature, threshold) arrays
    [cfg.n_forced]; ``quant_vals`` ``(gq, hq, g_scale, h_scale)``
    (``cfg.quant``).  Builds a ``SerialGrower`` for the one tree (a
    trainer keeps one per booster).  Returns (TreeArrays, leaf_id [n]
    int64), and with CEGB on the state after the tree, (used, rows)."""
    grower = SerialGrower(binned_t, meta, cfg, meta_t, monotone_constraints,
                          cegb_coupled_penalty, cegb_lazy_penalty,
                          forced_plan)
    if grower.cegb_state is not None:
        used, rows = grower.cegb_state
        if cegb_feat_used is not None:
            used.copy_(cegb_feat_used)
        if rows is not None and cegb_used_rows is not None:
            rows.copy_(cegb_used_rows)
    tree, leaf_id = grower.grow(grad, hess, row_mask, feature_mask,
                                quant_vals, rng_key, timer)
    if grower.cegb_state is not None:
        return tree, leaf_id, grower.cegb_state
    return tree, leaf_id
