"""Tree arrays, grower configuration and the bin-space decision rule
(counterpart of the shared half of ``lightgbm_tpu/grower.py``).

Node numbering matches the reference Tree (include/LightGBM/tree.h:60-85):
internal node s = s-th split; child pointers >= 0 are internal nodes,
negative values are leaves encoded as ``~leaf_index``; the left child
keeps the parent's leaf index, the right child gets leaf index
``num_leaves``.  The serial ``grow_tree`` is not ported (the trainer
runs ``grower_rounds.RoundGrower``).  A categorical split keeps the
bins that go left in a bitset of ``MAX_CAT_WORDS`` words (int64 tensors
holding uint32 values).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .binning import MissingType
from .ops.split import MAX_CAT_WORDS, SplitHyperparams


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
    """Grower configuration (the fields the rounds grower reads).
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
    candidate of a round instead of its exact best-first prefix."""

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
