"""The data-, feature- and voting-parallel tree learners over a process
group (counterpart of ``lightgbm_tpu/parallel/learners.py``).

reference: src/treelearner/{data,feature,voting}_parallel_tree_learner.cpp
and the factory CreateTreeLearner (tree_learner.cpp:13).  A rank holds
one share of the work and the growers (``grower.py``,
``grower_rounds.py``) meet the other ranks at three reduction points
(``collectives.py``):

- **data**: rank r holds a contiguous block of the padded rows
  (``contiguous_layout``; for ranking whole queries, ``query_layout``).
  Its histograms are summed over the group before every search; the sums
  are exact integers (int64 fixed point, int32 quantized levels), so
  every rank finds the serial grower's split and the tree is the serial
  tree, byte for byte;
- **feature**: every rank holds every row and a share of the features
  (``feature_layout``: blocks of ``ceil(F / W)`` features, or whole EFB
  bundles packed lightest-first).  Each rank searches its own features,
  the per-feature bests are gathered and the best taken in the serial
  order, and the owner of the split feature sends every row's side to
  the others (one [n] byte sum);
- **voting** (PV-Tree): rows as in data; each rank keeps its local
  histograms, searches them with local constraints (``min_data_in_leaf
  / W``), votes its ``top_k`` features by weighted gain, and only the
  elected features' histograms are summed.  With ``top_k`` >= F every
  feature is elected and the tree is the serial tree.

With quantized gradients the data and voting sums move int32 level
histograms; ``ops.histogram.hist_payload_bytes`` counts the bytes one
histogram sum moves.  ``grower_inputs`` cuts a rank's share for its
grower, for the booster and ``create_parallel_grower`` alike.  The 2-D
data x feature layout and the hybrid two-tier groups wait for ROADMAP
A9's remainder.
"""

from __future__ import annotations

import heapq
from typing import List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from .collectives import axis_index_flat, axis_size

ALIASES = {"data_parallel": "data", "feature_parallel": "feature",
           "voting_parallel": "voting", "serial_tree_learner": "serial"}


def resolve_tree_learner(name: str) -> str:
    """``tree_learner`` and its aliases -> serial | data | feature |
    voting (reference: CreateTreeLearner, tree_learner.cpp:13-36)."""
    tl = ALIASES.get(str(name).lower(), str(name).lower())
    if tl in ("data_feature", "2d"):
        raise NotImplementedError(
            "the 2-D data x feature layout is not ported to "
            "lightgbm_tpu_torch yet; it waits for ROADMAP queue A9 "
            "(2-D layout)")
    if tl not in ("serial", "data", "feature", "voting"):
        raise ValueError(f"unknown tree_learner {tl!r}")
    return tl


def pad_rows_to(n: int, devices: int) -> int:
    return (n + devices - 1) // devices * devices


def fused_best_payload_bytes(num_features: int) -> int:
    """Bytes of one per-feature-best tuple set (gain, bin, direction,
    left grad/hess/count: 6 cells x F of 4 bytes): what a collective
    would move if it exchanged candidates instead of histograms.
    Accounting only; the data-parallel sum moves histograms (gains do
    not add across ranks)."""
    return 6 * num_features * 4


class RowLayout(NamedTuple):
    """Which global rows each rank holds: ``perm`` [world * n_shard]
    maps padded slot s (rank s // n_shard) to its global row, ``n`` for
    a padding slot; a rank's real rows come first in its block."""

    n: int
    n_shard: int
    perm: np.ndarray

    def rows(self, rank: int) -> np.ndarray:
        block = self.perm[rank * self.n_shard:(rank + 1) * self.n_shard]
        return block[block < self.n]


def contiguous_layout(n: int, world: int) -> RowLayout:
    """Rank r holds rows [r * s, (r + 1) * s) of ``pad_rows_to(n,
    world)`` padded rows, s = n_pad / world: the JAX mesh's sharding."""
    n_pad = pad_rows_to(n, world)
    perm = np.arange(n_pad, dtype=np.int64)
    perm[perm >= n] = n
    return RowLayout(n, n_pad // world, perm)


def query_layout(query_boundaries: Sequence[int], world: int) -> RowLayout:
    """Whole queries per rank for distributed ranking: queries are packed
    onto the lightest rank in order, each rank padded to the largest
    share (the JAX package's ``_build_query_sharding``; reference:
    Metadata::CheckOrPartition, src/io/metadata.cpp:141)."""
    qb = np.asarray(query_boundaries, np.int64)
    sizes = np.diff(qb)
    heap = [(0, d) for d in range(world)]
    heapq.heapify(heap)
    shard_queries: List[List[int]] = [[] for _ in range(world)]
    for q in range(len(sizes)):
        tot, d = heapq.heappop(heap)
        shard_queries[d].append(q)
        heapq.heappush(heap, (tot + int(sizes[q]), d))
    n_shard = max(1, max((int(sizes[qs].sum()) for qs in shard_queries
                          if qs), default=1))
    n = int(qb[-1])
    perm = np.full(n_shard * world, n, np.int64)
    for d, qs in enumerate(shard_queries):
        pos = d * n_shard
        for q in qs:
            lo, hi = int(qb[q]), int(qb[q + 1])
            perm[pos:pos + hi - lo] = np.arange(lo, hi)
            pos += hi - lo
    return RowLayout(n, n_shard, perm)


def shard_dataset(group, binned: np.ndarray, *row_arrays, device=None):
    """This rank's block of the padded rows: the host row-major [n, F]
    ``binned`` as a feature-major [F, n_shard] tensor on ``device`` (the
    current card unless the caller names another, ``basic.
    resolve_device``), and each per-row array padded with zeros (pad
    rows carry mask 0); returns (tensors, n_pad), as the JAX function
    places arrays on its mesh."""
    from ..basic import resolve_device
    device = resolve_device(device)
    world, rank = axis_size(group), axis_index_flat(group)
    n = binned.shape[0]
    lay = contiguous_layout(n, world)
    sl = slice(rank * lay.n_shard, (rank + 1) * lay.n_shard)
    b = np.pad(binned, ((0, world * lay.n_shard - n), (0, 0)))[sl]
    out = [torch.as_tensor(np.ascontiguousarray(b.T), device=device)]
    for arr in row_arrays:
        a = np.pad(np.asarray(arr), (0, world * lay.n_shard - n))[sl]
        out.append(torch.as_tensor(np.ascontiguousarray(a), device=device))
    return out, world * lay.n_shard


class FeatureLayout(NamedTuple):
    """Which EFB group columns and used features each rank owns (the
    features in each rank's local order, group by group)."""

    world: int
    groups: List[np.ndarray]
    features: List[np.ndarray]

    @property
    def feature_shard(self) -> int:
        return max(len(f) for f in self.features)

    def gather_order(self) -> np.ndarray:
        """[F]: where global feature f sits in the ranks' per-feature
        results laid end to end, each padded to ``feature_shard``."""
        Fs = self.feature_shard
        F = sum(len(f) for f in self.features)
        order = np.empty(F, np.int64)
        for r, feats in enumerate(self.features):
            order[feats] = r * Fs + np.arange(len(feats))
        return order


def feature_layout(meta, world: int) -> FeatureLayout:
    """Without EFB bundles rank r owns features [r * s, (r + 1) * s), s =
    ceil(F / world); with bundles whole bundles are packed onto the rank
    of fewest features so far, largest bundles first (the JAX package's
    ``_build_group_sharding``; reference: feature_parallel_tree_learner.
    cpp:33-52).  Every rank must own a feature."""
    m = meta.resolved()
    F = len(m.num_bin)
    fg = np.asarray(m.feat_group, np.int64)
    G = int(m.num_groups)
    feats_of: List[List[int]] = [[] for _ in range(G)]
    for f, g in enumerate(fg):
        feats_of[int(g)].append(f)
    if m.has_bundles:
        heap = [(0, d) for d in range(world)]
        heapq.heapify(heap)
        shard_groups: List[List[int]] = [[] for _ in range(world)]
        for g in sorted(range(G), key=lambda gg: -len(feats_of[gg])):
            cnt, d = heapq.heappop(heap)
            shard_groups[d].append(g)
            heapq.heappush(heap, (cnt + len(feats_of[g]), d))
    else:
        s = -(-F // world)
        shard_groups = [sorted({int(fg[f]) for f in
                                range(r * s, min((r + 1) * s, F))})
                        for r in range(world)]
    groups = [np.asarray(gs, np.int64) for gs in shard_groups]
    features = [np.asarray([f for g in gs for f in feats_of[g]], np.int64)
                for gs in shard_groups]
    if any(len(f) == 0 for f in features):
        raise ValueError(
            f"feature-parallel training over {world} ranks needs at least "
            f"one feature group per rank ({G} groups of {F} features)")
    return FeatureLayout(world, groups, features)


def local_meta(meta, layout: FeatureLayout, rank: int):
    """The FeatureMeta of rank ``rank``'s features, group indices local
    to its columns (the bin axes stay the dataset's)."""
    import dataclasses
    m = meta.resolved()
    feats, groups = layout.features[rank], layout.groups[rank]
    pos = {int(g): j for j, g in enumerate(groups)}
    return dataclasses.replace(
        m, num_bin=m.num_bin[feats], missing_type=m.missing_type[feats],
        default_bin=m.default_bin[feats],
        most_freq_bin=m.most_freq_bin[feats],
        is_categorical=m.is_categorical[feats],
        feat_group=np.asarray([pos[int(g)] for g in m.feat_group[feats]],
                              np.int32),
        feat_start=np.asarray(m.feat_start[feats], np.int32),
        num_groups=len(groups))


class ShardSpec(NamedTuple):
    """What a grower needs to know of its share: the mode, the process
    group, the rows over every rank, and, in feature mode, the global
    meta, this rank's features (global ids in local order) and the
    layout's gather order (``FeatureLayout.gather_order``)."""

    mode: str
    group: object
    rows_global: int
    global_meta: object = None
    local_features: Optional[np.ndarray] = None
    gather_order: Optional[np.ndarray] = None
    feature_shard: int = 0


class GrowerInputs(NamedTuple):
    """A rank's share of the training set for its grower: the binned
    columns [G_local, rows], their meta, the ``ShardSpec`` (None:
    serial) and this rank's global rows (data, voting; None: every
    row)."""

    binned_t: torch.Tensor
    meta: object
    spec: Optional[ShardSpec]
    rows: Optional[torch.Tensor]


def grower_inputs(tree_learner: str, group, binned_t: torch.Tensor, meta,
                  layout: Optional[RowLayout] = None) -> GrowerInputs:
    """This rank's share of every row's binned columns ``binned_t`` [G,
    n]: feature, the columns of its EFB groups (``feature_layout``) and
    their meta; data and voting, its rows of ``layout`` (the contiguous
    one where None).  ``tree_learner`` is resolved; with one rank every
    learner is serial."""
    world, rank = axis_size(group), axis_index_flat(group)
    n = binned_t.shape[1]
    if tree_learner == "serial" or world == 1:
        return GrowerInputs(binned_t, meta, None, None)
    if tree_learner == "feature":
        lay = feature_layout(meta, world)
        cols = torch.as_tensor(lay.groups[rank], device=binned_t.device)
        spec = ShardSpec("feature", group, n, meta.resolved(),
                         lay.features[rank], lay.gather_order(),
                         lay.feature_shard)
        return GrowerInputs(binned_t.index_select(0, cols).contiguous(),
                            local_meta(meta, lay, rank), spec, None)
    layout = layout or contiguous_layout(n, world)
    rows = torch.as_tensor(layout.rows(rank), device=binned_t.device)
    return GrowerInputs(binned_t.index_select(1, rows).contiguous(), meta,
                        ShardSpec(tree_learner, group, n), rows)


def create_parallel_grower(tree_learner: str, group, binned_t: torch.Tensor,
                           meta, cfg, **kwargs):
    """Factory mirroring CreateTreeLearner (tree_learner.cpp:13-36): a
    ``grower.SerialGrower`` for this rank's share of every row's binned
    columns ``binned_t`` [G, n] (``grower_inputs``, as the booster
    builds its grower; data and voting rows in the contiguous layout).
    Voting takes ``cfg.voting_top_k``.  ``kwargs`` go to the grower
    (monotone constraints, CEGB penalties, forced plan)."""
    from ..grower import SerialGrower
    share = grower_inputs(resolve_tree_learner(tree_learner), group,
                          binned_t, meta)
    return SerialGrower(share.binned_t, share.meta, cfg, shard=share.spec,
                        **kwargs)


def make_hybrid_mesh(*args, **kwargs):
    """The JAX package's two-tier (ICI x DCN) layout: not ported."""
    raise NotImplementedError(
        "hybrid two-tier process groups are not ported to "
        "lightgbm_tpu_torch yet; they wait for ROADMAP queue A9 (hybrid "
        "two-tier groups)")


def shrink_and_resume(*args, **kwargs):
    """The JAX package's elastic resume (resilience/elastic.py): not
    ported."""
    raise NotImplementedError(
        "elastic resume after a lost rank is not ported to "
        "lightgbm_tpu_torch yet; it waits for ROADMAP queue A9 "
        "(resilience/elastic.py)")
