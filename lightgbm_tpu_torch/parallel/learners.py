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

- **data_feature** (``2d``): on a ``(data, feature)`` mesh rank (i, j)
  holds row block i (``contiguous_layout`` over the data axis) and
  feature share j (``feature_layout`` over the feature axis); its
  histograms are summed over the data axis, the candidates gathered
  over the feature axis, and the owner of a split's feature sends its
  block's row sides over the feature axis.  The tree is the serial tree.
  Only ``create_parallel_grower`` builds it, as in the JAX package (its
  booster takes serial, data, feature and voting).

Two tiers (``make_hybrid_mesh``): data and voting ranks on a ``("dcn",
"ici")`` mesh hold the same rows as on the flat group (the mesh's linear
order is the group's rank order), and ``ops.planner.plan_collectives``
elects flat or hierarchical sums (``_hybrid_cfg``); hierarchical voting
votes per slice (``grower.py``).

With quantized gradients the data and voting sums move int32 level
histograms; ``ops.histogram.hist_payload_bytes`` counts the bytes one
histogram sum moves.  ``grower_inputs`` cuts a rank's share for its
grower, for the booster and ``create_parallel_grower`` alike.
"""

from __future__ import annotations

import heapq
import threading
import weakref
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..utils import envflags
from .collectives import (DCN_AXIS, HYBRID_AXES, ICI_AXIS, ProcessMesh,
                          axis_index_flat, axis_size)

DATA_AXIS = "data"
FEATURE_AXIS = "feature"

ALIASES = {"data_parallel": "data", "feature_parallel": "feature",
           "voting_parallel": "voting", "serial_tree_learner": "serial",
           "2d": "data_feature"}


def resolve_tree_learner(name: str) -> str:
    """``tree_learner`` and its aliases -> serial | data | feature |
    voting | data_feature (reference: CreateTreeLearner,
    tree_learner.cpp:13-36; ``2d`` is the JAX package's alias of
    ``data_feature``)."""
    tl = ALIASES.get(str(name).lower(), str(name).lower())
    if tl not in ("serial", "data", "feature", "voting", "data_feature"):
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
    """What a grower needs to know of its share: the mode, the group its
    features are sharded over (feature; the feature axis of the 2-D
    mesh), the rows over every rank, and, where features are sharded,
    the global meta, this rank's features (global ids in local order)
    and the layout's gather order (``FeatureLayout.gather_order``);
    ``row_group`` is what its rows' sums run over (data and voting: the
    group or the two-tier mesh; the 2-D mesh's data axis; None where
    every rank holds every row)."""

    mode: str
    group: object
    rows_global: int
    global_meta: object = None
    local_features: Optional[np.ndarray] = None
    gather_order: Optional[np.ndarray] = None
    feature_shard: int = 0
    row_group: object = None


class GrowerInputs(NamedTuple):
    """A rank's share of the training set for its grower: the binned
    columns [G_local, rows], their meta, the ``ShardSpec`` (None:
    serial) and this rank's global rows (data, voting, 2-D; None: every
    row)."""

    binned_t: torch.Tensor
    meta: object
    spec: Optional[ShardSpec]
    rows: Optional[torch.Tensor]


def _feature_share(meta, world: int, j: int):
    """(layout, local meta, spec fields) of feature share ``j`` of
    ``world``."""
    lay = feature_layout(meta, world)
    return lay, local_meta(meta, lay, j), dict(
        global_meta=meta.resolved(), local_features=lay.features[j],
        gather_order=lay.gather_order(), feature_shard=lay.feature_shard)


def grower_inputs(tree_learner: str, group, binned_t: torch.Tensor, meta,
                  layout: Optional[RowLayout] = None) -> GrowerInputs:
    """This rank's share of every row's binned columns ``binned_t`` [G,
    n]: feature, the columns of its EFB groups (``feature_layout``) and
    their meta; data and voting, its rows of ``layout`` (the contiguous
    one where None) over every rank of ``group`` (a process group or a
    ``ProcessMesh``, in its linear order); data_feature, on a ``(data,
    feature)`` mesh, both.  ``tree_learner`` is resolved; with one rank
    every learner is serial."""
    world, rank = axis_size(group), axis_index_flat(group)
    n = binned_t.shape[1]
    if tree_learner == "serial" or world == 1:
        return GrowerInputs(binned_t, meta, None, None)
    if tree_learner == "feature":
        lay, lmeta, fs = _feature_share(meta, world, rank)
        cols = torch.as_tensor(lay.groups[rank], device=binned_t.device)
        return GrowerInputs(binned_t.index_select(0, cols).contiguous(),
                            lmeta, ShardSpec("feature", group, n, **fs),
                            None)
    if tree_learner == "data_feature":
        if not (isinstance(group, ProcessMesh)
                and group.axis_names == (DATA_AXIS, FEATURE_AXIS)):
            raise ValueError(
                "tree_learner=data_feature needs a (data, feature) mesh: "
                "make_mesh(group, (DATA_AXIS, FEATURE_AXIS), (d, f))")
        i, j = group.coords[DATA_AXIS], group.coords[FEATURE_AXIS]
        layout = layout or contiguous_layout(n, group.shape[DATA_AXIS])
        lay, lmeta, fs = _feature_share(meta, group.shape[FEATURE_AXIS], j)
        rows = torch.as_tensor(layout.rows(i), device=binned_t.device)
        cols = torch.as_tensor(lay.groups[j], device=binned_t.device)
        b = binned_t.index_select(0, cols).index_select(1, rows)
        spec = ShardSpec("data_feature", group.over(FEATURE_AXIS), n,
                         row_group=group.over(DATA_AXIS), **fs)
        return GrowerInputs(b.contiguous(), lmeta, spec, rows)
    layout = layout or contiguous_layout(n, world)
    rows = torch.as_tensor(layout.rows(rank), device=binned_t.device)
    return GrowerInputs(binned_t.index_select(1, rows).contiguous(), meta,
                        ShardSpec(tree_learner, group, n, row_group=group),
                        rows)


def create_parallel_grower(tree_learner: str, group, binned_t: torch.Tensor,
                           meta, cfg, **kwargs):
    """Factory mirroring CreateTreeLearner (tree_learner.cpp:13-36) and
    the JAX package's ``create_parallel_grower``: a ``grower.
    SerialGrower`` for this rank's share of every row's binned columns
    ``binned_t`` [G, n] (``grower_inputs``, as the booster builds its
    grower; rows in the contiguous layout).  ``group`` is a process
    group or a ``ProcessMesh``: data and voting on a two-tier mesh
    (``make_hybrid_mesh``) take the planner's election of flat or
    hierarchical sums (``_hybrid_cfg``); data_feature needs a ``(data,
    feature)`` mesh (``make_mesh``).  Voting takes ``cfg.voting_top_k``.
    ``kwargs`` go to the grower (monotone constraints, CEGB penalties,
    forced plan)."""
    from ..grower import SerialGrower
    tl = resolve_tree_learner(tree_learner)
    if tl in ("data", "voting") and isinstance(group, ProcessMesh):
        cfg = _hybrid_cfg(cfg, group, data_axis_of(group))
    share = grower_inputs(tl, group, binned_t, meta)
    return SerialGrower(share.binned_t, share.meta, cfg, shard=share.spec,
                        **kwargs)


# ----------------------------------------------------------------------
# meshes of process groups
# ----------------------------------------------------------------------

# the meshes made of each group, by (axes, shape): a group's sub-groups
# meet once on its store, so a second call returns the first mesh
_MESHES: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()
_mesh_lock = threading.Lock()


def make_mesh(group, axes: Sequence[str] = (DATA_AXIS,),
              shape: Optional[Sequence[int]] = None) -> ProcessMesh:
    """The ``ProcessMesh`` of ``group``'s ranks on ``axes`` (outermost
    first) of ``shape`` (default: every rank on the first axis), the
    group's rank order its linear order (the JAX package's ``make_mesh``
    over ``jax.devices()``).  Every rank of ``group`` must call it with
    the same arguments: each builds its sub-group along each axis
    (``parallel.network.sub_groups``, each wait bounded by the group's
    timeout)."""
    from .network import sub_groups
    axes = tuple(axes)
    world = int(group.size())
    if shape is None:
        shape = (world,) + (1,) * (len(axes) - 1)
    shape = tuple(int(s) for s in shape)
    key = (axes, shape)
    with _mesh_lock:
        cached = _MESHES.setdefault(group, {}).get(key)
    if cached is not None:
        return cached
    if int(np.prod(shape)) != world:
        raise ValueError(f"a mesh of shape {shape} needs {int(np.prod(shape))}"
                         f" ranks; the group has {world}")
    grid = np.arange(world).reshape(shape)
    groups = {}
    for k, ax in enumerate(axes):
        if shape[k] == world:
            groups[ax] = group
            continue
        lines = np.moveaxis(grid, k, -1).reshape(-1, shape[k])
        groups[ax] = sub_groups(group, [list(map(int, b)) for b in lines],
                                f"mesh-{'.'.join(axes)}-"
                                f"{'x'.join(map(str, shape))}/{ax}")
    mesh = ProcessMesh(group, axes, shape, groups)
    with _mesh_lock:
        _MESHES[group][key] = mesh
    return mesh


def simulated_slices() -> int:
    """``LGBM_TPU_NUM_SLICES``: simulated slices on one host (the whole
    two-tier plane then runs on one card, or on thread ranks on the
    CPU); 0/unset = no simulation."""
    v = (envflags.read("LGBM_TPU_NUM_SLICES") or "").strip()
    try:
        return max(int(v), 0) if v else 0
    except ValueError:
        return 0


def make_hybrid_mesh(group, num_slices: Optional[int] = None
                     ) -> ProcessMesh:
    """The two-tier ``("dcn", "ici")`` mesh of ``group``: ``num_slices``
    slices (default: ``parallel.network.mesh_plan``'s, one a host where
    the ranks span hosts, else ``LGBM_TPU_NUM_SLICES``, else 1) of
    consecutive ranks, so the linear order, and every rank's rows, are
    the flat group's."""
    world = int(group.size())
    if num_slices is None:
        from .network import mesh_plan
        mp = mesh_plan(world, group=group)
        if mp.total_shards != world:
            raise ValueError(
                f"the mesh plan ({mp.num_slices} slice(s) x "
                f"{mp.devices_per_slice} rank(s), from {mp.source}) does "
                f"not hold the group's {world} ranks")
        num_slices = mp.num_slices
    s = max(int(num_slices), 1)
    if world % s != 0:
        raise ValueError(
            f"cannot partition {world} ranks into {s} slices; "
            "num_slices must divide the rank count")
    return make_mesh(group, HYBRID_AXES, (s, world // s))


def data_axis_of(mesh) -> Optional[Tuple[str, ...]]:
    """The axes the rows are sharded over: the two-tier pair on a
    ``("dcn", "ici")`` mesh, ``("data",)`` on a mesh with a data axis,
    None (every rank of a bare group)."""
    if not isinstance(mesh, ProcessMesh):
        return None
    if DCN_AXIS in mesh.axis_names and ICI_AXIS in mesh.axis_names:
        return HYBRID_AXES
    return (DATA_AXIS,) if DATA_AXIS in mesh.axis_names else None


def _hybrid_cfg(cfg, mesh, data_axis):
    """The two-tier mesh's slice count and the planner's election of
    flat or hierarchical sums in the grower config
    (unchanged off a two-tier mesh); the JAX package's
    learners.py:153-177."""
    if data_axis != HYBRID_AXES:
        return cfg
    from ..ops.planner import plan_collectives
    total = axis_size(mesh, data_axis)
    slices = int(mesh.shape[DCN_AXIS])
    plan = plan_collectives(
        features=0, num_bins=cfg.num_bins, quant=cfg.quant,
        num_slices=slices,
        devices_per_slice=total // slices, voting_k=cfg.voting_top_k)
    return cfg._replace(num_slices=slices, hier_reduce=plan.hierarchical)
