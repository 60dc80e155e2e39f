"""Kernel sizing (counterpart of the parts of ``lightgbm_tpu/ops/planner.py``
that the predict path and the training kernels read).

The JAX planner elects a predict chunk and a row tile from a VMEM model
of the TPU core, and pads each chunk to a ladder rung (``bucket_rows``)
to bound its compiled shapes.  Neither applies on the H100: the kernel
is compiled once and launches on the unpadded rows.  The port fixes
both sizes here:

- ``PREDICT_CHUNK_ROWS``: rows per ``DeviceForest.predict_raw`` /
  ``predict_leaf`` call to the traversal kernel.  65,536 rows keep the
  leaves-mode output of a 500-tree forest, and scores mode's [T, n] f32
  scratch, at 128 MiB on the device.

The traversal kernel B1 (``csrc/traverse.cu``) descends trees in
parallel over packed 16-byte node records (``traverse_plan``): a block
takes R rows (its [R, F] f32 X tile in shared memory) through G trees,
one thread a (row, tree) pair at a time, and walks P row tiles.

- R: at most ``TRAV_TILE_ROWS`` and the batch's rows rounded up to a
  power of two, halved until the X tile fits ``TRAV_X_BYTES`` (1,024
  features take 8 rows; a row of more than ~58,000 features is
  refused).
- G: about ``TRAV_TARGET_BLOCKS`` blocks over the (row tile, tree group)
  grid, at least a warp of pairs a block; a batch of at least
  ``TRAV_LARGE_TILES`` row tiles aims at ``TRAV_LARGE_TARGET_BLOCKS``
  (about 30 trees a block at 65,536 rows of a 500-tree forest), and P
  row tiles a block keep the grid at about that size.
- The block's trees' records are staged in shared memory when at least
  ``TRAV_STAGE_MIN_TREES`` (a large batch: all G) fit beside the X tile
  in ``TRAV_SMEM_BYTES``, a budget that keeps four blocks an SM;
  otherwise (trees of thousands of leaves, 255-leaf trees at a large
  batch) the descents read them through L1 from global memory.
- Scores mode: the descents write leaf values into a [T, n] f32
  scratch that the ordered sum adds in tree order (``SUM_ROWS`` rows a
  block, as many trees a chunk as ``SUM_TILE_BYTES`` holds).

The accumulate kernel B4 (``csrc/fused.cu``) runs over the rows sorted
by slot; the JAX planner's ``plan_fused`` VMEM model does not apply:

- The sort: a block of 32 warps counts, and later scatters,
  ``SORT_BLOCK_ROWS`` = 8,192 consecutive rows (256 a warp, fixed in
  ``csrc/fused.cu``, which refuses a block count other than
  ``sort_blocks``); one block scans the (K + 1) x ``sort_blocks``
  per-(key, block) counts.
- The accumulate's feature tile (``acc_feat_tile``): features whose
  [Ft, C, B] arena of one slot one block holds in shared memory (two
  uint32 words a cell in f32 mode, the hi/lo halves; one in int8 mode),
  at most ``ACC_MAX_FEAT_TILE`` and ``ACC_ARENA_BYTES``, balanced over
  the tiles: 7 features (42 KiB f32, 14 KiB int8) at 28 features and
  255 bins; 2 (f32) at 1023 bins.
- The accumulate's segments (``acc_seg_rows``): a block takes at most S
  sorted rows of one slot, S about n / ``ACC_TARGET_SEGS`` (at least
  ``ACC_MIN_SEG_ROWS``), so a launch has at most ceil(n / S) + K
  segments (``acc_segments``, the grid's x axis the wrapper launches;
  blocks past the device-side total exit).  At 1 M rows S = 4,096: a
  root (K = 1) is 245 segments, and a frontier slot of under 4,096 rows
  is one segment that stores its arena without atomics.
- ``ACC_THREADS``: threads per accumulate block (rows in flight).

The scan kernel B5 (``csrc/fused.cu``) runs one warp per task and
``SCAN_WARPS`` tasks of one child a block (``scan_plan``): a feature
that walks more than 32 bins is a task of its own, whose lanes walk
its bins in 32-bin chunks; narrower features are packed, in index
order, into the 32 lanes of shared tasks, one lane per bin.  A feature
walks ``max(min(num_bin, B), 1)`` bins, so the scan has no bin limit;
the plan's lane entries (``f << 5 | first lane``) hold at most
``FUSED_SCAN_MAX_FEATURES`` features.

The binning kernel B3 (``csrc/ingest.cu``) stages its tables once per
persistent block (``ingest_plan``): the member records and ragged
bound/code words of a chunk of groups (the grid's y axis walks the
chunks).  Two layouts of its X tile:

- all columns: while a column-major [F, rows + 4] f32 tile of every
  column fits beside any single group's tables (about 1,500 features),
  the chunks are cut by their tables alone (at most
  ``INGEST_TABLE_BYTES`` and what the card's per-block maximum leaves
  beside the smallest tile), and every block stages whole rows with
  vector loads: the layout of the 28- and 674-feature tables;
- the chunk's own columns: wider tables cut the chunks by their tables
  plus the [C, rows + 4] tile of the C distinct columns their members
  read, at most ``INGEST_SMEM_TARGET`` at the smallest tile, and each
  block gathers its chunk's columns (the column list is one more
  table).  A group whose tables alone exceed that is split into member
  parts: the first part bins every row in the first launch, part j in
  launch j + 1 writes only its non-zero bins, so the parts fold in
  member order (the EFB fold keeps the last member whose bin is not 0).

The tile is the largest of ``INGEST_TILE_ROWS`` whose chunks all fit
``INGEST_SMEM_TARGET``, else 32 rows (a warp bins a tile's rows, rows /
32 a lane); ``ingest_grid`` sizes each launch: as many blocks a chunk as
the card holds at once (``SM_COUNT`` x blocks per SM by shared memory
and registers), each walking row tiles; a block's warps split the
chunk's members evenly, 8 warps where two blocks fit an SM, else 16
(``INGEST_THREADS``).  Only a member whose own tables and one-column
tile exceed the card's per-block maximum is refused: a numerical
feature of more than about 57,000 bins, or a categorical one of more
than about 28,000 codes.

The whole-dataset histogram kernel (``csrc/histogram.cu``, B6): a
block keeps the [Ft, 3, B] sums of a feature tile as uint32 hi/lo
halves in shared memory; the JAX kernel's (feat_tile, block_rows) VMEM
grid does not apply:

- ``hist_feat_tile``: as many features as ``HIST_ARENA_BYTES`` holds
  (8 bytes a cell), balanced over the tiles, so no tile is a 1-feature
  tail: 9 bundle columns at 256 bins are one tile of 9; 28 features are
  two of 14.
- ``HIST_THREADS``: threads per block; a thread takes
  ``HIST_ROWS_PER_THREAD`` consecutive rows at a time.
- The row axis is cut into chunks (``hist_row_chunks``): about
  ``HIST_TARGET_BLOCKS`` blocks over the feature tiles, at least
  ``HIST_MIN_CHUNK_ROWS`` rows a chunk, since every chunk flushes its
  non-zero cells into the output with global atomics.

The out-of-core data plane's two-level budget (``plan_stream``, the
card's and the host's peaks, ``stream_override``) and the serving
fleet's shared-memory residency election (``plan_fleet``, over the
byte model of the port's ``DeviceForest``) close the module.
The JAX package's knobs steer it the same way, through
``utils.envflags``: ``LGBM_TPU_STREAM`` and ``LGBM_TPU_STREAM_BLOCK_ROWS``
where ``stream_override`` leaves the choice to the planner,
``LGBM_TPU_HOST_BYTES`` for the host's limit and ``LGBM_TPU_HBM_BYTES``
for the card's; an explicit argument wins over each.  The two-tier
mesh's election of flat or hierarchical sums (``plan_collectives``)
closes it.
"""

from __future__ import annotations

import contextlib
import functools
import os
import threading
from typing import NamedTuple, Optional, Tuple

from ..utils import envflags

PREDICT_CHUNK_ROWS = 1 << 16
SM_COUNT = 132
# shared memory a block may use without / with the dynamic opt-in (H100)
SMEM_DEFAULT_BYTES = 48 * 1024
SMEM_MAX_BYTES = 227 * 1024

TRAV_THREADS = 256
TRAV_TILE_ROWS = 128
TRAV_X_BYTES = 48 * 1024
TRAV_SMEM_BYTES = 48 * 1024
TRAV_STAGE_MIN_TREES = 2
TRAV_TARGET_BLOCKS = 4 * SM_COUNT
TRAV_LARGE_TILES = SM_COUNT
TRAV_LARGE_TARGET_BLOCKS = 64 * SM_COUNT
# a node record (feature and flags, threshold, left, right) and a
# categorical node's (cat_offset, cat_nwords)
NODE_RECORD_BYTES = 16
CAT_RECORD_BYTES = 8
SUM_ROWS = 32
SUM_TILE_BYTES = 32 * 1024


class TraversePlan(NamedTuple):
    """One traversal launch: whether it emits scores; rows R and trees G
    a descent block, the row tiles P it walks, its threads, whether its
    trees' records are staged in shared memory, and its dynamic shared
    memory; in scores mode the ordered sum's rows a block and trees a
    chunk."""

    scores: bool
    rows: int
    trees: int
    row_tiles: int
    threads: int
    stage: bool
    smem_bytes: int
    sum_rows: int = 0
    sum_trees: int = 0


def _pow2_ceil(x: int) -> int:
    return 1 << max(int(x) - 1, 0).bit_length()


@functools.lru_cache(maxsize=256)
def traverse_plan(num_features: int, nodes: int, num_trees: int,
                  rows: int, has_cat: bool = False, num_class: int = 1,
                  scores: bool = False, stage=None) -> TraversePlan:
    """The traversal launch for ``rows`` rows of ``num_features`` f32
    columns through ``num_trees`` trees of ``nodes`` node slots (see the
    module docstring).  ``stage`` forces the staging (None: the
    planner's choice); a forced staging that does not fit raises, as
    does an X tile of one row that exceeds the card's per-block
    maximum."""
    F = max(int(num_features), 1)
    I = max(int(nodes), 1)
    T = max(int(num_trees), 1)
    n = max(int(rows), 1)
    K = max(int(num_class), 1)
    R = min(TRAV_TILE_ROWS, _pow2_ceil(n))
    while R > 1 and R * F * 4 > TRAV_X_BYTES:
        R //= 2
    x_bytes = R * F * 4
    if x_bytes > SMEM_MAX_BYTES:
        raise ValueError(f"{num_features} features do not fit the "
                         f"traversal kernel's shared-memory row tile")
    tiles = -(-n // R)
    large = tiles >= TRAV_LARGE_TILES
    target = TRAV_LARGE_TARGET_BLOCKS if large else TRAV_TARGET_BLOCKS
    # trees a block: about `target` blocks over the (row tile, tree group)
    # grid, at least a warp of pairs
    want = min(T, max(-(-T * tiles // target), -(-32 // R)))
    tree_bytes = I * (NODE_RECORD_BYTES
                      + (CAT_RECORD_BYTES if has_cat else 0))
    fits = max(TRAV_SMEM_BYTES - x_bytes, 0) // tree_bytes
    if stage is None:
        # staged where the trees fit beside the X tile: all the block
        # wants when the batch is large, else at least two
        stage = fits >= (want if large else TRAV_STAGE_MIN_TREES)
    elif stage and fits < 1:
        raise ValueError(f"no tree of {nodes} nodes fits the traversal "
                         f"block's shared memory beside its X tile")
    G = min(want, fits) if stage else want
    G = -(-T // -(-T // G))          # the same trees a group (no short tail)
    smem = x_bytes + (G * tree_bytes if stage else 0)
    threads = min(TRAV_THREADS, -(-min(R, n) * G // 32) * 32)
    # a block walks P row tiles with its trees staged once: about
    # `target` blocks over the tree groups
    splits = min(tiles, max(1, -(-target // -(-T // G))))
    P = -(-tiles // splits)
    if not scores:
        return TraversePlan(False, R, G, P, threads, bool(stage), smem)
    SR = min(SUM_ROWS, _pow2_ceil(n))
    C = max(1, min(T, SUM_TILE_BYTES // (SR * 4)))
    return TraversePlan(True, R, G, P, threads, bool(stage), smem, SR, C)


FUSED_SCAN_MAX_FEATURES = 1 << 26
SCAN_WARPS = 4
SCAN_LANES = 32
SORT_BLOCK_ROWS = 8192
ACC_THREADS = 512
ACC_MAX_FEAT_TILE = 8
ACC_ARENA_BYTES = 64 * 1024
ACC_TARGET_SEGS = 256
ACC_MIN_SEG_ROWS = 2048
ACC_SEG_ROWS_STEP = 512


class ScanPlan(NamedTuple):
    """B5's warp tasks for one feature layout: ``lanes`` holds 32
    entries a task, ``f << 5 | s`` for a lane of feature f whose first
    lane is s (-1 for an idle lane); ``tasks`` is their number."""

    lanes: Tuple[int, ...]
    tasks: int


def scan_walked_bins(num_bin: int, num_bins: int) -> int:
    """Bins B5 walks for a feature: its own, at most the bin axis, and
    bin 0 at least (a padding feature still writes its tuple)."""
    return max(min(int(num_bin), int(num_bins)), 1)


def scan_plan(num_bin, num_bins: int) -> ScanPlan:
    """Cut the features ``num_bin`` [F] over a bin axis of ``num_bins``
    into B5's warp tasks: a feature that walks more than
    ``SCAN_LANES`` bins takes a task of its own (every lane, in chunks);
    the others are packed in index order into shared tasks, a run of
    lanes each.  Tasks follow feature order, so a block's warps read
    neighbouring features."""
    F = len(num_bin)
    if F > FUSED_SCAN_MAX_FEATURES:
        raise ValueError(f"the scan kernel takes at most "
                         f"{FUSED_SCAN_MAX_FEATURES} features, got {F}")
    lanes, cur = [], []
    for f, nb in enumerate(num_bin):
        w = scan_walked_bins(nb, num_bins)
        if w > SCAN_LANES or len(cur) + w > SCAN_LANES:
            if cur:
                lanes += cur + [-1] * (SCAN_LANES - len(cur))
                cur = []
        if w > SCAN_LANES:
            lanes += [f << 5] * SCAN_LANES
        else:
            cur += [(f << 5) | len(cur)] * w
    if cur:
        lanes += cur + [-1] * (SCAN_LANES - len(cur))
    return ScanPlan(tuple(lanes), len(lanes) // SCAN_LANES)


def sort_blocks(rows: int) -> int:
    """Blocks of one sort: the counts scratch holds (K + 1) x this many
    int32."""
    return -(-max(int(rows), 1) // SORT_BLOCK_ROWS)


def acc_seg_rows(rows: int) -> int:
    """Most sorted rows of one slot that one accumulate block takes."""
    want = -(-max(int(rows), 1) // ACC_TARGET_SEGS)
    want = -(-want // ACC_SEG_ROWS_STEP) * ACC_SEG_ROWS_STEP
    return max(ACC_MIN_SEG_ROWS, want)


def acc_segments(rows: int, num_slots: int) -> int:
    """The accumulate grid's x axis: a bound on the segments of any slot
    layout, ceil(n / S) + K (each slot's last segment may be short)."""
    return -(-max(int(rows), 1) // acc_seg_rows(rows)) + int(num_slots)


def acc_arena_bytes(feat_tile: int, num_bins: int, quant: bool) -> int:
    """Shared memory of one accumulate block: [Ft, C, B] cells of one
    uint32 (int8 mode, C = 2) or two (f32 mode's hi/lo halves, C = 3)."""
    return int(feat_tile) * (2 * 4 if quant else 3 * 8) * max(int(num_bins), 1)


def acc_feat_tile(num_features: int, num_bins: int, quant: bool = False
                  ) -> int:
    """Features per accumulate block: as many as ``ACC_MAX_FEAT_TILE``
    and ``ACC_ARENA_BYTES`` allow, balanced over the tiles.  Raises when
    one feature's arena exceeds the card's per-block maximum."""
    per = acc_arena_bytes(1, num_bins, quant)
    if per > SMEM_MAX_BYTES:
        raise ValueError(f"{num_bins} bins do not fit the accumulate "
                         f"kernel's shared-memory arena")
    most = max(1, min(ACC_MAX_FEAT_TILE, ACC_ARENA_BYTES // per))
    F = max(int(num_features), 1)
    tiles = -(-F // most)
    return -(-F // tiles)


HIST_THREADS = 512
HIST_ROWS_PER_THREAD = 4
HIST_ARENA_BYTES = 112 * 1024
HIST_TARGET_BLOCKS = 2 * SM_COUNT
HIST_MIN_CHUNK_ROWS = 2048


def hist_feat_tile(num_features: int, num_bins: int) -> int:
    """Features per histogram block: as many [3, B] hi/lo arenas (8
    bytes a cell) as ``HIST_ARENA_BYTES`` holds, balanced over the
    tiles.  Raises when one feature's arena exceeds the card's per-block
    maximum."""
    per_feature = 3 * 8 * max(int(num_bins), 1)
    if per_feature > SMEM_MAX_BYTES:
        raise ValueError(f"{num_bins} bins do not fit the histogram "
                         f"kernel's shared-memory arena")
    most = max(1, HIST_ARENA_BYTES // per_feature)
    F = max(int(num_features), 1)
    tiles = -(-F // most)
    return -(-F // tiles)


def hist_row_chunks(rows: int, num_features: int, feat_tile: int) -> int:
    """Row chunks of one histogram launch (grid axis x)."""
    per_chunk = -(-int(num_features) // int(feat_tile))
    want = -(-HIST_TARGET_BLOCKS // max(per_chunk, 1))
    most = max(int(rows) // HIST_MIN_CHUNK_ROWS, 1)
    return max(1, min(want, most))


SMEM_PER_SM_BYTES = 228 * 1024
# threads a block: the fewer while two blocks fit an SM's shared memory,
# else the more, to split a wide chunk's members over more warps (H100:
# 1 M x 28 in 0.152 ms at 256 against 0.164 at 512; 1 M x 674, one block
# an SM, 3.22 ms at 512 against 4.83 at 256)
INGEST_THREADS = (256, 512)
# threads an SM holds within the kernel's registers (its
# __launch_bounds__(512, 2): at most 64 a thread)
INGEST_SM_THREADS = 1024
INGEST_TILE_ROWS = (128, 64, 32)
INGEST_SMEM_TARGET = 100 * 1024
INGEST_TABLE_BYTES = 96 * 1024
_MEMBER_INTS = 6
# a chunk record: groups [g0, g1), members [m0, m1), words [w0, w1),
# columns [c0, c1) of the plan's column lists
CHUNK_INTS = 8
# the kernel's launch modes (csrc/ingest.cu): whole rows of X; the
# chunk's own columns; those, as a later part of split groups (only
# non-zero bins are written)
MODE_WHOLE_ROWS, MODE_GATHERED, MODE_OVERLAY = 0, 1, 2


class IngestPlan(NamedTuple):
    """One binner's launch shape: rows per X tile; the launches, each a
    tuple of chunk records (``CHUNK_INTS`` ints); the chunks' column
    lists, concatenated; each member's column index within its chunk's
    list; the dynamic shared memory of a block, and its threads;
    whether the chunks stage whole rows of X (all F columns)."""

    tile_rows: int
    launches: Tuple[Tuple[Tuple[int, ...], ...], ...]
    columns: Tuple[int, ...]
    local_column: Tuple[int, ...]
    smem_bytes: int
    threads: int
    whole_rows: bool

    @property
    def num_chunks(self) -> int:
        return sum(len(launch) for launch in self.launches)

    def mode(self, launch: int) -> int:
        """The kernel's mode for launch ``launch``."""
        if self.whole_rows:
            return MODE_WHOLE_ROWS
        return MODE_OVERLAY if launch > 0 else MODE_GATHERED


def _ingest_tile_bytes(num_columns: int, tile_rows: int,
                       threads: int) -> int:
    """The column-major [C, rows + 4] f32 X tile and the warps' partial
    bins of the groups they share, [warps, 2, rows] int32."""
    return 4 * (int(num_columns) * (tile_rows + 4)
                + 2 * (threads // 32) * tile_rows)


def _ingest_blocks_per_sm(smem_bytes: int, threads: int) -> int:
    return max(1, min(INGEST_SM_THREADS // threads,
                      SMEM_PER_SM_BYTES // (smem_bytes + 1024)))


def ingest_plan(num_features: int, group_ptr, member_words,
                member_columns) -> IngestPlan:
    """Cut the groups into chunks (and a group too large for one chunk
    into member parts over successive launches) and pick the X tile and
    the block's threads.  ``group_ptr`` [G + 1] are the member
    boundaries of the groups, ``member_words`` [M + 1] the word
    boundaries of the members' runs, ``member_columns`` [M] the raw
    column each member reads.  Raises ``ValueError`` only for a member
    whose own tables and one-column tile exceed the card's per-block
    maximum (see the module docstring)."""
    F = int(num_features)
    gp = [int(x) for x in group_ptr]
    mw = [int(x) for x in member_words]
    cols = [int(x) for x in member_columns]
    G = len(gp) - 1

    def tables(m0: int, m1: int, ng: int, nc: int) -> int:
        return 4 * (_MEMBER_INTS * (m1 - m0) + (ng + 1) + (mw[m1] - mw[m0])
                    + nc)

    small_all = _ingest_tile_bytes(F, INGEST_TILE_ROWS[-1],
                                   INGEST_THREADS[-1])
    budget = min(INGEST_TABLE_BYTES, SMEM_MAX_BYTES - small_all)
    # (g0, g1, m0, m1, column set or None for all F) per chunk, per launch
    launches = [[]]
    whole_rows = all(tables(gp[g], gp[g + 1], 1, 0) <= budget
                     for g in range(G))
    if whole_rows:
        # every block stages whole rows (all F columns)
        first = 0
        for g in range(G + 1):
            if g == G or tables(gp[first], gp[g + 1], g + 1 - first,
                                0) > budget:
                if g > first:
                    launches[0].append((first, g, gp[first], gp[g], None))
                first = g
    else:
        def cost(m0, m1, ng, cset):
            return (tables(m0, m1, ng, len(cset))
                    + _ingest_tile_bytes(len(cset), INGEST_TILE_ROWS[-1],
                                         INGEST_THREADS[-1]))
        cur, cset = None, set()
        for g in range(G):
            a, b = gp[g], gp[g + 1]
            gset = set(cols[a:b])
            if cost(a, b, 1, gset) > INGEST_SMEM_TARGET:
                if cur is not None:
                    launches[0].append((cur, g, gp[cur], a, cset))
                    cur, cset = None, set()
                parts, m0, pset = [], a, set()
                for m in range(a, b):
                    if cost(m, m + 1, 1, {cols[m]}) > SMEM_MAX_BYTES:
                        raise ValueError(
                            f"member {m} (column {cols[m]}): its binning "
                            f"tables ({tables(m, m + 1, 1, 1)} bytes) "
                            f"exceed the card's shared memory")
                    if m > m0 and cost(m0, m + 1, 1, pset | {cols[m]}) \
                            > INGEST_SMEM_TARGET:
                        parts.append((m0, m, pset))
                        m0, pset = m, set()
                    pset = pset | {cols[m]}
                parts.append((m0, b, pset))
                for j, (p0, p1, ps) in enumerate(parts):
                    while len(launches) <= j:
                        launches.append([])
                    launches[j].append((g, g + 1, p0, p1, ps))
                continue
            if cur is not None and cost(gp[cur], b, g + 1 - cur,
                                        cset | gset) > INGEST_SMEM_TARGET:
                launches[0].append((cur, g, gp[cur], a, cset))
                cur, cset = None, set()
            if cur is None:
                cur = g
            cset = cset | gset
        if cur is not None:
            launches[0].append((cur, G, gp[cur], gp[G], cset))

    columns, local = [], list(cols)
    records, chunk_bytes = [], []
    for launch in launches:
        recs = []
        for g0, g1, m0, m1, cset in launch:
            c0 = len(columns)
            if cset is None:
                lst = list(range(F))
            else:
                lst = sorted(cset)
                pos = {c: i for i, c in enumerate(lst)}
                for m in range(m0, m1):
                    local[m] = pos[cols[m]]
            columns.extend(lst)
            recs.append((g0, g1, m0, m1, mw[m0], mw[m1], c0, len(columns)))
            chunk_bytes.append((len(lst), tables(
                m0, m1, g1 - g0, 0 if cset is None else len(lst))))
        records.append(tuple(recs))
    chunk_bytes = chunk_bytes or [(F, 4)]
    for threads in INGEST_THREADS:
        for rows in INGEST_TILE_ROWS:
            smem = max(_ingest_tile_bytes(nc, rows, threads) + tb
                       for nc, tb in chunk_bytes)
            if smem <= INGEST_SMEM_TARGET:
                break
        if _ingest_blocks_per_sm(smem, threads) >= 2:
            break
    if smem > SMEM_MAX_BYTES:
        raise ValueError(f"{F} features do not fit the binning kernel's "
                         f"shared-memory row tile")
    return IngestPlan(rows, tuple(records), tuple(columns), tuple(local),
                      smem, threads, whole_rows)


def ingest_grid(plan: IngestPlan, rows: int, launch: int = 0) -> int:
    """Persistent blocks per chunk of one launch: as many as the card
    holds at once (by shared memory and registers), at most one per row
    tile."""
    per_sm = _ingest_blocks_per_sm(plan.smem_bytes, plan.threads)
    chunks = len(plan.launches[launch])
    tiles = -(-int(rows) // plan.tile_rows)
    return max(1, min(tiles, SM_COUNT * per_sm // max(chunks, 1)))


# ----------------------------------------------------------------------
# the two-level budget of the out-of-core data plane (the JAX planner's
# plan_stream, ops/planner.py:1128-1215 and :1485-1590)
# ----------------------------------------------------------------------
#
# Training keeps its per-row state (values, scores, gradients, leaf
# routing) on the card either way; what streaming moves off the card is
# the binned [G, n] matrix, which then lives in a checksummed spill
# store (``data/blockstore.py``) and crosses to the card a row block at
# a time, every histogram pass.  ``plan_stream`` elects streaming when
# the resident training peak blows the card's budget or the resident
# host peak blows the host's, and searches a block size whose streamed
# peaks fit both.  The device side is modelled on the port's own
# tensors (``predict_peak_bytes``): the JAX package's model prices TPU
# lane padding and XLA scatter transients, which the card does not
# have.  The host side (``predict_host_peak_bytes``) is the JAX
# package's model, number for number.

# the share of a limit a plan may claim: the CUDA context, the caching
# allocator's slack and the phases' other tensors need the rest of the
# card; the OS and the Python runtime the rest of the host
HEADROOM = 0.85
HOST_HEADROOM = 0.8
# the device budget of a plan on a device with no card limit (the CPU)
NO_DEVICE_LIMIT = 1 << 62
DEFAULT_HOST_BYTES = 8 * (1 << 30)
# smallest and largest streamed row block: a transfer and a kernel pass
# over fewer rows are dominated by launch overhead (tests force smaller
# blocks through ``stream_override``)
MIN_STREAM_BLOCK_ROWS = 1 << 16
MAX_STREAM_BLOCK_ROWS = 1 << 24
# rows of raw f32 input binned a launch when the input streams in
# chunks (``data.stream.IngestPump``): one B3 launch a chunk
INGEST_CHUNK_ROWS = 1 << 17

# the in-process override of the election; where it leaves a choice to
# the planner (None), the JAX package's LGBM_TPU_STREAM and
# LGBM_TPU_STREAM_BLOCK_ROWS knobs make it (``_stream_force``,
# ``_stream_block_rows``)
_override = {"force": None, "block_rows": None}


@contextlib.contextmanager
def stream_override(force: Optional[bool] = None,
                    block_rows: Optional[int] = None):
    """Within the block, ``force=True`` elects streaming whatever the
    budgets say, ``force=False`` never streams, and ``block_rows`` fixes
    the streamed block (at least 128 rows); None leaves either to the
    planner (and to ``LGBM_TPU_STREAM`` / ``LGBM_TPU_STREAM_BLOCK_ROWS``
    where they are set).  Nests: the inner block's values win, the outer
    ones come back on exit."""
    saved = dict(_override)
    _override["force"] = force
    _override["block_rows"] = (None if block_rows is None
                               else max(int(block_rows), 128))
    try:
        yield
    finally:
        _override.update(saved)


def _stream_force() -> tuple:
    """(force, what set it): ``stream_override``'s force, else the
    ``LGBM_TPU_STREAM`` knob's ("1" forces streaming, "0" forbids it;
    unset or another word: None, the budgets decide)."""
    if _override["force"] is not None:
        f = _override["force"]
        return f, f"stream_override(force={f})"
    v = (envflags.read("LGBM_TPU_STREAM") or "").strip().lower()
    if v in ("1", "on", "force", "true", "yes"):
        return True, "LGBM_TPU_STREAM=1"
    if v in ("0", "off", "false", "no", "none"):
        return False, "LGBM_TPU_STREAM=0"
    return None, ""


def _stream_block_rows() -> Optional[int]:
    """``stream_override``'s block, else ``LGBM_TPU_STREAM_BLOCK_ROWS``
    (at least 128 rows), else None."""
    if _override["block_rows"] is not None:
        return _override["block_rows"]
    v = (envflags.read("LGBM_TPU_STREAM_BLOCK_ROWS") or "").strip()
    try:
        return max(int(float(v)), 128) if v else None
    except ValueError:
        return None


def _env_bytes(name: str) -> Optional[int]:
    """A byte-count knob's value (at least 1), or None unset or unparsable."""
    v = (envflags.read(name) or "").strip()
    try:
        return max(int(float(v)), 1) if v else None
    except ValueError:
        return None


def host_limit_bytes() -> tuple:
    """(limit_bytes, source) of the host side of the budget:
    ``LGBM_TPU_HOST_BYTES`` where set, else /proc/meminfo's MemAvailable
    (what this process may still claim), else ``DEFAULT_HOST_BYTES``.
    Never raises."""
    env = _env_bytes("LGBM_TPU_HOST_BYTES")
    if env is not None:
        return env, "env"
    try:
        with open("/proc/meminfo") as fh:
            for line in fh:
                if line.startswith("MemAvailable:"):
                    kb = int(line.split()[1])
                    if kb > 0:
                        return kb * 1024, "meminfo"
    except (OSError, ValueError, IndexError):
        pass
    return DEFAULT_HOST_BYTES, "default"


def device_limit_bytes(device) -> tuple:
    """(limit_bytes, source) of the card side: ``LGBM_TPU_HBM_BYTES``
    where set (on any device: a fake memory size for tests), else the
    free bytes ``torch.cuda.mem_get_info`` reports on ``device`` plus
    what the caching allocator holds reserved and unused.  A CPU device
    has no card limit (None): only a caller's budget applies there."""
    env = _env_bytes("LGBM_TPU_HBM_BYTES")
    if env is not None:
        return env, "env"
    import torch
    dev = torch.device(device)
    if dev.type != "cuda":
        return None, "none"
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    free, _total = torch.cuda.mem_get_info(idx)
    cached = (torch.cuda.memory_reserved(idx)
              - torch.cuda.memory_allocated(idx))
    return int(free + cached), "mem_get_info"


def predict_host_peak_bytes(rows: int, groups: int, bin_item: int = 1,
                            block_rows: int = 0) -> tuple:
    """(peak_bytes, breakdown) of the HOST side of one training run (the
    JAX package's model).  ``block_rows == 0``: the resident loader, the
    whole [n, G] binned matrix, one f64 column of binning scratch per
    worker and the per-row metadata; ``block_rows > 0``: the streaming
    loader, three block windows (the spill writer's buffer and the
    pump's two read windows) in place of the matrix."""
    n = max(int(rows), 1)
    G = max(int(groups), 1)
    b = {}
    b["row_meta"] = 16 * n
    if block_rows <= 0:
        b["binned"] = n * G * bin_item
        b["bin_scratch"] = 8 * 8 * n
    else:
        C = int(block_rows)
        b["block_windows"] = 3 * C * G * bin_item
        b["bin_scratch"] = 8 * 8 * C
    return sum(b.values()), b


def _row_state_bytes(n: int, num_class: int, quant: bool) -> dict:
    """The per-row tensors a booster keeps on the card either way."""
    K = max(int(num_class), 1)
    b = {}
    # the grower's value block [3, n] f32 ([2, n] int8 levels quantized)
    b["vals"] = 2 * n if quant else 12 * n
    # scores [K, n] f32, gradients and hessians [K, n] f32 each, and the
    # quantized levels' [K, 2, n] int8
    b["scores"] = 4 * K * n
    b["grads"] = 8 * K * n + (2 * K * n if quant else 0)
    # leaf_id [n] int64 with the tree's returned copy; the row mask f32,
    # member bool and the booster's all-ones mask f32
    b["leaf_id"] = 16 * n
    b["row_masks"] = 9 * n
    return b


def _hist_cache_bytes(features: int, num_bins: int, num_leaves: int,
                      quant: bool) -> int:
    """The tree's histogram cache [L + 1, C, F, B]: int64 fixed point,
    int32 level sums quantized."""
    cell = (2 * 4) if quant else (3 * 8)
    return (max(int(num_leaves), 2) + 1) * max(int(features), 1) \
        * max(int(num_bins), 2) * cell


def _transient_bytes(n: int, rows: int, features: int, num_bins: int,
                     num_leaves: int, quant: bool, round_width: int,
                     streamed: bool) -> dict:
    """The peak of each step's transients; the step with the largest
    sets the card's peak (they are never live together).  ``rows``: the
    rows of a B4 pass (every row resident, a block streamed).

    - ``round_commit``: four [KCAP, C, F, B] arenas (the parents
      gathered, the smaller children, the left and the right children)
      and, over every row, the new leaf ids (``torch.where`` of an int64
      and its int64 operand, and bits), with the rows' candidate rank
      (int64) and goes-left bits where they are not the streamed
      grower's own [n] buffers;
    - ``round_accumulate``: two arenas (the parents and B4's output) and
      the routing and B4's slot sort over ``rows`` rows (rank, feature
      and bin indices, bits, slot, order, and the slotted values: int64
      fixed point a channel, int8 levels quantized), with a streamed
      block's copy of its values;
    - ``quantize`` (quantized): the stochastic rounding's threefry draw,
      eight [2, n] int64 words live at once, and the weighted gradients.

    Measured at 1 M x 28 rows, 255 leaves and bins (NVIDIA H100 80GB
    HBM3, 700.00 W; ``tools/torch_stream_compare.py --what memory``):
    the quantized peaks are the draw's, the f32 peaks the commit's."""
    F = max(int(features), 1)
    B = max(int(num_bins), 2)
    L = max(int(num_leaves), 2)
    KCAP = min(max(L - 1, 1), max(int(round_width), 1))
    arena = KCAP * F * B * ((2 * 4) if quant else (3 * 8))
    r = max(int(rows), 1)
    t = {"round_commit": 4 * arena + 17 * n + (0 if streamed else 9 * n),
         "round_accumulate": 2 * arena + r * (48 if quant else 70)
         + (r * (2 if quant else 12) if streamed else 0)}
    if quant:
        t["quantize"] = 136 * n
    return t


def _device_peak(persistent: dict, transient: dict) -> tuple:
    """(peak_bytes, breakdown): what stays, plus the largest step."""
    step = max(transient, key=transient.get)
    b = dict(persistent)
    b[step] = transient[step]
    return int(sum(b.values())), b


def predict_peak_bytes(rows: int, features: int, num_bins: int,
                       num_leaves: int = 31, num_class: int = 1,
                       quant: bool = False, round_width: int = 128
                       ) -> tuple:
    """(peak_bytes, breakdown) of one resident training step on the card:
    the binned [G, n] matrix (uint8, or int32 past 256 bins), the
    per-row state and the histogram cache, and the largest step's
    transients (``_transient_bytes``).  The right order for the
    fits-or-not verdict, not an allocator simulation."""
    n = max(int(rows), 1)
    G = max(int(features), 1)
    b = {"binned": G * n * (1 if num_bins <= 256 else 4)}
    b.update(_row_state_bytes(n, num_class, quant))
    b["hist_cache"] = _hist_cache_bytes(G, num_bins, num_leaves, quant)
    return _device_peak(b, _transient_bytes(
        n, n, G, num_bins, num_leaves, quant, round_width, False))


def predict_stream_device_peak_bytes(rows: int, features: int,
                                     num_bins: int, block_rows: int,
                                     num_leaves: int = 31,
                                     num_class: int = 1,
                                     quant: bool = False,
                                     round_width: int = 128) -> int:
    """The card's peak of one STREAMED training step: the resident model
    with the matrix replaced by the pump's two block windows (the block
    in use and the next), the streamed grower's [n] candidate rank
    (int64) and goes-left bits, and B4's transients at block scale."""
    n = max(int(rows), 1)
    G = max(int(features), 1)
    C = min(max(int(block_rows), 1), n)
    b = {"block_windows": 2 * G * C * (1 if num_bins <= 256 else 4)}
    b.update(_row_state_bytes(n, num_class, quant))
    b["hist_cache"] = _hist_cache_bytes(G, num_bins, num_leaves, quant)
    b["round_rows"] = 9 * n
    return _device_peak(b, _transient_bytes(
        n, C, G, num_bins, num_leaves, quant, round_width, True))[0]


class StreamPlan(NamedTuple):
    """The two-level budget's verdict (the JAX package's fields)."""

    stream: bool                       # row-block streaming elected
    block_rows: int                    # rows a streamed block (0 = resident)
    num_blocks: int
    resident_device_ok: bool           # full residency fits the card
    resident_host_ok: bool             # full residency fits the host
    predicted_device_peak_bytes: int   # for the chosen mode
    predicted_host_peak_bytes: int     # for the chosen mode
    device_budget_bytes: int
    host_budget_bytes: int
    host_limit_bytes: int
    host_limit_source: str             # "meminfo" | "default" | "caller"
    feasible: bool                     # the chosen mode fits both budgets
    reason: str                        # why streaming was or was not elected

    def summary(self) -> dict:
        """JSON-friendly form."""
        return {k: getattr(self, k) for k in self._fields}


def plan_stream(rows: int, features: int, num_bins: int,
                num_leaves: int = 31, num_class: int = 1,
                quant: bool = False, round_width: int = 128, device=None,
                device_budget_bytes: Optional[int] = None,
                host_budget_bytes: Optional[int] = None,
                ledger: Optional["ResidencyLedger"] = None) -> StreamPlan:
    """Resident or row-block-streamed training for a shape.

    Streaming is elected when the resident peak blows either budget (the
    card's, ``predict_peak_bytes``; the host's,
    ``predict_host_peak_bytes``), or ``stream_override(force=True)`` is
    in effect.  The block search takes the largest power of two from
    ``MAX_STREAM_BLOCK_ROWS`` down whose streamed peaks fit both budgets
    (a block of every row is residency, so it is skipped); the port's
    fold is exact for any partition, so no tile alignment applies.
    ``feasible=False`` means not even ``MIN_STREAM_BLOCK_ROWS`` fits.
    Budgets: ``device_budget_bytes``/``host_budget_bytes`` given by the
    caller (times ``HEADROOM``; the host's times ``HOST_HEADROOM``), else
    the card's free memory on ``device`` (``device_limit_bytes``; a CPU
    device sets no card limit) and the host's available memory.  With
    ``ledger`` (a ``ResidencyLedger``; a caller's budget wins over it)
    the card's budget is the ledger's remainder, ``HEADROOM`` already
    applied by the ledger."""
    n = max(int(rows), 1)
    if device_budget_bytes is not None:
        dev_budget = int(device_budget_bytes * HEADROOM)
    elif ledger is not None:
        dev_budget = int(ledger.available_bytes())
    else:
        lim, _ = (device_limit_bytes(device) if device is not None
                  else (None, "none"))
        dev_budget = (int(lim * HEADROOM) if lim is not None
                      else NO_DEVICE_LIMIT)
    if host_budget_bytes is not None:
        host_limit, host_src = int(host_budget_bytes), "caller"
    else:
        host_limit, host_src = host_limit_bytes()
    host_budget = int(host_limit * HOST_HEADROOM)
    bin_item = 1 if num_bins <= 256 else 2

    resident_dev = predict_peak_bytes(n, features, num_bins, num_leaves,
                                      num_class, quant, round_width)[0]
    resident_host = predict_host_peak_bytes(n, features, bin_item)[0]
    dev_ok = resident_dev <= dev_budget
    host_ok = resident_host <= host_budget
    forced, forced_by = _stream_force()
    want = forced if forced is not None else not (dev_ok and host_ok)

    def mk(stream, block, reason, dev_peak, host_peak):
        nb = 0 if block <= 0 else -(-n // block)
        return StreamPlan(
            stream=stream, block_rows=block, num_blocks=nb,
            resident_device_ok=dev_ok, resident_host_ok=host_ok,
            predicted_device_peak_bytes=int(dev_peak),
            predicted_host_peak_bytes=int(host_peak),
            device_budget_bytes=dev_budget, host_budget_bytes=host_budget,
            host_limit_bytes=host_limit, host_limit_source=host_src,
            feasible=(dev_peak <= dev_budget and host_peak <= host_budget),
            reason=reason)

    if not want:
        reason = ("disabled by " + forced_by if forced is False
                  else "resident fits both budgets")
        return mk(False, 0, reason, resident_dev, resident_host)

    def peaks(block):
        return (predict_stream_device_peak_bytes(
                    n, features, num_bins, block, num_leaves, num_class,
                    quant, round_width),
                predict_host_peak_bytes(n, features, bin_item, block)[0])

    reason = ("forced by " + forced_by if forced else
              ("device+host" if not dev_ok and not host_ok else
               "device" if not dev_ok else "host") + " budget exceeded")
    forced_block = _stream_block_rows()
    if forced_block is not None:
        block = min(forced_block, n)
        dp, hp = peaks(block)
        return mk(True, block, reason + " (block forced)", dp, hp)
    block = MAX_STREAM_BLOCK_ROWS
    while block > MIN_STREAM_BLOCK_ROWS:
        if block < n:              # a single-block "stream" is residency
            dp, hp = peaks(block)
            if dp <= dev_budget and hp <= host_budget:
                return mk(True, block, reason, dp, hp)
        block //= 2
    block = min(MIN_STREAM_BLOCK_ROWS, n)
    dp, hp = peaks(block)
    return mk(True, block, reason, dp, hp)


# ----------------------------------------------------------------------
# the serving fleet's residency election
# ----------------------------------------------------------------------
#
# A fleet (``fleet/``) keeps N models' ``DeviceForest`` tensors in the
# memory of one card.  ``plan_fleet`` models each model's resident bytes
# and the bytes one call of each warmed bucket allocates, elects which
# models (and which of their buckets) stay on the card under the budget,
# and marks the rest evicted: an evicted model serves through the host
# path, bit-identical, until a replan readmits it.  The byte model is
# the card's own: it counts exactly the tensors the port's
# ``DeviceForest`` holds (the JAX package's model pads to TPU tiles and
# prices 22 bytes a node, neither of which the card has).  The plain
# planes stay beside the kernel's packed records, and B1 reads the bf16
# and int8 planes widened to f32, so a routing-only int8 forest holds
# more bytes than a bf16 one (ROADMAP C-24).

# bytes a node of the eight int32 planes (split_feature, left, right,
# missing_type, default_left, is_cat, cat_offset, cat_nwords)
_FOREST_PLANE_BYTES = 8 * 4
# the threshold plane's bytes a node, by storage precision; int8 adds
# the fix mask (bool) and the f32 values of the nodes left unquantized
_THRESHOLD_BYTES = {"f32": 4, "bf16": 2, "int8": 1 + 1 + 4}


def predict_forest_bytes(num_trees: int, nodes_dim: int, leaves_dim: int,
                         precision: str = "f32", cat_words: int = 0,
                         accel: Optional[bool] = None,
                         routing_only: bool = False) -> int:
    """Bytes on the card of ONE model's ``DeviceForest`` tensors, exactly:
    the threshold plane at ``precision`` (int8: its codes, fix mask, f32
    fix values and a f32 scale a tree), the eight int32 planes, the
    packed records ``nodes`` [T, I, 4] and ``cat_records`` ([T, I, 2]
    with categorical splits, else [1, 1, 2]), the bitset words
    (``cat_words`` of them; 0 means a forest without categorical splits,
    which keeps one word), and the f32 leaf values unless
    ``routing_only``.  ``nodes_dim``/``leaves_dim`` are the stacked
    forest's [T, I]/[T, L] axes.  ``accel`` is the JAX package's TPU
    padding switch, kept so its callers run: it has no effect on the
    card."""
    T = max(int(num_trees), 1)
    I = max(int(nodes_dim), 1)
    L = max(int(leaves_dim), 1)
    W = int(cat_words)
    if precision not in _THRESHOLD_BYTES:
        raise ValueError(f"unknown forest precision {precision!r}")
    b = T * I * (_THRESHOLD_BYTES[precision] + _FOREST_PLANE_BYTES
                 + NODE_RECORD_BYTES)
    if precision == "int8":
        b += T * 4                          # threshold_scale [T, 1] f32
    b += T * I * CAT_RECORD_BYTES if W > 0 else CAT_RECORD_BYTES
    b += 4 * max(W, 1)                      # cat_words
    if not routing_only:
        b += T * L * 4                      # leaf_value f32
    return int(b)


def predict_program_bytes(num_trees: int, bucket_rows: int, features: int,
                          accel: Optional[bool] = None, num_class: int = 1,
                          emit_scores: bool = False) -> int:
    """Bytes one call of a bucket-shaped serving program allocates on the
    card: the [bucket, F] f32 input and B1's output, leaf ids [T, bucket]
    int32, or with ``emit_scores`` the [K, bucket] f32 scores and the
    [T, bucket] f32 scratch of the ordered sum.  The residency election
    charges it a warmed bucket.  ``accel`` has no effect on the card."""
    T = max(int(num_trees), 1)
    C = max(int(bucket_rows), 1)
    F = max(int(features), 1)
    b = C * F * 4
    if emit_scores:
        b += max(int(num_class), 1) * C * 4 + T * C * 4
    else:
        b += T * C * 4
    return int(b)


def fleet_replica_bytes(m: "FleetModelShape",
                        accel: Optional[bool] = None):
    """The card's cost of ONE replica of ``m``: ``(forest_bytes,
    {bucket: program_bytes})``, the unit both the one-card residency
    election (``plan_fleet``) and the placement planner
    (``fleet.topology.plan_topology``) charge.  A f32 model's buckets
    are charged the scores mode (it serves in that mode once its
    epilogue verifies), a low-precision model's the leaves mode
    (routing only)."""
    lowprec = m.precision != "f32"
    fb = predict_forest_bytes(
        m.num_trees, m.nodes_dim, m.leaves_dim, m.precision,
        m.cat_words, accel, routing_only=lowprec)
    ladder = sorted(set(int(b) for b in m.buckets)) or [8]
    prog = {b: predict_program_bytes(m.num_trees, b, m.features, accel,
                                     m.num_class, emit_scores=not lowprec)
            for b in ladder}
    return fb, prog


class FleetModelShape(NamedTuple):
    """One serving model's shape as the fleet election sees it."""

    name: str
    num_trees: int
    nodes_dim: int              # padded internal-node axis I
    leaves_dim: int             # padded leaf axis L
    features: int
    num_class: int = 1
    buckets: tuple = ()         # the model's bucket ladder (row counts)
    weight: float = 1.0         # admission weight (fleet config)
    age_s: float = 0.0          # seconds since last request (0 = hot)
    precision: str = "f32"      # "f32" | "bf16" | "int8"
    cat_words: int = 0


class FleetModelPlan(NamedTuple):
    """Residency verdict for one model."""

    name: str
    resident: bool              # its DeviceForest stays on the card
    resident_buckets: tuple     # buckets whose programs stay warm
    forest_bytes: int           # charged when resident
    program_bytes: int          # charged for the resident buckets
    priority: float             # weight / (1 + age): the election key


class FleetPlan(NamedTuple):
    """Shared-memory residency plan of a serving fleet.  Always
    servable: an evicted model serves through the host path, so
    ``feasible`` is about residency on the card, not about serving."""

    models: tuple               # FleetModelPlan per input model, input order
    total_resident_bytes: int
    budget_bytes: int
    limit_bytes: int
    limit_source: str           # "mem_get_info" | "env" | "none" | "caller"
    #                             | "ledger"
    evicted: tuple              # names of non-resident models
    pressure: float             # wanted-resident bytes / budget
    feasible: bool              # every model got residency

    def summary(self) -> dict:
        """JSON-friendly form for telemetry (the JAX package's keys)."""
        return {
            "models": [
                {"name": m.name, "resident": m.resident,
                 "resident_buckets": list(m.resident_buckets),
                 "forest_bytes": m.forest_bytes,
                 "program_bytes": m.program_bytes,
                 "priority": round(m.priority, 6)}
                for m in self.models
            ],
            "total_resident_bytes": self.total_resident_bytes,
            "budget_bytes": self.budget_bytes,
            "hbm_limit_bytes": self.limit_bytes,
            "limit_source": self.limit_source,
            "evicted": list(self.evicted),
            "pressure": round(self.pressure, 4),
            "feasible": self.feasible,
        }


def fleet_limit_bytes(device=None) -> tuple:
    """(limit_bytes, budget_bytes, source) of a fleet on ``device`` (None:
    the current CUDA device, which a host without CUDA refuses):
    ``device_limit_bytes`` with ``HEADROOM`` applied; a CPU device has no
    card limit (``NO_DEVICE_LIMIT``)."""
    from ..basic import resolve_device
    lim, source = device_limit_bytes(resolve_device(device))
    if lim is None:
        return NO_DEVICE_LIMIT, NO_DEVICE_LIMIT, source
    return int(lim), int(lim * HEADROOM), source


def plan_fleet(models, budget_bytes: Optional[int] = None,
               accel: Optional[bool] = None, ledger=None,
               device=None) -> FleetPlan:
    """Elect per-model residency for a serving fleet on ``device``.

    Greedy by priority ``weight / (1 + age_s)``, hot heavily-weighted
    models first.  A model is admitted when its forest plus at least its
    smallest bucket's program fit what the budget has left; further
    buckets are admitted smallest first.  Models that do not fit are
    evicted.  The budget is ``budget_bytes`` (the caller's limit) or the
    card's (``fleet_limit_bytes``), ``HEADROOM`` applied either way;
    with ``ledger`` (a ``ResidencyLedger``) and no ``budget_bytes`` it is
    the ledger's remainder: bytes another plane holds (an in-flight
    training refresh) are not the fleet's."""
    if budget_bytes is not None:
        limit, source = int(budget_bytes), "caller"
        budget = int(limit * HEADROOM)
    elif ledger is not None:
        limit, source = int(ledger.limit_bytes), "ledger"
        budget = int(ledger.available_bytes())
    else:
        limit, budget, source = fleet_limit_bytes(device)
    models = list(models)

    def prio(m) -> float:
        return m.weight / (1.0 + max(m.age_s, 0.0))

    order = sorted(range(len(models)), key=lambda i: (-prio(models[i]), i))
    plans: dict = {}
    used = 0
    wanted = 0
    for i in order:
        m = models[i]
        fb, prog = fleet_replica_bytes(m, accel)
        ladder = sorted(prog)
        wanted += fb + sum(prog.values())
        if used + fb + prog[ladder[0]] > budget:
            plans[i] = FleetModelPlan(m.name, False, (), fb, 0, prio(m))
            continue
        used += fb
        taken, pb = [], 0
        for b in ladder:
            if used + prog[b] <= budget:
                taken.append(b)
                used += prog[b]
                pb += prog[b]
        plans[i] = FleetModelPlan(m.name, True, tuple(taken), fb, pb,
                                  prio(m))
    ordered = tuple(plans[i] for i in range(len(models)))
    evicted = tuple(p.name for p in ordered if not p.resident)
    return FleetPlan(
        models=ordered, total_resident_bytes=used, budget_bytes=budget,
        limit_bytes=limit, limit_source=source, evicted=evicted,
        pressure=(wanted / budget) if budget > 0 else float("inf"),
        feasible=not evicted)


# ======================================================================
# The residency ledger: one budget a card, which the serving and the
# training planes lease from (the JAX package's planner.py:1590-1814).
#
# Each planner above models its own plane's peak against a budget it
# takes as its own, which is how a training refresh beside a resident
# fleet over-commits a card.  ``ResidencyLedger`` arbitrates: one
# post-``HEADROOM`` budget a card, explicit leases (owner, plane, bytes,
# preemptible) and a ``ledger=`` arm on ``plan_stream``, ``plan_fleet``
# (and ``fleet.topology.plan_topology``, ``data.BulkScorer``) that makes
# each election run against the ledger's remainder.  An infeasible
# co-residency is a ``LedgerError`` that carries the lease table, not an
# out-of-memory error.  Every ledger event is a ``planner.ledger`` trace
# instant, mirrored to the ``ledger_*`` gauges.
#
# The ledger's default limit is the card's whole memory (the second
# value of ``torch.cuda.mem_get_info``), as the JAX ledger takes the
# device's whole HBM: ``device_limit_bytes`` (free memory plus the
# allocator's unused cache) would charge a resident fleet twice, once as
# allocated and again as its lease.  ``LGBM_TPU_HBM_BYTES`` and
# ``limit_bytes=`` override it, as in the JAX package.
# ======================================================================


class LedgerError(RuntimeError):
    """A lease asks for more than the ledger has left: co-residency is
    refused rather than run out of memory.  The message carries the
    lease table, so the operator sees who holds the card."""


class Lease(NamedTuple):
    """One admitted residency claim."""

    lease_id: int
    owner: str                  # e.g. "fleet:ranker" / "refresh:ranker"
    plane: str                  # "serving" | "train"
    nbytes: int
    preemptible: bool           # preempt() may evict it


def ledger_limit_bytes(device=None) -> tuple:
    """(limit_bytes, source) of a ledger on ``device`` (None: the current
    CUDA device, which a host without CUDA refuses):
    ``LGBM_TPU_HBM_BYTES`` where set, else the card's total memory; a
    CPU device has no card limit (``NO_DEVICE_LIMIT``)."""
    env = _env_bytes("LGBM_TPU_HBM_BYTES")
    if env is not None:
        return env, "env"
    import torch
    from ..basic import resolve_device
    dev = resolve_device(device)
    if dev.type != "cuda":
        return NO_DEVICE_LIMIT, "none"
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    return int(torch.cuda.mem_get_info(idx)[1]), "mem_get_info_total"


class ResidencyLedger:
    """One card's budget, shared by the serving and the training planes.

    Thread-safe: a fleet's replan and a co-resident refresh lease and
    release concurrently.  The ledger applies ``HEADROOM`` once to the
    limit (``limit_bytes``, else ``ledger_limit_bytes(device)``); a
    planner handed the ledger takes ``available_bytes()`` as it is, so
    the slack is never charged twice."""

    def __init__(self, limit_bytes: Optional[int] = None, device=None):
        if limit_bytes is not None:
            limit, source = max(int(limit_bytes), 1), "caller"
        else:
            limit, source = ledger_limit_bytes(device)
        self.limit_bytes = limit
        self.limit_source = source
        self.budget_bytes = int(limit * HEADROOM)
        self._lock = threading.Lock()
        self._leases = {}       # guarded-by: _lock
        self._next_id = 1       # guarded-by: _lock

    # -- accounting --------------------------------------------------

    def leased_bytes(self, plane: Optional[str] = None) -> int:
        with self._lock:
            return sum(l.nbytes for l in self._leases.values()
                       if plane is None or l.plane == plane)

    def available_bytes(self) -> int:
        """What is left of the post-``HEADROOM`` budget: what a
        co-resident planner may claim without over-committing the card."""
        return max(self.budget_bytes - self.leased_bytes(), 0)

    def train_limit_bytes(self, *leases: Lease) -> int:
        """The remainder as a limit (before ``HEADROOM``), for the
        planners that apply ``HEADROOM`` themselves (the readers of
        ``LGBM_TPU_HBM_BYTES``); floored, so that applying ``HEADROOM``
        again lands at most on the remainder.  Each of ``leases`` that
        the ledger holds is added back: the training plane's envelope is
        its own leases plus what is left."""
        grant = self.available_bytes()
        with self._lock:
            grant += sum(l.nbytes for l in leases
                         if l is not None and l.lease_id in self._leases)
        return max(int(grant / HEADROOM), 1)

    def table(self) -> list:
        """The lease table in lease order, JSON-friendly (flight bundles,
        the doctor's evidence, ``LedgerError`` messages)."""
        with self._lock:
            leases = sorted(self._leases.values())
        return [{"lease_id": l.lease_id, "owner": l.owner,
                 "plane": l.plane, "bytes": l.nbytes,
                 "preemptible": l.preemptible} for l in leases]

    def summary(self) -> dict:
        """JSON-friendly totals (the JAX package's keys)."""
        with self._lock:
            leased = sum(l.nbytes for l in self._leases.values())
            by_plane: dict = {}
            for l in self._leases.values():
                by_plane[l.plane] = by_plane.get(l.plane, 0) + l.nbytes
            count = len(self._leases)
        return {"limit_bytes": self.limit_bytes,
                "limit_source": self.limit_source,
                "budget_bytes": self.budget_bytes,
                "leased_bytes": leased,
                "available_bytes": max(self.budget_bytes - leased, 0),
                "num_leases": count,
                "leased_by_plane": by_plane}

    # -- leases --------------------------------------------------------

    def lease(self, owner: str, nbytes: int, plane: str = "train",
              preemptible: bool = False) -> Lease:
        """Admit a residency claim, or raise ``LedgerError``."""
        need = max(int(nbytes), 0)
        with self._lock:
            leased = sum(l.nbytes for l in self._leases.values())
            granted = None
            if leased + need <= self.budget_bytes:
                granted = Lease(self._next_id, str(owner), str(plane),
                                need, bool(preemptible))
                self._leases[granted.lease_id] = granted
                self._next_id += 1
        if granted is None:
            self._emit("deny", owner=str(owner), plane=str(plane),
                       bytes=need)
            raise LedgerError(
                f"residency ledger: lease '{owner}' ({plane}) wants "
                f"{need} bytes but only {self.available_bytes()} of the "
                f"{self.budget_bytes}-byte budget remain "
                f"(limit {self.limit_bytes}, source "
                f"{self.limit_source}); held leases: {self.table()}")
        self._emit("lease", owner=granted.owner, plane=granted.plane,
                   bytes=granted.nbytes, lease_id=granted.lease_id)
        return granted

    def try_lease(self, owner: str, nbytes: int, plane: str = "train",
                  preemptible: bool = False) -> Optional[Lease]:
        """``lease``, but None where it would raise."""
        try:
            return self.lease(owner, nbytes, plane, preemptible)
        except LedgerError:
            return None

    def release(self, lease) -> None:
        """Give a lease's bytes back (a ``Lease`` or its id; a second
        release does nothing)."""
        lid = getattr(lease, "lease_id", lease)
        with self._lock:
            gone = self._leases.pop(lid, None)
        if gone is not None:
            self._emit("release", owner=gone.owner, plane=gone.plane,
                       bytes=gone.nbytes, lease_id=gone.lease_id)

    def preempt(self, plane: str = "train") -> int:
        """Evict every preemptible lease of ``plane``; returns the bytes
        freed.  A co-resident refresh's training lease is preemptible,
        so serving under pressure preempts training, never the other way
        round."""
        with self._lock:
            victims = [l for l in self._leases.values()
                       if l.plane == plane and l.preemptible]
            for v in victims:
                del self._leases[v.lease_id]
        freed = sum(v.nbytes for v in victims)
        if victims:
            self._emit("preempt", plane=plane, freed_bytes=freed,
                       victims=[v.owner for v in victims])
        return freed

    @contextlib.contextmanager
    def train_env(self, *leases: Lease):
        """Within the block ``LGBM_TPU_HBM_BYTES`` is the training plane's
        envelope (``train_limit_bytes(*leases)``), so that every election
        inside ``engine.train`` (``plan_stream`` at a Dataset's construct
        and at the booster's) plans against the remainder plus its own
        lease instead of the whole card."""
        key = "LGBM_TPU_HBM_BYTES"
        prev = os.environ.get(key)
        os.environ[key] = str(self.train_limit_bytes(*leases))
        try:
            yield self
        finally:
            if prev is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = prev

    # -- telemetry ---------------------------------------------------

    def _emit(self, event: str, **extra) -> None:
        s = self.summary()
        from ..obs.metrics import global_registry
        from ..obs.trace import instant
        instant("planner.ledger", event=event, **extra, **s)
        global_registry.gauge("ledger_budget_bytes").set(s["budget_bytes"])
        global_registry.gauge("ledger_available_bytes").set(
            s["available_bytes"])
        for plane in ("serving", "train"):
            global_registry.gauge(
                "ledger_leased_bytes", labels={"plane": plane}).set(
                    s["leased_by_plane"].get(plane, 0))


# the process's co-residency ledger, where a ``coresident.Scheduler`` (or
# an operator) installed one; the diagnosis reads its lease table for
# the contention verdict's evidence
_active_ledger: Optional[ResidencyLedger] = None
_active_ledger_lock = threading.Lock()


def set_active_ledger(ledger: Optional[ResidencyLedger]):
    """Install ``ledger`` as the process's co-residency ledger; returns
    the one it replaces (restore it when a scheduler closes)."""
    global _active_ledger
    with _active_ledger_lock:
        prev = _active_ledger
        _active_ledger = ledger
    return prev


def active_ledger() -> Optional[ResidencyLedger]:
    return _active_ledger


# ======================================================================
# The two-tier mesh's reduction election (parallel/collectives.py; the
# JAX package's planner.py:939-1107).
#
# ``plan_collectives`` models one histogram sum on a ("dcn", "ici") mesh
# of ``num_slices`` slices of ``devices_per_slice`` ranks: flat (one
# all-reduce over every rank: the whole payload of every rank of a slice
# crosses the slow tier), hierarchical (the fast tier first, so the slow
# tier sums ``num_slices`` pre-reduced payloads) and voting (only the
# elected features' columns cross the slow tier), and elects the
# cheaper of flat and hierarchical.  The port's tiers are the links
# inside a host and the links between hosts.
# ======================================================================

# The link rates the election runs against (GB/s).  These are spec
# values, not measurements:
# - the fast tier: NVLink 4 of the H100 SXM, 900 GB/s a card (NVIDIA
#   H100 Tensor Core GPU data sheet: "NVLink: 900GB/s");
# - the slow tier: one 400 Gb/s NIC a card, 50 GB/s (NVIDIA ConnectX-7,
#   NDR InfiniBand / 400GbE, as DGX H100 pairs one with each card).
# On one host under gloo (the simulated slices of LGBM_TPU_NUM_SLICES)
# both tiers are the host's memory: the election then changes only the
# route and the bytes.  LGBM_TPU_ICI_GBPS / LGBM_TPU_DCN_GBPS override.
DEFAULT_ICI_GBPS = 900.0
DEFAULT_DCN_GBPS = 50.0


def _env_gbps(name: str, default: float) -> float:
    v = (envflags.read(name) or "").strip()
    if v:
        try:
            return max(float(v), 1e-6)
        except ValueError:
            pass
    return default


def _hier_override() -> Optional[bool]:
    """``LGBM_TPU_HIER_REDUCE``: None = the planner elects, True/False
    forced."""
    v = (envflags.read("LGBM_TPU_HIER_REDUCE") or "").strip().lower()
    if v in ("1", "on", "true", "yes", "force"):
        return True
    if v in ("0", "off", "false", "no"):
        return False
    return None


class CollectivePlan(NamedTuple):
    """The reduction verdict for one histogram sum.  Byte fields are a
    sum's: what one [C, F, B] histogram moves over each tier."""

    num_slices: int             # slow-tier participants (1 = one tier)
    devices_per_slice: int      # fast-tier participants a slice
    total_shards: int
    hierarchical: bool          # the fast tier first
    voting_k: int               # >0: only k elected features cross dcn
    payload_bytes: int          # one whole histogram's bytes
    ici_bytes: int              # bytes over the fast tier, a rank
    dcn_bytes: int              # bytes over the slow tier, a slice
    flat_dcn_bytes: int         # what the flat route moves there
    est_flat_us: float          # the link model's time of each route
    est_hier_us: float
    ici_gbps: float
    dcn_gbps: float
    elected: str                # "single" | "flat" | "hierarchical"
    #                             | "hierarchical+voting"

    def summary(self) -> dict:
        """JSON form for checkpoint manifests and the probe tool."""
        return {
            "mesh_shape": [self.num_slices, self.devices_per_slice],
            "num_slices": self.num_slices,
            "total_shards": self.total_shards,
            "hierarchy_elected": self.hierarchical,
            "voting_k": self.voting_k,
            "payload_bytes": self.payload_bytes,
            "ici_bytes": self.ici_bytes,
            "dcn_bytes": self.dcn_bytes,
            "flat_dcn_bytes": self.flat_dcn_bytes,
            "est_flat_us": round(self.est_flat_us, 3),
            "est_hier_us": round(self.est_hier_us, 3),
            "ici_gbps": self.ici_gbps,
            "dcn_gbps": self.dcn_gbps,
            "elected": self.elected,
        }


def plan_collectives(features: int, num_bins: int, quant: bool = False,
                     num_slices: int = 1, devices_per_slice: int = 1,
                     voting_k: int = 0, ici_gbps: Optional[float] = None,
                     dcn_gbps: Optional[float] = None) -> CollectivePlan:
    """Elect flat or hierarchical sums for a (two-tier) data mesh.

    ``features == 0`` plans without shapes (a unit payload: the
    standalone growers elect before the booster knows F).  ``voting_k``
    caps at ``features`` when both are known.  Unlike the JAX package's,
    it takes no row or quantized-bin count: the port's level sums are
    int32 whatever the rows (no int16 wire).  The verdict is the
    ``planner.plan_collectives`` trace instant."""
    from .histogram import hist_payload_bytes
    s = max(int(num_slices), 1)
    d = max(int(devices_per_slice), 1)
    F = max(int(features), 0)
    k = min(int(voting_k), F) if (voting_k and F) else int(voting_k or 0)
    ici_bw = ici_gbps if ici_gbps is not None else _env_gbps(
        "LGBM_TPU_ICI_GBPS", DEFAULT_ICI_GBPS)
    dcn_bw = dcn_gbps if dcn_gbps is not None else _env_gbps(
        "LGBM_TPU_DCN_GBPS", DEFAULT_DCN_GBPS)
    payload = hist_payload_bytes(F or 1, max(int(num_bins), 2), quant=quant)
    # over the slow tier: the pre-reduced payload (hierarchical), the
    # elected columns and the vote (voting; without F no saving is
    # modelled), or every rank's payload (flat)
    vote_ratio = (k / F) if (k and F) else 1.0
    dcn_hier = int(payload * (vote_ratio if k else 1.0))
    if k:
        dcn_hier += 8 * max(k, 1) * s
    flat_dcn = payload * d if s > 1 else 0
    us = 1e6 / 1e9
    est_flat = ((flat_dcn / dcn_bw + payload / ici_bw) * us if s > 1
                else (payload / ici_bw) * us)
    est_hier = (payload / ici_bw + dcn_hier / dcn_bw) * us
    forced = _hier_override()
    if s <= 1:
        hier = False
        elected = "single" if d <= 1 else "flat"
    else:
        hier = forced if forced is not None else est_hier <= est_flat
        elected = ("hierarchical+voting" if (hier and k) else
                   "hierarchical" if hier else "flat")
    plan = CollectivePlan(
        num_slices=s, devices_per_slice=d, total_shards=s * d,
        hierarchical=hier, voting_k=k,
        payload_bytes=int(payload),
        ici_bytes=int(payload) if s * d > 1 else 0,
        dcn_bytes=int(dcn_hier if hier else flat_dcn) if s > 1 else 0,
        flat_dcn_bytes=int(flat_dcn),
        est_flat_us=float(est_flat), est_hier_us=float(est_hier),
        ici_gbps=float(ici_bw), dcn_gbps=float(dcn_bw), elected=elected)
    from ..obs.trace import instant
    instant("planner.plan_collectives", features=F, **plan.summary())
    return plan


# ======================================================================
# The model axis (``multi/``): how many lanes one group program carries.
#
# ``multi.train_many`` trains B boosters as lanes of one group program:
# one captured CUDA graph whose replay runs every lane's round body in
# turn (``grower_rounds.RoundGroup``).  Per-lane state scales with the
# lanes: scores, gradients, the histogram cache, the round transients,
# and the lane's captured-graph buffers.  The binned matrix does not in
# shared-data mode (every lane reads one [G, n] tensor) and does in
# stacked mode (cv folds: each lane's own ``Dataset.subset``).
# ``plan_model_batch`` elects the largest lane chunk Bc <= B whose
# predicted peak fits the budget; the driver then trains ceil(B / Bc)
# groups in turn.  ``LGBM_TPU_MODEL_BATCH``: "" = the planner's
# election, "0"/"off" = one lane a group (solo), N = cap Bc at N.
# ======================================================================


def _model_batch_override() -> Optional[int]:
    """``LGBM_TPU_MODEL_BATCH``: None = the planner elects, 1 = batching
    off, N = the elected lane chunk capped at N."""
    v = (envflags.read("LGBM_TPU_MODEL_BATCH") or "").strip().lower()
    if not v:
        return None
    if v in ("0", "off", "false", "none", "no"):
        return 1
    try:
        return max(int(v), 1)
    except ValueError:
        return None


class ModelBatchPlan(NamedTuple):
    """The lane-chunk verdict for one group of boosters (the JAX
    package's fields)."""

    b_total: int                # boosters in the group
    b_chunk: int                # lanes a group program carries
    num_dispatch_groups: int    # ceil(b_total / b_chunk)
    stacked: bool               # the binned matrix scales with Bc
    per_lane_bytes: int         # what one more lane costs
    shared_bytes: int           # lane-independent (the shared matrix)
    predicted_peak_bytes: int   # at the elected b_chunk
    budget_bytes: int
    limit_bytes: int
    limit_source: str           # "mem_get_info" | "env" | "none" |
                                # "caller" | "ledger"
    feasible: bool              # even Bc = 1 fits the budget
    degraded: bool              # the budget forced Bc < b_total
    forced: bool                # LGBM_TPU_MODEL_BATCH capped the election

    def summary(self) -> dict:
        """JSON-friendly form (the JAX package's keys)."""
        return {
            "b_total": self.b_total,
            "b_chunk": self.b_chunk,
            "num_dispatch_groups": self.num_dispatch_groups,
            "stacked": self.stacked,
            "per_lane_bytes": self.per_lane_bytes,
            "shared_bytes": self.shared_bytes,
            "predicted_peak_bytes": self.predicted_peak_bytes,
            "budget_bytes": self.budget_bytes,
            "hbm_limit_bytes": self.limit_bytes,
            "limit_source": self.limit_source,
            "feasible": self.feasible,
            "degraded": self.degraded,
            "forced": self.forced,
        }


def round_graph_bytes(rows: int, features: int, num_bins: int,
                      num_leaves: int = 31, quant: bool = False,
                      round_width: int = 128) -> int:
    """The private memory pool one captured round body keeps: the round
    step's transients (the larger of ``round_commit`` and
    ``round_accumulate``, ``_transient_bytes``), which a CUDA graph
    holds for its lifetime instead of giving back to the allocator."""
    t = _transient_bytes(max(int(rows), 1), max(int(rows), 1), features,
                         num_bins, num_leaves, quant, round_width, False)
    return int(max(t["round_commit"], t["round_accumulate"]))


def plan_model_batch(
    b_total: int,
    rows: int,
    features: int,
    num_bins: int,
    num_leaves: int = 31,
    num_class: int = 1,
    quant: bool = False,
    round_width: int = 128,
    stacked: bool = False,
    budget_bytes: Optional[int] = None,
    ledger: Optional["ResidencyLedger"] = None,
    device=None,
) -> ModelBatchPlan:
    """Elect the lane chunk of a group of ``b_total`` boosters.

    Memory model (the JAX package's form): ``total(Bc) = shared + Bc *
    per_lane``.  ``shared`` is the binned [G, n] matrix in shared mode
    and 0 in stacked mode.  ``per_lane`` is ``predict_peak_bytes``'s
    solo peak without the matrix (with it, stacked: each fold has its
    own), plus one ``round_graph_bytes`` for the lane's captured-graph
    buffers: a lane's round body is captured twice, once in the group's
    graph and once in its own graph (the rounds after some lanes'
    trees have stopped).  The solo peak already holds one round
    transient (the solo graph's pool); the second is the lane's share
    of the group graph's pool.  That share is an upper bound: the group
    capture may reuse blocks one lane's body freed for the next lane's,
    so the measured pool is nearer one share than ``Bc``.

    The budget: ``budget_bytes`` (a caller's limit, ``HEADROOM``
    applied), else ``ledger.available_bytes()`` as it is, else the
    card's free memory on ``device`` (``device_limit_bytes``;
    ``NO_DEVICE_LIMIT`` on the CPU), ``HEADROOM`` applied.  Bc walks
    down from B until the prediction fits; ``feasible=False`` means one
    lane does not fit either (the group then trains solo, as a plan of
    Bc = 1 says).  The JAX signature's TPU knobs (``method``,
    ``machines``, ``tile_rows``, ``use_pack``, ``accel``) have no
    counterpart.  Emits the ``planner.model_batch`` instant."""
    B = max(int(b_total), 1)
    if budget_bytes is not None:
        limit, source = int(budget_bytes), "caller"
        budget = int(limit * HEADROOM)
    elif ledger is not None:
        limit, source = int(ledger.limit_bytes), "ledger"
        budget = int(ledger.available_bytes())   # HEADROOM already applied
    else:
        limit, source = device_limit_bytes("cuda" if device is None
                                           else device)
        if limit is None:
            limit = NO_DEVICE_LIMIT
        budget = int(limit * HEADROOM)
    solo_peak, bd = predict_peak_bytes(rows, features, num_bins, num_leaves,
                                       num_class, quant, round_width)
    binned = bd["binned"]
    shared = 0 if stacked else binned
    per_lane = (solo_peak - binned + (binned if stacked else 0)
                + round_graph_bytes(rows, features, num_bins, num_leaves,
                                    quant, round_width))
    forced_cap = _model_batch_override()
    cap = B if forced_cap is None else min(B, forced_cap)

    def total(bc):
        return shared + bc * per_lane

    bc = cap
    while bc > 1 and total(bc) > budget:
        bc -= 1
    plan = ModelBatchPlan(
        b_total=B, b_chunk=bc, num_dispatch_groups=-(-B // bc),
        stacked=bool(stacked), per_lane_bytes=int(per_lane),
        shared_bytes=int(shared), predicted_peak_bytes=int(total(bc)),
        budget_bytes=budget, limit_bytes=int(limit), limit_source=source,
        feasible=total(1) <= budget,
        degraded=bc < B and (forced_cap is None or bc < cap),
        forced=forced_cap is not None)
    from ..obs.trace import instant
    instant("planner.model_batch", rows=rows, features=features,
            **plan.summary())
    return plan
