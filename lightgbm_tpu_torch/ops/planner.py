"""Kernel sizing (counterpart of the parts of ``lightgbm_tpu/ops/planner.py``
that the predict path and the fused training path read).

The JAX planner elects a predict chunk and a row tile from a VMEM model
of the TPU core, and pads each chunk to a ladder rung (``bucket_rows``)
to bound its compiled shapes.  Neither applies on the H100: the kernel
is compiled once and launches on the unpadded rows.  The port fixes
both sizes here:

- ``PREDICT_CHUNK_ROWS``: rows per ``DeviceForest.predict_raw`` /
  ``predict_leaf`` call to the traversal kernel.  65,536 rows keep the
  leaves-mode output of a 500-tree forest at 128 MiB on the device.
- ``TILE_ROWS``: rows per thread block of the traversal kernel (one
  thread per row), staged in shared memory as a ``[rows, F]`` f32 tile.
  128 rows of 28 features are 14 KiB; wider feature counts shrink the
  tile (``tile_rows_for``) so the tile stays inside the 48 KiB a block
  gets without opting in, then opt into the larger dynamic limit.  The
  binning kernel (``csrc/ingest.cu``) stages its row tiles the same way.

The fused histogram kernels (``csrc/fused.cu``) take fixed tiles; the
JAX planner's ``plan_fused`` VMEM model does not apply:

- ``FUSED_SLOTS_PER_BLOCK``: slots whose [slots, 3, B] int64 arena one
  accumulate block holds in shared memory: 16 x 3 x 256 x 8 bytes = 96
  KiB at 256 bins, two blocks per SM.  Fewer for wider bin axes.  The
  int8 mode's [slots, 2, B] int32 arena takes
  ``FUSED_SLOTS_PER_BLOCK_INT8`` = 32 slots in 64 KiB at 256 bins.
- ``FUSED_ACC_THREADS``: threads per accumulate block (rows in flight).
- ``FUSED_TARGET_BLOCKS``: accumulate blocks to aim for (about four per
  SM of the 132); the row axis is cut into as many chunks as that needs
  over features x slot blocks, with at least ``FUSED_MIN_CHUNK_ROWS``
  rows a chunk, since every chunk flushes its whole arena.
- ``FUSED_SCAN_MAX_BINS``: the scan kernel runs one thread per bin.

The whole-dataset histogram kernel (``csrc/histogram.cu``, B6) takes
fixed tiles too; the JAX kernel's (feat_tile, block_rows) VMEM grid
does not apply:

- ``HIST_FEAT_TILE``: features whose [features, 3, B] int64 arena one
  block holds in shared memory: 8 x 3 x 256 x 8 bytes = 48 KiB at 256
  bins, inside the default limit.  Wider bin axes shrink the tile
  (``hist_feat_tile``).
- ``HIST_THREADS``: threads per block (rows in flight).
- The row axis is cut as the accumulate kernel's is
  (``hist_row_chunks``): about four blocks per SM over the feature
  tiles, at least ``FUSED_MIN_CHUNK_ROWS`` rows a chunk.
"""

from __future__ import annotations

PREDICT_CHUNK_ROWS = 1 << 16
TILE_ROWS = 128
MIN_TILE_ROWS = 32
# shared memory a block may use without / with the dynamic opt-in (H100)
SMEM_DEFAULT_BYTES = 48 * 1024
SMEM_MAX_BYTES = 227 * 1024


def tile_rows_for(num_features: int) -> int:
    """Rows per traversal block for ``num_features`` f32 columns: the
    fixed ``TILE_ROWS`` when its X tile fits the default shared memory,
    else ``MIN_TILE_ROWS``.  Raises when even that tile exceeds the
    card's per-block maximum."""
    row_bytes = 4 * max(int(num_features), 1)
    if TILE_ROWS * row_bytes <= SMEM_DEFAULT_BYTES:
        return TILE_ROWS
    if MIN_TILE_ROWS * row_bytes <= SMEM_MAX_BYTES:
        return MIN_TILE_ROWS
    raise ValueError(
        f"{num_features} features do not fit the traversal kernel's "
        f"shared-memory row tile ({SMEM_MAX_BYTES} bytes per block)")


FUSED_SLOTS_PER_BLOCK = 16
FUSED_SLOTS_PER_BLOCK_INT8 = 32
FUSED_ACC_THREADS = 512
FUSED_TARGET_BLOCKS = 4 * 132
FUSED_MIN_CHUNK_ROWS = 4096
FUSED_SCAN_MAX_BINS = 1024


def fused_slots_per_block(num_bins: int, quant: bool = False) -> int:
    """Slots per accumulate block for a ``num_bins`` bin axis: a [slots,
    3, B] int64 arena, or in the int8 mode a [slots, 2, B] int32 one."""
    per_slot = (2 * 4 if quant else 3 * 8) * max(int(num_bins), 1)
    cap = FUSED_SLOTS_PER_BLOCK_INT8 if quant else FUSED_SLOTS_PER_BLOCK
    sb = min(cap, SMEM_MAX_BYTES // per_slot)
    if sb < 1:
        raise ValueError(f"{num_bins} bins do not fit the accumulate "
                         f"kernel's shared-memory arena")
    return sb


def fused_row_chunks(rows: int, num_features: int, slot_blocks: int) -> int:
    """Row chunks of one accumulate launch (grid axis x)."""
    per_chunk = max(int(num_features) * int(slot_blocks), 1)
    want = -(-FUSED_TARGET_BLOCKS // per_chunk)
    most = max(int(rows) // FUSED_MIN_CHUNK_ROWS, 1)
    return max(1, min(want, most))


HIST_FEAT_TILE = 8
HIST_THREADS = 512


def hist_feat_tile(num_bins: int) -> int:
    """Features per histogram block for a ``num_bins`` bin axis: the
    fixed ``HIST_FEAT_TILE`` shrunk until the arena fits the default
    shared memory (one feature at least, up to the per-block maximum)."""
    per_feature = 3 * 8 * max(int(num_bins), 1)
    if per_feature > SMEM_MAX_BYTES:
        raise ValueError(f"{num_bins} bins do not fit the histogram "
                         f"kernel's shared-memory arena")
    return max(1, min(HIST_FEAT_TILE, SMEM_DEFAULT_BYTES // per_feature))


def hist_row_chunks(rows: int, num_features: int, feat_tile: int) -> int:
    """Row chunks of one histogram launch (grid axis x)."""
    return fused_row_chunks(rows, -(-int(num_features) // int(feat_tile)), 1)
