"""Predict-path sizing (counterpart of the parts of
``lightgbm_tpu/ops/planner.py`` that the predict path reads).

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
  gets without opting in, then opt into the larger dynamic limit.
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
