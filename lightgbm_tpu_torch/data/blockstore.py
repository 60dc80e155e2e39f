"""Checksummed spill store of binned row blocks (counterpart of
``lightgbm_tpu/data/blockstore.py``, in the same format).

The binned matrix of a Dataset that does not stay on the card lives
here: feature-major ``[G, rows]`` row blocks, each file written
atomically (``utils.file_io.write_atomic``: a temp sibling, then
``os.replace``) under a ``manifest.json`` that holds a sha256 a block,
so a torn write or bit-rot raises ``BlockStoreCorruptError`` instead of
growing wrong trees.  Reads are memory-mapped (``numpy.memmap``) for
random access, or ``readinto`` a caller's buffer for the block pump's
sequential scans (``data.stream.BlockPump``, which reads into pinned
host buffers).

``FORMAT``, the manifest's keys and the block files are the JAX
package's, so a store written by either package opens in the other
with the same bytes.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
from typing import List, Optional

import numpy as np

from ..utils.file_io import write_atomic

FORMAT = "lgbm_tpu.blockstore.v1"
MANIFEST = "manifest.json"


class BlockStoreCorruptError(RuntimeError):
    """A block's bytes do not match the manifest checksum (or the
    manifest itself is unreadable or inconsistent)."""


def _sha256(buf) -> str:
    return hashlib.sha256(buf).hexdigest()


class BlockStore:
    """A directory of ``block_NNNNN.bin`` files and an atomic manifest.

    Lifecycle: ``create`` -> ``append_rows`` -> ``finalize`` (writes the
    manifest; the store is unreadable before), or ``open`` a finalized
    store.  ``from_array`` spills a host matrix in one call.
    """

    def __init__(self, path: str, meta: dict, writable: bool = False):
        self.path = str(path)
        self.num_rows = int(meta["num_rows"])
        self.num_cols = int(meta["num_cols"])
        self.block_rows = int(meta["block_rows"])
        self.dtype = np.dtype(meta["dtype"])
        self._blocks: List[dict] = list(meta.get("blocks", []))
        self._writable = writable
        self._buf: Optional[np.ndarray] = None   # [block_rows, G] writer buf
        self._buf_fill = 0
        self._rows_written = sum(int(b["rows"]) for b in self._blocks)
        self._verified: set = set()

    # -- construction ------------------------------------------------------

    @classmethod
    def create(cls, path: str, num_rows: int, num_cols: int, dtype,
               block_rows: int) -> "BlockStore":
        if num_rows <= 0 or num_cols <= 0 or block_rows <= 0:
            raise ValueError("num_rows, num_cols and block_rows must be > 0")
        os.makedirs(path, exist_ok=True)
        return cls(path, {
            "num_rows": num_rows, "num_cols": num_cols,
            "block_rows": min(int(block_rows), int(num_rows)),
            "dtype": str(np.dtype(dtype)), "blocks": [],
        }, writable=True)

    @classmethod
    def from_array(cls, path: str, arr: np.ndarray,
                   block_rows: int) -> "BlockStore":
        """Spill a row-major [n, G] matrix."""
        st = cls.create(path, arr.shape[0], arr.shape[1], arr.dtype,
                        block_rows)
        st.append_rows(arr)
        return st.finalize()

    def append_rows(self, rows: np.ndarray) -> "BlockStore":
        """Buffer row-major ``[r, G]`` rows; full blocks flush to disk as
        feature-major ``[G, block_rows]`` files.  Any chunk sizes
        compose; ``finalize`` flushes the ragged last block."""
        if not self._writable:
            raise RuntimeError("BlockStore is read-only (already finalized)")
        rows = np.asarray(rows)
        if rows.ndim != 2 or rows.shape[1] != self.num_cols:
            raise ValueError(
                f"expected [r, {self.num_cols}] rows, got {rows.shape}")
        if self._rows_written + self._buf_fill + rows.shape[0] > self.num_rows:
            raise ValueError(
                f"append past the end: "
                f"{self._rows_written + self._buf_fill}+{rows.shape[0]} > "
                f"{self.num_rows}")
        rows = rows.astype(self.dtype, copy=False)
        pos = 0
        while pos < rows.shape[0]:
            if self._buf is None:
                self._buf = np.empty((self.block_rows, self.num_cols),
                                     self.dtype)
                self._buf_fill = 0
            take = min(self.block_rows - self._buf_fill, rows.shape[0] - pos)
            self._buf[self._buf_fill:self._buf_fill + take] = \
                rows[pos:pos + take]
            self._buf_fill += take
            pos += take
            if self._buf_fill == self.block_rows:
                self._flush_block()
        return self

    def _flush_block(self) -> None:
        raw = np.ascontiguousarray(self._buf[:self._buf_fill].T).tobytes()
        name = f"block_{len(self._blocks):05d}.bin"
        write_atomic(os.path.join(self.path, name), raw)
        self._blocks.append({"file": name, "rows": int(self._buf_fill),
                             "sha256": _sha256(raw), "size": len(raw)})
        self._rows_written += self._buf_fill
        self._buf_fill = 0

    def finalize(self) -> "BlockStore":
        """Flush the ragged last block and write the manifest atomically:
        the commit point, so an interrupted spill leaves no manifest and
        ``open`` refuses the directory."""
        if not self._writable:
            return self
        if self._buf_fill:
            self._flush_block()
        if self._rows_written != self.num_rows:
            raise ValueError(
                f"finalize with {self._rows_written}/{self.num_rows} rows "
                "appended")
        write_atomic(os.path.join(self.path, MANIFEST), json.dumps({
            "format": FORMAT, "num_rows": self.num_rows,
            "num_cols": self.num_cols, "block_rows": self.block_rows,
            "dtype": str(self.dtype), "blocks": self._blocks,
        }, indent=1))
        self._writable = False
        self._buf = None
        return self

    # -- reading -----------------------------------------------------------

    @classmethod
    def open(cls, path: str) -> "BlockStore":
        mp = os.path.join(path, MANIFEST)
        try:
            with open(mp) as fh:
                meta = json.load(fh)
        except (OSError, ValueError) as e:
            raise BlockStoreCorruptError(
                f"unreadable blockstore manifest at {mp}: {e}") from e
        if meta.get("format") != FORMAT:
            raise BlockStoreCorruptError(
                f"{mp}: unknown blockstore format {meta.get('format')!r}")
        st = cls(path, meta, writable=False)
        if st._rows_written != st.num_rows:
            raise BlockStoreCorruptError(
                f"{mp}: manifest covers {st._rows_written} of "
                f"{st.num_rows} rows")
        return st

    @property
    def num_blocks(self) -> int:
        return len(self._blocks)

    def block_bounds(self, i: int):
        """(start_row, rows) of block ``i``."""
        return i * self.block_rows, int(self._blocks[i]["rows"])

    def block_nbytes(self, i: int) -> int:
        return int(self._blocks[i]["size"])

    def nbytes(self) -> int:
        return sum(int(b["size"]) for b in self._blocks)

    def read_block(self, i: int, out: Optional[np.ndarray] = None,
                   verify: Optional[bool] = None) -> np.ndarray:
        """Block ``i`` as feature-major ``[G, rows]``.

        ``out=None`` returns a read-only ``np.memmap`` view; a buffer of
        at least the block's bytes (any shape, the store's dtype) is
        read into instead, and the view of its prefix returned.  The
        checksum is verified on the first read of each block per open
        (``verify`` overrides); a mismatch or a short read raises
        ``BlockStoreCorruptError``."""
        if self._writable:
            raise RuntimeError("BlockStore not finalized yet")
        b = self._blocks[i]
        fp = os.path.join(self.path, b["file"])
        rows = int(b["rows"])
        shape = (self.num_cols, rows)
        check = (i not in self._verified) if verify is None else verify
        if out is not None:
            view = out.reshape(-1)[:self.num_cols * rows]
            with open(fp, "rb") as fh:
                got = fh.readinto(memoryview(view.view(np.uint8)))
            if got != int(b["size"]):
                raise BlockStoreCorruptError(
                    f"{fp}: short read ({got} of {b['size']} bytes)")
            data = view.reshape(shape)
        else:
            try:
                data = np.memmap(fp, dtype=self.dtype, mode="r", shape=shape)
            except (OSError, ValueError) as e:
                raise BlockStoreCorruptError(f"{fp}: {e}") from e
        if check:
            digest = _sha256(memoryview(np.ascontiguousarray(data)
                                        .view(np.uint8).reshape(-1)))
            if digest != b["sha256"]:
                raise BlockStoreCorruptError(
                    f"{fp}: checksum mismatch (manifest {b['sha256'][:12]}…,"
                    f" file {digest[:12]}…) — the spill store is corrupt; "
                    "rebuild the dataset")
            self._verified.add(i)
        return data

    def cleanup(self) -> None:
        """Delete the store directory (best-effort)."""
        shutil.rmtree(self.path, ignore_errors=True)
