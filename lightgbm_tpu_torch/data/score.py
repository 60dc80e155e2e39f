"""Bulk offline scoring on the card (counterpart of
``lightgbm_tpu/data/score.py``): the block pump pointed at inference.

- **input**: a finalized ``BlockStore`` of raw ``[F, rows]`` float32
  feature blocks (sha256-verified on read);
- **routing**: each block, transposed and padded to ``block_rows`` rows,
  goes through the traversal kernel B1 in leaves mode
  (``ops.predict_kernels.fused_traverse``, one launch a block) of a
  ``predict.DeviceForest``, and the serving epilogue turns the leaves
  into raw scores: the device f32 pinned-order sum where the forest's
  one-time probe proved it bit-exact (``DeviceForest.
  _epilogue_verified``), else the host f64 gather
  (``predict.gather_leaf_sum``): ``DeviceForest.predict_raw_padded``'s
  decision, so a banked block equals it bit for bit, and equals
  ``Booster.predict(raw_score=True)`` on the path that decision takes
  (the device scores where the probe passed, else ``device=False``,
  the JAX package's default path);
- **output**: per-block ``[K, rows]`` float64 raw scores banked by a
  ``ScoreSink`` whose manifest is rewritten atomically after every
  block, so a run stopped at any point resumes by skipping exactly the
  banked blocks, and the rest come out byte-identical (the scores of a
  row do not depend on the block it is scored in);
- **placement**: ``plan_block_shards`` assigns blocks to the caller's
  device specs (each with ``slice_id`` and ``device_id``; a count is
  planned by ``fleet.topology.plan_devices``), the first spec's slice
  first; each participant scores its own blocks into the shared sink;
- **stored program**: with ``aot_store`` the routing program of the
  block bucket comes from ``fleet.aot.make_bulk_program``: a run
  restores its launch plan and epilogue verdict (``program_source``
  "aot"), or runs live and stores them so that the next run, a resumed
  one too, restores them.

The sink's format and commit protocol are the JAX package's, so sinks
pass both ways, and so are its events: the ``bulk.plan`` instant, a
``bulk.run`` span with a ``bulk.block`` span a block inside it, and the
``bulk_blocks_total`` counter of the process registry.  With
``ledger=`` (an ``ops.planner.ResidencyLedger``) a run leases its
predicted card peak on the serving plane for its blocks and releases
it after; where the ledger has less left, the run logs the JAX
package's warning and scores every block all the same.
"""

from __future__ import annotations

import hashlib
import json
import os
import time
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..obs.metrics import global_registry as _obs_registry
from ..obs.trace import instant as _instant, span as _span
from ..utils.file_io import write_atomic
from ..utils.log import log_info, log_warning
from .blockstore import BlockStore
from .stream import BlockPump, ReadAhead, host_rss_peak_bytes

SCORE_FORMAT = "lgbm_tpu.scorestore.v1"
SCORE_MANIFEST = "score_manifest.json"


class ScoreSinkError(RuntimeError):
    """A score block's bytes do not match its manifest checksum, or an
    existing sink's geometry contradicts the requested run."""


def _sha256(buf) -> str:
    return hashlib.sha256(buf).hexdigest()


class DeviceSpec(NamedTuple):
    """A scoring participant: its slice (a host, or an NVLink domain)
    and its device id."""

    slice_id: int
    device_id: int


class ScoreSink:
    """A directory of ``scores_NNNNN.bin`` float64 ``[K, rows]`` blocks
    under an atomically rewritten manifest.  ``write_block`` lands the
    block file atomically and THEN rewrites the whole manifest
    atomically: after a kill at any instant the manifest names exactly
    the blocks whose bytes are on disk, and ``open_or_create`` on the
    same path resumes by skipping them."""

    def __init__(self, path: str, meta: dict):
        self.path = str(path)
        self.num_rows = int(meta["num_rows"])
        self.num_class = int(meta["num_class"])
        self.block_rows = int(meta["block_rows"])
        self.num_blocks = int(meta["num_blocks"])
        self.model_digest = str(meta["model_digest"])
        self._blocks: Dict[int, dict] = {
            int(k): v for k, v in meta.get("blocks", {}).items()}

    @classmethod
    def open_or_create(cls, path: str, num_rows: int, num_class: int,
                       block_rows: int, num_blocks: int,
                       model_digest: str) -> "ScoreSink":
        """Open an existing sink, which must belong to this run's
        geometry and model (resuming another run's scores would
        interleave two models), or create an empty one."""
        mp = os.path.join(path, SCORE_MANIFEST)
        if os.path.exists(mp):
            try:
                with open(mp) as fh:
                    meta = json.load(fh)
            except (OSError, ValueError) as e:
                raise ScoreSinkError(
                    f"unreadable score manifest at {mp}: {e}") from e
            if meta.get("format") != SCORE_FORMAT:
                raise ScoreSinkError(
                    f"{mp}: unknown score-sink format "
                    f"{meta.get('format')!r}")
            want = {"num_rows": int(num_rows), "num_class": int(num_class),
                    "block_rows": int(block_rows),
                    "num_blocks": int(num_blocks),
                    "model_digest": str(model_digest)}
            got = {k: (str(meta.get(k)) if k == "model_digest"
                       else int(meta.get(k, -1))) for k in want}
            if got != want:
                raise ScoreSinkError(
                    f"{mp}: existing sink disagrees with this run "
                    f"(sink {got}, run {want}) — choose a fresh output "
                    "directory or delete the stale one")
            return cls(path, meta)
        os.makedirs(path, exist_ok=True)
        sink = cls(path, {
            "num_rows": int(num_rows), "num_class": int(num_class),
            "block_rows": int(block_rows), "num_blocks": int(num_blocks),
            "model_digest": str(model_digest), "blocks": {}})
        sink._write_manifest()
        return sink

    def _write_manifest(self) -> None:
        write_atomic(os.path.join(self.path, SCORE_MANIFEST), json.dumps({
            "format": SCORE_FORMAT, "num_rows": self.num_rows,
            "num_class": self.num_class, "block_rows": self.block_rows,
            "num_blocks": self.num_blocks,
            "model_digest": self.model_digest,
            "blocks": {str(k): self._blocks[k]
                       for k in sorted(self._blocks)},
        }, indent=1))

    def banked(self) -> set:
        """Block indices whose scores are committed on disk."""
        return set(self._blocks)

    @property
    def complete(self) -> bool:
        return len(self._blocks) == self.num_blocks

    def nbytes(self) -> int:
        return sum(int(b["size"]) for b in self._blocks.values())

    def write_block(self, i: int, scores: np.ndarray) -> None:
        """Bank block ``i``'s ``[K, rows]`` float64 scores: the block
        file first, the manifest rewrite second (the commit point)."""
        scores = np.ascontiguousarray(scores, np.float64)
        if scores.ndim != 2 or scores.shape[0] != self.num_class:
            raise ValueError(
                f"expected [{self.num_class}, rows] scores for block {i}, "
                f"got {scores.shape}")
        raw = scores.tobytes()
        name = f"scores_{int(i):05d}.bin"
        write_atomic(os.path.join(self.path, name), raw)
        self._blocks[int(i)] = {
            "file": name, "rows": int(scores.shape[1]),
            "sha256": _sha256(raw), "size": len(raw)}
        self._write_manifest()

    def read_block(self, i: int) -> np.ndarray:
        """Block ``i`` as ``[K, rows]`` float64, checksum-verified."""
        b = self._blocks.get(int(i))
        if b is None:
            raise ScoreSinkError(f"score block {i} is not banked")
        fp = os.path.join(self.path, b["file"])
        with open(fp, "rb") as fh:
            raw = fh.read()
        if len(raw) != int(b["size"]) or _sha256(raw) != b["sha256"]:
            raise ScoreSinkError(
                f"{fp}: checksum mismatch — the score bank is corrupt; "
                "delete the block (or the sink) and re-run to re-score")
        return np.frombuffer(raw, np.float64).reshape(
            self.num_class, int(b["rows"])).copy()


def plan_block_shards(num_blocks: int, devices: Sequence) -> Tuple[int, ...]:
    """Each block's ``device_id``, round-robin over ``devices`` (each
    with ``slice_id`` and ``device_id``) in home-slice-first order: the
    first device's slice fills first, the other slices take what is left
    over, in (slice, device) order."""
    devices = tuple(devices)
    if not devices:
        raise ValueError("plan_block_shards needs at least one device")
    home = devices[0].slice_id
    order = sorted(devices, key=lambda d: (d.slice_id != home,
                                           d.slice_id, d.device_id))
    return tuple(order[i % len(order)].device_id
                 for i in range(max(int(num_blocks), 0)))


class BulkScorer:
    """Score a float32 feature ``BlockStore`` with a ``DeviceForest`` and
    bank the raw scores in a ``ScoreSink`` at ``sink_path``, resumable
    (module docstring).  ``devices``: the participants' specs, or their
    count (``fleet.topology.plan_devices``; None: this device alone);
    this scorer takes the blocks ``plan_block_shards`` gives
    ``local_device_id``.  ``aot_store``: a ``fleet.aot.AOTStore`` for
    the routing program.  ``ledger``: a co-residency ledger that the
    run leases its card peak from (module docstring).  ``digest``: the
    model's digest in the sink and the store (None:
    ``serving.registry.forest_digest`` of the forest)."""

    def __init__(self, device_forest, store: BlockStore, sink_path: str,
                 num_class: int = 1, devices=None, local_device_id: int = 0,
                 aot_store=None, ledger=None, digest: Optional[str] = None):
        if store.dtype != np.dtype(np.float32):
            raise ValueError(
                f"bulk scoring expects a float32 feature store, got "
                f"{store.dtype}")
        if devices is None:
            devices = (DeviceSpec(0, int(local_device_id)),)
        elif isinstance(devices, int):
            from ..fleet.topology import plan_devices
            devices = plan_devices(devices)
        self.dev = device_forest
        self.store = store
        self.sink_path = str(sink_path)
        self.K = max(int(num_class), 1)
        self.devices = tuple(devices)
        self.local_device_id = int(local_device_id)
        self.aot_store = aot_store
        self.ledger = ledger
        if digest is None:
            from ..serving.registry import forest_digest
            digest = forest_digest(device_forest.forest)
        self.digest = str(digest)

    def _prep(self, xb: torch.Tensor) -> torch.Tensor:
        """A [F, rows] feature block as the padded row-major
        [block_rows, F] f32 batch the kernel routes."""
        F, rows = xb.shape
        X = torch.zeros((self.store.block_rows, F), dtype=torch.float32,
                        device=xb.device)
        X[:rows] = xb.T
        return X

    def _score_block(self, leaves: torch.Tensor, rows: int) -> np.ndarray:
        """The serving epilogue on one block's [T, block_rows] leaves:
        ``DeviceForest.predict_raw_padded``'s decision."""
        if self.dev._epilogue_verified(self.K):
            raw = self.dev._leaf_sum(leaves, self.K)
            return raw.cpu().numpy().astype(np.float64)[:, :rows]
        from ..predict import gather_leaf_sum
        return gather_leaf_sum(self.dev.forest,
                               leaves[:, :rows].cpu().numpy(), self.K)

    def _predicted_peaks(self) -> Tuple[int, int]:
        """(device, host) peak bytes: the forest's tensors on the card,
        one padded [block_rows, F] f32 batch and its [T, block_rows]
        int32 leaves and [K, block_rows] scores, four block windows
        (the block in use, the reader's two queued and the one it
        holds); on the host the pump's two pinned buffers and a score
        block."""
        F = int(self.store.num_cols)
        br = int(self.store.block_rows)
        T = int(self.dev.forest.num_trees)
        forest = sum(t.numel() * t.element_size()
                     for t in vars(self.dev).values()
                     if isinstance(t, torch.Tensor))
        dp = forest + br * F * 4 + T * br * 4 + self.K * br * 4 \
            + 4 * F * br * 4
        hp = 2 * F * br * 4 + self.K * br * 8
        return int(dp), int(hp)

    def run(self, max_blocks: Optional[int] = None) -> dict:
        """Score every block of this participant not yet banked; returns
        a stats dict.  ``max_blocks`` caps the blocks banked by this call
        (the resume seam: a capped run ends with the sink partly
        committed, the state a kill between two manifest rewrites
        leaves)."""
        nb = int(self.store.num_blocks)
        sink = ScoreSink.open_or_create(
            self.sink_path, int(self.store.num_rows), self.K,
            int(self.store.block_rows), nb, self.digest)
        shards = plan_block_shards(nb, self.devices)
        mine = [i for i in range(nb) if shards[i] == self.local_device_id]
        banked = sink.banked()
        todo = [i for i in mine if i not in banked]
        skipped = len(mine) - len(todo)
        if max_blocks is not None:
            todo = todo[:max(int(max_blocks), 0)]
        pred_dev, pred_host = self._predicted_peaks()
        from ..fleet.aot import make_bulk_program
        program, source = make_bulk_program(
            self.dev, int(self.store.num_cols), int(self.store.block_rows),
            self.digest, self.aot_store, num_class=self.K)
        # the blocks' bytes on the card, leased from the co-residency
        # ledger for the run; a denial warns and the run scores anyway
        lease = None
        if self.ledger is not None:
            lease = self.ledger.try_lease(
                f"bulk:{self.digest}", pred_dev, plane="serving")
            if lease is None:
                log_warning(
                    "bulk scorer: residency ledger denied a "
                    f"{pred_dev}-byte serving lease; scoring anyway — "
                    "expect HBM pressure against the co-resident planes")
        _instant("bulk.plan", blocks=nb, mine=len(mine), skipped=skipped,
                 todo=len(todo), program=source,
                 predicted_device_peak_bytes=pred_dev,
                 predicted_host_peak_bytes=pred_host)
        rows_scored = blocks_scored = 0
        t0 = time.perf_counter()
        try:
            # the reader thread reads ahead while the epilogue and the
            # sink run on the host (measured faster, PERF.md section 6)
            with _span("bulk.run", blocks=len(todo)):
                for i, _start, rows, xb in ReadAhead(
                        BlockPump(self.store, self.dev.device, blocks=todo)):
                    with _span("bulk.block", block=i, rows=rows):
                        leaves = program(self._prep(xb))
                        sink.write_block(i, self._score_block(leaves, rows))
                    _obs_registry.counter("bulk_blocks_total").inc()
                    rows_scored += int(rows)
                    blocks_scored += 1
        finally:
            if lease is not None:
                self.ledger.release(lease)
        elapsed = max(time.perf_counter() - t0, 1e-9)
        dev = self.dev.device
        measured_dev = (int(torch.cuda.max_memory_allocated(dev))
                        if dev.type == "cuda" else 0)
        rps = rows_scored / elapsed
        stats = {
            "rows_scored": rows_scored,
            "blocks_scored": blocks_scored,
            "skipped_blocks": skipped,
            "total_blocks": nb,
            "complete": sink.complete,
            "seconds": elapsed,
            "rows_per_sec": rps,
            "bulk_rows_per_sec_per_device": rps / max(len(self.devices), 1),
            "num_devices": len(self.devices),
            "program_source": source,
            "epilogue": ("device" if self.dev._epilogue_verified(self.K)
                         else "host"),
            "predicted_device_peak_bytes": pred_dev,
            "predicted_host_peak_bytes": pred_host,
            "measured_device_peak_bytes": measured_dev,
            "measured_host_peak_bytes": host_rss_peak_bytes(),
        }
        log_info(
            f"bulk scorer: {blocks_scored} blocks / {rows_scored} rows in "
            f"{elapsed:.2f}s ({rps / 1e6:.3f} Mrow/s, {skipped} banked "
            f"blocks skipped, program={source})")
        return stats
