"""Out-of-core streamed training on the card (counterpart of
``lightgbm_tpu/data/stream.py``): the block and ingest pumps, the
streaming election and the streamed rounds grower.

When ``ops.planner.plan_stream`` rules full residency out (or a Dataset
is already block-backed), the binned [G, n] matrix lives in a
checksummed spill store (``data/blockstore.py``) and crosses to the card
a row block at a time:

- the per-row state (values, scores, gradients, masks, leaf routing)
  stays on the card, O(n) and not O(n * G);
- ``BlockPump`` reads each block (``readinto`` a pinned host buffer),
  copies it to the card on a side CUDA stream with ``non_blocking=True``
  and hands it over with the event recorded after that copy, which the
  consumer's stream waits on; a pinned buffer is refilled only after the
  event of the copy that last read it.  A block is read when the pass
  asks for it, in the consumer's thread; ``ReadAhead`` runs a pump in a
  daemon reader thread a few blocks ahead, which bulk scoring takes
  (its host epilogue and sink writes leave the GIL to the reader) and
  the streamed grower and the pushed construct do not (their Python
  dispatch holds it, and the thread made them slower; PERF.md
  section 6);
- ``StreamGrower`` is the rounds grower (``grower_rounds.RoundGrower``)
  with the two steps that read the matrix run a block at a time: the
  root histogram (B6 a block at the tree's fixed-point scales, summed in
  int64; quantized, B4 int8 with one slot, summed in int32) and each
  round's pass over the rows (the routing of the block's rows and B4 on
  the block, the blocks' arenas summed exactly, then one B5 scan of the
  sum).  Every step of size [L] or [KCAP] is ``RoundGrower._round``'s own.

Histogram sums are exact integers at one scale per channel and tree,
taken once over all n rows, so a streamed tree is the resident tree for
ANY block partition, f32 included; the JAX package promises that only
for quantized payloads or for f32 in one pinned block order.

The body runs eagerly (the pump is driven from the host) and reads the
stop test once a round, as the JAX package does; no CUDA graph.  A
pump's ``passes``, ``blocks`` and ``h2d_bytes`` and a grower's
``host_reads`` count one object's work; the process registry
(``obs.metrics.global_registry``) gets the JAX package's series too:
``stream_passes_total``, ``stream_blocks_total`` and
``ingest_blocks_total``, ``stream_blocks_inflight`` and
``ingest_blocks_inflight`` (``ReadAhead``'s queue), the election's
``stream_block_rows``, ``stream_num_blocks`` and ``host_rss_peak_bytes``
gauges, a ``stream.pump``/``ingest.pump`` heartbeat a block, and the
``stream.block_put``, ``stream.spill``, ``stream.root_pass``,
``stream.round_pass`` and ``stream.tree`` spans with the
``planner.plan_stream`` instant; none of them reads the card.  An
``IngestPump`` over several devices places its chunks as the JAX
package does: ``fleet.topology.plan_devices`` describes the devices and
``data.score.plan_block_shards`` deals the chunks out, home slice
first.
"""

from __future__ import annotations

import contextlib
import os
import queue
import tempfile
import threading
import weakref
from typing import Optional

import numpy as np
import torch

from ..grower_rounds import RoundGrower
from ..obs.metrics import global_registry as _obs_registry
from ..obs.trace import instant as _instant, span as _span
from ..obs.watchdog import beat as _beat
from ..ops import fused
from ..ops import histogram as _hist
from ..utils import envflags
from ..utils.log import LightGBMError, log_info, log_warning
from .blockstore import BlockStore


def host_rss_bytes() -> int:
    """Current resident-set size of this process (VmRSS), 0 if unknown."""
    return _proc_status_kb("VmRSS:") * 1024


def host_rss_peak_bytes() -> int:
    """Peak resident-set size of this process (VmHWM), else the current
    one: the measured twin of the planner's predicted host peak."""
    peak = _proc_status_kb("VmHWM:")
    return (peak or _proc_status_kb("VmRSS:")) * 1024


def _proc_status_kb(key: str) -> int:
    try:
        with open("/proc/self/status") as fh:
            for line in fh:
                if line.startswith(key):
                    return int(line.split()[1])
    except (OSError, ValueError, IndexError):
        pass
    return 0


def default_spill_dir() -> str:
    """A fresh temporary directory for a spill store: under
    ``LGBM_TPU_STREAM_DIR`` where it is set (created if missing), else
    under the system's temporary directory."""
    base = envflags.read("LGBM_TPU_STREAM_DIR")
    if base:
        os.makedirs(base, exist_ok=True)
        return tempfile.mkdtemp(prefix="blocks_", dir=base)
    return tempfile.mkdtemp(prefix="lgbm_tpu_stream_")


# the torch view of each host dtype a pump moves (uint16 bins travel as
# int16 and are widened on the card)
_TORCH_DTYPE = {np.dtype(np.uint8): torch.uint8,
                np.dtype(np.uint16): torch.int16,
                np.dtype(np.float32): torch.float32}


class _Pump:
    """What the two pumps share: the pinned host buffers and the copy of
    each item to the card.  A subclass gives ``_items`` (the item
    indices of a pass, in order), ``_host_item(i, buf)`` -> (start, rows,
    host array) and ``_buffer_bytes``, and may shape the delivered
    tensor (``_shape``).  ``KIND`` names the pump's registry series,
    heartbeat and span (``<kind>_blocks_total``, ``<kind>.pump``,
    ``<kind>.block_put``)."""

    # pinned host buffers, used in turn: the next item is read while the
    # copy of the one before may still run
    NUM_BUFFERS = 2
    KIND = "stream"

    def __init__(self, device):
        from ..basic import resolve_device
        self.device = resolve_device(device)
        self.passes = 0
        self.blocks = 0
        self.h2d_bytes = 0
        self._cuda = self.device.type == "cuda"
        self._bufs = None      # pinned host buffers, used in rotation
        self._last = None      # each buffer's last copy event
        self._side = None      # the copies' CUDA stream, a device

    def _setup_cuda(self) -> None:
        if self._bufs is not None:
            return
        nbytes = max(self._buffer_bytes(), 1)
        self._bufs = [torch.empty(nbytes, dtype=torch.uint8,
                                  pin_memory=True)
                      for _ in range(self.NUM_BUFFERS)]
        self._last = [None] * self.NUM_BUFFERS
        self._side = {}

    def _device_of(self, i: int) -> torch.device:
        """The device item ``i`` is placed on."""
        return self.device

    def _load(self, i: int, k: int):
        """Item ``i``, the ``k``-th of its pass, on its device: (index,
        start, rows, tensor)."""
        device = self._device_of(i)
        if not self._cuda:
            start, rows, host = self._host_item(i, None)
            t = torch.from_numpy(host).to(device)
            self.h2d_bytes += t.numel() * t.element_size()
            return i, start, rows, t
        j = k % len(self._bufs)
        if self._last[j] is not None:
            # the copy that last read this buffer must be done
            self._last[j].synchronize()
        start, rows, host = self._host_item(i, self._bufs[j].numpy())
        nbytes = host.nbytes
        side = self._side.get(device)
        if side is None:
            side = self._side[device] = torch.cuda.Stream(device)
        with torch.cuda.stream(side):
            dev = torch.empty(nbytes, dtype=torch.uint8, device=device)
            dev.copy_(self._bufs[j][:nbytes], non_blocking=True)
            ev = torch.cuda.Event()
            ev.record(side)
        self._last[j] = ev
        stream = torch.cuda.current_stream(device)
        stream.wait_event(ev)
        # the block was allocated on the side stream
        dev.record_stream(stream)
        self.h2d_bytes += nbytes
        t = dev.view(_TORCH_DTYPE[host.dtype]).view(host.shape)
        return i, start, rows, t

    def _shape(self, t: torch.Tensor) -> torch.Tensor:
        return t

    def __iter__(self):
        if self._cuda:
            self._setup_cuda()
        self.passes += 1
        kind = self.KIND
        if kind == "stream":
            _obs_registry.counter("stream_passes_total").inc()
        blocks = _obs_registry.counter(f"{kind}_blocks_total")
        for k, i in enumerate(self._items()):
            with _span(f"{kind}.block_put", block=i):
                i, start, rows, t = self._load(i, k)
            self.blocks += 1
            blocks.inc()
            # the pump's heartbeat: a wedged store read goes stale here
            _beat(f"{kind}.pump", count=i + 1)
            yield i, start, rows, self._shape(t)


class ReadAhead:
    """A pump iterated in a daemon reader thread up to ``depth`` items
    ahead of its consumer, through a bounded queue; the pump's counters
    read through.  Every queue wait takes ``POLL_S`` and looks at the
    other side again; a consumer that stops early stops the reader,
    whose end is awaited at most ``JOIN_TIMEOUT_S``.  An error in the
    reader is raised on the consumer's side."""

    POLL_S = 0.1
    JOIN_TIMEOUT_S = 30.0

    def __init__(self, pump: _Pump, depth: int = 2):
        self.pump = pump
        self.depth = max(int(depth), 1)
        self.thread: Optional[threading.Thread] = None

    def __getattr__(self, name):
        return getattr(self.pump, name)

    def __iter__(self):
        q: "queue.Queue" = queue.Queue(maxsize=self.depth)
        stop = threading.Event()
        done = object()

        def put(item) -> None:
            while not stop.is_set():
                try:
                    q.put(item, timeout=self.POLL_S)
                    return
                except queue.Full:
                    continue

        def reader():
            try:
                # the consumer's device ("cuda" without an index: the
                # current one)
                with (torch.cuda.device(self.pump.device)
                      if self.pump.device.type == "cuda"
                      else contextlib.nullcontext()):
                    for item in self.pump:
                        if stop.is_set():
                            return
                        put(item)
                put(done)
            except BaseException as e:   # raised on the consumer's side
                put(e)

        t = self.thread = threading.Thread(target=reader, daemon=True,
                                           name="lgbm-read-ahead")
        t.start()
        inflight = _obs_registry.gauge(f"{self.pump.KIND}_blocks_inflight")
        try:
            while True:
                try:
                    item = q.get(timeout=self.POLL_S)
                except queue.Empty:
                    if not t.is_alive() and q.empty():
                        raise RuntimeError("the read-ahead thread ended "
                                           "before its pump's last item")
                    continue
                if item is done:
                    return
                if isinstance(item, BaseException):
                    raise item
                inflight.set(q.qsize() + 1)
                yield item
        finally:
            stop.set()
            inflight.set(0)
            t.join(self.JOIN_TIMEOUT_S)


class BlockPump(_Pump):
    """Double-buffered store -> card iterator over a ``BlockStore``.

    Yields ``(index, start_row, rows, block)`` for ``blocks`` (block
    indices, ascending; None: every block), ``block`` the [G, rows]
    binned matrix of those rows on ``device`` (uint8, or int32 for a
    uint16 store: the port's layout past 256 bins).  ``device=None`` is
    the CUDA card.  A block is read when it is asked for, into one of
    two pinned buffers, while the card may still run on the block before
    it.  A pass (an iteration) adds 1 to ``passes``, each block 1 to
    ``blocks`` and its bytes to ``h2d_bytes``."""

    def __init__(self, store: BlockStore, device=None, blocks=None):
        self.store = store
        self.block_ids = (range(store.num_blocks) if blocks is None
                          else [int(i) for i in blocks])
        super().__init__(device)

    def _items(self):
        return self.block_ids

    def _buffer_bytes(self) -> int:
        return (self.store.num_cols * self.store.block_rows
                * self.store.dtype.itemsize)

    def _host_item(self, i: int, buf):
        st = self.store
        start, rows = st.block_bounds(i)
        if buf is None:
            block = st.read_block(i, out=np.empty((st.num_cols, rows),
                                                  st.dtype))
            return start, rows, (block.astype(np.int32)
                                 if st.dtype == np.uint16 else block)
        buf = buf[:st.num_cols * rows * st.dtype.itemsize].view(st.dtype)
        return start, rows, st.read_block(i, out=buf)

    def _shape(self, t: torch.Tensor) -> torch.Tensor:
        if t.dtype == torch.int16:
            return t.to(torch.int32) & 0xFFFF
        return t


class IngestPump(_Pump):
    """Double-buffered host -> card iterator over raw rows: the source
    [n, F] (anything row-sliceable, a scipy CSR matrix too) in chunks of
    ``chunk_rows`` rows, each as a contiguous [rows, F] float32 tensor on
    ``device`` (the binning kernel B3's input).  Yields ``(index,
    start_row, rows, chunk)`` in ascending order.  With several
    ``devices`` (all of one type; on one card they may all be
    ``cuda:0``), chunk i goes to ``devices[owner[i]]``: the devices are
    described through ``fleet.topology.plan_devices`` (device i is spec
    i) and the chunks dealt out by ``data.score.plan_block_shards``, so
    each device bins its own row shard of the construction."""

    KIND = "ingest"

    def __init__(self, source, chunk_rows: int, device=None, devices=None):
        self.source = source
        self.n = int(source.shape[0])
        self.num_features = int(source.shape[1])
        self.chunk_rows = max(int(chunk_rows), 1)
        self.num_chunks = max(-(-self.n // self.chunk_rows), 1)
        self.devices = None
        self.owner = [0] * self.num_chunks
        if devices is not None and len(list(devices)) > 1:
            from ..basic import resolve_device
            from ..fleet.topology import plan_devices
            from .score import plan_block_shards
            self.devices = [resolve_device(d) for d in devices]
            if len({d.type for d in self.devices}) != 1:
                raise ValueError("an IngestPump's devices must all be of "
                                 "one type")
            self.owner = list(plan_block_shards(
                self.num_chunks, plan_devices(len(self.devices))))
            device = self.devices[0]
        elif devices is not None and len(list(devices)) == 1:
            device = list(devices)[0]
        super().__init__(device)

    def _device_of(self, i: int) -> torch.device:
        if self.devices is None:
            return self.device
        return self.devices[self.owner[i]]

    def _items(self):
        return range(self.num_chunks)

    def _buffer_bytes(self) -> int:
        return min(self.chunk_rows, self.n) * self.num_features * 4

    def _host_item(self, i: int, buf):
        start = i * self.chunk_rows
        rows = min(self.chunk_rows, self.n - start)
        chunk = self.source[start:start + rows]
        # a scipy sparse source is densified a chunk at a time
        chunk = np.asarray(chunk.toarray() if hasattr(chunk, "toarray")
                           else chunk, np.float32)
        if buf is None:
            return start, rows, np.ascontiguousarray(chunk)
        out = buf[:rows * self.num_features * 4].view(np.float32) \
            .reshape(rows, self.num_features)
        out[...] = chunk
        return start, rows, out


# ----------------------------------------------------------------------
# the election
# ----------------------------------------------------------------------

class StreamContext:
    """What a streamed booster keeps: its store, the plan and the
    grower."""

    def __init__(self, store: BlockStore, plan):
        self.store = store
        self.plan = plan
        self.grower: Optional["StreamGrower"] = None


def _config_stream_blockers(b) -> list:
    """The configurations the streamed grower does not cover (resident
    training keeps them); the JAX package's list, in its words."""
    cc = b.config
    meta = b.meta.resolved()
    blockers = []
    if not getattr(type(b), "_stream_ok", True):
        blockers.append(f"boosting={b.boosting_type}")
    if b.group is not None:
        blockers.append(f"tree_learner={b.tree_learner_type} sharding")
    if meta.has_bundles:
        blockers.append("EFB bundles")
    if bool(meta.is_categorical.any()):
        blockers.append("categorical features")
    if cc.monotone_constraints:
        blockers.append("monotone_constraints")
    if cc.extra_trees:
        blockers.append("extra_trees")
    if cc.feature_fraction_bynode < 1.0:
        blockers.append("feature_fraction_bynode")
    if (cc.cegb_penalty_split > 0.0 or cc.cegb_penalty_feature_coupled
            or cc.cegb_penalty_feature_lazy):
        blockers.append("CEGB")
    if cc.forcedsplits_filename:
        blockers.append("forced splits")
    return blockers


def spill_binned(binned_t: torch.Tensor, path: str, block_rows: int,
                 dtype) -> BlockStore:
    """A finalized store of a [G, n] binned matrix on any device, copied
    to the host one block at a time."""
    G, n = binned_t.shape
    store = BlockStore.create(path, n, G, dtype, block_rows)
    for s in range(0, n, store.block_rows):
        e = min(s + store.block_rows, n)
        store.append_rows(binned_t[:, s:e].cpu().numpy().T)
    return store.finalize()


def maybe_stream_setup(b) -> bool:
    """Decide streamed or resident training for booster ``b`` (a
    ``boosting.GBDT``) and, streaming, stand up its spill store; True
    when it trains out of core.  A Dataset constructed on the card is
    spilled from its ``binned_t``, which is then freed where the Dataset
    frees its raw data (``free_raw_data``), so later boosters of it
    stream too."""
    from ..ops.planner import (plan_stream, predict_host_peak_bytes,
                               predict_stream_device_peak_bytes)
    ds = b.train_set
    store = getattr(ds, "_block_store", None)
    n, G = ds.binned_shape()
    quant = bool(b.config.use_quantized_grad)
    plan = plan_stream(
        rows=n, features=G, num_bins=b.num_bins,
        num_leaves=b.config.num_leaves, num_class=b.num_tree_per_iteration,
        quant=quant, round_width=b.config.tpu_round_width, device=b.device)
    # the election's verdict, kept for the booster's planner.plan event
    b.stream_election = plan
    _instant("planner.plan_stream", rows=n, features=G, **plan.summary())
    if not plan.stream and (store is None or ds.binned_t is not None):
        # residency fits and the matrix is on the card: a spill store
        # left by an earlier booster does not force streaming
        return False
    blockers = _config_stream_blockers(b)
    if blockers:
        if store is not None and ds.binned_t is None:
            raise LightGBMError(
                "the training Dataset is block-backed (out-of-core spill "
                "store), which requires a streaming-compatible config; "
                "unsupported here: " + ", ".join(blockers))
        log_warning(
            "out-of-core streaming elected by the two-level budget "
            f"planner ({plan.reason}) but not supported with "
            + ", ".join(blockers)
            + "; training resident — expect memory pressure "
            "(stream_override(force=False) or LGBM_TPU_STREAM=0 "
            "silences this)")
        return False
    if not plan.feasible and store is None:
        log_warning(
            "stream planner: predicted peaks "
            f"(device {plan.predicted_device_peak_bytes / 1e9:.2f} GB, "
            f"host {plan.predicted_host_peak_bytes / 1e9:.2f} GB) exceed "
            "a budget even at block_rows="
            f"{plan.block_rows}; training may run out of memory")
    if store is None:
        path = default_spill_dir()
        with _span("stream.spill", rows=n, block_rows=plan.block_rows):
            store = spill_binned(ds.binned_t, path, plan.block_rows,
                                 ds.binned_dtype())
        ds._block_store = store
        ds._block_store_owned = True
        weakref.finalize(ds, BlockStore.cleanup, store)
        if ds.free_raw_data:
            ds.binned_t = None
        log_info(
            f"out-of-core streaming: spilled {n} rows x {G} columns to "
            f"{path} ({store.num_blocks} blocks of {store.block_rows} "
            f"rows, {store.nbytes() / 1e9:.2f} GB; {plan.reason})")
    if not plan.stream:
        # a block-backed Dataset streams even where residency would fit:
        # the plan in the store's streamed terms
        dp = predict_stream_device_peak_bytes(
            n, G, b.num_bins, store.block_rows, b.config.num_leaves,
            b.num_tree_per_iteration, quant, b.config.tpu_round_width)
        hp = predict_host_peak_bytes(n, G, store.dtype.itemsize,
                                     store.block_rows)[0]
        plan = plan._replace(
            stream=True, block_rows=int(store.block_rows),
            num_blocks=int(store.num_blocks),
            predicted_device_peak_bytes=dp, predicted_host_peak_bytes=hp,
            feasible=(dp <= plan.device_budget_bytes
                      and hp <= plan.host_budget_bytes),
            reason="block-backed dataset (the spill store is the only "
                   "copy of the binned matrix)")
    b._stream = StreamContext(store, plan)
    b.stream_plan = b.stream_election = plan
    _obs_registry.gauge("stream_block_rows").set(int(store.block_rows))
    _obs_registry.gauge("stream_num_blocks").set(int(store.num_blocks))
    _obs_registry.gauge("host_rss_peak_bytes").set(host_rss_peak_bytes())
    return True


# ----------------------------------------------------------------------
# the streamed rounds grower
# ----------------------------------------------------------------------

class StreamGrower(RoundGrower):
    """The rounds grower over a spill store (module docstring): the root
    histogram and each round's row pass fold over the store's blocks,
    read through one ``BlockPump``; the rest is ``RoundGrower``'s.
    The body runs eagerly with one host read of the stop test a round
    (``host_reads``).  Quantized folds add int32 arenas over the blocks,
    so the rows in all, not a block's, are held to
    ``ops.histogram.INT32_SAFE_ROWS``.  A tree is a ``stream.tree``
    span, with ``stream.root_pass`` and a ``stream.round_pass`` a round
    inside it (the body is eager, so each pass records)."""

    grow_span = "stream.tree"
    # the pump's passes are driven from the host: a tree grows alone
    lane_steps = False

    def __init__(self, store: BlockStore, meta, cfg, meta_t=None,
                 device=None):
        G, n = store.num_cols, store.num_rows
        dev = torch.device("cuda" if device is None else device)
        if cfg.quant and n > _hist.INT32_SAFE_ROWS:
            raise ValueError(
                f"{n} rows: int32 sums of quantized levels hold at most "
                f"{_hist.INT32_SAFE_ROWS} rows, however they are blocked")
        dt = torch.uint8 if store.dtype == np.uint8 else torch.int32
        # the [G, n] shape and device the rounds grower sizes its buffers
        # by; no row of the matrix is on the card
        shape_only = torch.empty((G, 1), dtype=dt, device=dev).expand(G, n)
        super().__init__(shape_only, meta, cfg, meta_t)
        self.binned_t = None
        self.store = store
        self.graphs = False
        self.split_pair = False
        self.pump = BlockPump(store, dev)
        self.host_reads = 0
        self._round_index = 0
        self._crank = torch.zeros(n, dtype=torch.int64, device=dev)
        self._gl = torch.zeros(n, dtype=torch.bool, device=dev)

    def grow(self, *args, **kwargs):
        out = super().grow(*args, **kwargs)
        _obs_registry.gauge("host_rss_peak_bytes").set(host_rss_peak_bytes())
        return out

    def _block_vals(self, start: int, rows: int) -> torch.Tensor:
        """The block's columns of the value block, contiguous (B4 and B6
        take contiguous values)."""
        return self.vals[:, start:start + rows].contiguous()

    def _root_fixed(self, slot0: torch.Tensor) -> torch.Tensor:
        acc = None
        with _span("stream.root_pass"):
            for _i, s, r, blk in self.pump:
                part = _hist.histogram_fixed(blk, self._block_vals(s, r),
                                             self.Bg, self.host_scales)
                acc = part if acc is None else acc + part
        return acc

    def _root_levels(self, slot0: torch.Tensor) -> torch.Tensor:
        acc = None
        with _span("stream.root_pass"):
            for _i, s, r, blk in self.pump:
                part = fused.accumulate(blk, self._block_vals(s, r),
                                        slot0[s:s + r].contiguous(), 1,
                                        self.Bg)[0]
                acc = part if acc is None else acc + part
        return acc

    def _row_pass(self, section, route, K: int, Bx: int, scales):
        seg = None
        with _span("stream.round_pass", round=self._round_index):
            for _i, s, r, blk in self.pump:
                rows = slice(s, s + r)
                with section("routing"):
                    crank, gl, slot = route(blk, self.leaf_id[rows],
                                            self.member[rows])
                    self._crank[rows] = crank
                    self._gl[rows] = gl
                with section("kernels"):
                    part = fused.accumulate(blk, self._block_vals(s, r),
                                            slot, K, Bx, scales)
                    seg = part if seg is None else seg + part
        return self._crank, self._gl, None, seg

    def _run_rounds(self, section, use_graph: bool) -> int:
        r = 0
        while r < self.Lm1:
            self.host_reads += 1
            if bool(self.done):
                break
            self._round_index = r
            self._round(section)
            r += 1
        return r
