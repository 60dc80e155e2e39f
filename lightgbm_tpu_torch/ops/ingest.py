"""Row binning on the card (counterpart of ``lightgbm_tpu/ops/ingest.py``).

``DeviceBinner`` bins a [n, F] f32 matrix against a dataset's bin
mappers and EFB layout into the trainer's feature-major [G, n] matrix.
For a CUDA tensor it launches ``csrc/ingest.cu`` (built by ``_build``)
or raises; for a CPU tensor it runs ``bin_plain``, the same function in
plain torch.  ``launch_counts["ingest"]`` counts the kernel's launches.
The kernel reads its own form of the tables (``kernel_tables``): ragged
runs of 32-bit words, each feature's own bounds or categorical codes as
a search tree in BFS order, staged in shared memory in group chunks
that ``ops/planner.py::ingest_plan`` sizes.  A wide table's chunks stage
only their own columns of X, and a group whose tables exceed a chunk is
binned in member parts over successive launches on the stream (the
first part writes every row, each later one its non-zero bins), so B3
bins any width the host bins; only a single feature whose tables exceed
the card's shared memory is refused (``ingest_plan``).

Byte parity with the host oracle (``Dataset._bin_block``: f64
``searchsorted`` against f64 upper bounds) rests on the directed-rounded
bound table: for an f32 value ``v``, ``ub < v`` holds exactly when
``round_toward_neg_inf_f32(ub) < v`` (no f32 lies strictly between a
bound and its round-down), so the f32 compare loses nothing.  That holds
only for f32 input: the ``Dataset`` bins f64 input on the host.  The
EFB fold is the host's, verbatim: members of a group in ascending
used-feature order, ``col = bin != 0 ? start + bin - 1 : col``.
"""

from __future__ import annotations

import ctypes
import threading
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from . import planner

# |v| >= 2^31 cannot equal any int32 categorical code (nor can the host's
# int64 cast of such a value match one)
_CAT_HUGE = float(np.float32(2147483648.0))

_counts_lock = threading.Lock()
launch_counts = {"ingest": 0}
_thread = threading.local()


def thread_launch_counts() -> dict:
    """The calling thread's B3 launches (one rank's, when ranks bin in
    threads of one process)."""
    d = getattr(_thread, "counts", None)
    if d is None:
        d = _thread.counts = {k: 0 for k in launch_counts}
    return d


def reset_launch_counts() -> None:
    with _counts_lock:
        for k in launch_counts:
            launch_counts[k] = 0
    for k in thread_launch_counts():
        thread_launch_counts()[k] = 0


class IngestUnsupported(ValueError):
    """This dataset's binning recipe cannot run through the kernel."""


class FeatureSpec(NamedTuple):
    """Per-used-feature binning recipe."""

    column: int          # raw matrix column
    group: int           # EFB output column
    start: int           # feat_start offset inside the merged column
    is_cat: bool
    num_bin: int
    row: int             # row in the bounds (numerical) / cats table
    nan_as_last: bool    # numerical MissingType.NAN: NaN -> num_bin - 1


class IngestTables(NamedTuple):
    """The directed-rounded f32 bound table, the int32 category table and
    the per-feature specs, host-side."""

    specs: Tuple[FeatureSpec, ...]
    bounds: np.ndarray       # f32 [max(Fnum, 1), Bmax], +inf padded
    cats: np.ndarray         # i32 [max(Fcat, 1), Cmax], -2 padded
    num_features: int        # raw matrix width
    num_groups: int
    out_dtype: np.dtype      # uint8 | uint16 (the group dtype)


def round_bounds_f32(ub: np.ndarray) -> np.ndarray:
    """f64 upper bounds -> the largest f32 <= each bound (round toward
    -inf), the table the pure-f32 compare is exact against."""
    ub = np.asarray(ub, np.float64)
    with np.errstate(over="ignore"):
        ub32 = ub.astype(np.float32)
        over = ub32.astype(np.float64) > ub
        ub32[over] = np.nextafter(ub32[over], np.float32(-np.inf))
    return ub32


def build_ingest_tables(ds) -> IngestTables:
    """Compile a Dataset's bin mappers and EFB layout into tables.
    Raises ``IngestUnsupported`` for categorical codes outside int32."""
    from ..binning import BinType, MissingType

    specs, brows, crows = [], [], []
    for j, f in enumerate(ds.used_features):
        m = ds.bin_mappers[f]
        g = int(ds.feat_group[j])
        start = int(ds.feat_start[j])
        if m.bin_type == BinType.CATEGORICAL:
            cats = np.asarray(m.bin_2_categorical, dtype=np.int64)
            if cats.size and (cats.max() >= 2 ** 31
                              or cats.min() < -2 ** 31):
                raise IngestUnsupported(
                    f"feature {f}: categorical codes exceed int32")
            specs.append(FeatureSpec(int(f), g, start, True,
                                     int(m.num_bin), len(crows), False))
            crows.append(cats.astype(np.int32))
        else:
            r = m.num_bin - 1
            if m.missing_type == MissingType.NAN:
                r -= 1
            specs.append(FeatureSpec(
                int(f), g, start, False, int(m.num_bin), len(brows),
                m.missing_type == MissingType.NAN))
            brows.append(round_bounds_f32(
                np.asarray(m.bin_upper_bound)[:max(r, 0)]))
    bmax = max([len(b) for b in brows] + [1])
    cmax = max([len(c) for c in crows] + [1])
    bounds = np.full((max(len(brows), 1), bmax), np.inf, np.float32)
    for i, b in enumerate(brows):
        bounds[i, :len(b)] = b
    cats_t = np.full((max(len(crows), 1), cmax), -2, np.int32)
    for i, c in enumerate(crows):
        cats_t[i, :len(c)] = c
    dtype = np.dtype(np.uint8 if ds.max_group_bin <= 256 else np.uint16)
    return IngestTables(tuple(specs), bounds, cats_t,
                        int(ds.num_total_features), int(ds.num_groups),
                        dtype)


def device_dtype(tables: IngestTables) -> torch.dtype:
    """The card's storage type of the binned matrix: uint8, or int32
    where a group has more than 256 bins (torch's uint16 support is too
    thin for gathers)."""
    return torch.uint8 if tables.out_dtype == np.uint8 else torch.int32


def salt_rows(width: int, like: Optional[np.ndarray] = None) -> np.ndarray:
    """Edge-case rows every parity check must cover: zeros, all-NaN,
    sign extremes, non-integer positives, negative and huge codes."""
    salt = np.zeros((6, width), np.float32)
    salt[1, :] = np.nan
    salt[2, :] = -np.float32(1e30)
    salt[3, :] = np.float32(1e30)
    salt[4, :] = np.float32(2.5)
    salt[5, :] = np.float32(-1.0)
    if like is not None and len(like):
        extra = np.array(like[:1], np.float32)
        extra[0, ::2] = np.nan
        salt = np.concatenate([salt, extra])
    return salt


# ----------------------------------------------------------------------
# the plain version
# ----------------------------------------------------------------------

def bin_plain(X: torch.Tensor, tables: IngestTables,
              bounds: torch.Tensor, cats: torch.Tensor) -> torch.Tensor:
    """The kernel's function in plain torch: [n, F] f32 -> [G, n]."""
    n = X.shape[0]
    out = torch.zeros((tables.num_groups, n), dtype=torch.int32,
                      device=X.device)
    for s in tables.specs:
        v = X[:, s.column]
        nan = torch.isnan(v)
        if s.is_cat:
            miss = nan | (v.abs() >= _CAT_HUGE)
            iv = torch.where(miss, torch.full_like(v, -1.0), v).trunc()
            iv = iv.to(torch.int32)
            hit = (iv[:, None] == cats[s.row][None, :]) & (iv[:, None] >= 0)
            first = hit.to(torch.int8).argmax(dim=1).to(torch.int32)
            bins = torch.where(hit.any(dim=1), first,
                               torch.full_like(first, s.num_bin - 1))
        else:
            fz = torch.where(nan, torch.zeros_like(v), v)
            # count of bounds < fz (the row is sorted and +inf padded)
            bins = torch.searchsorted(bounds[s.row].contiguous(), fz,
                                      side="left").to(torch.int32)
            if s.nan_as_last:
                bins = torch.where(nan, torch.full_like(bins, s.num_bin - 1),
                                   bins)
        out[s.group] = torch.where(bins != 0, s.start + bins - 1,
                                   out[s.group])
    return out.to(device_dtype(tables))


# ----------------------------------------------------------------------
# the kernel
# ----------------------------------------------------------------------

_lib_lock = threading.Lock()
_lib_handle = None


def _lib():
    global _lib_handle
    with _lib_lock:
        if _lib_handle is None:
            from . import _build
            lib = _build.load("ingest")
            p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
            lib.ingest_bin.argtypes = [
                p, ll, i,          # X, n, F
                p, p, p, p, i,     # group_ptr, members, words, chunks, nchunks
                p, i,              # columns, mode
                i, i, i, i,        # G, out_bytes, tile_rows, grid_x
                i, i, p, p]        # threads, smem_bytes, out, stream
            lib.ingest_bin.restype = ctypes.c_int
            _lib_handle = lib
        return _lib_handle


class KernelTables(NamedTuple):
    """The kernel's ragged tables, host-side: per group (CSR), its member
    records in ascending used-feature order, each pointing at its own
    run of ``words``.  A run is a perfect search tree of depth h in BFS
    (Eytzinger) order, 2^h - 1 entries whose in-order walk is sorted
    (``eytzinger``): a numerical feature's real bounds (f32 bits, padded
    with +inf only to 2^h - 1), or a categorical feature's non-negative
    codes (padded with INT32_MAX) followed by each node's index in the
    code row (a code below 0 can never match).  Runs follow the member
    order, so a group's runs are contiguous: ``group_words`` holds their
    boundaries."""

    group_ptr: np.ndarray    # int32 [G + 1]
    members: np.ndarray      # int32 [max(M, 1), 6]: column, start, flags,
    #                          num_bin, word offset, tree depth h
    words: np.ndarray        # int32 [max(W, 1)]
    group_words: np.ndarray  # int32 [G + 1]


FLAG_CAT, FLAG_NAN_LAST = 1, 2
_INT32_MAX = np.iinfo(np.int32).max


def ragged_bounds(tables: IngestTables, row: int) -> np.ndarray:
    """A numerical feature's bound row without its +inf padding."""
    b = tables.bounds[row]
    keep = np.flatnonzero(~np.isposinf(b))
    return b[:keep[-1] + 1 if keep.size else 0]


def eytzinger(sorted_vals: np.ndarray, pad) -> Tuple[np.ndarray, np.ndarray,
                                                     int]:
    """``sorted_vals`` as a perfect search tree of depth h =
    bit_length(len) in BFS order, padded with ``pad`` to 2^h - 1
    entries: (tree, each node's rank in the padded sorted run, h).
    Node i (1-based) sits at [i - 1], its children at 2i and 2i + 1."""
    L = len(sorted_vals)
    h = int(L).bit_length()
    size = (1 << h) - 1
    padded = np.concatenate([sorted_vals, np.full(size - L, pad,
                                                  sorted_vals.dtype)])
    rank = np.empty(size, np.int64)
    nxt = 0
    stack, i = [], 1
    while stack or i <= size:             # in-order walk of the BFS tree
        while i <= size:
            stack.append(i)
            i *= 2
        i = stack.pop()
        rank[i - 1] = nxt
        nxt += 1
        i = 2 * i + 1
    return padded[rank], rank, h


def kernel_tables(tables: IngestTables) -> KernelTables:
    """``tables`` as the kernel stages them (see ``KernelTables``)."""
    G = tables.num_groups
    by_group = [[] for _ in range(G)]
    for s in tables.specs:
        by_group[s.group].append(s)
    ptr = np.zeros(G + 1, np.int32)
    gw = np.zeros(G + 1, np.int32)
    rows, runs = [], []
    off = 0
    for g, members in enumerate(by_group):
        ptr[g + 1] = ptr[g] + len(members)
        for s in members:
            if s.is_cat:
                codes = tables.cats[s.row]
                idx = np.nonzero(codes >= 0)[0]
                idx = idx[np.argsort(codes[idx], kind="stable")]
                tree, rank, h = eytzinger(codes[idx].astype(np.int32),
                                          _INT32_MAX)
                where = np.concatenate([idx, np.full(len(tree) - len(idx),
                                                     -1)])
                run = np.concatenate([tree, where[rank]]).astype(np.int32)
            else:
                tree, _, h = eytzinger(ragged_bounds(tables, s.row),
                                       np.float32(np.inf))
                run = tree.view(np.int32)
            flags = (FLAG_CAT if s.is_cat else 0) | (
                FLAG_NAN_LAST if s.nan_as_last else 0)
            rows.append([s.column, s.start, flags, s.num_bin, off, h])
            runs.append(run)
            off += len(run)
        gw[g + 1] = off
    if G and not np.all(np.diff(ptr) > 0):
        raise ValueError("every group needs a member: the kernel stores a "
                         "group's bins from its members' warps")
    members = np.asarray(rows, np.int32).reshape(-1, 6)
    if members.size == 0:
        members = np.zeros((1, 6), np.int32)
    words = (np.concatenate(runs).astype(np.int32) if off
             else np.zeros(1, np.int32))
    return KernelTables(ptr, members, words, gw)


def _bin_cuda(X: torch.Tensor, binner: "DeviceBinner") -> torch.Tensor:
    n, F = X.shape
    G = binner.tables.num_groups
    out = torch.empty((G, n), dtype=device_dtype(binner.tables),
                      device=X.device)
    if n == 0:
        return out
    state = binner.kernel_state()
    plan = state.plan
    lib = _lib()
    first = 0
    with torch.cuda.device(X.device):
        stream = torch.cuda.current_stream(X.device).cuda_stream
        # the launches of one binning run in order on the stream: a split
        # group's later parts overwrite the earlier parts' rows
        for j, launch in enumerate(plan.launches):
            rc = lib.ingest_bin(
                X.data_ptr(), n, F, state.group_ptr.data_ptr(),
                state.members.data_ptr(), state.words.data_ptr(),
                state.chunks.data_ptr() + 4 * planner.CHUNK_INTS * first,
                len(launch), state.columns.data_ptr(), plan.mode(j), G,
                out.element_size(), plan.tile_rows,
                planner.ingest_grid(plan, n, j), plan.threads,
                plan.smem_bytes, out.data_ptr(), stream)
            if rc != 0:
                raise RuntimeError(
                    f"ingest kernel launch failed: CUDA error {rc}")
            mine = thread_launch_counts()
            with _counts_lock:
                launch_counts["ingest"] += 1
                mine["ingest"] += 1
            first += len(launch)
    return out


class _KernelState(NamedTuple):
    """What one binner's kernel launches share: the ragged tables (each
    member's column its index in its chunk's column list), the chunk
    records of every launch and the chunks' column lists on the card,
    and the launch plan."""

    plan: "planner.IngestPlan"
    group_ptr: torch.Tensor
    members: torch.Tensor
    words: torch.Tensor
    chunks: torch.Tensor
    columns: torch.Tensor


def plan_tables(num_features: int, kt: KernelTables) -> "planner.IngestPlan":
    """``ops/planner.py::ingest_plan`` for ``kernel_tables``' output."""
    M = int(kt.group_ptr[-1])
    member_words = np.append(kt.members[:M, 4], kt.group_words[-1])
    return planner.ingest_plan(num_features, kt.group_ptr, member_words,
                               kt.members[:M, 0])


class DeviceBinner:
    """Bins [n, F] f32 blocks of one dataset on ``device``.

    ``__call__`` returns the FEATURE-MAJOR [G, n] matrix (uint8, or int32
    where a group has more than 256 bins) on the input's device — the
    JAX package's binner returns [n, G]; the port writes the trainer's
    layout directly.  The kernel's ragged tables and launch plan are
    made at the first CUDA call (``ops/planner.py ingest_plan``); one
    binning is one launch, or one for each part of the largest split
    group (``launch_counts["ingest"]`` counts launches)."""

    def __init__(self, tables: IngestTables, device=None):
        self.tables = tables
        dev = torch.device("cpu" if device is None else device)
        self.bounds = torch.from_numpy(tables.bounds).to(dev)
        self.cats = torch.from_numpy(tables.cats).to(dev)
        self._state: Optional[_KernelState] = None

    def kernel_state(self) -> _KernelState:
        if self._state is None:
            kt = kernel_tables(self.tables)
            plan = plan_tables(self.tables.num_features, kt)
            members = kt.members.copy()
            M = int(kt.group_ptr[-1])
            members[:M, 0] = plan.local_column
            chunks = np.asarray([c for launch in plan.launches
                                 for c in launch] or [[0] * planner.CHUNK_INTS],
                                np.int32)
            dev = self.bounds.device
            self._state = _KernelState(
                plan, *(torch.from_numpy(a).to(dev) for a in (
                    kt.group_ptr, members, kt.words, chunks,
                    np.asarray(plan.columns or (0,), np.int32))))
        return self._state

    def plain(self, X: torch.Tensor) -> torch.Tensor:
        return bin_plain(X, self.tables, self.bounds, self.cats)

    def __call__(self, X: torch.Tensor) -> torch.Tensor:
        if not isinstance(X, torch.Tensor) or X.dtype != torch.float32 \
                or X.dim() != 2:
            raise ValueError("DeviceBinner takes a 2-D float32 tensor")
        if X.shape[1] != self.tables.num_features:
            raise ValueError(
                f"binner built for {self.tables.num_features} features, "
                f"got a block of {X.shape[1]}")
        if X.device != self.bounds.device:
            raise ValueError(f"X is on {X.device}, the tables on "
                             f"{self.bounds.device}")
        X = X.contiguous()
        if X.device.type == "cpu":
            return self.plain(X)
        if X.device.type != "cuda":
            raise ValueError(f"no binning kernel for device {X.device}")
        return _bin_cuda(X, self)
