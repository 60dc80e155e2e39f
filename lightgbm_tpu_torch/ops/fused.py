"""Histogram -> split search for a whole frontier (counterpart of
``lightgbm_tpu/ops/fused.py``).

The JAX package's Pallas megakernel (``_fused_call``) streams the binned
rows once per frontier round, accumulates the K smaller-child
histograms in a VMEM arena, derives each sibling from its parent and
scans both children's per-feature gains.  On Hopper it is two kernels
in ``csrc/fused.cu``, launched back to back on the current stream:

- ``accumulate`` (kernel B4, the counterpart of
  ``fused_frontier_accumulate``): [K, 3, F, B] int64 fixed-point sums of
  the rows of each slot, or, for the int8 levels of quantized training
  ([2, n] values), [K, 2, F, B] int32 sums.  It sorts the rows by slot
  on the card first (``_slot_order_cuda``, a stable counting sort whose
  plain version is ``slot_order_plain``; it also lays the slotted rows'
  values out in sorted order), then accumulates each slot's run of
  rows, so its work grows with the slotted rows, not with every row
  times the slots;
- ``sibling_scan`` (kernel B5, the counterpart of ``fused_sibling_scan``):
  exact sibling derive + the gain scan, six [NC, F] tuples; given
  ``ops.split.QuantScales`` it takes int32 level histograms and
  estimates the count channel (``ops.split.quant_count_hist``).  Three
  optional inputs select its other modes, in both: monotone constraints
  [F] (the monotone gain form), the children's output bounds [2, NC]
  (the clamp) and, in leaf mode, one random threshold per (child,
  feature) [NC, F] (extra trees).  In leaf mode it also reads the
  staged arm's group histograms [NC, C, G, Bg] directly, given their
  ``GroupLayout``: its plain version is ``expand_groups`` (the int64
  per-feature expansion) followed by the scan.  Its warp tasks
  (``scan_tasks``, from ``planner.scan_plan``) are built once a tree by
  the grower and passed in; a caller that passes none has them planned
  from its ``num_bin`` on the host.

``frontier_splits`` runs the pair (the megakernel's function, B2).
Each wrapper launches its kernel for CUDA tensors (or raises) and runs
the plain version (``ops.histogram.accumulate_plain``,
``ops.split.numeric_feature_scan``) for CPU tensors; the two agree bit
for bit because every sum is an exact integer (``ops/histogram.py``).
``launch_counts`` counts kernel launches per entry and mode, each where
its kernel is launched (``fused_frontier_accumulate`` and
``fused_frontier_accumulate_int8``, ...); a B2 is counted at the scan
launch that completes its pair, and B4's sort under
``fused_slot_order`` (once before every accumulate).  ``scan_modes``
splits B5's launches by the optional inputs they took (``plain``,
``monotone``, ``bounds``, ``rand_thr``, joined by ``+``; ``_int8`` for
the quantized mode), and ``path_counts`` counts B5's launches on group
histograms and the calls of ``expand_groups``.  A CUDA graph replays
launches without calling a wrapper, so the grower counts each replay
as the launches its capture recorded (``launch_count_delta``,
``add_launch_counts``).  ``thread_launch_counts`` keeps the calling
thread's launches beside the process-wide counts (one rank's, where
ranks train in threads of one process).

The functions named after the JAX package's (``fused_frontier_splits``,
``fused_segment_splits``, ``fused_frontier_accumulate``,
``fused_sibling_scan``) keep its f32 histograms at the interface and
convert to fixed point inside, and take the JAX package's int8 values
and int32 histograms with ``quant_scales`` in the quantized mode; the
grower calls the fixed-point entries directly and keeps its histogram
cache in int64 (int32 when quantized).
"""

from __future__ import annotations

import ctypes
import threading
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from . import _build, planner
from .histogram import (INT32_SAFE_ROWS, accumulate_plain, exponent_tensor,
                        fixed_point_scales, hist_scales, to_fixed)
from .split import (NumericFeatureBest, PerFeatureBest, QuantScales,
                    SplitHyperparams, SplitResult, f32,
                    fixed_to_f32, merge_categorical, numeric_feature_scan,
                    pick_best_feature, quant_count_hist, scale_tensor)

_ENTRIES = ("fused_frontier_splits", "fused_frontier_accumulate",
            "fused_sibling_scan", "fused_slot_order")
_counts_lock = threading.Lock()
launch_counts = {name + mode: 0 for mode in ("", "_int8")
                 for name in _ENTRIES}
scan_modes: dict = {}
# B5 launches that read the staged arm's group histograms, and calls of
# expand_groups (what the staged search expands)
path_counts = {"b5_on_group_histograms": 0, "expand_groups_calls": 0}


_thread = threading.local()


def thread_launch_counts() -> dict:
    """The calling thread's kernel launches by entry and mode (one
    rank's, when ranks train in threads of one process): counted beside
    ``launch_counts`` at every launch and replay."""
    d = getattr(_thread, "counts", None)
    if d is None:
        d = _thread.counts = {}
    return d


def reset_launch_counts() -> None:
    with _counts_lock:
        for k in launch_counts:
            launch_counts[k] = 0
        scan_modes.clear()
        for k in path_counts:
            path_counts[k] = 0
    thread_launch_counts().clear()


def _count(name: str, quant: bool) -> None:
    key = name + ("_int8" if quant else "")
    mine = thread_launch_counts()
    with _counts_lock:
        launch_counts[key] += 1
        mine[key] = mine.get(key, 0) + 1


def launch_count_snapshot() -> tuple:
    """The counts now (``launch_counts``, ``scan_modes``,
    ``path_counts``)."""
    with _counts_lock:
        return dict(launch_counts), dict(scan_modes), dict(path_counts)


def launch_count_delta(before: tuple) -> tuple:
    """What the counts rose by since ``before``: the launches a CUDA
    graph captured, counted again at each replay (``add_launch_counts``)
    since a replay goes through no wrapper."""
    now = launch_count_snapshot()
    return tuple({k: v - b.get(k, 0) for k, v in n.items()
                  if v != b.get(k, 0)} for n, b in zip(now, before))


def restore_launch_counts(before: tuple) -> None:
    with _counts_lock:
        launch_counts.update(before[0])
        scan_modes.clear()
        scan_modes.update(before[1])
        path_counts.update(before[2])


def add_launch_counts(delta: tuple) -> None:
    mine = thread_launch_counts()
    with _counts_lock:
        for counts, d in zip((launch_counts, scan_modes, path_counts),
                             delta):
            for k, v in d.items():
                counts[k] = counts.get(k, 0) + v
        for k, v in delta[0].items():
            mine[k] = mine.get(k, 0) + v


# ----------------------------------------------------------------------
# plain versions
# ----------------------------------------------------------------------

def derive_children(small: torch.Tensor, small_left: torch.Tensor,
                    parent: torch.Tensor) -> torch.Tensor:
    """[K, C, F, B] smaller-child + parent integers -> [2K, C, F, B]
    children [left 0..K-1, right K..2K-1], exact."""
    sl = small_left.to(torch.bool)[:, None, None, None]
    h_left = torch.where(sl, small, parent - small)
    return torch.cat([h_left, parent - h_left])


def slot_order_plain(slot: torch.Tensor, num_slots: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The sort step of B4 in plain torch: ``order`` [n] int32, the rows
    with ``slot`` in [0, K) grouped by slot (ascending row id within a
    slot), the dropped rows last; ``offsets`` [K + 1] int32, slot k's
    rows at ``order[offsets[k]:offsets[k + 1]]``."""
    K = int(num_slots)
    s = slot.to(torch.int64)
    key = torch.where((s >= 0) & (s < K), s, torch.full_like(s, K))
    order = torch.argsort(key, stable=True).to(torch.int32)
    offsets = torch.zeros(K + 1, dtype=torch.int32, device=slot.device)
    if K:
        offsets[1:] = torch.cumsum(torch.bincount(key, minlength=K + 1)[:K],
                                   0).to(torch.int32)
    return order, offsets


def sorted_values_plain(vals_t: torch.Tensor, order: torch.Tensor,
                        offsets: torch.Tensor, scales=None) -> torch.Tensor:
    """What B4's sort lays out beside ``order``, in plain torch: the
    slotted rows' values in sorted order, [m, C] with m = offsets[K]:
    int64 ``to_fixed`` at ``scales`` for f32 ``vals_t`` [3, n], the int8
    levels [2, n] as they are."""
    rows = order[:int(offsets[-1])].to(torch.int64)
    q = vals_t if vals_t.dtype == torch.int8 else to_fixed(vals_t, scales, 0)
    return q[:, rows].t().contiguous()


class GroupLayout(NamedTuple):
    """Where the staged arm's group histograms keep each feature (the
    dataset's EFB bundles): feature f's bin b >= 1 is merged bin
    ``feat_start[f] + b - 1`` of column ``feat_group[f]`` ([F] int32
    each); ``num_bins`` is the per-feature bin axis B."""

    feat_group: torch.Tensor
    feat_start: torch.Tensor
    num_bins: int


def expand_groups(ghist: torch.Tensor, groups: GroupLayout,
                  num_bin: torch.Tensor,
                  idx: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Group histograms [NC, C, G, Bg] (int64 fixed point, or the int32
    levels of quantized training) -> per-feature ones [NC, C, F, B] for
    the features ``idx`` (all where None), in plain torch (reference:
    grower_rounds.py:199-215): bin b >= 1 of feature f is merged bin
    ``feat_start[f] + b - 1`` of column ``feat_group[f]`` for b <
    ``num_bin[f]``, else 0; bin 0 (FixHistogram) is the child's total
    minus the feature's other bins.  The totals are the sum over group
    0's bins (every group column holds one bin per row), so the rebuilt
    bin is exact."""
    with _counts_lock:
        path_counts["expand_groups_calls"] += 1
    NC, C, G, Bg = ghist.shape
    B = int(groups.num_bins)
    fg, fs, nb = (t.to(device=ghist.device, dtype=torch.int64)
                  for t in (groups.feat_group, groups.feat_start, num_bin))
    if idx is not None:
        fg, fs, nb = fg[idx], fs[idx], nb[idx]
    b = torch.arange(B, device=ghist.device)
    merged = (fs[:, None] + b[None, :] - 1).clamp(0, Bg - 1)
    flat = fg[:, None] * Bg + merged                               # [F, B]
    drop = ~((b[None, :] >= 1) & (b[None, :] < nb[:, None]))
    h = ghist.reshape(NC, C, G * Bg)[:, :, flat]                   # [NC,C,F,B]
    h.masked_fill_(drop, 0)
    totals = ghist[:, :, 0, :].sum(-1)                             # [NC, C]
    h[..., 0] = totals[..., None] - h.sum(-1)
    return h


def scan_plain(small, scales, child_sums, num_bin, missing_type,
               default_bin, hp, small_left=None, parent=None,
               monotone_constraints=None, child_bounds=None, rand_thr=None,
               groups: Optional[GroupLayout] = None):
    if groups is not None:
        hist = expand_groups(small, groups, num_bin)
    else:
        hist = (small if parent is None
                else derive_children(small, small_left, parent))
    if isinstance(scales, QuantScales):
        hist = quant_count_hist(hist, child_sums[2])
    return numeric_feature_scan(hist, scales, child_sums[0], child_sums[1],
                                child_sums[2], num_bin, missing_type,
                                default_bin, hp, monotone_constraints,
                                child_bounds, rand_thr)


# ----------------------------------------------------------------------
# the kernels
# ----------------------------------------------------------------------

_lib_lock = threading.Lock()
_lib_handle = None


def _lib():
    global _lib_handle
    with _lib_lock:
        if _lib_handle is None:
            lib = _build.load("fused")
            p, i, fl = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
            lib.fused_slot_order.argtypes = [
                p, i, i, i, p, i,              # slot n K nblk vals bytes
                p, i,                          # exps acc_rows
                p, p, p, p, p, p]              # counts order offsets
            #                                    seg_start sv stream
            lib.fused_slot_order.restype = ctypes.c_int
            lib.fused_accumulate.argtypes = [
                p, i, i, p, p, p, p,           # binned bytes vbytes order
                i, i, i, i,                    # sv offsets seg_start; n F K B
                i, i, i, i, p, p]              # seg_rows segs ft threads
            #                                    out stream
            lib.fused_accumulate.restype = ctypes.c_int
            lib.fused_scan.argtypes = [
                p, p, p, p, p, p, i,           # small parent sl fg fs plan
                #                                tasks
                p, p, p, p,                    # sums nb mt db
                p, p, p,                       # mono bounds rand_thr
                i, i, i, i, i, i, i,           # K F B G Bg NC quant
                p,                             # scales
                i, fl, fl, fl, fl, fl, fl,     # use_l1 l1 l2 mgain mdata
                #                                mhess max_delta_step
                p, p, p, p, p, p, p]           # six outputs, stream
            lib.fused_scan.restype = ctypes.c_int
            lib.fused_prepare.argtypes = []
            lib.fused_prepare.restype = ctypes.c_int
            _lib_handle = lib
    # the kernels' shared-memory limits, raised once for the current
    # device before its first launch (no launch sets them, so launches
    # can be captured into a CUDA graph)
    _build.prepare("fused", _lib_handle)
    return _lib_handle


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _slot_order_cuda(slot, num_slots, vals_t, scales=None):
    """B4's sort on the card: (order [n], meta [2(K + 1)] = offsets then
    the accumulate's segment starts, sv = the slotted rows' values in
    sorted order, [n, C] of which the first offsets[K] rows are written:
    int64 fixed point at ``scales``, the int32 [3] exponents on the card,
    or the int8 levels as they are).  Three launches on the current
    stream, no host sync; the plain version is ``slot_order_plain`` and
    ``sorted_values_plain``."""
    n, K = slot.shape[0], int(num_slots)
    dev = slot.device
    nblk = planner.sort_blocks(n)
    counts = torch.empty((K + 1) * nblk, dtype=torch.int32, device=dev)
    order = torch.empty(n, dtype=torch.int32, device=dev)
    meta = torch.empty(2 * (K + 1), dtype=torch.int32, device=dev)
    quant = vals_t.dtype == torch.int8
    sv = torch.empty((n, vals_t.shape[0]), device=dev,
                     dtype=torch.int8 if quant else torch.int64)
    with torch.cuda.device(dev):
        lib = _lib()
        rc = lib.fused_slot_order(
            slot.data_ptr(), n, K, nblk, vals_t.data_ptr(),
            vals_t.element_size(),
            None if quant else exponent_tensor(scales, dev).data_ptr(),
            planner.acc_seg_rows(n), counts.data_ptr(), order.data_ptr(),
            meta.data_ptr(), meta.data_ptr() + 4 * (K + 1), sv.data_ptr(),
            _stream(slot))
    if rc != 0:
        raise RuntimeError(f"slot sort kernel launch failed: CUDA error {rc}")
    _count("fused_slot_order", quant)
    return order, meta, sv


def _accumulate_cuda(binned_t, vals_t, slot, num_slots, num_bins,
                     scales=None):
    F, n = binned_t.shape
    K, B = int(num_slots), int(num_bins)
    quant = vals_t.dtype == torch.int8
    out = torch.zeros((K, 2, F, B) if quant else (K, 3, F, B),
                      dtype=torch.int32 if quant else torch.int64,
                      device=binned_t.device)
    if n == 0 or K == 0 or F == 0:
        return out
    ft = planner.acc_feat_tile(F, B, quant)
    order, meta, sv = _slot_order_cuda(slot, K, vals_t, scales)
    with torch.cuda.device(binned_t.device):
        lib = _lib()
        rc = lib.fused_accumulate(
            binned_t.data_ptr(), binned_t.element_size(),
            vals_t.element_size(), order.data_ptr(), sv.data_ptr(),
            meta.data_ptr(), meta.data_ptr() + 4 * (K + 1), n, F, K, B,
            planner.acc_seg_rows(n), planner.acc_segments(n, K), ft,
            planner.ACC_THREADS, out.data_ptr(), _stream(binned_t))
    if rc != 0:
        raise RuntimeError(f"accumulate kernel launch failed: CUDA error {rc}")
    _count("fused_frontier_accumulate", quant)
    return out


def scan_tasks(num_bin, num_bins: int, device) -> torch.Tensor:
    """B5's warp tasks for the per-feature bin counts ``num_bin`` (a host
    sequence) over a bin axis of ``num_bins``: the lane entries of
    ``planner.scan_plan``, int32 [tasks * 32] on ``device``."""
    plan = planner.scan_plan([int(x) for x in num_bin], num_bins)
    return torch.tensor(plan.lanes, dtype=torch.int32, device=device)


def _scan_cuda(small, scales, child_sums, num_bin, missing_type,
               default_bin, hp, small_left=None, parent=None,
               monotone_constraints=None, child_bounds=None, rand_thr=None,
               pair=False, groups: Optional[GroupLayout] = None,
               plan: Optional[torch.Tensor] = None):
    if groups is None:
        K, _, F, B = small.shape
        G = Bg = 0
    else:
        K, _, G, Bg = small.shape
        F, B = num_bin.shape[0], int(groups.num_bins)
    NC = 2 * K if parent is not None else K
    dev = small.device
    outs = [torch.empty((NC, F), dtype=dt, device=dev) for dt in
            (torch.float32, torch.int32, torch.int32, torch.float32,
             torch.float32, torch.float32)]
    if NC == 0 or F == 0:
        return _best(outs)
    if plan is None:
        plan = scan_tasks(num_bin.tolist(), B, dev)
    tasks = plan.numel() // planner.SCAN_LANES
    sl = (small_left.to(torch.int32).contiguous()
          if small_left is not None else None)
    quant = isinstance(scales, QuantScales)
    sc = scale_tensor(scales, dev)
    with torch.cuda.device(dev):
        lib = _lib()
        rc = lib.fused_scan(
            small.data_ptr(),
            None if parent is None else parent.data_ptr(),
            None if sl is None else sl.data_ptr(),
            *((None, None) if groups is None else
              (groups.feat_group.data_ptr(), groups.feat_start.data_ptr())),
            plan.data_ptr(), tasks,
            child_sums.data_ptr(), num_bin.data_ptr(),
            missing_type.data_ptr(), default_bin.data_ptr(),
            *(None if t is None else t.data_ptr()
              for t in (monotone_constraints, child_bounds, rand_thr)),
            K, F, B, G, Bg, NC, int(quant), sc.data_ptr(),
            int(hp.lambda_l1 > 0.0),
            f32(hp.lambda_l1), f32(hp.lambda_l2),
            f32(hp.min_gain_to_split), f32(hp.min_data_in_leaf),
            f32(hp.min_sum_hessian_in_leaf), f32(hp.max_delta_step),
            *(o.data_ptr() for o in outs), _stream(small))
    if rc != 0:
        raise RuntimeError(f"scan kernel launch failed: CUDA error {rc}")
    _count("fused_sibling_scan", quant)
    mode = "+".join(name for name, t in (
        ("monotone", monotone_constraints), ("bounds", child_bounds),
        ("rand_thr", rand_thr)) if t is not None) or "plain"
    with _counts_lock:
        key = mode + ("_int8" if quant else "")
        scan_modes[key] = scan_modes.get(key, 0) + 1
        path_counts["b5_on_group_histograms"] += groups is not None
    if pair:
        # the launch that completes an accumulate -> scan pair (B2)
        _count("fused_frontier_splits", quant)
    return _best(outs)


def _best(outs) -> NumericFeatureBest:
    gain, thr, dl, lg, lh, lc = outs
    return NumericFeatureBest(gain=gain, threshold=thr,
                              default_left=dl.to(torch.bool),
                              left_sum_grad=lg, left_sum_hess=lh,
                              left_count=lc)


def _check_device(*ts) -> str:
    kinds = {t.device.type for t in ts if t is not None}
    if len(kinds) != 1:
        raise ValueError(f"tensors on mixed devices: {sorted(kinds)}")
    kind = kinds.pop()
    if kind not in ("cpu", "cuda"):
        raise ValueError(f"no fused kernels for device {kind}")
    return kind


# ----------------------------------------------------------------------
# fixed-point entries (the grower's)
# ----------------------------------------------------------------------

def accumulate(binned_t: torch.Tensor, vals_t: torch.Tensor,
               slot: torch.Tensor, num_slots: int, num_bins: int,
               scales: Optional[Sequence[int]] = None) -> torch.Tensor:
    """Kernel B4: [K, 3, F, B] int64 sums of ``round(vals * 2**s)`` per
    (slot, channel, feature, bin); ``slot == num_slots`` drops a row.
    ``binned_t`` [F, n] uint8/int32, ``vals_t`` [3, n] f32, ``slot`` [n]
    int32, all contiguous; ``scales`` the exponents s, three ints or an
    int tensor [3] (on the card the kernel reads them from the device,
    so a tensor there costs no copy).  An int8 ``vals_t`` [2, n]
    (quantized levels; ``scales`` unused) gives the [K, 2, F, B] int32
    sums of the levels, for at most ``INT32_SAFE_ROWS`` rows."""
    if vals_t.dtype == torch.int8:
        if vals_t.dim() != 2 or vals_t.shape[0] != 2:
            raise ValueError(f"int8 vals_t must be [2, n], got "
                             f"{tuple(vals_t.shape)}")
        if binned_t.shape[1] > INT32_SAFE_ROWS:
            raise ValueError(
                f"{binned_t.shape[1]} rows: int32 sums of quantized levels "
                f"hold at most {INT32_SAFE_ROWS} rows")
    elif scales is None:
        raise ValueError("f32 values need their fixed-point scales")
    if _check_device(binned_t, vals_t, slot) == "cpu":
        return accumulate_plain(binned_t, vals_t, slot, num_slots,
                                num_bins, scales)
    if binned_t.dtype not in (torch.uint8, torch.int32):
        raise ValueError(f"binned matrix must be uint8 or int32, got "
                         f"{binned_t.dtype}")
    if (vals_t.dtype not in (torch.float32, torch.int8)
            or slot.dtype != torch.int32):
        raise ValueError("vals_t must be float32 or int8 and slot int32")
    if not (binned_t.is_contiguous() and vals_t.is_contiguous()
            and slot.is_contiguous()):
        raise ValueError("accumulate takes contiguous tensors")
    return _accumulate_cuda(
        binned_t, vals_t, slot, num_slots, num_bins,
        None if vals_t.dtype == torch.int8
        else exponent_tensor(scales, binned_t.device))


def sibling_scan(small: torch.Tensor, scales: Sequence[int],
                 child_sums: torch.Tensor, num_bin: torch.Tensor,
                 missing_type: torch.Tensor, default_bin: torch.Tensor,
                 hp: SplitHyperparams,
                 small_left: Optional[torch.Tensor] = None,
                 parent: Optional[torch.Tensor] = None,
                 monotone_constraints: Optional[torch.Tensor] = None,
                 child_bounds: Optional[tuple] = None,
                 rand_thr: Optional[torch.Tensor] = None, pair: bool = False,
                 groups: Optional[GroupLayout] = None,
                 plan: Optional[torch.Tensor] = None
                 ) -> NumericFeatureBest:
    """Kernel B5: derive the children (parent mode: ``small`` holds each
    candidate's smaller child, ``parent`` its parent; leaf mode: ``small``
    holds the children) and scan them.  ``child_sums`` [3, NC] f32;
    meta [F] int32.  Returns [NC, F] tuples.  ``pair`` (set by
    ``frontier_splits``) also counts the launch as one of B2.
    ``scales``: the f32 mode's fixed-point exponents with int64 [K, 3,
    F, B] histograms, or ``QuantScales`` with int32 [K, 2, F, B] level
    histograms (quantized mode).  ``groups`` (leaf mode only): ``small``
    is the staged arm's group histograms [NC, C, G, Bg] and the scan
    reads each feature's bins from them (``expand_groups``).
    ``monotone_constraints`` [F] int32 selects the monotone gain form,
    ``child_bounds`` ([NC], [NC]) f32 the children's output clamp,
    ``rand_thr`` [NC, F] int32 (leaf mode only) one valid threshold per
    (child, feature).  ``plan``: the kernel's warp tasks for ``num_bin``
    and this bin axis (``scan_tasks``), planned here from ``num_bin``
    (read on the host) where None."""
    if rand_thr is not None and parent is not None:
        raise ValueError("random thresholds are a leaf-mode input")
    if groups is not None and parent is not None:
        raise ValueError("group histograms are a leaf-mode input")
    if _check_device(small, child_sums, parent, monotone_constraints,
                     rand_thr, *(child_bounds or ())) == "cpu":
        return scan_plain(small, scales, child_sums, num_bin, missing_type,
                          default_bin, hp, small_left, parent,
                          monotone_constraints, child_bounds, rand_thr,
                          groups=groups)
    quant = isinstance(scales, QuantScales)
    want = torch.int32 if quant else torch.int64
    if small.dtype != want or (parent is not None and parent.dtype != want):
        raise ValueError(f"the scan kernel takes {want} histograms in "
                         f"{'the quantized' if quant else 'the f32'} mode")
    meta = [m.to(torch.int32).contiguous()
            for m in (num_bin, missing_type, default_bin)]
    NC = small.shape[0] * (2 if parent is not None else 1)
    F = meta[0].shape[0]
    if groups is None and small.shape[2] != F:
        raise ValueError(f"{small.shape[2]} histogram features for {F} "
                         f"meta entries")
    if groups is not None:
        groups = GroupLayout(
            *(t.to(device=small.device, dtype=torch.int32).contiguous()
              for t in (groups.feat_group, groups.feat_start)),
            int(groups.num_bins))
        if groups.feat_group.shape != (F,) or groups.feat_start.shape != (F,):
            raise ValueError(f"feat_group and feat_start must be [{F}]")
    if plan is not None and (plan.dtype != torch.int32 or plan.dim() != 1
                             or plan.numel() % planner.SCAN_LANES
                             or plan.device != small.device):
        raise ValueError("plan must be scan_tasks' int32 lane entries on "
                         "the histograms' device")
    mono = bounds = thr = None
    if monotone_constraints is not None:
        mono = monotone_constraints.to(torch.int32).contiguous()
        if mono.shape != (F,):
            raise ValueError(f"monotone_constraints must be [{F}]")
    if child_bounds is not None:
        bounds = torch.stack([b.to(torch.float32) for b in child_bounds]
                             ).contiguous()
        if bounds.shape != (2, NC):
            raise ValueError(f"child_bounds must be two [{NC}] vectors")
    if rand_thr is not None:
        thr = rand_thr.to(torch.int32).contiguous()
        if thr.shape != (NC, F):
            raise ValueError(f"rand_thr must be [{NC}, {F}]")
    return _scan_cuda(small.contiguous(),
                      scales if quant
                      else exponent_tensor(scales, small.device),
                      child_sums.to(torch.float32).contiguous(), *meta, hp,
                      small_left,
                      None if parent is None else parent.contiguous(),
                      mono, bounds, thr, pair=pair, groups=groups,
                      plan=plan)


def frontier_splits(binned_t, vals_t, slot, num_slots, num_bins, scales,
                    child_sums, small_left, parent, num_bin, missing_type,
                    default_bin, hp, monotone_constraints=None,
                    child_bounds=None, plan=None):
    """The megakernel's function (B2): accumulate the K smaller-child
    histograms (B4), then derive each sibling and scan both children
    (B5, with the monotone constraints and bounds when given, and its
    warp tasks ``plan`` as ``sibling_scan`` takes them).  Returns
    (smaller-child hist [K, 3, F, B] int64, or [K, 2, F, B] int32 for
    int8 values with ``QuantScales``, and [2K, F] tuples)."""
    seg = accumulate(binned_t, vals_t, slot, num_slots, num_bins, scales)
    nfb = sibling_scan(seg, scales, child_sums, num_bin, missing_type,
                       default_bin, hp, small_left=small_left,
                       parent=parent,
                       monotone_constraints=monotone_constraints,
                       child_bounds=child_bounds, pair=True, plan=plan)
    return seg, nfb


# ----------------------------------------------------------------------
# the JAX package's interface (f32 histograms)
# ----------------------------------------------------------------------

def _meta(num_bin, missing_type, default_bin, device):
    return [torch.as_tensor(np.asarray(m), dtype=torch.int32, device=device)
            if not isinstance(m, torch.Tensor) else
            m.to(device=device, dtype=torch.int32)
            for m in (num_bin, missing_type, default_bin)]


def _quant(quant_scales) -> QuantScales:
    if quant_scales is None:
        raise ValueError("quantized fused kernels need quant_scales")
    return QuantScales(float(quant_scales[0]), float(quant_scales[1]))


def _mono(monotone_constraints, child_bounds, device) -> dict:
    """The JAX signature's optional scan inputs as tensors on ``device``."""
    def t(x, dtype):
        return torch.as_tensor(np.asarray(x) if not isinstance(
            x, torch.Tensor) else x, dtype=dtype, device=device)
    return {"monotone_constraints": (
                None if monotone_constraints is None
                else t(monotone_constraints, torch.int32)),
            "child_bounds": (
                None if child_bounds is None
                else tuple(t(b, torch.float32) for b in child_bounds))}


def fused_frontier_accumulate(binned_t, vals_t, slot, num_slots: int,
                              num_bins: int) -> torch.Tensor:
    """The K slot histograms [K, 3, F, B] f32 (each cell the f32 of its
    exact sum); for int8 ``vals_t`` [2, n], [K, 2, F, B] int32."""
    if vals_t.dtype == torch.int8:
        return accumulate(binned_t, vals_t, slot, num_slots, num_bins)
    scales = fixed_point_scales(vals_t)
    hist = accumulate(binned_t, vals_t, slot, num_slots, num_bins, scales)
    return fixed_to_f32(hist, scales, 1)


def fused_sibling_scan(small_hist, child_sums, num_bin, missing_type,
                       default_bin, hp: SplitHyperparams, small_left=None,
                       parent_hist=None, quant_scales=None,
                       monotone_constraints=None, child_bounds=None
                       ) -> NumericFeatureBest:
    """Sibling derive + gain scan on given f32 histograms (converted to
    fixed point at scales that bound every prefix of every child), or on
    integer [K, 2, F, B] level histograms with ``quant_scales`` (g, h);
    ``monotone_constraints`` [F] and ``child_bounds`` ([NC], [NC]) as in
    the JAX package."""
    mono = _mono(monotone_constraints, child_bounds, small_hist.device)
    if not small_hist.dtype.is_floating_point:
        meta = _meta(num_bin, missing_type, default_bin, small_hist.device)
        return sibling_scan(
            small_hist.to(torch.int32), _quant(quant_scales),
            torch.as_tensor(child_sums), *meta, hp, small_left=small_left,
            parent=(parent_hist.to(torch.int32) if parent_hist is not None
                    else None), **mono)
    hs = [small_hist] + ([parent_hist] if parent_hist is not None else [])
    scales = hist_scales(*hs)
    small = to_fixed(small_hist, scales, 1)
    parent = (to_fixed(parent_hist, scales, 1)
              if parent_hist is not None else None)
    meta = _meta(num_bin, missing_type, default_bin, small.device)
    return sibling_scan(small, scales, torch.as_tensor(child_sums), *meta,
                        hp, small_left=small_left, parent=parent, **mono)


def fused_segment_splits(binned_t, vals_t, slot, num_slots: int,
                         num_bins: int, slot_sums, num_bin, missing_type,
                         default_bin, hp: SplitHyperparams,
                         quant_scales=None, monotone_constraints=None,
                         child_bounds=None
                         ) -> Tuple[torch.Tensor, NumericFeatureBest]:
    """Leaf mode: K slot histograms and their per-feature-best splits
    (int32 histograms for int8 ``vals_t`` with ``quant_scales``)."""
    mono = _mono(monotone_constraints, child_bounds, binned_t.device)
    if vals_t.dtype == torch.int8:
        hist = accumulate(binned_t, vals_t, slot, num_slots, num_bins)
        meta = _meta(num_bin, missing_type, default_bin, hist.device)
        return hist, sibling_scan(hist, _quant(quant_scales),
                                  torch.as_tensor(slot_sums), *meta, hp,
                                  **mono)
    scales = fixed_point_scales(vals_t)
    hist = accumulate(binned_t, vals_t, slot, num_slots, num_bins, scales)
    meta = _meta(num_bin, missing_type, default_bin, hist.device)
    best = sibling_scan(hist, scales, torch.as_tensor(slot_sums), *meta, hp,
                        **mono)
    return fixed_to_f32(hist, scales, 1), best


def fused_frontier_splits(binned_t, vals_t, slot, num_slots: int,
                          num_bins: int, child_sums, small_left,
                          parent_hist, num_bin, missing_type, default_bin,
                          hp: SplitHyperparams, quant_scales=None,
                          monotone_constraints=None, child_bounds=None
                          ) -> Tuple[torch.Tensor, NumericFeatureBest]:
    """Frontier mode: the K smaller-child histograms (f32; int32 for int8
    ``vals_t`` with ``quant_scales``) and the [2K, F] tuples of both
    children of every candidate."""
    mono = _mono(monotone_constraints, child_bounds, binned_t.device)
    if vals_t.dtype == torch.int8:
        parent = parent_hist.to(torch.int32)
        meta = _meta(num_bin, missing_type, default_bin, parent.device)
        return frontier_splits(
            binned_t, vals_t, slot, num_slots, num_bins,
            _quant(quant_scales), torch.as_tensor(child_sums),
            torch.as_tensor(small_left), parent, *meta, hp, **mono)
    scales = tuple(min(a, b) for a, b in zip(fixed_point_scales(vals_t),
                                             hist_scales(parent_hist)))
    parent = to_fixed(parent_hist, scales, 1)
    meta = _meta(num_bin, missing_type, default_bin, parent.device)
    seg, best = frontier_splits(
        binned_t, vals_t, slot, num_slots, num_bins, scales,
        torch.as_tensor(child_sums), torch.as_tensor(small_left), parent,
        *meta, hp, **mono)
    return fixed_to_f32(seg, scales, 1), best


def pick_fused_best(best: NumericFeatureBest, sum_grad, sum_hess, num_data,
                    feature_mask: Optional[torch.Tensor] = None,
                    cat_best: Optional[PerFeatureBest] = None,
                    cat_idx: Optional[torch.Tensor] = None) -> SplitResult:
    """argmax over features of the per-feature-best tuples (ties ->
    smaller feature index), over the leading children axis; the feature
    mask applies here, as ``feature_best_splits`` applies it.

    Categorical merge: the kernels accumulate and scan every column, but
    the numeric scan means nothing on a categorical one, so the grower
    runs ``ops.split._best_categorical`` on the categorical slice of the
    children's histograms and passes it as ``cat_best`` (fields [..., Fc])
    with the column indices ``cat_idx``; its tuples replace the numeric
    ones before the argmax, as in the JAX package."""
    return pick_best_feature(merge_categorical(best, cat_best, cat_idx),
                             sum_grad, sum_hess, num_data, feature_mask)
