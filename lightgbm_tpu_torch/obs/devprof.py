"""Measured device profiling on the card (counterpart of
``lightgbm_tpu/obs/devprof.py``): the work each kernel must do, its time,
and the share of the card's peak rates that time reaches.

The JAX module reads FLOPs and bytes from XLA's ``cost_analysis`` of a
compiled program.  The card has no such model, and a count of what one
implementation happens to touch would move with every redesign.  So the
port counts the work: ``kernel_cost(kernel, **shape)`` gives, for B1-B6,
the bytes the function must move (each input read once, each output
written once) and its f32 operations, from the shape and, where the work
depends on the data (B1's descents, B4's slotted rows), from what this
input needs.  These are the numbers behind ``chip_smoke.py``'s bounds
(``roofline``: the larger of bytes over the memory rate and operations
over the f32 rate), so a redesigned kernel keeps its count and a
benchmark reads a roofline share from it:

    mfu      = ops / seconds / peak f32 FLOP/s
    hbm_util = bytes / seconds / peak memory bytes/s

The peaks are published rates keyed by ``torch.cuda.get_device_name()``
(``peak_flops_for``, ``peak_hbm_bw_for``): the H100 SXM's 3.35e12 B/s
and 67e12 f32 FLOP/s outside the tensor cores, where these kernels run.
A card not in the tables gets no ``mfu``/``hbm_util``, and the CPU none.

``measure_program`` times a callable with CUDA events after a warm call
(the host clock on the CPU).  The three tables keep the JAX package's
row names for the variants the port has:

- ``histogram_utilization_table``: ``f32/pallas`` (B6), ``quant/pallas``
  (the quantized whole-data histogram, which on the card is B4 in int8
  mode with one slot: B6 has no int8 mode), ``f32/fused`` and
  ``quant/fused`` (B2), and ``*/fused_sharded_flat`` (B4 then B5, the
  seam pair the sharded growers run);
- ``predict_utilization_table``: ``fused`` (B1 leaves) and
  ``fused_scores`` (B1 scores);
- ``ingest_utilization_table``: ``kernel/t<tile>`` (B3 at the planned
  launch; ``kernel/plain`` on the CPU) and the ``host`` row
  (``Dataset._bin_block``).

The TPU-only variants (``matmul*``, ``sorted``, ``expanded``, ``while``,
``fori``, the tile ladders) have no row; ``f32/scatter_batched8`` waits
for the model axis (ROADMAP queue A12).  On the card a kernel that fails
to build or launch raises out of a table; on the CPU a row times the
plain version and says so (``"route": "plain"``).  A table publishes the
best row's ``mfu`` as the ``mfu_measured_best`` gauge, which
``obs.aggregate`` and ``obs.diagnose`` read.  ``profiler_trace`` records
a ``torch.profiler`` Chrome trace around a block.
"""

from __future__ import annotations

import math
import os
import time
from contextlib import contextmanager
from typing import Callable, Optional

# published H100 SXM peaks (NVIDIA H100 Tensor Core GPU data sheet):
# HBM3 bytes/s, and f32 FLOP/s outside the tensor cores
H100_SXM_HBM_BYTES_PER_S = 3.35e12
H100_SXM_F32_FLOPS = 67e12
# by lower-cased device name (``torch.cuda.get_device_name``)
PEAK_HBM_BW = {"h100 80gb hbm3": H100_SXM_HBM_BYTES_PER_S,
               "h100 sxm": H100_SXM_HBM_BYTES_PER_S}
PEAK_F32_FLOPS = {"h100 80gb hbm3": H100_SXM_F32_FLOPS,
                  "h100 sxm": H100_SXM_F32_FLOPS}

# f32 operations per node visit of B1: isnan, the NaN->0 select,
# |v| <= 1e-35, v <= threshold
OPS_PER_VISIT = 4
# f32 operations per (child, feature, bin) of B5's gain scan: two
# directions of ~20 adds/multiplies/divides/compares each; the quantized
# scan adds the count estimate (convert, multiply, round) per cell
SCAN_OPS_PER_CELL = 40
QUANT_COUNT_OPS_PER_CELL = 3
# ... of the monotone scan: the plain scan's 40 plus, in each direction,
# two leaf outputs, two clamps, the direction test and two gains from
# outputs (~30 more)
MONO_OPS_PER_CELL = 70

KERNELS = ("B1", "B2", "B3", "B4", "B4_sort", "B5", "B6")


# ---------------------------------------------------------------- costs

def _b1(rows, features, num_trees, plane_entries, bitset_words, leaves,
        visits, num_class=1, emit_scores=False):
    # X, the plane entries, bitset words and (scores) leaf values this
    # input needs, and the output, each once
    entries = (sum(plane_entries.values())
               if isinstance(plane_entries, dict) else int(plane_entries))
    nbytes = rows * features * 4 + entries * 4 + bitset_words * 4
    ops = visits * OPS_PER_VISIT
    if emit_scores:
        nbytes += leaves * 4 + max(num_class, 1) * rows * 4
        ops += num_trees * rows
    else:
        nbytes += num_trees * rows * 4
    return nbytes, ops


def _b3(rows, columns, groups, steps_per_row, out_bytes=1):
    # the columns B3 reads once, the bins once; a descent of the bounds
    # a (row, member) and its steps
    return (4 * rows * columns + rows * groups * out_bytes,
            rows * steps_per_row)


def _b4(rows, features, bins, slots, slotted_rows, quant=False,
        bin_bytes=1):
    # each slot read once, the slotted rows' bins and values once, the
    # [K, C, F, B] sums written once; one add a (row, feature, channel)
    C, val_bytes, cell = (2, 2, 4) if quant else (3, 12, 8)
    m = slotted_rows
    return (4 * rows + m * (features * bin_bytes + val_bytes)
            + slots * C * features * bins * cell, C * m * features)


def _b4_sort(rows, slots, slotted_rows, quant=False):
    # the slots read and the order written; the per-slot offsets; the
    # slotted rows' values read and written in sorted order
    C, in_b, out_b = (2, 1, 1) if quant else (3, 4, 8)
    return (8 * rows + 8 * (slots + 1)
            + slotted_rows * C * (in_b + out_b), rows)


def _b5(children, features, bins=0, cells=None, walked=None, quant=False,
        leaf_mode=False, feature_meta=3, plan_entries=0, monotone=False,
        bounds=False, rand_thr=False):
    # histograms: parent mode reads the K smaller children's and the K
    # parents' cells (the siblings are derived), leaf mode the children's;
    # the children's sums, the smaller-child flags (parent mode), the
    # per-feature meta, the plan's lane entries and the mode's inputs;
    # the six [NC, F] tuples written; the gain arithmetic of every walked
    # bin
    C, cell = (2, 4) if quant else (3, 8)
    cells = features * bins if cells is None else cells
    walked = cells if walked is None else walked
    K = children // 2
    read = (children if leaf_mode else 2 * K) * C * cells * cell
    meta = (3 * children * 4 + (0 if leaf_mode else K * 4)
            + feature_meta * features * 4 + plan_entries * 4)
    if monotone:
        meta += features * 4
    if bounds:
        meta += 2 * children * 4
    if rand_thr:
        meta += children * features * 4
    per_cell = ((MONO_OPS_PER_CELL if monotone else SCAN_OPS_PER_CELL)
                + (QUANT_COUNT_OPS_PER_CELL if quant else 0))
    return (read + meta + children * features * 4 * 6,
            children * walked * per_cell)


def _b2(rows, features, bins, slots, slotted_rows, quant=False,
        bin_bytes=1, plan_entries=0):
    # B4 then B5 in one call: the smaller children's sums B4 writes are
    # not read back from memory
    ab, ao = _b4(rows, features, bins, slots, slotted_rows, quant,
                 bin_bytes)
    sb, so = _b5(2 * slots, features, bins, quant=quant,
                 plan_entries=plan_entries)
    C, cell = (2, 4) if quant else (3, 8)
    return ab + sb - slots * C * features * bins * cell, ao + so


def _b6(rows, features, bins, bin_bytes=1):
    # the binned matrix and the [3, n] values once, the [3, F, B] int64
    # sums once; one add a (row, feature, channel)
    return (bin_bytes * features * rows + 12 * rows
            + 3 * features * bins * 8, 3 * rows * features)


_COSTS = {"B1": _b1, "B2": _b2, "B3": _b3, "B4": _b4, "B4_sort": _b4_sort,
          "B5": _b5, "B6": _b6}


def kernel_cost(kernel: str, **shape) -> dict:
    """{"bytes", "ops"} of one call of ``kernel`` (``KERNELS``) at
    ``shape``: the bytes the function must move, each input read once and
    each output written once, and its f32 operations.  The shapes:

    - ``B1``: rows, features, num_trees, plane_entries (a count, or
      ``traverse_reads``' dict), bitset_words, leaves, visits,
      num_class, emit_scores;
    - ``B2``: rows, features, bins, slots, slotted_rows, quant,
      bin_bytes, plan_entries;
    - ``B3``: rows, columns (read), groups, steps_per_row, out_bytes;
    - ``B4``: rows, features, bins, slots, slotted_rows, quant,
      bin_bytes; ``B4_sort``: rows, slots, slotted_rows, quant;
    - ``B5``: children, features, bins (or cells a child and channel;
      walked bins), quant, leaf_mode, feature_meta (per-feature int32
      vectors), plan_entries, monotone, bounds, rand_thr;
    - ``B6``: rows, features, bins, bin_bytes."""
    if kernel not in _COSTS:
        raise KeyError(f"unknown kernel {kernel!r}; known: {KERNELS}")
    nbytes, ops = _COSTS[kernel](**shape)
    return {"bytes": int(nbytes), "ops": int(ops)}


def roofline(nbytes: float, ops: float) -> dict:
    """The least time of a call in ms on the H100 SXM: the larger of
    bytes over its memory rate and operations over its f32 rate, and
    which of the two it is."""
    t_bytes = nbytes / H100_SXM_HBM_BYTES_PER_S * 1e3
    t_ops = ops / H100_SXM_F32_FLOPS * 1e3
    return {"bytes": nbytes, "ops": ops, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def ingest_steps_per_row(groups: int, bound_width: int) -> int:
    """B3's steps a row where every group's bounds row is ``bound_width``
    wide: a binary descent of ceil(log2(width + 1)) steps and 4 more a
    group."""
    return groups * (int(math.ceil(math.log2(bound_width + 1))) + 4)


def grouped_scan_cells(feat_group, feat_start, num_bin, bins: int,
                       group_bins: int) -> int:
    """Cells of one child's channel that B5 in grouped leaf mode must
    read, each once: group 0's ``group_bins`` bins (the child's totals)
    and each feature's bins 1 .. min(num_bin, bins) - 1 at their merged
    places (``feat_start[f] + b - 1`` of column ``feat_group[f]``)."""
    import numpy as np
    fg, fs, nb = (np.asarray(v.cpu() if hasattr(v, "cpu") else v)
                  .astype(np.int64) for v in (feat_group, feat_start,
                                              num_bin))
    reps = np.maximum(np.minimum(nb, bins) - 1, 0)
    f = np.repeat(np.arange(len(nb)), reps)
    b = 1 + np.arange(int(reps.sum())) - np.repeat(np.cumsum(reps) - reps,
                                                   reps)
    return len(np.union1d(np.arange(group_bins),
                          fg[f] * group_bins + fs[f] + b - 1))


# node planes B1 reads (``predict_kernels.kernel_args``' names)
PLANES = ("sf", "thr", "left", "right", "mt", "dl", "ic", "co", "cn")


def traverse_reads(dev, X) -> dict:
    """What B1 must read for the rows ``X`` of ``dev`` (a
    ``DeviceForest``), each item once: per plane, the (tree, node)
    entries some row's decision needs (``plane_entries``); the bitset
    words some categorical decision tests; the (tree, leaf) values
    reached; and the (tree, row, level) visits.  A decision reads ``sf``
    (and ``ic`` where the forest has categories); a numerical one reads
    ``mt``, then ``dl`` if the value is missing or ``thr`` if not; a
    categorical one reads ``cn``, ``co`` and, for a value inside the
    bitset, one word; every decision reads the child it takes."""
    import torch

    from ..ops import predict_kernels as pk
    p = pk.kernel_args(dev)
    has_cat = dev.forest.has_cat
    T, I = dev.split_feature.shape
    n = X.shape[0]
    need = {k: torch.zeros((T, I), dtype=torch.bool, device=X.device)
            for k in PLANES}
    word_need = torch.zeros(dev.cat_words.numel(), dtype=torch.bool,
                            device=X.device)
    node = torch.zeros((T, n), dtype=torch.int32, device=X.device)
    tid = torch.arange(T, device=X.device)[:, None].expand_as(node)
    rid = torch.arange(n, device=X.device)[None, :].expand_as(node)
    visits = 0
    for _ in range(max(int(dev.forest.max_depth), 1)):
        live = node >= 0
        if not bool(live.any()):
            break
        visits += int(live.sum())
        t, nd, r = tid[live], node[live].long(), rid[live]
        v = X[r, p["sf"][t, nd].long()]
        m = p["mt"][t, nd]
        nan = torch.isnan(v)
        fz = torch.where(nan & (m != 2), torch.zeros_like(v), v)
        missing = ((m == 1) & (fz.abs() <= pk.K_ZERO_F32)) | ((m == 2) & nan)
        cat = (p["ic"][t, nd] != 0) if has_cat else torch.zeros_like(nan)
        num = ~cat
        need["sf"][t, nd] = True
        if has_cat:
            need["ic"][t, nd] = True
        need["mt"][t[num], nd[num]] = True
        need["dl"][t[num & missing], nd[num & missing]] = True
        need["thr"][t[num & ~missing], nd[num & ~missing]] = True
        if has_cat and bool(cat.any()):
            need["co"][t[cat], nd[cat]] = True
            need["cn"][t[cat], nd[cat]] = True
            iv = torch.where(nan, torch.full_like(v, -1.0), v).trunc()
            iv = iv.clamp(-1.0, pk._CAT_IV_MAX).to(torch.int32)
            nw = p["cn"][t, nd]
            inside = cat & (iv >= 0) & (iv < nw * 32)
            widx = p["co"][t, nd] + torch.minimum(
                iv.clamp_min(0) // 32, (nw - 1).clamp_min(0))
            word_need[widx[inside].long()] = True
        nxt = pk.decide_step(node, X, **pk._planes(dev))
        went_left = nxt[live] == p["left"][t, nd]
        need["left"][t[went_left], nd[went_left]] = True
        need["right"][t[~went_left], nd[~went_left]] = True
        node = nxt
    leaf_need = torch.zeros(dev.forest.leaf_value.shape, dtype=torch.bool,
                            device=X.device)
    leaf_need[tid, (~node).long()] = True
    return {"rows": int(n), "features": int(X.shape[1]),
            "num_trees": int(T),
            "plane_entries": {k: int(v.sum()) for k, v in need.items()},
            "bitset_words": int(word_need.sum()),
            "leaves": int(leaf_need.sum()), "visits": int(visits)}


def traverse_cost(dev, X, num_class: int = 1,
                  emit_scores: bool = False) -> dict:
    """``kernel_cost("B1")`` of ``dev`` on the rows ``X`` (what
    ``traverse_reads`` counts), with the plane entries and bitset words
    beside it."""
    r = traverse_reads(dev, X)
    return {**kernel_cost("B1", num_class=num_class,
                          emit_scores=emit_scores, **r),
            "plane_entries": r["plane_entries"],
            "bitset_words": r["bitset_words"]}


# ---------------------------------------------------------------- peaks

def _device_kind(device=None) -> str:
    import torch
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        return ""
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    return torch.cuda.get_device_name(idx).lower()


def _peak(table: dict, device) -> Optional[float]:
    kind = _device_kind(device)
    for key, val in table.items():
        if kind and key in kind:
            return val
    return None


def peak_flops_for(device=None) -> Optional[float]:
    """The card's published f32 FLOP/s, or None (unknown card, CPU)."""
    return _peak(PEAK_F32_FLOPS, device)


def peak_hbm_bw_for(device=None) -> Optional[float]:
    """The card's published memory bytes/s, or None (unknown card, CPU)."""
    return _peak(PEAK_HBM_BW, device)


# ---------------------------------------------------------------- timing

def _device_of(args, device):
    import torch
    if device is not None:
        return torch.device(device)
    for a in args:
        if isinstance(a, torch.Tensor):
            return a.device
    return torch.device("cpu")


def measure_program(fn: Callable, args: tuple = (), reps: int = 3,
                    cost: Optional[dict] = None, device=None) -> dict:
    """Time ``fn(*args)`` over ``reps`` calls after a warm one and report
    its utilization::

        {"seconds_per_call",
         "flops", "bytes_accessed", "hbm_gbps",    # where ``cost`` is given
         "peak_flops", "peak_hbm_bw",              # where the card is known
         "mfu", "hbm_util"}                        # where both are

    ``cost`` is ``kernel_cost``'s dict.  On the card (``device``, else the
    first tensor argument's) the calls are timed by CUDA events on the
    current stream; elsewhere by the host clock."""
    import torch
    dev = _device_of(args, device)
    out = {}
    if cost:
        out["flops"] = float(cost["ops"])
        out["bytes_accessed"] = float(cost["bytes"])
    reps = max(int(reps), 1)
    fn(*args)                             # warm outside the clock
    if dev.type == "cuda":
        with torch.cuda.device(dev):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            start.record()
            for _ in range(reps):
                fn(*args)
            end.record()
            end.synchronize()
            sec = start.elapsed_time(end) / 1e3 / reps
    else:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn(*args)
        sec = (time.perf_counter() - t0) / reps
    out["seconds_per_call"] = sec
    if "bytes_accessed" in out and sec > 0:
        out["hbm_gbps"] = out["bytes_accessed"] / sec / 1e9
    pf, pb = peak_flops_for(dev), peak_hbm_bw_for(dev)
    if pf is not None:
        out["peak_flops"] = pf
        if "flops" in out and sec > 0:
            out["mfu"] = out["flops"] / sec / pf
    if pb is not None:
        out["peak_hbm_bw"] = pb
        if "bytes_accessed" in out and sec > 0:
            out["hbm_util"] = out["bytes_accessed"] / sec / pb
    return out


@contextmanager
def profiler_trace(logdir: str):
    """Record the block with ``torch.profiler`` (CPU activity, and CUDA
    where the card is there) and write its Chrome trace as
    ``<logdir>/trace.json``; yields the profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def _row(fn, reps, cost, dev, kernel: str) -> dict:
    r = measure_program(fn, (), reps=reps, cost=cost, device=dev)
    r["kernel"] = kernel
    r["route"] = "cuda" if dev.type == "cuda" else "plain"
    return r


def _publish_best(table: dict) -> None:
    """The best row's ``mfu`` as the ``mfu_measured_best`` gauge (the pod
    vector's and the doctor's MFU), where a row has one."""
    best = max((v["mfu"] for v in table.values()
                if isinstance(v, dict) and "mfu" in v), default=None)
    if best is not None:
        from .metrics import global_registry
        g = global_registry.gauge("mfu_measured_best")
        prev = g.value
        g.set(max(best, prev) if isinstance(prev, (int, float)) else best)


# ---------------------------------------------------------------- tables

def histogram_utilization_table(rows: int = 1_000_000, features: int = 28,
                                num_bins: int = 255, slots: int = 128,
                                reps: int = 2, seed: int = 0,
                                quant: bool = True, device=None,
                                slot=None) -> dict:
    """The histogram family's rows (module docstring) at one frontier
    level: ``rows`` x ``features`` uint8 bins below ``num_bins``, K =
    ``slots`` candidates holding about half the rows, gradients from
    ``seed``; each row ``measure_program``'s dict with its kernel, route
    and ``kernel_cost``.  ``slot`` (a ``[rows]`` tensor, ``slots`` for a
    row outside the frontier) is a given frontier in place of the drawn
    one."""
    import numpy as np
    import torch

    from ..basic import resolve_device
    from ..ops import fused as FU
    from ..ops import histogram as H
    from ..ops.split import QuantScales, SplitHyperparams, fixed_to_f32

    dev = resolve_device(device)
    n, F, B, K = int(rows), int(features), int(num_bins), int(slots)
    rng = np.random.RandomState(seed)
    binned = torch.from_numpy(
        rng.randint(0, B, (F, n)).astype(np.uint8)).to(dev)
    grad = torch.from_numpy(rng.randn(n).astype(np.float32)).to(dev)
    hess = grad.abs() + 0.1
    vals = H._vals_t(grad, hess, torch.ones_like(grad)).contiguous()
    scales = H.fixed_point_scales(vals)
    r = torch.from_numpy(rng.rand(n)).to(dev)
    pick = torch.from_numpy(rng.randint(0, K, n).astype(np.int32)).to(dev)
    other = torch.from_numpy(rng.randint(0, K, n).astype(np.int32)).to(dev)
    if slot is None:
        slot = torch.where(r < 0.5, pick, torch.full_like(pick, K))
    else:
        slot = slot.to(device=dev, dtype=torch.int32)
    pslot = torch.where(slot < K, slot, other)
    small_left = torch.from_numpy(rng.rand(K) < 0.5).to(dev)
    m = int((slot < K).sum())
    nb = torch.full((F,), B, dtype=torch.int32, device=dev)
    mty = torch.zeros(F, dtype=torch.int32, device=dev)
    db = torch.zeros(F, dtype=torch.int32, device=dev)
    hp = SplitHyperparams(min_data_in_leaf=1)
    plan = FU.scan_tasks([B] * F, B, dev)

    parent = FU.accumulate(binned, vals, pslot, K, B, scales)
    children = FU.derive_children(
        FU.accumulate(binned, vals, slot, K, B, scales), small_left, parent)
    sums = torch.stack([fixed_to_f32(children[:, c, 0].sum(-1),
                                     [scales[c]], 0) for c in range(3)])
    shape4 = dict(rows=n, features=F, bins=B, slots=K, slotted_rows=m)

    out = {"rows": n, "features": F, "num_bins": B, "slots": K,
           "slotted_rows": m}
    out["f32/pallas"] = _row(
        lambda: H.histogram_fixed(binned, vals, B, scales), reps,
        kernel_cost("B6", rows=n, features=F, bins=B), dev, "B6")
    out["f32/fused"] = _row(
        lambda: FU.frontier_splits(binned, vals, slot, K, B, scales, sums,
                                   small_left, parent, nb, mty, db, hp,
                                   plan=plan), reps,
        kernel_cost("B2", **shape4), dev, "B2")
    out["f32/fused_sharded_flat"] = _row(
        lambda: FU.sibling_scan(
            FU.accumulate(binned, vals, slot, K, B, scales), scales, sums,
            nb, mty, db, hp, small_left=small_left, parent=parent,
            plan=plan), reps,
        _sum_costs(kernel_cost("B4", **shape4),
                   kernel_cost("B5", children=2 * K, features=F,
                               bins=B)), dev, "B4+B5")
    if quant:
        gq = torch.from_numpy(
            rng.randint(-8, 8, n).astype(np.int8)).to(dev)
        hq = torch.from_numpy(rng.randint(0, 8, n).astype(np.int8)).to(dev)
        vq = H._vals_t_int(gq, hq, torch.ones(n, dtype=torch.bool,
                                              device=dev)).contiguous()
        qs = QuantScales(0.25, 0.5)
        parent_q = FU.accumulate(binned, vq, pslot, K, B)
        tot = FU.derive_children(FU.accumulate(binned, vq, slot, K, B),
                                 small_left, parent_q)[:, :, 0]
        tot = tot.to(torch.int64).sum(-1).to(torch.float32)
        n_par = torch.bincount(pslot, minlength=K)
        n_small = torch.bincount(slot[slot < K], minlength=K)
        n_left = torch.where(small_left, n_small, n_par - n_small)
        sums_q = torch.stack([tot[:, 0] * qs.g, tot[:, 1] * qs.h,
                              torch.cat([n_left, n_par - n_left]).float()])
        slot0 = torch.zeros(n, dtype=torch.int32, device=dev)
        out["quant/pallas"] = _row(
            lambda: FU.accumulate(binned, vq, slot0, 1, B), reps,
            kernel_cost("B4", rows=n, features=F, bins=B, slots=1,
                        slotted_rows=n, quant=True), dev, "B4")
        out["quant/fused"] = _row(
            lambda: FU.frontier_splits(binned, vq, slot, K, B, qs, sums_q,
                                       small_left, parent_q, nb, mty, db,
                                       hp, plan=plan), reps,
            kernel_cost("B2", quant=True, **shape4), dev,
            "B2")
        out["quant/fused_sharded_flat"] = _row(
            lambda: FU.sibling_scan(
                FU.accumulate(binned, vq, slot, K, B), qs, sums_q, nb, mty,
                db, hp, small_left=small_left, parent=parent_q, plan=plan),
            reps,
            _sum_costs(kernel_cost("B4", quant=True, **shape4),
                       kernel_cost("B5", children=2 * K, features=F,
                                   bins=B, quant=True)),
            dev, "B4+B5")
    _publish_best(out)
    return out


def _sum_costs(a: dict, b: dict) -> dict:
    return {"bytes": a["bytes"] + b["bytes"], "ops": a["ops"] + b["ops"]}


def predict_utilization_table(device_forest, rows: int = 65_536,
                              reps: int = 2, num_class: int = 1,
                              seed: int = 0, X=None) -> dict:
    """The predict family's rows: ``fused`` (B1's leaves mode) and, where
    the forest has leaf values and its trees divide by ``num_class``,
    ``fused_scores`` (B1's scores mode), over one ``[rows, F]`` batch
    (``X``, else standard normals from ``seed``) on the forest's
    device; each with ``traverse_cost``."""
    import numpy as np
    import torch

    from ..ops import predict_kernels as PK
    dev = device_forest.device
    f = device_forest.forest
    F = int(np.asarray(f.split_feature).max(initial=0)) + 1
    if X is None:
        rng = np.random.RandomState(seed)
        X = rng.randn(int(rows), F).astype(np.float32)
    X = torch.as_tensor(X, dtype=torch.float32).to(dev)
    K = max(int(num_class), 1)
    variants = {"fused": False}
    if device_forest.leaf_value is not None and int(f.num_trees) % K == 0:
        variants["fused_scores"] = True
    out = {"rows": int(X.shape[0]), "features": int(X.shape[1]),
           "num_trees": int(f.num_trees)}
    for name, scores in variants.items():
        cost = traverse_cost(device_forest, X, K, scores)
        out[name] = _row(
            lambda s=scores: PK.fused_traverse(device_forest, X, K,
                                               emit_scores=s),
            reps, cost, dev, "B1")
        out[name]["plane_entries"] = cost["plane_entries"]
    _publish_best(out)
    return out


def ingest_utilization_table(dataset, raw, reps: int = 2) -> dict:
    """The ingest family's rows over one raw block ``raw`` [n, F] of a
    constructed ``dataset``: ``kernel/t<tile>`` (B3 at its planned
    launch, on the dataset's device, with ``kernel_cost``) and ``host``
    (``Dataset._bin_block``, the host's f64 binning, wall clock), then
    the kernel's speedup over the host and its rows/s."""
    import numpy as np
    import torch

    from ..ops import ingest as ING
    tables = ING.build_ingest_tables(dataset)
    dev = dataset.device
    binner = ING.DeviceBinner(tables, dev)
    X = np.ascontiguousarray(np.asarray(raw), dtype=np.float32)
    n, F = X.shape
    out = {"rows": int(n), "features": int(tables.num_features),
           "num_groups": int(tables.num_groups),
           "out_dtype": str(tables.out_dtype)}
    Xd = torch.from_numpy(X).to(dev)
    out_bytes = 1 if ING.device_dtype(tables) == torch.uint8 else 4
    cost = kernel_cost(
        "B3", rows=n, columns=F, groups=tables.num_groups,
        steps_per_row=ingest_steps_per_row(tables.num_groups,
                                           tables.bounds.shape[1]),
        out_bytes=out_bytes)
    tile = (f"t{binner.kernel_state().plan.tile_rows}"
            if dev.type == "cuda" else "plain")
    out[f"kernel/{tile}"] = _row(lambda: binner(Xd), reps, cost, dev, "B3")
    ref = np.zeros((n, tables.num_groups), tables.out_dtype)
    X64 = X.astype(np.float64)
    dataset._bin_block(X64, ref)          # warm the caches
    t0 = time.perf_counter()
    for _ in range(max(reps, 1)):
        dataset._bin_block(X64, ref)
    sec = (time.perf_counter() - t0) / max(reps, 1)
    out["host"] = {"seconds_per_call": sec, "route": "host"}
    best = min((v["seconds_per_call"] for k, v in out.items()
                if k.startswith("kernel/")), default=None)
    if best:
        out["best_kernel_seconds_per_call"] = best
        out["kernel_speedup_vs_host"] = round(sec / max(best, 1e-12), 3)
        out["bin_rows_per_sec"] = round(n / max(best, 1e-12), 1)
    _publish_best(out)
    return out
