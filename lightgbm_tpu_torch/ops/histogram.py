"""Histograms (counterpart of ``lightgbm_tpu/ops/histogram.py``).

The port accumulates histograms in exact fixed point: channel ``c`` of
a row's value block enters as ``round(v * 2**s_c)`` in int64, with one
power-of-two scale per channel and per tree (``fixed_point_scales``).
Integer sums are associative, so the CUDA kernels (``csrc/histogram.cu``,
``csrc/fused.cu``) and the plain versions here give the same bits in any
order.

The staged family:

- ``histogram_pallas`` is kernel B6's wrapper (``csrc/histogram.cu``),
  the whole-dataset histogram of the staged arm's root: for a CUDA
  tensor it launches the kernel (or raises) and counts the launch in
  ``launch_counts``; for a CPU tensor it runs ``histogram_plain``, a
  single-slot int64 ``index_add_`` that shares ``accumulate_plain``'s
  body.  It returns [3, F, B] f32 like the JAX function;
  ``histogram_fixed`` returns the int64 sums the grower caches.
- ``histogram_scatter`` is the plain counterpart of the JAX package's
  XLA scatter (f32 adds in row order); tests and CPU only.
- ``build_histogram(..., method=)`` takes every name the JAX package
  takes (``auto``, ``matmul``, ``matmul_f32``, ``scatter``, ``pallas``,
  ``fused``).  Those names choose TPU layouts (the MXU one-hot matmul
  against the XLA scatter) and have no Hopper meaning: every one runs
  ``histogram_pallas``, so on the card every one launches B6.  The JAX
  package's timing probe ``measured_best_method`` is not ported.
- ``segment_histogram``: per-slot histograms; on the card it is the
  accumulate kernel B4 (``ops/fused.py::accumulate``), which computes
  exactly this function in the same fixed point.
- ``subtract_histogram``: the sibling ``parent - child``, exact on int64
  (and on the int32 histograms of quantized training).

The integer family (quantized-gradient training, ``use_quantized_grad``):

- ``quant_levels``/``quantize_gradients``: each round's gradients and
  hessians, weights folded in, as int8 levels with one f32 scale per
  channel; stochastic rounding draws from the port's threefry
  (``utils/threefry.py``), bit-equal to the JAX package's draws;
- ``_vals_t_int``: the [2, n] int8 value block (no count row: counts
  are estimated from the hessian channel at split time,
  ``ops.split.quant_count_hist``);
- ``build_histogram_int`` / ``segment_histogram_int``: [2, F, B] and
  [S, 2, F, B] int32 sums of the levels.  On the card both are the
  accumulate kernel B4 in its int8 mode (``ops/fused.py::accumulate``;
  one slot for ``build_histogram_int``); the plain version is an exact
  int64 ``index_add_`` cast to int32.  A sum of n levels of magnitude at
  most 63 (``num_grad_quant_bins`` <= 64) fits int32 up to
  ``INT32_SAFE_ROWS`` rows, and the accumulate wrapper raises above it.

Not ported: ``compacted_segment_histogram`` and ``capacity_schedule``
(TPU static-shape bucketing; the card launches on unpadded rows), and
the TPU layout work (``histogram_matmul*``, ``segment_histogram_sorted*``,
``pack_cols_u32*``, ``take_from_table``), with their integer twins
(``histogram_matmul_int``, ``histogram_scatter_int``, the packed,
sorted and compacted ``*_int`` variants).

Sharded training (``parallel/``): ``fixed_point_scales`` and
``quantize_gradients`` take the process group or mesh whose ranks'
histograms are summed (the whole two-tier mesh, the 2-D mesh's data
axis), so that every rank scales by their peak (and, in fixed point,
their row count: otherwise the ranks' int64 sums would not add);
``hist_payload_bytes`` counts what one histogram sum moves, and
``ops.planner.plan_collectives`` plans the tiers with it.  Quantized
level histograms are summed as int32 (``parallel.collectives.
psum_tiered``, exact in any order and route).  The JAX package narrows
that sum to int16 where ``rows * hess_levels < 2**15``; neither NCCL nor
gloo reduces int16, and the bound holds only below ~11,000 rows at the
default 4 bins, so the port has no narrow wire (ROADMAP A9: it waits
for a backend with int16 sums).
"""

from __future__ import annotations

import ctypes
import functools
import math
import threading
from typing import Optional, Tuple

import torch

from . import _build, planner

# every sum of up to n scaled values stays below 2**62 in magnitude
FIXED_POINT_BITS = 62
# the largest quantization level (num_grad_quant_bins <= 64) and the rows
# whose sums of such levels fit int32 (the JAX package's bound, ~34 M)
QUANT_MAX_LEVEL = 63
INT32_SAFE_ROWS = (2 ** 31 - 1) // QUANT_MAX_LEVEL


def _vals_t(grad: torch.Tensor, hess: torch.Tensor,
            mask: torch.Tensor) -> torch.Tensor:
    """[3, n] f32 value block (g, h, 1) * mask."""
    return torch.stack([grad, hess, torch.ones_like(grad)]) * mask[None, :]


def fixed_point_scales(vals_t: torch.Tensor, group=None,
                       rows: Optional[int] = None) -> Tuple[int, int, int]:
    """Per-channel power-of-two scales ``s_c = 62 - ceil(log2(max_i
    |v_c,i| * n + 1))``: any sum of at most n scaled values fits in
    int64, and rounding a value to an integer at that scale costs at
    most 2**-(s_c + 1) (dyadic values like k/8 convert exactly).  Under
    a process ``group`` the peak is the max over the ranks and ``rows``
    the rows over every rank, so that every rank scales alike."""
    from ..parallel.collectives import pmax_tiered
    n = max(int(vals_t.shape[1] if rows is None else rows), 1)
    peak = (vals_t.abs().amax(dim=1) if vals_t.shape[1]
            else vals_t.new_zeros(vals_t.shape[0]))
    peak = pmax_tiered(peak.to(torch.float64), group)
    return tuple(_scale_for(m * n) for m in peak.cpu().tolist())


def _scale_for(bound: float) -> int:
    if not math.isfinite(bound):
        raise ValueError("gradients or hessians are not finite")
    return FIXED_POINT_BITS - math.ceil(math.log2(bound + 1.0))


def hist_scales(*hists: torch.Tensor) -> Tuple[int, int, int]:
    """Scales for converting given f32 histograms [..., 3, F, B] to
    fixed point: prefix sums over B bins of a sibling (|parent| +
    |small| per cell) must stay below 2**62."""
    B = int(hists[0].shape[-1])
    peak = torch.stack([h.abs().transpose(0, -3).reshape(3, -1).amax(1)
                        for h in hists]).amax(0)
    return tuple(_scale_for(m * 2 * B)
                 for m in peak.to(torch.float64).cpu().tolist())


def pow2(e: torch.Tensor) -> torch.Tensor:
    """``2**e`` in f64 for integer exponents ``e`` in [-1022, 1023],
    exactly: each f64 is built from its bits, on ``e``'s device."""
    return torch.bitwise_left_shift(e.to(torch.int64) + 1023, 52).view(
        torch.float64)


def exponent_tensor(scales, device) -> torch.Tensor:
    """Fixed-point exponents as the kernels read them: int32 [C] on
    ``device``, from a tensor (no host read) or a sequence of ints (copied
    to the device once a distinct sequence, ``host_constant``, so a
    launch captured into a CUDA graph after a first call copies
    nothing)."""
    if isinstance(scales, torch.Tensor):
        return scales.to(device=device, dtype=torch.int32).contiguous()
    return host_constant(tuple(int(s) for s in scales), "int32",
                         str(torch.device(device)))


@functools.lru_cache(maxsize=64)
def host_constant(values: tuple, dtype: str, device: str) -> torch.Tensor:
    """A small host constant as a tensor on ``device``, kept (callers do
    not write to it)."""
    return torch.tensor(values, dtype=getattr(torch, dtype), device=device)


def to_fixed(x: torch.Tensor, scales, channel_dim: int) -> torch.Tensor:
    """f32 values -> int64 ``round_half_even(x * 2**s_c)`` (the f64
    product is exact; the kernel's ``llrint(ldexp((double)v, s))``).
    ``scales``: the exponents, ints or an int tensor on any device."""
    mul = pow2(exponent_tensor(scales, x.device))
    shape = [1] * x.dim()
    shape[channel_dim] = mul.numel()
    return torch.round(x.to(torch.float64) * mul.view(shape)).to(torch.int64)


def accumulate_plain(binned_t: torch.Tensor, vals_t: torch.Tensor,
                     slot: torch.Tensor, num_slots: int, num_bins: int,
                     scales=None) -> torch.Tensor:
    """The accumulate kernel's function in plain torch: per (slot,
    channel, feature, bin) int64 sums of the fixed-point values of the
    rows with ``slot`` in [0, num_slots) (``slot == num_slots`` drops a
    row).  ``binned_t`` [F, n] uint8/int32; returns [K, 3, F, B].  An
    int8 ``vals_t`` [2, n] (quantized levels, ``scales`` unused) gives
    the int32 sums [K, 2, F, B] of the levels."""
    F, n = binned_t.shape
    K, B = int(num_slots), int(num_bins)
    quant = vals_t.dtype == torch.int8
    C = 2 if quant else 3
    out = torch.zeros(K * C * F * B, dtype=torch.int64,
                      device=binned_t.device)
    if K and n:
        # every row adds: a dropped one (its slot, or a bin past B) adds
        # 0 to a cell in range, so the shapes are fixed and nothing is
        # read on the host
        q = (vals_t.to(torch.int64) if quant
             else to_fixed(vals_t, scales, 0))               # [C, n]
        s = slot.to(torch.int64)
        keep = (s >= 0) & (s < K)
        s = torch.where(keep, s, 0)
        zero = torch.zeros_like(q[0])
        for f in range(F):
            b = binned_t[f].to(torch.int64)
            ok = keep & (b < B)                             # one-hot drops
            base = (s * C * F + f) * B + b.clamp(max=B - 1)
            for c in range(C):
                out.index_add_(0, base + c * F * B,
                               torch.where(ok, q[c], zero))
    out = out.view(K, C, F, B)
    return out.to(torch.int32) if quant else out


# ----------------------------------------------------------------------
# the staged family: kernel B6 and the functions around it
# ----------------------------------------------------------------------

HIST_METHODS = ("auto", "matmul", "matmul_f32", "scatter", "pallas", "fused")

_counts_lock = threading.Lock()
launch_counts = {"histogram_pallas": 0}
_thread = threading.local()


def thread_launch_counts() -> dict:
    """The calling thread's B6 launches (one rank's, when ranks train in
    threads of one process)."""
    d = getattr(_thread, "counts", None)
    if d is None:
        d = _thread.counts = {k: 0 for k in launch_counts}
    return d


def _count(name: str) -> None:
    mine = thread_launch_counts()
    with _counts_lock:
        launch_counts[name] += 1
        mine[name] += 1


def reset_launch_counts() -> None:
    with _counts_lock:
        for k in launch_counts:
            launch_counts[k] = 0
    for k in thread_launch_counts():
        thread_launch_counts()[k] = 0


def histogram_plain(binned_t: torch.Tensor, vals_t: torch.Tensor,
                    num_bins: int, scales) -> torch.Tensor:
    """B6's function in plain torch: [3, F, B] int64 sums of the
    fixed-point values of every row (one slot holding all rows)."""
    slot = torch.zeros(binned_t.shape[1], dtype=torch.int32,
                       device=binned_t.device)
    return accumulate_plain(binned_t, vals_t, slot, 1, num_bins, scales)[0]


_lib_lock = threading.Lock()
_lib_handle = None


def _lib():
    global _lib_handle
    with _lib_lock:
        if _lib_handle is None:
            lib = _build.load("histogram")
            p, i = ctypes.c_void_p, ctypes.c_int
            lib.histogram_build.argtypes = [
                p, i, p, i, i, i,          # binned, bytes, vals, n, F, B
                i, i, i, p, i, i, i, p]    # s0-2, out, chunks, ft, threads,
            lib.histogram_build.restype = ctypes.c_int   # stream
            lib.histogram_prepare.argtypes = []
            lib.histogram_prepare.restype = ctypes.c_int
            _lib_handle = lib
    _build.prepare("histogram", _lib_handle)    # once a device
    return _lib_handle


def _histogram_cuda(binned_t, vals_t, num_bins, scales):
    F, n = binned_t.shape
    B = int(num_bins)
    out = torch.zeros((3, F, B), dtype=torch.int64, device=binned_t.device)
    if n == 0 or F == 0:
        return out
    ft = planner.hist_feat_tile(F, B)
    chunks = planner.hist_row_chunks(n, F, ft)
    with torch.cuda.device(binned_t.device):
        lib = _lib()
        rc = lib.histogram_build(
            binned_t.data_ptr(), binned_t.element_size(), vals_t.data_ptr(),
            n, F, B, *scales, out.data_ptr(), chunks, ft,
            planner.HIST_THREADS,
            torch.cuda.current_stream(binned_t.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"histogram kernel launch failed: CUDA error {rc}")
    _count("histogram_pallas")
    return out


def histogram_fixed(binned_t: torch.Tensor, vals_t: torch.Tensor,
                    num_bins: int, scales) -> torch.Tensor:
    """Kernel B6: [3, F, B] int64 sums of ``round(vals * 2**s)`` per
    (channel, feature, bin) over every row.  ``binned_t`` [F, n]
    uint8/int32, ``vals_t`` [3, n] f32 (already masked), contiguous."""
    kinds = {binned_t.device.type, vals_t.device.type}
    if kinds == {"cpu"}:
        return histogram_plain(binned_t, vals_t, num_bins, scales)
    if kinds != {"cuda"}:
        raise ValueError(f"no histogram kernel for devices {sorted(kinds)}")
    if binned_t.dtype not in (torch.uint8, torch.int32):
        raise ValueError(f"binned matrix must be uint8 or int32, got "
                         f"{binned_t.dtype}")
    if vals_t.dtype != torch.float32 or vals_t.shape != (3, binned_t.shape[1]):
        raise ValueError("vals_t must be [3, n] float32")
    if not (binned_t.is_contiguous() and vals_t.is_contiguous()):
        raise ValueError("the histogram kernel takes contiguous tensors")
    return _histogram_cuda(binned_t, vals_t, num_bins,
                           tuple(int(s) for s in scales))


def histogram_pallas(binned_t: torch.Tensor, vals_t: torch.Tensor,
                     num_bins: int) -> torch.Tensor:
    """[3, F, B] f32 sums of (g, h, w) over the rows (the JAX function's
    interface): B6 at ``fixed_point_scales(vals_t)``, each cell the f32
    of its exact sum."""
    from .split import fixed_to_f32
    scales = fixed_point_scales(vals_t)
    return fixed_to_f32(histogram_fixed(binned_t, vals_t.contiguous(),
                                        num_bins, scales), scales, 0)


def histogram_scatter(binned_t: torch.Tensor, vals_t: torch.Tensor,
                      num_bins: int) -> torch.Tensor:
    """The JAX package's XLA scatter in plain torch: f32 adds of each
    row's (g, h, w) into its bins, rows in ascending order; [3, F, B].
    Tests and CPU only."""
    if binned_t.device.type != "cpu":
        raise ValueError("histogram_scatter is the CPU reference; the card "
                         "runs histogram_pallas")
    F, n = binned_t.shape
    B = int(num_bins)
    flat = (binned_t.to(torch.int64).T
            + torch.arange(F, dtype=torch.int64)[None, :] * B)     # [n, F]
    upd = vals_t.to(torch.float32).T[:, None, :].expand(n, F, 3)
    hist = torch.zeros((F * B, 3), dtype=torch.float32)
    hist.index_add_(0, flat.reshape(-1), upd.reshape(-1, 3))
    return hist.view(F, B, 3).permute(2, 0, 1).contiguous()


def build_histogram(binned_t: torch.Tensor, grad: torch.Tensor,
                    hess: torch.Tensor, mask: torch.Tensor, num_bins: int,
                    method: str = "auto") -> torch.Tensor:
    """Masked histogram [3, F, B] f32 = sums over rows of (g, h, 1) * mask.

    ``method`` takes every name the JAX package takes; each chooses a
    TPU layout there and none has a Hopper meaning, so every one runs
    ``histogram_pallas`` (B6 on the card, its plain version on the
    CPU)."""
    if method not in HIST_METHODS:
        raise ValueError(f"unknown histogram method {method!r}")
    return histogram_pallas(binned_t, _vals_t(grad, hess, mask).contiguous(),
                            num_bins)


def segment_histogram(binned_t: torch.Tensor, grad: torch.Tensor,
                      hess: torch.Tensor, weights: torch.Tensor,
                      slot: torch.Tensor, num_slots: int,
                      num_bins: int) -> torch.Tensor:
    """Per-slot masked histograms [S, 3, F, B] f32: row r adds its
    (g, h, 1) * w to slot[r]'s histogram; ``slot == num_slots`` drops the
    row.  The accumulate kernel B4 (``ops/fused.py::accumulate``) at
    ``fixed_point_scales``, each cell the f32 of its exact sum."""
    from . import fused
    from .split import fixed_to_f32
    vals = _vals_t(grad, hess, weights).contiguous()
    scales = fixed_point_scales(vals)
    hist = fused.accumulate(binned_t, vals, slot.to(torch.int32).contiguous(),
                            num_slots, num_bins, scales)
    return fixed_to_f32(hist, scales, 1)


def subtract_histogram(parent: torch.Tensor,
                       child: torch.Tensor) -> torch.Tensor:
    """The sibling ``parent - child`` (reference: FeatureHistogram::
    Subtract, feature_histogram.hpp:79-84); exact on int64."""
    return parent - child


# ----------------------------------------------------------------------
# the integer family (quantized-gradient training)
# ----------------------------------------------------------------------

def quant_levels(num_bins: int) -> Tuple[int, int]:
    """(grad level bound, hess level bound) for ``num_grad_quant_bins``
    (reference: gradient_discretizer.cpp): gradients take signed levels
    in [-(bins/2 - 1), bins/2 - 1], hessians [0, bins - 1]."""
    return max(num_bins // 2 - 1, 1), max(num_bins - 1, 1)


def quantize_gradients(grad: torch.Tensor, hess: torch.Tensor,
                       weights: torch.Tensor, num_bins: int, key,
                       stochastic: bool = True, group=None,
                       draw_rows: Optional[int] = None):
    """One class's grad/hess as int8 levels (the JAX function's
    arithmetic, f32 throughout).

    Weights are folded in first (``g * w``); each channel's scale is
    ``max(max|g * w|, 1e-30) / level_bound``; stochastic rounding is
    ``floor(x / scale + u)`` with ``u = threefry.uniform(key, (2, n))``
    (row i of channel c takes ``u[c, i]``), otherwise round half to
    even; then clip to the levels.  Returns ``(gq int8 [n], hq int8 [n],
    g_scale, h_scale)``, the scales 0-dim f32 tensors on the device.

    The scales stay device tensors on purpose: PyTorch's CUDA true
    division by a CPU scalar multiplies by its reciprocal, which can
    round differently from a division; dividing by a tensor on the
    card divides.

    Under a process ``group`` (a rank's rows) the peaks are the max over
    the ranks (the JAX function's ``pmax``), and the draws are made at
    ``draw_rows`` rows (the rank's padded block, as the JAX package's
    shard draws them) of which the first n are this rank's; the caller
    folds the rank into ``key``."""
    from ..parallel.collectives import pmax_tiered
    from ..utils import threefry
    qg, qh = quant_levels(num_bins)
    gw = grad * weights
    hw = hess * weights
    dev = gw.device
    lg = torch.tensor(qg, dtype=torch.float32, device=dev)
    lh = torch.tensor(qh, dtype=torch.float32, device=dev)
    peaks = torch.stack([gw.abs().amax(), hw.abs().amax()]) if gw.numel() \
        else torch.zeros(2, dtype=torch.float32, device=dev)
    peaks = pmax_tiered(peaks, group)
    g_scale = torch.clamp_min(peaks[0], 1e-30) / lg
    h_scale = torch.clamp_min(peaks[1], 1e-30) / lh
    if stochastic:
        n = int(gw.shape[0])
        u = threefry.uniform(key, (2, max(n, int(draw_rows or 0))),
                             device=dev)[:, :n]
        gq = torch.floor(gw / g_scale + u[0])
        hq = torch.floor(hw / h_scale + u[1])
    else:
        gq = torch.round(gw / g_scale)
        hq = torch.round(hw / h_scale)
    gq = gq.clamp(-qg, qg).to(torch.int8)
    hq = hq.clamp(0, qh).to(torch.int8)
    return gq, hq, g_scale, h_scale


def _vals_t_int(gq: torch.Tensor, hq: torch.Tensor,
                member: torch.Tensor) -> torch.Tensor:
    """[2, n] int8 value block (g, h) * member: the integer twin of
    ``_vals_t`` (no count row)."""
    return torch.stack([gq, hq]) * member.to(torch.int8)[None, :]


def build_histogram_int(binned_t: torch.Tensor, gq: torch.Tensor,
                        hq: torch.Tensor, member: torch.Tensor,
                        num_bins: int, method: str = "auto",
                        levels=None) -> torch.Tensor:
    """Masked integer histogram [2, F, B] int32: per-bin (sum gq, sum hq)
    over the ``member`` rows.  ``method`` takes the JAX package's names;
    none has a Hopper meaning: on the card this is B4 in int8 mode with
    one slot holding the member rows.  ``levels`` (the JAX package's
    packing hint) is unused."""
    from . import fused
    if method not in HIST_METHODS:
        raise ValueError(f"unknown histogram method {method!r}")
    vals = _vals_t_int(gq, hq, member).contiguous()
    slot = torch.where(member.to(torch.bool), 0, 1).to(torch.int32)
    return fused.accumulate(binned_t, vals, slot, 1, num_bins)[0]


def segment_histogram_int(binned_t: torch.Tensor, gq: torch.Tensor,
                          hq: torch.Tensor, member: torch.Tensor,
                          slot: torch.Tensor, num_slots: int,
                          num_bins: int, levels=None) -> torch.Tensor:
    """Per-slot integer histograms [S, 2, F, B] int32; non-members and
    ``slot == num_slots`` drop the row.  B4 in int8 mode on the card."""
    from . import fused
    vals = _vals_t_int(gq, hq, member).contiguous()
    slot_m = torch.where(member.to(torch.bool), slot.to(torch.int32),
                         int(num_slots)).to(torch.int32).contiguous()
    return fused.accumulate(binned_t, vals, slot_m, num_slots, num_bins)


# ----------------------------------------------------------------------
# sums over a process group (sharded training)
# ----------------------------------------------------------------------

def hist_payload_bytes(num_features: int, num_bins: int,
                       quant: bool = False) -> int:
    """The bytes one [*, F, B] histogram sum moves: the f32 pipeline's
    three int64 fixed-point channels (the JAX package moves three f32
    ones), or the quantized pipeline's two int32 level channels.
    Accounting only, kept next to the dtypes that are summed."""
    return num_features * num_bins * (2 * 4 if quant else 3 * 8)
