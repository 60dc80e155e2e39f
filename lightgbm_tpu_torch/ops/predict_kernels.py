"""Inference traversal: the hand-written CUDA kernel and its plain
PyTorch version (counterpart of ``lightgbm_tpu/ops/predict_kernels.py``).

``decide_step`` is one depth step of the ``[T', nc]`` node chase, written
once in torch.  ``leaves_while`` (a data-dependent trip count) and
``leaves_fori`` (exactly ``max_depth`` trips) iterate it; together with
``pinned_leaf_sum`` they are the plain version of the kernel.

``fused_traverse`` is the kernel's wrapper.  For a CUDA tensor it
launches ``csrc/traverse.cu`` (built by ``_build``) or raises; for a CPU
tensor it runs the plain version.  ``launch_counts["fused_traverse"]``
counts the kernel's launches, so a run can show that its main path went
through the kernel.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np
import torch

from . import planner

# kZeroThreshold (feature_group.h) as the f32 the kernel compares with;
# exactly representable, so the compare is the same in f32 or f64
K_ZERO_F32 = float(np.float32(1e-35))
# largest f32 below 2**31: the categorical value is clamped to
# [-1, _CAT_IV_MAX] before the int32 cast (torch's cast of an
# out-of-range float is undefined on the CPU; XLA saturates, and any
# value past the bitset is invalid either way)
_CAT_IV_MAX = 2147483520.0

_counts_lock = threading.Lock()
launch_counts = {"fused_traverse": 0}


def reset_launch_counts() -> None:
    with _counts_lock:
        for k in launch_counts:
            launch_counts[k] = 0


# ----------------------------------------------------------------------
# the plain version
# ----------------------------------------------------------------------

def decide_step(node, Xc, sf, thr, left, right, mt, dl, has_cat,
                ic=None, co=None, cn=None, cw=None):
    """One depth step of the [T', nc] node chase.

    ``node`` < 0 marks a frozen row (two's-complement leaf id); frozen
    entries come back untouched, so the step is idempotent and any trip
    count >= the true depth is exact.  Planes are [T', I] int32 (``thr``
    f32); ``cw`` holds the u32 bitset words as int32 bit patterns.
    """
    T, nc = node.shape
    dev = node.device
    tid2 = torch.arange(T, device=dev)[:, None]
    rows = torch.arange(nc, device=dev)[None, :]
    nd = node.clamp_min(0).long()
    fval = Xc[rows, sf[tid2, nd].long()]
    th = thr[tid2, nd]
    m = mt[tid2, nd]
    nan = torch.isnan(fval)
    fz = torch.where(nan & (m != 2), torch.zeros_like(fval), fval)
    is_missing = ((m == 1) & (fz.abs() <= K_ZERO_F32)) | ((m == 2) & nan)
    gl = torch.where(is_missing, dl[tid2, nd] != 0, fz <= th)
    if has_cat:
        # truncate toward zero (reference static_cast<int> semantics)
        iv = torch.where(nan, torch.full_like(fval, -1.0), fval).trunc()
        iv = iv.clamp(-1.0, _CAT_IV_MAX).to(torch.int32)
        nw = cn[tid2, nd]
        valid = (iv >= 0) & (iv < nw * 32)
        ivc = iv.clamp_min(0)
        widx = co[tid2, nd] + torch.minimum(ivc // 32, (nw - 1).clamp_min(0))
        widx = widx.clamp(0, cw.numel() - 1).long()
        # torch's uint32 support is thin: widen the words to int64 and
        # shift logically there
        word = cw[widx].to(torch.int64) & 0xFFFFFFFF
        inset = (word >> (ivc % 32).to(torch.int64)) & 1
        gl = torch.where(ic[tid2, nd] != 0, valid & (inset == 1), gl)
    nxt = torch.where(gl, left[tid2, nd], right[tid2, nd])
    return torch.where(node < 0, node, nxt)


def full_threshold_f32(dev) -> torch.Tensor:
    """The complete [T, I] f32 threshold plane.  The port serves f32
    thresholds only (bf16/int8 planes come with low-precision serving),
    so this is the stored plane itself."""
    return dev.threshold


def kernel_args(dev) -> dict:
    """The kernel's operand planes for ``dev``: int32 routing planes,
    the f32 threshold plane and the bitset words (int32 bit patterns)."""
    return {
        "sf": dev.split_feature, "thr": full_threshold_f32(dev),
        "left": dev.left, "right": dev.right, "mt": dev.missing_type,
        "dl": dev.default_left, "ic": dev.is_cat, "co": dev.cat_offset,
        "cn": dev.cat_nwords, "cw": dev.cat_words,
    }


def _planes(dev) -> dict:
    return dict(kernel_args(dev), has_cat=dev.forest.has_cat)


def leaves_while(dev, Xc: torch.Tensor) -> torch.Tensor:
    """[nc, F] f32 -> leaf index [T, nc], stepping until every row of
    every tree sits on a leaf."""
    planes = _planes(dev)
    node = torch.zeros((dev.num_trees, Xc.shape[0]), dtype=torch.int32,
                       device=Xc.device)
    while bool((node >= 0).any()):
        node = decide_step(node, Xc, **planes)
    return ~node


def leaves_fori(dev, Xc: torch.Tensor) -> torch.Tensor:
    """[nc, F] f32 -> leaf index [T, nc] in exactly ``max_depth`` trips
    (``StackedForest.max_depth`` counts the decisions on the deepest
    root-to-leaf path, so it is exactly sufficient)."""
    planes = _planes(dev)
    node = torch.zeros((dev.num_trees, Xc.shape[0]), dtype=torch.int32,
                       device=Xc.device)
    for _ in range(max(int(dev.forest.max_depth), 1)):
        node = decide_step(node, Xc, **planes)
    return ~node


def pinned_leaf_sum(leaf_value: torch.Tensor, leaves: torch.Tensor,
                    num_class: int) -> torch.Tensor:
    """[T, n] leaf ids -> [K, n] f32 raw scores, added one iteration at a
    time in tree order (tree t into class t % K) with plain adds — the
    kernel's and the JAX package's pinned order, bit-stable run to run
    (a ``sum`` may re-associate)."""
    K = max(num_class, 1)
    T, n = leaves.shape
    tid2 = torch.arange(T, device=leaves.device)[:, None]
    lv3 = leaf_value[tid2, leaves.long()].reshape(T // K, K, n)
    acc = torch.zeros((K, n), dtype=torch.float32, device=leaves.device)
    for i in range(T // K):
        acc = acc + lv3[i]
    return acc


def traverse_plain(dev, X: torch.Tensor, num_class: int = 1,
                   emit_scores: bool = False) -> torch.Tensor:
    """The kernel's function in plain torch, on X's device: leaf ids
    [T, n] int32, or raw scores [K, n] f32 when ``emit_scores``."""
    leaves = leaves_fori(dev, X)
    if not emit_scores:
        return leaves
    return pinned_leaf_sum(dev.leaf_value, leaves, num_class)


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
            lib = _build.load("traverse")
            p, i = ctypes.c_void_p, ctypes.c_int
            lib.traverse_forest.argtypes = [
                p, i, i,                      # X, n, F
                p, p, p, p, p, p, p, p, p,    # sf thr left right mt dl ic co cn
                p, i, i, i, i, i,             # cw, W, T, I, depth, has_cat
                p, i, i, i,                   # leaf_value, L, K, tile_rows
                p, p]                         # out, stream
            lib.traverse_forest.restype = ctypes.c_int
            _lib_handle = lib
        return _lib_handle


def _check(dev, X: torch.Tensor, num_class: int, emit_scores: bool) -> None:
    if not isinstance(X, torch.Tensor):
        raise TypeError("fused_traverse takes a torch.Tensor")
    if X.dtype != torch.float32 or X.dim() != 2:
        raise ValueError(f"X must be a 2-D float32 tensor, got {X.dtype} "
                         f"of shape {tuple(X.shape)}")
    if not X.is_contiguous():
        raise ValueError("X must be contiguous")
    if X.device != dev.device:
        raise ValueError(f"X is on {X.device}, the forest on {dev.device}")
    if X.shape[1] < dev.num_features:
        raise ValueError(f"X has {X.shape[1]} features, the forest splits "
                         f"on feature {dev.num_features - 1}")
    if emit_scores:
        K = max(num_class, 1)
        if dev.num_trees % K:
            raise ValueError(f"{dev.num_trees} trees are not whole "
                             f"iterations of {K} classes")


def fused_traverse(dev, X: torch.Tensor, num_class: int = 1,
                   emit_scores: bool = False) -> torch.Tensor:
    """Traverse every tree of ``dev`` (a ``DeviceForest``) for the rows of
    ``X`` [n, F] f32: leaf ids [T, n] int32, or raw scores [K, n] f32 in
    the pinned order when ``emit_scores``.

    A CUDA tensor launches the kernel on the current stream (or raises);
    a CPU tensor runs ``traverse_plain``."""
    _check(dev, X, num_class, emit_scores)
    if X.device.type == "cpu":
        return traverse_plain(dev, X, num_class, emit_scores)
    if X.device.type != "cuda":
        raise ValueError(f"no traversal for device {X.device}")
    n, F = X.shape
    T, I = dev.split_feature.shape
    K = max(num_class, 1)
    if emit_scores:
        out = torch.empty((K, n), dtype=torch.float32, device=X.device)
        lv, L = dev.leaf_value, dev.leaf_value.shape[1]
    else:
        out = torch.empty((T, n), dtype=torch.int32, device=X.device)
        lv, L = None, 0
    if n == 0:
        return out
    a = kernel_args(dev)
    lib = _lib()
    with torch.cuda.device(X.device):
        stream = torch.cuda.current_stream(X.device).cuda_stream
        rc = lib.traverse_forest(
            X.data_ptr(), n, F,
            *(a[k].data_ptr() for k in ("sf", "thr", "left", "right", "mt",
                                        "dl", "ic", "co", "cn")),
            a["cw"].data_ptr(), a["cw"].numel(), T, I,
            max(int(dev.forest.max_depth), 1), int(dev.forest.has_cat),
            None if lv is None else lv.data_ptr(), L, K,
            planner.tile_rows_for(F), out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"traverse kernel launch failed: CUDA error {rc}")
    with _counts_lock:
        launch_counts["fused_traverse"] += 1
    return out
