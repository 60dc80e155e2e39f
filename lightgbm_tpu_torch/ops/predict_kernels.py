"""Inference traversal: the hand-written CUDA kernel and its plain
PyTorch version (counterpart of ``lightgbm_tpu/ops/predict_kernels.py``).

``decide_step`` is one depth step of the ``[T', nc]`` node chase, written
once in torch.  ``leaves_while`` (a data-dependent trip count) and
``leaves_fori`` (exactly ``max_depth`` trips) iterate it; together with
``pinned_leaf_sum`` they are the plain version of the kernel.

``fused_traverse`` is the kernel's wrapper.  For a CUDA tensor it
launches ``csrc/traverse.cu`` (built by ``_build``) at the launch shape
of ``planner.traverse_plan``, or raises; for a CPU tensor it runs the
plain version.  The kernel reads the forest as packed node records
(``pack_nodes``, built once per ``DeviceForest``); the plain version
reads the unpacked planes.  ``launch_counts["fused_traverse"]`` counts
the kernel's launches (one a call, whose scores mode runs the descents
and then the ordered sum), and ``"fused_traverse[leaves]"`` and
``"fused_traverse[scores]"`` those of each mode, so a run can show that
its main path went through the kernel in the mode it needs.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Tuple

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
launch_counts = {"fused_traverse": 0, "fused_traverse[leaves]": 0,
                 "fused_traverse[scores]": 0}


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
    """The complete [T, I] f32 threshold plane of ``dev``, whatever its
    storage precision: bf16 widens, int8 dequantizes (``q * scale`` of
    its tree, in f32) with the fix-mask keeping the f32 value of the
    nodes that were not quantized (categorical bitset indices, the +inf
    padding).  Elementwise, so every value is the host grid's
    (``fleet.lowprec.int8_rows``) bit for bit."""
    precision = getattr(dev, "precision", "f32")
    if precision == "bf16":
        return dev.threshold.float()
    if precision == "int8":
        thr = dev.threshold.float() * dev.threshold_scale
        return torch.where(dev.threshold_fix_mask, dev.threshold_fix, thr)
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


# the node record's first word: feature | missing type << 28 |
# default left << 30 | categorical << 31 (csrc/traverse.cu)
FEATURE_BITS = 28
_MT_SHIFT, _DL_SHIFT, _CAT_SHIFT = 28, 30, 31


def pack_nodes(dev) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's node records for ``dev``'s planes, on its device:
    ``nodes`` [T, I, 4] int32, a node's (feature | missing type << 28 |
    default left << 30 | categorical << 31, the f32 threshold's bits,
    left, right), and ``cats`` [T, I, 2] int32, a node's (cat_offset,
    cat_nwords) ([1, 1, 2] zeros for a forest without categorical
    splits).  Raises for a feature index that needs more than
    ``FEATURE_BITS`` bits or a missing type outside 0..3."""
    sf = dev.split_feature.to(torch.int64)
    mt = dev.missing_type.to(torch.int64)
    if sf.numel() and (int(sf.min()) < 0
                       or int(sf.max()) >= 1 << FEATURE_BITS):
        raise ValueError(f"split features must lie in [0, 2**{FEATURE_BITS})"
                         f" for the packed node records")
    if mt.numel() and (int(mt.min()) < 0 or int(mt.max()) > 3):
        raise ValueError("missing types must lie in 0..3")
    word = (sf | (mt << _MT_SHIFT)
            | ((dev.default_left != 0).to(torch.int64) << _DL_SHIFT)
            | ((dev.is_cat != 0).to(torch.int64) << _CAT_SHIFT))
    word = torch.where(word >= 1 << 31, word - (1 << 32), word)
    nodes = torch.stack([word.to(torch.int32),
                         full_threshold_f32(dev).view(torch.int32),
                         dev.left, dev.right], dim=-1).contiguous()
    if dev.forest.has_cat:
        cats = torch.stack([dev.cat_offset, dev.cat_nwords],
                           dim=-1).contiguous()
    else:
        cats = torch.zeros((1, 1, 2), dtype=torch.int32, device=sf.device)
    return nodes, cats


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
                p, p, p, i,                   # nodes, cats, cw, W
                i, i, i, i,                   # T, I, depth, has_cat
                p, i, i,                      # leaf_value, L, K
                i, i, i, i, i,                # rows trees row_tiles
                                              # threads stage
                i, i, p, p, p]                # sum_rows sum_trees scratch
                                              # out stream
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
        if dev.leaf_value is None:
            raise ValueError("a routing-only forest has no leaf values to "
                             "sum: traverse it for leaf ids")
        K = max(num_class, 1)
        if dev.num_trees % K:
            raise ValueError(f"{dev.num_trees} trees are not whole "
                             f"iterations of {K} classes")


def fused_traverse(dev, X: torch.Tensor, num_class: int = 1,
                   emit_scores: bool = False, plan=None) -> torch.Tensor:
    """Traverse every tree of ``dev`` (a ``DeviceForest``) for the rows of
    ``X`` [n, F] f32: leaf ids [T, n] int32, or raw scores [K, n] f32 in
    the pinned order when ``emit_scores``.

    A CUDA tensor launches the kernel on the current stream at ``plan``
    (a ``planner.TraversePlan``; None: ``planner.traverse_plan``'s), or
    raises; a CPU tensor runs ``traverse_plain``."""
    _check(dev, X, num_class, emit_scores)
    if plan is not None and plan.scores != emit_scores:
        raise ValueError(f"the plan does not emit "
                         f"{'scores' if emit_scores else 'leaf ids'}")
    if X.device.type == "cpu":
        return traverse_plain(dev, X, num_class, emit_scores)
    if X.device.type != "cuda":
        raise ValueError(f"no traversal for device {X.device}")
    n, F = X.shape
    T, I = dev.split_feature.shape
    K = max(num_class, 1)
    has_cat = bool(dev.forest.has_cat)
    if plan is None:
        plan = planner.traverse_plan(F, I, T, n, has_cat, K, emit_scores)
    if emit_scores:
        out = torch.empty((K, n), dtype=torch.float32, device=X.device)
        lv, L = dev.leaf_value, dev.leaf_value.shape[1]
    else:
        out = torch.empty((T, n), dtype=torch.int32, device=X.device)
        lv, L = None, 0
    if n == 0:
        return out
    # scores mode: the descents' leaf values, summed by the ordered sum
    scratch = (torch.empty((T, n), dtype=torch.float32, device=X.device)
               if emit_scores else None)
    lib = _lib()
    with torch.cuda.device(X.device):
        stream = torch.cuda.current_stream(X.device).cuda_stream
        rc = lib.traverse_forest(
            X.data_ptr(), n, F, dev.nodes.data_ptr(),
            dev.cat_records.data_ptr(), dev.cat_words.data_ptr(),
            dev.cat_words.numel(), T, I, max(int(dev.forest.max_depth), 1),
            int(has_cat), None if lv is None else lv.data_ptr(), L, K,
            plan.rows, plan.trees, plan.row_tiles, plan.threads,
            int(plan.stage),
            plan.sum_rows, plan.sum_trees,
            None if scratch is None else scratch.data_ptr(), out.data_ptr(),
            stream)
    if rc != 0:
        raise RuntimeError(f"traverse kernel launch failed: CUDA error {rc}")
    with _counts_lock:
        launch_counts["fused_traverse"] += 1
        launch_counts["fused_traverse[scores]" if emit_scores
                      else "fused_traverse[leaves]"] += 1
    return out
