"""Batch prediction over a stacked forest (counterpart of
``lightgbm_tpu/predict.py``).

reference: src/application/predictor.hpp:29 (row-parallel Predictor),
include/LightGBM/tree.h:190 (inline Tree::Predict traversal), and
src/boosting/prediction_early_stop.cpp:13-90 (margin-based early stop).

``StackedForest`` packs all trees into padded [T, nodes] NumPy arrays and
advances every row one level per step on the host in float64.
``DeviceForest`` holds the same forest as torch tensors on one device and
routes rows through ``ops.predict_kernels.fused_traverse``: the CUDA
kernel on a card, its plain torch version on the CPU.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from .ops import planner
from .ops import predict_kernels as _pk
from .tree import K_CATEGORICAL_MASK, K_DEFAULT_LEFT_MASK, K_ZERO_THRESHOLD
from .utils.log import log_debug

_CHUNK_ROWS = 1 << 16


def gather_leaf_sum(forest, leaves: np.ndarray, num_class: int) -> np.ndarray:
    """Host float64 leaf-value gather + iteration-sum epilogue:
    [T, rows] leaf indices -> [K, rows] raw scores.

    The serving bit-parity contract hangs on this exact gather +
    ``sum(axis=0)`` reduction order matching ``StackedForest.predict_raw``.
    """
    K = max(num_class, 1)
    iters = forest.num_trees // K
    rows = leaves.shape[1]
    tid = np.arange(forest.num_trees)
    lv = forest.leaf_value[tid[:, None], leaves]             # [T, rows] f64
    return lv.reshape(iters, K, rows).sum(axis=0)            # [K, rows]


class StackedForest:
    """Padded [T, nodes] arrays for a list of HostTrees (raw-feature space)."""

    def __init__(self, trees: List):
        T = len(trees)
        self.num_trees = T
        I = max([max(t.num_leaves - 1, 1) for t in trees], default=1)
        L = max([max(t.num_leaves, 1) for t in trees], default=1)
        self.split_feature = np.zeros((T, I), np.int32)
        self.threshold = np.full((T, I), np.inf, np.float64)
        self.left = np.full((T, I), -1, np.int32)     # ~0 = leaf 0
        self.right = np.full((T, I), -1, np.int32)
        self.is_cat = np.zeros((T, I), bool)
        self.default_left = np.zeros((T, I), bool)
        self.missing_type = np.zeros((T, I), np.int8)
        self.leaf_value = np.zeros((T, L), np.float64)
        self.depth = np.ones(T, np.int32)
        # categorical bitsets: flat word array + per-node offset/word-count
        self.cat_offset = np.zeros((T, I), np.int64)
        self.cat_nwords = np.zeros((T, I), np.int32)
        words: List[np.ndarray] = []
        wpos = 0
        self.has_cat = False
        for t, tr in enumerate(trees):
            ns = tr.num_leaves - 1
            self.leaf_value[t, :tr.num_leaves] = tr.leaf_value[:tr.num_leaves]
            if ns <= 0:
                continue  # single-leaf tree: sentinel node routes to leaf 0
            self.split_feature[t, :ns] = tr.split_feature[:ns]
            self.threshold[t, :ns] = tr.threshold[:ns]
            self.left[t, :ns] = tr.left_child[:ns]
            self.right[t, :ns] = tr.right_child[:ns]
            dt = tr.decision_type[:ns].astype(np.int32)
            self.is_cat[t, :ns] = (dt & K_CATEGORICAL_MASK) != 0
            self.default_left[t, :ns] = (dt & K_DEFAULT_LEFT_MASK) != 0
            self.missing_type[t, :ns] = (dt >> 2) & 3
            self.depth[t] = tr.max_depth()
            for s in np.flatnonzero(self.is_cat[t, :ns]):
                self.has_cat = True
                ci = int(tr.threshold[s])
                lo = int(tr.cat_boundaries[ci])
                hi = int(tr.cat_boundaries[ci + 1])
                w = np.asarray(tr.cat_threshold[lo:hi], np.uint32)
                self.cat_offset[t, s] = wpos
                self.cat_nwords[t, s] = len(w)
                words.append(w)
                wpos += len(w)
        self.cat_words = (np.concatenate(words) if words
                          else np.zeros(1, np.uint32))
        self.max_depth = int(self.depth.max(initial=1))

    # ------------------------------------------------------------- traversal
    #
    # All trees of a block advance one level per step with [T', nc] state
    # arrays — one fused numpy op serves every (tree, row) pair.

    def _decide_block(self, tid2, nd, fval):
        """Vectorized go-left for a [T', nc] block of (tree, node) states."""
        thr = self.threshold[tid2, nd]
        mt = self.missing_type[tid2, nd]
        nan = np.isnan(fval)
        fz = np.where(nan & (mt != 2), 0.0, fval)
        is_missing = ((mt == 1) & (np.abs(fz) <= K_ZERO_THRESHOLD)) | \
                     ((mt == 2) & nan)
        with np.errstate(invalid="ignore"):
            gl = np.where(is_missing, self.default_left[tid2, nd], fz <= thr)
        if self.has_cat:
            cat = self.is_cat[tid2, nd]
            if cat.any():
                # truncation toward zero matches the reference's
                # static_cast<int> (so -0.5 -> category 0, not "invalid")
                with np.errstate(invalid="ignore"):
                    iv = np.where(nan, -1.0, fval).astype(np.int64)
                nw = self.cat_nwords[tid2, nd]
                valid = (iv >= 0) & (iv < nw.astype(np.int64) * 32)
                ivc = np.clip(iv, 0, None)
                widx = self.cat_offset[tid2, nd] + np.minimum(
                    ivc // 32, np.maximum(nw - 1, 0))
                inset = (self.cat_words[widx]
                         >> (ivc % 32).astype(np.uint32)) & 1
                gl = np.where(cat, valid & (inset == 1), gl)
        return gl

    def _leaves_chunk(self, Xc: np.ndarray, tree_ids,
                      block_elems: int = 1 << 23) -> np.ndarray:
        """Leaf index per (tree, row) for one row chunk. Returns [T', nc].

        Trees are processed depth-sorted in blocks so a block's step count
        is its own max depth, not the forest's.
        """
        nc = Xc.shape[0]
        tid = np.asarray(list(tree_ids), np.int32)
        out = np.zeros((len(tid), nc), np.int32)
        rows = np.arange(nc)[None, :]
        order = np.argsort(self.depth[tid], kind="stable")
        t_blk = max(1, block_elems // max(nc, 1))
        for bs in range(0, len(tid), t_blk):
            sel = order[bs:bs + t_blk]
            tb = tid[sel]
            tid2 = tb[:, None]
            node = np.zeros((len(tb), nc), np.int32)
            while True:
                nd = np.maximum(node, 0)
                fval = Xc[rows, self.split_feature[tid2, nd]]
                gl = self._decide_block(tid2, nd, fval)
                nxt = np.where(gl, self.left[tid2, nd], self.right[tid2, nd])
                node = np.where(node < 0, node, nxt)
                if (node < 0).all():
                    break
            out[sel] = ~node
        return out

    def predict_leaf(self, X: np.ndarray,
                     chunk_rows: int = _CHUNK_ROWS) -> np.ndarray:
        """Leaf indices [n, T] (reference pred_leaf output layout)."""
        X = np.ascontiguousarray(X, np.float64)
        n = X.shape[0]
        out = np.zeros((n, self.num_trees), np.int32)
        for s in range(0, n, chunk_rows):
            e = min(s + chunk_rows, n)
            out[s:e] = self._leaves_chunk(X[s:e], range(self.num_trees)).T
        return out

    def predict_raw(
        self,
        X: np.ndarray,
        num_class: int = 1,
        early_stop=None,
        chunk_rows: int = _CHUNK_ROWS,
    ) -> np.ndarray:
        """Summed raw scores [K, n].  Trees are laid out iteration-major
        (iteration i, class k -> tree i*K + k) as in the reference.

        ``early_stop``: optional ``EarlyStop``; every ``freq`` iterations
        rows whose margin passes are frozen and compacted out
        (reference: prediction_early_stop.cpp:13-60).
        """
        n = X.shape[0]
        K = max(num_class, 1)
        iters = self.num_trees // K
        X = np.ascontiguousarray(X, np.float64)
        out = np.zeros((K, n), np.float64)
        for s in range(0, n, chunk_rows):
            e = min(s + chunk_rows, n)
            Xc = X[s:e]
            if early_stop is None:
                leaves = self._leaves_chunk(Xc, range(self.num_trees))
                tid = np.arange(self.num_trees)
                lv = self.leaf_value[tid[:, None], leaves]      # [T, nc]
                out[:, s:e] += lv.reshape(iters, K, e - s).sum(axis=0)
            else:
                freq, margin_fn = early_stop.freq, early_stop.margin_fn
                live = np.arange(e - s)
                acc = np.zeros((K, e - s), np.float64)
                Xl = Xc
                for it in range(iters):
                    ids = range(it * K, (it + 1) * K)
                    leaves = self._leaves_chunk(Xl, ids)
                    for j, t in enumerate(ids):
                        acc[t % K, live] += self.leaf_value[t, leaves[j]]
                    if freq > 0 and (it + 1) % freq == 0 and it + 1 < iters:
                        stop = margin_fn(acc[:, live])
                        if stop.any():
                            live = live[~stop]
                            if live.size == 0:
                                break
                            Xl = Xc[live]
                out[:, s:e] = acc
        return out


def _int32_plane(a: np.ndarray, name: str) -> np.ndarray:
    """int32 copy of a routing array for the kernel planes; refuses
    values an int32 cannot hold (``cat_offset`` is int64 on the host)."""
    a = np.asarray(a)
    if a.size and (a.max() > np.iinfo(np.int32).max
                   or a.min() < np.iinfo(np.int32).min):
        raise ValueError(f"{name} does not fit the kernel's int32 planes")
    return np.ascontiguousarray(a, np.int32)


class DeviceForest:
    """A ``StackedForest`` as torch tensors on one device, traversed by
    ``ops.predict_kernels.fused_traverse``.

    Exactness: inputs are compared in float32, with each node threshold
    rounded DOWN to the nearest float32.  For float32 feature values x,
    ``x <= t64``  ⟺  ``x <= round_down_f32(t64)``, so routing matches the
    float64 host path exactly for f32-precision data (float64 inputs with
    sub-f32 precision may route differently at bin boundaries — use the
    host path when that matters).
    """

    def __init__(self, forest: StackedForest, device):
        self.forest = forest
        self.device = torch.device(device)
        f = forest
        # round thresholds toward -inf in f32
        thr32 = f.threshold.astype(np.float32)
        over = thr32.astype(np.float64) > f.threshold
        thr32[over] = np.nextafter(thr32[over], -np.inf, dtype=np.float32)

        def put(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

        self.threshold = put(thr32)
        self.device = self.threshold.device      # "cuda" -> "cuda:0"
        self.split_feature = put(_int32_plane(f.split_feature, "split_feature"))
        self.left = put(_int32_plane(f.left, "left"))
        self.right = put(_int32_plane(f.right, "right"))
        self.missing_type = put(_int32_plane(f.missing_type, "missing_type"))
        self.default_left = put(_int32_plane(f.default_left, "default_left"))
        self.is_cat = put(_int32_plane(f.is_cat, "is_cat"))
        self.cat_offset = put(_int32_plane(f.cat_offset, "cat_offset"))
        self.cat_nwords = put(_int32_plane(f.cat_nwords, "cat_nwords"))
        # u32 words travel as int32 bit patterns (torch's uint32 is thin)
        self.cat_words = put(np.ascontiguousarray(f.cat_words, np.uint32)
                             .view(np.int32))
        self.leaf_value = put(f.leaf_value.astype(np.float32))
        self.num_trees = f.num_trees
        self.num_features = int(f.split_feature.max(initial=0)) + 1
        self._epilogue_ok: dict = {}

    def _to_device(self, X: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(X, np.float32)) \
            .to(self.device)

    def _leaves(self, Xc: torch.Tensor) -> torch.Tensor:
        """[nc, F] f32 -> leaf index [T, nc]."""
        return _pk.fused_traverse(self, Xc)

    def _leaf_sum(self, leaves: torch.Tensor, num_class: int) -> torch.Tensor:
        """Device leaf-value epilogue: [T, rows] leaf indices ->
        [K, rows] f32 raw scores in pinned iteration-major order."""
        return _pk.pinned_leaf_sum(self.leaf_value, leaves, num_class)

    def _epilogue_verified(self, num_class: int) -> bool:
        """One-time per (forest, K) probe: the float32 device leaf-sum may
        replace the host float64 ``gather_leaf_sum`` ONLY if it reproduces
        it bit-exactly on a battery of synthetic leaf patterns — any
        divergence keeps the serving bit-parity contract on the host."""
        K = max(num_class, 1)
        if self.forest.num_trees % K:
            return False
        ok = self._epilogue_ok.get(K)
        if ok is None:
            T = self.forest.num_trees
            L = self.forest.leaf_value.shape[1]
            rng = np.random.RandomState(20260807)
            leaves = rng.randint(0, L, size=(T, 128)).astype(np.int32)
            leaves[:, 0] = 0                     # adversarial same-leaf
            leaves[:, 1] = L - 1                 # columns stress carries
            dev = self._leaf_sum(torch.from_numpy(leaves).to(self.device), K)
            ok = bool(np.array_equal(
                dev.cpu().numpy().astype(np.float64),
                gather_leaf_sum(self.forest, leaves, K)))
            if not ok:
                # the COMMON case for real-valued forests (f32 sums
                # rarely reproduce f64 bit-for-bit)
                log_debug(
                    "device leaf-sum epilogue demoted: float32 sums not "
                    "bit-identical to the float64 host gather for this "
                    "forest; predict_raw_padded keeps the host path")
            self._epilogue_ok[K] = ok
        return bool(ok)

    def predict_raw_padded(self, Xpad: np.ndarray,
                           num_class: int = 1) -> np.ndarray:
        """Raw scores [K, rows] for ONE already-padded, bucket-shaped
        batch — the serving subsystem's entry point (serving/registry.py).

        Routing runs on the device; leaf values are gathered and summed
        on the HOST in float64 in the order of ``StackedForest.predict_raw``
        — so for float32-precision feature values the output is
        bit-identical to the host path.  When ``_epilogue_verified`` shows
        that the float32 pinned-order sum reproduces that host gather for
        this forest, the kernel sums the scores itself (scores mode) and
        only [K, rows] leaves the device.
        """
        X = self._to_device(Xpad)
        if self._epilogue_verified(num_class):
            K = max(num_class, 1)
            return _pk.fused_traverse(self, X, K, emit_scores=True) \
                .cpu().numpy().astype(np.float64)
        leaves = self._leaves(X).cpu().numpy()
        return gather_leaf_sum(self.forest, leaves, num_class)

    def predict_raw(self, X: np.ndarray, num_class: int = 1) -> np.ndarray:
        """Summed raw scores [K, n] (float32, pinned order, in the kernel's
        scores mode)."""
        n = X.shape[0]
        K = max(num_class, 1)
        out = np.zeros((K, n), np.float64)
        cr = planner.PREDICT_CHUNK_ROWS
        for s in range(0, n, cr):
            e = min(s + cr, n)
            scores = _pk.fused_traverse(self, self._to_device(X[s:e]), K,
                                        emit_scores=True)
            out[:, s:e] = scores.cpu().numpy()
        return out

    def predict_leaf(self, X: np.ndarray) -> np.ndarray:
        """Leaf indices [n, T]."""
        n = X.shape[0]
        out = np.zeros((n, self.forest.num_trees), np.int32)
        cr = planner.PREDICT_CHUNK_ROWS
        for s in range(0, n, cr):
            e = min(s + cr, n)
            out[s:e] = self._leaves(self._to_device(X[s:e])).cpu().numpy().T
        return out


class EarlyStop:
    """Prediction early-stop spec (reference:
    CreatePredictionEarlyStopInstance, prediction_early_stop.cpp:62-90):
    'binary' stops when |2*score| > margin, 'multiclass' when the top-2
    score gap > margin, checked every ``freq`` iterations."""

    def __init__(self, kind_code: int, freq: int, margin: float, margin_fn):
        self.kind_code = kind_code
        self.freq = freq
        self.margin = margin
        self.margin_fn = margin_fn


def make_early_stop(kind: str, margin: float, freq: int):
    if freq <= 0 or kind == "none":
        return None
    if kind == "binary":
        def margin_fn(raw):  # [1, rows]
            return np.abs(2.0 * raw[0]) > margin
        return EarlyStop(1, freq, margin, margin_fn)
    if kind == "multiclass":
        def margin_fn(raw):  # [K, rows]
            if raw.shape[0] < 2:
                return np.zeros(raw.shape[1], bool)
            part = np.partition(raw, raw.shape[0] - 2, axis=0)
            return (part[-1] - part[-2]) > margin
        return EarlyStop(2, freq, margin, margin_fn)
    raise ValueError(f"unknown early-stop type {kind!r}")
