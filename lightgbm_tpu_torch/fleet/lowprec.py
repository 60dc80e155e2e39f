"""Opt-in low-precision serving: move a forest onto a bf16 or int8 grid
(counterpart of ``lightgbm_tpu/fleet/lowprec.py``).

``quantize_forest`` rounds a ``StackedForest``'s numeric thresholds and
leaf values onto a bf16 or per-tree int8 grid, giving a NEW forest that
the serving registry treats like any other model: its own digest, its
own programs, and a device path bit-identical to its host path (every
grid value is exactly f32-representable, so ``DeviceForest``'s f32
round-down is the identity on it).  The serving registry measures the
raw-score drift against the full forest on a probe batch and
quarantines a model whose drift exceeds its ``accuracy_budget``.

The arithmetic is the JAX package's, so a quantised forest is the same
bytes in both packages: bf16 rounds to nearest even (``torch.bfloat16``
here, ``ml_dtypes`` there), int8 takes the f32 scale ``mag / 127``,
``np.round`` of the f64 quotient, and the f32 ``q * scale``.

A leaf module: numpy and torch, no serving imports.
"""

from __future__ import annotations

import copy

import numpy as np
import torch

PRECISIONS = ("f32", "bf16", "int8")


def bf16_round(a: np.ndarray) -> np.ndarray:
    """Round float64 values to the nearest bfloat16 (ties to even),
    returned as float64 (every bf16 value is exactly f32- and
    f64-representable)."""
    t = torch.from_numpy(np.ascontiguousarray(a, np.float64))
    return t.to(torch.bfloat16).to(torch.float64).numpy()


def int8_rows(a: np.ndarray, skip=None):
    """Per-row symmetric int8 quantization of a [T, N] float64 array.

    Returns ``(q, scale, deq)``: int8 codes, per-row f32 scale, and the
    dequantized float64 grid ``f32(q * scale)``.  Entries where ``skip``
    is True (non-finite padding, categorical bitset indices) get code 0
    and keep their original value in ``deq``.  The scale and the
    dequantization are computed in float32 so that a device plane of
    ``q.float() * scale`` reproduces ``deq`` bit for bit.
    """
    a = np.asarray(a, np.float64)
    if skip is None:
        skip = ~np.isfinite(a)
    else:
        skip = np.asarray(skip, bool) | ~np.isfinite(a)
    live = np.where(skip, 0.0, a)
    mag = np.abs(live).max(axis=1)                        # [T]
    scale = np.where(mag > 0, mag, 1.0).astype(np.float32) / np.float32(127)
    q = np.clip(np.round(live / scale[:, None].astype(np.float64)),
                -127, 127).astype(np.int8)
    q = np.where(skip, np.int8(0), q)
    deq = (q.astype(np.float32) * scale[:, None]).astype(np.float64)
    deq = np.where(skip, a, deq)
    return q, scale, deq


def quantize_forest(forest, precision: str):
    """Shallow-copy ``forest`` with thresholds and leaf values moved onto
    the ``precision`` grid ("bf16" | "int8"; "f32" returns ``forest``).

    Categorical split nodes keep their thresholds verbatim (there the
    "threshold" is a bitset index, and rounding it would corrupt
    routing), and so do non-finite entries (the +inf padding of unused
    node slots).  An int8 forest also carries ``threshold_q`` /
    ``threshold_scale`` / ``threshold_skip``, from which
    ``DeviceForest(precision="int8")`` builds the same grid on the
    device.
    """
    if precision == "f32":
        return forest
    if precision not in PRECISIONS:
        raise ValueError(f"unknown serving precision {precision!r}; "
                         f"expected one of {PRECISIONS}")
    qf = copy.copy(forest)
    thr_skip = ~np.isfinite(forest.threshold) | forest.is_cat
    if precision == "bf16":
        qf.threshold = np.where(thr_skip, forest.threshold,
                                bf16_round(forest.threshold))
        qf.leaf_value = bf16_round(forest.leaf_value)
    else:
        q, scale, deq = int8_rows(forest.threshold, skip=thr_skip)
        qf.threshold = deq
        qf.threshold_q = q
        qf.threshold_scale = scale
        qf.threshold_skip = thr_skip
        _, _, qf.leaf_value = int8_rows(forest.leaf_value)
    return qf


def forest_precision_bytes(forest, precision: str) -> dict:
    """What the grid would save on the device: {threshold_bytes,
    leaf_bytes} at ``precision`` beside their f32 sizes.  The port's
    kernel still reads 16-byte node records whatever the precision
    (narrower records are ROADMAP queue B work); this is the accounting
    of the narrowed planes themselves."""
    T, I = forest.threshold.shape
    L = forest.leaf_value.shape[1]
    thr_item = {"f32": 4, "bf16": 2, "int8": 1}[precision]
    return {
        "threshold_bytes": T * I * thr_item + (T * 4 if precision == "int8"
                                               else 0),
        "threshold_bytes_f32": T * I * 4,
        # low-precision serving gathers leaves on the host: no device copy
        "leaf_bytes": 0 if precision != "f32" else T * L * 4,
        "leaf_bytes_f32": T * L * 4,
    }


def measure_accuracy_delta(full_forest, lp_forest, X: np.ndarray,
                           num_class: int = 1) -> float:
    """max |raw_lp - raw_full| over the probe rows ``X``: the number the
    serving registry compares with ``accuracy_budget`` and reports as
    ``lowprec_accuracy_delta``.  Both forests run the host path, which
    for f32-precision rows is bit-identical to what the device serves."""
    X = np.asarray(X, np.float64)
    ref = full_forest.predict_raw(X, num_class=num_class)
    got = lp_forest.predict_raw(X, num_class=num_class)
    return float(np.max(np.abs(got - ref))) if ref.size else 0.0
