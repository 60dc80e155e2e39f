"""Time the PyTorch port's traversal kernel (B1, ``ops/csrc/traverse.cu``)
and root histogram kernel (B6, ``ops/csrc/histogram.cu``) at the shapes
``chip_smoke.py`` drives, to compare two commits on one card:

- B1 in leaves and scores mode, on the ``higgs_500x255`` forest (28
  features, 500 trees, 255 leaves, binary) and the ``multiclass5_cat``
  forest (20 features, 100 iterations x 5 classes, 31 leaves, three
  categorical features), random trees from a seed
  (``testing.synthetic_model_text``), at 8, 64, 101 (the monotone
  sweep's batch), 1,024 and 65,536 rows (the serving buckets and one
  predict chunk);
- B6 at both staged-arm training shapes: the one-hot airline table's 9
  EFB bundle columns (``testing.airline_like`` one-hot, 1,000,000 rows,
  ``airline_onehot_1m``) and 28 uint8 features without bundles
  (``testing.higgs_like``, 1,000,000 rows, ``higgs_rand_1m``), with the
  binary objective's gradients at the label mean.

Every timed call is first held bit for bit against its plain version
(``traverse_plain``, ``histogram_plain``).  Run it once per checkout,
with that checkout first on ``sys.path``, and run the checkouts as A, B,
B, A in one call:

    PYTHONPATH=<checkout> python3 <this file> --label A

Prints one JSON line: each case's mean time over the launches of a CUDA
graph replayed 5 times, and the card's name and power limit.  For a
checkout whose planner has ``traverse_plan`` (and whose
``fused_traverse`` takes ``plan=``) it also times B1 with the node
records staged in shared memory and read from global memory, each as
``planner.traverse_plan(..., stage=)`` plans it, each held to its plain
version first.  Needs a
CUDA card; imports nothing of JAX."""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

ROWS = (8, 64, 101, 1024, 65536)


def graph_ms(fn, reps: int, replays: int = 5) -> float:
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (replays * reps)
    del graph
    torch.cuda.empty_cache()
    return ms


def _forests():
    from lightgbm_tpu_torch.testing import synthetic_model_text
    return {
        "higgs_500x255": (synthetic_model_text(28, 500, 255, seed=7), 28,
                          (), 7, 1),
        "multiclass5_cat": (synthetic_model_text(
            20, 100, 31, num_class=5, cat_features=(0, 7, 13), seed=101),
            20, (0, 7, 13), 101, 5),
    }


def _variants(dev, X, K, scores):
    """The staged and the global-record launch for these rows and mode,
    as the planner plans each (the staged one only where a tree fits);
    each (label, plan).  None for a checkout without ``traverse_plan``."""
    from lightgbm_tpu_torch.ops import planner
    if not hasattr(planner, "traverse_plan"):
        return None
    n, F = X.shape
    T, I = dev.split_feature.shape
    args = (F, I, T, n, bool(dev.forest.has_cat), K, scores)
    out = []
    for stage in (False, True):
        try:
            out.append(("staged" if stage else "global",
                        planner.traverse_plan(*args, stage=stage)))
        except ValueError:
            continue               # the trees do not fit: no staged path
    return out


def b1_cases(out) -> None:
    import numpy as np
    import torch
    import lightgbm_tpu_torch as lt
    from lightgbm_tpu_torch.ops import predict_kernels as pk
    from lightgbm_tpu_torch.testing import salt_rows, synthetic_rows
    for name, (text, F, cats, seed, K) in _forests().items():
        bst = lt.Booster(model_str=text)
        dev = bst._device_forest(bst._forest(0, len(bst.models) // K))
        for n in ROWS:
            X = salt_rows(synthetic_rows(F, n, cats, seed=seed,
                                         row_seed=n + 1))
            Xt = torch.from_numpy(X.astype(np.float32)).cuda()
            for scores in (False, True):
                def kernel():
                    return pk.fused_traverse(dev, Xt, K, emit_scores=scores)
                got = kernel()
                want = pk.traverse_plain(dev, Xt, K, emit_scores=scores)
                if not torch.equal(got.view(torch.int32),
                                   want.view(torch.int32)):
                    raise AssertionError(f"B1 {name} {n} rows differs from "
                                         f"its plain version")
                mode = "scores" if scores else "leaves"
                reps = 50 if n <= 1024 else 10
                out[f"b1_{name}_{mode}_{n}_ms"] = graph_ms(kernel, reps)
                for label, plan in _variants(dev, Xt, K, scores) or ():
                    def run():
                        return pk.fused_traverse(dev, Xt, K, scores,
                                                 plan=plan)
                    if not torch.equal(run().view(torch.int32),
                                       want.view(torch.int32)):
                        raise AssertionError(f"B1 {name} {n} rows "
                                             f"({label}) differs")
                    key = f"b1_{name}_{mode}_{n}_{label}"
                    out[key + "_ms"] = graph_ms(run, reps)
                    out[key + "_plan"] = [plan.rows, plan.trees,
                                          plan.row_tiles]


def b6_cases(out) -> None:
    import torch
    import lightgbm_tpu_torch as lt
    from lightgbm_tpu_torch.ops import histogram as H
    from lightgbm_tpu_torch.testing import airline_like, higgs_like, one_hot
    X8, y1 = airline_like(1_000_000, seed=11)
    X2, y2 = higgs_like(1_000_000, seed=11)
    for name, X, y in (("onehot", one_hot(X8), y1), ("rand", X2, y2)):
        ds = lt.Dataset(X, label=y)
        ds.construct()
        binned = ds.binned_t
        F, n = binned.shape
        B = int(ds.max_group_bin)
        p = float(y.mean())
        yt = torch.from_numpy(y.astype("float32")).cuda()
        grad = torch.full_like(yt, p) - yt
        hess = torch.full_like(yt, p * (1.0 - p))
        vals = H._vals_t(grad, hess, torch.ones_like(grad)).contiguous()
        scales = H.fixed_point_scales(vals)
        got = H.histogram_fixed(binned, vals, B, scales)
        if not torch.equal(got, H.histogram_plain(binned, vals, B, scales)):
            raise AssertionError(f"B6 ({name}) differs from its plain "
                                 f"version")
        out[f"b6_{name}_ms"] = graph_ms(
            lambda: H.histogram_fixed(binned, vals, B, scales), 20)
        out[f"b6_{name}_shape"] = [F, n, B]
        del ds, binned, vals


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--label", required=True)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 1
    out = {"label": args.label}
    b1_cases(out)
    b6_cases(out)
    out["card"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
