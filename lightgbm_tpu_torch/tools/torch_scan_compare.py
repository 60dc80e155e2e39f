"""Time the PyTorch port's scan kernel (B5, ``ops/csrc/fused.cu``) in its
plain mode, f32 and int8, at the ``hist`` shape of ``chip_smoke.py``
(K = 128 candidates, 256 children x 28 features x 255 bins, 1 M random
rows of which half are slotted).  Run it once per checkout, with that
checkout first on ``sys.path``, to compare two commits on one card in
one call (run them as A, B, B, A):

    PYTHONPATH=<checkout> python3 <this file> --label A

Prints one JSON line: each mode's mean time over 250 launches replayed
from a CUDA graph, and the card's name and power limit.  Needs a CUDA
card; imports nothing of JAX."""

from __future__ import annotations

import argparse
import json
import subprocess
import sys


def graph_ms(fn, reps: int = 50, replays: int = 5) -> float:
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
    return start.elapsed_time(end) / (replays * reps)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--label", required=True)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 1
    from lightgbm_tpu_torch.ops import fused
    from lightgbm_tpu_torch.ops.histogram import (_vals_t, _vals_t_int,
                                                  accumulate_plain,
                                                  fixed_point_scales)
    from lightgbm_tpu_torch.ops.split import (QuantScales, SplitHyperparams,
                                              fixed_to_f32)

    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(1)
    n, F, B, K = 1_000_000, 28, 255, 128

    def ints(lo, hi, size, dtype=torch.int32):
        return torch.randint(lo, hi, size, device=dev, generator=g,
                             dtype=torch.int32).to(dtype)
    binned = ints(0, B, (F, n), torch.uint8)
    grad = torch.randn(n, device=dev, generator=g)
    hess = torch.rand(n, device=dev, generator=g) + 0.1
    vals = _vals_t(grad, hess, torch.ones_like(grad)).contiguous()
    scales = fixed_point_scales(vals)
    r = torch.rand(n, device=dev, generator=g)
    pick, other = ints(0, K, (n,)), ints(0, K, (n,))
    slot = torch.where(r < 0.5, pick, torch.full_like(pick, K))
    pslot = torch.where(r < 0.5, pick, other)
    small_left = torch.rand(K, device=dev, generator=g) < 0.5
    nb = torch.full((F,), B, dtype=torch.int32, device=dev)
    mt = torch.zeros(F, dtype=torch.int32, device=dev)
    hp = SplitHyperparams(min_data_in_leaf=20)

    parent = accumulate_plain(binned, vals, pslot, K, B, scales)
    small = accumulate_plain(binned, vals, slot, K, B, scales)
    kids = fused.derive_children(small, small_left, parent)
    sums = torch.stack([fixed_to_f32(kids[:, c, 0].sum(-1), [scales[c]], 0)
                        for c in range(3)])

    qvals = _vals_t_int(ints(-2, 3, (n,), torch.int8),
                        ints(0, 4, (n,), torch.int8),
                        torch.ones(n, dtype=torch.bool, device=dev)
                        ).contiguous()
    qparent = accumulate_plain(binned, qvals, pslot, K, B)
    qsmall = accumulate_plain(binned, qvals, slot, K, B)
    qkids = fused.derive_children(qsmall, small_left, qparent)
    tot = qkids[:, :, 0].to(torch.int64).sum(-1).to(torch.float32)
    n_par = torch.bincount(pslot, minlength=K)
    n_small = torch.bincount(slot[slot < K], minlength=K)
    n_left = torch.where(small_left, n_small, n_par - n_small)
    qs = QuantScales(0.37, 0.11)
    qsums = torch.stack([tot[:, 0] * qs.g, tot[:, 1] * qs.h,
                         torch.cat([n_left, n_par - n_left]).float()])

    f32_ms = graph_ms(lambda: fused.sibling_scan(
        small, scales, sums, nb, mt, mt, hp, small_left=small_left,
        parent=parent))
    int8_ms = graph_ms(lambda: fused.sibling_scan(
        qsmall, qs, qsums, nb, mt, mt, hp, small_left=small_left,
        parent=qparent))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(json.dumps({"label": args.label, "b5_f32_ms": f32_ms,
                      "b5_int8_ms": int8_ms, "card": smi.strip()}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
