"""Per-tier bytes and time of one histogram sum on a two-tier mesh
(counterpart of ``tools/collective_probe.py``).

``world`` ranks, threads of this process each in its own gloo group
(``testing.thread_ranks``), form a ``("dcn", "ici")`` mesh of
``num_slices`` slices (``parallel.learners.make_hybrid_mesh``) and sum
one histogram of the sharded growers' dtypes (the f32 pipeline's int64
fixed point [3, F, B], the quantized pipeline's int32 levels [2, F, B])
under each route:

- **flat**: one all-reduce over every rank;
- **hierarchical**: the fast tier, then the slow one;
- **voting**: the whole histogram over the fast tier, then only the
  top-k columns (by |gradient| sum, the slice's vote stand-in) over the
  slow tier;

beside ``ops.planner.plan_collectives``'s byte accounting of data- and
voting-parallel.  The bytes each route moved over each tier are counted
(``parallel.collectives.thread_op_counts``) and exact; the times are
rank 0's host clock over ``reps`` sums (``torch.cuda.synchronize`` on
the card).  With thread ranks on one host both tiers are the host's
memory, so the times compare routes, not links.

Usage: python -m lightgbm_tpu_torch.tools.torch_collective_probe
       [--rows N] [--features F] [--world W] [--slices S] [--top-k K]
       [--reps R] [--device cuda|cpu]
Prints one JSON object.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np


def run_probe(rows: int = 200_000, features: int = 28, max_bin: int = 63,
              leaves: int = 255, trees: int = 100,
              world: int = 8, num_slices: int = 2, top_k: int = 8,
              reps: int = 5, device: str = "cuda") -> dict:
    import torch

    from ..ops.planner import plan_collectives
    from ..parallel import collectives
    from ..parallel.collectives import DCN_AXIS, ICI_AXIS, psum_tiered
    from ..parallel.learners import make_hybrid_mesh
    from ..testing import thread_ranks

    if device != "cpu" and not torch.cuda.is_available():
        raise RuntimeError("torch_collective_probe: no CUDA device; pass "
                           "--device cpu to probe the host")
    s = max(1, min(int(num_slices), world))
    if world % s:
        raise ValueError(f"{s} slices do not divide {world} ranks")
    d = world // s
    B = max_bin + 1
    F = int(features)
    k = min(int(top_k), F)
    levels_per_tree = max(1.0, float(np.log2(max(leaves, 2))))

    def sync():
        if device != "cpu":
            torch.cuda.synchronize()

    def rank_fn(rank, group):
        mesh = make_hybrid_mesh(group, num_slices=s)
        rng = np.random.RandomState(rank)
        hists = {"f32": torch.as_tensor(rng.randint(
                     -2 ** 40, 2 ** 40, (3, F, B)), device=device),
                 "quant": torch.as_tensor(rng.randint(
                     -1000, 1000, (2, F, B)).astype(np.int32),
                     device=device)}

        def flat(h):
            return psum_tiered(h, mesh)

        def hier(h):
            return psum_tiered(h, mesh, hierarchical=True)

        def vote(h):
            local = psum_tiered(h, mesh, ICI_AXIS)
            elected = local[0].abs().sum(-1).topk(k).indices
            # every rank of a slice holds the same local sums; the
            # slices' elections differ, so each sums its own columns of
            # every slice's histogram (the vote itself is a few bytes)
            local[:, elected] = psum_tiered(local[:, elected], mesh,
                                            DCN_AXIS)
            return local

        out = {}
        for name, h in hists.items():
            times, moved = {}, {}
            for route, fn in (("flat", flat), ("hier", hier),
                              ("voting", vote)):
                fn(h)                                   # warm
                sync()
                collectives.reset_op_counts()
                t0 = time.perf_counter()
                for _ in range(reps):
                    fn(h)
                sync()
                times[route + "_ms"] = (time.perf_counter() - t0) / reps * 1e3
                moved[route] = {
                    key.split("@")[1][:-len("_bytes")]: v // reps
                    for key, v in collectives.thread_op_counts().items()
                    if "@" in key and key.endswith("_bytes")}
            out[name] = (times, moved)
        return out

    measured = thread_ranks(world, rank_fn)[0]
    platform = (torch.cuda.get_device_name(0) if device != "cpu"
                else "cpu")
    out = {"rows": int(rows), "features": F, "max_bin": max_bin,
           "leaves": leaves, "trees": trees, "top_k": k, "world": world,
           "mesh_shape": [s, d], "platform": platform, "reps": reps,
           "measured_ms": {n: m[0] for n, m in measured.items()},
           "measured_bytes_rank0": {n: m[1] for n, m in measured.items()}}
    for name, quant in (("f32", False), ("quant", True)):
        kw = dict(features=F, num_bins=B, quant=quant, num_slices=s,
                  devices_per_slice=d)
        data = plan_collectives(voting_k=0, **kw)
        voting = plan_collectives(voting_k=k, **kw)
        reductions = levels_per_tree * trees
        out[name] = {
            "payload_bytes": data.payload_bytes,
            "data_parallel": dict(
                data.summary(),
                dcn_bytes_per_tree=int(data.dcn_bytes * levels_per_tree),
                dcn_bytes_total=int(data.dcn_bytes * reductions)),
            "voting_parallel": dict(
                voting.summary(),
                dcn_bytes_per_tree=int(voting.dcn_bytes * levels_per_tree),
                dcn_bytes_total=int(voting.dcn_bytes * reductions)),
            "voting_dcn_below_data": bool(
                s <= 1 or voting.dcn_bytes < data.dcn_bytes),
        }
    out["hierarchy_elected"] = bool(out["f32"]["data_parallel"]
                                    ["hierarchy_elected"])
    out["ici_bytes"] = int(out["f32"]["data_parallel"]["ici_bytes"])
    out["dcn_bytes"] = int(out["f32"]["data_parallel"]["dcn_bytes"])
    out["voting_k"] = k
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=int, default=200_000)
    ap.add_argument("--features", type=int, default=28)
    ap.add_argument("--max-bin", type=int, default=63)
    ap.add_argument("--leaves", type=int, default=255)
    ap.add_argument("--trees", type=int, default=100)
    ap.add_argument("--world", type=int, default=8)
    ap.add_argument("--slices", type=int, default=2)
    ap.add_argument("--top-k", type=int, default=8)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    out = run_probe(rows=args.rows, features=args.features,
                    max_bin=args.max_bin, leaves=args.leaves,
                    trees=args.trees, world=args.world,
                    num_slices=args.slices, top_k=args.top_k,
                    reps=args.reps, device=args.device)
    print(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
