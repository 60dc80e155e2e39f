"""The model axis' sweep probe: seconds a tree batched against
sequential, at batch widths B (counterpart of ``tools/sweep_probe.py``).

For each width B, B boosters over ONE shared ``Dataset`` (each lane its
own learning rate, bagging fraction and seed, as the JAX package's
probe varies them) train ``reps`` chunks of ``chunk`` iterations as one
group program (``multi.batch.BatchedChunkProgram``: one graph replay a
round for the group), after a warm chunk that captures the group's
graph; then B fresh boosters of the same configs train the same chunks
one booster after the other (``Booster.update_chunk``).  Each side is
timed on the host clock around its chunks, with the card synchronised
before and after.  The row holds the seconds a dispatch, iterations a
second, seconds a tree both ways, the group's replays and lane rounds,
and whether every lane's text equals its sequential twin's; the plan
is ``ops.planner.plan_model_batch``'s at the widest B.  A record, not
a claim: nothing here raises on a speed-up bar.

Usage: python -m lightgbm_tpu_torch.tools.torch_sweep_probe [--rows N]
[--features F] [--max-bin B] [--leaves L] [--chunk C] [--reps R]
[--widths 1,2,4,8] [--device cpu]; prints one JSON object.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np

BATCH_WIDTHS = (1, 2, 4, 8)


def _params(i: int, leaves: int, max_bin: int) -> dict:
    return {"objective": "binary", "num_leaves": int(leaves),
            "max_bin": int(max_bin), "verbosity": -1,
            "learning_rate": 0.05 + 0.02 * i,
            "bagging_fraction": 0.9 - 0.05 * (i % 4),
            "bagging_freq": 1, "bagging_seed": 7 + i}


def run_probe(rows=200_000, features=28, max_bin=255, leaves=255,
              chunk=2, reps=2, widths=BATCH_WIDTHS, device=None) -> dict:
    import torch

    import lightgbm_tpu_torch as lt
    from ..basic import resolve_device
    from ..multi.batch import BatchedChunkProgram
    from ..multi.group import group_boosters
    from ..ops.planner import plan_model_batch

    dev = resolve_device(device)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    rng = np.random.RandomState(0)
    n, F = int(rows), int(features)
    X = rng.randn(n, F)
    y = (X[:, 0] + 0.5 * X[:, 1] + 0.1 * rng.randn(n) > 0).astype(np.float64)
    ds = lt.Dataset(X, label=y, params={"max_bin": int(max_bin)},
                    free_raw_data=False, device=dev)
    ds.construct()
    widths = tuple(sorted(int(w) for w in widths))
    c, reps = int(chunk), max(int(reps), 1)
    out = {"rows": n, "features": F, "max_bin": int(max_bin),
           "leaves": int(leaves), "chunk": c, "reps": reps,
           "batch_widths": list(widths), "device": str(dev)}

    def boosters(B):
        return [lt.Booster(_params(i, leaves, max_bin), train_set=ds)
                for i in range(B)]

    for B in widths:
        lanes = boosters(B)
        groups = group_boosters([b.boosting for b in lanes], stacked=False)
        if len(groups) != 1:
            raise RuntimeError(f"sweep probe: {B} lanes formed "
                               f"{len(groups)} groups")
        prog = BatchedChunkProgram(groups[0])
        live, lrs = [True] * B, [None] * B
        prog.dispatch(c, live, lrs)                 # warm: the capture
        sync()
        t0 = time.perf_counter()
        for _ in range(reps):
            prog.dispatch(c, live, lrs)
        sync()
        batched = (time.perf_counter() - t0) / reps
        seq = boosters(B)
        for b in seq:
            b.update_chunk(c)                       # warm: the captures
        sync()
        t0 = time.perf_counter()
        for _ in range(reps):
            for b in seq:
                b.update_chunk(c)
        sync()
        sequential = (time.perf_counter() - t0) / reps
        trees = B * c * lanes[0].num_tree_per_iteration
        rg = prog.rounds
        out[f"B{B}"] = {
            "seconds_per_dispatch": batched,
            "iters_per_sec": B * c / batched if batched > 0 else 0.0,
            "s_per_tree_batched": batched / trees,
            "s_per_tree_sequential": sequential / trees,
            "speedup_vs_sequential": (sequential / batched
                                      if batched > 0 else 0.0),
            "group_replays": rg.replays, "group_rounds": rg.group_rounds,
            "lane_rounds": rg.lane_rounds, "captures": rg.captures,
            "texts_equal": all(a.model_to_string() == b.model_to_string()
                               for a, b in zip(lanes, seq)),
        }
        del lanes, seq, prog
    b0 = lt.Booster(_params(0, leaves, max_bin), train_set=ds).boosting
    cfg = b0.grower_cfg
    out["model_batch_plan"] = plan_model_batch(
        b_total=max(widths), rows=b0.num_data, features=F,
        num_bins=b0.num_bins, num_leaves=int(leaves),
        round_width=cfg.round_width, stacked=False, device=dev).summary()
    b1 = out[f"B{min(widths)}"]["iters_per_sec"]
    bmax = out[f"B{max(widths)}"]["iters_per_sec"]
    out["aggregate_speedup_vs_b1"] = (bmax / b1) if b1 > 0 else 0.0
    out["accel"] = dev.type == "cuda"
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rows", type=int, default=200_000)
    ap.add_argument("--features", type=int, default=28)
    ap.add_argument("--max-bin", type=int, default=255)
    ap.add_argument("--leaves", type=int, default=255)
    ap.add_argument("--chunk", type=int, default=2)
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--widths", default="1,2,4,8")
    ap.add_argument("--device", default=None)
    a = ap.parse_args(argv)
    widths = tuple(int(w) for w in a.widths.split(",") if w.strip())
    print(json.dumps(run_probe(rows=a.rows, features=a.features,
                               max_bin=a.max_bin, leaves=a.leaves,
                               chunk=a.chunk, reps=a.reps, widths=widths,
                               device=a.device)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
