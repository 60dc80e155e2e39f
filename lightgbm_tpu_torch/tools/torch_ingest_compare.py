"""Time the PyTorch port's binning kernel (B3, ``ops/csrc/ingest.cu``) at
a training configuration's shape: ``--data onehot`` (default), the
airline table one-hot encoded as in ``airline_onehot_1m``, 1 M rows x
674 f32 features in EFB bundles; ``--data higgs``, 1 M x 28 as in
``higgs_train_1m``.  Run it once per checkout, with that checkout first
on ``sys.path``, to compare two commits on one card in one call (run
them as A, B, B, A):

    PYTHONPATH=<checkout> python3 -m lightgbm_tpu_torch.tools.torch_ingest_compare --label A

Prints one JSON line: the train Dataset's construct seconds, the host
seconds of the binner's set-up (its tables and plan) and of copying X to
the card, the kernel's mean time over ``--reps`` calls by CUDA events,
whether its output equals the plain version's, and the card's name and
power limit.  Needs a CUDA card; imports nothing of JAX."""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--label", required=True)
    ap.add_argument("--rows", type=int, default=1_000_000)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--data", choices=("onehot", "higgs"), default="onehot")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 1
    import lightgbm_tpu_torch as lt
    from lightgbm_tpu_torch.ops import ingest as ING
    from lightgbm_tpu_torch.testing import airline_like, higgs_like, one_hot

    if args.data == "higgs":
        X, y = higgs_like(args.rows, seed=11)
    else:
        X8, y = airline_like(args.rows, seed=11)
        X = one_hot(X8)
        del X8
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ds = lt.Dataset(X, label=y)
    ds.construct()
    torch.cuda.synchronize()
    construct_s = time.perf_counter() - t0

    tables = ING.build_ingest_tables(ds)
    t0 = time.perf_counter()
    binner = ING.DeviceBinner(tables, "cuda")
    if hasattr(binner, "kernel_state"):    # older checkouts lack it
        binner.kernel_state()
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    Xt = torch.from_numpy(X).cuda()
    torch.cuda.synchronize()
    copy_s = time.perf_counter() - t0

    got = binner(Xt)
    equal = bool(torch.equal(got, binner.plain(Xt)))
    del got
    for _ in range(2):
        binner(Xt)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(args.reps):
        binner(Xt)
    end.record()
    torch.cuda.synchronize()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(json.dumps({
        "label": args.label, "data": args.data, "rows": X.shape[0],
        "features": X.shape[1],
        "groups": tables.num_groups, "construct_s": construct_s,
        "binner_setup_s": setup_s, "copy_x_s": copy_s,
        "kernel_ms": start.elapsed_time(end) / args.reps,
        "equal_to_plain": equal, "card": smi.strip()}), flush=True)
    return 0 if equal else 1


if __name__ == "__main__":
    sys.exit(main())
