"""Sharded training over W processes started the way a user starts them:
``parallel.network.init_network`` from a machine list.

    python3 -m lightgbm_tpu_torch.tools.torch_dist_check [--world 4]
        [--backend nccl] [--device cuda] [--rows 1000000] [--rounds 3]
        [--leaves 255] [--timeout 600]

Spawns ``world`` processes.  Rank r takes ``cuda:r`` (or the CPU), calls
``init_network(machines="localhost:p0,...,localhost:pW", local_listen_
port=p_r, num_machines=W, backend=...)``, so its rank is its place in
the list and the default group is the one training finds
(``current_group``); then it builds ``testing.higgs_like(rows, seed=11)``
on its device and trains ``rounds`` rounds of ``leaves`` leaves:
serially (the rounds grower, then the serial grower), then data-,
quantized data-, feature- and voting-parallel (top_k = the feature
count).  Each rank's data, feature and voting model texts must equal
its serial twins' (the rounds grower's for data, the serial grower's
for the others), and every rank's quantized text the others' (the rank
folds into the rounding key).  Prints one JSON line: seconds a tree of
each mode on each rank, the check, the backend, and the cards' names
and power limit.  Exits non-zero when a rank fails or a text differs.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import shutil
import socket
import subprocess
import sys
import tempfile
import time

import torch

MODES = ("data", "data_quant", "feature", "voting")


def _free_ports(count: int) -> list:
    socks = [socket.socket() for _ in range(count)]
    try:
        for s in socks:
            s.bind(("localhost", 0))
        return [s.getsockname()[1] for s in socks]
    finally:
        for s in socks:
            s.close()


def _params(mode: str, leaves: int, features: int) -> dict:
    p = {"objective": "binary", "num_leaves": leaves, "max_bin": 255,
         "learning_rate": 0.1, "verbose": -1}
    if mode == "serial_rounds":
        return p
    if mode == "serial_grower":
        return dict(p, tpu_tree_growth="serial")
    if mode == "data":
        return dict(p, tree_learner="data")
    if mode == "data_quant":
        return dict(p, tree_learner="data", use_quantized_grad=True)
    return dict(p, tpu_tree_growth="serial", tree_learner=mode,
                top_k=features)


def _worker(rank, args, ports, out_dir):
    import lightgbm_tpu_torch as lt
    from lightgbm_tpu_torch.parallel.network import free_network, init_network
    from lightgbm_tpu_torch.testing import higgs_like
    device = torch.device(args.device, rank) if args.device == "cuda" \
        else torch.device("cpu")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    else:
        torch.set_num_threads(1)       # W ranks share the host's cores
    init_network(machines=",".join(f"localhost:{p}" for p in ports),
                 local_listen_port=ports[rank], num_machines=args.world,
                 listen_time_out=args.timeout, backend=args.backend)
    import torch.distributed as dist
    X, y = higgs_like(args.rows, seed=11)
    ds = lt.Dataset(X, label=y, device=device).construct()
    texts, seconds = {}, {}
    for mode in ("serial_rounds", "serial_grower") + MODES:
        dist.barrier()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        bst = lt.train(_params(mode, args.leaves, X.shape[1]), ds,
                       args.rounds, verbose_eval=False)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        seconds[mode] = (time.perf_counter() - t0) / args.rounds
        want = ("serial" if mode.startswith("serial")
                else mode.replace("_quant", ""))
        if bst.boosting.tree_learner_type != want:
            raise AssertionError(f"rank {rank}: {mode} trained as "
                                 f"{bst.boosting.tree_learner_type}")
        texts[mode] = bst.model_to_string().partition("parameters:")[0]
    free_network()
    twin = {"data": "serial_rounds", "feature": "serial_grower",
            "voting": "serial_grower"}
    out = {"rank": rank, "device": str(device), "seconds": seconds,
           "equal_to_serial": {m: texts[m] == texts[t]
                               for m, t in twin.items()},
           "digests": {m: hashlib.sha256(t.encode()).hexdigest()
                       for m, t in texts.items()}}
    with open(os.path.join(out_dir, f"rank_{rank}.json"), "w") as f:
        json.dump(out, f)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--world", type=int, default=4)
    ap.add_argument("--backend", default="nccl")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--rows", type=int, default=1_000_000)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--leaves", type=int, default=255)
    ap.add_argument("--timeout", type=int, default=600)
    args = ap.parse_args(argv)
    import torch.multiprocessing as torch_mp
    ports = _free_ports(args.world)
    out_dir = tempfile.mkdtemp(prefix="lgbt-dist-check-")
    try:
        ctx = torch_mp.start_processes(_worker, args=(args, ports, out_dir),
                                       nprocs=args.world, join=False,
                                       start_method="spawn")
        deadline = time.perf_counter() + args.timeout
        while not ctx.join(timeout=5):
            if time.perf_counter() > deadline:
                for p in ctx.processes:
                    p.terminate()
                raise TimeoutError(f"the ranks ran past {args.timeout} s")
        ranks = []
        for r in range(args.world):
            with open(os.path.join(out_dir, f"rank_{r}.json")) as f:
                ranks.append(json.load(f))
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    agree = {m: len({rk["digests"][m] for rk in ranks}) == 1
             for m in ("serial_rounds", "serial_grower") + MODES}
    ok = all(agree.values()) and all(
        all(rk["equal_to_serial"].values()) for rk in ranks)
    smi = ""
    if args.device == "cuda":
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()
    print(json.dumps({
        "world": args.world, "backend": args.backend, "rows": args.rows,
        "rounds": args.rounds, "num_leaves": args.leaves,
        "s_per_tree": {m: [rk["seconds"][m] for rk in ranks]
                       for m in ("serial_rounds", "serial_grower") + MODES},
        "equal_to_serial": [rk["equal_to_serial"] for rk in ranks],
        "ranks_agree": agree, "ok": ok,
        "devices": [rk["device"] for rk in ranks],
        "nvidia_smi": smi.splitlines()}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
