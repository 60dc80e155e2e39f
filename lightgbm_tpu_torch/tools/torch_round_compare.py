"""Seconds a tree of the round loop on one card, in variants run in the
order A B B A (host clocks spread between calls).

    python3 -m lightgbm_tpu_torch.tools.torch_round_compare [--rows N]
        [--trees T] [--lags 1,2] [--configs higgs,onehot]

For each configuration (``higgs``: ``testing.higgs_like`` 1 M x 28,
binary, 255 leaves; ``onehot``: the airline table one-hot, EFB, the
staged arm) it builds one ``Dataset`` and trains fresh boosters of
``T`` trees through ``Booster.update()`` with ``grower_rounds.STOP_LAG``
set to each lag (the round graph), and once eagerly
(``grower_rounds.USE_GRAPHS = False``, the first lag).  Each run's
model text must equal the first's.  Prints one JSON line a
configuration: seconds a tree of each run after its first tree (which
captures the graph), the dead rounds a tree, and the card's name and
power limit.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import torch


def _trees(lt, ds, params, trees, lag, graphs):
    from lightgbm_tpu_torch import grower_rounds
    saved = grower_rounds.STOP_LAG, grower_rounds.USE_GRAPHS
    grower_rounds.STOP_LAG, grower_rounds.USE_GRAPHS = lag, graphs
    try:
        b = lt.Booster(params, train_set=ds)
        b.update()                     # the first tree captures the graph
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(trees - 1):
            b.update()
        torch.cuda.synchronize()
        s = (time.perf_counter() - t0) / (trees - 1)
    finally:
        grower_rounds.STOP_LAG, grower_rounds.USE_GRAPHS = saved
    g = b.boosting.grower
    dead = [ran - int(live) for ran, live in g.round_counts]
    return s, dead, b.model_to_string()


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=int, default=1_000_000)
    ap.add_argument("--trees", type=int, default=9)
    ap.add_argument("--lags", default="1,2")
    ap.add_argument("--configs", default="higgs,onehot")
    a = ap.parse_args()
    import lightgbm_tpu_torch as lt
    from lightgbm_tpu_torch.testing import airline_like, higgs_like, one_hot
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    params = {"objective": "binary", "num_leaves": 255, "max_bin": 255,
              "verbose": -1}
    lags = [int(x) for x in a.lags.split(",")]
    for config in a.configs.split(","):
        if config == "higgs":
            X, y = higgs_like(a.rows, seed=11)
        else:
            X8, y = airline_like(a.rows, seed=11)
            X = one_hot(X8)
        ds = lt.Dataset(X, label=y)
        ds.construct()
        del X
        runs = [("graph", lag) for lag in lags]
        order = runs + runs[::-1] + [("eager", lags[0])]
        out, text = {}, None
        for kind, lag in order:
            s, dead, t = _trees(lt, ds, params, a.trees, lag,
                                kind == "graph")
            if text is None:
                text = t
            elif t != text:
                raise AssertionError(f"{config} {kind} lag {lag}: the "
                                     "model text differs")
            key = f"{kind}_lag{lag}"
            out.setdefault(key, {"s_per_tree": [], "dead_rounds": dead})
            out[key]["s_per_tree"].append(s)
        print(json.dumps({"config": config, "rows": a.rows,
                          "trees_timed": a.trees - 1, "card": smi, **out}),
              flush=True)


if __name__ == "__main__":
    main()
