"""Co-residency smoke: threaded traffic AND a continual refresh on the
same device set, behind the shared residency ledger (counterpart of
``tools/coresident_smoke.py``).  The last line of its standard output is
one JSON object.

Phases (each its own sub-dict of the summary):

* ``train``: train the deployed model; stand up a chaos-armed
  ``PodFleet`` (a scheduled ``device.delay`` window inflates batch
  latency mid-run: the contention the brownout guard must catch);
  lease the serving residency from the ledger;
* ``coresidency``: drive threaded traffic through the fleet while the
  ``coresident.Scheduler`` refreshes the model on the same devices; the
  brownout guards watch every replica's windowed p99 at a ceiling well
  below the serving SLO, the delay window forces at least one throttle,
  and the refreshed model hot-swaps in.

Bars (``failed`` True where one is missed): no untyped request
failure; the request p99 within the serving SLO; ``model_age_seconds``
dropped across the refresh; the throttle counter moved; the served
output bit-equal to the refreshed booster's (the serving contract's
host float64 sums).

Usage: python -m lightgbm_tpu_torch.tools.torch_coresident_smoke
[--rows 4000] [--trees 8] [--refresh-trees 6] [--requests 120]
[--device cpu]; exits 1 when a bar was missed.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import threading
import time

import numpy as np


def _make_data(rng, rows, features):
    X = rng.randn(rows, features).astype(np.float32).astype(np.float64)
    y = (X[:, 0] + X[:, 1] * X[:, 2] > 0).astype(float)
    return X, y


def run_smoke(rows=4000, trees=8, refresh_trees=6, features=10,
              leaves=15, requests=120, threads=4, max_request_rows=64,
              slo_ms=2000.0, brownout_ms=30.0, delay_s=0.12,
              directory=None, device=None) -> dict:
    """Run both phases; returns the summary dict.  ``device``: the CUDA
    card unless ``"cpu"``."""
    import lightgbm_tpu_torch as lt
    from ..coresident import CoresidentConfig, Scheduler
    from ..obs.flight import global_flight
    from ..obs.watchdog import global_watchdog
    from ..ops.planner import ResidencyLedger
    from ..resilience.faults import ChaosRegistry, FaultSpec
    from ..serving.errors import DeadlineExceeded, QueueFull

    own_tmp = None
    if directory is None:
        own_tmp = tempfile.TemporaryDirectory(prefix="lgbt_coresident_")
        directory = own_tmp.name
    # the delay window breaches a brownout guard on purpose, so a run
    # dumps a bundle: keep it out of the working directory
    prev_flight_dir = global_flight._out_dir
    global_flight._out_dir = directory
    summary = {"rows": rows, "trees": trees, "phases": {}}
    rng = np.random.RandomState(0)
    params = {"objective": "binary", "verbosity": -1, "num_leaves": leaves}

    # ------------------------------------------------------------ train
    X, y = _make_data(rng, rows, features)
    base_ds = lt.Dataset(X, label=y, free_raw_data=False, device=device)
    deployed = lt.train(params, base_ds, trees, verbose_eval=False)
    dev = base_ds.device
    # batches 4..23 of every device each stall delay_s, then succeed:
    # contention, not failure
    chaos = ChaosRegistry([FaultSpec(site="device", kind="delay", at=i,
                                     arg=delay_s) for i in range(4, 24)])
    fleet = lt.PodFleet(devices=2, chaos=chaos, max_batch_rows=256,
                        device=dev)
    sched = None
    serving_lease = None
    try:
        fleet.add_model("live", deployed)
        fleet.warm()
        global_watchdog.watch_freshness("live")
        global_watchdog.mark_fresh("live")
        ledger = ResidencyLedger(limit_bytes=1 << 30)
        cfg = CoresidentConfig(brownout_p99_ms=brownout_ms,
                               throttle_delay_s=0.01, recovery_s=0.3,
                               escalate_s=30.0,     # throttle only
                               poll_interval_s=0.02)
        sched = Scheduler(fleet=fleet, ledger=ledger, config=cfg,
                          workdir=os.path.join(directory, "work"))
        serving_lease = sched.lease_serving_residency()
        guards = sched.guard_fleet()
        summary["phases"]["train"] = {
            "iterations": deployed.current_iteration(),
            "devices": fleet.live_devices(), "guards": guards,
            "serving_lease_bytes": (serving_lease.nbytes
                                    if serving_lease else 0),
            "ledger": ledger.summary()}

        # ------------------------------------------------- coresidency
        lat_ms, typed, untyped = [], [], []
        stop = threading.Event()

        def worker(tidx):
            r = np.random.RandomState(1000 + tidx)
            for _ in range(requests // threads):
                m = int(r.randint(1, max_request_rows + 1))
                Xr = r.randn(m, features).astype(np.float32).astype(
                    np.float64)
                t0 = time.perf_counter()
                try:
                    fleet.predict("live", Xr, timeout=120)
                    lat_ms.append((time.perf_counter() - t0) * 1e3)
                except (QueueFull, DeadlineExceeded) as e:
                    typed.append(type(e).__name__)
                except Exception as e:  # noqa: BLE001 - a bar counts them
                    untyped.append(repr(e)[:200])
                if stop.is_set():
                    break
                time.sleep(0.002)

        ts = [threading.Thread(target=worker, args=(i,), daemon=True)
              for i in range(threads)]
        for t in ts:
            t.start()
        time.sleep(0.3)     # traffic and the delay window first
        age_before = global_watchdog.model_age_s("live")
        Xf, yf = _make_data(rng, rows // 2, features)
        fresh = lt.Dataset(Xf, label=yf, free_raw_data=False, device=dev)
        t0 = time.perf_counter()
        booster, stats = sched.refresh("live", fresh, params,
                                       refresh_trees, init_model=deployed)
        refresh_s = time.perf_counter() - t0
        age_after = global_watchdog.model_age_s("live")
        for t in ts:
            t.join(120)
        stop.set()
        probe = X[:128]
        served = fleet.predict("live", probe, timeout=120)
        ref = booster.predict(probe, raw_score=True, device=False)
        p99 = (float(np.percentile(np.array(lat_ms), 99))
               if lat_ms else None)
        sstats = sched.stats()
        summary["phases"]["coresidency"] = {
            "requests_ok": len(lat_ms), "typed_failures": len(typed),
            "untyped_failures": untyped,
            "p99_ms": round(p99, 2) if p99 is not None else None,
            "slo_ms": slo_ms, "throttles": sstats["throttles"],
            "pauses": sstats["pauses"],
            "scheduler_state": sstats["state"],
            "chunk_cap": stats["chunk_cap"],
            "refresh_seconds": round(refresh_s, 3),
            "refreshed_iterations": booster.current_iteration(),
            "served_bit_equal_refreshed": bool(np.array_equal(served, ref)),
            "model_age_before_s": (round(age_before, 3)
                                   if age_before is not None else None),
            "model_age_after_s": (round(age_after, 3)
                                  if age_after is not None else None)}
    finally:
        if sched is not None:
            sched.close()
            if serving_lease is not None:
                sched.ledger.release(serving_lease)
        fleet.close()
        global_watchdog.unwatch("live")
        global_flight._out_dir = prev_flight_dir
    summary["phases"]["coresidency"]["flight_dumps"] = sorted(
        d for d in os.listdir(directory) if d.startswith("flight_"))
    if own_tmp is not None:
        own_tmp.cleanup()
    co = summary["phases"]["coresidency"]
    summary["phase_ok"] = {
        "no_untyped_failures": not untyped and len(lat_ms) > 0,
        "p99_within_slo": p99 is not None and p99 <= slo_ms,
        "model_age_dropped": (age_before is not None
                              and age_after is not None
                              and age_after < age_before),
        "throttled": sstats["throttles"] > 0,
        "swap_bit_equal": co["served_bit_equal_refreshed"]}
    summary["failed"] = not all(summary["phase_ok"].values())
    return summary


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rows", type=int, default=4000)
    ap.add_argument("--trees", type=int, default=8)
    ap.add_argument("--refresh-trees", type=int, default=6)
    ap.add_argument("--features", type=int, default=10)
    ap.add_argument("--requests", type=int, default=120)
    ap.add_argument("--threads", type=int, default=4)
    ap.add_argument("--max-request-rows", type=int, default=64)
    ap.add_argument("--slo-ms", type=float, default=2000.0)
    ap.add_argument("--brownout-ms", type=float, default=30.0)
    ap.add_argument("--dir", default=None,
                    help="work directory (default: a temporary one)")
    ap.add_argument("--device", default=None)
    a = ap.parse_args(argv)
    summary = run_smoke(
        rows=a.rows, trees=a.trees, refresh_trees=a.refresh_trees,
        features=a.features, requests=a.requests, threads=a.threads,
        max_request_rows=a.max_request_rows, slo_ms=a.slo_ms,
        brownout_ms=a.brownout_ms, directory=a.dir, device=a.device)
    print(json.dumps(summary, sort_keys=True, default=str))
    return 1 if summary["failed"] else 0


if __name__ == "__main__":
    raise SystemExit(main())
