"""Lifecycle smoke: train -> continual refresh -> guarded promotion ->
forced rollback (counterpart of ``tools/lifecycle_smoke.py``).  The
last line of its standard output is one JSON object.

Phases (each its own sub-dict of the summary):

* ``train``: train the deployed model, serve it as the fleet's ``live``
  entry;
* ``promote``: warm-start a candidate over fresh rows on the deployed
  bin grid (``lifecycle.refresh``), bank its sha256 bundle, then drive
  the guarded rollout under threaded traffic (probe quarantine ->
  shadow mirror -> staged canary ramp -> probed cutover); the bar is a
  clean promotion with the fleet serving the candidate bit-identically
  (the serving contract's host float64 sums) and ``model_age_seconds``
  reset;
* ``rollback``: refresh again and promote under an impossible drift
  budget: the rollout must roll back, the fleet's output must be
  byte-identical to the pre-promotion model's, and a flight bundle
  naming the ``drift`` gate must exist;
* ``shadow``: ``serving.loadgen``'s shadow mode against two servers:
  mirrored count, measured drift, honest live accounting.

Usage: python -m lightgbm_tpu_torch.tools.torch_lifecycle_smoke
[--rows 6000] [--trees 10] [--refresh-trees 4] [--requests 96]
[--device cpu]; exits 1 when a bar was missed.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import threading

import numpy as np


def _make_data(rng, rows, features):
    X = rng.randn(rows, features).astype(np.float32).astype(np.float64)
    y = (X[:, 0] + X[:, 1] * X[:, 2] > 0).astype(float)
    return X, y


def _loadgen_traffic(requests, threads, rows):
    """A ``promote`` traffic driver: threaded mixed-size requests
    through the controller (every join with a timeout)."""

    def drive(controller, phase, fraction):
        F = controller.fleet.entry(controller.live_name).model.num_features

        def worker(tidx):
            r = np.random.RandomState(1000 + tidx)
            for _ in range(requests // threads):
                m = int(r.randint(1, rows + 1))
                Xr = r.randn(m, F).astype(np.float32).astype(np.float64)
                controller.predict(Xr, timeout=120)

        ts = [threading.Thread(target=worker, args=(i,), daemon=True)
              for i in range(threads)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(300)

    return drive


def run_smoke(rows=6000, trees=10, refresh_trees=4, features=10,
              leaves=15, requests=96, threads=4, max_request_rows=64,
              directory=None, device=None) -> dict:
    """Run every phase; returns the summary dict (``failed`` True where a
    bar was missed).  ``device``: the CUDA card unless ``"cpu"``."""
    import lightgbm_tpu_torch as lt
    from ..lifecycle import LifecycleConfig, LifecycleController
    from ..obs.flight import global_flight
    from ..obs.watchdog import global_watchdog
    from ..serving.loadgen import fire_requests

    own_tmp = None
    if directory is None:
        own_tmp = tempfile.TemporaryDirectory(prefix="lgbt_lifecycle_")
        directory = own_tmp.name
    summary = {"rows": rows, "trees": trees, "phases": {}}
    rng = np.random.RandomState(0)
    params = {"objective": "binary", "verbosity": -1, "num_leaves": leaves}

    # ------------------------------------------------------------ train
    X, y = _make_data(rng, rows, features)
    base_ds = lt.Dataset(X, label=y, free_raw_data=False, device=device)
    deployed = lt.train(params, base_ds, trees, verbose_eval=False)
    dev = base_ds.device
    fleet = lt.Fleet(max_batch_rows=256, device=dev)
    # the rollout's gates judge latency; no queue deadline expires a
    # request of the smoke on a loaded host
    fleet.add_model("live", deployed, deadline_class="batch")
    fleet.warm()
    summary["phases"]["train"] = {
        "iterations": deployed.current_iteration(),
        "live_digest": fleet.entry("live").model.digest}
    probe = X[:256]
    traffic = _loadgen_traffic(requests, threads, max_request_rows)

    # ---------------------------------------------------------- promote
    ctl = LifecycleController(
        fleet, "live", directory=f"{directory}/ok", device=dev,
        config=LifecycleConfig(drift_budget=50.0, mirror_fraction=0.5,
                               ramp=(0.25, 0.5)))
    Xf, yf = _make_data(rng, rows // 2, features)
    bundle, cand = ctl.refresh(Xf, yf, params=params,
                               num_boost_round=refresh_trees)
    res = ctl.promote(bundle, probe_X=probe, traffic=traffic)
    ref = cand.predict(probe, raw_score=True, device=False)
    served = fleet.predict("live", probe, timeout=120)
    age = global_watchdog.model_age_s("live")
    summary["phases"]["promote"] = {
        "status": res["status"],
        "candidate_iterations": cand.current_iteration(),
        "shadow": res["phases"].get("shadow"),
        "ramp": res["phases"].get("ramp"),
        "served_bit_equal_candidate": bool(np.array_equal(served, ref)),
        "model_age_seconds": round(age, 3) if age is not None else None}
    promote_ok = (res["status"] == "promoted"
                  and summary["phases"]["promote"]
                  ["served_bit_equal_candidate"]
                  and age is not None and age < 300.0)

    # --------------------------------------------------------- rollback
    pre = fleet.predict("live", probe, timeout=120)

    def _flight_listing():
        try:
            return set(os.listdir(global_flight.out_dir()))
        except OSError:
            return set()

    before_dumps = _flight_listing()
    ctl2 = LifecycleController(
        fleet, "live", directory=f"{directory}/bad", device=dev,
        config=LifecycleConfig(drift_budget=1e-12, mirror_fraction=1.0))
    Xg, yg = _make_data(rng, rows // 2, features)
    bundle2, _ = ctl2.refresh(Xg, yg, params=params,
                              num_boost_round=refresh_trees, base=base_ds)
    res2 = ctl2.promote(bundle2, probe_X=probe, traffic=traffic)
    post = fleet.predict("live", probe, timeout=120)
    new_dumps = [d for d in _flight_listing()
                 if d not in before_dumps and "lifecycle" in d]
    summary["phases"]["rollback"] = {
        "status": res2["status"], "gate": res2.get("gate"),
        "bit_identical_after_rollback": bool(np.array_equal(pre, post)),
        "flight_dumps": sorted(new_dumps)}
    rollback_ok = (res2["status"] == "rolled_back"
                   and res2.get("gate") == "drift"
                   and summary["phases"]["rollback"]
                   ["bit_identical_after_rollback"]
                   and any("drift" in d for d in new_dumps))

    # ----------------------------------------------------------- shadow
    live_srv = deployed.serve(max_batch_rows=256)
    cand_srv = cand.serve(max_batch_rows=256)
    try:
        storm = fire_requests(live_srv, requests, threads,
                              max_request_rows, features, timeout=120,
                              shadow_server=cand_srv, mirror_fraction=0.5)
    finally:
        live_srv.close()
        cand_srv.close()
        fleet.close()
    sh = storm["shadow"]
    summary["phases"]["shadow"] = {
        "live_requests": storm["requests"], "mirrored": sh["mirrored"],
        "drift_max": sh["drift_max"],
        "latency_delta_ms_mean": sh["latency_delta_ms"].get("mean"),
        "errors": storm["errors"] + sh["errors"]}
    shadow_ok = (not storm["errors"] and not sh["errors"]
                 and storm["requests"] == storm["requests_planned"]
                 and sh["mirrored"] > 0 and sh["drift_max"] is not None)

    if own_tmp is not None:
        own_tmp.cleanup()
    summary["phase_ok"] = {"promote": promote_ok, "rollback": rollback_ok,
                           "shadow": shadow_ok}
    summary["failed"] = not (promote_ok and rollback_ok and shadow_ok)
    return summary


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rows", type=int, default=6000)
    ap.add_argument("--trees", type=int, default=10)
    ap.add_argument("--refresh-trees", type=int, default=4)
    ap.add_argument("--features", type=int, default=10)
    ap.add_argument("--requests", type=int, default=96)
    ap.add_argument("--threads", type=int, default=4)
    ap.add_argument("--max-request-rows", type=int, default=64)
    ap.add_argument("--dir", default=None,
                    help="bundle and journal directory (default: a "
                         "temporary one)")
    ap.add_argument("--device", default=None)
    a = ap.parse_args(argv)
    summary = run_smoke(
        rows=a.rows, trees=a.trees, refresh_trees=a.refresh_trees,
        features=a.features, requests=a.requests, threads=a.threads,
        max_request_rows=a.max_request_rows, directory=a.dir,
        device=a.device)
    print(json.dumps(summary, sort_keys=True, default=str))
    return 1 if summary["failed"] else 0


if __name__ == "__main__":
    raise SystemExit(main())
