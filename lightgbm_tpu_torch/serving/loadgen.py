"""Threaded mixed-shape load generator for the serving path (counterpart of
``lightgbm_tpu/serving/loadgen.py``).

It fires, optionally verifies bit equality, and reports completed
counts and client-side latencies; it is not a benchmark harness.
**Shadow mode**: a ``mirror_fraction`` sample of live requests is
replayed against a candidate server, and the summary's ``shadow``
section reports the raw-score drift and latency deltas, counted apart
from the live path.  ``fire_fleet_requests`` drives a ``fleet.Fleet``
or ``fleet.PodFleet`` with a weighted mix of models, counting typed
sheds, expiries and failures and the availability they leave.
"""

from __future__ import annotations

import threading
import time
from typing import Optional

import numpy as np


def expected_answer(model, Xr: np.ndarray) -> np.ndarray:
    """A CompiledModel's host float64 answer for ``Xr``, shaped as the
    server returns raw scores."""
    raw = model.scale_raw(model.forest.predict_raw(
        Xr, num_class=model.num_class))
    return raw[0] if model.num_class == 1 else raw.T


def fire_requests(server, n_requests: int, n_threads: int,
                  max_request_rows: int, num_features: int,
                  verify_forest=None, timeout: float = 300.0,
                  shadow_server=None, mirror_fraction: float = 0.25,
                  seed: int = 100, verify_models=None) -> dict:
    """Fire ``n_requests`` (rounded down to a multiple of ``n_threads``)
    mixed-size requests of float32-precise rows (1 to
    ``max_request_rows`` each) from ``n_threads`` threads; return
    completed and row counts, wall time, client latencies and
    per-thread errors.

    ``verify_forest``: every response must equal
    ``verify_forest.predict_raw(X)[0]`` bit for bit (a one-class model).
    ``verify_models``: CompiledModels (``server.models.active`` at
    various times); every response must equal, bit for bit, the host
    float64 answer of the model its request was admitted against (the
    future's ``model_digest``), which holds through a hot-swap.

    ``QueueFull`` sheds and ``DeadlineExceeded`` expiries are counted
    (``shed`` / ``expired``), not treated as errors.  With
    ``shadow_server`` a ``mirror_fraction`` sample of completed requests
    is also sent to the candidate; its drift, latencies, non-finite
    outputs and errors land in the ``shadow`` section.
    """
    from .errors import DeadlineExceeded, QueueFull

    by_digest = ({m.digest: m for m in verify_models}
                 if verify_models is not None else None)
    per_thread = n_requests // n_threads
    done = [0] * n_threads
    rows_served = [0] * n_threads
    lock = threading.Lock()
    mismatches: list = []
    errors: list = []
    digests: dict = {}
    live = {"shed": 0, "expired": 0, "lat_ms": []}
    shadow = {"mirrored": 0, "drift": [], "lat_ms": [], "lat_delta_ms": [],
              "nonfinite": 0, "errors": []}

    def mirror(tidx: int, Xr, out, live_lat: float) -> None:
        t0 = time.perf_counter()
        try:
            cand = shadow_server.predict(Xr, timeout=timeout)
        except Exception as e:  # candidate evidence, not a live error
            with lock:
                shadow["mirrored"] += 1
                shadow["errors"].append(
                    f"thread {tidx}: {type(e).__name__}: {str(e)[:200]}")
            return
        lat = (time.perf_counter() - t0) * 1e3
        cand = np.asarray(cand, np.float64)
        finite = bool(np.isfinite(cand).all())
        with lock:
            shadow["mirrored"] += 1
            shadow["lat_ms"].append(lat)
            shadow["lat_delta_ms"].append(lat - live_lat)
            if finite:
                shadow["drift"].append(float(np.max(np.abs(
                    cand - np.asarray(out, np.float64)))))
            else:
                shadow["nonfinite"] += 1

    def worker(tidx: int) -> None:
        r = np.random.RandomState(seed + tidx)
        try:
            for _ in range(per_thread):
                m = int(r.randint(1, max_request_rows + 1))
                Xr = r.randn(m, num_features).astype(np.float32) \
                    .astype(np.float64)
                do_mirror = (shadow_server is not None
                             and r.rand() < mirror_fraction)
                t0 = time.perf_counter()
                try:
                    fut = server.submit(Xr)
                    out = fut.result(timeout)
                except QueueFull:
                    with lock:
                        live["shed"] += 1
                    continue
                except DeadlineExceeded:
                    with lock:
                        live["expired"] += 1
                    continue
                lat = (time.perf_counter() - t0) * 1e3
                rows_served[tidx] += m
                done[tidx] += 1
                digest = getattr(fut, "model_digest", None)
                with lock:
                    live["lat_ms"].append(lat)
                    digests[digest] = digests.get(digest, 0) + 1
                if verify_forest is not None and not np.array_equal(
                        out, verify_forest.predict_raw(Xr)[0]):
                    mismatches.append((tidx, m))
                if by_digest is not None and (
                        digest not in by_digest or not np.array_equal(
                            out, expected_answer(by_digest[digest], Xr))):
                    mismatches.append((tidx, m, digest))
                if do_mirror:
                    mirror(tidx, Xr, out, lat)
        except Exception as e:  # a dead thread must not bank clean numbers
            errors.append(f"thread {tidx}: {type(e).__name__}: {str(e)[:200]}")

    t0 = time.perf_counter()
    threads = [threading.Thread(target=worker, args=(i,))
               for i in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        # each request waits at most ``timeout``: a thread outliving all
        # of its requests' waits has hung
        t.join(timeout * (per_thread + 1))
        if t.is_alive():
            errors.append(f"{t.name}: still running after its requests' "
                          "timeouts")
    out = {
        "requests": sum(done),
        "requests_planned": per_thread * n_threads,
        "rows": sum(rows_served),
        "shed": live["shed"],
        "expired": live["expired"],
        "wall_seconds": time.perf_counter() - t0,
        "latency_ms": _latency_summary(live["lat_ms"]),
        "model_digests": digests,
        "mismatches": mismatches,
        "errors": errors,
    }
    if shadow_server is not None:
        drift = np.asarray(shadow["drift"], np.float64)
        out["shadow"] = {
            "mirrored": shadow["mirrored"],
            "drift_max": (round(float(drift.max()), 6)
                          if drift.size else None),
            "drift_mean": (round(float(drift.mean()), 6)
                           if drift.size else None),
            "nonfinite": shadow["nonfinite"],
            "latency_ms": _latency_summary(shadow["lat_ms"]),
            "latency_delta_ms": _latency_summary(shadow["lat_delta_ms"]),
            "errors": shadow["errors"],
        }
    return out


def _latency_summary(lat_ms: list) -> dict:
    """p50/p90/p99 + mean/max of client-measured latencies (exact
    percentiles over the sample, not histogram-bucket interpolation)."""
    if not lat_ms:
        return {"count": 0}
    a = np.asarray(lat_ms, np.float64)
    return {
        "count": int(a.size),
        "mean": round(float(a.mean()), 3),
        "p50": round(float(np.percentile(a, 50)), 3),
        "p90": round(float(np.percentile(a, 90)), 3),
        "p99": round(float(np.percentile(a, 99)), 3),
        "max": round(float(a.max()), 3),
    }


def fire_fleet_requests(fleet, mix: dict, n_requests: int, n_threads: int,
                        max_request_rows: int, verify: Optional[dict] = None,
                        timeout: float = 300.0, seed: int = 100) -> dict:
    """Multi-model traffic storm against a ``fleet.Fleet`` or
    ``fleet.PodFleet``.

    ``mix`` maps model name -> traffic weight: every request picks its
    model by weighted draw (one mixed workload, not N single-model
    storms).  Sheds
    (``QueueFull`` — the fleet's weighted-admission or brownout
    verdict) and deadline expiries (``DeadlineExceeded`` — the model's
    SLO class rejecting queue-aged work) are counted per model, NOT as
    errors: under deliberate overload both are the correct, typed
    behavior.  Any OTHER per-request failure is a typed-``failed``
    outcome — counted, recorded, and the storm continues, so a failover
    drill measures exactly how many requests a lost device cost instead
    of losing a whole thread's numbers.  ``verify`` maps model name ->
    ``StackedForest``; every verified response must be bit-equal to its
    ``predict_raw`` (the serving contract; for a low-precision model pass
    its quantized forest).

    The summary carries per-model request/row counts, CLIENT-measured
    latency percentiles, per-outcome counts (``outcomes``:
    completed/shed/expired/failed), and **availability** = 1 −
    failed / (completed + failed) — typed shed/expired excluded from
    both sides, because rejecting work you cannot serve on time is
    correct behavior, not unavailability (None before any non-typed
    outcome).
    """
    from .errors import DeadlineExceeded, QueueFull

    names = sorted(mix)
    w = np.asarray([float(mix[n]) for n in names], np.float64)
    p = w / w.sum()
    feats = {n: fleet.entry(n).model.num_features for n in names}
    classes = {n: fleet.entry(n).model.num_class for n in names}
    per_thread = n_requests // n_threads
    lock = threading.Lock()
    per_model = {n: {"requests": 0, "rows": 0, "shed": 0, "expired": 0,
                     "failed": 0, "lat_ms": [], "mismatches": 0}
                 for n in names}
    errors: list = []
    failures: list = []

    def worker(tidx: int) -> None:
        r = np.random.RandomState(seed + tidx)
        try:
            for _ in range(per_thread):
                name = names[int(r.choice(len(names), p=p))]
                m = int(r.randint(1, max_request_rows + 1))
                Xr = r.randn(m, feats[name]).astype(np.float32) \
                    .astype(np.float64)
                t0 = time.perf_counter()
                try:
                    out = fleet.predict(name, Xr, timeout=timeout)
                except QueueFull:
                    with lock:
                        per_model[name]["shed"] += 1
                    continue
                except DeadlineExceeded:
                    with lock:
                        per_model[name]["expired"] += 1
                    continue
                except Exception as e:  # noqa: BLE001 — a failed request
                    with lock:          # is an OUTCOME, not a dead thread
                        per_model[name]["failed"] += 1
                        failures.append(
                            f"thread {tidx} [{name}]: "
                            f"{type(e).__name__}: {str(e)[:200]}")
                    continue
                lat = (time.perf_counter() - t0) * 1e3
                ok = True
                if verify is not None and name in verify:
                    K = classes[name]
                    ref = verify[name].predict_raw(Xr, num_class=K)
                    ok = np.array_equal(out, ref[0] if K == 1 else ref.T)
                with lock:
                    s = per_model[name]
                    s["requests"] += 1
                    s["rows"] += m
                    s["lat_ms"].append(lat)
                    if not ok:
                        s["mismatches"] += 1
        except Exception as e:  # a dead thread must not bank clean numbers
            errors.append(
                f"thread {tidx}: {type(e).__name__}: {str(e)[:200]}")

    t0 = time.perf_counter()
    threads = [threading.Thread(target=worker, args=(i,))
               for i in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0

    def availability(completed: int, failed: int):
        return (None if completed + failed == 0
                else round(1.0 - failed / (completed + failed), 6))

    models_out = {}
    for n in names:
        s = per_model[n]
        models_out[n] = {
            "weight": float(mix[n]),
            "requests": s["requests"],
            "rows": s["rows"],
            "shed": s["shed"],
            "expired": s["expired"],
            "failed": s["failed"],
            "availability": availability(s["requests"], s["failed"]),
            "mismatches": s["mismatches"],
            "latency_ms": _latency_summary(s["lat_ms"]),
        }
    completed = sum(s["requests"] for s in per_model.values())
    failed = sum(s["failed"] for s in per_model.values())
    shed = sum(s["shed"] for s in per_model.values())
    expired = sum(s["expired"] for s in per_model.values())
    return {
        "requests": completed,
        "requests_planned": per_thread * n_threads,
        "rows": sum(s["rows"] for s in per_model.values()),
        "shed": shed,
        "expired": expired,
        "failed": failed,
        "outcomes": {"completed": completed, "shed": shed,
                     "expired": expired, "failed": failed},
        "availability": availability(completed, failed),
        # client latencies over every model (the JAX summary has only the
        # per-model ones)
        "latency_ms": _latency_summary(
            [v for s in per_model.values() for v in s["lat_ms"]]),
        "mismatches": sum(s["mismatches"] for s in per_model.values()),
        "wall_seconds": wall,
        "errors": errors,
        "failures": failures,
        "models": models_out,
    }
