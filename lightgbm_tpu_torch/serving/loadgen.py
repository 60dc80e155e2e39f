"""Threaded mixed-shape load generator for the serving path (counterpart of
``lightgbm_tpu/serving/loadgen.py``).

It fires, optionally verifies bit equality, and reports completed
counts and client-side latencies; it is not a benchmark harness.
**Shadow mode**: a ``mirror_fraction`` sample of live requests is
replayed against a candidate server, and the summary's ``shadow``
section reports the raw-score drift and latency deltas, counted apart
from the live path.  The JAX package's ``fire_fleet_requests`` drives
its serving fleet (ROADMAP queue A6).
"""

from __future__ import annotations

import threading
import time

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
