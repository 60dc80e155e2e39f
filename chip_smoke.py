#!/usr/bin/env python3
"""Smoke run of lightgbm_tpu_torch on one NVIDIA card (sm_90a, an H100).

    python3 chip_smoke.py

Builds the CUDA traversal kernel from ``lightgbm_tpu_torch/ops/csrc`` with
``nvcc``, holds it against its plain PyTorch version on the card, then
serves a HIGGS-width model (28 features, 500 trees, 255 leaves, binary;
random leaf-wise trees from a seed) through ``Booster.serve()`` and
``Booster.predict()`` on the card.  Each phase prints one JSON line.
Any failed check raises, and the script exits non-zero; it exits
non-zero without a result where CUDA is absent or the package is
missing.  The last lines are the kernel table, the card's name and power
limit as ``nvidia-smi`` reports them, and
``{"ok": true, "device": {...}}``.
"""

import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import torch

# published H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and f32 FLOP/s
# outside the tensor cores; the card's power limit is printed beside them
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_PER_S = 67e12
# f32 operations per node visit: isnan, the NaN->0 select, |v| <= 1e-35,
# v <= threshold
OPS_PER_VISIT = 4
KERNEL = "fused_traverse"
# rows checked against the plain version (ragged tiles included) and the
# timed shapes: the serving buckets and one predict chunk
CHECK_ROWS = (8, 64, 1000, 1024, 65536 + 37)
TIMED_ROWS = (8, 64, 1024, 65536)
SERVE_REQUESTS, SERVE_THREADS, MAX_REQUEST_ROWS = 320, 8, 1500
PREDICT_ROWS = 100_000


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def event_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean time of ``fn`` over ``reps`` back-to-back calls from Python,
    by CUDA events after a warm-up: the device time plus whatever the
    host's launch rate leaves the card idle between calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps: int) -> float:
    """Mean device time of ``fn``: ``reps`` calls captured into one CUDA
    graph, replayed and timed by CUDA events, so no Python runs between
    launches.  The forest planes stay hot in L2, as they do for a server
    answering batch after batch."""
    fn()                                   # builds and loads the kernel
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / reps
    del graph
    torch.cuda.empty_cache()
    return ms


# node planes the traversal function reads (kernel_args' names)
PLANES = ("sf", "thr", "left", "right", "mt", "dl", "ic", "co", "cn")


def reads(pk, dev, X):
    """What the traversal function must read for this input, each item
    once: per plane, the (tree, node) entries some row's decision needs;
    the bitset words some categorical decision tests; the (tree, leaf)
    values reached; and the (tree, row, level) visits.

    A decision reads ``sf`` (and ``ic`` where the forest has categories);
    a numerical one reads ``mt``, then ``dl`` if the value is missing or
    ``thr`` if not; a categorical one reads ``cn``, ``co`` and, for a value
    inside the bitset, one word; every decision reads the child it takes."""
    p = pk.kernel_args(dev)
    has_cat = dev.forest.has_cat
    T, I = dev.split_feature.shape
    n = X.shape[0]
    need = {k: torch.zeros((T, I), dtype=torch.bool, device=X.device)
            for k in PLANES}
    word_need = torch.zeros(dev.cat_words.numel(), dtype=torch.bool,
                            device=X.device)
    node = torch.zeros((T, n), dtype=torch.int32, device=X.device)
    tid = torch.arange(T, device=X.device)[:, None].expand_as(node)
    rid = torch.arange(n, device=X.device)[None, :].expand_as(node)
    visits = 0
    for _ in range(max(int(dev.forest.max_depth), 1)):
        live = node >= 0
        if not bool(live.any()):
            break
        visits += int(live.sum())
        t, nd, r = tid[live], node[live].long(), rid[live]
        v = X[r, p["sf"][t, nd].long()]
        m = p["mt"][t, nd]
        nan = torch.isnan(v)
        fz = torch.where(nan & (m != 2), torch.zeros_like(v), v)
        missing = ((m == 1) & (fz.abs() <= pk.K_ZERO_F32)) | ((m == 2) & nan)
        cat = (p["ic"][t, nd] != 0) if has_cat else torch.zeros_like(nan)
        num = ~cat
        need["sf"][t, nd] = True
        if has_cat:
            need["ic"][t, nd] = True
        need["mt"][t[num], nd[num]] = True
        need["dl"][t[num & missing], nd[num & missing]] = True
        need["thr"][t[num & ~missing], nd[num & ~missing]] = True
        if has_cat and bool(cat.any()):
            need["co"][t[cat], nd[cat]] = True
            need["cn"][t[cat], nd[cat]] = True
            iv = torch.where(nan, torch.full_like(v, -1.0), v).trunc()
            iv = iv.clamp(-1.0, pk._CAT_IV_MAX).to(torch.int32)
            nw = p["cn"][t, nd]
            inside = cat & (iv >= 0) & (iv < nw * 32)
            widx = p["co"][t, nd] + torch.minimum(
                iv.clamp_min(0) // 32, (nw - 1).clamp_min(0))
            word_need[widx[inside].long()] = True
        nxt = pk.decide_step(node, X, **pk._planes(dev))
        went_left = nxt[live] == p["left"][t, nd]
        need["left"][t[went_left], nd[went_left]] = True
        need["right"][t[~went_left], nd[~went_left]] = True
        node = nxt
    leaf_need = torch.zeros(dev.leaf_value.shape, dtype=torch.bool,
                            device=X.device)
    leaf_need[tid, (~node).long()] = True
    entries = {k: int(v.sum()) for k, v in need.items()}
    return entries, int(word_need.sum()), int(leaf_need.sum()), visits


def bound(pk, dev, X, num_class, emit_scores):
    """Least time the card could take: the larger of bytes over HBM rate
    (X, the plane entries, bitset words and leaf values this input needs,
    and the output, each once) and f32 operations over the f32 rate."""
    n, F = X.shape
    T = dev.num_trees
    entries, words, leaves, visits = reads(pk, dev, X)
    nbytes = n * F * 4 + sum(entries.values()) * 4 + words * 4
    ops = visits * OPS_PER_VISIT
    if emit_scores:
        nbytes += leaves * 4 + max(num_class, 1) * n * 4
        ops += T * n
    else:
        nbytes += T * n * 4
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_F32_PER_S * 1e3
    return {"bytes": nbytes, "plane_entries": entries, "bitset_words": words,
            "ops": ops, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def check_kernel(pk, dev, X, K, host_forest=None):
    """Kernel vs plain version on the card, both modes; exact."""
    leaves = pk.fused_traverse(dev, X)
    plain = pk.traverse_plain(dev, X)
    torch.cuda.synchronize()
    if not torch.equal(leaves, plain):
        bad = int((leaves != plain).sum())
        raise AssertionError(f"leaf ids differ from the plain version at "
                             f"{bad} of {leaves.numel()} entries")
    if host_forest is not None:
        host = host_forest.predict_leaf(X.double().cpu().numpy())
        if not np.array_equal(leaves.cpu().numpy(), host.T):
            raise AssertionError("leaf ids differ from the host float64 path")
    scores = pk.fused_traverse(dev, X, K, emit_scores=True)
    plain_s = pk.traverse_plain(dev, X, K, emit_scores=True)
    torch.cuda.synchronize()
    if not torch.equal(scores.view(torch.int32), plain_s.view(torch.int32)):
        raise AssertionError("scores differ from the plain version in bits")
    return float((scores - plain_s).abs().max())


def phase_kernel(pk, models):
    """Correctness at ragged and bucket shapes; times at the serving
    buckets and a predict chunk."""
    from lightgbm_tpu_torch.testing import salt_rows, synthetic_rows
    rows = {}
    max_err = 0.0
    for name, (bst, F, cats, seed) in models.items():
        K = bst.num_tree_per_iteration
        forest = bst._forest(0, len(bst.models) // K)
        dev = bst._device_forest(forest)
        for n in CHECK_ROWS:
            X = salt_rows(synthetic_rows(F, n, cats, seed=seed, row_seed=n))
            Xt = torch.from_numpy(X.astype(np.float32)).cuda()
            err = check_kernel(pk, dev, Xt, K,
                               forest if n == CHECK_ROWS[2] and F < 100
                               else None)
            max_err = max(max_err, err)
        emit({"phase": "kernel", "forest": name, "rows": list(CHECK_ROWS),
              "checked": "exact", "max_abs_err": max_err})
        if F >= 100:
            continue          # the wide forest checks the big-tile path only
        for n_t in TIMED_ROWS:
            X = salt_rows(synthetic_rows(F, n_t, cats, seed=seed,
                                         row_seed=n_t + 1))
            Xt = torch.from_numpy(X.astype(np.float32)).cuda()
            for scores in (False, True):
                def kernel():
                    return pk.fused_traverse(dev, Xt, K, emit_scores=scores)

                def plain():
                    return pk.traverse_plain(dev, Xt, K, emit_scores=scores)

                reps_k = 50 if n_t <= 1024 else 10
                reps_p = 5 if n_t <= 1024 else 2
                b = bound(pk, dev, Xt, K, scores)
                row = {"phase": "kernel", "forest": name, "rows": n_t,
                       "mode": "scores" if scores else "leaves",
                       "trees": dev.num_trees, "features": F,
                       "kernel_ms": graph_ms(kernel, reps_k),
                       "kernel_event_ms": event_ms(kernel, reps_k),
                       "plain_ms": graph_ms(plain, reps_p),
                       "plain_event_ms": event_ms(plain, reps_p, warmup=1),
                       "library_ms": None, **b}
                rows[(name, n_t, scores)] = row
                emit(row)
    return rows, max_err


def phase_serve(pk, bst, F, seed):
    """The main path: Booster.serve() answering mixed-size requests from
    several threads, then Booster.predict() in scores mode."""
    from lightgbm_tpu_torch.testing import synthetic_rows
    forest = bst._forest(0, len(bst.models))
    rng = np.random.RandomState(seed)
    n_req, n_threads = SERVE_REQUESTS, SERVE_THREADS
    sizes = np.minimum(np.exp(rng.uniform(0, np.log(MAX_REQUEST_ROWS),
                                          n_req)).astype(int),
                       MAX_REQUEST_ROWS)
    sizes[:2] = [1, MAX_REQUEST_ROWS]
    X = synthetic_rows(F, int(sizes.sum()), seed=seed, row_seed=77)
    bounds = np.concatenate([[0], np.cumsum(sizes)])
    Xbig = synthetic_rows(F, PREDICT_ROWS, seed=seed, row_seed=78)
    torch.cuda.synchronize()

    pk.reset_launch_counts()
    results, lat = {}, {}
    errors = []
    t0 = time.perf_counter()
    with bst.serve() as srv:
        def client(ids):
            try:
                for i in ids:
                    s = time.perf_counter()
                    results[i] = srv.predict(X[bounds[i]:bounds[i + 1]],
                                             timeout=600)
                    lat[i] = (time.perf_counter() - s) * 1e3
            except Exception as e:  # noqa: BLE001 — re-raised below
                errors.append(e)

        threads = [threading.Thread(target=client,
                                    args=(range(k, n_req, n_threads),))
                   for k in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(900)
        wall = time.perf_counter() - t0
        metrics = srv.metrics_dict()
    if errors:
        raise errors[0]
    if any(t.is_alive() for t in threads) or len(results) != n_req:
        raise AssertionError("not every request was answered")
    t1 = time.perf_counter()
    raw = bst.predict(Xbig, raw_score=True)
    predict_s = time.perf_counter() - t1
    launches = pk.launch_counts[KERNEL]

    host = forest.predict_raw(X)[0]
    for i in range(n_req):
        want = host[bounds[i]:bounds[i + 1]]
        if not np.array_equal(results[i].view(np.uint64),
                              want.view(np.uint64)):
            raise AssertionError(f"served request {i} differs from the "
                                 "host float64 path")
    dev = bst._device_forest(forest)
    plain = pk.traverse_plain(dev, torch.from_numpy(
        Xbig.astype(np.float32)).cuda(), 1, emit_scores=True)
    plain = plain.cpu().numpy().astype(np.float64)[0]
    if not np.array_equal(raw.view(np.uint64), plain.view(np.uint64)):
        raise AssertionError("Booster.predict differs from the plain version")
    if not np.isfinite(raw).all() or raw.shape != (Xbig.shape[0],):
        raise AssertionError("Booster.predict gave a bad result")
    if launches <= 0:
        raise AssertionError("the main path never launched the kernel")
    lat_ms = np.array([lat[i] for i in range(n_req)])
    hist = metrics["histograms"]
    emit({"phase": "serve", "requests": n_req, "threads": n_threads,
          "rows": int(sizes.sum()), "wall_s": wall,
          "rows_per_s": int(sizes.sum()) / wall,
          "p50_ms": float(np.percentile(lat_ms, 50)),
          "p99_ms": float(np.percentile(lat_ms, 99)),
          "batches": metrics["counters"]["batches_total"],
          "batch_rows_mean": hist["batch_rows"]["mean"],
          "batch_ms_mean": hist["batch_latency_ms"]["mean"],
          "queue_wait_ms_mean": hist["queue_wait_ms"]["mean"],
          **batch_breakdown(dev, forest, F, seed),
          "predict_rows": Xbig.shape[0],
          "predict_rows_per_s": Xbig.shape[0] / predict_s,
          "launches": launches, "checked": "bit-exact"})
    return launches


def batch_breakdown(dev, forest, F, seed, reps: int = 21) -> dict:
    """Host-clock split of one top-bucket (1024-row) serving batch, as
    ``DeviceForest.predict_raw_padded`` runs it when the f32 epilogue is
    not verified: rows to the card + kernel + leaf ids back, then the
    host float64 leaf gather.  Medians over ``reps`` runs."""
    from lightgbm_tpu_torch.predict import gather_leaf_sum
    from lightgbm_tpu_torch.testing import synthetic_rows
    Xpad = synthetic_rows(F, 1024, seed=seed, row_seed=79)
    route, gather = [], []
    for _ in range(reps):
        t = time.perf_counter()
        leaves = dev._leaves(dev._to_device(Xpad)).cpu().numpy()
        route.append((time.perf_counter() - t) * 1e3)
        t = time.perf_counter()
        gather_leaf_sum(forest, leaves, 1)
        gather.append((time.perf_counter() - t) * 1e3)
    return {"bucket1024_route_ms": float(np.median(route)),
            "bucket1024_gather_ms": float(np.median(gather))}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run "
              "needs an NVIDIA card", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import lightgbm_tpu_torch as lt
    from lightgbm_tpu_torch.ops import _build
    from lightgbm_tpu_torch.ops import predict_kernels as pk
    from lightgbm_tpu_torch.testing import synthetic_model_text

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    emit({"phase": "env", "python": sys.version.split()[0],
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "device": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "nvidia_smi": smi})

    t0 = time.perf_counter()
    lib = _build.build(["traverse"])["traverse"]
    info = _build.build_info["traverse"]
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "fresh": info["seconds"] > 0,
          "library": os.path.relpath(lib, os.path.dirname(
              os.path.abspath(__file__))),
          "ptxas": [ln.strip() for ln in info["ptxas"].splitlines()
                    if "registers" in ln or "spill" in ln]})

    t0 = time.perf_counter()
    higgs = synthetic_model_text(28, 500, 255, seed=7)
    multi_cats = (0, 7, 13)
    multi = synthetic_model_text(20, 100, 31, num_class=5,
                                 cat_features=multi_cats, seed=101)
    wide = synthetic_model_text(400, 10, 15, cat_features=(3,), seed=5)
    models = {
        "higgs_500x255": (lt.Booster(model_str=higgs), 28, (), 7),
        "multiclass5_cat": (lt.Booster(model_str=multi), 20, multi_cats, 101),
        "wide_400": (lt.Booster(model_str=wide), 400, (3,), 5),
    }
    emit({"phase": "models", "seconds": time.perf_counter() - t0,
          "higgs_text_bytes": len(higgs)})

    rows, max_err = phase_kernel(pk, models)
    launches = phase_serve(pk, models["higgs_500x255"][0], 28, 7)

    head = rows[("higgs_500x255", TIMED_ROWS[2], False)]
    emit({"kernels": [{
        "name": KERNEL, "route": "cuda",
        "source": "lightgbm_tpu_torch/ops/csrc/traverse.cu",
        "replaces": "lightgbm_tpu/ops/predict_kernels.py:238",
        "launches": launches, "max_abs_err": max_err,
        "ms": head["kernel_ms"], "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
        "library_ms": None}]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
