#!/usr/bin/env python3
"""Smoke run of lightgbm_tpu_torch on one NVIDIA card (sm_90a, an H100).

    python3 chip_smoke.py

Builds the CUDA kernels from ``lightgbm_tpu_torch/ops/csrc`` with
``nvcc`` (one process per source, all at once), then:

- ``kernel``/``serve``: holds the traversal kernel (B1) against its plain
  PyTorch version, then serves a HIGGS-width model (28 features, 500
  trees, 255 leaves, binary; random trees from a seed) through
  ``Booster.serve()`` and ``Booster.predict()`` on the card;
- ``train``: trains a HIGGS-width binary model (1,000,000 x 28 f32 rows
  from a seed, 255 leaves, 255 bins, 10 rounds, a 100,000-row valid set)
  through ``Dataset`` and ``train`` on the card — binning (B3), root and
  frontier histograms (B4), the frontier histogram -> split pair (B2)
  and the scans (B5) — and checks that the model text is byte-identical
  to a second run with every kernel replaced by its plain version, that
  the valid logloss falls every round and that the card's predictions
  match the host's;
- ``ingest``/``hist``: holds B3, B4, B2 and B5 against their plain
  versions at the training run's shapes, bit for bit, and times them;
- ``wide_bins``: a short run at ``max_bin=1023`` (int32 binned matrix,
  1023-bin scans) against its plain-version twin;
- ``efb_train``: the airline table one-hot encoded (1,000,000 x 674 f32,
  EFB bundles; ``testing.airline_like``) trained on the staged arm: B3's
  EFB fold, the whole-dataset histogram (B6) for each root, B4 segment
  histograms, the int64 expansion and B5 in leaf mode; then
  ``Booster.predict`` through B1 against B1's plain version;
- ``hist6``: B6 against its plain version on that group matrix, timed;
- ``cat_train``: the same table with six native categorical features on
  the fused arm with the categorical merge, and B3's categorical branch;
- ``quant_hist``: B4, B5 and B2 in their int8/int32 mode (quantized
  gradients) against their plain versions at the training run's shapes,
  exact, and timed, with ``quantize_gradients`` (threefry included);
- ``quant_train``: ``higgs_quant_1m``, the training run's dataset again
  with ``use_quantized_grad`` (LightGBM's defaults: 4 bins, stochastic
  rounding, no leaf renewal): the card's quantized gradients of the
  first tree and of the scores after the last bit-equal to the CPU
  port's, the model text byte-identical to the
  plain-version run, only the int8 kernels launched; then 3 rounds at 16
  bins without stochastic rounding and with leaf renewal, and 3 rounds
  of the one-hot table on the staged arm, each against its plain-version
  run.

Each phase prints one JSON line.  Any failed check raises, and the
script exits non-zero; it exits non-zero without a result where CUDA is
absent or the package is missing.  The last lines are the kernel table,
the card's name and power limit as ``nvidia-smi`` reports them, and
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
# the training run (BASELINE's HIGGS width) and the histogram check's
# frontier width: one level of KCAP = 128 candidates
TRAIN_ROWS, VALID_ROWS, TRAIN_ROUNDS = 1_000_000, 100_000, 10
TRAIN_PARAMS = {"objective": "binary", "num_leaves": 255, "max_bin": 255,
                "learning_rate": 0.1, "metric": ["auc", "binary_logloss"],
                "verbose": -1}
HIST_SLOTS = 128
# the categorical phases: the airline table at a tenth of the Flight Delay
# set's rows, the training run's parameters; B3 is checked against the
# host oracle on the first EFB_ORACLE_ROWS rows of the one-hot matrix
EFB_ROWS, EFB_VALID_ROWS, EFB_ORACLE_ROWS = 1_000_000, 100_000, 250_000
# a short run with groups of more than 256 bins: the int32 binned layout
# and a 1024-thread scan
WIDE_ROWS, WIDE_ROUNDS = 200_000, 3
WIDE_PARAMS = {"objective": "binary", "num_leaves": 63, "max_bin": 1023,
               "verbose": -1}
# f32 operations per (child, feature, bin) of the gain scan: two
# directions of ~20 adds/multiplies/divides/compares each; the quantized
# scan adds the count estimate (convert, multiply, round) per cell
SCAN_OPS_PER_CELL = 40
QUANT_COUNT_OPS_PER_CELL = 3
# quantized training (higgs_quant_1m): the training run's data and
# parameters with LightGBM's quantized-training defaults; the two short
# runs take the other rounding/renewal branches and the staged arm
QUANT_PARAMS = dict(TRAIN_PARAMS, use_quantized_grad=True)
QUANT_BRANCH_PARAMS = dict(QUANT_PARAMS, num_grad_quant_bins=16,
                           stochastic_rounding=False,
                           quant_train_renew_leaf=True)
QUANT_SHORT_ROUNDS = 3


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


# template arguments of the accumulate kernel as the mangled name spells
# them
_MANGLED = {"h": "uint8_t", "i": "int", "f": "float", "a": "int8_t"}


def sass_atomics(_build, lib, kernel: str) -> dict:
    """The atomic opcodes (``ATOMS``/``ATOM``/``RED``) in the SASS of each
    instance of ``kernel`` in a built library, by ``cuobjdump -sass``
    from the toolkit that built it: a 64-bit shared add that compiles to
    a compare-and-swap loop shows as ``ATOMS.CAST.SPIN.64``."""
    import re
    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, timeout=120, check=True).stdout
    found, func = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            func = None
            if kernel in m.group(1):
                t = re.search(kernel + r"I(\w)(\w)E", m.group(1))
                func = (f"{kernel}<{_MANGLED.get(t.group(1), t.group(1))}, "
                        f"{_MANGLED.get(t.group(2), t.group(2))}>"
                        if t else m.group(1))
                found[func] = set()
            continue
        m = re.search(r"\b((?:ATOMS|ATOMG|ATOM|RED)\.[A-Z0-9._]+)", line)
        if m and func is not None:
            found[func].add(m.group(1))
    if not found:
        raise AssertionError(f"no {kernel} in the SASS of {lib}")
    return {k: sorted(v) for k, v in sorted(found.items())}


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


def bytes_or_ops(nbytes: float, ops: float) -> dict:
    """Least time on the card: the larger of bytes over the HBM rate and
    operations over the f32 rate."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_F32_PER_S * 1e3
    return {"bytes": nbytes, "ops": ops, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def max_abs_err(a, b) -> float:
    """Largest |a - b| over two tensors (equal infinities count 0), or
    over the fields of two ``NumericFeatureBest`` tuples."""
    if hasattr(a, "_fields"):
        return max(max_abs_err(getattr(a, f), getattr(b, f))
                   for f in a._fields)
    a, b = a.double(), b.double()
    d = torch.where(a == b, torch.zeros_like(a), (a - b).abs())
    return float(d.max()) if d.numel() else 0.0


def kernel_launches():
    """Current launch counts of the training kernels (B3, B4, B5, B2,
    B6)."""
    from lightgbm_tpu_torch.ops import fused, histogram, ingest
    return {"ingest": ingest.launch_counts["ingest"],
            **fused.launch_counts, **histogram.launch_counts}


def reset_training_counts() -> None:
    from lightgbm_tpu_torch.ops import fused, histogram, ingest
    fused.reset_launch_counts()
    ingest.reset_launch_counts()
    histogram.reset_launch_counts()


def train_once(lt, X, y, Xv, yv, params, rounds, categorical,
               datasets=None):
    """Dataset + valid set + ``train`` on the card (``datasets``: a
    constructed (train, valid) pair to reuse instead); returns (datasets,
    booster, evals, construct seconds, train seconds)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if datasets is None:
        ds = lt.Dataset(X, label=y, categorical_feature=categorical)
        vs = ds.create_valid(Xv, label=yv)
    else:
        ds, vs = datasets
    ds.construct()
    vs.construct()
    torch.cuda.synchronize()
    construct_s = time.perf_counter() - t0
    evals = {}
    t1 = time.perf_counter()
    bst = lt.train(params, ds, rounds, valid_sets=[vs],
                   valid_names=["valid"], evals_result=evals,
                   verbose_eval=False)
    torch.cuda.synchronize()
    return ds, vs, bst, evals, construct_s, time.perf_counter() - t1


def plain_kernels():
    """Replace every training kernel's launcher by its plain version
    (returns the originals for ``restore_kernels``)."""
    from lightgbm_tpu_torch.ops import fused, histogram, ingest
    saved = (ingest._bin_cuda, fused._accumulate_cuda, fused._scan_cuda,
             histogram._histogram_cuda)
    ingest._bin_cuda = lambda X, binner: binner.plain(X)
    fused._accumulate_cuda = fused.accumulate_plain
    fused._scan_cuda = (lambda *args, pair=False, **kw:
                        fused.scan_plain(*args, **kw))
    histogram._histogram_cuda = histogram.histogram_plain
    return saved


def restore_kernels(saved) -> None:
    from lightgbm_tpu_torch.ops import fused, histogram, ingest
    (ingest._bin_cuda, fused._accumulate_cuda, fused._scan_cuda,
     histogram._histogram_cuda) = saved


def training_runs(lt, X, y, Xv, yv, params, rounds, categorical="auto",
                  datasets=None):
    """The training path on the card three times: the main run (counts
    set to 0 just before it and read just after), the same run with every
    kernel replaced by its plain version (its model text must be the same
    bytes, since every sum is an exact integer, and no count may rise),
    and a run through ``Booster.update()`` with a section timer (where a
    tree's time goes; the timer synchronises the card at each section)
    that logs each tree's (candidates, committed) per frontier round.
    Checks the trees, the falling valid logloss and the card's
    predictions against the host's; returns what the phases report.
    ``datasets``: a constructed (train, valid) pair that every run
    reuses."""
    from lightgbm_tpu_torch.boosting import gbdt as gbdt_mod
    from lightgbm_tpu_torch.utils.timer import SectionTimer
    reset_training_counts()
    ds, vs, bst, evals, construct_s, train_s = train_once(
        lt, X, y, Xv, yv, params, rounds, categorical, datasets)
    launches = kernel_launches()
    text = bst.model_to_string()
    if bst.num_trees() != rounds:
        raise AssertionError(f"trained {bst.num_trees()} trees, not {rounds}")
    ll = evals["valid"]["binary_logloss"]
    if not all(b < a for a, b in zip(ll, ll[1:])):
        raise AssertionError(f"valid logloss does not fall: {ll}")
    auc = evals["valid"]["auc"]
    if not auc[-1] > auc[0]:
        raise AssertionError(f"valid AUC does not rise: {auc}")
    raw_dev = bst.predict(Xv, raw_score=True)
    raw_host = bst.predict(Xv, raw_score=True, device=False)
    leaf_dev = bst.predict(Xv[:20000], pred_leaf=True)
    leaf_host = bst.predict(Xv[:20000], pred_leaf=True, device=False)
    if raw_dev.shape != (Xv.shape[0],) or not np.isfinite(raw_dev).all():
        raise AssertionError("Booster.predict gave a bad result")
    if not np.array_equal(leaf_dev, leaf_host):
        raise AssertionError("leaf ids on the card differ from the host's")
    # f32 sums of the leaf values on the card vs f64 on the host
    pred_err = float(np.abs(raw_dev - raw_host).max())
    if not np.allclose(raw_dev, raw_host, rtol=1e-5, atol=1e-6):
        raise AssertionError(f"predictions differ from the host: {pred_err}")

    saved = plain_kernels()
    reset_training_counts()
    try:
        _, _, bst_p, _, _, plain_train_s = train_once(
            lt, X, y, Xv, yv, params, rounds, categorical, datasets)
    finally:
        restore_kernels(saved)
    plain_launches = kernel_launches()
    if any(plain_launches.values()):
        raise AssertionError(f"launch counts rose with no kernel launched: "
                             f"{plain_launches}")
    if bst_p.model_to_string() != text:
        raise AssertionError("the model text differs from the plain-version "
                             "run")
    del bst_p

    grow = gbdt_mod.grow_tree_rounds
    rounds_log = []

    def logged_grow(*args, **kw):
        rounds_log.append([])
        return grow(*args, rounds=rounds_log[-1], **kw)

    bst_t = lt.Booster(params, train_set=ds)
    bst_t.add_valid(vs, "valid")
    timer = SectionTimer(cuda=True)
    bst_t.boosting.timer = timer
    gbdt_mod.grow_tree_rounds = logged_grow
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        for _ in range(rounds):
            bst_t.update()
    finally:
        gbdt_mod.grow_tree_rounds = grow
    timed_s = time.perf_counter() - t0
    if (bst_t.model_to_string().partition("end of trees")[0]
            != text.partition("end of trees")[0]):
        raise AssertionError("the timed run's trees differ")
    per_tree = {k: v / rounds for k, v in timer.seconds.items()}
    per_tree["other"] = timed_s / rounds - sum(per_tree.values())
    return {"ds": ds, "vs": vs, "bst": bst, "launches": launches, "row": {
        "rows": X.shape[0], "valid_rows": Xv.shape[0],
        "features": X.shape[1], "rounds": rounds,
        "num_leaves": params["num_leaves"],
        "leaves_per_tree": [m.num_leaves for m in bst.models],
        "construct_s": construct_s, "train_s": train_s,
        "s_per_tree": train_s / rounds,
        "plain_s_per_tree": plain_train_s / rounds,
        "timed_s_per_tree": timed_s / rounds,
        "breakdown_s_per_tree": per_tree,
        "valid_auc": auc, "valid_logloss": ll, "launches": launches,
        "launches_per_tree": {k: v / rounds for k, v in launches.items()},
        "rounds_per_tree": [len(r) for r in rounds_log],
        "rollbacks_per_tree": [sum(m < k for k, m in r) for r in rounds_log],
        "predict_max_abs_err_vs_host_f64": pred_err,
        "checked": "model text byte-identical to the plain run"}}


F32_ENTRIES = ("fused_frontier_splits", "fused_frontier_accumulate",
               "fused_sibling_scan", "fused_slot_order")
INT8_ENTRIES = tuple(name + "_int8" for name in F32_ENTRIES)


def expect_launches(launches: dict, positive=(), zero=(), exact=None):
    # B4 sorts the rows before every accumulate, and the training path
    # runs the sort nowhere else
    for mode in ("", "_int8"):
        if (launches["fused_slot_order" + mode]
                != launches["fused_frontier_accumulate" + mode]):
            raise AssertionError(f"B4{mode}: {launches} sorts for "
                                 "accumulates")
    for name in positive:
        if launches[name] <= 0:
            raise AssertionError(f"the training path never launched {name}")
    for name in zero:
        if launches[name] != 0:
            raise AssertionError(f"{name} launched {launches[name]} times; "
                                 "this path must not launch it")
    for name, n in (exact or {}).items():
        if launches[name] != n:
            raise AssertionError(f"{name} launched {launches[name]} times, "
                                 f"not {n}")


def phase_train(lt):
    """The training path on the card; returns (launches, datasets, raw
    train matrix, booster)."""
    from lightgbm_tpu_torch.testing import higgs_like
    X, y = higgs_like(TRAIN_ROWS, seed=11)
    Xv, yv = higgs_like(VALID_ROWS, seed=12)
    r = training_runs(lt, X, y, Xv, yv, TRAIN_PARAMS, TRAIN_ROUNDS)
    # the fused arm: B4 roots, B2 (B4 + B5) rounds, no B6
    expect_launches(r["launches"], positive=("ingest",) + F32_ENTRIES,
                    zero=("histogram_pallas",) + INT8_ENTRIES)
    emit({"phase": "train", **r["row"]})
    return r, (X, y, Xv, yv)


def edge_rows(ds, F: int, X) -> np.ndarray:
    """Rows at every bin bound of every feature (the f32 nearest the
    bound and its two neighbours), plus NaN, +-inf, +-1e30, denormals
    and the salted rows of ``ops.ingest.salt_rows``."""
    from lightgbm_tpu_torch.ops.ingest import salt_rows
    cols = []
    for f in range(F):
        ub = np.asarray(ds.bin_mappers[f].bin_upper_bound, np.float64)
        ub = ub[np.isfinite(ub)].astype(np.float32)
        cols.append(np.concatenate([
            ub, np.nextafter(ub, np.float32(np.inf)),
            np.nextafter(ub, np.float32(-np.inf))]))
    width = max(len(c) for c in cols)
    grid = np.zeros((width, F), np.float32)
    for f, c in enumerate(cols):
        grid[:len(c), f] = c
    special = np.array([np.nan, np.inf, -np.inf, 1e30, -1e30, 1e-40, -1e-40,
                        1e-45, 0.0, -0.0], np.float32)
    spec = np.repeat(special[:, None], F, axis=1)
    return np.concatenate([salt_rows(F, X), spec, grid]).astype(np.float32)


def phase_ingest(ds, X):
    """B3 against the host oracle ``Dataset._bin_block`` at the training
    shape plus edge rows, byte for byte; its times."""
    from lightgbm_tpu_torch.ops import ingest as ING
    n, F = X.shape
    tables = ING.build_ingest_tables(ds)
    binner = ING.DeviceBinner(tables, "cuda")
    Xc = np.concatenate([X, edge_rows(ds, F, X)])
    got = binner(torch.from_numpy(Xc).cuda()).cpu().numpy()
    ref = np.zeros((Xc.shape[0], tables.num_groups), tables.out_dtype)
    with np.errstate(invalid="ignore", over="ignore"):
        ds._bin_block(Xc.astype(np.float64), ref)
    if not np.array_equal(got.T, ref):
        bad = int((got.T != ref).sum())
        raise AssertionError(f"binned bytes differ from _bin_block at {bad} "
                             "entries")
    Xt = torch.from_numpy(X).cuda()
    plain_out = binner.plain(Xt)
    max_err = max_abs_err(binner(Xt), plain_out)
    if max_err != 0.0:
        raise AssertionError(f"B3 differs from its plain version by {max_err} "
                             "bins")
    del plain_out
    layouts = ingest_layouts(ING, tables, Xc[-100_003:], ref[-100_003:])
    cols = [s.column for s in tables.specs if not s.is_cat]
    XT = Xt[:, cols].T.contiguous()
    bw = tables.bounds.shape[1]
    row = {"phase": "ingest", "rows": n, "features": F,
           "groups": tables.num_groups, "checked_rows": int(Xc.shape[0]),
           "checked": "byte-identical to _bin_block", "max_abs_err": max_err,
           "plan": {"tile_rows": binner.kernel_state().plan.tile_rows,
                    "chunks": len(binner.kernel_state().plan.chunks) - 1,
                    "smem_bytes": binner.kernel_state().plan.smem_bytes,
                    "blocks": ING.planner.ingest_grid(
                        binner.kernel_state().plan, n)},
           "layouts": layouts,
           "kernel_ms": graph_ms(lambda: binner(Xt), 20),
           "plain_ms": event_ms(lambda: binner.plain(Xt), 3, warmup=1),
           "library_ms": event_ms(
               lambda: torch.searchsorted(binner.bounds, XT), 20),
           **bytes_or_ops(4 * n * F + n * tables.num_groups,
                          n * tables.num_groups
                          * (int(np.ceil(np.log2(bw + 1))) + 4))}
    emit(row)
    return row


def ingest_layouts(ING, tables, Xc, ref) -> list:
    """B3 byte for byte against ``_bin_block``'s ``ref`` where the kernel
    takes its other paths: X at an address that is not 16-byte aligned
    (scalar loads, and a row count that leaves ragged output words), and
    tables cut into several group chunks (a small table budget)."""
    from lightgbm_tpu_torch.ops import planner
    n, F = Xc.shape
    buf = torch.empty(n * F + 1, dtype=torch.float32, device="cuda")
    buf[1:] = torch.from_numpy(Xc).cuda().flatten()
    saved = planner.INGEST_TABLE_BYTES
    done = []
    try:
        for name, X, budget in (
                ("misaligned", buf[1:].view(n, F), saved),
                ("group_chunks", torch.from_numpy(Xc).cuda(), 4096)):
            planner.INGEST_TABLE_BYTES = budget
            binner = ING.DeviceBinner(tables, "cuda")
            got = binner(X).cpu().numpy()
            if not np.array_equal(got.T, ref):
                raise AssertionError(f"B3 ({name}) differs from _bin_block")
            done.append({"layout": name, "rows": n, "chunks":
                         len(binner.kernel_state().plan.chunks) - 1})
    finally:
        planner.INGEST_TABLE_BYTES = saved
    return done


def phase_hist(ds, bst):
    """B4, B2 and B5 against their plain versions at one frontier level
    of the training run (K = 128 slots, about half the rows slotted, the
    run's gradients after its last round); their times.  B4 and its sort
    also at a root and a deep round (``b4_shapes``) and on the edge cases
    of ``b4_edge_cases``.  Kernels are
    timed from CUDA graphs; the plain versions and the library call sync
    with the host (``nonzero``, ``bincount``) and cannot be captured, so
    they are timed by CUDA events over back-to-back calls."""
    from lightgbm_tpu_torch.ops import fused
    from lightgbm_tpu_torch.ops.histogram import (_vals_t, accumulate_plain,
                                                  fixed_point_scales)
    from lightgbm_tpu_torch.ops.split import fixed_to_f32
    gb = bst.boosting
    binned_t = ds.binned_t
    F, n = binned_t.shape
    K, B = HIST_SLOTS, gb.num_bins
    hp = gb.grower_cfg.hp
    mt = gb.meta_t
    nb, mty, db = mt["num_bin"], mt["missing_type"], mt["default_bin"]
    grad, hess = gb.objective.get_gradients(gb.train_score[0])
    vals = _vals_t(grad, hess, torch.ones_like(grad)).contiguous()
    scales = fixed_point_scales(vals)
    g = torch.Generator(device="cuda").manual_seed(5)
    r = torch.rand(n, device="cuda", generator=g)
    pick = torch.randint(0, K, (n,), device="cuda", generator=g,
                         dtype=torch.int32)
    other = torch.randint(0, K, (n,), device="cuda", generator=g,
                          dtype=torch.int32)
    slot = torch.where(r < 0.5, pick, torch.full_like(pick, K))
    parent = accumulate_plain(binned_t, vals, torch.where(r < 0.5, pick,
                                                          other), K, B,
                              scales)
    small_left = torch.rand(K, device="cuda", generator=g) < 0.5

    small = fused.accumulate(binned_t, vals, slot, K, B, scales)
    small_p = accumulate_plain(binned_t, vals, slot, K, B, scales)
    if not torch.equal(small, small_p):
        raise AssertionError("B4 differs from its plain version")
    # in value units: each channel's fixed-point difference times 2**-s
    err_b4 = max(max_abs_err(small[:, c], small_p[:, c]) * 2.0 ** -scales[c]
                 for c in range(3))
    del small_p
    children = fused.derive_children(small, small_left, parent)
    sums = torch.stack([fixed_to_f32(children[:, c, 0].sum(-1),
                                     [scales[c]], 0) for c in range(3)])

    def same(a, b):
        for name in a._fields:
            x, y = getattr(a, name), getattr(b, name)
            if x.dtype == torch.float32:
                x, y = x.view(torch.int32), y.view(torch.int32)
            if not torch.equal(x, y):
                return False
        return True

    def b5():
        return fused.sibling_scan(small, scales, sums, nb, mty, db, hp,
                                  small_left=small_left, parent=parent)

    def b5_plain():
        return fused.scan_plain(small, scales, sums, nb, mty, db, hp,
                                small_left=small_left, parent=parent)

    def b2():
        return fused.frontier_splits(binned_t, vals, slot, K, B, scales,
                                     sums, small_left, parent, nb, mty, db,
                                     hp)

    def b2_plain():
        seg = accumulate_plain(binned_t, vals, slot, K, B, scales)
        return seg, fused.scan_plain(seg, scales, sums, nb, mty, db, hp,
                                     small_left=small_left, parent=parent)

    best_k5, best_p5 = b5(), b5_plain()
    if not same(best_k5, best_p5):
        raise AssertionError("B5 differs from its plain version in bits")
    err_b5 = max_abs_err(best_k5, best_p5)
    seg_k, best_k = b2()
    seg_p, best_p = b2_plain()
    if not (torch.equal(seg_k, seg_p) and same(best_k, best_p)):
        raise AssertionError("B2 differs from its plain version in bits")
    err_b2 = max(max_abs_err(best_k, best_p),
                 *(max_abs_err(seg_k[:, c], seg_p[:, c]) * 2.0 ** -scales[c]
                   for c in range(3)))
    del seg_k, seg_p
    torch.cuda.synchronize()

    m = int((slot < K).sum())
    NC = 2 * K
    hist_bytes = K * 3 * F * B * 8
    tuple_bytes = NC * F * 4 * 6
    scan = bytes_or_ops(2 * hist_bytes + 3 * NC * 4 + K * 4 + 3 * F * 4
                        + tuple_bytes, NC * F * B * SCAN_OPS_PER_CELL)
    shapes = b4_shapes(fused, accumulate_plain, binned_t, vals, scales, B,
                       slot, seed=7)
    acc = shapes["frontier"]
    pair = bytes_or_ops(acc["bytes"] + hist_bytes + 3 * NC * 4 + K * 4
                        + 3 * F * 4 + tuple_bytes, acc["ops"] + scan["ops"])
    edges = b4_edge_cases(fused, accumulate_plain, binned_t, vals, scales, B)
    rows_out = {
        "fused_frontier_accumulate": dict(acc, max_abs_err=err_b4),
        "fused_slot_order": slot_order_row(fused, slot, K, vals, scales),
        "fused_sibling_scan": {
            "kernel_ms": graph_ms(b5, 10),
            "plain_ms": event_ms(b5_plain, 2, warmup=1),
            "library_ms": None, "max_abs_err": err_b5, **scan},
        "fused_frontier_splits": {
            "kernel_ms": graph_ms(b2, 10),
            "plain_ms": event_ms(b2_plain, 2, warmup=1),
            "library_ms": None, "max_abs_err": err_b2, **pair},
    }
    emit({"phase": "hist", "rows": n, "features": F, "bins": B, "slots": K,
          "slotted_rows": m, "scales": list(scales),
          "checked": "bit-identical to the plain versions",
          "b4_shapes": shapes, "b4_edge_cases": edges,
          **{k: v for k, v in rows_out.items()}})
    return rows_out


# B4's frontier shapes besides the training run's level (K = 128 with
# about half the rows slotted): a root (one slot holding every row) and a
# deep round (K = 128, about 5% of the rows slotted)
B4_SHAPES = (("root", 1, 1.0), ("deep", HIST_SLOTS, 0.05))


def b4_bound(n, F, B, K, m, quant, bin_bytes=1):
    """B4's least time: each slot read once, the slotted rows' bins and
    values once, the [K, C, F, B] sums written once; one add per
    (slotted row, feature, channel)."""
    C, val_bytes, cell = (2, 2, 4) if quant else (3, 12, 8)
    return bytes_or_ops(4 * n + m * (F * bin_bytes + val_bytes)
                        + K * C * F * B * cell, C * m * F)


def b4_shapes(fused, accumulate_plain, binned_t, vals, scales, B, slot,
              seed):
    """B4 (sort + accumulate) at the frontier shape (``slot``, K =
    ``HIST_SLOTS``) and at ``B4_SHAPES``: each equal to
    ``accumulate_plain`` and its sort to ``slot_order_plain`` and
    ``sorted_values_plain`` (``torch.equal``), then the kernel's time
    from a CUDA graph, the plain version's and ``torch.bincount`` x C
    (one call per channel over the flattened (slot, feature, bin) index
    of the slotted rows, the levels as f32 weights in int8 mode: exact,
    sums below 2**24)."""
    F, n = binned_t.shape
    quant = vals.dtype == torch.int8
    C = 2 if quant else 3
    g = torch.Generator(device="cuda").manual_seed(seed)
    out = {}
    for name, K, frac in (("frontier", HIST_SLOTS, None),) + B4_SHAPES:
        if frac is not None:
            r = torch.rand(n, device="cuda", generator=g)
            pick = torch.randint(0, K, (n,), device="cuda", generator=g,
                                 dtype=torch.int32)
            slot = torch.where(r < frac, pick, torch.full_like(pick, K))
        got = fused.accumulate(binned_t, vals, slot, K, B, scales)
        want = accumulate_plain(binned_t, vals, slot, K, B, scales)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"B4 differs from its plain version at the "
                                 f"{name} shape")
        del got, want
        sort_vs_plain(fused, slot, K, vals, scales, f"the {name} shape")
        rows = torch.nonzero(slot < K).flatten()
        m = int(rows.numel())
        idx = ((slot[rows].to(torch.int64)[None, :] * F
                + torch.arange(F, device="cuda")[:, None]) * B
               + binned_t[:, rows].to(torch.int64)).flatten()
        wts = [vals[c, rows].float()[None, :].expand(F, -1).flatten()
               .contiguous() for c in range(C)]

        def library():
            for w in wts:
                torch.bincount(idx, weights=w, minlength=K * F * B)

        out[name] = {
            "slots": K, "slotted_rows": m,
            "kernel_ms": graph_ms(lambda: fused.accumulate(
                binned_t, vals, slot, K, B, scales), 10),
            "plain_ms": event_ms(lambda: accumulate_plain(
                binned_t, vals, slot, K, B, scales), 2, warmup=1),
            "library_ms": event_ms(library, 5),
            "sort_ms": graph_ms(lambda: fused._slot_order_cuda(
                slot, K, vals, scales), 10),
            **b4_bound(n, F, B, K, m, quant, binned_t.element_size())}
        del idx, wts
    return out


def sort_vs_plain(fused, slot, K, vals, scales, where) -> float:
    """B4's sort as the path runs it (``_slot_order_cuda``: order,
    offsets and the slotted rows' values in sorted order) against
    ``slot_order_plain`` and ``sorted_values_plain``: raises unless all
    three are equal; returns the largest |difference| over them."""
    order, meta, sv = fused._slot_order_cuda(slot, K, vals, scales)
    p_order, p_offsets = fused.slot_order_plain(slot, K)
    p_sv = fused.sorted_values_plain(vals, p_order, p_offsets, scales)
    pairs = ((order, p_order), (meta[:K + 1], p_offsets),
             (sv[:p_sv.shape[0]], p_sv))
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in pairs):
        raise AssertionError(f"B4's sort differs from its plain version at "
                             f"{where}")
    return max(float((a.to(torch.int64) - b.to(torch.int64)).abs().max())
               if a.numel() else 0.0 for a, b in pairs)


def slot_order_row(fused, slot, K, vals, scales):
    """B4's sort at the frontier shape, the variant the path runs (it
    lays out the slotted rows' values too): held to its plain version,
    its time from a CUDA graph and the plain version's.  No one PyTorch
    call computes it; ``torch.argsort(stable=True)`` gives the order
    alone (``argsort_order_only_ms``)."""
    n = slot.shape[0]
    err = sort_vs_plain(fused, slot, K, vals, scales, "the frontier shape")
    m = int((slot < K).sum())
    C, in_b, out_b = (2, 1, 1) if vals.dtype == torch.int8 else (3, 4, 8)

    def plain():
        order, offsets = fused.slot_order_plain(slot, K)
        return fused.sorted_values_plain(vals, order, offsets, scales)

    return {"kernel_ms": graph_ms(lambda: fused._slot_order_cuda(
                slot, K, vals, scales), 10),
            "plain_ms": event_ms(plain, 5),
            "library_ms": None,
            "argsort_order_only_ms": event_ms(
                lambda: torch.argsort(slot, stable=True), 5),
            "max_abs_err": err, "slotted_rows": m,
            **bytes_or_ops(8 * n + 8 * (K + 1) + m * C * (in_b + out_b), n)}


def b4_edge_cases(fused, accumulate_plain, binned_t, vals, scales, B):
    """B4 against its plain version on the card where the sort has
    nothing or little to do: every row dropped, and slots left empty."""
    n = binned_t.shape[1]
    K = HIST_SLOTS
    g = torch.Generator(device="cuda").manual_seed(9)
    pick = torch.randint(0, K // 8, (n,), device="cuda", generator=g,
                         dtype=torch.int32) * 8      # 7 of 8 slots empty
    cases = {"all_dropped": torch.full((n,), K, dtype=torch.int32,
                                       device="cuda"),
             "empty_slots": pick}
    for name, slot in cases.items():
        got = fused.accumulate(binned_t, vals, slot, K, B, scales)
        want = accumulate_plain(binned_t, vals, slot, K, B, scales)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"B4 differs from its plain version: {name}")
        sort_vs_plain(fused, slot, K, vals, scales, name)
        if name == "all_dropped" and bool(got.any()):
            raise AssertionError("B4 summed dropped rows")
    return {"cases": sorted(cases), "checked": "equal to the plain version"}


def phase_wide_bins(lt):
    """Groups of more than 256 bins (``max_bin=1023``): B3 writes int32,
    B4 reads it, B5 scans 1023 bins.  B3 against ``_bin_block`` byte for
    byte, and a short training run against its plain-version twin, model
    text byte for byte."""
    from lightgbm_tpu_torch.testing import higgs_like
    X, y = higgs_like(WIDE_ROWS, seed=13)
    X[::97, 3] = np.nan

    def run():
        ds = lt.Dataset(X, label=y,
                        params={"max_bin": WIDE_PARAMS["max_bin"]})
        bst = lt.train(WIDE_PARAMS, ds, WIDE_ROUNDS, verbose_eval=False)
        return ds, bst.model_to_string()

    ds, text = run()
    if ds.binned_t.dtype != torch.int32:
        raise AssertionError(f"wide groups binned as {ds.binned_t.dtype}")
    ref = np.zeros((WIDE_ROWS, ds.num_groups), ds.binned_dtype())
    ds._bin_block(X.astype(np.float64), ref)
    if not np.array_equal(ds.binned_t.cpu().numpy().T, ref):
        raise AssertionError("wide-bin binned matrix differs from "
                             "_bin_block")
    saved = plain_kernels()
    try:
        _, text_p = run()
    finally:
        restore_kernels(saved)
    if text != text_p:
        raise AssertionError("wide-bin model text differs from the "
                             "plain-version run")
    B = int(ds.feature_meta().max_num_bin)
    emit({"phase": "wide_bins", "rows": WIDE_ROWS, "max_num_bin": B,
          "binned": str(ds.binned_t.dtype), "rounds": WIDE_ROUNDS,
          "b4_int32_bins": b4_wide_bins(ds.binned_t, B),
          "checked": "binned bytes equal _bin_block; model text "
                     "byte-identical to the plain run; B4 on int32 bins "
                     "equal to its plain version"})


def b4_wide_bins(binned_t, B) -> dict:
    """B4 on the int32 binned matrix of ``max_bin=1023`` in both modes
    (f32 values at their fixed-point scales, int8 levels), K = 64 with
    about half the rows slotted, against its plain version."""
    from lightgbm_tpu_torch.ops import fused
    from lightgbm_tpu_torch.ops.histogram import (accumulate_plain,
                                                  fixed_point_scales)
    n = binned_t.shape[1]
    K = 64
    g = torch.Generator(device="cuda").manual_seed(10)
    r = torch.rand(n, device="cuda", generator=g)
    pick = torch.randint(0, K, (n,), device="cuda", generator=g,
                         dtype=torch.int32)
    slot = torch.where(r < 0.5, pick, torch.full_like(pick, K))
    vals = torch.randn((3, n), device="cuda", generator=g)
    vals[2] = 1.0
    levels = torch.randint(-31, 32, (2, n), device="cuda", generator=g,
                           dtype=torch.int32).to(torch.int8)
    out = {}
    for mode, v, sc in (("f32", vals, fixed_point_scales(vals)),
                        ("int8", levels, None)):
        got = fused.accumulate(binned_t, v, slot, K, B, sc)
        want = accumulate_plain(binned_t, v, slot, K, B, sc)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"B4 ({mode}) differs from its plain "
                                 f"version on int32 bins")
        out[mode] = {"kernel_ms": graph_ms(
            lambda: fused.accumulate(binned_t, v, slot, K, B, sc), 5)}
    return {"slots": K, "bins": B, **out}


def predict_vs_plain(pk, bst, Xv) -> int:
    """``Booster.predict`` of the valid rows through B1 (scores mode),
    bit for bit against B1's plain version; returns the B1 launches of
    that call."""
    pk.reset_launch_counts()
    raw = bst.predict(Xv, raw_score=True)
    launches = pk.launch_counts[KERNEL]
    forest = bst._forest(0, len(bst.models))
    dev = bst._device_forest(forest)
    plain = pk.traverse_plain(dev, torch.from_numpy(
        np.ascontiguousarray(Xv, np.float32)).cuda(), 1, emit_scores=True)
    plain = plain.cpu().numpy().astype(np.float64)[0]
    if not np.array_equal(raw.view(np.uint64), plain.view(np.uint64)):
        raise AssertionError("Booster.predict differs from B1's plain version")
    if launches <= 0:
        raise AssertionError("Booster.predict never launched B1")
    return launches


def oracle_check(ds, X) -> int:
    """B3 against the host oracle ``Dataset._bin_block`` on the dataset's
    own layout (EFB groups, categorical codes): ``X`` plus the edge rows
    (bin bounds, salted rows, every category code and its neighbours),
    byte for byte; returns the rows checked."""
    from lightgbm_tpu_torch.ops import ingest as ING
    F = X.shape[1]
    edge = [edge_rows(ds, F, X)]
    for f in ds.used_features:
        codes = np.asarray(ds.bin_mappers[f].bin_2_categorical, np.float64)
        if codes.size:
            vals = np.concatenate([codes, codes + 0.4, codes - 0.4,
                                   [codes.max() + 1.0, -1.0, -2.0]])
            block = np.repeat(X[:1], vals.size, axis=0)
            block[:, f] = vals.astype(np.float32)
            edge.append(block)
    tables = ING.build_ingest_tables(ds)
    binner = ING.DeviceBinner(tables, "cuda")
    Xc = np.concatenate([X] + edge).astype(np.float32)
    got = binner(torch.from_numpy(Xc).cuda()).cpu().numpy()
    ref = np.zeros((Xc.shape[0], tables.num_groups), tables.out_dtype)
    with np.errstate(invalid="ignore", over="ignore"):
        ds._bin_block(Xc.astype(np.float64), ref)
    if not np.array_equal(got.T, ref):
        bad = int((got.T != ref).sum())
        raise AssertionError(f"binned bytes differ from _bin_block at {bad} "
                             "entries")
    return int(Xc.shape[0])


def b3_at(ds, X) -> dict:
    """B3 at a training phase's own shape, the whole train matrix: equal
    to its plain version, its time from a CUDA graph, the plain
    version's, one ``torch.searchsorted`` over the numerical columns, and
    the bound (X once, the bins once; a descent of h + 4 steps per (row,
    member)); beside them the host's parts of a Dataset's binning: the
    ragged tables and plan (``kernel_state``) and the copy of X to the
    card."""
    from lightgbm_tpu_torch.ops import ingest as ING
    n, F = X.shape
    tables = ING.build_ingest_tables(ds)
    binner = ING.DeviceBinner(tables, "cuda")
    t0 = time.perf_counter()
    state = binner.kernel_state()
    torch.cuda.synchronize()
    tables_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    Xt = torch.from_numpy(X).cuda()
    torch.cuda.synchronize()
    copy_s = time.perf_counter() - t0
    err = max_abs_err(binner(Xt), binner.plain(Xt))
    if err != 0.0:
        raise AssertionError(f"B3 differs from its plain version by {err} "
                             "bins")
    cols = [s.column for s in tables.specs if not s.is_cat]
    XT = Xt[:, cols].T.contiguous()
    depth = int(state.members[:, 5].sum()) + 4 * len(tables.specs)
    row = {"rows": n, "features": F, "groups": tables.num_groups,
           "plan": {"tile_rows": state.plan.tile_rows,
                    "chunks": len(state.plan.chunks) - 1,
                    "smem_bytes": state.plan.smem_bytes,
                    "blocks": ING.planner.ingest_grid(state.plan, n)},
           "kernel_ms": graph_ms(lambda: binner(Xt), 5),
           "plain_ms": event_ms(lambda: binner.plain(Xt), 1, warmup=1),
           "library_ms": event_ms(
               lambda: torch.searchsorted(binner.bounds, XT), 5),
           "max_abs_err": err, "host_tables_s": tables_s,
           "host_copy_x_s": copy_s,
           **bytes_or_ops(4 * n * F + n * tables.num_groups
                          * (1 if ING.device_dtype(tables) == torch.uint8
                             else 4),
                          n * depth)}
    del Xt, XT
    return row


def phase_efb_train(lt, pk):
    """``airline_onehot_1m``: the airline table one-hot encoded (674 f32
    features, EFB bundles) trained on the staged arm: B3's EFB fold, B6
    for each root, B4 segment histograms, the int64 expansion and B5 in
    leaf mode.  Returns (launches, dataset, booster)."""
    from lightgbm_tpu_torch.testing import airline_like, one_hot
    X8, y = airline_like(EFB_ROWS, seed=11)
    Xv8, yv = airline_like(EFB_VALID_ROWS, seed=12)
    X, Xv = one_hot(X8), one_hot(Xv8)
    del X8, Xv8
    r = training_runs(lt, X, y, Xv, yv, TRAIN_PARAMS, TRAIN_ROUNDS)
    ds = r["ds"]
    if not ds.feature_meta().has_bundles:
        raise AssertionError("the one-hot table did not bundle")
    expect_launches(r["launches"], positive=(
        "fused_frontier_accumulate", "fused_sibling_scan",
        "fused_slot_order"), zero=("fused_frontier_splits",) + INT8_ENTRIES,
        exact={"histogram_pallas": TRAIN_ROUNDS, "ingest": 2})
    checked = oracle_check(ds, X[:EFB_ORACLE_ROWS])
    b3 = b3_at(ds, X)
    b1 = predict_vs_plain(pk, r["bst"], Xv)
    emit({"phase": "efb_train", "config": "airline_onehot_1m", **r["row"],
          "b3": b3,
          "used_features": len(ds.used_features), "groups": ds.num_groups,
          "max_group_bin": int(ds.max_group_bin),
          "max_num_bin": int(ds.feature_meta().max_num_bin),
          "b3_oracle_rows": checked, "predict_b1_launches": b1,
          "predict": "bit-identical to B1's plain version"})
    return r["launches"], ds, r["bst"]


def phase_cat_train(lt, pk):
    """``airline_cat_1m``: the same table with its six categorical
    columns as native ``categorical_feature`` (8 features, no bundles) on
    the fused arm with the categorical merge, and B3's categorical
    branch."""
    from lightgbm_tpu_torch.testing import AIRLINE_CATEGORICAL, airline_like
    X, y = airline_like(EFB_ROWS, seed=11)
    Xv, yv = airline_like(EFB_VALID_ROWS, seed=12)
    r = training_runs(lt, X, y, Xv, yv, TRAIN_PARAMS, TRAIN_ROUNDS,
                      categorical=list(AIRLINE_CATEGORICAL))
    ds = r["ds"]
    meta = ds.feature_meta()
    if meta.has_bundles or int(meta.is_categorical.sum()) != 6:
        raise AssertionError("the categorical table is not 6 categorical "
                             "features without bundles")
    expect_launches(r["launches"], positive=F32_ENTRIES,
                    zero=("histogram_pallas",) + INT8_ENTRIES,
                    exact={"ingest": 2})
    checked = oracle_check(ds, X)
    b1 = predict_vs_plain(pk, r["bst"], Xv)
    cat_splits = sum(int((m.decision_type[:m.num_leaves - 1] & 1).sum())
                     for m in r["bst"].models)
    if cat_splits == 0:
        raise AssertionError("no categorical split was made")
    emit({"phase": "cat_train", "config": "airline_cat_1m", **r["row"],
          "num_bin": meta.num_bin.tolist(), "categorical_splits": cat_splits,
          "b3_oracle_rows": checked, "predict_b1_launches": b1,
          "predict": "bit-identical to B1's plain version"})


def phase_hist6(ds, bst):
    """B6 against its plain version, bit for bit on int64, on the
    ``efb_train`` group matrix with the first tree's gradients; its time
    from a CUDA graph, its bound and ``torch.bincount`` x 3."""
    from lightgbm_tpu_torch.ops import histogram as H
    gb = bst.boosting
    binned_t = ds.binned_t
    G, n = binned_t.shape
    Bg = int(ds.max_group_bin)
    init = float(np.float32(gb.init_scores[0]))
    grad, hess = gb.objective.get_gradients(
        torch.full((n,), init, dtype=torch.float32, device="cuda"))
    vals = H._vals_t(grad, hess, torch.ones_like(grad)).contiguous()
    scales = H.fixed_point_scales(vals)
    got = H.histogram_fixed(binned_t, vals, Bg, scales)
    want = H.histogram_plain(binned_t, vals, Bg, scales)
    if not torch.equal(got, want):
        raise AssertionError("B6 differs from its plain version")
    err = max(max_abs_err(got[c], want[c]) * 2.0 ** -scales[c]
              for c in range(3))
    del got, want
    idx = (torch.arange(G, device="cuda")[:, None] * Bg
           + binned_t.to(torch.int64)).flatten()
    wts = [vals[c][None, :].expand(G, -1).flatten().contiguous()
           for c in range(3)]

    def library():
        for w in wts:
            torch.bincount(idx, weights=w, minlength=G * Bg)

    row = {"phase": "hist6", "rows": n, "groups": G, "group_bins": Bg,
           "scales": list(scales), "max_abs_err": err,
           "checked": "bit-identical to the plain version (int64)",
           "kernel_ms": graph_ms(
               lambda: H.histogram_fixed(binned_t, vals, Bg, scales), 20),
           "plain_ms": event_ms(
               lambda: H.histogram_plain(binned_t, vals, Bg, scales), 3,
               warmup=1),
           "library_ms": event_ms(library, 5),
           **bytes_or_ops(binned_t.element_size() * G * n + 12 * n
                          + 3 * G * Bg * 8, 3 * n * G)}
    emit(row)
    return row


def same_bits(a, b) -> bool:
    """Two ``NumericFeatureBest`` tuples equal bit for bit."""
    for name in a._fields:
        x, y = getattr(a, name), getattr(b, name)
        if x.dtype == torch.float32:
            x, y = x.view(torch.int32), y.view(torch.int32)
        if not torch.equal(x, y):
            return False
    return True


def quant_check(gb, score, it) -> dict:
    """Quantization on the card against the CPU port, for the gradients
    at ``score`` with the booster's key of iteration ``it``: levels and
    scales must be the same bits (PyTorch's CUDA division by a CPU
    scalar multiplies by the reciprocal, so the scales stay device
    tensors; ``rows_differing_under_cpu_scalar_division`` counts the
    rows whose ``g / scale`` that would have changed)."""
    from lightgbm_tpu_torch.ops.histogram import quantize_gradients
    from lightgbm_tpu_torch.utils import threefry
    n = gb.num_data
    grad, hess = gb.objective.get_gradients(score)
    ones = torch.ones_like(grad)
    key = threefry.fold_in(threefry.fold_in(
        threefry.fold_in(gb._node_key_base, it), 0x51475442), 0)
    bins = gb.config.num_grad_quant_bins
    card = quantize_gradients(grad, hess, ones, bins, key)
    host = quantize_gradients(grad.cpu(), hess.cpu(), ones.cpu(), bins, key)
    same = [torch.equal(a.cpu(), b) for a, b in zip(card[:2], host[:2])]
    same += [np.float32(a.item()).tobytes() == np.float32(b.item()).tobytes()
             for a, b in zip(card[2:], host[2:])]
    if not all(same):
        raise AssertionError(f"the card's quantized gradients differ from "
                             f"the CPU port's (gq, hq, g_scale, h_scale: "
                             f"{same})")
    # what a division by a Python float (a CPU scalar) would have given
    x = grad * ones
    recip_rows = int((x / card[2] != x / float(card[2])).sum())
    return {"rows": n, "iteration": it,
            "distinct_gradients": int(torch.unique(grad).numel()),
            "gq_hq_scales_bit_equal_to_cpu": True,
            "g_scale": float(card[2]), "h_scale": float(card[3]),
            "rows_differing_under_cpu_scalar_division": recip_rows}


def phase_quant_hist(ds, bst):
    """B4, B5 and B2 in the int8/int32 mode against their plain versions
    at one frontier level of the training run (K = 128 slots, about half
    the rows slotted), with int8 levels that ``quantize_gradients`` made
    on the card from the run's last gradients; exact (integer sums), so
    ``max_abs_err`` must be 0.  B4 also at ``b4_shapes`` and
    ``b4_edge_cases``, as in ``phase_hist``.  Kernels timed from CUDA
    graphs; plain versions, ``torch.bincount`` x 2 and
    ``quantize_gradients`` by CUDA events."""
    from lightgbm_tpu_torch.ops import fused
    from lightgbm_tpu_torch.ops.histogram import (_vals_t_int,
                                                  accumulate_plain,
                                                  quantize_gradients)
    from lightgbm_tpu_torch.ops.split import QuantScales
    from lightgbm_tpu_torch.utils import threefry
    gb = bst.boosting
    binned_t = ds.binned_t
    F, n = binned_t.shape
    K, B = HIST_SLOTS, gb.num_bins
    hp = gb.grower_cfg.hp
    mt = gb.meta_t
    nb, mty, db = mt["num_bin"], mt["missing_type"], mt["default_bin"]
    grad, hess = gb.objective.get_gradients(gb.train_score[0])
    ones = torch.ones_like(grad)
    key = threefry.fold_in(threefry.fold_in(threefry.prng_key(0),
                                            0x51475442), 0)

    def quantize():
        return quantize_gradients(grad, hess, ones, 4, key)

    gq, hq, gs, hs = quantize()
    qs = QuantScales(float(gs), float(hs))
    vals = _vals_t_int(gq, hq, ones > 0).contiguous()
    g = torch.Generator(device="cuda").manual_seed(6)
    r = torch.rand(n, device="cuda", generator=g)
    pick = torch.randint(0, K, (n,), device="cuda", generator=g,
                         dtype=torch.int32)
    other = torch.randint(0, K, (n,), device="cuda", generator=g,
                          dtype=torch.int32)
    slot = torch.where(r < 0.5, pick, torch.full_like(pick, K))
    pslot = torch.where(r < 0.5, pick, other)
    parent = accumulate_plain(binned_t, vals, pslot, K, B)
    small_left = torch.rand(K, device="cuda", generator=g) < 0.5

    small = fused.accumulate(binned_t, vals, slot, K, B)
    small_p = accumulate_plain(binned_t, vals, slot, K, B)
    if small.dtype != torch.int32 or not torch.equal(small, small_p):
        raise AssertionError("B4 int8 differs from its plain version")
    err_b4 = max_abs_err(small, small_p)
    del small_p
    children = fused.derive_children(small, small_left, parent)
    n_par = torch.bincount(pslot, minlength=K)
    n_small = torch.bincount(slot[slot < K], minlength=K)
    n_left = torch.where(small_left, n_small, n_par - n_small)
    tot = children[:, :, 0].to(torch.int64).sum(-1).to(torch.float32)
    sums = torch.stack([tot[:, 0] * gs, tot[:, 1] * hs,
                        torch.cat([n_left, n_par - n_left]).float()])

    def b5():
        return fused.sibling_scan(small, qs, sums, nb, mty, db, hp,
                                  small_left=small_left, parent=parent)

    def b5_plain():
        return fused.scan_plain(small, qs, sums, nb, mty, db, hp,
                                small_left=small_left, parent=parent)

    def b2():
        return fused.frontier_splits(binned_t, vals, slot, K, B, qs, sums,
                                     small_left, parent, nb, mty, db, hp)

    def b2_plain():
        seg = accumulate_plain(binned_t, vals, slot, K, B)
        return seg, fused.scan_plain(seg, qs, sums, nb, mty, db, hp,
                                     small_left=small_left, parent=parent)

    best_k5, best_p5 = b5(), b5_plain()
    if not same_bits(best_k5, best_p5):
        raise AssertionError("B5 (quantized) differs from its plain version "
                             "in bits")
    if not bool(torch.isfinite(best_k5.gain).any()):
        raise AssertionError("B5 (quantized) found no split")
    err_b5 = max_abs_err(best_k5, best_p5)
    seg_k, best_k = b2()
    seg_p, best_p = b2_plain()
    if not (torch.equal(seg_k, seg_p) and same_bits(best_k, best_p)):
        raise AssertionError("B2 (int8) differs from its plain version")
    err_b2 = max(max_abs_err(best_k, best_p), max_abs_err(seg_k, seg_p))
    del seg_k, seg_p
    for err in (err_b4, err_b5, err_b2):
        if err != 0.0:
            raise AssertionError(f"an int8 kernel is off by {err}")
    torch.cuda.synchronize()

    m = int((slot < K).sum())
    NC = 2 * K
    hist_bytes = K * 2 * F * B * 4
    tuple_bytes = NC * F * 4 * 6
    scan_ops = NC * F * B * (SCAN_OPS_PER_CELL + QUANT_COUNT_OPS_PER_CELL)
    scan = bytes_or_ops(2 * hist_bytes + 3 * NC * 4 + K * 4 + 3 * F * 4
                        + tuple_bytes, scan_ops)
    shapes = b4_shapes(fused, accumulate_plain, binned_t, vals, None, B,
                       slot, seed=8)
    acc = shapes["frontier"]
    pair = bytes_or_ops(acc["bytes"] + hist_bytes + 3 * NC * 4 + K * 4
                        + 3 * F * 4 + tuple_bytes, acc["ops"] + scan["ops"])
    edges = b4_edge_cases(fused, accumulate_plain, binned_t, vals, None, B)
    rows_out = {
        "fused_frontier_accumulate": dict(acc, max_abs_err=err_b4),
        "fused_slot_order": slot_order_row(fused, slot, K, vals, None),
        "fused_sibling_scan": {
            "kernel_ms": graph_ms(b5, 10),
            "plain_ms": event_ms(b5_plain, 2, warmup=1),
            "library_ms": None, "max_abs_err": err_b5, **scan},
        "fused_frontier_splits": {
            "kernel_ms": graph_ms(b2, 10),
            "plain_ms": event_ms(b2_plain, 2, warmup=1),
            "library_ms": None, "max_abs_err": err_b2, **pair},
    }
    quant_ms = event_ms(quantize, 10)
    emit({"phase": "quant_hist", "rows": n, "features": F, "bins": B,
          "slots": K, "slotted_rows": m, "quant_bins": 4,
          "g_scale": qs.g, "h_scale": qs.h,
          "checked": "exact: equal to the plain versions (int32 sums, "
                     "tuples bit for bit)",
          "b4_shapes": shapes, "b4_edge_cases": edges,
          "quantize_gradients_ms": quant_ms,
          "quantize_gradients_bytes": 8 * n + 2 * n,
          **rows_out})
    return rows_out


def short_quant_run(lt, ds, params, positive, zero):
    """``QUANT_SHORT_ROUNDS`` rounds of ``params`` on a reused dataset, on
    the kernels and then on their plain versions: the model texts must be
    the same bytes.  Returns the kernel run's launch counts."""
    reset_training_counts()
    bst = lt.train(params, ds, QUANT_SHORT_ROUNDS, verbose_eval=False)
    torch.cuda.synchronize()
    launches = kernel_launches()
    expect_launches(launches, positive=positive, zero=zero)
    if not bst.boosting._quant_on or bst.num_trees() != QUANT_SHORT_ROUNDS:
        raise AssertionError("the short run did not train quantized trees")
    saved = plain_kernels()
    try:
        bst_p = lt.train(params, ds, QUANT_SHORT_ROUNDS, verbose_eval=False)
    finally:
        restore_kernels(saved)
    if bst_p.model_to_string() != bst.model_to_string():
        raise AssertionError("the short quantized run's model text differs "
                             "from its plain-version run")
    return launches


def phase_quant_train(lt, f32_run, data, efb_ds):
    """``higgs_quant_1m``: the training run's datasets with
    ``use_quantized_grad`` and LightGBM's defaults, through
    ``training_runs``; then the other branches (16 bins, no stochastic
    rounding, leaf renewal) and the staged arm (the one-hot table), 3
    rounds each.  Returns the main run's launch counts."""
    ds, f32_row = f32_run["ds"], f32_run["row"]
    r = training_runs(lt, *data, QUANT_PARAMS, TRAIN_ROUNDS,
                      datasets=(ds, f32_run["vs"]))
    expect_launches(r["launches"], positive=INT8_ENTRIES,
                    zero=F32_ENTRIES + ("histogram_pallas", "ingest"))
    if not r["bst"].boosting._quant_on:
        raise AssertionError("the quantized run trained f32 histograms")
    gb = r["bst"].boosting
    init = float(np.float32(gb.init_scores[0]))
    checks = [quant_check(gb, torch.full((gb.num_data,), init,
                                         device="cuda"), 0),
              quant_check(gb, gb.train_score[0], TRAIN_ROUNDS)]
    branch = short_quant_run(
        lt, ds, QUANT_BRANCH_PARAMS,
        positive=INT8_ENTRIES + ("fused_frontier_accumulate",
                                 "fused_slot_order"),
        zero=("fused_frontier_splits", "fused_sibling_scan",
              "histogram_pallas"))
    staged = short_quant_run(
        lt, efb_ds, QUANT_PARAMS,
        positive=("fused_frontier_accumulate_int8",
                  "fused_sibling_scan_int8", "fused_slot_order_int8"),
        zero=F32_ENTRIES + ("fused_frontier_splits_int8",
                            "histogram_pallas"))
    row = r["row"]
    cfg = r["bst"].boosting.config
    emit({"phase": "quant_train", "config": "higgs_quant_1m", **row,
          "datasets": "reused from phase train",
          "quant": {k: getattr(cfg, k) for k in (
              "use_quantized_grad", "num_grad_quant_bins",
              "stochastic_rounding", "quant_train_renew_leaf")},
          "round10_vs_f32": {
              "auc": [row["valid_auc"][-1], f32_row["valid_auc"][-1]],
              "logloss": [row["valid_logloss"][-1],
                          f32_row["valid_logloss"][-1]]},
          "quantize_check_first_and_after_last_tree": checks,
          "branch_run": {"rounds": QUANT_SHORT_ROUNDS,
                         "params": {k: QUANT_BRANCH_PARAMS[k] for k in (
                             "num_grad_quant_bins", "stochastic_rounding",
                             "quant_train_renew_leaf")},
                         "launches": branch,
                         "checked": "model text byte-identical to the "
                                    "plain run"},
          "staged_run": {"config": "airline_onehot_1m",
                         "rounds": QUANT_SHORT_ROUNDS, "launches": staged,
                         "checked": "model text byte-identical to the "
                                    "plain run"}})
    return r["launches"]


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
    libs = _build.build(["traverse", "ingest", "fused", "histogram"])
    root = os.path.dirname(os.path.abspath(__file__))
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "libraries": {
              name: {"path": os.path.relpath(lib, root),
                     "fresh": _build.build_info[name]["seconds"] > 0,
                     "ptxas": [ln.strip() for ln in
                               _build.build_info[name]["ptxas"].splitlines()
                               if "registers" in ln or "spill" in ln],
                     **({"accumulate_atomics": sass_atomics(
                         _build, lib, "accumulate_kernel")}
                        if name == "fused" else {})}
              for name, lib in libs.items()}})

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
    del models
    train_run, train_data = phase_train(lt)
    train_launches, ds, bst = (train_run["launches"], train_run["ds"],
                               train_run["bst"])
    ing = phase_ingest(ds, train_data[0])
    hist = phase_hist(ds, bst)
    qhist = phase_quant_hist(ds, bst)
    del ds, bst
    train_run.pop("bst")
    phase_wide_bins(lt)
    efb_launches, efb_ds, efb_bst = phase_efb_train(lt, pk)
    hist6 = phase_hist6(efb_ds, efb_bst)
    del efb_bst
    quant_launches = phase_quant_train(lt, train_run, train_data, efb_ds)
    del train_run, train_data, efb_ds
    phase_cat_train(lt, pk)

    head = rows[("higgs_500x255", TIMED_ROWS[2], False)]
    table = [{
        "name": KERNEL, "route": "cuda",
        "source": "lightgbm_tpu_torch/ops/csrc/traverse.cu",
        "replaces": "lightgbm_tpu/ops/predict_kernels.py:238",
        "launches": launches, "max_abs_err": max_err,
        "ms": head["kernel_ms"], "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
        "library_ms": None}]
    fused_src = "lightgbm_tpu_torch/ops/csrc/fused.cu"
    for name, src, replaces, r in (
            ("ingest", "lightgbm_tpu_torch/ops/csrc/ingest.cu",
             "lightgbm_tpu/ops/ingest.py:233", ing),
            ("fused_frontier_splits", fused_src,
             "lightgbm_tpu/ops/fused.py:151",
             hist["fused_frontier_splits"]),
            ("fused_frontier_accumulate", fused_src,
             "lightgbm_tpu/ops/fused.py:375",
             hist["fused_frontier_accumulate"]),
            ("fused_slot_order", fused_src,
             "lightgbm_tpu/ops/fused.py:375", hist["fused_slot_order"]),
            ("fused_sibling_scan", fused_src,
             "lightgbm_tpu/ops/fused.py:403", hist["fused_sibling_scan"])):
        table.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": train_launches[name],
            "max_abs_err": r["max_abs_err"], "ms": r["kernel_ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    for name, replaces in (
            ("fused_frontier_splits", "lightgbm_tpu/ops/fused.py:151"),
            ("fused_frontier_accumulate", "lightgbm_tpu/ops/fused.py:375"),
            ("fused_slot_order", "lightgbm_tpu/ops/fused.py:375"),
            ("fused_sibling_scan", "lightgbm_tpu/ops/fused.py:403")):
        r = qhist[name]
        table.append({
            "name": f"{name}[int8]", "route": "cuda", "source": fused_src,
            "replaces": replaces, "launches": quant_launches[name + "_int8"],
            "max_abs_err": r["max_abs_err"], "ms": r["kernel_ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    table.append({
        "name": "histogram_pallas", "route": "cuda",
        "source": "lightgbm_tpu_torch/ops/csrc/histogram.cu",
        "replaces": "lightgbm_tpu/ops/histogram.py:199",
        "launches": efb_launches["histogram_pallas"],
        "max_abs_err": hist6["max_abs_err"], "ms": hist6["kernel_ms"],
        "plain_ms": hist6["plain_ms"], "bound_ms": hist6["bound_ms"],
        "bound_by": hist6["bound_by"], "library_ms": hist6["library_ms"]})
    emit({"kernels": table})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
