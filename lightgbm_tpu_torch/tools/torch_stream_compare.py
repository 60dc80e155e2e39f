"""Where a streamed tree's time goes, on one card.

    python3 -m lightgbm_tpu_torch.tools.torch_stream_compare [--rows N]
        [--rounds R] [--block-rows B] [--label NAME]
        [--what pump,train,bulk,ingest,memory,csr] [--profile]

Builds the HIGGS-width rows of ``testing.higgs_like`` (28 f32 features,
seed 11), spills them through ``Dataset.from_sample`` + ``push_rows`` in
``--block-rows`` blocks and bins a resident twin, then prints one JSON
line.  Each comparison runs the pumps reading a block when it is asked
for and under ``data.stream.ReadAhead``, a daemon reader thread two
blocks ahead, in alternation:

- ``pump``: a ``BlockPump`` pass alone (store -> card), its file reads
  alone and its copies to the card alone;
- ``train``: seconds a tree of ``--rounds`` streamed rounds (255 leaves)
  after a warm-up tree, two pairs, each mode first in one; with a
  section timer (the card synchronised at each section); and of the
  resident twin;
- ``bulk``: ``BulkScorer.run`` rows/s over the f32 rows in 65,536-row
  blocks; ``ingest``: the spilled ``from_sample`` + ``push_rows``
  construct's seconds;
- ``memory``: the live tensors at the card's allocation peak of a
  booster's first ``--rounds`` trees (streamed and resident, f32 and
  quantized), summed by the first frame in the package that allocated
  them (the allocator's history), beside the planner's prediction;
- ``csr``: seconds of the one-hot airline CSR construct (1 M rows, 674
  columns), which needs only ``Dataset`` and ``testing``, so the script
  can time an older checkout of the package
  (``PYTHONPATH=<checkout> python3 <this file> --what csr``).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import shutil
import subprocess
import tempfile
import time

import torch

PARAMS = {"objective": "binary", "num_leaves": 255, "max_bin": 255,
          "learning_rate": 0.1, "verbose": -1}
MODES = ("sync", "read_ahead")


def _sync():
    torch.cuda.synchronize()
    return time.perf_counter()


@contextlib.contextmanager
def pumps_in(mode: str):
    """Every pump built in the block runs in ``mode``: ``sync``, a block
    read when it is asked for (bulk scoring's ``ReadAhead`` taken off),
    or ``read_ahead``, under ``data.stream.ReadAhead`` (the streamed
    grower's and the ingest pumps put under it)."""
    from lightgbm_tpu_torch.data import score as score_mod
    from lightgbm_tpu_torch.data import stream as stream_mod
    saved = (stream_mod.BlockPump, stream_mod.IngestPump,
             score_mod.ReadAhead)
    if mode == "sync":
        score_mod.ReadAhead = lambda pump: pump
    else:
        def wrap(cls):
            return lambda *a, **k: stream_mod.ReadAhead(cls(*a, **k))
        stream_mod.BlockPump = wrap(saved[0])
        stream_mod.IngestPump = wrap(saved[1])
    try:
        yield
    finally:
        (stream_mod.BlockPump, stream_mod.IngestPump,
         score_mod.ReadAhead) = saved


def pump_pass_ms(store, mode: str, passes: int = 5) -> float:
    from lightgbm_tpu_torch.data import BlockPump, ReadAhead
    pump = BlockPump(store, "cuda")
    pump = ReadAhead(pump) if mode == "read_ahead" else pump
    for _ in pump:                       # warm: buffers, checksums
        pass
    t0 = _sync()
    for _ in range(passes):
        for _ in pump:
            pass
    return (_sync() - t0) / passes * 1e3


def read_pass_ms(store, passes: int = 5) -> float:
    """The store's blocks read into one pinned host buffer (``readinto``),
    no copy to the card."""
    buf = torch.empty(store.num_cols * store.block_rows
                      * store.dtype.itemsize, dtype=torch.uint8,
                      pin_memory=True).numpy().view(store.dtype)
    t0 = time.perf_counter()
    for _ in range(passes):
        for i in range(store.num_blocks):
            store.read_block(i, out=buf)
    return (time.perf_counter() - t0) / passes * 1e3


def copy_pass_ms(store, passes: int = 5) -> float:
    """One pass's bytes copied from a pinned host buffer to the card a
    block at a time, no file read."""
    nb = store.num_cols * store.block_rows * store.dtype.itemsize
    src = torch.empty(nb, dtype=torch.uint8, pin_memory=True)
    dst = torch.empty(nb, dtype=torch.uint8, device="cuda")
    t0 = _sync()
    for _ in range(passes):
        for _i in range(store.num_blocks):
            dst.copy_(src, non_blocking=True)
    return (_sync() - t0) / passes * 1e3


def train_s(lt, ds, rounds: int, mode: str = "sync", timer=False):
    from lightgbm_tpu_torch.utils.timer import SectionTimer
    with pumps_in(mode):
        bst = lt.Booster(dict(PARAMS), train_set=ds)
    g = bst.boosting.grower
    if timer:
        bst.boosting.timer = SectionTimer(cuda=True)
    t0 = _sync()
    for _ in range(rounds):
        bst.update()
    s = (_sync() - t0) / rounds
    out = {"s_per_tree": s}
    if timer:
        out["sections_s_per_tree"] = {
            k: v / rounds for k, v in bst.boosting.timer.seconds.items()}
    if hasattr(g, "pump"):
        out["passes_per_tree"] = g.pump.passes / rounds
    return out, bst.model_to_string()


def bulk_rows_per_s(lt, X, y, block_rows: int = 65_536, reps: int = 3):
    """``BulkScorer.run`` over X in ``block_rows``-row blocks in each
    pump mode, alternating: rows/s each."""
    from lightgbm_tpu_torch.data import BlockStore, BulkScorer
    from lightgbm_tpu_torch.predict import DeviceForest
    ds = lt.Dataset(X, label=y, device="cuda")
    bst = lt.Booster(dict(PARAMS), train_set=ds)
    for _ in range(10):
        bst.update()
    dev = DeviceForest(bst._forest(0, 10), "cuda")
    tmp = tempfile.mkdtemp(prefix="lgbt-bulk-compare-")
    out = {m: [] for m in MODES}
    try:
        store = BlockStore.from_array(os.path.join(tmp, "x"), X, block_rows)
        BulkScorer(dev, store, os.path.join(tmp, "warm")).run()
        for r in range(reps):
            for mode in MODES:
                sink = os.path.join(tmp, f"{mode}{r}")
                with pumps_in(mode):
                    st = BulkScorer(dev, store, sink).run()
                out[mode].append(st["rows_per_sec"])
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out


def ingest_s(lt, X, block_rows: int, reps: int = 3):
    """The spilled ``from_sample`` + ``push_rows`` construct (100,000-row
    f32 chunks through B3) in each pump mode, alternating: seconds
    each."""
    tmp = tempfile.mkdtemp(prefix="lgbt-ingest-compare-")
    out = {m: [] for m in MODES}
    n = len(X)
    try:
        for r in range(reps + 1):
            for mode in MODES:
                with pumps_in(mode):
                    t0 = _sync()
                    ds = lt.Dataset.from_sample(
                        X[:200_000], n, spill=os.path.join(tmp, f"{mode}{r}"),
                        spill_block_rows=block_rows, device="cuda")
                    for s in range(0, n, 100_000):
                        ds.push_rows(X[s:s + 100_000])
                    s = _sync() - t0
                if r:                                # the first is warm-up
                    out[mode].append(s)
                del ds
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out


def _peak_breakdown(fn, top: int = 20) -> dict:
    """Run ``fn`` under the CUDA allocator's history and replay it: the
    bytes above the start at the peak, and the tensors live at that
    moment summed by the first frame in ``lightgbm_tpu_torch`` that
    allocated them."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.memory._record_memory_history(stacks="python",
                                              max_entries=2_000_000)
    try:
        fn()
        torch.cuda.synchronize()
        snap = torch.cuda.memory._snapshot()
    finally:
        torch.cuda.memory._record_memory_history(enabled=None)
    peak_alloc = torch.cuda.max_memory_allocated() - base
    live, cur, best, at_peak = {}, 0, 0, {}
    for ev in snap["device_traces"][0]:
        act, addr = ev["action"], ev["addr"]
        if act == "alloc":
            live[addr] = ev
            cur += ev["size"]
            if cur > best:
                best, at_peak = cur, dict(live)
        elif act in ("free_requested", "free_completed") and addr in live:
            cur -= live.pop(addr)["size"]
    sites: dict = {}
    for ev in at_peak.values():
        site = "?"
        for fr in ev.get("frames", []):
            if "lightgbm_tpu_torch" in fr.get("filename", ""):
                site = (fr["filename"].split("lightgbm_tpu_torch/")[-1]
                        + f":{fr['line']} {fr['name']}")
                break
        sites[site] = sites.get(site, 0) + ev["size"]
    rows = sorted(sites.items(), key=lambda kv: -kv[1])[:top]
    return {"peak_bytes": peak_alloc, "replayed_peak_bytes": best,
            "sites": [{"site": k, "bytes": v} for k, v in rows]}


def memory_breakdown(lt, sds, rds, rounds: int) -> dict:
    """``_peak_breakdown`` of a booster's construction and first
    ``rounds`` trees, streamed and resident, f32 and quantized, beside
    the planner's predictions."""
    from lightgbm_tpu_torch.ops import planner
    out = {}
    n, F = rds.binned_t.shape[1], rds.binned_t.shape[0]
    for quant in (False, True):
        params = dict(PARAMS, use_quantized_grad=quant)
        for name, ds in (("streamed", sds), ("resident", rds)):
            box = {}

            def run():
                bst = lt.Booster(dict(params), train_set=ds)
                for _ in range(rounds):
                    bst.update()
                box["plan"] = bst.boosting.stream_plan
            row = _peak_breakdown(run)
            if name == "streamed":
                row["predicted"] = box["plan"].predicted_device_peak_bytes
            else:
                row["predicted"] = planner.predict_peak_bytes(
                    n, F, 255, PARAMS["num_leaves"], 1, quant)[0]
            out[f"{name}[quant={quant}]"] = row
    return out


def csr_construct_s(reps: int = 3) -> list:
    """Seconds of ``Dataset(csr).construct()`` on the card for the
    one-hot airline rows (``testing.one_hot_csr``), ``reps`` times."""
    import lightgbm_tpu_torch as lt
    from lightgbm_tpu_torch.testing import airline_like, one_hot_csr
    X8, y = airline_like(1_000_000, seed=11)
    csr = one_hot_csr(X8)
    del X8
    lt.Dataset(csr[:70_000], label=y[:70_000]).construct()      # warm
    out = []
    for _ in range(reps):
        t0 = _sync()
        ds = lt.Dataset(csr, label=y, free_raw_data=False).construct()
        out.append(_sync() - t0)
        del ds
    return out


def profile_tree(lt, ds, top: int = 25) -> dict:
    """One streamed tree under ``torch.profiler``: its wall seconds, the
    device's busy milliseconds and the ``top`` ops by host time."""
    from torch.profiler import ProfilerActivity, profile
    bst = lt.Booster(dict(PARAMS), train_set=ds)
    bst.update()                              # warm
    t0 = _sync()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        bst.update()
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    ka = prof.key_averages()
    rows = sorted(ka, key=lambda e: e.self_cpu_time_total, reverse=True)
    dev_us = sum(getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0)) for e in ka)
    return {"wall_s": wall, "device_ms": dev_us / 1e3,
            "top_host_ops": [
                {"op": e.key, "calls": e.count,
                 "self_host_ms": e.self_cpu_time_total / 1e3}
                for e in rows[:top]]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=int, default=1_000_000)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--block-rows", type=int, default=131_072)
    ap.add_argument("--label", default="")
    ap.add_argument("--what", default="pump,train",
                    help="comma-separated: pump, train, bulk, ingest, "
                         "memory, csr")
    ap.add_argument("--profile", action="store_true",
                    help="also profile one streamed tree (torch.profiler: "
                         "the ops of most host time, and the device time)")
    a = ap.parse_args(argv)
    what = set(a.what.split(","))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()
    if what == {"csr"}:
        print(json.dumps({"label": a.label, "csr_construct_s":
                          csr_construct_s(), "nvidia_smi": smi}),
              flush=True)
        return 0
    import lightgbm_tpu_torch as lt
    from lightgbm_tpu_torch.ops import _build
    from lightgbm_tpu_torch.testing import higgs_like
    _build.build(["ingest", "fused", "histogram", "traverse"])
    X, y = higgs_like(a.rows, seed=11)
    tmp = tempfile.mkdtemp(prefix="lgbt-stream-compare-")
    try:
        datasets = []
        for spill in (os.path.join(tmp, "st"), None):
            ds = lt.Dataset.from_sample(X[:200_000], a.rows, spill=spill,
                                        spill_block_rows=a.block_rows,
                                        device="cuda")
            for s in range(0, a.rows, 100_000):
                ds.push_rows(X[s:s + 100_000])
            ds.set_label(y)
            datasets.append(ds)
        sds, rds = datasets
        store = sds._block_store
        row = {"label": a.label, "rows": a.rows, "rounds": a.rounds,
               "blocks": store.num_blocks, "store_bytes": store.nbytes(),
               "nvidia_smi": smi}
        texts = set()
        if "pump" in what:
            for mode in MODES:
                ms = pump_pass_ms(store, mode)
                row[f"pump_pass_ms[{mode}]"] = ms
                row[f"pump_gb_per_s[{mode}]"] = store.nbytes() / ms / 1e6
            row["read_pass_ms"] = read_pass_ms(store)
            row["copy_pass_ms"] = copy_pass_ms(store)
        if "train" in what:
            # a first streamed booster pays the process's warm-up; then
            # the two modes alternate, each first in one pair
            train_s(lt, sds, 1)
            for order in (MODES, MODES[::-1]):
                for mode in order:
                    out, text = train_s(lt, sds, a.rounds, mode)
                    row.setdefault(f"streamed[{mode}]", []).append(out)
                    texts.add(text)
            row["streamed_timer"], text = train_s(lt, sds, a.rounds,
                                                  timer=True)
            texts.add(text)
            row["resident"], text = train_s(lt, rds, a.rounds)
            texts.add(text)
        if "memory" in what:
            row["memory"] = memory_breakdown(lt, sds, rds, a.rounds)
        if "ingest" in what:
            row["ingest_s"] = ingest_s(lt, X, a.block_rows)
        if "bulk" in what:
            row["bulk_rows_per_s"] = bulk_rows_per_s(lt, X, y)
        if "csr" in what:
            row["csr_construct_s"] = csr_construct_s()
        if a.profile:
            row["profile"] = profile_tree(lt, sds)
        row["texts_equal"] = len(texts) <= 1
        print(json.dumps(row), flush=True)
        return 0 if row["texts_equal"] else 1
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


if __name__ == "__main__":
    raise SystemExit(main())
