"""Bottleneck diagnosis (counterpart of ``lightgbm_tpu/obs/diagnose.py``):
measured and planner-predicted signals joined into ranked verdicts, each
with the evidence behind it.

``diagnose`` is a pure function from a flat signal dict to an ordered
list of verdicts, with the JAX package's rules, thresholds, names and
scores verbatim, so the same dict gives the same verdicts in both
packages.  The taxonomy:

- ``dcn-bound``: the slow tier's wire time, under the planner's link
  model, is a material share of an iteration;
- ``compile-bound``: compilation dominates the wall clock;
- ``input-bound``: streaming is on but the block pump does not hide its
  copies, or binning dominates training;
- ``straggler``: one slice's iterations run materially slower (names
  the slice; ``obs.aggregate``'s gauges);
- ``contention``: co-resident training and serving fight over the card:
  training was throttled or paused by brownout signals (evidence: the
  residency ledger's lease table and the event counts,
  ``coresident/scheduler.py``);
- ``kernel-underutilized``: none of the above, and the measured MFU
  (``obs.devprof``'s ``mfu_measured_best``) says the card is mostly
  idle;
- ``healthy``: nothing fired.

Each verdict has a ``score`` in [0, 1] (the ranking is the diagnosis),
a one-line summary and the raw numbers as ``evidence``.

``collect_signals`` assembles the dict from the process registry, the
active ledger and a bench journal's stages.  Two signals of the JAX
package come from modules the port skips on purpose and are never
present here: ``autotune_last`` (the TPU kernel autotuner, which names
the measured-best variant as the ``kernel-underutilized`` cure) and
``ingest_last`` (the TPU ingest election between host and kernel
binning, which the ``input-bound`` verdict of binning names); the rules
that read them keep their generic cure.  Stdlib only.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

# tunable rule thresholds, named so tests and docs can cite them
DCN_FRACTION_MATERIAL = 0.25      # DCN seconds / iteration seconds
COMPILE_FRACTION_MATERIAL = 0.4   # compile / (compile + train) wall
OVERLAP_EFFICIENCY_FLOOR = 1.05   # pump gain below this = no overlap
STRAGGLER_SKEW_MATERIAL = 1.15    # slowest / fastest slice
MFU_HEALTHY_FLOOR = 0.01          # below this the chip is mostly idle
CONTENTION_EVENTS_MATERIAL = 1    # >= this many throttles+pauses fires
BIN_FRACTION_MATERIAL = 0.5       # bin_seconds / train_seconds


@dataclass
class Verdict:
    name: str
    score: float                  # 0..1, comparable across verdicts
    summary: str
    evidence: dict = field(default_factory=dict)

    def to_dict(self) -> dict:
        return {"name": self.name, "score": round(self.score, 4),
                "summary": self.summary, "evidence": self.evidence}


def _num(v, default=0.0):
    try:
        if isinstance(v, bool):
            return float(v)
        return float(v)
    except (TypeError, ValueError):
        return default


def collect_signals(registry=None, stages: Optional[dict] = None) -> dict:
    """Assemble the diagnoser's flat signal dict from the live process
    registry and/or a bench journal's banked stages (either may be
    None/empty; absent signals simply don't fire their rules)."""
    sig: dict = {}
    if registry is None:
        from .metrics import global_registry as registry
    d = registry.to_dict()
    g = d.get("gauges", {})
    for k in ("train_ici_payload_bytes", "train_dcn_payload_bytes",
              "train_num_slices", "train_hier_reduce",
              "train_trees_per_sec", "train_iter_seconds",
              "compile_cache_warm", "pod_straggler_skew",
              "pod_straggler_slice", "pod_ici_payload_bytes",
              "pod_dcn_payload_bytes", "pod_mfu", "mfu_measured_best",
              "host_rss_peak_bytes", "trace_events_dropped"):
        if k in g:
            sig[k] = g[k]
    c = d.get("counters", {})
    sig["slo_breach_total"] = sum(
        v for k, v in c.items() if k.startswith("slo_breach_total"))
    sig["stream_blocks_total"] = c.get("stream_blocks_total", 0)
    # co-residency contention signals: brownout event counters, the
    # residency ledger's lease accounting, and the worst watched p99
    sig["coresident_throttle_total"] = sum(
        v for k, v in c.items()
        if k.startswith("coresident_throttle_total"))
    sig["coresident_pause_total"] = sum(
        v for k, v in c.items() if k.startswith("coresident_pause_total"))
    for k, v in g.items():
        if k.startswith("ledger_leased_bytes"):
            sig["ledger_leased_bytes"] = sig.get("ledger_leased_bytes",
                                                 0.0) + _num(v)
    if "ledger_available_bytes" in g:
        sig["ledger_available_bytes"] = g["ledger_available_bytes"]
    p99s = [_num(v) for k, v in g.items()
            if k.startswith("watchdog_p99_")]
    if p99s:
        sig["watchdog_p99_ms_max"] = max(p99s)
    from ..ops.planner import active_ledger
    lg = active_ledger()
    if lg is not None:
        sig["ledger_lease_table"] = lg.table()
    # bench journal stages refine / supply the workload-scale numbers
    stages = stages or {}
    full = None
    for key, st in stages.items():
        if key == "full" or str(key).startswith("full@"):
            full = st
    full = full or stages.get("smoke")
    if isinstance(full, dict):
        sig.setdefault("sec_per_tree", _num(full.get("sec_per_tree")))
        sig.setdefault("trees", _num(full.get("trees")))
        sig.setdefault("compile_seconds",
                       _num(full.get("compile_seconds")))
        sig.setdefault("train_seconds", _num(full.get("value")))
        cc = full.get("compile_cache")
        if isinstance(cc, dict):
            sig.setdefault("compile_cache_warm",
                           1.0 if cc.get("warm_start") else 0.0)
        mm = full.get("mfu_measured")
        if isinstance(mm, dict):
            best = max((v.get("mfu", 0.0) for v in mm.values()
                        if isinstance(v, dict)), default=0.0)
            if best:
                sig.setdefault("mfu_measured_best", best)
        sig.setdefault("bin_seconds", _num(full.get("bin_seconds")))
        sig.setdefault("bin_rows_per_sec",
                       _num(full.get("bin_rows_per_sec")))
    ip = stages.get("ingest_probe")
    if isinstance(ip, dict):
        sig.setdefault("ingest_kernel_speedup",
                       _num(ip.get("kernel_speedup_vs_host")))
    sp = stages.get("stream_probe")
    if isinstance(sp, dict):
        sig.setdefault("overlap_efficiency",
                       _num(sp.get("overlap_efficiency"), 1.0))
    cp = stages.get("collective_probe")
    if isinstance(cp, dict):
        sig.setdefault("train_ici_payload_bytes", _num(cp.get("ici_bytes")))
        sig.setdefault("train_dcn_payload_bytes", _num(cp.get("dcn_bytes")))
    # the planner's link rates (the model the DCN rule prices bytes with)
    from ..ops.planner import DEFAULT_DCN_GBPS, DEFAULT_ICI_GBPS, _env_gbps
    sig.setdefault("ici_gbps",
                   _env_gbps("LGBM_TPU_ICI_GBPS", DEFAULT_ICI_GBPS))
    sig.setdefault("dcn_gbps",
                   _env_gbps("LGBM_TPU_DCN_GBPS", DEFAULT_DCN_GBPS))
    return sig


def diagnose(signals: dict) -> List[Verdict]:
    """Rank every verdict whose rule fires; ``healthy`` alone when none
    do.  A pure function of the signal dict."""
    out: List[Verdict] = []
    s = signals

    # --- dcn-bound: price the DCN payload with the per-tier link model
    dcn_bytes = _num(s.get("train_dcn_payload_bytes"))
    num_slices = _num(s.get("train_num_slices"), 1.0)
    iter_s = _num(s.get("train_iter_seconds")) or \
        _num(s.get("sec_per_tree"))
    if dcn_bytes > 0 and num_slices > 1 and iter_s > 0:
        dcn_s = dcn_bytes / (_num(s.get("dcn_gbps"), 6.25) * 1e9)
        frac = dcn_s / iter_s
        if frac >= DCN_FRACTION_MATERIAL:
            out.append(Verdict(
                "dcn-bound", min(frac, 1.0),
                f"DCN wire time ~{frac:.0%} of each iteration "
                f"({dcn_bytes / 1e6:.1f} MB/sync at "
                f"{_num(s.get('dcn_gbps'), 6.25):g} GB/s across "
                f"{int(num_slices)} slices) — elect voting-parallel or "
                "shrink the cross-slice payload",
                {"dcn_payload_bytes": dcn_bytes,
                 "dcn_gbps": _num(s.get("dcn_gbps"), 6.25),
                 "dcn_seconds_per_sync": dcn_s,
                 "iter_seconds": iter_s, "fraction": round(frac, 4),
                 "num_slices": int(num_slices),
                 "hier_reduce": bool(_num(s.get("train_hier_reduce")))}))

    # --- compile-bound: one-time XLA compile vs the steady-state train
    comp = _num(s.get("compile_seconds"))
    train = _num(s.get("train_seconds"))
    if comp > 0 and (comp + train) > 0:
        frac = comp / (comp + train)
        warm = bool(_num(s.get("compile_cache_warm")))
        if frac >= COMPILE_FRACTION_MATERIAL:
            out.append(Verdict(
                "compile-bound", min(frac, 1.0),
                f"XLA compilation is {frac:.0%} of wall-clock "
                f"({comp:.1f}s compile vs {train:.1f}s train); compile "
                f"cache {'WARM — shapes are churning' if warm else 'COLD'}"
                " — set LGBM_TPU_COMPILE_CACHE / stop varying shapes",
                {"compile_seconds": comp, "train_seconds": train,
                 "fraction": round(frac, 4),
                 "compile_cache_warm": warm}))

    # --- input/stream-bound: the pump isn't hiding host->device puts
    streaming = _num(s.get("stream_blocks_total")) > 0 or \
        "overlap_efficiency" in s
    if streaming and "overlap_efficiency" in s:
        eff = _num(s.get("overlap_efficiency"), 1.0)
        if eff < OVERLAP_EFFICIENCY_FLOOR:
            score = min(max((OVERLAP_EFFICIENCY_FLOOR - eff) * 4 + 0.4,
                            0.0), 1.0)
            out.append(Verdict(
                "input-bound", score,
                f"block pump overlap efficiency {eff:.2f} (< "
                f"{OVERLAP_EFFICIENCY_FLOOR}): device compute is waiting "
                "on host reads/puts — deepen prefetch, grow blocks, or "
                "speed the spill store",
                {"overlap_efficiency": eff,
                 "stream_blocks_total":
                     int(_num(s.get("stream_blocks_total"))),
                 "floor": OVERLAP_EFFICIENCY_FLOOR}))

    # --- input-bound (ingest flavor): binning dominates training wall
    # clock (the JAX package's ingest_last evidence is never present
    # here: module docstring)
    bin_s = _num(s.get("bin_seconds"))
    train_s = _num(s.get("train_seconds"))
    if bin_s > 0 and train_s > 0:
        frac = bin_s / train_s
        if frac >= BIN_FRACTION_MATERIAL:
            ev = {"bin_seconds": bin_s, "train_seconds": train_s,
                  "fraction": round(frac, 4),
                  "threshold": BIN_FRACTION_MATERIAL}
            if _num(s.get("bin_rows_per_sec")):
                ev["bin_rows_per_sec"] = _num(s.get("bin_rows_per_sec"))
            cure = ("route construction through the device ingest kernel "
                    "(ops/ingest.py)")
            out.append(Verdict(
                "input-bound", min(0.3 + 0.4 * frac, 1.0),
                f"Dataset binning took {bin_s:.1f}s against {train_s:.1f}"
                f"s of training ({frac:.0%}): construction is the "
                f"bottleneck — {cure}",
                ev))

    # --- straggler: one slice materially slower than its peers
    skew = _num(s.get("pod_straggler_skew"), 1.0)
    if skew >= STRAGGLER_SKEW_MATERIAL:
        slice_k = int(_num(s.get("pod_straggler_slice")))
        out.append(Verdict(
            "straggler", min((skew - 1.0), 1.0),
            f"slice {slice_k} runs {skew:.2f}x slower than the fastest "
            "slice — check its hosts (thermal, neighbors, failing "
            "links); elastic shrink-rejoin can drop it",
            {"straggler_slice": slice_k, "straggler_skew": skew,
             "threshold": STRAGGLER_SKEW_MATERIAL}))

    # --- contention: co-resident planes fighting over the same devices
    thr = _num(s.get("coresident_throttle_total"))
    pauses = _num(s.get("coresident_pause_total"))
    if thr + pauses >= CONTENTION_EVENTS_MATERIAL:
        ev = {"coresident_throttle_total": int(thr),
              "coresident_pause_total": int(pauses)}
        for k in ("ledger_leased_bytes", "ledger_available_bytes",
                  "watchdog_p99_ms_max"):
            if k in s:
                ev[k] = s[k]
        table = s.get("ledger_lease_table")
        if isinstance(table, list):
            ev["ledger_lease_table"] = table
        # pauses weigh double: a pause means the brownout persisted past
        # throttling - deeper contention than a transient spike
        out.append(Verdict(
            "contention",
            min(0.4 + 0.05 * (thr + 2.0 * pauses), 0.9),
            f"co-resident training was throttled {int(thr)}x and paused "
            f"{int(pauses)}x by serving brownout signals — train and "
            "serve are contending for the same devices; shrink the "
            "training chunk cap / lease, move the refresh off-peak, or "
            "give serving its own devices",
            ev))

    # --- kernel-underutilized: nothing specific, chip still idle
    mfu = s.get("mfu_measured_best")
    if mfu is not None and _num(mfu) < MFU_HEALTHY_FLOOR and not out:
        mfu = _num(mfu)
        ev = {"mfu_measured_best": mfu, "floor": MFU_HEALTHY_FLOOR}
        cure = ("batch boosters over a model axis or widen the fused "
                "frontier")
        out.append(Verdict(
            "kernel-underutilized",
            min(0.3 + (MFU_HEALTHY_FLOOR - mfu) / MFU_HEALTHY_FLOOR * 0.4,
                0.7),
            f"best measured kernel MFU {mfu:.5f} (< {MFU_HEALTHY_FLOOR})"
            " with no specific bottleneck: per-level work is too small "
            f"for the MXU — {cure}",
            ev))

    if not out:
        return [Verdict("healthy", 1.0,
                        "no rule fired: no dominant bottleneck in the "
                        "measured signals", {})]
    out.sort(key=lambda v: v.score, reverse=True)
    return out


def diagnosis_summary(verdicts: List[Verdict],
                      signals: Optional[dict] = None) -> dict:
    """JSON-ready report (the bench stage / CLI last-line shape)."""
    out = {
        "top_verdict": verdicts[0].name if verdicts else "healthy",
        "verdicts": [v.to_dict() for v in verdicts],
    }
    if signals is not None:
        out["signals"] = {k: v for k, v in sorted(signals.items())
                          if isinstance(v, (int, float, str, bool))}
    return out


def run_doctor(registry=None, stages: Optional[dict] = None) -> dict:
    """collect -> diagnose -> summarize in one call (the entry point of
    ``tools/obs_doctor.py``)."""
    signals = collect_signals(registry=registry, stages=stages)
    return diagnosis_summary(diagnose(signals), signals)
