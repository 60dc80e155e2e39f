"""obs_doctor: ranked bottleneck verdicts from a bench journal and a
metrics snapshot (counterpart of the JAX package's ``tools/obs_doctor.py``;
the rules are ``lightgbm_tpu_torch.obs.diagnose``'s).

It joins measured signals (``obs.devprof``'s MFU, stream overlap,
straggler skew, the co-resident scheduler's throttles and pauses) with
the planner's (per-tier payload bytes, link rates) and prints ranked
verdicts, "dcn-bound", "compile-bound", "input-bound", "straggler",
"contention" (with the residency ledger's lease table) and
"kernel-underutilized", each with its evidence.  The last line of
standard output is one JSON summary.

Usage::

    python -m lightgbm_tpu_torch.tools.obs_doctor \\
        [--journal bench_journal.json]   # a journal's stages
        [--metrics bench_out/bench_obs_metrics.json]  # a registry snapshot
        [--json-only]

Absent files read as empty (the doctor then reads this process's own
registry, which is empty in a fresh process).  Exit codes: 0 =
diagnosed, whatever the verdict; 2 = an input file is unreadable.
"""

import argparse
import json
import os
import sys


def load_journal_stages(path):
    """The stages of a bench journal ({} where absent): the fingerprint-
    wrapped layout or a bare map of stages."""
    if not path or not os.path.exists(path):
        return {}
    with open(path) as fh:
        d = json.load(fh)
    if isinstance(d, dict) and isinstance(d.get("stages"), dict):
        return d["stages"]
    return d if isinstance(d, dict) else {}


def load_metrics_snapshot(path):
    """A registry snapshot (``MetricsRegistry.dump_json``) wrapped so that
    ``collect_signals`` reads it as a live registry (only ``to_dict`` is
    called); None where absent."""
    if not path or not os.path.exists(path):
        return None
    with open(path) as fh:
        snap = json.load(fh)

    class _Snap:
        def to_dict(self):
            return snap

    return _Snap()


def run_doctor(stages=None, registry=None):
    """collect -> diagnose -> summary (the process registry where
    ``registry`` is None)."""
    from lightgbm_tpu_torch.obs.diagnose import run_doctor as _run
    return _run(registry=registry, stages=stages)


def format_human(report):
    lines = [f"obs_doctor: top verdict = {report['top_verdict']}", ""]
    for i, v in enumerate(report["verdicts"], 1):
        lines.append(f"{i}. [{v['name']}] score={v['score']:.2f}")
        lines.append(f"   {v['summary']}")
        if v["evidence"]:
            ev = ", ".join(f"{k}={v['evidence'][k]}"
                           for k in sorted(v["evidence"]))
            lines.append(f"   evidence: {ev}")
    return "\n".join(lines)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--journal", default="bench_journal.json")
    ap.add_argument("--metrics",
                    default=os.path.join("bench_out",
                                         "bench_obs_metrics.json"))
    ap.add_argument("--json-only", action="store_true")
    args = ap.parse_args(argv)
    try:
        stages = load_journal_stages(args.journal)
        registry = load_metrics_snapshot(args.metrics)
    except (OSError, ValueError) as e:
        print(json.dumps({"error": f"unreadable input: {e}"}))
        return 2
    report = run_doctor(stages=stages, registry=registry)
    if not args.json_only:
        print(format_human(report))
    print(json.dumps(report, sort_keys=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
