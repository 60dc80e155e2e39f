"""Pod telemetry (counterpart of ``lightgbm_tpu/obs/aggregate.py``):
fixed-layout metric vectors, one a rank, gathered at eval boundaries.

Each rank packs a fixed layout (``METRIC_LAYOUT``) of float64 slots read
from its process registry; the vectors travel through
``resilience.retry.resilient_allgather`` (CRC framing and a verdict all
ranks agree on: a telemetry round never wedges training and never mixes
rounds), and every rank derives the same pod view:

- **straggler gauge**: the mean iteration seconds of each slice (slice
  = rank // devices_per_slice, the two-tier mesh's row-major order), the
  skew (slowest slice over fastest) and which slice is the straggler;
- **summed per-tier payload bytes**: the pod's wire load on the fast
  and the slow tier, not one rank's share;
- **pod MFU**: the mean of the ranks' measured MFU (``obs.devprof``'s
  ``mfu_measured_best`` gauge; 0 where unmeasured).

The view lands as ``pod_*`` gauges of the registry and a
``pod.telemetry`` trace instant, and returns as a ``PodTelemetry``;
``obs.diagnose`` reads ``pod_straggler_skew``/``pod_straggler_slice``
from those gauges.  The frame (magic, version, ``struct`` layout) is the
JAX package's byte for byte, so the two packages' ranks read each
other's frames.

``engine.train`` gathers at each evaluation only where a transport is
registered (``register_pod_transport``; the port's is
``parallel.collectives.all_gather_bytes`` over the training group, e.g.
``lambda b: all_gather_bytes(b, group)``): a lone process never pays a
round.  Stdlib only.
"""

from __future__ import annotations

import struct
import threading
import time
from dataclasses import dataclass
from typing import Callable, List, Optional

# the fixed layout, one float64 a slot.  Append only: reordering or
# removing slots breaks pods of mixed versions; the header's version
# changes with any layout change.
METRIC_LAYOUT = (
    "iter_seconds",          # last engine step wall-clock / iteration
    "trees_per_sec",         # live training rate
    "ici_payload_bytes",     # per-sync fast-tier bytes (planner model)
    "dcn_payload_bytes",     # per-sync slow-tier bytes (planner model)
    "mfu",                   # measured MFU (devprof), 0 when unmeasured
    "host_rss_peak_bytes",   # streaming host watermark
    "compile_cache_warm",    # 0/1
    "slo_breach_total",      # watchdog breaches seen by this rank
)

_MAGIC = b"LGPM"
_VERSION = 1
_HEAD = struct.Struct("<4sBI")            # magic, version, rank


def pack_rank_vector(values: dict, rank: int) -> bytes:
    """``values`` (a missing slot is 0.0) in the fixed wire layout."""
    vec = [float(values.get(k, 0.0) or 0.0) for k in METRIC_LAYOUT]
    return (_HEAD.pack(_MAGIC, _VERSION, int(rank))
            + struct.pack(f"<{len(METRIC_LAYOUT)}d", *vec))


def unpack_rank_vector(blob: bytes) -> "tuple[int, dict]":
    """(rank, {slot: value}); raises ValueError on a foreign frame."""
    if len(blob) < _HEAD.size:
        raise ValueError(f"short pod-metric frame ({len(blob)} bytes)")
    magic, ver, rank = _HEAD.unpack(blob[:_HEAD.size])
    if magic != _MAGIC:
        raise ValueError("bad pod-metric magic")
    if ver != _VERSION:
        raise ValueError(f"pod-metric layout version {ver} != {_VERSION}")
    body = blob[_HEAD.size:]
    n = len(body) // 8
    vals = struct.unpack(f"<{n}d", body[:n * 8])
    return int(rank), dict(zip(METRIC_LAYOUT, vals))


def local_vector(registry=None) -> dict:
    """This rank's slot values from the process registry's gauges and
    counters (an absent instrument reads 0)."""
    if registry is None:
        from .metrics import global_registry as registry
    d = registry.to_dict()
    g, c = d.get("gauges", {}), d.get("counters", {})

    def num(v):
        return float(v) if isinstance(v, (int, float)) \
            and not isinstance(v, bool) else 0.0

    breaches = sum(v for k, v in c.items()
                   if k.startswith("slo_breach_total"))
    return {
        "iter_seconds": num(g.get("train_iter_seconds", 0.0)),
        "trees_per_sec": num(g.get("train_trees_per_sec_live",
                                   g.get("train_trees_per_sec", 0.0))),
        "ici_payload_bytes": num(g.get("train_ici_payload_bytes", 0.0)),
        "dcn_payload_bytes": num(g.get("train_dcn_payload_bytes", 0.0)),
        "mfu": num(g.get("mfu_measured_best", 0.0)),
        "host_rss_peak_bytes": num(g.get("host_rss_peak_bytes", 0.0)),
        "compile_cache_warm": num(g.get("compile_cache_warm", 0.0)),
        "slo_breach_total": float(breaches),
    }


@dataclass
class PodTelemetry:
    """The pod view every rank derives alike."""

    world: int
    num_slices: int
    devices_per_slice: int
    per_rank: List[dict]                 # slot dicts in rank order
    slice_iter_seconds: List[float]      # each slice's mean iteration s
    straggler_slice: int
    straggler_skew: float                # slowest / fastest slice
    pod_ici_payload_bytes: float
    pod_dcn_payload_bytes: float
    pod_mfu: float

    def summary(self) -> dict:
        return {
            "world": self.world,
            "num_slices": self.num_slices,
            "devices_per_slice": self.devices_per_slice,
            "slice_iter_seconds": [round(s, 6)
                                   for s in self.slice_iter_seconds],
            "straggler_slice": self.straggler_slice,
            "straggler_skew": round(self.straggler_skew, 4),
            "pod_ici_payload_bytes": int(self.pod_ici_payload_bytes),
            "pod_dcn_payload_bytes": int(self.pod_dcn_payload_bytes),
            "pod_mfu": round(self.pod_mfu, 6),
        }


def derive_pod_view(per_rank: List[dict], num_slices: int) -> PodTelemetry:
    """The pod view of rank-ordered vectors (a pure function: the live
    gather's and the tests')."""
    world = len(per_rank)
    s = max(int(num_slices), 1)
    dps = max(world // s, 1)
    slice_iters = []
    for k in range(s):
        members = per_rank[k * dps:(k + 1) * dps]
        vals = [m.get("iter_seconds", 0.0) for m in members] or [0.0]
        slice_iters.append(sum(vals) / len(vals))
    fastest = min((v for v in slice_iters if v > 0), default=0.0)
    slowest = max(slice_iters, default=0.0)
    skew = (slowest / fastest) if fastest > 0 else 1.0
    straggler = slice_iters.index(slowest) if slice_iters else 0
    mfus = [m.get("mfu", 0.0) for m in per_rank]
    return PodTelemetry(
        world=world, num_slices=s, devices_per_slice=dps,
        per_rank=per_rank, slice_iter_seconds=slice_iters,
        straggler_slice=straggler, straggler_skew=skew,
        pod_ici_payload_bytes=sum(m.get("ici_payload_bytes", 0.0)
                                  for m in per_rank),
        pod_dcn_payload_bytes=sum(m.get("dcn_payload_bytes", 0.0)
                                  for m in per_rank),
        pod_mfu=(sum(mfus) / len(mfus)) if mfus else 0.0)


def _publish(view: PodTelemetry, registry=None) -> None:
    if registry is None:
        from .metrics import global_registry as registry
    registry.gauge("pod_straggler_skew").set(round(view.straggler_skew, 4))
    registry.gauge("pod_straggler_slice").set(view.straggler_slice)
    registry.gauge("pod_ici_payload_bytes").set(
        int(view.pod_ici_payload_bytes))
    registry.gauge("pod_dcn_payload_bytes").set(
        int(view.pod_dcn_payload_bytes))
    registry.gauge("pod_mfu").set(round(view.pod_mfu, 6))
    registry.gauge("pod_world").set(view.world)
    from .trace import instant
    instant("pod.telemetry", **view.summary())


def gather_pod_metrics(allgather_bytes: Callable[[bytes], List[bytes]],
                       *, world: int, rank: int, num_slices: int = 1,
                       registry=None, config=None,
                       values: Optional[dict] = None) -> PodTelemetry:
    """One telemetry round: pack the local vector, gather it resiliently,
    derive and publish the pod view.  Raises ``CollectiveError`` only
    where the transport itself is down."""
    from ..resilience.retry import ResilienceConfig, resilient_allgather
    cfg = config or ResilienceConfig(deadline_s=10.0, max_retries=2)
    payload = pack_rank_vector(
        values if values is not None else local_vector(registry), rank)
    # flight_dump=False: the caller logs a failed telemetry round and
    # goes on; it must not spend the bounded forensic dump budget
    parts = resilient_allgather(payload, allgather_bytes, world=world,
                                rank=rank, config=cfg,
                                label="pod_telemetry", metrics=registry,
                                flight_dump=False)
    decoded = sorted((unpack_rank_vector(p) for p in parts),
                     key=lambda rv: rv[0])
    view = derive_pod_view([v for _r, v in decoded], num_slices)
    _publish(view, registry)
    return view


# ---------------------------------------------------------------- engine seam

_transport_lock = threading.Lock()
_transport: Optional[dict] = None


def register_pod_transport(allgather_bytes: Callable[[bytes], List[bytes]],
                           *, world: int, rank: int,
                           num_slices: int = 1) -> None:
    """Install the process's telemetry transport (any ``allgather_bytes``
    of bytes to the ranks' bytes); ``engine.train`` then gathers at
    every evaluation, until ``clear_pod_transport``."""
    global _transport
    with _transport_lock:
        _transport = {"fn": allgather_bytes, "world": int(world),
                      "rank": int(rank), "num_slices": int(num_slices)}


def clear_pod_transport() -> None:
    global _transport
    with _transport_lock:
        _transport = None


def maybe_gather_at_eval(registry=None) -> Optional[PodTelemetry]:
    """The engine's eval-boundary hook: None, doing nothing, unless a
    transport is registered; a failed round is logged, never raised into
    the training loop."""
    with _transport_lock:
        t = dict(_transport) if _transport else None
    if t is None:
        return None
    t0 = time.perf_counter()
    try:
        view = gather_pod_metrics(
            t["fn"], world=t["world"], rank=t["rank"],
            num_slices=t["num_slices"], registry=registry)
    except Exception as e:  # noqa: BLE001 - telemetry must not kill training
        from ..utils.log import log_warning
        log_warning(f"pod telemetry round failed ({e!r}); continuing")
        return None
    if registry is None:
        from .metrics import global_registry as registry
    registry.histogram("pod_telemetry_round_ms").observe(
        (time.perf_counter() - t0) * 1e3)
    return view
