"""The environment flags the port reads (counterpart of
``lightgbm_tpu/utils/envflags.py``).

Every ``LGBM_TPU_*`` / ``LIGHTGBM_TPU_*`` name a module of
``lightgbm_tpu_torch`` reads is declared here, with the JAX package's
name and default, so a script or a deployment written for
``lightgbm_tpu`` steers the port the same way.  Only the flags the port
reads are registered: the JAX package's TPU-only, ``bench.py`` and
unported-module flags are not (``tests/test_torch_envflags.py`` names
each with its reason).  The reading call sites go through ``get`` (the
value, or the registered default) or ``read`` (the value, or None when
unset), and both raise ``KeyError`` for a name the registry lacks.

Two rules hold for every knob: an explicit argument wins over the
environment, and an unset flag leaves the behaviour the port has without
it.  Stdlib only.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Iterable, Optional


@dataclasses.dataclass(frozen=True)
class EnvFlag:
    """One environment knob: its default (textual, '' = unset), the
    port module that reads it, a one-line doc, and the file that must
    name it (``README.md``'s port section)."""

    name: str
    default: str
    consumer: str
    doc: str
    docfile: str


def _f(name: str, default: str, consumer: str, doc: str) -> EnvFlag:
    return EnvFlag(name, default, consumer, doc, "README.md")


FLAGS: Dict[str, EnvFlag] = {f.name: f for f in [
    # ------------------------------------------------------ data plane
    _f("LGBM_TPU_HBM_BYTES", "", "ops/planner.py",
       "override the card's memory limit (bytes) the streaming election "
       "plans against"),
    _f("LGBM_TPU_HOST_BYTES", "", "ops/planner.py",
       "override the host-RSS budget for the streaming planner"),
    _f("LGBM_TPU_STREAM", "", "ops/planner.py",
       "force ('1') / forbid ('0') out-of-core row-block streaming"),
    _f("LGBM_TPU_STREAM_BLOCK_ROWS", "", "ops/planner.py",
       "force the streaming row-block size"),
    _f("LGBM_TPU_STREAM_DIR", "", "data/stream.py",
       "directory for the spill blockstore (default: a tmpdir)"),
    _f("LGBM_TPU_CHUNK", "", "boosting/macro.py",
       "macro-chunk size override ('0'/'off' disables chunking)"),
    _f("LGBM_TPU_MODEL_BATCH", "", "ops/planner.py",
       "cap the model axis' lane chunk ('0'/'off' trains every lane "
       "solo)"),
    # ------------------------------------------------------ sharded training
    _f("LGBM_TPU_NUM_SLICES", "", "parallel/learners.py",
       "slice count of the simulated two-tier mesh on one host"),
    _f("LGBM_TPU_SLICE_DEVICES", "", "parallel/network.py",
       "ranks a slice in the mesh plan (an elastic shrink sets it)"),
    _f("LGBM_TPU_HIER_REDUCE", "", "ops/planner.py",
       "force ('1') / forbid ('0') hierarchical two-tier sums"),
    _f("LGBM_TPU_ICI_GBPS", "", "ops/planner.py",
       "the fast tier's link rate (GB/s) the collective plan models"),
    _f("LGBM_TPU_DCN_GBPS", "", "ops/planner.py",
       "the slow tier's link rate (GB/s) the collective plan models"),
    # ------------------------------------------------------ serving fleet
    _f("LGBM_TPU_COMPILE_CACHE", "", "fleet/aot.py",
       "<dir>/serving is the AOT store of serving bucket programs "
       "('0'/'off'/'none' disables)"),
    # ------------------------------------------------------ observability
    _f("LIGHTGBM_TPU_TIMETAG", "", "utils/timer.py",
       "'1' timer table at exit; 'json'/'json:<path>' machine form"),
    _f("LIGHTGBM_TPU_TRACE", "", "obs/trace.py",
       "'1' record spans; any other value also dumps Chrome JSON there"),
    _f("LIGHTGBM_TPU_TRACE_MAX_EVENTS", "1000000", "obs/trace.py",
       "cap on the in-process span list"),
    _f("LIGHTGBM_TPU_FLIGHT", "1", "obs/flight.py",
       "flight recorder armed (default on); '0' disarms"),
    _f("LIGHTGBM_TPU_FLIGHT_EVENTS", "2048", "obs/flight.py",
       "flight ring capacity"),
    _f("LIGHTGBM_TPU_FLIGHT_DIR", "", "obs/flight.py",
       "flight bundle directory (default cwd)"),
    _f("LIGHTGBM_TPU_FLIGHT_MAX_DUMPS", "8", "obs/flight.py",
       "per-process flight dump budget"),
    _f("LIGHTGBM_TPU_WATCHDOG", "", "obs/watchdog.py",
       "'1' starts the SLO sentry thread at engine/server init"),
    _f("LIGHTGBM_TPU_WATCHDOG_INTERVAL_S", "5", "obs/watchdog.py",
       "sentry check interval (seconds)"),
    _f("LIGHTGBM_TPU_SLO_TREES_PER_SEC", "", "obs/watchdog.py",
       "training throughput floor (trees/sec) the sentry enforces"),
    _f("LIGHTGBM_TPU_SLO_SERVING_P99_MS", "", "obs/watchdog.py",
       "serving p99 latency ceiling (ms)"),
    _f("LIGHTGBM_TPU_SLO_MODEL_AGE_S", "", "obs/watchdog.py",
       "deployed-model freshness ceiling (seconds since promotion)"),
    _f("LIGHTGBM_TPU_SLO_AVAILABILITY", "", "obs/watchdog.py",
       "per-model windowed availability floor (0..1) the sentry "
       "enforces"),
    _f("LIGHTGBM_TPU_SLO_HEARTBEAT_S", "300", "obs/watchdog.py",
       "heartbeat staleness threshold (seconds)"),
    _f("LIGHTGBM_TPU_METRICS_PORT", "", "obs/http.py",
       "opt-in HTTP metrics port ('0' = ephemeral)"),
    _f("LIGHTGBM_TPU_METRICS_HOST", "127.0.0.1", "obs/http.py",
       "bind host for the HTTP metrics endpoint"),
    # the model lifecycle
    _f("LGBM_TPU_LIFECYCLE_DIR", "", "lifecycle/rollout.py",
       "bundle and rollout-journal directory of the model lifecycle"),
    _f("LGBM_TPU_LIFECYCLE_DRIFT_BUDGET", "10.0", "lifecycle/rollout.py",
       "largest candidate-vs-live raw-score drift a rollout tolerates"),
    _f("LGBM_TPU_LIFECYCLE_P99_MS", "", "lifecycle/rollout.py",
       "candidate p99 latency ceiling (ms) of the rollout gates"),
    _f("LGBM_TPU_LIFECYCLE_MIRROR", "0.25", "lifecycle/rollout.py",
       "share of live requests mirrored to the candidate"),
    _f("LGBM_TPU_LIFECYCLE_RAMP", "0.05,0.25,0.5", "lifecycle/rollout.py",
       "comma list of the staged canary traffic shares"),
    # co-resident train and serve
    _f("LGBM_TPU_CORESIDENT_CHUNK_CAP", "", "coresident/scheduler.py",
       "chunk cap ceiling of co-resident refreshes (default: the "
       "LGBM_TPU_CHUNK cap)"),
    _f("LGBM_TPU_CORESIDENT_THROTTLE_S", "0.02", "coresident/scheduler.py",
       "host-side yield a consult while brownout-throttled (seconds)"),
    _f("LGBM_TPU_CORESIDENT_RECOVERY_S", "1.0", "coresident/scheduler.py",
       "quiet time after the last breach before throttled or paused "
       "training resumes at the whole cap (seconds)"),
]}


def lookup(name: str) -> Optional[EnvFlag]:
    """The registry entry for ``name``, or None for unknown flags."""
    return FLAGS.get(name)


def all_flags() -> Iterable[EnvFlag]:
    return FLAGS.values()


def get(name: str) -> str:
    """``name``'s value in the environment, else its registered default.
    Raises KeyError for an unregistered name."""
    return os.environ.get(name, FLAGS[name].default)


def read(name: str) -> Optional[str]:
    """``name``'s value in the environment, or None when it is unset (a
    reader for which "unset" differs from the default).  Raises KeyError
    for an unregistered name."""
    if name not in FLAGS:
        raise KeyError(name)
    return os.environ.get(name)
