"""Observability (counterpart of ``lightgbm_tpu/obs/``): structured
tracing, the process metrics registry, the flight recorder and the SLO
watchdog, under the JAX package's names, event names, metric names and
file formats, so a script, dashboard or trace viewer built for
``lightgbm_tpu`` reads the port's output unchanged.

- ``obs.trace``: the span recorder (``span("engine.step")``), Chrome
  trace-event JSON, gated by ``LIGHTGBM_TPU_TRACE``;
- ``obs.metrics``: ``MetricsRegistry`` and the process registry
  ``global_registry``, with JSON snapshots and Prometheus text;
- ``obs.flight``: the always-on bounded ring and its atomic forensic
  bundles;
- ``obs.watchdog``: heartbeats and the SLO sentry;
- ``obs.http``: the opt-in HTTP exposition of the process registry;
- ``obs.devprof``: each kernel's work counts, its measured time and
  roofline shares on the card, the histogram, predict and ingest tables;
- ``obs.aggregate``: pod telemetry frames gathered at eval boundaries;
- ``obs.diagnose``: ranked bottleneck verdicts (``tools/obs_doctor.py``).

Every module but ``devprof`` is stdlib only and never reads a torch
tensor; ``devprof`` imports torch where it times.
"""

from .metrics import (LATENCY_BUCKETS_MS, RATIO_BUCKETS, Counter, Gauge,
                      Histogram, MetricsRegistry, get_registry,
                      global_registry)
from .trace import (Tracer, global_tracer, instant, span, span_coverage,
                    trace_enabled, trace_path)
# importing flight installs the tracer's ring tee (set_flight_sink)
from .flight import FlightRecorder, global_flight
from .watchdog import SLOConfig, Watchdog, global_watchdog

__all__ = [
    "span", "instant", "trace_enabled", "trace_path", "span_coverage",
    "Tracer", "global_tracer",
    "MetricsRegistry", "global_registry", "get_registry",
    "Counter", "Gauge", "Histogram",
    "LATENCY_BUCKETS_MS", "RATIO_BUCKETS",
    "FlightRecorder", "global_flight",
    "Watchdog", "SLOConfig", "global_watchdog",
]
