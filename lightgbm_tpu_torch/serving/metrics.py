"""Back-compat shim (counterpart of ``lightgbm_tpu/serving/metrics.py``):
the serving metrics registry is the process-wide instrument registry of
``obs.metrics``; this module re-exports its serving surface so the JAX
package's import path (``from ....serving.metrics import
MetricsRegistry``) works on the port, with the same ``to_dict()`` key
layout (``counters``/``gauges``/``histograms``).
"""

from ..obs.metrics import (LATENCY_BUCKETS_MS, RATIO_BUCKETS, Counter, Gauge,
                           Histogram, MetricsRegistry)

__all__ = [
    "MetricsRegistry", "Counter", "Gauge", "Histogram",
    "LATENCY_BUCKETS_MS", "RATIO_BUCKETS",
]
