"""Observability: the metrics registry the serving path reports through."""

from .metrics import (LATENCY_BUCKETS_MS, RATIO_BUCKETS, Counter, Gauge,
                      Histogram, MetricsRegistry)

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "LATENCY_BUCKETS_MS", "RATIO_BUCKETS"]
