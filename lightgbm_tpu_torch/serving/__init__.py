"""In-process serving: micro-batched, shape-bucketed forest inference
with metrics (counterpart of ``lightgbm_tpu/serving``).

Quick start::

    server = booster.serve(max_batch_rows=512)
    fut = server.submit(X)                         # thread-safe, batched
    scores = fut.result()
    server.swap_model(new_booster)                 # hot-swap, no drops
    print(server.prometheus_text())
    server.close()                                 # graceful drain

Module map: ``server`` (facade: submit/apredict/deadlines/backpressure/
hot-swap/drain), ``batcher`` (micro-batch scheduler + bucket ladder),
``registry`` (program LRU + the active model + swap probe/quarantine),
``loadgen`` (concurrent load generator with bit-exact verification),
``errors`` (typed rejections); the metrics registry is ``obs.metrics``,
low-precision models come from ``fleet.lowprec``, and many models
behind one front door are ``fleet.Fleet`` and ``fleet.PodFleet``.
"""

from ..obs.metrics import MetricsRegistry
from .batcher import BucketLadder
from .errors import (DeadlineExceeded, DeviceLost, LowPrecisionQuarantined,
                     ModelNotFound, QueueFull, ServerClosed, ServingError,
                     SwapQuarantined)
from .registry import (CompiledModel, ModelRegistry, ProgramRegistry,
                       forest_digest)
from .server import Server, ServingConfig

__all__ = [
    "Server", "ServingConfig", "BucketLadder", "MetricsRegistry",
    "ProgramRegistry", "ModelRegistry", "CompiledModel", "forest_digest",
    "ServingError", "QueueFull", "DeadlineExceeded", "ServerClosed",
    "SwapQuarantined", "LowPrecisionQuarantined", "ModelNotFound",
    "DeviceLost",
]
