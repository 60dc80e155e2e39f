"""In-process serving: micro-batched, shape-bucketed forest inference
with metrics (counterpart of ``lightgbm_tpu/serving``).

Quick start::

    server = booster.serve(max_batch_rows=512)
    fut = server.submit(X)                         # thread-safe, batched
    scores = fut.result()
    print(server.metrics_json())
    server.close()                                 # graceful drain

Module map: ``server`` (facade: submit/deadlines/backpressure/drain),
``batcher`` (micro-batch scheduler + bucket ladder), ``registry``
(program cache + the active model), ``errors`` (typed rejections); the
metrics registry is ``obs.metrics``.
"""

from ..obs.metrics import MetricsRegistry
from .batcher import BucketLadder
from .errors import DeadlineExceeded, QueueFull, ServerClosed, ServingError
from .registry import CompiledModel, ModelRegistry, ProgramRegistry
from .server import Server, ServingConfig

__all__ = [
    "Server", "ServingConfig", "BucketLadder", "MetricsRegistry",
    "ProgramRegistry", "ModelRegistry", "CompiledModel",
    "ServingError", "QueueFull", "DeadlineExceeded", "ServerClosed",
]
