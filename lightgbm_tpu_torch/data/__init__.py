"""The out-of-core data plane (counterpart of ``lightgbm_tpu/data``).

Trains datasets whose binned matrix does not stay on the card, and
scores stores of rows of any size: the two-level budget planner
(``ops.planner.plan_stream``) elects row-block streaming, the matrix
spills to a checksummed block store (``blockstore.BlockStore``), and a
double-buffered pump feeds row blocks to the card (``ReadAhead`` runs
one in a reader thread), where the streamed
rounds grower folds each round's histograms over them before one split
scan (``stream``); ``score`` drives the same pump through the traversal
kernel for bulk offline scoring.
"""

from ..ops.planner import (StreamPlan, host_limit_bytes,  # noqa: F401
                           plan_stream, predict_host_peak_bytes,
                           predict_stream_device_peak_bytes,
                           stream_override)
from .blockstore import (BlockStore, BlockStoreCorruptError,  # noqa: F401
                         FORMAT as BLOCKSTORE_FORMAT)
from .score import (BulkScorer, DeviceSpec, ScoreSink,  # noqa: F401
                    ScoreSinkError, plan_block_shards)
from .stream import (BlockPump, IngestPump, ReadAhead,  # noqa: F401
                     StreamGrower,
                     default_spill_dir, host_rss_bytes,
                     host_rss_peak_bytes, maybe_stream_setup)

__all__ = [
    "BlockPump", "BlockStore", "BlockStoreCorruptError", "BulkScorer",
    "DeviceSpec", "IngestPump", "ReadAhead", "ScoreSink", "ScoreSinkError",
    "StreamGrower", "StreamPlan", "default_spill_dir", "host_limit_bytes",
    "host_rss_bytes", "host_rss_peak_bytes", "maybe_stream_setup",
    "plan_block_shards", "plan_stream", "predict_host_peak_bytes",
    "predict_stream_device_peak_bytes", "stream_override",
]
