"""Fault tolerance (counterpart of ``lightgbm_tpu/resilience``).

- ``checkpoint``: checksummed atomic checkpoint bundles, keep-last-K
  retention, corruption fallback, byte-identical resume state.
- ``faults``: deterministic seeded chaos injection over the allgather,
  file-system, serving and pod-device seams.
- ``retry``: ``resilient_allgather``: CRC framing, deadline and
  backoff, a verdict every rank shares, a consistent abort.

The JAX package's elastic shrink-rejoin (``resilience/elastic.py``) is
ROADMAP queue A9 (rest).
"""

from .checkpoint import (Checkpoint, CheckpointCorruptError, CheckpointError,
                         CheckpointManager, CheckpointNotFoundError,
                         load_checkpoint, resolve_resume_point,
                         restore_booster, save_checkpoint)
from .faults import (ChaosRegistry, FaultInjected, FaultSpec,
                     parse_schedule)
from .retry import (CollectiveError, ResilienceConfig, make_resilient,
                    resilient_allgather)

__all__ = [
    "Checkpoint", "CheckpointCorruptError", "CheckpointError",
    "CheckpointManager", "CheckpointNotFoundError", "load_checkpoint",
    "resolve_resume_point", "restore_booster", "save_checkpoint",
    "ChaosRegistry", "FaultInjected", "FaultSpec", "parse_schedule",
    "CollectiveError", "ResilienceConfig", "make_resilient",
    "resilient_allgather",
]
