"""Fault tolerance (counterpart of ``lightgbm_tpu/resilience``).

- ``checkpoint``: checksummed atomic checkpoint bundles, keep-last-K
  retention, corruption fallback, byte-identical resume state.
- ``faults``: deterministic seeded chaos injection over the allgather,
  file-system, serving and pod-device seams.
- ``retry``: ``resilient_allgather``: CRC framing, deadline and
  backoff, a verdict every rank shares, a consistent abort.
- ``elastic``: shrink-and-resume after a lost slice: a membership probe
  every rank agrees on, the shrunk world's plan, the resume in the
  survivors' group.
"""

from .checkpoint import (Checkpoint, CheckpointCorruptError, CheckpointError,
                         CheckpointManager, CheckpointNotFoundError,
                         load_checkpoint, resolve_resume_point,
                         restore_booster, save_checkpoint)
from .elastic import (SliceLostError, apply_world, membership_probe,
                      plan_shrunk_world, shrink_and_resume)
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
    "SliceLostError", "apply_world", "membership_probe",
    "plan_shrunk_world", "shrink_and_resume",
]
