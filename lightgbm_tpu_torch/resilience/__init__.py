"""Fault tolerance (counterpart of ``lightgbm_tpu/resilience``).

- ``faults``: deterministic seeded chaos injection over the allgather,
  file-system, serving and pod-device seams.

The JAX package's checkpoint bundles, ``resilient_allgather`` and
elastic shrink-rejoin are ROADMAP queue A8.
"""

from .faults import (ChaosRegistry, FaultInjected, FaultSpec,
                     parse_schedule)

__all__ = ["ChaosRegistry", "FaultInjected", "FaultSpec", "parse_schedule"]
