"""Guarded model lifecycle: continual training, canary promotion,
automated rollback (counterpart of ``lightgbm_tpu/lifecycle/``).

It composes the port's planes into one guarded cycle:

* **refresh** (refresh.py): warm-start boosting from the DEPLOYED
  model over fresh rows binned on its frozen bin grid (engine
  ``init_model`` and the streaming constructor), banked as an atomic
  sha256-manifested checkpoint bundle (``resilience.checkpoint``);
* **promote** (rollout.py): probe-batch quarantine -> shadow traffic
  (mirrored raw-score drift and client-measured p99 against declared
  budgets) -> staged canary weight ramp through the serving ``Fleet``
  -> atomic probed cutover;
* **rollback**: any gate breach (drift, latency, error rate,
  non-finite outputs, corrupt bundle, failed cutover probe) restores
  the previous verified bundle and dumps a flight-recorder bundle
  naming the gate; the rollout journal (journal.py) makes a crashed
  pipeline resume or roll back, never double-promote;
* **freshness**: ``model_age_seconds`` is a watchdog SLO: a live
  model past its age ceiling breaches ``freshness:<name>``.
"""

from .journal import RolloutJournal, RolloutJournalError
from .refresh import (booster_digest, fresh_dataset, save_candidate,
                      train_candidate)
from .rollout import (CANARY_SUFFIX, LifecycleConfig, LifecycleController,
                      LifecycleError, RollbackFailed, replay_traffic)

__all__ = [
    "LifecycleController", "LifecycleConfig", "LifecycleError",
    "RollbackFailed", "RolloutJournal", "RolloutJournalError",
    "CANARY_SUFFIX", "replay_traffic", "booster_digest",
    "fresh_dataset", "train_candidate", "save_candidate",
]
