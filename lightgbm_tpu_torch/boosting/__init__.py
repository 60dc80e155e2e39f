"""Boosting algorithms (counterpart of ``lightgbm_tpu/boosting``).

reference: src/boosting/boosting.cpp CreateBoosting (boosting.h:310):
gbdt, goss, dart and rf.
"""

from __future__ import annotations

from ..config import Config
from .dart import DART
from .gbdt import GBDT
from .goss import GOSS
from .rf import RF


def create_boosting(config: Config, train_set, objective):
    """The boosting object of ``config.boosting`` and its aliases."""
    t = config.boosting
    if t in ("gbdt", "gbrt"):
        return GBDT(config, train_set, objective)
    if t == "goss":
        return GOSS(config, train_set, objective)
    if t == "dart":
        return DART(config, train_set, objective)
    if t in ("rf", "random_forest"):
        return RF(config, train_set, objective)
    raise ValueError(f"unknown boosting type {t!r}")
