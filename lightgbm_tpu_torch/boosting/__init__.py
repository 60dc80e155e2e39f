"""Boosting loops of the port (the single-device GBDT)."""

from .gbdt import GBDT

__all__ = ["GBDT"]
