"""Logging, mirroring reference utils/log.h:26-118 semantics.

Levels: Fatal < Warning < Info < Debug.  ``Fatal`` raises (the reference
throws std::runtime_error caught at API boundaries).

``LightGBMError`` lives here because this is the port's dependency root:
the JAX package defines it in ``config.py``, which the port has not
ported yet.
"""

from __future__ import annotations

import sys

_LEVELS = {"fatal": -1, "warning": 0, "info": 1, "debug": 2}
_current_level = 1


class LightGBMError(Exception):
    """Error thrown by this package (reference: basic.py:158)."""


def reset_log_level(level: str) -> None:
    global _current_level
    _current_level = _LEVELS[level.lower()]


def set_verbosity(verbosity: int) -> None:
    global _current_level
    _current_level = max(-1, min(int(verbosity), 2))


def log_debug(msg: str) -> None:
    if _current_level >= 2:
        print(f"[LightGBM-TPU-Torch] [Debug] {msg}", file=sys.stderr)


def log_info(msg: str) -> None:
    if _current_level >= 1:
        print(f"[LightGBM-TPU-Torch] [Info] {msg}")


def log_warning(msg: str) -> None:
    if _current_level >= 0:
        print(f"[LightGBM-TPU-Torch] [Warning] {msg}", file=sys.stderr)


def log_fatal(msg: str) -> None:
    raise RuntimeError(f"[LightGBM-TPU-Torch] [Fatal] {msg}")
