"""Scheme-routed file IO with a registration seam (counterpart of
``lightgbm_tpu/utils/file_io.py``).

reference: VirtualFileReader/VirtualFileWriter (src/io/file_io.cpp).
``register_file_system`` installs an opener for a URL scheme;
unregistered ``scheme://`` paths fall back to fsspec where it is
installed; plain paths use the builtin ``open``.  Local writes land
atomically: a temp sibling, fsync, ``os.replace``.
"""

from __future__ import annotations

import contextlib
import os
import uuid
from typing import Callable, Dict, Optional

_OPENERS: Dict[str, Callable] = {}
_REMOVERS: Dict[str, Callable] = {}


def register_file_system(scheme: str, opener: Callable,
                         remover: Optional[Callable] = None) -> None:
    """Install ``opener(path, mode) -> file-like`` (and optionally
    ``remover(path)``) for ``scheme://`` paths."""
    _OPENERS[scheme] = opener
    if remover is not None:
        _REMOVERS[scheme] = remover
    else:
        _REMOVERS.pop(scheme, None)


def unregister_file_system(scheme: str) -> None:
    _OPENERS.pop(scheme, None)
    _REMOVERS.pop(scheme, None)


def _scheme(path: str) -> Optional[str]:
    return path.split("://", 1)[0] if "://" in path else None


def open_file(path, mode: str = "r"):
    """Open ``path`` through the backend registered for its scheme."""
    path = str(path)
    scheme = _scheme(path)
    if scheme is None:
        return open(path, mode)
    if scheme in _OPENERS:
        return _OPENERS[scheme](path, mode)
    try:
        import fsspec
        return fsspec.open(path, mode).open()
    except (ImportError, ValueError) as e:
        raise OSError(
            f"no file system registered for {scheme}:// and fsspec cannot "
            f"handle it ({e}); register_file_system({scheme!r}, opener) to "
            "add one") from e


@contextlib.contextmanager
def open_atomic(path, mode: str = "w"):
    """A writable handle backed by a temp sibling; a clean exit fsyncs
    and lands it with ``os.replace``, an exception removes the temp.
    ``w``/``wb`` only.  ``scheme://`` paths write through ``open_file``;
    a non-regular destination (a FIFO, ``/dev/stdout``) is written
    through; a symlink is written through to its target."""
    path = str(path)
    if "w" not in mode:
        raise ValueError(
            f"open_atomic supports only 'w'/'wb' modes, got {mode!r}")
    if _scheme(path) is not None:
        with open_file(path, mode) as fh:
            yield fh
        return
    path = os.path.realpath(path)
    if os.path.exists(path) and not os.path.isfile(path):
        with open(path, mode) as fh:
            yield fh
        return
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    tmp = os.path.join(d, ".{}.tmp.{}.{}".format(
        os.path.basename(path), os.getpid(), uuid.uuid4().hex[:8]))
    fd = os.open(tmp, os.O_CREAT | os.O_EXCL | os.O_WRONLY, 0o666)
    try:
        with os.fdopen(fd, mode) as fh:
            yield fh
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, path)
    except BaseException:
        with contextlib.suppress(OSError):
            os.remove(tmp)
        raise


def write_atomic(path, data) -> None:
    """Crash-safe write of ``data`` (str or bytes) to ``path``."""
    mode = "wb" if isinstance(data, (bytes, bytearray)) else "w"
    with open_atomic(path, mode) as fh:
        fh.write(data)


def remove(path) -> bool:
    """Best-effort delete; True when the file is known gone.  Never
    raises."""
    path = str(path)
    scheme = _scheme(path)
    if scheme is None:
        try:
            os.remove(path)
            return True
        except FileNotFoundError:
            return True
        except OSError:
            return False
    if scheme in _REMOVERS:
        try:
            _REMOVERS[scheme](path)
            return True
        except Exception:
            return False
    if scheme in _OPENERS:
        return False
    try:
        import fsspec
        fs, p = fsspec.core.url_to_fs(path)
        fs.rm(p)
        return True
    except Exception:
        return False


def exists(path) -> bool:
    path = str(path)
    if _scheme(path) is None:
        return os.path.exists(path)
    try:
        with open_file(path, "r"):
            return True
    except Exception:
        return False
