"""Build and load the native host library (the port's copy of
``lightgbm_tpu/native/build.py``).

``findbin.cpp`` and ``predictor.cpp`` compile on first use with
``g++ -O3 -march=native -fopenmp -shared -fPIC`` into
``build/lightgbm_tpu_torch/liblgbt-<digest>.so`` beside the package
(``build/`` is git-ignored), never into the package directory.  The
digest hashes the sources, the flags and the host's CPU (model name and
ISA flags): a library built with ``-march=native`` on one CPU could
raise SIGILL on another, so another CPU builds its own.  Loading is
``ctypes`` against a plain C interface.

Where ``g++`` or OpenMP is missing the loader gives None and the callers
take their NumPy route, which gives the same bits.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import threading
from pathlib import Path
from typing import Optional

from ..utils.log import log_warning

SRC_DIR = Path(__file__).resolve().parent
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "lightgbm_tpu_torch"
SOURCES = ("predictor.cpp", "findbin.cpp")
CXX_FLAGS = ("-O3", "-march=native", "-fopenmp", "-shared", "-fPIC",
             "-std=c++17")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def host_tag() -> str:
    """The machine, system, CPU model and ISA flags of this host."""
    bits = [platform.machine(), platform.system()]
    model = flags = None
    try:
        with open("/proc/cpuinfo") as fh:
            for line in fh:
                if model is None and line.startswith("model name"):
                    model = line.strip()
                elif flags is None and line.startswith("flags"):
                    flags = line.strip()
                if model is not None and flags is not None:
                    break
    except OSError:
        pass
    bits.extend(b for b in (model, flags) if b)
    return "|".join(bits)


def library_path() -> Path:
    h = hashlib.sha256()
    for name in SOURCES:
        h.update((SRC_DIR / name).read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    h.update(host_tag().encode())
    return BUILD_DIR / f"liblgbt-{h.hexdigest()[:12]}.so"


def build() -> Path:
    """Compile the library unless a current one exists; returns its
    path.  Raises where ``g++`` fails."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = ["g++", *CXX_FLAGS, "-o", str(tmp),
           *(str(SRC_DIR / s) for s in SOURCES)]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, out)      # atomic: concurrent builds race safely
    finally:
        if tmp.exists():
            tmp.unlink()
    return out


def _declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    """The C signatures of the library's two entry points."""
    p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib.lgbt_predict.argtypes = [
        p, i64, i64,                  # X [n, F] f64, n, F
        i64, i64, i64,                # T, I, L
        p, p, p, p,                   # split_feature, threshold, left, right
        p, p, p, p,                   # is_cat, default_left, missing_type,
                                      # leaf_value
        p, p, p,                      # cat_offset, cat_nwords, cat_words
        i64, i32, i32, ctypes.c_double,   # K, early stop kind, freq, margin
        p, p]                         # out [K, n] or NULL, leaf [n, T] or NULL
    lib.lgbt_predict.restype = None
    lib.lgbt_greedy_find_bin.argtypes = [p, p, i64, i32, i64, i32, p]
    lib.lgbt_greedy_find_bin.restype = i32
    return lib


def load_native_lib() -> Optional[ctypes.CDLL]:
    """The loaded library, or None where it cannot be built (tried once
    a process)."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        try:
            _lib = _declare(ctypes.CDLL(str(build())))
        except Exception as e:  # noqa: BLE001 - any failure: NumPy route
            log_warning(f"native host library unavailable ({e!r}); "
                        "prediction and bin fitting take the NumPy route")
            _lib = None
        return _lib
