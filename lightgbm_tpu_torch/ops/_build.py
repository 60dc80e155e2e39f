"""Build the package's CUDA sources with ``nvcc`` into shared libraries
with a plain C interface, and load them through ``ctypes``.

Each ``ops/csrc/<name>.cu`` compiles on first use into
``build/lightgbm_tpu_torch/lib<name>-<digest>.so`` beside the package
(``build/`` is git-ignored), where ``<digest>`` hashes the source and the
flags, so an edited source is rebuilt and an unchanged one is reused.
Several sources build in parallel, one ``nvcc`` each.  Nothing here runs
at import time: a host without ``nvcc`` imports the package and only
fails when a CUDA tensor reaches a kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Sequence

CSRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "lightgbm_tpu_torch"

# sm_90a keeps wgmma/setmaxnreg available to later kernels; --fmad=false
# keeps f32 sums free of FMA contraction (bit parity with the plain
# versions); no --use_fast_math (isnan and denormals must stay IEEE)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "--fmad=false", "-shared", "-Xcompiler",
              "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
# name -> {"seconds": build time (0.0 when reused), "ptxas": compiler log}
build_info: Dict[str, dict] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None:
        from torch.utils.cpp_extension import CUDA_HOME
        if CUDA_HOME is not None:
            cand = os.path.join(CUDA_HOME, "bin", "nvcc")
            path = cand if os.path.exists(cand) else None
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels of "
                           "lightgbm_tpu_torch need the CUDA toolkit")
    return path


def library_path(name: str) -> Path:
    src = CSRC_DIR / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build(names: Sequence[str]) -> Dict[str, Path]:
    """Compile every source in ``names`` that has no current library,
    all ``nvcc`` processes started together; returns name -> library."""
    out = {name: library_path(name) for name in names}
    todo = [n for n, p in out.items() if not p.exists()]
    for n in names:
        if n not in todo:
            build_info.setdefault(n, {"seconds": 0.0, "ptxas": ""})
    if not todo:
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    t0 = time.perf_counter()
    for n in todo:
        tmp = out[n].with_name(f"{out[n].name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{n}.cu")]
        procs[n] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT,
                                          text=True))
    failed = []
    for n, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{n}.cu (exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out[n])       # atomic: a concurrent build races safely
        build_info[n] = {"seconds": time.perf_counter() - t0, "ptxas": log}
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build([name])[name]))
            _libs[name] = lib
        return lib
