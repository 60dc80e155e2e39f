"""Registers, stack and spills of every kernel of one CUDA source, as
``nvcc -Xptxas -v`` reports them with the port's build flags
(``ops/_build.py``): a port source by name (``--source ingest``) or any
file (``--file path.cu``, e.g. a variant under ``build/``).  Needs
``nvcc``; prints one JSON line per kernel:

    python3 -m lightgbm_tpu_torch.tools.ptxas_report --source ingest
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
import tempfile
from pathlib import Path


def report(source: Path, match: str = "") -> list:
    from lightgbm_tpu_torch.ops import _build
    with tempfile.TemporaryDirectory() as tmp:
        out = subprocess.run(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I",
             str(_build.CSRC_DIR), "-o", str(Path(tmp) / "lib.so"),
             str(source)], capture_output=True, text=True)
    if out.returncode != 0:
        raise RuntimeError(out.stdout + out.stderr)
    rows, name = [], None
    for line in (out.stdout + out.stderr).splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
            rows.append({"kernel": name})
            continue
        if name is None or match not in name:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            rows[-1].update(stack=int(m.group(1)),
                            spill_stores=int(m.group(2)),
                            spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            rows[-1]["registers"] = int(m.group(1))
    return [r for r in rows if match in r["kernel"]]


def main() -> int:
    ap = argparse.ArgumentParser()
    src = ap.add_mutually_exclusive_group(required=True)
    src.add_argument("--source", help="a port source: ingest, fused, ...")
    src.add_argument("--file", type=Path)
    ap.add_argument("--match", default="", help="kernel name substring")
    args = ap.parse_args()
    from lightgbm_tpu_torch.ops import _build
    path = args.file or _build.CSRC_DIR / f"{args.source}.cu"
    for row in report(path, args.match):
        print(json.dumps(dict(row, source=str(path))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
