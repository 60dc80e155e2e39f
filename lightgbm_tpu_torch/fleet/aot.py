"""Stored serving programs: a fresh replica restores its bucket programs
instead of building them (counterpart of ``lightgbm_tpu/fleet/aot.py``).

The JAX package serializes each (model digest, bucket) routing program
with ``jax.export``.  A PyTorch program has no such blob: what a live
build computes for a device bucket program on a miss is the kernel's
operands and its launch shape.  So an entry stores

- the packed B1 records (``predict_kernels.pack_nodes``'s ``nodes``
  [T, I, 4] and ``cats``) and the bitset words ``cat_words``, and the
  f32 leaf values where the forest holds them, once per model digest (``<digest>.npz``, read with
  ``allow_pickle=False``);
- per bucket, the device epilogue's verdict
  (``DeviceForest._epilogue_verified``) and the bucket's
  ``planner.traverse_plan`` in both modes (``<digest>-b<bucket>.bin``,
  JSON);
- per bucket, the metadata checked before anything else is read
  (``<digest>-b<bucket>.json``): the store's version, the platform
  (``cuda`` or ``cpu``) and the card's compute capability, the torch
  version, a hash of ``csrc/traverse.cu`` and of the record layout
  (``FEATURE_BITS`` and the shifts), and the sha256 of the two files.

A model restores once, when its device forest is built
(``CompiledModel.restore_device``, ``AOTStore.restore_device_forest``):
the ``DeviceForest`` takes its records, words and leaves from the store
and its epilogue verdict from the entry, so nothing is packed and
nothing probed, and it holds the same tensors a live build holds (one
forest a model on the card, as ``ops.planner.predict_forest_bytes``
counts; a model whose Booster already holds its forest on the card
shares that one instead).  A bucket restores its plans and verdict: its
program is the live program (``CompiledModel.program``) launched at the
stored plans, so a restored program is bit-identical to a built one.
The bulk scorer, which is handed its forest, restores the same way.  Any mismatch, truncation or
corruption is a miss that logs a warning, and the program is built as
usual: a cache miss, never a serving failure and never a kernel
fallback (B1 runs on the card either way).  Files are written with
``utils.file_io.write_atomic``.
"""

from __future__ import annotations

import functools
import hashlib
import io
import json
import os
import zipfile
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..ops import planner
from ..ops import predict_kernels as _pk
from ..utils import envflags
from ..utils.file_io import write_atomic
from ..utils.log import log_warning

AOT_VERSION = 1
_SUBDIR = "serving"


def aot_dir_from_env() -> Optional[str]:
    """``LGBM_TPU_COMPILE_CACHE=<dir>`` -> ``<dir>/serving``, or None
    where it is unset or one of "0", "off", "none"."""
    d = (envflags.read("LGBM_TPU_COMPILE_CACHE") or "").strip()
    if not d or d.lower() in ("0", "off", "none"):
        return None
    return os.path.join(d, _SUBDIR)


@functools.lru_cache(maxsize=1)
def kernel_hash() -> str:
    """sha256 of B1's source and of the packed record layout: a store
    written for another kernel or layout never restores."""
    h = hashlib.sha256()
    src = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "ops", "csrc", "traverse.cu")
    with open(src, "rb") as fh:
        h.update(fh.read())
    h.update(json.dumps([_pk.FEATURE_BITS, _pk._MT_SHIFT, _pk._DL_SHIFT,
                         _pk._CAT_SHIFT, planner.NODE_RECORD_BYTES,
                         planner.CAT_RECORD_BYTES]).encode())
    return h.hexdigest()[:16]


def device_target(device) -> dict:
    """The platform and compute capability a stored program is for."""
    dev = torch.device(device)
    cap = None
    if dev.type == "cuda":
        major, minor = torch.cuda.get_device_capability(dev)
        cap = f"{major}.{minor}"
    return {"platform": dev.type, "capability": cap}


def _sha256(raw: bytes) -> str:
    return hashlib.sha256(raw).hexdigest()


def _npz_bytes(arrays: dict) -> bytes:
    """``arrays`` as the bytes of a ``.npz`` archive, the same bytes for
    the same arrays (``np.savez`` stamps the time of writing), so that a
    model's records written again keep the checksum its earlier bucket
    entries hold."""
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w") as zf:
        for name, a in arrays.items():
            member = io.BytesIO()
            np.lib.format.write_array(member, np.ascontiguousarray(a),
                                      allow_pickle=False)
            zf.writestr(zipfile.ZipInfo(name + ".npy",
                                        date_time=(1980, 1, 1, 0, 0, 0)),
                        member.getvalue())
    return buf.getvalue()


class StoredProgram(NamedTuple):
    """One (digest, bucket) entry as read back: B1's launch plans by
    mode ({"leaves", "scores"} -> ``planner.TraversePlan``), the device
    epilogue's verdict, the program description and the sha256 of the
    model's records file it belongs to."""

    plans: dict
    epilogue: bool
    spec: dict
    records_sha: str


class AOTStore:
    """Directory of stored serving programs keyed ``(model digest,
    bucket_rows)`` (module docstring for the files of an entry)."""

    def __init__(self, root: str):
        self.root = str(root)

    # ------------------------------------------------------------- layout

    def _base(self, digest: str, bucket_rows: int) -> str:
        return os.path.join(self.root, f"{digest}-b{int(bucket_rows)}")

    def _records(self, digest: str) -> str:
        return os.path.join(self.root, f"{digest}.npz")

    def entries(self) -> list:
        """Sorted [(digest, bucket_rows)] of complete entries on disk."""
        try:
            names = os.listdir(self.root)
        except OSError:
            return []
        out = []
        for n in names:
            if not n.endswith(".json"):
                continue
            stem = n[:-len(".json")]
            digest, sep, b = stem.rpartition("-b")
            if not sep or not b.isdigit():
                continue
            if os.path.exists(os.path.join(self.root, stem + ".bin")) and \
                    os.path.exists(self._records(digest)):
                out.append((digest, int(b)))
        return sorted(out)

    def buckets_for(self, digest: str) -> list:
        return sorted(b for d, b in self.entries() if d == digest)

    # -------------------------------------------------------------- export

    def export_device_forest(self, device_forest, features: int, buckets,
                             digest: str, num_class: int = 1) -> int:
        """Store ``device_forest``'s bucket programs for every bucket in
        ``buckets``: the records once, a program and its metadata a
        bucket.  Returns the number of entries written."""
        dev = device_forest
        f = dev.forest
        K = max(int(num_class), 1)
        epilogue = bool(dev._epilogue_verified(K))
        arrays = {"nodes": dev.nodes.cpu().numpy(),
                  "cats": dev.cat_records.cpu().numpy(),
                  "cat_words": dev.cat_words.cpu().numpy()}
        if dev.leaf_value is not None:
            arrays["leaf_value"] = dev.leaf_value.cpu().numpy()
        records = _npz_bytes(arrays)
        os.makedirs(self.root, exist_ok=True)
        write_atomic(self._records(digest), records)
        T, I = dev.split_feature.shape
        F = int(features)
        n = 0
        for b in sorted({int(b) for b in buckets}):
            plans = {mode: planner.traverse_plan(
                F, I, T, b, bool(f.has_cat), K if mode == "scores" else 1,
                mode == "scores")._asdict() for mode in ("leaves", "scores")}
            program = json.dumps({
                "trees": int(T), "nodes": int(I), "features": F,
                "split_features": int(dev.num_features),
                "has_cat": bool(f.has_cat),
                "max_depth": int(max(f.max_depth, 1)), "num_class": K,
                "epilogue": epilogue, "plans": plans},
                sort_keys=True).encode()
            base = self._base(digest, b)
            write_atomic(base + ".bin", program)
            write_atomic(base + ".json", json.dumps({
                "version": AOT_VERSION, "digest": digest,
                "bucket_rows": b, **device_target(dev.device),
                "torch": torch.__version__, "kernel": kernel_hash(),
                "program_sha256": _sha256(program),
                "records_sha256": _sha256(records)},
                indent=1, sort_keys=True))
            n += 1
        return n

    # ------------------------------------------------------------- restore

    def _check_meta(self, meta: dict, device) -> Optional[str]:
        """Why ``meta`` cannot restore on ``device``, or None."""
        want = {"version": AOT_VERSION, **device_target(device),
                "torch": torch.__version__, "kernel": kernel_hash()}
        for k, v in want.items():
            if meta.get(k) != v:
                return f"{k} {meta.get(k)!r} is not {v!r}"
        return None

    def load_program(self, digest: str, bucket_rows: int,
                     device) -> Optional[StoredProgram]:
        """The stored (digest, bucket) program for ``device``, or None on
        any miss.  A missing entry is a silent miss; a mismatched,
        truncated or corrupt one logs a warning."""
        base = self._base(digest, bucket_rows)
        try:
            with open(base + ".json") as fh:
                meta = json.load(fh)
            why = self._check_meta(meta, device)
            if why is not None:
                log_warning(f"AOT serving entry {os.path.basename(base)} "
                            f"not restored: {why}; building this bucket")
                return None
            with open(base + ".bin", "rb") as fh:
                raw = fh.read()
            if _sha256(raw) != meta.get("program_sha256"):
                raise ValueError("program checksum mismatch")
            spec = json.loads(raw.decode())
            if int(spec["num_class"]) < 1 or set(spec["plans"]) != {
                    "leaves", "scores"}:
                raise ValueError("malformed program")
            plans = {mode: planner.TraversePlan(**p)
                     for mode, p in spec["plans"].items()}
            return StoredProgram(plans, bool(spec["epilogue"]), spec,
                                 str(meta["records_sha256"]))
        except FileNotFoundError:
            return None
        except Exception as e:  # noqa: BLE001 — any corruption is a miss
            self._unusable(base, e)
            return None

    def load_records(self, digest: str, records_sha: str) -> Optional[dict]:
        """The model's stored arrays (``nodes``, ``cats``, ``cat_words``
        and ``leaf_value`` where the forest held them) as NumPy arrays,
        or None on any miss."""
        path = self._records(digest)
        try:
            with open(path, "rb") as fh:
                raw = fh.read()
            if _sha256(raw) != records_sha:
                raise ValueError("records checksum mismatch")
            with np.load(io.BytesIO(raw), allow_pickle=False) as z:
                return {k: z[k] for k in z.files}
        except FileNotFoundError:
            return None
        except Exception as e:  # noqa: BLE001 — any corruption is a miss
            self._unusable(path, e)
            return None

    @staticmethod
    def _unusable(path: str, e: Exception) -> None:
        log_warning(f"AOT serving entry {os.path.basename(path)} unusable "
                    f"({type(e).__name__}: {str(e)[:120]}); building this "
                    "bucket")

    def restore_device_forest(self, forest, digest: str, device,
                              num_class: int = 1, precision: str = "f32",
                              routing_only: bool = False):
        """``forest``'s ``DeviceForest`` on ``device`` from its stored
        records and epilogue verdict (the first of its bucket entries
        that restores), or None on a miss: nothing packed, nothing
        probed.  The forest holds the same tensors as one built live."""
        from ..predict import DeviceForest
        K = max(int(num_class), 1)
        got = None
        for b in self.buckets_for(digest):
            got = self.load_program(digest, b, device)
            if got is not None:
                break
        if got is None:
            return None
        arrays = self.load_records(digest, got.records_sha)
        if arrays is None:
            return None
        T, I = forest.split_feature.shape
        spec = got.spec
        want = {"nodes": (T, I, 4), "cat_words": (len(forest.cat_words),)}
        if not routing_only:
            want["leaf_value"] = forest.leaf_value.shape
        bad = [k for k, shape in want.items()
               if k not in arrays or arrays[k].shape != tuple(shape)]
        if bad or "cats" not in arrays or int(spec["num_class"]) != K or \
                (int(spec["trees"]), int(spec["nodes"])) != (T, I):
            self._unusable(self._records(digest), ValueError(
                f"records do not match the forest ({bad or 'program'})"))
            return None
        dev = DeviceForest(forest, device, precision=precision,
                           routing_only=routing_only,
                           stored={**arrays, "epilogue": {K: got.epilogue}})
        dev.aot_records_sha = got.records_sha
        return dev


def make_aot_program(store: AOTStore, model, bucket_rows: int):
    """``model``'s serving program for ``bucket_rows`` restored from
    ``store``, or None on a miss (or while the model is evicted): the
    live program (``CompiledModel.program``) on the model's one device
    forest, launched at the stored plans, with the stored epilogue
    verdict standing in for the probe.  It is tagged ``aot``, so the
    program registry counts a restore, not a build."""
    dev = model.device_forest
    if dev is None:
        return None
    got = store.load_program(model.digest, bucket_rows, dev.device)
    if got is None or int(got.spec["num_class"]) != model.num_class:
        return None
    dev._epilogue_ok.setdefault(model.num_class, got.epilogue)
    return model.program(plans=got.plans)


def make_bulk_program(device_forest, features: int, block_rows: int,
                      digest: str, store: Optional[AOTStore] = None,
                      num_class: int = 1):
    """The bulk scorer's routing program (``data/score.py``) at its one
    block-sized bucket: ``[block_rows, F] f32 -> [T, block_rows] int32``
    leaf ids through B1 on ``device_forest``.  With ``store`` it
    restores the bucket's launch plan and epilogue verdict (source
    "aot"); on a miss it stores the bucket, so that the next run (a
    resumed one too) restores it, and runs live (source "live").
    Storing is best-effort.  Returns ``(callable, source)``."""
    plan, source = None, "live"
    if store is not None:
        got = store.load_program(digest, block_rows, device_forest.device)
        if got is not None and int(got.spec["num_class"]) == num_class:
            plan, source = got.plans["leaves"], "aot"
            device_forest._epilogue_ok.setdefault(num_class, got.epilogue)
        else:
            try:
                store.export_device_forest(device_forest, features,
                                           [block_rows], digest,
                                           num_class=num_class)
            except Exception as e:  # noqa: BLE001 — best-effort
                log_warning(f"bulk AOT export failed ({type(e).__name__}:"
                            f" {str(e)[:120]}); nothing stored")

    def leaves(X: torch.Tensor) -> torch.Tensor:
        return _pk.fused_traverse(device_forest, X, plan=plan)

    return leaves, source
