"""Checksummed atomic checkpoint bundles with byte-identical resume
(counterpart of ``lightgbm_tpu/resilience/checkpoint.py``).

A checkpoint is ONE file (a zip container) holding three members:

- ``manifest.json``: the format tag, the iteration, provenance (the
  chunk cap, the histogram plan, the streamed run's plan and spill store
  geometry, the collective layout) and a sha256 and size per member,
  verified on every load, so a truncated or bit-flipped bundle is caught
  before any state is trusted;
- ``model.txt``: the reference-format model text at the checkpoint
  iteration, loadable on its own;
- ``state.pkl``: the training state of ``GBDT.capture_state`` (host
  trees, scores, every RNG stream, DART's drop state, the device trees
  as NumPy arrays) with the Booster's best iteration and score and the
  engine's callback states, so a resumed run replays the same random
  draws and ends with the same model text.

The format tag is the port's own, ``lgbt-ckpt-torch/1``.  A JAX bundle
(``lgbt-ckpt/1``) pickles classes of the JAX package, which the port
never imports: it is refused with a ``CheckpointError`` that points to
its ``model.txt`` member (``train(..., init_model=)`` continues from
it).  The port's ``state.pkl`` is read by an unpickler that admits only
builtins, NumPy and ``lightgbm_tpu_torch`` classes.

Bundles are written through ``utils.file_io.write_atomic`` (a temp
sibling and ``os.replace`` locally; the ``register_file_system`` seam
for other schemes), so no file is ever left half-written.
``CheckpointManager`` keeps the last K bundles, listed in an
atomically written ``index.json`` (so finding a bundle never needs a
directory listing on a remote scheme), and ``latest_verified()`` walks
them newest to oldest, skipping corrupt ones with a warning.

The ``checkpoint.save`` and ``checkpoint.load`` spans and the
``checkpoint_save_ms``/``checkpoint_load_ms`` histograms of the process
registry are the JAX package's.
"""

from __future__ import annotations

import builtins
import collections
import hashlib
import io
import json
import pickle
import time
import zipfile
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

from ..obs.metrics import global_registry as _obs_registry
from ..obs.trace import span as _span
from ..utils.file_io import exists, open_file, remove, write_atomic
from ..utils.log import log_info, log_warning

FORMAT = "lgbt-ckpt-torch/1"
JAX_FORMAT = "lgbt-ckpt/1"
BUNDLE_SUFFIX = ".lgbckpt"
INDEX_NAME = "index.json"


class CheckpointError(RuntimeError):
    """Base class for checkpoint load failures."""


class CheckpointCorruptError(CheckpointError):
    """The bundle exists but fails structural or checksum verification."""


class CheckpointNotFoundError(CheckpointError):
    """No (verifiable) bundle at the requested location."""


@dataclass
class Checkpoint:
    """A verified, decoded bundle."""

    iteration: int
    model_str: str
    boosting_state: dict
    booster_state: dict = field(default_factory=dict)
    engine_state: dict = field(default_factory=dict)
    manifest: dict = field(default_factory=dict)
    path: Optional[str] = None


def _sha256(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


_SAFE_BUILTINS = frozenset((
    "dict", "list", "tuple", "set", "frozenset", "int", "float", "complex",
    "bool", "str", "bytes", "bytearray", "slice", "range"))
_NUMPY_FUNCS = frozenset(("_reconstruct", "scalar", "_frombuffer"))


class _StateUnpickler(pickle.Unpickler):
    """Admits builtins' containers and scalars, NumPy arrays, dtypes and
    scalars, ``collections.OrderedDict`` and ``lightgbm_tpu_torch``
    classes; any other global (the JAX package's classes among them) is
    refused before its module is imported."""

    def find_class(self, module, name):
        if module == "builtins" and name in _SAFE_BUILTINS:
            return getattr(builtins, name)
        if module == "collections" and name == "OrderedDict":
            return collections.OrderedDict
        root = module.split(".", 1)[0]
        if root == "numpy":
            obj = super().find_class(module, name)
            if isinstance(obj, type) or name in _NUMPY_FUNCS:
                return obj
        elif root == "lightgbm_tpu_torch":
            obj = super().find_class(module, name)
            if isinstance(obj, type):
                return obj
        raise pickle.UnpicklingError(
            f"state.pkl names {module}.{name}, which a port bundle never "
            "holds")


def _provenance(booster) -> dict:
    """The manifest's provenance, never validated on restore: resumed
    runs replay byte-identically under any chunk plan (the chunk body
    does not depend on the chunk size, ``boosting/macro.py``), and
    streamed training equals resident training for any block partition,
    so a bundle of either restores into the other."""
    from ..boosting.macro import chunk_cap
    b = booster.boosting
    splan = getattr(b, "stream_plan", None)
    sctx = getattr(b, "_stream", None)
    stream_prov = None
    if splan is not None:
        stream_prov = dict(splan.summary())
        if sctx is not None:
            stream_prov["store_path"] = sctx.store.path
            stream_prov["store_block_rows"] = int(sctx.store.block_rows)
            stream_prov["store_num_blocks"] = int(sctx.store.num_blocks)
    # the mesh and the elected route this bundle trained under (the JAX
    # package's checkpoint.py:120-135), with the row layout: provenance,
    # never validated, since a resume re-tiles into any layout
    cplan = None
    if getattr(b, "group", None) is not None:
        cp = getattr(b, "collective_plan", None)
        cplan = {**(cp.summary() if cp is not None else {}),
                 **b._row_layout()}
    plan = getattr(b, "hist_plan", None)
    return {"chunk_cap": chunk_cap(),
            "hist_plan": dict(plan) if plan is not None else None,
            "stream_plan": stream_prov, "collective_plan": cplan}


def build_bundle_bytes(booster, iteration: int,
                       engine_state: Optional[dict] = None) -> bytes:
    """The bundle of ``booster``'s whole training state, as bytes."""
    model_txt = booster.model_to_string(num_iteration=-1).encode()
    state = {
        "boosting": booster.boosting.capture_state(),
        "booster": {"best_iteration": booster.best_iteration,
                    "best_score": booster.best_score,
                    "attr": dict(booster._attr)},
        "engine": dict(engine_state or {}),
    }
    state_pkl = pickle.dumps(state, protocol=4)
    manifest = {
        "format": FORMAT,
        "iteration": int(iteration),
        **_provenance(booster),
        "members": {
            "model.txt": {"sha256": _sha256(model_txt),
                          "size": len(model_txt)},
            "state.pkl": {"sha256": _sha256(state_pkl),
                          "size": len(state_pkl)},
        },
    }
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w", zipfile.ZIP_DEFLATED) as zf:
        zf.writestr("manifest.json", json.dumps(manifest, indent=1))
        zf.writestr("model.txt", model_txt)
        zf.writestr("state.pkl", state_pkl)
    return buf.getvalue()


def decode_bundle_bytes(blob: bytes, path: Optional[str] = None) -> Checkpoint:
    """Verify the manifest's checksums and decode; raises
    ``CheckpointCorruptError`` on any structural or checksum mismatch,
    and ``CheckpointError`` for a bundle of the JAX package."""
    where = path or "<bytes>"
    try:
        zf = zipfile.ZipFile(io.BytesIO(blob))
        manifest = json.loads(zf.read("manifest.json").decode())
    except Exception as e:
        raise CheckpointCorruptError(
            f"checkpoint {where}: unreadable container ({e})") from e
    fmt = manifest.get("format")
    if fmt == JAX_FORMAT:
        raise CheckpointError(
            f"checkpoint {where} is a lightgbm_tpu bundle ({JAX_FORMAT!r}); "
            "its state.pkl holds classes of the JAX package, which "
            "lightgbm_tpu_torch does not read. Its model.txt member is a "
            "complete model: continue training it in the port with "
            "train(..., init_model=<that model file>)")
    if fmt != FORMAT:
        raise CheckpointCorruptError(
            f"checkpoint {where}: format {fmt!r} != {FORMAT!r}")
    members = {}
    for name, meta in manifest.get("members", {}).items():
        try:
            data = zf.read(name)
        except Exception as e:
            raise CheckpointCorruptError(
                f"checkpoint {where}: missing member {name!r} ({e})") from e
        if len(data) != meta.get("size") or _sha256(data) != meta.get("sha256"):
            raise CheckpointCorruptError(
                f"checkpoint {where}: member {name!r} fails its manifest "
                "checksum (truncated or bit-flipped)")
        members[name] = data
    if "model.txt" not in members or "state.pkl" not in members:
        raise CheckpointCorruptError(
            f"checkpoint {where}: manifest lists no model/state members")
    try:
        state = _StateUnpickler(io.BytesIO(members["state.pkl"])).load()
    except Exception as e:
        raise CheckpointCorruptError(
            f"checkpoint {where}: state.pkl checksummed OK but failed to "
            f"unpickle ({e})") from e
    return Checkpoint(
        iteration=int(manifest["iteration"]),
        model_str=members["model.txt"].decode(),
        boosting_state=state["boosting"],
        booster_state=state.get("booster", {}),
        engine_state=state.get("engine", {}),
        manifest=manifest,
        path=path,
    )


def save_checkpoint(booster, path: str, iteration: Optional[int] = None,
                    engine_state: Optional[dict] = None) -> str:
    """Write one bundle to ``path`` atomically; returns the path."""
    if iteration is None:
        iteration = booster.current_iteration()
    t0 = time.perf_counter()
    with _span("checkpoint.save", iteration=int(iteration)):
        write_atomic(path,
                     build_bundle_bytes(booster, iteration, engine_state))
    _obs_registry.histogram("checkpoint_save_ms").observe(
        (time.perf_counter() - t0) * 1e3)
    return str(path)


def load_checkpoint(path: str) -> Checkpoint:
    """Read and verify one bundle."""
    if not exists(path):
        raise CheckpointNotFoundError(f"no checkpoint at {path!r}")
    t0 = time.perf_counter()
    with _span("checkpoint.load", path=str(path)):
        try:
            with open_file(path, "rb") as fh:
                blob = fh.read()
        except Exception as e:
            raise CheckpointCorruptError(
                f"checkpoint {path}: unreadable ({e})") from e
        ck = decode_bundle_bytes(blob, path=str(path))
    _obs_registry.histogram("checkpoint_load_ms").observe(
        (time.perf_counter() - t0) * 1e3)
    return ck


def restore_booster(booster, ckpt: Checkpoint) -> None:
    """Push a verified checkpoint's state into a freshly built Booster
    (the same params, train set and valid sets as the original run)."""
    booster.boosting.restore_state(ckpt.boosting_state)
    bs = ckpt.booster_state
    booster.best_iteration = bs.get("best_iteration", -1)
    booster.best_score = bs.get("best_score", {})
    booster._attr = dict(bs.get("attr", {}))


class CheckpointManager:
    """A directory of the last K bundles with an atomically updated
    index::

        <directory>/ckpt_iter_00000010.lgbckpt
        <directory>/index.json      {"format": ..., "bundles": [oldest..newest]}
    """

    def __init__(self, directory: str, prefix: str = "ckpt",
                 keep_last: int = 3):
        self.directory = str(directory).rstrip("/")
        self.prefix = prefix
        self.keep_last = max(1, int(keep_last))

    def path_for(self, iteration: int) -> str:
        return (f"{self.directory}/{self.prefix}_iter_"
                f"{int(iteration):08d}{BUNDLE_SUFFIX}")

    @property
    def index_path(self) -> str:
        return f"{self.directory}/{INDEX_NAME}"

    def _read_index(self) -> List[str]:
        try:
            with open_file(self.index_path, "r") as fh:
                idx = json.loads(fh.read())
            return [str(b) for b in idx.get("bundles", [])]
        except Exception:
            return []

    def _write_index(self, bundles: List[str]) -> None:
        write_atomic(self.index_path,
                     json.dumps({"format": FORMAT, "bundles": bundles},
                                indent=1))

    def bundles(self) -> List[str]:
        """Bundle file names, oldest to newest: the index where it is
        readable, plus (local paths only) any bundle on disk the index
        missed, so a crash between the bundle's write and the index's
        never orphans the newest checkpoint."""
        names = self._read_index()
        if "://" not in self.directory:
            import os
            try:
                on_disk = sorted(
                    f for f in os.listdir(self.directory)
                    if f.startswith(self.prefix) and f.endswith(BUNDLE_SUFFIX))
            except OSError:
                on_disk = []
            known = set(names)
            names.extend(f for f in on_disk if f not in known)
            names.sort()
        return names

    def save(self, booster, iteration: int,
             engine_state: Optional[dict] = None) -> str:
        path = self.path_for(iteration)
        save_checkpoint(booster, path, iteration, engine_state)
        name = path.rsplit("/", 1)[-1]
        names = [n for n in self.bundles() if n != name] + [name]
        # retention: the index first, so no reader sees an indexed but
        # deleted bundle
        drop, keep = names[:-self.keep_last], names[-self.keep_last:]
        self._write_index(keep)
        for old in drop:
            if not remove(f"{self.directory}/{old}"):
                log_warning(f"checkpoint retention: could not delete "
                            f"{self.directory}/{old} (no remover for the "
                            "backend, or delete refused); leaving it")
        log_info(f"checkpoint: wrote {path} (keep_last={self.keep_last})")
        return path

    def latest_verified(self, before: Optional[str] = None) -> Checkpoint:
        """The newest bundle that passes verification; corrupt ones are
        skipped with a warning.  Raises ``CheckpointNotFoundError`` when
        none survives, and ``CheckpointError`` at a bundle of the JAX
        package.  ``before`` (a bundle path or name, or an iteration)
        keeps only the bundles strictly older than it."""
        names = self.bundles()
        if before is not None:
            cutoff = (self.path_for(before) if isinstance(before, int)
                      else str(before)).rsplit("/", 1)[-1]
            names = [n for n in names if n < cutoff]
        errors: List[Tuple[str, str]] = []
        for name in reversed(names):
            path = f"{self.directory}/{name}"
            try:
                ck = load_checkpoint(path)
            except (CheckpointCorruptError, CheckpointNotFoundError) as e:
                log_warning(f"checkpoint: skipping corrupt bundle {path}: {e}")
                errors.append((name, str(e)))
                continue
            if errors:
                log_warning(
                    "checkpoint: newest bundle(s) CORRUPT, falling back "
                    f"to {path}: "
                    + "; ".join(f"{n}: {e}" for n, e in errors))
            return ck
        raise CheckpointNotFoundError(
            f"no verifiable checkpoint bundle under {self.directory!r} "
            f"(saw {len(names)}, all corrupt)" if names else
            f"no checkpoint bundles under {self.directory!r}")


def resolve_resume_point(resume_from: str) -> Checkpoint:
    """``resume_from`` is a bundle file or a manager's directory; a
    directory resolves to its newest verified bundle."""
    p = str(resume_from)
    if p.endswith(BUNDLE_SUFFIX):
        return load_checkpoint(p)
    if "://" not in p:
        import os
        if os.path.isfile(p):
            return load_checkpoint(p)
        if not os.path.isdir(p):
            raise CheckpointNotFoundError(f"resume_from={p!r}: no such "
                                          "bundle file or directory")
    return CheckpointManager(p).latest_verified()
