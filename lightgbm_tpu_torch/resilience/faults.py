"""Deterministic, seeded fault injection over the port's seams
(counterpart of ``lightgbm_tpu/resilience/faults.py``).

The seams are wrapped, never monkeypatched:

- the ``allgather_bytes`` transport of ``parallel/dist_data.py``:
  ``wrap_allgather`` returns a transport with scheduled payload
  corruption (drop / truncate / bit-flip), latency (delay) and wedges
  (stall);
- the pluggable file system of ``utils/file_io.py``:
  ``install_filesystem`` registers a ``chaos://`` scheme whose opener
  proxies to the real path underneath while injecting ENOSPC, silent
  partial writes (the crash-mid-write shape) and transient errors;
- a predict callable: ``wrap_predict`` injects latency spikes
  (``serving.delay``), NaN outputs (``serving.nan``) and hard failures
  (``serving.error``);
- one logical serving device of a ``fleet.PodFleet`` (its batcher's
  ``run_batch``): ``wrap_device_batch`` errors, delays, wedges or
  vanishes it, raising the port's ``serving.errors.DeviceLost`` that
  the pod's router retries on a surviving replica.

Faults are scheduled, not sprayed: a ``FaultSpec`` names a site
(``allgather`` / ``fs`` / ``serving`` / ``device``), a kind, the 0-based
op index at which it fires on that site, and optionally the rank (or
device id) it applies to.  The compact string syntax::

    allgather.bitflip@2:rank=1,allgather.delay@0:sec=0.05,fs.enospc@1

means "bit-flip rank 1's 3rd allgather send, delay everyone's 1st by
50 ms, ENOSPC the 2nd chaos:// write open".  ``prob=`` makes a spec
probabilistic; draws come from one ``numpy.RandomState(seed)``, so a
chaos run replays bit-identically under the same seed and schedule (the
JAX package's draws, number for number).

Transport faults corrupt the outbound frame by default (every receiver
sees the damage); ``recv`` kinds corrupt one entry of the received list
on the faulted rank only.
"""

from __future__ import annotations

import errno
import io
import threading
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence

from ..utils.file_io import open_file, register_file_system, remove, \
    unregister_file_system
from ..utils.log import log_warning

ALLGATHER_KINDS = ("drop", "truncate", "bitflip", "delay", "stall",
                   "recv_bitflip", "recv_truncate")
FS_KINDS = ("enospc", "partial", "transient")
# the serving site wraps a predict callable: ``delay`` injects a latency
# spike (arg/sec seconds), ``nan`` poisons one output element, ``error``
# raises: the failure shapes a rollout gate must catch
SERVING_KINDS = ("delay", "nan", "error")
# the device site kills one logical serving device of a pod fleet
# (fleet/router.py): ``error`` fails one batch execution (a transient
# device fault), ``wedge``
# blocks the device's batcher thread (arg/sec seconds, default forever
# — the preempted-but-not-dead shape whose heartbeat goes stale), and
# ``vanish`` makes the device gone for good (every later dispatch fails
# fast with DeviceLost).  ``rank=`` selects the device id; the 0-based
# op index counts batch executions on that device.  wedge/vanish are
# PERSISTENT: once fired the device stays down until the registry is
# discarded — a replan, not a retry, is the recovery path.  ``delay``
# sleeps arg/sec seconds (default 0.05) before the batch executes and
# then SUCCEEDS — the latency-inflation shape (a contended device under
# co-resident training) that brownout controllers must catch without a
# single typed failure.
DEVICE_KINDS = ("wedge", "error", "vanish", "delay")


class FaultInjected(OSError):
    """Raised by injected transient file-system faults."""


@dataclass
class FaultSpec:
    site: str                   # "allgather" | "fs" | "serving" | "device"
    kind: str
    at: int                     # 0-based op index on that (site, rank)
    rank: Optional[int] = None  # allgather rank / device id; None = all
    prob: float = 1.0           # fire probability when the index matches
    arg: float = 0.0            # delay/stall seconds, etc.
    fired: int = 0

    def __post_init__(self):
        kinds = {"allgather": ALLGATHER_KINDS, "fs": FS_KINDS,
                 "serving": SERVING_KINDS, "device": DEVICE_KINDS}
        ok = kinds.get(self.site)
        if ok is None:
            raise ValueError(f"unknown fault site {self.site!r}")
        if self.kind not in ok:
            raise ValueError(
                f"unknown {self.site} fault kind {self.kind!r}; "
                f"one of {ok}")


def parse_schedule(schedule: str) -> List[FaultSpec]:
    """Parse the compact comma-separated schedule syntax (module doc)."""
    specs: List[FaultSpec] = []
    for tok in (schedule or "").split(","):
        tok = tok.strip()
        if not tok:
            continue
        head, _, opts = tok.partition(":")
        try:
            site_kind, _, at = head.partition("@")
            site, _, kind = site_kind.partition(".")
            spec = FaultSpec(site=site, kind=kind, at=int(at or 0))
        except ValueError:
            raise
        except Exception as e:
            raise ValueError(f"bad fault token {tok!r}: {e}") from e
        for opt in filter(None, opts.split(":")):
            k, _, v = opt.partition("=")
            if k == "rank":
                spec.rank = int(v)
            elif k == "prob":
                spec.prob = float(v)
            elif k in ("sec", "arg"):
                spec.arg = float(v)
            else:
                raise ValueError(f"bad fault option {opt!r} in {tok!r}")
        specs.append(spec)
    return specs


class ChaosRegistry:
    """Holds the schedule, the seeded RNG and per-(site, rank) op
    counters; hands out wrapped seams.  Thread-safe — fake-mesh ranks run
    on threads."""

    def __init__(self, schedule: "str | Sequence[FaultSpec]" = (),
                 seed: int = 0):
        import numpy as np
        self.specs = (parse_schedule(schedule)
                      if isinstance(schedule, str) else list(schedule))
        self._rng = np.random.RandomState(seed)
        self._lock = threading.Lock()
        self._counts: Dict[tuple, int] = {}
        self._downed: Dict[int, str] = {}   # device id -> "wedge"|"vanish"
        self.log: List[str] = []     # every fault actually fired

    # ------------------------------------------------------------ core match

    def _next_op(self, site: str, rank: Optional[int]) -> int:
        with self._lock:
            key = (site, rank)
            n = self._counts.get(key, 0)
            self._counts[key] = n + 1
            return n

    def _due(self, site: str, rank: Optional[int], op: int) -> List[FaultSpec]:
        out = []
        with self._lock:
            for s in self.specs:
                if s.site != site or s.at != op:
                    continue
                if site in ("allgather", "device") and s.rank is not None \
                        and s.rank != rank:
                    continue
                if s.prob < 1.0 and self._rng.rand() >= s.prob:
                    continue
                s.fired += 1
                self.log.append(f"{site}[{'' if rank is None else rank}]"
                                f".{s.kind}@{op}")
                out.append(s)
        return out

    # ------------------------------------------------------------- allgather

    def wrap_allgather(self, fn: Callable[[bytes], List[bytes]],
                       rank: int) -> Callable[[bytes], List[bytes]]:
        """Chaos transport for one rank.  Faults consume the transport
        round (a dropped send still participates with a tombstone), so
        rank-local round counters never desynchronize — which is what
        lets retry recover instead of phase-shifting forever."""

        def chaotic(payload: bytes) -> List[bytes]:
            op = self._next_op("allgather", rank)
            send = payload
            recv_specs = []
            for s in self._due("allgather", rank, op):
                if s.kind == "drop":
                    send = b"\x00LGBT-CHAOS-DROPPED"
                elif s.kind == "truncate":
                    send = send[:max(1, len(send) // 2)]
                elif s.kind == "bitflip":
                    i = min(len(send) - 1, 8 + (s.at % max(1, len(send) - 8)))
                    send = send[:i] + bytes([send[i] ^ 0x40]) + send[i + 1:]
                elif s.kind == "delay":
                    time.sleep(s.arg or 0.05)
                elif s.kind == "stall":
                    time.sleep(s.arg or 3600.0)
                else:
                    recv_specs.append(s)
            out = fn(send)
            for s in recv_specs:
                victim = (rank + 1) % max(1, len(out))
                blob = out[victim]
                if s.kind == "recv_truncate":
                    out = list(out)
                    out[victim] = blob[:max(1, len(blob) // 2)]
                elif s.kind == "recv_bitflip" and blob:
                    i = min(len(blob) - 1, 8)
                    out = list(out)
                    out[victim] = (blob[:i] + bytes([blob[i] ^ 0x40])
                                   + blob[i + 1:])
            return out

        return chaotic

    # -------------------------------------------------------------- serving

    def wrap_predict(self, fn: Callable) -> Callable:
        """Chaos wrapper for a predict callable: scheduled
        ``serving.delay`` sleeps before the
        call (a mid-ramp latency spike), ``serving.error`` raises
        instead of serving, ``serving.nan`` poisons one element of the
        returned scores — each at its 0-based call index, exactly like
        the other sites."""

        def chaotic(*args, **kwargs):
            import numpy as np
            op = self._next_op("serving", None)
            post = []
            for s in self._due("serving", None, op):
                if s.kind == "delay":
                    time.sleep(s.arg or 0.05)
                elif s.kind == "error":
                    raise FaultInjected(
                        errno.EIO, "chaos: injected serving error")
                else:
                    post.append(s)
            out = fn(*args, **kwargs)
            for s in post:
                if s.kind == "nan":
                    out = np.array(out, dtype=np.float64, copy=True)
                    out.reshape(-1)[0] = np.nan
            return out

        return chaotic

    # --------------------------------------------------------------- device

    def device_down(self, device_id: int) -> Optional[str]:
        """The persistent down-state of a simulated device: ``"wedge"`` /
        ``"vanish"`` once such a fault fired (or ``down_device`` was
        called), else None.  The pod router consults this at dispatch so
        a vanished device fails FAST instead of queueing work a dead
        batcher will never pop."""
        with self._lock:
            return self._downed.get(int(device_id))

    def down_device(self, device_id: int, kind: str = "vanish") -> None:
        """Imperatively kill a device now: the mid-run kill switch of a
        failover drill, where the interesting moment is wall-clock
        ("under load"), not a batch index."""
        if kind not in ("wedge", "vanish"):
            raise ValueError(f"device down kind must be wedge|vanish, "
                             f"got {kind!r}")
        with self._lock:
            self._downed[int(device_id)] = kind
            self.log.append(f"device[{device_id}].{kind}@manual")

    def wrap_device_batch(self, device_id: int, fn: Callable) -> Callable:
        """Chaos wrapper for one simulated serving device's batch
        executor (the MicroBatcher ``run_batch`` seam).  Scheduled
        ``device.error`` fails this one batch (transient — the router
        retries elsewhere); ``device.wedge`` marks the device down and
        blocks the batcher thread (its liveness beat goes stale — the
        health-scored death the watchdog detects); ``device.vanish``
        marks the device down and raises ``DeviceLost``.  A device
        already down keeps failing/blocking on every later batch."""
        did = int(device_id)

        def chaotic(batch):
            from ..serving.errors import DeviceLost
            op = self._next_op("device", did)
            for s in self._due("device", did, op):
                if s.kind in ("wedge", "vanish"):
                    with self._lock:
                        self._downed[did] = s.kind
                elif s.kind == "delay":
                    # latency inflation, not failure: the batch still
                    # succeeds after the stall (brownout-detection shape)
                    time.sleep(s.arg if s.arg else 0.05)
                elif s.kind == "error":
                    raise FaultInjected(
                        errno.EIO,
                        f"chaos: injected device {did} batch error")
            state = self.device_down(did)
            if state == "vanish":
                raise DeviceLost(f"chaos: device {did} vanished")
            if state == "wedge":
                # the wedged device's batcher blocks here: in-flight
                # items never complete, the per-replica heartbeat goes
                # stale, and only the router's drain/replan recovers
                spec = next((s for s in self.specs
                             if s.site == "device" and s.kind == "wedge"
                             and (s.rank is None or s.rank == did)), None)
                time.sleep((spec.arg if spec is not None and spec.arg
                            else 3600.0))
                raise DeviceLost(f"chaos: device {did} wedged")
            return fn(batch)

        return chaotic

    # ----------------------------------------------------------- file system

    def install_filesystem(self, scheme: str = "chaos") -> str:
        """Register ``<scheme>://<path>`` proxying to ``<path>`` with fs
        faults applied at open/write time; returns the scheme."""
        registry = self

        def opener(path: str, mode: str = "r"):
            real = path.split("://", 1)[1]
            writing = any(c in mode for c in "wa+x")
            if writing and "://" not in real:
                # object stores create "directories" implicitly; the local
                # proxy must too or every chaos:// write needs a mkdir
                import os
                d = os.path.dirname(os.path.abspath(real))
                if d:
                    os.makedirs(d, exist_ok=True)
            if writing:
                op = registry._next_op("fs", None)
                for s in registry._due("fs", None, op):
                    if s.kind == "enospc":
                        raise FaultInjected(
                            errno.ENOSPC, "chaos: no space left on device",
                            real)
                    if s.kind == "transient":
                        raise FaultInjected(
                            errno.EIO, "chaos: transient write error", real)
                    if s.kind == "partial":
                        return _PartialWriter(real, mode)
            return open_file(real, mode)

        def remover(path: str):
            remove(path.split("://", 1)[1])

        register_file_system(scheme, opener, remover)
        return scheme

    def uninstall_filesystem(self, scheme: str = "chaos") -> None:
        unregister_file_system(scheme)


class _PartialWriter:
    """File-like that buffers writes, then SILENTLY persists only the
    first half on close — the on-disk shape of a crash mid-write on a
    backend without atomic rename.  Checksums, not luck, must catch it."""

    def __init__(self, real_path: str, mode: str):
        self._real = real_path
        self._binary = "b" in mode
        self._buf = io.BytesIO() if self._binary else io.StringIO()
        self.closed = False

    def write(self, data):
        return self._buf.write(data)

    def flush(self):
        pass

    def close(self):
        if self.closed:
            return
        self.closed = True
        data = self._buf.getvalue()
        half = data[:max(1, len(data) // 2)]
        with open_file(self._real, "wb" if self._binary else "w") as fh:
            fh.write(half)
        log_warning(f"chaos: partial write persisted "
                    f"{len(half)}/{len(data)} bytes to {self._real}")

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
