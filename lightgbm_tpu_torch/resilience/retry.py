"""Resilient byte all-gather: CRC framing, deadline, backoff and a
verdict that every rank shares (counterpart of
``lightgbm_tpu/resilience/retry.py``).

The distributed Dataset's all-gather (``parallel/dist_data.py``) is what
distributed construction needs of a degraded network, and the raw seam
(``collectives.all_gather_bytes`` over a process group, or an injected
``allgather_bytes``) has no deadline, no retry and no corruption check.
``resilient_allgather`` wraps ANY such callable with:

- **per-attempt CRC framing**: every payload travels as ``magic |
  version | attempt | crc32 | length | bytes``, so a truncated,
  bit-flipped, dropped or round-mixed entry is caught on receipt and
  never consumed;
- **a verdict round**: after each payload round every rank sends its
  1-byte ok/bad verdict through the SAME transport, and the attempt
  commits only when every rank voted ok, so a corruption that one
  receiver sees makes ALL ranks retry together;
- **a deadline and exponential backoff with per-rank jitter** drawn
  from a seeded stream: attempts stop at ``max_retries`` or at the
  deadline, whichever comes first, and each transport call is bounded
  in time (a stalled transport thread is abandoned, never joined), so
  the caller never hangs;
- on exhaustion every rank raises ``CollectiveError`` within the
  deadline: a consistent abort.

Each attempt is an ``allgather.attempt`` span and flight note, beats the
``collective.allgather`` heartbeat and counts into the process
registry's ``collective_clean``, ``collective_retries``,
``collective_retries_recovered`` and ``collective_aborts``; an abort
dumps a flight bundle.  reference anchor: Network::Allgather
(network.h:89-120) assumes a healthy socket ring.
"""

from __future__ import annotations

import struct
import threading
import time
import zlib
from dataclasses import dataclass
from typing import Callable, List, Optional, Tuple

import numpy as np

from ..utils.log import log_warning

MAGIC = b"LGRA"     # payload frame
VMAGIC = b"LGRV"    # verdict frame
_VERSION = 1
_HEAD = struct.Struct("<BIIQ")   # version, attempt, crc32, payload length


class CollectiveError(RuntimeError):
    """Allgather failed permanently (deadline / retries exhausted).
    Raised on every rank — the consistent-abort signal."""


@dataclass(frozen=True)
class ResilienceConfig:
    """Knobs for ``resilient_allgather`` (params surface:
    ``network_deadline`` seconds, ``network_retries``,
    ``network_backoff`` base seconds, ``network_degraded_fallback``)."""

    deadline_s: float = 30.0
    max_retries: int = 4
    base_backoff_s: float = 0.05
    backoff_cap_s: float = 2.0
    jitter_seed: int = 0
    degraded_fallback: bool = False

    @classmethod
    def from_params(cls, params: dict) -> "Optional[ResilienceConfig]":
        """None unless ``network_resilience`` is truthy."""
        p = params or {}
        if not p.get("network_resilience", False):
            return None
        return cls(
            deadline_s=float(p.get("network_deadline", 30.0)),
            max_retries=int(p.get("network_retries", 4)),
            base_backoff_s=float(p.get("network_backoff", 0.05)),
            jitter_seed=int(p.get("network_jitter_seed",
                                  p.get("data_random_seed", 1))),
            degraded_fallback=bool(p.get("network_degraded_fallback",
                                         False)),
        )


def frame_payload(payload: bytes, attempt: int) -> bytes:
    return MAGIC + _HEAD.pack(_VERSION, attempt,
                              zlib.crc32(payload) & 0xFFFFFFFF,
                              len(payload)) + payload


def unframe_payload(blob: bytes,
                    attempt: int) -> Tuple[Optional[bytes], str]:
    """Returns (payload, "") or (None, reason)."""
    head = len(MAGIC) + _HEAD.size
    if len(blob) < head:
        return None, f"short frame ({len(blob)} bytes)"
    if blob[:len(MAGIC)] != MAGIC:
        return None, "bad magic"
    ver, att, crc, length = _HEAD.unpack(blob[len(MAGIC):head])
    if ver != _VERSION:
        return None, f"version {ver}"
    if att != attempt:
        return None, f"attempt {att} != {attempt} (round-mixed)"
    payload = blob[head:]
    if len(payload) != length:
        return None, f"truncated ({len(payload)}/{length} bytes)"
    if zlib.crc32(payload) & 0xFFFFFFFF != crc:
        return None, "crc mismatch (bit-flip)"
    return payload, ""


def _call_bounded(fn: Callable[[bytes], List[bytes]], arg: bytes,
                  timeout: float) -> List[bytes]:
    """Run ``fn(arg)`` on a daemon thread, waiting at most ``timeout``
    seconds.  A stalled transport is ABANDONED (the thread leaks until
    the underlying call returns) — the alternative is hanging forever."""
    box: list = []

    def run():
        try:
            box.append(("ok", fn(arg)))
        except BaseException as e:  # noqa: BLE001 — re-raised on the caller
            box.append(("err", e))

    t = threading.Thread(target=run, daemon=True,
                         name="lgbt-resilient-allgather")
    t.start()
    t.join(timeout)
    if not box:
        raise TimeoutError(f"transport call exceeded {timeout:.2f}s")
    kind, val = box[0]
    if kind == "err":
        raise val
    return val


def resilient_allgather(payload: bytes,
                        allgather_bytes: Callable[[bytes], List[bytes]],
                        *, world: int, rank: int,
                        config: Optional[ResilienceConfig] = None,
                        label: str = "allgather",
                        metrics=None,
                        flight_dump: bool = True) -> List[bytes]:
    """Allgather ``payload`` across ``world`` ranks, surviving transient
    transport faults; returns the unframed per-rank payloads.

    Raises ``CollectiveError`` (on every rank, within the deadline) when
    the transport cannot produce a round that ALL ranks verify.

    ``metrics`` defaults to the unified process registry
    (``obs.metrics.global_registry``) so collective health counters are
    always visible process-wide; pass a registry to scope them.  Every
    attempt records an ``allgather.attempt`` trace span when tracing is
    enabled (docs/OBSERVABILITY.md).
    """
    cfg = config or ResilienceConfig()
    if metrics is None:
        from ..obs.metrics import global_registry
        metrics = global_registry
    from ..obs.flight import global_flight
    from ..obs.trace import span as _span
    from ..obs.watchdog import beat as _beat
    deadline = time.monotonic() + cfg.deadline_s
    rng = np.random.RandomState(
        (int(cfg.jitter_seed) * 1000003 + rank * 7919) % (2 ** 31))
    attempt = 0
    last_reason = "no attempt ran"

    def bump(name):
        if metrics is not None:
            metrics.counter(name).inc()

    while True:
        remaining = deadline - time.monotonic()
        if remaining <= 0 or attempt > cfg.max_retries:
            bump("collective_aborts")
            err = CollectiveError(
                f"{label}: rank {rank} aborting after {attempt} attempt(s) "
                f"({'deadline exceeded' if remaining <= 0 else 'retries exhausted'}); "
                f"last failure: {last_reason}")
            # consistent abort = the forensic moment: every rank dumps
            # its own bundle (ring shows this rank's retry ladder).
            # flight_dump=False spares the bounded dump budget for
            # callers whose failure is benign (pod telemetry) or who
            # dump a more specific bundle themselves (membership probe)
            if flight_dump:
                global_flight.on_exception("collective", err)
            raise err
        _beat("collective.allgather", count=attempt)
        att_span = _span("allgather.attempt", label=label, rank=rank,
                         attempt=attempt)
        with att_span:
            # --- payload round ---------------------------------------------
            ok, parts, reason = True, None, ""
            try:
                raw = _call_bounded(allgather_bytes,
                                    frame_payload(payload, attempt),
                                    remaining)
                if len(raw) != world:
                    ok, reason = False, f"{len(raw)} parts != world {world}"
                else:
                    parts = []
                    for r, blob in enumerate(raw):
                        p, why = unframe_payload(blob, attempt)
                        if p is None:
                            ok, reason = False, f"rank {r} frame: {why}"
                            break
                        parts.append(p)
            except Exception as e:  # noqa: BLE001 — any transport fault retries
                ok, reason = False, repr(e)
            # --- verdict round: all ranks agree to commit or retry ---------
            committed = False
            remaining = deadline - time.monotonic()
            if remaining > 0:
                try:
                    vote = VMAGIC + struct.pack("<IB", attempt,
                                                1 if ok else 0)
                    votes = _call_bounded(allgather_bytes, vote, remaining)
                    if len(votes) == world:
                        committed = ok and all(
                            len(v) == len(vote) and v[:4] == VMAGIC
                            and struct.unpack("<IB", v[4:])[0] == attempt
                            and struct.unpack("<IB", v[4:])[1] == 1
                            for v in votes)
                        if ok and not committed:
                            reason = "a peer rank voted to retry"
                    else:
                        reason = reason or "verdict round incomplete"
                except Exception as e:  # noqa: BLE001
                    reason = reason or f"verdict round failed: {e!r}"
            att_span.set(ok=ok, committed=committed,
                         reason=(reason or "")[:120])
        # the flight ring sees every attempt outcome even with tracing
        # off — a CollectiveError bundle must show the retry ladder
        global_flight.note("allgather.attempt", label=label, rank=rank,
                           attempt=attempt, ok=ok, committed=committed,
                           reason=(reason or "")[:120])
        if committed:
            if attempt > 0:
                log_warning(f"{label}: rank {rank} recovered after "
                            f"{attempt} retr{'y' if attempt == 1 else 'ies'}")
            bump("collective_retries_recovered" if attempt else
                 "collective_clean")
            return parts
        last_reason = reason or "unknown"
        bump("collective_retries")
        attempt += 1
        backoff = min(cfg.backoff_cap_s,
                      cfg.base_backoff_s * (2.0 ** (attempt - 1)))
        backoff *= 0.5 + 0.5 * rng.rand()     # deterministic per-rank jitter
        time.sleep(max(0.0, min(backoff, deadline - time.monotonic())))


def make_resilient(allgather_bytes, *, world: int, rank: int,
                   config: ResilienceConfig, label: str = "allgather",
                   metrics=None):
    """Wrap a raw AllgatherBytes into one with the same signature that
    routes every round through ``resilient_allgather``."""
    def wrapped(payload: bytes) -> List[bytes]:
        return resilient_allgather(payload, allgather_bytes, world=world,
                                   rank=rank, config=config, label=label,
                                   metrics=metrics)
    return wrapped
