"""The reduction points of sharded training over a process group
(counterpart of ``lightgbm_tpu/parallel/collectives.py``).

The JAX package names mesh axes and lets XLA lower ``psum``,
``pmax`` and ``all_gather`` over them; here every collective takes an
explicit ``torch.distributed.ProcessGroup`` (``None`` = one rank: each
function is then the identity, as the JAX helpers are for axis
``None``).  An explicit group is to a collective what an explicit device
is to a tensor: ranks that are threads of one process (the CPU tests)
each hold their own gloo group, and no call reaches for the default
group behind the caller's back.

- ``psum_tiered``: the sum of an INTEGER tensor over the ranks.  The
  port's histograms and totals are exact integers (int64 fixed point, or
  int32 quantized levels), so the sum is the same in any order and the
  JAX package's hierarchical and pinned policies are equal to this flat
  one (the two-tier groups wait for ROADMAP A9's remainder);
- ``pmax_tiered``: the max (the quantization scales, the fixed-point
  peaks);
- ``all_gather_tiered``: ``[W, *shape]`` in rank order, and
  ``all_gather_bytes`` for byte payloads of any length (the distributed
  bin mappers).

gloo reduces CUDA tensors through the host; the helpers stage them there
explicitly (one copy out, one back), so the path a card's tensors take
is the same on every torch build.  NCCL reduces only CUDA tensors: a
host tensor (a row count, a byte payload) rides the current card.
``op_counts`` counts each collective and its payload bytes,
process-wide, and ``thread_op_counts`` the calling thread's (one
rank's, when ranks are threads).

Observability, as in the JAX package's collectives.py:49-163: each sum
notes its route in the flight ring (``collective.route``: the tier, the
bytes) and runs in a ``collective.reduce`` span with its bytes; a
collective that raises dumps a flight-recorder bundle
(``collective:<error>``) before the error propagates.  The sharded
round body runs eagerly, so these record on every call.
"""

from __future__ import annotations

import threading
from typing import List

import torch
import torch.distributed as dist

from ..obs.flight import global_flight as _flight
from ..obs.trace import span as _span

_counts_lock = threading.Lock()
_KINDS = ("all_reduce", "all_gather")
op_counts = {k + s: 0 for k in _KINDS for s in ("", "_bytes")}
_thread = threading.local()


def thread_op_counts() -> dict:
    """The calling thread's collective counts (its own dict)."""
    d = getattr(_thread, "counts", None)
    if d is None:
        d = _thread.counts = {k: 0 for k in op_counts}
    return d


def reset_op_counts() -> None:
    with _counts_lock:
        for k in op_counts:
            op_counts[k] = 0
    for k in thread_op_counts():
        thread_op_counts()[k] = 0


def _count(kind: str, nbytes: int) -> None:
    mine = thread_op_counts()
    with _counts_lock:
        for d in (op_counts, mine):
            d[kind] += 1
            d[kind + "_bytes"] += int(nbytes)


def axis_size(group) -> int:
    """The number of ranks of ``group`` (1 for None)."""
    return 1 if group is None else int(group.size())


def axis_index_flat(group) -> int:
    """This rank's index in ``group`` (0 for None)."""
    return 0 if group is None else int(group.rank())


def _nbytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()


def _wire(group, x: torch.Tensor) -> torch.Tensor:
    """``x`` where ``group``'s backend reduces it: gloo on the host, NCCL
    on the current card (``x`` itself where it already is)."""
    if group.name() == "gloo":
        return x.cpu()
    if group.name() == "nccl" and x.device.type == "cpu":
        return x.to(torch.device("cuda", torch.cuda.current_device()))
    return x


def _wait(work) -> None:
    """Wait for a collective; a failure dumps a forensic bundle first."""
    try:
        work.wait()
    except Exception as e:  # noqa: BLE001 - re-raised after the dump
        _flight.on_exception("collective", e)
        raise


def _all_reduce(x: torch.Tensor, group, op, tier: str) -> torch.Tensor:
    out = x.contiguous().clone()
    wire = _wire(group, out)
    nbytes = _nbytes(wire)
    _flight.note("collective.route", tiers=[tier], hierarchical=False,
                 pinned=False, bytes=nbytes)
    opts = dist.AllreduceOptions()
    opts.reduceOp = op
    with _span("collective.reduce", tier=tier, bytes=nbytes):
        _wait(group.allreduce([wire], opts))
    if wire is not out:
        out.copy_(wire)
    _count("all_reduce", nbytes)
    return out


def psum_tiered(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of integer ``x`` over ``group``'s ranks (a new tensor)."""
    if group is None or group.size() == 1:
        return x
    if x.is_floating_point():
        raise TypeError("psum_tiered sums integer tensors only: a float "
                        "sum depends on the order of the ranks")
    return _all_reduce(x, group, dist.ReduceOp.SUM, group.name())


def pmax_tiered(x: torch.Tensor, group) -> torch.Tensor:
    """The max of ``x`` over ``group``'s ranks (exact in any order)."""
    if group is None or group.size() == 1:
        return x
    return _all_reduce(x, group, dist.ReduceOp.MAX, group.name())


def all_gather_tiered(x: torch.Tensor, group) -> torch.Tensor:
    """``[W, *x.shape]``: every rank's ``x`` (same shape on every rank),
    in rank order."""
    if group is None or group.size() == 1:
        return x[None]
    wire = _wire(group, x.contiguous())
    outs = [torch.empty_like(wire) for _ in range(group.size())]
    _wait(group.allgather([outs], [wire]))
    _count("all_gather", _nbytes(wire) * group.size())
    return torch.stack(outs).to(x.device)


def all_gather_bytes(payload: bytes, group) -> List[bytes]:
    """Every rank's byte payload (any length), in rank order: the
    lengths first, then the payloads padded to the longest (reference:
    Network::Allgather with per-rank block sizes, network.h:89-120)."""
    if group is None or group.size() == 1:
        return [payload]
    n = torch.tensor([len(payload)], dtype=torch.int64)
    lens = all_gather_tiered(n, group).reshape(-1).tolist()
    buf = torch.zeros(max(lens), dtype=torch.uint8)
    if payload:
        buf[:len(payload)] = torch.frombuffer(bytearray(payload),
                                              dtype=torch.uint8)
    allb = all_gather_tiered(buf, group)
    return [bytes(allb[r, :lens[r]].numpy().tobytes())
            for r in range(group.size())]
