"""The reduction points of sharded training over process groups and
meshes of them (counterpart of ``lightgbm_tpu/parallel/collectives.py``).

The JAX package names mesh axes and lets XLA lower ``psum``,
``pmax`` and ``all_gather`` over them; here every collective takes an
explicit ``torch.distributed.ProcessGroup`` or a ``ProcessMesh`` of them
(``None`` = one rank: each function is then the identity, as the JAX
helpers are for axis ``None``).  An explicit group is to a collective
what an explicit device is to a tensor: ranks that are threads of one
process (the CPU tests) each hold their own gloo group, and no call
reaches for the default group behind the caller's back.

A ``ProcessMesh`` is the JAX package's named mesh made of process
groups: axis names (outermost first), a shape, the group of all its
ranks, whose rank order is the mesh's linear order (outermost axis most
significant), and this rank's sub-group along each axis
(``parallel.learners.make_mesh`` builds one).  The two-tier layout is
``HYBRID_AXES`` = ("dcn", "ici"): slices over the slow tier (the links
between hosts), each slice's ranks over the fast one (the links inside a
host).  Every function takes ``axis`` (a name or an outermost-first
tuple of the mesh's names; None = all of them); ``ProcessMesh.over``
gives the mesh of one or more of its axes as a value to pass around.

- ``psum_tiered``: the sum of an INTEGER tensor.  Two routes: **flat**
  (one all-reduce over every rank of the axes) and **hierarchical** (the
  innermost tier first, then each tier outwards, one all-reduce a tier).
  The port's histograms and totals are exact integers (int64 fixed
  point, or int32 quantized levels), so both give the same bits in any
  order (the JAX package's third, pinned route fixes the order of float
  sums, which the port has none of); they move different bytes over
  different groups, which ``op_counts`` counts per tier;
- ``pmax_tiered``: the max (the quantization scales, the fixed-point
  peaks): exact in any order, one all-reduce;
- ``all_gather_tiered``: ``[W, *shape]`` in the linear rank order, and
  ``all_gather_bytes`` for byte payloads of any length (the distributed
  bin mappers, the membership probe).

gloo reduces CUDA tensors through the host; the helpers stage them there
explicitly (one copy out, one back), so the path a card's tensors take
is the same on every torch build.  NCCL reduces only CUDA tensors: a
host tensor (a row count, a byte payload) rides the current card.
``op_counts`` counts each collective and its payload bytes,
process-wide, and ``thread_op_counts`` the calling thread's (one
rank's, when ranks are threads); ``<kind>@<tier>`` and
``<kind>@<tier>_bytes`` count each tier apart (the tier is the mesh
axis, ``+``-joined names for a flat sum over several, ``flat`` for a
bare group).

Observability, as in the JAX package's collectives.py:49-163: each sum
notes its route in the flight ring (``collective.route``: the tiers,
hierarchical or not, the bytes) and runs each tier's
all-reduce in a ``collective.reduce`` span tagged with the tier and its
bytes; a collective that raises dumps a flight-recorder bundle
(``collective:<error>``) before the error propagates.  The sharded
round body runs eagerly, so these record on every call.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Sequence, Tuple, Union

import torch
import torch.distributed as dist

from ..obs.flight import global_flight as _flight
from ..obs.trace import span as _span

# the two-tier mesh's axes, outermost first: slices over the links
# between hosts, a slice's ranks over the links inside one
DCN_AXIS = "dcn"
ICI_AXIS = "ici"
HYBRID_AXES: Tuple[str, str] = (DCN_AXIS, ICI_AXIS)

AxisName = Union[None, str, Sequence[str]]

_counts_lock = threading.Lock()
_KINDS = ("all_reduce", "all_gather")
op_counts = {k + s: 0 for k in _KINDS for s in ("", "_bytes")}
_thread = threading.local()


def axis_names(axis_name: AxisName) -> Tuple[str, ...]:
    """Normalize ``None | str | tuple`` to an outermost-first tuple."""
    if axis_name is None:
        return ()
    if isinstance(axis_name, str):
        return (axis_name,)
    return tuple(axis_name)


class ProcessMesh:
    """Ranks arranged on named axes (see the module docstring).

    ``group`` holds every rank of the mesh, ``groups[axis]`` this rank's
    sub-group along ``axis`` (the ranks whose other coordinates are this
    rank's), ``shape[axis]`` the axis size; ``rank`` is this rank's
    linear index (its rank in ``group``) and ``coords`` its index along
    each axis."""

    def __init__(self, group, axes: Sequence[str], shape: Sequence[int],
                 groups: Dict[str, object]):
        self.axis_names = tuple(axes)
        sizes = tuple(int(s) for s in shape)
        if len(sizes) != len(self.axis_names):
            raise ValueError(f"mesh axes {self.axis_names} and shape "
                             f"{sizes} differ in length")
        self.shape = dict(zip(self.axis_names, sizes))
        self.group = group
        self.groups = dict(groups)
        total = 1
        for s in sizes:
            total *= s
        if int(group.size()) != total:
            raise ValueError(f"a mesh of shape {sizes} needs {total} ranks; "
                             f"the group has {group.size()}")
        self.rank = int(group.rank())
        coords, r = [], self.rank
        for s in reversed(sizes):
            coords.append(r % s)
            r //= s
        self.coords = dict(zip(self.axis_names, reversed(coords)))

    def over(self, axis: AxisName) -> "ProcessMesh":
        """The mesh of ``axis`` alone (one name, or all of them): its
        group is the sub-group of one axis, or this mesh's group."""
        names = axis_names(axis) or self.axis_names
        if names == self.axis_names:
            return self
        if len(names) != 1:
            raise ValueError(f"a sub-mesh over {names} of {self.axis_names}: "
                             "one axis, or all of them")
        ax = names[0]
        return ProcessMesh(self.groups[ax], (ax,), (self.shape[ax],),
                           {ax: self.groups[ax]})

    def __repr__(self) -> str:
        return (f"ProcessMesh({dict(self.shape)}, rank={self.rank}, "
                f"backend={self.group.name()!r})")


def _tiers(group, axis: AxisName) -> Tuple[List[Tuple[str, object]],
                                           Tuple[str, object]]:
    """([(tier, sub-group)] outermost first, (flat tier, flat group)) of
    ``group`` (a ProcessGroup or a ProcessMesh) along ``axis``."""
    if not isinstance(group, ProcessMesh):
        if axis_names(axis):
            raise ValueError(f"axis {axis!r} needs a ProcessMesh, not a "
                             "bare process group")
        return [("flat", group)], ("flat", group)
    mesh = group.over(axis)
    tiers = [(ax, mesh.groups[ax]) for ax in mesh.axis_names]
    if len(tiers) == 1:
        return tiers, tiers[0]
    return tiers, ("+".join(mesh.axis_names), mesh.group)


def thread_op_counts() -> dict:
    """The calling thread's collective counts (its own dict)."""
    d = getattr(_thread, "counts", None)
    if d is None:
        d = _thread.counts = {k: 0 for k in op_counts}
    return d


def reset_op_counts() -> None:
    for d in (op_counts, thread_op_counts()):
        with _counts_lock:
            for k in list(d):
                if "@" in k:
                    del d[k]
                else:
                    d[k] = 0


def _count(kind: str, nbytes: int, tier: str) -> None:
    mine = thread_op_counts()
    with _counts_lock:
        for d in (op_counts, mine):
            for k in (kind, f"{kind}@{tier}"):
                d[k] = d.get(k, 0) + 1
                d[k + "_bytes"] = d.get(k + "_bytes", 0) + int(nbytes)


def axis_size(group, axis: AxisName = None) -> int:
    """The number of ranks of ``group`` along ``axis`` (the product over
    a tuple; every axis for None; 1 for a None group)."""
    if group is None:
        return 1
    if isinstance(group, ProcessMesh):
        out = 1
        for ax in axis_names(axis) or group.axis_names:
            out *= group.shape[ax]
        return out
    return int(group.size())


def axis_index_flat(group, axis: AxisName = None) -> int:
    """This rank's linear index along ``axis`` (outermost most
    significant, the order of ``all_gather_tiered``; 0 for None)."""
    if group is None:
        return 0
    if isinstance(group, ProcessMesh):
        idx = 0
        for ax in axis_names(axis) or group.axis_names:
            idx = idx * group.shape[ax] + group.coords[ax]
        return idx
    return int(group.rank())


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
    """One all-reduce of ``x`` over ``group`` in a span of ``tier`` (a
    new tensor)."""
    out = x.contiguous().clone()
    wire = _wire(group, out)
    nbytes = _nbytes(wire)
    opts = dist.AllreduceOptions()
    opts.reduceOp = op
    with _span("collective.reduce", tier=tier, bytes=nbytes):
        _wait(group.allreduce([wire], opts))
    if wire is not out:
        out.copy_(wire)
    _count("all_reduce", nbytes, tier)
    return out


def _all_gather(x: torch.Tensor, group, tier: str) -> torch.Tensor:
    wire = _wire(group, x.contiguous())
    outs = [torch.empty_like(wire) for _ in range(group.size())]
    _wait(group.allgather([outs], [wire]))
    _count("all_gather", _nbytes(wire) * group.size(), tier)
    return torch.stack(outs).to(x.device)


def psum_tiered(x: torch.Tensor, group, axis: AxisName = None, *,
                hierarchical: bool = False) -> torch.Tensor:
    """The sum of integer ``x`` over ``group``'s ranks along ``axis``
    under the route the caller elected (a new tensor; see the module
    docstring).  ``hierarchical`` applies where there are two or more
    tiers."""
    if group is None or axis_size(group, axis) == 1:
        return x
    if x.is_floating_point():
        raise TypeError("psum_tiered sums integer tensors only: a float "
                        "sum depends on the order of the ranks")
    tiers, (flat_tier, flat_group) = _tiers(group, axis)
    hier = hierarchical and len(tiers) > 1
    _flight.note("collective.route", tiers=[t for t, _ in tiers],
                 hierarchical=hier, bytes=_nbytes(x))
    if hier:
        for tier, g in reversed(tiers):
            if g.size() > 1:
                x = _all_reduce(x, g, dist.ReduceOp.SUM, tier)
        return x
    return _all_reduce(x, flat_group, dist.ReduceOp.SUM, flat_tier)


def pmax_tiered(x: torch.Tensor, group, axis: AxisName = None
                ) -> torch.Tensor:
    """The max of ``x`` over ``group``'s ranks along ``axis`` (exact in
    any order: one all-reduce)."""
    if group is None or axis_size(group, axis) == 1:
        return x
    _, (tier, g) = _tiers(group, axis)
    return _all_reduce(x, g, dist.ReduceOp.MAX, tier)


def all_gather_tiered(x: torch.Tensor, group, axis: AxisName = None
                      ) -> torch.Tensor:
    """``[W, *x.shape]``: every rank's ``x`` (same shape on every rank)
    along ``axis``, in the linear rank order."""
    if group is None or axis_size(group, axis) == 1:
        return x[None]
    _, (tier, g) = _tiers(group, axis)
    return _all_gather(x, g, tier)


def all_gather_bytes(payload: bytes, group,
                     axis: AxisName = None) -> List[bytes]:
    """Every rank's byte payload (any length), in rank order: the
    lengths first, then the payloads padded to the longest (reference:
    Network::Allgather with per-rank block sizes, network.h:89-120)."""
    if group is None or axis_size(group, axis) == 1:
        return [payload]
    n = torch.tensor([len(payload)], dtype=torch.int64)
    lens = all_gather_tiered(n, group, axis).reshape(-1).tolist()
    buf = torch.zeros(max(lens), dtype=torch.uint8)
    if payload:
        buf[:len(payload)] = torch.frombuffer(bytearray(payload),
                                              dtype=torch.uint8)
    allb = all_gather_tiered(buf, group, axis)
    return [bytes(allb[r, :lens[r]].numpy().tobytes())
            for r in range(len(lens))]
