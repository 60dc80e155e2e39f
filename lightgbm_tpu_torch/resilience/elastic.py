"""Elastic shrink-and-resume after a lost slice (counterpart of
``lightgbm_tpu/resilience/elastic.py``).

Training on capacity that can be taken away loses slices mid-run; the
reference's socket ``Network`` would wait forever.  Four steps close the
loop:

1. **detect**: a lost slice surfaces as ``resilient_allgather``'s
   ``CollectiveError``, which every surviving rank raises within the
   deadline instead of hanging (``retry.py``);
2. **agree**: ``membership_probe`` runs a liveness all-gather (8-byte
   rank stamps through the same CRC framing and verdict round) over a
   candidate world.  A committed round is the agreement: every listed
   rank saw every other's stamp and voted ok.  A consistent failure
   (``SliceLostError`` on every survivor) means the world still holds a
   dead member;
3. **re-plan**: ``plan_shrunk_world`` keeps each slice's ranks and drops
   the lost slices (a ``parallel.network.MeshPlan``), and
   ``apply_world`` states it through ``LGBM_TPU_NUM_SLICES`` /
   ``LGBM_TPU_SLICE_DEVICES``, which ``mesh_plan`` reads;
4. **resume**: the survivors build a fresh process group among
   themselves (the port's world is the current group,
   ``parallel.network.current_group``), and ``shrink_and_resume`` trains
   in it from the newest verified bundle (``resume_from``):
   ``GBDT.restore_state`` re-tiles the global state into the smaller
   world's layout, and the evaluation history and early stopping ride
   the bundle's callback states.

The port's sums are exact integers, so a shrunk f32 run is the run a
fresh small world would train from scratch, byte for byte, and so is a
quantized one with ``stochastic_rounding=false``.  Stochastic rounding
folds the rank into its key and draws at the rank's block size, so a
quantized stochastic run depends on the world by design.
"""

from __future__ import annotations

import struct
from typing import Callable, List, Optional

from ..utils.log import log_info, log_warning
from .retry import CollectiveError, ResilienceConfig, resilient_allgather

_STAMP = struct.Struct("<4sI")
_MAGIC = b"LGEL"


class SliceLostError(RuntimeError):
    """The candidate world cannot commit a membership round: at least one
    member is gone.  ``world`` carries the candidate that failed."""

    def __init__(self, world: int, reason: str):
        super().__init__(
            f"membership probe failed for world={world}: {reason}; "
            "shrink the world and re-probe")
        self.world = world


def membership_probe(allgather_bytes: Callable[[bytes], List[bytes]],
                     *, world: int, rank: int,
                     config: Optional[ResilienceConfig] = None,
                     metrics=None) -> List[int]:
    """A liveness round over a candidate ``world`` that every rank agrees
    on: each rank all-gathers an 8-byte stamp through
    ``resilient_allgather`` (``allgather_bytes``: for instance
    ``lambda p: parallel.collectives.all_gather_bytes(p, group)``).  On
    commit, returns the sorted member ranks; on a consistent abort
    raises ``SliceLostError`` (after a flight-recorder bundle), and the
    caller shrinks the world and probes again over a fresh transport."""
    cfg = config or ResilienceConfig(deadline_s=10.0, max_retries=2)
    from ..obs.flight import global_flight
    try:
        # the SliceLostError bundle below is the forensic record: one
        # event dumps once
        parts = resilient_allgather(
            _STAMP.pack(_MAGIC, rank), allgather_bytes, world=world,
            rank=rank, config=cfg, label="membership_probe",
            metrics=metrics, flight_dump=False)
    except CollectiveError as e:
        err = SliceLostError(world, str(e))
        global_flight.on_exception("elastic.membership", err)
        raise err from e
    members = []
    for p in parts:
        if len(p) != _STAMP.size or p[:4] != _MAGIC:
            err = SliceLostError(world, f"malformed member stamp {p!r}")
            global_flight.on_exception("elastic.membership", err)
            raise err
        members.append(int(_STAMP.unpack(p)[1]))
    return sorted(members)


def plan_shrunk_world(num_slices: int, devices_per_slice: int,
                      lost_slices: int):
    """The world after ``lost_slices`` slices are gone: the survivors
    keep their ranks a slice (a slice is a host: its links are
    physical), only the slice count shrinks.  Returns a ``parallel.
    network.MeshPlan``; raises ``SliceLostError`` when nothing
    survives."""
    from ..parallel.network import MeshPlan
    s = max(int(num_slices), 1) - max(int(lost_slices), 0)
    if s < 1:
        raise SliceLostError(int(num_slices),
                             f"all {num_slices} slices lost")
    d = max(int(devices_per_slice), 1)
    return MeshPlan(s, d, s * d, "elastic")


def apply_world(plan) -> None:
    """State a (shrunk) world through the mesh plan's seam: sets
    ``LGBM_TPU_NUM_SLICES`` and ``LGBM_TPU_SLICE_DEVICES``, so the next
    booster built (``parallel.network.mesh_plan``) takes the plan's
    two-tier mesh.  Across hosts the live topology wins over them."""
    import os
    os.environ["LGBM_TPU_NUM_SLICES"] = str(int(plan.num_slices))
    os.environ["LGBM_TPU_SLICE_DEVICES"] = str(int(plan.devices_per_slice))
    log_info(
        f"elastic: world re-planned to {plan.num_slices} slice(s) x "
        f"{plan.devices_per_slice} rank(s) = {plan.total_shards} shards "
        f"(source={plan.source})")


def shrink_and_resume(params: dict, train_set, ckpt_dir: str,
                      *, num_slices: int, devices_per_slice: int,
                      lost_slices: int = 1, num_boost_round: int = 100,
                      **train_kw):
    """The survivor's one call: re-plan the world, then resume from the
    newest verified bundle in ``ckpt_dir`` in the current process group
    (``parallel.network.current_group``, which the survivors have
    rebuilt among themselves); returns the resumed Booster.  Raises a
    ``ValueError`` naming both sizes where that group's ranks are not
    the re-planned world's.  Keyword arguments go to ``lt.train``
    (valid sets, callbacks, ``snapshot_freq`` to keep checkpointing)."""
    from ..parallel.collectives import axis_size
    from ..parallel.network import current_group
    plan = plan_shrunk_world(num_slices, devices_per_slice, lost_slices)
    have = axis_size(current_group())
    if have != plan.total_shards:
        raise ValueError(
            f"elastic: the shrunk world has {plan.total_shards} ranks "
            f"({plan.num_slices} slice(s) x {plan.devices_per_slice}), "
            f"but the current process group has {have}: rebuild the group "
            "among the survivors (parallel.network.new_group) and train "
            "inside it (use_group, or the default group)")
    log_warning(
        f"elastic: {lost_slices} slice(s) lost from a "
        f"{num_slices}x{devices_per_slice} world; resuming from the "
        f"latest verified bundle in {ckpt_dir!r} on the shrunk "
        f"{plan.num_slices}x{plan.devices_per_slice} mesh")
    apply_world(plan)
    from ..engine import train as _train
    return _train(params, train_set, num_boost_round=num_boost_round,
                  resume_from=ckpt_dir, **train_kw)
