"""Multi-device serving topology: replicate hot models for throughput,
partition the cold tail for capacity (counterpart of
``lightgbm_tpu/fleet/topology.py``).

``plan_topology`` grows ``ops.planner.plan_fleet`` into a placement
planner: which device hosts which replica of which model.

* **devices** come from the mesh-plan seam
  (``parallel.network.mesh_plan``): on one host every device is in
  slice 0 unless ``LGBM_TPU_NUM_SLICES`` simulates slices, and the
  router's same-slice-first order is device-local-first.
* **placement** is a two-pass greedy election charged with the same
  per-replica cost the one-card residency election uses
  (``ops.planner.fleet_replica_bytes``).  Pass 1 partitions: every
  model, hottest first (``weight / (1 + age_s)``), gets its primary
  replica on the least-loaded device that admits it.  Pass 2
  replicates: while devices have room, the model with the highest
  marginal heat (priority / replica count) gains a replica on a device
  not yet hosting it.
* **per-device residency** is then ``plan_fleet`` run on each device's
  replicas against its own budget.

Replicas serve bit-identical raw scores (same forest, same program), so
the router's hedges and failover re-dispatch never change an answer.
A device's budget defaults to the card's (``ops.planner.
fleet_limit_bytes`` of the caller's ``device``); the devices of a
``PodFleet`` are logical devices on that one backend.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Tuple

from ..ops.planner import (HEADROOM, FleetPlan, fleet_limit_bytes,
                           fleet_replica_bytes, plan_fleet)


class DeviceSpec(NamedTuple):
    """One serving device of the pod: its id, the slice it lives in (the
    same slice is local, another slice a slower crossing), and its memory
    budget (None = the card's limit)."""

    device_id: int
    slice_id: int
    hbm_budget_bytes: Optional[int] = None


def plan_devices(n_devices: int,
                 budget_bytes_per_device: Optional[int] = None
                 ) -> Tuple[DeviceSpec, ...]:
    """Describe ``n_devices`` serving devices through the mesh-plan seam
    (``parallel.network.mesh_plan``): device ``i`` belongs to slice
    ``i // devices_per_slice``, the row-major order of the two-tier
    mesh."""
    from ..parallel.network import mesh_plan
    n = max(int(n_devices), 1)
    mp = mesh_plan(n)
    per = max(int(mp.devices_per_slice), 1) if mp.hybrid else n
    return tuple(DeviceSpec(i, i // per, budget_bytes_per_device)
                 for i in range(n))


class ReplicaPlacement(NamedTuple):
    """One (model, device) replica assignment."""

    name: str
    device_id: int
    primary: bool               # the model's home replica (pass 1)


class TopologyPlan(NamedTuple):
    """Placement verdict for a multi-device serving fleet.

    ``feasible`` means every model won at least one replica; an
    unplaced model is NOT unservable — the router degrades it to the
    bit-identical host path — but it is a capacity signal the operator
    should see.  ``device_plans`` carries each device's own
    ``FleetPlan`` residency election over exactly the replicas placed
    there."""

    devices: Tuple[DeviceSpec, ...]
    placements: Tuple[ReplicaPlacement, ...]
    replicas: Dict[str, Tuple[int, ...]]    # name -> device ids, primary 1st
    device_plans: Dict[int, FleetPlan]      # device_id -> residency plan
    device_load_bytes: Dict[int, int]       # placed replica bytes
    budget_bytes: int                       # per-device budget (headroomed)
    unplaced: Tuple[str, ...]
    feasible: bool

    def summary(self) -> dict:
        """JSON-friendly form for bench journals / flight fingerprints."""
        return {
            "devices": [
                {"device": d.device_id, "slice": d.slice_id,
                 "load_bytes": self.device_load_bytes.get(d.device_id, 0),
                 "models": sorted(p.name for p in self.placements
                                  if p.device_id == d.device_id)}
                for d in self.devices
            ],
            "replicas": {n: list(ids)
                         for n, ids in sorted(self.replicas.items())},
            "budget_bytes": self.budget_bytes,
            "unplaced": list(self.unplaced),
            "feasible": self.feasible,
        }


def plan_topology(models, devices, accel: Optional[bool] = None,
                  max_replicas: Optional[int] = None,
                  ledgers: Optional[dict] = None,
                  device=None) -> TopologyPlan:
    """Elect replica placement for ``models`` (``FleetModelShape`` list)
    over ``devices`` (``DeviceSpec`` list) — module docstring for the
    election; deterministic for identical inputs (ties break on the
    lower device id / earlier model).

    ``device`` is the backend whose limit a spec without a budget gets
    (None: the CUDA card).  ``ledgers`` (the JAX package's co-residency
    ledgers) are not ported."""
    if ledgers:
        raise NotImplementedError(
            "plan_topology(ledgers=): the residency ledger is not ported "
            "to lightgbm_tpu_torch yet; it waits for ROADMAP queue A11 "
            "(residency ledger)")
    models = list(models)
    devices = tuple(sorted(devices, key=lambda d: d.device_id))
    if not devices:
        raise ValueError("plan_topology needs at least one device")
    cap = min(max_replicas or len(devices), len(devices))

    default_limit = None
    limits: Dict[int, int] = {}
    budgets: Dict[int, int] = {}
    for d in devices:
        limit = d.hbm_budget_bytes
        if limit is None:
            if default_limit is None:
                default_limit = fleet_limit_bytes(device)[0]
            limit = default_limit
        # plan_fleet applies HEADROOM to the RAW limit itself: hand it
        # the same limit (not budget/HEADROOM, whose int round-trip can
        # land a byte short) so the placement admission and the
        # per-device residency election can never disagree
        limits[d.device_id] = int(limit)
        budgets[d.device_id] = int(limit * HEADROOM)

    costs = {}          # name -> (admit_bytes, load_bytes)
    prio = {}
    for m in models:
        fb, prog = fleet_replica_bytes(m, accel)
        costs[m.name] = (fb + prog[min(prog)], fb + sum(prog.values()))
        prio[m.name] = m.weight / (1.0 + max(m.age_s, 0.0))

    load: Dict[int, int] = {d.device_id: 0 for d in devices}
    hosted: Dict[int, set] = {d.device_id: set() for d in devices}
    placements: List[ReplicaPlacement] = []
    replicas: Dict[str, List[int]] = {m.name: [] for m in models}

    def admit(name: str, primary: bool) -> bool:
        """Least-loaded device not hosting ``name`` that fits one more
        replica; False when none admits."""
        admit_b, load_b = costs[name]
        cands = [d.device_id for d in devices
                 if name not in hosted[d.device_id]
                 and load[d.device_id] + admit_b <= budgets[d.device_id]]
        if not cands:
            return False
        did = min(cands, key=lambda i: (load[i], i))
        load[did] += min(load_b, budgets[did] - load[did])
        hosted[did].add(name)
        placements.append(ReplicaPlacement(name, did, primary))
        replicas[name].append(did)
        return True

    # pass 1 — partition: primaries, hottest first
    order = sorted(range(len(models)),
                   key=lambda i: (-prio[models[i].name], i))
    unplaced = []
    for i in order:
        if not admit(models[i].name, primary=True):
            unplaced.append(models[i].name)

    # pass 2 — replicate by marginal heat until nothing more fits
    while True:
        cands = [(prio[m.name] / len(replicas[m.name]), -i, m.name)
                 for i, m in enumerate(models)
                 if 0 < len(replicas[m.name]) < cap]
        placed_one = False
        for _heat, _i, name in sorted(cands, reverse=True):
            if admit(name, primary=False):
                placed_one = True
                break
        if not placed_one:
            break

    shapes = {m.name: m for m in models}
    device_plans = {}
    for d in devices:
        placed = [shapes[p.name] for p in placements
                  if p.device_id == d.device_id]
        device_plans[d.device_id] = plan_fleet(
            placed, budget_bytes=limits[d.device_id], accel=accel)

    return TopologyPlan(
        devices=devices, placements=tuple(placements),
        replicas={n: tuple(ids) for n, ids in replicas.items()},
        device_plans=device_plans, device_load_bytes=dict(load),
        budget_bytes=max(budgets.values()),
        unplaced=tuple(unplaced), feasible=not unplaced)
