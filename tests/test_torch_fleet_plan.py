"""The serving fleet's planners on the port (lightgbm_tpu_torch.ops.planner
and fleet.topology) against the JAX package's.

The byte models differ on purpose: the port counts the tensors its
``DeviceForest`` holds on the card, the JAX package prices TPU tiles.
So the elections are held to the JAX package's under ONE shared cost
table (the JAX ``fleet_replica_bytes`` at ``accel=False``, set with
``monkeypatch`` in both packages and in both topology modules, which
import it by name), and the byte model is held to the tensors a CPU
``DeviceForest`` holds, exactly.
"""

import pytest

from lightgbm_tpu.fleet import topology as jtopology
from lightgbm_tpu.ops import planner as jplanner

import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch.fleet import quantize_forest
from lightgbm_tpu_torch.fleet import topology
from lightgbm_tpu_torch.ops import planner
from lightgbm_tpu_torch.predict import DeviceForest
from lightgbm_tpu_torch.testing import one_thread  # noqa: F401
from lightgbm_tpu_torch.testing import synthetic_model_text

F = 10
HEADROOM = jplanner.HEADROOM


_JAX_COST = jplanner.fleet_replica_bytes


def _shared_cost(m, accel=None):
    return _JAX_COST(m, accel=False)


@pytest.fixture
def shared_costs(monkeypatch):
    assert planner.HEADROOM == jplanner.HEADROOM
    for mod in (jplanner, jtopology, planner, topology):
        monkeypatch.setattr(mod, "fleet_replica_bytes", _shared_cost)


def _fleet_plan_fields(plan):
    return (tuple(tuple(m) for m in plan.models), plan.total_resident_bytes,
            plan.budget_bytes, plan.limit_bytes, plan.limit_source,
            plan.evicted, plan.pressure, plan.feasible, plan.summary())


def _fleet_cases():
    """tests/test_fleet.py's three planner cases (the first at an ample
    and at a hot-only budget): (shapes, budget)."""
    cost = _shared_cost
    hot_cold = [("hot", 100, 30, 31, F, 1, (8, 64), 4.0),
                ("cold", 100, 30, 31, F, 1, (8, 64), 1.0, 300.0)]
    fb, prog = cost(jplanner.FleetModelShape(*hot_cold[0]))
    hot_cost = fb + sum(prog.values())
    stale = [("stale", 100, 30, 31, F, 1, (8,), 4.0, 1e6),
             ("fresh", 100, 30, 31, F, 1, (8,), 1.0)]
    fb1, prog1 = cost(jplanner.FleetModelShape(*stale[1]))
    big = [("m", 200, 60, 61, F, 1, (8, 512, 4096), 1.0)]
    fbm, progm = cost(jplanner.FleetModelShape(*big[0]))
    return [
        (hot_cold, 1 << 30),
        (hot_cold, int((hot_cost + 512) / HEADROOM)),
        (stale, int((fb1 + prog1[8] + 512) / HEADROOM)),
        (big, int((fbm + progm[8] + progm[512] + 256) / HEADROOM)),
    ]


@pytest.mark.parametrize("case", range(4))
def test_plan_fleet_election_equals_the_jax_package(shared_costs, case):
    rows, budget = _fleet_cases()[case]
    jp = jplanner.plan_fleet([jplanner.FleetModelShape(*r) for r in rows],
                             budget_bytes=budget, accel=False)
    pp = planner.plan_fleet([planner.FleetModelShape(*r) for r in rows],
                            budget_bytes=budget)
    assert _fleet_plan_fields(pp) == _fleet_plan_fields(jp)
    assert pp.evicted == jp.evicted and pp.models[0].resident_buckets == \
        jp.models[0].resident_buckets


def _topo_shapes(pkg):
    return [
        pkg.FleetModelShape("hot", 100, 30, 31, F, buckets=(8, 64),
                            weight=8.0),
        pkg.FleetModelShape("warm", 100, 30, 31, F, buckets=(8, 64),
                            weight=2.0),
        pkg.FleetModelShape("cold", 100, 30, 31, F, buckets=(8, 64),
                            weight=1.0, age_s=300.0),
    ]


def _topo_devices(case):
    """tests/test_fleet_topology.py's three placement cases."""
    fb, prog = _shared_cost(_topo_shapes(jplanner)[0])
    one = fb + sum(prog.values())
    if case == "replicate":
        return [(i, 0, int(one * 1.5 / 0.9)) for i in range(4)]
    if case == "ample":
        return [(i, i // 2, 1 << 30) for i in range(4)]
    return [(0, 0, 1024)]


def _topo_fields(tp):
    return (tp.devices, tuple(tuple(p) for p in tp.placements),
            tp.replicas, tp.device_load_bytes, tp.budget_bytes,
            tp.unplaced, tp.feasible, tp.summary(),
            {d: _fleet_plan_fields(p) for d, p in tp.device_plans.items()})


@pytest.mark.parametrize("case", ["replicate", "ample", "unplaced"])
def test_plan_topology_election_equals_the_jax_package(shared_costs, case):
    devs = _topo_devices(case)
    jt = jtopology.plan_topology(
        _topo_shapes(jplanner), [jtopology.DeviceSpec(*d) for d in devs],
        accel=False)
    pt = topology.plan_topology(
        _topo_shapes(planner), [topology.DeviceSpec(*d) for d in devs])
    assert _topo_fields(pt) == _topo_fields(jt)
    if case == "replicate":
        assert len(pt.replicas["hot"]) > len(pt.replicas["cold"])
    if case == "unplaced":
        assert set(pt.unplaced) == {"hot", "warm", "cold"}


@pytest.mark.parametrize("n", range(1, 9))
def test_plan_devices_equals_the_jax_package(monkeypatch, n):
    monkeypatch.delenv("LGBM_TPU_NUM_SLICES", raising=False)
    monkeypatch.delenv("LGBM_TPU_SLICE_DEVICES", raising=False)
    got = topology.plan_devices(n, 1 << 20)
    want = jtopology.plan_devices(n, 1 << 20)
    assert [tuple(d) for d in got] == [tuple(d) for d in want]


def _forest(cat: bool):
    text = synthetic_model_text(F, 12, 15, seed=3,
                                cat_features=(2, 5) if cat else ())
    b = lt.Booster(model_str=text, device="cpu")
    return b._forest(0, 12)


def _tensor_bytes(dev) -> int:
    import torch
    return sum(t.numel() * t.element_size() for t in vars(dev).values()
               if isinstance(t, torch.Tensor))


@pytest.mark.parametrize("precision", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("cat", [False, True])
def test_forest_bytes_are_the_device_forests_tensors(precision, cat):
    forest = _forest(cat)
    assert forest.has_cat == cat
    if precision == "f32":
        dev = DeviceForest(forest, "cpu")
    else:
        dev = DeviceForest(quantize_forest(forest, precision), "cpu",
                           precision=precision, routing_only=True)
    T, I = forest.split_feature.shape
    want = planner.predict_forest_bytes(
        T, I, forest.leaf_value.shape[1], precision,
        forest.cat_words.size if forest.has_cat else 0,
        routing_only=precision != "f32")
    assert _tensor_bytes(dev) == want


def test_program_bytes_grow_with_the_bucket():
    for scores in (False, True):
        sizes = [planner.predict_program_bytes(100, b, F, num_class=3,
                                               emit_scores=scores)
                 for b in (8, 64, 1024)]
        assert sizes == sorted(sizes) and len(set(sizes)) == 3
    # scores mode adds the [K, n] scores to the [T, n] scratch
    assert planner.predict_program_bytes(100, 64, F, emit_scores=True) > \
        planner.predict_program_bytes(100, 64, F)


def test_low_precision_ladder_on_the_card_c24():
    """ROADMAP C-24: B1 reads bf16 and int8 planes widened to f32 and the
    plain planes stay beside the packed records, so on the card a
    routing-only int8 forest (codes, fix mask, f32 fix values) holds more
    than a bf16 one; the JAX package's ladder is f32 > bf16 > int8.  At
    higgs_500x255 (500 trees, 254 nodes, 255 leaves): 7,114,012,
    6,350,012 and 6,860,012 bytes."""
    f32 = planner.predict_forest_bytes(500, 254, 255, "f32")
    bf16 = planner.predict_forest_bytes(500, 254, 255, "bf16",
                                        routing_only=True)
    int8 = planner.predict_forest_bytes(500, 254, 255, "int8",
                                        routing_only=True)
    assert (f32, bf16, int8) == (7_114_012, 6_350_012, 6_860_012)
    assert f32 > int8 > bf16


def test_default_budget_is_the_device_and_the_ledger_is_unported():
    import torch
    shapes = [planner.FleetModelShape("m", 10, 7, 8, F, buckets=(8,))]
    plan = planner.plan_fleet(shapes, device="cpu")
    assert plan.limit_source == "none" and plan.feasible
    assert plan.budget_bytes == planner.NO_DEVICE_LIMIT
    with pytest.raises(NotImplementedError, match="A11"):
        planner.plan_fleet(shapes, ledger=object())
    with pytest.raises(NotImplementedError, match="A11"):
        topology.plan_topology(shapes, topology.plan_devices(2),
                               ledgers={0: object()})
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            planner.plan_fleet(shapes)
