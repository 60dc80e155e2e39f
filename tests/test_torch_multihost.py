"""The two-tier plane of sharded training in the port (tests/
test_multihost.py's cases on ``lightgbm_tpu_torch``): ranks are threads
of this process (``testing.thread_ranks``), each with its own gloo group,
and ``LGBM_TPU_NUM_SLICES`` splits them into simulated slices, as the JAX
package splits its 8 CPU devices.

- The meshes (``parallel.learners.make_hybrid_mesh``), the mesh plan's
  priority, warnings and refusals, and the two routes of
  ``psum_tiered``: the port's sums are exact integers, so flat and
  hierarchical give the same bits (the JAX package's pinned route, which
  fixes the order of float sums, has nothing to pin here), and the
  counts show each route's all-reduces per tier;
- ``ops.planner.plan_collectives``'s three cases on fake link rates;
- trained texts: quantized hierarchical and flat byte-identical, and so
  under ``LGBM_TPU_PINNED_REDUCE=1`` (which the port does not read), f32
  ones the serial text; hierarchical voting per slice with its plan,
  tier gauges and per-tier spans;
- the elastic loop: a membership probe that commits and one that fails
  on every survivor under seeded chaos, the shrunk plan, and a 4 x 2
  run's bundle resumed by its 2 x 2 survivors, equal to 2 x 2 from
  scratch;
- against the JAX package on its 8 CPU devices: quantized hybrid
  data-parallel at 2 x 4, per-slice voting (whose text differs from the
  port's flat voting) and the elastic shrunk run, each to equal trees
  with leaf values within ROADMAP C-3's tolerances;
- ``tools/torch_collective_probe.py``'s JSON, as tests/test_multihost.py
  holds ``tools/collective_probe.py``'s.

The comparisons against the JAX package and the elastic run train
tests/test_multihost.py's 15 leaves for 4 rounds (not 8); the
within-port cases, whose texts must be byte-identical, train 7 leaves
for 2 to 3 rounds, and 4 ranks where a case needs no 8 shards, to keep
the whole test run short.
"""

import json
import os
import threading

import numpy as np
import pytest
import torch

import lightgbm_tpu as lgb

import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch.obs.metrics import global_registry
from lightgbm_tpu_torch.obs.trace import global_tracer
from lightgbm_tpu_torch.ops.planner import plan_collectives
from lightgbm_tpu_torch.parallel import collectives, learners
from lightgbm_tpu_torch.parallel import network as net
from lightgbm_tpu_torch.parallel.collectives import (DCN_AXIS, HYBRID_AXES,
                                                     ICI_AXIS,
                                                     axis_index_flat,
                                                     axis_size, psum_tiered)
from lightgbm_tpu_torch.parallel.dist_data import make_fake_allgather
from lightgbm_tpu_torch.resilience import (ChaosRegistry, CheckpointManager,
                                           ResilienceConfig, SliceLostError,
                                           membership_probe,
                                           plan_shrunk_world,
                                           shrink_and_resume)
from lightgbm_tpu_torch.testing import thread_ranks
from lightgbm_tpu_torch.testing import one_thread  # noqa: F401

from test_torch_objectives import assert_same_trees
from test_torch_parallel import _vote_xy

RNG = np.random.RandomState(7)
# n not divisible by 8: every world pads differently
N, F = 1201, 10
X = RNG.randn(N, F).astype(np.float32)
Y = (X[:, 0] + 0.5 * X[:, 3] ** 2 + 0.1 * RNG.randn(N) > 0.5).astype(
    np.float32)
XV = RNG.randn(301, F).astype(np.float32)
YV = (XV[:, 0] + 0.5 * XV[:, 3] ** 2 > 0.5).astype(np.float32)

BASE = {"objective": "binary", "num_leaves": 7, "learning_rate": 0.1,
        "max_bin": 63, "min_data_in_leaf": 5, "verbosity": -1,
        "tree_learner": "data"}
QUANT = {"use_quantized_grad": True, "num_grad_quant_bins": 16}
ROUNDS = 3
ENV = ("LGBM_TPU_NUM_SLICES", "LGBM_TPU_SLICE_DEVICES",
       "LGBM_TPU_HIER_REDUCE", "LGBM_TPU_PINNED_REDUCE")


def _env(setenv, slices=0, per=0, hier=None, pinned=False):
    """The simulated topology and the route, through ``setenv(k, v)``
    (None unsets)."""
    setenv("LGBM_TPU_NUM_SLICES", str(slices) if slices else None)
    setenv("LGBM_TPU_SLICE_DEVICES", str(per) if per else None)
    setenv("LGBM_TPU_HIER_REDUCE", None if hier is None
           else "1" if hier else "0")
    setenv("LGBM_TPU_PINNED_REDUCE", "1" if pinned else None)


def _mp(monkeypatch):
    def setenv(k, v):
        if v is None:
            monkeypatch.delenv(k, raising=False)
        else:
            monkeypatch.setenv(k, v)
    return setenv


def _body(text: str) -> str:
    return text.partition("parameters:")[0]


def _ranks(world, params, rounds=ROUNDS, X_=X, Y_=Y, **kw):
    """``world`` thread ranks train ``params``; returns each rank's
    (booster, its thread's collective counts)."""
    def fn(rank, group):
        collectives.reset_op_counts()
        bst = lt.train(dict(params), lt.Dataset(X_, label=Y_, device="cpu"),
                       rounds, verbose_eval=False, **kw)
        return bst, dict(collectives.thread_op_counts())
    return thread_ranks(world, fn)


# ---------------------------------------------------------------- meshes


def test_make_hybrid_mesh_shapes_and_refusal(monkeypatch):
    """The two-tier meshes of 8 ranks: axes, shapes, a linear order that
    is the group's rank order (``axis_index_flat``), so electing a mesh
    never moves a row; a slice count that does not divide is refused,
    and so is a mesh plan that leaves ranks out (no rank drops out)."""
    _env(_mp(monkeypatch), slices=2, per=2)

    def fn(rank, group):
        out = {}
        for s in (2, 4):
            mesh = learners.make_hybrid_mesh(group, num_slices=s)
            assert learners.make_hybrid_mesh(group, num_slices=s) is mesh
            out[s] = (mesh.axis_names, dict(mesh.shape),
                      learners.data_axis_of(mesh),
                      axis_size(mesh, HYBRID_AXES),
                      axis_index_flat(mesh, HYBRID_AXES),
                      axis_index_flat(mesh, ICI_AXIS),
                      axis_index_flat(mesh, DCN_AXIS),
                      mesh.over(ICI_AXIS).group.size())
        with pytest.raises(ValueError, match="partition"):
            learners.make_hybrid_mesh(group, num_slices=3)
        with pytest.raises(ValueError, match="does not hold"):
            learners.make_hybrid_mesh(group)
        return out
    for rank, out in enumerate(thread_ranks(8, fn)):
        for s in (2, 4):
            names, shape, axis, size, flat, ici, dcn, ici_ranks = out[s]
            assert names == HYBRID_AXES and axis == HYBRID_AXES
            assert shape == {DCN_AXIS: s, ICI_AXIS: 8 // s} and size == 8
            assert flat == rank and ici_ranks == 8 // s
            assert (dcn, ici) == divmod(rank, 8 // s)
    assert learners.data_axis_of(None) is None


@pytest.mark.parametrize("slices", [2, 4])
def test_tiered_psum_matches_flat(slices):
    """Flat and hierarchical sums of int32 and int64 payloads are the
    same bits, the sum of every rank's; the counts show one all-reduce
    flat and one a tier hierarchical; the max and the gather run over
    every rank in linear order."""
    def fn(rank, group):
        mesh = learners.make_hybrid_mesh(group, num_slices=slices)
        xi = torch.arange(24, dtype=torch.int32) * (rank + 1) - 91
        xl = xi.to(torch.int64) * (1 << 40)
        out = {}
        for route, kw in (("flat", {}), ("hier", {"hierarchical": True})):
            collectives.reset_op_counts()
            out[route] = ([psum_tiered(x, mesh, **kw) for x in (xi, xl)],
                          {k: v for k, v in
                           collectives.thread_op_counts().items()
                           if "@" in k and not k.endswith("_bytes")})
        peak = collectives.pmax_tiered(torch.tensor([rank]), mesh)
        order = collectives.all_gather_tiered(torch.tensor([rank]), mesh)
        return out, int(peak), order.reshape(-1).tolist()
    want = sum(torch.arange(24, dtype=torch.int64) * (r + 1) - 91
               for r in range(8))
    for out, peak, order in thread_ranks(8, fn):
        for route in out:
            (si, sl), _ = out[route]
            assert si.dtype == torch.int32 and torch.equal(si.long(), want)
            assert torch.equal(sl, want * (1 << 40)), route
        assert out["flat"][1] == {"all_reduce@dcn+ici": 2}
        assert out["hier"][1] == {"all_reduce@ici": 2, "all_reduce@dcn": 2}
        assert peak == 7 and order == list(range(8))


# ------------------------------------------------------------ mesh plan


def test_mesh_plan_priority(monkeypatch):
    _env(_mp(monkeypatch))
    monkeypatch.setattr(net, "_LAST_INIT", None)
    flat = net.mesh_plan(8)
    assert (flat.num_slices, flat.total_shards, flat.hybrid) == (1, 8, False)
    assert flat.source == "flat"
    monkeypatch.setenv("LGBM_TPU_NUM_SLICES", "2")
    mp = net.mesh_plan(8)
    assert (mp.num_slices, mp.devices_per_slice, mp.source) == (2, 4, "env")
    # bounded by the ranks a slice: how an elastic shrink states the
    # survivors' world (the booster refuses a plan that is not its
    # group: no rank drops out)
    monkeypatch.setenv("LGBM_TPU_SLICE_DEVICES", "2")
    mp = net.mesh_plan(8)
    assert (mp.num_slices, mp.devices_per_slice, mp.total_shards) \
        == (2, 2, 4)
    monkeypatch.delenv("LGBM_TPU_NUM_SLICES")
    monkeypatch.delenv("LGBM_TPU_SLICE_DEVICES")
    mp = net.mesh_plan(8, num_machines=4)
    assert (mp.num_slices, mp.devices_per_slice, mp.source) \
        == (4, 2, "num_machines")
    # a num_machines that does not divide leaves the plan flat, every
    # rank in it (the JAX package caps its mesh at num_machines devices)
    mp = net.mesh_plan(8, num_machines=3)
    assert (mp.num_slices, mp.total_shards) == (1, 8)
    # the live topology first: one slice a host, over the env
    monkeypatch.setenv("LGBM_TPU_NUM_SLICES", "4")
    mp = net.mesh_plan(4, hosts=["a", "a", "b", "b"])
    assert (mp.num_slices, mp.devices_per_slice, mp.source) \
        == (2, 2, "distributed")
    # hosts that do not hold equal blocks of consecutive ranks: flat
    seen = []
    monkeypatch.setattr(net, "log_warning", seen.append)
    mp = net.mesh_plan(4, hosts=["a", "b", "a", "b"])
    assert (mp.num_slices, mp.source) == (1, "flat") and seen
    # simulated slices that cannot partition the ranks are refused, not
    # quietly flat
    monkeypatch.setenv("LGBM_TPU_NUM_SLICES", "3")
    with pytest.raises(ValueError, match="cannot partition the 4 ranks"):
        net.mesh_plan(4, hosts=["a"] * 4)
    monkeypatch.setenv("LGBM_TPU_NUM_SLICES", "2")
    monkeypatch.setenv("LGBM_TPU_SLICE_DEVICES", "4")
    with pytest.raises(ValueError, match="SLICE_DEVICES=4"):
        net.mesh_plan(4)
    monkeypatch.delenv("LGBM_TPU_NUM_SLICES")
    monkeypatch.delenv("LGBM_TPU_SLICE_DEVICES")
    # num_machines on ranks of one live host: flat, and it says so (the
    # slow tier it would model is not there)
    seen.clear()
    mp = net.mesh_plan(8, num_machines=4, hosts=["a"] * 8)
    assert (mp.num_slices, mp.total_shards, mp.source) == (1, 8, "flat")
    assert len(seen) == 1 and "one host" in seen[0]


def test_mesh_plan_mismatch_warns(monkeypatch):
    _env(_mp(monkeypatch), slices=2)
    seen = []
    monkeypatch.setattr(net, "log_warning", seen.append)
    mp = net.mesh_plan(8, num_machines=5, local_listen_port=12399)
    assert mp.num_slices == 2
    assert len(seen) == 1 and "num_machines=5 disagrees" in seen[0]
    assert "12399" in seen[0]


def test_init_network_roundtrips_into_mesh_plan(monkeypatch):
    """A single-machine init records itself (no group is started), and
    mesh_plan reads the recorded call where no num_machines is given."""
    _env(_mp(monkeypatch))
    net.init_network(machines="127.0.0.1:12400", num_machines=1,
                     local_listen_port=12400)
    rec = net.last_network_init()
    assert rec is not None and rec["num_machines"] == 1
    assert rec["local_listen_port"] == 12400
    net.free_network()
    assert net.last_network_init() is None
    monkeypatch.setattr(net, "_LAST_INIT",
                        {"num_machines": 4, "local_listen_port": 12401})
    mp = net.mesh_plan(8)
    assert (mp.num_slices, mp.source) == (4, "num_machines")


# -------------------------------------------------------- planner model


def test_plan_collectives_elects_hierarchical_on_slow_dcn():
    plan = plan_collectives(features=28, num_bins=64, num_slices=2,
                            devices_per_slice=4, ici_gbps=100.0,
                            dcn_gbps=5.0)
    assert plan.hierarchical and plan.elected == "hierarchical"
    assert plan.dcn_bytes == plan.payload_bytes
    assert plan.flat_dcn_bytes == plan.payload_bytes * 4
    s = plan.summary()
    assert s["mesh_shape"] == [2, 4] and s["hierarchy_elected"]


def test_plan_collectives_flat_cases(monkeypatch):
    _env(_mp(monkeypatch))
    p1 = plan_collectives(features=28, num_bins=64, num_slices=1,
                          devices_per_slice=8)
    assert not p1.hierarchical and p1.dcn_bytes == 0
    assert p1.elected == "flat"
    monkeypatch.setenv("LGBM_TPU_HIER_REDUCE", "0")
    p2 = plan_collectives(features=28, num_bins=64, num_slices=2,
                          devices_per_slice=4)
    assert not p2.hierarchical and p2.elected == "flat"
    assert p2.dcn_bytes == p2.flat_dcn_bytes


def test_plan_collectives_voting_shrinks_dcn(monkeypatch):
    _env(_mp(monkeypatch))
    kw = dict(features=28, num_bins=64, num_slices=2, devices_per_slice=4,
              ici_gbps=100.0, dcn_gbps=5.0)
    data = plan_collectives(**kw)
    vote = plan_collectives(voting_k=8, **kw)
    assert vote.elected == "hierarchical+voting"
    assert vote.dcn_bytes < data.dcn_bytes
    assert vote.ici_bytes == data.ici_bytes
    # int32 level histograms: two channels of 4 bytes against three of 8
    quant = plan_collectives(quant=True, **kw)
    assert quant.payload_bytes * 3 == data.payload_bytes


# ---------------------------------------------------------- trained texts


@pytest.mark.parametrize("payload", ["f32", "quant"])
def test_hierarchical_flat_and_pinned_texts(monkeypatch, payload):
    """On 2 x 2 thread ranks hierarchical and flat sums give one model
    text, byte for byte, quantized as in f32, and the f32 text is the
    serial one.  The sums are exact integers, so nothing needs pinning:
    the JAX package's ``LGBM_TPU_PINNED_REDUCE=1`` is not read by the
    port, and a run under it takes the same all-reduces to the same
    text."""
    setenv = _mp(monkeypatch)
    extra = QUANT if payload == "quant" else {}
    texts = {}
    for route, kw in (("hier", {"hier": True}), ("flat", {"hier": False}),
                      ("pinned", {"hier": True, "pinned": True})):
        _env(setenv, slices=2, **kw)
        out = _ranks(4, dict(BASE, **extra))
        plan = out[0][0].boosting.collective_plan
        assert plan.summary()["mesh_shape"] == [2, 2]
        assert plan.hierarchical == kw["hier"]
        counts = out[0][1]
        tiers = ("ici", "dcn") if kw["hier"] else ("dcn+ici",)
        for t in tiers:
            assert counts.get(f"all_reduce@{t}", 0) > 0, (route, t)
        assert "all_gather@ici" not in counts, route
        assert "all_gather@dcn" not in counts, route
        assert len({_body(b.model_to_string()) for b, _ in out}) == 1
        texts[route] = _body(out[0][0].model_to_string())
    assert texts["hier"] == texts["flat"] == texts["pinned"]
    if payload == "f32":
        _env(setenv)
        serial = {k: v for k, v in BASE.items() if k != "tree_learner"}
        want = lt.train(serial, lt.Dataset(X, label=Y, device="cpu"),
                        ROUNDS, verbose_eval=False)
        assert texts["flat"] == _body(want.model_to_string())


def test_hybrid_voting_plan_gauges_and_spans(monkeypatch):
    """Hierarchical voting on 2 x 2 ranks: the plan elects
    hierarchical+voting with fewer bytes over the slow tier than a whole
    histogram, the four tier gauges repeat the plan, and a traced run's
    collective.reduce spans name both tiers."""
    _env(_mp(monkeypatch), slices=2, hier=True)
    global_tracer.reset()
    global_tracer.enable()
    try:
        out = _ranks(4, dict(BASE, tree_learner="voting", top_k=6),
                     rounds=2)
        events = global_tracer.events()
    finally:
        global_tracer.disable()
        global_tracer.reset()
    b = out[0][0].boosting
    plan = b.collective_plan
    assert plan.voting_k == 6 and plan.elected == "hierarchical+voting"
    assert plan.dcn_bytes < plan.payload_bytes
    assert b.grower_cfg.num_slices == 2 and b.grower_cfg.hier_reduce
    gauges = global_registry.to_dict()["gauges"]
    assert int(gauges["train_ici_payload_bytes"]) == plan.ici_bytes
    assert int(gauges["train_dcn_payload_bytes"]) == plan.dcn_bytes
    assert int(gauges["train_num_slices"]) == 2
    assert int(gauges["train_hier_reduce"]) == 1
    tiers = {e["args"].get("tier") for e in events
             if e["name"] == "collective.reduce"}
    assert {DCN_AXIS, ICI_AXIS} <= tiers
    assert np.isfinite(out[0][0].predict(XV)).all()


# ------------------------------------------------------------- elastic


def _probe(world, chaos=None, timeout=2.0):
    fake = make_fake_allgather(world, timeout=timeout)
    out, errs = [None] * world, [None] * world

    def runner(k):
        try:
            ag = fake(k)
            if chaos is not None:
                ag = chaos.wrap_allgather(ag, k)
            out[k] = membership_probe(
                ag, world=world, rank=k,
                config=ResilienceConfig(deadline_s=1.5, max_retries=3,
                                        base_backoff_s=0.01))
        except Exception as e:      # noqa: BLE001 — asserted by the caller
            errs[k] = e
    ts = [threading.Thread(target=runner, args=(k,), daemon=True)
          for k in range(world)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(60)
    assert not any(t.is_alive() for t in ts), "a rank hung"
    return out, errs


def test_membership_probe_commits_and_detects_loss():
    out, errs = _probe(4)
    assert errs == [None] * 4
    assert all(o == [0, 1, 2, 3] for o in out)
    # seeded chaos stalls rank 2's transport for good: every survivor
    # raises SliceLostError instead of hanging
    dead = ",".join(f"allgather.stall@{i}:rank=2:sec=60" for i in range(40))
    out, errs = _probe(4, ChaosRegistry(dead, seed=3), timeout=0.4)
    assert all(isinstance(e, SliceLostError) for k, e in enumerate(errs)
               if k != 2), errs


def test_plan_shrunk_world():
    plan = plan_shrunk_world(4, 2, lost_slices=2)
    assert (plan.num_slices, plan.devices_per_slice, plan.total_shards) \
        == (2, 2, 4)
    assert plan.source == "elastic"
    with pytest.raises(SliceLostError):
        plan_shrunk_world(2, 4, lost_slices=2)


ELASTIC = dict(BASE, num_leaves=15, stochastic_rounding=False, **QUANT)
ELASTIC_FIRST, ELASTIC_ROUNDS = 2, 4


def _elastic_run(tmp_path, monkeypatch):
    """4 x 2 ranks train ``ELASTIC_FIRST`` rounds with a bundle every 2;
    a probe under chaos fails; the 2 x 2 survivors resume to
    ``ELASTIC_ROUNDS``.  Returns (the first run's evals, each survivor's
    (booster, evals, the 2 x 2 world's text from scratch), the
    directory)."""
    setenv = _mp(monkeypatch)
    _env(setenv, slices=4, per=2)

    def first(rank, group):
        ev = {}
        bst = lt.train(ELASTIC, lt.Dataset(X, label=Y, device="cpu"),
                       ELASTIC_FIRST, valid_sets=[lt.Dataset(
                           XV, label=YV, device="cpu")],
                       valid_names=["v"], evals_result=ev,
                       snapshot_freq=2, verbose_eval=False,
                       snapshot_out=str(tmp_path / f"r{rank}" / "m.txt"))
        assert bst.boosting.collective_plan.summary()["mesh_shape"] \
            == [4, 2]
        return ev
    ev1 = thread_ranks(8, first)[0]
    # the loss: rank 1's transport dies; the probe's verdict, shared by
    # every survivor, is the decision to shrink
    dead = ",".join(f"allgather.stall@{i}:rank=1:sec=60" for i in range(40))
    _, errs = _probe(4, ChaosRegistry(dead, seed=11), timeout=0.4)
    assert isinstance(errs[0], SliceLostError)

    def resume(rank, group):
        ev = {}
        bst = shrink_and_resume(
            ELASTIC, lt.Dataset(X, label=Y, device="cpu"),
            str(tmp_path / f"r{rank}" / "m.txt.ckpt"), num_slices=4,
            devices_per_slice=2, lost_slices=2,
            num_boost_round=ELASTIC_ROUNDS,
            valid_sets=[lt.Dataset(XV, label=YV, device="cpu")],
            valid_names=["v"], evals_result=ev, snapshot_freq=2,
            snapshot_out=str(tmp_path / f"s{rank}" / "m.txt"),
            verbose_eval=False)
        fresh = lt.train(ELASTIC, lt.Dataset(X, label=Y, device="cpu"),
                         ELASTIC_ROUNDS, verbose_eval=False)
        return bst, ev, _body(fresh.model_to_string())
    out = thread_ranks(4, resume)
    # the survivors' world is 4 ranks: another group size is refused
    with pytest.raises(ValueError, match="has 4 ranks"):
        thread_ranks(2, lambda r, g: shrink_and_resume(
            ELASTIC, lt.Dataset(X, label=Y, device="cpu"),
            str(tmp_path / "r0" / "m.txt.ckpt"), num_slices=4,
            devices_per_slice=2, lost_slices=2))
    return ev1, out, tmp_path


@pytest.fixture(scope="module")
def elastic(tmp_path_factory):
    mp = pytest.MonkeyPatch()
    try:
        yield _elastic_run(tmp_path_factory.mktemp("elastic"), mp)
    finally:
        mp.undo()


def test_elastic_shrink_resume_end_to_end(elastic):
    """The rejoin: the survivors' booster ends at ELASTIC_ROUNDS with the
    first run's evaluation history as its prefix, its new bundle names
    the re-planned 2 x 2 mesh, and its text is the 2 x 2 world's from
    scratch (deterministic rounding: the quantized run does not depend
    on the world)."""
    ev1, out, _ = elastic
    for bst, ev, fresh in out:
        assert bst.current_iteration() == ELASTIC_ROUNDS
        assert bst.boosting.collective_plan.summary()["mesh_shape"] \
            == [2, 2]
        h1, h2 = ev1["v"]["binary_logloss"], ev["v"]["binary_logloss"]
        assert len(h2) == ELASTIC_ROUNDS and h2[:ELASTIC_FIRST] == h1
        assert _body(bst.model_to_string()) == fresh
        assert np.isfinite(bst.predict(XV)).all()


def test_elastic_bundle_names_the_shrunk_mesh(elastic):
    """The survivors' newest bundle records the re-planned world: the
    collective plan's ``[2, 2]`` mesh and the row layout beside it."""
    *_, root = elastic
    ck = CheckpointManager(str(root / "s0" / "m.txt.ckpt")).latest_verified()
    assert ck.iteration == ELASTIC_ROUNDS
    cp = ck.manifest["collective_plan"]
    assert cp["mesh_shape"] == [2, 2] and cp["world"] == 4
    assert cp["rows"] == "contiguous"
    assert ck.manifest["hist_plan"] is not None


# ------------------------------------------------- against the JAX package

# tests/test_multihost.py's 15 leaves; 4 rounds of its 8 (each round
# more costs about 6 s of thread ranks here).  At top_k 6 of 16 the
# per-slice vote elects other features than the flat vote.
JAX_BASE = dict(BASE, num_leaves=15)
VOTE = dict(JAX_BASE, tree_learner="voting", top_k=6,
            tpu_tree_growth="serial")
JAX_ROUNDS = 4


def _jax_env(**kw):
    saved = {k: os.environ.get(k) for k in ENV}

    def setenv(k, v):
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v
    _env(setenv, **kw)
    return saved


def _restore_env(saved):
    for k, v in saved.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v


@pytest.fixture(scope="session")
def jax_hybrid():
    """The JAX package's runs on its 8 CPU devices: quantized data on
    2 x 4, hierarchical, per-slice voting on 2 x 4 (``VOTE``, the
    ``_vote_xy`` data), and the 2 x 2 world's deterministic quantized
    run the elastic survivors must reach."""
    import jax
    assert jax.device_count() >= 8, "conftest must give 8 CPU devices"
    out = {}
    Xv, yv = _vote_xy()
    for name, params, data, env, rounds in (
            ("data_quant", dict(JAX_BASE, **QUANT), (X, Y),
             dict(slices=2, hier=True), JAX_ROUNDS),
            ("voting", VOTE, (Xv, yv), dict(slices=2, hier=True),
             JAX_ROUNDS),
            ("elastic", ELASTIC, (X, Y), dict(slices=2, per=2),
             ELASTIC_ROUNDS)):
        saved = _jax_env(**env)
        try:
            bst = lgb.train(dict(params), lgb.Dataset(*data[:1],
                                                      label=data[1]),
                            rounds)
        finally:
            _restore_env(saved)
        assert bst.boosting.collective_plan.summary()["mesh_shape"] == (
            [2, 2] if name == "elastic" else [2, 4])
        out[name] = bst
    return out


def test_quant_hybrid_data_matches_the_jax_package(jax_hybrid, monkeypatch):
    """2 x 4 ranks, hierarchical, quantized with stochastic rounding
    (both packages fold the rank into the key): equal trees, leaf values
    within 1e-5 plus 1e-5 of the largest leaf."""
    _env(_mp(monkeypatch), slices=2, hier=True)
    out = _ranks(8, dict(JAX_BASE, **QUANT), rounds=JAX_ROUNDS)
    assert out[0][0].boosting.collective_plan.elected == "hierarchical"
    assert len({_body(b.model_to_string()) for b, _ in out}) == 1
    assert_same_trees(jax_hybrid["data_quant"], out[0][0], JAX_ROUNDS,
                      rtol=1e-5, atol=1e-5, atol_of_largest=1e-5)


def test_per_slice_voting_matches_the_jax_package(jax_hybrid, monkeypatch):
    """Hierarchical voting votes per slice: 2 x 2 thread ranks hold the
    rows the JAX package's 2 x 4 slices hold, so the trees are its trees
    (f32: leaf values to 1e-4, C-3); and the per-slice vote elects other
    features than the flat vote of 4 ranks, whose text differs."""
    setenv = _mp(monkeypatch)
    Xv, yv = _vote_xy()
    _env(setenv, slices=2, hier=True)
    per_slice = _ranks(4, VOTE, rounds=JAX_ROUNDS, X_=Xv, Y_=yv)
    assert per_slice[0][0].boosting.collective_plan.elected \
        == "hierarchical+voting"
    assert_same_trees(jax_hybrid["voting"], per_slice[0][0], JAX_ROUNDS)
    _env(setenv, slices=2, hier=False)
    flat = _ranks(4, VOTE, rounds=JAX_ROUNDS, X_=Xv, Y_=yv)
    assert flat[0][0].boosting.collective_plan.elected == "flat"
    assert _body(flat[0][0].model_to_string()) \
        != _body(per_slice[0][0].model_to_string())


def test_elastic_shrunk_run_matches_the_jax_package(jax_hybrid, elastic):
    """The survivors' resumed booster against the JAX package's 2 x 2
    run (which its own elastic test holds equal to its shrunk resume):
    equal trees, quantized tolerances."""
    _, out, _ = elastic
    assert_same_trees(jax_hybrid["elastic"], out[0][0], ELASTIC_ROUNDS,
                      rtol=1e-5, atol=1e-5, atol_of_largest=1e-5)


# ---------------------------------------------------------------- probe


def test_collective_probe_json():
    from lightgbm_tpu_torch.tools.torch_collective_probe import run_probe
    out = run_probe(rows=4096, features=8, max_bin=31, world=8,
                    num_slices=2, top_k=4, reps=1, device="cpu")
    assert out["mesh_shape"] == [2, 4]
    for payload in ("f32", "quant"):
        sec = out[payload]
        assert sec["voting_dcn_below_data"]
        assert sec["voting_parallel"]["dcn_bytes"] \
            < sec["data_parallel"]["dcn_bytes"]
        assert sec["data_parallel"]["dcn_bytes_total"] > 0
    assert out["quant"]["payload_bytes"] < out["f32"]["payload_bytes"]
    assert {"hierarchy_elected", "ici_bytes", "dcn_bytes",
            "voting_k"} <= out.keys()
    json.dumps(out)
