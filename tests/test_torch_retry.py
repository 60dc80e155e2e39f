"""The port's resilient all-gather (``lightgbm_tpu_torch.resilience.retry``)
and the distributed Dataset's ``resilience=`` (``parallel/dist_data.py``)
under the port's seeded fault schedules, mirroring tests/test_chaos.py's
transport, bin-mapper, config and file-system cases (the two stress
cases stay ``slow``), and tests/test_obs.py's retry spans.  The bin
mappers under a fault schedule equal the JAX package's under the same
schedule."""

import threading
import time

import numpy as np
import pytest

from lightgbm_tpu.parallel.dist_data import (
    distributed_bin_mappers as jdistributed_bin_mappers,
    make_fake_allgather as jmake_fake_allgather)
from lightgbm_tpu.resilience import (ChaosRegistry as JChaosRegistry,
                                     ResilienceConfig as JResilienceConfig)

import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch.obs import global_tracer
from lightgbm_tpu_torch.parallel.dist_data import (distributed_bin_mappers,
                                                   make_fake_allgather)
from lightgbm_tpu_torch.resilience import (ChaosRegistry, CheckpointManager,
                                           CollectiveError, ResilienceConfig,
                                           resilient_allgather)
from lightgbm_tpu_torch.testing import one_thread  # noqa: F401

pytestmark = pytest.mark.chaos

WORLD = 4
CFG = ResilienceConfig(deadline_s=20.0, max_retries=5, base_backoff_s=0.01)


def _run_ranks(fn, world=WORLD, join_s=120):
    """fn(rank) on one thread per rank; returns (results, errors)."""
    out, errs = [None] * world, [None] * world

    def runner(k):
        try:
            out[k] = fn(k)
        except Exception as e:  # noqa: BLE001 — asserted by callers
            errs[k] = e

    threads = [threading.Thread(target=runner, args=(k,))
               for k in range(world)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(join_s)
    assert not any(t.is_alive() for t in threads), "a rank is HUNG"
    return out, errs


def _gather(chaos=None, cfg=CFG, mesh_timeout=2.0, world=WORLD):
    fake = make_fake_allgather(world, timeout=mesh_timeout)

    def fn(k):
        ag = fake(k)
        if chaos is not None:
            ag = chaos.wrap_allgather(ag, k)
        return resilient_allgather(f"rank{k}".encode(), ag, world=world,
                                   rank=k, config=cfg)

    return _run_ranks(fn, world)


EXPECT = [f"rank{k}".encode() for k in range(WORLD)]


def test_clean_transport_single_attempt():
    out, errs = _gather()
    assert errs == [None] * WORLD
    assert all(o == EXPECT for o in out)


@pytest.mark.parametrize("kind", ["bitflip", "truncate", "drop"])
def test_send_faults_recover_after_retry(kind):
    chaos = ChaosRegistry(f"allgather.{kind}@0:rank=1", seed=0)
    out, errs = _gather(chaos)
    assert errs == [None] * WORLD
    assert all(o == EXPECT for o in out), \
        "a rank consumed a corrupted payload"
    assert chaos.log == [f"allgather[1].{kind}@0"]


def test_recv_corruption_forces_rank_consistent_retry():
    chaos = ChaosRegistry("allgather.recv_bitflip@0:rank=3", seed=0)
    out, errs = _gather(chaos)
    assert errs == [None] * WORLD
    assert all(o == EXPECT for o in out)


def test_delay_fault_is_transparent():
    chaos = ChaosRegistry("allgather.delay@0:sec=0.05", seed=0)
    out, errs = _gather(chaos)
    assert errs == [None] * WORLD
    assert all(o == EXPECT for o in out)


def test_stall_aborts_consistently_within_deadline():
    chaos = ChaosRegistry("allgather.stall@0:rank=0:sec=60", seed=0)
    cfg = ResilienceConfig(deadline_s=2.5, max_retries=10,
                           base_backoff_s=0.01)
    t0 = time.monotonic()
    out, errs = _gather(chaos, cfg=cfg, mesh_timeout=0.4)
    elapsed = time.monotonic() - t0
    assert all(isinstance(e, CollectiveError) for e in errs), errs
    assert elapsed < cfg.deadline_s + 8.0, "abort was not deadline-bounded"


def test_allgather_retry_spans_under_chaos():
    """tests/test_obs.py's case: an injected fault surfaces as retried
    ``allgather.attempt`` spans."""
    chaos = ChaosRegistry("allgather.bitflip@0:rank=1", seed=0)
    global_tracer.reset()
    global_tracer.enable()
    try:
        out, errs = _gather(chaos)
        assert errs == [None] * WORLD
        atts = [e for e in global_tracer.events()
                if e["name"] == "allgather.attempt"]
        assert atts, "no allgather.attempt spans recorded"
        assert any(not a["args"]["committed"] for a in atts)
        assert any(a["args"]["committed"] and a["args"]["attempt"] >= 1
                   for a in atts)
    finally:
        global_tracer.disable()
        global_tracer.reset()


# --------------------------------------------------------- bin mappers


def _bin_data():
    rng = np.random.RandomState(0)
    X = rng.rand(2000, 5)
    bounds = np.linspace(0, len(X), WORLD + 1).astype(int)
    return X, bounds


SCHEDULE = ("allgather.bitflip@0:rank=0,allgather.truncate@4:rank=2,"
            "allgather.drop@2:rank=3")


def _run_mappers(chaos, cfg, mesh_timeout=2.0, jax=False):
    X, bounds = _bin_data()
    fake = (jmake_fake_allgather if jax else make_fake_allgather)(
        WORLD, timeout=mesh_timeout)
    binner = jdistributed_bin_mappers if jax else distributed_bin_mappers

    def fn(k):
        ag = fake(k)
        if chaos is not None:
            ag = chaos.wrap_allgather(ag, k)
        return binner(X[bounds[k]:bounds[k + 1]], params={}, rank=k,
                      world=WORLD, allgather_bytes=ag, resilience=cfg)

    return _run_ranks(fn)


def _assert_mappers_equal(a, b):
    assert len(a[0]) == len(b[0])
    for m, n in zip(a[0], b[0]):
        assert m.num_bin == n.num_bin
        np.testing.assert_array_equal(m.bin_upper_bound, n.bin_upper_bound)


@pytest.fixture(scope="module")
def jax_faulted():
    chaos = JChaosRegistry(SCHEDULE, seed=0)
    out, errs = _run_mappers(chaos, JResilienceConfig(
        deadline_s=20.0, max_retries=5, base_backoff_s=0.01), jax=True)
    assert errs == [None] * WORLD
    return out, list(chaos.log)


def test_bin_mappers_complete_under_faults(jax_faulted):
    clean, errs = _run_mappers(None, None)
    assert errs == [None] * WORLD
    chaos = ChaosRegistry(SCHEDULE, seed=0)
    faulted, errs = _run_mappers(chaos, CFG)
    assert errs == [None] * WORLD
    for r in range(WORLD):
        _assert_mappers_equal(faulted[r], clean[0])
        assert faulted[r][2] == clean[0][2]    # total_sample_cnt
        # the JAX package's mappers under the same schedule
        _assert_mappers_equal(faulted[r], jax_faulted[0][r])
        assert faulted[r][2] == jax_faulted[0][r][2]
        for f in faulted[r][1]:
            np.testing.assert_array_equal(faulted[r][1][f],
                                          jax_faulted[0][r][1][f])
    assert len(chaos.log) == 3
    assert sorted(chaos.log) == sorted(jax_faulted[1])


def test_bin_mappers_dead_transport_aborts_all_ranks():
    dead = ",".join(f"allgather.stall@{i}:rank=1:sec=60" for i in range(50))
    cfg = ResilienceConfig(deadline_s=3.0, max_retries=30,
                           base_backoff_s=0.01)
    t0 = time.monotonic()
    _, errs = _run_mappers(ChaosRegistry(dead, seed=0), cfg,
                           mesh_timeout=0.4)
    assert all(isinstance(e, CollectiveError) for e in errs), errs
    assert time.monotonic() - t0 < cfg.deadline_s + 10.0


def test_bin_mappers_degraded_fallback_is_loud_and_completes():
    dead = ",".join(f"allgather.stall@{i}:rank=1:sec=60" for i in range(50))
    cfg = ResilienceConfig(deadline_s=3.0, max_retries=30,
                           base_backoff_s=0.01, degraded_fallback=True)
    out, errs = _run_mappers(ChaosRegistry(dead, seed=0), cfg,
                             mesh_timeout=0.4)
    assert errs == [None] * WORLD
    assert all(len(o[0]) == 5 for o in out)    # every rank got mappers


def test_network_resilience_param_wraps_the_transport():
    """``params['network_resilience']`` alone turns the retries on."""
    X, bounds = _bin_data()
    fake = make_fake_allgather(WORLD, timeout=2.0)
    chaos = ChaosRegistry("allgather.bitflip@0:rank=2", seed=0)
    params = {"network_resilience": True, "network_deadline": 20.0,
              "network_backoff": 0.01}

    def fn(k):
        return distributed_bin_mappers(
            X[bounds[k]:bounds[k + 1]], params=params, rank=k, world=WORLD,
            allgather_bytes=chaos.wrap_allgather(fake(k), k))

    out, errs = _run_ranks(fn)
    assert errs == [None] * WORLD
    for r in range(1, WORLD):
        _assert_mappers_equal(out[r], out[0])


def test_resilience_config_from_params():
    assert ResilienceConfig.from_params({}) is None
    for params in ({"network_resilience": True, "network_deadline": 7.5,
                    "network_retries": 2,
                    "network_degraded_fallback": True},
                   {"network_resilience": True, "data_random_seed": 9},
                   {"network_resilience": False}):
        got = ResilienceConfig.from_params(params)
        want = JResilienceConfig.from_params(params)
        assert (got is None) == (want is None)
        if got is not None:
            assert vars(got) == vars(want)
    cfg = ResilienceConfig.from_params(
        {"network_resilience": True, "network_deadline": 7.5,
         "network_retries": 2, "network_degraded_fallback": True})
    assert cfg.deadline_s == 7.5 and cfg.max_retries == 2
    assert cfg.degraded_fallback


# ----------------------------------------------------------- fs faults


def _booster(rounds=4, n=300, f=5, **extra):
    rng = np.random.RandomState(0)
    X = rng.rand(n, f)
    y = (X[:, 0] > 0.5).astype(np.float32)
    params = {"objective": "binary", "num_leaves": 7, "verbosity": -1,
              "min_data_in_leaf": 5, **extra}
    return X, y, params, lt.train(params, lt.Dataset(X, label=y,
                                                     device="cpu"),
                                  rounds, verbose_eval=False)


def test_fs_transient_and_partial_write(tmp_path):
    _, _, _, bst = _booster()
    chaos = ChaosRegistry("fs.transient@0", seed=0)
    chaos.install_filesystem("chaos")
    try:
        mgr = CheckpointManager(f"chaos://{tmp_path}/ck", keep_last=3)
        with pytest.raises(OSError):
            mgr.save(bst, 2)            # the transient error surfaces
        mgr.save(bst, 2)                # the retry succeeds
        mgr.save(bst, 4)
        assert mgr.latest_verified().iteration == 4
    finally:
        chaos.uninstall_filesystem()
    # a silent partial write of the newest bundle is caught by the
    # manifest, and the previous good bundle is used
    chaos = ChaosRegistry("fs.partial@0", seed=0)
    chaos.install_filesystem("chaos")
    try:
        mgr = CheckpointManager(f"chaos://{tmp_path}/ck", keep_last=3)
        mgr.save(bst, 6)
        assert mgr.latest_verified().iteration == 4
    finally:
        chaos.uninstall_filesystem()


def test_fs_enospc_leaves_prior_state_intact(tmp_path):
    _, _, _, bst = _booster()
    chaos = ChaosRegistry("fs.enospc@2", seed=0)
    chaos.install_filesystem("chaos")
    try:
        mgr = CheckpointManager(f"chaos://{tmp_path}/ck2", keep_last=3)
        mgr.save(bst, 2)                # ops 0-1 (bundle + index) ok ...
        with pytest.raises(OSError):    # ... op 2, the next bundle, ENOSPC
            mgr.save(bst, 4)
        assert mgr.latest_verified().iteration == 2
    finally:
        chaos.uninstall_filesystem()


# -------------------------------------------------------- slow stress


@pytest.mark.slow
def test_stress_random_faults_never_corrupt():
    spray = ",".join(
        f"allgather.bitflip@{i}:rank={i % WORLD}:prob=0.3" for i in range(60))
    chaos = ChaosRegistry(spray, seed=7)
    fake = make_fake_allgather(WORLD, timeout=2.0)
    cfg = ResilienceConfig(deadline_s=30.0, max_retries=8,
                           base_backoff_s=0.005)

    def fn(k):
        ag = chaos.wrap_allgather(fake(k), k)
        return [resilient_allgather(f"r{k}i{i}".encode(), ag, world=WORLD,
                                    rank=k, config=cfg) for i in range(6)]

    out, errs = _run_ranks(fn, join_s=240)
    assert errs == [None] * WORLD
    for k in range(WORLD):
        for i, got in enumerate(out[k]):
            assert got == [f"r{q}i{i}".encode() for q in range(WORLD)]


@pytest.mark.slow
def test_stress_checkpoint_chaos_train_resume(tmp_path):
    """Train under a partial-write fault, then resume from the newest
    verified bundle to the byte-identical final model."""
    rng = np.random.RandomState(1)
    X = rng.rand(500, 8)
    y = (X[:, 0] + X[:, 1] > 1.0).astype(np.float32)
    P = {"objective": "binary", "num_leaves": 15, "verbosity": -1,
         "bagging_fraction": 0.8, "bagging_freq": 1, "min_data_in_leaf": 5}

    def ds():
        return lt.Dataset(X, label=y, device="cpu")

    full = lt.train(P, ds(), 20, verbose_eval=False).model_to_string()
    chaos = ChaosRegistry("fs.partial@8", seed=0)
    chaos.install_filesystem("chaos")
    try:
        lt.train(P, ds(), 12, verbose_eval=False, snapshot_freq=2,
                 snapshot_out=f"chaos://{tmp_path}/m.txt")
    finally:
        chaos.uninstall_filesystem()
    res = lt.train(P, ds(), 20, verbose_eval=False,
                   resume_from=str(tmp_path / "m.txt.ckpt"))
    assert res.model_to_string() == full
