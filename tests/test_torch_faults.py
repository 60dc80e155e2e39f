"""The port's fault injection (lightgbm_tpu_torch.resilience.faults) against
the JAX package's: the schedule syntax, seeded replays, and the device,
serving and file-system sites raising the port's own errors."""

import errno
import time

import numpy as np
import pytest

from lightgbm_tpu.resilience import faults as jfaults
from lightgbm_tpu.serving.errors import DeviceLost as JDeviceLost

from lightgbm_tpu_torch.resilience import faults
from lightgbm_tpu_torch.resilience.faults import (ChaosRegistry,
                                                  FaultInjected, FaultSpec,
                                                  parse_schedule)
from lightgbm_tpu_torch.serving.errors import DeviceLost
from lightgbm_tpu_torch.testing import one_thread  # noqa: F401

# tests/test_chaos.py::test_parse_schedule_syntax's strings, and more
SCHEDULES = [
    "allgather.bitflip@2:rank=1,fs.enospc@0,"
    "allgather.delay@1:sec=0.25:prob=0.5",
    "device.wedge@0:rank=0:sec=8",
    "device.vanish@3:rank=2,device.error@1,device.delay@0:arg=0.01",
    "serving.nan@4,serving.error@0:prob=0.25,serving.delay@2:sec=0.1",
    "fs.partial@1,fs.transient@2, allgather.recv_truncate@5:rank=3",
    "",
]


def _fields(spec) -> tuple:
    return (spec.site, spec.kind, spec.at, spec.rank, spec.prob, spec.arg,
            spec.fired)


@pytest.mark.parametrize("schedule", SCHEDULES)
def test_schedule_parses_as_in_the_jax_package(schedule):
    got = [_fields(s) for s in parse_schedule(schedule)]
    want = [_fields(s) for s in jfaults.parse_schedule(schedule)]
    assert got == want


def test_parse_schedule_syntax():
    specs = parse_schedule(
        "allgather.bitflip@2:rank=1,fs.enospc@0,"
        "allgather.delay@1:sec=0.25:prob=0.5")
    assert [s.kind for s in specs] == ["bitflip", "enospc", "delay"]
    assert specs[0].rank == 1 and specs[0].at == 2
    assert specs[2].arg == 0.25 and specs[2].prob == 0.5
    for bad in ("allgather.explode@0", "disk.enospc@0",
                "fs.enospc@0:colour=red"):
        with pytest.raises(ValueError):
            parse_schedule(bad)
        with pytest.raises(ValueError):
            jfaults.parse_schedule(bad)
    with pytest.raises(ValueError):
        FaultSpec("device", "melt", 0)


def _replay(mod, seed: int):
    """A probabilistic allgather schedule over 40 ops of 3 ranks: what
    each rank sent and the registry's firing log."""
    schedule = ",".join(
        f"allgather.{kind}@{at}:prob=0.5" + (f":rank={at % 3}" if at % 2
                                             else "")
        for at, kind in enumerate(["bitflip", "truncate", "drop",
                                   "recv_bitflip"] * 10))
    reg = mod.ChaosRegistry(schedule, seed=seed)
    sent = {r: [] for r in range(3)}
    wraps = {}
    for r in range(3):
        def transport(payload, r=r):
            sent[r].append(payload)
            return [payload] * 3
        wraps[r] = reg.wrap_allgather(transport, r)
    recv = []
    for op in range(40):
        for r in range(3):
            recv.append(wraps[r](b"lgbt-frame-%04d-rank-%d" % (op, r)))
    return sent, recv, list(reg.log)


@pytest.mark.parametrize("seed", [0, 7])
def test_seeded_schedule_replays_the_jax_package(seed):
    sent, recv, log = _replay(faults, seed)
    jsent, jrecv, jlog = _replay(jfaults, seed)
    assert log and log == jlog
    assert sent == jsent and recv == jrecv
    # and the port replays itself under the same seed
    assert _replay(faults, seed)[2] == log


def test_device_site_wedges_errors_and_vanishes():
    reg = ChaosRegistry("device.error@0:rank=1,device.wedge@1:rank=1:"
                        "sec=0.05,device.vanish@0:rank=2,"
                        "device.delay@0:rank=3:sec=0.05")
    calls = []

    def run_batch(batch):
        calls.append(batch)
        return batch

    d1 = reg.wrap_device_batch(1, run_batch)
    with pytest.raises(FaultInjected) as e:
        d1("b0")
    assert e.value.errno == errno.EIO
    t0 = time.monotonic()
    with pytest.raises(DeviceLost) as lost:
        d1("b1")                      # the wedge blocks, then raises
    assert time.monotonic() - t0 >= 0.04
    assert not isinstance(lost.value, JDeviceLost)
    assert reg.device_down(1) == "wedge"
    with pytest.raises(DeviceLost):
        reg.wrap_device_batch(2, run_batch)("b")
    assert reg.device_down(2) == "vanish"
    with pytest.raises(DeviceLost):     # persistent: every later batch
        reg.wrap_device_batch(2, run_batch)("b")
    t0 = time.monotonic()
    assert reg.wrap_device_batch(3, run_batch)("ok") == "ok"
    assert time.monotonic() - t0 >= 0.04
    assert reg.device_down(0) is None
    reg.down_device(0, "vanish")
    with pytest.raises(DeviceLost):
        reg.wrap_device_batch(0, run_batch)("b")
    with pytest.raises(ValueError):
        reg.down_device(0, "melt")
    assert calls == ["ok"]
    assert "device[1].wedge@1" in reg.log and \
        "device[0].vanish@manual" in reg.log


def test_serving_site_injects_delay_nan_and_error():
    reg = ChaosRegistry("serving.delay@0:sec=0.05,serving.nan@1,"
                        "serving.error@2")

    def predict(X):
        return np.asarray(X, np.float64) * 2.0

    fn = reg.wrap_predict(predict)
    t0 = time.monotonic()
    assert np.array_equal(fn([1.0, 2.0]), [2.0, 4.0])
    assert time.monotonic() - t0 >= 0.04
    out = fn([1.0, 2.0])
    assert np.isnan(out[0]) and out[1] == 4.0
    with pytest.raises(FaultInjected):
        fn([1.0])
    assert np.array_equal(fn([3.0]), [6.0])       # op 3: nothing due
    assert reg.log == ["serving[].delay@0", "serving[].nan@1",
                       "serving[].error@2"]


def test_fs_site_rides_the_ports_file_io(tmp_path):
    from lightgbm_tpu_torch.utils import file_io
    reg = ChaosRegistry("fs.enospc@0,fs.partial@1,fs.transient@2")
    scheme = reg.install_filesystem("chaostest")
    try:
        path = f"{scheme}://{tmp_path}/sub/a.bin"
        with pytest.raises(FaultInjected) as e:
            file_io.open_file(path, "wb")
        assert e.value.errno == errno.ENOSPC
        with file_io.open_file(path, "wb") as fh:     # silently halved
            fh.write(b"0123456789")
        with open(tmp_path / "sub" / "a.bin", "rb") as fh:
            assert fh.read() == b"01234"
        with pytest.raises(OSError):
            file_io.open_file(path, "wb")
        with file_io.open_file(path, "wb") as fh:
            fh.write(b"whole")
        with file_io.open_file(path, "rb") as fh:
            assert fh.read() == b"whole"
        assert file_io.remove(path)
    finally:
        reg.uninstall_filesystem("chaostest")


def _mappers_over_chaos(schedule: str):
    """Two thread ranks through ``parallel.dist_data``'s bin-mapper
    all-gather, each rank's transport wrapped by one registry: each
    rank's (mappers' upper bounds, or the error it raised)."""
    import threading

    from lightgbm_tpu_torch.parallel.dist_data import (
        distributed_bin_mappers, make_fake_allgather)
    rng = np.random.RandomState(3)
    samples = [rng.randn(200, 4), rng.randn(200, 4)]
    fn_for = make_fake_allgather(2, timeout=30)
    reg = ChaosRegistry(schedule, seed=0)
    out = {}

    def rank(r):
        try:
            mappers, _nz, _cnt = distributed_bin_mappers(
                samples[r], {"max_bin": 15}, rank=r, world=2,
                allgather_bytes=reg.wrap_allgather(fn_for(r), r))
            out[r] = [list(m.bin_upper_bound) for m in mappers]
        except Exception as e:  # noqa: BLE001 — the outcome under test
            out[r] = e

    threads = [threading.Thread(target=rank, args=(r,)) for r in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    assert not any(t.is_alive() for t in threads)
    return out, reg.log


def test_allgather_site_rides_the_dist_data_seam():
    clean, log = _mappers_over_chaos("")
    assert log == [] and clean[0] == clean[1]
    delayed, log = _mappers_over_chaos("allgather.delay@0:sec=0.05")
    assert delayed == clean and len(log) == 2
    dropped, log = _mappers_over_chaos("allgather.drop@0:rank=1")
    assert log == ["allgather[1].drop@0"]
    assert all(isinstance(v, Exception) for v in dropped.values())
