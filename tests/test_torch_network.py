"""The port's machine lists, rank resolution and ``init_network``
(``lightgbm_tpu_torch/parallel/network.py``; reference: Linkers::
Linkers, linkers_socket.cpp:23-76): tests/test_network.py's cases on the
port.  A mistyped machine list file or a non-positive listen_time_out
fails at init, loudly; ``dry_run`` starts no process group."""
import socket

import pytest

from lightgbm_tpu_torch.parallel.network import (init_network, mesh_plan,
                                                 parse_machine_list,
                                                 resolve_rank)
from lightgbm_tpu_torch.testing import one_thread  # noqa: F401


def test_parse_machines_string_and_default_port():
    ml = parse_machine_list(machines="10.0.0.1:123,10.0.0.2,10.0.0.3:9")
    assert ml == [("10.0.0.1", 123), ("10.0.0.2", 12400), ("10.0.0.3", 9)]


def test_parse_machines_newline_separated():
    assert parse_machine_list(machines="a:1\nb:2\n") == [("a", 1), ("b", 2)]


def test_parse_machine_list_file(tmp_path):
    f = tmp_path / "mlist.txt"
    f.write_text("hostA:5000\n\nhostB:5001\n")
    assert parse_machine_list(machine_list_file=str(f)) == \
        [("hostA", 5000), ("hostB", 5001)]


def test_parse_missing_machine_list_file_raises(tmp_path):
    with pytest.raises(ValueError, match="does not exist"):
        parse_machine_list(machine_list_file=str(tmp_path / "nope.txt"))


def test_parse_bad_port_raises():
    with pytest.raises(ValueError, match="not an integer"):
        parse_machine_list(machines="hostA:http")


def test_parse_empty_host_raises():
    with pytest.raises(ValueError, match="no host"):
        parse_machine_list(machines=":123")


def test_resolve_rank_by_position():
    me = socket.gethostname()
    ml = [("other-host-zzz", 1), (me, 2), ("another-host-yyy", 3)]
    assert resolve_rank(ml) == 1


def test_resolve_rank_duplicate_hosts_port_disambiguates():
    """Several processes on one host: local_listen_port picks the slot;
    an unknown port falls back to the first local entry."""
    ml = [("localhost", 5000), ("localhost", 5001), ("localhost", 5002)]
    assert resolve_rank(ml, local_listen_port=5001) == 1
    assert resolve_rank(ml, local_listen_port=5002) == 2
    assert resolve_rank(ml, local_listen_port=9999) == 0
    assert resolve_rank(ml) == 0


def test_resolve_rank_no_match_raises():
    with pytest.raises(ValueError, match="matches this host"):
        resolve_rank([("host-that-is-not-us-1", 1),
                      ("host-that-is-not-us-2", 2)])


def test_init_network_truncates_list_to_num_machines():
    coord, n, rank = init_network(
        machines="localhost:12400,localhost:12401,ghost:12402",
        local_listen_port=12401, num_machines=2, dry_run=True)
    assert (coord, n, rank) == ("localhost:12400", 2, 1)


def test_init_network_num_machines_exceeding_list_raises():
    with pytest.raises(ValueError, match="machine list has"):
        init_network(machines="localhost:12400", num_machines=3,
                     dry_run=True)


def test_init_network_missing_file_raises(tmp_path):
    with pytest.raises(ValueError, match="does not exist"):
        init_network(machine_list_file=str(tmp_path / "missing.txt"),
                     dry_run=True)


@pytest.mark.parametrize("bad", [0, -1, -120])
def test_init_network_rejects_nonpositive_timeout(bad):
    with pytest.raises(ValueError, match="listen_time_out"):
        init_network(machines="localhost:12400,localhost:12401",
                     listen_time_out=bad, dry_run=True)


def test_init_network_no_list_single_machine_is_noop():
    assert init_network(dry_run=True) is None


def test_mesh_plan_is_one_tier_and_warns_on_a_wrong_num_machines(
        monkeypatch):
    from lightgbm_tpu_torch.parallel import network
    seen = []
    monkeypatch.setattr(network, "log_warning", seen.append)
    plan = mesh_plan(4, num_machines=4)
    assert (plan.num_slices, plan.total_shards, plan.hybrid) == (1, 4, False)
    assert not seen
    mesh_plan(4, num_machines=3)
    assert len(seen) == 1 and "num_machines=3" in seen[0]


def test_init_network_starts_the_group_that_training_finds(capsys):
    """Two processes started from a machine list (``init_network`` with
    gloo, ranks by local_listen_port) train data-, feature- and
    voting-parallel models equal to their serial twins, and quantized
    ones equal on both ranks (``tools/torch_dist_check.py``)."""
    import json

    from lightgbm_tpu_torch.tools import torch_dist_check
    rc = torch_dist_check.main(["--world", "2", "--backend", "gloo",
                                "--device", "cpu", "--rows", "4000",
                                "--rounds", "2", "--leaves", "7",
                                "--timeout", "300"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and out["ok"], out
    assert out["equal_to_serial"] == [{"data": True, "feature": True,
                                       "voting": True}] * 2
