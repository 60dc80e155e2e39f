"""Process groups from reference-style configs (counterpart of
``lightgbm_tpu/parallel/network.py``).

The reference's distributed story is ``Network::Init`` over a socket or
MPI machine list (src/network/linkers_socket.cpp:23-188: parse
``machine_list``, bind ``local_listen_port``, connect all to all).  The
port's transport is ``torch.distributed``: ``init_network`` maps the
reference's config surface (``machines`` / ``machine_list_filename`` /
``local_listen_port`` / ``num_machines``, config.h:190-210) onto
``torch.distributed.init_process_group`` at ``tcp://host0:port0``:

- the FIRST machine in the list hosts the rendezvous (the reference's
  rank 0 by list order, linkers_socket.cpp:64-76);
- this process's rank is its position in the list, matched by local
  hostname or IP; ``local_listen_port`` tells apart several processes
  of one host;
- the backend is the caller's: NCCL for the card, gloo for
  ``device="cpu"``; nothing switches backends when one fails.

Training finds its group with ``current_group``: the group a thread set
with ``use_group`` (how ranks that are threads of one process, as in the
CPU tests, each train in their own group), else the default group
``init_network`` started, else None (one rank: every tree learner trains
serially, as the JAX package does on one device).
"""

from __future__ import annotations

import contextlib
import datetime
import socket
import threading
from typing import List, NamedTuple, Optional, Tuple

from ..utils.log import log_info, log_warning

# the last real (non-dry-run) init_network call
_LAST_INIT: Optional[dict] = None
_thread = threading.local()


class MeshPlan(NamedTuple):
    """How the data-parallel ranks partition into tiers.  The port has
    one tier (``num_slices`` 1): the JAX package's hybrid ICI x DCN
    layout waits for ROADMAP A9's remainder."""

    num_slices: int
    devices_per_slice: int
    total_shards: int
    source: str                 # "distributed" | "num_machines" | "flat"

    @property
    def hybrid(self) -> bool:
        return self.num_slices > 1


def last_network_init() -> Optional[dict]:
    """The recorded (non-dry-run) ``init_network`` call, or None."""
    return _LAST_INIT


def mesh_plan(world_size: int, num_machines: Optional[int] = None,
              local_listen_port: Optional[int] = None) -> MeshPlan:
    """The one-tier plan of ``world_size`` ranks.  A configured
    ``num_machines`` (or the last ``init_network``'s) that disagrees
    with the ranks present warns: the reference would wait for the
    missing machines."""
    nd = max(int(world_size), 1)
    if num_machines is None and _LAST_INIT is not None:
        num_machines = _LAST_INIT.get("num_machines")
        if local_listen_port is None:
            local_listen_port = _LAST_INIT.get("local_listen_port")
    nm = int(num_machines or 0)
    if nm > 1 and nm != nd:
        log_warning(
            f"num_machines={nm} disagrees with the process group's "
            f"{nd} ranks; using the group — fix num_machines / the "
            "machine list so the configured world matches the ranks "
            "actually present"
            + (f" (local_listen_port={local_listen_port})"
               if local_listen_port else ""))
    return MeshPlan(1, nd, nd, "distributed" if nd > 1 else "flat")


def parse_machine_list(machines: Optional[str] = None,
                       machine_list_file: Optional[str] = None
                       ) -> List[Tuple[str, int]]:
    """reference: Linkers::Linkers reads ``machines`` ("ip1:port1,
    ip2:port2") or one host:port per line of ``machine_list_filename``
    (linkers_socket.cpp:23-63)."""
    entries: List[str] = []
    if machines:
        entries = [tok for tok in str(machines).replace("\n", ",").split(",")
                   if tok.strip()]
    elif machine_list_file:
        from ..utils.file_io import exists, open_file
        if not exists(machine_list_file):
            # reference: Log::Fatal on an unreadable machine list file
            # (linkers_socket.cpp:27)
            raise ValueError(
                f"machine_list_file {str(machine_list_file)!r} does not "
                "exist; every machine needs the same host:port list file")
        with open_file(machine_list_file) as fh:
            entries = [ln.strip() for ln in fh.read().splitlines()
                       if ln.strip()]
    out = []
    for e in entries:
        host, _, port = e.strip().partition(":")
        if not host:
            raise ValueError(f"machine list entry {e!r} has no host")
        try:
            out.append((host, int(port) if port else 12400))
        except ValueError:
            raise ValueError(
                f"machine list entry {e!r}: port {port!r} is not an "
                "integer") from None
    return out


def _local_identifiers() -> set:
    ids = {"localhost", "127.0.0.1", socket.gethostname()}
    try:
        ids.add(socket.gethostbyname(socket.gethostname()))
    except OSError:
        pass
    try:
        ids.update(i[4][0] for i in socket.getaddrinfo(
            socket.gethostname(), None))
    except OSError:
        pass
    return ids


def resolve_rank(machine_list: List[Tuple[str, int]],
                 local_listen_port: Optional[int] = None) -> int:
    """This process's rank: its position in the machine list (the
    reference matches the bound interface and port,
    linkers_socket.cpp:64-76).  Where several entries name this host,
    ``local_listen_port`` picks one; else the first wins."""
    local = _local_identifiers()
    matches = [i for i, (h, p) in enumerate(machine_list) if h in local]
    if not matches:
        raise ValueError(
            f"none of the machine-list hosts {[h for h, _ in machine_list]} "
            f"matches this host ({sorted(local)}); set machines= to include "
            "this machine")
    if len(matches) > 1 and local_listen_port is not None:
        port_matches = [i for i in matches
                        if machine_list[i][1] == local_listen_port]
        if port_matches:
            return port_matches[0]
    return matches[0]


def init_network(machines: Optional[str] = None,
                 local_listen_port: Optional[int] = None,
                 listen_time_out: int = 120,
                 num_machines: Optional[int] = None,
                 machine_list_file: Optional[str] = None,
                 dry_run: bool = False, backend: str = "nccl"):
    """Start ``torch.distributed``'s default group from a reference-style
    machine list.  reference: Network::Init (network.cpp:29-58) /
    LGBM_NetworkInit (c_api.h).  Returns (rendezvous address "host:port",
    num_machines, rank); with ``dry_run`` nothing is started.
    ``listen_time_out`` (seconds) is the group's timeout; ``backend`` is
    ``nccl`` for the card and ``gloo`` for the CPU."""
    if listen_time_out is None:
        listen_time_out = 120      # the signature default, for explicit None
    try:
        ok = float(listen_time_out) > 0
    except (TypeError, ValueError):
        ok = False
    if not ok:
        raise ValueError(
            f"listen_time_out must be a positive number of seconds, "
            f"got {listen_time_out!r}")
    ml = parse_machine_list(machines, machine_list_file)
    if not ml and num_machines in (None, 0, 1):
        log_warning("init_network: no machine list and num_machines<=1; "
                    "nothing to do")
        return None
    if not ml:
        raise ValueError("init_network needs machines= or machine_list_file=")
    n = num_machines or len(ml)
    if n > len(ml):
        raise ValueError(
            f"num_machines={n} but machine list has {len(ml)} entries")
    ml = ml[:n]
    rank = resolve_rank(ml, local_listen_port)
    host0, port0 = ml[0]
    coordinator = f"{host0}:{port0}"
    if dry_run:
        return coordinator, n, rank
    global _LAST_INIT
    _LAST_INIT = {"num_machines": n, "rank": rank,
                  "local_listen_port": local_listen_port,
                  "coordinator": coordinator}
    import torch.distributed as dist
    if dist.is_initialized():
        log_warning("init_network: torch.distributed already initialized")
        return coordinator, n, rank
    if n == 1:
        log_info("init_network: single machine; no process group")
        return coordinator, n, rank
    log_info(f"init_network: init_process_group({backend!r}, "
             f"tcp://{coordinator}, world_size={n}, rank={rank})")
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator}", world_size=n,
        rank=rank, timeout=datetime.timedelta(seconds=float(listen_time_out)))
    return coordinator, n, rank


def free_network() -> None:
    """reference: Network::Dispose / LGBM_NetworkFree."""
    global _LAST_INIT
    _LAST_INIT = None
    import torch.distributed as dist
    try:
        if dist.is_initialized():
            dist.destroy_process_group()
    except Exception as e:   # noqa: BLE001 — best-effort teardown
        log_warning(f"free_network: {e}")


@contextlib.contextmanager
def use_group(group):
    """Train in ``group`` inside the block, on this thread."""
    prev = getattr(_thread, "group", None)
    _thread.group = group
    try:
        yield group
    finally:
        _thread.group = prev


def current_group():
    """The group training uses on this thread: ``use_group``'s, else the
    default group of an initialized ``torch.distributed`` with more than
    one rank, else None."""
    g = getattr(_thread, "group", None)
    if g is not None:
        return g
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized() \
            and dist.get_world_size() > 1:
        return dist.group.WORLD
    return None
