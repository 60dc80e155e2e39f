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

Two tiers: ``mesh_plan`` partitions a group's ranks into slices (one a
host, or ``LGBM_TPU_NUM_SLICES`` simulated ones on one host), and
``parallel.learners.make_mesh`` splits the group into the sub-groups of
each slice and across them.  A sub-group meets on the store its group
was built on: ``new_group`` builds a group and remembers its store
(``sub_groups``), and the default group splits with
``torch.distributed.new_group``.
"""

from __future__ import annotations

import contextlib
import datetime
import socket
import threading
import weakref
from typing import List, NamedTuple, Optional, Sequence, Tuple

from ..utils import envflags
from ..utils.log import log_info, log_warning

# the last real (non-dry-run) init_network call
_LAST_INIT: Optional[dict] = None
_thread = threading.local()


class MeshPlan(NamedTuple):
    """How the data-parallel ranks partition into tiers.

    ``num_slices > 1`` elects the two-tier ``("dcn", "ici")`` mesh
    (``parallel.learners.make_hybrid_mesh``); 1 keeps the flat group.
    ``source`` records which signal decided (the live topology >
    simulated slices > num_machines > flat; ``elastic`` for a plan of
    ``resilience.elastic.plan_shrunk_world``)."""

    num_slices: int
    devices_per_slice: int
    total_shards: int
    source: str                 # "distributed" | "env" | "num_machines"
    #                             | "flat" | "elastic"

    @property
    def hybrid(self) -> bool:
        return self.num_slices > 1


def last_network_init() -> Optional[dict]:
    """The recorded (non-dry-run) ``init_network`` call, or None."""
    return _LAST_INIT


def _slice_env() -> Tuple[int, int]:
    """(``LGBM_TPU_NUM_SLICES``, ``LGBM_TPU_SLICE_DEVICES``), 0 where
    unset or not an integer."""
    from .learners import simulated_slices
    per_env = (envflags.read("LGBM_TPU_SLICE_DEVICES") or "").strip()
    try:
        per = max(int(per_env), 1) if per_env else 0
    except ValueError:
        per = 0
    return simulated_slices(), per


def mesh_plan(world_size: int, num_machines: Optional[int] = None,
              local_listen_port: Optional[int] = None, group=None,
              hosts: Optional[Sequence] = None) -> MeshPlan:
    """Partition ``world_size`` data-parallel ranks into slices (the JAX
    package's priority, network.py:63-135):

    1. the live topology: where the ranks span more than one host, one
       slice per host (``hosts``: each rank's host, as the booster
       gathers them; else found once by an all-gather of the host names
       over ``group``, ``host_ids``).  The hosts must hold equal,
       contiguous blocks of ranks, else the plan is flat;
    2. ``LGBM_TPU_NUM_SLICES`` (simulated slices on one host), its
       slices bounded to ``LGBM_TPU_SLICE_DEVICES`` ranks where set
       (how an elastic shrink, ``resilience/elastic.py``, states the
       survivors' world).  A slice count that cannot partition the
       ranks raises: the mesh never quietly becomes flat;
    3. ``num_machines`` (or the last ``init_network``'s): that many
       slices where it divides the ranks and leaves a slice more than
       one rank, unless the live topology is known and is one host.
       The JAX package's one process has no live topology and simulates
       them; the port's ranks on one host would only pay a second
       all-reduce a sum for a slow tier they do not have, so the plan
       stays flat and says so (``LGBM_TPU_NUM_SLICES`` simulates slices
       on one host);
    4. flat.

    A configured ``num_machines`` that disagrees with the world the plan
    found warns (the reference would wait for the missing machines).
    Unlike the JAX package, which can leave devices out of its mesh, a
    flat plan holds every rank: the booster refuses a plan whose shards
    are not its group's ranks."""
    nd = max(int(world_size), 1)
    if num_machines is None and _LAST_INIT is not None:
        num_machines = _LAST_INIT.get("num_machines")
        if local_listen_port is None:
            local_listen_port = _LAST_INIT.get("local_listen_port")
    nm = int(num_machines or 0)

    def warn_mismatch(actual: int, what: str):
        if nm > 1 and nm != actual:
            log_warning(
                f"num_machines={nm} disagrees with {what} ({actual}); "
                "using the actual topology — fix num_machines / the "
                "machine list so the configured world matches the "
                "devices actually present"
                + (f" (local_listen_port={local_listen_port})"
                   if local_listen_port else ""))

    if hosts is None and group is not None and nd > 1:
        hosts = host_ids(group)
    h = 0
    if hosts is not None:
        order = list(dict.fromkeys(hosts))
        h = len(order)
        if h > 1:
            warn_mismatch(h, "the live host count")
            per = nd // h if nd % h == 0 else 0
            if per and list(hosts) == [order[r // per] for r in range(nd)]:
                return MeshPlan(h, per, nd, "distributed")
            log_warning(f"the {nd} ranks do not lie in equal blocks of "
                        f"consecutive ranks on their {h} hosts; the mesh "
                        "is flat")
            return MeshPlan(1, nd, nd, "flat")
    sim, per = _slice_env()
    if sim >= 1 and (sim > 1 or per):
        per_c = per or (nd // sim if nd % sim == 0 else 0)
        if not per_c or sim * per_c > nd:
            raise ValueError(
                f"LGBM_TPU_NUM_SLICES={sim}"
                + (f" x LGBM_TPU_SLICE_DEVICES={per}" if per else "")
                + f" cannot partition the {nd} ranks into equal slices; "
                "set a slice count that divides the ranks, or unset it "
                "to train on one tier")
        warn_mismatch(sim, "LGBM_TPU_NUM_SLICES")
        return MeshPlan(sim, per_c, sim * per_c, "env")
    if nm > 1 and nd % nm == 0 and nd // nm > 1:
        if h != 1:
            return MeshPlan(nm, nd // nm, nd, "num_machines")
        log_warning(
            f"num_machines={nm} would split the {nd} ranks into {nm} "
            "slices, but every rank runs on one host: the mesh is flat "
            "(set LGBM_TPU_NUM_SLICES to simulate slices on one host)")
        return MeshPlan(1, nd, nd, "flat")
    warn_mismatch(nd, "the process group's ranks")
    return MeshPlan(1, nd, nd, "flat")


# ----------------------------------------------------------------------
# groups a mesh can split: the store each was built on
# ----------------------------------------------------------------------

class _GroupInfo(NamedTuple):
    store: object
    prefix: str
    timeout: datetime.timedelta


# the store, prefix and timeout of each group ``new_group`` built, and
# the host names ``host_ids`` found; keyed weakly by group
_GROUPS: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()
_HOSTS: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()
_registry_lock = threading.Lock()


def new_group(store, rank: int, world: int, timeout: float = 300.0,
              prefix: str = "lgbt"):
    """A gloo process group of ``world`` ranks over ``store`` (a
    ``torch.distributed`` Store: ``FileStore``, ``TCPStore``,
    ``HashStore`` for thread ranks), this one ``rank``, every wait
    bounded by ``timeout`` seconds: the CPU's ranks, and several ranks
    on one card (NCCL refuses two ranks on one GPU; NCCL ranks, one a
    card, take the default group of ``init_network``).  The store is
    remembered, so that ``parallel.learners.make_mesh`` can build the
    group's sub-groups on it (a ``ProcessGroup`` does not give its store
    back)."""
    td = datetime.timedelta(seconds=float(timeout))
    pg = _gloo_group(store, prefix, rank, world, td)
    with _registry_lock:
        _GROUPS[pg] = _GroupInfo(store, prefix, td)
    return pg


def _gloo_group(store, prefix: str, rank: int, world: int,
                timeout: datetime.timedelta):
    import torch.distributed as dist
    return dist.ProcessGroupGloo(dist.PrefixStore(prefix, store), rank,
                                 world, timeout)


def sub_groups(group, blocks: List[List[int]], key: str):
    """This rank's group among ``blocks`` (disjoint lists of ``group``
    ranks that cover it): every rank of ``group`` calls this with the
    same ``blocks`` and ``key``, and each builds only its own block's
    group, on the store ``new_group`` remembered under ``<prefix>/<key>/
    <block>`` (the default group of ``init_network``/
    ``init_process_group`` splits with ``torch.distributed.new_group``,
    every block in order on every rank)."""
    import torch.distributed as dist
    rank = int(group.rank())
    info = _GROUPS.get(group)
    if info is None:
        if dist.is_initialized() and group is dist.group.WORLD:
            mine = None
            for b in blocks:
                g = dist.new_group(ranks=b)
                if rank in b:
                    mine = g
            return mine
        raise ValueError(
            "this process group was not built by parallel.network."
            "new_group (or init_network), so its sub-groups have no store "
            "to meet on: build the group with new_group(store, rank, "
            "world) to train on a mesh of it")
    for i, b in enumerate(blocks):
        if rank in b:
            return _gloo_group(info.store, f"{info.prefix}/{key}/{i}",
                               b.index(rank), len(b), info.timeout)
    raise ValueError(f"rank {rank} is in none of the blocks {blocks}")


def host_ids(group) -> List[str]:
    """Each rank's host name, in rank order: one all-gather over
    ``group`` the first time a group is asked, remembered after."""
    with _registry_lock:
        got = _HOSTS.get(group)
    if got is None:
        from .collectives import all_gather_bytes
        got = [b.decode() for b in all_gather_bytes(
            socket.gethostname().encode(), group)]
        with _registry_lock:
            _HOSTS[group] = got
    return got


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
