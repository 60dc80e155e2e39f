"""Distributed Dataset construction: FindBin over the ranks' samples
and an all-gather of the bin mappers (counterpart of
``lightgbm_tpu/parallel/dist_data.py``).

reference: DatasetLoader::ConstructBinMappersFromTextData, distributed
branch (src/io/dataset_loader.cpp:913-1000): with num_machines > 1 each
rank runs FindBin only for features ``f % num_machines == rank`` over
the sampled values, serializes its BinMappers, and an all-gather gives
every rank the identical full mapper set.

The transport is a byte all-gather over a process group
(``collectives.all_gather_bytes``), or any ``allgather_bytes(payload) ->
[payload of each rank]`` a caller injects (the
LGBM_NetworkInitWithFunctions analogue, c_api.h:1036; the tests drive
the protocol with ``make_fake_allgather``'s in-process ranks).  The
samples' nonzero masks ride along: the EFB groups define the [G, n]
layout that the data-parallel histogram sums assume, so every rank
groups from the global sample.  Each rank then bins its own rows
through the binning kernel B3 (``Dataset._bin_rows``: f32 rows on the
kernel route, f64 on the host).

``resilience=`` (a ``resilience.retry.ResilienceConfig``, or implied by
``params['network_resilience']``) routes both all-gather rounds through
``resilient_allgather``: CRC framing, deadline and backoff, a verdict
every rank shares, so a flaky transport retries or aborts on every rank
alike instead of hanging or consuming a corrupted payload.  With its
``degraded_fallback`` a permanent failure falls back, with a warning, to
binning this rank's sample alone (the mappers then differ between
ranks: for salvage runs only).  ``resilience.faults.ChaosRegistry.
wrap_allgather`` injects faults at this seam.
"""

from __future__ import annotations

import json
from typing import Callable, List, Optional, Sequence

import numpy as np

from ..binning import BinMapper, BinType
from ..dataset import Dataset, _as_2d, _load_forced_bins, _sample_indices
from .collectives import all_gather_bytes, axis_index_flat, axis_size

AllgatherBytes = Callable[[bytes], List[bytes]]


def _encode_sample(S: int, cols: dict, F: int) -> bytes:
    """Binary framing of the phase-1 payload: [S:i64][F:i64][values per
    feature: F x i64][every value f64][every mask packbits, ceil(S/8)
    bytes per feature]."""
    head = np.empty(2 + F, np.int64)
    head[0], head[1] = S, F
    vals_parts, mask_parts = [], []
    for f in range(F):
        v, m = cols[f]
        head[2 + f] = len(v)
        vals_parts.append(np.ascontiguousarray(v, np.float64).tobytes())
        mask_parts.append(np.packbits(m.astype(np.uint8)).tobytes())
    return head.tobytes() + b"".join(vals_parts) + b"".join(mask_parts)


def _decode_sample(blob: bytes):
    """Inverse of ``_encode_sample``: (S, {f: values}, {f: mask})."""
    S, F = np.frombuffer(blob, np.int64, count=2)
    S, F = int(S), int(F)
    nvals = np.frombuffer(blob, np.int64, count=F, offset=16)
    off = 16 + 8 * F
    vals = {}
    for f in range(F):
        nv = int(nvals[f])
        vals[f] = np.frombuffer(blob, np.float64, count=nv, offset=off)
        off += 8 * nv
    mask_bytes = (S + 7) // 8
    masks = {}
    for f in range(F):
        packed = np.frombuffer(blob, np.uint8, count=mask_bytes, offset=off)
        masks[f] = np.unpackbits(packed)[:S].astype(bool)
        off += mask_bytes
    return S, vals, masks


def _transport(rank, world, allgather_bytes, group):
    if allgather_bytes is None:
        if group is None:
            from .network import current_group
            group = current_group()
        allgather_bytes = (lambda payload: all_gather_bytes(payload,
                                                           group))
        if rank is None or world is None:
            rank, world = axis_index_flat(group), axis_size(group)
    if rank is None or world is None:
        raise ValueError("an injected allgather_bytes needs rank= and world=")
    return rank, world, allgather_bytes


def distributed_bin_mappers(
    local_sample: np.ndarray,
    params: Optional[dict] = None,
    categorical: Sequence[int] = (),
    rank: Optional[int] = None,
    world: Optional[int] = None,
    allgather_bytes: Optional[AllgatherBytes] = None,
    group=None,
    resilience=None,
):
    """Returns (bin_mappers [F], sample_nonzero {feature -> bool
    [S_total]}, total_sample_cnt), the same on every rank.
    ``local_sample`` [S_local, F]: this rank's sampled rows.  The
    transport is ``allgather_bytes`` (with ``rank``/``world``), else
    ``group`` (else the current group); ``resilience``: the module
    docstring.

    The feature shard is ``f % world == rank`` (the reference's mod
    partition, dataset_loader.cpp:924).  FindBin for a shard runs over
    the global sample (every rank's sampled values of that feature
    travel in the first all-gather), as the reference gathers the
    per-feature sample values before binning them on the owning rank."""
    p = dict(params or {})
    sample = _as_2d(local_sample)
    rank, world, allgather_bytes = _transport(rank, world, allgather_bytes,
                                              group)
    from ..resilience.retry import ResilienceConfig
    res = (resilience if resilience is not None
           else ResilienceConfig.from_params(p))
    if res is not None and world > 1:
        from ..resilience.retry import CollectiveError, make_resilient
        from ..utils.log import log_warning
        wrapped = make_resilient(allgather_bytes, world=world, rank=rank,
                                 config=res, label="distributed_bin_mappers")
        try:
            return _bin_mappers_impl(sample, p, categorical, rank, world,
                                     wrapped)
        except CollectiveError:
            if not res.degraded_fallback:
                raise
            log_warning(
                "distributed_bin_mappers: COLLECTIVE FAILED PERMANENTLY; "
                f"rank {rank} continuing DEGRADED as a single-rank binning "
                "over its local sample ONLY — bin mappers will NOT agree "
                "across ranks (network_degraded_fallback=True)")
            return _bin_mappers_impl(sample, p, categorical, 0, 1,
                                     lambda b: [b])
    return _bin_mappers_impl(sample, p, categorical, rank, world,
                             allgather_bytes)


def _bin_mappers_impl(sample, p, categorical, rank, world, allgather_bytes):
    S, F = sample.shape
    # phase 1: every rank's sampled values of every feature (NaN and
    # non-zero only: zeros are implicit, as in the reference's sparse
    # sample) and its nonzero/NaN mask
    cols = {}
    for f in range(F):
        col = np.asarray(sample[:, f], np.float64)
        keep = np.isnan(col) | (np.abs(col) > 1e-35)
        cols[f] = (col[keep], keep)
    parts = allgather_bytes(_encode_sample(S, cols, F))
    if len(parts) != world:
        raise RuntimeError(f"the all-gather returned {len(parts)} payloads "
                           f"for {world} ranks")
    decoded = [_decode_sample(b) for b in parts]
    total_sample_cnt = int(sum(d[0] for d in decoded))
    all_vals = {f: np.concatenate([d[1][f] for d in decoded])
                for f in range(F)}
    sample_nonzero = {f: np.concatenate([d[2][f] for d in decoded])
                      for f in range(F)}

    # phase 2: bin this rank's feature shard over the global sample, then
    # gather the serialized mappers (dataset_loader.cpp:985)
    forced_bounds = _load_forced_bins(p)
    max_bin = int(p.get("max_bin", 255))
    mine = {}
    for f in range(rank, F, world):
        m = BinMapper()
        m.find_bin(
            all_vals[f], total_sample_cnt, max_bin,
            min_data_in_bin=int(p.get("min_data_in_bin", 3)),
            min_split_data=int(p.get("min_data_in_leaf", 20)),
            pre_filter=bool(p.get("feature_pre_filter", True)),
            bin_type=(BinType.CATEGORICAL if f in categorical
                      else BinType.NUMERICAL),
            use_missing=bool(p.get("use_missing", True)),
            zero_as_missing=bool(p.get("zero_as_missing", False)),
            forced_upper_bounds=forced_bounds.get(f, ()))
        mine[str(f)] = m.to_dict()
    mappers: List[Optional[BinMapper]] = [None] * F
    for blob in allgather_bytes(json.dumps(mine).encode()):
        for fs, d in json.loads(blob.decode()).items():
            mappers[int(fs)] = BinMapper.from_dict(d)
    if any(m is None for m in mappers):
        raise RuntimeError("a feature's bin mapper is missing after the "
                           "all-gather")
    return mappers, sample_nonzero, total_sample_cnt


def construct_distributed(
    local_data,
    label=None,
    params: Optional[dict] = None,
    categorical_feature: Sequence[int] = (),
    rank: Optional[int] = None,
    world: Optional[int] = None,
    allgather_bytes: Optional[AllgatherBytes] = None,
    group=None,
    device=None,
    resilience=None,
) -> Dataset:
    """This rank's Dataset over its own rows with bin mappers and an EFB
    layout that every rank agrees on (so that data-parallel histogram
    sums line up).  reference flow: DatasetLoader::LoadFromFile with
    num_machines > 1: local rows, the distributed
    ConstructBinMappersFromTextData, then the local rows through the
    shared mappers (here B3, ``Dataset._bin_rows``)."""
    p = dict(params or {})
    data = _as_2d(local_data)
    n_local, F = data.shape
    sample_idx = _sample_indices(
        n_local, int(p.get("bin_construct_sample_cnt", 200000)),
        int(p.get("data_random_seed", 1)))
    mappers, sample_nonzero, total_sample_cnt = distributed_bin_mappers(
        data[sample_idx], params=p, categorical=categorical_feature,
        rank=rank, world=world, allgather_bytes=allgather_bytes,
        group=group, resilience=resilience)
    ds = Dataset(None, label=label, params=p,
                 categorical_feature=list(categorical_feature) or "auto",
                 device=device)
    ds.num_data, ds.num_total_features = n_local, F
    ds.feature_names = [f"Column_{i}" for i in range(F)]
    ds.bin_mappers = mappers
    ds.used_features = [f for f, m in enumerate(mappers) if not m.is_trivial]
    ds._build_groups({j: sample_nonzero[f]
                      for j, f in enumerate(ds.used_features)},
                     total_sample_cnt)
    ds.binned_t = ds._bin_rows(data).to(ds.device)
    ds._finish_construct()
    return ds


def make_fake_allgather(world: int, timeout: Optional[float] = None):
    """In-process transport for tests: ``world`` ranks in threads meet at
    a barrier per all-gather round.  Returns ``fn_for(rank)``.  Rounds
    are numbered by a per-rank call counter and each has its own barrier,
    so a broken rendezvous (a rank past ``timeout``) poisons only its
    round (``threading.BrokenBarrierError`` for every waiter)."""
    import threading

    barriers: dict = {}
    bufs: dict = {}
    rounds = [0] * world
    lock = threading.Lock()

    def fn_for(rank: int) -> AllgatherBytes:
        def allgather(payload: bytes) -> List[bytes]:
            with lock:
                r = rounds[rank]
                rounds[rank] += 1
                if r not in barriers:
                    barriers[r] = threading.Barrier(world)
                bar = barriers[r]
                buf = bufs.setdefault(r, {})
                buf[rank] = payload
            bar.wait(timeout)            # every rank has written
            out = [buf[q] for q in range(world)]
            bar.wait(timeout)            # every rank has read
            with lock:
                barriers.pop(r - 4, None)
                bufs.pop(r - 4, None)
            return out
        return allgather

    return fn_for
