"""Dataset: binned feature matrix + metadata (counterpart of
``lightgbm_tpu/dataset.py``).

reference: include/LightGBM/dataset.h:41,333, src/io/dataset_loader.cpp.
Construction fits the bin mappers on a row sample on the host (NumPy,
``binning.py``), groups features as the JAX package's EFB does, then
bins every row.  The binned matrix lives FEATURE-MAJOR, ``[G, n]``, on
the Dataset's torch device (``binned_t``), the layout the trainer reads:

- f32 input bins through ``ops.ingest.DeviceBinner``: on ``cuda`` the
  binning kernel (``csrc/ingest.cu``), on the CPU its plain version;
- f64 input bins on the host with ``_bin_block``, as the JAX package
  does: the kernel's directed-rounded f32 bound table is exact only
  against f32 values.

``_bin_block`` is also the kernel's oracle: the two give the same bytes.

Inputs: a dense matrix (or a list of row blocks), a pandas DataFrame
(category columns become their codes; the category lists are kept in
``pandas_categorical`` and re-applied to valid sets and at predict), a
scipy sparse matrix (the bin mappers fit on the densified sample rows;
every row is binned in densified chunks of ``SPARSE_CHUNK_ROWS`` rows,
f32 chunks through the binning kernel), or a file path: a binary cache
written by ``save_binary`` (recognised by its magic bytes, whatever
the name, and interchangeable with the JAX package's), or a CSV, TSV
or LibSVM text file (``io_utils.py``; ``two_round`` reads it twice and
never holds its float matrix).  ``device=None`` means the CUDA card, and
a host without one raises; tests pass ``device="cpu"``.

Streamed construction (the JAX package's dataset.py:597-790; reference:
LGBM_DatasetCreateFromSampledColumn + LGBM_DatasetPushRows, c_api.h:98-
144): ``Dataset.from_sample`` fits the bins on a row sample and
``push_rows`` bins chunks of rows (dense or CSR, in any order over
disjoint ranges) into the preallocated ``binned_t`` on the card; the
load finishes itself when every row is in.  f32 chunks bin through B3
over ``data.stream.IngestPump`` (one launch a chunk of
``ops.planner.INGEST_CHUNK_ROWS`` rows), f64 chunks on the host.  With
``spill=`` the rows go, in order, to a checksummed block store
(``data/blockstore.py``) instead, and training streams them
(``data/stream.py``).  A Dataset whose resident training peak does not
fit the card (``ops.planner.plan_stream``'s device verdict at
construct) never allocates ``binned_t``: it bins chunk by chunk straight
into a spill store, as ``from_sample(spill=True)`` would.  The JAX
package builds its resident matrix on the host and spills it only when
a booster elects streaming (ROADMAP queue C).
"""

from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from .binning import BinMapper, BinType
from .compat import is_pandas_frame

_BINARY_MAGIC = b"lgbm_tpu.dataset.v1\n"
# rows of a sparse matrix densified at a time (176 MB of f32 at 674
# features)
SPARSE_CHUNK_ROWS = 1 << 16
# the layout a validation set, a subset and a binary cache share with
# their reference
_LAYOUT = ("num_total_features", "bin_mappers", "used_features",
           "feature_names", "feat_group", "feat_start", "num_groups",
           "_group_size", "group_num_bin", "max_group_bin")


def same_bins(a: Sequence[BinMapper], b: Sequence[BinMapper]) -> bool:
    """Two lists of bin mappers bin alike (their records compared as
    JSON text, so NaN bounds compare equal)."""
    return a is b or (len(a) == len(b) and json.dumps(
        [m.to_dict() for m in a]) == json.dumps([m.to_dict() for m in b]))


def _is_sparse(data) -> bool:
    return hasattr(data, "tocsc") and hasattr(data, "nnz")


def _as_2d(data) -> np.ndarray:
    if hasattr(data, "values") and not callable(data.values):
        data = data.values
    if isinstance(data, (list, tuple)) and data and all(
            isinstance(a, np.ndarray) for a in data):
        data = np.vstack([np.atleast_2d(a) for a in data])
    arr = np.asarray(data)
    if arr.ndim != 2:
        raise ValueError(f"data must be 2-D, got shape {arr.shape}")
    if arr.dtype not in (np.float32, np.float64):
        arr = arr.astype(np.float64)
    return arr


def _data_from_pandas(data, feature_name, categorical_feature,
                      pandas_categorical):
    """DataFrame -> (float matrix, feature names, categorical features,
    category lists): category columns become their codes (-1 and unseen
    values NaN); the category lists are recorded on a train set and
    re-applied to a valid set; "auto" categorical features are the
    unordered category columns.  reference: _data_from_pandas
    (python-package/lightgbm/basic.py:331)."""
    if not is_pandas_frame(data):
        return data, feature_name, categorical_feature, pandas_categorical
    if feature_name in ("auto", None):
        data = data.rename(columns=str)
    cat_cols = [str(c) for c in
                data.select_dtypes(include=["category"]).columns]
    cat_cols_not_ordered = [c for c in cat_cols if not data[c].cat.ordered]
    if pandas_categorical is None:
        pandas_categorical = [list(data[c].cat.categories) for c in cat_cols]
    else:
        if len(cat_cols) != len(pandas_categorical):
            raise ValueError(
                "train and valid dataset categorical_feature do not match.")
        for col, category in zip(cat_cols, pandas_categorical):
            if list(data[col].cat.categories) != list(category):
                data[col] = data[col].cat.set_categories(category)
    if cat_cols:
        data = data.copy()
        data[cat_cols] = (data[cat_cols].apply(lambda x: x.cat.codes)
                          .replace({-1: np.nan}))
    if categorical_feature is not None:
        categorical_feature = (cat_cols_not_ordered
                               if categorical_feature == "auto"
                               else list(categorical_feature))
    if feature_name == "auto":
        feature_name = [str(c) for c in data.columns]
    values = data.values
    if values.dtype not in (np.float32, np.float64):
        values = values.astype(np.float32)
    return values, feature_name, categorical_feature, pandas_categorical


def _sample_indices(num_data: int, sample_cnt: int, seed: int) -> np.ndarray:
    if num_data <= sample_cnt:
        return np.arange(num_data)
    rng = np.random.RandomState(seed)
    return np.sort(rng.choice(num_data, size=sample_cnt, replace=False))


def _avoid_inf(value):
    """reference: Common::AvoidInf (utils/common.h:697-715): NaN -> 0,
    infinities clamp to the type's largest value."""
    a = np.asarray(value)
    if a.dtype.kind != "f":
        return a
    lim = 1e300 if a.dtype == np.float64 else np.finfo(a.dtype).max
    if np.isnan(a).any() or np.isinf(a).any():
        a = np.nan_to_num(a, nan=0.0, posinf=lim, neginf=-lim)
    return a


def _f32(v):
    return None if v is None else np.asarray(v, np.float32).reshape(-1)


def _f64(v):
    return None if v is None else np.asarray(v, np.float64)


@dataclass
class Metadata:
    """Labels / weights / query boundaries / init scores.

    reference: include/LightGBM/dataset.h:41-249, src/io/metadata.cpp."""

    label: Optional[np.ndarray] = None
    weight: Optional[np.ndarray] = None
    query_boundaries: Optional[np.ndarray] = None
    init_score: Optional[np.ndarray] = None

    def __setattr__(self, name, value):
        if name in ("label", "weight", "init_score") and value is not None:
            value = _avoid_inf(value)
        object.__setattr__(self, name, value)

    def set_group(self, group: Optional[Sequence[int]]) -> None:
        if group is None:
            self.query_boundaries = None
            return
        g = np.asarray(group, dtype=np.int64)
        self.query_boundaries = np.concatenate(
            [[0], np.cumsum(g)]).astype(np.int32)

    def num_queries(self) -> int:
        return (0 if self.query_boundaries is None
                else len(self.query_boundaries) - 1)

    def check(self, num_data: int) -> None:
        if self.label is not None and len(self.label) != num_data:
            raise ValueError(f"label length {len(self.label)} != num_data "
                             f"{num_data}")
        if self.weight is not None and len(self.weight) != num_data:
            raise ValueError("weight length mismatch")
        if self.query_boundaries is not None and \
                self.query_boundaries[-1] != num_data:
            raise ValueError("sum of query group sizes != num_data")


class Dataset:
    """User-facing dataset; constructed (binned) on first use."""

    def __init__(self, data, label=None, reference: Optional["Dataset"] = None,
                 weight=None, group=None, init_score=None,
                 silent: bool = False, feature_name="auto",
                 categorical_feature="auto", params: Optional[dict] = None,
                 free_raw_data: bool = True, device=None):
        from .basic import resolve_device
        self.params = dict(params or {})
        self.raw_data = data
        self.reference = reference
        self.free_raw_data = free_raw_data
        self.device = (reference.device if device is None
                       and reference is not None else resolve_device(device))
        self.metadata = Metadata()
        self.metadata.label = _f32(label)
        self.metadata.weight = _f32(weight)
        if group is not None:
            self.metadata.set_group(group)
        self.metadata.init_score = _f64(init_score)
        self._feature_name_param = feature_name
        self._categorical_feature_param = categorical_feature
        self.pandas_categorical = None
        self.constructed = False
        self.bin_mappers: List[BinMapper] = []
        self.used_features: List[int] = []
        self.binned_t: Optional[torch.Tensor] = None   # [G, n] on device
        self.feature_names: List[str] = []
        self.num_data = 0
        self.num_total_features = 0
        self.construct_seconds = 0.0
        # how the rows were binned: "kernel" (DeviceBinner) or "host"
        self.bin_route = None
        self._binner = None
        # the out-of-core spill store holding the binned rows instead of
        # binned_t, and whether this Dataset made it (and deletes it)
        self._block_store = None
        self._block_store_owned = False
        # a from_sample load: rows pushed so far, the append cursor
        self._streaming = False
        self._pushed = None
        self._append_cursor = 0

    # -- construction --------------------------------------------------------

    def construct(self) -> "Dataset":
        if self.constructed:
            return self
        if self._streaming:
            # name the first gap, so that an out-of-order loader sees
            # where its coverage broke
            missing = np.flatnonzero(~self._pushed)
            first = int(missing[0]) if len(missing) else 0
            raise RuntimeError(
                f"streaming dataset load incomplete: "
                f"{int(self._pushed.sum())}/{self.num_data} rows pushed "
                f"(first unpushed row: {first})")
        from .utils.timer import global_timer
        t0 = time.perf_counter()
        with global_timer.section("Dataset::Construct"):
            self._construct_inner()
        self.construct_seconds = time.perf_counter() - t0
        return self

    def _construct_inner(self) -> None:
        if self.raw_data is None:
            raise RuntimeError("cannot construct Dataset: raw data was freed")
        data = self.raw_data
        if is_pandas_frame(data):
            pc_in = None
            if self.reference is not None:
                pc_in = self.reference.construct().pandas_categorical
            data, fn, cf, pc = _data_from_pandas(
                data, self._feature_name_param,
                self._categorical_feature_param, pc_in)
            self.pandas_categorical = pc
            if self._categorical_feature_param in ("auto", None):
                self._categorical_auto_resolved = cf or []
        if isinstance(data, (str, os.PathLike)):
            if _is_binary_cache(str(data)):
                self._construct_from_cache(str(data))
                return
            from .io_utils import (_param_bool, load_text_dataset,
                                   load_text_dataset_two_round)
            if _param_bool(self.params, "two_round"):
                load_text_dataset_two_round(str(data), self)
                return
            data = load_text_dataset(str(data), self)
        if _is_sparse(data):
            raw = data.tocsr()
        else:
            raw = _as_2d(data)
        self.num_data, self.num_total_features = raw.shape
        # the binner holds the tables of the bins fitted last: a Dataset
        # constructed again under other parameters (a booster's
        # max_bin) fits new bins and needs new tables (ROADMAP C-27)
        self._binner = None
        p = self.params
        if self._feature_name_param in ("auto", None):
            if is_pandas_frame(self.raw_data):
                self.feature_names = [str(c) for c in self.raw_data.columns]
            else:
                self.feature_names = [f"Column_{i}"
                                      for i in range(self.num_total_features)]
        else:
            self.feature_names = list(self._feature_name_param)
        categorical = self._resolve_categorical()
        if self.reference is not None:
            # validation set: the reference's bin mappers and EFB layout
            self._align_with(self.reference.construct())
        else:
            sample_idx = _sample_indices(
                self.num_data, int(p.get("bin_construct_sample_cnt", 200000)),
                int(p.get("data_random_seed", 1)))
            if _is_sparse(raw):
                # the sampled rows densified: the values the JAX package
                # reads column by column from its CSC copy
                sample = raw[sample_idx].toarray()
                self._fit_bin_mappers(sample, np.arange(len(sample_idx)),
                                      categorical)
            else:
                self._fit_bin_mappers(raw, sample_idx, categorical)
        if self.reference is None and self._spill_at_construct():
            # the resident matrix would not fit the card: bin chunk by
            # chunk straight into a spill store
            self._setup_spill(True, self.binned_dtype(), None)
            self._fill(raw, 0, atomic=False)
            self._block_store.finalize()
        elif _is_sparse(raw):
            self._alloc_binned()
            self._fill(raw, 0)
        else:
            self.binned_t = self._bin_rows(raw).to(self.device)
        self._finish_construct()

    def _finish_construct(self) -> None:
        self.metadata.check(self.num_data)
        if self.metadata.label is None:
            self.metadata.label = np.zeros(self.num_data, dtype=np.float32)
        self.constructed = True
        if self.free_raw_data:
            self.raw_data = None

    def _align_with(self, ref: "Dataset") -> None:
        """Take ``ref``'s bin mappers and EFB layout."""
        for k in _LAYOUT:
            setattr(self, k, getattr(ref, k))

    def _binner_for(self):
        from .ops import ingest as ING
        held = None if self._binner is None else self._binner.bounds.device
        if held is None or held.type != self.device.type or (
                self.device.index is not None
                and held.index != self.device.index):
            self._binner = ING.DeviceBinner(ING.build_ingest_tables(self),
                                            self.device)
        return self._binner

    def _bin_rows(self, raw) -> torch.Tensor:
        """Rows into their [G, rows] binned matrix: f32 rows (a host
        array, or a tensor on the Dataset's device) through B3 on the
        device, other rows on the host (the f64 path; a CPU tensor,
        uint8 or int32).  The kernel route is the JAX package's
        ``ingest.device_bin`` span, and adds to ``ingest_rows_total`` and
        sets ``bin_rows_per_sec`` on the process registry: host seconds,
        since nothing here waits for the card (B3's time lands in
        whatever first reads the binned rows)."""
        if isinstance(raw, torch.Tensor) or raw.dtype == np.float32:
            from .obs.metrics import global_registry
            from .obs.trace import span
            self._note_route("kernel")
            n = int(raw.shape[0])
            t0 = time.perf_counter()
            with span("ingest.device_bin", rows=n):
                if not isinstance(raw, torch.Tensor):
                    raw = torch.from_numpy(np.ascontiguousarray(raw)).to(
                        self.device)
                out = self._binner_for()(raw)
            dt = time.perf_counter() - t0
            global_registry.counter("ingest_rows_total").inc(n)
            global_registry.gauge("bin_rows_per_sec").set(
                round(n / max(dt, 1e-9), 1))
            return out
        self._note_route("host")
        out = np.zeros((raw.shape[0], self.num_groups),
                       dtype=self.binned_dtype())
        self._bin_block(raw, out)
        dt = np.uint8 if out.dtype == np.uint8 else np.int32
        return torch.from_numpy(np.ascontiguousarray(out.T).astype(dt))

    # -- streamed construction ---------------------------------------------

    def _spill_at_construct(self) -> bool:
        """The card side of ``plan_stream``'s verdict for training on
        this Dataset resident (its own ``num_leaves``,
        ``use_quantized_grad``, ``num_class`` and ``tpu_round_width``)."""
        from .ops.planner import plan_stream
        p = self.params
        plan = plan_stream(
            rows=self.num_data, features=self.num_groups,
            num_bins=self.max_group_bin,
            num_leaves=int(p.get("num_leaves", 31)),
            num_class=max(int(p.get("num_class", 1)), 1),
            quant=bool(p.get("use_quantized_grad", False)),
            round_width=int(p.get("tpu_round_width", 128)),
            device=self.device)
        return not plan.resident_device_ok

    def _alloc_binned(self) -> None:
        """A zeroed [G, n] ``binned_t`` on the Dataset's device (uint8, or
        int32 past 256 bins) for chunks to fill."""
        self.binned_t = torch.zeros(
            (self.num_groups, self.num_data),
            dtype=torch.uint8 if self.max_group_bin <= 256 else torch.int32,
            device=self.device)

    def _binned_chunks(self, raw, base: int = 0):
        """Bin rows in chunks (``_bin_rows`` each): yields (start, rows,
        [G, rows] binned tensor) with ``start`` offset by ``base``.  f32
        rows cross to the Dataset's device over one ``IngestPump`` (B3
        once a chunk); CSR rows are densified a chunk of
        ``SPARSE_CHUNK_ROWS`` at a time."""
        from .data.stream import IngestPump
        from .ops.planner import INGEST_CHUNK_ROWS
        step = SPARSE_CHUNK_ROWS if _is_sparse(raw) else INGEST_CHUNK_ROWS
        if raw.dtype == np.float32:
            for _i, s, r, chunk in IngestPump(raw, step, device=self.device):
                yield base + s, r, self._bin_rows(chunk)
            return
        for s in range(0, raw.shape[0], step):
            part = raw[s:s + step]
            part = part.toarray() if _is_sparse(part) else part
            yield base + s, part.shape[0], self._bin_rows(part)

    def _note_route(self, route: str) -> None:
        self.bin_route = (route if self.bin_route in (None, route)
                          else "mixed")

    def _fill(self, raw, start: int, atomic: bool = True) -> None:
        """Bin rows ``[start, start + len(raw))`` into ``binned_t``, or
        append them to the spill store: ``atomic``, every chunk binned
        before any is appended (a failed push leaves the store as it
        was), else each chunk as it comes (host memory O(chunk))."""
        store = self._block_store
        if store is None:
            for s, r, t in self._binned_chunks(raw, start):
                self.binned_t[:, s:s + r] = t
            return
        parts = (t.cpu().numpy().T for _s, _r, t in
                 self._binned_chunks(raw, start))
        for part in (list(parts) if atomic else parts):
            store.append_rows(part)

    def _setup_spill(self, spill, dtype, block_rows: Optional[int]) -> None:
        """Route the binned rows to a block store: ``spill`` a directory,
        or True for a temporary one this Dataset deletes; ``block_rows``
        None takes ``plan_stream``'s (or every row)."""
        import weakref

        from .data.blockstore import BlockStore
        from .data.stream import default_spill_dir
        path = (spill if isinstance(spill, (str, os.PathLike))
                else default_spill_dir())
        if block_rows is None:
            from .ops.planner import plan_stream
            plan = plan_stream(rows=self.num_data, features=self.num_groups,
                               num_bins=self.max_group_bin,
                               device=self.device)
            block_rows = plan.block_rows or self.num_data
        self.binned_t = None
        self._block_store = BlockStore.create(
            str(path), self.num_data, self.num_groups, dtype,
            int(block_rows))
        self._block_store_owned = not isinstance(spill, (str, os.PathLike))
        if self._block_store_owned:
            weakref.finalize(self, BlockStore.cleanup, self._block_store)

    def _start_streaming(self, spill, spill_block_rows) -> None:
        if spill:
            self._setup_spill(spill, self.binned_dtype(), spill_block_rows)
        else:
            self._alloc_binned()
        self.raw_data = None
        self._pushed = np.zeros(self.num_data, bool)
        self._streaming = True
        self._append_cursor = 0

    @classmethod
    def from_sample(cls, sample, num_total_rows: int,
                    params: Optional[dict] = None, feature_name="auto",
                    categorical_feature="auto", spill=None,
                    spill_block_rows: Optional[int] = None,
                    device=None) -> "Dataset":
        """A streaming Dataset: the bin mappers and EFB layout from the
        rows ``sample`` (every one of them), the binned matrix of
        ``num_total_rows`` rows filled by ``push_rows``.  ``spill``: a
        directory for a block store of the binned rows (True: a
        temporary one), whose pushes must append in order; the store's
        blocks are ``spill_block_rows`` rows (None: ``plan_stream``'s).
        ``device=None`` is the CUDA card.  reference:
        LGBM_DatasetCreateFromSampledColumn (c_api.cpp)."""
        ds = cls(None, params=params, feature_name=feature_name,
                 categorical_feature=categorical_feature, device=device)
        sample = _as_2d(sample)
        ds.num_data = int(num_total_rows)
        ds.num_total_features = sample.shape[1]
        if feature_name in ("auto", None):
            ds.feature_names = [f"Column_{i}"
                                for i in range(ds.num_total_features)]
        else:
            ds.feature_names = list(feature_name)
        categorical = ds._resolve_categorical()
        ds._fit_bin_mappers(sample, np.arange(sample.shape[0]), categorical)
        ds._start_streaming(spill, spill_block_rows)
        return ds

    @classmethod
    def from_reference_streaming(cls, reference: "Dataset",
                                 num_total_rows: int,
                                 params: Optional[dict] = None
                                 ) -> "Dataset":
        """An empty streaming Dataset binned with ``reference``'s
        mappers and layout, on its device; fill it with ``push_rows``
        (reference: LGBM_DatasetCreateByReference, c_api.h)."""
        ref = reference.construct()
        ds = cls(None, reference=reference,
                 params=dict(params or ref.params))
        ds._align_with(ref)
        ds.pandas_categorical = ref.pandas_categorical
        ds.num_data = int(num_total_rows)
        ds._start_streaming(None, None)
        return ds

    def push_rows(self, chunk, start_row: Optional[int] = None) -> "Dataset":
        """Bin a chunk of raw rows (dense or scipy sparse) into rows
        ``[start_row, start_row + len)`` (None: after the last push;
        chunk sizes may vary, the last one ragged).  A push over rows
        already pushed raises, a failed push may be retried (rows count
        as pushed once binned); a spilled Dataset's pushes must append
        in order.  The load finishes itself when every row is in.
        reference: LGBM_DatasetPushRows (c_api.h:98)."""
        if not self._streaming:
            raise RuntimeError(
                "push_rows requires a Dataset created by from_sample")
        if self.constructed:
            raise RuntimeError("dataset load already finished")
        raw = chunk.tocsr() if _is_sparse(chunk) else _as_2d(chunk)
        rows = raw.shape[0]
        if start_row is None:
            start_row = self._append_cursor
        if start_row + rows > self.num_data:
            raise ValueError(
                f"push past the end: {start_row}+{rows} > {self.num_data}")
        already = np.flatnonzero(self._pushed[start_row:start_row + rows])
        if len(already):
            raise ValueError(
                f"push_rows overlap: row {start_row + int(already[0])} was "
                f"already pushed (chunk covers [{start_row}, "
                f"{start_row + rows})); pushes must cover disjoint row "
                "ranges — only a failed push may be retried")
        store = self._block_store
        if store is not None and start_row != self._append_cursor:
            raise ValueError(
                f"spill-mode push_rows must append in order: expected "
                f"start_row={self._append_cursor}, got {start_row} "
                "(the block store is append-only)")
        self._fill(raw, start_row)
        self._pushed[start_row:start_row + rows] = True
        self._append_cursor = max(self._append_cursor, start_row + rows)
        if self._pushed.all():             # auto-finish, as the C API
            if store is not None:
                store.finalize()
            self._finish_construct()
        return self

    def _fit_bin_mappers(self, raw, sample_idx, categorical) -> None:
        """FindBin per feature over a row sample + EFB grouping.

        reference: DatasetLoader::ConstructBinMappersFromTextData
        (dataset_loader.cpp:823) + Dataset::Construct EFB
        (dataset.cpp:97-313)."""
        from .utils.log import LightGBMError
        p = self.params
        max_bin = int(p.get("max_bin", 255))
        mbbf = p.get("max_bin_by_feature") or []
        if isinstance(mbbf, str):
            mbbf = [int(v) for v in mbbf.split(",") if v.strip()]
        if mbbf and len(mbbf) != self.num_total_features:
            raise LightGBMError("Length of max_bin_by_feature is not same "
                                "with feature number")
        forced_bounds = _load_forced_bins(p)
        min_data_in_bin = int(p.get("min_data_in_bin", 3))
        min_data_in_leaf = int(p.get("min_data_in_leaf", 20))
        use_missing = bool(p.get("use_missing", True))
        zero_as_missing = bool(p.get("zero_as_missing", False))
        pre_filter = bool(p.get("feature_pre_filter", True))
        total_sample_cnt = len(sample_idx)
        sraw = np.ascontiguousarray(raw[sample_idx])
        self.bin_mappers = []
        for f in range(self.num_total_features):
            col = np.asarray(sraw[:, f], dtype=np.float64)
            keep = np.isnan(col) | (np.abs(col) > 1e-35)
            m = BinMapper()
            btype = (BinType.CATEGORICAL if f in categorical
                     else BinType.NUMERICAL)
            m.find_bin(col[keep], total_sample_cnt,
                       int(mbbf[f]) if mbbf else max_bin,
                       min_data_in_bin=min_data_in_bin,
                       min_split_data=min_data_in_leaf,
                       pre_filter=pre_filter, bin_type=btype,
                       use_missing=use_missing,
                       zero_as_missing=zero_as_missing,
                       forced_upper_bounds=forced_bounds.get(f, ()))
            self.bin_mappers.append(m)
        self.used_features = [f for f, m in enumerate(self.bin_mappers)
                              if not m.is_trivial]
        if not self.used_features and self.bin_mappers:
            # every feature constant: one never-splittable dummy column
            self.bin_mappers[0] = BinMapper(
                num_bin=2, is_trivial=False,
                bin_upper_bound=np.array([0.0, np.inf]))
            self.used_features = [0]
        sample_nonzero = {}
        for j, f in enumerate(self.used_features):
            col = np.asarray(sraw[:, f], dtype=np.float64)
            sample_nonzero[j] = np.isnan(col) | (np.abs(col) > 1e-35)
        self._build_groups(sample_nonzero, total_sample_cnt)

    def _bin_block(self, raw, out: np.ndarray) -> None:
        """Bin raw rows into ``out`` (a [rows, G] uint view) on the host:
        the f64 path, and the binning kernel's oracle."""
        dtype = out.dtype
        for j, f in enumerate(self.used_features):
            g = int(self.feat_group[j])
            col = np.asarray(raw[:, f], dtype=np.float64)
            bins = self.bin_mappers[f].value_to_bin(col)
            start = int(self.feat_start[j])
            if start == 1 and self._group_size[g] == 1:
                out[:, g] = bins.astype(dtype)
            else:
                nz = bins != 0   # bundled features are zero-default
                out[nz, g] = (start + bins[nz] - 1).astype(dtype)

    def _build_groups(self, sample_nonzero: dict,
                      total_sample_cnt: int) -> None:
        """Greedy conflict-bounded exclusive feature bundling, as the JAX
        package does it (reference: Dataset::FindGroups, dataset.cpp:97-
        234).  The trainer refuses a dataset that bundles."""
        F = len(self.used_features)
        enable = str(self.params.get("enable_bundle", True)).lower() not in (
            "false", "0", "no")
        eligible = []
        for j, f in enumerate(self.used_features):
            m = self.bin_mappers[f]
            if (enable and m.bin_type == BinType.NUMERICAL
                    and m.most_freq_bin == 0 and m.default_bin == 0
                    and m.num_bin <= 256 and j in sample_nonzero):
                eligible.append(j)
        budget = max(total_sample_cnt // 10000, 0)
        groups: List[List[int]] = []
        group_nz: List[np.ndarray] = []
        group_cnt: List[int] = []
        group_conflict: List[int] = []
        group_bins: List[int] = []
        nz_cnt = {j: int(sample_nonzero[j].sum()) for j in eligible}
        eligible.sort(key=lambda j: nz_cnt[j], reverse=True)
        max_search_group = 100
        for j in eligible:
            nz = sample_nonzero[j]
            cnt_j = nz_cnt[j]
            nb = self.bin_mappers[self.used_features[j]].num_bin
            placed = False
            searched = 0
            for gi in range(len(groups)):
                if searched >= max_search_group:
                    break
                if group_bins[gi] + nb - 1 > 256:
                    continue
                lower = max(0, cnt_j + group_cnt[gi] - total_sample_cnt)
                if group_conflict[gi] + lower > budget:
                    continue
                searched += 1
                conflict = int(np.count_nonzero(group_nz[gi] & nz))
                if group_conflict[gi] + conflict <= budget:
                    groups[gi].append(j)
                    group_nz[gi] = group_nz[gi] | nz
                    group_cnt[gi] = group_cnt[gi] + cnt_j - conflict
                    group_conflict[gi] += conflict
                    group_bins[gi] += nb - 1
                    placed = True
                    break
            if not placed:
                groups.append([j])
                group_nz.append(nz.copy())
                group_cnt.append(cnt_j)
                group_conflict.append(0)
                group_bins.append(1 + (nb - 1))

        feat_group = np.zeros(F, np.int32)
        feat_start = np.ones(F, np.int32)
        group_size: List[int] = []
        group_num_bin: List[int] = []
        gid = 0
        bundled_pos = set()
        for members in groups:
            if len(members) == 1:
                continue
            off = 1
            for j in members:
                feat_group[j] = gid
                feat_start[j] = off
                off += self.bin_mappers[self.used_features[j]].num_bin - 1
                bundled_pos.add(j)
            group_size.append(len(members))
            group_num_bin.append(off)
            gid += 1
        for j in range(F):
            if j in bundled_pos:
                continue
            feat_group[j] = gid
            feat_start[j] = 1
            group_size.append(1)
            group_num_bin.append(
                self.bin_mappers[self.used_features[j]].num_bin)
            gid += 1
        self.feat_group = feat_group
        self.feat_start = feat_start
        self.num_groups = gid
        self._group_size = group_size
        self.group_num_bin = group_num_bin
        self.max_group_bin = max(group_num_bin, default=2)

    def _resolve_categorical(self) -> set:
        cf = self._categorical_feature_param
        if cf == "auto" or cf is None:
            cats = set()
            auto = getattr(self, "_categorical_auto_resolved", None)
            if auto:
                cats |= self._names_to_indices(auto)
            pcf = (self.params.get("categorical_feature")
                   or self.params.get("categorical_column"))
            if pcf:
                cats |= self._names_to_indices(pcf)
            return cats
        return self._names_to_indices(cf)

    def _names_to_indices(self, spec) -> set:
        if isinstance(spec, str):
            spec = [s for s in spec.split(",") if s]
        out = set()
        for s in spec:
            if isinstance(s, str) and not s.lstrip("-").isdigit():
                if s in self.feature_names:
                    out.add(self.feature_names.index(s))
                else:
                    raise ValueError(f"unknown categorical feature {s!r}")
            else:
                out.add(int(s))
        return out

    # -- binary cache (reference: Dataset::SaveBinaryFile dataset.cpp:890;
    #    the JAX package's format, byte for byte) ---------------------------

    def save_binary(self, filename: str) -> "Dataset":
        """Write the binned rows, bin mappers, EFB layout, construction
        parameters and metadata to ``filename`` atomically."""
        from .utils.file_io import open_atomic
        self.construct()
        binned = self.host_binned()
        meta = {
            "version": 1,
            "params": {k: v for k, v in self.params.items()
                       if isinstance(v, (int, float, str, bool, list))
                       or v is None},
            "num_data": int(self.num_data),
            "num_total_features": int(self.num_total_features),
            "used_features": list(map(int, self.used_features)),
            "feature_names": self.feature_names,
            "bin_mappers": [m.to_dict() for m in self.bin_mappers],
            "dtype": str(binned.dtype),
            "feat_group": list(map(int, self.feat_group)),
            "feat_start": list(map(int, self.feat_start)),
            "num_groups": int(self.num_groups),
            "group_size": list(map(int, self._group_size)),
            "group_num_bin": list(map(int, self.group_num_bin)),
            "has_label": self.metadata.label is not None,
            "has_weight": self.metadata.weight is not None,
            "has_group": self.metadata.query_boundaries is not None,
            "has_init_score": self.metadata.init_score is not None,
        }
        with open_atomic(filename, "wb") as fh:
            fh.write(_BINARY_MAGIC)
            hdr = json.dumps(meta).encode()
            fh.write(len(hdr).to_bytes(8, "little"))
            fh.write(hdr)
            fh.write(binned.tobytes())
            for arr in (self.metadata.label, self.metadata.weight,
                        self.metadata.query_boundaries,
                        self.metadata.init_score):
                if arr is not None:
                    fh.write(np.ascontiguousarray(arr).tobytes())
        return self

    @staticmethod
    def load_binary(filename: str, params: Optional[dict] = None,
                    device=None) -> "Dataset":
        """A constructed Dataset from a binary cache, its binned rows on
        ``device`` (the CUDA card by default)."""
        ds = Dataset(None, params=params, device=device)
        ds._read_cache(filename, params)
        return ds

    def _read_cache(self, filename: str, params: Optional[dict]) -> None:
        from .utils.file_io import open_file
        with open_file(filename, "rb") as fh:
            if fh.read(len(_BINARY_MAGIC)) != _BINARY_MAGIC:
                raise ValueError(
                    f"{filename} is not a lightgbm_tpu binary dataset")
            n = int.from_bytes(fh.read(8), "little")
            meta = json.loads(fh.read(n).decode())
            self.params = dict(params or meta.get("params") or {})
            self._feature_name_param = meta["feature_names"]
            self._categorical_feature_param = None
            self.num_data = meta["num_data"]
            self.num_total_features = meta["num_total_features"]
            self.used_features = meta["used_features"]
            self.feature_names = meta["feature_names"]
            self.bin_mappers = [BinMapper.from_dict(d)
                                for d in meta["bin_mappers"]]
            F = len(self.used_features)
            if "feat_group" in meta:
                self.feat_group = np.asarray(meta["feat_group"], np.int32)
                self.feat_start = np.asarray(meta["feat_start"], np.int32)
                self.num_groups = int(meta["num_groups"])
                self._group_size = list(meta["group_size"])
                self.group_num_bin = list(meta["group_num_bin"])
            else:    # a file from before EFB: identity groups
                self.feat_group = np.arange(F, dtype=np.int32)
                self.feat_start = np.ones(F, np.int32)
                self.num_groups = F
                self._group_size = [1] * F
                self.group_num_bin = [self.bin_mappers[f].num_bin
                                      for f in self.used_features]
            self.max_group_bin = max(self.group_num_bin, default=2)
            dtype = np.dtype(meta["dtype"])
            nd, G = self.num_data, self.num_groups
            binned = np.frombuffer(fh.read(nd * G * dtype.itemsize),
                                   dtype=dtype).reshape(nd, G)
            self.binned_t = torch.from_numpy(np.ascontiguousarray(
                binned.T).astype(np.uint8 if dtype == np.uint8
                                 else np.int32)).to(self.device)
            md = self.metadata = Metadata()
            if meta["has_label"]:
                md.label = np.frombuffer(fh.read(nd * 4), np.float32).copy()
            if meta["has_weight"]:
                md.weight = np.frombuffer(fh.read(nd * 4), np.float32).copy()
            rest = fh.read()
        isc_bytes = nd * 8 if meta["has_init_score"] else 0
        if meta["has_group"]:
            md.query_boundaries = np.frombuffer(
                rest[:len(rest) - isc_bytes], np.int32).copy()
        if isc_bytes:
            md.init_score = np.frombuffer(rest[len(rest) - isc_bytes:],
                                          np.float64).copy()
        self.bin_route = "cache"
        self.constructed = True

    def _construct_from_cache(self, path: str) -> None:
        """A path that holds a binary cache: the cache's bins, layout and
        parameters (the file's win, so the Booster's parameter check
        sees the true old values); fields given to the constructor
        override the file's."""
        pre = self.metadata
        keep = (self._feature_name_param, self._categorical_feature_param)
        self._read_cache(path, None)
        self._feature_name_param, self._categorical_feature_param = keep
        if self.free_raw_data:
            self.raw_data = None
        self._from_binary_cache = True
        if self.reference is not None:
            ref = self.reference.construct()
            aligned = (
                same_bins(ref.bin_mappers, self.bin_mappers)
                and list(ref.used_features) == list(self.used_features)
                and np.array_equal(ref.feat_group, self.feat_group)
                and np.array_equal(ref.feat_start, self.feat_start))
            if not aligned:
                from .utils.log import LightGBMError
                raise LightGBMError(
                    "Cannot add validation data, since it has different bin "
                    "mappers with training data")
        for f in ("label", "weight", "init_score", "query_boundaries"):
            v = getattr(pre, f, None)
            if v is not None:
                setattr(self.metadata, f, v)
        self.metadata.check(self.num_data)

    # -- accessors -----------------------------------------------------------

    def create_valid(self, data, label=None, weight=None, group=None,
                     init_score=None, params=None) -> "Dataset":
        """A validation Dataset binned with THIS dataset's mappers, on the
        same device.  reference: Dataset.create_valid (basic.py:1142)."""
        return Dataset(data, label=label, reference=self, weight=weight,
                       group=group, init_score=init_score,
                       feature_name=self._feature_name_param,
                       categorical_feature=self._categorical_feature_param,
                       params=dict(params or self.params),
                       free_raw_data=self.free_raw_data, device=self.device)

    # 'group' is set as per-query SIZES and read back as the cumulative
    # boundaries (reference: Dataset.get_field/set_field, basic.py:1255)
    _FIELDS = ("label", "weight", "init_score", "group")

    def set_field(self, field_name: str, data) -> "Dataset":
        if field_name not in self._FIELDS:
            raise ValueError(f"unknown field {field_name!r}")
        if field_name == "group":
            self.metadata.set_group(data)
        elif field_name == "init_score":
            self.metadata.init_score = _f64(data)
        else:
            setattr(self.metadata, field_name, _f32(data))
        return self

    def get_field(self, field_name: str):
        if field_name not in self._FIELDS:
            raise ValueError(f"unknown field {field_name!r}")
        if field_name == "group":
            return self.metadata.query_boundaries
        return getattr(self.metadata, field_name)

    def set_label(self, label):
        return self.set_field("label", label)

    def set_weight(self, weight):
        return self.set_field("weight", weight)

    def set_init_score(self, init_score):
        return self.set_field("init_score", init_score)

    def set_group(self, group):
        return self.set_field("group", group)

    def get_label(self):
        return self.metadata.label

    def get_weight(self):
        return self.metadata.weight

    def get_init_score(self):
        return self.metadata.init_score

    def get_group(self):
        """Per-query group SIZES."""
        qb = self.metadata.query_boundaries
        return None if qb is None else np.diff(qb)

    label = property(get_label, set_label)
    weight = property(get_weight, set_weight)
    init_score = property(get_init_score, set_init_score)
    group = property(get_group, set_group)

    def get_data(self):
        """The raw data this Dataset was built from (raises after it was
        freed)."""
        if self.raw_data is None and self.constructed:
            raise RuntimeError(
                "Cannot get data: raw data was freed after construction "
                "(pass free_raw_data=False to keep it)")
        return self.raw_data

    def get_feature_names(self) -> List[str]:
        return self.feature_names

    def set_categorical_feature(self, categorical_feature) -> "Dataset":
        if self._categorical_feature_param == categorical_feature:
            return self
        if self.constructed:
            raise RuntimeError(
                "Cannot set categorical feature after dataset construction; "
                "create a new Dataset")
        self._categorical_feature_param = categorical_feature
        return self

    def set_feature_name(self, feature_name) -> "Dataset":
        if feature_name != "auto":
            self._feature_name_param = feature_name
            if self.constructed:
                if len(feature_name) != self.num_total_features:
                    raise ValueError(
                        f"Length of feature names ({len(feature_name)}) does "
                        f"not equal number of features "
                        f"({self.num_total_features})")
                self.feature_names = list(feature_name)
        return self

    def set_reference(self, reference: "Dataset") -> "Dataset":
        if self.reference is reference:
            return self
        if self.constructed:
            raise RuntimeError(
                "Cannot set reference after dataset construction; "
                "create a new Dataset")
        self.reference = reference
        return self

    def add_features_from(self, other: "Dataset") -> "Dataset":
        """Append ``other``'s features (both constructed, with as many
        rows): its groups follow this one's, each keeping its EFB
        bundles.  reference: Dataset::AddFeaturesFrom (dataset.cpp)."""
        if not (self.constructed and other.constructed):
            raise ValueError("Both source and target Datasets must be "
                             "constructed before adding features")
        if self.num_data != other.num_data:
            from .utils.log import LightGBMError
            raise LightGBMError(
                f"Cannot add features from {other.num_data}-row Dataset to "
                f"{self.num_data}-row Dataset")
        base = self.num_total_features
        self.bin_mappers = list(self.bin_mappers) + list(other.bin_mappers)
        self.used_features = list(self.used_features) + [
            base + f for f in other.used_features]
        wide = max(self.max_group_bin, other.max_group_bin) > 256
        dt = torch.int32 if wide else torch.uint8
        self.binned_t = torch.cat([self._resident_binned().to(dt),
                                   other._resident_binned().to(self.device,
                                                               dt)])
        self.feat_group = np.concatenate(
            [self.feat_group, other.feat_group + self.num_groups]
        ).astype(np.int32)
        self.feat_start = np.concatenate(
            [self.feat_start, other.feat_start]).astype(np.int32)
        self._group_size = list(self._group_size) + list(other._group_size)
        self.group_num_bin = (list(self.group_num_bin)
                              + list(other.group_num_bin))
        self.num_groups += other.num_groups
        self.max_group_bin = max(self.max_group_bin, other.max_group_bin)
        self.num_total_features += other.num_total_features
        self.feature_names = (list(self.feature_names)
                              + list(other.feature_names))
        self._binner = None
        return self

    def subset(self, used_indices, params=None) -> "Dataset":
        """The rows ``used_indices`` (in that order) as a constructed
        Dataset with this one's bins: a gather of the [G, n] matrix on
        the device.  Rows of one query must stay contiguous and in
        order.  reference: the JAX package's dataset.py:1203."""
        self.construct()
        idx = np.asarray(used_indices, dtype=np.int64)
        sub = Dataset(None, params=dict(params or self.params),
                      device=self.device)
        if self.raw_data is not None and not isinstance(
                self.raw_data, (str, os.PathLike)):
            sub.raw_data = (self.raw_data.iloc[idx]
                            if hasattr(self.raw_data, "iloc")
                            else self.raw_data[idx])
            sub.free_raw_data = self.free_raw_data
        elif self.raw_data is not None:
            sub.raw_data = self.raw_data
            sub.free_raw_data = self.free_raw_data
        sub.reference = self
        md = self.metadata
        qb = None
        if md.query_boundaries is not None:
            gid = np.searchsorted(md.query_boundaries, idx, side="right") - 1
            if np.any(np.diff(gid) < 0):
                raise ValueError(
                    "subset() of grouped (ranking) data requires "
                    "used_indices to keep each query's rows contiguous and "
                    "in order")
            change = np.flatnonzero(np.diff(gid)) + 1
            qb = np.concatenate([[0], change, [len(idx)]]).astype(np.int32)
        sub.metadata = Metadata(
            label=None if md.label is None else md.label[idx],
            weight=None if md.weight is None else md.weight[idx],
            init_score=None if md.init_score is None else
            np.asarray(md.init_score).reshape(self.num_data, -1)[idx]
            .reshape(-1),
            query_boundaries=qb)
        sub._feature_name_param = self.feature_names
        sub._categorical_feature_param = self._categorical_feature_param
        sub.pandas_categorical = self.pandas_categorical
        sub._align_with(self)
        sub.binned_t = self._resident_binned()[:, torch.from_numpy(idx).to(
            self.device)]
        sub.num_data = len(idx)
        sub.bin_route = "subset"
        sub.constructed = True
        return sub

    def _resident_binned(self) -> torch.Tensor:
        """``binned_t``, or the error of a Dataset without it."""
        self.construct()
        if self.binned_t is None and self._block_store is not None:
            raise RuntimeError(
                "this Dataset's binned matrix lives in an out-of-core "
                "block store (lightgbm_tpu_torch/data/), not on the "
                "device; metadata consumers should use binned_shape()/"
                "binned_dtype(), bulk consumers must stream blocks via "
                "Dataset._block_store.read_block")
        return self.binned_t

    def host_binned(self) -> np.ndarray:
        """The binned matrix as a host [n, G] array of ``binned_dtype``
        (raises for a block-backed Dataset)."""
        return np.ascontiguousarray(
            self._resident_binned().cpu().numpy().T).astype(
                self.binned_dtype())

    def _dump_text(self, filename: str) -> "Dataset":
        """A debugging dump of the binned matrix (reference:
        Dataset::DumpTextFile, src/io/dataset.cpp:994, through
        LGBM_DatasetDumpText; the JAX package's dataset.py:1103): the
        header, the feature names, then each row's bin of every used
        feature.  Not loadable back."""
        self.construct()
        from .utils.file_io import open_atomic
        F = len(self.used_features)
        meta = self.feature_meta()
        group = (meta.feat_group if meta.feat_group is not None
                 else np.arange(F))
        start = (meta.feat_start if meta.feat_start is not None
                 else np.ones(F, np.int32))
        binned = self.host_binned()
        with open_atomic(filename, "w") as fh:
            fh.write(f"num_features: {F}\n")
            fh.write(f"num_total_features: {self.num_total_features}\n")
            fh.write(f"num_groups: {self.num_groups}\n")
            fh.write(f"num_data: {self.num_data}\n")
            fh.write("feature_names: " + ", ".join(self.feature_names)
                     + "\n")
            for row in binned:
                bins = []
                for j in range(F):
                    dec = int(row[group[j]]) - int(start[j]) + 1
                    bins.append(dec if 1 <= dec < meta.num_bin[j] else 0)
                fh.write(", ".join(str(b) for b in bins) + "\n")
        return self

    def binned_shape(self) -> tuple:
        """(num_data, num_groups): metadata, valid on the card and for a
        block-backed Dataset alike."""
        self.construct()
        return (self.num_data, self.num_groups)

    def binned_dtype(self) -> np.dtype:
        return np.dtype(np.uint8 if self.max_group_bin <= 256
                        else np.uint16)

    def get_params(self) -> dict:
        """A copy of the Dataset's parameters."""
        return dict(self.params)

    def get_ref_chain(self, ref_limit: int = 100) -> set:
        """The Datasets reachable through ``.reference``, this one
        included (reference: Dataset.get_ref_chain, basic.py:1633; the
        JAX package's dataset.py:1013)."""
        head, chain = self, set()
        while len(chain) < ref_limit:
            if isinstance(head, Dataset):
                chain.add(head)
                if head.reference is not None \
                        and head.reference not in chain:
                    head = head.reference
                else:
                    break
            else:
                break
        return chain

    @property
    def categorical_feature(self):
        """The ``categorical_feature`` spec as given (reference keeps the
        user's names or indices on the Dataset)."""
        return self._categorical_feature_param

    def num_feature(self) -> int:
        """The number of original features (reference:
        LGBM_DatasetGetNumFeature)."""
        self.construct()
        return self.num_total_features

    def num_features(self) -> int:
        """The number of used (non-trivial) features."""
        self.construct()
        return len(self.used_features)

    def feature_meta(self) -> "FeatureMeta":
        self.construct()
        return FeatureMeta.from_mappers(
            [self.bin_mappers[f] for f in self.used_features],
            feat_group=self.feat_group, feat_start=self.feat_start,
            num_groups=self.num_groups, max_group_bin=self.max_group_bin)


def _is_binary_cache(path: str) -> bool:
    """A file that starts with the cache's magic bytes, whatever its name
    (reference: DatasetLoader::LoadFromFile checks the binary token
    first, dataset_loader.cpp:273)."""
    from .utils.file_io import open_file
    try:
        with open_file(path, "rb") as fh:
            return fh.read(len(_BINARY_MAGIC)) == _BINARY_MAGIC
    except OSError:
        return False


def _load_forced_bins(params: dict) -> Dict[int, List[float]]:
    """``forcedbins_filename``: a JSON list of ``{"feature": f,
    "bin_upper_bound": [...]}``, as each feature's forced upper bounds
    (reference: the DatasetLoader constructor, dataset_loader.cpp; the
    JAX package's dataset.py:1469)."""
    fn = params.get("forcedbins_filename", "")
    if not fn:
        return {}
    from .utils.file_io import open_file
    with open_file(fn) as fh:
        spec = json.load(fh)
    return {int(e["feature"]): [float(x) for x in e["bin_upper_bound"]]
            for e in spec}


@dataclass(frozen=True)
class FeatureMeta:
    """Per-used-feature metadata arrays for the kernels.

    EFB mapping (reference: FeatureGroup bin stacking,
    feature_group.h:32-50): feature f's non-default bins b >= 1 live at
    merged bin ``feat_start[f] + b - 1`` of column ``feat_group[f]``;
    singleton groups use feat_start = 1 (merged bin == feature bin)."""

    num_bin: np.ndarray        # int32 [F]
    missing_type: np.ndarray   # int32 [F]
    default_bin: np.ndarray    # int32 [F]
    most_freq_bin: np.ndarray  # int32 [F]
    is_categorical: np.ndarray  # bool [F]
    max_num_bin: int           # padded per-feature bin axis B
    feat_group: Optional[np.ndarray] = None
    feat_start: Optional[np.ndarray] = None
    num_groups: int = 0
    max_group_bin: int = 0

    def with_identity_groups(self) -> "FeatureMeta":
        import dataclasses
        F = len(self.num_bin)
        return dataclasses.replace(
            self, feat_group=np.arange(F, dtype=np.int32),
            feat_start=np.ones(F, np.int32), num_groups=F,
            max_group_bin=self.max_num_bin)

    @property
    def has_bundles(self) -> bool:
        return self.num_groups != 0 and self.num_groups != len(self.num_bin)

    def resolved(self) -> "FeatureMeta":
        return self if self.num_groups else self.with_identity_groups()

    def tensors(self, device) -> Dict[str, torch.Tensor]:
        """The int32 meta vectors on ``device``."""
        m = self.resolved()
        return {k: torch.as_tensor(getattr(m, k).astype(np.int32),
                                   device=device)
                for k in ("num_bin", "missing_type", "default_bin",
                          "feat_group", "feat_start")}

    @staticmethod
    def from_mappers(mappers: Sequence[BinMapper], feat_group=None,
                     feat_start=None, num_groups: int = 0,
                     max_group_bin: int = 0) -> "FeatureMeta":
        nb = np.array([m.num_bin for m in mappers], dtype=np.int32)
        meta = FeatureMeta(
            num_bin=nb,
            missing_type=np.array([m.missing_type for m in mappers],
                                  dtype=np.int32),
            default_bin=np.array([m.default_bin for m in mappers],
                                 dtype=np.int32),
            most_freq_bin=np.array([m.most_freq_bin for m in mappers],
                                   dtype=np.int32),
            is_categorical=np.array([m.bin_type == BinType.CATEGORICAL
                                     for m in mappers], dtype=bool),
            max_num_bin=int(nb.max()) if len(nb) else 2,
            feat_group=feat_group, feat_start=feat_start,
            num_groups=num_groups, max_group_bin=max_group_bin)
        return meta.resolved()
