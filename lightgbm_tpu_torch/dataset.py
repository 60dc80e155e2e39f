"""Dataset: binned feature matrix + metadata (counterpart of the in-memory
dense half of ``lightgbm_tpu/dataset.py``).

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
Streaming, spill, binary files, ``subset``, pandas and sparse input are
not ported.  ``device=None`` means the CUDA card, and a host without one
raises; tests pass ``device="cpu"``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from .binning import BinMapper, BinType


def _as_2d(data) -> np.ndarray:
    arr = np.asarray(data)
    if arr.ndim != 2:
        raise ValueError(f"data must be 2-D, got shape {arr.shape}")
    if arr.dtype not in (np.float32, np.float64):
        arr = arr.astype(np.float64)
    return arr


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
        if label is not None:
            self.metadata.label = np.asarray(label, np.float32).reshape(-1)
        if weight is not None:
            self.metadata.weight = np.asarray(weight, np.float32).reshape(-1)
        if group is not None:
            self.metadata.set_group(group)
        if init_score is not None:
            self.metadata.init_score = np.asarray(init_score, np.float64)
        self._feature_name_param = feature_name
        self._categorical_feature_param = categorical_feature
        self.constructed = False
        self.bin_mappers: List[BinMapper] = []
        self.used_features: List[int] = []
        self.binned_t: Optional[torch.Tensor] = None   # [G, n] on device
        self.feature_names: List[str] = []
        self.num_data = 0
        self.num_total_features = 0
        self.construct_seconds = 0.0

    # -- construction --------------------------------------------------------

    def construct(self) -> "Dataset":
        if self.constructed:
            return self
        import time
        t0 = time.perf_counter()
        self._construct_inner()
        self.construct_seconds = time.perf_counter() - t0
        return self

    def _construct_inner(self) -> None:
        if self.raw_data is None:
            raise RuntimeError("cannot construct Dataset: raw data was freed")
        data = self.raw_data
        if hasattr(data, "tocsc") or isinstance(data, str) \
                or hasattr(data, "columns"):
            raise NotImplementedError(
                "lightgbm_tpu_torch bins dense NumPy matrices only; sparse, "
                "pandas and file input wait for ROADMAP queue A "
                "(Dataset input formats)")
        raw = _as_2d(data)
        self.num_data, self.num_total_features = raw.shape
        p = self.params
        sample_cnt = int(p.get("bin_construct_sample_cnt", 200000))
        seed = int(p.get("data_random_seed", 1))
        if self._feature_name_param in ("auto", None):
            self.feature_names = [f"Column_{i}"
                                  for i in range(self.num_total_features)]
        else:
            self.feature_names = list(self._feature_name_param)
        categorical = self._resolve_categorical()

        if self.reference is not None:
            # validation set: the reference's bin mappers and EFB layout
            ref = self.reference.construct()
            self.bin_mappers = ref.bin_mappers
            self.used_features = ref.used_features
            self.feature_names = ref.feature_names
            self.feat_group = ref.feat_group
            self.feat_start = ref.feat_start
            self.num_groups = ref.num_groups
            self._group_size = ref._group_size
            self.group_num_bin = ref.group_num_bin
            self.max_group_bin = ref.max_group_bin
        else:
            sample_idx = _sample_indices(self.num_data, sample_cnt, seed)
            self._fit_bin_mappers(raw, sample_idx, categorical)

        self.binned_t = self._bin_rows(raw)
        self.metadata.check(self.num_data)
        if self.metadata.label is None:
            self.metadata.label = np.zeros(self.num_data, dtype=np.float32)
        self.constructed = True
        if self.free_raw_data:
            self.raw_data = None

    def _bin_rows(self, raw: np.ndarray) -> torch.Tensor:
        """Every row into the [G, n] matrix on the Dataset's device."""
        from .ops import ingest as ING
        if raw.dtype == np.float32:
            tables = ING.build_ingest_tables(self)
            binner = ING.DeviceBinner(tables, self.device)
            return binner(torch.from_numpy(np.ascontiguousarray(raw)).to(
                self.device))
        out = np.zeros((self.num_data, self.num_groups),
                       dtype=self.binned_dtype())
        self._bin_block(raw, out)
        dt = torch.uint8 if out.dtype == np.uint8 else torch.int32
        return torch.from_numpy(
            np.ascontiguousarray(out.T).astype(
                np.uint8 if dt == torch.uint8 else np.int32)).to(self.device)

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
        if p.get("forcedbins_filename"):
            raise NotImplementedError(
                "forcedbins_filename waits for ROADMAP queue A (forced "
                "bins)")
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
                       forced_upper_bounds=())
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
            pcf = (self.params.get("categorical_feature")
                   or self.params.get("categorical_column"))
            return self._names_to_indices(pcf) if pcf else set()
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

    def host_binned(self) -> np.ndarray:
        """The binned matrix as a host [n, G] array of ``binned_dtype``."""
        self.construct()
        return np.ascontiguousarray(
            self.binned_t.cpu().numpy().T).astype(self.binned_dtype())

    def binned_shape(self) -> tuple:
        self.construct()
        return (self.num_data, self.num_groups)

    def binned_dtype(self) -> np.dtype:
        return np.dtype(np.uint8 if self.max_group_bin <= 256
                        else np.uint16)

    def get_label(self):
        return self.metadata.label

    @property
    def label(self):
        return self.metadata.label

    @property
    def weight(self):
        return self.metadata.weight

    def num_feature(self) -> int:
        self.construct()
        return len(self.used_features)

    def feature_meta(self) -> "FeatureMeta":
        self.construct()
        return FeatureMeta.from_mappers(
            [self.bin_mappers[f] for f in self.used_features],
            feat_group=self.feat_group, feat_start=self.feat_start,
            num_groups=self.num_groups, max_group_bin=self.max_group_bin)


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
