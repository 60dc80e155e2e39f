"""Host-side feature binning (quantization); the port's copy of
``lightgbm_tpu/binning.py``.

LightGBM's BinMapper (reference: include/LightGBM/bin.h:61-219,
src/io/bin.cpp:54-534).  Fitting the bin bounds is a host-side, one-shot
step in plain NumPy; the card bins rows against those bounds
(``ops/ingest.py``).  The binning *algorithm*
reproduces the reference semantics exactly (GreedyFindBin,
FindBinWithZeroAsOneBin, categorical count-sort, missing types) so that
split thresholds and model text are cross-compatible.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np

# reference: include/LightGBM/meta.h:53
K_ZERO_THRESHOLD = 1e-35
# reference: include/LightGBM/bin.h:39
K_SPARSE_THRESHOLD = 0.7


class MissingType:
    NONE = 0
    ZERO = 1
    NAN = 2


class BinType:
    NUMERICAL = 0
    CATEGORICAL = 1


def _next_after_up(a: float) -> float:
    """reference: Common::GetDoubleUpperBound (utils/common.h:894)."""
    return math.nextafter(a, math.inf)


def _check_double_equal_ordered(a: float, b: float) -> bool:
    """reference: Common::CheckDoubleEqualOrdered (utils/common.h:889)."""
    return b <= math.nextafter(a, math.inf)


def _greedy_find_bin_native(distinct_values, counts, max_bin, total_cnt,
                            min_data_in_bin):
    """``GreedyFindBin`` in the native library (``native/findbin.cpp``),
    or None where the library is unavailable."""
    from . import native
    lib = native.load_native_lib()
    if lib is None:
        native.count_route("find_bin", "numpy")
        return None
    native.count_route("find_bin", "native")
    dv = np.ascontiguousarray(distinct_values, dtype=np.float64)
    ct = np.ascontiguousarray(counts, dtype=np.int64)
    if len(ct) != len(dv):
        raise ValueError("counts and distinct values differ in length")
    out = np.empty(max(max_bin, 1), np.float64)
    n = lib.lgbt_greedy_find_bin(dv.ctypes.data, ct.ctypes.data, len(dv),
                                 int(max_bin), int(total_cnt),
                                 int(min_data_in_bin), out.ctypes.data)
    return out[:n].tolist()


def greedy_find_bin(
    distinct_values: np.ndarray,
    counts: np.ndarray,
    max_bin: int,
    total_cnt: int,
    min_data_in_bin: int,
) -> List[float]:
    """Equal-ish-frequency bin boundaries over sorted distinct values.

    reference: GreedyFindBin (src/io/bin.cpp:77-155).  Returns the list of
    bin upper bounds, last element is +inf.  The greedy scan is
    sequential over up to the sampled distinct-value count: above 512
    distinct values it runs in the native library (``native/findbin.cpp``,
    the same float semantics and the same list of floats), with this
    Python body where the library is unavailable.
    """
    if len(distinct_values) > 512 and max_bin > 0:
        native = _greedy_find_bin_native(distinct_values, counts, max_bin,
                                         total_cnt, min_data_in_bin)
        if native is not None:
            return native
    num_distinct_values = len(distinct_values)
    bin_upper_bound: List[float] = []
    assert max_bin > 0
    if num_distinct_values == 0:
        return [math.inf]
    if num_distinct_values <= max_bin:
        cur_cnt_inbin = 0
        for i in range(num_distinct_values - 1):
            cur_cnt_inbin += int(counts[i])
            if cur_cnt_inbin >= min_data_in_bin:
                val = _next_after_up((float(distinct_values[i]) + float(distinct_values[i + 1])) / 2.0)
                if not bin_upper_bound or not _check_double_equal_ordered(bin_upper_bound[-1], val):
                    bin_upper_bound.append(val)
                    cur_cnt_inbin = 0
        bin_upper_bound.append(math.inf)
        return bin_upper_bound

    if min_data_in_bin > 0:
        max_bin = min(max_bin, total_cnt // min_data_in_bin)
        max_bin = max(max_bin, 1)
    mean_bin_size = total_cnt / max_bin

    rest_bin_cnt = max_bin
    rest_sample_cnt = total_cnt
    is_big_count_value = counts >= mean_bin_size
    rest_bin_cnt -= int(is_big_count_value.sum())
    rest_sample_cnt -= int(counts[is_big_count_value].sum())
    mean_bin_size = rest_sample_cnt / rest_bin_cnt if rest_bin_cnt > 0 else math.inf

    upper_bounds = [math.inf] * max_bin
    lower_bounds = [math.inf] * max_bin

    bin_cnt = 0
    lower_bounds[bin_cnt] = float(distinct_values[0])
    cur_cnt_inbin = 0
    counts_l = counts.tolist()
    big_l = is_big_count_value.tolist()
    vals_l = distinct_values.tolist()
    for i in range(num_distinct_values - 1):
        if not big_l[i]:
            rest_sample_cnt -= counts_l[i]
        cur_cnt_inbin += counts_l[i]
        # need a new bin: the reference's `std::max(1.0, mean_bin_size *
        # 0.5f)` promotes to DOUBLE (double * float -> double), so the
        # half-mean trigger compares at double precision (ADVICE.md r5)
        if big_l[i] or cur_cnt_inbin >= mean_bin_size or (
            big_l[i + 1] and cur_cnt_inbin >= max(1.0, mean_bin_size * 0.5)
        ):
            upper_bounds[bin_cnt] = vals_l[i]
            bin_cnt += 1
            lower_bounds[bin_cnt] = vals_l[i + 1]
            if bin_cnt >= max_bin - 1:
                break
            cur_cnt_inbin = 0
            if not big_l[i]:
                rest_bin_cnt -= 1
                mean_bin_size = rest_sample_cnt / rest_bin_cnt if rest_bin_cnt > 0 else math.inf
    bin_cnt += 1
    bin_upper_bound = []
    for i in range(bin_cnt - 1):
        val = _next_after_up((upper_bounds[i] + lower_bounds[i + 1]) / 2.0)
        if not bin_upper_bound or not _check_double_equal_ordered(bin_upper_bound[-1], val):
            bin_upper_bound.append(val)
    bin_upper_bound.append(math.inf)
    return bin_upper_bound


def _find_bin_with_zero_as_one_bin(
    distinct_values: np.ndarray,
    counts: np.ndarray,
    max_bin: int,
    total_sample_cnt: int,
    min_data_in_bin: int,
) -> List[float]:
    """reference: FindBinWithZeroAsOneBin (src/io/bin.cpp:255-312)."""
    num_distinct_values = len(distinct_values)
    left_mask = distinct_values <= -K_ZERO_THRESHOLD
    right_mask = distinct_values > K_ZERO_THRESHOLD
    left_cnt_data = int(counts[left_mask].sum())
    right_cnt_data = int(counts[right_mask].sum())
    cnt_zero = total_sample_cnt - left_cnt_data - right_cnt_data

    nonleft = np.nonzero(~left_mask)[0]
    left_cnt = int(nonleft[0]) if len(nonleft) else num_distinct_values

    bin_upper_bound: List[float] = []
    if left_cnt > 0 and max_bin > 1:
        denom = total_sample_cnt - cnt_zero
        left_max_bin = int(left_cnt_data / denom * (max_bin - 1)) if denom > 0 else 1
        left_max_bin = max(1, left_max_bin)
        bin_upper_bound = greedy_find_bin(
            distinct_values[:left_cnt], counts[:left_cnt], left_max_bin, left_cnt_data, min_data_in_bin
        )
        if bin_upper_bound:
            bin_upper_bound[-1] = -K_ZERO_THRESHOLD

    rights = np.nonzero(right_mask[left_cnt:])[0]
    right_start = left_cnt + int(rights[0]) if len(rights) else -1

    right_max_bin = max_bin - 1 - len(bin_upper_bound)
    if right_start >= 0 and right_max_bin > 0:
        right_bounds = greedy_find_bin(
            distinct_values[right_start:], counts[right_start:], right_max_bin, right_cnt_data, min_data_in_bin
        )
        bin_upper_bound.append(K_ZERO_THRESHOLD)
        bin_upper_bound.extend(right_bounds)
    else:
        bin_upper_bound.append(math.inf)
    assert len(bin_upper_bound) <= max_bin
    return bin_upper_bound


def _find_bin_with_predefined_bin(
    distinct_values: np.ndarray,
    counts: np.ndarray,
    max_bin: int,
    total_sample_cnt: int,
    min_data_in_bin: int,
    forced_upper_bounds: Sequence[float],
) -> List[float]:
    """reference: FindBinWithPredefinedBin (src/io/bin.cpp:157-253)."""
    num_distinct_values = len(distinct_values)
    left_mask = distinct_values <= -K_ZERO_THRESHOLD
    right_mask = distinct_values > K_ZERO_THRESHOLD
    nonleft = np.nonzero(~left_mask)[0]
    left_cnt = int(nonleft[0]) if len(nonleft) else num_distinct_values
    rights = np.nonzero(right_mask[left_cnt:])[0]
    right_start = left_cnt + int(rights[0]) if len(rights) else -1

    bin_upper_bound: List[float] = []
    if max_bin == 2:
        bin_upper_bound.append(K_ZERO_THRESHOLD if left_cnt == 0 else -K_ZERO_THRESHOLD)
    elif max_bin >= 3:
        if left_cnt > 0:
            bin_upper_bound.append(-K_ZERO_THRESHOLD)
        if right_start >= 0:
            bin_upper_bound.append(K_ZERO_THRESHOLD)
    bin_upper_bound.append(math.inf)

    max_to_insert = max_bin - len(bin_upper_bound)
    num_inserted = 0
    for b in forced_upper_bounds:
        if num_inserted >= max_to_insert:
            break
        if abs(b) > K_ZERO_THRESHOLD:
            bin_upper_bound.append(float(b))
            num_inserted += 1
    bin_upper_bound.sort()

    free_bins = max_bin - len(bin_upper_bound)
    bounds_to_add: List[float] = []
    value_ind = 0
    n_fixed = len(bin_upper_bound)
    for i in range(n_fixed):
        cnt_in_bin = 0
        distinct_cnt_in_bin = 0
        bin_start = value_ind
        while value_ind < num_distinct_values and distinct_values[value_ind] < bin_upper_bound[i]:
            cnt_in_bin += int(counts[value_ind])
            distinct_cnt_in_bin += 1
            value_ind += 1
        bins_remaining = max_bin - n_fixed - len(bounds_to_add)
        num_sub_bins = int(round(cnt_in_bin * free_bins / total_sample_cnt))
        num_sub_bins = min(num_sub_bins, bins_remaining) + 1
        if i == n_fixed - 1:
            num_sub_bins = bins_remaining + 1
        new_ub = greedy_find_bin(
            distinct_values[bin_start:bin_start + distinct_cnt_in_bin],
            counts[bin_start:bin_start + distinct_cnt_in_bin],
            num_sub_bins, cnt_in_bin, min_data_in_bin,
        )
        bounds_to_add.extend(new_ub[:-1])  # last bound is inf
    bin_upper_bound.extend(bounds_to_add)
    bin_upper_bound.sort()
    assert len(bin_upper_bound) <= max_bin
    return bin_upper_bound


def _need_filter(cnt_in_bin: List[int], total_cnt: int, filter_cnt: int, bin_type: int) -> bool:
    """reference: NeedFilter (src/io/bin.cpp:54-75)."""
    if bin_type == BinType.NUMERICAL:
        sum_left = 0
        for i in range(len(cnt_in_bin) - 1):
            sum_left += cnt_in_bin[i]
            if sum_left >= filter_cnt and total_cnt - sum_left >= filter_cnt:
                return False
        return True
    else:
        if len(cnt_in_bin) <= 2:
            for i in range(len(cnt_in_bin) - 1):
                if cnt_in_bin[i] >= filter_cnt and total_cnt - cnt_in_bin[i] >= filter_cnt:
                    return False
            return True
        return False


@dataclass
class BinMapper:
    """Per-feature value→bin quantizer.  reference: include/LightGBM/bin.h:61."""

    num_bin: int = 1
    missing_type: int = MissingType.NONE
    is_trivial: bool = True
    sparse_rate: float = 1.0
    bin_type: int = BinType.NUMERICAL
    bin_upper_bound: np.ndarray = field(default_factory=lambda: np.array([np.inf]))
    bin_2_categorical: List[int] = field(default_factory=list)
    categorical_2_bin: Dict[int, int] = field(default_factory=dict)
    min_val: float = 0.0
    max_val: float = 0.0
    default_bin: int = 0
    most_freq_bin: int = 0

    def find_bin(
        self,
        values: np.ndarray,
        total_sample_cnt: int,
        max_bin: int,
        min_data_in_bin: int = 3,
        min_split_data: int = 0,
        pre_filter: bool = False,
        bin_type: int = BinType.NUMERICAL,
        use_missing: bool = True,
        zero_as_missing: bool = False,
        forced_upper_bounds: Sequence[float] = (),
    ) -> None:
        """Fit bin boundaries from sampled values.

        ``values`` are the sampled *non-zero* (or all) values of one feature;
        ``total_sample_cnt`` is the number of sampled rows, so
        ``total_sample_cnt - len(values)`` rows are implicit zeros.
        reference: BinMapper::FindBin (src/io/bin.cpp:327-534).
        """
        values = np.asarray(values, dtype=np.float64)
        num_sample_values = len(values)
        values = values[~np.isnan(values)]
        na_cnt = num_sample_values - len(values)
        if not use_missing:
            self.missing_type = MissingType.NONE
        elif zero_as_missing:
            self.missing_type = MissingType.ZERO
        else:
            self.missing_type = MissingType.NONE if na_cnt == 0 else MissingType.NAN
        if self.missing_type != MissingType.NAN:
            na_cnt = 0  # NaNs fold into the zero bin (reference: bin.cpp:332-347)

        self.bin_type = bin_type
        self.default_bin = 0
        zero_cnt = int(total_sample_cnt - len(values) - na_cnt)

        # distinct values with zero spliced at its sorted position; ties within
        # nextafter() of each other collapse to the larger value
        # (reference: src/io/bin.cpp:358-390).  Vectorized: the loop's
        # CheckDoubleEqualOrdered(prev, cur) compares CONSECUTIVE raw
        # values, so group boundaries are exactly where cur > nextafter(
        # prev, inf); each group's representative is its LAST (largest)
        # member — a chained "collapse to cur" lands there too.  (This was
        # a ~12 s pure-Python loop per 28-feature construct at the default
        # 200k sample.)
        values = np.sort(values, kind="stable")
        if len(values):
            newgrp = values[1:] > np.nextafter(values[:-1], np.inf)
            ends = np.append(np.nonzero(newgrp)[0], len(values) - 1)
            dv = values[ends]                           # last member of group
            ct = np.diff(np.append(-1, ends)).astype(np.int64)
            # splice the implicit-zeros group at its sorted position,
            # mirroring the scalar loop exactly: before everything only
            # when zero_cnt > 0; BETWEEN a negative and a positive group
            # unconditionally (the loop inserts a zero-count group there
            # too); after everything only when zero_cnt > 0.  Sampled
            # values have |v| > kZeroThreshold, so no group spans zero.
            # (arrays end to end — the former .tolist()/.insert round-trip
            # of 200k-element vectors was a measured ~40% of find_bin)
            zpos = None
            if values[0] > 0.0:
                if zero_cnt > 0:
                    zpos = 0
            elif values[-1] < 0.0:
                if zero_cnt > 0:
                    zpos = len(dv)
            elif dv[0] < 0.0 and dv[-1] > 0.0:
                zpos = int(np.searchsorted(dv, 0.0))
            if zpos is not None:
                dv = np.insert(dv, zpos, 0.0)
                ct = np.insert(ct, zpos, zero_cnt)
        else:
            dv = np.array([0.0], np.float64)
            ct = np.array([zero_cnt], np.int64)

        # dv is never empty here: the grouped branch always yields at
        # least one group and the empty-values branch builds the zero
        # group explicitly
        self.min_val = float(dv[0])
        self.max_val = float(dv[-1])
        num_distinct_values = len(dv)
        cnt_in_bin: List[int] = []

        if bin_type == BinType.NUMERICAL:
            forced = sorted(forced_upper_bounds) if len(forced_upper_bounds) else []
            if self.missing_type == MissingType.ZERO:
                ub = self._find_bin_inner(dv, ct, max_bin, total_sample_cnt, min_data_in_bin, forced)
                if len(ub) == 2:
                    self.missing_type = MissingType.NONE
            elif self.missing_type == MissingType.NONE:
                ub = self._find_bin_inner(dv, ct, max_bin, total_sample_cnt, min_data_in_bin, forced)
            else:
                ub = self._find_bin_inner(dv, ct, max_bin - 1, total_sample_cnt - na_cnt, min_data_in_bin, forced)
                ub = ub + [math.nan]
            self.bin_upper_bound = np.asarray(ub, dtype=np.float64)
            self.num_bin = len(ub)
            # count per bin for filtering / most_freq.  The reference
            # loop advances i_bin at most ONCE per distinct value
            # (bin.cpp cnt_in_bin accumulation), which LAGS behind the
            # true bin when forced bounds create consecutive empty bins —
            # that lag is observable (NeedFilter prefix sums,
            # most_freq_bin) and must be mirrored.  Closed form of the
            # recurrence i_bin_i = min(true_i, i_bin_{i-1} + 1) with
            # i_bin_{-1} = 0:  min(i + 1, i + running_min(true_j - j)).
            nb_real = (self.num_bin - 1
                       if self.missing_type == MissingType.NAN
                       else self.num_bin)       # exclude the NaN sentinel
            true_idx = np.minimum(
                np.searchsorted(self.bin_upper_bound[:nb_real], dv,
                                side="left"), nb_real - 1)
            lag = np.arange(len(dv))
            i_bin = np.minimum(
                lag + 1, lag + np.minimum.accumulate(true_idx - lag))
            cnt_vec = np.bincount(i_bin, weights=ct,
                                  minlength=self.num_bin)
            cnt_in_bin = [int(v) for v in cnt_vec]
            if self.missing_type == MissingType.NAN:
                cnt_in_bin[self.num_bin - 1] = na_cnt
            assert self.num_bin <= max_bin
        else:
            # categorical: count-sorted category→bin (src/io/bin.cpp:425-497)
            dvi: List[int] = []
            cti: List[int] = []
            for i in range(num_distinct_values):
                val = int(dv[i])
                if val < 0:
                    na_cnt += int(ct[i])
                else:
                    if not dvi or val != dvi[-1]:
                        dvi.append(val)
                        cti.append(int(ct[i]))
                    else:
                        cti[-1] += int(ct[i])
            self.num_bin = 0
            rest_cnt = total_sample_cnt - na_cnt
            if rest_cnt > 0:
                # sort descending by count, stable (SortForPair)
                order = np.argsort(-np.asarray(cti), kind="stable")
                cti = [cti[j] for j in order]
                dvi = [dvi[j] for j in order]
                if dvi and dvi[0] == 0:
                    if len(cti) == 1:
                        cti.append(0)
                        dvi.append(dvi[0] + 1)
                    cti[0], cti[1] = cti[1], cti[0]
                    dvi[0], dvi[1] = dvi[1], dvi[0]
                cut_cnt = int((total_sample_cnt - na_cnt) * 0.99)
                cur_cat = 0
                self.categorical_2_bin = {}
                self.bin_2_categorical = []
                used_cnt = 0
                max_bin_c = min(len(dvi), max_bin)
                cnt_in_bin = []
                while cur_cat < len(dvi) and (used_cnt < cut_cnt or self.num_bin < max_bin_c):
                    if cti[cur_cat] < min_data_in_bin and cur_cat > 1:
                        break
                    self.bin_2_categorical.append(dvi[cur_cat])
                    self.categorical_2_bin[dvi[cur_cat]] = self.num_bin
                    used_cnt += cti[cur_cat]
                    cnt_in_bin.append(cti[cur_cat])
                    self.num_bin += 1
                    cur_cat += 1
                if cur_cat == len(dvi) and na_cnt > 0:
                    self.bin_2_categorical.append(-1)
                    self.categorical_2_bin[-1] = self.num_bin
                    cnt_in_bin.append(0)
                    self.num_bin += 1
                if cur_cat == len(dvi) and na_cnt == 0:
                    self.missing_type = MissingType.NONE
                else:
                    self.missing_type = MissingType.NAN
                if cnt_in_bin:
                    cnt_in_bin[-1] += total_sample_cnt - used_cnt

        self.is_trivial = self.num_bin <= 1
        if not self.is_trivial and pre_filter and _need_filter(
            cnt_in_bin, total_sample_cnt, min_split_data, self.bin_type
        ):
            self.is_trivial = True

        if not self.is_trivial:
            self.default_bin = int(self.value_to_bin(np.array([0.0]))[0])
            self.most_freq_bin = int(np.argmax(cnt_in_bin))
            if self.bin_type == BinType.CATEGORICAL and self.most_freq_bin == 0:
                self.most_freq_bin = 1
            max_sparse_rate = cnt_in_bin[self.most_freq_bin] / total_sample_cnt
            if self.most_freq_bin != self.default_bin and max_sparse_rate < K_SPARSE_THRESHOLD:
                self.most_freq_bin = self.default_bin
            self.sparse_rate = cnt_in_bin[self.most_freq_bin] / total_sample_cnt
        else:
            self.sparse_rate = 1.0

    @staticmethod
    def _find_bin_inner(dv, ct, max_bin, total_cnt, min_data_in_bin, forced) -> List[float]:
        if forced:
            return _find_bin_with_predefined_bin(dv, ct, max_bin, total_cnt, min_data_in_bin, forced)
        return _find_bin_with_zero_as_one_bin(dv, ct, max_bin, total_cnt, min_data_in_bin)

    # ---- (de)serialization: the binary cache's mapper records, as the
    #      JAX package writes them ---------------------------------------

    def to_dict(self) -> dict:
        d = {
            "num_bin": self.num_bin,
            "missing_type": self.missing_type,
            "is_trivial": self.is_trivial,
            "sparse_rate": self.sparse_rate,
            "bin_type": self.bin_type,
            "min_val": self.min_val,
            "max_val": self.max_val,
            "default_bin": self.default_bin,
            "most_freq_bin": self.most_freq_bin,
        }
        if self.bin_type == BinType.NUMERICAL:
            d["bin_upper_bound"] = [float(x) for x in self.bin_upper_bound]
        else:
            d["bin_2_categorical"] = list(self.bin_2_categorical)
        return d

    @staticmethod
    def from_dict(d: dict) -> "BinMapper":
        m = BinMapper(**{k: d[k] for k in (
            "num_bin", "missing_type", "is_trivial", "sparse_rate",
            "bin_type", "min_val", "max_val", "default_bin",
            "most_freq_bin")})
        if m.bin_type == BinType.NUMERICAL:
            m.bin_upper_bound = np.asarray(d["bin_upper_bound"],
                                           dtype=np.float64)
        else:
            m.bin_2_categorical = list(d["bin_2_categorical"])
            m.categorical_2_bin = {c: i for i, c in
                                   enumerate(m.bin_2_categorical)}
        return m

    # ---- application -------------------------------------------------------

    def value_to_bin(self, values: np.ndarray) -> np.ndarray:
        """Vectorized value→bin (reference: BinMapper::ValueToBin bin.h:457-493)."""
        values = np.asarray(values, dtype=np.float64)
        if self.bin_type == BinType.NUMERICAL:
            nan_mask = np.isnan(values)
            v = np.where(nan_mask, 0.0, values)
            r = self.num_bin - 1
            if self.missing_type == MissingType.NAN:
                r -= 1
            # first index i in [0, r) with v <= ub[i], else r
            bins = np.searchsorted(self.bin_upper_bound[:r], v, side="left").astype(np.int32)
            if self.missing_type == MissingType.NAN:
                bins = np.where(nan_mask, self.num_bin - 1, bins)
            return bins
        else:
            nan_bin = self.num_bin - 1
            out = np.full(values.shape, nan_bin, dtype=np.int32)
            iv = np.where(np.isnan(values), -1, values).astype(np.int64)
            cats = np.asarray(self.bin_2_categorical, dtype=np.int64)
            bins_for_cat = np.arange(len(cats), dtype=np.int32)
            order = np.argsort(cats)
            sorted_cats = cats[order]
            pos = np.searchsorted(sorted_cats, iv)
            pos_c = np.clip(pos, 0, len(cats) - 1)
            found = (sorted_cats[pos_c] == iv) & (iv >= 0)
            out[found] = bins_for_cat[order][pos_c[found]]
            return out
