# Port copy of lightgbm_tpu/binning.py: the port keeps its own numpy-only copy so
# that importing it never runs lightgbm_tpu/__init__.py (which imports JAX).
"""Per-feature value→bin quantization (host side, numpy).

TPU-native re-design of the reference binning layer
(`include/LightGBM/bin.h:61-209`, `src/io/bin.cpp:49-420`).  Semantics are kept
bit-parity-close because bin boundaries are the root of all downstream numeric
parity:

  * ``GreedyFindBin`` (`src/io/bin.cpp:72-150`) — count-balanced greedy bins
    over distinct sample values, midpoint upper bounds nudged with
    ``nextafter`` (`utils/common.h:836-843`).
  * ``FindBinWithZeroAsOneBin`` (`src/io/bin.cpp:152-205`) — zero gets a
    dedicated bin ``(-kZeroThreshold, kZeroThreshold]``; negatives/positives
    get proportional bin budgets.
  * Missing handling (`bin.h:22-26`): MissingType None / Zero / NaN; NaN bin is
    the last bin when present.
  * Categorical: count-sorted, 99% mass cutoff, NaN→last bin
    (`src/io/bin.cpp:303-377`).

Unlike the reference there is no sparse/dense bin storage zoo here — the
binned matrix is always a dense uint8/uint16 array (TPUs want dense); see
``lightgbm_tpu/dataset.py``.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

kZeroThreshold = 1e-35  # `include/LightGBM/meta.h:40`
kEpsilon = 1e-15        # `include/LightGBM/meta.h:38`

MISSING_NONE = 0
MISSING_ZERO = 1
MISSING_NAN = 2

BIN_NUMERICAL = 0
BIN_CATEGORICAL = 1

_MISSING_NAMES = {MISSING_NONE: "none", MISSING_ZERO: "zero", MISSING_NAN: "nan"}


def _check_double_equal_ordered(a: float, b: float) -> bool:
    return b <= np.nextafter(a, np.inf)


def _double_upper_bound(a: float) -> float:
    return float(np.nextafter(a, np.inf))


def greedy_find_bin(distinct_values: np.ndarray, counts: np.ndarray,
                    max_bin: int, total_cnt: int, min_data_in_bin: int) -> List[float]:
    """Port of ``GreedyFindBin`` (`src/io/bin.cpp:72-150`)."""
    num_distinct = len(distinct_values)
    bin_upper_bound: List[float] = []
    assert max_bin > 0
    if num_distinct <= max_bin:
        cur_cnt_inbin = 0
        for i in range(num_distinct - 1):
            cur_cnt_inbin += int(counts[i])
            if cur_cnt_inbin >= min_data_in_bin:
                val = _double_upper_bound((distinct_values[i] + distinct_values[i + 1]) / 2.0)
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
    is_big = counts >= mean_bin_size
    rest_bin_cnt -= int(is_big.sum())
    rest_sample_cnt -= int(counts[is_big].sum())
    mean_bin_size = rest_sample_cnt / rest_bin_cnt if rest_bin_cnt else math.inf

    upper_bounds = [math.inf] * max_bin
    lower_bounds = [math.inf] * max_bin
    bin_cnt = 0
    lower_bounds[0] = float(distinct_values[0])
    cur_cnt_inbin = 0
    for i in range(num_distinct - 1):
        if not is_big[i]:
            rest_sample_cnt -= int(counts[i])
        cur_cnt_inbin += int(counts[i])
        if (is_big[i] or cur_cnt_inbin >= mean_bin_size or
                (is_big[i + 1] and cur_cnt_inbin >= max(1.0, mean_bin_size * np.float32(0.5)))):
            upper_bounds[bin_cnt] = float(distinct_values[i])
            bin_cnt += 1
            lower_bounds[bin_cnt] = float(distinct_values[i + 1])
            if bin_cnt >= max_bin - 1:
                break
            cur_cnt_inbin = 0
            if not is_big[i]:
                rest_bin_cnt -= 1
                mean_bin_size = rest_sample_cnt / rest_bin_cnt if rest_bin_cnt else math.inf
    bin_cnt += 1
    for i in range(bin_cnt - 1):
        val = _double_upper_bound((upper_bounds[i] + lower_bounds[i + 1]) / 2.0)
        if not bin_upper_bound or not _check_double_equal_ordered(bin_upper_bound[-1], val):
            bin_upper_bound.append(val)
    bin_upper_bound.append(math.inf)
    return bin_upper_bound


def find_bin_with_zero_as_one_bin(distinct_values: np.ndarray, counts: np.ndarray,
                                  max_bin: int, total_sample_cnt: int,
                                  min_data_in_bin: int) -> List[float]:
    """Port of ``FindBinWithZeroAsOneBin`` (`src/io/bin.cpp:152-205`)."""
    num_distinct = len(distinct_values)
    left_cnt_data = int(counts[distinct_values <= -kZeroThreshold].sum())
    cnt_zero = int(counts[(distinct_values > -kZeroThreshold)
                          & (distinct_values <= kZeroThreshold)].sum())
    right_cnt_data = int(counts[distinct_values > kZeroThreshold].sum())

    left_cnt = -1
    for i in range(num_distinct):
        if distinct_values[i] > -kZeroThreshold:
            left_cnt = i
            break
    if left_cnt < 0:
        left_cnt = num_distinct

    bin_upper_bound: List[float] = []
    if left_cnt > 0:
        denom = total_sample_cnt - cnt_zero
        left_max_bin = int(left_cnt_data / denom * (max_bin - 1)) if denom else 1
        left_max_bin = max(1, left_max_bin)
        bin_upper_bound = greedy_find_bin(distinct_values[:left_cnt], counts[:left_cnt],
                                          left_max_bin, left_cnt_data, min_data_in_bin)
        bin_upper_bound[-1] = -kZeroThreshold

    right_start = -1
    for i in range(left_cnt, num_distinct):
        if distinct_values[i] > kZeroThreshold:
            right_start = i
            break

    if right_start >= 0:
        right_max_bin = max_bin - 1 - len(bin_upper_bound)
        assert right_max_bin > 0
        right_bounds = greedy_find_bin(distinct_values[right_start:], counts[right_start:],
                                       right_max_bin, right_cnt_data, min_data_in_bin)
        bin_upper_bound.append(kZeroThreshold)
        bin_upper_bound.extend(right_bounds)
    else:
        bin_upper_bound.append(math.inf)
    return bin_upper_bound


def _need_filter(cnt_in_bin: Sequence[int], total_cnt: int, filter_cnt: int,
                 bin_type: int) -> bool:
    """Port of ``NeedFilter`` (`src/io/bin.cpp:49-70`)."""
    if bin_type == BIN_NUMERICAL:
        sum_left = 0
        for i in range(len(cnt_in_bin) - 1):
            sum_left += cnt_in_bin[i]
            if sum_left >= filter_cnt and total_cnt - sum_left >= filter_cnt:
                return False
        return True
    if len(cnt_in_bin) <= 2:
        for i in range(len(cnt_in_bin) - 1):
            if cnt_in_bin[i] >= filter_cnt and total_cnt - cnt_in_bin[i] >= filter_cnt:
                return False
        return True
    return False


class BinMapper:
    """One feature's value→bin mapping (reference ``BinMapper``, `bin.h:61-209`)."""

    def __init__(self) -> None:
        self.num_bin: int = 1
        self.missing_type: int = MISSING_NONE
        self.is_trivial: bool = True
        self.sparse_rate: float = 1.0
        self.bin_type: int = BIN_NUMERICAL
        self.bin_upper_bound: np.ndarray = np.array([np.inf])
        self.bin_2_categorical: List[int] = []
        self.categorical_2_bin: Dict[int, int] = {}
        self.min_val: float = 0.0
        self.max_val: float = 0.0
        self.default_bin: int = 0

    # -- construction: port of BinMapper::FindBin (`src/io/bin.cpp:207-420`) --

    def find_bin(self, values: np.ndarray, total_sample_cnt: int, max_bin: int,
                 min_data_in_bin: int, min_split_data: int,
                 bin_type: int = BIN_NUMERICAL, use_missing: bool = True,
                 zero_as_missing: bool = False) -> None:
        values = np.asarray(values, dtype=np.float64)
        num_sample_values = len(values)
        non_nan = values[~np.isnan(values)]
        na_cnt = 0
        if not use_missing:
            self.missing_type = MISSING_NONE
        elif zero_as_missing:
            self.missing_type = MISSING_ZERO
        else:
            if len(non_nan) == num_sample_values:
                self.missing_type = MISSING_NONE
            else:
                self.missing_type = MISSING_NAN
                na_cnt = num_sample_values - len(non_nan)
        values = non_nan
        self.bin_type = bin_type
        self.default_bin = 0
        zero_cnt = int(total_sample_cnt - len(values) - na_cnt)

        # distinct values with zero injected at its sorted position
        # (`src/io/bin.cpp:236-270`); equal-within-1ulp values merge keeping the
        # larger one.
        values = np.sort(values, kind="stable")
        distinct_values: List[float] = []
        counts: List[int] = []
        if len(values) == 0 or (values[0] > 0.0 and zero_cnt > 0):
            distinct_values.append(0.0)
            counts.append(zero_cnt)
        if len(values) > 0:
            distinct_values.append(float(values[0]))
            counts.append(1)
        for i in range(1, len(values)):
            prev, cur = values[i - 1], values[i]
            if not _check_double_equal_ordered(prev, cur):
                if prev < 0.0 and cur > 0.0:
                    distinct_values.append(0.0)
                    counts.append(zero_cnt)
                distinct_values.append(float(cur))
                counts.append(1)
            else:
                distinct_values[-1] = float(cur)
                counts[-1] += 1
        if len(values) > 0 and values[-1] < 0.0 and zero_cnt > 0:
            distinct_values.append(0.0)
            counts.append(zero_cnt)

        dv = np.asarray(distinct_values)
        ct = np.asarray(counts)
        self.min_val = float(dv[0]) if len(dv) else 0.0
        self.max_val = float(dv[-1]) if len(dv) else 0.0
        cnt_in_bin: List[int] = []
        num_distinct = len(dv)

        if bin_type == BIN_NUMERICAL:
            if self.missing_type == MISSING_ZERO:
                bounds = find_bin_with_zero_as_one_bin(dv, ct, max_bin,
                                                       total_sample_cnt, min_data_in_bin)
                if len(bounds) == 2:
                    self.missing_type = MISSING_NONE
            elif self.missing_type == MISSING_NONE:
                bounds = find_bin_with_zero_as_one_bin(dv, ct, max_bin,
                                                       total_sample_cnt, min_data_in_bin)
            else:  # NaN: reserve last bin for NaN (`src/io/bin.cpp:283-286`)
                bounds = find_bin_with_zero_as_one_bin(dv, ct, max_bin - 1,
                                                       total_sample_cnt - na_cnt,
                                                       min_data_in_bin)
                bounds.append(math.nan)
            self.bin_upper_bound = np.asarray(bounds, dtype=np.float64)
            self.num_bin = len(bounds)
            # count per bin for trivial-feature filtering (`src/io/bin.cpp:289-301`)
            cnt_in_bin = [0] * self.num_bin
            i_bin = 0
            for i in range(num_distinct):
                if dv[i] > self.bin_upper_bound[i_bin]:
                    i_bin += 1
                cnt_in_bin[i_bin] += int(ct[i])
            if self.missing_type == MISSING_NAN:
                cnt_in_bin[self.num_bin - 1] = na_cnt
            assert self.num_bin <= max_bin
        else:
            # categorical: count-sorted cut at 99% mass (`src/io/bin.cpp:303-377`)
            dv_int: List[int] = []
            ct_int: List[int] = []
            for i in range(num_distinct):
                val = int(dv[i])
                if val < 0:
                    na_cnt += int(ct[i])
                else:
                    if not dv_int or val != dv_int[-1]:
                        dv_int.append(val)
                        ct_int.append(int(ct[i]))
                    else:
                        ct_int[-1] += int(ct[i])
            self.num_bin = 0
            rest_cnt = total_sample_cnt - na_cnt
            if rest_cnt > 0:
                order = sorted(range(len(dv_int)), key=lambda i: -ct_int[i])
                dv_int = [dv_int[i] for i in order]
                ct_int = [ct_int[i] for i in order]
                if dv_int and dv_int[0] == 0:
                    if len(ct_int) == 1:
                        ct_int.append(0)
                        dv_int.append(dv_int[0] + 1)
                    ct_int[0], ct_int[1] = ct_int[1], ct_int[0]
                    dv_int[0], dv_int[1] = dv_int[1], dv_int[0]
                cut_cnt = int((total_sample_cnt - na_cnt) * np.float32(0.99))
                self.categorical_2_bin = {}
                self.bin_2_categorical = []
                used_cnt = 0
                max_bin_c = min(len(dv_int), max_bin)
                cnt_in_bin = []
                cur_cat = 0
                while cur_cat < len(dv_int) and (used_cnt < cut_cnt or self.num_bin < max_bin_c):
                    if ct_int[cur_cat] < min_data_in_bin and cur_cat > 1:
                        break
                    self.bin_2_categorical.append(dv_int[cur_cat])
                    self.categorical_2_bin[dv_int[cur_cat]] = self.num_bin
                    used_cnt += ct_int[cur_cat]
                    cnt_in_bin.append(ct_int[cur_cat])
                    self.num_bin += 1
                    cur_cat += 1
                if cur_cat == len(dv_int) and na_cnt > 0:
                    self.bin_2_categorical.append(-1)
                    self.categorical_2_bin[-1] = self.num_bin
                    cnt_in_bin.append(0)
                    self.num_bin += 1
                if cur_cat == len(dv_int) and na_cnt == 0:
                    self.missing_type = MISSING_NONE
                elif na_cnt == 0:
                    self.missing_type = MISSING_ZERO
                else:
                    self.missing_type = MISSING_NAN
                if cnt_in_bin:
                    cnt_in_bin[-1] += total_sample_cnt - used_cnt

        self.is_trivial = self.num_bin <= 1
        if not self.is_trivial and _need_filter(cnt_in_bin, total_sample_cnt,
                                                min_split_data, bin_type):
            self.is_trivial = True
        if not self.is_trivial:
            self.default_bin = int(self.value_to_bin(0.0))
            if bin_type == BIN_CATEGORICAL:
                assert self.default_bin > 0
            self.sparse_rate = cnt_in_bin[self.default_bin] / total_sample_cnt
        else:
            self.sparse_rate = 1.0

    # -- lookup: port of BinMapper::ValueToBin (`bin.h:457-493`) -------------

    def value_to_bin(self, value: float) -> int:
        if math.isnan(value):
            if self.missing_type == MISSING_NAN:
                return self.num_bin - 1
            value = 0.0
        if self.bin_type == BIN_NUMERICAL:
            r = self.num_bin - 1
            if self.missing_type == MISSING_NAN:
                r -= 1
            # same binary search as reference: first bin with value <= ub
            return int(np.searchsorted(self.bin_upper_bound[:r], value, side="left"))
        int_value = int(value)
        if int_value < 0:
            return self.num_bin - 1
        return self.categorical_2_bin.get(int_value, self.num_bin - 1)

    def values_to_bins(self, values: np.ndarray) -> np.ndarray:
        """Vectorized ``ValueToBin`` over a column."""
        values = np.asarray(values, dtype=np.float64)
        if self.bin_type == BIN_NUMERICAL:
            nan_mask = np.isnan(values)
            v = np.where(nan_mask, 0.0, values)
            r = self.num_bin - 1
            if self.missing_type == MISSING_NAN:
                r -= 1
            bins = np.searchsorted(self.bin_upper_bound[:r], v, side="left")
            if self.missing_type == MISSING_NAN:
                bins = np.where(nan_mask, self.num_bin - 1, bins)
            return bins.astype(np.int32)
        nan_mask = np.isnan(values)
        iv = np.where(nan_mask, -1, values).astype(np.int64)
        lut_max = max(self.categorical_2_bin.keys(), default=0)
        lut = np.full(lut_max + 2, self.num_bin - 1, dtype=np.int32)
        for cat, b in self.categorical_2_bin.items():
            if cat >= 0:
                lut[cat] = b
        out = np.where((iv < 0) | (iv > lut_max), self.num_bin - 1, lut[np.clip(iv, 0, lut_max)])
        return out.astype(np.int32)

    def values_to_bins_predict(self, values: np.ndarray,
                               oov_bin: int) -> np.ndarray:
        """Binning with RAW-prediction semantics for categorical features
        (``Tree::CategoricalDecision``, `tree.h:250-268`): unseen or
        negative categories map to ``oov_bin`` (beyond every split bitset →
        always right), and NaN maps to the NaN bin under missing_type NaN
        (never inside a bitset — ``used_bin`` excludes it) or to category
        0's bin otherwise.  Numerical features bin normally (thresholds are
        bin upper bounds, so raw and binned compares agree exactly)."""
        if self.bin_type == BIN_NUMERICAL:
            return self.values_to_bins(values)
        values = np.asarray(values, dtype=np.float64)
        nan_mask = np.isnan(values)
        iv = np.where(nan_mask, 0, values).astype(np.int64)
        lut_max = max(self.categorical_2_bin.keys(), default=0)
        lut = np.full(lut_max + 2, oov_bin, dtype=np.int32)
        for cat, b in self.categorical_2_bin.items():
            if cat >= 0:
                lut[cat] = b
        out = np.where((iv < 0) | (iv > lut_max), oov_bin,
                       lut[np.clip(iv, 0, lut_max)])
        if self.missing_type == MISSING_NAN:
            # raw categorical prediction always sends NaN right
            # (`tree.h:255-258`) — the sentinel guarantees that even when a
            # truncated vocabulary left no dedicated NaN bin
            out = np.where(nan_mask, oov_bin, out)
        return out.astype(np.int32)

    def bin_to_value(self, bin_idx: int) -> float:
        """Representative value for a bin (used in model text thresholds)."""
        if self.bin_type == BIN_NUMERICAL:
            return float(self.bin_upper_bound[bin_idx])
        return float(self.bin_2_categorical[bin_idx])

    # -- serialization (binary dataset format / distributed allgather) ------

    def to_dict(self) -> Dict:
        return {
            "num_bin": self.num_bin, "missing_type": self.missing_type,
            "is_trivial": self.is_trivial, "sparse_rate": self.sparse_rate,
            "bin_type": self.bin_type,
            "bin_upper_bound": self.bin_upper_bound.tolist(),
            "bin_2_categorical": list(self.bin_2_categorical),
            "min_val": self.min_val, "max_val": self.max_val,
            "default_bin": self.default_bin,
        }

    @classmethod
    def from_dict(cls, d: Dict) -> "BinMapper":
        m = cls()
        m.num_bin = int(d["num_bin"])
        m.missing_type = int(d["missing_type"])
        m.is_trivial = bool(d["is_trivial"])
        m.sparse_rate = float(d["sparse_rate"])
        m.bin_type = int(d["bin_type"])
        m.bin_upper_bound = np.asarray(d["bin_upper_bound"], dtype=np.float64)
        m.bin_2_categorical = [int(x) for x in d["bin_2_categorical"]]
        m.categorical_2_bin = {c: i for i, c in enumerate(m.bin_2_categorical)}
        m.min_val = float(d["min_val"])
        m.max_val = float(d["max_val"])
        m.default_bin = int(d["default_bin"])
        return m
