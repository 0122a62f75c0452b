"""Quantile binning: raw feature values -> small integer bins.

Counterpart of ``lightgbm_tpu/binning.py`` (numpy path): numeric features
take equal-count greedy bins from a row sample with bin boundaries at
midpoints between distinct values, zero in a bin of its own, and NaN in a
dedicated last bin when the sample holds NaNs; categorical features
(:380-415) take a bin a category, by descending count, cut at 99% of the
count and at ``max_bin``.  The greedy loops run over Python
lists, which gives the same float64 arithmetic as the reference's numpy
scalars at a fraction of the interpreter cost.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

K_ZERO_THRESHOLD = 1e-35


class MissingType:
    NONE = 0
    ZERO = 1
    NAN = 2


def _greedy_find_bin(
    distinct_values: np.ndarray,
    counts: np.ndarray,
    max_bin: int,
    total_sample_cnt: int,
    min_data_in_bin: int,
) -> List[float]:
    """Equal-count greedy binning over sorted distinct values; returns the
    bin upper bounds, the last being +inf (reference GreedyFindBin)."""
    n = len(distinct_values)
    if n == 0:
        return []
    dv = distinct_values.tolist()
    cnt = counts.tolist()
    if n <= max_bin:
        # every distinct value its own bin, but honor min_data_in_bin
        bounds: List[float] = []
        cur_cnt = 0
        for i in range(n - 1):
            cur_cnt += cnt[i]
            if cur_cnt >= min_data_in_bin or max_bin >= n:
                bounds.append((dv[i] + dv[i + 1]) / 2.0)
                cur_cnt = 0
        bounds.append(np.inf)
        return bounds

    # more distinct values than bins: greedy equal-count with heavy values
    # forced into their own bin
    max_bin = max(1, max_bin)
    mean_bin_size = total_sample_cnt / max_bin
    is_big_np = counts >= mean_bin_size
    big_suffix = np.concatenate(
        [np.cumsum(is_big_np[::-1])[::-1], np.zeros(1, np.int64)]
    ).tolist()
    is_big = is_big_np.tolist()
    rest_cnt = total_sample_cnt - counts[is_big_np].sum()
    rest_bins = max_bin - int(is_big_np.sum())
    if rest_bins > 0:
        mean_bin_size = rest_cnt / rest_bins
    bounds = []
    cur_cnt = 0
    remaining_bins = max_bin
    for i in range(n - 1):
        if not is_big[i]:
            rest_cnt -= cnt[i]
        cur_cnt += cnt[i]
        # close the bin if it is full enough, or the next value is heavy
        if (
            is_big[i]
            or cur_cnt >= mean_bin_size
            or (is_big[i + 1] and cur_cnt >= max(1.0, mean_bin_size * 0.5))
        ):
            bounds.append((dv[i] + dv[i + 1]) / 2.0)
            cur_cnt = 0
            remaining_bins -= 1
            if remaining_bins <= 1:
                break
            if not is_big[i] and rest_bins > 0:
                rest_bins_left = remaining_bins - int(big_suffix[i + 1])
                if rest_bins_left > 0:
                    mean_bin_size = max(1.0, rest_cnt / rest_bins_left)
    bounds.append(np.inf)
    return bounds


def _find_bin_zero_as_one(
    values: np.ndarray, counts_total: int, max_bin: int, min_data_in_bin: int
) -> List[float]:
    """Numerical binning with zero forced into its own bin: negatives and
    positives are binned separately with the bin budget split by count
    (reference FindBinWithZeroAsOneBin)."""
    values = values[np.isfinite(values)]
    neg = values[values < -K_ZERO_THRESHOLD]
    pos = values[values > K_ZERO_THRESHOLD]
    n_zero = counts_total - len(neg) - len(pos)
    n_total = counts_total
    if n_total == 0:
        return [np.inf]
    budget = max_bin - 1  # one bin reserved for zero
    n_neg, n_pos = len(neg), len(pos)
    if n_neg + n_pos == 0:
        return [np.inf]
    neg_bins = int(round(budget * (n_neg / n_total))) if n_neg > 0 else 0
    if n_neg > 0:
        neg_bins = max(1, neg_bins)
    pos_bins = budget - neg_bins
    if n_pos > 0:
        pos_bins = max(1, pos_bins)

    bounds: List[float] = []
    if n_neg > 0:
        dv, cnt = np.unique(neg, return_counts=True)
        b = _greedy_find_bin(dv, cnt, max(1, neg_bins), n_neg, min_data_in_bin)
        # last bound of the negative side closes at the zero band
        if b:
            b[-1] = -K_ZERO_THRESHOLD
            bounds.extend(b)
        else:
            bounds.append(-K_ZERO_THRESHOLD)
    if n_zero > 0 or (n_neg > 0 and n_pos > 0):
        bounds.append(K_ZERO_THRESHOLD)
    if n_pos > 0:
        dv, cnt = np.unique(pos, return_counts=True)
        bounds.extend(
            _greedy_find_bin(dv, cnt, max(1, pos_bins), n_pos, min_data_in_bin)
        )
    if not bounds or bounds[-1] != np.inf:
        bounds.append(np.inf)
    out: List[float] = []
    for x in bounds:  # dedupe while preserving order
        if not out or x > out[-1]:
            out.append(x)
    return out


@dataclasses.dataclass
class BinMapper:
    """Per-feature value -> bin mapping (reference include/LightGBM/bin.h:85).
    A categorical mapper's bin b holds category ``bin_to_cat[b]``."""

    bin_upper_bound: np.ndarray  # [num_numeric_bins] float64, last == +inf
    missing_type: int = MissingType.NONE
    num_bins: int = 1  # total bins incl. the NaN bin if present
    nan_bin: int = -1  # bin index NaN maps to, -1 if none
    min_value: float = 0.0  # the sample's smallest and largest finite values
    max_value: float = 0.0
    is_categorical: bool = False
    cat_to_bin: Optional[Dict[int, int]] = None  # category -> bin
    bin_to_cat: Optional[np.ndarray] = None  # [kept categories] i64, by bin

    @property
    def is_trivial(self) -> bool:
        return self.num_bins <= 1

    @classmethod
    def from_sample(
        cls, values: np.ndarray, max_bin: int, *, min_data_in_bin: int = 3,
        is_categorical: bool = False,
    ) -> "BinMapper":
        values = np.asarray(values, dtype=np.float64).ravel()
        nan_mask = np.isnan(values)
        has_nan = bool(nan_mask.any())
        finite = values[~nan_mask]
        if is_categorical:
            return cls._from_sample_categorical(finite, max_bin, has_nan)
        missing_type = MissingType.NAN if has_nan else MissingType.NONE
        if len(finite) == 0:
            if has_nan:
                return cls(np.array([np.inf]), MissingType.NAN, 2, 1)
            return cls(np.array([np.inf]))
        bounds = _find_bin_zero_as_one(
            finite, len(values) - int(nan_mask.sum()), max_bin, min_data_in_bin
        )
        num_bins = len(bounds)
        nan_bin = -1
        if missing_type == MissingType.NAN:
            nan_bin = num_bins
            num_bins += 1
        return cls(np.asarray(bounds, np.float64), missing_type, num_bins, nan_bin,
                   float(finite.min()), float(finite.max()))

    @classmethod
    def _from_sample_categorical(cls, finite: np.ndarray, max_bin: int,
                                 has_nan_bin: bool) -> "BinMapper":
        """Categories (values truncated to integers) by descending count,
        ties in ascending value (a stable sort), kept while the ones before
        hold less than 99% of the count and up to ``max_bin`` bins (one
        less with a NaN bin), the NaN bin after them
        (lightgbm_tpu/binning.py:380-415)."""
        cats = finite.astype(np.int64)
        if len(cats) == 0:
            return cls(np.array([np.inf]), is_categorical=True)
        if cats.min() < 0:
            raise ValueError("categorical feature values must be non-negative")
        uniq, cnt = np.unique(cats, return_counts=True)
        order = np.argsort(-cnt, kind="stable")
        uniq, cnt = uniq[order], cnt[order]
        cutoff = 0.99 * cnt.sum()
        keep = min(len(uniq), max_bin - (1 if has_nan_bin else 0))
        csum = np.cumsum(cnt)
        while keep > 1 and csum[keep - 1] - cnt[keep - 1] >= cutoff:
            keep -= 1
        uniq = uniq[:keep]
        num_bins, nan_bin = keep, -1
        if has_nan_bin:
            nan_bin, num_bins = keep, keep + 1
        return cls(
            np.array([np.inf]),
            MissingType.NAN if has_nan_bin else MissingType.NONE,
            num_bins, nan_bin, float(uniq.min()), float(uniq.max()),
            is_categorical=True,
            cat_to_bin={int(c): i for i, c in enumerate(uniq)},
            bin_to_cat=uniq.copy(),
        )

    def values_to_bins(self, values: np.ndarray) -> np.ndarray:
        """Vectorized value -> bin (reference BinMapper::ValueToBin).  A
        categorical value is truncated to an integer; one outside the kept
        categories takes bin 0, NaN the NaN bin (the training-time rule of
        lightgbm_tpu/binning.py:420-433; predict sends unseen categories
        right by a sentinel bin instead, ``categorical_bins``)."""
        values = np.asarray(values, dtype=np.float64).ravel()
        if self.is_categorical:
            out = np.zeros(len(values), dtype=np.int32)
            nan_mask = np.isnan(values)
            iv = np.where(nan_mask, 0, values).astype(np.int64)
            if self.bin_to_cat is not None and len(self.bin_to_cat):
                sorter = np.argsort(self.bin_to_cat)
                sorted_cats = self.bin_to_cat[sorter]
                pos = np.clip(np.searchsorted(sorted_cats, iv), 0, len(sorted_cats) - 1)
                out = np.where(sorted_cats[pos] == iv, sorter[pos], 0).astype(np.int32)
            if self.nan_bin >= 0:
                out[nan_mask] = self.nan_bin
            return out
        nan_mask = np.isnan(values)
        safe = np.where(nan_mask, 0.0, values)
        out = np.searchsorted(self.bin_upper_bound, safe, side="left").astype(np.int32)
        if self.missing_type == MissingType.ZERO:
            out[nan_mask | (np.abs(values) <= K_ZERO_THRESHOLD)] = self.nan_bin
        elif self.missing_type == MissingType.NAN and self.nan_bin >= 0:
            out[nan_mask] = self.nan_bin
        return out

    def feature_info_str(self) -> str:
        """The feature's ``feature_infos`` entry of the model text."""
        if self.is_trivial:
            return "none"
        if self.is_categorical:  # the kept categories, ascending
            cats = sorted(int(c) for c in (self.bin_to_cat if self.bin_to_cat is not None else []))
            return ":".join(str(c) for c in cats)
        return f"[{self.min_value:g}:{self.max_value:g}]"

    def bin_to_threshold(self, bin_idx: int) -> float:
        """Real-valued split threshold for 'bin <= bin_idx goes left'."""
        if self.is_categorical:
            raise ValueError("categorical bins have no scalar threshold")
        b = int(bin_idx)
        if b >= len(self.bin_upper_bound) - 1:
            return float(self.bin_upper_bound[-2]) if len(self.bin_upper_bound) > 1 else 0.0
        return float(self.bin_upper_bound[b])


def categorical_bins(mapper: BinMapper, values: np.ndarray, sentinel: int) -> np.ndarray:
    """Predict-time bins of a categorical column: ``values_to_bins``, but a
    value outside the kept categories (unseen, negative, fractional parts
    aside), or NaN without a NaN bin, takes ``sentinel``, a bin no
    categorical node sends left, so it goes right (reference
    CategoricalDecision, tree.h:382; lightgbm_tpu/boosting/gbdt.py:3118-3129)."""
    vals = np.asarray(values, np.float64).ravel()
    b = mapper.values_to_bins(vals)
    nan_mask = np.isnan(vals)
    iv = np.where(nan_mask, -1, vals).astype(np.int64)
    known = np.isin(iv, mapper.bin_to_cat) & (iv >= 0)
    return np.where(known | (nan_mask & (mapper.nan_bin >= 0)), b, sentinel).astype(np.int32)
