"""Best-split search over a leaf histogram (basic numeric path).

Counterpart of ``lightgbm_tpu/ops/split.py``: ``threshold_l1``,
``leaf_gain``, ``leaf_output``, ``SplitCandidate`` and ``best_split`` (:108)
without the categorical, monotone, CEGB, path-smoothing and extra-trees
options.  Gains for every (missing direction, feature, bin) candidate are
evaluated at once and the first maximum wins, in the JAX package's order
(missing-right candidates of every feature first).

``best_split`` is the plain version of the split-scan kernel
(``ops/split_scan.py``): both compute the same candidate from the same
histogram, and the grower reaches the kernel through ``fused_best_split``.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

_EPS = 1e-15
PREFIX_BLOCK = 16


def threshold_l1(g, l1: float):
    return torch.sign(g) * torch.clamp(torch.abs(g) - l1, min=0.0)


def leaf_gain(g, h, l1: float, l2: float):
    t = threshold_l1(g, l1)
    return (t * t) / (h + l2 + _EPS)


def leaf_output(g, h, l1: float, l2: float):
    """CalculateSplittedLeafOutput (feature_histogram.hpp:711) without
    max_delta_step."""
    return -threshold_l1(g, l1) / (h + l2 + _EPS)


class SplitCandidate(NamedTuple):
    """Best split of one leaf (reference SplitInfo, split_info.hpp:22), as
    host scalars; the f32 statistics are exact f32 values."""

    gain: float  # improvement over the parent minus min_gain; <= 0: no split
    feature: int  # used-feature index
    bin: int  # threshold bin: bin <= threshold goes left
    default_left: bool  # missing values go left
    left_g: float
    left_h: float
    left_cnt: float
    right_g: float
    right_h: float
    right_cnt: float


def prefix_sum_bins(x: torch.Tensor) -> torch.Tensor:
    """Inclusive f32 prefix sum over axis 1 of ``[F, B, ...]``, associated
    in blocks of 16 bins: sequential inside a block, then the block totals
    carried in order.  This is the order of XLA's CPU cumsum that the JAX
    package's best_split runs (bins <= 256), and the order of the split-scan
    kernel, so all three give the same f32 sums."""
    f, b = x.shape[0], x.shape[1]
    out = torch.empty_like(x)
    carry = torch.zeros_like(x[:, 0])
    for b0 in range(0, b, PREFIX_BLOCK):
        s = torch.zeros_like(x[:, 0])
        for i in range(b0, min(b0 + PREFIX_BLOCK, b)):
            s = s + x[:, i]
            out[:, i] = s
        out[:, b0 : b0 + PREFIX_BLOCK] = out[:, b0 : b0 + PREFIX_BLOCK] + carry[:, None]
        carry = out[:, min(b0 + PREFIX_BLOCK, b) - 1]
    return out


def _ordered_cum(hist: torch.Tensor, nan_bins: torch.Tensor):
    """Shared front of best_split and the plain split scan: NaN-bin stats
    [F, 3] and the ordered prefix sums [F, B, 3] with the NaN bin out."""
    f, b, _ = hist.shape
    has_nan = nan_bins >= 0
    nan_idx = torch.where(has_nan, nan_bins, torch.zeros_like(nan_bins)).long()
    nan_stats = hist[torch.arange(f, device=hist.device), nan_idx] * has_nan[:, None]
    bin_ids = torch.arange(b, device=hist.device)[None, :]
    is_nan_bin = has_nan[:, None] & (bin_ids == nan_bins[:, None])
    hist_o = torch.where(is_nan_bin[:, :, None], torch.zeros_like(hist), hist)
    return has_nan, nan_stats, prefix_sum_bins(hist_o)


def split_gains(
    cum, nan_stats, has_nan, parent, num_bins, feature_mask, *,
    lambda_l1: float, lambda_l2: float, min_data_in_leaf: float,
    min_sum_hessian_in_leaf: float,
):
    """[2, F, B] gains: case 0 missing -> right, case 1 missing -> left
    (-inf where invalid), as best_split's eval_case (ops/split.py:215)."""
    f, b, _ = cum.shape
    bin_ids = torch.arange(b, device=cum.device)[None, :]
    num_ordered = num_bins - has_nan.to(num_bins.dtype)
    valid = (bin_ids < (num_ordered[:, None] - 1)) & feature_mask[:, None]
    ninf = torch.tensor(float("-inf"), dtype=torch.float32, device=cum.device)

    def eval_case(left, ok):
        lg, lh, lc = left[..., 0], left[..., 1], left[..., 2]
        rg, rh, rc = parent[0] - lg, parent[1] - lh, parent[2] - lc
        ok = (
            ok
            & (lc >= min_data_in_leaf)
            & (rc >= min_data_in_leaf)
            & (lh >= min_sum_hessian_in_leaf)
            & (rh >= min_sum_hessian_in_leaf)
        )
        gain = leaf_gain(lg, lh, lambda_l1, lambda_l2) + leaf_gain(
            rg, rh, lambda_l1, lambda_l2
        )
        return torch.where(ok, gain, ninf)

    gain_right = eval_case(cum, valid)
    gain_left = eval_case(cum + nan_stats[:, None, :], valid & has_nan[:, None])
    return torch.stack([gain_right, gain_left])


def best_split(
    hist: torch.Tensor,  # [F, B, 3] (sum_grad, sum_hess, count)
    parent_g: float,
    parent_h: float,
    parent_cnt: float,
    num_bins: torch.Tensor,  # [F] i32 total bins (NaN bin included)
    nan_bins: torch.Tensor,  # [F] i32 NaN-bin index, -1 if none
    feature_mask: torch.Tensor,  # [F] bool
    *,
    lambda_l1: float,
    lambda_l2: float,
    min_data_in_leaf: int,
    min_sum_hessian_in_leaf: float,
    min_gain_to_split: float,
) -> SplitCandidate:
    """Best numeric split of one leaf, both missing directions
    (FindBestThresholdSequentially, feature_histogram.hpp:832)."""
    f, b, _ = hist.shape
    parent = torch.tensor(
        [parent_g, parent_h, parent_cnt], dtype=torch.float32, device=hist.device
    )
    has_nan, nan_stats, cum = _ordered_cum(hist, nan_bins)
    gains = split_gains(
        cum, nan_stats, has_nan, parent, num_bins, feature_mask.bool(),
        lambda_l1=lambda_l1, lambda_l2=lambda_l2,
        min_data_in_leaf=float(min_data_in_leaf),
        min_sum_hessian_in_leaf=min_sum_hessian_in_leaf,
    )
    flat = int(torch.argmax(gains.reshape(-1)))  # first maximum
    case, rem = divmod(flat, f * b)
    feat, tbin = divmod(rem, b)
    left = cum[feat, tbin] + (nan_stats[feat] if case == 1 else 0.0)
    parent_gain = leaf_gain(parent[0], parent[1], lambda_l1, lambda_l2)
    best = gains[case, feat, tbin]
    improvement = best - parent_gain - min_gain_to_split
    vals = torch.stack([improvement, *left, *(parent - left), best]).tolist()
    gain = vals[0] if math.isfinite(vals[7]) else float("-inf")
    return SplitCandidate(
        gain, feat, tbin, case == 1, vals[1], vals[2], vals[3], vals[4],
        vals[5], vals[6],
    )
