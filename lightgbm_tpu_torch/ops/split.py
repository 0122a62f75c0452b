"""Best-split search over a leaf histogram.

Counterpart of ``lightgbm_tpu/ops/split.py``: ``threshold_l1``,
``leaf_gain``, ``leaf_output``, ``SplitCandidate``, ``CatParams`` and
``best_split`` (:108) with its EFB operand ``bundle_end`` (:154-162,
:190-206, :456-470), its categorical cases (``is_cat``, :270-343, the
winner's mask :440-456) and the near-tie margin (``with_margin``), without
the monotone, CEGB, path-smoothing and extra-trees options.  Gains for
every (case, feature, bin) candidate are evaluated at once and the first
maximum wins, in the JAX package's case-major order: missing-right
candidates of every feature, then missing-left, then the categorical
one-hot, forward and backward sorted-subset candidates.

``best_split`` is the plain version of the split-scan kernel
(``ops/split_scan.py``): both compute the same candidate from the same
histogram.  The grower reaches the kernel through ``fused_best_split``,
and ``best_split`` itself on bundled data, where the JAX package never
takes its scan kernel (ops/grower.py:460-477): a bundle-plane winner
carries its goes-left table, the plane bins outside its member's
sub-range ``[t, end]``.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

_EPS = 1e-15
PREFIX_BLOCK = 16


def threshold_l1(g, l1: float):
    if l1 == 0.0:  # sign(g) * max(|g| - 0, 0) is g, bit for bit
        return g
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
    # [B] bool goes-left table of a bundle-plane winner (left: every plane
    # bin outside the member's [bin, end]) or of a categorical winner (left:
    # the chosen categories' bins); None for a threshold split
    table: Optional[np.ndarray] = None
    # the winner is a categorical split (its table is the category mask)
    is_cat: bool = False


class CatParams(NamedTuple):
    """The categorical split search's keys (lightgbm_tpu/ops/split.py:97-105;
    reference FindBestThresholdCategoricalInner,
    src/treelearner/feature_histogram.cpp:147)."""

    max_cat_to_onehot: int = 4
    max_cat_threshold: int = 32
    cat_l2: float = 10.0
    cat_smooth: float = 10.0
    min_data_per_group: int = 100


def prefix_sum_bins(x: torch.Tensor) -> torch.Tensor:
    """Inclusive f32 prefix sum over axis 1 of ``[F, B, ...]``, associated
    in blocks of 16 bins: sequential inside a block, then each block's
    inclusive prefix of the block totals (itself this prefix sum, in blocks
    of 16 totals past 16 blocks) added to the next block.  This is the order
    of XLA's CPU cumsum that the JAX package's best_split runs, and, at up to
    256 bins, where the totals are carried in order, the order of the
    split-scan kernel, so all three give the same f32 sums."""
    f, b = x.shape[0], x.shape[1]
    nblk = -(-b // PREFIX_BLOCK)
    pad = nblk * PREFIX_BLOCK - b
    xb = torch.cat([x, x.new_zeros((f, pad) + x.shape[2:])], 1) if pad else x
    xb = xb.reshape((f, nblk, PREFIX_BLOCK) + x.shape[2:])
    # every block's running sums at once, one bin position a step
    sums = []
    s = torch.zeros_like(xb[:, :, 0])
    for i in range(PREFIX_BLOCK):
        s = s + xb[:, :, i]
        sums.append(s)
    out = torch.stack(sums, 2)
    if nblk <= PREFIX_BLOCK:  # the block totals carried in order, in place
        for k in range(1, nblk):
            out[:, k].add_(out[:, k - 1, PREFIX_BLOCK - 1 : PREFIX_BLOCK])
    else:  # the totals' own prefix sum, carried into the blocks after
        carry = prefix_sum_bins(out[:, :, PREFIX_BLOCK - 1].contiguous())
        out[:, 1:] += carry[:, :-1].unsqueeze(2)
    return out.reshape((f, nblk * PREFIX_BLOCK) + x.shape[2:])[:, :b]


def _ordered_cum(hist: torch.Tensor, nan_bins: torch.Tensor):
    """Shared front of best_split and the plain split scan: NaN-bin stats
    [..., F, 3] and the ordered prefix sums [..., F, B, 3] with the NaN bin
    out, of histograms [..., F, B, 3]."""
    f, b = hist.shape[-3], hist.shape[-2]
    has_nan = nan_bins >= 0
    nan_idx = torch.where(has_nan, nan_bins, torch.zeros_like(nan_bins)).long()
    nan_stats = hist[..., torch.arange(f, device=hist.device), nan_idx, :] * has_nan[:, None]
    bin_ids = torch.arange(b, device=hist.device)[None, :]
    is_nan_bin = has_nan[:, None] & (bin_ids == nan_bins[:, None])
    hist_o = torch.where(is_nan_bin[:, :, None], torch.zeros_like(hist), hist)
    cum = prefix_sum_bins(hist_o.reshape(-1, b, 3)).reshape(hist.shape)
    return has_nan, nan_stats, cum


def split_gains(
    cum, nan_stats, has_nan, parent, num_bins, feature_mask, *,
    lambda_l1: float, lambda_l2: float, min_data_in_leaf: float,
    min_sum_hessian_in_leaf: float, valid=None,
):
    """[..., 2, F, B] gains of prefix sums [..., F, B, 3] and parents [...,
    3]: case 0 missing -> right, case 1 missing -> left (-inf where
    invalid), as best_split's eval_case (ops/split.py:215).  ``valid`` [F,
    B]: the candidate bins, by default every ordered bin but the last;
    ``feature_mask`` [F], or [..., F] a mask a leaf."""
    b = cum.shape[-2]
    if valid is None:
        bin_ids = torch.arange(b, device=cum.device)[None, :]
        num_ordered = num_bins - has_nan.to(num_bins.dtype)
        valid = bin_ids < (num_ordered[:, None] - 1)
    valid = valid & feature_mask[..., None]
    pr = parent[..., None, None, :]

    def eval_case(left, ok):
        return _eval_gain(left[..., 0], left[..., 1], left[..., 2], pr, ok, lambda_l1,
                          lambda_l2, min_data_in_leaf, min_sum_hessian_in_leaf)

    gain_right = eval_case(cum, valid)
    gain_left = eval_case(cum + nan_stats[..., None, :], valid & has_nan[:, None])
    return torch.stack([gain_right, gain_left], dim=-3)


def _eval_gain(lg, lh, lc, pr, ok, l1: float, l2: float, min_data_in_leaf: float,
               min_sum_hessian_in_leaf: float):
    """Gains of left statistics [..., F, B] against parents ``pr`` [..., 1,
    1, 3], -inf where not ``ok`` or a child is below its count or hessian
    floor (best_split's eval_gain, ops/split.py:209-247)."""
    rg, rh, rc = pr[..., 0] - lg, pr[..., 1] - lh, pr[..., 2] - lc
    ok = (
        ok
        & (torch.minimum(lc, rc) >= min_data_in_leaf)
        & (torch.minimum(lh, rh) >= min_sum_hessian_in_leaf)
    )
    gain = leaf_gain(lg, lh, l1, l2) + leaf_gain(rg, rh, l1, l2)
    return torch.where(ok, gain, torch.tensor(float("-inf"), dtype=torch.float32,
                                              device=lg.device))


def categorical_gains(hist, parent, num_bins, nan_bins, feature_mask, is_cat,
                      cp: CatParams, *, lambda_l1: float, lambda_l2: float,
                      min_data_in_leaf: float, min_sum_hessian_in_leaf: float):
    """The categorical cases of best_split (ops/split.py:270-343) for
    histograms [M, F, B, 3]: ([M, 3, F, B] gains of the one-hot, forward
    and backward sorted-subset candidates, and what the winner's left
    statistics and mask need: the sorted prefix sums, the backward sums,
    the sort ranks, the valid bins and their count).

    One-hot (features of at most ``max_cat_to_onehot`` bins): left is one
    category's bin.  Sorted subsets: the bins with at least ``cat_smooth``
    rows, sorted by g / (h + cat_smooth) (a stable sort), left the first t +
    1 of them (forward) or the last t + 1 (backward), t below
    min(max_cat_threshold, (used + 1) // 2), with ``l2 + cat_l2``, where
    the count crosses a multiple of ``min_data_per_group`` and at least
    that many rows stay right (the JAX package's vectorised rule).  The NaN
    bin never goes left.  The prefix sums take XLA's CPU cumsum order
    (``prefix_sum_bins``)."""
    m, f, b, _ = hist.shape
    dev = hist.device
    bin_ids = torch.arange(b, device=dev)[None, :]
    is_nan_bin = (nan_bins >= 0)[:, None] & (bin_ids == nan_bins[:, None])
    in_range = (bin_ids < num_bins[:, None]) & ~is_nan_bin  # [F, B]
    g_, h_, c_ = hist[..., 0], hist[..., 1], hist[..., 2]  # [M, F, B]
    catf = (is_cat[None, :] & feature_mask)[..., None]  # [M or 1, F, 1]
    use_onehot_f = (num_bins <= cp.max_cat_to_onehot)[:, None]
    pr = parent[:, None, None, :]
    kw = dict(l1=lambda_l1, min_data_in_leaf=min_data_in_leaf,
              min_sum_hessian_in_leaf=min_sum_hessian_in_leaf)
    gain_oh = _eval_gain(g_, h_, c_, pr, in_range & catf & use_onehot_f, l2=lambda_l2, **kw)
    l2c = lambda_l2 + cp.cat_l2
    validb = in_range & (c_ >= cp.cat_smooth)  # [M, F, B]
    key = torch.where(validb, g_ / (h_ + cp.cat_smooth), float("inf"))
    order = torch.argsort(key, dim=2, stable=True)
    # each bin's sorted position (the inverse permutation of order)
    rank = torch.empty_like(order).scatter_(
        2, order, torch.arange(b, device=dev).expand(m, f, b).contiguous())
    sorted3 = torch.gather(torch.where(validb[..., None], hist, 0.0), 2,
                           order[..., None].expand(m, f, b, 3))
    pre = prefix_sum_bins(sorted3.reshape(m * f, b, 3)).reshape(m, f, b, 3)
    used = validb.sum(dim=2)  # [M, F]
    tot = pre[:, :, -1:, :]
    max_num_cat = torch.clamp(torch.div(used + 1, 2, rounding_mode="floor"),
                              max=cp.max_cat_threshold)
    pos_ok = bin_ids[None] < torch.minimum(used, max_num_cat)[..., None]
    ok_sorted = catf & ~use_onehot_f & pos_ok
    bidx = used[..., None] - 2 - bin_ids[None]
    prev = torch.gather(pre, 2, bidx.clamp(0, b - 1)[..., None].expand(m, f, b, 3))
    bwd = tot - torch.where((bidx >= 0)[..., None], prev, 0.0)

    def group_ok(lc):
        if cp.min_data_per_group <= 1:
            return torch.ones(lc.shape, dtype=torch.bool, device=dev)
        before = torch.cat([torch.zeros_like(lc[..., :1]), lc[..., :-1]], dim=-1)
        md = float(cp.min_data_per_group)
        return torch.floor(lc / md) > torch.floor(before / md)

    gains = [gain_oh]
    for left in (pre, bwd):
        lc = left[..., 2]
        ok = ok_sorted & group_ok(lc) & (pr[..., 2] - lc >= cp.min_data_per_group)
        gains.append(_eval_gain(left[..., 0], left[..., 1], lc, pr, ok, l2=l2c, **kw))
    return torch.stack(gains, dim=1), (pre, bwd, rank, validb, used)


def bundle_table(tbin: int, end: int, b: int) -> np.ndarray:
    """[B] bool goes-left table of a bundle-plane split at plane bin
    ``tbin`` whose member's sub-range ends at ``end``: every bin outside
    ``[tbin, end]`` goes left (lightgbm_tpu/ops/split.py:456-470)."""
    bids = np.arange(b)
    return ~((bids >= tbin) & (bids <= end))


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
    bundle_end: Optional[torch.Tensor] = None,  # [F, B] i32: EFB sub-range ends
    with_margin: bool = False,
    is_cat: Optional[torch.Tensor] = None,  # [F] bool: categorical features
    cat_params: Optional[CatParams] = None,
):
    """Best split of one leaf (FindBestThresholdSequentially,
    feature_histogram.hpp:832, both missing directions; with ``is_cat``
    FindBestThresholdCategoricalInner too): ``best_split_batch`` of one
    leaf."""
    return best_split_batch(
        hist[None], [(parent_g, parent_h, parent_cnt)], num_bins, nan_bins, feature_mask,
        lambda_l1=lambda_l1, lambda_l2=lambda_l2, min_data_in_leaf=min_data_in_leaf,
        min_sum_hessian_in_leaf=min_sum_hessian_in_leaf, min_gain_to_split=min_gain_to_split,
        bundle_end=bundle_end, with_margin=with_margin, is_cat=is_cat, cat_params=cat_params,
    )[0]


def best_split_batch(
    hist: torch.Tensor,  # [M, F, B, 3] (sum_grad, sum_hess, count) of M leaves
    parents,  # M (g, h, count) host triples, exact f32 values
    num_bins: torch.Tensor,  # [F] i32 total bins (NaN bin included)
    nan_bins: torch.Tensor,  # [F] i32 NaN-bin index, -1 if none
    feature_mask: torch.Tensor,  # [F] bool, or [M, F] a mask a leaf
    *,
    lambda_l1: float,
    lambda_l2: float,
    min_data_in_leaf: int,
    min_sum_hessian_in_leaf: float,
    min_gain_to_split: float,
    bundle_end: Optional[torch.Tensor] = None,  # [F, B] i32: EFB sub-range ends
    with_margin: bool = False,
    is_cat: Optional[torch.Tensor] = None,  # [F] bool: categorical features
    cat_params: Optional[CatParams] = None,
):
    """``best_split`` of M leaves at once (the ``jax.vmap`` of the JAX
    package's batched children, ops/grower.py:2670-2712): the same f32
    operations on each, so each member is bit-equal to a call on it alone,
    and one read of the M results to the host.  Returns M candidates, or
    M (candidate, margin) pairs with ``with_margin``.

    ``bundle_end`` (``BundleLayout.bundle_end_array``): on a bundle plane
    the candidate at bin t is "the member's local bin <= t - start goes
    left", so left = parent - (cum[end] - cum[t - 1]) and every sub-range
    bin is a candidate (t = start: the default alone goes left); the
    winner carries its goes-left table.  ``is_cat`` (with ``cat_params``,
    default ``CatParams()``): the categorical features, which take no
    threshold candidate and the cases of ``categorical_gains`` instead; a
    categorical winner carries its category mask as its goes-left table
    and ``is_cat``.  ``with_margin``: the near-tie margin, the relative gap
    between the best candidate and the best other one over every (case,
    feature, bin), +inf when either is not finite."""
    m, f, b, _ = hist.shape
    dev = hist.device
    parent = torch.tensor(parents, dtype=torch.float32, device=dev).reshape(m, 3)
    has_nan, nan_stats, cum = _ordered_cum(hist, nan_bins)
    valid = None
    if bundle_end is not None:
        bundled_bin = bundle_end >= 0
        idx = bundle_end.clamp(0, b - 1).long()[None, :, :, None].expand(m, f, b, 3)
        cum_end = torch.gather(cum, 2, idx)
        # a bundle plane has no NaN bin: hist is its hist_o
        cum = torch.where(bundled_bin[:, :, None],
                          parent[:, None, None, :] - cum_end + cum - hist, cum)
        bin_ids = torch.arange(b, device=dev)[None, :]
        num_ordered = num_bins - has_nan.to(num_bins.dtype)
        valid = torch.where(bundled_bin.any(1)[:, None], bundled_bin,
                            bin_ids < (num_ordered[:, None] - 1))
    fmask = feature_mask.bool()
    gain_kw = dict(lambda_l1=lambda_l1, lambda_l2=lambda_l2,
                   min_data_in_leaf=float(min_data_in_leaf),
                   min_sum_hessian_in_leaf=min_sum_hessian_in_leaf)
    gains = split_gains(cum, nan_stats, has_nan, parent, num_bins,
                        fmask if is_cat is None else fmask & ~is_cat, valid=valid, **gain_kw)
    if is_cat is not None:
        cp = cat_params if cat_params is not None else CatParams()
        cat_g, (pre, bwd, rank, validb, used) = categorical_gains(
            hist, parent, num_bins, nan_bins, fmask, is_cat, cp, **gain_kw)
        gains = torch.cat([gains, cat_g], dim=1)
    g = gains.reshape(m, -1)
    rows = torch.arange(m, device=dev)
    flat = torch.argmax(g, dim=1)  # first maximum of each leaf
    rem = flat % (f * b)
    case_t = flat // (f * b)
    left = cum.reshape(m, f * b, 3)[rows, rem] + torch.where(
        (case_t == 1)[:, None], nan_stats[rows, rem // b], 0.0)
    if is_cat is not None:
        left = torch.where((case_t == 2)[:, None], hist.reshape(m, f * b, 3)[rows, rem], left)
        left = torch.where((case_t == 3)[:, None], pre.reshape(m, f * b, 3)[rows, rem], left)
        left = torch.where((case_t == 4)[:, None], bwd.reshape(m, f * b, 3)[rows, rem], left)
        feat_t = rem // b
        # the winners' features' sort ranks, valid bins and counts, to host
        # in one copy
        win = torch.cat([rank[rows, feat_t], validb[rows, feat_t].long(),
                         used[rows, feat_t][:, None]], dim=1).cpu().numpy()
        cat_rank, cat_valid, cat_used = win[:, :b], win[:, b:2 * b] != 0, win[:, 2 * b]
    parent_gain = leaf_gain(parent[:, 0], parent[:, 1], lambda_l1, lambda_l2)
    best = g[rows, flat]
    improvement = best - parent_gain - min_gain_to_split
    # one host copy in f64: the f32 values exactly, and the flat index past
    # 2^24 candidates (five cases at wide bins) too
    cols = [improvement[:, None], left, parent - left, best[:, None], flat[:, None]]
    if bundle_end is not None:
        cols.append(bundle_end.reshape(-1)[rem][:, None])
    if with_margin:
        sec = torch.where(torch.arange(g.shape[1], device=dev)[None, :] == flat[:, None],
                          float("-inf"), g).max(dim=1).values
        margin = torch.where(
            torch.isfinite(best) & torch.isfinite(sec),
            (best - sec) / torch.clamp(torch.abs(best), min=_EPS),
            float("inf"),
        )
        cols.append(margin[:, None])
    out = []
    for vals in torch.cat([c.to(torch.float64) for c in cols], dim=1).tolist():
        gain = vals[0] if math.isfinite(vals[7]) else float("-inf")
        case, r = divmod(int(vals[8]), f * b)
        feat, tbin = divmod(r, b)
        table = None
        if bundle_end is not None and vals[9] >= 0:
            table = bundle_table(tbin, int(vals[9]), b)
        if case >= 2:  # categorical: the winner's category mask
            i = len(out)
            table = category_mask(case, tbin, b, cat_rank[i], cat_valid[i], int(cat_used[i]))
        cand = SplitCandidate(gain, feat, tbin, case == 1, *vals[1:7], table, case >= 2)
        out.append((cand, vals[-1]) if with_margin else cand)
    return out


def category_mask(case: int, tbin: int, b: int, rank, valid, used: int) -> np.ndarray:
    """[B] bool goes-left mask of a categorical winner (ops/split.py:444-456):
    case 2 (one-hot) the bin ``tbin``; case 3 (forward) the valid bins of
    sort rank <= tbin; case 4 (backward) those of rank >= used - 1 - tbin."""
    if case == 2:
        return np.arange(b) == tbin
    if case == 3:
        return valid & (rank <= tbin)
    return valid & (rank >= used - 1 - tbin)
