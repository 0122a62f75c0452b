"""Leaf-wise (best-first) tree growth on the segment-resident rows.

Counterpart of the serial (``leaf_batch=1``) seg-mode body of
``lightgbm_tpu/ops/grower.py`` ``grow_tree`` (:733) with the fused split
scan (:460-496) and two separate launches per split (``grow_fused=False``):

  root:   histogram of all rows, candidate of the root;
  split:  the leaf with the best cached candidate; stable partition of its
          window; histogram of the smaller child (``nleft <= nright`` picks
          the left, :1692); the sibling as parent minus child; candidates
          of both children.

Growth stops at ``num_leaves`` or when no leaf has a positive gain.  The
loop over splits runs on the host: each split reads back the left count of
the partition and the two children's candidates (a few host syncs per
split — the cost the device-resident TPU loop does not pay).  The
per-leaf statistics are kept on the host as f32 values.
"""

from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Tuple

import numpy as np
import torch

from .seg import SegRows, pack_rows, seg_hist, sort_partition
from .split import SplitCandidate, leaf_output
from .split_scan import fused_best_split

_F32 = np.float32


@dataclasses.dataclass(frozen=True)
class GrowerParams:
    """Parameters of one tree's growth."""

    num_leaves: int
    max_bin: int  # B: padded bin-axis size of the histogram
    min_data_in_leaf: int = 20
    min_sum_hessian_in_leaf: float = 1e-3
    lambda_l1: float = 0.0
    lambda_l2: float = 0.0
    min_gain_to_split: float = 0.0


class TreeArrays(NamedTuple):
    """Bin-space tree, mirroring the JAX package's TreeArrays
    (ops/grower.py:227): child pointers >= 0 are internal nodes, negative
    ones ``~leaf``.  Host numpy arrays sized by num_leaves."""

    split_feature: np.ndarray  # [L-1] i32 used-feature index
    split_bin: np.ndarray  # [L-1] i32
    split_gain: np.ndarray  # [L-1] f32
    default_left: np.ndarray  # [L-1] bool
    left_child: np.ndarray  # [L-1] i32
    right_child: np.ndarray  # [L-1] i32
    internal_value: np.ndarray  # [L-1] f32
    internal_weight: np.ndarray  # [L-1] f32
    internal_count: np.ndarray  # [L-1] f32
    leaf_value: np.ndarray  # [L] f32 (raw, unshrunk)
    leaf_weight: np.ndarray  # [L] f32
    leaf_count: np.ndarray  # [L] f32
    leaf_depth: np.ndarray  # [L] i32
    num_leaves: int


def _sum_bins(x: np.ndarray) -> np.ndarray:
    """f32 sum over axis 0 of a [B, 3] histogram row, in the association of
    XLA's CPU reduce (sequential blocks of 32 bins, then the block sums in
    order) that the JAX package's root totals use (ops/grower.py:1341)."""
    total = np.zeros(x.shape[1:], _F32)
    for b0 in range(0, x.shape[0], 32):
        s = np.zeros(x.shape[1:], _F32)
        for row in x[b0 : b0 + 32]:
            s = s + row
        total = total + s
    return total


def _leaf_output(g, h, p: GrowerParams) -> np.ndarray:
    out = leaf_output(
        torch.as_tensor(np.asarray(g, _F32)), torch.as_tensor(np.asarray(h, _F32)),
        p.lambda_l1, p.lambda_l2,
    )
    return out.numpy()


def grow_tree(
    bins_fn: torch.Tensor,  # [F, N] u8 feature-major bins
    grad: torch.Tensor,  # [N] f32
    hess: torch.Tensor,  # [N] f32
    count_mask: torch.Tensor,  # [N] f32, 1 in bag
    num_bins: torch.Tensor,  # [F] i32
    nan_bins: torch.Tensor,  # [F] i32
    feature_mask: torch.Tensor,  # [F] bool
    params: GrowerParams,
) -> Tuple[TreeArrays, torch.Tensor]:
    """Grow one tree.  Returns (TreeArrays, leaf_id [N] i32 on the input
    device)."""
    p = params
    L, B = p.num_leaves, p.max_bin
    f, n = int(bins_fn.shape[0]), int(bins_fn.shape[1])
    nan_host = nan_bins.cpu().numpy()
    rows = pack_rows(bins_fn, grad, hess, count_mask)

    def candidate(hist, g, h, c) -> SplitCandidate:
        return fused_best_split(
            hist, g, h, c, num_bins, nan_bins, feature_mask,
            lambda_l1=p.lambda_l1, lambda_l2=p.lambda_l2,
            min_data_in_leaf=p.min_data_in_leaf,
            min_sum_hessian_in_leaf=p.min_sum_hessian_in_leaf,
            min_gain_to_split=p.min_gain_to_split,
        )

    hist_buf = torch.zeros((L, f, B, 3), dtype=torch.float32, device=rows.device)
    hist_buf[0] = seg_hist(rows, 0, n, B)
    totals = _sum_bins(hist_buf[0, 0].cpu().numpy())  # every row: one bin of feature 0

    leaf_g = np.zeros(L, _F32)
    leaf_h = np.zeros(L, _F32)
    leaf_cnt = np.zeros(L, _F32)
    leaf_g[0], leaf_h[0], leaf_cnt[0] = totals
    leaf_depth = np.zeros(L, np.int32)
    leaf_parent = np.full(L, -1, np.int32)
    leaf_is_right = np.zeros(L, bool)
    leaf_begin = np.zeros(L, np.int64)
    leaf_nrows = np.zeros(L, np.int64)
    leaf_nrows[0] = n
    cands: List[SplitCandidate] = [candidate(hist_buf[0], *map(float, totals))]
    gains = np.full(L, -np.inf)
    gains[0] = cands[0].gain

    nn = L - 1
    split_feature = np.zeros(nn, np.int32)
    split_bin = np.zeros(nn, np.int32)
    split_gain = np.zeros(nn, _F32)
    default_left = np.zeros(nn, bool)
    left_child = np.full(nn, -1, np.int32)
    right_child = np.full(nn, -1, np.int32)
    internal_value = np.zeros(nn, _F32)
    internal_weight = np.zeros(nn, _F32)
    internal_count = np.zeros(nn, _F32)

    num_leaves = 1
    for t in range(nn):
        l = int(np.argmax(gains[:num_leaves]))  # first maximum
        c = cands[l]
        if not c.gain > 0.0:
            break
        new = t + 1
        begin, cnt = int(leaf_begin[l]), int(leaf_nrows[l])
        nleft = int(sort_partition(
            rows, begin, cnt, c.feature, c.bin, c.default_left,
            int(nan_host[c.feature]),
        ))
        nright = cnt - nleft
        left_smaller = nleft <= nright
        child_start = begin + (0 if left_smaller else nleft)
        sm = seg_hist(rows, child_start, nleft if left_smaller else nright, B)
        other = hist_buf[l] - sm
        left_hist, right_hist = (sm, other) if left_smaller else (other, sm)

        # record node t (reference Tree::Split, src/io/tree.cpp:65)
        left_child[t] = ~l
        right_child[t] = ~new
        par = leaf_parent[l]
        if par >= 0:
            if leaf_is_right[l]:
                right_child[par] = t
            else:
                left_child[par] = t
        split_feature[t] = c.feature
        split_bin[t] = c.bin
        split_gain[t] = _F32(c.gain) + _F32(p.min_gain_to_split)
        default_left[t] = c.default_left
        internal_value[t] = _leaf_output(leaf_g[l], leaf_h[l], p)
        internal_weight[t] = leaf_h[l]
        internal_count[t] = leaf_cnt[l]

        leaf_g[l], leaf_h[l], leaf_cnt[l] = c.left_g, c.left_h, c.left_cnt
        leaf_g[new], leaf_h[new], leaf_cnt[new] = c.right_g, c.right_h, c.right_cnt
        leaf_depth[l] = leaf_depth[new] = leaf_depth[l] + 1
        leaf_parent[l] = leaf_parent[new] = t
        leaf_is_right[l], leaf_is_right[new] = False, True
        leaf_begin[new] = begin + nleft
        leaf_nrows[l], leaf_nrows[new] = nleft, nright
        hist_buf[l] = left_hist
        hist_buf[new] = right_hist

        cand_l = candidate(left_hist, c.left_g, c.left_h, c.left_cnt)
        cand_r = candidate(right_hist, c.right_g, c.right_h, c.right_cnt)
        cands[l] = cand_l
        cands.append(cand_r)
        gains[l], gains[new] = cand_l.gain, cand_r.gain
        num_leaves += 1

    nl_ = num_leaves
    out = _leaf_output(leaf_g, leaf_h, p)
    # a tree with no split contributes nothing (gbdt.cpp:428)
    leaf_value = np.where(np.arange(L) < nl_, out, 0.0).astype(_F32)
    if nl_ <= 1:
        leaf_value[:] = 0.0
    tree = TreeArrays(
        split_feature=split_feature[: nl_ - 1],
        split_bin=split_bin[: nl_ - 1],
        split_gain=split_gain[: nl_ - 1],
        default_left=default_left[: nl_ - 1],
        left_child=left_child[: nl_ - 1],
        right_child=right_child[: nl_ - 1],
        internal_value=internal_value[: nl_ - 1],
        internal_weight=internal_weight[: nl_ - 1],
        internal_count=internal_count[: nl_ - 1],
        leaf_value=leaf_value[:nl_],
        leaf_weight=leaf_h[:nl_].copy(),
        leaf_count=leaf_cnt[:nl_].copy(),
        leaf_depth=leaf_depth[:nl_].copy(),
        num_leaves=nl_,
    )
    return tree, leaf_id_from_seg(rows, leaf_begin[:nl_], leaf_nrows[:nl_])


def leaf_id_from_seg(
    rows: SegRows, leaf_begin: np.ndarray, leaf_nrows: np.ndarray
) -> torch.Tensor:
    """Leaf of every original row: windows give the leaf of each segment
    position, ridx maps positions back to rows (segpart.leaf_id_from_seg)."""
    order = np.argsort(leaf_begin, kind="stable")
    dev = rows.device
    leaf_pos = torch.repeat_interleave(
        torch.as_tensor(order, dtype=torch.int32, device=dev),
        torch.as_tensor(leaf_nrows[order], dtype=torch.int64, device=dev),
    )
    leaf_id = torch.empty(rows.n, dtype=torch.int32, device=dev)
    leaf_id[rows.ridx.long()] = leaf_pos
    return leaf_id
