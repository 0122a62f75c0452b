"""Leaf-wise (best-first) tree growth on the segment-resident rows.

Counterpart of the serial (``leaf_batch=1``) seg-mode body of
``lightgbm_tpu/ops/grower.py`` ``grow_tree`` (:733) with the fused split
scan (:460-496):

  root:   histogram of all rows, candidate of the root;
  split:  the leaf with the best cached candidate; stable partition of its
          window and histogram of the smaller child (``nleft <= nright``
          picks the left, :1692) -- ONE fused grow step (``grow_fused``,
          the serial fused branch :1599-1627), or a partition and a
          histogram launch (:1628-1697); the sibling as parent minus child;
          candidates of both children.

int8 accumulation (``quant_scales`` given, the gate ``int8_acc_eligible``
of :300-323): every histogram the tree keeps is on the int8 2-digit grid,
siblings are subtracted on it, and every decision whose near-tie margin is
below ``near_tie_tol`` is taken on an f32 re-accumulation of its window
instead -- the root's (:1374-1392) and the two children's in one K=2
launch (:2130-2150).  The refined histogram serves that decision only;
``TreeArrays.refine_count`` counts the refines as the JAX loop's
``refines`` (:1473, :2212).

Growth stops at ``num_leaves`` or when no leaf has a positive gain.  The
loop over splits runs on the host: each split reads back the left count
and the two children's candidates (a few host syncs per split -- the cost
the device-resident TPU loop does not pay).  The per-leaf statistics are
kept on the host as f32 values.
"""

from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from .grow_step import fused_grow_step
from .seg import SegRows, pack_rows, seg_hist, seg_hist_batch, sort_partition
from .split import SplitCandidate, leaf_output
from .split_scan import fused_best_split

_F32 = np.float32

# Lets the int8 accumulation engage on the CPU, where its plain version
# runs (the port's counterpart of the JAX package's seg._INTERPRET, which
# lets it engage off the TPU): used by the tests and by the parity phase of
# chip_smoke.py.  Off, the CPU accumulates in f32 as the JAX CPU path does.
INT8_ON_CPU = False


def int8_acc_eligible(hist_acc: str, device: torch.device) -> bool:
    """The int8 accumulation gate (ops/grower.py:300-323 for the serial
    single-host numeric path): on unless ``hist_acc='bf16'``, on a CUDA
    device, or on the CPU with ``INT8_ON_CPU``."""
    if hist_acc == "bf16":
        return False
    return torch.device(device).type == "cuda" or INT8_ON_CPU


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
    grow_fused: bool = True  # one fused grow step per split
    near_tie_tol: float = 1e-3  # int8 margin below which a decision refines


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
    refine_count: int = 0  # decisions taken on an f32 re-accumulation


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
    quant_scales: Optional[torch.Tensor] = None,  # [2] f32: int8 grid
) -> Tuple[TreeArrays, torch.Tensor]:
    """Grow one tree.  Returns (TreeArrays, leaf_id [N] i32 on the input
    device).  ``quant_scales`` (``quantize.hist_acc_scales``) turns on the
    int8 accumulation with the near-tie f32 refine."""
    p = params
    L, B = p.num_leaves, p.max_bin
    f, n = int(bins_fn.shape[0]), int(bins_fn.shape[1])
    nan_host = nan_bins.cpu().numpy()
    rows = pack_rows(bins_fn, grad, hess, count_mask)
    qs = quant_scales
    tol = _F32(p.near_tie_tol)

    def candidate(hist, g, h, c, with_margin=False):
        return fused_best_split(
            hist, g, h, c, num_bins, nan_bins, feature_mask,
            lambda_l1=p.lambda_l1, lambda_l2=p.lambda_l2,
            min_data_in_leaf=p.min_data_in_leaf,
            min_sum_hessian_in_leaf=p.min_sum_hessian_in_leaf,
            min_gain_to_split=p.min_gain_to_split, with_margin=with_margin,
        )

    def decide(hists, stats, windows):
        """Candidates of the leaves with histograms ``hists``.  With the
        int8 accumulation, a leaf whose near-tie margin is below the
        tolerance is decided on an f32 histogram of its window instead (one
        launch for all such leaves, zero rows for the others); the refined
        histogram is used for this decision only.  Returns (candidates,
        refines)."""
        if qs is None:
            return [candidate(hh, *st) for hh, st in zip(hists, stats)], 0
        got = [candidate(hh, *st, with_margin=True) for hh, st in zip(hists, stats)]
        near = [margin < tol for _, margin in got]
        cands = [cand for cand, _ in got]
        if any(near):
            refined = seg_hist_batch(
                rows, [(s, c if nr else 0) for (s, c), nr in zip(windows, near)], B
            )
            cands = [candidate(refined[i], *stats[i]) if nr else cand
                     for i, (cand, nr) in enumerate(zip(cands, near))]
        return cands, int(sum(near))

    hist_buf = torch.zeros((L, f, B, 3), dtype=torch.float32, device=rows.device)
    hist_buf[0] = seg_hist(rows, 0, n, B, qs)
    totals = _sum_bins(hist_buf[0, 0].cpu().numpy())  # every row: one bin of feature 0
    (cand0,), refines = decide([hist_buf[0]], [tuple(map(float, totals))], [(0, n)])

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
    cands: List[SplitCandidate] = [cand0]
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
        nanb = int(nan_host[c.feature])
        if p.grow_fused:
            nl_t, _, _, _, sm = fused_grow_step(
                rows, [begin], [cnt], [c.feature], [c.bin], [int(c.default_left)],
                [nanb], B, quant_scales=qs,
            )
            nleft = int(nl_t[0])
            sm = sm[0]
            left_smaller = nleft <= cnt - nleft
        else:
            nleft = int(sort_partition(rows, begin, cnt, c.feature, c.bin, c.default_left, nanb))
            left_smaller = nleft <= cnt - nleft
            child_start = begin + (0 if left_smaller else nleft)
            sm = seg_hist(rows, child_start, nleft if left_smaller else cnt - nleft, B, qs)
        nright = cnt - nleft
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

        # a refined child is re-histogrammed directly, never by subtraction
        cand2, r = decide(
            [left_hist, right_hist],
            [(c.left_g, c.left_h, c.left_cnt), (c.right_g, c.right_h, c.right_cnt)],
            [(begin, nleft), (begin + nleft, nright)],
        )
        refines += r
        cands[l] = cand2[0]
        cands.append(cand2[1])
        gains[l], gains[new] = cand2[0].gain, cand2[1].gain
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
        refine_count=refines,
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
