"""Leaf-wise (best-first) tree growth on the segment-resident rows.

Counterpart of the seg-mode bodies of ``lightgbm_tpu/ops/grower.py``
``grow_tree`` (:733) with the fused split scan (:460-496), serial
(``leaf_batch=1``) and frontier-batched (``leaf_batch=K``, ``body_batched``
:2219-2890).  The serial loop:

  root:   histogram of all rows, candidate of the root;
  split:  the leaf with the best cached candidate; stable partition of its
          window and histogram of the smaller child (``nleft <= nright``
          picks the left, :1692) -- ONE fused grow step (``grow_fused``,
          the serial fused branch :1599-1627), or a partition and a
          histogram launch (:1628-1697); the sibling as parent minus child;
          candidates of both children in one split-scan call (one launch,
          one transfer).

int8 accumulation (``quant_scales`` given, the gate ``int8_acc_eligible``
of :300-323): every histogram the tree keeps is on the int8 2-digit grid,
siblings are subtracted on it, and every decision whose near-tie margin is
below ``near_tie_tol`` is taken on an f32 re-accumulation of its window
instead -- the root's (:1374-1392) and the two children's in one K=2
launch (:2130-2150).  The refined histogram serves that decision only;
``TreeArrays.refine_count`` counts the refines as the JAX loop's
``refines`` (:1473, :2212).

Frontier batching (``leaf_batch=K > 1``, the JAX while loop :2891-2900):
each step takes the K leaves with the best cached gains (the order of
``lax.top_k``: ties to the lowest index), partitions their DISJOINT
windows and histograms their K smaller children in one launch (the fused
grow step, or ``sort_partition_batch`` and a K-window ``seg_hist_batch``),
takes each sibling as parent minus child, and refreshes the 2K child
candidates in ONE batched split scan and ONE transfer (int8: the near-tie
children refine in one 2K-window f32 launch).  Member i commits iff every
earlier member committed AND its gain is strictly greater than the best
child gain of every earlier member (the prefix-commit rule, :2729-2739):
exactly when the serial loop would have picked it next, so the committed
split sequence, node numbering included, is the serial one.  An
uncommitted member only reordered rows inside its own window and is a
no-op otherwise; its leaf stays in the frontier.  ``TreeArrays.grow_steps``
counts the steps (serial: the splits), from which the booster's
commit-rate clamp reads its rate.

EFB (``bundle_end`` given, the JAX package's ``use_bundle``, ops/grower.py:
769-771, :819): every leaf is decided by ``best_split`` with the
bundle operand, near-tie refine included, as the JAX package never takes
its scan kernel with a bundle (:460-477, ``bundle_end is None`` in
``fused_ok``), singleton planes too; a bundle-plane winner carries its
goes-left table, and the partition (the fused step, the partition kernel,
or the ordered layout's PyTorch partition, :1251, :1758-1761) sends the
rows of the plane bins outside its member's sub-range ``[t, end]`` left.

Categorical features (``is_cat`` given, the JAX package's ``use_cat``,
ops/grower.py:816-820): every leaf is decided by ``best_split`` with the
categorical cases, near-tie refine included, as the JAX package never takes
its scan kernel then (``not p.use_cat`` in ``fused_ok``, :467); a
categorical winner carries its category mask as its goes-left table, as
wide as the padded bin axis, which the partition (the fused step, the
partition kernel, or the ordered layout's PyTorch partition) reads, and
the tree keeps it (``TreeArrays.split_table``, ``split_is_cat``).

Bins past a byte (``max_bin`` > 256, the JAX package's wide seg path): the
seg rows hold each feature as two byte planes (``SegRows.wide``: the u16
modes of the partition, the histogram and the fused step), and every leaf
is decided by ``best_split``, near-tie refine included, as the JAX grower
takes its scan kernel only at ``max_bin <= 256`` (``fused_ok``, :460-479);
its ties go case-major (the booster's ``case_major_ties``).

Feature sampling (the JAX grower's ``node_feature_mask``, :864-871, and
``seg_live``, :1104-1127): the tree's ``feature_mask`` (by-tree
``feature_fraction``) bounds every node's candidates, and on the seg
layout its live features (feature 0 always among them: its histogram
gives the root's totals) are the only ones the histograms read
(``live_features``; the kernels' live mode, ops/seg.py).  With
``feature_fraction_bynode`` < 1 each node's candidates are further those
whose uniform draw from ``fold_in(rng, node seed)`` lies below it (node
seeds 0 at the root, 2t + 1 and 2t + 2 for the children of split t,
speculative batch members included), drawn once a tree on the host for
every seed the tree can reach and copied to the device; they reach the
split-scan kernel as its [M, F] masks and ``best_split_batch`` likewise.
Quantized training on seg (``params.quantized``): the histograms run the
int8 mode on the quantization scales, exact, and no decision is refined
(:1082-1102).

Growth stops at ``num_leaves`` or when no leaf has a positive gain.  The
loop over splits runs on the host: each split reads back the left count
and the two children's candidates (two host syncs per split -- the cost
the device-resident TPU loop does not pay).  The per-leaf statistics are
kept on the host as f32 values.

The loop is layout-independent: it reads and splits the rows through a row
store.  ``_SegStore`` keeps the rows physically in leaf order (ops/seg.py,
the fused grow step).  ``_OrderedStore`` is the ordered layout
(``hist_mode='ordered'``, :1160-1345): the rows never move, an i32 index
array ``order`` holds every leaf's rows as one window, a split partitions
its window of the index stably (``_make_part_branch`` :1240-1272, plain
PyTorch: a column gather, a compare, two cumsums and a scatter, as it is
XLA there), and a histogram reads the gathered rows of the row-major bins
(``ops/histogram.py``: K windows per launch; past 256 bins u16 rows, the
kernel's u16 mode, and the partition reads a feature's two byte planes).
On the ordered layout ``quant_scales`` are those of quantized training
(``hist_method='pallas_int8'``): every histogram is on the exact int8 grid
and no decision is refined.
"""

from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from .. import random as rnd
from .grow_step import fused_grow_step
from .histogram import OrderedRows, ordered_hist, ordered_hist_int8
from .seg import (
    RANGE_BINS,
    go_left,
    pack_rows,
    seg_hist,
    seg_hist_batch,
    sort_partition,
    sort_partition_batch,
)
from .split import CatParams, SplitCandidate, best_split_batch, leaf_output
from .split_scan import fused_best_split_batch, scan_inputs

_F32 = np.float32

# Lets the int8 accumulation engage on the CPU, where its plain version
# runs (the port's counterpart of the JAX package's seg._INTERPRET, which
# lets it engage off the TPU): used by the tests and by the parity phase of
# chip_smoke.py.  Off, the CPU accumulates in f32 as the JAX CPU path does.
INT8_ON_CPU = False


def int8_acc_eligible(hist_acc: str, hist_mode: str, device: torch.device) -> bool:
    """The int8 accumulation gate (ops/grower.py:300-323 for the serial
    single-host numeric path, and ``use_seg`` at :1096): on the seg layout
    only, unless ``hist_acc='bf16'``, on a CUDA device, or on the CPU with
    ``INT8_ON_CPU``."""
    if hist_mode != "seg" or hist_acc == "bf16":
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
    leaf_batch: int = 1  # K: frontier leaves split per step (1 = serial)
    hist_mode: str = "seg"  # row store: 'seg' or 'ordered'
    # exact gain ties between features go by best_split's case-major argmax
    # (missing-right first) instead of the split-scan kernel's first feature
    case_major_ties: bool = False
    # feature_fraction_bynode: each node's candidates are the features of
    # the tree's mask whose draw from fold_in(rng, node seed) is below it
    feature_fraction_bynode: float = 1.0
    # quant_scales are quantized training's (hist_method='pallas_int8'):
    # the seg histograms run the exact int8 mode, no decision is refined
    quantized: bool = False
    # the categorical split search's keys (used with grow_tree's is_cat)
    cat_params: Optional[CatParams] = None


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
    grow_steps: int = 0  # grow-loop steps (serial: splits; batched: steps)
    # [L-1] per node: the [B] bool goes-left table of a bundle-plane or a
    # categorical split, None for a threshold split (None altogether
    # without EFB and categorical features)
    split_table: Optional[List[Optional[np.ndarray]]] = None
    # [L-1] bool: the node is a categorical split (None without categorical
    # features)
    split_is_cat: Optional[np.ndarray] = None


# the cached candidate of a leaf that does not exist yet (or cannot split)
_NO_SPLIT = SplitCandidate(float("-inf"), 0, 0, False, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0)


def _sum_bins(x: np.ndarray) -> np.ndarray:
    """f32 sum over axis 0 of a [B, 3] histogram row, in the association of
    XLA's CPU reduce (sequential blocks of 32 bins, then the block sums in
    order, themselves summed so past 32 blocks) that the JAX package's root
    totals use (ops/grower.py:1341)."""
    sums = []
    for b0 in range(0, x.shape[0], 32):
        s = np.zeros(x.shape[1:], _F32)
        for row in x[b0 : b0 + 32]:
            s = s + row
        sums.append(s)
    if len(sums) > 32:
        return _sum_bins(np.stack(sums))
    total = np.zeros(x.shape[1:], _F32)
    for s in sums:
        total = total + s
    return total


def _leaf_output(g, h, p: GrowerParams) -> np.ndarray:
    out = leaf_output(
        torch.as_tensor(np.asarray(g, _F32)), torch.as_tensor(np.asarray(h, _F32)),
        p.lambda_l1, p.lambda_l2,
    )
    return out.numpy()


def _smaller_windows(begins, cnts, nleft) -> np.ndarray:
    """[K, 2] (start, cnt) of the smaller child of each split window: the
    left one when ``nleft <= nright`` (ops/grower.py:1692)."""
    begins = np.asarray(begins, np.int64)
    cnts = np.asarray(cnts, np.int64)
    ls = nleft <= cnts - nleft
    return np.stack([begins + np.where(ls, 0, nleft), np.where(ls, nleft, cnts - nleft)], axis=1)


class _SegStore:
    """Rows kept physically in leaf order (ops/seg.py): a split is one
    fused grow step, or a partition and a histogram launch."""

    def __init__(self, bins_fn, grad, hess, mask, num_bins: int, qs, fused: bool,
                 used_bins: int = 0, live=None):
        # past 256 bins, bins_fn holds each feature as two byte planes
        self.rows = pack_rows(bins_fn, grad, hess, mask, wide=num_bins > RANGE_BINS,
                              used_bins=used_bins)
        self.device = self.rows.device
        self.B, self.qs, self.fused = num_bins, qs, fused
        # the tree's live features (None: all): every histogram skips the
        # others and writes their cells 0
        self.live = live

    def root_hist(self) -> torch.Tensor:
        return seg_hist(self.rows, 0, self.rows.n, self.B, self.qs, live=self.live)

    def refine_hist(self, windows) -> torch.Tensor:
        """f32 histograms of K windows: the near-tie refine of the int8
        accumulation, which only this layout runs."""
        return seg_hist_batch(self.rows, windows, self.B, live=self.live)

    def split(self, begins, cnts, feats, tbins, dls, nanbs, tables):
        """Partition K disjoint windows (by threshold, or by a member's
        goes-left table where ``tables`` has one); (nleft [K] host i64, the
        smaller children's histograms [K, F, B, 3])."""
        iscats = [t is not None for t in tables]
        if self.fused:
            nl_t, _, _, _, sm = fused_grow_step(
                self.rows, begins, cnts, feats, tbins, dls, nanbs, self.B,
                quant_scales=self.qs, iscats=iscats, tables=tables, live=self.live,
            )
            return nl_t.cpu().numpy().astype(np.int64), sm
        if len(begins) == 1:  # the serial loop: the single partition
            nleft = np.array([int(sort_partition(
                self.rows, int(begins[0]), int(cnts[0]), int(feats[0]), int(tbins[0]),
                bool(dls[0]), int(nanbs[0]), tables[0],
            ))], np.int64)
        else:
            nleft = sort_partition_batch(
                self.rows, begins, cnts, feats, tbins, dls, nanbs, iscats, tables
            ).cpu().numpy().astype(np.int64)
        windows = _smaller_windows(begins, cnts, nleft)
        return nleft, seg_hist_batch(self.rows, windows, self.B, self.qs, live=self.live)

    def leaf_id(self, leaf_begin, leaf_nrows) -> torch.Tensor:
        return leaf_id_from_windows(self.rows.ridx, leaf_begin, leaf_nrows)


class _OrderedStore:
    """The ordered layout: the rows stay where they are, the i32 index
    array ``order`` holds each leaf's rows as one window (the reference's
    DataPartition), the row-major bins serve the histograms and the
    feature-major ones the partition's column reads.  Past 256 bins the
    row-major bins are u16 (the histogram's u16 mode) and the feature-major
    ones two byte planes a feature, read as lo | hi << 8."""

    def __init__(self, bins_fn, bins_nf, grad, hess, mask, num_bins: int, qs, f: int,
                 used_bins: int = 0):
        n = int(bins_fn.shape[1])
        self.wide = num_bins > RANGE_BINS
        if int(bins_fn.shape[0]) != (2 * f if self.wide else f):
            raise ValueError("the ordered layout's feature-major bins: one plane a feature, "
                             "two byte planes past 256 bins")
        if (bins_nf is None or int(bins_nf.shape[0]) != n or int(bins_nf.shape[1]) < f
                or (bins_nf.dtype == torch.uint16) != self.wide):
            raise ValueError("the ordered layout needs the [N, >= F] row-major bins (bins_nf), "
                             "u16 past 256 bins")
        self.rows = OrderedRows(
            bins=bins_nf, f=f,
            g=grad.to(torch.float32).contiguous(), h=hess.to(torch.float32).contiguous(),
            m=(mask > 0).to(torch.float32), used_bins=int(used_bins),
        )
        self.cols = bins_fn
        self.device = self.rows.device
        self.order = torch.arange(n, dtype=torch.int32, device=self.device)
        self.B, self.qs = num_bins, qs

    def _column(self, feat: int, win: torch.Tensor) -> torch.Tensor:
        """Feature ``feat``'s bins of the rows ``win`` (i64 indices): the
        u8 column, or past 256 bins its two byte planes as lo | hi << 8
        (``seg.feature_bins``)."""
        if not self.wide:
            return self.cols[feat][win]
        return (self.cols[2 * feat][win].to(torch.int64)
                | (self.cols[2 * feat + 1][win].to(torch.int64) << 8))

    def _hist(self, order, windows) -> torch.Tensor:
        if self.qs is None:
            return ordered_hist(self.rows, order, windows, self.B)
        return ordered_hist_int8(self.rows, order, windows, self.B, self.qs)

    def root_hist(self) -> torch.Tensor:
        """All rows, no index (:1335-1345)."""
        return self._hist(None, [(0, self.rows.n)])[0]

    def _partition(self, start, cnt, feat, tbin, dl, nanb, table) -> torch.Tensor:
        """Stable partition of order[start : start + cnt] (_make_part_branch,
        :1240-1272, its goes-left table :1251): left rows to [0, nleft),
        right rows to [nleft, cnt), each in their old order.  Returns nleft,
        a 0-d i32 tensor."""
        win = self.order[start : start + cnt]
        gl = go_left(self._column(feat, win.long()), tbin, dl, nanb, table)
        pos_l = torch.cumsum(gl, 0, dtype=torch.int32)
        nleft = pos_l[-1]
        pos_r = nleft + torch.cumsum(~gl, 0, dtype=torch.int32)
        pos = torch.where(gl, pos_l, pos_r) - 1
        out = torch.empty_like(win)
        out[pos.long()] = win
        self.order[start : start + cnt] = out
        return nleft

    def split(self, begins, cnts, feats, tbins, dls, nanbs, tables):
        """K partitions, then the K smaller children's histograms in one
        launch (:2437-2500; serial :1698-1747 is K = 1)."""
        zero = torch.zeros((), dtype=torch.int32, device=self.device)
        nls = [self._partition(int(s0), int(c), int(ft), int(tb), bool(dl), int(nb), tab)
               if c > 0 else zero
               for s0, c, ft, tb, dl, nb, tab in zip(begins, cnts, feats, tbins, dls, nanbs,
                                                     tables)]
        nleft = torch.stack(nls).cpu().numpy().astype(np.int64)
        return nleft, self._hist(self.order, _smaller_windows(begins, cnts, nleft))

    def leaf_id(self, leaf_begin, leaf_nrows) -> torch.Tensor:
        return leaf_id_from_windows(self.order, leaf_begin, leaf_nrows)


def grow_tree(
    bins_fn: torch.Tensor,  # [F, N] u8 feature-major bins ([2F, N] byte planes past 256 bins)
    grad: torch.Tensor,  # [N] f32
    hess: torch.Tensor,  # [N] f32
    count_mask: torch.Tensor,  # [N] f32, 1 in bag
    num_bins: torch.Tensor,  # [F] i32
    nan_bins: torch.Tensor,  # [F] i32
    feature_mask: torch.Tensor,  # [F] bool
    params: GrowerParams,
    quant_scales: Optional[torch.Tensor] = None,  # [2] f32: int8 grid
    bins_nf: Optional[torch.Tensor] = None,  # [N, stride] u8 / u16 row-major (ordered)
    bundle_end: Optional[torch.Tensor] = None,  # [F, B] i32: EFB sub-range ends
    rng: Optional[rnd.Key] = None,  # the tree's key: feature_fraction_bynode
    is_cat: Optional[torch.Tensor] = None,  # [F] bool: categorical features
) -> Tuple[TreeArrays, torch.Tensor]:
    """Grow one tree.  Returns (TreeArrays, leaf_id [N] i32 on the input
    device).  ``params.hist_mode`` picks the row store: 'seg', where
    ``quant_scales`` (``quantize.hist_acc_scales``) turns on the int8
    accumulation with the near-tie f32 refine, or 'ordered' (``bins_nf``
    needed), where ``quant_scales`` (``quantize.quantize_gradients``) put
    every histogram on the exact int8 grid (on 'seg' too with
    ``params.quantized``).  ``params.leaf_batch`` > 1 runs the
    frontier-batched loop.  ``feature_mask`` is the tree's (by-tree
    sampling): on 'seg' its live features, feature 0 always among them, are
    the only ones the histograms read (``live_features``); with
    ``params.feature_fraction_bynode`` < 1 and ``rng``, each node's
    candidates are further cut by ``node_feature_masks``.  ``bundle_end``
    (``BundleLayout.bundle_end_array``) makes the columns EFB planes: every
    leaf is decided by ``best_split``, and bundle-plane splits partition
    by their goes-left tables.  ``is_cat`` (None: no categorical feature)
    likewise sends every leaf to ``best_split``, with its categorical
    cases (``params.cat_params``), and categorical splits partition by
    their category masks."""
    p = params
    L, B = p.num_leaves, p.max_bin
    K = max(1, min(p.leaf_batch, L - 1))
    wide = B > RANGE_BINS
    f, n = int(bins_fn.shape[0]) // (2 if wide else 1), int(bins_fn.shape[1])
    nan_host = nan_bins.cpu().numpy()
    qs = quant_scales
    used = int(num_bins.max()) if wide and f else 0
    fm_host = feature_mask.detach().cpu().numpy().astype(bool).reshape(f)
    if p.hist_mode == "ordered":
        store = _OrderedStore(bins_fn, bins_nf, grad, hess, count_mask, B, qs, f, used)
        refine = False
    elif p.hist_mode == "seg":
        store = _SegStore(bins_fn, grad, hess, count_mask, B, qs, p.grow_fused, used,
                          live_features(fm_host))
        refine = qs is not None and not p.quantized
    else:
        raise ValueError(f"hist_mode={p.hist_mode!r} not yet ported to lightgbm_tpu_torch")
    dev = store.device
    tol = _F32(p.near_tie_tol)
    kw = dict(
        lambda_l1=p.lambda_l1, lambda_l2=p.lambda_l2,
        min_data_in_leaf=p.min_data_in_leaf,
        min_sum_hessian_in_leaf=p.min_sum_hessian_in_leaf,
        min_gain_to_split=p.min_gain_to_split,
        case_major=p.case_major_ties,
    )

    # the scan's per-feature inputs as its kernel reads them, once a tree
    scan_in = scan_inputs(num_bins, nan_bins, feature_mask, dev)
    bynode = p.feature_fraction_bynode < 1.0 and rng is not None

    bs_kw = {k: v for k, v in kw.items() if k != "case_major"}

    # every node's by-node mask, drawn once a tree (node seeds below
    # 2 (L + K) + 1: the batched loop's speculative members go past L) and
    # copied to the device in one go, in f32 as the scan kernel reads it
    node_table = None
    if bynode:
        node_table = torch.as_tensor(node_feature_masks(
            fm_host, rng, range(2 * (L + K) + 1), p.feature_fraction_bynode),
            dtype=torch.float32, device=dev)

    def node_masks(t0, k):
        """[2k, F] masks on the device of the children of splits t0 .. t0 +
        k - 1, the left ones' (seeds 2t + 1) then the right ones' (2t + 2);
        k = 0: [1, F], the root's; None: the tree's mask serves every node.
        Slices of the table, so no index goes to the device."""
        if node_table is None:
            return None
        if k == 0:
            return node_table[0:1]
        lo = 2 * t0 + 1
        if k == 1:
            return node_table[lo:lo + 2]
        return torch.cat([node_table[lo:lo + 2 * k:2], node_table[lo + 1:lo + 2 * k + 1:2]])

    def scan(hists, stats, masks=None, with_margin=False):
        """Candidates of the leaves with histograms ``hists`` (a list of
        [F, B, 3]) under their node masks (``masks`` [M, F], or None for
        the tree's mask): one launch and one transfer for all of them; with
        ``bundle_end``, categorical features or past 256 bins,
        ``best_split`` of each, in one batched call."""
        if bundle_end is not None or wide or is_cat is not None:
            fm = feature_mask if masks is None else masks
            return best_split_batch(torch.stack(hists), stats, num_bins, nan_bins, fm,
                                    bundle_end=bundle_end, with_margin=with_margin,
                                    is_cat=is_cat, cat_params=p.cat_params, **bs_kw)
        inputs = scan_in if masks is None else (*scan_in[:2], masks)
        return fused_best_split_batch(hists, stats, *inputs, with_margin=with_margin, **kw)

    def decide(hists, stats, windows, masks, live=None):
        """Candidates of the leaves with histograms ``hists`` under their
        by-node ``masks`` (``node_masks``).  With the int8 accumulation, a
        leaf whose near-tie margin is below the tolerance (and that is
        ``live``) is decided on an f32 histogram of its window instead (one
        launch for all such leaves, zero rows for the others); the refined
        histogram is used for this decision only.  Returns (candidates,
        near flags)."""
        if not refine:
            return scan(hists, stats, masks), [False] * len(stats)
        got = scan(hists, stats, masks, True)
        near = [bool(margin < tol) and (live is None or bool(live[i]))
                for i, (_, margin) in enumerate(got)]
        cands = [cand for cand, _ in got]
        if any(near):
            refined = store.refine_hist(
                [(s, c if nr else 0) for (s, c), nr in zip(windows, near)]
            )
            idx = [i for i, nr in enumerate(near) if nr]
            sub = None if masks is None else torch.stack([masks[i] for i in idx])
            for i, cand in zip(idx, scan([refined[i] for i in idx], [stats[i] for i in idx],
                                         sub)):
                cands[i] = cand
        return cands, near

    hist_buf = torch.zeros((L, f, B, 3), dtype=torch.float32, device=dev)
    hist_buf[0] = store.root_hist()
    totals = _sum_bins(hist_buf[0, 0].cpu().numpy())  # every row: one bin of feature 0
    (cand0,), near0 = decide([hist_buf[0]], [tuple(map(float, totals))], [(0, n)],
                             node_masks(0, 0))
    refines = int(sum(near0))

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
    cands: List[SplitCandidate] = [_NO_SPLIT] * L
    cands[0] = cand0
    gains = np.full(L, -np.inf)
    gains[0] = cand0.gain

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
    split_table: List[Optional[np.ndarray]] = [None] * nn
    split_is_cat = np.zeros(nn, bool)

    def record(t, l, new, begin, nleft, nright, cand_l, cand_r):
        """Split leaf l by its cached candidate into node t, leaves l (left)
        and new (right), with the children's candidates (reference
        Tree::Split, src/io/tree.cpp:65).  Host state only."""
        c = cands[l]
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
        split_table[t] = c.table
        split_is_cat[t] = c.is_cat
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
        cands[l], cands[new] = cand_l, cand_r
        gains[l], gains[new] = cand_l.gain, cand_r.gain

    num_leaves = 1
    steps = 0
    if K == 1:
        for t in range(nn):
            l = int(np.argmax(gains[:num_leaves]))  # first maximum
            c = cands[l]
            if not c.gain > 0.0:
                break
            new = t + 1
            begin, cnt = int(leaf_begin[l]), int(leaf_nrows[l])
            nl_a, sm = store.split([begin], [cnt], [c.feature], [c.bin], [int(c.default_left)],
                                   [int(nan_host[c.feature])], [c.table])
            nleft = int(nl_a[0])
            sm = sm[0]
            nright = cnt - nleft
            # the children's histograms in place: the smaller one as
            # accumulated, the other as parent minus it
            if nleft <= nright:
                torch.sub(hist_buf[l], sm, out=hist_buf[new])
                hist_buf[l].copy_(sm)
            else:
                hist_buf[l].sub_(sm)
                hist_buf[new].copy_(sm)

            # both children in one scan; a refined child is re-histogrammed
            # directly, never by subtraction
            cand2, near = decide(
                [hist_buf[l], hist_buf[new]],
                [(c.left_g, c.left_h, c.left_cnt), (c.right_g, c.right_h, c.right_cnt)],
                [(begin, nleft), (begin + nleft, nright)],
                node_masks(t, 1),
            )
            refines += int(sum(near))
            record(t, l, new, begin, nleft, nright, cand2[0], cand2[1])
            num_leaves += 1
            steps += 1
    else:
        while num_leaves < L:
            steps += 1
            # the K best cached gains, ties to the lowest leaf (lax.top_k)
            l_k = np.argsort(-gains, kind="stable")[:K]
            g_k = gains[l_k]
            if not g_k[0] > 0.0:
                break
            t_k = num_leaves - 1 + np.arange(K)  # node id of each member
            active = (g_k > 0.0) & (t_k < nn)
            cs = [cands[l] for l in l_k]
            begins = leaf_begin[l_k]
            cnts = np.where(active, leaf_nrows[l_k], 0)
            feats = [c.feature for c in cs]
            split = (begins, cnts, feats, [c.bin for c in cs],
                     [int(c.default_left) for c in cs], nan_host[feats], [c.table for c in cs])
            nleft, sm = store.split(*split)
            nright = cnts - nleft
            ls4 = torch.as_tensor(nleft <= nright, device=dev)[:, None, None, None]
            other = hist_buf[torch.as_tensor(l_k, device=dev)] - sm
            left_h = torch.where(ls4, sm, other)
            right_h = torch.where(ls4, other, sm)
            cand2, near2 = decide(
                list(left_h) + list(right_h),
                [(c.left_g, c.left_h, c.left_cnt) for c in cs]
                + [(c.right_g, c.right_h, c.right_cnt) for c in cs],
                list(zip(begins, nleft)) + list(zip(begins + nleft, nright)),
                node_masks(int(t_k[0]), K),
                live=np.concatenate([active, active]),
            )
            # prefix commit: strictly beat every earlier member's children
            child_best = np.maximum([c.gain for c in cand2[:K]],
                                    [c.gain for c in cand2[K:]])
            prev_max = np.maximum.accumulate(np.concatenate([[-np.inf], child_best[:-1]]))
            commit = np.logical_and.accumulate(active & (g_k > prev_max))
            ci = np.flatnonzero(commit)
            for i in ci:
                record(int(t_k[i]), int(l_k[i]), int(t_k[i]) + 1, int(begins[i]),
                       int(nleft[i]), int(nright[i]), cand2[i], cand2[K + i])
                refines += int(near2[i]) + int(near2[K + i])
            sel = torch.as_tensor(ci, device=dev)
            hist_buf[torch.as_tensor(l_k[ci], device=dev)] = left_h[sel]
            hist_buf[torch.as_tensor(t_k[ci] + 1, device=dev)] = right_h[sel]
            num_leaves += len(ci)

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
        grow_steps=steps,
        split_table=(split_table[: nl_ - 1]
                     if bundle_end is not None or is_cat is not None else None),
        split_is_cat=split_is_cat[: nl_ - 1] if is_cat is not None else None,
    )
    return tree, store.leaf_id(leaf_begin[:nl_], leaf_nrows[:nl_])


def live_features(feature_mask: np.ndarray) -> Optional[np.ndarray]:
    """The features a tree's histograms read on the seg layout: those of
    its mask, and feature 0, whose histogram gives the root's totals
    (lightgbm_tpu/ops/pallas/seg.py:62-65 keeps its group live); None when
    every feature is live.  The JAX package skips whole plane groups with
    no live feature (ops/grower.py:1104-1127); the port skips features, and
    the grower never reads a skipped one."""
    keep = np.asarray(feature_mask, bool).copy()
    if keep.size == 0 or keep.all():
        return None
    keep[0] = True
    return None if keep.all() else np.flatnonzero(keep).astype(np.int32)


def node_feature_masks(feature_mask: np.ndarray, rng, seeds, fraction: float) -> np.ndarray:
    """[M, F] bool by-node masks of the nodes ``seeds`` (the JAX grower's
    ``node_feature_mask``, ops/grower.py:864-871): the tree's mask and a
    uniform draw from ``fold_in(rng, seed)`` below ``fraction`` in f32.
    Node seeds: 0 at the root, 2t + 1 and 2t + 2 for the children of split
    t (:2052, :2673-2674)."""
    u = rnd.fold_in_uniform(rng, seeds, len(feature_mask)).numpy()
    return np.asarray(feature_mask, bool)[None, :] & (u < np.float32(fraction))


def leaf_id_from_windows(
    index: torch.Tensor, leaf_begin: np.ndarray, leaf_nrows: np.ndarray
) -> torch.Tensor:
    """Leaf of every original row: windows give the leaf of each position,
    ``index`` (the seg rows' ridx, or the ordered layout's order) maps
    positions back to rows (segpart.leaf_id_from_seg; the ordered layout's
    marker-cumsum, ops/grower.py:2955-2979)."""
    by_begin = np.argsort(leaf_begin, kind="stable")
    dev = index.device
    leaf_pos = torch.repeat_interleave(
        torch.as_tensor(by_begin, dtype=torch.int32, device=dev),
        torch.as_tensor(leaf_nrows[by_begin], dtype=torch.int64, device=dev),
    )
    leaf_id = torch.empty(int(index.shape[0]), dtype=torch.int32, device=dev)
    leaf_id[index.long()] = leaf_pos
    return leaf_id
