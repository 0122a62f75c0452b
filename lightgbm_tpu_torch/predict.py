"""Stacked trees and the plain level-synchronous walkers.

Counterpart of ``lightgbm_tpu/predict.py``: ``stack_bin_trees`` pads the
per-tree records into ``[T, M]`` arrays and ``predict_bins_leaves`` /
``predict_bins_raw`` walk every row through every tree one level at a time
(``_walk``, predict.py:180-238).  This walker is the plain version the
forest-walk kernel (``ops/forest_walk.py``) is held against, and the
booster's walker for a model the kernel rejects (``walk_reject_reason``),
on the booster's device: the JAX package's XLA fallback, and the walker of
every EFB model (a bundle-plane node goes left by its [B] goes-left table,
``cat_mask``, as predict.py:63, :199-226 walk it; the JAX package declines
its walk kernel for such models, boosting/gbdt.py:2872-2875).

``stack_real_trees`` / ``predict_real_leaves`` / ``predict_real_raw`` are
the real-space walker of a model read from text, which has no bin mappers
(predict.py:133-284 and ``Tree._decide``, tree.py:286-305): NumericalDecision
on the raw values, with the None, Zero and NaN missing types, and
CategoricalDecision (a NaN or negative value goes right, else the bit of
``int(value)`` in the node's bitset goes left, a value past its words
right).  It decides
in f64 (the JAX package walks in f32 and re-walks the rows near a threshold
in f64, so its decisions are the f64 ones) and sums f64 leaf values.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

from .binning import K_ZERO_THRESHOLD
from .tree import K_CATEGORICAL_MASK, MISSING_NAN, MISSING_ZERO, missing_type_of


class BinTreeBatch(NamedTuple):
    split_feature: torch.Tensor  # [T, M] i64 used-feature index
    split_bin: torch.Tensor  # [T, M] i64
    default_left: torch.Tensor  # [T, M] bool
    nan_bin: torch.Tensor  # [T, M] i64 NaN bin of the node's feature, -1 none
    left_child: torch.Tensor  # [T, M] i64 (neg = ~leaf)
    right_child: torch.Tensor  # [T, M] i64
    leaf_value: torch.Tensor  # [T, Lm] f32
    split_is_cat: torch.Tensor  # [T, M] bool: the node goes left by its table
    cat_mask: torch.Tensor  # [T, M, Bm] bool goes-left tables (Bm = 1: none)


def stack_bin_trees(records: Sequence[dict], nan_bins: np.ndarray, device) -> BinTreeBatch:
    """Pad bin-space records to [T, M]; a single-leaf tree routes every row
    to leaf 0 from node 0.  Records with ``split_is_cat`` / ``cat_mask``
    (EFB) give the tables, as wide as the widest."""
    t = len(records)
    m = max([len(r["split_feature"]) for r in records] + [1])
    lm = max(len(r["leaf_value"]) for r in records)
    arr = {k: np.zeros((t, m), np.int64) for k in ("sf", "sb", "dl", "lc", "rc")}
    arr["lc"][:] = -1
    arr["rc"][:] = -1
    leaf = np.zeros((t, lm), np.float32)
    for i, r in enumerate(records):
        nn = len(r["split_feature"])
        arr["sf"][i, :nn] = r["split_feature"]
        arr["sb"][i, :nn] = r["split_bin"]
        arr["dl"][i, :nn] = r["default_left"]
        arr["lc"][i, :nn] = r["left_child"]
        arr["rc"][i, :nn] = r["right_child"]
        leaf[i, : len(r["leaf_value"])] = r["leaf_value"]
    bm = max([np.asarray(r["cat_mask"]).shape[1] for r in records
              if r.get("cat_mask") is not None and np.size(r["cat_mask"])] + [1])
    is_cat = np.zeros((t, m), bool)
    cmask = np.zeros((t, m, bm), bool)
    for i, r in enumerate(records):
        if r.get("cat_mask") is not None and np.size(r["cat_mask"]):
            cm = np.asarray(r["cat_mask"], bool)
            is_cat[i, : len(r["split_is_cat"])] = r["split_is_cat"]
            cmask[i, : cm.shape[0], : cm.shape[1]] = cm
    nan_bins = np.asarray(nan_bins, np.int64)
    as_t = lambda a: torch.as_tensor(a, device=device)
    return BinTreeBatch(
        split_feature=as_t(arr["sf"]),
        split_bin=as_t(arr["sb"]),
        default_left=as_t(arr["dl"] != 0),
        nan_bin=as_t(np.where(arr["sf"] >= 0, nan_bins[arr["sf"]], -1)),
        left_child=as_t(arr["lc"]),
        right_child=as_t(arr["rc"]),
        leaf_value=as_t(leaf),
        split_is_cat=as_t(is_cat),
        cat_mask=as_t(cmask),
    )


def predict_bins_leaves(batch: BinTreeBatch, bins: torch.Tensor) -> torch.Tensor:
    """Leaf index [N, T] of every row in every tree; bins [N, F].  A table
    node sends a row left by its table's entry of the row's bin (a bin past
    the table goes right)."""
    n = bins.shape[0]
    t = batch.split_feature.shape[0]
    trees = torch.arange(t, device=bins.device)[None, :]
    nodes = torch.zeros((n, t), dtype=torch.int64, device=bins.device)
    while bool((nodes >= 0).any()):
        cur = torch.clamp(nodes, min=0)
        feat = batch.split_feature[trees, cur]
        fval = torch.gather(bins, 1, feat).long()
        nb = batch.nan_bin[trees, cur]
        gl = (fval <= batch.split_bin[trees, cur]) | (
            batch.default_left[trees, cur] & (nb >= 0) & (fval == nb)
        )
        bm = batch.cat_mask.shape[-1]
        if bm > 1:
            gl_cat = batch.cat_mask[trees, cur, torch.clamp(fval, max=bm - 1)] & (fval < bm)
            gl = torch.where(batch.split_is_cat[trees, cur], gl_cat, gl)
        nxt = torch.where(gl, batch.left_child[trees, cur], batch.right_child[trees, cur])
        nodes = torch.where(nodes >= 0, nxt, nodes)
    return ~nodes


def predict_bins_raw(batch: BinTreeBatch, bins: torch.Tensor, k: int) -> torch.Tensor:
    """Raw scores [N, k]: leaf values of tree t summed into class t % k,
    trees in order, in f32."""
    leaves = predict_bins_leaves(batch, bins)
    t = leaves.shape[1]
    trees = torch.arange(t, device=bins.device)[None, :]
    vals = batch.leaf_value[trees, leaves]
    out = torch.zeros((bins.shape[0], k), dtype=torch.float32, device=bins.device)
    for i in range(t):
        out[:, i % k] += vals[:, i]
    return out


class RealTreeBatch(NamedTuple):
    split_feature: torch.Tensor  # [T, M] i64 original feature index
    threshold: torch.Tensor  # [T, M] f64
    missing_type: torch.Tensor  # [T, M] i64
    default_left: torch.Tensor  # [T, M] bool
    left_child: torch.Tensor  # [T, M] i64 (neg = ~leaf)
    right_child: torch.Tensor  # [T, M] i64
    leaf_value: torch.Tensor  # [T, Lm] f64
    is_cat: torch.Tensor  # [T, M] bool: a categorical decision
    cat_begin: torch.Tensor  # [T, M] i64: the node's first word in cat_words
    cat_nwords: torch.Tensor  # [T, M] i64: its words (0 for a numeric node)
    cat_words: torch.Tensor  # [W + 1] i64: every tree's bitset words, then a 0


def stack_real_trees(trees: Sequence, device) -> RealTreeBatch:
    """Pad real-space trees (``tree.Tree``) to [T, M]; a single-leaf tree
    routes every row to leaf 0 from node 0."""
    t = len(trees)
    m = max([tr.num_leaves - 1 for tr in trees] + [1])
    lm = max([tr.num_leaves for tr in trees] + [1])
    sf = np.zeros((t, m), np.int64)
    dt = np.zeros((t, m), np.int64)
    thr = np.zeros((t, m), np.float64)
    lc = np.full((t, m), -1, np.int64)
    rc = np.full((t, m), -1, np.int64)
    leaf = np.zeros((t, lm), np.float64)
    cat_begin = np.zeros((t, m), np.int64)
    cat_nwords = np.zeros((t, m), np.int64)
    words = []
    for i, tr in enumerate(trees):
        nn = tr.num_leaves - 1
        sf[i, :nn] = tr.split_feature_real
        dt[i, :nn] = tr.decision_type
        thr[i, :nn] = tr.threshold
        lc[i, :nn] = tr.left_child
        rc[i, :nn] = tr.right_child
        leaf[i, : tr.num_leaves] = tr.leaf_value
        if tr.num_cat:
            cat = np.flatnonzero(np.asarray(tr.decision_type[:nn], np.int64) & K_CATEGORICAL_MASK)
            idx = np.asarray(tr.threshold, np.float64)[cat].astype(np.int64)
            cat_begin[i, cat] = len(words) + tr.cat_boundaries[idx]
            cat_nwords[i, cat] = tr.cat_boundaries[idx + 1] - tr.cat_boundaries[idx]
            words.extend(int(w) for w in tr.cat_threshold)
    as_t = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
    return RealTreeBatch(
        split_feature=as_t(sf),
        threshold=as_t(thr),
        missing_type=as_t(missing_type_of(dt)),
        default_left=as_t((dt & 2) != 0),
        left_child=as_t(lc),
        right_child=as_t(rc),
        leaf_value=as_t(leaf),
        is_cat=as_t((dt & K_CATEGORICAL_MASK) != 0),
        cat_begin=as_t(cat_begin),
        cat_nwords=as_t(cat_nwords),
        cat_words=as_t(np.asarray(words + [0], np.int64)),
    )


def predict_real_leaves(batch: RealTreeBatch, x: torch.Tensor) -> torch.Tensor:
    """Leaf index [N, T] of every row in every tree; x [N, F] f64 raw
    values.  A NaN is 0 unless the node's missing type is NaN; a missing
    value (NaN for NaN, |v| <= 1e-35 for Zero) takes the default side,
    else ``v <= threshold`` goes left.  At a categorical node a NaN or
    negative value goes right, else v's integer part c goes left when bit c
    & 31 of the node's word c >> 5 is set (a word past the node's goes
    right)."""
    n = x.shape[0]
    t = batch.split_feature.shape[0]
    trees = torch.arange(t, device=x.device)[None, :]
    nodes = torch.zeros((n, t), dtype=torch.int64, device=x.device)
    while bool((nodes >= 0).any()):
        cur = torch.clamp(nodes, min=0)
        fval = torch.gather(x, 1, batch.split_feature[trees, cur])
        mt = batch.missing_type[trees, cur]
        isnan = torch.isnan(fval)
        fval = torch.where(isnan & (mt != MISSING_NAN), torch.zeros_like(fval), fval)
        missing = ((mt == MISSING_ZERO) & (fval.abs() <= K_ZERO_THRESHOLD)) | (
            (mt == MISSING_NAN) & isnan)
        gl = torch.where(missing, batch.default_left[trees, cur],
                         fval <= batch.threshold[trees, cur])
        if len(batch.cat_words) > 1:
            raw = torch.gather(x, 1, batch.split_feature[trees, cur])
            # values past 2^31 lie past every bitset: go right
            ok = ~torch.isnan(raw) & (raw >= 0) & (raw < 2.0**31)
            c = torch.where(ok, raw, torch.zeros_like(raw)).long()
            w = c >> 5
            ok &= w < batch.cat_nwords[trees, cur]
            word = batch.cat_words[torch.where(ok, batch.cat_begin[trees, cur] + w, -1)]
            gl_cat = ok & (((word >> (c & 31)) & 1) != 0)
            gl = torch.where(batch.is_cat[trees, cur], gl_cat, gl)
        nxt = torch.where(gl, batch.left_child[trees, cur], batch.right_child[trees, cur])
        nodes = torch.where(nodes >= 0, nxt, nodes)
    return ~nodes


def predict_real_raw(batch: RealTreeBatch, x: torch.Tensor) -> torch.Tensor:
    """Raw scores [N] f64: the trees' leaf values summed."""
    leaves = predict_real_leaves(batch, x)
    trees = torch.arange(leaves.shape[1], device=x.device)[None, :]
    return batch.leaf_value[trees, leaves].sum(dim=1)
