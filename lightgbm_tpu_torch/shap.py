"""SHAP feature contributions (``pred_contrib``) by exact TreeSHAP.

Counterpart of ``lightgbm_tpu/shap.py`` (reference ``Tree::TreeSHAP`` /
``GBDT::PredictContrib``, Lundberg et al.'s algorithm), host numpy as
there: contributions explain a model, they are not on a hot path.  The
recursion over a tree's nodes is the JAX package's, taken for all rows at
once: the path's feature indices and zero fractions do not depend on the
row, so only its one fractions (0 or 1: whether the row follows the split)
and path weights are [N] vectors, and a node recurses into its left child
and then its right one, the row's own ("hot") child taking the incoming
one fraction and the other child 0.  The JAX package recurses into each
row's hot child first; the sums differ from its only in the order of the
contributions' additions.  Decisions are the real-space ones of the model
text (``Tree._decide``: numeric thresholds with the three missing types,
categorical bitsets).

Output layout as LightGBM's: ``[N, num_features + 1]`` for one model per
iteration, the last column the expected value (bias); ``[N, k
(num_features + 1)]`` for k trees an iteration, class by class (tree t
explains class t % k; lightgbm_tpu/shap.py:215-228).
"""

from __future__ import annotations

from typing import List

import numpy as np

from .binning import K_ZERO_THRESHOLD
from .tree import K_CATEGORICAL_MASK, K_DEFAULT_LEFT_MASK, MISSING_NAN, MISSING_ZERO, Tree


class _Path:
    """The unique path of a recursion, ``depth + 1`` elements: feature
    index and zero fraction (scalars), one fraction and path weight ([N])."""

    def __init__(self, feature: List[int], zero: List[float], one: List[np.ndarray],
                 pweight: List[np.ndarray]):
        self.feature, self.zero, self.one, self.pweight = feature, zero, one, pweight

    def extended(self, depth: int, zero: float, one: np.ndarray, feature: int) -> "_Path":
        """A copy of the first ``depth`` elements with one more (reference
        ExtendPath)."""
        n = one.shape[0]
        path = _Path(self.feature[:depth] + [feature], self.zero[:depth] + [zero],
                     self.one[:depth] + [one],
                     [p.copy() for p in self.pweight[:depth]]
                     + [np.ones(n) if depth == 0 else np.zeros(n)])
        pw = path.pweight
        for i in range(depth - 1, -1, -1):
            pw[i + 1] += one * pw[i] * (i + 1) / (depth + 1)
            pw[i] = zero * pw[i] * (depth - i) / (depth + 1)
        return path

    def unwind(self, depth: int, index: int) -> None:
        """Undo element ``index`` (reference UnwindPath)."""
        one, zero = self.one[index], self.zero[index]
        pw = self.pweight
        nz = one != 0
        safe = np.where(nz, one, 1.0)
        nxt = pw[depth].copy()
        with np.errstate(divide="ignore", invalid="ignore"):
            for i in range(depth - 1, -1, -1):
                tmp = pw[i]
                on = nxt * (depth + 1) / ((i + 1) * safe)
                off = tmp * (depth + 1) / (zero * (depth - i))
                pw[i] = np.where(nz, on, off)
                nxt = np.where(nz, tmp - pw[i] * zero * (depth - i) / (depth + 1), nxt)
        for i in range(index, depth):
            self.feature[i] = self.feature[i + 1]
            self.zero[i] = self.zero[i + 1]
            self.one[i] = self.one[i + 1]

    def unwound_sum(self, depth: int, index: int) -> np.ndarray:
        """The path weight with element ``index`` undone, summed (reference
        UnwoundPathSum)."""
        one, zero = self.one[index], self.zero[index]
        pw = self.pweight
        nz = one != 0
        safe = np.where(nz, one, 1.0)
        nxt = pw[depth].copy()
        total = np.zeros_like(nxt)
        with np.errstate(divide="ignore", invalid="ignore"):
            for i in range(depth - 1, -1, -1):
                tmp = nxt * (depth + 1) / ((i + 1) * safe)
                off = pw[i] / (zero * (depth - i) / (depth + 1))
                total += np.where(nz, tmp, off)
                nxt = np.where(nz, pw[i] - tmp * zero * (depth - i) / (depth + 1), nxt)
        return total


def _goes_left(tree: Tree, node: int, col: np.ndarray) -> np.ndarray:
    """[N] bool: the rows' values ``col`` of the node's feature go left."""
    dt = int(tree.decision_type[node])
    if dt & K_CATEGORICAL_MASK:
        ok = ~np.isnan(col) & (col >= 0) & (col < 2.0**31)
        c = np.where(ok, col, 0).astype(np.int64)
        i = int(tree.threshold[node])
        b0, b1 = int(tree.cat_boundaries[i]), int(tree.cat_boundaries[i + 1])
        w = c >> 5
        ok &= b0 + w < b1
        words = np.asarray(tree.cat_threshold, np.int64)
        word = words[np.where(ok, b0 + w, b0)] if len(words) else np.zeros_like(c)
        return ok & (((word >> (c & 31)) & 1) != 0)
    missing = (dt >> 2) & 3
    isnan = np.isnan(col)
    val = np.where(isnan & (missing != MISSING_NAN), 0.0, col)
    miss = ((missing == MISSING_ZERO) & (np.abs(val) <= K_ZERO_THRESHOLD)) | (
        (missing == MISSING_NAN) & isnan)
    with np.errstate(invalid="ignore"):
        return np.where(miss, bool(dt & K_DEFAULT_LEFT_MASK), val <= tree.threshold[node])


def _weight(tree: Tree, node: int) -> float:
    """Training rows through a node (internal_count) or a leaf (leaf_count)."""
    return float(tree.leaf_count[~node] if node < 0 else tree.internal_count[node])


def _recurse(tree: Tree, x: np.ndarray, phi: np.ndarray, node: int, depth: int,
             parent: _Path, zero: float, one: np.ndarray, feature: int) -> None:
    path = parent.extended(depth, zero, one, feature)
    if node < 0:
        value = float(tree.leaf_value[~node])
        for i in range(1, depth + 1):
            w = path.unwound_sum(depth, i)
            phi[:, path.feature[i]] += w * (path.one[i] - path.zero[i]) * value
        return
    f = int(tree.split_feature_real[node])
    left = _goes_left(tree, node, x[:, f])
    lc, rc = int(tree.left_child[node]), int(tree.right_child[node])
    w_node = max(_weight(tree, node), 1e-300)
    in_zero, in_one = 1.0, np.ones(x.shape[0])
    # a feature already on the path: undo its earlier split
    index = next((i for i in range(1, depth + 1) if path.feature[i] == f), -1)
    if index >= 0:
        in_zero, in_one = path.zero[index], path.one[index]
        path.unwind(depth, index)
        depth -= 1
    _recurse(tree, x, phi, lc, depth + 1, path, _weight(tree, lc) / w_node * in_zero,
             in_one * left, f)
    _recurse(tree, x, phi, rc, depth + 1, path, _weight(tree, rc) / w_node * in_zero,
             in_one * ~left, f)


def tree_expected_value(tree: Tree) -> float:
    """The leaf-count weighted mean output (the mean leaf value when no
    leaf has a count)."""
    counts = np.asarray(tree.leaf_count[: tree.num_leaves], np.float64)
    values = np.asarray(tree.leaf_value[: tree.num_leaves], np.float64)
    total = float(counts.sum())
    if total <= 0:
        return float(np.mean(values))
    return float((values * counts).sum() / total)


def tree_shap(tree: Tree, x: np.ndarray, num_features: int) -> np.ndarray:
    """[N, num_features + 1]: each row's contributions of one tree, and
    its expected value last."""
    phi = np.zeros((x.shape[0], num_features + 1))
    if tree.num_leaves <= 1:
        phi[:, -1] = float(tree.leaf_value[0])
        return phi
    phi[:, -1] = tree_expected_value(tree)
    _recurse(tree, x, phi, 0, 0, _Path([], [], [], []), 1.0, np.ones(x.shape[0]), -1)
    return phi


def predict_contrib(booster, x: np.ndarray, t0: int, t1: int) -> np.ndarray:
    """The contributions of trees [t0, t1) summed by class: [N, F + 1] for
    one tree an iteration, else [N, k (F + 1)], F the model's
    ``max_feature_idx + 1``."""
    x = np.asarray(x, np.float64)
    k = booster.num_class
    num_f = booster.max_feature_idx + 1
    if x.shape[1] < num_f:
        raise ValueError(f"data has {x.shape[1]} columns, the model has {num_f} features")
    out = np.zeros((x.shape[0], k, num_f + 1))
    for t in range(t0, t1):
        out[:, t % k] += tree_shap(booster.trees[t], x, num_f)
    return out[:, 0] if k == 1 else out.reshape(x.shape[0], k * (num_f + 1))
