"""One decision tree: the bin-space record the forest walk reads, the
real-valued split a reader of the model sees, and its model text.

Counterpart of ``lightgbm_tpu/tree.py``: ``Tree.from_device_arrays`` (:100,
with its EFB decode :105-150: a bundle-plane split becomes a threshold on
the member feature; and its categorical nodes :152-171: the bins of a
category mask become a bitset of category values, ``cat_threshold`` words
between ``cat_boundaries``, the node's threshold the bitset's index),
``apply_shrinkage`` (:236),
``add_bias`` (:259), the ``decision_type`` bit field (:35-47) with the
three missing types (None, Zero, NaN), ``to_string`` (:391) and
``from_string`` (:435) in LightGBM's text format; and of the bin-space
record dicts of ``boosting/gbdt.py`` (``_bin_records``).  A tree read from
model text has no bin-space form: it is walked in real space
(``predict.predict_real_leaves``, by the streaming engine).  A block with
linear leaves raises ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

import numpy as np

from .binning import BinMapper

# decision_type bit layout (reference include/LightGBM/tree.h:21-22, :283)
K_CATEGORICAL_MASK = 1
K_DEFAULT_LEFT_MASK = 2

MISSING_NONE = 0
MISSING_ZERO = 1
MISSING_NAN = 2


def make_decision_type(default_left, missing_type, categorical=False) -> np.ndarray:
    """Decision types: the categorical bit, the default-left bit and the
    missing type."""
    dl = np.asarray(default_left, bool).astype(np.int64)
    mt = np.asarray(missing_type, np.int64)
    cat = np.asarray(categorical, bool).astype(np.int64)
    return (cat * K_CATEGORICAL_MASK | dl * K_DEFAULT_LEFT_MASK | (mt & 3) << 2).astype(np.int8)


def category_words(cats) -> list:
    """The bitset of category values ``cats`` as u32 words, up to the word
    of the largest (one word when there is none; tree.py:160-164)."""
    cats = [int(c) for c in cats]
    words = [0] * (max(cats, default=0) // 32 + 1)
    for c in cats:
        words[c // 32] |= 1 << (c % 32)
    return words


def missing_type_of(decision_type) -> np.ndarray:
    return (np.asarray(decision_type, np.int64) >> 2) & 3


def _fmt(x: float) -> str:
    """High-precision float formatting like the reference's ArrayToString<true>."""
    return repr(float(x)) if np.isfinite(x) else ("inf" if x > 0 else "-inf")


def _arr_str(arr, high_precision: bool = False) -> str:
    if high_precision:
        return " ".join(_fmt(v) for v in arr)
    out = []
    for v in arr:
        if isinstance(v, (bool, np.bool_, int, np.integer)):
            out.append(str(int(v)))
        else:
            out.append(f"{float(v):g}")
    return " ".join(out)


@dataclasses.dataclass
class Tree:
    """Structure of arrays over nodes and leaves.  Child pointers >= 0 are
    internal nodes, negative ones ``~leaf``.  ``split_feature``,
    ``split_bin`` are the bin-space split (used-feature index, bin <=
    split_bin goes left) of a tree the port grew, None for a tree read from
    model text."""

    num_leaves: int
    split_feature_real: np.ndarray  # [n-1] i32 original feature index
    threshold: np.ndarray  # [n-1] f64: value <= threshold goes left
    decision_type: np.ndarray  # [n-1] i8: default-left bit, missing type
    left_child: np.ndarray  # [n-1] i32
    right_child: np.ndarray  # [n-1] i32
    leaf_value: np.ndarray  # [n] f64
    split_gain: np.ndarray  # [n-1] f64
    leaf_weight: np.ndarray  # [n] f64: sum of hessians
    leaf_count: np.ndarray  # [n] i64
    internal_value: np.ndarray  # [n-1] f64
    internal_weight: np.ndarray  # [n-1] f64
    internal_count: np.ndarray  # [n-1] i64
    shrinkage: float = 1.0
    split_feature: Optional[np.ndarray] = None  # [n-1] i32 column of the bins
    split_bin: Optional[np.ndarray] = None  # [n-1] i32
    # [n-1] bool nodes that go left by their table, [n-1, B] bool the tables
    # (the bin-space form of a bundle-plane or a categorical split); None
    # without EFB and categorical features
    split_is_cat: Optional[np.ndarray] = None
    cat_mask: Optional[np.ndarray] = None
    # categorical nodes in real space (reference Tree::cat_boundaries_,
    # cat_threshold_): node t with the categorical bit holds the bitset
    # cat_threshold[cat_boundaries[i] : cat_boundaries[i + 1]], i =
    # threshold[t]; value v goes left when bit v & 31 of word v >> 5 is set
    num_cat: int = 0
    cat_boundaries: Optional[np.ndarray] = None  # [num_cat + 1] i64
    cat_threshold: Optional[np.ndarray] = None  # [words] u32

    @property
    def default_left(self) -> np.ndarray:
        """[n-1] bool: missing values go left."""
        return (np.asarray(self.decision_type, np.int64) & K_DEFAULT_LEFT_MASK) != 0

    # ------------------------------------------------------------------ build
    @classmethod
    def from_tree_arrays(
        cls, ta, bin_mappers: Sequence[BinMapper], used_features: Sequence[int],
        bundle_layout=None, num_bins: int = 0,
    ) -> "Tree":
        """Bin-space grower output -> Tree, thresholds from the bin upper
        bounds of the training Dataset's mappers, the node and leaf
        statistics of the grower.  With ``bundle_layout`` the columns are
        EFB planes: a bundle-plane split at plane bin t decodes to the
        member owning t and the threshold of its local bin t - start (the
        shared default bin always goes left; members have no missing
        values, so no default-left bit), and its goes-left table, [B =
        ``num_bins``] bool, is kept for the bin-space walk.  A split on a
        categorical feature becomes a categorical node: its mask's bins
        that hold a category map to their values (the NaN bin and bins past
        the categories never go left), the node's bitset, with no
        default-left bit and the mapper's missing type; its mask is kept
        likewise."""
        n = int(ta.num_leaves)
        nn = max(n - 1, 0)
        sf = np.asarray(ta.split_feature, np.int32)[:nn]
        sb = np.asarray(ta.split_bin, np.int32)[:nn]
        dl = np.asarray(ta.default_left, bool)[:nn].copy()
        real = np.zeros(nn, np.int32)
        thr = np.zeros(nn, np.float64)
        is_cat = np.zeros(nn, bool)  # goes left by its table (bin space)
        cat_node = np.zeros(nn, bool)  # a categorical decision (real space)
        boundaries, words = [0], []
        for t in range(nn):
            if bundle_layout is None:
                real[t], local = used_features[sf[t]], sb[t]
            elif bundle_layout.is_bundle(sf[t]):
                real[t], local = bundle_layout.decode(int(sf[t]), int(sb[t]))
                is_cat[t], dl[t] = True, False
            else:
                real[t], local = bundle_layout.planes[sf[t]][0], sb[t]
            mapper = bin_mappers[real[t]]
            if mapper.is_categorical:
                left = np.flatnonzero(ta.split_table[t])
                left = left[left < len(mapper.bin_to_cat)]
                thr[t] = len(boundaries) - 1
                words.extend(category_words(mapper.bin_to_cat[left]))
                boundaries.append(len(words))
                is_cat[t] = cat_node[t] = True
                dl[t] = False
                continue
            thr[t] = mapper.bin_to_threshold(int(local))
        mt = [bin_mappers[r].missing_type for r in real]
        cat_mask = None
        if ta.split_table is not None:
            cat_mask = np.zeros((nn, num_bins), bool)
            for t in np.flatnonzero(is_cat):
                cat_mask[t, : len(ta.split_table[t])] = ta.split_table[t]
        num_cat = len(boundaries) - 1
        return cls(
            num_leaves=n,
            split_feature_real=real,
            threshold=thr,
            decision_type=make_decision_type(dl, mt, cat_node),
            left_child=np.asarray(ta.left_child, np.int32)[:nn],
            right_child=np.asarray(ta.right_child, np.int32)[:nn],
            leaf_value=np.asarray(ta.leaf_value, np.float64)[:n],
            split_gain=np.asarray(ta.split_gain, np.float64)[:nn],
            leaf_weight=np.asarray(ta.leaf_weight, np.float64)[:n],
            leaf_count=np.asarray(ta.leaf_count, np.int64)[:n],
            internal_value=np.asarray(ta.internal_value, np.float64)[:nn],
            internal_weight=np.asarray(ta.internal_weight, np.float64)[:nn],
            internal_count=np.asarray(ta.internal_count, np.int64)[:nn],
            split_feature=sf,
            split_bin=sb,
            split_is_cat=None if cat_mask is None else is_cat,
            cat_mask=cat_mask,
            num_cat=num_cat,
            cat_boundaries=np.asarray(boundaries, np.int64) if num_cat else None,
            cat_threshold=np.asarray(words, np.uint32) if num_cat else None,
        )

    @classmethod
    def from_record(cls, rec: Dict[str, np.ndarray]) -> "Tree":
        """A tree from an exported bin-space record (no real thresholds,
        no statistics; ``split_is_cat`` / ``cat_mask`` kept where it has
        them)."""
        sf = np.asarray(rec["split_feature"], np.int32)
        nn = len(sf)
        return cls(
            num_leaves=nn + 1,
            split_feature_real=sf.copy(),
            threshold=np.full(nn, np.nan),
            decision_type=make_decision_type(rec["default_left"], np.zeros(nn)),
            left_child=np.asarray(rec["left_child"], np.int32),
            right_child=np.asarray(rec["right_child"], np.int32),
            leaf_value=np.asarray(rec["leaf_value"], np.float64)[: nn + 1],
            split_gain=np.zeros(nn),
            leaf_weight=np.zeros(nn + 1),
            leaf_count=np.zeros(nn + 1, np.int64),
            internal_value=np.zeros(nn),
            internal_weight=np.zeros(nn),
            internal_count=np.zeros(nn, np.int64),
            split_feature=sf,
            split_bin=np.asarray(rec["split_bin"], np.int32),
            split_is_cat=(None if rec.get("split_is_cat") is None
                          else np.asarray(rec["split_is_cat"], bool)),
            cat_mask=None if rec.get("cat_mask") is None else np.asarray(rec["cat_mask"], bool),
        )

    @classmethod
    def constant(cls, val: float) -> "Tree":
        """Tree::AsConstantTree: one leaf of value ``val``."""
        z = np.zeros(0, np.int32)
        return cls(
            num_leaves=1, split_feature_real=z, threshold=np.zeros(0),
            decision_type=np.zeros(0, np.int8), left_child=z, right_child=z,
            leaf_value=np.array([float(val)]), split_gain=np.zeros(0),
            leaf_weight=np.zeros(1), leaf_count=np.zeros(1, np.int64),
            internal_value=np.zeros(0), internal_weight=np.zeros(0),
            internal_count=np.zeros(0, np.int64), split_feature=z, split_bin=z,
        )

    # ----------------------------------------------------------------- mutate
    def apply_shrinkage(self, rate: float) -> None:
        """Tree::Shrinkage (tree.h:197).  The rate is rounded to f32 first:
        the train-score update adds leaf(f32) * rate(f32) in f32, and this
        f64 product of two f32 values rounds back to exactly that addend."""
        r = float(np.float32(rate))
        self.leaf_value = self.leaf_value * r
        self.internal_value = self.internal_value * r
        self.shrinkage *= rate

    def add_bias(self, val: float) -> None:
        """Tree::AddBias — boost_from_average folds the init score into the
        first tree."""
        self.leaf_value = self.leaf_value + val
        self.internal_value = self.internal_value + val

    def record(self) -> Dict[str, np.ndarray]:
        """The bin-space record the forest walk stacks (leaf values f32)."""
        if self.split_feature is None:
            raise ValueError("a tree read from model text has no bin-space form")
        rec = {
            "split_feature": self.split_feature,
            "split_bin": self.split_bin,
            "default_left": self.default_left,
            "left_child": self.left_child,
            "right_child": self.right_child,
            "leaf_value": self.leaf_value.astype(np.float32),
        }
        if self.cat_mask is not None:
            rec["split_is_cat"] = self.split_is_cat
            rec["cat_mask"] = self.cat_mask
        return rec

    # ---------------------------------------------------------- model text
    def to_string(self, tree_index: int) -> str:
        """LightGBM text format (reference Tree::ToString, src/io/tree.cpp:343)."""
        lines = [
            f"Tree={tree_index}",
            f"num_leaves={self.num_leaves}",
            f"num_cat={self.num_cat}",
            "split_feature=" + _arr_str(self.split_feature_real),
            "split_gain=" + _arr_str(self.split_gain),
            "threshold=" + _arr_str(self.threshold, high_precision=True),
            "decision_type=" + _arr_str(self.decision_type),
            "left_child=" + _arr_str(self.left_child),
            "right_child=" + _arr_str(self.right_child),
            "leaf_value=" + _arr_str(self.leaf_value, high_precision=True),
            "leaf_weight=" + _arr_str(self.leaf_weight, high_precision=True),
            "leaf_count=" + _arr_str(self.leaf_count),
            "internal_value=" + _arr_str(self.internal_value),
            "internal_weight=" + _arr_str(self.internal_weight),
            "internal_count=" + _arr_str(self.internal_count),
        ]
        if self.num_cat > 0:
            lines += ["cat_boundaries=" + _arr_str(self.cat_boundaries),
                      "cat_threshold=" + _arr_str(self.cat_threshold)]
        lines += [
            "is_linear=0",
            f"shrinkage={self.shrinkage:g}",
            "",
            "",
        ]
        return "\n".join(lines)

    @classmethod
    def from_string(cls, block: str) -> "Tree":
        """Parse one ``Tree=`` block of a model file (reference Tree ctor
        from string, src/io/tree.cpp:714): numeric and categorical splits."""
        kv = {}
        for line in block.splitlines():
            line = line.strip()
            if "=" in line and not line.startswith("Tree="):
                k, v = line.split("=", 1)
                kv[k] = v
        if int(kv.get("is_linear", 0)):
            raise NotImplementedError(
                "linear trees in model text not yet ported to lightgbm_tpu_torch "
                "(ROADMAP Queue 1, item 6)")
        n = int(kv["num_leaves"])
        nn = max(n - 1, 0)

        def arr(key, size, dtype):
            if key not in kv:
                return np.zeros(size, dtype)
            vals = [float(x) for x in kv[key].split()]
            if len(vals) != size:
                raise ValueError(f"model text: {key} has {len(vals)} values, not {size}")
            return np.asarray(vals, np.float64).astype(dtype)

        dt = arr("decision_type", nn, np.int8)
        num_cat = int(kv.get("num_cat", 0))
        if num_cat > 0:
            bounds = np.asarray([int(float(x)) for x in kv["cat_boundaries"].split()], np.int64)
            words = np.asarray([int(float(x)) for x in kv["cat_threshold"].split()], np.int64)
            if len(bounds) != num_cat + 1 or bounds[-1] != len(words):
                raise ValueError("model text: cat_boundaries do not match num_cat and "
                                 "cat_threshold")
        return cls(
            num_leaves=n,
            split_feature_real=arr("split_feature", nn, np.int32),
            threshold=arr("threshold", nn, np.float64),
            decision_type=dt,
            left_child=arr("left_child", nn, np.int32),
            right_child=arr("right_child", nn, np.int32),
            leaf_value=arr("leaf_value", n, np.float64),
            split_gain=arr("split_gain", nn, np.float64),
            leaf_weight=arr("leaf_weight", n, np.float64),
            leaf_count=arr("leaf_count", n, np.int64),
            internal_value=arr("internal_value", nn, np.float64),
            internal_weight=arr("internal_weight", nn, np.float64),
            internal_count=arr("internal_count", nn, np.int64),
            shrinkage=float(kv.get("shrinkage", 1.0)),
            num_cat=num_cat,
            cat_boundaries=bounds if num_cat else None,
            cat_threshold=words.astype(np.uint32) if num_cat else None,
        )
