"""One decision tree: the bin-space record the forest walk reads, and the
real-valued thresholds a reader of the model sees.

Counterpart of ``lightgbm_tpu/tree.py`` (``Tree.from_device_arrays`` :100,
``apply_shrinkage`` :236, ``add_bias`` :259) for numeric splits, and of the
bin-space record dicts of ``boosting/gbdt.py`` (``_bin_records``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Sequence

import numpy as np

from .binning import BinMapper


@dataclasses.dataclass
class Tree:
    """Structure of arrays over nodes and leaves.  Child pointers >= 0 are
    internal nodes, negative ones ``~leaf``."""

    num_leaves: int
    split_feature: np.ndarray  # [n-1] i32 used-feature index (bin space)
    split_bin: np.ndarray  # [n-1] i32: bin <= split_bin goes left
    default_left: np.ndarray  # [n-1] bool: the NaN bin goes left
    left_child: np.ndarray  # [n-1] i32
    right_child: np.ndarray  # [n-1] i32
    leaf_value: np.ndarray  # [n] f64
    split_feature_real: np.ndarray  # [n-1] i32 original feature index
    threshold: np.ndarray  # [n-1] f64: value <= threshold goes left

    @classmethod
    def from_tree_arrays(
        cls, ta, bin_mappers: Sequence[BinMapper], used_features: Sequence[int]
    ) -> "Tree":
        """Bin-space grower output -> Tree, thresholds from the bin upper
        bounds of the training Dataset's mappers."""
        n = int(ta.num_leaves)
        nn = max(n - 1, 0)
        sf = np.asarray(ta.split_feature, np.int32)[:nn]
        sb = np.asarray(ta.split_bin, np.int32)[:nn]
        real = np.array([used_features[j] for j in sf], np.int32)
        thr = np.array(
            [bin_mappers[r].bin_to_threshold(int(b)) for r, b in zip(real, sb)],
            np.float64,
        )
        return cls(
            num_leaves=n,
            split_feature=sf,
            split_bin=sb,
            default_left=np.asarray(ta.default_left, bool)[:nn],
            left_child=np.asarray(ta.left_child, np.int32)[:nn],
            right_child=np.asarray(ta.right_child, np.int32)[:nn],
            leaf_value=np.asarray(ta.leaf_value, np.float64)[:n],
            split_feature_real=real,
            threshold=thr,
        )

    @classmethod
    def from_record(cls, rec: Dict[str, np.ndarray]) -> "Tree":
        """A tree from an exported bin-space record (no real thresholds)."""
        sf = np.asarray(rec["split_feature"], np.int32)
        nn = len(sf)
        return cls(
            num_leaves=nn + 1,
            split_feature=sf,
            split_bin=np.asarray(rec["split_bin"], np.int32),
            default_left=np.asarray(rec["default_left"], bool),
            left_child=np.asarray(rec["left_child"], np.int32),
            right_child=np.asarray(rec["right_child"], np.int32),
            leaf_value=np.asarray(rec["leaf_value"], np.float64)[: nn + 1],
            split_feature_real=sf.copy(),
            threshold=np.full(nn, np.nan),
        )

    def apply_shrinkage(self, rate: float) -> None:
        """Tree::Shrinkage (tree.h:197).  The rate is rounded to f32 first:
        the train-score update adds leaf(f32) * rate(f32) in f32, and this
        f64 product of two f32 values rounds back to exactly that addend."""
        r = float(np.float32(rate))
        self.leaf_value = self.leaf_value * r

    def add_bias(self, val: float) -> None:
        """Tree::AddBias — boost_from_average folds the init score into the
        first tree."""
        self.leaf_value = self.leaf_value + val

    def record(self) -> Dict[str, np.ndarray]:
        """The bin-space record the forest walk stacks (leaf values f32)."""
        return {
            "split_feature": self.split_feature,
            "split_bin": self.split_bin,
            "default_left": self.default_left,
            "left_child": self.left_child,
            "right_child": self.right_child,
            "leaf_value": self.leaf_value.astype(np.float32),
        }
