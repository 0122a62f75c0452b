"""Carry a model trained by the JAX package across to the port.

``booster_from_arrays`` takes plain numpy arrays and dicts — a JAX
booster's bin-space tree records (``Booster._bin_records``) and its
Dataset's bin mappers, and its EFB layout where it has one
(``layout_from_arrays``) — and returns a port ``Booster`` that predicts
what the JAX booster predicts: through the forest walk, or, for a bundled
model, through the plain walker with its nodes' goes-left tables.  A model
trained with categorical features carries its categorical mappers
(``bin_to_cats``) and its records' category masks (``split_is_cat``,
``cat_mask``) across.  A multiclass model (k trees an iteration, tree t
of class t % k) carries its ``num_class``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from .binning import BinMapper
from .boosting.gbdt import Booster
from .bundling import BundleLayout
from .device import resolve_device
from .objectives import create_objective
from .tree import Tree


def booster_from_arrays(
    records: Sequence[dict],
    bin_upper_bounds: Sequence[np.ndarray],
    missing_types: Sequence[int],
    nan_bins: Sequence[int],
    init_score: float,
    objective: str,
    num_class: int = 1,
    device=None,
    used_features: Optional[Sequence[int]] = None,
    bundle_layout: Optional[BundleLayout] = None,
    bin_to_cats: Optional[Sequence[Optional[np.ndarray]]] = None,
) -> Booster:
    """A predict-only Booster.

    objective: the objective's name (its output conversion; the multiclass
        ones with ``num_class`` classes, ``num_class`` trees an iteration);
    records: per tree, ``split_feature`` (used-feature index), ``split_bin``,
        ``default_left``, ``left_child``, ``right_child`` (``~leaf`` for
        leaves) and f32 ``leaf_value`` (shrunk, the first tree holding the
        boost-from-average bias, as the JAX package's records do);
    bin_upper_bounds, missing_types, nan_bins: per used feature, the bin
        mapper of the training Dataset;
    init_score: a constant added to every raw score (0 for records whose
        first tree already holds the bias);
    used_features: the original column of each used feature (default: the
        columns of ``predict``'s input are the used features, in order);
    bundle_layout: the training Dataset's EFB planes; the records' columns
        are then planes, and a bundle-plane node carries ``split_is_cat``
        and its ``cat_mask`` row, as the JAX package's records do;
    bin_to_cats: per used feature, the category of each bin of a
        categorical feature's mapper (its ``bin_to_cat``), None for a
        numeric feature; a categorical node of the records then carries
        ``split_is_cat`` and its ``cat_mask`` row.
    """
    params = {"objective": objective}
    if num_class != 1:
        params["num_class"] = num_class
    b = Booster(params, device=resolve_device(device))
    b.objective = create_objective(b.config, np.zeros(0), b.device)
    b.num_class = b.config.num_tree_per_iteration()
    b.trees = [Tree.from_record(r) for r in records]
    f = len(bin_upper_bounds)
    used = list(range(f)) if used_features is None else [int(j) for j in used_features]
    mappers = [None] * (max(used) + 1 if used else 0)
    cats = [None] * f if bin_to_cats is None else list(bin_to_cats)
    for j, ub, mt, nb, bc in zip(used, bin_upper_bounds, missing_types, nan_bins, cats):
        ub = np.asarray(ub, np.float64)
        if bc is None:
            mappers[j] = BinMapper(ub, int(mt), len(ub) + (1 if nb >= 0 else 0), int(nb))
            continue
        bc = np.asarray(bc, np.int64)
        mappers[j] = BinMapper(
            np.array([np.inf]), int(mt), len(bc) + (1 if nb >= 0 else 0), int(nb),
            float(bc.min(initial=0)), float(bc.max(initial=0)), is_categorical=True,
            cat_to_bin={int(c): i for i, c in enumerate(bc)}, bin_to_cat=bc)
    b.bin_mappers = mappers
    b.used_features = used
    b.nan_bins = np.asarray(nan_bins, np.int32)
    b.bundle_layout = bundle_layout
    if bundle_layout is not None:  # a bundle plane has no NaN bin
        b.nan_bins = np.array([mappers[p[0]].nan_bin if len(p) == 1 else -1
                               for p in bundle_layout.planes], np.int32)
    nb = [m.num_bins for m in mappers if m is not None]
    b._max_bin = 1 << max(0, (max(nb, default=2) - 1).bit_length())
    b.init_score = float(init_score)
    return b


def layout_from_arrays(planes, starts, widths, plane_bins) -> BundleLayout:
    """The port's ``BundleLayout`` from the lists of one (a JAX package's
    ``BundleLayout`` carries the same four)."""
    return BundleLayout(
        planes=[[int(j) for j in p] for p in planes],
        starts=[[int(v) for v in p] for p in starts],
        widths=[[int(v) for v in p] for p in widths],
        plane_bins=[int(v) for v in plane_bins],
    )
