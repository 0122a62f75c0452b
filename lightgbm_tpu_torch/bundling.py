"""Exclusive Feature Bundling (EFB): mutually exclusive sparse columns share
one bin plane.

Copy (numpy, plus one torch packer) of ``lightgbm_tpu/bundling.py``:
``BundleLayout`` (:48) with ``decode`` (:86), ``bundle_end_array`` (:108)
and ``pack_columns`` (:121), ``_eligible``, ``greedy_find_bundles`` and
``build_layout`` (:240), over the row sample of
``Dataset._find_bundle_layout`` (lightgbm_tpu/dataset.py:1302-1336).

A bundle IS a bin plane of the ``[N, P]`` bin matrix: plane bin 0 is the
shared all-default bin, and member feature ``k`` owns the sub-range
``[start_k, start_k + w_k)`` of its non-default bins (its local bin ``b``
sits at plane bin ``start_k + b - 1``).  Only numeric features (never a
categorical one) with no
missing values and the value 0 in bin 0 bundle, so "a member at its
default" always means "raw value 0" and every plane-bin split decodes to
one threshold on one original feature (``Tree.from_tree_arrays``).  Dense
columns never bundle: a column with NaNs, a nonzero default bin (negative
values) or more than half its sampled rows nonzero is no candidate.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from .binning import MissingType

# a bundle plane's bin budget (lightgbm_tpu/bundling.py:38): bundle planes
# stay byte-sized whatever max_bin, beside singleton planes of up to 2^16 bins
MAX_PLANE_BINS = 256
RANK_STRIDE = 1 << 16  # pack_tensor's key: a member's rank above its bin
# bundles past this count stop being probed; later features stay singletons
MAX_SEARCH_GROUPS = 512
# columns denser than this cannot usefully be exclusive with anything
MAX_BUNDLE_DENSITY = 0.5


@dataclasses.dataclass
class BundleLayout:
    """Plane layout of a bundled dataset: ``planes[p]`` the original
    feature ids sharing plane ``p`` (ascending; a singleton plane is the
    identity), ``starts[p]`` / ``widths[p]`` each member's sub-range
    (singletons: ``[0]`` / ``[num_bins]``), ``plane_bins[p]`` the plane's
    bins, the shared bin 0 included."""

    planes: List[List[int]]
    starts: List[List[int]]
    widths: List[List[int]]
    plane_bins: List[int]

    def __post_init__(self) -> None:
        self._pos: Dict[int, Tuple[int, int]] = {}
        for p, feats in enumerate(self.planes):
            for k, j in enumerate(feats):
                self._pos[int(j)] = (p, k)

    @property
    def num_planes(self) -> int:
        return len(self.planes)

    @property
    def has_bundles(self) -> bool:
        return any(len(p) > 1 for p in self.planes)

    def is_bundle(self, plane: int) -> bool:
        return len(self.planes[plane]) > 1

    def feature_position(self, orig: int) -> Tuple[int, int]:
        """(plane, member index) of an original used feature."""
        return self._pos[int(orig)]

    def decode(self, plane: int, plane_bin: int) -> Tuple[int, int]:
        """(original feature, feature-local bin) owning ``plane_bin``.  A
        bundle-plane candidate at plane bin ``t`` (left: every plane bin but
        ``[t, end]``) is "local bin <= t - start goes left", the shared
        default bin 0 always left; singleton planes are the identity."""
        feats = self.planes[plane]
        if len(feats) == 1:
            return feats[0], int(plane_bin)
        for j, s, w in zip(feats, self.starts[plane], self.widths[plane]):
            if s <= plane_bin < s + w:
                return j, int(plane_bin) - s
        raise ValueError(
            f"plane bin {plane_bin} is outside every sub-range of plane {plane} "
            f"(starts={self.starts[plane]}, widths={self.widths[plane]})"
        )

    def bundle_end_array(self, num_bins_padded: int) -> np.ndarray:
        """[P, B] i32: for a bundle-plane bin inside a member's sub-range,
        the sub-range's LAST bin (``best_split``'s operand); -1 elsewhere
        (singleton planes, the shared bin 0, padding)."""
        out = np.full((self.num_planes, num_bins_padded), -1, np.int32)
        for p, feats in enumerate(self.planes):
            if len(feats) < 2:
                continue
            for s, w in zip(self.starts[p], self.widths[p]):
                out[p, s : s + w] = s + w - 1
        return out

    def pack_columns(self, n: int, local_bins_of: Callable[[int], np.ndarray],
                     dtype=np.int32) -> np.ndarray:
        """The [N, P] plane matrix from each feature's own bin column
        (``local_bins_of(orig) -> [n]``).  Members write their non-default
        bins at ``start + local - 1`` in ascending feature id, so a conflict
        row (two members nonzero, allowed up to ``max_conflict_rate``)
        keeps the highest feature's value, in every packer alike."""
        out = np.zeros((n, self.num_planes), dtype=dtype)
        for p, feats in enumerate(self.planes):
            if len(feats) == 1:
                out[:, p] = local_bins_of(feats[0])
                continue
            for j, s in zip(feats, self.starts[p]):
                local = np.asarray(local_bins_of(j))
                nz = local > 0
                if nz.any():
                    out[nz, p] = (s - 1) + local[nz]
        return out

    def pack_tensor(self, local: torch.Tensor, used_features: List[int]) -> torch.Tensor:
        """``pack_columns`` of local bins [N, F_used] (column ci is original
        feature ``used_features[ci]``) on their device: [N, P] i32.  Each
        plane keeps the nonzero member of the highest rank (the ascending
        visit's last write)."""
        n, dev = int(local.shape[0]), local.device
        plane = np.zeros(len(used_features), np.int64)
        rank = np.zeros(len(used_features), np.int64)
        base = np.zeros(len(used_features), np.int64)
        for ci, j in enumerate(used_features):
            p, k = self.feature_position(j)
            plane[ci], rank[ci] = p, k
            base[ci] = self.starts[p][k] - 1 if self.is_bundle(p) else 0
        loc = local.to(torch.int32)
        packed = loc + torch.as_tensor(base, dtype=torch.int32, device=dev)
        # (rank + 1) * 2^16 + bin where the member is nonzero (a bin is
        # below 2^16, a singleton plane's past 256 too): the amax over a
        # plane's members is its highest nonzero member's bin
        key = torch.where(loc > 0, packed + RANK_STRIDE * (
            torch.as_tensor(rank, dtype=torch.int32, device=dev) + 1), 0)
        out = torch.zeros((n, self.num_planes), dtype=torch.int32, device=dev)
        idx = torch.as_tensor(plane, device=dev).expand(n, -1)
        out.scatter_reduce_(1, idx, key, "amax")
        return out % RANK_STRIDE


def _eligible(mapper, budget: int) -> bool:
    """Numeric, no missing values, value 0 in bin 0, and narrow enough to
    share a plane (the restrictions that keep a bundle's decode exact); a
    categorical column never bundles (lightgbm_tpu/bundling.py:162)."""
    return (
        not mapper.is_categorical
        and mapper.missing_type == MissingType.NONE
        and mapper.nan_bin < 0
        and default_bin(mapper) == 0
        and 2 <= mapper.num_bins
        and mapper.num_bins - 1 <= budget - 1
    )


def default_bin(mapper) -> int:
    """The bin of the value 0.0 (lightgbm_tpu/binning.py:366-368)."""
    if mapper.missing_type == MissingType.ZERO:
        return mapper.nan_bin
    return int(np.searchsorted(mapper.bin_upper_bound, 0.0, side="left"))


def greedy_find_bundles(
    nz_lists: List[np.ndarray],
    widths: np.ndarray,
    sample_n: int,
    max_conflict_rate: float,
    budget: int = MAX_PLANE_BINS,
    max_search: int = MAX_SEARCH_GROUPS,
) -> List[List[int]]:
    """Greedy conflict-count bundling (reference FindGroups): candidates in
    column order; each joins the first open bundle whose accumulated
    conflicts stay within ``max_conflict_rate * sample_n`` and whose bins
    still fit the budget, else opens a new one.  ``nz_lists[i]``: sorted
    sample rows where candidate i is nonzero; ``widths[i]``: the plane bins
    it needs.  Returns groups of candidate indices, singletons included."""
    max_err = max_conflict_rate * max(sample_n, 1)
    occupancy = np.zeros((0, sample_n), bool)
    conflicts: List[float] = []
    used_bins: List[int] = []
    groups: List[List[int]] = []
    extra_singletons: List[List[int]] = []
    for fi, nz in enumerate(nz_lists):
        w = int(widths[fi])
        gsel = -1
        if occupancy.shape[0]:
            if len(nz):
                cnt = occupancy[:, nz].sum(axis=1)
            else:
                cnt = np.zeros(occupancy.shape[0], np.int64)
            ok = ((np.asarray(conflicts) + cnt <= max_err)
                  & (np.asarray(used_bins) + w <= budget - 1))
            hits = np.flatnonzero(ok)
            if len(hits):
                gsel = int(hits[0])
        if gsel >= 0:
            groups[gsel].append(fi)
            conflicts[gsel] += float(cnt[gsel])
            used_bins[gsel] += w
            if len(nz):
                occupancy[gsel, nz] = True
        elif occupancy.shape[0] >= max_search:
            extra_singletons.append([fi])
        else:
            groups.append([fi])
            conflicts.append(0.0)
            used_bins.append(w)
            row = np.zeros((1, sample_n), bool)
            if len(nz):
                row[0, nz] = True
            occupancy = np.concatenate([occupancy, row], axis=0)
    return groups + extra_singletons


def build_layout(
    used_features: List[int],
    bin_mappers,
    nonzeros_of: Callable[[int], np.ndarray],
    sample_n: int,
    max_conflict_rate: float = 0.0,
    budget: int = MAX_PLANE_BINS,
) -> Optional[BundleLayout]:
    """The plane layout, or None when nothing bundles (the bin matrix stays
    the unbundled one).  ``nonzeros_of(j)``: sorted rows of the bundling
    sample (``sample_n`` rows) where column j is nonzero.  Each plane sits
    at the position of its lowest original feature, so unbundled features
    keep their relative order."""
    if len(used_features) < 2:
        return None
    cand: List[int] = []
    nz_lists: List[np.ndarray] = []
    widths: List[int] = []
    for j in used_features:
        m = bin_mappers[j]
        if not _eligible(m, budget):
            continue
        nz = np.asarray(nonzeros_of(j))
        if len(nz) > MAX_BUNDLE_DENSITY * sample_n:
            continue
        cand.append(j)
        nz_lists.append(nz)
        widths.append(m.num_bins - 1)
    if len(cand) < 2:
        return None
    groups = greedy_find_bundles(nz_lists, np.asarray(widths), sample_n,
                                 max_conflict_rate, budget)
    if not any(len(g) > 1 for g in groups):
        return None
    bundled_of: Dict[int, List[int]] = {}
    for g in groups:
        if len(g) > 1:
            feats = sorted(cand[i] for i in g)
            for j in feats:
                bundled_of[j] = feats
    planes: List[List[int]] = []
    starts: List[List[int]] = []
    widths_out: List[List[int]] = []
    plane_bins: List[int] = []
    seen = set()
    for j in used_features:
        if j in seen:
            continue
        feats = bundled_of.get(j)
        if feats is None:
            planes.append([j])
            starts.append([0])
            widths_out.append([bin_mappers[j].num_bins])
            plane_bins.append(bin_mappers[j].num_bins)
            continue
        seen.update(feats)
        ss, ww = [], []
        s = 1  # plane bin 0: the shared all-default bin
        for f in feats:
            w = bin_mappers[f].num_bins - 1
            ss.append(s)
            ww.append(w)
            s += w
        planes.append(list(feats))
        starts.append(ss)
        widths_out.append(ww)
        plane_bins.append(s)
    return BundleLayout(planes=planes, starts=starts, widths=widths_out, plane_bins=plane_bins)
