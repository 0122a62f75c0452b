"""Exclusive Feature Bundling: the search only, so that a Dataset whose
columns would bundle is refused rather than trained unbundled.

Copy (numpy only) of the part of ``lightgbm_tpu/bundling.py`` that decides
whether any bundle forms: ``_eligible``, ``greedy_find_bundles`` and the
candidate scan of ``build_layout`` (:156-290), over the row sample of
``Dataset._find_bundle_layout`` (lightgbm_tpu/dataset.py:1302-1336).  The
JAX package then packs each bundle into one bin plane; the port does not
yet, so ``Dataset.construct`` raises where a bundle of two or more columns
would form, and ``enable_bundle=False`` trains the columns unbundled.

Dense columns never bundle: a column with NaNs, a nonzero default bin
(negative values) or more than half its sampled rows nonzero is no
candidate, and is skipped before its nonzeros are gathered.
"""

from __future__ import annotations

from typing import Callable, List

import numpy as np

from .binning import MissingType

# plane bin budget (bins stay byte-sized)
MAX_PLANE_BINS = 256
# bundles past this count stop being probed; later features stay singletons
MAX_SEARCH_GROUPS = 512
# columns denser than this cannot usefully be exclusive with anything
MAX_BUNDLE_DENSITY = 0.5


def default_bin(mapper) -> int:
    """The bin of the value 0.0 (lightgbm_tpu/binning.py:366-368)."""
    if mapper.missing_type == MissingType.ZERO:
        return mapper.nan_bin
    return int(np.searchsorted(mapper.bin_upper_bound, 0.0, side="left"))


def _eligible(mapper, budget: int) -> bool:
    """Numeric, no missing values, value 0 in bin 0, and narrow enough to
    share a plane (the restrictions that keep a bundle's decode exact)."""
    return (
        mapper.missing_type == MissingType.NONE
        and mapper.nan_bin < 0
        and default_bin(mapper) == 0
        and 2 <= mapper.num_bins
        and mapper.num_bins - 1 <= budget - 1
    )


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


def find_bundles(
    used_features: List[int],
    bin_mappers,
    nonzeros_of: Callable[[int], np.ndarray],
    sample_n: int,
    max_conflict_rate: float = 0.0,
    budget: int = MAX_PLANE_BINS,
) -> List[List[int]]:
    """The bundles of two or more original feature ids that the JAX
    package's ``build_layout`` would form (empty: it returns None).
    ``nonzeros_of(j)``: sorted sample rows where column j is nonzero."""
    if len(used_features) < 2:
        return []
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
        return []
    groups = greedy_find_bundles(nz_lists, np.asarray(widths), sample_n,
                                 max_conflict_rate, budget)
    return [sorted(cand[i] for i in g) for g in groups if len(g) > 1]


def refuse_bundles(used_features, bin_mappers, sample: np.ndarray,
                   max_conflict_rate: float) -> None:
    """Raise NotImplementedError where a bundle would form over the binning
    sample ``sample`` [S, F] (the rows ``_find_bundle_layout`` draws)."""
    groups = find_bundles(used_features, bin_mappers,
                          lambda j: np.flatnonzero(sample[:, j]), sample.shape[0],
                          max_conflict_rate)
    if groups:
        shown = "; ".join(str(g) for g in groups[:3]) + ("; ..." if len(groups) > 3 else "")
        raise NotImplementedError(
            f"Exclusive Feature Bundling is not yet ported to lightgbm_tpu_torch "
            f"(ROADMAP.md, Queue 1, item 3): with enable_bundle=True (the default) "
            f"the JAX package bundles {sum(map(len, groups))} columns of this data "
            f"into {len(groups)} planes ({shown}); pass enable_bundle=False to "
            f"train them unbundled"
        )
