"""Training data: dense numpy input -> per-feature bin mappers + a u8 bin
matrix (u16 once a column has more than 256 bins, as
lightgbm_tpu/dataset.py:852 stores them).

Counterpart of the dense path of ``lightgbm_tpu/dataset.py``: bin mappers are
fit on a row sample drawn from ``np.random.default_rng(data_random_seed)``
(the same draw as the JAX package, so both packages bin identically),
features with a single bin are dropped from training, and the kept columns
form the ``[N, F]`` uint8 (or uint16) matrix the trainer consumes.  The matrix stays on
the host; the booster moves it to its device.  With ``enable_bundle`` (the
default) mutually exclusive sparse columns share bin planes (EFB,
``bundling.build_layout`` over the binning sample, as
lightgbm_tpu/dataset.py:834-845 and :1302-1336): the matrix is then ``[N,
P]``, one column a plane, packed by ``BundleLayout.pack_columns``, and
``num_bins`` / ``nan_bins`` are the planes' (a bundle plane has no NaN
bin).  Dense input only.

The metadata of ``lightgbm_tpu/dataset.py`` (:565-579): row ``weight`` and
``init_score`` (the raw score a row starts from), and ``reference``: a
validation set is binned with its reference's mappers and used features
and bundle layout (the row-major u8 bins the walkers read), so a tree of
the training set walks it in bin space.

Categorical columns (``categorical_feature=``, the argument or the param,
resolved as lightgbm_tpu/dataset.py:1123-1138 does): integer-coded
columns of the numpy input, binned a bin a category
(``BinMapper.from_sample(..., is_categorical=True)``); such a column never
joins an EFB bundle and keeps a plane of its own (``plane_is_cat``).
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional

import numpy as np

from .binning import BinMapper
from .bundling import BundleLayout, build_layout
from .config import Config

MIN_DATA_IN_BIN = 3
BIN_BLOCK_ROWS = 1 << 14  # rows binned a block (their columns made contiguous)


def _row_array(v, n: int, what: str, per_class: bool = False) -> Optional[np.ndarray]:
    """A per-row f64 array of length ``n`` (None stays None); with
    ``per_class``, k * n values (class by class, k trees an iteration) are
    taken too."""
    if v is None:
        return None
    a = np.asarray(v, dtype=np.float64).ravel()
    if len(a) != n and not (per_class and n and len(a) % n == 0):
        raise ValueError(f"{what} length {len(a)} != num rows {n}")
    if not np.all(np.isfinite(a)):
        raise ValueError(f"{what} contains NaN or inf")
    return a


def ceil_pow2(x: int) -> int:
    return max(1, 1 << (int(x) - 1).bit_length())


class Dataset:
    """Binned training set (lazily constructed, like the reference's)."""

    def __init__(
        self,
        data: np.ndarray,
        label: Optional[np.ndarray] = None,
        *,
        reference: Optional["Dataset"] = None,
        weight: Optional[np.ndarray] = None,
        init_score: Optional[np.ndarray] = None,
        params: Optional[Dict[str, Any]] = None,
        categorical_feature: Any = "auto",
    ) -> None:
        self.params: Dict[str, Any] = dict(params or {})
        self._categorical_feature = categorical_feature
        self._raw_data = data
        self._label = label
        self._weight = weight
        self._init_score = init_score
        self.reference = reference
        self.constructed = False
        self.bin_mappers: List[BinMapper] = []
        self.used_features: List[int] = []
        self.feature_names: List[str] = []
        self.num_total_features = 0
        self.bins: Optional[np.ndarray] = None  # [N, P] u8 or u16, row-major (P planes)
        self.bundle_layout: Optional[BundleLayout] = None  # None: a plane a used feature
        self.label: Optional[np.ndarray] = None  # [N] float64
        self.weight: Optional[np.ndarray] = None  # [N] float64 or None
        self.init_score: Optional[np.ndarray] = None  # [N] (or [k * N]) float64, or None
        self.bundle_check_s = 0.0  # seconds of the bundle search

    def construct(self) -> "Dataset":
        if self.constructed:
            return self
        cfg = Config.from_params(self.params)
        data = np.asarray(self._raw_data, dtype=np.float64)
        if data.ndim != 2:
            raise ValueError(f"data must be 2-D, got shape {data.shape}")
        if self._label is None:
            raise ValueError("label is required to construct a Dataset")
        label = np.asarray(self._label, dtype=np.float64).ravel()
        n, f = data.shape
        if len(label) != n:
            raise ValueError(f"label length {len(label)} != num rows {n}")
        if not np.all(np.isfinite(label)):
            raise ValueError("label contains NaN or inf")
        self.weight = _row_array(self._weight, n, "weight")
        self.init_score = _row_array(self._init_score, n, "init_score", per_class=True)
        self.feature_names = [f"Column_{i}" for i in range(f)]
        self.num_total_features = f
        if self.reference is not None:
            self._bin_like(self.reference.construct(), data)
        else:
            self._fit_bins(cfg, data, self._resolve_categorical(cfg, f))
        self.label = label
        self.constructed = True
        self._raw_data = None
        return self

    def _bin_like(self, ref: "Dataset", data: np.ndarray) -> None:
        """Bins of a validation set: the reference's mappers and used
        features."""
        if data.shape[1] != ref.num_total_features:
            raise ValueError(f"data has {data.shape[1]} columns, its reference "
                             f"{ref.num_total_features}")
        self.bin_mappers = ref.bin_mappers
        self.used_features = list(ref.used_features)
        self.bundle_layout = ref.bundle_layout
        self.bins = self._binned(data)

    def _bin_dtype(self):
        """u8, or u16 once a column (an EFB plane, or a used feature) has
        more than 256 bins (lightgbm_tpu/dataset.py:846-852); a validation
        set shares its reference's mappers and layout, so its width."""
        if self.bundle_layout is not None:
            widest = max(self.bundle_layout.plane_bins, default=1)
        else:
            widest = max((self.bin_mappers[j].num_bins for j in self.used_features), default=1)
        return np.uint8 if widest <= 256 else np.uint16

    def _binned(self, data: np.ndarray) -> np.ndarray:
        """[N, P] u8 (or u16) bins: each used feature's own bins, packed
        into the layout's planes when there is one."""
        dtype = self._bin_dtype()
        local = local_bins(self.bin_mappers, self.used_features, data, dtype)
        if self.bundle_layout is None:
            return local
        pos = {j: ci for ci, j in enumerate(self.used_features)}
        return self.bundle_layout.pack_columns(
            data.shape[0], lambda j: local[:, pos[j]], dtype=dtype)

    def _resolve_categorical(self, cfg: Config, num_features: int) -> List[int]:
        """The categorical columns (lightgbm_tpu/dataset.py:1123-1138): the
        Dataset's argument, else the ``categorical_feature`` param; indices,
        column names, ``name:``-prefixed or plain digit strings, or a
        comma-separated string of them; unknown names and indices out of
        range are dropped."""
        cf = self._categorical_feature
        if cf == "auto" or cf is None or cf == "":
            cfg_cf = cfg.categorical_feature
            cf = cfg_cf if cfg_cf not in ("", "auto", None) else []
        if isinstance(cf, str):
            cf = [c for c in cf.split(",") if c != ""]
        out: List[int] = []
        for c in cf:
            if isinstance(c, (int, np.integer)):
                out.append(int(c))
            elif str(c) in self.feature_names:
                out.append(self.feature_names.index(str(c)))
            else:
                out.append(int(str(c).replace("name:", "")) if str(c).isdigit() else -1)
        return [c for c in out if 0 <= c < num_features]

    def _fit_bins(self, cfg: Config, data: np.ndarray, cat_idx: List[int]) -> None:
        n, f = data.shape
        sample_cnt = min(n, cfg.bin_construct_sample_cnt)
        if sample_cnt < n:
            rng = np.random.default_rng(cfg.data_random_seed)
            sample = data[np.sort(rng.choice(n, size=sample_cnt, replace=False))]
        else:
            sample = data
        self.bin_mappers = []
        self.used_features = []
        for j in range(f):
            m = BinMapper.from_sample(
                sample[:, j], cfg.max_bin, min_data_in_bin=MIN_DATA_IN_BIN,
                is_categorical=j in cat_idx,
            )
            self.bin_mappers.append(m)
            if not m.is_trivial:
                self.used_features.append(j)
        if cfg.enable_bundle:
            t0 = time.perf_counter()
            self.bundle_layout = build_layout(
                self.used_features, self.bin_mappers,
                lambda j: np.flatnonzero(sample[:, j]), sample.shape[0],
                cfg.max_conflict_rate)
            self.bundle_check_s = time.perf_counter() - t0
        self.bins = self._binned(data)

    def get_label(self) -> np.ndarray:
        return self.construct().label

    def get_weight(self) -> Optional[np.ndarray]:
        return self.construct().weight

    def get_init_score(self) -> Optional[np.ndarray]:
        return self.construct().init_score

    @property
    def num_data(self) -> int:
        return int(self.construct().bins.shape[0])

    @property
    def num_planes(self) -> int:
        """Columns of ``bins``: EFB planes, or used features."""
        return int(self.construct().bins.shape[1])

    def num_bins(self) -> np.ndarray:
        """[P] int32 bins per column of ``bins`` (NaN bin included; a bundle
        plane's bins, the shared bin 0 included)."""
        self.construct()
        if self.bundle_layout is not None:
            return np.asarray(self.bundle_layout.plane_bins, np.int32)
        return np.array(
            [self.bin_mappers[j].num_bins for j in self.used_features], np.int32
        )

    def nan_bins(self) -> np.ndarray:
        """[P] int32 NaN-bin index per column of ``bins``, -1 if none (a
        bundle plane never has one)."""
        self.construct()
        cols = ([[j] for j in self.used_features] if self.bundle_layout is None
                else self.bundle_layout.planes)
        return np.array(
            [self.bin_mappers[c[0]].nan_bin if len(c) == 1 else -1 for c in cols], np.int32
        )

    def plane_is_cat(self) -> np.ndarray:
        """[P] bool: the column of ``bins`` is a categorical feature (a
        bundle plane never is; lightgbm_tpu/dataset.py:662-677)."""
        self.construct()
        cols = ([[j] for j in self.used_features] if self.bundle_layout is None
                else self.bundle_layout.planes)
        return np.array([len(c) == 1 and self.bin_mappers[c[0]].is_categorical for c in cols],
                        bool)

    @property
    def max_bin_padded(self) -> int:
        """Histogram bin axis: the next power of two over the widest feature."""
        nb = self.num_bins()
        return ceil_pow2(int(nb.max()) if len(nb) else 2)


def local_bins(mappers, used_features, data: np.ndarray, dtype=np.uint8) -> np.ndarray:
    """[N, F_used] ``dtype`` (u8 or u16): each used feature's own bins, in
    blocks of ``BIN_BLOCK_ROWS`` rows whose columns are first made
    contiguous (a column of a wide row-major table is a strided read)."""
    n = data.shape[0]
    out = np.zeros((n, len(used_features)), dtype)
    for r0 in range(0, n, BIN_BLOCK_ROWS):
        blk = np.ascontiguousarray(data[r0 : r0 + BIN_BLOCK_ROWS].T)
        for ci, j in enumerate(used_features):
            out[r0 : r0 + BIN_BLOCK_ROWS, ci] = mappers[j].values_to_bins(blk[j])
    return out
