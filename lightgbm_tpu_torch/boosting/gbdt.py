"""GBDT boosting loop and the user-facing Booster.

Counterpart of ``lightgbm_tpu/boosting/gbdt.py`` for one model per
iteration (binary or regression): the training layout (``hist_mode``, the
JAX package's rule at :1313-1369), the train loop (gradients, quantized
gradients or the int8 accumulator's scales once per iteration,
``grow_tree``, f32-rounded shrinkage, score update through the leaf of
each row), the effective frontier batch K of each tree with the adaptive
commit-rate clamp, and ``predict`` through the forest walk (or the plain
walker on the same device when the kernel rejects the model), with device
binning and an exact host re-bin of the rows whose f32 binning is in
doubt.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..config import Config
from ..dataset import Dataset
from ..device import resolve_device
from ..objectives import create_objective
from ..ops.forest_walk import (
    ForestTables,
    bin_numeric,
    build_devbin_tables,
    build_tables,
    forest_walk,
    walk_reject_reason,
)
from ..ops.grower import GrowerParams, grow_tree, int8_acc_eligible
from ..ops.histogram import row_major_bins
from ..predict import predict_bins_raw, stack_bin_trees
from ..quantize import hist_acc_scales, quantize_gradients
from ..tree import Tree

_EPS = 1e-15
PREDICT_CHUNK = 1 << 20  # rows binned and walked per launch
# the seg layout's feature budget at max_bin <= 256 (boosting/gbdt.py:1318)
SEG_MAX_FEATURES = 242


def resolve_hist_mode(n_used: int, max_bin_padded: int) -> str:
    """The JAX package's layout rule (boosting/gbdt.py:1313-1369): 'seg'
    when the bins fit a byte and 0 < used features <= 242, else 'ordered',
    with the JAX package's warning.  (At max_bin <= 256 the seg kernels'
    scratch does not depend on F, so the cap is the whole rule.)"""
    if max_bin_padded <= 256 and 0 < n_used <= SEG_MAX_FEATURES:
        return "seg"
    if n_used > 0:
        warnings.warn(
            "segment-resident training is unavailable: "
            f"{n_used} used features > {SEG_MAX_FEATURES} (packed row exceeds 128 "
            "i16 lanes); falling back to hist_mode='ordered' (1.4-10x slower "
            "at scale). Consider feature selection.",
            stacklevel=3,
        )
    return "ordered"


class Booster:
    """Trains on ``device`` (the CUDA card unless ``device='cpu'``) and
    predicts through the forest walk."""

    def __init__(
        self,
        params: Optional[Dict[str, Any]] = None,
        train_set: Optional[Dataset] = None,
        device=None,
    ) -> None:
        self.params: Dict[str, Any] = dict(params or {})
        self.config = Config.from_params(self.params)
        self.device = resolve_device(device)
        self.num_class = 1
        self.trees: List[Tree] = []
        self.train_set: Optional[Dataset] = None
        self.objective = None
        self._finished = False
        self._tables = None
        self._warned_walk_fallback = False
        self.hist_mode: Optional[str] = None  # the resolved training layout
        # per trained tree: near-tie f32 refines of the int8 accumulation,
        # grow-loop steps, the frontier batch K it grew with, and its commit
        # rate (splits / (steps * K))
        self.refine_counts: List[int] = []
        self.grow_steps: List[int] = []
        self.leaf_batch_effective: List[int] = []
        self.commit_rates: List[float] = []
        # the adaptive clamp (boosting/gbdt.py:291-335): EMA of the commit
        # rate at the current K, and the cap on K once it has halved
        self.commit_rate_ema: Optional[float] = None
        self.leaf_batch_cap: Optional[int] = None
        # (num_leaves, grow_steps) of the last tree, noted one tree late
        self._unnoted: Optional[tuple] = None
        # constant added to every raw score (predict-only boosters, see
        # convert.booster_from_arrays); training folds its init score into
        # the first tree instead
        self.init_score = 0.0
        if train_set is not None:
            self._init_train(train_set)

    # ------------------------------------------------------------- training
    def _init_train(self, train_set: Dataset) -> None:
        ds = train_set.construct()
        cfg = self.config
        dev = self.device
        self.train_set = ds
        self.bin_mappers = ds.bin_mappers
        self.used_features = list(ds.used_features)
        n = ds.num_data
        self.objective = create_objective(cfg.objective, ds.label, dev)
        self.score = torch.zeros(n, dtype=torch.float32, device=dev)
        self.hist_mode = cfg.hist_mode or resolve_hist_mode(
            len(self.used_features), ds.max_bin_padded
        )
        cfg.check_layout(self.hist_mode)
        self._bins_fn = torch.as_tensor(np.ascontiguousarray(ds.bins.T), device=dev)
        # the ordered layout reads whole rows: a row-major copy beside the
        # feature-major one that its partition reads a column of
        self._bins_nf = (
            row_major_bins(ds.bins, dev) if self.hist_mode == "ordered" else None
        )
        self.nan_bins = ds.nan_bins()
        self._num_bins_t = torch.as_tensor(ds.num_bins(), device=dev)
        self._nan_bins_t = torch.as_tensor(self.nan_bins, device=dev)
        self._feature_mask = torch.ones(
            len(self.used_features), dtype=torch.bool, device=dev
        )
        self._count_mask = torch.ones(n, dtype=torch.float32, device=dev)
        # the JAX grower takes its split-scan kernel's tie rule only where
        # the kernel runs (fused_ok, ops/grower.py:460-478): the scan or the
        # fused step on ('on' fuses on either layout, 'auto' on seg), at
        # most 64 features and 256 bins; best_split's rule elsewhere
        kernel_scan = cfg.fused_split_scan or cfg.grow_fused == "on" or (
            cfg.grow_fused == "auto" and self.hist_mode == "seg")
        kernel_ties = (kernel_scan and len(self.used_features) <= 64
                       and ds.max_bin_padded <= 256)
        self._grower_params = GrowerParams(
            num_leaves=cfg.num_leaves,
            max_bin=ds.max_bin_padded,
            min_data_in_leaf=cfg.min_data_in_leaf,
            min_sum_hessian_in_leaf=cfg.min_sum_hessian_in_leaf,
            lambda_l1=cfg.lambda_l1,
            lambda_l2=cfg.lambda_l2,
            min_gain_to_split=cfg.min_gain_to_split,
            grow_fused=cfg.resolved_grow_fused() and self.hist_mode == "seg",
            near_tie_tol=cfg.hist_near_tie_tol,
            leaf_batch=self._leaf_k(),
            hist_mode=self.hist_mode,
            case_major_ties=not kernel_ties,
        )
        self._int8_acc = int8_acc_eligible(cfg.hist_acc, self.hist_mode, dev)

    def _leaf_k(self) -> int:
        """The frontier batch of the next tree (boosting/gbdt.py:1372-1410):
        ``leaf_batch`` within the remaining-leaf budget (num_leaves - 1)
        and the commit-rate cap."""
        cfg = self.config
        k = min(max(1, cfg.leaf_batch), max(1, cfg.num_leaves - 1))
        if self.leaf_batch_cap is not None:
            k = min(k, self.leaf_batch_cap)
        return k

    def _note_commit_rate(self, num_leaves: int, steps: int, k: int) -> None:
        """The adaptive clamp (boosting/gbdt.py:291-335): rate =
        (num_leaves - 1) / (steps * K); EMA 0.7 * ema + 0.3 * rate; below
        ``leaf_batch_min_commit_rate`` K halves for the rest of the run (it
        never rises again) and the EMA restarts.

        ``update`` keeps the JAX Booster's schedule, which notes a tree one
        iteration late (its pipelined update materializes tree i after
        tree i+1 is dispatched, gbdt.py:392-476, :243): tree i is noted
        after tree i+1 has grown, with ``k`` the K then in force, and the
        first tree, grown before that pipeline starts, is not noted.  So a
        halving reaches the second tree after the one that caused it, and
        both packages grow every tree with the same K."""
        if k <= 1 or steps <= 0:
            return
        rate = (num_leaves - 1) / float(steps * k)
        ema = self.commit_rate_ema
        ema = rate if ema is None else 0.7 * ema + 0.3 * rate
        self.commit_rate_ema = ema
        cfg = self.config
        if cfg.leaf_batch_adaptive and ema < cfg.leaf_batch_min_commit_rate:
            self.leaf_batch_cap = max(1, k // 2)
            self.commit_rate_ema = None
            self._grower_params = dataclasses.replace(
                self._grower_params, leaf_batch=self._leaf_k()
            )

    def update(self) -> bool:
        """One boosting iteration (reference GBDT::TrainOneIter
        gbdt.cpp:352).  Returns True when no split had a positive gain."""
        if self.train_set is None:
            raise ValueError("Booster has no training data")
        if self._finished:
            return True
        cfg = self.config
        init_score = 0.0
        if not self.trees and cfg.boost_from_average:
            s = self.objective.boost_from_score()
            if abs(s) > _EPS:
                init_score = s
                self.score += s
        grad, hess = self.objective.get_gradients(self.score)
        n_leaves, refines, steps = 1, 0, 0
        k = self._grower_params.leaf_batch
        if self.objective.need_train and self.used_features:
            grad, hess, qs = self._grow_inputs(grad, hess)
            ta, leaf_id = grow_tree(
                self._bins_fn, grad, hess, self._count_mask, self._num_bins_t,
                self._nan_bins_t, self._feature_mask, self._grower_params,
                quant_scales=qs, bins_nf=self._bins_nf,
            )
            n_leaves, refines, steps = ta.num_leaves, ta.refine_count, ta.grow_steps
        if self._unnoted is not None:
            self._note_commit_rate(*self._unnoted, k)
        self._unnoted = (n_leaves, steps) if self.trees and n_leaves > 1 else None
        if n_leaves <= 1:
            # constant tree (gbdt.cpp:428-441): only a first tree is kept;
            # without boost_from_average its value is the objective's
            # init score, added to the scores (boosting/gbdt.py:2256-2267)
            if not self.trees:
                if not cfg.boost_from_average:
                    init_score = self.objective.boost_from_score()
                    self.score += init_score
                tree = Tree.from_record(_constant_record(init_score))
                self.trees.append(tree)
                self._note_tree(refines, steps, k, n_leaves)
                self._tables = None
            self._finished = True
            return True
        tree = Tree.from_tree_arrays(ta, self.bin_mappers, self.used_features)
        self._note_tree(refines, steps, k, n_leaves)
        tree.apply_shrinkage(cfg.learning_rate)
        rate = torch.tensor(np.float32(cfg.learning_rate), device=self.device)
        shrunk = torch.as_tensor(ta.leaf_value, device=self.device) * rate
        self.score += shrunk[leaf_id.long()]
        if init_score:
            tree.add_bias(init_score)
        self.trees.append(tree)
        self._tables = None
        return False

    def _grow_inputs(self, grad, hess):
        """(grad, hess, quant_scales) the tree grows on.  Quantized training
        (``_quant_grow_inputs``, boosting/gbdt.py:1020-1040): the quantized
        gradients, and their scales for the int8 histogram when
        ``hist_method='pallas_int8'``; else the true gradients, and the int8
        accumulator's scales where the gate admits it."""
        cfg = self.config
        if cfg.use_quantized_grad:
            grad, hess, g_scale, h_scale = quantize_gradients(
                grad, hess, cfg.num_grad_quant_bins,
                constant_hessian=self.objective.is_constant_hessian,
            )
            if cfg.hist_method != "pallas_int8":
                return grad, hess, None
            return grad, hess, torch.stack([g_scale, h_scale])
        if self._int8_acc:
            return grad, hess, hist_acc_scales(grad, hess, self._count_mask)
        return grad, hess, None

    def _note_tree(self, refines: int, steps: int, k: int, n_leaves: int) -> None:
        self.refine_counts.append(refines)
        self.grow_steps.append(steps)
        self.leaf_batch_effective.append(k)
        self.commit_rates.append((n_leaves - 1) / float(steps * k) if steps else 0.0)

    def refine_rate(self, i: int = -1) -> float:
        """Share of tree ``i``'s split decisions that took the near-tie f32
        refine: refines / (2 * (leaves - 1) + 1), the root and both children
        of every split (boosting/gbdt.py:336-349)."""
        decisions = 2 * max(0, self.trees[i].num_leaves - 1) + 1
        return self.refine_counts[i] / decisions

    def train_loss(self) -> float:
        """Training loss of the current score (binary log-loss or l2)."""
        return self.objective.train_loss(self.score)

    # ------------------------------------------------------------ prediction
    def _walk_tables(self):
        """Walk tables of the model: the forest-walk kernel's, or, when the
        kernel rejects the model (``walk_reject_reason``), the stacked trees
        of the plain walker (the JAX package's XLA fallback,
        boosting/gbdt.py:2646-2694)."""
        if self._tables is None:
            records = [t.record() for t in self.trees]
            nb = [self.bin_mappers[j].num_bins for j in self.used_features]
            max_bin = 1 << max(0, (max(nb, default=2) - 1).bit_length())
            reason = walk_reject_reason(records, self.nan_bins, len(self.used_features), max_bin)
            if reason is None:
                self._tables = build_tables(records, self.nan_bins, self.device)
            else:
                if not self._warned_walk_fallback:
                    self._warned_walk_fallback = True
                    warnings.warn(
                        "prediction fast path (forest-walk kernel) unavailable: "
                        + reason + "; using the slower plain walker", stacklevel=3,
                    )
                self._tables = stack_bin_trees(records, self.nan_bins, self.device)
        return self._tables

    def _bin_host(self, x: np.ndarray) -> np.ndarray:
        """Exact f64 host binning of rows x [n, F_total] -> [n, F_used]."""
        cols = [self.bin_mappers[j].values_to_bins(x[:, j]) for j in self.used_features]
        return np.stack(cols, axis=1) if cols else np.zeros((len(x), 0), np.int32)

    def predict_raw_bins(self, bins: torch.Tensor) -> torch.Tensor:
        """Raw scores [N] of already-binned rows [N, F_used] u8 on the
        booster's device."""
        tables = self._walk_tables()
        if isinstance(tables, ForestTables):
            raw = forest_walk(bins, tables, self.num_class)[:, 0]
        else:
            raw = predict_bins_raw(tables, bins, self.num_class)[:, 0]
        return raw + self.init_score if self.init_score else raw

    def predict(self, data: np.ndarray, raw_score: bool = False) -> np.ndarray:
        """Scores of rows ``data`` [N, F] (probabilities for binary unless
        ``raw_score``).  Rows are binned on the device in f32; rows within
        f32 rounding of a bin boundary are re-binned on the host in f64,
        so the bins equal the training Dataset's."""
        x = np.asarray(data, dtype=np.float64)
        if x.ndim != 2:
            raise ValueError(f"data must be 2-D, got shape {x.shape}")
        n = x.shape[0]
        if not self.trees:
            return np.zeros(n)
        dbt = build_devbin_tables(self.bin_mappers, self.used_features, self.device)
        parts = []
        for lo in range(0, n, PREDICT_CHUNK):
            xo = x[lo : lo + PREDICT_CHUNK]
            xs = torch.as_tensor(
                np.ascontiguousarray(xo[:, self.used_features], dtype=np.float32),
                device=self.device,
            )
            bins, suspect = bin_numeric(xs, *dbt)
            sidx = torch.nonzero(suspect)[:, 0].cpu().numpy()
            if len(sidx):
                patch = self._bin_host(xo[sidx])
                bins[torch.as_tensor(sidx, device=self.device)] = torch.as_tensor(
                    patch.astype(np.int32), device=self.device
                )
            parts.append(self.predict_raw_bins(bins.to(torch.uint8)))
        raw = torch.cat(parts) if parts else torch.zeros(0, device=self.device)
        return self._finish_predict(raw, raw_score)

    def _finish_predict(self, raw: torch.Tensor, raw_score: bool) -> np.ndarray:
        """Raw scores -> output space (gbdt.py:2826)."""
        if not raw_score and self.objective is not None:
            raw = self.objective.convert_output(raw)
        return raw.double().cpu().numpy()


def _constant_record(val: float) -> dict:
    return {
        "split_feature": np.zeros(0, np.int32),
        "split_bin": np.zeros(0, np.int32),
        "default_left": np.zeros(0, bool),
        "left_child": np.zeros(0, np.int32),
        "right_child": np.zeros(0, np.int32),
        "leaf_value": np.array([val], np.float32),
    }

