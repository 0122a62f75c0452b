"""GBDT boosting loop and the user-facing Booster.

Counterpart of ``lightgbm_tpu/boosting/gbdt.py`` for the pointwise
objectives (``objectives.py``): the training layout (``hist_mode``, the
JAX package's rule at :1313-1369), the train loop (:2040-2297: the
gradients of every class once per iteration, one row sample, then a tree a
class: quantized gradients or the int8 accumulator's scales,
``grow_tree``, the leaves renewed on the host from the residuals of their
in-bag rows for L1, quantile and MAPE, f32-rounded shrinkage, the class's
score updated through the leaf of each row; a class that needs no training
gets a constant tree), the effective frontier batch K of each tree with
the adaptive commit-rate clamp, and ``predict`` through the forest walk
(or the plain walker on the same device when the kernel rejects the
model), with device binning and an exact host re-bin of the rows whose f32
binning is in doubt.

Multiclass (softmax, one-vs-all): k = ``num_class`` trees an iteration,
tree t of class t % k; the training and validation scores are [k, N]
(``Booster.score`` is [N] at k = 1, else [k, N]), ``init_score`` N or k * N
values (class by class), each class's first tree folds in its own
``boost_from_score``; predictions are [N, k] (raw, or the objective's
``convert_output``: softmax over the classes), ``pred_leaf`` [N, T],
``pred_contrib`` [N, k (F + 1)], and the model text carries
``num_class`` / ``num_tree_per_iteration`` both ways.

Evaluation (:1569, :2458-2515): validation sets added with ``add_valid``
keep a score on the device that each new tree is added to by the
forest-walk kernel on their row-major bins (a one-tree table; the plain
walker past ``walk_reject_reason``'s limits), the replacement of the JAX
package's XLA walk ``_apply_tree_valid_score`` (:78-110); their metrics
and the training set's (``metrics.py``) read the scores where they lie.
Row weights and ``init_score`` come from the Dataset (an init score starts
the score and turns ``boost_from_average`` off, :712-717, :2071-2082).

Sampling and keys (:807, :1632-1660, :1842, :2364-2385): one key stream
(``random.py``, equal to ``jax.random``'s) from ``seed``, drawn in the JAX
Booster's order each iteration: the gradients' key (the port's objectives
take none), the row sampler's (``boosting/sampling.py``: bagging, GOSS),
then, a class at a time, the quantization's and the tree's
(``feature_fraction_bynode``), in that order once a tree exists (the JAX
pipelined update, :405-412) and the other way round in the first
iteration and for an objective that renews its leaves, which the JAX
Booster never pipelines (:2046-2054, :2125, :1032); the by-tree
``feature_fraction`` mask from numpy's ``default_rng(feature_fraction_seed
+ iteration)``.

EFB (:761-786, :896-936, :2728-2735, :2872-2875): on a bundled Dataset the
columns are planes; the layout rule counts them, every leaf is decided by
``best_split`` with the planes' ``bundle_end``, trees keep the goes-left
tables of their bundle-plane nodes and decode them to thresholds on the
member features, predict packs the rows' bins into the planes, and the
model predicts and scores its validation sets through the plain walker
with tables (the forest-walk kernel stays the route of every unbundled
model).

Categorical features (:775-779, :1457-1466, :3118-3129): a Dataset with
categorical columns grows every tree with the categorical split search
(``grow_tree``'s ``is_cat``, every leaf by ``best_split``), trees keep
their category masks (``Tree.cat_mask``) and bitsets (model text's
``num_cat``, ``cat_boundaries``, ``cat_threshold``), and predict bins the
categorical columns on the host: a value outside the kept categories, or
NaN without a NaN bin, takes a sentinel bin that no categorical node
sends left, so it goes right.  The walk kernel takes categorical nodes
(``walk_reject_reason``: masks of at most 256 bins, none claiming bin 255)
on u8 bins, where the sentinel is 255; a model it rejects takes the plain
walker on i32 bins, where the sentinel is 65535, past every table (so a
category kept at bin 255 at ``max_bin`` 256 stays a category).

Prediction (:2583-3040): ``predict`` routes as the JAX Booster does, but
for a model read from text: the walk path (``_walk_raw``) for a trained
booster's scores, in chunks of PREDICT_CHUNK rows copied on a side stream
one chunk ahead; the streaming engine (``predict.py``
``StreamingPredictor``) for ``pred_leaf`` and prediction early stopping
(the binary margin rule, ``_apply_pred_early_stop``); the scores of a
model read from text by the real-space walker in chunks of
REAL_WALK_CELLS rows x trees (``_real_raw``: the JAX package streams them
through its engine, whose 4,096-row chunks cost the port a hundred-odd
operator launches each); ``pred_contrib`` by TreeSHAP on the host
(``shap.py``).  ``last_predict_stats`` holds the last call's phases,
``compile_predict`` builds what a predict needs before the first one.

Model text (:3186-3421): ``model_to_string`` / ``save_model`` write
LightGBM's format; ``Booster(model_file=...)`` / ``Booster(model_str=...)``
/ ``model_from_string`` read it.  A model read from text has no bin
mappers: it predicts through the real-space walker (``predict.py``) on the
booster's device.  Its ``parameters:`` block is kept as text and written
back as it was.
"""

from __future__ import annotations

import dataclasses
import os
import time
import warnings
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from .. import _build
from ..binning import categorical_bins
from ..config import _OBJECTIVE_ALIASES, Config, check_pred_engine
from ..dataset import Dataset
from ..device import resolve_device
from ..metrics import create_metric, create_metrics
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
from ..ops.seg import byte_planes
from ..predict import (StreamingPredictor, predict_bins_raw, predict_real_leaves, shard_count,
                       stack_bin_trees)
from ..quantize import hist_acc_scales, quantize_gradients
from ..random import fold_in, prng_key, split
from ..shap import predict_contrib
from ..tree import Tree
from .sampling import create_sample_strategy

_EPS = 1e-15
_MODEL_VERSION = "v4"
PREDICT_CHUNK = 1 << 20  # rows binned and walked per launch on the walk path
REAL_WALK_CELLS = 1 << 24  # rows x trees of one real-space walk
# predict's keywords beside the named arguments (each also a parameter)
_PREDICT_KEYS = frozenset({"pred_early_stop", "pred_early_stop_freq", "pred_early_stop_margin",
                           "pred_chunk_rows", "pred_num_buffers", "pred_shard_devices",
                           "pred_engine"})
# the seg layout's feature budget (boosting/gbdt.py:1317): two byte bins a
# TPU i16 plane up to 256 padded bins, one u16 plane a feature past them
SEG_MAX_FEATURES = 242
SEG_MAX_FEATURES_WIDE = 121
# the widest padded bin axis seg_vmem_ok admits (lightgbm_tpu/ops/pallas/
# seg.py:139; its histogram scratch does not depend on F), and the most any
# layout takes (boosting/gbdt.py:1322)
SEG_MAX_BIN_PADDED = 8192
MAX_BIN_PADDED = 65536


def resolve_hist_mode(n_used: int, max_bin_padded: int) -> str:
    """The JAX package's layout rule (boosting/gbdt.py:1309-1369): 'seg'
    at 0 < used columns <= 242 when the bins fit a byte, <= 121 at a padded
    width of 512 to 8192, else 'ordered', with the JAX package's warning
    for each reason."""
    fcap = SEG_MAX_FEATURES if max_bin_padded <= 256 else SEG_MAX_FEATURES_WIDE
    fits = max_bin_padded <= SEG_MAX_BIN_PADDED
    if max_bin_padded <= MAX_BIN_PADDED and fits and 0 < n_used <= fcap:
        return "seg"
    if n_used > 0:
        if max_bin_padded > MAX_BIN_PADDED:
            why = f"max_bin padded to {max_bin_padded} > {MAX_BIN_PADDED}"
        elif not fits:
            why = (f"histogram VMEM scratch at {n_used} features x max_bin "
                   f"{max_bin_padded} exceeds the budget")
        else:
            why = f"{n_used} used features > {fcap} (packed row exceeds 128 i16 lanes)"
        warnings.warn(
            "segment-resident training is unavailable: " + why + "; falling back to "
            "hist_mode='ordered' (1.4-10x slower at scale). Consider feature selection"
            + (" or a smaller max_bin" if fcap == SEG_MAX_FEATURES_WIDE or not fits else "")
            + ".",
            stacklevel=3,
        )
    return "ordered"


class _EvalEntry:
    """A validation set: its row-major bins (planes under EFB) and f32
    scores on the device, and its metrics."""

    def __init__(self, name: str, dataset: Dataset, metrics, bins, scores):
        self.name = name
        self.dataset = dataset
        self.metrics = metrics
        self.bins = bins  # [N, P] u8 (i32 past 256 bins)
        self.scores = scores  # [k, N] f32

    @property
    def score(self) -> torch.Tensor:
        """[N] f32 of a one-model-an-iteration booster, else [k, N]."""
        return self.scores[0] if self.scores.shape[0] == 1 else self.scores


class Booster:
    """Trains on ``device`` (the CUDA card unless ``device='cpu'``) and
    predicts through the forest walk; or reads a model from text
    (``model_file`` / ``model_str``) and predicts it in real space."""

    def __init__(
        self,
        params: Optional[Dict[str, Any]] = None,
        train_set: Optional[Dataset] = None,
        model_file: Optional[str] = None,
        model_str: Optional[str] = None,
        device=None,
    ) -> None:
        self.params: Dict[str, Any] = dict(params or {})
        self.config = Config.from_params(self.params)
        self.device = resolve_device(device)
        self.num_class = 1  # trees an iteration (num_tree_per_iteration)
        self.trees: List[Tree] = []
        self.train_set: Optional[Dataset] = None
        self.objective = None
        self.bin_mappers = None  # None: a model read from text, walked in real space
        self.bundle_layout = None  # EFB planes of the training Dataset (None: unbundled)
        self.best_iteration = -1
        self.best_score: Dict[str, Dict[str, float]] = {}
        self.feature_names: List[str] = []
        self.feature_infos: List[str] = []
        self.max_feature_idx = -1
        self._iter = 0
        self._valid: List[_EvalEntry] = []
        self._train_metrics: list = []
        self._has_init_score = False
        # model text: the objective's string, the header's version, and the
        # text from the parameters block on (kept as read, or made from
        # params at the first model_to_string of a trained booster)
        self._objective_str = self.config.objective
        self._version = _MODEL_VERSION
        self._params_tail: Optional[str] = None
        self._finished = False
        # walk tables by tree range: (t0, t1) the walk path's, ("stream",
        # space, t0, t1) the streaming engine's
        self._tables: Dict[tuple, Any] = {}
        # predict: the streaming engine, its staging buffers (by bucket,
        # width, dtype, kind and trees; ``predict.staging`` keeps the small
        # ones), the device binning tables, and the phases of the last call
        self._stream: Optional[StreamingPredictor] = None
        self._staging: Dict[tuple, list] = {}
        self._devbin = None
        self.last_predict_stats: Dict[str, Any] = {}
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
        # (num_leaves, grow_steps) of the last iteration's trees with a
        # split, noted one iteration late
        self._unnoted: List[tuple] = []
        # host milliseconds of each leaf renewal (L1, quantile, MAPE)
        self.renew_ms: List[float] = []
        # (iteration, in-bag share of the rows) at each fresh sampled mask
        self.bag_shares: List[tuple] = []
        # constant added to every raw score (predict-only boosters, see
        # convert.booster_from_arrays); training folds its init score into
        # the first tree instead
        self.init_score = 0.0
        if model_file is not None:
            with open(model_file) as f:
                model_str = f.read()
        if model_str is not None:
            self._load_model_string(model_str)
            if self.config.pred_aot_compile:
                self.compile_predict()
        elif train_set is not None:
            self._init_train(train_set)

    # ------------------------------------------------------------- training
    def _init_train(self, train_set: Dataset) -> None:
        ds = train_set.construct()
        cfg = self.config
        dev = self.device
        self.train_set = ds
        self.bin_mappers = ds.bin_mappers
        self.used_features = list(ds.used_features)
        self.bundle_layout = ds.bundle_layout
        n = ds.num_data
        self.objective = create_objective(cfg, ds.label, dev, ds.weight)
        self.num_class = cfg.num_tree_per_iteration()
        self._class_need_train = [self.objective.class_need_train(c)
                                  for c in range(self.num_class)]
        self._objective_str = self.objective.to_string()
        self._has_init_score = ds.init_score is not None
        self.scores = self._start_score(ds)
        self._train_metrics = create_metrics(cfg, ds.label, ds.weight, dev)
        self.feature_names = list(ds.feature_names)
        self.feature_infos = [m.feature_info_str() for m in ds.bin_mappers]
        self.max_feature_idx = ds.num_total_features - 1
        # the budget counts bin columns: EFB planes (boosting/gbdt.py:1295-1297)
        self.hist_mode = cfg.hist_mode or resolve_hist_mode(ds.num_planes, ds.max_bin_padded)
        # feature-major bins, transposed on the device (a host transpose of
        # 1,048,576 x 700 bytes takes ~10 s); past 256 bins each column as
        # two byte planes (lo, hi: the seg rows' u16 mode, ops/seg.py, and
        # the ordered partition's column reads), the u16 bins read through
        # an i16 view (PyTorch's uint16 takes few operators)
        bins = np.ascontiguousarray(ds.bins)
        if bins.dtype == np.uint8:
            self._bins_fn = torch.as_tensor(bins).to(dev).T.contiguous()
        else:
            wide = torch.as_tensor(bins.view(np.int16)).to(dev).to(torch.int32) & 0xFFFF
            self._bins_fn = byte_planes(wide.T)
        # the ordered layout reads whole rows: a row-major copy (u16 past 256
        # bins, the histogram's u16 mode) beside the feature-major one that
        # its partition reads a column of
        self._bins_nf = (
            row_major_bins(ds.bins, dev) if self.hist_mode == "ordered" else None
        )
        self.nan_bins = ds.nan_bins()
        self._max_bin = ds.max_bin_padded
        self._num_bins_t = torch.as_tensor(ds.num_bins(), device=dev)
        self._nan_bins_t = torch.as_tensor(self.nan_bins, device=dev)
        self._feature_mask = torch.ones(ds.num_planes, dtype=torch.bool, device=dev)
        self._bundle_end = None if self.bundle_layout is None else torch.as_tensor(
            self.bundle_layout.bundle_end_array(self._max_bin), device=dev)
        # categorical columns (boosting/gbdt.py:775-779): None when there is none
        is_cat = ds.plane_is_cat()
        self._is_cat = torch.as_tensor(is_cat, device=dev) if is_cat.any() else None
        # the key stream (boosting/gbdt.py:807) and the row sampler
        self._rng = prng_key(cfg.seed if cfg.seed is not None else 0)
        self._sampler = create_sample_strategy(cfg, n, dev, ds.label)
        # the JAX grower takes its split-scan kernel's tie rule only where
        # the kernel runs (fused_ok, ops/grower.py:460-478): the scan or the
        # fused step on ('on' fuses on either layout, 'auto' on seg), at
        # most 64 columns and 256 bins, no bundle, no categorical feature;
        # best_split's rule elsewhere
        kernel_scan = cfg.fused_split_scan or cfg.grow_fused == "on" or (
            cfg.grow_fused == "auto" and self.hist_mode == "seg")
        kernel_ties = (kernel_scan and ds.num_planes <= 64 and ds.max_bin_padded <= 256
                       and self.bundle_layout is None and self._is_cat is None)
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
            feature_fraction_bynode=cfg.feature_fraction_bynode,
            quantized=cfg.use_quantized_grad and cfg.hist_method == "pallas_int8",
            cat_params=cfg.cat_params() if self._is_cat is not None else None,
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

    @property
    def score(self) -> torch.Tensor:
        """The training rows' raw scores on the device: [N] f32 for one
        model an iteration, [k, N] for the multiclass objectives."""
        return self.scores[0] if self.num_class == 1 else self.scores

    def update(self) -> bool:
        """One boosting iteration (reference GBDT::TrainOneIter
        gbdt.cpp:352; boosting/gbdt.py:2040-2135): the gradients of every
        class, one row sample, then a tree a class (a class that needs no
        training gets the JAX Booster's constant tree).  Returns True when
        no class's tree had a positive-gain split."""
        if self.train_set is None:
            raise ValueError("Booster has no training data")
        if self._finished:
            return True
        cfg = self.config
        k = self.num_class
        first = not self.trees
        init_scores = [0.0] * k
        if first and cfg.boost_from_average and not self._has_init_score:
            for c in range(k):
                s = self.objective.boost_from_score(c)
                if abs(s) > _EPS:
                    init_scores[c] = s
                    self._add_to_scores(s, c)
        grad, hess = self.objective.get_gradients(self.scores)  # [k, N]
        self._next_rng()  # the gradients' key (the JAX objectives take one)
        mask, grad, hess = self._sampler.sample(self._iter, grad, hess, self._bagging_rng())
        if self._sampler.refreshed:
            self.bag_shares.append((self._iter, float(mask.mean())))
        feature_mask = self._feature_mask_for_iter()
        # the JAX Booster's first iteration, and every iteration of an
        # objective that renews its leaves, draws a tree's key before its
        # quantization's; its pipelined update after it (boosting/gbdt.py:
        # 2046-2054, 2123-2125 with :1032; :405-412), and notes the commit
        # rates of an iteration's trees once the next one's have grown
        serial = first or self.objective.is_renew_tree_output
        grown = []
        for c in range(k):
            grown.append(None)
            if not (self._class_need_train[c] and self.used_features):
                continue
            if serial:
                tree_rng = self._tree_rng()
                g, h, qs = self._grow_inputs(grad[c], hess[c], mask)
            else:
                g, h, qs = self._grow_inputs(grad[c], hess[c], mask)
                tree_rng = self._tree_rng()
            k_used = self._grower_params.leaf_batch
            ta, leaf_id = grow_tree(
                self._bins_fn, g, h, mask, self._num_bins_t,
                self._nan_bins_t, feature_mask, self._grower_params,
                quant_scales=qs, bins_nf=self._bins_nf, bundle_end=self._bundle_end,
                rng=tree_rng, is_cat=self._is_cat,
            )
            grown[-1] = (ta, leaf_id, k_used)
        for n_leaves, steps in self._unnoted:
            self._note_commit_rate(n_leaves, steps, self._grower_params.leaf_batch)
        self._unnoted = [] if serial else [
            (g[0].num_leaves, g[0].grow_steps) for g in grown
            if g is not None and g[0].num_leaves > 1]
        split = any(g is not None and g[0].num_leaves > 1 for g in grown)
        # with no split in any class (gbdt.cpp:428-441; boosting/gbdt.py:
        # 2253-2297) only a first iteration's trees are kept, all constant
        if split or first:
            for c in range(k):
                self._commit_class_tree(c, grown[c], mask, init_scores[c], first)
            self._drop_predict_caches()
        if not split:
            self._finished = True
            return True
        self._iter += 1
        return False

    def _commit_class_tree(self, c: int, grown, mask, init_score: float, first: bool) -> None:
        """Class c's tree into the model (boosting/gbdt.py:2151-2297): its
        leaves renewed from the residuals of their in-bag rows where the
        objective renews them, shrunk, added to the training and validation
        scores of class c through each row's leaf, the init score folded
        in; a class without a split (or without training) gets a constant
        tree, whose value is the init score in a first iteration."""
        cfg = self.config
        if grown is None:
            self._note_tree(0, 0, self._grower_params.leaf_batch, 1)
        else:
            self._note_tree(grown[0].refine_count, grown[0].grow_steps, grown[2],
                            grown[0].num_leaves)
        if grown is None or grown[0].num_leaves <= 1:
            # without boost_from_average a first constant tree holds the
            # objective's init score, added to the scores
            if first and not cfg.boost_from_average and not self._has_init_score:
                init_score = self.objective.boost_from_score(c)
                self._add_to_scores(init_score, c)
            self.trees.append(Tree.constant(init_score if first else 0.0))
            return
        ta, leaf_id, _ = grown
        if self.objective.is_renew_tree_output:
            t = time.perf_counter()
            n = self.train_set.num_data
            lv = self.objective.renew_tree_output(
                self.scores[c].double().cpu().numpy(), leaf_id.cpu().numpy()[:n],
                np.asarray(ta.leaf_value, np.float64)[: ta.num_leaves],
                mask.cpu().numpy()[:n])
            # the tree keeps the f64 values, the scores their f32 rounding
            ta = ta._replace(leaf_value=np.asarray(lv, np.float64))
            self.renew_ms.append((time.perf_counter() - t) * 1e3)
        tree = Tree.from_tree_arrays(ta, self.bin_mappers, self.used_features,
                                     self.bundle_layout, self._max_bin)
        tree.apply_shrinkage(cfg.learning_rate)
        rate = np.float32(cfg.learning_rate)
        shrunk = np.asarray(ta.leaf_value, np.float32)[: ta.num_leaves] * rate
        self.scores[c] += torch.as_tensor(shrunk, device=self.device)[leaf_id.long()]
        if self._valid:
            # the new tree without the bias, which _add_to_scores added
            rec = {**tree.record(), "leaf_value": shrunk}
            for entry in self._valid:
                entry.scores[c] += self._walk_one(rec, entry.bins)
        if init_score:
            tree.add_bias(init_score)
        self.trees.append(tree)

    def _start_score(self, ds: Dataset) -> torch.Tensor:
        """[k, N] f32 scores a Dataset's rows start from: its init_score
        (N values, or k * N class by class: boosting/gbdt.py:710-715), or 0."""
        k, n = self.num_class, ds.num_data
        out = torch.zeros((k, n), dtype=torch.float32, device=self.device)
        if ds.init_score is not None:
            isc = np.asarray(ds.init_score, np.float32)
            if isc.size not in (n, k * n):
                raise ValueError(f"init_score has {isc.size} values, not {n} or {k * n}")
            out += torch.as_tensor(isc.reshape(k, n) if isc.size == k * n
                                   else isc.reshape(1, n), device=self.device)
        return out

    def _add_to_scores(self, val: float, c: int = 0) -> None:
        """An init score, added to class c's training and validation scores."""
        self.scores[c] += val
        for entry in self._valid:
            entry.scores[c] += val

    def _walk_one(self, rec: dict, bins: torch.Tensor) -> torch.Tensor:
        """[N] f32 leaf values of one tree's record on rows ``bins``: the
        forest-walk kernel (plain version on the CPU), or the plain walker
        when the kernel rejects the tree."""
        tables = self._tables_of([rec])
        if isinstance(tables, ForestTables):
            return forest_walk(bins, tables, 1)[:, 0]
        return predict_bins_raw(tables, bins, 1)[:, 0]

    def _next_rng(self):
        """The next key of the stream (boosting/gbdt.py:1632-1634)."""
        self._rng, sub = split(self._rng)
        return sub

    def _tree_rng(self):
        """The tree's key for ``feature_fraction_bynode`` (:1636-1649),
        drawn only when it is below 1."""
        if self.config.feature_fraction_bynode >= 1.0:
            return None
        return self._next_rng()

    def _bagging_rng(self):
        """The row sampler's key, drawn every iteration; an explicit
        ``bagging_seed`` folds in (:1651-1660)."""
        key = self._next_rng()
        if "bagging_seed" in self.config.raw:
            key = fold_in(key, self.config.bagging_seed)
        return key

    def _feature_mask_for_iter(self) -> torch.Tensor:
        """The tree's features (by-tree ``feature_fraction``,
        boosting/gbdt.py:2364-2385): ``round(F * fraction)`` of the F
        columns (EFB planes) chosen by ``np.random.default_rng(
        feature_fraction_seed + iteration)``; all at fraction 1."""
        cfg = self.config
        f = int(self._feature_mask.shape[0])
        if cfg.feature_fraction >= 1.0 or f == 0:
            return self._feature_mask
        rng = np.random.default_rng(cfg.feature_fraction_seed + self._iter)
        chosen = rng.choice(f, size=max(1, int(round(f * cfg.feature_fraction))), replace=False)
        m = np.zeros(f, dtype=bool)
        m[chosen] = True
        return torch.as_tensor(m, device=self.device)

    def _grow_inputs(self, grad, hess, mask):
        """(grad, hess, quant_scales) the tree grows on.  Quantized training
        (``_quant_grow_inputs``, boosting/gbdt.py:1020-1040, its key drawn
        whether or not the rounding is stochastic): the quantized gradients,
        and their scales for the int8 histograms when
        ``hist_method='pallas_int8'``; else the true (or quantized)
        gradients, and the int8 accumulator's scales over the in-bag rows
        ``mask`` where the gate admits it."""
        cfg = self.config
        if cfg.use_quantized_grad:
            key = self._next_rng()
            grad, hess, g_scale, h_scale = quantize_gradients(
                grad, hess, cfg.num_grad_quant_bins,
                constant_hessian=self.objective.is_constant_hessian,
                key=key if cfg.stochastic_rounding else None,
            )
            if cfg.hist_method == "pallas_int8":
                return grad, hess, torch.stack([g_scale, h_scale])
        if self._int8_acc:
            return grad, hess, hist_acc_scales(grad, hess, mask)
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
        """Training loss of the current score: binary log-loss or l2 in f64
        for those objectives, else the objective's default metric."""
        if hasattr(self.objective, "train_loss"):
            return self.objective.train_loss(self.score)
        metric = create_metric(self.config.default_metric()[0], self.train_set.label,
                               self.train_set.weight, self.device, self.config)
        return float(metric.eval(self.score, self.objective)[0][1])

    # ------------------------------------------------------------ prediction
    def _walk_tables(self, t0: int = 0, t1: Optional[int] = None):
        """Walk tables of trees [t0, t1) (all by default), cached."""
        key = (t0, len(self.trees) if t1 is None else t1)
        if key not in self._tables:
            self._tables[key] = self._tables_of([t.record() for t in self.trees[key[0]:key[1]]])
        return self._tables[key]

    def _tables_of(self, records):
        """The forest-walk kernel's tables of bin-space records, or, when
        the kernel rejects them (``walk_reject_reason``), the stacked trees
        of the plain walker (the JAX package's XLA fallback,
        boosting/gbdt.py:2646-2694), with a warning the first time.  An EFB
        model always takes the plain walker, which reads its nodes' tables
        (:2872-2875)."""
        if self.bundle_layout is not None:
            return stack_bin_trees(records, self.nan_bins, self.device)
        nf = len(self.nan_bins)
        reason = walk_reject_reason(records, self.nan_bins, nf, self._max_bin)
        if reason is None:
            return build_tables(records, self.nan_bins, self.device)
        if not self._warned_walk_fallback:
            self._warned_walk_fallback = True
            warnings.warn(
                "prediction fast path (forest-walk kernel) unavailable: "
                + reason + "; using the slower plain walker", stacklevel=4,
            )
        return stack_bin_trees(records, self.nan_bins, self.device)

    def _bin_host(self, x: np.ndarray, u8: Optional[bool] = None) -> np.ndarray:
        """Exact f64 host binning of rows x [n, F_total] -> [n, F_used]
        (categorical columns by ``_cat_bins``)."""
        cols = [self._cat_bins(j, x[:, j], u8) if self.bin_mappers[j].is_categorical
                else self.bin_mappers[j].values_to_bins(x[:, j]) for j in self.used_features]
        return np.stack(cols, axis=1) if cols else np.zeros((len(x), 0), np.int32)

    def _cat_bins(self, j: int, col: np.ndarray, u8: Optional[bool] = None) -> np.ndarray:
        """Predict-time bins of categorical column j: unseen values, and
        NaN without a NaN bin, at the sentinel bin that every categorical
        node sends right: 255 in the walk kernel's u8 bins, else 65535
        (``u8`` None: u8 up to 256 bins, as ``_bin_type``)."""
        u8 = self._max_bin <= 256 if u8 is None else u8
        return categorical_bins(self.bin_mappers[j], col, 255 if u8 else 65535)

    def _bin_type(self, bins, u8: Optional[bool] = None):
        """Rows' bins [N, P] (an array or a tensor) as the walkers take them
        on the booster's device: u8, or i32 (``u8`` None: u8 up to 256
        bins; past them only the plain walker walks, ``walk_reject_reason``)."""
        u8 = self._max_bin <= 256 if u8 is None else u8
        dt = torch.uint8 if u8 else torch.int32
        if isinstance(bins, np.ndarray):
            bins = torch.as_tensor(bins.astype(np.int32) if bins.dtype == np.uint16 else bins)
        return bins.to(device=self.device, dtype=dt)

    def predict_raw_bins(self, bins: torch.Tensor, t0: int = 0,
                         t1: Optional[int] = None) -> torch.Tensor:
        """Raw scores [N] ([N, k] for k trees an iteration) of already-
        binned rows [N, P] (u8 for the walk kernel, u8 or i32 for the plain
        walker; the training Dataset's columns: EFB planes, or used
        features) on the booster's device, through trees [t0, t1) (all by
        default; t0 a multiple of k, so tree t adds into class t % k)."""
        tables = self._walk_tables(t0, t1)
        if isinstance(tables, ForestTables):
            raw = forest_walk(bins, tables, self.num_class)
        else:
            raw = predict_bins_raw(tables, bins, self.num_class)
        if self.num_class == 1:
            raw = raw[:, 0]
        return raw + self.init_score if self.init_score else raw

    def predict(self, data: np.ndarray, start_iteration: int = 0,
                num_iteration: Optional[int] = None, raw_score: bool = False,
                pred_leaf: bool = False, pred_contrib: bool = False, **kwargs) -> np.ndarray:
        """Predictions of rows ``data`` [N, F] through iterations
        [start_iteration, start_iteration + num_iteration) (``_tree_range``:
        by default up to the best iteration once early stopping has set
        one), routed as the JAX Booster routes them (boosting/gbdt.py:
        2583-2693) but for a model read from text's scores:

        * ``pred_contrib``: TreeSHAP contributions [N, F + 1], or
          [N, k (F + 1)] for k trees an iteration (``shap.py``);
        * ``pred_leaf``: i32 leaf indices [N, T] by the streaming engine;
        * with ``pred_early_stop`` on a binary, cross-entropy or multiclass
          model: the margin rule over the engine's per-tree block
          (``_apply_pred_early_stop``);
        * a trained booster's scores otherwise: the walk path
          (``_walk_raw``: device binning, the forest-walk kernel or the
          plain walker past its limits);
        * a model read from text's scores otherwise: the real-space walker
          in large chunks (``_real_raw``, f64).

        Scores are [N], or [N, k] for k trees an iteration, in the
        objective's output space (``convert_output``: probabilities for a
        binary model, softmax over the classes) unless ``raw_score``.
        The keywords ``pred_early_stop``, ``pred_early_stop_freq``,
        ``pred_early_stop_margin``, ``pred_chunk_rows``,
        ``pred_num_buffers``, ``pred_shard_devices`` and ``pred_engine``
        win over the params' values; ``last_predict_stats`` then holds the
        call's phases."""
        unknown = sorted(set(kwargs) - _PREDICT_KEYS)
        if unknown:
            raise ValueError("predict keyword(s) not yet ported to lightgbm_tpu_torch: "
                             + ", ".join(unknown))
        x = np.asarray(data)
        if x.dtype not in (np.float32, np.float64):
            x = x.astype(np.float64)
        if x.ndim != 2:
            raise ValueError(f"data must be 2-D, got shape {x.shape}")
        n = x.shape[0]
        t0, t1 = self._tree_range(start_iteration, num_iteration)
        if pred_contrib:
            return predict_contrib(self, x, t0, t1)
        knobs = self._predict_knobs(kwargs)
        shard_count(knobs["shard_devices"], self.device)
        if t1 <= t0:
            if pred_leaf:
                return np.zeros((n, 0), np.int32)
            return np.zeros(n) if self.num_class == 1 else np.zeros((n, self.num_class))
        space = self._predict_space(t0, t1)
        if space == "real":
            self._check_real_width(x, t0, t1)
        eng = self._stream_engine()
        if pred_leaf:
            out = eng.run(x, t0, t1, space=space, kind="leaf", **knobs)
            self.last_predict_stats = eng.last_stats
            return out
        if not raw_score and self.objective is None:
            raise NotImplementedError(
                f"objective {self._objective_str!r} of this model not yet ported to "
                "lightgbm_tpu_torch (only raw_score=True predicts it)")
        early = bool(kwargs.get("pred_early_stop", self.config.pred_early_stop))
        if not (early and self._early_stop_type() != "none"):
            if space == "bin":
                return self._walk_raw(x, t0, t1, knobs["num_buffers"], raw_score)
            return self._real_raw(x, t0, t1, raw_score)
        per_tree = eng.run(x, t0, t1, space=space, kind="value", **knobs)
        self.last_predict_stats = eng.last_stats
        return self._finish_predict(self._apply_pred_early_stop(per_tree, kwargs), raw_score)

    def _predict_knobs(self, kwargs: Dict[str, Any]) -> Dict[str, Any]:
        """The streaming engine's knobs (boosting/gbdt.py:2695-2710):
        per-call keywords win over params."""
        cfg = self.config
        return {
            "chunk": int(kwargs.get("pred_chunk_rows", cfg.pred_chunk_rows)),
            "num_buffers": int(kwargs.get("pred_num_buffers", cfg.pred_num_buffers)),
            "shard_devices": int(kwargs.get("pred_shard_devices", cfg.pred_shard_devices)),
            "engine": check_pred_engine(str(kwargs.get("pred_engine", cfg.pred_engine))),
        }

    def _stream_engine(self) -> StreamingPredictor:
        if self._stream is None:
            self._stream = StreamingPredictor(self)
        return self._stream

    def _predict_space(self, t0: int, t1: int) -> str:
        """'bin' for a trained booster (exact bins from its mappers), 'real'
        for a model read from text (boosting/gbdt.py:2764-2777)."""
        return "bin" if self.bin_mappers is not None else "real"

    def _bin_matrix_width(self) -> int:
        """Columns of the host-binned rows: EFB planes, else the used
        features, one when none is used (boosting/gbdt.py:2719-2726)."""
        if self.bundle_layout is not None:
            return max(1, self.bundle_layout.num_planes)
        return max(1, len(self.used_features))

    def _bin_matrix(self, x: np.ndarray) -> np.ndarray:
        """Exact f64 host binning of rows x [n, F_total] into the model's
        bin columns, [n, _bin_matrix_width()] i32 (``_bin_input_host``,
        boosting/gbdt.py:3102-3146): categorical values outside the kept
        categories at the sentinel 65535, EFB members packed into their
        planes."""
        if self.bundle_layout is not None:
            def local(j):
                if self.bin_mappers[j].is_categorical:
                    return self._cat_bins(j, x[:, j], False)
                return self.bin_mappers[j].values_to_bins(x[:, j])
            return self.bundle_layout.pack_columns(len(x), local)
        if not self.used_features:
            return np.zeros((len(x), 1), np.int32)
        return self._bin_host(x, False).astype(np.int32, copy=False)

    def _check_real_width(self, x: np.ndarray, t0: int, t1: int) -> None:
        nf = max([int(t.split_feature_real.max()) + 1 for t in self.trees[t0:t1]
                  if t.num_leaves > 1] + [0])
        if x.shape[1] < nf:
            raise ValueError(f"data has {x.shape[1]} columns, the model splits on {nf}")

    def compile_predict(self, start_iteration: int = 0, num_iteration: Optional[int] = None,
                        kinds=("value",), chunk: Optional[int] = None,
                        pred_engine: Optional[str] = None) -> int:
        """Build what a predict of this tree range needs before the first
        one (``pred_aot_compile`` runs it when a model is read from text;
        boosting/gbdt.py:2736-2762): the engine's tables and the staging of
        every ladder bucket of ``chunk`` (default ``pred_chunk_rows``) for
        ``kinds`` (the tables also serve a model read from text's scores),
        and for a trained booster the walk path's tables, its device
        binning tables and the walk kernel (on the card).  Returns
        the tables and kernels built (0 when warm)."""
        t0, t1 = self._tree_range(start_iteration, num_iteration)
        if t1 <= t0:
            return 0
        knobs = self._predict_knobs({} if pred_engine is None else {"pred_engine": pred_engine})
        space = self._predict_space(t0, t1)
        built = self._stream_engine().warmup(
            t0, t1, space=space, chunk=knobs["chunk"] if chunk is None else chunk,
            kinds=kinds, num_buffers=knobs["num_buffers"])
        if space == "bin":
            built += self._walk_prereqs(t0, t1)[2]
        return built

    def _walk_prereqs(self, t0: int, t1: int):
        """(walk tables of [t0, t1), device binning tables, tables and
        kernels this call built)."""
        built = int((t0, t1) not in self._tables)
        tables = self._walk_tables(t0, t1)
        if self._devbin is None:
            self._devbin = build_devbin_tables(self.bin_mappers, self.used_features, self.device)
            built += 1
        if (isinstance(tables, ForestTables) and self.device.type == "cuda"
                and not _build.loaded("forest_walk")):
            _build.entry("forest_walk")
            built += 1
        return tables, self._devbin, built

    def _walk_raw(self, x: np.ndarray, t0: int, t1: int, num_buffers: int,
                  raw_score: bool) -> np.ndarray:
        """The walk path of a trained booster (boosting/gbdt.py:2948-3003):
        chunks of PREDICT_CHUNK rows, each chunk's used columns in f32 (the
        caller's rows themselves when they are C-ordered f32 with every
        column used, else gathered and converted on the host), copied to
        the device on a side stream and binned there in f32
        (``bin_numeric``); rows within f32 rounding of a bin boundary
        re-binned on the host in f64, so the bins equal the training
        Dataset's, and categorical columns binned on the host; packed into
        the EFB planes where the model has them; then walked by the
        forest-walk kernel (the plain walker on the same device when the
        kernel rejects the model).  With ``num_buffers`` of 2 or more,
        chunk i+1's gather, conversion and copy run while chunk i is binned
        and walked (the lookahead); with 1, they start once chunk i's
        suspect rows are read.  Each copy reads pageable memory, which the
        driver stages before the call returns, and no host buffer is
        reused, so nothing the host writes can reach a copy still in
        flight.  The phases go to ``last_predict_stats``, with the rows
        re-binned on the host (``suspect_rows``)."""
        dev = self.device
        cuda = dev.type == "cuda"
        tables, dbt, built = self._walk_prereqs(t0, t1)
        kernel = isinstance(tables, ForestTables)
        # u8 bins (sentinel 255) for the walk kernel, i32 (sentinel 65535)
        # for the plain walker, whose masks may claim bin 255
        u8 = kernel
        used = list(self.used_features)
        every = used == list(range(x.shape[1]))
        cat_pos = [i for i, j in enumerate(used) if self.bin_mappers[j].is_categorical]
        n = x.shape[0]
        stats = {"path": "forest_walk" if kernel else "plain_walk", "rows": n, "chunks": 0,
                 "bin_ms": 0.0, "transfer_ms": 0.0, "walk_ms": 0.0, "host_ms": 0.0,
                 "compiles": built, "suspect_rows": 0}
        chunks = [(lo, min(PREDICT_CHUNK, n - lo)) for lo in range(0, n, PREDICT_CHUNK)]
        side = torch.cuda.Stream(dev) if cuda else None
        main = torch.cuda.current_stream(dev) if cuda else None

        def clock(phase, t):
            stats[phase] += (time.perf_counter() - t) * 1e3

        def upload(ci):
            """(chunk ci's rows, its used columns in f32 on the device, the
            event that its copy on the side stream records)."""
            lo, rows = chunks[ci]
            t = time.perf_counter()
            xo = x[lo: lo + rows]
            xs = torch.as_tensor(np.ascontiguousarray(xo if every else xo[:, used],
                                                      dtype=np.float32))
            clock("bin_ms", t)
            if not cuda:
                return xo, xs, None
            t = time.perf_counter()
            with torch.cuda.stream(side):
                xd = xs.to(dev, non_blocking=True)
                copied = torch.cuda.Event()
                copied.record(side)
            clock("transfer_ms", t)
            return xo, xd, copied

        parts = []
        pending = upload(0) if chunks else None
        for ci in range(len(chunks)):
            xo, xs, copied = pending
            pending = None
            t = time.perf_counter()
            if cuda:
                main.wait_event(copied)
                xs.record_stream(main)  # made on the side stream, read on this one
            bins, suspect = bin_numeric(xs, *dbt)
            clock("walk_ms", t)
            if num_buffers > 1 and ci + 1 < len(chunks):
                pending = upload(ci + 1)  # the lookahead
            if cat_pos:  # categorical columns: binned on the host
                t = time.perf_counter()
                host = np.stack([self._cat_bins(used[i], xo[:, used[i]], u8)
                                 for i in cat_pos], axis=1)
                clock("bin_ms", t)
                t = time.perf_counter()
                bins[:, cat_pos] = torch.as_tensor(host, device=dev)
                clock("transfer_ms", t)
            t = time.perf_counter()
            sidx = torch.nonzero(suspect)[:, 0].cpu().numpy()
            clock("walk_ms", t)
            stats["suspect_rows"] += len(sidx)
            if len(sidx):
                t = time.perf_counter()
                patch = self._bin_host(xo[sidx], u8).astype(np.int32)
                clock("bin_ms", t)
                t = time.perf_counter()
                bins[torch.as_tensor(sidx, device=dev)] = torch.as_tensor(patch, device=dev)
                clock("transfer_ms", t)
            t = time.perf_counter()
            if self.bundle_layout is not None:
                bins = self.bundle_layout.pack_tensor(bins, used)
            parts.append(self.predict_raw_bins(self._bin_type(bins, u8), t0, t1))
            clock("walk_ms", t)
            stats["chunks"] += 1
            if pending is None and ci + 1 < len(chunks):
                pending = upload(ci + 1)
        t = time.perf_counter()
        raw = torch.cat(parts) if parts else torch.zeros(0, device=dev)
        if cuda:
            main.synchronize()
        clock("walk_ms", t)
        t = time.perf_counter()
        out = self._finish_predict(raw, raw_score)
        clock("host_ms", t)
        self.last_predict_stats = stats
        return out

    def _real_raw(self, x: np.ndarray, t0: int, t1: int, raw_score: bool) -> np.ndarray:
        """Scores of a model read from text through trees [t0, t1): the
        real-space walker (``predict_real_leaves``, f64) on the booster's
        device, in chunks of at most REAL_WALK_CELLS rows x trees, the leaf
        values summed there in f64.  The phases go to
        ``last_predict_stats`` (``bin_ms`` 0: nothing is binned)."""
        dev = self.device
        batch, built = self._stream_engine().stacked("real", t0, t1)
        n = x.shape[0]
        stats = {"path": "real_walk", "rows": n, "chunks": 0, "bin_ms": 0.0,
                 "transfer_ms": 0.0, "walk_ms": 0.0, "host_ms": 0.0, "compiles": built}
        trees = torch.arange(t1 - t0, device=dev)[None, :]
        step = max(1, REAL_WALK_CELLS // (t1 - t0))
        parts = []
        for lo in range(0, n, step):
            t = time.perf_counter()
            xs = torch.as_tensor(x[lo: lo + step], dtype=torch.float64, device=dev)
            stats["transfer_ms"] += (time.perf_counter() - t) * 1e3
            t = time.perf_counter()
            vals = batch.leaf_value[trees, predict_real_leaves(batch, xs)]
            sums = vals.reshape(len(xs), -1, self.num_class).sum(dim=1)
            parts.append(sums[:, 0] if self.num_class == 1 else sums)
            stats["walk_ms"] += (time.perf_counter() - t) * 1e3
            stats["chunks"] += 1
        t = time.perf_counter()
        raw = torch.cat(parts) if parts else torch.zeros(0, dtype=torch.float64, device=dev)
        if dev.type == "cuda":
            torch.cuda.current_stream(dev).synchronize()
        stats["walk_ms"] += (time.perf_counter() - t) * 1e3
        t = time.perf_counter()
        out = self._finish_predict(raw, raw_score)
        stats["host_ms"] += (time.perf_counter() - t) * 1e3
        self.last_predict_stats = stats
        return out

    def _early_stop_type(self) -> str:
        """The margin rule of the objective (boosting/gbdt.py:3005-3013):
        'multiclass' for k trees an iteration, 'binary' for a binary or
        cross-entropy model, else 'none' (no early stopping)."""
        if self.num_class > 1:
            return "multiclass"
        name = getattr(self.objective, "name", "")
        return "binary" if name in ("binary", "cross_entropy", "cross_entropy_lambda") else "none"

    def _apply_pred_early_stop(self, per_tree: np.ndarray, kwargs: Dict[str, Any]) -> np.ndarray:
        """Margin-based prediction early stopping over the per-tree block
        [N, T] f64 (boosting/gbdt.py:3015-3040; reference
        prediction_early_stop.cpp:26-75 and gbdt_prediction.cpp:18-36): each
        row's class sums stop at the first checkpoint (every
        ``pred_early_stop_freq`` iterations) where the margin exceeds
        ``pred_early_stop_margin``: 2 |sum| for one class, the largest sum
        less the second largest for k.  Returns [N], or [N, k]."""
        freq = max(1, int(kwargs.get("pred_early_stop_freq", self.config.pred_early_stop_freq)))
        margin_thr = float(kwargs.get("pred_early_stop_margin",
                                      self.config.pred_early_stop_margin))
        k = self.num_class
        n, total = per_tree.shape
        iters = total // k
        cum = np.cumsum(per_tree.reshape(n, iters, k), axis=1)  # [N, I, k]
        if k == 1:
            margin = 2.0 * np.abs(cum[:, :, 0])
        else:
            srt = np.sort(cum, axis=2)
            margin = srt[:, :, -1] - srt[:, :, -2]
        checkpoint = (np.arange(1, iters + 1) % freq) == 0
        stop = (margin > margin_thr) & checkpoint[None, :]
        first = np.where(stop.any(axis=1), stop.argmax(axis=1), iters - 1)
        out = cum[np.arange(n), first]
        return out[:, 0] if k == 1 else out

    def _tree_range(self, start_iteration: int, num_iteration: Optional[int]):
        """Trees [t0, t1) of a predict or a model text
        (boosting/gbdt.py:2568-2580), k trees an iteration:
        ``num_iteration`` None runs to the best iteration when early
        stopping set one, <= 0 to the last."""
        k = self.num_class
        total = len(self.trees) // k
        start = max(0, start_iteration)
        if num_iteration is None:
            end = self.best_iteration if self.best_iteration > 0 else total
            end = min(end, total)
        elif num_iteration <= 0:
            end = total
        else:
            end = min(total, start + num_iteration)
        return start * k, max(end, start) * k

    def current_iteration(self) -> int:
        """Iterations that added a tree."""
        return self._iter

    def num_trees(self) -> int:
        return len(self.trees)

    # ------------------------------------------------------------ evaluation
    def add_valid(self, data: Dataset, name: str) -> "Booster":
        """Evaluate ``data`` (made with ``reference=`` the training set)
        after every iteration: its score starts at its init_score and the
        trees already grown are walked onto it (boosting/gbdt.py:1569)."""
        if self.train_set is None:
            raise ValueError("a validation set needs a Booster that trains")
        data.construct()
        if data.bin_mappers is not self.bin_mappers:
            raise ValueError(
                "a validation set must be binned like the training set: make it "
                "with Dataset(..., reference=train_set)")
        metrics = create_metrics(self.config, data.label, data.weight, self.device)
        bins = self._bin_type(data.bins)
        scores = self._start_score(data)
        for i, tree in enumerate(self.trees):
            c = i % self.num_class
            if tree.num_leaves <= 1:
                scores[c] += float(tree.leaf_value[0])
            else:
                scores[c] += self._walk_one(tree.record(), bins)
        self._valid.append(_EvalEntry(name, data, metrics, bins, scores))
        return self

    def _eval(self, name: str, score: torch.Tensor, metrics, dataset, feval):
        out = []
        for m in metrics:
            for mname, val in m.eval(score, self.objective):
                out.append((name, mname, val, m.is_higher_better))
        if feval is not None:
            # feval takes output-space predictions (GBDT::GetPredictAt),
            # [N, k] for k trees an iteration (boosting/gbdt.py:2480-2492)
            s = score.double() if score.dim() == 1 else score.double().T
            pred = self.objective.convert_output(s).cpu().numpy()
            for f in (feval if isinstance(feval, (list, tuple)) else [feval]):
                res = f(pred, dataset)
                for fname, val, hib in (res if isinstance(res, list) else [res]):
                    out.append((name, fname, val, hib))
        return out

    def eval_train(self, feval=None):
        """[('training', metric, value, is_higher_better)] of the training score."""
        return self._eval("training", self.score, self._train_metrics, self.train_set, feval)

    def eval_valid(self, feval=None):
        """The same of every validation set, in the order they were added."""
        out = []
        for e in self._valid:
            out.extend(self._eval(e.name, e.score, e.metrics, e.dataset, feval))
        return out

    # ------------------------------------------------------------ model text
    def _split_counts(self, t1: int) -> np.ndarray:
        """Splits on each original feature in the first ``t1`` trees."""
        counts = np.zeros(self.max_feature_idx + 1)
        for tree in self.trees[:t1]:
            counts += np.bincount(tree.split_feature_real, minlength=len(counts))
        return counts

    def model_to_string(self, num_iteration: Optional[int] = None,
                        start_iteration: int = 0) -> str:
        """LightGBM's model text (GBDT::SaveModelToString,
        gbdt_model_text.cpp:314): the header, the trees of ``_tree_range``,
        the split counts of their features, the parameters block."""
        t0, t1 = self._tree_range(start_iteration, num_iteration)
        tree_strs = [self.trees[i].to_string(i - t0) for i in range(t0, t1)]
        lines = [
            "tree",
            f"version={self._version}",
            f"num_class={self.num_class}",
            f"num_tree_per_iteration={self.num_class}",
            "label_index=0",
            f"max_feature_idx={self.max_feature_idx}",
            f"objective={self._objective_str}",
            "feature_names=" + " ".join(self.feature_names),
            "feature_infos=" + " ".join(self.feature_infos),
            "tree_sizes=" + " ".join(str(len(t) + 1) for t in tree_strs),
            "",
        ]
        body = "\n".join(tree_strs)
        out = "\n".join(lines) + "\n" + body + ("\n" if body else "") + "end of trees\n"
        imp = self._split_counts(t1)
        pairs = sorted([(imp[i], self.feature_names[i]) for i in range(len(imp)) if imp[i] > 0],
                       key=lambda p: -p[0])
        out += "\nfeature_importances:\n"
        for v, fname in pairs:
            out += f"{fname}={int(v)}\n"
        if self._params_tail is None:
            out += "\nparameters:\n"
            for key, val in self.params.items():
                if isinstance(val, (list, tuple)):
                    val = ",".join(str(v) for v in val)
                out += f"[{key}: {val}]\n"
            return out + "end of parameters\n\npandas_categorical:null\n"
        return out + self._params_tail

    def save_model(self, filename: str, num_iteration: Optional[int] = None,
                   start_iteration: int = 0) -> "Booster":
        """Write ``model_to_string`` to ``filename`` (through a temporary file
        and a rename: a save cut short leaves the earlier file whole)."""
        text = self.model_to_string(num_iteration, start_iteration)
        tmp = f"{filename}.tmp"
        with open(tmp, "w") as f:
            f.write(text)
        os.replace(tmp, filename)
        return self

    def model_from_string(self, model_str: str) -> "Booster":
        """Replace this booster's model by the one in ``model_str``."""
        self._load_model_string(model_str)
        return self

    def _load_model_string(self, s: str) -> None:
        """GBDT::LoadModelFromString (gbdt_model_text.cpp:468): the header
        (``num_tree_per_iteration`` trees an iteration), the objective of
        its ``objective=`` line (``_output_objective``) and the trees.  The
        text from the parameters block on is kept as it was; it does not
        configure this booster."""
        _, marker, rest = s.rpartition("\nparameters:\n")
        self._params_tail = marker + rest if marker else ""
        header, _, trees_part = s.partition("Tree=")
        kv = {}
        for line in header.splitlines():
            line = line.strip()
            if "=" in line:
                key, v = line.split("=", 1)
                kv[key] = v
            elif line == "average_output":
                raise NotImplementedError(
                    "average_output (random forest) models not yet ported to lightgbm_tpu_torch")
        self.num_class = int(kv.get("num_tree_per_iteration", kv.get("num_class", 1)))
        self._version = kv.get("version", _MODEL_VERSION)
        self.max_feature_idx = int(kv.get("max_feature_idx", -1))
        self.feature_names = kv.get("feature_names", "").split()
        self.feature_infos = kv.get("feature_infos", "").split()
        self._objective_str = kv.get("objective", "")
        self.objective = _output_objective(self._objective_str, self.device,
                                           int(kv.get("num_class", 1)))
        blocks = ("Tree=" + trees_part).partition("end of trees")[0].split("Tree=")
        self.trees = [Tree.from_string(b) for b in blocks if b.strip()]
        self.train_set = None
        self.bin_mappers = None
        self.bundle_layout = None
        self._valid = []
        self._train_metrics = []
        self._iter = len(self.trees) // self.num_class
        self.best_iteration = -1
        self.init_score = 0.0
        self._drop_predict_caches()
        self._devbin = None

    def _drop_predict_caches(self) -> None:
        """Forget the walk tables and staging buffers once the trees change."""
        self._tables = {}
        self._staging = {}

    def _finish_predict(self, raw, raw_score: bool) -> np.ndarray:
        """Raw scores (a tensor, or an f64 array from the streaming engine,
        converted on the host) -> output space (gbdt.py:2826)."""
        if isinstance(raw, np.ndarray):
            raw = torch.as_tensor(raw)
        if not raw_score and self.objective is not None:
            raw = self.objective.convert_output(raw)
        return raw.double().cpu().numpy()


def _output_objective(text: str, device, num_class: int = 1):
    """The objective that converts a model's raw scores, from the model
    text's ``objective=`` line (its name, then ``key:value`` tokens and
    ``sqrt``, as boosting/gbdt.py:3340-3354 reads them), with no rows;
    None for an objective not yet ported (its model predicts only raw
    scores)."""
    parts = text.split()
    name = _OBJECTIVE_ALIASES.get(parts[0]) if parts else None
    if name is None:
        return None
    params = {"objective": name}
    if name in ("multiclass", "multiclassova"):
        params["num_class"] = num_class
    for tok in parts[1:]:
        if ":" in tok:
            key, val = tok.split(":", 1)
            params[key] = val
        elif tok == "sqrt":
            params["reg_sqrt"] = True
    try:
        return create_objective(Config.from_params(params), np.zeros(0), device)
    except ValueError:
        return None

