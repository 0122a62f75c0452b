"""Parameters of the PyTorch port.

Counterpart of ``lightgbm_tpu/config.py``, cut to the fields this port
reads.  A parameter outside that set raises ``ValueError`` naming it as not
yet ported, so a user never trains silently with an option ignored.

The objectives (``objectives.py``; lightgbm_tpu/config.py:192-233,
:555-577, :664-667, :772-792): regression (with ``reg_sqrt``, also by the
names l2_root / rmse), regression_l1, huber and quantile (``alpha``), fair
(``fair_c``), poisson (``poisson_max_delta_step``), mape, gamma, tweedie
(``tweedie_variance_power``), binary (``sigmoid``), multiclass and
multiclassova (``num_class`` >= 2, alias ``num_classes``; k trees an
iteration), cross_entropy and cross_entropy_lambda, with the JAX package's
aliases and each one's default metric; the multiclass metrics'
``multi_error_top_k`` and ``auc_mu_weights``.  The ranking objectives and
``is_unbalance`` / ``scale_pos_weight`` are not ported (unknown keys raise).

The path parameters take the JAX package's defaults and values
(:320-364, validation :672-706) on the single-host layouts:

* ``hist_mode``: unset, the Booster resolves it by the JAX package's rule
  (boosting/gbdt.py:1313-1369): the segment-resident layout ('seg') at
  0 < used features <= 242, else the ordered layout ('ordered': an index
  array of leaf windows over the row-major bins), which wide data takes;
  'seg' and 'ordered' may be named; 'gather' and 'full' are not ported;
* ``hist_method``: 'auto', or 'pallas_int8' (the exact int8 histograms
  of quantized gradients on their scales, the ordered layout's and the
  segment histogram's, which needs ``use_quantized_grad``);
* ``use_quantized_grad`` with ``num_grad_quant_bins`` (<= 127): trees grow
  on gradients quantized once per iteration (ops/quantize.py:32-80), with
  LightGBM's default ``stochastic_rounding=True`` (threefry draws,
  ``random.py``) or deterministically, on either layout (on seg with
  ``hist_method='pallas_int8'`` the segment histogram's exact int8 mode,
  else the default seg path); ``quant_train_renew_leaf`` still raises;
* ``grow_fused`` in auto/on/off (seg only): one fused grow step per split,
  or a partition and a histogram launch ('off'); 'auto' is on, as it is
  on the seg path (boosting/gbdt.py:1410-1415);
* ``fused_split_scan``: the per-feature split-scan kernel.  The fused grow
  step implies it (ops/grower.py:460-463), so ``fused_split_scan=False``
  with ``grow_fused='off'`` is the one combination not yet ported;
* ``hist_acc`` in auto/int8/bf16: int8 2-digit accumulation with the f32
  near-tie refine below ``hist_near_tie_tol`` ('auto', 'int8' where the
  gate admits it: seg, on the card), or f32-accurate sums ('bf16', the
  name the JAX package gives its 3-term accumulator);
* ``leaf_batch`` >= 1: frontier leaves split per grow step (1 = the
  serial loop), with ``leaf_batch_adaptive`` (halve K when the commit
  rate's EMA falls below ``leaf_batch_min_commit_rate``) as in
  boosting/gbdt.py:291-335;
* the train API's keys: ``num_iterations`` (the rounds ``train`` runs when
  the params carry it), ``verbosity``, ``metric`` (a list, or a
  comma-separated string; empty: the objective's default metric),
  ``metric_freq``, ``is_provide_training_metric``, ``early_stopping_round``
  (> 0 adds the early-stopping callback) with ``early_stopping_min_delta``
  and ``first_metric_only``;
* sampling (``boosting/sampling.py``): ``bagging_fraction`` with
  ``bagging_freq`` (per row, or balanced by ``pos_bagging_fraction`` /
  ``neg_bagging_fraction`` on the binary objective), ``boosting='goss'`` or
  ``data_sample_strategy='goss'`` with ``top_rate`` / ``other_rate``,
  ``feature_fraction`` (by tree) and ``feature_fraction_bynode``, with the
  JAX package's aliases (lightgbm_tpu/config.py:27-28, :74-88) and seeds:
  ``seed`` (aliases ``random_seed``, ``random_state``) re-derives
  ``bagging_seed``, ``feature_fraction_seed`` and ``data_random_seed``
  where the params do not name them (:640-655).  ``boosting`` other than
  'gbdt' and 'goss', ``extra_trees`` and ``bagging_by_query`` are not
  ported and raise;
* ``enable_bundle`` (default True, aliases ``is_enable_bundle`` and
  ``bundle``) with ``max_conflict_rate``: Exclusive Feature Bundling, as
  the JAX package does it (lightgbm_tpu/config.py:488): mutually exclusive
  sparse columns share bin planes (``bundling.py``), where a sampled row may
  have two members nonzero in at most ``max_conflict_rate`` of the sample;
  ``enable_bundle=False`` trains every column in its own plane.  No option
  that the JAX package refuses beside a bundle (boosting/gbdt.py:896-936:
  monotone and interaction constraints, forced splits, extra_trees, CEGB,
  feature- and voting-parallel learners) is ported, so none is refused here;
* ``categorical_feature`` (aliases ``cat_feature``, ``categorical_column``,
  ``cat_column``, ``categorical_features``; indices, column names, names
  with a ``name:`` prefix, or a comma-separated string; a Dataset argument
  of the same name wins over it) with ``max_cat_to_onehot``,
  ``max_cat_threshold``, ``cat_l2``, ``cat_smooth`` and
  ``min_data_per_group``: integer-coded categorical columns of numpy input,
  binned a bin a category and split by one-hot or sorted-subset search
  (``ops/split.py``).  Pandas ``category`` columns and ``pandas_categorical``
  in model text are not ported (a DataFrame is not an input of the port's
  Dataset).
* prediction (lightgbm_tpu/config.py:521-539, :676-678):
  ``pred_early_stop`` with ``pred_early_stop_freq`` and
  ``pred_early_stop_margin`` (the margin rule of a binary model; a
  regression model ignores them), the streaming predictor's
  ``pred_chunk_rows`` (4096), ``pred_num_buffers`` (2: chunks in flight,
  and the walk path's staging slots), ``pred_shard_devices`` (1; a count
  that resolves to more than one device raises: ROADMAP Queue 1, item 9),
  ``pred_aot_compile`` (``Booster.compile_predict`` when a model is read
  from text) and ``pred_engine`` ('walk'; 'matmul' and 'auto' name the
  tensor-forest engine, ROADMAP Queue 1, item 7, and raise).  Each may also
  be given to ``Booster.predict`` as a keyword, which wins.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

_PARAM_ALIASES: Dict[str, str] = {
    "objective_type": "objective",
    "app": "objective",
    "application": "objective",
    "loss": "objective",
    "shrinkage_rate": "learning_rate",
    "eta": "learning_rate",
    "num_leaf": "num_leaves",
    "max_leaves": "num_leaves",
    "max_leaf": "num_leaves",
    "max_leaf_nodes": "num_leaves",
    "min_data_per_leaf": "min_data_in_leaf",
    "min_data": "min_data_in_leaf",
    "min_child_samples": "min_data_in_leaf",
    "min_samples_leaf": "min_data_in_leaf",
    "min_sum_hessian_per_leaf": "min_sum_hessian_in_leaf",
    "min_sum_hessian": "min_sum_hessian_in_leaf",
    "min_hessian": "min_sum_hessian_in_leaf",
    "min_child_weight": "min_sum_hessian_in_leaf",
    "reg_alpha": "lambda_l1",
    "l1_regularization": "lambda_l1",
    "reg_lambda": "lambda_l2",
    "lambda": "lambda_l2",
    "l2_regularization": "lambda_l2",
    "min_split_gain": "min_gain_to_split",
    "max_bins": "max_bin",
    "subsample_for_bin": "bin_construct_sample_cnt",
    "data_seed": "data_random_seed",
    "random_seed": "seed",
    "random_state": "seed",
    "boosting_type": "boosting",
    "boost": "boosting",
    "sub_row": "bagging_fraction",
    "subsample": "bagging_fraction",
    "bagging": "bagging_fraction",
    "pos_sub_row": "pos_bagging_fraction",
    "pos_subsample": "pos_bagging_fraction",
    "pos_bagging": "pos_bagging_fraction",
    "neg_sub_row": "neg_bagging_fraction",
    "neg_subsample": "neg_bagging_fraction",
    "neg_bagging": "neg_bagging_fraction",
    "subsample_freq": "bagging_freq",
    "bagging_fraction_seed": "bagging_seed",
    "sub_feature": "feature_fraction",
    "colsample_bytree": "feature_fraction",
    "sub_feature_bynode": "feature_fraction_bynode",
    "colsample_bynode": "feature_fraction_bynode",
    "is_enable_bundle": "enable_bundle",
    "bundle": "enable_bundle",
    "num_iteration": "num_iterations",
    "n_iter": "num_iterations",
    "num_tree": "num_iterations",
    "num_trees": "num_iterations",
    "num_round": "num_iterations",
    "num_rounds": "num_iterations",
    "nrounds": "num_iterations",
    "num_boost_round": "num_iterations",
    "n_estimators": "num_iterations",
    "max_iter": "num_iterations",
    "early_stopping_rounds": "early_stopping_round",
    "early_stopping": "early_stopping_round",
    "n_iter_no_change": "early_stopping_round",
    "verbose": "verbosity",
    "metrics": "metric",
    "metric_types": "metric",
    "output_freq": "metric_freq",
    "training_metric": "is_provide_training_metric",
    "cat_feature": "categorical_feature",
    "categorical_column": "categorical_feature",
    "cat_column": "categorical_feature",
    "categorical_features": "categorical_feature",
    "is_training_metric": "is_provide_training_metric",
    "train_metric": "is_provide_training_metric",
    "num_classes": "num_class",
}

# the JAX package's objective names and aliases (lightgbm_tpu/config.py:
# 192-233); the ranking objectives are not ported yet
_OBJECTIVE_ALIASES: Dict[str, str] = {
    "regression": "regression",
    "regression_l2": "regression",
    "l2": "regression",
    "mean_squared_error": "regression",
    "mse": "regression",
    "l2_root": "regression",
    "root_mean_squared_error": "regression",
    "rmse": "regression",
    "regression_l1": "regression_l1",
    "l1": "regression_l1",
    "mean_absolute_error": "regression_l1",
    "mae": "regression_l1",
    "mean_absolute_percentage_error": "mape",
    "mape": "mape",
    "huber": "huber",
    "fair": "fair",
    "poisson": "poisson",
    "quantile": "quantile",
    "gamma": "gamma",
    "tweedie": "tweedie",
    "binary": "binary",
    "multiclass": "multiclass",
    "softmax": "multiclass",
    "multiclassova": "multiclassova",
    "multiclass_ova": "multiclassova",
    "ova": "multiclassova",
    "ovr": "multiclassova",
    "cross_entropy": "cross_entropy",
    "xentropy": "cross_entropy",
    "cross_entropy_lambda": "cross_entropy_lambda",
    "xentlambda": "cross_entropy_lambda",
}
# the objectives' default metrics (lightgbm_tpu/config.py:772-792)
_DEFAULT_METRIC: Dict[str, str] = {
    "regression": "l2", "regression_l1": "l1", "huber": "huber", "fair": "fair",
    "poisson": "poisson", "quantile": "quantile", "mape": "mape", "gamma": "gamma",
    "tweedie": "tweedie", "binary": "binary_logloss", "multiclass": "multi_logloss",
    "multiclassova": "multi_logloss", "cross_entropy": "cross_entropy",
    "cross_entropy_lambda": "cross_entropy_lambda",
}

HIST_MODES = ("seg", "ordered")
HIST_METHODS = ("auto", "pallas_int8")
# the JAX package's layouts that are not ported yet
_UNPORTED_HIST_MODES = ("gather", "full")


# the most windows one launch of the grow-step and partition kernels takes
MAX_LEAF_BATCH = 16


def check_pred_engine(engine: str) -> str:
    """``pred_engine``: 'walk' is the port's engine; 'matmul' and 'auto'
    (which may resolve to the tensor-forest engine in the JAX package, so
    taking it silently would change what runs) raise."""
    if engine in ("matmul", "auto"):
        raise NotImplementedError(
            f"pred_engine={engine!r} not yet ported to lightgbm_tpu_torch: the "
            "tensor-forest engine is ROADMAP Queue 1, item 7 (ported: 'walk')")
    if engine != "walk":
        raise ValueError("pred_engine must be one of 'walk', 'matmul', 'auto'")
    return engine


def _to_bool(v: Any) -> bool:
    if isinstance(v, bool):
        return v
    if isinstance(v, (int, float)):
        return bool(v)
    s = str(v).strip().lower()
    if s in ("true", "1", "yes", "+"):
        return True
    if s in ("false", "0", "no", "-"):
        return False
    raise ValueError(f"cannot parse boolean from {v!r}")


def _to_str_list(v: Any) -> List[str]:
    """A list of names from a list or a comma-separated string."""
    if v is None or v == "":
        return []
    if isinstance(v, (list, tuple)):
        return [str(x) for x in v]
    return [s for s in str(v).split(",") if s != ""]


@dataclasses.dataclass
class Config:
    """Typed view of a LightGBM-style parameter dict (the ported subset)."""

    objective: str = "regression"
    num_leaves: int = 31
    max_bin: int = 255
    learning_rate: float = 0.1
    min_data_in_leaf: int = 20
    min_sum_hessian_in_leaf: float = 1e-3
    lambda_l1: float = 0.0
    lambda_l2: float = 0.0
    min_gain_to_split: float = 0.0
    bin_construct_sample_cnt: int = 200000
    data_random_seed: int = 1
    boost_from_average: bool = True
    # the objectives (lightgbm_tpu/config.py:555-577)
    num_class: int = 1
    sigmoid: float = 1.0
    reg_sqrt: bool = False
    alpha: float = 0.9
    fair_c: float = 1.0
    poisson_max_delta_step: float = 0.7
    tweedie_variance_power: float = 1.5
    multi_error_top_k: int = 1
    auc_mu_weights: List[float] = dataclasses.field(default_factory=list)
    # sampling (boosting/sampling.py) and its seeds; ``seed`` re-derives the
    # seeds the params do not name (_apply_seed)
    seed: Optional[int] = None
    boosting: str = "gbdt"
    data_sample_strategy: str = "bagging"
    bagging_fraction: float = 1.0
    pos_bagging_fraction: float = 1.0
    neg_bagging_fraction: float = 1.0
    bagging_freq: int = 0
    bagging_seed: int = 3
    top_rate: float = 0.2
    other_rate: float = 0.1
    feature_fraction: float = 1.0
    feature_fraction_bynode: float = 1.0
    feature_fraction_seed: int = 2
    # Exclusive Feature Bundling (bundling.py): True bundles mutually
    # exclusive sparse columns into shared planes, False keeps a plane a column
    enable_bundle: bool = True
    max_conflict_rate: float = 0.0
    # categorical features (lightgbm_tpu/config.py:408-412, :508): the
    # columns (indices, names, a comma-separated string) and the sorted-
    # subset split search's keys
    categorical_feature: Any = ""
    max_cat_to_onehot: int = 4
    max_cat_threshold: int = 32
    cat_l2: float = 10.0
    cat_smooth: float = 10.0
    min_data_per_group: int = 100
    hist_mode: Optional[str] = None  # None: the Booster's layout rule
    hist_method: str = "auto"
    use_quantized_grad: bool = False
    num_grad_quant_bins: int = 4
    stochastic_rounding: bool = True
    quant_train_renew_leaf: bool = False
    leaf_batch: int = 1
    leaf_batch_adaptive: bool = True
    leaf_batch_min_commit_rate: float = 0.625
    grow_fused: str = "auto"
    fused_split_scan: bool = False
    hist_acc: str = "auto"
    hist_near_tie_tol: float = 1e-3
    # the train API (engine.train, the Booster's metrics)
    num_iterations: int = 100
    verbosity: int = 1
    metric: List[str] = dataclasses.field(default_factory=list)
    metric_freq: int = 1
    is_provide_training_metric: bool = False
    early_stopping_round: int = 0
    early_stopping_min_delta: float = 0.0
    first_metric_only: bool = False
    # prediction (Booster.predict; per-call keywords win over these)
    pred_early_stop: bool = False
    pred_early_stop_freq: int = 10
    pred_early_stop_margin: float = 10.0
    pred_chunk_rows: int = 4096
    pred_num_buffers: int = 2
    pred_shard_devices: int = 1
    pred_aot_compile: bool = False
    pred_engine: str = "walk"
    # the canonical keys the params gave, with their values
    raw: Dict[str, Any] = dataclasses.field(default_factory=dict, repr=False)

    @classmethod
    def from_params(cls, params: Optional[Dict[str, Any]]) -> "Config":
        cfg = cls()
        resolved: Dict[str, Any] = {}
        # canonical name wins over its aliases, else the first alias seen
        for key, value in dict(params or {}).items():
            canon = _PARAM_ALIASES.get(key, key)
            if canon in resolved and canon != key:
                continue
            resolved[canon] = value
        fields = {f.name: f for f in dataclasses.fields(cls) if f.name != "raw"}
        unknown = sorted(k for k in resolved if k not in fields)
        if unknown:
            raise ValueError(
                "parameter(s) not yet ported to lightgbm_tpu_torch: "
                + ", ".join(unknown)
            )
        for name, v in resolved.items():
            typ = fields[name].type
            try:
                if typ in ("bool", bool):
                    setattr(cfg, name, _to_bool(v))
                elif typ in ("int", int):
                    setattr(cfg, name, int(float(v)))
                elif typ in ("float", float):
                    setattr(cfg, name, float(v))
                elif name == "seed":
                    setattr(cfg, name, None if v is None else int(float(v)))
                elif name == "metric":
                    setattr(cfg, name, _to_str_list(v))
                elif name == "auc_mu_weights":
                    setattr(cfg, name, [float(x) for x in _to_str_list(v)])
                elif name == "categorical_feature":
                    setattr(cfg, name, v)
                else:
                    setattr(cfg, name, str(v))
            except (TypeError, ValueError) as exc:
                raise ValueError(f"bad value for parameter {name!r}: {v!r}") from exc
        cfg.raw = resolved
        cfg._apply_seed()
        obj = _OBJECTIVE_ALIASES.get(cfg.objective)
        if obj is None:
            raise ValueError(
                f"objective {cfg.objective!r} not yet ported to "
                "lightgbm_tpu_torch (ported: " + ", ".join(sorted(set(
                    _OBJECTIVE_ALIASES.values()))) + ")"
            )
        if str(cfg.objective).lower() in ("l2_root", "root_mean_squared_error", "rmse"):
            cfg.reg_sqrt = True
        cfg.objective = obj
        cfg._check_objective()
        if cfg.hist_mode in _UNPORTED_HIST_MODES:
            raise ValueError(
                f"hist_mode={cfg.hist_mode!r} not yet ported to lightgbm_tpu_torch "
                f"(ported: {', '.join(HIST_MODES)})"
            )
        if cfg.hist_mode is not None and cfg.hist_mode not in HIST_MODES:
            raise ValueError(f"unknown hist_mode {cfg.hist_mode!r}")
        if cfg.hist_method not in HIST_METHODS:
            raise ValueError(
                f"hist_method={cfg.hist_method!r} not yet ported to "
                f"lightgbm_tpu_torch (ported: {', '.join(HIST_METHODS)})"
            )
        cfg._check_quantized()
        cfg._check_sampling()
        if cfg.leaf_batch < 1:
            raise ValueError("leaf_batch must be >= 1")
        if cfg.leaf_batch > MAX_LEAF_BATCH:
            raise ValueError(
                f"leaf_batch={cfg.leaf_batch} not yet ported to lightgbm_tpu_torch "
                f"(the batched kernels take at most {MAX_LEAF_BATCH} windows)"
            )
        if not 0.0 <= cfg.leaf_batch_min_commit_rate <= 1.0:
            raise ValueError("leaf_batch_min_commit_rate must be in [0, 1]")
        if cfg.grow_fused not in ("auto", "on", "off"):
            raise ValueError("grow_fused must be one of 'auto', 'on', 'off'")
        if cfg.hist_acc not in ("auto", "int8", "bf16"):
            raise ValueError("hist_acc must be one of 'auto', 'int8', 'bf16'")
        if cfg.hist_near_tie_tol < 0.0:
            raise ValueError("hist_near_tie_tol must be >= 0")
        # on the ordered layout the split-scan kernel is the port's split
        # search whatever these two say (the JAX package leaves its fused
        # scan there above 64 features, ops/grower.py:460-478)
        if (cfg.hist_mode != "ordered" and not cfg.resolved_grow_fused()
                and not cfg.fused_split_scan):
            raise ValueError(
                "fused_split_scan=False with grow_fused='off' not yet ported "
                "to lightgbm_tpu_torch on the seg layout (the port scans "
                "splits with the split-scan kernel: set fused_split_scan=True "
                "or grow_fused to 'auto' or 'on')"
            )
        if cfg.num_leaves < 2:
            raise ValueError("num_leaves must be >= 2")
        check_pred_engine(cfg.pred_engine)
        if not 0.0 <= cfg.max_conflict_rate < 1.0:
            raise ValueError("max_conflict_rate must be in [0, 1)")
        if cfg.max_bin < 2:
            raise ValueError("max_bin must be >= 2")
        if cfg.max_cat_to_onehot < 1 or cfg.max_cat_threshold < 1:
            raise ValueError("max_cat_to_onehot and max_cat_threshold must be >= 1")
        if cfg.cat_l2 < 0.0 or cfg.cat_smooth < 0.0 or cfg.min_data_per_group < 1:
            raise ValueError("cat_l2 and cat_smooth must be >= 0, min_data_per_group >= 1")
        return cfg

    def cat_params(self):
        """The categorical split search's keys (``ops.split.CatParams``)."""
        from .ops.split import CatParams

        return CatParams(self.max_cat_to_onehot, self.max_cat_threshold, self.cat_l2,
                         self.cat_smooth, self.min_data_per_group)

    def _apply_seed(self) -> None:
        """``seed`` re-derives the seeds the port reads that the params do
        not name (lightgbm_tpu/config.py:640-655): bagging_seed = seed + 3,
        feature_fraction_seed = seed + 2, data_random_seed = seed + 1."""
        if self.seed is None:
            return
        base = int(self.seed)
        for name, off in (("bagging_seed", 3), ("feature_fraction_seed", 2),
                          ("data_random_seed", 1)):
            if name not in self.raw:
                setattr(self, name, base + off)

    def _check_sampling(self) -> None:
        """The sampling keys: ``boosting`` 'gbdt' or 'goss' (or
        ``data_sample_strategy='goss'``), the fractions in (0, 1], GOSS's
        rates (boosting/sampling.py), and balanced bagging's binary
        objective (lightgbm_tpu/config.py:747-749)."""
        if self.boosting not in ("gbdt", "goss"):
            raise ValueError(
                f"boosting={self.boosting!r} not yet ported to lightgbm_tpu_torch "
                "(ported: gbdt, goss)")
        if self.data_sample_strategy not in ("bagging", "goss"):
            raise ValueError(
                f"data_sample_strategy must be 'bagging' or 'goss', got "
                f"{self.data_sample_strategy!r}")
        for name in ("bagging_fraction", "pos_bagging_fraction", "neg_bagging_fraction",
                     "feature_fraction", "feature_fraction_bynode"):
            if not 0.0 < getattr(self, name) <= 1.0:
                raise ValueError(f"{name} must be in (0, 1]")
        if self.is_goss():
            if self.top_rate + self.other_rate > 1.0:
                raise ValueError("top_rate + other_rate must be <= 1.0")
            if self.top_rate <= 0 or self.other_rate <= 0:
                raise ValueError("top_rate and other_rate must be > 0 for GOSS")
        if (self.bagging_freq > 0 and self.objective != "binary"
                and (self.pos_bagging_fraction < 1.0 or self.neg_bagging_fraction < 1.0)):
            raise ValueError("pos/neg bagging fractions require binary objective")

    def is_goss(self) -> bool:
        """GOSS row sampling: ``boosting='goss'`` or
        ``data_sample_strategy='goss'`` (boosting/sampling.py:213-216)."""
        return self.boosting == "goss" or self.data_sample_strategy == "goss"

    def _check_quantized(self) -> None:
        """The quantized-training keys (lightgbm_tpu/config.py:475-478) and
        the int8 kernel's need for them (boosting/gbdt.py:1302)."""
        if self.hist_method == "pallas_int8" and not self.use_quantized_grad:
            raise ValueError(
                "hist_method='pallas_int8' needs quantized gradients "
                "(use_quantized_grad=True provides the scales)"
            )
        if self.num_grad_quant_bins > 127:
            raise ValueError("num_grad_quant_bins must be <= 127 (int8 grid)")
        if self.use_quantized_grad and self.quant_train_renew_leaf:
            raise ValueError(
                "quant_train_renew_leaf=True not yet ported to lightgbm_tpu_torch "
                "(leaf values come from the quantized sums)"
            )

    def _check_objective(self) -> None:
        """The objectives' checks (lightgbm_tpu/config.py:666-667 and the
        objectives' own): num_class >= 2 for the multiclass ones, sigmoid
        > 0, quantile's alpha in (0, 1)."""
        if self.objective in ("multiclass", "multiclassova") and self.num_class < 2:
            raise ValueError(f"objective {self.objective} requires num_class >= 2")
        if self.sigmoid <= 0:
            raise ValueError("sigmoid parameter must be > 0")
        if self.objective == "quantile" and not 0.0 < self.alpha < 1.0:
            raise ValueError("alpha must be in (0, 1) for quantile objective")

    def num_tree_per_iteration(self) -> int:
        """Trees an iteration: num_class for the multiclass objectives, else 1."""
        return self.num_class if self.objective in ("multiclass", "multiclassova") else 1

    def default_metric(self) -> List[str]:
        """The objective's metric when ``metric`` names none."""
        return [_DEFAULT_METRIC[self.objective]]

    def resolved_grow_fused(self) -> bool:
        """'on' and 'auto' fuse on the seg layout (the Booster ignores the
        fused step on the ordered one, as the JAX package does)."""
        return self.grow_fused != "off"
