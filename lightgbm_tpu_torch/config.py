"""Parameter/config system with alias resolution (a copy of
``lightgbm_tpu/config.py``, which imports no JAX; the port keeps its own).

reference: include/LightGBM/config.h (struct Config, ~180 parameters) and
the codegen'd alias table in src/io/config_auto.cpp (generated by
helpers/parameter_generator.py).  Here the table is maintained directly as
data; ``Config.from_params`` resolves aliases, coerces types, and applies
``CheckParamConflict``-style fixups (config.cpp:246+).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from .utils.log import LightGBMError  # noqa: F401  (raised below)


# alias -> canonical name (reference: config_auto.cpp Config::alias_table)
_ALIASES = {
    "config_file": "config",
    "task_type": "task",
    "objective_type": "objective", "app": "objective", "application": "objective", "loss": "objective",
    "boosting_type": "boosting", "boost": "boosting",
    "train": "data", "train_data": "data", "train_data_file": "data", "data_filename": "data",
    "test": "valid", "valid_data": "valid", "valid_data_file": "valid", "test_data": "valid",
    "test_data_file": "valid", "valid_filenames": "valid",
    "num_iteration": "num_iterations", "n_iter": "num_iterations", "num_tree": "num_iterations",
    "num_trees": "num_iterations", "num_round": "num_iterations", "num_rounds": "num_iterations",
    "num_boost_round": "num_iterations", "n_estimators": "num_iterations",
    "shrinkage_rate": "learning_rate", "eta": "learning_rate",
    "num_leaf": "num_leaves", "max_leaves": "num_leaves", "max_leaf": "num_leaves",
    "tree": "tree_learner", "tree_type": "tree_learner", "tree_learner_type": "tree_learner",
    "num_thread": "num_threads", "nthread": "num_threads", "nthreads": "num_threads",
    "n_jobs": "num_threads",
    "device": "device_type",
    "random_seed": "seed", "random_state": "seed",
    "min_data_per_leaf": "min_data_in_leaf", "min_data": "min_data_in_leaf",
    "min_child_samples": "min_data_in_leaf",
    "min_sum_hessian_per_leaf": "min_sum_hessian_in_leaf", "min_sum_hessian": "min_sum_hessian_in_leaf",
    "min_hessian": "min_sum_hessian_in_leaf", "min_child_weight": "min_sum_hessian_in_leaf",
    "sub_row": "bagging_fraction", "subsample": "bagging_fraction", "bagging": "bagging_fraction",
    "pos_sub_row": "pos_bagging_fraction", "pos_subsample": "pos_bagging_fraction",
    "pos_bagging": "pos_bagging_fraction",
    "neg_sub_row": "neg_bagging_fraction", "neg_subsample": "neg_bagging_fraction",
    "neg_bagging": "neg_bagging_fraction",
    "subsample_freq": "bagging_freq",
    "bagging_fraction_seed": "bagging_seed",
    "sub_feature": "feature_fraction", "colsample_bytree": "feature_fraction",
    "sub_feature_bynode": "feature_fraction_bynode", "colsample_bynode": "feature_fraction_bynode",
    "early_stopping_rounds": "early_stopping_round", "early_stopping": "early_stopping_round",
    "n_iter_no_change": "early_stopping_round",
    "max_tree_output": "max_delta_step", "max_leaf_output": "max_delta_step",
    "reg_alpha": "lambda_l1", "l1_regularization": "lambda_l1",
    "reg_lambda": "lambda_l2", "lambda": "lambda_l2", "l2_regularization": "lambda_l2",
    "min_split_gain": "min_gain_to_split",
    "rate_drop": "drop_rate",
    "topk": "top_k",
    "mc": "monotone_constraints", "monotone_constraint": "monotone_constraints",
    "feature_contrib": "feature_contri", "fc": "feature_contri", "fp": "feature_contri",
    "fs": "forcedsplits_filename", "forced_splits_filename": "forcedsplits_filename",
    "forced_splits_file": "forcedsplits_filename", "forced_splits": "forcedsplits_filename",
    "verbose": "verbosity",
    "model_output": "output_model", "model_out": "output_model",
    "model_input": "input_model", "model_in": "input_model",
    "predict_result": "output_result", "prediction_result": "output_result",
    "predict_name": "output_result", "pred_name": "output_result", "name_pred": "output_result",
    "is_pre_partition": "pre_partition",
    "is_enable_bundle": "enable_bundle", "bundle": "enable_bundle",
    "is_enable_sparse": "is_sparse", "enable_sparse": "is_sparse", "sparse": "is_sparse",
    "two_round_loading": "two_round", "use_two_round_loading": "two_round",
    "is_save_binary": "save_binary", "is_save_binary_file": "save_binary",
    "has_header": "header",
    "label": "label_column",
    "weight": "weight_column",
    "group": "group_column", "group_id": "group_column", "query_column": "group_column",
    "query": "group_column", "query_id": "group_column",
    "ignore_feature": "ignore_column", "blacklist": "ignore_column",
    "categorical_feature": "categorical_column", "cat_feature": "categorical_column",
    "categorical_features": "categorical_column", "cat_column": "categorical_column",
    "is_sparse_feature": "is_sparse",
    "predict_raw_score": "predict_raw_score", "raw_score": "predict_raw_score",
    "is_predict_raw_score": "predict_raw_score",
    "leaf_index": "predict_leaf_index", "is_predict_leaf_index": "predict_leaf_index",
    "contrib": "predict_contrib", "is_predict_contrib": "predict_contrib",
    "convert_model_file": "convert_model",
    "num_classes": "num_class",
    "unbalance": "is_unbalance", "unbalanced_sets": "is_unbalance",
    "metric_types": "metric", "metrics": "metric",
    "output_freq": "metric_freq",
    "training_metric": "is_provide_training_metric", "is_training_metric": "is_provide_training_metric",
    "train_metric": "is_provide_training_metric",
    "ndcg_eval_at": "eval_at", "ndcg_at": "eval_at", "map_eval_at": "eval_at", "map_at": "eval_at",
    "num_machine": "num_machines",
    "local_port": "local_listen_port", "port": "local_listen_port",
    "machine_list_file": "machine_list_filename", "machine_list": "machine_list_filename",
    "mlist": "machine_list_filename",
    "workers": "machines", "nodes": "machines",
    "subsample_for_bin": "bin_construct_sample_cnt",
    "hist_pool_size": "histogram_pool_size",
    "data_seed": "data_random_seed",
    "feature_fraction_seed": "feature_fraction_seed",
    "extra_seed": "extra_trees_seed",
    "drop_seed": "drop_seed",
    "objective_seed": "objective_seed",
    "max_bins": "max_bin",
    "quantized_grad": "use_quantized_grad",
    "use_quantised_grad": "use_quantized_grad",
    "use_quantized_gradients": "use_quantized_grad",
    "grad_quant_bins": "num_grad_quant_bins",
    "num_gradient_quant_bins": "num_grad_quant_bins",
    "quantized_train_renew_leaf": "quant_train_renew_leaf",
    "use_stochastic_rounding": "stochastic_rounding",
}

# objective aliases (reference: config.cpp:68-98 ParseObjectiveAlias)
_OBJECTIVE_ALIASES = {
    "regression": "regression", "regression_l2": "regression", "l2": "regression",
    "mean_squared_error": "regression", "mse": "regression", "l2_root": "regression",
    "root_mean_squared_error": "regression", "rmse": "regression",
    "regression_l1": "regression_l1", "l1": "regression_l1",
    "mean_absolute_error": "regression_l1", "mae": "regression_l1",
    "multiclass": "multiclass", "softmax": "multiclass",
    "multiclassova": "multiclassova", "multiclass_ova": "multiclassova",
    "ova": "multiclassova", "ovr": "multiclassova",
    "xentropy": "cross_entropy", "cross_entropy": "cross_entropy",
    "xentlambda": "cross_entropy_lambda", "cross_entropy_lambda": "cross_entropy_lambda",
    "mean_absolute_percentage_error": "mape", "mape": "mape",
    "binary": "binary",
    "huber": "huber", "fair": "fair", "poisson": "poisson", "quantile": "quantile",
    "gamma": "gamma", "tweedie": "tweedie",
    "lambdarank": "lambdarank", "rank_xendcg": "rank_xendcg",
    "xendcg": "rank_xendcg", "xe_ndcg": "rank_xendcg", "xe_ndcg_mart": "rank_xendcg",
    "xendcg_mart": "rank_xendcg",
    "none": "none", "null": "none", "custom": "none", "na": "none",
}

_METRIC_ALIASES = {
    "l1": "l1", "mean_absolute_error": "l1", "mae": "l1", "regression_l1": "l1",
    "l2": "l2", "mean_squared_error": "l2", "mse": "l2", "regression_l2": "l2", "regression": "l2",
    "rmse": "rmse", "root_mean_squared_error": "rmse", "l2_root": "rmse",
    "quantile": "quantile", "huber": "huber", "fair": "fair", "poisson": "poisson",
    "mape": "mape", "mean_absolute_percentage_error": "mape",
    "gamma": "gamma", "gamma_deviance": "gamma_deviance", "tweedie": "tweedie",
    "ndcg": "ndcg", "lambdarank": "ndcg", "rank_xendcg": "ndcg", "xendcg": "ndcg",
    "map": "map", "mean_average_precision": "map",
    "auc": "auc", "auc_mu": "auc_mu",
    "binary_logloss": "binary_logloss", "binary": "binary_logloss",
    "binary_error": "binary_error",
    "multi_logloss": "multi_logloss", "multiclass": "multi_logloss",
    "softmax": "multi_logloss", "multiclassova": "multi_logloss", "ova": "multi_logloss",
    "multiclass_ova": "multi_logloss", "ovr": "multi_logloss",
    "multi_error": "multi_error",
    "cross_entropy": "cross_entropy", "xentropy": "cross_entropy",
    "cross_entropy_lambda": "cross_entropy_lambda", "xentlambda": "cross_entropy_lambda",
    "kullback_leibler": "kullback_leibler", "kldiv": "kullback_leibler",
    "none": "none", "na": "none", "null": "none", "custom": "none",
}


@dataclass
class Config:
    """Typed parameters.  Defaults mirror reference config.h."""

    # section: core
    task: str = "train"
    objective: str = "regression"
    boosting: str = "gbdt"
    data: str = ""
    valid: str = ""
    num_iterations: int = 100
    learning_rate: float = 0.1
    num_leaves: int = 31
    tree_learner: str = "serial"
    num_threads: int = 0
    device_type: str = "tpu"
    seed: int = 0
    # section: learning control
    max_depth: int = -1
    min_data_in_leaf: int = 20
    min_sum_hessian_in_leaf: float = 1e-3
    bagging_fraction: float = 1.0
    pos_bagging_fraction: float = 1.0
    neg_bagging_fraction: float = 1.0
    bagging_freq: int = 0
    bagging_seed: int = 3
    feature_fraction: float = 1.0
    feature_fraction_bynode: float = 1.0
    feature_fraction_seed: int = 2
    extra_trees: bool = False
    extra_trees_seed: int = 6
    early_stopping_round: int = 0
    first_metric_only: bool = False
    max_delta_step: float = 0.0
    lambda_l1: float = 0.0
    lambda_l2: float = 0.0
    min_gain_to_split: float = 0.0
    drop_rate: float = 0.1
    max_drop: int = 50
    skip_drop: float = 0.5
    xgboost_dart_mode: bool = False
    uniform_drop: bool = False
    drop_seed: int = 4
    top_rate: float = 0.2
    other_rate: float = 0.1
    min_data_per_group: int = 100
    max_cat_threshold: int = 32
    cat_l2: float = 10.0
    cat_smooth: float = 10.0
    max_cat_to_onehot: int = 4
    top_k: int = 20
    monotone_constraints: List[int] = field(default_factory=list)
    feature_contri: List[float] = field(default_factory=list)
    forcedsplits_filename: str = ""
    forcedbins_filename: str = ""
    refit_decay_rate: float = 0.9
    cegb_tradeoff: float = 1.0
    cegb_penalty_split: float = 0.0
    cegb_penalty_feature_lazy: List[float] = field(default_factory=list)
    cegb_penalty_feature_coupled: List[float] = field(default_factory=list)
    use_quantized_grad: bool = False    # quantized-gradient training:
                                        # int8 MXU histograms, int32
                                        # accumulation, shrunken psum
                                        # payloads (reference: LightGBM 4.x
                                        # gradient_discretizer lineage);
                                        # falls back to f32 (warn-once) for
                                        # DART/CEGB/monotone/extra_trees
    num_grad_quant_bins: int = 4        # signed integer levels grad/hess
                                        # discretize into (2..64; grad uses
                                        # [-bins/2+1, bins/2-1], hess
                                        # [0, bins-1])
    quant_train_renew_leaf: bool = False  # re-fit committed leaf outputs
                                        # from TRUE f32 gradient sums
                                        # (ops/renew.py quant_train_renew_
                                        # leaf seam)
    stochastic_rounding: bool = True    # unbiased floor(x + u) rounding of
                                        # the discretized gradients, seeded
                                        # from the per-round key streams
    # IO / dataset
    verbosity: int = 1
    max_bin: int = 255
    max_bin_by_feature: Optional[List[int]] = None  # per-feature bin budgets
    min_data_in_bin: int = 3
    bin_construct_sample_cnt: int = 200000
    histogram_pool_size: float = -1.0
    data_random_seed: int = 1
    output_model: str = "LightGBM_model.txt"
    snapshot_freq: int = -1
    input_model: str = ""
    output_result: str = "LightGBM_predict_result.txt"
    initscore_filename: str = ""
    valid_data_initscores: str = ""
    pre_partition: bool = False
    enable_bundle: bool = True
    is_sparse: bool = True
    force_col_wise: bool = False   # accepted for config-file compatibility
    force_row_wise: bool = False   # (reference config.h:232,246): the
                                   # col-vs-row choice is superseded here by
                                   # the timed kernel probe
                                   # (tpu_hist_method=auto); a warning is
                                   # logged when set
    use_missing: bool = True
    zero_as_missing: bool = False
    feature_pre_filter: bool = True
    two_round: bool = False
    save_binary: bool = False
    header: bool = False
    label_column: str = ""
    weight_column: str = ""
    group_column: str = ""
    ignore_column: str = ""
    categorical_column: str = ""
    predict_raw_score: bool = False
    predict_leaf_index: bool = False
    predict_contrib: bool = False
    predict_disable_shape_check: bool = False  # reference config.h:681
    num_iteration_predict: int = -1
    pred_early_stop: bool = False
    pred_early_stop_freq: int = 10
    pred_early_stop_margin: float = 10.0
    convert_model_language: str = ""
    convert_model: str = "gbdt_prediction.cpp"
    # section: objective
    num_class: int = 1
    is_unbalance: bool = False
    scale_pos_weight: float = 1.0
    sigmoid: float = 1.0
    boost_from_average: bool = True
    reg_sqrt: bool = False
    alpha: float = 0.9
    fair_c: float = 1.0
    poisson_max_delta_step: float = 0.7
    tweedie_variance_power: float = 1.5
    max_position: int = 20
    lambdarank_truncation_level: int = 20
    lambdarank_norm: bool = True
    label_gain: List[float] = field(default_factory=list)
    objective_seed: int = 5
    # section: metric
    metric: List[str] = field(default_factory=list)
    metric_freq: int = 1
    is_provide_training_metric: bool = False
    eval_at: List[int] = field(default_factory=lambda: [1, 2, 3, 4, 5])
    multi_error_top_k: int = 1
    # section: network
    num_machines: int = 1
    local_listen_port: int = 12400
    time_out: int = 120
    machine_list_filename: str = ""
    machines: str = ""
    # section: device
    gpu_platform_id: int = -1
    gpu_device_id: int = -1
    gpu_use_dp: bool = False
    # section: tpu-specific
    tpu_hist_method: str = "auto"       # auto|matmul|matmul_f32|scatter|
                                        # pallas|fused.  "fused" = the
                                        # Pallas histogram→split megakernel
                                        # (ops/fused.py: one HBM pass per
                                        # level, split scan in VMEM); auto
                                        # elects it on accelerators when
                                        # the planner's VMEM arena fits
                                        # and the context is the numeric
                                        # unsharded case, with the staged
                                        # family as the fallback arm
    tpu_compact_hist: bool = True       # bucketed leaf-row compaction
    tpu_round_width: int = 128          # rounds grower: max splits batched
                                        # per round (see grower_rounds.py)
    tpu_tree_growth: str = "auto"       # auto|serial|rounds|fast: one split
                                        # per while_loop step vs batched
                                        # frontier rounds (structurally
                                        # identical trees); "fast" skips the
                                        # best-first exactness fallback (see
                                        # grower_rounds.py)
    tpu_double_precision: bool = False  # use f64 accumulation paths on host
    tpu_donate_buffers: bool = True
    tpu_forced_split_parity: bool = False  # forced splits: reproduce the
                                        # reference GatherInfoForThreshold
                                        # stats convention (bin==threshold
                                        # goes right) for bit-identical
                                        # forced trees; default keeps the
                                        # self-consistent stats==partition
                                        # rule (see grower.py
                                        # forced_split_result)

    @staticmethod
    def canonical_key(key: str) -> str:
        key = key.strip()
        return _ALIASES.get(key, key)

    @staticmethod
    def from_params(params: Optional[dict], *, warn_unknown: bool = False) -> "Config":
        cfg = Config()
        cfg.update(params or {}, warn_unknown=warn_unknown)
        return cfg

    def update(self, params: dict, *, warn_unknown: bool = False) -> "Config":
        fields = {f.name: f for f in dataclasses.fields(self)}
        seen: Dict[str, str] = {}
        for raw_key, value in params.items():
            if value is None:
                # None marks "unset" (e.g. to_dataset_params entries merged
                # back into Dataset.params) — keep the field default
                continue
            key = Config.canonical_key(str(raw_key))
            if key not in fields:
                if warn_unknown:
                    import warnings
                    warnings.warn(f"Unknown parameter: {raw_key}")
                continue
            if key in seen:
                continue  # first alias wins (reference: KV2Map keeps first)
            seen[key] = str(raw_key)
            setattr(self, key, _coerce(value, fields[key].type, key))
        if "objective" in seen:
            self.objective = _OBJECTIVE_ALIASES.get(self.objective, self.objective)
        if "metric" in seen:
            resolved = [_METRIC_ALIASES.get(m, m) for m in self.metric]
            # dedup after alias resolution (the reference's C++ config
            # dedups metric types): metric="binary" + eval_metric=
            # "binary_logloss" must not evaluate the same metric twice
            self.metric = list(dict.fromkeys(resolved))
        self._check_conflicts()
        return self

    def _check_conflicts(self) -> None:
        """reference: Config::CheckParamConflict (src/io/config.cpp:246+)."""
        if self.is_unbalance and self.scale_pos_weight != 1.0:
            raise ValueError("is_unbalance and scale_pos_weight cannot both be set")
        if self.objective in ("multiclass", "multiclassova") and self.num_class <= 1:
            raise LightGBMError(
                "Number of classes should be specified and greater than 1 "
                f"for {self.objective} training")
        if self.objective not in ("multiclass", "multiclassova", "none") and self.num_class != 1:
            raise LightGBMError(
                "Number of classes must be 1 for non-multiclass training")
        if self.bagging_freq > 0 and not (0.0 < self.bagging_fraction <= 1.0):
            raise ValueError("bagging_fraction must be in (0, 1]")
        if self.use_quantized_grad and not (
                2 <= self.num_grad_quant_bins <= 64):
            # 64 levels keeps int8 per-row values AND an int32 per-bin
            # accumulator safe past 30M rows (ops/histogram.py quant notes)
            raise LightGBMError(
                "num_grad_quant_bins must be in [2, 64], got "
                f"{self.num_grad_quant_bins}")
        if self.force_col_wise and self.force_row_wise:
            # reference: CheckParamConflict fatals on both (config.cpp)
            raise LightGBMError(
                "force_col_wise and force_row_wise cannot both be true")
        if self.force_col_wise or self.force_row_wise:
            from .utils.log import log_warning
            log_warning(
                "force_col_wise/force_row_wise are accepted for config "
                "compatibility but superseded by the timed kernel probe "
                "(tpu_hist_method=auto) on this backend")

    def default_metric(self) -> List[str]:
        """Metric implied by the objective when none given (config.cpp)."""
        obj2metric = {
            "regression": "l2", "regression_l1": "l1", "huber": "huber", "fair": "fair",
            "poisson": "poisson", "quantile": "quantile", "mape": "mape",
            "gamma": "gamma", "tweedie": "tweedie",
            "binary": "binary_logloss",
            "multiclass": "multi_logloss", "multiclassova": "multi_logloss",
            "cross_entropy": "cross_entropy", "cross_entropy_lambda": "cross_entropy_lambda",
            "lambdarank": "ndcg", "rank_xendcg": "ndcg",
        }
        m = obj2metric.get(self.objective)
        return [m] if m else []

    def split_hyperparams(self):
        from .ops.split import SplitHyperparams
        return SplitHyperparams(
            lambda_l1=self.lambda_l1,
            lambda_l2=self.lambda_l2,
            min_gain_to_split=self.min_gain_to_split,
            min_data_in_leaf=self.min_data_in_leaf,
            min_sum_hessian_in_leaf=self.min_sum_hessian_in_leaf,
            max_delta_step=self.max_delta_step,
            max_cat_threshold=self.max_cat_threshold,
            cat_l2=self.cat_l2,
            cat_smooth=self.cat_smooth,
            max_cat_to_onehot=self.max_cat_to_onehot,
            min_data_per_group=self.min_data_per_group,
            extra_trees=self.extra_trees,
        )

    def to_dataset_params(self) -> dict:
        return {
            "max_bin": self.max_bin,
            "max_bin_by_feature": (tuple(self.max_bin_by_feature)
                                   if self.max_bin_by_feature else None),
            "pre_partition": self.pre_partition,
            "enable_bundle": self.enable_bundle,
            "is_sparse": self.is_sparse,
            "min_data_in_bin": self.min_data_in_bin,
            "min_data_in_leaf": self.min_data_in_leaf,
            "bin_construct_sample_cnt": self.bin_construct_sample_cnt,
            "data_random_seed": self.data_random_seed,
            "use_missing": self.use_missing,
            "zero_as_missing": self.zero_as_missing,
            "feature_pre_filter": self.feature_pre_filter,
            "forcedbins_filename": self.forcedbins_filename,
            "two_round": self.two_round,
            "header": self.header if self.header else None,
            "label_column": self.label_column or 0,
            "weight_column": self.weight_column or None,
            "group_column": self.group_column or None,
            "ignore_column": self.ignore_column or None,
            "categorical_feature": self.categorical_column or None,
        }


def _coerce(value: Any, ftype, key: str):
    s = str(ftype)
    if isinstance(value, (set, frozenset)):
        # the reference Python package accepts metric={...}; sets have no
        # order, so sort for a deterministic metric sequence
        value = sorted(value, key=str)
    if "List[int]" in s:
        if isinstance(value, (list, tuple)):
            return [int(v) for v in value]
        return [int(v) for v in str(value).split(",") if v != ""]
    if "List[float]" in s:
        if isinstance(value, (list, tuple)):
            return [float(v) for v in value]
        return [float(v) for v in str(value).split(",") if v != ""]
    if "List[str]" in s:
        if isinstance(value, (list, tuple)):
            return [str(v) for v in value]
        return [v for v in str(value).split(",") if v != ""]
    if ftype is bool or "bool" in s:
        if isinstance(value, bool):
            return value
        return str(value).lower() in ("true", "1", "yes", "+")
    if ftype is int or "int" in s:
        return int(float(value))
    if ftype is float or "float" in s:
        return float(value)
    return str(value)


def parse_config_file(path: str) -> dict:
    """Parse a reference-style ``key = value`` config file.

    reference: Application::LoadParameters (src/application/application.cpp:49),
    Config::Str2Map/KV2Map (include/LightGBM/config.h:81).
    """
    out: Dict[str, str] = {}
    with open(path) as fh:
        for line in fh:
            line = line.split("#", 1)[0].strip()
            if not line or "=" not in line:
                continue
            k, v = line.split("=", 1)
            out[k.strip()] = v.strip()
    return out
