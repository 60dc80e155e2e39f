"""scikit-learn estimators (counterpart of ``lightgbm_tpu/sklearn.py``).

reference: python-package/lightgbm/sklearn.py: LGBMModel (:169),
LGBMRegressor (:744), LGBMClassifier (:771), LGBMRanker (:913).  The
estimators train and predict with the port's ``train`` and
``Booster`` on ``device`` (a constructor parameter: None is the CUDA
card, ``"cpu"`` the host).  Import this module only where
scikit-learn is installed; without it the estimators still fit and
predict, on stand-in base classes, but ``score`` and the string
``class_weight`` modes need it.
"""

from __future__ import annotations

import copy
from typing import Callable, Dict, List, Optional, Union

import numpy as np

from .basic import Booster
from .compat import sklearn_bases
from .dataset import Dataset
from .engine import train as train_fn

(_LGBMModelBase, _LGBMClassifierBase, _LGBMRegressorBase,
 LGBMNotFittedError) = sklearn_bases()


def _ensure_1d_y(y):
    """Flatten y, warning on a column vector (sklearn protocol)."""
    y = np.asarray(y)
    if y.ndim == 2 and y.shape[1] == 1:
        import warnings
        try:
            from sklearn.exceptions import DataConversionWarning
        except ImportError:
            DataConversionWarning = UserWarning
        warnings.warn(
            "A column-vector y was passed when a 1d array was expected. "
            "Please change the shape of y to (n_samples, ), for example "
            "using ravel().", DataConversionWarning, stacklevel=2)
    return y.reshape(-1)


def _sample_weight_from_class_weight(class_weight, y):
    """Per-row weights from a class_weight spec.

    A dict may name only SOME classes; absent classes weigh 1.0 — the
    semantics the reference inherited from older scikit-learn (modern
    compute_sample_weight raises on a partial dict instead).
    """
    y = np.asarray(y).reshape(-1)
    if isinstance(class_weight, dict):
        u, inv = np.unique(y, return_inverse=True)
        per_class = np.array([float(class_weight.get(v, 1.0)) for v in u],
                             np.float64)
        return per_class[inv]
    from sklearn.utils.class_weight import compute_sample_weight
    return compute_sample_weight(class_weight, y)


class LGBMModel(_LGBMModelBase):
    """Base sklearn-style estimator (reference: sklearn.py:169).

    Inherits scikit-learn's BaseEstimator (the reference's _LGBMModelBase,
    compat.py) so meta-estimators (GridSearchCV, clone, modern
    __sklearn_tags__ introspection) treat it as a first-class estimator.
    """

    def __init__(self, boosting_type: str = "gbdt", num_leaves: int = 31,
                 max_depth: int = -1, learning_rate: float = 0.1,
                 n_estimators: int = 100, subsample_for_bin: int = 200000,
                 objective: Optional[str] = None, class_weight=None,
                 min_split_gain: float = 0.0, min_child_weight: float = 1e-3,
                 min_child_samples: int = 20, subsample: float = 1.0,
                 subsample_freq: int = 0, colsample_bytree: float = 1.0,
                 reg_alpha: float = 0.0, reg_lambda: float = 0.0,
                 random_state=None, n_jobs: int = -1, silent: bool = True,
                 importance_type: str = "split", device=None, **kwargs):
        self.boosting_type = boosting_type
        self.num_leaves = num_leaves
        self.max_depth = max_depth
        self.learning_rate = learning_rate
        self.n_estimators = n_estimators
        self.subsample_for_bin = subsample_for_bin
        self.objective = objective
        self.class_weight = class_weight
        self.min_split_gain = min_split_gain
        self.min_child_weight = min_child_weight
        self.min_child_samples = min_child_samples
        self.subsample = subsample
        self.subsample_freq = subsample_freq
        self.colsample_bytree = colsample_bytree
        self.reg_alpha = reg_alpha
        self.reg_lambda = reg_lambda
        self.random_state = random_state
        self.n_jobs = n_jobs
        self.silent = silent
        self.importance_type = importance_type
        self.device = device
        self._other_params = dict(kwargs)
        self._Booster: Optional[Booster] = None
        self._evals_result: Dict = {}
        self._best_iteration = -1
        self._best_score: Dict = {}
        self._n_features = -1
        self._classes = None
        self._n_classes = -1
        self.set_params(**kwargs)

    # -- sklearn plumbing ----------------------------------------------------

    def get_params(self, deep: bool = True) -> dict:
        params = {
            k: getattr(self, k) for k in (
                "boosting_type", "num_leaves", "max_depth", "learning_rate",
                "n_estimators", "subsample_for_bin", "objective", "class_weight",
                "min_split_gain", "min_child_weight", "min_child_samples",
                "subsample", "subsample_freq", "colsample_bytree", "reg_alpha",
                "reg_lambda", "random_state", "n_jobs", "silent",
                "importance_type", "device")
        }
        params.update(self._other_params)
        return params

    def set_params(self, **params) -> "LGBMModel":
        for key, value in params.items():
            if hasattr(self, key) and not key.startswith("_"):
                setattr(self, key, value)
            else:
                self._other_params[key] = value
        return self

    def _process_params(self, stage: str) -> dict:
        params = self.get_params()
        params.pop("silent", None)
        params.pop("importance_type", None)
        params.pop("device", None)
        params.pop("n_estimators", None)
        params.pop("class_weight", None)
        obj = getattr(self, "_objective_resolved", None) or self.objective
        if callable(obj):
            params["objective"] = "none"
        elif obj is None:
            params["objective"] = self._default_objective()
        else:
            params["objective"] = obj
        nc = getattr(self, "_num_class_fit", 0)
        if nc > 1:
            params.setdefault("num_class", nc)
        self._objective = (obj if callable(obj)
                           else params.get("objective", obj))
        if self.random_state is not None:
            params["seed"] = (self.random_state if isinstance(self.random_state, int)
                              else 0)
        params.pop("random_state", None)
        params.pop("n_jobs", None)
        alias = {
            "boosting_type": "boosting", "min_split_gain": "min_gain_to_split",
            "min_child_weight": "min_sum_hessian_in_leaf",
            "min_child_samples": "min_data_in_leaf", "subsample": "bagging_fraction",
            "subsample_freq": "bagging_freq", "colsample_bytree": "feature_fraction",
            "reg_alpha": "lambda_l1", "reg_lambda": "lambda_l2",
            "subsample_for_bin": "bin_construct_sample_cnt",
        }
        for old, new in alias.items():
            if old in params:
                params[new] = params.pop(old)
        if not params.get("verbosity") and self.silent:
            params["verbosity"] = -1
        return params

    def __sklearn_tags__(self):
        tags = super().__sklearn_tags__()
        tags.input_tags.sparse = True      # scipy CSR/CSC bin host-side
        tags.input_tags.allow_nan = True   # NaN is a first-class missing value
        return tags

    def __sklearn_is_fitted__(self) -> bool:
        # modern check_is_fitted protocol: our fitted state lives behind
        # properties, not trailing-underscore instance attributes
        return self._Booster is not None

    def _default_objective(self) -> str:
        return "regression"

    def _default_eval_metric(self) -> str:
        """Metric deduced from the estimator class when the objective is a
        custom callable (reference: sklearn.py fit's original_metric
        deduction) — keeps early stopping usable with custom objectives."""
        return "l2"

    # -- fitting -------------------------------------------------------------

    def fit(self, X, y, sample_weight=None, init_score=None, group=None,
            eval_set=None, eval_names=None, eval_sample_weight=None,
            eval_class_weight=None, eval_init_score=None, eval_group=None,
            eval_metric=None, early_stopping_rounds=None, verbose=False,
            feature_name="auto", categorical_feature="auto", callbacks=None,
            init_model=None) -> "LGBMModel":
        params = self._process_params("fit")
        # metric resolution (reference sklearn.py fit): start from the
        # params metric, or — when absent — the objective name as a metric
        # alias (the factory resolves "regression"->l2 etc.) or the class
        # default for callable objectives; then UNION with eval_metric
        # strings (eval_metric adds metrics, it does not replace).
        # A BARE-callable eval_metric skips this whole block (reference
        # sklearn.py:520-524: `if callable(eval_metric): feval = ...` with
        # the deduction in the else branch), so a custom objective + custom
        # metric trains with no built-in metric at all.
        em, feval_fns = [], []
        if eval_metric is not None:
            em_raw = ([eval_metric] if isinstance(eval_metric, str)
                      or callable(eval_metric) else list(eval_metric))
            em = [m for m in em_raw if not callable(m)]
            feval_fns = [m for m in em_raw if callable(m)]
        if not callable(eval_metric):
            pm = params.get("metric")
            if isinstance(pm, (set, frozenset)):
                pm = sorted(pm, key=str)    # deterministic (config._coerce)
            pm = [pm] if isinstance(pm, str) else list(pm or [])
            if not pm:
                if callable(self.objective):
                    pm = [self._default_eval_metric()]
                # else: engine derives the objective's default metric itself
            if em and not pm:
                pm = [str(params.get("objective", self._default_objective()))]
            # eval_metric strings PREPEND (reference order): first_metric_only
            # early stopping keys off the first metric, which must be the
            # caller's eval_metric when one is given
            merged = [m for m in em if m not in pm] + pm
            if merged:
                params["metric"] = merged
        if getattr(self, "_eval_at", None):
            params["eval_at"] = list(self._eval_at)

        X_orig, y_orig = X, y
        if not _is_pandas(X):
            X = _to_array(X)
        y = _ensure_1d_y(y)
        if getattr(X, "ndim", 2) == 1:
            raise ValueError(
                "Expected 2D array, got 1D array instead. Reshape your "
                "data either using array.reshape(-1, 1) if your data has "
                "a single feature or array.reshape(1, -1) if it contains "
                "a single sample.")
        if X.shape[0] == 0:
            raise ValueError(
                f"Found array with 0 sample(s) (shape={X.shape}) while a "
                "minimum of 1 is required.")
        if X.ndim == 2 and X.shape[1] == 0:
            raise ValueError(
                f"Found array with 0 feature(s) (shape={X.shape}) while a "
                "minimum of 1 is required.")
        self._n_features = X.shape[1]
        y_t = self._transform_label(y)
        if self.class_weight is not None and sample_weight is None:
            # computed on ORIGINAL labels so dict keys match caller values
            sample_weight = self._class_weights(y)
        if isinstance(init_model, LGBMModel):
            init_model = init_model.booster_

        train_set = Dataset(X, label=y_t, weight=sample_weight, group=group,
                            init_score=init_score,
                            feature_name=feature_name,
                            categorical_feature=categorical_feature,
                            params=params, free_raw_data=init_model is None,
                            device=self.device)
        valid_sets = []
        if eval_set is not None:
            if isinstance(eval_set, tuple):
                eval_set = [eval_set]
            for i, (vx, vy) in enumerate(eval_set):
                vw = eval_sample_weight[i] if eval_sample_weight else None
                vg = eval_group[i] if eval_group else None
                vi = eval_init_score[i] if eval_init_score else None
                vcw = eval_class_weight[i] if eval_class_weight else None
                if vcw is not None and vw is None:
                    # weights computed on ORIGINAL labels so dict keys
                    # ({'5': 30} / {5: 30}) match the caller's y values
                    vw = _sample_weight_from_class_weight(
                        vcw, np.asarray(vy).reshape(-1))
                vxa = vx if _is_pandas(vx) else _to_array(vx)
                same = (vx is X_orig and vy is y_orig
                        and vw is None and vg is None and vi is None)
                if not same and not _is_pandas(vx) and not _is_pandas(X):
                    try:
                        same = (vxa.shape == X.shape
                                and len(vy) == len(y)
                                and vw is None and vg is None and vi is None
                                and vcw is None
                                and np.allclose(vxa[:5], X[:5],
                                                equal_nan=True))
                    except (TypeError, ValueError):
                        same = False
                if same:
                    valid_sets.append(train_set)
                    continue
                valid_sets.append(Dataset(vxa,
                                          label=self._transform_label(np.asarray(vy).reshape(-1)),
                                          weight=vw, group=vg, init_score=vi,
                                          reference=train_set, params=params,
                                          device=self.device))

        feval = None
        if feval_fns:
            wrapped = [_wrap_eval_metric(f, self) for f in feval_fns]
            if len(wrapped) == 1:
                feval = wrapped[0]
            else:
                def feval(score, dataset):
                    out = []
                    for f in wrapped:
                        r = f(score, dataset)
                        out.extend(r if isinstance(r, list) else [r])
                    return out
        fobj = _wrap_objective(self.objective) if callable(self.objective) else None

        self._evals_result = {}
        self._Booster = train_fn(
            params, train_set, num_boost_round=self.n_estimators,
            valid_sets=valid_sets or None, valid_names=eval_names,
            fobj=fobj, feval=feval,
            early_stopping_rounds=early_stopping_rounds,
            evals_result=self._evals_result, verbose_eval=verbose,
            callbacks=callbacks, init_model=init_model)
        self._best_iteration = self._Booster.best_iteration
        self._best_score = self._Booster.best_score
        return self

    def _transform_label(self, y):
        return y.astype(np.float64)

    def _class_weights(self, y):
        return _sample_weight_from_class_weight(self.class_weight, y)

    def predict(self, X, raw_score: bool = False, num_iteration=None,
                pred_leaf: bool = False, pred_contrib: bool = False, **kwargs):
        if self._Booster is None:
            raise LGBMNotFittedError("Estimator not fitted; call fit first")
        if not _is_pandas(X):
            X = _to_array(X)
        if getattr(X, "ndim", 2) == 1:
            raise ValueError(
                "Expected 2D array, got 1D array instead. Reshape your "
                "data either using array.reshape(-1, 1) if your data has "
                "a single feature or array.reshape(1, -1) if it contains "
                "a single sample.")
        if (X.shape[1] != self._n_features
                and not kwargs.get("predict_disable_shape_check")):
            raise ValueError(
                f"X has {X.shape[1]} features, but "
                f"{type(self).__name__} is expecting "
                f"{self._n_features} features as input")
        # kwargs ride through to Booster.predict (pred_early_stop,
        # pred_early_stop_freq/margin, predict_disable_shape_check, ...)
        return self._Booster.predict(X, raw_score=raw_score,
                                     num_iteration=num_iteration,
                                     pred_leaf=pred_leaf,
                                     pred_contrib=pred_contrib, **kwargs)

    # -- attributes ----------------------------------------------------------

    @property
    def booster_(self) -> Booster:
        if self._Booster is None:
            raise LGBMNotFittedError("No booster found; call fit first")
        return self._Booster

    @property
    def objective_(self):
        """The concrete objective used while fitting (reference:
        sklearn.py:703)."""
        if self._Booster is None:
            raise LGBMNotFittedError("No objective found; call fit first")
        return self._objective

    @property
    def best_iteration_(self):
        return self._best_iteration

    @property
    def best_score_(self):
        return self._best_score

    @property
    def evals_result_(self):
        # reference semantics: None when no eval set produced results
        # (e.g. metric="None"), not an empty dict
        return self._evals_result or None

    @property
    def n_features_(self):
        return self._n_features

    @property
    def n_features_in_(self):
        if self._Booster is None:
            # NotFittedError subclasses AttributeError, so hasattr() is
            # False before fit — the modern sklearn check_n_features_in
            # contract
            raise LGBMNotFittedError(
                "No fit performed; call fit before n_features_in_")
        return self._n_features

    @property
    def feature_importances_(self):
        return self.booster_.feature_importance(self.importance_type)

    @property
    def feature_name_(self):
        return self.booster_.feature_name()


class LGBMRegressor(_LGBMRegressorBase, LGBMModel):
    """reference: sklearn.py:744."""

    def _default_objective(self):
        return "regression"

    def score(self, X, y, sample_weight=None):
        from sklearn.metrics import r2_score
        return r2_score(y, self.predict(X), sample_weight=sample_weight)


class LGBMClassifier(_LGBMClassifierBase, LGBMModel):
    """reference: sklearn.py:771."""

    def _default_objective(self):
        return "binary" if (self._n_classes is not None and self._n_classes <= 2) \
            else "multiclass"

    def _default_eval_metric(self):
        return ("multi_logloss"
                if (self._n_classes or 0) > 2 else "binary_logloss")

    def score(self, X, y, sample_weight=None):
        from sklearn.metrics import accuracy_score
        return accuracy_score(y, self.predict(X), sample_weight=sample_weight)

    def fit(self, X, y, **kwargs):
        if y is None:
            raise ValueError(
                "This estimator requires y to be passed, but the target "
                "y is None")
        y = _ensure_1d_y(y)
        try:
            from sklearn.utils.multiclass import check_classification_targets
            check_classification_targets(y)
        except ImportError:
            pass
        self._classes = np.unique(y)
        self._n_classes = len(self._classes)
        # resolve the fit-time objective WITHOUT mutating self.objective
        # (clone/get_params must keep reconstructing the constructor args):
        # >2 classes forces a multiclass objective — any non-ova string,
        # including an unknown one, becomes "multiclass" (reference
        # sklearn.py:794-797 "Switch to using a multiclass objective")
        params_obj = self.objective
        ova_aliases = {"multiclassova", "multiclass_ova", "ova", "ovr"}
        if callable(params_obj):
            resolved = params_obj
        elif self._n_classes > 2:
            resolved = (params_obj if params_obj in ova_aliases
                        else "multiclass")
        else:
            resolved = params_obj if params_obj is not None else "binary"
        self._objective_resolved = resolved
        self._num_class_fit = (self._n_classes if self._n_classes > 2
                               and "num_class" not in self._other_params
                               else 0)
        # an eval_metric of the wrong arity is swapped for its alternative
        # (reference sklearn.py:797-805) so binary_error on a 3-class fit
        # means multi_error instead of a config conflict
        if self._n_classes > 2:
            remap = {"logloss": "multi_logloss", "binary_logloss":
                     "multi_logloss", "error": "multi_error",
                     "binary_error": "multi_error"}
        else:
            remap = {"logloss": "binary_logloss", "multi_logloss":
                     "binary_logloss", "error": "binary_error",
                     "multi_error": "binary_error"}
        em = kwargs.get("eval_metric")
        if isinstance(em, str):
            kwargs["eval_metric"] = remap.get(em, em)
        elif isinstance(em, (list, tuple)):
            kwargs["eval_metric"] = [
                remap.get(m, m) if isinstance(m, str) else m for m in em]
        super().fit(X, y, **kwargs)
        return self

    def _transform_label(self, y):
        """Encode with the TRAIN-time class mapping (self._classes, set in
        fit): an independent np.unique would silently misencode eval sets
        missing one of the train classes (reference uses one fitted
        LabelEncoder for train and eval labels alike)."""
        y = np.asarray(y).reshape(-1)
        if self._classes is None:
            _, y_enc = np.unique(y, return_inverse=True)
            return y_enc.astype(np.float64)
        idx = np.searchsorted(self._classes, y)
        idx_c = np.minimum(idx, len(self._classes) - 1)
        if not np.array_equal(self._classes[idx_c], y):
            raise ValueError("eval set contains labels unseen in training")
        return idx_c.astype(np.float64)

    def predict(self, X, raw_score=False, num_iteration=None,
                pred_leaf=False, pred_contrib=False, **kwargs):
        result = self.predict_proba(X, raw_score, num_iteration, pred_leaf,
                                    pred_contrib, **kwargs)
        if (callable(getattr(self, "_objective", self.objective))
                or raw_score or pred_leaf or pred_contrib):
            # custom objective: outputs are raw scores, not probabilities —
            # thresholding them would mislabel (reference sklearn.py
            # predict returns the raw result for callable objectives)
            return result
        if result.ndim == 1:  # binary probabilities
            idx = (result > 0.5).astype(int)
        else:
            idx = np.argmax(result, axis=1)
        return self._classes[idx]

    def predict_proba(self, X, raw_score=False, num_iteration=None,
                      pred_leaf=False, pred_contrib=False, **kwargs):
        res = super().predict(X, raw_score, num_iteration, pred_leaf,
                              pred_contrib, **kwargs)
        if callable(getattr(self, "_objective", self.objective)) \
                and not (raw_score or pred_leaf or pred_contrib):
            # reference sklearn.py predict_proba: a custom objective means
            # the model's outputs are untransformable raw scores
            import warnings
            warnings.warn("Cannot compute class probabilities or labels "
                          "due to the usage of customized objective "
                          "function.\nReturning raw scores instead.")
            return res
        if raw_score or pred_leaf or pred_contrib:
            return res
        if res.ndim == 1:
            return np.vstack([1.0 - res, res]).T
        return res

    @property
    def classes_(self):
        return self._classes

    @property
    def n_classes_(self):
        return self._n_classes


class LGBMRanker(LGBMModel):
    """reference: sklearn.py:913."""

    def _default_objective(self):
        return "lambdarank"

    def _default_eval_metric(self):
        return "ndcg"

    def fit(self, X, y, group=None, eval_set=None, eval_group=None,
            eval_at=None, **kwargs):
        if group is None:
            raise ValueError("Should set group for ranking task")
        if eval_set is not None:
            if eval_group is None:
                raise ValueError(
                    "Eval_group cannot be None when eval_set is not None")
            n_eval = 1 if isinstance(eval_set, tuple) else len(eval_set)
            if len(eval_group) != n_eval:
                raise ValueError(
                    "Length of eval_group should be equal to eval_set")
            if any(g is None for g in eval_group):
                raise ValueError(
                    "Should set group for all eval datasets for ranking "
                    "task; if you use dict, the index should start from 0")
        # a constructor/params eval_at wins unless fit() overrides it
        # (reference _choose_param_value semantics); the engine's config
        # default (1,2,3,4,5) applies when neither is given
        self._eval_at = eval_at
        return super().fit(X, y, group=group, eval_set=eval_set,
                           eval_group=eval_group, **kwargs)


def _is_pandas(X) -> bool:
    return hasattr(X, "dtypes") and hasattr(X, "columns")


def _to_array(X):
    if hasattr(X, "toarray"):          # scipy sparse (any format) FIRST:
        X = X.toarray()                # dok has a dict-style .values METHOD
    elif hasattr(X, "values") and not callable(X.values):
        X = X.values                   # pandas
    elif hasattr(X, "values"):
        X = X.values()
    X = np.asarray(X)
    if np.iscomplexobj(X):
        raise ValueError("Complex data not supported")
    return np.ascontiguousarray(X, dtype=np.float64)


def _wrap_objective(func: Callable):
    def fobj(score, dataset):
        ret = func(dataset.get_label(), score)
        if len(ret) == 2:
            return ret
        raise ValueError("custom objective must return (grad, hess)")
    return fobj


def _wrap_eval_metric(func: Callable, model):
    def feval(score, dataset):
        return func(dataset.get_label(), score)
    return feval
