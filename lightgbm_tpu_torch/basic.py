"""Booster: the user-facing model handle (counterpart of
``lightgbm_tpu/basic.py``).

reference: python-package/lightgbm/basic.py:1704 (class Booster).  A
Booster either trains (``train_set=``, through ``boosting.GBDT``) or
holds a loaded model (``model_file=``/``model_str=``); both predict and
serve through the same path.  The Booster owns one torch device: a
training Booster takes its Dataset's; a loaded one takes ``device``,
where ``None`` means the CUDA card, and a host without one raises
instead of quietly running on the CPU; the CPU is used only when the
caller asks for it (``device="cpu"``).
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

import numpy as np
import torch

from .binning import BinType
from .model_text import load_model_from_string, save_model_to_string
from .tree import HostTree
from .utils.log import LightGBMError


def resolve_device(device=None) -> torch.device:
    """``None`` -> the current CUDA device; a CUDA device on a host
    without CUDA raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "lightgbm_tpu_torch runs on a CUDA device by default and "
            "torch.cuda.is_available() is False; pass device='cpu' to run "
            "on the CPU")
    return dev


def device_from_params(params: dict, device=None) -> torch.device:
    """The device of a C API handle or a CLI task: ``device`` where
    given; else the parameters' ``device_type`` (alias ``device``):
    ``cpu`` asks for the CPU; unset (or empty), ``tpu``, ``gpu`` or
    ``cuda`` mean the CUDA card (which must exist); any other value
    raises."""
    if device is not None:
        return resolve_device(device)
    from .config import Config
    val = None
    for k, v in (params or {}).items():
        if Config.canonical_key(k) == "device_type":
            val = v
    val = "" if val is None else str(val).strip().lower()
    if val == "cpu":
        return torch.device("cpu")
    if val in ("", "tpu", "gpu", "cuda"):
        return resolve_device(None)
    raise ValueError(f"device_type={val!r}: lightgbm_tpu_torch runs on "
                     "'cpu' or the CUDA card ('cuda', 'gpu' or 'tpu')")


class Booster:
    def __init__(self, params: Optional[dict] = None, train_set=None,
                 model_file: Optional[str] = None,
                 model_str: Optional[str] = None, *, device=None):
        from .config import Config
        self.params = dict(params or {})
        self.config = Config.from_params(self.params)
        self.best_iteration = -1
        self.best_score: Dict = {}
        self.boosting = None
        self.train_set = None
        self.objective = None
        self._loaded: Optional[dict] = None
        self._attr: Dict[str, str] = {}
        self._train_data_name = "training"
        if train_set is not None:
            self.device = train_set.device
            if device is not None and resolve_device(device) != self.device:
                raise ValueError(f"the Dataset lives on {self.device}, not "
                                 f"{device}")
            self._init_train(train_set)
            return
        self.device = resolve_device(device)
        if model_file is not None:
            from .utils.file_io import open_file
            with open_file(model_file) as fh:
                model_str = fh.read()
        if model_str is None:
            raise ValueError("need train_set, model_file or model_str")
        self._init_from_string(model_str)

    def _init_from_string(self, s: str) -> None:
        self._loaded = load_model_from_string(s)
        self.objective = None
        self.pandas_categorical = self._loaded.get("pandas_categorical")

    def model_from_string(self, model_str: str) -> "Booster":
        """Reset this Booster to the model in ``model_str`` (reference:
        Booster.model_from_string, basic.py:2438)."""
        self.boosting = None
        self.train_set = None
        self._init_from_string(model_str)
        return self

    # -------------------------------------------------------------- training

    def _check_dataset_param_changes(self, train_set, ds_params: dict,
                                     can_rebuild: bool) -> None:
        """Dataset parameters cannot change once the Dataset is binned,
        unless its raw data is kept to bin it again; ``min_data_in_leaf``
        may grow, or shrink when ``feature_pre_filter`` was off.
        reference: LGBM_DatasetUpdateParamChecking; the JAX package's
        basic.py:62, for a constructed Dataset and a binary cache."""
        from .config import Config
        old = Config.from_params(train_set.params).to_dataset_params()
        explicit = {Config.canonical_key(k) for k in self.params}
        ck = {"categorical_feature": "categorical_column"}
        diff = {k for k, v in ds_params.items()
                if ck.get(k, k) in explicit and old.get(k) != v}
        if not diff:
            return
        if can_rebuild and train_set.raw_data is not None:
            train_set.params.update({k: ds_params[k] for k in diff})
            train_set.constructed = False
            train_set.binned_t = None
            # a spill store holds the OLD binning: dropped, so the next
            # streaming election spills again
            store = getattr(train_set, "_block_store", None)
            if store is not None:
                if getattr(train_set, "_block_store_owned", False):
                    store.cleanup()
                train_set._block_store = None
            return
        for k in sorted(diff):
            if k == "min_data_in_leaf":
                nv, ov = ds_params[k], old.get(k, 0)
                if nv > ov or not old.get("feature_pre_filter", True):
                    train_set.params[k] = nv
                    continue
                raise LightGBMError(
                    "Reducing `min_data_in_leaf` with "
                    "`feature_pre_filter=true` may cause unexpected "
                    "behaviour for features that were pre-filtered by the "
                    "larger `min_data_in_leaf`.")
            disp = {"is_sparse": "is_enable_sparse",
                    "forcedbins_filename": "forced bins"}.get(k, k)
            raise LightGBMError(
                f"Cannot change {disp} after constructed Dataset handle.")

    def _init_train(self, train_set) -> None:
        from .boosting import create_boosting
        from .boosting.gbdt import check_supported
        from .objectives import create_objective
        check_supported(self.config)
        ds_params = self.config.to_dataset_params()
        if train_set.constructed:
            self._check_dataset_param_changes(train_set, ds_params, True)
        merged = dict(ds_params)
        merged.update(train_set.params)
        train_set.params = merged
        was_constructed = train_set.constructed
        train_set.construct()
        if not was_constructed and getattr(train_set, "_from_binary_cache",
                                           False):
            # the cache's own parameters replaced the Dataset's: a caller's
            # parameter that contradicts them cannot be honoured
            self._check_dataset_param_changes(train_set, ds_params, False)
        self.train_set = train_set
        self.pandas_categorical = train_set.pandas_categorical
        self.objective = create_objective(self.config)
        self.boosting = create_boosting(self.config, train_set,
                                        self.objective)
        self._resolve_metrics()

    def _resolve_metrics(self) -> None:
        """(Re)build the train and valid metrics from the config."""
        names = self.config.metric or self.config.default_metric()
        self._metric_names = [m for m in names if m.lower()
                              not in ("none", "na", "null", "custom")]
        self._check_metrics()
        self.boosting.set_metrics(
            self._build_metrics(self.train_set.metadata,
                                self.train_set.num_data),
            [self._build_metrics(ds.metadata, ds.num_data)
             for ds in self.boosting.valid_sets])

    def _check_metrics(self) -> None:
        """The metric/objective conflicts the JAX package refuses
        (reference: its basic.py:147-170, after Config's own checks)."""
        from .config import _METRIC_ALIASES
        c = self.config
        multi = (c.objective in ("multiclass", "multiclassova")
                 or (c.objective == "none" and c.num_class > 1))
        for m in self._metric_names:
            canon = _METRIC_ALIASES.get(m, m)
            if (canon in ("multi_logloss", "multi_error", "auc_mu")
                    and c.num_class <= 1):
                raise LightGBMError(
                    "Number of classes should be specified and greater "
                    "than 1 for multiclass training")
            if canon in ("binary_logloss", "binary_error") and multi:
                raise LightGBMError(
                    "Multiclass objective and metrics don't match")

    def _build_metrics(self, metadata, num_data):
        from .metrics import create_metric
        ms = []
        for name in self._metric_names:
            m = create_metric(name, self.config)
            if m is not None:
                m.init(metadata, num_data)
                ms.append(m)
        return ms

    def add_valid(self, data, name: str) -> "Booster":
        if data.reference is None:
            data.reference = self.train_set
        data.construct()
        self.boosting.add_valid(data, name)
        self.boosting.valid_metrics.append(
            self._build_metrics(data.metadata, data.num_data))
        return self

    def update(self, train_set=None, fobj=None) -> bool:
        """One boosting iteration; True when training stopped (no more
        splits).  ``fobj(score, train_set) -> (grad, hess)``: a custom
        objective, given the f32 train scores ([n], or [K, n] for K
        trees an iteration).  A ``train_set`` other than the booster's
        own becomes the training data first (``reset_training_data``).
        reference: basic.py:2089 Booster.update."""
        if train_set is not None and train_set is not self.train_set:
            self.reset_training_data(train_set)
        if fobj is not None:
            score = self.boosting.train_score.cpu().numpy()
            if self.boosting.num_tree_per_iteration == 1:
                score = score[0]
            grad, hess = fobj(score, self.train_set)
            return self.boosting.train_one_iter(np.asarray(grad),
                                                np.asarray(hess))
        return self.boosting.train_one_iter()

    def update_chunk(self, chunk: int, learning_rates=None) -> bool:
        """Train ``chunk`` iterations with no host read between them
        beyond each tree's fixed-point scales and its lagged stop flag
        (``boosting/macro.py``); the same model as ``chunk`` calls of
        ``update()`` where ``boosting.chunk_supported()``, which it
        requires.  ``learning_rates``: one learning rate an iteration.
        True when training stopped (no more splits).  reference: the JAX
        package's basic.py:206."""
        return self.boosting.train_chunk(chunk, learning_rates)

    def rollback_one_iter(self) -> "Booster":
        """Drop the last iteration's trees and take them out of the
        train and valid scores (reference: basic.py:2420)."""
        self.boosting.rollback_one_iter()
        return self

    def reset_training_data(self, train_set) -> "Booster":
        """Train on ``train_set`` from now on: it is binned with this
        booster's bin mappers (its ``reference`` becomes the current train
        set where it has none); its scores start from every tree so far.
        The init model's trees of a continued training are predicted from
        its raw rows (``free_raw_data=False``).  reference:
        LGBM_BoosterResetTrainingData."""
        if train_set.reference is None and not train_set.constructed:
            train_set.reference = self.train_set
        if train_set.device != self.device:
            raise ValueError(f"the new train set lives on {train_set.device}"
                             f", the booster on {self.device}")
        raw = train_set.raw_data
        train_set.params = dict(self.train_set.params, **train_set.params)
        train_set.construct()
        b = self.boosting
        scores = None
        if b.num_init_iteration:
            if raw is None:
                raise ValueError("resetting the training data of a "
                                 "continued training needs "
                                 "free_raw_data=False on the new Dataset")
            scores = self._init_model_scores(
                raw, b.num_init_iteration, b.num_tree_per_iteration)
        b.reset_training_data(train_set, scores)
        self.train_set = train_set
        self._resolve_metrics()
        return self

    def _init_model_scores(self, raw, iterations: int, K: int) -> np.ndarray:
        """[K, n] raw scores of the first ``iterations`` iterations."""
        pred = self.predict(raw, raw_score=True, num_iteration=iterations)
        return np.asarray(pred, np.float64).reshape(-1, K).T

    def reset_parameter(self, params: dict) -> "Booster":
        """Change parameters between iterations.  A learning rate alone
        (a schedule's step) sets the shrinkage; any other parameter also
        rebuilds the grower (and the metrics, where they changed).  A
        rejected reset leaves the booster as it was.  reference:
        basic.py:306 (the JAX package)."""
        import copy
        from .config import Config
        if all(Config.canonical_key(k) == "learning_rate" for k in params):
            self.params.update(params)
            self.config.update(params)
            if self.boosting is not None:
                self.boosting.shrinkage_rate = self.config.learning_rate
            return self
        old_params = dict(self.params)
        old_cfg = copy.deepcopy(self.config.__dict__)
        old_metrics = list(getattr(self, "_metric_names", []))
        try:
            self.params.update(params)
            self.config.update(params)
            if self.boosting is not None:
                self.boosting.shrinkage_rate = self.config.learning_rate
                self.boosting.reset_config()
                if any(Config.canonical_key(k) in
                       ("metric", "eval_at", "multi_error_top_k")
                       for k in params):
                    self._resolve_metrics()
        except Exception:
            self.params = old_params
            self.config.__dict__.clear()
            self.config.__dict__.update(old_cfg)
            self._metric_names = old_metrics
            if self.boosting is not None:
                self.boosting.shrinkage_rate = self.config.learning_rate
                self.boosting.reset_config()
            raise
        return self

    def refit(self, data, label, decay_rate: float = 0.9,
              **kwargs) -> "Booster":
        """A new Booster whose trees keep this one's structure with leaf
        values refit to ``data``: each row's leaves come from the
        traversal kernel's leaves mode (``predict(pred_leaf=True)``, on
        this Booster's device), then ``GBDT.refit_leaf_values``.
        reference: basic.py:2521 Booster.refit -> GBDT::RefitTree."""
        import copy
        from .dataset import Dataset
        leaf_pred = self.predict(data, pred_leaf=True)
        if self.boosting is not None:
            params = dict(self.params)
        else:
            params = {"objective": (self._loaded["objective_name"]
                                    or "regression").split(" ")[0],
                      "num_class": self._loaded["num_class"]}
        params.update(kwargs)
        params["refit_decay_rate"] = decay_rate
        new = Booster(params=params, train_set=Dataset(
            data, label=label, device=self.device))
        b = new.boosting
        b.models = [copy.deepcopy(m) for m in self.models]
        b.iter = len(b.models) // max(b.num_tree_per_iteration, 1)
        b.num_init_iteration = b.iter
        b.refit_leaf_values(leaf_pred, decay_rate)
        return new

    def current_iteration(self) -> int:
        if self.boosting is not None:
            return self.boosting.current_iteration()
        return len(self.models) // self.num_tree_per_iteration

    def eval_train(self, feval=None):
        name = self._train_data_name
        out = [(name, n, v, h) for (_, n, v, h) in self.boosting.eval_train()]
        return out + self._custom_eval(feval, name,
                                       self.boosting.train_score,
                                       self.train_set)

    def eval_valid(self, feval=None):
        out = list(self.boosting.eval_valid())
        if feval is not None:
            for i, name in enumerate(self.boosting.valid_names):
                out += self._custom_eval(feval, name,
                                         self.boosting.valid_scores[i],
                                         self.boosting.valid_sets[i])
        return out

    def _custom_eval(self, feval, name, score, dataset):
        """``feval(score, dataset)`` -> (name, value, higher_better) or a
        list of them, on the f64 scores ([n] or [K, n])."""
        if feval is None:
            return []
        s = score.cpu().numpy().astype(np.float64)
        if self.boosting.num_tree_per_iteration == 1:
            s = s[0]
        ret = feval(s, dataset)
        if isinstance(ret, tuple):
            ret = [ret]
        return [(name, mn, mv, hib) for (mn, mv, hib) in ret]

    def eval(self, data, name: str, feval=None):
        """Evaluate on ``data``, the training set or an added valid set;
        the results carry ``name`` (reference: Booster.eval,
        basic.py:2274)."""
        if data is self.train_set:
            out = [(name, n, v, h)
                   for (_, n, v, h) in self.boosting.eval_train()]
            return out + self._custom_eval(feval, name,
                                           self.boosting.train_score,
                                           self.train_set)
        b = self.boosting
        for i, vs in enumerate(b.valid_sets):
            if vs is data:
                out = [(name, mn, mv, h) for (_, mn, mv, h) in b._eval(
                    name, b.valid_scores[i], b.valid_metrics[i])]
                return out + self._custom_eval(feval, name,
                                               b.valid_scores[i], vs)
        raise ValueError("Data should be either valid data or training data")

    def set_train_data_name(self, name: str) -> "Booster":
        self._train_data_name = name
        return self

    def attr(self, key: str):
        """A string attribute (reference: Booster.attr, basic.py:2914)."""
        return self._attr.get(key)

    def set_attr(self, **kwargs) -> "Booster":
        for key, value in kwargs.items():
            if value is None:
                self._attr.pop(key, None)
            elif isinstance(value, str):
                self._attr[key] = value
            else:
                raise ValueError("Only string values are accepted")
        return self

    def num_data(self) -> int:
        return self.train_set.num_data if self.train_set is not None else 0

    def free_dataset(self) -> "Booster":
        return self

    def set_network(self, machines, local_listen_port: int = 12400,
                    listen_time_out: int = 120,
                    num_machines: int = 1) -> "Booster":
        """Start ``torch.distributed``'s default group from a
        reference-style machine list (reference: Booster.set_network,
        basic.py:1867 -> LGBM_NetworkInit; ``parallel.network.
        init_network``)."""
        from .parallel.network import init_network
        init_network(machines=machines, local_listen_port=local_listen_port,
                     listen_time_out=listen_time_out,
                     num_machines=num_machines)
        return self

    def free_network(self) -> "Booster":
        """reference: Booster.free_network -> LGBM_NetworkFree."""
        from .parallel.network import free_network
        free_network()
        return self

    def __copy__(self):
        return self.__deepcopy__(None)

    def __deepcopy__(self, _memo):
        """A model-text round trip on the same device (reference:
        Booster.__deepcopy__)."""
        return Booster(model_str=self.model_to_string(num_iteration=0),
                       device=self.device)

    def __getstate__(self):
        """The model text and the light host state; the training state
        (device tensors) does not travel."""
        return {"params": self.params, "best_iteration": self.best_iteration,
                "best_score": self.best_score, "_attr": self._attr,
                "_train_data_name": self._train_data_name,
                "device": str(self.device),
                "model_str": self.model_to_string(num_iteration=0)}

    def __setstate__(self, state):
        from .config import Config
        model_str = state.pop("model_str")
        device = state.pop("device")
        self.__dict__.update(state)
        self.config = Config.from_params(dict(self.params))
        self.device = resolve_device(device)
        self.boosting = None
        self.train_set = None
        self._init_from_string(model_str)

    # ------------------------------------------------------------- structure

    def get_leaf_output(self, tree_id: int, leaf_id: int) -> float:
        """reference: LGBM_BoosterGetLeafValue."""
        return float(self.models[tree_id].leaf_value[leaf_id])

    def upper_bound(self) -> float:
        """The sum over trees of each tree's largest leaf value
        (reference: GBDT::GetUpperBoundValue, gbdt.cpp:632)."""
        return float(sum(np.max(m.leaf_value[:m.num_leaves])
                         for m in self.models))

    def lower_bound(self) -> float:
        """reference: GBDT::GetLowerBoundValue (gbdt.cpp:640)."""
        return float(sum(np.min(m.leaf_value[:m.num_leaves])
                         for m in self.models))

    def shuffle_models(self, start_iteration: int = 0,
                       end_iteration: int = -1) -> "Booster":
        """Shuffle the iterations in [start, end) with the reference's LCG
        draws (GBDT::ShuffleModels, gbdt.h:80: Fisher-Yates with
        Random(17).NextShort); scores mid-training are not re-derived."""
        models = self.models
        K = self.num_tree_per_iteration
        total_iter = len(models) // K
        start = max(0, start_iteration)
        end = (total_iter if end_iteration <= 0
               else min(total_iter, end_iteration))
        indices = list(range(total_iter))
        x = 17
        for i in range(start, end - 1):
            x = (214013 * x + 2531011) & 0xFFFFFFFF
            r = (x >> 16) & 0x7FFF
            j = r % (end - (i + 1)) + (i + 1)
            indices[i], indices[j] = indices[j], indices[i]
        models[:] = [models[i * K + k] for i in indices for k in range(K)]
        self._forest_cache = None
        return self

    def dump_model(self, num_iteration: Optional[int] = None,
                   start_iteration: int = 0) -> dict:
        """The model as JSON-ready dicts (reference: DumpModel,
        gbdt_model_text.cpp:21; ``num_iteration`` defaults to the best
        iteration)."""
        if num_iteration is None:
            num_iteration = self.best_iteration
        K = max(self.num_tree_per_iteration, 1)
        total_iter = len(self.models) // K
        start = max(0, int(start_iteration))
        stop = (total_iter if num_iteration <= 0
                else min(total_iter, start + int(num_iteration)))

        def node(t: HostTree, nd: int) -> dict:
            if nd < 0:
                li = ~nd
                return {
                    "leaf_index": int(li),
                    "leaf_value": float(t.leaf_value[li]),
                    "leaf_weight": (float(t.leaf_weight[li])
                                    if len(t.leaf_weight) > li else 0.0),
                    "leaf_count": (int(t.leaf_count[li])
                                   if len(t.leaf_count) > li else 0)}
            dt = int(t.decision_type[nd])
            return {
                "split_index": int(nd),
                "split_feature": int(t.split_feature[nd]),
                "split_gain": float(t.split_gain[nd]),
                "threshold": float(t.threshold[nd]),
                "decision_type": "==" if dt & 1 else "<=",
                "default_left": bool(dt & 2),
                "missing_type": ["None", "Zero", "NaN"][(dt >> 2) & 3],
                "internal_value": float(t.internal_value[nd]),
                "internal_weight": float(t.internal_weight[nd]),
                "internal_count": int(t.internal_count[nd]),
                "left_child": node(t, int(t.left_child[nd])),
                "right_child": node(t, int(t.right_child[nd]))}

        return {
            "name": self.sub_model_name, "version": "v3",
            "num_class": self.num_class,
            "num_tree_per_iteration": self.num_tree_per_iteration,
            "label_index": self.label_index,
            "max_feature_idx": self.max_feature_idx,
            "objective": self.objective_name,
            "average_output": self.average_output,
            "feature_names": self.feature_names,
            "tree_info": [
                {"tree_index": i, "num_leaves": t.num_leaves,
                 "num_cat": t.num_cat, "shrinkage": t.shrinkage,
                 "tree_structure": node(t, 0 if t.num_leaves > 1 else -1)}
                for i, t in enumerate(self.models[start * K:stop * K])]}

    def trees_to_dataframe(self):
        """The trees' nodes in preorder as a pandas DataFrame, the
        reference's columns (basic.py:1906); needs pandas."""
        import pandas as pd
        if self.num_trees() == 0:
            raise LightGBMError("There are no trees in this Booster and "
                                "thus nothing to parse")
        fnames = self.feature_name()

        def nidx(nd, ti):
            if "split_index" in nd:
                return f"{ti}-S{nd['split_index']}"
            return f"{ti}-L{nd.get('leaf_index', 0)}"

        rows = []

        def walk(nd, ti, depth, parent):
            rec = {"tree_index": ti, "node_depth": depth,
                   "node_index": nidx(nd, ti), "left_child": None,
                   "right_child": None, "parent_index": parent,
                   "split_feature": None, "split_gain": None,
                   "threshold": None, "decision_type": None,
                   "missing_direction": None, "missing_type": None,
                   "value": None, "weight": None, "count": None}
            if "split_index" in nd:
                rec.update(
                    split_feature=fnames[nd["split_feature"]],
                    left_child=nidx(nd["left_child"], ti),
                    right_child=nidx(nd["right_child"], ti),
                    split_gain=nd["split_gain"], threshold=nd["threshold"],
                    decision_type=nd["decision_type"],
                    missing_direction=("left" if nd["default_left"]
                                       else "right"),
                    missing_type=nd["missing_type"],
                    value=nd["internal_value"], weight=nd["internal_weight"],
                    count=nd["internal_count"])
                rows.append(rec)
                walk(nd["left_child"], ti, depth + 1, rec["node_index"])
                walk(nd["right_child"], ti, depth + 1, rec["node_index"])
            else:
                rec["value"] = nd["leaf_value"]
                if parent is not None:
                    rec["weight"] = nd.get("leaf_weight")
                    rec["count"] = nd.get("leaf_count")
                rows.append(rec)

        for t in self.dump_model()["tree_info"]:
            walk(t["tree_structure"], t["tree_index"], 1, None)
        return pd.DataFrame(rows)

    def get_split_value_histogram(self, feature, bins=None,
                                  xgboost_style=False):
        """The histogram of a numeric feature's split thresholds
        (reference: basic.py:2762); ``xgboost_style`` gives the
        (SplitValue, Count) table, a DataFrame where pandas is
        installed."""
        fnames = self.feature_name()
        fidx = (fnames.index(feature) if isinstance(feature, str)
                else int(feature))
        vals = []
        for t in self.models:
            for nd in range(t.num_leaves - 1):
                if int(t.split_feature[nd]) == fidx:
                    if int(t.decision_type[nd]) & 1:
                        raise LightGBMError(
                            "Cannot compute split value histogram for the "
                            "categorical feature")
                    vals.append(float(t.threshold[nd]))
        if bins is None or (isinstance(bins, int) and xgboost_style):
            n_unique = len(np.unique(vals))
            bins = max(min(n_unique, bins) if bins is not None else n_unique,
                       1)
        hist, bin_edges = np.histogram(vals, bins=bins)
        if xgboost_style:
            ret = np.column_stack((bin_edges[1:], hist))
            ret = ret[ret[:, 1] > 0]
            from .compat import PANDAS_INSTALLED
            if PANDAS_INSTALLED:
                import pandas as pd
                return pd.DataFrame(ret, columns=["SplitValue", "Count"])
            return ret
        return hist, bin_edges

    @property
    def models(self) -> List[HostTree]:
        if self.boosting is not None:
            return self.boosting.models
        return self._loaded["models"]

    @property
    def num_tree_per_iteration(self) -> int:
        if self.boosting is not None:
            return self.boosting.num_tree_per_iteration
        return self._loaded["num_tree_per_iteration"]

    @property
    def num_class(self) -> int:
        if self.boosting is not None:
            return self.config.num_class
        return self._loaded["num_class"]

    def num_trees(self) -> int:
        return len(self.models)

    def num_model_per_iteration(self) -> int:
        """Trees an iteration (reference: LGBM_BoosterNumModelPerIteration)."""
        return self.num_tree_per_iteration

    def num_features(self) -> int:
        if self.boosting is not None:
            return self.train_set.num_total_features
        return self._loaded["max_feature_idx"] + 1

    def num_feature(self) -> int:
        return self.num_features()

    def feature_name(self) -> List[str]:
        if self.boosting is not None:
            return list(self.train_set.feature_names)
        return self._loaded["feature_names"]

    # ------------------------------------------------------------- inference

    def _forest(self, start_iter: int, stop_iter: int):
        """StackedForest over models[start*K : stop*K], cached per range."""
        from .predict import StackedForest
        K = self.num_tree_per_iteration
        key = (start_iter, stop_iter, len(self.models))
        cached = getattr(self, "_forest_cache", None)
        if cached is not None and cached[0] == key:
            return cached[1]
        forest = StackedForest(self.models[start_iter * K:stop_iter * K])
        self._forest_cache = (key, forest)
        return forest

    def _device_forest(self, forest):
        """DeviceForest for ``forest`` on this Booster's device, cached
        alongside the host cache."""
        from .predict import DeviceForest
        cached = getattr(self, "_device_forest_cache", None)
        if cached is not None and cached[0] is forest:
            return cached[1]
        dev = DeviceForest(forest, self.device)
        self._device_forest_cache = (forest, dev)
        return dev

    def predict(self, data, num_iteration: Optional[int] = None,
                raw_score: bool = False, pred_leaf: bool = False,
                pred_contrib: bool = False, start_iteration: int = 0,
                device: bool = True, **kwargs) -> np.ndarray:
        """reference: basic.py:2281 Booster.predict.

        ``device=True`` (default) routes rows on this Booster's device
        (float32 scores summed in the pinned tree order); ``device=False``
        runs the host float64 NumPy path.  ``pred_early_stop`` /
        ``pred_early_stop_freq`` / ``pred_early_stop_margin`` mirror the
        reference (src/boosting/prediction_early_stop.cpp) and run only on
        the host path: with ``device=True`` they raise.
        ``pred_contrib=True`` gives each feature's SHAP value and the
        expected value last ([n, F + 1], or [n, K * (F + 1)]), on the host
        in float64 (``utils/shap.py``).  ``data`` may be a text file's
        path, a pandas DataFrame (the training category lists are
        re-applied) or a scipy sparse matrix (densified
        ``SPARSE_CHUNK_ROWS`` rows at a time).
        """
        from .compat import is_pandas_frame
        from .dataset import SPARSE_CHUNK_ROWS, _data_from_pandas, _is_sparse
        if isinstance(data, (str, os.PathLike)):
            from .io_utils import load_prediction_file
            data = load_prediction_file(str(data), self.num_features(),
                                        dict(self.params))
        if is_pandas_frame(data):
            data = _data_from_pandas(data, None, None,
                                     getattr(self, "pandas_categorical",
                                             None))[0]
        if _is_sparse(data):
            csr = data.tocsr()
            self._check_width(csr.shape[1], kwargs)
            outs = [self.predict(csr[s:s + SPARSE_CHUNK_ROWS].toarray(),
                                 num_iteration, raw_score, pred_leaf,
                                 pred_contrib, start_iteration, device,
                                 **kwargs)
                    for s in range(0, csr.shape[0], SPARSE_CHUNK_ROWS)]
            return np.concatenate(outs, axis=0) if outs else np.zeros((0,))
        from .utils.timer import global_timer
        with global_timer.section("Booster::Predict"):
            return self._predict_rows(data, num_iteration, raw_score,
                                      pred_leaf, pred_contrib,
                                      start_iteration, device, kwargs)

    def _predict_rows(self, data, num_iteration, raw_score, pred_leaf,
                      pred_contrib, start_iteration, device,
                      kwargs) -> np.ndarray:
        """``predict`` of dense rows (the ``Booster::Predict`` timer
        section)."""
        X = np.ascontiguousarray(np.asarray(data, np.float64))
        if X.ndim == 1:
            X = X[None, :]
        self._check_width(X.shape[1], kwargs)
        K = self.num_tree_per_iteration
        n_total_iter = len(self.models) // max(K, 1)
        if num_iteration is None or num_iteration < 0:
            # best_iteration is already a 1-based count of iterations to keep
            num_iteration = (self.best_iteration
                             if self.best_iteration > 0 else n_total_iter)
        stop_iter = min(start_iteration + num_iteration, n_total_iter)
        forest = self._forest(start_iteration, stop_iter)

        if pred_leaf:
            if device:
                return self._device_forest(forest).predict_leaf(X)
            return forest.predict_leaf(X)
        if pred_contrib:
            from .utils.shap import tree_shap_batch
            F = self.num_features()
            out = np.zeros((X.shape[0], K, F + 1), np.float64)
            for it in range(start_iteration, stop_iter):
                for k in range(K):
                    tree_shap_batch(self.models[it * K + k], X, out[:, k, :])
            return out.reshape(X.shape[0], -1) if K > 1 else out[:, 0, :]

        early_stop = None
        if kwargs.get("pred_early_stop"):
            if device:
                raise LightGBMError(
                    "pred_early_stop runs on the host path only; pass "
                    "device=False to predict with early stop")
            from .predict import make_early_stop
            obj = (self.objective_name or "").split(" ")[0]
            kind = ("binary" if obj == "binary"
                    else "multiclass" if obj in ("multiclass", "softmax",
                                                 "multiclassova", "ova")
                    else "none")
            early_stop = make_early_stop(
                kind,
                float(kwargs.get("pred_early_stop_margin", 10.0)),
                int(kwargs.get("pred_early_stop_freq", 10)))

        if device:
            raw = self._device_forest(forest).predict_raw(X, num_class=K)
        else:
            raw = forest.predict_raw(X, num_class=K, early_stop=early_stop)
        if self.average_output and stop_iter > start_iteration:
            raw /= (stop_iter - start_iteration)
        if raw_score:
            return raw[0] if K == 1 else raw.T
        conv = self._convert_output(raw)
        return conv[0] if (K == 1 and conv.shape[0] == 1) else conv.T

    def _check_width(self, width: int, kwargs: dict) -> None:
        disable_check = kwargs.get(
            "predict_disable_shape_check",
            self.params.get("predict_disable_shape_check", False))
        if width != self.num_features() and not disable_check:
            raise LightGBMError(
                f"The number of features in data ({width}) is not the "
                f"same as it was in training data ({self.num_features()}).\n"
                "You can set ``predict_disable_shape_check=true`` to discard "
                "this error, but please be aware what you are doing.")

    def serve(self, config=None, **overrides):
        """In-process inference server over this model: thread-safe
        ``submit``/``predict`` with micro-batching into power-of-two
        shape buckets, per-request deadlines, queue backpressure, a
        JSON-dumpable metrics registry, model hot-swap
        (``swap_model``) and graceful drain on ``close()``.  Keyword
        overrides populate a ``serving.ServingConfig`` (e.g.
        ``max_batch_rows=512, backend="host"``, ``precision="bf16",
        accuracy_budget=1e-2, probe_X=X``, ``max_programs=32``)."""
        from .serving import Server
        return Server(self, config=config, **overrides)

    def _convert_output(self, raw: np.ndarray) -> np.ndarray:
        obj = self.objective_name.split(" ")[0] if self.objective_name else ""
        if obj == "binary":
            sig = self._objective_param("sigmoid", 1.0)
            return 1.0 / (1.0 + np.exp(-sig * raw))
        if obj in ("multiclass", "softmax"):
            e = np.exp(raw - raw.max(axis=0, keepdims=True))
            return e / e.sum(axis=0, keepdims=True)
        if obj in ("multiclassova", "ova"):
            sig = self._objective_param("sigmoid", 1.0)
            return 1.0 / (1.0 + np.exp(-sig * raw))
        if obj in ("poisson", "gamma", "tweedie"):
            return np.exp(raw)
        if obj in ("cross_entropy_lambda", "xentlambda"):
            return np.log1p(np.exp(raw))
        if obj in ("cross_entropy", "xentropy"):
            return 1.0 / (1.0 + np.exp(-raw))
        if obj == "regression" and self._objective_param_flag("sqrt"):
            return np.sign(raw) * raw * raw
        return raw

    def _objective_param(self, key: str, default: float) -> float:
        for tok in (self.objective_name or "").split(" ")[1:]:
            if tok.startswith(f"{key}:"):
                return float(tok.split(":", 1)[1])
        return default

    def _objective_param_flag(self, key: str) -> bool:
        return key in (self.objective_name or "").split(" ")[1:]

    def feature_importance(self, importance_type: str = "split",
                           iteration: Optional[int] = None) -> np.ndarray:
        imp = np.zeros(self.num_features(), np.float64)
        K = self.num_tree_per_iteration
        if iteration is None:
            # reference: Booster.feature_importance defaults to
            # best_iteration (basic.py:2744)
            iteration = self.best_iteration
        stop = len(self.models) if iteration <= 0 else iteration * K
        for ht in self.models[:stop]:
            for s in range(ht.num_leaves - 1):
                f = int(ht.split_feature[s])
                if importance_type == "split":
                    imp[f] += 1
                else:
                    imp[f] += max(float(ht.split_gain[s]), 0.0)
        if importance_type == "split":
            return imp.astype(np.int64)
        return imp

    # -------------------------------------------------------------- model IO

    @property
    def sub_model_name(self) -> str:
        if self.boosting is not None:
            return "tree"
        return self._loaded["sub_model_name"]

    @property
    def average_output(self) -> bool:
        if self.boosting is not None:
            return self.config.boosting in ("rf", "random_forest")
        return self._loaded["average_output"]

    @property
    def objective_name(self) -> str:
        if self.boosting is not None:
            return self._objective_to_string()
        return self._loaded["objective_name"]

    def _objective_to_string(self) -> str:
        """The model text's objective line (reference: the JAX package's
        basic.py:770-785); empty for a custom objective."""
        if self.objective is None:
            return ""
        c = self.config
        name = self.objective.name
        if name == "binary":
            return f"binary sigmoid:{c.sigmoid:g}"
        if name in ("multiclass", "multiclassova"):
            s = f"{name} num_class:{c.num_class}"
            if name == "multiclassova":
                s += f" sigmoid:{c.sigmoid:g}"
            return s
        if name == "regression" and c.reg_sqrt:
            return "regression sqrt"
        return name

    @property
    def label_index(self) -> int:
        return 0

    @property
    def max_feature_idx(self) -> int:
        return self.num_features() - 1

    @property
    def feature_names(self) -> List[str]:
        return self.feature_name()

    @property
    def feature_infos(self) -> List[str]:
        """reference format: [min:max] per numeric feature, the
        ':'-joined categories of a categorical one, "none" for a trivial
        one."""
        if self.boosting is None:
            return self._loaded["feature_infos"]
        out = []
        for m in self.train_set.bin_mappers:
            if m.is_trivial:
                out.append("none")
            elif m.bin_type == BinType.CATEGORICAL:
                out.append(":".join(str(c) for c in m.bin_2_categorical))
            else:
                out.append(f"[{m.min_val:g}:{m.max_val:g}]")
        return out

    @property
    def params_str(self) -> str:
        return "\n".join(f"[{k}: {v}]" for k, v in sorted(self.params.items()))

    def feature_importance_int(self):
        imp = self.feature_importance("split")
        names = self.feature_name()
        return [(names[i], int(imp[i])) for i in range(len(imp))]

    def model_to_string(self, num_iteration: Optional[int] = None,
                        start_iteration: int = 0) -> str:
        # reference: num_iteration defaults to best_iteration
        # (basic.py:2407,2490)
        if num_iteration is None:
            num_iteration = self.best_iteration
        out = save_model_to_string(self, num_iteration, start_iteration)

        # category value lists ride in the model file (reference:
        # _dump_pandas_categorical, basic.py:385)
        def _default(o):
            if isinstance(o, np.generic):
                return o.item()
            raise TypeError(f"not JSON serializable: {type(o)}")

        out += ("\npandas_categorical:"
                + json.dumps(self.pandas_categorical, default=_default)
                + "\n")
        return out

    def save_model(self, filename: str, num_iteration: Optional[int] = None,
                   start_iteration: int = 0) -> "Booster":
        """Write the model text atomically (``utils/file_io.py``), so a
        crash mid-write never leaves a truncated model."""
        from .utils.file_io import write_atomic
        write_atomic(filename,
                     self.model_to_string(num_iteration, start_iteration))
        return self
