"""C-API-shaped stable entry points for external runtimes (counterpart
of ``lightgbm_tpu/capi.py``).

reference: include/LightGBM/c_api.h (~70 ``LGBM_*`` functions wrapped by
ctypes/R/SWIG).  The seam is a flat Python module with the reference's
calling convention: every function is named after its c_api.h
counterpart and takes its positional arguments, returns 0 on success and
-1 on failure, reports through ``LGBM_GetLastError``, and passes integer
handles and out-parameter lists instead of objects, which is what an
embedding runtime (JNI, pyo3, R's reticulate) binds against.

Devices: a function that creates a Dataset or a Booster from data, a
file or a string takes a keyword-only ``device=None``; without it the
parameter string's ``device_type`` (alias ``device``) decides: ``cpu``
asks for the CPU, unset, ``tpu``, ``gpu`` or ``cuda`` mean the CUDA card
(``basic.device_from_params``), and a host without CUDA raises through
the error protocol.  A Booster made from a Dataset handle, a Dataset made
by reference and a subset take their source's device.  Training runs
through the port's round graph (B2) and binning through B3 where the
rows are f32 (the kernel route); predictions go through ``DeviceForest``
(B1).  ``LGBM_NetworkInit``/``LGBM_NetworkFree`` start and stop the
port's ``torch.distributed`` group (``parallel.network``).
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional

import numpy as np

_last_error = threading.local()


def _set_error(msg: str) -> int:
    _last_error.msg = str(msg)
    return -1


def LGBM_GetLastError() -> str:
    """reference: c_api.h LGBM_GetLastError."""
    return getattr(_last_error, "msg", "")


def _guard(fn):
    import functools

    @functools.wraps(fn)
    def inner(*args, **kwargs):
        try:
            return fn(*args, **kwargs)
        except Exception as e:   # noqa: BLE001 - ABI boundary
            return _set_error(f"{type(e).__name__}: {e}")

    return inner


_handles: Dict[int, object] = {}
_next_handle = [1]
_lock = threading.Lock()


def _register(obj) -> int:
    with _lock:
        h = _next_handle[0]
        _next_handle[0] += 1
        _handles[h] = obj
    return h


def _get(handle: int):
    try:
        return _handles[handle]
    except KeyError:
        raise ValueError(f"invalid handle {handle}") from None


def _parse_params(parameters: str) -> dict:
    """reference: Config::Str2Map (config.h:81) — 'k=v k2=v2' strings,
    with value typing ('false' must parse as False, not a truthy str)."""
    out = {}
    for tok in str(parameters or "").replace("\n", " ").split():
        if "=" not in tok:
            continue
        k, v = tok.split("=", 1)
        low = v.strip().lower()
        if low in ("true", "false"):
            out[k] = low == "true"
            continue
        try:
            out[k] = int(v)
            continue
        except ValueError:
            pass
        try:
            out[k] = float(v)
            continue
        except ValueError:
            pass
        out[k] = v
    return out


def _params_device(parameters: str, device):
    """(parameters without ``device_type``, the device they ask for)."""
    from .basic import device_from_params
    from .config import Config
    params = _parse_params(parameters)
    dev = device_from_params(params, device)
    return ({k: v for k, v in params.items()
             if Config.canonical_key(k) != "device_type"}, dev)


def _models_changed(bst) -> None:
    """Drop a Booster's cached forests after its trees changed in place."""
    bst._forest_cache = None
    bst._device_forest_cache = None


# ------------------------------------------------------------------ dataset

@_guard
def LGBM_DatasetCreateFromMat(data, parameters: str, label,
                              out_handle: List[int], *, device=None) -> int:
    """reference: c_api.h LGBM_DatasetCreateFromMat.  Accepts
    ``free_raw_data=false`` in the parameter string (needed for
    LGBM_BoosterResetTrainingData's score replay).  f32 rows bin on the
    card through B3, f64 rows on the host route."""
    from .dataset import Dataset
    params, dev = _params_device(parameters, device)
    keep_raw = not params.pop("free_raw_data", True)
    ds = Dataset(np.asarray(data), label=label, params=params,
                 free_raw_data=not keep_raw, device=dev)
    out_handle[:] = [_register(ds)]
    return 0


@_guard
def LGBM_DatasetCreateFromFile(filename: str, parameters: str,
                               reference_handle: Optional[int],
                               out_handle: List[int], *, device=None) -> int:
    """reference: c_api.h LGBM_DatasetCreateFromFile (a text file or a
    binary Dataset file); with a reference, its device."""
    from .dataset import Dataset
    ref = _get(reference_handle) if reference_handle else None
    params, dev = _params_device(parameters, device)
    ds = Dataset(str(filename), params=params, reference=ref,
                 device=dev if ref is None else None)
    out_handle[:] = [_register(ds)]
    return 0


@_guard
def LGBM_DatasetCreateFromSampledColumn(sample_data, num_total_row: int,
                                        parameters: str,
                                        out_handle: List[int], *,
                                        device=None) -> int:
    """reference: c_api.h LGBM_DatasetCreateFromSampledColumn: start a
    streaming load; push blocks with LGBM_DatasetPushRows."""
    from .dataset import Dataset
    params, dev = _params_device(parameters, device)
    ds = Dataset.from_sample(np.asarray(sample_data), int(num_total_row),
                             params=params, device=dev)
    out_handle[:] = [_register(ds)]
    return 0


@_guard
def LGBM_DatasetPushRows(dataset_handle: int, data,
                         start_row: int = None) -> int:
    """reference: c_api.h:98 LGBM_DatasetPushRows (start_row None
    appends after the previous push)."""
    sr = None if start_row is None else int(start_row)
    _get(dataset_handle).push_rows(data, start_row=sr)
    return 0


@_guard
def LGBM_DatasetSetField(dataset_handle: int, field_name: str,
                         field_data) -> int:
    """reference: c_api.h LGBM_DatasetSetField (label/weight/group/
    init_score)."""
    ds = _get(dataset_handle)
    field = str(field_name)
    if field == "label":
        ds.set_label(field_data)
    elif field == "weight":
        ds.set_weight(field_data)
    elif field in ("group", "query"):
        ds.set_group(field_data)
    elif field == "init_score":
        ds.set_init_score(field_data)
    else:
        raise ValueError(f"unknown field {field!r}")
    return 0


@_guard
def LGBM_DatasetGetNumData(dataset_handle: int, out: List[int]) -> int:
    ds = _get(dataset_handle)
    ds.construct()
    out[:] = [ds.num_data]
    return 0


@_guard
def LGBM_DatasetGetNumFeature(dataset_handle: int, out: List[int]) -> int:
    ds = _get(dataset_handle)
    ds.construct()
    out[:] = [len(ds.used_features)]
    return 0


@_guard
def LGBM_DatasetSaveBinary(dataset_handle: int, filename: str) -> int:
    _get(dataset_handle).construct().save_binary(str(filename))
    return 0


@_guard
def LGBM_DatasetFree(dataset_handle: int) -> int:
    with _lock:
        _handles.pop(dataset_handle, None)
    return 0


# ------------------------------------------------------------------ booster

@_guard
def LGBM_BoosterCreate(train_data_handle: int, parameters: str,
                       out_handle: List[int], *, device=None) -> int:
    """reference: c_api.h LGBM_BoosterCreate.  The Booster trains on the
    Dataset's device (``device``, where given, must be that one)."""
    from .basic import Booster
    from .config import Config
    params = {k: v for k, v in _parse_params(parameters).items()
              if Config.canonical_key(k) != "device_type"}
    bst = Booster(params=params, train_set=_get(train_data_handle),
                  device=device)
    out_handle[:] = [_register(bst)]
    return 0


@_guard
def LGBM_BoosterCreateFromModelfile(filename: str,
                                    out_num_iterations: List[int],
                                    out_handle: List[int], *,
                                    device=None) -> int:
    """reference: c_api.h LGBM_BoosterCreateFromModelfile; on the card
    unless ``device="cpu"``."""
    from .basic import Booster
    bst = Booster(model_file=str(filename), device=device)
    out_num_iterations[:] = [bst.current_iteration()]
    out_handle[:] = [_register(bst)]
    return 0


@_guard
def LGBM_BoosterLoadModelFromString(model_str: str,
                                    out_num_iterations: List[int],
                                    out_handle: List[int], *,
                                    device=None) -> int:
    """reference: c_api.h LGBM_BoosterLoadModelFromString; on the card
    unless ``device="cpu"``."""
    from .basic import Booster
    bst = Booster(model_str=str(model_str), device=device)
    out_num_iterations[:] = [bst.current_iteration()]
    out_handle[:] = [_register(bst)]
    return 0


@_guard
def LGBM_BoosterAddValidData(booster_handle: int,
                             valid_data_handle: int) -> int:
    bst = _get(booster_handle)
    bst.add_valid(_get(valid_data_handle),
                  f"valid_{len(bst.boosting.valid_names)}")
    return 0


@_guard
def LGBM_BoosterUpdateOneIter(booster_handle: int,
                              out_is_finished: List[int]) -> int:
    """reference: c_api.h LGBM_BoosterUpdateOneIter."""
    stopped = _get(booster_handle).update()
    out_is_finished[:] = [1 if stopped else 0]
    return 0


@_guard
def LGBM_BoosterUpdateOneIterCustom(booster_handle: int, grad, hess,
                                    out_is_finished: List[int]) -> int:
    """reference: c_api.h:507 custom-objective update."""
    bst = _get(booster_handle)
    stopped = bst.boosting.train_one_iter(np.asarray(grad, np.float32),
                                          np.asarray(hess, np.float32))
    out_is_finished[:] = [1 if stopped else 0]
    return 0


@_guard
def LGBM_BoosterRollbackOneIter(booster_handle: int) -> int:
    _get(booster_handle).rollback_one_iter()
    return 0


@_guard
def LGBM_BoosterGetEval(booster_handle: int, data_idx: int,
                        out_results: List[float]) -> int:
    """reference: c_api.h LGBM_BoosterGetEval — data_idx 0 is the train
    set, i >= 1 the (i-1)-th validation set."""
    bst = _get(booster_handle)
    if data_idx == 0:
        res = bst.boosting.eval_train()
    else:
        name = bst.boosting.valid_names[data_idx - 1]
        res = [r for r in bst.boosting.eval_valid() if r[0] == name]
    out_results[:] = [float(v) for (_, _, v, _) in res]
    return 0


@_guard
def LGBM_BoosterGetNumClasses(booster_handle: int, out: List[int]) -> int:
    out[:] = [_get(booster_handle).num_class]
    return 0


@_guard
def LGBM_BoosterNumberOfTotalModel(booster_handle: int,
                                   out: List[int]) -> int:
    out[:] = [_get(booster_handle).num_trees()]
    return 0


@_guard
def LGBM_BoosterGetCurrentIteration(booster_handle: int,
                                    out: List[int]) -> int:
    out[:] = [_get(booster_handle).current_iteration()]
    return 0


@_guard
def LGBM_BoosterPredictForMat(booster_handle: int, data, predict_type: int,
                              num_iteration: int,
                              out_result: List[np.ndarray]) -> int:
    """reference: c_api.h:822; predict_type 0=normal 1=raw 2=leaf 3=contrib
    (C_API_PREDICT_* constants)."""
    bst = _get(booster_handle)
    kwargs = {}
    if predict_type == 1:
        kwargs["raw_score"] = True
    elif predict_type == 2:
        kwargs["pred_leaf"] = True
    elif predict_type == 3:
        kwargs["pred_contrib"] = True
    ni = None if num_iteration <= 0 else int(num_iteration)
    out_result[:] = [bst.predict(np.asarray(data), num_iteration=ni,
                                 **kwargs)]
    return 0


@_guard
def LGBM_BoosterSaveModel(booster_handle: int, start_iteration: int,
                          num_iteration: int, filename: str) -> int:
    # C semantics: num_iteration <= 0 saves ALL iterations (the Python
    # layer's best_iteration defaulting happens above this ABI)
    ni = int(num_iteration)
    _get(booster_handle).save_model(str(filename), num_iteration=ni,
                                    start_iteration=int(start_iteration))
    return 0


@_guard
def LGBM_BoosterSaveModelToString(booster_handle: int,
                                  out_str: List[str]) -> int:
    out_str[:] = [_get(booster_handle).model_to_string()]
    return 0


@_guard
def LGBM_BoosterFree(booster_handle: int) -> int:
    with _lock:
        _handles.pop(booster_handle, None)
    return 0


# --------------------------------------------------------------------------
# round-4 additions: the remaining c_api.h surface


def LGBM_SetLastError(msg: str) -> int:
    """reference: c_api.h LGBM_SetLastError."""
    _set_error(msg)
    return 0


@_guard
def LGBM_DatasetCreateByReference(reference_handle: int, num_total_row: int,
                                  out_handle: List[int]) -> int:
    """reference: c_api.h LGBM_DatasetCreateByReference: an empty aligned
    dataset on the reference's device, to be filled by PushRows."""
    from .dataset import Dataset
    ref = _get(reference_handle)
    ds = Dataset.from_reference_streaming(ref, int(num_total_row))
    out_handle[:] = [_register(ds)]
    return 0


@_guard
def LGBM_DatasetPushRowsByCSR(dataset_handle: int, indptr, indices, data,
                              num_rows: int, start_row: int = None) -> int:
    """reference: c_api.h:123 — push a CSR block into a streaming dataset."""
    from scipy import sparse
    indptr = np.asarray(indptr, np.int64)
    ds = _get(dataset_handle)
    ncol = ds.num_total_features or (int(np.max(indices)) + 1 if len(indices) else 0)
    block = sparse.csr_matrix(
        (np.asarray(data, np.float64), np.asarray(indices, np.int32), indptr),
        shape=(int(num_rows), ncol))
    ds.push_rows(block, start_row=start_row)
    return 0


@_guard
def LGBM_DatasetCreateFromCSR(indptr, indices, data, num_rows: int,
                              num_col: int, parameters: str, label,
                              reference_handle: int,
                              out_handle: List[int], *, device=None) -> int:
    """reference: c_api.h LGBM_DatasetCreateFromCSR."""
    from scipy import sparse
    from .dataset import Dataset
    mat = sparse.csr_matrix(
        (np.asarray(data, np.float64), np.asarray(indices, np.int32),
         np.asarray(indptr, np.int64)),
        shape=(int(num_rows), int(num_col)))
    ref = _get(reference_handle) if reference_handle else None
    params, dev = _params_device(parameters, device)
    ds = Dataset(mat, label=label, reference=ref, params=params,
                 device=dev if ref is None else None).construct()
    out_handle[:] = [_register(ds)]
    return 0


@_guard
def LGBM_DatasetCreateFromCSC(col_ptr, indices, data, num_rows: int,
                              num_col: int, parameters: str, label,
                              reference_handle: int,
                              out_handle: List[int], *, device=None) -> int:
    """reference: c_api.h LGBM_DatasetCreateFromCSC."""
    from scipy import sparse
    from .dataset import Dataset
    mat = sparse.csc_matrix(
        (np.asarray(data, np.float64), np.asarray(indices, np.int32),
         np.asarray(col_ptr, np.int64)),
        shape=(int(num_rows), int(num_col)))
    ref = _get(reference_handle) if reference_handle else None
    params, dev = _params_device(parameters, device)
    ds = Dataset(mat.tocsr(), label=label, reference=ref, params=params,
                 device=dev if ref is None else None).construct()
    out_handle[:] = [_register(ds)]
    return 0


@_guard
def LGBM_DatasetCreateFromMats(mats, parameters: str, label,
                               out_handle: List[int], *, device=None) -> int:
    """reference: c_api.h LGBM_DatasetCreateFromMats: a list of row
    blocks."""
    from .dataset import Dataset
    data = np.vstack([np.asarray(m) for m in mats])
    params, dev = _params_device(parameters, device)
    ds = Dataset(data, label=label, params=params, device=dev).construct()
    out_handle[:] = [_register(ds)]
    return 0


@_guard
def LGBM_DatasetGetSubset(dataset_handle: int, used_row_indices,
                          parameters: str, out_handle: List[int]) -> int:
    """reference: c_api.h LGBM_DatasetGetSubset."""
    ds = _get(dataset_handle)
    sub = ds.subset(np.asarray(used_row_indices, np.int64),
                    params=_parse_params(parameters))
    sub.construct()
    out_handle[:] = [_register(sub)]
    return 0


@_guard
def LGBM_DatasetSetFeatureNames(dataset_handle: int, names) -> int:
    _get(dataset_handle).set_feature_name(list(names))
    return 0


@_guard
def LGBM_DatasetGetFeatureNames(dataset_handle: int,
                                out_names: List[str]) -> int:
    ds = _get(dataset_handle)
    ds.construct()
    out_names[:] = list(ds.feature_names)
    return 0


@_guard
def LGBM_DatasetGetField(dataset_handle: int, field_name: str,
                         out: List[np.ndarray]) -> int:
    val = _get(dataset_handle).get_field(str(field_name))
    out[:] = [val]
    return 0


@_guard
def LGBM_DatasetAddFeaturesFrom(target_handle: int, source_handle: int) -> int:
    _get(target_handle).add_features_from(_get(source_handle))
    return 0


@_guard
def LGBM_DatasetDumpText(dataset_handle: int, filename: str) -> int:
    _get(dataset_handle)._dump_text(str(filename))
    return 0


@_guard
def LGBM_DatasetUpdateParamChecking(old_parameters: str,
                                    new_parameters: str) -> int:
    """reference: c_api.h LGBM_DatasetUpdateParamChecking — error when a
    dataset-level parameter changes between boosters sharing a dataset."""
    from .config import Config
    old = Config.from_params(_parse_params(old_parameters)).to_dataset_params()
    new = Config.from_params(_parse_params(new_parameters)).to_dataset_params()
    diff = {k for k in set(old) | set(new) if old.get(k) != new.get(k)}
    if diff:
        return _set_error(
            f"Cannot change dataset parameters during training: {sorted(diff)}")
    return 0


@_guard
def LGBM_BoosterMerge(booster_handle: int, other_handle: int) -> int:
    """reference: c_api.h LGBM_BoosterMerge — append the other booster's
    trees to this booster's model."""
    bst = _get(booster_handle)
    other = _get(other_handle)
    bst.models.extend(other.models)
    _models_changed(bst)
    return 0


@_guard
def LGBM_BoosterResetParameter(booster_handle: int, parameters: str) -> int:
    _get(booster_handle).reset_parameter(_parse_params(parameters))
    return 0


@_guard
def LGBM_BoosterResetTrainingData(booster_handle: int,
                                  train_data_handle: int) -> int:
    """reference: c_api.h LGBM_BoosterResetTrainingData — swap the training
    dataset (same bin mappers) keeping the trained model."""
    from .basic import Booster
    from .engine import _apply_init_model
    bst = _get(booster_handle)
    ds = _get(train_data_handle)
    # continued-training semantics: adopt the trees AND replay their score
    # contributions on the new data (GBDT::ResetTrainingData replays
    # AddScore for every existing model, src/boosting/gbdt.cpp:648) —
    # otherwise the next UpdateOneIter would fit gradients as if the
    # model were empty.  Requires the new dataset's raw features
    # (free_raw_data=False) for the replay.
    loaded = Booster(model_str=bst.model_to_string(num_iteration=0),
                     device=bst.device)
    fresh = Booster(params=dict(bst.params), train_set=ds)
    _apply_init_model(fresh, loaded, ds)
    # the reference preserves Python-side booster attributes across a
    # training-data swap: carry over attrs/best_iteration/name explicitly
    # and drop every stale key (a blind update would leave caches behind)
    preserved = {k: bst.__dict__[k]
                 for k in ("_attr", "best_iteration", "best_score",
                           "_train_data_name")
                 if k in bst.__dict__}
    bst.__dict__.clear()
    bst.__dict__.update(fresh.__dict__)
    bst.__dict__.update(preserved)
    return 0


@_guard
def LGBM_BoosterRefit(booster_handle: int, leaf_preds) -> int:
    """reference: c_api.h LGBM_BoosterRefit."""
    bst = _get(booster_handle)
    bst.boosting.refit_leaf_values(np.asarray(leaf_preds),
                                   bst.config.refit_decay_rate)
    return 0


@_guard
def LGBM_BoosterShuffleModels(booster_handle: int, start_iter: int,
                              end_iter: int) -> int:
    _get(booster_handle).shuffle_models(int(start_iter), int(end_iter))
    return 0


@_guard
def LGBM_BoosterNumModelPerIteration(booster_handle: int,
                                     out: List[int]) -> int:
    out[:] = [_get(booster_handle).num_model_per_iteration()]
    return 0


@_guard
def LGBM_BoosterGetNumFeature(booster_handle: int, out: List[int]) -> int:
    out[:] = [_get(booster_handle).num_feature()]
    return 0


@_guard
def LGBM_BoosterGetFeatureNames(booster_handle: int,
                                out_names: List[str]) -> int:
    out_names[:] = list(_get(booster_handle).feature_name())
    return 0


def _eval_names(bst) -> List[str]:
    """Metric names, derived from the configured metric objects without an
    evaluation pass (Metric.names); recomputed on every call so parameter
    resets that change the metric list are always reflected."""
    return [n for m in bst.boosting.train_metrics for n in m.names()]


@_guard
def LGBM_BoosterGetEvalCounts(booster_handle: int, out: List[int]) -> int:
    out[:] = [len(_eval_names(_get(booster_handle)))]
    return 0


@_guard
def LGBM_BoosterGetEvalNames(booster_handle: int,
                             out_names: List[str]) -> int:
    out_names[:] = list(_eval_names(_get(booster_handle)))
    return 0


@_guard
def LGBM_BoosterGetLeafValue(booster_handle: int, tree_idx: int,
                             leaf_idx: int, out: List[float]) -> int:
    out[:] = [_get(booster_handle).get_leaf_output(int(tree_idx),
                                                   int(leaf_idx))]
    return 0


@_guard
def LGBM_BoosterSetLeafValue(booster_handle: int, tree_idx: int,
                             leaf_idx: int, val: float) -> int:
    """reference: c_api.h LGBM_BoosterSetLeafValue."""
    bst = _get(booster_handle)
    bst.models[int(tree_idx)].leaf_value[int(leaf_idx)] = float(val)
    _models_changed(bst)
    return 0


@_guard
def LGBM_BoosterGetUpperBoundValue(booster_handle: int,
                                   out: List[float]) -> int:
    out[:] = [_get(booster_handle).upper_bound()]
    return 0


@_guard
def LGBM_BoosterGetLowerBoundValue(booster_handle: int,
                                   out: List[float]) -> int:
    out[:] = [_get(booster_handle).lower_bound()]
    return 0


def _inner_scores(bst, data_idx: int) -> np.ndarray:
    """The inner raw scores ([K, n] class-major, flattened) of the train
    set (0) or valid set ``data_idx - 1``."""
    b = bst.boosting
    s = b.train_score if data_idx == 0 else b.valid_scores[data_idx - 1]
    return s.cpu().numpy().reshape(-1)


@_guard
def LGBM_BoosterGetNumPredict(booster_handle: int, data_idx: int,
                              out: List[int]) -> int:
    """reference: c_api.h LGBM_BoosterGetNumPredict — size of the inner
    score vector for the data_idx-th dataset."""
    out[:] = [int(_inner_scores(_get(booster_handle), data_idx).size)]
    return 0


@_guard
def LGBM_BoosterGetPredict(booster_handle: int, data_idx: int,
                           out_result: List[np.ndarray]) -> int:
    """reference: c_api.h LGBM_BoosterGetPredict — inner raw scores kept
    for the training / validation datasets."""
    out_result[:] = [_inner_scores(_get(booster_handle), data_idx)]
    return 0


@_guard
def LGBM_BoosterCalcNumPredict(booster_handle: int, num_row: int,
                               predict_type: int, num_iteration: int,
                               out: List[int]) -> int:
    """reference: c_api.h LGBM_BoosterCalcNumPredict."""
    bst = _get(booster_handle)
    K = bst.num_tree_per_iteration
    total_iter = len(bst.models) // max(K, 1)
    ni = total_iter if num_iteration <= 0 else min(int(num_iteration),
                                                   total_iter)
    if predict_type == 2:      # leaf indices
        per_row = ni * K
    elif predict_type == 3:    # SHAP contribs
        per_row = (bst.num_features() + 1) * max(bst.num_class, 1)
    else:
        per_row = max(bst.num_class, 1)
    out[:] = [int(num_row) * per_row]
    return 0


def _predict_with_type(bst, data, predict_type, num_iteration):
    kwargs = {}
    if predict_type == 1:
        kwargs["raw_score"] = True
    elif predict_type == 2:
        kwargs["pred_leaf"] = True
    elif predict_type == 3:
        kwargs["pred_contrib"] = True
    ni = None if num_iteration <= 0 else int(num_iteration)
    return bst.predict(data, num_iteration=ni, **kwargs)


@_guard
def LGBM_BoosterPredictForCSR(booster_handle: int, indptr, indices, data,
                              num_rows: int, num_col: int, predict_type: int,
                              num_iteration: int,
                              out_result: List[np.ndarray]) -> int:
    from scipy import sparse
    mat = sparse.csr_matrix(
        (np.asarray(data, np.float64), np.asarray(indices, np.int32),
         np.asarray(indptr, np.int64)),
        shape=(int(num_rows), int(num_col)))
    out_result[:] = [_predict_with_type(_get(booster_handle), mat,
                                        predict_type, num_iteration)]
    return 0


@_guard
def LGBM_BoosterPredictForCSC(booster_handle: int, col_ptr, indices, data,
                              num_rows: int, num_col: int, predict_type: int,
                              num_iteration: int,
                              out_result: List[np.ndarray]) -> int:
    from scipy import sparse
    mat = sparse.csc_matrix(
        (np.asarray(data, np.float64), np.asarray(indices, np.int32),
         np.asarray(col_ptr, np.int64)),
        shape=(int(num_rows), int(num_col))).tocsr()
    out_result[:] = [_predict_with_type(_get(booster_handle), mat,
                                        predict_type, num_iteration)]
    return 0


@_guard
def LGBM_BoosterPredictForCSRSingleRow(booster_handle: int, indptr, indices,
                                       data, num_col: int, predict_type: int,
                                       num_iteration: int,
                                       out_result: List[np.ndarray]) -> int:
    return LGBM_BoosterPredictForCSR(booster_handle, indptr, indices, data,
                                     1, num_col, predict_type, num_iteration,
                                     out_result)


@_guard
def LGBM_BoosterPredictForMatSingleRow(booster_handle: int, row,
                                       predict_type: int, num_iteration: int,
                                       out_result: List[np.ndarray]) -> int:
    out_result[:] = [_predict_with_type(
        _get(booster_handle), np.asarray(row).reshape(1, -1), predict_type,
        num_iteration)]
    return 0


@_guard
def LGBM_BoosterPredictForMats(booster_handle: int, rows, predict_type: int,
                               num_iteration: int,
                               out_result: List[np.ndarray]) -> int:
    data = np.vstack([np.asarray(r).reshape(1, -1) for r in rows])
    out_result[:] = [_predict_with_type(_get(booster_handle), data,
                                        predict_type, num_iteration)]
    return 0


@_guard
def LGBM_BoosterPredictForFile(booster_handle: int, data_filename: str,
                               data_has_header: int, predict_type: int,
                               num_iteration: int,
                               result_filename: str) -> int:
    """reference: c_api.h LGBM_BoosterPredictForFile — predictions written
    one row per line (tab-separated for multi-output)."""
    from .io_utils import load_prediction_file
    bst = _get(booster_handle)
    X = load_prediction_file(str(data_filename), bst.num_features(),
                             {"header": bool(data_has_header)})
    pred = _predict_with_type(bst, X, predict_type, num_iteration)
    pred = np.asarray(pred)
    from .utils.file_io import open_atomic
    with open_atomic(str(result_filename), "w") as fh:
        for row in (pred if pred.ndim > 1 else pred[:, None]):
            fh.write("\t".join(repr(float(v)) for v in row) + "\n")
    return 0


@_guard
def LGBM_BoosterDumpModel(booster_handle: int, start_iteration: int,
                          num_iteration: int, out_str: List[str]) -> int:
    """reference: c_api.h LGBM_BoosterDumpModel (JSON)."""
    import json
    ni = int(num_iteration)          # <= 0 dumps all (C semantics)
    d = _get(booster_handle).dump_model(num_iteration=ni,
                                        start_iteration=int(start_iteration))
    out_str[:] = [json.dumps(d)]
    return 0


@_guard
def LGBM_BoosterFeatureImportance(booster_handle: int, num_iteration: int,
                                  importance_type: int,
                                  out: List[np.ndarray]) -> int:
    """reference: c_api.h LGBM_BoosterFeatureImportance — importance_type
    0 = split counts, 1 = total gain."""
    ni = int(num_iteration)          # <= 0 covers all (C semantics)
    kind = "gain" if importance_type == 1 else "split"
    out[:] = [_get(booster_handle).feature_importance(kind,
                                                      iteration=ni)]
    return 0


@_guard
def LGBM_NetworkInit(machines: str, local_listen_port: int,
                     listen_time_out: int, num_machines: int) -> int:
    """reference: c_api.h LGBM_NetworkInit (socket transport): here the
    machine list starts the port's ``torch.distributed`` group
    (``parallel.network.init_network``; NCCL for the card)."""
    from .parallel.network import init_network
    init_network(machines=machines, local_listen_port=local_listen_port,
                 listen_time_out=listen_time_out, num_machines=num_machines)
    return 0


@_guard
def LGBM_NetworkFree() -> int:
    """reference: c_api.h LGBM_NetworkFree."""
    from .parallel.network import free_network
    free_network()
    return 0


def LGBM_NetworkInitWithFunctions(num_machines: int, rank: int,
                                  reduce_scatter_ext_fun,
                                  allgather_ext_fun) -> int:
    """reference: c_api.h:1036, external collective injection (the Spark/
    Dask seam).  The port's histogram sums run over a
    ``torch.distributed`` process group (``parallel.collectives``); an
    external reduce-scatter and all-gather cannot stand in for it.  It
    fails fast, so a Spark- or Dask-style caller never trains
    partition-local models with no aggregation."""
    return _set_error(
        "LGBM_NetworkInitWithFunctions: external collective injection is "
        "not supported by lightgbm_tpu_torch (its sums run over a "
        "torch.distributed process group); use LGBM_NetworkInit + "
        "tree_learner=data instead")
