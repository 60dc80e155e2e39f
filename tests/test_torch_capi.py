"""The port's C-API-shaped module (``lightgbm_tpu_torch.capi``) against the
JAX package's (``lightgbm_tpu.capi``): the seven cases of
tests/test_capi.py run through both on the same NumPy inputs, the port's
handles on the CPU (``device="cpu"`` on every function that creates
one).  Each case compares return codes, counts, eval names and values,
model texts (``assert_same_trees``, the tolerances of
test_torch_objectives.py) and predictions.  Both packages grow by
rounds on the fused arm (``GROW``), as the other parity files do."""

import functools
import inspect
import json
import socket

import numpy as np
import pytest

from lightgbm_tpu import capi as jcapi

from lightgbm_tpu_torch import capi as tcapi
from lightgbm_tpu_torch.testing import one_thread  # noqa: F401
from test_torch_objectives import assert_same_trees

GROW = " tpu_tree_growth=rounds tpu_hist_method=fused"


class _OnCpu:
    """The port's module with ``device="cpu"`` passed to every function
    that takes it."""

    def __init__(self, mod):
        self._mod = mod

    def __getattr__(self, name):
        fn = getattr(self._mod, name)
        if callable(fn) and name.startswith("LGBM_"):
            sig = inspect.signature(inspect.unwrap(fn))
            if "device" in sig.parameters:
                return functools.partial(fn, device="cpu")
        return fn


PACKAGES = {"jax": jcapi, "port": _OnCpu(tcapi)}


def _data(n=2000, f=5, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.rand(n, f)
    y = (X[:, 0] + X[:, 1] > 1).astype(np.float32)
    return X, y


def _both(flow, *args):
    return {name: flow(c, *args) for name, c in PACKAGES.items()}


def _close(a, b, rtol=1e-4, atol=1e-6):
    np.testing.assert_allclose(np.asarray(b), np.asarray(a), rtol=rtol,
                               atol=atol)


def _full_flow(c, tmp_path):
    X, y = _data()
    dh, vh, bh = [0], [0], [0]
    rc = [c.LGBM_DatasetCreateFromMat(X, "max_bin=63 min_data_in_leaf=10",
                                      y, dh),
          c.LGBM_DatasetCreateFromMat(X, "max_bin=63", y, vh),
          c.LGBM_BoosterCreate(
              dh[0], "objective=binary num_leaves=15 verbosity=-1 "
              "metric=auc" + GROW, bh),
          c.LGBM_BoosterAddValidData(bh[0], vh[0])]
    fin = [0]
    for _ in range(20):
        rc.append(c.LGBM_BoosterUpdateOneIter(bh[0], fin))
        if fin[0]:
            break
    out_n, ev, pred, pred2 = [0], [], [None], [None]
    rc.append(c.LGBM_BoosterNumberOfTotalModel(bh[0], out_n))
    rc.append(c.LGBM_BoosterGetEval(bh[0], 1, ev))
    rc.append(c.LGBM_BoosterPredictForMat(bh[0], X[:100], 0, -1, pred))
    path = str(tmp_path / f"model_{id(c)}.txt")
    rc.append(c.LGBM_BoosterSaveModel(bh[0], 0, -1, path))
    nh, it = [0], [0]
    rc.append(c.LGBM_BoosterCreateFromModelfile(path, it, nh))
    rc.append(c.LGBM_BoosterPredictForMat(nh[0], X[:100], 0, -1, pred2))
    bst = c._get(bh[0])
    out = {"rc": rc, "n": out_n[0], "it": it[0], "ev": ev, "pred": pred[0],
           "pred2": pred2[0], "bst": bst}
    for h in (dh[0], vh[0]):
        rc.append(c.LGBM_DatasetFree(h))
    for h in (bh[0], nh[0]):
        rc.append(c.LGBM_BoosterFree(h))
    return out


def test_full_train_predict_flow(tmp_path):
    r = _both(_full_flow, tmp_path)
    j, t = r["jax"], r["port"]
    assert t["rc"] == j["rc"] and set(t["rc"]) == {0}
    assert t["n"] == j["n"] > 0 and t["it"] == j["it"]
    assert len(t["ev"]) == len(j["ev"]) == 1 and t["ev"][0] > 0.8
    _close(j["ev"], t["ev"])
    assert_same_trees(j["bst"], t["bst"], j["n"])
    _close(j["pred"], t["pred"])
    np.testing.assert_allclose(t["pred"], t["pred2"], rtol=1e-12)


def _streaming_flow(c):
    X, y = _data(n=3000)
    dh, bh = [0], [0]
    rc = [c.LGBM_DatasetCreateFromSampledColumn(X[:1000], len(X),
                                                "max_bin=63", dh),
          c.LGBM_DatasetPushRows(dh[0], X[:1500], 0),
          c.LGBM_DatasetPushRows(dh[0], X[1500:], 1500),
          c.LGBM_DatasetSetField(dh[0], "label", y)]
    out = [0]
    rc.append(c.LGBM_DatasetGetNumData(dh[0], out))
    rc.append(c.LGBM_BoosterCreate(
        dh[0], "objective=binary num_leaves=7 verbosity=-1" + GROW, bh))
    fin = [0]
    rc.append(c.LGBM_BoosterUpdateOneIter(bh[0], fin))
    return {"rc": rc, "n": out[0], "fin": fin[0], "bst": c._get(bh[0])}


def test_streaming_push_via_capi():
    r = _both(_streaming_flow)
    j, t = r["jax"], r["port"]
    assert t["rc"] == j["rc"] and set(t["rc"]) == {0}
    assert t["n"] == j["n"] == 3000 and t["fin"] == j["fin"]
    assert_same_trees(j["bst"], t["bst"], 1)


def _error_flow(c):
    out = [0]
    rc1 = c.LGBM_DatasetGetNumData(999999, out)
    msg = c.LGBM_GetLastError()
    rc2 = c.LGBM_DatasetSetField(999999, "label", [1.0])
    return rc1, "invalid handle" in msg, rc2


def test_error_protocol():
    r = _both(_error_flow)
    assert r["port"] == r["jax"] == (-1, True, -1)


def _custom_flow(c):
    X, y = _data(n=1000)
    dh, bh = [0], [0]
    rc = [c.LGBM_DatasetCreateFromMat(X, "", y, dh),
          c.LGBM_BoosterCreate(
              dh[0], "objective=regression num_leaves=7 verbosity=-1" + GROW,
              bh)]
    bst = c._get(bh[0])
    score = np.zeros(len(y), np.float32)
    fin = [0]
    for _ in range(3):
        grad = score - y
        hess = np.ones_like(grad)
        rc.append(c.LGBM_BoosterUpdateOneIterCustom(bh[0], grad, hess, fin))
        score = bst.predict(X, raw_score=True).astype(np.float32)
    return {"rc": rc, "score": score, "bst": bst,
            "mse": float(np.mean((score - y) ** 2)),
            "mse0": float(np.mean((0 - y) ** 2))}


def test_custom_objective_update():
    r = _both(_custom_flow)
    j, t = r["jax"], r["port"]
    assert t["rc"] == j["rc"] and set(t["rc"]) == {0}
    assert t["mse"] < t["mse0"]
    assert_same_trees(j["bst"], t["bst"], 3)
    _close(j["score"], t["score"])


def _surface_flow(c, tmp_path, tag):
    from scipy import sparse
    X, y = _data(1200, 6)
    sp = sparse.csr_matrix(X)
    dh, bh = [0], [0]
    o = {}
    rc = [c.LGBM_DatasetCreateFromCSR(
        sp.indptr, sp.indices, sp.data, X.shape[0], X.shape[1],
        "max_bin=31 min_data_in_leaf=5", y, 0, dh)]
    nd = [0]
    rc.append(c.LGBM_DatasetGetNumData(dh[0], nd))
    o["nd"] = nd[0]
    rc.append(c.LGBM_BoosterCreate(
        dh[0], "objective=binary num_leaves=7 verbosity=-1 metric=auc"
        + GROW, bh))
    fin = [0]
    for _ in range(5):
        rc.append(c.LGBM_BoosterUpdateOneIter(bh[0], fin))
    names, cnt = [], [0]
    rc += [c.LGBM_BoosterGetEvalCounts(bh[0], cnt),
           c.LGBM_BoosterGetEvalNames(bh[0], names)]
    o["eval_names"], o["eval_count"] = list(names), cnt[0]
    fnames, nf = [], [0]
    rc += [c.LGBM_BoosterGetNumFeature(bh[0], nf),
           c.LGBM_BoosterGetFeatureNames(bh[0], fnames)]
    o["nf"], o["fnames"] = nf[0], list(fnames)
    p_mat, p_csr, p_row, p_mats = [None], [None], [None], [None]
    s8 = sparse.csr_matrix(X[:8])
    rc += [c.LGBM_BoosterPredictForMat(bh[0], X[:8], 0, -1, p_mat),
           c.LGBM_BoosterPredictForCSR(bh[0], s8.indptr, s8.indices,
                                       s8.data, 8, 6, 0, -1, p_csr),
           c.LGBM_BoosterPredictForMatSingleRow(bh[0], X[0], 0, -1, p_row),
           c.LGBM_BoosterPredictForMats(bh[0], [X[0], X[1]], 0, -1, p_mats)]
    o.update(p_mat=p_mat[0], p_csr=p_csr[0], p_row=p_row[0],
             p_mats=p_mats[0])
    out = [0]
    rc.append(c.LGBM_BoosterCalcNumPredict(bh[0], 10, 2, -1, out))
    o["calc_leaf"] = out[0]
    rc.append(c.LGBM_BoosterCalcNumPredict(bh[0], 10, 3, -1, out))
    o["calc_contrib"] = out[0]
    js, imp = [None], [None]
    rc += [c.LGBM_BoosterDumpModel(bh[0], 0, -1, js),
           c.LGBM_BoosterFeatureImportance(bh[0], -1, 0, imp)]
    o["dump_trees"] = len(json.loads(js[0])["tree_info"])
    o["imp"] = imp[0]
    lo, hi, lv, lv2 = [0.0], [0.0], [0.0], [0.0]
    rc += [c.LGBM_BoosterGetLowerBoundValue(bh[0], lo),
           c.LGBM_BoosterGetUpperBoundValue(bh[0], hi),
           c.LGBM_BoosterGetLeafValue(bh[0], 0, 0, lv)]
    o["lo"], o["hi"], o["lv"] = lo[0], hi[0], lv[0]
    rc += [c.LGBM_BoosterSetLeafValue(bh[0], 0, 0, lv[0] + 1.0),
           c.LGBM_BoosterGetLeafValue(bh[0], 0, 0, lv2)]
    o["lv2"] = lv2[0]
    p_after = [None]
    rc.append(c.LGBM_BoosterPredictForMat(bh[0], X[:8], 1, -1, p_after))
    o["p_after_set_leaf"] = p_after[0]
    npred, scores = [0], [None]
    rc += [c.LGBM_BoosterGetNumPredict(bh[0], 0, npred),
           c.LGBM_BoosterGetPredict(bh[0], 0, scores)]
    o["npred"], o["scores"] = npred[0], scores[0]
    o["text"] = c._get(bh[0]).model_to_string()
    bh2, total = [0], [0]
    rc += [c.LGBM_BoosterCreate(
        dh[0], "objective=binary num_leaves=7 verbosity=-1" + GROW, bh2),
        c.LGBM_BoosterUpdateOneIter(bh2[0], fin),
        c.LGBM_BoosterMerge(bh[0], bh2[0]),
        c.LGBM_BoosterNumberOfTotalModel(bh[0], total),
        c.LGBM_BoosterShuffleModels(bh[0], 0, -1)]
    o["total"] = total[0]
    sub = [0]
    rc += [c.LGBM_DatasetGetSubset(dh[0], np.arange(100, 300), "", sub),
           c.LGBM_DatasetGetNumData(sub[0], nd)]
    o["sub_n"] = nd[0]
    ref_stream = [0]
    s2 = sparse.csr_matrix(X[60:100])
    rc += [c.LGBM_DatasetCreateByReference(dh[0], 100, ref_stream),
           c.LGBM_DatasetPushRows(ref_stream[0], X[:60], None),
           c.LGBM_DatasetPushRowsByCSR(ref_stream[0], s2.indptr, s2.indices,
                                       s2.data, 40, None),
           c.LGBM_DatasetGetNumData(ref_stream[0], nd)]
    o["ref_n"] = nd[0]
    o["param_ok"] = c.LGBM_DatasetUpdateParamChecking(
        "max_bin=31", "max_bin=31 learning_rate=0.2")
    o["param_bad"] = c.LGBM_DatasetUpdateParamChecking("max_bin=31",
                                                       "max_bin=63")
    o["param_msg"] = "max_bin" in c.LGBM_GetLastError()
    data_f = tmp_path / f"{tag}_pred_in.csv"
    np.savetxt(data_f, X[:10], delimiter=",", fmt="%.6f")
    out_f = tmp_path / f"{tag}_pred_out.txt"
    rc.append(c.LGBM_BoosterPredictForFile(bh[0], str(data_f), 0, 0, -1,
                                           str(out_f)))
    o["file_pred"] = np.loadtxt(out_f)
    field, got_names = [None], []
    rc += [c.LGBM_DatasetGetField(dh[0], "label", field),
           c.LGBM_DatasetSetFeatureNames(dh[0], [f"f{i}" for i in range(6)]),
           c.LGBM_DatasetGetFeatureNames(dh[0], got_names),
           c.LGBM_DatasetDumpText(dh[0], str(tmp_path / f"{tag}_dump.txt"))]
    o["field_n"], o["got_names"] = field[0].shape[0], list(got_names)
    o["dump"] = (tmp_path / f"{tag}_dump.txt").read_text()
    o["net_one"] = c.LGBM_NetworkInit(f"{socket.gethostname()}:12400",
                                      12400, 120, 1)
    o["net_two"] = c.LGBM_NetworkInit("10.255.1.1:1,10.255.1.2:2", 12400,
                                      120, 2)
    o["net_msg"] = "matches this host" in c.LGBM_GetLastError()
    o["net_free"] = c.LGBM_NetworkFree()
    o["net_fun"] = c.LGBM_NetworkInitWithFunctions(2, 0, None, None)
    o["net_fun_msg"] = "NetworkInitWithFunctions" in c.LGBM_GetLastError()
    o["rc"] = rc
    return o


def test_round4_capi_surface(tmp_path):
    from lightgbm_tpu_torch.model_text import load_model_from_string
    r = {name: _surface_flow(c, tmp_path, name)
         for name, c in PACKAGES.items()}
    j, t = r["jax"], r["port"]
    assert t["rc"] == j["rc"] and set(t["rc"]) == {0}
    for key in ("nd", "eval_names", "eval_count", "nf", "fnames",
                "calc_leaf", "calc_contrib", "dump_trees", "npred", "total",
                "sub_n", "ref_n", "param_ok", "param_bad", "param_msg",
                "field_n", "got_names", "net_one", "net_two", "net_msg",
                "net_free", "net_fun_msg"):
        assert t[key] == j[key], key
    assert (t["nd"], t["eval_names"], t["nf"], t["calc_leaf"],
            t["calc_contrib"], t["total"], t["sub_n"]) == (
                1200, ["auc"], 6, 50, 70, 6, 200)
    assert t["net_fun"] != 0 and j["net_fun"] != 0
    assert t["param_bad"] == -1 and t["param_ok"] == 0
    # the five trees before the leaf edit and the merge
    jm = load_model_from_string(j["text"])["models"]
    tm = load_model_from_string(t["text"])["models"]
    assert [m.num_leaves for m in jm] == [m.num_leaves for m in tm]
    for key in ("p_mat", "p_csr", "p_mats", "p_after_set_leaf",
                "file_pred", "lo", "hi", "lv", "lv2"):
        _close(j[key], t[key], rtol=1e-4 if key != "file_pred" else 1e-5)
    _close(t["p_csr"], t["p_mat"], rtol=1e-6)
    _close(t["p_row"][0], t["p_mat"][0], rtol=1e-6)
    _close(t["p_mats"], t["p_mat"][:2], rtol=1e-6)
    assert abs(t["lv2"] - t["lv"] - 1.0) < 1e-9
    _close(j["scores"], t["scores"])
    np.testing.assert_array_equal(t["imp"], j["imp"])
    assert t["dump"] == j["dump"]


def _reset_flow(c):
    X, y = _data(1500, 4, seed=3)
    dh, bh = [0], [0]
    rc = [c.LGBM_DatasetCreateFromMat(X, "max_bin=31 free_raw_data=false",
                                      y, dh),
          c.LGBM_BoosterCreate(
              dh[0], "objective=binary num_leaves=7 verbosity=-1 "
              "metric=binary_logloss" + GROW, bh)]
    fin = [0]
    for _ in range(5):
        rc.append(c.LGBM_BoosterUpdateOneIter(bh[0], fin))
    ev0, ev1, ev2 = [], [], []
    rc.append(c.LGBM_BoosterGetEval(bh[0], 0, ev0))
    X2, y2 = _data(1500, 4, seed=4)
    dh2 = [0]
    rc += [c.LGBM_DatasetCreateFromMat(X2, "max_bin=31 free_raw_data=false",
                                       y2, dh2),
           c.LGBM_BoosterResetTrainingData(bh[0], dh2[0]),
           c.LGBM_BoosterGetEval(bh[0], 0, ev1)]
    for _ in range(3):
        rc.append(c.LGBM_BoosterUpdateOneIter(bh[0], fin))
    total = [0]
    rc += [c.LGBM_BoosterGetEval(bh[0], 0, ev2),
           c.LGBM_BoosterNumberOfTotalModel(bh[0], total)]
    return {"rc": rc, "ev": (ev0[0], ev1[0], ev2[0]), "total": total[0],
            "bst": c._get(bh[0])}


def test_reset_training_data_replays_scores():
    r = _both(_reset_flow)
    j, t = r["jax"], r["port"]
    assert t["rc"] == j["rc"] and set(t["rc"]) == {0}
    assert t["total"] == j["total"] == 8
    ev0, ev1, ev2 = t["ev"]
    assert ev1 < 0.6 and ev2 < ev1
    _close(j["ev"], t["ev"])
    assert_same_trees(j["bst"], t["bst"], 8)


def _names_flow(c):
    X, y = _data(1000, 4, seed=5)
    dh, bh = [0], [0]
    rc = [c.LGBM_DatasetCreateFromMat(X, "max_bin=31 free_raw_data=false",
                                      y, dh),
          c.LGBM_BoosterCreate(dh[0], "objective=binary num_leaves=7 "
                               "verbosity=-1 metric=binary_logloss" + GROW,
                               bh)]
    names, cnt = [], [0]
    rc.append(c.LGBM_BoosterGetEvalNames(bh[0], names))
    first = list(names)
    rc += [c.LGBM_BoosterResetParameter(bh[0], "metric=auc,binary_error"),
           c.LGBM_BoosterGetEvalNames(bh[0], names)]
    second = list(names)
    rc.append(c.LGBM_BoosterGetEvalCounts(bh[0], cnt))
    bst = c._get(bh[0])
    bst.set_attr(note="kept")
    bst.set_train_data_name("mytrain")
    fin = [0]
    rc.append(c.LGBM_BoosterUpdateOneIter(bh[0], fin))
    X2, y2 = _data(1000, 4, seed=6)
    dh2 = [0]
    rc += [c.LGBM_DatasetCreateFromMat(X2, "max_bin=31 free_raw_data=false",
                                       y2, dh2),
           c.LGBM_BoosterResetTrainingData(bh[0], dh2[0])]
    bst = c._get(bh[0])
    rc.append(c.LGBM_BoosterGetEvalNames(bh[0], names))
    ev = []
    rc.append(c.LGBM_BoosterGetEval(bh[0], 0, ev))
    return {"rc": rc, "names": (first, second, list(names)),
            "count": cnt[0], "attr": bst.attr("note"),
            "train_name": bst._train_data_name, "ev": ev}


def test_eval_names_follow_parameter_and_data_resets():
    r = _both(_names_flow)
    j, t = r["jax"], r["port"]
    assert t["rc"] == j["rc"] and set(t["rc"]) == {0}
    assert t["names"] == j["names"] == (
        ["binary_logloss"], ["auc", "binary_error"], ["auc", "binary_error"])
    assert t["count"] == j["count"] == 2
    assert t["attr"] == j["attr"] == "kept"
    assert t["train_name"] == j["train_name"] == "mytrain"
    _close(j["ev"], t["ev"])


def test_handles_follow_device_type():
    """``device_type`` in a parameter string (alias ``device``) picks the
    device; an unknown one fails through the error protocol; a Booster of
    a Dataset handle takes the Dataset's device."""
    X, y = _data(300, 4)
    dh, bh = [0], [0]
    assert tcapi.LGBM_DatasetCreateFromMat(X, "device_type=cpu", y, dh) == 0
    assert tcapi._get(dh[0]).device.type == "cpu"
    assert tcapi.LGBM_BoosterCreate(
        dh[0], "objective=binary num_leaves=7 verbosity=-1", bh) == 0
    assert tcapi._get(bh[0]).device.type == "cpu"
    assert tcapi.LGBM_DatasetCreateFromMat(X, "device=quantum", y, dh) == -1
    assert "device_type" in tcapi.LGBM_GetLastError()
    import torch
    if not torch.cuda.is_available():
        # unset, tpu, gpu and cuda all ask for the card, which is absent
        for p in ("", "device_type=tpu", "device=gpu", "device_type=cuda"):
            assert tcapi.LGBM_DatasetCreateFromMat(X, p, y, dh) == -1
            assert "CUDA" in tcapi.LGBM_GetLastError()
        text = [None]
        assert tcapi.LGBM_BoosterSaveModelToString(bh[0], text) == 0
        it, nh = [0], [0]
        assert tcapi.LGBM_BoosterLoadModelFromString(text[0], it, nh) == -1
        assert tcapi.LGBM_BoosterLoadModelFromString(
            text[0], it, nh, device="cpu") == 0 and it[0] == 0


def test_same_functions_and_positional_signatures():
    """Every ``LGBM_*`` function of the JAX package's module, with its
    positional parameters; the port adds only the keyword-only
    ``device``."""
    jnames = sorted(n for n in dir(jcapi) if n.startswith("LGBM_"))
    tnames = sorted(n for n in dir(tcapi) if n.startswith("LGBM_"))
    assert tnames == jnames and len(jnames) >= 60
    for name in jnames:
        jp = inspect.signature(inspect.unwrap(getattr(jcapi, name)))
        tp = inspect.signature(inspect.unwrap(getattr(tcapi, name)))
        pos = [p for p in tp.parameters.values()
               if p.kind is not p.KEYWORD_ONLY]
        assert [(p.name, p.default) for p in pos] == [
            (p.name, p.default) for p in jp.parameters.values()], name
        assert {p.name for p in tp.parameters.values()
                if p.kind is p.KEYWORD_ONLY} <= {"device"}, name
