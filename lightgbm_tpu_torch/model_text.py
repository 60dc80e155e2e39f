"""Model text (de)serialization, reference-format compatible (counterpart
of ``lightgbm_tpu/model_text.py``).

reference: src/boosting/gbdt_model_text.cpp — SaveModelToString (:301),
LoadModelFromString (:405), Tree::ToString (src/io/tree.cpp:560+),
Tree::Tree(const char*) text parsing ctor.  Text saved by the JAX package
loads here and saves back as the same text.  ``model_to_if_else`` writes
the model as standalone C++ (reference: ModelToIfElse,
gbdt_model_text.cpp:117), the same source as the JAX package's.
"""

from __future__ import annotations

import json
from typing import Dict, List

import numpy as np

from .tree import HostTree

MODEL_VERSION = "v3"


def _arr2str(arr, fmt="{:g}") -> str:
    return " ".join(fmt.format(x) for x in arr)


def _arr2str_precise(arr) -> str:
    return " ".join(repr(float(x)) for x in arr)


def tree_to_string(t: HostTree) -> str:
    nl = t.num_leaves
    ns = max(nl - 1, 0)
    lines = [f"num_leaves={nl}", f"num_cat={t.num_cat}"]
    lines.append("split_feature=" + _arr2str(t.split_feature[:ns], "{:d}"))
    lines.append("split_gain=" + _arr2str(t.split_gain[:ns]))
    lines.append("threshold=" + _arr2str_precise(t.threshold[:ns]))
    lines.append("decision_type=" + _arr2str(t.decision_type[:ns], "{:d}"))
    lines.append("left_child=" + _arr2str(t.left_child[:ns], "{:d}"))
    lines.append("right_child=" + _arr2str(t.right_child[:ns], "{:d}"))
    lines.append("leaf_value=" + _arr2str_precise(t.leaf_value[:nl]))
    lines.append("leaf_weight=" + _arr2str(t.leaf_weight[:nl]))
    lines.append("leaf_count=" + _arr2str(t.leaf_count[:nl].astype(np.int64), "{:d}"))
    lines.append("internal_value=" + _arr2str(t.internal_value[:ns]))
    lines.append("internal_weight=" + _arr2str(t.internal_weight[:ns]))
    lines.append("internal_count=" + _arr2str(t.internal_count[:ns].astype(np.int64), "{:d}"))
    if t.num_cat > 0:
        lines.append("cat_boundaries=" + _arr2str(t.cat_boundaries, "{:d}"))
        lines.append("cat_threshold=" + _arr2str(t.cat_threshold, "{:d}"))
    lines.append(f"shrinkage={t.shrinkage:g}")
    lines.append("")
    return "\n".join(lines)


def save_model_to_string(booster, num_iteration=None,
                         start_iteration: int = 0) -> str:
    """booster: anything with the loaded-model attributes of
    ``basic.Booster`` (``models``, ``num_class``, ``feature_names``, ...).

    ``num_iteration``/``start_iteration`` slice whole boosting iterations
    (reference: GBDT::SaveModelToString start_iteration/num_iteration,
    gbdt_model_text.cpp:301; num_iteration <= 0 means all remaining).
    """
    b = booster
    K = max(b.num_tree_per_iteration, 1)
    total_iter = len(b.models) // K
    start = max(0, int(start_iteration))
    if num_iteration is None or num_iteration <= 0:
        stop = total_iter
    else:
        stop = min(total_iter, start + int(num_iteration))
    models = b.models[start * K: stop * K]
    ss: List[str] = []
    ss.append(b.sub_model_name)
    ss.append(f"version={MODEL_VERSION}")
    ss.append(f"num_class={b.num_class}")
    ss.append(f"num_tree_per_iteration={b.num_tree_per_iteration}")
    ss.append(f"label_index={b.label_index}")
    ss.append(f"max_feature_idx={b.max_feature_idx}")
    if b.objective_name:
        ss.append(f"objective={b.objective_name}")
    if b.average_output:
        ss.append("average_output")
    ss.append("feature_names=" + " ".join(b.feature_names))
    ss.append("feature_infos=" + " ".join(b.feature_infos))

    tree_strs = []
    for i, t in enumerate(models):
        tree_strs.append(f"Tree={i}\n" + tree_to_string(t) + "\n")
    sizes = [len(s) for s in tree_strs]
    ss.append("tree_sizes=" + " ".join(map(str, sizes)))
    ss.append("")
    out = "\n".join(ss) + "\n" + "".join(tree_strs)
    out += "end of trees\n"
    # feature importances
    imp = b.feature_importance_int()
    pairs = sorted([(v, n) for n, v in imp if v > 0], key=lambda p: -p[0])
    out += "\nfeature_importances:\n"
    for v, n in pairs:
        out += f"{n}={v}\n"
    if b.params_str:
        out += "\nparameters:\n" + b.params_str + "\nend of parameters\n"
    return out


def parse_tree(block: str) -> HostTree:
    kv: Dict[str, str] = {}
    for line in block.splitlines():
        line = line.strip()
        if "=" in line:
            k, v = line.split("=", 1)
            kv[k] = v

    def geti(key, default=None):
        if key not in kv:
            return default
        s = kv[key].split()
        return np.asarray([int(float(x)) for x in s], np.int64) if s else np.zeros(0, np.int64)

    def getf(key):
        if key not in kv or not kv[key].strip():
            return np.zeros(0, np.float64)
        return np.asarray([float(x) for x in kv[key].split()], np.float64)

    nl = int(kv["num_leaves"])
    num_cat = int(kv.get("num_cat", 0))
    ns = max(nl - 1, 0)
    split_feature = geti("split_feature", np.zeros(0, np.int64)).astype(np.int32)
    return HostTree(
        num_leaves=nl,
        split_feature=split_feature,
        split_feature_inner=split_feature.copy(),
        threshold=getf("threshold"),
        threshold_in_bin=np.zeros(ns, np.int32),
        decision_type=geti("decision_type", np.zeros(ns, np.int64)).astype(np.int8)
        if "decision_type" in kv else np.zeros(ns, np.int8),
        left_child=geti("left_child", np.zeros(0, np.int64)).astype(np.int32),
        right_child=geti("right_child", np.zeros(0, np.int64)).astype(np.int32),
        split_gain=getf("split_gain"),
        internal_value=getf("internal_value"),
        internal_weight=getf("internal_weight") if "internal_weight" in kv else np.zeros(ns),
        internal_count=getf("internal_count"),
        leaf_value=getf("leaf_value"),
        leaf_weight=getf("leaf_weight") if "leaf_weight" in kv else np.zeros(nl),
        leaf_count=getf("leaf_count"),
        num_cat=num_cat,
        cat_boundaries=geti("cat_boundaries", np.zeros(1, np.int64)).astype(np.int32),
        cat_threshold=geti("cat_threshold", np.zeros(0, np.int64)).astype(np.uint32),
        shrinkage=float(kv.get("shrinkage", 1.0)),
        real_feature_index=split_feature.copy(),
    )


def load_model_from_string(s: str) -> dict:
    """Parse a reference-format model string into a dict of attributes +
    HostTree list."""
    header, sep, rest = s.partition("tree_sizes=")
    if not sep:
        # tree_sizes is advisory (the reference re-parses on mismatch,
        # gbdt_model_text.cpp LoadModelFromString) — a model string
        # without it still loads by scanning the Tree= blocks
        i = s.find("Tree=")
        header, rest = (s[:i], "sizes\n" + s[i:]) if i >= 0 else (s, "")
    lines = header.splitlines()
    out = {
        "sub_model_name": lines[0].strip() if lines else "tree",
        "num_class": 1, "num_tree_per_iteration": 1, "label_index": 0,
        "max_feature_idx": 0, "objective_name": "", "average_output": False,
        "feature_names": [], "feature_infos": [], "params_str": "",
    }
    for ln in lines[1:]:
        ln = ln.strip()
        if ln == "average_output":
            out["average_output"] = True
        elif ln.startswith("num_class="):
            out["num_class"] = int(ln.split("=", 1)[1])
        elif ln.startswith("num_tree_per_iteration="):
            out["num_tree_per_iteration"] = int(ln.split("=", 1)[1])
        elif ln.startswith("label_index="):
            out["label_index"] = int(ln.split("=", 1)[1])
        elif ln.startswith("max_feature_idx="):
            out["max_feature_idx"] = int(ln.split("=", 1)[1])
        elif ln.startswith("objective="):
            out["objective_name"] = ln.split("=", 1)[1]
        elif ln.startswith("feature_names="):
            out["feature_names"] = ln.split("=", 1)[1].split()
        elif ln.startswith("feature_infos="):
            out["feature_infos"] = ln.split("=", 1)[1].split()

    body = rest.partition("\n")[2]
    trees_part, _, tail = body.partition("end of trees")
    models = []
    for block in trees_part.split("Tree="):
        block = block.strip()
        if not block:
            continue
        block = block.partition("\n")[2]  # drop tree index line remainder
        if "num_leaves=" in block:
            models.append(parse_tree(block))
    out["models"] = models
    if "parameters:" in tail:
        pstr = tail.partition("parameters:")[2].partition("end of parameters")[0]
        out["params_str"] = pstr.strip()
    # category value lists (reference: _load_pandas_categorical, basic.py:395)
    key = "pandas_categorical:"
    pos = s.rfind(key)
    if pos >= 0:
        try:
            out["pandas_categorical"] = json.loads(
                s[pos + len(key):].partition("\n")[0])
        except ValueError:
            out["pandas_categorical"] = None
    return out


def _tree_to_if_else(t: HostTree, idx: int) -> str:
    """One tree as a C++ function (reference: gbdt_model_text.cpp:117
    ModelToIfElse / Tree::ToIfElse, src/io/tree.cpp)."""
    lines = [f"double PredictTree{idx}(const double* arr) {{"]

    # explicit work stack — deep unbalanced trees (depth > ~1000) would
    # overflow Python recursion
    if t.num_leaves <= 1:
        val = t.leaf_value[0] if len(t.leaf_value) else 0.0
        lines.append(f"  return {float(val)!r};")
        lines.append("}")
        return "\n".join(lines)

    stack = [("node", 0, 0)]
    while stack:
        kind, a, depth = stack.pop()
        pad = "  " * (depth + 1)
        if kind == "text":
            lines.append(a)
            continue
        node = a
        if node < 0:
            lines.append(f"{pad}return {float(t.leaf_value[~node])!r};")
            continue
        f = int(t.split_feature[node])
        dt = int(t.decision_type[node])
        left, right = int(t.left_child[node]), int(t.right_child[node])
        if dt & 1:  # categorical: bitset membership goes left
            cat_idx = int(t.threshold[node])
            lo, hi = int(t.cat_boundaries[cat_idx]), int(t.cat_boundaries[cat_idx + 1])
            words = ",".join(f"{int(w)}u" for w in t.cat_threshold[lo:hi])
            nw = hi - lo
            lines.append(
                f"{pad}{{ static const uint32_t bits[] = {{{words}}};"
                f" int iv = std::isnan(arr[{f}]) ? -1 : (int)arr[{f}];"
                f" if (iv >= 0 && iv < {nw * 32} && ((bits[iv / 32] >> (iv % 32)) & 1)) {{")
            close = f"{pad}}} }}"
        else:
            missing_type = (dt >> 2) & 3
            default_left = bool(dt & 2)
            thr = repr(float(t.threshold[node]))
            v = f"arr[{f}]"
            if missing_type == 2:       # NaN-aware
                cond = (f"(std::isnan({v}) ? {str(default_left).lower()} : "
                        f"{v} <= {thr})")
            elif missing_type == 1:     # zero as missing
                zv = f"(std::isnan({v}) ? 0.0 : {v})"
                cond = (f"(std::fabs({zv}) <= 1e-35 ? {str(default_left).lower()} : "
                        f"{zv} <= {thr})")
            else:
                cond = f"((std::isnan({v}) ? 0.0 : {v}) <= {thr})"
            lines.append(f"{pad}if ({cond}) {{")
            close = f"{pad}}}"
        stack.extend(reversed([
            ("node", left, depth + 1),
            ("text", f"{pad}}} else {{", 0),
            ("node", right, depth + 1),
            ("text", close, 0),
        ]))
    lines.append("}")
    return "\n".join(lines)


def model_to_if_else(booster) -> str:
    """Standalone C++ source evaluating the model
    (reference: ModelToIfElse, gbdt_model_text.cpp:117)."""
    models = booster.models
    K = booster.num_tree_per_iteration
    avg = getattr(booster, "average_output", False)
    parts = ["#include <cmath>", "#include <cstdint>", ""]
    for i, t in enumerate(models):
        parts.append(_tree_to_if_else(t, i))
        parts.append("")
    n_iter = len(models) // max(K, 1)
    parts.append("extern \"C\" void Predict(const double* features, "
                 "double* output) {")
    for k in range(K):
        calls = " + ".join(f"PredictTree{it * K + k}(features)"
                           for it in range(n_iter)) or "0.0"
        scale = f" / {n_iter}.0" if (avg and n_iter) else ""
        parts.append(f"  output[{k}] = ({calls}){scale};")
    parts.append("}")
    return "\n".join(parts)
