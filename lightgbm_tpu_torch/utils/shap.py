"""Exact TreeSHAP, the unique-path algorithm (counterpart of
``lightgbm_tpu/utils/shap.py``, the same arithmetic in the same order).

reference: src/io/tree.cpp TreeSHAP / Tree::PredictContrib (tree.h:137),
Lundberg et al.'s algorithm 2.  Host-side, float64: ``tree_shap`` one
row by recursion, ``tree_shap_batch`` every row of a batch in one walk
of the tree (the path's features and zero fractions do not depend on
the row; its one fractions and weights become [n] vectors).
"""

from __future__ import annotations

import numpy as np


class _PathElement:
    __slots__ = ("feature_index", "zero_fraction", "one_fraction", "pweight")

    def __init__(self, f=-1, z=0.0, o=0.0, w=0.0):
        self.feature_index = f
        self.zero_fraction = z
        self.one_fraction = o
        self.pweight = w

    def copy(self):
        return _PathElement(self.feature_index, self.zero_fraction,
                            self.one_fraction, self.pweight)


def _extend(path, unique_depth, zero_fraction, one_fraction, feature_index):
    path.append(_PathElement(feature_index, zero_fraction, one_fraction,
                             1.0 if unique_depth == 0 else 0.0))
    for i in range(unique_depth - 1, -1, -1):
        path[i + 1].pweight += one_fraction * path[i].pweight * (i + 1) / (unique_depth + 1)
        path[i].pweight = zero_fraction * path[i].pweight * (unique_depth - i) / (unique_depth + 1)


def _unwind(path, unique_depth, path_index):
    one_fraction = path[path_index].one_fraction
    zero_fraction = path[path_index].zero_fraction
    next_one_portion = path[unique_depth].pweight
    for i in range(unique_depth - 1, -1, -1):
        if one_fraction != 0:
            tmp = path[i].pweight
            path[i].pweight = next_one_portion * (unique_depth + 1) / ((i + 1) * one_fraction)
            next_one_portion = tmp - path[i].pweight * zero_fraction * (unique_depth - i) / (unique_depth + 1)
        else:
            path[i].pweight = path[i].pweight * (unique_depth + 1) / (zero_fraction * (unique_depth - i))
    for i in range(path_index, unique_depth):
        path[i].feature_index = path[i + 1].feature_index
        path[i].zero_fraction = path[i + 1].zero_fraction
        path[i].one_fraction = path[i + 1].one_fraction
    path.pop()


def _unwound_sum(path, unique_depth, path_index):
    one_fraction = path[path_index].one_fraction
    zero_fraction = path[path_index].zero_fraction
    next_one_portion = path[unique_depth].pweight
    total = 0.0
    for i in range(unique_depth - 1, -1, -1):
        if one_fraction != 0:
            tmp = next_one_portion * (unique_depth + 1) / ((i + 1) * one_fraction)
            total += tmp
            next_one_portion = path[i].pweight - tmp * zero_fraction * ((unique_depth - i) / (unique_depth + 1))
        else:
            total += path[i].pweight / (zero_fraction * ((unique_depth - i) / (unique_depth + 1)))
    return total


def tree_shap(tree, x: np.ndarray, phi: np.ndarray) -> None:
    """Accumulate SHAP values of one sample into phi [num_features+1]."""

    def node_count(node):
        return tree.internal_count[node] if node >= 0 else tree.leaf_count[~node]

    def node_value(node):
        return tree.internal_value[node] if node >= 0 else tree.leaf_value[~node]

    def recurse(node, path, parent_zero, parent_one, parent_feature):
        unique_depth = len(path)
        path = [p.copy() for p in path]
        _extend(path, unique_depth, parent_zero, parent_one, parent_feature)
        if node < 0:  # leaf
            for i in range(1, unique_depth + 1):
                w = _unwound_sum(path, unique_depth, i)
                el = path[i]
                phi[el.feature_index] += w * (el.one_fraction - el.zero_fraction) * node_value(node)
            return
        hot = tree.left_child[node] if _goes_left(tree, x, node) else tree.right_child[node]
        cold = tree.right_child[node] if _goes_left(tree, x, node) else tree.left_child[node]
        hot_frac = node_count(hot) / max(node_count(node), 1e-30)
        cold_frac = node_count(cold) / max(node_count(node), 1e-30)
        incoming_zero, incoming_one = 1.0, 1.0
        path_index = 0
        feat = int(tree.split_feature[node])
        while path_index <= unique_depth:
            if path[path_index].feature_index == feat:
                break
            path_index += 1
        if path_index != unique_depth + 1:
            incoming_zero = path[path_index].zero_fraction
            incoming_one = path[path_index].one_fraction
            _unwind(path, unique_depth, path_index)
        recurse(hot, path, hot_frac * incoming_zero, incoming_one, feat)
        recurse(cold, path, cold_frac * incoming_zero, 0.0, feat)

    recurse(0, [], 1.0, 1.0, -1)
    # bias term: expected value
    phi[-1] += tree.expected_value()


def _goes_left(tree, x, node):
    fval = x[tree.split_feature[node]]
    return bool(np.asarray(tree._decide(np.array([fval]), node))[0])


def tree_shap_batch(tree, X: np.ndarray, phi: np.ndarray) -> None:
    """Accumulate SHAP values of a batch into phi [n, num_features+1].

    A row's path state at a leaf depends only on the directions it takes
    at the leaf's ancestors (its one fractions are 0 or 1), so each leaf
    computes the unwound sums once for each distinct direction pattern
    among the rows (a key of one bit an ancestor) and hands every row
    its pattern's values: the same operations on the same inputs, so the
    same bits as one computation a row."""
    n = X.shape[0]
    if tree.num_leaves <= 1:
        phi[:, -1] += tree.expected_value()
        return

    # precompute per-node go-left decision vectors [n]
    ns = tree.num_leaves - 1
    goes_left = np.zeros((ns, n), bool)
    for nd in range(ns):
        goes_left[nd] = tree._decide(X[:, tree.split_feature[nd]], nd)

    def node_count(node):
        return float(tree.internal_count[node] if node >= 0
                     else tree.leaf_count[~node])

    ones = np.ones(n)

    # path element arrays, parallel lists indexed by path position
    def recurse(node, feats, zeros, one_list, pw_list,
                parent_zero, parent_one, parent_feature, key, depth):
        ud = len(feats)  # unique_depth
        feats = feats + [parent_feature]
        zeros = zeros + [parent_zero]
        one_list = [o for o in one_list] + [parent_one]
        pw_list = [p.copy() for p in pw_list] + \
            [ones.copy() if ud == 0 else np.zeros(n)]
        for i in range(ud - 1, -1, -1):
            pw_list[i + 1] += parent_one * pw_list[i] * ((i + 1) / (ud + 1))
            pw_list[i] = parent_zero * pw_list[i] * ((ud - i) / (ud + 1))

        if node < 0:  # leaf: attribute along the unique path
            val = float(tree.leaf_value[~node])
            if not ud:
                return
            if depth < 63:
                _, reps, inv = np.unique(key, return_index=True,
                                         return_inverse=True)
            else:     # too deep for a 63-bit key: every row its own
                reps, inv = np.arange(n), np.arange(n)
            ones_r = [o[reps] for o in one_list]
            w = _unwound_sums_batch(zeros, ones_r,
                                    [p[reps] for p in pw_list], ud)
            for pi in range(1, ud + 1):
                phi[:, feats[pi]] += (w[pi - 1] * (ones_r[pi] - zeros[pi])
                                      * val)[inv]
            return

        feat = int(tree.split_feature[node])
        gl = goes_left[node]
        cnt = max(node_count(node), 1e-30)
        incoming_zero, incoming_one = 1.0, ones
        pi = 0
        while pi <= ud:
            if feats[pi] == feat:
                break
            pi += 1
        if pi != ud + 1:
            incoming_zero = zeros[pi]
            incoming_one = one_list[pi]
            feats, zeros, one_list, pw_list = _unwind_batch(
                feats, zeros, one_list, pw_list, ud, pi)
            ud -= 1
        for child, to_child in ((int(tree.left_child[node]), gl),
                                (int(tree.right_child[node]), ~gl)):
            frac = node_count(child) / cnt
            recurse(child, feats, zeros, one_list, pw_list,
                    frac * incoming_zero, incoming_one * to_child, feat,
                    key * 2 + to_child if depth < 63 else key, depth + 1)

    import sys
    limit = sys.getrecursionlimit()
    if limit < 4 * tree.num_leaves + 100:
        sys.setrecursionlimit(4 * tree.num_leaves + 100)
    recurse(0, [], [], [], [], 1.0, ones, -1, np.zeros(n, np.int64), 0)
    phi[:, -1] += tree.expected_value()


def _unwind_batch(feats, zeros, one_list, pw_list, ud, pi):
    of = one_list[pi]            # [n]
    zf = zeros[pi]               # scalar
    of_nz = of != 0
    of_safe = np.where(of_nz, of, 1.0)
    pw_list = [p.copy() for p in pw_list]
    next_one = pw_list[ud].copy()
    for i in range(ud - 1, -1, -1):
        tmp = pw_list[i]
        a = next_one * ((ud + 1) / (i + 1)) / of_safe
        b = tmp * (ud + 1) / (zf * (ud - i)) if zf != 0 else tmp * 0.0
        new_pw = np.where(of_nz, a, b)
        next_one = np.where(of_nz,
                            tmp - new_pw * zf * ((ud - i) / (ud + 1)),
                            next_one)
        pw_list[i] = new_pw
    # features/fractions shift left over the removed slot; pweights do NOT
    # shift — the loop above recomputed pw[0..ud-1] and the last is dropped
    # (mirrors scalar _unwind: in-place overwrite + path.pop())
    feats = feats[:pi] + feats[pi + 1:]
    zeros = zeros[:pi] + zeros[pi + 1:]
    one_list = one_list[:pi] + one_list[pi + 1:]
    pw_list = pw_list[:ud]
    return feats, zeros, one_list, pw_list


def _unwound_sums_batch(zeros, one_list, pw_list, ud):
    """The unwound path sums of every path index 1..ud at once, [ud, m]
    (``_unwound_sum``'s arithmetic, element by element in the same
    order, so the same bits as the JAX package's per-index batch)."""
    of = np.stack(one_list[1:ud + 1])
    zf = np.asarray(zeros[1:ud + 1], np.float64)[:, None]
    of_nz = of != 0
    of_safe = np.where(of_nz, of, 1.0)
    zf_nz = zf != 0
    zf_safe = np.where(zf_nz, zf, 1.0)
    next_one = np.broadcast_to(pw_list[ud], of.shape)
    total = np.zeros(of.shape)
    for i in range(ud - 1, -1, -1):
        a = next_one * ((ud + 1) / (i + 1)) / of_safe
        pw = pw_list[i]
        b = np.where(zf_nz, pw / (zf_safe * ((ud - i) / (ud + 1))), pw * 0.0)
        total += np.where(of_nz, a, b)
        next_one = np.where(of_nz, pw - a * zf * ((ud - i) / (ud + 1)),
                            next_one)
    return total
