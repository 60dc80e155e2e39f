"""A custom objective (``fobj``) and a custom metric (``feval``) in the
port held against ``lightgbm_tpu``: ``fobj`` returns binary logloss's
gradients in f64 from the f32 scores, so the objective becomes "none"
(no boost from average, no default metric, an empty objective line in
the model text) and the trees equal the JAX package's with the same
``fobj``; ``feval`` reports on the f64 scores.  Bars: tree structure
equal; leaf values to rtol 1e-4 or 2e-4 of the tree's largest |leaf|
(measured: 1.6e-5 on a leaf of 0.112, the tree's largest 0.158: a
gradient sum that cancels, summed in f32 by the JAX package and exactly
by the port); the custom metric to rtol 1e-4; raw predictions carried.
With three classes ``fobj`` takes and returns [K, n].  ``Booster.update``
refuses a training set other than its own.
"""

import numpy as np
import pytest
import torch

import lightgbm_tpu as lgb

import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch.utils.log import LightGBMError

from test_torch_objectives import (BASE, assert_same_trees, table,
                                   train_both)
from lightgbm_tpu_torch.testing import one_thread  # noqa: F401

ROUNDS = 4
PARAMS = dict(BASE, objective="binary")


def logloss_obj(score, dataset):
    p = 1.0 / (1.0 + np.exp(-np.asarray(score, np.float64)))
    y = dataset.get_label()
    return p - y, p * (1.0 - p)


def error_eval(score, dataset):
    return ("err", float(((score > 0) != dataset.get_label()).mean()),
            False)


@pytest.fixture(scope="module")
def trained():
    torch.exp(torch.randn(1 << 20))      # ROADMAP queue C (CPU exp)
    X, y = table(22, 2000, "binary")
    Xv, yv = table(23, 500, "binary")
    return (*train_both(PARAMS, X, y, Xv, yv, ROUNDS, fobj=logloss_obj,
                        feval=error_eval), Xv)


def test_trees_match(trained):
    bj, bt = trained[0], trained[1]
    assert bt.boosting.objective is None and bt.objective_name == ""
    assert "\nobjective=" not in bt.model_to_string()
    assert_same_trees(bj, bt, ROUNDS, atol_of_largest=2e-4)


def test_custom_metric_matches(trained):
    ev_j, ev_t = trained[2], trained[3]
    assert list(ev_t["valid_0"]) == ["err"]
    np.testing.assert_allclose(ev_t["valid_0"]["err"], ev_j["valid_0"]["err"],
                               rtol=1e-4)


def test_raw_predictions_carry(trained):
    bj, bt, Xv = trained[0], trained[1], trained[4]
    np.testing.assert_allclose(bt.predict(Xv, raw_score=True),
                               bj.predict(Xv, raw_score=True), rtol=1e-4,
                               atol=1e-6)
    back = lgb.Booster(model_str=bt.model_to_string())
    np.testing.assert_allclose(back.predict(Xv, raw_score=True),
                               bt.predict(Xv, raw_score=True), rtol=1e-5,
                               atol=1e-6)


def test_multiclass_fobj_takes_class_major_scores():
    X, y = table(24, 600, "class")
    seen = []

    def softmax_obj(score, dataset):
        seen.append(score.shape)
        e = np.exp(score - score.max(axis=0))
        p = e / e.sum(axis=0)
        onehot = np.eye(3)[dataset.get_label().astype(int)].T
        return (p - onehot).reshape(-1), (2 * p * (1 - p)).reshape(-1)
    bt = lt.train({**BASE, "num_class": 3}, lt.Dataset(X, label=y,
                                                       device="cpu"),
                  2, fobj=softmax_obj)
    assert seen == [(3, 600), (3, 600)]
    assert bt.num_trees() == 6


def test_update_refuses_another_train_set():
    X, y = table(25, 300, "binary")
    ds = lt.Dataset(X, label=y, device="cpu")
    bt = lt.Booster(PARAMS, train_set=ds)
    bt.update(train_set=ds, fobj=logloss_obj)
    # a train set binned with other bin mappers is refused; one binned
    # with the booster's (its reference) becomes the training data
    other = lt.Dataset(X[::-1].copy() * 2.0, label=y[::-1].copy(),
                       device="cpu").construct()
    with pytest.raises(LightGBMError, match="different bin mappers"):
        bt.update(train_set=other)
    assert bt.current_iteration() == 1
    aligned = lt.Dataset(X[::-1].copy(), label=y[::-1].copy(), device="cpu")
    bt.update(train_set=aligned, fobj=logloss_obj)
    assert bt.train_set is aligned and bt.current_iteration() == 2
