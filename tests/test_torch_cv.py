"""``lightgbm_tpu_torch.cv`` held against ``lightgbm_tpu.cv`` on the CPU.

- The folds are equal for every mode: a shuffled plain split,
  stratified folds, whole queries of ranking data, and the caller's
  ``folds`` (pairs or a splitter).
- The results dict has the JAX package's keys, and each metric's mean
  and standard deviation agree to rtol=1e-4 (test_torch_train.py's bar
  for metrics: the two packages sum f32 histograms in different orders)
  plus 1e-7 absolute for a standard deviation near zero.
- Each fold trains on ``Dataset.subset``: fold 0's model equals a
  ``train`` on the same subset; ``return_cvbooster``, early stopping,
  ``fpreproc`` and the refusal of ``fused=True`` are the port's own.
  tests/test_engine.py's ``test_cv`` is mirrored on synthetic data.
"""

import numpy as np
import pytest

import lightgbm_tpu as lgb
from lightgbm_tpu.engine import _make_n_folds as jfolds

import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch.engine import _make_n_folds as tfolds
from lightgbm_tpu_torch.testing import one_thread  # noqa: F401

N = 1200
BASE = {"num_leaves": 7, "min_data_in_leaf": 10, "verbose": -1,
        "tpu_tree_growth": "rounds", "tpu_hist_method": "fused",
        "max_bin": 63}
BINARY = dict(BASE, objective="binary", metric=["auc", "binary_logloss"])
ROUNDS = 4


def _data(seed=5):
    rng = np.random.RandomState(seed)
    X = rng.randn(N, 6).astype(np.float32)
    y = ((X[:, 0] + 0.6 * X[:, 1] * X[:, 2] + 0.4 * rng.randn(N)) > 0)
    return X, y.astype(np.float32)


X, Y = _data()
GROUP = np.full(N // 40, 40)


def _port_ds(**kw):
    return lt.Dataset(X, label=Y, device="cpu", **kw)


@pytest.mark.parametrize("mode", ["plain", "unshuffled", "stratified",
                                  "query", "pairs", "splitter"])
def test_folds_equal_the_jax_package(mode):
    from sklearn.model_selection import KFold
    kw = dict(folds=None, nfold=4, params={}, seed=3, stratified=False,
              shuffle=True)
    group = None
    if mode == "unshuffled":
        kw["shuffle"] = False
    elif mode == "stratified":
        kw["stratified"] = True
    elif mode == "query":
        group = GROUP
    elif mode == "pairs":
        kw["folds"] = list(KFold(3, shuffle=True, random_state=1).split(X))
    elif mode == "splitter":
        kw["folds"] = KFold(3, shuffle=True, random_state=1)
    j = jfolds(lgb.Dataset(X, label=Y, group=group), **kw)
    t = tfolds(_port_ds(group=group), **kw)
    assert len(j) == len(t)
    for (a, b), (c, d) in zip(j, t):
        assert np.array_equal(a, c) and np.array_equal(b, d)


# one JAX cv (its trainings compile): stratified folds, the train
# metric and early stopping together
CV_CASES = {
    "stratified_train_metric": dict(nfold=3, stratified=True, seed=2,
                                    eval_train_metric=True,
                                    early_stopping_rounds=2),
}


@pytest.fixture(scope="session")
def jax_cv():
    return {name: lgb.cv(dict(BINARY), lgb.Dataset(X, label=Y), ROUNDS,
                         **kw) for name, kw in CV_CASES.items()}


@pytest.mark.parametrize("name", list(CV_CASES))
def test_results_equal_the_jax_package(jax_cv, name):
    got = lt.cv(dict(BINARY), _port_ds(), ROUNDS, **CV_CASES[name])
    want = jax_cv[name]
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert len(got[k]) == len(v), k
        np.testing.assert_allclose(got[k], v, rtol=1e-4, atol=1e-7,
                                   err_msg=k)


def test_fold_zero_equals_train_on_its_subset():
    res = lt.cv(dict(BINARY), _port_ds(), 3, nfold=3, stratified=False,
                seed=4, return_cvbooster=True)
    cvb = res["cvbooster"]
    assert len(cvb.boosters) == 3
    tr_idx, te_idx = tfolds(_port_ds(), None, 3, {}, 4, False, True)[0]
    full = _port_ds().construct()
    bst = lt.train(dict(BINARY), full.subset(tr_idx, dict(BINARY)), 3,
                   valid_sets=[full.subset(te_idx, dict(BINARY))],
                   verbose_eval=False)
    assert (cvb.boosters[0].model_to_string().partition("end of trees")[0]
            == bst.model_to_string().partition("end of trees")[0])
    aucs = [b.eval_valid()[0][2] for b in cvb.boosters]
    assert np.mean(aucs) == pytest.approx(res["auc-mean"][-1], rel=1e-12)
    assert cvb.num_trees() == [3, 3, 3]


def test_cv_mirrors_test_engine_cv():
    """tests/test_engine.py::test_cv on synthetic rows."""
    res = lt.cv({"objective": "binary", "metric": "binary_logloss",
                 "verbosity": -1}, _port_ds(), num_boost_round=5, nfold=3,
                stratified=True, shuffle=True)
    assert len(res["binary_logloss-mean"]) == 5
    assert res["binary_logloss-mean"][-1] < res["binary_logloss-mean"][0]


def test_query_folds_and_fpreproc():
    seen = []

    def fpreproc(tr, te, params):
        seen.append((tr.num_data, te.num_data))
        return tr, te, dict(params, learning_rate=0.2)

    rel = (np.arange(N) % 4).astype(np.float32)
    res = lt.cv(dict(BASE, objective="lambdarank", metric="ndcg",
                     eval_at=[3]),
                lt.Dataset(X, label=rel, group=GROUP, device="cpu"), 2,
                nfold=3, fpreproc=fpreproc)
    assert sorted(res) == ["ndcg@3-mean", "ndcg@3-stdv"]
    assert len(seen) == 3 and sum(te for _, te in seen) == N
    assert all(tr % 40 == 0 and te % 40 == 0 for tr, te in seen)


def test_fused_refused():
    """``fused=True`` was refused until the model axis was ported; it now
    steps the folds as lanes and returns the serial result bit for bit
    (tests/test_torch_multi.py holds it at more rounds)."""
    kw = dict(nfold=2, stratified=False)
    assert lt.cv(dict(BINARY), _port_ds(), 2, fused=True, **kw) == \
        lt.cv(dict(BINARY), _port_ds(), 2, **kw)
