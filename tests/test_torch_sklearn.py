"""``lightgbm_tpu_torch.sklearn`` held against ``lightgbm_tpu.sklearn`` on
the CPU (``device="cpu"``): the regressor, the binary and multiclass
classifier (with ``class_weight``) and the ranker give the JAX
package's predictions to rtol=1e-4 (test_torch_train.py's bar; the two
packages sum f32 histograms in different orders) with 1e-6 absolute
for a probability near zero, and the same labels; the estimators pass
scikit-learn's ``clone``/``get_params`` round trip.
"""

import numpy as np
import pytest
from sklearn.base import clone

from lightgbm_tpu import sklearn as JS

from lightgbm_tpu_torch import sklearn as TS
from lightgbm_tpu_torch.testing import one_thread  # noqa: F401

KW = dict(n_estimators=4, num_leaves=7, min_child_samples=10,
          tpu_tree_growth="rounds", tpu_hist_method="fused", max_bin=63)
N = 800


def _rows(seed):
    rng = np.random.RandomState(seed)
    X = rng.randn(N, 5).astype(np.float32)
    return X, rng


X, RNG = _rows(9)
Y_REG = X[:, 0] - 0.5 * X[:, 1] + 0.2 * RNG.randn(N)
Y_BIN = np.where(X[:, 0] + 0.3 * RNG.randn(N) > 0, "yes", "no")
Y_MULTI = np.digitize(X[:, 0] + 0.3 * X[:, 2], [-0.5, 0.5])
Y_RANK = np.clip(np.round(X[:, 0] + 1.5), 0, 3).astype(int)
GROUP = [100] * (N // 100)

CASES = {
    "regressor": ("LGBMRegressor", Y_REG, {}, {}),
    "binary": ("LGBMClassifier", Y_BIN, {"class_weight": {"yes": 2.0}}, {}),
    "multiclass": ("LGBMClassifier", Y_MULTI,
                   {"class_weight": "balanced"}, {}),
    "ranker": ("LGBMRanker", Y_RANK, {}, {"group": GROUP}),
}


def _predict(est):
    if hasattr(est, "predict_proba"):
        return est.predict_proba(X), est.predict(X)
    return est.predict(X), None


@pytest.fixture(scope="session")
def jax_fits():
    out = {}
    for name, (cls, y, ctor, fit) in CASES.items():
        out[name] = _predict(getattr(JS, cls)(**KW, **ctor).fit(X, y, **fit))
    return out


@pytest.mark.parametrize("name", list(CASES))
def test_predictions_match_the_jax_package(jax_fits, name):
    cls, y, ctor, fit = CASES[name]
    est = getattr(TS, cls)(device="cpu", **KW, **ctor).fit(X, y, **fit)
    got, labels = _predict(est)
    want, want_labels = jax_fits[name]
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)
    if labels is not None:
        assert np.array_equal(labels, want_labels)
        assert set(labels) <= set(y)
    assert est.n_features_in_ == 5
    assert len(est.feature_importances_) == 5


@pytest.mark.parametrize("cls", ["LGBMRegressor", "LGBMClassifier",
                                 "LGBMRanker"])
def test_clone_and_get_params_round_trip(cls):
    est = getattr(TS, cls)(device="cpu", num_leaves=5, reg_lambda=0.5,
                           tpu_hist_method="fused")
    params = est.get_params()
    assert params["device"] == "cpu" and params["num_leaves"] == 5
    assert params["tpu_hist_method"] == "fused"
    twin = clone(est)
    assert twin is not est and twin.get_params() == params
    twin.set_params(num_leaves=9)
    assert twin.get_params()["num_leaves"] == 9
    with pytest.raises(Exception, match="fit"):
        twin.predict(X)


def test_eval_set_and_early_stopping():
    est = TS.LGBMClassifier(device="cpu", n_estimators=30, num_leaves=7,
                            min_child_samples=10)
    Xv, rng = _rows(10)
    yv = np.where(Xv[:, 0] + 0.3 * rng.randn(N) > 0, "yes", "no")
    est.fit(X, Y_BIN, eval_set=[(Xv, yv)], eval_metric="auc",
            early_stopping_rounds=3)
    assert 0 < est.best_iteration_ <= 30
    assert "auc" in est.evals_result_["valid_0"]
    assert est.score(Xv, yv) > 0.7
