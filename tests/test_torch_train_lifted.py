"""The configurations the port once refused (monotone constraints, extra
trees, bynode sampling) train the JAX package's trees on
test_torch_train.py's data.  (Moved out of test_torch_train.py so that
parallel test workers take the files apart.)
"""

import numpy as np
import pytest

import lightgbm_tpu as lgb

import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch.model_text import load_model_from_string
from lightgbm_tpu_torch.testing import one_thread  # noqa: F401

from test_torch_train import BASE, TREE_EXACT, _data


@pytest.mark.parametrize("params", [
    {"monotone_constraints": [1, 0, 0, 0, -1, 0]},
    {"extra_trees": True},
    {"feature_fraction_bynode": 0.5},
], ids=["monotone", "extra_trees", "bynode"])
def test_lifted_configurations_train_like_the_reference(params):
    """The configurations the port once refused train the JAX package's
    trees (tests/test_torch_monotone.py and tests/test_torch_random.py
    cover them in depth): the same structure, leaf values within 1e-5
    (measured: 8.0e-6 on a leaf of 0.049 under extra trees)."""
    X, y = _data(1, 2000, "binary")
    p = {**BASE, "objective": "binary", **params}
    bj = lgb.train(dict(p), lgb.Dataset(X, label=y), 3, verbose_eval=False)
    bt = lt.train(dict(p), lt.Dataset(X, label=y, device="cpu"), 3,
                  verbose_eval=False)
    jm = load_model_from_string(bj.model_to_string())["models"]
    tm = load_model_from_string(bt.model_to_string())["models"]
    assert len(jm) == len(tm) == 3
    for j, t in zip(jm, tm):
        for f in TREE_EXACT:
            assert np.array_equal(getattr(j, f), getattr(t, f)), f
        np.testing.assert_allclose(t.leaf_value, j.leaf_value, rtol=1e-4,
                                   atol=1e-5)
