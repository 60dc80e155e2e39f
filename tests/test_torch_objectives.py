"""Every objective of ``lightgbm_tpu_torch.objectives`` held against
``lightgbm_tpu.objectives`` on the same labels, weights and scores, and
the helpers the training tests of multiclass, ranking and the boosting
variants share (``tests/test_torch_multiclass.py`` and the files beside
it import them).

Bars:

- Gradients and hessians: l2 (with and without ``reg_sqrt``), l1,
  huber, fair, quantile and MAPE bit-equal (one subtraction, a sign, a
  select or a division in the same order); the objectives through
  ``exp`` within 4 ulps of the largest |value| of the vector (measured:
  at most 3.9, binary's and OVA's hessians; ROADMAP queue C-4), and
  weighted ``cross_entropy_lambda`` (a chain of exp, log1p and five
  divisions) within 256 (measured: 183).
- Softmax: ``torch.softmax`` against ``jax.nn.softmax`` within 4 ulps
  (measured: 3 ulps in 0.8% of the elements; the explicit form differed
  in 8%, ROADMAP queue C).
- ``boost_from_score`` (host f64): equal to 1e-12 relative, every class.
- ``convert_output``: within 4 ulps.
- The weighted percentile of the L1 family (``_percentile``): equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lightgbm_tpu as lgb
from lightgbm_tpu.config import Config as JConfig
from lightgbm_tpu.dataset import Metadata as JMeta
from lightgbm_tpu.objectives import _percentile as j_percentile
from lightgbm_tpu.objectives import create_objective as jcreate

import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch.config import Config as TConfig
from lightgbm_tpu_torch.convert import stacked_forest_from_numpy
from lightgbm_tpu_torch.dataset import Metadata as TMeta
from lightgbm_tpu_torch.model_text import load_model_from_string
from lightgbm_tpu_torch.objectives import _percentile as t_percentile
from lightgbm_tpu_torch.objectives import create_objective as tcreate
from lightgbm_tpu_torch.objectives import softmax0
from lightgbm_tpu_torch.testing import one_thread  # noqa: F401

N = 4000
# name -> (params, label kind, gradient bar in ulps of the largest value;
# 0 = bit-equal)
OBJECTIVES = {
    "regression": ({}, "real", 0),
    "reg_sqrt": ({"objective": "regression", "reg_sqrt": True}, "real", 0),
    "regression_l1": ({}, "real", 0),
    "huber": ({}, "real", 0),
    "fair": ({}, "real", 0),
    "quantile": ({"alpha": 0.3}, "real", 0),
    "mape": ({}, "real", 0),
    "poisson": ({}, "positive", 4),
    "gamma": ({}, "positive", 4),
    "tweedie": ({}, "positive", 4),
    "binary": ({}, "binary", 4),
    "cross_entropy": ({}, "unit", 4),
    "cross_entropy_lambda": ({}, "unit", 4),
    "multiclass": ({"num_class": 4}, "class", 4),
    "multiclassova": ({"num_class": 4}, "class", 4),
}
# (objective, weighted) -> a wider bar
WIDER = {("cross_entropy_lambda", True): 256}

# the training tests' shared settings: the rounds grower on the fused arm
BASE = {"num_leaves": 7, "min_data_in_leaf": 5, "verbose": -1,
        "tpu_tree_growth": "rounds", "tpu_hist_method": "fused",
        "max_bin": 63}
TREE_EXACT = ("split_feature", "threshold", "decision_type", "left_child",
              "right_child", "leaf_count", "cat_boundaries",
              "cat_threshold")


def ulps(a, b) -> np.ndarray:
    """Elementwise distance of two f32 arrays in units in the last place
    (the ordered integer difference of their bit patterns)."""
    def ordered(x):
        i = np.asarray(x, np.float32).view(np.int32).astype(np.int64)
        return np.where(i < 0, -(i & 0x7FFFFFFF), i)
    return np.abs(ordered(a) - ordered(b))


def labels(kind: str, n: int, rng) -> np.ndarray:
    return {"real": lambda: rng.randn(n) * 3,
            "positive": lambda: rng.gamma(2.0, 1.5, n),
            "binary": lambda: (rng.rand(n) < 0.4) * 1.0,
            "unit": lambda: rng.rand(n),
            "class": lambda: rng.randint(0, 4, n) * 1.0}[kind]().astype(
                np.float32)


def objective_pair(params: dict, y, w=None, group=None):
    """The JAX and the port objective of ``params``, each initialised on
    the same metadata."""
    jm, tm = JMeta(label=y, weight=w), TMeta(label=y, weight=w)
    if group is not None:
        jm.set_group(group)
        tm.set_group(group)
    jo = jcreate(JConfig.from_params(dict(params)))
    to = tcreate(TConfig.from_params(dict(params)))
    jo.init(jm, len(y))
    to.init(tm, len(y), "cpu")
    return jo, to


def _case(name, weighted, seed=0):
    params, kind, bar = OBJECTIVES[name]
    params = {"objective": name, **params}
    rng = np.random.RandomState(seed)
    y = labels(kind, N, rng)
    w = (rng.rand(N) + 0.5).astype(np.float32) if weighted else None
    K = params.get("num_class", 1)
    score = (rng.randn(*((K, N) if K > 1 else (N,))) * 2).astype(np.float32)
    return params, y, w, score, WIDER.get((name, weighted), bar)


@pytest.mark.parametrize("weighted", [False, True], ids=["plain",
                                                          "weighted"])
@pytest.mark.parametrize("name", list(OBJECTIVES))
def test_gradients_match(name, weighted):
    params, y, w, score, bar = _case(name, weighted)
    jo, to = objective_pair(params, y, w)
    jg, jh = (np.asarray(a) for a in jo.get_gradients(jnp.asarray(score)))
    tg, th = (a.numpy() for a in to.get_gradients(torch.as_tensor(score)))
    assert tg.shape == jg.shape and th.shape == jh.shape
    for t, j in ((tg, jg), (th, jh)):
        if bar == 0:
            assert t.tobytes() == j.tobytes()
        else:
            err = np.abs(t.astype(np.float64) - j)
            assert (err <= bar * 2.0 ** -23 * np.abs(j).max()).all()


@pytest.mark.parametrize("name", list(OBJECTIVES))
def test_boost_from_score_and_convert_output(name):
    params, y, w, score, _ = _case(name, True, seed=1)
    for weight in (None, w):
        jo, to = objective_pair(params, y, weight)
        K = jo.num_model_per_iteration
        assert to.num_model_per_iteration == K
        for k in range(K):
            np.testing.assert_allclose(to.boost_from_score(k),
                                       jo.boost_from_score(k), rtol=1e-12,
                                       atol=1e-300)
    jc = np.asarray(jo.convert_output(jnp.asarray(score)))
    tc = to.convert_output(torch.as_tensor(score)).numpy()
    assert ulps(tc, jc).max() <= 4


def test_softmax_against_xla():
    rng = np.random.RandomState(2)
    s = (rng.randn(5, 20000) * 3).astype(np.float32)
    j = np.asarray(jax.nn.softmax(jnp.asarray(s), axis=0))
    d = ulps(softmax0(torch.as_tensor(s)).numpy(), j)
    assert d.max() <= 4 and (d > 0).mean() < 0.02


@pytest.mark.parametrize("alpha", [0.1, 0.5, 0.9])
def test_weighted_percentile_matches(alpha):
    rng = np.random.RandomState(3)
    v = rng.randn(501)
    for w in (None, rng.rand(501) + 0.1, np.ones(501)):
        assert t_percentile(v, w, alpha) == j_percentile(v, w, alpha)


def test_unknown_objective_raises():
    cfg = TConfig.from_params({"objective": "regression"})
    cfg.objective = "nope"
    with pytest.raises(ValueError, match="unknown objective"):
        tcreate(cfg)
    cfg.objective = "none"
    assert tcreate(cfg) is None


# ----------------------------------------------------------------------
# helpers of the training tests
# ----------------------------------------------------------------------

def train_both(params, X, y, Xv, yv, rounds, group=None, vgroup=None,
               categorical="auto", **kw):
    """``lightgbm_tpu.train`` and ``lt.train`` (on the CPU) of the same
    data; returns (jax booster, port booster, jax evals, port evals)."""
    ev_j, ev_t = {}, {}
    dj = lgb.Dataset(X, label=y, group=group,
                     categorical_feature=categorical)
    bj = lgb.train(dict(params), dj, rounds,
                   valid_sets=[lgb.Dataset(Xv, label=yv, group=vgroup,
                                           reference=dj)],
                   evals_result=ev_j, verbose_eval=False, **kw)
    dt = lt.Dataset(X, label=y, group=group, device="cpu",
                    categorical_feature=categorical)
    bt = lt.train(dict(params), dt, rounds,
                  valid_sets=[dt.create_valid(Xv, label=yv, group=vgroup)],
                  evals_result=ev_t, verbose_eval=False, **kw)
    return bj, bt, ev_j, ev_t


def assert_same_trees(bj, bt, num_trees, rtol=1e-4, atol=1e-6,
                      atol_of_largest=0.0):
    """Equal model headers and tree structure; leaf values to ``rtol``
    (the two packages sum f32 histograms in different orders), or within
    ``atol`` plus ``atol_of_largest`` of the tree's largest |leaf|."""
    jm = load_model_from_string(bj.model_to_string())
    tm = load_model_from_string(bt.model_to_string())
    for key in ("objective_name", "num_class", "num_tree_per_iteration",
                "average_output", "feature_infos"):
        assert jm[key] == tm[key], key
    assert len(jm["models"]) == len(tm["models"]) == num_trees
    for j, t in zip(jm["models"], tm["models"]):
        assert j.num_leaves == t.num_leaves
        for f in TREE_EXACT:
            assert np.array_equal(getattr(j, f), getattr(t, f)), f
        np.testing.assert_allclose(
            t.leaf_value, j.leaf_value, rtol=rtol,
            atol=atol + atol_of_largest * np.abs(j.leaf_value).max())
        np.testing.assert_allclose(t.shrinkage, j.shrinkage, rtol=1e-12)


def assert_same_metrics(ev_j, ev_t, rtol=1e-4):
    assert ev_j.keys() == ev_t.keys()
    for data, metrics in ev_j.items():
        assert metrics.keys() == ev_t[data].keys()
        for metric, vals in metrics.items():
            np.testing.assert_allclose(ev_t[data][metric], vals, rtol=rtol)


def assert_predictions_carry(bj, bt, Xv, rtol=1e-4, atol=1e-6):
    """The port's predictions (card path and host path) equal the JAX
    package's; the port's model text loads in ``lightgbm_tpu.Booster``
    and predicts the same; the JAX model loads in the port through model
    text and through ``convert.stacked_forest_from_numpy`` and predicts
    the same raw and converted outputs."""
    for raw in (False, True):
        want = bj.predict(Xv, raw_score=raw)
        np.testing.assert_allclose(bt.predict(Xv, raw_score=raw), want,
                                   rtol=rtol, atol=atol)
        np.testing.assert_allclose(
            bt.predict(Xv, raw_score=raw, device=False), want, rtol=rtol,
            atol=atol)
        back = lgb.Booster(model_str=bt.model_to_string())
        np.testing.assert_allclose(back.predict(Xv, raw_score=raw),
                                   bt.predict(Xv, raw_score=raw,
                                              device=False),
                                   rtol=1e-5, atol=1e-6)
        loaded = lt.Booster(model_str=bj.model_to_string(), device="cpu")
        np.testing.assert_allclose(loaded.predict(Xv, raw_score=raw), want,
                                   rtol=1e-5, atol=1e-6)
    jf = bj._forest(0, len(bj.models) // bj.num_tree_per_iteration)
    arrays = {name: np.asarray(getattr(jf, name)) for name in (
        "split_feature", "threshold", "left", "right", "is_cat",
        "default_left", "missing_type", "leaf_value", "depth",
        "cat_offset", "cat_nwords", "cat_words", "has_cat", "max_depth")}
    forest = stacked_forest_from_numpy(arrays)
    K = bj.num_tree_per_iteration
    raw = forest.predict_raw(np.asarray(Xv, np.float64), num_class=K)
    if bj.average_output:
        raw = raw / (len(bj.models) // K)
    want = bj.predict(Xv, raw_score=True)
    np.testing.assert_allclose(raw[0] if K == 1 else raw.T, want,
                               rtol=1e-5, atol=1e-6)


def table(seed: int, n: int, kind: str):
    """Six f32 features (one integer-valued) and a label of ``kind``:
    "binary", "regression" (real), "positive", "class" (3 classes) or
    "grade" (relevance 0-4); returns (X, y)."""
    rng = np.random.RandomState(seed)
    X = rng.randn(n, 6).astype(np.float32)
    X[:, 4] = np.round(X[:, 4] * 2)
    z = (X[:, 0] + 0.5 * X[:, 1] * X[:, 2] - 0.4 * X[:, 4]
         + 0.3 * rng.randn(n))
    y = {"binary": lambda: z > 0,
         "regression": lambda: z,
         "positive": lambda: np.exp(0.5 * z),
         "class": lambda: np.digitize(z + 0.4 * X[:, 3], [-0.5, 0.5]),
         "grade": lambda: np.clip(np.round(z + 1.5), 0, 4)}[kind]()
    return X, np.asarray(y, np.float32)


def query_sizes(seed: int, n: int, lo: int = 3, hi: int = 40) -> np.ndarray:
    """Query lengths in [lo, hi) summing to ``n`` (the last takes the
    remainder)."""
    rng = np.random.RandomState(seed)
    sizes = []
    while sum(sizes) < n:
        sizes.append(int(rng.randint(lo, hi)))
    sizes[-1] -= sum(sizes) - n
    return np.asarray(sizes, np.int64)
