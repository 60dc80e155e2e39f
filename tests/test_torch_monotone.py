"""Monotone constraints in the port (lightgbm_tpu_torch) held against the
JAX package (lightgbm_tpu), on the CPU, where the port's kernels run
their plain versions.

- The plain monotone scan (``ops.split.numeric_feature_scan`` with
  ``monotone_constraints`` and ``leaf_output_bounds``) against the JAX
  package's, run op by op: bit-identical tuples on dyadic histograms
  (every f32 sum exact in both packages), f32 and quantized at
  power-of-two scales; on random f32 histograms thresholds, default_left
  and left sums equal and gains within ``GAIN_TOL``.
- ``fused_frontier_splits`` / ``fused_segment_splits`` /
  ``fused_sibling_scan`` with constraints and child bounds against the
  Pallas kernel in interpret mode, and ``grow_tree_rounds`` on both arms
  (fused, and staged as ``hist_method="pallas"``) against the JAX
  package's: there XLA compiles the monotone gain
  ``-(2 sg out + (h + l2) out out)`` into a fused program whose result
  can sit an ulp or two from the op-by-op one (the JAX package's own
  fused and staged monotone gains differ so, ROADMAP queue C), so every
  field but the gain is held equal (dyadic: the whole tree but
  ``split_gain``) and gains within ``GAIN_TOL``; random leaf values
  within rtol=3e-5.
- ``lt.train`` against ``lightgbm_tpu.train`` with constraints [1, -1, 0]
  on upstream LightGBM's monotone data, with the prediction sweep of
  tests/test_engine.py; a constant feature dropped at binning (the
  constraints follow the used features); ``max_delta_step`` > 0.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lightgbm_tpu as lgb
from lightgbm_tpu.dataset import FeatureMeta as JMeta
from lightgbm_tpu.grower import GrowerConfig as JConfig
from lightgbm_tpu.grower_rounds import grow_tree_rounds as jgrow
from lightgbm_tpu.ops import fused as JFU
from lightgbm_tpu.ops import split as JS

import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch.dataset import FeatureMeta as TMeta
from lightgbm_tpu_torch.grower import GrowerConfig as TConfig
from lightgbm_tpu_torch.grower_rounds import grow_tree_rounds as tgrow
from lightgbm_tpu_torch.model_text import load_model_from_string
from lightgbm_tpu_torch.ops import fused as TFU
from lightgbm_tpu_torch.ops import split as TS
from lightgbm_tpu_torch.ops.histogram import hist_scales, to_fixed
from lightgbm_tpu_torch.testing import MONOTONE_CONSTRAINTS, monotone_like
from lightgbm_tpu_torch.testing import one_thread  # noqa: F401

N, F, B, K = 2000, 6, 16, 3
NUM_BIN = np.array([16, 16, 16, 2, 12, 16], np.int32)
MISSING = np.array([0, 2, 1, 0, 2, 0], np.int32)
DEFAULT = np.array([0, 0, 4, 0, 0, 0], np.int32)
MONO = np.array([1, -1, 0, 1, -1, 1], np.int32)
HP = dict(min_data_in_leaf=5, lambda_l2=0.5, min_sum_hessian_in_leaf=0.01,
          max_delta_step=0.0)
FIELDS = ("gain", "threshold", "default_left", "left_sum_grad",
          "left_sum_hess", "left_count")
# gains (shifted by the child's parent gain, so they cancel) within 1e-5
# of the child's largest |gain|: measured at most 2.2e-6 of it on this
# data (fused functions, dyadic and random)
GAIN_TOL = 1e-5


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _bounds(nc, seed):
    """Child output bounds, child i by i % 4: none, an upper bound, a
    lower bound, both (finite bounds within 0.1-1.1 of zero, so the
    clamp bites)."""
    rng = np.random.RandomState(seed)
    i = np.arange(nc)
    lo = np.where(i % 4 >= 2, -0.1 - rng.rand(nc), -np.inf)
    hi = np.where(i % 2 == 1, 0.1 + rng.rand(nc), np.inf)
    return lo.astype(np.float32), hi.astype(np.float32)


def _data(seed, dyadic):
    rng = np.random.RandomState(seed)
    binned = np.stack([rng.randint(0, nb, N) for nb in NUM_BIN]
                      ).astype(np.uint8)
    if dyadic:
        g = rng.randint(-64, 65, N) / 8.0 - (binned[0] - 8) / 4.0 \
            + (binned[1] - 8) / 8.0
        h = np.where(rng.rand(N) < 0.5, 1.0, rng.randint(1, 9, N) / 4.0)
    else:
        g = rng.randn(N) - (binned[0] - 8) * 0.3 + (binned[1] - 8) * 0.2
        h = np.abs(rng.randn(N)) + 0.1
    w = (rng.rand(N) > 0.2).astype(np.float64)
    vals = (np.stack([g, h, np.ones(N)]) * w).astype(np.float32)
    slot = np.where(rng.rand(N) < 0.7, rng.randint(0, K, N), K)
    more = np.where(rng.rand(N) < 0.6, rng.randint(0, K, N), K)
    slot_parent = np.where(slot < K, slot, more)
    return (binned, vals, slot.astype(np.int32), slot_parent,
            rng.rand(K) < 0.5)


def _hist64(binned, vals, slot):
    out = np.zeros((K, 3, F, B))
    rows = np.nonzero(slot < K)[0]
    for f in range(F):
        for c in range(3):
            np.add.at(out[:, c, f], (slot[rows], binned[f, rows]),
                      vals[c, rows].astype(np.float64))
    return out


def _meta_j():
    return jnp.asarray(NUM_BIN), jnp.asarray(MISSING), jnp.asarray(DEFAULT)


def _meta_t():
    return (torch.from_numpy(NUM_BIN), torch.from_numpy(MISSING),
            torch.from_numpy(DEFAULT))


def _assert_tuples(jbest, tbest, exact):
    """``exact``: all six tuples bit for bit; otherwise every field but
    the gain equal (random data: the left sums are the f32 of exact sums
    in the port and f32 sums in the JAX package, so only thresholds and
    default_left), and gains within ``GAIN_TOL`` of each child's
    largest |gain|."""
    names = FIELDS if exact else ("threshold", "default_left")
    for name in names:
        assert np.array_equal(_np(getattr(jbest, name)),
                              _np(getattr(tbest, name))), name
    jg, tg = _np(jbest.gain), _np(tbest.gain)
    assert np.array_equal(np.isfinite(jg), np.isfinite(tg))
    fin = np.isfinite(jg)
    assert fin.any()
    scale = np.where(fin, np.abs(jg), 0).max(axis=-1, keepdims=True)
    assert (np.abs(np.where(fin, tg - jg, 0)) <= GAIN_TOL * scale).all()


def _assert_fused(jbest, tbest, dyadic):
    """The fused functions: every field but the gain as ``_assert_tuples``
    (dyadic: all of them equal), the gain within ``GAIN_TOL``."""
    if dyadic:
        for name in FIELDS[1:]:
            assert np.array_equal(_np(getattr(jbest, name)),
                                  _np(getattr(tbest, name))), name
    _assert_tuples(jbest, tbest, exact=False)


# ----------------------------------------------------------------------
# the plain scan
# ----------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["f32_dyadic", "f32_random", "quant"])
def test_plain_monotone_scan_matches_reference(mode):
    binned, vals, slot, _, _ = _data(11, mode != "f32_random")
    jhp, thp = JS.SplitHyperparams(**HP), TS.SplitHyperparams(**HP)
    lo, hi = _bounds(K, 3)
    if mode == "quant":
        rng = np.random.RandomState(2)
        gq = rng.randint(-7, 8, N)
        hq = rng.randint(0, 8, N)
        lv = np.stack([gq, hq, np.zeros(N)]).astype(np.float64)
        hist = _hist64(binned, lv, slot)[:, :2].astype(np.int32)
        gs, hs = 0.125, 0.25
        cnt = np.bincount(slot[slot < K], minlength=K).astype(np.float32)
        sums = np.stack([hist[:, 0, 0].sum(-1) * gs, hist[:, 1, 0].sum(-1)
                         * hs, cnt]).astype(np.float32)
        jh = JS.quant_rescale_hist(jnp.asarray(hist), gs, hs,
                                   jnp.asarray(cnt))
        th = TS.quant_count_hist(torch.from_numpy(hist),
                                 torch.from_numpy(cnt))
        scales = TS.QuantScales(gs, hs)
    else:
        h64 = _hist64(binned, vals, slot)
        sums = h64[:, :, 0, :].sum(-1).T.astype(np.float32)
        jh = jnp.asarray(h64.astype(np.float32))
        hf = torch.from_numpy(h64.astype(np.float32))
        scales = hist_scales(hf)
        th = to_fixed(hf, scales, 1)
    jbest = JS.numeric_feature_scan(
        jh, jnp.asarray(sums[0]), jnp.asarray(sums[1]), jnp.asarray(sums[2]),
        *_meta_j(), jhp, monotone_constraints=jnp.asarray(MONO),
        leaf_output_bounds=(jnp.asarray(lo), jnp.asarray(hi)))
    ts = torch.from_numpy(sums)
    tbest = TS.numeric_feature_scan(
        th, scales, ts[0], ts[1], ts[2], *_meta_t(), thp,
        monotone_constraints=torch.from_numpy(MONO),
        leaf_output_bounds=(torch.from_numpy(lo), torch.from_numpy(hi)))
    _assert_tuples(jbest, tbest, exact=mode != "f32_random")
    # the constraints bite: the unconstrained scan elects otherwise
    free = TS.numeric_feature_scan(th, scales, ts[0], ts[1], ts[2],
                                   *_meta_t(), thp)
    assert not (np.array_equal(_np(free.threshold), _np(tbest.threshold))
                and np.array_equal(_np(free.gain), _np(tbest.gain)))


# ----------------------------------------------------------------------
# the fused functions (JAX signatures) against the Pallas kernel
# ----------------------------------------------------------------------

def _fused(seed, dyadic):
    binned, vals, slot, slot_parent, small_left = _data(seed, dyadic)
    small64 = _hist64(binned, vals, slot)
    parent = _hist64(binned, vals, slot_parent).astype(np.float32)
    sl = small_left[:, None, None, None]
    left = np.where(sl, small64, parent.astype(np.float64) - small64)
    kids = np.concatenate([left, parent.astype(np.float64) - left])
    csums = kids[:, :, 0, :].sum(-1).T.astype(np.float32)
    ssums = small64[:, :, 0, :].sum(-1).T.astype(np.float32)
    jb, jv, js = jnp.asarray(binned), jnp.asarray(vals), jnp.asarray(slot)
    tb, tv, ts = (torch.from_numpy(binned), torch.from_numpy(vals),
                  torch.from_numpy(slot))
    jhp, thp = JS.SplitHyperparams(**HP), TS.SplitHyperparams(**HP)
    b2, bk = _bounds(2 * K, seed), _bounds(K, seed + 1)
    jm, tm = jnp.asarray(MONO), torch.from_numpy(MONO)

    def jbd(b):
        return (jnp.asarray(b[0]), jnp.asarray(b[1]))

    def tbd(b):
        return (torch.from_numpy(b[0]), torch.from_numpy(b[1]))
    small32 = small64.astype(np.float32)
    out = {
        "frontier": (
            JFU.fused_frontier_splits(
                jb, jv, js, K, B, jnp.asarray(csums),
                jnp.asarray(small_left), jnp.asarray(parent), *_meta_j(),
                jhp, monotone_constraints=jm, child_bounds=jbd(b2),
                interpret=True)[1],
            TFU.fused_frontier_splits(
                tb, tv, ts, K, B, torch.from_numpy(csums),
                torch.from_numpy(small_left), torch.from_numpy(parent),
                *_meta_t(), thp, monotone_constraints=tm,
                child_bounds=tbd(b2))[1]),
        "segment": (
            JFU.fused_segment_splits(
                jb, jv, js, K, B, jnp.asarray(ssums), *_meta_j(), jhp,
                monotone_constraints=jm, child_bounds=jbd(bk),
                interpret=True)[1],
            TFU.fused_segment_splits(
                tb, tv, ts, K, B, torch.from_numpy(ssums), *_meta_t(), thp,
                monotone_constraints=tm, child_bounds=tbd(bk))[1]),
        "scan_parent": (
            JFU.fused_sibling_scan(
                jnp.asarray(small32), jnp.asarray(csums), *_meta_j(), jhp,
                small_left=jnp.asarray(small_left),
                parent_hist=jnp.asarray(parent), monotone_constraints=jm,
                child_bounds=jbd(b2), interpret=True),
            TFU.fused_sibling_scan(
                torch.from_numpy(small32), torch.from_numpy(csums),
                *_meta_t(), thp, small_left=torch.from_numpy(small_left),
                parent_hist=torch.from_numpy(parent),
                monotone_constraints=tm, child_bounds=tbd(b2))),
        "scan_leaf_mono_only": (
            JFU.fused_sibling_scan(
                jnp.asarray(small32), jnp.asarray(ssums), *_meta_j(), jhp,
                monotone_constraints=jm, interpret=True),
            TFU.fused_sibling_scan(
                torch.from_numpy(small32), torch.from_numpy(ssums),
                *_meta_t(), thp, monotone_constraints=tm)),
    }
    return out


@pytest.fixture(scope="module")
def fused_dyadic():
    return _fused(3, True)


@pytest.fixture(scope="module")
def fused_random():
    return _fused(5, False)


FUSED = ["frontier", "segment", "scan_parent", "scan_leaf_mono_only"]


@pytest.mark.parametrize("fn", FUSED)
def test_fused_monotone_dyadic_matches_reference(fused_dyadic, fn):
    _assert_fused(*fused_dyadic[fn], dyadic=True)


@pytest.mark.parametrize("fn", FUSED)
def test_fused_monotone_random_within_f32(fused_random, fn):
    _assert_fused(*fused_random[fn], dyadic=False)


@pytest.mark.parametrize("fn", ["frontier", "segment"])
def test_fused_monotone_quantized_matches_reference(fn):
    """The int8/int32 mode with constraints and bounds, at power-of-two
    scales (every sum exact in both packages)."""
    binned, _, slot, slot_parent, small_left = _data(13, True)
    rng = np.random.RandomState(4)
    member = rng.rand(N) > 0.1
    gq = np.where(member, rng.randint(-7, 8, N), 0)
    hq = np.where(member, rng.randint(0, 8, N), 0)
    vals = np.stack([gq, hq]).astype(np.int8)
    gs, hs = 0.125, 0.25
    lv = np.stack([gq, hq, member]).astype(np.float64)
    small = _hist64(binned, lv, slot)
    parent = _hist64(binned, lv, slot_parent)
    jhp, thp = JS.SplitHyperparams(**HP), TS.SplitHyperparams(**HP)
    jm, tm = jnp.asarray(MONO), torch.from_numpy(MONO)
    if fn == "frontier":
        sl = small_left[:, None, None, None]
        left = np.where(sl, small, parent - small)
        kids = np.concatenate([left, parent - left])
        sums = np.stack([kids[:, 0, 0].sum(-1) * gs,
                         kids[:, 1, 0].sum(-1) * hs,
                         kids[:, 2, 0].sum(-1)]).astype(np.float32)
        lo, hi = _bounds(2 * K, 9)
        par32 = parent[:, :2].astype(np.int32)
        jb = JFU.fused_frontier_splits(
            jnp.asarray(binned), jnp.asarray(vals), jnp.asarray(slot), K, B,
            jnp.asarray(sums), jnp.asarray(small_left), jnp.asarray(par32),
            *_meta_j(), jhp, quant_scales=(gs, hs), monotone_constraints=jm,
            child_bounds=(jnp.asarray(lo), jnp.asarray(hi)),
            interpret=True)[1]
        tb = TFU.fused_frontier_splits(
            torch.from_numpy(binned), torch.from_numpy(vals),
            torch.from_numpy(slot), K, B, torch.from_numpy(sums),
            torch.from_numpy(small_left), torch.from_numpy(par32),
            *_meta_t(), thp, quant_scales=(gs, hs), monotone_constraints=tm,
            child_bounds=(torch.from_numpy(lo), torch.from_numpy(hi)))[1]
    else:
        sums = np.stack([small[:, 0, 0].sum(-1) * gs,
                         small[:, 1, 0].sum(-1) * hs,
                         small[:, 2, 0].sum(-1)]).astype(np.float32)
        lo, hi = _bounds(K, 10)
        jb = JFU.fused_segment_splits(
            jnp.asarray(binned), jnp.asarray(vals), jnp.asarray(slot), K, B,
            jnp.asarray(sums), *_meta_j(), jhp, quant_scales=(gs, hs),
            monotone_constraints=jm,
            child_bounds=(jnp.asarray(lo), jnp.asarray(hi)),
            interpret=True)[1]
        tb = TFU.fused_segment_splits(
            torch.from_numpy(binned), torch.from_numpy(vals),
            torch.from_numpy(slot), K, B, torch.from_numpy(sums),
            *_meta_t(), thp, quant_scales=(gs, hs), monotone_constraints=tm,
            child_bounds=(torch.from_numpy(lo), torch.from_numpy(hi)))[1]
    _assert_fused(jb, tb, dyadic=True)


def test_random_thresholds_are_a_leaf_mode_input():
    small = torch.zeros((K, 3, F, B), dtype=torch.int64)
    with pytest.raises(ValueError, match="leaf-mode"):
        TFU.sibling_scan(small, (20, 20, 20), torch.zeros(3, 2 * K),
                         *_meta_t(), TS.SplitHyperparams(),
                         small_left=torch.zeros(K, dtype=torch.bool),
                         parent=small,
                         rand_thr=torch.zeros((2 * K, F), dtype=torch.int32))


# ----------------------------------------------------------------------
# the grower, both arms
# ----------------------------------------------------------------------

GN, GB, LEAVES, WIDTH = 3000, 32, 15, 8
STRUCTURE = ("split_feature", "threshold_bin", "default_left", "left_child",
             "right_child", "leaf_parent", "leaf_depth")
VALUES = ("split_gain", "internal_value", "internal_weight", "internal_count",
          "leaf_value", "leaf_weight", "leaf_count")


def _grow_inputs(dyadic):
    rng = np.random.RandomState(21)
    binned = rng.randint(0, GB, (F, GN)).astype(np.uint8)
    y = (0.15 * binned[1] - 0.1 * binned[3] + np.sin(binned[0] * 0.4)
         + 0.3 * rng.randn(GN))
    if dyadic:
        grad = np.round(-y * 8) / 8
        hess = np.where(rng.rand(GN) < 0.5, 1.0, rng.randint(1, 9, GN) / 4)
    else:
        grad, hess = -y, 0.5 + rng.rand(GN)
    mc = np.zeros(F, np.int32)
    mc[1], mc[3] = 1, -1
    return (binned, grad.astype(np.float32), hess.astype(np.float32),
            np.ones(GN, np.float32), mc)


def _gmeta(mod):
    return mod(num_bin=np.full(F, GB, np.int32),
               missing_type=np.zeros(F, np.int32),
               default_bin=np.zeros(F, np.int32),
               most_freq_bin=np.zeros(F, np.int32),
               is_categorical=np.zeros(F, bool), max_num_bin=GB)


@pytest.mark.parametrize("arm", ["fused", "pallas"])
@pytest.mark.parametrize("dyadic", [True, False], ids=["dyadic", "random"])
def test_grower_monotone_matches_reference(arm, dyadic):
    binned, grad, hess, mask, mc = _grow_inputs(dyadic)
    hp = dict(min_data_in_leaf=5, lambda_l2=1.0)
    jt, jl = jgrow(jnp.asarray(binned), jnp.asarray(grad), jnp.asarray(hess),
                   jnp.asarray(mask), _gmeta(JMeta),
                   JConfig(num_leaves=LEAVES, hp=JS.SplitHyperparams(**hp),
                           num_bins=GB, round_width=WIDTH, hist_method=arm),
                   monotone_constraints=jnp.asarray(mc))
    tt, tl = tgrow(torch.from_numpy(binned), torch.from_numpy(grad),
                   torch.from_numpy(hess), torch.from_numpy(mask),
                   _gmeta(TMeta),
                   TConfig(num_leaves=LEAVES, hp=TS.SplitHyperparams(**hp),
                           num_bins=GB, round_width=WIDTH, hist_method=arm),
                   monotone_constraints=torch.from_numpy(mc))
    tt = tt.to_numpy()
    assert int(jt.num_leaves) == tt["num_leaves"] > 4
    for name in STRUCTURE:
        assert np.array_equal(np.asarray(getattr(jt, name)), tt[name]), name
    assert np.array_equal(np.asarray(jl), tl.numpy())
    jg = np.asarray(jt.split_gain)
    np.testing.assert_allclose(tt["split_gain"], jg, rtol=0,
                               atol=GAIN_TOL * np.abs(jg).max())
    if dyadic:
        for name in VALUES[1:]:
            assert np.array_equal(np.asarray(getattr(jt, name)),
                                  tt[name]), name
    else:
        np.testing.assert_allclose(tt["leaf_value"],
                                   np.asarray(jt.leaf_value), rtol=3e-5,
                                   atol=1e-7)
    # a constrained feature splits, and the output clamp holds: the
    # leaves under each split of feature 1 (increasing) are ordered
    assert (tt["split_feature"][:tt["num_leaves"] - 1] == 1).any()


# ----------------------------------------------------------------------
# training
# ----------------------------------------------------------------------

TREE_EXACT = ("split_feature", "threshold", "decision_type", "left_child",
              "right_child", "leaf_count")
TRAIN = {"objective": "regression", "metric": "l2", "verbose": -1,
         "num_leaves": 31, "min_data_in_leaf": 5, "max_bin": 63,
         "tpu_tree_growth": "rounds"}


def _compare(params, X, y, rounds, Xv=None):
    bj = lgb.train(dict(params), lgb.Dataset(X, label=y), rounds,
                   verbose_eval=False)
    bt = lt.train(dict(params), lt.Dataset(X, label=y, device="cpu"), rounds,
                  verbose_eval=False)
    jm = load_model_from_string(bj.model_to_string())
    tm = load_model_from_string(bt.model_to_string())
    assert len(jm["models"]) == len(tm["models"]) == rounds
    for j, t in zip(jm["models"], tm["models"]):
        assert j.num_leaves == t.num_leaves
        for f in TREE_EXACT:
            assert np.array_equal(getattr(j, f), getattr(t, f)), f
        np.testing.assert_allclose(t.leaf_value, j.leaf_value, rtol=1e-5,
                                   atol=1e-6)
    if Xv is not None:
        np.testing.assert_allclose(bt.predict(Xv), bj.predict(Xv),
                                   rtol=1e-5, atol=1e-5)
    return bt


def _sweep_is_monotone(bst, seed):
    rng = np.random.RandomState(seed)
    grid = np.linspace(0.0, 1.0, 101)
    for row in rng.rand(10, 3):
        sweep = np.tile(row, (grid.size, 1))
        sweep[:, 0] = grid
        assert (np.diff(bst.predict(sweep)) >= -1e-10).all()
        sweep = np.tile(row, (grid.size, 1))
        sweep[:, 1] = grid
        assert (np.diff(bst.predict(sweep)) <= 1e-10).all()


@pytest.mark.parametrize("arm", ["fused", "pallas"])
def test_train_monotone_matches_reference(arm):
    """tests/test_engine.py::test_monotone_constraints' data and sweep."""
    X, y = monotone_like(2000, seed=42, num_features=3)
    params = dict(TRAIN, monotone_constraints=list(MONOTONE_CONSTRAINTS),
                  tpu_hist_method=arm)
    bt = _compare(params, X, y, 10, Xv=monotone_like(300, 7, 3)[0])
    assert bt.boosting._monotone.tolist() == [1, -1, 0]
    _sweep_is_monotone(bt, 42)


def test_monotone_follows_the_used_features():
    """A constant column dropped at binning drops its constraint: the
    others stay on their own features."""
    X, y = monotone_like(2000, seed=3, num_features=3)
    X = np.column_stack([X[:, 0], np.full(len(X), 2.5, np.float32),
                         X[:, 1], X[:, 2]])
    params = dict(TRAIN, monotone_constraints=[1, 0, -1, 0],
                  tpu_hist_method="fused")
    bt = _compare(params, X, y, 5)
    assert bt.boosting.train_set.used_features == [0, 2, 3]
    assert bt.boosting._monotone.tolist() == [1, -1, 0]


def test_max_delta_step_with_constraints():
    X, y = monotone_like(2000, seed=9, num_features=3)
    params = dict(TRAIN, monotone_constraints=list(MONOTONE_CONSTRAINTS),
                  max_delta_step=0.4, tpu_hist_method="fused")
    bt = _compare(params, X, y, 5)
    lv = np.concatenate([m.leaf_value for m in bt.models[1:]])
    assert np.abs(lv).max() <= 0.4 * 0.1 + 1e-7      # clipped, shrunk
