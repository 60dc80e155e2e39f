"""The port's staged split search (lightgbm_tpu_torch/ops/split.py:
``feature_best_splits``, ``best_split_for_leaf``, ``pick_best_feature``
and ``_best_categorical``) held against the JAX package's
(lightgbm_tpu/ops/split.py) on one leaf's histogram.

The port takes int64 fixed-point histograms; the test converts the JAX
package's f32 histogram at ``hist_scales`` (exact for the dyadic cells
used here).  The features cover numeric ones with each missing type, a
one-hot categorical feature (3 categories, ``num_bin <=
max_cat_to_onehot``), many-vs-many categorical ones (one with a NaN bin,
one with categories too small to be usable) and a padded one.

- Dyadic histograms (rows with g = k/8, h in {1, k/4}; distinct
  g / (h + cat_smooth) ratios):
  every sum is exact in both packages, so the per-feature tuples, the
  bitsets and the picked split are bit-identical.  Bitsets are compared
  at categorical features only: the JAX package keeps the categorical
  search's bitset for numeric features too (never read), the port
  zeros.
- Random f32 histograms: the picks (feature, threshold, bitset) are equal
  and the gains agree within 1e-5 (relative): the JAX package sums the
  sorted categories in f32 and the port in int64.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightgbm_tpu.ops import split as JS

from lightgbm_tpu_torch.ops import split as TS
from lightgbm_tpu_torch.ops.histogram import hist_scales, to_fixed
from lightgbm_tpu_torch.testing import one_thread  # noqa: F401

N, B = 3000, 40
NUM_BIN = np.array([40, 33, 3, 24, 40, 18, 12, 0], np.int32)
MISSING = np.array([0, 2, 0, 2, 1, 0, 2, 0], np.int32)
DEFAULT = np.array([0, 0, 0, 0, 7, 0, 0, 0], np.int32)
IS_CAT = np.array([0, 0, 1, 1, 0, 1, 1, 0], bool)
HP = dict(min_data_in_leaf=5, lambda_l2=0.5, min_sum_hessian_in_leaf=0.01,
          max_cat_threshold=8, min_data_per_group=40)
FIELDS = ("gain", "threshold", "default_left", "left_sum_grad",
          "left_sum_hess", "left_count", "is_categorical", "cat_bitset")


def _hist(seed, dyadic):
    """[3, F, B] f32 leaf histogram of N rows: each feature's bins drawn
    with uneven frequencies (feature 6's every third category rare enough
    to be unusable), exact float64 sums rounded once to f32."""
    rng = np.random.RandomState(seed)
    F = len(NUM_BIN)
    if dyadic:
        g = rng.randint(-64, 65, N) / 8.0
        h = np.where(rng.rand(N) < 0.5, 1.0, rng.randint(1, 9, N) / 4.0)
    else:
        g = rng.randn(N)
        h = np.abs(rng.randn(N)) + 0.1
    hist = np.zeros((3, F, B))
    for f in range(F):
        nb = NUM_BIN[f]
        if nb == 0:
            continue
        p = rng.rand(nb) + 0.2
        if f == 6:
            p[::3] = 0.002
        bins = rng.choice(nb, N, p=p / p.sum())
        for c, v in enumerate((g, h, np.ones(N))):
            np.add.at(hist[c, f], bins, v)
    return hist.astype(np.float32)


def _both(hist, mask=None):
    sums = hist[:, 0].sum(-1).astype(np.float32)
    jpf = JS.feature_best_splits(
        jnp.asarray(hist), *map(jnp.asarray, sums), jnp.asarray(NUM_BIN),
        jnp.asarray(MISSING), jnp.asarray(DEFAULT), jnp.asarray(IS_CAT),
        JS.SplitHyperparams(**HP), has_categorical=True,
        feature_mask=None if mask is None else jnp.asarray(mask))
    jres = JS.pick_best_feature(jpf, *map(jnp.asarray, sums))
    th = torch.from_numpy(hist)
    scales = hist_scales(th[None])
    t = [torch.from_numpy(np.asarray(a)) for a in
         (NUM_BIN, MISSING, DEFAULT, IS_CAT)]
    tsums = [torch.tensor([float(v)]) for v in sums]
    tpf = TS.feature_best_splits(
        to_fixed(th[None], scales, 1), scales, *tsums, *t,
        TS.SplitHyperparams(**HP),
        feature_mask=None if mask is None else torch.from_numpy(mask))
    tres = TS.best_split_for_leaf(
        to_fixed(th[None], scales, 1), scales, *tsums, *t,
        TS.SplitHyperparams(**HP),
        feature_mask=None if mask is None else torch.from_numpy(mask))
    return jpf, jres, tpf, tres


def _np(x):
    return np.asarray(x).astype(np.float64)


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_dyadic_tuples_and_bitsets_are_identical(seed):
    jpf, jres, tpf, tres = _both(_hist(seed, True))
    assert bool(IS_CAT.any())
    for name in FIELDS:
        want = _np(getattr(jpf, name))
        got = _np(getattr(tpf, name))[0]
        if name == "cat_bitset":
            want, got = want[IS_CAT], got[IS_CAT]
        assert np.array_equal(got, want), name
    for name in jres._fields:
        want = _np(getattr(jres, name))
        got = _np(getattr(tres, name))[0]
        if name == "cat_bitset" and not bool(jres.is_categorical):
            continue
        assert np.array_equal(got, want), name


@pytest.mark.parametrize("seed", [4, 5, 6])
def test_random_picks_equal_gains_close(seed):
    jpf, jres, tpf, tres = _both(_hist(seed, False))
    jg, tg = _np(jpf.gain), _np(tpf.gain)[0]
    assert np.array_equal(np.isfinite(jg), np.isfinite(tg))
    fin = np.isfinite(jg)
    np.testing.assert_allclose(tg[fin], jg[fin], rtol=1e-5)
    for name in ("threshold", "default_left", "is_categorical"):
        assert np.array_equal(_np(getattr(tpf, name))[0],
                              _np(getattr(jpf, name))), name
    assert np.array_equal(_np(tpf.cat_bitset)[0][IS_CAT],
                          _np(jpf.cat_bitset)[IS_CAT])
    for name in ("feature", "threshold", "default_left", "is_categorical"):
        assert np.array_equal(_np(getattr(tres, name))[0],
                              _np(getattr(jres, name))), name
    if bool(jres.is_categorical):
        assert np.array_equal(_np(tres.cat_bitset)[0], _np(jres.cat_bitset))


def test_every_categorical_mode_is_exercised():
    """The dyadic leaf has a finite one-hot split (feature 2), a finite
    many-vs-many split from both scan ends over the seeds, a NaN-bin
    feature whose left set never holds the NaN bin, and unusable
    categories that stay together."""
    modes = set()
    for seed in (1, 2, 3):
        _, _, tpf, _ = _both(_hist(seed, True))
        gain = tpf.gain[0].numpy()
        bits = tpf.cat_bitset[0].numpy()
        assert np.isfinite(gain[2])
        left = [[(bits[f, b // 32] >> (b % 32)) & 1 for b in range(B)]
                for f in range(len(NUM_BIN))]
        assert sum(left[2]) == 1                     # one category left
        for f in (3, 6):                             # NaN bin never left
            assert left[f][NUM_BIN[f] - 1] == 0
        # unusable categories all fall on one side (the right one, unless
        # the NaN bin forced a swap of sides)
        assert len({left[6][b] for b in range(0, NUM_BIN[6] - 1, 3)}) == 1
        modes.update(int(t) for t in tpf.threshold[0].numpy()[[3, 5, 6]])
    assert len(modes) > 1


def test_feature_mask_and_numeric_features_match_the_scan():
    """A masked feature never wins; numeric features keep the scan's
    tuples (B5's function) under the merge."""
    hist = _hist(1, True)
    mask = np.ones(len(NUM_BIN), np.float32)
    _, jres0, _, tres0 = _both(hist)
    mask[int(tres0.feature[0])] = 0.0
    jpf, jres, tpf, tres = _both(hist, mask)
    assert int(tres.feature[0]) != int(tres0.feature[0])
    assert int(tres.feature[0]) == int(np.asarray(jres.feature))
    assert not np.isfinite(tpf.gain[0].numpy()[mask == 0]).any()


def test_bitset_words():
    member = torch.zeros((2, 300), dtype=torch.bool)
    member[0, [0, 31, 32, 255]] = True
    member[1, [5, 299]] = True               # bins past 256 are dropped
    words = TS.member_bitset(member)
    assert words.shape == (2, TS.MAX_CAT_WORDS)
    assert words[0].tolist() == [1 | (1 << 31), 1, 0, 0, 0, 0, 0, 1 << 31]
    assert words[1].tolist() == [1 << 5, 0, 0, 0, 0, 0, 0, 0]
