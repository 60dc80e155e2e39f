"""The port's threefry2x32 (lightgbm_tpu_torch/utils/threefry.py) held
against ``jax.random``: keys, ``fold_in`` and ``uniform`` draws are
bit-equal (no tolerance: the draws decide stochastic rounding, so one
flipped bit can change a quantized gradient).

The variant of the draws follows ``jax.config.jax_threefry_partitionable``
as the reference runs; the other variant is checked too, with the
config switched for the duration of the test.  The Random123
known-answer vectors of threefry2x32-20 pin the hash itself.
"""

import contextlib

import jax
import numpy as np
import pytest
import torch

import lightgbm_tpu as lgb

import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch.utils import threefry
from lightgbm_tpu_torch.testing import one_thread  # noqa: F401

SEEDS = (0, 1, 6, 2 ** 31 - 1)
SIZES = (1, 7, 1000, 10007)


def _key(jkey):
    return tuple(int(v) for v in np.asarray(jkey, np.uint32))


@contextlib.contextmanager
def _partitionable(value):
    old = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", value)
    try:
        yield
    finally:
        jax.config.update("jax_threefry_partitionable", old)


@pytest.mark.parametrize("ctr,key,want", [
    ((0, 0), (0, 0), (0x6B200159, 0x99BA4EFE)),
    ((0xFFFFFFFF, 0xFFFFFFFF), (0xFFFFFFFF, 0xFFFFFFFF),
     (0x1CB996FC, 0xBB002BE7)),
    ((0x243F6A88, 0x85A308D3), (0x13198A2E, 0x03707344),
     (0xC4923A9C, 0x483DF7A0)),
])
def test_random123_known_answers(ctr, key, want):
    """Random123's kat_vectors for threefry2x32 with 20 rounds, on
    Python ints and on int64 tensors."""
    assert threefry.threefry2x32(key, *ctr) == want
    t = threefry.threefry2x32(key, torch.tensor([ctr[0]]),
                              torch.tensor([ctr[1]]))
    assert (int(t[0]), int(t[1])) == want


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key_and_fold_in(seed):
    jk = jax.random.PRNGKey(seed)
    tk = threefry.prng_key(seed)
    assert tk == _key(jk)
    for data in (0, 1, 0x51475442, 2 ** 32 - 1):
        assert threefry.fold_in(tk, data) == _key(jax.random.fold_in(jk,
                                                                     data))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("n", SIZES)
def test_uniform_is_bit_equal(seed, n):
    part = bool(jax.config.jax_threefry_partitionable)
    key = jax.random.fold_in(jax.random.PRNGKey(seed), 3)
    want = np.asarray(jax.random.uniform(key, (2, n)))
    got = threefry.uniform(_key(key), (2, n), partitionable=part).numpy()
    assert got.dtype == np.float32 and got.shape == (2, n)
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("n", SIZES)
def test_other_variant_is_bit_equal(n):
    part = not bool(jax.config.jax_threefry_partitionable)
    with _partitionable(part):
        key = jax.random.PRNGKey(6)
        want = np.asarray(jax.random.uniform(key, (2, n)))
        bits = np.asarray(jax.random.bits(key, (n,)))
    got = threefry.uniform((0, 6), (2, n), partitionable=part).numpy()
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))
    tb = threefry.random_bits((0, 6), (n,), partitionable=part).numpy()
    assert np.array_equal(tb.astype(np.uint32), bits)


def test_booster_key_chain():
    """The booster's keys for 20 iterations and class 0, against the JAX
    package's own base key: ``fold_in(base, iter)`` and the quantization
    key ``fold_in(fold_in(key, 0x51475442), 0)``."""
    X = np.random.RandomState(0).randn(200, 3).astype(np.float32)
    y = (X[:, 0] > 0).astype(np.float32)
    params = {"objective": "binary", "verbose": -1, "extra_trees_seed": 5,
              "feature_fraction_seed": 9, "use_quantized_grad": True}
    jb = lgb.Booster(dict(params), train_set=lgb.Dataset(X, label=y))
    tb = lt.Booster(dict(params), train_set=lt.Dataset(X, label=y,
                                                       device="cpu"))
    jbase = jb.boosting._node_key_base
    gb = tb.boosting
    assert gb._node_key_base == _key(jbase)
    for it in range(20):
        gb.iter = it
        jrng = jax.random.fold_in(jbase, it)
        assert gb._node_key() == _key(jrng)
        jq = jax.random.fold_in(jax.random.fold_in(jrng, 0x51475442), 0)
        tq = threefry.fold_in(threefry.fold_in(gb._node_key(), 0x51475442),
                              0)
        assert tq == _key(jq)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("num", (2, 3, 8))
def test_split_is_bit_equal(seed, num):
    """``split(key, num)`` is ``jax.random.split`` in both variants: the
    GOSS key stream and rank_xendcg's key."""
    for part in (True, False):
        with _partitionable(part):
            jk = jax.random.fold_in(jax.random.PRNGKey(seed), 7)
            want = [_key(k) for k in jax.random.split(jk, num)]
        assert threefry.split(_key(jk), num, partitionable=part) == want


def test_split_chain_follows_the_stream():
    """Five iterations of ``key, sub = split(key)`` (GOSS's sampled
    iterations) give JAX's keys and subkeys."""
    jk, tk = jax.random.PRNGKey(3), threefry.prng_key(3)
    for _ in range(5):
        jk, jsub = jax.random.split(jk)
        tk, tsub = threefry.split(tk)
        assert (tk, tsub) == (_key(jk), _key(jsub))
