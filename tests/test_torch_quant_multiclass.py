"""Quantized multiclass (``use_quantized_grad``, K = 3): each class's
gradients quantized with its own scales and stochastic-rounding key
``fold_in(fold_in(key, 0x51475442), k)``, its tree grown from the int8
levels; ``lt.train`` on the CPU against ``lightgbm_tpu.train`` (rounds
grower, fused arm).

Bars as in tests/test_torch_quantized.py: the quantized levels and the
per-class scales of an iteration bit-equal (same gradients in, same
threefry draws); tree structure equal; leaf values to rtol 1e-5 plus
1e-5 of the tree's largest |leaf| (the JAX package sums ``fl(q_b * s)``
per bin in f32, the port rounds exact integer prefixes once); metrics
to 1e-4.  16 bins with stochastic rounding: at the default 4 bins exact
ties between candidates are common (tests/test_torch_quantized.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lightgbm_tpu as lgb
from lightgbm_tpu.ops.histogram import quantize_gradients as jquantize

import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch.model_text import load_model_from_string
from lightgbm_tpu_torch.ops.histogram import quantize_gradients as tquantize
from lightgbm_tpu_torch.utils import threefry

from test_torch_objectives import (BASE, TREE_EXACT, assert_same_metrics,
                                   table, train_both)
from lightgbm_tpu_torch.testing import one_thread  # noqa: F401

ROUNDS = 3
PARAMS = dict(BASE, objective="multiclass", num_class=3,
              use_quantized_grad=True, num_grad_quant_bins=16,
              metric=["multi_logloss"])


@pytest.fixture(scope="module")
def trained():
    torch.exp(torch.randn(1 << 20))      # ROADMAP queue C (CPU exp)
    X, y = table(5, 2000, "class")
    Xv, yv = table(6, 500, "class")
    return (*train_both(PARAMS, X, y, Xv, yv, ROUNDS), Xv)


def test_every_class_trains_quantized(trained):
    _, bt, _, _, _ = trained
    gb = bt.boosting
    assert gb._quant_on and gb.grower_cfg.quant
    assert len(gb._quant_scales) == 3
    assert len({(float(g), float(h)) for g, h in gb._quant_scales}) == 3


def test_per_class_quantization_is_bit_equal(trained):
    _, bt, _, _, _ = trained
    gb = bt.boosting
    grad, hess = gb._gradients(gb.train_score)
    key = threefry.fold_in(gb._node_key_base, gb.iter)
    for k in range(3):
        qkey = threefry.fold_in(threefry.fold_in(key, 0x51475442), k)
        t = tquantize(grad[k], hess[k], gb._row_valid, 16, qkey,
                      stochastic=True)
        j = jquantize(jnp.asarray(grad[k].numpy()),
                      jnp.asarray(hess[k].numpy()),
                      jnp.ones(gb.num_data, jnp.float32), 16,
                      jnp.asarray(np.asarray(qkey, np.uint32)),
                      stochastic=True)
        for a, b in zip(t, j):
            assert np.asarray(a).tobytes() == np.asarray(b).tobytes()


def test_trees_match(trained):
    bj, bt, _, _, _ = trained
    jm = load_model_from_string(bj.model_to_string())["models"]
    tm = load_model_from_string(bt.model_to_string())["models"]
    assert len(jm) == len(tm) == 3 * ROUNDS
    for j, t in zip(jm, tm):
        assert j.num_leaves == t.num_leaves
        for f in TREE_EXACT:
            assert np.array_equal(getattr(j, f), getattr(t, f)), f
        big = np.abs(j.leaf_value).max()
        np.testing.assert_allclose(t.leaf_value, j.leaf_value, rtol=1e-5,
                                   atol=1e-5 * big)


def test_metrics_and_predictions_match(trained):
    bj, bt, ev_j, ev_t, Xv = trained
    assert_same_metrics(ev_j, ev_t)
    np.testing.assert_allclose(bt.predict(Xv), bj.predict(Xv), rtol=1e-4,
                               atol=1e-6)
    back = lgb.Booster(model_str=bt.model_to_string())
    np.testing.assert_allclose(back.predict(Xv), bt.predict(Xv), rtol=1e-5,
                               atol=1e-6)
    assert isinstance(lt.Booster(model_str=bj.model_to_string(),
                                 device="cpu"), lt.Booster)
