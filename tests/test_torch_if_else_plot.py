"""The trainer's last surfaces in the port, held against the JAX package:
``model_text.model_to_if_else``, the plotting functions and a random
forest's ``Booster.update(train_set=)``.

- ``model_to_if_else`` gives the JAX package's string for the same
  model (categorical bitsets, every missing type, multiclass and an
  averaged random forest), and the source, compiled with ``g++``, gives
  ``StackedForest.predict_raw``'s float64 scores bit for bit;
- each plotting function draws on the Agg backend the bars, lines or
  graph nodes that the JAX package's draws (``plot_tree`` renders
  through graphviz's ``dot``; where that binary is absent its PNG comes
  from matplotlib, so the port's drawing path still runs);
- a random forest moved to a new Dataset of the same rows keeps its
  running-mean scores bit for bit and grows the JAX package's trees
  (the JAX package's ``update`` keeps its own training set); moved to
  other rows, its scores are the running mean of its trees over them.
"""

import shutil
import subprocess

import numpy as np
import pytest

import lightgbm_tpu as lgb
from lightgbm_tpu import plotting as jax_plotting
from lightgbm_tpu.model_text import model_to_if_else as jax_if_else

import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch import plotting
from lightgbm_tpu_torch.model_text import model_to_if_else
from lightgbm_tpu_torch.testing import (salt_rows, synthetic_model_text,
                                        synthetic_rows)
from lightgbm_tpu_torch.testing import one_thread  # noqa: F401

from test_torch_objectives import BASE, assert_same_trees, table

F = 6
CATS = (1,)

_MAIN_CPP = r"""
#include <cstdio>
#include <cstdlib>
#include <vector>
extern "C" void Predict(const double* features, double* output);
int main(int argc, char** argv) {
  long n = atol(argv[1]), f = atol(argv[2]), k = atol(argv[3]);
  std::vector<double> x(n * f), out(n * k);
  FILE* in = fopen(argv[4], "rb");
  if (fread(x.data(), sizeof(double), n * f, in) != (size_t)(n * f)) return 1;
  fclose(in);
  for (long r = 0; r < n; ++r) Predict(&x[r * f], &out[r * k]);
  FILE* o = fopen(argv[5], "wb");
  fwrite(out.data(), sizeof(double), n * k, o);
  fclose(o);
  return 0;
}
"""


@pytest.fixture(scope="module")
def texts():
    rf = lt.train(dict(BASE, objective="binary", boosting="rf",
                       bagging_freq=1, bagging_fraction=0.632),
                  lt.Dataset(*table(21, 800, "binary"), device="cpu"), 3)
    return {
        "binary": (synthetic_model_text(F, 12, 15, cat_features=CATS,
                                        seed=71), 1),
        "multiclass": (synthetic_model_text(F, 4, 7, num_class=3,
                                            cat_features=CATS, seed=72), 3),
        "rf": (rf.model_to_string(), 1),
    }


@pytest.mark.parametrize("case", ["binary", "multiclass", "rf"])
def test_model_to_if_else_equals_the_jax_string(texts, case):
    text, _K = texts[case]
    src = model_to_if_else(lt.Booster(model_str=text, device="cpu"))
    assert src == jax_if_else(lgb.Booster(model_str=text))
    assert src.count("double PredictTree") == text.count("\nTree=")
    if case == "rf":
        assert " / 3.0;" in src


@pytest.mark.parametrize("case", ["binary", "multiclass", "rf"])
def test_model_to_if_else_compiles_to_predict_raw(texts, case, tmp_path):
    text, K = texts[case]
    bst = lt.Booster(model_str=text, device="cpu")
    (tmp_path / "model.cpp").write_text(model_to_if_else(bst))
    (tmp_path / "main.cpp").write_text(_MAIN_CPP)
    exe = tmp_path / "predict"
    subprocess.run(["g++", "-O1", "-std=c++17", "-o", str(exe),
                    str(tmp_path / "model.cpp"), str(tmp_path / "main.cpp")],
                   check=True, capture_output=True, timeout=240)
    if case == "rf":
        X = np.asarray(table(22, 400, "binary")[0], np.float64)
    else:
        X = salt_rows(synthetic_rows(F, 400, CATS,
                                     seed=71 if K == 1 else 72))
    nf = X.shape[1]
    X.tofile(tmp_path / "x.bin")
    subprocess.run([str(exe), str(len(X)), str(nf), str(K),
                    str(tmp_path / "x.bin"), str(tmp_path / "out.bin")],
                   check=True, timeout=60)
    got = np.fromfile(tmp_path / "out.bin", np.float64).reshape(len(X), K)
    want = bst.predict(X, raw_score=True, device=False)
    assert np.array_equal(got.reshape(want.shape), want)


# ---------------------------------------------------------------- plotting


@pytest.fixture(scope="module")
def plot_models():
    import matplotlib
    matplotlib.use("Agg")
    X, y = table(23, 800, "binary")
    Xv, yv = table(24, 200, "binary")
    params = dict(BASE, objective="binary", metric=["binary_logloss", "auc"])
    ev = {}
    dt = lt.Dataset(X, label=y, device="cpu")
    bt = lt.train(params, dt, 4, valid_sets=[dt, dt.create_valid(Xv,
                                                                label=yv)],
                  valid_names=["train", "valid"], evals_result=ev)
    # both read the same text, so the split gains are the same numbers
    text = bt.model_to_string()
    return (lgb.Booster(model_str=text),
            lt.Booster(model_str=text, device="cpu"), ev)


def _bars(ax):
    return [(round(p.get_x(), 9), round(p.get_y(), 9),
             round(p.get_width(), 9), round(p.get_height(), 9))
            for p in ax.patches]


def _texts(ax):
    return ([t.get_text() for t in ax.get_yticklabels()],
            [t.get_text() for t in ax.texts], ax.get_title(),
            ax.get_xlabel(), ax.get_ylabel())


def test_plot_importance_draws_the_jax_bars(plot_models):
    import matplotlib.pyplot as plt
    bj, bt, _ev = plot_models
    for kw in ({}, {"importance_type": "gain", "max_num_features": 3},
               {"ignore_zero": False, "title": None}):
        a = plotting.plot_importance(bt, **kw)
        b = jax_plotting.plot_importance(bj, **kw)
        assert len(a.patches) > 0
        assert _bars(a) == _bars(b) and _texts(a) == _texts(b), kw
        plt.close("all")


def test_plot_metric_draws_the_jax_lines(plot_models):
    import matplotlib.pyplot as plt
    _bj, _bt, ev = plot_models
    for kw in ({}, {"metric": "auc", "dataset_names": ["valid"]}):
        a = plotting.plot_metric(ev, **kw)
        b = jax_plotting.plot_metric(ev, **kw)
        la, lb = a.get_lines(), b.get_lines()
        assert len(la) == len(lb) == len(kw.get("dataset_names", ev))
        for x, y in zip(la, lb):
            assert x.get_label() == y.get_label()
            assert np.array_equal(x.get_xydata(), y.get_xydata())
        assert _texts(a) == _texts(b)
        plt.close("all")
    with pytest.raises(TypeError):
        plotting.plot_metric(object())


def test_plot_split_value_histogram_draws_the_jax_bars(plot_models):
    import matplotlib.pyplot as plt
    bj, bt, _ev = plot_models
    feat = int(np.argmax(bt.feature_importance("split")))
    for bins in (None, 5):
        a = plotting.plot_split_value_histogram(bt, feat, bins=bins)
        b = jax_plotting.plot_split_value_histogram(bj, feat, bins=bins)
        assert len(a.patches) > 0
        assert _bars(a) == _bars(b) and _texts(a) == _texts(b)
        plt.close("all")


def test_tree_digraph_and_plot_tree(plot_models, monkeypatch, tmp_path):
    import graphviz
    import matplotlib.pyplot as plt
    bj, bt, _ev = plot_models
    info = ["split_gain", "internal_count", "leaf_count"]
    for idx in (0, 3):
        g = plotting.create_tree_digraph(bt, tree_index=idx, show_info=info)
        h = jax_plotting.create_tree_digraph(bj, tree_index=idx,
                                             show_info=info)
        assert g.source == h.source
        assert g.source.count("leaf") >= bt.models[idx].num_leaves
    if shutil.which("dot") is None:
        fig = plt.figure(figsize=(1, 1))
        fig.savefig(tmp_path / "tree.png")
        plt.close(fig)
        data = (tmp_path / "tree.png").read_bytes()
        monkeypatch.setattr(graphviz.Digraph, "pipe",
                            lambda self, format=None, **kw: data)
    a = plotting.plot_tree(bt, tree_index=1)
    b = jax_plotting.plot_tree(bj, tree_index=1)
    ia, ib = a.get_images(), b.get_images()
    assert len(ia) == len(ib) == 1
    assert np.array_equal(ia[0].get_array(), ib[0].get_array())
    plt.close("all")


# ------------------------------------------------ rf update(train_set=)


RF_PARAMS = dict(BASE, objective="binary", boosting="rf", bagging_freq=1,
                 bagging_fraction=0.632, feature_fraction=0.8)


def test_rf_update_train_set_of_the_same_rows():
    X, y = table(25, 1500, "binary")
    ds = lt.Dataset(X, label=y, device="cpu")
    bt = lt.Booster(dict(RF_PARAMS), train_set=ds)
    jb = lgb.Booster(dict(RF_PARAMS), train_set=lgb.Dataset(X, label=y))
    for _ in range(2):
        bt.update()
    score = bt.boosting.train_score.clone()
    grad = bt.boosting._grad.clone()
    again = lt.Dataset(X, label=y, device="cpu")
    bt.update(train_set=again)
    assert bt.train_set is again and bt.boosting.train_set is again
    bt.update()
    for _ in range(4):
        jb.update()
    assert_same_trees(jb, bt, 4)
    # the replayed running mean and the fixed gradients, bit for bit
    fresh = lt.Booster(dict(RF_PARAMS), train_set=ds)
    for _ in range(2):
        fresh.update()
    assert np.array_equal(fresh.boosting.train_score.numpy(), score.numpy())
    assert np.array_equal(bt.boosting._grad.numpy(), grad.numpy())


def test_rf_update_train_set_of_other_rows():
    X, y = table(26, 1200, "binary")
    X2, y2 = table(27, 700, "binary")
    ds = lt.Dataset(X, label=y, device="cpu")
    bt = lt.Booster(dict(RF_PARAMS), train_set=ds)
    for _ in range(3):
        bt.update()
    other = lt.Dataset(X2, label=y2, device="cpu", reference=ds)
    bt.reset_training_data(other)
    b = bt.boosting
    assert b.train_score.shape == (1, 700) and b._grad.shape == (1, 700)
    # the running mean of the trees (their bias included) over the rows
    mean = bt.predict(X2, raw_score=True, device=False)
    np.testing.assert_allclose(b.train_score.numpy()[0], mean, rtol=1e-5,
                               atol=1e-6)
    init = b.init_scores[0]
    p = 1.0 / (1.0 + np.exp(-init))
    np.testing.assert_allclose(b._grad.numpy()[0], p - y2, rtol=1e-5,
                               atol=1e-6)
    assert not bt.update()
    assert bt.num_trees() == 4
    assert np.isfinite(bt.predict(X2)).all()
