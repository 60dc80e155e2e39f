"""CEGB, forced splits and forced bins in ``lightgbm_tpu_torch`` on the
CPU, held against ``lightgbm_tpu`` (which runs CEGB and forced splits on
its serial grower, as the port does).

- The 13 tests of tests/test_cegb_forced.py on the port; each CEGB and
  forced-split model is also held against the JAX package's model of the
  same data: tree structure equal, leaf values to rtol=1e-4 (the JAX
  package sums f32 in its order, the port exactly: ROADMAP queue C,
  C-3).
- After each iteration the port's cross-tree CEGB state (the
  used-feature flags and the lazy paid-row bitmap) equals the JAX
  booster's ``_cegb_state``.
- Forced bins: the bin mappers' bounds and the [G, n] bytes equal the
  JAX package's for dense, CSR and text-file input, and after a binary
  cache round trip.
- ``update_chunk(4)`` with lazy CEGB is byte-equal to four ``update()``
  calls, also where training stops inside the chunk; GOSS, RF and DART
  with CEGB against the JAX package; the errors and the quantized
  fallback.
"""

import json
import os

import numpy as np
import pytest
import scipy.sparse as sps

import lightgbm_tpu as lgb

import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch.testing import one_thread  # noqa: F401

from test_torch_objectives import assert_same_trees


def _data(n=600, f=5, seed=3):
    rng = np.random.RandomState(seed)
    X = rng.rand(n, f)
    y = (2.0 * X[:, 0] + 1.0 * X[:, 1] + 0.5 * X[:, 2]
         + 0.05 * rng.randn(n)).astype(np.float32)
    return X, y


BASE = {"objective": "regression", "num_leaves": 16, "verbosity": -1,
        "min_data_in_leaf": 5, "learning_rate": 0.1}
_CACHE = {}


def _train(params, rounds, n=600, jax_too=True):
    """(port booster, JAX booster or None) trained on ``_data(n)``, once
    per configuration for the whole file; the JAX one is held against
    the port's."""
    key = (json.dumps(params, sort_keys=True), rounds, n, jax_too)
    if key not in _CACHE:
        X, y = _data(n)
        bt = lt.train(dict(params), lt.Dataset(X, label=y, device="cpu"),
                      rounds)
        bj = None
        if jax_too:
            bj = lgb.train(dict(params), lgb.Dataset(X, label=y),
                           num_boost_round=rounds)
            assert_same_trees(bj, bt, len(bj.boosting.models))
        _CACHE[key] = (bt, bj)
    return _CACHE[key]


def _total_leaves(booster):
    return sum(m.num_leaves for m in booster.boosting.models)


def _used_features(booster):
    out = set()
    for m in booster.boosting.models:
        for s in range(m.num_leaves - 1):
            out.add(int(m.split_feature[s]))
    return out


def _forced_file(tmp_path, spec, name="forced.json"):
    fn = os.path.join(str(tmp_path), name)
    with open(fn, "w") as f:
        json.dump(spec, f)
    return fn


class TestCEGB:
    def test_split_penalty_prunes(self):
        b0, _ = _train(BASE, 2, jax_too=False)
        b1, _ = _train(dict(BASE, cegb_penalty_split=0.05), 2)
        b2, _ = _train(dict(BASE, cegb_penalty_split=100.0), 2)
        assert 0 < _total_leaves(b1) < _total_leaves(b0)
        assert sum(m.num_leaves - 1 for m in b2.boosting.models) == 0

    def test_split_penalty_changes_chosen_splits(self):
        b0, _ = _train(BASE, 1, jax_too=False)
        b1, _ = _train(dict(BASE, cegb_penalty_split=0.05), 1)
        t0, t1 = b0.boosting.models[0], b1.boosting.models[0]
        assert (t0.num_leaves != t1.num_leaves
                or t0.split_feature[:t0.num_leaves - 1].tolist()
                != t1.split_feature[:t1.num_leaves - 1].tolist())

    def test_coupled_penalty_concentrates_features(self):
        b0, _ = _train(BASE, 3, jax_too=False)
        b1, _ = _train(dict(BASE, cegb_penalty_feature_coupled=[5.0] * 5), 3)
        assert len(_used_features(b1)) < len(_used_features(b0))
        assert _total_leaves(b1) > 0

    def test_coupled_state_persists_across_trees(self):
        b, _ = _train(dict(BASE, cegb_penalty_feature_coupled=[5.0] * 5), 4)
        assert len(b.boosting.models) == 4
        per_tree = [{int(f) for f in m.split_feature[:m.num_leaves - 1]}
                    for m in b.boosting.models if m.num_leaves > 1]
        paid = per_tree[0]
        for feats in per_tree[1:]:
            assert feats <= paid
            paid |= feats

    def test_lazy_penalty_prunes(self):
        b0, _ = _train(BASE, 2, jax_too=False)
        b1, _ = _train(dict(BASE, cegb_penalty_feature_lazy=[0.05] * 5), 2)
        b2, _ = _train(dict(BASE, cegb_penalty_feature_lazy=[10.0] * 5), 2)
        assert _total_leaves(b1) <= _total_leaves(b0)
        assert sum(m.num_leaves - 1 for m in b2.boosting.models) == 0

    def test_penalty_list_length_validated(self):
        X, y = _data()
        for mod, kw in ((lt, {"device": "cpu"}), (lgb, {})):
            with pytest.raises(ValueError,
                               match="same size as feature number"):
                mod.train(dict(BASE, cegb_penalty_feature_coupled=[1.0, 2.0]),
                          mod.Dataset(X, label=y, **kw), num_boost_round=1)

    def test_tradeoff_scales_penalty(self):
        X, _ = _data()
        b0, _ = _train(BASE, 2, jax_too=False)
        b1, _ = _train(dict(BASE, cegb_penalty_split=0.05,
                            cegb_tradeoff=0.0), 2)
        np.testing.assert_allclose(b0.predict(X), b1.predict(X), rtol=1e-6)


class TestForcedSplits:
    def test_root_forced(self, tmp_path):
        fn = _forced_file(tmp_path, {"feature": 3, "threshold": 0.5})
        b, _ = _train(dict(BASE, forcedsplits_filename=fn), 1)
        t = b.boosting.models[0]
        assert int(t.split_feature[0]) == 3
        assert abs(t.threshold[0] - 0.5) < 0.1

    def test_bfs_order_and_leaf_routing(self, tmp_path):
        fn = _forced_file(tmp_path, {
            "feature": 3, "threshold": 0.5,
            "left": {"feature": 4, "threshold": 0.25},
            "right": {"feature": 4, "threshold": 0.75}})
        b, _ = _train(dict(BASE, forcedsplits_filename=fn), 1)
        t = b.boosting.models[0]
        assert int(t.split_feature[0]) == 3
        assert int(t.split_feature[1]) == 4 and int(t.split_feature[2]) == 4
        thr = sorted([t.threshold[1], t.threshold[2]])
        assert abs(thr[0] - 0.25) < 0.1 and abs(thr[1] - 0.75) < 0.1
        assert t.left_child[0] == 1 and t.right_child[0] == 2

    def test_partition_consistency(self, tmp_path):
        X, _ = _data()
        fn = _forced_file(tmp_path, {"feature": 0, "threshold": 0.5})
        b, _ = _train(dict(BASE, forcedsplits_filename=fn), 1)
        t = b.boosting.models[0]
        leaves = b.predict(X, pred_leaf=True).astype(int).ravel()
        thr = float(t.threshold[0])
        left = {int(v) for v in leaves[X[:, 0] <= thr]}
        right = {int(v) for v in leaves[X[:, 0] > thr]}
        assert left.isdisjoint(right)

    def test_training_continues_best_first(self, tmp_path):
        fn = _forced_file(tmp_path, {"feature": 3, "threshold": 0.5})
        b, _ = _train(dict(BASE, forcedsplits_filename=fn), 1)
        b0, _ = _train(BASE, 1, jax_too=False)
        t = b.boosting.models[0]
        assert t.num_leaves > 2
        assert t.num_leaves == b0.boosting.models[0].num_leaves

    def test_bad_forced_split_aborts_plan(self, tmp_path):
        fn = _forced_file(tmp_path, {
            "feature": 3, "threshold": 100.0,
            "left": {"feature": 4, "threshold": 0.5}})
        b, _ = _train(dict(BASE, forcedsplits_filename=fn), 1)
        t = b.boosting.models[0]
        assert not (int(t.split_feature[0]) == 3 and t.threshold[0] > 1.0)
        assert t.num_leaves > 1

    def test_forced_plus_accuracy(self, tmp_path):
        X, y = _data(n=2000)
        fn = _forced_file(tmp_path, {"feature": 0, "threshold": 0.5})
        b0, _ = _train(BASE, 20, n=2000, jax_too=False)
        b1, _ = _train(dict(BASE, forcedsplits_filename=fn), 20, n=2000,
                       jax_too=False)
        mse0 = float(np.mean((b0.predict(X) - y) ** 2))
        mse1 = float(np.mean((b1.predict(X) - y) ** 2))
        assert mse1 < mse0 * 1.5


def test_forced_exact_parity_stats_convention(tmp_path):
    X, y = _data(800, 4)
    fn = _forced_file(tmp_path, {"feature": 0, "threshold": 0.5})
    base = dict(BASE, num_leaves=2, forcedsplits_filename=fn)
    models = {}
    for parity in (False, True):
        p = dict(base, tpu_forced_split_parity=parity)
        bt = lt.train(dict(p), lt.Dataset(X, label=y, device="cpu"), 1)
        bj = lgb.train(dict(p), lgb.Dataset(X, label=y), num_boost_round=1)
        assert_same_trees(bj, bt, 1)
        models[parity] = bt.boosting.models[0]
    t_def, t_par = models[False], models[True]
    assert int(t_def.split_feature[0]) == int(t_par.split_feature[0]) == 0
    assert int(t_def.threshold_in_bin[0]) == int(t_par.threshold_in_bin[0])
    l_def, r_def = float(t_def.leaf_count[0]), float(t_def.leaf_count[1])
    l_par, r_par = float(t_par.leaf_count[0]), float(t_par.leaf_count[1])
    assert l_def + r_def == l_par + r_par == len(X)
    assert l_par < l_def


# ----------------------------------------------------------------------
# the cross-tree state, chunks, GOSS and RF
# ----------------------------------------------------------------------

LAZY = dict(BASE, cegb_penalty_feature_lazy=[0.004, 0.01, 0.002, 0.001,
                                              0.003],
            cegb_penalty_feature_coupled=[0.5, 1.0, 2.0, 0.2, 0.1],
            cegb_penalty_split=1e-3)


def test_cegb_state_matches_after_each_iteration():
    X, y = _data()
    bt = lt.Booster(dict(LAZY), train_set=lt.Dataset(X, label=y,
                                                     device="cpu"))
    bj = lgb.Booster(dict(LAZY), train_set=lgb.Dataset(X, label=y))
    for _ in range(4):
        bt.update()
        bj.update()
        used, rows = bt.boosting.grower.cegb_state
        ju, jr = (np.asarray(a) for a in bj.boosting._cegb_state)
        assert np.array_equal(used.numpy(), ju)
        assert np.array_equal(rows.numpy(), jr[:, :len(y)])
    assert used.any() and rows.any() and not rows.all()
    assert_same_trees(bj, bt, 4)


def test_update_chunk_equals_updates_with_lazy_cegb():
    """Four ``update()`` calls against ``update_chunk(4)``; then, with
    bagging and a split penalty that stops training after a few
    iterations, a chunk that stops inside: the model text and the state
    equal per-iteration training's."""
    X, y = _data()
    stops = dict(LAZY, cegb_penalty_split=0.9, bagging_fraction=0.5,
                 bagging_freq=1)
    for params, chunks in ((LAZY, (4,)), (stops, (4, 4, 4))):
        ds = lt.Dataset(X, label=y, device="cpu")
        one = lt.Booster(dict(params), train_set=ds)
        iters = 0
        for _ in range(4 * len(chunks)):
            iters += 1
            if one.update():
                break
        chunked = lt.Booster(dict(params), train_set=ds)
        for c in chunks:
            if chunked.update_chunk(c):
                break
        assert chunked.model_to_string() == one.model_to_string()
        for a, b in zip(one.boosting.grower.cegb_state,
                        chunked.boosting.grower.cegb_state):
            assert np.array_equal(a.numpy(), b.numpy())
        if params is stops:
            # training stopped inside a chunk, not at its end
            assert iters % 4 != 0 and iters < 4 * len(chunks)


@pytest.mark.parametrize("boosting", ["goss", "rf", "dart"])
def test_goss_and_rf_with_cegb_match(boosting):
    """GOSS and RF train through chunks, DART one iteration at a time;
    the CEGB state carries through each as through the JAX package's
    steps."""
    params = dict(LAZY, boosting=boosting)
    if boosting == "goss":
        params["learning_rate"] = 0.5
    elif boosting == "rf":
        params.update(bagging_fraction=0.7, bagging_freq=1)
    else:
        params.update(drop_rate=0.5, skip_drop=0.0)
    X, y = _data(1000)
    bt = lt.train(dict(params), lt.Dataset(X, label=y, device="cpu"), 4)
    bj = lgb.train(dict(params), lgb.Dataset(X, label=y), num_boost_round=4)
    assert_same_trees(bj, bt, 4)
    for a, b in zip(bj.boosting._cegb_state, bt.boosting.grower.cegb_state):
        assert np.array_equal(np.asarray(a)[..., :len(y)], b.numpy())


# ----------------------------------------------------------------------
# errors and the quantized fallback
# ----------------------------------------------------------------------

@pytest.mark.parametrize("growth", ["rounds", "fast"])
def test_rounds_growth_with_cegb_raises(growth, tmp_path):
    X, y = _data()
    fn = _forced_file(tmp_path, {"feature": 0, "threshold": 0.5})
    for extra in ({"cegb_penalty_split": 0.01},
                  {"forcedsplits_filename": fn}):
        p = dict(BASE, tpu_tree_growth=growth, **extra)
        msgs = []
        for mod, kw in ((lt, {"device": "cpu"}), (lgb, {})):
            with pytest.raises(ValueError, match="does not support CEGB") \
                    as err:
                mod.train(dict(p), mod.Dataset(X, label=y, **kw), 1)
            msgs.append(str(err.value))
        assert msgs[0] == msgs[1]


def test_quantized_cegb_falls_back_to_f32(monkeypatch):
    from lightgbm_tpu_torch.boosting import gbdt as tgbdt
    warnings = []
    monkeypatch.setattr(tgbdt, "log_warning", warnings.append)
    X, y = _data()
    p = dict(BASE, cegb_penalty_split=0.01, use_quantized_grad=True)
    bt = lt.train(dict(p), lt.Dataset(X, label=y, device="cpu"), 2)
    assert not bt.boosting._quant_on and not bt.boosting.grower_cfg.quant
    assert len(warnings) == 1 and "CEGB" in warnings[0]
    assert "falling back to f32" in warnings[0]
    bj = lgb.train(dict(p), lgb.Dataset(X, label=y), num_boost_round=2)
    assert not bj.boosting._quant_on
    assert_same_trees(bj, bt, 2)
    f32 = lt.train(dict(p, use_quantized_grad=False),
                   lt.Dataset(X, label=y, device="cpu"), 2)
    assert (f32.model_to_string().partition("parameters:")[0]
            == bt.model_to_string().partition("parameters:")[0])


# ----------------------------------------------------------------------
# forced bins
# ----------------------------------------------------------------------

BIN_SPEC = [{"feature": 0, "bin_upper_bound": [0.1, 0.35, 0.62]},
            {"feature": 2, "bin_upper_bound": [0.05, 0.5, 0.9]}]


@pytest.fixture(scope="module")
def forced_bins(tmp_path_factory):
    d = tmp_path_factory.mktemp("forced_bins")
    fn = os.path.join(str(d), "bins.json")
    with open(fn, "w") as f:
        json.dump(BIN_SPEC, f)
    X, y = _data(1500, 4, seed=8)
    X[::7, 1] = 0.0
    csv = os.path.join(str(d), "t.csv")
    np.savetxt(csv, np.column_stack([y, X]), delimiter=",", fmt="%.9g")
    params = {"max_bin": 15, "forcedbins_filename": fn}
    inputs = {"dense": (X, {"label": y}),
              "csr": (sps.csr_matrix(X), {"label": y}),
              "csv": (csv, {})}
    jax_ds = {k: lgb.Dataset(data, params=dict(params), **kw).construct()
              for k, (data, kw) in inputs.items()}
    return d, params, inputs, jax_ds


def _same_bins(jd, td):
    for jm, tm in zip(jd.bin_mappers, td.bin_mappers):
        assert json.dumps(jm.to_dict()) == json.dumps(tm.to_dict())
    jb, tb = np.asarray(jd.binned), td.host_binned()
    assert jb.dtype == tb.dtype and jb.tobytes() == tb.tobytes()


@pytest.mark.parametrize("kind", ["dense", "csr", "csv"])
def test_forced_bins_match_the_jax_package(forced_bins, kind):
    _, params, inputs, jax_ds = forced_bins
    data, kw = inputs[kind]
    td = lt.Dataset(data, params=dict(params), device="cpu",
                    **kw).construct()
    _same_bins(jax_ds[kind], td)
    for spec in BIN_SPEC:
        ub = td.bin_mappers[spec["feature"]].bin_upper_bound
        for bound in spec["bin_upper_bound"]:
            assert np.any(np.isclose(ub, bound, rtol=0, atol=1e-12))


def test_forced_bins_survive_a_binary_cache(forced_bins):
    d, params, inputs, jax_ds = forced_bins
    data, kw = inputs["dense"]
    path = os.path.join(str(d), "cache.bin")
    lt.Dataset(data, params=dict(params), device="cpu",
               **kw).construct().save_binary(path)
    back = lt.Dataset(path, device="cpu").construct()
    assert back.bin_route == "cache"
    _same_bins(jax_ds["dense"], back)
