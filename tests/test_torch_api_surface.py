"""The port's public surface against the JAX package's (ROADMAP C-23):
every name of ``lightgbm_tpu.__all__`` on ``lightgbm_tpu_torch`` (but
for the listed names of modules the port has not ported), and
tests/test_api_surface.py's Dataset and Booster cases on the port, on
the CPU."""

import numpy as np
import pytest

import lightgbm_tpu as lgb

import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch.testing import one_thread  # noqa: F401

# the JAX package's public names that belong to modules not ported yet
UNPORTED = {
    "lifecycle": "A12", "LifecycleController": "A12",
    "multi": "A12", "train_many": "A12", "expand_param_grid": "A12",
}


def test_every_public_name_resolves_or_is_unported():
    missing = [n for n in lgb.__all__
               if n not in UNPORTED and not hasattr(lt, n)]
    assert missing == []
    for n in UNPORTED:
        assert n in lgb.__all__ and n not in lt.__all__, n
        assert not hasattr(lt, n), n
    assert set(lgb.__all__) - set(UNPORTED) <= set(lt.__all__)
    # the serving fleet (queue A6) resolves to the port's own classes
    from lightgbm_tpu_torch.fleet import registry, router
    assert lt.Fleet is registry.Fleet and lt.PodFleet is router.PodFleet
    assert set(lgb.fleet.__all__) <= set(lt.fleet.__all__)
    # co-residency resolves to the port's own scheduler
    from lightgbm_tpu_torch.coresident import scheduler
    assert lt.coresident.Scheduler is scheduler.Scheduler
    assert set(lgb.coresident.__all__) == set(lt.coresident.__all__)


def test_public_names_are_the_ports_own():
    from lightgbm_tpu_torch import callback, config, engine, serving
    assert lt.Config is config.Config
    assert lt.EarlyStopException is callback.EarlyStopException
    assert lt.print_evaluation is callback.print_evaluation
    assert lt.reset_parameter is callback.reset_parameter
    assert lt.InitModelCompatibilityError is \
        engine.InitModelCompatibilityError
    assert lt.serving is serving and lt.serving.Server
    from lightgbm_tpu_torch import sklearn as sk
    for name in ("LGBMModel", "LGBMRegressor", "LGBMClassifier",
                 "LGBMRanker"):
        assert getattr(lt, name) is getattr(sk, name)
    assert lt.obs.global_registry is lt.obs.get_registry()


@pytest.fixture(scope="module")
def trained():
    rng = np.random.RandomState(3)
    n = 2000
    X = rng.rand(n, 8).astype(np.float32)
    y = ((X[:, 0] + 0.5 * X[:, 1] + 0.1 * rng.randn(n)) > 0.7).astype(
        np.float32)
    ds = lt.Dataset(X, label=y, free_raw_data=False, device="cpu")
    dv = ds.create_valid(X[:500], label=y[:500])
    params = {"objective": "binary", "num_leaves": 7, "verbosity": -1,
              "metric": "binary_logloss"}
    bst = lt.train(params, ds, num_boost_round=5, valid_sets=[dv],
                   valid_names=["v0"], verbose_eval=False)
    return X, y, ds, dv, bst


def test_dataset_fields_and_params():
    rng = np.random.RandomState(0)
    X = rng.rand(100, 4).astype(np.float32)
    ds = lt.Dataset(X, params={"max_bin": 16}, device="cpu")
    ds.set_field("label", np.arange(100) % 2)
    ds.set_field("weight", np.ones(100))
    ds.set_field("init_score", np.zeros(100))
    ds.set_field("group", [60, 40])
    np.testing.assert_array_equal(ds.get_field("label"), np.arange(100) % 2)
    np.testing.assert_array_equal(ds.get_field("group"), [0, 60, 100])
    np.testing.assert_array_equal(ds.get_group(), [60, 40])
    assert ds.get_params() == {"max_bin": 16}
    jds = lgb.Dataset(X, params={"max_bin": 16})
    assert ds.get_params() == jds.get_params()
    p = ds.get_params()
    p["max_bin"] = 3                  # a copy: the Dataset keeps its own
    assert ds.get_params() == {"max_bin": 16}
    with pytest.raises(ValueError):
        ds.set_field("nope", [1])
    ds.set_field("weight", None)
    assert ds.get_field("weight") is None


def test_dataset_ref_chain_and_setters():
    rng = np.random.RandomState(0)
    X = rng.rand(50, 3).astype(np.float32)
    a = lt.Dataset(X, label=np.zeros(50), device="cpu")
    b = lt.Dataset(X, label=np.zeros(50), device="cpu")
    b.set_reference(a)
    c = lt.Dataset(X, label=np.zeros(50), reference=b, device="cpu")
    assert c.get_ref_chain() == {a, b, c}
    assert c.get_ref_chain(ref_limit=2) == {b, c}
    assert a.get_ref_chain() == {a}
    a.set_feature_name([f"f{i}" for i in range(3)])
    a.construct()
    assert a.feature_names == ["f0", "f1", "f2"]
    assert a.num_feature() == 3
    with pytest.raises(RuntimeError):
        a.set_reference(b)


@pytest.mark.parametrize("spec", ["auto", [1], ["c1"], None])
def test_dataset_categorical_feature_property(spec):
    rng = np.random.RandomState(0)
    X = rng.randint(0, 4, (60, 3)).astype(np.float32)
    kw = {} if spec == "auto" else {"categorical_feature": spec}
    names = ["c0", "c1", "c2"]
    ds = lt.Dataset(X, label=np.zeros(60), feature_name=names,
                    device="cpu", **kw)
    jds = lgb.Dataset(X, label=np.zeros(60), feature_name=names, **kw)
    assert ds.categorical_feature == jds.categorical_feature
    assert ds.categorical_feature == ("auto" if spec == "auto" else spec)


def test_dataset_get_data_and_free():
    rng = np.random.RandomState(0)
    X = rng.rand(50, 3).astype(np.float32)
    kept = lt.Dataset(X, label=np.zeros(50), free_raw_data=False,
                      device="cpu").construct()
    assert kept.get_data() is not None
    freed = lt.Dataset(X, label=np.zeros(50), device="cpu").construct()
    with pytest.raises(RuntimeError):
        freed.get_data()


def test_booster_attr_and_train_data_name(trained):
    _, _, ds, dv, bst = trained
    assert bst.attr("missing") is None
    bst.set_attr(alpha="1", beta="x")
    assert bst.attr("alpha") == "1"
    bst.set_attr(alpha=None)
    assert bst.attr("alpha") is None
    with pytest.raises(ValueError):
        bst.set_attr(gamma=3)
    bst.set_train_data_name("mytrain")
    assert bst.eval_train()[0][0] == "mytrain"


def test_booster_eval_on_datasets(trained):
    _, _, ds, dv, bst = trained
    tr = bst.eval(ds, "anything")
    assert tr and tr[0][0] == "anything"
    ev = bst.eval(dv, "renamed")
    assert ev and ev[0][0] == "renamed" and ev[0][1] == "binary_logloss"
    with pytest.raises(ValueError):
        bst.eval(lt.Dataset(np.zeros((5, 8)), label=np.zeros(5),
                            device="cpu"), "x")


def test_booster_bounds_and_leaf_output(trained):
    _, _, _, _, bst = trained
    lo, hi = bst.lower_bound(), bst.upper_bound()
    assert lo <= hi
    m0 = bst.models[0]
    assert bst.get_leaf_output(0, 0) == pytest.approx(float(m0.leaf_value[0]))
    total_lo = sum(float(np.min(m.leaf_value[:m.num_leaves]))
                   for m in bst.models)
    assert lo == pytest.approx(total_lo)


def test_booster_model_from_string_and_num_feature(trained):
    X, _, _, _, bst = trained
    s = bst.model_to_string()
    pred = bst.predict(X, device=False)
    b2 = lt.Booster(model_str=s, device="cpu")
    b2.model_from_string(s)
    np.testing.assert_allclose(b2.predict(X, device=False), pred,
                               rtol=1e-9)
    assert b2.num_feature() == 8


@pytest.mark.parametrize("objective,K", [("binary", 1),
                                         ("multiclass", 3)])
def test_booster_num_model_per_iteration(objective, K):
    rng = np.random.RandomState(1)
    X = rng.rand(300, 4).astype(np.float32)
    y = (X[:, 0] * (3 if K > 1 else 2)).astype(np.int64).astype(np.float32)
    y = np.minimum(y, K if K > 1 else 1)
    params = {"objective": objective, "num_leaves": 5, "verbosity": -1}
    if K > 1:
        params["num_class"] = K
    bst = lt.train(params, lt.Dataset(X, label=y, device="cpu"), 2)
    jb = lgb.Booster(model_str=bst.model_to_string())
    assert bst.num_model_per_iteration() == K == \
        jb.num_model_per_iteration()
    loaded = lt.Booster(model_str=bst.model_to_string(), device="cpu")
    assert loaded.num_model_per_iteration() == K


def test_booster_set_and_free_network(trained, monkeypatch):
    """``set_network``/``free_network`` drive ``parallel.network``: a
    one-machine list starts no group (as ``init_network`` does), and a
    two-machine list starts ``torch.distributed``'s default group with
    the list's address, size and rank."""
    from lightgbm_tpu_torch.parallel import network
    bst = trained[4]
    calls = []
    import torch.distributed as dist
    monkeypatch.setattr(dist, "init_process_group",
                        lambda *a, **kw: calls.append((a, kw)))
    monkeypatch.setattr(dist, "is_initialized", lambda: False)
    assert bst.set_network("127.0.0.1:12400", local_listen_port=12400,
                           num_machines=1) is bst
    assert calls == []
    assert bst.set_network("127.0.0.1:12400,127.0.0.1:12401",
                           local_listen_port=12401, num_machines=2) is bst
    (backend,), kw = calls[0]
    assert kw["init_method"] == "tcp://127.0.0.1:12400"
    assert kw["world_size"] == 2 and kw["rank"] == 1
    assert network.last_network_init()["num_machines"] == 2
    assert bst.free_network() is bst
    assert network.last_network_init() is None


def test_booster_shuffle_models(trained):
    X, _, _, _, bst = trained
    pred_before = bst.predict(X, device=False)
    before = list(bst.models)
    bst.shuffle_models()
    after = list(bst.models)
    assert sorted(map(id, before)) == sorted(map(id, after))
    assert list(map(id, before)) != list(map(id, after))
    np.testing.assert_allclose(bst.predict(X, device=False), pred_before,
                               rtol=1e-6)
