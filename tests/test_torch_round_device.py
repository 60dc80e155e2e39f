"""The port's round loop at fixed shapes, driven by the device
(``lightgbm_tpu_torch/grower_rounds.py``), on the CPU.

- While the rounds of a tree run, nothing is read on the host: a
  ``TorchDispatchMode`` that raises on ``aten._local_scalar_dense``,
  ``aten.item``, ``aten.nonzero`` and ``aten.masked_select`` (and on
  indexing with a boolean mask, whose ``nonzero`` runs below the
  dispatcher, and on ``aten.lift_fresh``, a tensor made from host data,
  which on the card is a copy a graph capture refuses) wraps
  ``RoundGrower._run_rounds`` on both arms, f32 and quantized, with
  monotone constraints, per-node randomness and categorical splits.
- The model texts of ``CASES`` (both arms, f32 and quantized, monotone
  constraints, per-node randomness, EFB bundles, native categorical
  features, narrow rounds that roll back with ``max_depth``, multiclass
  and ranking) are byte-equal to those of the loop that read ``k`` and
  ``m`` on the host every round (their sha256, saved from it).
- The trees equal ``lightgbm_tpu.train``'s on the cases of
  ``test_torch_train.py`` (its data, its comparator and tolerances),
  trained under the guard above.
- The device round log is consistent (``1 <= m <= k`` on every live
  round, the committed splits sum to ``num_leaves - 1``), and each tree
  runs its live rounds plus ``STOP_LAG`` dead ones (fewer when the leaf
  budget ends the loop).
- ``tpu_tree_growth="fast"`` (every candidate of a round committed)
  gives the JAX package's ``"fast"`` trees, differs from exact growth,
  and trains to the same quality (tests/test_rounds.py's
  ``test_fast_mode_trains_equivalent_quality``).
"""

import contextlib
import hashlib

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import lightgbm_tpu as lgb

import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch import grower_rounds, testing
from lightgbm_tpu_torch.model_text import load_model_from_string

import test_torch_train as train_cases
from lightgbm_tpu_torch.testing import one_thread  # noqa: F401

# ----------------------------------------------------------------------
# the cases: (params, data, rounds)
# ----------------------------------------------------------------------

ROWS = 1500
BASE = {"num_leaves": 15, "min_data_in_leaf": 5, "max_bin": 63,
        "verbose": -1}
CASES = {
    "fused": (dict(BASE, objective="binary", bagging_fraction=0.8,
                   bagging_freq=1, feature_fraction=0.8), "higgs", 3),
    "fused_narrow": (dict(BASE, objective="binary", tpu_round_width=2,
                          max_depth=4), "higgs", 3),
    "quant_fused": (dict(BASE, objective="binary", use_quantized_grad=True),
                    "higgs", 3),
    "monotone": (dict(BASE, objective="regression",
                      monotone_constraints=[1, -1, 0]), "monotone", 3),
    "bynode": (dict(BASE, objective="binary", extra_trees=True,
                    feature_fraction_bynode=0.5), "higgs", 3),
    "quant_bynode": (dict(BASE, objective="binary", use_quantized_grad=True,
                          num_grad_quant_bins=16,
                          feature_fraction_bynode=0.5), "higgs", 3),
    "staged_efb": (dict(BASE, objective="binary", min_data_in_leaf=20),
                   "onehot", 3),
    "quant_staged": (dict(BASE, objective="binary", min_data_in_leaf=20,
                          use_quantized_grad=True), "onehot", 3),
    "staged_monotone": (dict(BASE, objective="binary", min_data_in_leaf=20,
                             tpu_hist_method="pallas",
                             monotone_constraints=[1, -1]), "higgs", 3),
    "categorical": (dict(BASE, objective="binary", max_cat_threshold=3),
                    "airline", 3),
    "multiclass": (dict(BASE, objective="multiclass", num_class=5,
                        num_leaves=7), "airline_multi", 2),
    "lambdarank": (dict(BASE, objective="lambdarank"), "rank", 2),
}


def _case_data(name: str):
    """(X, y, group, categorical) of a case's data, from fixed seeds."""
    group = None
    categorical = "auto"
    if name == "higgs":
        X, y = testing.higgs_like(ROWS, seed=3, num_features=10)
    elif name == "monotone":
        X, y = testing.monotone_like(ROWS, seed=4, num_features=8)
    elif name == "onehot":
        X, y = testing.airline_like(ROWS, seed=5)
        X = testing.one_hot(X)
    elif name == "airline":
        X, y = testing.airline_like(ROWS, seed=6)
        categorical = list(testing.AIRLINE_CATEGORICAL)
    elif name == "airline_multi":
        X, y = testing.airline_multiclass_like(ROWS, seed=7)
        categorical = list(testing.AIRLINE_CATEGORICAL)
    elif name == "rank":
        X, y, group = testing.mslr_like(ROWS, seed=8)
        X = X[:, :24]
    else:
        raise KeyError(name)
    return X, y, group, categorical


def booster(case: str):
    """The port's Booster of a case on the CPU (not yet trained)."""
    params, dname, _ = CASES[case]
    X, y, group, categorical = _case_data(dname)
    ds = lt.Dataset(X, label=y, group=group, device="cpu",
                    categorical_feature=categorical)
    return lt.Booster(dict(params), train_set=ds)


def port_text(case: str) -> str:
    """The port's model text of a case after its rounds of ``update()``."""
    bst = booster(case)
    for _ in range(CASES[case][2]):
        bst.update()
    return bst.model_to_string()


# sha256 of each case's model text from the loop that read k and m on
# the host every round (commit 85ca919, one CPU thread; print_digests()
# recomputes them)
SAVED_TEXT_SHA256 = {
    "bynode": "f362760bf33c41751031af3364371d4af5b6e685d36a897973fb1b980312f7f8",
    "categorical": "f91449d95eca432f05e4d0d79e580e0c8709831e1d0af7cbe2ce25bbd174c8bd",
    "fused": "49d531d1896dc865deed2b3ce7dc374e26ec9c64cee09f1e7a2fa927c6027d0b",
    "fused_narrow": "ad978a95be28dbf783a7b043637a0b0e88586d6eee9c7c7a5de102f9c908f1f4",
    "lambdarank": "b6d0c7a008ef57efeae66b9b22095ad6402f28e3e1300919f6a49bb896bbc988",
    "monotone": "67626a5f5588cdbb84233ee804caaed926428b83091d97f56b34a284f01b583c",
    "multiclass": "df353d088d73e17ffc6a6af7afb633fb5cd98b855e49a1eadb566c46771e198b",
    "quant_bynode": "35ca333ed22cb68a480b36eb641be2b1611e22387627244b5f7548ffbc77720f",
    "quant_fused": "f071ace34643c95854ccb581fd91cb2007b08f360052da2e9320c7a4338eddb9",
    "quant_staged": "e8ca03541dafb2fd1a33dd61d353099b1b535f6651d7f6c8d6885612d32bf219",
    "staged_efb": "b947d40e1c3dded076eaf7f7d88050332a622e92db87d584d19e8a484aa49c10",
    "staged_monotone": "927b9d7b3581cd7a63eafac728909d51c2e7380a68b9c51a2873ca87de32b9e8",
}


def sha256(text: str) -> str:
    return hashlib.sha256(text.encode()).hexdigest()


def print_digests() -> None:
    """The digests of this checkout's model texts, for SAVED_TEXT_SHA256
    (``PYTHONPATH=. python tests/test_torch_round_device.py`` in a
    checkout of the loop they describe), on one CPU thread as the tests
    train."""
    torch.set_num_threads(1)
    for case in sorted(CASES):
        print(f'    "{case}": "{sha256(port_text(case))}",')


_HOST_READS = ("aten._local_scalar_dense", "aten.item", "aten.nonzero",
               "aten.masked_select",
               # a tensor made from host data: on the card a copy from
               # the host, which a CUDA graph capture refuses
               "aten.lift_fresh")


_INDEXING = ("aten.index", "aten.index_put", "aten.index_put_")


class NoHostRead(TorchDispatchMode):
    """Raises on any operator that copies a device value to the host, and
    on indexing with a boolean mask (a ``nonzero`` inside the operator,
    below the dispatcher)."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = str(func.overloadpacket)
        if any(name == r or name.startswith(r + ".") for r in _HOST_READS):
            raise AssertionError(f"host read in the round loop: {func}")
        if name in _INDEXING and any(
                isinstance(i, torch.Tensor)
                and i.dtype in (torch.bool, torch.uint8)
                for i in (args[1] if len(args) > 1 else ())):
            raise AssertionError(f"host read in the round loop: {func} "
                                 "with a boolean mask")
        return func(*args, **(kwargs or {}))


@contextlib.contextmanager
def guarded_rounds(monkeypatch, seen=None):
    """Runs every tree's rounds under ``NoHostRead``; ``seen`` counts the
    trees."""
    run = grower_rounds.RoundGrower._run_rounds

    def guarded(self, *a, **kw):
        with NoHostRead():
            out = run(self, *a, **kw)
        if seen is not None:
            seen.append(out)
        return out
    monkeypatch.setattr(grower_rounds.RoundGrower, "_run_rounds", guarded)
    yield


@pytest.fixture(scope="module")
def trained():
    """Every case trained once with each tree's rounds under
    ``NoHostRead`` and its round log kept: case -> (booster, trees whose
    rounds ran under the guard)."""
    out = {}
    seen = []
    with pytest.MonkeyPatch.context() as mp, guarded_rounds(mp, seen):
        for case in CASES:
            seen.clear()
            bst = booster(case)
            bst.boosting.round_log = []
            for _ in range(CASES[case][2]):
                bst.update()
            out[case] = (bst, len(seen))
    return out


def test_the_guard_catches_a_host_read():
    t = torch.arange(4)
    with pytest.raises(AssertionError, match="host read"):
        with NoHostRead():
            int(t.sum())
    with pytest.raises(AssertionError, match="host read"):
        with NoHostRead():
            torch.nonzero(t)
    with pytest.raises(AssertionError, match="host read"):
        with NoHostRead():
            t[t > 1]
    with pytest.raises(AssertionError, match="host read"):
        with NoHostRead():
            t[t > 1] = 0
    with pytest.raises(AssertionError, match="host read"):
        with NoHostRead():
            torch.tensor(1.0) + t
    i, j = torch.tensor([1, 2]), torch.tensor([0, 3])
    with NoHostRead():                       # integer indices read nothing
        t[i] = t[j]


@pytest.mark.parametrize("case", sorted(CASES))
def test_rounds_read_nothing_on_the_host(case, trained):
    bst, seen = trained[case]
    assert seen == bst.num_trees() == (CASES[case][2]
                                       * bst.num_tree_per_iteration)


@pytest.mark.parametrize("case", sorted(CASES))
def test_model_text_equals_the_host_read_loop(case, trained):
    assert (sha256(trained[case][0].model_to_string())
            == SAVED_TEXT_SHA256[case])


def test_the_cases_cover_both_arms(trained):
    arms = {}
    for case, (bst, _) in trained.items():
        g = bst.boosting.grower
        arms[case] = (g.fused_arm, g.cfg.quant, g.groups is not None,
                      g.use_mc, g.use_rng, g.cat_idx is not None)
    assert {a[0] for a in arms.values()} == {True, False}
    assert arms["staged_efb"][2] and arms["quant_staged"][1]
    assert arms["quant_fused"][0] and arms["quant_fused"][1]
    assert arms["monotone"][3] and arms["staged_monotone"][3]
    assert not arms["staged_monotone"][0]
    assert arms["bynode"][4] and arms["categorical"][5]


@pytest.mark.parametrize("case", sorted(CASES))
def test_round_log_and_dead_rounds(case, trained):
    bst = trained[case][0]
    logs, models = bst.boosting.round_log, bst.boosting.models
    grower = bst.boosting.grower
    assert len(logs) == len(models) == len(grower.round_counts)
    L = grower.L
    for log, model, (ran, live) in zip(logs, models, grower.round_counts):
        assert all(1 <= m <= k <= grower.KCAP for k, m in log)
        assert sum(m for _, m in log) == model.num_leaves - 1
        assert int(live) == len(log)
        assert ran == min(len(log) + grower_rounds.STOP_LAG, L - 1)
    if case == "fused_narrow":
        assert any(m < k for log in logs for k, m in log)


@pytest.mark.parametrize("name", list(train_cases.CONFIGS))
def test_trees_match_the_jax_package_without_host_reads(name, monkeypatch):
    """test_torch_train.py's cases, the port trained under the guard."""
    with guarded_rounds(monkeypatch):
        r = train_cases._train(name)
    jm = load_model_from_string(r["jax"].model_to_string())
    tm = load_model_from_string(r["port"].model_to_string())
    assert len(jm["models"]) == len(tm["models"]) == train_cases.ROUNDS
    for j, t in zip(jm["models"], tm["models"]):
        assert j.num_leaves == t.num_leaves
        for f in train_cases.TREE_EXACT:
            assert np.array_equal(getattr(j, f), getattr(t, f)), f
        np.testing.assert_allclose(t.leaf_value, j.leaf_value, rtol=1e-4,
                                   atol=1e-6)


def test_unsplittable_root_runs_only_dead_rounds():
    rng = np.random.RandomState(0)
    X = rng.randn(300, 4)
    bst = lt.Booster({"objective": "regression", "num_leaves": 7,
                      "verbose": -1},
                     train_set=lt.Dataset(X, label=np.full(300, 2.0),
                                          device="cpu"))
    bst.boosting.round_log = []
    assert bst.update()
    ran, live = bst.boosting.grower.round_counts[0]
    assert bst.boosting.round_log == [[]]
    assert int(live) == 0 and ran == grower_rounds.STOP_LAG


# ----------------------------------------------------------------------
# tpu_tree_growth="fast"
# ----------------------------------------------------------------------

FAST = dict(train_cases.BASE, objective="binary", num_leaves=15,
            tpu_round_width=4)


def test_fast_trees_match_the_jax_package():
    X, y = train_cases._data(1, 2000, "binary")
    p = dict(FAST, tpu_tree_growth="fast")
    bj = lgb.train(dict(p), lgb.Dataset(X, label=y), 3, verbose_eval=False)
    bt = lt.train(dict(p), lt.Dataset(X, label=y, device="cpu"), 3,
                  verbose_eval=False)
    exact = lt.train(dict(FAST), lt.Dataset(X, label=y, device="cpu"), 3,
                     verbose_eval=False)
    assert bt.boosting.grower.cfg.rounds_relaxed
    jm = load_model_from_string(bj.model_to_string())["models"]
    tm = load_model_from_string(bt.model_to_string())["models"]
    em = load_model_from_string(exact.model_to_string())["models"]
    assert len(jm) == len(tm) == 3
    for j, t in zip(jm, tm):
        assert j.num_leaves == t.num_leaves
        for f in train_cases.TREE_EXACT:
            assert np.array_equal(getattr(j, f), getattr(t, f)), f
        np.testing.assert_allclose(t.leaf_value, j.leaf_value, rtol=1e-4,
                                   atol=1e-6)
    # whole batches: the fast trees leave the exact best-first order
    assert any(not np.array_equal(t.split_feature, e.split_feature)
               or not np.array_equal(t.left_child, e.left_child)
               for t, e in zip(tm, em))


def test_fast_mode_trains_equivalent_quality():
    """tests/test_rounds.py's case at 2,000 rows: fast growth may pick
    another final-level split set, but trains to the quality of exact
    growth."""
    rng = np.random.RandomState(2)
    n = 2000
    X = rng.rand(n, 10).astype(np.float32)
    y = ((X[:, 0] + X[:, 1] * X[:, 2] - X[:, 3] + 0.2 * rng.randn(n)) > 0.2
         ).astype(np.float32)
    Xt, yt, Xv, yv = X[:1500], y[:1500], X[1500:], y[1500:]
    loss = {}
    for mode in ("rounds", "fast"):
        params = {"objective": "binary", "num_leaves": 31, "max_bin": 32,
                  "metric": "binary_logloss", "verbose": -1,
                  "min_data_in_leaf": 5, "tpu_tree_growth": mode}
        ds = lt.Dataset(Xt, label=yt, device="cpu")
        evals = {}
        bst = lt.train(params, ds, 10, valid_sets=[ds.create_valid(
            Xv, label=yv)], valid_names=["v"], evals_result=evals,
            verbose_eval=False)
        assert bst.models[0].num_leaves == 31
        loss[mode] = evals["v"]["binary_logloss"][-1]
    assert abs(loss["fast"] - loss["rounds"]) < 0.01, loss


if __name__ == "__main__":
    print_digests()
