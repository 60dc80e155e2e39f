"""Checkpoints and pause control in the port
(``lightgbm_tpu_torch.resilience.checkpoint``, ``engine.train``'s
``snapshot_freq``/``resume_from``/``pause_control``), mirroring every
case of tests/test_resilience.py on the CPU, and more:

- a run resumed from a bundle ends with the uninterrupted run's model
  text BYTE for byte and its evaluation history, for bagging, DART
  (uniform and not), GOSS, RF, CEGB, quantized gradients,
  ``extra_trees``, multiclass, lambdarank and continued training
  (``init_model=``); from a chunked run into a per-iteration one and
  back; after a pause; and from a bundle another process wrote;
- early stopping's state across the resume, its best iteration before
  and after the bundle;
- corruption, truncation, retention, resolution of ``resume_from``,
  the standalone ``model.txt`` member, atomic writes into new
  directories, the ``checkpoint.save``/``checkpoint.load`` spans;
- against the JAX package: the manifest's keys are its keys (the format
  tag is the port's own), a JAX bundle is refused without importing
  ``lightgbm_tpu`` (in a subprocess), and the port's resumed models hold
  the JAX package's uninterrupted models under ``assert_same_trees``
  with test_torch_objectives.py's (f32) and test_torch_quantized.py's
  (quantized) tolerances.

The port resumes from the full run's own bundle of iteration 6: a
snapshot does not change training (``test_snapshots_do_not_change_
training``), so that bundle is the one a run killed after iteration 6
would have left."""

import glob
import json
import os
import subprocess
import sys
import zipfile

import numpy as np
import pytest

import lightgbm_tpu as lgb

import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch.engine import TrainingPaused
from lightgbm_tpu_torch.resilience import (CheckpointCorruptError,
                                           CheckpointError,
                                           CheckpointManager,
                                           CheckpointNotFoundError,
                                           load_checkpoint, save_checkpoint)
from lightgbm_tpu_torch.testing import one_thread  # noqa: F401
from test_torch_objectives import assert_same_trees

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROUNDS, FREQ, AT = 12, 3, 6
BASE = {"objective": "binary", "num_leaves": 7, "verbosity": -1,
        "min_data_in_leaf": 5}
PARITY = {"tpu_tree_growth": "rounds", "tpu_hist_method": "fused"}


def _data(seed=0, n=400, f=6, label="binary"):
    rng = np.random.RandomState(seed)
    X = rng.rand(n, f)
    Xv = rng.rand(n // 2, f)

    def lab(A):
        s = A[:, 0] + A[:, 1] * A[:, 2]
        if label == "multiclass":
            return np.digitize(s, [0.5, 0.9]).astype(np.float32)
        if label == "rank":
            return np.digitize(s, [0.4, 0.7, 1.0]).astype(np.float32)
        return (s > 0.8).astype(np.float32)
    return X, lab(X), Xv, lab(Xv)


def _ds(X, y, label="binary", **kw):
    group = [20] * (len(X) // 20) if label == "rank" else None
    return lt.Dataset(X, label=y, group=group, device="cpu", **kw)


def _train(params, rounds, label="binary", **kw):
    X, y, Xv, yv = _data(label=label)
    ev = {}
    ds = _ds(X, y, label, free_raw_data=False)
    bst = lt.train(params, ds, rounds,
                   valid_sets=[_ds(Xv, yv, label, free_raw_data=False)],
                   evals_result=ev, verbose_eval=False, **kw)
    return bst, ev


def _resume_parity(tmp_path, params, label="binary", **kw):
    """The full run with a bundle every FREQ iterations, then a fresh run
    resumed from its bundle of iteration AT: the same model text, eval
    history and best iteration."""
    snap = str(tmp_path / "m.txt")
    full, ev_full = _train(params, ROUNDS, label, snapshot_freq=FREQ,
                           snapshot_out=snap, **kw)
    bundle = f"{snap}.ckpt/ckpt_iter_{AT:08d}.lgbckpt"
    res, ev_res = _train(params, ROUNDS, label, resume_from=bundle, **kw)
    assert res.model_to_string() == full.model_to_string(), \
        "the resumed model text is not byte-identical"
    assert res.best_iteration == full.best_iteration
    assert ev_res == ev_full, "the resumed eval history diverged"
    return full, res


MODES = {
    "bagging": {"bagging_fraction": 0.7, "bagging_freq": 2,
                "feature_fraction": 0.8},
    "dart": {"boosting": "dart", "drop_rate": 0.5},
    "dart_nonuniform": {"boosting": "dart", "drop_rate": 0.5,
                        "uniform_drop": False},
    "goss": {"boosting": "goss", "learning_rate": 0.3},
    "rf": {"boosting": "rf", "bagging_fraction": 0.7, "bagging_freq": 1},
    # already charged penalties must not be charged again
    "cegb": {"cegb_tradeoff": 0.5, "cegb_penalty_split": 0.1,
             "cegb_penalty_feature_coupled": [0.4] * 6,
             "cegb_penalty_feature_lazy": [0.3] * 6},
    # stochastic rounding's key is fold_in(base, iter)
    "quantized": {"use_quantized_grad": True, "bagging_fraction": 0.7,
                  "bagging_freq": 1},
    # per-node randomness, keyed the same way
    "extra_trees": {"extra_trees": True, "feature_fraction_bynode": 0.5},
}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_resume_bit_identical(tmp_path, mode):
    _resume_parity(tmp_path, dict(BASE, **MODES[mode]))


def test_resume_bit_identical_multiclass(tmp_path):
    _resume_parity(tmp_path, dict(BASE, objective="multiclass", num_class=3,
                                  bagging_fraction=0.8, bagging_freq=1),
                   label="multiclass")


def test_resume_bit_identical_lambdarank(tmp_path):
    _resume_parity(tmp_path, dict(BASE, objective="lambdarank",
                                  min_data_in_leaf=3), label="rank")


def test_resume_bit_identical_continued_training(tmp_path):
    """``init_model`` trees come first: the resumed run keeps the init
    model's iterations apart from its own (``num_init_iteration``) and
    its keys at the same ``iter``."""
    X, y, _, _ = _data()
    params = dict(BASE, bagging_fraction=0.7, bagging_freq=1,
                  use_quantized_grad=True)
    init = lt.train(params, _ds(X, y), 3, verbose_eval=False)
    full, res = _resume_parity(tmp_path, params, init_model=init)
    assert res.boosting.num_init_iteration == 3
    assert full.num_trees() == 3 + ROUNDS


def test_snapshots_do_not_change_training(tmp_path):
    params = dict(BASE, **MODES["bagging"])
    plain, ev_plain = _train(params, ROUNDS)
    snap, ev_snap = _train(params, ROUNDS, snapshot_freq=FREQ,
                           snapshot_out=str(tmp_path / "m.txt"))
    assert snap.model_to_string() == plain.model_to_string()
    assert ev_snap == ev_plain


@pytest.mark.parametrize("write,read", [("32", "0"), ("0", "32")])
def test_chunk_plans_are_interchangeable(tmp_path, monkeypatch, write, read):
    """A bundle of a chunked run (``LGBM_TPU_CHUNK=32``: chunks end at
    each snapshot and evaluation) resumes into a per-iteration run
    (``0``), and the other way round, to the same text."""
    params = dict(BASE, **MODES["bagging"])
    monkeypatch.setenv("LGBM_TPU_CHUNK", write)
    snap = str(tmp_path / "m.txt")
    X, y, _, _ = _data()
    full = lt.train(params, _ds(X, y), ROUNDS, verbose_eval=False,
                    snapshot_freq=FREQ, snapshot_out=snap)
    with zipfile.ZipFile(f"{snap}.ckpt/ckpt_iter_{AT:08d}.lgbckpt") as zf:
        assert json.loads(zf.read("manifest.json"))["chunk_cap"] == int(
            write)
    monkeypatch.setenv("LGBM_TPU_CHUNK", read)
    res = lt.train(params, _ds(X, y), ROUNDS, verbose_eval=False,
                   resume_from=f"{snap}.ckpt/ckpt_iter_{AT:08d}.lgbckpt")
    assert res.model_to_string() == full.model_to_string()


class _PauseAt:
    """A pause control: "pause" at iteration ``at``, chunks of at most
    ``cap``; it records every iteration it was consulted at."""

    def __init__(self, at, cap=2):
        self.at, self.cap, self.seen = at, cap, []

    def consult(self, i):
        self.seen.append(i)
        return "pause" if i == self.at else "run"

    def chunk_cap(self):
        return self.cap


def test_pause_and_resume(tmp_path):
    """With no evaluation to end them, chunks run to the pause control's
    cap (2), and it is consulted at each chunk's start."""
    params = dict(BASE, **MODES["quantized"])
    X, y, _, _ = _data()
    full = lt.train(params, _ds(X, y), ROUNDS, verbose_eval=False)
    ctl = _PauseAt(4)
    with pytest.raises(TrainingPaused) as e:
        lt.train(params, _ds(X, y), ROUNDS, verbose_eval=False,
                 pause_control=ctl, snapshot_out=str(tmp_path / "p.txt"))
    assert e.value.iteration == 4 and ctl.seen == [0, 2, 4]
    assert os.path.basename(e.value.bundle_path) == \
        "ckpt_iter_00000004.lgbckpt"
    res = lt.train(params, _ds(X, y), ROUNDS, verbose_eval=False,
                   resume_from=e.value.bundle_path,
                   pause_control=_PauseAt(-1))
    assert res.model_to_string() == full.model_to_string()


def test_pause_with_evaluations_resumes_the_history(tmp_path):
    params = dict(BASE, **MODES["bagging"])
    full, ev_full = _train(params, ROUNDS, early_stopping_rounds=20)
    with pytest.raises(TrainingPaused) as e:
        _train(params, ROUNDS, pause_control=_PauseAt(7),
               early_stopping_rounds=20,
               snapshot_out=str(tmp_path / "p.txt"))
    res, ev_res = _train(params, ROUNDS, resume_from=e.value.bundle_path,
                         early_stopping_rounds=20)
    assert res.model_to_string() == full.model_to_string()
    assert ev_res == ev_full
    assert res.best_iteration == full.best_iteration
    assert res.best_score == full.best_score


_WRITER = """
import sys
import numpy as np
sys.path.insert(0, {repo!r})
import lightgbm_tpu_torch as lt
rng = np.random.RandomState(0)
X = rng.rand(400, 6)
y = (X[:, 0] + X[:, 1] * X[:, 2] > 0.8).astype(np.float32)
lt.train({params!r}, lt.Dataset(X, label=y, device="cpu"), 6,
         verbose_eval=False, snapshot_freq=3, snapshot_out={snap!r})
print("modules", "lightgbm_tpu" in sys.modules, "jax" in sys.modules)
"""


def test_bundle_resumes_in_another_process(tmp_path):
    snap = str(tmp_path / "w.txt")
    env = dict(os.environ, OMP_NUM_THREADS="1", JAX_PLATFORMS="cpu")
    params = dict(BASE, **MODES["goss"])
    r = subprocess.run([sys.executable, "-c", _WRITER.format(
        repo=REPO, params=params, snap=snap)],
        env=env, capture_output=True, text=True, timeout=240)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "modules False False" in r.stdout
    X, y, _, _ = _data()
    full = lt.train(params, _ds(X, y), ROUNDS, verbose_eval=False)
    res = lt.train(params, _ds(X, y), ROUNDS, verbose_eval=False,
                   resume_from=f"{snap}.ckpt")
    assert res.model_to_string() == full.model_to_string()


def _early_stop(tmp_path, die_after, flip=None):
    """tests/test_resilience.py::test_resume_early_stopping_state on the
    port: a valid set of noise labels (or the training rule with a share
    ``flip`` of its labels flipped) stops training early; the bundles of
    a run killed after ``die_after`` iterations, every 2."""
    rng = np.random.RandomState(3)
    X = rng.rand(400, 6)
    y = (X[:, 0] > 0.5).astype(np.float32)
    Xv = rng.rand(150, 6)
    if flip is None:
        yv = (rng.rand(150) > 0.5).astype(np.float32)
    else:
        yv = (Xv[:, 0] > 0.5).astype(np.float32)
        f = rng.rand(150) < flip
        yv[f] = 1 - yv[f]

    def run(rounds, **kw):
        return lt.train(BASE, _ds(X, y), rounds,
                        valid_sets=[_ds(Xv, yv)], verbose_eval=False,
                        early_stopping_rounds=4, **kw)

    full = run(40)
    run(die_after, snapshot_freq=2, snapshot_out=str(tmp_path / "p.txt"))
    res = run(40, resume_from=str(tmp_path / "p.txt.ckpt"))
    assert full.best_iteration < 40, "the case needs early stopping"
    assert res.model_to_string() == full.model_to_string()
    assert res.best_iteration == full.best_iteration
    assert res.best_score == full.best_score
    return full


def test_resume_early_stopping_state(tmp_path):
    # the JAX package's case: noise labels, the bundle of iteration 4
    _early_stop(tmp_path, 4)


def test_resume_early_stopping_best_after_the_bundle(tmp_path):
    full = _early_stop(tmp_path, 4, flip=0.2)
    assert full.best_iteration > 4


def test_resume_early_stopping_best_before_the_bundle(tmp_path):
    full = _early_stop(tmp_path, 12, flip=0.2)
    assert full.best_iteration < 12 < full.num_trees()


def test_early_stopping_is_off_under_dart():
    """ROADMAP C-25: as in the JAX package (its callback.py's
    ``enabled``), early stopping warns and stands aside under DART, and
    its state says so."""
    rng = np.random.RandomState(3)
    X = rng.rand(400, 6)
    y = (X[:, 0] > 0.5).astype(np.float32)
    Xv = rng.rand(150, 6)
    yv = (rng.rand(150) > 0.5).astype(np.float32)
    cb = lt.early_stopping(2, verbose=False)
    with pytest.warns(UserWarning, match="dart"):
        bst = lt.train(dict(BASE, **MODES["dart"]), _ds(X, y), 12,
                       valid_sets=[_ds(Xv, yv)], verbose_eval=False,
                       callbacks=[cb])
    assert bst.num_trees() == 12
    assert cb.get_state()["enabled"] is False


def test_corrupted_newest_bundle_falls_back(tmp_path):
    X, y, _, _ = _data()
    lt.train(BASE, _ds(X, y), 9, verbose_eval=False, snapshot_freq=3,
             snapshot_out=str(tmp_path / "m.txt"))
    d = tmp_path / "m.txt.ckpt"
    bundles = sorted(p for p in os.listdir(d) if p.endswith(".lgbckpt"))
    assert bundles == ["ckpt_iter_00000003.lgbckpt",
                       "ckpt_iter_00000006.lgbckpt",
                       "ckpt_iter_00000009.lgbckpt"]
    newest = d / bundles[-1]
    blob = bytearray(newest.read_bytes())
    blob[len(blob) // 2] ^= 0xFF
    newest.write_bytes(bytes(blob))
    with pytest.raises(CheckpointCorruptError):
        load_checkpoint(str(newest))
    assert CheckpointManager(str(d)).latest_verified().iteration == 6
    res = lt.train(BASE, _ds(X, y), 9, verbose_eval=False,
                   resume_from=str(d))
    assert len(res.boosting.models) == 9


def test_truncated_bundle_detected(tmp_path):
    X, y, _, _ = _data()
    bst = lt.train(BASE, _ds(X, y), 3, verbose_eval=False)
    p = tmp_path / "one.lgbckpt"
    save_checkpoint(bst, str(p), iteration=3)
    p.write_bytes(p.read_bytes()[:p.stat().st_size // 2])
    with pytest.raises(CheckpointCorruptError):
        load_checkpoint(str(p))


def test_all_bundles_corrupt_raises_not_found(tmp_path):
    X, y, _, _ = _data()
    lt.train(BASE, _ds(X, y), 4, verbose_eval=False, snapshot_freq=2,
             snapshot_out=str(tmp_path / "m.txt"))
    d = tmp_path / "m.txt.ckpt"
    for name in os.listdir(d):
        if name.endswith(".lgbckpt"):
            (d / name).write_bytes(b"garbage")
    with pytest.raises(CheckpointNotFoundError):
        CheckpointManager(str(d)).latest_verified()


def test_retention_keeps_last_k(tmp_path):
    X, y, _, _ = _data()
    lt.train(BASE, _ds(X, y), 10, verbose_eval=False, snapshot_freq=2,
             snapshot_out=str(tmp_path / "m.txt"), snapshot_keep=2)
    d = tmp_path / "m.txt.ckpt"
    assert sorted(p for p in os.listdir(d) if p.endswith(".lgbckpt")) == [
        "ckpt_iter_00000008.lgbckpt", "ckpt_iter_00000010.lgbckpt"]
    assert json.loads((d / "index.json").read_text())["bundles"] == [
        "ckpt_iter_00000008.lgbckpt", "ckpt_iter_00000010.lgbckpt"]


def test_resume_from_specific_bundle_file(tmp_path):
    X, y, _, _ = _data()
    lt.train(BASE, _ds(X, y), 6, verbose_eval=False, snapshot_freq=2,
             snapshot_out=str(tmp_path / "m.txt"))
    bundle = tmp_path / "m.txt.ckpt" / "ckpt_iter_00000004.lgbckpt"
    res = lt.train(BASE, _ds(X, y), 6, verbose_eval=False,
                   resume_from=str(bundle))
    assert len(res.boosting.models) == 6


def test_resume_missing_location_raises(tmp_path):
    X, y, _, _ = _data()
    with pytest.raises(CheckpointNotFoundError):
        lt.train(BASE, _ds(X, y), 3, verbose_eval=False,
                 resume_from=str(tmp_path / "nope"))


def test_resume_into_another_row_layout_raises(tmp_path):
    X, y, _, _ = _data()
    bst = lt.train(BASE, _ds(X, y), 3, verbose_eval=False)
    p = str(tmp_path / "b.lgbckpt")
    save_checkpoint(bst, p, iteration=3)
    with pytest.raises(ValueError, match=r"A9 \(resilience/elastic.py\)"):
        lt.train(BASE, _ds(X[:300], y[:300]), 6, verbose_eval=False,
                 resume_from=p)


def test_bundle_model_txt_member_loads_standalone(tmp_path):
    X, y, _, _ = _data()
    bst = lt.train(BASE, _ds(X, y), 5, verbose_eval=False)
    p = str(tmp_path / "b.lgbckpt")
    save_checkpoint(bst, p, iteration=5)
    ck = load_checkpoint(p)
    loaded = lt.Booster(model_str=ck.model_str, device="cpu")
    np.testing.assert_allclose(loaded.predict(X[:16]), bst.predict(X[:16]),
                               rtol=1e-6)
    # the member loads in the JAX package too
    np.testing.assert_allclose(lgb.Booster(model_str=ck.model_str).predict(
        X[:16]), bst.predict(X[:16]), rtol=1e-5)


def test_save_model_atomic_creates_parent_dirs(tmp_path):
    X, y, _, _ = _data()
    bst = lt.train(BASE, _ds(X, y), 2, verbose_eval=False)
    target = tmp_path / "does" / "not" / "exist" / "model.txt"
    bst.save_model(str(target))
    assert os.listdir(target.parent) == ["model.txt"]
    reload = lt.Booster(model_file=str(target), device="cpu")
    np.testing.assert_allclose(reload.predict(X[:8]), bst.predict(X[:8]),
                               rtol=1e-6)


def test_snapshot_out_into_new_dir(tmp_path):
    X, y, _, _ = _data()
    out = tmp_path / "fresh" / "dir" / "m.txt"
    lt.train(BASE, _ds(X, y), 4, verbose_eval=False, snapshot_freq=2,
             snapshot_out=str(out))
    assert (out.parent / "m.txt.ckpt" / "index.json").is_file()
    assert not [f for f in os.listdir(out.parent / "m.txt.ckpt")
                if ".tmp." in f]


def test_checkpoint_spans_appear(tmp_path):
    """tests/test_obs.py's case on the port."""
    from lightgbm_tpu_torch.obs import global_registry, global_tracer
    X, y, _, _ = _data()
    before = global_registry.to_dict()["histograms"]

    def count(d, name):
        return d.get(name, {}).get("count", 0)

    global_tracer.reset()
    global_tracer.enable()
    try:
        lt.train(BASE, _ds(X, y), 4, verbose_eval=False, snapshot_freq=2,
                 snapshot_out=str(tmp_path / "m.txt"))
        lt.train(BASE, _ds(X, y), 4, verbose_eval=False,
                 resume_from=str(tmp_path / "m.txt.ckpt"))
        names = [e["name"] for e in global_tracer.events()]
        assert "checkpoint.save" in names and "checkpoint.load" in names
    finally:
        global_tracer.disable()
        global_tracer.reset()
    after = global_registry.to_dict()["histograms"]
    assert count(after, "checkpoint_save_ms") - count(
        before, "checkpoint_save_ms") >= 2
    assert count(after, "checkpoint_load_ms") - count(
        before, "checkpoint_load_ms") >= 1


# ----------------------------------------------------------------------
# against the JAX package
# ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    """The JAX package's uninterrupted f32 and quantized runs (rounds
    grower, fused arm), the f32 one writing bundles."""
    d = tmp_path_factory.mktemp("jax_ckpt")
    X, y, Xv, yv = _data()
    out = {}
    for name, mode in (("f32", "bagging"), ("quantized", "quantized")):
        params = dict(BASE, **MODES[mode], **PARITY)
        dj = lgb.Dataset(X, label=y)
        kw = ({"snapshot_freq": FREQ, "snapshot_out": str(d / "j.txt")}
              if name == "f32" else {})
        out[name] = lgb.train(params, dj, ROUNDS,
                              valid_sets=[lgb.Dataset(Xv, label=yv,
                                                      reference=dj)],
                              verbose_eval=False, **kw)
    out["bundle"] = str(d / "j.txt.ckpt" / f"ckpt_iter_{AT:08d}.lgbckpt")
    return out


@pytest.mark.parametrize("name,tol", [
    ("f32", {}),
    ("quantized", {"rtol": 1e-5, "atol": 0.0, "atol_of_largest": 1e-5})])
def test_resumed_model_holds_the_jax_uninterrupted_model(
        tmp_path, jax_runs, name, tol):
    mode = "bagging" if name == "f32" else "quantized"
    _, res = _resume_parity(tmp_path, dict(BASE, **MODES[mode], **PARITY))
    assert_same_trees(jax_runs[name], res, ROUNDS, **tol)


def test_manifest_keys_are_the_jax_packages(tmp_path, jax_runs):
    X, y, _, _ = _data()
    lt.train(dict(BASE, **MODES["bagging"]), _ds(X, y), AT,
             verbose_eval=False, snapshot_freq=FREQ,
             snapshot_out=str(tmp_path / "m.txt"))
    (port,) = glob.glob(str(tmp_path / "m.txt.ckpt" / f"*{AT:08d}*"))
    mans = []
    for path in (port, jax_runs["bundle"]):
        with zipfile.ZipFile(path) as zf:
            assert sorted(zf.namelist()) == ["manifest.json", "model.txt",
                                             "state.pkl"]
            mans.append(json.loads(zf.read("manifest.json")))
    tman, jman = mans
    assert tman.keys() == jman.keys()
    assert tman["members"].keys() == jman["members"].keys()
    for member in tman["members"].values():
        assert member.keys() == {"sha256", "size"}
    assert (tman["format"], jman["format"]) == ("lgbt-ckpt-torch/1",
                                                "lgbt-ckpt/1")
    assert tman["iteration"] == jman["iteration"] == AT
    assert tman["hist_plan"]["variant"] == "fused"
    assert tman["stream_plan"] is None      # a resident run


_REFUSE = """
import io, json, sys, zipfile, hashlib
sys.path.insert(0, {repo!r})
import numpy as np
import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch.resilience import (CheckpointError,
                                           CheckpointCorruptError,
                                           load_checkpoint)
from lightgbm_tpu_torch.resilience.checkpoint import decode_bundle_bytes
rng = np.random.RandomState(0)
X = rng.rand(400, 6)
y = (X[:, 0] > 0.5).astype(np.float32)
try:
    lt.train({{"objective": "binary", "verbosity": -1}},
             lt.Dataset(X, label=y, device="cpu"), 8, verbose_eval=False,
             resume_from={bundle!r})
    print("not refused")
except CheckpointError as e:
    assert not isinstance(e, CheckpointCorruptError)
    print("refused", "init_model" in str(e))
# the same state.pkl under the port's tag, checksums made good: the
# unpickler refuses the JAX package's classes
zin = zipfile.ZipFile({bundle!r})
man = json.loads(zin.read("manifest.json"))
man["format"] = "lgbt-ckpt-torch/1"
buf = io.BytesIO()
with zipfile.ZipFile(buf, "w") as zout:
    zout.writestr("manifest.json", json.dumps(man))
    for m in ("model.txt", "state.pkl"):
        zout.writestr(m, zin.read(m))
try:
    decode_bundle_bytes(buf.getvalue())
    print("unpickled")
except CheckpointCorruptError as e:
    print("unpickler refused", "lightgbm_tpu" in str(e))
print("modules", "lightgbm_tpu" in sys.modules, "jax" in sys.modules)
"""


def test_jax_bundle_refused_without_importing_the_jax_package(jax_runs):
    env = dict(os.environ, OMP_NUM_THREADS="1", JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", _REFUSE.format(
        repo=REPO, bundle=jax_runs["bundle"])], env=env,
        capture_output=True, text=True, timeout=240)
    assert r.returncode == 0, r.stderr[-2000:]
    out = r.stdout.splitlines()
    assert "refused True" in out
    assert "unpickler refused True" in out
    assert "modules False False" in out


def test_jax_bundle_error_names_init_model(jax_runs):
    with pytest.raises(CheckpointError, match="init_model"):
        load_checkpoint(jax_runs["bundle"])
    # its model.txt member continues training in the port
    with zipfile.ZipFile(jax_runs["bundle"]) as zf:
        text = zf.read("model.txt").decode()
    X, y, _, _ = _data()
    init = lt.Booster(model_str=text, device="cpu")
    bst = lt.train(dict(BASE, **PARITY), _ds(X, y, free_raw_data=False), 2,
                   init_model=init, verbose_eval=False)
    assert bst.num_trees() == AT + 2
