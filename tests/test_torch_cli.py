"""The port's CLI (``python -m lightgbm_tpu_torch``) against the JAX
package's (``lightgbm_tpu.application``) on synthetic files: the
``train``, ``predict``, ``refit`` and ``convert_model`` tasks,
``resume_from=`` (the bundles of ``snapshot_freq``), and the non-zero
exit on a host without CUDA when ``device_type=cpu`` is not given
(tests/test_cli.py's cases, which read the reference's examples, on
files each run writes).

The port's tasks run as subprocesses (one thread each, with a timeout;
the four that read the trained model run side by side); the JAX
package's run in-process, once a module.  Trees are held to the JAX
package's with ``assert_same_trees`` (test_torch_objectives.py's
tolerances); the CLI's predictions equal the port's in-process
``Booster.predict`` within rtol 1e-9, as tests/test_cli.py holds the JAX
CLI's."""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

import lightgbm_tpu as lgb
from lightgbm_tpu.application import Application as JApplication

import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch.testing import one_thread  # noqa: F401
from test_torch_objectives import assert_same_trees

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROUNDS = 6
CONF = f"""# synthetic binary task
task = train
objective = binary
data = binary.train
valid_data = binary.test
num_trees = {ROUNDS}
num_leaves = 7
min_data_in_leaf = 5
metric = binary_logloss
tpu_tree_growth = rounds
tpu_hist_method = fused
device_type = cpu
"""


def _write_data(d):
    rng = np.random.RandomState(7)
    for name, n in (("binary.train", 300), ("binary.test", 100)):
        X = rng.rand(n, 5)
        y = (X[:, 0] + X[:, 1] * X[:, 2] > 0.7).astype(int)
        np.savetxt(d / name, np.column_stack([y, X]), delimiter="\t",
                   fmt="%.9g")
    (d / "train.conf").write_text(CONF)


def _start(args, cwd):
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1",
               JAX_PLATFORMS="cpu")
    return subprocess.Popen([sys.executable, "-m", "lightgbm_tpu_torch"]
                            + args, cwd=str(cwd), env=env, text=True,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE)


def _finish(procs, timeout=240):
    out = {}
    for name, p in procs.items():
        try:
            so, se = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            p.kill()
            so, se = p.communicate()
        out[name] = subprocess.CompletedProcess(p.args, p.returncode, so, se)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every port CLI run of the module: train (snapshots every 3) and a
    run without ``device_type``, then predict, resume (the same
    arguments and ``resume_from``: the bundle of iteration 3 is the
    newest left), refit and convert_model side by side."""
    d = tmp_path_factory.mktemp("cli")
    _write_data(d)
    first = _finish({
        "train": _start(["config=train.conf", "output_model=m.txt",
                         "snapshot_freq=3"], d),
        "no_cuda": _start(["config=train.conf", "device_type=",
                           "output_model=never.txt"], d)})
    assert first["train"].returncode == 0, first["train"].stderr[-2000:]
    os.remove(d / "m.txt.ckpt" / f"ckpt_iter_{ROUNDS:08d}.lgbckpt")
    second = {
        "predict": _start(["task=predict", "data=binary.test",
                           "input_model=m.txt", "output_result=preds.txt",
                           "device_type=cpu"], d),
        "resume": _start(["config=train.conf", "output_model=r.txt",
                          "snapshot_freq=3", "resume_from=m.txt.ckpt"], d),
        "refit": _start(["task=refit", "data=binary.test",
                         "input_model=m.txt", "output_model=refit.txt",
                         "objective=binary", "device_type=cpu"], d),
        "convert": _start(["task=convert_model", "input_model=m.txt",
                           "convert_model=m.cpp", "device=cpu"], d)}
    return d, {**first, **_finish(second)}


@pytest.fixture(scope="module")
def jax_runs(runs):
    """The JAX package's CLI tasks on the same files, in-process."""
    d, _ = runs
    j = d / "jax"
    j.mkdir()
    for args in (["task=train", f"output_model={j / 'm.txt'}"],
                 ["task=predict", f"data={d / 'binary.test'}",
                  f"input_model={j / 'm.txt'}",
                  f"output_result={j / 'preds.txt'}"],
                 ["task=refit", f"data={d / 'binary.test'}",
                  f"input_model={j / 'm.txt'}",
                  f"output_model={j / 'refit.txt'}", "objective=binary"],
                 ["task=convert_model", f"input_model={d / 'm.txt'}",
                  f"convert_model={j / 'm.cpp'}"]):
        conf = [f"config={d / 'train.conf'}"] if args[0] == "task=train" \
            else []
        JApplication(conf + args).run()
    return j


def _test_rows(d):
    return np.loadtxt(d / "binary.test")[:, 1:]


def test_cli_train_matches_the_jax_cli(runs, jax_runs):
    d, r = runs
    assert "runs on device cpu" in r["train"].stdout
    port = lt.Booster(model_file=str(d / "m.txt"), device="cpu")
    assert_same_trees(lgb.Booster(model_file=str(jax_runs / "m.txt")), port,
                      ROUNDS)


def test_cli_predict_matches_python_and_the_jax_cli(runs, jax_runs):
    d, r = runs
    assert r["predict"].returncode == 0, r["predict"].stderr[-2000:]
    cli_pred = np.loadtxt(d / "preds.txt")
    bst = lt.Booster(model_file=str(d / "m.txt"), device="cpu")
    np.testing.assert_allclose(cli_pred, bst.predict(_test_rows(d)),
                               rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(cli_pred, np.loadtxt(jax_runs / "preds.txt"),
                               rtol=1e-4, atol=1e-6)


def test_cli_resume_from_is_byte_identical(runs):
    d, r = runs
    assert r["resume"].returncode == 0, r["resume"].stderr[-2000:]
    assert "resume: restored iteration 3" in r["resume"].stdout
    assert (d / "r.txt").read_bytes() == (d / "m.txt").read_bytes()


def test_cli_refit_matches_the_jax_cli(runs, jax_runs):
    d, r = runs
    assert r["refit"].returncode == 0, r["refit"].stderr[-2000:]
    assert_same_trees(lgb.Booster(model_file=str(jax_runs / "refit.txt")),
                      lt.Booster(model_file=str(d / "refit.txt"),
                                 device="cpu"), ROUNDS)


def test_cli_convert_model_compiles_and_matches(runs, jax_runs):
    d, r = runs
    assert r["convert"].returncode == 0, r["convert"].stderr[-2000:]
    # the same model converts to the same source in both packages
    assert (d / "m.cpp").read_text() == (jax_runs / "m.cpp").read_text()
    if shutil.which("g++") is None:
        pytest.skip("no g++")
    harness = r"""
#include <cstdio>
#include <cstdlib>
extern "C" void Predict(const double*, double*);
int main(int argc, char** argv) {
  int nf = atoi(argv[1]);
  double feat[256], out[8];
  while (true) {
    for (int i = 0; i < nf; ++i)
      if (scanf("%lf", &feat[i]) != 1) return 0;
    Predict(feat, out);
    printf("%.17g\n", out[0]);
  }
}
"""
    (d / "main.cpp").write_text(harness)
    c = subprocess.run(["g++", "-O1", "-o", "pred", "m.cpp", "main.cpp"],
                       cwd=str(d), capture_output=True, text=True,
                       timeout=120)
    assert c.returncode == 0, c.stderr[-2000:]
    Xt = _test_rows(d)[:32]
    inp = "\n".join(" ".join(f"{v:.17g}" for v in row) for row in Xt)
    run = subprocess.run(["./pred", str(Xt.shape[1])], input=inp,
                         cwd=str(d), capture_output=True, text=True,
                         timeout=60)
    cpp_raw = np.array([float(v) for v in run.stdout.split()])
    bst = lt.Booster(model_file=str(d / "m.txt"), device="cpu")
    np.testing.assert_allclose(cpp_raw,
                               bst.predict(Xt, raw_score=True, device=False),
                               rtol=1e-12, atol=1e-12)


def test_cli_without_device_type_exits_on_a_host_without_cuda(runs):
    import torch
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA; the refusal needs a host without")
    d, r = runs
    assert r["no_cuda"].returncode != 0
    assert "runs on a CUDA device" in r["no_cuda"].stderr
    assert not (d / "never.txt").exists()
