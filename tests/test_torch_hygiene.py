"""Hygiene of the port package lightgbm_tpu_torch: it imports neither JAX
nor the JAX package, and its entry points never fall back to the CPU
quietly."""

import json
import os
import subprocess
import sys

import pytest

import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch.testing import synthetic_model_text

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r"""
import importlib, json, pkgutil, sys
import lightgbm_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "lightgbm_tpu"))
print(json.dumps({"modules": names, "bad": bad}))
"""


def test_import_pulls_in_no_jax():
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["bad"] == []
    for mod in ("basic", "convert", "model_text", "predict", "testing",
                "tree", "obs.metrics", "ops._build", "ops.planner",
                "ops.predict_kernels", "serving.batcher", "serving.errors",
                "serving.registry", "serving.server", "utils.log",
                "binning", "dataset", "engine", "grower", "grower_rounds",
                "boosting.gbdt", "ops.fused", "ops.histogram", "ops.ingest",
                "ops.split", "tools.torch_ingest_compare"):
        assert f"lightgbm_tpu_torch.{mod}" in res["modules"]


def test_default_device_is_cuda_and_never_falls_back():
    import torch
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA; the refusal needs a host without")
    text = synthetic_model_text(3, 2, 4, seed=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        lt.Booster(model_str=text)
    with pytest.raises(RuntimeError, match="CUDA"):
        lt.Booster(model_str=text, device="cuda")
    assert lt.Booster(model_str=text, device="cpu").device.type == "cpu"
