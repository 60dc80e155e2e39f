"""CLI application: config-file driven train, refit, predict and
convert_model (counterpart of ``lightgbm_tpu/application.py``).

reference: src/application/application.cpp: LoadParameters (:49),
LoadData (:84), InitTrain (:164), Train (:201), Predict (:212), driven
by ``task=`` (src/main.cpp:11).  Usage mirrors the reference CLI:

    python -m lightgbm_tpu_torch config=train.conf [key=value ...]

Config files are ``key = value`` lines with ``#`` comments; command-line
pairs override file entries (application.cpp:49-82).  Relative data
paths resolve against the config file's directory, so the stock
``examples/*/train.conf`` files run unchanged; outputs go to the
working directory.  ``resume_from=`` (a checkpoint bundle or the
``<output_model>.ckpt`` directory that ``snapshot_freq`` fills) resumes
a training byte-identically.

Every task runs on the device ``device_type`` (alias ``device``) names,
as the C API's handles do: ``cpu`` asks for the CPU; unset, ``tpu``,
``gpu`` or ``cuda`` mean the CUDA card, and on a host without one the
CLI exits non-zero with the port's "runs on a CUDA device" error; the
task logs its device at info level.  The CPU's torch thread count
follows ``OMP_NUM_THREADS``.
"""

from __future__ import annotations

import os
import sys
from typing import Dict, List

import numpy as np

from .basic import Booster, device_from_params
from .config import Config
from .dataset import Dataset
from .engine import train as train_fn
from .utils.log import log_info


def parse_config_file(path: str) -> Dict[str, str]:
    out: Dict[str, str] = {}
    with open(path) as fh:
        for ln in fh:
            ln = ln.split("#", 1)[0].strip()
            if not ln or "=" not in ln:
                continue
            k, v = ln.split("=", 1)
            out[k.strip()] = v.strip()
    return out


def parse_argv(argv: List[str]) -> Dict[str, str]:
    """key=value pairs; ``config=`` pulls in a config file (the command
    line wins)."""
    cli: Dict[str, str] = {}
    for a in argv:
        if "=" not in a:
            raise SystemExit(f"unknown argument {a!r}; expected key=value")
        k, v = a.split("=", 1)
        cli[k.strip()] = v.strip()
    params: Dict[str, str] = {}
    cfg_path = cli.get("config", cli.get("config_file"))
    if cfg_path:
        params.update(parse_config_file(cfg_path))
        params["__config_dir__"] = os.path.dirname(os.path.abspath(cfg_path))
    params.update(cli)
    return params


def _resolve(path: str, params: Dict[str, str]) -> str:
    if os.path.isabs(path) or os.path.exists(path):
        return path
    base = params.get("__config_dir__", "")
    cand = os.path.join(base, path)
    return cand if os.path.exists(cand) else path


class Application:
    """reference: class Application (src/application/application.h)."""

    def __init__(self, argv: List[str]):
        self.params = parse_argv(argv)
        self.task = self.params.get("task", "train")
        self.device = None

    def run(self) -> None:
        tasks = {"train": self.train, "refit": self.refit,
                 "refit_tree": self.refit, "predict": self.predict,
                 "prediction": self.predict, "test": self.predict,
                 "convert_model": self.convert_model}
        if self.task not in tasks:
            raise SystemExit(f"unknown task {self.task!r}")
        try:
            self.device = device_from_params(self.params)
        except (RuntimeError, ValueError) as e:
            raise SystemExit(f"lightgbm_tpu_torch: {e}") from e
        log_info(f"task={self.task} runs on device {self.device}")
        tasks[self.task]()

    # ------------------------------------------------------------------ train

    def train(self) -> None:
        p = dict(self.params)
        data_path = p.pop("data", None)
        if not data_path:
            raise SystemExit("no training data: set data=...")
        valid_paths = [v for v in p.pop("valid_data",
                                        p.pop("valid", "")).split(",") if v]
        output_model = p.pop("output_model", "LightGBM_model.txt")
        input_model = p.pop("input_model", None)
        # a checkpoint bundle or <output_model>.ckpt: the whole training
        # state, unlike input_model's continued training
        resume_from = p.pop("resume_from", None)
        p.pop("__config_dir__", None)
        cfg = Config.from_params(p)
        if cfg.num_machines > 1:
            # reference: the Application calls Network::Init only when
            # num_machines > 1 (application.cpp:96-98)
            from .parallel.network import init_network
            init_network(machines=cfg.machines or None,
                         local_listen_port=cfg.local_listen_port,
                         listen_time_out=cfg.time_out,
                         num_machines=cfg.num_machines or None,
                         machine_list_file=(cfg.machine_list_filename
                                            or None),
                         backend=("nccl" if self.device.type == "cuda"
                                  else "gloo"))
        train_set = Dataset(_resolve(data_path, self.params), params=p,
                            device=self.device)
        valid_sets = [Dataset(_resolve(v, self.params), params=p,
                              reference=train_set) for v in valid_paths]
        valid_names = [os.path.basename(v) for v in valid_paths]
        booster = train_fn(
            p, train_set, num_boost_round=cfg.num_iterations,
            valid_sets=valid_sets, valid_names=valid_names,
            init_model=input_model, verbose_eval=max(cfg.metric_freq, 1),
            snapshot_freq=cfg.snapshot_freq, snapshot_out=output_model,
            resume_from=resume_from)
        booster.save_model(output_model)
        log_info(f"Finished training; model saved to {output_model}")

    # ------------------------------------------------------------------ refit

    def _text_rows(self, data_path: str, p: dict):
        """A text file's rows (f64) and labels."""
        from .io_utils import load_text_dataset
        tmp_ds = Dataset(None, params=p, device=self.device)
        X = load_text_dataset(_resolve(data_path, self.params), tmp_ds)
        return X, tmp_ds.metadata.label

    def refit(self) -> None:
        """reference: task=refit (application.cpp:212-248): load
        input_model, refit its leaf values on ``data``, save."""
        p = dict(self.params)
        data_path = p.pop("data", None)
        if not data_path:
            raise SystemExit("no refit data: set data=...")
        input_model = p.pop("input_model", "LightGBM_model.txt")
        output_model = p.pop("output_model", "LightGBM_model.txt")
        p.pop("__config_dir__", None)
        p.pop("task", None)
        cfg = Config.from_params(p)
        booster = Booster(model_file=_resolve(input_model, self.params),
                          params=p, device=self.device)
        X, y = self._text_rows(data_path, p)
        refitted = booster.refit(X, y, decay_rate=cfg.refit_decay_rate, **p)
        refitted.save_model(output_model)
        log_info(f"Finished refit; model saved to {output_model}")

    # ---------------------------------------------------------------- predict

    def predict(self) -> None:
        p = dict(self.params)
        data_path = p.pop("data", None)
        if not data_path:
            raise SystemExit("no data to predict: set data=...")
        input_model = p.pop("input_model", "LightGBM_model.txt")
        output_result = p.pop("output_result", "LightGBM_predict_result.txt")
        booster = Booster(model_file=_resolve(input_model, self.params),
                          params=p, device=self.device)
        X, _ = self._text_rows(data_path, p)

        def flag(key):
            return str(p.get(key, "false")).lower() == "true"

        pred = np.atleast_1d(booster.predict(
            X, raw_score=flag("predict_raw_score"),
            pred_leaf=flag("predict_leaf_index"),
            pred_contrib=flag("predict_contrib")))
        from .utils.file_io import open_atomic
        with open_atomic(output_result, "w") as fh:
            if pred.ndim == 1:
                for v in pred:
                    fh.write(f"{v:.18g}\n")
            else:
                for row in pred:
                    fh.write("\t".join(f"{v:.18g}" for v in row) + "\n")
        log_info(f"Finished prediction; results saved to {output_result}")

    # ---------------------------------------------------------- convert_model

    def convert_model(self) -> None:
        from .model_text import model_to_if_else
        from .utils.file_io import write_atomic
        p = self.params
        input_model = p.get("input_model", "LightGBM_model.txt")
        out = p.get("convert_model", "gbdt_prediction.cpp")
        booster = Booster(model_file=_resolve(input_model, p),
                          device=self.device)
        write_atomic(out, model_to_if_else(booster))
        log_info(f"Finished converting model; saved to {out}")


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    if not argv:
        raise SystemExit(__doc__)
    Application(argv).run()
