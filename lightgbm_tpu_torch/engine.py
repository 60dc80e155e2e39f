"""Training entry point (counterpart of ``train`` in
``lightgbm_tpu/engine.py``).

reference: python-package/lightgbm/engine.py:18.  The loop trains chunks
of iterations (``boosting/macro.py``) as the JAX package's engine does
(``lightgbm_tpu/engine.py:237-325``): each step takes ``c =
pow2_chunk(distance to the next evaluation or the end, cap)``
iterations, through ``Booster.update_chunk``, where nothing needs the
host between them: no custom objective, a booster that
``chunk_supported()``, every callback after an iteration ``_chunk_safe``
and every callback before one a learning-rate schedule (whose values
ride into the chunk, then a final ``reset_parameter``); otherwise c = 1
through ``Booster.update``.  The JAX package's pause control,
checkpoints, flight recorder and watchdog are not ported (ROADMAP queue
A8 and A11).  Training runs on the Dataset's device: ``device=None``
keeps it (a new Dataset defaults to the CUDA card), ``device="cpu"``
moves a not-yet-constructed Dataset and its valid sets to the CPU.
"""

from __future__ import annotations

import collections
from typing import Callable, List, Optional

from . import callback as callback_mod
from .basic import Booster, resolve_device
from .boosting.macro import DEFAULT_CHUNK_CAP, pow2_chunk
from .config import Config
from .dataset import Dataset


def _place(ds: Dataset, device) -> None:
    if ds.device == device:
        return
    if ds.constructed:
        raise ValueError(f"the Dataset was constructed on {ds.device}; "
                         f"cannot train it on {device}")
    ds.device = device


def train(params: dict, train_set: Dataset, num_boost_round: int = 100,
          valid_sets: Optional[List[Dataset]] = None,
          valid_names: Optional[List[str]] = None,
          early_stopping_rounds: Optional[int] = None,
          evals_result: Optional[dict] = None,
          verbose_eval=True, callbacks: Optional[List[Callable]] = None,
          device=None, fobj: Optional[Callable] = None,
          feval: Optional[Callable] = None, learning_rates=None,
          **unsupported) -> Booster:
    """Train a model; returns the Booster (reference: engine.py:18).
    ``fobj(score, train_set) -> (grad, hess)`` replaces the objective
    (``objective`` becomes "none"); ``feval(score, dataset) -> (name,
    value, higher_better)`` (or a list of them) adds metrics;
    ``learning_rates``: a list (one a round) or a function of the round
    (``callback.reset_parameter``)."""
    for key, val in unsupported.items():
        if val is not None:
            raise NotImplementedError(
                f"train(..., {key}=) waits for ROADMAP queue A "
                "(training options)")
    params = dict(params)
    if fobj is not None:
        params["objective"] = "none"
    cfg = Config.from_params(params)
    if "num_iterations" in {Config.canonical_key(k) for k in params}:
        num_boost_round = cfg.num_iterations
    params["num_iterations"] = num_boost_round
    if isinstance(valid_sets, Dataset):
        valid_sets = [valid_sets]
    if isinstance(valid_names, str):
        valid_names = [valid_names]
    if device is not None:
        dev = resolve_device(device)
        for ds in [train_set] + list(valid_sets or []):
            _place(ds, dev)

    booster = Booster(params=params, train_set=train_set)
    train_in_valid = False
    if valid_sets:
        names_given = valid_names is not None
        valid_names = valid_names or [f"valid_{i}"
                                      for i in range(len(valid_sets))]
        for vs, name in zip(valid_sets, valid_names):
            if vs is train_set:
                train_in_valid = True
                if names_given:
                    booster._train_data_name = name
                continue
            booster.add_valid(vs, name)

    cbs = set(callbacks or [])
    if early_stopping_rounds is not None and early_stopping_rounds > 0:
        cbs.add(callback_mod.early_stopping(
            early_stopping_rounds, cfg.first_metric_only,
            verbose=bool(verbose_eval)))
    if cfg.early_stopping_round and cfg.early_stopping_round > 0:
        cbs.add(callback_mod.early_stopping(
            cfg.early_stopping_round, cfg.first_metric_only,
            verbose=bool(verbose_eval)))
    if verbose_eval is True:
        cbs.add(callback_mod.log_evaluation())
    elif isinstance(verbose_eval, int) and verbose_eval > 0:
        cbs.add(callback_mod.log_evaluation(verbose_eval))
    if evals_result is not None:
        cbs.add(callback_mod.record_evaluation(evals_result))
    if learning_rates is not None:
        cbs.add(callback_mod.reset_parameter(learning_rate=learning_rates))
    cbs_before = sorted((cb for cb in cbs
                         if getattr(cb, "before_iteration", False)),
                        key=lambda cb: getattr(cb, "order", 0))
    cbs_after = sorted((cb for cb in cbs
                        if not getattr(cb, "before_iteration", False)),
                       key=lambda cb: getattr(cb, "order", 0))

    mf = max(int(cfg.metric_freq), 1)
    eval_possible = bool(
        (valid_sets and booster.boosting.valid_metrics)
        or feval is not None or cfg.is_provide_training_metric
        or train_in_valid)
    # chunks of iterations, each ending at the next boundary that needs
    # the host (an evaluation every metric_freq, the end)
    lr_cbs = [cb for cb in cbs_before
              if getattr(cb, "_lr_schedule", None) is not None]
    lr_lists_ok = all(not isinstance(cb._lr_schedule, list)
                      or len(cb._lr_schedule) == num_boost_round
                      for cb in lr_cbs)
    can_chunk = (fobj is None and booster.boosting.chunk_supported()
                 and len(lr_cbs) == len(cbs_before) and lr_lists_ok
                 and all(getattr(cb, "_chunk_safe", False)
                         for cb in cbs_after))

    def lr_at(j):
        v = None
        for cb in lr_cbs:
            sched = cb._lr_schedule
            v = sched[j] if isinstance(sched, list) else sched(j)
        return float(v)

    evaluation_result_list = []
    i = 0
    while i < num_boost_round:
        c = 1
        if can_chunk:
            d = num_boost_round - i
            if eval_possible:
                d = min(d, mf - (i % mf))
            c = pow2_chunk(d, DEFAULT_CHUNK_CAP)
        if c > 1:
            lrs = [lr_at(j) for j in range(i, i + c)] if lr_cbs else None
            finished = booster.update_chunk(c, lrs)
            if lrs is not None:
                # the last reset_parameter of the chunk, as per-iteration
                # training leaves it
                booster.reset_parameter({"learning_rate": lrs[-1]})
                params["learning_rate"] = lrs[-1]
        else:
            for cb in cbs_before:
                cb(callback_mod.CallbackEnv(booster, params, i, 0,
                                            num_boost_round, None))
            finished = booster.update(fobj=fobj)
        i += c
        j = i - 1        # the last iteration of this step
        evaluation_result_list = []
        if eval_possible and (j + 1) % mf == 0:
            if cfg.is_provide_training_metric or train_in_valid:
                evaluation_result_list.extend(booster.eval_train(feval))
            evaluation_result_list.extend(booster.eval_valid(feval))
        try:
            for cb in cbs_after:
                cb(callback_mod.CallbackEnv(booster, params, j, 0,
                                            num_boost_round,
                                            evaluation_result_list))
        except callback_mod.EarlyStopException as e:
            booster.best_iteration = e.best_iteration + 1
            for item in e.best_score:
                booster.best_score.setdefault(item[0],
                                              collections.OrderedDict())
                booster.best_score[item[0]][item[1]] = item[2]
            break
        if finished:
            break
    if booster.best_iteration <= 0:
        booster.best_iteration = booster.current_iteration()
        for item in evaluation_result_list:
            booster.best_score.setdefault(item[0], collections.OrderedDict())
            booster.best_score[item[0]][item[1]] = item[2]
    return booster
