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
through ``Booster.update``; the cap is ``macro.chunk_cap()``
(``LGBM_TPU_CHUNK``).

Checkpoints and pause control (the JAX package's engine.py:26-36,
:180-213, :279-306): ``snapshot_freq`` writes a checkpoint bundle
(``resilience/checkpoint.py``: atomic, sha256-manifested, the whole
training state) into ``<snapshot_out>.ckpt/`` every ``snapshot_freq``
iterations, keeping the last ``snapshot_keep``; a snapshot boundary ends
a chunk.  ``resume_from`` (a bundle file or that directory) restores the
state into the freshly built booster and the callbacks, so the resumed
run ends with the uninterrupted run's model text and evaluation history
whatever the chunk plans of the two runs.  ``pause_control`` (any object
with ``consult(i)`` and ``chunk_cap()``) is consulted at every chunk
boundary: ``"pause"`` saves a bundle and raises ``TrainingPaused``;
``chunk_cap()`` caps the chunk.

Observability, at the JAX package's call sites
(``lightgbm_tpu/engine.py:80-84, 266-391``): ``train`` starts the
env-gated watchdog sentry and metrics endpoint, puts the run in the
flight recorder's context, watches the ``engine.step`` heartbeat (with
the trees/s floor of ``LIGHTGBM_TPU_SLO_TREES_PER_SEC``) while the loop
runs, records the ``engine.train`` root span, an ``engine.step`` span a
step and ``engine.eval`` around the evaluations (after which a
registered pod transport gathers ``obs.aggregate``'s telemetry), notes
each step in the
flight ring, sets the ``train_iter_seconds``,
``train_trees_per_sec_live``, ``train_iterations_total`` and
``train_trees_per_sec`` instruments, and dumps a forensic bundle when
the loop raises (not on a pause); bundles add the ``checkpoint.save``
and ``checkpoint.load`` spans and an ``engine.pause`` flight note.  All
of it is host bookkeeping: nothing reads the
card.  Training runs on the Dataset's device: ``device=None``
keeps it (a new Dataset defaults to the CUDA card), ``device="cpu"``
moves a not-yet-constructed Dataset and its valid sets to the CPU.
"""

from __future__ import annotations

import collections
import time
from typing import Callable, Dict, List, Optional

from . import callback as callback_mod
from .basic import Booster, resolve_device
from .boosting.macro import chunk_cap, pow2_chunk
from .config import Config
from .dataset import Dataset, same_bins
from .obs.flight import global_flight as _flight
from .obs.metrics import global_registry as _obs_registry
from .obs.aggregate import maybe_gather_at_eval as _maybe_gather_at_eval
from .obs.trace import span as _span
from .obs.watchdog import global_watchdog as _watchdog
from .resilience.checkpoint import (CheckpointManager,
                                    resolve_resume_point, restore_booster)
from .utils.log import log_info


def _place(ds: Dataset, device) -> None:
    if ds.device == device:
        return
    if ds.constructed:
        raise ValueError(f"the Dataset was constructed on {ds.device}; "
                         f"cannot train it on {device}")
    ds.device = device


class TrainingPaused(Exception):
    """Raised out of ``train()`` when its ``pause_control`` orders a
    pause: the whole training state was saved to a checkpoint bundle
    first, so the caller resumes byte-identically by calling ``train``
    again with the same arguments and ``resume_from=e.bundle_path``.
    Not an error: the engine's forensic dump does not fire."""

    def __init__(self, iteration: int, bundle_path: str):
        super().__init__(
            f"training paused at iteration {iteration}; state evicted "
            f"to {bundle_path}")
        self.iteration = int(iteration)
        self.bundle_path = bundle_path


def train(params: dict, train_set: Dataset, num_boost_round: int = 100,
          valid_sets: Optional[List[Dataset]] = None,
          valid_names: Optional[List[str]] = None,
          fobj: Optional[Callable] = None, feval: Optional[Callable] = None,
          init_model=None, feature_name="auto", categorical_feature="auto",
          early_stopping_rounds: Optional[int] = None,
          evals_result: Optional[dict] = None,
          verbose_eval=True, learning_rates=None,
          keep_training_booster: bool = False,
          callbacks: Optional[List[Callable]] = None,
          snapshot_freq: int = -1, snapshot_out: str = "model.txt",
          snapshot_keep: int = 3, resume_from: Optional[str] = None,
          pause_control=None, device=None) -> Booster:
    """Train a model; returns the Booster (reference: engine.py:18).
    ``fobj(score, train_set) -> (grad, hess)`` replaces the objective
    (``objective`` becomes "none"); ``feval(score, dataset) -> (name,
    value, higher_better)`` (or a list of them) adds metrics;
    ``learning_rates``: a list (one a round) or a function of the round
    (``callback.reset_parameter``).  ``init_model`` (a Booster or a model
    file) continues training: its trees come first and its raw scores,
    from the traversal kernel's scores mode on the training device,
    start the train and valid scores (the train set and the valid sets
    keep their raw rows for that: ``free_raw_data=False`` where they
    were constructed before).  ``keep_training_booster`` is accepted for
    the reference's signature: the returned Booster always keeps its
    training state.  ``snapshot_freq``/``snapshot_out``/
    ``snapshot_keep``, ``resume_from`` and ``pause_control``: the
    module docstring."""
    # the env-gated SLO sentry and metrics endpoint
    from .obs.http import maybe_start_from_env as _http_from_env
    from .obs.watchdog import maybe_start_from_env as _wd_from_env
    _wd_from_env()
    _http_from_env()
    params = dict(params)
    if feature_name != "auto":
        train_set._feature_name_param = feature_name
    if categorical_feature != "auto":
        train_set._categorical_feature_param = categorical_feature
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

    predictor = None
    if init_model is not None:
        predictor = (init_model if isinstance(init_model, Booster)
                     else Booster(model_file=init_model, params=params,
                                  device=train_set.device))
    # the raw rows, before construction frees them
    train_raw = train_set.raw_data if predictor is not None else None

    booster = Booster(params=params, train_set=train_set)
    if predictor is not None:
        _apply_init_model(booster, predictor, train_set, raw=train_raw)
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
            raw = vs.raw_data
            booster.add_valid(vs, name)
            if predictor is not None:
                if raw is None:
                    raise ValueError(
                        "continued training requires free_raw_data=False "
                        "on validation Datasets")
                booster.boosting.valid_scores[-1] += _raw_scores(
                    predictor, raw, booster)

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

    start_iter = 0
    if resume_from is not None:
        ck = resolve_resume_point(resume_from)
        restore_booster(booster, ck)
        _restore_callback_states(cbs_before + cbs_after,
                                 ck.engine_state.get("callbacks", {}))
        start_iter = ck.iteration
        log_info(f"resume: restored iteration {start_iter} from "
                 f"{ck.path or resume_from}")
    ckpt_mgr = None
    if snapshot_freq > 0:
        ckpt_mgr = CheckpointManager(f"{snapshot_out}.ckpt",
                                     keep_last=snapshot_keep)

    def engine_state() -> dict:
        return {"callbacks": _collect_callback_states(cbs_before
                                                      + cbs_after)}

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
    cap = chunk_cap()
    can_chunk = (cap > 1 and fobj is None
                 and booster.boosting.chunk_supported()
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
    i = start_iter
    t_loop0 = time.perf_counter()
    K_per_iter = booster.boosting.num_tree_per_iteration
    _flight.set_context(
        phase="train", num_boost_round=num_boost_round,
        start_iter=start_iter,
        objective=cfg.objective, num_leaves=cfg.num_leaves,
        rows=train_set.num_data)
    # the loop's heartbeat is stale-watched only WHILE the loop runs (a
    # finished loop never breaches)
    _watchdog.watch_heartbeat(
        "engine.step", floor=_watchdog.config.trees_per_sec_floor)
    try:
        with _span("engine.train", start_iter=start_iter,
                   num_boost_round=num_boost_round) as train_root:
            while i < num_boost_round:
                if pause_control is not None \
                        and pause_control.consult(i) == "pause":
                    # the whole state goes to a bundle before the card
                    # is yielded: the resumed run is byte-identical
                    mgr = ckpt_mgr or CheckpointManager(
                        f"{snapshot_out}.ckpt",
                        keep_last=max(snapshot_keep, 1))
                    path = mgr.save(booster, iteration=i,
                                    engine_state=engine_state())
                    _flight.note("engine.pause", i=i, bundle=str(path))
                    train_root.set(paused=True)
                    raise TrainingPaused(i, path)
                c = 1
                if can_chunk:
                    d = num_boost_round - i
                    if eval_possible:
                        d = min(d, mf - (i % mf))
                    if ckpt_mgr is not None:
                        # a snapshot boundary ends a chunk
                        d = min(d, snapshot_freq - (i % snapshot_freq))
                    c = pow2_chunk(d, cap)
                    if pause_control is not None:
                        c = pow2_chunk(c, max(int(
                            pause_control.chunk_cap()), 1))
                t_step0 = time.perf_counter()
                if c > 1:
                    lrs = ([lr_at(j) for j in range(i, i + c)] if lr_cbs
                           else None)
                    with _span("engine.step", i=i, c=c):
                        finished = booster.update_chunk(c, lrs)
                    if lrs is not None:
                        # the last reset_parameter of the chunk, as
                        # per-iteration training leaves it
                        booster.reset_parameter({"learning_rate": lrs[-1]})
                        params["learning_rate"] = lrs[-1]
                else:
                    for cb in cbs_before:
                        cb(callback_mod.CallbackEnv(booster, params, i, 0,
                                                    num_boost_round, None))
                    with _span("engine.step", i=i, c=1):
                        finished = booster.update(fobj=fobj)
                i += c
                # the step boundary: the flight ring, the live-rate gauges
                # and the heartbeat (host accounting: no device work)
                step_s = time.perf_counter() - t_step0
                _flight.note("engine.step", i=i - c, c=c, dur_us=step_s * 1e6)
                _flight.sample_metrics()
                _obs_registry.gauge("train_iter_seconds").set(
                    round(step_s / max(c, 1), 6))
                live = (i - start_iter) * K_per_iter / max(
                    time.perf_counter() - t_loop0, 1e-9)
                _obs_registry.gauge("train_trees_per_sec_live").set(
                    round(live, 3))
                _watchdog.beat("engine.step", count=i * K_per_iter)
                j = i - 1        # the last iteration of this step
                evaluation_result_list = []
                early_stopped = False
                if eval_possible and (j + 1) % mf == 0:
                    with _span("engine.eval", iteration=j):
                        if cfg.is_provide_training_metric or train_in_valid:
                            evaluation_result_list.extend(
                                booster.eval_train(feval))
                        evaluation_result_list.extend(
                            booster.eval_valid(feval))
                    # pod telemetry at the eval boundary: a no-op unless
                    # a transport is registered (obs/aggregate.py)
                    _maybe_gather_at_eval()
                try:
                    for cb in cbs_after:
                        cb(callback_mod.CallbackEnv(booster, params, j, 0,
                                                    num_boost_round,
                                                    evaluation_result_list))
                except callback_mod.EarlyStopException as e:
                    booster.best_iteration = e.best_iteration + 1
                    for item in e.best_score:
                        booster.best_score.setdefault(
                            item[0], collections.OrderedDict())
                        booster.best_score[item[0]][item[1]] = item[2]
                    early_stopped = True
                # a snapshot also on the iteration that stopped early
                # (reference: GBDT::Train reaches the snapshot write,
                # gbdt.cpp:259-263)
                if ckpt_mgr is not None and (j + 1) % snapshot_freq == 0:
                    ckpt_mgr.save(booster, iteration=j + 1,
                                  engine_state=engine_state())
                if early_stopped or finished:
                    break
    except TrainingPaused:
        # an ordered yield, not a failure: no forensic bundle
        raise
    except BaseException as e:
        # an unhandled loop failure (the span above closed tagged with
        # it): the forensic bundle (ring, metrics, fingerprint) before
        # the raise unwinds the process
        _flight.on_exception("engine.train", e)
        raise
    finally:
        _watchdog.unwatch("engine.step")
    wall = time.perf_counter() - t_loop0
    trained = i - start_iter
    if trained > 0:
        _obs_registry.counter("train_iterations_total").inc(trained)
        if wall > 0:
            _obs_registry.gauge("train_trees_per_sec").set(
                round(trained * K_per_iter / wall, 3))
    if booster.best_iteration <= 0:
        booster.best_iteration = booster.current_iteration()
        for item in evaluation_result_list:
            booster.best_score.setdefault(item[0], collections.OrderedDict())
            booster.best_score[item[0]][item[1]] = item[2]
    return booster


def _collect_callback_states(cbs) -> dict:
    """The resumable callbacks' states, keyed by each one's
    ``_resume_token`` (``early_stopping`` and ``record_evaluation``)."""
    return {cb._resume_token: cb.get_state() for cb in cbs
            if getattr(cb, "_resume_token", None) is not None
            and hasattr(cb, "get_state")}


def _restore_callback_states(cbs, states: dict) -> None:
    for cb in cbs:
        tok = getattr(cb, "_resume_token", None)
        if tok is not None and tok in states and hasattr(cb, "set_state"):
            cb.set_state(states[tok])


class InitModelCompatibilityError(ValueError):
    """The ``init_model`` cannot continue training on this train set
    (feature count or trees an iteration differ)."""


def _validate_init_model(booster: Booster, predictor: Booster,
                         train_set: Dataset) -> None:
    """reference: the JAX package's engine.py:425-470."""
    f_model = predictor.num_features()
    f_train = train_set.num_total_features
    if f_model != f_train:
        raise InitModelCompatibilityError(
            f"init_model was trained on {f_model} features but the "
            f"training data has {f_train}; continued training requires the "
            "same feature layout")
    k_model = max(predictor.num_tree_per_iteration, 1)
    k_train = max(booster.boosting.num_tree_per_iteration, 1)
    if k_model != k_train:
        raise InitModelCompatibilityError(
            f"init_model has {k_model} tree(s) per iteration but this "
            f"training is configured for {k_train} (num_class / objective "
            "mismatch); continued training cannot mix them")
    pts = predictor.train_set
    if (pts is not None and pts.constructed and train_set.bin_mappers
            and not same_bins(pts.bin_mappers, train_set.bin_mappers)):
        from .utils.log import log_warning
        log_warning(
            "continued training: the new train set's bin mappers differ "
            "from the init model's training grid; init scores stay exact "
            "(trees hold real thresholds), but new histograms live on a "
            "different grid")


def _raw_scores(predictor: Booster, raw, booster: Booster):
    """[K, n] f32 raw scores of ``predictor`` over ``raw`` on the
    booster's device (the traversal kernel's scores mode)."""
    import numpy as np
    import torch
    K = booster.boosting.num_tree_per_iteration
    if predictor.device != booster.device:
        predictor = Booster(model_str=predictor.model_to_string(
            num_iteration=0), device=booster.device)
    pred = np.asarray(predictor.predict(raw, raw_score=True,
                                        num_iteration=-1), np.float32)
    return torch.as_tensor(np.ascontiguousarray(pred.reshape(-1, K).T),
                           device=booster.device)


def _apply_init_model(booster: Booster, predictor: Booster,
                      train_set: Dataset, raw=None) -> None:
    """The init model's trees first and its raw scores added to the
    train scores (reference: basic.py:840 _set_init_score_by_predictor;
    the JAX package's engine.py:473-500).  A streamed Dataset of fresh
    rows (``lifecycle.fresh_dataset``) carries the init model's raw
    scores, taken chunk by chunk at push time, as
    ``_init_model_raw_scores``: they stand in for a prediction over raw
    rows it never kept."""
    import numpy as np
    import torch
    _validate_init_model(booster, predictor, train_set)
    b = booster.boosting
    K = b.num_tree_per_iteration
    pre = getattr(train_set, "_init_model_raw_scores", None)
    if pre is not None:
        init = torch.as_tensor(np.ascontiguousarray(
            np.asarray(pre, np.float32).reshape(-1, K).T),
            device=booster.device)
    else:
        if raw is None:
            raw = train_set.raw_data
        if raw is None:
            raise ValueError("continued training requires "
                             "free_raw_data=False on the training Dataset")
        init = _raw_scores(predictor, raw, booster)
    b.train_score += init
    b._init_score_added = True
    b.models = list(predictor.models)
    b.iter = b.num_init_iteration = len(predictor.models) // K


class CVBooster:
    """The folds' Boosters; a method call calls it on each (reference:
    engine.py CVBooster)."""

    def __init__(self):
        self.boosters: List[Booster] = []
        self.best_iteration = -1

    def _append(self, booster: Booster) -> None:
        self.boosters.append(booster)

    def __getattr__(self, name):
        def handler_function(*args, **kwargs):
            return [getattr(b, name)(*args, **kwargs) for b in self.boosters]
        return handler_function


def _make_n_folds(full_data: Dataset, folds, nfold: int, params: dict,
                  seed: int, stratified: bool, shuffle: bool):
    """The (train rows, test rows) of each fold, drawn as the JAX package
    draws them: ``folds`` (pairs, or a splitter with ``split``); whole
    queries for ranking data (scikit-learn's GroupKFold where it is
    installed); scikit-learn's StratifiedKFold when ``stratified``; else
    a RandomState(seed) shuffle cut into ``nfold`` chunks."""
    import numpy as np
    full_data.construct()
    num_data = full_data.num_data
    if folds is not None:
        if not hasattr(folds, "__iter__") and hasattr(folds, "split"):
            group = full_data.get_group()
            if group is not None:
                group = np.repeat(np.arange(len(group)), group)
            folds = folds.split(X=np.empty(num_data),
                                y=full_data.get_label(), groups=group)
        return list(folds)
    rng = np.random.RandomState(seed)
    qb = full_data.metadata.query_boundaries
    if qb is not None:
        nq = len(qb) - 1
        if nfold > nq:
            raise ValueError(
                f"nfold={nfold} exceeds the number of query groups ({nq})")
        from .compat import SKLEARN_INSTALLED
        if SKLEARN_INSTALLED:
            from sklearn.model_selection import GroupKFold
            flat = np.repeat(np.arange(nq), np.diff(qb))
            return list(GroupKFold(n_splits=nfold).split(
                X=np.empty(num_data), groups=flat))
        q_idx = np.arange(nq)
        if shuffle:
            rng.shuffle(q_idx)
        q_chunks = np.array_split(q_idx, nfold)

        def rows(qs):
            return np.concatenate([np.arange(qb[q], qb[q + 1])
                                   for q in np.sort(qs)])

        return [(rows(np.concatenate([c for j, c in enumerate(q_chunks)
                                      if j != i])), rows(q_chunks[i]))
                for i in range(nfold)]
    if stratified:
        from sklearn.model_selection import StratifiedKFold
        skf = StratifiedKFold(n_splits=nfold, shuffle=shuffle,
                              random_state=seed if shuffle else None)
        return list(skf.split(np.empty(num_data), full_data.get_label()))
    idx = np.arange(num_data)
    if shuffle:
        rng.shuffle(idx)
    chunks = np.array_split(idx, nfold)
    return [(np.concatenate([c for j, c in enumerate(chunks) if j != i]),
             chunks[i]) for i in range(nfold)]


def cv(params: dict, train_set: Dataset, num_boost_round: int = 100,
       folds=None, nfold: int = 5, stratified: bool = True,
       shuffle: bool = True, metrics=None, fobj=None, feval=None,
       init_model=None, feature_name="auto", categorical_feature="auto",
       early_stopping_rounds=None, fpreproc=None, verbose_eval=None,
       show_stdv: bool = True, seed: int = 0, callbacks=None,
       eval_train_metric: bool = False, return_cvbooster: bool = False,
       fused: bool = False, device=None) -> Dict[str, List[float]]:
    """Cross-validation (reference: engine.py:375): each fold trains on
    ``train_set.subset`` of its rows (a gather of the binned matrix on
    the device) and is evaluated on the rest; the result holds each
    metric's mean and standard deviation over the folds a round
    (``"valid <metric>-mean"`` and ``"train ..."`` with
    ``eval_train_metric``, else ``"<metric>-mean"``).  The folds advance
    one iteration each in turn; ``fused=True`` advances them as lanes of
    group programs (``multi.CVStepper``), with the same results dict bit
    for bit, since both run each fold's chunk of one (a custom ``fobj``,
    or no batchable fold pair, steps them in turn with a warning).
    ``stratified`` folds need scikit-learn
    (``ImportError`` without it; ``stratified=False`` or ``folds=`` do
    not).  ``init_model``, ``feature_name`` and ``categorical_feature``
    are accepted and unused, as in the JAX package."""
    import numpy as np
    params = dict(params)
    if fobj is not None:
        params["objective"] = "none"
    if metrics is not None:
        for k in [k for k in params if Config.canonical_key(k) == "metric"]:
            params.pop(k)
        params["metric"] = metrics
    cfg = Config.from_params(params)
    if not (cfg.objective == "binary"
            or cfg.objective.startswith("multiclass")):
        stratified = False
    if device is not None:
        _place(train_set, resolve_device(device))
    folds_idx = _make_n_folds(train_set, folds, nfold, params, seed,
                              stratified, shuffle)
    cvbooster = CVBooster()
    results = collections.defaultdict(list)
    boosters = []
    for tr_idx, te_idx in folds_idx:
        tr = train_set.subset(tr_idx, params)
        te = train_set.subset(te_idx, params)
        if fpreproc is not None:
            tr, te, params = fpreproc(tr, te, dict(params))
        bst = Booster(params=params, train_set=tr)
        bst.add_valid(te, "valid")
        boosters.append(bst)
        cvbooster._append(bst)

    cbs = set(callbacks or [])
    if early_stopping_rounds is not None and early_stopping_rounds > 0:
        cbs.add(callback_mod.early_stopping(
            early_stopping_rounds, cfg.first_metric_only, verbose=False))
    if verbose_eval is True:
        cbs.add(callback_mod.log_evaluation(show_stdv=show_stdv))
    elif isinstance(verbose_eval, int) and verbose_eval:
        cbs.add(callback_mod.log_evaluation(verbose_eval, show_stdv))
    cbs = sorted(cbs, key=lambda cb: getattr(cb, "order", 0))

    from .multi.driver import CVStepper
    stepper = CVStepper(boosters, fused, fobj)
    for i in range(num_boost_round):
        agg = collections.defaultdict(list)
        # every fold first (as lanes of group programs when fused), then
        # the evaluations: the folds are independent
        stepper.step()
        for bst in boosters:
            res = ([("train", mn, v, h)
                    for (_, mn, v, h) in bst.eval_train(feval)]
                   if eval_train_metric else []) + bst.eval_valid(feval)
            for dname, mname, val, hib in res:
                agg[(dname if eval_train_metric else "valid", mname,
                     hib)].append(val)
        evaluation_result_list = [
            ("cv_agg", f"{d} {m}" if eval_train_metric else m,
             float(np.mean(v)), h, float(np.std(v)))
            for (d, m, h), v in agg.items()]
        for _, m, mean, _, std in evaluation_result_list:
            results[m + "-mean"].append(mean)
            results[m + "-stdv"].append(std)
        try:
            for cb in cbs:
                cb(callback_mod.CallbackEnv(cvbooster, params, i, 0,
                                            num_boost_round,
                                            evaluation_result_list))
        except callback_mod.EarlyStopException as e:
            cvbooster.best_iteration = e.best_iteration + 1
            for k in results:
                results[k] = results[k][:cvbooster.best_iteration]
            break
    out = dict(results)
    if return_cvbooster:
        out["cvbooster"] = cvbooster
    return out
