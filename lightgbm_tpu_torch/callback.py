"""Training callbacks: log/record evaluation, learning-rate schedules
and early stopping (counterpart of part of ``lightgbm_tpu/callback.py``).

reference: python-package/lightgbm/callback.py (print_evaluation :60,
record_evaluation :85, reset_parameter :109, early_stopping :150).  A
callback marked ``_chunk_safe`` may run once after a chunk of
iterations (``engine.train``): it does nothing on an iteration without
evaluation results.  ``reset_parameter`` of ``learning_rate`` alone
carries its schedule as ``_lr_schedule``, which the engine feeds into a
chunk as one learning rate an iteration.

``record_evaluation`` and ``early_stopping`` carry a ``_resume_token``
and ``get_state``/``set_state`` (the JAX package's resume seam,
``lightgbm_tpu/callback.py:73, :211``): the recorded history and the
best-so-far tracking are training state that a checkpoint bundle
(``resilience/checkpoint.py``) keeps, so a resumed run stops at the same
iteration with the same best score as the uninterrupted one.
"""

from __future__ import annotations

import collections
from typing import Callable, List

CallbackEnv = collections.namedtuple(
    "CallbackEnv",
    ["model", "params", "iteration", "begin_iteration", "end_iteration",
     "evaluation_result_list"])


class EarlyStopException(Exception):
    def __init__(self, best_iteration: int, best_score):
        super().__init__()
        self.best_iteration = best_iteration
        self.best_score = best_score


def _format_eval_result(value, show_stdv: bool = True) -> str:
    """A (data, metric, value, higher_better) result, or cv's
    (..., stdv)."""
    if len(value) == 5 and show_stdv:
        return f"{value[0]}'s {value[1]}: {value[2]:g} + {value[4]:g}"
    return f"{value[0]}'s {value[1]}: {value[2]:g}"


def log_evaluation(period: int = 1, show_stdv: bool = True) -> Callable:
    """Print the evaluation results every ``period`` iterations."""
    def _callback(env: CallbackEnv) -> None:
        if period > 0 and env.evaluation_result_list and \
                (env.iteration + 1) % period == 0:
            result = "\t".join(_format_eval_result(x, show_stdv)
                               for x in env.evaluation_result_list)
            print(f"[{env.iteration + 1}]\t{result}")
    _callback.order = 10
    _callback._chunk_safe = True
    return _callback


print_evaluation = log_evaluation


def record_evaluation(eval_result: dict) -> Callable:
    """Record every evaluation into ``eval_result[data][metric]``."""
    if not isinstance(eval_result, dict):
        raise TypeError("eval_result should be a dict")
    eval_result.clear()

    def _callback(env: CallbackEnv) -> None:
        for item in env.evaluation_result_list:
            eval_result.setdefault(item[0], collections.OrderedDict())
            eval_result[item[0]].setdefault(item[1], []).append(item[2])

    def _get_state():
        import copy
        return copy.deepcopy(eval_result)

    def _set_state(state) -> None:
        import copy
        eval_result.clear()
        eval_result.update(copy.deepcopy(state))

    _callback.order = 20
    _callback._chunk_safe = True   # no-op on empty evaluation lists
    _callback._resume_token = "record_evaluation"
    _callback.get_state = _get_state
    _callback.set_state = _set_state
    return _callback


def reset_parameter(**kwargs) -> Callable:
    """Before each iteration, set each parameter to its value in a list
    (one entry an iteration) or returned by a function of the iteration
    (reference: callback.py:109)."""
    def _callback(env: CallbackEnv) -> None:
        new_parameters = {}
        for key, value in kwargs.items():
            if isinstance(value, list):
                if len(value) != env.end_iteration - env.begin_iteration:
                    raise ValueError(f"Length of list {key!r} has to equal "
                                     "to 'num_boost_round'")
                new_param = value[env.iteration - env.begin_iteration]
            else:
                new_param = value(env.iteration - env.begin_iteration)
            new_parameters[key] = new_param
        if new_parameters:
            env.model.reset_parameter(new_parameters)
            env.params.update(new_parameters)
    _callback.before_iteration = True
    _callback.order = 10
    _callback._lr_schedule = (kwargs["learning_rate"]
                              if set(kwargs) == {"learning_rate"} else None)
    return _callback


def early_stopping(stopping_rounds: int, first_metric_only: bool = False,
                   verbose: bool = True) -> Callable:
    """reference: callback.py:150."""
    best_score: List = []
    best_iter: List = []
    best_score_list: List = []
    cmp_op: List = []
    higher_better: List[bool] = []
    enabled: List[bool] = [True]
    first_metric: List[str] = [""]

    def _init(env: CallbackEnv) -> None:
        # the reference disables early stopping under DART (a dropped
        # tree changes every earlier iteration's score)
        enabled[0] = not any(
            env.params.get(alias, "") == "dart"
            for alias in ("boosting", "boosting_type", "boost"))
        if not enabled[0]:
            import warnings
            warnings.warn("Early stopping is not available in dart mode")
            return
        if not env.evaluation_result_list:
            raise ValueError(
                "For early stopping, at least one dataset and eval metric is "
                "required for evaluation")
        if verbose:
            print(f"Training until validation scores don't improve for "
                  f"{stopping_rounds} rounds")
        first_metric[0] = env.evaluation_result_list[0][1].split(" ")[-1]
        for eval_ret in env.evaluation_result_list:
            best_iter.append(0)
            best_score_list.append(None)
            higher_better.append(bool(eval_ret[3]))
            if eval_ret[3]:
                best_score.append(float("-inf"))
                cmp_op.append(lambda x, y: x > y)
            else:
                best_score.append(float("inf"))
                cmp_op.append(lambda x, y: x < y)

    def _callback(env: CallbackEnv) -> None:
        if not cmp_op:
            if not env.evaluation_result_list:
                return
            _init(env)
        if not enabled[0]:
            return
        for i in range(len(env.evaluation_result_list)):
            score = env.evaluation_result_list[i][2]
            if best_score_list[i] is None or cmp_op[i](score, best_score[i]):
                best_score[i] = score
                best_iter[i] = env.iteration
                best_score_list[i] = env.evaluation_result_list
            name = env.evaluation_result_list[i][1].split(" ")
            if first_metric_only and first_metric[0] != name[-1]:
                continue
            # cv's train metrics never stop it
            if env.evaluation_result_list[i][0] == "cv_agg" and \
                    name[0] == "train":
                continue
            if env.iteration - best_iter[i] >= stopping_rounds:
                if verbose:
                    print("Early stopping, best iteration is:\n"
                          f"[{best_iter[i] + 1}]\t"
                          + "\t".join(_format_eval_result(x)
                                      for x in best_score_list[i]))
                raise EarlyStopException(best_iter[i], best_score_list[i])
            if env.iteration == env.end_iteration - 1:
                if verbose:
                    print("Did not meet early stopping. Best iteration is:\n"
                          f"[{best_iter[i] + 1}]\t"
                          + "\t".join(_format_eval_result(x)
                                      for x in best_score_list[i]))
                raise EarlyStopException(best_iter[i], best_score_list[i])
            if first_metric_only:
                break

    # the best-so-far tracking is training state: without it a resumed
    # run would restart the patience window.  cmp_op holds lambdas (no
    # pickle), so the state carries the higher_better flags instead
    def _get_state():
        return {"best_score": list(best_score), "best_iter": list(best_iter),
                "best_score_list": list(best_score_list),
                "higher_better": list(higher_better),
                "enabled": enabled[0], "first_metric": first_metric[0]}

    def _set_state(state) -> None:
        for lst in (best_score, best_iter, best_score_list, cmp_op,
                    higher_better):
            del lst[:]
        best_score.extend(state["best_score"])
        best_iter.extend(state["best_iter"])
        best_score_list.extend(state["best_score_list"])
        higher_better.extend(state["higher_better"])
        cmp_op.extend((lambda x, y: x > y) if hib else (lambda x, y: x < y)
                      for hib in state["higher_better"])
        enabled[0] = state["enabled"]
        first_metric[0] = state["first_metric"]

    _callback.order = 30
    _callback._chunk_safe = True   # no-op on empty evaluation lists
    _callback._resume_token = (f"early_stopping({stopping_rounds},"
                               f"{first_metric_only})")
    _callback.get_state = _get_state
    _callback.set_state = _set_state
    return _callback
