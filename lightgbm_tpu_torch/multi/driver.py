"""``train_many``: B boosters trained as lanes of group programs
(counterpart of ``lightgbm_tpu/multi/driver.py``).

One booster's round body leaves most of the card idle at small shapes:
a 255-leaf round over 200,000 rows is a few launches of a few
microseconds each.  Cross-validation folds, hyperparameter sweeps and
per-segment families are independent across models, so this driver
trains them as the lanes of one group program (``multi.batch``): one
CUDA graph replay a round carries every lane's round body.

1. A ``Booster`` a config (the ordinary constructor: nothing of a
   lane's host state knows it is batched).
2. Structural groups (``multi.group``), as the JAX package forms them.
3. A group larger than ``ops.planner.plan_model_batch``'s lane chunk
   trains as several groups in turn.
4. Each group runs the engine's own scheduling: the chunk is
   ``pow2_chunk`` of the nearest live lane's boundary (its evaluation,
   its snapshot, its round budget), with each lane's callbacks,
   evaluation and early stopping at its boundaries; a lane that stopped
   is left out of later chunks.
5. Each lane is an ordinary trained ``Booster`` whose model text is its
   solo text byte for byte, so checkpoints, serving and the fleet's
   probe-quarantine swap take it as they take any other.

Configs that cannot be batched (DART, CEGB, forced splits, a custom
``fobj``, the serial grower's learners, streamed boosters) and groups
of one train solo through the same scheduling loop.  Entry points run
on the CUDA card unless ``device="cpu"``.
"""

from __future__ import annotations

import collections
import itertools
from typing import List, Optional, Sequence, Union

from .. import callback as callback_mod
from ..basic import Booster, resolve_device
from ..config import Config
from ..dataset import Dataset
from ..obs.metrics import global_registry as _obs_registry
from ..obs.trace import span as _span
from .batch import BatchedChunkProgram
from .group import MultiGroup, group_boosters


def expand_param_grid(grid: dict) -> List[dict]:
    """The Cartesian product of the grid's list-valued entries, in
    sorted key order, each point a whole params dict::

        expand_param_grid({"objective": "binary",
                           "learning_rate": [0.05, 0.1],
                           "num_leaves": [15, 31]})
        # -> 4 configs

    A list-valued field that must not expand (e.g.
    ``interaction_constraints``) is wrapped one level deeper:
    ``[[...constraint lists...]]`` expands to the inner list."""
    fixed = {k: v for k, v in grid.items() if not isinstance(v, list)}
    sweep = {k: v for k, v in grid.items() if isinstance(v, list)}
    if not sweep:
        return [dict(fixed)]
    keys = sorted(sweep)
    out = []
    for combo in itertools.product(*(sweep[k] for k in keys)):
        p = dict(fixed)
        p.update(zip(keys, combo))
        out.append(p)
    return out


class _Lane:
    """One booster's host state in the driver's loop: the per-lane half
    of what ``engine.train`` keeps in locals."""

    def __init__(self, index: int, booster: Booster, params: dict,
                 rounds: int, cbs: list, feval, verbose_eval,
                 snapshot_freq: int, snapshot_out: Optional[str],
                 snapshot_keep: int, train_in_valid: bool = False):
        self.index = index
        self.booster = booster
        self.params = params
        self.rounds = rounds
        self.feval = feval
        self.train_in_valid = train_in_valid
        self.it = 0
        self.live = True
        self.evaluation_result_list: list = []
        cfg = booster.config
        cbs = set(cbs)
        if cfg.early_stopping_round and cfg.early_stopping_round > 0:
            cbs.add(callback_mod.early_stopping(
                cfg.early_stopping_round, cfg.first_metric_only,
                verbose=bool(verbose_eval)))
        if verbose_eval is True:
            cbs.add(callback_mod.log_evaluation())
        elif isinstance(verbose_eval, int) and verbose_eval > 0:
            cbs.add(callback_mod.log_evaluation(verbose_eval))
        before = {cb for cb in cbs if getattr(cb, "before_iteration", False)}
        self.cbs_before = sorted(before,
                                 key=lambda cb: getattr(cb, "order", 0))
        self.cbs_after = sorted(cbs - before,
                                key=lambda cb: getattr(cb, "order", 0))
        self.lr_cbs = [cb for cb in self.cbs_before
                       if getattr(cb, "_lr_schedule", None) is not None]
        lr_lists_ok = all(
            not isinstance(cb._lr_schedule, list)
            or len(cb._lr_schedule) == rounds for cb in self.lr_cbs)
        self.can_chunk = (booster.boosting.chunk_supported()
                          and len(self.lr_cbs) == len(self.cbs_before)
                          and lr_lists_ok
                          and all(getattr(cb, "_chunk_safe", False)
                                  for cb in self.cbs_after))
        self.mf = max(int(cfg.metric_freq), 1)
        self.eval_possible = bool(
            booster.boosting.valid_metrics or feval is not None
            or cfg.is_provide_training_metric or train_in_valid)
        if any(str(getattr(cb, "_resume_token", "")).startswith(
                "early_stopping") for cb in self.cbs_after) \
                and not self.eval_possible and rounds > 0:
            raise ValueError(
                "For early stopping, at least one dataset and eval metric "
                "is required for evaluation")
        self.ckpt_mgr = None
        self.snapshot_freq = snapshot_freq
        if snapshot_freq > 0 and snapshot_out:
            from ..resilience.checkpoint import CheckpointManager
            self.ckpt_mgr = CheckpointManager(f"{snapshot_out}.ckpt",
                                              keep_last=snapshot_keep)

    def boundary_distance(self) -> int:
        """``engine.train``'s chunk boundary rule for this lane."""
        d = self.rounds - self.it
        if self.eval_possible:
            d = min(d, self.mf - (self.it % self.mf))
        if self.ckpt_mgr is not None:
            d = min(d, self.snapshot_freq - (self.it % self.snapshot_freq))
        return max(d, 1)

    def lr_at(self, j: int) -> float:
        v = None
        for cb in self.lr_cbs:
            s = cb._lr_schedule
            v = s[j] if isinstance(s, list) else s(j)
        return float(v)

    def lrs_for(self, c: int) -> Optional[List[float]]:
        if not self.lr_cbs:
            return None
        return [self.lr_at(j) for j in range(self.it, self.it + c)]

    def after_chunk(self, c: int, stopped: bool,
                    lr_list: Optional[List[float]]) -> None:
        """The boundary work ``engine.train`` runs after each step: the
        last learning rate, evaluation at the ``metric_freq`` boundary,
        the after-callbacks with early stopping, snapshots, liveness."""
        bst = self.booster
        self.it += c
        if lr_list is not None and self.lr_cbs:
            bst.reset_parameter({"learning_rate": lr_list[-1]})
            self.params["learning_rate"] = lr_list[-1]
        j = self.it - 1
        self.evaluation_result_list = []
        if self.eval_possible and (j + 1) % self.mf == 0:
            with _span("multi.eval", lane=self.index, iteration=j):
                if bst.config.is_provide_training_metric \
                        or self.train_in_valid:
                    self.evaluation_result_list.extend(
                        bst.eval_train(self.feval))
                self.evaluation_result_list.extend(
                    bst.eval_valid(self.feval))
        early_stopped = False
        try:
            for cb in self.cbs_after:
                cb(callback_mod.CallbackEnv(bst, self.params, j, 0,
                                            self.rounds,
                                            self.evaluation_result_list))
        except callback_mod.EarlyStopException as e:
            bst.best_iteration = e.best_iteration + 1
            for item in e.best_score:
                bst.best_score.setdefault(item[0],
                                          collections.OrderedDict())
                bst.best_score[item[0]][item[1]] = item[2]
            early_stopped = True
        if self.ckpt_mgr is not None and (j + 1) % self.snapshot_freq == 0:
            from ..engine import _collect_callback_states
            self.ckpt_mgr.save(
                bst, iteration=j + 1,
                engine_state={"callbacks": _collect_callback_states(
                    self.cbs_before + self.cbs_after)})
        if early_stopped or stopped or self.it >= self.rounds:
            self.live = False
            if bst.best_iteration <= 0:
                bst.best_iteration = bst.current_iteration()
                for item in self.evaluation_result_list:
                    bst.best_score.setdefault(item[0],
                                              collections.OrderedDict())
                    bst.best_score[item[0]][item[1]] = item[2]


class _SoloProgram:
    """The dispatch of a group of one (or of an unbatchable config):
    the same scheduling loop over the booster's own solo path."""

    def __init__(self, lane: _Lane):
        self.lane = lane

    def dispatch(self, c: int, live: List[bool],
                 lr_lists: Sequence) -> List[bool]:
        lane = self.lane
        bst = lane.booster
        if bst.boosting.chunk_supported():
            return [bst.update_chunk(c, lr_lists[0])]
        # the per-iteration path (DART, a custom objective; c is 1):
        # the before-callbacks run as in engine.train
        for cb in lane.cbs_before:
            cb(callback_mod.CallbackEnv(bst, lane.params, lane.it, 0,
                                        lane.rounds, None))
        return [bst.update()]


def _chunk_for(lanes: List[_Lane], cap: int) -> int:
    from ..boosting.macro import pow2_chunk
    live = [lane for lane in lanes if lane.live]
    if cap <= 1 or not all(lane.can_chunk for lane in live):
        return 1
    return pow2_chunk(min(lane.boundary_distance() for lane in live), cap)


def _train_lanes(lanes: List[_Lane], program) -> None:
    """Drive one group to its end: every live lane advances by the same
    chunk; boundaries are each lane's own."""
    from ..boosting.macro import chunk_cap
    cap = chunk_cap()
    while any(lane.live for lane in lanes):
        c = _chunk_for(lanes, cap)
        lr_lists = [lane.lrs_for(c) if lane.live else None
                    for lane in lanes]
        stopped = program.dispatch(c, [lane.live for lane in lanes],
                                   lr_lists)
        for lane, stop, lrl in zip(lanes, stopped, lr_lists):
            if lane.live:
                lane.after_chunk(c, stop, lrl)


def _group_plan(g: MultiGroup):
    """The planner's lane-chunk verdict for one structural group."""
    from ..ops.planner import plan_model_batch
    b0 = g.boosters[0]
    cfg = b0.grower_cfg
    return plan_model_batch(
        b_total=len(g), rows=b0.num_data, features=b0.binned_t.shape[0],
        num_bins=b0.num_bins, num_leaves=cfg.num_leaves,
        num_class=b0.num_tree_per_iteration,
        quant=bool(getattr(b0, "_quant_on", False)),
        round_width=cfg.round_width,
        stacked=g.stacked, device=b0.device)


def _dispatch_groups(g: MultiGroup) -> List[MultiGroup]:
    """Split a structural group into the planner's groups of at most
    ``b_chunk`` lanes, trained in turn."""
    if g.key is None or len(g) == 1:
        return [g]
    bc = _group_plan(g).b_chunk
    if bc >= len(g):
        return [g]
    return [MultiGroup(g.key, g.boosters[i:i + bc], g.stacked)
            for i in range(0, len(g), bc)]


def _program(dg: MultiGroup, by_booster: dict):
    lanes = [by_booster[id(b)] for b in dg.boosters]
    if dg.key is None or len(dg) == 1:
        return lanes, _SoloProgram(lanes[0])
    return lanes, BatchedChunkProgram(dg)


def train_many(
    params_list: Union[List[dict], dict],
    train_set: Union[Dataset, Sequence[Dataset]],
    num_boost_round: int = 100,
    valid_sets: Optional[List[Dataset]] = None,
    valid_names: Optional[List[str]] = None,
    feval=None,
    early_stopping_rounds: Optional[int] = None,
    evals_results: Optional[List[dict]] = None,
    verbose_eval: Union[bool, int] = False,
    callbacks: Optional[List[list]] = None,
    init_models: Optional[list] = None,
    snapshot_freq: int = -1,
    snapshot_outs: Optional[List[str]] = None,
    snapshot_keep: int = 3,
    device=None,
) -> List[Booster]:
    """Train one booster a config of ``params_list``, as lanes of group
    programs wherever the configs' structure agrees, and return them in
    input order, each byte-identical in model text to the same config
    trained alone.

    ``params_list``: a list of params dicts, or ONE dict whose
    list-valued entries expand as a grid (``expand_param_grid``).
    ``train_set``: one shared ``Dataset`` (a sweep), or one Dataset a
    config (stacked: folds, per-segment families).  ``valid_sets``
    attach to EVERY booster.  ``callbacks``: one list a config (a
    stateful callback such as early stopping cannot be shared between
    lanes); ``evals_results`` likewise one dict a config.
    ``init_models`` (one a config, None entries allowed) continues
    training from existing models, as ``train(init_model=)`` does
    (``lifecycle.refresh_many`` runs on it).  ``snapshot_outs``: one
    checkpoint-bundle path a config (with ``snapshot_freq``), which
    ``train(resume_from=...)`` resumes bit for bit.  ``device``: as
    ``train``'s (None keeps the Datasets' device, the CUDA card for a
    new Dataset)."""
    if isinstance(params_list, dict):
        params_list = expand_param_grid(params_list)
    if not params_list:
        raise ValueError("train_many needs at least one config")
    B = len(params_list)
    stacked = not isinstance(train_set, Dataset)
    if stacked:
        datasets = list(train_set)
        if len(datasets) != B:
            raise ValueError(
                f"got {len(datasets)} datasets for {B} configs; stacked "
                "mode needs exactly one Dataset per config")
    else:
        datasets = [train_set] * B
    if isinstance(valid_sets, Dataset):
        valid_sets = [valid_sets]
    if device is not None:
        from ..engine import _place
        dev = resolve_device(device)
        for ds in datasets + list(valid_sets or []):
            _place(ds, dev)

    def _per_lane(arg, name):
        if arg is None:
            return [None] * B
        if len(arg) != B:
            raise ValueError(f"{name} must have one entry per config "
                             f"({B}), got {len(arg)}")
        return list(arg)

    lane_cbs = _per_lane(callbacks, "callbacks")
    lane_evals = _per_lane(evals_results, "evals_results")
    lane_inits = _per_lane(init_models, "init_models")
    lane_snaps = _per_lane(snapshot_outs, "snapshot_outs")

    from ..engine import _apply_init_model, _raw_scores
    lanes: List[_Lane] = []
    for i, params in enumerate(params_list):
        params = dict(params)
        cfg = Config.from_params(params)
        rounds = num_boost_round
        if "num_iterations" in {Config.canonical_key(k) for k in params}:
            rounds = cfg.num_iterations
        params["num_iterations"] = rounds
        predictor = None
        if lane_inits[i] is not None:
            predictor = (lane_inits[i]
                         if isinstance(lane_inits[i], Booster)
                         else Booster(model_file=lane_inits[i],
                                      params=params,
                                      device=datasets[i].device))
        raw = datasets[i].raw_data if predictor is not None else None
        bst = Booster(params=params, train_set=datasets[i])
        if predictor is not None:
            _apply_init_model(bst, predictor, datasets[i], raw=raw)
        train_in_valid = False
        if valid_sets:
            names = valid_names or [f"valid_{k}"
                                    for k in range(len(valid_sets))]
            for vs, name in zip(valid_sets, names):
                if vs is datasets[i]:
                    # a valid set that is the train set reports the
                    # training metrics, as engine.train does
                    train_in_valid = True
                    if valid_names is not None:
                        bst.set_train_data_name(name)
                    continue
                vraw = vs.raw_data
                bst.add_valid(vs, name)
                if predictor is not None:
                    if vraw is None:
                        raise ValueError(
                            "continued training requires "
                            "free_raw_data=False on validation Datasets")
                    bst.boosting.valid_scores[-1] += _raw_scores(
                        predictor, vraw, bst)
        cbs = list(lane_cbs[i] or [])
        if early_stopping_rounds is not None and early_stopping_rounds > 0:
            cbs.append(callback_mod.early_stopping(
                early_stopping_rounds, cfg.first_metric_only,
                verbose=bool(verbose_eval)))
        if lane_evals[i] is not None:
            cbs.append(callback_mod.record_evaluation(lane_evals[i]))
        lanes.append(_Lane(i, bst, params, rounds, cbs, feval,
                           verbose_eval, snapshot_freq, lane_snaps[i],
                           snapshot_keep, train_in_valid))

    by_booster = {id(lane.booster.boosting): lane for lane in lanes}
    groups = group_boosters([lane.booster.boosting for lane in lanes],
                            stacked)
    _obs_registry.counter("multi_train_many_calls").inc()
    with _span("multi.train_many", configs=B, stacked=stacked,
               groups=len(groups)):
        for g in groups:
            for dg in _dispatch_groups(g):
                _train_lanes(*_program(dg, by_booster))
    return [lane.booster for lane in lanes]


# ======================================================================
# fused cross-validation: engine.cv's round loop, the folds as lanes
# ======================================================================


class CVStepper:
    """Advance every fold one boosting round.  ``fused=True`` trains the
    folds' rounds as lanes of group programs (folds differ in size by at
    most one row when N % nfold != 0, so at most two groups form).  The
    serial stepper's ``update`` runs each supported fold as a chunk of
    one, the same body, which is why fused and serial cv agree bit for
    bit."""

    def __init__(self, boosters: List[Booster], fused: bool, fobj=None):
        self.boosters = boosters
        self.fobj = fobj
        self.fused = fused and fobj is None
        self._programs: List = []
        if self.fused:
            by_b = {id(b.boosting): b for b in boosters}
            batched = 0
            for g in group_boosters([b.boosting for b in boosters],
                                    stacked=True):
                for dg in _dispatch_groups(g):
                    if dg.key is None or len(dg) == 1:
                        self._programs.append(
                            ("solo", by_b[id(dg.boosters[0])]))
                    else:
                        batched += len(dg)
                        self._programs.append(
                            ("batched", BatchedChunkProgram(dg)))
            if batched == 0:
                from ..utils.log import log_warning
                log_warning(
                    "cv(fused=True): no fold pair is batchable under "
                    "this config (per-iteration host logic or custom "
                    "fobj); stepping folds serially")
                self.fused = False

    def step(self) -> None:
        if not self.fused:
            for bst in self.boosters:
                bst.update(fobj=self.fobj)
            return
        for kind, prog in self._programs:
            if kind == "solo":
                prog.update(fobj=self.fobj)
            else:
                n = len(prog.group.boosters)
                # serial cv ignores update()'s stopped flag, so every
                # lane stays live for the whole cv loop, as here
                prog.dispatch(1, [True] * n, [None] * n)
