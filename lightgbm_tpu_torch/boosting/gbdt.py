"""GBDT training loop on one device (counterpart of the single-device part
of ``lightgbm_tpu/boosting/gbdt.py``).

reference: src/boosting/gbdt.cpp — GBDT::Init (:42), TrainOneIter (:338),
Bagging (:163), BoostFromAverage (:302), UpdateScore (:459).  One
iteration: gradients of every class from the objective (torch, on the
device; or from a custom ``fobj``) -> bagging mask -> K trees, one a
class, by the batched-frontier grower (its fused arm, or its staged arm
for a dataset with EFB bundles or a staged ``tpu_hist_method``), or by
the serial grower (``tpu_tree_growth="serial"``, and ``auto`` with CEGB
or forced splits, which run only there) -> leaf renewal (the percentile
objectives) -> shrinkage -> train and valid score updates -> the host
trees.  Scores are [K, n] (K =
``num_tree_per_iteration``: the number of classes of ``multiclass`` and
``multiclassova``, else 1).  Bagging and column sampling draw from NumPy
``RandomState`` streams seeded as the JAX package seeds them (the [K,
F] feature masks class by class from one stream), so both packages
sample the same rows and features.

Quantized-gradient training (``use_quantized_grad``): each class's
gradients are quantized with the bagging mask as weights
(``ops.histogram.quantize_gradients``; per-class scales) and its tree
grows from the int8 levels.  Stochastic rounding draws from the JAX
package's threefry key chain, reproduced bit for bit by
``utils/threefry.py``: the base key ``PRNGKey((extra_trees_seed *
2654435761 ^ feature_fraction_seed) % 2**31)``, the iteration's key
``fold_in(base, iter)``, and the quantization key
``fold_in(fold_in(key, 0x51475442), k)`` of class k.  The same
iteration key drives per-node randomness (``extra_trees``,
``feature_fraction_bynode``): class k's grower key is ``fold_in(key,
k)``.  Monotone constraints are given per original feature and aligned
with the used features (a feature dropped at binning drops its
constraint).

The objectives with ``renew_percentile`` (the L1 family, quantile,
MAPE) re-fit each leaf to the weighted percentile of the residuals
``label - score[k]`` of its rows (``ops.renew.leaf_percentile``) before
shrinkage.  GOSS, DART and RF are subclasses (``goss.py``, ``dart.py``,
``rf.py``); ``boosting.create_boosting`` picks one.

CEGB (cost-efficient gradient boosting: split, coupled and lazy
penalties) keeps its cross-tree state in the serial grower; forced
splits come from ``forcedsplits_filename`` as a BFS plan
(``_build_forced_plan``).

Sharded training (``tree_learner`` data, feature or voting, under the
process group of ``parallel.network.current_group``; with one rank
every learner trains serially, as the JAX package does on one device;
the JAX package's ``_setup_distribution``, boosting/gbdt.py:336-430):
the scores, the objective, bagging and GOSS masks, metrics and valid
sets stay global on every rank, as the JAX package's one controller
sees them; the tree is the part that is sharded.  Data and voting: the
grower gets this rank's rows (``parallel.learners.contiguous_layout``,
or whole queries for ranking, ``query_layout``), their gradients and
mask sliced from the global ones, and the trees' leaf ids of every
rank's rows are gathered after each tree; the quantization key folds in
the rank (the JAX package's boosting/gbdt.py:1025-1036).  Feature: the
grower gets every row and this rank's EFB groups
(``parallel.learners.feature_layout``).  The configurations the port
does not cover raise ``NotImplementedError`` naming the ROADMAP item
that brings them; none is trained another way.

Out-of-core training (``data/stream.py``; the JAX package's
boosting/gbdt.py:133, :1468-1495): ``maybe_stream_setup`` elects it in
``__init__`` where ``ops.planner.plan_stream`` rules residency out or
the Dataset is block-backed, and the booster's grower is then a
``data.stream.StreamGrower`` over the spill store, so every iteration
path (chunks of one, GOSS's masks, custom objectives) streams through
``_grow`` unchanged; such a booster trains one iteration at a time
(``chunk_supported`` False) and refuses ``rollback_one_iter``; DART and
RF (``_stream_ok``) and the configurations of
``data.stream._config_stream_blockers`` train resident.

Checkpoints (``resilience/checkpoint.py``; the JAX package's
boosting/gbdt.py:1793-1958): ``capture_state`` gives every mutable
state of the loop as host values (the scores, both ``RandomState``
streams and the bagging mask, the host and device trees, DART's and
GOSS's streams in their subclasses, the serial grower's CEGB state),
and ``restore_state`` puts it into a fresh booster of the same config
and data, which then trains on as the uninterrupted one did; a bundle
of another row layout raises (ROADMAP queue A9, resilience/elastic.py).

Observability (``obs/``; the JAX package's boosting/gbdt.py:845-895 and
its timer tags): where ``_configure`` settles the arm (rounds, serial or
streamed; fused or staged; f32 or quantized; ``KCAP``) it emits the
``planner.plan`` instant with the planner's predicted card peak and
budget, sets the ``train_hist_method``,
``train_hist_predicted_peak_bytes``, ``train_hbm_budget_bytes`` (on a
card: the CPU has no limit) and, under a process group,
``train_psum_payload_bytes`` gauges, and puts
the plan in the flight recorder's context.  ``train_one_iter`` is the
``GBDT::TrainOneIter`` section, an iteration outside a chunk the
``gbdt.dispatch`` and ``gbdt.finish_iter`` spans, a chunk's host side
``macro.host_fetch``, an evaluation ``gbdt.eval``.  These are host
events: none reads the card, and none runs inside the captured round
body.
"""

from __future__ import annotations

import contextlib
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..config import Config
from ..dataset import Dataset, same_bins
from ..grower import GrowerConfig, SerialGrower, predict_leaf_index_binned
from ..grower_rounds import RoundGrower
from ..obs.flight import global_flight as _flight
from ..obs.metrics import global_registry as _obs_registry
from ..obs.trace import instant as _instant, span as _span
from ..objectives import ObjectiveFunction
from ..ops.histogram import HIST_METHODS, quantize_gradients
from ..ops.renew import leaf_percentile
from ..ops.split import MAX_CAT_WORDS, f32
from ..parallel import learners
from ..parallel.collectives import (all_gather_tiered, axis_index_flat,
                                    axis_size)
from ..tree import HostTree, tree_to_host
from ..utils import threefry
from ..utils.log import log_info, log_warning
from ..utils.timer import global_timer

K_EPSILON = 1e-15


def _route(arrays: dict) -> tuple:
    """(depth, has a categorical split) of a tree from its host arrays:
    the trip count of its routing."""
    nl = int(arrays["num_leaves"])
    if nl <= 1:
        return 0, False
    return (int(arrays["leaf_depth"][:nl].max()),
            bool(arrays["is_categorical"][:nl - 1].any()))


def check_supported(config: Config) -> None:
    """Raise ``NotImplementedError`` for every configuration outside the
    port so far (gbdt, goss, dart and rf; every objective; f32 or
    quantized gradients; numeric, bundled and categorical features; the
    serial and the rounds grower, CEGB and forced splits; the serial,
    data-, feature- and voting-parallel tree learners)."""
    c = config
    learners.resolve_tree_learner(c.tree_learner)
    if c.pre_partition and axis_size(_group_of(c)) > 1:
        raise NotImplementedError(
            "pre_partition=true (each rank's Dataset holds only its own "
            "rows) is not ported to lightgbm_tpu_torch yet; it waits for "
            "ROADMAP queue A9 (sharded training on pre-partitioned rows)")
    if c.tpu_hist_method not in HIST_METHODS:
        raise ValueError(f"unknown tpu_hist_method {c.tpu_hist_method!r}; "
                         f"expected one of {', '.join(HIST_METHODS)}")


def _group_of(config: Config):
    """The process group a booster of ``config`` trains in: the current
    group (``parallel.network.current_group``) for a sharded tree
    learner with more than one rank, else None."""
    from ..parallel.network import current_group
    if learners.resolve_tree_learner(config.tree_learner) == "serial":
        return None
    g = current_group()
    return g if axis_size(g) > 1 else None


class GBDT:
    """reference: class GBDT (src/boosting/gbdt.h)."""

    boosting_type = "gbdt"
    # quantized-gradient training applies (the JAX package's DART clears
    # it: its reweighting would compound round-local quantization scales)
    _quant_ok = True
    # out-of-core streamed training applies (DART and RF clear it, as in
    # the JAX package); a streamed booster's ``data.stream.StreamContext``
    _stream_ok = True
    _stream = None
    # the streaming election's ``ops.planner.StreamPlan`` (resident or
    # not), which the planner.plan event reads
    stream_election = None

    def __init__(self, config: Config, train_set: Dataset,
                 objective: Optional[ObjectiveFunction]):
        check_supported(config)
        self.config = config
        self.train_set = train_set.construct()
        self.device = self.train_set.device
        self.objective = objective
        self.num_class = config.num_class
        K = self.num_tree_per_iteration = (
            objective.num_model_per_iteration if objective is not None
            else config.num_class)
        self.iter = 0
        self.models: List[HostTree] = []
        self.shrinkage_rate = config.learning_rate
        self.meta = self.train_set.feature_meta()
        wide = [f for f in np.nonzero(self.meta.is_categorical)[0]
                if self.meta.num_bin[f] > 32 * MAX_CAT_WORDS]
        if wide:
            raise ValueError(
                f"categorical features {wide} (used-feature indices) have "
                f"more than {32 * MAX_CAT_WORDS} bins; categorical split "
                f"bitsets cover {32 * MAX_CAT_WORDS} (lower max_bin)")
        # the tree learner and its process group, fixed for the booster
        self.tree_learner_type = self._learner_asked = (
            learners.resolve_tree_learner(config.tree_learner))
        self.group = _group_of(config)
        self.world = axis_size(self.group)
        self.rank = axis_index_flat(self.group)
        if self.group is None:
            self.tree_learner_type = "serial"
        else:
            from ..parallel.network import mesh_plan
            mesh_plan(self.world, num_machines=config.num_machines or None,
                      local_listen_port=config.local_listen_port)
            self._check_same_data()
        self.num_data = self.train_set.num_data
        self.num_bins = int(self.meta.max_num_bin)
        self.binned_t = self.train_set.binned_t
        self.meta_t = self.meta.tensors(self.device)
        # the out-of-core election (data/stream.py): where the planner
        # rules residency out on the card or the host, or the Dataset is
        # block-backed, the matrix stays in its spill store and every
        # histogram pass streams its blocks (the JAX package's
        # boosting/gbdt.py:133)
        self.stream_plan = None
        from ..data.stream import maybe_stream_setup
        if maybe_stream_setup(self):
            self.binned_t = None
        n = self.num_data
        md = self.train_set.metadata
        if objective is not None:
            objective.init(md, n, self.device)
        self.train_score = torch.zeros((K, n), dtype=torch.float32,
                                       device=self.device)
        self.init_scores = [0.0] * K
        self._init_score_added = False
        if md.init_score is not None:
            self.train_score += self._init_score_rows(md.init_score, n)
            self._init_score_added = True
        # the percentile renewal's labels and row weights
        self._renew_pct = (objective.renew_percentile
                           if objective is not None else None)
        if self._renew_pct is not None:
            self._renew_label = torch.as_tensor(
                np.asarray(md.label, np.float32), device=self.device)
            self._renew_weight = (
                torch.as_tensor(np.asarray(md.weight, np.float32),
                                device=self.device)
                if md.weight is not None else None)
        self.valid_sets: List[Dataset] = []
        self.valid_names: List[str] = []
        self.valid_scores: List[torch.Tensor] = []
        self.train_metrics: list = []
        self.valid_metrics: List[list] = []
        self._rng = np.random.RandomState(config.bagging_seed)
        self._feature_rng = np.random.RandomState(
            config.feature_fraction_seed)
        self._cur_mask = None
        self._row_valid = torch.ones(n, dtype=torch.float32,
                                     device=self.device)
        self._ones_fmask = None
        # per-node randomness base key; advanced by iteration
        self._node_key_base = threefry.prng_key(
            (config.extra_trees_seed * 2654435761
             ^ config.feature_fraction_seed) % (2 ** 31))
        self._configure()
        # each kept iteration's K device trees (the first iteration's
        # with the init scores folded in) and the scale each model has
        # taken since (DART's Normalize); rollback_one_iter reads them
        self.tree_history: List[list] = []
        self.history_scale: dict = {}
        # a utils.timer.SectionTimer here splits each iteration's time
        # into sections (and runs the round body eagerly); None keeps the
        # run free of synchronisation
        self.timer = None
        # a list here gets each tree's round log, [(k, m), ...] (one host
        # read a tree)
        self.round_log: Optional[list] = None
        # iterations of an init model (continued training): they come
        # first in ``models`` and have no device trees
        self.num_init_iteration = 0

    def _configure(self) -> None:
        """What the trees take from the config: CEGB's penalties, the
        forced plan, the quantized arm, per-node sampling, monotone
        constraints and the grower, serial or rounds (``reset_config``
        runs it again, which resets the cross-tree CEGB state as the JAX
        package's rebuild does)."""
        config = self.config
        # CEGB (reference: CostEfficientGradientBoosting::IsEnable + Init,
        # cost_effective_gradient_boosting.hpp:25-49; the JAX package's
        # boosting/gbdt.py:595-641): per-original-feature penalty lists
        # onto the used features
        coupled = list(config.cegb_penalty_feature_coupled or [])
        lazy = list(config.cegb_penalty_feature_lazy or [])
        cegb_on = bool(config.cegb_penalty_split > 0.0 or coupled or lazy)
        ntf = self.train_set.num_total_features
        uf = np.asarray(self.train_set.used_features, np.int64)
        pens = {}
        if cegb_on:
            for name, lst in (("cegb_penalty_feature_coupled", coupled),
                              ("cegb_penalty_feature_lazy", lazy)):
                if lst and len(lst) != ntf:
                    raise ValueError(
                        f"{name} should be the same size as feature number "
                        f"({len(lst)} vs {ntf})")
                pens[name] = (np.asarray(lst, np.float32)[uf] if lst
                              else None)
        # the JAX package's f32 fallback (boosting/gbdt.py:642-666)
        quant_on = bool(config.use_quantized_grad)
        if quant_on:
            blockers = []
            if not type(self)._quant_ok:
                blockers.append(f"boosting={self.boosting_type}")
            if cegb_on:
                blockers.append("CEGB")
            if config.monotone_constraints:
                blockers.append("monotone_constraints")
            if config.extra_trees:
                blockers.append("extra_trees (random thresholds)")
            if blockers:
                quant_on = False
                if not getattr(self, "_quant_warned", False):
                    self._quant_warned = True
                    log_warning(
                        "use_quantized_grad=true is not supported with "
                        + ", ".join(blockers)
                        + "; falling back to f32 histograms for this "
                        "booster (training proceeds unquantized)")
        self._quant_on = quant_on
        forced_plan = self._build_forced_plan()
        # the growth (the JAX package's boosting/gbdt.py:960-986, its
        # accelerator rule: the port treats the CPU as the card's twin)
        growth = config.tpu_tree_growth
        tl = self.tree_learner_type
        rounds_ok = (not cegb_on and forced_plan is None
                     and tl in ("serial", "data"))
        if growth in ("rounds", "fast") and not rounds_ok:
            raise ValueError(
                f"tpu_tree_growth={growth} does not support CEGB, voting, "
                "feature-parallel or forced splits; use serial or auto")
        if growth not in ("auto", "serial", "rounds", "fast"):
            raise ValueError(f"unknown tpu_tree_growth {growth!r}")
        serial = growth == "serial" or not rounds_ok
        # the last iteration's (g_scale, h_scale) of each class, 0-dim f32
        # tensors
        self._quant_scales = None
        # feature_fraction_bynode -> the per-node sample count (reference:
        # ColSampler::GetCnt, col_sampler.hpp:28-33, as the JAX package
        # computes it, boosting/gbdt.py:587-594)
        F_used = len(self.train_set.used_features)
        bynode_cnt = 0
        if config.feature_fraction_bynode < 1.0:
            bynode_cnt = max(
                int(round(F_used * config.feature_fraction_bynode)),
                min(2, F_used))
        # monotone constraints per original feature -> the used features
        # (reference: the JAX package's boosting/gbdt.py:943-955)
        self._monotone = None
        mc = config.monotone_constraints
        if mc:
            full = np.zeros(self.train_set.num_total_features, np.int32)
            full[:len(mc)] = np.asarray(mc, np.int32)
            self._monotone = torch.as_tensor(
                full[np.asarray(self.train_set.used_features, np.int64)],
                device=self.device)
        # the JAX package's "fused does not apply" warning
        # (boosting/gbdt.py:688-731), once a booster
        fused_ctx = (not cegb_on and tl not in ("feature", "voting")
                     and forced_plan is None and not config.extra_trees
                     and bynode_cnt == 0 and not self.meta.has_bundles)
        if growth == "serial" and (bool(self.meta.is_categorical.any())
                                   or tl == "data"):
            fused_ctx = False
        if config.tpu_hist_method == "fused" and not fused_ctx \
                and not getattr(self, "_fused_warned", False):
            self._fused_warned = True
            log_warning(
                "tpu_hist_method=fused does not apply to this "
                "configuration (EFB bundles, extra_trees, per-node "
                "column sampling, CEGB, forced splits, streaming, "
                "feature/voting sharding — or categorical/data-parallel "
                "under tpu_tree_growth=serial); falling back to the "
                "staged kernel family")
        self.grower_cfg = GrowerConfig(
            num_leaves=config.num_leaves, max_depth=config.max_depth,
            hp=config.split_hyperparams(), num_bins=self.num_bins,
            round_width=config.tpu_round_width,
            hist_method=config.tpu_hist_method, quant=quant_on,
            quant_bins=config.num_grad_quant_bins,
            quant_renew=config.quant_train_renew_leaf,
            bynode_feature_cnt=bynode_cnt,
            rounds_relaxed=growth == "fast",
            cegb_tradeoff=config.cegb_tradeoff,
            cegb_penalty_split=config.cegb_penalty_split,
            cegb_coupled=bool(coupled), cegb_lazy=bool(lazy),
            n_forced=0 if forced_plan is None else len(forced_plan[0]),
            forced_exact_parity=config.tpu_forced_split_parity,
            voting_top_k=config.top_k if tl == "voting" else 0)
        if self._stream is not None:
            # the streamed rounds grower over the spill store (streaming
            # grows by rounds whatever tpu_tree_growth says, as in the JAX
            # package); a reset to a config it does not cover raises
            from ..data.stream import StreamGrower, _config_stream_blockers
            blockers = _config_stream_blockers(self)
            if blockers:
                from ..utils.log import LightGBMError
                raise LightGBMError(
                    "this booster trains out of core (streamed from its "
                    "spill store), which requires a streaming-compatible "
                    "config; unsupported here: " + ", ".join(blockers))
            self._slot_of_row = self._n_shard = self.layout = None
            self._rows_t = None      # every row is the grower's
            self.grower = self._stream.grower = StreamGrower(
                self._stream.store, self.meta, self.grower_cfg, self.meta_t,
                self.device)
            self._publish_plan()
            return
        binned, meta, meta_t, shard = self._shard_inputs()
        if serial:
            # one split at a time; it carries the CEGB state across trees
            self.grower = SerialGrower(
                binned, meta, self.grower_cfg, meta_t,
                self._monotone, pens.get("cegb_penalty_feature_coupled"),
                pens.get("cegb_penalty_feature_lazy"), forced_plan,
                shard=shard)
        else:
            # the round loop of every tree: its buffers and, on the card,
            # its CUDA graph
            self.grower = RoundGrower(binned, meta, self.grower_cfg, meta_t,
                                      self._monotone, shard=shard)
        self._publish_plan()

    def _publish_plan(self) -> None:
        """The settled arm as the ``planner.plan`` instant, the registry's
        training gauges and the flight recorder's context (the JAX
        package's boosting/gbdt.py:845-895): the growth (rounds, serial
        or stream), the histogram arm (fused or staged, never "auto"),
        f32 or quantized, the round's candidate lanes (``KCAP``; 1 for
        the serial grower), and the planner's predicted card peak
        (``ops.planner.predict_peak_bytes``, or the streamed peak) beside
        the election's budget (``device_limit_bytes`` times the
        headroom).  Host arithmetic only."""
        from ..ops.histogram import hist_payload_bytes
        from ..ops.planner import (NO_DEVICE_LIMIT, predict_peak_bytes,
                                   predict_stream_device_peak_bytes)
        g, cfg, c = self.grower, self.grower_cfg, self.config
        n, G = self.train_set.binned_shape()
        growth = ("stream" if self._stream is not None
                  else "serial" if isinstance(g, SerialGrower)
                  else "rounds")
        variant = "fused" if g.fused_arm else "staged"
        args = (n, G, self.num_bins)
        if self._stream is not None:
            peak = predict_stream_device_peak_bytes(
                *args, self._stream.store.block_rows, cfg.num_leaves,
                self.num_tree_per_iteration, self._quant_on,
                cfg.round_width)
        else:
            peak = predict_peak_bytes(*args, cfg.num_leaves,
                                      self.num_tree_per_iteration,
                                      self._quant_on, cfg.round_width)[0]
        el = self.stream_election
        # None: no card limit (the CPU), so no budget gauge
        budget = (int(el.device_budget_bytes) if el is not None
                  and el.device_budget_bytes < NO_DEVICE_LIMIT else None)
        plan = {"variant": variant, "growth": growth,
                "fused": variant == "fused", "quant": self._quant_on,
                "kcap": int(getattr(g, "KCAP", 1)),
                "tree_learner": self.tree_learner_type,
                "predicted_peak_bytes": int(peak), "budget_bytes": budget,
                "feasible": budget is None or peak <= budget,
                "stream": self._stream is not None}
        # a checkpoint bundle's manifest records it (provenance only)
        self.hist_plan = plan
        _instant("planner.plan", rows=n, features=G, **plan)
        _obs_registry.gauge("train_hist_method").set(variant)
        _obs_registry.gauge("train_hist_predicted_peak_bytes").set(int(peak))
        if budget is not None:
            _obs_registry.gauge("train_hbm_budget_bytes").set(budget)
        if self.group is not None:
            _obs_registry.gauge("train_psum_payload_bytes").set(
                hist_payload_bytes(len(self.meta.num_bin), self.num_bins,
                                   quant=self._quant_on))
        # the plan rides every forensic bundle's fingerprint: the ring
        # may have rolled past the instant when a long run dies
        _flight.set_context(hist_plan=plan, num_leaves=c.num_leaves,
                            objective=c.objective)

    def _check_same_data(self) -> None:
        """Every rank must hold the same training set, whose rows the
        booster shards: one all-gather of the row count and a digest of
        the labels, raising where a rank differs (a Dataset of each
        rank's own rows would be sliced again as if it held every row,
        and the trees would be silently wrong)."""
        import hashlib
        label = np.ascontiguousarray(self.train_set.metadata.label,
                                     np.float32)
        digest = np.frombuffer(hashlib.sha256(label.tobytes()).digest(),
                               np.int64)
        mine = torch.as_tensor(np.concatenate(
            [[self.train_set.num_data], digest]))
        every = all_gather_tiered(mine, self.group)
        if not bool((every == every[0]).all()):
            raise ValueError(
                f"tree_learner={self.tree_learner_type} needs the same "
                "training set on every rank (the booster shards its "
                f"rows); the ranks hold {every[:, 0].tolist()} rows and "
                f"{len({tuple(r) for r in every[:, 1:].tolist()})} "
                "different label sets.  Training on a Dataset of each "
                "rank's own rows (pre_partition, parallel.dist_data."
                "construct_distributed) waits for ROADMAP queue A9 "
                "(sharded training on pre-partitioned rows)")

    def _shard_inputs(self):
        """This rank's share of the training set for the grower:
        (binned [G, rows], meta, meta tensors, ``ShardSpec`` or None),
        and the row layout the trees' gathers use (``_rows_t``: this
        rank's global rows, or None for all of them)."""
        self._slot_of_row = self._n_shard = self.layout = None
        tl = self.tree_learner_type
        if tl in ("data", "voting"):
            n = self.num_data
            need_group = getattr(self.objective, "need_group", False)
            md = self.train_set.metadata
            if need_group and md.query_boundaries is None:
                raise RuntimeError("Ranking tasks require query information")
            self.layout = (learners.query_layout(md.query_boundaries,
                                                 self.world)
                           if need_group
                           else learners.contiguous_layout(n, self.world))
            self._n_shard = self.layout.n_shard
            slot = np.empty(n, np.int64)
            real = self.layout.perm < n
            slot[self.layout.perm[real]] = np.nonzero(real)[0]
            self._slot_of_row = torch.as_tensor(slot, device=self.device)
        share = learners.grower_inputs(tl, self.group, self.binned_t,
                                       self.meta, self.layout)
        self._rows_t = share.rows
        meta_t = (self.meta_t if share.meta is self.meta
                  else share.meta.tensors(self.device))
        return share.binned_t, share.meta, meta_t, share.spec

    def _local(self, x: torch.Tensor) -> torch.Tensor:
        """A per-row tensor [n] -> this rank's rows (data, voting)."""
        return x if self._rows_t is None else x.index_select(0, self._rows_t)

    def _global_leaf_id(self, leaf_id: torch.Tensor) -> torch.Tensor:
        """This rank's rows' leaf ids -> every row's, in row order: one
        all-gather of each rank's block, padded to ``n_shard``."""
        if self._rows_t is None:
            return leaf_id
        pad = leaf_id.new_zeros(self._n_shard, dtype=torch.int32)
        pad[:leaf_id.shape[0]] = leaf_id
        allb = all_gather_tiered(pad, self.group).reshape(-1)
        return allb.index_select(0, self._slot_of_row).to(torch.int64)

    def _build_forced_plan(self):
        """``forcedsplits_filename`` as plan arrays (leaf, used feature,
        threshold bin), each [n_forced] int32, or None (reference: the
        ForceSplits BFS, serial_tree_learner.cpp:411-521; the JAX
        package's boosting/gbdt.py:280-335).  The leaves are known in
        advance: the splits apply in BFS order, the left child keeps the
        parent's leaf and the right child of the i-th split is leaf i +
        1.  A numerical threshold bin is clamped to [0, num_bin - 2]; a
        split on a feature binning dropped ends the plan there, with a
        warning."""
        fname = self.config.forcedsplits_filename
        if not fname:
            return None
        import json
        from collections import deque

        from ..binning import BinType
        from ..utils.file_io import open_file
        with open_file(fname) as f:
            root = json.load(f)
        inner = {orig: j for j, orig in
                 enumerate(self.train_set.used_features)}
        mappers = self.train_set.bin_mappers
        leaves, feats, thrs = [], [], []
        q = deque()
        if isinstance(root, dict) and "feature" in root \
                and "threshold" in root:
            q.append((root, 0))
        while q and len(leaves) < self.config.num_leaves - 1:
            node, leaf = q.popleft()
            forig = int(node["feature"])
            if forig not in inner:
                log_warning(
                    f"forced split on unused/trivial feature {forig}; "
                    "the rest of the forced-splits plan is dropped")
                break
            m = mappers[forig]
            tb = int(m.value_to_bin(
                np.array([float(node["threshold"])]))[0])
            if m.bin_type == BinType.NUMERICAL:
                tb = min(max(tb, 0), max(m.num_bin - 2, 0))
            leaves.append(leaf)
            feats.append(inner[forig])
            thrs.append(tb)
            right_leaf = len(leaves)      # i + 1 for the i-th split
            for side, child_leaf in (("left", leaf), ("right", right_leaf)):
                ch = node.get(side)
                if isinstance(ch, dict) and "feature" in ch \
                        and "threshold" in ch:
                    q.append((ch, child_leaf))
        if not leaves:
            return None
        return (np.asarray(leaves, np.int32), np.asarray(feats, np.int32),
                np.asarray(thrs, np.int32))

    def _section(self, name: str):
        if self.timer is None:
            return contextlib.nullcontext()
        return self.timer.section(name)

    def _init_score_rows(self, init_score, n: int) -> torch.Tensor:
        """A user's init score ([n], or [K * n] class-major) as [K, n]."""
        K = self.num_tree_per_iteration
        isc = np.asarray(init_score, np.float32)
        isc = (isc.reshape(K, n) if isc.size == K * n
               else np.broadcast_to(isc.reshape(1, n), (K, n)))
        return torch.as_tensor(np.ascontiguousarray(isc), device=self.device)

    # ------------------------------------------------------------------ setup

    def add_valid(self, valid_set: Dataset, name: str) -> None:
        valid_set.construct()
        if valid_set.device != self.device:
            raise ValueError(f"valid set on {valid_set.device}, training on "
                             f"{self.device}")
        self.valid_sets.append(valid_set)
        self.valid_names.append(name)
        nv = valid_set.num_data
        vs = torch.zeros((self.num_tree_per_iteration, nv),
                         dtype=torch.float32, device=self.device)
        if valid_set.metadata.init_score is not None:
            vs += self._init_score_rows(valid_set.metadata.init_score, nv)
        self.valid_scores.append(vs)

    def set_metrics(self, train_metrics, valid_metrics_per_set) -> None:
        self.train_metrics = train_metrics
        self.valid_metrics = valid_metrics_per_set

    # --------------------------------------------------------------- training

    def _bagging_mask(self, it: int) -> torch.Tensor:
        """reference: GBDT::Bagging (gbdt.cpp:163-244) as a weight mask,
        with the JAX package's RandomState draws."""
        c = self.config
        n = self.num_data
        need = c.bagging_freq > 0 and c.bagging_fraction < 1.0
        need_posneg = (c.pos_bagging_fraction < 1.0
                       or c.neg_bagging_fraction < 1.0)
        if not (need or need_posneg):
            return self._row_valid
        if it % max(c.bagging_freq, 1) != 0 and self._cur_mask is not None:
            return self._cur_mask
        if need_posneg:
            lbl = np.asarray(self.train_set.metadata.label) > 0
            u = self._rng.rand(n)
            keep = np.where(lbl, u < c.pos_bagging_fraction,
                            u < c.neg_bagging_fraction)
        else:
            cnt = int(n * c.bagging_fraction)
            idx = self._rng.choice(n, size=cnt, replace=False)
            keep = np.zeros(n, bool)
            keep[idx] = True
        self._cur_mask = torch.as_tensor(keep.astype(np.float32),
                                         device=self.device)
        return self._cur_mask

    def _feature_masks(self) -> torch.Tensor:
        """Per-tree column sampling (reference: ColSampler by-tree,
        col_sampler.hpp:19), [K, F]: class k's mask is the k-th draw of
        the one stream."""
        K = self.num_tree_per_iteration
        F = len(self.train_set.used_features)
        frac = self.config.feature_fraction
        if frac >= 1.0:
            if self._ones_fmask is None:
                self._ones_fmask = torch.ones((K, F), dtype=torch.float32,
                                              device=self.device)
            return self._ones_fmask
        cnt = max(1, int(round(F * frac)))
        masks = np.zeros((K, F), np.float32)
        for k in range(K):
            masks[k, self._feature_rng.choice(F, size=cnt,
                                              replace=False)] = 1.0
        return torch.as_tensor(masks, device=self.device)

    def boost_from_average(self) -> None:
        """reference: GBDT::BoostFromAverage (gbdt.cpp:313), class by
        class."""
        if (self.iter > 0 or self.objective is None
                or self._init_score_added):
            return
        if not self.config.boost_from_average:
            return
        self._init_score_added = True
        for k in range(self.num_tree_per_iteration):
            s = self.objective.boost_from_score(k)
            if abs(s) > K_EPSILON:
                self.init_scores[k] = s
                self.train_score[k] += f32(s)
                for vs in self.valid_scores:
                    vs[k] += f32(s)
                log_info(f"Start training from score {s:.6f}")

    def _gradients(self, score: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The objective's gradients and hessians of the scores [K, n],
        as [K, n]."""
        if self.objective is None:
            raise RuntimeError("no objective: gradients must be provided")
        K, n = self.num_tree_per_iteration, self.num_data
        g, h = self.objective.get_gradients(score if K > 1 else score[0])
        return g.reshape(K, n), h.reshape(K, n)

    def _given_gradients(self, grad, hess):
        """A custom objective's gradients ([n] or [K * n] class-major,
        any float type) as f32 [K, n] on the device."""
        K, n = self.num_tree_per_iteration, self.num_data

        def put(a):
            return torch.as_tensor(
                np.ascontiguousarray(np.asarray(a, np.float32).reshape(K, n)),
                device=self.device)
        return put(grad), put(hess)

    def train_one_iter(self, grad=None, hess=None) -> bool:
        """One boosting iteration; True when training should stop (no
        splittable leaf in any class's tree).  ``grad``/``hess``: a
        custom objective's gradients.  reference: GBDT::TrainOneIter.
        A supported booster runs it as a chunk of one
        (``boosting/macro.py``), so training does not depend on how its
        iterations are chunked."""
        with global_timer.section("GBDT::TrainOneIter"):
            if grad is None and self._chunk_ok():
                from .macro import run_chunk
                return run_chunk(self, 1)
            self.boost_from_average()
            with self._section("objective"):
                if grad is None:
                    with global_timer.section("GBDT::Boosting(gradients)"):
                        grad, hess = self._gradients(self.train_score)
                else:
                    grad, hess = self._given_gradients(grad, hess)
                with global_timer.section("GBDT::Bagging"):
                    mask = self._bagging_mask(self.iter)
            return self._train_with(grad, hess, mask)

    def _train_with(self, grad, hess, mask) -> bool:
        with global_timer.section("TreeLearner::Train(dispatch)"), \
                _span("gbdt.dispatch", iteration=self.iter):
            trees = self._grow(self.train_score, grad, hess, mask,
                               self.shrinkage_rate, self._feature_masks(),
                               self._node_key())
        return self._finish_iter(trees)

    def _renew_residual(self, score: torch.Tensor, k: int) -> torch.Tensor:
        """The residuals the percentile renewal of class k's tree reads:
        ``label - score[k]``, the scores before this tree (RF overrides)."""
        return self._renew_label - score[k]

    def _grow(self, score: torch.Tensor, grad, hess, mask, lr, fmask, rng,
              alive: Optional[torch.Tensor] = None) -> list:
        """Grow class k's tree from ``grad[k]``/``hess[k]`` for every k
        (feature masks ``fmask`` [K, F], node key ``rng``), renew, shrink
        by ``lr`` and add it to ``score[k]`` in place (only where the
        device flag ``alive`` holds, if given); returns the K trees
        (reference: the JAX package's ``iter_body``,
        boosting/gbdt.py:1019-1115)."""
        cfg = self.grower_cfg
        lr32 = f32(lr)
        trees, scales = [], []
        row_group = None if self._rows_t is None else self.group
        mask_l = self._local(mask)
        for k in range(self.num_tree_per_iteration):
            quant_vals = None
            g_l, h_l = self._local(grad[k]), self._local(hess[k])
            if self._quant_on:
                with self._section("quantize"):
                    qkey = threefry.fold_in(
                        threefry.fold_in(rng, 0x51475442), k)
                    if row_group is not None:
                        # i.i.d. rounding noise across the ranks' rows
                        qkey = threefry.fold_in(qkey, self.rank)
                    quant_vals = quantize_gradients(
                        g_l, h_l, mask_l,
                        self.config.num_grad_quant_bins, qkey,
                        stochastic=self.config.stochastic_rounding,
                        group=row_group, draw_rows=self._n_shard)
                    scales.append(quant_vals[2:])
            log = [] if self.round_log is not None else None
            tree, leaf_id = self.grower.grow(
                g_l, h_l, mask_l, fmask[k], quant_vals,
                threefry.fold_in(rng, k), self.timer, log)
            leaf_id = self._global_leaf_id(leaf_id)
            if log is not None:
                self.round_log.append(log)
            with self._section("score"):
                if self._renew_pct is not None:
                    w = (mask if self._renew_weight is None
                         else mask * self._renew_weight)
                    pct = leaf_percentile(
                        leaf_id, self._renew_residual(score, k), w,
                        cfg.num_leaves, float(self._renew_pct))
                    active = (torch.arange(cfg.num_leaves,
                                           device=self.device)
                              < tree.num_leaves)
                    tree = tree._replace(leaf_value=torch.where(
                        active, pct, tree.leaf_value))
                tree = tree._replace(
                    leaf_value=tree.leaf_value * lr32,
                    internal_value=tree.internal_value * lr32)
                if alive is None:
                    score[k] += tree.leaf_value[leaf_id]
                else:
                    score[k] = torch.where(
                        alive, score[k] + tree.leaf_value[leaf_id],
                        score[k])
            trees.append(tree)
        if self._quant_on:
            self._quant_scales = scales
        return trees

    def _node_key(self):
        """This iteration's key: ``fold_in(base, iter)``."""
        return threefry.fold_in(self._node_key_base, self.iter)

    def _host_trees(self, trees) -> List[HostTree]:
        with self._section("host_tree"):
            return [tree_to_host(t, self.train_set, self.shrinkage_rate)
                    for t in trees]

    def _stop(self, new_models: List[HostTree]) -> bool:
        """True (and the warning) when no class's tree split; the first
        iteration then keeps constant trees of the init scores
        (reference: gbdt.cpp:387-405, AsConstantTree)."""
        if any(ht.num_leaves > 1 for ht in new_models):
            return False
        log_warning("Stopped training because there are no more leaves "
                    "that meet the split requirements")
        if self.iter == 0 and not self.models:
            for k, ht in enumerate(new_models):
                ht.leaf_value[:1] = self.init_scores[k]
            self.models.extend(new_models)
        return True

    def _keep_iteration(self, new_models: List[HostTree], trees,
                        it: int) -> bool:
        """Host bookkeeping of iteration ``it``'s trees: the stop check,
        the first iteration's bias, the model list and the device tree
        history; True when training should stop."""
        self.iter = it
        if self._stop(new_models):
            return True
        first = it == 0
        for k, ht in enumerate(new_models):
            if first and abs(self.init_scores[k]) > K_EPSILON:
                ht.add_bias(self.init_scores[k])
        self.models.extend(new_models)
        # a device tree's output equals its host tree's: the first
        # iteration's carries the init score, as add_bias
        self.tree_history.append([
            t._replace(leaf_value=t.leaf_value + f32(self.init_scores[k]))
            if first and abs(self.init_scores[k]) > K_EPSILON else t
            for k, t in enumerate(trees)])
        return False

    def _finish_iter(self, trees) -> bool:
        """Host trees, first-iteration bias, valid-score updates of an
        iteration trained outside a chunk (DART, a custom objective);
        True when training should stop."""
        with global_timer.section("GBDT::FinishIter(host trees)"), \
                _span("gbdt.finish_iter", iteration=self.iter):
            new_models = self._host_trees(trees)
            if self._keep_iteration(new_models, trees, self.iter):
                return True
            with self._section("score"):
                self._valid_update(trees, self.iter)
            self.iter += 1
            return False

    def _valid_update(self, trees, it: int, routes=None) -> None:
        """Add iteration ``it``'s trees to the valid scores; ``routes``:
        each tree's (depth, has categorical split), read on the host, so
        the routing waits on nothing."""
        for i, vs in enumerate(self.valid_sets):
            for k, t in enumerate(trees):
                self.valid_scores[i][k] += self._tree_output(
                    t, vs, *(routes[k] if routes else ()))

    def _tree_output(self, tree, dataset: Dataset, depth=None,
                     has_cat=None) -> torch.Tensor:
        """A device tree's leaf values over the rows of a constructed
        dataset (``depth``/``has_cat``: its depth and whether it has a
        categorical split, when known on the host)."""
        if dataset.binned_t is None:
            # a block-backed dataset: its spill store's blocks in turn
            from ..data.stream import BlockPump
            leaf = torch.cat([
                predict_leaf_index_binned(tree, block, self.meta_t, depth,
                                          has_cat)
                for _i, _s, _r, block in BlockPump(dataset._block_store,
                                                   self.device)])
        else:
            leaf = predict_leaf_index_binned(tree, dataset.binned_t,
                                             self.meta_t, depth, has_cat)
        return tree.leaf_value[leaf]

    def _tree_pred(self, model_idx: int, dataset) -> torch.Tensor:
        """Model ``model_idx``'s current output over ``dataset``'s rows:
        its device tree times the scale it has taken since."""
        it, k = divmod(model_idx, self.num_tree_per_iteration)
        it -= self.num_init_iteration
        if it < 0:
            raise ValueError(
                f"model {model_idx} belongs to the init model, whose trees "
                "have no device copy to route binned rows through")
        out = self._tree_output(self.tree_history[it][k], dataset)
        scale = self.history_scale.get(model_idx, 1.0)
        return out * f32(scale) if scale != 1.0 else out

    def rollback_one_iter(self) -> None:
        """Take the last iteration's trees out of the train and valid
        scores, then drop them (reference: GBDT::RollbackOneIter,
        gbdt.cpp:422; the JAX package's boosting/gbdt.py:2023-2049)."""
        if self.iter <= 0:
            return
        if self._stream is not None:
            raise RuntimeError(
                "rollback_one_iter re-evaluates trees over the resident "
                "binned matrix; an out-of-core streamed booster has none "
                "(DART and rollback stay resident — "
                "stream_override(force=False))")
        K = self.num_tree_per_iteration
        first = len(self.models) - K
        for k in range(K):
            self.train_score[k] -= self._tree_pred(first + k,
                                                   self.train_set)
            for i, vs in enumerate(self.valid_sets):
                self.valid_scores[i][k] -= self._tree_pred(first + k, vs)
            self.history_scale.pop(first + k, None)
        del self.models[-K:]
        self.tree_history.pop()
        self.iter -= 1

    # ------------------------------------------------------------ checkpoint

    def _row_layout(self) -> dict:
        """How this booster's rows lie over its ranks (the tree learner,
        the world and this rank): a bundle restores only into the same
        layout."""
        return {"tree_learner": self.tree_learner_type,
                "world": int(self.world), "rank": int(self.rank)}

    def capture_state(self) -> dict:
        """Every mutable state of the training loop as host values (NumPy
        arrays, builtins and the port's host trees), so a bundle does not
        depend on the device it was written on; ``restore_state`` of it
        into a fresh booster of the same config and data replays the
        same random draws and the same f32 sums (the JAX package's
        boosting/gbdt.py:1793-1854, under its keys where the state
        exists in the port).  The per-iteration node and quantization
        keys are ``fold_in(base, iter)``: restoring ``iter`` restores
        them.  GOSS's key stream is ``goss_rng_key`` (``goss.py``);
        CEGB's cross-tree state is the serial grower's ``cegb_state``."""
        import copy as _copy

        def host(t):
            return t.detach().cpu().numpy() if isinstance(
                t, torch.Tensor) else t

        cegb = getattr(self.grower, "cegb_state", None)
        return {
            "boosting_type": self.boosting_type,
            "iter": int(self.iter),
            "num_init_iteration": int(self.num_init_iteration),
            "num_data": int(self.num_data),
            "row_layout": self._row_layout(),
            "models": [_copy.deepcopy(m) for m in self.models],
            "train_score": host(self.train_score),
            "valid_scores": [host(v) for v in self.valid_scores],
            "init_scores": list(self.init_scores),
            "init_score_added": bool(self._init_score_added),
            "shrinkage_rate": float(self.shrinkage_rate),
            "bagging_rng": self._rng.get_state(),
            "feature_rng": self._feature_rng.get_state(),
            "cur_mask": host(self._cur_mask),
            "history_scale": dict(self.history_scale),
            "tree_history": [[{f: host(getattr(t, f)) for f in t._fields}
                              for t in trees]
                             for trees in self.tree_history],
            "cegb_state": (None if cegb is None
                           else tuple(host(a) for a in cegb)),
            "quant_scales": (None if self._quant_scales is None else
                             [tuple(host(s) for s in sc)
                              for sc in self._quant_scales]),
        }

    def restore_state(self, st: dict) -> None:
        """Inverse of ``capture_state`` into a freshly built booster of
        the same config, training data and valid sets (the engine builds
        it first).  Refuses a booster whose round graph is already
        captured, and a bundle of another row layout: an elastic resume
        into another layout waits for ROADMAP queue A9
        (resilience/elastic.py)."""
        import copy as _copy
        from ..grower import TreeArrays
        if st.get("boosting_type") != self.boosting_type:
            raise ValueError(
                f"checkpoint was boosting={st.get('boosting_type')!r}, this "
                f"run is boosting={self.boosting_type!r}")
        if len(st["valid_scores"]) != len(self.valid_scores):
            raise ValueError(
                f"checkpoint has {len(st['valid_scores'])} valid sets, this "
                f"run has {len(self.valid_scores)}")
        if (int(st["num_data"]) != self.num_data
                or st["row_layout"] != self._row_layout()):
            raise ValueError(
                f"the checkpoint holds {st['num_data']} rows laid out as "
                f"{st['row_layout']}; this run has {self.num_data} rows "
                f"laid out as {self._row_layout()}; resuming into another "
                "row layout (an elastic resume) waits for ROADMAP queue A9 "
                "(resilience/elastic.py)")
        if getattr(self.grower, "graph", None) is not None:
            raise RuntimeError(
                "restore_state needs a fresh booster: this one has already "
                "captured its round graph")
        dev = self.device

        def dev_t(a):
            return (torch.as_tensor(np.asarray(a), device=dev)
                    if isinstance(a, np.ndarray) else a)

        self.iter = int(st["iter"])
        self.num_init_iteration = int(st["num_init_iteration"])
        self.models[:] = [_copy.deepcopy(m) for m in st["models"]]
        self.train_score = dev_t(st["train_score"]).clone()
        self.valid_scores = [dev_t(v).clone() for v in st["valid_scores"]]
        self.init_scores = list(st["init_scores"])
        self._init_score_added = bool(st["init_score_added"])
        self.shrinkage_rate = float(st["shrinkage_rate"])
        self._rng.set_state(st["bagging_rng"])
        self._feature_rng.set_state(st["feature_rng"])
        self._cur_mask = (None if st["cur_mask"] is None
                          else dev_t(st["cur_mask"]))
        self.history_scale = dict(st["history_scale"])
        self.tree_history = [[TreeArrays(**{f: dev_t(v)
                                            for f, v in t.items()})
                              for t in trees]
                             for trees in st["tree_history"]]
        cegb = getattr(self.grower, "cegb_state", None)
        saved = st.get("cegb_state")
        if (cegb is None) != (saved is None):
            raise ValueError("the checkpoint's CEGB state does not match "
                             "this run's CEGB configuration")
        if cegb is not None:
            # the grower's buffers in place: already charged penalties
            # stay charged
            for buf, a in zip(cegb, saved):
                if (buf is None) != (a is None):
                    raise ValueError("the checkpoint's lazy CEGB bitmap "
                                     "does not match this run's")
                if buf is not None:
                    buf.copy_(dev_t(a))
        qs = st.get("quant_scales")
        self._quant_scales = (None if qs is None else
                              [tuple(dev_t(s) for s in sc) for sc in qs])

    # ------------------------------------------------ refit and resets

    def reset_config(self) -> None:
        """Re-derive what the trees take from ``self.config`` after a
        parameter reset (the JAX package rebuilds its jitted functions).
        The tree learner cannot change: the rows' layout over the ranks
        is fixed when the booster is built."""
        check_supported(self.config)
        tl = learners.resolve_tree_learner(self.config.tree_learner)
        if tl != self._learner_asked:
            raise ValueError(
                f"Cannot change tree_learner during training (from "
                f"{self._learner_asked} to {tl}): the layout of the rows "
                "over the ranks is fixed when the booster is built")
        self._configure()

    def refit_leaf_values(self, leaf_preds: np.ndarray,
                          decay_rate: float) -> None:
        """Refit every tree's leaf values to this dataset's gradients,
        the structures fixed: iteration by iteration, the gradients of
        the current train scores are summed by leaf (f64, in row order),
        and each leaf becomes ``decay * old + (1 - decay) * output *
        shrinkage``.  ``leaf_preds``: [n, trees] leaf indices.
        reference: GBDT::RefitTree (gbdt.cpp:267-290),
        SerialTreeLearner::FitByExistingTree (serial_tree_learner.cpp:
        198-229); the JAX package's boosting/gbdt.py:1949."""
        K = self.num_tree_per_iteration
        n = self.num_data
        leaf_preds = np.asarray(leaf_preds)
        if leaf_preds.ndim == 1:
            leaf_preds = leaf_preds[:, None]
        if leaf_preds.shape != (n, len(self.models)):
            raise ValueError(f"leaf_preds shape {leaf_preds.shape} != "
                             f"({n}, {len(self.models)})")
        c = self.config
        for it in range(len(self.models) // K):
            grad, hess = self._gradients(self.train_score)
            g = grad.cpu().numpy()
            h = hess.cpu().numpy()
            for k in range(K):
                m = self.models[it * K + k]
                lp = leaf_preds[:, it * K + k].astype(np.int64)
                if lp.max(initial=0) >= m.num_leaves:
                    raise ValueError("leaf prediction out of range")
                sg = np.bincount(lp, weights=g[k], minlength=m.num_leaves)
                sh = np.bincount(lp, weights=h[k],
                                 minlength=m.num_leaves) + K_EPSILON
                reg = np.sign(sg) * np.maximum(np.abs(sg) - c.lambda_l1, 0.0)
                out = -reg / (sh + c.lambda_l2)
                if c.max_delta_step > 0:
                    out = np.clip(out, -c.max_delta_step, c.max_delta_step)
                m.leaf_value = (decay_rate * m.leaf_value
                                + (1.0 - decay_rate) * out * m.shrinkage)
                self.train_score[k] += torch.as_tensor(
                    m.leaf_value[lp].astype(np.float32), device=self.device)

    def reset_training_data(self, train_set: Dataset, raw_scores=None) -> None:
        """Train on ``train_set`` from now on (reference:
        GBDT::ResetTrainingData, gbdt.cpp:653): it must be binned with the
        current bin mappers; its train scores are its init scores plus
        every tree so far, this run's trees routed on the card through
        their device copies.  ``raw_scores``: the init model's raw scores
        of the new rows ([K, n]), which continued training needs."""
        train_set.construct()
        old = self.train_set
        if not same_bins(train_set.bin_mappers, old.bin_mappers) \
                or not np.array_equal(train_set.feat_group, old.feat_group):
            from ..utils.log import LightGBMError
            raise LightGBMError(
                "Cannot reset training data, since new training data has "
                "different bin mappers")
        if train_set.device != self.device:
            raise ValueError(f"the new train set lives on {train_set.device},"
                             f" the booster on {self.device}")
        if self.num_init_iteration and raw_scores is None:
            raise ValueError(
                "resetting the training data of a continued training needs "
                "the init model's scores of the new rows")
        K = self.num_tree_per_iteration
        # the election again, for the new set: it streams from its own
        # store where the planner or its spill says so (a refused config
        # leaves the booster on its old set)
        from ..data.stream import maybe_stream_setup
        kept = self.train_set, self._stream, self.stream_plan
        self.train_set, self._stream, self.stream_plan = train_set, None, None
        try:
            streamed = maybe_stream_setup(self)
        except Exception:
            self.train_set, self._stream, self.stream_plan = kept
            raise
        self.num_data = n = train_set.num_data
        self.binned_t = None if streamed else train_set.binned_t
        md = train_set.metadata
        if self.objective is not None:
            self.objective.init(md, n, self.device)
        score = torch.zeros((K, n), dtype=torch.float32, device=self.device)
        if md.init_score is not None:
            score += self._init_score_rows(md.init_score, n)
        if raw_scores is not None:
            score += torch.as_tensor(np.asarray(raw_scores, np.float32)
                                     .reshape(K, n), device=self.device)
        for mi in range(self.num_init_iteration * K, len(self.models)):
            score[mi % K] += self._tree_pred(mi, train_set)
        self.train_score = score
        if self._renew_pct is not None:
            self._renew_label = torch.as_tensor(
                np.asarray(md.label, np.float32), device=self.device)
            self._renew_weight = (
                torch.as_tensor(np.asarray(md.weight, np.float32),
                                device=self.device)
                if md.weight is not None else None)
        self._cur_mask = None
        self._row_valid = torch.ones(n, dtype=torch.float32,
                                     device=self.device)
        self._configure()

    # ----------------------------------------------------------- chunks

    # a chunk trains every boosting type but DART (per-iteration drops)
    _macro_ok = True

    def _chunk_ok(self) -> bool:
        """True when ``boosting/macro.py`` can train this booster's
        iterations (False for DART and a custom objective, which need the
        host every iteration)."""
        return type(self)._macro_ok and self.objective is not None

    def chunk_supported(self) -> bool:
        """True when ``train_chunk`` queues several iterations at once;
        False where ``_chunk_ok`` is, and for a streamed booster, whose
        pump is driven from the host (the JAX package's
        boosting/gbdt.py:1484-1495): the engine then trains one
        iteration at a time."""
        return self._chunk_ok() and self._stream is None

    def train_chunk(self, c: int, lrs=None) -> bool:
        """Train ``c`` iterations as one chunk; the same model as ``c``
        calls of ``train_one_iter``.  A streamed booster trains them one
        at a time.  True when training stopped."""
        from .macro import run_chunk
        with global_timer.section("GBDT::TrainChunk"):
            if self._stream is not None and self._chunk_ok():
                for j in range(c):
                    if run_chunk(self, 1,
                                 None if lrs is None else [lrs[j]]):
                        return True
                return False
            return run_chunk(self, c, lrs)

    def _chunk_goss_keys(self, its, lrs) -> list:
        return [None] * len(its)

    def _chunk_gradients(self, score):
        return self._gradients(score)

    def _chunk_mask(self, grad, hess, mask, goss_key):
        return mask

    def _chunk_step(self, score, grad, hess, mask, xs, j: int, alive):
        """Iteration ``j`` of a chunk: its trees, and the train score
        after them (unchanged where ``alive`` is False)."""
        trees = self._grow(score, grad, hess, mask, xs.lrs[j], xs.fmasks[j],
                           xs.keys[j], alive)
        return trees, score

    def _finish_chunk(self, stacked, xs, it0: int) -> bool:
        """The host side of a chunk: every device tree's fields in one
        transfer a field, the host trees, the stop check (a stop
        truncates the chunk there), the valid scores of the kept
        iterations.  True when training stopped.  The JAX package's
        ``macro.host_fetch`` span (``gbdt.finish_iter`` for a streamed
        booster's iteration)."""
        with global_timer.section("GBDT::FinishIter(host trees)"), \
                (_span("gbdt.finish_iter", iteration=it0)
                 if self._stream is not None else
                 _span("macro.host_fetch", c=len(stacked), it0=it0)):
            return self._finish_chunk_inner(stacked, xs, it0)

    def _finish_chunk_inner(self, stacked, xs, it0: int) -> bool:
        K = self.num_tree_per_iteration
        flat = [t for trees in stacked for t in trees]
        with self._section("host_tree"):
            bulk = {f: torch.stack([getattr(t, f) for t in flat]).cpu()
                    .numpy() for f in flat[0]._fields}
        stopped, routes = False, []
        for j, trees in enumerate(stacked):
            arrays = [{f: a[j * K + k] for f, a in bulk.items()}
                      for k in range(K)]
            with self._section("host_tree"):
                new_models = [tree_to_host(a, self.train_set, xs.lrs[j])
                              for a in arrays]
            if self._keep_iteration(new_models, trees, xs.its[j]):
                stopped = True
                break
            routes.append([_route(a) for a in arrays])
        with self._section("score"):
            for j, r in enumerate(routes):
                self._valid_update(stacked[j], xs.its[j], r)
        self.iter = it0 + len(routes)
        return stopped

    # ------------------------------------------------------------------- eval

    def eval_train(self) -> List[Tuple[str, str, float, bool]]:
        return self._eval("training", self.train_score, self.train_metrics)

    def eval_valid(self) -> List[Tuple[str, str, float, bool]]:
        out = []
        for i, name in enumerate(self.valid_names):
            out.extend(self._eval(name, self.valid_scores[i],
                                  self.valid_metrics[i]))
        return out

    def _eval(self, dataname, score, metrics):
        with global_timer.section("GBDT::EvalMetrics"), \
                _span("gbdt.eval", dataset=dataname):
            return self._eval_inner(dataname, score, metrics)

    def _eval_inner(self, dataname, score, metrics):
        s = score.cpu().numpy()
        if self.num_tree_per_iteration == 1:
            s = s[0]
        out = []
        for m in metrics:
            for (mname, val, hib) in m.eval(s, self.objective):
                out.append((dataname, mname, val, hib))
        return out

    def num_trees(self) -> int:
        return len(self.models)

    def current_iteration(self) -> int:
        return self.iter
