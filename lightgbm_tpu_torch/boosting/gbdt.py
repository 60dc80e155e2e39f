"""GBDT training loop on one device (counterpart of the single-device part
of ``lightgbm_tpu/boosting/gbdt.py``).

reference: src/boosting/gbdt.cpp — GBDT::Init (:42), TrainOneIter (:338),
Bagging (:163), BoostFromAverage (:302), UpdateScore (:459).  One
iteration: gradients from the objective (torch, on the device) ->
bagging mask -> one tree by the batched-frontier grower (its fused arm,
or its staged arm for a dataset with EFB bundles or a staged
``tpu_hist_method``) -> shrinkage -> train and valid score updates -> the
host tree.  Bagging and column sampling draw from NumPy ``RandomState``
streams seeded as the JAX package seeds them, so both packages sample
the same rows and features.

Quantized-gradient training (``use_quantized_grad``): each iteration
quantizes the gradients with the bagging mask as weights
(``ops.histogram.quantize_gradients``) and grows the tree from the int8
levels.  Stochastic rounding draws from the JAX package's threefry key
chain, reproduced bit for bit by ``utils/threefry.py``: the base key
``PRNGKey((extra_trees_seed * 2654435761 ^ feature_fraction_seed) %
2**31)``, the iteration's key ``fold_in(base, iter)``, and the
quantization key ``fold_in(fold_in(key, 0x51475442), k)`` of class k.
The same iteration key drives per-node randomness (``extra_trees``,
``feature_fraction_bynode``): the grower's key is ``fold_in(key, k)``.
Monotone constraints are given per original feature and aligned with
the used features (a feature dropped at binning drops its constraint).

The configurations the slice does not cover raise ``NotImplementedError``
naming the ROADMAP item that brings them; none is trained another way.
"""

from __future__ import annotations

import contextlib
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..config import Config
from ..dataset import Dataset
from ..grower import GrowerConfig, predict_leaf_index_binned
from ..grower_rounds import grow_tree_rounds
from ..objectives import ObjectiveFunction
from ..ops.histogram import HIST_METHODS, quantize_gradients
from ..ops.split import MAX_CAT_WORDS
from ..tree import HostTree, tree_to_host
from ..utils import threefry
from ..utils.log import log_info, log_warning

K_EPSILON = 1e-15


def check_supported(config: Config) -> None:
    """Raise ``NotImplementedError`` for every configuration outside the
    port so far (single-device gbdt, f32 or quantized gradients, numeric,
    bundled and categorical features)."""
    c = config

    def no(what: str, item: str) -> None:
        raise NotImplementedError(
            f"{what} is not ported to lightgbm_tpu_torch yet; it waits for "
            f"ROADMAP queue A ({item})")

    if c.boosting not in ("gbdt", "gbrt"):
        no(f"boosting={c.boosting}", "GOSS, DART and RF")
    multiclass = c.num_class > 1 or c.objective in ("multiclass",
                                                    "multiclassova")
    if multiclass and c.use_quantized_grad:
        no("quantized multiclass (per-class scales)", "multiclass")
    if multiclass:
        no("multiclass", "multiclass")
    if (c.cegb_penalty_split > 0.0 or c.cegb_penalty_feature_lazy
            or c.cegb_penalty_feature_coupled):
        no("CEGB", "CEGB and forced splits")
    if c.forcedsplits_filename:
        no("forced splits", "CEGB and forced splits")
    tl = str(c.tree_learner).lower()
    if tl not in ("serial", "serial_tree_learner") or c.num_machines > 1:
        no(f"tree_learner={c.tree_learner}", "sharded training")
    if c.tpu_tree_growth not in ("auto", "rounds"):
        no(f"tpu_tree_growth={c.tpu_tree_growth}", "the serial grower")
    if c.tpu_hist_method not in HIST_METHODS:
        raise ValueError(f"unknown tpu_hist_method {c.tpu_hist_method!r}; "
                         f"expected one of {', '.join(HIST_METHODS)}")


class GBDT:
    """reference: class GBDT (src/boosting/gbdt.h)."""

    boosting_type = "gbdt"
    # quantized-gradient training applies (the JAX package's DART clears
    # it: its reweighting would compound round-local quantization scales)
    _quant_ok = True

    def __init__(self, config: Config, train_set: Dataset,
                 objective: Optional[ObjectiveFunction]):
        check_supported(config)
        if objective is None:
            raise NotImplementedError(
                "custom objectives wait for ROADMAP queue A (objectives)")
        self.config = config
        self.train_set = train_set.construct()
        self.device = self.train_set.device
        self.objective = objective
        self.num_class = config.num_class
        self.num_tree_per_iteration = 1
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
        if config.tpu_hist_method == "fused" and self.meta.has_bundles:
            log_warning("tpu_hist_method=fused does not apply to a dataset "
                        "with EFB bundles; training on the staged arm")
        self.num_data = self.train_set.num_data
        self.num_bins = int(self.meta.max_num_bin)
        self.binned_t = self.train_set.binned_t
        self.meta_t = self.meta.tensors(self.device)
        objective.init(self.train_set.metadata, self.num_data, self.device)
        n = self.num_data
        self.train_score = torch.zeros((1, n), dtype=torch.float32,
                                       device=self.device)
        self.init_scores = [0.0]
        self._init_score_added = False
        isc = self.train_set.metadata.init_score
        if isc is not None:
            self.train_score += torch.as_tensor(
                np.asarray(isc, np.float32).reshape(1, n), device=self.device)
            self._init_score_added = True
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
        # the JAX package's f32 fallback (boosting/gbdt.py:642-666), as it
        # is there; check_supported has already refused every blocker on
        # it that the port does not train (CEGB and the boostings other
        # than gbdt)
        cegb_enabled = bool(config.cegb_penalty_split > 0.0
                            or config.cegb_penalty_feature_coupled
                            or config.cegb_penalty_feature_lazy)
        quant_on = bool(config.use_quantized_grad)
        if quant_on:
            blockers = []
            if not type(self)._quant_ok:
                blockers.append(f"boosting={self.boosting_type}")
            if cegb_enabled:
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
        # the last iteration's (g_scale, h_scale), 0-dim f32 tensors
        self._quant_scales = None
        # per-node randomness base key; advanced by iteration
        self._node_key_base = threefry.prng_key(
            (config.extra_trees_seed * 2654435761
             ^ config.feature_fraction_seed) % (2 ** 31))
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
        self.grower_cfg = GrowerConfig(
            num_leaves=config.num_leaves, max_depth=config.max_depth,
            hp=config.split_hyperparams(), num_bins=self.num_bins,
            round_width=config.tpu_round_width,
            hist_method=config.tpu_hist_method, quant=quant_on,
            quant_bins=config.num_grad_quant_bins,
            quant_renew=config.quant_train_renew_leaf,
            bynode_feature_cnt=bynode_cnt)
        # a utils.timer.SectionTimer here splits each iteration's time
        # into sections; None keeps the run free of synchronisation
        self.timer = None

    def _section(self, name: str):
        if self.timer is None:
            return contextlib.nullcontext()
        return self.timer.section(name)

    # ------------------------------------------------------------------ setup

    def add_valid(self, valid_set: Dataset, name: str) -> None:
        valid_set.construct()
        if valid_set.device != self.device:
            raise ValueError(f"valid set on {valid_set.device}, training on "
                             f"{self.device}")
        self.valid_sets.append(valid_set)
        self.valid_names.append(name)
        nv = valid_set.num_data
        vs = torch.zeros((1, nv), dtype=torch.float32, device=self.device)
        isc = valid_set.metadata.init_score
        if isc is not None:
            vs += torch.as_tensor(np.asarray(isc, np.float32).reshape(1, nv),
                                  device=self.device)
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
        col_sampler.hpp:19), [1, F]."""
        F = len(self.train_set.used_features)
        frac = self.config.feature_fraction
        if frac >= 1.0:
            if self._ones_fmask is None:
                self._ones_fmask = torch.ones((1, F), dtype=torch.float32,
                                              device=self.device)
            return self._ones_fmask
        cnt = max(1, int(round(F * frac)))
        masks = np.zeros((1, F), np.float32)
        masks[0, self._feature_rng.choice(F, size=cnt, replace=False)] = 1.0
        return torch.as_tensor(masks, device=self.device)

    def boost_from_average(self) -> None:
        """reference: GBDT::BoostFromAverage (gbdt.cpp:313)."""
        if self.iter > 0 or self._init_score_added:
            return
        if not self.config.boost_from_average:
            return
        self._init_score_added = True
        s = self.objective.boost_from_score(0)
        if abs(s) > K_EPSILON:
            self.init_scores[0] = s
            self.train_score[0] += float(np.float32(s))
            for vs in self.valid_scores:
                vs[0] += float(np.float32(s))
            log_info(f"Start training from score {s:.6f}")

    def train_one_iter(self) -> bool:
        """One boosting iteration; True when training should stop (no
        splittable leaf).  reference: GBDT::TrainOneIter."""
        self.boost_from_average()
        with self._section("objective"):
            grad, hess = self.objective.get_gradients(self.train_score[0])
            mask = self._bagging_mask(self.iter)
            fmask = self._feature_masks()
        quant_vals = None
        rng = self._node_key()
        if self._quant_on:
            with self._section("quantize"):
                qkey = threefry.fold_in(threefry.fold_in(rng, 0x51475442), 0)
                quant_vals = quantize_gradients(
                    grad, hess, mask, self.config.num_grad_quant_bins, qkey,
                    stochastic=self.config.stochastic_rounding)
                self._quant_scales = quant_vals[2:]
        tree, leaf_id = grow_tree_rounds(
            self.binned_t, grad, hess, mask, self.meta, self.grower_cfg,
            feature_mask=fmask[0], meta_t=self.meta_t, timer=self.timer,
            quant_vals=quant_vals, monotone_constraints=self._monotone,
            rng_key=threefry.fold_in(rng, 0))
        with self._section("score"):
            lr = float(np.float32(self.shrinkage_rate))
            tree = tree._replace(leaf_value=tree.leaf_value * lr,
                                 internal_value=tree.internal_value * lr)
            self.train_score[0] += tree.leaf_value[leaf_id]
        return self._finish_iter(tree)

    def _node_key(self):
        """This iteration's key: ``fold_in(base, iter)``."""
        return threefry.fold_in(self._node_key_base, self.iter)

    def _finish_iter(self, tree) -> bool:
        """Host tree, first-iteration bias, valid-score updates; True
        when training should stop."""
        with self._section("host_tree"):
            ht = tree_to_host(tree, self.train_set, self.shrinkage_rate)
        if ht.num_leaves <= 1:
            log_warning("Stopped training because there are no more leaves "
                        "that meet the split requirements")
            if self.iter == 0 and not self.models:
                ht.leaf_value[:1] = self.init_scores[0]
                self.models.append(ht)
            return True
        if self.iter == 0 and abs(self.init_scores[0]) > K_EPSILON:
            ht.add_bias(self.init_scores[0])
        self.models.append(ht)
        with self._section("score"):
            for i, vs in enumerate(self.valid_sets):
                leaf = predict_leaf_index_binned(tree, vs.binned_t,
                                                 self.meta_t)
                self.valid_scores[i][0] += tree.leaf_value[leaf]
        self.iter += 1
        return False

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
        s = score.cpu().numpy()[0]
        out = []
        for m in metrics:
            for (mname, val, hib) in m.eval(s, self.objective):
                out.append((dataname, mname, val, hib))
        return out

    def num_trees(self) -> int:
        return len(self.models)

    def current_iteration(self) -> int:
        return self.iter
