"""DART: dropouts meet multiple additive regression trees (counterpart of
``lightgbm_tpu/boosting/dart.py``).

reference: src/boosting/dart.hpp — DroppingTrees (:97), Normalize (:158),
TrainOneIter (:58).  Each iteration drops a random subset of the trees
trained so far (probability ``drop_rate``, at most ``max_drop``; no drop
at all with probability ``skip_drop``; with ``uniform_drop`` off the
pick is weighted by each tree's weight), takes the gradients of the
scores without them, and trains the new tree with shrinkage lr / (1 + k)
(``xgboost_dart_mode``: lr / (lr + k)), k the number dropped.  Then each
dropped tree is scaled to k / (k + 1) (xgboost mode: k / (lr + k)) of
its weight, and the train and valid scores follow.

The drops draw from ``RandomState(drop_seed)`` in the JAX package's
order.  A dropped tree's train and valid outputs come from its device
tree (``tree_history``, the grower's ``TreeArrays``, routed by
``predict_leaf_index_binned``) times the scale it has taken, in f32, and
each score update is the JAX package's: minus the output before the
gradients, plus ``w`` times it after (or plus it back when the iteration
stops).  Quantized gradients fall back to f32 (``_quant_ok``), as there.
"""

from __future__ import annotations

from typing import List

import numpy as np

from ..ops.split import f32
from .gbdt import GBDT


class DART(GBDT):
    boosting_type = "dart"
    _quant_ok = False
    # drops and rescales need the host every iteration
    _macro_ok = False
    # drops re-evaluate saved trees over the resident binned matrix
    _stream_ok = False

    def __init__(self, config, train_set, objective):
        super().__init__(config, train_set, objective)
        self._drop_rng = np.random.RandomState(config.drop_seed)
        self.tree_weight: List[float] = []
        self.sum_weight = 0.0
        # the iterations each call dropped (the device trees and their
        # scales are GBDT's tree_history and history_scale)
        self.drops: List[List[int]] = []

    def _dropping_trees(self) -> List[int]:
        """The iterations to drop; sets the new tree's shrinkage
        (reference: dart.hpp:97-151)."""
        c = self.config
        drop: List[int] = []
        if self._drop_rng.rand() >= c.skip_drop:
            drop_rate = c.drop_rate
            # this run's iterations only (reference: dart.hpp drops
            # num_init_iteration_ + i)
            n_own = min(self.iter,
                        len(self.models) // self.num_tree_per_iteration) \
                - self.num_init_iteration
            if not c.uniform_drop and self.sum_weight > 0:
                n_own = min(n_own, len(self.tree_weight))
                inv_avg = len(self.tree_weight) / self.sum_weight
                if c.max_drop > 0:
                    drop_rate = min(drop_rate,
                                    c.max_drop * inv_avg / self.sum_weight)
                for i in range(n_own):
                    if (self._drop_rng.rand()
                            < drop_rate * self.tree_weight[i] * inv_avg):
                        drop.append(i)
                        if c.max_drop > 0 and len(drop) >= c.max_drop:
                            break
            else:
                if c.max_drop > 0 and n_own > 0:
                    drop_rate = min(drop_rate, c.max_drop / n_own)
                for i in range(n_own):
                    if self._drop_rng.rand() < drop_rate:
                        drop.append(i)
                        if c.max_drop > 0 and len(drop) >= c.max_drop:
                            break
        k = len(drop)
        if not c.xgboost_dart_mode:
            self.shrinkage_rate = c.learning_rate / (1.0 + k)
        else:
            self.shrinkage_rate = (c.learning_rate if k == 0 else
                                   c.learning_rate / (c.learning_rate + k))
        return drop

    def train_one_iter(self, grad=None, hess=None) -> bool:
        c = self.config
        K = self.num_tree_per_iteration
        drop = self._dropping_trees()
        self.drops.append(drop)
        k = len(drop)
        # the dropped trees leave the train score before the gradients
        # (reference: GetTrainingScore -> DroppingTrees, dart.hpp:131-137)
        drop_preds = {}
        off = self.num_init_iteration    # drop i -> model (off + i) * K + kk
        for i in drop:
            for kk in range(K):
                p = self._tree_pred((off + i) * K + kk, self.train_set)
                drop_preds[(i, kk)] = p
                self.train_score[kk] -= p
        if super().train_one_iter(grad, hess):
            for (i, kk), p in drop_preds.items():
                self.train_score[kk] += p
            return True
        # Normalize (dart.hpp:158-199): each dropped tree to w of its
        # contribution
        if k > 0:
            w = (k / (k + 1.0) if not c.xgboost_dart_mode
                 else k / (k + c.learning_rate))
            for (i, kk), p in drop_preds.items():
                mi = (off + i) * K + kk
                self.train_score[kk] += f32(w) * p
                for vi, vs in enumerate(self.valid_sets):
                    self.valid_scores[vi][kk] += (f32(-(1.0 - w))
                                                  * self._tree_pred(mi, vs))
                self.models[mi].scale(w)
                self.history_scale[mi] = self.history_scale.get(mi, 1.0) * w
            if not c.uniform_drop:
                denom = (k + 1.0 if not c.xgboost_dart_mode
                         else k + c.learning_rate)
                for i in drop:
                    self.sum_weight -= self.tree_weight[i] / denom
                    self.tree_weight[i] *= w
        if not c.uniform_drop:
            self.tree_weight.append(self.shrinkage_rate)
            self.sum_weight += self.shrinkage_rate
        return False
