"""Random forest mode (counterpart of ``lightgbm_tpu/boosting/rf.py``).

reference: src/boosting/rf.hpp — bagging is required, there is no
shrinkage, the gradients are taken once from the constant
boost-from-average scores (rf.hpp:77-98), every tree carries its class's
init score as a bias (AddBias, rf.hpp:137), and the train and valid
scores are the running mean of the trees' outputs (rf.hpp:140-142);
predictions average over iterations (``average_output`` in the model
text).  The percentile objectives renew each leaf against the constant
init score (rf.hpp:130-135).  The running mean is the JAX package's f32
``(score * it + tree + init) / (it + 1)``, dividing by a device scalar
(ROADMAP queue C-5).
"""

from __future__ import annotations

import torch

from ..utils.log import log_warning
from .gbdt import GBDT, K_EPSILON


class RF(GBDT):
    boosting_type = "rf"
    # trains resident, as in the JAX package (its running-mean renorm
    # rides the resident iteration program)
    _stream_ok = False

    def __init__(self, config, train_set, objective):
        if not (config.bagging_freq > 0
                and 0.0 < config.bagging_fraction < 1.0):
            raise ValueError("random forest requires bagging "
                             "(bagging_freq > 0 and bagging_fraction < 1)")
        if objective is None:
            raise ValueError("RF mode does not support custom objective "
                             "functions, please use built-in objectives")
        super().__init__(config, train_set, objective)
        self.shrinkage_rate = 1.0
        K = self.num_tree_per_iteration
        # constant per-class init scores, carried by each tree as a bias
        # and never added to the scores themselves
        if config.boost_from_average:
            self.init_scores = [objective.boost_from_score(k)
                                for k in range(K)]
        self._init_score_added = True
        self._init_col = torch.tensor(self.init_scores, dtype=torch.float32,
                                      device=self.device)[:, None]
        self._grad, self._hess = self._gradients(
            self._init_col.expand(K, self.num_data).contiguous())

    def reset_training_data(self, train_set, raw_scores=None) -> None:
        """Train on ``train_set`` from now on: its scores are the running
        mean of every tree so far over its rows, replayed in the f32
        order training takes (``_chunk_steps``), and its gradients are
        taken once more from the constant init scores (rf.hpp:77-98)."""
        if self.num_init_iteration:
            raise ValueError(
                "the running mean of a continued random forest needs each "
                "init iteration's scores of the new rows; train the new "
                "rows from the saved model with init_model instead")
        super().reset_training_data(train_set, raw_scores)
        K, n = self.num_tree_per_iteration, self.num_data
        score = torch.zeros((K, n), dtype=torch.float32, device=self.device)
        if train_set.metadata.init_score is not None:
            score += self._init_score_rows(train_set.metadata.init_score, n)
        for it, trees in enumerate(self.tree_history):
            s = score * it
            for k, t in enumerate(trees):
                s[k] += self._tree_output(t, train_set)
            div = torch.tensor(it + 1, dtype=torch.float32,
                               device=self.device)
            score = (s + self._init_col) / div
        self.train_score = score
        self._grad, self._hess = self._gradients(
            self._init_col.expand(K, n).contiguous())

    def _renew_residual(self, score, k):
        return self._renew_label - self._init_col[k, 0]

    def train_one_iter(self, grad=None, hess=None) -> bool:
        if grad is not None:
            raise ValueError("RF mode does not support custom objectives")
        return super().train_one_iter()

    def _chunk_gradients(self, score):
        return self._grad, self._hess

    def _chunk_steps(self, score, grad, hess, mask, xs, j, alive):
        # grow on it * mean (so "+ tree" keeps the sum), then back to the
        # running mean with the tree's bias
        it = xs.its[j]
        s = score * it
        trees = yield from self._grow_steps(s, grad, hess, mask, 1.0,
                                            xs.fmasks[j], xs.keys[j])
        div = torch.tensor(it + 1, dtype=torch.float32, device=self.device)
        return trees, torch.where(alive, (s + self._init_col) / div, score)

    def _keep_iteration(self, new_models, trees, it) -> bool:
        self.iter = it
        for k, ht in enumerate(new_models):
            if abs(self.init_scores[k]) > K_EPSILON:
                ht.add_bias(self.init_scores[k])
        if not any(ht.num_leaves > 1 for ht in new_models):
            log_warning("Stopped training because there are no more leaves "
                        "that meet the split requirements")
            return True
        self.models.extend(new_models)
        self.tree_history.append(trees)
        return False

    def _valid_update(self, trees, it, routes=None) -> None:
        div = torch.tensor(it + 1, dtype=torch.float32, device=self.device)
        for i, vs in enumerate(self.valid_sets):
            v = self.valid_scores[i] * it
            for k, t in enumerate(trees):
                v[k] += self._tree_output(t, vs,
                                          *(routes[k] if routes else ()))
            self.valid_scores[i] = (v + self._init_col) / div
