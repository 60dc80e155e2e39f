"""GOSS: gradient-based one-side sampling (counterpart of
``lightgbm_tpu/boosting/goss.py``).

reference: src/boosting/goss.hpp:24-132 — keep the ``top_rate`` share of
rows with the largest |grad * hess|, sample ``other_rate`` of the rest
and amplify their weight by (1 - top_rate) / other_rate; no sampling in
the first 1 / learning_rate iterations (goss.hpp:126-131).

As in the JAX package the sample is a weight mask (1, the amplified
weight, or 0) made on the device from the iteration's gradients: the
threshold is the ``max(1, int(top_rate * n))``-th largest of the rows'
``sum_k |g * h|`` (f32), and a row outside the top keeps when
``uniform(sub, (n,)) < other_rate / (1 - top_rate)``, ``sub`` split off
the key stream ``PRNGKey(bagging_seed)`` once a sampled iteration.  The
JAX package draws at ``n`` rows on the CPU and at its shape bucket's
padded rows on a TPU; the port draws at ``n`` (ROADMAP queue C).  The
histograms carry the weights in every channel, the count channel too;
quantized training counts the rows of weight above 0.
"""

from __future__ import annotations

import torch

from ..ops.split import f32
from ..utils import threefry
from .gbdt import GBDT


def goss_mask(grad: torch.Tensor, hess: torch.Tensor, key, top_rate: float,
              other_rate: float) -> torch.Tensor:
    """The GOSS weights [n] f32 of gradients [K, n] under ``key``."""
    n = grad.shape[1]
    score = (grad * hess).abs().sum(dim=0)
    top_k = max(1, int(top_rate * n))
    thresh = torch.topk(score, top_k).values[-1]
    rest_p = f32(other_rate / max(1e-12, 1.0 - top_rate))
    keep_rest = threefry.uniform(key, (n,), device=grad.device) < rest_p
    amp = torch.tensor(f32((1.0 - top_rate) / max(other_rate, 1e-12)),
                       device=grad.device)
    one = torch.ones((), dtype=torch.float32, device=grad.device)
    zero = torch.zeros_like(one)
    return torch.where(score >= thresh, one,
                       torch.where(keep_rest, amp, zero))


class GOSS(GBDT):
    boosting_type = "goss"

    def __init__(self, config, train_set, objective):
        super().__init__(config, train_set, objective)
        if config.bagging_freq > 0 and config.bagging_fraction < 1.0:
            raise ValueError("cannot use bagging in GOSS")
        if config.top_rate + config.other_rate > 1.0:
            raise ValueError("top_rate + other_rate cannot be larger than "
                             "1.0")
        self._goss_key = threefry.prng_key(config.bagging_seed)
        # sampled iterations so far, and the kept rows' share of each
        self.sampled_iters = 0
        self.kept_share: list = []

    def _bagging_mask(self, it):
        return self._row_valid

    def _chunk_goss_keys(self, its, lrs) -> list:
        """The subkeys of a chunk's iterations, split off the stream in
        iteration order; None for an iteration of the warm-up (the first
        1 / learning_rate iterations, at that iteration's rate), which
        leaves the stream as it is."""
        keys = []
        for it, lr in zip(its, lrs):
            if it >= 1.0 / max(lr, 1e-12):
                self._goss_key, sub = threefry.split(self._goss_key)
                keys.append(sub)
            else:
                keys.append(None)
        return keys

    def _chunk_mask(self, grad, hess, mask, goss_key):
        # a custom objective's gradients train unsampled, as in the JAX
        # package (they never reach a chunk)
        if goss_key is None:
            return mask
        m = goss_mask(grad, hess, goss_key, self.config.top_rate,
                      self.config.other_rate)
        self.sampled_iters += 1
        self.kept_share.append(m.count_nonzero() / m.numel())
        return m
