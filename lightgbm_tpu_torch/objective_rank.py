"""Ranking objectives: LambdaRank-NDCG and RankXENDCG (counterpart of
``lightgbm_tpu/objective_rank.py``).

reference: src/objective/rank_objective.hpp — RankingObjective (:48),
LambdarankNDCG (:98), RankXENDCG (:288).  As in the JAX package, queries
are grouped into buckets by padded size (the next power of two, at least
8), each bucket a dense [nq, Q] block of row indices (``n`` pads); the
pairwise [Q, Q] lambdas run over chunks of queries whose [chunk, Q, Q]
intermediates stay under ``_PAIR_BUDGET`` elements, and each row's
gradient lands back in the flat [n] vector.  Plain PyTorch on the
scores' device, in f32; the sums over a query's pairs run in torch's
order, not XLA's (ROADMAP queue C).
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from .config import Config
from .objectives import ObjectiveFunction
from .ops.split import f32
from .utils import threefry

K_EPSILON = 1e-15
_MIN_BUCKET = 8
_PAIR_BUDGET = 1 << 22   # elements of one [chunk, Q, Q] intermediate


def query_sums(a: torch.Tensor) -> torch.Tensor:
    """[c, Q, Q] -> [c], each query's sum in one serial pass.  On the
    CPU torch splits a reduction with a single output across its threads,
    so the sum of a lone query's pairs would depend on the thread count
    (ROADMAP C-19); two outputs (the second a stride-0 view of the first)
    keep one pass an output, which is the one-thread order."""
    flat = a.reshape(a.shape[0], -1)
    if flat.shape[0] == 1:
        return flat.expand(2, -1).sum(dim=1)[:1]
    return flat.sum(dim=1)


def _bucket_queries(qb: np.ndarray) -> Dict[int, np.ndarray]:
    """Query ids by padded size {Q: ids}, buckets in the order their
    first query appears."""
    buckets: Dict[int, List[int]] = {}
    for q, s in enumerate(np.diff(qb)):
        Q = _MIN_BUCKET
        while Q < s:
            Q *= 2
        buckets.setdefault(Q, []).append(q)
    return {Q: np.asarray(v, np.int64) for Q, v in buckets.items()}


class RankingObjective(ObjectiveFunction):
    need_group = True

    def init(self, metadata, num_data, device=None):
        super().init(metadata, num_data, device)
        if metadata.query_boundaries is None:
            raise RuntimeError("Ranking tasks require query information")
        self.qb = np.asarray(metadata.query_boundaries, np.int64)
        self.num_queries = len(self.qb) - 1
        lbl = np.asarray(metadata.label, np.float64)
        self.buckets = _bucket_queries(self.qb)
        # per bucket: row indices [nq, Q] (n = padding), labels [nq, Q]
        self.bucket_data = {}
        n = num_data
        for Q, qids in self.buckets.items():
            idx = np.full((len(qids), Q), n, np.int64)
            for r, q in enumerate(qids):
                lo, hi = self.qb[q], self.qb[q + 1]
                idx[r, :hi - lo] = np.arange(lo, hi)
            labels = np.where(idx < n, lbl[np.minimum(idx, n - 1)], -1.0)
            self.bucket_data[Q] = (
                torch.as_tensor(idx, device=self.device),
                self._tensor(labels), qids)

    def get_gradients(self, score):
        n = self.num_data
        grad = torch.zeros(n + 1, dtype=torch.float32, device=score.device)
        hess = torch.zeros_like(grad)
        score_pad = torch.cat([score, score.new_zeros(1)])
        for Q, (idx, labels, qids) in self.bucket_data.items():
            valid = idx < n
            g, h = self._query_gradients(Q, score_pad[idx], labels, valid,
                                         qids)
            # each row sits in one bucket slot: the adds land on zeros
            grad.index_add_(0, idx.reshape(-1), g.reshape(-1))
            hess.index_add_(0, idx.reshape(-1), h.reshape(-1))
        grad, hess = grad[:n], hess[:n]
        if self.weight is not None:
            grad = grad * self.weight
            hess = hess * self.weight
        return grad, hess

    def _query_gradients(self, Q, s, labels, valid, qids):
        raise NotImplementedError


class LambdarankNDCG(RankingObjective):
    """reference: LambdarankNDCG (rank_objective.hpp:98)."""

    name = "lambdarank"

    def __init__(self, config: Config):
        super().__init__(config)
        self.sigmoid = config.sigmoid
        self.norm = config.lambdarank_norm
        self.truncation_level = config.lambdarank_truncation_level
        lg = list(config.label_gain)
        if not lg:
            lg = [float((1 << i) - 1) for i in range(31)]
        self.label_gain_np = np.asarray(lg, np.float64)

    def init(self, metadata, num_data, device=None):
        super().init(metadata, num_data, device)
        lbl = np.asarray(metadata.label, np.int64)
        if lbl.min() < 0 or lbl.max() >= len(self.label_gain_np):
            raise ValueError("ranking label out of range of label_gain")
        # inverse max DCG at the truncation level, per query
        # (reference: rank_objective.hpp:124-132)
        inv = np.zeros(self.num_queries, np.float64)
        for q in range(self.num_queries):
            ls = np.sort(lbl[self.qb[q]:self.qb[q + 1]])[::-1][
                :self.truncation_level]
            dcg = (self.label_gain_np[ls]
                   / np.log2(np.arange(len(ls)) + 2.0)).sum()
            inv[q] = 1.0 / dcg if dcg > 0 else 0.0
        self.inverse_max_dcgs = inv
        self.label_gain_t = self._tensor(self.label_gain_np)

    def _chunk(self, s, lbl, gain, valid, inv):
        """Lambdas and hessians of a chunk of queries [c, Q]."""
        sig = self.sigmoid
        smask = torch.where(valid, s, -float("inf"))
        order = torch.argsort(-smask, dim=1, stable=True)
        rank = torch.argsort(order, dim=1, stable=True)
        disc = 1.0 / torch.log2(rank.to(torch.float32) + 2.0)
        best = smask.amax(dim=1)
        worst = torch.where(valid, s, float("inf")).amin(dim=1)
        # pair (i = high, j = low): label_i > label_j
        pair_valid = ((lbl[:, :, None] > lbl[:, None, :])
                      & valid[:, :, None] & valid[:, None, :])
        dcg_gap = gain[:, :, None] - gain[:, None, :]
        paired_disc = (disc[:, :, None] - disc[:, None, :]).abs()
        delta = dcg_gap * paired_disc * inv[:, None, None]
        ds = s[:, :, None] - s[:, None, :]
        if self.norm:
            has_range = (best != worst)[:, None, None]
            delta = torch.where(has_range, delta / (0.01 + ds.abs()), delta)
        p = 1.0 / (1.0 + torch.exp(f32(sig) * ds))
        zero = torch.zeros((), dtype=torch.float32, device=s.device)
        p_lambda = torch.where(pair_valid, f32(-sig) * delta * p, zero)
        p_hess = torch.where(pair_valid,
                             f32(sig * sig) * delta * p * (1.0 - p), zero)
        lam = p_lambda.sum(dim=2) - p_lambda.sum(dim=1)   # high minus low
        hes = p_hess.sum(dim=2) + p_hess.sum(dim=1)
        if self.norm:
            sum_lambdas = -2.0 * query_sums(p_lambda)
            factor = torch.where(
                sum_lambdas > 0,
                torch.log2(1.0 + sum_lambdas)
                / sum_lambdas.clamp_min(f32(K_EPSILON)),
                torch.ones_like(sum_lambdas))
            lam = lam * factor[:, None]
            hes = hes * factor[:, None]
        return lam, hes

    def _query_gradients(self, Q, s, labels, valid, qids):
        inv = torch.as_tensor(self.inverse_max_dcgs[qids].astype(np.float32),
                              device=s.device)
        gain = self.label_gain_t[labels.clamp_min(0.0).to(torch.int64)]
        gain = torch.where(valid, gain, torch.zeros_like(gain))
        chunk = max(1, _PAIR_BUDGET // (Q * Q))
        lams, hess = [], []
        for c0 in range(0, s.shape[0], chunk):
            sl = slice(c0, c0 + chunk)
            lam, hes = self._chunk(s[sl], labels[sl], gain[sl], valid[sl],
                                   inv[sl])
            lams.append(lam)
            hess.append(hes)
        return torch.cat(lams), torch.cat(hess)


class RankXENDCG(RankingObjective):
    """reference: RankXENDCG (rank_objective.hpp:288, arXiv 1911.09798).
    A bucket's gammas are ``uniform(fold_in(sub, Q), [nq, Q])`` with
    ``sub`` the second half of ``split(PRNGKey(objective_seed))``.  The
    JAX package means to split a fresh ``sub`` off its key at every call
    (the reference's per-query ``rands_[q].NextFloat()``), but it splits
    while its iteration program is traced, so the one ``sub`` of the
    trace is compiled in and every iteration draws the same gammas; the
    port draws as that program does (ROADMAP queue C)."""

    name = "rank_xendcg"

    def __init__(self, config: Config):
        super().__init__(config)
        _, self._cur_key = threefry.split(
            threefry.prng_key(config.objective_seed))

    def _query_gradients(self, Q, s, labels, valid, qids):
        eps = f32(K_EPSILON)
        zero = torch.zeros((), dtype=torch.float32, device=s.device)
        gammas = threefry.uniform(threefry.fold_in(self._cur_key, Q),
                                  s.shape, device=s.device)
        rho = torch.where(valid, torch.softmax(torch.where(
            valid, s, -float("inf")), dim=1), zero)
        phi = torch.where(valid, torch.exp2(labels.clamp_min(0.0)) - gammas,
                          zero)
        sum_labels = phi.sum(dim=1, keepdim=True).clamp_min(eps)
        l1 = torch.where(valid, -phi / sum_labels + rho, zero)
        sum_l1 = l1.sum(dim=1, keepdim=True)
        denom = (1.0 - rho).clamp_min(eps)
        l2 = torch.where(valid, (sum_l1 - l1) / denom, zero)
        sum_l2 = l2.sum(dim=1, keepdim=True)
        l3 = torch.where(valid, (sum_l2 - l2) / denom, zero)
        cnt = valid.sum(dim=1, keepdim=True)
        lam = torch.where(cnt <= 1, l1, l1 + rho * l2 + rho * rho * l3)
        hes = rho * (1.0 - rho)
        return torch.where(valid, lam, zero), torch.where(valid, hes, zero)


