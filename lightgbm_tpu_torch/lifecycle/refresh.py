"""Continual-training candidates: warm-start boosting from the deployed
model over FRESH rows, binned on the deployed model's frozen bin grid
(counterpart of ``lightgbm_tpu/lifecycle/refresh.py``).

The continued-training seam (``train(init_model=...)``, engine.py)
puts the deployed model's trees under the new booster and starts
boosting from its predictions; this module supplies the data half:

* ``fresh_dataset`` bins new rows with the DEPLOYED training set's bin
  mappers (``Dataset(reference=...)``), so the candidate's histograms
  live on the bin grid the deployed model was grown on;
* chunked loads go through the port's streaming constructor
  (``Dataset.from_reference_streaming`` + ``push_rows``), and the
  deployed model's raw scores over each chunk are taken at push time
  (``_init_model_raw_scores``), so the warm start needs no raw rows;
* ``train_candidate`` runs the warm start; ``refresh_many`` warm-starts
  a whole family through ``multi.train_many``; ``save_candidate``
  writes the sha256-manifested bundle (``resilience.checkpoint``, the
  port's ``lgbt-ckpt-torch/1``; a JAX package bundle is refused there)
  that the rollout promotes.
"""

from __future__ import annotations

from typing import Iterable, Optional, Tuple

import numpy as np


def booster_digest(booster) -> str:
    """Content digest of a booster's whole forest: the identity the
    rollout journal records and the rollback's bit-parity check compares
    (``serving.registry.forest_digest`` over every trained iteration)."""
    from ..serving.registry import forest_digest
    K = max(booster.num_tree_per_iteration, 1)
    n_iter = len(booster.models) // K
    return forest_digest(booster._forest(0, n_iter))


def fresh_dataset(reference, X=None, label=None,
                  chunks: Optional[Iterable[Tuple]] = None,
                  num_rows: Optional[int] = None,
                  predictor=None, params: Optional[dict] = None):
    """A training Dataset of fresh rows on ``reference``'s frozen bin
    grid, on its device.

    Resident: ``fresh_dataset(ref, X, y)`` keeps the raw rows
    (``free_raw_data=False``) for ``train(init_model=...)``'s init
    scores.  Streamed: ``chunks`` is an iterable of ``(X_chunk,
    y_chunk)`` pairs of ``num_rows`` rows in all; each chunk is binned
    and released, and with ``predictor`` (the deployed booster) its raw
    scores over each chunk are kept as ``_init_model_raw_scores``, which
    ``engine._apply_init_model`` takes in place of a prediction over raw
    rows the streamed Dataset never kept."""
    from ..dataset import Dataset
    if chunks is None:
        if X is None:
            raise ValueError("fresh_dataset needs X (resident) or "
                             "chunks (streamed)")
        return Dataset(X, label=label, reference=reference,
                       params=dict(params or {}), free_raw_data=False,
                       device=reference.device)
    if num_rows is None:
        raise ValueError("streamed fresh_dataset needs num_rows")
    ds = Dataset.from_reference_streaming(reference, num_rows,
                                          params=dict(params or {}))
    labels = []
    scores = [] if predictor is not None else None
    for xc, yc in chunks:
        xc = np.asarray(xc)
        ds.push_rows(xc)
        labels.append(np.asarray(yc, np.float32).reshape(-1))
        if scores is not None:
            # the scores engine._raw_scores takes over resident rows
            scores.append(np.asarray(
                predictor.predict(xc, raw_score=True, num_iteration=-1),
                np.float64))
    if not ds.constructed:
        raise ValueError(
            f"streamed fresh_dataset: chunks covered "
            f"{sum(len(y) for y in labels)}/{num_rows} rows")
    ds.set_label(np.concatenate(labels))
    if scores is not None:
        ds._init_model_raw_scores = np.concatenate(
            [s.reshape(len(s), -1) for s in scores], axis=0)
    return ds


def train_candidate(deployed, train_set, params: dict,
                    num_boost_round: int, **train_kw):
    """Warm-start ``num_boost_round`` fresh rounds from the DEPLOYED
    model over ``train_set`` (``train(init_model=...)``: the deployed
    trees come first and boosting resumes from their predictions).  The
    init model's fit to the train set is checked first
    (``engine.InitModelCompatibilityError``)."""
    from ..engine import train
    return train(dict(params), train_set, num_boost_round,
                 init_model=deployed, verbose_eval=False, **train_kw)


def refresh_many(deployed, train_sets, params_list, num_boost_round: int,
                 **train_kw):
    """Warm-start a whole per-segment model family in one run, through
    ``multi.train_many`` in stacked mode: one Dataset a segment (each
    on its deployed model's bin grid, ``fresh_dataset``), one deployed
    booster a segment as ``init_models``.  Compatible segments train as
    the lanes of one group program, each candidate byte-identical to
    its solo ``train_candidate``.  Returns the candidates in segment
    order."""
    from ..multi import train_many
    deployed = list(deployed)
    if len(deployed) != len(params_list):
        raise ValueError(
            f"refresh_many: {len(deployed)} deployed models for "
            f"{len(params_list)} configs")
    return train_many(list(params_list), list(train_sets), num_boost_round,
                      init_models=deployed, **train_kw)


def save_candidate(booster, manager) -> str:
    """Write the candidate's checkpoint bundle (atomic, sha256 manifest)
    through ``manager`` (``resilience.CheckpointManager``); returns the
    bundle path the rollout verifies and promotes."""
    return manager.save(booster, iteration=booster.current_iteration())
