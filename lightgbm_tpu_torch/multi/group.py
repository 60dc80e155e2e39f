"""Structural grouping: which boosters train as lanes of one group
program (counterpart of ``lightgbm_tpu/multi/group.py``).

The JAX package traces one chunk body for a whole group under
``jax.vmap``, so everything the trace bakes in must be equal across its
lanes.  The port's group program is a CUDA graph of each lane's own
round body in turn (``multi.batch``), which could hold lanes of any
shapes; it groups lanes exactly as the JAX package does all the same,
so that a sweep or a family splits into the same groups on either
package and a group's lanes share what the key says they share (one
binned matrix in shared mode, one round width, one chunk schedule).
Two boosters land in one group only when every ``Config`` field but
the runtime-varying ones, the grower's configuration, and the
objective's scalars match.  An over-split key costs batching (smaller
groups), never bits: each lane's bits are its solo bits either way.

Two data modes, as in the JAX package:

* ``shared``: every booster trains on the SAME ``Dataset`` (a sweep);
  its lanes read one binned [G, n] tensor;
* ``stacked``: one ``Dataset`` a booster (cv folds from
  ``Dataset.subset``, per-segment families).  The JAX package stacks the
  lanes' matrices into one padded array; here each lane reads its own
  tensor at its own shape, so nothing is padded.  The key still holds
  the matrix's shape, as the JAX package's does, so folds of different
  row counts form different groups there and here.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

# Config fields that may differ between the lanes of one group: runtime
# inputs of a lane (its masks, learning rates, liveness) and host-side
# scheduling and evaluation (the JAX package's list)
RUNTIME_VARYING_FIELDS = frozenset({
    "learning_rate",
    "bagging_fraction",
    "bagging_freq",
    "bagging_seed",
    "feature_fraction",
    "feature_fraction_seed",
    "num_iterations",
    "early_stopping_round",
    "first_metric_only",
    "metric",
    "metric_freq",
    "is_provide_training_metric",
    "verbosity",
    "seed",
    "snapshot_freq",
})


class MultiGroup:
    """One structurally compatible set of boosters (``GBDT`` objects)
    that one group program trains; ``stacked`` marks the data mode."""

    def __init__(self, key: Optional[tuple], boosters: List,
                 stacked: bool):
        self.key = key
        self.boosters = boosters
        self.stacked = stacked

    def __len__(self) -> int:
        return len(self.boosters)


def objective_array_attrs(obj) -> List[str]:
    """Names of the objective's per-dataset arrays (labels, binary's
    ``label_sign``, multiclass one-hots), sorted.  The JAX package swaps
    them for lane-stacked arguments in its one trace; here each lane's
    own objective computes its gradients, so they only enter the
    structural key."""
    if obj is None:
        return []
    return sorted(k for k, v in vars(obj).items()
                  if isinstance(v, (torch.Tensor, np.ndarray)))


def _objective_fingerprint(obj) -> tuple:
    """The objective's class, public scalars and array names (private
    attributes are host-side caches)."""
    if obj is None:
        return ("none",)
    scalars = tuple(sorted(
        (k, v) for k, v in vars(obj).items()
        if not k.startswith("_") and isinstance(v, (bool, int, float, str))))
    return (type(obj).__name__, scalars, tuple(objective_array_attrs(obj)),
            obj.weight is None if hasattr(obj, "weight") else True)


def _config_fingerprint(cfg) -> tuple:
    """Every Config field but ``RUNTIME_VARYING_FIELDS``, hashable
    (``repr`` normalises list values)."""
    return tuple(sorted(
        (k, repr(v)) for k, v in vars(cfg).items()
        if k not in RUNTIME_VARYING_FIELDS))


def structural_key(b, stacked: bool) -> Optional[tuple]:
    """The group key of ``GBDT`` ``b``, or None when it cannot join a
    group (it then trains solo): no chunk support (DART, a custom
    objective), a grower whose trees do not run in rounds (the serial
    grower of CEGB, forced splits and the feature- and voting-parallel
    learners), a streamed booster, and, stacked, RF (the JAX package's
    chunk bakes RF's data-derived init column into its trace)."""
    if not b.chunk_supported():
        return None
    if not getattr(b.grower, "lane_steps", False):
        return None
    if stacked and b.boosting_type == "rf":
        return None
    if b.binned_t is None:
        return None
    data_key = (("stacked",) + tuple(b.binned_t.shape)
                + (str(b.binned_t.dtype),)
                if stacked else ("shared", id(b.train_set), id(b.binned_t)))
    mesh_key = (id(b.group) if b.group is not None else None,
                b.tree_learner_type)
    return (data_key, mesh_key, str(b.device),
            b.boosting_type, b.num_tree_per_iteration, b.num_data,
            b.grower_cfg,
            _config_fingerprint(b.config),
            _objective_fingerprint(b.objective),
            b.train_set.metadata.init_score is not None,
            bool(getattr(b, "_quant_on", False)))


def group_boosters(bs: Sequence, stacked: bool) -> List[MultiGroup]:
    """Partition GBDTs into groups, in first-seen order (so the driver
    trains lanes in a fixed order).  A booster of key None is a group
    of one with ``key=None``: the driver trains it solo."""
    groups: dict = {}
    out: List[MultiGroup] = []
    for b in bs:
        key = structural_key(b, stacked)
        if key is None:
            out.append(MultiGroup(None, [b], stacked))
            continue
        g = groups.get(key)
        if g is None:
            g = groups[key] = MultiGroup(key, [], stacked)
            out.append(g)
        g.boosters.append(b)
    return out
