"""Chunked iterations (counterpart of ``lightgbm_tpu/boosting/macro.py``).

The JAX package runs ``c`` boosting iterations as one device program (a
``fori_loop`` over its ``iter_body``), so the host dispatches once a
chunk.  Here a chunk is ``c`` iterations queued on the card with no host
read between them beyond the two the trainer keeps: each tree's
fixed-point scales (``ops.histogram.fixed_point_scales``, before its
rounds; none in quantized training) and the round loop's lagged stop
flag (``grower_rounds.STOP_LAG``).  Everything else an iteration needs
is on the card or drawn on the host before the chunk:

- the gradients are taken from the carried train score;
- the bagging masks, per-tree feature masks, per-iteration node keys,
  learning rates, iteration indices and GOSS subkeys are drawn on the
  host in the exact per-iteration order (``chunk_host_inputs``);
- GOSS masks come from the in-chunk gradients and those subkeys;
- RF's running mean rides on the iteration index (``score * it`` before
  the tree, ``(score + init) / (it + 1)`` after);
- the serial grower's cross-tree CEGB state (``SerialGrower.
  cegb_state``) carries from iteration to iteration in order, as the
  JAX chunk's ``fori_loop`` carries it, and an iteration after a stop
  leaves it as it was (``alive``), so a chunk that stops mid-way leaves
  the state of per-iteration training.

The c x K device trees are kept; the host builds the trees once, at the
chunk's end, from one transfer a field (``GBDT._finish_chunk``), and
detects a stop there: an iteration whose trees all failed to split
truncates the chunk exactly as per-iteration training stops (its score
update stands, as it does there; a device flag keeps every later
iteration of the chunk from touching the scores).  The valid scores of
the kept iterations are routed through each tree at a trip count of its
own depth, read from that transfer, so nothing waits on the card.

Per-iteration training of a supported booster runs as a chunk of one
(``GBDT.train_one_iter``), as the JAX package's ``_chunk_single`` does,
so a model does not depend on how its iterations were chunked.  DART and
a custom objective need the host every iteration: ``chunk_supported`` is
False for them, and the engine falls back to c = 1 there.

The chunk size cap is ``chunk_cap()``: ``DEFAULT_CHUNK_CAP``, or the
JAX package's knob ``LGBM_TPU_CHUNK`` where it is set ("0"/"off"
disables chunking, a positive integer sets the cap); the engine picks
``pow2_chunk`` of the distance to its next boundary.  A caller's
``Booster.update_chunk(c)`` takes ``c`` whatever the knob says.

Each chunk counts ``train_chunk_dispatches`` and observes its size in
the ``train_chunk_size`` histogram of the process registry, and runs
inside the ``TreeLearner::Train(dispatch)`` timer section and a
``macro.dispatch`` span, as the JAX package's chunk does; the host side
of the chunk is ``GBDT._finish_chunk``'s ``macro.host_fetch``.  A
streamed booster's iteration is a ``stream.iteration`` span and a
``gbdt.finish_iter``, the JAX package's per-iteration streamed step.
None of them reads the card.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence

import torch

from ..grower_rounds import run_alone
from ..obs.metrics import global_registry as _obs_registry
from ..obs.trace import span as _span
from ..utils import envflags, threefry
from ..utils.timer import global_timer

DEFAULT_CHUNK_CAP = 32


def chunk_cap() -> int:
    """The engine's chunk size cap: ``LGBM_TPU_CHUNK`` where set ("0",
    "off", "false", "no": 0, chunking off; a positive integer: that cap;
    "", "on", "auto" or another word: the default), else
    ``DEFAULT_CHUNK_CAP``."""
    env = envflags.get("LGBM_TPU_CHUNK").strip().lower()
    if env in ("0", "off", "false", "no"):
        return 0
    if env in ("", "on", "true", "auto", "default"):
        return DEFAULT_CHUNK_CAP
    try:
        return max(0, int(env))
    except ValueError:
        return DEFAULT_CHUNK_CAP


def pow2_chunk(distance: int, cap: int) -> int:
    """Largest power of two <= min(distance, cap) (at least 1)."""
    d = min(distance, cap)
    if d < 1:
        return 1
    c = 1
    while c * 2 <= d:
        c *= 2
    return c


class ChunkInputs(NamedTuple):
    """The host-drawn inputs of a chunk, one entry per iteration."""

    masks: List[torch.Tensor]     # [n] f32 bagging weights
    fmasks: List[torch.Tensor]    # [K, F] f32 per-tree feature masks
    keys: List[tuple]             # node keys fold_in(base, it)
    lrs: List[float]              # learning rates (RF: 1.0)
    its: List[int]                # iteration indices
    goss: List[Optional[tuple]]   # GOSS subkey, or None (no sampling)


def chunk_host_inputs(b, c: int, lrs: Optional[Sequence[float]] = None
                      ) -> ChunkInputs:
    """Draw booster ``b``'s per-iteration host inputs for ``c``
    iterations from ``b.iter``, in the exact per-iteration order: the
    bagging mask, the feature masks and the node key of each iteration,
    then the GOSS subkeys.  ``lrs``: a learning-rate schedule (one value
    an iteration), else the booster's shrinkage rate."""
    it0 = b.iter
    masks, fmasks, keys = [], [], []
    for j in range(c):
        masks.append(b._bagging_mask(it0 + j))
        fmasks.append(b._feature_masks())
        keys.append(threefry.fold_in(b._node_key_base, it0 + j))
    if b.boosting_type == "rf":
        lr_list = [1.0] * c
    elif lrs is not None:
        lr_list = [float(v) for v in lrs]
        if len(lr_list) != c:
            raise ValueError(f"got {len(lr_list)} learning rates for a "
                             f"chunk of {c} iterations")
    else:
        lr_list = [float(b.shrinkage_rate)] * c
    its = list(range(it0, it0 + c))
    return ChunkInputs(masks, fmasks, keys, lr_list, its,
                       b._chunk_goss_keys(its, lr_list))


def run_chunk(b, c: int, lrs: Optional[Sequence[float]] = None) -> bool:
    """Train ``c`` iterations of booster ``b`` (``lrs``: one learning
    rate an iteration, else its shrinkage rate).  Returns True when
    training stopped (an iteration with no split), the chunk truncated
    there."""
    if c < 1:
        raise ValueError(f"chunk size must be >= 1, got {c}")
    if not b._chunk_ok():
        raise RuntimeError(
            f"boosting={b.boosting_type!r} with this configuration needs "
            "per-iteration host logic; train it with train_one_iter (the "
            "engine falls back to c=1)")
    b.boost_from_average()
    it0 = b.iter
    xs = chunk_host_inputs(b, c, lrs)
    streamed = b._stream is not None
    if not streamed:
        _obs_registry.counter("train_chunk_dispatches").inc()
        _obs_registry.histogram(
            "train_chunk_size",
            buckets=(1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0)).observe(c)
    with global_timer.section("TreeLearner::Train(dispatch)"), \
            (_span("stream.iteration", iteration=it0) if streamed
             else _span("macro.dispatch", c=c, it0=it0)):
        stacked = _dispatch(b, c, xs)
    return b._finish_chunk(stacked, xs, it0)


def _dispatch(b, c: int, xs: ChunkInputs) -> list:
    """Queue the chunk's ``c`` iterations on the device; returns each
    iteration's K device trees (the train score carried in ``b``)."""
    return run_alone(dispatch_steps(b, c, xs))


def dispatch_steps(b, c: int, xs: ChunkInputs):
    """``_dispatch`` as a generator of lane steps: it yields each rounds
    grower whose tree it has begun and takes back the rounds run
    (``GBDT._grow_tree``).  Alone, each tree runs its own rounds
    (``grower_rounds.run_alone``); the model axis
    (``multi.batch.BatchedChunkProgram``) advances several boosters'
    generators together and runs their trees' rounds as one group
    (``grower_rounds.RoundGroup``), iteration by iteration and class by
    class, so that each booster's gradients, masks, trees and score
    updates are its own, in its own order."""
    score = b.train_score
    # False once an earlier iteration of the chunk grew no split
    alive = torch.ones((), dtype=torch.bool, device=b.device)
    stacked = []
    state = getattr(b.grower, "cegb_state", None)
    for j in range(c):
        with b._section("objective"):
            g, h = b._chunk_gradients(score)
            mask = b._chunk_mask(g, h, xs.masks[j], xs.goss[j])
        before = ([t.clone() for t in state if t is not None]
                  if state is not None and j else None)
        trees, score = yield from b._chunk_steps(score, g, h, mask, xs, j,
                                                 alive)
        if before is not None:
            for t, old in zip((t for t in state if t is not None), before):
                t.copy_(torch.where(alive, t, old))
        stacked.append(trees)
        alive = alive & torch.stack([t.num_leaves > 1 for t in trees]).any()
    b.train_score = score
    return stacked
