"""The group program of the model axis (counterpart of
``lightgbm_tpu/multi/batch.py``).

The JAX package runs a group as ``jit(vmap(chunk_fn))``: the solo chunk
body over a leading lane axis, one program.  Here a group's chunk is
its lanes' solo chunks advanced together.  Each lane's chunk is the
generator ``boosting.macro.dispatch_steps``: the solo code, which stops
wherever a tree's rounds are due, with the tree begun.  The group
advances every live lane to that point, in lane order (its gradients,
masks, quantized values, the tree's one host read of its fixed-point
scales, the root), runs all their trees' rounds as one
``grower_rounds.RoundGroup`` (one replay of one captured CUDA graph a
round while every lane's tree still grows, each lane's round body in
turn), then resumes every lane (its leaf values, score update, next
class or iteration).  Each lane's ``_finish_chunk`` then does its host
bookkeeping, as solo training does.  So a lane runs its solo kernels on
its own tensors in its own order, and its model text is its solo text
byte for byte; ``tests/test_torch_multi.py`` holds that in every mode.

- **No rebind at trace.**  The JAX package points the objective's
  per-dataset arrays at lane-stacked tracers during its one trace.
  Nothing is traced here: each lane's own objective computes its own
  gradients from its own labels.
- **Stacked mode** (cv folds, per-segment families): each lane reads
  its own binned tensor (``Dataset.subset``) at its own row count; the
  group graph captures bodies of different shapes, so nothing is
  padded to one shape.  ``stacked`` stays in the plan, where the
  matrices are charged once a lane.
- **Dead lanes** (early stopping, a per-lane round budget) are not
  advanced at all: they draw from no RNG stream and their boosters'
  state is left as it is.  The group graph holds the lanes it was
  captured with, so a change of the live set captures it again, once,
  after one eager round (15-43 ms a capture at 1 M rows, PERF.md; a
  lane dies at most once, so a run captures at most once a lane).
  Keeping dead lanes in the graph would cost no capture, but each dead
  lane would launch its B4/B5 pass every round for nothing.
- **Data-parallel lanes** (``tree_learner="data"`` under a process
  group): the round bodies run eagerly, in lane order, so every rank
  runs the lanes' collectives in the same order.
"""

from __future__ import annotations

from typing import List, Sequence

from ..boosting.macro import chunk_host_inputs, dispatch_steps
from ..grower_rounds import RoundGroup
from ..obs.metrics import global_registry as _obs_registry
from ..obs.trace import span as _span
from ..utils.timer import global_timer
from .group import MultiGroup


class BatchedChunkProgram:
    """One group's program: ``dispatch(c, live, lr_lists)`` advances
    every live lane ``c`` iterations together and runs each live
    booster's ``_finish_chunk``, the host bookkeeping solo training
    runs (model extraction, valid-score updates, stop detection).
    ``rounds`` is the group's ``RoundGroup`` (its graph and counts)."""

    def __init__(self, group: MultiGroup):
        self.group = group
        self.stacked = group.stacked
        self.rounds = RoundGroup()

    def dispatch(self, c: int, live: List[bool],
                 lr_lists: Sequence) -> List[bool]:
        """Advance the live lanes ``c`` iterations; returns each lane's
        ``stopped`` flag (True = no more splittable leaves, the solo
        ``run_chunk`` contract; dead lanes report False)."""
        bs = self.group.boosters
        idx = [i for i in range(len(bs)) if live[i]]
        if not idx:
            raise RuntimeError("batched chunk dispatched with no live lane")
        it0s, xs, steps = {}, {}, {}
        for i in idx:
            b = bs[i]
            b.boost_from_average()
            it0s[i] = b.iter
            xs[i] = chunk_host_inputs(b, c, lr_lists[i])
            steps[i] = dispatch_steps(b, c, xs[i])
        _obs_registry.counter("multi_chunk_dispatches").inc()
        _obs_registry.histogram(
            "multi_batch_lanes",
            buckets=(1.0, 2.0, 4.0, 8.0, 16.0, 32.0)).observe(len(bs))
        with global_timer.section("TreeLearner::Train(dispatch)"), \
                _span("multi.dispatch", lanes=len(bs), c=c, live=len(idx)):
            stacked = self._advance(steps)
        stopped = [False] * len(bs)
        for i in idx:
            stopped[i] = bs[i]._finish_chunk(stacked[i], xs[i], it0s[i])
        return stopped

    def _advance(self, steps: dict) -> dict:
        """Drive the lanes' step generators together: each time they
        stand at a tree's rounds, run those rounds as one group; returns
        each lane's chunk (its iterations' device trees)."""
        out, pending = {}, {}
        for i, gen in steps.items():
            try:
                pending[i] = next(gen)
            except StopIteration as e:
                out[i] = e.value
        while pending:
            order = sorted(pending)
            ran = self.rounds.run([pending[i] for i in order])
            nxt = {}
            for i, r in zip(order, ran):
                try:
                    nxt[i] = steps[i].send(r)
                except StopIteration as e:
                    out[i] = e.value
            pending = nxt
        return out
