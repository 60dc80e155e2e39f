"""In-process serving facade: sync submit, deadlines, backpressure,
graceful drain (counterpart of ``lightgbm_tpu/serving/server.py``).

``Server`` is the one class users touch (``Booster.serve()`` /
``lightgbm_tpu_torch.serve()`` construct it).  A request is validated and
cut into <= top-bucket work items at submit time; the micro-batch
scheduler (batcher.py) coalesces items from ALL submitters into padded
bucket-shaped batches; the program registry (registry.py) maps each
(model, bucket) pair to its predict program.  Results are scattered back
into a per-request float64 buffer and the request's future resolves when
its last item lands.

Correctness contract: with ``raw_score=True`` (default) the values a
future resolves to are bit-identical to ``Booster.predict(raw_score=True,
device=False)`` — ``StackedForest.predict_raw`` plus the average_output
division — unconditionally on the "host" backend, and for
float32-precision feature values on the "device" backend (see
DeviceForest.predict_raw_padded).  Overload is surfaced as typed errors
at submit (QueueFull) or completion (DeadlineExceeded), never as
unbounded queueing latency.
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import Future, InvalidStateError
from concurrent.futures import TimeoutError as FuturesTimeoutError
from dataclasses import dataclass
from typing import Optional

import numpy as np

from ..obs.metrics import MetricsRegistry
from .batcher import Batch, BucketLadder, MicroBatcher, WorkItem
from .errors import QueueFull, ServerClosed, ServingError
from .registry import ModelRegistry, ProgramRegistry


@dataclass
class ServingConfig:
    """Knobs for Server; every field has a serving-sane default."""

    min_bucket_rows: int = 8          # smallest padded batch shape
    max_batch_rows: int = 1024        # top bucket; larger requests split
    batch_window_ms: float = 2.0      # max extra latency spent coalescing
    max_queue_rows: int = 1 << 16     # backpressure: reject beyond this
    default_deadline_ms: Optional[float] = None   # None = no deadline
    backend: str = "device"           # "device" (the Booster's) | "host"
    raw_score: bool = True            # False: predict()-style transform
    num_iteration: Optional[int] = None
    start_iteration: int = 0

    def __post_init__(self):
        if self.backend not in ("device", "host"):
            raise ValueError(f"unknown serving backend {self.backend!r}")


class _Request:
    """Submit-side accounting for one predict call: result buffer, item
    countdown, future, deadline, and the model the request was admitted
    against."""

    __slots__ = ("n", "out", "future", "submitter", "deadline", "model",
                 "t_submit", "_remaining", "_lock", "_settled")

    def __init__(self, n: int, num_class: int, n_items: int,
                 deadline: Optional[float], model):
        self.n = n
        self.model = model
        self.out = np.zeros((num_class, n), np.float64)
        self.future: Future = Future()
        self.submitter = threading.get_ident()
        self.deadline = deadline
        self.t_submit = time.monotonic()
        self._remaining = n_items
        self._lock = threading.Lock()
        self._settled = False    # a future may settle exactly once

    def is_settled(self) -> bool:
        """True once the future has an outcome — including caller-side
        cancellation: the scheduler drops settled items at pop time
        instead of spending device work on results nobody will read."""
        with self._lock:
            if not self._settled and self.future.cancelled():
                self._settled = True
            return self._settled

    def fail_item(self, exc: Exception) -> bool:
        """Fail the whole request; True iff THIS call settled it (so a
        split request rejected item-by-item counts once, not n times)."""
        with self._lock:
            if self._settled:
                return False
            self._settled = True
        try:
            self.future.set_exception(exc)
            return True
        except InvalidStateError:       # cancelled under our feet
            return False

    def complete_item(self, server: "Server", offset: int,
                      raw_part: np.ndarray) -> None:
        """Install one item's [K, n_item] raw slice; resolve when last."""
        self.out[:, offset:offset + raw_part.shape[1]] = raw_part
        with self._lock:
            if self._settled:
                return
            self._remaining -= 1
            done = self._remaining == 0
            if done:
                self._settled = True
        if done:
            server._finalize(self)


class Server:
    """Micro-batched, shape-bucketed forest inference."""

    def __init__(self, booster, config: Optional[ServingConfig] = None,
                 **overrides):
        if config is None:
            config = ServingConfig(**overrides)
        elif overrides:
            raise ValueError("pass either config or keyword overrides")
        self.config = config
        self.metrics = MetricsRegistry()
        self.ladder = BucketLadder(config.min_bucket_rows,
                                   config.max_batch_rows)
        self.programs = ProgramRegistry(self.metrics)
        self.models = ModelRegistry(
            booster, self.metrics, backend=config.backend,
            num_iteration=config.num_iteration,
            start_iteration=config.start_iteration)
        self._batcher = MicroBatcher(
            self.ladder, self._run_batch, self.metrics,
            batch_window_ms=config.batch_window_ms,
            max_queue_rows=config.max_queue_rows)
        self._closed = False

    # --------------------------------------------------------------- submit

    def submit(self, X, deadline_ms: Optional[float] = None) -> Future:
        """Enqueue a predict request; returns a concurrent.futures.Future
        resolving to raw scores [n] (num_class == 1) or [n, K].

        Raises QueueFull / ServerClosed synchronously; resolves the
        future with DeadlineExceeded if the request's deadline (argument,
        else config.default_deadline_ms) expires before execution."""
        if self._closed:
            self.metrics.counter("requests_rejected_closed").inc()
            raise ServerClosed("server is shut down")
        # ALWAYS copy: work items hold row views until the pad-copy runs,
        # so a caller refilling a preallocated buffer must not corrupt
        # queued rows
        X = np.array(X, np.float64, order="C")
        if X.ndim == 1:
            X = X[None, :]
        if X.ndim != 2:
            raise ServingError(f"expected 2-D input, got shape {X.shape}")
        model = self.models.active
        if X.shape[1] != model.num_features:
            raise ServingError(
                f"request has {X.shape[1]} features, model expects "
                f"{model.num_features}")
        n = X.shape[0]
        if n > self.config.max_queue_rows:
            # no amount of caller backoff can ever admit this request
            raise ServingError(
                f"request of {n} rows exceeds max_queue_rows="
                f"{self.config.max_queue_rows}; raise max_queue_rows or "
                "chunk the request")
        K = model.num_class
        if deadline_ms is None:
            deadline_ms = self.config.default_deadline_ms
        deadline = (time.monotonic() + deadline_ms / 1e3
                    if deadline_ms is not None else None)
        top = self.ladder.max_rows
        n_items = max((n + top - 1) // top, 1)
        req = _Request(n, K, n_items, deadline, model)
        if n == 0:
            req.future.set_result(self._shape_result(req.out, K))
            return req.future
        self.metrics.counter("requests_total").inc()
        self.metrics.counter("rows_total").inc(n)
        items = [WorkItem(req, X[i * top:(i + 1) * top], i * top)
                 for i in range(n_items)]
        try:
            # all-or-nothing: a rejected request leaves nothing queued
            self._batcher.submit_items(items)
        except (QueueFull, ServerClosed) as e:
            if isinstance(e, QueueFull):
                self.metrics.counter("requests_rejected_queue_full").inc()
            else:
                self.metrics.counter("requests_rejected_closed").inc()
            req.fail_item(e)
            raise
        return req.future

    def predict(self, X, deadline_ms: Optional[float] = None,
                timeout: Optional[float] = None) -> np.ndarray:
        """Synchronous submit + wait.  On wait timeout the request is
        cancelled so its queued items stop holding backpressure budget."""
        fut = self.submit(X, deadline_ms=deadline_ms)
        try:
            return fut.result(timeout)
        except FuturesTimeoutError:
            fut.cancel()
            raise

    # ------------------------------------------------------------ execution

    def _run_batch(self, batch: Batch) -> None:
        model = self.models.active
        prog = self.programs.get(model, batch.bucket)
        t0 = time.perf_counter()
        raw = prog(batch.padded_input())       # [K, bucket] f64
        self.metrics.histogram("batch_latency_ms").observe(
            (time.perf_counter() - t0) * 1e3)
        pos = 0
        for it in batch.items:
            it.request.complete_item(self, it.offset, raw[:, pos:pos + it.n])
            pos += it.n

    @staticmethod
    def _shape_result(raw: np.ndarray, K: int) -> np.ndarray:
        return raw[0] if K == 1 else raw.T

    def _finalize(self, req: _Request) -> None:
        K = req.out.shape[0]
        # average_output scaling applies to raw scores too, exactly as
        # Booster.predict(raw_score=True) does (identity except for rf)
        raw = req.model.scale_raw(req.out)
        if not self.config.raw_score:
            raw = req.model.transform_raw(raw)
        try:
            req.future.set_result(self._shape_result(raw, K))
        except InvalidStateError:       # cancelled mid-flight: the caller
            self.metrics.counter("requests_cancelled").inc()
            return                      # saw a timeout, not a completion
        self.metrics.counter("requests_completed").inc()
        self.metrics.histogram("request_latency_ms").observe(
            (time.monotonic() - req.t_submit) * 1e3)

    def warm(self, buckets=None) -> int:
        """Run the active model's program once for ``buckets`` (an
        iterable of row counts, mapped through the ladder) or the whole
        ladder, so the first real requests pay no kernel build or first
        launch.  Returns the number of buckets warmed."""
        model = self.models.active
        rows = {self.ladder.bucket_for(min(b, self.ladder.max_rows))
                for b in (buckets if buckets is not None
                          else self.ladder.buckets)}
        return self.programs.warm(model, rows)

    # ------------------------------------------------------------- lifecycle

    def close(self, drain: bool = True,
              timeout: Optional[float] = None) -> None:
        """Stop accepting requests; ``drain=True`` completes everything
        already queued, ``drain=False`` fails it with ServerClosed."""
        if self._closed:
            return
        self._closed = True
        self._batcher.close(drain=drain, timeout=timeout)

    def __enter__(self) -> "Server":
        return self

    def __exit__(self, *exc) -> None:
        self.close(drain=True)

    # ------------------------------------------------------------- metrics

    def metrics_dict(self) -> dict:
        return self.metrics.to_dict()

    def metrics_json(self, path: Optional[str] = None) -> str:
        return self.metrics.dump_json(path)
