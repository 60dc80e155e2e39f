"""Micro-batch scheduler: coalesce concurrent predict requests into
padded, bucket-shaped device batches (counterpart of
``lightgbm_tpu/serving/batcher.py``).

Concurrent requests are concatenated into one batch and padded up to a
small ladder of power-of-two row buckets, so one kernel launch serves
many callers.

Scheduling policy (one daemon thread):

* pop the oldest queued item, then keep popping for at most
  ``batch_window_ms`` or until adding the next item would overflow the
  largest bucket — latency is bounded by the window, throughput by the
  bucket ladder;
* an item that would overflow is carried (never reordered past) into the
  next batch, so the queue stays FIFO;
* items whose deadline expired while queued are rejected at pop time
  (reject-with-error beats unbounded latency under overload);
* requests larger than the top bucket are split by the server into
  top-bucket-sized work items that share one result buffer.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Callable, List, Optional

import numpy as np

from ..obs.flight import global_flight as _flight
from ..obs.metrics import RATIO_BUCKETS
from ..obs.trace import span as _span
from ..obs.watchdog import beat as _beat
from .errors import DeadlineExceeded, QueueFull, ServerClosed


class BucketLadder:
    """Power-of-two row buckets in [min_rows, max_rows].

    ``bucket_for(n)`` returns the smallest bucket >= n; n must not exceed
    ``max_rows`` (the server splits oversized requests first).
    """

    def __init__(self, min_rows: int = 8, max_rows: int = 1024):
        if min_rows < 1 or max_rows < min_rows:
            raise ValueError("need 1 <= min_rows <= max_rows")

        def pow2(v):
            p = 1
            while p < v:
                p <<= 1
            return p

        self.min_rows = pow2(min_rows)
        self.max_rows = pow2(max_rows)
        self.buckets: List[int] = []
        b = self.min_rows
        while b < self.max_rows:
            self.buckets.append(b)
            b <<= 1
        self.buckets.append(self.max_rows)

    def bucket_for(self, n: int) -> int:
        if n > self.max_rows:
            raise ValueError(f"{n} rows exceed top bucket {self.max_rows}")
        for b in self.buckets:
            if n <= b:
                return b
        return self.max_rows


class WorkItem:
    """One schedulable unit: a (<= top bucket)-row slice of a request.

    ``request`` owns the result buffer and completion accounting; the
    item only knows which rows it covers.
    """

    __slots__ = ("request", "X", "offset", "enqueued_at")

    def __init__(self, request, X: np.ndarray, offset: int):
        self.request = request
        self.X = X                      # [n_item, F] float64 view
        self.offset = offset            # row offset inside the request
        self.enqueued_at = time.monotonic()

    @property
    def n(self) -> int:
        return self.X.shape[0]


class Batch:
    """Items coalesced for one program invocation."""

    __slots__ = ("items", "rows", "bucket")

    def __init__(self, items: List[WorkItem], bucket: int):
        self.items = items
        self.rows = sum(it.n for it in items)
        self.bucket = bucket

    def padded_input(self) -> np.ndarray:
        X0 = self.items[0].X
        out = np.zeros((self.bucket, X0.shape[1]), np.float64)
        pos = 0
        for it in self.items:
            out[pos:pos + it.n] = it.X
            pos += it.n
        return out


class MicroBatcher:
    """FIFO queue + scheduler thread turning items into Batches.

    ``run_batch(batch)`` is the execution callback (the Server binds it to
    the program registry); it must scatter results / exceptions onto the
    items' requests itself.  The scheduler thread beats ``beat_name``
    (``obs.watchdog``) every turn, idle turns included, runs each batch
    in a ``serving.dispatch`` span and notes it in the flight ring
    (``serving.batch``).
    """

    def __init__(self, ladder: BucketLadder, run_batch: Callable,
                 metrics, batch_window_ms: float = 2.0,
                 max_queue_rows: int = 1 << 16,
                 beat_name: str = "serving.batcher"):
        self.ladder = ladder
        self.beat_name = beat_name
        self.run_batch = run_batch
        self.metrics = metrics
        self.batch_window_s = max(batch_window_ms, 0.0) / 1e3
        self.max_queue_rows = max_queue_rows
        self._q = collections.deque()           # guarded-by: _lock
        self._carry: Optional[WorkItem] = None  # guarded-by: _lock
        self._queued_rows = 0                   # guarded-by: _lock
        self._lock = threading.Lock()
        self._work_ready = threading.Condition(self._lock)
        self._closed = False
        self._thread = threading.Thread(target=self._loop,
                                        name="lgbt-torch-serving-batcher",
                                        daemon=True)
        self._thread.start()

    def _set_depth_gauges(self) -> None:
        """Sync both depth gauges to the truth (lock held).  The carried
        item is queued-but-not-in-_q, so it counts in both."""
        self.metrics.gauge("queue_depth_rows").set(self._queued_rows)
        self.metrics.gauge("queue_depth_items").set(
            len(self._q) + (1 if self._carry is not None else 0))

    def queued_rows(self) -> int:
        """Rows occupying the queue, the carried item included: the
        fleet's weighted-admission input (``fleet/registry.py``).  A
        plain int read, atomic under the GIL, lock-free on the submit
        path."""
        return self._queued_rows

    # ------------------------------------------------------------- enqueue

    def submit_items(self, items: List[WorkItem]) -> None:
        """Atomically enqueue every work item of ONE request — all or
        nothing, so a split request can never be half-admitted.  Raises
        ServerClosed / QueueFull upward through the server (which owns
        reject accounting)."""
        total = sum(it.n for it in items)
        with self._lock:
            if self._closed:
                raise ServerClosed("server is shut down")
            if self._queued_rows + total > self.max_queue_rows:
                raise QueueFull(
                    f"queue depth {self._queued_rows} rows + {total} would "
                    f"exceed max_queue_rows={self.max_queue_rows}")
            self._q.extend(items)
            self._queued_rows += total
            self._set_depth_gauges()
            self._work_ready.notify()

    # ----------------------------------------------------------- scheduler

    def _pop(self, timeout: Optional[float]) -> Optional[WorkItem]:
        """Next item (carry first), or None on timeout / drain-complete."""
        with self._lock:
            if self._carry is not None:
                it, self._carry = self._carry, None
                self._queued_rows -= it.n
                self._set_depth_gauges()
                return it
            if not self._q:
                if self._closed:
                    return None
                self._work_ready.wait(timeout)
                if not self._q:
                    return None
            it = self._q.popleft()
            self._queued_rows -= it.n
            self._set_depth_gauges()
            return it

    def _unpop(self, item: WorkItem) -> None:
        with self._lock:            # close(drain=False) also reads _carry
            self._carry = item
            # the carry still occupies the queue for backpressure
            self._queued_rows += item.n
            self._set_depth_gauges()

    @staticmethod
    def _expired(item: WorkItem, now: float) -> bool:
        dl = item.request.deadline
        return dl is not None and now > dl

    def _loop(self) -> None:
        while True:
            # the liveness heartbeat every scheduler turn (an idle turn
            # wakes at the pop timeout): a dead batcher thread goes stale
            # within ~0.1 s, whatever the queue holds
            _beat(self.beat_name)
            item = self._pop(timeout=0.1)
            if item is None:
                with self._lock:
                    if self._closed and not self._q and self._carry is None:
                        return
                continue
            now = time.monotonic()
            if item.request.is_settled():
                # cancelled by the caller, or sibling item of a request
                # already failed: results would be discarded
                self.metrics.counter("items_dropped_settled").inc()
                continue
            if self._expired(item, now):
                if item.request.fail_item(DeadlineExceeded(
                        "deadline expired after "
                        f"{(now - item.enqueued_at) * 1e3:.1f} ms in queue")):
                    self.metrics.counter("requests_rejected_deadline").inc()
                continue
            items = [item]
            rows = item.n
            window_end = now + self.batch_window_s
            while rows < self.ladder.max_rows:
                remaining = window_end - time.monotonic()
                nxt = self._pop(timeout=max(remaining, 0.0))
                if nxt is None:
                    if remaining <= 0:
                        break
                    continue
                if nxt.request.is_settled():
                    self.metrics.counter("items_dropped_settled").inc()
                    continue
                if self._expired(nxt, time.monotonic()):
                    if nxt.request.fail_item(DeadlineExceeded(
                            "deadline expired in queue")):
                        self.metrics.counter(
                            "requests_rejected_deadline").inc()
                    continue
                if rows + nxt.n > self.ladder.max_rows:
                    self._unpop(nxt)
                    break
                items.append(nxt)
                rows += nxt.n
            batch = Batch(items, self.ladder.bucket_for(rows))
            self._record_batch(batch)
            try:
                with _span("serving.dispatch", rows=batch.rows,
                           bucket=batch.bucket, items=len(batch.items)):
                    self.run_batch(batch)
            except Exception as e:  # noqa: BLE001 — fail items, keep serving
                for it in batch.items:
                    it.request.fail_item(e)

    def _record_batch(self, batch: Batch) -> None:
        m = self.metrics
        m.counter("batches_total").inc()
        # the flight ring sees every dispatched batch, tracing off too
        _flight.note("serving.batch", rows=batch.rows,
                     bucket=batch.bucket, items=len(batch.items))
        m.histogram("batch_rows", buckets=tuple(
            float(b) for b in self.ladder.buckets)).observe(batch.rows)
        m.histogram("batch_fill_ratio", buckets=RATIO_BUCKETS).observe(
            batch.rows / batch.bucket)
        submitters = {it.request.submitter for it in batch.items}
        m.histogram("batch_submitters",
                    buckets=(1.0, 2.0, 4.0, 8.0, 16.0)).observe(
            len(submitters))
        if len(submitters) >= 2:
            m.counter("multi_submitter_batches").inc()
        now = time.monotonic()
        for it in batch.items:
            m.histogram("queue_wait_ms").observe(
                (now - it.enqueued_at) * 1e3)

    # ------------------------------------------------------------ shutdown

    def close(self, drain: bool = True, timeout: Optional[float] = None):
        """Stop accepting work.  ``drain=True`` serves everything already
        queued before the thread exits; ``drain=False`` fails it."""
        pending = []
        with self._lock:
            self._closed = True
            if not drain:
                pending = list(self._q)
                if self._carry is not None:
                    pending.insert(0, self._carry)
                    self._carry = None
                self._q.clear()
                self._queued_rows = 0
                self._set_depth_gauges()
            self._work_ready.notify_all()
        for it in pending:
            it.request.fail_item(ServerClosed("server shut down"))
        self._thread.join(timeout)
