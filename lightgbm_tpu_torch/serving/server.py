"""In-process serving facade: sync and async submit, deadlines,
backpressure, model hot-swap, graceful drain (counterpart of
``lightgbm_tpu/serving/server.py``).

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
DeviceForest.predict_raw_padded).  A request is pinned to the model it
was admitted against, so through a ``swap_model`` every answer is that
model's.  Overload is surfaced as typed errors at submit (QueueFull) or
completion (DeadlineExceeded), never as unbounded queueing latency.

Observability (the JAX package's serving/server.py:176-190, 294-362,
416): a server attaches its registry to the process registry
(``obs.metrics.global_registry``) as a ``serving`` component and
detaches it at ``close``, holds its request-latency p99 to the
watchdog's serving ceiling (``LIGHTGBM_TPU_SLO_SERVING_P99_MS``), starts
the env-gated sentry and metrics endpoint, and records the
``serving.admit`` and ``serving.complete`` instants and a
``serving.batch`` span a program run; its batcher beats
``ServingConfig.heartbeat_name``.
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
from ..obs.metrics import global_registry as _obs_registry
from ..obs.trace import instant as _instant
from ..obs.trace import span as _span
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
    max_programs: int = 64            # program-LRU capacity
    raw_score: bool = True            # False: predict()-style transform
    num_iteration: Optional[int] = None
    start_iteration: int = 0
    # opt-in low-precision serving: "bf16" / "int8" serve the quantized
    # twin of the model, held to accuracy_budget on a probe batch
    # (probe_X, else fixed noise) at admission and at every hot-swap;
    # "f32" (default) keeps raw-score bit parity with
    # Booster.predict(raw_score=True, device=False)
    precision: str = "f32"
    accuracy_budget: Optional[float] = None
    probe_X: Optional[object] = None
    # the AOT store of bucket programs (fleet/aot.py); None follows
    # LGBM_TPU_COMPILE_CACHE/serving, "" / "off" disables
    aot_dir: Optional[str] = None
    # the batcher thread's liveness heartbeat (obs.watchdog); a fleet
    # of servers gives each its own name
    heartbeat_name: str = "serving.batcher"

    def __post_init__(self):
        if self.backend not in ("device", "host"):
            raise ValueError(f"unknown serving backend {self.backend!r}")
        if self.precision not in ("f32", "bf16", "int8"):
            raise ValueError(f"unknown serving precision "
                             f"{self.precision!r}")


def as_booster(booster_or_path, device):
    """A Booster as given, or a model file loaded onto ``device``."""
    from ..basic import Booster
    if isinstance(booster_or_path, Booster):
        return booster_or_path
    return Booster(model_file=str(booster_or_path), device=device)


class _Request:
    """Submit-side accounting for one predict call: result buffer, item
    countdown, future, deadline, and the model the request was admitted
    against: pinned at submit, so a hot-swap mid-flight can neither mix
    model generations inside one multi-item request nor run rows
    validated for F features through a model expecting F' (and the old
    model's device forest lives until its last request completes)."""

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
        cancellation (``asyncio.wait_for`` on ``apredict`` cancels the
        wrapped Future): the scheduler drops settled items at pop time
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
    """Micro-batched, shape-bucketed, hot-swappable forest inference."""

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
        self.programs = ProgramRegistry(self.metrics,
                                        max_programs=config.max_programs)
        self.aot = self._resolve_aot(config.aot_dir)
        self.models = ModelRegistry(
            booster, self.programs, self.metrics, backend=config.backend,
            num_iteration=config.num_iteration,
            start_iteration=config.start_iteration,
            precision=config.precision,
            accuracy_budget=config.accuracy_budget,
            probe_X=config.probe_X, aot=self.aot)
        self._batcher = MicroBatcher(
            self.ladder, self._run_batch, self.metrics,
            batch_window_ms=config.batch_window_ms,
            max_queue_rows=config.max_queue_rows,
            beat_name=config.heartbeat_name)
        self._closed = False
        # the per-server registry stays authoritative (tests read it);
        # a process-wide snapshot or scrape sees it as a named
        # component, detached at close()
        self._obs_component = _obs_registry.attach_child(
            "serving", self.metrics)
        # hold this server's request p99 to the configured ceiling (it
        # never breaches unless one is set), and start the env-gated
        # sentry and metrics endpoint
        from ..obs.http import maybe_start_from_env as _http_from_env
        from ..obs.watchdog import (global_watchdog,
                                    maybe_start_from_env as _wd_from_env)
        self._wd_hist = f"serving_p99:{self._obs_component}"
        global_watchdog.watch_histogram_p99(
            self._wd_hist, self.metrics.histogram("request_latency_ms"))
        _wd_from_env()
        _http_from_env()

    @staticmethod
    def _resolve_aot(aot_dir):
        """The AOT store of bucket programs (``fleet/aot.py``): an
        explicit directory wins; None follows
        ``LGBM_TPU_COMPILE_CACHE``/serving; "" / "0" / "off" / "none"
        disables."""
        from ..fleet.aot import AOTStore, aot_dir_from_env
        if aot_dir is None:
            aot_dir = aot_dir_from_env()
        elif not str(aot_dir).strip() or \
                str(aot_dir).strip().lower() in ("0", "off", "none"):
            aot_dir = None
        return AOTStore(aot_dir) if aot_dir else None

    def _ladder_rows(self, buckets) -> set:
        """Row counts mapped through the bucket ladder (default: the
        whole ladder): traffic only ever meets bucket shapes.  Shared by
        ``warm`` and ``export_aot``, so the exported buckets are the
        warmed ones."""
        return {self.ladder.bucket_for(min(b, self.ladder.max_rows))
                for b in (buckets if buckets is not None
                          else self.ladder.buckets)}

    # --------------------------------------------------------------- submit

    def submit(self, X, deadline_ms: Optional[float] = None) -> Future:
        """Enqueue a predict request; returns a concurrent.futures.Future
        resolving to raw scores [n] (num_class == 1) or [n, K], whose
        ``model_digest`` names the model that answers it.

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
        # which model will answer: a load generator verifies against it
        req.future.model_digest = model.digest
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
        # after submit_items: a rejected request is not traced as admitted
        _instant("serving.admit", rows=n, items=n_items)
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

    async def apredict(self, X, deadline_ms: Optional[float] = None):
        """Asyncio-native submit: awaits the result without blocking the
        event loop (the concurrent Future is bridged to an asyncio one;
        bound the wait with ``asyncio.wait_for``)."""
        import asyncio
        loop = asyncio.get_running_loop()
        return await asyncio.wrap_future(
            self.submit(X, deadline_ms=deadline_ms), loop=loop)

    # ------------------------------------------------------------ execution

    def _run_batch(self, batch: Batch) -> None:
        # items carry the model their request was pinned to at submit;
        # outside a swap that is one group (one program run on the
        # batch's own bucket), during one it is two, never a mix of
        # generations inside one program run
        groups: dict = {}
        for it in batch.items:
            groups.setdefault(id(it.request.model), []).append(it)
        for items in groups.values():
            model = items[0].request.model
            sub = (batch if len(groups) == 1 else
                   Batch(items, self.ladder.bucket_for(
                       sum(it.n for it in items))))
            prog = self.programs.get(model, sub.bucket)
            t0 = time.perf_counter()
            with _span("serving.batch", rows=sub.rows, bucket=sub.bucket):
                raw = prog(sub.padded_input())       # [K, bucket] f64
            self.metrics.histogram("batch_latency_ms").observe(
                (time.perf_counter() - t0) * 1e3)
            pos = 0
            for it in items:
                it.request.complete_item(self, it.offset,
                                         raw[:, pos:pos + it.n])
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
        lat_ms = (time.monotonic() - req.t_submit) * 1e3
        self.metrics.histogram("request_latency_ms").observe(lat_ms)
        _instant("serving.complete", rows=req.n, latency_ms=round(lat_ms, 3))

    def warm(self, buckets=None) -> int:
        """Run the active model's program once for ``buckets`` (an
        iterable of row counts, mapped through the ladder) or the whole
        ladder, so the first real requests pay no kernel build or first
        launch.  Returns the number of buckets warmed."""
        model = self.models.active
        rows = self._ladder_rows(buckets)
        return self.programs.warm(model,
                                  {(b, model.num_class) for b in rows})

    def export_aot(self, path: Optional[str] = None, buckets=None) -> int:
        """Write the active model's bucket programs for ``buckets``
        (default: the whole ladder) into the AOT store at ``path`` (else
        the configured one), so a fresh replica restores them instead of
        building them (``fleet/aot.py``).  Returns the entries written."""
        from ..fleet.aot import AOTStore
        store = AOTStore(path) if path is not None else self.aot
        if store is None:
            raise ServingError(
                "no AOT store configured: pass path=, set aot_dir, or "
                "set LGBM_TPU_COMPILE_CACHE")
        return self.models.active.export_aot(store,
                                             self._ladder_rows(buckets))

    # ------------------------------------------------------------- hot swap

    def swap_model(self, booster_or_path, warm: bool = True,
                   block: bool = True, probe: bool = True):
        """Replace the serving model without dropping in-flight requests.

        ``booster_or_path``: a Booster or a model-file path (loaded on
        the active model's device).  With ``warm=True`` (default) every
        bucket shape served so far runs once for the new model before
        the atomic pointer flip; ``block=False`` runs probe, warm and
        flip in a background thread and returns it at once (join it, or
        poll the ``model_generation`` gauge; a failure sets the thread's
        ``exception`` and the ``swap_failures`` counter instead of
        flipping).  With ``probe=True`` (default) the candidate first
        runs a probe batch and is quarantined (``SwapQuarantined``, the
        ``swap_quarantines`` counter) on a raise or non-finite output."""
        booster = self._as_booster(booster_or_path)
        return self.models.swap(
            booster, warm=warm, block=block, probe=probe,
            num_iteration=self.config.num_iteration,
            start_iteration=self.config.start_iteration)

    def _as_booster(self, booster_or_path):
        return as_booster(booster_or_path,
                          self.models.active.booster.device)

    # ------------------------------------------------------------- lifecycle

    def close(self, drain: bool = True,
              timeout: Optional[float] = None) -> None:
        """Stop accepting requests; ``drain=True`` completes everything
        already queued, ``drain=False`` fails it with ServerClosed."""
        if self._closed:
            return
        self._closed = True
        self._batcher.close(drain=drain, timeout=timeout)
        _obs_registry.detach_child(self._obs_component)
        from ..obs.watchdog import global_watchdog
        global_watchdog.unwatch_histogram(self._wd_hist)

    def __enter__(self) -> "Server":
        return self

    def __exit__(self, *exc) -> None:
        self.close(drain=True)

    # ------------------------------------------------------------- metrics

    def metrics_dict(self) -> dict:
        return self.metrics.to_dict()

    def metrics_json(self, path: Optional[str] = None) -> str:
        return self.metrics.dump_json(path)

    def prometheus_text(self, prefix: str = "lgbt_serving") -> str:
        """This server's instruments in the Prometheus text exposition
        format (the process-wide scrape is
        ``obs.metrics.global_registry.to_prometheus()``, and
        ``obs.http`` serves it)."""
        return self.metrics.to_prometheus(prefix=prefix)
