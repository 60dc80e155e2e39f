"""Program and model registry: one predict callable per
(model digest, row bucket, num_class), and atomic model hot-swap
(counterpart of ``lightgbm_tpu/serving/registry.py``).

``ProgramRegistry`` is an LRU of predict callables keyed
``(digest, bucket_rows, num_class)``; a miss builds the callable and
counts ``bucket_misses`` and, by where the program came from, the JAX
package's ``compile_events`` (built from the forest),
``aot_program_loads`` (restored from the fleet's AOT store,
``fleet/aot.py``, on a device forest built from the stored records) or ``host_fallback_builds`` (built while the model
was evicted); a hit counts ``bucket_hits``, and an entry pushed out
past ``max_programs`` counts ``program_evictions``.  PyTorch runs
eagerly, so a program is a closure over its ``CompiledModel`` that
reads the model's ``DeviceForest`` at call time: a model whose device
tensors the fleet dropped (``drop_device``) serves through the
bit-identical host path and its programs hold none of its memory.
``seen_buckets`` (every (bucket, num_class) shape served) is the warm
set of a swap.

``ModelRegistry`` owns the serving pointer.  ``swap()`` builds the new
model, runs a probe batch through it (a raise or a non-finite score
quarantines it, ``SwapQuarantined``), holds a bf16/int8 model to its
``accuracy_budget`` (``LowPrecisionQuarantined``), optionally runs every
seen bucket once (``warm``), then flips ``active`` in one assignment.
Requests are pinned to the model they were admitted against
(server.py), so a swap never drops, corrupts or mixes generations of
in-flight work.  A quarantine dumps a flight-recorder bundle
(``obs.flight``; the JAX package's serving/registry.py:339-346) before
its error is raised.
"""

from __future__ import annotations

import hashlib
import threading
from collections import OrderedDict
from typing import Callable, Optional, Set, Tuple

import numpy as np

from .errors import LowPrecisionQuarantined, SwapQuarantined


def forest_digest(forest) -> str:
    """Stable content hash of a StackedForest's semantic arrays (the
    JAX package's fields, so the same hex for the same forest)."""
    h = hashlib.sha256()
    for a in (forest.split_feature, forest.threshold, forest.left,
              forest.right, forest.leaf_value, forest.is_cat,
              forest.default_left, forest.missing_type,
              forest.cat_offset, forest.cat_nwords, forest.cat_words):
        h.update(np.ascontiguousarray(a).tobytes())
    h.update(np.int64([forest.num_trees]).tobytes())
    return h.hexdigest()[:16]


class CompiledModel:
    """One immutable loaded model: booster, host forest (and device
    forest for the "device" backend), its digest and output transform.

    ``precision`` ("bf16" / "int8") serves the quantized twin
    (``fleet.lowprec.quantize_forest``): its own digest, leaves gathered
    on the host, a routing-only device forest on the narrowed grid;
    ``forest_full`` keeps the exact forest for the accuracy probe.
    ``aot`` is an optional ``fleet.aot.AOTStore`` consulted before a
    bucket program is built.  The device tensors are evictable
    (``drop_device``/``restore_device``, driven by the fleet's
    residency plan): programs read the pointer at call time and take
    the bit-identical host path while the model is evicted."""

    def __init__(self, booster, backend: str = "device",
                 num_iteration: Optional[int] = None,
                 start_iteration: int = 0, precision: str = "f32",
                 aot=None):
        self.booster = booster
        self.backend = backend
        self.precision = precision
        self.aot = aot
        K = max(booster.num_tree_per_iteration, 1)
        self.num_class = K
        n_total_iter = len(booster.models) // K
        if num_iteration is None or num_iteration < 0:
            num_iteration = (booster.best_iteration
                             if booster.best_iteration > 0 else n_total_iter)
        stop_iter = min(start_iteration + num_iteration, n_total_iter)
        self.num_iterations = stop_iter - start_iteration
        self.forest_full = booster._forest(start_iteration, stop_iter)
        if precision != "f32":
            from ..fleet.lowprec import quantize_forest
            self.forest = quantize_forest(self.forest_full, precision)
        else:
            self.forest = self.forest_full
        self.num_features = booster.num_features()
        self.device_forest = None
        self.digest = forest_digest(self.forest)
        self.average_output = bool(booster.average_output)
        if backend == "device":
            self.restore_device()

    # --------------------------------------------------------- device state

    def restore_device(self) -> None:
        """(Re-)upload the device forest; a no-op off the device backend
        or when it is resident.  With an AOT store the forest is built
        from the model's stored records and epilogue verdict where the
        store has them (``fleet.aot``), else packed and probed live."""
        if self.backend != "device" or self.device_forest is not None:
            return
        f32 = self.precision == "f32"
        cache = getattr(self.booster, "_device_forest_cache", None)
        if f32 and cache is not None and cache[0] is self.forest:
            # share Booster.predict's DeviceForest: one upload
            self.device_forest = cache[1]
            return
        dev = None
        if self.aot is not None:
            dev = self.aot.restore_device_forest(
                self.forest, self.digest, self.booster.device,
                num_class=self.num_class, precision=self.precision,
                routing_only=not f32)
        if f32:
            if dev is None:
                dev = self.booster._device_forest(self.forest)
            else:
                self.booster._device_forest_cache = (self.forest, dev)
        elif dev is None:
            from ..predict import DeviceForest
            dev = DeviceForest(self.forest, self.booster.device,
                               precision=self.precision, routing_only=True)
        self.device_forest = dev

    def drop_device(self) -> None:
        """Release the device forest (fleet eviction) and the Booster's
        cached one with it.  Serving goes on through the host path,
        bit-identical for the same inputs, until ``restore_device``."""
        dropped, self.device_forest = self.device_forest, None
        cache = getattr(self.booster, "_device_forest_cache", None)
        if (cache is not None and dropped is not None
                and cache[1] is dropped):
            self.booster._device_forest_cache = None

    def make_program(self, bucket_rows: int) -> Callable:
        """Predict callable for one bucket shape: [bucket, F] float64
        padded batch -> raw scores [K, bucket] float64: restored from
        the AOT store where it holds the bucket (``fleet.aot``), else
        built (``program``)."""
        if self.backend == "device" and self.aot is not None:
            from ..fleet.aot import make_aot_program
            prog = make_aot_program(self.aot, self, bucket_rows)
            if prog is not None:
                return prog
        return self.program()

    def program(self, plans: Optional[dict] = None) -> Callable:
        """The predict callable.  Both backends are bit-identical to
        ``StackedForest.predict_raw`` of the SERVED forest (the quantized
        twin under low precision) per row: "host" unconditionally (it IS
        predict_raw on the padded batch), "device" for float32-precision
        feature values (the DeviceForest's routing-exactness domain; leaf
        values are summed on the host in float64 in the order of
        predict_raw, or on the card where its epilogue probe proved that
        bit-exact).  ``plans`` are a stored program's B1 launch plans
        (the program is then tagged ``aot``); a program built while the
        model is evicted is tagged ``host_fallback``.
        """
        K = self.num_class
        forest = self.forest
        if self.backend == "host":

            def run(Xpad: np.ndarray) -> np.ndarray:
                return forest.predict_raw(Xpad, num_class=K)

            return run
        model = self

        def run(Xpad: np.ndarray) -> np.ndarray:
            # read at call time: an evicted model's programs route on the
            # host and keep none of its device memory
            dev = model.device_forest
            if dev is None:
                return forest.predict_raw(Xpad, num_class=K)
            return dev.predict_raw_padded(Xpad, num_class=K, plans=plans)

        run.aot = plans is not None
        run.host_fallback = self.device_forest is None
        return run

    def export_aot(self, store, buckets) -> int:
        """Write this model's bucket programs for ``buckets`` into
        ``store`` (``fleet.aot.AOTStore``); returns the entries written
        (0 while evicted)."""
        if self.device_forest is None:
            return 0
        return store.export_device_forest(
            self.device_forest, self.num_features, buckets, self.digest,
            num_class=self.num_class)

    def measure_accuracy(self, X: np.ndarray) -> float:
        """max |served raw - full-precision raw| over probe rows ``X``
        (0.0 for f32 models by construction)."""
        if self.precision == "f32":
            return 0.0
        from ..fleet.lowprec import measure_accuracy_delta
        return measure_accuracy_delta(self.forest_full, self.forest, X,
                                      num_class=self.num_class)

    def scale_raw(self, raw: np.ndarray) -> np.ndarray:
        """The average_output division Booster.predict applies to BOTH
        raw and transformed output — identity for every boosting mode
        but rf."""
        if self.average_output and self.num_iterations > 0:
            raw = raw / self.num_iterations
        return raw

    def transform_raw(self, raw: np.ndarray) -> np.ndarray:
        """predict()'s objective transform for ALREADY-SCALED raw
        [K, n]; returns [K, n]."""
        return self.booster._convert_output(raw)


class ProgramRegistry:
    """LRU of predict programs keyed (digest, bucket_rows, num_class)."""

    def __init__(self, metrics, max_programs: int = 64):
        self.metrics = metrics
        self.max_programs = max_programs
        self._lock = threading.Lock()
        self._lru: "OrderedDict[Tuple[str, int, int], Callable]" = \
            OrderedDict()
        # (bucket, num_class) shapes ever served: the warm set for swaps
        self.seen_buckets: Set[Tuple[int, int]] = set()

    def get(self, model: CompiledModel, bucket_rows: int) -> Callable:
        key = (model.digest, bucket_rows, model.num_class)
        with self._lock:
            prog = self._lru.get(key)
            if prog is not None:
                self._lru.move_to_end(key)
                self.metrics.counter("bucket_hits").inc()
                return prog
        # built outside the lock: a restore reads the AOT store and a
        # build may probe the forest; other buckets must not wait on it
        prog = model.make_program(bucket_rows)
        with self._lock:
            race = self._lru.get(key)
            if race is not None:
                self._lru.move_to_end(key)
                self.metrics.counter("bucket_hits").inc()
                return race
            self._lru[key] = prog
            self.seen_buckets.add((bucket_rows, model.num_class))
            self.metrics.counter("bucket_misses").inc()
            if getattr(prog, "aot", False):
                # restored from the AOT store (the cold-start
                # discriminator)
                self.metrics.counter("aot_program_loads").inc()
            elif getattr(prog, "host_fallback", False):
                # a device program built while the model is evicted
                self.metrics.counter("host_fallback_builds").inc()
            else:
                self.metrics.counter("compile_events").inc()
            while len(self._lru) > self.max_programs:
                self._lru.popitem(last=False)
                self.metrics.counter("program_evictions").inc()
        return prog

    def evict_model(self, digest: str) -> int:
        """Drop every cached program of one model digest (a fleet
        eviction or restore: the next ``get`` rebuilds against the
        model's current state); returns the number evicted."""
        with self._lock:
            keys = [k for k in self._lru if k[0] == digest]
            for k in keys:
                del self._lru[k]
            if keys:
                self.metrics.counter("program_evictions").inc(len(keys))
        return len(keys)

    def warm(self, model: CompiledModel,
             buckets: Optional[Set[Tuple[int, int]]] = None) -> int:
        """Run ``model``'s program on zeros once for every bucket-rows
        value in ``buckets`` (default: every shape ever served), so the
        kernel build and first launches happen before the model takes
        traffic.  The num_class half of the keys is ignored: the model's
        own K applies, so a swap that changes the class count still
        warms every bucket.  Returns the number of buckets warmed."""
        with self._lock:
            todo = sorted({b for b, _k in (buckets if buckets is not None
                                           else self.seen_buckets)})
        for bucket_rows in todo:
            prog = self.get(model, bucket_rows)
            prog(np.zeros((bucket_rows, model.num_features), np.float64))
        return len(todo)


class ModelRegistry:
    """The serving pointer and the hot-swap protocol."""

    # rows of the pre-promotion probe batch when no bucket has been
    # served yet (otherwise the smallest seen bucket)
    probe_rows = 8

    def __init__(self, booster, programs: ProgramRegistry, metrics,
                 backend: str = "device",
                 num_iteration: Optional[int] = None,
                 start_iteration: int = 0, precision: str = "f32",
                 accuracy_budget: Optional[float] = None, probe_X=None,
                 aot=None):
        self.programs = programs
        self.aot = aot
        self.metrics = metrics
        self.backend = backend
        self.precision = precision
        self.accuracy_budget = accuracy_budget
        self.probe_X = probe_X
        self._swap_lock = threading.Lock()    # serializes swaps, not reads
        self._seq_lock = threading.Lock()     # ticket allocation only
        self._active = CompiledModel(booster, backend=backend,
                                     num_iteration=num_iteration,
                                     start_iteration=start_iteration,
                                     precision=precision, aot=aot)
        # a low-precision model meets its budget before it ever serves
        self._probe_lowprec(self._active)
        metrics.gauge("active_model_digest").set(self._active.digest)
        metrics.gauge("model_generation").set(0)
        self._generation = 0
        self._swap_seq = 0          # ticket order of swap() calls
        self._applied_seq = 0       # highest ticket that has flipped

    @property
    def active(self) -> CompiledModel:
        # a plain attribute read: atomic under the GIL, no lock on the
        # per-batch path
        return self._active

    def _probe(self, model: CompiledModel) -> None:
        """Run one probe batch through the candidate BEFORE promotion; a
        raise or a non-finite raw score quarantines the swap, so the
        active pointer never flips to a model that cannot serve."""
        with self.programs._lock:
            seen = sorted(b for b, _k in self.programs.seen_buckets)
        rows = seen[0] if seen else self.probe_rows
        try:
            raw = model.make_program(rows)(
                np.zeros((rows, model.num_features), np.float64))
            raw = model.scale_raw(np.asarray(raw, np.float64))
        except Exception as e:  # noqa: BLE001 - any probe failure quarantines
            self.metrics.counter("swap_quarantines").inc()
            raise self._quarantine(SwapQuarantined(
                f"hot-swap candidate {model.digest} failed its probe batch "
                f"({rows} rows): {e!r}; swap rolled back"),
                digest=model.digest) from e
        if not np.isfinite(raw).all():
            self.metrics.counter("swap_quarantines").inc()
            raise self._quarantine(SwapQuarantined(
                f"hot-swap candidate {model.digest} produced non-finite "
                f"probe output; swap rolled back"), digest=model.digest)

    def _quarantine(self, err: SwapQuarantined, **extra) -> SwapQuarantined:
        """Dump the quarantine to the flight recorder (the serving pointer
        never flipped: the bundle is the postmortem of why) and hand the
        error back for the caller to raise.  Dumping never raises."""
        from ..obs.flight import global_flight
        global_flight.dump(f"serving.swap:{type(err).__name__}", exc=err,
                           extra=extra or None)
        return err

    def _probe_rows(self, model: CompiledModel) -> np.ndarray:
        """Probe rows for the low-precision accuracy measurement: the
        caller's batch when given, else a fixed float32-precise
        standard-normal batch."""
        if self.probe_X is not None:
            return np.asarray(self.probe_X, np.float64)
        rng = np.random.RandomState(0x1F1EE7)
        return rng.randn(256, model.num_features) \
            .astype(np.float32).astype(np.float64)

    def _probe_lowprec(self, model: CompiledModel) -> None:
        """Measure a bf16/int8 candidate's raw-score drift on the probe
        batch and quarantine it when the drift exceeds the declared
        ``accuracy_budget``.  The delta is reported either way
        (``lowprec_accuracy_delta`` gauge)."""
        if model.precision == "f32":
            return
        delta = model.measure_accuracy(self._probe_rows(model))
        self.metrics.gauge("lowprec_accuracy_delta").set(delta)
        self.metrics.gauge("lowprec_precision").set(model.precision)
        if self.accuracy_budget is not None and delta > self.accuracy_budget:
            self.metrics.counter("swap_quarantines").inc()
            self.metrics.counter("lowprec_quarantines").inc()
            raise self._quarantine(LowPrecisionQuarantined(
                f"{model.precision} candidate {model.digest} measured "
                f"probe accuracy delta {delta:.3e} over the declared "
                f"budget {self.accuracy_budget:.3e}; not promoted"),
                digest=model.digest, precision=model.precision,
                accuracy_delta=delta)

    def swap(self, booster, warm: bool = True, block: bool = True,
             num_iteration: Optional[int] = None,
             start_iteration: int = 0,
             probe: bool = True) -> "threading.Thread | None":
        """Load ``booster`` as the new serving model.

        With ``warm=True`` every bucket shape served so far runs once
        for the new model before the pointer flips.  ``block=False``
        does probe, warm and flip in a daemon thread and returns it
        (serving continues on the old model meanwhile; a failure sets
        the thread's ``exception``).  With ``probe=True`` the candidate
        must first survive a probe batch (``SwapQuarantined``) and, under
        low precision, its ``accuracy_budget``
        (``LowPrecisionQuarantined``); the old model keeps serving."""
        new = CompiledModel(booster, backend=self.backend,
                            num_iteration=num_iteration,
                            start_iteration=start_iteration,
                            precision=self.precision, aot=self.aot)
        # ticket taken at CALL time: two block=False swaps whose threads
        # take the lock out of order still converge on the later call's
        # model
        with self._seq_lock:
            self._swap_seq += 1
            seq = self._swap_seq

        def do_swap():
            try:
                with self._swap_lock:
                    if seq < self._applied_seq:
                        return      # a newer swap already landed
                    if probe:
                        self._probe(new)
                        self._probe_lowprec(new)
                    if warm:
                        self.programs.warm(new)
                    self._applied_seq = seq
                    self._active = new
                    self._generation += 1
                    self.metrics.counter("hot_swaps").inc()
                    self.metrics.gauge("active_model_digest").set(new.digest)
                    self.metrics.gauge("model_generation").set(
                        self._generation)
            except Exception:
                # counted on both paths: a dashboard must see it too
                self.metrics.counter("swap_failures").inc()
                raise

        if block:
            do_swap()
            return None

        def do_swap_bg():
            try:
                do_swap()
            except Exception as e:  # noqa: BLE001
                t.exception = e

        t = threading.Thread(target=do_swap_bg, name="lgbt-serving-swap",
                             daemon=True)
        t.exception = None
        t.start()
        return t
