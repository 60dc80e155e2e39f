"""Synthetic models and rows for the tests and the chip smoke run (not
public API).

``synthetic_model_text`` writes reference-format model text for random,
valid leaf-wise trees over a seeded feature distribution:

- numeric thresholds are drawn from the quantiles of each feature's
  distribution, as midpoints of adjacent sample values (half of them
  rounded to float32, half left in float64 so the device path's threshold
  round-down is exercised);
- ``decision_type`` bits cover the missing types none/zero/NaN (one per
  numeric feature, cycling through ``missing_types``) and both
  ``default_left`` values;
- categorical features get bitsets, some wider than one 32-bit word;
- about one tree in twenty is a single leaf.

``synthetic_rows`` draws rows from the same distribution, rounded to
float32 precision (the device path's exactness domain), with NaNs,
zeros and out-of-range categories planted; ``salt_rows`` overwrites the
first rows with the routing edge cases.

``thread_ranks`` runs a function in W thread ranks, each in its own
gloo group (the CPU tests of sharded training).

``one_thread`` (built on first access, so that importing this module
needs no pytest) is the autouse module fixture the ``test_torch_*``
files import: their CPU trainings and predictions run on one torch
thread, which keeps parallel test workers from oversubscribing the
cores and makes the f32 sums independent of the core count; the old
count comes back after the module.
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import Sequence

import numpy as np

from .model_text import save_model_to_string
from .tree import HostTree, MISSING_NAN, MISSING_NONE, MISSING_ZERO

_SAMPLE = 4096
ALL_MISSING = (MISSING_NONE, MISSING_ZERO, MISSING_NAN)
SALT_VALUES = (0.0, np.nan, -1e30, 1e30, 2.5, -0.5)


def _feature_specs(num_features: int, cat_features: Sequence[int],
                   seed: int, missing_types: Sequence[int]) -> list:
    rng = np.random.RandomState(seed)
    cats = set(int(c) for c in cat_features)
    specs = []
    numeric_i = 0
    for f in range(num_features):
        if f in cats:
            # 8..100 categories: bitsets of one to four words
            specs.append({"cat": True, "ncat": int(rng.randint(8, 101)),
                          "mt": MISSING_NAN})
            continue
        mt = int(missing_types[numeric_i % len(missing_types)])
        numeric_i += 1
        loc, scale = rng.normal(0.0, 2.0), rng.uniform(0.5, 3.0)
        sample = rng.normal(loc, scale, _SAMPLE)
        if mt == MISSING_ZERO:
            sample[rng.rand(_SAMPLE) < 0.2] = 0.0
        specs.append({"cat": False, "loc": loc, "scale": scale, "mt": mt,
                      "sample": np.sort(sample)})
    return specs


def synthetic_rows(num_features: int, n: int, cat_features=(),
                   seed: int = 0, row_seed: int = 1,
                   missing_types: Sequence[int] = ALL_MISSING) -> np.ndarray:
    """[n, F] float64 rows of float32 precision from the distribution of
    ``synthetic_model_text`` with the same features, seed and missing
    types."""
    specs = _feature_specs(num_features, cat_features, seed, missing_types)
    rng = np.random.RandomState(row_seed)
    X = np.empty((n, num_features), np.float64)
    for f, s in enumerate(specs):
        if s["cat"]:
            col = rng.randint(0, s["ncat"], n).astype(np.float64)
            odd = rng.rand(n)
            col[odd < 0.03] = s["ncat"] + 40          # past the bitset
            col[(odd >= 0.03) & (odd < 0.05)] = -3.0  # negative category
            col[(odd >= 0.05) & (odd < 0.08)] = np.nan
        else:
            col = rng.normal(s["loc"], s["scale"], n)
            col[rng.rand(n) < 0.1] = np.nan
            if s["mt"] == MISSING_ZERO:
                col[rng.rand(n) < 0.2] = 0.0
        X[:, f] = col
    return X.astype(np.float32).astype(np.float64)


def salt_rows(X: np.ndarray) -> np.ndarray:
    """A copy of ``X`` whose first rows are all 0, all NaN, all -1e30,
    all 1e30, all 2.5 and all -0.5 (float32 precision)."""
    Xs = np.array(X, np.float64)
    for i, v in enumerate(SALT_VALUES[:Xs.shape[0]]):
        Xs[i, :] = v
    return Xs.astype(np.float32).astype(np.float64)


def _tree(rng, specs, nl: int, dyadic_leaves: bool) -> HostTree:
    def leaf_values(k):
        if dyadic_leaves:
            return rng.randint(-64, 65, k) / 64.0
        return rng.normal(0.0, 0.1, k)

    if nl <= 1:
        z = np.zeros(0)
        return HostTree(
            num_leaves=1, split_feature=np.zeros(0, np.int32),
            split_feature_inner=np.zeros(0, np.int32), threshold=z,
            threshold_in_bin=np.zeros(0, np.int32),
            decision_type=np.zeros(0, np.int8),
            left_child=np.zeros(0, np.int32),
            right_child=np.zeros(0, np.int32), split_gain=z,
            internal_value=z, internal_weight=z, internal_count=z,
            leaf_value=leaf_values(1), leaf_weight=np.ones(1),
            leaf_count=np.full(1, 100.0), shrinkage=0.1)
    ns = nl - 1
    left = np.zeros(ns, np.int32)
    right = np.zeros(ns, np.int32)
    parent = {0: (-1, None)}            # leaf -> (internal node, side)
    for s in range(ns):
        leaf = int(rng.randint(0, s + 1))   # leaf-wise: grow any leaf
        p, side = parent[leaf]
        if p >= 0:
            (left if side == "L" else right)[p] = s
        left[s], right[s] = ~leaf, ~(s + 1)
        parent[leaf] = (s, "L")
        parent[s + 1] = (s, "R")
    split_feature = np.zeros(ns, np.int32)
    threshold = np.zeros(ns, np.float64)
    decision_type = np.zeros(ns, np.int8)
    cat_boundaries = [0]
    cat_threshold = []
    for s in range(ns):
        f = int(rng.randint(0, len(specs)))
        spec = specs[f]
        split_feature[s] = f
        if spec["cat"]:
            k = int(rng.randint(1, spec["ncat"]))
            chosen = rng.choice(spec["ncat"], size=k, replace=False)
            words = np.zeros(int(chosen.max()) // 32 + 1, np.uint32)
            for c in chosen:
                words[c // 32] |= np.uint32(1) << np.uint32(c % 32)
            threshold[s] = len(cat_boundaries) - 1
            cat_boundaries.append(cat_boundaries[-1] + len(words))
            cat_threshold.extend(int(w) for w in words)
            decision_type[s] = 1 | (spec["mt"] << 2)
        else:
            # a bin upper bound: the midpoint of two adjacent sample values
            srt = spec["sample"]
            i = int(rng.uniform(0.05, 0.95) * (srt.size - 1))
            thr = (srt[i] + srt[i + 1]) / 2.0
            if rng.rand() < 0.5:
                thr = float(np.float32(thr))
            threshold[s] = thr
            decision_type[s] = (spec["mt"] << 2) | (int(rng.rand() < 0.5) << 1)
    counts = rng.randint(20, 2000, ns).astype(np.float64)
    return HostTree(
        num_leaves=nl, split_feature=split_feature,
        split_feature_inner=split_feature.copy(), threshold=threshold,
        threshold_in_bin=np.zeros(ns, np.int32),
        decision_type=decision_type, left_child=left, right_child=right,
        split_gain=np.round(rng.exponential(5.0, ns), 3),
        internal_value=np.round(rng.normal(0.0, 0.1, ns), 6),
        internal_weight=np.round(counts * 0.25, 3), internal_count=counts,
        leaf_value=leaf_values(nl), leaf_weight=np.round(
            rng.uniform(1.0, 50.0, nl), 3),
        leaf_count=rng.randint(10, 1000, nl).astype(np.float64),
        num_cat=len(cat_boundaries) - 1,
        cat_boundaries=np.asarray(cat_boundaries, np.int32),
        cat_threshold=np.asarray(cat_threshold, np.uint32),
        shrinkage=0.1, real_feature_index=split_feature.copy())


def synthetic_model_text(num_features: int, num_trees: int,
                         num_leaves: int, num_class: int = 1,
                         cat_features: Sequence[int] = (), seed: int = 0,
                         dyadic_leaves: bool = False,
                         missing_types: Sequence[int] = ALL_MISSING) -> str:
    """Reference-format model text: ``num_trees`` boosting iterations of
    ``num_class`` trees each, up to ``num_leaves`` leaves per tree.

    ``missing_types`` are the missing types the numeric features cycle
    through.  ``dyadic_leaves`` draws leaf values from multiples of 1/64,
    whose float32 pinned-order sums equal the float64 host sums (the
    device leaf-sum epilogue then verifies)."""
    specs = _feature_specs(num_features, cat_features, seed, missing_types)
    rng = np.random.RandomState(seed + 1)
    K = max(int(num_class), 1)
    trees = []
    for _ in range(num_trees * K):
        u = rng.rand()
        if u < 0.05:
            nl = 1
        elif u < 0.15:
            nl = int(rng.randint(2, num_leaves + 1))
        else:
            nl = num_leaves
        trees.append(_tree(rng, specs, nl, dyadic_leaves))
    names = [f"Column_{f}" for f in range(num_features)]
    infos = [":".join(str(c) for c in range(s["ncat"])) if s["cat"]
             else f"[{s['sample'].min():g}:{s['sample'].max():g}]"
             for s in specs]
    imp = np.zeros(num_features, np.int64)
    for t in trees:
        np.add.at(imp, t.split_feature, 1)
    model = SimpleNamespace(
        models=trees, num_tree_per_iteration=K, num_class=K,
        sub_model_name="tree", label_index=0,
        max_feature_idx=num_features - 1,
        objective_name=("binary sigmoid:1" if K == 1
                        else f"multiclass num_class:{K}"),
        average_output=False, feature_names=names, feature_infos=infos,
        params_str="",
        feature_importance_int=lambda: list(zip(names, imp.tolist())))
    return save_model_to_string(model) + "\npandas_categorical:null\n"


def higgs_like(rows: int, seed: int, num_features: int = 28):
    """Training rows at HIGGS width: ``num_features`` dense f32 columns
    (every third one non-negative and skewed, like the momenta of the
    UCI HIGGS set) and a 0/1 label with signal in a few of them.
    Returns (X [rows, F] f32, y [rows] f32)."""
    rng = np.random.RandomState(seed)
    X = rng.standard_normal((rows, num_features)).astype(np.float32)
    X[:, ::3] = np.abs(X[:, ::3]) ** 1.5
    logit = (1.2 * X[:, 0] - 0.8 * X[:, 1] * X[:, 2]
             + 0.6 * np.sin(2.0 * X[:, 4]) + 0.3 * X[:, 5:9].sum(axis=1)
             - 1.0 + 0.7 * rng.standard_normal(rows))
    return X, (logit > 0).astype(np.float32)


MONOTONE_CONSTRAINTS = (1, -1, 0)


def monotone_like(rows: int, seed: int, num_features: int = 28):
    """Regression rows for monotone constraints: upstream LightGBM's
    generator (tests/python_package_test/test_engine.py,
    test_monotone_constraints), ``x0`` increasing with a ``sin(10 pi
    x0)`` ripple, ``x1`` decreasing with a ``cos(10 pi x1)`` ripple,
    ``x2`` free, plus ``higgs_like`` columns to ``num_features`` (HIGGS
    width); constrain the first three with ``MONOTONE_CONSTRAINTS``.
    Returns (X [rows, F] f32, y [rows] f32)."""
    rng = np.random.RandomState(seed)
    x0, x1, x2 = rng.rand(rows), rng.rand(rows), rng.rand(rows)
    y = (5 * x0 + np.sin(10 * np.pi * x0)
         - 5 * x1 - np.cos(10 * np.pi * x1)
         + 10 * x2 + rng.rand(rows))
    X = np.empty((rows, num_features), np.float32)
    X[:, 0], X[:, 1], X[:, 2] = x0, x1, x2
    if num_features > 3:
        X[:, 3:] = higgs_like(rows, seed + 1, num_features - 3)[0]
    return X, y.astype(np.float32)


# the airline on-time schema of the benchm-ml benchmark (2005-2006 ASA
# Data Expo rows): name, first code, number of codes; DepTime (hhmm) and
# Distance are numeric
AIRLINE_COLUMNS = (("Month", 1, 12), ("DayofMonth", 1, 31),
                   ("DayOfWeek", 1, 7), ("DepTime", None, None),
                   ("UniqueCarrier", 0, 22), ("Origin", 0, 300),
                   ("Dest", 0, 300), ("Distance", None, None))
AIRLINE_CATEGORICAL = tuple(i for i, (_, lo, _) in enumerate(AIRLINE_COLUMNS)
                            if lo is not None)


def _airport_weights(count: int) -> np.ndarray:
    """Zipf-Mandelbrot airport frequencies, 1 / (rank + 10)^2: the busiest
    airport takes 9% of the flights, and the busiest 232 of 300 take 99%
    (so a 255-bin categorical mapper keeps them all in one bin each)."""
    w = 1.0 / (np.arange(1, count + 1) + 10.0) ** 2
    return w / w.sum()


def _airline_rows(rows: int, seed: int):
    """The airline rows and their delay logit, and the generator after
    drawing them (``airline_like``)."""
    fx = np.random.RandomState(2009)          # the effects, fixed
    effects = {name: fx.normal(0.0, 0.35, k)
               for name, lo, k in AIRLINE_COLUMNS if lo is not None}
    rank_of = {name: fx.permutation(300) for name in ("Origin", "Dest")}
    rng = np.random.RandomState(seed)
    X = np.zeros((rows, len(AIRLINE_COLUMNS)), np.float32)
    logit = np.full(rows, -1.6)
    for j, (name, lo, k) in enumerate(AIRLINE_COLUMNS):
        if name in rank_of:
            codes = rank_of[name][rng.choice(k, rows, p=_airport_weights(k))]
        elif lo is not None:
            codes = rng.randint(0, k, rows)
        else:
            continue
        X[:, j] = codes + lo
        logit += effects[name][codes]
    hour = rng.randint(5, 24, rows)
    X[:, 3] = hour * 100 + rng.randint(0, 60, rows)
    X[:, 7] = np.round(np.exp(rng.normal(6.4, 0.6, rows)))
    logit += 0.12 * (hour - 14) + 0.2 * rng.standard_normal(rows)
    return X, logit, rng


def airline_like(rows: int, seed: int):
    """Rows of the airline schema (``AIRLINE_COLUMNS``), f32, and a 0/1
    label "departure delayed by 15 minutes or more".

    Month, DayofMonth and DayOfWeek are uniform; UniqueCarrier has 22
    codes, Origin and Dest 300 each with Zipf-skewed frequencies (airport
    ranks are a fixed shuffle of the codes); DepTime is hhmm between
    05:00 and 23:59, Distance in miles.  The label is a seeded logistic
    of per-category effects (drawn once, the same for every ``seed``)
    plus a late-departure term; about one row in five is positive.
    Returns (X [rows, 8] f32, y [rows] f32)."""
    X, logit, rng = _airline_rows(rows, seed)
    y = rng.rand(rows) < 1.0 / (1.0 + np.exp(-logit))
    return X, y.astype(np.float32)


# the departure-delay bands of airline_multiclass_like, on the latent
# delay whose sign is airline_like's label
DELAY_BANDS = (-2.0, -1.0, 0.0, 1.0)


def airline_multiclass_like(rows: int, seed: int):
    """The ``airline_like`` rows with a 5-class label: the band of the
    latent delay ``logit - log(u / (1 - u))`` (the same uniform ``u``
    that draws ``airline_like``'s label, which is "latent > 0") cut at
    ``DELAY_BANDS``: 0 to 2 on time, 3 and 4 (``airline_like``'s
    positives) delayed and much delayed.
    Returns (X [rows, 8] f32, y [rows] f32 in 0..4)."""
    X, logit, rng = _airline_rows(rows, seed)
    u = np.clip(rng.rand(rows), 1e-12, 1.0 - 1e-12)
    latent = logit - np.log(u / (1.0 - u))
    return X, np.digitize(latent, DELAY_BANDS).astype(np.float32)


# MSLR-WEB30K (Qin and Liu, 2013): 136 features, graded relevance 0-4;
# its training folds hold 2,270,296 rows of about 120 documents a query
# (LightGBM docs/Experiments.rst), at most ~1,250; the grades' shares
MSLR_FEATURES = 136
MSLR_GRADE_SHARES = (0.52, 0.32, 0.13, 0.02, 0.01)


def mslr_like(rows: int, seed: int):
    """Learning-to-rank rows at MSLR-WEB30K width: 136 f32 features
    (query-document scores, counts and ratios: some non-negative and
    skewed, some integer-valued), queries of lognormal lengths around
    120 documents (1 to 1,250; the last query takes the remainder), and
    graded relevance 0-4 in MSLR's shares from a noisy nonlinear score.
    Returns (X [rows, 136] f32, y [rows] f32, group [queries] int32)."""
    F = MSLR_FEATURES
    rng = np.random.RandomState(seed)
    sizes = []
    total = 0
    while total < rows:
        s = int(np.clip(np.round(rng.lognormal(np.log(95.0), 0.7)), 1,
                        1250))
        s = min(s, rows - total)
        sizes.append(s)
        total += s
    group = np.asarray(sizes, np.int32)
    X = rng.standard_normal((rows, F)).astype(np.float32)
    X[:, 0:40] = np.abs(X[:, 0:40]) ** 2
    X[:, 40:60] = np.floor(np.abs(X[:, 40:60]) * 8.0)
    X[:, 60:70] = (X[:, 60:70] > 0.5).astype(np.float32)
    w = np.random.RandomState(136).standard_normal(F).astype(np.float32)
    w[70:] *= 0.1
    score = (X[:, :70] @ w[:70] + 0.1 * (X[:, 70:] @ w[70:])
             + 1.5 * np.tanh(X[:, 0] * X[:, 1]) - X[:, 2] * (X[:, 61] > 0))
    # a query's own offset, so grades are not one global cut
    score += np.repeat(rng.standard_normal(len(group)) * score.std() * 0.5,
                       group)
    score += rng.standard_normal(rows) * score.std() * 0.5
    cuts = np.quantile(score, np.cumsum(MSLR_GRADE_SHARES)[:-1])
    y = np.digitize(score, cuts).astype(np.float32)
    return X, y, group


def one_hot(X: np.ndarray) -> np.ndarray:
    """The airline rows with every categorical column one-hot encoded in
    place (12 + 31 + 7 + 22 + 300 + 300 columns, DepTime and Distance
    kept): [rows, 674] f32."""
    widths = [1 if lo is None else k for _, lo, k in AIRLINE_COLUMNS]
    out = np.zeros((X.shape[0], sum(widths)), np.float32)
    at = 0
    for j, (_, lo, k) in enumerate(AIRLINE_COLUMNS):
        if lo is None:
            out[:, at] = X[:, j]
        else:
            out[np.arange(X.shape[0]), at + X[:, j].astype(np.int64) - lo] = 1
        at += widths[j]
    return out


def one_hot_csr(X: np.ndarray):
    """``one_hot(X)`` as a scipy CSR matrix (f32), built without the dense
    matrix: 8 stored entries a row (six ones, DepTime, Distance)."""
    import scipy.sparse as sps
    n = X.shape[0]
    widths = [1 if lo is None else k for _, lo, k in AIRLINE_COLUMNS]
    starts = np.concatenate([[0], np.cumsum(widths)[:-1]])
    cols = np.empty((n, len(AIRLINE_COLUMNS)), np.int64)
    vals = np.ones((n, len(AIRLINE_COLUMNS)), np.float32)
    for j, (_, lo, k) in enumerate(AIRLINE_COLUMNS):
        if lo is None:
            cols[:, j] = starts[j]
            vals[:, j] = X[:, j]
        else:
            cols[:, j] = starts[j] + X[:, j].astype(np.int64) - lo
    indptr = np.arange(0, n * len(AIRLINE_COLUMNS) + 1, len(AIRLINE_COLUMNS))
    return sps.csr_matrix((vals.reshape(-1), cols.reshape(-1), indptr),
                          shape=(n, sum(widths)))


def thread_ranks(world: int, fn, timeout: float = 300.0,
                 name: str = "ranks") -> list:
    """Run ``fn(rank, group)`` for ranks 0..world-1 in threads of this
    process, each rank in its own gloo process group over one
    ``HashStore`` (``parallel.network.new_group``, so a mesh of it can be
    built) and inside ``parallel.network.use_group(group)``; returns the
    results in rank order.  Every join and every collective has
    ``timeout``; a rank's exception is raised here, and a rank still
    running after the timeout fails the call."""
    import threading

    import torch.distributed as dist

    from .parallel.network import new_group, use_group
    store = dist.HashStore()
    out, errs = [None] * world, []

    def run(r):
        try:
            pg = new_group(store, r, world, timeout, prefix=name)
            with use_group(pg):
                out[r] = fn(r, pg)
        except BaseException as e:   # noqa: BLE001 — re-raised below
            errs.append((r, e))

    threads = [threading.Thread(target=run, args=(r,), daemon=True)
               for r in range(world)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout)
    if errs:
        raise errs[0][1]
    if any(t.is_alive() for t in threads):
        raise TimeoutError(f"a rank of {world} ran past {timeout} s")
    return out


_ONE_THREAD = None


def __getattr__(name):
    global _ONE_THREAD
    if name != "one_thread":
        raise AttributeError(name)
    if _ONE_THREAD is None:
        import pytest
        import torch

        @pytest.fixture(autouse=True, scope="module")
        def one_thread():
            n = torch.get_num_threads()
            torch.set_num_threads(1)
            yield
            torch.set_num_threads(n)
        _ONE_THREAD = one_thread
    return _ONE_THREAD
