"""The port's configuration, bin mappers, Dataset and binning kernel
(plain version) held against the JAX package's.

``Config`` and ``BinMapper`` are copies and must resolve to the same
values; the Dataset's binned matrix, EFB layout and ``FeatureMeta`` must
be the same bytes; the plain version of the binning kernel
(``lightgbm_tpu_torch/ops/ingest.py``) must give the bytes of the JAX
``DeviceBinner`` in Pallas interpret mode and of the host oracle
``_bin_block``.  The CUDA kernel is held against the same oracle on the
card by chip_smoke.py.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

import lightgbm_tpu as lgb
from lightgbm_tpu import binning as jbin
from lightgbm_tpu.config import Config as JConfig
from lightgbm_tpu.ops import ingest as jing

import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch import binning as tbin
from lightgbm_tpu_torch.config import Config as TConfig
from lightgbm_tpu_torch.ops import ingest as ting
from lightgbm_tpu_torch.testing import one_thread  # noqa: F401

PARAMS = [
    {},
    {"objective": "binary", "num_leaves": 255, "max_bin": 255,
     "learning_rate": 0.1, "metric": "auc,binary_logloss"},
    {"application": "regression", "num_iterations": 7, "bagging_fraction":
     0.8, "bagging_freq": 1, "feature_fraction": 0.8, "min_data": 5},
    {"objective": "binary", "is_unbalance": True, "lambda_l1": 0.5,
     "reg_lambda": 2.0, "min_sum_hessian_in_leaf": 1.0,
     "tpu_round_width": 16, "tpu_hist_method": "fused",
     "tpu_tree_growth": "rounds", "zero_as_missing": True},
    {"boosting_type": "goss", "num_class": 1, "max_depth": 5,
     "metric": ["l2", "l1"], "use_missing": False, "seed": 3},
]


@pytest.mark.parametrize("params", PARAMS)
def test_config_resolves_like_the_jax_package(params):
    j = dataclasses.asdict(JConfig.from_params(dict(params)))
    t = dataclasses.asdict(TConfig.from_params(dict(params)))
    assert t == j
    assert (TConfig.from_params(dict(params)).split_hyperparams()._asdict()
            == JConfig.from_params(dict(params)).split_hyperparams()
            ._asdict())


def _columns(seed=0, n=1500):
    rng = np.random.RandomState(seed)
    normal = rng.randn(n)
    nan = rng.randn(n) * 3
    nan[rng.rand(n) < 0.1] = np.nan
    zeros = np.where(rng.rand(n) < 0.4, 0.0, rng.exponential(2.0, n))
    return {
        "normal": normal, "nan": nan, "zeros": zeros,
        "constant": np.full(n, 1.5),
        "few_unique": rng.choice([-1.0, 0.0, 2.5], n),
        "integers": rng.randint(0, 40, n).astype(np.float64),
        "f32_grid": rng.randn(n).astype(np.float32).astype(np.float64),
    }


@pytest.mark.parametrize("max_bin", [15, 63, 255])
@pytest.mark.parametrize("zero_as_missing", [False, True])
def test_bin_mappers_match(max_bin, zero_as_missing):
    for name, col in _columns().items():
        keep = np.isnan(col) | (np.abs(col) > 1e-35)
        out = []
        for mod in (jbin, tbin):
            m = mod.BinMapper()
            m.find_bin(col[keep], len(col), max_bin, min_data_in_bin=3,
                       min_split_data=20, pre_filter=True,
                       zero_as_missing=zero_as_missing)
            out.append(m)
        j, t = out
        jb = np.asarray(j.bin_upper_bound, np.float64)
        tb = np.asarray(t.bin_upper_bound, np.float64)
        assert jb.tobytes() == tb.tobytes(), name
        for attr in ("num_bin", "missing_type", "default_bin",
                     "most_freq_bin", "is_trivial", "min_val", "max_val"):
            assert np.asarray(getattr(j, attr)).tobytes() == \
                np.asarray(getattr(t, attr)).tobytes(), (name, attr)


def _matrix(seed=1, n=1500, dtype=np.float32):
    cols = _columns(seed, n)
    return np.stack(list(cols.values()), axis=1).astype(dtype)


def _pair(X, params):
    y = np.arange(len(X)) % 2
    j = lgb.Dataset(X, label=y, params=dict(params)).construct()
    t = lt.Dataset(X, label=y, params=dict(params), device="cpu").construct()
    return j, t


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("params", [
    {"max_bin": 63}, {"max_bin": 255, "zero_as_missing": True},
    {"max_bin": 31, "enable_bundle": False}])
def test_dataset_bytes_match(dtype, params):
    X = _matrix(dtype=dtype)
    j, t = _pair(X, params)
    assert t.used_features == j.used_features
    assert np.array_equal(t.feat_group, j.feat_group)
    assert np.array_equal(t.feat_start, j.feat_start)
    assert t.binned_dtype() == j.binned_dtype()
    assert t.binned_shape() == j.binned_shape()
    hb = t.host_binned()
    assert hb.dtype == j.binned.dtype
    assert np.array_equal(hb, j.binned)
    jm, tm = j.feature_meta(), t.feature_meta()
    for f in ("num_bin", "missing_type", "default_bin", "most_freq_bin",
              "is_categorical", "feat_group", "feat_start"):
        assert np.array_equal(getattr(jm, f), getattr(tm, f)), f
    for f in ("max_num_bin", "num_groups", "max_group_bin"):
        assert getattr(jm, f) == getattr(tm, f), f


def test_efb_groups_match():
    """Sparse, mutually exclusive columns bundle the same way."""
    rng = np.random.RandomState(4)
    n = 2000
    X = np.zeros((n, 8), np.float32)
    owner = rng.randint(0, 8, n)
    X[np.arange(n), owner] = rng.rand(n).astype(np.float32) + 0.5
    j, t = _pair(X, {"max_bin": 15})
    assert j.num_groups < 8          # the columns did bundle
    assert np.array_equal(t.feat_group, j.feat_group)
    assert np.array_equal(t.feat_start, j.feat_start)
    assert np.array_equal(t.host_binned(), j.binned)


def test_create_valid_bins_with_the_reference_mappers():
    X = _matrix()
    j, t = _pair(X, {"max_bin": 63})
    Xv = _matrix(seed=9, n=400)
    jv = j.create_valid(Xv, label=np.zeros(400)).construct()
    tv = t.create_valid(Xv, label=np.zeros(400)).construct()
    assert tv.device == t.device
    assert np.array_equal(tv.host_binned(), jv.binned)


@pytest.mark.parametrize("params", [{"max_bin": 63},
                                    {"max_bin": 15, "zero_as_missing": True}])
def test_binning_plain_version_matches_jax_kernel_and_oracle(params):
    X = _matrix()
    X[:, 5] = np.floor(np.abs(X[:, 5]))        # a categorical column
    params = dict(params, categorical_feature=[5], enable_bundle=False)
    j, t = _pair(X, params)
    rows = np.concatenate([
        jing.salt_rows(X.shape[1], X), ting.salt_rows(X.shape[1], X),
        _matrix(seed=7, n=700)]).astype(np.float32)
    rows[-50:, 5] = np.array([-3.0, 1e9, 7.7, -0.5, 2 ** 31] * 10,
                             np.float32)
    jt = jing.build_ingest_tables(j)
    tt = ting.build_ingest_tables(t)
    assert np.array_equal(jt.bounds, tt.bounds)
    assert np.array_equal(jt.cats, tt.cats)
    got = ting.DeviceBinner(tt, "cpu")(torch.from_numpy(rows))
    assert got.dtype == torch.uint8 and got.shape == (t.num_groups,
                                                       len(rows))
    jax_out = np.asarray(jing.DeviceBinner(jt, tile_rows=256,
                                           interpret=True)(rows))
    oracle = np.zeros((len(rows), t.num_groups), np.uint8)
    with np.errstate(invalid="ignore"):
        t._bin_block(rows.astype(np.float64), oracle)
    assert np.array_equal(got.numpy().T, jax_out)
    assert np.array_equal(got.numpy().T, oracle)


def test_binner_refuses_bad_input():
    X = _matrix()
    _, t = _pair(X, {"max_bin": 15, "enable_bundle": False})
    binner = ting.DeviceBinner(ting.build_ingest_tables(t), "cpu")
    with pytest.raises(ValueError):
        binner(torch.zeros((4, X.shape[1]), dtype=torch.float64))
    with pytest.raises(ValueError):
        binner(torch.zeros((4, X.shape[1] + 1), dtype=torch.float32))


def test_dataset_refuses_input_it_does_not_bin(tmp_path):
    """A forced-bins file that does not exist is refused as the JAX
    package refuses it; one that exists bins as the JAX package bins
    (forced bins on every input route: tests/test_torch_cegb_forced.py;
    text files, sparse and pandas input:
    tests/test_torch_dataset_formats.py)."""
    X = _matrix()
    missing = {"forcedbins_filename": str(tmp_path / "bins.json")}
    for mod, kw in ((lt, {"device": "cpu"}), (lgb, {})):
        with pytest.raises(FileNotFoundError):
            mod.Dataset(X, params=dict(missing), **kw).construct()
    with open(missing["forcedbins_filename"], "w") as fh:
        fh.write('[{"feature": 1, "bin_upper_bound": [-0.5, 0.25, 1.5]}]')
    j, t = _pair(X, dict(missing, max_bin=15))
    # as JSON, where NaN bounds compare equal
    assert json.dumps([m.to_dict() for m in j.bin_mappers]) == \
        json.dumps([m.to_dict() for m in t.bin_mappers])
    assert np.asarray(j.binned).tobytes() == t.host_binned().tobytes()


# ----------------------------------------------------------------------
# the kernel's own tables (ragged, staged in shared memory) and its
# launch plan; the kernel runs only on the card, where chip_smoke.py holds
# it against _bin_block byte for byte
# ----------------------------------------------------------------------

def _tables(params, categorical=True, bundle=True):
    X = _matrix()
    if categorical:
        X[:, 5] = np.floor(np.abs(X[:, 5]))
        params = dict(params, categorical_feature=[5])
    params = dict(params, enable_bundle=bundle)
    _, t = _pair(X, params)
    return X, t, ting.build_ingest_tables(t)


def _descend(tree, h, x, less):
    """The kernel's descent of a BFS-order search tree: the leaf reached
    (i - 2^h is the count of entries ``less`` than x) and the last node
    left to the left (0 if none)."""
    i = np.ones(len(x), np.int64)
    cand = np.zeros(len(x), np.int64)
    for _ in range(h):
        go = less(tree[i - 1], x)
        cand = np.where(go, cand, i)
        i = 2 * i + go
    return i, cand


def _member_bins(X, kt, m):
    """Member m's bins by the kernel's lookups over the ragged tables,
    in numpy: descents of its feature's search tree."""
    column, start, flags, nb, off, h = kt.members[m]
    size = (1 << h) - 1
    v = X[:, column]
    nan = np.isnan(v)
    if flags & ting.FLAG_CAT:
        codes = kt.words[off:off + size]
        where = kt.words[off + size:off + 2 * size]
        miss = nan | (np.abs(v) >= 2.0 ** 31)
        iv = np.where(miss, -1, np.trunc(np.where(miss, 0, v)))
        _, cand = _descend(codes, h, iv, np.less)
        hit = (iv >= 0) & (cand > 0)
        hit &= codes[np.maximum(cand, 1) - 1] == iv
        b = np.where(hit, where[np.maximum(cand, 1) - 1], nb - 1)
    else:
        tree = kt.words[off:off + size].view(np.float32)
        leaf, _ = _descend(tree, h, np.where(nan, 0, v)
                           .astype(np.float32), np.less)
        b = leaf - (1 << h)
        if flags & ting.FLAG_NAN_LAST:
            b = np.where(nan, nb - 1, b)
    return b


def _kernel_model(X, kt, G):
    """The kernel's lookups, then the EFB fold in member order."""
    out = np.zeros((G, len(X)), np.int64)
    for g in range(G):
        for m in range(kt.group_ptr[g], kt.group_ptr[g + 1]):
            b = _member_bins(X, kt, m)
            out[g] = np.where(b != 0, kt.members[m, 1] + b - 1, out[g])
    return out


def _warp_split_model(X, kt, G, warps):
    """The kernel's split of a chunk's members over its warps, in numpy:
    warp w folds members [w M / W, (w + 1) M / W); a group wholly inside
    is stored, a shared one leaves partials (-1: no non-zero bin) in
    slot 0 (the group the warp starts in) or 1 (the group it ends in),
    which the warp where the group starts folds in warp order."""
    gp = kt.group_ptr.astype(np.int64)
    M = int(gp[-1])
    out = np.full((G, len(X)), -7, np.int64)
    part = np.full((warps, 2, len(X)), -9, np.int64)
    span = [(w * M // warps, (w + 1) * M // warps) for w in range(warps)]

    def group_of(m):
        return int(np.searchsorted(gp, m, side="right") - 1)

    for w, (mb, me) in enumerate(span):
        m, g = mb, (group_of(mb) if mb < me else 0)
        while m < me:
            end = min(gp[g + 1], me)
            col = np.full(len(X), -1, np.int64)
            for k in range(m, end):
                b = _member_bins(X, kt, k)
                col = np.where(b != 0, kt.members[k, 1] + b - 1, col)
            m = end
            head, tail = gp[g] < mb, gp[g + 1] > me
            if head:
                part[w, 0] = col
            if tail:
                part[w, 1] = col
            if not (head or tail):
                out[g] = np.maximum(col, 0)
            g += 1
    for w, (mb, me) in enumerate(span):
        if mb == me:
            continue
        g = group_of(me - 1)
        if not (gp[g] >= mb and gp[g + 1] > me):
            continue
        w_end = (int(gp[g + 1]) * warps + M - 1) // M - 1
        col = np.zeros(len(X), np.int64)
        for v in range(w, w_end + 1):
            if span[v][0] == span[v][1]:
                continue
            p = part[v, 1 if v == w else 0]
            col = np.where(p >= 0, p, col)
        out[g] = col
    return out


def _in_order(tree):
    """A BFS-order tree's entries in in-order (sorted) order."""
    order, stack, i = [], [], 1
    while stack or i <= len(tree):
        while i <= len(tree):
            stack.append(i)
            i *= 2
        i = stack.pop()
        order.append(i - 1)
        i = 2 * i + 1
    return np.asarray(tree)[order]


@pytest.mark.parametrize("params", [{"max_bin": 63},
                                    {"max_bin": 15, "zero_as_missing": True},
                                    {"max_bin": 255}])
def test_ragged_tables_give_back_every_feature(params):
    X, t, tables = _tables(params)
    kt = ting.kernel_tables(tables)
    assert kt.group_ptr[-1] == len(tables.specs)
    by_group = sorted(range(len(tables.specs)),
                      key=lambda i: (tables.specs[i].group, i))
    for rec, i in zip(kt.members, by_group):
        s = tables.specs[i]
        column, start, flags, nb, off, h = rec
        size = (1 << h) - 1
        assert (column, start, nb) == (s.column, s.start, s.num_bin)
        assert bool(flags & ting.FLAG_CAT) == s.is_cat
        assert bool(flags & ting.FLAG_NAN_LAST) == s.nan_as_last
        if s.is_cat:
            row = tables.cats[s.row]
            real = int((row >= 0).sum())
            assert h == real.bit_length()
            codes = _in_order(kt.words[off:off + size])
            where = _in_order(kt.words[off + size:off + 2 * size])
            assert np.all(np.diff(codes[:real]) > 0)
            assert (codes[real:] == np.iinfo(np.int32).max).all()
            assert np.array_equal(row[where[:real]], codes[:real])
            assert set(where[:real]) == set(np.nonzero(row >= 0)[0])
        else:
            bounds = ting.ragged_bounds(tables, s.row)
            row = tables.bounds[s.row]
            assert np.isposinf(row[len(bounds):]).all()
            assert h == len(bounds).bit_length()
            got = _in_order(kt.words[off:off + size].view(np.float32))
            assert np.array_equal(got[:len(bounds)], bounds)
            assert np.isposinf(got[len(bounds):]).all()
    groups = [s.group for s in tables.specs]
    for g in range(tables.num_groups):
        a, b = kt.group_ptr[g], kt.group_ptr[g + 1]
        assert b - a == groups.count(g)
        if b > a:
            last = kt.members[b - 1]
            width = ((1 << last[5]) - 1) * (2 if last[2] & ting.FLAG_CAT
                                            else 1)
            assert kt.group_words[g] == kt.members[a, 4]
            assert kt.group_words[g + 1] == last[4] + width
    rows = np.concatenate([ting.salt_rows(X.shape[1], X),
                           _matrix(seed=7, n=700)]).astype(np.float32)
    rows[-50:, 5] = np.array([-3.0, 1e9, 7.7, -0.5, 2 ** 31] * 10,
                             np.float32)
    plain = ting.DeviceBinner(tables, "cpu")(torch.from_numpy(rows))
    assert np.array_equal(_kernel_model(rows, kt, tables.num_groups),
                          plain.numpy())


@pytest.mark.parametrize("warps", [1, 3, 16, 200])
def test_warps_split_groups_by_members(warps):
    """The kernel's even split of a chunk's members over its warps, with
    the partials of shared groups folded in warp order, gives the EFB
    fold's bins: on the one-hot airline table (groups of 1 to ~230
    members) and rows that set many members of a group at once, with
    more warps than members too."""
    from lightgbm_tpu_torch.testing import airline_like, one_hot
    X8, y = airline_like(3000, seed=5)
    X = one_hot(X8)
    ds = lt.Dataset(X, label=y, device="cpu").construct()
    tables = ting.build_ingest_tables(ds)
    kt = ting.kernel_tables(tables)
    assert np.diff(kt.group_ptr).max() > 16      # a group spans warps
    # rows where many members of a bundle are non-zero at once: the
    # fold keeps the last, so the partials' order decides the bin
    clash = (np.random.RandomState(warps).rand(200, X.shape[1]) < 0.3)
    rows = np.concatenate([X[:300], clash.astype(np.float32),
                           np.ones((2, X.shape[1]), np.float32)])
    want = ting.DeviceBinner(tables, "cpu")(torch.from_numpy(rows)).numpy()
    got = _warp_split_model(rows, kt, tables.num_groups, warps)
    assert np.array_equal(got, want)


def _check_plan(plan, kt, num_features):
    """A plan's chunks cover every member once, in member order within
    each group (a split group's parts over successive launches, the
    first writing every row), each chunk's shared memory fits the plan's
    and the card's, and each member's column is in its chunk's list."""
    from lightgbm_tpu_torch.ops import planner
    gp = kt.group_ptr
    M = int(gp[-1])
    seen = np.zeros(M, np.int64)
    assert plan.tile_rows in planner.INGEST_TILE_ROWS
    assert plan.threads in planner.INGEST_THREADS
    assert plan.smem_bytes <= planner.SMEM_MAX_BYTES
    parts = {}
    assert plan.mode(0) == (planner.MODE_WHOLE_ROWS if plan.whole_rows
                            else planner.MODE_GATHERED)
    for j, launch in enumerate(plan.launches):
        if j:
            assert plan.mode(j) == planner.MODE_OVERLAY
        for g0, g1, m0, m1, w0, w1, c0, c1 in launch:
            assert 0 <= g0 < g1 and m0 < m1 and c0 < c1
            assert gp[g0] <= m0 and m1 <= gp[g1]
            assert (w0, w1) == (kt.members[m0, 4],
                                kt.members[m1, 4] if m1 < M
                                else kt.group_words[-1])
            seen[m0:m1] += 1
            cols = np.asarray(plan.columns[c0:c1])
            whole = plan.whole_rows
            if whole:
                assert np.array_equal(cols, np.arange(num_features))
            else:
                assert np.all(np.diff(cols) > 0)
            for m in range(m0, m1):
                assert cols[plan.local_column[m]] == kt.members[m, 0]
            tables = 4 * (6 * (m1 - m0) + (g1 - g0 + 1) + (w1 - w0)
                          + (0 if whole else c1 - c0))
            assert (planner._ingest_tile_bytes(c1 - c0, plan.tile_rows,
                                               plan.threads)
                    + tables <= plan.smem_bytes)
            if gp[g0] < m0 or m1 < gp[g1]:
                assert g1 == g0 + 1                  # a part of one group
                parts.setdefault(g0, []).append((j, m0, m1))
            else:
                assert j == 0
    assert np.all(seen == 1)
    for g, ps in parts.items():
        assert [p[0] for p in ps] == list(range(len(ps)))
        assert ps[0][1] == gp[g] and ps[-1][2] == gp[g + 1]
        assert all(a[2] == b[1] for a, b in zip(ps, ps[1:]))


def _plan(kt, num_features):
    return ting.plan_tables(num_features, kt)


@pytest.mark.parametrize("budget", [None, 2048, 700])
def test_ingest_plan_chunks_fit_and_cover(budget, monkeypatch):
    from lightgbm_tpu_torch.ops import planner
    _, _, tables = _tables({"max_bin": 63}, bundle=False)
    kt = ting.kernel_tables(tables)
    if budget is not None:
        monkeypatch.setattr(planner, "INGEST_TABLE_BYTES", budget)
    plan = _plan(kt, tables.num_features)
    _check_plan(plan, kt, tables.num_features)
    chunks = [c for launch in plan.launches for c in launch]
    assert len(plan.launches) == 1                # no group is split
    if budget is None:
        assert len(chunks) == 1
        assert chunks[0][7] - chunks[0][6] == tables.num_features
    if budget == 700:
        assert len(chunks) > 1
    grid = planner.ingest_grid(plan, 1_000_000)
    assert 1 <= grid <= planner.SM_COUNT * 8
    assert planner.ingest_grid(plan, 5) == 1
    # a table budget below one member's tables no longer refuses: the
    # chunks stage their own columns and the groups split into parts
    monkeypatch.setattr(planner, "INGEST_TABLE_BYTES", 16)
    monkeypatch.setattr(planner, "INGEST_SMEM_TARGET", 4096)
    plan = _plan(kt, tables.num_features)
    _check_plan(plan, kt, tables.num_features)
    assert not plan.whole_rows
    assert all(c[3] - c[2] == 1 for launch in plan.launches
               for c in launch)


def test_ingest_plan_refuses_rows_too_wide():
    """Only a member whose own tables exceed the card's shared memory is
    refused; the widest rows are not (they stage a chunk's columns)."""
    from lightgbm_tpu_torch.ops import planner
    with pytest.raises(ValueError, match="exceed the card"):
        planner.ingest_plan(3, [0, 1], [0, 60_000], [2])
    plan = planner.ingest_plan(100_000, [0, 1], [0, 255], [99_999])
    assert plan.columns == (99_999,) and plan.local_column == (0,)


def _wide_tables(num_features, seed=0, n=400):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, num_features).astype(np.float32)
    X[rng.rand(n, num_features) < 0.1] = np.nan
    ds = lt.Dataset(X, label=rng.rand(n).astype(np.float32), device="cpu",
                    params={"max_bin": 63}).construct()
    return X, ds, ting.build_ingest_tables(ds)


@pytest.mark.parametrize("num_features", [2000, 5000])
def test_ingest_plan_takes_wide_rows(num_features):
    """2,000 and 5,000 features: chunks of their own columns, each within
    the card's shared memory, covering every member; the kernel's bins
    over that plan (numpy model) equal the plain version's."""
    from lightgbm_tpu_torch.ops import planner
    X, ds, tables = _wide_tables(num_features)
    kt = ting.kernel_tables(tables)
    plan = _plan(kt, tables.num_features)
    _check_plan(plan, kt, tables.num_features)
    chunks = plan.launches[0]
    assert len(plan.launches) == 1 and len(chunks) > 1
    assert not plan.whole_rows
    assert all(c[7] - c[6] < num_features for c in chunks)
    assert plan.smem_bytes <= planner.INGEST_SMEM_TARGET
    if num_features == 2000:
        rows = X[:120]
        want = ting.DeviceBinner(tables, "cpu")(torch.from_numpy(rows))
        assert np.array_equal(_plan_model(rows, kt, plan, tables.num_groups),
                              want.numpy())


def test_ingest_plan_splits_a_group_of_2000_members():
    """One group of 2,000 members (tables of 2,000 two-word runs and
    records) is cut into member parts over successive launches."""
    from lightgbm_tpu_torch.ops import planner
    M = 2000
    gp = [0, M]
    words = np.arange(M + 1) * 3
    plan = planner.ingest_plan(M, gp, words, np.arange(M))
    assert len(plan.launches) > 1
    assert all(len(launch) == 1 for launch in plan.launches)
    assert [plan.mode(j) for j in range(len(plan.launches))] == \
        [planner.MODE_GATHERED] + [planner.MODE_OVERLAY] * (
            len(plan.launches) - 1)
    assert plan.launches[0][0][2] == 0 and plan.launches[-1][0][3] == M
    assert plan.smem_bytes <= planner.SMEM_MAX_BYTES


def _plan_model(X, kt, plan, G, part_order=None):
    """The kernel over a plan, in numpy: launches in order (or the split
    groups' parts in ``part_order``), each chunk's members fold their
    non-zero bins in member order through their chunk's column list; a
    chunk stores its bins (0 where no member's bin is non-zero), a chunk
    of an overlay launch only the non-zero ones."""
    from lightgbm_tpu_torch.ops import planner
    out = np.full((G, len(X)), -5, np.int64)
    chunks = [c + (plan.mode(j) == planner.MODE_OVERLAY,)
              for j, launch in enumerate(plan.launches) for c in launch]
    if part_order is not None:
        chunks = part_order(chunks)
    for g0, g1, m0, m1, w0, w1, c0, c1, overlay in chunks:
        cols = np.asarray(plan.columns[c0:c1])
        for g in range(g0, g1):
            a = max(int(kt.group_ptr[g]), m0)
            b = min(int(kt.group_ptr[g + 1]), m1)
            col = np.full(len(X), -1, np.int64)
            for m in range(a, b):
                rec = kt.members.copy()
                rec[m, 0] = cols[plan.local_column[m]]
                bins = _member_bins(X, kt._replace(members=rec), m)
                col = np.where(bins != 0, kt.members[m, 1] + bins - 1, col)
            if overlay:
                out[g] = np.where(col >= 0, col, out[g])
            else:
                out[g] = np.maximum(col, 0)
    return out


def test_split_groups_fold_in_part_order(monkeypatch):
    """A small shared-memory target splits the one-hot airline table's
    EFB groups into member parts: the parts, applied launch by launch,
    give the plain version's bins on rows where several members of a
    group are non-zero at once (EFB conflicts); applied in the reverse
    order they do not."""
    from lightgbm_tpu_torch.ops import planner
    from lightgbm_tpu_torch.testing import airline_like, one_hot
    X8, y = airline_like(3000, seed=5)
    X = one_hot(X8)
    ds = lt.Dataset(X, label=y, device="cpu").construct()
    tables = ting.build_ingest_tables(ds)
    kt = ting.kernel_tables(tables)
    monkeypatch.setattr(planner, "INGEST_TABLE_BYTES", 512)
    monkeypatch.setattr(planner, "INGEST_SMEM_TARGET", 6000)
    plan = _plan(kt, tables.num_features)
    _check_plan(plan, kt, tables.num_features)
    assert len(plan.launches) > 2
    clash = (np.random.RandomState(3).rand(150, X.shape[1]) < 0.3)
    rows = np.concatenate([X[:200], clash.astype(np.float32),
                           np.ones((2, X.shape[1]), np.float32)])
    want = ting.DeviceBinner(tables, "cpu")(torch.from_numpy(rows)).numpy()
    got = _plan_model(rows, kt, plan, tables.num_groups)
    assert np.array_equal(got, want)

    def parts_reversed(chunks):
        # every split group's parts in reverse member order, the last
        # one writing every row
        by_group = {}
        for c in chunks:
            by_group.setdefault((c[0], c[1]), []).append(c)
        out = []
        for cs in by_group.values():
            if len(cs) > 1 or cs[0][8]:
                cs = [c[:8] + (int(i > 0),)
                      for i, c in enumerate(sorted(cs, key=lambda c: -c[2]))]
            out.extend(cs)
        return out
    bad = _plan_model(rows, kt, plan, tables.num_groups,
                      part_order=parts_reversed)
    assert not np.array_equal(bad, want)
