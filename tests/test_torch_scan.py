"""Kernel B5's design (lightgbm_tpu_torch/ops/csrc/fused.cu scan_kernel)
held on the CPU, where the kernel cannot run:

- ``kernel_model`` is a lane-level numpy model of the kernel: the
  planner's warp tasks (``ops.planner.scan_plan``), 32-bin chunks with a
  carried prefix, segmented warp-shuffle scans and arg-max reductions
  (emulated shuffle by shuffle), each lane's own best finite gain of
  each direction with the tie rules, the int8 mode's first pass for the
  hess total, the "no valid threshold" tuple at bin B - 1 written from
  the carried prefix, and, in leaf mode on the
  staged arm, the reads of the group histograms (bin 0 rebuilt from the
  child's total).  It must equal the plain version
  (``ops.fused.scan_plain``, which is ``ops.split.numeric_feature_scan``
  after ``quant_count_hist`` in the int8 mode) bit for bit on random
  integer histograms, every mode, f32 and int8, num_bin 2, 33 and 1023;
  the kernel is held to the same plain version on the card by
  ``chip_smoke.py``.
- The grouped leaf-mode entry (``sibling_scan`` with a ``GroupLayout``)
  and the model on group histograms equal the expansion followed by
  ``scan_plain``, bit for bit, with NaN- and zero-missing features,
  single-feature groups and bundles, and, through
  ``feature_best_splits``, a native categorical column beside bundles.
  The expansion they are held to is ``np_expand``, written here in numpy
  from the layout's meaning; ``ops.fused.expand_groups`` (the entry's
  plain version on the CPU) is held to it too.
- The planner's tasks cover every (child, feature) pair exactly once;
  the grower plans them once a tree and hands that plan to every scan.

Equality is bitwise (f32 fields compared as int32 words).
"""

import numpy as np
import pytest
import torch

from lightgbm_tpu_torch.dataset import FeatureMeta
from lightgbm_tpu_torch.grower import GrowerConfig
from lightgbm_tpu_torch.grower_rounds import group_layout, grow_tree_rounds
from lightgbm_tpu_torch.ops import fused as TFU
from lightgbm_tpu_torch.ops import planner
from lightgbm_tpu_torch.ops.histogram import (_vals_t, _vals_t_int,
                                              accumulate_plain,
                                              fixed_point_scales)
from lightgbm_tpu_torch.ops.split import (QuantScales, SplitHyperparams,
                                          channel_multipliers,
                                          feature_best_splits, fixed_to_f32,
                                          random_thresholds)
from lightgbm_tpu_torch.testing import one_thread  # noqa: F401

FIELDS = ("gain", "threshold", "default_left", "left_sum_grad",
          "left_sum_hess", "left_count")
L = np.arange(32)
f32 = np.float32
EPS = f32(1e-15)
TWO_EPS = f32(2e-15)
NEG_INF = f32(-np.inf)


def _bits(x: torch.Tensor) -> np.ndarray:
    x = x.detach().cpu()
    if x.dtype == torch.float32:
        x = x.view(torch.int32)
    return x.to(torch.int64).numpy()


def assert_same_bits(a, b, what=""):
    for name in FIELDS:
        x, y = _bits(torch.as_tensor(getattr(a, name))), \
            _bits(torch.as_tensor(getattr(b, name)))
        assert np.array_equal(x, y), (what, name, np.argwhere(x != y)[:5])


# ----------------------------------------------------------------------
# the lane-level model of scan_kernel
# ----------------------------------------------------------------------

def _seg_scan(v, seg):
    """Inclusive shfl_up scan within each lane's segment."""
    v = v.copy()
    for o in (1, 2, 4, 8, 16):
        y = np.concatenate([v[:o], v[:-o]])          # __shfl_up_sync
        v = np.where(L - o >= seg, v + y, v)
    return v


def _better(a, b, last):
    av, ai, ao = a
    bv, bi, bo = b
    tie = (ai > bi) if last else (ai < bi)
    return ao & (~bo | (av > bv) | ((av == bv) & tie))


def _seg_argmax(a, seg_end, last):
    """Suffix reduction by shfl_down within [lane, seg_end)."""
    v, i, ok = (x.copy() for x in a)
    for o in (1, 2, 4, 8, 16):
        def down(x):
            return np.concatenate([x[o:], x[-o:]])   # __shfl_down_sync
        b = (down(v), down(i), down(ok))
        take = (L + o < seg_end) & _better(b, (v, i, ok), last)
        v, i, ok = (np.where(take, x, y) for x, y in zip(b, (v, i, ok)))
    return v, i, ok


def _to_f32(p, m):
    return (np.asarray(p).astype(np.float64) * m).astype(f32)


def kernel_model(small, scales, sums, num_bin, missing_type, default_bin,
                 hp, mono=None, bounds=None, rand_thr=None, groups=None):
    """Leaf mode of scan_kernel, lane by lane: ``small`` [NC, C, F, B]
    (or the group histograms [NC, C, G, Bg] with ``groups``); returns the
    six [NC, F] tuples and asserts that every (child, feature) is written
    by exactly one lane."""
    quant = isinstance(scales, QuantScales)
    h = small.numpy().astype(np.int64)
    NC, C = h.shape[:2]
    nbv = num_bin.numpy().astype(np.int64)
    mtv = missing_type.numpy().astype(np.int64)
    dbv = default_bin.numpy().astype(np.int64)
    F = len(nbv)
    if groups is None:
        B = h.shape[3]
    else:
        B = int(groups.num_bins)
        Bg = h.shape[3]
        fgv = groups.feat_group.numpy().astype(np.int64)
        fsv = groups.feat_start.numpy().astype(np.int64)
    plan = planner.scan_plan(nbv.tolist(), B)
    lanes = np.array(plan.lanes, np.int64).reshape(plan.tasks, 32)
    mult = channel_multipliers(scales)
    l1, l2 = f32(hp.lambda_l1), f32(hp.lambda_l2)
    min_gain, min_data = f32(hp.min_gain_to_split), f32(hp.min_data_in_leaf)
    min_hess, mds = f32(hp.min_sum_hessian_in_leaf), f32(hp.max_delta_step)
    sums = sums.numpy().astype(f32)
    outs = {"gain": np.zeros((NC, F), f32), "threshold": np.zeros(
        (NC, F), np.int32), "default_left": np.zeros((NC, F), bool),
        "left_sum_grad": np.zeros((NC, F), f32),
        "left_sum_hess": np.zeros((NC, F), f32),
        "left_count": np.zeros((NC, F), f32)}
    written = np.zeros((NC, F), int)

    def thr_l1(g):
        if hp.lambda_l1 <= 0:
            return g
        return np.sign(g).astype(f32) * np.maximum(np.abs(g) - l1, f32(0))

    def leaf_gain(g, hh):
        sg = thr_l1(g)
        return (sg * sg) / (hh + l2)

    def leaf_out(g, hh):
        o = -thr_l1(g) / (hh + l2)
        return np.minimum(mds, np.maximum(-mds, o)) if hp.max_delta_step > 0 \
            else o

    def gain_given(g, hh, o):
        sg = thr_l1(g)
        return -(f32(2.0) * sg * o + (hh + l2) * o * o)

    for c in range(NC):
        sg, sh, cnt = sums[0, c], sums[1, c], sums[2, c]
        tot = h[c, :, 0, :].sum(-1) if groups is not None else None
        total_h = sh + TWO_EPS
        mgs = leaf_gain(sg, total_h) + min_gain
        lo_b = f32(bounds[0][c]) if bounds is not None else NEG_INF
        hi_b = f32(bounds[1][c]) if bounds is not None else f32(np.inf)
        for t in range(plan.tasks):
            e = lanes[t]
            mine = e >= 0
            f = np.where(mine, e, e[0]) >> 5
            seg = np.where(mine, e & 31, L)
            nb = nbv[f]
            nbw = np.maximum(np.minimum(nb, B), 1)
            wide = nbw > 32
            seg_end = np.where(mine, np.where(wide, 32, seg + nbw), L + 1)
            chunks = int((nbw[0] + 31) // 32) if wide[0] else 1
            mt = mtv[f]
            has_md = (mt != 0) & (nb > 2)
            miss = np.where(mt == 2, nb - 1, np.where(mt == 1, dbv[f], -1))
            miss = np.where(has_md, miss, -1)

            def cell(ff, ch, b):
                ok = (b >= 0) & (b < B)
                return np.where(ok, h[c, ch, ff, np.clip(b, 0, B - 1)], 0)

            def gcell(ch, b):
                ok = (b >= 1) & (b < nb) & (b < B)
                idx = np.clip(fsv[f] + b - 1, 0, Bg - 1)
                return np.where(ok, h[c, ch, fgv[f], idx], 0)

            rest = np.zeros((C, 32), np.int64)
            htot = np.zeros(32, np.int64)
            if groups is not None:
                for kc in range(chunks):
                    b = kc * 32 + L - seg
                    m = mine & (b < nbw)
                    for ch in range(C):
                        rest[ch] += np.where(m, gcell(ch, b), 0)
                for ch in range(C):
                    rest[ch] = _seg_scan(rest[ch], seg)[seg_end - 1]
                if quant:
                    htot[:] = tot[1]
            elif quant:
                for s in range(32):
                    if mine[s] and seg[s] == s:     # a segment's first lane
                        htot[seg == s] = h[c, 1, f[s], :].sum()

            def value(ch, b):
                if groups is not None:
                    return np.where(b == 0, tot[ch] - rest[ch],
                                    gcell(ch, b))
                return cell(f, ch, b)

            cf = cnt / np.maximum(htot.astype(f32), f32(1))

            def count(x):
                return np.rint(x.astype(f32) * cf).astype(np.int64)

            mm = mine & (miss >= 0) & (miss < B)
            mv = np.zeros((3, 32), np.int64)
            for ch in range(C):
                mv[ch] = np.where(mm, value(ch, miss), 0)
            if quant:
                mv[2] = np.where(mm, count(mv[1]), 0)
            ms = [_to_f32(mv[ch], mult[ch]) for ch in range(3)]
            mc = mono.numpy()[f] if mono is not None else None
            rt = rand_thr.numpy()[c, f] if rand_thr is not None else None
            na_dir = (has_md & (mt == 2)).astype(np.int64)

            def eval_dir(lg, lh, lc):
                rg, rh, rc = sg - lg, total_h - lh, cnt - lc
                ok = ((lc >= min_data) & (rc >= min_data) & (lh >= min_hess)
                      & (rh >= min_hess))
                if mc is None:
                    gain = leaf_gain(lg, lh) + leaf_gain(rg, rh)
                else:
                    lo, ro = leaf_out(lg, lh), leaf_out(rg, rh)
                    if bounds is not None:
                        lo = np.minimum(hi_b, np.maximum(lo_b, lo))
                        ro = np.minimum(hi_b, np.maximum(lo_b, ro))
                    bad = ((mc > 0) & (lo > ro)) | ((mc < 0) & (lo < ro))
                    gain = gain_given(lg, lh, lo) + gain_given(rg, rh, ro)
                    gain = np.where(bad, NEG_INF, gain)
                return np.where(ok & (gain > mgs), gain, NEG_INF), lg, lh, lc

            carry = np.zeros((3, 32), np.int64)
            best = {d: [np.full(32, NEG_INF), np.zeros(32, np.int64),
                        np.zeros(32, bool), np.zeros(32, f32),
                        np.zeros(32, f32), np.zeros(32, f32)]
                    for d in "lr"}
            for kc in range(chunks):
                b = kc * 32 + L - seg
                inb = mine & (b < nbw)
                keep = inb & (b < nb) & (b != miss)
                x = np.zeros((3, 32), np.int64)
                for ch in range(C):
                    x[ch] = np.where(keep, value(ch, b), 0)
                if quant:
                    x[2] = np.where(keep, count(x[1]), 0)
                for ch in range(3):
                    x[ch] = _seg_scan(x[ch], seg) + carry[ch]
                    carry[ch] = x[ch][seg_end - 1]        # __shfl_sync
                pf = [_to_f32(x[ch], mult[ch]) for ch in range(3)]
                dr = eval_dir(pf[0], pf[1] + EPS, pf[2])
                dl = eval_dir(pf[0] + ms[0], (pf[1] + ms[1]) + EPS,
                              pf[2] + ms[2])
                t_valid = (inb & (b < nb - 1 - na_dir)
                           & ~((mt == 1) & (b == miss)))
                if rt is not None:
                    t_valid &= b == rt
                g = {"r": np.where(t_valid & has_md, dr[0], NEG_INF),
                     "l": np.where(t_valid, dl[0], NEG_INF)}
                for d, res in (("l", dl), ("r", dr)):
                    # a finite gain is a candidate: last max (reverse),
                    # first max (forward)
                    v, i, ok = best[d][:3]
                    better = (g[d] >= v) if d == "l" else (g[d] > v)
                    upd = (g[d] > NEG_INF) & (~ok | better)
                    best[d] = [np.where(upd, a, old) for a, old in zip(
                        (g[d], b, np.ones(32, bool), res[1], res[2], res[3]),
                        best[d])]
            tot_seg = carry
            lv, li, _ = _seg_argmax(best["l"][:3], seg_end, True)
            rv, ri, _ = _seg_argmax(best["r"][:3], seg_end, False)
            lv, li, rv, ri = lv[seg], li[seg], rv[seg], ri[seg]
            use_left = lv >= rv
            none = use_left & (lv == NEG_INF)
            tsel = np.where(none, B - 1, np.where(use_left, li, ri))
            own_i = np.where(use_left, best["l"][1], best["r"][1])
            own_ok = np.where(use_left, best["l"][2], best["r"][2])
            writer = mine & np.where(none, L == seg, own_ok & (own_i == tsel))
            for ln in np.nonzero(writer)[0]:
                ff = f[ln]
                written[c, ff] += 1
                ng = lv[ln] if use_left[ln] else rv[ln]
                outs["gain"][c, ff] = ng - mgs if np.isfinite(ng) else NEG_INF
                outs["threshold"][c, ff] = tsel[ln]
                outs["default_left"][c, ff] = (use_left[ln] if has_md[ln]
                                               else mt[ln] != 2)
                if none[ln]:
                    p = [_to_f32(tot_seg[ch][ln], mult[ch])
                         for ch in range(3)]
                    outs["left_sum_grad"][c, ff] = p[0] + ms[0][ln]
                    outs["left_sum_hess"][c, ff] = \
                        ((p[1] + ms[1][ln]) + EPS) - EPS
                    outs["left_count"][c, ff] = p[2] + ms[2][ln]
                else:
                    d = best["l"] if use_left[ln] else best["r"]
                    outs["left_sum_grad"][c, ff] = d[3][ln]
                    outs["left_sum_hess"][c, ff] = d[4][ln] - EPS
                    outs["left_count"][c, ff] = d[5][ln]
    assert (written == 1).all(), np.argwhere(written != 1)[:5]
    return TFU.NumericFeatureBest(**{k: torch.from_numpy(v)
                                     for k, v in outs.items()})


# ----------------------------------------------------------------------
# (b) the model against numeric_feature_scan on random histograms
# ----------------------------------------------------------------------

def _random_case(seed, num_bin, B, NC, quant):
    """Random integer histograms (bins past num_bin non-zero too), random
    missing types and defaults, child sums near each child's totals."""
    rng = np.random.RandomState(seed)
    F = len(num_bin)
    nb = np.asarray(num_bin, np.int32)
    mt = rng.randint(0, 3, F).astype(np.int32)
    db = np.array([rng.randint(0, max(n, 1)) for n in nb], np.int32)
    if quant:
        g = rng.randint(-40, 41, (NC, F, B))
        hh = rng.randint(0, 60, (NC, F, B))
        hist = torch.from_numpy(np.stack([g, hh], 1).astype(np.int32))
        scales = QuantScales(0.37, 0.11)
        tot = hist[:, :, 0].to(torch.int64).sum(-1).to(torch.float32)
        sums = torch.stack([tot[:, 0] * scales.g, tot[:, 1] * scales.h,
                            torch.from_numpy(rng.randint(
                                200, 2000, NC).astype(np.float32))])
    else:
        s = (40, 40, 30)
        g = rng.randint(-2 ** 40, 2 ** 40, (NC, F, B))
        hh = rng.randint(0, 2 ** 41, (NC, F, B))
        cc = rng.randint(0, 40, (NC, F, B)) << 30
        hist = torch.from_numpy(np.stack([g, hh, cc], 1).astype(np.int64))
        scales = s
        sums = torch.stack([fixed_to_f32(hist[:, ch, 0].sum(-1), [s[ch]], 0)
                            for ch in range(3)])
    meta = [torch.from_numpy(a) for a in (nb, mt, db)]
    return hist, scales, sums, meta


HP = SplitHyperparams(min_data_in_leaf=3, min_sum_hessian_in_leaf=1e-3,
                      lambda_l2=0.5)
HP_L1 = SplitHyperparams(min_data_in_leaf=3, lambda_l1=0.3, lambda_l2=1.0,
                         max_delta_step=0.7, min_gain_to_split=0.01)


def _modes(rng, F, NC, nb, kind):
    if kind == "plain":
        return {}
    if kind == "monotone+bounds":
        mono = torch.from_numpy(rng.randint(-1, 2, F).astype(np.int32))
        lo = torch.from_numpy(np.where(rng.rand(NC) < 0.3, -np.inf,
                                       -0.05 - rng.rand(NC)).astype(
                                           np.float32))
        hi = torch.from_numpy(np.where(rng.rand(NC) < 0.3, np.inf,
                                       0.05 + rng.rand(NC)).astype(
                                           np.float32))
        return {"monotone_constraints": mono, "child_bounds": (lo, hi)}
    if kind == "monotone":
        return {"monotone_constraints": torch.from_numpy(
            rng.randint(-1, 2, F).astype(np.int32))}
    thr = random_thresholds(torch.from_numpy(rng.rand(NC, F).astype(
        np.float32)), nb)
    return {"rand_thr": thr}


def _model_kw(kw):
    return {"mono": kw.get("monotone_constraints"),
            "bounds": kw.get("child_bounds"), "rand_thr": kw.get("rand_thr")}


CASES = [
    # num_bin per feature, B: one-hot columns, 33 bins (two chunks), the
    # axis itself, a one-bin and a padding feature, bins past num_bin
    ([2, 33, 2, 2, 9, 1, 0, 40, 3], 40),
    ([63, 2, 5, 17, 32, 31], 63),
]


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("kind", ["plain", "monotone+bounds", "monotone",
                                  "rand_thr"])
@pytest.mark.parametrize("case", range(len(CASES)))
def test_warp_scan_model_equals_the_plain_scan(case, kind, quant):
    num_bin, B = CASES[case]
    NC = 3
    hist, scales, sums, meta = _random_case(case, num_bin, B, NC, quant)
    kw = _modes(np.random.RandomState(7 + case), len(num_bin), NC, meta[0],
                kind)
    for hp in (HP, HP_L1):
        want = TFU.scan_plain(hist, scales, sums, *meta, hp, **kw)
        got = kernel_model(hist, scales, sums, *meta, hp, **_model_kw(kw))
        assert_same_bits(got, want, (kind, hp))
        assert bool(torch.isfinite(want.gain).any())


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
def test_warp_scan_model_at_1023_bins(quant):
    """A 1023-bin feature walks 32 chunks with the carry; beside it a
    2-bin feature packed with a 33-bin one's neighbours."""
    num_bin, B, NC = [1023, 2, 33, 700], 1023, 2
    hist, scales, sums, meta = _random_case(11, num_bin, B, NC, quant)
    want = TFU.scan_plain(hist, scales, sums, *meta, HP)
    got = kernel_model(hist, scales, sums, *meta, HP)
    assert_same_bits(got, want)
    assert int(want.threshold.max()) > 32


def test_no_valid_threshold_takes_bin_b_minus_1():
    """With every gain -inf the reverse scan's last maximum is bin B - 1
    (past the walked bins), whose left sums are the walk's total: the
    model writes it from the carried prefix, as the plain scan gives."""
    num_bin, B, NC = [5, 40, 2], 64, 2
    hist, scales, sums, meta = _random_case(3, num_bin, B, NC, False)
    hp = SplitHyperparams(min_data_in_leaf=10 ** 9)
    want = TFU.scan_plain(hist, scales, sums, *meta, hp)
    assert (want.threshold == B - 1).all()
    assert_same_bits(kernel_model(hist, scales, sums, *meta, hp), want)


# ----------------------------------------------------------------------
# (a) the grouped leaf-mode entry against expansion + scan
# ----------------------------------------------------------------------

# features: (num_bin, group): bundles of one-hot / narrow columns and
# single-feature groups (a NaN- and a zero-missing feature among them)
LAYOUT = [(2, 0), (2, 0), (3, 0), (2, 0), (40, 1), (9, 2), (2, 3), (2, 3),
          (17, 4), (5, 5), (2, 5), (33, 6)]
MISSING = [0, 0, 0, 0, 2, 1, 0, 0, 2, 0, 0, 1]
DEFAULT = [0, 0, 0, 0, 0, 3, 0, 0, 0, 0, 0, 7]
N_ROWS = 4000


def _grouped_case(seed, quant, NC=4):
    """Group columns whose merged bins partition the rows (bin 0 shared by
    a bundle's features), their B4 group histograms for NC random
    children, and the children's sums."""
    rng = np.random.RandomState(seed)
    F = len(LAYOUT)
    G = max(g for _, g in LAYOUT) + 1
    nb = np.array([n for n, _ in LAYOUT], np.int32)
    fg = np.array([g for _, g in LAYOUT], np.int32)
    fs = np.zeros(F, np.int32)
    width = np.ones(G, np.int64)
    for f, (n, g) in enumerate(LAYOUT):
        fs[f] = width[g]
        width[g] += n - 1
    Bg, B = int(width.max()), int(nb.max())
    binned = np.stack([rng.randint(0, width[g], N_ROWS) for g in range(G)]
                      ).astype(np.uint8)
    slot = rng.randint(0, NC, N_ROWS).astype(np.int32)
    tb, ts = torch.from_numpy(binned), torch.from_numpy(slot)
    if quant:
        vals = _vals_t_int(
            torch.from_numpy(rng.randint(-31, 32, N_ROWS).astype(np.int8)),
            torch.from_numpy(rng.randint(0, 8, N_ROWS).astype(np.int8)),
            torch.ones(N_ROWS, dtype=torch.bool)).contiguous()
        scales = QuantScales(0.25, 0.125)
        ghist = accumulate_plain(tb, vals, ts, NC, Bg)
        tot = ghist[:, :, 0].to(torch.int64).sum(-1).to(torch.float32)
        sums = torch.stack([tot[:, 0] * scales.g, tot[:, 1] * scales.h,
                            torch.bincount(ts, minlength=NC).float()])
    else:
        g = torch.from_numpy(rng.randn(N_ROWS).astype(np.float32))
        hs = torch.from_numpy(rng.rand(N_ROWS).astype(np.float32) + 0.1)
        vals = _vals_t(g, hs, torch.ones(N_ROWS)).contiguous()
        scales = fixed_point_scales(vals)
        ghist = accumulate_plain(tb, vals, ts, NC, Bg, scales)
        sums = torch.stack([fixed_to_f32(ghist[:, c, 0].sum(-1),
                                         [scales[c]], 0) for c in range(3)])
    meta_t = {"num_bin": torch.from_numpy(nb),
              "missing_type": torch.tensor(MISSING, dtype=torch.int32),
              "default_bin": torch.tensor(DEFAULT, dtype=torch.int32),
              "feat_group": torch.from_numpy(fg),
              "feat_start": torch.from_numpy(fs)}
    return ghist, scales, sums, meta_t, B, Bg


def np_expand(ghist: torch.Tensor, mt: dict, B: int) -> torch.Tensor:
    """Group histograms [NC, C, G, Bg] -> per-feature ones [NC, C, F, B],
    cell by cell: bin b in 1 .. num_bin - 1 of feature f is merged bin
    feat_start[f] + b - 1 of column feat_group[f]; bin 0 is the child's
    total (the sum of group 0's bins) minus the feature's other bins."""
    g = ghist.numpy().astype(np.int64)
    NC, C = g.shape[:2]
    nb, fg, fs = (mt[k].numpy().astype(np.int64)
                  for k in ("num_bin", "feat_group", "feat_start"))
    out = np.zeros((NC, C, len(nb), B), np.int64)
    total = g[:, :, 0, :].sum(-1)
    for f in range(len(nb)):
        for b in range(1, min(nb[f], B)):
            out[:, :, f, b] = g[:, :, fg[f], fs[f] + b - 1]
        out[:, :, f, 0] = total - out[:, :, f, 1:].sum(-1)
    return torch.from_numpy(out).to(ghist.dtype)


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("kind", ["plain", "monotone+bounds", "rand_thr"])
def test_grouped_entry_equals_expansion_then_scan(kind, quant):
    ghist, scales, sums, mt, B, Bg = _grouped_case(5, quant)
    meta = [mt[k] for k in ("num_bin", "missing_type", "default_bin")]
    kw = _modes(np.random.RandomState(9), len(LAYOUT), ghist.shape[0],
                meta[0], kind)
    groups = group_layout(mt, B)
    hp = SplitHyperparams(min_data_in_leaf=5, lambda_l2=0.5)
    expanded = np_expand(ghist, mt, B)
    assert torch.equal(TFU.expand_groups(ghist, groups, meta[0]), expanded)
    want = TFU.scan_plain(expanded, scales, sums, *meta, hp, **kw)
    assert bool(torch.isfinite(want.gain).any())
    got = TFU.sibling_scan(ghist, scales, sums, *meta, hp, groups=groups,
                           **kw)
    assert_same_bits(got, want, "entry")
    model = kernel_model(ghist, scales, sums, *meta, hp, groups=groups,
                         **_model_kw(kw))
    assert_same_bits(model, want, "model")


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
def test_grouped_search_with_a_categorical_column(quant):
    """``feature_best_splits`` on group histograms, with a native
    categorical single-feature group beside the bundles, equals the
    search of the fully expanded histograms; only the categorical
    column is expanded."""
    ghist, scales, sums, mt, B, Bg = _grouped_case(6, quant)
    meta = [mt[k] for k in ("num_bin", "missing_type", "default_bin")]
    is_cat = torch.zeros(len(LAYOUT), dtype=torch.bool)
    is_cat[5] = True                      # the 9-bin single-feature group
    hp = SplitHyperparams(min_data_in_leaf=5, lambda_l2=0.5,
                          max_cat_threshold=3)
    args = (scales, sums[0], sums[1], sums[2], *meta, is_cat, hp)
    want = feature_best_splits(np_expand(ghist, mt, B), *args)
    got = feature_best_splits(ghist, *args, groups=group_layout(mt, B))
    for name in want._fields:
        assert torch.equal(_bits_t(getattr(got, name)),
                           _bits_t(getattr(want, name))), name
    assert bool(want.is_categorical[:, 5].all())


def _bits_t(x):
    return x.view(torch.int32) if x.dtype == torch.float32 else x


def test_expand_groups_restricted_to_columns():
    ghist, _, _, mt, B, Bg = _grouped_case(7, False)
    full = np_expand(ghist, mt, B)
    idx = torch.tensor([5, 0, 11])
    part = TFU.expand_groups(ghist, group_layout(mt, B), mt["num_bin"], idx)
    assert torch.equal(part, full[:, :, idx])


# ----------------------------------------------------------------------
# (c) the planner's tasks
# ----------------------------------------------------------------------

@pytest.mark.parametrize("num_bin,B", [
    ([2] * 100, 255), ([255] * 28, 255), ([2, 255, 3, 0, 1, 33, 32, 31, 2],
                                           255),
    ([1023, 2, 2], 1023), ([300, 5], 64),
    (list(np.random.RandomState(0).randint(0, 70, 200)), 63)])
def test_scan_plan_covers_every_pair_once(num_bin, B):
    """Every (child, feature) pair is one lane segment of one warp of
    one block, as the kernel maps blocks and warps to tasks; a segment
    spans the feature's walked bins, or the warp and its chunks."""
    NC = 3
    plan = planner.scan_plan(num_bin, B)
    lanes = np.array(plan.lanes).reshape(plan.tasks, 32)
    nblk = -(-plan.tasks // planner.SCAN_WARPS)
    seen = {}
    for x in range(NC * nblk):             # csrc/fused.cu fused_scan's grid
        c = x // nblk
        for w in range(planner.SCAN_WARPS):
            task = (x - c * nblk) * planner.SCAN_WARPS + w
            if task >= plan.tasks:
                continue
            e = lanes[task]
            for ln in range(32):
                if e[ln] >= 0 and (e[ln] & 31) == ln:
                    f = int(e[ln] >> 5)
                    seen[c, f] = seen.get((c, f), 0) + 1
                    w_bins = planner.scan_walked_bins(num_bin[f], B)
                    span = (e == e[ln]).sum()
                    assert span == min(w_bins, 32)
                    if w_bins > 32:
                        assert ln == 0 and span == 32
    assert seen == {(c, f): 1 for c in range(NC)
                    for f in range(len(num_bin))}
    # neighbouring features share a task: 100 one-hot columns fill 7
    if num_bin == [2] * 100:
        assert plan.tasks == 7


def test_scan_launch_takes_the_plan(monkeypatch):
    """The wrapper hands the kernel a given plan's lane entries and task
    count without planning again, and plans ``num_bin`` itself where no
    plan is given."""
    calls = []

    class Lib:
        def fused_scan(self, *args):
            calls.append(args)
            return 0

    monkeypatch.setattr(TFU, "_lib", Lib)
    monkeypatch.setattr(TFU, "_stream", lambda t: 0)
    monkeypatch.setattr(torch.cuda, "device", lambda d: _Null())
    built = []
    real = planner.scan_plan
    monkeypatch.setattr(planner, "scan_plan",
                        lambda *a: built.append(a) or real(*a))
    ghist, scales, sums, mt, B, Bg = _grouped_case(5, False)
    meta = [mt[k] for k in ("num_bin", "missing_type", "default_bin")]
    groups = group_layout(mt, B)
    plan = TFU.scan_tasks(mt["num_bin"].tolist(), B, "cpu")
    assert len(built) == 1
    want = real(mt["num_bin"].tolist(), B)
    assert plan.tolist() == list(want.lanes)
    for _ in range(2):
        TFU._scan_cuda(ghist, scales, sums, *meta, SplitHyperparams(),
                       groups=groups, plan=plan)
    assert len(built) == 1
    args = calls[-1]
    assert args[5:7] == (plan.data_ptr(), want.tasks)
    assert args[3] == groups.feat_group.data_ptr()
    assert args[14:20] == (ghist.shape[0], len(LAYOUT), B, ghist.shape[2],
                           Bg, ghist.shape[0])
    TFU._scan_cuda(ghist, scales, sums, *meta, SplitHyperparams(),
                   groups=groups)
    assert len(built) == 2 and calls[-1][6] == want.tasks


@pytest.mark.parametrize("hist_method", ["fused", "staged"])
def test_grower_plans_the_scan_once_a_tree(monkeypatch, hist_method):
    """The grower plans B5's warp tasks once a tree, from the dataset's
    meta, and every scan of the tree (the root's, each round's B2 on the
    fused arm or staged search) takes that plan."""
    built, seen = [], []
    real_tasks, real_scan = TFU.scan_tasks, TFU.sibling_scan

    def tasks(*a):
        built.append(real_tasks(*a))
        return built[-1]

    def scan(*a, plan=None, **kw):
        seen.append(plan)
        return real_scan(*a, plan=plan, **kw)
    monkeypatch.setattr(TFU, "scan_tasks", tasks)
    monkeypatch.setattr(TFU, "sibling_scan", scan)
    rng = np.random.RandomState(4)
    n, num_bin, B = 2000, [2, 40, 9, 33, 2, 17], 40
    F = len(num_bin)
    binned = np.stack([rng.randint(0, nb, n) for nb in num_bin]
                      ).astype(np.uint8)
    grad = (np.sin(binned[1] * 0.2) + 0.3 * binned[0]
            + rng.randn(n) * 0.1).astype(np.float32)
    meta = FeatureMeta(num_bin=np.array(num_bin, np.int32),
                       missing_type=np.zeros(F, np.int32),
                       default_bin=np.zeros(F, np.int32),
                       most_freq_bin=np.zeros(F, np.int32),
                       is_categorical=np.zeros(F, bool), max_num_bin=B)
    tree, _ = grow_tree_rounds(
        torch.from_numpy(binned), torch.from_numpy(-grad),
        torch.ones(n), torch.ones(n), meta,
        GrowerConfig(num_leaves=15, num_bins=B, hp=SplitHyperparams(),
                     hist_method=hist_method))
    assert tree.num_leaves > 4
    assert len(built) == 1 and len(seen) > 2
    assert all(p is built[0] for p in seen)
    assert built[0].tolist() == list(planner.scan_plan(num_bin, B).lanes)


class _Null:
    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False
