"""Time the PyTorch port's scan kernel (B5, ``ops/csrc/fused.cu``) in each
of its modes at the ``hist`` shape of ``chip_smoke.py`` (K = 128
candidates, 256 children x 28 features x 255 bins, 1 M random rows of
which half are slotted): plain f32 and int8 (parent mode), monotone +
bounds f32 and int8 (parent mode), random thresholds (leaf mode); and
the staged arm's search at the ``onehot`` leaf shape (256 children of
the one-hot airline table, ``testing.airline_like`` at 200,000 rows, 664
used features in EFB bundles) as the checkout runs it: the int64
expansion then B5 where the package has no grouped input, B5 on the
group histograms where it has; and parent mode at the ``cat_train``
shape (8 features, 4 to 64 candidates).  Every timed call is first held bit for
bit against its plain version.  Run it once per checkout, with that
checkout first on ``sys.path``, to compare two commits on one card in
one call (run them as A, B, B, A):

    PYTHONPATH=<checkout> python3 <this file> --label A

Prints one JSON line: each case's mean time over 250 launches replayed
from a CUDA graph (50 for the one-hot search), and the card's name and
power limit.  Needs a CUDA card; imports nothing of JAX."""

from __future__ import annotations

import argparse
import json
import subprocess
import sys


def graph_ms(fn, reps: int = 50, replays: int = 5) -> float:
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (replays * reps)


def same_bits(a, b) -> bool:
    import torch
    for name in a._fields:
        x, y = getattr(a, name), getattr(b, name)
        if x.dtype == torch.float32:
            x, y = x.view(torch.int32), y.view(torch.int32)
        if not torch.equal(x, y):
            return False
    return True


def timed(name, fn, plain, out, reps=50):
    """Hold ``fn`` to ``plain`` bit for bit, then time it into ``out``."""
    if not same_bits(fn(), plain()):
        raise AssertionError(f"B5 ({name}) differs from its plain version")
    out[name + "_ms"] = graph_ms(fn, reps)


def plan_kw(fused, num_bin, B: int) -> dict:
    """The scan's warp tasks for ``num_bin``, built once as the grower
    builds them a tree, where this checkout's wrapper takes them; {}
    where it has none."""
    if not hasattr(fused, "scan_tasks"):
        return {}
    return {"plan": fused.scan_tasks(num_bin.tolist(), B, num_bin.device)}


def hist_cases(out) -> None:
    import torch
    from lightgbm_tpu_torch.ops import fused
    from lightgbm_tpu_torch.ops.histogram import (_vals_t, _vals_t_int,
                                                  accumulate_plain,
                                                  fixed_point_scales)
    from lightgbm_tpu_torch.ops.split import (QuantScales, SplitHyperparams,
                                              fixed_to_f32,
                                              random_thresholds)

    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(1)
    n, F, B, K = 1_000_000, 28, 255, 128
    NC = 2 * K

    def ints(lo, hi, size, dtype=torch.int32):
        return torch.randint(lo, hi, size, device=dev, generator=g,
                             dtype=torch.int32).to(dtype)
    binned = ints(0, B, (F, n), torch.uint8)
    grad = torch.randn(n, device=dev, generator=g)
    hess = torch.rand(n, device=dev, generator=g) + 0.1
    vals = _vals_t(grad, hess, torch.ones_like(grad)).contiguous()
    scales = fixed_point_scales(vals)
    r = torch.rand(n, device=dev, generator=g)
    pick, other = ints(0, K, (n,)), ints(0, K, (n,))
    slot = torch.where(r < 0.5, pick, torch.full_like(pick, K))
    pslot = torch.where(r < 0.5, pick, other)
    small_left = torch.rand(K, device=dev, generator=g) < 0.5
    nb = torch.full((F,), B, dtype=torch.int32, device=dev)
    mt = torch.zeros(F, dtype=torch.int32, device=dev)
    hp = SplitHyperparams(min_data_in_leaf=20)
    plan = plan_kw(fused, nb, B)

    parent = accumulate_plain(binned, vals, pslot, K, B, scales)
    small = accumulate_plain(binned, vals, slot, K, B, scales)
    kids = fused.derive_children(small, small_left, parent).contiguous()
    sums = torch.stack([fixed_to_f32(kids[:, c, 0].sum(-1), [scales[c]], 0)
                        for c in range(3)])

    qvals = _vals_t_int(ints(-2, 3, (n,), torch.int8),
                        ints(0, 4, (n,), torch.int8),
                        torch.ones(n, dtype=torch.bool, device=dev)
                        ).contiguous()
    qparent = accumulate_plain(binned, qvals, pslot, K, B)
    qsmall = accumulate_plain(binned, qvals, slot, K, B)
    qkids = fused.derive_children(qsmall, small_left, qparent)
    tot = qkids[:, :, 0].to(torch.int64).sum(-1).to(torch.float32)
    n_par = torch.bincount(pslot, minlength=K)
    n_small = torch.bincount(slot[slot < K], minlength=K)
    n_left = torch.where(small_left, n_small, n_par - n_small)
    qs = QuantScales(0.37, 0.11)
    qsums = torch.stack([tot[:, 0] * qs.g, tot[:, 1] * qs.h,
                         torch.cat([n_left, n_par - n_left]).float()])

    # the monotone + bounds inputs of chip_smoke.py's b5_mode_rows
    mono = torch.zeros(F, dtype=torch.int32, device=dev)
    mono[0::3], mono[1::3] = 1, -1
    free = torch.rand(NC, device=dev, generator=g) < 0.25
    lo = -0.02 - 0.1 * torch.rand(NC, device=dev, generator=g)
    hi = 0.02 + 0.1 * torch.rand(NC, device=dev, generator=g)
    bounds = (torch.where(free, torch.full_like(lo, -float("inf")), lo),
              torch.where(free, torch.full_like(hi, float("inf")), hi))
    thr = random_thresholds(torch.rand((NC, F), device=dev, generator=g), nb)

    for name, h, p, sc, s, kw in (
            ("b5_f32", small, parent, scales, sums, {}),
            ("b5_int8", qsmall, qparent, qs, qsums, {}),
            ("b5_monotone_bounds_f32", small, parent, scales, sums,
             {"monotone_constraints": mono, "child_bounds": bounds}),
            ("b5_monotone_bounds_int8", qsmall, qparent, qs, qsums,
             {"monotone_constraints": mono, "child_bounds": bounds})):
        timed(name,
              lambda: fused.sibling_scan(h, sc, s, nb, mt, mt, hp,
                                         small_left=small_left, parent=p,
                                         **kw, **plan),
              lambda: fused.scan_plain(h, sc, s, nb, mt, mt, hp,
                                       small_left=small_left, parent=p,
                                       **kw), out)
    timed("b5_rand_thr",
          lambda: fused.sibling_scan(kids, scales, sums, nb, mt, mt, hp,
                                     rand_thr=thr, **plan),
          lambda: fused.scan_plain(kids, scales, sums, nb, mt, mt, hp,
                                   rand_thr=thr), out)


def onehot_case(out) -> None:
    """The staged arm's numeric search of 256 children at the one-hot
    table's width, as this checkout's grower runs it."""
    import torch
    import lightgbm_tpu_torch as lt
    from lightgbm_tpu_torch.ops import fused
    from lightgbm_tpu_torch.ops.histogram import (_vals_t,
                                                  fixed_point_scales)
    from lightgbm_tpu_torch.ops.split import SplitHyperparams, fixed_to_f32
    from lightgbm_tpu_torch.testing import airline_like, one_hot

    X8, y = airline_like(200_000, seed=11)
    ds = lt.Dataset(one_hot(X8), label=y)
    ds.construct()
    meta = ds.feature_meta()
    mt = meta.tensors("cuda")
    binned_t = ds.binned_t
    G, n = binned_t.shape
    Bg, B, NC = int(ds.max_group_bin), int(meta.max_num_bin), 256
    g = torch.Generator(device="cuda").manual_seed(10)
    grad = torch.randn(n, device="cuda", generator=g)
    hess = torch.rand(n, device="cuda", generator=g) + 0.1
    vals = _vals_t(grad, hess, torch.ones_like(grad)).contiguous()
    scales = fixed_point_scales(vals)
    slot = torch.randint(0, NC, (n,), device="cuda", generator=g,
                         dtype=torch.int32)
    ghist = fused.accumulate(binned_t, vals, slot, NC, Bg, scales)
    sums = torch.stack([fixed_to_f32(ghist[:, c, 0].sum(-1), [scales[c]], 0)
                        for c in range(3)])
    meta3 = (mt["num_bin"], mt["missing_type"], mt["default_bin"])
    hp = SplitHyperparams(min_data_in_leaf=20)
    grouped = hasattr(fused, "GroupLayout")
    if grouped:
        from lightgbm_tpu_torch.grower_rounds import group_layout
        groups = group_layout(mt, B)
        plan = plan_kw(fused, meta3[0], B)

        def expand(h):
            return fused.expand_groups(h, groups, meta3[0])

        def search():
            return fused.sibling_scan(ghist, scales, sums, *meta3, hp,
                                      groups=groups, **plan)
    else:
        # the expansion the grouped input replaced
        from lightgbm_tpu_torch.grower_rounds import make_expand_hist
        expand = make_expand_hist(mt, B, Bg)

        def search():
            return fused.sibling_scan(expand(ghist), scales, sums, *meta3,
                                      hp)
        hist = expand(ghist).contiguous()
        out["onehot_b5_on_expanded_ms"] = graph_ms(
            lambda: fused.sibling_scan(hist, scales, sums, *meta3, hp), 10)
        out["onehot_expansion_ms"] = graph_ms(lambda: expand(ghist), 10)
        del hist
    timed("onehot_search", search,
          lambda: fused.scan_plain(expand(ghist), scales, sums, *meta3, hp),
          out, reps=10)
    out.update(onehot_grouped_input=grouped, onehot_features=len(meta3[0]),
               onehot_groups=G, onehot_group_bins=Bg, onehot_bins=B)


def cat_cases(out) -> None:
    """B5 in parent mode (B2's scan half) at the ``cat_train`` shape: the
    airline table with its six categorical columns native (8 features
    of their own bin counts, no bundles; 200,000 rows), K = 4, 16 and
    64 candidates, about half the rows slotted."""
    import torch
    import lightgbm_tpu_torch as lt
    from lightgbm_tpu_torch.ops import fused
    from lightgbm_tpu_torch.ops.histogram import (_vals_t, accumulate_plain,
                                                  fixed_point_scales)
    from lightgbm_tpu_torch.ops.split import SplitHyperparams, fixed_to_f32
    from lightgbm_tpu_torch.testing import AIRLINE_CATEGORICAL, airline_like

    X, y = airline_like(200_000, seed=11)
    ds = lt.Dataset(X, label=y, categorical_feature=list(AIRLINE_CATEGORICAL))
    ds.construct()
    meta = ds.feature_meta()
    mt = meta.tensors("cuda")
    binned_t = ds.binned_t
    F, n = binned_t.shape
    B = int(meta.max_num_bin)
    meta3 = (mt["num_bin"], mt["missing_type"], mt["default_bin"])
    hp = SplitHyperparams(min_data_in_leaf=20)
    plan = plan_kw(fused, meta3[0], B)
    g = torch.Generator(device="cuda").manual_seed(12)
    grad = torch.randn(n, device="cuda", generator=g)
    hess = torch.rand(n, device="cuda", generator=g) + 0.1
    vals = _vals_t(grad, hess, torch.ones_like(grad)).contiguous()
    scales = fixed_point_scales(vals)
    for K in (4, 16, 64):
        r = torch.rand(n, device="cuda", generator=g)
        pick = torch.randint(0, K, (n,), device="cuda", generator=g,
                             dtype=torch.int32)
        other = torch.randint(0, K, (n,), device="cuda", generator=g,
                              dtype=torch.int32)
        slot = torch.where(r < 0.5, pick, torch.full_like(pick, K))
        parent = accumulate_plain(binned_t, vals,
                                  torch.where(r < 0.5, pick, other), K, B,
                                  scales)
        small = accumulate_plain(binned_t, vals, slot, K, B, scales)
        small_left = torch.rand(K, device="cuda", generator=g) < 0.5
        kids = fused.derive_children(small, small_left, parent)
        sums = torch.stack([fixed_to_f32(kids[:, c, 0].sum(-1),
                                         [scales[c]], 0) for c in range(3)])
        kw = {"small_left": small_left, "parent": parent}
        timed(f"b5_cat_k{K}",
              lambda: fused.sibling_scan(small, scales, sums, *meta3, hp,
                                         **kw, **plan),
              lambda: fused.scan_plain(small, scales, sums, *meta3, hp,
                                       **kw), out)
    out.update(cat_features=F, cat_bins=B,
               cat_num_bin=meta.num_bin.tolist())


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--label", required=True)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 1
    out = {"label": args.label}
    hist_cases(out)
    onehot_case(out)
    cat_cases(out)
    out["card"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
