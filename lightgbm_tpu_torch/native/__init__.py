"""The native host library: a row-parallel float64 forest predictor and
``GreedyFindBin`` in C++ (counterpart of ``lightgbm_tpu/native``).

``load_native_lib()`` builds it at first use (``build.py``) and gives
None where it cannot, and then ``predict.StackedForest`` and
``binning.greedy_find_bin`` take their NumPy routes, with the same bits.
``route_counts`` counts each call by route (``"predict[native]"``,
``"predict[numpy]"``, ``"find_bin[native]"``, ``"find_bin[numpy]"``) so
that a run can show which one it took.
"""

from __future__ import annotations

import threading

from .build import load_native_lib

_counts_lock = threading.Lock()
route_counts = {"predict[native]": 0, "predict[numpy]": 0,
                "find_bin[native]": 0, "find_bin[numpy]": 0}


def count_route(kind: str, route: str) -> None:
    with _counts_lock:
        route_counts[f"{kind}[{route}]"] += 1


def reset_route_counts() -> None:
    with _counts_lock:
        for k in route_counts:
            route_counts[k] = 0


__all__ = ["load_native_lib", "route_counts", "count_route",
           "reset_route_counts"]
