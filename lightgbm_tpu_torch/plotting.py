"""Plotting: feature importance, metric curves, split-value histograms
and trees (counterpart of ``lightgbm_tpu/plotting.py``).

reference: python-package/lightgbm/plotting.py: plot_importance,
plot_metric, plot_tree, plot_split_value_histogram, create_tree_digraph.
matplotlib and graphviz are imported where a function runs, never at
import time: the card's machine has neither, and the package imports
there all the same (``compat.MATPLOTLIB_INSTALLED``).
"""

from __future__ import annotations

import numpy as np

from .compat import MATPLOTLIB_INSTALLED


def _check_matplotlib():
    if not MATPLOTLIB_INSTALLED:
        raise ImportError("You must install matplotlib for plotting")
    import matplotlib.pyplot as plt
    return plt


def plot_importance(booster, ax=None, height: float = 0.2, xlim=None, ylim=None,
                    title="Feature importance", xlabel="Feature importance",
                    ylabel="Features", importance_type="split",
                    max_num_features=None, ignore_zero=True, figsize=None,
                    grid=True, precision=3, **kwargs):
    """reference: plotting.py plot_importance."""
    plt = _check_matplotlib()
    if hasattr(booster, "booster_"):
        booster = booster.booster_
    importance = booster.feature_importance(importance_type)
    feature_name = booster.feature_name()
    tuples = sorted(zip(feature_name, importance), key=lambda x: x[1])
    if ignore_zero:
        tuples = [x for x in tuples if x[1] > 0]
    if max_num_features is not None and max_num_features > 0:
        tuples = tuples[-max_num_features:]
    if not tuples:
        raise ValueError("cannot plot importance with no nonzero feature")
    labels, values = zip(*tuples)
    if ax is None:
        _, ax = plt.subplots(1, 1, figsize=figsize)
    ylocs = np.arange(len(values))
    ax.barh(ylocs, values, align="center", height=height, **kwargs)
    for x, y in zip(values, ylocs):
        ax.text(x + 1, y, f"{x:.{precision}g}" if isinstance(x, float) else str(x),
                va="center")
    ax.set_yticks(ylocs)
    ax.set_yticklabels(labels)
    if xlim is not None:
        ax.set_xlim(xlim)
    if ylim is not None:
        ax.set_ylim(ylim)
    if title:
        ax.set_title(title)
    if xlabel:
        ax.set_xlabel(xlabel)
    if ylabel:
        ax.set_ylabel(ylabel)
    ax.grid(grid)
    return ax


def plot_metric(booster, metric=None, dataset_names=None, ax=None, xlim=None,
                ylim=None, title="Metric during training", xlabel="Iterations",
                ylabel="auto", figsize=None, grid=True):
    """reference: plotting.py plot_metric."""
    plt = _check_matplotlib()
    if isinstance(booster, dict):
        eval_results = booster
    elif hasattr(booster, "evals_result_"):
        eval_results = booster.evals_result_
    else:
        raise TypeError("booster must be dict or LGBMModel with evals_result_")
    if not eval_results:
        raise ValueError("eval results cannot be empty")
    if dataset_names is None:
        dataset_names = list(eval_results.keys())
    if ax is None:
        _, ax = plt.subplots(1, 1, figsize=figsize)
    msets = eval_results[dataset_names[0]]
    if metric is None:
        metric = list(msets.keys())[0]
    for name in dataset_names:
        results = eval_results[name][metric]
        ax.plot(range(len(results)), results, label=name)
    ax.legend(loc="best")
    if xlim is not None:
        ax.set_xlim(xlim)
    if ylim is not None:
        ax.set_ylim(ylim)
    if title:
        ax.set_title(title)
    if xlabel:
        ax.set_xlabel(xlabel)
    ax.set_ylabel(metric if ylabel == "auto" else ylabel)
    ax.grid(grid)
    return ax


def plot_split_value_histogram(booster, feature, bins=None, ax=None,
                               width_coef: float = 0.8, xlim=None, ylim=None,
                               title="Split value histogram for feature with "
                                     "@index/name@ @feature@",
                               xlabel="Feature split value", ylabel="Count",
                               figsize=None, grid=True, **kwargs):
    """reference: plotting.py plot_split_value_histogram."""
    plt = _check_matplotlib()
    if hasattr(booster, "booster_"):
        booster = booster.booster_
    hist, edges = booster.get_split_value_histogram(feature, bins)
    if hist.sum() == 0:
        raise ValueError(f"Cannot plot split value histogram, "
                         f"because feature {feature} was not used in splitting")
    centers = (edges[:-1] + edges[1:]) / 2
    width = width_coef * (edges[1] - edges[0]) if len(edges) > 1 else 1.0
    if ax is None:
        _, ax = plt.subplots(1, 1, figsize=figsize)
    ax.bar(centers, hist, width=width, **kwargs)
    if title:
        title = title.replace("@feature@", str(feature)).replace(
            "@index/name@", "name" if isinstance(feature, str) else "index")
        ax.set_title(title)
    if xlabel:
        ax.set_xlabel(xlabel)
    if ylabel:
        ax.set_ylabel(ylabel)
    ax.grid(grid)
    return ax


def create_tree_digraph(booster, tree_index: int = 0, show_info=None,
                        precision: int = 3, **kwargs):
    """reference: plotting.py create_tree_digraph (graphviz)."""
    try:
        from graphviz import Digraph
    except ImportError as e:
        raise ImportError("You must install graphviz for plot_tree") from e
    if hasattr(booster, "booster_"):
        booster = booster.booster_
    t = booster.models[tree_index]
    fnames = booster.feature_name()
    show_info = show_info or []
    graph = Digraph(**kwargs)

    def add(node, parent=None, decision=None):
        if node < 0:
            li = ~node
            name = f"leaf{li}"
            label = f"leaf {li}: {t.leaf_value[li]:.{precision}f}"
            if "leaf_count" in show_info and len(t.leaf_count) > li:
                label += f"\ncount: {int(t.leaf_count[li])}"
            graph.node(name, label=label)
        else:
            name = f"split{node}"
            label = f"{fnames[int(t.split_feature[node])]}"
            dt = int(t.decision_type[node])
            op = "==" if dt & 1 else "<="
            label += f" {op} {t.threshold[node]:.{precision}g}"
            if "split_gain" in show_info:
                label += f"\ngain: {t.split_gain[node]:.{precision}g}"
            if "internal_count" in show_info:
                label += f"\ncount: {int(t.internal_count[node])}"
            graph.node(name, label=label)
            add(int(t.left_child[node]), name, "yes")
            add(int(t.right_child[node]), name, "no")
        if parent is not None:
            graph.edge(parent, name, decision)
        return name

    add(0 if t.num_leaves > 1 else -1)
    return graph


def plot_tree(booster, ax=None, tree_index: int = 0, figsize=None,
              show_info=None, precision: int = 3, **kwargs):
    """reference: plotting.py plot_tree (graphviz renders, matplotlib
    shows)."""
    plt = _check_matplotlib()
    import io

    import matplotlib.image as mpimg
    graph = create_tree_digraph(booster, tree_index, show_info, precision, **kwargs)
    s = io.BytesIO(graph.pipe(format="png"))
    img = mpimg.imread(s)
    if ax is None:
        _, ax = plt.subplots(1, 1, figsize=figsize)
    ax.imshow(img)
    ax.axis("off")
    return ax
