"""Plotting helpers (`python-package/lightgbm/plotting.py:30-430`).

Port of ``lightgbm_tpu/plotting.py``: ``matplotlib`` and ``graphviz`` are
imported inside the functions that draw, so the package imports without
them.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def _check_not_tuple_of_2_elements(obj, obj_name="obj"):
    if not isinstance(obj, tuple) or len(obj) != 2:
        raise TypeError(f"{obj_name} must be a tuple of 2 elements.")


def plot_importance(booster, ax=None, height: float = 0.2, xlim=None,
                    ylim=None, title: str = "Feature importance",
                    xlabel: str = "Feature importance",
                    ylabel: str = "Features", importance_type: str = "split",
                    max_num_features: Optional[int] = None,
                    ignore_zero: bool = True, figsize=None, grid: bool = True,
                    precision: int = 3, **kwargs):
    """`plotting.py:30-140`."""
    import matplotlib.pyplot as plt
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
        raise ValueError("Cannot plot trees with zero importance")
    labels, values = zip(*tuples)
    if ax is None:
        _, ax = plt.subplots(1, 1, figsize=figsize)
    ylocs = np.arange(len(values))
    ax.barh(ylocs, values, align="center", height=height, **kwargs)
    for x, y in zip(values, ylocs):
        ax.text(x + 1, y, _float2str(x, precision) if importance_type == "gain"
                else str(int(x)), va="center")
    ax.set_yticks(ylocs)
    ax.set_yticklabels(labels)
    if xlim is not None:
        _check_not_tuple_of_2_elements(xlim, "xlim")
        ax.set_xlim(xlim)
    if ylim is not None:
        _check_not_tuple_of_2_elements(ylim, "ylim")
        ax.set_ylim(ylim)
    if title is not None:
        ax.set_title(title)
    if xlabel is not None:
        ax.set_xlabel(xlabel)
    if ylabel is not None:
        ax.set_ylabel(ylabel)
    ax.grid(grid)
    return ax


def _float2str(value, precision=3):
    return f"{value:.{precision}f}"


def plot_metric(booster, metric: Optional[str] = None,
                dataset_names=None, ax=None, xlim=None, ylim=None,
                title: str = "Metric during training",
                xlabel: str = "Iterations", ylabel: str = "auto",
                figsize=None, grid: bool = True):
    """`plotting.py:144-230` — plots recorded eval results."""
    import matplotlib.pyplot as plt
    if isinstance(booster, dict):
        eval_results = booster
    elif hasattr(booster, "evals_result_"):
        eval_results = booster.evals_result_
    elif hasattr(booster, "gbdt"):
        eval_results = booster.gbdt.eval_history
    else:
        raise TypeError("booster must be dict, Booster or LGBMModel")
    if not eval_results:
        raise ValueError("eval results cannot be empty")
    if ax is None:
        _, ax = plt.subplots(1, 1, figsize=figsize)
    names = dataset_names or list(eval_results.keys())
    for name in names:
        metrics = eval_results[name]
        m = metric or next(iter(metrics))
        results = metrics[m]
        ax.plot(range(1, len(results) + 1), results, label=name)
        if ylabel == "auto":
            ylabel = m
    ax.legend(loc="best")
    if title is not None:
        ax.set_title(title)
    ax.set_xlabel(xlabel)
    if ylabel not in (None, "auto"):
        ax.set_ylabel(ylabel)
    ax.grid(grid)
    return ax


def create_tree_digraph(booster, tree_index: int = 0, show_info=None,
                        precision: int = 3, **kwargs):
    """`plotting.py:318-388` — graphviz Digraph of one tree."""
    import graphviz
    if hasattr(booster, "booster_"):
        booster = booster.booster_
    tree = booster.gbdt.models[tree_index]
    show_info = show_info or []
    graph = graphviz.Digraph(**kwargs)

    def add(node, parent=None, decision=None):
        if node < 0:
            leaf = ~node
            name = f"leaf{leaf}"
            label = f"leaf {leaf}: {_float2str(tree.leaf_value[leaf], precision)}"
            if "leaf_count" in show_info:
                label += f"\ncount: {tree.leaf_count[leaf]}"
            graph.node(name, label=label)
        else:
            name = f"split{node}"
            label = (f"split_feature_index: {tree.split_feature[node]}"
                     f"\nthreshold: {_float2str(tree.threshold[node], precision)}")
            if "split_gain" in show_info:
                label += f"\nsplit_gain: {_float2str(tree.split_gain[node], precision)}"
            if "internal_count" in show_info:
                label += f"\ncount: {tree.internal_count[node]}"
            graph.node(name, label=label)
            add(tree.left_child[node], name, "<=")
            add(tree.right_child[node], name, ">")
        if parent is not None:
            graph.edge(parent, name, decision)

    add(0 if tree.num_leaves > 1 else ~0)
    return graph


def plot_tree(booster, ax=None, tree_index: int = 0, figsize=None,
              show_info=None, precision: int = 3, **kwargs):
    """`plotting.py:391-430`."""
    import io as _io
    import matplotlib.image as mpimg
    import matplotlib.pyplot as plt
    if ax is None:
        _, ax = plt.subplots(1, 1, figsize=figsize)
    graph = create_tree_digraph(booster, tree_index=tree_index,
                                show_info=show_info, precision=precision)
    s = _io.BytesIO(graph.pipe(format="png"))
    img = mpimg.imread(s)
    ax.imshow(img)
    ax.axis("off")
    return ax
