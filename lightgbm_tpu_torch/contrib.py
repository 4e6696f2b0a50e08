"""SHAP-style feature contributions (``PredictContrib``).

Port of ``lightgbm_tpu/contrib.py``, host numpy as there: a
re-implementation of ``Tree::PredictContrib`` / TreeSHAP
(`include/LightGBM/tree.h:118-124`, `src/io/tree.cpp` ``TreeSHAP`` path
following Lundberg et al.): exact per-tree Shapley values over the decision
path, O(leaves · depth²) per row.  Output layout matches the reference:
``(n_rows, n_features + 1)`` per class with the expected value in the last
column.
"""

from __future__ import annotations

from typing import List

import numpy as np

from .tree import Tree


class _PathElement:
    __slots__ = ("feature_index", "zero_fraction", "one_fraction", "pweight")

    def __init__(self, feature_index, zero_fraction, one_fraction, pweight):
        self.feature_index = feature_index
        self.zero_fraction = zero_fraction
        self.one_fraction = one_fraction
        self.pweight = pweight


def _extend_path(path: List[_PathElement], unique_depth, zero_fraction,
                 one_fraction, feature_index):
    path.append(_PathElement(feature_index, zero_fraction, one_fraction,
                             1.0 if unique_depth == 0 else 0.0))
    for i in range(unique_depth - 1, -1, -1):
        path[i + 1].pweight += one_fraction * path[i].pweight * (i + 1) \
            / (unique_depth + 1)
        path[i].pweight = zero_fraction * path[i].pweight * \
            (unique_depth - i) / (unique_depth + 1)


def _unwind_path(path: List[_PathElement], unique_depth, path_index):
    one_fraction = path[path_index].one_fraction
    zero_fraction = path[path_index].zero_fraction
    next_one_portion = path[unique_depth].pweight
    for i in range(unique_depth - 1, -1, -1):
        if one_fraction != 0:
            tmp = path[i].pweight
            path[i].pweight = next_one_portion * (unique_depth + 1) \
                / ((i + 1) * one_fraction)
            next_one_portion = tmp - path[i].pweight * zero_fraction \
                * (unique_depth - i) / (unique_depth + 1)
        else:
            path[i].pweight = path[i].pweight * (unique_depth + 1) \
                / (zero_fraction * (unique_depth - i))
    for i in range(path_index, unique_depth):
        path[i].feature_index = path[i + 1].feature_index
        path[i].zero_fraction = path[i + 1].zero_fraction
        path[i].one_fraction = path[i + 1].one_fraction
    path.pop()


def _unwound_path_sum(path: List[_PathElement], unique_depth, path_index):
    one_fraction = path[path_index].one_fraction
    zero_fraction = path[path_index].zero_fraction
    next_one_portion = path[unique_depth].pweight
    total = 0.0
    for i in range(unique_depth - 1, -1, -1):
        if one_fraction != 0:
            tmp = next_one_portion * (unique_depth + 1) \
                / ((i + 1) * one_fraction)
            total += tmp
            next_one_portion = path[i].pweight - tmp * zero_fraction * \
                (unique_depth - i) / (unique_depth + 1)
        else:
            total += path[i].pweight / (zero_fraction *
                                        (unique_depth - i) / (unique_depth + 1))
    return total


def _tree_shap(tree: Tree, x: np.ndarray, phi: np.ndarray, node: int,
               unique_depth: int, parent_path: List[_PathElement],
               parent_zero_fraction: float, parent_one_fraction: float,
               parent_feature_index: int, node_weights: np.ndarray):
    path = [_PathElement(p.feature_index, p.zero_fraction, p.one_fraction,
                         p.pweight) for p in parent_path]
    _extend_path(path, unique_depth, parent_zero_fraction,
                 parent_one_fraction, parent_feature_index)

    if node < 0:  # leaf
        leaf = ~node
        for i in range(1, unique_depth + 1):
            w = _unwound_path_sum(path, unique_depth, i)
            el = path[i]
            phi[el.feature_index] += w * (el.one_fraction - el.zero_fraction) \
                * tree.leaf_value[leaf]
        return

    hot, cold = _decision_children(tree, x, node)
    w_node = node_weights[node]
    hot_zero = _child_weight(tree, hot, node_weights) / w_node
    cold_zero = _child_weight(tree, cold, node_weights) / w_node
    incoming_zero, incoming_one = 1.0, 1.0
    path_index = 0
    feat = int(tree.split_feature[node])
    while path_index <= unique_depth:
        if path[path_index].feature_index == feat:
            break
        path_index += 1
    if path_index != unique_depth + 1:
        incoming_zero = path[path_index].zero_fraction
        incoming_one = path[path_index].one_fraction
        _unwind_path(path, unique_depth, path_index)
        unique_depth -= 1

    _tree_shap(tree, x, phi, hot, unique_depth + 1, path,
               hot_zero * incoming_zero, incoming_one, feat, node_weights)
    _tree_shap(tree, x, phi, cold, unique_depth + 1, path,
               cold_zero * incoming_zero, 0.0, feat, node_weights)


def _child_weight(tree: Tree, child: int, node_weights: np.ndarray) -> float:
    if child < 0:
        return float(tree.leaf_count[~child])
    return float(node_weights[child])


def _decision_children(tree: Tree, x: np.ndarray, node: int):
    fv = np.asarray([x[tree.split_feature[node]]])
    go_left = tree._decision(fv, np.asarray([node]))[0]
    if go_left:
        return tree.left_child[node], tree.right_child[node]
    return tree.right_child[node], tree.left_child[node]


def _expected_value(tree: Tree, node_weights: np.ndarray) -> float:
    num = 0.0
    for leaf in range(tree.num_leaves):
        num += tree.leaf_count[leaf] * tree.leaf_value[leaf]
    total = tree.leaf_count[:tree.num_leaves].sum()
    return num / total if total > 0 else 0.0


def predict_contrib(gbdt, X: np.ndarray, num_iteration: int = -1) -> np.ndarray:
    """(n, F + 1) contributions, the expected value last; (n, K * (F + 1))
    for K classes.  Each row sums to the raw score."""
    n, f_total = X.shape[0], gbdt.max_feature_idx + 1
    k = gbdt.num_tree_per_iteration
    num_models = gbdt._num_models_for(num_iteration)
    out = np.zeros((n, k, f_total + 1), dtype=np.float64)
    for mi in range(num_models):
        tree = gbdt.models[mi]
        cid = mi % k
        if tree.num_leaves <= 1:
            out[:, cid, -1] += tree.leaf_value[0]
            continue
        node_weights = np.zeros(max(tree.num_leaves - 1, 1))
        for node in range(tree.num_leaves - 2, -1, -1):
            node_weights[node] = (
                _child_weight(tree, tree.left_child[node], node_weights)
                + _child_weight(tree, tree.right_child[node], node_weights))
        exp_val = _expected_value(tree, node_weights)
        for r in range(n):
            phi = np.zeros(f_total + 1)
            phi[-1] += exp_val
            _tree_shap(tree, X[r], phi, 0, 0, [], 1.0, 1.0, -1, node_weights)
            out[r, cid] += phi
    if k == 1:
        return out[:, 0, :]
    return out.reshape(n, k * (f_total + 1))
