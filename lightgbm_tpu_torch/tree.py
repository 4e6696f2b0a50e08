# Port copy of lightgbm_tpu/tree.py: the port keeps its own numpy-only copy so
# that importing it never runs lightgbm_tpu/__init__.py (which imports JAX).
"""Flat-array decision tree model (host side).

Mirrors the reference ``Tree`` (`include/LightGBM/tree.h:20-517`,
`src/io/tree.cpp`): same node layout (internal nodes ``0..num_leaves-2``,
leaves encoded as ``~leaf_index`` in child pointers), same ``decision_type``
bit packing (`tree.h:14-15,183-203`: bit0 categorical, bit1 default-left,
bits2-3 missing type), and the same ``ToString`` text block
(`src/io/tree.cpp:207-240`) so models interchange with the reference format.

Trees are assembled on host from the device builder's per-split records
(`lightgbm_tpu/learner.py`); prediction has both a numpy path (exact
reference semantics, `tree.h:211-231` ``NumericalDecision``) and a packed
array form consumed by the batched device predictor.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import numpy as np

K_CATEGORICAL_MASK = 1
K_DEFAULT_LEFT_MASK = 2

K_ZERO_THRESHOLD = 1e-35


def _is_zero(v) -> bool:
    return -K_ZERO_THRESHOLD < v < K_ZERO_THRESHOLD


def _avoid_inf(x: float) -> float:
    # Common::AvoidInf caps at +-1e300
    if math.isnan(x):
        return 0.0
    return min(max(x, -1e300), 1e300)


def _array_to_str(arr, high_precision: bool = False) -> str:
    out = []
    for v in arr:
        if isinstance(v, (np.floating, float)):
            fv = float(v)
            if high_precision:
                s = repr(fv)
            else:
                s = f"{fv:g}"
            out.append(s)
        else:
            out.append(str(int(v)))
    return " ".join(out)


class Tree:
    """One decision tree with ``max_leaves`` capacity (reference `tree.h:20`)."""

    def __init__(self, max_leaves: int):
        self.max_leaves = max_leaves
        self.num_leaves = 1
        self.num_cat = 0
        n = max(max_leaves - 1, 1)
        self.left_child = np.zeros(n, dtype=np.int32)
        self.right_child = np.zeros(n, dtype=np.int32)
        self.split_feature_inner = np.zeros(n, dtype=np.int32)
        self.split_feature = np.zeros(n, dtype=np.int32)  # real (original) idx
        self.threshold_in_bin = np.zeros(n, dtype=np.int32)
        self.threshold = np.zeros(n, dtype=np.float64)
        self.decision_type = np.zeros(n, dtype=np.int8)
        self.split_gain = np.zeros(n, dtype=np.float64)
        self.leaf_parent = np.full(max_leaves, -1, dtype=np.int32)
        self.leaf_value = np.zeros(max_leaves, dtype=np.float64)
        self.leaf_count = np.zeros(max_leaves, dtype=np.int32)
        self.internal_value = np.zeros(n, dtype=np.float64)
        self.internal_count = np.zeros(n, dtype=np.int32)
        self.leaf_depth = np.zeros(max_leaves, dtype=np.int32)
        self.shrinkage = 1.0
        # categorical split storage (bitsets over categories)
        self.cat_boundaries: List[int] = [0]
        self.cat_threshold: List[int] = []

    # -- construction (Tree::Split, `tree.h:393-427`) ------------------------

    def split(self, leaf: int, feature_inner: int, real_feature: int,
              threshold_bin: int, threshold_double: float, left_value: float,
              right_value: float, left_cnt: int, right_cnt: int, gain: float,
              missing_type: int, default_left: bool) -> int:
        new_node = self.num_leaves - 1
        parent = self.leaf_parent[leaf]
        if parent >= 0:
            if self.left_child[parent] == ~leaf:
                self.left_child[parent] = new_node
            else:
                self.right_child[parent] = new_node
        self.split_feature_inner[new_node] = feature_inner
        self.split_feature[new_node] = real_feature
        self.split_gain[new_node] = _avoid_inf(gain)
        self.left_child[new_node] = ~leaf
        self.right_child[new_node] = ~self.num_leaves
        self.leaf_parent[leaf] = new_node
        self.leaf_parent[self.num_leaves] = new_node
        self.internal_value[new_node] = self.leaf_value[leaf]
        self.internal_count[new_node] = left_cnt + right_cnt
        self.leaf_value[leaf] = 0.0 if math.isnan(left_value) else left_value
        self.leaf_count[leaf] = left_cnt
        self.leaf_value[self.num_leaves] = 0.0 if math.isnan(right_value) else right_value
        self.leaf_count[self.num_leaves] = right_cnt
        self.leaf_depth[self.num_leaves] = self.leaf_depth[leaf] + 1
        self.leaf_depth[leaf] += 1
        # decision type: numerical + default dir + missing type (`tree.h:53-70`)
        dt = 0
        if default_left:
            dt |= K_DEFAULT_LEFT_MASK
        dt |= (missing_type & 3) << 2
        self.decision_type[new_node] = dt
        self.threshold_in_bin[new_node] = threshold_bin
        self.threshold[new_node] = threshold_double
        self.num_leaves += 1
        return self.num_leaves - 1

    def split_categorical(self, leaf: int, feature_inner: int, real_feature: int,
                          threshold_bins: List[int], threshold_cats: List[int],
                          left_value: float, right_value: float, left_cnt: int,
                          right_cnt: int, gain: float, missing_type: int) -> int:
        """Categorical split storing bitsets (`tree.h:73-108` SplitCategorical)."""
        cat_idx = self.num_cat
        # threshold fields hold the categorical-split index into
        # cat_boundaries (`tree.h:93-101`); default direction is right
        right = self.split(leaf, feature_inner, real_feature, cat_idx,
                           float(cat_idx), left_value, right_value, left_cnt,
                           right_cnt, gain, missing_type, False)
        node = self.num_leaves - 2
        self.decision_type[node] |= K_CATEGORICAL_MASK
        bitset = _to_bitset(threshold_cats)
        self.cat_threshold.extend(bitset)
        self.cat_boundaries.append(len(self.cat_threshold))
        self._cat_bitsets_inner = getattr(self, "_cat_bitsets_inner", {})
        self._cat_bitsets_inner[cat_idx] = set(threshold_bins)
        self.num_cat += 1
        return right

    def apply_shrinkage(self, rate: float) -> None:
        """Tree::Shrinkage (`tree.h:139-147`)."""
        self.leaf_value[:self.num_leaves] *= rate
        self.internal_value[:max(self.num_leaves - 1, 0)] *= rate
        self.shrinkage *= rate

    # -- prediction (numpy; exact `tree.h:211-231` semantics) ----------------

    def predict(self, X: np.ndarray) -> np.ndarray:
        n = X.shape[0]
        if self.num_leaves <= 1:
            return np.full(n, self.leaf_value[0])
        leaf = self.predict_leaf_index(X)
        return self.leaf_value[leaf]

    def predict_leaf_index(self, X: np.ndarray) -> np.ndarray:
        n = X.shape[0]
        if self.num_leaves <= 1:
            return np.zeros(n, dtype=np.int32)
        node = np.zeros(n, dtype=np.int32)
        out = np.full(n, -1, dtype=np.int32)
        active = np.arange(n)
        # iterative traversal, vectorized per depth level
        while len(active):
            nd = node[active]
            fv = X[active, self.split_feature[nd]]
            go_left = self._decision(fv, nd)
            child = np.where(go_left, self.left_child[nd], self.right_child[nd])
            is_leaf = child < 0
            out[active[is_leaf]] = ~child[is_leaf]
            node[active[~is_leaf]] = child[~is_leaf]
            active = active[~is_leaf]
        return out

    def _decision(self, fval: np.ndarray, node: np.ndarray) -> np.ndarray:
        dt = self.decision_type[node]
        missing_type = (dt >> 2) & 3
        default_left = (dt & K_DEFAULT_LEFT_MASK) != 0
        is_cat = (dt & K_CATEGORICAL_MASK) != 0
        nan_mask = np.isnan(fval)
        fv = np.where(nan_mask & (missing_type != 2), 0.0, fval)
        is_zero = (fv > -K_ZERO_THRESHOLD) & (fv < K_ZERO_THRESHOLD)
        is_missing = ((missing_type == 1) & is_zero) | ((missing_type == 2) & nan_mask)
        numeric_left = fv <= self.threshold[node]
        go_left = np.where(is_missing, default_left, numeric_left)
        if self.num_cat > 0 and is_cat.any():
            cat_left = np.zeros(len(fval), dtype=bool)
            for i in np.where(is_cat)[0]:
                v = fval[i]
                # `tree.h:250-262`: negative → right; NaN → right only for
                # missing_type NaN, else probed as category 0
                if np.isnan(v):
                    if missing_type[i] == 2:
                        continue
                    v = 0.0
                if int(v) < 0:
                    continue
                cat_idx = int(self.threshold[node[i]])
                cat_left[i] = _in_bitset(
                    self.cat_threshold,
                    self.cat_boundaries[cat_idx], self.cat_boundaries[cat_idx + 1],
                    int(v))
            go_left = np.where(is_cat, cat_left, go_left)
        return go_left

    # -- serialization (Tree::ToString, `src/io/tree.cpp:207-240`) -----------

    def to_string(self) -> str:
        nl = self.num_leaves
        ni = nl - 1
        buf = [f"num_leaves={nl}", f"num_cat={self.num_cat}"]
        buf.append("split_feature=" + _array_to_str(self.split_feature[:ni]))
        buf.append("split_gain=" + _array_to_str(self.split_gain[:ni]))
        buf.append("threshold=" + _array_to_str(self.threshold[:ni], True))
        buf.append("decision_type=" + _array_to_str(self.decision_type[:ni]))
        buf.append("left_child=" + _array_to_str(self.left_child[:ni]))
        buf.append("right_child=" + _array_to_str(self.right_child[:ni]))
        buf.append("leaf_value=" + _array_to_str(self.leaf_value[:nl], True))
        buf.append("leaf_count=" + _array_to_str(self.leaf_count[:nl]))
        buf.append("internal_value=" + _array_to_str(self.internal_value[:ni]))
        buf.append("internal_count=" + _array_to_str(self.internal_count[:ni]))
        if self.num_cat > 0:
            buf.append("cat_boundaries=" + _array_to_str(self.cat_boundaries))
            buf.append("cat_threshold=" + _array_to_str(self.cat_threshold))
        buf.append(f"shrinkage={self.shrinkage:g}")
        buf.append("")
        return "\n".join(buf) + "\n"

    @classmethod
    def from_string(cls, s: str) -> "Tree":
        kv: Dict[str, str] = {}
        for line in s.strip().split("\n"):
            if "=" in line:
                k, v = line.split("=", 1)
                kv[k] = v
        nl = int(kv["num_leaves"])
        t = cls(max(nl, 2))
        t.num_leaves = nl
        # inner (bin-space) fields are not serialized; boosters that want to
        # traverse this tree over a binned dataset must rebind it first
        t.needs_rebind = True
        t.num_cat = int(kv.get("num_cat", 0))
        ni = nl - 1

        def ints(key, n):
            if n == 0 or key not in kv or not kv[key]:
                return np.zeros(n, dtype=np.int32)
            return np.array(kv[key].split(), dtype=np.float64).astype(np.int32)[:n]

        def floats(key, n):
            if n == 0 or key not in kv or not kv[key]:
                return np.zeros(n, dtype=np.float64)
            return np.array(kv[key].split(), dtype=np.float64)[:n]

        if ni > 0:
            t.split_feature[:ni] = ints("split_feature", ni)
            t.split_gain[:ni] = floats("split_gain", ni)
            t.threshold[:ni] = floats("threshold", ni)
            t.decision_type[:ni] = ints("decision_type", ni).astype(np.int8)
            t.left_child[:ni] = ints("left_child", ni)
            t.right_child[:ni] = ints("right_child", ni)
            t.internal_value[:ni] = floats("internal_value", ni)
            t.internal_count[:ni] = ints("internal_count", ni)
        t.leaf_value[:nl] = floats("leaf_value", nl)
        t.leaf_count[:nl] = ints("leaf_count", nl)
        if t.num_cat > 0:
            t.cat_boundaries = [int(x) for x in kv["cat_boundaries"].split()]
            t.cat_threshold = [int(x) for x in kv["cat_threshold"].split()]
        t.shrinkage = float(kv.get("shrinkage", 1))
        # leaf_depth/leaf_parent are not part of the model text format
        # (matching `src/io/tree.cpp:207-240`), but the device traversal
        # sizes its scan by leaf_depth.max() — reconstruct both by walking
        # the child arrays from the root.
        t._rebuild_depths()
        return t

    def _rebuild_depths(self) -> None:
        if self.num_leaves <= 1:
            self.leaf_depth[:1] = 0
            return
        visited = set()
        leaves_seen = set()
        stack = [(0, 0)]  # (node, depth)
        while stack:
            node, depth = stack.pop()
            if node in visited or node >= self.num_leaves - 1:
                raise ValueError("malformed tree: child arrays do not form a "
                                 "binary tree")
            visited.add(node)
            for child in (self.left_child[node], self.right_child[node]):
                if child < 0:
                    leaf = ~child
                    if leaf >= self.num_leaves or leaf in leaves_seen:
                        raise ValueError("malformed tree: leaf index out of "
                                         "range or reached twice")
                    leaves_seen.add(leaf)
                    self.leaf_depth[leaf] = depth + 1
                    self.leaf_parent[leaf] = node
                else:
                    stack.append((int(child), depth + 1))
        # every internal node and every leaf must have been reached — an
        # unreachable node would leave leaf_depth at 0 and silently truncate
        # the device traversal scan (sized by leaf_depth.max())
        if len(visited) != self.num_leaves - 1 or \
                len(leaves_seen) != self.num_leaves:
            raise ValueError(
                f"malformed tree: walked {len(visited)} internal nodes / "
                f"{len(leaves_seen)} leaves, expected "
                f"{self.num_leaves - 1} / {self.num_leaves}")

    # -- JSON dump (Tree::ToJSON, `src/io/tree.cpp:215-313`) -----------------

    def to_json(self) -> Dict:
        out = {"num_leaves": int(self.num_leaves),
               "num_cat": int(self.num_cat),
               "shrinkage": float(self.shrinkage)}
        if self.num_leaves == 1:
            out["tree_structure"] = {"leaf_value": float(self.leaf_value[0])}
        else:
            out["tree_structure"] = self._node_to_json(0)
        return out

    def _node_to_json(self, index: int) -> Dict:
        if index >= 0:
            dt = int(self.decision_type[index])
            node = {
                "split_index": index,
                "split_feature": int(self.split_feature[index]),
                "split_gain": float(self.split_gain[index]),
            }
            if dt & K_CATEGORICAL_MASK:
                cat_idx = int(self.threshold[index])
                lo, hi = self.cat_boundaries[cat_idx], \
                    self.cat_boundaries[cat_idx + 1]
                cats = [c for c in range(32 * (hi - lo))
                        if _in_bitset(self.cat_threshold, lo, hi, c)]
                node["threshold"] = "||".join(str(c) for c in cats)
                node["decision_type"] = "=="
            else:
                node["threshold"] = _avoid_inf(float(self.threshold[index]))
                node["decision_type"] = "<="
            node["default_left"] = bool(dt & K_DEFAULT_LEFT_MASK)
            node["missing_type"] = {0: "None", 1: "Zero", 2: "NaN"}[
                (dt >> 2) & 3]
            node["internal_value"] = float(self.internal_value[index])
            node["internal_count"] = int(self.internal_count[index])
            node["left_child"] = self._node_to_json(
                int(self.left_child[index]))
            node["right_child"] = self._node_to_json(
                int(self.right_child[index]))
            return node
        leaf = ~index
        return {"leaf_index": leaf,
                "leaf_value": float(self.leaf_value[leaf]),
                "leaf_count": int(self.leaf_count[leaf])}

    # -- packed arrays for the device batch predictor ------------------------

    def pack(self) -> Dict[str, np.ndarray]:
        ni = max(self.num_leaves - 1, 1)
        return {
            "split_feature": self.split_feature[:ni],
            "threshold": self.threshold[:ni],
            "decision_type": self.decision_type[:ni],
            "left_child": self.left_child[:ni],
            "right_child": self.right_child[:ni],
            "leaf_value": self.leaf_value[:self.num_leaves],
            "num_leaves": self.num_leaves,
        }

    def __deepcopy__(self, memo):
        # device-array caches (_traverse_pack holds a weakref to a dataset
        # and jax arrays) must not survive a copy — they are rebuilt lazily
        import copy as _copy

        out = self.__class__(self.max_leaves)
        memo[id(self)] = out
        for k, v in self.__dict__.items():
            if k in ("_traverse_pack",):
                continue
            setattr(out, k, _copy.deepcopy(v, memo))
        return out

    def leaf_output(self, leaf: int) -> float:
        return float(self.leaf_value[leaf])

    def set_leaf_output(self, leaf: int, value: float) -> None:
        self.leaf_value[leaf] = value


def _to_bitset(vals: List[int]) -> List[int]:
    """Common::ConstructBitset (`utils/common.h`)."""
    if not vals:
        return []
    size = max(vals) // 32 + 1
    out = [0] * size
    for v in vals:
        out[v // 32] |= (1 << (v % 32))
    return out


def _in_bitset(bits: List[int], begin: int, end: int, val: int) -> bool:
    i1 = val // 32
    if i1 >= end - begin:
        return False
    return bool((bits[begin + i1] >> (val % 32)) & 1)
