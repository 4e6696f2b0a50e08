"""Model → C++ if-else source (``task=convert_model``).

Port of ``lightgbm_tpu/convert.py``; the source it writes is the JAX
package's, character for character.  The analogue of
``GBDT::SaveModelToIfElse`` / ``Tree::ToIfElse``
(`src/boosting/gbdt_model_text.cpp:169-242`, `src/io/tree.cpp:315-470`):
emits one ``PredictTree<i>`` function per tree
plus a ``Predict`` driver summing raw scores.  The generated file is
standalone C++ (only <cmath>/<vector>/<cstdint>), unlike the reference's
(which compiles into its own source tree), but the split semantics emitted
are the same decision-type bit tests.
"""

from __future__ import annotations

import math
from typing import List

from .tree import Tree, K_CATEGORICAL_MASK, K_DEFAULT_LEFT_MASK


_IS_ZERO = "(fval > -1e-35 && fval <= 1e-35)"


def _num_decision(tree: Tree, nd: int) -> str:
    """NumericalDecisionIfElse (`src/io/tree.cpp:322-340`) — exact
    reference conditions."""
    missing_type = (int(tree.decision_type[nd]) >> 2) & 3
    default_left = bool(int(tree.decision_type[nd]) & K_DEFAULT_LEFT_MASK)
    thrf = float(tree.threshold[nd])
    thr = repr(thrf)
    f = int(tree.split_feature[nd])
    out = f"fval = arr[{f}];"
    if missing_type == 0 or (missing_type == 1 and default_left
                             and 1e-35 < thrf):
        cond = f"fval <= {thr}"
    elif missing_type == 1:
        if default_left:
            cond = f"fval <= {thr} || {_IS_ZERO} || std::isnan(fval)"
        else:
            cond = f"fval <= {thr} && !{_IS_ZERO} && !std::isnan(fval)"
    else:
        if default_left:
            cond = f"fval <= {thr} || std::isnan(fval)"
        else:
            cond = f"fval <= {thr} && !std::isnan(fval)"
    return out + f" if ({cond})"


def _cat_decision(tree: Tree, nd: int) -> str:
    """CategoricalDecisionIfElse (`src/io/tree.cpp:340-351`)."""
    f = int(tree.split_feature[nd])
    cat_idx = int(tree.threshold[nd])
    lo = tree.cat_boundaries[cat_idx]
    hi = tree.cat_boundaries[cat_idx + 1]
    return (f"fval = arr[{f}]; int_fval = std::isnan(fval) ? -1 : "
            f"static_cast<int>(fval); if (int_fval >= 0 && "
            f"int_fval < {32 * (hi - lo)} && ((cat_threshold[{lo} + "
            f"int_fval / 32] >> (int_fval % 32)) & 1))")


def _node_to_if_else(tree: Tree, nd: int, leaf_index: bool,
                     buf: List[str]) -> None:
    if nd >= 0:
        if int(tree.decision_type[nd]) & K_CATEGORICAL_MASK:
            buf.append(_cat_decision(tree, nd))
        else:
            buf.append(_num_decision(tree, nd))
        buf.append("{")
        _node_to_if_else(tree, int(tree.left_child[nd]), leaf_index, buf)
        buf.append("} else {")
        _node_to_if_else(tree, int(tree.right_child[nd]), leaf_index, buf)
        buf.append("}")
    else:
        leaf = ~nd
        val = leaf if leaf_index else float(tree.leaf_value[leaf])
        buf.append(f"return {val!r};" if not leaf_index
                   else f"return {leaf};")


def tree_to_if_else(tree: Tree, index: int, leaf_index: bool = False) -> str:
    name = f"PredictTree{index}" + ("Leaf" if leaf_index else "")
    buf = [f"double {name}(const double* arr) {{"]
    if tree.num_leaves <= 1:
        buf.append(f"return {float(tree.leaf_value[0])!r};")
    else:
        cats = ",".join(str(int(v)) for v in tree.cat_threshold)
        buf.append(f"static const std::vector<uint32_t> cat_threshold = "
                   f"{{{cats}}};")
        buf.append("double fval = 0.0;")
        if tree.num_cat > 0:
            buf.append("int int_fval = 0;")
        buf.append("(void)fval;")
        _node_to_if_else(tree, 0, leaf_index, buf)
    buf.append("}")
    return "\n".join(buf) + "\n"


def model_to_if_else(gbdt) -> str:
    """``GBDT::SaveModelToIfElse`` — all trees + Predict drivers."""
    k = max(gbdt.num_tree_per_iteration, 1)
    models = gbdt.models
    out = ["// generated by lightgbm_tpu task=convert_model",
           "#include <cmath>", "#include <cstdint>", "#include <vector>",
           ""]
    for i, t in enumerate(models):
        out.append(tree_to_if_else(t, i))
    n = len(models)
    out.append(f"const int kNumTrees = {n};")
    out.append(f"const int kNumClass = {k};")
    calls = " + ".join(f"PredictTree{i}(arr)" for i in range(n)) or "0.0"
    if k == 1:
        out.append("double Predict(const double* arr) { return "
                   + calls + "; }")
    else:
        out.append("void Predict(const double* arr, double* output) {")
        for c in range(k):
            cc = " + ".join(f"PredictTree{i}(arr)"
                            for i in range(c, n, k)) or "0.0"
            out.append(f"  output[{c}] = {cc};")
        out.append("}")
    return "\n".join(out) + "\n"
