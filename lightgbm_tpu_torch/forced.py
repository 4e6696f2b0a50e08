# Port copy of lightgbm_tpu/forced.py: the port keeps its own copy so that
# importing it never runs lightgbm_tpu/__init__.py (which imports JAX).
"""Forced splits: host-side parsing of ``forcedsplits_filename``.

The reference applies a user-supplied JSON tree of (feature, threshold)
splits at the start of EVERY tree, breadth-first, before best-gain growth
(`src/treelearner/serial_tree_learner.cpp:543-663` ``ForceSplits``; config
`include/LightGBM/config.h:361-365`).  The JSON structure is fixed at
config time, so the whole BFS — including each node's target leaf index —
is static:

  * pop k of the BFS splits leaf ``L_k``: the left child keeps ``L_k``,
    the right child becomes leaf ``k + 1`` (the reference's
    ``Tree::Split`` numbering), so ``L_child`` is known at parse time;
  * only the VALIDITY of each split (gain-vs-no-split at the forced
    threshold) is data-dependent — an invalid split aborts the remaining
    queue (`serial_tree_learner.cpp:612-616`), which the masked and the
    compact learners carry as an ``aborted`` device flag (no read of a
    split's validity to the host).
"""

from __future__ import annotations

import json
import warnings
from typing import List, Optional

from .binning import BIN_CATEGORICAL


class ForcedSplit:
    """One BFS entry of the forced-split tree (all fields static)."""

    __slots__ = ("leaf", "feature_inner", "threshold_bin", "is_cat")

    def __init__(self, leaf: int, feature_inner: int, threshold_bin: int,
                 is_cat: bool):
        self.leaf = leaf
        self.feature_inner = feature_inner
        self.threshold_bin = threshold_bin
        self.is_cat = is_cat


def load_forced_splits(filename: str, data) -> Optional[List[ForcedSplit]]:
    """Parse the forced-splits JSON against a constructed dataset's bin
    mappers; returns the BFS-ordered static split list (None when the tree
    is empty or unusable)."""
    with open(filename) as fh:
        root = json.load(fh)
    if not isinstance(root, dict) or "feature" not in root \
            or "threshold" not in root:
        return None
    inner_of = {int(j): k for k, j in enumerate(data.used_feature_map)}
    out: List[ForcedSplit] = []
    queue = [(root, 0)]        # (json node, target leaf)
    num_splits = 0
    while queue:
        node, leaf = queue.pop(0)
        real = int(node["feature"])
        if real not in inner_of:
            warnings.warn(
                f"forced split on feature {real} ignored: the feature is "
                f"trivial or unused; aborting the remaining forced splits")
            break
        inner = inner_of[real]
        mapper = data.bin_mappers[inner]
        thr_bin = int(mapper.value_to_bin(float(node["threshold"])))
        out.append(ForcedSplit(leaf, inner, thr_bin,
                               mapper.bin_type == BIN_CATEGORICAL))
        num_splits += 1
        left_leaf, right_leaf = leaf, num_splits
        for key, child_leaf in (("left", left_leaf), ("right", right_leaf)):
            ch = node.get(key)
            if isinstance(ch, dict) and "feature" in ch and "threshold" in ch:
                queue.append((ch, child_leaf))
    return out or None
