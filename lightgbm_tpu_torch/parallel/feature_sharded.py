"""Feature-parallel compact and wave learners.

Port of ``lightgbm_tpu/parallel/feature_sharded.py``
(``tree_learner=feature``, `feature_parallel_tree_learner.cpp:29-73`):
every rank holds ALL rows, builds histograms and scans only over its slice
of the packed bin words, and the winning split is agreed with one
all-gather of the fixed-width winner rows; the row partition then runs
identically on every rank.  The packed word axis is padded to a multiple
of the mesh (padding words hold features with no bins, which never win);
rank d reads words ``[d * fws, (d + 1) * fws)``, a contiguous view of the
lanes, which the ``hist_packed`` / ``hist_segments`` / ``hist_multislot``
kernels take as they are.  No histogram crosses the wire: the row seams are
the serial learner's.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import Config
from ..dataset import _ConstructedDataset
from ..learner_compact import CompactTreeLearner
from ..learner_wave import WaveTreeLearner
from .compact_sharded import ShardedSeams
from .sharding import feature_axis


class FeatureSeams(ShardedSeams):
    """Replicated rows, a word slice of features per rank."""

    _placement_mode = "feature"

    def _set_geometry(self, data: _ConstructedDataset) -> None:
        self.axis = feature_axis(self.mesh)
        self.D = self.mesh.axis_size(self.axis)
        self.row_shards = 1
        fw = int(data.bins.shape[0]) // 4
        self.fw2 = -(-fw // self.D) * self.D
        self.fws = self.fw2 // self.D             # words per rank
        self.f_pad = self.fw2 * 4
        self.fs = self.fws * 4
        self._local_cols = self.fs
        self.f_off = self.mesh.axis_index(self.axis) * self.fs

    def exchange_probe(self):
        """(fn, args): feature parallel's only per-split wire traffic, the
        all-gather of the best-split rows (JAX ``feature_sharded.py:163``),
        on one zero row."""
        from ..learner import NUM_CF
        row = torch.zeros((1, NUM_CF), dtype=self._acc, device=self.device)
        return self._unledgered("all_gather", self.axis), (row,)

    def _code_rows(self) -> np.ndarray:
        codes = self.data.bins
        if codes.shape[0] < self.f_pad:
            codes = np.concatenate([codes, np.zeros(
                (self.f_pad - codes.shape[0], codes.shape[1]), codes.dtype)])
        return codes

    def _hist_bins(self, bins: torch.Tensor) -> torch.Tensor:
        w0 = self.mesh.axis_index(self.axis) * self.fws
        return bins[w0:w0 + self.fws]

    # rows are replicated: the serial row seams
    def _global_scalar(self, v):
        return v

    def _global_max(self, v):
        return v

    def _sync_counts(self, lc_bag, c_bag):
        return lc_bag, c_bag

    def _sync_counts3(self, counts):
        return counts

    def _replicated_spans(self, spans):
        return spans

    def _global_row_offset(self) -> int:
        return 0

    def _reduce_hist(self, local_hist):
        return local_hist

    def _reduce_hist_batch(self, local_hists):
        return local_hists


class FeatureShardedCompactLearner(FeatureSeams, CompactTreeLearner):
    """``tree_learner=feature`` on the compact learner."""


class FeatureShardedWaveLearner(FeatureSeams, WaveTreeLearner):
    """``tree_learner=feature`` on the frontier-wave learner: each wave's
    member histograms cover the rank's slice, and only the 2W best child
    splits are all-gathered per wave."""


def feature_sharded_eligible(cfg: Config, data: _ConstructedDataset,
                             mesh_size: int) -> bool:
    """The JAX package's gates (the padded feature and row counts divide
    by the mesh; codes pack four to a word)."""
    if data.max_num_bin > 256:
        return False
    if data.bins.shape[0] % max(mesh_size, 1):
        return False
    if data.num_data_padded % max(mesh_size, 1):
        return False
    return True

