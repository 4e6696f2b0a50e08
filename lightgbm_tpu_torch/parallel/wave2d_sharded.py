"""2-D hybrid data x feature frontier-wave learner
(``tree_learner=data_feature``).

Port of ``lightgbm_tpu/parallel/wave2d_sharded.py``.  Each rank of a
(data, feature) mesh of Dd x Df ranks owns a TILE of the packed bins: the
word slice ``[j * fws, (j + 1) * fws)`` of feature column j over the row
shard i (``rules_for_mode("data_feature")``'s ``(feature, data)`` spec), so

  * member histograms cover ``fs_col = 4 * fws`` features of the local rows,
    and the per-wave reduce-scatter runs along the ``data`` axis only: Dd
    ranks moving (W, fs_col, B, 3) instead of the 1-D mode's D ranks moving
    (W, f_pad, B, 3);
  * each rank scans its ``fs = fs_col / Dd`` slice of the reduced column,
    and the winners merge in ONE all-gather over both axes with an explicit
    lowest-feature tie-break (tile offsets are not ascending in rank order);
  * the one new exchange is the decide pass's word: a row's split feature
    lives on one feature column, so every rank reads the words it holds
    (zero elsewhere) and one (rows,) int32 sum along ``feature`` hands every
    rank of the column group the same words, hence the same partition.

The JAX learner's double-buffered half-wave reduce-scatters
(``tpu_wave_hist_buffers``) overlap XLA's async collectives with the next
group's accumulation; the eager port issues one reduce-scatter per wave.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..config import Config
from ..dataset import _ConstructedDataset
from ..learner_wave import WaveTreeLearner, wave_budget_reason
from .compact_sharded import ShardedSeams
from .sharding import AXIS_DATA, AXIS_FEATURE, Mesh


def _mesh_dims(mesh: Mesh):
    shape = dict(zip(mesh.axis_names, mesh.shape))
    return int(shape.get(AXIS_DATA, 1)), int(shape.get(AXIS_FEATURE, 1))


class ShardedWave2DLearner(ShardedSeams, WaveTreeLearner):
    """One tile of the bins per rank (see the module docstring).  The row
    seams of the 1-D data learner ride the ``data`` axis."""

    _placement_mode = "data_feature"

    def _set_geometry(self, data: _ConstructedDataset) -> None:
        self.axis, self.faxis = AXIS_DATA, AXIS_FEATURE
        self.Dd, self.Df = _mesh_dims(self.mesh)
        self.D = self.Dd * self.Df
        self.row_shards = self.Dd
        reason = _tile_reason(int(data.num_data_padded),
                              int(data.bins.shape[0]), self.Dd, self.Df)
        if reason is not None:
            raise ValueError(reason)
        self.f_pad = int(data.bins.shape[0])
        self.fws = self.f_pad // 4 // self.Df     # words of a tile
        self.fs_col = self.fws * 4                # features of a column
        self.fs = self.fs_col // self.Dd          # scanned per rank
        self._local_cols = self.fs_col
        i = self.mesh.axis_index(self.axis)
        j = self.mesh.axis_index(self.faxis)
        self.f_off = j * self.fs_col + i * self.fs
        self._w0 = j * self.fws

    def _code_rows(self) -> np.ndarray:
        return self.data.bins[4 * self._w0:4 * (self._w0 + self.fws)]

    def _row_words(self, bins_p: torch.Tensor, widx: torch.Tensor
                   ) -> torch.Tensor:
        """The words a row's split reads: this tile's (zero for a word of
        another column), summed along ``feature`` (JAX ``_word_select``)."""
        loc = widx.to(torch.int64) - self._w0
        mine = (loc >= 0) & (loc < self.fws)
        word = bins_p.gather(0, torch.clamp(loc, 0, self.fws - 1)
                             .view(1, -1))[0]
        word = torch.where(mine, word, 0)
        return self._coll("psum", word, self.faxis)

    def _merge_axis(self):
        return None                      # the whole mesh, row-major order

    def _merge_cands(self, cf, ci, cb, lowest_feature: bool = True):
        return super()._merge_cands(cf, ci, cb, lowest_feature=True)


def _tile_reason(n_pad: int, f_pad: int, dd: int, df: int) -> Optional[str]:
    if f_pad % 4:
        return f"padded features {f_pad} not word-aligned"
    if n_pad % max(dd, 1):
        return f"padded rows {n_pad} % data axis {dd} != 0"
    fw = f_pad // 4
    if fw % max(df, 1):
        return f"packed words {fw} % feature axis {df} != 0"
    fs_col = (fw // max(df, 1)) * 4
    if fs_col % max(dd, 1):
        return f"feature column {fs_col} % data axis {dd} != 0"
    return None


def wave2d_ineligible_reason(cfg: Config, data: _ConstructedDataset,
                             mesh: Mesh) -> Optional[str]:
    """Why ``tree_learner=data_feature`` cannot run on this mesh and
    dataset (None = eligible): the tile geometry, then the serial wave
    budget at the tile's shape (the JAX package's gates and messages)."""
    if cfg.tpu_learner not in ("auto", "wave"):
        return f"tpu_learner={cfg.tpu_learner} (2D mode is wave-only)"
    if data.max_num_bin > 256:
        return f"max_num_bin {data.max_num_bin} > 256"
    dd, df = _mesh_dims(mesh)
    n_pad = int(data.num_data_padded)
    f_pad = int(data.bins.shape[0])
    reason = _tile_reason(n_pad, f_pad, dd, df)
    if reason is not None:
        return reason
    fs_col = (f_pad // 4 // max(df, 1)) * 4
    return wave_budget_reason(cfg, n_pad // max(dd, 1), fs_col,
                              int(data.max_num_bin))
