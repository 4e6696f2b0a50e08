"""GOSS: gradient-based one-side sampling (`src/boosting/goss.hpp:26-200`).

Port of ``lightgbm_tpu/boosting/goss.py``.  Keep the ``top_rate`` share of
rows with the largest |grad * hess| (summed over classes), draw
``other_rate`` of the rest uniformly and amplify the drawn rows' gradients
by the rest's count over the drawn count, so histogram sums stay unbiased.
The selection runs on the device with no host read (``goss_select``), so
GOSS keeps the pipelined loop and one host read per tree; the bag mask and
the amplified gradients reach the wave learner through its root, so its
CUDA graphs stay as captured.

The top set is exact by magnitude with the lower row index first among
equal magnitudes, the order of ``jax.lax.top_k``: a stable descending sort
(``torch.topk`` leaves the tie order unspecified on CUDA).  The uniform
draws come from a ``torch.Generator`` on the booster's device seeded from
``bagging_seed`` and the iteration (``_goss_uniform``); they cannot be the
JAX package's threefry stream, so the parity tests replace that one method
with JAX's draws.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from .gbdt import GBDT


def goss_select(grad: torch.Tensor, hess: torch.Tensor,
                valid_rows: torch.Tensor, u: torch.Tensor, top_k: int,
                other_k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """JAX ``_goss_select`` (``goss.py:24-42``): (K, N) gradients and
    hessians, (N,) float32 valid-row mask (0 on padding), (N,) uniform
    draws -> (bag mask (N,) float32, amplification (N,) float32).  The
    counts and the amplification stay device scalars, in float32."""
    mag = torch.abs(grad * hess).sum(0)
    valid = valid_rows > 0.5
    magv = torch.where(valid, mag, float("-inf"))
    vals, idx = torch.sort(magv, descending=True, stable=True)
    is_top = torch.zeros_like(valid).scatter_(
        0, idx[:top_k], ~torch.isneginf(vals[:top_k]))
    rest = valid & ~is_top
    n_rest = rest.sum()
    p = torch.clamp(other_k / torch.clamp(n_rest, min=1), max=1.0)
    sampled = rest & (u < p)
    n_samp = torch.clamp(sampled.sum(), min=1)
    multiply = n_rest.to(torch.float32) / n_samp.to(torch.float32)
    bag = (is_top | sampled).to(torch.float32)
    amp = torch.where(sampled, multiply, 1.0).to(torch.float32)
    return bag, amp


class GOSS(GBDT):
    name = "goss"

    def init(self, train_data, objective, training_metrics=()) -> None:
        cfg = self.cfg
        if not (cfg.top_rate + cfg.other_rate <= 1.0
                and cfg.top_rate > 0 and cfg.other_rate > 0):
            raise ValueError("top_rate + other_rate must be in (0, 1] with "
                             "both positive for GOSS")
        if cfg.bagging_freq > 0 and cfg.bagging_fraction != 1.0:
            raise ValueError("Cannot use bagging in GOSS")
        super().init(train_data, objective, training_metrics)
        #: the last sampled iteration's (iteration, top_k, bagged rows as a
        #: device scalar: top_k plus the drawn rest), None before the first
        self.last_draw: Optional[tuple] = None

    def _goss_uniform(self, iter_: int) -> torch.Tensor:
        """(N_pad,) float32 uniform draws of iteration ``iter_``."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed((int(self.cfg.bagging_seed) * 1_000_003 + iter_)
                        % (1 << 63))
        return torch.rand(self.train_data.num_data_padded, generator=gen,
                          device=self.device, dtype=torch.float32)

    def _sample(self, grads: List[tuple]) -> List[tuple]:
        """No sampling before iteration ``int(1 / learning_rate)``
        (`goss.hpp:139-141`); then the device selection, the amplified
        gradients and the new bag mask (its host copy left unread)."""
        cfg = self.cfg
        self._np_bag_mask = None
        if self.iter_ < int(1.0 / cfg.learning_rate):
            self._bag_mask = self._valid_rows
            return grads
        n = self.num_data
        top_k = max(1, int(n * cfg.top_rate))
        other_k = max(1, int(n * cfg.other_rate))
        # the selection is global: every rank selects from the whole
        # row axis and keeps its rows of the bag and the amplification
        g = self._global(torch.stack([a for a, _ in grads]), "score")
        h = self._global(torch.stack([b for _, b in grads]), "score")
        bag, amp = goss_select(g, h, self._global(self._valid_rows),
                               self._goss_uniform(self.iter_), top_k,
                               other_k)
        self.last_draw = (self.iter_, top_k, bag.to(torch.int64).sum())
        bag, amp = self._local(bag), self._local(amp)
        self._bag_mask = bag
        return [(a * amp, b * amp) for a, b in grads]
