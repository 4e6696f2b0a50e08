"""Histograms over unpacked bin codes: the dispatcher and the plain version.

Counterpart of ``lightgbm_tpu/ops/histogram.py``:

    hist[f, b, c] = sum_r [bins[f, r] == b] * w[c, r]

``build_histogram`` dispatches as the JAX package's does: ``dp`` takes the
plain float64 version on every device (the JAX package keeps dp off its
Pallas kernel, `ops/histogram.py:97-101`), everything else goes to
``ops/hist_full.py:build_histogram_full``, which launches the hand-written
kernel on a CUDA tensor and runs the plain version on a CPU tensor.

The JAX package contracts a one-hot expansion on the MXU; a dense one-hot
(28 x 1M x 256) does not fit here, so the plain version scatters with
``index_add_`` over a flat ``f * (B + 1) + bin`` index.  Codes at or past
``num_bins`` land in an overflow column that is dropped, matching the
one-hot's "no bin matches" semantics.  ``dp`` accumulates and returns float64
(the reference's ``gpu_use_dp``).  On CUDA ``index_add_`` uses atomics, so
float sums may differ between runs in the last bits; this is the plain
version the kernels are held against, not a path of the main program.
"""

from __future__ import annotations

import torch


def read_codes(bins: torch.Tensor, index=...) -> torch.Tensor:
    """``bins[index]`` widened to int64.  uint16 codes (past 256 bins) are
    read through an int16 view and masked back to 0..65535: the card has
    few kernels for uint16, and a view and an int16 index kernel are
    enough."""
    if bins.dtype == torch.uint16:
        return bins.view(torch.int16)[index].to(torch.int64) & 0xFFFF
    return bins[index].to(torch.int64)


def build_histogram(bins: torch.Tensor, w: torch.Tensor, *, num_bins: int,
                    dp: bool = False) -> torch.Tensor:
    """bins (F, N) uint8/uint16 codes, w (3, N) float32 -> (F, num_bins, 3),
    float64 with ``dp`` (see the module docstring)."""
    if dp:
        return build_histogram_onehot(bins, w, num_bins=num_bins, dp=True)
    from .hist_full import build_histogram_full
    return build_histogram_full(bins, w, num_bins=num_bins)


def build_histogram_onehot(bins: torch.Tensor, w: torch.Tensor, *,
                           num_bins: int, dp: bool = False) -> torch.Tensor:
    """bins (F, N) integer codes, w (C, N) weights -> (F, num_bins, C)."""
    f, n = bins.shape
    c = w.shape[0]
    acc = torch.float64 if dp else torch.float32
    codes = torch.clamp(read_codes(bins), max=num_bins)
    offs = torch.arange(f, device=bins.device, dtype=torch.int64) \
        * (num_bins + 1)
    idx = (codes + offs[:, None]).reshape(-1)
    src = w.to(acc).t().unsqueeze(0).expand(f, n, c).reshape(f * n, c)
    out = torch.zeros(f * (num_bins + 1), c, dtype=acc, device=bins.device)
    out.index_add_(0, idx, src)
    return out.view(f, num_bins + 1, c)[:, :num_bins]


def fix_histogram(hist: torch.Tensor, default_bin: torch.Tensor,
                  sum_g: torch.Tensor, sum_h: torch.Tensor,
                  cnt: torch.Tensor) -> torch.Tensor:
    """Recompute each feature's default-bin entry from leaf totals
    (``Dataset::FixHistogram``, `src/io/dataset.cpp:923-942`); the per-feature
    totals ``sum_g/sum_h/cnt`` have shape (F,)."""
    f, b, c = hist.shape
    totals = torch.stack([sum_g, sum_h, cnt], dim=-1).to(hist.dtype)  # (F, 3)
    d = default_bin.to(torch.int64)
    at_d = torch.gather(hist, 1, d[:, None, None].expand(f, 1, c))
    others = totals[:, None, :] - hist.sum(dim=1, keepdim=True) + at_d
    sel = torch.arange(b, device=hist.device)[None, :, None] == d[:, None, None]
    return torch.where(sel, others, hist)
