"""Plain torch histograms over unpacked bin codes.

Counterpart of ``lightgbm_tpu/ops/histogram.py``:

    hist[f, b, c] = sum_r [bins[f, r] == b] * w[c, r]

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


def build_histogram_onehot(bins: torch.Tensor, w: torch.Tensor, *,
                           num_bins: int, dp: bool = False) -> torch.Tensor:
    """bins (F, N) integer codes, w (C, N) weights -> (F, num_bins, C)."""
    f, n = bins.shape
    c = w.shape[0]
    acc = torch.float64 if dp else torch.float32
    codes = torch.clamp(bins.to(torch.int64), max=num_bins)
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
