"""Quantized-gradient primitives (plain torch: the JAX package has no kernel
here).

Port of ``lightgbm_tpu/ops/quant.py:60-153, 259-270``, LightGBM's
quantized-training recipe (Shi et al., NeurIPS 2022): per boosting round the
bagged float32 gradients and hessians are rounded onto a small integer grid,
``gq`` in [-GMAX, GMAX] and ``hq`` in [0, HMAX], with STOCHASTIC rounding and
a power-of-two scale per lane.  The dequantized lanes ``gq * sg`` and
``hq * sh`` are exact in float32, so every histogram of them is an exact
integer multiple of its scale (while the hessian mass stays below 2**24
quanta, the ``F32_EXACT_ROWS`` gate) and equal bit for bit whatever the
order of its sum: on the card's kernels, their plain versions and the JAX
package's kernels alike.

Stochastic rounding is stateless: a murmur3-finalizer hash of (row index,
float32 bits of the value, lane salt) supplies the uniform, so the results
are bitwise the JAX package's on the same float32 inputs.  torch has no
uint32 arithmetic with wraparound on every device, so the hash runs in
int64 and keeps the low 32 bits after every multiply and xor; the multiply
is split in 16-bit halves so that no int64 product overflows.

The JAX module's packed int32 accumulators and its int16 histogram-exchange
tier serve only the sharded learners and are not ported here.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

# the integer grids (3-bit gradients, 4-bit hessians)
GMAX = 7
HMAX = 15
#: float32 sums of the integer hessian mass are exact below 2**24 quanta
F32_EXACT_ROWS = (1 << 24) // HMAX

_M32 = 0xFFFFFFFF
_G_SALT = 0x51ED2701
_H_SALT = 0x3C6EF372


def pow2_ceil_scale(t: torch.Tensor) -> torch.Tensor:
    """Smallest power of two >= t (t > 0); 1.0 when t <= 0.  ``frexp``
    gives t = mant * 2**e with mant in [0.5, 1); 2**(e-1) is the answer when
    t is itself a power of two (mant == 0.5), else 2**e.  A subnormal t
    counts as 0, as in the JAX package, whose CPU and TPU backends flush
    subnormals to zero."""
    t = torch.as_tensor(t, dtype=torch.float32)
    mant, e = torch.frexp(t)
    one = torch.ones_like(t)
    scale = torch.where(mant == 0.5, torch.ldexp(one, e - 1),
                        torch.ldexp(one, e))
    normal = t >= torch.finfo(torch.float32).tiny
    return torch.where(normal, scale, one).to(torch.float32)


def _mul32(h: torch.Tensor, c: int) -> torch.Tensor:
    """(h * c) mod 2**32 for int64 h in [0, 2**32) without overflow."""
    hi = ((h >> 16) * c) & 0xFFFF
    return ((hi << 16) + (h & 0xFFFF) * c) & _M32


def _hash_uniform(idx: torch.Tensor, value: torch.Tensor,
                  salt: int) -> torch.Tensor:
    """Stateless uniform in [0, 1): murmur3 finalizer over the row index,
    the value's float32 bit pattern and a per-lane salt."""
    bits = value.to(torch.float32).contiguous().view(torch.int32) \
        .to(torch.int64) & _M32
    h = _mul32(idx.to(torch.int64) & _M32, 0x85EBCA6B)
    h = h ^ bits ^ salt
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    h = h ^ (h >> 16)
    return (h >> 8).to(torch.float32) * (2.0 ** -24)


def stochastic_round(x: torch.Tensor, idx: torch.Tensor,
                     salt: int) -> torch.Tensor:
    """Unbiased rounding: floor(x) + Bernoulli(frac(x)), the Bernoulli a
    pure function of (row index, value, lane)."""
    f = torch.floor(x)
    u = _hash_uniform(idx, x, salt)
    return f + (u < (x - f)).to(torch.float32)


def quantize_gradients(gb: torch.Tensor, hb: torch.Tensor, bag: torch.Tensor,
                       row_offset: int, max_abs_g: torch.Tensor,
                       max_abs_h: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                  torch.Tensor]:
    """Round bagged gradient / hessian rows onto the integer grid.

    gb, hb : (N,) float32 grad*bag, hess*bag;  bag : (N,) {0, 1}
    row_offset : the first row's global index (0 on one device)
    max_abs_g, max_abs_h : float32 scalars, max |gb| and max hb
    Returns (gd, hd, sg, sh): the dequantized lanes gq*sg*bag, hq*sh*bag
    (exact products) and the two scales.  Unbagged rows are exact zeros.
    """
    sg = pow2_ceil_scale(torch.as_tensor(max_abs_g, dtype=torch.float32)
                         / GMAX)
    sh = pow2_ceil_scale(torch.as_tensor(max_abs_h, dtype=torch.float32)
                         / HMAX)
    idx = row_offset + torch.arange(gb.shape[0], dtype=torch.int64,
                                    device=gb.device)
    gq = stochastic_round(gb / sg, idx, _G_SALT)
    gq = torch.clamp(gq, -float(GMAX), float(GMAX))
    hq = stochastic_round(hb / sh, idx, _H_SALT)
    hq = torch.clamp(hq, 0.0, float(HMAX))
    bagf = bag.to(torch.float32)
    return gq * sg * bagf, hq * sh * bagf, sg, sh


def quant_ineligible_reason(n_pad: int, hist_dp: bool) -> Optional[str]:
    """Why quantized-gradient training cannot run (None = it can); the
    JAX package's gate and messages."""
    if hist_dp:
        return ("hist_dp adds calibrated f32 noise to histogram bins; "
                "quantized integer-unit histograms would denoise it")
    if n_pad >= F32_EXACT_ROWS:
        return (f"padded rows {n_pad} >= {F32_EXACT_ROWS}: Σhq can "
                "leave the f32-exact integer window during histogram "
                "accumulation")
    return None
