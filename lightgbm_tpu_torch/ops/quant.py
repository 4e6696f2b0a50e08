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

The packed int32 accumulators (``pack_gh``: both lanes of a row in one
word, ``gq * 2**16 + hq``) and the int16 histogram-exchange tier of the
sharded learners (``exchange_tier``, ``pack_hist_int16``) are the JAX
module's (`:161-254`).  Neither gloo nor NCCL reduces int16, so the
sharded learners send a histogram's integer units as one packed word per
bin (``pack_hist_words``): the gradient and hessian units, the count
channel rebuilt from the hessian units on arrival; the no-carry window of
the packed word is exactly the int16 tier's bound.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

# the integer grids (3-bit gradients, 4-bit hessians)
GMAX = 7
HMAX = 15
#: float32 sums of the integer hessian mass are exact below 2**24 quanta
F32_EXACT_ROWS = (1 << 24) // HMAX
#: the most rows of one bin whose packed words sum with no carry between
#: the lanes: sum(hq) < 2**16 and |sum(gq)| < 2**15
PACKED_SAFE_ROWS = min((1 << 16) // HMAX - 1, (1 << 15) // GMAX - 1)

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


# -- packed int32 accumulation (`:161-220`) ------------------------------------

def pack_gh(gq: torch.Tensor, hq: torch.Tensor) -> torch.Tensor:
    """gq * 2**16 + hq as carry-free int32 arithmetic; gq in [-GMAX, GMAX],
    hq in [0, HMAX] (or sums of such within ``PACKED_SAFE_ROWS`` rows)."""
    return gq.to(torch.int32) * (1 << 16) + hq.to(torch.int32)


def unpack_gh(word: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Decode a sum of packed words: hq = word & 0xFFFF (the low half never
    borrows while sum(hq) < 2**16), gq = (word - hq) >> 16."""
    word = word.to(torch.int32)
    hq = word & 0xFFFF
    return (word - hq) >> 16, hq


def hist_accumulate_packed(bins: torch.Tensor, packed: torch.Tensor, *,
                           num_bins: int) -> torch.Tensor:
    """One integer histogram pass over both lanes: out[f, b] = sum over rows
    r with bins[f, r] == b of packed[r].  Exact within the no-carry window
    (``PACKED_SAFE_ROWS`` rows per bin).  bins (F, N) codes, packed (N,)
    int32; returns (F, num_bins) int32."""
    f, n = bins.shape
    flat = (torch.arange(f, dtype=torch.int64, device=bins.device)[:, None]
            * num_bins + bins.to(torch.int64)).reshape(-1)
    vals = packed.to(torch.int32).expand(f, n).reshape(-1)
    out = torch.zeros(f * num_bins, dtype=torch.int32, device=bins.device)
    return out.index_add_(0, flat, vals).view(f, num_bins)


def hist_accumulate_packed_chunked(bins: torch.Tensor, gq: torch.Tensor,
                                   hq: torch.Tensor, *, num_bins: int,
                                   chunk: int = 4096
                                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Any-N exact packed accumulation: per chunk of at most
    ``PACKED_SAFE_ROWS`` rows pack, accumulate and unpack, summing the
    decoded lanes.  Returns ((F, num_bins) sum(gq), sum(hq)) int32."""
    if chunk > PACKED_SAFE_ROWS:
        raise ValueError(f"chunk {chunk} > PACKED_SAFE_ROWS "
                         f"{PACKED_SAFE_ROWS}")
    f, n = bins.shape
    sum_g = torch.zeros((f, num_bins), dtype=torch.int32, device=bins.device)
    sum_h = torch.zeros_like(sum_g)
    packed = pack_gh(gq, hq)
    for s in range(0, n, chunk):
        g, h = unpack_gh(hist_accumulate_packed(
            bins[:, s:s + chunk], packed[s:s + chunk], num_bins=num_bins))
        sum_g += g
        sum_h += h
    return sum_g, sum_h


# -- the histogram-exchange tier of the sharded learners (`:224-254`) ---------

def exchange_tier(n_global: int) -> str:
    """'int16' when every reduced channel provably fits int16 (sum(hq) <=
    HMAX * N is the binding bound), else 'f32'."""
    return "int16" if HMAX * n_global <= 32767 else "f32"


def pack_hist_int16(hist: torch.Tensor, inv_sg, inv_sh,
                    cnt_to_int=1.0) -> torch.Tensor:
    """(..., 3) quantized-unit histogram -> (..., 3) int16 integer units:
    the channels divided by (sg, sh, 1 / cnt_to_int), rounded to nearest
    (``cnt_to_int`` is the mean hessian mass per row, m)."""
    mul = torch.stack([torch.as_tensor(v, dtype=torch.float32,
                                       device=hist.device)
                       for v in (inv_sg, inv_sh, cnt_to_int)])
    return torch.round(hist * mul).to(torch.int16)


def unpack_hist_int16(h16: torch.Tensor, sg, sh, int_to_cnt=1.0
                      ) -> torch.Tensor:
    """Inverse of ``pack_hist_int16`` after the integer reduction;
    ``int_to_cnt`` is the float32 reciprocal 1 / m the serial count rescale
    uses, so the count channel is bitwise the serial one."""
    mul = torch.stack([torch.as_tensor(v, dtype=torch.float32,
                                       device=h16.device)
                       for v in (sg, sh, int_to_cnt)])
    return h16.to(torch.float32) * mul


def pack_hist_words(hist: torch.Tensor, inv_sg, inv_sh) -> torch.Tensor:
    """(..., 3) quantized-unit histogram -> (...) int32 words
    ``pack_gh(gq, hq)`` of its gradient and hessian units: the int16 tier's
    units, two to a word (a sum of words over ranks stays carry-free under
    ``exchange_tier``'s bound)."""
    h16 = pack_hist_int16(hist, inv_sg, inv_sh)
    return pack_gh(h16[..., 0], h16[..., 1])


def unpack_hist_words(words: torch.Tensor, sg, sh, int_to_cnt
                      ) -> torch.Tensor:
    """Inverse of ``pack_hist_words`` after the reduction: the (..., 3)
    channels of ``unpack_hist_int16``, the count from the hessian units
    (the count channel's integer is the hessian lane's)."""
    gq, hq = unpack_gh(words)
    return unpack_hist_int16(torch.stack([gq, hq, hq], -1), sg, sh,
                             int_to_cnt)
