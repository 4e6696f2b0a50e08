"""Fused child scans of a quantized growth wave (CUDA kernel + plain torch).

Port of ``lightgbm_tpu/ops/scan_pallas.py:fused_child_scans``: for all K
members of a wave, given each member's SMALLER-child histogram and its
parent's pooled histogram, one call does the sibling subtraction, the
left/right selection, the raw children's pool writes, the per-child
``FixHistogram`` and both children's split scans.  The candidates come back
as a (2K, F)-batched ``SplitCandidates`` in the interleaved child order
[l0, r0, l1, r1, ...] with ``find_best_splits``'s conventions.

Where the TPU kernel hands the raw children back for the caller's pool
writes, this port writes them into the pool in place: the left child over
the parent's slot ``ph[k]``, the right child into the fresh slot ``rh[k]``,
as the wave learner's unfused step does.

On a CUDA tensor ``fused_child_scans`` launches the hand-written Hopper
kernel ``csrc/fused_scan.cu`` (design and bound in that file's header); on a
CPU tensor it runs ``fused_child_scans_plain``, the unfused composition the
wave learner runs without it: subtraction, ``ops/split.py:fix_histogram``
and ``find_best_splits``.  On exact sums (quantized or dyadic histograms)
every field and both pool rows agree bit for bit.
"""

from __future__ import annotations

import ctypes

import torch

from .. import native
from .scan import N_OUT, candidates_from_planes, leaf_totals
from .split import SplitCandidates, find_best_splits, fix_histogram


def _check_pool(h_small, pool, ph, rh, left_small):
    k, f, b, c = h_small.shape
    if c != 3 or pool.dim() != 4 or tuple(pool.shape[1:]) != (f, b, 3):
        raise ValueError(f"h_small must be (K, F, B, 3) and pool (H, F, B, 3)"
                         f", got {tuple(h_small.shape)} and "
                         f"{tuple(pool.shape)}")
    if any(t.shape != (k,) for t in (ph, rh, left_small)):
        raise ValueError("ph, rh and left_small must be (K,)")


def fused_child_scans_plain(h_small: torch.Tensor, pool: torch.Tensor,
                            ph: torch.Tensor, rh: torch.Tensor,
                            left_small: torch.Tensor, sum_g2: torch.Tensor,
                            sum_h2: torch.Tensor, num2: torch.Tensor,
                            num_bin: torch.Tensor, missing_type: torch.Tensor,
                            default_bin: torch.Tensor,
                            feature_mask: torch.Tensor, **kw
                            ) -> SplitCandidates:
    """Plain torch version: the unfused composition (see the module
    docstring); ``kw`` are ``find_best_splits``'s split parameters."""
    _check_pool(h_small, pool, ph, rh, left_small)
    k = h_small.shape[0]
    ph, rh = ph.to(torch.int64), rh.to(torch.int64)
    h_large = pool.index_select(0, ph) - h_small
    lsm = left_small.view(k, 1, 1, 1)
    hl = torch.where(lsm, h_small, h_large)
    hr = torch.where(lsm, h_large, h_small)
    pool.index_copy_(0, ph, hl)
    pool.index_copy_(0, rh, hr)
    h2 = torch.stack([hl, hr], 1).reshape((2 * k,) + hl.shape[1:])
    h2 = fix_histogram(h2, sum_g2, sum_h2, num2, default_bin)
    return find_best_splits(h2, sum_g2, sum_h2, num2, num_bin, missing_type,
                            default_bin, feature_mask, **kw)


_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        lib = native.load("fused_scan")
        lib.lgbt_fused_scan.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
            ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_float,
            ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p]
        lib.lgbt_fused_scan.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def fused_child_scans(h_small: torch.Tensor, pool: torch.Tensor,
                      ph: torch.Tensor, rh: torch.Tensor,
                      left_small: torch.Tensor, sum_g2: torch.Tensor,
                      sum_h2: torch.Tensor, num2: torch.Tensor,
                      num_bin: torch.Tensor, missing_type: torch.Tensor,
                      default_bin: torch.Tensor, feature_mask: torch.Tensor,
                      *, lambda_l1: float = 0.0, lambda_l2: float = 0.0,
                      max_delta_step: float = 0.0,
                      min_data_in_leaf: int = 20,
                      min_sum_hessian_in_leaf: float = 1e-3,
                      min_gain_to_split: float = 0.0) -> SplitCandidates:
    """Subtract, select, write the pool, fix and scan both children of K
    members.

    h_small    : (K, F, B, 3) float32, each member's smaller child
    pool       : (H, F, B, 3) float32 histogram pool, written in place: the
                 left child over ``ph[k]`` (which holds the parent), the
                 right child into ``rh[k]``; the slots must be distinct
    left_small : (K,) bool;  sum_g2, sum_h2, num2 : (2K,) child totals,
                 interleaved [l0, r0, l1, r1, ...]
    Returns (2K, F)-batched ``SplitCandidates``.  CPU tensors take the plain
    version; CUDA tensors launch the kernel (counted in
    ``fused_child_scans.launches``) or raise.
    """
    kw = dict(lambda_l1=lambda_l1, lambda_l2=lambda_l2,
              max_delta_step=max_delta_step,
              min_data_in_leaf=min_data_in_leaf,
              min_sum_hessian_in_leaf=min_sum_hessian_in_leaf,
              min_gain_to_split=min_gain_to_split)
    if h_small.device.type == "cpu" and pool.device.type == "cpu":
        return fused_child_scans_plain(
            h_small, pool, ph, rh, left_small, sum_g2, sum_h2, num2, num_bin,
            missing_type, default_bin, feature_mask, **kw)
    dev = pool.device
    if dev.type != "cuda" or h_small.device != dev:
        raise ValueError("h_small and pool must lie on one CUDA device")
    if h_small.dtype != torch.float32 or pool.dtype != torch.float32 \
            or h_small.dim() != 4:
        raise ValueError("h_small and pool must be float32 (K, F, B, 3) and "
                         "(H, F, B, 3) tensors")
    _check_pool(h_small, pool, ph, rh, left_small)
    if not pool.is_contiguous():
        raise ValueError("pool must be contiguous (it is written in place)")
    k, f, b, _ = h_small.shape
    if not 1 <= b <= 256 or k < 1 or f < 1:
        raise ValueError(f"need K, F >= 1 and 1 <= B <= 256, got {k, f, b}")
    ints = [t.to(torch.int32).contiguous() for t in
            (ph, rh, left_small, num_bin, missing_type, default_bin)]
    if any(t.device != dev for t in ints) \
            or any(t.shape != (f,) for t in ints[3:]):
        raise ValueError("slots, flags and (F,) feature metadata must lie on "
                         "the pool's device")
    total_g, total_h, total_n, min_gain_shift = leaf_totals(
        sum_g2, sum_h2, num2, torch.float32, lambda_l1=lambda_l1,
        lambda_l2=lambda_l2, max_delta_step=max_delta_step,
        min_gain_to_split=min_gain_to_split)
    tot = torch.stack([total_g, sum_h2.to(torch.float32), total_h, total_n,
                       min_gain_shift], 1).contiguous()
    if tot.shape != (2 * k, 5) or tot.device != dev:
        raise ValueError("child totals must be (2K,) on the pool's device")
    h_small = h_small.contiguous()
    out = torch.empty((2 * k, N_OUT, f), dtype=torch.float32, device=dev)
    p = 1 << (b - 1).bit_length()
    stream = torch.cuda.current_stream(dev).cuda_stream
    native.launch("fused_scan", _lib().lgbt_fused_scan, h_small, pool,
                  *ints[:3], tot, *ints[3:], k, f, b, p, float(lambda_l1),
                  float(lambda_l2), float(max_delta_step),
                  int(max_delta_step > 0.0), float(min_data_in_leaf),
                  float(min_sum_hessian_in_leaf), out, stream)
    fused_child_scans.launches += 1
    return candidates_from_planes(out, total_g, total_h, total_n,
                                  min_gain_shift, feature_mask)


fused_child_scans.launches = 0
