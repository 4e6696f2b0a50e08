"""Batched best-split scan of the wave learner (CUDA kernel + plain torch).

Port of ``lightgbm_tpu/ops/scan_pallas.py:find_best_splits_batched``: the
best numerical threshold of every (leaf, feature) of a ``(K, F, B, 3)``
float32 histogram cube, as ``SplitCandidates`` with the post-shift gain and
``K_EPSILON`` conventions of ``ops/split.py:find_best_splits`` (and of
``scan_pallas.py:236-248``).  The histograms arrive already unbundled and
FixHistogram'd, as in the JAX package.

On a CUDA tensor ``find_best_splits_batched`` is one launch of the
hand-written Hopper kernel ``csrc/split_scan.cu`` (design and bound in that
file's header), which forms the leaf totals, scans, masks features and
writes every ``SplitCandidates`` field itself, bitwise equal to the plain
version on the CPU; no other device op runs.  On a CPU tensor it runs the
plain version, ``ops/split.py:find_best_splits`` with its batch axis and
both missing-direction scans.  The kernel is float32 only: ``gpu_use_dp``
keeps the plain float64 path, as the JAX package gates its scan kernel off
in dp.  The fused child-scan kernel (``ops/fused_scan.py``) writes the same
planes.

Monotone constraints and ``feature_contri`` penalties go through the same
kernel (the JAX package sends them to its XLA scan, off the Pallas one,
``scan_pallas.py:scan_ineligible_reason``): per-leaf value bounds (K,), a
monotone sign (F,) and a gain penalty (F,), any of them None.  A call with
none of them launches the unconstrained instantiation, unchanged.
"""

from __future__ import annotations

import ctypes

import torch

from .. import native
from .split import SplitCandidates, find_best_splits

#: the scan kernels' float32 planes, in SplitCandidates order without
#: default_left (its own bool tensor); plane 1 holds the int32 threshold
N_PLANES = 10

_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        lib = native.load("split_scan")
        lib.lgbt_split_scan.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
            ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
            ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
            ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_float,
            ctypes.c_float, ctypes.c_float, ctypes.c_void_p,
            ctypes.c_longlong, ctypes.c_void_p, ctypes.c_longlong,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p]
        lib.lgbt_split_scan.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def candidates_from_kernel(planes: torch.Tensor,
                           dleft: torch.Tensor) -> SplitCandidates:
    """A scan kernel's (N_PLANES, rows, F) planes and (rows, F)
    default_left as ``SplitCandidates`` (views, no device op)."""
    p = planes.unbind(0)
    return SplitCandidates(p[0], p[1].view(torch.int32), dleft, *p[2:])


def find_best_splits_batched(hist: torch.Tensor, sum_gradients: torch.Tensor,
                             sum_hessians: torch.Tensor,
                             num_data: torch.Tensor, num_bin: torch.Tensor,
                             missing_type: torch.Tensor,
                             default_bin: torch.Tensor,
                             feature_mask: torch.Tensor, monotone=None,
                             min_constraint=None, max_constraint=None, *,
                             lambda_l1: float = 0.0, lambda_l2: float = 0.0,
                             max_delta_step: float = 0.0,
                             min_data_in_leaf: int = 20,
                             min_sum_hessian_in_leaf: float = 1e-3,
                             min_gain_to_split: float = 0.0,
                             penalty=None) -> SplitCandidates:
    """hist (K, F, B, 3) float32, leaf totals (K,), feature metadata (F,),
    feature_mask (F,) or (K, F) bool, and optionally the monotone sign (F,)
    int8, the leaves' value bounds (K,) (both or neither) and the gain
    penalty (F,) -> (K, F)-batched ``SplitCandidates``.  CPU tensors take
    the plain version; CUDA tensors launch the kernel (counted in
    ``find_best_splits_batched.launches``, the constrained launches also in
    ``.con_launches``) or raise."""
    kw = dict(lambda_l1=lambda_l1, lambda_l2=lambda_l2,
              max_delta_step=max_delta_step,
              min_data_in_leaf=min_data_in_leaf,
              min_sum_hessian_in_leaf=min_sum_hessian_in_leaf,
              min_gain_to_split=min_gain_to_split)
    if hist.device.type == "cpu":
        return find_best_splits(hist, sum_gradients, sum_hessians, num_data,
                                num_bin, missing_type, default_bin,
                                feature_mask, monotone, min_constraint,
                                max_constraint, penalty=penalty, **kw)
    dev = hist.device
    if dev.type != "cuda":
        raise ValueError(f"hist must lie on the CPU or a CUDA device, not "
                         f"{dev}")
    if hist.dtype != torch.float32 or hist.dim() != 4 or hist.shape[-1] != 3:
        raise ValueError(f"hist must be a (K, F, B, 3) float32 tensor, got "
                         f"{hist.dtype} {tuple(hist.shape)}")
    k, f, b, _ = hist.shape
    if not 1 <= b <= 256 or k < 1 or f < 1:
        raise ValueError(f"need K, F >= 1 and 1 <= B <= 256, got {k, f, b}")
    # every conversion below is a no-op for the learner's tensors (float32
    # sums, int32 metadata, a bool mask, a contiguous cube): the call is
    # then one kernel launch and no other device op
    meta = [t.to(torch.int32).contiguous() for t in
            (num_bin, missing_type, default_bin)]
    if any(t.shape != (f,) or t.device != dev for t in meta):
        raise ValueError("feature metadata must be (F,) on the hist's device")
    sums = [t.to(torch.float32) for t in (sum_gradients, sum_hessians,
                                          num_data)]
    if any(t.shape != (k,) or t.device != dev for t in sums):
        raise ValueError("leaf totals must be (K,) on the hist's device")
    fm = feature_mask.to(torch.bool)
    if fm.device != dev or fm.shape not in ((f,), (k, f)):
        raise ValueError(f"feature_mask must be ({f},) or ({k}, {f}) on the "
                         f"hist's device")
    if fm.stride(-1) != 1:
        fm = fm.contiguous()
    if (min_constraint is None) != (max_constraint is None):
        raise ValueError("min_constraint and max_constraint go together")
    bounds = []
    for t in (min_constraint, max_constraint):
        if t is None:
            bounds += [None, 0]
            continue
        t = t.to(torch.float32)
        if t.shape != (k,) or t.device != dev:
            raise ValueError("leaf bounds must be (K,) on the hist's device")
        bounds += [t, t.stride(0)]
    mono = None if monotone is None else monotone.to(torch.int8).contiguous()
    pen = None if penalty is None else penalty.to(torch.float32).contiguous()
    if any(t is not None and (t.shape != (f,) or t.device != dev)
           for t in (mono, pen)):
        raise ValueError("monotone and penalty must be (F,) on the hist's "
                         "device")
    con = any(t is not None for t in (min_constraint, mono, pen))
    hist = hist.contiguous()
    planes = torch.empty((N_PLANES, k, f), dtype=torch.float32, device=dev)
    dleft = torch.empty((k, f), dtype=torch.bool, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    native.launch("split_scan", _lib().lgbt_split_scan, hist, sums[0],
                  sums[0].stride(0), sums[1], sums[1].stride(0), sums[2],
                  sums[2].stride(0), *meta, fm,
                  fm.stride(0) if fm.dim() == 2 else 0, k, f, b,
                  float(lambda_l1), float(lambda_l2), float(max_delta_step),
                  int(max_delta_step > 0.0), float(min_data_in_leaf),
                  float(min_sum_hessian_in_leaf), float(min_gain_to_split),
                  *bounds, mono, pen, planes, dleft, stream)
    native.count(find_best_splits_batched)
    native.count(find_best_splits_batched, "con_launches", int(con))
    if find_best_splits_batched.shapes is not None \
            and not torch.cuda.is_current_stream_capturing():
        find_best_splits_batched.shapes.append(k)
    return candidates_from_kernel(planes, dleft)


find_best_splits_batched.launches = 0
find_best_splits_batched.con_launches = 0
#: a list to record each launch's leaf count K in, or None;
#: a launch captured into a CUDA graph records nothing
find_best_splits_batched.shapes = None
