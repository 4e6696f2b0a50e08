"""Best categorical split per (leaf, feature) (CUDA kernel + plain torch).

Port of ``lightgbm_tpu/ops/split_cat.py:find_best_splits_categorical`` (the
reference's ``FeatureHistogram::FindBestThresholdCategorical``,
`feature_histogram.hpp:110-232`), batched over K leaves:

  * one-vs-other when the feature has at most ``max_cat_to_onehot`` bins:
    every bin evaluated as the lone left category, the smallest bin winning
    ties;
  * sorted-CTR many-vs-many otherwise: the bins with ``cnt >= cat_smooth``
    ordered by ``g / (h + cat_smooth)`` (a stable sort, the bin index
    breaking ties; 0.0 and -0.0 compare equal, NaN sorts last) and scanned
    from both ends, up to ``min(max_cat_threshold, (used + 1) // 2)``
    categories, with the ``min_data_per_group`` group bookkeeping; the
    backward direction wins only on strictly greater gain;
  * ``lambda_l2`` for one-hot, ``lambda_l2 + cat_l2`` for many-vs-many.

The JAX package runs the scan as a ``lax.scan`` vmapped over (feature,
direction).  The plain version here runs it as a Python loop over the
positions the scan can reach, vectorized across (K, F, direction), in the
``lax.scan``'s accumulation order.  The winning split is a bin-space bitset
of the LEFT child, ``(K, F, W)`` int32 words (W = ceil(B / 32)); bit
``b & 31`` of word ``b >> 5`` is bin ``b`` (the word's bits are the JAX
package's uint32 bits).

``categorical_candidates`` is what the learners call: it writes the
categorical columns of a batch's (K, F) candidate fields in place, after the
numerical scan has filled the others (threshold 0 and default_left False on
those columns, as the JAX ``_feature_cands`` merges them).  On a CUDA tensor
it is one launch of the hand-written Hopper kernel ``csrc/split_cat.cu``
(bitwise equal to the plain version on the CPU) and no other device op, at
any width up to 65,536 bins (``split_cat_plan``); on a CPU tensor it runs
the plain version, ``categorical_candidates_plain``.  The kernel is float32
only: ``gpu_use_dp`` keeps the plain float64 search.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from .. import native
from ..binning import MISSING_NONE
from .split import (K_EPSILON, K_MIN_SCORE, SplitCandidates, _split_gains,
                    apply_penalty, calculate_leaf_output, leaf_split_gain)

#: most bins the kernel takes: every width of the masked learner's uint16
#: codes (bins fit the kernel's 16-bit sort-key field)
MAX_BINS = 1 << 16
#: keys the kernel sorts at once (``split_cat_plan``)
SORT_CAP = 8192
#: dynamic shared memory one block may take on the card: Hopper's 227 KB
#: less a kilobyte for the kernel's static shared memory
_SMEM_LIMIT = 232_448 - 1_024


class CatSplitCandidates(NamedTuple):
    """Per-(leaf, feature) best categorical split; fields (K, F), ``bits``
    (K, F, W) int32, the bin-space membership bitset of the LEFT child."""
    gain: torch.Tensor
    bits: torch.Tensor
    left_sum_g: torch.Tensor
    left_sum_h: torch.Tensor
    left_cnt: torch.Tensor
    right_sum_g: torch.Tensor
    right_sum_h: torch.Tensor
    right_cnt: torch.Tensor
    left_output: torch.Tensor
    right_output: torch.Tensor


def cat_words(num_bins: int) -> int:
    """W, the bitset words of a histogram of ``num_bins`` bins."""
    return (num_bins + 31) // 32


def bits_from_member(member: torch.Tensor) -> torch.Tensor:
    """(..., B) bool -> (..., W) int32 words, bin b at bit b & 31 of word
    b >> 5 (the uint32 word's bits, held as int32)."""
    b = member.shape[-1]
    w = cat_words(b)
    pad = member.new_zeros(member.shape[:-1] + (w * 32 - b,))
    m = torch.cat([member, pad], -1).reshape(member.shape[:-1] + (w, 32))
    weights = torch.ones(32, dtype=torch.int64, device=member.device) \
        << torch.arange(32, device=member.device)
    words = (m.to(torch.int64) * weights).sum(-1)
    return torch.where(words >= 1 << 31, words - (1 << 32), words) \
        .to(torch.int32)


def find_best_splits_categorical(
        hist: torch.Tensor, sum_gradients: torch.Tensor,
        sum_hessians: torch.Tensor, num_data: torch.Tensor,
        num_bin: torch.Tensor, missing_type: torch.Tensor,
        feature_mask: torch.Tensor, min_constraint=None,
        max_constraint=None, *, lambda_l1: float = 0.0,
        lambda_l2: float = 0.0, max_delta_step: float = 0.0,
        min_data_in_leaf: int = 20, min_sum_hessian_in_leaf: float = 1e-3,
        min_gain_to_split: float = 0.0, cat_l2: float = 10.0,
        cat_smooth: float = 10.0, max_cat_threshold: int = 32,
        max_cat_to_onehot: int = 4, min_data_per_group: int = 100
        ) -> CatSplitCandidates:
    """Best categorical split per (leaf, feature), the plain version.

    hist (K, F, B, 3) — (sum_grad, sum_hess, cnt) per bin; the leaf totals
    (K,), sum_hessians without epsilons; num_bin / missing_type (F,);
    feature_mask (F,) or (K, F) bool, False drops a feature (its gain -inf,
    its bits 0); min_constraint / max_constraint (K,) the leaves' value
    bounds or None: the outputs, and the outputs the gains are formed from,
    are clipped to them (`FindBestThresholdCategorical` carries no monotone
    direction)."""
    k, f, b, _ = hist.shape
    dt, dev = hist.dtype, hist.device
    l1, l2, mds = lambda_l1, lambda_l2, max_delta_step
    mn = mx = None
    if min_constraint is not None:
        mn = min_constraint.to(dt)[:, None, None]                 # (K,1,1)
        mx = max_constraint.to(dt)[:, None, None]
    total_g = sum_gradients.to(dt)[:, None, None]                 # (K,1,1)
    total_h = sum_hessians.to(dt)[:, None, None] + 2.0 * K_EPSILON
    total_n = num_data.to(dt)[:, None, None]
    hg, hh, hc = hist.unbind(-1)                                  # (K,F,B)
    bins_i = torch.arange(b, device=dev)
    used_bin = num_bin.to(torch.int64) - 1 \
        + (missing_type == MISSING_NONE).to(torch.int64)          # (F,)
    in_range = bins_i[None, :] < used_bin[:, None]                # (F,B)
    min_gain_shift = leaf_split_gain(total_g, total_h, l1, l2, mds) \
        + min_gain_to_split                                       # (K,1,1)

    # ---- one-vs-other (`feature_histogram.hpp:130-161`)
    other_g = total_g - hg
    other_h = total_h - hh - K_EPSILON
    other_n = total_n - hc
    oh_valid = in_range & (hc >= min_data_in_leaf) \
        & (hh >= min_sum_hessian_in_leaf) & (other_n >= min_data_in_leaf) \
        & (other_h >= min_sum_hessian_in_leaf)
    g_oh = _split_gains(other_g, other_h, hg, hh + K_EPSILON, l1, l2, mds,
                        mn, mx)[0]
    g_oh = torch.where(oh_valid & (g_oh > min_gain_shift), g_oh, K_MIN_SCORE)
    oh_t = torch.argmax(g_oh, dim=-1, keepdim=True)               # smallest
    oh_gain = torch.gather(g_oh, -1, oh_t)[..., 0]

    def at(x, t):
        return torch.gather(x, -1, t)[..., 0]

    oh_lg, oh_lh, oh_lc = at(hg, oh_t), at(hh, oh_t) + K_EPSILON, \
        at(hc, oh_t)

    # ---- sorted-CTR many-vs-many (`feature_histogram.hpp:162-232`)
    l2m = lambda_l2 + cat_l2
    eligible = in_range & (hc >= cat_smooth)
    used_m = eligible.sum(-1)                                     # (K,F)
    ctr = hg / (hh + cat_smooth)
    # + 0.0 turns -0.0 into 0.0, so the two tie in the stable sort
    order = torch.argsort(torch.where(eligible, ctr + 0.0, float("inf")),
                          dim=-1, stable=True)
    max_num_cat = torch.clamp((used_m + 1) // 2, max=max_cat_threshold)
    # position i of the forward scan holds sorted rank i, of the backward
    # scan rank used - 1 - i: (K, F, 2, B) gathers of the sorted bins
    pos = bins_i.expand(k, f, b)
    rank_at = torch.stack([pos, torch.clamp(used_m[..., None] - 1 - pos,
                                            min=0)], 2)
    src = torch.gather(order[:, :, None, :].expand(k, f, 2, b), -1, rank_at)
    sg, sh, sc = (torch.gather(x[:, :, None, :].expand(k, f, 2, b), -1, src)
                  for x in (hg, hh, hc))
    used3, maxc3 = used_m[..., None], max_num_cat[..., None]      # (K,F,1)
    tg, th, tn = total_g, total_h, total_n                        # (K,1,1)
    mgs = min_gain_shift
    zero = hist.new_zeros((k, f, 2))
    slg, slh, lcnt, grp = zero, zero + K_EPSILON, zero, zero
    best_gain = zero + K_MIN_SCORE
    best_i = torch.full((k, f, 2), -1, dtype=torch.int64, device=dev)
    blg, blh, blc = zero, zero, zero
    stopped = torch.zeros((k, f, 2), dtype=torch.bool, device=dev)
    # only the first min(max_cat_threshold, (used + 1) // 2) positions can
    # be active, and used <= B
    for i in range(min(max_cat_threshold, (b + 1) // 2)):
        slg = slg + sg[..., i]
        slh = slh + sh[..., i]
        lcnt = lcnt + sc[..., i]
        grp = grp + sc[..., i]
        active = (i < used3) & (i < maxc3) & ~stopped
        rcnt = tn - lcnt
        srh = th - slh
        brk = (rcnt < min_data_in_leaf) | (rcnt < min_data_per_group) \
            | (srh < min_sum_hessian_in_leaf)
        stopped = stopped | (active & brk)
        can_eval = active & ~brk & (lcnt >= min_data_in_leaf) \
            & (slh >= min_sum_hessian_in_leaf) & (grp >= min_data_per_group)
        gain = _split_gains(slg, slh, tg - slg, srh, l1, l2m, mds, mn,
                            mx)[0]
        ok = can_eval & (gain > mgs)
        grp = torch.where(can_eval, 0.0, grp)
        better = ok & (gain > best_gain)
        best_gain = torch.where(better, gain, best_gain)
        best_i = torch.where(better, i, best_i)
        blg = torch.where(better, slg, blg)
        blh = torch.where(better, slh, blh)
        blc = torch.where(better, lcnt, blc)
    # direction merge: backward only on strictly greater gain
    use_bwd = best_gain[..., 1] > best_gain[..., 0]               # (K,F)
    d = use_bwd.to(torch.int64)[..., None]

    def pick_dir(x):
        return torch.gather(x, -1, d)[..., 0]

    mv_gain, mv_i = pick_dir(best_gain), pick_dir(best_i)
    mv_lg, mv_lh, mv_lc = pick_dir(blg), pick_dir(blh), pick_dir(blc)
    rank = torch.empty_like(order).scatter_(-1, order, pos)
    mv_member = torch.where(
        use_bwd[..., None], rank >= (used_m - 1 - mv_i)[..., None],
        rank <= mv_i[..., None]) & eligible

    # ---- the scan per feature (`num_bin <= max_cat_to_onehot`)
    use_onehot = (num_bin <= max_cat_to_onehot)[None, :]          # (1,F)
    gain = torch.where(use_onehot, oh_gain, mv_gain)
    lg = torch.where(use_onehot, oh_lg, mv_lg)
    lh = torch.where(use_onehot, oh_lh, mv_lh)
    lc = torch.where(use_onehot, oh_lc, mv_lc)
    member = torch.where(use_onehot[..., None], pos == oh_t, mv_member)
    tg, th, tn = tg[..., 0], th[..., 0], tn[..., 0]               # (K,1)
    rg, rh, rc = tg - lg, th - lh, tn - lc
    lo = torch.where(use_onehot, calculate_leaf_output(lg, lh, l1, l2, mds),
                     calculate_leaf_output(lg, lh, l1, l2m, mds))
    ro = torch.where(use_onehot, calculate_leaf_output(rg, rh, l1, l2, mds),
                     calculate_leaf_output(rg, rh, l1, l2m, mds))
    if mn is not None:
        lo = torch.clamp(lo, mn[..., 0], mx[..., 0])
        ro = torch.clamp(ro, mn[..., 0], mx[..., 0])
    invalid = torch.isneginf(gain) | ~feature_mask
    return CatSplitCandidates(
        gain=torch.where(invalid, K_MIN_SCORE, gain - mgs[..., 0]),
        bits=bits_from_member(member & ~invalid[..., None]),
        left_sum_g=lg, left_sum_h=lh - K_EPSILON, left_cnt=lc,
        right_sum_g=rg, right_sum_h=rh - K_EPSILON, right_cnt=rc,
        left_output=lo, right_output=ro)


def categorical_candidates_plain(cands: SplitCandidates, bits: torch.Tensor,
                                 hist, sum_gradients, sum_hessians, num_data,
                                 num_bin, missing_type, feature_mask,
                                 cat_cols: torch.Tensor, min_constraint=None,
                                 max_constraint=None, penalty=None,
                                 **kw) -> None:
    """The plain version of ``categorical_candidates``: the categorical
    columns ``cat_cols`` of every (K, F) field of ``cands`` and of ``bits``
    (K, F, W) are overwritten in place with ``find_best_splits_categorical``
    of those columns (threshold 0, default_left False), the gains times
    their ``penalty`` (F,) where one is given."""
    cols = cat_cols.to(torch.int64)
    fm = feature_mask.index_select(-1, cols)
    cat = find_best_splits_categorical(
        hist.index_select(1, cols), sum_gradients, sum_hessians, num_data,
        num_bin.index_select(0, cols), missing_type.index_select(0, cols),
        fm, min_constraint, max_constraint, **kw)
    gain = apply_penalty(cat.gain, None if penalty is None
                         else penalty.index_select(0, cols))
    for name, val in zip(("gain", "left_sum_g", "left_sum_h", "left_cnt",
                          "right_sum_g", "right_sum_h", "right_cnt",
                          "left_output", "right_output"),
                         (gain,) + cat[2:]):
        field = getattr(cands, name)
        field.index_copy_(1, cols, val.to(field.dtype))
    cands.threshold.index_fill_(1, cols, 0)
    cands.default_left.index_fill_(1, cols, False)
    bits.index_copy_(1, cols, cat.bits)


_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        lib = native.load("split_cat")
        p, ll, i, fl = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                        ctypes.c_float)
        lib.lgbt_split_cat.argtypes = [
            p, p, ll, p, ll, p, ll, p, p, p, ll, p, i, i, i, i,
            fl, fl, fl, fl, i, fl, fl, fl, fl, i, i, fl, p, ll, p, ll, p,
            p, p, p, p, p, p, p, p, p, p, p, p, i, i, i, ll, p]
        lib.lgbt_split_cat.restype = ctypes.c_int
        _LIB = lib
    return _LIB


class SplitCatPlan(NamedTuple):
    """The kernel's launch for a histogram of B bins: threads per block,
    the sort buffer's keys, the scan positions per direction and the
    dynamic shared memory."""
    threads: int
    cap: int
    tcap: int
    smem: int


def split_cat_plan(num_bins: int, max_cat_threshold: int) -> SplitCatPlan:
    """Half the next power of two of B threads (64 to 512); a sort buffer
    of that power of two, at most SORT_CAP keys (a wider column's sorted
    run is cut to its ``max_cat_threshold`` smallest and largest between
    rounds, which needs room for both and a round); ``max_cat_threshold``
    scan positions a direction, at most (B + 1) // 2.  Raises for what the
    kernel does not take."""
    b, mct = num_bins, max_cat_threshold
    if not 1 <= b <= MAX_BINS:
        raise ValueError(f"the kernel takes 1 to {MAX_BINS} bins, got {b}")
    if mct < 0:
        raise ValueError(f"max_cat_threshold must be >= 0, got {mct}")
    p2 = 1 << (b - 1).bit_length()
    threads = min(512, max(64, p2 // 2))
    cap = min(p2, SORT_CAP)
    tcap = max(1, min(mct, (b + 1) // 2))
    smem = 8 * cap + 58 * tcap + 4 * cat_words(b)
    if (cap < p2 and 2 * mct + threads > cap) or smem > _SMEM_LIMIT:
        raise ValueError(f"max_cat_threshold {mct} at {b} bins is past the "
                         f"kernel's shared memory")
    return SplitCatPlan(threads, cap, tcap, smem)


#: the SplitCandidates fields the kernel writes, with their dtypes
_FIELD_TYPES = (("gain", torch.float32), ("threshold", torch.int32),
                ("default_left", torch.bool),
                ("left_sum_g", torch.float32), ("left_sum_h", torch.float32),
                ("left_cnt", torch.float32), ("right_sum_g", torch.float32),
                ("right_sum_h", torch.float32), ("right_cnt", torch.float32),
                ("left_output", torch.float32),
                ("right_output", torch.float32))


def categorical_candidates(cands: SplitCandidates, bits: torch.Tensor,
                           hist: torch.Tensor, sum_gradients: torch.Tensor,
                           sum_hessians: torch.Tensor,
                           num_data: torch.Tensor, num_bin: torch.Tensor,
                           missing_type: torch.Tensor,
                           feature_mask: torch.Tensor,
                           cat_cols: torch.Tensor, min_constraint=None,
                           max_constraint=None, penalty=None, *,
                           lambda_l1: float = 0.0, lambda_l2: float = 0.0,
                           max_delta_step: float = 0.0,
                           min_data_in_leaf: int = 20,
                           min_sum_hessian_in_leaf: float = 1e-3,
                           min_gain_to_split: float = 0.0,
                           cat_l2: float = 10.0, cat_smooth: float = 10.0,
                           max_cat_threshold: int = 32,
                           max_cat_to_onehot: int = 4,
                           min_data_per_group: int = 100) -> None:
    """Write the best categorical split of columns ``cat_cols`` (C,) of a
    (K, F, B, 3) histogram batch into the (K, F) fields of ``cands`` and the
    (K, F, W) int32 ``bits``, in place; optionally with the leaves' value
    bounds (K,) (both or neither), which clip the outputs, and the gain
    penalty (F,).  CPU tensors take the plain version; CUDA tensors launch
    the kernel (counted in ``categorical_candidates.launches``, the launches
    with bounds or a penalty also in ``.con_launches``) or raise."""
    kw = dict(lambda_l1=lambda_l1, lambda_l2=lambda_l2,
              max_delta_step=max_delta_step,
              min_data_in_leaf=min_data_in_leaf,
              min_sum_hessian_in_leaf=min_sum_hessian_in_leaf,
              min_gain_to_split=min_gain_to_split, cat_l2=cat_l2,
              cat_smooth=cat_smooth, max_cat_threshold=max_cat_threshold,
              max_cat_to_onehot=max_cat_to_onehot,
              min_data_per_group=min_data_per_group)
    if hist.device.type == "cpu":
        categorical_candidates_plain(cands, bits, hist, sum_gradients,
                                     sum_hessians, num_data, num_bin,
                                     missing_type, feature_mask, cat_cols,
                                     min_constraint, max_constraint, penalty,
                                     **kw)
        return
    dev = hist.device
    if dev.type != "cuda":
        raise ValueError(f"hist must lie on the CPU or a CUDA device, not "
                         f"{dev}")
    if hist.dtype != torch.float32 or hist.dim() != 4 or hist.shape[-1] != 3 \
            or not hist.is_contiguous():
        raise ValueError(f"hist must be a contiguous (K, F, B, 3) float32 "
                         f"tensor, got {hist.dtype} {tuple(hist.shape)}")
    k, f, b, _ = hist.shape
    w = cat_words(b)
    if k < 1 or f < 1:
        raise ValueError(f"need K, F >= 1, got {k, f}")
    plan = split_cat_plan(b, int(max_cat_threshold))
    # the learner's tensors need no conversion: the call is then one launch
    meta = [t.to(torch.int32).contiguous() for t in (num_bin, missing_type)]
    cols = cat_cols.to(torch.int32).contiguous()
    if any(t.shape != (f,) or t.device != dev for t in meta) \
            or cols.dim() != 1 or cols.device != dev:
        raise ValueError("feature metadata must be (F,) and cat_cols (C,) on "
                         "the hist's device")
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
    fields = [getattr(cands, name) for name, _ in _FIELD_TYPES]
    for (name, dtype), t in zip(_FIELD_TYPES, fields):
        if t.dtype != dtype or t.shape != (k, f) or not t.is_contiguous() \
                or t.device != dev:
            raise ValueError(f"candidate field {name} must be a contiguous "
                             f"({k}, {f}) {dtype} tensor on the hist's device")
    if bits.dtype != torch.int32 or bits.shape != (k, f, w) \
            or not bits.is_contiguous() or bits.device != dev:
        raise ValueError(f"bits must be a contiguous ({k}, {f}, {w}) int32 "
                         f"tensor on the hist's device")
    if (min_constraint is None) != (max_constraint is None):
        raise ValueError("min_constraint and max_constraint go together")
    con = []
    for t in (min_constraint, max_constraint):
        if t is None:
            con += [None, 0]
            continue
        t = t.to(torch.float32)
        if t.shape != (k,) or t.device != dev:
            raise ValueError("leaf bounds must be (K,) on the hist's device")
        con += [t, t.stride(0)]
    pen = None if penalty is None else penalty.to(torch.float32).contiguous()
    if pen is not None and (pen.shape != (f,) or pen.device != dev):
        raise ValueError("penalty must be (F,) on the hist's device")
    if cols.numel() == 0:
        return
    stream = torch.cuda.current_stream(dev).cuda_stream
    native.launch("split_cat", _lib().lgbt_split_cat, hist, sums[0],
                  sums[0].stride(0), sums[1], sums[1].stride(0), sums[2],
                  sums[2].stride(0), *meta, fm,
                  fm.stride(0) if fm.dim() == 2 else 0, cols, cols.numel(),
                  k, f, b, float(lambda_l1), float(lambda_l2),
                  float(lambda_l2 + cat_l2), float(max_delta_step),
                  int(max_delta_step > 0.0), float(min_data_in_leaf),
                  float(min_sum_hessian_in_leaf), float(min_gain_to_split),
                  float(cat_smooth), int(max_cat_threshold),
                  int(max_cat_to_onehot), float(min_data_per_group),
                  *con, pen, *fields, bits, plan.threads, plan.cap,
                  plan.tcap, plan.smem, stream)
    native.count(categorical_candidates)
    native.count(categorical_candidates, "con_launches", int(
        min_constraint is not None or pen is not None))
    if categorical_candidates.shapes is not None \
            and not torch.cuda.is_current_stream_capturing():
        categorical_candidates.shapes.append(k)


categorical_candidates.launches = 0
categorical_candidates.con_launches = 0
#: a list to record each launch's leaf count K in, or None;
#: a launch captured into a CUDA graph records nothing
categorical_candidates.shapes = None
