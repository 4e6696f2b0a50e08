"""Vectorized best numerical split search over (feature, bin) histograms.

Port of ``lightgbm_tpu/ops/split.py:find_best_splits`` (the reference's
``FeatureHistogram::FindBestThreshold*``, `feature_histogram.hpp:75-232`):
both missing-direction scans become suffix/prefix sums over the bin axis for
every feature at once, with validity masks standing in for the reference's
``continue``/``break`` conditions.  Semantics, gain math and tie-breaks are
the JAX package's, line for line:

  * missing None — one missing-left scan, thresholds 0..nb-2;
  * missing Zero (nb>2) — both scans skip the zero bin; threshold d-1 is never
    evaluated missing-left, d never missing-right;
  * missing NaN (nb>2) — last bin is the NaN bin (left scan 0..nb-3, right
    scan 0..nb-2);
  * the missing-right scan wins only on strictly greater gain; within the
    missing-left scan ties keep the largest threshold, within missing-right
    the smallest; across features the lowest index wins.

The sums use ``torch.cumsum``, the sequential order of the JAX package's CPU
path.  The TPU's triangular-matmul scan is an MXU mechanism and is not
carried over.  Every function takes an optional leading batch axis: ``hist``
is (..., F, B, 3) and the leaf totals have shape (...,).  Monotone
constraints enter as per-leaf value bounds (...,) that clip both outputs
and a per-feature sign whose violation zeroes a threshold's gain
(``_split_gains``), ``feature_contri`` as a per-feature factor on the
post-shift gain (``apply_penalty``); ``forced_split_info`` is the
reference's ``GatherInfoForThreshold`` for a forced split.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..binning import MISSING_NAN, MISSING_NONE, MISSING_ZERO

K_EPSILON = 1e-15   # `meta.h:38`
K_MIN_SCORE = float("-inf")


class SplitCandidates(NamedTuple):
    """Per-feature best split (the vector analogue of ``SplitInfo``); every
    field has shape (..., F)."""
    gain: torch.Tensor          # raw_gain - min_gain_shift; -inf if invalid
    threshold: torch.Tensor     # int32 bin threshold (left: bin <= thr)
    default_left: torch.Tensor  # bool
    left_sum_g: torch.Tensor
    left_sum_h: torch.Tensor
    left_cnt: torch.Tensor
    right_sum_g: torch.Tensor
    right_sum_h: torch.Tensor
    right_cnt: torch.Tensor
    left_output: torch.Tensor
    right_output: torch.Tensor


def threshold_l1(s, l1):
    reg = torch.clamp(torch.abs(s) - l1, min=0.0)
    return torch.sign(s) * reg


def calculate_leaf_output(sum_g, sum_h, l1, l2, max_delta_step):
    """``CalculateSplittedLeafOutput`` (`feature_histogram.hpp:443-450`)."""
    ret = -threshold_l1(sum_g, l1) / (sum_h + l2)
    if max_delta_step <= 0.0:
        return ret
    return torch.clamp(ret, -max_delta_step, max_delta_step)


def leaf_split_gain_given_output(sum_g, sum_h, l1, l2, output):
    sg_l1 = threshold_l1(sum_g, l1)
    return -(2.0 * sg_l1 * output + (sum_h + l2) * output * output)


def leaf_split_gain(sum_g, sum_h, l1, l2, max_delta_step):
    """``GetLeafSplitGain`` (`feature_histogram.hpp:490-494`)."""
    out = calculate_leaf_output(sum_g, sum_h, l1, l2, max_delta_step)
    return leaf_split_gain_given_output(sum_g, sum_h, l1, l2, out)


def _split_gains(lg, lh, rg, rh, l1, l2, mds, min_c=None, max_c=None,
                 monotone=None):
    """``GetSplitGains`` (`feature_histogram.hpp:453-466`): outputs clipped
    to the leaf's [min_c, max_c] value constraint; a monotone violation
    (increasing but left > right, or decreasing but left < right) zeroes
    the gain."""
    lo = calculate_leaf_output(lg, lh, l1, l2, mds)
    ro = calculate_leaf_output(rg, rh, l1, l2, mds)
    if min_c is not None:
        lo = torch.clamp(lo, min_c, max_c)
        ro = torch.clamp(ro, min_c, max_c)
    gain = (leaf_split_gain_given_output(lg, lh, l1, l2, lo)
            + leaf_split_gain_given_output(rg, rh, l1, l2, ro))
    if monotone is not None:
        violated = ((monotone > 0) & (lo > ro)) | ((monotone < 0) & (lo < ro))
        gain = torch.where(violated, 0.0, gain)
    return gain, lo, ro


def apply_penalty(gain: torch.Tensor, penalty) -> torch.Tensor:
    """The ``feature_contri`` gain penalty (`feature_histogram.hpp:81`, as
    the JAX learner applies it after the scan, `learner.py:274-277`): every
    gain but -inf times its feature's factor; ``penalty`` (F,) or None."""
    if penalty is None:
        return gain
    return torch.where(torch.isneginf(gain), gain,
                       gain * penalty.to(gain.dtype))


def leaf_bounds(bound, dt):
    """A per-leaf value bound, () or (...,), broadcast against (..., F, B)
    planes; None stays None."""
    if bound is None:
        return None
    return torch.as_tensor(bound).to(dt)[..., None, None]


def pairwise_bin_sum(x: torch.Tensor) -> torch.Tensor:
    """(..., B, C) -> (..., C): the sum over bins as a pairwise tree over B
    padded with zeros to a power of two, ``x[i] + x[i + half]`` at every
    level.  Its order is fixed on every device, so the card's fused
    child-scan kernel (``csrc/fused_scan.cu``) reproduces it bit for bit."""
    b = x.shape[-2]
    p = 1 << max(b - 1, 0).bit_length()
    if p > b:
        pad = x.new_zeros(x.shape[:-2] + (p - b, x.shape[-1]))
        x = torch.cat([x, pad], -2)
    while p > 1:
        p //= 2
        x = x[..., :p, :] + x[..., p:2 * p, :]
    return x[..., 0, :]


def fix_histogram(hist: torch.Tensor, sum_g: torch.Tensor,
                  sum_h: torch.Tensor, cnt: torch.Tensor,
                  default_bin: torch.Tensor) -> torch.Tensor:
    """``Dataset::FixHistogram`` (`src/io/dataset.cpp:923-941`): every
    feature with ``default_bin > 0`` gets its default-bin entry rebuilt as
    leaf totals minus the other bins (summed by ``pairwise_bin_sum``).
    hist (K, F, B, 3), totals (K,), default_bin (F,)."""
    dt = hist.dtype
    b = hist.shape[-2]
    db = default_bin
    dbm = (torch.arange(b, device=hist.device)[None, :] == db[:, None]) \
        & (db[:, None] > 0)                                       # (F, B)
    totals = torch.stack([sum_g, sum_h, cnt], -1).to(dt)          # (K, 3)
    others = pairwise_bin_sum(torch.where(dbm[..., None], 0.0, hist))
    fixed = totals[..., None, :] - others                         # (K, F, 3)
    return torch.where(dbm[..., None], fixed[..., None, :], hist)


def _take(a, t):
    return torch.gather(a, -1, t.unsqueeze(-1)).squeeze(-1)


def find_best_splits(hist: torch.Tensor, sum_gradients: torch.Tensor,
                     sum_hessians: torch.Tensor, num_data: torch.Tensor,
                     num_bin: torch.Tensor, missing_type: torch.Tensor,
                     default_bin: torch.Tensor, feature_mask: torch.Tensor,
                     monotone=None, min_constraint=None, max_constraint=None,
                     *, lambda_l1: float = 0.0, lambda_l2: float = 0.0,
                     max_delta_step: float = 0.0, min_data_in_leaf: int = 20,
                     min_sum_hessian_in_leaf: float = 1e-3,
                     min_gain_to_split: float = 0.0,
                     skip_missing_scan: bool = False,
                     penalty=None) -> SplitCandidates:
    """Best numerical split per feature for one leaf (or a batch of leaves).

    hist          : (..., F, B, 3) — (sum_grad, sum_hess, cnt) per bin
    sum_gradients : (...,) leaf sum of g (bagged)
    sum_hessians  : (...,) leaf sum of h (no epsilon pre-added)
    num_data      : (...,) leaf count (bagged)
    num_bin/missing_type/default_bin : (F,) int32 per-feature metadata
    feature_mask  : (F,) or (..., F) bool — usable features this tree
    monotone      : (F,) int8 monotone sign (+1, -1, 0) or None
    min_constraint / max_constraint : (...,) the leaves' value bounds, or
                    None (no clip); both or neither
    penalty       : (F,) ``feature_contri`` factor on the gain, or None
    """
    f, b = hist.shape[-3], hist.shape[-2]
    dt = hist.dtype
    dev = hist.device
    l1, l2, mds = lambda_l1, lambda_l2, max_delta_step
    mn = leaf_bounds(min_constraint, dt)
    mx = leaf_bounds(max_constraint, dt)
    mono_b = None if monotone is None else monotone[:, None]          # (F,1)
    bins_i = torch.arange(b, dtype=torch.int32, device=dev)[None, :]  # (1,B)
    nb = num_bin[:, None]                                             # (F,1)
    d_bin = default_bin[:, None]
    mtype = missing_type[:, None]
    total_g = sum_gradients.to(dt)[..., None, None]
    total_h = sum_hessians.to(dt)[..., None, None] + 2.0 * K_EPSILON
    total_n = num_data.to(dt)[..., None, None]

    two_scan = (num_bin > 2) & (missing_type != MISSING_NONE)        # (F,)
    is_zero = mtype == MISSING_ZERO
    is_nan = mtype == MISSING_NAN
    two = two_scan[:, None]

    gain_shift = leaf_split_gain(total_g, total_h, l1, l2, mds)
    min_gain_shift = gain_shift + min_gain_to_split                   # (...,1,1)

    hg, hh, hc = hist[..., 0], hist[..., 1], hist[..., 2]            # (...,F,B)

    # ---- missing-left scan (reference dir == -1)
    excl_m1 = (two & is_zero & (bins_i == d_bin)) | \
              (two & is_nan & (bins_i >= nb - 1)) | (bins_i >= nb)
    keep = (~excl_m1).to(dt)

    def suffix_after(x):
        """sum over bins > t, at every threshold t."""
        c = torch.flip(torch.cumsum(torch.flip(x, [-1]), -1), [-1])
        return torch.cat([c[..., 1:], torch.zeros_like(c[..., :1])], -1)

    rg_m1 = suffix_after(hg * keep)
    rh_m1 = suffix_after(hh * keep) + K_EPSILON
    rc_m1 = suffix_after(hc * keep)
    lg_m1 = total_g - rg_m1
    lh_m1 = total_h - rh_m1
    lc_m1 = total_n - rc_m1

    thr_hi_m1 = torch.where(two_scan & is_nan[:, 0], num_bin - 3,
                            num_bin - 2)[:, None]
    valid_m1 = (bins_i <= thr_hi_m1) & (bins_i >= 0)
    valid_m1 = valid_m1 & ~(two & is_zero & (bins_i == d_bin - 1))
    valid_m1 = valid_m1 & (rc_m1 >= min_data_in_leaf) \
        & (lc_m1 >= min_data_in_leaf)
    valid_m1 = valid_m1 & (rh_m1 >= min_sum_hessian_in_leaf) \
        & (lh_m1 >= min_sum_hessian_in_leaf)
    g_m1, lo_m1, ro_m1 = _split_gains(lg_m1, lh_m1, rg_m1, rh_m1, l1, l2, mds,
                                      mn, mx, mono_b)
    g_m1 = torch.where(valid_m1 & (g_m1 > min_gain_shift), g_m1, K_MIN_SCORE)

    # tie-break: largest threshold wins (right-to-left scan with strict >)
    best_t_m1 = (b - 1) - torch.argmax(torch.flip(g_m1, [-1]), dim=-1)
    best_g_m1 = torch.amax(g_m1, dim=-1)
    mgs = min_gain_shift[..., 0]                                      # (...,1)
    tg, tn = total_g[..., 0], total_n[..., 0]
    th = total_h[..., 0]

    if skip_missing_scan:
        best_t = best_t_m1
        lg_b, lh_b = _take(lg_m1, best_t), _take(lh_m1, best_t)
        lc_b = _take(lc_m1, best_t)
        invalid = torch.isneginf(best_g_m1) | ~feature_mask
        return SplitCandidates(
            gain=apply_penalty(torch.where(invalid, K_MIN_SCORE,
                                           best_g_m1 - mgs), penalty),
            threshold=best_t.to(torch.int32),
            default_left=torch.ones_like(invalid),
            left_sum_g=lg_b, left_sum_h=lh_b - K_EPSILON, left_cnt=lc_b,
            right_sum_g=tg - lg_b, right_sum_h=th - lh_b - K_EPSILON,
            right_cnt=tn - lc_b,
            left_output=_take(lo_m1, best_t),
            right_output=_take(ro_m1, best_t))

    # ---- missing-right scan (reference dir == +1), two-scan features only
    excl_p1 = (is_zero & (bins_i == d_bin)) | \
              (is_nan & (bins_i >= nb - 1)) | (bins_i >= nb)
    keep_p = (~excl_p1).to(dt)
    lg_p1 = torch.cumsum(hg * keep_p, -1)                  # left(t): bins<=t
    lh_p1 = torch.cumsum(hh * keep_p, -1) + K_EPSILON
    lc_p1 = torch.cumsum(hc * keep_p, -1)
    rg_p1 = total_g - lg_p1
    rh_p1 = total_h - lh_p1
    rc_p1 = total_n - lc_p1

    valid_p1 = two & (bins_i <= nb - 2)
    valid_p1 = valid_p1 & ~(is_zero & (bins_i == d_bin))
    valid_p1 = valid_p1 & (lc_p1 >= min_data_in_leaf) \
        & (rc_p1 >= min_data_in_leaf)
    valid_p1 = valid_p1 & (lh_p1 >= min_sum_hessian_in_leaf) \
        & (rh_p1 >= min_sum_hessian_in_leaf)
    g_p1, lo_p1, ro_p1 = _split_gains(lg_p1, lh_p1, rg_p1, rh_p1, l1, l2, mds,
                                      mn, mx, mono_b)
    g_p1 = torch.where(valid_p1 & (g_p1 > min_gain_shift), g_p1, K_MIN_SCORE)
    best_t_p1 = torch.argmax(g_p1, dim=-1)                  # smallest thr
    best_g_p1 = torch.amax(g_p1, dim=-1)

    # ---- combine (missing-right overrides on strictly greater gain)
    use_p1 = best_g_p1 > best_g_m1
    best_t = torch.where(use_p1, best_t_p1, best_t_m1)
    best_g = torch.where(use_p1, best_g_p1, best_g_m1)
    # NaN with 2 bins: the reference forces default right
    # (`feature_histogram.hpp:100-103`)
    default_left = torch.where(
        use_p1, False, ~((~two_scan) & (missing_type == MISSING_NAN)))

    def pick(a_p1, a_m1):
        return torch.where(use_p1, _take(a_p1, best_t), _take(a_m1, best_t))

    lg_b = pick(lg_p1, lg_m1)
    lh_b = pick(lh_p1, lh_m1)
    lc_b = pick(lc_p1, lc_m1)
    invalid = torch.isneginf(best_g) | ~feature_mask
    return SplitCandidates(
        gain=apply_penalty(torch.where(invalid, K_MIN_SCORE, best_g - mgs),
                           penalty),
        threshold=best_t.to(torch.int32),
        default_left=default_left,
        left_sum_g=lg_b, left_sum_h=lh_b - K_EPSILON, left_cnt=lc_b,
        right_sum_g=tg - lg_b, right_sum_h=th - lh_b - K_EPSILON,
        right_cnt=tn - lc_b,
        left_output=pick(lo_p1, lo_m1), right_output=pick(ro_p1, ro_m1))


def forced_split_info(hrow: torch.Tensor, sum_g: torch.Tensor,
                      sum_h: torch.Tensor, cnt: torch.Tensor, *,
                      threshold: int, num_bin: int, missing_type: int,
                      default_bin: int, is_cat: bool, lambda_l1: float,
                      lambda_l2: float, max_delta_step: float,
                      min_gain_to_split: float):
    """Split info at a FORCED (feature, threshold) —
    ``FeatureHistogram::GatherInfoForThreshold``
    (`src/treelearner/feature_histogram.hpp:273-413`), as
    ``lightgbm_tpu/ops/split.py:forced_split_info``.

    hrow: (B, 3) histogram row of the forced feature; the threshold and the
    feature's metadata are static (the forced-split tree is fixed at config
    time).  min_data / min_hessian are bypassed like the reference; only the
    gain-vs-no-split check applies (gain <= shift refuses the forced split,
    and the rest of the forced queue aborts,
    `serial_tree_learner.cpp:612-616`).

    Returns (gain, left_g, left_h_eps, left_cnt, right_g, right_h_eps,
    right_cnt, left_out, right_out, valid), 0-d tensors; the *_h_eps carry
    ``find_best_splits``'s K_EPSILON convention (the caller subtracts it).
    """
    dt = hrow.dtype
    l1, l2, mds = lambda_l1, lambda_l2, max_delta_step
    total_g = sum_g.to(dt)
    total_h = sum_h.to(dt) + 2.0 * K_EPSILON
    total_n = cnt.to(dt)
    min_gain_shift = leaf_split_gain(total_g, total_h, l1, l2, mds) \
        + min_gain_to_split
    b = hrow.shape[0]
    if is_cat:
        # one-hot categorical forced split (`feature_histogram.hpp:359-413`)
        lg = hrow[threshold, 0]
        lh = hrow[threshold, 1] + K_EPSILON
        lc = hrow[threshold, 2]
        rg = total_g - lg
        rh = total_h - lh
        rc = total_n - lc
        # the reference computes the left term of the gain check with the
        # RIGHT hessian (`feature_histogram.hpp:389-394`), mirrored so that
        # forced-categorical acceptance matches
        cur = leaf_split_gain(rg, rh, l1, l2, mds) \
            + leaf_split_gain(lg, rh, l1, l2, mds)
        ok = threshold < num_bin
    else:
        # right = bins >= threshold, never bin 0, skipping the default bin
        # for MissingType::Zero and the NaN bin for MissingType::NaN
        # (`feature_histogram.hpp:284-322`)
        idx = torch.arange(b, device=hrow.device)
        m = (idx >= max(int(threshold), 1)) & (idx < num_bin)
        if missing_type == MISSING_ZERO:
            m = m & (idx != default_bin)
        elif missing_type == MISSING_NAN:
            m = m & (idx <= num_bin - 2)
        mv = m.to(dt)
        rg = torch.sum(hrow[:, 0] * mv)
        rh = torch.sum(hrow[:, 1] * mv) + K_EPSILON
        rc = torch.sum(hrow[:, 2] * mv)
        lg = total_g - rg
        lh = total_h - rh
        lc = total_n - rc
        cur = leaf_split_gain(lg, lh, l1, l2, mds) \
            + leaf_split_gain(rg, rh, l1, l2, mds)
        ok = True
    valid = ~torch.isnan(cur) & (cur > min_gain_shift) & bool(ok)
    lo = calculate_leaf_output(lg, lh, l1, l2, mds)
    ro = calculate_leaf_output(rg, rh, l1, l2, mds)
    return cur - min_gain_shift, lg, lh, lc, rg, rh, rc, lo, ro, valid
