// One leaf-feature split scan, a warp's work, shared by split_scan.cu and
// fused_scan.cu (the TPU package shares _scan_body between
// find_best_splits_batched and fused_child_scans the same way).  Build every
// includer with -fmad=false (native.py does): the gain arithmetic must round
// after every operation, as the plain torch version (ops/split.py) does.
//
// warp_scan() finds the best numerical threshold of one (leaf, feature)
// histogram with the semantics of ops/split.py:find_best_splits (the
// reference's FeatureHistogram::FindBestThreshold*):
//
//   * the missing-left scan (suffix sums over bins > t, thresholds up to
//     nb-2, or nb-3 for a NaN feature; the zero bin excluded and threshold
//     d-1 skipped for a Zero-missing feature), largest threshold on ties;
//   * the missing-right scan for two-scan features (prefix sums over bins
//     <= t), smallest threshold on ties, chosen only on strictly greater gain;
//   * min_data_in_leaf / min_sum_hessian_in_leaf feasibility, a gain above
//     the leaf's min_gain_shift, L1 / L2 / max_delta_step leaf outputs;
//   * default_left false when the missing-right scan wins, and false for a
//     NaN feature with two bins;
//   * with kCon (a constrained scan): both outputs clipped to the leaf's
//     [min_c, max_c] value bounds and the gain 0 where the clipped outputs
//     break the feature's monotone sign (_split_gains), and the post-shift
//     gain times the feature's feature_contri penalty (apply_penalty);
//
// and writes every SplitCandidates field with the epilogue of
// find_best_splits: the post-shift gain (-inf where the best is -inf or the
// feature is masked), the int32 threshold, default_left, the left and right
// sums with the K_EPSILON conventions and both outputs.  Without kCon the
// scan is the unconstrained one instruction for instruction: a constrained
// scan with bounds of -inf and +inf, sign 0 and penalty 1 computes the same
// bits, so one instantiation of each kind serves every call.  Every field is
// computed with the plain version's operations in its order (_rn
// intrinsics, no contraction), so it equals ops/split.py on the CPU bit for
// bit.
//
// Design.  A warp per (leaf, feature) and 6 KB of shared memory per warp
// (WarpSmem).  The caller loads the histogram with coalesced 16-byte loads
// (load_row) and hands every lane its bins lane, lane + 32, ... in
// registers.  All 32 lanes write the bins of both directions under their
// keep masks, and six lanes then turn them, in place, into the six
// cumulative sums (3 channels x 2 directions) in bin order with one running
// carry each, in double and rounded to float at every bin: that is what
// torch.cumsum does on the CPU for float32 (a tree-shaped scan would not
// be).  Every lane evaluates B / 32 thresholds of both directions, keeps its
// best of each by beats()'s tie rules (a strict order on (gain,
// threshold)), and a five-step shuffle butterfly (warp_best) gives every
// lane the warp's best; lane 0 forms the chosen candidate and the epilogue.
// No block-wide barrier.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace scan {

constexpr int kBins = 256;             // most bins a histogram holds
constexpr int kPerLane = kBins / 32;   // bins a lane holds
constexpr int kUnroll = 8;             // bins per step of the carry loop
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kMissingNone = 0;
constexpr int kMissingZero = 1;
constexpr int kMissingNan = 2;
constexpr float kEpsilon = 1e-15f;  // meta.h:38, as float32

struct Params {
  float l1, l2, mds;
  int use_mds;
  float min_data, min_hess;
};

__device__ __forceinline__ float threshold_l1(float s, float l1) {
  float reg = __fsub_rn(fabsf(s), l1);
  reg = reg < 0.0f ? 0.0f : reg;  // clamp(min=0), NaN kept
  const float sg = s > 0.0f ? 1.0f : (s < 0.0f ? -1.0f : 0.0f);
  return __fmul_rn(sg, reg);
}

__device__ __forceinline__ float leaf_output(float g, float h,
                                             const Params& p) {
  float ret = __fdiv_rn(-threshold_l1(g, p.l1), __fadd_rn(h, p.l2));
  if (p.use_mds && !isnan(ret)) {
    ret = ret < -p.mds ? -p.mds : ret;
    ret = ret > p.mds ? p.mds : ret;
  }
  return ret;
}

__device__ __forceinline__ float gain_given_output(float g, float h, float out,
                                                   const Params& p) {
  const float sg = threshold_l1(g, p.l1);
  const float a = __fmul_rn(__fmul_rn(2.0f, sg), out);
  const float b = __fmul_rn(__fmul_rn(__fadd_rn(h, p.l2), out), out);
  return -__fadd_rn(a, b);
}

// A leaf's value bounds, a feature's monotone sign (+1, -1, 0) and its
// feature_contri gain penalty: what a constrained scan reads.
struct Constraint {
  float mn = -INFINITY, mx = INFINITY;
  int mono = 0;
  float pen = 1.0f;
};

// torch.clamp(x, mn, mx) of the plain version: NaN kept, mx last.
__device__ __forceinline__ float clip(float x, float mn, float mx) {
  x = x < mn ? mn : x;
  return x > mx ? mx : x;
}

struct Cand {
  float gain, lg, lh, lc, lo, ro;
};

// One threshold of one direction: left sums (lg, lh, lc), right sums by
// subtraction from the totals, feasibility, gain (or -inf); kCon clips the
// outputs to the leaf's bounds and zeroes a gain against the monotone sign.
template <bool kCon>
__device__ __forceinline__ Cand evaluate(float lg, float lh, float lc,
                                         float rg, float rh, float rc,
                                         bool shape_ok, float mgs,
                                         const Params& p,
                                         const Constraint& cs) {
  Cand c;
  c.lg = lg;
  c.lh = lh;
  c.lc = lc;
  c.lo = leaf_output(lg, lh, p);
  c.ro = leaf_output(rg, rh, p);
  if (kCon) {
    c.lo = clip(c.lo, cs.mn, cs.mx);
    c.ro = clip(c.ro, cs.mn, cs.mx);
  }
  float gain = __fadd_rn(gain_given_output(lg, lh, c.lo, p),
                         gain_given_output(rg, rh, c.ro, p));
  if (kCon && ((cs.mono > 0 && c.lo > c.ro) || (cs.mono < 0 && c.lo < c.ro)))
    gain = 0.0f;
  const bool valid = shape_ok && rc >= p.min_data && lc >= p.min_data &&
                     rh >= p.min_hess && lh >= p.min_hess;
  c.gain = (valid && gain > mgs) ? gain : -INFINITY;
  return c;
}

struct Feature {
  int nb, d;
  bool two, is_zero, is_nan;
};

__device__ __forceinline__ Feature make_feature(int nb, int mt, int d) {
  Feature ft;
  ft.nb = nb;
  ft.d = d;
  ft.two = nb > 2 && mt != kMissingNone;
  ft.is_zero = mt == kMissingZero;
  ft.is_nan = mt == kMissingNan;
  return ft;
}

// Missing-left candidate at threshold t: right = suffix sums over bins > t.
template <bool kCon>
__device__ __forceinline__ Cand cand_m1(int t, const Feature& ft,
                                        const float (*cm)[kBins + 1],
                                        float tg, float th, float tn,
                                        float mgs, const Params& p,
                                        const Constraint& cs) {
  const float rg = cm[0][t + 1];
  const float rh = __fadd_rn(cm[1][t + 1], kEpsilon);
  const float rc = cm[2][t + 1];
  const int thr_hi = (ft.two && ft.is_nan) ? ft.nb - 3 : ft.nb - 2;
  const bool shape_ok = t <= thr_hi && t >= 0 &&
                        !(ft.two && ft.is_zero && t == ft.d - 1);
  return evaluate<kCon>(__fsub_rn(tg, rg), __fsub_rn(th, rh),
                        __fsub_rn(tn, rc), rg, rh, rc, shape_ok, mgs, p, cs);
}

// Missing-right candidate at threshold t: left = prefix sums over bins <= t.
template <bool kCon>
__device__ __forceinline__ Cand cand_p1(int t, const Feature& ft,
                                        const float (*cp)[kBins],
                                        float tg, float th, float tn,
                                        float mgs, const Params& p,
                                        const Constraint& cs) {
  const float lg = cp[0][t];
  const float lh = __fadd_rn(cp[1][t], kEpsilon);
  const float lc = cp[2][t];
  const bool shape_ok = ft.two && t <= ft.nb - 2 &&
                        !(ft.is_zero && t == ft.d);
  return evaluate<kCon>(lg, lh, lc, __fsub_rn(tg, lg), __fsub_rn(th, lh),
                        __fsub_rn(tn, lc), shape_ok, mgs, p, cs);
}

// (g1, t1) beats (g2, t2): larger gain; on equal gains the larger threshold
// when `prefer_high`, else the smaller; t < 0 marks an absent entry.
__device__ __forceinline__ bool beats(float g1, int t1, float g2, int t2,
                                      bool prefer_high) {
  if (t2 < 0) return true;
  if (t1 < 0) return false;
  if (g1 > g2) return true;
  if (g2 > g1) return false;
  return prefer_high ? t1 > t2 : t1 < t2;
}

// One warp's shared memory.
struct WarpSmem {
  union {
    float hs[kBins * 3];        // the histogram as stored, (bin, channel)
    float cm[3][kBins + 1];     // then the suffix sums over bins >= b
  };
  float cp[3][kBins];           // prefix sums over bins <= b
};

// The warp copies n floats from global src to shared dst: 16-byte loads
// where src is aligned, words elsewhere.  The caller synchronises the warp
// before reading dst.
__device__ __forceinline__ void load_row(float* dst, const float* src, int n,
                                         int lane) {
  const int head = static_cast<int>(
      ((16 - (reinterpret_cast<uintptr_t>(src) & 15)) & 15) >> 2);
  const int h0 = head < n ? head : n;
  if (lane < h0) dst[lane] = src[lane];
  const int n4 = (n - h0) >> 2;
  const float4* src4 = reinterpret_cast<const float4*>(src + h0);
  for (int i = lane; i < n4; i += 32) {
    const float4 v = src4[i];
    float* d = dst + h0 + 4 * i;
    d[0] = v.x;
    d[1] = v.y;
    d[2] = v.z;
    d[3] = v.w;
  }
  for (int i = h0 + 4 * n4 + lane; i < n; i += 32) dst[i] = src[i];
}

// Every lane's bins lane, lane + 32, ... of the (bin, channel) histogram in
// s.hs (B bins), zeros past B.  The caller synchronises the warp after
// filling s.hs.
__device__ __forceinline__ void lane_bins(const WarpSmem& s, int B, int lane,
                                          float (&v)[kPerLane][3]) {
#pragma unroll
  for (int j = 0; j < kPerLane; ++j) {
    const int b = lane + 32 * j;
#pragma unroll
    for (int c = 0; c < 3; ++c) v[j][c] = b < B ? s.hs[b * 3 + c] : 0.0f;
  }
}

// Keep the better of (g, t) and the other lanes' entries, the warp's best in
// every lane after five butterfly steps.
__device__ __forceinline__ void warp_best(float& g, int& t, bool prefer_high) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float og = __shfl_xor_sync(kFull, g, o);
    const int ot = __shfl_xor_sync(kFull, t, o);
    if (!beats(g, t, og, ot, prefer_high)) {
      g = og;
      t = ot;
    }
  }
}

// Where the SplitCandidates fields of `rows` leaves x F features go.
struct Fields {
  float* planes;     // (10, rows, F): gain, threshold (int32), lsg, lsh, lc,
                     // rsg, rsh, rc, lo, ro
  uint8_t* dleft;    // (rows, F) bool
  long long plane;   // rows * F
};

// Scan one (leaf, feature) and write its fields at entry `pair` (= leaf * F
// + feature) of `o`.  v holds every lane's bins (lane_bins), tg, sum_h (no
// epsilon) and tn are the leaf's sums, `masked` drops the feature for this
// leaf.  s.hs may hold the histogram v was read from: it is overwritten.
// kCon runs the constrained scan with `cs`.  Every lane of the warp must
// call it.
template <bool kCon = false>
__device__ __forceinline__ void warp_scan(WarpSmem& s,
                                          const float (&v)[kPerLane][3],
                                          const Feature& ft, int B, float tg,
                                          float sum_h, float tn, bool masked,
                                          float min_gain_to_split,
                                          const Params& p, const Fields& o,
                                          long long pair,
                                          const Constraint& cs = Constraint{}) {
  const int lane = threadIdx.x & 31;
  // the leaf totals, as find_best_splits forms them
  const float th = __fadd_rn(sum_h, 2.0f * kEpsilon);
  const float shift = gain_given_output(tg, th, leaf_output(tg, th, p), p);
  const float mgs = __fadd_rn(shift, min_gain_to_split);
  __syncwarp();  // every lane has read its bins (cm shares its words with hs)

  // The six cumulative sums.  First every lane writes the masked bins of
  // both directions, bins past B as zeros (the missing-left keep mask into
  // cm, the missing-right one into cp); then lanes 0-2 turn cm[c] into
  // suffix sums from bin 255 down and lanes 3-5 cp[c] into prefix sums from
  // bin 0 up, in place, one running carry each in double, rounded to float
  // at every bin.  The leading zeros of the suffix walk leave its carry at
  // +0.0, so every sum is the plain version's.  The loop is the same 256
  // steps for all six lanes, eight bins to an unrolled step.
#pragma unroll
  for (int j = 0; j < kPerLane; ++j) {
    const int b = lane + 32 * j;
    const bool excl_l = (ft.two && ft.is_zero && b == ft.d) ||
                        (ft.two && ft.is_nan && b >= ft.nb - 1) || b >= ft.nb;
    const bool excl_r = (ft.is_zero && b == ft.d) ||
                        (ft.is_nan && b >= ft.nb - 1) || b >= ft.nb;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      s.cm[c][b] = __fmul_rn(v[j][c], excl_l ? 0.0f : 1.0f);
      s.cp[c][b] = __fmul_rn(v[j][c], excl_r ? 0.0f : 1.0f);
    }
  }
  if (lane < 3) s.cm[lane][kBins] = 0.0f;
  __syncwarp();
  if (lane < 6) {
    const bool suffix = lane < 3;
    float* x = suffix ? &s.cm[lane][kBins - 1] : s.cp[lane - 3];
    const int step = suffix ? -1 : 1;
    double carry = 0.0;
    for (int i0 = 0; i0 < kBins; i0 += kUnroll) {
      float u[kUnroll];
#pragma unroll
      for (int q = 0; q < kUnroll; ++q) u[q] = x[(i0 + q) * step];
#pragma unroll
      for (int q = 0; q < kUnroll; ++q) {
        carry += (double)u[q];
        x[(i0 + q) * step] = __double2float_rn(carry);
      }
    }
  }
  __syncwarp();

  // each lane's thresholds t = lane, lane + 32, ...; t < 0 marks none
  float gm = -INFINITY, gp = -INFINITY;
  int tm = -1, tp = -1;
#pragma unroll
  for (int j = 0; j < kPerLane; ++j) {  // unrolled: independent chains
    const int t = lane + 32 * j;
    if (t < B) {
      const float g1 =
          cand_m1<kCon>(t, ft, s.cm, tg, th, tn, mgs, p, cs).gain;
      if (beats(g1, t, gm, tm, true)) {
        gm = g1;
        tm = t;
      }
      const float g2 =
          cand_p1<kCon>(t, ft, s.cp, tg, th, tn, mgs, p, cs).gain;
      if (beats(g2, t, gp, tp, false)) {
        gp = g2;
        tp = t;
      }
    }
  }
  warp_best(gm, tm, true);
  warp_best(gp, tp, false);
  if (lane != 0) return;

  const bool use_p1 = gp > gm;
  const int bt = use_p1 ? tp : tm;
  const Cand c = use_p1 ? cand_p1<kCon>(bt, ft, s.cp, tg, th, tn, mgs, p, cs)
                        : cand_m1<kCon>(bt, ft, s.cm, tg, th, tn, mgs, p, cs);
  const float best = use_p1 ? gp : gm;
  const bool dleft = use_p1 ? false : !(!ft.two && ft.is_nan);
  const bool invalid = (isinf(best) && best < 0.0f) || masked;
  float* out = o.planes + pair;
  const long long pl = o.plane;
  const float shifted = __fsub_rn(best, mgs);
  out[0] = invalid ? -INFINITY : (kCon ? __fmul_rn(shifted, cs.pen) : shifted);
  reinterpret_cast<int32_t*>(out + pl)[0] = bt;
  out[2 * pl] = c.lg;
  out[3 * pl] = __fsub_rn(c.lh, kEpsilon);
  out[4 * pl] = c.lc;
  out[5 * pl] = __fsub_rn(tg, c.lg);
  out[6 * pl] = __fsub_rn(__fsub_rn(th, c.lh), kEpsilon);
  out[7 * pl] = __fsub_rn(tn, c.lc);
  out[8 * pl] = c.lo;
  out[9 * pl] = c.ro;
  o.dleft[pair] = dleft ? 1 : 0;
}

}  // namespace scan
