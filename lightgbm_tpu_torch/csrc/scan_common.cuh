// One leaf-feature split scan, shared by split_scan.cu and fused_scan.cu
// (the TPU package shares _scan_body between find_best_splits_batched and
// fused_child_scans the same way).  Build every includer with -fmad=false
// (native.py does): the gain arithmetic must round after every operation, as
// the plain torch version (ops/split.py) does.
//
// scan_leaf() finds the best numerical threshold of one (leaf, feature)
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
//     NaN feature with two bins.
//
// It writes 8 planes, as the TPU kernel: the raw best gain, the threshold,
// default_left, and the left sums (g, h + K_EPSILON, count) and both outputs
// at that threshold.
//
// Design.  A block of 256 threads, one thread per bin.  Six threads form the
// six cumulative sums (3 channels x 2 directions) in bin order with one
// running carry each, accumulated in double and rounded to float at every
// bin: that is what torch.cumsum does on the CPU for float32, so the sums
// equal the plain version's on the CPU bit for bit (a tree-shaped block scan
// would not).  Every thread then evaluates its threshold in both directions
// with the operation order of ops/split.py (explicit _rn intrinsics, no
// contraction), and two shared-memory reductions pick each direction's best
// threshold with the tie rules above.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace scan {

constexpr int kThreads = 256;
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

struct Cand {
  float gain, lg, lh, lc, lo, ro;
};

// One threshold of one direction: left sums (lg, lh, lc), right sums by
// subtraction from the totals, feasibility, gain (or -inf).
__device__ __forceinline__ Cand evaluate(float lg, float lh, float lc,
                                         float rg, float rh, float rc,
                                         bool shape_ok, float mgs,
                                         const Params& p) {
  Cand c;
  c.lg = lg;
  c.lh = lh;
  c.lc = lc;
  c.lo = leaf_output(lg, lh, p);
  c.ro = leaf_output(rg, rh, p);
  const float gain = __fadd_rn(gain_given_output(lg, lh, c.lo, p),
                               gain_given_output(rg, rh, c.ro, p));
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
__device__ __forceinline__ Cand cand_m1(int t, const Feature& ft,
                                        const float (*cm)[kThreads + 1],
                                        float tg, float th, float tn,
                                        float mgs, const Params& p) {
  const float rg = cm[0][t + 1];
  const float rh = __fadd_rn(cm[1][t + 1], kEpsilon);
  const float rc = cm[2][t + 1];
  const int thr_hi = (ft.two && ft.is_nan) ? ft.nb - 3 : ft.nb - 2;
  const bool shape_ok = t <= thr_hi && t >= 0 &&
                        !(ft.two && ft.is_zero && t == ft.d - 1);
  return evaluate(__fsub_rn(tg, rg), __fsub_rn(th, rh), __fsub_rn(tn, rc),
                  rg, rh, rc, shape_ok, mgs, p);
}

// Missing-right candidate at threshold t: left = prefix sums over bins <= t.
__device__ __forceinline__ Cand cand_p1(int t, const Feature& ft,
                                        const float (*cp)[kThreads],
                                        float tg, float th, float tn,
                                        float mgs, const Params& p) {
  const float lg = cp[0][t];
  const float lh = __fadd_rn(cp[1][t], kEpsilon);
  const float lc = cp[2][t];
  const bool shape_ok = ft.two && t <= ft.nb - 2 &&
                        !(ft.is_zero && t == ft.d);
  return evaluate(lg, lh, lc, __fsub_rn(tg, lg), __fsub_rn(th, lh),
                  __fsub_rn(tn, lc), shape_ok, mgs, p);
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

// Shared memory one scan_leaf() call works in.
struct Smem {
  float cm[3][kThreads + 1];  // suffix sums, cm[c][B] = 0
  float cp[3][kThreads];      // prefix sums
  float red_g[2][kThreads];
  int red_t[2][kThreads];
};

// Scan one (leaf, feature): hs holds the histogram's three channels over B
// bins (filled and synchronised by the caller); tg, th (sum_h + 2 *
// K_EPSILON), tn are the leaf totals, mgs its min_gain_shift.  Thread 0
// writes the 8 planes to o[0], o[stride], ..., o[7 * stride].  Every thread
// of the block must call it.
__device__ void scan_leaf(const float (*hs)[kThreads], Smem& sm,
                          const Feature& ft, int B, float tg, float th,
                          float tn, float mgs, const Params& p, float* o,
                          int stride) {
  const int t = threadIdx.x;
  if (t < 3) {
    // missing-left keep mask; suffix sums from the last bin down
    double carry = 0.0;
    for (int b = B - 1; b >= 0; --b) {
      const bool excl = (ft.two && ft.is_zero && b == ft.d) ||
                        (ft.two && ft.is_nan && b >= ft.nb - 1) || b >= ft.nb;
      carry += (double)__fmul_rn(hs[t][b], excl ? 0.0f : 1.0f);
      sm.cm[t][b] = __double2float_rn(carry);
    }
    sm.cm[t][B] = 0.0f;
  } else if (t < 6) {
    // missing-right keep mask; prefix sums from the first bin up
    const int c = t - 3;
    double carry = 0.0;
    for (int b = 0; b < B; ++b) {
      const bool excl = (ft.is_zero && b == ft.d) ||
                        (ft.is_nan && b >= ft.nb - 1) || b >= ft.nb;
      carry += (double)__fmul_rn(hs[c][b], excl ? 0.0f : 1.0f);
      sm.cp[c][b] = __double2float_rn(carry);
    }
  }
  __syncthreads();

  float gm = -INFINITY, gp = -INFINITY;
  int tm = -1, tp = -1;
  if (t < B) {
    gm = cand_m1(t, ft, sm.cm, tg, th, tn, mgs, p).gain;
    gp = cand_p1(t, ft, sm.cp, tg, th, tn, mgs, p).gain;
    tm = t;
    tp = t;
  }
  sm.red_g[0][t] = gm;
  sm.red_t[0][t] = tm;
  sm.red_g[1][t] = gp;
  sm.red_t[1][t] = tp;
  __syncthreads();
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    if (t < s) {
      if (!beats(sm.red_g[0][t], sm.red_t[0][t], sm.red_g[0][t + s],
                 sm.red_t[0][t + s], true)) {
        sm.red_g[0][t] = sm.red_g[0][t + s];
        sm.red_t[0][t] = sm.red_t[0][t + s];
      }
      if (!beats(sm.red_g[1][t], sm.red_t[1][t], sm.red_g[1][t + s],
                 sm.red_t[1][t + s], false)) {
        sm.red_g[1][t] = sm.red_g[1][t + s];
        sm.red_t[1][t] = sm.red_t[1][t + s];
      }
    }
    __syncthreads();
  }
  if (t == 0) {
    const float best_m1 = sm.red_g[0][0];
    const float best_p1 = sm.red_g[1][0];
    const bool use_p1 = best_p1 > best_m1;
    const int bt = use_p1 ? sm.red_t[1][0] : sm.red_t[0][0];
    const Cand c = use_p1 ? cand_p1(bt, ft, sm.cp, tg, th, tn, mgs, p)
                          : cand_m1(bt, ft, sm.cm, tg, th, tn, mgs, p);
    const bool dleft = use_p1 ? false : !(!ft.two && ft.is_nan);
    o[0 * stride] = use_p1 ? best_p1 : best_m1;
    o[1 * stride] = (float)bt;
    o[2 * stride] = dleft ? 1.0f : 0.0f;
    o[3 * stride] = c.lg;
    o[4 * stride] = c.lh;
    o[5 * stride] = c.lc;
    o[6 * stride] = c.lo;
    o[7 * stride] = c.ro;
  }
  // the caller may reuse hs and sm after this
  __syncthreads();
}

}  // namespace scan
