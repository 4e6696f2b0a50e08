// Batched best-split scan for the frontier-wave learner, written for Hopper
// (sm_90a).  Build with -fmad=false (native.py does): the gain arithmetic
// must round after every operation, as the plain torch version does.
//
// Replaces the TPU kernel lightgbm_tpu/ops/scan_pallas.py:
// find_best_splits_batched (_scan_kernel / _scan_body), which forms the
// cumulative histograms as triangular MXU contractions.  For every (leaf k,
// feature f) of a (K, F, B, 3) float32 histogram cube it finds the best
// numerical threshold with the semantics of ops/split.py:find_best_splits
// (the reference's FeatureHistogram::FindBestThreshold*):
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
// It writes 8 planes per (k, f), as the TPU kernel: the raw best gain, the
// threshold, default_left, and the left sums (g, h + K_EPSILON, count) and
// both outputs at that threshold; the wrapper (ops/scan.py) subtracts the
// gain shift and masks features exactly as find_best_splits does.
//
// Design.  One block of 256 threads per (k, f), one thread per bin.  Six
// threads form the six cumulative sums (3 channels x 2 directions) in bin
// order with one running carry each, accumulated in double and rounded to
// float at every bin: that is what torch.cumsum does on the CPU for float32,
// so the sums equal the plain version's on the CPU bit for bit (a tree-shaped
// block scan would not).  Every thread then evaluates its threshold in both
// directions with the operation order of ops/split.py (explicit _rn
// intrinsics, no contraction), and two shared-memory reductions pick each
// direction's best threshold with the tie rules above.
//
// Bound.  The function must read the cube once, K * F * B * 3 * 4 bytes, and
// write K * 8 * F * 4; at K = 128, F = 28, B = 255 that is about 11 MB, about
// 3.3 us at 3.35 TB/s.  Its arithmetic (two dozen float operations per bin and
// direction) is far below the card's rate; the sequential carries (B dependent
// double additions per block) are the likelier limit.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

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

__global__ void __launch_bounds__(kThreads)
split_scan(const float* __restrict__ hist, const float* __restrict__ tot,
           const int32_t* __restrict__ num_bin,
           const int32_t* __restrict__ missing,
           const int32_t* __restrict__ default_bin, int F, int B, Params p,
           float* __restrict__ out) {
  __shared__ float hs[3][kThreads];
  __shared__ float cm[3][kThreads + 1];  // suffix sums, cm[c][B] = 0
  __shared__ float cp[3][kThreads];      // prefix sums
  __shared__ float red_g[2][kThreads];
  __shared__ int red_t[2][kThreads];

  const int k = blockIdx.x / F;
  const int f = blockIdx.x - k * F;
  const int t = threadIdx.x;
  Feature ft;
  ft.nb = num_bin[f];
  ft.d = default_bin[f];
  const int mt = missing[f];
  ft.two = ft.nb > 2 && mt != kMissingNone;
  ft.is_zero = mt == kMissingZero;
  ft.is_nan = mt == kMissingNan;
  const float tg = tot[k * 4 + 0];
  const float th = tot[k * 4 + 1];  // sum_h + 2 * K_EPSILON
  const float tn = tot[k * 4 + 2];
  const float mgs = tot[k * 4 + 3];  // gain shift + min_gain_to_split

  const float* h = hist + ((long long)k * F + f) * (long long)B * 3;
  if (t < B) {
    hs[0][t] = h[t * 3 + 0];
    hs[1][t] = h[t * 3 + 1];
    hs[2][t] = h[t * 3 + 2];
  }
  __syncthreads();
  if (t < 3) {
    // missing-left keep mask; suffix sums from the last bin down
    double carry = 0.0;
    for (int b = B - 1; b >= 0; --b) {
      const bool excl = (ft.two && ft.is_zero && b == ft.d) ||
                        (ft.two && ft.is_nan && b >= ft.nb - 1) || b >= ft.nb;
      carry += (double)__fmul_rn(hs[t][b], excl ? 0.0f : 1.0f);
      cm[t][b] = __double2float_rn(carry);
    }
    cm[t][B] = 0.0f;
  } else if (t < 6) {
    // missing-right keep mask; prefix sums from the first bin up
    const int c = t - 3;
    double carry = 0.0;
    for (int b = 0; b < B; ++b) {
      const bool excl = (ft.is_zero && b == ft.d) ||
                        (ft.is_nan && b >= ft.nb - 1) || b >= ft.nb;
      carry += (double)__fmul_rn(hs[c][b], excl ? 0.0f : 1.0f);
      cp[c][b] = __double2float_rn(carry);
    }
  }
  __syncthreads();

  float gm = -INFINITY, gp = -INFINITY;
  int tm = -1, tp = -1;
  if (t < B) {
    gm = cand_m1(t, ft, cm, tg, th, tn, mgs, p).gain;
    gp = cand_p1(t, ft, cp, tg, th, tn, mgs, p).gain;
    tm = t;
    tp = t;
  }
  red_g[0][t] = gm;
  red_t[0][t] = tm;
  red_g[1][t] = gp;
  red_t[1][t] = tp;
  __syncthreads();
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    if (t < s) {
      if (!beats(red_g[0][t], red_t[0][t], red_g[0][t + s], red_t[0][t + s],
                 true)) {
        red_g[0][t] = red_g[0][t + s];
        red_t[0][t] = red_t[0][t + s];
      }
      if (!beats(red_g[1][t], red_t[1][t], red_g[1][t + s], red_t[1][t + s],
                 false)) {
        red_g[1][t] = red_g[1][t + s];
        red_t[1][t] = red_t[1][t + s];
      }
    }
    __syncthreads();
  }
  if (t == 0) {
    const float best_m1 = red_g[0][0];
    const float best_p1 = red_g[1][0];
    const bool use_p1 = best_p1 > best_m1;
    const int bt = use_p1 ? red_t[1][0] : red_t[0][0];
    const Cand c = use_p1 ? cand_p1(bt, ft, cp, tg, th, tn, mgs, p)
                          : cand_m1(bt, ft, cm, tg, th, tn, mgs, p);
    const bool dleft = use_p1 ? false : !(!ft.two && ft.is_nan);
    float* o = out + (long long)k * 8 * F + f;
    o[0 * F] = use_p1 ? best_p1 : best_m1;
    o[1 * F] = (float)bt;
    o[2 * F] = dleft ? 1.0f : 0.0f;
    o[3 * F] = c.lg;
    o[4 * F] = c.lh;
    o[5 * F] = c.lc;
    o[6 * F] = c.lo;
    o[7 * F] = c.ro;
  }
}

}  // namespace

extern "C" {

// Launch on `stream`: hist (K, F, B, 3) float32, tot (K, 4) float32 rows
// (sum_g, sum_h + 2*K_EPSILON, count, min_gain_shift), per-feature int32
// metadata, out (K, 8, F) float32.  Returns cudaGetLastError() after the
// launch (0 = launched).
int lgbt_split_scan(const void* hist, const void* tot, const void* num_bin,
                    const void* missing, const void* default_bin, int K, int F,
                    int B, float l1, float l2, float mds, int use_mds,
                    float min_data, float min_hess, void* out, void* stream) {
  if (B < 1 || B > kThreads) return (int)cudaErrorInvalidValue;
  Params p{l1, l2, mds, use_mds, min_data, min_hess};
  const long long blocks = (long long)K * F;
  split_scan<<<(unsigned)blocks, kThreads, 0,
               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(hist), static_cast<const float*>(tot),
      static_cast<const int32_t*>(num_bin),
      static_cast<const int32_t*>(missing),
      static_cast<const int32_t*>(default_bin), F, B, p,
      static_cast<float*>(out));
  return (int)cudaGetLastError();
}

}  // extern "C"
