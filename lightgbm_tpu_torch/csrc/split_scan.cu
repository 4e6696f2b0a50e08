// Batched best-split scan for the frontier-wave learner, written for Hopper
// (sm_90a).  Build with -fmad=false (native.py does): the gain arithmetic
// must round after every operation, as the plain torch version does.
//
// Replaces the TPU kernel lightgbm_tpu/ops/scan_pallas.py:
// find_best_splits_batched (_scan_kernel / _scan_body), which forms the
// cumulative histograms as triangular MXU contractions.  For every (leaf k,
// feature f) of a (K, F, B, 3) float32 histogram cube it finds the best
// numerical threshold with the semantics of ops/split.py:find_best_splits
// (the rules are listed in scan_common.cuh, whose per-threshold arithmetic
// it shares with fused_scan.cu) and writes the SplitCandidates fields
// themselves.  One launch is the whole call:
//
//   * the leaf totals: total_h = sum_h + 2*K_EPSILON and the leaf's
//     min_gain_shift (GetLeafSplitGain + min_gain_to_split), per leaf;
//   * the scan of both missing directions and the best threshold;
//   * the epilogue of find_best_splits: the post-shift gain, -inf where the
//     best is -inf or the feature is masked ((F,) or (K, F) mask), the int32
//     threshold, default_left, the left and right sums with the K_EPSILON
//     conventions, both outputs.
//
// Every field is computed with the plain version's operations in its order
// (_rn intrinsics, no contraction), so it equals ops/split.py on the CPU bit
// for bit.
//
// Design.  A warp per (k, f), four per block, seven blocks (28 warps) per
// SM, 6 KB of shared memory per warp: at K = 128, F = 28 the 3,584 warps
// run in one wave, at K = 2 the call is one short chain.  The warp loads
// its 3 KB histogram with coalesced 16-byte loads.  All 32 lanes write the
// bins of both directions under their keep masks, and six lanes then turn
// them, in place, into the six cumulative sums (3 channels x 2 directions)
// in bin order with one running carry each, in double and rounded to float
// at every bin: that is what torch.cumsum does on the CPU for float32 (a
// tree-shaped scan would not be).  Every lane evaluates B / 32 thresholds
// of both directions, keeps its best of each by scan_common.cuh's beats()
// tie rules (a strict order on (gain, threshold)), and a five-step shuffle
// butterfly gives every lane the warp's best; lane 0 forms the chosen
// candidate and the epilogue.  No block-wide barrier, no second launch and
// no torch op around it.
//
// Bound.  The function must read the cube once, K * F * B * 3 * 4 bytes, and
// the leaf totals, and write the eleven (K, F) fields, ten of 4 bytes and one
// of 1; at K = 128, F = 28, B = 255 that is about 11 MB, about 3.3 us at
// 3.35 TB/s.  Its arithmetic (about 40 float operations per bin and
// direction) is far below the card's rate.  What limits it now: the 256-step
// sequential double carries (a dependent chain per warp, six lanes busy of
// 32) and the instruction count of the threshold evaluation.

#include "scan_common.cuh"

namespace {

constexpr int kWarps = 4;       // (k, f) pairs per block
constexpr int kBlocksPerSm = 7; // 28 warps per SM: K = 128, F = 28 in one
                                // wave (the register cap this sets is 73)
constexpr int kBins = scan::kThreads;  // most bins a histogram holds
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kUnroll = 8;      // bins per step of the carry loop

// One warp's shared memory.
struct WarpSmem {
  union {
    float hs[kBins * 3];        // the histogram as stored, (bin, channel)
    float cm[3][kBins + 1];     // then the suffix sums over bins >= b
  };
  float cp[3][kBins];           // prefix sums over bins <= b
};

// Keep the better of (g, t) and the other lanes' entries, the warp's best in
// every lane after five butterfly steps.
__device__ __forceinline__ void warp_best(float& g, int& t, bool prefer_high) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float og = __shfl_xor_sync(kFull, g, o);
    const int ot = __shfl_xor_sync(kFull, t, o);
    if (!scan::beats(g, t, og, ot, prefer_high)) {
      g = og;
      t = ot;
    }
  }
}

// The totals and flags of one call, and where the fields go.
struct Args {
  const float* hist;
  const float *sum_g, *sum_h, *num_data;
  long long sg_stride, sh_stride, nd_stride;
  const int32_t *num_bin, *missing, *default_bin;
  const uint8_t* fmask;
  long long fmask_stride;  // 0 for an (F,) mask, F for (K, F)
  int K, F, B;
  float min_gain_to_split;
  float* planes;     // (10, K, F): gain, threshold (int32), lsg, lsh, lc,
                     // rsg, rsh, rc, lo, ro
  uint8_t* dleft;    // (K, F) bool
};

__global__ void __launch_bounds__(kWarps * 32, kBlocksPerSm)
split_scan(Args a, scan::Params p) {
  __shared__ WarpSmem smem[kWarps];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long pair = (long long)blockIdx.x * kWarps + warp;
  if (pair >= (long long)a.K * a.F) return;  // whole warps only
  const int k = static_cast<int>(pair / a.F);
  const int f = static_cast<int>(pair - (long long)k * a.F);
  WarpSmem& s = smem[warp];
  const int B = a.B;

  // the histogram: 16-byte loads where the row is aligned, words elsewhere
  const int n = B * 3;
  const float* src = a.hist + pair * n;
  const int head = static_cast<int>(
      ((16 - (reinterpret_cast<uintptr_t>(src) & 15)) & 15) >> 2);
  const int h0 = head < n ? head : n;
  if (lane < h0) s.hs[lane] = src[lane];
  const int n4 = (n - h0) >> 2;
  const float4* src4 = reinterpret_cast<const float4*>(src + h0);
  for (int i = lane; i < n4; i += 32) {
    const float4 v = src4[i];
    float* d = s.hs + h0 + 4 * i;
    d[0] = v.x;
    d[1] = v.y;
    d[2] = v.z;
    d[3] = v.w;
  }
  for (int i = h0 + 4 * n4 + lane; i < n; i += 32) s.hs[i] = src[i];

  // the leaf totals, as ops/scan.py:leaf_totals forms them
  const float tg = a.sum_g[k * a.sg_stride];
  const float th = __fadd_rn(a.sum_h[k * a.sh_stride], 2.0f * scan::kEpsilon);
  const float tn = a.num_data[k * a.nd_stride];
  const float shift = scan::gain_given_output(
      tg, th, scan::leaf_output(tg, th, p), p);
  const float mgs = __fadd_rn(shift, a.min_gain_to_split);
  const scan::Feature ft =
      scan::make_feature(a.num_bin[f], a.missing[f], a.default_bin[f]);
  const bool masked = a.fmask[k * a.fmask_stride + f] == 0;
  __syncwarp();

  // the six cumulative sums, as scan_common.cuh's scan_leaf() forms them.
  // First every lane writes the masked bins of both directions, bins past
  // B as zeros (the missing-left keep mask into cm, the missing-right one
  // into cp); then lanes 0-2 turn cm[c] into suffix sums from bin 255 down
  // and lanes 3-5 cp[c] into prefix sums from bin 0 up, in place, one
  // running carry each in double, rounded to float at every bin.  The
  // leading zeros of the suffix walk leave its carry at +0.0, so every sum
  // is the plain version's.  The loop is the same 256 steps for all six
  // lanes, eight bins to an unrolled step.
  // (cm shares its words with hs: every lane reads its bins first)
  float v[kBins / 32][3];
#pragma unroll
  for (int j = 0; j < kBins / 32; ++j) {
    const int b = lane + 32 * j;
#pragma unroll
    for (int c = 0; c < 3; ++c) v[j][c] = b < B ? s.hs[b * 3 + c] : 0.0f;
  }
  __syncwarp();
#pragma unroll
  for (int j = 0; j < kBins / 32; ++j) {
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
      float v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) v[u] = x[(i0 + u) * step];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        carry += (double)v[u];
        x[(i0 + u) * step] = __double2float_rn(carry);
      }
    }
  }
  __syncwarp();

  // each lane's thresholds t = lane, lane + 32, ...; t < 0 marks none
  float gm = -INFINITY, gp = -INFINITY;
  int tm = -1, tp = -1;
#pragma unroll
  for (int j = 0; j < kBins / 32; ++j) {  // unrolled: independent chains
    const int t = lane + 32 * j;
    if (t < B) {
      const float g1 = scan::cand_m1(t, ft, s.cm, tg, th, tn, mgs, p).gain;
      if (scan::beats(g1, t, gm, tm, true)) {
        gm = g1;
        tm = t;
      }
      const float g2 = scan::cand_p1(t, ft, s.cp, tg, th, tn, mgs, p).gain;
      if (scan::beats(g2, t, gp, tp, false)) {
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
  const scan::Cand c = use_p1
      ? scan::cand_p1(bt, ft, s.cp, tg, th, tn, mgs, p)
      : scan::cand_m1(bt, ft, s.cm, tg, th, tn, mgs, p);
  const float best = use_p1 ? gp : gm;
  const bool dleft = use_p1 ? false : !(!ft.two && ft.is_nan);
  const bool invalid = (isinf(best) && best < 0.0f) || masked;
  const long long plane = (long long)a.K * a.F;
  float* o = a.planes + pair;
  o[0] = invalid ? -INFINITY : __fsub_rn(best, mgs);
  reinterpret_cast<int32_t*>(o + plane)[0] = bt;
  o[2 * plane] = c.lg;
  o[3 * plane] = __fsub_rn(c.lh, scan::kEpsilon);
  o[4 * plane] = c.lc;
  o[5 * plane] = __fsub_rn(tg, c.lg);
  o[6 * plane] = __fsub_rn(__fsub_rn(th, c.lh), scan::kEpsilon);
  o[7 * plane] = __fsub_rn(tn, c.lc);
  o[8 * plane] = c.lo;
  o[9 * plane] = c.ro;
  a.dleft[pair] = dleft ? 1 : 0;
}

}  // namespace

extern "C" {

// Launch on `stream`: hist (K, F, B, 3) float32 contiguous; the leaf sums
// sum_g, sum_h (no epsilon), num_data as float32 vectors with element
// strides; per-feature int32 metadata; the feature mask as bytes with a row
// stride (0 for one (F,) mask); planes (10, K, F) float32 (plane 1 holds the
// int32 threshold) and dleft (K, F) bytes.  Returns cudaGetLastError()
// after the launch (0 = launched).
int lgbt_split_scan(const void* hist, const void* sum_g, long long sg_stride,
                    const void* sum_h, long long sh_stride,
                    const void* num_data, long long nd_stride,
                    const void* num_bin, const void* missing,
                    const void* default_bin, const void* fmask,
                    long long fmask_stride, int K, int F, int B, float l1,
                    float l2, float mds, int use_mds, float min_data,
                    float min_hess, float min_gain_to_split, void* planes,
                    void* dleft, void* stream) {
  if (B < 1 || B > kBins || K < 1 || F < 1) return (int)cudaErrorInvalidValue;
  Args a;
  a.hist = static_cast<const float*>(hist);
  a.sum_g = static_cast<const float*>(sum_g);
  a.sum_h = static_cast<const float*>(sum_h);
  a.num_data = static_cast<const float*>(num_data);
  a.sg_stride = sg_stride;
  a.sh_stride = sh_stride;
  a.nd_stride = nd_stride;
  a.num_bin = static_cast<const int32_t*>(num_bin);
  a.missing = static_cast<const int32_t*>(missing);
  a.default_bin = static_cast<const int32_t*>(default_bin);
  a.fmask = static_cast<const uint8_t*>(fmask);
  a.fmask_stride = fmask_stride;
  a.K = K;
  a.F = F;
  a.B = B;
  a.min_gain_to_split = min_gain_to_split;
  a.planes = static_cast<float*>(planes);
  a.dleft = static_cast<uint8_t*>(dleft);
  scan::Params p{l1, l2, mds, use_mds, min_data, min_hess};
  const long long pairs = (long long)K * F;
  const long long blocks = (pairs + kWarps - 1) / kWarps;
  split_scan<<<(unsigned)blocks, kWarps * 32, 0,
               static_cast<cudaStream_t>(stream)>>>(a, p);
  return (int)cudaGetLastError();
}

}  // extern "C"
