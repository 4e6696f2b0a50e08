// Fused child scans of a quantized growth wave, written for Hopper (sm_90a).
// Build with -fmad=false (native.py does), as split_scan.cu.
//
// Replaces the TPU kernel lightgbm_tpu/ops/scan_pallas.py:fused_child_scans
// (_fused_kernel), which folds the per-wave subtract / select /
// FixHistogram / scan glue into one launch.  For every wave member k and
// feature f it computes, in true float32:
//
//   large    = pool[ph[k], f] - h_small[k, f]            (sibling subtraction)
//   hl, hr   = (h_small, large) if left_small[k] else (large, h_small)
//   pool[ph[k], f] = hl;  pool[rh[k], f] = hr             (the raw children)
//   for each child: the default-bin entry rebuilt as the child's totals minus
//   the other bins (Dataset::FixHistogram, a feature with default_bin > 0),
//   then the split scan of the fixed histogram, every SplitCandidates field
//
//   h_small : (K, F, B, 3) float32, each member's smaller-child histogram
//   pool    : (H, F, B, 3) float32, the learner's histogram pool, updated
//             in place; ph[k] is the member's own slot (its parent
//             histogram, overwritten by the left child), rh[k] a fresh slot;
//             slots are int64 with element strides, as the learner makes them
//   left_small : (K,) bool with an element stride
//   sums    : the (2K,) child sums sum_g, sum_h (no epsilon), count, float32
//             with element strides, interleaved [l0, r0, l1, r1, ...]
//   mask    : the feature mask, (F,) or (2K, F) bytes
//   out     : (10, 2K, F) float32 planes and (2K, F) default_left, as
//             split_scan.cu writes them
//
// One launch is the whole call: for the learner's tensors the wrapper issues
// no other device op.
//
// Design.  A warp per (member, child, feature), 2K * F warps packed as
// split_scan.cu packs its (leaf, feature) warps: four a block, seven blocks
// an SM.  The smaller child's warp loads h_small[k, f].  The larger child's
// warp loads h_small[k, f] and the parent's row pool[ph[k], f], forms the
// larger child by subtraction, and writes BOTH pool rows.  So the order of
// the parent's read before its overwrite is the program order of that one
// warp (each lane's loads have returned before the warp synchronises and
// any lane stores), and no other warp reads or writes those rows: the
// smaller child's warp never touches the pool, the members' slots are
// distinct and the right children's slots fresh.  No barrier between warps
// and no second buffer are needed.  (Both children in one warp would
// serialise two 256-step carries; a named barrier between the pair of warps
// would tie two warps' schedules for nothing.)
//
// The child's warp then rebuilds the default-bin entry in registers: the
// sum of the other bins as ops/split.py:pairwise_bin_sum forms it, a
// pairwise tree over the bins padded to a power of two P (x[i] + x[i + P/2]
// at every level: the levels of half 128, 64 and 32 add a lane's own bins
// lane + 32 j, the last five are shuffles), so the entry equals
// fix_histogram's on every device bit for bit.  Then scan_common.cuh's
// warp_scan() scans it with split_scan.cu's code and writes the fields, so
// on the same histograms every field is bitwise split_scan.cu's, and equal
// to the plain version on the CPU.
//
// Bound.  The function must read h_small and the parents' rows and write
// both children, 4 * K * F * B * 3 * 4 bytes, plus the (2K,) sums and the
// 2K * F fields: at K = 64, F = 28, B = 255 about 22 MB, about 6.6 us at
// 3.35 TB/s.  As in split_scan.cu, the sequential carries (B dependent
// double additions per warp) and the threshold evaluation's instructions
// are the likelier limit.

#include "scan_common.cuh"

namespace {

constexpr int kWarps = 4;        // (member, child, feature) warps per block
constexpr int kBlocksPerSm = 7;  // as split_scan.cu

struct Args {
  const float* h_small;
  float* pool;
  const int64_t *ph, *rh;
  long long ph_stride, rh_stride;
  const uint8_t* left_small;
  long long ls_stride;
  const float *sum_g, *sum_h, *num_data;
  long long sg_stride, sh_stride, nd_stride;
  const int32_t *num_bin, *missing, *default_bin;
  const uint8_t* fmask;
  long long fmask_stride;  // 0 for an (F,) mask, F for (2K, F)
  int K, F, B;
  long long H;             // pool slots
  float min_gain_to_split;
  scan::Fields out;        // (10, 2K, F) planes and (2K, F) default_left
};

// The pairwise sum over P bins (a power of two, at most kBins) of x, a
// lane's bins lane + 32 j, one channel; the result in every lane.
__device__ __forceinline__ float pairwise_sum(float (&x)[scan::kPerLane],
                                              int P) {
#pragma unroll
  for (int h = scan::kPerLane / 2; h >= 1; h >>= 1) {  // halves 128, 64, 32
    if (P >= 64 * h) {
#pragma unroll
      for (int j = 0; j < h; ++j) x[j] = __fadd_rn(x[j], x[j + h]);
    }
  }
  float t = x[0];
#pragma unroll
  for (int half = 16; half >= 1; half >>= 1) {
    const float o = __shfl_down_sync(scan::kFull, t, half);
    if (P >= 2 * half) t = __fadd_rn(t, o);
  }
  return __shfl_sync(scan::kFull, t, 0);
}

__global__ void __launch_bounds__(kWarps * 32, kBlocksPerSm)
fused_child_scan(Args a, scan::Params p) {
  __shared__ scan::WarpSmem smem[kWarps];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long pair = (long long)blockIdx.x * kWarps + warp;
  if (pair >= 2LL * a.K * a.F) return;  // whole warps only
  const int row = static_cast<int>(pair / a.F);  // the child, 2k + c
  const int f = static_cast<int>(pair - (long long)row * a.F);
  const int k = row >> 1;
  const bool ls = a.left_small[k * a.ls_stride] != 0;
  const bool smaller = ((row & 1) == 0) == ls;
  scan::WarpSmem& s = smem[warp];
  const int B = a.B;
  const int n = B * 3;

  const float* hs = a.h_small + ((long long)k * a.F + f) * n;
  scan::load_row(s.hs, hs, n, lane);
  if (!smaller) {
    const long long ph = a.ph[k * a.ph_stride];
    const long long rh = a.rh[k * a.rh_stride];
    if (ph < 0 || ph >= a.H || rh < 0 || rh >= a.H) __trap();
    float* par = a.pool + (ph * a.F + f) * n;
    float* rgt = a.pool + (rh * a.F + f) * n;
    float* ps = &s.cp[0][0];  // the parent's row, before any write
    scan::load_row(ps, par, n, lane);
    __syncwarp();
    for (int e = lane; e < n; e += 32) {
      const float sm = s.hs[e];
      const float lg = __fsub_rn(ps[e], sm);
      par[e] = ls ? sm : lg;
      rgt[e] = ls ? lg : sm;
      s.hs[e] = lg;  // this warp's child
    }
  }
  __syncwarp();
  float v[scan::kPerLane][3];
  scan::lane_bins(s, B, lane, v);

  const float tg = a.sum_g[row * a.sg_stride];
  const float sh = a.sum_h[row * a.sh_stride];
  const float tn = a.num_data[row * a.nd_stride];
  const int d = a.default_bin[f];
  if (d > 0 && d < B) {
    // FixHistogram: bin d = the child's totals minus the other bins
    const int P = 1 << (32 - __clz(B - 1));  // B rounded up to a power of 2
    const float tot[3] = {tg, sh, tn};
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      float x[scan::kPerLane];
#pragma unroll
      for (int j = 0; j < scan::kPerLane; ++j)
        x[j] = lane + 32 * j == d ? 0.0f : v[j][c];
      const float fixed = __fsub_rn(tot[c], pairwise_sum(x, P));
#pragma unroll
      for (int j = 0; j < scan::kPerLane; ++j)
        if (lane + 32 * j == d) v[j][c] = fixed;
    }
  }
  const scan::Feature ft =
      scan::make_feature(a.num_bin[f], a.missing[f], d);
  const bool masked = a.fmask[row * a.fmask_stride + f] == 0;
  scan::warp_scan(s, v, ft, B, tg, sh, tn, masked, a.min_gain_to_split, p,
                  a.out, pair);
}

}  // namespace

extern "C" {

// Launch on `stream` (see the header for the operands).  Returns
// cudaGetLastError() after the launch (0 = launched), or
// cudaErrorInvalidValue for shapes the kernel does not take.
int lgbt_fused_scan(const void* h_small, void* pool, long long H,
                    const void* ph, long long ph_stride, const void* rh,
                    long long rh_stride, const void* left_small,
                    long long ls_stride, const void* sum_g,
                    long long sg_stride, const void* sum_h,
                    long long sh_stride, const void* num_data,
                    long long nd_stride, const void* num_bin,
                    const void* missing, const void* default_bin,
                    const void* fmask, long long fmask_stride, int K, int F,
                    int B, float l1, float l2, float mds, int use_mds,
                    float min_data, float min_hess, float min_gain_to_split,
                    void* planes, void* dleft, void* stream) {
  if (B < 1 || B > scan::kBins || K < 1 || F < 1 || H < 1)
    return (int)cudaErrorInvalidValue;
  Args a;
  a.h_small = static_cast<const float*>(h_small);
  a.pool = static_cast<float*>(pool);
  a.ph = static_cast<const int64_t*>(ph);
  a.rh = static_cast<const int64_t*>(rh);
  a.ph_stride = ph_stride;
  a.rh_stride = rh_stride;
  a.left_small = static_cast<const uint8_t*>(left_small);
  a.ls_stride = ls_stride;
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
  a.H = H;
  a.min_gain_to_split = min_gain_to_split;
  a.out = scan::Fields{static_cast<float*>(planes),
                       static_cast<uint8_t*>(dleft), 2LL * K * F};
  scan::Params p{l1, l2, mds, use_mds, min_data, min_hess};
  const long long blocks = (2LL * K * F + kWarps - 1) / kWarps;
  fused_child_scan<<<(unsigned)blocks, kWarps * 32, 0,
                     static_cast<cudaStream_t>(stream)>>>(a, p);
  return (int)cudaGetLastError();
}

}  // extern "C"
