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
//   then scan_common.cuh's scan_leaf() over the fixed histogram
//
//   h_small : (K, F, B, 3) float32, each member's smaller-child histogram
//   pool    : (H, F, B, 3) float32, the learner's histogram pool, updated
//             in place; ph[k] is the member's own slot (its parent
//             histogram, overwritten by the left child), rh[k] a fresh slot
//   tot     : (2K, 5) float32 per child, interleaved [l0, r0, l1, ...]:
//             sum_g, sum_h, sum_h + 2*K_EPSILON, count, min_gain_shift
//   out     : (2K, 8, F) float32 planes, as split_scan.cu
//
// Design.  One block of 256 threads per (k, f), one thread per bin, so one
// block reads and writes every element of its (member, feature) row of the
// pool: each thread reads its bin of pool[ph[k], f] before it writes the left
// child there, and no other block touches that row (the members' slots are
// distinct, the right children's slots fresh), so the in-place write needs
// no second buffer.  The FixHistogram sums run as a pairwise tree over the
// bins padded to a power of two, the order ops/split.py:fix_histogram uses on
// every device, so the fused and the unfused wave agree bit for bit even on
// the count channel, whose values (hessian sums times a rescale) are not
// exact.  Then each child runs scan_leaf(), the batched scan's code: on the
// same histograms every field is bitwise split_scan.cu's.
//
// Bound.  The function must read h_small and the parents' rows and write
// both children, 4 * K * F * B * 3 * 4 bytes, plus the tot rows and the
// 2K * 8 * F planes: at K = 64, F = 28, B = 255 about 22 MB, about 6.6 us at
// 3.35 TB/s.  As in split_scan.cu, the two children's sequential carries
// (2 x B dependent double additions per block) are the likelier limit.

#include "scan_common.cuh"

namespace {

using scan::kThreads;

__global__ void __launch_bounds__(kThreads)
fused_child_scan(const float* __restrict__ h_small, float* __restrict__ pool,
                 const int32_t* __restrict__ ph, const int32_t* __restrict__ rh,
                 const int32_t* __restrict__ left_small,
                 const float* __restrict__ tot,
                 const int32_t* __restrict__ num_bin,
                 const int32_t* __restrict__ missing,
                 const int32_t* __restrict__ default_bin, int F, int B, int P,
                 scan::Params p, float* __restrict__ out) {
  __shared__ float hc[2][3][kThreads];  // the children, then fixed
  __shared__ float tr[6][kThreads];     // FixHistogram pairwise sums
  __shared__ scan::Smem sm;

  const int k = blockIdx.x / F;
  const int f = blockIdx.x - k * F;
  const int t = threadIdx.x;
  const long long row = (long long)B * 3;
  const float* hs = h_small + ((long long)k * F + f) * row;
  float* par = pool + ((long long)ph[k] * F + f) * row;
  float* rgt = pool + ((long long)rh[k] * F + f) * row;
  const bool ls = left_small[k] != 0;
  if (t < B) {
    for (int c = 0; c < 3; ++c) {
      const float a = hs[t * 3 + c];
      const float large = __fsub_rn(par[t * 3 + c], a);
      const float l = ls ? a : large;
      const float r = ls ? large : a;
      hc[0][c][t] = l;
      hc[1][c][t] = r;
      par[t * 3 + c] = l;  // this thread read this element just above
      rgt[t * 3 + c] = r;
    }
  }
  const int d = default_bin[f];
  const bool fix = d > 0 && d < B;
  if (fix) {
    // others[child][c] = sum of the bins but d, pairwise over P bins
    __syncthreads();
    for (int q = 0; q < 6; ++q)
      tr[q][t] = (t < B && t != d) ? hc[q / 3][q % 3][t] : 0.0f;
    __syncthreads();
    for (int s = P / 2; s > 0; s >>= 1) {
      if (t < s)
        for (int q = 0; q < 6; ++q) tr[q][t] = __fadd_rn(tr[q][t], tr[q][t + s]);
      __syncthreads();
    }
    if (t < 6) {
      const int child = t / 3;
      const int c = t % 3;
      const float* tc = tot + (2LL * k + child) * 5;
      const float total = c == 0 ? tc[0] : (c == 1 ? tc[1] : tc[3]);
      hc[child][c][d] = __fsub_rn(total, tr[t][0]);
    }
  }
  __syncthreads();
  const scan::Feature ft =
      scan::make_feature(num_bin[f], missing[f], default_bin[f]);
  for (int child = 0; child < 2; ++child) {
    const float* tc = tot + (2LL * k + child) * 5;
    scan::scan_leaf(hc[child], sm, ft, B, tc[0], tc[2], tc[3], tc[4], p,
                    out + (2LL * k + child) * 8 * F + f, F);
  }
}

}  // namespace

extern "C" {

// Launch on `stream` (see the header for the operands; ph, rh and
// left_small are (K,) int32, P is the bin count rounded up to a power of
// two).  Returns cudaGetLastError() after the launch (0 = launched).
int lgbt_fused_scan(const void* h_small, void* pool, const void* ph,
                    const void* rh, const void* left_small, const void* tot,
                    const void* num_bin, const void* missing,
                    const void* default_bin, int K, int F, int B, int P,
                    float l1, float l2, float mds, int use_mds, float min_data,
                    float min_hess, void* out, void* stream) {
  if (B < 1 || B > kThreads || P < B || P > kThreads || (P & (P - 1)))
    return (int)cudaErrorInvalidValue;
  scan::Params p{l1, l2, mds, use_mds, min_data, min_hess};
  const long long blocks = (long long)K * F;
  fused_child_scan<<<(unsigned)blocks, kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(h_small), static_cast<float*>(pool),
      static_cast<const int32_t*>(ph), static_cast<const int32_t*>(rh),
      static_cast<const int32_t*>(left_small), static_cast<const float*>(tot),
      static_cast<const int32_t*>(num_bin),
      static_cast<const int32_t*>(missing),
      static_cast<const int32_t*>(default_bin), F, B, P, p,
      static_cast<float*>(out));
  return (int)cudaGetLastError();
}

}  // extern "C"
