// Batched best-split scan for the frontier-wave learner, written for Hopper
// (sm_90a).  Build with -fmad=false (native.py does): the gain arithmetic
// must round after every operation, as the plain torch version does.
//
// Replaces the TPU kernel lightgbm_tpu/ops/scan_pallas.py:
// find_best_splits_batched (_scan_kernel / _scan_body), which forms the
// cumulative histograms as triangular MXU contractions.  For every (leaf k,
// feature f) of a (K, F, B, 3) float32 histogram cube it finds the best
// numerical threshold with the semantics of ops/split.py:find_best_splits;
// the scan itself, its semantics and its design (six sequential carries in
// double, one thread per bin, _rn intrinsics) are scan_common.cuh's
// scan_leaf(), which fused_scan.cu shares.
//
// It writes 8 planes per (k, f), as the TPU kernel: the raw best gain, the
// threshold, default_left, and the left sums (g, h + K_EPSILON, count) and
// both outputs at that threshold; the wrapper (ops/scan.py) subtracts the
// gain shift and masks features exactly as find_best_splits does.
//
// Design.  One block of 256 threads per (k, f), one thread per bin: the block
// loads its histogram into shared memory and runs scan_leaf().
//
// Bound.  The function must read the cube once, K * F * B * 3 * 4 bytes, and
// write K * 8 * F * 4; at K = 128, F = 28, B = 255 that is about 11 MB, about
// 3.3 us at 3.35 TB/s.  Its arithmetic (two dozen float operations per bin and
// direction) is far below the card's rate; the sequential carries (B dependent
// double additions per block) are the likelier limit.

#include "scan_common.cuh"

namespace {

using scan::kThreads;

__global__ void __launch_bounds__(kThreads)
split_scan(const float* __restrict__ hist, const float* __restrict__ tot,
           const int32_t* __restrict__ num_bin,
           const int32_t* __restrict__ missing,
           const int32_t* __restrict__ default_bin, int F, int B,
           scan::Params p, float* __restrict__ out) {
  __shared__ float hs[3][kThreads];
  __shared__ scan::Smem sm;

  const int k = blockIdx.x / F;
  const int f = blockIdx.x - k * F;
  const int t = threadIdx.x;
  const scan::Feature ft =
      scan::make_feature(num_bin[f], missing[f], default_bin[f]);
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
  scan::scan_leaf(hs, sm, ft, B, tg, th, tn, mgs, p,
                  out + (long long)k * 8 * F + f, F);
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
  scan::Params p{l1, l2, mds, use_mds, min_data, min_hess};
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
