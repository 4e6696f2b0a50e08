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
//     conventions, both outputs;
//   * where the call passes any of them (monotone constraints, feature_contri
//     penalties), the constrained scan: per-leaf value bounds (K,) that clip
//     both outputs, a per-feature monotone sign (F,) int8 whose violation
//     zeroes a threshold's gain, and a per-feature penalty (F,) on the
//     post-shift gain (scan_common.cuh, kCon).  It is a second instantiation
//     of the kernel, so a call with none of them runs the unconstrained scan
//     as before, with no extra load or instruction.
//
// Every field is computed with the plain version's operations in its order
// (_rn intrinsics, no contraction), so it equals ops/split.py on the CPU bit
// for bit.
//
// Design.  A warp per (k, f), four per block, seven blocks (28 warps) per
// SM, 6 KB of shared memory per warp: at K = 128, F = 28 the 3,584 warps
// run in one wave, at K = 2 the call is one short chain.  The warp loads
// its 3 KB histogram with coalesced 16-byte loads and runs
// scan_common.cuh's warp_scan(): six lanes carry the cumulative sums, every
// lane evaluates B / 32 thresholds, a shuffle butterfly picks the best, lane
// 0 writes the fields.  No block-wide barrier, no second launch and no
// torch op around it.
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

// The totals and flags of one call, and where the fields go.
struct Args {
  const float* hist;
  const float *sum_g, *sum_h, *num_data;
  long long sg_stride, sh_stride, nd_stride;
  const int32_t *num_bin, *missing, *default_bin;
  const uint8_t* fmask;
  long long fmask_stride;  // 0 for an (F,) mask, F for (K, F)
  // the constrained scan's inputs, each null where the call has none
  const float *min_c, *max_c;   // (K,) leaf value bounds
  long long mn_stride, mx_stride;
  const int8_t* mono;           // (F,) monotone sign
  const float* penalty;         // (F,) feature_contri factor
  int K, F, B;
  float min_gain_to_split;
  scan::Fields out;        // (10, K, F) planes and (K, F) default_left
};

template <bool kCon>
__global__ void __launch_bounds__(kWarps * 32, kBlocksPerSm)
split_scan(Args a, scan::Params p) {
  __shared__ scan::WarpSmem smem[kWarps];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long pair = (long long)blockIdx.x * kWarps + warp;
  if (pair >= (long long)a.K * a.F) return;  // whole warps only
  const int k = static_cast<int>(pair / a.F);
  const int f = static_cast<int>(pair - (long long)k * a.F);
  scan::WarpSmem& s = smem[warp];
  const int B = a.B;

  scan::load_row(s.hs, a.hist + pair * B * 3, B * 3, lane);
  const scan::Feature ft =
      scan::make_feature(a.num_bin[f], a.missing[f], a.default_bin[f]);
  const bool masked = a.fmask[k * a.fmask_stride + f] == 0;
  __syncwarp();
  float v[scan::kPerLane][3];
  scan::lane_bins(s, B, lane, v);
  scan::Constraint cs;
  if (kCon) {
    if (a.min_c != nullptr) cs.mn = a.min_c[k * a.mn_stride];
    if (a.max_c != nullptr) cs.mx = a.max_c[k * a.mx_stride];
    if (a.mono != nullptr) cs.mono = a.mono[f];
    if (a.penalty != nullptr) cs.pen = a.penalty[f];
  }
  scan::warp_scan<kCon>(s, v, ft, B, a.sum_g[k * a.sg_stride],
                        a.sum_h[k * a.sh_stride], a.num_data[k * a.nd_stride],
                        masked, a.min_gain_to_split, p, a.out, pair, cs);
}

}  // namespace

extern "C" {

// Launch on `stream`: hist (K, F, B, 3) float32 contiguous; the leaf sums
// sum_g, sum_h (no epsilon), num_data as float32 vectors with element
// strides; per-feature int32 metadata; the feature mask as bytes with a row
// stride (0 for one (F,) mask); the leaf bounds min_c, max_c as float32
// vectors with element strides, the (F,) int8 monotone sign and the (F,)
// float32 penalty, each null where the call has none (all four null: the
// unconstrained scan); planes (10, K, F) float32 (plane 1 holds the int32
// threshold) and dleft (K, F) bytes.  Returns cudaGetLastError() after the
// launch (0 = launched).
int lgbt_split_scan(const void* hist, const void* sum_g, long long sg_stride,
                    const void* sum_h, long long sh_stride,
                    const void* num_data, long long nd_stride,
                    const void* num_bin, const void* missing,
                    const void* default_bin, const void* fmask,
                    long long fmask_stride, int K, int F, int B, float l1,
                    float l2, float mds, int use_mds, float min_data,
                    float min_hess, float min_gain_to_split,
                    const void* min_c, long long mn_stride,
                    const void* max_c, long long mx_stride,
                    const void* mono, const void* penalty, void* planes,
                    void* dleft, void* stream) {
  if (B < 1 || B > scan::kBins || K < 1 || F < 1)
    return (int)cudaErrorInvalidValue;
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
  a.min_c = static_cast<const float*>(min_c);
  a.max_c = static_cast<const float*>(max_c);
  a.mn_stride = mn_stride;
  a.mx_stride = mx_stride;
  a.mono = static_cast<const int8_t*>(mono);
  a.penalty = static_cast<const float*>(penalty);
  a.K = K;
  a.F = F;
  a.B = B;
  a.min_gain_to_split = min_gain_to_split;
  a.out = scan::Fields{static_cast<float*>(planes),
                       static_cast<uint8_t*>(dleft), (long long)K * F};
  scan::Params p{l1, l2, mds, use_mds, min_data, min_hess};
  const long long pairs = (long long)K * F;
  const long long blocks = (pairs + kWarps - 1) / kWarps;
  const bool con = min_c != nullptr || max_c != nullptr || mono != nullptr ||
                   penalty != nullptr;
  if (con)
    split_scan<true><<<(unsigned)blocks, kWarps * 32, 0,
                        static_cast<cudaStream_t>(stream)>>>(a, p);
  else
    split_scan<false><<<(unsigned)blocks, kWarps * 32, 0,
                         static_cast<cudaStream_t>(stream)>>>(a, p);
  return (int)cudaGetLastError();
}

}  // extern "C"
