// Best categorical split per (leaf, categorical feature), written for Hopper
// (sm_90a).  Build with -fmad=false (native.py does): the gain arithmetic
// must round after every operation, as the plain torch version does.
//
// Replaces the XLA function lightgbm_tpu/ops/split_cat.py:
// find_best_splits_categorical (a lax.scan vmapped over feature and
// direction; not a pallas_call).  For every (leaf k, categorical column c)
// of a (K, F, B, 3) float32 histogram cube it finds the best categorical
// split with the semantics of ops/split_cat.py:find_best_splits_categorical
// (the reference's FeatureHistogram::FindBestThresholdCategorical) and
// writes the column's SplitCandidates fields in place (threshold 0,
// default_left false) and its (W,) bitset words, W = ceil(B / 32):
//
//   * one-vs-other for a feature of at most max_cat_to_onehot bins: every
//     bin as the lone left category, lambda_l2, the smallest bin on ties;
//   * sorted-CTR many-vs-many otherwise: the bins with cnt >= cat_smooth
//     sorted by g / (h + cat_smooth), the bin index second (the plain
//     version's stable argsort; -0.0 and 0.0 equal, NaN after +inf, an
//     ineligible bin at +inf), scanned from both ends up to
//     min(max_cat_threshold, (used + 1) / 2) categories with the
//     min_data_per_group bookkeeping, lambda_l2 + cat_l2; the backward
//     direction only on strictly greater gain.
//
// Every field is computed with the plain version's operations in its order
// (_rn intrinsics, scan_common.cuh's leaf output and gain), so it equals
// ops/split_cat.py on the CPU bit for bit.
//
// Design.  One warp per (k, c), a block each, the grid covering only the
// categorical columns (the learner lists them once); the numerical columns'
// fields come from split_scan.cu, launched before this kernel on the same
// fields.  The warp loads its histogram row into shared memory with
// coalesced 16-byte loads.  One-hot: a lane per bin, a shuffle argmax.
// Many-vs-many: each lane builds the 64-bit sort keys (class, the float's
// order-preserving bits, bin) of its bins, a bitonic sort over the next
// power of two in shared memory orders them, then lane 0 runs the forward
// scan and lane 1 the backward one, each in the plain version's order; the
// members' bits are set with shared-memory atomics and written by W lanes.
// No block-wide barrier and no torch op around the launch.
//
// Bound.  The function must read the categorical columns' histograms once,
// K * C * B * 3 * 4 bytes, and the leaf totals, and write the eleven fields
// and W words of each (k, c); at K = 128, C = 6, B = 256 that is about 2.4
// MB, 0.7 us at 3.35 TB/s.  What limits this simple version: the sort's
// log2(P) * (log2(P) + 1) / 2 warp-synchronous stages and the sequential
// scans of up to 32 positions on two lanes.

#include "scan_common.cuh"

namespace {

constexpr int kMaxBins = 1024;
constexpr int kMaxWords = kMaxBins / 32;
constexpr int kBinBits = 10;  // bins fit in the key's low 10 bits

struct Args {
  const float* hist;
  const float *sum_g, *sum_h, *num_data;
  long long sg_stride, sh_stride, nd_stride;
  const int32_t *num_bin, *missing;
  const uint8_t* fmask;
  long long fmask_stride;  // 0 for an (F,) mask, F for (K, F)
  const int32_t* cols;
  int C, K, F, B, P, W;
  float min_gain_to_split, cat_smooth, min_data_per_group;
  int max_cat_threshold, max_cat_to_onehot;
  float *gain, *lsg, *lsh, *lc, *rsg, *rsh, *rc, *lo, *ro;
  int32_t* thr;
  uint8_t* dleft;
  int32_t* bits;
};

// The float's bits mapped to an unsigned order: larger float, larger key.
__device__ __forceinline__ uint32_t ordered(float x) {
  const uint32_t u = __float_as_uint(x);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// Sort key of bin b: class (0 a number or +inf, 1 NaN, 2 padding), then
// the value, then the bin (unique keys, so the sort is stable).
__device__ __forceinline__ unsigned long long sort_key(uint32_t cls, float v,
                                                      int b) {
  return ((unsigned long long)cls << (32 + kBinBits)) |
         ((unsigned long long)(cls == 0 ? ordered(v) : 0u) << kBinBits) |
         (unsigned long long)b;
}

// One direction's scan over sorted positions; every lane that calls it
// scans on its own (lane 0 forward, lane 1 backward).
struct DirBest {
  float gain, lg, lh, lc;
  int i;
};

__device__ __forceinline__ DirBest scan_dir(
    bool bwd, int used, int max_cat, const unsigned long long* keys,
    const float* hs, float tg, float th, float tn, float mgs,
    float min_data_per_group, const scan::Params& pm) {
  float slg = 0.0f, slh = scan::kEpsilon, lcnt = 0.0f, grp = 0.0f;
  DirBest best{-INFINITY, 0.0f, 0.0f, 0.0f, -1};
  for (int i = 0; i < max_cat; ++i) {
    const int b = static_cast<int>(keys[bwd ? used - 1 - i : i] &
                                   ((1u << kBinBits) - 1));
    slg = __fadd_rn(slg, hs[b * 3]);
    slh = __fadd_rn(slh, hs[b * 3 + 1]);
    lcnt = __fadd_rn(lcnt, hs[b * 3 + 2]);
    grp = __fadd_rn(grp, hs[b * 3 + 2]);
    const float rcnt = __fsub_rn(tn, lcnt);
    const float srh = __fsub_rn(th, slh);
    if (rcnt < pm.min_data || rcnt < min_data_per_group ||
        srh < pm.min_hess)
      break;  // the plain version's `stopped`: no later position is active
    if (!(lcnt >= pm.min_data && slh >= pm.min_hess &&
          grp >= min_data_per_group))
      continue;
    const float rg = __fsub_rn(tg, slg);
    const float l_out = scan::leaf_output(slg, slh, pm);
    const float r_out = scan::leaf_output(rg, srh, pm);
    const float gain =
        __fadd_rn(scan::gain_given_output(slg, slh, l_out, pm),
                  scan::gain_given_output(rg, srh, r_out, pm));
    grp = 0.0f;
    if (gain > mgs && gain > best.gain) {
      best.gain = gain;
      best.i = i;
      best.lg = slg;
      best.lh = slh;
      best.lc = lcnt;
    }
  }
  return best;
}

__global__ void __launch_bounds__(32)
split_cat(Args a, scan::Params p, scan::Params pm) {
  extern __shared__ unsigned long long smem[];
  const int lane = threadIdx.x;
  const int k = blockIdx.x / a.C;
  const int f = a.cols[blockIdx.x - k * a.C];
  const long long pair = (long long)k * a.F + f;
  const int B = a.B;
  unsigned long long* keys = smem;                          // (P,)
  float* hs = reinterpret_cast<float*>(keys + a.P);         // (B, 3)
  uint32_t* words = reinterpret_cast<uint32_t*>(hs + 3 * B);  // (W,)

  scan::load_row(hs, a.hist + pair * B * 3, B * 3, lane);
  if (lane < a.W) words[lane] = 0u;
  const int nb = a.num_bin[f];
  const int used_bin = nb - 1 + (a.missing[f] == scan::kMissingNone ? 1 : 0);
  const bool masked = a.fmask[k * a.fmask_stride + f] == 0;
  const float tg = a.sum_g[k * a.sg_stride];
  const float th = __fadd_rn(a.sum_h[k * a.sh_stride], 2.0f * scan::kEpsilon);
  const float tn = a.num_data[k * a.nd_stride];
  const float mgs = __fadd_rn(
      scan::gain_given_output(tg, th, scan::leaf_output(tg, th, p), p),
      a.min_gain_to_split);
  const bool onehot = nb <= a.max_cat_to_onehot;
  __syncwarp();

  float gain, lg, lh, lc;
  int oh_t = 0, mv_i = -1, used = 0;
  bool use_bwd = false;
  if (onehot) {
    // a lane per bin; the lane keeps its best, ties to its smaller bin
    float bg = -INFINITY;
    int bt = lane < B ? lane : 0x7fffffff;
    for (int b = lane; b < B; b += 32) {
      const float g = hs[b * 3], h = hs[b * 3 + 1], c = hs[b * 3 + 2];
      const float other_g = __fsub_rn(tg, g);
      const float other_h = __fsub_rn(__fsub_rn(th, h), scan::kEpsilon);
      const float other_n = __fsub_rn(tn, c);
      const bool valid = b < used_bin && c >= p.min_data &&
                         h >= p.min_hess && other_n >= p.min_data &&
                         other_h >= p.min_hess;
      const float h_eps = __fadd_rn(h, scan::kEpsilon);
      const float o_out = scan::leaf_output(other_g, other_h, p);
      const float b_out = scan::leaf_output(g, h_eps, p);
      const float gv =
          __fadd_rn(scan::gain_given_output(other_g, other_h, o_out, p),
                    scan::gain_given_output(g, h_eps, b_out, p));
      const float gk = (valid && gv > mgs) ? gv : -INFINITY;
      if (gk > bg) {
        bg = gk;
        bt = b;
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float og = __shfl_xor_sync(scan::kFull, bg, o);
      const int ot = __shfl_xor_sync(scan::kFull, bt, o);
      if (og > bg || (og == bg && ot < bt)) {
        bg = og;
        bt = ot;
      }
    }
    oh_t = bt;
    gain = bg;
    lg = hs[oh_t * 3];
    lh = __fadd_rn(hs[oh_t * 3 + 1], scan::kEpsilon);
    lc = hs[oh_t * 3 + 2];
  } else {
    // sort keys; used = the eligible bins
    int n_elig = 0;
    for (int q = lane; q < a.P; q += 32) {
      bool elig = false;
      unsigned long long key;
      if (q < B) {
        const float g = hs[q * 3], h = hs[q * 3 + 1], c = hs[q * 3 + 2];
        elig = q < used_bin && c >= a.cat_smooth;
        if (elig) {
          // + 0.0 turns -0.0 into 0.0
          const float ctr = __fadd_rn(__fdiv_rn(g, __fadd_rn(h, a.cat_smooth)),
                                      0.0f);
          key = isnan(ctr) ? sort_key(1u, 0.0f, q) : sort_key(0u, ctr, q);
        } else {
          key = sort_key(0u, INFINITY, q);
        }
      } else {
        key = sort_key(2u, 0.0f, q);
      }
      keys[q] = key;
      n_elig += __popc(__ballot_sync(__activemask(), elig));
    }
    used = __shfl_sync(scan::kFull, n_elig, 0);
    __syncwarp();
    // bitonic sort of the P keys, ascending
    for (int size = 2; size <= a.P; size <<= 1) {
      for (int stride = size >> 1; stride > 0; stride >>= 1) {
        for (int t = lane; t < (a.P >> 1); t += 32) {
          const int i = 2 * stride * (t / stride) + (t % stride);
          const int j = i + stride;
          const bool asc = (i & size) == 0;
          const unsigned long long x = keys[i], y = keys[j];
          if ((x > y) == asc) {
            keys[i] = y;
            keys[j] = x;
          }
        }
        __syncwarp();
      }
    }
    const int max_cat = min(a.max_cat_threshold, (used + 1) / 2);
    DirBest d{-INFINITY, 0.0f, 0.0f, 0.0f, -1};
    if (lane < 2)
      d = scan_dir(lane == 1, used, max_cat, keys, hs, tg, th, tn, mgs,
                   a.min_data_per_group, pm);
    const float bg = __shfl_sync(scan::kFull, d.gain, 1);
    const int bi = __shfl_sync(scan::kFull, d.i, 1);
    const float b_lg = __shfl_sync(scan::kFull, d.lg, 1);
    const float b_lh = __shfl_sync(scan::kFull, d.lh, 1);
    const float b_lc = __shfl_sync(scan::kFull, d.lc, 1);
    const float fg = __shfl_sync(scan::kFull, d.gain, 0);
    use_bwd = bg > fg;
    if (use_bwd) {
      gain = bg;
      mv_i = bi;
      lg = b_lg;
      lh = b_lh;
      lc = b_lc;
    } else {
      gain = fg;
      mv_i = __shfl_sync(scan::kFull, d.i, 0);
      lg = __shfl_sync(scan::kFull, d.lg, 0);
      lh = __shfl_sync(scan::kFull, d.lh, 0);
      lc = __shfl_sync(scan::kFull, d.lc, 0);
    }
  }

  // the members' bits (none when the split is invalid)
  const bool invalid = (isinf(gain) && gain < 0.0f) || masked;
  if (!invalid) {
    if (onehot) {
      if (lane == 0) words[oh_t >> 5] |= 1u << (oh_t & 31);
    } else {
      const int lo_pos = use_bwd ? used - 1 - mv_i : 0;
      const int hi_pos = use_bwd ? used - 1 : mv_i;
      for (int q = lo_pos + lane; q <= hi_pos; q += 32) {
        const int b = static_cast<int>(keys[q] & ((1u << kBinBits) - 1));
        if (b < used_bin && hs[b * 3 + 2] >= a.cat_smooth)  // eligible
          atomicOr(&words[b >> 5], 1u << (b & 31));
      }
    }
  }
  __syncwarp();
  if (lane < a.W)
    a.bits[pair * a.W + lane] = static_cast<int32_t>(words[lane]);
  if (lane != 0) return;

  const scan::Params& pe = onehot ? p : pm;
  const float rg = __fsub_rn(tg, lg);
  const float rh = __fsub_rn(th, lh);
  const float rc = __fsub_rn(tn, lc);
  a.gain[pair] = invalid ? -INFINITY : __fsub_rn(gain, mgs);
  a.thr[pair] = 0;
  a.dleft[pair] = 0;
  a.lsg[pair] = lg;
  a.lsh[pair] = __fsub_rn(lh, scan::kEpsilon);
  a.lc[pair] = lc;
  a.rsg[pair] = rg;
  a.rsh[pair] = __fsub_rn(rh, scan::kEpsilon);
  a.rc[pair] = rc;
  a.lo[pair] = scan::leaf_output(lg, lh, pe);
  a.ro[pair] = scan::leaf_output(rg, rh, pe);
}

}  // namespace

extern "C" {

// Launch on `stream`: hist (K, F, B, 3) float32 contiguous; the leaf sums
// sum_g, sum_h (no epsilon), num_data as float32 vectors with element
// strides; per-feature int32 num_bin and missing type; the feature mask as
// bytes with a row stride (0 for one (F,) mask); the C categorical columns
// as int32; the (K, F) contiguous candidate fields (gain, threshold int32,
// default_left bytes, left sums, right sums, outputs) and bits (K, F, W)
// int32, of which the categorical columns are written.  Returns
// cudaGetLastError() after the launch (0 = launched).
int lgbt_split_cat(const void* hist, const void* sum_g, long long sg_stride,
                   const void* sum_h, long long sh_stride,
                   const void* num_data, long long nd_stride,
                   const void* num_bin, const void* missing,
                   const void* fmask, long long fmask_stride,
                   const void* cols, int C, int K, int F, int B, float l1,
                   float l2, float l2m, float mds, int use_mds,
                   float min_data, float min_hess, float min_gain_to_split,
                   float cat_smooth, int max_cat_threshold,
                   int max_cat_to_onehot, float min_data_per_group,
                   void* gain, void* thr, void* dleft, void* lsg, void* lsh,
                   void* lc, void* rsg, void* rsh, void* rc, void* lo,
                   void* ro, void* bits, void* stream) {
  if (B < 1 || B > kMaxBins || K < 1 || F < 1 || C < 1)
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
  a.fmask = static_cast<const uint8_t*>(fmask);
  a.fmask_stride = fmask_stride;
  a.cols = static_cast<const int32_t*>(cols);
  a.C = C;
  a.K = K;
  a.F = F;
  a.B = B;
  int P = 1;
  while (P < B) P <<= 1;
  a.P = P;
  a.W = (B + 31) / 32;
  a.min_gain_to_split = min_gain_to_split;
  a.cat_smooth = cat_smooth;
  a.min_data_per_group = min_data_per_group;
  a.max_cat_threshold = max_cat_threshold;
  a.max_cat_to_onehot = max_cat_to_onehot;
  a.gain = static_cast<float*>(gain);
  a.thr = static_cast<int32_t*>(thr);
  a.dleft = static_cast<uint8_t*>(dleft);
  a.lsg = static_cast<float*>(lsg);
  a.lsh = static_cast<float*>(lsh);
  a.lc = static_cast<float*>(lc);
  a.rsg = static_cast<float*>(rsg);
  a.rsh = static_cast<float*>(rsh);
  a.rc = static_cast<float*>(rc);
  a.lo = static_cast<float*>(lo);
  a.ro = static_cast<float*>(ro);
  a.bits = static_cast<int32_t*>(bits);
  scan::Params p{l1, l2, mds, use_mds, min_data, min_hess};
  scan::Params pm{l1, l2m, mds, use_mds, min_data, min_hess};
  const size_t smem = (size_t)P * sizeof(unsigned long long) +
                      (size_t)B * 3 * sizeof(float) +
                      (size_t)kMaxWords * sizeof(uint32_t);
  const long long blocks = (long long)K * C;
  split_cat<<<(unsigned)blocks, 32, smem,
              static_cast<cudaStream_t>(stream)>>>(a, p, pm);
  return (int)cudaGetLastError();
}

}  // extern "C"
