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
//     t = min(max_cat_threshold, (used + 1) / 2) categories with the
//     min_data_per_group bookkeeping, lambda_l2 + cat_l2; the backward
//     direction only on strictly greater gain;
//   * where the call passes them (monotone constraints, feature_contri
//     penalties), the leaf's value bounds (K,) clip every leaf output the
//     gains are formed from and the written outputs, and the feature's
//     penalty (F,) multiplies the written post-shift gain.  A call without
//     them reads bounds of -inf and +inf and a penalty of 1, which change
//     no bit (scan::clip keeps the value, x * 1 is x).
//
// Every field is computed with the plain version's operations in its order
// (_rn intrinsics, scan_common.cuh's leaf output and gain), so it equals
// ops/split_cat.py on the CPU bit for bit.
//
// Design.  A block per (k, c), 64 to 512 threads by the width (half the
// next power of two of B), the grid covering only the categorical columns
// (the learner lists them once); the numerical columns' fields come from
// split_scan.cu, launched before this kernel on the same fields.  B is a
// row stride: only the column's own used bins (< num_bin) are read, and
// bins up to 65,536 fit the sort key.  The sorted order falls into three
// runs: the eligible bins of finite (or -inf) CTR by (CTR, bin), then the
// bins at +inf (the ineligible ones, the eligible of CTR +inf and every bin
// past the used ones) by bin, then the eligible NaN ones by bin.  Only the
// first run needs sorting, and the scans read only its t smallest and its
// t largest entries: the block collects that run's 48-bit keys (the CTR's
// order-preserving bits, the bin) into shared memory (a warp's ballot
// places its keys) and sorts them: up to 64 by their ranks, more by a
// bitonic sort whose keys stay in registers (shuffles within a warp, shared
// memory across warps); a run longer than the buffer (8,192 keys) is
// cut to its t smallest and t largest between rounds.  The other two runs
// are placed by an ordered compaction, run only where such bins exist.
// The scans: per direction, three lanes form the g, h and count prefix
// sums of the t positions side by side in the plain version's order, one
// lane runs the group count's resets and the stop over them, then a warp
// per direction evaluates every position's leaf outputs and gain in
// parallel and takes the first maximum.  One-vs-other: a thread per bin, a
// block-wide argmax.  The members' bits are set with shared-memory atomics
// and written by the block.  No torch op around the launch.
//
// Bound.  The function must read the categorical columns' histograms once,
// K * C * B * 3 * 4 bytes, and the leaf totals, and write the eleven fields
// and W words of each (k, c); at K = 128, C = 6, B = 256 that is about 2.4
// MB, 0.7 us at 3.35 TB/s.  What limits it is latency: per block the
// histogram's load, the sort (a rank loop over up to 64 keys, or a bitonic
// sort's log2(P) * (log2(P) + 1) / 2 stages, the cross-warp ones behind
// barriers) and the group count's chain over the t positions.

#include "scan_common.cuh"

#include <limits.h>

namespace {

typedef unsigned long long u64;

constexpr int kMaxThreads = 512;
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr unsigned kBinMask = 0xFFFFu;  // bins fit the key's low 16 bits
constexpr u64 kPad = ~0ull;             // after every key

struct Args {
  const float* hist;
  const float *sum_g, *sum_h, *num_data;
  long long sg_stride, sh_stride, nd_stride;
  const int32_t *num_bin, *missing;
  const uint8_t* fmask;
  long long fmask_stride;  // 0 for an (F,) mask, F for (K, F)
  const int32_t* cols;
  int C, K, F, B, W;
  int cap;   // keys the sort buffer holds (a power of two)
  int tcap;  // scan positions a direction holds
  float min_gain_to_split, cat_smooth, min_data_per_group;
  int max_cat_threshold, max_cat_to_onehot;
  // (K,) leaf value bounds and (F,) penalty, each null where the call has
  // none
  const float *min_c, *max_c;
  long long mn_stride, mx_stride;
  const float* penalty;
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

// A bin's class in the sorted order: 0 eligible of finite or -inf CTR (the
// sorted run), 1 at +inf, 2 eligible of NaN CTR; its CTR in `ctr`.
__device__ __forceinline__ int bin_class(const float* hs, int q, int U,
                                         float cat_smooth, float& ctr) {
  ctr = 0.0f;
  if (q >= U || !(hs[q * 3 + 2] >= cat_smooth)) return 1;
  // + 0.0 turns -0.0 into 0.0
  ctr = __fadd_rn(__fdiv_rn(hs[q * 3], __fadd_rn(hs[q * 3 + 1], cat_smooth)),
                  0.0f);
  if (isnan(ctr)) return 2;
  return ctr == INFINITY ? 1 : 0;
}

// Bitonic sort of buf[0, P) ascending, P = E * blockDim.x, the E keys of
// thread t (indices t * E ..) in registers: exchanges inside a thread,
// across a warp's lanes by shuffles, and across warps through shared memory
// (two barriers each), so most of the log2(P) * (log2(P) + 1) / 2 stages
// take no barrier.  Every thread calls it.
template <int E>
__device__ void bitonic_regs(u64* buf, int P) {
  const int t = threadIdx.x;
  u64 x[E];
#pragma unroll
  for (int e = 0; e < E; ++e) x[e] = buf[t * E + e];
  for (int size = 2; size <= P; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      if (stride < E) {
        // s runs over the compile-time strides, so x stays in registers
#pragma unroll
        for (int s = E / 2; s > 0; s >>= 1) {
          if (s != stride) continue;
#pragma unroll
          for (int e = 0; e < E; ++e) {
            if ((e & s) == 0) {
              const bool asc = ((t * E + e) & size) == 0;
              const u64 u = x[e], v = x[e + s];
              if ((u > v) == asc) {
                x[e] = v;
                x[e + s] = u;
              }
            }
          }
        }
      } else if (stride < 32 * E) {
        const bool lower = (t & (stride / E)) == 0;
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const u64 y = __shfl_xor_sync(scan::kFull, x[e], stride / E);
          const bool asc = ((t * E + e) & size) == 0;
          x[e] = (lower == asc) ? min(x[e], y) : max(x[e], y);
        }
      } else {
#pragma unroll
        for (int e = 0; e < E; ++e) buf[t * E + e] = x[e];
        __syncthreads();
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const int i = t * E + e;
          const u64 y = buf[i ^ stride];
          const bool asc = (i & size) == 0;
          x[e] = (((i & stride) == 0) == asc) ? min(x[e], y) : max(x[e], y);
        }
        __syncthreads();
      }
    }
  }
#pragma unroll
  for (int e = 0; e < E; ++e) buf[t * E + e] = x[e];
  __syncthreads();
}

// Sort buf[0, n) ascending (the keys are distinct): up to 64 keys by each
// one's rank, more by a bitonic sort of max(P, blockDim.x) keys, P the next
// power of two of n (padded with kPad; up to 4 a thread in registers, more
// through shared memory; n <= the buffer's cap), then, past 2 * keep keys,
// only the keep smallest and keep largest kept (in order, at [0, 2 *
// keep)).  Every thread calls it; returns the count.
__device__ int sort_keep(u64* buf, int n, int keep) {
  const int T = blockDim.x, tid = threadIdx.x;
  if (n <= 64) {
    u64 v = 0ull;
    int r = 0;
    if (tid < n) {
      v = buf[tid];
      for (int y = 0; y < n; ++y) r += buf[y] < v ? 1 : 0;
    }
    __syncthreads();
    if (tid < n) buf[r] = v;
    __syncthreads();
    return n;
  }
  int P = T;
  while (P < n) P <<= 1;
  for (int i = n + tid; i < P; i += T) buf[i] = kPad;
  __syncthreads();
  if (P == T) {
    bitonic_regs<1>(buf, P);
  } else if (P == 2 * T) {
    bitonic_regs<2>(buf, P);
  } else if (P == 4 * T) {
    bitonic_regs<4>(buf, P);
  } else {
    // past 2,048 keys (a column wider than the block's registers hold):
    // every stage through shared memory
    for (int size = 2; size <= P; size <<= 1) {
      for (int stride = size >> 1; stride > 0; stride >>= 1) {
        for (int s = tid; s < (P >> 1); s += T) {
          const int i = ((s & ~(stride - 1)) << 1) | (s & (stride - 1));
          const int j = i + stride;
          const u64 x = buf[i], y = buf[j];
          if ((x > y) == ((i & size) == 0)) {
            buf[i] = y;
            buf[j] = x;
          }
        }
        __syncthreads();
      }
    }
  }
  if (n <= 2 * keep) return n;
  // the top keep to [keep, 2 keep), a chunk at a time (each chunk's source
  // lies past what earlier chunks wrote)
  for (int base = 0; base < keep; base += T) {
    const int i = base + tid;
    const u64 v = i < keep ? buf[n - keep + i] : 0ull;
    __syncthreads();
    if (i < keep) buf[keep + i] = v;
    __syncthreads();
  }
  return 2 * keep;
}

// Ordered compaction of the bins below U of class 1 and 2: fn(position in
// the sorted order, bin) for each.  Class 1 bins below U come first in
// their run (the bins past U follow them), class 2 fill the last nN
// positions of the B.
template <class Fn>
__device__ void place_runs(const float* hs, int U, int B, int nF, int nN,
                           float cat_smooth, int* s_w1, int* s_w2, Fn fn) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nw = blockDim.x >> 5;
  const unsigned lt = (1u << lane) - 1u;
  int b1 = 0, b2 = 0;
  for (int base = 0; base < U; base += blockDim.x) {
    const int q = base + tid;
    float ctr;
    const int cls = q < U ? bin_class(hs, q, U, cat_smooth, ctr) : 0;
    const unsigned m1 = __ballot_sync(scan::kFull, cls == 1);
    const unsigned m2 = __ballot_sync(scan::kFull, cls == 2);
    if (lane == 0) {
      s_w1[warp] = __popc(m1);
      s_w2[warp] = __popc(m2);
    }
    __syncthreads();
    int o1 = b1, o2 = b2, t1 = 0, t2 = 0;
    for (int w = 0; w < nw; ++w) {
      if (w < warp) {
        o1 += s_w1[w];
        o2 += s_w2[w];
      }
      t1 += s_w1[w];
      t2 += s_w2[w];
    }
    if (cls == 1) fn(nF + o1 + __popc(m1 & lt), q);
    if (cls == 2) fn(B - nN + o2 + __popc(m2 & lt), q);
    b1 += t1;
    b2 += t2;
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kMaxThreads)
split_cat(Args a, scan::Params p, scan::Params pm) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_cnt, s_used, s_nn, s_ni;
  __shared__ int s_neff[2], s_w1[kMaxWarps], s_w2[kMaxWarps];
  __shared__ float s_g[kMaxWarps], s_dg[2], s_dlg[2], s_dlh[2], s_dlc[2];
  __shared__ int s_i[kMaxWarps], s_di[2];
  const int tid = threadIdx.x, T = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int k = blockIdx.x / a.C;
  const int f = a.cols[blockIdx.x - k * a.C];
  const long long pair = (long long)k * a.F + f;
  const int B = a.B, tc = a.tcap;
  const float* hs = a.hist + pair * B * 3;
  u64* buf = reinterpret_cast<u64*>(smem);                      // cap
  float* sv = reinterpret_cast<float*>(buf + a.cap);   // 2 tc x 3: the
  float* pre = sv + 6 * tc;  // positions' (g, h, c), their prefix sums
  int* sbin = reinterpret_cast<int*>(pre + 6 * tc);             // 2 tc
  uint32_t* words = reinterpret_cast<uint32_t*>(sbin + 2 * tc);  // W
  uint8_t* sce = reinterpret_cast<uint8_t*>(words + a.W);       // 2 tc

  for (int w = tid; w < a.W; w += T) words[w] = 0u;
  if (tid == 0) {
    s_cnt = 0;
    s_used = 0;
    s_nn = 0;
    s_ni = 0;
  }
  const int nb = a.num_bin[f];
  const int used_bin = nb - 1 + (a.missing[f] == scan::kMissingNone ? 1 : 0);
  const int U = max(0, min(used_bin, B));
  const bool masked = a.fmask[k * a.fmask_stride + f] == 0;
  const float tg = a.sum_g[k * a.sg_stride];
  const float th = __fadd_rn(a.sum_h[k * a.sh_stride], 2.0f * scan::kEpsilon);
  const float tn = a.num_data[k * a.nd_stride];
  const float mgs = __fadd_rn(
      scan::gain_given_output(tg, th, scan::leaf_output(tg, th, p), p),
      a.min_gain_to_split);
  const bool onehot = nb <= a.max_cat_to_onehot;
  const float mn = a.min_c != nullptr ? a.min_c[k * a.mn_stride] : -INFINITY;
  const float mx = a.max_c != nullptr ? a.max_c[k * a.mx_stride] : INFINITY;
  __syncthreads();

  float gain, lg, lh, lc;
  int oh_t = 0, mv_i = -1, used = 0, t = 0;
  bool use_bwd = false;
  if (onehot) {
    // a thread per bin (only bins below used_bin can be valid); each
    // keeps its best, ties to its smaller bin
    float bg = -INFINITY;
    int bt = INT_MAX;
    for (int b = tid; b < U; b += T) {
      const float g = hs[b * 3], h = hs[b * 3 + 1], c = hs[b * 3 + 2];
      const float other_g = __fsub_rn(tg, g);
      const float other_h = __fsub_rn(__fsub_rn(th, h), scan::kEpsilon);
      const float other_n = __fsub_rn(tn, c);
      const bool valid = c >= p.min_data && h >= p.min_hess &&
                         other_n >= p.min_data && other_h >= p.min_hess;
      const float h_eps = __fadd_rn(h, scan::kEpsilon);
      const float o_out =
          scan::clip(scan::leaf_output(other_g, other_h, p), mn, mx);
      const float b_out = scan::clip(scan::leaf_output(g, h_eps, p), mn, mx);
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
    if (lane == 0) {
      s_g[warp] = bg;
      s_i[warp] = bt;
    }
    __syncthreads();
    bg = s_g[0];
    bt = s_i[0];
    for (int w = 1; w < (T >> 5); ++w) {
      if (s_g[w] > bg || (s_g[w] == bg && s_i[w] < bt)) {
        bg = s_g[w];
        bt = s_i[w];
      }
    }
    // no valid bin: the plain version's argmax over -inf is bin 0
    oh_t = bt == INT_MAX ? 0 : bt;
    gain = bg;
    lg = hs[oh_t * 3];
    lh = __fadd_rn(hs[oh_t * 3 + 1], scan::kEpsilon);
    lc = hs[oh_t * 3 + 2];
  } else {
    // ---- the first run's keys (cut to its t smallest and t largest
    // between rounds when it outgrows the buffer) and the class counts
    const int keep = a.max_cat_threshold;  // t <= max_cat_threshold
    for (int base = 0; base < U; base += T) {
      const int add = min(T, U - base);
      // every thread reads the count before any warp adds this round's
      // keys to it: a thread that read it after would take the cut branch
      // (and its barriers) alone
      const int n0 = s_cnt;
      __syncthreads();
      if (n0 + add > a.cap) {
        const int n = sort_keep(buf, n0, keep);
        __syncthreads();
        if (tid == 0) s_cnt = n;
        __syncthreads();
      }
      // a warp's ballots place its keys and count its classes
      const int q = base + tid;
      const bool elig = q < U && hs[q * 3 + 2] >= a.cat_smooth;
      float ctr = 0.0f;
      const int cls = elig ? bin_class(hs, q, U, a.cat_smooth, ctr) : -1;
      const unsigned m0 = __ballot_sync(scan::kFull, cls == 0);
      const unsigned m1 = __ballot_sync(scan::kFull, cls == 1);
      const unsigned m2 = __ballot_sync(scan::kFull, cls == 2);
      int at = 0;
      if (lane == 0) {
        if (m0) at = atomicAdd(&s_cnt, __popc(m0));
        if (m0 | m1 | m2) atomicAdd(&s_used, __popc(m0 | m1 | m2));
        if (m1) atomicAdd(&s_ni, __popc(m1));
        if (m2) atomicAdd(&s_nn, __popc(m2));
      }
      at = __shfl_sync(scan::kFull, at, 0);
      if (cls == 0)
        buf[at + __popc(m0 & ((1u << lane) - 1u))] =
            ((u64)ordered(ctr) << 16) | (u64)(unsigned)q;
      __syncthreads();
    }
    const int cnt = sort_keep(buf, s_cnt, INT_MAX / 4);
    used = s_used;
    const int nN = s_nn, nI = s_ni;
    const int nF = used - nN - nI;
    t = min(a.max_cat_threshold, (used + 1) / 2);
    // ---- the bin at each scan position: forward p = i, backward
    // p = used - 1 - i; the first run from the sorted keys (rank r is at
    // r below keep, at cnt - (nF - r) in the kept top)
    const int zU = U - nF - nN;  // run 2 bins below U
    for (int x = tid; x < 2 * t; x += T) {
      const int pos = x < t ? x : used - 1 - (x - t);
      int b = -1;
      if (pos < nF) {
        b = (int)(buf[pos < keep ? pos : cnt - (nF - pos)] & kBinMask);
      } else if (pos >= nF + zU && pos < B - nN) {
        b = U + (pos - nF - zU);  // a bin past the used ones
      }
      sbin[x] = b;
    }
    __syncthreads();
    if (nI + nN > 0) {
      place_runs(hs, U, B, nF, nN, a.cat_smooth, s_w1, s_w2,
                 [&](int pos, int q) {
                   if (pos < t) sbin[pos] = q;
                   if (pos < used && pos >= used - t)
                     sbin[t + used - 1 - pos] = q;
                 });
    }
    for (int x = tid; x < 2 * t; x += T) {
      const int b = sbin[x];
      sv[3 * x] = hs[b * 3];
      sv[3 * x + 1] = hs[b * 3 + 1];
      sv[3 * x + 2] = hs[b * 3 + 2];
    }
    __syncthreads();
    // ---- each direction's prefix sums, in the plain version's order:
    // warp d's lanes 0, 1, 2 run the g, h and count sums of direction d
    // side by side (one __fadd_rn a position each), then its lane 0 runs
    // the group count, the stop and the eligibility, the only chain that
    // needs the others
    if (warp < 2) {
      const float* v = sv + 3 * warp * t;
      float* s3 = pre + 3 * warp * t;
      uint8_t* ce = sce + warp * t;
      if (lane < 3) {
        float acc = lane == 1 ? scan::kEpsilon : 0.0f;
        for (int i = 0; i < t; ++i) {
          acc = __fadd_rn(acc, v[3 * i + lane]);
          s3[3 * i + lane] = acc;
        }
      }
      __syncwarp();
      if (lane == 0) {
        float grp = 0.0f;
        int neff = t;
        for (int i = 0; i < t; ++i) {
          const float slh = s3[3 * i + 1], lcnt = s3[3 * i + 2];
          grp = __fadd_rn(grp, v[3 * i + 2]);
          const float rcnt = __fsub_rn(tn, lcnt);
          const float srh = __fsub_rn(th, slh);
          if (rcnt < pm.min_data || rcnt < a.min_data_per_group ||
              srh < pm.min_hess) {
            neff = i;  // the plain version's `stopped`
            break;
          }
          const bool can = lcnt >= pm.min_data && slh >= pm.min_hess &&
                           grp >= a.min_data_per_group;
          ce[i] = can;
          if (can) grp = 0.0f;
        }
        s_neff[warp] = neff;
      }
    }
    __syncthreads();
    // ---- a warp per direction: every position's gain, the first maximum
    if (warp < 2) {
      const float* v = pre + 3 * warp * t;
      const uint8_t* ce = sce + warp * t;
      float bg = -INFINITY;
      int bi = INT_MAX;
      for (int i = lane; i < s_neff[warp]; i += 32) {
        if (!ce[i]) continue;
        const float slg = v[3 * i], slh = v[3 * i + 1];
        const float rg = __fsub_rn(tg, slg);
        const float srh = __fsub_rn(th, slh);
        const float l_out =
            scan::clip(scan::leaf_output(slg, slh, pm), mn, mx);
        const float r_out =
            scan::clip(scan::leaf_output(rg, srh, pm), mn, mx);
        const float g =
            __fadd_rn(scan::gain_given_output(slg, slh, l_out, pm),
                      scan::gain_given_output(rg, srh, r_out, pm));
        if (g > mgs && g > bg) {
          bg = g;
          bi = i;
        }
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        const float og = __shfl_xor_sync(scan::kFull, bg, o);
        const int oi = __shfl_xor_sync(scan::kFull, bi, o);
        if (og > bg || (og == bg && oi < bi)) {
          bg = og;
          bi = oi;
        }
      }
      if (lane == 0) {
        const bool any = bi != INT_MAX;
        s_dg[warp] = bg;
        s_di[warp] = any ? bi : -1;
        s_dlg[warp] = any ? v[3 * bi] : 0.0f;
        s_dlh[warp] = any ? v[3 * bi + 1] : 0.0f;
        s_dlc[warp] = any ? v[3 * bi + 2] : 0.0f;
      }
    }
    __syncthreads();
    use_bwd = s_dg[1] > s_dg[0];
    const int d = use_bwd ? 1 : 0;
    gain = s_dg[d];
    mv_i = s_di[d];
    lg = s_dlg[d];
    lh = s_dlh[d];
    lc = s_dlc[d];
  }

  // the members' bits (none when the split is invalid)
  const bool invalid = (isinf(gain) && gain < 0.0f) || masked;
  if (!invalid) {
    if (onehot) {
      if (tid == 0) words[oh_t >> 5] |= 1u << (oh_t & 31);
    } else {
      // positions 0..mv_i forward, used-1-mv_i..used-1 backward: the
      // scan's bins x = 0..mv_i of the direction, the eligible ones
      for (int x = tid; x <= mv_i; x += T) {
        const int b = sbin[(use_bwd ? t : 0) + x];
        if (b < U && hs[b * 3 + 2] >= a.cat_smooth)
          atomicOr(&words[b >> 5], 1u << (b & 31));
      }
      // and backward every eligible bin past position used - 1 (CTR +inf
      // or NaN behind ineligible bins)
      if (use_bwd && s_ni + s_nn > 0) {
        const int nN = s_nn, nF = used - s_nn - s_ni;
        place_runs(hs, U, B, nF, nN, a.cat_smooth, s_w1, s_w2,
                   [&](int pos, int q) {
                     if (pos >= used && hs[q * 3 + 2] >= a.cat_smooth)
                       atomicOr(&words[q >> 5], 1u << (q & 31));
                   });
      }
    }
  }
  __syncthreads();
  for (int w = tid; w < a.W; w += T)
    a.bits[pair * a.W + w] = static_cast<int32_t>(words[w]);
  if (tid != 0) return;

  const scan::Params& pe = onehot ? p : pm;
  const float rg = __fsub_rn(tg, lg);
  const float rh = __fsub_rn(th, lh);
  const float rc = __fsub_rn(tn, lc);
  const float pen = a.penalty != nullptr ? a.penalty[f] : 1.0f;
  a.gain[pair] = invalid ? -INFINITY : __fmul_rn(__fsub_rn(gain, mgs), pen);
  a.thr[pair] = 0;
  a.dleft[pair] = 0;
  a.lsg[pair] = lg;
  a.lsh[pair] = __fsub_rn(lh, scan::kEpsilon);
  a.lc[pair] = lc;
  a.rsg[pair] = rg;
  a.rsh[pair] = __fsub_rn(rh, scan::kEpsilon);
  a.rc[pair] = rc;
  a.lo[pair] = scan::clip(scan::leaf_output(lg, lh, pe), mn, mx);
  a.ro[pair] = scan::clip(scan::leaf_output(rg, rh, pe), mn, mx);
}

}  // namespace

extern "C" {

// Launch on `stream`: hist (K, F, B, 3) float32 contiguous; the leaf sums
// sum_g, sum_h (no epsilon), num_data as float32 vectors with element
// strides; per-feature int32 num_bin and missing type; the feature mask as
// bytes with a row stride (0 for one (F,) mask); the C categorical columns
// as int32; the (K, F) contiguous candidate fields (gain, threshold int32,
// default_left bytes, left sums, right sums, outputs) and bits (K, F, W)
// int32, of which the categorical columns are written; the leaf bounds
// min_c, max_c as float32 vectors with element strides and the (F,) float32
// penalty, each null where the call has none.  threads, cap,
// tcap and smem are ops/split_cat.py:split_cat_plan's.  Returns
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
                   const void* min_c, long long mn_stride,
                   const void* max_c, long long mx_stride,
                   const void* penalty, void* gain, void* thr,
                   void* dleft, void* lsg, void* lsh, void* lc, void* rsg, void* rsh, void* rc, void* lo,
                   void* ro, void* bits, int threads, int cap, int tcap,
                   long long smem, void* stream) {
  if (B < 1 || B > (int)kBinMask + 1 || K < 1 || F < 1 || C < 1 ||
      threads < 64 || threads > kMaxThreads || threads % 32 != 0 ||
      cap < 1 || tcap < 1 || max_cat_threshold < 0)
    return (int)cudaErrorInvalidValue;
  static long long raised[64] = {0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (smem > 48 * 1024 && dev < 64 && smem > raised[dev]) {
    err = cudaFuncSetAttribute(split_cat,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    raised[dev] = smem;
  }
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
  a.W = (B + 31) / 32;
  a.cap = cap;
  a.tcap = tcap;
  a.min_gain_to_split = min_gain_to_split;
  a.cat_smooth = cat_smooth;
  a.min_data_per_group = min_data_per_group;
  a.max_cat_threshold = max_cat_threshold;
  a.max_cat_to_onehot = max_cat_to_onehot;
  a.min_c = static_cast<const float*>(min_c);
  a.max_c = static_cast<const float*>(max_c);
  a.mn_stride = mn_stride;
  a.mx_stride = mx_stride;
  a.penalty = static_cast<const float*>(penalty);
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
  const long long blocks = (long long)K * C;
  split_cat<<<(unsigned)blocks, threads, (size_t)smem,
              static_cast<cudaStream_t>(stream)>>>(a, p, pm);
  return (int)cudaGetLastError();
}

}  // extern "C"
