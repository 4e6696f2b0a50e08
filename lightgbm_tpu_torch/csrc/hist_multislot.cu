// Per-slot histograms over the full row axis in one pass, for the wave
// learner's level-wise opening, written for Hopper (sm_90a).
//
// Replaces the TPU kernel lightgbm_tpu/ops/hist_pallas.py:
// build_histogram_multislot (_hist_kernel_multislot), which shares one bin
// one-hot per row block across K slots and routes rows to slots through a
// (K, rows) slot one-hot in the MXU's weight operand.  It computes, in true
// float32:
//
//   out[j, 4*k + s, b, c] = sum over r with slot[r] == j of
//                           [byte_s(words[k, r]) == b] * w[c, r]
//
//   words : (Fw, N) int32 packed bin codes, contiguous
//   w     : (3, N) float32 (g*bag, h*bag, bag), contiguous
//   slot  : (N,) int32 output slot per row; a slot outside [0, K)
//           contributes nowhere
//   out   : (K, 4*Fw, nbins, 3) float32; codes >= nbins are dropped
//   quant : the quantized-gradient mode, as in hist_packed.cu: channel 2
//           accumulates lane 1 (h), not lane 2 (bag)
//
// Design.  It is csrc/hist_segments.cu's privatized histogram with a slot per
// row in place of a window per member.  Pass 1 runs a (Fw, G, nchunks) grid:
// block (k, g, ch) reads word lane k over a chunk of rows and builds the
// histograms of slot group g (at most kGroup = 16 slots; one slot of one word
// is 4 * nbins * 3 floats, 12,240 bytes at 255 bins, so 16 slots take
// 195,840 bytes of shared memory, and K = 64 slots need four groups, each
// block skipping the rows of the other groups).  A histogram is written by
// one warp only, so no atomics are needed and every sum has a fixed order:
//   * with 8 or more slots in the group, warp q owns slots q and q + 8 and
//     scans the slot of every row of the chunk;
//   * with fewer slots (the first opening levels: 1, 2, 4 members), each
//     slot gets 8 / slots warps, each with a private copy over every
//     (8 / slots)-th 32-row step, and the copies are summed in warp order.
// A warp's scan is cheap: four 32-row steps of slots loaded at once, a
// ballot of the rows that are its own, their offsets appended to a per-warp
// queue in shared memory in scan order.  Each time the queue holds 32 rows
// the warp loads their words and weights (one row per lane, all lanes busy)
// and groups them by (slot, bin) with __match_any_sync; the group's leader
// sums the group's weights in lane order.  So each row's words and weights
// are read once per block, whatever share of the rows the warp owns.  The
// block's per-slot partials are summed in pass 2 over the chunks, in chunk
// order.  The launch geometry depends only on (Fw, K, N), so two launches on
// the same input are bitwise equal.
//
// Bound.  The function must read the words, the weights and the slot of
// every row once (Fw*4 + 3*4 + 4 bytes a row) and write K * 4*Fw * nbins * 3
// * 4 bytes: at the bench width (Fw = 8, N = 1,000,448) and K = 16 that is
// 49.6 MB, about 14.8 us at 3.35 TB/s.  As in the other histogram kernels,
// the per-row match, the leaders' group sums and the shared-memory
// read-modify-writes are the likelier limit; here also the 8-fold scan of
// each row's slot by the warps of a block (from L1), the scattered loads of
// a queue's rows, a single block per SM (the 16-slot histograms fill its
// shared memory), and clearing and reducing 16 histograms per block.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kStage = 32 * 3;  // one batch's (g, h, c) per lane
constexpr int kGroup = 16;      // slots per block group
constexpr int kQueue = 64;      // a warp's pending rows (< 32 + one step)
constexpr int kUnroll = 4;      // 32-row steps whose slots load together
constexpr unsigned kFull = 0xFFFFFFFFu;

// Histogram copies a block keeps for `kg` slots (see the header).
__host__ __device__ inline int copies_for(int kg) {
  return kg >= kWarps ? kg : (kWarps / kg) * kg;
}

// One batch of a warp's queue: lanes below `cnt` hold a row (its offset
// from the chunk's first row in qo, its slot within the warp's own in qj).
// Adds the rows' weights into the histograms, grouped by (slot, bin).
__device__ __forceinline__ void flush_batch(
    const int* qo, const int* qj, int cnt, int lane, long long r0,
    const int32_t* __restrict__ lane_words, const float* __restrict__ wg,
    const float* __restrict__ wh, const float* __restrict__ wc, float* st,
    float* hist, int E, int nbins, bool wide, int warp) {
  const bool valid = lane < cnt;
  uint32_t word = 0u;
  float gv = 0.0f, hv = 0.0f, cv = 0.0f;
  int jl = 0;
  if (valid) {
    const long long r = r0 + qo[lane];
    jl = qj[lane];
    word = static_cast<uint32_t>(lane_words[r]);
    gv = wg[r];
    hv = wh[r];
    cv = wc[r];
  }
  const bool active = valid && (gv != 0.0f || hv != 0.0f || cv != 0.0f);
  st[lane * 3 + 0] = gv;
  st[lane * 3 + 1] = hv;
  st[lane * 3 + 2] = cv;
  __syncwarp();
  // wide groups: local slot jl * 8 + warp has its own copy; narrow groups:
  // the warp's private copy
  float* copy = hist + (long long)(wide ? jl * kWarps + warp : warp) * E;
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    const uint32_t code = (word >> (8 * s)) & 0xFFu;
    const uint32_t key =
        active ? ((static_cast<uint32_t>(jl) << 8) | code) : kFull;
    const uint32_t grp = __match_any_sync(kFull, key);
    const int leader = __ffs(grp) - 1;
    if (active && lane == leader && code < static_cast<uint32_t>(nbins)) {
      float sg = 0.0f, sh = 0.0f, sc = 0.0f;
      uint32_t mm = grp;
      while (mm) {
        const int q = __ffs(mm) - 1;
        mm &= mm - 1;
        sg += st[q * 3 + 0];
        sh += st[q * 3 + 1];
        sc += st[q * 3 + 2];
      }
      float* dst = copy + (s * nbins + static_cast<int>(code)) * 3;
      dst[0] += sg;
      dst[1] += sh;
      dst[2] += sc;
    }
  }
  __syncwarp();
}

__global__ void __launch_bounds__(kThreads)
hist_multislot_partial(const int32_t* __restrict__ words,
                       const float* __restrict__ w,
                       const int32_t* __restrict__ slot, long long n,
                       int kslots, int chunk, int nbins, int quant,
                       float* __restrict__ partial) {
  const int k = blockIdx.x;
  const int g = blockIdx.y;
  const int ch = blockIdx.z;
  const int slot0 = g * kGroup;
  const int kg = min(kGroup, kslots - slot0);
  const bool wide = kg >= kWarps;
  const int rep = wide ? 1 : kWarps / kg;  // warps per slot
  const int copies = copies_for(kg);
  extern __shared__ float smem[];
  const int E = 4 * nbins * 3;
  float* hist = smem;                                  // copies * E
  float* stage = smem + copies * E;                    // kWarps * kStage
  int* queue = reinterpret_cast<int*>(stage + kWarps * kStage);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  for (int i = threadIdx.x; i < copies * E; i += kThreads) hist[i] = 0.0f;
  __syncthreads();

  // this warp's slots and row steps: wide groups give warp q the local
  // slots q and q + 8 over every step; narrow groups give it slot q % kg
  // over the steps s with s % rep == q / kg
  const bool working = wide || warp < copies;
  const int my_slot = wide ? warp : warp % kg;
  const int phase = wide ? 0 : warp / kg;
  float* st = stage + warp * kStage;
  int* qo = queue + warp * 2 * kQueue;   // row offsets from r0
  int* qj = qo + kQueue;                 // slot within the warp's own
  const int32_t* lane_words = words + (long long)k * n;
  const float* wg = w;
  const float* wh = w + n;
  const float* wc = quant ? wh : w + 2 * n;
  const long long r0 = (long long)ch * chunk;
  long long r1 = r0 + chunk;
  if (r1 > n) r1 = n;
  const long long step = 32LL * rep;

  if (working) {
    int count = 0;  // rows in the queue (warp-uniform)
    for (long long base = r0 + (long long)phase * 32; base < r1;
         base += kUnroll * step) {
      int jv[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const long long r = base + u * step + lane;
        jv[u] = r < r1 ? slot[r] - slot0 : -1;
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int j = jv[u];
        const bool mine =
            j >= 0 && j < kg &&
            (wide ? (j & (kWarps - 1)) == my_slot : j == my_slot);
        const uint32_t bal = __ballot_sync(kFull, mine);
        if (mine) {
          const int pos = count + __popc(bal & ((1u << lane) - 1u));
          qo[pos] = static_cast<int>(base + u * step + lane - r0);
          qj[pos] = wide ? (j >> 3) : 0;
        }
        count += __popc(bal);
        if (count >= 32) {
          __syncwarp();
          flush_batch(qo, qj, 32, lane, r0, lane_words, wg, wh, wc, st, hist,
                      E, nbins, wide, warp);
          // move the rest of the queue to its front
          const int rest = count - 32;
          int vo = 0, vj = 0;
          if (lane < rest) {
            vo = qo[32 + lane];
            vj = qj[32 + lane];
          }
          __syncwarp();
          if (lane < rest) {
            qo[lane] = vo;
            qj[lane] = vj;
          }
          __syncwarp();
          count = rest;
        }
      }
    }
    if (count > 0) {
      __syncwarp();
      flush_batch(qo, qj, count, lane, r0, lane_words, wg, wh, wc, st, hist,
                  E, nbins, wide, warp);
    }
  }
  __syncthreads();

  // partial[k, slot0 + j, ch, e]: the slot's copies summed in warp order
  for (int i = threadIdx.x; i < kg * E; i += kThreads) {
    const int j = i / E;
    const int e = i - j * E;
    float v;
    if (wide) {
      v = hist[(long long)j * E + e];
    } else {
      v = 0.0f;
      for (int p = 0; p < rep; ++p) v += hist[(long long)(p * kg + j) * E + e];
    }
    partial[(((long long)k * kslots + slot0 + j) * gridDim.z + ch) *
                (long long)E + e] = v;
  }
}

// out[j, k, e] = sum over chunks q of partial[k, j, q, e], in chunk order.
__global__ void hist_multislot_reduce(const float* __restrict__ partial,
                                      int fw, int kslots, int nchunks, int E,
                                      float* __restrict__ out) {
  const long long total = (long long)kslots * fw * E;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const long long j = i / ((long long)fw * E);
  const long long rem = i - j * fw * E;
  const long long k = rem / E;
  const long long e = rem - k * E;
  const float* p = partial + ((k * kslots + j) * nchunks) * (long long)E + e;
  float v = 0.0f;
  for (int q = 0; q < nchunks; ++q) v += p[(long long)q * E];
  out[i] = v;
}

// Shared memory pass 1 needs for K slots of `nbins` bins, in bytes.
long long smem_bytes(int kslots, int nbins) {
  const int kg = kslots < kGroup ? kslots : kGroup;
  return (long long)(copies_for(kg) * 4 * nbins * 3 + kWarps * kStage) *
             (long long)sizeof(float) +
         (long long)kWarps * 2 * kQueue * (long long)sizeof(int);
}

}  // namespace

extern "C" {

// Launch both passes on `stream`.  `partial` holds Fw * K * nchunks *
// 4*nbins*3 floats of scratch, `out` K * 4*Fw * nbins * 3 floats.  Returns
// cudaGetLastError() after the launches (0 = both launched).
int lgbt_hist_multislot(const void* words, const void* w, const void* slot,
                        long long n, int fw, int kslots, int nbins, int quant,
                        int nchunks, int chunk, void* partial, void* out,
                        void* stream) {
  if (kslots < 1 || nbins < 1 || nbins > 256) return (int)cudaErrorInvalidValue;
  const long long smem = smem_bytes(kslots, nbins);
  cudaError_t err = cudaFuncSetAttribute(
      hist_multislot_partial, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int groups = (kslots + kGroup - 1) / kGroup;
  hist_multislot_partial<<<dim3(fw, groups, nchunks), kThreads, smem, st>>>(
      static_cast<const int32_t*>(words), static_cast<const float*>(w),
      static_cast<const int32_t*>(slot), n, kslots, chunk, nbins, quant,
      static_cast<float*>(partial));
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int E = 4 * nbins * 3;
  const long long total = (long long)kslots * fw * E;
  const int threads = 256;
  const long long blocks = (total + threads - 1) / threads;
  hist_multislot_reduce<<<(unsigned)blocks, threads, 0, st>>>(
      static_cast<const float*>(partial), fw, kslots, nchunks, E,
      static_cast<float*>(out));
  return (int)cudaGetLastError();
}

}  // extern "C"
