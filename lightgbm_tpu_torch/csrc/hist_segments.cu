// Per-member segment histograms for the frontier-wave learner, written for
// Hopper (sm_90a).
//
// Replaces the TPU kernel lightgbm_tpu/ops/hist_pallas.py:
// build_histogram_segments (_hist_kernel_segment), which walks a
// scalar-prefetched chunk list of row blocks and expands bin codes into
// one-hot MXU matrices.  For every wave member m it computes, in true float32:
//
//   out[m, 4*k + s, b, c] = sum over r in [start[m], start[m] + cnt[m])
//                           with lid[r] == leaf[m] of
//                           [byte_s(words[k, r]) == b] * w[c, r]
//
//   words : (Fw, N) int32 packed bin codes, contiguous
//   w     : (3, N) float32 (g*bag, h*bag, bag), contiguous
//   lid   : (N,) int32 node-slot id per row
//   start, cnt, leaf : (K,) int32 per member (device arrays: the learner does
//           not read the windows back to the host)
//   out   : (K, 4*Fw, nbins, 3) float32; codes >= nbins are dropped
//   quant : the quantized-gradient mode, as in hist_packed.cu: channel 2
//           accumulates lane 1 (h), not lane 2 (bag)
//
// Member ranges may start at any row and may overlap (frozen members share
// their parent's span and are told apart by their leaf id).
//
// Design.  It is csrc/hist_packed.cu with a member axis.  Pass 1 runs a
// (Fw, K, nchunks) grid: block (k, m, ch) reads word lane k over rows
// [start[m] + ch*chunk, ...) of member m, 32 consecutive rows per warp step,
// so the word and weight loads are coalesced.  A row counts only if its lid
// is the member's leaf.  Each warp owns a private shared-memory histogram;
// lanes holding the same bin are grouped with __match_any_sync and the
// group's leader sums the group in lane order.  The warps' copies are summed
// in warp order into the block's partial.  Blocks whose chunk lies past the
// member's count exit at once: the grid is sized from the largest member
// window the host knows (the parent windows it read at the start of the
// wave), the exact counts live on the device.  Pass 2 sums, for every member,
// the partials of the chunks its count covers, in chunk order.  The launch
// geometry depends only on (Fw, K, the largest window), so every sum has a
// fixed order and two launches on the same input are bitwise equal.
//
// Bound.  The function must read lid once for every row of the union of the
// member ranges (4 bytes), the words and weights once for every row that
// matches its member's leaf (Fw*4 + 3*4 bytes), and write the output
// K * 4*Fw * nbins * 3 * 4 bytes, at 3.35 TB/s.  (sum_m cnt[m] rows would
// count a shared frozen span once per member.)  As in hist_packed, the per-row match, the leader's group sums
// and the shared-memory read-modify-writes are the likelier limit, and late
// waves of many small members pay the fixed per-block cost of clearing and
// reducing 8 warp histograms.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kStage = 32 * 3;  // one warp step's (g, h, c) per lane

__global__ void __launch_bounds__(kThreads)
hist_segments_partial(const int32_t* __restrict__ words,
                      const float* __restrict__ w,
                      const int32_t* __restrict__ lid, long long n,
                      const int32_t* __restrict__ start,
                      const int32_t* __restrict__ cnt,
                      const int32_t* __restrict__ leaf, int chunk, int nbins,
                      int quant, float* __restrict__ partial) {
  const int k = blockIdx.x;
  const int m = blockIdx.y;
  const int ch = blockIdx.z;
  const long long c_m = cnt[m];
  const long long off = (long long)ch * chunk;
  if (off >= c_m) return;  // past this member's window: no partial
  extern __shared__ float smem[];
  const int E = 4 * nbins * 3;
  float* hist = smem;                      // kWarps * E
  float* stage = smem + kWarps * E;        // kWarps * kStage
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  for (int i = threadIdx.x; i < kWarps * E; i += kThreads) hist[i] = 0.0f;
  __syncthreads();

  float* mine = hist + warp * E;
  float* st = stage + warp * kStage;
  const int32_t* lane_words = words + (long long)k * n;
  const float* wg = w;
  const float* wh = w + n;
  const float* wc = quant ? wh : w + 2 * n;
  const int32_t my_leaf = leaf[m];
  const long long r0 = (long long)start[m] + off;
  long long r1 = (long long)start[m] + c_m;
  if (r1 > r0 + chunk) r1 = r0 + chunk;
  if (r1 > n) r1 = n;

  for (long long base = r0 + warp * 32; base < r1; base += kThreads) {
    const long long r = base + lane;
    const bool valid = r < r1 && r >= 0;
    uint32_t word = 0u;
    float g = 0.0f, h = 0.0f, c = 0.0f;
    bool in_leaf = false;
    if (valid) {
      in_leaf = lid[r] == my_leaf;
      if (in_leaf) {
        word = static_cast<uint32_t>(lane_words[r]);
        g = wg[r];
        h = wh[r];
        c = wc[r];
      }
    }
    const bool active = in_leaf && (g != 0.0f || h != 0.0f || c != 0.0f);
    st[lane * 3 + 0] = g;
    st[lane * 3 + 1] = h;
    st[lane * 3 + 2] = c;
    __syncwarp();
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const uint32_t code = (word >> (8 * s)) & 0xFFu;
      const uint32_t key = active ? code : 0xFFFFFFFFu;
      const uint32_t group = __match_any_sync(0xFFFFFFFFu, key);
      const int leader = __ffs(group) - 1;
      if (active && lane == leader && code < static_cast<uint32_t>(nbins)) {
        float sg = 0.0f, sh = 0.0f, sc = 0.0f;
        uint32_t mm = group;
        while (mm) {
          const int j = __ffs(mm) - 1;
          mm &= mm - 1;
          sg += st[j * 3 + 0];
          sh += st[j * 3 + 1];
          sc += st[j * 3 + 2];
        }
        float* dst = mine + (s * nbins + static_cast<int>(code)) * 3;
        dst[0] += sg;
        dst[1] += sh;
        dst[2] += sc;
      }
    }
    __syncwarp();
  }
  __syncthreads();

  float* out = partial +
      (((long long)k * gridDim.y + m) * gridDim.z + ch) * (long long)E;
  for (int e = threadIdx.x; e < E; e += kThreads) {
    float v = 0.0f;
    for (int q = 0; q < kWarps; ++q) v += hist[q * E + e];
    out[e] = v;
  }
}

// out[m, k, e] = sum over the chunks q < ceil(cnt[m] / chunk) of
// partial[k, m, q, e], in chunk order.
__global__ void hist_segments_reduce(const float* __restrict__ partial,
                                     const int32_t* __restrict__ cnt, int fw,
                                     int kmem, int nchunks, int chunk, int E,
                                     float* __restrict__ out) {
  const long long total = (long long)kmem * fw * E;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const long long m = i / ((long long)fw * E);
  const long long rem = i - m * fw * E;
  const long long k = rem / E;
  const long long e = rem - k * E;
  const long long c_m = cnt[m];
  long long used = c_m <= 0 ? 0 : (c_m + chunk - 1) / chunk;
  if (used > nchunks) used = nchunks;
  const float* p = partial + ((k * kmem + m) * nchunks) * (long long)E + e;
  float v = 0.0f;
  for (long long q = 0; q < used; ++q) v += p[q * E];
  out[i] = v;
}

long long smem_bytes(int nbins) {
  return (long long)(kWarps * 4 * nbins * 3 + kWarps * kStage) * sizeof(float);
}

}  // namespace

extern "C" {

// Launch both passes on `stream`.  `partial` holds Fw * K * nchunks *
// 4*nbins*3 floats of scratch, `out` K * 4*Fw * nbins * 3 floats.  Returns
// cudaGetLastError() after the launches (0 = both launched).
int lgbt_hist_segments(const void* words, const void* w, const void* lid,
                       long long n, int fw, const void* start, const void* cnt,
                       const void* leaf, int kmem, int nbins, int quant,
                       int nchunks, int chunk, void* partial, void* out,
                       void* stream) {
  const long long smem = smem_bytes(nbins);
  cudaError_t err = cudaFuncSetAttribute(
      hist_segments_partial, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  hist_segments_partial<<<dim3(fw, kmem, nchunks), kThreads, smem, st>>>(
      static_cast<const int32_t*>(words), static_cast<const float*>(w),
      static_cast<const int32_t*>(lid), n, static_cast<const int32_t*>(start),
      static_cast<const int32_t*>(cnt), static_cast<const int32_t*>(leaf),
      chunk, nbins, quant, static_cast<float*>(partial));
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int E = 4 * nbins * 3;
  const long long total = (long long)kmem * fw * E;
  const int threads = 256;
  const long long blocks = (total + threads - 1) / threads;
  hist_segments_reduce<<<(unsigned)blocks, threads, 0, st>>>(
      static_cast<const float*>(partial), static_cast<const int32_t*>(cnt), fw,
      kmem, nchunks, chunk, E, static_cast<float*>(out));
  return (int)cudaGetLastError();
}

}  // extern "C"
