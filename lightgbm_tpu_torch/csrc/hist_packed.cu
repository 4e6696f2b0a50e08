// Packed-word histogram for the compact learner, written for Hopper (sm_90a).
//
// Replaces the TPU kernel lightgbm_tpu/ops/hist_pallas.py:build_histogram_packed
// (_hist_kernel_packed, _radix_word), which expands bin codes into one-hot
// bf16 matrices on the MXU.  It computes, in true float32 for every
// tpu_hist_precision setting (the TPU's "highest" semantics):
//
//   out[4*k + s, b, c] = sum_r [byte_s(words[k, r]) == b] * w[c, r]
//
//   words : (Fw, S) int32, 4 features per word (feature 4k+s in byte s); a
//           window view of the learner's (Fw, N) array: a base pointer at the
//           window's first row plus the row stride N, so no copy is made
//   w     : (3, S) float32 rows (g*bag, h*bag, bag), with its own row stride
//   out   : (4*Fw, nbins, 3) float32; codes >= nbins are dropped
//   quant : the quantized-gradient mode (_expand_terms_quant / _reduce_quant
//           of the TPU kernel): channel 2 accumulates lane 1 (h), not lane
//           2 (bag); the caller rescales it into a count
//
// Design.  Pass 1 runs a (Fw, nchunks) grid: each block reads ONE word lane
// over a chunk of rows, 32 consecutive rows per warp step, so every load of
// the word lane and of the three weight rows is coalesced.  Each warp owns a
// private shared-memory histogram (4 sub-features x nbins x 3 floats, 12 KB at
// 256 bins).  For each sub-feature the lanes holding the same bin are grouped
// with __match_any_sync; the group's leader sums the group's weights from a
// per-warp staging buffer in lane order and adds the sum to the warp's copy.
// Leaders of different groups touch different bins, so no atomics are
// needed.  The warps' copies are then summed in warp order and written as the
// block's partial; pass 2 sums the partials over chunks in chunk order.  The
// launch geometry depends only on (Fw, S), so every sum is taken in a fixed
// order and two launches on the same input are bitwise equal, as on the TPU;
// a float atomicAdd histogram would not be.  Rows whose three weights are all
// zero (masked out of the leaf or the bag) add nothing and are skipped.
//
// Bound.  The function must read Fw*S*4 + 3*S*4 bytes; at the full window of
// the bench width (Fw = 8, S = 1,000,448) that is about 44 MB, about 13 us at
// 3.35 TB/s.  The real limit is more likely the per-row match, the group sums
// and the shared-memory read-modify-writes (a few dozen instructions per row
// and word); skewed bins, where many of a warp's 32 rows share one bin,
// serialise the group sums in the leader.  Loads are 4 bytes per lane so that
// window views at any row offset stay valid; 16-byte loads need aligned views.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kStage = 32 * 3;  // one warp step's (g, h, c) per lane

__global__ void __launch_bounds__(kThreads)
hist_packed_partial(const int32_t* __restrict__ words, long long words_stride,
                    const float* __restrict__ w, long long w_stride, int S,
                    int chunk, int nbins, int quant,
                    float* __restrict__ partial) {
  extern __shared__ float smem[];
  const int E = 4 * nbins * 3;
  float* hist = smem;                      // kWarps * E
  float* stage = smem + kWarps * E;        // kWarps * kStage
  const int k = blockIdx.x;
  const int ch = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  for (int i = threadIdx.x; i < kWarps * E; i += kThreads) hist[i] = 0.0f;
  __syncthreads();

  float* mine = hist + warp * E;
  float* st = stage + warp * kStage;
  const int32_t* lane_words = words + (long long)k * words_stride;
  const float* wg = w;
  const float* wh = w + w_stride;
  const float* wc = quant ? wh : w + 2 * w_stride;
  const int r0 = ch * chunk;
  const int r1 = min(S, r0 + chunk);

  for (int base = r0 + warp * 32; base < r1; base += kThreads) {
    const int r = base + lane;
    const bool valid = r < r1;
    uint32_t word = 0u;
    float g = 0.0f, h = 0.0f, c = 0.0f;
    if (valid) {
      word = static_cast<uint32_t>(lane_words[r]);
      g = wg[r];
      h = wh[r];
      c = wc[r];
    }
    const bool active = valid && (g != 0.0f || h != 0.0f || c != 0.0f);
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
        uint32_t m = group;
        while (m) {
          const int j = __ffs(m) - 1;
          m &= m - 1;
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

  float* out = partial + ((long long)k * gridDim.y + ch) * E;
  for (int e = threadIdx.x; e < E; e += kThreads) {
    float v = 0.0f;
    for (int q = 0; q < kWarps; ++q) v += hist[q * E + e];
    out[e] = v;
  }
}

__global__ void hist_packed_reduce(const float* __restrict__ partial,
                                   int nchunks, int E, long long total,
                                   float* __restrict__ out) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const long long k = i / E;
  const long long e = i - k * E;
  const float* p = partial + k * nchunks * (long long)E + e;
  float v = 0.0f;
  for (int q = 0; q < nchunks; ++q) v += p[(long long)q * E];
  out[i] = v;
}

// Shared memory pass 1 needs for `nbins` bins, in bytes.
long long smem_bytes(int nbins) {
  return (long long)(kWarps * 4 * nbins * 3 + kWarps * kStage) * sizeof(float);
}

}  // namespace

extern "C" {

// Launch both passes on `stream`.  `partial` holds Fw * nchunks * 4*nbins*3
// floats of scratch, `out` 4*Fw*nbins*3 floats.  Returns cudaGetLastError()
// after the launches (0 = both launched).
int lgbt_hist_packed(const void* words, long long words_stride, const void* w,
                     long long w_stride, int fw, int S, int nbins, int quant,
                     int nchunks, int chunk, void* partial, void* out,
                     void* stream) {
  const long long smem = smem_bytes(nbins);
  cudaError_t err = cudaFuncSetAttribute(
      hist_packed_partial, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  hist_packed_partial<<<dim3(fw, nchunks), kThreads, smem, st>>>(
      static_cast<const int32_t*>(words), words_stride,
      static_cast<const float*>(w), w_stride, S, chunk, nbins, quant,
      static_cast<float*>(partial));
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int E = 4 * nbins * 3;
  const long long total = (long long)fw * E;
  const int threads = 256;
  const long long blocks = (total + threads - 1) / threads;
  hist_packed_reduce<<<(unsigned)blocks, threads, 0, st>>>(
      static_cast<const float*>(partial), nchunks, E, total,
      static_cast<float*>(out));
  return (int)cudaGetLastError();
}

}  // extern "C"
