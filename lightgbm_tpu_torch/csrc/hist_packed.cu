// Packed-word histogram for the compact learner and the wave learner's root,
// written for Hopper (sm_90a).
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
// Bound.  The function must read Fw*S*4 + 3*S*4 bytes and write
// 4*Fw*nbins*12; at the full window of the bench width (Fw = 8, S =
// 1,000,448) that is about 44 MB, about 13 us at 3.35 TB/s; at a 65,536-row
// window 2.9 MB, under 1 us.
//
// Design (hist_common.cuh holds the shared pieces):
//
//  * Grid (nchunks, lane groups).  A block takes nl word lanes and gives
//    each of their features its own warp, so a warp bins one byte plane.
//    The host sizes the plan (ops/hist_packed.py: packed_plan): at the full
//    window nl = 4 (16 warps, two lane groups at Fw = 8) and 1,024-row
//    chunks and more, at most one wave of the 132 SMs at three blocks
//    each; a window under 131,072 rows takes one word lane a block (eight
//    lane groups) and up to 64 chunks of at least 256 rows, so it spreads
//    over the card with few chunk partials.
//  * The block copies each 128-row stage's weights and its lanes' words into
//    shared memory with cp.async (4 bytes each, so window views at any row
//    offset stay valid), three stages deep: the weights are read once per
//    row for the block's 4 * nl features.  A 32-row step with no weighted
//    row is not binned.
//  * Binning: one histogram copy per feature (3 KB at 256 bins) and an
//    nbins-word group mask per warp (group_add): 76 KB a block of four
//    lanes at 256 bins, so up to three blocks (48 warps) an SM.  No
//    cross-warp merge.
//  * One block per chunk writes its partial, only the bins it touched, with
//    a bitmap (flush); the second pass (hist_reduce) sums them over chunks
//    in a fixed order.  A single chunk writes the output directly and the
//    second pass is not launched.  No float atomics.
//
// What limits it: the binning's shared-memory traffic (an OR, a read-back
// and a read-modify-write per row and feature: at the full window on an
// H100 about 50 SM cycles per 32-row step of one feature), at small windows
// the block's fixed work (zeroing, the pipeline's first stages, the flush),
// the chunks' partials that the second pass reads back and its launch.
//
// A lane-per-feature layout (a warp bins one row's 32 features, each lane
// its own histogram, no bin-mates to find) was tried and measured slower:
// its per-warp histogram copies (98 KB at 255 bins) leave two binning warps
// an SM, and their row-to-row read-modify-write chain set the pace.

#include "hist_common.cuh"

namespace {

using namespace lgbt_hist;

constexpr int kLanesMax = 4;  // word lanes per block (4 warps each)
constexpr int kRows = 128;    // rows per stage
constexpr int kStages = 3;

size_t smem_bytes(int nl, int nbins) {
  return sizeof(float) * ((size_t)4 * nl * nbins * 4 +
                          (size_t)kStages * kRows * (3 + nl));
}

// Copy stage rows [row0, row0 + n) to the stage at shared address `buf`:
// the three weight lanes (two in quant mode: channel 2 reads lane 1), then
// the block's nl word lanes.
__device__ __forceinline__ void issue(const int32_t* words,
                                      long long words_stride, const float* w,
                                      long long w_stride, int fw, int lane0,
                                      int nl, int quant, int row0, int n,
                                      unsigned buf) {
  const int arrays = 3 + nl;
  for (int e = threadIdx.x; e < arrays * kRows; e += blockDim.x) {
    const int a = e / kRows;
    const int i = e - a * kRows;
    if (i >= n) continue;
    if (a < 3) {
      if (a == 2 && quant) continue;
      cp_async4(buf + 4 * e, w + a * w_stride + row0 + i);
    } else if (lane0 + a - 3 < fw) {
      cp_async4(buf + 4 * e,
                  words + (lane0 + a - 3) * words_stride + row0 + i);
    }
  }
}

__global__ void __launch_bounds__(4 * kLanesMax * 32)
hist_packed_chunks(const int32_t* __restrict__ words, long long words_stride,
                   const float* __restrict__ w, long long w_stride, int fw,
                   int S, int chunk, int nbins, int quant, int nchunks,
                   float* __restrict__ partial, uint32_t* __restrict__ bits,
                   float* __restrict__ out) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int nl = blockDim.x >> 7;  // word lanes of this block
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int lane0 = blockIdx.y * nl;
  const int k = lane0 + (warp >> 2);  // this warp's word lane
  const int s = warp & 3;             // ... and byte plane
  const bool live = k < fw;
  const int ch = blockIdx.x;
  const int nw = 4 * nl;
  float* hist = smem + warp * nbins * 3;
  uint32_t* msk = reinterpret_cast<uint32_t*>(smem + nw * nbins * 3) +
                  warp * nbins;
  float* stages = smem + nw * nbins * 4;
  const unsigned sstages =
      static_cast<unsigned>(__cvta_generic_to_shared(stages));
  const int stage_floats = kRows * (3 + nl);
  for (int e = threadIdx.x; e < nw * nbins * 4; e += blockDim.x)
    smem[e] = 0.0f;  // histograms and group masks

  const int r0 = ch * chunk;
  const int r1 = min(S, r0 + chunk);
  const int nst = (r1 - r0 + kRows - 1) / kRows;
  for (int j = 0; j < kStages - 1; ++j) {
    if (j < nst)
      issue(words, words_stride, w, w_stride, fw, lane0, nl, quant,
            r0 + j * kRows, min(kRows, r1 - r0 - j * kRows),
            sstages + 4 * j * stage_floats);
    cp_async_commit();
  }
  for (int j = 0; j < nst; ++j) {
    const int ja = j + kStages - 1;
    if (ja < nst)
      issue(words, words_stride, w, w_stride, fw, lane0, nl, quant,
            r0 + ja * kRows, min(kRows, r1 - r0 - ja * kRows),
            sstages + 4 * (ja % kStages) * stage_floats);
    cp_async_commit();
    cp_async_wait<kStages - 1>();  // stage j (this thread's copies) landed
    __syncthreads();               // ... and every thread's
    const float* buf = stages + (j % kStages) * stage_floats;
    const float* sg = buf;
    const float* sh = buf + kRows;
    const float* sc = quant ? sh : buf + 2 * kRows;
    const uint32_t* sw =
        reinterpret_cast<const uint32_t*>(buf + (3 + (warp >> 2)) * kRows);
    const int n = min(kRows, r1 - r0 - j * kRows);
    if (live) {
#pragma unroll
      for (int i0 = 0; i0 < kRows; i0 += 32) {
        const int i = i0 + lane;
        bool a = false;
        float g = 0.0f, h = 0.0f, c = 0.0f;
        if (i < n) {
          g = sg[i];
          h = sh[i];
          c = sc[i];
          a = weighted(g, h, c);
        }
        if (__ballot_sync(kFull, a) == 0u) continue;  // warp-uniform
        const uint32_t code = a ? (sw[i] >> (8 * s)) & 0xFFu : 0u;
        const bool in = a && code < static_cast<uint32_t>(nbins);
        group_add(in, static_cast<int>(code), g, h, c, sg, sh, sc, i0, msk,
                  hist);
      }
    }
    __syncthreads();  // the stage is free for the copies of a later stage
  }
  if (!live) return;
  const int f = 4 * k + s;
  const long long slot = (long long)ch * 4 * fw + f;
  if (nchunks == 1)
    flush(hist, nbins, true, out + (long long)f * nbins * 3, nullptr);
  else
    flush(hist, nbins, false, partial + slot * nbins * 3,
          bits + slot * ((nbins + 31) >> 5));
}

}  // namespace

extern "C" {

// Launch on `stream`: the binning pass over (nchunks, ceil(fw / nl)) blocks
// of 4 * nl warps, then, for nchunks > 1, the reduce pass.  `partial` holds
// nchunks * 4*fw * nbins * 3 floats and `bits` nchunks * 4*fw *
// ceil(nbins / 32) words of scratch (unused for one chunk), `out`
// 4*fw * nbins * 3 floats.  Returns cudaGetLastError() after the launches
// (0 = launched), or cudaErrorInvalidValue for arguments outside what the
// kernel takes.
int lgbt_hist_packed(const void* words, long long words_stride, const void* w,
                     long long w_stride, int fw, int S, int nbins, int quant,
                     int nl, int nchunks, int chunk, void* partial,
                     void* bits, void* out, void* stream) {
  static bool raised[64] = {false};
  if (nbins < 1 || nbins > 256 || fw < 1 || S < 1 || nl < 1 ||
      nl > kLanesMax || nchunks < 1 || chunk < 1 || chunk % kRows)
    return (int)cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  if (!raised[dev]) {  // once per device: the largest block this file makes
    err = cudaFuncSetAttribute(hist_packed_chunks,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem_bytes(kLanesMax, 256));
    if (err != cudaSuccess) return (int)err;
    raised[dev] = true;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int groups = (fw + nl - 1) / nl;
  hist_packed_chunks<<<dim3(nchunks, groups), 4 * nl * 32,
                       smem_bytes(nl, nbins), st>>>(
      static_cast<const int32_t*>(words), words_stride,
      static_cast<const float*>(w), w_stride, fw, S, chunk, nbins, quant,
      nchunks, static_cast<float*>(partial), static_cast<uint32_t*>(bits),
      static_cast<float*>(out));
  err = cudaGetLastError();
  if (err != cudaSuccess || nchunks == 1) return (int)err;
  return (int)launch_reduce(static_cast<const float*>(partial),
                            static_cast<const uint32_t*>(bits), nchunks,
                            4 * fw, nbins, static_cast<float*>(out), st);
}

}  // extern "C"
