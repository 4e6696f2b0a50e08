// Pieces shared by the two full-pass histogram kernels, hist_full.cu and
// hist_packed.cu (Hopper, sm_90a).
//
// Both kernels give every warp ONE feature: a private shared-memory
// histogram of nb bins x (g, h, c) floats and an nb-word group mask.  A
// block stages each row's three weights in shared memory once for all of
// its warps, and a warp bins 32 consecutive rows per step:
//
//  * group_add: lanes that hold one bin find each other through integer
//    ORs into the mask (no __match_any_sync), and the group's lowest lane
//    adds the group's sum, taken in lane (row) order, to the bin, so every
//    bin has one writer and no float atomics are needed;
//  * flush: at the end of its rows the warp writes its histogram straight
//    into the output when its block is the only one over those rows, else
//    into the block's partial slot, only the bins it touched (a bin is
//    touched when one of its three sums is not +0.0), with one bitmap word
//    per 32 bins saying which;
//  * hist_reduce: the second pass sums each output element's partials over
//    the row chunks in a fixed order (kParts consecutive runs, then the
//    runs in order), reading only the partials whose bit is set.
//
// A histogram sum is never -0.0: it starts at +0.0, and +0.0 + -0.0 is
// +0.0 in round-to-nearest.  So a bin that is not written holds exactly
// +0.0, and skipping it gives the bits that adding it would; a NaN sum is
// not +0.0 and is written.  The plan depends only on the shapes, so two
// launches on the same input are bitwise equal.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace lgbt_hist {

constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kParts = 8;  // chunk runs one reduce block sums apart

// Copy 4 bytes to shared-space address `s` (from __cvta_generic_to_shared
// once, outside the loop: converted per copy inside a branchy loop, the
// compiler may re-read the shared window's base for every copy).
__device__ __forceinline__ void cp_async4(unsigned s, const void* gmem) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most N of this thread's copy groups are pending.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// The row's (g, h, c) enter the histogram unless all three are exactly
// zero (a NaN weight is not skipped).
__device__ __forceinline__ bool weighted(float g, float h, float c) {
  return g != 0.0f || h != 0.0f || c != 0.0f;
}

// One 32-row step of one warp.  Lanes with `in` add their row's (g, h, c)
// to bin `bin` of `hist`; sg/sh/sc are the staged weights of the step's
// rows, lane j's row at index i0 + j.  `msk` (one word per bin) is zero
// between calls.
__device__ __forceinline__ void group_add(bool in, int bin, float g, float h,
                                          float c, const float* sg,
                                          const float* sh, const float* sc,
                                          int i0, uint32_t* msk,
                                          float* hist) {
  const int lane = threadIdx.x & 31;
  if (in) atomicOr(msk + bin, 1u << lane);
  __syncwarp();
  const uint32_t group = in ? msk[bin] : 0u;
  __syncwarp();
  if (in && lane == __ffs(group) - 1) {
    float tg = g, th = h, tc = c;
    uint32_t mm = group & (group - 1);  // the members after this lane
    while (mm) {
      const int j = i0 + __ffs(mm) - 1;
      mm &= mm - 1;
      tg += sg[j];
      th += sh[j];
      tc += sc[j];
    }
    float* d = hist + bin * 3;
    d[0] += tg;
    d[1] += th;
    d[2] += tc;
    msk[bin] = 0u;
  }
  __syncwarp();
}

// Warp-private: write the warp's nb-bin histogram.  `direct`: all of it,
// to dst.  Otherwise the touched bins only, to dst, and their bitmap
// (ceil(nb / 32) words) to bits.
__device__ __forceinline__ void flush(const float* hist, int nb, bool direct,
                                      float* dst, uint32_t* bits) {
  const int lane = threadIdx.x & 31;
  __syncwarp();
  if (direct) {
    for (int e = lane; e < nb * 3; e += 32) dst[e] = hist[e];
    return;
  }
  for (int b0 = 0; b0 < nb; b0 += 32) {
    const int b = b0 + lane;
    float g = 0.0f, h = 0.0f, c = 0.0f;
    if (b < nb) {
      g = hist[b * 3];
      h = hist[b * 3 + 1];
      c = hist[b * 3 + 2];
    }
    const bool touched = b < nb && weighted(g, h, c);
    const uint32_t word = __ballot_sync(kFull, touched);
    if (lane == 0) bits[b0 >> 5] = word;
    if (touched) {
      dst[b * 3] = g;
      dst[b * 3 + 1] = h;
      dst[b * 3 + 2] = c;
    }
  }
}

// out[f, b, c] = the sum over the nchunks row chunks of partial[chunk, f, b,
// c] where bit b of the chunk's bitmap for f is set.  Partials are laid out
// (nchunks, nf, nbins, 3), bitmaps (nchunks, nf, W) with W = ceil(nbins / 32).
// Grid (W, nf), kParts warps a block: the block takes 32 bins of one
// feature, one bin per lane; warp q sums the q-th of kParts consecutive runs
// of chunks (each chunk's bitmap word read once, by the whole warp), and the
// runs' sums are added in run order.
__global__ void __launch_bounds__(kParts * 32)
hist_reduce(const float* __restrict__ partial,
            const uint32_t* __restrict__ bits, int nchunks, int nf, int nbins,
            float* __restrict__ out) {
  __shared__ float s_sum[kParts][32][3];
  const int lane = threadIdx.x & 31;
  const int q = threadIdx.x >> 5;
  const int W = (nbins + 31) >> 5;
  const int wd = blockIdx.x;
  const int f = blockIdx.y;
  const int b = wd * 32 + lane;
  const int run = (nchunks + kParts - 1) / kParts;
  const int c0 = q * run;
  const int c1 = c0 + run < nchunks ? c0 + run : nchunks;
  const long long per_chunk = (long long)nf * nbins * 3;
  const float* p = partial + ((long long)f * nbins + b) * 3;
  const uint32_t* bw = bits + (long long)f * W + wd;
  float g = 0.0f, h = 0.0f, c = 0.0f;
#pragma unroll 4
  for (int ch = c0; ch < c1; ++ch) {
    if ((bw[(long long)ch * nf * W] >> lane) & 1u) {
      const float* pc = p + ch * per_chunk;
      g += pc[0];
      h += pc[1];
      c += pc[2];
    }
  }
  s_sum[q][lane][0] = g;
  s_sum[q][lane][1] = h;
  s_sum[q][lane][2] = c;
  __syncthreads();
  if (q == 0 && b < nbins) {
    for (int j = 1; j < kParts; ++j) {
      g += s_sum[j][lane][0];
      h += s_sum[j][lane][1];
      c += s_sum[j][lane][2];
    }
    float* o = out + ((long long)f * nbins + b) * 3;
    o[0] = g;
    o[1] = h;
    o[2] = c;
  }
}

// Launch the second pass over nf features of nbins bins on `st`.
inline cudaError_t launch_reduce(const float* partial, const uint32_t* bits,
                                 int nchunks, int nf, int nbins, float* out,
                                 cudaStream_t st) {
  hist_reduce<<<dim3((nbins + 31) / 32, nf), kParts * 32, 0, st>>>(
      partial, bits, nchunks, nf, nbins, out);
  return cudaGetLastError();
}

}  // namespace lgbt_hist
