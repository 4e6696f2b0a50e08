// Stable row partition for the frontier-wave learner, written for Hopper
// (sm_90a).
//
// Replaces the TPU kernel lightgbm_tpu/ops/partition_pallas.py:apply_partition
// (_apply_partition_call -> _permute_kernel), which moves rows through bf16
// byte planes and a one-hot MXU contraction because the TPU has no scatter.
// It computes the same permutation: every row r of every lane goes to
// dest[r],
//
//   bins_out[k, dest[r]] = bins[k, r]   k < Fw   (packed bin words, int32)
//   w_out[c, dest[r]]    = w[c, r]      c < 3    (moved as 32-bit patterns)
//   rid_out[dest[r]]     = rid[r]                (int64 row ids)
//   lid_out[dest[r]]     = lid[r]                (int32 node-slot ids)
//
// where dest is a permutation of [0, N) computed by the caller (rows outside
// the sortable windows have dest[r] = r).  The outputs are a second set of
// buffers, so every output row is written exactly once and the result is a
// pure permutation, bitwise for any payload (NaN and negative-zero weights
// included: weights travel as uint32 bits).
//
// Design.  One thread per source row reads dest[r] once and moves the row's
// Fw + 3 + 2 + 1 words.  Reads are coalesced (neighbouring threads read
// neighbouring rows); writes are coalesced within each run of rows that keep
// their side, which is most of a stable partition.  A destination outside
// [0, N) breaks the wrapper's contract: the kernel traps, so the launch
// fails loudly (as the plain version's index_copy_ raises) instead of
// leaving the output row that nobody wrote with the spare buffer's stale
// lanes.
//
// Bound.  The function must read and write every lane once and read dest
// once: N * (Fw + 3 + 2 + 1) * 4 * 2 + N * 4 bytes (rid counted as 8 bytes);
// at the bench width (Fw = 8, N = 1,000,448) that is about 116 MB, about
// 35 us at 3.35 TB/s.  There is no arithmetic to speak of: it is bytes-bound.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
partition_rows(const int32_t* __restrict__ bins, int fw,
               const uint32_t* __restrict__ w, const int64_t* __restrict__ rid,
               const int32_t* __restrict__ lid,
               const int32_t* __restrict__ dest, int n,
               int32_t* __restrict__ bins_out, uint32_t* __restrict__ w_out,
               int64_t* __restrict__ rid_out, int32_t* __restrict__ lid_out) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x; r < n;
       r += stride) {
    const int d = dest[r];
    if (d < 0 || d >= n) __trap();
    for (int k = 0; k < fw; ++k) {
      bins_out[(long long)k * n + d] = bins[(long long)k * n + r];
    }
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      w_out[(long long)c * n + d] = w[(long long)c * n + r];
    }
    rid_out[d] = rid[r];
    lid_out[d] = lid[r];
  }
}

}  // namespace

extern "C" {

// Launch on `stream`.  Every array is contiguous with row stride n.  Returns
// cudaGetLastError() after the launch (0 = launched).
int lgbt_partition(const void* bins, int fw, const void* w, const void* rid,
                   const void* lid, const void* dest, int n, void* bins_out,
                   void* w_out, void* rid_out, void* lid_out, void* stream) {
  long long blocks = ((long long)n + kThreads - 1) / kThreads;
  if (blocks > 65535LL * 32) blocks = 65535LL * 32;
  if (blocks < 1) blocks = 1;
  partition_rows<<<(unsigned)blocks, kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(bins), fw, static_cast<const uint32_t*>(w),
      static_cast<const int64_t*>(rid), static_cast<const int32_t*>(lid),
      static_cast<const int32_t*>(dest), n, static_cast<int32_t*>(bins_out),
      static_cast<uint32_t*>(w_out), static_cast<int64_t*>(rid_out),
      static_cast<int32_t*>(lid_out));
  return (int)cudaGetLastError();
}

}  // extern "C"
