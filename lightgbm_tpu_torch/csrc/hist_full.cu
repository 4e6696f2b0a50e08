// Full-pass histogram of unpacked bin codes for the masked learner, written
// for Hopper (sm_90a).
//
// Replaces the TPU kernel
// lightgbm_tpu/ops/hist_pallas.py:build_histogram_pallas
// (_hist_kernel), which expands each row block's codes into a one-hot matrix
// and contracts it with the weights on the MXU.  It computes, in true float32:
//
//   out[f, b, c] = sum_r [bins[f, r] == b] * w[c, r]
//
//   bins : (F, S) uint8 or uint16 codes (code_bytes 1 or 2), read as they are
//          (never widened); rows contiguous, row stride bins_stride, so the
//          first F rows of the dataset's feature-padded matrix are read and
//          the padding rows are not
//   w    : (3, S) float32 rows (g*m, h*m, m), row stride w_stride
//   out  : (F, nbins, 3) float32, exactly nbins wide; codes >= nbins dropped
//
// The masked learner calls it once per split over every row, with weights
// that are zero outside the smaller child: at its median launch a fraction
// of a percent of the rows carry a weight.  Rows whose three weights are all
// zero add nothing.
//
// Bound.  The function must read the three weight rows (3*S*4 bytes), the
// code sectors (32 bytes) that hold a weighted row, and write F*nbins*12
// bytes.  With every row weighted, at the bench width (F = 28, S =
// 1,000,448, uint16 codes, nbins = 1,023), that is 68.4 MB, about 0.020 ms
// at 3.35 TB/s; with 0.2% of the rows weighted about 14 MB.
//
// Design (hist_common.cuh holds the shared pieces): the weights, not the
// codes, decide what is read and binned.
//
//  * Pass 0 (hist_full_active) reads the three weight rows once and writes
//    one ballot word per 32 rows: bit j set when row 32q + j is weighted.
//  * Pass 1, grid (nchunks, ceil(F / 4), bin tiles).  A block takes kFeat
//    = 4 features, a warp each, over one chunk of rows and one tile of at
//    most 1,024 bins; wider histograms (uint16 codes allow 65,536 bins)
//    take more tiles, each block counting only the codes of its own tile.
//    The chunk count is sized on the host (ops/hist_full.py: full_plan) so
//    the grid is one wave of the 132 SMs at three blocks each, with no
//    tail.  The block reads its chunk's ballot words and lists, in row
//    order, the 32-row groups that hold a weighted row (a block scan; up to
//    896 groups a segment).  Only those groups are staged: their weights
//    copied into shared memory with cp.async, eight groups a stage, three
//    stages deep, once for the block's four features; each warp loads its
//    feature's codes of a stage's groups one stage ahead of binning them.
//    An unweighted group costs no load and no binning.
//  * Binning: one histogram copy per feature (12 KB) and a 1,024-word group
//    mask per warp (group_add), 76.5 KB a block with the stages and the
//    list: three blocks, 12 warps, per SM.  No cross-warp merge.
//  * One block per chunk writes its partial: only the bins it touched, with
//    a bitmap (flush); pass 2 (hist_reduce) sums them over chunks in a
//    fixed order.  A single chunk writes the output directly and pass 2 is
//    not launched.  The plan depends only on the shapes and the weights'
//    zero pattern, so two launches on the same input are bitwise equal.  No
//    float atomics.
//
// What limits it: with every row weighted, the binning's shared-memory
// traffic (an OR, a read-back and a read-modify-write per row and
// feature); with few rows weighted, pass 0's read of the weight rows, the
// stage latency of the few groups a block holds, and pass 2.

#include "hist_common.cuh"

namespace {

using namespace lgbt_hist;

constexpr int kFeat = 4;               // features (warps) per block
constexpr int kThreads = kFeat * 32;
constexpr int kMaxTile = 1024;
constexpr int kRows = 256;             // rows per stage
constexpr int kSteps = kRows / 32;     // 32-row steps per stage
constexpr int kStages = 3;
constexpr int kSeg = 896;              // 32-row groups per list segment
constexpr int kPer = kSeg / kThreads;  // ... that one thread lists
constexpr int kActRows = 4;            // rows per thread of pass 0

size_t smem_bytes(int tile) {
  return sizeof(float) * ((size_t)kFeat * tile * 4 + kStages * 3 * kRows) +
         kSeg * sizeof(uint16_t) + 8 * sizeof(int);
}

// Pass 0: act[q] = the ballot of rows [32q, 32q + 32): bit j set when row
// 32q + j has a weight that is not zero.  A block of 256 threads takes
// 1,024 rows, each thread four rows 256 apart (twelve loads in flight).
__global__ void __launch_bounds__(256)
hist_full_active(const float* __restrict__ w, long long w_stride, int S,
                 uint32_t* __restrict__ act) {
  const int base = blockIdx.x * 256 * kActRows + threadIdx.x;
  float v[kActRows][3];
#pragma unroll
  for (int u = 0; u < kActRows; ++u) {
    const int r = base + 256 * u;
#pragma unroll
    for (int a = 0; a < 3; ++a)
      v[u][a] = r < S ? w[a * w_stride + r] : 0.0f;
  }
#pragma unroll
  for (int u = 0; u < kActRows; ++u) {
    const int r = base + 256 * u;
    const uint32_t word =
        __ballot_sync(kFull, r < S && weighted(v[u][0], v[u][1], v[u][2]));
    if ((threadIdx.x & 31) == 0 && r < S) act[r >> 5] = word;
  }
}

// The block's list of the active groups of one segment, in row order.
struct List {
  uint16_t* grp;   // group offsets within the segment
  int* scan;       // kFeat warp sums
};

// List the groups [g0, g0 + ng) whose ballot is not zero, in order; every
// thread must call it.  Returns their count.
__device__ __forceinline__ int build_list(const uint32_t* act, int g0, int ng,
                                          const List& l) {
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  uint32_t a[kPer];
  int c = 0;
#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    const int q = kPer * t + u;
    a[u] = q < ng ? act[g0 + q] : 0u;
    c += a[u] != 0u;
  }
  int x = c;  // inclusive scan over the block
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) l.scan[warp] = x;
  __syncthreads();
  int before = 0, total = 0;
#pragma unroll
  for (int i = 0; i < kFeat; ++i) {
    const int v = l.scan[i];
    before += i < warp ? v : 0;
    total += v;
  }
  int pos = before + x - c;
#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    if (a[u] != 0u) l.grp[pos++] = static_cast<uint16_t>(kPer * t + u);
  }
  __syncthreads();
  return total;
}

// Copy the weights of stage j's groups (list entries [8j, 8j + 8)) into its
// buffer at shared address `buf`: slot q holds list entry 8j + q, row
// 32 * group + lane at q*32+lane.
__device__ __forceinline__ void issue(const float* w, long long w_stride,
                                      int g0, int r1, int j, int n,
                                      const List& l, unsigned buf) {
  for (int e = threadIdx.x; e < 3 * kRows; e += kThreads) {
    const int a = e / kRows;
    const int i = e - a * kRows;
    const int k = j * kSteps + (i >> 5);
    if (k < n) {
      const int row = (g0 + l.grp[k]) * 32 + (i & 31);
      if (row < r1) cp_async4(buf + 4 * e, w + a * w_stride + row);
    }
  }
}

// Stage j's ballots (from pass 0, so rows past S are never weighted), and
// this lane's code in each of its groups (loaded whatever the lane's own
// weight: the group's code sector is read anyway), both in flight together.
template <typename Code>
__device__ __forceinline__ void prepare(const uint32_t* act_words,
                                        const Code* row, int g0, int r1,
                                        int j, int n, bool live,
                                        const List& l, uint32_t* act,
                                        uint32_t* code) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int q = 0; q < kSteps; ++q) {
    const int k = j * kSteps + q;
    act[q] = 0u;
    code[q] = 0u;
    if (k < n) {
      const int grp = g0 + l.grp[k];
      act[q] = act_words[grp];
      const int r = grp * 32 + lane;
      if (live && r < r1) code[q] = static_cast<uint32_t>(row[r]);
    }
  }
}

__device__ __forceinline__ void process(const float* buf, int lo, int nb,
                                        const uint32_t* act,
                                        const uint32_t* code, uint32_t* msk,
                                        float* hist) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int q = 0; q < kSteps; ++q) {
    if (act[q] == 0u) continue;  // warp-uniform
    const int i = q * 32 + lane;
    const bool a = (act[q] >> lane) & 1u;
    const uint32_t bin = code[q] - static_cast<uint32_t>(lo);
    const bool in = a && bin < static_cast<uint32_t>(nb);
    float g = 0.0f, h = 0.0f, c = 0.0f;
    if (a) {
      g = buf[i];
      h = buf[kRows + i];
      c = buf[2 * kRows + i];
    }
    group_add(in, static_cast<int>(bin), g, h, c, buf, buf + kRows,
              buf + 2 * kRows, q * 32, msk, hist);
  }
}

template <typename Code>
__global__ void __launch_bounds__(kThreads)
hist_full_chunks(const Code* __restrict__ bins, long long bins_stride,
                 const float* __restrict__ w, long long w_stride,
                 const uint32_t* __restrict__ act_words, int F, int S,
                 int chunk, int nbins, int tile, int nchunks,
                 float* __restrict__ partial, uint32_t* __restrict__ bits,
                 float* __restrict__ out) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int warp = threadIdx.x >> 5;
  const int ch = blockIdx.x;
  const int f = blockIdx.y * kFeat + warp;
  const bool live = f < F;
  const int lo = blockIdx.z * tile;
  const int nb = min(nbins, lo + tile) - lo;
  float* hist = smem + warp * tile * 3;
  uint32_t* msk = reinterpret_cast<uint32_t*>(smem + kFeat * tile * 3) +
                  warp * tile;
  float* stages = smem + kFeat * tile * 4;
  const unsigned sstages =
      static_cast<unsigned>(__cvta_generic_to_shared(stages));
  List l;
  l.scan = reinterpret_cast<int*>(stages + kStages * 3 * kRows);
  l.grp = reinterpret_cast<uint16_t*>(l.scan + 8);
  for (int e = threadIdx.x; e < kFeat * tile * 4; e += kThreads)
    smem[e] = 0.0f;  // histograms and group masks

  const Code* row = bins + (long long)(live ? f : 0) * bins_stride;
  const int r0 = ch * chunk;
  const int r1 = min(S, r0 + chunk);
  const int g1 = (r1 + 31) >> 5;
  for (int g0 = r0 >> 5; g0 < g1; g0 += kSeg) {
    const int n = build_list(act_words, g0, min(kSeg, g1 - g0), l);
    const int nst = (n + kSteps - 1) / kSteps;
    if (nst == 0) continue;  // uniform: no weighted row in the segment
    for (int j = 0; j < kStages - 1; ++j) {
      if (j < nst)
        issue(w, w_stride, g0, r1, j, n, l, sstages + 4 * j * 3 * kRows);
      cp_async_commit();
    }
    uint32_t act[kSteps], code[kSteps];
    prepare(act_words, row, g0, r1, 0, n, live, l, act, code);
    cp_async_wait<kStages - 2>();  // stage 0 (this thread's copies) landed
    __syncthreads();               // ... and every thread's
    for (int j = 0; j < nst; ++j) {
      const int ja = j + kStages - 1;
      if (ja < nst)
        issue(w, w_stride, g0, r1, ja, n, l,
              sstages + 4 * (ja % kStages) * 3 * kRows);
      cp_async_commit();
      uint32_t act_n[kSteps] = {}, code_n[kSteps] = {};
      if (j + 1 < nst)
        prepare(act_words, row, g0, r1, j + 1, n, live, l, act_n, code_n);
      if (live)
        process(stages + (j % kStages) * 3 * kRows, lo, nb, act, code, msk,
                hist);
      cp_async_wait<kStages - 2>();  // stage j + 1 landed
      __syncthreads();  // ... for all; stage j's buffer and the list free
#pragma unroll
      for (int q = 0; q < kSteps; ++q) {
        act[q] = act_n[q];
        code[q] = code_n[q];
      }
    }
  }
  if (!live) return;
  const long long slot = (long long)ch * F + f;
  if (nchunks == 1)
    flush(hist, nb, true, out + ((long long)f * nbins + lo) * 3, nullptr);
  else
    flush(hist, nb, false, partial + (slot * nbins + lo) * 3,
          bits + slot * ((nbins + 31) >> 5) + (lo >> 5));
}

template <typename Code>
cudaError_t launch(const void* bins, long long bins_stride, const void* w,
                   long long w_stride, int F, int S, int nbins, int tile,
                   int nchunks, int chunk, void* act, void* partial,
                   void* bits, void* out, cudaStream_t st) {
  static bool raised[64] = {false};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (!raised[dev]) {  // once per device: the largest block this file makes
    err = cudaFuncSetAttribute(hist_full_chunks<Code>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem_bytes(kMaxTile));
    if (err != cudaSuccess) return err;
    raised[dev] = true;
  }
  hist_full_active<<<(S + 256 * kActRows - 1) / (256 * kActRows), 256, 0,
                     st>>>(
      static_cast<const float*>(w), w_stride, S, static_cast<uint32_t*>(act));
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int ntiles = (nbins + tile - 1) / tile;
  const int groups = (F + kFeat - 1) / kFeat;
  hist_full_chunks<Code>
      <<<dim3(nchunks, groups, ntiles), kThreads, smem_bytes(tile), st>>>(
          static_cast<const Code*>(bins), bins_stride,
          static_cast<const float*>(w), w_stride,
          static_cast<const uint32_t*>(act), F, S, chunk, nbins, tile,
          nchunks, static_cast<float*>(partial),
          static_cast<uint32_t*>(bits), static_cast<float*>(out));
  err = cudaGetLastError();
  if (err != cudaSuccess || nchunks == 1) return err;
  return launch_reduce(static_cast<const float*>(partial),
                       static_cast<const uint32_t*>(bits), nchunks, F, nbins,
                       static_cast<float*>(out), st);
}

}  // namespace

extern "C" {

// Launch on `stream`: pass 0 (the row ballots), the binning pass over
// (nchunks, ceil(F / 4), tiles) blocks, then, for nchunks > 1, the reduce
// pass.  `act` holds ceil(S / 32) words of scratch, `partial`
// nchunks * F * nbins * 3 floats and `bits` nchunks * F * ceil(nbins / 32)
// words of scratch (unused for one chunk), `out` F * nbins * 3 floats.
// Returns cudaGetLastError() after the launches (0 = launched), or
// cudaErrorInvalidValue for a code width other than 1 or 2, a tile outside
// [1, 1024] or a chunk that is not a positive multiple of 256 rows.
int lgbt_hist_full(const void* bins, long long bins_stride, int code_bytes,
                   const void* w, long long w_stride, int F, int S, int nbins,
                   int tile, int nchunks, int chunk, void* act,
                   void* partial, void* bits, void* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (tile < 1 || tile > kMaxTile || chunk < 1 || chunk % kRows ||
      nchunks < 1 || F < 1 || S < 1)
    return (int)cudaErrorInvalidValue;
  if (code_bytes == 1)
    return (int)launch<uint8_t>(bins, bins_stride, w, w_stride, F, S, nbins,
                                tile, nchunks, chunk, act, partial, bits, out,
                                st);
  if (code_bytes == 2)
    return (int)launch<uint16_t>(bins, bins_stride, w, w_stride, F, S, nbins,
                                 tile, nchunks, chunk, act, partial, bits,
                                 out, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
