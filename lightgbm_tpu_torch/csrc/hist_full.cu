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
// Design: hist_packed.cu's, with one code per row instead of four per word.
// Pass 1 runs an (F, nchunks, ntiles) grid: each block reads ONE feature's
// code row and the three weight rows over a chunk of rows, 32 consecutive rows
// per warp step, so every load is coalesced.  Each warp owns a private
// shared-memory histogram of the block's bin tile [lo, lo + tile) (tile <=
// 1024 bins: 12 KB per warp, 96 KB for the block's 8 warps, above the 48 KB
// default, so the launch raises the block's limit).  Lanes holding the same
// code are grouped with __match_any_sync; the group's leader sums the group's
// weights from a per-warp staging buffer in lane order and adds the sum to the
// warp's copy, so no atomics are needed.  The warps' copies are summed in warp
// order into the block's partial; pass 2 sums the partials over chunks in
// chunk order.  Past 1024 bins (uint16 codes allow up to 65,536) the tile axis
// grows instead of the shared memory: each block counts only the codes of its
// own tile.  The geometry depends only on the shapes, so two launches on the
// same input are bitwise equal; a float atomicAdd histogram would not be.
// Rows whose three weights are all zero add nothing and are skipped: in the
// masked learner that is every row outside the smaller child.
//
// Bound.  The function must read F*S*code_bytes + 3*S*4 bytes and write
// F*nbins*12; at the bench width (F = 28, S = 1,000,448, uint16 codes,
// nbins = 1,023) that is 68.4 MB, about 0.020 ms at 3.35 TB/s.  The real
// limit is more likely the per-row match, the group sums and the
// shared-memory read-modify-writes of every row of a full pass, whatever the
// share of rows with non-zero weights.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kStage = 32 * 3;  // one warp step's (g, h, c) per lane
constexpr int kMaxTile = 1024;

template <typename Code>
__global__ void __launch_bounds__(kThreads)
hist_full_partial(const Code* __restrict__ bins, long long bins_stride,
                  const float* __restrict__ w, long long w_stride, int S,
                  int chunk, int nbins, int tile,
                  float* __restrict__ partial) {
  extern __shared__ float smem[];
  const int f = blockIdx.x;
  const int ch = blockIdx.y;
  const int lo = blockIdx.z * tile;
  const int hi = min(nbins, lo + tile);
  const int E = (hi - lo) * 3;
  float* hist = smem;                      // kWarps * E
  float* stage = smem + kWarps * tile * 3; // kWarps * kStage
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  for (int i = threadIdx.x; i < kWarps * E; i += kThreads) hist[i] = 0.0f;
  __syncthreads();

  float* mine = hist + warp * E;
  float* st = stage + warp * kStage;
  const Code* row = bins + (long long)f * bins_stride;
  const float* wg = w;
  const float* wh = w + w_stride;
  const float* wc = w + 2 * w_stride;
  const int r0 = ch * chunk;
  const int r1 = min(S, r0 + chunk);

  for (int base = r0 + warp * 32; base < r1; base += kThreads) {
    const int r = base + lane;
    const bool valid = r < r1;
    uint32_t code = 0u;
    float g = 0.0f, h = 0.0f, c = 0.0f;
    if (valid) {
      code = static_cast<uint32_t>(row[r]);
      g = wg[r];
      h = wh[r];
      c = wc[r];
    }
    const bool active = valid && (g != 0.0f || h != 0.0f || c != 0.0f) &&
                        code >= static_cast<uint32_t>(lo) &&
                        code < static_cast<uint32_t>(hi);
    st[lane * 3 + 0] = g;
    st[lane * 3 + 1] = h;
    st[lane * 3 + 2] = c;
    __syncwarp();
    const uint32_t key = active ? code : 0xFFFFFFFFu;
    const uint32_t group = __match_any_sync(0xFFFFFFFFu, key);
    if (active && lane == __ffs(group) - 1) {
      float sg = 0.0f, sh = 0.0f, sc = 0.0f;
      uint32_t m = group;
      while (m) {
        const int j = __ffs(m) - 1;
        m &= m - 1;
        sg += st[j * 3 + 0];
        sh += st[j * 3 + 1];
        sc += st[j * 3 + 2];
      }
      float* dst = mine + (static_cast<int>(code) - lo) * 3;
      dst[0] += sg;
      dst[1] += sh;
      dst[2] += sc;
    }
    __syncwarp();
  }
  __syncthreads();

  float* out = partial + ((long long)f * gridDim.y + ch) * nbins * 3 + lo * 3;
  for (int e = threadIdx.x; e < E; e += kThreads) {
    float v = 0.0f;
    for (int q = 0; q < kWarps; ++q) v += hist[q * E + e];
    out[e] = v;
  }
}

__global__ void hist_full_reduce(const float* __restrict__ partial,
                                 int nchunks, int E, long long total,
                                 float* __restrict__ out) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const long long f = i / E;
  const long long e = i - f * E;
  const float* p = partial + f * nchunks * (long long)E + e;
  float v = 0.0f;
  for (int q = 0; q < nchunks; ++q) v += p[(long long)q * E];
  out[i] = v;
}

template <typename Code>
int launch(const void* bins, long long bins_stride, const void* w,
           long long w_stride, int F, int S, int nbins, int tile, int nchunks,
           int chunk, void* partial, void* out, cudaStream_t st) {
  const int smem = (kWarps * tile * 3 + kWarps * kStage) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      hist_full_partial<Code>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  const int ntiles = (nbins + tile - 1) / tile;
  hist_full_partial<Code><<<dim3(F, nchunks, ntiles), kThreads, smem, st>>>(
      static_cast<const Code*>(bins), bins_stride,
      static_cast<const float*>(w), w_stride, S, chunk, nbins, tile,
      static_cast<float*>(partial));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launch both passes on `stream`.  `partial` holds F * nchunks * nbins * 3
// floats of scratch, `out` F * nbins * 3 floats.  Returns cudaGetLastError()
// after the launches (0 = both launched), or cudaErrorInvalidValue for a code
// width other than 1 or 2 or a tile outside [1, 1024].
int lgbt_hist_full(const void* bins, long long bins_stride, int code_bytes,
                   const void* w, long long w_stride, int F, int S, int nbins,
                   int tile, int nchunks, int chunk, void* partial, void* out,
                   void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (tile < 1 || tile > kMaxTile) return (int)cudaErrorInvalidValue;
  int err;
  if (code_bytes == 1) {
    err = launch<uint8_t>(bins, bins_stride, w, w_stride, F, S, nbins, tile,
                          nchunks, chunk, partial, out, st);
  } else if (code_bytes == 2) {
    err = launch<uint16_t>(bins, bins_stride, w, w_stride, F, S, nbins, tile,
                           nchunks, chunk, partial, out, st);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return err;
  const int E = nbins * 3;
  const long long total = (long long)F * E;
  const int threads = 256;
  const long long blocks = (total + threads - 1) / threads;
  hist_full_reduce<<<(unsigned)blocks, threads, 0, st>>>(
      static_cast<const float*>(partial), nchunks, E, total,
      static_cast<float*>(out));
  return (int)cudaGetLastError();
}

}  // extern "C"
