// Predict-time binning of a raw float64 matrix, written for Hopper (sm_90a).
//
// Replaces lightgbm_tpu/serving/binner.py:_bin_device, a jitted XLA
// function (not a pallas_call) that bins a request matrix on the device
// before the traversal.  It computes exactly what the port's host binner
// (binner.py:BinnerArrays.bin_host) computes, code for code:
//
//   out[k, r] = code of x[r, col[k]] under used feature k     k < fu
//   out[k, r] = 0                                             fu <= k < f_pad
//
// where the code of a value v under feature k is
//
//   numerical:   NaN and missing type NaN -> nan_bin[k]; otherwise (NaN
//                probing as 0.0) the count of bounds[k, :] below v, a
//                lower_bound over the sorted +inf-padded row (numpy's
//                searchsorted(side="left"); -0.0 compares equal to 0.0)
//   categorical: NaN and missing type NaN -> OOV; otherwise (NaN as 0.0)
//                t = trunc(v); OOV unless 0 <= t <= cat_max[k], else
//                cat_lut[k, t].  The host binner's int64 cast sends every
//                value outside [0, cat_max] (negative, past the table, +-inf,
//                1e30) to a negative code or past cat_max, so both are OOV.
//
// Design.  A block per (used feature, row tile): blockIdx.x is the feature
// (the features of one tile run side by side, so the 32-byte sectors of a
// row tile that one feature's block fetches serve the others from the L2),
// blockIdx.y walks the row tiles.  A numerical feature's block stages its
// own bounds row in shared memory when it fits the default 48 KB (B <= 6,144,
// every max_bin up to 6,145), and searches the row in global memory
// otherwise, so every width bins.  The category table can be wide (lut_max
// + 2 int32): it is probed in global memory.  Each thread bins rows r,
// r + 256, ... of the tile: the codes are written coalesced along a row of
// the (f_pad, n) output.  The input is read one double per row and feature
// at a stride of ldx doubles: not coalesced (a warp touches 32 sectors for
// 256 useful bytes), which the L2 absorbs across a tile's features.
//
// Bound.  The function must read the used columns once (n * fu * 8 bytes)
// and the tables once, and write f_pad * n int32 codes: at the predict
// shape of chip_smoke.py (100,000 rows x 28 features, f_pad 32) that is
// 22.4 MB + 12.8 MB, 0.0105 ms at 3.35 TB/s.  The arithmetic (a few compares
// per search step) is far below the card's rate: it is bytes-bound.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTileRows = 2048;          // rows per (feature, tile) block
constexpr int kOOV = 1 << 20;            // binner.py:OOV_BIN
constexpr int kMissingNaN = 2;           // binning.py:MISSING_NAN
constexpr int kStageMaxBytes = 48 * 1024;

// per-feature metadata columns of `meta` (fu, kMeta) int32
enum { M_COL = 0, M_MISSING, M_NAN_BIN, M_IS_CAT, M_CAT_MAX, kMeta };

__device__ __forceinline__ int lower_bound(const double* b, int n, double v) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (b[mid] < v) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__global__ void __launch_bounds__(kThreads)
bin_predict_rows(const double* __restrict__ x, long long ldx, int n, int fu,
                 const int32_t* __restrict__ meta,
                 const double* __restrict__ bounds, int nb, int stage,
                 const int32_t* __restrict__ cat_lut, int ncat,
                 int32_t* __restrict__ out) {
  extern __shared__ double s_bounds[];
  const int k = blockIdx.x;
  const int ntiles = (n + kTileRows - 1) / kTileRows;
  if (k >= fu) {                         // a padding feature row: zeros
    for (int t = blockIdx.y; t < ntiles; t += gridDim.y) {
      const int r1 = min(n, (t + 1) * kTileRows);
      for (int r = t * kTileRows + threadIdx.x; r < r1; r += kThreads)
        out[(long long)k * n + r] = 0;
    }
    return;
  }
  const int col = meta[k * kMeta + M_COL];
  const bool nan_missing = meta[k * kMeta + M_MISSING] == kMissingNaN;
  const int nan_bin = meta[k * kMeta + M_NAN_BIN];
  const bool is_cat = meta[k * kMeta + M_IS_CAT] != 0;
  const double cat_max = (double)meta[k * kMeta + M_CAT_MAX];
  const double* row = bounds + (long long)k * nb;
  // block-uniform: every thread takes the same branch and reaches the sync
  if (stage && !is_cat) {
    for (int i = threadIdx.x; i < nb; i += kThreads) s_bounds[i] = row[i];
    __syncthreads();
    row = s_bounds;
  }
  const int32_t* lut = cat_lut + (long long)k * ncat;
  for (int t = blockIdx.y; t < ntiles; t += gridDim.y) {
    const int r1 = min(n, (t + 1) * kTileRows);
    for (int r = t * kTileRows + threadIdx.x; r < r1; r += kThreads) {
      double v = x[(long long)r * ldx + col];
      int code;
      if (isnan(v) && nan_missing) {
        code = is_cat ? kOOV : nan_bin;
      } else {
        if (isnan(v)) v = 0.0;
        if (is_cat) {
          const double tr = trunc(v);
          code = (tr >= 0.0 && tr <= cat_max) ? lut[(int)tr] : kOOV;
        } else {
          code = lower_bound(row, nb, v);
        }
      }
      out[(long long)k * n + r] = code;
    }
  }
}

}  // namespace

extern "C" {

// x: (n, ldx) float64 row-major raw matrix; meta: (fu, 5) int32 (column,
// missing type, nan bin, is categorical, cat_max); bounds: (fu, nb) float64
// sorted rows padded with +inf; cat_lut: (fu, ncat) int32; out: (f_pad, n)
// int32.  Returns the CUDA error of the launch (0 on success).
int lgbt_bin_predict(const double* x, long long ldx, int n, int fu, int f_pad,
                     const int32_t* meta, const double* bounds, int nb,
                     const int32_t* cat_lut, int ncat, int32_t* out,
                     cudaStream_t stream) {
  if (n <= 0 || f_pad <= 0) return 0;
  const int ntiles = (n + kTileRows - 1) / kTileRows;
  const int stage = (long long)nb * (long long)sizeof(double) <= kStageMaxBytes;
  const size_t smem = stage ? (size_t)nb * sizeof(double) : 0;
  dim3 grid(f_pad, ntiles < 65535 ? ntiles : 65535);
  bin_predict_rows<<<grid, kThreads, smem, stream>>>(
      x, ldx, n, fu, meta, bounds, nb, stage, cat_lut, ncat, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
