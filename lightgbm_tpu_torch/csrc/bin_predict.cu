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
// Bound.  The function must read the used columns once (n * fu * 8 bytes)
// and the tables once, and write f_pad * n int32 codes: at the predict
// shape of chip_smoke.py (100,000 rows x 28 features, f_pad 32) that is
// 22.4 MB + 12.8 MB, 0.0105 ms at 3.35 TB/s.  The arithmetic is a few
// compares per search step, far below the card's rate.  What competes with
// the device memory is the search: L dependent shared-memory loads a value,
// whose addresses depend on the value, so the deep levels' lanes fall on
// the same banks (profiling/profile_bin_predict.py --levels measures each
// level's cost).
//
// Design (binner.py:bin_plan decides every number named here).
//
//   * A persistent grid: ``groups * stripes`` blocks, one per SM.  Block b
//     takes feature group b % groups and walks the row tiles stripe,
//     stripe + stripes, ... of its stripe b / groups, so no wave of blocks
//     trails the others.  A small request spreads its features over more
//     groups instead, so 37 rows do not wait on one block.
//   * A feature group is a run of used features whose bounds rows and
//     metadata, beside the row-tile buffers, fit the block's shared memory
//     (up to 232,448 bytes, asked for with
//     cudaFuncAttributeMaxDynamicSharedMemorySize).  The last group also
//     writes the zero rows of the padding features, as part of each tile's
//     stores.  A block stages its group's bounds once, at its start, not
//     once per tile.  A bounds row wider than bin_plan's limit is searched
//     in global memory (read through the L1) and staged nowhere.
//   * Row tiles (``kRows``): the rows [r0, r1) of the row-major (n, ldx)
//     matrix are one contiguous run of doubles, brought into shared memory
//     by one bulk copy of the Tensor Memory Accelerator (cp.async.bulk),
//     started by the block's last warp, that completes on the buffer's
//     ``full`` mbarrier, in a ring of ``stages`` buffers: the next tiles
//     load while this one is searched, and device memory and the L2 see
//     each input byte once per group, coalesced.  Each consumer warp
//     arrives on the buffer's ``empty`` mbarrier when done with it, and the
//     producer refills it then: no block-wide barrier between tiles.  The
//     bulk copy needs 16-byte-aligned addresses and sizes: bin_plan reads
//     strided columns where the matrix does not start on a 16-byte
//     boundary, a tile of a multiple of 128 rows starts where its matrix
//     does, and the producer copies a tile's odd last double itself before
//     it arrives on ``full`` (the arrive releases that store to the
//     consumers that wait on the barrier).
//   * Strided reads (``!kRows``): where the model reads few of a wide
//     matrix's columns, where a task's rows are too wide to double-buffer,
//     or where a block walks too few tiles for the ring's first copy to pay
//     (at 100,000 rows, three a block, the strided reads took 9% less), a
//     warp reads its feature's column from global memory.
//   * The search: a task is one feature over 32 * kU consecutive rows
//     (kU = 4, 1,024 threads a block): a lane per 32-row chunk runs kU
//     independent descents interleaved, so a warp keeps kU loads in flight
//     (the search is latency-bound: time fell with every doubling of
//     threads and of kU up to these), and the codes of a row of
//     (f_pad, n) are written coalesced.  The consumer warps take the tasks
//     of successive tiles round robin.  The bounds row is kept in
//     Eytzinger order (the implicit binary tree in breadth-first order,
//     padded with +inf to 2^L - 1 nodes in binner.py:device_arrays): L
//     fixed, branchless steps, i = 2i + (t[i] < v), and the code is i - 2^L.
//     A tree level is contiguous, so the top levels are broadcasts or fall
//     in distinct banks, where a sorted row's midpoints of one step would
//     all share one bank.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;           // a block (one per SM)
constexpr int kU = 4;                    // rows of one feature a lane bins
constexpr int kMaxStages = 8;            // mbarriers in static shared memory
constexpr int kSmemLimit = 232448;       // a block's shared memory on the H100
constexpr int kOOV = 1 << 20;            // binner.py:OOV_BIN
constexpr int kMissingNaN = 2;           // binning.py:MISSING_NAN

// per-feature metadata columns of `meta` (fu, kMeta) int32
enum { M_COL = 0, M_MISSING, M_NAN_BIN, M_IS_CAT, M_CAT_MAX, kMeta };

struct Args {
  const double* x;            // (n, ldx) row-major
  long long ldx, n;
  long long tiles;            // row tiles of tile_rows rows
  long long stage_doubles;    // doubles of one row-tile buffer (even)
  const int32_t* meta;        // (fu, kMeta)
  const double* tree;         // (fu, W) Eytzinger rows, node 0 unused
  const int32_t* cat_lut;     // (fu, ncat)
  long long ncat;
  int32_t* out;               // (f_pad, n)
  int fu, f_pad, W, L;
  int group, groups, stripes, tile_rows, stages;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_addr(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(a), "r"(parity) : "memory");
  }
}

// One thread: start the copy of tile t into `buf`, completing on `bar`: the
// bulk copy of its even part, and a plain copy of an odd last double,
// released to the consumers by the arrive.
__device__ __forceinline__ void start_tile(const Args& a, long long t,
                                           double* buf, uint64_t* bar) {
  const long long r0 = t * a.tile_rows;
  const long long len = (min(a.n, r0 + a.tile_rows) - r0) * a.ldx;
  const double* src = a.x + r0 * a.ldx;
  const long long body = len & ~1LL;
  if (len & 1) buf[body] = __ldg(src + body);
  if (body > 0) {
    const uint32_t bytes = (uint32_t)(body * 8);
    mbar_expect_tx(bar, bytes);
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];\n"
        :: "r"(smem_addr(buf)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
        : "memory");
  } else {
    mbar_arrive(bar);
  }
}

// The codes of kU values v[u] of feature k (metadata row m): the NaN and
// categorical rules of the header, and for a numerical feature kU
// interleaved descents of its Eytzinger row at `base` in `tree` (shared or
// global memory), so a lane keeps kU independent loads in flight.
template <bool kShared>
__device__ __forceinline__ void bin_codes(const double (&v)[kU], const int* m,
                                          int k, const double* tree,
                                          long long base, const Args& a,
                                          int (&code)[kU]) {
  const bool nan_missing = m[M_MISSING] == kMissingNaN;
  if (m[M_IS_CAT] != 0) {
    const double cat_max = (double)m[M_CAT_MAX];
    const int32_t* lut = a.cat_lut + (long long)k * a.ncat;
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const double t = trunc(isnan(v[u]) ? 0.0 : v[u]);
      code[u] = (isnan(v[u]) && nan_missing) ? kOOV
                : (t >= 0.0 && t <= cat_max) ? __ldg(lut + (long long)t)
                                             : kOOV;
    }
    return;
  }
  const double* row = tree + base;
  double q[kU];
  int i[kU];
#pragma unroll
  for (int u = 0; u < kU; ++u) {
    q[u] = isnan(v[u]) ? 0.0 : v[u];
    i[u] = 1;
  }
  for (int l = 0; l < a.L; ++l) {
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const double b = kShared ? row[i[u]] : __ldg(row + i[u]);
      i[u] = 2 * i[u] + (b < q[u] ? 1 : 0);
    }
  }
  const int nan_bin = m[M_NAN_BIN];
#pragma unroll
  for (int u = 0; u < kU; ++u)
    code[u] = (isnan(v[u]) && nan_missing) ? nan_bin : i[u] - a.W;
}

// kRows: row tiles staged by the last warp (the producer) through bulk
// copies; else the used columns read strided.  kStaged: bounds rows in
// shared memory.  A task is one feature over 32 * kU consecutive rows, a
// lane per row and chunk of 32.
template <bool kRows, bool kStaged>
__global__ void __launch_bounds__(kThreads, 1)
bin_predict_rows(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ __align__(8) uint64_t full[kMaxStages];
  __shared__ __align__(8) uint64_t empty[kMaxStages];
  const int g = blockIdx.x % a.groups;
  const long long stripe = blockIdx.x / a.groups;
  const int k0 = g * a.group;
  // the last group also writes the padding features' zero rows
  const int k1 = g == a.groups - 1 ? a.f_pad : min(a.fu, k0 + a.group);
  const int nk = k1 - k0;                      // features this block writes
  const int ku = max(0, min(k1, a.fu) - k0);   // of them used
  double* tiles = reinterpret_cast<double*>(smem);
  double* stree = tiles + (kRows ? a.stages * a.stage_doubles : 0);
  int* smeta = reinterpret_cast<int*>(
      stree + (kStaged ? (long long)a.group * a.W : 0));
  // this block's tiles: stripe, stripe + stripes, ...
  const long long ntile = (a.tiles - stripe + a.stripes - 1) / a.stripes;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  // in kRows the last warp produces and the others consume
  const int consumers = kRows ? nwarps - 1 : nwarps;
  const bool producer = kRows && warp == nwarps - 1;

  if (kRows && threadIdx.x == 0) {
    for (int s = 0; s < a.stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], consumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (producer && lane == 0) {
    const long long first = min((long long)a.stages, ntile);
    for (long long j = 0; j < first; ++j)
      start_tile(a, stripe + j * a.stripes, tiles + j * a.stage_doubles,
                 &full[j]);
  }
  // tasks of a tile: nk features x chunks of 32 * kU rows; the consumer
  // warps take them round robin across tiles, so no warp waits at a tile's
  // end for the others
  const int chunk = 32 * kU;
  const long long per_tile =
      (long long)nk * ((a.tile_rows + chunk - 1) / chunk);
  // the group's metadata and search rows, once per block, while the first
  // tiles load
  for (int i = threadIdx.x; i < ku * kMeta; i += blockDim.x)
    smeta[i] = __ldg(a.meta + (long long)k0 * kMeta + i);
  if (kStaged) {
    const double2* src =
        reinterpret_cast<const double2*>(a.tree + (long long)k0 * a.W);
    double2* dst = reinterpret_cast<double2*>(stree);
    const int pairs = ku * (a.W >> 1);
    for (int i = threadIdx.x; i < pairs; i += blockDim.x)
      dst[i] = __ldg(src + i);
  }
  __syncthreads();

  if (producer) {
    // refill each buffer once every consumer warp is done with it
    if (lane == 0)
      for (long long j = a.stages; j < ntile; ++j) {
        const int s = (int)(j % a.stages);
        mbar_wait(&empty[s], (uint32_t)(((j / a.stages) + 1) & 1));
        start_tile(a, stripe + j * a.stripes, tiles + s * a.stage_doubles,
                   &full[s]);
      }
    return;
  }
  for (long long j = 0; j < ntile; ++j) {
    const long long t = stripe + j * a.stripes;
    const long long r0 = t * a.tile_rows;
    const int nr = (int)(min(a.n, r0 + a.tile_rows) - r0);
    const double* src = a.x + r0 * a.ldx;
    const int s = kRows ? (int)(j % a.stages) : 0;
    const double* stile = tiles + s * a.stage_doubles;
    if constexpr (kRows)
      mbar_wait(&full[s], (uint32_t)((j / a.stages) & 1));
    const long long first = j * per_tile;
    long long task = (warp - first) % consumers;
    if (task < 0) task += consumers;
    for (; task < per_tile; task += consumers) {
      const int kk = (int)(task % nk);
      const int rb = (int)(task / nk) * chunk + lane;   // rows in the tile
      if (rb >= nr) continue;
      const int k = k0 + kk;
      int code[kU] = {};
      if (kk < ku) {
        const int* m = smeta + kk * kMeta;
        const int col = m[M_COL];
        double v[kU];
#pragma unroll
        for (int u = 0; u < kU; ++u) {
          const int r = min(rb + 32 * u, nr - 1);
          const long long e = (long long)r * a.ldx + col;
          v[u] = kRows ? stile[e] : __ldg(src + e);
        }
        if constexpr (kStaged)
          bin_codes<true>(v, m, k, stree, (long long)kk * a.W, a, code);
        else
          bin_codes<false>(v, m, k, a.tree, (long long)k * a.W, a, code);
      }
      int32_t* o = a.out + (long long)k * a.n + r0;
#pragma unroll
      for (int u = 0; u < kU; ++u)
        if (rb + 32 * u < nr) o[rb + 32 * u] = code[u];
    }
    if constexpr (kRows) {
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
    }
  }
}

}  // namespace

extern "C" {

// x: (n, ldx) float64 row-major raw matrix, 8-byte aligned (16 to read
// row tiles); meta: (fu, 5) int32 (column, missing type, nan bin, is
// categorical, cat_max); tree: (fu, W) float64 Eytzinger rows (W a power of
// two, node 0 unused); cat_lut: (fu, ncat) int32; out: (f_pad, n) int32.
// The rest is binner.py:bin_plan's: read whole row tiles (rows) or the used
// columns, stage the bounds rows (staged), features per group, groups, row
// stripes per group, rows per tile, tile buffers, doubles per buffer and
// dynamic shared memory bytes.  Returns the CUDA error of the attribute
// call or the launch (0 on success).
int lgbt_bin_predict(const double* x, long long ldx, long long n, int fu,
                     int f_pad, const int32_t* meta, const double* tree,
                     int W, const int32_t* cat_lut, long long ncat,
                     int32_t* out, int rows, int staged, int group,
                     int groups, int stripes, int tile_rows, int stages,
                     long long stage_doubles, long long smem,
                     cudaStream_t stream) {
  if (n <= 0 || f_pad <= 0) return 0;
  int L = 0;
  while ((1 << L) < W && L < 30) ++L;
  if (W < 2 || (1 << L) != W || ldx < 1 || fu < 0 || fu > f_pad ||
      group < 1 || groups < 1 || stripes < 1 || tile_rows < 1 ||
      smem < 0 || smem > kSmemLimit - 2 * kMaxStages * 8 ||
      (long long)groups * group < fu ||
      (long long)groups * stripes > 0x7fffffffLL ||
      (rows && (stages < 1 || stages > kMaxStages ||
                stage_doubles < (long long)tile_rows * ldx ||
                stage_doubles % 2 != 0 ||
                reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
                (long long)tile_rows * ldx % 2 != 0)))
    return (int)cudaErrorInvalidValue;
  void (*const kernels[4])(const Args) = {
      bin_predict_rows<false, false>, bin_predict_rows<false, true>,
      bin_predict_rows<true, false>, bin_predict_rows<true, true>};
  const int variant = (rows ? 2 : 0) + (staged ? 1 : 0);
  // the dynamic shared-memory limit, raised per device and variant to the
  // largest size asked so far
  static long long raised[64][4] = {{0}};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (smem > 48 * 1024 && (dev >= 64 || smem > raised[dev][variant])) {
    err = cudaFuncSetAttribute(kernels[variant],
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    if (dev < 64) raised[dev][variant] = smem;
  }
  Args a;
  a.x = x;
  a.ldx = ldx;
  a.n = n;
  a.tiles = (n + tile_rows - 1) / tile_rows;
  a.stage_doubles = rows ? stage_doubles : 0;
  a.meta = meta;
  a.tree = tree;
  a.cat_lut = cat_lut;
  a.ncat = ncat;
  a.out = out;
  a.fu = fu;
  a.f_pad = f_pad;
  a.W = W;
  a.L = L;
  a.group = group;
  a.groups = groups;
  a.stripes = stripes;
  a.tile_rows = tile_rows;
  a.stages = rows ? stages : 0;
  if (stripes > a.tiles) return (int)cudaErrorInvalidValue;
  kernels[variant]<<<groups * stripes, kThreads, (size_t)smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
