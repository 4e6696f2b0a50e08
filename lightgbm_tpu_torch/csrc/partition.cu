// Stable row partitions for the frontier-wave and compact learners, written
// for Hopper (sm_90a): the whole-N permutation below, and the windowed split
// of one leaf further down (lgbt_partition_window).
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

// ---------------------------------------------------------------------------
// Windowed partition: the compact learner's DataPartition::Split.
//
// Replaces the compact learner's window split in the JAX package
// (lightgbm_tpu/learner_compact.py:265 _make_partition_branch, a stable
// one-bit-key lax.sort over a power-of-two bucket of the parent's window;
// the TPU partition kernel above computes the same permutation for the wave
// learner).  One split of leaf `leaf` at rows [s, s + c) of the four lanes,
// every number of it read from device memory (split, a vector of eight
// int64: leaf, new_leaf, feature, threshold, flags, do, s, c), so the
// learner's step never reads the window to the host:
//
//   go_left(r)  the split's decision on row r (NumericalDecisionInner,
//               tree.h:233-249, with the EFB bundle decode and the missing
//               rule; CategoricalDecisionInner, tree.h:270-277: bit
//               bin & 31 of the bitset's word bin >> 5), from the feature's
//               byte of its packed word (ftab: the per-feature decode table)
//   sort mode   (c > mask_max, the learner's tpu_sort_cutoff rule): the
//               window is stably partitioned in place, left rows first, then
//               right, each in row order; left rows keep leaf, right rows
//               get new_leaf
//   mask mode   (c <= mask_max): no row moves; rows of `leaf` that go right
//               get new_leaf, and both children keep the parent's window
//   do == 0     nothing is read or written but `out`
//
// out (six int64): the children's windows [ls, lw, rs, rw] and the bagged
// counts [left, all] (a row is bagged where its lane-2 weight is > 0.5; in
// mask mode only rows of `leaf` count).
//
// Design.  The grid is sized on the host from the padded row count (one block
// per kWinTile = 2,048 rows); blocks whose tile starts at or past c exit at
// once.  Three launches on the stream:
//  1. count:   each block decides its rows and writes its left, bagged-left
//              and bagged counts to blk (mask mode: rewrites the leaf ids);
//  2. scatter: each block sums the counts of the blocks before it (the
//              stable order across blocks: a scan of per-block left counts)
//              and of all blocks (the left total), ranks its rows' flags in
//              row order with warp ballots, and moves every lane of each row
//              to its place in a scratch set of lanes; block 0 writes out;
//  3. copy:    the scratch rows [0, c) back to [s, s + c).
//
// Bound.  In sort mode the function must read and write the window's lanes
// once: 2 * c * (Fw*4 + 3*4 + 8 + 4) bytes (at Fw = 8 and c = 1,000,448,
// 112 MB, 34 us at 3.35 TB/s); in mask mode read the feature's word, the bag
// lane and the leaf ids and write the leaf ids: 16 * c bytes.  The scratch
// round trip doubles the sort mode's traffic (a later design could
// ping-pong lane sets instead).

constexpr int kWinThreads = 256;
constexpr int kWinRows = 8;                        // rows a thread takes
constexpr int kWinTile = kWinThreads * kWinRows;   // rows a block takes
constexpr int kWinWarps = kWinThreads / 32;
constexpr unsigned kFullMask = 0xFFFFFFFFu;

// fields of the split vector and columns of the feature decode table
enum { kLeaf, kNew, kFeat, kThr, kFlags, kDo, kStart, kCount };
enum { kWidx, kShift, kMt, kDb, kNb, kBoff, kBnd, kFtabCols };

struct Win {
  long long s, c;   // window start, rows taken (0 when do is 0)
  bool sort, dleft, cat, bnd;
  int leaf, new_leaf, thr, shift, mt, db, nb, boff;
  long long widx;
};

__device__ Win load_win(const long long* split, const long long* ftab,
                        long long mask_max) {
  Win v;
  const long long* t = ftab + split[kFeat] * kFtabCols;
  v.s = split[kStart];
  v.c = split[kDo] != 0 ? split[kCount] : 0;
  v.sort = v.c > mask_max;
  v.leaf = (int)split[kLeaf];
  v.new_leaf = (int)split[kNew];
  v.thr = (int)split[kThr];
  v.dleft = (split[kFlags] & 1) != 0;
  v.cat = (split[kFlags] & 2) != 0;
  v.widx = t[kWidx];
  v.shift = (int)t[kShift];
  v.mt = (int)t[kMt];
  v.db = (int)t[kDb];
  v.nb = (int)t[kNb];
  v.boff = (int)t[kBoff];
  v.bnd = t[kBnd] != 0;
  return v;
}

__device__ __forceinline__ bool decide(const int32_t* __restrict__ bins,
                                       long long n, long long r,
                                       const Win& v,
                                       const int32_t* __restrict__ bits,
                                       int nwords) {
  const uint32_t word = (uint32_t)bins[v.widx * n + r];
  int frow = (int)((word >> v.shift) & 0xFFu);
  if (v.bnd) {
    // a bundle code outside this feature's range: it sits at its default
    const int rr = frow - v.boff;
    frow = (rr >= 0 && rr < v.nb - 1) ? rr + (rr >= v.db ? 1 : 0) : v.db;
  }
  if (v.cat && bits != nullptr) {
    const int wi = min(frow >> 5, nwords - 1);
    return ((bits[wi] >> (frow & 31)) & 1) != 0;
  }
  const bool missing =
      (v.mt == 1 && frow == v.db) || (v.mt == 2 && frow == v.nb - 1);
  return missing ? v.dleft : frow <= v.thr;
}

__device__ __forceinline__ int warp_sum(int x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_down_sync(kFullMask, x, o);
  return x;
}

// Sum each of the K per-thread values over the block; every thread gets the
// totals.  `sm` holds K * kWinWarps ints.
template <int K>
__device__ void block_sums(int (&a)[K], int* sm) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int x = warp_sum(a[k]);
    if (lane == 0) sm[k * kWinWarps + warp] = x;
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < K; ++k) {
    int t = 0;
    for (int q = 0; q < kWinWarps; ++q) t += sm[k * kWinWarps + q];
    a[k] = t;
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kWinThreads)
partition_window_count(const int32_t* __restrict__ bins,
                       const float* __restrict__ w, int32_t* __restrict__ lid,
                       long long n, const long long* __restrict__ split,
                       const long long* __restrict__ ftab,
                       const int32_t* __restrict__ bits, int nwords,
                       long long mask_max, int* __restrict__ blk) {
  __shared__ int sm[3 * kWinWarps];
  const Win v = load_win(split, ftab, mask_max);
  const long long base = (long long)blockIdx.x * kWinTile;
  if (base >= v.c) return;
  int a[3] = {0, 0, 0};   // lefts, bagged lefts, bagged
  for (int j = 0; j < kWinRows; ++j) {
    const long long off = base + (long long)j * kWinThreads + threadIdx.x;
    if (off >= v.c) break;
    const long long r = v.s + off;
    const bool gl = decide(bins, n, r, v, bits, nwords);
    const bool bag = w[2 * n + r] > 0.5f;
    if (v.sort) {
      a[0] += gl;
      a[1] += gl && bag;
      a[2] += bag;
    } else {
      const bool seg = lid[r] == v.leaf;
      if (seg && !gl) lid[r] = v.new_leaf;
      a[1] += seg && gl && bag;
      a[2] += seg && bag;
    }
  }
  block_sums<3>(a, sm);
  if (threadIdx.x < 3) blk[3 * blockIdx.x + threadIdx.x] = a[threadIdx.x];
}

__global__ void __launch_bounds__(kWinThreads)
partition_window_scatter(const int32_t* __restrict__ bins, int fw,
                         const uint32_t* __restrict__ w,
                         const int64_t* __restrict__ rid, long long n,
                         const long long* __restrict__ split,
                         const long long* __restrict__ ftab,
                         const int32_t* __restrict__ bits, int nwords,
                         long long mask_max, const int* __restrict__ blk,
                         int32_t* __restrict__ sbins,
                         uint32_t* __restrict__ sw,
                         int64_t* __restrict__ srid,
                         int32_t* __restrict__ slid,
                         long long* __restrict__ out) {
  __shared__ int sm[4 * kWinWarps];
  __shared__ int wsum[kWinWarps];
  const Win v = load_win(split, ftab, mask_max);
  const long long base = (long long)blockIdx.x * kWinTile;
  const bool first = blockIdx.x == 0;
  const bool moves = v.sort && base < v.c;
  if (!first && !moves) return;
  // the active blocks' totals, and the lefts of the blocks before this one
  const long long nact = (v.c + kWinTile - 1) / kWinTile;
  int a[4] = {0, 0, 0, 0};  // lefts, bagged lefts, bagged, lefts before
  for (long long i = threadIdx.x; i < nact; i += kWinThreads) {
    a[0] += blk[3 * i];
    a[1] += blk[3 * i + 1];
    a[2] += blk[3 * i + 2];
    if (i < blockIdx.x) a[3] += blk[3 * i];
  }
  block_sums<4>(a, sm);
  const long long total = a[0];
  if (first && threadIdx.x == 0) {
    out[0] = v.s;
    out[1] = v.sort ? total : v.c;
    out[2] = v.sort ? v.s + total : v.s;
    out[3] = v.sort ? v.c - total : v.c;
    out[4] = a[1];
    out[5] = a[2];
  }
  if (!moves) return;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  long long run = a[3];          // lefts of the window before this chunk
  for (int j = 0; j < kWinRows; ++j) {
    const long long off = base + (long long)j * kWinThreads + threadIdx.x;
    const bool live = off < v.c;
    const long long r = v.s + off;
    const bool gl = live && decide(bins, n, r, v, bits, nwords);
    const unsigned bal = __ballot_sync(kFullMask, gl);
    if (lane == 0) wsum[warp] = __popc(bal);
    __syncthreads();
    int before = 0, chunk = 0;
    for (int q = 0; q < kWinWarps; ++q) {
      const int x = wsum[q];
      before += q < warp ? x : 0;
      chunk += x;
    }
    __syncthreads();
    if (live) {
      // lefts of the window before this row
      const long long rank = run + before + __popc(bal & ((1u << lane) - 1u));
      const long long d = gl ? rank : total + (off - rank);
      for (int k = 0; k < fw; ++k) sbins[k * n + d] = bins[k * n + r];
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) sw[ch * n + d] = w[ch * n + r];
      srid[d] = rid[r];
      slid[d] = gl ? v.leaf : v.new_leaf;
    }
    run += chunk;
  }
}

__global__ void __launch_bounds__(kWinThreads)
partition_window_copy(int32_t* __restrict__ bins, int fw,
                      uint32_t* __restrict__ w, int64_t* __restrict__ rid,
                      int32_t* __restrict__ lid, long long n,
                      const long long* __restrict__ split,
                      const long long* __restrict__ ftab, long long mask_max,
                      const int32_t* __restrict__ sbins,
                      const uint32_t* __restrict__ sw,
                      const int64_t* __restrict__ srid,
                      const int32_t* __restrict__ slid) {
  const Win v = load_win(split, ftab, mask_max);
  const long long base = (long long)blockIdx.x * kWinTile;
  if (!v.sort || base >= v.c) return;
  for (int j = 0; j < kWinRows; ++j) {
    const long long off = base + (long long)j * kWinThreads + threadIdx.x;
    if (off >= v.c) break;
    const long long r = v.s + off;
    for (int k = 0; k < fw; ++k) bins[k * n + r] = sbins[k * n + off];
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) w[ch * n + r] = sw[ch * n + off];
    rid[r] = srid[off];
    lid[r] = slid[off];
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

// The windowed split of one leaf (see above), launched on `stream` as three
// kernels over ceil(n / 2048) blocks.  The lanes are updated in place; the
// scratch lanes have the lanes' shapes; blk holds 3 ints per block; out
// six int64.  Returns the first launch error (0 = launched).
int lgbt_partition_window(void* bins, int fw, void* w, void* rid, void* lid,
                          int n, const void* split, const void* ftab,
                          const void* bits, int nwords, long long mask_max,
                          void* sbins, void* sw, void* srid, void* slid,
                          void* blk, void* out, void* stream) {
  const unsigned grid = (unsigned)(((long long)n + kWinTile - 1) / kWinTile);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long* sp = static_cast<const long long*>(split);
  const long long* ft = static_cast<const long long*>(ftab);
  const int32_t* bt = static_cast<const int32_t*>(bits);
  partition_window_count<<<grid, kWinThreads, 0, st>>>(
      static_cast<const int32_t*>(bins), static_cast<const float*>(w),
      static_cast<int32_t*>(lid), n, sp, ft, bt, nwords, mask_max,
      static_cast<int*>(blk));
  int err = (int)cudaGetLastError();
  if (err != 0) return err;
  partition_window_scatter<<<grid, kWinThreads, 0, st>>>(
      static_cast<const int32_t*>(bins), fw,
      static_cast<const uint32_t*>(w), static_cast<const int64_t*>(rid), n,
      sp, ft, bt, nwords, mask_max, static_cast<const int*>(blk),
      static_cast<int32_t*>(sbins), static_cast<uint32_t*>(sw),
      static_cast<int64_t*>(srid), static_cast<int32_t*>(slid),
      static_cast<long long*>(out));
  err = (int)cudaGetLastError();
  if (err != 0) return err;
  partition_window_copy<<<grid, kWinThreads, 0, st>>>(
      static_cast<int32_t*>(bins), fw, static_cast<uint32_t*>(w),
      static_cast<int64_t*>(rid), static_cast<int32_t*>(lid), n, sp, ft,
      mask_max, static_cast<const int32_t*>(sbins),
      static_cast<const uint32_t*>(sw), static_cast<const int64_t*>(srid),
      static_cast<const int32_t*>(slid));
  return (int)cudaGetLastError();
}

}  // extern "C"
