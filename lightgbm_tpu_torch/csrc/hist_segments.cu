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
//   start, cnt, leaf : (K,) int64 per member (device arrays: the learner does
//           not read the windows back to the host)
//   out   : (K, 4*Fw, nbins, 3) float32; codes >= nbins are dropped
//   quant : the quantized-gradient mode, as in hist_packed.cu: channel 2
//           accumulates lane 1 (h), not lane 2 (bag)
//
// Member ranges may start at any row and may overlap (frozen members share
// their parent's span and are told apart by their leaf id).
//
// Bound.  The function must read lid once for every row of the union of the
// member ranges (4 bytes), the words and weights once for every row that
// matches its member's leaf (Fw*4 + 3*4 bytes), and write the output
// K * 4*Fw * nbins * 3 * 4 bytes, at 3.35 TB/s: about 16 us for a wave of
// 64 members over 1M rows at Fw = 8.
//
// Design: the work is divided by rows, and each row is read once.
//
//  * The tile table.  Member m's rows are cut into ceil(cnt[m] / kTile)
//    tiles of kTile = 64 rows; an exclusive scan of those counts over the
//    members numbers every tile of the wave (ops/hist_segments.py:
//    segment_tile_plan is the same plan in torch, and the CPU tests check
//    that it covers every row of every member exactly once).  Each block
//    forms the scan itself from the device counts, so the host reads
//    nothing back.  The grid holds G blocks, G sized on the host from an
//    upper bound on the rows (one block per 256 rows; the wave learner
//    passes its padded row count, known with no read) and capped at the
//    blocks the card holds at once; block b takes the q = ceil(tiles / G)
//    consecutive tiles [b*q, (b+1)*q), so every block gets the same number
//    of rows whatever the member sizes, and blocks past the real count
//    exit.  Many small members of a late wave and a K = 1 stall correction
//    fill the card alike.
//  * One block takes all Fw word lanes of its rows (up to 8, a warp each;
//    wider words take a second grid row).  It stages each tile's lid and
//    weight lanes, and every lane's words, in shared memory once with
//    cp.async, three stages deep: two tiles' copies are in flight while the
//    warps bin a third.  So lid and the weights are read from device memory
//    once per row (once per 8 word lanes past Fw = 8), not once per lane.
//  * Warp k owns word lane k's four features: its 4 * nbins * 3 float
//    histogram (12 KB at 255 bins) is the only copy of those bins in the
//    block, so there is no cross-warp merge.  Lanes that hold one bin find
//    each other through integer ORs into a 256-word mask (no
//    __match_any_sync, whose throughput set the pace of the first design),
//    and the group's lowest lane adds the group's sum, in lane (row) order:
//    every bin has one writer.  Histograms, masks and stages take 113 KB at
//    Fw = 8 and 255 bins: two blocks, 16 warps, per SM.
//  * Determinism.  A block walks its tiles in order and flushes a member's
//    histogram when its tiles end: straight into out when the block holds
//    all of the member's tiles, else into the partial slot b + m (unique:
//    the members a block touches follow those of the block before), and
//    records its block as the member's first or last.  The second pass
//    sums a member's partials over its blocks in a fixed order (eight
//    consecutive runs, then the runs in order) and writes zeros for members
//    with no rows; it exits at once for the others.  The plan depends only
//    on (cnt, G, Fw), so two launches on the same input are bitwise equal.
//    No float atomics.
//  * The shared-memory limit is raised once per device, not per call.
//
// What limits it now: the binning's dependent shared-memory chain (an OR,
// a read-back and a read-modify-write per row-feature, four features in
// turn) with 16 warps per SM to hide it, the per-tile barriers, and for
// small launches the 98 KB of partial histograms a block writes and the
// second pass reads.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;      // rows per tile, one pipeline stage
constexpr int kMask = 256;     // group-mask words per warp, one per code
constexpr int kStages = 3;     // tiles in shared memory: two in flight
constexpr int kParts = 8;      // partial ranges one reduce block sums apart
constexpr int kLanesMax = 8;   // word lanes (warps) per block
constexpr unsigned kFull = 0xFFFFFFFFu;

__device__ __forceinline__ long long tiles_of(long long c) {
  return c <= 0 ? 0 : (c + kTile - 1) / kTile;
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most kStages - 1 of this thread's copy groups are pending.
__device__ __forceinline__ void cp_async_wait_stages() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 1));
}

// Inclusive scan of x over the block (blockDim.x a multiple of 32, at most
// 32 warps); `total` gets the block's sum.  Every thread must call it.
__device__ long long block_scan(long long x, long long* s_warp,
                                long long& total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  for (int o = 1; o < 32; o <<= 1) {
    const long long y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) s_warp[warp] = x;
  __syncthreads();
  long long before = 0, sum = 0;
  for (int i = 0; i < nwarps; ++i) {
    const long long v = s_warp[i];
    if (i < warp) before += v;
    sum += v;
  }
  __syncthreads();
  total = sum;
  return x + before;
}

// Total tiles of the K members.  Every thread must call it.
__device__ long long total_tiles(const long long* cnt, int K,
                                 long long* s_warp) {
  long long total = 0;
  for (int c0 = 0; c0 < K; c0 += blockDim.x) {
    const int m = c0 + threadIdx.x;
    long long t;
    block_scan(m < K ? tiles_of(cnt[m]) : 0, s_warp, t);
    total += t;
  }
  return total;
}

// The walk over the tile table: member m holds tiles [first, first + nt).
struct Cursor {
  int m;
  long long first, nt, start, cnt;
  int leaf;
};

__device__ __forceinline__ void load_member(Cursor& c, const long long* start,
                                            const long long* cnt,
                                            const long long* leaf) {
  c.cnt = cnt[c.m];
  c.nt = tiles_of(c.cnt);
  c.start = start[c.m];
  c.leaf = static_cast<int>(leaf[c.m]);
}

// Advance the cursor to the member holding tile t (t < total tiles).
__device__ __forceinline__ void seek(Cursor& c, long long t,
                                     const long long* start,
                                     const long long* cnt,
                                     const long long* leaf) {
  while (t >= c.first + c.nt) {
    c.first += c.nt;
    ++c.m;
    load_member(c, start, cnt, leaf);
  }
}

struct Tile {
  int m, leaf, nrows;
  long long first, nt, row0;
};

__device__ __forceinline__ Tile tile_of(const Cursor& c, long long t) {
  Tile ti;
  const long long j = t - c.first;
  ti.m = c.m;
  ti.leaf = c.leaf;
  ti.first = c.first;
  ti.nt = c.nt;
  ti.row0 = c.start + j * kTile;
  const long long left = c.cnt - j * kTile;
  ti.nrows = static_cast<int>(left < kTile ? left : kTile);
  return ti;
}

// Shared-memory stage of one tile: lid, g, h, c, then nw word lanes.
struct Stage {
  int32_t* lid;
  float *g, *h, *c;
  uint32_t* words;
};

__device__ __forceinline__ Stage stage_at(float* base, int nw) {
  Stage s;
  s.lid = reinterpret_cast<int32_t*>(base);
  s.g = base + kTile;
  s.h = base + 2 * kTile;
  s.c = base + 3 * kTile;
  s.words = reinterpret_cast<uint32_t*>(base + 4 * kTile);
  return s;
}

// Copy tile ti's lid, weights and the block's word lanes into stage s.
__device__ __forceinline__ void issue(const Tile& ti, const Stage& s,
                                      const int32_t* words, const float* w,
                                      const int32_t* lid, long long n, int fw,
                                      int lane0, int nw, int quant) {
  const int arrays = 4 + nw;
  for (int e = threadIdx.x; e < arrays * kTile; e += blockDim.x) {
    const int a = e / kTile;
    const int i = e - a * kTile;
    const long long r = ti.row0 + i;
    if (i >= ti.nrows || r < 0 || r >= n) continue;
    if (a == 0) {
      cp_async4(s.lid + i, lid + r);
    } else if (a < 4) {
      if (a == 3 && quant) continue;  // channel 2 reads lane 1
      float* dst = a == 1 ? s.g : (a == 2 ? s.h : s.c);
      cp_async4(dst + i, w + (long long)(a - 1) * n + r);
    } else {
      const int k = lane0 + a - 4;
      if (k < fw) cp_async4(s.words + (a - 4) * kTile + i,
                            words + (long long)k * n + r);
    }
  }
}

// Warp `warp` adds tile ti's matching rows of its word lane to `mine`.
// For each of the four byte planes, the lanes holding one bin find each
// other through `msk` (256 words, zero between uses): every lane ORs its bit
// into its bin's word, reads the word back as its group, and the group's
// lowest lane adds the group's sum, in lane (row) order, and clears the
// word.  Integer ORs commute, so the groups, and every sum's order, are the
// same on every launch.
__device__ __forceinline__ void accumulate(const Tile& ti, const Stage& s,
                                           int warp, long long n, int nbins,
                                           int quant, float* mine,
                                           uint32_t* msk) {
  const int lane = threadIdx.x & 31;
  const float* sc = quant ? s.h : s.c;
  const uint32_t* sw = s.words + warp * kTile;
  for (int i0 = 0; i0 < ti.nrows; i0 += 32) {
    const int i = i0 + lane;
    const long long r = ti.row0 + i;
    bool act = false;
    uint32_t word = 0u;
    float g = 0.0f, h = 0.0f, c = 0.0f;
    if (i < ti.nrows && r >= 0 && r < n && s.lid[i] == ti.leaf) {
      g = s.g[i];
      h = s.h[i];
      c = sc[i];
      act = g != 0.0f || h != 0.0f || c != 0.0f;
      word = sw[i];
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const uint32_t code = (word >> (8 * q)) & 0xFFu;
      const bool in = act && code < static_cast<uint32_t>(nbins);
      if (in) atomicOr(msk + code, 1u << lane);
      __syncwarp();
      const uint32_t group = in ? msk[code] : 0u;
      __syncwarp();
      if (in && lane == __ffs(group) - 1) {
        float sg = g, sh = h, sx = c;
        uint32_t mm = group & (group - 1);  // the members after this lane
        while (mm) {
          const int j = i0 + __ffs(mm) - 1;
          mm &= mm - 1;
          sg += s.g[j];
          sh += s.h[j];
          sx += sc[j];
        }
        float* d = mine + (q * nbins + static_cast<int>(code)) * 3;
        d[0] += sg;
        d[1] += sh;
        d[2] += sx;
        msk[code] = 0u;
      }
      __syncwarp();
    }
  }
}

// Warp-private: write `mine` (E floats) to dst and clear it.
__device__ __forceinline__ void flush(float* mine, float* dst, int E) {
  const int lane = threadIdx.x & 31;
  __syncwarp();
  float4* s4 = reinterpret_cast<float4*>(mine);
  float4* d4 = reinterpret_cast<float4*>(dst);
  for (int e = lane; e < E / 4; e += 32) {
    d4[e] = s4[e];
    s4[e] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
  __syncwarp();
}

// The block's rows of member m (tiles [first, first + nt)) end: each warp
// writes its histogram straight into out when the block holds all of the
// member's tiles, else into the partial slot b + m; thread 0 records the
// block as the member's first (seg[2m]) or last (seg[2m + 1]) where it is.
__device__ __forceinline__ void finish(int m, long long first, long long nt,
                                       long long t0, long long t1,
                                       long long b, int k, int fw, int E,
                                       float* mine, float* partial,
                                       int32_t* seg, float* out) {
  const bool has_first = first >= t0;
  const bool has_last = first + nt <= t1;
  if (k < fw) {
    float* dst = has_first && has_last
        ? out + ((long long)m * fw + k) * E
        : partial + ((b + m) * fw + k) * (long long)E;
    flush(mine, dst, E);
  }
  if (threadIdx.x == 0) {
    if (has_first) seg[2 * m] = static_cast<int32_t>(b);
    if (has_last) seg[2 * m + 1] = static_cast<int32_t>(b);
  }
}

// The prologue's scratch (scan partials, the first member) lives in the
// first stage, which no copy touches before the prologue ends.
struct Prologue {
  long long warp_sums[kLanesMax];
  long long first;
  int member;
};

__global__ void __launch_bounds__(kLanesMax * 32, 2)
hist_segments_tiles(const int32_t* __restrict__ words,
                    const float* __restrict__ w,
                    const int32_t* __restrict__ lid, long long n, int fw,
                    const long long* __restrict__ start,
                    const long long* __restrict__ cnt,
                    const long long* __restrict__ leaf, int K, int nbins,
                    int quant, float* __restrict__ partial,
                    int32_t* __restrict__ seg, float* __restrict__ out) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int nw = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5;
  const int lane0 = blockIdx.y * kLanesMax;
  const int k = lane0 + warp;  // this warp's word lane
  const int E = 4 * nbins * 3;
  const long long b = blockIdx.x;
  const long long G = gridDim.x;
  float* hist = smem;                                          // nw * E
  uint32_t* masks = reinterpret_cast<uint32_t*>(smem + nw * E);  // nw * 256
  float* stages = smem + nw * (E + kMask);        // kStages tiles
  const int stage_floats = kTile * (4 + nw);
  Prologue& pro = *reinterpret_cast<Prologue*>(stages);

  const long long total = total_tiles(cnt, K, pro.warp_sums);
  const long long q = (total + G - 1) / G;
  const long long t0 = b * q;
  if (t0 >= total) return;  // uniform: past the wave's rows
  const long long t1 = t0 + q < total ? t0 + q : total;

  // the member holding tile t0: a chunked scan of the tile counts
  long long base = 0;
  for (int c0 = 0; c0 < K && base <= t0; c0 += blockDim.x) {
    const int m = c0 + threadIdx.x;
    const long long nt = m < K ? tiles_of(cnt[m]) : 0;
    long long chunk;
    const long long incl = block_scan(nt, pro.warp_sums, chunk);
    if (nt > 0 && base + incl - nt <= t0 && t0 < base + incl) {
      pro.member = m;
      pro.first = base + incl - nt;
    }
    base += chunk;
  }
  for (int e = threadIdx.x; e < nw * (E + kMask); e += blockDim.x)
    smem[e] = 0.0f;  // the histograms and the group masks
  __syncthreads();
  Cursor cur;  // the tile being accumulated
  cur.m = pro.member;
  cur.first = pro.first;
  load_member(cur, start, cnt, leaf);
  __syncthreads();  // the prologue's scratch is read: the stages are free
  Cursor iss = cur;  // the tile whose copies are issued, kStages - 1 ahead
  for (int j = 0; j < kStages - 1; ++j) {
    if (t0 + j < t1) {
      seek(iss, t0 + j, start, cnt, leaf);
      issue(tile_of(iss, t0 + j), stage_at(stages + j * stage_floats, nw),
            words, w, lid, n, fw, lane0, nw, quant);
    }
    cp_async_commit();
  }
  float* mine = hist + warp * E;
  int acc_m = -1;  // the member being accumulated
  long long acc_first = 0, acc_nt = 0;
  for (long long t = t0; t < t1; ++t) {
    const long long ta = t + kStages - 1;
    if (ta < t1) {
      seek(iss, ta, start, cnt, leaf);
      issue(tile_of(iss, ta),
            stage_at(stages + ((ta - t0) % kStages) * stage_floats, nw),
            words, w, lid, n, fw, lane0, nw, quant);
    }
    cp_async_commit();
    cp_async_wait_stages();  // tile t's copies (this thread's) have landed
    __syncthreads();         // ... and every thread's
    seek(cur, t, start, cnt, leaf);
    const Tile ti = tile_of(cur, t);
    if (ti.m != acc_m) {
      if (acc_m >= 0)
        finish(acc_m, acc_first, acc_nt, t0, t1, b, k, fw, E, mine, partial,
               seg, out);
      acc_m = ti.m;
      acc_first = ti.first;
      acc_nt = ti.nt;
    }
    if (k < fw)
      accumulate(ti, stage_at(stages + ((t - t0) % kStages) * stage_floats,
                              nw),
                 warp, n, nbins, quant, mine, masks + warp * kMask);
    __syncthreads();  // the stage is free for the copies of a later tile
  }
  finish(acc_m, acc_first, acc_nt, t0, t1, b, k, fw, E, mine, partial, seg,
         out);
}

// out[m] = the sum of member m's partials in block order, for every member
// whose tiles span more than one block (seg[2m] to seg[2m + 1]); zeros for
// a member with no rows.  Grid (chunks of `per_block` * 32 float4 of
// out[m], K), 256 threads: thread (g, e) sums the g-th of kParts
// consecutive runs of the member's blocks for element e, and the runs'
// sums are added in run order, so the order is fixed.
__global__ void __launch_bounds__(kParts * 32)
hist_segments_reduce(const float* __restrict__ partial,
                     const long long* __restrict__ cnt,
                     const int32_t* __restrict__ seg, int fw, int E,
                     int per_block, float* __restrict__ out) {
  __shared__ float4 s_sum[kParts][32];
  const int m = blockIdx.y;
  long long b0 = 0, b1 = -1;  // the blocks holding the member's tiles
  if (cnt[m] > 0) {
    b0 = seg[2 * m];
    b1 = seg[2 * m + 1];
    if (b0 == b1) return;  // one block wrote it directly
  }
  const long long per4 = (long long)fw * E / 4;
  const int el = threadIdx.x & 31;
  const int g = threadIdx.x >> 5;
  const long long run = (b1 - b0 + kParts) / kParts;
  const long long r0 = b0 + g * run;
  const long long r1 = r0 + run - 1 < b1 ? r0 + run - 1 : b1;
  const float4* p4 = reinterpret_cast<const float4*>(partial);
  for (int c = 0; c < per_block; ++c) {
    const long long e = ((long long)blockIdx.x * per_block + c) * 32 + el;
    float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (e < per4) {
#pragma unroll 4
      for (long long bb = r0; bb <= r1; ++bb) {
        const float4 v = p4[(bb + m) * per4 + e];
        acc.x += v.x;
        acc.y += v.y;
        acc.z += v.z;
        acc.w += v.w;
      }
    }
    s_sum[g][el] = acc;
    __syncthreads();
    if (g == 0 && e < per4) {
      float4 t = s_sum[0][el];
      for (int j = 1; j < kParts; ++j) {
        const float4 v = s_sum[j][el];
        t.x += v.x;
        t.y += v.y;
        t.z += v.z;
        t.w += v.w;
      }
      reinterpret_cast<float4*>(out)[(long long)m * per4 + e] = t;
    }
    __syncthreads();
  }
}

size_t smem_bytes(int nw, int nbins) {
  return sizeof(float) * ((size_t)nw * (4 * nbins * 3 + kMask) +
                          kStages * (size_t)kTile * (4 + nw));
}

}  // namespace

extern "C" {

// Launch both passes on `stream` with a grid of `G` blocks per lane group.
// `partial` holds (G + K) * Fw * 4*nbins*3 floats and `seg` 2K int32 of
// scratch, `out` K * 4*Fw * nbins * 3 floats.  Returns cudaGetLastError()
// after the launches (0 = both launched).
int lgbt_hist_segments(const void* words, const void* w, const void* lid,
                       long long n, int fw, const void* start, const void* cnt,
                       const void* leaf, int kmem, int nbins, int quant, int G,
                       void* partial, void* seg, void* out, void* stream) {
  static bool raised[64] = {false};
  if (nbins < 1 || nbins > 256 || fw < 1 || kmem < 1 || G < 1)
    return (int)cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  if (!raised[dev]) {  // once per device: the largest block this file makes
    err = cudaFuncSetAttribute(hist_segments_tiles,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem_bytes(kLanesMax, 256));
    if (err != cudaSuccess) return (int)err;
    raised[dev] = true;
  }
  const int nw = fw < kLanesMax ? fw : kLanesMax;
  const int groups = (fw + kLanesMax - 1) / kLanesMax;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  hist_segments_tiles<<<dim3(G, groups), nw * 32, smem_bytes(nw, nbins),
                        st>>>(
      static_cast<const int32_t*>(words), static_cast<const float*>(w),
      static_cast<const int32_t*>(lid), n, fw,
      static_cast<const long long*>(start), static_cast<const long long*>(cnt),
      static_cast<const long long*>(leaf), kmem, nbins, quant,
      static_cast<float*>(partial), static_cast<int32_t*>(seg),
      static_cast<float*>(out));
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int E = 4 * nbins * 3;
  const long long per4 = (long long)fw * E / 4;
  // one 32-float4 chunk per block for a few members, up to four for many:
  // enough blocks to fill the card, few enough to start quickly
  const int per_block = kmem < 16 ? 1 : (kmem < 64 ? kmem / 16 : 4);
  const long long chunks = (per4 + 32 * per_block - 1) / (32 * per_block);
  hist_segments_reduce<<<dim3((unsigned)chunks, kmem), kParts * 32, 0, st>>>(
      static_cast<const float*>(partial), static_cast<const long long*>(cnt),
      static_cast<const int32_t*>(seg), fw, E, per_block,
      static_cast<float*>(out));
  return (int)cudaGetLastError();
}

}  // extern "C"
