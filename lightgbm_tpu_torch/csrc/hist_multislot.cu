// Per-slot histograms over the full row axis in one pass, for the wave
// learner's level-wise opening, written for Hopper (sm_90a).
//
// Replaces the TPU kernel lightgbm_tpu/ops/hist_pallas.py:
// build_histogram_multislot (_hist_kernel_multislot), which shares one bin
// one-hot per row block across K slots and routes rows to slots through a
// (K, rows) slot one-hot in the MXU's weight operand.  It computes, in true
// float32:
//
//   out[j, 4*k + s, b, c] = sum over r with slot[r] == j of
//                           [byte_s(words[k, r]) == b] * w[c, r]
//
//   words : (Fw, N) int32 packed bin codes, contiguous
//   w     : (3, N) float32 (g*bag, h*bag, bag), contiguous
//   slot  : (N,) int32 output slot per row; a slot outside [0, K)
//           contributes nowhere
//   out   : (K, 4*Fw, nbins, 3) float32; codes >= nbins are dropped
//   quant : the quantized-gradient mode, as in hist_packed.cu: channel 2
//           accumulates lane 1 (h), not lane 2 (bag)
//
// Bound.  The function must read the slot of every row (4 bytes) and the
// words and weights of the rows in a slot (Fw*4 + 3*4 bytes), and write
// K * 4*Fw * nbins * 3 * 4 bytes: at the bench width (Fw = 8, N =
// 1,000,448), K = 16 and every row in a slot that is 49.6 MB, about 14.8 us
// at 3.35 TB/s.
//
// Design.  hist_packed.cu's block, fed one slot's rows (hist_common.cuh
// holds the shared pieces):
//
//  * Grid (K, lane groups, chunks), the slot fastest.  Block (j, g, c)
//    builds slot j's histograms of word lanes [g * nl, (g + 1) * nl) over
//    row chunk c, a warp per feature with ONE histogram (3 KB at 255 bins)
//    and an nbins-word group mask (group_add: lanes that hold one bin find
//    each other through integer ORs, the lowest lane adds the group's sum
//    in row order).  The host sizes the plan (ops/hist_multislot.py:
//    multislot_plan): nl = 4 word lanes (16 warps, two blocks an SM at 255
//    bins) and as many chunks as fill one wave of the card, so K = 16 at
//    the bench width is 16 x 2 x 8 blocks and K = 1 is 1 x 2 x 131.
//  * The block lists its slot's rows once: every thread reads kPer slots of
//    a window of blockDim * kPer rows (coalesced, the next window's loads in
//    flight while this one is ranked), a ballot per warp and one warp's
//    scan of the counts give each matching row its place, and the row
//    offsets are appended to a shared-memory list in row order.  So each
//    row's slot is read once per block, and no warp scans rows that are not
//    its block's.
//  * Whenever the list might overflow in the next window, and at the
//    chunk's end, the block bins the listed rows: 128-row stages of their
//    weights and the block's word lanes gathered into shared memory with
//    cp.async (4 bytes each), three stages deep, every row's weights staged
//    once for the block's 4 * nl features; a 32-row step with no weighted
//    row is not binned.  A step whose binned rows all hold one code (the
//    dataset's padding features, code 0 in every row) is summed by a
//    shuffle butterfly and added by one lane: group_add would give its
//    lowest lane a 32-long dependent chain, and that warp would set its
//    block's pace.  Rows of a slot are binned in row order.
//  * At the end each warp writes its histogram straight into out when the
//    plan has one chunk, else into the chunk's partial, only the bins it
//    touched, with a bitmap (flush); hist_reduce sums the K * 4*Fw
//    features' partials over the chunks in a fixed order.  No float
//    atomics: the plan depends only on (Fw, K, N, nbins), so two launches
//    on the same input are bitwise equal.
//
// What limits it: as in hist_packed.cu, the binning's shared-memory traffic
// (about 50 SM cycles per 32-row step of one feature at the full window),
// here on the rows in a slot only; the gathers of those rows (a sector per
// row and array when a slot holds a small share of the rows, served from
// the L2 as the slot blocks of one chunk walk the same rows together); the
// K * groups reads of each row's slot; the chunks' partials.

#include "hist_common.cuh"

namespace {

using namespace lgbt_hist;

constexpr int kLanesMax = 4;           // word lanes per block (4 warps each)
constexpr int kWarpsMax = 4 * kLanesMax;
constexpr int kRows = 128;             // rows per stage
constexpr int kStages = 3;
constexpr int kPer = 8;                // slots a thread reads per window
constexpr int kList = 8192;            // row offsets the block's list holds

size_t smem_bytes(int nl, int nbins) {
  return sizeof(float) * ((size_t)4 * nl * nbins * 4 +
                          (size_t)kStages * kRows * (3 + nl)) +
         sizeof(int) * ((size_t)kList + 2 * kPer * kWarpsMax + 1);
}

// Copy the weights and the block's nl word lanes of listed rows
// [i0, i0 + n) (offsets from r0 in `list`) to the stage at shared address
// `buf`; two weight lanes in quant mode (channel 2 reads lane 1).
__device__ __forceinline__ void issue(const int32_t* words, const float* w,
                                      long long n_rows, int fw, int lane0,
                                      int nl, int quant, long long r0,
                                      const int* list, int n, unsigned buf) {
  const int arrays = 3 + nl;
  for (int e = threadIdx.x; e < arrays * kRows; e += blockDim.x) {
    const int a = e / kRows;
    const int i = e - a * kRows;
    if (i >= n) continue;
    const long long r = r0 + list[i];
    if (a < 3) {
      if (a == 2 && quant) continue;
      cp_async4(buf + 4 * e, w + a * n_rows + r);
    } else if (lane0 + a - 3 < fw) {
      cp_async4(buf + 4 * e, words + (lane0 + a - 3) * n_rows + r);
    }
  }
}

__global__ void __launch_bounds__(kWarpsMax * 32)
hist_multislot_chunks(const int32_t* __restrict__ words,
                      const float* __restrict__ w,
                      const int32_t* __restrict__ slot, long long n_rows,
                      int fw, int kslots, int chunk, int nbins, int quant,
                      int nchunks, float* __restrict__ partial,
                      uint32_t* __restrict__ bits, float* __restrict__ out) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int nl = blockDim.x >> 7;  // word lanes of this block
  const int nw = 4 * nl;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int j = blockIdx.x;        // the slot
  const int lane0 = blockIdx.y * nl;
  const int k = lane0 + (warp >> 2);  // this warp's word lane
  const int s = warp & 3;             // ... and byte plane
  const bool live = k < fw;
  const int ch = blockIdx.z;
  float* hist = smem + warp * nbins * 3;
  uint32_t* msk = reinterpret_cast<uint32_t*>(smem + nw * nbins * 3) +
                  warp * nbins;
  float* stages = smem + nw * nbins * 4;
  const int stage_floats = kRows * (3 + nl);
  int* list = reinterpret_cast<int*>(stages + kStages * stage_floats);
  int* s_cnt = list + kList;         // kPer * nw window counts
  int* s_off = s_cnt + kPer * nw;    // ... their exclusive scan
  int* s_tot = s_off + kPer * nw;    // ... and total
  const unsigned sstages =
      static_cast<unsigned>(__cvta_generic_to_shared(stages));
  for (int e = threadIdx.x; e < nw * nbins * 4; e += blockDim.x)
    smem[e] = 0.0f;  // histograms and group masks

  const long long r0 = (long long)ch * chunk;
  const long long r1 = min(n_rows, r0 + chunk);
  const int T = blockDim.x;
  const long long W = (long long)T * kPer;

  // bin the `count` listed rows (every thread calls it)
  auto bin_list = [&](int count) {
    const int nst = (count + kRows - 1) / kRows;
    __syncthreads();  // the list is complete
    for (int q = 0; q < kStages - 1; ++q) {
      if (q < nst)
        issue(words, w, n_rows, fw, lane0, nl, quant, r0, list + q * kRows,
              min(kRows, count - q * kRows), sstages + 4 * q * stage_floats);
      cp_async_commit();
    }
    for (int q = 0; q < nst; ++q) {
      const int qa = q + kStages - 1;
      if (qa < nst)
        issue(words, w, n_rows, fw, lane0, nl, quant, r0, list + qa * kRows,
              min(kRows, count - qa * kRows),
              sstages + 4 * (qa % kStages) * stage_floats);
      cp_async_commit();
      cp_async_wait<kStages - 1>();  // stage q (this thread's copies) landed
      __syncthreads();               // ... and every thread's
      const float* buf = stages + (q % kStages) * stage_floats;
      const float* sg = buf;
      const float* sh = buf + kRows;
      const float* sc = quant ? sh : buf + 2 * kRows;
      const uint32_t* sw =
          reinterpret_cast<const uint32_t*>(buf + (3 + (warp >> 2)) * kRows);
      const int n = min(kRows, count - q * kRows);
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
          const uint32_t c0 = __reduce_or_sync(kFull, in ? code : 0u);
          if (__reduce_and_sync(kFull, in ? code : ~0u) == c0) {
            // every binned row of the step in one bin (a padding feature's
            // constant code): a butterfly sum in place of group_add's
            // 32-long chain in one lane
            float tg = in ? g : 0.0f, th = in ? h : 0.0f, tc = in ? c : 0.0f;
#pragma unroll
            for (int o = 16; o > 0; o >>= 1) {
              tg += __shfl_xor_sync(kFull, tg, o);
              th += __shfl_xor_sync(kFull, th, o);
              tc += __shfl_xor_sync(kFull, tc, o);
            }
            if (lane == 0) {
              float* d = hist + c0 * 3;
              d[0] += tg;
              d[1] += th;
              d[2] += tc;
            }
            __syncwarp();
            continue;
          }
          group_add(in, static_cast<int>(code), g, h, c, sg, sh, sc, i0, msk,
                    hist);
        }
      }
      __syncthreads();  // the stage (and the list) free for later writes
    }
  };

  // list the chunk's rows of slot j, window by window
  int nxt[kPer];
#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    const long long r = r0 + u * T + threadIdx.x;
    nxt[u] = r < r1 ? slot[r] : -1;
  }
  int count = 0;  // rows in the list (block-uniform)
  for (long long base = r0; base < r1; base += W) {
    int cur[kPer];
#pragma unroll
    for (int u = 0; u < kPer; ++u) cur[u] = nxt[u];
    if (base + W < r1) {
#pragma unroll
      for (int u = 0; u < kPer; ++u) {
        const long long r = base + W + u * T + threadIdx.x;
        nxt[u] = r < r1 ? slot[r] : -1;
      }
    }
    uint32_t bal[kPer];
#pragma unroll
    for (int u = 0; u < kPer; ++u) bal[u] = __ballot_sync(kFull, cur[u] == j);
    if (lane == 0) {
#pragma unroll
      for (int u = 0; u < kPer; ++u) s_cnt[u * nw + warp] = __popc(bal[u]);
    }
    __syncthreads();
    if (warp == 0) {
      // exclusive scan of the kPer * nw counts in (u, warp) order, i.e. in
      // row order; each lane takes up to four consecutive entries
      const int E = kPer * nw;
      const int per = (E + 31) >> 5;
      int loc[4];
      int sum = 0;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int e = lane * per + i;
        loc[i] = sum;
        if (i < per && e < E) sum += s_cnt[e];
      }
      int incl = sum;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(kFull, incl, o);
        if (lane >= o) incl += y;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int e = lane * per + i;
        if (i < per && e < E) s_off[e] = incl - sum + loc[i];
      }
      if (lane == 31) *s_tot = incl;
    }
    __syncthreads();
    const uint32_t below = (1u << lane) - 1u;
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      if (cur[u] == j)
        list[count + s_off[u * nw + warp] + __popc(bal[u] & below)] =
            static_cast<int>(base + u * T + threadIdx.x - r0);
    }
    count += *s_tot;
    if (count > kList - W || base + W >= r1) {  // block-uniform
      if (count > 0) bin_list(count);
      count = 0;
    }
  }
  __syncthreads();  // every warp's last binning step is done
  if (!live) return;
  const long long fo = (long long)j * 4 * fw + 4 * k + s;
  if (nchunks == 1) {
    flush(hist, nbins, true, out + fo * nbins * 3, nullptr);
  } else {
    const long long slot_f = (long long)ch * kslots * 4 * fw + fo;
    flush(hist, nbins, false, partial + slot_f * nbins * 3,
          bits + slot_f * ((nbins + 31) >> 5));
  }
}

}  // namespace

extern "C" {

// Launch on `stream`: the binning pass over (K, ceil(fw / nl), nchunks)
// blocks of 4 * nl warps, then, for nchunks > 1, the reduce pass over the
// K * 4*fw features.  `partial` holds nchunks * K * 4*fw * nbins * 3 floats
// and `bits` nchunks * K * 4*fw * ceil(nbins / 32) words of scratch (unused
// for one chunk), `out` K * 4*fw * nbins * 3 floats.  Returns
// cudaGetLastError() after the launches (0 = launched), or
// cudaErrorInvalidValue for arguments outside what the kernel takes.
int lgbt_hist_multislot(const void* words, const void* w, const void* slot,
                        long long n, int fw, int kslots, int nbins, int quant,
                        int nl, int nchunks, int chunk, void* partial,
                        void* bits, void* out, void* stream) {
  static bool raised[64] = {false};
  if (kslots < 1 || nbins < 1 || nbins > 256 || fw < 1 || n < 1 || nl < 1 ||
      nl > kLanesMax || nchunks < 1 || chunk < 1 ||
      (long long)nchunks * chunk < n || (long long)kslots * 4 * fw > 65535)
    return (int)cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  if (!raised[dev]) {  // once per device: the largest block this file makes
    err = cudaFuncSetAttribute(hist_multislot_chunks,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem_bytes(kLanesMax, 256));
    if (err != cudaSuccess) return (int)err;
    raised[dev] = true;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int groups = (fw + nl - 1) / nl;
  hist_multislot_chunks<<<dim3(kslots, groups, nchunks), 4 * nl * 32,
                          smem_bytes(nl, nbins), st>>>(
      static_cast<const int32_t*>(words), static_cast<const float*>(w),
      static_cast<const int32_t*>(slot), n, fw, kslots, chunk, nbins, quant,
      nchunks, static_cast<float*>(partial), static_cast<uint32_t*>(bits),
      static_cast<float*>(out));
  err = cudaGetLastError();
  if (err != cudaSuccess || nchunks == 1) return (int)err;
  return (int)launch_reduce(static_cast<const float*>(partial),
                            static_cast<const uint32_t*>(bits), nchunks,
                            kslots * 4 * fw, nbins,
                            static_cast<float*>(out), st);
}

}  // extern "C"
