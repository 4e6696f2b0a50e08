// One pass of the wave learner's exact greedy replay, written for Hopper
// (sm_90a).
//
// Port of the XLA loop lightgbm_tpu/learner_wave.py:_replay (not a Pallas
// kernel: the JAX package runs it as a lax.while_loop on the device).  The
// replay re-derives the reference's best-first pop order over the forest the
// growth waves grew (serial_tree_learner.cpp:185-218): pop the available
// leaf with the largest gain, the lowest leaf index on exact ties
// (serial_tree_learner.cpp:505-520); its left child keeps the leaf index,
// its right child gets the next one (pops + 1); stop after `budget` pops or
// when no available gain is positive.  A pass stops early ("stall") when the
// leaf to pop next was never split by the growth; the learner splits it (and
// up to stall_batch - 1 more of the likeliest next stalls) and runs the next
// pass, which carries on from the state this one left:
//
//   avail  (M,) uint8   the available (frontier) node slots
//   refidx (M,) int32   leaf index of every revealed slot
//   poprec (budget, 2) int32   (slot, leaf index) of each pop, in order
//   ctl    int32        pops, extras, flag (0 run, 1 stall, 2 done), passes,
//                       stall events, stall splits, error (ops/replay.py)
//
// On a stall it also writes the correction's members: the top stall_batch
// unsplit positive-gain available slots by (gain desc, leaf index asc), the
// stalled top first; each extra past the first counts against extras_cap
// over the whole replay and must have a window width <= vec_cap; members
// are compacted in that order and padded with pad_slot, mvalid marking the
// real ones.  A pass that finds the flag at 2 (done) returns at once, so a
// pass queued behind the last one is a device no-op.
//
// Design.  The node table (M = 1 + 2 * (grow budget + correction reserve)
// slots: 1,145 at 255 leaves) is read once into shared memory by the whole
// block: an order-preserving 64-bit key per slot (the bits of the positive
// gain as a double, 0 for a gain that is not positive or NaN), the left
// child and the split flag.  Warp 0 then compacts the available slots into
// a list of at most budget + 1 entries (ballots, so the list order is fixed)
// and runs the pops.  Entry p belongs to lane p % 32, which keeps the best
// of its entries by (key desc, leaf index asc); a pop is three warp
// reductions (__reduce_max_sync: the key's high word, its low word, the
// least leaf index), the popped entry becomes its left child and a new
// entry its right child, and only the popped entry's lane rescans (the new
// entry's lane compares one entry).  An entry carries its slot's left
// child and split flag, so a pop reads two shared words after the
// reductions.  A pop writes nothing to device memory: the pass keeps its
// pops in shared memory and the warp writes the pop records, the
// children's leaf indices and the available flags after the last.  The pass is
// bitwise equal to ops/replay.py:replay_pass_plain: it compares and copies,
// it computes nothing.
//
// Bound.  The function must read the node table once (gain, split flag,
// left child, available flag and leaf index: 18 bytes per slot with float32
// gains, 21 KB at M = 1,145; a window width only for a stall's batch
// extras) and write per pop its record and the two children's leaf indices
// (16 bytes), plus the available flags that change: under 10 ns of
// device-memory time.
// What bounds it is latency: up to `budget` dependent pops, each three
// warp reductions, a few shared-memory reads and one lane's rescan of at
// most ceil((budget + 1) / 32) entries.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr unsigned kFull = 0xFFFFFFFFu;
// ctl layout, as ops/replay.py
constexpr int kPops = 0, kExtras = 1, kFlag = 2, kPasses = 3,
              kStallEvents = 4, kStallSplits = 5, kError = 6;
constexpr int kStall = 1, kDone = 2;
constexpr unsigned kEmpty = 0xFFFFFFFFu;

typedef unsigned long long u64;

// (key desc, rp asc), the key as its high and low words, rp = leaf index
// << 16 | list position: the leaf index decides (it is unique among the
// available slots), the position never
__device__ __forceinline__ bool better(unsigned ha, unsigned la, unsigned ra,
                                       unsigned hb, unsigned lb,
                                       unsigned rb) {
  return ha > hb || (ha == hb && (la > lb || (la == lb && ra < rb)));
}

// The warp's best (key, rp) in every lane: three single-instruction
// reductions (the key's high word, its low word among the lanes that hold
// the high one, the least rp among the lanes that hold the key)
__device__ __forceinline__ void warp_best(unsigned& h, unsigned& l,
                                          unsigned& rp) {
  const unsigned mh = __reduce_max_sync(kFull, h);
  const unsigned ml = __reduce_max_sync(kFull, h == mh ? l : 0u);
  const unsigned mr = __reduce_max_sync(kFull,
                                        h == mh && l == ml ? ~rp : 0u);
  h = mh;
  l = ml;
  rp = ~mr;
}

__device__ __forceinline__ u64 gain_key(const void* gain, long long stride,
                                        int f64, int i) {
  const double g = f64 ? static_cast<const double*>(gain)[i * stride]
                       : (double)static_cast<const float*>(gain)[i * stride];
  return g > 0.0 ? (u64)__double_as_longlong(g) : 0ull;
}

__global__ void __launch_bounds__(kThreads)
replay_pass(const void* __restrict__ gain, long long gstride, int gain_f64,
            const uint8_t* __restrict__ split,
            const int64_t* __restrict__ child0,
            const int64_t* __restrict__ width, long long wstride, int M,
            uint8_t* __restrict__ avail, int32_t* __restrict__ refidx,
            int32_t* __restrict__ poprec, int32_t* __restrict__ ctl,
            int64_t* __restrict__ members, uint8_t* __restrict__ mvalid,
            int budget, int kb, int extras_cap, long long vec_cap,
            long long pad_slot, int cap) {
  if (ctl[kFlag] == kDone) return;  // uniform: a pass behind the last one
  // per slot: key, left child, leaf index, split and avail flags; per list
  // entry: key words, rp, slot, the slot's left child and split flag; per
  // pop of this pass: slot, leaf index, left child
  extern __shared__ __align__(16) unsigned char smem[];
  u64* skey = reinterpret_cast<u64*>(smem);                       // M
  int32_t* schild = reinterpret_cast<int32_t*>(skey + M);          // M
  int32_t* sref = schild + M;                                      // M
  unsigned* lhi = reinterpret_cast<unsigned*>(sref + M);           // cap
  unsigned* llo = lhi + cap;                                       // cap
  unsigned* lrp = llo + cap;                                       // cap
  int32_t* lslot = reinterpret_cast<int32_t*>(lrp + cap);          // cap
  int32_t* lchild = lslot + cap;                                   // cap
  int32_t* spop = lchild + cap;                                    // 3 cap
  uint8_t* ssplit = reinterpret_cast<uint8_t*>(spop + 3 * cap);    // M
  uint8_t* savail = ssplit + M;                                    // M
  uint8_t* lsplit = savail + M;                                    // cap

  for (int i = threadIdx.x; i < M; i += blockDim.x) {
    skey[i] = gain_key(gain, gstride, gain_f64, i);
    schild[i] = (int32_t)child0[i];
    sref[i] = refidx[i];
    ssplit[i] = split[i];
    savail[i] = avail[i];
  }
  __syncthreads();
  if (threadIdx.x >= 32) return;
  const int lane = threadIdx.x;
  const unsigned lt_mask = (1u << lane) - 1u;

  auto put = [&](int p, int s, int ref) {   // list entry p := slot s
    const u64 k = skey[s];
    lhi[p] = (unsigned)(k >> 32);
    llo[p] = (unsigned)k;
    lrp[p] = ((unsigned)ref << 16) | (unsigned)p;
    lslot[p] = s;
    lchild[p] = schild[s];
    lsplit[p] = ssplit[s];
  };

  // ---- the available slots, compacted in slot order
  int n = 0;
  for (int base = 0; base < M; base += 32) {
    const int i = base + lane;
    const bool a = i < M && savail[i] != 0;
    const unsigned ball = __ballot_sync(kFull, a);
    const int p = n + __popc(ball & lt_mask);
    if (a && p < cap) put(p, i, sref[i]);
    n += __popc(ball);
  }
  int err = n > cap;
  if (err) n = cap;
  __syncwarp();

  const int pops0 = ctl[kPops];
  int pops = pops0;
  int extras = ctl[kExtras];
  // this lane's best entry (entries lane, lane + 32, ...)
  unsigned mh = 0u, ml = 0u, mrp = kEmpty;
  auto consider = [&](int p) {
    const unsigned h = lhi[p], l = llo[p], r = lrp[p];
    if (better(h, l, r, mh, ml, mrp)) {
      mh = h;
      ml = l;
      mrp = r;
    }
  };
  auto rescan = [&]() {      // four entries' loads in flight at a time
    mh = 0u;
    ml = 0u;
    mrp = kEmpty;
    int p = lane;
    for (; p + 96 < n; p += 128) {
      unsigned h[4], l[4], r[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        h[u] = lhi[p + 32 * u];
        l[u] = llo[p + 32 * u];
        r[u] = lrp[p + 32 * u];
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (better(h[u], l[u], r[u], mh, ml, mrp)) {
          mh = h[u];
          ml = l[u];
          mrp = r[u];
        }
      }
    }
    for (; p < n; p += 32) consider(p);
  };
  rescan();

  int flag = kDone, top = -1;
  while (!err && pops < budget) {
    unsigned bh = mh, bl = ml, brp = mrp;
    warp_best(bh, bl, brp);
    if ((bh | bl) == 0u) break;  // no positive gain left
    const int pos = (int)(brp & 0xFFFFu);
    const int ref = (int)(brp >> 16);
    const int s = lslot[pos];
    const int c0 = lchild[pos];
    if (!lsplit[pos]) {      // the growth never split it: stall
      flag = kStall;
      top = s;
      break;
    }
    if (n >= cap) {          // an inconsistent carried state
      err = 1;
      break;
    }
    if (lane == 0) {         // written to device memory after the pops
      spop[3 * (pops - pops0)] = s;
      spop[3 * (pops - pops0) + 1] = ref;
      spop[3 * (pops - pops0) + 2] = c0;
    }
    // the popped entry becomes its left child (same leaf index), a new
    // entry its right child (leaf index pops + 1)
    const int fresh = n;
    if (lane == (pos & 31)) put(pos, c0, ref);
    if (lane == (fresh & 31)) put(fresh, c0 + 1, pops + 1);
    ++n;
    ++pops;
    if (lane == (pos & 31)) {
      rescan();
    } else if (lane == (fresh & 31)) {
      consider(fresh);
    }
    __syncwarp();
  }

  // ---- the correction's members
  int nm = 0;
  if (flag == kStall) {
    if (kb == 1) {
      if (lane == 0) {
        members[0] = top;
        mvalid[0] = 1;
      }
      nm = 1;
    } else {
      // the j-th candidate is the best unsplit positive-gain entry strictly
      // after the (j-1)-th in the pop order
      unsigned ph = ~0u, pl = ~0u, prp = 0u;
      for (int j = 0; j < kb; ++j) {
        unsigned ch = 0u, cl = 0u, crp = kEmpty;
        for (int p = lane; p < n; p += 32) {
          const unsigned h = lhi[p], l = llo[p], r = lrp[p];
          if ((h | l) == 0u || lsplit[p]) continue;
          if (better(ph, pl, prp, h, l, r) && better(h, l, r, ch, cl, crp)) {
            ch = h;
            cl = l;
            crp = r;
          }
        }
        warp_best(ch, cl, crp);
        if ((ch | cl) == 0u) break;  // fewer candidates than the batch
        ph = ch;
        pl = cl;
        prp = crp;
        const int s = lslot[crp & 0xFFFFu];
        const bool take = j == 0 || (extras + j - 1 < extras_cap &&
                                     width[(long long)s * wstride] <= vec_cap);
        if (take) {
          if (lane == 0) {
            members[nm] = s;
            mvalid[nm] = 1;
          }
          ++nm;
        }
      }
      extras += nm - 1;
    }
  }
  // ---- this pass's pops to device memory: the pop records, the
  // children's leaf indices, the popped slots out of avail and the final
  // list into it (disjoint slots: a popped slot is never in the list)
  __syncwarp();
  for (int i = lane; i < pops - pops0; i += 32) {
    const int s = spop[3 * i], ref = spop[3 * i + 1], c0 = spop[3 * i + 2];
    poprec[2 * (pops0 + i)] = s;
    poprec[2 * (pops0 + i) + 1] = ref;
    refidx[c0] = ref;
    refidx[c0 + 1] = pops0 + i + 1;
    avail[s] = 0;
  }
  for (int p = lane; p < n; p += 32) avail[lslot[p]] = 1;
  if (lane == 0) {
    for (int j = nm; j < kb; ++j) {
      members[j] = pad_slot;
      mvalid[j] = 0;
    }
    ctl[kPops] = pops;
    ctl[kExtras] = extras;
    ctl[kFlag] = err ? kDone : flag;
    ctl[kPasses] += 1;
    ctl[kStallEvents] += flag == kStall;
    ctl[kStallSplits] += nm;
    ctl[kError] |= err;
  }
}

// Shared memory the kernel takes for M slots and a list of cap entries
// (ops/replay.py:replay_smem_bytes).
long long replay_smem(int M, int cap) {
  return (long long)M * (8 + 4 + 4 + 1 + 1) + (long long)cap * (8 * 4 + 1);
}

}  // namespace

extern "C" {

// Launch one pass on `stream` (one block).  gain is float32 (gain_f64 = 0)
// or float64 with element stride gstride; width is int64 with element
// stride wstride.  Returns cudaGetLastError() after the launch.
int lgbt_replay(const void* gain, long long gstride, int gain_f64,
                const void* split, const void* child0, const void* width,
                long long wstride, int M, void* avail, void* refidx,
                void* poprec, void* ctl, void* members, void* mvalid,
                int budget, int kb, int extras_cap, long long vec_cap,
                long long pad_slot, int cap, void* stream) {
  const long long smem = replay_smem(M, cap);
  // the dynamic shared-memory limit, raised per device to the largest
  // size asked so far
  static long long raised[64] = {0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (smem > 48 * 1024 && dev < 64 && smem > raised[dev]) {
    err = cudaFuncSetAttribute(replay_pass,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    raised[dev] = smem;
  }
  replay_pass<<<1, kThreads, (size_t)smem,
                static_cast<cudaStream_t>(stream)>>>(
      gain, gstride, gain_f64, static_cast<const uint8_t*>(split),
      static_cast<const int64_t*>(child0),
      static_cast<const int64_t*>(width), wstride, M,
      static_cast<uint8_t*>(avail), static_cast<int32_t*>(refidx),
      static_cast<int32_t*>(poprec), static_cast<int32_t*>(ctl),
      static_cast<int64_t*>(members), static_cast<uint8_t*>(mvalid), budget,
      kb, extras_cap, vec_cap, pad_slot, cap);
  return (int)cudaGetLastError();
}

}  // extern "C"
