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
// Design.  One block of 512 threads pops whole runs at a time, as the JAX
// package's batched simulation does (learner_wave.py:1599-1617).  The
// block first copies the node table into a compact form (an
// order-preserving 64-bit key per slot: the positive gain's bits as a
// double, 0 for a gain that is not positive or NaN; the left child; the
// split flag) and lists the available slots of positive key (each warp's
// ballot places its entries) in replay order: key desc, leaf index asc,
// slot asc (a strict order: available slots have distinct leaf indices):
// up to 512 entries by each one's rank (a thread each, four loads in
// flight), more by a bitonic sort.  A step then pops the longest prefix
// of the list in which every entry is split and comes before every child
// the entries ahead of it reveal (their leaf indices are known: the
// parent's on the left, pops + position + 1 on the right), capped by the
// budget and by a window of 32 entries.  Such a prefix is exactly what
// sequential pops would take, ties included, so no exact tie needs the JAX
// package's single-pop fallback.
// Warp 0 evaluates the window, a lane per entry: its better child, a warp
// scan (shuffles) of the best child revealed ahead of it, and one ballot
// for the prefix; its lanes write the pops' records, children's leaf
// indices and avail flags straight to device memory and rank the
// positive-key children among themselves.  After one barrier the whole
// block merges the list's rest with the children into the other list
// buffer (the thread at position i places its entry after the children
// that come before it, and every child that falls between its entry and
// the one ahead), then a second barrier ends the step.  A step whose
// prefix is empty has an unsplit head: the stall, and the head is its
// top.  The members are then the first stall_batch unsplit entries of the
// list.
//
// Memory.  The table (13 bytes a slot) and the two list buffers (16 bytes
// an entry, the next power of two above budget + 1 each) live in shared
// memory where they fit (ops/replay.py:replay_plan places them: at 255
// leaves both, 23 KB, beside 2 KB of the step's children); what does not
// fit lives in a global scratch buffer the wrapper allocates (a kernel
// instantiation per placement), so every M the learner sizes runs (M =
// 16,505 at 4,095 leaves keeps its table in device memory, which the L2
// holds).
//
// Bound.  The function must read the node table once (gain, split flag,
// left child, available flag and leaf index: 18 bytes per slot with float32
// gains, 21 KB at M = 1,145; a window width only for a stall's batch
// extras) and write per pop its record and the two children's leaf indices
// (16 bytes), plus the available flags that change: under 10 ns of
// device-memory time.  What bounds it is latency: the table's load, the
// sort, and per step warp 0's chain (three shared-memory loads, five
// shuffle rounds, the children's ranks) and two block barriers; real trees
// pop in a few runs per pass.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kMaxBatch = 64;
constexpr int kWindow = 32;  // entries a step evaluates: one warp
constexpr int kLoad = 4;     // slots a thread loads at once
constexpr unsigned kFull = 0xFFFFFFFFu;
// ctl layout, as ops/replay.py
constexpr int kPops = 0, kExtras = 1, kFlag = 2, kPasses = 3,
              kStallEvents = 4, kStallSplits = 5, kError = 6;
constexpr int kStall = 1, kDone = 2;

typedef unsigned long long u64;

// A list entry: an available slot (or a revealed child) of positive key.
struct __align__(16) Ent {
  u64 key;  // the positive gain's bits as a double
  int ref;  // leaf index
  int slot;
};

// Replay order: key desc, leaf index asc, slot asc.  The sentinel (key 0)
// comes after every entry of positive key.
__device__ __forceinline__ bool before(const Ent& a, const Ent& b) {
  return a.key > b.key ||
         (a.key == b.key && (a.ref < b.ref || (a.ref == b.ref &&
                                               a.slot < b.slot)));
}

// An entry through one 16-byte access (a warp's accesses to consecutive
// entries then take no bank conflict; 64-bit halves would)
__device__ __forceinline__ Ent load_ent(const Ent* p) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  Ent e;
  e.key = ((u64)v.y << 32) | v.x;
  e.ref = (int)v.z;
  e.slot = (int)v.w;
  return e;
}

__device__ __forceinline__ void store_ent(Ent* p, const Ent& e) {
  *reinterpret_cast<uint4*>(p) = make_uint4(
      (unsigned)e.key, (unsigned)(e.key >> 32), (unsigned)e.ref,
      (unsigned)e.slot);
}

// before(a, b) as 0 or 1, without branches (a rank loop's body)
__device__ __forceinline__ int ahead_of(const Ent& a, const Ent& b) {
  const int eq_ref = a.ref == b.ref;
  return (a.key > b.key) |
         ((a.key == b.key) & ((a.ref < b.ref) | (eq_ref & (a.slot < b.slot))));
}

__device__ __forceinline__ Ent sentinel() {
  Ent e;
  e.key = 0ull;
  e.ref = INT_MAX;
  e.slot = INT_MAX;
  return e;
}

__device__ __forceinline__ u64 gain_key(const void* gain, long long stride,
                                        int f64, int i) {
  const double g =
      f64 ? __ldg(static_cast<const double*>(gain) + i * stride)
          : (double)__ldg(static_cast<const float*>(gain) + i * stride);
  return g > 0.0 ? (u64)__double_as_longlong(g) : 0ull;
}

// Block-wide bitonic sort of x[0, P) into replay order, P a power of two
__device__ void bitonic_sort(Ent* x, int P) {
  for (int size = 2; size <= P; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int t = threadIdx.x; t < (P >> 1); t += blockDim.x) {
        const int i = ((t & ~(stride - 1)) << 1) | (t & (stride - 1));
        const int j = i + stride;
        const bool asc = (i & size) == 0;
        const Ent u = load_ent(x + i), v = load_ent(x + j);
        if (before(v, u) == asc) {
          store_ent(x + i, v);
          store_ent(x + j, u);
        }
      }
      __syncthreads();
    }
  }
}

struct Args {
  const void* gain;
  long long gstride;
  int gain_f64;
  const uint8_t* split;
  const int64_t* child0;
  const int64_t* width;
  long long wstride;
  int M;
  uint8_t* avail;
  int32_t* refidx;
  int32_t* poprec;
  int32_t* ctl;
  int64_t* members;
  uint8_t* mvalid;
  int budget, kb, extras_cap;
  long long vec_cap, pad_slot;
  // the plan (ops/replay.py:replay_plan): list capacity (a power of two
  // >= budget + 1), where the lists and the table live, and the global
  // scratch for what is not in shared memory
  int cap;
  unsigned char* scratch;
};

// kListShared / kTabShared: the list buffers / the table in shared memory
// (else in the global scratch buffer); one instantiation per placement, so
// the compiler knows each pointer's memory space.
template <bool kListShared, bool kTabShared>
__global__ void __launch_bounds__(kThreads) replay_pass(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_n, s_k, s_m, s_top;
  __shared__ int s_cand[kMaxBatch];
  __shared__ u64 ckey[2 * kWindow];  // the step's children: keys (0 for
  __shared__ int cref[2 * kWindow];  // none) and leaf indices
  __shared__ Ent csrt[2 * kWindow];  // ... of positive key, in replay order
  const int tid = threadIdx.x, T = blockDim.x, M = a.M;
  const int lane = tid & 31, warp = tid >> 5;
  const unsigned lt_mask = (1u << lane) - 1u;

  const size_t list_bytes = 2 * (size_t)a.cap * sizeof(Ent);
  Ent* la = reinterpret_cast<Ent*>(kListShared ? smem : a.scratch);
  Ent* lb = la + a.cap;
  unsigned char* tp = kTabShared
                          ? smem + (kListShared ? list_bytes : 0)
                          : a.scratch + (kListShared ? 0 : list_bytes);
  u64* tkey = reinterpret_cast<u64*>(tp);
  int32_t* tchild = reinterpret_cast<int32_t*>(tkey + M);
  uint8_t* tsplit = reinterpret_cast<uint8_t*>(tchild + M);

  // ---- the compact table and the unsorted list of available slots (a
  // warp's ballot places its entries; the inputs are read before the pass
  // writes avail or refidx)
  if (tid == 0) s_n = 0;
  __syncthreads();
  // the flag's load in flight with the table's first loads: a pass behind
  // the last one returns before it writes anything
  const int flag0 = a.ctl[kFlag];
  for (int base = 0; base < M; base += kLoad * T) {
    // every load of kLoad slots a thread in flight at once
    u64 key[kLoad];
    int ch[kLoad], ref[kLoad];
    uint8_t spl[kLoad], av[kLoad];
#pragma unroll
    for (int u = 0; u < kLoad; ++u) {
      const int i = base + u * T + tid;
      key[u] = 0ull;
      av[u] = 0;
      if (i < M) {
        key[u] = gain_key(a.gain, a.gstride, a.gain_f64, i);
        ch[u] = (int)__ldg(a.child0 + i);
        spl[u] = __ldg(a.split + i);
        av[u] = __ldg(a.avail + i);
        ref[u] = __ldg(a.refidx + i);
      }
    }
    if (flag0 == kDone) return;  // uniform
#pragma unroll
    for (int u = 0; u < kLoad; ++u) {
      const int i = base + u * T + tid;
      if (i < M) {
        tkey[i] = key[u];
        tchild[i] = ch[u];
        tsplit[i] = spl[u];
      }
      const bool take = i < M && av[u] != 0 && key[u] != 0ull;
      const unsigned bal = __ballot_sync(kFull, take);
      int wbase = 0;
      if (lane == 0 && bal != 0u) wbase = atomicAdd(&s_n, __popc(bal));
      wbase = __shfl_sync(kFull, wbase, 0);
      const int pos = wbase + __popc(bal & lt_mask);
      if (take && pos < a.cap) {
        Ent e;
        e.key = key[u];
        e.ref = ref[u];
        e.slot = i;
        store_ent(la + pos, e);
      }
    }
  }
  __syncthreads();
  int n = s_n;
  bool err = n > a.cap;  // an inconsistent carried state
  if (err) n = 0;
  Ent* L = la;
  Ent* Lo = lb;
  if (n <= T) {
    // a thread per entry: its rank is the entries that come before it
    if (tid < n) {
      const Ent e = load_ent(la + tid);
      // four loads in flight, four counts
      int r0 = 0, r1 = 0, r2 = 0, r3 = 0, y = 0;
      for (; y + 4 <= n; y += 4) {
        const Ent a0 = load_ent(la + y), a1 = load_ent(la + y + 1);
        const Ent a2 = load_ent(la + y + 2), a3 = load_ent(la + y + 3);
        r0 += ahead_of(a0, e);
        r1 += ahead_of(a1, e);
        r2 += ahead_of(a2, e);
        r3 += ahead_of(a3, e);
      }
      for (; y < n; ++y) r0 += ahead_of(load_ent(la + y), e);
      store_ent(lb + r0 + r1 + r2 + r3, e);
    }
    __syncthreads();
    L = lb;
    Lo = la;
  } else {
    int P = 1;
    while (P < n) P <<= 1;
    for (int i = n + tid; i < P; i += T) store_ent(la + i, sentinel());
    __syncthreads();
    bitonic_sort(la, P);
  }

  // ---- steps: pop the longest prefix that sequential pops would take.
  // Within a step every leaf index is distinct (the list's, a popped
  // entry's left child that takes over its index, the right children's
  // new ones), so (key desc, leaf index asc) orders everything a step
  // compares; the values stay in registers as scalars.
  int pops = a.ctl[kPops];
  int flag = kDone, top = -1;
  while (!err && pops < a.budget && n > 0) {
    if (warp == 0) {
      // lane j evaluates entry j of the window: its better child, the
      // best child revealed by the entries ahead of it (a warp scan), and
      // whether it pops
      const int lim = min(min(n, a.budget - pops), kWindow);
      u64 ek = 0ull, k0 = 0ull, k1 = 0ull;
      int er = INT_MAX, es = 0, c0 = 0;
      bool split = false;
      if (lane < lim) {
        const Ent e = load_ent(L + lane);
        ek = e.key;
        er = e.ref;
        es = e.slot;
        split = tsplit[es] != 0;
        if (split) {
          c0 = tchild[es];
          k0 = tkey[c0];
          k1 = tkey[c0 + 1];
        }
      }
      // the better child: the right one only on a larger key (the left
      // keeps the parent's index, smaller than any new one)
      const int r1 = pops + lane + 1;
      u64 bk = k1 > k0 ? k1 : k0;
      int br = k1 > k0 ? r1 : er;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const u64 ok = __shfl_up_sync(kFull, bk, d);
        const int orf = __shfl_up_sync(kFull, br, d);
        if (lane >= d && (ok > bk || (ok == bk && orf < br))) {
          bk = ok;
          br = orf;
        }
      }
      u64 ak = __shfl_up_sync(kFull, bk, 1);
      int ar = __shfl_up_sync(kFull, br, 1);
      if (lane == 0) {
        ak = 0ull;
        ar = INT_MAX;
      }
      const bool pop = lane < lim && split && (ek > ak ||
                                                (ek == ak && er < ar));
      const unsigned okb = __ballot_sync(kFull, pop);
      int k = okb == kFull ? 32 : __ffs(~okb) - 1;
      if (k > 0 && n + k > a.cap) k = -1;  // inconsistent carried state
      if (lane < k) {
        const int pj = pops + lane;
        a.poprec[2 * pj] = es;
        a.poprec[2 * pj + 1] = er;
        a.refidx[c0] = er;
        a.refidx[c0 + 1] = r1;
        a.avail[es] = 0;
        a.avail[c0] = 1;
        a.avail[c0 + 1] = 1;
      }
      // the children of positive key, ranked among themselves: lane j's
      // are children 2j and 2j + 1
      const bool p0 = lane < k && k0 != 0ull, p1 = lane < k && k1 != 0ull;
      ckey[2 * lane] = p0 ? k0 : 0ull;
      ckey[2 * lane + 1] = p1 ? k1 : 0ull;
      cref[2 * lane] = er;
      cref[2 * lane + 1] = r1;
      __syncwarp();
      int q0 = 0, q1 = 0;
      for (int y = 0; y < 2 * k; ++y) {
        const u64 yk = ckey[y];
        const int yr = cref[y];
        q0 += yk > k0 || (yk == k0 && yr < er) ? 1 : 0;
        q1 += yk > k1 || (yk == k1 && yr < r1) ? 1 : 0;
      }
      if (p0) {
        Ent c;
        c.key = k0;
        c.ref = er;
        c.slot = c0;
        store_ent(csrt + q0, c);
      }
      if (p1) {
        Ent c;
        c.key = k1;
        c.ref = r1;
        c.slot = c0 + 1;
        store_ent(csrt + q1, c);
      }
      const int m = __popc(__ballot_sync(kFull, p0)) +
                    __popc(__ballot_sync(kFull, p1));
      if (lane == 0) {
        s_k = k;
        s_m = m;
        s_top = es;
      }
    }
    __syncthreads();
    const int k = s_k, m = s_m;
    if (k <= 0) {
      if (k == 0) {  // the head is unsplit: stall
        flag = kStall;
        top = s_top;
      } else {
        err = true;
      }
      break;
    }
    // merge the list's rest and the children into the other buffer: the
    // thread at position i places L[i] after the children before it, and
    // each child that falls between L[i - 1] and L[i]
    for (int i = k + tid; i <= n; i += T) {
      const bool has = i < n;
      u64 vk = 0ull, pk = ~0ull;
      int vr = INT_MAX, pr = -1;
      Ent v;
      if (has) {
        v = load_ent(L + i);
        vk = v.key;
        vr = v.ref;
      }
      if (i > k) {
        const Ent pv = load_ent(L + i - 1);
        pk = pv.key;
        pr = pv.ref;
      }
      int cnt = 0;
      for (int r = 0; r < m; ++r) {
        const Ent c = load_ent(csrt + r);
        // c ahead of L[i] (always past the end), behind L[i - 1]
        const bool ahead = !has || c.key > vk || (c.key == vk && c.ref < vr);
        const bool behind = pk > c.key || (pk == c.key && pr < c.ref);
        if (ahead && behind) store_ent(Lo + r + i - k, c);
        cnt += ahead ? 1 : 0;
      }
      if (has) store_ent(Lo + i - k + cnt, v);
    }
    __syncthreads();
    Ent* t = L;
    L = Lo;
    Lo = t;
    n += m - k;
    pops += k;
  }

  // ---- the correction's members, then the counters (warp 0)
  if (tid >= 32) return;
  int extras = a.ctl[kExtras];
  int nm = 0;
  if (flag == kStall) {
    if (a.kb == 1) {
      if (lane == 0) {
        a.members[0] = top;
        a.mvalid[0] = 1;
      }
      nm = 1;
    } else {
      // the first kb unsplit entries of the list, in replay order (the
      // head, the stalled top, first)
      int found = 0;
      for (int base = 0; base < n && found < a.kb; base += 32) {
        const int i = base + lane;
        const int slot = i < n ? load_ent(L + i).slot : 0;
        const bool u = i < n && tsplit[slot] == 0;
        const unsigned bal = __ballot_sync(kFull, u);
        const int r = found + __popc(bal & lt_mask);
        if (u && r < a.kb) s_cand[r] = slot;
        found += __popc(bal);
      }
      found = min(found, a.kb);
      __syncwarp();
      for (int base = 0; base < found; base += 32) {
        const int j = base + lane;
        int s = 0;
        bool take = false;
        if (j < found) {
          s = s_cand[j];
          take = j == 0 ||
                 (extras + j - 1 < a.extras_cap &&
                  a.width[(long long)s * a.wstride] <= a.vec_cap);
        }
        const unsigned bal = __ballot_sync(kFull, take);
        if (take) {
          const int o = nm + __popc(bal & lt_mask);
          a.members[o] = s;
          a.mvalid[o] = 1;
        }
        nm += __popc(bal);
      }
      extras += nm - 1;
    }
  }
  for (int j = nm + lane; j < a.kb; j += 32) {
    a.members[j] = a.pad_slot;
    a.mvalid[j] = 0;
  }
  if (lane == 0) {
    a.ctl[kPops] = pops;
    a.ctl[kExtras] = extras;
    a.ctl[kFlag] = err ? kDone : flag;
    a.ctl[kPasses] += 1;
    a.ctl[kStallEvents] += flag == kStall;
    a.ctl[kStallSplits] += nm;
    a.ctl[kError] |= err ? 1 : 0;
  }
}

}  // namespace

extern "C" {

// Launch one pass on `stream` (one block of 512 threads).  gain is float32
// (gain_f64 = 0) or float64 with element stride gstride; width is int64
// with element stride wstride.  cap, list_smem, tab_smem, smem and the
// scratch buffer are ops/replay.py:replay_plan's.  Returns
// cudaGetLastError() after the launch.
int lgbt_replay(const void* gain, long long gstride, int gain_f64,
                const void* split, const void* child0, const void* width,
                long long wstride, int M, void* avail, void* refidx,
                void* poprec, void* ctl, void* members, void* mvalid,
                int budget, int kb, int extras_cap, long long vec_cap,
                long long pad_slot, int cap, int list_smem, int tab_smem,
                long long smem, void* scratch, void* stream) {
  if (kb < 1 || kb > kMaxBatch || cap < 1) return (int)cudaErrorInvalidValue;
  void (*const kernels[4])(Args) = {
      replay_pass<false, false>, replay_pass<false, true>,
      replay_pass<true, false>, replay_pass<true, true>};
  const int variant = (list_smem ? 2 : 0) + (tab_smem ? 1 : 0);
  // the dynamic shared-memory limit, raised per device and variant to the
  // largest size asked so far
  static long long raised[64][4] = {{0}};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (smem > 48 * 1024 && dev < 64 && smem > raised[dev][variant]) {
    err = cudaFuncSetAttribute(kernels[variant],
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    raised[dev][variant] = smem;
  }
  Args a;
  a.gain = gain;
  a.gstride = gstride;
  a.gain_f64 = gain_f64;
  a.split = static_cast<const uint8_t*>(split);
  a.child0 = static_cast<const int64_t*>(child0);
  a.width = static_cast<const int64_t*>(width);
  a.wstride = wstride;
  a.M = M;
  a.avail = static_cast<uint8_t*>(avail);
  a.refidx = static_cast<int32_t*>(refidx);
  a.poprec = static_cast<int32_t*>(poprec);
  a.ctl = static_cast<int32_t*>(ctl);
  a.members = static_cast<int64_t*>(members);
  a.mvalid = static_cast<uint8_t*>(mvalid);
  a.budget = budget;
  a.kb = kb;
  a.extras_cap = extras_cap;
  a.vec_cap = vec_cap;
  a.pad_slot = pad_slot;
  a.cap = cap;
  a.scratch = static_cast<unsigned char*>(scratch);
  kernels[variant]<<<1, kThreads, (size_t)smem,
                     static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
