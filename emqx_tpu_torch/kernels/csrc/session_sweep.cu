// Kernel 12: the session store's retransmit and expiry sweep.
//
// Replaces the sweep half of `session_ack_impl`
// (emqx_tpu/ops/session_table.py:76, lines 107-131), which runs over the
// session lanes AFTER the rider's scatter:
//   due     = ascending row ids r with sess_slot[r] >= 0, sess_state[r] in
//             {1, 2} (publish or rel phase) and now - sess_ts[r] >= retry,
//             the difference taken in int32 with wraparound;
//   expired = ascending slots s with 0 < slot_expiry[s] <= now;
// each left-packed into sweep_k entries, -1 padded, beside its UNCAPPED
// count (JAX: `_compact` of `where(mask, arange, -1)` and `sum(mask)`).
//
// Bound: bytes. The function reads three row lanes (12 bytes a row) and the
// slot lane (4 bytes a slot) once and writes 2 x sweep_k x 4 bytes.
//
// Design: ONE launch, an ordered compaction with decoupled look-back
// (single-pass prefix scan). Blocks [0, nb_due) of the logical order cover
// rows, the rest slots, kSpan elements each; the two halves are two
// independent prefix chains. Each block
//   1. takes its logical index from an atomic ticket (`ticket - base`), so
//      it only ever waits on blocks that took a ticket before it, which are
//      running;
//   2. reads its elements once, each thread 16 of them as kVec 16-byte
//      streaming loads a lane (a scalar path where a base is not 16-byte
//      aligned or at the ragged end), each vector load coalesced across the
//      warp;
//   3. counts its hits (a 4 x 8-bit packed warp scan of the per-vector
//      counts, then the warp totals) and publishes the count as its
//      AGGREGATE, or as its inclusive PREFIX if it opens its half; warp 1
//      meanwhile adds it to its half's total (below);
//   4. looks back (warp 0, 32 predecessors a round) summing aggregates up
//      to the nearest prefix, then publishes its own prefix. The walk stops
//      as soon as the published words it has seen already sum to sweep_k
//      or more: such a block stores nothing, and publishes a prefix of
//      sweep_k (saturated: "at or past sweep_k"), so its successors stop
//      too without waiting on every predecessor;
//   5. stores its hits at (prefix + rank) when that is below sweep_k.
// The uncapped totals do not come from the chain: every block adds one
// block and its count to its half's word (done << 40 | hits) with one
// atomic; the block that completes a half writes that total and the
// half's -1 tail, and zeroes the word for the next call.
// A status word is (epoch << 32 | prefix flag << 31 | value): the wrapper
// passes a fresh nonzero epoch each call, so words of earlier calls read as
// "not yet published" and the status array is never cleared between calls.
// Scratch (the wrapper's, zeroed once): the 64-bit ticket counter, the
// word of each half, then one status word a block.
#include "common.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kVec = 4;  // 16-byte vectors a lane, per lane array
constexpr int kPerThread = 4 * kVec;      // elements a thread
constexpr int kWarpSpan = 32 * kPerThread;
constexpr long long kSpan = static_cast<long long>(kThreads) * kPerThread;
// 3 blocks an SM leave 40 registers a thread and no spill (4 forced 32
// registers and a spill, and ran 0-4% slower on an NVIDIA H100 80GB HBM3 at
// 700 W; PERF.md, the session_sweep A/B)
constexpr int kBlocksPerSm = 3;
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr unsigned long long kPrefix = 1ull << 31;
constexpr unsigned long long kValue = kPrefix - 1;
constexpr int kDoneShift = 40;  // a half's word: blocks done << 40 | hits
constexpr unsigned long long kTotalMask = (1ull << kDoneShift) - 1;

struct Args {
  const int32_t* slot;
  const int32_t* state;
  const int32_t* ts;
  long long cap;
  const int32_t* expiry;
  long long scap;
  int32_t now;
  int32_t retry;
  long long nb_due;
  long long nb_total;
  bool vec_rows;  // the three row lanes are 16-byte aligned
  bool vec_slots;
  unsigned long long* ticket;
  unsigned long long* halves;  // [2]: each half's blocks done and hits
  unsigned long long* status;
  unsigned long long base;
  unsigned long long epoch;
  int32_t* due;
  int32_t* expired;
  int32_t* counts;  // [2]: the uncapped totals
  int sweep_k;
};

__device__ __forceinline__ bool due_hit(int32_t slot, int32_t st, int32_t ts, int32_t now,
                                        int32_t retry) {
  // int32 now - ts with wraparound: unsigned subtract, then the cast
  const int32_t age =
      static_cast<int32_t>(static_cast<uint32_t>(now) - static_cast<uint32_t>(ts));
  return slot >= 0 && (st == 1 || st == 2) && age >= retry;
}

__device__ __forceinline__ bool exp_hit(int32_t e, int32_t now) { return e > 0 && now >= e; }

// The hit bits of one thread's 16 elements, bit v*4 + j for element
// first + v*128 + j (lane-strided vectors: one warp instruction reads 512
// contiguous bytes).
__device__ __forceinline__ unsigned thread_hits(const Args& a, bool exp, long long first) {
  unsigned mask = 0;
  const long long n = exp ? a.scap : a.cap;
  const bool vec = exp ? a.vec_slots : a.vec_rows;
  if (vec && first + (kVec - 1) * 128 + 3 < n) {
    if (exp) {
      int4 e[kVec];
#pragma unroll
      for (int v = 0; v < kVec; ++v)
        e[v] = __ldcs(reinterpret_cast<const int4*>(a.expiry + first + v * 128));
#pragma unroll
      for (int v = 0; v < kVec; ++v) {
        mask |= (exp_hit(e[v].x, a.now) ? 1u : 0u) << (4 * v);
        mask |= (exp_hit(e[v].y, a.now) ? 2u : 0u) << (4 * v);
        mask |= (exp_hit(e[v].z, a.now) ? 4u : 0u) << (4 * v);
        mask |= (exp_hit(e[v].w, a.now) ? 8u : 0u) << (4 * v);
      }
    } else {
      int4 s[kVec], st[kVec], t[kVec];
#pragma unroll
      for (int v = 0; v < kVec; ++v) {
        s[v] = __ldcs(reinterpret_cast<const int4*>(a.slot + first + v * 128));
        st[v] = __ldcs(reinterpret_cast<const int4*>(a.state + first + v * 128));
        t[v] = __ldcs(reinterpret_cast<const int4*>(a.ts + first + v * 128));
      }
#pragma unroll
      for (int v = 0; v < kVec; ++v) {
        mask |= (due_hit(s[v].x, st[v].x, t[v].x, a.now, a.retry) ? 1u : 0u) << (4 * v);
        mask |= (due_hit(s[v].y, st[v].y, t[v].y, a.now, a.retry) ? 2u : 0u) << (4 * v);
        mask |= (due_hit(s[v].z, st[v].z, t[v].z, a.now, a.retry) ? 4u : 0u) << (4 * v);
        mask |= (due_hit(s[v].w, st[v].w, t[v].w, a.now, a.retry) ? 8u : 0u) << (4 * v);
      }
    }
    return mask;
  }
  for (int v = 0; v < kVec; ++v) {
    for (int j = 0; j < 4; ++j) {
      const long long i = first + v * 128 + j;
      if (i >= n) continue;
      const bool h = exp ? exp_hit(a.expiry[i], a.now)
                         : due_hit(a.slot[i], a.state[i], a.ts[i], a.now, a.retry);
      mask |= (h ? 1u : 0u) << (4 * v + j);
    }
  }
  return mask;
}

__device__ __forceinline__ unsigned long long load_status(const unsigned long long* p) {
  return *reinterpret_cast<const volatile unsigned long long*>(p);
}

__device__ __forceinline__ void store_status(unsigned long long* p, unsigned long long w) {
  *reinterpret_cast<volatile unsigned long long*>(p) = w;
}

__global__ void __launch_bounds__(kThreads, kBlocksPerSm) sweep_kernel(Args a) {
  __shared__ long long s_tix;
  __shared__ int s_warp[kWarps];
  __shared__ long long s_excl;
  __shared__ long long s_total;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) s_tix = static_cast<long long>(atomicAdd(a.ticket, 1ull) - a.base);
  __syncthreads();
  const long long tix = s_tix;
  const bool exp = tix >= a.nb_due;
  const long long lo = exp ? a.nb_due : 0;            // first block of this half
  const long long hi = exp ? a.nb_total : a.nb_due;   // one past its last
  const long long blk = tix - lo;
  const long long first = blk * kSpan + warp * kWarpSpan + lane * 4;
  const unsigned mask = thread_hits(a, exp, first);

  // per-vector counts packed 8 bits each (a warp's field is at most 128)
  unsigned packed = 0;
#pragma unroll
  for (int v = 0; v < kVec; ++v) packed |= __popc((mask >> (4 * v)) & 0xFu) << (8 * v);
  unsigned incl = packed;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const unsigned y = __shfl_up_sync(kFull, incl, d);
    if (lane >= d) incl += y;
  }
  const unsigned wtot = __shfl_sync(kFull, incl, 31);
  const unsigned lane_excl = incl - packed;
  if (lane == 0) {
    int t = 0;
#pragma unroll
    for (int v = 0; v < kVec; ++v) t += (wtot >> (8 * v)) & 0xFFu;
    s_warp[warp] = t;
  }
  __syncthreads();
  int warp_excl = 0;
  int agg = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const int c = s_warp[w];
    warp_excl += w < warp ? c : 0;
    agg += c;
  }

  const long long k = a.sweep_k;
  // warp 1 adds the count and one block to the half's word while warp 0
  // looks back; the half's last block reads the total and zeroes the word
  if (threadIdx.x == 32) {
    unsigned long long* half = a.halves + (exp ? 1 : 0);
    const unsigned long long old =
        atomicAdd(half, (1ull << kDoneShift) | static_cast<unsigned long long>(agg));
    if ((old >> kDoneShift) == static_cast<unsigned long long>(hi - lo - 1)) {
      s_total = static_cast<long long>(old & kTotalMask) + agg;
      *half = 0;
    } else {
      s_total = -1;
    }
  }
  if (warp == 0) {  // publish, look back, publish the prefix
    const unsigned long long tag = a.epoch << 32;
    long long excl = 0;
    bool exact = true;
    if (tix == lo) {
      if (lane == 0) store_status(a.status + tix, tag | kPrefix | static_cast<unsigned>(agg));
    } else {
      if (lane == 0) store_status(a.status + tix, tag | static_cast<unsigned>(agg));
      long long j = tix - 1;
      while (true) {
        const long long idx = j - lane;
        unsigned long long w = tag | kPrefix;  // before the half: a zero prefix
        if (idx >= lo) w = load_status(a.status + idx);
        const bool valid = (w >> 32) == a.epoch;
        const unsigned pm = __ballot_sync(kFull, valid && (w & kPrefix) != 0);
        const int stop = pm ? __ffs(pm) - 1 : 31;  // the nearest published prefix
        long long v = (valid && lane <= stop) ? static_cast<long long>(w & kValue) : 0;
#pragma unroll
        for (int d = 16; d > 0; d >>= 1) v += __shfl_xor_sync(kFull, v, d);
        if (excl + v >= k) {  // what is published already reaches sweep_k
          exact = false;
          break;
        }
        if (__ballot_sync(kFull, !valid && lane <= stop)) continue;  // read again
        excl += v;
        if (pm) break;
        j -= 32;
      }
      if (lane == 0) {
        store_status(a.status + tix,
                     tag | kPrefix | static_cast<unsigned long long>(exact ? excl + agg : k));
      }
    }
    if (lane == 0) s_excl = exact ? excl : k;
  }
  __syncthreads();
  const long long excl = s_excl;
  const long long total = s_total;
  int32_t* out = exp ? a.expired : a.due;
  if (total >= 0) {  // the half's uncapped count, and its -1 tail
    if (threadIdx.x == 0) a.counts[exp ? 1 : 0] = static_cast<int32_t>(total);
    for (long long p = (total < k ? total : k) + threadIdx.x; p < k; p += kThreads) out[p] = -1;
  }
  if (excl >= k || mask == 0) return;
  // this thread's hits in order: vector v, then j
  long long pos = excl + warp_excl;
#pragma unroll
  for (int v = 0; v < kVec; ++v) {
    const unsigned before = (lane_excl >> (8 * v)) & 0xFFu;
    unsigned m = (mask >> (4 * v)) & 0xFu;
    long long p = pos + before;
    while (m) {
      const int j = __ffs(m) - 1;
      m &= m - 1;
      if (p < k) out[p] = static_cast<int32_t>(first + v * 128 + j);
      ++p;
    }
    pos += (wtot >> (8 * v)) & 0xFFu;
  }
}

long long blocks_for(long long n) { return (n + kSpan - 1) / kSpan; }

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

}  // namespace

// Blocks (tickets and status words) of one call over `cap` rows and
// `scap` slots.
EMQX_EXPORT long long emqx_sweep_blocks(long long cap, long long scap) {
  return blocks_for(cap) + blocks_for(scap);
}

// One launch. scratch: the 64-bit ticket counter, the two halves' words,
// then emqx_sweep_blocks status words (zeroed once by the wrapper); base:
// the tickets taken by the earlier calls on this scratch; epoch: nonzero,
// new each call (< 2^32). counts: int32 [2], the uncapped totals.
EMQX_EXPORT int emqx_session_sweep(const void* slot, const void* state, const void* ts,
                                   long long cap, const void* expiry, long long scap,
                                   int now, int retry, void* scratch,
                                   unsigned long long base, unsigned long long epoch,
                                   void* due, void* expired, void* counts, int sweep_k,
                                   void* stream) {
  Args a;
  a.slot = static_cast<const int32_t*>(slot);
  a.state = static_cast<const int32_t*>(state);
  a.ts = static_cast<const int32_t*>(ts);
  a.cap = cap;
  a.expiry = static_cast<const int32_t*>(expiry);
  a.scap = scap;
  a.now = static_cast<int32_t>(now);
  a.retry = static_cast<int32_t>(retry);
  a.nb_due = blocks_for(cap);
  a.nb_total = a.nb_due + blocks_for(scap);
  a.vec_rows = aligned16(slot) && aligned16(state) && aligned16(ts);
  a.vec_slots = aligned16(expiry);
  a.ticket = static_cast<unsigned long long*>(scratch);
  a.halves = a.ticket + 1;
  a.status = a.ticket + 3;
  a.base = base;
  a.epoch = epoch;
  a.due = static_cast<int32_t*>(due);
  a.expired = static_cast<int32_t*>(expired);
  a.counts = static_cast<int32_t*>(counts);
  a.sweep_k = sweep_k;
  sweep_kernel<<<static_cast<unsigned>(a.nb_total), kThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
