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
// Design: an ordered left-pack across the grid in three launches, over the
// row lanes and the slot lane together (blocks [0, nb_due) cover rows,
// the rest cover slots; each block covers kSpan elements as kItems tiles
// of kThreads):
//   1. sweep_count: per block, the hits of each tile by __ballot_sync +
//      __popc per warp, summed over the warps;
//   2. sweep_scan: ONE block of 1024 threads scans the block counts of each
//      half into exclusive offsets (1024 counts a round, a carry between
//      rounds, so any number of blocks) and writes the two uncapped totals;
//   3. sweep_write: per block, tile by tile, each hit's position is its
//      block's offset + the hits of the earlier warps of the tile + its rank
//      in its warp's ballot, stored when < sweep_k; a block whose offset is
//      already past sweep_k, or that holds no hit, stops there. The threads
//      of each half also write -1 over [min(total, sweep_k), sweep_k).
// Scratch (the wrapper's): block counts and offsets, int32 [blocks] each.
// Indices are 64-bit; a row id is stored as int32 (tables below 2^31 rows).
//
// Bound: bytes. The function reads three row lanes (12 bytes a row) and the
// slot lane (4 bytes a slot) once and writes 2 x sweep_k x 4 bytes; pass 1
// reads everything, pass 3 again only the blocks that store hits.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 8;
constexpr long long kSpan = static_cast<long long>(kThreads) * kItems;
constexpr int kScanThreads = 1024;
constexpr unsigned kFull = 0xFFFFFFFFu;

struct Lanes {
  const int32_t* slot;
  const int32_t* state;
  const int32_t* ts;
  long long cap;
  const int32_t* expiry;
  long long scap;
  int32_t now;
  int32_t retry;
};

// element i of half `exp` (false: rows, true: slots) is a hit
__device__ __forceinline__ bool hit(const Lanes& a, bool exp, long long i) {
  if (exp) {
    if (i >= a.scap) return false;
    const int32_t e = a.expiry[i];
    return e > 0 && a.now >= e;
  }
  if (i >= a.cap || a.slot[i] < 0) return false;
  const int32_t st = a.state[i];
  // int32 now - ts with wraparound: unsigned subtract, then the cast
  const int32_t age = static_cast<int32_t>(static_cast<uint32_t>(a.now) -
                                           static_cast<uint32_t>(a.ts[i]));
  return (st == 1 || st == 2) && age >= a.retry;
}

__global__ void __launch_bounds__(kThreads)
    sweep_count(Lanes a, long long nb_due, int32_t* __restrict__ counts) {
  const bool exp = blockIdx.x >= nb_due;
  const long long base = (exp ? blockIdx.x - nb_due : blockIdx.x) * kSpan;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int n = 0;
  for (int t = 0; t < kItems; ++t) {
    const long long i = base + static_cast<long long>(t) * kThreads + threadIdx.x;
    n += __popc(__ballot_sync(kFull, hit(a, exp, i)));
  }
  __shared__ int s[kWarps];
  if (lane == 0) s[warp] = n;
  __syncthreads();
  if (threadIdx.x == 0) {
    int total = 0;
    for (int w = 0; w < kWarps; ++w) total += s[w];
    counts[blockIdx.x] = total;
  }
}

__global__ void __launch_bounds__(kScanThreads)
    sweep_scan(const int32_t* __restrict__ counts, int32_t* __restrict__ offsets,
               long long nb_due, long long nb_total, int32_t* __restrict__ totals) {
  __shared__ long long sums[kScanThreads / 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int half = 0; half < 2; ++half) {
    const long long lo = half ? nb_due : 0;
    const long long hi = half ? nb_total : nb_due;
    long long carry = 0;  // the same in every thread
    for (long long b0 = lo; b0 < hi; b0 += kScanThreads) {
      const long long b = b0 + threadIdx.x;
      const long long v = b < hi ? counts[b] : 0;
      long long x = v;  // inclusive scan within the warp
      for (int d = 1; d < 32; d <<= 1) {
        const long long y = __shfl_up_sync(kFull, x, d);
        if (lane >= d) x += y;
      }
      if (lane == 31) sums[warp] = x;
      __syncthreads();
      if (warp == 0) {  // inclusive scan of the 32 warp sums
        long long w = sums[lane];
        for (int d = 1; d < 32; d <<= 1) {
          const long long y = __shfl_up_sync(kFull, w, d);
          if (lane >= d) w += y;
        }
        sums[lane] = w;
      }
      __syncthreads();
      if (b < hi) {
        offsets[b] = static_cast<int32_t>(carry + (warp ? sums[warp - 1] : 0) + x - v);
      }
      carry += sums[kScanThreads / 32 - 1];
      __syncthreads();  // sums is rewritten by the next round
    }
    if (threadIdx.x == 0) totals[half] = static_cast<int32_t>(carry);
  }
}

__global__ void __launch_bounds__(kThreads)
    sweep_write(Lanes a, long long nb_due, const int32_t* __restrict__ counts,
                const int32_t* __restrict__ offsets, const int32_t* __restrict__ totals,
                int32_t* __restrict__ due, int32_t* __restrict__ expired, int sweep_k) {
  const bool exp = blockIdx.x >= nb_due;
  const long long blk = exp ? blockIdx.x - nb_due : blockIdx.x;
  const long long half_blocks = exp ? gridDim.x - nb_due : nb_due;
  int32_t* out = exp ? expired : due;
  // the -1 tail of this half, strided over all of its threads
  const long long total = totals[exp ? 1 : 0];
  const long long filled = total < sweep_k ? total : sweep_k;
  for (long long p = filled + blk * kThreads + threadIdx.x; p < sweep_k;
       p += half_blocks * kThreads) {
    out[p] = -1;
  }
  long long off = offsets[blockIdx.x];  // the same in every thread
  if (counts[blockIdx.x] == 0 || off >= sweep_k) return;
  const long long base = blk * kSpan;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned below = (1u << lane) - 1u;
  __shared__ int s[kWarps];
  for (int t = 0; t < kItems && off < sweep_k; ++t) {
    const long long i = base + static_cast<long long>(t) * kThreads + threadIdx.x;
    const bool h = hit(a, exp, i);
    const unsigned m = __ballot_sync(kFull, h);
    if (lane == 0) s[warp] = __popc(m);
    __syncthreads();
    int before = 0;
    int tile = 0;
    for (int w = 0; w < kWarps; ++w) {
      const int c = s[w];
      if (w < warp) before += c;
      tile += c;
    }
    if (h) {
      const long long p = off + before + __popc(m & below);
      if (p < sweep_k) out[p] = static_cast<int32_t>(i);
    }
    off += tile;
    __syncthreads();  // s is rewritten by the next tile
  }
}

Lanes lanes(const void* slot, const void* state, const void* ts, long long cap,
            const void* expiry, long long scap, int now, int retry) {
  return Lanes{static_cast<const int32_t*>(slot), static_cast<const int32_t*>(state),
               static_cast<const int32_t*>(ts), cap,
               static_cast<const int32_t*>(expiry), scap,
               static_cast<int32_t>(now), static_cast<int32_t>(retry)};
}

long long blocks_for(long long n) { return (n + kSpan - 1) / kSpan; }

}  // namespace

// The wrapper sizes its scratch with this (rows or slots per block).
EMQX_EXPORT long long emqx_sweep_block_span() { return kSpan; }

// The wrapper launches the three kernels in order, one C call each.

EMQX_EXPORT int emqx_sweep_count(const void* slot, const void* state, const void* ts,
                                 long long cap, const void* expiry, long long scap,
                                 int now, int retry, void* counts, void* stream) {
  const long long nb_due = blocks_for(cap);
  const unsigned grid = static_cast<unsigned>(nb_due + blocks_for(scap));
  sweep_count<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      lanes(slot, state, ts, cap, expiry, scap, now, retry), nb_due,
      static_cast<int32_t*>(counts));
  return static_cast<int>(cudaGetLastError());
}

EMQX_EXPORT int emqx_sweep_scan(const void* counts, void* offsets, long long cap,
                                long long scap, void* totals, void* stream) {
  const long long nb_due = blocks_for(cap);
  sweep_scan<<<1, kScanThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(counts), static_cast<int32_t*>(offsets), nb_due,
      nb_due + blocks_for(scap), static_cast<int32_t*>(totals));
  return static_cast<int>(cudaGetLastError());
}

EMQX_EXPORT int emqx_sweep_write(const void* slot, const void* state, const void* ts,
                                 long long cap, const void* expiry, long long scap,
                                 int now, int retry, const void* counts,
                                 const void* offsets, const void* totals, void* due,
                                 void* expired, int sweep_k, void* stream) {
  const long long nb_due = blocks_for(cap);
  const unsigned grid = static_cast<unsigned>(nb_due + blocks_for(scap));
  sweep_write<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      lanes(slot, state, ts, cap, expiry, scap, now, retry), nb_due,
      static_cast<const int32_t*>(counts), static_cast<const int32_t*>(offsets),
      static_cast<const int32_t*>(totals), static_cast<int32_t*>(due),
      static_cast<int32_t*>(expired), sweep_k);
  return static_cast<int>(cudaGetLastError());
}
