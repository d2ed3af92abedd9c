// Kernel 6: the residual-NFA walk of a batch of tokenized topics.
//
// Replaces `batch_match_syms` with `_probe_edges`, `_compact` and
// `_append` (emqx_tpu/ops/matcher.py:139, :84, :110, :125): the whole
// `lax.scan` over levels runs inside one launch. Per level lvl < nwords,
// in frontier order: append hash_filter[state] (unless lvl == 0 on a `$`
// topic); probe the literal edge (state, sym) in the open-addressing edge
// table (first hit among `probes` slots; tombstones, edge_node == -2,
// never equal a state); take plus_child[state] under the same `$` rule;
// then left-pack [literal children..., plus children...] into the next
// frontier of F slots, flagging an active row whose count exceeds F. After
// the scan, rows with nwords <= L append term_filter and then hash_filter
// of every surviving state. `matched` keeps the JAX order bit for bit;
// the match count is uncapped and writes at or past K are dropped.
//
// Bound: latency of dependent reads, then bytes. Per row it reads L
// symbols and writes K + 4 words, plus a few random table reads per live
// state and level (a 12-byte edge slot per probe, one word each for the
// `#`, `+` and terminal filters); no arithmetic to speak of. Each level
// depends on the last, so the design spreads rows, not levels: one warp
// per topic row, lane i holding frontier state i (a loop over chunks of
// 32 for F > 32). The order-keeping compaction and the appends are a
// `__ballot_sync` plus a `__popc` of the lanes below, with no scan and no
// shared-memory atomics; the frontier is double-buffered in shared memory
// (2 x F words per warp) so the next frontier is written while the
// current one is read.
#include "common.cuh"

namespace {

constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr uint32_t kEdgeMulNode = 0x9E3779B1u;  // nfa.py EDGE_H_MUL_NODE
constexpr uint32_t kEdgeMulSym = 0x85EBCA77u;   // EDGE_H_MUL_SYM
constexpr int kEdgeShift = 15;                  // EDGE_H_SHIFT

__device__ __forceinline__ int32_t probe_edge(
    int32_t node, int32_t sym, const int32_t* __restrict__ edge_node,
    const int32_t* __restrict__ edge_sym,
    const int32_t* __restrict__ edge_child, uint32_t emask, int probes) {
  uint32_t h = static_cast<uint32_t>(node) * kEdgeMulNode +
               static_cast<uint32_t>(sym) * kEdgeMulSym;
  h ^= h >> kEdgeShift;
  for (int p = 0; p < probes; ++p) {
    const uint32_t idx = (h + static_cast<uint32_t>(p)) & emask;
    if (edge_node[idx] == node && edge_sym[idx] == sym) return edge_child[idx];
  }
  return -1;
}

// Append the lanes' v >= 0 in lane order at the row's running count.
__device__ __forceinline__ void append(int32_t v, int lane, int32_t* mrow,
                                       int K, int& mcount) {
  const unsigned m = __ballot_sync(kFull, v >= 0);
  if (v >= 0) {
    const int pos = mcount + __popc(m & ((1u << lane) - 1u));
    if (pos < K) mrow[pos] = v;
  }
  mcount += __popc(m);
}

// Write the lanes' v >= 0 in lane order into nxt at base + rank (< F).
__device__ __forceinline__ void pack(int32_t v, int lane, int32_t* nxt,
                                     int F, int& base) {
  const unsigned m = __ballot_sync(kFull, v >= 0);
  if (v >= 0) {
    const int pos = base + __popc(m & ((1u << lane) - 1u));
    if (pos < F) nxt[pos] = v;
  }
  base += __popc(m);
}

__global__ void nfa_walk_kernel(
    const int32_t* __restrict__ syms, const int32_t* __restrict__ nwords,
    const bool* __restrict__ dollar, const int32_t* __restrict__ plus_child,
    const int32_t* __restrict__ hash_filter,
    const int32_t* __restrict__ term_filter,
    const int32_t* __restrict__ edge_node,
    const int32_t* __restrict__ edge_sym,
    const int32_t* __restrict__ edge_child, uint32_t emask,
    int32_t* __restrict__ matched, int32_t* __restrict__ mcount_out,
    bool* __restrict__ flags, int B, int L, int F, int K, int probes) {
  extern __shared__ int32_t smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long row =
      static_cast<long long>(blockIdx.x) * (blockDim.x >> 5) + warp;
  if (row >= B) return;  // uniform across the warp
  int32_t* cur = smem + static_cast<size_t>(warp) * 2 * F;
  int32_t* nxt = cur + F;
  int32_t* mrow = matched + row * K;
  for (int k = lane; k < K; k += 32) mrow[k] = -1;
  if (lane == 0) cur[0] = 0;  // the root
  __syncwarp();
  int nf = 1;  // live states, left-packed in cur[0, nf)
  int mcount = 0;
  bool fover = false;
  const int nw = nwords[row];
  const bool dl = dollar[row];
  const int32_t* srow = syms + row * L;
  for (int lvl = 0; lvl < L && lvl < nw; ++lvl) {
    const int32_t sym = srow[lvl];
    const bool wild = !(lvl == 0 && dl);
    int nlit = 0;
    for (int c = 0; c < nf; c += 32) {
      const int i = c + lane;
      const int32_t s = i < nf ? cur[i] : -1;
      append(s >= 0 && wild ? hash_filter[s] : -1, lane, mrow, K, mcount);
      const int32_t lit =
          s >= 0 && sym >= 0
              ? probe_edge(s, sym, edge_node, edge_sym, edge_child, emask,
                           probes)
              : -1;
      pack(lit, lane, nxt, F, nlit);
    }
    int total = nlit;
    if (wild) {
      for (int c = 0; c < nf; c += 32) {
        const int i = c + lane;
        pack(i < nf ? plus_child[cur[i]] : -1, lane, nxt, F, total);
      }
    }
    fover |= total > F;
    nf = min(total, F);
    __syncwarp();
    int32_t* t = cur;
    cur = nxt;
    nxt = t;
  }
  const bool done = nw <= L;
  if (done) {
    for (int c = 0; c < nf; c += 32) {
      const int i = c + lane;
      append(i < nf ? term_filter[cur[i]] : -1, lane, mrow, K, mcount);
    }
    for (int c = 0; c < nf; c += 32) {
      const int i = c + lane;
      append(i < nf ? hash_filter[cur[i]] : -1, lane, mrow, K, mcount);
    }
  }
  if (lane == 0) {
    const bool mover = mcount > K;
    mcount_out[row] = min(mcount, K);
    flags[row] = fover || mover || !done;  // flags
    flags[B + row] = !done;                // too_deep
    flags[2LL * B + row] = fover;          // frontier_overflow
    flags[3LL * B + row] = mover;          // match_overflow
  }
}

}  // namespace

EMQX_EXPORT int emqx_nfa_walk(const void* syms, const void* nwords,
                              const void* dollar, const void* plus_child,
                              const void* hash_filter, const void* term_filter,
                              const void* edge_node, const void* edge_sym,
                              const void* edge_child, long long E,
                              void* matched, void* mcount, void* flags, int B,
                              int L, int F, int K, int probes, void* stream) {
  if (B > 0) {
    // 8 warps (rows) per block while their two frontier buffers fit in
    // 48 KB of shared memory, fewer for very wide frontiers
    int warps = 8;
    while (warps > 1 && static_cast<size_t>(warps) * 2 * F * 4 > 49152)
      warps >>= 1;
    const size_t smem = static_cast<size_t>(warps) * 2 * F * 4;
    const unsigned blocks = static_cast<unsigned>((B + warps - 1) / warps);
    nfa_walk_kernel<<<blocks, warps * 32, smem,
                      static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(syms), static_cast<const int32_t*>(nwords),
        static_cast<const bool*>(dollar),
        static_cast<const int32_t*>(plus_child),
        static_cast<const int32_t*>(hash_filter),
        static_cast<const int32_t*>(term_filter),
        static_cast<const int32_t*>(edge_node),
        static_cast<const int32_t*>(edge_sym),
        static_cast<const int32_t*>(edge_child),
        static_cast<uint32_t>(E - 1), static_cast<int32_t*>(matched),
        static_cast<int32_t*>(mcount), static_cast<bool*>(flags), B, L, F, K,
        probes);
  }
  return static_cast<int>(cudaGetLastError());
}
