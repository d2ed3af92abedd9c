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
// depends on the last (its states are the last level's children), so a
// row's time is its chain of round trips to L2, where the tables sit.
// Design: one round trip a level in the common case.
// - A team of T lanes walks a row, lane i holding frontier state i (a loop
//   over chunks of T for wider frontiers), 32 / T rows a warp; the
//   order-keeping compaction and the appends are a warp ballot, the team's
//   bits of it and a `__popc` of the lanes below. Loop trip counts are
//   the warp's largest, so every lane meets every ballot.
// - A level's reads go out together, through the read-only path: for each
//   live state its `#` filter, its `+` child and the three words of its
//   edge's first probe slot. Later slots are read only on a collision, and
//   a never-written slot (edge_node == -1) ends the chain: the NFA builder
//   fills the first -1 or tombstone slot of a chain, deletes leave
//   tombstones and a rehash re-places every edge, so no live edge sits
//   behind a -1 within `probes` slots (the CPU tests walk every chain).
// - The next level's symbol is read during this level; depth and `$` once.
// - The frontier is double-buffered in shared memory (2 x F words a row);
//   past one chunk of T states, the `+` children wait in the slots of the
//   states they came from until every literal child is packed.
// - Each word of the row's K matches is written once: a match where the
//   walk appends it, the rest -1 when the walk ends.
// Instances: T = 8 up to F = 64 (4 rows a warp: a batch of 8,192 rows is
// 2,048 warps, one wave on 132 SMs), a warp a row past it.
#include "common.cuh"

namespace {

constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr uint32_t kEdgeMulNode = 0x9E3779B1u;  // nfa.py EDGE_H_MUL_NODE
constexpr uint32_t kEdgeMulSym = 0x85EBCA77u;   // EDGE_H_MUL_SYM
constexpr int kEdgeShift = 15;                  // EDGE_H_SHIFT
constexpr int kTeam = 8;  // lanes a row while F <= kTeamMaxF
constexpr int kTeamMaxF = 64;
constexpr int kBlockWarps = 4;

struct Tables {
  const int32_t* __restrict__ plus_child;
  const int32_t* __restrict__ hash_filter;
  const int32_t* __restrict__ term_filter;
  const int32_t* __restrict__ edge_node;
  const int32_t* __restrict__ edge_sym;
  const int32_t* __restrict__ edge_child;
  uint32_t emask;
  int probes;
};

__device__ __forceinline__ uint32_t edge_hash(int32_t node, int32_t sym) {
  uint32_t h = static_cast<uint32_t>(node) * kEdgeMulNode +
               static_cast<uint32_t>(sym) * kEdgeMulSym;
  return h ^ (h >> kEdgeShift);
}

// Slots p >= 1 of the chain of (node, sym): one slot's three words a round
// trip, until a hit, a never-written slot or `probes` slots.
__device__ __forceinline__ int32_t probe_rest(const Tables& tb, int32_t node,
                                           int32_t sym, uint32_t h) {
  for (int p = 1; p < tb.probes; ++p) {
    const uint32_t idx = (h + static_cast<uint32_t>(p)) & tb.emask;
    const int32_t en = __ldg(tb.edge_node + idx);
    const int32_t es = __ldg(tb.edge_sym + idx);
    const int32_t ec = __ldg(tb.edge_child + idx);
    if (en == node && es == sym) return ec;
    if (en == -1) return -1;
  }
  return -1;
}

// The team's bits of a warp ballot (every lane of the warp calls it).
template <int T>
__device__ __forceinline__ unsigned team_ballot(bool p, int shift) {
  const unsigned m = __ballot_sync(kFull, p);
  if constexpr (T == 32) {
    return m;
  } else {
    return (m >> shift) & ((1u << T) - 1u);
  }
}

// Append the team's v >= 0 in lane order at the row's running count.
template <int T>
__device__ __forceinline__ void append(int32_t v, int t, int shift,
                                       int32_t* mrow, int K, int& mcount) {
  const unsigned m = team_ballot<T>(v >= 0, shift);
  if (v >= 0) {
    const int pos = mcount + __popc(m & ((1u << t) - 1u));
    if (pos < K) mrow[pos] = v;
  }
  mcount += __popc(m);
}

// Write the team's v >= 0 in lane order into nxt at base + rank (< F).
template <int T>
__device__ __forceinline__ void pack(int32_t v, int t, int shift,
                                     int32_t* nxt, int F, int& base) {
  const unsigned m = team_ballot<T>(v >= 0, shift);
  if (v >= 0) {
    const int pos = base + __popc(m & ((1u << t) - 1u));
    if (pos < F) nxt[pos] = v;
  }
  base += __popc(m);
}

template <int T>
__global__ void __launch_bounds__(kBlockWarps * 32)
    nfa_walk_kernel(const int32_t* __restrict__ syms,
                    const int32_t* __restrict__ nwords,
                    const bool* __restrict__ dollar, const Tables tb,
                    int32_t* __restrict__ matched,
                    int32_t* __restrict__ mcount_out, bool* __restrict__ flags,
                    int B, int L, int F, int K) {
  extern __shared__ int32_t smem[];
  const int lane = threadIdx.x % 32;
  const int t = lane % T;
  const int shift = lane - t;
  const int team = threadIdx.x / T;  // the row's index in the block
  const long long row =
      static_cast<long long>(blockIdx.x) * (blockDim.x / T) + team;
  const bool on = row < B;
  int32_t* cur = smem + static_cast<size_t>(team) * 2 * F;
  int32_t* nxt = cur + F;
  const long long r = on ? row : 0;
  const int32_t* srow = syms + r * L;
  int32_t* mrow = matched + r * K;
  const int nw = on ? __ldg(nwords + r) : 0;
  const bool dl = on && dollar[r];
  const int depth = on ? max(0, min(nw, L)) : 0;
  int32_t sym_next = depth > 0 ? __ldg(srow) : -1;
  if (t == 0) cur[0] = 0;  // the root
  __syncwarp();
  int nf = on ? 1 : 0;  // live states, left-packed in cur[0, nf)
  int mcount = 0;
  bool fover = false;
  const int levels = __reduce_max_sync(kFull, depth);
  for (int lvl = 0; lvl < levels; ++lvl) {
    const bool act = lvl < depth;
    const int32_t sym = sym_next;
    if (lvl + 1 < depth) sym_next = __ldg(srow + lvl + 1);
    const bool wild = !(lvl == 0 && dl);
    const int na = act ? nf : 0;
    const int width = __reduce_max_sync(kFull, na);
    int nlit = 0;
    for (int c = 0; c < width; c += T) {
      const int i = c + t;
      const int32_t s = i < na ? cur[i] : -1;
      const bool look = s >= 0 && sym >= 0;
      const uint32_t h = look ? edge_hash(s, sym) : 0u;
      const uint32_t i0 = h & tb.emask;
      // the level's reads, issued together
      int32_t hf = -1, pc = -1, en = -1, es = -1, ec = -1;
      if (s >= 0 && wild) {
        hf = __ldg(tb.hash_filter + s);
        pc = __ldg(tb.plus_child + s);
      }
      if (look) {
        en = __ldg(tb.edge_node + i0);
        es = __ldg(tb.edge_sym + i0);
        ec = __ldg(tb.edge_child + i0);
      }
      int32_t lit = -1;
      if (look) {
        if (en == s && es == sym) {
          lit = ec;
        } else if (en != -1) {
          lit = probe_rest(tb, s, sym, h);
        }
      }
      append<T>(hf, t, shift, mrow, K, mcount);
      pack<T>(lit, t, shift, nxt, F, nlit);
      if (width <= T) {  // one chunk: every literal child is placed
        pack<T>(pc, t, shift, nxt, F, nlit);
      } else if (i < na) {
        cur[i] = pc;  // the `+` child waits in its state's slot
      }
    }
    int total = nlit;
    for (int c = 0; width > T && c < width; c += T) {
      const int i = c + t;
      pack<T>(i < na ? cur[i] : -1, t, shift, nxt, F, total);
    }
    if (act) {
      fover |= total > F;
      nf = min(total, F);
      int32_t* tmp = cur;
      cur = nxt;
      nxt = tmp;
    }
    __syncwarp();
  }
  const bool done = on && nw <= L;
  const int nd = done ? nf : 0;
  const int width = __reduce_max_sync(kFull, nd);
  for (int c = 0; c < width; c += T) {
    const int i = c + t;
    const int32_t s = i < nd ? cur[i] : -1;
    int32_t tf = -1, hf = -1;
    if (s >= 0) {
      tf = __ldg(tb.term_filter + s);
      hf = __ldg(tb.hash_filter + s);
    }
    append<T>(tf, t, shift, mrow, K, mcount);
    if (width <= T) {  // the `#` filters follow every terminal one
      append<T>(hf, t, shift, mrow, K, mcount);
    } else if (i < nd) {
      cur[i] = hf;
    }
  }
  for (int c = 0; width > T && c < width; c += T) {
    const int i = c + t;
    append<T>(i < nd ? cur[i] : -1, t, shift, mrow, K, mcount);
  }
  if (!on) return;
  const int kept = min(mcount, K);
  for (int k = kept + t; k < K; k += T) mrow[k] = -1;
  if (t == 0) {
    const bool mover = mcount > K;
    mcount_out[row] = kept;
    flags[row] = fover || mover || !done;  // flags
    flags[B + row] = !done;                // too_deep
    flags[2LL * B + row] = fover;          // frontier_overflow
    flags[3LL * B + row] = mover;          // match_overflow
  }
}

template <int T>
int launch(const int32_t* syms, const int32_t* nwords, const bool* dollar,
           const Tables& tb, int32_t* matched, int32_t* mcount, bool* flags,
           int B, int L, int F, int K, cudaStream_t stream) {
  // kBlockWarps warps a block while the rows' frontier buffers fit in 48 KB
  // of shared memory, fewer for very wide frontiers
  int warps = kBlockWarps;
  const size_t per_row = static_cast<size_t>(2) * F * 4;
  while (warps > 1 && warps * (32 / T) * per_row > 49152) warps >>= 1;
  const int rows = warps * (32 / T);
  const unsigned blocks = static_cast<unsigned>((B + rows - 1) / rows);
  nfa_walk_kernel<T><<<blocks, warps * 32, rows * per_row, stream>>>(
      syms, nwords, dollar, tb, matched, mcount, flags, B, L, F, K);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

EMQX_EXPORT int emqx_nfa_walk(const void* syms, const void* nwords,
                              const void* dollar, const void* plus_child,
                              const void* hash_filter, const void* term_filter,
                              const void* edge_node, const void* edge_sym,
                              const void* edge_child, long long E,
                              void* matched, void* mcount, void* flags, int B,
                              int L, int F, int K, int probes, void* stream) {
  if (B <= 0) return static_cast<int>(cudaGetLastError());
  const Tables tb{static_cast<const int32_t*>(plus_child),
                  static_cast<const int32_t*>(hash_filter),
                  static_cast<const int32_t*>(term_filter),
                  static_cast<const int32_t*>(edge_node),
                  static_cast<const int32_t*>(edge_sym),
                  static_cast<const int32_t*>(edge_child),
                  static_cast<uint32_t>(E - 1), probes};
  const auto* s = static_cast<const int32_t*>(syms);
  const auto* w = static_cast<const int32_t*>(nwords);
  const auto* d = static_cast<const bool*>(dollar);
  auto* m = static_cast<int32_t*>(matched);
  auto* c = static_cast<int32_t*>(mcount);
  auto* f = static_cast<bool*>(flags);
  const auto st = static_cast<cudaStream_t>(stream);
  if (F <= kTeamMaxF) return launch<kTeam>(s, w, d, tb, m, c, f, B, L, F, K, st);
  return launch<32>(s, w, d, tb, m, c, f, B, L, F, K, st);
}
