// Kernel 4: fan-out bitmaps -> ascending subscriber slot ids.
//
// Replaces `compact_fanout_slots` (emqx_tpu/models/router_model.py:77).
// slots[b, :] holds the first kslot set-bit positions of bitmaps[b, :]
// (slot = word * 32 + bit), ascending, -1 padded; count[b] is the
// UNCAPPED number of set bits and overflow[b] = count > kslot, so the
// host fetches the dense row instead and the cap never costs correctness.
// The JAX function needs two left-pack stages (nonzero words, then their
// bits) to keep its intermediates O(B x kslot x 32); here no intermediate
// exists at all.
//
// On a ('dp', 'tp') mesh (emqx_tpu/parallel/mesh.py:372-384) each tp
// shard compacts its own lane slice: `lane_base` (tp rank x W x 32) turns
// its local bit positions into global slot ids in the same store (JAX's
// `jnp.where(slots >= 0, slots + off, -1)`), and `pair`, when given, takes
// count and overflow as int32 rows of one [2, B] buffer, so that one 'tp'
// all-reduce carries both. Lane base 0 and no pair are the single-device
// kernel, bit for bit.
//
// Bound: bytes. It reads B x W words and writes B x (kslot + 2) words;
// the work per set bit is a find-first-set and a store. The whole row is
// always read, since the count is uncapped. Design:
// - each lane owns groups of 4 consecutive words: one 16-byte load a
//   group when W % 4 == 0 and the base is 16-byte aligned, else 4 scalar
//   loads (a ragged W, a view 4 bytes off); streaming (evict-first) loads
//   for wide rows, cached ones for narrow rows;
// - wide rows (W > 128 words): a warp a row; a round issues kUnroll
//   groups a lane (kUnroll x 512 bytes a warp) before it looks at any, so
//   the card holds several MB in flight (one 128-byte load a warp, waiting
//   on a scan before the next, held it at 2x its bound). A group's bits are
//   placed only while the row has fewer than kslot placed, and only for a
//   group set where a warp vote finds a nonzero word: that set takes a
//   5-step scan of the lanes' popcounts, then the bits are placed (`place`,
//   below). All-zero groups cost a popcount and the vote. Every lane sums
//   its own popcounts; one warp reduction gives the uncapped count;
// - narrow rows (W <= 128): a team of T lanes a row, 32 / T rows a warp,
//   one round; T is the power of two at least ceil(W / 4) and at least
//   min(32, ceil(kslot / 4)), since at W <= 8 the row's kslot slots are
//   most of its bytes: the padding leaves as one 16-byte store a lane, the
//   warp's rows side by side (a lane a row, tried first, wrote 16 stores to
//   32 rows and took twice the time at W = 4); the scan runs over the
//   team's lanes only (shuffles of width T), ceil(log2 G) steps for a
//   row of G groups; an instance a T, so the scan, the row's index and
//   the padding loop are unrolled (at W <= 8 a launch is a few µs and
//   its chain of dependent instructions counts);
// - placing bits: each lane writes its own bits at their final positions
//   (__ffs) while no lane of the warp has more than kSerialMax of them;
//   otherwise (a dense row: the Zipf topics of a mixed_10m batch give
//   0.75-4.8% of lanes more than 8, one batch 24%) the positions are
//   dealt round the lanes, each finding its bit by a binary search over
//   the lanes' popcount sums (shuffles), two positions a lane a round, so
//   a dense row takes kslot / 2T rounds and not one lane's kslot stores
//   in a row;
// - each output word is written once: the placed bits, then the -1
//   padding from min(count, kslot) by the row's lanes together, 16-byte
//   stores where kslot % 4 == 0 and the slots' base is aligned.
#include <algorithm>

#include "common.cuh"

namespace {

constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kWarp = 32;
constexpr int kBlock = 128;
constexpr int kRowsWide = kBlock / kWarp;  // wide rows a block
constexpr int kUnroll = 4;                 // groups a lane a round, wide rows
constexpr int kTeamMaxWords = 4 * kWarp;   // the widest row a team takes
constexpr int kSerialMax = 8;              // bits a lane places on its own

__device__ __forceinline__ int popc4(const uint4& v) {
  return __popc(v.x) + __popc(v.y) + __popc(v.z) + __popc(v.w);
}

// a read of the bitmaps: streaming (evict first) for wide rows, which
// pass through L2 once; cached for narrow ones, small enough to stay there
template <bool kStream, typename V>
__device__ __forceinline__ V ld(const V* p) {
  if constexpr (kStream) {
    return __ldcs(p);
  } else {
    return __ldg(p);
  }
}

// words [4q, 4q + 4) of a row, zero past W
template <bool kStream>
__device__ __forceinline__ uint4 load_group(const uint32_t* __restrict__ row,
                                            int W, int q, bool vec) {
  uint4 v = make_uint4(0u, 0u, 0u, 0u);
  const int w = 4 * q;
  if (w >= W) return v;
  if (vec) return ld<kStream>(reinterpret_cast<const uint4*>(row) + q);
  v.x = ld<kStream>(row + w);
  if (w + 1 < W) v.y = ld<kStream>(row + w + 1);
  if (w + 2 < W) v.z = ld<kStream>(row + w + 2);
  if (w + 3 < W) v.w = ld<kStream>(row + w + 3);
  return v;
}

// inclusive sum of c over the lanes of a team of T (t its lane in it);
// exact for the first n lanes (warp-uniform n, the lanes that hold
// words: the rest hold 0), so a short row takes ceil(log2 n) steps
template <int T>
__device__ __forceinline__ int team_scan(int c, int t, int n = T) {
#pragma unroll
  for (int off = 1; off < T; off <<= 1) {
    if (off >= n) break;
    const int y = __shfl_up_sync(kFull, c, off, T);
    if (t >= off) c += y;
  }
  return c;
}

// the set bits of m at out[pos, ...), ascending, none at or past cap
__device__ __forceinline__ int place_word(int32_t* __restrict__ out,
                                          uint32_t m, int pos, int cap,
                                          int slot0) {
  while (m != 0u && pos < cap) {
    out[pos++] = slot0 + (__ffs(m) - 1);
    m &= m - 1u;
  }
  return pos;
}

// the bit position of the r-th (from 0) set bit of word, r < popc(word)
__device__ __forceinline__ int select_bit(uint32_t word, int r) {
  int pos = 0;
#pragma unroll
  for (int half = 16; half > 0; half >>= 1) {
    const int n = __popc(word & ((1u << half) - 1u));
    if (r >= n) {
      r -= n;
      word >>= half;
      pos += half;
    }
  }
  return pos;
}

// out[pos0 + k] = the slot of the k-th set bit of the team's groups when
// k < lim, lo the team's lane that holds it (every lane runs the
// shuffles; lane t holds the team's group t: words v, excl bits before it)
template <int T>
__device__ __forceinline__ void deal_one(int32_t* __restrict__ out,
                                         const uint4& v, int excl, int k,
                                         int lo, int pos0, int lim,
                                         int slot_q0) {
  const uint32_t x = __shfl_sync(kFull, v.x, lo, T);
  const uint32_t y = __shfl_sync(kFull, v.y, lo, T);
  const uint32_t z = __shfl_sync(kFull, v.z, lo, T);
  const uint32_t w = __shfl_sync(kFull, v.w, lo, T);
  int r = k - __shfl_sync(kFull, excl, lo, T);
  if (k >= lim) return;
  uint32_t word = x;
  int wi = 0;
  int n = __popc(x);
  if (r >= n) {
    r -= n, word = y, wi = 1, n = __popc(y);
    if (r >= n) {
      r -= n, word = z, wi = 2, n = __popc(z);
      if (r >= n) r -= n, word = w, wi = 3;
    }
  }
  out[pos0 + k] = slot_q0 + 128 * lo + 32 * wi + select_bit(word, r);
}

// out[pos0 + k] for k < lim: the slot of the k-th set bit of the team's
// groups (lane t holds the team's group t: words v, c set bits, incl the
// team's inclusive sum of c; slot_q0 the slot of the group of lane 0).
// Every lane of the warp calls it (shuffles); lim is per team.
template <int T>
__device__ __forceinline__ void place(int32_t* __restrict__ out,
                                      const uint4& v, int c, int incl, int t,
                                      int pos0, int lim, int slot_q0) {
  const int excl = incl - c;
  const int mine = max(0, min(c, lim - excl));  // this lane's bits to place
  if (!__any_sync(kFull, mine > kSerialMax)) {
    if (mine > 0) {
      const int cap = pos0 + lim;
      const int slot0 = slot_q0 + 128 * t;
      int pos = place_word(out, v.x, pos0 + excl, cap, slot0);
      pos = place_word(out, v.y, pos, cap, slot0 + 32);
      pos = place_word(out, v.z, pos, cap, slot0 + 64);
      place_word(out, v.w, pos, cap, slot0 + 96);
    }
    return;
  }
  // a dense row: the positions dealt round the team's lanes, two a lane a
  // round (two independent searches); each finds the first lane of the
  // team whose incl passes its position
  for (int k0 = 0; __any_sync(kFull, k0 < lim); k0 += 2 * T) {
    const int ka = k0 + t, kb = ka + T;
    int la = 0, lb = 0;
#pragma unroll
    for (int step = T >> 1; step > 0; step >>= 1) {
      const int sa = __shfl_sync(kFull, incl, la + step - 1, T);
      const int sb = __shfl_sync(kFull, incl, lb + step - 1, T);
      if (sa <= ka) la += step;
      if (sb <= kb) lb += step;
    }
    deal_one<T>(out, v, excl, ka, la, pos0, lim, slot_q0);
    deal_one<T>(out, v, excl, kb, lb, pos0, lim, slot_q0);
  }
}

// -1 into out[from, kslot) by a row's T lanes, and the row's count
template <int T>
__device__ __forceinline__ void finish_row(
    int32_t* __restrict__ out, int32_t* __restrict__ count,
    bool* __restrict__ overflow, int32_t* __restrict__ pair, int B, int r,
    int kslot, int total, int t, bool vec_out) {
  const int from = total < kslot ? total : kslot;
  if (vec_out) {
    const int head = (from + 3) & ~3;  // <= kslot: kslot % 4 == 0
    for (int p = from + t; p < head; p += T) out[p] = -1;
    int4* out4 = reinterpret_cast<int4*>(out);
    for (int j = head / 4 + t; j < kslot / 4; j += T)
      out4[j] = make_int4(-1, -1, -1, -1);
  } else {
    for (int p = from + t; p < kslot; p += T) out[p] = -1;
  }
  if (t == 0) {
    if (count != nullptr) count[r] = total;
    if (overflow != nullptr) overflow[r] = total > kslot;
    if (pair != nullptr) {
      pair[r] = total;
      pair[static_cast<size_t>(B) + r] = total > kslot ? 1 : 0;
    }
  }
}

// W > 128: a warp a row, kUnroll groups a lane in flight a round
__device__ __forceinline__ void compact_wide(
    const uint32_t* __restrict__ bitmaps, int32_t* __restrict__ slots,
    int32_t* __restrict__ count, bool* __restrict__ overflow,
    int32_t* __restrict__ pair, int B, int W, int kslot, int lane_base,
    bool vec, bool vec_out) {
  const int lane = threadIdx.x % kWarp;
  const int r = blockIdx.x * kRowsWide + threadIdx.x / kWarp;
  if (r >= B) return;  // uniform across the warp
  const uint32_t* row = bitmaps + static_cast<size_t>(r) * W;
  int32_t* out = slots + static_cast<size_t>(r) * kslot;
  const int G = (W + 3) / 4;
  int placed = 0;  // bits placed so far, warp-uniform
  int mine = 0;    // this lane's set bits
  for (int g0 = 0; g0 < G; g0 += kUnroll * kWarp) {  // the same trips a lane
    uint4 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      v[u] = load_group<true>(row, W, g0 + u * kWarp + lane, vec);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int c = popc4(v[u]);
      mine += c;
      if (placed < kslot && __any_sync(kFull, c != 0)) {
        const int incl = team_scan<kWarp>(c, lane);
        const int round = __shfl_sync(kFull, incl, kWarp - 1);
        place<kWarp>(out, v[u], c, incl, lane, placed,
                     min(round, kslot - placed),
                     lane_base + 128 * (g0 + u * kWarp));
        placed += round;
      }
    }
  }
  const int total = static_cast<int>(
      __reduce_add_sync(kFull, static_cast<unsigned>(mine)));
  finish_row<kWarp>(out, count, overflow, pair, B, r, kslot, total, lane,
                    vec_out);
}

// W <= 128: a team of T lanes a row, 32 / T rows a warp, one round
template <int T>
__device__ __forceinline__ void compact_team(
    const uint32_t* __restrict__ bitmaps, int32_t* __restrict__ slots,
    int32_t* __restrict__ count, bool* __restrict__ overflow,
    int32_t* __restrict__ pair, int B, int W, int kslot, int lane_base,
    bool vec, bool vec_out) {
  const int lane = threadIdx.x % kWarp;
  const int t = lane % T;
  const int r = (blockIdx.x * kRowsWide + threadIdx.x / kWarp) * (kWarp / T) +
                lane / T;
  const bool live = r < B;
  const uint4 v =
      live ? load_group<false>(bitmaps + static_cast<size_t>(r) * W, W, t, vec)
           : make_uint4(0u, 0u, 0u, 0u);
  const int c = popc4(v);
  const int G = (W + 3) / 4;  // the row's groups, at most T
  int incl = team_scan<T>(c, t, G);
  const int total = __shfl_sync(kFull, incl, G - 1, T);
  if (t >= G) incl = total;  // past the row's words: the sums stay monotone
  int32_t* out = slots + static_cast<size_t>(live ? r : 0) * kslot;
  place<T>(out, v, c, incl, t, 0, live ? min(total, kslot) : 0, lane_base);
  if (!live) return;  // after the team's last shuffle
  finish_row<T>(out, count, overflow, pair, B, r, kslot, total, t, vec_out);
}

// kT 0: wide rows; else narrow rows, a team of kT lanes
template <int kT>
__global__ void __launch_bounds__(kBlock)
    compact_kernel(const uint32_t* __restrict__ bitmaps,
                   int32_t* __restrict__ slots, int32_t* __restrict__ count,
                   bool* __restrict__ overflow, int32_t* __restrict__ pair,
                   int B, int W, int kslot, int lane_base, bool vec,
                   bool vec_out) {
  if constexpr (kT == 0) {
    compact_wide(bitmaps, slots, count, overflow, pair, B, W, kslot,
                 lane_base, vec, vec_out);
  } else {
    compact_team<kT>(bitmaps, slots, count, overflow, pair, B, W, kslot,
                     lane_base, vec, vec_out);
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

template <int kT>
void run(const void* bitmaps, void* slots, void* count, void* overflow,
         void* pair, int B, int W, int kslot, int lane_base, bool vec,
         bool vec_out, cudaStream_t stream) {
  const int rows = kT == 0 ? kRowsWide : kBlock / kT;  // rows a block
  const unsigned blocks = static_cast<unsigned>((B + rows - 1) / rows);
  compact_kernel<kT><<<blocks, kBlock, 0, stream>>>(
      static_cast<const uint32_t*>(bitmaps), static_cast<int32_t*>(slots),
      static_cast<int32_t*>(count), static_cast<bool*>(overflow),
      static_cast<int32_t*>(pair), B, W, kslot, lane_base, vec, vec_out);
}

}  // namespace

EMQX_EXPORT int emqx_compact_fanout_slots(const void* bitmaps, void* slots,
                                          void* count, void* overflow,
                                          void* pair, int B, int W, int kslot,
                                          int lane_base, void* stream) {
  if (B > 0) {
    const bool vec = W % 4 == 0 && aligned16(bitmaps);
    const bool vec_out = kslot % 4 == 0 && aligned16(slots);
    const auto s = static_cast<cudaStream_t>(stream);
    // narrow rows: enough lanes for the row's words and for its slots'
    // 16-byte groups (up to a warp): the padding is most of what a narrow
    // row writes, so it leaves as one store a lane, rows side by side
    const int need = std::max((W + 3) / 4, std::min(kWarp, (kslot + 3) / 4));
    int T = 1;
    while (T < need) T <<= 1;
    const int kt = W > kTeamMaxWords ? 0 : T;
#define EMQX_COMPACT_RUN(K)                                                   \
  case K:                                                                     \
    run<K>(bitmaps, slots, count, overflow, pair, B, W, kslot, lane_base, vec, \
           vec_out, s);                                                       \
    break;
    switch (kt) {
      EMQX_COMPACT_RUN(0)
      EMQX_COMPACT_RUN(1)
      EMQX_COMPACT_RUN(2)
      EMQX_COMPACT_RUN(4)
      EMQX_COMPACT_RUN(8)
      EMQX_COMPACT_RUN(16)
      EMQX_COMPACT_RUN(32)
    }
#undef EMQX_COMPACT_RUN
  }
  return static_cast<int>(cudaGetLastError());
}
