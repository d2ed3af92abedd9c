// Kernel 9: $share picks, matched filters -> group lanes -> member index.
//
// Replaces `share_pick_device` (emqx_tpu/models/router_model.py:904, the
// single-device branch). Lane i = (row b, matched column k, group slot l)
// of the flat [B, K * GPF] output: gid = filter_groups[fid, l] when the
// fid and the slot are live, else -1; then per strategy
//   0 random       ((rand[b] * 2654435761) ^ g) mod len       (uint32)
//   1 round_robin  (group_rr[g] + occ[i]) mod len   (int32: the sum wraps,
//                  and the modulo is floored, as jnp's %, so it never goes
//                  negative)
//   2 sticky       group_sticky[g] when 0 <= it < len, else
//                  (rand[b] ^ g) mod len                       (uint32)
//   3 hash_clientid client_hash[b] mod len                     (uint32)
//   4 hash_topic   topic_hash[b] mod len                       (uint32)
// with g = max(gid, 0) and len = max(group_len[g], 1); any other strategy
// id picks as random, as the JAX function's else branch does. A lane
// whose gid is -1 or whose group is empty (group_len 0) gives -1 in both
// outputs. Every table index is clamped into its array (JAX's gathers
// clamp the same way), so no read leaves filter_groups or the group arrays.
//
// `phase` 0 writes only the raw gid lanes (into pick_gid): the input of
// the occurrence index that round robin needs (kernel 10). Phase 1 writes
// the picks; under round robin it reads the raw lanes back from pick_gid
// (one coalesced load beside the occurrence) instead of going through
// matched and filter_groups again, and overwrites them.
//
// The mesh branch (`dp_axis`, emqx_tpu/models/router_model.py:942-962):
// with the batch split over 'dp', a round-robin lane's rank within its
// group must count the lanes of lower dp ranks too. `all_counts` [dp,
// gcap] holds every dp rank's per-group lane counts (the totals of
// occurrence_index.cu's scan, then an all-gather); phase 1 adds prev[g], the sum of the rows below
// `dp_rank`, to the local occurrence before the modulo, in the same
// launch: dp_rank reads a lane, issued with the group words. A null
// `all_counts` is the single-device kernel, bit for bit.
//
// Bound: bytes. Each lane reads one filter_groups word and two or three
// group words and writes two words; a few integer operations. At the
// cells' sizes (tens of thousands of pairs) a launch is latency: a chain of
// dependent reads. Design:
// - at GPF 4, and at GPF 8 under round robin (GroupTable starts at 4 and
//   doubles), one thread a (row, k) pair: one `matched` read serves its
//   GPF lanes, the fid's filter_groups row comes as one or two 16-byte
//   loads, and the outputs leave as vectors; any other case, or a base
//   not 16-byte aligned, takes a thread a lane; the row's rand / hash word
//   is read beside `matched`, before the chain;
// - every lane's group words are issued together through the read-only
//   path, so a pick waits on matched -> filter_groups -> the group words,
//   and round robin's pick launch on pick_gid -> the group words; a lane
//   with no group reads none, a pair with none reads no rank, and round
//   robin's pick rewrites only the pick_gid lanes it changes (a live lane
//   of an empty group): most lanes hold no group;
// - 32-bit indices throughout: the wrapper refuses B x K x GPF, Fcap x GPF
//   or dp x Gcap at 2^31, so no lane runs a 64-bit division.
#include "common.cuh"

namespace {

// threads a block: a thread a pair, a thread a lane (both the faster of
// 128 and 256 on the card, PERF.md)
template <int kG>
constexpr int kThreads = kG > 0 ? 128 : 256;

struct Args {
  const int32_t* fg;
  int fcap;
  int gpf;
  const int32_t* glen;
  const int32_t* grr;
  const int32_t* gsticky;
  int gcap;
  const int32_t* matched;
  const int32_t* occ;
  const int32_t* ch;
  const int32_t* th;
  const int32_t* rnd;
  int32_t* pick_gid;
  int32_t* pick_idx;
  int pairs;
  int lanes;  // pairs x gpf
  int K;
  int strategy;
  int phase;
  const int32_t* all_counts;
  int dp_rank;
};

// N consecutive int32 words; 16-byte accesses when N % 4 == 0 (the
// launcher picks such an N only on 16-byte aligned bases)
template <int N, bool kReadOnly>
__device__ __forceinline__ void load_n(int32_t (&d)[N],
                                       const int32_t* __restrict__ p) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int j = 0; j < N; j += 4) {
      const int4* q = reinterpret_cast<const int4*>(p + j);
      const int4 v = kReadOnly ? __ldg(q) : *q;
      d[j] = v.x, d[j + 1] = v.y, d[j + 2] = v.z, d[j + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int l = 0; l < N; ++l) d[l] = kReadOnly ? __ldg(p + l) : p[l];
  }
}

template <int N>
__device__ __forceinline__ void store_n(int32_t* __restrict__ p,
                                        const int32_t (&d)[N]) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int j = 0; j < N; j += 4)
      *reinterpret_cast<int4*>(p + j) =
          make_int4(d[j], d[j + 1], d[j + 2], d[j + 3]);
  } else {
#pragma unroll
    for (int l = 0; l < N; ++l) p[l] = d[l];
  }
}

// lanes [i0, i0 + N) of one pair; f its fid, word its row's rand / hash
template <int N>
__device__ __forceinline__ void pick_lanes(const Args& a, int32_t f,
                                           const int32_t* __restrict__ fgrow,
                                           uint32_t word, int i0) {
  int32_t gid[N];
  if (a.strategy == 1 && a.phase == 1) {
    load_n<N, false>(gid, a.pick_gid + i0);  // phase 0's raw lanes
  } else {
    load_n<N, true>(gid, fgrow);
#pragma unroll
    for (int l = 0; l < N; ++l) gid[l] = (f >= 0 && gid[l] >= 0) ? gid[l] : -1;
    if (a.phase == 0) {
      store_n<N>(a.pick_gid + i0, gid);
      return;
    }
  }
  int32_t gs[N], len[N], aux[N], occ[N];
  bool live = false;
#pragma unroll
  for (int l = 0; l < N; ++l) {
    const int32_t g = gid[l] > 0 ? gid[l] : 0;
    gs[l] = g < a.gcap ? g : a.gcap - 1;  // gather index
    len[l] = gid[l] >= 0 ? __ldg(a.glen + gs[l]) : 0;  // dead lanes read none
    live |= gid[l] >= 0;
  }
  if (a.strategy == 1) {
    if (live) {  // a dead lane's rank is never read: most pairs skip it
      load_n<N, true>(occ, a.occ + i0);
    } else {
#pragma unroll
      for (int l = 0; l < N; ++l) occ[l] = 0;
    }
#pragma unroll
    for (int l = 0; l < N; ++l) aux[l] = gid[l] >= 0 ? __ldg(a.grr + gs[l]) : 0;
    if (a.all_counts != nullptr) {
      for (int r = 0; r < a.dp_rank; ++r) {
        const int32_t* row = a.all_counts + r * a.gcap;
#pragma unroll
        for (int l = 0; l < N; ++l)
          occ[l] = static_cast<int32_t>(
              static_cast<uint32_t>(occ[l]) +
              static_cast<uint32_t>(__ldg(row + gs[l])));
      }
    }
  } else if (a.strategy == 2) {
#pragma unroll
    for (int l = 0; l < N; ++l)
      aux[l] = gid[l] >= 0 ? __ldg(a.gsticky + gs[l]) : 0;
  }
  int32_t out_gid[N], out_idx[N];
#pragma unroll
  for (int l = 0; l < N; ++l) {
    const int32_t g = gid[l] > 0 ? gid[l] : 0;
    const uint32_t ug = static_cast<uint32_t>(g);
    const int32_t denom = len[l] > 1 ? len[l] : 1;
    const uint32_t ud = static_cast<uint32_t>(denom);
    int32_t idx;
    switch (a.strategy) {
      case 1: {
        const int32_t s = static_cast<int32_t>(static_cast<uint32_t>(aux[l]) +
                                               static_cast<uint32_t>(occ[l]));
        int32_t m = s % denom;
        if (m < 0) m += denom;  // floored: the divisor is >= 1
        idx = m;
        break;
      }
      case 2: {
        const int32_t s = aux[l];
        idx = (s >= 0 && s < len[l]) ? s
                                     : static_cast<int32_t>((word ^ ug) % ud);
        break;
      }
      case 3:
      case 4:
        idx = static_cast<int32_t>(word % ud);
        break;
      default:
        idx = static_cast<int32_t>(((word * 2654435761u) ^ ug) % ud);
        break;
    }
    const bool ok = gid[l] >= 0 && len[l] > 0;
    out_gid[l] = ok ? gid[l] : -1;
    out_idx[l] = ok ? idx : -1;
  }
  if (a.strategy == 1) {
    // pick_gid holds phase 0's raw lanes: only a live lane of an empty
    // group changes (to -1)
#pragma unroll
    for (int l = 0; l < N; ++l)
      if (out_gid[l] != gid[l]) a.pick_gid[i0 + l] = out_gid[l];
  } else {
    store_n<N>(a.pick_gid + i0, out_gid);
  }
  store_n<N>(a.pick_idx + i0, out_idx);
}

// kG 4 or 8: GPF = kG, a thread a pair, vector words; kG 0: any GPF, a
// thread a lane
template <int kG>
__global__ void __launch_bounds__(kThreads<kG>)
    share_pick_kernel(const Args a) {
  const int t = static_cast<int>(blockIdx.x) * kThreads<kG> +
                static_cast<int>(threadIdx.x);
  if (t >= (kG > 0 ? a.pairs : a.lanes)) return;
  int p = t, l = 0;  // the pair, and the lane's slot in it
  if constexpr (kG == 0) {
    p = static_cast<int>(static_cast<unsigned>(t) /
                         static_cast<unsigned>(a.gpf));
    l = t - p * a.gpf;
  }
  const bool rr_pick = a.strategy == 1 && a.phase == 1;
  const bool needs_row = a.phase == 1 && a.strategy != 1;
  const int b = static_cast<int>(static_cast<unsigned>(p) /
                                 static_cast<unsigned>(a.K));
  // the row's word, read beside the fid, before the chain
  const int32_t* wsrc = a.strategy == 3 ? a.ch : a.strategy == 4 ? a.th : a.rnd;
  const uint32_t word = needs_row ? static_cast<uint32_t>(__ldg(wsrc + b)) : 0u;
  int32_t f = -1;
  const int32_t* fgrow = a.fg;
  if (!rr_pick) {
    f = __ldg(a.matched + p);
    int32_t fs = f > 0 ? f : 0;
    if (fs >= a.fcap) fs = a.fcap - 1;
    fgrow = a.fg + fs * a.gpf + l;
  }
  if constexpr (kG > 0) {
    pick_lanes<kG>(a, f, fgrow, word, p * kG);
  } else {
    pick_lanes<1>(a, f, fgrow, word, t);
  }
}

bool aligned(const void* p, uintptr_t bytes) {
  return (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) == 0;
}

}  // namespace

EMQX_EXPORT int emqx_share_pick(
    const void* fg, long long fcap, int gpf, const void* glen,
    const void* grr, const void* gsticky, long long gcap,
    const void* matched, const void* occ, const void* ch, const void* th,
    const void* rnd, void* pick_gid, void* pick_idx, int B, int K,
    int strategy, int phase, const void* all_counts, int dp_rank,
    void* stream) {
  const long long pairs = static_cast<long long>(B) * K;
  constexpr long long kMax = (1LL << 31) - 1;
  if (pairs <= 0 || gpf <= 0) return static_cast<int>(cudaGetLastError());
  // 32-bit lane, table and count indices (the wrapper checks the same)
  if (pairs * gpf > kMax || fcap * gpf > kMax || fcap < 1 || gcap < 1 ||
      gcap > kMax || (all_counts != nullptr && dp_rank * gcap > kMax))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{static_cast<const int32_t*>(fg), static_cast<int>(fcap), gpf,
               static_cast<const int32_t*>(glen),
               static_cast<const int32_t*>(grr),
               static_cast<const int32_t*>(gsticky), static_cast<int>(gcap),
               static_cast<const int32_t*>(matched),
               static_cast<const int32_t*>(occ),
               static_cast<const int32_t*>(ch),
               static_cast<const int32_t*>(th),
               static_cast<const int32_t*>(rnd),
               static_cast<int32_t*>(pick_gid),
               static_cast<int32_t*>(pick_idx), static_cast<int>(pairs),
               static_cast<int>(pairs * gpf), K,
               strategy, phase, static_cast<const int32_t*>(all_counts),
               dp_rank};
  // a thread a pair only where every base its vectors touch is aligned;
  // at GPF 8 only under round robin, whose launches move the raw lanes
  // as vectors: a pick of the other strategies is faster a lane a thread
  // (the pair's 8 chains take 64 registers)
  const bool vec = (gpf == 4 || (gpf == 8 && strategy == 1)) &&
                   aligned(fg, 16) && aligned(pick_gid, 16) &&
                   aligned(pick_idx, 16) &&
                   (occ == nullptr || aligned(occ, 16));
  const auto s = static_cast<cudaStream_t>(stream);
  const auto blocks = [](long long n, int threads) {
    return static_cast<unsigned>((n + threads - 1) / threads);
  };
  if (vec && gpf == 4) {
    share_pick_kernel<4><<<blocks(pairs, kThreads<4>), kThreads<4>, 0, s>>>(a);
  } else if (vec && gpf == 8) {
    share_pick_kernel<8><<<blocks(pairs, kThreads<8>), kThreads<8>, 0, s>>>(a);
  } else {
    share_pick_kernel<0>
        <<<blocks(pairs * gpf, kThreads<0>), kThreads<0>, 0, s>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}
