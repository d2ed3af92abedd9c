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
// `phase` 0 writes only the raw gid lanes (into pick_gid) — the input of
// the occurrence index that round-robin needs (kernel 10); phase 1 writes
// the picks.
//
// The mesh branch (`dp_axis`, emqx_tpu/models/router_model.py:942-962):
// with the batch split over 'dp', a round-robin lane's rank within its
// group must count the lanes of lower dp ranks too. `all_counts` [dp,
// gcap] holds every dp rank's per-group lane counts (group_counts.cu,
// then an all-gather); phase 1 adds prev[g], the sum of the rows below
// `dp_rank`, to the local occurrence before the modulo, in the same
// launch: O(dp) reads a lane, no pass of its own. A null `all_counts` is
// the single-device kernel, bit for bit.
//
// Bound: bytes. Each lane reads one filter_groups word and two or three
// group words and writes two words; a few integer operations. Design: one
// thread per lane; neighbouring lanes of one fid read neighbouring words.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void share_pick_kernel(
    const int32_t* __restrict__ fg, long long fcap, int gpf,
    const int32_t* __restrict__ glen, const int32_t* __restrict__ grr,
    const int32_t* __restrict__ gsticky, long long gcap,
    const int32_t* __restrict__ matched, const int32_t* __restrict__ occ,
    const int32_t* __restrict__ ch, const int32_t* __restrict__ th,
    const int32_t* __restrict__ rnd, int32_t* __restrict__ pick_gid,
    int32_t* __restrict__ pick_idx, long long n, int K, int strategy,
    int phase, const int32_t* __restrict__ all_counts, int dp_rank) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (i >= n) return;
  const int l = static_cast<int>(i % gpf);
  const long long bk = i / gpf;
  const long long b = bk / K;
  const int32_t f = matched[bk];
  long long fs = f > 0 ? f : 0;
  if (fs >= fcap) fs = fcap - 1;
  const int32_t g = fg[fs * gpf + l];
  const int32_t gid = (f >= 0 && g >= 0) ? g : -1;
  if (phase == 0) {
    pick_gid[i] = gid;
    return;
  }
  const int32_t gsafe = gid > 0 ? gid : 0;
  const long long gs = gsafe < gcap ? gsafe : gcap - 1;  // gather index
  const int32_t len = glen[gs];
  const int32_t denom = len > 1 ? len : 1;
  const uint32_t ug = static_cast<uint32_t>(gsafe);
  const uint32_t ud = static_cast<uint32_t>(denom);
  int32_t idx;
  switch (strategy) {
    case 1: {
      uint32_t o = static_cast<uint32_t>(occ[i]);
      if (all_counts != nullptr) {
        for (int r = 0; r < dp_rank; ++r)
          o += static_cast<uint32_t>(all_counts[r * gcap + gs]);
      }
      const int32_t a =
          static_cast<int32_t>(static_cast<uint32_t>(grr[gs]) + o);
      int32_t r = a % denom;
      if (r < 0) r += denom;  // floored: the divisor is >= 1
      idx = r;
      break;
    }
    case 2: {
      const int32_t s = gsticky[gs];
      const uint32_t fb = (static_cast<uint32_t>(rnd[b]) ^ ug) % ud;
      idx = (s >= 0 && s < len) ? s : static_cast<int32_t>(fb);
      break;
    }
    case 3:
      idx = static_cast<int32_t>(static_cast<uint32_t>(ch[b]) % ud);
      break;
    case 4:
      idx = static_cast<int32_t>(static_cast<uint32_t>(th[b]) % ud);
      break;
    default:
      idx = static_cast<int32_t>(
          ((static_cast<uint32_t>(rnd[b]) * 2654435761u) ^ ug) % ud);
      break;
  }
  const bool ok = gid >= 0 && len > 0;
  pick_gid[i] = ok ? gid : -1;
  pick_idx[i] = ok ? idx : -1;
}

}  // namespace

EMQX_EXPORT int emqx_share_pick(
    const void* fg, long long fcap, int gpf, const void* glen,
    const void* grr, const void* gsticky, long long gcap,
    const void* matched, const void* occ, const void* ch, const void* th,
    const void* rnd, void* pick_gid, void* pick_idx, int B, int K,
    int strategy, int phase, const void* all_counts, int dp_rank,
    void* stream) {
  const long long n = static_cast<long long>(B) * K * gpf;
  if (n > 0) {
    share_pick_kernel<<<static_cast<unsigned>((n + kThreads - 1) / kThreads),
                        kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(fg), fcap, gpf,
        static_cast<const int32_t*>(glen), static_cast<const int32_t*>(grr),
        static_cast<const int32_t*>(gsticky), gcap,
        static_cast<const int32_t*>(matched), static_cast<const int32_t*>(occ),
        static_cast<const int32_t*>(ch), static_cast<const int32_t*>(th),
        static_cast<const int32_t*>(rnd), static_cast<int32_t*>(pick_gid),
        static_cast<int32_t*>(pick_idx), n, K, strategy, phase,
        static_cast<const int32_t*>(all_counts), dp_rank);
  }
  return static_cast<int>(cudaGetLastError());
}
