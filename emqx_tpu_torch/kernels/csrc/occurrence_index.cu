// Kernel 10: per-group occurrence rank in flat order.
//
// Replaces `_occurrence_index` (emqx_tpu/models/router_model.py:885):
// occ[i] = #{j < i : g[j] == g[i]} over the n = B * K * GPF group lanes of
// a batch, the per-batch offset round-robin picks add to the group's
// synced base. JAX gets it from a stable argsort, a cummax of run starts
// and a scatter back.
//
// Bound: bytes. The function reads n gids and writes n ranks (8n bytes),
// with a range check, a count, a prefix and an add a lane; with the totals
// it also writes gcap counts (4 gcap bytes more).
//
// Design: no sort. The caller knows the range: a gid is -1 or below `gcap`
// (share_pick passes the group arrays' length), so a gid is one of gcap + 1
// columns (column gid + 1). A lane's rank is its stable rank inside its
// tile plus the count of its column in all earlier tiles. A gid outside
// [-1, gcap) (a group table that names a group past its arrays, which a
// `GroupTable` never uploads) takes no column: occ_add ranks it exactly by
// counting its equals among the lanes before it, O(i) reads for lane i,
// so the result is the reference's on every input. Three launches:
//   1. occ_count_kernel, one block a tile of `sub` x 2048 lanes, each
//      2048-lane sub-tile ranked in shared memory by 8 warps of 256 lanes:
//      - column 0 (no group; most lanes of a batch) is ranked by ballots: a
//        warp's running count plus the lanes below in the ballot;
//      - the other lanes are left-packed in order into the warp's buffer
//        (ballots again), and the packed lanes are ranked 32 at a time: in
//        a round `__match_any_sync` finds the lanes of one column, whose
//        first lane finds the column's slot in the block's hash table (open
//        addressing, at most half full) and reads and bumps the warp's own
//        16-bit counter there; the rank in the warp is that count plus the
//        peers below. A batch's 10-15% of live lanes make one round a warp;
//      - after a barrier, each lane adds the counts of the warps below it
//        (one 16-byte read of the slot's eight counters);
//      - the block keeps its running count of each column in its own row
//        of the count matrix (zeroed by the block first), which carries
//        ranks across its sub-tiles and ends as the tile's counts; only
//        the slots the sub-tile took are visited (a list, not the table).
//      It writes the in-tile ranks to `occ`.
//   2. occ_scan_kernel: the exclusive prefix of each column over the tiles,
//      in place; a block takes 32 columns (coalesced rows), its 8 warps a
//      segment of tiles each, loads in flight together. With `totals` set
//      it also writes each group's count over all lanes, totals[gid] for
//      gid in [0, gcap): the last warp's running sum ends at its column's
//      total, so the histogram costs one store a group and no launch. It
//      is the `dp_axis` histogram of `share_pick_device`
//      (emqx_tpu/models/router_model.py:944-947),
//        zeros(Gcap).at[max(gids, 0)].add(gids >= 0, mode="drop"):
//      a gid outside [-1, gcap) takes no column and is not counted, as
//      the histogram adds nothing below 0 and drops a gid past Gcap.
//   3. occ_add_kernel, a thread a lane: occ[i] += prefix[tile][column], or
//      for a gid without a column the count of its equals before lane i.
// The count matrix is the wrapper's scratch, tiles x stride int32 (stride
// gcap + 1 rounded up to 4 words); the wrapper picks `sub` so that it
// stays a few MB at share's gcap of 16,384 (64 tiles of 2,048 lanes at
// n = 131,072: 4.2 MB, in L2).
#include "common.cuh"

namespace {

constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRounds = 8;                      // 32-lane rounds a warp
constexpr int kWarpSpan = 32 * kRounds;         // lanes a warp a sub-tile
constexpr int kSub = kWarps * kWarpSpan;        // lanes a sub-tile (OCC_SUB)
constexpr int kSlots = 2 * kSub;                // hash slots: at most half full
constexpr int kNone = -1;                       // a lane past n
constexpr int kOut = -2;                        // a gid outside [-1, gcap)
constexpr int kScanChunk = 8;                   // tiles a scan thread loads at once

static_assert(kWarpSpan < 65536, "a warp's count must fit 16 bits");
static_assert((kSlots & (kSlots - 1)) == 0, "slots must be a power of two");

struct Shared {
  int32_t key[kSlots];               // the slot's column (>= 1); 0 = empty
  uint4 cnt[kSlots];                 // eight 16-bit counters, one a warp;
                                     // x: the column's earlier count, last
  int32_t used[kSub];                // the slots this sub-tile took
  int32_t packed[kWarps][kWarpSpan]; // a warp's live columns, then ranks
  int32_t slot[kWarps][kWarpSpan];   // the packed lanes' slots
  int32_t none[kWarps];              // a warp's column-0 lanes
  int32_t none_before;               // the block's column-0 lanes before
  int32_t nused;
};

__host__ __device__ constexpr long long row_stride(long long gcap) {
  return (gcap + 4) & ~3LL;  // gcap + 1 columns, rounded up to 16 bytes
}

// column of a gid: gid + 1 in [0, gcap]; kOut past that range
__device__ __forceinline__ int32_t column(int32_t g, long long gcap) {
  return g >= -1 && g < gcap ? g + 1 : kOut;
}

// the slot of column k (>= 1), inserting it; `fresh` when this call did
__device__ __forceinline__ int slot_of(int32_t* key, int32_t k, bool& fresh) {
  uint32_t s = (static_cast<uint32_t>(k) * 0x9E3779B1u) >> 20;  // 12 bits
  static_assert(kSlots == 4096, "the hash takes 12 bits");
  fresh = false;
  while (true) {
    const int32_t prev = atomicCAS(&key[s], 0, k);
    if (prev == 0) fresh = true;
    if (prev == 0 || prev == k) return static_cast<int>(s);
    s = (s + 1) & (kSlots - 1);
  }
}

__device__ __forceinline__ uint32_t half(const uint4& v, int w) {
  const uint32_t x = w < 4 ? (w < 2 ? v.x : v.y) : (w < 6 ? v.z : v.w);
  return (w & 1) ? x >> 16 : x & 0xFFFFu;
}

__global__ void __launch_bounds__(kThreads, 2)
    occ_count_kernel(const int32_t* __restrict__ gids, long long n,
                     long long gcap, int sub, int32_t* __restrict__ counts,
                     int32_t* __restrict__ occ) {
  extern __shared__ uint4 shared_raw[];
  Shared& sh = *reinterpret_cast<Shared*>(shared_raw);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const unsigned below = (1u << lane) - 1u;
  const long long stride = row_stride(gcap);
  int32_t* row = counts + static_cast<long long>(blockIdx.x) * stride;
  int4* row4 = reinterpret_cast<int4*>(row);
  for (long long c = threadIdx.x; c < stride / 4; c += kThreads)
    row4[c] = make_int4(0, 0, 0, 0);
  int32_t* packed = sh.packed[warp];
  int32_t* pslot = sh.slot[warp];
  const long long tile = static_cast<long long>(blockIdx.x) * sub * kSub;
  for (int j = 0; j < sub; ++j) {
    const long long base = tile + static_cast<long long>(j) * kSub;
    if (base >= n) break;  // uniform across the block
    int4* key4 = reinterpret_cast<int4*>(sh.key);
    for (int s = threadIdx.x; s < kSlots / 4; s += kThreads)
      key4[s] = make_int4(0, 0, 0, 0);
    for (int s = threadIdx.x; s < kSlots; s += kThreads)
      sh.cnt[s] = make_uint4(0u, 0u, 0u, 0u);
    if (threadIdx.x == 0) sh.nused = 0;
    const long long first = base + warp * kWarpSpan + lane;
    int32_t col[kRounds];
#pragma unroll
    for (int r = 0; r < kRounds; ++r) {
      const long long q = first + r * 32;
      col[r] = q < n ? column(gids[q], gcap) : kNone;
    }
    __syncthreads();
    // column 0 by ballots; the rest packed in order
    int zeros = 0;
    int live = 0;
    int at[kRounds];  // a column-0 lane's rank in the warp, else its packed position
#pragma unroll
    for (int r = 0; r < kRounds; ++r) {
      const unsigned z = __ballot_sync(kFull, col[r] == 0);
      const unsigned l = __ballot_sync(kFull, col[r] > 0);
      at[r] = 0;
      if (col[r] == 0) at[r] = zeros + __popc(z & below);
      if (col[r] > 0) {
        at[r] = live + __popc(l & below);
        packed[at[r]] = col[r];
      }
      zeros += __popc(z);
      live += __popc(l);
    }
    __syncwarp();
    for (int p0 = 0; p0 < live; p0 += 32) {
      const int p = p0 + lane;
      const int32_t k = p < live ? packed[p] : kNone;
      const unsigned peers = __match_any_sync(kFull, k);
      const int leader = __ffs(peers) - 1;
      int s = 0;
      int c = 0;
      if (lane == leader && k != kNone) {
        bool fresh;
        s = slot_of(sh.key, k, fresh);
        if (fresh) sh.used[atomicAdd(&sh.nused, 1)] = s;
        uint16_t* mine = reinterpret_cast<uint16_t*>(&sh.cnt[s]) + warp;
        c = *mine;
        *mine = static_cast<uint16_t>(c + __popc(peers));
      }
      s = __shfl_sync(kFull, s, leader);
      c = __shfl_sync(kFull, c, leader) + __popc(peers & below);
      if (k != kNone) {
        packed[p] = c;
        pslot[p] = s;
      }
      __syncwarp();
    }
    if (lane == 0) sh.none[warp] = zeros;
    __syncthreads();
    // add the warps below; column 0's from their counts
    int none_below = 0;
    for (int w = 0; w < warp; ++w) none_below += sh.none[w];
    int rank[kRounds];
    int slot[kRounds];
#pragma unroll
    for (int r = 0; r < kRounds; ++r) {
      slot[r] = -1;
      rank[r] = at[r] + none_below;
      if (col[r] > 0) {
        slot[r] = pslot[at[r]];
        const uint4 v = sh.cnt[slot[r]];
        rank[r] = packed[at[r]];
#pragma unroll
        for (int w = 0; w < kWarps; ++w)
          if (w < warp) rank[r] += half(v, w);
      }
    }
    __syncthreads();
    // the sub-tile's counts into the block's row: the count before it
    // (j > 0: what earlier sub-tiles left there) goes to the lanes
    const int nused = sh.nused;
    for (int u = threadIdx.x; u < nused; u += kThreads) {
      const int s = sh.used[u];
      const uint4 v = sh.cnt[s];
      const uint32_t pair = v.x + v.y + v.z + v.w;  // halves <= 4 x 256: no carry
      const int32_t total = static_cast<int32_t>((pair & 0xFFFFu) + (pair >> 16));
      const int32_t k = sh.key[s];
      const int32_t before = j ? row[k] : 0;
      row[k] = before + total;
      sh.cnt[s].x = static_cast<uint32_t>(before);
    }
    if (threadIdx.x == 0) {
      int total = 0;
      for (int w = 0; w < kWarps; ++w) total += sh.none[w];
      const int32_t before = j ? row[0] : 0;
      row[0] = before + total;
      sh.none_before = before;
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < kRounds; ++r) {
      if (col[r] < 0) continue;  // past n, or ranked by occ_add
      const int32_t before = col[r] > 0 ? static_cast<int32_t>(sh.cnt[slot[r]].x)
                                        : sh.none_before;
      occ[first + r * 32] = rank[r] + before;
    }
    if (j + 1 < sub) __syncthreads();  // before the next sub-tile clears
  }
}

__global__ void __launch_bounds__(kThreads)
    occ_scan_kernel(int32_t* __restrict__ counts, long long tiles,
                    long long gcap, int32_t* __restrict__ totals) {
  __shared__ int32_t part[kWarps][32];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const long long c = static_cast<long long>(blockIdx.x) * 32 + lane;
  const bool on = c <= gcap;
  const long long stride = row_stride(gcap);
  const long long seg = (tiles + kWarps - 1) / kWarps;
  const long long t0 = warp * seg;
  const long long t1 = t0 + seg < tiles ? t0 + seg : tiles;
  int32_t* p = counts + (on ? c : 0);
  int32_t v[kScanChunk];
  int32_t sum = 0;
  for (long long t = t0; t < t1; t += kScanChunk) {
#pragma unroll
    for (int u = 0; u < kScanChunk; ++u)
      v[u] = on && t + u < t1 ? p[(t + u) * stride] : 0;
#pragma unroll
    for (int u = 0; u < kScanChunk; ++u) sum += v[u];
  }
  part[warp][lane] = sum;
  __syncthreads();
  if (!on) return;
  int32_t run = 0;
  for (int w = 0; w < warp; ++w) run += part[w][lane];
  for (long long t = t0; t < t1; t += kScanChunk) {
    if (seg > kScanChunk) {  // only the last chunk is still in registers
#pragma unroll
      for (int u = 0; u < kScanChunk; ++u)
        v[u] = t + u < t1 ? p[(t + u) * stride] : 0;
    }
#pragma unroll
    for (int u = 0; u < kScanChunk; ++u) {
      if (t + u < t1) p[(t + u) * stride] = run;
      run += v[u];
    }
  }
  // the last warp's segment ends the tiles (it may be empty): its run is
  // the column's total
  if (totals != nullptr && warp == kWarps - 1 && c >= 1) totals[c - 1] = run;
}

__global__ void occ_add_kernel(const int32_t* __restrict__ gids, long long n,
                               long long gcap, long long span,
                               const int32_t* __restrict__ prefix,
                               int32_t* __restrict__ occ) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (i >= n) return;
  const int32_t g = gids[i];
  const int32_t c = column(g, gcap);
  if (c >= 0) {
    occ[i] += __ldg(prefix + (i / span) * row_stride(gcap) + c);
    return;
  }
  // no column: count the equal gids before this lane, four reads in flight
  int32_t k[4] = {0, 0, 0, 0};
  long long j = 0;
  for (; j + 4 <= i; j += 4) {
#pragma unroll
    for (int u = 0; u < 4; ++u) k[u] += __ldg(gids + j + u) == g;
  }
  for (; j < i; ++j) k[0] += __ldg(gids + j) == g;
  occ[i] = k[0] + k[1] + k[2] + k[3];
}

// the tiles of a call, or -1 when the arguments do not fit the scratch
long long plan(long long n, long long gcap, int sub, long long words) {
  if (n < 1 || gcap < 0 || gcap >= 0x7FFFFFFFLL || sub < 1) return -1;
  const long long span = static_cast<long long>(sub) * kSub;
  const long long tiles = (n + span - 1) / span;
  if (tiles > 0x7FFFFFFFLL || tiles * row_stride(gcap) > words) return -1;
  return tiles;
}

}  // namespace

// The three launches of one call, in order, on one scratch of `words`
// int32 (at least tiles x stride, see `plan`); each returns the launch's
// cudaError_t, or cudaErrorInvalidValue when the arguments do not fit.
// `totals` (int32 [gcap], or null) takes each group's count from the scan.

EMQX_EXPORT int emqx_occ_count(const void* gids, long long n, long long gcap,
                               int sub, void* counts, long long words,
                               void* occ, void* stream) {
  const long long tiles = plan(n, gcap, sub, words);
  if (tiles < 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t e = cudaFuncSetAttribute(
      occ_count_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(sizeof(Shared)));
  if (e != cudaSuccess) return static_cast<int>(e);
  occ_count_kernel<<<static_cast<unsigned>(tiles), kThreads, sizeof(Shared),
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(gids), n, gcap, sub,
      static_cast<int32_t*>(counts), static_cast<int32_t*>(occ));
  return static_cast<int>(cudaGetLastError());
}

EMQX_EXPORT int emqx_occ_scan(long long n, long long gcap, int sub,
                              void* counts, long long words, void* totals,
                              void* stream) {
  const long long tiles = plan(n, gcap, sub, words);
  if (tiles < 0) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned blocks = static_cast<unsigned>((gcap + 32) / 32);
  occ_scan_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<int32_t*>(counts), tiles, gcap,
      static_cast<int32_t*>(totals));
  return static_cast<int>(cudaGetLastError());
}

EMQX_EXPORT int emqx_occ_add(const void* gids, long long n, long long gcap,
                             int sub, const void* counts, long long words,
                             void* occ, void* stream) {
  if (plan(n, gcap, sub, words) < 0) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned blocks = static_cast<unsigned>((n + kThreads - 1) / kThreads);
  occ_add_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(gids), n, gcap,
      static_cast<long long>(sub) * kSub, static_cast<const int32_t*>(counts),
      static_cast<int32_t*>(occ));
  return static_cast<int>(cudaGetLastError());
}
