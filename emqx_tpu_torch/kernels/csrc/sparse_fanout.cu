// Kernel 8: CSR gather-union of each topic's matched filters -> compact
// subscriber slot rows.
//
// Replaces `sparse_fanout_slots` (emqx_tpu/ops/csr_table.py:84). Per row
// b: the matched fids (clamped to fcap - 1 for the gathers, as JAX's
// gathers clamp) have their packed regions laid end to end (an exclusive
// scan of their allocated lengths gives each its start, in 64 bits as the
// twin's), window position p < kg joins the region whose start is the last
// one <= p (a count of starts <= p, so a zero-length region tying its
// successor's start never owns p), and one gather from the slot column
// (the source clamped to [0, pcap)) gives the candidate. Hot pairs whose
// fid is one of the row's matched fids follow the window, in hot-segment
// order. The first kslot live (>= 0) candidates of [window | hot] are
// left-packed, sorted ascending, and each adjacent duplicate is set to -1
// where it stands (-1 may then sit mid-row, as in JAX). live[b] counts
// every live candidate, duplicates included; count[b] = live, or
// max(total, kslot + 1) when the regions' total length passes kg (the
// host rebuilds such a row); overflow[b] = count > kslot.
//
// Bound: bytes. A row reads its K fids, two region words per fid, at most
// kg slot words and the H hot pairs, and writes kslot + 3 words; the
// arithmetic (K compares per window position and per hot entry, a
// kslot-wide sort) is small.
//
// Design, two instances chosen by shape, one launch either way:
// - sparse_fanout_warp (K <= 32, kslot <= 128: the serving path): a warp a
//   row, 8 rows a block, no block barrier inside a row's work. Lane k holds
//   fid k's length, offset and start (a warp scan); every lane holds the K
//   fids and the K starts (clamped to [-1, kg], which keeps every compare
//   with a position < kg) in registers. The window runs 32 positions a
//   round: K register compares give each position its region (the rank
//   form, exact for any lengths), a shuffle its start, length and offset,
//   and the lanes of one region read consecutive slot words. The hot
//   segment's fids are staged in shared memory once a block (4,096 a
//   round) and each row's warp scans them 128 at a time (a 16-byte load a
//   lane, KR register compares an entry (KR = 4 for the serving path's K
//   <= 4, else 32), one ballot; a hit, rare, is packed in order with a warp
//   scan). Live candidates are left-packed in
//   order by ballot and popcount into a kslot-word buffer of the warp's,
//   which stops storing at kslot and keeps counting; then the sort (a
//   bitonic network over 32 x E registers, E = 2 up to kslot 64 and 4 up
//   to 128: shuffles across lanes, swaps within a lane), the duplicate test
//   with a shuffle, coalesced stores.
// - sparse_fanout_block (any K, any kslot): a block of 256 a row, the
//   regions' words and the kslot-wide sort in shared memory, each chunk of
//   256 candidates compacted with a warp ballot and a scan of the 8 warp
//   totals, the hot segment read from global memory.
#include "common.cuh"

#include <climits>

namespace {

constexpr unsigned kFull = 0xFFFFFFFFu;

struct Args {
  const int32_t* off;
  const int32_t* len;
  long long fcap;
  const int32_t* col;
  long long pcap;
  const int32_t* hfid;
  const int32_t* hslot;
  long long H;
  const int32_t* matched;
  int32_t* slots;
  int32_t* count;
  bool* overflow;
  int32_t* live;
  int B;
  int K;
  int kslot;
  int kg;
};

// count[b], overflow[b] (count > kslot) and live[b] of one row: count is
// live, or max(total, kslot + 1) past the window, as an int32 (the twin's
// int64 -> int32 conversion keeps the low 32 bits)
__device__ __forceinline__ void row_counts(const Args& a, int b, long long total, int live) {
  const long long c64 =
      total > a.kg ? (total > a.kslot + 1ll ? total : a.kslot + 1ll) : static_cast<long long>(live);
  const int32_t c = static_cast<int32_t>(static_cast<uint32_t>(c64));
  a.count[b] = c;
  a.overflow[b] = c > a.kslot;
  a.live[b] = live;
}

// fid f's gather inputs: its allocated length (0 for a hole) and offset
__device__ __forceinline__ void region(const Args& a, int32_t f, int32_t* fl, int32_t* fo) {
  long long safe = f > 0 ? f : 0;
  if (safe >= a.fcap) safe = a.fcap - 1;  // JAX's gather clamps the same way
  *fl = f >= 0 ? __ldg(a.len + safe) : 0;
  *fo = __ldg(a.off + safe);
}

__device__ __forceinline__ int32_t gather_slot(const Args& a, long long src) {
  if (src < 0) src = 0;
  if (src > a.pcap - 1) src = a.pcap - 1;
  return __ldg(a.col + src);
}

// -- the warp instance ---------------------------------------------------------

constexpr int kRowsPerBlock = 8;
constexpr int kWarpThreads = 32 * kRowsPerBlock;
constexpr int kHotChunk = 4096;  // hot fids staged a round (16 KB)

// Appends one candidate a lane to the warp's ordered pack: lanes in order,
// positions past kslot counted but not stored.
__device__ __forceinline__ void pack(int32_t cand, int32_t* buf, int kslot, int lane, int* base) {
  const bool ok = cand >= 0;
  const unsigned bal = __ballot_sync(kFull, ok);
  const int pos = *base + __popc(bal & ((1u << lane) - 1u));
  if (ok && pos < kslot) buf[pos] = cand;
  *base += __popc(bal);
}

// Ascending bitonic sort of the 32 x E values v[e] at index e * 32 + lane.
template <int E>
__device__ __forceinline__ void warp_sort(int32_t (&v)[E], int lane) {
#pragma unroll
  for (int size = 2; size <= 32 * E; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      if (stride >= 32) {  // partners in one lane: registers e and e ^ (stride / 32)
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const int q = e ^ (stride >> 5);
          if (q > e) {
            const bool up = ((e * 32 + lane) & size) == 0;
            const int32_t x = v[e], y = v[q];
            if ((x > y) == up) {
              v[e] = y;
              v[q] = x;
            }
          }
        }
      } else {  // partners across lanes
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const int32_t y = __shfl_xor_sync(kFull, v[e], stride);
          const bool up = ((e * 32 + lane) & size) == 0;
          const bool lower = (lane & stride) == 0;
          v[e] = (lower == up) ? min(v[e], y) : max(v[e], y);
        }
      }
    }
  }
}

template <int E, int KR>
__global__ void __launch_bounds__(kWarpThreads) sparse_fanout_warp(Args a) {
  __shared__ int4 s_hot4[kHotChunk / 4];
  __shared__ int32_t s_buf[kRowsPerBlock][32 * E];
  int32_t* s_hot = reinterpret_cast<int32_t*>(s_hot4);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int b = blockIdx.x * kRowsPerBlock + warp;
  const bool row_ok = b < a.B;
  int32_t* buf = s_buf[warp];

  // lane k: fid k, its region and its exclusive start
  int32_t f = -1, fl = 0, fo = 0;
  if (row_ok && lane < a.K) {
    f = __ldg(a.matched + static_cast<size_t>(b) * a.K + lane);
    region(a, f, &fl, &fo);
  }
  long long incl = fl;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const long long y = __shfl_up_sync(kFull, incl, d);
    if (lane >= d) incl += y;
  }
  const long long st = incl - fl;
  const long long total = __shfl_sync(kFull, incl, 31);
  // every lane: the K fids and the K starts (clamped: a start < 0 is <= any
  // position, one past kg above every position; unused ranks never count)
  int32_t sc = INT_MAX;
  if (lane < a.K) sc = st < 0 ? -1 : (st > a.kg ? a.kg : static_cast<int32_t>(st));
  int32_t m[KR], s[KR];
#pragma unroll
  for (int k = 0; k < KR; ++k) {
    m[k] = __shfl_sync(kFull, f, k);
    s[k] = __shfl_sync(kFull, sc, k);
  }
  const bool any_fid = __any_sync(kFull, f >= 0);

  // the window: 32 positions a round
  int base = 0;
  const int wend = total < a.kg ? (total > 0 ? static_cast<int>(total) : 0) : a.kg;
  for (int c = 0; c < wend; c += 32) {
    const int p = c + lane;
    int cnt = 0;
#pragma unroll
    for (int k = 0; k < KR; ++k) cnt += s[k] <= p;
    int seg = cnt - 1;
    seg = seg < 0 ? 0 : (seg > a.K - 1 ? a.K - 1 : seg);
    const long long sg = __shfl_sync(kFull, st, seg);
    const int32_t lg = __shfl_sync(kFull, fl, seg);
    const int32_t og = __shfl_sync(kFull, fo, seg);
    const long long j = p - sg;
    int32_t cand = -1;
    if (p < wend && j < lg) cand = gather_slot(a, og + j);
    pack(cand, buf, a.kslot, lane, &base);
  }

  // the hot segment, staged a chunk at a time; every warp takes part in the
  // staging, a row's warp scans only if it has a fid
  for (long long h0 = 0; h0 < a.H; h0 += kHotChunk) {
    const long long rem = a.H - h0;
    const int n = rem < kHotChunk ? static_cast<int>(rem) : kHotChunk;
    const int n128 = (n + 127) & ~127;
    __syncthreads();  // the previous chunk's scans are done
    for (int i = threadIdx.x; i < n128; i += kWarpThreads) {
      s_hot[i] = i < n ? __ldg(a.hfid + h0 + i) : -1;
    }
    __syncthreads();
    if (!row_ok || !any_fid) continue;
    for (int i0 = 0; i0 < n128; i0 += 128) {
      const int4 q = s_hot4[(i0 >> 2) + lane];
      const int32_t fv[4] = {q.x, q.y, q.z, q.w};
      unsigned hm = 0;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        bool hit = false;
#pragma unroll
        for (int k = 0; k < KR; ++k) hit |= m[k] == fv[e];
        hm |= (hit && fv[e] >= 0) ? (1u << e) : 0u;
      }
      if (!__any_sync(kFull, hm != 0)) continue;
      // rare: this lane's hits, in order, with their live slots
      int32_t sv[4];
      int c = 0;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        sv[e] = (hm >> e) & 1u ? __ldg(a.hslot + h0 + i0 + lane * 4 + e) : -1;
        c += sv[e] >= 0;
      }
      int x = c;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int y = __shfl_up_sync(kFull, x, d);
        if (lane >= d) x += y;
      }
      int pos = base + x - c;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (sv[e] >= 0) {
          if (pos < a.kslot) buf[pos] = sv[e];
          ++pos;
        }
      }
      base += __shfl_sync(kFull, x, 31);
    }
  }
  if (!row_ok) return;
  __syncwarp();

  // the first kslot live candidates, -1 past them, INT_MAX past kslot
  const int filled = base < a.kslot ? base : a.kslot;
  int32_t v[E];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int i = e * 32 + lane;
    v[e] = i < filled ? buf[i] : (i < a.kslot ? -1 : INT_MAX);
  }
  warp_sort<E>(v, lane);
  int32_t* out = a.slots + static_cast<size_t>(b) * a.kslot;
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int i = e * 32 + lane;
    const int32_t up = __shfl_up_sync(kFull, v[e], 1);
    const int32_t wrap = __shfl_sync(kFull, v[e > 0 ? e - 1 : 0], 31);
    const int32_t prev = lane ? up : wrap;
    if (i < a.kslot) out[i] = (i > 0 && v[e] >= 0 && prev == v[e]) ? -1 : v[e];
  }
  if (lane == 0) row_counts(a, b, total, base);
}

// -- the block instance ----------------------------------------------------------

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__global__ void __launch_bounds__(kThreads) sparse_fanout_block(Args a, int sortcap) {
  extern __shared__ long long smem64[];
  long long* st = smem64;                                // [K] exclusive starts
  int32_t* m = reinterpret_cast<int32_t*>(st + a.K);    // [K] matched fids
  int32_t* fl = m + a.K;                                // [K] allocated lengths
  int32_t* fo = fl + a.K;                               // [K] region offsets
  int32_t* sc = fo + a.K;                               // [K] clamped starts
  int32_t* buf = sc + a.K;                              // [sortcap]
  __shared__ int warp_tot[kWarps];
  __shared__ long long s_total;

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int K = a.K;
  for (int k = tid; k < K; k += kThreads) {
    const int32_t f = __ldg(a.matched + static_cast<size_t>(b) * K + k);
    m[k] = f;
    region(a, f, fl + k, fo + k);
  }
  for (int i = tid; i < sortcap; i += kThreads) buf[i] = i < a.kslot ? -1 : INT_MAX;
  __syncthreads();
  if (tid == 0) {
    long long acc = 0;
    for (int k = 0; k < K; ++k) {
      st[k] = acc;
      sc[k] = acc < 0 ? -1 : (acc > a.kg ? a.kg : static_cast<int32_t>(acc));
      acc += fl[k];
    }
    s_total = acc;
  }
  __syncthreads();
  const long long total = s_total;
  const int wend = total < a.kg ? (total > 0 ? static_cast<int>(total) : 0) : a.kg;

  int base = 0;  // live candidates in the chunks before this one
  const long long ncand = static_cast<long long>(wend) + a.H;
  for (long long c0 = 0; c0 < ncand; c0 += kThreads) {
    const long long p = c0 + tid;
    int32_t cand = -1;
    if (p < wend) {
      const int pp = static_cast<int>(p);
      int seg = -1;
      for (int k = 0; k < K; ++k) seg += sc[k] <= pp;
      seg = seg < 0 ? 0 : (seg > K - 1 ? K - 1 : seg);
      const long long j = pp - st[seg];
      if (j < fl[seg]) cand = gather_slot(a, fo[seg] + j);
    } else if (p < ncand) {
      const long long h = p - wend;
      const int32_t f = __ldg(a.hfid + h);
      if (f >= 0) {
        bool hit = false;
        for (int k = 0; k < K; ++k) hit |= m[k] == f;
        if (hit) cand = __ldg(a.hslot + h);
      }
    }
    const bool ok = cand >= 0;
    const unsigned bal = __ballot_sync(kFull, ok);
    if (lane == 0) warp_tot[warp] = __popc(bal);
    __syncthreads();
    int before = 0, chunk = 0;
    for (int w = 0; w < kWarps; ++w) {
      const int t = warp_tot[w];
      before += w < warp ? t : 0;
      chunk += t;
    }
    if (ok) {
      const int pos = base + before + __popc(bal & ((1u << lane) - 1u));
      if (pos < a.kslot) buf[pos] = cand;
    }
    base += chunk;
    __syncthreads();  // warp_tot is rewritten by the next chunk
  }

  // bitonic sort, ascending: -1 pads go to the front, INT_MAX pads past
  // kslot to the back
  for (int size = 2; size <= sortcap; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = tid; i < sortcap; i += kThreads) {
        const int q = i ^ stride;
        if (q > i) {
          const bool up = (i & size) == 0;
          const int32_t x = buf[i];
          const int32_t y = buf[q];
          if ((x > y) == up) {
            buf[i] = y;
            buf[q] = x;
          }
        }
      }
      __syncthreads();
    }
  }
  int32_t* out = a.slots + static_cast<size_t>(b) * a.kslot;
  for (int i = tid; i < a.kslot; i += kThreads) {
    const int32_t v = buf[i];
    out[i] = (i > 0 && v >= 0 && buf[i - 1] == v) ? -1 : v;
  }
  if (tid == 0) row_counts(a, b, total, base);
}

template <int E, int KR>
void launch_warp(const Args& a, cudaStream_t stream) {
  const unsigned grid = static_cast<unsigned>((a.B + kRowsPerBlock - 1) / kRowsPerBlock);
  sparse_fanout_warp<E, KR><<<grid, kWarpThreads, 0, stream>>>(a);
}

template <int E>
void launch_warp_k(const Args& a, cudaStream_t stream) {
  if (a.K <= 4) {  // the serving path's shape lane (m_active 4)
    launch_warp<E, 4>(a, stream);
  } else {
    launch_warp<E, 32>(a, stream);
  }
}

}  // namespace

EMQX_EXPORT int emqx_sparse_fanout_slots(
    const void* off, const void* len, long long fcap, const void* col,
    long long pcap, const void* hfid, const void* hslot, long long H,
    const void* matched, void* slots, void* count, void* overflow,
    void* live, int B, int K, int kslot, int kg, void* stream) {
  if (B <= 0) return static_cast<int>(cudaGetLastError());
  const Args a{static_cast<const int32_t*>(off), static_cast<const int32_t*>(len), fcap,
               static_cast<const int32_t*>(col), pcap,
               static_cast<const int32_t*>(hfid), static_cast<const int32_t*>(hslot), H,
               static_cast<const int32_t*>(matched), static_cast<int32_t*>(slots),
               static_cast<int32_t*>(count), static_cast<bool*>(overflow),
               static_cast<int32_t*>(live), B, K, kslot, kg};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (K <= 32 && kslot <= 128) {
    if (kslot <= 64) {  // the routers' floor, KSLOT_MIN
      launch_warp_k<2>(a, s);
    } else {
      launch_warp_k<4>(a, s);
    }
    return static_cast<int>(cudaGetLastError());
  }
  int sortcap = 1;
  while (sortcap < kslot) sortcap <<= 1;
  const size_t shm = sizeof(long long) * static_cast<size_t>(K) +
                     sizeof(int32_t) * (4 * static_cast<size_t>(K) + sortcap);
  if (shm > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        sparse_fanout_block, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(shm));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  sparse_fanout_block<<<B, kThreads, shm, s>>>(a, sortcap);
  return static_cast<int>(cudaGetLastError());
}
