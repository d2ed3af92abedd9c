// Kernel 8: CSR gather-union of each topic's matched filters -> compact
// subscriber slot rows.
//
// Replaces `sparse_fanout_slots` (emqx_tpu/ops/csr_table.py:84). Per row
// b: the matched fids' packed regions are laid end to end (an exclusive
// scan of their allocated lengths gives each its start), window position
// p < kg joins the region whose start is the last one <= p (a count of
// starts <= p, so a zero-length region tying its successor's start never
// owns p), and one gather from the slot column gives the candidate. Hot
// pairs whose fid is one of the row's matched fids follow the window.
// The first kslot live (>= 0) candidates of [window | hot], in that order,
// are left-packed, sorted ascending, and each adjacent duplicate is set to
// -1 where it stands (-1 may then sit mid-row, as in JAX). live[b] counts
// every live candidate, duplicates included; count[b] = live, or
// max(total, kslot + 1) when the regions' total length passes kg (the
// host rebuilds such a row); overflow[b] = count > kslot.
//
// Bound: bytes. A row reads its K fids, two region words per fid, at most
// kg slot words and the H hot pairs, and writes kslot + 3 words; the
// arithmetic (K compares per window position and per hot entry, a
// kslot-wide sort) is small. Design: one block per row. The row's fids,
// lengths, offsets and starts live in shared memory; the kg + H candidate
// positions stream through the block in chunks of its width, each chunk
// compacted in order with a warp ballot, the popcount of the lanes below
// and a scan of the 8 warp totals, so shared memory holds only the
// kslot-wide output (padded to a power of two for the bitonic sort), never
// the hot segment, whose size is the table's and not the row's.
#include "common.cuh"

#include <climits>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xFFFFFFFFu;

__global__ void __launch_bounds__(kThreads) sparse_fanout_kernel(
    const int32_t* __restrict__ off, const int32_t* __restrict__ len,
    long long fcap, const int32_t* __restrict__ col, long long pcap,
    const int32_t* __restrict__ hfid, const int32_t* __restrict__ hslot,
    long long H, const int32_t* __restrict__ matched,
    int32_t* __restrict__ slots, int32_t* __restrict__ count,
    bool* __restrict__ overflow, int32_t* __restrict__ live_out, int K,
    int kslot, int kg, int sortcap) {
  extern __shared__ int32_t smem[];
  int32_t* m = smem;        // [K] matched fids
  int32_t* fl = m + K;      // [K] allocated region lengths (0 for holes)
  int32_t* fo = fl + K;     // [K] region offsets
  int32_t* st = fo + K;     // [K] exclusive starts
  int32_t* buf = st + K;    // [sortcap] packed candidates, then sort pads
  __shared__ int warp_tot[kWarps];
  __shared__ int s_total;

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int32_t* mrow = matched + static_cast<size_t>(b) * K;
  for (int k = tid; k < K; k += kThreads) {
    const int32_t f = mrow[k];
    long long safe = f > 0 ? f : 0;
    if (safe >= fcap) safe = fcap - 1;  // JAX's gather clamps the same way
    m[k] = f;
    fl[k] = f >= 0 ? len[safe] : 0;
    fo[k] = off[safe];
  }
  for (int i = tid; i < sortcap; i += kThreads) buf[i] = i < kslot ? -1 : INT_MAX;
  __syncthreads();
  if (tid == 0) {
    uint32_t acc = 0;  // int32 wrap-around, as jnp.cumsum
    for (int k = 0; k < K; ++k) {
      st[k] = static_cast<int32_t>(acc);
      acc += static_cast<uint32_t>(fl[k]);
    }
    s_total = static_cast<int32_t>(acc);
  }
  __syncthreads();
  const int total = s_total;

  int base = 0;  // live candidates in the chunks before this one
  const long long ncand = static_cast<long long>(kg) + H;
  for (long long c0 = 0; c0 < ncand; c0 += kThreads) {
    const long long p = c0 + tid;
    int32_t cand = -1;
    if (p < kg) {
      const int pp = static_cast<int>(p);
      int seg = -1;
      for (int k = 0; k < K; ++k) seg += st[k] <= pp;
      if (seg < 0) seg = 0;
      if (seg > K - 1) seg = K - 1;
      const int j = pp - st[seg];
      if (pp < total && j < fl[seg]) {
        long long src = static_cast<long long>(fo[seg]) + j;
        if (src < 0) src = 0;
        if (src > pcap - 1) src = pcap - 1;
        cand = col[src];
      }
    } else if (p < ncand) {
      const long long h = p - kg;
      const int32_t f = hfid[h];
      if (f >= 0) {
        bool hit = false;
        for (int k = 0; k < K; ++k) hit |= m[k] == f;
        if (hit) cand = hslot[h];
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
      if (pos < kslot) buf[pos] = cand;
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
          const int32_t a = buf[i];
          const int32_t c = buf[q];
          if ((a > c) == up) {
            buf[i] = c;
            buf[q] = a;
          }
        }
      }
      __syncthreads();
    }
  }
  int32_t* out = slots + static_cast<size_t>(b) * kslot;
  for (int i = tid; i < kslot; i += kThreads) {
    const int32_t v = buf[i];
    out[i] = (i > 0 && v >= 0 && buf[i - 1] == v) ? -1 : v;
  }
  if (tid == 0) {
    const int cnt = total > kg ? (total > kslot + 1 ? total : kslot + 1) : base;
    count[b] = cnt;
    overflow[b] = cnt > kslot;
    live_out[b] = base;
  }
}

}  // namespace

EMQX_EXPORT int emqx_sparse_fanout_slots(
    const void* off, const void* len, long long fcap, const void* col,
    long long pcap, const void* hfid, const void* hslot, long long H,
    const void* matched, void* slots, void* count, void* overflow,
    void* live, int B, int K, int kslot, int kg, void* stream) {
  if (B <= 0) return static_cast<int>(cudaGetLastError());
  int sortcap = 1;
  while (sortcap < kslot) sortcap <<= 1;
  const size_t shm = sizeof(int32_t) * (4 * static_cast<size_t>(K) + sortcap);
  if (shm > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        sparse_fanout_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(shm));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  sparse_fanout_kernel<<<B, kThreads, shm, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(off), static_cast<const int32_t*>(len), fcap,
      static_cast<const int32_t*>(col), pcap,
      static_cast<const int32_t*>(hfid), static_cast<const int32_t*>(hslot), H,
      static_cast<const int32_t*>(matched), static_cast<int32_t*>(slots),
      static_cast<int32_t*>(count), static_cast<bool*>(overflow),
      static_cast<int32_t*>(live), K, kslot, kg, sortcap);
  return static_cast<int>(cudaGetLastError());
}
