// Kernel 3: matched filter ids -> OR of their subscriber bitmap rows, plus
// the per-row popcount (the `fanout_bits` statistic).
//
// Replaces `fanout_bitmaps` and `popcount32`
// (emqx_tpu/models/router_model.py:52, :44). out[b, :] is the bitwise OR
// of sub_bitmaps[f, :] over the row's lanes with 0 <= f < Fcap (-1 holes
// and out-of-range fids read nothing); popcount[b] counts its set bits.
//
// Bound: bytes. The B x K lanes in, each distinct matched fid's W-word
// row gathered, the B x W words and B counts out; one OR a gathered word.
// Matches are sparse (4,196 of 524,288 lanes at plus_100k), so the lanes
// are read once a row, not once a word. Design:
// - a team reads the row's K fids with coalesced loads and keeps the
//   in-range ones in shared memory (a warp ballot and a __popc prefix);
//   its threads then OR only those rows, and a row with no match stores
//   its zeros without a gather;
// - each thread owns 4 consecutive words: one 16-byte load a fid through
//   the read-only path and one 16-byte store when W % 4 == 0 and both
//   bases are 16-byte aligned, else 4 scalar words, in the same kernel;
// - the popcount is summed in registers (warp shuffles, then shared memory
//   across a block's warps) and written once by the row's owner: no
//   atomics, and no zeroing launch before the kernel.
// Teams: W <= 128 words (G = ceil(W / 4) <= 32 groups of 4 words), T
// lanes a row, T the power of two at least G and at least min(K, 32), so
// the lanes take few chunks and small rows share a warp (T = 4 at W = 8,
// K = 4: 8 rows a warp); the team's lanes form T / P slices (P = G rounded
// up to a power of two) that OR disjoint fids into the same groups and meet
// in xor shuffles; blocks of 64 threads. W > 128, a block of 256 threads a
// row, each thread striding over the groups. At B = 8,192: 512 blocks at
// W = 8, K = 4, and 8,192 past W = 128, for 132 SMs.
// Stores: default (write-back through L2), or streaming (__stcs, evict
// first) when the caller asks; at plus_100k, fan-out and the compaction
// that reads its bitmaps together, the default stores were no slower
// (PERF.md records both).
#include <algorithm>

#include "common.cuh"

namespace {

constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kWarp = 32;
constexpr int kBlock = 256;
constexpr int kWarpsPerBlock = kBlock / kWarp;
constexpr int kTeamBlock = 64;  // 512 blocks at W = 8, K = 4, B = 8,192
constexpr int kTeamWarps = kTeamBlock / kWarp;
constexpr int kTeamMaxWords = 4 * kWarp;  // the widest row a team takes

__device__ __forceinline__ bool in_range(int32_t f, long long fcap) {
  return f >= 0 && f < fcap;
}

__device__ __forceinline__ unsigned lanes_below(int lane) {
  return (1u << lane) - 1u;
}

__device__ __forceinline__ int popc4(const uint4& v) {
  return __popc(v.x) + __popc(v.y) + __popc(v.z) + __popc(v.w);
}

// v |= row f's words [4g, 4g + 4) (those below W)
__device__ __forceinline__ void gather_or(uint4& v,
                                          const uint32_t* __restrict__ sub,
                                          int32_t f, int W, int g, bool vec) {
  const uint32_t* p = sub + static_cast<size_t>(f) * W + 4 * g;
  if (vec) {
    const uint4 r = __ldg(reinterpret_cast<const uint4*>(p));
    v.x |= r.x;
    v.y |= r.y;
    v.z |= r.z;
    v.w |= r.w;
  } else {
    const int n = min(4, W - 4 * g);
    v.x |= __ldg(p);
    if (n > 1) v.y |= __ldg(p + 1);
    if (n > 2) v.z |= __ldg(p + 2);
    if (n > 3) v.w |= __ldg(p + 3);
  }
}

template <bool kStream>
__device__ __forceinline__ void put(uint32_t* p, uint32_t x) {
  if (kStream) {
    __stcs(p, x);
  } else {
    *p = x;
  }
}

// words [4g, 4g + 4) of one output row (those below W)
template <bool kStream>
__device__ __forceinline__ void store_words(uint32_t* __restrict__ row, int W,
                                            int g, const uint4& v, bool vec) {
  uint32_t* p = row + 4 * g;
  if (vec) {
    if (kStream) {
      __stcs(reinterpret_cast<uint4*>(p), v);
    } else {
      *reinterpret_cast<uint4*>(p) = v;
    }
  } else {
    const int n = min(4, W - 4 * g);
    put<kStream>(p, v.x);
    if (n > 1) put<kStream>(p + 1, v.y);
    if (n > 2) put<kStream>(p + 2, v.z);
    if (n > 3) put<kStream>(p + 3, v.w);
  }
}

// W <= 128: a team of T lanes a row (T a power of two, at least G and,
// up to 32, at least K), 32 / T rows a warp
template <bool kStream>
__device__ __forceinline__ void fanout_team(
    const uint32_t* __restrict__ sub, long long fcap,
    const int32_t* __restrict__ matched, uint32_t* __restrict__ out,
    int32_t* __restrict__ popcount, int B, int K, int W, int T, bool vec) {
  __shared__ int32_t fids[kTeamWarps][kWarp];
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int team = lane / T;
  const int t = lane % T;
  const long long row =
      (static_cast<long long>(blockIdx.x) * kTeamWarps + warp) * (kWarp / T) +
      team;
  const bool live = row < B;
  const int G = (W + 3) / 4;
  int P = 1;
  while (P < G) P <<= 1;
  const int g = t & (P - 1);
  const int slice = t / P;
  const int slices = T / P;
  const bool owner = live && g < G;
  const unsigned team_bits =
      (T == kWarp ? kFull : (1u << T) - 1u) << (team * T);
  const int32_t* lanes = matched + row * K;
  int32_t* list = fids[warp] + team * T;
  uint4 v = make_uint4(0u, 0u, 0u, 0u);
  for (int k0 = 0; k0 < K; k0 += T) {  // the same trip count for every team
    const int32_t f = live && k0 + t < K ? lanes[k0 + t] : -1;
    const bool ok = in_range(f, fcap);
    const unsigned mask = __ballot_sync(kFull, ok) & team_bits;
    if (ok) list[__popc(mask & lanes_below(lane))] = f;
    __syncwarp();
    const int n = __popc(mask);
    if (owner) {
      for (int j = slice; j < n; j += slices) gather_or(v, sub, list[j], W, g, vec);
    }
    __syncwarp();  // the list is read before the next chunk rewrites it
  }
  for (int off = P; off < T; off <<= 1) {  // the slices meet inside the team
    v.x |= __shfl_xor_sync(kFull, v.x, off);
    v.y |= __shfl_xor_sync(kFull, v.y, off);
    v.z |= __shfl_xor_sync(kFull, v.z, off);
    v.w |= __shfl_xor_sync(kFull, v.w, off);
  }
  int pc = 0;
  if (owner && slice == 0) {
    store_words<kStream>(out + row * W, W, g, v, vec);
    pc = popc4(v);
  }
  for (int off = T / 2; off > 0; off >>= 1) pc += __shfl_xor_sync(kFull, pc, off);
  if (live && t == 0) popcount[row] = pc;
}

// W > 128: one block a row; the row's in-range fids in dynamic shared
// memory (K entries)
template <bool kStream>
__device__ __forceinline__ void fanout_block(
    const uint32_t* __restrict__ sub, long long fcap,
    const int32_t* __restrict__ matched, uint32_t* __restrict__ out,
    int32_t* __restrict__ popcount, int K, int W, bool vec) {
  extern __shared__ int32_t list[];
  __shared__ int per_warp[kWarpsPerBlock];
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const size_t row = blockIdx.x;
  const int32_t* lanes = matched + row * K;
  int n = 0;
  for (int k0 = 0; k0 < K; k0 += kBlock) {
    const int k = k0 + static_cast<int>(threadIdx.x);
    const int32_t f = k < K ? lanes[k] : -1;
    const bool ok = in_range(f, fcap);
    const unsigned mask = __ballot_sync(kFull, ok);
    if (lane == 0) per_warp[warp] = __popc(mask);
    __syncthreads();
    int at = n;
    for (int w = 0; w < kWarpsPerBlock; ++w) {
      if (w == warp) at = n;
      n += per_warp[w];
    }
    if (ok) list[at + __popc(mask & lanes_below(lane))] = f;
    __syncthreads();  // the list is whole and per_warp free again
  }
  const int G = (W + 3) / 4;
  uint32_t* orow = out + row * W;
  int pc = 0;
  for (int g = threadIdx.x; g < G; g += kBlock) {
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
#pragma unroll 4
    for (int j = 0; j < n; ++j) gather_or(v, sub, list[j], W, g, vec);
    store_words<kStream>(orow, W, g, v, vec);
    pc += popc4(v);
  }
  pc = static_cast<int>(__reduce_add_sync(kFull, static_cast<unsigned>(pc)));
  if (lane == 0) per_warp[warp] = pc;
  __syncthreads();
  if (threadIdx.x == 0) {
    int total = 0;
    for (int w = 0; w < kWarpsPerBlock; ++w) total += per_warp[w];
    popcount[row] = total;
  }
}

template <bool kWide, bool kStream>
__global__ void __launch_bounds__(kBlock)
    fanout_kernel(const uint32_t* __restrict__ sub, long long fcap,
                  const int32_t* __restrict__ matched,
                  uint32_t* __restrict__ out, int32_t* __restrict__ popcount,
                  int B, int K, int W, int T, bool vec) {
  if constexpr (kWide) {
    fanout_block<kStream>(sub, fcap, matched, out, popcount, K, W, vec);
  } else {
    fanout_team<kStream>(sub, fcap, matched, out, popcount, B, K, W, T, vec);
  }
}

int pow2_at_least(int x) {
  int p = 1;
  while (p < x) p <<= 1;
  return p;
}

template <bool kWide, bool kStream>
void run(const void* sub, long long fcap, const void* matched, void* out,
         void* popcount, int B, int K, int W, bool vec, cudaStream_t stream) {
  unsigned blocks = static_cast<unsigned>(B);
  int threads = kBlock, T = 0;
  size_t smem = sizeof(int32_t) * static_cast<size_t>(K);
  if (!kWide) {
    T = pow2_at_least(std::max((W + 3) / 4, std::min(K, kWarp)));
    const int rows = kTeamBlock / T;
    blocks = static_cast<unsigned>((B + rows - 1) / rows);
    threads = kTeamBlock;
    smem = 0;
  }
  fanout_kernel<kWide, kStream><<<blocks, threads, smem, stream>>>(
      static_cast<const uint32_t*>(sub), fcap,
      static_cast<const int32_t*>(matched), static_cast<uint32_t*>(out),
      static_cast<int32_t*>(popcount), B, K, W, T, vec);
}

}  // namespace

EMQX_EXPORT int emqx_fanout_bitmaps(const void* sub_bitmaps, long long fcap,
                                    const void* matched, void* out,
                                    void* popcount, int B, int K, int W,
                                    int streaming, void* stream) {
  if (B > 0) {
    const bool vec =
        W % 4 == 0 && ((reinterpret_cast<uintptr_t>(sub_bitmaps) |
                        reinterpret_cast<uintptr_t>(out)) &
                       15u) == 0;
    const auto s = static_cast<cudaStream_t>(stream);
    const bool wide = W > kTeamMaxWords;
    if (wide && streaming) {
      run<true, true>(sub_bitmaps, fcap, matched, out, popcount, B, K, W, vec, s);
    } else if (wide) {
      run<true, false>(sub_bitmaps, fcap, matched, out, popcount, B, K, W, vec, s);
    } else if (streaming) {
      run<false, true>(sub_bitmaps, fcap, matched, out, popcount, B, K, W, vec, s);
    } else {
      run<false, false>(sub_bitmaps, fcap, matched, out, popcount, B, K, W, vec, s);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
