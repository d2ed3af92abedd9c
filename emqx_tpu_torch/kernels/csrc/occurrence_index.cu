// Kernel 10: per-group occurrence rank in flat order.
//
// Replaces `_occurrence_index` (emqx_tpu/models/router_model.py:885):
// occ[i] = #{j < i : g[j] == g[i]} over the n = B * K * GPF group lanes of
// a batch, the per-batch offset round-robin picks add to the group's
// synced base. JAX gets it from a stable argsort, a cummax of run starts
// and a scatter back.
//
// Design: no stability is needed. Every lane becomes one 64-bit key,
// (gid ^ 0x80000000) << 32 | i, so the keys are unique and any correct
// sort keeps arrival order within a gid. The sort is written here:
//   1. one block per tile of 2048 keys sorts it in shared memory (bitonic;
//      the ragged last tile is padded with all-ones keys that are never
//      written back);
//   2. merge passes double the sorted run length until one run remains;
//      each thread places one key of a pair of runs at its own position
//      plus its rank in the sibling run (a binary search: keys are unique,
//      so the two runs never tie);
//   3. each sorted position p finds the first position of its gid's run
//      with a binary search for (gid << 32), and writes p minus that start
//      to occ[i] for the key's lane i.
// The two ping-pong key buffers (2 x n x 8 bytes) are the wrapper's.
//
// Bound: bytes. The function reads n gids and writes n ranks (8n bytes);
// the sort moves 16 bytes per key per merge pass (log2(n / 2048) passes)
// plus one tile pass, which is where the time goes at these sizes (n is a
// few hundred thousand lanes, far below what would pay for a radix sort's
// passes over digits).
#include "common.cuh"

namespace {

constexpr int kTile = 2048;
constexpr int kTileThreads = 1024;
constexpr int kThreads = 256;

__device__ __forceinline__ uint64_t make_key(int32_t g, long long i) {
  return (static_cast<uint64_t>(static_cast<uint32_t>(g) ^ 0x80000000u) << 32) |
         static_cast<uint64_t>(static_cast<uint32_t>(i));
}

__global__ void __launch_bounds__(kTileThreads)
    occ_tile_sort(const int32_t* __restrict__ g, uint64_t* __restrict__ out,
                  long long n) {
  __shared__ uint64_t s[kTile];
  const long long base = static_cast<long long>(blockIdx.x) * kTile;
  for (int i = threadIdx.x; i < kTile; i += kTileThreads) {
    const long long q = base + i;
    s[i] = q < n ? make_key(g[q], q) : ~0ull;
  }
  __syncthreads();
  for (int size = 2; size <= kTile; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = threadIdx.x; i < kTile; i += kTileThreads) {
        const int q = i ^ stride;
        if (q > i) {
          const bool up = (i & size) == 0;
          const uint64_t a = s[i];
          const uint64_t c = s[q];
          if ((a > c) == up) {
            s[i] = c;
            s[q] = a;
          }
        }
      }
      __syncthreads();
    }
  }
  for (int i = threadIdx.x; i < kTile; i += kTileThreads) {
    if (base + i < n) out[base + i] = s[i];
  }
}

__global__ void occ_merge(const uint64_t* __restrict__ in,
                          uint64_t* __restrict__ out, long long n,
                          long long run) {
  const long long q = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (q >= n) return;
  const long long r = q / run;
  const long long base = (r >> 1) * 2 * run;
  const long long mine = q - r * run;
  long long lo, hi;
  if ((r & 1) == 0) {
    lo = base + run;
    hi = base + 2 * run < n ? base + 2 * run : n;
    if (hi < lo) hi = lo;  // no right sibling: the run is copied
  } else {
    lo = base;
    hi = base + run;
  }
  const long long lo0 = lo;
  const uint64_t key = in[q];
  while (lo < hi) {
    const long long mid = (lo + hi) >> 1;
    if (in[mid] < key) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  out[base + mine + (lo - lo0)] = key;
}

__global__ void occ_finalize(const uint64_t* __restrict__ s,
                             int32_t* __restrict__ occ, long long n) {
  const long long p = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (p >= n) return;
  const uint64_t key = s[p];
  const uint64_t gkey = key & 0xFFFFFFFF00000000ull;
  long long lo = 0, hi = p;  // the run's first key is at or before p
  while (lo < hi) {
    const long long mid = (lo + hi) >> 1;
    if (s[mid] < gkey) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  occ[static_cast<uint32_t>(key)] = static_cast<int32_t>(p - lo);
}

}  // namespace

// The wrapper launches the three kernels in order, one C call each, and
// ping-pongs the merge passes between the two halves of its scratch.

EMQX_EXPORT int emqx_occ_tile_sort(const void* gids, void* keys, long long n,
                                   void* stream) {
  const unsigned tiles = static_cast<unsigned>((n + kTile - 1) / kTile);
  occ_tile_sort<<<tiles, kTileThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(gids), static_cast<uint64_t*>(keys), n);
  return static_cast<int>(cudaGetLastError());
}

EMQX_EXPORT int emqx_occ_merge(const void* in, void* out, long long n,
                               long long run, void* stream) {
  const unsigned blocks = static_cast<unsigned>((n + kThreads - 1) / kThreads);
  occ_merge<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint64_t*>(in), static_cast<uint64_t*>(out), n, run);
  return static_cast<int>(cudaGetLastError());
}

EMQX_EXPORT int emqx_occ_finalize(const void* keys, void* occ, long long n,
                                  void* stream) {
  const unsigned blocks = static_cast<unsigned>((n + kThreads - 1) / kThreads);
  occ_finalize<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint64_t*>(keys), static_cast<int32_t*>(occ), n);
  return static_cast<int>(cudaGetLastError());
}
