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
// the work per set bit is a find-first-set and a store. Design: one warp
// per row. Each lane takes one word of a 32-word chunk, a warp-wide
// inclusive scan of the words' popcounts (__shfl_up_sync) gives every word
// its output offset, and each lane then writes its own word's bits at
// their final positions, stopping at kslot; the row's padding is written
// by the lanes together.
#include "common.cuh"

namespace {

constexpr unsigned kFull = 0xFFFFFFFFu;

__global__ void compact_kernel(const uint32_t* __restrict__ bitmaps,
                               int32_t* __restrict__ slots,
                               int32_t* __restrict__ count,
                               bool* __restrict__ overflow,
                               int32_t* __restrict__ pair, int B, int W,
                               int kslot, int lane_base) {
  const long long warp =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= B) return;  // uniform across the warp
  const int r = static_cast<int>(warp);
  const uint32_t* row = bitmaps + static_cast<size_t>(r) * W;
  int32_t* out = slots + static_cast<size_t>(r) * kslot;
  int base = 0;  // set bits in the chunks before this one
  for (int w0 = 0; w0 < W; w0 += 32) {
    const int w = w0 + lane;
    uint32_t v = w < W ? row[w] : 0u;
    const int c = __popc(v);
    int incl = c;
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(kFull, incl, off);
      if (lane >= off) incl += y;
    }
    int pos = base + incl - c;
    while (v != 0u && pos < kslot) {
      out[pos++] = lane_base + w * 32 + (__ffs(v) - 1);
      v &= v - 1u;
    }
    base += __shfl_sync(kFull, incl, 31);
  }
  for (int p = base + lane; p < kslot; p += 32) out[p] = -1;
  if (lane == 0) {
    if (count != nullptr) count[r] = base;
    if (overflow != nullptr) overflow[r] = base > kslot;
    if (pair != nullptr) {
      pair[r] = base;
      pair[static_cast<size_t>(B) + r] = base > kslot ? 1 : 0;
    }
  }
}

}  // namespace

EMQX_EXPORT int emqx_compact_fanout_slots(const void* bitmaps, void* slots,
                                          void* count, void* overflow,
                                          void* pair, int B, int W, int kslot,
                                          int lane_base, void* stream) {
  if (B > 0) {
    constexpr int kThreads = 256;  // 8 rows per block
    const long long threads = static_cast<long long>(B) * 32;
    compact_kernel<<<static_cast<unsigned>((threads + kThreads - 1) /
                                           kThreads),
                     kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(bitmaps), static_cast<int32_t*>(slots),
        static_cast<int32_t*>(count), static_cast<bool*>(overflow),
        static_cast<int32_t*>(pair), B, W, kslot, lane_base);
  }
  return static_cast<int>(cudaGetLastError());
}
