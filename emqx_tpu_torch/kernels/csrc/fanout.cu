// Kernel 3: matched filter ids -> OR of their subscriber bitmap rows, plus
// the per-row popcount (the `fanout_bits` statistic).
//
// Replaces `fanout_bitmaps` and `popcount32`
// (emqx_tpu/models/router_model.py:52, :44). out[b, :] is the bitwise OR
// of sub_bitmaps[f, :] over the row's matched fids f >= 0 (-1 holes are
// skipped); popcount[b] counts its set bits.
//
// Bound: bytes. Each valid fid gathers one W-word row (32 bytes at W = 8)
// from a table of Fcap x W words (33.5 MB at 1M filters), and the output
// is B x W words; one OR per word. Design: one thread per (row, word), so
// the K gathers of a word are independent loads in flight at once, the
// row's W threads read one contiguous stretch of each bitmap row, and the
// stores of a warp are contiguous. The popcount adds each thread's
// __popc into popcount[b] (zeroed by the wrapper) with one atomic per
// nonzero word. A fid outside [0, Fcap) reads nothing.
#include "common.cuh"

namespace {

__global__ void fanout_kernel(const uint32_t* __restrict__ sub_bitmaps,
                              long long fcap,
                              const int32_t* __restrict__ matched,
                              uint32_t* __restrict__ out,
                              int32_t* __restrict__ popcount, int B, int K,
                              int W) {
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (t >= static_cast<long long>(B) * W) return;
  const int r = static_cast<int>(t / W);
  const int w = static_cast<int>(t % W);
  const int32_t* fids = matched + static_cast<size_t>(r) * K;
  uint32_t v = 0u;
  for (int k = 0; k < K; ++k) {
    const int32_t f = fids[k];
    if (f >= 0 && f < fcap) v |= sub_bitmaps[static_cast<size_t>(f) * W + w];
  }
  out[t] = v;
  if (v) atomicAdd(popcount + r, __popc(v));
}

}  // namespace

EMQX_EXPORT int emqx_fanout_bitmaps(const void* sub_bitmaps, long long fcap,
                                    const void* matched, void* out,
                                    void* popcount, int B, int K, int W,
                                    void* stream) {
  const long long n = static_cast<long long>(B) * W;
  if (n > 0) {
    constexpr int kThreads = 256;
    fanout_kernel<<<static_cast<unsigned>((n + kThreads - 1) / kThreads),
                    kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(sub_bitmaps), fcap,
        static_cast<const int32_t*>(matched), static_cast<uint32_t*>(out),
        static_cast<int32_t*>(popcount), B, K, W);
  }
  return static_cast<int>(cudaGetLastError());
}
