// Kernel 15b: one dp shard's per-group histogram of live $share lanes.
//
// Replaces the histogram of the mesh branch of `share_pick_device`
// (emqx_tpu/models/router_model.py:944-947):
//   counts = zeros(Gcap).at[max(gids, 0)].add(gids >= 0, mode="drop")
// over the raw group lanes of this shard's rows (share_pick.cu, phase 0).
// A lane with gid -1 adds nothing, a gid at or past gcap is dropped. The
// counts are all-gathered over 'dp' and read by share_pick.cu's phase 1.
//
// Bound: bytes. It reads n lane words and writes gcap counts (zeroed by
// the wrapper); one 32-bit atomic add per live lane. Design: one thread
// per lane; lanes of one group collide only in L2's atomic units, which
// at a batch's few thousand lanes a group costs less than a sort.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void group_counts_kernel(const int32_t* __restrict__ gids,
                                    long long n, int32_t* __restrict__ counts,
                                    long long gcap) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (i >= n) return;
  const int32_t g = gids[i];
  if (g >= 0 && g < gcap) atomicAdd(&counts[g], 1);
}

}  // namespace

EMQX_EXPORT int emqx_group_counts(const void* gids, long long n, void* counts,
                                  long long gcap, void* stream) {
  if (n > 0) {
    group_counts_kernel<<<static_cast<unsigned>((n + kThreads - 1) /
                                                kThreads),
                          kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(gids), n, static_cast<int32_t*>(counts),
        gcap);
  }
  return static_cast<int>(cudaGetLastError());
}
