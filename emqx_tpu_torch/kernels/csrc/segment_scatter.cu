// Kernel 7: O(delta) replay of a table's op-log suffix onto its device
// mirror, every touched array in one launch.
//
// Replaces `segment_scatter_impl` (emqx_tpu/ops/segments.py:73):
// flats[a][idx] = val for every (array a, flat index, value) entry of the
// suffix. The wrapper hands over ONE int64 buffer [2A + 3n]: the A arrays'
// base pointers, their A element widths in bytes, then n array ids, n flat
// indices and n values (the int32 bits of each value, sign-extended). A
// mirrored array holds 4-byte words (int32, uint32 bits in an int32
// tensor, or float32 bits: the semantic table's lanes), 2-byte words (the
// bfloat16 bits of a quantized semantic table's vectors, rounded on the
// host) or bytes (the retained topic chunks, uint8); a narrower array
// takes the value's low 16 bits or low byte. Values travel as bits, so no
// float is converted here. The host has already kept the last write per
// slot, so no two entries touch one element and the writes need no
// atomics: two threads may store distinct bytes of one 4-byte word, and
// CUDA's byte and 2-byte stores never write the neighbouring bytes, so
// neither store is lost. The wrapper scatters into fresh clones, so a snapshot a caller
// still holds never changes under it (the JAX function's outputs are fresh
// buffers too). Unlike the JAX version, nothing is padded to a power of
// two: there is no compiled program whose shape the delta would have to
// match.
//
// Bound: bytes. Each entry reads 24 bytes and writes one 4-, 2- or 1-byte
// element at a random address; no arithmetic. Design: one thread per
// entry.
#include "common.cuh"

namespace {

__global__ void segment_scatter_kernel(const long long* __restrict__ buf,
                                       int A, long long n) {
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (t >= n) return;
  const long long* ent = buf + 2 * A;
  const long long a = ent[t];
  const long long idx = ent[n + t];
  const long long val = ent[2 * n + t];
  const long long width = buf[A + a];
  if (width == 1) {
    reinterpret_cast<uint8_t*>(buf[a])[idx] = static_cast<uint8_t>(val);
  } else if (width == 2) {
    reinterpret_cast<uint16_t*>(buf[a])[idx] = static_cast<uint16_t>(val);
  } else {
    reinterpret_cast<int32_t*>(buf[a])[idx] = static_cast<int32_t>(val);
  }
}

}  // namespace

EMQX_EXPORT int emqx_segment_scatter(const void* buf, int A, long long n,
                                     void* stream) {
  if (n > 0) {
    constexpr int kThreads = 256;
    segment_scatter_kernel<<<static_cast<unsigned>((n + kThreads - 1) /
                                                   kThreads),
                             kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const long long*>(buf), A, n);
  }
  return static_cast<int>(cudaGetLastError());
}
