// Kernels 11a and 11b: the two passes of a retained replay storm that the
// serving kernels do not already cover.
//
// A storm matches chunks of stored retained topics (uint8 [N, MB] rows,
// zero padded) against the storm's filter table with the serving kernels
// (tokenize, shape_match, and the residual lane). What the JAX step
// `_retained_step` (emqx_tpu/models/retained_index.py:55) and
// `fused_route_retained_step_impl` (emqx_tpu/models/router_model.py:573)
// add around them is computed here:
//
// - row_lengths: replaces `jnp.sum((bm != 0).astype(jnp.int32), axis=1)`
//   (retained_index.py:69, router_model.py:653). A retained topic holds no
//   NUL byte, so its length is the count of nonzero bytes of its row; a
//   padding or removed row counts 0.
// - narrow_i16: replaces `m.astype(jnp.int16)` (retained_index.py:82,
//   router_model.py:666): the storm's [N, lanes] int32 match matrix to
//   int16 when every filter id fits, which halves the readback. A value
//   keeps its low 16 bits, as XLA's and PyTorch's conversions do.
//
// Bound: bytes, both. row_lengths reads N x MB bytes and writes 4N;
// narrow_i16 reads 4 and writes 2 bytes per element; a few integer ops per
// byte. Design: row_lengths runs one thread per row and reads the row as
// 4-byte words where MB and the base address allow (a word's nonzero
// bytes counted with one carry-free mask and a popcount); narrow_i16 runs
// 8 elements a thread: two 16-byte loads and one 16-byte store (each pair
// of low halves packed with one byte permute), so a warp reads 1,024
// contiguous bytes and writes 512; a count that is not a multiple of 8, or
// a base off a 16-byte boundary, takes the same thread's scalar tail.
#include "common.cuh"

namespace {

// the number of nonzero bytes of w: bit 7 of each byte of
// ((w & 0x7F..) + 0x7F..) is set when the byte's low 7 bits are nonzero
// (no carry crosses a byte); or-ing w adds bytes whose top bit is set
__device__ __forceinline__ int nonzero_bytes(uint32_t w) {
  const uint32_t t = ((w & 0x7F7F7F7Fu) + 0x7F7F7F7Fu) | w;
  return __popc(t & 0x80808080u);
}

__global__ void row_lengths_kernel(const uint8_t* __restrict__ bytes,
                                   int32_t* __restrict__ out, long long N,
                                   int MB) {
  const long long r = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (r >= N) return;
  const uint8_t* row = bytes + r * MB;
  int n = 0;
  if (((reinterpret_cast<uintptr_t>(bytes) | static_cast<uintptr_t>(MB)) &
       3u) == 0) {
    const uint32_t* words = reinterpret_cast<const uint32_t*>(row);
    for (int j = 0; j < (MB >> 2); ++j) n += nonzero_bytes(words[j]);
  } else {
    for (int j = 0; j < MB; ++j) n += row[j] != 0;
  }
  out[r] = n;
}

constexpr int kNarrowPerThread = 8;

__global__ void narrow_i16_kernel(const int32_t* __restrict__ in,
                                  int16_t* __restrict__ out, long long n,
                                  bool vec) {
  const long long e =
      kNarrowPerThread *
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x);
  if (e >= n) return;
  if (vec && e + kNarrowPerThread <= n) {
    const int4 a = __ldg(reinterpret_cast<const int4*>(in + e));
    const int4 b = __ldg(reinterpret_cast<const int4*>(in + e + 4));
    // bytes 0-1 of the first word, then bytes 0-1 of the second
    const int4 r = make_int4(__byte_perm(a.x, a.y, 0x5410),
                             __byte_perm(a.z, a.w, 0x5410),
                             __byte_perm(b.x, b.y, 0x5410),
                             __byte_perm(b.z, b.w, 0x5410));
    *reinterpret_cast<int4*>(out + e) = r;
    return;
  }
  const long long end = min(e + kNarrowPerThread, n);
  for (long long i = e; i < end; ++i) out[i] = static_cast<int16_t>(in[i]);
}

constexpr int kThreads = 256;

unsigned blocks_for(long long n) {
  return static_cast<unsigned>((n + kThreads - 1) / kThreads);
}

}  // namespace

EMQX_EXPORT int emqx_row_lengths(const void* bytes, void* out, long long N,
                                 int MB, void* stream) {
  if (N > 0) {
    row_lengths_kernel<<<blocks_for(N), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(bytes), static_cast<int32_t*>(out), N, MB);
  }
  return static_cast<int>(cudaGetLastError());
}

EMQX_EXPORT int emqx_narrow_i16(const void* in, void* out, long long n,
                                void* stream) {
  if (n > 0) {
    const bool vec = ((reinterpret_cast<uintptr_t>(in) |
                       reinterpret_cast<uintptr_t>(out)) &
                      15u) == 0;
    narrow_i16_kernel<<<blocks_for((n + kNarrowPerThread - 1) /
                                   kNarrowPerThread),
                        kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(in), static_cast<int16_t*>(out), n, vec);
  }
  return static_cast<int>(cudaGetLastError());
}
