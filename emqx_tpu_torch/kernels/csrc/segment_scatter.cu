// Kernel 7: O(delta) replay of a table's op-log suffix onto its device
// mirror, every touched array in one call of two short launches.
//
// Replaces `segment_scatter_impl` (emqx_tpu/ops/segments.py:73):
// flats[a][idx] = val for every (array a, flat index, value) entry of the
// suffix, the last write in program order winning where one slot is
// written more than once. The wrapper hands over ONE int64 buffer
// [3A + 1 + n + ceil(n / 2)]: the A arrays' base pointers, their A element
// widths in bytes, A + 1 entry offsets (array a's entries are offsets[a]
// .. offsets[a + 1]), then the n flat indices and the n values (the int32
// bits of each, two to an int64 word), all in program order and NOT
// reduced to one write per slot. A mirrored array holds 4-byte words
// (int32, uint32 bits in an int32 tensor, or float32 bits: the semantic
// table's lanes), 2-byte words (the bfloat16 bits of a quantized semantic
// table's vectors, rounded on the host) or bytes (the retained topic
// chunks, uint8); a narrower array takes the value's low 16 bits or low
// byte. Values travel as bits, so no float is converted here.
//
// Last-write-wins, deterministically and without a sort, in two launches:
// (a) `scatter_claim_kernel`: each entry claims its key (array, index) in
//     an open-addressing hash table of cap = 2 next_pow2(n) slots with
//     atomicCAS (linear probing, never full: at most n keys) and raises
//     the slot's position to its own program-order position + 1 with
//     atomicMax; it records the slot it took. The table is scratch the
//     wrapper allocates; this launcher zeroes it with cudaMemsetAsync.
// (b) `scatter_store_kernel`: an entry stores its value only if its
//     position is its slot's maximum, so exactly one entry, the last,
//     writes each element, whatever order the threads ran in. Two threads
//     may still store distinct bytes of one 4-byte word: CUDA's byte and
//     2-byte stores never write the neighbouring bytes, so neither store
//     is lost.
// The wrapper scatters into fresh clones, so a snapshot a caller still
// holds never changes under it (the JAX function's outputs are fresh
// buffers too). Unlike the JAX version, nothing is padded to a power of
// two: there is no compiled program whose shape the delta would have to
// match.
//
// Bound: bytes. Each entry reads 12 bytes, claims and tests one 12-byte
// table slot and writes one 4-, 2- or 1-byte element at a random address;
// the wrapper's clones (each touched array read and written once) are
// most of the bytes of a call. Design: one thread per entry in each pass.
#include "common.cuh"

namespace {

// splitmix64's finalizer: spreads keys whose indices are consecutive
__device__ __forceinline__ unsigned long long mix64(unsigned long long x) {
  x ^= x >> 30;
  x *= 0xBF58476D1CE4E5B9ull;
  x ^= x >> 27;
  x *= 0x94D049BB133111EBull;
  x ^= x >> 31;
  return x;
}

// the array of entry t: the last a with offsets[a] <= t (A is small)
__device__ __forceinline__ int array_of(const long long* off, int A,
                                        long long t) {
  int a = 0;
  while (a + 1 < A && off[a + 1] <= t) ++a;
  return a;
}

__global__ void scatter_claim_kernel(const long long* __restrict__ buf,
                                     int A, long long n,
                                     unsigned long long* __restrict__ keys,
                                     int* __restrict__ pos,
                                     int* __restrict__ slot,
                                     unsigned long long mask) {
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (t >= n) return;
  const long long* idx = buf + 3 * A + 1;
  const int a = array_of(buf + 2 * A, A, t);
  // never 0, the empty slot's key: index < 2^40, a < 2^23
  const unsigned long long key =
      ((static_cast<unsigned long long>(a) << 40) |
       static_cast<unsigned long long>(idx[t])) + 1ull;
  unsigned long long h = mix64(key) & mask;
  for (;;) {
    const unsigned long long prev = atomicCAS(keys + h, 0ull, key);
    if (prev == 0ull || prev == key) break;
    h = (h + 1) & mask;
  }
  atomicMax(pos + h, static_cast<int>(t + 1));
  slot[t] = static_cast<int>(h);
}

__global__ void scatter_store_kernel(const long long* __restrict__ buf,
                                     int A, long long n,
                                     const int* __restrict__ pos,
                                     const int* __restrict__ slot) {
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (t >= n) return;
  if (pos[slot[t]] != static_cast<int>(t + 1)) return;  // a later write wins
  const long long* idx = buf + 3 * A + 1;
  const int* bits = reinterpret_cast<const int*>(idx + n);
  const int a = array_of(buf + 2 * A, A, t);
  const long long i = idx[t];
  const int val = bits[t];
  const long long width = buf[A + a];
  if (width == 1) {
    reinterpret_cast<uint8_t*>(buf[a])[i] = static_cast<uint8_t>(val);
  } else if (width == 2) {
    reinterpret_cast<uint16_t*>(buf[a])[i] = static_cast<uint16_t>(val);
  } else {
    reinterpret_cast<int32_t*>(buf[a])[i] = val;
  }
}

constexpr int kThreads = 256;

unsigned blocks(long long n) {
  return static_cast<unsigned>((n + kThreads - 1) / kThreads);
}

// table: cap keys (8 B each), cap positions (4 B), n slots (4 B)
unsigned long long* table_keys(void* table) {
  return static_cast<unsigned long long*>(table);
}
int* table_pos(void* table, long long cap) {
  return reinterpret_cast<int*>(table_keys(table) + cap);
}
int* table_slot(void* table, long long cap) {
  return table_pos(table, cap) + cap;
}

}  // namespace

EMQX_EXPORT int emqx_scatter_claim(const void* buf, int A, long long n,
                                   void* table, long long cap, void* stream) {
  if (n > 0) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const cudaError_t rc = cudaMemsetAsync(table, 0, cap * 12, st);
    if (rc != cudaSuccess) return static_cast<int>(rc);
    scatter_claim_kernel<<<blocks(n), kThreads, 0, st>>>(
        static_cast<const long long*>(buf), A, n, table_keys(table),
        table_pos(table, cap), table_slot(table, cap),
        static_cast<unsigned long long>(cap - 1));
  }
  return static_cast<int>(cudaGetLastError());
}

EMQX_EXPORT int emqx_scatter_store(const void* buf, int A, long long n,
                                   void* table, long long cap, void* stream) {
  if (n > 0) {
    scatter_store_kernel<<<blocks(n), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        static_cast<const long long*>(buf), A, n, table_pos(table, cap),
        table_slot(table, cap));
  }
  return static_cast<int>(cudaGetLastError());
}
