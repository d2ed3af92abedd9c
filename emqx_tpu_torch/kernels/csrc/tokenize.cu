// Kernel 1: topic bytes -> per-level word-hash pairs.
//
// Replaces `tokenize_device` (emqx_tpu/ops/tokenizer.py:147). The JAX
// function computes each word's polynomial hash from prefix sums with
// inverse powers, (U[e] - U[s-1]) * P^e + P^wlen, because a TPU has no
// cheap per-byte recurrence. That value equals the per-word Horner form
// h = 1; h = h * P + c (mod 2^32) of `_poly_raw` (ops/nfa.py), which is
// what a GPU thread does best, so each row is walked once with two Horner
// accumulators and no tables.
//
// Bound: bytes. One pass reads B x MB bytes and B lengths and writes
// 2 x B x L hash words, B depths and B flags; the hash stores are most of
// them (64 of 105 bytes a row at MB = 32, L = 8). Design:
// - one thread walks one row, from registers: at MB = 32 (a storm chunk)
//   and 64 (a routed batch) on a 16-byte aligned base the whole row is
//   loaded as 16-byte vectors before the walk, in one round trip to
//   memory, and only chunks that hold live bytes are walked; any other
//   row is read a byte at a time, up to its length;
// - in a preloaded row, bytes past its length are replaced by '/' inside
//   the last live chunk, so the walk needs no length test a byte: the
//   first of them closes the last word, the rest close empty words at
//   levels past the depth (which the store zeroes) and are taken off it;
// - a finished word's raw accumulators go to the row's slots in shared
//   memory (an odd stride a row, so a warp's stores miss each other's
//   banks; words past L - 1 go to a discard slot): no register array is
//   indexed by a level chosen at run time, so nothing spills;
// - the block then writes its rows' L-word hash runs as one contiguous
//   run of words, each warp 128 contiguous bytes a store, applying the
//   finalizer (murmur3 mix of the seeded accumulator) and the zeros past
//   the depth on the way out.
// Rows deeper than L keep counting words (nwords is the true depth);
// levels at or past nwords are zero; "" is one empty word (the hash of
// the empty string); lengths are clamped to [0, MB].
// L is a template parameter for 4, 8 and 16 levels (the division of the
// store loop becomes a shift), with a generic path for any other L.
#include "common.cuh"

namespace {

constexpr uint32_t kP1 = 0x01000193u;  // ops/nfa.py P1
constexpr uint32_t kP2 = 0x00BC8F6Bu;  // ops/nfa.py P2
constexpr uint32_t kSlash = '/';
constexpr uint32_t kSlashes = 0x2F2F2F2Fu;  // '/' in every byte
constexpr int kRows = 128;               // rows (threads) a block
constexpr size_t kMaxShared = 232448;    // a block's shared memory on sm_90

// the open word's Horner accumulators and the words begun before it
struct Walk {
  uint32_t a = 1u, b = 1u;  // P^0: encodes length, "" hashes distinctly
  int w = 0;
};

// one byte: a separator stores the finished word's accumulators in slot
// min(w, L) of the row and opens the next word
__device__ __forceinline__ void step(Walk& s, uint32_t c, uint32_t* s1,
                                     uint32_t* s2, int L) {
  const bool sep = c == kSlash;
  if (sep) {
    const int slot = s.w < L ? s.w : L;
    s1[slot] = s.a;
    s2[slot] = s.b;
  }
  s.w += sep;
  s.a = sep ? 1u : s.a * kP1 + c;
  s.b = sep ? 1u : s.b * kP2 + c;
}

// four bytes of a 16-byte chunk, `live` of them real (the rest read '/')
__device__ __forceinline__ void step4(Walk& s, uint32_t x, int live,
                                      uint32_t* s1, uint32_t* s2, int L) {
  if (live < 4) {
    const uint32_t keep = live <= 0 ? 0u : 0xFFFFFFFFu >> (32 - 8 * live);
    x = (x & keep) | (kSlashes & ~keep);
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) step(s, (x >> (8 * k)) & 0xFFu, s1, s2, L);
}

// one 16-byte chunk, `live` of its bytes real
__device__ __forceinline__ void walk16(Walk& s, const uint4& v, int live,
                                       uint32_t* s1, uint32_t* s2, int L) {
  step4(s, v.x, live, s1, s2, L);
  step4(s, v.y, live - 4, s1, s2, L);
  step4(s, v.z, live - 8, s1, s2, L);
  step4(s, v.w, live - 12, s1, s2, L);
}

// kChunks > 0: MB = 16 x kChunks on a 16-byte aligned base, every chunk of
// the row loaded before the walk (one round trip to memory, not one a
// chunk); 0: any MB and base, bytes
template <int kL, int kChunks>
__global__ void __launch_bounds__(kRows) tokenize_kernel(
    const uint8_t* __restrict__ bytes, const int32_t* __restrict__ lengths,
    uint32_t* __restrict__ h1, uint32_t* __restrict__ h2,
    int32_t* __restrict__ nwords, bool* __restrict__ is_dollar, int B,
    int MB, int L_arg, uint32_t seed1, uint32_t seed2) {
  const int L = kL > 0 ? kL : L_arg;
  const int S = (L + 1) | 1;  // L levels + the discard slot, odd
  extern __shared__ uint32_t smem[];
  uint32_t* s1 = smem;
  uint32_t* s2 = s1 + blockDim.x * S;
  int* snw = reinterpret_cast<int*>(s2 + blockDim.x * S);
  const int t = threadIdx.x;
  const int r0 = blockIdx.x * blockDim.x;
  const int r = r0 + t;
  if (r < B) {
    const uint8_t* row = bytes + static_cast<size_t>(r) * MB;
    const uint4* v16 = reinterpret_cast<const uint4*>(row);
    uint4 v[kChunks > 0 ? kChunks : 1];
#pragma unroll
    for (int q = 0; q < kChunks; ++q) v[q] = __ldg(v16 + q);
    const int len = lengths[r];
    const int n = len < 0 ? 0 : (len > MB ? MB : len);
    uint32_t* my1 = s1 + t * S;
    uint32_t* my2 = s2 + t * S;
    Walk s;
    int pad = 0;  // '/' bytes read past n
    bool dollar = false;
    if (kChunks > 0) {
#pragma unroll
      for (int q = 0; q < kChunks; ++q) {
        if (16 * q < n) walk16(s, v[q], n - 16 * q, my1, my2, L);
      }
      dollar = n > 0 && (v[0].x & 0xFFu) == '$';
      pad = (16 - n % 16) % 16;
    } else {
      for (int j = 0; j < n; ++j) step(s, __ldg(row + j), my1, my2, L);
      dollar = n > 0 && __ldg(row) == '$';
    }
    // the last word (or, after '/' padding, an empty one past the depth)
    const int slot = s.w < L ? s.w : L;
    my1[slot] = s.a;
    my2[slot] = s.b;
    const int depth = s.w - pad + 1;
    snw[t] = depth;
    nwords[r] = depth;
    is_dollar[r] = dollar;
  }
  __syncthreads();
  const int rows = min(static_cast<int>(blockDim.x), B - r0);
  const int total = rows * L;
  uint32_t* o1 = h1 + static_cast<size_t>(r0) * L;
  uint32_t* o2 = h2 + static_cast<size_t>(r0) * L;
  for (int f = t; f < total; f += blockDim.x) {
    const int i = f / L;
    const int lvl = f - i * L;
    uint32_t x1 = 0u, x2 = 0u;
    if (lvl < snw[i]) {
      x1 = emqx_mix32(s1[i * S + lvl] ^ seed1);
      x2 = emqx_mix32(s2[i * S + lvl] ^ seed2);
    }
    o1[f] = x1;
    o2[f] = x2;
  }
}

// one call's arguments, as the C launcher takes them
struct Call {
  const void* bytes;
  const void* lengths;
  void* h1;
  void* h2;
  void* nwords;
  void* is_dollar;
  int B, MB, L;
  uint32_t seed1, seed2;
  bool aligned;  // the bytes' base on a 16-byte boundary
  cudaStream_t stream;
};

template <int kL, int kChunks>
cudaError_t launch(const Call& c) {
  const size_t S = static_cast<size_t>((c.L + 1) | 1);
  int rows = kRows;
  while (rows > 32 && rows * (2 * S + 1) * 4 > kMaxShared) rows /= 2;
  const size_t shared = rows * (2 * S + 1) * 4;
  if (shared > kMaxShared) return cudaErrorInvalidValue;
  if (shared > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        tokenize_kernel<kL, kChunks>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(shared));
    if (e != cudaSuccess) return e;
  }
  tokenize_kernel<kL, kChunks>
      <<<(c.B + rows - 1) / rows, rows, shared, c.stream>>>(
          static_cast<const uint8_t*>(c.bytes),
          static_cast<const int32_t*>(c.lengths), static_cast<uint32_t*>(c.h1),
          static_cast<uint32_t*>(c.h2), static_cast<int32_t*>(c.nwords),
          static_cast<bool*>(c.is_dollar), c.B, c.MB, c.L, c.seed1, c.seed2);
  return cudaGetLastError();
}

// the row width's instance: whole rows preloaded at 32 and 64 bytes on an
// aligned base, bytes otherwise
template <int kL>
cudaError_t launch_width(const Call& c) {
  switch (c.aligned ? c.MB : 0) {
    case 32:
      return launch<kL, 2>(c);
    case 64:
      return launch<kL, 4>(c);
    default:
      return launch<kL, 0>(c);
  }
}

}  // namespace

EMQX_EXPORT int emqx_tokenize(const void* bytes, const void* lengths,
                              void* h1, void* h2, void* nwords,
                              void* is_dollar, int B, int MB, int L,
                              uint32_t seed1, uint32_t seed2, void* stream) {
  if (B <= 0) return static_cast<int>(cudaGetLastError());
  const bool aligned = reinterpret_cast<uintptr_t>(bytes) % 16 == 0;
  const Call c{bytes, lengths, h1,    h2,    nwords,  is_dollar,
               B,     MB,      L,     seed1, seed2,   aligned,
               static_cast<cudaStream_t>(stream)};
  switch (L) {
    case 4:
      return static_cast<int>(launch_width<4>(c));
    case 8:
      return static_cast<int>(launch_width<8>(c));
    case 16:
      return static_cast<int>(launch_width<16>(c));
    default:
      return static_cast<int>(launch_width<0>(c));
  }
}
