// Kernel 1: topic bytes -> per-level word-hash pairs.
//
// Replaces `tokenize_device` (emqx_tpu/ops/tokenizer.py:147). The JAX
// function computes each word's polynomial hash from prefix sums with
// inverse powers, (U[e] - U[s-1]) * P^e + P^wlen, because a TPU has no
// cheap per-byte recurrence. That value equals the per-word Horner form
// h = 1; h = h * P + c (mod 2^32) of `_poly_raw` (ops/nfa.py), which is
// what a GPU thread does best, so this kernel walks each row once with two
// Horner accumulators and no tables.
//
// Bound: bytes. One pass reads B x MB bytes and writes 2 x B x L words;
// the arithmetic is a few integer ops per byte. Design: one thread per
// row, so no thread waits on another; the row's 64 bytes sit in one or
// two L1 lines. Rows deeper than L keep counting words (nwords is the
// true depth) but write no hash past level L-1; levels at or past nwords
// are zero. "" is one empty word (hash of the empty string).
//
// Precondition (as for the JAX function): lengths <= MB, which
// encode_topics guarantees by truncating; a longer length reads MB bytes.
#include "common.cuh"

namespace {

constexpr uint32_t kP1 = 0x01000193u;  // ops/nfa.py P1
constexpr uint32_t kP2 = 0x00BC8F6Bu;  // ops/nfa.py P2

__global__ void tokenize_kernel(const uint8_t* __restrict__ bytes,
                                const int32_t* __restrict__ lengths,
                                uint32_t* __restrict__ h1,
                                uint32_t* __restrict__ h2,
                                int32_t* __restrict__ nwords,
                                bool* __restrict__ is_dollar, int B, int MB,
                                int L, uint32_t seed1, uint32_t seed2) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= B) return;
  const uint8_t* row = bytes + static_cast<size_t>(r) * MB;
  const int len = lengths[r];
  const int n = len < 0 ? 0 : (len > MB ? MB : len);
  uint32_t* o1 = h1 + static_cast<size_t>(r) * L;
  uint32_t* o2 = h2 + static_cast<size_t>(r) * L;
  uint32_t a = 1u, b = 1u;  // P^0: encodes length, "" hashes distinctly
  int w = 0;
  for (int j = 0; j < n; ++j) {
    const uint32_t c = row[j];
    if (c == '/') {
      if (w < L) {
        o1[w] = emqx_mix32(a ^ seed1);
        o2[w] = emqx_mix32(b ^ seed2);
      }
      ++w;
      a = 1u;
      b = 1u;
    } else {
      a = a * kP1 + c;
      b = b * kP2 + c;
    }
  }
  if (w < L) {
    o1[w] = emqx_mix32(a ^ seed1);
    o2[w] = emqx_mix32(b ^ seed2);
  }
  for (int k = w + 1; k < L; ++k) {
    o1[k] = 0u;
    o2[k] = 0u;
  }
  nwords[r] = w + 1;
  is_dollar[r] = len > 0 && row[0] == '$';
}

}  // namespace

EMQX_EXPORT int emqx_tokenize(const void* bytes, const void* lengths,
                              void* h1, void* h2, void* nwords,
                              void* is_dollar, int B, int MB, int L,
                              uint32_t seed1, uint32_t seed2, void* stream) {
  if (B > 0) {
    constexpr int kThreads = 128;
    tokenize_kernel<<<(B + kThreads - 1) / kThreads, kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(bytes),
        static_cast<const int32_t*>(lengths), static_cast<uint32_t*>(h1),
        static_cast<uint32_t*>(h2), static_cast<int32_t*>(nwords),
        static_cast<bool*>(is_dollar), B, MB, L, seed1, seed2);
  }
  return static_cast<int>(cudaGetLastError());
}
