// Kernel 5: per-level word-hash pairs -> residual-NFA symbol ids.
//
// Replaces `vocab_lookup_device` (emqx_tpu/ops/tokenizer.py:294). For
// every (topic, level) lane: slot hash h = mix(h1 * VOCAB_H_MUL), then up
// to `probes` linear probes at (h + p) & (V - 1); the first slot holding
// the same (h1, h2) pair and a live symbol (vocab_sym >= 0, so a tombstone
// of -3 never hits) gives the lane's symbol, else -1 (out of vocabulary).
// Every lane is looked up, those past a row's depth included (their
// hashes are 0), exactly as the JAX function does.
//
// Bound: bytes. Each lane reads its two hash words and writes one symbol
// (20 bytes); a hit adds one 12-byte vocab slot at a random address, and
// the slot hash is a handful of integer ops. Design: one thread per lane,
// so the B x L independent probe chains are in flight together, and a
// lane stops at its first hit (the JAX `~found` chain keeps the first).
#include "common.cuh"

namespace {

constexpr uint32_t kVocabMul = 0xC2B2AE3Du;  // nfa.py VOCAB_H_MUL
constexpr int kVocabShift = 13;              // VOCAB_H_SHIFT

__global__ void vocab_lookup_kernel(const uint32_t* __restrict__ h1,
                                    const uint32_t* __restrict__ h2,
                                    const uint32_t* __restrict__ vocab_h1,
                                    const uint32_t* __restrict__ vocab_h2,
                                    const int32_t* __restrict__ vocab_sym,
                                    uint32_t vmask, int32_t* __restrict__ sym,
                                    long long n, int probes) {
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (t >= n) return;
  const uint32_t a = h1[t];
  const uint32_t b = h2[t];
  uint32_t h = a * kVocabMul;
  h ^= h >> kVocabShift;
  int32_t out = -1;
  for (int p = 0; p < probes; ++p) {
    const uint32_t idx = (h + static_cast<uint32_t>(p)) & vmask;
    const int32_t s = vocab_sym[idx];
    if (s >= 0 && vocab_h1[idx] == a && vocab_h2[idx] == b) {
      out = s;
      break;
    }
  }
  sym[t] = out;
}

}  // namespace

EMQX_EXPORT int emqx_vocab_lookup(const void* h1, const void* h2,
                                  const void* vocab_h1, const void* vocab_h2,
                                  const void* vocab_sym, long long V,
                                  void* sym, long long n, int probes,
                                  void* stream) {
  if (n > 0) {
    constexpr int kThreads = 256;
    vocab_lookup_kernel<<<static_cast<unsigned>((n + kThreads - 1) / kThreads),
                          kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(h1), static_cast<const uint32_t*>(h2),
        static_cast<const uint32_t*>(vocab_h1),
        static_cast<const uint32_t*>(vocab_h2),
        static_cast<const int32_t*>(vocab_sym),
        static_cast<uint32_t>(V - 1), static_cast<int32_t*>(sym), n, probes);
  }
  return static_cast<int>(cudaGetLastError());
}
