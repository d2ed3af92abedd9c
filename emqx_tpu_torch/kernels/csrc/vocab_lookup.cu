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
// (12 bytes); a lane found adds one 12-byte vocab slot, one not found a
// 4-byte symbol word. On the card the reads are random 4-byte words, each
// a 32-byte sector of L2 (the table sits there at mixed_10m's V = 65,536)
// or L1 (plus_100k's V = 1,024): three sectors a lane and probe.
//
// Design: one thread a lane, one round trip a probe. A probe's three words
// (vocab_sym, vocab_h1, vocab_h2 at one slot) are read together through
// the read-only path, not one behind the other, so a lane found at its
// first slot (most lanes) costs the hash pair's read and one more. A
// chain ends at its first never-written slot (vocab_sym == -1): the NFA
// builder inserts a word at the first -1 or tombstone slot of its chain,
// a delete leaves a tombstone and a rehash re-places every word, so no
// live word sits behind a -1 within `probes` slots (the CPU tests walk
// every chain of both packages' builders through churn). A missing lane,
// and every lane past a row's depth, thus stops within a probe or two
// instead of walking all eight. Reading a window of slots at once, a team
// of lanes a lookup, or the symbol words first were slower on the card:
// each adds sector reads, which bound the kernel (PERF.md, row 3).
#include "common.cuh"

namespace {

constexpr uint32_t kVocabMul = 0xC2B2AE3Du;  // nfa.py VOCAB_H_MUL
constexpr int kVocabShift = 13;              // VOCAB_H_SHIFT
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
    vocab_lookup_kernel(const uint32_t* __restrict__ h1,
                        const uint32_t* __restrict__ h2,
                        const uint32_t* __restrict__ vocab_h1,
                        const uint32_t* __restrict__ vocab_h2,
                        const int32_t* __restrict__ vocab_sym, uint32_t vmask,
                        int32_t* __restrict__ sym, long long n, int probes) {
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (t >= n) return;
  const uint32_t a = __ldg(h1 + t);
  const uint32_t b = __ldg(h2 + t);
  uint32_t h = a * kVocabMul;
  h ^= h >> kVocabShift;
  int32_t out = -1;
  for (int p = 0; p < probes; ++p) {
    const uint32_t idx = (h + static_cast<uint32_t>(p)) & vmask;
    const int32_t s = __ldg(vocab_sym + idx);
    const uint32_t x = __ldg(vocab_h1 + idx);
    const uint32_t y = __ldg(vocab_h2 + idx);
    if (s >= 0 && x == a && y == b) {
      out = s;
      break;
    }
    if (s == -1) break;  // never written: nothing live lies further on
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
