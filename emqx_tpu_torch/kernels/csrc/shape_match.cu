// Kernel 2: tokenized topics x live shapes -> matched filter ids.
//
// Replaces `shape_match_device` and `_mix32_dev`
// (emqx_tpu/ops/shape_index.py:1108, :1225). For every (topic, shape) lane:
// the masked sum-product of the level hashes gives the combined pair
// (c1, c2); a double-hash probe of the packed table (tombstoned rows
// masked out), then of the hot overlay, finds the filter id. The result is
// SPARSE: out[b, m] is the fid matched under shape m, or -1.
//
// Bound: bytes, and latency of dependent random reads. The tables are tens
// of MB (33.5 MB packed at 1M filters), far past L1, and a hit reads one
// 16-byte row (plus one tombstone word) at a random address; the hashing
// is a few dozen integer ops per lane. Design: one thread per lane, so the
// B x M independent probe chains are all in flight at once and the card
// hides the DRAM latency by parallelism; a lane stops at its first hit,
// the probe order of the JAX `~found` chain, and only a lane that misses
// the packed table probes the hot overlay. Lanes that cannot match (wrong
// depth, dead shape, `$` topic against a root-wildcard shape) read no
// table at all.
#include "common.cuh"

namespace {

constexpr uint32_t kK1 = 0x9E3779B1u;    // shape_index.py K1_MUL
constexpr uint32_t kK2 = 0x85EBCA77u;    // K2_MUL
constexpr uint32_t kFold1 = 0xC2B2AE35u;  // FOLD1
constexpr uint32_t kFold2 = 0x27D4EB2Fu;  // FOLD2
constexpr uint32_t kSlotMul = 0x165667B1u;  // SLOT_MUL
constexpr int kSlotShift = 14;              // SLOT_SHIFT

__device__ __forceinline__ int probe(const int32_t* __restrict__ tab,
                                     uint32_t mask, uint32_t slot,
                                     uint32_t step, uint32_t c1, uint32_t c2,
                                     int sid, int probes,
                                     const uint32_t* __restrict__ tomb) {
  for (int p = 0; p < probes; ++p) {
    const uint32_t idx = (slot + static_cast<uint32_t>(p) * step) & mask;
    const int32_t* row = tab + static_cast<size_t>(idx) * 4;
    const int32_t fid = row[2];
    if (fid >= 0 && static_cast<uint32_t>(row[0]) == c1 &&
        static_cast<uint32_t>(row[1]) == c2 && row[3] == sid) {
      if (tomb == nullptr || ((tomb[idx >> 5] >> (idx & 31)) & 1u) == 0u)
        return fid;
    }
  }
  return -1;
}

__global__ void shape_match_kernel(
    const uint32_t* __restrict__ h1, const uint32_t* __restrict__ h2,
    const int32_t* __restrict__ nwords, const bool* __restrict__ dollar,
    const int32_t* __restrict__ shape_mask,
    const int32_t* __restrict__ shape_len,
    const int32_t* __restrict__ shape_flags, const int32_t* __restrict__ tab,
    long long tcap, const int32_t* __restrict__ hot, long long hcap,
    const uint32_t* __restrict__ tomb, int32_t* __restrict__ out, int B,
    int L, int M, int probes) {
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (t >= static_cast<long long>(B) * M) return;
  const int r = static_cast<int>(t / M);
  const int m = static_cast<int>(t % M);
  const int32_t plen = shape_len[m];
  const int32_t flags = shape_flags[m];
  const int32_t nw = nwords[r];
  const bool has_hash = (flags & 1) != 0;
  const bool rootwild = (flags & 2) != 0;
  const bool ok_len = has_hash ? nw >= plen : nw == plen;
  if (plen < 0 || !ok_len || (dollar[r] && rootwild)) {
    out[t] = -1;
    return;
  }
  const int32_t mask = shape_mask[m];
  const uint32_t* a = h1 + static_cast<size_t>(r) * L;
  const uint32_t* b = h2 + static_cast<size_t>(r) * L;
  uint32_t s1 = 0u, s2 = 0u;
  for (int l = 0; l < L; ++l) {
    // the JAX form shifts an int32 arithmetically: levels past 31 read
    // the sign bit
    const int bit = l < 32 ? ((mask >> l) & 1) : (mask < 0 ? 1 : 0);
    if (bit) {
      const uint32_t k = 2u * static_cast<uint32_t>(l + 1);
      s1 += a[l] * (kK1 * k + 1u);
      s2 += b[l] * (kK2 * k + 1u);
    }
  }
  const uint32_t c1 = emqx_mix32(s1 ^ (static_cast<uint32_t>(m) * kFold1));
  const uint32_t c2 = emqx_mix32(s2 ^ (static_cast<uint32_t>(m) * kFold2));
  uint32_t slot = c1 * kSlotMul;
  slot ^= slot >> kSlotShift;
  const uint32_t step = c2 | 1u;
  int fid = probe(tab, static_cast<uint32_t>(tcap - 1), slot, step, c1, c2,
                  m, probes, tomb);
  if (fid < 0)
    fid = probe(hot, static_cast<uint32_t>(hcap - 1), slot, step, c1, c2, m,
                probes, nullptr);
  out[t] = fid;
}

}  // namespace

EMQX_EXPORT int emqx_shape_match(const void* h1, const void* h2,
                                 const void* nwords, const void* dollar,
                                 const void* shape_mask,
                                 const void* shape_len,
                                 const void* shape_flags, const void* tab,
                                 long long tcap, const void* hot,
                                 long long hcap, const void* tomb, void* out,
                                 int B, int L, int M, int probes,
                                 void* stream) {
  const long long n = static_cast<long long>(B) * M;
  if (n > 0) {
    constexpr int kThreads = 256;
    shape_match_kernel<<<static_cast<unsigned>((n + kThreads - 1) / kThreads),
                         kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(h1), static_cast<const uint32_t*>(h2),
        static_cast<const int32_t*>(nwords), static_cast<const bool*>(dollar),
        static_cast<const int32_t*>(shape_mask),
        static_cast<const int32_t*>(shape_len),
        static_cast<const int32_t*>(shape_flags),
        static_cast<const int32_t*>(tab), tcap,
        static_cast<const int32_t*>(hot), hcap,
        static_cast<const uint32_t*>(tomb), static_cast<int32_t*>(out), B, L,
        M, probes);
  }
  return static_cast<int>(cudaGetLastError());
}
