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
// to hundreds of MB (33.5 MB packed at 1M filters), and most lanes that
// pass the depth test miss (958,464 of 1,048,576 in a retained storm
// chunk), so a lane's cost is the length of its probe chains. Design:
// - one thread a lane, so the B x M chains are all in flight at once: a
//   block's x threads are a row's shapes (up to 256), its y threads rows,
//   so out is written row-major and coalesced and no thread divides its
//   index by M;
// - the row's level hashes arrive as 16-byte vectors (only the groups of
//   four levels that the shape's mask touches) when L % 4 == 0 and h1/h2
//   are 16-byte aligned, else as words; the lanes of one row sit in one
//   warp when M is large and read the same addresses, one request a warp;
// - a probed row is one 16-byte read-only load (c1, c2, fid, sid), and a
//   chain ends at its first never-written row (fid -1): the host tables
//   never place a live key behind one (`_build_table`'s probe rounds and
//   kicks, `_place_hot` and `_bulk_place_hot` take the first free slot;
//   removals only tombstone; slots return to -1 only in a rebuild that
//   places everything again; `tests/test_torch_kernels.py` walks every
//   live key's chain), so at the tables' load of at most one half a miss
//   reads about two rows instead of `probes`;
// - the tombstone word is read only on a hit; only a lane that misses the
//   packed table probes the hot overlay; lanes that cannot match (wrong
//   depth, dead shape, `$` topic against a root-wildcard shape) read no
//   table at all.
// L is a template parameter for 4, 8 and 16 levels, with a generic path.
#include "common.cuh"

namespace {

constexpr uint32_t kK1 = 0x9E3779B1u;    // shape_index.py K1_MUL
constexpr uint32_t kK2 = 0x85EBCA77u;    // K2_MUL
constexpr uint32_t kFold1 = 0xC2B2AE35u;  // FOLD1
constexpr uint32_t kFold2 = 0x27D4EB2Fu;  // FOLD2
constexpr uint32_t kSlotMul = 0x165667B1u;  // SLOT_MUL
constexpr int kSlotShift = 14;              // SLOT_SHIFT
constexpr int kThreads = 256;

// level l's bit of a shape mask: the JAX form shifts an int32
// arithmetically, so levels past 31 read the sign bit
__device__ __forceinline__ bool level_bit(int32_t mask, int l) {
  return l < 32 ? ((mask >> l) & 1) != 0 : mask < 0;
}

__device__ __forceinline__ void add_level(uint32_t& s1, uint32_t& s2,
                                          uint32_t a, uint32_t b, int l,
                                          bool on) {
  const uint32_t k = 2u * static_cast<uint32_t>(l + 1);
  s1 += on ? a * (kK1 * k + 1u) : 0u;
  s2 += on ? b * (kK2 * k + 1u) : 0u;
}

// first live row of (c1, c2, sid) along the chain, or -1; a never-written
// row (fid -1) ends the chain
__device__ __forceinline__ int probe(const int32_t* __restrict__ tab,
                                     bool vec, uint32_t mask, uint32_t slot,
                                     uint32_t step, uint32_t c1, uint32_t c2,
                                     int sid, int probes,
                                     const uint32_t* __restrict__ tomb) {
  for (int p = 0; p < probes; ++p) {
    const uint32_t idx = (slot + static_cast<uint32_t>(p) * step) & mask;
    const int32_t* at = tab + static_cast<size_t>(idx) * 4;
    int4 row;
    if (vec) {
      row = __ldg(reinterpret_cast<const int4*>(at));
    } else {
      row = make_int4(__ldg(at), __ldg(at + 1), __ldg(at + 2), __ldg(at + 3));
    }
    if (row.z == -1) return -1;
    if (row.z >= 0 && static_cast<uint32_t>(row.x) == c1 &&
        static_cast<uint32_t>(row.y) == c2 && row.w == sid) {
      if (tomb == nullptr || ((__ldg(tomb + (idx >> 5)) >> (idx & 31)) & 1u) == 0u)
        return row.z;
    }
  }
  return -1;
}

template <int kL>
__global__ void __launch_bounds__(kThreads) shape_match_kernel(
    const uint32_t* __restrict__ h1, const uint32_t* __restrict__ h2,
    const int32_t* __restrict__ nwords, const bool* __restrict__ dollar,
    const int32_t* __restrict__ shape_mask,
    const int32_t* __restrict__ shape_len,
    const int32_t* __restrict__ shape_flags, const int32_t* __restrict__ tab,
    long long tcap, const int32_t* __restrict__ hot, long long hcap,
    const uint32_t* __restrict__ tomb, int32_t* __restrict__ out, int B,
    int L_arg, int M, int probes, bool vec_h, bool vec_tab) {
  const int L = kL > 0 ? kL : L_arg;
  const int m = blockIdx.y * blockDim.x + threadIdx.x;
  const int r = blockIdx.x * blockDim.y + threadIdx.y;
  if (m >= M || r >= B) return;
  const size_t t = static_cast<size_t>(r) * M + m;
  const int32_t plen = __ldg(shape_len + m);
  const int32_t flags = __ldg(shape_flags + m);
  const int32_t nw = __ldg(nwords + r);
  const bool has_hash = (flags & 1) != 0;
  const bool rootwild = (flags & 2) != 0;
  const bool ok_len = has_hash ? nw >= plen : nw == plen;
  if (plen < 0 || !ok_len || (rootwild && dollar[r])) {
    out[t] = -1;
    return;
  }
  const int32_t mask = __ldg(shape_mask + m);
  const uint32_t* a = h1 + static_cast<size_t>(r) * L;
  const uint32_t* b = h2 + static_cast<size_t>(r) * L;
  uint32_t s1 = 0u, s2 = 0u;
  if (kL > 0 && vec_h) {
#pragma unroll
    for (int g = 0; g < kL / 4; ++g) {
      if (((mask >> (4 * g)) & 0xF) == 0) continue;  // no level of the group
      const uint4 va = __ldg(reinterpret_cast<const uint4*>(a) + g);
      const uint4 vb = __ldg(reinterpret_cast<const uint4*>(b) + g);
      add_level(s1, s2, va.x, vb.x, 4 * g, level_bit(mask, 4 * g));
      add_level(s1, s2, va.y, vb.y, 4 * g + 1, level_bit(mask, 4 * g + 1));
      add_level(s1, s2, va.z, vb.z, 4 * g + 2, level_bit(mask, 4 * g + 2));
      add_level(s1, s2, va.w, vb.w, 4 * g + 3, level_bit(mask, 4 * g + 3));
    }
  } else {
#pragma unroll 4
    for (int l = 0; l < L; ++l) {
      if (level_bit(mask, l)) add_level(s1, s2, __ldg(a + l), __ldg(b + l), l, true);
    }
  }
  const uint32_t c1 = emqx_mix32(s1 ^ (static_cast<uint32_t>(m) * kFold1));
  const uint32_t c2 = emqx_mix32(s2 ^ (static_cast<uint32_t>(m) * kFold2));
  uint32_t slot = c1 * kSlotMul;
  slot ^= slot >> kSlotShift;
  const uint32_t step = c2 | 1u;
  int fid = probe(tab, vec_tab, static_cast<uint32_t>(tcap - 1), slot, step,
                  c1, c2, m, probes, tomb);
  if (fid < 0)
    fid = probe(hot, vec_tab, static_cast<uint32_t>(hcap - 1), slot, step, c1,
                c2, m, probes, nullptr);
  out[t] = fid;
}

// one call's arguments, as the C launcher takes them
struct Call {
  const void *h1, *h2, *nwords, *dollar, *shape_mask, *shape_len,
      *shape_flags, *tab;
  long long tcap;
  const void* hot;
  long long hcap;
  const void* tomb;
  void* out;
  int B, L, M, probes;
  cudaStream_t stream;
};

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <int kL>
void launch(const Call& c) {
  const bool vec_h = c.L % 4 == 0 && aligned16(c.h1) && aligned16(c.h2);
  const bool vec_tab = aligned16(c.tab) && aligned16(c.hot);
  // x: up to 256 shapes of a row; y: the rows of a block
  const int mx = c.M < kThreads ? c.M : kThreads;
  const int ry = kThreads / mx;
  const dim3 block(mx, ry);
  const dim3 grid((c.B + ry - 1) / ry, (c.M + mx - 1) / mx);
  shape_match_kernel<kL><<<grid, block, 0, c.stream>>>(
      static_cast<const uint32_t*>(c.h1), static_cast<const uint32_t*>(c.h2),
      static_cast<const int32_t*>(c.nwords),
      static_cast<const bool*>(c.dollar),
      static_cast<const int32_t*>(c.shape_mask),
      static_cast<const int32_t*>(c.shape_len),
      static_cast<const int32_t*>(c.shape_flags),
      static_cast<const int32_t*>(c.tab), c.tcap,
      static_cast<const int32_t*>(c.hot), c.hcap,
      static_cast<const uint32_t*>(c.tomb), static_cast<int32_t*>(c.out), c.B,
      c.L, c.M, c.probes, vec_h, vec_tab);
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
  if (B > 0 && M > 0) {
    const Call c{h1,   h2,  nwords, dollar, shape_mask, shape_len,
                 shape_flags, tab, tcap, hot, hcap, tomb, out, B, L, M,
                 probes, static_cast<cudaStream_t>(stream)};
    switch (L) {
      case 4:
        launch<4>(c);
        break;
      case 8:
        launch<8>(c);
        break;
      case 16:
        launch<16>(c);
        break;
      default:
        launch<0>(c);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
