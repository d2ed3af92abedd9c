// Kernel 13: the semantic routing stage. Every embedding filter of the
// table against every message of a batch, masked, counted and cut to the
// row's top-k, then unioned into the topic fan-out's compact slot rows.
//
// Replaces `semantic_match_step` and `union_semantic_slots`
// (emqx_tpu/ops/semantic_table.py:104, :176). The JAX program stores the
// [B, E] f32 similarities and a [B, E] membership mask (8.6 GB and 2.1 GB
// at B = 8,192, E = 2^18) and hands them to lax.top_k. Nothing of size
// [B, E] is stored here; two launches:
//
// (a) the score kernel: a block takes 128 query rows and one of S column
//     splits of the E = P + H entries (packed segment, then hot segment,
//     read in place) and walks its split in tiles of 128 entries. Warp w
//     owns rows 16w .. 16w + 15 of the block, against all 128 entries of
//     a tile, so a row's scores never leave its warp. Per tile:
//     - f32 table, `scores_f32_kernel`: exact f32 FMAs (no TF32), a SIMT
//       GEMM. A thread keeps an 8 x 8 register block (rows 8 ty .. 8 ty +
//       7; entries tx + 16 j). The query and entry chunks of 16
//       dimensions sit row by row in shared memory (80-byte rows), so a
//       thread reads four dimensions of a row as one float4: the query
//       rows broadcast across the warp, the entry rows fall in distinct
//       banks. Each score is one fmaf chain over d = 0 .. D - 1, so it
//       differs from JAX's sum only in order.
//     - bf16 table, `scores_bf16_kernel`: tensor cores,
//       mma.sync.m16n8k16.row.col with f32 accumulators, one m16 tile by
//       sixteen n8 tiles a warp, chunks of 64 dimensions. A block first
//       rounds its 128 query rows to bf16 with __float2bfloat16_rn, as
//       JAX's q.astype(bf16) does, once, into a scratch the wrapper
//       allocates; their chunks stream from there beside the table's.
//       Both operands reach the tensor cores through ldmatrix. A product of two bf16 values is
//       exact, so only the accumulation differs from JAX's.
//     Both copy their chunks with cp.async (16-byte pieces where D and
//     the pointers allow, else element by element) into a ring of three
//     stages, across tile boundaries, so the next chunks load while the
//     FMAs or MMAs run; a table of any D is zero-padded to the chunk
//     width. The epilogue reads the scores from the registers that hold
//     them and applies the cheap masks first (entry in range, live slot,
//     sim >= threshold); the warp appends their survivors to a queue in
//     shared memory, and drains it 32 at a time when it fills and after
//     the tile: the scope (fid < 0, or the fid among the row's K matched
//     fids), the count, and an offer to the row's top-k list in shared
//     memory where the entry ranks ahead of the row's k-th. The owning
//     warp keeps the list (a lane a place, ordered by score desc, index
//     asc, the order lax.top_k keeps). Each block writes, per row, its
//     split's top-k candidates and count: S x topk (score, index) pairs
//     and S counts per row.
// (b) `semantic_merge_kernel`: one warp per row merges the S candidate
//     lists in the same order, maps the winners to their slots (-1 where
//     fewer than topk qualify, or the winner's score is -inf, as JAX's
//     `top_v > -inf`), and writes the union row: the row's kslot topic
//     slots unchanged, then the winners, each -1 where it is already among
//     the topic slots; and the row's count, the sum of the S counts.
// `semantic_union_kernel` is `union_semantic_slots` alone (one warp per
// row), for callers that hold winners already.
//
// Bound: operations. 2 * B * E * D flops (1.65e12 at B = 8,192, E = 2^18,
// D = 384): at the H100's 67 TFLOP/s of f32 outside the tensor cores,
// about 25 ms (exact f32 keeps the work off TF32); a bf16 table is bound
// by the 989 TFLOP/s bf16 tensor-core rate, about 1.7 ms. The bytes (the
// table once, the queries, the lanes) take a tenth of a millisecond:
// blocks with the same split run side by side (the row block is the fast
// grid axis), so a table tile comes from device memory about once and
// from L2 for the other row blocks. Scratch: B * S * topk * 8 bytes of
// candidates, B * S * 4 of counts and, bf16, the rounded query rows.
// Indices are 64-bit (E * D reaches 1e8 and B * E 2e9); an entry index
// fits 31 bits (the wrapper checks).
// Shared memory: 133,632 bytes a block (f32), 182,784 (bf16): above the
// 48 KB default, so the launcher raises the limit first and returns its
// error.
#include <cuda_bf16.h>
#include <math_constants.h>

#include <climits>

#include "common.cuh"

namespace {

constexpr int kBM = 128;       // query rows per block
constexpr int kBN = 128;       // entries per tile
constexpr int kThreads = 256;  // 8 warps, 16 rows each
constexpr int kRowsPerWarp = kBM / (kThreads / 32);
constexpr int kTopkMax = 32;   // one lane a place
constexpr int kStages = 3;     // the cp.async ring
constexpr int kLanes = 3;      // tile lane buffers (tile index mod 3)
constexpr unsigned kFull = 0xffffffffu;

// f32: chunks of 16 dimensions, query and entry rows [128][16 + 4]
// (80-byte rows: 16-byte copies land aligned, and a float4 read of 16
// consecutive rows falls in distinct banks)
constexpr int kDK32 = 16;
constexpr int kLD32 = kDK32 + 4;
// bf16: chunks of 64 dimensions; the bf16 query and table rows [128][72]
// (144-byte rows: ldmatrix's eight row addresses fall in distinct bank
// groups)
constexpr int kDK16 = 64;
constexpr int kLT = kDK16 + 8;
// a warp's queue of the tile's survivors of the cheap masks: room for a
// column's votes of eight rows (8 x 32) past its drain threshold
constexpr int kQueue = 512;

// the row lists and counts, the tile lanes and the warps' queues, after
// each kernel's operand ring
constexpr size_t kTailBytes = size_t(kBM) * kTopkMax * 8 + size_t(kBM) * 16 +
                              size_t(kLanes) * kBN * 12 +
                              size_t(kThreads / 32) * kQueue * 8;
constexpr size_t kSmemF32 = size_t(2) * kStages * kBM * kLD32 * 4 + kTailBytes;
// bf16: the table's ring, then the query's ring of the same shape
constexpr size_t kSmemBf16 = size_t(2) * kStages * kBN * kLT * 2 + kTailBytes;

// (score desc, index asc): does (as, ai) rank ahead of (bs, bi)?
__device__ __forceinline__ bool ahead(float as, int ai, float bs, int bi) {
  return as > bs || (as == bs && ai < bi);
}

// Insert (cs, ci) into the warp's sorted list: lane j < n holds place j.
__device__ __forceinline__ void warp_insert(float& ls, int& li, int& n,
                                            float cs, int ci, int k,
                                            int lane) {
  const bool a = lane < n && ahead(ls, li, cs, ci);
  const int pos = __popc(__ballot_sync(kFull, a));
  if (pos >= k) return;  // uniform: the list is full and ranks ahead
  const float us = __shfl_up_sync(kFull, ls, 1);
  const int ui = __shfl_up_sync(kFull, li, 1);
  if (lane > pos) {
    ls = us;
    li = ui;
  } else if (lane == pos) {
    ls = cs;
    li = ci;
  }
  n = min(n + 1, k);
}

// Offer each lane's candidate (s, e), where `ok`, to the list, in lane
// order. A candidate that does not rank ahead of the current k-th cannot
// enter later either: the k-th only improves.
__device__ __forceinline__ void warp_offer(float& ls, int& li, int& n,
                                           bool ok, float s, int e, int k,
                                           int lane) {
  const float ks = __shfl_sync(kFull, ls, k - 1);
  const int ki = __shfl_sync(kFull, li, k - 1);
  unsigned m = __ballot_sync(kFull, ok && (n < k || ahead(s, e, ks, ki)));
  while (m) {
    const int src = __ffs(m) - 1;
    m &= m - 1;
    const float cs = __shfl_sync(kFull, s, src);
    const int ci = __shfl_sync(kFull, e, src);
    warp_insert(ls, li, n, cs, ci, k, lane);
  }
}

// -- asynchronous copies and the tensor-core instructions -----------------

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// copy `bytes` (0 or 4) of src, zero-filling the rest of 4
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

// copy `bytes` (0 or 16) of src, zero-filling the rest of 16
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

// c += a (16 x 16, row) * b (16 x 8, col), bf16 in, f32 accumulators
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// -- the row lists and the tile lanes (shared memory) ----------------------

struct Tail {
  float* ls;   // [kBM][kTopkMax] scores of each row's list
  int* li;     // [kBM][kTopkMax] entry indices
  int* n;      // [kBM] list lengths
  float* gs;   // [kBM] the gate: the k-th (score, index), or (-inf,
  int* gi;     //       INT_MAX) while the list is short
  int* cnt;    // [kBM] qualifying entries of the split so far
  int* slot;   // [kLanes][kBN] tile lanes
  float* th;
  int* fid;
  float* qs;   // [warps][kQueue] survivors: score
  int* qrc;    //                 and (block row << 16) | tile column
};

__device__ __forceinline__ Tail carve_tail(unsigned char* p) {
  Tail t;
  t.ls = reinterpret_cast<float*>(p);
  t.li = reinterpret_cast<int*>(t.ls + kBM * kTopkMax);
  t.n = t.li + kBM * kTopkMax;
  t.gs = reinterpret_cast<float*>(t.n + kBM);
  t.gi = reinterpret_cast<int*>(t.gs + kBM);
  t.cnt = t.gi + kBM;
  t.slot = t.cnt + kBM;
  t.th = reinterpret_cast<float*>(t.slot + kLanes * kBN);
  t.fid = reinterpret_cast<int*>(t.th + kLanes * kBN);
  t.qs = reinterpret_cast<float*>(t.fid + kLanes * kBN);
  t.qrc = reinterpret_cast<int*>(t.qs + (kThreads / 32) * kQueue);
  return t;
}

// Table lanes of the entries a tile covers, into lane buffer tile % 3
// (zero past E: the epilogue tests e < E).
struct Lanes {
  const int* fid_p;
  const int* slot_p;
  const float* th_p;
  const int* fid_h;
  const int* slot_h;
  const float* th_h;
  long long P;
  long long E;
};

__device__ __forceinline__ void load_lanes(const Tail& tl, const Lanes& ln,
                                           long long tile, int tid) {
  if (tid >= kBN) return;
  const long long e = tile * kBN + tid;
  const int b = static_cast<int>(tile % kLanes) * kBN + tid;
  const bool in = e < ln.E;
  const bool packed = e < ln.P;
  const long long h = packed ? e : e - ln.P;
  const int bytes = in ? 4 : 0;
  cp_async4(tl.slot + b, in ? (packed ? ln.slot_p + h : ln.slot_h + h) : ln.slot_p,
            bytes);
  cp_async4(tl.th + b, in ? (packed ? ln.th_p + h : ln.th_h + h) : ln.th_p, bytes);
  cp_async4(tl.fid + b, in ? (packed ? ln.fid_p + h : ln.fid_h + h) : ln.fid_p,
            bytes);
}

// Once a tile's lanes have landed: its threshold lane becomes NaN where
// the entry is past E or its slot is dead, so the epilogue's one compare
// takes all three cheap masks. Visible to the epilogue after the next
// __syncthreads.
__device__ __forceinline__ void mask_lanes(const Tail& tl, long long tile,
                                           long long E, int tid) {
  if (tid >= kBN) return;
  const int b = static_cast<int>(tile % kLanes) * kBN + tid;
  if (tile * kBN + tid >= E || tl.slot[b] < 0) tl.th[b] = CUDART_NAN_F;
}

// Insert (cs, ci) into row r's list; the whole warp calls it together.
__device__ __noinline__ void list_insert(const Tail& tl, int r, float cs,
                                         int ci, int k, int lane) {
  float* ls = tl.ls + r * kTopkMax;
  int* li = tl.li + r * kTopkMax;
  const int n = tl.n[r];
  const float vs = lane < n ? ls[lane] : -CUDART_INF_F;
  const int vi = lane < n ? li[lane] : -1;
  const int pos =
      __popc(__ballot_sync(kFull, lane < n && ahead(vs, vi, cs, ci)));
  if (pos >= k) return;  // uniform: the list is full and ranks ahead
  const float us = __shfl_up_sync(kFull, vs, 1);
  const int ui = __shfl_up_sync(kFull, vi, 1);
  float ns = vs;
  int ni = vi;
  if (lane == pos) {
    ns = cs;
    ni = ci;
  } else if (lane > pos) {
    ns = us;
    ni = ui;
  }
  const int n2 = min(n + 1, k);
  const float ks = __shfl_sync(kFull, ns, k - 1);
  const int ki = __shfl_sync(kFull, ni, k - 1);
  __syncwarp();
  if (lane < n2) {
    ls[lane] = ns;
    li[lane] = ni;
  }
  if (lane == 0) {
    tl.n[r] = n2;
    if (n2 == k) {
      tl.gs[r] = ks;
      tl.gi[r] = ki;
    }
  }
  __syncwarp();
}

// Drain a warp's queue of `qn` survivors of the cheap masks, 32 at a
// time: each checks its row and its scope (fid < 0, or the fid among the
// row's K matched fids), counts, and, where it ranks ahead of its row's
// k-th (read fresh from shared memory), enters the row's list. The
// queue's order does not matter: the count is a sum and the list keeps a
// total order. Inline after the tile; out of line (`drain_queue`) where
// a full queue interrupts the tile, which is rare.
__device__ __forceinline__ void drain_body(const Tail& tl, int warp, int qn,
                                           long long r0, long long e0, int b,
                                           int B,
                                           const int* __restrict__ matched,
                                           int K, int topk, int lane) {
  const float* qs = tl.qs + warp * kQueue;
  const int* qrc = tl.qrc + warp * kQueue;
  for (int base = 0; base < qn; base += 32) {
    const int at = base + lane;
    bool ok = at < qn;
    float s = 0.0f;
    int r = 0;
    int c = 0;
    if (ok) {
      s = qs[at];
      r = qrc[at] >> 16;
      c = qrc[at] & 0xffff;
    }
    const long long row = r0 + r;
    ok = ok && row < B;
    const int f = tl.fid[b + c];
    if (ok && f >= 0) {  // scoped: f must be among the row's matches
      const int* mrow = matched + row * K;
      bool hit = false;
      for (int x = 0; x < K; ++x) hit |= __ldg(mrow + x) == f;
      ok = hit;
    }
    if (ok) atomicAdd(tl.cnt + r, 1);
    const int e = static_cast<int>(e0 + c);
    unsigned m = __ballot_sync(kFull, ok && ahead(s, e, tl.gs[r], tl.gi[r]));
    while (m) {
      const int src = __ffs(m) - 1;
      m &= m - 1;
      list_insert(tl, __shfl_sync(kFull, r, src), __shfl_sync(kFull, s, src),
                  __shfl_sync(kFull, e, src), topk, lane);
    }
  }
  __syncwarp();
}

__device__ __noinline__ void drain_queue(const Tail& tl, int warp, int qn,
                                         long long r0, long long e0, int b,
                                         int B,
                                         const int* __restrict__ matched,
                                         int K, int topk, int lane) {
  drain_body(tl, warp, qn, r0, e0, b, B, matched, K, topk, lane);
}

// The tile's epilogue for one thread's NR rows x NC entries: `row_of(i)`
// and `col_of(j)` are block-local, `score(i, j)` reads the register that
// holds the score. Each element takes the cheap masks (entry in range,
// live slot, score >= threshold: `mask_lanes` made the threshold NaN
// where either of the first two fails) and a vote; the warp appends its survivors to its queue in shared
// memory, which `drain_queue` empties when it fills and after the tile.
template <int NR, int NC, typename RowOf, typename ColOf, typename Score>
__device__ __forceinline__ void tile_epilogue(
    RowOf row_of, ColOf col_of, Score score, const Tail& tl, int warp,
    long long tile, long long r0, int B, const int* __restrict__ matched,
    int K, int topk, int lane) {
  const int b = static_cast<int>(tile % kLanes) * kBN;
  const long long e0 = tile * kBN;
  const unsigned below = (1u << lane) - 1u;
  float* qs = tl.qs + warp * kQueue;
  int* qrc = tl.qrc + warp * kQueue;
  int qn = 0;
  // the thresholds, NaN where dead or past E (`mask_lanes`), read ahead:
  // the compiler cannot move a load past a possible drain
  float th[NC];
#pragma unroll
  for (int j = 0; j < NC; ++j) th[j] = tl.th[b + col_of(j)];
#pragma unroll
  for (int j = 0; j < NC; ++j) {
    const int c = col_of(j);
#pragma unroll
    for (int i = 0; i < NR; ++i) {  // no branch: predicated appends
      const bool cheap = score(i, j) >= th[j];
      const unsigned m = __ballot_sync(kFull, cheap);
      if (cheap) {
        const int at = qn + __popc(m & below);
        qs[at] = score(i, j);
        qrc[at] = (row_of(i) << 16) | c;
      }
      qn += __popc(m);
    }
    if (qn > kQueue - 32 * NR) {  // room for the next column's NR votes
      __syncwarp();
      drain_queue(tl, warp, qn, r0, e0, b, B, matched, K, topk, lane);
      qn = 0;
    }
  }
  if (qn) {
    __syncwarp();
    drain_body(tl, warp, qn, r0, e0, b, B, matched, K, topk, lane);
  }
}

__device__ __forceinline__ void init_lists(const Tail& tl, int warp,
                                           int lane) {
  if (lane < kRowsPerWarp) {
    const int r = warp * kRowsPerWarp + lane;
    tl.n[r] = 0;
    tl.cnt[r] = 0;
    tl.gs[r] = -CUDART_INF_F;
    tl.gi[r] = INT_MAX;
  }
  __syncwarp();
}

// Each of the warp's rows: its split's count and top-k candidates, -inf /
// -1 past the list's length.
__device__ __forceinline__ void write_lists(const Tail& tl, int warp,
                                            int lane, long long r0, int B,
                                            int S, int split, int topk,
                                            float* __restrict__ cand_s,
                                            int* __restrict__ cand_i,
                                            int* __restrict__ part) {
  __syncwarp();
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const int r = warp * kRowsPerWarp + rr;
    const long long row = r0 + r;
    if (row >= B) break;
    const long long base = (row * S + split) * topk;
    if (lane < topk) {
      const bool has = lane < tl.n[r];
      cand_s[base + lane] = has ? tl.ls[r * kTopkMax + lane] : -CUDART_INF_F;
      cand_i[base + lane] = has ? tl.li[r * kTopkMax + lane] : -1;
    }
    if (lane == 0) part[row * S + split] = tl.cnt[r];
  }
}

// The split's tile range and step count (one step = one chunk of a tile).
struct Walk {
  long long t_begin;
  long long steps;
  int nchunks;
};

__device__ __forceinline__ Walk split_walk(long long E, int D, int dk,
                                           long long tiles_per_split,
                                           int split) {
  const long long ntiles = (E + kBN - 1) / kBN;
  Walk w;
  w.t_begin = split * tiles_per_split;
  const long long t_end = min(w.t_begin + tiles_per_split, ntiles);
  w.nchunks = (D + dk - 1) / dk;
  w.steps = t_end > w.t_begin ? (t_end - w.t_begin) * w.nchunks : 0;
  return w;
}

// -- (a), f32 table: the SIMT GEMM -----------------------------------------

// vec: the query and both segments start on 16 bytes and D % 4 == 0, so
// a row's chunk copies as 16-byte pieces; else element by element
__global__ void __launch_bounds__(kThreads, 1) scores_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ vp,
    const float* __restrict__ vh, Lanes ln, const int* __restrict__ matched,
    int B, int K, int D, int topk, int S, long long tiles_per_split, int vec,
    float* __restrict__ cand_s, int* __restrict__ cand_i,
    int* __restrict__ part) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* As = reinterpret_cast<float*>(smem);  // [kStages][kBM][kLD32]
  float* Bs = As + kStages * kBM * kLD32;      // [kStages][kBN][kLD32]
  const Tail tl = carve_tail(reinterpret_cast<unsigned char*>(
      Bs + kStages * kBN * kLD32));

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int tx = lane & 15;                  // entries tx + 16 j
  const int ty = warp * 2 + (lane >> 4);     // rows 8 ty .. 8 ty + 7
  const long long r0 = static_cast<long long>(blockIdx.x) * kBM;
  const int split = blockIdx.y;
  const Walk w = split_walk(ln.E, D, kDK32, tiles_per_split, split);
  init_lists(tl, warp, lane);

  // producer: step s -> ring slot s % kStages
  long long p_tile = w.t_begin;
  int p_chunk = 0;
  int p_slot = 0;
  auto produce = [&]() {
    float* as = As + p_slot * kBM * kLD32;
    float* bs = Bs + p_slot * kBN * kLD32;
    const long long e0 = p_tile * kBN;
    const int d0 = p_chunk * kDK32;
    if (vec) {  // 4 pieces of 16 bytes a row and operand: 2 a thread
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        const int x = tid + kThreads * m;
        const int r = x >> 2;
        const int gd = d0 + (x & 3) * 4;
        const long long row = r0 + r;
        const bool okq = row < B && gd < D;
        cp_async16(as + r * kLD32 + (x & 3) * 4, okq ? q + row * D + gd : q,
                   okq ? 16 : 0);
        const long long e = e0 + r;
        const bool okt = e < ln.E && gd < D;
        const float* src =
            okt ? (e < ln.P ? vp + e * D + gd : vh + (e - ln.P) * D + gd) : q;
        cp_async16(bs + r * kLD32 + (x & 3) * 4, src, okt ? 16 : 0);
      }
    } else {  // 16 elements a row and operand: 8 a thread
#pragma unroll
      for (int m = 0; m < 8; ++m) {
        const int x = tid + kThreads * m;
        const int r = x >> 4;
        const int gd = d0 + (x & 15);
        const long long row = r0 + r;
        const bool okq = row < B && gd < D;
        cp_async4(as + r * kLD32 + (x & 15), okq ? q + row * D + gd : q,
                  okq ? 4 : 0);
        const long long e = e0 + r;
        const bool okt = e < ln.E && gd < D;
        const float* src =
            okt ? (e < ln.P ? vp + e * D + gd : vh + (e - ln.P) * D + gd) : q;
        cp_async4(bs + r * kLD32 + (x & 15), src, okt ? 4 : 0);
      }
    }
    if (p_chunk == 0) load_lanes(tl, ln, p_tile, tid);
    if (++p_chunk == w.nchunks) {
      p_chunk = 0;
      ++p_tile;
    }
    p_slot = p_slot + 1 == kStages ? 0 : p_slot + 1;
  };

  float acc[8][8];
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < w.steps) produce();
    cp_async_commit();
  }
  long long c_tile = w.t_begin;
  int c_chunk = 0;
  int c_slot = 0;
  for (long long s = 0; s < w.steps; ++s) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // step s landed; every warp is done with step s - 1
    if (s + kStages - 1 < w.steps) produce();
    cp_async_commit();
    if (c_chunk == 0) {
      mask_lanes(tl, c_tile, ln.E, tid);
      if (w.nchunks == 1) __syncthreads();  // else a later step's barrier
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
    }
    const float* as = As + c_slot * kBM * kLD32 + ty * 8 * kLD32;
    const float* bs = Bs + c_slot * kBN * kLD32 + tx * kLD32;
#pragma unroll
    for (int k4 = 0; k4 < kDK32 / 4; ++k4) {  // zero-filled past D
      float4 a[8];
      float4 b[8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        a[i] = *reinterpret_cast<const float4*>(as + i * kLD32 + 4 * k4);
#pragma unroll
      for (int j = 0; j < 8; ++j)
        b[j] = *reinterpret_cast<const float4*>(bs + 16 * j * kLD32 + 4 * k4);
      // d ascending: each score stays one fmaf chain over d
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i].x, b[j].x, acc[i][j]);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i].y, b[j].y, acc[i][j]);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i].z, b[j].z, acc[i][j]);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i].w, b[j].w, acc[i][j]);
    }
    if (c_chunk == w.nchunks - 1) {
      tile_epilogue<8, 8>(
          [&](int i) { return ty * 8 + i; }, [&](int j) { return tx + 16 * j; },
          [&](int i, int j) { return acc[i][j]; }, tl, warp, c_tile, r0, B,
          matched, K, topk, lane);
      c_chunk = 0;
      ++c_tile;
    } else {
      ++c_chunk;
    }
    c_slot = c_slot + 1 == kStages ? 0 : c_slot + 1;
  }
  cp_async_wait<0>();
  write_lists(tl, warp, lane, r0, B, S, split, topk, cand_s, cand_i, part);
}

// -- (a), bf16 table: tensor cores -----------------------------------------

// flags: bit 0, both segments start on 16 bytes and D % 8 == 0, so a
// table row's chunk copies as 16-byte pieces (else element by element);
// bit 2, the query starts on 16 bytes and D % 4 == 0 (float4 reads).
// qb, a scratch [row blocks x kBM][Dp] the wrapper allocates, takes the
// query rows rounded to bf16, each block writing its own rows (the S
// blocks of a row block write the same bits) before its chunks stream
// from there beside the table's.
__global__ void __launch_bounds__(kThreads, 1) scores_bf16_kernel(
    const float* __restrict__ q, __nv_bfloat16* __restrict__ qb,
    const __nv_bfloat16* __restrict__ vp, const __nv_bfloat16* __restrict__ vh,
    Lanes ln, const int* __restrict__ matched, int B, int K, int D, int topk,
    int S, long long tiles_per_split, int flags, float* __restrict__ cand_s,
    int* __restrict__ cand_i, int* __restrict__ part) {
  const bool vec = flags & 1;
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;   // the fragments' row group
  const int t4 = lane & 3;   // the fragments' column pair
  const long long r0 = static_cast<long long>(blockIdx.x) * kBM;
  const int split = blockIdx.y;
  const Walk w = split_walk(ln.E, D, kDK16, tiles_per_split, split);
  const int Dp = w.nchunks * kDK16;
  // [kStages][kBN][kLT] the table; then [kStages][kBM][kLT] the query
  __nv_bfloat16* Tb = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Ab = Tb + kStages * kBN * kLT;
  const Tail tl = carve_tail(reinterpret_cast<unsigned char*>(Ab + kStages * kBM * kLT));
  init_lists(tl, warp, lane);

  // the block's query rows, rounded to bf16 (__float2bfloat16_rn) once:
  // four dimensions a load where the rows allow 16-byte reads
  __nv_bfloat16* qrows = qb + r0 * Dp;
  if (flags & 4) {
    const int Dp4 = Dp / 4;
#pragma unroll 4
    for (int x = tid; x < kBM * Dp4; x += kThreads) {
      const int r = x / Dp4;
      const int d = (x - r * Dp4) * 4;
      float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (r0 + r < B && d < D) v = *reinterpret_cast<const float4*>(q + (r0 + r) * D + d);
      const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
      const __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
      *reinterpret_cast<uint2*>(qrows + r * Dp + d) =
          make_uint2(*reinterpret_cast<const unsigned*>(&lo),
                     *reinterpret_cast<const unsigned*>(&hi));
    }
  } else {
    for (int x = tid; x < kBM * Dp; x += kThreads) {
      const int r = x / Dp;
      const int d = x - r * Dp;
      const float v = r0 + r < B && d < D ? q[(r0 + r) * D + d] : 0.0f;
      qrows[r * Dp + d] = __float2bfloat16_rn(v);
    }
  }
  __threadfence();  // the copies below read qb through L2
  __syncthreads();

  long long p_tile = w.t_begin;
  int p_chunk = 0;
  int p_slot = 0;
  auto produce = [&]() {
    __nv_bfloat16* ts = Tb + p_slot * kBN * kLT;
    const long long e0 = p_tile * kBN;
    const int d0 = p_chunk * kDK16;
    // kPieces pieces of 8 bf16 a row and operand
    constexpr int kPieces = kDK16 / 8;
    __nv_bfloat16* as = Ab + p_slot * kBM * kLT;
#pragma unroll
    for (int m = 0; m < kBM * kPieces / kThreads; ++m) {
      const int x = tid + kThreads * m;
      const int r = x / kPieces;
      const int p = (x % kPieces) * 8;
      cp_async16(as + r * kLT + p, qrows + r * Dp + d0 + p, 16);
    }
    if (vec) {
#pragma unroll
      for (int m = 0; m < kBN * kPieces / kThreads; ++m) {
        const int x = tid + kThreads * m;
        const int r = x / kPieces;
        const int p = (x % kPieces) * 8;
        const int gd = d0 + p;
        const long long e = e0 + r;
        const bool ok = e < ln.E && gd < D;
        const __nv_bfloat16* src =
            ok ? (e < ln.P ? vp + e * D + gd : vh + (e - ln.P) * D + gd) : vp;
        cp_async16(ts + r * kLT + p, src, ok ? 16 : 0);
      }
    } else {  // any other D: element by element, synchronously
      for (int x = tid; x < kBN * kDK16; x += kThreads) {
        const int r = x / kDK16;
        const int dd = x % kDK16;
        const long long e = e0 + r;
        const int gd = d0 + dd;
        __nv_bfloat16 v = __float2bfloat16_rn(0.0f);
        if (e < ln.E && gd < D) {
          v = e < ln.P ? vp[e * D + gd] : vh[(e - ln.P) * D + gd];
        }
        ts[r * kLT + dd] = v;
      }
    }
    if (p_chunk == 0) load_lanes(tl, ln, p_tile, tid);
    if (++p_chunk == w.nchunks) {
      p_chunk = 0;
      ++p_tile;
    }
    p_slot = p_slot + 1 == kStages ? 0 : p_slot + 1;
  };

  float acc[16][4];
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < w.steps) produce();
    cp_async_commit();
  }
  long long c_tile = w.t_begin;
  int c_chunk = 0;
  int c_slot = 0;
  for (long long s = 0; s < w.steps; ++s) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // step s landed; every warp is done with step s - 1
    if (s + kStages - 1 < w.steps) produce();
    cp_async_commit();
    if (c_chunk == 0) {
      mask_lanes(tl, c_tile, ln.E, tid);
      if (w.nchunks == 1) __syncthreads();  // else a later step's barrier
#pragma unroll
      for (int i = 0; i < 16; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
    }
    const __nv_bfloat16* as = Ab + c_slot * kBM * kLT;
    const __nv_bfloat16* ts = Tb + c_slot * kBN * kLT;
#pragma unroll
    for (int ks = 0; ks < kDK16 / 16; ++ks) {  // zero-filled past D
      unsigned a[4];
      ldmatrix_x4(a, as + (warp * kRowsPerWarp + (lane & 15)) * kLT + ks * 16 +
                         (lane >> 4) * 8);
      const int mi = lane >> 3;
#pragma unroll
      for (int np = 0; np < 8; ++np) {
        unsigned b[4];
        ldmatrix_x4(b, ts + ((2 * np + (mi >> 1)) * 8 + (lane & 7)) * kLT +
                           ks * 16 + (mi & 1) * 8);
        mma_bf16(acc[2 * np], a, b[0], b[1]);
        mma_bf16(acc[2 * np + 1], a, b[2], b[3]);
      }
    }
    if (c_chunk == w.nchunks - 1) {
      // acc[nt] holds (row g, entries 8 nt + 2 t4, + 1) and (row g + 8, ...)
      tile_epilogue<2, 32>(
          [&](int i) { return warp * kRowsPerWarp + g + 8 * i; },
          [&](int j) { return (j >> 1) * 8 + 2 * t4 + (j & 1); },
          [&](int i, int j) { return acc[j >> 1][2 * i + (j & 1)]; }, tl, warp,
          c_tile, r0, B, matched, K, topk, lane);
      c_chunk = 0;
      ++c_tile;
    } else {
      ++c_chunk;
    }
    c_slot = c_slot + 1 == kStages ? 0 : c_slot + 1;
  }
  cp_async_wait<0>();
  write_lists(tl, warp, lane, r0, B, S, split, topk, cand_s, cand_i, part);
}

__global__ void semantic_merge_kernel(
    const float* __restrict__ cand_s, const int* __restrict__ cand_i,
    const int* __restrict__ part, int S, const int* __restrict__ slot_p,
    long long P, const int* __restrict__ slot_h,
    const int* __restrict__ topic, int kslot, int B, int topk,
    int* __restrict__ out, int* __restrict__ count) {
  const long long row =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= B) return;  // the whole warp leaves together
  float ls = -CUDART_INF_F;
  int li = -1;
  int n = 0;
  for (int s = 0; s < S; ++s) {
    const long long base = (row * S + s) * topk;
    float cs = -CUDART_INF_F;
    int ci = -1;
    if (lane < topk) {
      cs = cand_s[base + lane];
      ci = cand_i[base + lane];
    }
    warp_offer(ls, li, n, ci >= 0, cs, ci, topk, lane);
  }
  int total = 0;
  for (int s = lane; s < S; s += 32) total += part[row * S + s];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) total += __shfl_xor_sync(kFull, total, o);
  const long long W = kslot + topk;
  int* orow = out + row * W;
  const int* trow = topic + row * kslot;
  for (int j = lane; j < kslot; j += 32) orow[j] = trow[j];
  if (lane < topk) {
    int slot = -1;
    if (lane < n && ls > -CUDART_INF_F) {
      slot = li < P ? slot_p[li] : slot_h[li - P];
    }
    if (slot >= 0) {
      for (int j = 0; j < kslot; ++j) {
        if (trow[j] == slot) {
          slot = -1;
          break;
        }
      }
    }
    orow[kslot + lane] = slot;
  }
  if (lane == 0) count[row] = total;
}

__global__ void semantic_union_kernel(const int* __restrict__ slots,
                                      int kslot,
                                      const int* __restrict__ sem, int topk,
                                      int B, int* __restrict__ out) {
  const long long row =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= B) return;
  const long long W = kslot + topk;
  const int* trow = slots + row * kslot;
  int* orow = out + row * W;
  for (int j = lane; j < kslot; j += 32) orow[j] = trow[j];
  for (int j = lane; j < topk; j += 32) {
    int slot = sem[row * topk + j];
    if (slot >= 0) {
      for (int i = 0; i < kslot; ++i) {
        if (trow[i] == slot) {
          slot = -1;
          break;
        }
      }
    }
    orow[kslot + j] = slot;
  }
}

constexpr int kWarpThreads = 256;  // 8 rows per block in (b) and the union

unsigned warp_blocks(int B) {
  const int per = kWarpThreads / 32;
  return static_cast<unsigned>((B + per - 1) / per);
}

}  // namespace

EMQX_EXPORT int emqx_semantic_scores(
    const void* q, void* qb, const void* vp, long long P, const void* vh, long long H,
    int bf16, const void* fid_p, const void* slot_p, const void* th_p,
    const void* fid_h, const void* slot_h, const void* th_h,
    const void* matched, int B, int K, int D, int topk, int S,
    long long tiles_per_split, void* cand_s, void* cand_i, void* part,
    void* stream) {
  if (B > 0) {
    const dim3 grid(static_cast<unsigned>((B + kBM - 1) / kBM),
                    static_cast<unsigned>(S));
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const auto* m = static_cast<const int*>(matched);
    const Lanes ln{static_cast<const int*>(fid_p), static_cast<const int*>(slot_p),
                   static_cast<const float*>(th_p), static_cast<const int*>(fid_h),
                   static_cast<const int*>(slot_h), static_cast<const float*>(th_h),
                   P, P + H};
    if (bf16) {
      const cudaError_t rc = cudaFuncSetAttribute(
          scores_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(kSmemBf16));
      if (rc != cudaSuccess) {
        cudaGetLastError();  // returned here, not left for the next launch
        return static_cast<int>(rc);
      }
      const auto rows = reinterpret_cast<uintptr_t>(vp) | reinterpret_cast<uintptr_t>(vh);
      const int flags = (D % 8 == 0 && rows % 16 == 0 ? 1 : 0) |
                        (D % 4 == 0 && reinterpret_cast<uintptr_t>(q) % 16 == 0 ? 4 : 0);
      scores_bf16_kernel<<<grid, kThreads, kSmemBf16, st>>>(
          static_cast<const float*>(q), static_cast<__nv_bfloat16*>(qb),
          static_cast<const __nv_bfloat16*>(vp),
          static_cast<const __nv_bfloat16*>(vh), ln, m, B, K, D, topk, S,
          tiles_per_split, flags, static_cast<float*>(cand_s),
          static_cast<int*>(cand_i), static_cast<int*>(part));
    } else {
      const cudaError_t rc = cudaFuncSetAttribute(
          scores_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(kSmemF32));
      if (rc != cudaSuccess) {
        cudaGetLastError();
        return static_cast<int>(rc);
      }
      const auto rows = reinterpret_cast<uintptr_t>(q) |
                        reinterpret_cast<uintptr_t>(vp) | reinterpret_cast<uintptr_t>(vh);
      const int vec = D % 4 == 0 && rows % 16 == 0;
      scores_f32_kernel<<<grid, kThreads, kSmemF32, st>>>(
          static_cast<const float*>(q), static_cast<const float*>(vp),
          static_cast<const float*>(vh), ln, m, B, K, D, topk, S,
          tiles_per_split, vec, static_cast<float*>(cand_s),
          static_cast<int*>(cand_i), static_cast<int*>(part));
    }
  }
  return static_cast<int>(cudaGetLastError());
}

EMQX_EXPORT int emqx_semantic_merge(const void* cand_s, const void* cand_i,
                                    const void* part, int S,
                                    const void* slot_p, long long P,
                                    const void* slot_h, const void* topic,
                                    int kslot, int B, int topk, void* out,
                                    void* count, void* stream) {
  if (B > 0) {
    semantic_merge_kernel<<<warp_blocks(B), kWarpThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(cand_s), static_cast<const int*>(cand_i),
        static_cast<const int*>(part), S, static_cast<const int*>(slot_p), P,
        static_cast<const int*>(slot_h), static_cast<const int*>(topic),
        kslot, B, topk, static_cast<int*>(out), static_cast<int*>(count));
  }
  return static_cast<int>(cudaGetLastError());
}

EMQX_EXPORT int emqx_semantic_union(const void* slots, int kslot,
                                    const void* sem, int topk, int B,
                                    void* out, void* stream) {
  if (B > 0) {
    semantic_union_kernel<<<warp_blocks(B), kWarpThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(slots), kslot, static_cast<const int*>(sem),
        topk, B, static_cast<int*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}
