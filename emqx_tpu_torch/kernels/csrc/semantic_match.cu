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
// (a) `semantic_scores_kernel`: a block takes 64 query rows and one of S
//     column splits of the E = P + H entries (packed segment, then hot
//     segment, read in place). It walks its split in tiles of 64 entries;
//     per tile it computes the 64 x 64 f32 dot products with the queries
//     and the entries staged through shared memory in chunks of 32
//     dimensions (a thread owns a 4 x 4 block of outputs). A bf16 table is
//     widened to f32 and the query rounded to bf16 first (__float2bfloat16_rn),
//     as JAX's q.astype(bf16) does; a product of two bf16 values is exact in
//     f32, so the sums differ from JAX's only in their order. The epilogue
//     masks each (row, entry): slot >= 0, sim >= threshold, then fid < 0 or
//     fid among the row's K matched fids; it counts the qualifying entries
//     and offers them to the row's running top-k, kept by one warp (a lane
//     per place, ordered by score desc, index asc, the order lax.top_k
//     keeps). Each block writes, per row, its split's top-k candidates and
//     count: S x topk (score, index) pairs and S counts per row.
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
// D = 384): at the H100's 67 TFLOP/s of f32 outside the tensor cores, about
// 25 ms (exact f32 keeps the work off TF32); a bf16 table would be bound
// by the 989 TFLOP/s bf16 tensor-core rate. The bytes (the table once, the
// queries, the lanes) take a tenth of a millisecond. This design is the
// simple one: SIMT FMAs from shared memory, no tensor cores, TMA or wgmma;
// blocks with the same split run side by side (the row block is the fast
// grid axis), so a table tile comes from device memory about once and from
// L2 for the other row blocks. Scratch: B * S * topk * 8 bytes of
// candidates and B * S * 4 of counts. Indices are 64-bit (E * D reaches
// 1e8 and B * E 2e9); an entry index fits 31 bits (the wrapper checks).
#include <cuda_bf16.h>
#include <math_constants.h>

#include "common.cuh"

namespace {

constexpr int kBM = 64;        // query rows per block
constexpr int kBN = 64;        // entries per tile
constexpr int kDK = 32;        // dimensions per shared-memory chunk
constexpr int kThreads = 256;  // 16 x 16 threads, 4 x 4 outputs each
constexpr int kRowsPerWarp = kBM / (kThreads / 32);
constexpr unsigned kFull = 0xffffffffu;

template <typename T>
__device__ __forceinline__ float widen(T v);
template <>
__device__ __forceinline__ float widen<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ float widen<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// the query as the table's type holds it: f32 as is, bf16 rounded to
// nearest even and widened back
template <typename T>
__device__ __forceinline__ float as_table_type(float v);
template <>
__device__ __forceinline__ float as_table_type<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ float as_table_type<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

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

template <typename T>
__global__ void __launch_bounds__(kThreads) semantic_scores_kernel(
    const float* __restrict__ q, const T* __restrict__ vp, long long P,
    const T* __restrict__ vh, long long H, const int* __restrict__ fid_p,
    const int* __restrict__ slot_p, const float* __restrict__ th_p,
    const int* __restrict__ fid_h, const int* __restrict__ slot_h,
    const float* __restrict__ th_h, const int* __restrict__ matched, int B,
    int K, int D, int topk, int S, long long tiles_per_split,
    float* __restrict__ cand_s, int* __restrict__ cand_i,
    int* __restrict__ part) {
  __shared__ float qs[kBM][kDK + 1];
  __shared__ float ts[kBN][kDK + 1];
  __shared__ float sc[kBM][kBN + 1];
  __shared__ int e_fid[kBN];
  __shared__ int e_slot[kBN];
  __shared__ float e_th[kBN];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int ty = tid >> 4;
  const int tx = tid & 15;
  const long long E = P + H;
  const long long r0 = static_cast<long long>(blockIdx.x) * kBM;
  const int split = blockIdx.y;
  const long long ntiles = (E + kBN - 1) / kBN;
  const long long t_begin = split * tiles_per_split;
  const long long t_end = min(t_begin + tiles_per_split, ntiles);

  float ls[kRowsPerWarp];
  int li[kRowsPerWarp];
  int n[kRowsPerWarp];
  int cnt[kRowsPerWarp];
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    ls[rr] = -CUDART_INF_F;
    li[rr] = -1;
    n[rr] = 0;
    cnt[rr] = 0;
  }

  for (long long t = t_begin; t < t_end; ++t) {
    const long long e0 = t * kBN;
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
    for (int d0 = 0; d0 < D; d0 += kDK) {
      __syncthreads();  // the previous chunk (or tile epilogue) is read
      for (int i = tid; i < kBM * kDK; i += kThreads) {
        const int r = i / kDK;
        const int dd = i % kDK;
        const long long row = r0 + r;
        const int d = d0 + dd;
        float v = 0.0f;
        if (row < B && d < D) v = as_table_type<T>(q[row * D + d]);
        qs[r][dd] = v;
      }
      for (int i = tid; i < kBN * kDK; i += kThreads) {
        const int c = i / kDK;
        const int dd = i % kDK;
        const long long e = e0 + c;
        const int d = d0 + dd;
        float v = 0.0f;
        if (e < E && d < D) {
          v = e < P ? widen(vp[e * D + d]) : widen(vh[(e - P) * D + d]);
        }
        ts[c][dd] = v;
      }
      if (d0 == 0 && tid < kBN) {
        const long long e = e0 + tid;
        int f = -1;
        int s = -1;
        float th = 1.0f;
        if (e < P) {
          f = fid_p[e];
          s = slot_p[e];
          th = th_p[e];
        } else if (e < E) {
          f = fid_h[e - P];
          s = slot_h[e - P];
          th = th_h[e - P];
        }
        e_fid[tid] = f;
        e_slot[tid] = s;
        e_th[tid] = th;
      }
      __syncthreads();
#pragma unroll 8
      for (int dd = 0; dd < kDK; ++dd) {  // zero-filled past D
        float a[4];
        float b[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = qs[ty + 16 * i][dd];
#pragma unroll
        for (int j = 0; j < 4; ++j) b[j] = ts[tx + 16 * j][dd];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[ty + 16 * i][tx + 16 * j] = acc[i][j];
    __syncthreads();
    // epilogue: warp w masks, counts and offers rows 8w .. 8w + 7
#pragma unroll
    for (int rr = 0; rr < kRowsPerWarp; ++rr) {
      const int r = warp * kRowsPerWarp + rr;
      const long long row = r0 + r;
#pragma unroll
      for (int h = 0; h < kBN; h += 32) {
        const int c = h + lane;
        const long long e = e0 + c;
        const float s = sc[r][c];
        bool ok = false;
        if (row < B && e < E) {
          ok = e_slot[c] >= 0 && s >= e_th[c];
          const int f = e_fid[c];
          if (ok && f >= 0) {  // scoped: f must be among the row's matches
            const int* mrow = matched + row * K;
            bool hit = false;
            for (int j = 0; j < K; ++j) hit |= __ldg(mrow + j) == f;
            ok = hit;
          }
        }
        cnt[rr] += __popc(__ballot_sync(kFull, ok));
        warp_offer(ls[rr], li[rr], n[rr], ok, s, static_cast<int>(e), topk,
                   lane);
      }
    }
  }
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const long long row = r0 + warp * kRowsPerWarp + rr;
    if (row >= B) continue;
    const long long base = (row * S + split) * topk;
    if (lane < topk) {
      const bool has = lane < n[rr];
      cand_s[base + lane] = has ? ls[rr] : -CUDART_INF_F;
      cand_i[base + lane] = has ? li[rr] : -1;
    }
    if (lane == 0) part[row * S + split] = cnt[rr];
  }
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
    const void* q, const void* vp, long long P, const void* vh, long long H,
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
    if (bf16) {
      semantic_scores_kernel<__nv_bfloat16><<<grid, kThreads, 0, st>>>(
          static_cast<const float*>(q),
          static_cast<const __nv_bfloat16*>(vp), P,
          static_cast<const __nv_bfloat16*>(vh), H,
          static_cast<const int*>(fid_p), static_cast<const int*>(slot_p),
          static_cast<const float*>(th_p), static_cast<const int*>(fid_h),
          static_cast<const int*>(slot_h), static_cast<const float*>(th_h), m,
          B, K, D, topk, S, tiles_per_split, static_cast<float*>(cand_s),
          static_cast<int*>(cand_i), static_cast<int*>(part));
    } else {
      semantic_scores_kernel<float><<<grid, kThreads, 0, st>>>(
          static_cast<const float*>(q), static_cast<const float*>(vp), P,
          static_cast<const float*>(vh), H, static_cast<const int*>(fid_p),
          static_cast<const int*>(slot_p), static_cast<const float*>(th_p),
          static_cast<const int*>(fid_h), static_cast<const int*>(slot_h),
          static_cast<const float*>(th_h), m, B, K, D, topk, S,
          tiles_per_split, static_cast<float*>(cand_s),
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
