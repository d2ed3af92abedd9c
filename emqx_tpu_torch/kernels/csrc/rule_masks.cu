// Kernel 14: the compiled rule set's WHERE masks over one feature batch,
// every rule in one launch.
//
// Replaces `eval_prog` / `eval_rule_masks` (emqx_tpu/rules/compile.py:222,
// :318), which the JAX package unrolls into the serving jit once per rule
// set. Here one source is built once: the host encodes the R programs
// (`rules/compile.py` `encode_progs`) as (opcode, argument) int32 pairs,
// per-rule offsets and an f32 literal pool, kept on the device between
// calls (`rule_code`), and the kernel interprets them. A rule-set change is
// a new upload of a few hundred bytes, not an nvcc run.
//
// Semantics are the JAX trace's, op for op (null semantics of
// rules/runtime.eval_expr): arithmetic is valid where both operands are,
// and the divisions also need b != 0 (b itself, before any trunc); `idiv`
// and `mod` trunc both operands, then follow jnp.floor_divide and jnp.mod
// on floats (`_float_divmod`: fmod, the exact quotient of what is left, one
// off where the signs differ, rounded half away from zero). So b = 0.5
// passes the guard, truncates to 0, and gives NaN with valid set, as JAX
// does. `eq` is where(va & vb, a == b, !va & !vb); the orderings are
// va & vb & (a op b); `truthy` is va & (a != 0), true for NaN. A numeric
// top of stack means its truthiness; an empty program gives false.
//
// Every float operation is written as a round-to-nearest intrinsic, and
// the library is built without --use_fast_math, so nvcc fuses no
// a * b + c across interpreter steps and `/` stays IEEE: each op rounds
// exactly once, as XLA's and PyTorch's elementwise ops do.
//
// Bound: bytes. The least traffic is the features and validity read once
// (B * F * 5 bytes) and the masks written (R * B bytes). On the card the
// time is the launch, one round trip for the features, and the longest
// program's chain of interpreted ops, each a few dependent steps.
//
// Design: a block of 8 warps takes a tile of 32 rows and a group of 8
// rules (grid.y: the groups). It first copies the tile's features and
// validity (rows of F, contiguous in memory: a plain copy, every load
// issued before any store) and the encoded programs into shared memory,
// with one barrier; then each warp interprets its rule over the tile's
// rows, a row a lane, so every lane of a warp runs the same op and the
// stack pointer is warp-uniform. At R <= 8 the features are read once;
// past it once a group, since a warp looping over several rules would
// chain their programs (slower than the replaced kernel at R 25 and 40).
// The groups take the rules longest program first (`order`, from the
// host), so a block's warps end together and free its slot for the next.
// The top of the stack lives in registers; the entries below it in
// shared memory as [depth][thread], conflict-free for a uniform pointer,
// sized by the programs' deepest stack (`RuleCode.depth`) through dynamic
// shared memory. The next instruction is read while this one runs.
// Features past 409 lanes, or programs past 32 KB, stay in global memory
// and are read through L1 instead. Any R fits: past 65,535 groups a warp
// loops over rules. A warp's 32 one-byte mask stores are one 32-byte sector.
#include "common.cuh"

namespace {

constexpr int kStackMax = 64;  // rules/compile.py STACK_MAX
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 32;                      // rows a block
constexpr long long kStageFeatMax = 64 << 10;  // staged features and validity
constexpr long long kStageCodeMax = 32 << 10;  // staged programs
constexpr int kMaxGroups = 65535;              // grid.y: past it a warp loops

enum Op : int {
  kFeat = 0, kLit, kBlit, kAdd, kSub, kMul, kTrueDiv, kIDiv, kMod, kNeg,
  kEq, kNe, kGt, kLt, kGe, kLe, kTruthy, kNot, kAnd, kOr,
};

// lax.sign: -1, 0 or 1, and NaN for NaN (a zero keeps its sign)
__device__ __forceinline__ float jsign(float x) {
  return x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : x);
}

// jnp.floor_divide(a, b) on floats (jax/_src/numpy/ufuncs.py `_float_divmod`)
__device__ __forceinline__ float floor_divide(float a, float b) {
  const float mod = fmodf(a, b);
  float div = __fdiv_rn(__fsub_rn(a, mod), b);
  if (mod != 0.0f && jsign(b) != jsign(mod)) div = __fsub_rn(div, 1.0f);
  return roundf(div);  // half away from zero, as lax.round
}

// jnp.mod(a, b) on floats (jnp.remainder)
__device__ __forceinline__ float remainder(float a, float b) {
  const float m = fmodf(a, b);
  const bool plus = ((m < 0.0f) != (b < 0.0f)) && m != 0.0f;
  return plus ? __fadd_rn(m, b) : m;
}

__host__ __device__ __forceinline__ long long up4(long long x) { return (x + 3) & ~3LL; }

// byte offsets of the dynamic shared memory: the stack's values, the
// programs, the features (all 4-byte words, each segment 16-byte aligned),
// then the stack's tags and the validity bytes
struct Layout {
  long long code, feat, tag, valid, total;
};

__host__ __device__ __forceinline__ Layout layout(int depth_mem, int n_words, int F,
                                                  bool stage_feat, bool stage_code) {
  Layout s;
  s.code = 4 * up4(static_cast<long long>(depth_mem) * kThreads);
  s.feat = s.code + (stage_code ? 4 * up4(n_words) : 0);
  s.tag = s.feat + (stage_feat ? 4 * up4(static_cast<long long>(kTile) * F) : 0);
  s.valid = s.tag + 16 * ((static_cast<long long>(depth_mem) * kThreads + 15) / 16);
  s.total = s.valid + (stage_feat ? 16 * ((static_cast<long long>(kTile) * F + 15) / 16) : 0);
  return s;
}

template <bool kStageFeat, bool kStageCode>
__global__ void __launch_bounds__(kThreads)
    rule_masks_kernel(const int* __restrict__ words, int n_code, int R, int n_words,
                      const float* __restrict__ feats, const uint8_t* __restrict__ valid,
                      int B, int F, int depth_mem, uint8_t* __restrict__ out) {
  extern __shared__ int4 shared_raw[];
  char* shared = reinterpret_cast<char*>(shared_raw);
  const Layout at = layout(depth_mem, n_words, F, kStageFeat, kStageCode);
  float* sval = reinterpret_cast<float*>(shared);
  uint8_t* stag = reinterpret_cast<uint8_t*>(shared + at.tag);
  const int tid = threadIdx.x;
  const long long row0 = static_cast<long long>(blockIdx.x) * kTile;
  const int rows = static_cast<int>(B - row0 < kTile ? B - row0 : kTile);
  const float* fsrc = feats + row0 * F;
  const uint8_t* vsrc = valid + row0 * F;
  const int* prog = words;
  if (kStageFeat || kStageCode) {
    float* sf = reinterpret_cast<float*>(shared + at.feat);
    uint8_t* sv = reinterpret_cast<uint8_t*>(shared + at.valid);
    int* sc = reinterpret_cast<int*>(shared + at.code);
    constexpr int kU = 4;  // loads a thread issues before it stores any
    const int total = kStageFeat ? rows * F : 0;
    const int nw = kStageCode ? n_words : 0;
    for (int e0 = tid; e0 < total || e0 < nw; e0 += kU * kThreads) {
      float fv[kU];
      uint8_t vv[kU];
      int cw[kU];
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int e = e0 + u * kThreads;
        if (e < total) {
          fv[u] = __ldg(fsrc + e);
          vv[u] = __ldg(vsrc + e);
        }
        if (e < nw) cw[u] = __ldg(words + e);
      }
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int e = e0 + u * kThreads;
        if (e < total) {
          sf[e] = fv[u];
          sv[e] = vv[u];
        }
        if (e < nw) sc[e] = cw[u];
      }
    }
    __syncthreads();
    if (kStageFeat) {
      fsrc = sf;
      vsrc = sv;
    }
    if (kStageCode) prog = sc;
  }
  const int* offsets = prog + n_code;
  const int* order = offsets + R + 1;  // the rules, longest program first
  const float* lits = reinterpret_cast<const float*>(order + R);
  const int2* code2 = reinterpret_cast<const int2*>(prog);
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int rc = lane < rows ? lane : rows - 1;  // a lane past B reads a real row
  const float* frow = fsrc + rc * F;
  const uint8_t* vrow = vsrc + rc * F;
  for (int slot = blockIdx.y * kWarps + warp; slot < R; slot += gridDim.y * kWarps) {
    const int rule = order[slot];
    // entries [0, sp - 1) in shared memory, the top in (v0, t0); a tag's
    // bit 0: valid (numeric entry) or the mask (boolean), bit 1: boolean
    int sp = 0;
    float v0 = 0.0f;
    uint32_t t0 = 0;
    auto push = [&](float v, uint32_t t) {
      if (sp >= 1) {
        sval[(sp - 1) * kThreads + tid] = v0;
        stag[(sp - 1) * kThreads + tid] = static_cast<uint8_t>(t0);
      }
      v0 = v;
      t0 = t;
      ++sp;
    };
    int pc = offsets[rule];
    const int end = offsets[rule + 1];
    int2 next = code2[pc];  // past the last op: the offsets, never used
    for (; pc < end; ++pc) {
      const int2 ins = next;
      next = code2[pc + 1];
      const int op = ins.x;
      const int arg = ins.y;
      if (op == kFeat) {
        push(frow[arg], vrow[arg] ? 1u : 0u);
      } else if (op == kLit) {
        push(lits[arg], 1u);
      } else if (op == kBlit) {
        push(0.0f, 2u | (arg ? 1u : 0u));
      } else if (op == kNeg) {
        v0 = -v0;
      } else if (op == kTruthy) {
        t0 = 2u | (((t0 & 1u) && v0 != 0.0f) ? 1u : 0u);
      } else if (op == kNot) {
        t0 ^= 1u;
      } else {  // binary: a below the top, b the top
        const float b = v0;
        const uint32_t tb = t0;
        const float a = sval[(sp - 2) * kThreads + tid];
        const uint32_t ta = stag[(sp - 2) * kThreads + tid];
        const uint32_t both = ta & tb & 1u;
        float r = 0.0f;
        uint32_t rt = 0;
        switch (op) {
          case kAdd: r = __fadd_rn(a, b); rt = both; break;
          case kSub: r = __fsub_rn(a, b); rt = both; break;
          case kMul: r = __fmul_rn(a, b); rt = both; break;
          case kTrueDiv:
          case kIDiv:
          case kMod: {
            const float safe = b != 0.0f ? b : 1.0f;
            if (op == kTrueDiv) r = __fdiv_rn(a, safe);
            else if (op == kIDiv) r = floor_divide(truncf(a), truncf(safe));
            else r = remainder(truncf(a), truncf(safe));
            rt = (both && b != 0.0f) ? 1u : 0u;
            break;
          }
          case kEq:
          case kNe: {
            const bool va = ta & 1u, vb = tb & 1u;
            bool m = (va && vb) ? (a == b) : (!va && !vb);
            if (op == kNe) m = !m;
            rt = 2u | (m ? 1u : 0u);
            break;
          }
          case kGt: rt = 2u | ((both && a > b) ? 1u : 0u); break;
          case kLt: rt = 2u | ((both && a < b) ? 1u : 0u); break;
          case kGe: rt = 2u | ((both && a >= b) ? 1u : 0u); break;
          case kLe: rt = 2u | ((both && a <= b) ? 1u : 0u); break;
          case kAnd: rt = 2u | both; break;
          default: rt = 2u | ((ta | tb) & 1u); break;  // kOr
        }
        --sp;
        v0 = r;
        t0 = rt;
      }
    }
    bool result = false;  // an empty program: ~tt
    if (sp > 0) result = (t0 & 2u) ? (t0 & 1u) : ((t0 & 1u) && v0 != 0.0f);
    if (lane < rows) out[static_cast<long long>(rule) * B + row0 + lane] = result ? 1 : 0;
  }
}

template <bool kStageFeat, bool kStageCode>
cudaError_t launch(const int* words, int n_code, int R, int n_words, const float* feats,
                   const uint8_t* valid, int B, int F, int depth_mem, uint8_t* out,
                   cudaStream_t stream) {
  const Layout at = layout(depth_mem, n_words, F, kStageFeat, kStageCode);
  const auto kernel = rule_masks_kernel<kStageFeat, kStageCode>;
  if (at.total > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(at.total));
    if (e != cudaSuccess) return e;
  }
  const int groups = (R + kWarps - 1) / kWarps;  // a warp a rule
  const dim3 grid(static_cast<unsigned>((B + kTile - 1) / kTile),
                  static_cast<unsigned>(groups < kMaxGroups ? groups : kMaxGroups));
  kernel<<<grid, kThreads, static_cast<size_t>(at.total), stream>>>(
      words, n_code, R, n_words, feats, valid, B, F, depth_mem, out);
  return cudaGetLastError();
}

}  // namespace

// words: the encoded programs as one int32 buffer (n_code words of
// (opcode, argument) pairs, R + 1 offsets, the R rules in the order the
// groups take them, the literals' bits; n_words in all); depth: the
// deepest stack of any program
EMQX_EXPORT int emqx_rule_masks(const void* words, int n_code, int R, int n_words,
                                int depth, const void* feats, const void* valid, int B,
                                int F, void* out, void* stream) {
  if (R < 1 || B < 1) return static_cast<int>(cudaSuccess);
  if (depth < 0 || depth > kStackMax || F < 0 || n_code < 0 || n_words < n_code + 2 * R + 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int depth_mem = depth > 1 ? depth - 1 : 0;
  const bool sf = 5LL * kTile * F <= kStageFeatMax;
  const bool sc = 4LL * n_words <= kStageCodeMax;
  const auto* w = static_cast<const int*>(words);
  const auto* f = static_cast<const float*>(feats);
  const auto* v = static_cast<const uint8_t*>(valid);
  auto* o = static_cast<uint8_t*>(out);
  const auto st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (sf && sc) e = launch<true, true>(w, n_code, R, n_words, f, v, B, F, depth_mem, o, st);
  else if (sf) e = launch<true, false>(w, n_code, R, n_words, f, v, B, F, depth_mem, o, st);
  else if (sc) e = launch<false, true>(w, n_code, R, n_words, f, v, B, F, depth_mem, o, st);
  else e = launch<false, false>(w, n_code, R, n_words, f, v, B, F, depth_mem, o, st);
  return static_cast<int>(e);
}
