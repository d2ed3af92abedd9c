// Kernel 14: the compiled rule set's WHERE masks over one feature batch,
// every rule in one launch.
//
// Replaces `eval_prog` / `eval_rule_masks` (emqx_tpu/rules/compile.py:222,
// :318), which the JAX package unrolls into the serving jit once per rule
// set. Here one source is built once: the host encodes the R programs
// (`rules/compile.py` `encode_progs`) as (opcode, argument) int32 pairs,
// per-rule offsets and an f32 literal pool, and one thread per (rule, row)
// interprets its rule's program over its row, with a per-thread stack of
// (value, valid) pairs and masks. A rule-set change is a new upload of a
// few hundred bytes, not an nvcc run.
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
// Bound: bytes. A thread reads its row's F features and F validity bytes
// once per feature op (L1 serves the repeats) and writes one byte; the
// programs (a few hundred bytes) stay in L1. The least traffic is
// B * F * 5 + R * B bytes. Design: one thread per (rule, row), rows
// across the block so that a warp reads neighbouring rows; the stack lives
// in local memory (cached), STACK_MAX entries deep, which the host
// checks before the launch.
#include "common.cuh"

namespace {

constexpr int kStackMax = 64;  // rules/compile.py STACK_MAX

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

__global__ void rule_masks_kernel(const int* __restrict__ code,
                                  const int* __restrict__ offsets,
                                  const float* __restrict__ lits,
                                  const float* __restrict__ feats,
                                  const uint8_t* __restrict__ valid, int B,
                                  int F, uint8_t* __restrict__ out) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  const int rule = blockIdx.y;
  if (row >= B) return;
  const long long fbase = static_cast<long long>(row) * F;
  float val[kStackMax];
  // bit 0: valid (numeric entry) or the mask (boolean entry); bit 1: boolean
  uint8_t tag[kStackMax];
  int sp = 0;
  const int end = offsets[rule + 1];
  for (int pc = offsets[rule]; pc < end; ++pc) {
    const int op = code[2 * pc];
    const int arg = code[2 * pc + 1];
    switch (op) {
      case kFeat:
        val[sp] = feats[fbase + arg];
        tag[sp] = valid[fbase + arg] ? 1 : 0;
        ++sp;
        break;
      case kLit:
        val[sp] = lits[arg];
        tag[sp] = 1;
        ++sp;
        break;
      case kBlit:
        val[sp] = 0.0f;
        tag[sp] = 2 | (arg ? 1 : 0);
        ++sp;
        break;
      case kAdd: case kSub: case kMul: case kTrueDiv: case kIDiv: case kMod: {
        const float b = val[sp - 1], a = val[sp - 2];
        bool ok = (tag[sp - 1] & 1) && (tag[sp - 2] & 1);
        float r;
        if (op == kAdd) {
          r = __fadd_rn(a, b);
        } else if (op == kSub) {
          r = __fsub_rn(a, b);
        } else if (op == kMul) {
          r = __fmul_rn(a, b);
        } else {
          ok = ok && b != 0.0f;
          const float safe = b != 0.0f ? b : 1.0f;
          if (op == kTrueDiv) {
            r = __fdiv_rn(a, safe);
          } else if (op == kIDiv) {
            r = floor_divide(truncf(a), truncf(safe));
          } else {
            r = remainder(truncf(a), truncf(safe));
          }
        }
        sp -= 1;
        val[sp - 1] = r;
        tag[sp - 1] = ok ? 1 : 0;
        break;
      }
      case kNeg:
        val[sp - 1] = -val[sp - 1];
        break;
      case kEq: case kNe: case kGt: case kLt: case kGe: case kLe: {
        const float b = val[sp - 1], a = val[sp - 2];
        const bool vb = tag[sp - 1] & 1, va = tag[sp - 2] & 1;
        bool m;
        if (op == kEq || op == kNe) {
          m = (va && vb) ? (a == b) : (!va && !vb);
          if (op == kNe) m = !m;
        } else {
          const bool r = op == kGt ? a > b
                       : op == kLt ? a < b
                       : op == kGe ? a >= b
                                   : a <= b;
          m = va && vb && r;
        }
        sp -= 1;
        tag[sp - 1] = 2 | (m ? 1 : 0);
        break;
      }
      case kTruthy:
        tag[sp - 1] = 2 | (((tag[sp - 1] & 1) && val[sp - 1] != 0.0f) ? 1 : 0);
        break;
      case kNot:
        tag[sp - 1] ^= 1;
        break;
      case kAnd:
      case kOr: {
        const bool m2 = tag[sp - 1] & 1, m1 = tag[sp - 2] & 1;
        sp -= 1;
        tag[sp - 1] = 2 | ((op == kAnd ? (m1 && m2) : (m1 || m2)) ? 1 : 0);
        break;
      }
      default:
        break;  // encode_progs refuses unknown ops
    }
  }
  bool result = false;  // an empty program: ~tt
  if (sp > 0) {
    const uint8_t t = tag[sp - 1];
    result = (t & 2) ? (t & 1) : ((t & 1) && val[sp - 1] != 0.0f);
  }
  out[static_cast<long long>(rule) * B + row] = result ? 1 : 0;
}

}  // namespace

EMQX_EXPORT int emqx_rule_masks(const void* code, const void* offsets,
                                const void* lits, int R, const void* feats,
                                const void* valid, int B, int F, void* out,
                                void* stream) {
  if (R > 0 && B > 0) {
    constexpr int kThreads = 128;
    const dim3 grid(static_cast<unsigned>((B + kThreads - 1) / kThreads),
                    static_cast<unsigned>(R));
    rule_masks_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(code), static_cast<const int*>(offsets),
        static_cast<const float*>(lits), static_cast<const float*>(feats),
        static_cast<const uint8_t*>(valid), B, F, static_cast<uint8_t*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}
