// Shared helpers of the port's CUDA kernels (sm_90a, plain C interface).
//
// uint32 data travels between PyTorch and these kernels as int32 tensors;
// the kernels read it back as uint32_t, so every wrap-around below is the
// mod-2^32 arithmetic the JAX package gets from jnp.uint32.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#define EMQX_EXPORT extern "C" __attribute__((visibility("default")))

// murmur3-style finalizer: ops/nfa.py _mix32, ops/shape_index.py _mix32_dev
__device__ __forceinline__ uint32_t emqx_mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}
