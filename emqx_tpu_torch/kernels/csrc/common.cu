// Error text for the codes the launchers return (cudaGetLastError()).
#include "common.cuh"

EMQX_EXPORT const char* emqx_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
