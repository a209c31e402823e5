// Helpers shared by every kernel library of the port: warp reductions and
// the error string a wrapper reports when a launch returns a cudaError_t.
#pragma once

#include <cuda_runtime.h>

namespace hig {

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

}  // namespace hig

extern "C" const char* hig_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
