// Shared helpers of the port's hand-written Hopper kernels.
#pragma once

#include <cuda_runtime.h>

#include <algorithm>
#include <float.h>
#include <math.h>

#define UNAV_RETURN_IF_ERROR()                      \
  do {                                              \
    cudaError_t e_ = cudaGetLastError();            \
    if (e_ != cudaSuccess) return (int)e_;          \
  } while (0)

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

static inline int ceil_div(long a, long b) { return (int)((a + b - 1) / b); }

// Every library exports its own copy (they are loaded separately).
extern "C" const char* unav_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
