// Shared helpers of the port's CUDA kernels: float32 or bfloat16 storage,
// float32 arithmetic.  Every launcher is `extern "C"`, takes raw device
// pointers and a cudaStream_t, and returns cudaGetLastError().
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

// dtype codes the Python wrappers pass (kernels/cuda_build.py DTYPE_CODES)
enum : int { DTYPE_F32 = 0, DTYPE_BF16 = 1 };

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch's .to()
}
