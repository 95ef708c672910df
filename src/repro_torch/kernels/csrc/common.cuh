// Shared helpers of the hand-written kernels: fp32 <-> storage-type
// conversion and the mask constants of the reference (-1e30, empty slot
// position -2^30).
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace repro {

constexpr float kNegInf = -1e30f;
constexpr int kEmptyPos = -(1 << 30);

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Dynamic shared memory above 48 KB has to be opted into per kernel.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace repro
