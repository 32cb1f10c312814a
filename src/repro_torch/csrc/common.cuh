// Shared helpers for the port's attention kernels: dtype conversion and
// 16-byte vector loads.  Inputs are float32 or bfloat16; all arithmetic is
// float32.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

// dtype codes shared with the Python wrappers
enum DType : int { kFloat32 = 0, kBFloat16 = 1 };

template <typename T> struct VecWidth;
template <> struct VecWidth<float> { static constexpr int N = 4; };
template <> struct VecWidth<__nv_bfloat16> { static constexpr int N = 8; };

// One 16-byte load of VecWidth<T>::N elements, converted to float.
// `src` must be 16-byte aligned (the wrappers check base pointers; every
// row offset is a multiple of head_dim, itself a multiple of the width).
template <typename T>
__device__ __forceinline__ void load_vec(const T* __restrict__ src, float* dst) {
  const uint4 raw = __ldg(reinterpret_cast<const uint4*>(src));
  if constexpr (sizeof(T) == 4) {
    const float* f = reinterpret_cast<const float*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) dst[i] = f[i];
  } else {
    const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
    for (int i = 0; i < 8; ++i) dst[i] = __bfloat162float(h[i]);
  }
}

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// Raise the dynamic shared-memory cap of `kernel` when a launch needs more
// than the default 48 KB.
template <typename Kernel>
static cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}
