// Shared helpers for the port's attention kernels: dtype conversion, 16-byte
// vector loads, cp.async copies and the dynamic shared-memory opt-in.
// Inputs are float32 or bfloat16; softmax arithmetic is float32.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>
#include <mutex>

// dtype codes shared with the Python wrappers
enum DType : int { kFloat32 = 0, kBFloat16 = 1 };

template <typename T> struct VecWidth;
template <> struct VecWidth<float> { static constexpr int N = 4; };
template <> struct VecWidth<__nv_bfloat16> { static constexpr int N = 8; };

// The VecWidth<T>::N elements of one 16-byte word, converted to float.
template <typename T>
__device__ __forceinline__ void unpack_vec(const uint4& raw, float* dst) {
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

// One 16-byte load of VecWidth<T>::N elements, converted to float.
// `src` must be 16-byte aligned (the wrappers check base pointers; every
// row offset is a multiple of head_dim, itself a multiple of the width).
template <typename T>
__device__ __forceinline__ void load_vec(const T* __restrict__ src, float* dst) {
  unpack_vec<T>(__ldg(reinterpret_cast<const uint4*>(src)), dst);
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Asynchronous 16-byte copy global -> shared address `dst`; `bytes` 0 fills
// the 16 bytes with zeros and reads nothing.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int bytes = 16) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Raise the dynamic shared-memory cap of `Kernel` when a launch needs more
// than the default 48 KB.  The attribute is set once per kernel
// instantiation and size (again only when a launch needs more than any
// before), not on every launch; the lock serialises first launches from
// several host threads.  One device per process, as in the port.
template <auto Kernel>
cudaError_t allow_smem(size_t bytes) {
  static std::atomic<size_t> granted{48 * 1024};
  static std::mutex mu;
  if (bytes <= granted.load(std::memory_order_acquire)) return cudaSuccess;
  std::lock_guard<std::mutex> lock(mu);
  if (bytes <= granted.load(std::memory_order_relaxed)) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err == cudaSuccess) granted.store(bytes, std::memory_order_release);
  return err;
}
