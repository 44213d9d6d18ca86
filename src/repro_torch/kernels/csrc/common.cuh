// Helpers shared by the attention kernels: dtype conversion to and from
// the f32 accumulation type, and warp-wide reductions.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace repro_torch {

template <typename T>
__device__ __forceinline__ float to_f32(T x);

template <>
__device__ __forceinline__ float to_f32<float>(float x) {
  return x;
}

template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);

template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}

template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// 16-byte loads: rows of hd (a multiple of 16) elements start on 16-byte
// boundaries, so one load brings 16 / sizeof(T) elements; a warp then
// reads 512 contiguous bytes per instruction instead of 64 or 128.
template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int n = 4;
};

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int n = 8;
};

template <typename T>
__device__ __forceinline__ void load16(const T* src, float* dst);

template <>
__device__ __forceinline__ void load16<float>(const float* src, float* dst) {
  const float4 r = __ldg(reinterpret_cast<const float4*>(src));
  dst[0] = r.x;
  dst[1] = r.y;
  dst[2] = r.z;
  dst[3] = r.w;
}

template <>
__device__ __forceinline__ void load16<__nv_bfloat16>(
    const __nv_bfloat16* src, float* dst) {
  const uint4 r = __ldg(reinterpret_cast<const uint4*>(src));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 f = __bfloat1622float2(h[j]);
    dst[2 * j] = f.x;
    dst[2 * j + 1] = f.y;
  }
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) {
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  }
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) {
    v += __shfl_xor_sync(0xffffffffu, v, o);
  }
  return v;
}

// Dynamic shared memory above the 48 KB default needs an opt-in per kernel.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace repro_torch
