// Shared helpers for the port's hand-written Hopper kernels.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace ir2rgb {

// 16-byte vector of T: 4 fp32 or 8 bf16 values, loaded and stored as one
// uint4 so that neighbouring threads read neighbouring 16-byte words.
template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static void unpack(const uint4& q, float* v) {
    const float* f = reinterpret_cast<const float*>(&q);
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] = f[i];
  }
  __device__ __forceinline__ static uint4 pack(const float* v) {
    uint4 q;
    float* f = reinterpret_cast<float*>(&q);
#pragma unroll
    for (int i = 0; i < N; ++i) f[i] = v[i];
    return q;
  }
  __device__ __forceinline__ static float scalar(float v) { return v; }
};

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ __forceinline__ static void unpack(const uint4& q, float* v) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&q);
#pragma unroll
    for (int i = 0; i < N / 2; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
  __device__ __forceinline__ static uint4 pack(const float* v) {
    uint4 q;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&q);
#pragma unroll
    for (int i = 0; i < N / 2; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    return q;
  }
  __device__ __forceinline__ static __nv_bfloat16 scalar(float v) {
    return __float2bfloat16(v);
  }
};

}  // namespace ir2rgb
