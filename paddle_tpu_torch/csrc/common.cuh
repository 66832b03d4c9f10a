// Shared helpers of the port's CUDA kernels: dtype codes, conversions
// between the storage type and the f32 the kernels compute in, and a
// 16-byte vector load that widens to f32.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace ptt {

// dtype codes passed from Python (kernels/_build.py callers)
constexpr int kF32 = 0;
constexpr int kBF16 = 1;

// the JAX kernels mask with -1e30, not -inf (flash_attention.py:45,
// paged_attention.py:57): exp(-1e30 - m) is exactly 0 for any real m
constexpr float kNegInf = -1e30f;

template <typename T>
__device__ __forceinline__ float to_float(T x);
template <>
__device__ __forceinline__ float to_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_float<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);  // round to nearest even, as astype does
}

// x rounded through T and widened back: the value of `p.astype(v.dtype)`
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_float<T>(from_float<T>(x));
}

// elements of T in one 16-byte vector
template <typename T>
struct Vec {
  static constexpr int N = 16 / sizeof(T);
};

// read 16 bytes at src (16-byte aligned) and widen them to f32
template <typename T>
__device__ __forceinline__ void load16(const T* src, float* dst) {
  const uint4 raw = __ldg(reinterpret_cast<const uint4*>(src));
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int i = 0; i < Vec<T>::N; ++i) dst[i] = to_float<T>(e[i]);
}

}  // namespace ptt
