// Shared helpers of the port's CUDA kernels: dtype codes, conversions
// between the storage type and the f32 the kernels compute in, a 16-byte
// vector load that widens to f32, and the head-dim instances of the
// attention kernels.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

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

// The attention kernels are built for head dims D = 16, 32, 64 and 128 and
// take any head dim 0 < d <= 128 (the TPU kernels' range): d runs in the
// smallest instance D >= d. Each kernel has a FULL template flag. FULL
// (d == D) is the code as written for D, rows read with 16-byte loads; not
// FULL (d < D, the masked instances, built in the *_masked.cu sources) reads
// rows element by element with the columns d..D-1 as 0, so they add nothing
// to Q.K^T or P.V, and never stores them.
inline int instance_dim(int d) {
  return d < 1 ? 0 : d <= 16 ? 16 : d <= 32 ? 32 : d <= 64 ? 64 : d <= 128 ? 128 : 0;
}

// the VEC = Vec<T>::N elements at columns c.. of the row at src, as f32:
// one 16-byte load at the instance's full width (src 16-byte aligned), else
// element by element, 0 at columns >= d
template <typename T, bool FULL>
__device__ __forceinline__ void load_cols(const T* src, int c, int d, float* dst) {
  if constexpr (FULL) {
    load16(src + c, dst);
  } else {
#pragma unroll
    for (int i = 0; i < Vec<T>::N; ++i)
      dst[i] = c + i < d ? to_float<T>(src[c + i]) : 0.f;
  }
}

template <typename T>
struct Tag {
  using type = T;
};

// fn(Tag<T>{}, std::integral_constant<int, D>{}) for the dtype code and the
// instance D of head dim d; cudaErrorInvalidValue for any other dtype or d
template <typename Fn>
cudaError_t dispatch_dtype_dim(int dtype, int d, Fn&& fn) {
  using I16 = std::integral_constant<int, 16>;
  using I32 = std::integral_constant<int, 32>;
  using I64 = std::integral_constant<int, 64>;
  using I128 = std::integral_constant<int, 128>;
  const int D = instance_dim(d);
  if (dtype == kF32) {
    if (D == 16) return fn(Tag<float>{}, I16{});
    if (D == 32) return fn(Tag<float>{}, I32{});
    if (D == 64) return fn(Tag<float>{}, I64{});
    if (D == 128) return fn(Tag<float>{}, I128{});
  } else if (dtype == kBF16) {
    if (D == 16) return fn(Tag<__nv_bfloat16>{}, I16{});
    if (D == 32) return fn(Tag<__nv_bfloat16>{}, I32{});
    if (D == 64) return fn(Tag<__nv_bfloat16>{}, I64{});
    if (D == 128) return fn(Tag<__nv_bfloat16>{}, I128{});
  }
  return cudaErrorInvalidValue;
}

}  // namespace ptt
