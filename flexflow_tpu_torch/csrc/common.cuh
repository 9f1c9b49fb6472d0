// Helpers shared by the port's attention kernels: f32 conversion of the
// element types the kernels take (float, bf16) and vector loads of E
// consecutive elements.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace fft {

// Score of a masked or absent cache line. Finite, so that exp(m - m_new)
// of two untouched running maxima is exp(0) and never NaN.
constexpr float kNegInf = -1e30f;
// Softmax denominators are clamped here: a row with nothing to attend
// divides a zero accumulator and gives 0.
constexpr float kMinDenominator = 1e-20f;

enum DType : int { kFloat32 = 0, kBFloat16 = 1 };

template <typename T> __device__ __forceinline__ float to_f32(T x);
template <> __device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Load E consecutive elements at p, which is aligned to E * sizeof(T)
// bytes when that is 4, 8 or 16, as f32 values.
template <typename T, int E>
__device__ __forceinline__ void load_f32(const T* __restrict__ p, float (&o)[E]) {
  constexpr int kBytes = E * int(sizeof(T));
  if constexpr (kBytes == 16) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const T* t = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < E; ++i) o[i] = to_f32<T>(t[i]);
  } else if constexpr (kBytes == 8) {
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    const T* t = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < E; ++i) o[i] = to_f32<T>(t[i]);
  } else if constexpr (kBytes == 4) {
    const uint32_t raw = *reinterpret_cast<const uint32_t*>(p);
    const T* t = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < E; ++i) o[i] = to_f32<T>(t[i]);
  } else {
#pragma unroll
    for (int i = 0; i < E; ++i) o[i] = to_f32<T>(p[i]);
  }
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

}  // namespace fft
