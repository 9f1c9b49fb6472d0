// Helpers shared by the port's attention kernels: f32 conversion of the
// element types the kernels take (float, bf16), vector loads of E
// consecutive elements and stores of 8.
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
// bytes when that is 4, 8 or 16 (16 when it is 32), as f32 values.
template <typename T, int E>
__device__ __forceinline__ void load_f32(const T* __restrict__ p, float (&o)[E]) {
  constexpr int kBytes = E * int(sizeof(T));
  if constexpr (kBytes == 16) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const T* t = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < E; ++i) o[i] = to_f32<T>(t[i]);
  } else if constexpr (kBytes == 32) {
    const uint4 raw0 = *reinterpret_cast<const uint4*>(p);
    const uint4 raw1 = *reinterpret_cast<const uint4*>(p + E / 2);
    const T* t0 = reinterpret_cast<const T*>(&raw0);
    const T* t1 = reinterpret_cast<const T*>(&raw1);
#pragma unroll
    for (int i = 0; i < E / 2; ++i) {
      o[i] = to_f32<T>(t0[i]);
      o[E / 2 + i] = to_f32<T>(t1[i]);
    }
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

// Store 8 f32 values as T at p, 16-byte aligned (bf16: each rounded once;
// f32: as they are).
template <typename T>
__device__ __forceinline__ void store8(T* p, const float (&v)[8]);
template <>
__device__ __forceinline__ void store8<float>(float* p, const float (&v)[8]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}
template <>
__device__ __forceinline__ void store8<__nv_bfloat16>(__nv_bfloat16* p, const float (&v)[8]) {
  uint4 raw;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = raw;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

}  // namespace fft
