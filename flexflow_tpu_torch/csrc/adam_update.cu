// adam_update — one bias-corrected Adam step of one parameter, in place,
// for sm_90a.
//
// No TPU kernel of its own: the JAX package leaves the update to XLA,
// which fuses each leaf's arithmetic into one pass
// (flexflow_tpu/optimizers.py AdamOptimizer.update). The port's plain
// version (optimizers.adam_update_ref) runs ~10 elementwise PyTorch passes
// a leaf; this kernel runs one. Same arithmetic, in the plain version's
// order, each operation rounded to f32 as PyTorch rounds it, so the result
// is bitwise the plain version's on the card (__fmul_rn, __fadd_rn,
// __fsqrt_rn and __fdiv_rn keep nvcc from contracting into FMAs or
// approximating):
//   g' = g + wd * p              (wd != 0 only)
//   m  = m * b1 + (1 - b1) * g'
//   v  = v * b2 + ((1 - b2) * g') * g'
//   p  = p - (alpha_t * m) / (sqrt(v) + eps)
// The reference's eps placement and alpha_t form (alpha_t = lr * sqrt(1 -
// b2^t) / (1 - b1^t), a device scalar the optimizer computes once a step
// from its lr and step count; torch.optim's fused Adam places eps
// elsewhere). alpha_t is read from device memory: no host sync.
//
// Bound on an H100: bytes. p and g read and p written in the parameter's
// dtype, m and v read and written in f32: 22 bytes a bf16 parameter (28
// an f32 one), at 3.35 TB/s.
//
// Design: a grid-stride loop over vectors of 8 parameters (16-byte loads
// of bf16 p and g, two of each f32 tensor), the tail of fewer than 8 one
// at a time; enough blocks to keep every SM's loads in flight.
#include "common.cuh"

namespace fft {
namespace {

constexpr int kThreads = 256;

struct AdamConsts {
  float b1, c1, b2, c2, eps, wd;  // c1 = 1 - b1, c2 = 1 - b2 (rounded to f32)
};

__device__ __forceinline__ void adam_one(float& p, float g, float& m, float& v, float alpha,
                                         const AdamConsts& k) {
  if (k.wd != 0.f) g = __fadd_rn(g, __fmul_rn(k.wd, p));
  m = __fadd_rn(__fmul_rn(m, k.b1), __fmul_rn(k.c1, g));
  v = __fadd_rn(__fmul_rn(v, k.b2), __fmul_rn(__fmul_rn(k.c2, g), g));
  p = __fsub_rn(p, __fdiv_rn(__fmul_rn(alpha, m), __fadd_rn(__fsqrt_rn(v), k.eps)));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
adam_kernel(T* __restrict__ p, const T* __restrict__ g, float* __restrict__ m,
            float* __restrict__ v, const float* __restrict__ alpha_t, size_t n,
            AdamConsts k) {
  const float alpha = *alpha_t;
  const size_t nvec = n / 8;
  const size_t stride = (size_t)gridDim.x * kThreads;
  for (size_t i = (size_t)blockIdx.x * kThreads + threadIdx.x; i < nvec; i += stride) {
    float pv[8], gv[8], mv[8], vv[8];
    load_f32<T, 8>(p + 8 * i, pv);
    load_f32<T, 8>(g + 8 * i, gv);
    load_f32<float, 8>(m + 8 * i, mv);
    load_f32<float, 8>(v + 8 * i, vv);
#pragma unroll
    for (int e = 0; e < 8; ++e) adam_one(pv[e], gv[e], mv[e], vv[e], alpha, k);
    store8<T>(p + 8 * i, pv);
    store8<float>(m + 8 * i, mv);
    store8<float>(v + 8 * i, vv);
  }
  if (blockIdx.x == 0) {
    for (size_t i = 8 * nvec + threadIdx.x; i < n; i += kThreads) {
      float pe = to_f32<T>(p[i]), me = m[i], ve = v[i];
      adam_one(pe, to_f32<T>(g[i]), me, ve, alpha, k);
      p[i] = from_f32<T>(pe);
      m[i] = me;
      v[i] = ve;
    }
  }
}

template <typename T>
cudaError_t launch(void* p, const void* g, float* m, float* v, const float* alpha, size_t n,
                   const AdamConsts& k, cudaStream_t stream) {
  int sms = 0, dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const size_t want = (n / 8 + kThreads - 1) / kThreads;
  const int blocks = (int)(want < 1 ? 1 : (want > (size_t)sms * 8 ? (size_t)sms * 8 : want));
  adam_kernel<T><<<blocks, kThreads, 0, stream>>>(static_cast<T*>(p), static_cast<const T*>(g),
                                                  m, v, alpha, n, k);
  return cudaGetLastError();
}

}  // namespace
}  // namespace fft

// p, g (n elements of DType dtype), m, v (n f32), alpha_t (one f32), all
// on the device, p, m and v written in place; n = n_hi * 2^30 + n_lo.
extern "C" int adam_update_launch(void* p, const void* g, void* m, void* v, const void* alpha_t,
                                  int n_hi, int n_lo, int dtype, float b1, float c1, float b2,
                                  float c2, float eps, float wd, void* stream) {
  if (n_hi < 0 || n_lo < 0 || n_lo >= (1 << 30)) return (int)cudaErrorInvalidValue;
  const size_t n = ((size_t)n_hi << 30) + (size_t)n_lo;
  if (n == 0) return (int)cudaSuccess;
  const fft::AdamConsts k{b1, c1, b2, c2, eps, wd};
  float* mf = static_cast<float*>(m);
  float* vf = static_cast<float*>(v);
  const float* a = static_cast<const float*>(alpha_t);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == fft::kBFloat16) return (int)fft::launch<__nv_bfloat16>(p, g, mf, vf, a, n, k, s);
  if (dtype == fft::kFloat32) return (int)fft::launch<float>(p, g, mf, vf, a, n, k, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
