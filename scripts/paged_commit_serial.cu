// paged_commit_serial — the first design of the quantized K/V commit
// (flexflow_tpu_torch/csrc/paged_commit.cu before its redesign), kept
// outside the package as the yardstick that chip_smoke.py times the
// commit kernel against on the same card. chip_smoke.py alone builds it
// (nvcc with the package's flags and -I flexflow_tpu_torch/csrc) and
// launches it; no serving path does.
//
// The same function as paged_commit.cu (kv_quant.quant_line_write on K
// and on V, bitwise on every page but the scratch page), in its serial
// form: one block of 256 threads a (KV head, slot) commits K and then V;
// in each, the line amax by scalar loads, each line's page lead by an
// O(C) scan, the pages whose scale moved requantized one after another,
// the lines read again to be quantized, four barriers. Padding lines are
// committed to the scratch page. In quant_line_write's whole-pool branch
// (R * C >= P + 1) up to 1024 x KV sweep blocks each scan every line to
// learn whether their page was touched. phys and off are int32.
#include "paged_attention.cuh"

namespace fft {
namespace {

constexpr int kSerialThreads = 256;
constexpr int kSerialMaxLines = 232448 / 20;  // 5 words a line in 227 KB

struct SerialArgs {
  const void* k;
  const void* v;
  void* k_pool;
  void* v_pool;
  float* k_scale;
  float* v_scale;
  const int* phys;
  const int* off;
  int R, C, KV, ps;
  float qmax;
};

__device__ __forceinline__ uint8_t serial_pack(float lo, float hi) {
  return uint8_t(((int)lo + 8) | (((int)hi + 8) << 4));
}

template <typename TQ, int KIND, int DK>
__device__ void serial_lines(const SerialArgs& f, int r, int h, const TQ* vals, void* pool,
                             float* scale, float* sLq, int* sPage, int* sLead, float* sNew,
                             float* sRatio) {
  constexpr int NT = kSerialThreads;
  constexpr int kWarps = NT / 32;
  constexpr int DKP = DK / pack_of<KIND>();
  const int C = f.C, tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const float qmax = f.qmax;
  const TQ* rowv = vals + ((size_t)r * C * f.KV + h) * DK;
  const size_t line_stride = (size_t)f.KV * DK;
  const int* of = f.off + (size_t)r * C;

  for (int c = warp; c < C; c += kWarps) {
    float mx = 0.f;
    for (int d = lane; d < DK; d += 32) mx = fmaxf(mx, fabsf(to_f32<TQ>(rowv[c * line_stride + d])));
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    if (lane == 0) sLq[c] = __fdiv_rn(mx, qmax);
  }
  for (int c = tid; c < C; c += NT) sPage[c] = f.phys[(size_t)r * C + c];
  __syncthreads();
  for (int c = tid; c < C; c += NT) {
    const int page = sPage[c];
    int lead = c;
    for (int c2 = 0; c2 < c; ++c2) {
      if (sPage[c2] == page) {
        lead = c2;
        break;
      }
    }
    sLead[c] = lead;
    if (lead != c) continue;
    bool first = false;
    float pmax = 0.f;
    for (int c2 = c; c2 < C; ++c2) {
      if (sPage[c2] != page) continue;
      first = first || of[c2] == 0;
      pmax = fmaxf(pmax, sLq[c2]);
    }
    const float old = first ? 0.f : scale[(size_t)page * f.KV + h];
    const float nw = fmaxf(old, pmax);
    sNew[c] = nw;
    sRatio[c] = nw > 0.f ? __fdiv_rn(old, fmaxf(nw, 1e-30f)) : 0.f;
  }
  __syncthreads();

  constexpr int V = DKP / 8;
  for (int c = 0; c < C; ++c) {  // block-uniform
    if (sLead[c] != c || sRatio[c] == 1.f) continue;
    const float ratio = sRatio[c];
    const size_t base = pool_row<KIND, DK>(sPage[c], 0, h, f.ps, f.KV);
    for (int idx = tid; idx < f.ps * V; idx += NT) {
      uint8_t* at = static_cast<uint8_t*>(pool) + base + (size_t)(idx / V) * f.KV * DKP +
                    idx % V * 8;
      uint2 w = *reinterpret_cast<const uint2*>(at);
      uint8_t* b = reinterpret_cast<uint8_t*>(&w);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        if constexpr (KIND == kPoolInt8) {
          b[i] = (uint8_t)(int8_t)rintf(__fmul_rn(float(int8_t(b[i])), ratio));
        } else {
          const float lo = rintf(__fmul_rn(float(int(b[i] & 0xF) - 8), ratio));
          const float hi = rintf(__fmul_rn(float(int((b[i] >> 4) & 0xF) - 8), ratio));
          b[i] = serial_pack(lo, hi);
        }
      }
      *reinterpret_cast<uint2*>(at) = w;
    }
  }
  __syncthreads();

  for (int idx = tid; idx < C * V; idx += NT) {
    const int c = idx / V, j0 = idx % V * 8;
    const float den = fmaxf(sNew[sLead[c]], 1e-30f);
    const TQ* v = rowv + c * line_stride;
    float x[8], y[8];
    load_f32<TQ, 8>(v + j0, x);
    if constexpr (KIND == kPoolInt4) load_f32<TQ, 8>(v + j0 + DK / 2, y);
    uint2 w;
    uint8_t* b = reinterpret_cast<uint8_t*>(&w);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float qx = fminf(fmaxf(rintf(__fdiv_rn(x[i], den)), -qmax), qmax);
      if constexpr (KIND == kPoolInt8) {
        b[i] = (uint8_t)(int8_t)qx;
      } else {
        const float qy = fminf(fmaxf(rintf(__fdiv_rn(y[i], den)), -qmax), qmax);
        b[i] = serial_pack(qx, qy);
      }
    }
    *reinterpret_cast<uint2*>(static_cast<uint8_t*>(pool) +
                              pool_row<KIND, DK>(sPage[c], of[c], h, f.ps, f.KV) + j0) = w;
  }
  for (int c = tid; c < C; c += NT) {
    if (sLead[c] == c) scale[(size_t)sPage[c] * f.KV + h] = sNew[c];
  }
  __syncthreads();
}

template <int KIND, int DK>
__device__ void serial_sweep(const SerialArgs& f, int h, int first, int stride, int P1) {
  constexpr int DKP = DK / pack_of<KIND>();
  constexpr uint8_t kZero = KIND == kPoolInt4 ? 0x88 : 0x00;
  const int lines = f.R * f.C;
  for (int page = first; page < P1; page += stride) {
    int touched = 0;
    for (int i = threadIdx.x; i < lines; i += kSerialThreads) touched |= f.phys[i] == page;
    if (__syncthreads_or(touched)) continue;
    const size_t sidx = (size_t)page * f.KV + h;
    for (int which = 0; which < 2; ++which) {
      const float* sc = which ? f.v_scale : f.k_scale;
      if (sc[sidx] != 0.f) continue;
      uint8_t* pool = static_cast<uint8_t*>(which ? f.v_pool : f.k_pool);
      for (int idx = threadIdx.x; idx < f.ps * DKP; idx += kSerialThreads)
        pool[pool_row<KIND, DK>(page, idx / DKP, h, f.ps, f.KV) + idx % DKP] = kZero;
    }
  }
}

template <typename TQ, int KIND, int DK>
__global__ void __launch_bounds__(kSerialThreads)
serial_commit_kernel(SerialArgs f, int P1, int sweep) {
  const int h = blockIdx.x, r = blockIdx.y;
  if (r >= f.R) {
    serial_sweep<KIND, DK>(f, h, r - f.R, sweep, P1);
    return;
  }
  extern __shared__ __align__(16) unsigned char smem[];
  const int C = f.C;
  float* lq = reinterpret_cast<float*>(smem);
  int* page = reinterpret_cast<int*>(lq + C);
  int* lead = page + C;
  float* nw = reinterpret_cast<float*>(lead + C);
  float* ratio = nw + C;
  serial_lines<TQ, KIND, DK>(f, r, h, static_cast<const TQ*>(f.k), f.k_pool, f.k_scale, lq,
                             page, lead, nw, ratio);
  serial_lines<TQ, KIND, DK>(f, r, h, static_cast<const TQ*>(f.v), f.v_pool, f.v_scale, lq,
                             page, lead, nw, ratio);
}

template <typename TQ, int KIND, int DK>
cudaError_t launch(const SerialArgs& f, int P1, int sweep, cudaStream_t stream) {
  const size_t smem = 20 * size_t(f.C);
  cudaError_t err = cudaFuncSetAttribute(serial_commit_kernel<TQ, KIND, DK>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(f.KV, f.R + sweep);
  serial_commit_kernel<TQ, KIND, DK><<<grid, kSerialThreads, smem, stream>>>(f, P1, sweep);
  return cudaGetLastError();
}

template <typename TQ, int KIND>
cudaError_t launch_kind(const SerialArgs& f, int dk, int P1, int sweep, cudaStream_t s) {
  if (dk == 64) return launch<TQ, KIND, 64>(f, P1, sweep, s);
  if (dk == 80) return launch<TQ, KIND, 80>(f, P1, sweep, s);
  if (dk == 128) return launch<TQ, KIND, 128>(f, P1, sweep, s);
  if (dk == 256) return launch<TQ, KIND, 256>(f, P1, sweep, s);
  return cudaErrorInvalidValue;
}

template <typename TQ>
cudaError_t launch_q(const SerialArgs& f, int dk, int pool_kind, int P1, int sweep,
                     cudaStream_t s) {
  if (pool_kind == kPoolInt8) return launch_kind<TQ, kPoolInt8>(f, dk, P1, sweep, s);
  if (pool_kind == kPoolInt4) return launch_kind<TQ, kPoolInt4>(f, dk, P1, sweep, s);
  return cudaErrorInvalidValue;
}

}  // namespace
}  // namespace fft

// The arguments of paged_commit_launch, with int32 phys and off.
extern "C" int paged_commit_serial_launch(const void* k, const void* v, void* k_pool,
                                          void* v_pool, void* k_scale, void* v_scale,
                                          const void* phys, const void* off, int R, int C,
                                          int KV, int dk, int ps, int P1, int dtype,
                                          int pool_kind, int whole_pool, float qmax,
                                          void* stream) {
  if (R <= 0 || C <= 0 || C > fft::kSerialMaxLines || KV <= 0 || P1 <= 0 || ps <= 0 ||
      KV > 65535)
    return (int)cudaErrorInvalidValue;
  const int sweep = whole_pool ? (P1 < 1024 ? P1 : 1024) : 0;
  if (R + sweep > 65535) return (int)cudaErrorInvalidValue;
  const fft::SerialArgs f{k, v, k_pool, v_pool, static_cast<float*>(k_scale),
                          static_cast<float*>(v_scale), static_cast<const int*>(phys),
                          static_cast<const int*>(off), R, C, KV, ps, qmax};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == fft::kBFloat16) return (int)fft::launch_q<__nv_bfloat16>(f, dk, pool_kind, P1, sweep, s);
  if (dtype == fft::kFloat32) return (int)fft::launch_q<float>(f, dk, pool_kind, P1, sweep, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
