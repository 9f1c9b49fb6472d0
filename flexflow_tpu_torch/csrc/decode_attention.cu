// decode_attention — one query token per request slot against its dense
// KV-cache prefix, for sm_90a.
//
// Replaces the Pallas TPU kernel flexflow_tpu/serve/kernels.py
// decode_attention (body _decode_kernel). Same function: q (R, H, dk)
// attends lines [0, seq_len) of k/v (R, S1, KV, dk); grouped-query heads
// h = kv * G + g share KV head kv; f32 online softmax; the denominator is
// clamped at 1e-20, so a slot with seq_len 0 writes zeros. Output in q's
// dtype (float32 or bfloat16).
//
// Bound on an H100: the bytes of the K/V lines read,
// 2 * sum(seq_len) * KV * dk * itemsize, over 3.35 TB/s. With one query
// token per line the arithmetic is ~2 FLOP per byte, far below the ~295
// FLOP/byte where the tensor cores would become the limit.
//
// Design against that bound:
//  * It reads only lines < seq_len. The TPU kernel DMAs every block of
//    the cache and skips only the compute of invalid blocks.
//  * One thread block per (slot, KV head, group of up to 8 query heads):
//    the G query heads of a group sit in registers and every K/V line is
//    read from device memory once for all of them.
//  * The block's 8 warps split the lines: warp w takes lines 4w..4w+3,
//    then 32 lines further on, and so on. A lane holds dk/32 consecutive
//    elements of a line, so a warp reads each line as one coalesced
//    segment, four lines in flight at a time. Scores reduce with warp
//    shuffles and each warp keeps its own online softmax (max, sum,
//    accumulator) in registers; the 8 partial results merge once through
//    shared memory at the end.
//  * No tensor cores, TMA or split-K across blocks: with R * KV blocks
//    (512 at LLaMA-7B with 16 slots) the card is filled already; those
//    are for later work.
#include "common.cuh"

namespace fft {
namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kLines = 4;  // lines per warp per iteration

template <typename T, int DK, int GB>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const int* __restrict__ seq_lens,
              T* __restrict__ out, int S1, int H, int KV, float scale) {
  constexpr int E = DK / 32;  // elements per lane
  const int g_blk = blockIdx.x, h = blockIdx.y, r = blockIdx.z;
  const int G = H / KV;
  const int g0 = g_blk * GB;
  const int gc = min(GB, G - g0);  // query heads of this block
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int len = max(0, min(seq_lens[r], S1));

  float qr[GB][E];
#pragma unroll
  for (int g = 0; g < GB; ++g) {
    if (g < gc) {
      load_f32<T, E>(q + ((size_t)r * H + (size_t)h * G + g0 + g) * DK + lane * E, qr[g]);
#pragma unroll
      for (int e = 0; e < E; ++e) qr[g][e] *= scale;
    } else {
#pragma unroll
      for (int e = 0; e < E; ++e) qr[g][e] = 0.f;
    }
  }
  float m[GB], l[GB], acc[GB][E];
#pragma unroll
  for (int g = 0; g < GB; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[g][e] = 0.f;
  }

  const size_t line_stride = (size_t)KV * DK;
  const size_t base = ((size_t)r * S1 * KV + h) * DK + lane * E;
  for (int s0 = warp * kLines; s0 < len; s0 += kWarps * kLines) {
    float kr[kLines][E], vr[kLines][E];
#pragma unroll
    for (int u = 0; u < kLines; ++u) {
      if (s0 + u < len) {
        load_f32<T, E>(k + base + (size_t)(s0 + u) * line_stride, kr[u]);
        load_f32<T, E>(v + base + (size_t)(s0 + u) * line_stride, vr[u]);
      } else {
#pragma unroll
        for (int e = 0; e < E; ++e) kr[u][e] = vr[u][e] = 0.f;
      }
    }
#pragma unroll
    for (int g = 0; g < GB; ++g) {
      if (g >= gc) continue;  // block-uniform: the shuffles stay converged
      float sc[kLines];
      float mx = m[g];
#pragma unroll
      for (int u = 0; u < kLines; ++u) {
        float part = 0.f;
#pragma unroll
        for (int e = 0; e < E; ++e) part = fmaf(qr[g][e], kr[u][e], part);
        part = warp_sum(part);
        sc[u] = (s0 + u < len) ? part : kNegInf;
        mx = fmaxf(mx, sc[u]);
      }
      const float corr = expf(m[g] - mx);
      float p[kLines];
      float psum = 0.f;
#pragma unroll
      for (int u = 0; u < kLines; ++u) {
        p[u] = (s0 + u < len) ? expf(sc[u] - mx) : 0.f;
        psum += p[u];
      }
      l[g] = l[g] * corr + psum;
      m[g] = mx;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        float a = acc[g][e] * corr;
#pragma unroll
        for (int u = 0; u < kLines; ++u) a = fmaf(p[u], vr[u][e], a);
        acc[g][e] = a;
      }
    }
  }

  // merge the warps' partial softmax states
  __shared__ float sm_m[kWarps][GB];
  __shared__ float sm_l[kWarps][GB];
  __shared__ float sm_acc[kWarps][GB][DK];
#pragma unroll
  for (int g = 0; g < GB; ++g) {
    if (lane == 0) {
      sm_m[warp][g] = m[g];
      sm_l[warp][g] = l[g];
    }
#pragma unroll
    for (int e = 0; e < E; ++e) sm_acc[warp][g][lane * E + e] = acc[g][e];
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < gc * DK; idx += kThreads) {
    const int g = idx / DK, d = idx % DK;
    float M = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) M = fmaxf(M, sm_m[w][g]);
    float L = 0.f, O = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float f = expf(sm_m[w][g] - M);
      L = fmaf(sm_l[w][g], f, L);
      O = fmaf(sm_acc[w][g][d], f, O);
    }
    out[((size_t)r * H + (size_t)h * G + g0 + g) * DK + d] =
        from_f32<T>(O / fmaxf(L, kMinDenominator));
  }
}

template <typename T, int DK, int GB>
void launch_gb(const void* q, const void* k, const void* v, const int* seq_lens,
               void* out, int R, int S1, int H, int KV, float scale,
               cudaStream_t stream) {
  const int G = H / KV;
  dim3 grid((G + GB - 1) / GB, KV, R);
  decode_kernel<T, DK, GB><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), seq_lens, static_cast<T*>(out), S1, H, KV, scale);
}

template <typename T, int DK>
void launch_dk(const void* q, const void* k, const void* v, const int* seq_lens,
               void* out, int R, int S1, int H, int KV, float scale,
               cudaStream_t stream) {
  const int G = H / KV;
  if (G >= 8) {
    launch_gb<T, DK, 8>(q, k, v, seq_lens, out, R, S1, H, KV, scale, stream);
  } else if (G >= 4) {
    launch_gb<T, DK, 4>(q, k, v, seq_lens, out, R, S1, H, KV, scale, stream);
  } else if (G >= 2) {
    launch_gb<T, DK, 2>(q, k, v, seq_lens, out, R, S1, H, KV, scale, stream);
  } else {
    launch_gb<T, DK, 1>(q, k, v, seq_lens, out, R, S1, H, KV, scale, stream);
  }
}

template <typename T>
cudaError_t launch_t(const void* q, const void* k, const void* v,
                     const int* seq_lens, void* out, int R, int S1, int H,
                     int KV, int dk, float scale, cudaStream_t stream) {
  if (dk == 64) {
    launch_dk<T, 64>(q, k, v, seq_lens, out, R, S1, H, KV, scale, stream);
  } else if (dk == 128) {
    launch_dk<T, 128>(q, k, v, seq_lens, out, R, S1, H, KV, scale, stream);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace
}  // namespace fft

extern "C" int decode_attention_launch(const void* q, const void* k,
                                       const void* v, const void* seq_lens,
                                       void* out, int R, int S1, int H, int KV,
                                       int dk, int dtype, float scale,
                                       void* stream) {
  if (R <= 0 || KV <= 0 || H % KV != 0) return (int)cudaErrorInvalidValue;
  const int* sl = static_cast<const int*>(seq_lens);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == fft::kBFloat16) {
    err = fft::launch_t<__nv_bfloat16>(q, k, v, sl, out, R, S1, H, KV, dk, scale, s);
  } else if (dtype == fft::kFloat32) {
    err = fft::launch_t<float>(q, k, v, sl, out, R, S1, H, KV, dk, scale, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return (int)err;
}

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
