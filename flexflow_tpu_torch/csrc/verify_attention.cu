// verify_attention — C query tokens per request slot against the dense KV
// cache under an explicit boolean mask, for sm_90a.
//
// Replaces the Pallas TPU kernel flexflow_tpu/serve/kernels.py
// verify_attention (body _verify_kernel). Same function: q (R, C, H, dk)
// attends the lines of k/v (R, S1, KV, dk) that mask (R, C, S1) allows —
// the causal-by-position mask of chunked prefill and of the mixed
// continuous-batching step, or a speculation tree's bitmask. GQA heads
// h = kv * G + g share KV head kv; f32 online softmax per query row; the
// denominator is clamped at 1e-20, so a fully masked row writes zeros.
// Output in q's dtype (float32 or bfloat16).
//
// Bound on an H100: the larger of
//  * bytes: the K/V lines the mask reaches plus the mask and q/out bytes,
//    over 3.35 TB/s;
//  * operations: 4 * (attended (row, line) pairs) * G * dk FLOP (QK^T and
//    PV), over the rate of the unit that runs them. This kernel runs
//    them in f32 on the CUDA cores (67 TFLOP/s); bf16 tensor cores
//    (989 TFLOP/s) are the later step.
// A chunked-prefill step attends ~C/2 lines per query row on average,
// so at C = 128 it does ~60 FLOP per K/V byte: above the CUDA cores'
// ~20 FLOP/byte balance point, i.e. bound by operations.
//
// Design against that bound:
//  * One thread block per (slot, KV head, tile of 32 query rows), rows
//    numbered c * G + g so the G heads sharing one KV head share the
//    block and every K/V tile is loaded once for all of them.
//  * The block walks the cache in tiles of 64 lines. It first loads the
//    tile's mask bits and skips the tile when no row of the block
//    attends any of its lines (__syncthreads_or), as the TPU kernel
//    skips all-false mask blocks. Untouched tiles cost only the mask
//    read.
//  * K and V of a tile are staged once in shared memory as f32 with
//    16-byte vector loads. Each of the 128 threads owns 4 query rows:
//    it computes their scores against 4 lines of the tile (a 4 x 4
//    register block fed by float4 shared-memory reads, so each read
//    serves 4 FMAs) and accumulates their outputs in dk / 16 columns
//    each. The 16 threads that share 4 rows reduce the rows' max and
//    sum with 4 shuffles, and keep the f32 online softmax in registers.
//    K rows are padded by 4 floats so the 8 lanes of a quarter-warp
//    read 8 different lines from 32 different banks.
//  * No tensor-core mma/wgmma, TMA pipeline or split-K yet: the f32
//    CUDA-core version is the correct, simple first step, and its time
//    stands beside its bound in PERF.md.
#include "common.cuh"

namespace fft {
namespace {

constexpr int kRows = 32;                    // query rows per block
constexpr int kTile = 64;                    // cache lines per tile
constexpr int kThreads = 128;
constexpr int kLanesPerRowGroup = 16;        // threads sharing 4 rows
constexpr int kRowsPerThread = kRows / (kThreads / kLanesPerRowGroup);  // 4
constexpr int kLinesPerThread = kTile / kLanesPerRowGroup;              // 4

template <int DK>
struct Smem {
  static constexpr int kStrideK = DK + 4;     // padded: conflict-free reads
  static constexpr int kStrideP = kTile + 4;
  static constexpr size_t kK = size_t(kTile) * kStrideK;
  static constexpr size_t kV = size_t(kTile) * DK;
  static constexpr size_t kQ = size_t(kRows) * kStrideK;
  static constexpr size_t kP = size_t(kRows) * kStrideP;
  static constexpr size_t kBytes = sizeof(float) * (kK + kV + kQ + kP)
                                   + size_t(kRows) * kTile;  // mask bits
};

template <typename T, int DK>
__global__ void __launch_bounds__(kThreads)
verify_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const uint8_t* __restrict__ mask,
              T* __restrict__ out, int C, int S1, int H, int KV, float scale) {
  using L = Smem<DK>;
  constexpr int kCols = DK / kLanesPerRowGroup;  // output columns per thread
  constexpr int kVec = 16 / int(sizeof(T));      // elements per 16-byte load
  extern __shared__ __align__(16) float smem[];
  float* sK = smem;                // [kTile][DK + 4]
  float* sV = sK + L::kK;          // [kTile][DK]
  float* sQ = sV + L::kV;          // [kRows][DK + 4], pre-scaled
  float* sP = sQ + L::kQ;          // [kRows][kTile + 4]
  uint8_t* sM = reinterpret_cast<uint8_t*>(sP + L::kP);  // [kRows][kTile]

  const int row0 = blockIdx.x * kRows, h = blockIdx.y, r = blockIdx.z;
  const int G = H / KV;
  const int rows = C * G;
  const int tid = threadIdx.x;
  const int tx = tid % kLanesPerRowGroup;  // line / column group
  const int i0 = (tid / kLanesPerRowGroup) * kRowsPerThread;  // first own row

  for (int idx = tid; idx < kRows * DK; idx += kThreads) {
    const int ii = idx / DK, d = idx % DK, rr = row0 + ii;
    float x = 0.f;
    if (rr < rows) {
      const int c = rr / G, g = rr % G;
      x = to_f32<T>(q[(((size_t)r * C + c) * H + (size_t)h * G + g) * DK + d]) * scale;
    }
    sQ[ii * L::kStrideK + d] = x;
  }

  float m[kRowsPerThread], l[kRowsPerThread], acc[kRowsPerThread][kCols];
#pragma unroll
  for (int a = 0; a < kRowsPerThread; ++a) {
    m[a] = kNegInf;
    l[a] = 0.f;
#pragma unroll
    for (int e = 0; e < kCols; ++e) acc[a][e] = 0.f;
  }

  const uint8_t* mrow = mask + (size_t)r * C * S1;
  for (int t0 = 0; t0 < S1; t0 += kTile) {
    int any = 0;
    for (int idx = tid; idx < kRows * kTile; idx += kThreads) {
      const int ii = idx / kTile, j = idx % kTile;
      const int rr = row0 + ii, s = t0 + j;
      uint8_t bit = 0;
      if (rr < rows && s < S1) bit = mrow[(size_t)(rr / G) * S1 + s] != 0;
      sM[idx] = bit;
      any |= bit;
    }
    // also orders this tile's smem writes after the last tile's reads
    if (!__syncthreads_or(any)) continue;

    for (int idx = tid; idx < kTile * (DK / kVec); idx += kThreads) {
      const int j = idx / (DK / kVec), d = (idx % (DK / kVec)) * kVec;
      const int s = t0 + j;
      float kx[kVec], vx[kVec];
      if (s < S1) {
        const size_t off = (((size_t)r * S1 + s) * KV + h) * DK + d;
        load_f32<T, kVec>(k + off, kx);
        load_f32<T, kVec>(v + off, vx);
      } else {
#pragma unroll
        for (int e = 0; e < kVec; ++e) kx[e] = vx[e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < kVec; e += 4) {
        *reinterpret_cast<float4*>(sK + j * L::kStrideK + d + e) =
            make_float4(kx[e], kx[e + 1], kx[e + 2], kx[e + 3]);
        *reinterpret_cast<float4*>(sV + j * DK + d + e) =
            make_float4(vx[e], vx[e + 1], vx[e + 2], vx[e + 3]);
      }
    }
    __syncthreads();

    // scores of own rows i0 + a against lines tx + 16 b
    float sc[kRowsPerThread][kLinesPerThread];
#pragma unroll
    for (int a = 0; a < kRowsPerThread; ++a)
#pragma unroll
      for (int b = 0; b < kLinesPerThread; ++b) sc[a][b] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DK; d += 4) {
      float4 qv[kRowsPerThread], kv[kLinesPerThread];
#pragma unroll
      for (int a = 0; a < kRowsPerThread; ++a)
        qv[a] = *reinterpret_cast<const float4*>(sQ + (i0 + a) * L::kStrideK + d);
#pragma unroll
      for (int b = 0; b < kLinesPerThread; ++b)
        kv[b] = *reinterpret_cast<const float4*>(
            sK + (tx + kLanesPerRowGroup * b) * L::kStrideK + d);
#pragma unroll
      for (int a = 0; a < kRowsPerThread; ++a)
#pragma unroll
        for (int b = 0; b < kLinesPerThread; ++b) {
          float x = sc[a][b];
          x = fmaf(qv[a].x, kv[b].x, x);
          x = fmaf(qv[a].y, kv[b].y, x);
          x = fmaf(qv[a].z, kv[b].z, x);
          x = fmaf(qv[a].w, kv[b].w, x);
          sc[a][b] = x;
        }
    }

    // online softmax per own row; the row's 16 threads are 16
    // consecutive lanes of one warp
    float corr[kRowsPerThread];
#pragma unroll
    for (int a = 0; a < kRowsPerThread; ++a) {
      const uint8_t* mt = sM + (i0 + a) * kTile;
      float mx = m[a];
#pragma unroll
      for (int b = 0; b < kLinesPerThread; ++b) {
        if (!mt[tx + kLanesPerRowGroup * b]) sc[a][b] = kNegInf;
        mx = fmaxf(mx, sc[a][b]);
      }
#pragma unroll
      for (int off = kLanesPerRowGroup / 2; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      corr[a] = expf(m[a] - mx);
      float psum = 0.f;
      float* prow = sP + (i0 + a) * L::kStrideP;
#pragma unroll
      for (int b = 0; b < kLinesPerThread; ++b) {
        const int j = tx + kLanesPerRowGroup * b;
        const float p = mt[j] ? expf(sc[a][b] - mx) : 0.f;
        prow[j] = p;
        psum += p;
      }
#pragma unroll
      for (int off = kLanesPerRowGroup / 2; off > 0; off >>= 1)
        psum += __shfl_xor_sync(0xffffffffu, psum, off);
      l[a] = l[a] * corr[a] + psum;
      m[a] = mx;
    }
    __syncwarp();  // own rows' probabilities are written and read in-warp

    // PV: own rows x columns tx * 4 + e + 64 * hh
#pragma unroll
    for (int a = 0; a < kRowsPerThread; ++a)
#pragma unroll
      for (int e = 0; e < kCols; ++e) acc[a][e] *= corr[a];
#pragma unroll 4
    for (int j = 0; j < kTile; ++j) {
      float p[kRowsPerThread];
#pragma unroll
      for (int a = 0; a < kRowsPerThread; ++a) p[a] = sP[(i0 + a) * L::kStrideP + j];
#pragma unroll
      for (int hh = 0; hh < kCols / 4; ++hh) {
        const float4 vv = *reinterpret_cast<const float4*>(sV + j * DK + tx * 4 + 64 * hh);
#pragma unroll
        for (int a = 0; a < kRowsPerThread; ++a) {
          acc[a][4 * hh + 0] = fmaf(p[a], vv.x, acc[a][4 * hh + 0]);
          acc[a][4 * hh + 1] = fmaf(p[a], vv.y, acc[a][4 * hh + 1]);
          acc[a][4 * hh + 2] = fmaf(p[a], vv.z, acc[a][4 * hh + 2]);
          acc[a][4 * hh + 3] = fmaf(p[a], vv.w, acc[a][4 * hh + 3]);
        }
      }
    }
    __syncthreads();  // the next tile overwrites sK/sV/sP/sM
  }

#pragma unroll
  for (int a = 0; a < kRowsPerThread; ++a) {
    const int rr = row0 + i0 + a;
    if (rr >= rows) continue;
    const int c = rr / G, g = rr % G;
    const float inv = 1.f / fmaxf(l[a], kMinDenominator);
    T* o = out + (((size_t)r * C + c) * H + (size_t)h * G + g) * DK + tx * 4;
#pragma unroll
    for (int hh = 0; hh < kCols / 4; ++hh)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[64 * hh + e] = from_f32<T>(acc[a][4 * hh + e] * inv);
  }
}

template <typename T, int DK>
cudaError_t launch_dk(const void* q, const void* k, const void* v,
                      const uint8_t* mask, void* out, int R, int C, int S1,
                      int H, int KV, float scale, cudaStream_t stream) {
  constexpr size_t kSmem = Smem<DK>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      verify_kernel<T, DK>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmem);
  if (err != cudaSuccess) return err;
  const int rows = C * (H / KV);
  dim3 grid((rows + kRows - 1) / kRows, KV, R);
  verify_kernel<T, DK><<<grid, kThreads, kSmem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      mask, static_cast<T*>(out), C, S1, H, KV, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_t(const void* q, const void* k, const void* v,
                     const uint8_t* mask, void* out, int R, int C, int S1,
                     int H, int KV, int dk, float scale, cudaStream_t stream) {
  if (dk == 64) return launch_dk<T, 64>(q, k, v, mask, out, R, C, S1, H, KV, scale, stream);
  if (dk == 128) return launch_dk<T, 128>(q, k, v, mask, out, R, C, S1, H, KV, scale, stream);
  return cudaErrorInvalidValue;
}

}  // namespace
}  // namespace fft

extern "C" int verify_attention_launch(const void* q, const void* k,
                                       const void* v, const void* mask,
                                       void* out, int R, int C, int S1, int H,
                                       int KV, int dk, int dtype, float scale,
                                       void* stream) {
  if (R <= 0 || C <= 0 || KV <= 0 || H % KV != 0) return (int)cudaErrorInvalidValue;
  const uint8_t* mk = static_cast<const uint8_t*>(mask);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == fft::kBFloat16) {
    err = fft::launch_t<__nv_bfloat16>(q, k, v, mk, out, R, C, S1, H, KV, dk, scale, s);
  } else if (dtype == fft::kFloat32) {
    err = fft::launch_t<float>(q, k, v, mk, out, R, C, S1, H, KV, dk, scale, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return (int)err;
}

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
