// Tiles shared by the training flash-attention kernels
// (flash_attention_fwd.cu, flash_attention_bwd.cu): the f32 kernels' tile
// shape, the loader of a head's rows from the (B, S, H, dk) layout into
// shared memory, the 4 x 4 register-blocked score product (summed over dk
// in chunks of 32), and the
// causal rule (the bf16 kernels, on wgmma, use hopper.cuh and their own
// tiles).
//
// The f32 kernels work on tiles of 64 query rows and 64 key lines and run
// 256 threads on the CUDA cores: in the score phase thread t
// owns rows i0 .. i0 + 3 of the query
// tile (i0 = 4 * (t / 16)) and lines tx, tx + 16, tx + 32, tx + 48 of the
// key tile (tx = t % 16): the 16 threads sharing a row group are 16
// consecutive lanes of one warp, so a row's max and sum reduce with four
// shuffles. Tiles live in shared memory as f32 with rows padded by 4
// floats, so the lanes of a quarter-warp reading 4 consecutive floats of
// 8 different lines hit 32 different banks.
#pragma once

#include "mma.cuh"

namespace fft {
namespace flash {

constexpr int kRows = 64;      // query rows per tile
constexpr int kLines = 64;     // key lines per tile
constexpr int kThreads = 256;
constexpr int kLanes = 16;     // threads sharing a row group
constexpr int kLdP = kLines + 4;  // row stride of a (rows x lines) tile

template <int DK>
struct Ld {
  static constexpr int kRow = DK + 4;  // row stride of a (rows x dk) tile
};

// Rows [r0, r0 + NROWS) of one head — element (r, d) at base[r * rstride
// + d] — into dst as f32 with row stride DK + 4; rows at or past n read
// as zeros (the JAX kernels zero the rows of a padded block the same way).
// base and rstride keep each row 16-byte aligned.
template <typename T, int DK, int NROWS>
__device__ __forceinline__ void load_rows(float* __restrict__ dst,
                                          const T* __restrict__ base, int r0,
                                          int n, size_t rstride) {
  constexpr int kVec = 16 / int(sizeof(T));  // elements per 16-byte load
  constexpr int kPerRow = DK / kVec;
  for (int idx = threadIdx.x; idx < NROWS * kPerRow; idx += kThreads) {
    const int r = idx / kPerRow, d = (idx % kPerRow) * kVec;
    float x[kVec];
    if (r0 + r < n) {
      load_f32<T, kVec>(base + (size_t)(r0 + r) * rstride + d, x);
    } else {
#pragma unroll
      for (int e = 0; e < kVec; ++e) x[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < kVec; e += 4)
      *reinterpret_cast<float4*>(dst + r * Ld<DK>::kRow + d + e) =
          make_float4(x[e], x[e + 1], x[e + 2], x[e + 3]);
  }
}

// acc[a][b] = dot(X row i0 + a, Y row tx + 16 b) over dk, both tiles with
// row stride DK + 4. Each 32 dims' partial dot goes into a fresh
// accumulator, added into the total once a chunk: one f32 running sum over
// all dk terms was several times less accurate than cuBLAS's, and the
// backward's ds = p * (dp - delta) cancels to that error where dp and
// delta nearly agree.
template <int DK>
__device__ __forceinline__ void dot_tile(const float* __restrict__ X,
                                         const float* __restrict__ Y, int i0,
                                         int tx, float (&acc)[4][4]) {
  constexpr int L = Ld<DK>::kRow;
  constexpr int kChunk = 32;
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) acc[a][b] = 0.f;
#pragma unroll 1
  for (int d0 = 0; d0 < DK; d0 += kChunk) {
    float part[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) part[a][b] = 0.f;
#pragma unroll 4
    for (int d = d0; d < d0 + kChunk; d += 4) {
      float4 xv[4], yv[4];
#pragma unroll
      for (int a = 0; a < 4; ++a)
        xv[a] = *reinterpret_cast<const float4*>(X + (i0 + a) * L + d);
#pragma unroll
      for (int b = 0; b < 4; ++b)
        yv[b] = *reinterpret_cast<const float4*>(Y + (tx + kLanes * b) * L + d);
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          float x = part[a][b];
          x = fmaf(xv[a].x, yv[b].x, x);
          x = fmaf(xv[a].y, yv[b].y, x);
          x = fmaf(xv[a].z, yv[b].z, x);
          x = fmaf(xv[a].w, yv[b].w, x);
          part[a][b] = x;
        }
    }
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) acc[a][b] += part[a][b];
  }
}

// Whether query row r attends key line c: both inside their sequences
// and, when causal, c at or left of r (the top-left rule qpos >= kpos of
// the JAX kernels, for S != T too).
__device__ __forceinline__ bool attends(int r, int c, int S, int T, int causal) {
  return r < S && c < T && (!causal || r >= c);
}

template <typename Kernel>
cudaError_t set_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace flash
}  // namespace fft
