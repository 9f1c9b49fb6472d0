// Tiles shared by the training flash-attention kernels
// (flash_attention_fwd.cu, flash_attention_bwd.cu): the tile shape, the
// loaders of a head's rows from the (B, S, H, dk) layout into shared
// memory, the 4 x 4 register-blocked score product of the f32 kernels and
// the mma.sync fragments of the bf16 kernels.
//
// Every kernel works on tiles of 64 query rows and 64 key lines. The f32
// kernels run 256 threads on the CUDA cores: in the score phase thread t
// owns rows i0 .. i0 + 3 of the query
// tile (i0 = 4 * (t / 16)) and lines tx, tx + 16, tx + 32, tx + 48 of the
// key tile (tx = t % 16): the 16 threads sharing a row group are 16
// consecutive lanes of one warp, so a row's max and sum reduce with four
// shuffles. Tiles live in shared memory as f32 with rows padded by 4
// floats, so the lanes of a quarter-warp reading 4 consecutive floats of
// 8 different lines hit 32 different banks.
#pragma once

#include "common.cuh"

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
// row stride DK + 4.
template <int DK>
__device__ __forceinline__ void dot_tile(const float* __restrict__ X,
                                         const float* __restrict__ Y, int i0,
                                         int tx, float (&acc)[4][4]) {
  constexpr int L = Ld<DK>::kRow;
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) acc[a][b] = 0.f;
#pragma unroll 4
  for (int d = 0; d < DK; d += 4) {
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
        float x = acc[a][b];
        x = fmaf(xv[a].x, yv[b].x, x);
        x = fmaf(xv[a].y, yv[b].y, x);
        x = fmaf(xv[a].z, yv[b].z, x);
        x = fmaf(xv[a].w, yv[b].w, x);
        acc[a][b] = x;
      }
  }
}

// Whether query row r attends key line c: both inside their sequences
// and, when causal, c at or left of r (the top-left rule qpos >= kpos of
// the JAX kernels, for S != T too).
__device__ __forceinline__ bool attends(int r, int c, int S, int T, int causal) {
  return r < S && c < T && (!causal || r >= c);
}

// ---------------------------------------------------------------------------
// Tensor-core tiles (bf16 inputs): 4 warps of 16 rows (or lines) each run
// mma.sync.m16n8k16 with f32 accumulation. Operands stay bf16 in shared
// memory with rows padded by 8 elements, so the 32-bit fragment reads of
// a warp (8 rows x 4 words) hit 32 different banks. Probabilities and
// score gradients, f32 in registers, enter an mma as a hi + lo pair of
// bf16 operands: their f32 value to ~2^-16, as the TPU kernels keep them
// in f32.

constexpr int kMmaThreads = 128;

template <int W>
struct LdH {
  static constexpr int kRow = W + 8;  // bf16 row stride of a W-wide tile
};

// c += a (16 x 16, row-major fragments) * b (16 x 8, column fragments)
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// (x0, x1) ≈ hi + lo, each a pair of bf16 (x0 in the low half)
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo) {
  __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  hi = *reinterpret_cast<uint32_t*>(&h);
  lo = pack_bf16(x0 - __low2float(h), x1 - __high2float(h));
}

// The A fragments (hi and lo) of a 16 x 16 block whose two 16 x 8 halves
// are the accumulators c0 (columns 0-7) and c1 (columns 8-15): an mma's
// output layout is the next mma's input layout.
__device__ __forceinline__ void acc_to_a(const float (&c0)[4], const float (&c1)[4],
                                         uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  split_bf16(c0[0], c0[1], hi[0], lo[0]);
  split_bf16(c0[2], c0[3], hi[1], lo[1]);
  split_bf16(c1[0], c1[1], hi[2], lo[2]);
  split_bf16(c1[2], c1[3], hi[3], lo[3]);
}

// The A fragment of rows m0 .. m0 + 15, columns k0 .. k0 + 15 of a
// row-major bf16 tile with row stride L.
template <int L>
__device__ __forceinline__ void load_a(const __nv_bfloat16* tile, int m0, int k0,
                                       int g, int t, uint32_t (&a)[4]) {
  const __nv_bfloat16* p = tile + (m0 + g) * L + k0 + 2 * t;
  a[0] = ld32(p);
  a[1] = ld32(p + 8 * L);
  a[2] = ld32(p + 8);
  a[3] = ld32(p + 8 * L + 8);
}

// The B fragment (k0 .. k0 + 15) x (n0 .. n0 + 7) of B = tile^T, where the
// tile is row-major (n, k) with row stride L: b0, b1.
template <int L>
__device__ __forceinline__ void load_b(const __nv_bfloat16* tile, int n0, int k0,
                                       int g, int t, uint32_t& b0, uint32_t& b1) {
  const __nv_bfloat16* p = tile + (n0 + g) * L + k0 + 2 * t;
  b0 = ld32(p);
  b1 = ld32(p + 8);
}

// Rows [r0, r0 + NROWS) of one bf16 head into dst with row stride DK + 8,
// zeros past n; transposed (dst (d, r) at d * (NROWS + 8) + r) with
// TRANSPOSE.
template <int DK, int NROWS, bool TRANSPOSE>
__device__ __forceinline__ void load_rows_bf16(__nv_bfloat16* __restrict__ dst,
                                               const __nv_bfloat16* __restrict__ base,
                                               int r0, int n, size_t rstride) {
  constexpr int kPerRow = DK / 8;  // 16-byte chunks per row
  for (int idx = threadIdx.x; idx < NROWS * kPerRow; idx += kMmaThreads) {
    // transposed: neighbouring threads take neighbouring rows, so their
    // 2-byte stores land side by side
    const int r = TRANSPOSE ? idx % NROWS : idx / kPerRow;
    const int d = (TRANSPOSE ? idx / NROWS : idx % kPerRow) * 8;
    uint4 x = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < n) x = *reinterpret_cast<const uint4*>(base + (size_t)(r0 + r) * rstride + d);
    if constexpr (TRANSPOSE) {
      const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&x);
#pragma unroll
      for (int j = 0; j < 8; ++j) dst[(d + j) * LdH<NROWS>::kRow + r] = e[j];
    } else {
      *reinterpret_cast<uint4*>(dst + r * LdH<DK>::kRow + d) = x;
    }
  }
}

template <typename Kernel>
cudaError_t set_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace flash
}  // namespace fft
