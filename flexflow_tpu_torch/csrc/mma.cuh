// Tensor-core fragments and asynchronous copies shared by the
// tensor-core kernels: the mixed-step tile of the paged kernels
// (paged_attention.cuh, bf16 and f32 q) and the whole-step kernel's
// projections (whole_step_decode.cu); the training flash-attention
// kernels, on wgmma (hopper.cuh), take its softmax helpers and its
// accumulator-to-A-fragment split.
//
// mma.sync.m16n8k16 bf16 with f32 accumulation. In a warp, lane = 4 g + t
// holds row g (and g + 8) of an A or C fragment and column g of a B
// fragment. Operands stay bf16 in shared memory with rows padded by 8
// elements, so the 32-bit fragment reads of a warp (8 rows x 4 words)
// and the 16-byte rows of an ldmatrix (8 rows x 16 bytes) hit 32
// different banks. f32 values (probabilities, score gradients) enter an
// mma as a hi + lo pair of bf16 operands: their f32 value to ~2^-16.
//
// f32 products run as mma.sync.m16n8k8 TF32 in three products (3xTF32:
// each operand split into TF32 hi + lo, lo * hi + hi * lo + hi * hi),
// within ~2^-22 of an f32 product; one TF32 product alone keeps ~2^-11.
#pragma once

#include "common.cuh"

namespace fft {

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// 2^x, subnormal results flushed to 0 (a probability under 2^-126 adds
// nothing a bf16 output can show)
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// the maximum and the sum of x as trees (short dependency chains); x is
// overwritten
template <int N>
__device__ __forceinline__ float tree_max(float (&x)[N]) {
#pragma unroll
  for (int w = N / 2; w > 0; w /= 2)
#pragma unroll
    for (int i = 0; i < w; ++i) x[i] = fmaxf(x[i], x[i + w]);
  return x[0];
}

template <int N>
__device__ __forceinline__ float tree_sum(float (&x)[N]) {
#pragma unroll
  for (int w = N / 2; w > 0; w /= 2)
#pragma unroll
    for (int i = 0; i < w; ++i) x[i] += x[i + w];
  return x[0];
}

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

// c += a (16 x 8, row-major fragments) * b (8 x 8, column fragments), TF32
// operands (f32 bit patterns whose low 13 mantissa bits are 0) and f32
// accumulation. Lane 4 g + t holds a[0] = (g, t), a[1] = (g + 8, t),
// a[2] = (g, t + 4), a[3] = (g + 8, t + 4); b0 = (t, g), b1 = (t + 4, g);
// c as for m16n8k16.
__device__ __forceinline__ void mma1688_tf32(float (&c)[4], const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// x rounded to TF32, to nearest with ties away from zero
__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t y;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(y) : "f"(x));
  return y;
}

// x ≈ hi + lo, each TF32: hi = x rounded, lo = the rest (exact in f32)
// rounded; their sum is x to ~2^-22 relative
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

// c += a * b in f32 on the TF32 tensor cores ("3xTF32"): a arrives split
// (ah + al), b0 and b1 as f32 values. b is split too and the two small
// products go into the accumulator before the large one (as CUTLASS's
// OpMultiplyAddFastF32 orders them); with EXACT, b is already TF32 (a
// quantized code: at most 8 significant bits) and takes al * b, ah * b.
template <bool EXACT>
__device__ __forceinline__ void mma_3xtf32(float (&c)[4], const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4], float b0, float b1) {
  if constexpr (EXACT) {
    mma1688_tf32(c, al, __float_as_uint(b0), __float_as_uint(b1));
    mma1688_tf32(c, ah, __float_as_uint(b0), __float_as_uint(b1));
  } else {
    uint32_t h0, l0, h1, l1;
    split_tf32(b0, h0, l0);
    split_tf32(b1, h1, l1);
    mma1688_tf32(c, al, h0, h1);
    mma1688_tf32(c, ah, l0, l1);
    mma1688_tf32(c, ah, h0, h1);
  }
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

// The B fragments (k0 .. k0 + 15) x (n0 .. n0 + 15) of B = tile^T, where the
// tile is row-major (n, k) with row stride L: b[0], b[1] for columns
// n0 .. n0 + 7 and b[2], b[3] for n0 + 8 .. n0 + 15, by one ldmatrix (lane
// l gives the address of row n0 + l % 8 + 8 (l / 16), column k0 + 8 (l / 8
// % 2)). Rows are 16-byte aligned.
template <int L>
__device__ __forceinline__ void load_b_x4(const __nv_bfloat16* tile, int n0, int k0,
                                          int lane, uint32_t (&b)[4]) {
  const __nv_bfloat16* p = tile + (n0 + (lane & 7) + 8 * (lane >> 4)) * L + k0 + 8 * ((lane >> 3) & 1);
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(b[0]), "=r"(b[1]), "=r"(b[2]), "=r"(b[3])
               : "r"(s));
}

// The B fragments (k0 .. k0 + 15) x (n0 .. n0 + 15) of B = the tile itself,
// row-major (k, n) with row stride L: b[0], b[1] for columns n0 .. n0 + 7
// and b[2], b[3] for n0 + 8 .. n0 + 15, by one transposing ldmatrix
// (lane l gives the address of row k0 + l % 16, column n0 + 8 (l / 16)).
// Rows are 16-byte aligned.
template <int L>
__device__ __forceinline__ void load_b_trans(const __nv_bfloat16* tile, int k0, int n0,
                                             int lane, uint32_t (&b)[4]) {
  const __nv_bfloat16* p = tile + (k0 + (lane & 15)) * L + n0 + 8 * (lane >> 4);
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(b[0]), "=r"(b[1]), "=r"(b[2]), "=r"(b[3])
               : "r"(s));
}

// 16 bytes from global to shared memory through L2 (cp.async.cg); with
// src_bytes 0 the destination is zero-filled and gmem not read.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes = 16) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most N committed groups of this thread are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

}  // namespace fft
