// wq_matmul — y = x @ dequantize(q, scale) for weight-only int8 / int4
// weights, for sm_90a.
//
// No TPU kernel of its own: the JAX package leaves dequantize + matmul to
// XLA, which fuses the convert-and-scale into the dot's operand read
// (flexflow_tpu/quantization.py:66 dequantize, the `_mm` / `_dense_w` of
// models/llama.py and models/transformer.py). Done plainly on the card
// (dequantize into a bf16 tensor, then a GEMM) every step would write and
// read back a bf16 copy of every weight: 1 + 2 + 2 bytes a weight for int8
// against 2 for a bf16 weight, so a quantized model would decode slower
// than the dense one. This kernel dequantizes inside the product.
//
// Function (the plain version is serve/kernels.wq_matmul_ref):
//   x (B or 1, M, K) bf16 or f32; q (B, K, N) int8 codes or (B, K / 2, N)
//   uint8 int4 nibble pairs (low nibble = even row, biased by 8); scale
//   (B, G, N) f32, row k at scale row k / (K / G); y (B, M, N) in x's type.
//   Each weight is dequantized as quantization.dequantize does it: the f32
//   code times the f32 scale, rounded once to x's type. Products
//   accumulate in f32 and round once to x's type. So the kernel and its
//   plain version differ in summation order alone. G > 1 is the expert
//   stack's down projection: the experts' (E * Fe, D) codes as one K, each
//   expert's rows at its own scale, summed in one f32 accumulator.
//
// Bound on an H100 (3.35 TB/s, 989 TFLOP/s bf16): at decode (M <= 16) the
// codes' bytes (int8 K * N, int4 K * N / 2; x and y are small); at M =
// 2048 the 2 M K N operations on the tensor cores.
//
// The launch plan (design, K slices, stage depth) comes from the caller
// (serve/kernels.wq_plan, a pure function of the shapes and the SM count);
// the launcher checks it and refuses a plan it cannot run.
//
// Designs (wq_matmul_design):
//   "splitk" (M <= 16, bf16 x: decode). The product runs transposed,
//     y^T = W^T x^T, so the weight is mma.sync m16n8k16's 16-row A operand
//     and M rides in its n8 dimension (two products for M > 8). A block
//     owns a strip of 128 columns and one K slice; the blocks of a K split
//     form a thread block cluster (at most 8). One producer warp streams
//     the slice by TMA into a ring (the plan's depth), each stage a code
//     box (128 columns x 128 code rows, 16 KB, 128-byte swizzle) and x's
//     rows of the same K (2 or 4 boxes of 64 k x 16 or 8 rows, swizzled):
//     x's slice reaches shared memory once per block, beside the codes.
//     Eight consumer warps,
//     two column halves x four phases, take the 16-deep K steps of a stage
//     in turn. A thread reads 8 code bytes a row (8 columns) from 4 rows of
//     a step (int8: rows 2t, 2t + 1, 2t + 8, 2t + 9, mma's own k order;
//     int4: code rows 2t, 2t + 1, each byte a k pair, so k runs 4t .. 4t +
//     3 for thread t and x's B fragment follows that order), conflict-free
//     through the swizzle. Column 8 g + 2 i + h of a half is fragment row
//     g + 8 h of the i-th 16-row A tile, so those bytes become A fragments
//     in registers with no transpose: a code turns into f32 by the
//     exponent trick (PRMT into 0x4B0000xx, one FADD; int4 one LOP3 or
//     shift for 4 codes first), one FMUL by its column's scale, and pairs
//     round to bf16 by cvt.rn.bf16x2.f32: int8 3.75 instructions a code
//     byte (PRMT, FADD, FMUL, half a CVT, a quarter LOP3), int4 7.75 (two
//     codes a byte, and a LOP3, a shift and a LOP3 a word), against M / 8
//     mma.sync a 256 codes. The four phases add
//     their partial sums in shared memory in phase order; then the
//     cluster's ranks read each other's partial sums through distributed
//     shared memory, each rank summing a share of the strip's outputs over
//     the ranks in rank order: one launch, deterministic from run to run.
//   "wgmma" (M > 16, bf16 x: mixed steps, chunked prefill). The product
//     runs transposed here too, on wgmma m64n256k16 with the dequantized
//     weight as its register A operand and x's rows as B: a block owns
//     128 weight columns x 256 rows of x, 64-deep K steps. Warpgroup 0's
//     first thread keeps TMA loads of x tiles (bf16, K-major, 128-byte
//     swizzle: wgmma's B as it lies) and code tiles (uint8, 128-byte
//     swizzle) in flight in a ring of 4 stages. Each of the two consumer
//     warpgroups owns 64 weight columns: a thread takes 2 adjacent columns
//     (its fragment rows g and g + 8) with one 2-byte load a code row
//     (int4: a byte is its k pair), dequantizes them into its A fragments
//     (each k16 against its own scale row, so a step may cross a scale
//     group) and issues the step's four products. No dequantized tile
//     goes through shared memory and no barrier joins the warps; A
//     fragments alternate between two register sets, so step j + 1
//     dequantizes while step j's products run. Every code is dequantized
//     once per 256 rows of x. Blocks walk the M tiles of a column strip
//     together, so a strip's codes stay in L2.
//   "rows" (M <= 16, f32 x; test-sized f32 models). A block of 256 threads
//     owns 32 columns and one K split; x's slice staged as f32, FMAs on the
//     CUDA cores; the splits' partial sums meet in a second launch
//     (wq_reduce_kernel) in split order.
//   "f32" (M > 16, f32 x): "rows" over tiles of 16 rows.
#include <cooperative_groups.h>

#include <climits>

#include <mutex>

#include "hopper.cuh"

namespace fft {
namespace {

namespace cg = cooperative_groups;

enum WqDesign : int { kWqRows = 0, kWqWgmma = 1, kWqF32 = 2, kWqSplitK = 3 };
constexpr int kWqRowsMax = 16;

inline int wq_design(int M, int dtype) {
  if (M <= kWqRowsMax) return dtype == kBFloat16 ? kWqSplitK : kWqRows;
  return dtype == kBFloat16 ? kWqWgmma : kWqF32;
}

// the f32 value of the biased byte in byte J of v: 0x4B0000bb is 2^23 + bb
template <int J>
__device__ __forceinline__ float biased_byte(uint32_t v) {
  return __uint_as_float(__byte_perm(v, 0x4B000000u, 0x7650 | J));
}

// ---------------------------------------------------------------------------
// "rows" and "f32" (f32 x): M <= MT rows a block (blockIdx.z tiles M by MT
// for "f32"), K split over blockIdx.y's splits

constexpr int kRowsThreads = 256;
constexpr int kRowsCols = 4;               // columns a thread (one 4-byte code load)
constexpr int kRowsTX = 8;                 // threads along N: 32-column strips
constexpr int kRowsStrip = kRowsCols * kRowsTX;
constexpr int kRowsTY = kRowsThreads / kRowsTX;  // threads along K
constexpr int kRowsDepth = 8;              // code loads a thread has in flight
constexpr int kRowsSplitMax = 1024;        // most K rows of a split: x's f32 slice in smem

inline int rows_tile(int M) { return M <= 1 ? 1 : M <= 2 ? 2 : M <= 4 ? 4 : M <= 8 ? 8 : 16; }

template <int BITS, int MT>
__global__ void __launch_bounds__(kRowsThreads, 2)
wq_rows_kernel(const float* __restrict__ x, const uint8_t* __restrict__ q,
               const float* __restrict__ scale, float* __restrict__ y,
               float* __restrict__ part_out, int M, int K, int N, int G, long long x_bstride,
               int S, int Ks) {
  constexpr int kRpc = BITS == 4 ? 2 : 1;                 // K rows a code row holds
  extern __shared__ __align__(16) unsigned char rows_smem[];
  float* xs = reinterpret_cast<float*>(rows_smem);        // [MT][Ks]: x's slice
  __shared__ float part[kRowsThreads / 32][MT][kRowsStrip];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tx = lane & 7;
  const int ty = warp * 4 + (lane >> 3);
  const int b = blockIdx.y / S, split = blockIdx.y % S;
  const int m0 = blockIdx.z * MT;
  const int rows = min(MT, M - m0);
  const int n = blockIdx.x * kRowsStrip + tx * kRowsCols;
  const bool col_ok = n < N;
  const int k_lo = split * Ks;
  const int kn = min(K, k_lo + Ks) - k_lo;                // a multiple of 32
  const long long CR = K / kRpc;
  x += b * x_bstride + (long long)m0 * K + k_lo;
  q += ((long long)b * CR + k_lo / kRpc) * N;
  scale += (long long)b * G * N;
  const int Kg = K / G;

  for (int i = tid; i < MT * (kn / 8); i += kRowsThreads) {
    const int m = i / (kn / 8), k = (i % (kn / 8)) * 8;
    float v[8];
    if (m < rows) {
      load_f32<float, 8>(x + (long long)m * K + k, v);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] = 0.f;
    }
    store8<float>(xs + m * Ks + k, v);
  }
  __syncthreads();

  float acc[MT][kRowsCols];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < kRowsCols; ++j) acc[m][j] = 0.f;
  float sc[kRowsCols];
  int cur_g = -1;
  const int ncr = kn / kRpc;                              // code rows of the split
  if (col_ok) {
    for (int base = 0; base < ncr; base += kRowsDepth * kRowsTY) {
      uint32_t raw[kRowsDepth];
#pragma unroll
      for (int u = 0; u < kRowsDepth; ++u) {
        const int r = base + ty + u * kRowsTY;
        raw[u] = r < ncr ? __ldg(reinterpret_cast<const unsigned int*>(q + (long long)r * N + n))
                         : 0u;
      }
#pragma unroll
      for (int u = 0; u < kRowsDepth; ++u) {
        const int r = base + ty + u * kRowsTY;
        if (r >= ncr) break;
        const int g = (k_lo + r * kRpc) / Kg;
        if (g != cur_g) {
          load_f32<float, kRowsCols>(scale + (long long)g * N + n, sc);
          cur_g = g;
        }
        const uint8_t* c = reinterpret_cast<const uint8_t*>(&raw[u]);
#pragma unroll
        for (int j = 0; j < kRowsCols; ++j) {
          if constexpr (BITS == 8) {
            const float w = __fmul_rn(float(int8_t(c[j])), sc[j]);
#pragma unroll
            for (int m = 0; m < MT; ++m)
              acc[m][j] = fmaf(xs[m * Ks + r], w, acc[m][j]);
          } else {
            const float w0 = __fmul_rn(float(int(c[j] & 15) - 8), sc[j]);
            const float w1 = __fmul_rn(float(int(c[j] >> 4) - 8), sc[j]);
#pragma unroll
            for (int m = 0; m < MT; ++m) {
              acc[m][j] = fmaf(xs[m * Ks + 2 * r], w0, acc[m][j]);
              acc[m][j] = fmaf(xs[m * Ks + 2 * r + 1], w1, acc[m][j]);
            }
          }
        }
      }
    }
  }
  // the 4 row-threads of a warp (lane bits 3..4), then the 8 warps
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < kRowsCols; ++j) {
      float v = acc[m][j];
      v += __shfl_xor_sync(0xffffffffu, v, 8);
      v += __shfl_xor_sync(0xffffffffu, v, 16);
      if ((lane >> 3) == 0) part[warp][m][tx * kRowsCols + j] = v;
    }
  __syncthreads();
  for (int i = tid; i < MT * kRowsStrip; i += kRowsThreads) {
    const int m = i / kRowsStrip, c = i % kRowsStrip;
    const int col = blockIdx.x * kRowsStrip + c;
    if (m >= rows || col >= N) continue;
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kRowsThreads / 32; ++w) s += part[w][m][c];
    const long long at = ((long long)b * M + m0 + m) * N + col;
    if (S == 1)
      y[at] = s;
    else  // the split's partial sum, [split][B][M][N]: wq_reduce_kernel adds them
      part_out[(long long)split * ((long long)(gridDim.y / S) * M * N) + at] = s;
  }
}

// y = the splits' partial sums added in split order
__global__ void wq_reduce_kernel(const float* __restrict__ part, float* __restrict__ y,
                                 long long total, int S) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (long long)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int k = 0; k < S; ++k) s += part[(long long)k * total + i];
    y[i] = s;
  }
}

// ---------------------------------------------------------------------------
// "splitk": bf16 x, M <= 16, on mma.sync with the weight as A; K split over
// the blocks of a cluster

namespace sk {
constexpr int kWarps = 8;                        // consumer warps: 2 column halves x 4 phases
constexpr int kThreads = 32 * (kWarps + 1);      // + the producer warp
constexpr int kCols = 128;                       // a strip: one 128-byte swizzled box row
constexpr int kBoxRows = 128;                    // code rows a stage
constexpr uint32_t kCodeBytes = kCols * kBoxRows;  // 16 KB
constexpr int kRedPitch = kCols + 1;             // partial sums' row pitch: 2-way stores
constexpr int kMinStages = 2;                    // the phases' partial sums reuse the ring
constexpr int kMaxStages = 6;
constexpr int kMaxCluster = 8;
}  // namespace sk

template <int BITS, int MT>
struct SkGeom {
  static constexpr int kRpc = BITS == 4 ? 2 : 1;
  static constexpr int kStageK = sk::kBoxRows * kRpc;   // K rows a stage: 128 / 256
  static constexpr int kSteps = kStageK / 16;           // 16-deep steps a stage: 8 / 16
  static constexpr int kWarpSteps = kSteps / 4;         // a phase's steps a stage: 2 / 4
  static constexpr int kStepBytes = 16 / kRpc * 128;    // code bytes of a step
  static constexpr int kLoads = BITS == 8 ? 4 : 2;      // 8-byte code loads a step
  static constexpr int kXBoxes = kStageK / 64;          // x boxes a stage (64 k x MT rows)
  static constexpr uint32_t kXBox = MT * 128;
  static constexpr uint32_t kStage = sk::kCodeBytes + kXBoxes * kXBox;
  static size_t smem(int R) { return 1024 + size_t(R) * kStage; }
};

__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(sk::kWarps * 32) : "memory");
}

// N consecutive columns' f32 scales (16-byte aligned), or zeros
template <int N>
__device__ __forceinline__ void load_sc(const float* p, bool ok, float (&sc)[N]) {
#pragma unroll
  for (int c = 0; c < N; c += 4) {
    const float4 v = ok ? __ldg(reinterpret_cast<const float4*>(p + c))
                        : make_float4(0.f, 0.f, 0.f, 0.f);
    sc[c] = v.x, sc[c + 1] = v.y, sc[c + 2] = v.z, sc[c + 3] = v.w;
  }
}

// One 16-deep K step of this thread's 8 columns: ``codes`` the step's
// first code row in the swizzled stage tile, ``xb`` the x box of its K;
// coff / xoff the thread's byte offsets in them (the same every step: a
// step starts on a multiple of 8 rows, so the swizzle repeats). int8: code
// rows 2t, 2t + 1, 2t + 8, 2t + 9 (mma's own k order); int4: code rows 2t,
// 2t + 1 (k 4t .. 4t + 3 of the step, low nibble first, and x's B fragment
// in that order). Column 8 g + 2 i + h of the half is fragment row g + 8 h
// of A tile i.
template <int BITS, int MT>
__device__ __forceinline__ void sk_step(const unsigned char* codes, const unsigned char* xb,
                                        const int (&coff)[SkGeom<BITS, MT>::kLoads],
                                        const int (&xoff)[MT / 8], const float (&sc)[8],
                                        float (&acc)[4][MT / 8][4]) {
  constexpr int kL = SkGeom<BITS, MT>::kLoads;
  uint2 L[kL];
#pragma unroll
  for (int qd = 0; qd < kL; ++qd) L[qd] = *reinterpret_cast<const uint2*>(codes + coff[qd]);
  uint32_t bx[MT / 8][2];
#pragma unroll
  for (int h8 = 0; h8 < MT / 8; ++h8) {
    if constexpr (BITS == 8) {  // k 2t, 2t + 1 and 2t + 8, 2t + 9: the next 16-byte chunk
      bx[h8][0] = *reinterpret_cast<const uint32_t*>(xb + xoff[h8]);
      bx[h8][1] = *reinterpret_cast<const uint32_t*>(xb + (xoff[h8] ^ 16));
    } else {
      const uint2 v = *reinterpret_cast<const uint2*>(xb + xoff[h8]);
      bx[h8][0] = v.x;
      bx[h8][1] = v.y;
    }
  }
#pragma unroll
  for (int wd = 0; wd < 2; ++wd) {  // code word wd: columns 4 wd .. 4 wd + 3, tiles 2 wd, 2 wd + 1
    float w[2][2][4];  // [k pair][k of the pair][column]
#pragma unroll
    for (int p = 0; p < 2; ++p)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        uint32_t v;
        float off;
        if constexpr (BITS == 8) {
          v = (wd ? L[2 * p + h].y : L[2 * p + h].x) ^ 0x80808080u;  // c + 128
          off = 8388736.f;
        } else {
          v = ((wd ? L[p].y : L[p].x) >> (4 * h)) & 0x0F0F0F0Fu;     // c + 8
          off = 8388616.f;
        }
        w[p][h][0] = __fmul_rn(biased_byte<0>(v) - off, sc[4 * wd + 0]);
        w[p][h][1] = __fmul_rn(biased_byte<1>(v) - off, sc[4 * wd + 1]);
        w[p][h][2] = __fmul_rn(biased_byte<2>(v) - off, sc[4 * wd + 2]);
        w[p][h][3] = __fmul_rn(biased_byte<3>(v) - off, sc[4 * wd + 3]);
      }
#pragma unroll
    for (int ti = 0; ti < 2; ++ti) {
      const int c0 = 2 * ti, c1 = 2 * ti + 1;
      const uint32_t a[4] = {pack_bf16(w[0][0][c0], w[0][1][c0]),
                             pack_bf16(w[0][0][c1], w[0][1][c1]),
                             pack_bf16(w[1][0][c0], w[1][1][c0]),
                             pack_bf16(w[1][0][c1], w[1][1][c1])};
#pragma unroll
      for (int h8 = 0; h8 < MT / 8; ++h8)
        mma16816(acc[2 * wd + ti][h8], a, bx[h8][0], bx[h8][1]);
    }
  }
}

template <int BITS, int MT>
__global__ void __launch_bounds__(sk::kThreads, 2)
wq_splitk_kernel(const __grid_constant__ CUtensorMap cmap, const __grid_constant__ CUtensorMap xmap,
                 const float* __restrict__ scale, __nv_bfloat16* __restrict__ y, int M, int K,
                 int N, int G, int Ks, int R, int x_batched) {
  using namespace hopper;
  using Geo = SkGeom<BITS, MT>;
  extern __shared__ unsigned char sk_raw[];
  __shared__ __align__(8) uint64_t full[sk::kMaxStages], empty[sk::kMaxStages];
  // the swizzle follows address bits 7-9: stages 1024-byte aligned
  unsigned char* ring = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(sk_raw) + 1023) & ~uintptr_t(1023));
  float* red = reinterpret_cast<float*>(ring);  // [4 phases][MT][kRedPitch], after the ring

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank(), S = (int)cluster.num_blocks();
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int b = blockIdx.z, n0 = blockIdx.y * sk::kCols;
  const int k_lo = rank * Ks, k_hi = min(K, k_lo + Ks);
  const int nsteps = k_hi > k_lo ? (k_hi - k_lo) / 16 : 0;
  const int nst = (nsteps * 16 + Geo::kStageK - 1) / Geo::kStageK;

  if (tid == 0) {
    for (int st = 0; st < R; ++st) {
      mbar_init(&full[st], 1);
      mbar_init(&empty[st], sk::kWarps);  // a lane of every consumer warp
    }
    fence_mbar_init();
  }
  __syncthreads();

  if (warp == sk::kWarps) {
    // producer: a stage is the slice's next code box and x's rows of its K;
    // phases of empty[st] start complete (parity 1 passes at once)
    if (lane == 0) {
      int st = 0;
      uint32_t par = 0;
      for (int j = 0; j < nst; ++j) {
        unsigned char* sp = ring + st * Geo::kStage;
        mbar_wait(&empty[st], par ^ 1);
        mbar_expect_tx(&full[st], Geo::kStage);
        tma_load_3d(sp, &cmap, &full[st], n0, k_lo / Geo::kRpc + j * sk::kBoxRows, b);
#pragma unroll
        for (int xb = 0; xb < Geo::kXBoxes; ++xb)
          tma_load_3d(sp + sk::kCodeBytes + xb * Geo::kXBox, &xmap, &full[st],
                      k_lo + j * Geo::kStageK + 64 * xb, 0, x_batched ? b : 0);
        if (++st == R) st = 0, par ^= 1;
      }
    }
  } else {
    // warp = 2 phase + half: columns 64 half .., steps phase + 4 u of a stage
    const int half = warp & 1, phase = warp >> 1;
    const int g = lane / 4, t = lane % 4;
    const int c8 = 8 * half + g;                // this thread's 8 columns: 8 c8 ..
    const bool col_ok = n0 + 8 * c8 < N;        // N % 16 == 0: all 8 or none
    const int Kg = K / G;
    const float* sc_col = scale + (long long)b * G * N + n0 + 8 * c8;
    int coff[Geo::kLoads], xoff[MT / 8];
#pragma unroll
    for (int qd = 0; qd < Geo::kLoads; ++qd) {
      const int row = BITS == 8 ? 2 * t + (qd & 1) + 8 * (qd >> 1) : 2 * t + qd;
      coff[qd] = row * 128 + (((c8 >> 1) ^ (row & 7)) << 4) + (c8 & 1) * 8;
    }
#pragma unroll
    for (int h8 = 0; h8 < MT / 8; ++h8)  // row g + 8 h8 of the box: its swizzle is g's
      xoff[h8] = (g + 8 * h8) * 128 +
                 (BITS == 8 ? (((2 * phase) ^ g) << 4) + 4 * t
                            : (((2 * phase + (t >> 1)) ^ g) << 4) + (t & 1) * 8);
    float sc[8];
    int k_next = INT_MIN;  // the next scale group's first row
    float acc[4][MT / 8][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int h8 = 0; h8 < MT / 8; ++h8)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][h8][e] = 0.f;
    int st = 0;
    uint32_t par = 0;
    for (int j = 0; j < nst; ++j) {
      const unsigned char* sp = ring + st * Geo::kStage;
      mbar_wait(&full[st], par);
#pragma unroll
      for (int u = 0; u < Geo::kWarpSteps; ++u) {
        const int ls = phase + 4 * u;  // the step within the stage: x box u
        const int k = k_lo + 16 * (j * Geo::kSteps + ls);
        if (k < k_hi) {
          if (k >= k_next) {  // a 16-deep step lies in one group
            const int grp = k / Kg;
            load_sc<8>(sc_col + (long long)grp * N, col_ok, sc);
            k_next = (grp + 1) * Kg;
          }
          sk_step<BITS, MT>(sp + ls * Geo::kStepBytes, sp + sk::kCodeBytes + u * Geo::kXBox,
                            coff, xoff, sc, acc);
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[st]);
      if (++st == R) st = 0, par ^= 1;
    }
    // the phases' partial sums over the finished ring, then added in phase
    // order into red[0]; output row m at fragment column m % 8 of product
    // m / 8
    consumers_sync();
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int h8 = 0; h8 < MT / 8; ++h8)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = 8 * c8 + 2 * i + (e >> 1), m = 8 * h8 + 2 * t + (e & 1);
          red[(phase * MT + m) * sk::kRedPitch + col] = acc[i][h8][e];
        }
    consumers_sync();
    for (int e = tid; e < MT * sk::kCols; e += sk::kWarps * 32) {
      const int at = e / sk::kCols * sk::kRedPitch + e % sk::kCols;
      float v = red[at];
#pragma unroll
      for (int p = 1; p < 4; ++p) v += red[p * MT * sk::kRedPitch + at];
      red[at] = v;
    }
  }
  __syncwarp();
  cluster.sync();  // every rank's partial sums are in its red[0]
  // rank r writes a share of the strip's outputs, each the ranks' partial
  // sums added in rank order
  for (int e = tid + rank * sk::kThreads; e < MT * sk::kCols; e += S * sk::kThreads) {
    const int m = e / sk::kCols, col = n0 + e % sk::kCols;
    if (m >= M || col >= N) continue;
    const int at = m * sk::kRedPitch + e % sk::kCols;
    float v = 0.f;
    for (int r = 0; r < S; ++r) v += cluster.map_shared_rank(red, r)[at];
    y[((long long)b * M + m) * N + col] = __float2bfloat16(v);
  }
  cluster.sync();  // no rank leaves while another reads its shared memory
}

// ---------------------------------------------------------------------------
// "wgmma": bf16 x, M > 16: y^T = W^T x^T on wgmma, the dequantized weight
// the register A operand

namespace wgq {
constexpr int kThreads = 384;                    // the producer warpgroup + 2 consumers
constexpr int kBM = 256, kBN = 128, kBK = 64;    // a consumer: 64 weight columns x 256 rows
constexpr int kStages = 4;
constexpr uint32_t kXBytes = kBM * kBK * 2;      // 32 KB
constexpr int kProducerRegs = 40, kConsumerRegs = 232;
}  // namespace wgq

template <int BITS>
struct WgGeom {
  static constexpr int kRpc = BITS == 4 ? 2 : 1;
  static constexpr int kCodeRows = wgq::kBK / kRpc;                 // 64 / 32
  static constexpr uint32_t kCodeBytes = kCodeRows * wgq::kBN;      // 8 / 4 KB
  static constexpr uint32_t kStage = wgq::kXBytes + kCodeBytes;    // multiples of 1 KB
  static constexpr size_t kSmem = 1024 + size_t(wgq::kStages) * kStage;
};

// d (64 x 256, f32) += a * b: A (64 x 16 bf16) in registers, in mma.sync's
// A fragment layout (warp w of the warpgroup: rows 16 w ..); B (16 x 256)
// K-major in shared memory (no transpose)
__device__ __forceinline__ void wgmma_rs_n256_k(float (&d)[32][4], const uint32_t (&a)[4],
                                                uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, {%128, %129, %130, %131}, %132, p, 1, 1, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
        "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
        "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3]),
        "+f"(d[16][0]), "+f"(d[16][1]), "+f"(d[16][2]), "+f"(d[16][3]),
        "+f"(d[17][0]), "+f"(d[17][1]), "+f"(d[17][2]), "+f"(d[17][3]),
        "+f"(d[18][0]), "+f"(d[18][1]), "+f"(d[18][2]), "+f"(d[18][3]),
        "+f"(d[19][0]), "+f"(d[19][1]), "+f"(d[19][2]), "+f"(d[19][3]),
        "+f"(d[20][0]), "+f"(d[20][1]), "+f"(d[20][2]), "+f"(d[20][3]),
        "+f"(d[21][0]), "+f"(d[21][1]), "+f"(d[21][2]), "+f"(d[21][3]),
        "+f"(d[22][0]), "+f"(d[22][1]), "+f"(d[22][2]), "+f"(d[22][3]),
        "+f"(d[23][0]), "+f"(d[23][1]), "+f"(d[23][2]), "+f"(d[23][3]),
        "+f"(d[24][0]), "+f"(d[24][1]), "+f"(d[24][2]), "+f"(d[24][3]),
        "+f"(d[25][0]), "+f"(d[25][1]), "+f"(d[25][2]), "+f"(d[25][3]),
        "+f"(d[26][0]), "+f"(d[26][1]), "+f"(d[26][2]), "+f"(d[26][3]),
        "+f"(d[27][0]), "+f"(d[27][1]), "+f"(d[27][2]), "+f"(d[27][3]),
        "+f"(d[28][0]), "+f"(d[28][1]), "+f"(d[28][2]), "+f"(d[28][3]),
        "+f"(d[29][0]), "+f"(d[29][1]), "+f"(d[29][2]), "+f"(d[29][3]),
        "+f"(d[30][0]), "+f"(d[30][1]), "+f"(d[30][2]), "+f"(d[30][3]),
        "+f"(d[31][0]), "+f"(d[31][1]), "+f"(d[31][2]), "+f"(d[31][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// the f32 weights of the two biased code bytes in the low half of v (the
// thread's two columns), each times its column's scale
__device__ __forceinline__ void wg_pair(uint32_t v, float off, const float (&sc)[2], float& w0,
                                        float& w1) {
  w0 = __fmul_rn(biased_byte<0>(v) - off, sc[0]);
  w1 = __fmul_rn(biased_byte<1>(v) - off, sc[1]);
}

template <int BITS>
__global__ void __launch_bounds__(wgq::kThreads, 1)
wq_wgmma_kernel(const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap cmap,
                const float* __restrict__ scale, __nv_bfloat16* __restrict__ y, int M, int K,
                int N, int G, int x_batched) {
  using namespace hopper;
  using Geo = WgGeom<BITS>;
  extern __shared__ unsigned char wg_raw[];
  __shared__ __align__(8) uint64_t full[wgq::kStages], empty[wgq::kStages];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(wg_raw) + 1023) & ~uintptr_t(1023));
  const int m0 = blockIdx.x * wgq::kBM, n0 = blockIdx.y * wgq::kBN, b = blockIdx.z;
  const int nk = (K + wgq::kBK - 1) / wgq::kBK;
  const int group = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int st = 0; st < wgq::kStages; ++st) {
      mbar_init(&full[st], 1);
      mbar_init(&empty[st], 8);  // a lane of every consumer warp
    }
    fence_mbar_init();
  }
  __syncthreads();

  if (group == 0) {
    reg_dealloc<wgq::kProducerRegs>();
    if (threadIdx.x == 0) {
      for (int j = 0; j < nk; ++j) {
        const int st = j % wgq::kStages;
        unsigned char* sp = smem + st * Geo::kStage;
        mbar_wait(&empty[st], ((j / wgq::kStages) & 1) ^ 1);
        mbar_expect_tx(&full[st], Geo::kStage);
        tma_load_3d(sp, &xmap, &full[st], j * wgq::kBK, m0, x_batched ? b : 0);
        tma_load_3d(sp + wgq::kXBytes, &cmap, &full[st], n0, j * Geo::kCodeRows, b);
      }
    }
  } else {
    reg_alloc<wgq::kConsumerRegs>();
    const int ct = threadIdx.x - 128, cw = ct / 32, lane = ct % 32;
    const int g = lane / 4, t = lane % 4;
    // this thread's columns: 2 g, 2 g + 1 of its warp's 16 (A fragment rows
    // g and g + 8), one 2-byte load a code row
    const int cb = 64 * (group - 1) + 16 * (cw % 4) + 2 * g;
    const int col = n0 + cb;
    const bool col_ok = col < N;  // N % 16 == 0: both columns or neither
    const float* sc_col = scale + (long long)b * G * N + col;
    const int Kg = K / G;
    float sc[2] = {0.f, 0.f};
    int k_next = INT_MIN;  // the next scale group's first row
    // the thread's code rows of a k16 in the swizzled tile (int8: 2t, 2t +
    // 1, 2t + 8, 2t + 9; int4: t, t + 4, each a k pair), the same every
    // k16: it starts on a multiple of 8 rows
    int coff[4];
#pragma unroll
    for (int qd = 0; qd < 4; ++qd) {
      const int row = BITS == 8 ? 2 * t + (qd & 1) + 8 * (qd >> 1) : t + 4 * (qd & 1);
      coff[qd] = row * 128 + (((cb >> 4) ^ (row & 7)) << 4) + (cb & 15);
    }
    float acc[32][4];
#pragma unroll
    for (int i = 0; i < 32; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
    // step j: its four k16 A fragments dequantized from the stage's codes
    // into aj (one of two sets: step j - 1's products may still read the
    // other), then four products against x's tile
    auto step = [&](int j, uint32_t (&aj)[4][4]) {
      const int st = j % wgq::kStages, k0 = j * wgq::kBK;
      const unsigned char* sp = smem + st * Geo::kStage;
      mbar_wait(&full[st], (j / wgq::kStages) & 1);
#pragma unroll
      for (int kk = 0; kk < wgq::kBK / 16; ++kk) {
        const int k = k0 + 16 * kk;  // a k16 lies in one scale group
        if (k >= k_next) {
          // a k row past K holds zeros (TMA's fill): any scale row will do
          const int grp = min(k / Kg, G - 1);
          if (col_ok) {
            const float2 v = __ldg(reinterpret_cast<const float2*>(sc_col + (long long)grp * N));
            sc[0] = v.x, sc[1] = v.y;
          }
          k_next = (grp + 1) * Kg;
        }
        const unsigned char* ck = sp + wgq::kXBytes + 16 / Geo::kRpc * kk * 128;
        float w[2][2][2];  // [k 2t.. / 2t + 8..][k of the pair][column 2g, 2g + 1]
        if constexpr (BITS == 8) {
#pragma unroll
          for (int qd = 0; qd < 4; ++qd)
            wg_pair(uint32_t(*reinterpret_cast<const uint16_t*>(ck + coff[qd])) ^ 0x8080u,
                    8388736.f, sc, w[qd >> 1][qd & 1][0], w[qd >> 1][qd & 1][1]);
        } else {
#pragma unroll
          for (int p = 0; p < 2; ++p) {
            const uint32_t v = *reinterpret_cast<const uint16_t*>(ck + coff[p]);
            wg_pair(v & 0x0F0Fu, 8388616.f, sc, w[p][0][0], w[p][0][1]);
            wg_pair((v >> 4) & 0x0F0Fu, 8388616.f, sc, w[p][1][0], w[p][1][1]);
          }
        }
        aj[kk][0] = pack_bf16(w[0][0][0], w[0][1][0]);  // row g (column 2g), k 2t, 2t + 1
        aj[kk][1] = pack_bf16(w[0][0][1], w[0][1][1]);  // row g + 8 (column 2g + 1)
        aj[kk][2] = pack_bf16(w[1][0][0], w[1][1][0]);  // k 2t + 8, 2t + 9
        aj[kk][3] = pack_bf16(w[1][0][1], w[1][1][1]);
      }
      fence_regs(acc);
      wgmma_fence();  // the A registers' writes before the products read them
#pragma unroll
      for (int kk = 0; kk < wgq::kBK / 16; ++kk)
        wgmma_rs_n256_k(acc, aj[kk], desc_sw128(sp + kk * 32, 16, 1024));
      wgmma_commit();
      wgmma_wait<1>();  // step j - 1's products are done: its registers and stage are free
      fence_regs(acc);
      if (j > 0 && lane == 0) mbar_arrive(&empty[(j - 1) % wgq::kStages]);
    };
    uint32_t a[2][4][4];
    int j = 0;
    for (; j + 1 < nk; j += 2) {
      step(j, a[0]);
      step(j + 1, a[1]);
    }
    if (j < nk) step(j, a[0]);
    wgmma_wait<0>();
    fence_regs(acc);
    // D row 16 (cw % 4) + g (+ 8) is column cb (+ 1); D column 8 n8 + 2t (+ 1) is row m
    if (col_ok) {
#pragma unroll
      for (int n8 = 0; n8 < 32; ++n8)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int row = m0 + 8 * n8 + 2 * t + e;
          if (row < M)
            *reinterpret_cast<__nv_bfloat162*>(y + ((long long)b * M + row) * N + col) =
                __floats2bfloat162_rn(acc[n8][e], acc[n8][2 + e]);
        }
    }
  }
}

// ---------------------------------------------------------------------------
// tensor maps of the codes, cached by weight: a layer's codes keep their
// address for the model's life, so each is encoded once

enum CodeBox : int { kBoxSplitK = 0, kBoxWgmma = 1 };

struct CodeMapSlot {
  const void* base;
  int device, N, CR, B, box;
  CUtensorMap map;
};

// The (B, CR, N) uint8 codes at base as a 3-D map (N, CR, B) in boxes of
// 128 columns x box_rows ("splitk" a stage's 128 code rows, "wgmma" a
// step's), 128-byte swizzle, zeros outside the tensor.
inline cudaError_t code_map(CUtensorMap* out, const void* base, int N, int CR, int B, int box,
                            int box_rows) {
  static std::mutex mu;
  static CodeMapSlot slots[1024];
  int device = 0;
  cudaGetDevice(&device);
  const size_t h = ((reinterpret_cast<uintptr_t>(base) >> 4) * 0x9E3779B97F4A7C15ull ^
                    (size_t)box ^ ((size_t)device << 1)) % 1024;
  std::lock_guard<std::mutex> lock(mu);
  CodeMapSlot& s = slots[h];
  if (!(s.base == base && s.device == device && s.N == N && s.CR == CR && s.B == B &&
        s.box == box)) {
    hopper::EncodeTiled fn = hopper::encode_tiled();
    if (fn == nullptr) return cudaErrorNotSupported;
    const cuuint64_t dims[3] = {cuuint64_t(N), cuuint64_t(CR), cuuint64_t(B)};
    const cuuint64_t strides[2] = {cuuint64_t(N), cuuint64_t(CR) * N};
    const cuuint32_t boxd[3] = {128u, cuuint32_t(box_rows), 1u};
    const cuuint32_t elem[3] = {1, 1, 1};
    const CUresult r = fn(&s.map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, const_cast<void*>(base),
                          dims, strides, boxd, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                          CU_TENSOR_MAP_SWIZZLE_128B,
                          CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                          CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    if (r != CUDA_SUCCESS) {
      s.base = nullptr;
      return cudaErrorInvalidValue;
    }
    s.base = base, s.device = device, s.N = N, s.CR = CR, s.B = B, s.box = box;
  }
  *out = s.map;
  return cudaSuccess;
}

// ---------------------------------------------------------------------------
// launchers

// the kernel's dynamic shared memory limit raised to ``bytes`` once: ``set``
// is its launcher's record of the limit it set
template <typename K>
cudaError_t set_smem_once(K kernel, size_t bytes, size_t& set) {
  if (bytes <= set) return cudaSuccess;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess) set = bytes;
  return err;
}

template <int BITS, int MT>
cudaError_t launch_rows(const float* x, const uint8_t* q, const float* s, float* y, float* part,
                        int B, int M, int K, int N, int G, long long xb, int S, int Ks,
                        cudaStream_t stream) {
  if (Ks > kRowsSplitMax || (S > 1 && part == nullptr)) return cudaErrorInvalidValue;
  static size_t set = 0;
  cudaError_t err = set_smem_once(wq_rows_kernel<BITS, MT>, (size_t)MT * kRowsSplitMax * 4, set);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + kRowsStrip - 1) / kRowsStrip, B * S, (M + MT - 1) / MT);
  wq_rows_kernel<BITS, MT><<<grid, kRowsThreads, (size_t)MT * Ks * 4, stream>>>(
      x, q, s, y, part, M, K, N, G, xb, S, Ks);
  err = cudaGetLastError();
  if (err != cudaSuccess || S == 1) return err;
  const long long total = (long long)B * M * N;
  const int blocks = (int)((total + 255) / 256 < 4096 ? (total + 255) / 256 : 4096);
  wq_reduce_kernel<<<blocks, 256, 0, stream>>>(part, y, total, S);
  return cudaGetLastError();
}

template <int BITS>
cudaError_t launch_rows_m(const float* x, const uint8_t* q, const float* s, float* y,
                          float* part, int B, int M, int K, int N, int G, long long xb, int S,
                          int Ks, cudaStream_t st) {
  switch (rows_tile(M)) {
    case 1: return launch_rows<BITS, 1>(x, q, s, y, part, B, M, K, N, G, xb, S, Ks, st);
    case 2: return launch_rows<BITS, 2>(x, q, s, y, part, B, M, K, N, G, xb, S, Ks, st);
    case 4: return launch_rows<BITS, 4>(x, q, s, y, part, B, M, K, N, G, xb, S, Ks, st);
    case 8: return launch_rows<BITS, 8>(x, q, s, y, part, B, M, K, N, G, xb, S, Ks, st);
    default: return launch_rows<BITS, 16>(x, q, s, y, part, B, M, K, N, G, xb, S, Ks, st);
  }
}

// x (Bx, M, K) bf16 as a 3-D map (K, M, Bx) in boxes of 64 columns x rows,
// 128-byte swizzle, zeros outside the tensor
inline cudaError_t x_map(CUtensorMap* map, const void* x, int Bx, int M, int K, int rows) {
  const cuuint64_t dims[3] = {cuuint64_t(K), cuuint64_t(M), cuuint64_t(Bx)};
  const cuuint64_t strides[2] = {cuuint64_t(K) * 2, cuuint64_t(M) * K * 2};
  const cuuint32_t box[3] = {64, cuuint32_t(rows), 1};
  return hopper::make_map_bf16(map, x, 3, dims, strides, box);
}

template <int BITS, int MT>
cudaError_t launch_splitk(const void* x, const uint8_t* q, const float* s, void* y, int B,
                          int M, int K, int N, int G, int x_batched, int S, int Ks, int R,
                          cudaStream_t stream) {
  using Geo = SkGeom<BITS, MT>;
  if (S > sk::kMaxCluster || R < sk::kMinStages || R > sk::kMaxStages) return cudaErrorInvalidValue;
  CUtensorMap cmap, xmap;
  cudaError_t err = code_map(&cmap, q, N, K / Geo::kRpc, B, kBoxSplitK, sk::kBoxRows);
  if (err == cudaSuccess) err = x_map(&xmap, x, x_batched ? B : 1, M, K, MT);
  if (err != cudaSuccess) return err;
  auto kernel = wq_splitk_kernel<BITS, MT>;
  static size_t set = 0;
  err = set_smem_once(kernel, Geo::smem(sk::kMaxStages), set);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(S, (N + sk::kCols - 1) / sk::kCols, B);
  cfg.blockDim = dim3(sk::kThreads);
  cfg.dynamicSmemBytes = Geo::smem(R);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = S;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  __nv_bfloat16* yp = static_cast<__nv_bfloat16*>(y);
  void* args[] = {&cmap, &xmap, &s, &yp, &M, &K, &N, &G, &Ks, &R, &x_batched};
  err = cudaLaunchKernelExC(&cfg, (const void*)kernel, args);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <int BITS>
cudaError_t launch_wgmma(const void* x, const uint8_t* q, const float* s, void* y, int B,
                         int M, int K, int N, int G, int x_batched, cudaStream_t stream) {
  using Geo = WgGeom<BITS>;
  CUtensorMap xmap, cmap;
  cudaError_t err = x_map(&xmap, x, x_batched ? B : 1, M, K, wgq::kBM);
  if (err == cudaSuccess)
    err = code_map(&cmap, q, N, K / Geo::kRpc, B, kBoxWgmma, Geo::kCodeRows);
  if (err != cudaSuccess) return err;
  static size_t set = 0;
  err = set_smem_once(wq_wgmma_kernel<BITS>, Geo::kSmem, set);
  if (err != cudaSuccess) return err;
  const dim3 grid((M + wgq::kBM - 1) / wgq::kBM, (N + wgq::kBN - 1) / wgq::kBN, B);
  wq_wgmma_kernel<BITS><<<grid, wgq::kThreads, Geo::kSmem, stream>>>(
      xmap, cmap, s, static_cast<__nv_bfloat16*>(y), M, K, N, G, x_batched);
  return cudaGetLastError();
}

template <int BITS>
cudaError_t launch_splitk_m(const void* x, const uint8_t* q, const float* s, void* y, int B,
                            int M, int K, int N, int G, int xbat, int S, int Ks, int R,
                            cudaStream_t st) {
  return M <= 8 ? launch_splitk<BITS, 8>(x, q, s, y, B, M, K, N, G, xbat, S, Ks, R, st)
                : launch_splitk<BITS, 16>(x, q, s, y, B, M, K, N, G, xbat, S, Ks, R, st);
}

}  // namespace
}  // namespace fft

// x (x_batched ? B : 1, M, K), q (B, K or K / 2, N), scale (B, G, N) f32,
// y (B, M, N), all contiguous on the device, x, q and scale 16-byte
// aligned; bits 8 (int8 codes) or 4 (packed int4); dtype of x and y: 0
// f32, 1 bf16; K and K / G multiples of 32, N of 16. The plan
// (serve/kernels.wq_plan): design (wq_matmul_design's code for M and
// dtype), splits K slices of k_slice rows (a multiple of 32; the last may
// be shorter, none empty), stages of the ring ("wgmma": its 4). "splitk" runs the
// slices as one cluster (splits <= 8); "rows" and "f32" add the slices'
// partial sums in a second launch, from part (splits x B x M x N floats,
// null when splits is 1).
extern "C" int wq_matmul_launch(const void* x, const void* q, const void* scale, void* y,
                                void* part, int B, int M, int K, int N, int G, int x_batched,
                                int bits, int dtype, int design, int splits, int k_slice,
                                int stages, void* stream) {
  using namespace fft;
  if (B < 1 || M < 1 || K < 32 || N < 16 || G < 1 || K % 32 || N % 16 || K % G ||
      (K / G) % 32 || (bits != 8 && bits != 4) || (dtype != kBFloat16 && dtype != kFloat32))
    return (int)cudaErrorInvalidValue;
  if (design != wq_design(M, dtype) || splits < 1 || k_slice < 32 || k_slice % 32 ||
      (long long)(splits - 1) * k_slice >= K || (long long)splits * k_slice < K)
    return (int)cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(q) |
       reinterpret_cast<uintptr_t>(scale)) & 15)
    return (int)cudaErrorMisalignedAddress;
  const long long xb = x_batched ? (long long)M * K : 0;
  const uint8_t* qc = static_cast<const uint8_t*>(q);
  const float* s = static_cast<const float*>(scale);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (design) {
    case kWqSplitK:
      return bits == 8
                 ? (int)launch_splitk_m<8>(x, qc, s, y, B, M, K, N, G, x_batched, splits,
                                           k_slice, stages, st)
                 : (int)launch_splitk_m<4>(x, qc, s, y, B, M, K, N, G, x_batched, splits,
                                           k_slice, stages, st);
    case kWqWgmma:
      if (splits != 1 || stages != wgq::kStages) return (int)cudaErrorInvalidValue;
      return bits == 8 ? (int)launch_wgmma<8>(x, qc, s, y, B, M, K, N, G, x_batched, st)
                       : (int)launch_wgmma<4>(x, qc, s, y, B, M, K, N, G, x_batched, st);
    default: {
      const float* xf = static_cast<const float*>(x);
      float* yf = static_cast<float*>(y);
      float* pt = static_cast<float*>(part);
      return bits == 8 ? (int)launch_rows_m<8>(xf, qc, s, yf, pt, B, M, K, N, G, xb, splits,
                                               k_slice, st)
                       : (int)launch_rows_m<4>(xf, qc, s, yf, pt, B, M, K, N, G, xb, splits,
                                               k_slice, st);
    }
  }
}

// The design the launcher takes for M rows of x of DType dtype: 0 "rows",
// 1 "wgmma", 2 "f32", 3 "splitk".
extern "C" int wq_matmul_design(int M, int dtype) { return fft::wq_design(M, dtype); }

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
