// wq_matmul — y = x @ dequantize(q, scale) for weight-only int8 / int4
// weights, for sm_90a.
//
// No TPU kernel of its own: the JAX package leaves dequantize + matmul to
// XLA, which fuses the convert-and-scale into the dot's operand read
// (flexflow_tpu/quantization.py:11-15, the `_mm` / `_dense_w` of
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
// Designs (wq_matmul_design):
//   "rows" (M <= 16, decode). A block of 256 threads owns a strip of 32
//     columns and one split of K: 8 threads along N, each loading 4 code
//     bytes a row (4 columns of int8, or 4 columns by 2 rows of int4), so
//     a warp reads 4 rows of 32 bytes, coalesced along N where the (K, N)
//     layout is contiguous; 32 threads along K split the split's rows. x's
//     slice of the split (at most 1024 rows) is staged once in shared
//     memory as f32; then each thread keeps 8 code loads in flight at a time,
//     dequantizes them in registers and accumulates its M x 4 sums on the
//     CUDA cores, with no barrier until the end. The partial sums reduce by
//     warp shuffles, then across the block's 8 warps in shared memory, in a
//     fixed order. K is split until the grid has 4 blocks an SM (a strip
//     count of 128 fills no card alone); the splits' f32 partial sums meet
//     in a second launch (wq_reduce_kernel), added in split order and
//     rounded once. 4 columns a thread keep the M = 16 accumulators at 64
//     registers, for two blocks an SM (there the M = 16 instantiations
//     meet the 128-register cap and spill 28 bytes).
//   "mma" (M > 16, bf16 x: mixed steps, chunked prefill). 128 x 128
//     output tiles, 8 warps of 64 x 32; each 32-deep K step's x tile comes
//     by cp.async and its codes by 16-byte loads into registers, both
//     issued while the previous step multiplies (two shared-memory stages);
//     the codes are dequantized into the bf16 B tile and multiplied by
//     mma.sync m16n8k16 with f32 accumulation (mma.cuh), the A and B
//     fragments read by ldmatrix; two blocks an SM (the int4 instantiation
//     spills 4 bytes at the 128-register cap). int4's code vectors are 8
//     bytes (8 columns by 2 rows), so every thread dequantizes a vector a
//     step. wgmma and TMA are later work.
//   "f32" (M > 16, f32 x; test-sized f32 models): the "rows" kernel over
//     tiles of 16 rows, on the CUDA cores.
#include "mma.cuh"

namespace fft {
namespace {

enum WqDesign : int { kWqRows = 0, kWqMma = 1, kWqF32 = 2 };
constexpr int kWqRowsMax = 16;

inline int wq_design(int M, int dtype) {
  if (M <= kWqRowsMax) return kWqRows;
  return dtype == kBFloat16 ? kWqMma : kWqF32;
}

template <typename T> __device__ __forceinline__ float round_to(float v);
template <> __device__ __forceinline__ float round_to<float>(float v) { return v; }
template <> __device__ __forceinline__ float round_to<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// ---------------------------------------------------------------------------
// "rows": M <= MT rows a block (blockIdx.z tiles M by MT for "f32"), K split
// over blockIdx.y's splits

constexpr int kRowsThreads = 256;
constexpr int kRowsCols = 4;               // columns a thread (one 4-byte code load)
constexpr int kRowsTX = 8;                 // threads along N: 32-column strips
constexpr int kRowsStrip = kRowsCols * kRowsTX;
constexpr int kRowsTY = kRowsThreads / kRowsTX;  // threads along K
constexpr int kRowsDepth = 8;              // code loads a thread has in flight
constexpr int kRowsSplitMax = 1024;        // most K rows of a split: x's f32 slice in smem
constexpr int kRowsBlocksPerSm = 4;        // blocks an SM the split count aims for

inline int rows_tile(int M) { return M <= 1 ? 1 : M <= 2 ? 2 : M <= 4 ? 4 : M <= 8 ? 8 : 16; }

// The K rows of one split (a multiple of 32) and the split count: at least
// K / kRowsSplitMax splits, more while the grid has fewer than
// kRowsBlocksPerSm blocks an SM (a split keeps at least 256 rows).
inline void rows_splits(int M, int K, int N, int B, int sms, int& S, int& Ks) {
  const int base = ((N + kRowsStrip - 1) / kRowsStrip) * B * ((M + rows_tile(M) - 1) / rows_tile(M));
  const int s_min = (K + kRowsSplitMax - 1) / kRowsSplitMax;
  const int s_want = (kRowsBlocksPerSm * sms + base - 1) / base;
  const int s_max = K / 256 > 1 ? K / 256 : 1;
  S = s_want < s_max ? s_want : s_max;
  if (S < s_min) S = s_min;
  Ks = ((K + S - 1) / S + 31) / 32 * 32;
  S = (K + Ks - 1) / Ks;
}

template <typename T, int BITS, int MT>
__global__ void __launch_bounds__(kRowsThreads, 2)
wq_rows_kernel(const T* __restrict__ x, const uint8_t* __restrict__ q,
               const float* __restrict__ scale, T* __restrict__ y, float* __restrict__ part_out,
               int M, int K, int N, int G, long long x_bstride, int S, int Ks) {
  constexpr int kRpc = BITS == 4 ? 2 : 1;                 // K rows a code row holds
  extern __shared__ __align__(16) unsigned char rows_smem[];
  float* xs = reinterpret_cast<float*>(rows_smem);        // [MT][Ks]: x's slice, as f32
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

  // x's slice of this split, staged once as f32, 8 elements a load
  for (int i = tid; i < MT * (kn / 8); i += kRowsThreads) {
    const int m = i / (kn / 8), k = (i % (kn / 8)) * 8;
    float v[8];
    if (m < rows) {
      load_f32<T, 8>(x + (long long)m * K + k, v);
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
      // kRowsDepth loads in flight before any is used
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
            const float w = round_to<T>(__fmul_rn(float(int8_t(c[j])), sc[j]));
#pragma unroll
            for (int m = 0; m < MT; ++m)
              acc[m][j] = fmaf(xs[m * Ks + r], w, acc[m][j]);
          } else {
            const float w0 = round_to<T>(__fmul_rn(float(int(c[j] & 15) - 8), sc[j]));
            const float w1 = round_to<T>(__fmul_rn(float(int(c[j] >> 4) - 8), sc[j]));
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
      y[at] = from_f32<T>(s);
    else  // the split's f32 partial sum, [split][B][M][N]: wq_reduce_kernel adds them
      part_out[(long long)split * ((long long)(gridDim.y / S) * M * N) + at] = s;
  }
}

// y = the splits' partial sums added in split order, rounded once to T
template <typename T>
__global__ void wq_reduce_kernel(const float* __restrict__ part, T* __restrict__ y,
                                 long long total, int S) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (long long)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int k = 0; k < S; ++k) s += part[(long long)k * total + i];
    y[i] = from_f32<T>(s);
  }
}

// ---------------------------------------------------------------------------
// "mma": bf16 x, 128 x 128 tiles on mma.sync, two stages

constexpr int kMmaThreads = 256;
constexpr int kBM = 128, kBN = 128, kBK = 32;
constexpr int kLA = kBK + 8;   // bf16 row stride of the x tile
constexpr int kLB = kBN + 8;   // bf16 row stride of the dequantized weight tile

// The A fragments (rows m0 .. m0 + 15, columns k0 .. k0 + 15) of a
// row-major bf16 tile with row stride L, by one ldmatrix (lane l gives the
// address of row m0 + l % 16, column k0 + 8 (l / 16)); rows 16-byte aligned.
template <int L>
__device__ __forceinline__ void load_a_x4(const __nv_bfloat16* tile, int m0, int k0, int lane,
                                          uint32_t (&a)[4]) {
  const __nv_bfloat16* p = tile + (m0 + (lane & 15)) * L + k0 + 8 * (lane >> 4);
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(s));
}

template <int BITS>
struct MmaCodes {
  static constexpr int kRpc = BITS == 4 ? 2 : 1;
  static constexpr int kCodeRows = kBK / kRpc;           // code rows of a K step
  static constexpr int kVecCols = BITS == 4 ? 8 : 16;    // columns of a code vector
  static constexpr int kVecsPerRow = kBN / kVecCols;
  static constexpr int kVecs = kCodeRows * kVecsPerRow;  // code vectors of a step: 256
};

template <int BITS>
__global__ void __launch_bounds__(kMmaThreads, 2)
wq_mma_kernel(const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ q,
              const float* __restrict__ scale, __nv_bfloat16* __restrict__ y, int M, int K,
              int N, int G, long long x_bstride) {
  using C = MmaCodes<BITS>;
  constexpr int kRpc = C::kRpc;
  constexpr int kVC = C::kVecCols;
  static_assert(C::kVecs == kMmaThreads, "one code vector a thread a step");
  __shared__ __align__(16) __nv_bfloat16 As[2][kBM * kLA];
  __shared__ __align__(16) __nv_bfloat16 Bs[2][kBK * kLB];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp >> 2, wn = warp & 3;   // a warp's 64 x 32 tile
  const int b = blockIdx.z;
  const int m_blk = blockIdx.y * kBM, n_blk = blockIdx.x * kBN;
  const long long CR = K / kRpc;
  x += b * x_bstride;
  q += (long long)b * CR * N;
  scale += (long long)b * G * N;
  y += (long long)b * M * N;
  const int Kg = K / G;

  // this thread's code vector: code row vr of a step, columns nv .. nv + kVC - 1
  const int vr = tid / C::kVecsPerRow;
  const int nv = n_blk + (tid % C::kVecsPerRow) * kVC;
  const bool v_ok = nv < N;
  float sc[kVC];
  int cur_g = -1;

  auto load_x = [&](int k0, int stage) {  // 128 x 32 bf16: 512 chunks of 16 bytes
#pragma unroll
    for (int i = tid; i < kBM * (kBK / 8); i += kMmaThreads) {
      const int r = i / (kBK / 8), c = i % (kBK / 8);
      const int gm = m_blk + r;
      const bool ok = gm < M;
      cp_async16(&As[stage][r * kLA + c * 8], ok ? x + (long long)gm * K + k0 + c * 8 : x,
                 ok ? 16 : 0);
    }
    cp_async_commit();
  };
  auto load_codes = [&](int k0) -> uint4 {
    uint4 raw = make_uint4(0u, 0u, 0u, 0u);
    if (!v_ok) return raw;
    const uint8_t* p = q + (long long)(k0 / kRpc + vr) * N + nv;
    if constexpr (kVC == 16) {
      raw = __ldg(reinterpret_cast<const uint4*>(p));
    } else {
      const uint2 r2 = __ldg(reinterpret_cast<const uint2*>(p));
      raw.x = r2.x;
      raw.y = r2.y;
    }
    return raw;
  };
  // the codes of step k0, dequantized into the B tile of ``stage``: the
  // f32 code times the f32 scale, rounded once to bf16
  auto store_codes = [&](uint4 raw, int k0, int stage) {
    float w[kRpc][kVC];
    if (v_ok) {
      const int gg = k0 / Kg;  // a step lies in one scale group
      if (gg != cur_g) {
#pragma unroll
        for (int h = 0; h < kVC; h += 8)
          load_f32<float, 8>(scale + (long long)gg * N + nv + h,
                             *reinterpret_cast<float(*)[8]>(sc + h));
        cur_g = gg;
      }
      const uint8_t* c = reinterpret_cast<const uint8_t*>(&raw);
#pragma unroll
      for (int j = 0; j < kVC; ++j) {
        if constexpr (BITS == 8) {
          w[0][j] = __fmul_rn(float(int8_t(c[j])), sc[j]);
        } else {
          w[0][j] = __fmul_rn(float(int(c[j] & 15) - 8), sc[j]);
          w[kRpc - 1][j] = __fmul_rn(float(int(c[j] >> 4) - 8), sc[j]);
        }
      }
    } else {
#pragma unroll
      for (int h = 0; h < kRpc; ++h)
#pragma unroll
        for (int j = 0; j < kVC; ++j) w[h][j] = 0.f;
    }
#pragma unroll
    for (int h = 0; h < kRpc; ++h)
#pragma unroll
      for (int c8 = 0; c8 < kVC; c8 += 8)
        store8<__nv_bfloat16>(&Bs[stage][(vr * kRpc + h) * kLB + (nv - n_blk) + c8],
                              *reinterpret_cast<float(*)[8]>(&w[h][c8]));
  };

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  load_x(0, 0);
  store_codes(load_codes(0), 0, 0);
  cp_async_wait<0>();
  __syncthreads();
  int stage = 0;
  for (int k0 = 0; k0 < K; k0 += kBK) {
    const int nxt = k0 + kBK;
    uint4 raw = make_uint4(0u, 0u, 0u, 0u);
    if (nxt < K) {  // the next step's loads in flight while this one multiplies
      load_x(nxt, stage ^ 1);
      raw = load_codes(nxt);
    }
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      uint32_t a[4][4];
#pragma unroll
      for (int im = 0; im < 4; ++im)
        load_a_x4<kLA>(As[stage], wm * 64 + im * 16, kk, lane, a[im]);
#pragma unroll
      for (int jn = 0; jn < 2; ++jn) {
        uint32_t bb[4];
        load_b_trans<kLB>(Bs[stage], kk, wn * 32 + jn * 16, lane, bb);
#pragma unroll
        for (int im = 0; im < 4; ++im) {
          mma16816(acc[im][2 * jn], a[im], bb[0], bb[1]);
          mma16816(acc[im][2 * jn + 1], a[im], bb[2], bb[3]);
        }
      }
    }
    if (nxt < K) store_codes(raw, nxt, stage ^ 1);
    cp_async_wait<0>();
    __syncthreads();  // the next stage is written and this one's readers are done
    stage ^= 1;
  }
#pragma unroll
  for (int im = 0; im < 4; ++im)
#pragma unroll
    for (int jn = 0; jn < 4; ++jn) {
      const int row = m_blk + wm * 64 + im * 16 + g;
      const int col = n_blk + wn * 32 + jn * 8 + 2 * t;
      if (col >= N) continue;
      const float* c = acc[im][jn];
      if (row < M)
        *reinterpret_cast<__nv_bfloat162*>(y + (long long)row * N + col) =
            __floats2bfloat162_rn(c[0], c[1]);
      if (row + 8 < M)
        *reinterpret_cast<__nv_bfloat162*>(y + (long long)(row + 8) * N + col) =
            __floats2bfloat162_rn(c[2], c[3]);
    }
}

// ---------------------------------------------------------------------------
// launchers

inline int sm_count() {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms;
}

template <typename T, int BITS, int MT>
cudaError_t launch_rows(const void* x, const uint8_t* q, const float* s, void* y, float* part,
                        int B, int M, int K, int N, int G, long long xb, cudaStream_t stream) {
  int S = 1, Ks = K;
  rows_splits(M, K, N, B, sm_count(), S, Ks);
  if (S > 1 && part == nullptr) return cudaErrorInvalidValue;
  const size_t smem = (size_t)MT * Ks * sizeof(float);
  static bool attr_set = false;  // once an instantiation: the most x's slice takes
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        wq_rows_kernel<T, BITS, MT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)(MT * kRowsSplitMax * sizeof(float)));
    if (err != cudaSuccess) return err;
    attr_set = true;
  }
  const dim3 grid((N + kRowsStrip - 1) / kRowsStrip, B * S, (M + MT - 1) / MT);
  wq_rows_kernel<T, BITS, MT><<<grid, kRowsThreads, smem, stream>>>(
      static_cast<const T*>(x), q, s, static_cast<T*>(y), part, M, K, N, G, xb, S, Ks);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || S == 1) return err;
  const long long total = (long long)B * M * N;
  const int blocks = (int)((total + 255) / 256 < 4096 ? (total + 255) / 256 : 4096);
  wq_reduce_kernel<T><<<blocks, 256, 0, stream>>>(part, static_cast<T*>(y), total, S);
  return cudaGetLastError();
}

template <typename T, int BITS>
cudaError_t launch_rows_m(const void* x, const uint8_t* q, const float* s, void* y, float* part,
                          int B, int M, int K, int N, int G, long long xb, cudaStream_t st) {
  switch (rows_tile(M)) {
    case 1: return launch_rows<T, BITS, 1>(x, q, s, y, part, B, M, K, N, G, xb, st);
    case 2: return launch_rows<T, BITS, 2>(x, q, s, y, part, B, M, K, N, G, xb, st);
    case 4: return launch_rows<T, BITS, 4>(x, q, s, y, part, B, M, K, N, G, xb, st);
    case 8: return launch_rows<T, BITS, 8>(x, q, s, y, part, B, M, K, N, G, xb, st);
    default: return launch_rows<T, BITS, 16>(x, q, s, y, part, B, M, K, N, G, xb, st);
  }
}

template <int BITS>
cudaError_t launch_mma(const void* x, const uint8_t* q, const float* s, void* y, int B, int M,
                       int K, int N, int G, long long xb, cudaStream_t stream) {
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM, B);
  wq_mma_kernel<BITS><<<grid, kMmaThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(x), q, s, static_cast<__nv_bfloat16*>(y), M, K, N, G,
      xb);
  return cudaGetLastError();
}

}  // namespace
}  // namespace fft

// x (x_batched ? B : 1, M, K), q (B, K or K / 2, N), scale (B, G, N) f32,
// y (B, M, N), all contiguous on the device; part: the f32 partial sums of
// the "rows"/"f32" designs' K splits, wq_matmul_splits(...) x B x M x N
// floats (null when that is 1); bits 8 (int8 codes) or 4 (packed int4);
// dtype of x and y: 0 f32, 1 bf16. K and K / G multiples of 32, N of 16.
extern "C" int wq_matmul_launch(const void* x, const void* q, const void* scale, void* y,
                                void* part, int B, int M, int K, int N, int G, int x_batched,
                                int bits, int dtype, void* stream) {
  using namespace fft;
  if (B < 1 || M < 1 || K < 32 || N < 16 || G < 1 || K % 32 || N % 16 || K % G ||
      (K / G) % 32 || (bits != 8 && bits != 4))
    return (int)cudaErrorInvalidValue;
  const long long xb = x_batched ? (long long)M * K : 0;
  const uint8_t* qc = static_cast<const uint8_t*>(q);
  const float* s = static_cast<const float*>(scale);
  float* pt = static_cast<float*>(part);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int design = wq_design(M, dtype);
  if (dtype == kBFloat16) {
    if (design == kWqMma)
      return bits == 8 ? (int)launch_mma<8>(x, qc, s, y, B, M, K, N, G, xb, st)
                       : (int)launch_mma<4>(x, qc, s, y, B, M, K, N, G, xb, st);
    return bits == 8
               ? (int)launch_rows_m<__nv_bfloat16, 8>(x, qc, s, y, pt, B, M, K, N, G, xb, st)
               : (int)launch_rows_m<__nv_bfloat16, 4>(x, qc, s, y, pt, B, M, K, N, G, xb, st);
  }
  if (dtype == kFloat32)
    return bits == 8 ? (int)launch_rows_m<float, 8>(x, qc, s, y, pt, B, M, K, N, G, xb, st)
                     : (int)launch_rows_m<float, 4>(x, qc, s, y, pt, B, M, K, N, G, xb, st);
  return (int)cudaErrorInvalidValue;
}

// The K splits of the "rows" and "f32" designs for these sizes (1 for
// "mma"): the caller's partial-sum buffer holds that many B x M x N.
extern "C" int wq_matmul_splits(int B, int M, int K, int N, int dtype) {
  using namespace fft;
  if (wq_design(M, dtype) == kWqMma || K < 32) return 1;
  int S = 1, Ks = K;
  rows_splits(M, K, N, B, sm_count(), S, Ks);
  return S;
}

extern "C" int wq_matmul_design(int M, int dtype) { return fft::wq_design(M, dtype); }

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
