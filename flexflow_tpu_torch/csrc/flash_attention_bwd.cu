// flash_attention_bwd — the training backward pass of flash attention, for
// sm_90a: flash_attention_bwd_kv (dK, dV) and flash_attention_bwd_q (dQ).
//
// Replaces the Pallas TPU kernels of flexflow_tpu/ops/flash_attention.py
// _flash_bwd (bodies _bwd_kv_kernel and _bwd_q_kernel), and keeps their
// two-kernel split, so every gradient is a sum its own block owns: no
// atomics, and the result does not change from run to run. Both recompute
// the probabilities from the forward pass's log-sum-exp
// (FlashAttention-2): s = dot(q, k) * scale, p = exp(s - lse) where the
// row attends the line (top-left causal rule qpos >= kpos), 0 elsewhere;
// dp = dot(do, v); ds = p * (dp - delta) * scale, with delta = sum(do *
// out) per row in f32, computed by the wrapper as the JAX package does
// outside Pallas. Then dV = sum over rows of p * do and dK = sum of ds *
// q (kv kernel), dQ = sum over lines of ds * k (q kernel), accumulated in
// f32 and written in the inputs' dtypes. q, k, v, do, dq, dk and dv keep
// the (B, S|T, H, dk) layout (row stride H * dk); lse and delta are
// (B, H, S) f32.
//
// Bound on an H100: operations. Per attended (row, line) pair and head,
// the kv kernel does 8 * dk FLOP (s, dp, dV, dK) and the q kernel 6 * dk
// (s, dp, dQ); at B*H = 128, S = T = 2048, dk = 128, causal, 275 and 206
// GFLOP against ~340 MB each. bf16 inputs run on Hopper's warpgroup
// products (design "wgmma"); f32 inputs on the CUDA cores (design "f32",
// 67 TFLOP/s peak).
//
// Design against that bound:
//  * bf16 (flash_bwd_kv_wgmma_kernel, flash_bwd_q_wgmma_kernel, below,
//    after the forward's design): three warpgroups, one TMA producer
//    thread filling a 3-stage mbarrier ring, two consumer warpgroups on
//    wgmma. kv: a block owns 128 key lines (64 a consumer, K and V loaded
//    once) and streams (Q, dO) tiles of 64 rows from the diagonal on;
//    S^T and dP^T from shared memory, P^T and dS^T from registers into
//    dV += P^T dO and dK += dS^T Q with dO and Q read
//    MN-major (the transpose bit), so no transposed copy is staged. q: a
//    block owns 128 rows (64 a consumer) and streams (K, V) tiles of 64
//    lines up to the diagonal; dQ += dS K with K MN-major. p and ds enter
//    as hi + lo bf16 fragments: 6 products where the math has 4 (kv), 4
//    where it has 3 (q).
//  * f32 (flash_bwd_kv_kernel, flash_bwd_q_kernel; tiles and thread
//    layouts of flash_attention.cuh):
//    - kv: one block per (b * H + h, tile of 64 key lines), K and V
//      staged once; it walks the query tiles from the one holding the
//      diagonal to the end (causal), or all of them, staging Q, dO, lse
//      and delta. Each thread computes a 4 x 4 block of s and dp, writes
//      p and ds to shared memory, and then accumulates dV and dK for 4
//      lines x dk / 16 columns from float4 reads of p, ds, dO and Q.
//    - q: one block per (b * H + h, tile of 64 query rows), Q, dO, lse
//      and delta staged once; it walks the key tiles up to the diagonal,
//      and accumulates dQ for its 4 rows x dk / 16 columns as the forward
//      kernel accumulates its output.
//    - Each tile's sums (64 rows, or 64 lines) go into fresh
//      accumulators, added into the totals once a tile: a running f32
//      sum over all 2048 rows one at a time lost ~8 x more than the
//      plain version's product.
//  * Rows past S and lines past T are zero in shared memory and masked
//    out (the JAX kernels' NaN guards on padded blocks).
#include "flash_attention.cuh"
#include "hopper.cuh"

namespace fft {
namespace {

using namespace flash;

template <int DK>
struct BwdSmem {
  static constexpr int L = Ld<DK>::kRow;
  // kv: sK, sV, sQ, sdO [64][L]; sP, sdS [64][kLdP]; lse, delta [64]
  static constexpr size_t kKv = sizeof(float) * (4 * size_t(kRows) * L
                                                 + 2 * size_t(kRows) * kLdP + 2 * kRows);
  // q: sQ, sdO, sK, sV [64][L]; sdS [64][kLdP]; lse, delta [64]
  static constexpr size_t kQ = sizeof(float) * (4 * size_t(kRows) * L
                                                + size_t(kRows) * kLdP + 2 * kRows);
};

// lse and delta of rows [r0, r0 + kRows) of head n, zeros past S.
__device__ __forceinline__ void load_row_stats(float* sL, float* sD,
                                               const float* __restrict__ lse,
                                               const float* __restrict__ delta,
                                               size_t n, int r0, int S) {
  for (int i = threadIdx.x; i < kRows; i += kThreads) {
    const int r = r0 + i;
    sL[i] = r < S ? lse[n * S + r] : 0.f;
    sD[i] = r < S ? delta[n * S + r] : 0.f;
  }
}

// p and ds of this thread's 4 x 4 block (rows i0 + a of the tile at r0,
// lines tx + 16 b of the tile at t0), from staged Q, K, dO, V, lse, delta.
template <int DK>
__device__ __forceinline__ void probs_and_dscores(
    const float* sQ, const float* sK, const float* sdO, const float* sV,
    const float* sL, const float* sD, int r0, int t0, int i0, int tx, int S,
    int T_, int causal, float scale, float (&p)[4][4], float (&ds)[4][4]) {
  float dp[4][4];
  dot_tile<DK>(sQ, sK, i0, tx, p);
  dot_tile<DK>(sdO, sV, i0, tx, dp);
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int r = r0 + i0 + a;
    const float lse_r = sL[i0 + a], delta_r = sD[i0 + a];
#pragma unroll
    for (int bb = 0; bb < 4; ++bb) {
      const bool ok = attends(r, t0 + tx + kLanes * bb, S, T_, causal);
      // the score rounded as the forward rounds it (no FMA with -lse), so
      // p is exactly 1 where a row's one attended line set its lse
      const float pr = ok ? expf(__fmul_rn(p[a][bb], scale) - lse_r) : 0.f;
      p[a][bb] = pr;
      ds[a][bb] = pr * (dp[a][bb] - delta_r) * scale;
    }
  }
}

template <typename T, int DK>
__global__ void __launch_bounds__(kThreads)
flash_bwd_kv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    T* __restrict__ dk, T* __restrict__ dv, int S, int T_, int H,
                    int causal, float scale) {
  constexpr int L = Ld<DK>::kRow;
  constexpr int kCols = DK / kLanes;
  extern __shared__ __align__(16) float smem[];
  float* sK = smem;                  // [kLines][L]
  float* sV = sK + kLines * L;       // [kLines][L]
  float* sQ = sV + kLines * L;       // [kRows][L]
  float* sdO = sQ + kRows * L;       // [kRows][L]
  float* sP = sdO + kRows * L;       // [kRows][kLdP]
  float* sdS = sP + kRows * kLdP;    // [kRows][kLdP]
  float* sL = sdS + kRows * kLdP;    // [kRows]
  float* sD = sL + kRows;            // [kRows]

  const int t0 = blockIdx.x * kLines;  // early key tiles walk the most rows
  const int n = blockIdx.y, b = n / H, h = n % H;
  const size_t rs = (size_t)H * DK;
  const size_t qoff = ((size_t)b * S * H + h) * DK;
  const size_t koff = ((size_t)b * T_ * H + h) * DK;
  const int tid = threadIdx.x;
  const int tx = tid % kLanes;
  const int i0 = (tid / kLanes) * 4;  // score phase: own rows; then own lines

  load_rows<T, DK, kLines>(sK, k + koff, t0, T_, rs);
  load_rows<T, DK, kLines>(sV, v + koff, t0, T_, rs);

  // dK and dV: each query tile's sums in fresh accumulators (tdk, tdv),
  // added into the totals once a tile, so no f32 running sum spans more
  // than 64 rows (a sum over all S rows one at a time lost precision)
  float adk[4][kCols], adv[4][kCols];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int e = 0; e < kCols; ++e) adk[a][e] = adv[a][e] = 0.f;

  // rows before t0 attend no line of this tile under the causal rule
  const int r_begin = causal ? (t0 / kRows) * kRows : 0;
  for (int r0 = r_begin; r0 < S; r0 += kRows) {
    __syncthreads();  // the last tile's reads of sQ/sdO/sP/sdS are done
    load_rows<T, DK, kRows>(sQ, q + qoff, r0, S, rs);
    load_rows<T, DK, kRows>(sdO, dout + qoff, r0, S, rs);
    load_row_stats(sL, sD, lse, delta, (size_t)n, r0, S);
    __syncthreads();

    float p[4][4], ds[4][4];
    probs_and_dscores<DK>(sQ, sK, sdO, sV, sL, sD, r0, t0, i0, tx, S, T_, causal,
                          scale, p, ds);
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int bb = 0; bb < 4; ++bb) {
        sP[(i0 + a) * kLdP + tx + kLanes * bb] = p[a][bb];
        sdS[(i0 + a) * kLdP + tx + kLanes * bb] = ds[a][bb];
      }
    __syncthreads();

    // dV[line] += p[row][line] * dO[row], dK[line] += ds[row][line] * Q[row]
    // for own lines i0 .. i0 + 3 and columns tx * 4 + 64 hh
    float tdk[4][kCols], tdv[4][kCols];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int e = 0; e < kCols; ++e) tdk[a][e] = tdv[a][e] = 0.f;
#pragma unroll 2
    for (int i = 0; i < kRows; ++i) {
      const float4 pv = *reinterpret_cast<const float4*>(sP + i * kLdP + i0);
      const float4 sv = *reinterpret_cast<const float4*>(sdS + i * kLdP + i0);
      const float pa[4] = {pv.x, pv.y, pv.z, pv.w};
      const float sa[4] = {sv.x, sv.y, sv.z, sv.w};
#pragma unroll
      for (int hh = 0; hh < kCols / 4; ++hh) {
        const float4 dov = *reinterpret_cast<const float4*>(sdO + i * L + tx * 4 + 64 * hh);
        const float4 qv = *reinterpret_cast<const float4*>(sQ + i * L + tx * 4 + 64 * hh);
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          tdv[a][4 * hh + 0] = fmaf(pa[a], dov.x, tdv[a][4 * hh + 0]);
          tdv[a][4 * hh + 1] = fmaf(pa[a], dov.y, tdv[a][4 * hh + 1]);
          tdv[a][4 * hh + 2] = fmaf(pa[a], dov.z, tdv[a][4 * hh + 2]);
          tdv[a][4 * hh + 3] = fmaf(pa[a], dov.w, tdv[a][4 * hh + 3]);
          tdk[a][4 * hh + 0] = fmaf(sa[a], qv.x, tdk[a][4 * hh + 0]);
          tdk[a][4 * hh + 1] = fmaf(sa[a], qv.y, tdk[a][4 * hh + 1]);
          tdk[a][4 * hh + 2] = fmaf(sa[a], qv.z, tdk[a][4 * hh + 2]);
          tdk[a][4 * hh + 3] = fmaf(sa[a], qv.w, tdk[a][4 * hh + 3]);
        }
      }
    }
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int e = 0; e < kCols; ++e) {
        adk[a][e] += tdk[a][e];
        adv[a][e] += tdv[a][e];
      }
  }

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int c = t0 + i0 + a;
    if (c >= T_) continue;
    const size_t off = koff + (size_t)c * rs + tx * 4;
#pragma unroll
    for (int hh = 0; hh < kCols / 4; ++hh)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        dk[off + 64 * hh + e] = from_f32<T>(adk[a][4 * hh + e]);
        dv[off + 64 * hh + e] = from_f32<T>(adv[a][4 * hh + e]);
      }
  }
}

template <typename T, int DK>
__global__ void __launch_bounds__(kThreads)
flash_bwd_q_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const T* __restrict__ dout,
                   const float* __restrict__ lse, const float* __restrict__ delta,
                   T* __restrict__ dq, int S, int T_, int H, int causal,
                   float scale) {
  constexpr int L = Ld<DK>::kRow;
  constexpr int kCols = DK / kLanes;
  extern __shared__ __align__(16) float smem[];
  float* sQ = smem;                  // [kRows][L]
  float* sdO = sQ + kRows * L;       // [kRows][L]
  float* sK = sdO + kRows * L;       // [kLines][L]
  float* sV = sK + kLines * L;       // [kLines][L]
  float* sdS = sV + kLines * L;      // [kRows][kLdP]
  float* sL = sdS + kRows * kLdP;    // [kRows]
  float* sD = sL + kRows;            // [kRows]

  const int row0 = (gridDim.x - 1 - blockIdx.x) * kRows;  // heavy tiles first
  const int n = blockIdx.y, b = n / H, h = n % H;
  const size_t rs = (size_t)H * DK;
  const size_t qoff = ((size_t)b * S * H + h) * DK;
  const size_t koff = ((size_t)b * T_ * H + h) * DK;
  const int tid = threadIdx.x;
  const int tx = tid % kLanes;
  const int i0 = (tid / kLanes) * 4;

  load_rows<T, DK, kRows>(sQ, q + qoff, row0, S, rs);
  load_rows<T, DK, kRows>(sdO, dout + qoff, row0, S, rs);
  load_row_stats(sL, sD, lse, delta, (size_t)n, row0, S);

  float acc[4][kCols];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int e = 0; e < kCols; ++e) acc[a][e] = 0.f;

  const int t_end = causal ? min(T_, row0 + kRows) : T_;
  for (int t0 = 0; t0 < t_end; t0 += kLines) {
    __syncthreads();  // the last tile's reads of sK/sV/sdS are done
    load_rows<T, DK, kLines>(sK, k + koff, t0, T_, rs);
    load_rows<T, DK, kLines>(sV, v + koff, t0, T_, rs);
    __syncthreads();

    float p[4][4], ds[4][4];
    probs_and_dscores<DK>(sQ, sK, sdO, sV, sL, sD, row0, t0, i0, tx, S, T_, causal,
                          scale, p, ds);
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int bb = 0; bb < 4; ++bb) sdS[(i0 + a) * kLdP + tx + kLanes * bb] = ds[a][bb];
    __syncwarp();  // a row group's ds are written and read in-warp

    // this key tile's sum in a fresh accumulator, added once a tile
    float tile[4][kCols];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int e = 0; e < kCols; ++e) tile[a][e] = 0.f;
#pragma unroll 4
    for (int j = 0; j < kLines; ++j) {
      float sa[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) sa[a] = sdS[(i0 + a) * kLdP + j];
#pragma unroll
      for (int hh = 0; hh < kCols / 4; ++hh) {
        const float4 kv = *reinterpret_cast<const float4*>(sK + j * L + tx * 4 + 64 * hh);
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          tile[a][4 * hh + 0] = fmaf(sa[a], kv.x, tile[a][4 * hh + 0]);
          tile[a][4 * hh + 1] = fmaf(sa[a], kv.y, tile[a][4 * hh + 1]);
          tile[a][4 * hh + 2] = fmaf(sa[a], kv.z, tile[a][4 * hh + 2]);
          tile[a][4 * hh + 3] = fmaf(sa[a], kv.w, tile[a][4 * hh + 3]);
        }
      }
    }
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int e = 0; e < kCols; ++e) acc[a][e] += tile[a][e];
  }

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int r = row0 + i0 + a;
    if (r >= S) continue;
    const size_t off = qoff + (size_t)r * rs + tx * 4;
#pragma unroll
    for (int hh = 0; hh < kCols / 4; ++hh)
#pragma unroll
      for (int e = 0; e < 4; ++e) dq[off + 64 * hh + e] = from_f32<T>(acc[a][4 * hh + e]);
  }
}

// The bf16 backward on Hopper's warpgroup products, after the forward
// (flash_attention_fwd.cu): blocks of three warpgroups, warpgroup 0 a TMA
// producer (one thread, registers cut to kProducerRegs by setmaxnreg),
// warpgroups 1 and 2 consumers of 64 lines (kv) or 64 rows (q) each,
// raised to kConsumerRegs. Tiles arrive through a ring of kStages
// buffers, each guarded by a full and an empty mbarrier, as TMA boxes of
// 64 bf16 columns with the 128-byte swizzle; rows past S and lines past T
// arrive as zeros. Every product is wgmma.mma_async with f32
// accumulators; p and ds enter their products from registers as hi + lo
// bf16 A fragments (acc_to_a: the accumulator layout is the A layout), so
// they keep their f32 value to ~2^-16. Scores go to base 2 (scale * log2e
// folded into one FFMA with the row's lse) and the softmax scale of ds is
// applied once to the finished dK or dQ.
namespace bwg {

constexpr int kThreads = 384;       // producer + two consumer warpgroups
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;  // 24 * 128 + 240 * 256 <= 65536
constexpr int kStages = 3;
constexpr int kBoxCols = 64;        // bf16 columns of a 128-byte TMA box
constexpr int kKvLines = 128;       // kv: key lines a block, 64 a consumer
constexpr int kKvRows = 64;         // kv: query rows a ring tile
constexpr int kQRows = 128;         // q: query rows a block, 64 a consumer
constexpr int kQLines = 64;         // q: key lines a ring tile

// kv: K and V boxes of the block's 128 lines; a ring of Q and dO boxes of
// 64 rows; then each consumer's two buffers of a tile's lse and delta
// (2 x 64 f32 each)
template <int DK>
struct KvSmem {
  static constexpr int kBoxes = DK / kBoxCols;
  static constexpr uint32_t kKBox = kKvLines * 128;
  static constexpr uint32_t kK = kBoxes * kKBox;   // K or V
  static constexpr uint32_t kQBox = kKvRows * 128;
  static constexpr uint32_t kQ = kBoxes * kQBox;   // Q or dO of a stage
  static constexpr uint32_t kStats = 2 * 2 * 2 * kKvRows * 4;  // consumers x buffers
  static constexpr size_t kBytes = 2 * size_t(kK) + kStages * 2 * size_t(kQ) + kStats
                                   + 1024;  // + alignment
};

// q: Q and dO boxes of the block's 128 rows; a ring of K and V boxes of
// 64 lines
template <int DK>
struct QSmem {
  static constexpr int kBoxes = DK / kBoxCols;
  static constexpr uint32_t kQBox = kQRows * 128;
  static constexpr uint32_t kQ = kBoxes * kQBox;  // Q or dO
  static constexpr uint32_t kKBox = kQLines * 128;
  static constexpr uint32_t kK = kBoxes * kKBox;  // K or V of a stage
  static constexpr size_t kBytes = 2 * size_t(kQ) + kStages * 2 * size_t(kK) + 1024;
};

// bar.sync on barrier ``id`` (not 0, __syncthreads's) among ``count``
// threads: one consumer warpgroup
__device__ __forceinline__ void named_barrier_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// the 1024-byte-aligned start of the dynamic shared memory (the swizzle
// pattern follows address bits 7-9)
__device__ __forceinline__ unsigned char* aligned_smem(unsigned char* raw) {
  return reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(raw) + 1023) &
                                          ~uintptr_t(1023));
}

// acc (64 x 64 f32) = sum over dk of A (64 rows at a, K-major boxes of
// a_box bytes) times B^T (64 rows at b, K-major boxes of b_box bytes)
template <int DK>
__device__ __forceinline__ void product_ss(float (&acc)[8][4], const unsigned char* a,
                                           uint32_t a_box, const unsigned char* b,
                                           uint32_t b_box) {
  using namespace hopper;
#pragma unroll
  for (int ks = 0; ks < DK / 16; ++ks) {
    const int bx = ks / 4, kof = (ks % 4) * 32;  // box, byte offset in its rows
    wgmma_ss_n64(acc, desc_sw128(a + bx * a_box + kof, 16, 1024),
                 desc_sw128(b + bx * b_box + kof, 16, 1024), ks > 0);
  }
}

// acc (64 x DK f32) += A (64 x 64, 4 hi + lo fragment pairs from
// registers) times B (64 x DK at b: 64 rows of boxes of box bytes, read
// MN-major through the transpose bit)
template <int DK>
__device__ __forceinline__ void product_rs(float (&acc)[DK / 8][4], const uint32_t (&hi)[4][4],
                                           const uint32_t (&lo)[4][4], const unsigned char* b,
                                           uint32_t box) {
  using namespace hopper;
#pragma unroll
  for (int kt = 0; kt < 4; ++kt) {
    const uint64_t db = desc_sw128(b + kt * 16 * 128, box, 1024);
    if constexpr (DK == 128) {
      wgmma_rs_n128(acc, hi[kt], db);
      wgmma_rs_n128(acc, lo[kt], db);
    } else {
      wgmma_rs_n64(acc, hi[kt], db);
      wgmma_rs_n64(acc, lo[kt], db);
    }
  }
}

// acc rows 16 w + g (+ 8) of a consumer warpgroup, columns 8 nt + 2 t (+1),
// times mul, as bf16 into the (B, L, H, dk) tensor at base + line 0 of
// the head, lines at or past n skipped
template <int DK>
__device__ __forceinline__ void store_rows(__nv_bfloat16* base, size_t rstride, int r0, int n,
                                           const float (&acc)[DK / 8][4], float mul, int warp,
                                           int g, int t) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + 16 * warp + g + 8 * i;
    if (r >= n) continue;
    __nv_bfloat16* row = base + (size_t)r * rstride + 2 * t;
#pragma unroll
    for (int nt = 0; nt < DK / 8; ++nt)
      *reinterpret_cast<uint32_t*>(row + nt * 8) =
          pack_bf16(acc[nt][2 * i] * mul, acc[nt][2 * i + 1] * mul);
  }
}

}  // namespace bwg

// dK/dV. One block per (b * H + h, 128 key lines), early key tiles (which
// walk the most rows) first. The producer loads the block's K and V once,
// then streams (Q, dO) tiles of 64 rows from the one holding the block's
// first line (causal) or from row 0; each consumer copies the tile's lse
// and delta into its own shared buffer (a value a thread, then a barrier
// of its warpgroup: no TMA box runs past the rows). Consumer c owns lines
// l0 = t0 + 64 c; per tile it computes S^T = K Q^T and dP^T = V dO^T
// (m64n64k16, both operands K-major in shared memory), P^T = 2^(S^T *
// scale2 - lse2) and dS^T = P^T (dP^T - delta) in registers (zero where
// the row does not attend the line), then dV += P^T dO and dK += dS^T Q
// (m64n{dk}k16, A from registers, dO and Q read MN-major: no transposed
// copies). A consumer whose lines no row of a tile attends waits for the
// tile and arrives without the math.
template <int DK>
__global__ void __launch_bounds__(bwg::kThreads, 1)
flash_bwd_kv_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                          const __grid_constant__ CUtensorMap kmap,
                          const __grid_constant__ CUtensorMap vmap,
                          const __grid_constant__ CUtensorMap domap,
                          const float* __restrict__ lse_g, const float* __restrict__ delta_g,
                          __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
                          int S, int T_, int H, int causal, float scale) {
  using namespace hopper;
  using L = bwg::KvSmem<DK>;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[bwg::kStages], empty[bwg::kStages], kvfull;
  unsigned char* sK = bwg::aligned_smem(smem_raw);
  unsigned char* sV = sK + L::kK;
  unsigned char* sQ = sV + L::kK;  // stage st: Q at st * 2 kQ, dO after it
  // consumer c's buffer i: lse (base 2) and delta of a tile's 64 rows
  float* sStat = reinterpret_cast<float*>(sQ + bwg::kStages * 2 * L::kQ);

  const int t0 = blockIdx.x * bwg::kKvLines;
  const int n = blockIdx.y, b = n / H, h = n % H;
  const int r_begin = causal ? t0 : 0;  // rows before t0 attend no line here
  const int ntiles = r_begin < S ? (S - r_begin + bwg::kKvRows - 1) / bwg::kKvRows : 0;
  const int group = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(&kvfull, 1);
    for (int st = 0; st < bwg::kStages; ++st) {
      mbar_init(&full[st], 1);
      mbar_init(&empty[st], 8);  // a lane of every consumer warp
    }
    fence_mbar_init();
  }
  __syncthreads();

  if (group == 0) {
    reg_dealloc<bwg::kProducerRegs>();
    if (threadIdx.x == 0) {
      mbar_expect_tx(&kvfull, 2 * L::kK);
      for (int bx = 0; bx < L::kBoxes; ++bx) {
        tma_load_4d(sK + bx * L::kKBox, &kmap, &kvfull, bx * bwg::kBoxCols, h, t0, b);
        tma_load_4d(sV + bx * L::kKBox, &vmap, &kvfull, bx * bwg::kBoxCols, h, t0, b);
      }
      for (int j = 0; j < ntiles; ++j) {
        const int st = j % bwg::kStages, r0 = r_begin + j * bwg::kKvRows;
        mbar_wait(&empty[st], ((j / bwg::kStages) & 1) ^ 1);
        mbar_expect_tx(&full[st], 2 * L::kQ);
        unsigned char* q = sQ + st * 2 * L::kQ;
        for (int bx = 0; bx < L::kBoxes; ++bx) {
          tma_load_4d(q + bx * L::kQBox, &qmap, &full[st], bx * bwg::kBoxCols, h, r0, b);
          tma_load_4d(q + L::kQ + bx * L::kQBox, &domap, &full[st], bx * bwg::kBoxCols, h, r0,
                      b);
        }
      }
    }
  } else {
    reg_alloc<bwg::kConsumerRegs>();
    const int c = group - 1;
    const int tid = threadIdx.x - 128 * group, warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, t = lane % 4;
    const int l0 = t0 + 64 * c;                               // this consumer's lines
    const int la = l0 + 16 * warp + g, lb = la + 8;           // this thread's lines
    const float scale2 = scale * kLog2e;

    float adk[DK / 8][4], adv[DK / 8][4];
#pragma unroll
    for (int nt = 0; nt < DK / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) adk[nt][e] = adv[nt][e] = 0.f;
    mbar_wait(&kvfull, 0);

    for (int j = 0; j < ntiles; ++j) {
      const int st = j % bwg::kStages, r0 = r_begin + j * bwg::kKvRows;
      // the tile's lse (base 2) and delta, one value a thread, into this
      // consumer's buffer j % 2 (its reads of the tile two back are done:
      // every thread passed the barrier of the tile between)
      float* lse = sStat + (c * 2 + (j & 1)) * 2 * bwg::kKvRows;
      const float* delta = lse + bwg::kKvRows;
      {
        const int r = r0 + tid % bwg::kKvRows;
        const float* src = tid < bwg::kKvRows ? lse_g : delta_g;
        const float x = r < S ? src[(size_t)n * S + r] : 0.f;
        lse[tid] = tid < bwg::kKvRows ? x * kLog2e : x;
      }
      bwg::named_barrier_sync(1 + c, 128);
      mbar_wait(&full[st], (j / bwg::kStages) & 1);
      if (l0 < T_ && (!causal || r0 + bwg::kKvRows - 1 >= l0)) {
        const unsigned char* q = sQ + st * 2 * L::kQ;
        const unsigned char* dO = q + L::kQ;
        float s[8][4], dp[8][4];
        wgmma_fence();
        bwg::product_ss<DK>(s, sK + c * 64 * 128, L::kKBox, q, L::kQBox);
        bwg::product_ss<DK>(dp, sV + c * 64 * 128, L::kKBox, dO, L::kQBox);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(s);
        fence_regs(dp);

        // s[nt][e]: line la (e < 2) or lb, row r0 + 8 nt + 2 t + (e & 1)
        const bool edge = (causal && r0 < l0 + 63) || r0 + bwg::kKvRows > S ||
                          l0 + 64 > T_;
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          const float2 lz = *reinterpret_cast<const float2*>(lse + 8 * nt + 2 * t);
          const float2 dz = *reinterpret_cast<const float2*>(delta + 8 * nt + 2 * t);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float l_r = (e & 1) ? lz.y : lz.x, d_r = (e & 1) ? dz.y : dz.x;
            float p = exp2_ftz(fmaf(s[nt][e], scale2, -l_r));
            if (edge && !attends(r0 + 8 * nt + 2 * t + (e & 1), e < 2 ? la : lb, S, T_, causal))
              p = 0.f;
            s[nt][e] = p;
            dp[nt][e] = p * (dp[nt][e] - d_r);
          }
        }
        uint32_t ph[4][4], pl[4][4], dh[4][4], dl[4][4];
#pragma unroll
        for (int kt = 0; kt < 4; ++kt) {
          acc_to_a(s[2 * kt], s[2 * kt + 1], ph[kt], pl[kt]);
          acc_to_a(dp[2 * kt], dp[2 * kt + 1], dh[kt], dl[kt]);
        }
        wgmma_fence();
        bwg::product_rs<DK>(adv, ph, pl, dO, L::kQBox);
        bwg::product_rs<DK>(adk, dh, dl, q, L::kQBox);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(adv);
        fence_regs(adk);
      }
      __syncwarp();  // the warp is done with the stage (its products waited for)
      if (lane == 0) mbar_arrive(&empty[st]);
    }

    const size_t rs = (size_t)H * DK;
    const size_t head = ((size_t)b * T_ * H + h) * DK;
    bwg::store_rows<DK>(dk + head, rs, l0, T_, adk, scale, warp, g, t);
    bwg::store_rows<DK>(dv + head, rs, l0, T_, adv, 1.f, warp, g, t);
  }
}

// dQ. One block per (b * H + h, 128 query rows), heavy causal tiles
// first. The producer loads the block's Q and dO once, then streams (K,
// V) tiles of 64 lines up to the causal diagonal. Consumer c owns rows
// rbase = row0 + 64 c (lse and delta of its thread's two rows in
// registers); per tile it computes S = Q K^T and dP = dO V^T (m64n64k16
// from shared memory), dS = P (dP - delta) in registers, then dQ += dS K
// (m64n{dk}k16, dS from registers, K read MN-major).
template <int DK>
__global__ void __launch_bounds__(bwg::kThreads, 1)
flash_bwd_q_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                         const __grid_constant__ CUtensorMap kmap,
                         const __grid_constant__ CUtensorMap vmap,
                         const __grid_constant__ CUtensorMap domap,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         __nv_bfloat16* __restrict__ dq, int S, int T_, int H, int causal,
                         float scale) {
  using namespace hopper;
  using L = bwg::QSmem<DK>;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[bwg::kStages], empty[bwg::kStages], qfull;
  unsigned char* sQ = bwg::aligned_smem(smem_raw);
  unsigned char* sdO = sQ + L::kQ;
  unsigned char* sK = sdO + L::kQ;  // stage st: K at st * 2 kK, V after it

  const int row0 = (gridDim.x - 1 - blockIdx.x) * bwg::kQRows;  // heavy tiles first
  const int n = blockIdx.y, b = n / H, h = n % H;
  const int t_end = causal ? min(T_, row0 + bwg::kQRows) : T_;
  const int ntiles = (t_end + bwg::kQLines - 1) / bwg::kQLines;
  const int group = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(&qfull, 1);
    for (int st = 0; st < bwg::kStages; ++st) {
      mbar_init(&full[st], 1);
      mbar_init(&empty[st], 8);
    }
    fence_mbar_init();
  }
  __syncthreads();

  if (group == 0) {
    reg_dealloc<bwg::kProducerRegs>();
    if (threadIdx.x == 0) {
      mbar_expect_tx(&qfull, 2 * L::kQ);
      for (int bx = 0; bx < L::kBoxes; ++bx) {
        tma_load_4d(sQ + bx * L::kQBox, &qmap, &qfull, bx * bwg::kBoxCols, h, row0, b);
        tma_load_4d(sdO + bx * L::kQBox, &domap, &qfull, bx * bwg::kBoxCols, h, row0, b);
      }
      for (int j = 0; j < ntiles; ++j) {
        const int st = j % bwg::kStages;
        mbar_wait(&empty[st], ((j / bwg::kStages) & 1) ^ 1);
        mbar_expect_tx(&full[st], 2 * L::kK);
        unsigned char* k = sK + st * 2 * L::kK;
        for (int bx = 0; bx < L::kBoxes; ++bx) {
          tma_load_4d(k + bx * L::kKBox, &kmap, &full[st], bx * bwg::kBoxCols, h,
                      j * bwg::kQLines, b);
          tma_load_4d(k + L::kK + bx * L::kKBox, &vmap, &full[st], bx * bwg::kBoxCols, h,
                      j * bwg::kQLines, b);
        }
      }
    }
  } else {
    reg_alloc<bwg::kConsumerRegs>();
    const int c = group - 1;
    const int tid = threadIdx.x - 128 * group, warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, t = lane % 4;
    const int rbase = row0 + 64 * c;
    const int ra = rbase + 16 * warp + g, rb = ra + 8;  // this thread's rows
    const int my_end = causal ? min(T_, rbase + 64) : T_;
    const float scale2 = scale * kLog2e;
    float lse2[2], dlt[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = i ? rb : ra;
      lse2[i] = r < S ? lse[(size_t)n * S + r] * kLog2e : 0.f;
      dlt[i] = r < S ? delta[(size_t)n * S + r] : 0.f;
    }

    float adq[DK / 8][4];
#pragma unroll
    for (int nt = 0; nt < DK / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) adq[nt][e] = 0.f;
    mbar_wait(&qfull, 0);

    for (int j = 0; j < ntiles; ++j) {
      const int st = j % bwg::kStages, t0 = j * bwg::kQLines;
      mbar_wait(&full[st], (j / bwg::kStages) & 1);
      if (t0 < my_end) {
        const unsigned char* k = sK + st * 2 * L::kK;
        const unsigned char* v = k + L::kK;
        float s[8][4], dp[8][4];
        wgmma_fence();
        bwg::product_ss<DK>(s, sQ + c * 64 * 128, L::kQBox, k, L::kKBox);
        bwg::product_ss<DK>(dp, sdO + c * 64 * 128, L::kQBox, v, L::kKBox);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(s);
        fence_regs(dp);

        // s[nt][e]: row ra (e < 2) or rb, line t0 + 8 nt + 2 t + (e & 1)
        const bool edge = t0 + bwg::kQLines > T_ || (causal && t0 + bwg::kQLines - 1 > rbase);
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = e >> 1;
            float p = exp2_ftz(fmaf(s[nt][e], scale2, -lse2[i]));
            if (edge && !attends(i ? rb : ra, t0 + 8 * nt + 2 * t + (e & 1), S, T_, causal))
              p = 0.f;
            dp[nt][e] = p * (dp[nt][e] - dlt[i]);
          }
        uint32_t dh[4][4], dl[4][4];
#pragma unroll
        for (int kt = 0; kt < 4; ++kt) acc_to_a(dp[2 * kt], dp[2 * kt + 1], dh[kt], dl[kt]);
        wgmma_fence();
        bwg::product_rs<DK>(adq, dh, dl, k, L::kKBox);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(adq);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[st]);
    }

    const size_t rs = (size_t)H * DK;
    bwg::store_rows<DK>(dq + ((size_t)b * S * H + h) * DK, rs, rbase, S, adq, scale, warp, g,
                        t);
  }
}

template <int DK>
cudaError_t launch_kv_bf16(const void* q, const void* k, const void* v, const void* dout,
                           const float* lse, const float* delta, void* dk, void* dv,
                           int B, int S, int T_, int H, int causal, float scale,
                           cudaStream_t stream) {
  CUtensorMap qmap, kmap, vmap, domap;
  cudaError_t err = hopper::make_map(&qmap, q, B, S, H, DK, bwg::kKvRows);
  if (err == cudaSuccess) err = hopper::make_map(&domap, dout, B, S, H, DK, bwg::kKvRows);
  if (err == cudaSuccess) err = hopper::make_map(&kmap, k, B, T_, H, DK, bwg::kKvLines);
  if (err == cudaSuccess) err = hopper::make_map(&vmap, v, B, T_, H, DK, bwg::kKvLines);
  if (err != cudaSuccess) return err;
  constexpr size_t kSmem = bwg::KvSmem<DK>::kBytes;
  err = set_smem(flash_bwd_kv_wgmma_kernel<DK>, kSmem);
  if (err != cudaSuccess) return err;
  dim3 grid((T_ + bwg::kKvLines - 1) / bwg::kKvLines, B * H);
  flash_bwd_kv_wgmma_kernel<DK><<<grid, bwg::kThreads, kSmem, stream>>>(
      qmap, kmap, vmap, domap, lse, delta, static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), S, T_, H, causal, scale);
  return cudaGetLastError();
}

template <int DK>
cudaError_t launch_q_bf16(const void* q, const void* k, const void* v, const void* dout,
                          const float* lse, const float* delta, void* dq, int B, int S,
                          int T_, int H, int causal, float scale, cudaStream_t stream) {
  CUtensorMap qmap, kmap, vmap, domap;
  cudaError_t err = hopper::make_map(&qmap, q, B, S, H, DK, bwg::kQRows);
  if (err == cudaSuccess) err = hopper::make_map(&domap, dout, B, S, H, DK, bwg::kQRows);
  if (err == cudaSuccess) err = hopper::make_map(&kmap, k, B, T_, H, DK, bwg::kQLines);
  if (err == cudaSuccess) err = hopper::make_map(&vmap, v, B, T_, H, DK, bwg::kQLines);
  if (err != cudaSuccess) return err;
  constexpr size_t kSmem = bwg::QSmem<DK>::kBytes;
  err = set_smem(flash_bwd_q_wgmma_kernel<DK>, kSmem);
  if (err != cudaSuccess) return err;
  dim3 grid((S + bwg::kQRows - 1) / bwg::kQRows, B * H);
  flash_bwd_q_wgmma_kernel<DK><<<grid, bwg::kThreads, kSmem, stream>>>(
      qmap, kmap, vmap, domap, lse, delta, static_cast<__nv_bfloat16*>(dq), S, T_, H, causal,
      scale);
  return cudaGetLastError();
}

template <typename T, int DK>
cudaError_t launch_kv(const void* q, const void* k, const void* v, const void* dout,
                      const float* lse, const float* delta, void* dk, void* dv,
                      int B, int S, int T_, int H, int causal, float scale,
                      cudaStream_t stream) {
  constexpr size_t kSmem = BwdSmem<DK>::kKv;
  cudaError_t err = set_smem(flash_bwd_kv_kernel<T, DK>, kSmem);
  if (err != cudaSuccess) return err;
  dim3 grid((T_ + kLines - 1) / kLines, B * H);
  flash_bwd_kv_kernel<T, DK><<<grid, kThreads, kSmem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, delta, static_cast<T*>(dk),
      static_cast<T*>(dv), S, T_, H, causal, scale);
  return cudaGetLastError();
}

template <typename T, int DK>
cudaError_t launch_q(const void* q, const void* k, const void* v, const void* dout,
                     const float* lse, const float* delta, void* dq, int B, int S,
                     int T_, int H, int causal, float scale, cudaStream_t stream) {
  constexpr size_t kSmem = BwdSmem<DK>::kQ;
  cudaError_t err = set_smem(flash_bwd_q_kernel<T, DK>, kSmem);
  if (err != cudaSuccess) return err;
  dim3 grid((S + kRows - 1) / kRows, B * H);
  flash_bwd_q_kernel<T, DK><<<grid, kThreads, kSmem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, delta, static_cast<T*>(dq), S, T_, H, causal,
      scale);
  return cudaGetLastError();
}

bool valid_dims(int B, int S, int T, int H) {
  return B > 0 && S > 0 && T > 0 && H > 0 && B * H <= 65535;
}

}  // namespace
}  // namespace fft

extern "C" int flash_attention_bwd_kv_launch(
    const void* q, const void* k, const void* v, const void* dout, const void* lse,
    const void* delta, void* dk, void* dv, int B, int S, int T, int H, int dkh,
    int causal, int dtype, float scale, void* stream) {
  if (!fft::valid_dims(B, S, T, H)) return (int)cudaErrorInvalidValue;
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == fft::kBFloat16) {
    if (dkh == 64) return (int)fft::launch_kv_bf16<64>(q, k, v, dout, l, dl, dk, dv, B, S, T, H, causal, scale, s);
    if (dkh == 128) return (int)fft::launch_kv_bf16<128>(q, k, v, dout, l, dl, dk, dv, B, S, T, H, causal, scale, s);
  } else if (dtype == fft::kFloat32) {
    if (dkh == 64) return (int)fft::launch_kv<float, 64>(q, k, v, dout, l, dl, dk, dv, B, S, T, H, causal, scale, s);
    if (dkh == 128) return (int)fft::launch_kv<float, 128>(q, k, v, dout, l, dl, dk, dv, B, S, T, H, causal, scale, s);
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" int flash_attention_bwd_q_launch(
    const void* q, const void* k, const void* v, const void* dout, const void* lse,
    const void* delta, void* dq, int B, int S, int T, int H, int dkh, int causal,
    int dtype, float scale, void* stream) {
  if (!fft::valid_dims(B, S, T, H)) return (int)cudaErrorInvalidValue;
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == fft::kBFloat16) {
    if (dkh == 64) return (int)fft::launch_q_bf16<64>(q, k, v, dout, l, dl, dq, B, S, T, H, causal, scale, s);
    if (dkh == 128) return (int)fft::launch_q_bf16<128>(q, k, v, dout, l, dl, dq, B, S, T, H, causal, scale, s);
  } else if (dtype == fft::kFloat32) {
    if (dkh == 64) return (int)fft::launch_q<float, 64>(q, k, v, dout, l, dl, dq, B, S, T, H, causal, scale, s);
    if (dkh == 128) return (int)fft::launch_q<float, 128>(q, k, v, dout, l, dl, dq, B, S, T, H, causal, scale, s);
  }
  return (int)cudaErrorInvalidValue;
}

// The design either launcher takes for q of DType dtype: 0 "f32" (the
// CUDA cores), 1 "wgmma".
extern "C" int flash_attention_bwd_kv_design(int dtype) { return dtype == fft::kBFloat16; }
extern "C" int flash_attention_bwd_q_design(int dtype) { return dtype == fft::kBFloat16; }

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
