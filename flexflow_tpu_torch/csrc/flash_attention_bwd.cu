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
// GFLOP against ~340 MB each. bf16 inputs run on the tensor cores
// (the *_mma_kernel pair, mma.sync with f32 accumulation; p and ds enter
// their products as hi + lo bf16 operands, their f32 value to ~2^-16),
// f32 inputs on the CUDA cores (67 TFLOP/s peak). wgmma and TMA are the
// later step.
//
// Design against that bound (tiles and thread layouts of
// flash_attention.cuh; the f32 kernels as below, the mma kernels as their
// comments say):
//  * kv: one block per (b * H + h, tile of 64 key lines), K and V staged
//    once; it walks the query tiles from the one holding the diagonal to
//    the end (causal), or all of them, staging Q, dO, lse and delta. Each
//    thread computes a 4 x 4 block of s and dp, writes p and ds to shared
//    memory, and then accumulates dV and dK for 4 lines x dk / 16 columns
//    from float4 reads of p, ds, dO and Q.
//  * q: one block per (b * H + h, tile of 64 query rows), Q, dO, lse and
//    delta staged once; it walks the key tiles up to the diagonal, and
//    accumulates dQ for its 4 rows x dk / 16 columns as the forward
//    kernel accumulates its output.
//  * Rows past S and lines past T are zero in shared memory and masked
//    out (the JAX kernels' NaN guards on padded blocks).
#include "flash_attention.cuh"

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
      const float pr = ok ? expf(p[a][bb] * scale - lse_r) : 0.f;
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
          adv[a][4 * hh + 0] = fmaf(pa[a], dov.x, adv[a][4 * hh + 0]);
          adv[a][4 * hh + 1] = fmaf(pa[a], dov.y, adv[a][4 * hh + 1]);
          adv[a][4 * hh + 2] = fmaf(pa[a], dov.z, adv[a][4 * hh + 2]);
          adv[a][4 * hh + 3] = fmaf(pa[a], dov.w, adv[a][4 * hh + 3]);
          adk[a][4 * hh + 0] = fmaf(sa[a], qv.x, adk[a][4 * hh + 0]);
          adk[a][4 * hh + 1] = fmaf(sa[a], qv.y, adk[a][4 * hh + 1]);
          adk[a][4 * hh + 2] = fmaf(sa[a], qv.z, adk[a][4 * hh + 2]);
          adk[a][4 * hh + 3] = fmaf(sa[a], qv.w, adk[a][4 * hh + 3]);
        }
      }
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
          acc[a][4 * hh + 0] = fmaf(sa[a], kv.x, acc[a][4 * hh + 0]);
          acc[a][4 * hh + 1] = fmaf(sa[a], kv.y, acc[a][4 * hh + 1]);
          acc[a][4 * hh + 2] = fmaf(sa[a], kv.z, acc[a][4 * hh + 2]);
          acc[a][4 * hh + 3] = fmaf(sa[a], kv.w, acc[a][4 * hh + 3]);
        }
      }
    }
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

// The bf16 backward on the tensor cores: blocks of 4 warps, tiles as the
// f32 kernels. Scores and dp are exact bf16 products with f32
// accumulation; p and ds enter the dV/dK/dQ products as hi + lo bf16
// fragments taken from the accumulators.
//
// dK/dV: warp w owns key lines 16 w .. 16 w + 15 of the block's tile and
// computes S^T and dP^T (its lines x 32 rows at a time) from K and V
// (A fragments) against Q and dO (B fragments), then dV += P^T dO and
// dK += dS^T Q with dO and Q staged transposed.
template <int DK>
__global__ void __launch_bounds__(kMmaThreads)
flash_bwd_kv_mma_kernel(const __nv_bfloat16* __restrict__ q,
                        const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v,
                        const __nv_bfloat16* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
                        int S, int T_, int H, int causal, float scale) {
  using bf = __nv_bfloat16;
  constexpr int LQ = LdH<DK>::kRow;
  constexpr int LT = LdH<kRows>::kRow;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf* sK = reinterpret_cast<bf*>(smem_raw);  // [kLines][LQ]
  bf* sV = sK + kLines * LQ;                 // [kLines][LQ]
  bf* sQ = sV + kLines * LQ;                 // [kRows][LQ]
  bf* sdO = sQ + kRows * LQ;                 // [kRows][LQ]
  bf* sQt = sdO + kRows * LQ;                // [DK][LT]
  bf* sdOt = sQt + DK * LT;                  // [DK][LT]
  float* sL = reinterpret_cast<float*>(sdOt + DK * LT);  // [kRows]
  float* sD = sL + kRows;                                // [kRows]

  const int t0 = blockIdx.x * kLines;  // early key tiles walk the most rows
  const int n = blockIdx.y, b = n / H, h = n % H;
  const size_t rs = (size_t)H * DK;
  const size_t qoff = ((size_t)b * S * H + h) * DK;
  const size_t koff = ((size_t)b * T_ * H + h) * DK;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int c_a = t0 + warp * 16 + g, c_b = c_a + 8;  // this thread's lines

  load_rows_bf16<DK, kLines, false>(sK, k + koff, t0, T_, rs);
  load_rows_bf16<DK, kLines, false>(sV, v + koff, t0, T_, rs);

  float adk[DK / 8][4], adv[DK / 8][4];
#pragma unroll
  for (int nt = 0; nt < DK / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) adk[nt][e] = adv[nt][e] = 0.f;

  const int r_begin = causal ? (t0 / kRows) * kRows : 0;
  for (int r0 = r_begin; r0 < S; r0 += kRows) {
    __syncthreads();  // the last tile's reads are done
    load_rows_bf16<DK, kRows, false>(sQ, q + qoff, r0, S, rs);
    load_rows_bf16<DK, kRows, false>(sdO, dout + qoff, r0, S, rs);
    load_rows_bf16<DK, kRows, true>(sQt, q + qoff, r0, S, rs);
    load_rows_bf16<DK, kRows, true>(sdOt, dout + qoff, r0, S, rs);
    for (int i = threadIdx.x; i < kRows; i += kMmaThreads) {
      const int r = r0 + i;
      sL[i] = r < S ? lse[(size_t)n * S + r] : 0.f;
      sD[i] = r < S ? delta[(size_t)n * S + r] : 0.f;
    }
    __syncthreads();

#pragma unroll 1
    for (int half = 0; half < 2; ++half) {  // rows 32 half .. 32 half + 31
      const int rh = half * 32;
      // p^T: c[e] of tile nt at line c_a (e < 2) or c_b, row rh + 8 nt + 2 t + (e & 1)
      float p[4][4], ds[4][4];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) p[nt][e] = ds[nt][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < DK / 16; ++ks) {
        uint32_t ak[4], av[4];
        load_a<LQ>(sK, warp * 16, ks * 16, g, t, ak);
        load_a<LQ>(sV, warp * 16, ks * 16, g, t, av);
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          uint32_t b0, b1;
          load_b<LQ>(sQ, rh + nt * 8, ks * 16, g, t, b0, b1);
          mma16816(p[nt], ak, b0, b1);
          load_b<LQ>(sdO, rh + nt * 8, ks * 16, g, t, b0, b1);
          mma16816(ds[nt], av, b0, b1);
        }
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int ri = rh + nt * 8 + 2 * t + (e & 1);
          const bool ok = attends(r0 + ri, e < 2 ? c_a : c_b, S, T_, causal);
          const float pr = ok ? expf(p[nt][e] * scale - sL[ri]) : 0.f;
          p[nt][e] = pr;
          ds[nt][e] = pr * (ds[nt][e] - sD[ri]) * scale;
        }
#pragma unroll
      for (int kt = 0; kt < 2; ++kt) {
        uint32_t ph[4], pl[4], sh[4], sl[4];
        acc_to_a(p[2 * kt], p[2 * kt + 1], ph, pl);
        acc_to_a(ds[2 * kt], ds[2 * kt + 1], sh, sl);
#pragma unroll
        for (int nt = 0; nt < DK / 8; ++nt) {
          uint32_t b0, b1;
          load_b<LT>(sdOt, nt * 8, rh + kt * 16, g, t, b0, b1);
          mma16816(adv[nt], ph, b0, b1);
          mma16816(adv[nt], pl, b0, b1);
          load_b<LT>(sQt, nt * 8, rh + kt * 16, g, t, b0, b1);
          mma16816(adk[nt], sh, b0, b1);
          mma16816(adk[nt], sl, b0, b1);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int c = i ? c_b : c_a;
    if (c >= T_) continue;
    const size_t off = koff + (size_t)c * rs + 2 * t;
#pragma unroll
    for (int nt = 0; nt < DK / 8; ++nt) {
      *reinterpret_cast<uint32_t*>(dk + off + nt * 8) = pack_bf16(adk[nt][2 * i], adk[nt][2 * i + 1]);
      *reinterpret_cast<uint32_t*>(dv + off + nt * 8) = pack_bf16(adv[nt][2 * i], adv[nt][2 * i + 1]);
    }
  }
}

// dQ: warp w owns query rows 16 w .. 16 w + 15 of the block's tile; per
// key tile it computes S and dP from Q and dO (A fragments) against K and
// V, then dQ += dS K with K staged transposed.
template <int DK>
__global__ void __launch_bounds__(kMmaThreads)
flash_bwd_q_mma_kernel(const __nv_bfloat16* __restrict__ q,
                       const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v,
                       const __nv_bfloat16* __restrict__ dout,
                       const float* __restrict__ lse, const float* __restrict__ delta,
                       __nv_bfloat16* __restrict__ dq, int S, int T_, int H, int causal,
                       float scale) {
  using bf = __nv_bfloat16;
  constexpr int LQ = LdH<DK>::kRow;
  constexpr int LT = LdH<kLines>::kRow;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf* sQ = reinterpret_cast<bf*>(smem_raw);  // [kRows][LQ]
  bf* sdO = sQ + kRows * LQ;                 // [kRows][LQ]
  bf* sK = sdO + kRows * LQ;                 // [kLines][LQ]
  bf* sV = sK + kLines * LQ;                 // [kLines][LQ]
  bf* sKt = sV + kLines * LQ;                // [DK][LT]

  const int row0 = (gridDim.x - 1 - blockIdx.x) * kRows;  // heavy tiles first
  const int n = blockIdx.y, b = n / H, h = n % H;
  const size_t rs = (size_t)H * DK;
  const size_t qoff = ((size_t)b * S * H + h) * DK;
  const size_t koff = ((size_t)b * T_ * H + h) * DK;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int r_a = row0 + warp * 16 + g, r_b = r_a + 8;  // this thread's rows

  load_rows_bf16<DK, kRows, false>(sQ, q + qoff, row0, S, rs);
  load_rows_bf16<DK, kRows, false>(sdO, dout + qoff, row0, S, rs);
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = i ? r_b : r_a;
    lse_r[i] = r < S ? lse[(size_t)n * S + r] : 0.f;
    delta_r[i] = r < S ? delta[(size_t)n * S + r] : 0.f;
  }

  float acc[DK / 8][4];
#pragma unroll
  for (int nt = 0; nt < DK / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;

  const int t_end = causal ? min(T_, row0 + kRows) : T_;
  for (int t0 = 0; t0 < t_end; t0 += kLines) {
    __syncthreads();  // the last tile's reads of sK/sV/sKt are done
    load_rows_bf16<DK, kLines, false>(sK, k + koff, t0, T_, rs);
    load_rows_bf16<DK, kLines, false>(sV, v + koff, t0, T_, rs);
    load_rows_bf16<DK, kLines, true>(sKt, k + koff, t0, T_, rs);
    __syncthreads();

    // c[e] of tile nt: row r_a (e < 2) or r_b, line t0 + 8 nt + 2 t + (e & 1)
    float p[kLines / 8][4], ds[kLines / 8][4];
#pragma unroll
    for (int nt = 0; nt < kLines / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) p[nt][e] = ds[nt][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < DK / 16; ++ks) {
      uint32_t aq[4], ado[4];
      load_a<LQ>(sQ, warp * 16, ks * 16, g, t, aq);
      load_a<LQ>(sdO, warp * 16, ks * 16, g, t, ado);
#pragma unroll
      for (int nt = 0; nt < kLines / 8; ++nt) {
        uint32_t b0, b1;
        load_b<LQ>(sK, nt * 8, ks * 16, g, t, b0, b1);
        mma16816(p[nt], aq, b0, b1);
        load_b<LQ>(sV, nt * 8, ks * 16, g, t, b0, b1);
        mma16816(ds[nt], ado, b0, b1);
      }
    }
#pragma unroll
    for (int nt = 0; nt < kLines / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        const bool ok = attends(i ? r_b : r_a, t0 + nt * 8 + 2 * t + (e & 1), S, T_, causal);
        const float pr = ok ? expf(p[nt][e] * scale - lse_r[i]) : 0.f;
        ds[nt][e] = pr * (ds[nt][e] - delta_r[i]) * scale;
      }
#pragma unroll
    for (int kt = 0; kt < kLines / 16; ++kt) {
      uint32_t sh[4], sl[4];
      acc_to_a(ds[2 * kt], ds[2 * kt + 1], sh, sl);
#pragma unroll
      for (int nt = 0; nt < DK / 8; ++nt) {
        uint32_t b0, b1;
        load_b<LT>(sKt, nt * 8, kt * 16, g, t, b0, b1);
        mma16816(acc[nt], sh, b0, b1);
        mma16816(acc[nt], sl, b0, b1);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = i ? r_b : r_a;
    if (r >= S) continue;
    const size_t off = qoff + (size_t)r * rs + 2 * t;
#pragma unroll
    for (int nt = 0; nt < DK / 8; ++nt)
      *reinterpret_cast<uint32_t*>(dq + off + nt * 8) = pack_bf16(acc[nt][2 * i], acc[nt][2 * i + 1]);
  }
}

template <int DK>
cudaError_t launch_kv_bf16(const void* q, const void* k, const void* v, const void* dout,
                           const float* lse, const float* delta, void* dk, void* dv,
                           int B, int S, int T_, int H, int causal, float scale,
                           cudaStream_t stream) {
  using bf = __nv_bfloat16;
  constexpr size_t kSmem = sizeof(bf) * (4 * size_t(kRows) * LdH<DK>::kRow
                                         + 2 * size_t(DK) * LdH<kRows>::kRow)
                           + sizeof(float) * 2 * kRows;
  cudaError_t err = set_smem(flash_bwd_kv_mma_kernel<DK>, kSmem);
  if (err != cudaSuccess) return err;
  dim3 grid((T_ + kLines - 1) / kLines, B * H);
  flash_bwd_kv_mma_kernel<DK><<<grid, kMmaThreads, kSmem, stream>>>(
      static_cast<const bf*>(q), static_cast<const bf*>(k), static_cast<const bf*>(v),
      static_cast<const bf*>(dout), lse, delta, static_cast<bf*>(dk), static_cast<bf*>(dv),
      S, T_, H, causal, scale);
  return cudaGetLastError();
}

template <int DK>
cudaError_t launch_q_bf16(const void* q, const void* k, const void* v, const void* dout,
                          const float* lse, const float* delta, void* dq, int B, int S,
                          int T_, int H, int causal, float scale, cudaStream_t stream) {
  using bf = __nv_bfloat16;
  constexpr size_t kSmem = sizeof(bf) * (4 * size_t(kRows) * LdH<DK>::kRow
                                         + size_t(DK) * LdH<kLines>::kRow);
  cudaError_t err = set_smem(flash_bwd_q_mma_kernel<DK>, kSmem);
  if (err != cudaSuccess) return err;
  dim3 grid((S + kRows - 1) / kRows, B * H);
  flash_bwd_q_mma_kernel<DK><<<grid, kMmaThreads, kSmem, stream>>>(
      static_cast<const bf*>(q), static_cast<const bf*>(k), static_cast<const bf*>(v),
      static_cast<const bf*>(dout), lse, delta, static_cast<bf*>(dq), S, T_, H, causal,
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

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
