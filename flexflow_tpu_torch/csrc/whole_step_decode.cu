// whole_step_decode — the whole LLaMA serving step (all L layers, the
// final norm, the LM head at logits_idx and the greedy argmax) as one
// persistent cooperative kernel, for sm_90a.
//
// Replaces both Pallas TPU kernels of the whole-step walk,
// flexflow_tpu/serve/kernels.py whole_step_decode (grid (L,)) and
// _whole_step_decode_tiled (grid (L, 4 K): the projection weights
// streamed in K output-column tiles). It computes what
// models/llama.serve_step_whole computes after the embedding: per layer
//   1. RMS norm (rows)                       x -> h
//   2. Q/K/V projections                     h -> partial sums
//   3. per (slot, KV head): the Q/K/V lines from the partial sums, RoPE,
//      the in-place commit of the new K/V lines into their pages (a
//      scatter, or kv_quant.quant_line_write's arithmetic on quantized
//      pools; paged_commit.cuh), then paged attention over the slot's
//      table (attend_decode or attend_tile of paged_attention.cuh)
//   4. out-projection                        attn -> partial sums
//   5. residual + RMS norm (rows)            x2 = x + o, h2
//   6. w1 / w3 projections                   h2 -> partial sums
//   7. SiLU(gate) * up (elementwise)         act
//   8. w2 projection                         act -> partial sums, whose
//      residual the next layer's step 1 adds
// then the last residual and the final norm of the logits_idx rows, the
// f32 LM head (in column items no wider than the layers' widest tile) and
// a grid-wide first-maximum argmax. A grid-wide barrier
// (cooperative_groups grid sync) separates the stages.
//
// Rounding follows the plain PyTorch path (models/llama.py): each
// projection output element rounds once to the model dtype; _rms rounds
// (x * r) to the model dtype and then multiplies by gamma in the model
// dtype; SiLU(gate) rounds to the model dtype before the product with up;
// the LM head multiplies model-dtype values with f32 accumulation (bf16
// products are exact in f32, so this is the plain f32 head up to
// summation order).
//
// Projections: one work item is (a row tile of 16, 32 or 64 rows, one
// output-column tile of width N / tiles, one of KS contraction slices). The block
// streams its weight columns and activation rows through shared memory in
// 32-deep K chunks (cp.async, double-buffered) and accumulates in
// registers: bf16 on the tensor cores (mma.sync.m16n8k16, f32
// accumulation), f32 on the CUDA cores. The KS slices of an output
// element are summed in slice order by the stage that reads them. KS
// depends on the row count alone (and row tiles group rows only), so
// every output element's contraction runs in one order at every tile
// count: logits, tokens and pool bytes
// are bitwise equal across the legal tile counts (the JAX contract that
// tiles split only output columns). Weights are read through their
// strides; a tied head reads embed (V, D) as the transposed head.
//
// Bound on an H100: a decode step reads every weight once (13.2 GB at
// LLaMA-7B in bf16) plus the K/V lines it attends, over 3.35 TB/s; a
// mixed step at C = 128 does 2 * rows * weights FLOP, over 989 TFLOP/s
// (bf16) or 67 TFLOP/s (f32 on the CUDA cores). Design against it: the
// weights are read once per row tile (once per step at decode), the
// K-split fills the SMs when a step has few rows, the hidden state lives
// in a global scratch that L2 holds at decode, and no pool slice is ever
// staged whole. Later work: wgmma and TMA for the projections.
#include <algorithm>
#include <climits>
#include <cmath>

#include <cooperative_groups.h>

#include "paged_commit.cuh"

namespace fft {
namespace {

namespace coop = cooperative_groups;

constexpr int kThreads = 256;   // one block size for every stage
constexpr int kWarps = kThreads / 32;
constexpr int kBK = 32;         // K depth of a staged chunk
constexpr int kMaxFrags = 24;   // 16 x 8 accumulator fragments per warp
constexpr int kHeadCols = 256;  // LM-head columns per work item
constexpr int kAttnRows = kThreads / kRowGroup * kRowsPerThread;  // attend_tile rows

struct WholeArgs {
  // layer weights, stacked on a leading layer dim (model dtype)
  const void *attn_norm, *wq, *wk, *wv, *wo, *ffn_norm, *w1, *w2, *w3;
  const void* final_norm;
  const void* head;        // lm_head (D, V), or embed (V, D) when tied
  const void* x0;          // (R, C, D) embedded step input
  const float* cos;        // (R, C, dk)
  const float* sin;
  void* k_pool;            // (L, P1, ps, KV, dk / pack)
  void* v_pool;
  float* k_scale;          // (L, P1, KV), quantized pools only
  float* v_scale;
  const int* table;        // (R, NP)
  const int* phys;         // (R, C)
  const int* off;          // (R, C)
  const uint8_t* mask;     // (R, C, NP * ps)
  const int* logits_idx;   // (R,)
  float* logits;           // (R, V) out
  int* tokens;             // (R,) out
  void* scratch;           // model-dtype scratch, see Scratch
  float* work;             // (KS, R * C, Nw) f32 partial sums
  int L, R, C, D, H, KV, dk, F, V, ps, NP, P1, tiles, KS, tied;
  float eps, scale, qmax;
};

// Model-dtype buffers carved out of WholeArgs::scratch, in this order
// (the wrapper allocates their sum).
template <typename T>
struct Scratch {
  T *x, *h, *x2, *h2, *qraw, *qrot, *attn, *knew, *vnew, *krot, *act, *hf;
  __device__ explicit Scratch(const WholeArgs& a) {
    const size_t M = (size_t)a.R * a.C, D = a.D, Q = (size_t)a.H * a.dk,
                 KVd = (size_t)a.KV * a.dk;
    T* p = static_cast<T*>(a.scratch);
    x = p; p += M * D;
    h = p; p += M * D;
    x2 = p; p += M * D;
    h2 = p; p += M * D;
    qraw = p; p += M * Q;
    qrot = p; p += M * Q;
    attn = p; p += M * Q;
    knew = p; p += M * KVd;
    vnew = p; p += M * KVd;
    krot = p; p += M * KVd;
    act = p; p += M * (size_t)a.F;
    hf = p;
  }
};

// Loads of data other blocks wrote earlier in this launch go through L2
// (ld.global.cg): the SM's L1 is not kept coherent with other SMs' stores.
template <typename T> __device__ __forceinline__ float ld_l2(const T* p);
template <> __device__ __forceinline__ float ld_l2<float>(const float* p) { return __ldcg(p); }
template <> __device__ __forceinline__ float ld_l2<__nv_bfloat16>(const __nv_bfloat16* p) {
  return __bfloat162float(__ushort_as_bfloat16(__ldcg(reinterpret_cast<const unsigned short*>(p))));
}

__host__ __device__ constexpr int imax(int a, int b) { return a > b ? a : b; }
__host__ __device__ constexpr int imin(int a, int b) { return a < b ? a : b; }

// The widest output-column tile of the layer projections; LM-head work
// items are no wider (at most kHeadCols).
__host__ __device__ inline int head_width_cap(const WholeArgs& a) {
  return imax(imax(a.H * a.dk, a.KV * a.dk), imax(a.D, a.F)) / a.tiles;
}

__host__ __device__ inline int head_width(const WholeArgs& a) {
  return imin(imin(kHeadCols, a.V), head_width_cap(a));
}

// 16-row fragments of a row tile: one for a step of at most 16 rows,
// else the most (4, 2, 1) whose accumulators for a column tile of width w
// fit a warp's kMaxFrags. Row tiles group rows only: an output element's
// arithmetic is the same whatever the tile.
__host__ __device__ inline int row_frags(int rows, int w) {
  if (rows <= 16) return 1;
  const int per_warp = (w / 8 + kWarps - 1) / kWarps;
  return per_warp <= kMaxFrags / 4 ? 4 : per_warp <= kMaxFrags / 2 ? 2 : 1;
}

template <typename T>
__device__ __forceinline__ float round_to(float x) { return to_f32<T>(from_f32<T>(x)); }

// Sum of the KS partial sums of element i, in slice order.
__device__ __forceinline__ float partial_sum(const float* part, size_t slice, int KS, size_t i) {
  float s = __ldcg(part + i);
  for (int k = 1; k < KS; ++k) s = __fadd_rn(s, __ldcg(part + k * slice + i));
  return s;
}

__device__ __forceinline__ float block_sum(float x, float* red) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  x = warp_sum(x);
  if (lane == 0) red[warp] = x;
  __syncthreads();
  float s = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) s += red[w];
  __syncthreads();  // red may be rewritten
  return s;
}

// ---------------------------------------------------------------------------
// projections

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory"); }

__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack2(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return uint32_t(__bfloat16_as_ushort(lo)) | (uint32_t(__bfloat16_as_ushort(hi)) << 16);
}

// One projection work item: out[m * ldo + j] = sum over K chunks
// [kc0, kc1) of A[m, k] * W(k, n0 + j), for rows [m0, m0 + 16 MF) below M
// and columns j < width.
struct GemmItem {
  const void* A;        // (M, K) row-major
  int M, K;
  const void* W;        // element (k, n) at W[k * sk + n * sn]; sk == 1 or sn == 1
  size_t sk, sn;
  int n0, width;        // width a multiple of 8
  int m0, kc0, kc1;
  float* out;
  int ldo;
};

// Shared-memory elements of one stage buffer pair (A chunk and W chunk).
template <typename T, int MF>
__host__ __device__ constexpr size_t gemm_buf_elems(int width) {
  return size_t(16 * MF) * (kBK + 16 / sizeof(T)) + size_t(kBK) * (width + 16 / sizeof(T));
}

template <typename T, int MF>
__device__ void gemm_item(const GemmItem& it, unsigned char* smem_raw) {
  constexpr int BM = 16 * MF, NJ = kMaxFrags / MF, V8 = 16 / sizeof(T);
  constexpr int LA = kBK + V8;
  const int W = it.width, LB = W + V8, NF = W / 8;
  T* smem = reinterpret_cast<T*>(smem_raw);
  T* sA[2] = {smem, smem + gemm_buf_elems<T, MF>(W)};
  T* sB[2] = {sA[0] + BM * LA, sA[1] + BM * LA};
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const T* A = static_cast<const T*>(it.A);
  const T* Wp = static_cast<const T*>(it.W);

  auto load = [&](int buf, int kc) {
    const int kb = kc * kBK;
    for (int idx = tid; idx < BM * (kBK / V8); idx += kThreads) {
      const int r = idx / (kBK / V8), v = (idx % (kBK / V8)) * V8;
      T* dst = sA[buf] + r * LA + v;
      if (it.m0 + r < it.M) {
        cp_async16(dst, A + (size_t)(it.m0 + r) * it.K + kb + v);
      } else {
        *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
      }
    }
    if (it.sn == 1) {
      for (int idx = tid; idx < kBK * (W / V8); idx += kThreads) {
        const int k = idx / (W / V8), v = (idx % (W / V8)) * V8;
        cp_async16(sB[buf] + k * LB + v, Wp + (size_t)(kb + k) * it.sk + it.n0 + v);
      }
    } else {  // transposed: W(k, n) = head[n * sn + k], 16 bytes along k
      for (int idx = tid; idx < W * (kBK / V8); idx += kThreads) {
        const int n = idx / (kBK / V8), k = (idx % (kBK / V8)) * V8;
        const uint4 raw = *reinterpret_cast<const uint4*>(Wp + (size_t)(it.n0 + n) * it.sn + kb + k);
        const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
        for (int i = 0; i < V8; ++i) sB[buf][(k + i) * LB + n] = e[i];
      }
    }
  };

  float acc[NJ][MF][4];
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int mf = 0; mf < MF; ++mf)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][mf][e] = 0.f;

  if (it.kc0 < it.kc1) {
    load(0, it.kc0);
    cp_async_commit();
  }
  for (int kc = it.kc0; kc < it.kc1; ++kc) {
    const int cur = (kc - it.kc0) & 1;
    if (kc + 1 < it.kc1) {
      load(cur ^ 1, kc + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* a_s = sA[cur];
    const T* b_s = sB[cur];
    if constexpr (sizeof(T) == 2) {
#pragma unroll
      for (int kk = 0; kk < kBK; kk += 16) {
        uint32_t af[MF][4];
#pragma unroll
        for (int mf = 0; mf < MF; ++mf) {
          const T* p = a_s + (mf * 16 + g) * LA + kk + 2 * t;
          af[mf][0] = *reinterpret_cast<const uint32_t*>(p);
          af[mf][1] = *reinterpret_cast<const uint32_t*>(p + 8 * LA);
          af[mf][2] = *reinterpret_cast<const uint32_t*>(p + 8);
          af[mf][3] = *reinterpret_cast<const uint32_t*>(p + 8 * LA + 8);
        }
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const int nf = warp + kWarps * j;
          if (nf >= NF) continue;  // warp-uniform
          const T* bp = b_s + (kk + 2 * t) * LB + nf * 8 + g;
          const uint32_t b0 = pack2(bp[0], bp[LB]);
          const uint32_t b1 = pack2(bp[8 * LB], bp[9 * LB]);
#pragma unroll
          for (int mf = 0; mf < MF; ++mf) mma16816(acc[j][mf], af[mf], b0, b1);
        }
      }
    } else {
#pragma unroll 4
      for (int kk = 0; kk < kBK; ++kk) {
        float a0[MF], a1[MF];
#pragma unroll
        for (int mf = 0; mf < MF; ++mf) {
          a0[mf] = a_s[(mf * 16 + g) * LA + kk];
          a1[mf] = a_s[(mf * 16 + g + 8) * LA + kk];
        }
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const int nf = warp + kWarps * j;
          if (nf >= NF) continue;
          const float b0 = b_s[kk * LB + nf * 8 + 2 * t];
          const float b1 = b_s[kk * LB + nf * 8 + 2 * t + 1];
#pragma unroll
          for (int mf = 0; mf < MF; ++mf) {
            acc[j][mf][0] = fmaf(a0[mf], b0, acc[j][mf][0]);
            acc[j][mf][1] = fmaf(a0[mf], b1, acc[j][mf][1]);
            acc[j][mf][2] = fmaf(a1[mf], b0, acc[j][mf][2]);
            acc[j][mf][3] = fmaf(a1[mf], b1, acc[j][mf][3]);
          }
        }
      }
    }
    __syncthreads();  // the next load overwrites this buffer
  }

#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int nf = warp + kWarps * j;
    if (nf >= NF) continue;
    const int col = nf * 8 + 2 * t;
#pragma unroll
    for (int mf = 0; mf < MF; ++mf) {
      const int r0 = it.m0 + mf * 16 + g;
      if (r0 < it.M) {
        it.out[(size_t)r0 * it.ldo + col] = acc[j][mf][0];
        it.out[(size_t)r0 * it.ldo + col + 1] = acc[j][mf][1];
      }
      if (r0 + 8 < it.M) {
        it.out[(size_t)(r0 + 8) * it.ldo + col] = acc[j][mf][2];
        it.out[(size_t)(r0 + 8) * it.ldo + col + 1] = acc[j][mf][3];
      }
    }
  }
}

// One projection stage: up to three weights side by side in the output
// row (of width ldo), each cut into column tiles of width[r]; work items
// (weight, column tile, row tile, K slice) spread over the grid. Slice s
// writes out + s * M * ldo.
struct GemmStage {
  const void* A;
  int M, K, KS, n;
  const void* W[3];
  int N[3], width[3];
  size_t sk[3], sn[3];
  float* out;
  int ldo;
};

// Not inlined: one copy per (T, MF) serves every stage of every kernel
// instantiation (pool type, head dim), which keeps the build short.
template <typename T, int MF>
__device__ __noinline__ void run_gemm_stage(const GemmStage& s, unsigned char* smem) {
  constexpr int BM = 16 * MF;
  const int RT = (s.M + BM - 1) / BM, nch = s.K / kBK;
  int total = 0, tiles[3];
  for (int r = 0; r < s.n; ++r) {
    tiles[r] = (s.N[r] + s.width[r] - 1) / s.width[r];
    total += tiles[r] * RT * s.KS;
  }
  for (int u = blockIdx.x; u < total; u += gridDim.x) {
    int rest = u, r = 0, col = 0;
    while (rest >= tiles[r] * RT * s.KS) {
      rest -= tiles[r] * RT * s.KS;
      col += s.N[r];
      ++r;
    }
    const int ks = rest % s.KS, rt = (rest / s.KS) % RT, tile = rest / s.KS / RT;
    const int n0 = tile * s.width[r];
    GemmItem it;
    it.A = s.A;
    it.M = s.M;
    it.K = s.K;
    it.W = s.W[r];
    it.sk = s.sk[r];
    it.sn = s.sn[r];
    it.n0 = n0;
    it.width = min(s.width[r], s.N[r] - n0);
    it.m0 = rt * BM;
    it.kc0 = ks * nch / s.KS;
    it.kc1 = (ks + 1) * nch / s.KS;
    it.out = s.out + (size_t)ks * s.M * s.ldo + col + n0;
    it.ldo = s.ldo;
    gemm_item<T, MF>(it, smem);
  }
}

template <typename T>
__device__ void gemm_stage(const GemmStage& s, int mf, unsigned char* smem) {
  if (mf == 4) {
    run_gemm_stage<T, 4>(s, smem);
  } else if (mf == 2) {
    run_gemm_stage<T, 2>(s, smem);
  } else {
    run_gemm_stage<T, 1>(s, smem);
  }
}

// ---------------------------------------------------------------------------
// row stages

// x_out = x_in (+ the rounded partial sums of the previous projection,
// when part is given), then h = rms(x_out) * gamma, for row m. x_in and
// x_out may alias (the same thread reads and writes each element).
template <typename T>
__device__ void residual_norm_row(const T* x_in, const float* part, size_t slice, int KS,
                                  T* x_out, T* h, const T* gamma, int D, float eps, float* red) {
  float ss = 0.f;
  for (int d = threadIdx.x; d < D; d += kThreads) {
    float x = ld_l2<T>(x_in + d);
    if (part != nullptr) x = round_to<T>(__fadd_rn(x, round_to<T>(partial_sum(part, slice, KS, d))));
    x_out[d] = from_f32<T>(x);
    ss = fmaf(x, x, ss);
  }
  const float r = 1.f / sqrtf(__fdiv_rn(block_sum(ss, red), (float)D) + eps);
  for (int d = threadIdx.x; d < D; d += kThreads) {
    const float x = to_f32<T>(x_out[d]);
    h[d] = from_f32<T>(__fmul_rn(round_to<T>(__fmul_rn(x, r)), to_f32<T>(gamma[d])));
  }
}

// ---------------------------------------------------------------------------
// the kernel

template <typename TQ, int KIND, int DK>
__global__ void __launch_bounds__(kThreads, 1) whole_step_kernel(WholeArgs a) {
  using T = TQ;
  using P = typename PoolT<TQ, KIND>::T;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float red[kWarps];
  coop::grid_group grid = coop::this_grid();
  const Scratch<T> s(a);
  const int M = a.R * a.C, D = a.D, Q = a.H * DK, KVd = a.KV * DK, F = a.F;
  const int G = a.H / a.KV;
  const int dkp = DK / pack_of<KIND>();
  const size_t pool_layer = (size_t)a.P1 * a.ps * a.KV * dkp;
  const size_t scale_layer = (size_t)a.P1 * a.KV;
  const int mf = row_frags(M, head_width_cap(a));

  for (int l = 0; l < a.L; ++l) {
    const T* attn_norm = static_cast<const T*>(a.attn_norm) + (size_t)l * D;
    const T* ffn_norm = static_cast<const T*>(a.ffn_norm) + (size_t)l * D;

    // 1. residual of the previous layer's w2 (or x0), attention norm
    for (int m = blockIdx.x; m < M; m += gridDim.x) {
      if (l == 0) {
        residual_norm_row<T>(static_cast<const T*>(a.x0) + (size_t)m * D, nullptr, 0, 0,
                             s.x + (size_t)m * D, s.h + (size_t)m * D, attn_norm, D, a.eps, red);
      } else {
        residual_norm_row<T>(s.x2 + (size_t)m * D, a.work + (size_t)m * D, (size_t)M * D, a.KS,
                             s.x + (size_t)m * D, s.h + (size_t)m * D, attn_norm, D, a.eps,
                             red);
      }
    }
    grid.sync();

    // 2. Q, K, V
    {
      GemmStage st{};
      st.A = s.h;
      st.M = M;
      st.K = D;
      st.KS = a.KS;
      st.n = 3;
      const void* w[3] = {a.wq, a.wk, a.wv};
      const int n[3] = {Q, KVd, KVd};
      for (int r = 0; r < 3; ++r) {
        st.W[r] = static_cast<const T*>(w[r]) + (size_t)l * D * n[r];
        st.N[r] = n[r];
        st.width[r] = n[r] / a.tiles;
        st.sk[r] = n[r];
        st.sn[r] = 1;
      }
      st.out = a.work;
      st.ldo = Q + 2 * KVd;
      gemm_stage<T>(st, mf, smem);
    }
    grid.sync();

    // 3. Q/K/V lines, RoPE + commit, attention, per (slot, KV head)
    {
      const size_t sl = (size_t)M * (Q + 2 * KVd);
      const int ld = Q + 2 * KVd;
      PagedArgs pa{s.qrot,
                   static_cast<P*>(a.k_pool) + l * pool_layer,
                   static_cast<P*>(a.v_pool) + l * pool_layer,
                   KIND == kPoolFloat ? nullptr : a.k_scale + l * scale_layer,
                   KIND == kPoolFloat ? nullptr : a.v_scale + l * scale_layer,
                   a.table, a.mask, s.attn, a.R, a.C, a.H, a.KV, a.ps, a.NP, a.scale};
      CommitArgs f;
      f.a = pa;
      f.q_raw = s.qraw;
      f.k_new = s.knew;
      f.v_new = s.vnew;
      f.cos = a.cos;
      f.sin = a.sin;
      f.k_pool = static_cast<P*>(a.k_pool) + l * pool_layer;
      f.v_pool = static_cast<P*>(a.v_pool) + l * pool_layer;
      f.k_scale = KIND == kPoolFloat ? nullptr : a.k_scale + l * scale_layer;
      f.v_scale = KIND == kPoolFloat ? nullptr : a.v_scale + l * scale_layer;
      f.q_rot = s.qrot;
      f.k_rot = s.krot;
      f.logical = nullptr;
      f.phys = a.phys;
      f.off = a.off;
      f.rot = DK;
      f.qmax = a.qmax;
      for (int u = blockIdx.x; u < a.R * a.KV; u += gridDim.x) {
        const int r = u / a.KV, kh = u % a.KV;
        for (int idx = threadIdx.x; idx < a.C * (G + 2) * DK; idx += kThreads) {
          const int d = idx % DK, j = idx / DK, c = j / (G + 2), e = j % (G + 2);
          const size_t m = (size_t)r * a.C + c;
          if (e < G) {
            const int col = (kh * G + e) * DK + d;
            s.qraw[m * Q + col] = from_f32<T>(partial_sum(a.work, sl, a.KS, m * ld + col));
          } else {
            const int col = kh * DK + d;
            const int base = e == G ? Q : Q + KVd;
            T* dst = e == G ? s.knew : s.vnew;
            dst[m * KVd + col] = from_f32<T>(partial_sum(a.work, sl, a.KS, m * ld + base + col));
          }
        }
        __syncthreads();
        rope_and_commit<T, KIND, DK, kThreads>(f, r, kh);
        const int rows = a.C * G;
        if (rows == 1) {
          attend_decode<T, KIND, DK, 1>(pa, r, kh, 0);
        } else {
          for (int row0 = 0; row0 < rows; row0 += kAttnRows)
            attend_tile<T, KIND, DK, kThreads>(pa, r, kh, row0, reinterpret_cast<float*>(smem));
        }
      }
    }
    grid.sync();

    // 4. out-projection
    {
      GemmStage st{};
      st.A = s.attn;
      st.M = M;
      st.K = Q;
      st.KS = a.KS;
      st.n = 1;
      st.W[0] = static_cast<const T*>(a.wo) + (size_t)l * Q * D;
      st.N[0] = D;
      st.width[0] = D / a.tiles;
      st.sk[0] = D;
      st.sn[0] = 1;
      st.out = a.work;
      st.ldo = D;
      gemm_stage<T>(st, mf, smem);
    }
    grid.sync();

    // 5. attention residual, MLP norm
    for (int m = blockIdx.x; m < M; m += gridDim.x) {
      residual_norm_row<T>(s.x + (size_t)m * D, a.work + (size_t)m * D, (size_t)M * D, a.KS,
                           s.x2 + (size_t)m * D, s.h2 + (size_t)m * D, ffn_norm, D, a.eps, red);
    }
    grid.sync();

    // 6. gate (w1) and up (w3)
    {
      GemmStage st{};
      st.A = s.h2;
      st.M = M;
      st.K = D;
      st.KS = a.KS;
      st.n = 2;
      st.W[0] = static_cast<const T*>(a.w1) + (size_t)l * D * F;
      st.W[1] = static_cast<const T*>(a.w3) + (size_t)l * D * F;
      for (int r = 0; r < 2; ++r) {
        st.N[r] = F;
        st.width[r] = F / a.tiles;
        st.sk[r] = F;
        st.sn[r] = 1;
      }
      st.out = a.work;
      st.ldo = 2 * F;
      gemm_stage<T>(st, mf, smem);
    }
    grid.sync();

    // 7. act = silu(gate) * up, each rounded to the model dtype
    {
      const size_t sl = (size_t)M * 2 * F;
      for (size_t i = (size_t)blockIdx.x * kThreads + threadIdx.x; i < (size_t)M * F;
           i += (size_t)gridDim.x * kThreads) {
        const size_t m = i / F, j = i % F;
        const float gt = round_to<T>(partial_sum(a.work, sl, a.KS, m * 2 * F + j));
        const float up = round_to<T>(partial_sum(a.work, sl, a.KS, m * 2 * F + F + j));
        const float silu = round_to<T>(__fdiv_rn(gt, __fadd_rn(1.f, expf(-gt))));
        s.act[i] = from_f32<T>(__fmul_rn(silu, up));
      }
    }
    grid.sync();

    // 8. down-projection (its residual is added by the next stage 1)
    {
      GemmStage st{};
      st.A = s.act;
      st.M = M;
      st.K = F;
      st.KS = a.KS;
      st.n = 1;
      st.W[0] = static_cast<const T*>(a.w2) + (size_t)l * F * D;
      st.N[0] = D;
      st.width[0] = D / a.tiles;
      st.sk[0] = D;
      st.sn[0] = 1;
      st.out = a.work;
      st.ldo = D;
      gemm_stage<T>(st, mf, smem);
    }
    grid.sync();
  }

  // the last residual and the final norm, at each slot's logits_idx row
  for (int r = blockIdx.x; r < a.R; r += gridDim.x) {
    const size_t m = (size_t)r * a.C + a.logits_idx[r];
    residual_norm_row<T>(s.x2 + m * D, a.work + m * D, (size_t)M * D, a.KS, s.x + m * D,
                         s.hf + (size_t)r * D, static_cast<const T*>(a.final_norm), D, a.eps,
                         red);
  }
  grid.sync();

  // LM head: f32 logits (R, V)
  {
    GemmStage st{};
    st.A = s.hf;
    st.M = a.R;
    st.K = D;
    st.KS = 1;
    st.n = 1;
    st.W[0] = a.head;
    st.N[0] = a.V;
    st.width[0] = head_width(a);
    st.sk[0] = a.tied ? 1 : a.V;
    st.sn[0] = a.tied ? D : 1;
    st.out = a.logits;
    st.ldo = a.V;
    gemm_stage<T>(st, row_frags(a.R, head_width(a)), smem);
  }
  grid.sync();

  // greedy head: the first maximal index of each row
  __shared__ float best_v[kWarps];
  __shared__ int best_i[kWarps];
  for (int r = blockIdx.x; r < a.R; r += gridDim.x) {
    float bv = -INFINITY;
    int bi = INT_MAX;
    for (int v = threadIdx.x; v < a.V; v += kThreads) {
      const float x = __ldcg(a.logits + (size_t)r * a.V + v);
      if (x > bv) {  // ascending v: the first of equal values stays
        bv = x;
        bi = v;
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, bv, o);
      const int oi = __shfl_xor_sync(0xffffffffu, bi, o);
      if (ov > bv || (ov == bv && oi < bi)) {
        bv = ov;
        bi = oi;
      }
    }
    const int warp = threadIdx.x / 32;
    if (threadIdx.x % 32 == 0) {
      best_v[warp] = bv;
      best_i[warp] = bi;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      for (int w = 1; w < kWarps; ++w) {
        if (best_v[w] > bv || (best_v[w] == bv && best_i[w] < bi)) {
          bv = best_v[w];
          bi = best_i[w];
        }
      }
      a.tokens[r] = bi == INT_MAX ? 0 : bi;
    }
    __syncthreads();
  }
}

template <typename TQ>
size_t gemm_smem(int rows, int w) {
  const int mf = row_frags(rows, w);
  const size_t elems = mf == 4 ? gemm_buf_elems<TQ, 4>(w)
                       : mf == 2 ? gemm_buf_elems<TQ, 2>(w) : gemm_buf_elems<TQ, 1>(w);
  return 2 * elems * sizeof(TQ);
}

// Dynamic shared memory of a launch: the projections' double-buffered
// chunks at the widest column tile (or an LM-head item), or the
// attention's tile design when a KV head has more than one query row.
template <typename TQ, int DK>
size_t dynamic_smem(const WholeArgs& a) {
  const size_t gemm = std::max(gemm_smem<TQ>(a.R * a.C, head_width_cap(a)),
                               gemm_smem<TQ>(a.R, head_width(a)));
  const size_t attn = a.C * (a.H / a.KV) > 1 ? TileSmem<DK, kAttnRows>::kBytes : 0;
  return std::max(gemm, attn);
}

template <typename TQ, int KIND, int DK>
cudaError_t launch(WholeArgs a, cudaStream_t stream) {
  auto kernel = whole_step_kernel<TQ, KIND, DK>;
  const size_t smem = dynamic_smem<TQ, DK>(a);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem)) !=
      cudaSuccess)
    return err;
  // a block that does not fit an SM is an error, never a smaller grid
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  void* args[] = {&a};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel), dim3(sms * per_sm),
                                    dim3(kThreads), args, smem, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename TQ, int KIND>
cudaError_t launch_kind(const WholeArgs& a, cudaStream_t stream) {
  if (a.dk == 64) return launch<TQ, KIND, 64>(a, stream);
  if (a.dk == 128) return launch<TQ, KIND, 128>(a, stream);
  return cudaErrorInvalidValue;
}

template <typename TQ>
cudaError_t launch_q(const WholeArgs& a, int pool_kind, cudaStream_t stream) {
  if (pool_kind == kPoolFloat) return launch_kind<TQ, kPoolFloat>(a, stream);
  if (pool_kind == kPoolInt8) return launch_kind<TQ, kPoolInt8>(a, stream);
  if (pool_kind == kPoolInt4) return launch_kind<TQ, kPoolInt4>(a, stream);
  return cudaErrorInvalidValue;
}

}  // namespace
}  // namespace fft

extern "C" int whole_step_decode_launch(
    const void* attn_norm, const void* wq, const void* wk, const void* wv, const void* wo,
    const void* ffn_norm, const void* w1, const void* w2, const void* w3,
    const void* final_norm, const void* head, const void* x0, const void* cos,
    const void* sin, void* k_pool, void* v_pool, void* k_scale, void* v_scale,
    const void* table, const void* phys, const void* off, const void* mask,
    const void* logits_idx, void* logits, void* tokens, void* scratch, void* work, int L,
    int R, int C, int D, int H, int KV, int dk, int F, int V, int ps, int NP, int P1,
    int tiles, int KS, int tied, int dtype, int pool_kind, float eps, float scale,
    float qmax, void* stream) {
  using namespace fft;
  if (L <= 0 || R <= 0 || C <= 0 || C > kMaxChunk || KV <= 0 || H % KV != 0 || tiles <= 0 ||
      KS <= 0 || NP <= 0)
    return (int)cudaErrorInvalidValue;
  if (ps != 16 && ps != 32 && ps != 64 && ps != 128) return (int)cudaErrorInvalidValue;
  if (D % kBK || (H * dk) % kBK || F % kBK || V % 8) return (int)cudaErrorInvalidValue;
  if ((H * dk) % (8 * tiles) || (KV * dk) % (8 * tiles) || D % (8 * tiles) || F % (8 * tiles))
    return (int)cudaErrorInvalidValue;
  // every column tile's fragments fit a warp's accumulators
  const int wmax = imax(imax(H * dk, KV * dk), imax(D, F)) / tiles;
  if ((wmax / 8 + kWarps - 1) / kWarps > kMaxFrags) return (int)cudaErrorInvalidValue;
  if (pool_kind != kPoolFloat && (k_scale == nullptr || v_scale == nullptr))
    return (int)cudaErrorInvalidValue;
  WholeArgs a;
  a.attn_norm = attn_norm;
  a.wq = wq;
  a.wk = wk;
  a.wv = wv;
  a.wo = wo;
  a.ffn_norm = ffn_norm;
  a.w1 = w1;
  a.w2 = w2;
  a.w3 = w3;
  a.final_norm = final_norm;
  a.head = head;
  a.x0 = x0;
  a.cos = static_cast<const float*>(cos);
  a.sin = static_cast<const float*>(sin);
  a.k_pool = k_pool;
  a.v_pool = v_pool;
  a.k_scale = static_cast<float*>(k_scale);
  a.v_scale = static_cast<float*>(v_scale);
  a.table = static_cast<const int*>(table);
  a.phys = static_cast<const int*>(phys);
  a.off = static_cast<const int*>(off);
  a.mask = static_cast<const uint8_t*>(mask);
  a.logits_idx = static_cast<const int*>(logits_idx);
  a.logits = static_cast<float*>(logits);
  a.tokens = static_cast<int*>(tokens);
  a.scratch = scratch;
  a.work = static_cast<float*>(work);
  a.L = L;
  a.R = R;
  a.C = C;
  a.D = D;
  a.H = H;
  a.KV = KV;
  a.dk = dk;
  a.F = F;
  a.V = V;
  a.ps = ps;
  a.NP = NP;
  a.P1 = P1;
  a.tiles = tiles;
  a.KS = KS;
  a.tied = tied;
  a.eps = eps;
  a.scale = scale;
  a.qmax = qmax;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == kBFloat16) {
    err = launch_q<__nv_bfloat16>(a, pool_kind, s);
  } else if (dtype == kFloat32) {
    err = launch_q<float>(a, pool_kind, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return (int)err;
}

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
