// whole_step_decode — the whole serving step of a decoder (all L layers,
// the final norm, the LM head at logits_idx and the greedy argmax) as one
// persistent cooperative kernel, for sm_90a.
//
// Replaces both Pallas TPU kernels of the whole-step walk,
// flexflow_tpu/serve/kernels.py whole_step_decode (grid (L,)) and
// _whole_step_decode_tiled (grid (L, 4 K): the projection weights
// streamed in K output-column tiles). It computes what
// models/llama.serve_step_whole and models/transformer.serve_step_whole
// compute after the embedding, the layer body set at run time by
// WholeArgs (the norm kind, the activation, GLU or not, a sequential or
// parallel block, the rotary width, a bias on any projection): per layer
//   1. the residual and the input norm (rows)          x -> h
//   2. Q/K/V projections                     h -> partial sums
//   3. per (slot, KV head): the Q/K/V lines from the partial sums (plus
//      their biases), RoPE over the rotary width (or none),
//      the in-place commit of the new K/V lines into their pages (a
//      scatter, or kv_quant.quant_line_write's arithmetic on quantized
//      pools; paged_commit.cuh), then paged attention over the slot's
//      table in the paged kernels' designs: for at most 8 query rows a
//      KV head (decode steps) every unit commits, a grid barrier follows,
//      and the blocks walk work items (live slot, KV head, row, split) of
//      the paged kernels' split walk (attend_split, paged_decode.cuh; the
//      split rule kernels.paged_decode_split; 8 warps an item, the walk's
//      scratch in the dynamic shared memory, the partials in the f32
//      scratch ``work``, merged in split order by the last split of a
//      (slot, KV head, row)); above 8 rows, 128-row passes of the
//      tensor-core tile
//      attend_tile_mma ("mma" for bf16, "tf32x3" for f32) right after the
//      unit's commit, the stage's dynamic shared memory then MmaSmem's
//      layout
//   4. out-projection                        attn -> partial sums
//   5. residual + the FFN's norm (rows)      x2 = x + o, h2 = norm(x2);
//      a parallel block norms x (its second norm) or reads h (none)
//   6. gate and up projections (up alone without GLU)  h2 -> partial sums
//   7. act(gate) * up, or act(up) (elementwise)        act
//   8. down projection                       act -> partial sums, whose
//      residual the next layer's step 1 adds
// The residual chain is round(round(x + o) + ffn) for both kinds of block.
// then the last residual and the final norm of the logits_idx rows, the
// f32 LM head (in column items no wider than the layers' widest tile) and
// a grid-wide first-maximum argmax. A grid-wide barrier
// (cooperative_groups grid sync) separates the stages.
//
// The speculation fold (a SpecInfer draft or verify step) is the same
// kernel: the mask and the lines' (page, offset) are inputs, so a tree
// mask and slack lines anywhere in a slot's pages need nothing of their
// own; the early-exit draft is a launch over the first layers' weights and
// pools (nothing here takes L for the model's depth); with ``all_logits``
// the tail runs over every row of the step (the final norm of R * C rows,
// the LM head writing (R * C, V), the argmax of each row).
//
// Rounding follows the plain PyTorch path (models/llama.py,
// models/transformer.py): each projection output element rounds once to
// the model dtype, and a bias added to it rounds again; RMS rounds (x * r)
// to the model dtype and then multiplies by gamma in the model dtype,
// Gemma's RMS multiplies (x * r) by (1 + gamma) in f32 and rounds once,
// LayerNorm rounds (x - mu) * r, its product with gamma and the sum with
// beta; the activation is computed in f32 from its rounded input and
// rounded once, and a GLU's product with up rounds again; the LM head
// multiplies model-dtype values with f32 accumulation (bf16 products are
// exact in f32, so this is the plain f32 head up to summation order) and
// adds its bias in f32.
//
// Projections, two designs, chosen by the step's shape alone (tc_path):
//  * bf16 steps of more than 64 rows (mixed and prefill steps): wgmma
//    m64n256k16, in work items of 128 rows (two warpgroups of 64) by 256
//    columns, K in 64-deep stages that TMA brings into a 4-buffer ring (the
//    activation rows K-major, the weight's 64 x 64 boxes MN-major, 128-
//    byte swizzle); run_gemm_stage_tc. Before it, items of 16-64 rows on
//    mma.sync read each layer's weights once per row tile, 64 times at C
//    = 128 with 16 slots, from L2 and through scalar shared-memory loads:
//    33 of the bf16 mixed step's 45.6 ms at 39-75 TFLOP/s (NVIDIA H100
//    80GB HBM3, 700 W). 128-row items read them 16 times, in 128-byte
//    boxes, with four stages in flight; an item whose rows are all
//    padding (their lines all on the scratch page) writes zeros instead:
//    a bias then makes those rows' values nonzero, still finite, and no
//    live row reads them (a padding row's line is on the scratch page,
//    which no live row's mask opens).
//  * otherwise (decode steps, f32): one work item is (a row tile of 16, 32
//    or 64 rows, one output-column tile of width N / tiles, one of KS
//    contraction slices). The block streams its weight columns and
//    activation rows through shared memory in 32-deep K chunks (cp.async,
//    double-buffered) and accumulates in registers: bf16 on the tensor
//    cores (mma.sync.m16n8k16, f32 accumulation), f32 on the CUDA cores.
// The KS slices of an output element are summed in slice order by the
// stage that reads them. KS depends on the row count alone, row tiles
// group rows only, and the wgmma items' 256-column chunks lie on the
// weight's own grid, so every output element's contraction runs in one
// order at every tile count: logits, tokens and pool bytes are bitwise
// equal across the legal tile counts (the JAX contract that tiles split
// only output columns). A role's column tile is N / tiles rounded up to
// whole 8-wide MMA columns (role_width: Falcon's 64-wide K/V at 16 or 32
// tiles), the LM head's last item may be ragged (GPT-2's V = 50257, its
// missing columns zeros in shared memory and never stored). Weights are
// read through their strides; a tied head reads embed (V, D) as the
// transposed head.
//
// Bound on an H100: a decode step reads every weight once (13.2 GB at
// LLaMA-7B in bf16) plus the K/V lines it attends, over 3.35 TB/s; a
// mixed step at C = 128 does 2 * rows * weights FLOP, over 989 TFLOP/s
// (bf16) or 67 TFLOP/s (f32 on the CUDA cores). Design against it: the
// weights are read once per row tile (once per step at decode), the
// K-split fills the SMs when a step has few rows, the hidden state lives
// in a global scratch that L2 holds at decode, and no pool slice is ever
// staged whole.
#include <algorithm>
#include <climits>
#include <cmath>

#include <cooperative_groups.h>

#include "hopper.cuh"
#include "paged_decode.cuh"

namespace fft {
namespace {

namespace coop = cooperative_groups;

constexpr int kThreads = 256;   // one block size for every stage
constexpr int kWarps = kThreads / 32;
constexpr int kBK = 32;         // K depth of a staged chunk
constexpr int kMaxFrags = 24;   // 16 x 8 accumulator fragments per warp
constexpr int kHeadCols = 256;  // LM-head columns per work item
static_assert(kThreads == kMmaTileThreads,
              "the attention stage runs the tensor-core tile's blocks of 256 threads");

// bf16 projections of steps of more than kTcMinRows rows, on wgmma: work
// items of 128 rows (two warpgroups of 64) by up to 256 columns (four
// 64-column products), 64-deep K stages in a ring of kTcStages buffers
// fed by TMA
constexpr int kTcMinRows = 64;
constexpr int kTcRows = 128;
constexpr int kTcBK = 64;
constexpr int kTcBlocks = 4;                                  // 64-column boxes of an item
constexpr int kTcCols = 64 * kTcBlocks;                       // columns of an item
constexpr int kTcStages = 4;
constexpr uint32_t kTcABytes = kTcRows * kTcBK * 2;           // the rows' 64-deep slice
constexpr uint32_t kTcBBox = kTcBK * 64 * 2;                  // 64 K rows x 64 columns
constexpr uint32_t kTcStage = kTcABytes + kTcBlocks * kTcBBox;
constexpr size_t kTcSmem = size_t(kTcStages) * kTcStage + 1024;  // + 1024-byte alignment

// the tensor maps of a launch: the four activations the projections read
// and the seven stacked weights
enum WholeMap : int {
  kMapH, kMapAttn, kMapH2, kMapAct, kMapWq, kMapWk, kMapWv, kMapWo, kMapWgate, kMapWup,
  kMapWdown, kNumMaps
};

// The body's norm kinds and activations (serve/kernels._WS_NORMS,
// _WS_ACTS), and its block kinds
enum NormKind : int { kNormRms, kNormRmsPlusOne, kNormLayer };
enum ActKind : int { kActSilu, kActGelu, kActGeluTanh, kActRelu };
enum BlockKind : int { kSequential, kParallelOneNorm, kParallelTwoNorms };

struct WholeArgs {
  // layer weights and biases, stacked on a leading layer dim (model
  // dtype); a bias, the gate (no GLU) and the second norm (a parallel
  // block with one norm) may be null
  const void *attn_norm, *attn_norm_b, *wq, *wk, *wv, *bq, *bk, *bv, *wo, *bo;
  const void *mlp_norm, *mlp_norm_b, *w_gate, *b_gate, *w_up, *b_up, *w_down, *b_down;
  const void *final_norm, *final_norm_b;
  const void* head;        // lm_head (D, V), or embed (V, D) when tied
  const void* head_b;      // (V,) or null
  const void* x0;          // (R, C, D) embedded step input
  const float* cos;        // (R, C, rot), or null: no RoPE
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
  float* logits;           // (R, V) out, (R * C, V) with all_logits
  int* tokens;             // (R,) out, (R * C,) with all_logits
  void* scratch;           // model-dtype scratch, see Scratch
  float* work;             // (KS, R * C, Nw) f32 partial sums
  long long* stamps;       // (1 + 8 L + 3,) %globaltimer ns, or null: see stamp()
  int* counters;           // (R * KV,) int32 zeros: the split walk's merge counters
  int L, R, C, D, H, KV, dk, F, V, ps, NP, P1, tiles, KS, tied;
  int split_pages;         // pages a split of the decode design (paged_decode_split)
  int all_logits;          // the head over every row (the fold), else a row a slot
  int norm_kind, act, glu, block, rot;  // NormKind, ActKind, a GLU FFN, BlockKind, RoPE dims
  float eps, scale, qmax;
  CUtensorMap maps[kNumMaps];  // WholeMap; encoded when tc_path()
};

// Model-dtype buffers carved out of WholeArgs::scratch, in this order
// (the wrapper allocates their sum).
template <typename T>
struct Scratch {
  T *x, *h, *x2, *h2, *qraw, *qrot, *attn, *knew, *vnew, *krot, *act, *hf;
  __host__ __device__ explicit Scratch(const WholeArgs& a) {
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
    hf = p;  // the final norm's rows: head_rows(a) x D
  }
};

// Per-stage timer: with a stamps buffer, thread 0 of block 0 reads the
// global timer (ns) at entry and after every grid barrier, the stage that
// ends there: per layer norm, qkv, attention, out_proj, norm2, w1w3, act,
// w2; then final_norm, head and the argmax (after block 0's rows). Without
// one it does nothing. Stage i of a step is stamps[i + 1] - stamps[i]
// (serve/kernels.whole_step_stage_ms).
__device__ __forceinline__ void stamp(const WholeArgs& a, int& i) {
  if (a.stamps != nullptr && blockIdx.x == 0 && threadIdx.x == 0) {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    a.stamps[i] = (long long)t;
  }
  ++i;
}

__host__ __device__ constexpr int dtype_of(size_t bytes) {
  return bytes == 2 ? kBFloat16 : kFloat32;
}

// Whether the layer projections of a launch run on wgmma: bf16, more than
// kTcMinRows rows, every contraction a whole number of 64-deep stages. A
// function of the shapes alone, never of the tile count.
__host__ __device__ inline bool tc_path(const WholeArgs& a, size_t elem_bytes) {
  return elem_bytes == 2 && a.R * a.C > kTcMinRows && a.D % kTcBK == 0 &&
         (a.H * a.dk) % kTcBK == 0 && a.F % kTcBK == 0;
}
__host__ __device__ constexpr int imax(int a, int b) { return a > b ? a : b; }
__host__ __device__ constexpr int imin(int a, int b) { return a < b ? a : b; }

// The output-column tile of a role of n columns: n / tiles rounded up to
// whole 8-wide MMA columns (serve/kernels._ws_tile_width)
__host__ __device__ inline int role_width(int n, int tiles) { return (n / tiles + 7) / 8 * 8; }

// The widest output-column tile of the layer projections; LM-head work
// items are no wider (at most kHeadCols).
__host__ __device__ inline int head_width_cap(const WholeArgs& a) {
  return imax(imax(role_width(a.H * a.dk, a.tiles), role_width(a.KV * a.dk, a.tiles)),
              imax(role_width(a.D, a.tiles), role_width(a.F, a.tiles)));
}

__host__ __device__ inline int head_width(const WholeArgs& a) {
  return imin(imin(kHeadCols, a.V), head_width_cap(a));
}

// The rows of the tail (final norm, LM head, argmax): one a slot at its
// logits_idx, or every row of the step with all_logits.
__host__ __device__ inline int head_rows(const WholeArgs& a) {
  return a.all_logits ? a.R * a.C : a.R;
}

// 16-row fragments of a row tile: one for a step of at most 16 rows,
// else the most (4, 2, 1) whose accumulators for a column tile of width w
// fit a warp's kMaxFrags. Row tiles group rows only: an output element's
// arithmetic is the same whatever the tile.
__host__ __device__ inline int row_frags(int rows, int w) {
  if (rows <= 16) return 1;
  const int per_warp = ((w + 7) / 8 + kWarps - 1) / kWarps;
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

// ---------------------------------------------------------------------------
// projections

__device__ __forceinline__ uint32_t pack2(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return uint32_t(__bfloat16_as_ushort(lo)) | (uint32_t(__bfloat16_as_ushort(hi)) << 16);
}

// One projection work item: out[m * ldo + j] = sum over K chunks
// [kc0, kc1) of A[m, k] * W(k, n0 + j) (+ bias[n0 + j] in f32, the LM
// head's), for rows [m0, m0 + 16 MF) below M and columns j < width.
struct GemmItem {
  const void* A;        // (M, K) row-major
  int M, K;
  const void* W;        // element (k, n) at W[k * sk + n * sn]; sk == 1 or sn == 1
  size_t sk, sn;
  int n0, width;        // width a multiple of 8 but in the LM head's last item
  int m0, kc0, kc1;
  float* out;
  int ldo;
  const void* bias;     // (N,) model dtype, or null
};

__host__ __device__ constexpr int round8(int n) { return (n + 7) / 8 * 8; }

// Shared-memory elements of one stage buffer pair (A chunk and W chunk).
template <typename T, int MF>
__host__ __device__ constexpr size_t gemm_buf_elems(int width) {
  return size_t(16 * MF) * (kBK + 16 / sizeof(T)) + size_t(kBK) * (round8(width) + 16 / sizeof(T));
}

template <typename T, int MF>
__device__ void gemm_item(const GemmItem& it, unsigned char* smem_raw) {
  constexpr int BM = 16 * MF, NJ = kMaxFrags / MF, V8 = 16 / sizeof(T);
  constexpr int LA = kBK + V8;
  // a ragged width (the LM head's last item) rounds up to whole 8-column
  // fragments, the columns past it zeros
  const int W = it.width, W8 = round8(W), LB = W8 + V8, NF = W8 / 8;
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
    if (it.sn == 1 && W == W8 && it.sk % V8 == 0 && it.n0 % V8 == 0) {
      for (int idx = tid; idx < kBK * (W / V8); idx += kThreads) {
        const int k = idx / (W / V8), v = (idx % (W / V8)) * V8;
        cp_async16(sB[buf] + k * LB + v, Wp + (size_t)(kb + k) * it.sk + it.n0 + v);
      }
    } else if (it.sn == 1) {  // rows not 16-byte aligned, or a ragged width
      for (int idx = tid; idx < kBK * W8; idx += kThreads) {
        const int k = idx / W8, n = idx % W8;
        sB[buf][k * LB + n] = n < W ? Wp[(size_t)(kb + k) * it.sk + it.n0 + n] : from_f32<T>(0.f);
      }
    } else {  // transposed: W(k, n) = head[n * sn + k], 16 bytes along k
      for (int idx = tid; idx < W * (kBK / V8); idx += kThreads) {
        const int n = idx / (kBK / V8), k = (idx % (kBK / V8)) * V8;
        const uint4 raw = *reinterpret_cast<const uint4*>(Wp + (size_t)(it.n0 + n) * it.sn + kb + k);
        const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
        for (int i = 0; i < V8; ++i) sB[buf][(k + i) * LB + n] = e[i];
      }
      for (int idx = tid; idx < kBK * (W8 - W); idx += kThreads)
        sB[buf][idx / (W8 - W) * LB + W + idx % (W8 - W)] = from_f32<T>(0.f);
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

  const T* bias = static_cast<const T*>(it.bias);
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int nf = warp + kWarps * j;
    if (nf >= NF) continue;
    const int col = nf * 8 + 2 * t;
    if (bias != nullptr) {
      const float b0 = col < W ? to_f32<T>(bias[it.n0 + col]) : 0.f;
      const float b1 = col + 1 < W ? to_f32<T>(bias[it.n0 + col + 1]) : 0.f;
#pragma unroll
      for (int mf = 0; mf < MF; ++mf) {
        acc[j][mf][0] = __fadd_rn(acc[j][mf][0], b0);
        acc[j][mf][1] = __fadd_rn(acc[j][mf][1], b1);
        acc[j][mf][2] = __fadd_rn(acc[j][mf][2], b0);
        acc[j][mf][3] = __fadd_rn(acc[j][mf][3], b1);
      }
    }
#pragma unroll
    for (int mf = 0; mf < MF; ++mf) {
      const int r0 = it.m0 + mf * 16 + g;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = r0 + 8 * h;
        if (row >= it.M) continue;
        if (col < W) it.out[(size_t)row * it.ldo + col] = acc[j][mf][2 * h];
        if (col + 1 < W) it.out[(size_t)row * it.ldo + col + 1] = acc[j][mf][2 * h + 1];
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
  const void* bias;  // the LM head's (V,), added in f32 (CUDA-core items only)
  // on wgmma: the maps of A and of the weights, the layer, and each row's
  // page (a row whose line goes to the scratch page is padding)
  const CUtensorMap* amap;
  const CUtensorMap* wmap[3];
  int layer;
  const int* phys;
  int scratch;
};

// The TMA ring of the wgmma projections: a buffer's full barrier completes
// when its bytes have landed, its empty barrier when every warp is done
// multiplying it; and the count of stages this block has loaded (and
// consumed) so far
struct TcRing {
  uint64_t* full;
  uint64_t* empty;
  uint32_t count;
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
    it.bias = s.bias;
    gemm_item<T, MF>(it, smem);
  }
}

// One projection stage on wgmma (bf16). A work item is (weight, column
// tile, 256-column chunk, 128-row tile, K slice). The chunks lie on the
// weight's own 256-column grid, whatever the tile count: a tile covers the
// chunks its columns touch, and an item writes only its tile's columns.
// So every output element is the same product at the same place of an
// m64n256k16 instruction, its contraction summed in one order (64-deep
// stages from kc0, four k16 steps each) at every tile count, and the
// outputs are bitwise equal across tile counts. Thread 0 keeps kTcStages
// stages of TMA loads in flight (the rows' 64-deep slice, K-major; the
// weight's four 64 x 64 boxes, MN-major; 128-byte swizzle, zeros past the
// tensors' ends); both warpgroups multiply, keeping one stage's products
// in flight while they wait for the next stage, and a lane of every warp
// frees a stage on its empty barrier once its products are done. One
// n256 instruction a k16 step reads A from shared memory once for all 256
// columns. Not inlined, like run_gemm_stage.
__device__ __noinline__ void run_gemm_stage_tc(const GemmStage& s, unsigned char* smem_raw,
                                               TcRing& ring) {
  using namespace hopper;
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int tid = threadIdx.x, wg = tid / 128, warp = tid % 128 / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int RT = (s.M + kTcRows - 1) / kTcRows, nch = s.K / kTcBK;
  int total = 0, items[3], tiles[3], chunks[3];
  for (int r = 0; r < s.n; ++r) {
    tiles[r] = (s.N[r] + s.width[r] - 1) / s.width[r];
    chunks[r] = 1;  // the most 256-column chunks a tile touches
    for (int tl = 0; tl < tiles[r]; ++tl) {
      const int t0 = tl * s.width[r], tw = min(s.width[r], s.N[r] - t0);
      chunks[r] = max(chunks[r], ((t0 & (kTcCols - 1)) + tw + kTcCols - 1) / kTcCols);
    }
    items[r] = tiles[r] * chunks[r] * RT * s.KS;
    total += items[r];
  }
  // the earlier stages' ordinary accesses of this shared memory come
  // before the TMA writes
  fence_proxy_async();
  __syncthreads();
  uint32_t count = ring.count;  // thread 0 writes it back at the end
  for (int u = blockIdx.x; u < total; u += gridDim.x) {
    int rest = u, r = 0, col = 0;
    while (rest >= items[r]) {
      rest -= items[r];
      col += s.N[r];
      ++r;
    }
    const int ks = rest % s.KS, rt = rest / s.KS % RT, rc = rest / s.KS / RT;
    const int t0 = rc / chunks[r] * s.width[r], tw = min(s.width[r], s.N[r] - t0);
    const int n0 = (t0 & ~(kTcCols - 1)) + rc % chunks[r] * kTcCols;  // the chunk's first column
    if (n0 >= t0 + tw) continue;  // block-uniform: this tile has fewer chunks
    const int m0 = rt * kTcRows;
    float* out = s.out + (size_t)ks * s.M * s.ldo + col;
    // an item whose rows are all padding (an idle slot's) writes zeros: its
    // rows' values are never read, and stay finite
    if (!__syncthreads_or(tid < kTcRows && m0 + tid < s.M && s.phys[m0 + tid] != s.scratch)) {
      const int c0 = max(n0, t0), c1 = min(n0 + kTcCols, t0 + tw);
      for (int i = tid; i < kTcRows * (c1 - c0); i += kThreads) {
        const int row = m0 + i / (c1 - c0);
        if (row < s.M) out[(size_t)row * s.ldo + c0 + i % (c1 - c0)] = 0.f;
      }
      continue;
    }
    const int kc0 = ks * nch / s.KS, nk = (ks + 1) * nch / s.KS - kc0;
    const bool rows_on = m0 + 64 * wg < s.M;  // warpgroup-uniform
    const CUtensorMap* wmap = s.wmap[r];

    auto issue = [&](int j) {  // thread 0: stage j of the item, once its buffer is free
      const uint32_t q = count + j;
      const int st = q % kTcStages;
      unsigned char* sa = smem + st * kTcStage;
      mbar_wait(&ring.empty[st], ((q / kTcStages) & 1) ^ 1);  // a fresh barrier passes
      mbar_expect_tx(&ring.full[st], kTcStage);
      tma_load_2d(sa, s.amap, &ring.full[st], (kc0 + j) * kTcBK, m0);
      for (int b = 0; b < kTcBlocks; ++b)
        tma_load_3d(sa + kTcABytes + b * kTcBBox, wmap, &ring.full[st], n0 + 64 * b,
                    (kc0 + j) * kTcBK, s.layer);
    };
    if (tid == 0)
      for (int j = 0; j < min(kTcStages, nk); ++j) issue(j);

    float acc[kTcBlocks * 8][4];  // the accumulator of m64n256: columns 8 n8 + 2 t + (e & 1)
#pragma unroll
    for (int n8 = 0; n8 < kTcBlocks * 8; ++n8)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n8][e] = 0.f;
    for (int j = 0; j < nk; ++j) {
      const uint32_t q = count + j;
      const int st = q % kTcStages;
      mbar_wait(&ring.full[st], (q / kTcStages) & 1);
      if (rows_on) {
        const unsigned char* sa = smem + st * kTcStage;
        fence_regs(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kTcBK / 16; ++kk)
          wgmma_ss_t_n256(acc, desc_sw128(sa + wg * 64 * 128 + kk * 32, 16, 1024),
                          desc_sw128(sa + kTcABytes + kk * 16 * 128, kTcBBox, 1024));
        wgmma_commit();
        wgmma_wait<1>();  // the last stage's products are done
        fence_regs(acc);
      }
      if (j > 0) {  // free the last stage, refill it
        const int prev = (q - 1) % kTcStages;
        if (lane == 0) mbar_arrive(&ring.empty[prev]);
        if (tid == 0 && j - 1 + kTcStages < nk) issue(j - 1 + kTcStages);
      }
    }
    if (rows_on) {
      wgmma_wait<0>();
      fence_regs(acc);
    }
    if (lane == 0) mbar_arrive(&ring.empty[(count + nk - 1) % kTcStages]);
    count += nk;

    // the tile's columns of the item, rows below M
    if (!rows_on) continue;
#pragma unroll
    for (int n8 = 0; n8 < kTcBlocks * 8; ++n8) {
      const int c = n0 + 8 * n8 + 2 * t;
      if (c < t0 || c >= t0 + tw) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + 64 * wg + 16 * warp + g + 8 * h;
        if (row < s.M)
          *reinterpret_cast<float2*>(out + (size_t)row * s.ldo + c) =
              make_float2(acc[n8][2 * h], acc[n8][2 * h + 1]);
      }
    }
  }
  __syncthreads();  // every thread has read the count
  if (tid == 0) ring.count = count;
}

template <typename T>
__device__ void gemm_stage(const GemmStage& s, int mf, unsigned char* smem, TcRing* ring) {
  if constexpr (sizeof(T) == 2) {
    if (ring != nullptr) {
      run_gemm_stage_tc(s, smem, *ring);
      return;
    }
  }
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

// 8 consecutive elements at p (16-byte aligned) that other blocks wrote
// earlier in this launch, as f32: through L2 (ld.global.cg), since the
// SM's L1 is not kept coherent with other SMs' stores
__device__ __forceinline__ void load8_l2(const __nv_bfloat16* p, float (&o)[8]) {
  const uint4 raw = __ldcg(reinterpret_cast<const uint4*>(p));
  const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
  for (int i = 0; i < 8; ++i) o[i] = __bfloat162float(e[i]);
}
__device__ __forceinline__ void load8_l2(const float* p, float (&o)[8]) {
  const float4 a = __ldcg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldcg(reinterpret_cast<const float4*>(p + 4));
  o[0] = a.x, o[1] = a.y, o[2] = a.z, o[3] = a.w, o[4] = b.x, o[5] = b.y, o[6] = b.z, o[7] = b.w;
}

// x_out = x_in (+ the residual when part is given: the KS partial sums of
// the previous projection, rounded, plus its bias, rounded again), then
// h = norm(x_out), or norm(x_in) with of_input (a parallel block's second
// norm reads the block's input), for one row, by one warp (8 elements a
// lane at a time; D a multiple of 8); no norm when h is null (a parallel
// block whose FFN reads the input norm). The norm as the plain path's
// _norm rounds it: RMS (x r) rounded, times gamma; RMS by 1 + gamma, (x r)
// (1 + gamma) in f32; LayerNorm (x - mu) r rounded, times gamma, rounded,
// plus beta (when given). x_in and x_out are distinct buffers; every read
// goes through L2: other blocks wrote x_in, this lane x_out.
template <typename T>
__device__ void residual_norm_row(const T* x_in, const float* part, const T* bias, size_t slice,
                                  int KS, T* x_out, T* h, const T* gamma, const T* beta, int D,
                                  float eps, int kind, bool of_input) {
  const int lane = threadIdx.x % 32;
  const bool layer = kind == kNormLayer;
  float sum = 0.f;  // of x (LayerNorm) or of x^2 (RMS)
  for (int d = 8 * lane; d < D; d += 256) {
    float x[8];
    load8_l2(x_in + d, x);
    if (of_input) {
#pragma unroll
      for (int i = 0; i < 8; ++i) sum = layer ? __fadd_rn(sum, x[i]) : fmaf(x[i], x[i], sum);
    }
    if (part != nullptr) {
      float p[8], q[8];
      load8_l2(part + d, p);
      for (int k = 1; k < KS; ++k) {  // the KS slices in slice order, as partial_sum
        load8_l2(part + k * slice + d, q);
#pragma unroll
        for (int i = 0; i < 8; ++i) p[i] = __fadd_rn(p[i], q[i]);
      }
      if (bias != nullptr) {
        load_f32<T, 8>(bias + d, q);
#pragma unroll
        for (int i = 0; i < 8; ++i) p[i] = __fadd_rn(round_to<T>(p[i]), q[i]);
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) x[i] = round_to<T>(__fadd_rn(x[i], round_to<T>(p[i])));
    }
    store8<T>(x_out + d, x);
    if (!of_input) {
#pragma unroll
      for (int i = 0; i < 8; ++i) sum = layer ? __fadd_rn(sum, x[i]) : fmaf(x[i], x[i], sum);
    }
  }
  if (h == nullptr) return;
  const T* src = of_input ? x_in : x_out;
  float mu = 0.f, ss = warp_sum(sum);
  if (layer) {  // the variance about the mean, a second pass
    mu = __fdiv_rn(ss, (float)D);
    float var = 0.f;
    for (int d = 8 * lane; d < D; d += 256) {
      float x[8];
      load8_l2(src + d, x);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float c = __fsub_rn(x[i], mu);
        var = fmaf(c, c, var);
      }
    }
    ss = warp_sum(var);
  }
  const float r = 1.f / sqrtf(__fdiv_rn(ss, (float)D) + eps);
  for (int d = 8 * lane; d < D; d += 256) {
    float x[8], g[8];
    load8_l2(src + d, x);
    load_f32<T, 8>(gamma + d, g);
    if (kind == kNormRmsPlusOne) {
#pragma unroll
      for (int i = 0; i < 8; ++i) x[i] = __fmul_rn(__fmul_rn(x[i], r), __fadd_rn(1.f, g[i]));
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float c = layer ? __fsub_rn(x[i], mu) : x[i];
        x[i] = __fmul_rn(round_to<T>(__fmul_rn(c, r)), g[i]);
      }
      if (beta != nullptr) {
        load_f32<T, 8>(beta + d, g);
#pragma unroll
        for (int i = 0; i < 8; ++i) x[i] = __fadd_rn(round_to<T>(x[i]), g[i]);
      }
    }
    store8<T>(h + d, x);
  }
}

// ---------------------------------------------------------------------------
// attention

// The block's state between the kernel's calls of its stages: the
// arguments, the loop counters of the kernel and of its attention stage,
// that stage's commit and paged arguments and the TMA ring. It lives in
// shared memory, where the non-inlined stage functions find it at a fixed
// address: no value or pointer stays in a register across their calls.
// (The calling convention saves every register a caller holds across a
// call, ptxas counts those saves as spills, and a callee may use all 255.)
// Thread 0 writes it, and a barrier follows before the block reads it.
struct BlockState {
  const WholeArgs* args;
  int l;      // layer
  int si;     // next stamp
  int u;      // (slot, KV head) unit of the attention stage
  int units;  // R * KV
  int rows;   // query rows of a KV head, C * G
  int row0;   // first row of an attention pass
  int item;   // split walk item (live slot, KV head, row, split) of the decode design
  int items;  // live slots * KV * rows * splits
  bool tile;  // the attention takes the tensor-core tile (not the split walk)
  bool idle;  // the unit is an idle slot's (every line on the scratch page)
  bool tc;    // the layer projections run on wgmma (tc_path)
  TcRing ring;
  CommitArgs commit;
  SplitArgs split;  // the split walk's: partials in ``work``, the launch's counters
};
__shared__ BlockState g_block;
__shared__ __align__(8) uint64_t g_tc_full[kTcStages], g_tc_empty[kTcStages];

// The grid barrier that ends a stage, and its stamp. The stages end with
// it themselves: the kernel holds nothing between their calls.
__device__ __forceinline__ void end_stage() {
  coop::this_grid().sync();
  if (threadIdx.x == 0) stamp(*g_block.args, g_block.si);
}

// The whole step's split walk takes one query row an item, its lanes at
// most 8 head dims of a line (16-byte loads on bf16 and f32 pages, 8 on
// int8, 4 on int4): a walk that holds more registers made ptxas spill in
// the kernel's other stages, whose non-inlined functions share its
// register allocation (ptxas -v for sm_90a, every instantiation: 4- and
// 8-row walks 3,292 to 10,766 bytes across the library, one row at 32
// and 16 dims a lane 52 and 32 bytes, at 8 none). A row a time reads a
// KV head's lines once per row, as the design before this one did.
constexpr int kWsSplitDims = 8;

// The split walk's dynamic shared memory in the attention stage of a
// decode-design step: the walk's scratch (SplitSmem) for one row and the
// block's 8 warps, the item's query row, then the step's live slots (R
// ints). serve/kernels.whole_step_split_smem_bytes mirrors it.
template <typename T, int DK>
struct SplitLayout {
  static constexpr size_t kQ = (sizeof(SplitSmem<DK, 1, kWarps, true>) + 15) / 16 * 16;
  static constexpr size_t kSlots = kQ + size_t(DK) * sizeof(T);  // live slots
  static size_t bytes(int R) { return kSlots + 4 * size_t(R); }
};

// The live slots (a line off the scratch page) in slot order, after the
// split walk's scratch, and the stage's item count: warp 0 ballots 32
// slots at a time. Ends with a barrier.
template <typename T, int DK>
__device__ __noinline__ void list_live_slots() {
  extern __shared__ __align__(16) unsigned char smem[];
  BlockState& b = g_block;
  const WholeArgs& a = *b.args;
  int* live = reinterpret_cast<int*>(smem + SplitLayout<T, DK>::kSlots);
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    int n = 0;
    for (int r0 = 0; r0 < a.R; r0 += 32) {
      const int r = r0 + lane;
      bool on = false;
      for (int c = 0; r < a.R && c < a.C; ++c) on = on || a.phys[(size_t)r * a.C + c] != a.P1 - 1;
      const unsigned ballot = __ballot_sync(0xffffffffu, on);
      if (on) live[n + __popc(ballot & ((1u << lane) - 1u))] = r;
      n += __popc(ballot);
    }
    if (lane == 0) b.items = n * a.KV * b.rows * b.split.nsplit;
  }
  __syncthreads();
}

// The block's split walk item b.item: (live slot, KV head, query row,
// split), on the block's 8 warps, its query row (rotated, a.q) staged
// through L2: other blocks wrote it in the commit. Not inlined, like
// attend_rows_mma.
template <typename T, int KIND, int DK>
__device__ __noinline__ void attend_row_split() {
  extern __shared__ __align__(16) unsigned char smem[];
  using Layout = SplitLayout<T, DK>;
  constexpr int V = DK * int(sizeof(T)) / 16;  // 16-byte vectors a row
  const BlockState& b = g_block;
  const PagedArgs& a = b.commit.a;
  const int* live = reinterpret_cast<const int*>(smem + Layout::kSlots);
  const int nsplit = b.split.nsplit, G = a.H / a.KV;
  const int r = live[b.item / (a.KV * b.rows * nsplit)], h = b.item / (b.rows * nsplit) % a.KV;
  const int i = b.item / nsplit % b.rows;
  T* sQ = reinterpret_cast<T*>(smem + Layout::kQ);
  const size_t row = ((size_t)r * a.C + i / G) * a.H + (size_t)h * G + i % G;
  if (threadIdx.x < V)
    reinterpret_cast<uint4*>(sQ)[threadIdx.x] =
        __ldcg(reinterpret_cast<const uint4*>(static_cast<const T*>(a.q) + row * DK) +
               threadIdx.x);
  attend_split<T, KIND, DK, 1, kWarps, kWsSplitDims>(
      PagedLines<true>{a, r, h, i, 1}, b.split, b.item % nsplit, sQ,
      *reinterpret_cast<SplitSmem<DK, 1, kWarps, true>*>(smem));
}

// One 128-row pass of the paged kernels' tensor-core tile ("mma" for bf16
// q, "tf32x3" for f32 q) at the block's unit, rows from its row0. Not
// inlined: the tile holds up to 253 registers a thread, and a call keeps
// its allocation out of the rest of the stage.
template <typename TQ, int KIND, int DK>
__device__ __noinline__ void attend_rows_mma() {
  extern __shared__ __align__(16) unsigned char smem[];
  const BlockState& b = g_block;
  attend_tile_mma<TQ, KIND, DK>(b.commit.a, b.u / b.commit.a.KV, b.u % b.commit.a.KV, b.row0,
                                smem);
}

// ---------------------------------------------------------------------------
// the stages

// Each stage is a function the kernel calls, ending with a grid barrier.
// Not inlined: a stage keeps its own register allocation (with the stages
// inlined in the kernel, its allocation spilled), and the block's state
// stays in g_block.

// Layer l's row of a stacked (L, n) tensor, or null
template <typename T>
__device__ __forceinline__ const T* layer_row(const void* p, int l, int n) {
  return p == nullptr ? nullptr : static_cast<const T*>(p) + (size_t)l * n;
}

// 1. the residual of the previous layer's down projection (or x0) and the
// input norm, or 5. the attention residual and the FFN's norm (``mlp``):
// of x + o (sequential), of x (a parallel block's second norm) or none (a
// parallel block with one norm: the FFN reads h)
template <typename T>
__device__ __noinline__ void norm_stage(bool mlp) {
  const WholeArgs& a = *g_block.args;
  const Scratch<T> s(a);
  const int l = g_block.l;
  const int M = a.R * a.C, D = a.D;
  const T* gamma = layer_row<T>(mlp ? a.mlp_norm : a.attn_norm, l, D);
  const T* beta = layer_row<T>(mlp ? a.mlp_norm_b : a.attn_norm_b, l, D);
  for (int m = blockIdx.x * kWarps + threadIdx.x / 32; m < M; m += gridDim.x * kWarps) {
    const size_t o = (size_t)m * D;
    if (mlp) {
      residual_norm_row<T>(s.x + o, a.work + o, layer_row<T>(a.bo, l, D), (size_t)M * D, a.KS,
                           s.x2 + o, a.block == kParallelOneNorm ? nullptr : s.h2 + o, gamma,
                           beta, D, a.eps, a.norm_kind, a.block == kParallelTwoNorms);
    } else if (l == 0) {
      residual_norm_row<T>(static_cast<const T*>(a.x0) + o, nullptr, nullptr, 0, 0, s.x + o,
                           s.h + o, gamma, beta, D, a.eps, a.norm_kind, false);
    } else {
      residual_norm_row<T>(s.x2 + o, a.work + o, layer_row<T>(a.b_down, l - 1, D), (size_t)M * D,
                           a.KS, s.x + o, s.h + o, gamma, beta, D, a.eps, a.norm_kind, false);
    }
  }
  end_stage();
}

enum Proj : int { kProjQkv, kProjOut, kProjW1W3, kProjW2 };

// 2. Q, K, V; 4. the out-projection; 6. gate (a GLU's) and up, from h2
// (or h: a parallel block with one norm); 8. the down-projection (its
// residual is added by the next stage 1). Biases are added by the stages
// that read the sums.
template <typename T>
__device__ __noinline__ void proj_stage(int which) {
  extern __shared__ __align__(16) unsigned char smem[];
  const WholeArgs& a = *g_block.args;
  const Scratch<T> s(a);
  const int l = g_block.l;
  const int M = a.R * a.C, D = a.D, Q = a.H * a.dk, KVd = a.KV * a.dk, F = a.F;
  GemmStage st{};
  st.M = M;
  st.KS = a.KS;
  st.out = a.work;
  st.layer = l;
  st.phys = a.phys;
  st.scratch = a.P1 - 1;
  const void* w[3] = {};
  int n[3] = {}, K = 0;
  if (which == kProjQkv) {
    st.A = s.h;
    st.amap = &a.maps[kMapH];
    st.n = 3;
    K = D;
    w[0] = a.wq, w[1] = a.wk, w[2] = a.wv;
    n[0] = Q, n[1] = KVd, n[2] = KVd;
    st.wmap[0] = &a.maps[kMapWq], st.wmap[1] = &a.maps[kMapWk], st.wmap[2] = &a.maps[kMapWv];
  } else if (which == kProjOut) {
    st.A = s.attn;
    st.amap = &a.maps[kMapAttn];
    st.n = 1;
    K = Q;
    w[0] = a.wo;
    n[0] = D;
    st.wmap[0] = &a.maps[kMapWo];
  } else if (which == kProjW1W3) {
    const bool from_h = a.block == kParallelOneNorm;
    st.A = from_h ? s.h : s.h2;
    st.amap = &a.maps[from_h ? kMapH : kMapH2];
    K = D;
    if (a.glu) {
      w[st.n] = a.w_gate, n[st.n] = F, st.wmap[st.n] = &a.maps[kMapWgate];
      ++st.n;
    }
    w[st.n] = a.w_up, n[st.n] = F, st.wmap[st.n] = &a.maps[kMapWup];
    ++st.n;
  } else {
    st.A = s.act;
    st.amap = &a.maps[kMapAct];
    st.n = 1;
    K = F;
    w[0] = a.w_down;
    n[0] = D;
    st.wmap[0] = &a.maps[kMapWdown];
  }
  st.K = K;
  st.ldo = 0;
  for (int r = 0; r < st.n; ++r) {
    st.W[r] = static_cast<const T*>(w[r]) + (size_t)l * K * n[r];
    st.N[r] = n[r];
    st.width[r] = role_width(n[r], a.tiles);
    st.sk[r] = n[r];
    st.sn[r] = 1;
    st.ldo += n[r];
  }
  gemm_stage<T>(st, row_frags(M, head_width_cap(a)), smem, g_block.tc ? &g_block.ring : nullptr);
  end_stage();
}

// 3. per (slot, KV head): the Q/K/V lines from the partial sums, RoPE and
// the commit (commit_unit), then attention in the paged kernels' designs
// (paged_design): at decode, after every unit's commit and a grid
// barrier, the split walk's items; above 8 rows, 128-row passes of the
// tensor-core tile after the unit's commit
template <typename T, int KIND, int DK>
__device__ __noinline__ void commit_unit() {
  BlockState& b = g_block;
  const WholeArgs& a = *b.args;
  const CommitArgs& f = b.commit;
  const Scratch<T> s(a);
  const int M = a.R * a.C, Q = a.H * DK, KVd = a.KV * DK, G = a.H / a.KV;
  const size_t sl = (size_t)M * (Q + 2 * KVd);
  const int ld = Q + 2 * KVd;
  const int r = b.u / a.KV, kh = b.u % a.KV;
  // a unit whose lines all go to the scratch page is an idle slot's: its
  // attention outputs are never read, so they are zeros, and its lines
  // are not committed
  bool live = false;
  for (int c = threadIdx.x; c < a.C; c += kThreads)
    live = live || a.phys[(size_t)r * a.C + c] != a.P1 - 1;
  live = __syncthreads_or(live);
  if (threadIdx.x == 0) b.idle = !live;
  if (!live) {
    const float zero[8] = {};
    for (int idx = threadIdx.x; idx < a.C * G * (DK / 8); idx += kThreads) {
      const int d = idx % (DK / 8) * 8, j = idx / (DK / 8);
      store8<T>(s.attn + ((size_t)r * a.C + j / G) * Q + (kh * G + j % G) * DK + d, zero);
    }
    __syncthreads();
    return;
  }
  // 8 dims a thread at a time: line e of column c is query head kh G + e
  // (e < G), or the new K (e == G) or V line; a bias is added to the
  // rounded sum and rounded again
  const T* bq = layer_row<T>(a.bq, b.l, Q);
  const T* bk = layer_row<T>(a.bk, b.l, KVd);
  const T* bv = layer_row<T>(a.bv, b.l, KVd);
  for (int idx = threadIdx.x; idx < a.C * (G + 2) * (DK / 8); idx += kThreads) {
    const int d = idx % (DK / 8) * 8, j = idx / (DK / 8), cc = j / (G + 2), e = j - cc * (G + 2);
    const size_t m = (size_t)r * a.C + cc;
    const int col = e < G ? (kh * G + e) * DK + d : (e == G ? Q : Q + KVd) + kh * DK + d;
    float x[8], y[8];
    load8_l2(a.work + m * ld + col, x);
    for (int k = 1; k < a.KS; ++k) {  // the KS slices in slice order, as partial_sum
      load8_l2(a.work + k * sl + m * ld + col, y);
#pragma unroll
      for (int i = 0; i < 8; ++i) x[i] = __fadd_rn(x[i], y[i]);
    }
    T* dst = e < G ? s.qraw + m * Q + (kh * G + e) * DK + d
                   : (e == G ? s.knew : s.vnew) + m * KVd + kh * DK + d;
    const T* bias = e < G ? bq : e == G ? bk : bv;
    if (bias != nullptr) {
      load_f32<T, 8>(bias + (e < G ? (kh * G + e) * DK : kh * DK) + d, y);
#pragma unroll
      for (int i = 0; i < 8; ++i) x[i] = __fadd_rn(round_to<T>(x[i]), y[i]);
    }
    store8<T>(dst, x);
  }
  __syncthreads();
  rope_and_commit<T, KIND, DK, kThreads>(f, r, kh);
}

template <typename T, int KIND, int DK>
__device__ __noinline__ void attention_stage() {
  using P = typename PoolT<T, KIND>::T;
  BlockState& b = g_block;
  if (threadIdx.x == 0) {
    const WholeArgs& a = *b.args;
    const Scratch<T> s(a);
    const size_t pool_layer = (size_t)a.P1 * a.ps * a.KV * (DK / pack_of<KIND>());
    const size_t scale_layer = (size_t)a.P1 * a.KV;
    P* k_pool = static_cast<P*>(a.k_pool) + b.l * pool_layer;
    P* v_pool = static_cast<P*>(a.v_pool) + b.l * pool_layer;
    float* k_scale = KIND == kPoolFloat ? nullptr : a.k_scale + b.l * scale_layer;
    float* v_scale = KIND == kPoolFloat ? nullptr : a.v_scale + b.l * scale_layer;
    CommitArgs& f = b.commit;
    f.a = PagedArgs{s.qrot, k_pool,  v_pool, k_scale, v_scale, a.table, a.mask,
                    s.attn, a.R,     a.C,    a.H,     a.KV,    a.ps,    a.NP, a.scale};
    f.q_raw = s.qraw;
    f.k_new = s.knew;
    f.v_new = s.vnew;
    f.cos = a.cos;
    f.sin = a.sin;
    f.k_pool = k_pool;
    f.v_pool = v_pool;
    f.k_scale = k_scale;
    f.v_scale = v_scale;
    f.q_rot = s.qrot;
    f.k_rot = s.krot;
    f.logical = nullptr;
    f.phys = a.phys;
    f.off = a.off;
    f.rot = a.rot;
    f.qmax = a.qmax;
    b.units = a.R * a.KV;
    b.rows = a.C * (a.H / a.KV);
    b.tile = paged_design(b.rows, dtype_of(sizeof(T))) != kDesignDecode;
    b.u = blockIdx.x;
    b.split = SplitArgs{a.work, a.counters, a.split_pages,
                        (a.NP + a.split_pages - 1) / a.split_pages};
  }
  __syncthreads();
  while (b.u < b.units) {
    commit_unit<T, KIND, DK>();
    if (b.tile && !b.idle) {
      if (threadIdx.x == 0) b.row0 = 0;
      __syncthreads();
      while (b.row0 < b.rows) {
        attend_rows_mma<T, KIND, DK>();  // ends with a barrier
        if (threadIdx.x == 0) b.row0 += kMmaTileRows;
        __syncthreads();
      }
    }
    __syncthreads();  // every thread has read b.u
    if (threadIdx.x == 0) b.u += gridDim.x;
    __syncthreads();
  }
  if (b.tile) {
    end_stage();
  } else {  // grid-uniform: split_stage attends once every unit is committed
    coop::this_grid().sync();
  }
}

// 3, at decode (the decode design): the split walk's items, after every
// unit's commit. Its time is the attention stage's.
template <typename T, int KIND, int DK>
__device__ __noinline__ void split_stage() {
  BlockState& b = g_block;
  list_live_slots<T, DK>();
  if (threadIdx.x == 0) b.item = blockIdx.x;
  __syncthreads();
  while (b.item < b.items) {
    attend_row_split<T, KIND, DK>();
    __syncthreads();  // the walk's scratch and b.item are read
    if (threadIdx.x == 0) b.item += gridDim.x;
    __syncthreads();
  }
  end_stage();
}

// The activation of x in f32, as PyTorch's CPU kernels order it (F.silu,
// F.gelu exact and tanh, torch.relu); __fmul_rn and __fadd_rn keep nvcc
// from contracting products into FMAs
__device__ __forceinline__ float activate(float x, int act) {
  if (act == kActGelu)
    return __fmul_rn(__fmul_rn(x, 0.5f),
                     __fadd_rn(1.f, erff(__fmul_rn(x, 0.70710678118654752440f))));
  if (act == kActGeluTanh) {
    const float cube = __fmul_rn(__fmul_rn(x, x), x);
    const float inner =
        __fmul_rn(0.79788456080286535588f, __fadd_rn(x, __fmul_rn(0.044715f, cube)));
    return __fmul_rn(__fmul_rn(0.5f, x), __fadd_rn(1.f, tanhf(inner)));
  }
  if (act == kActRelu) return fmaxf(x, 0.f);
  return __fdiv_rn(x, __fadd_rn(1.f, expf(-x)));
}

// 7. act = act(gate) * up (GLU) or act(up): each projection rounded to the
// model dtype (plus its bias, rounded again), the activation of the
// rounded value rounded once, the GLU product rounded again
template <typename T>
__device__ __noinline__ void act_stage() {
  const WholeArgs& a = *g_block.args;
  const Scratch<T> s(a);
  const int l = g_block.l;
  const int M = a.R * a.C, F8 = a.F / 8, nw = a.glu ? 2 : 1;
  const size_t sl = (size_t)M * nw * a.F;
  const T* b_gate = layer_row<T>(a.b_gate, l, a.F);
  const T* b_up = layer_row<T>(a.b_up, l, a.F);
  // 8 columns a thread at a time (F a multiple of 8); the gate's columns
  // come first in a GLU's row of partial sums
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < M * F8; i += gridDim.x * kThreads) {
    const int m = i / F8, j = i % F8 * 8;
    const float* part = a.work + (size_t)m * nw * a.F + j;
    float up[8], x[8];
    load8_l2(part + (nw - 1) * a.F, up);
    for (int k = 1; k < a.KS; ++k) {  // the KS slices in slice order, as partial_sum
      load8_l2(part + k * sl + (nw - 1) * a.F, x);
#pragma unroll
      for (int e = 0; e < 8; ++e) up[e] = __fadd_rn(up[e], x[e]);
    }
#pragma unroll
    for (int e = 0; e < 8; ++e) up[e] = round_to<T>(up[e]);
    if (b_up != nullptr) {
      load_f32<T, 8>(b_up + j, x);
#pragma unroll
      for (int e = 0; e < 8; ++e) up[e] = round_to<T>(__fadd_rn(up[e], x[e]));
    }
    if (a.glu) {
      float gt[8];
      load8_l2(part, gt);
      for (int k = 1; k < a.KS; ++k) {
        load8_l2(part + k * sl, x);
#pragma unroll
        for (int e = 0; e < 8; ++e) gt[e] = __fadd_rn(gt[e], x[e]);
      }
#pragma unroll
      for (int e = 0; e < 8; ++e) gt[e] = round_to<T>(gt[e]);
      if (b_gate != nullptr) {
        load_f32<T, 8>(b_gate + j, x);
#pragma unroll
        for (int e = 0; e < 8; ++e) gt[e] = round_to<T>(__fadd_rn(gt[e], x[e]));
      }
#pragma unroll
      for (int e = 0; e < 8; ++e) x[e] = __fmul_rn(round_to<T>(activate(gt[e], a.act)), up[e]);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) x[e] = activate(up[e], a.act);
    }
    store8<T>(s.act + (size_t)m * a.F + j, x);
  }
  end_stage();
}

// the last residual and the final norm, at each slot's logits_idx row, or
// at every row with all_logits
template <typename T>
__device__ __noinline__ void final_norm_stage() {
  const WholeArgs& a = *g_block.args;
  const Scratch<T> s(a);
  const int M = a.R * a.C, D = a.D, rows = head_rows(a);
  for (int r = blockIdx.x * kWarps + threadIdx.x / 32; r < rows; r += gridDim.x * kWarps) {
    const size_t m = a.all_logits ? (size_t)r : (size_t)r * a.C + a.logits_idx[r];
    residual_norm_row<T>(s.x2 + m * D, a.work + m * D, layer_row<T>(a.b_down, a.L - 1, D),
                         (size_t)M * D, a.KS, s.x + m * D, s.hf + (size_t)r * D,
                         static_cast<const T*>(a.final_norm),
                         static_cast<const T*>(a.final_norm_b), D, a.eps, a.norm_kind, false);
  }
  end_stage();
}

// the LM head: f32 logits (head_rows, V), plus its bias
template <typename T>
__device__ __noinline__ void head_stage() {
  extern __shared__ __align__(16) unsigned char smem[];
  const WholeArgs& a = *g_block.args;
  GemmStage st{};
  st.A = Scratch<T>(a).hf;
  st.M = head_rows(a);
  st.K = a.D;
  st.KS = 1;
  st.n = 1;
  st.W[0] = a.head;
  st.N[0] = a.V;
  st.width[0] = head_width(a);
  st.sk[0] = a.tied ? 1 : a.V;
  st.sn[0] = a.tied ? a.D : 1;
  st.out = a.logits;
  st.ldo = a.V;
  st.bias = a.head_b;
  gemm_stage<T>(st, row_frags(st.M, head_width(a)), smem, nullptr);
  end_stage();
}

// the greedy head: the first maximal index of each row of the logits
__device__ __noinline__ void argmax_stage() {
  const WholeArgs& a = *g_block.args;
  __shared__ float best_v[kWarps];
  __shared__ int best_i[kWarps];
  for (int r = blockIdx.x; r < head_rows(a); r += gridDim.x) {
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
  if (threadIdx.x == 0) stamp(a, g_block.si);
}

// ---------------------------------------------------------------------------
// the kernel

template <typename TQ, int KIND, int DK>
__global__ void __launch_bounds__(kThreads, 1)
whole_step_kernel(const __grid_constant__ WholeArgs a) {
  using T = TQ;
  BlockState& b = g_block;
  if (threadIdx.x == 0) {
    b.args = &a;
    b.si = 0;
    stamp(a, b.si);
    b.l = 0;
    b.tc = tc_path(a, sizeof(T));
    b.ring = TcRing{g_tc_full, g_tc_empty, 0};
    if (b.tc) {
      for (int i = 0; i < kTcStages; ++i) {
        hopper::mbar_init(&g_tc_full[i], 1);
        hopper::mbar_init(&g_tc_empty[i], kWarps);  // a lane of every warp
      }
      hopper::fence_mbar_init();
    }
  }
  __syncthreads();
  while (b.l < a.L) {
    norm_stage<T>(false);
    proj_stage<T>(kProjQkv);
    attention_stage<T, KIND, DK>();
    if (!b.tile) split_stage<T, KIND, DK>();
    proj_stage<T>(kProjOut);
    norm_stage<T>(true);
    proj_stage<T>(kProjW1W3);
    act_stage<T>();
    proj_stage<T>(kProjW2);
    if (threadIdx.x == 0) ++b.l;  // every thread read b.l before the last grid barrier
    __syncthreads();
  }
  final_norm_stage<T>();
  head_stage<T>();
  argmax_stage();
}

template <typename TQ>
size_t gemm_smem(int rows, int w) {
  const int mf = row_frags(rows, w);
  const size_t elems = mf == 4 ? gemm_buf_elems<TQ, 4>(w)
                       : mf == 2 ? gemm_buf_elems<TQ, 2>(w) : gemm_buf_elems<TQ, 1>(w);
  return 2 * elems * sizeof(TQ);
}

// Dynamic shared memory of a launch: the projections' double-buffered
// chunks at the widest column tile (or an LM-head item of head_rows), or the attention
// stage's: the tensor-core tile when a KV head has more than 8 query
// rows, else the split walk's (SplitLayout).
template <typename TQ, int KIND, int DK>
size_t dynamic_smem(const WholeArgs& a) {
  const size_t gemm = std::max(gemm_smem<TQ>(a.R * a.C, head_width_cap(a)),
                               gemm_smem<TQ>(head_rows(a), head_width(a)));
  const bool tile = paged_design(a.C * (a.H / a.KV), dtype_of(sizeof(TQ))) != kDesignDecode;
  return std::max(std::max(gemm, tc_path(a, sizeof(TQ)) ? kTcSmem : size_t(0)),
                  tile ? MmaSmem<TQ, KIND, DK>::kBytes : SplitLayout<TQ, DK>::bytes(a.R));
}

// The tensor maps of the wgmma projections: the activations (M, K) in
// boxes of 64 K columns x 128 rows, the stacked weights (L, K, N) in boxes
// of 64 columns x 64 K rows x 1 layer
inline cudaError_t make_maps(WholeArgs& a) {
  const Scratch<__nv_bfloat16> s(a);
  const cuuint64_t M = (cuuint64_t)a.R * a.C, D = a.D, Q = (cuuint64_t)a.H * a.dk,
                   KVd = (cuuint64_t)a.KV * a.dk, F = a.F, L = a.L;
  const struct { int map; const void* base; cuuint64_t K; } acts[] = {
      {kMapH, s.h, D}, {kMapAttn, s.attn, Q}, {kMapH2, s.h2, D}, {kMapAct, s.act, F}};
  for (const auto& x : acts) {
    const cuuint64_t dims[2] = {x.K, M}, strides[1] = {x.K * 2};
    const cuuint32_t box[2] = {kTcBK, kTcRows};
    const cudaError_t err = hopper::make_map_bf16(&a.maps[x.map], x.base, 2, dims, strides, box);
    if (err != cudaSuccess) return err;
  }
  const struct { int map; const void* base; cuuint64_t K, N; } weights[] = {
      {kMapWq, a.wq, D, Q},          {kMapWk, a.wk, D, KVd},   {kMapWv, a.wv, D, KVd},
      {kMapWo, a.wo, Q, D},          {kMapWgate, a.w_gate, D, F}, {kMapWup, a.w_up, D, F},
      {kMapWdown, a.w_down, F, D}};
  for (const auto& w : weights) {
    if (w.base == nullptr) continue;  // no gate without GLU
    const cuuint64_t dims[3] = {w.N, w.K, L}, strides[2] = {w.N * 2, w.K * w.N * 2};
    const cuuint32_t box[3] = {64, kTcBK, 1};
    const cudaError_t err = hopper::make_map_bf16(&a.maps[w.map], w.base, 3, dims, strides, box);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

template <typename TQ, int KIND, int DK>
cudaError_t launch(WholeArgs a, cudaStream_t stream) {
  auto kernel = whole_step_kernel<TQ, KIND, DK>;
  const size_t smem = dynamic_smem<TQ, KIND, DK>(a);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  if (tc_path(a, sizeof(TQ)) && (err = make_maps(a)) != cudaSuccess) return err;
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

template <typename TQ, int KIND, int DK>
struct Launch {
  static cudaError_t run(const WholeArgs& a, cudaStream_t stream) {
    return launch<TQ, KIND, DK>(a, stream);
  }
};

// The tensor-core tile's dynamic bytes, the kernel's static shared bytes
// (from the runtime) and the split walk's dynamic bytes before its live
// slots (SplitLayout::kSlots) of one instantiation
template <typename TQ, int KIND, int DK>
struct SmemReport {
  static cudaError_t run(int* mma_bytes, int* static_bytes, int* split_bytes) {
    cudaFuncAttributes attr;
    const cudaError_t err = cudaFuncGetAttributes(&attr, whole_step_kernel<TQ, KIND, DK>);
    *mma_bytes = (int)MmaSmem<TQ, KIND, DK>::kBytes;
    *static_bytes = (int)attr.sharedSizeBytes;
    *split_bytes = (int)SplitLayout<TQ, DK>::kSlots;
    return err;
  }
};

// F<TQ, KIND, DK>::run(args...) at the runtime dtype, pool kind and head dim
template <template <typename, int, int> class F, typename TQ, int KIND, typename... A>
cudaError_t by_dk(int dk, A... args) {
  if (dk == 64) return F<TQ, KIND, 64>::run(args...);
  if (dk == 80) return F<TQ, KIND, 80>::run(args...);
  if (dk == 128) return F<TQ, KIND, 128>::run(args...);
  if (dk == 256) return F<TQ, KIND, 256>::run(args...);
  return cudaErrorInvalidValue;
}

template <template <typename, int, int> class F, typename TQ, typename... A>
cudaError_t by_kind(int pool_kind, int dk, A... args) {
  if (pool_kind == kPoolFloat) return by_dk<F, TQ, kPoolFloat>(dk, args...);
  if (pool_kind == kPoolInt8) return by_dk<F, TQ, kPoolInt8>(dk, args...);
  if (pool_kind == kPoolInt4) return by_dk<F, TQ, kPoolInt4>(dk, args...);
  return cudaErrorInvalidValue;
}

template <template <typename, int, int> class F, typename... A>
cudaError_t dispatch(int dtype, int pool_kind, int dk, A... args) {
  if (dtype == kBFloat16) return by_kind<F, __nv_bfloat16>(pool_kind, dk, args...);
  if (dtype == kFloat32) return by_kind<F, float>(pool_kind, dk, args...);
  return cudaErrorInvalidValue;
}

}  // namespace
}  // namespace fft

extern "C" int whole_step_decode_launch(
    const void* attn_norm, const void* attn_norm_b, const void* wq, const void* wk,
    const void* wv, const void* bq, const void* bk, const void* bv, const void* wo,
    const void* bo, const void* mlp_norm, const void* mlp_norm_b, const void* w_gate,
    const void* b_gate, const void* w_up, const void* b_up, const void* w_down,
    const void* b_down, const void* final_norm, const void* final_norm_b, const void* head,
    const void* head_b, const void* x0, const void* cos, const void* sin, void* k_pool,
    void* v_pool, void* k_scale, void* v_scale, const void* table, const void* phys,
    const void* off, const void* mask, const void* logits_idx, void* logits, void* tokens,
    void* scratch, void* work, void* stamps, void* counters, int L, int R, int C, int D, int H,
    int KV, int dk, int F, int V, int ps, int NP, int P1, int tiles, int KS, int tied,
    int dtype, int pool_kind, int split_pages, int all_logits, int norm_kind, int act, int glu,
    int block, int rot, float eps, float scale, float qmax, void* stream) {
  using namespace fft;
  if (L <= 0 || R <= 0 || C <= 0 || C > kMaxChunk || KV <= 0 || H % KV != 0 || tiles <= 0 ||
      KS <= 0 || NP <= 0 || V <= 0)
    return (int)cudaErrorInvalidValue;
  if (ps != 16 && ps != 32 && ps != 64 && ps != 128) return (int)cudaErrorInvalidValue;
  if (D % kBK || (H * dk) % kBK || F % kBK) return (int)cudaErrorInvalidValue;
  if ((H * dk) % tiles || (KV * dk) % tiles || D % tiles || F % tiles)
    return (int)cudaErrorInvalidValue;
  // the body: its kinds, the tensors each needs, a rotary width within the head
  if (norm_kind < kNormRms || norm_kind > kNormLayer || act < kActSilu || act > kActRelu ||
      block < kSequential || block > kParallelTwoNorms)
    return (int)cudaErrorInvalidValue;
  if (attn_norm == nullptr || wq == nullptr || wk == nullptr || wv == nullptr || wo == nullptr ||
      w_up == nullptr || w_down == nullptr || final_norm == nullptr || head == nullptr ||
      (glu != 0) != (w_gate != nullptr) || (block == kParallelOneNorm) != (mlp_norm == nullptr))
    return (int)cudaErrorInvalidValue;
  if ((cos == nullptr) != (rot == 0) || (cos == nullptr) != (sin == nullptr) || rot % 2 ||
      rot < 0 || rot > dk)
    return (int)cudaErrorInvalidValue;
  // every column tile's fragments fit a warp's accumulators
  const int wmax = imax(imax(role_width(H * dk, tiles), role_width(KV * dk, tiles)),
                        imax(role_width(D, tiles), role_width(F, tiles)));
  if ((wmax / 8 + kWarps - 1) / kWarps > kMaxFrags) return (int)cudaErrorInvalidValue;
  if (pool_kind != kPoolFloat && (k_scale == nullptr || v_scale == nullptr))
    return (int)cudaErrorInvalidValue;
  // the decode design's split walk: at most kSplitMaxSplits splits, one
  // unless C == 1, merge counters with several
  if (split_pages <= 0) return (int)cudaErrorInvalidValue;
  const int nsplit = (NP + split_pages - 1) / split_pages;
  if (nsplit > kSplitMaxSplits || (nsplit > 1 && (C != 1 || counters == nullptr)))
    return (int)cudaErrorInvalidValue;
  WholeArgs a{};
  a.attn_norm = attn_norm;
  a.attn_norm_b = attn_norm_b;
  a.wq = wq;
  a.wk = wk;
  a.wv = wv;
  a.bq = bq;
  a.bk = bk;
  a.bv = bv;
  a.wo = wo;
  a.bo = bo;
  a.mlp_norm = mlp_norm;
  a.mlp_norm_b = mlp_norm_b;
  a.w_gate = w_gate;
  a.b_gate = b_gate;
  a.w_up = w_up;
  a.b_up = b_up;
  a.w_down = w_down;
  a.b_down = b_down;
  a.final_norm = final_norm;
  a.final_norm_b = final_norm_b;
  a.head = head;
  a.head_b = head_b;
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
  a.stamps = static_cast<long long*>(stamps);
  a.counters = static_cast<int*>(counters);
  a.split_pages = split_pages;
  a.all_logits = all_logits != 0;
  a.norm_kind = norm_kind;
  a.act = act;
  a.glu = glu != 0;
  a.block = block;
  a.rot = rot;
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
  return (int)dispatch<Launch>(dtype, pool_kind, dk, a, s);
}

// The attention design (PagedDesign) of the kernel's stage 3 for C query
// tokens per slot, H query and KV key/value heads and q of DType dtype.
extern "C" int whole_step_decode_design(int C, int H, int KV, int dtype) {
  return fft::paged_design(C * (H / (KV > 0 ? KV : 1)), dtype);
}

// The tensor-core attention tile's dynamic shared bytes (MmaSmem), the
// kernel's static shared bytes and the split walk's dynamic bytes before
// its R live slots (SplitLayout::kSlots) of the (dtype, pool_kind, dk)
// instantiation.
extern "C" int whole_step_decode_smem(int dtype, int pool_kind, int dk, int* mma_bytes,
                                      int* static_bytes, int* split_bytes) {
  return (int)fft::dispatch<fft::SmemReport>(dtype, pool_kind, dk, mma_bytes, static_bytes,
                                             split_bytes);
}

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
