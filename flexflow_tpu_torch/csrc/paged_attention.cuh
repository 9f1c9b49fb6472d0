// The page-tile attention loop shared by ragged_paged_attention.cu,
// fused_rope_paged_attention.cu and whole_step_decode.cu.
//
// q (R, C, H, dk) attends, under mask (R, C, NP * ps), the virtual cache
// of its slot: logical line s of slot r lives at line s % ps of physical
// page table[r, s / ps] of the pools (P + 1, ps, KV, dk / pack). Grouped-
// query heads h = kv * G + g share KV head kv; query rows of one KV head
// are numbered i = c * G + g. f32 online softmax; the denominator is
// clamped at 1e-20, so a row with nothing to attend gives 0. Output in
// q's dtype.
//
// Pools hold q's dtype (float, bf16) or quantized codes: int8, or int4
// as uint8 bytes whose low nibble is dim j and high nibble dim j + dk/2,
// each biased by +8. A quantized page carries one f32 scale per KV head
// (k_scale, v_scale (P + 1, KV)). The scales are applied as the TPU
// kernel applies them: a score is dot(q, k codes) * (k_scale * scale),
// and a probability is multiplied by v_scale before it weighs the V
// codes (the softmax sum takes the unscaled probability). A full-
// precision pool uses the same formulas with both page scales 1.
//
// Three block designs (paged_design), chosen by the number of query rows
// per KV head and q's dtype:
//  * "decode" (C * G <= 8: decode steps): attend_split (paged_decode.cuh:
//    one block per (slot, KV head, split of whole pages), its partials
//    merged by the last block), in the ragged, fused and whole-step
//    kernels alike.
//  * attend_tile_mma ("mma", bf16 q, C * G > 8: mixed and prefill steps
//    in the model dtype): one block of 8 warps per (slot, KV head, 128
//    rows), on the tensor cores. A bf16 mixed step at C = 128 is bound by
//    the bytes of the pages it opens, its FLOP about a quarter of that
//    time at the bf16 tensor-core rate; on the CUDA cores in f32 (an
//    earlier tile) the same FLOP bound it many times over. So: QK^T and
//    PV run as mma.sync.m16n8k16 bf16 with f32 accumulation (mma.cuh),
//    warp w owning rows 16 w .. 16 w + 15 with its Q fragments in
//    registers for the whole walk and the scores and (m, l) in the
//    accumulators (base-2 exponent, tree reductions: with one block of 8
//    warps an SM, two warps a scheduler, the softmax is latency-bound);
//    P enters PV as a hi + lo pair of bf16, so the result stays as close
//    to the f32 plain version as the CUDA-core tile. K/V tiles of 64
//    lines stream through three bf16 buffers, two cp.async copies
//    (16-byte, through L2) in flight while the third is multiplied, one
//    barrier a tile; int8/int4 codes are copied raw and widened to bf16
//    codes in shared memory (every code is exact in bf16; the page scales
//    stay on the scores and probabilities), so quantized pools still move
//    1/2 and 1/4 of the bytes. 128 rows read each tile once: at C = 128,
//    G = 1 that is every row of a (slot, KV head). The mask of 32 tiles
//    is packed to bits ahead of them (with their page ids and scales), so
//    a tile no row of the block attends is never read and a warp whose 16
//    rows attend nothing in a tile skips its math. A warp's math on one
//    tile is mma_warp_tile, which the dense verify kernel shares.
//  * attend_tile_mma<float> ("tf32x3", f32 q, C * G > 8): the same block,
//    chunk loop and cp.async ring on f32 tiles (row stride dk + 4), with
//    the block's Q rows in shared memory and each tile taken in two
//    32-line halves (at dk 128, Q fragments in registers or 64-line
//    scores made ptxas spill); f32 pages at dk 128 then leave room for
//    two stages and the bits of 16 tiles.
//    On the CUDA cores (an earlier tile) an f32 mixed step at C = 128 ran
//    5.3 times its 67 TFLOP/s bound. One TF32 product keeps ~11 bits of
//    each operand and misses the f32 kernels' 1e-5 tolerance by 7-12
//    times; split on one product alone it still misses (5-6e-5). So both
//    products run as 3xTF32 on mma.sync.m16n8k8 (mma.cuh: every operand
//    split into TF32 hi + lo, lo * hi and hi * lo before hi * hi), within
//    ~2e-7 of the f32 result with IEEE f32 sums; the tensor cores' own
//    f32 sums lose more, so each k-step of S and each half tile of PV sums
//    in fresh accumulators, added up in f32. On int8/int4 pools the codes
//    are exact in TF32 and only Q and P split (two products). Q splits
//    per k-step; PV takes each 8-line group's lines in the order the S
//    accumulator holds them (tf32_warp_tile). The bound is then 3 (2)
//    products at the TF32 rate, 494.7 TFLOP/s.
// The whole-step kernel (whole_step_decode.cu) runs attend_split on 8
// warps an item and attend_tile_mma in 128-row passes in its attention
// stage.
//
// Pool and q pointers are read with plain loads (never the read-only
// cache): the fused kernel writes them earlier in the same launch.
#pragma once

#include <type_traits>

#include "mma.cuh"

namespace fft {

enum PoolKind : int { kPoolFloat = 0, kPoolInt8 = 1, kPoolInt4 = 2 };

enum PagedDesign : int { kDesignDecode = 0, kDesignMma = 1, kDesignTf32x3 = 2 };

constexpr int kDecodeRows = 8;    // most query rows per KV head of a decode block

// The block design of a paged attention call with ``rows`` = C * G query
// rows per KV head and q of DType ``dtype``; the launchers route by it and
// export it to their wrappers.
__host__ __device__ inline int paged_design(int rows, int dtype) {
  if (rows <= kDecodeRows) return kDesignDecode;
  return dtype == kBFloat16 ? kDesignMma : kDesignTf32x3;
}

struct PagedArgs {
  const void* q;         // (R, C, H, dk) TQ
  const void* k_pool;    // (P + 1, ps, KV, dk / pack)
  const void* v_pool;
  const float* k_scale;  // (P + 1, KV), quantized pools only
  const float* v_scale;
  const int* table;      // (R, NP)
  const uint8_t* mask;   // (R, C, NP * ps) bool
  void* out;             // (R, C, H, dk) TQ
  int R, C, H, KV, ps, NP;
  float scale;
};

template <typename TQ, int KIND> struct PoolT { using T = TQ; };
template <typename TQ> struct PoolT<TQ, kPoolInt8> { using T = int8_t; };
template <typename TQ> struct PoolT<TQ, kPoolInt4> { using T = uint8_t; };

template <int KIND>
__host__ __device__ constexpr int pack_of() { return KIND == kPoolInt4 ? 2 : 1; }

// Element offset of (page, line, KV head) in a pool of row width DK / pack.
template <int KIND, int DK>
__device__ __forceinline__ size_t pool_row(int page, int line, int h, int ps, int KV) {
  return (((size_t)page * ps + line) * KV + h) * (DK / pack_of<KIND>());
}

// ---------------------------------------------------------------------------
// tile designs

constexpr int kTileLines = 64;               // virtual lines per tile

// ---------------------------------------------------------------------------
// tensor-core designs: "mma" (bf16 q) and "tf32x3" (f32 q)

constexpr int kMmaTileWarps = 8;
constexpr int kMmaTileThreads = kMmaTileWarps * 32;
constexpr int kMmaTileRows = kMmaTileWarps * 16;  // query rows per block or pass
constexpr int kMmaStages = 3;                     // K/V tile buffers: two copies in flight
constexpr int kMetaTiles = 32;                    // tiles whose mask bits are staged at once
// dynamic shared bytes a tensor-core tile may take: a block's 232,448 less
// 8 KB for static buffers (the fused kernel's, paged_commit.cuh, take at
// most 5,120)
constexpr size_t kMmaSmemBudget = 232448 - 8192;

// Shared bytes of the mask bits, page ids, scales and flags of ``tiles``
// tiles for the 128 rows of a tensor-core tile
__host__ __device__ constexpr size_t mma_meta_bytes(int tiles) {
  return sizeof(uint64_t) * tiles * kMmaTileRows                         // bits [tile][row]
         + (2 * sizeof(float) + sizeof(int)) * (tiles * kTileLines / 16)  // pages at ps = 16
         + size_t(tiles) * (kMmaTileRows / 32);                           // flags [tile][32 rows]
}

// Shared memory of attend_tile_mma for q of type TQ: K/V tiles of 64 lines
// in TQ (kStages of them, or, for quantized pools, one that the raw codes
// of kStages stages widen into); the block's 128 Q rows in TQ where they
// live in shared memory (kQShared); then the mask bits, page ids, scales
// and flags of kMeta tiles. Q rows go to shared memory for f32 q (split
// per k-step there) and for bf16 q above dk 128 (at dk 256 its A
// fragments in registers would add 64 a thread to the accumulator's 128),
// where two stages fit beside them; f32 q at dk 256 fits no two stages
// beside its rows (130 KB each) and reads them from global memory. Then as
// many stages (3, 2 or 1) and mask tiles (32 or 16) as fit: bf16 q at dk
// 64-128 takes three stages and 32 tiles, f32 pages at dk 128 two stages
// and 16 tiles, f32 pages at dk 256 one stage and 32 tiles.
template <typename TQ, int KIND, int DK>
struct MmaSmem {
  static constexpr bool kQuant = KIND != kPoolFloat;
  static constexpr bool kF32 = std::is_same<TQ, float>::value;
  // row stride in elements: bf16 rows padded by 8 (mma.cuh); f32 rows by
  // 4, so a stride of 4 (mod 32) words puts the TF32 fragment reads of a
  // warp (8 rows x 4 dims of Q and K; 4 line pairs x 8 dims of V) on 32
  // banks
  static constexpr int kLd = kF32 ? DK + 4 : LdH<DK>::kRow;
  static constexpr int kRaw = DK / pack_of<KIND>();           // code bytes of a pool row
  static constexpr size_t kTile = size_t(kTileLines) * kLd;   // elements of a K or V tile
  static constexpr size_t kPair = 2 * kTile * sizeof(TQ);     // bytes of a K/V tile pair
  static constexpr size_t kRawPair = 2 * size_t(kTileLines) * kRaw;
  static constexpr size_t kQRows = size_t(kMmaTileRows) * kLd * sizeof(TQ);
  // K/V buffers at ``stages`` stages
  static __host__ __device__ constexpr size_t buffers(int stages) {
    return kQuant ? kPair + stages * kRawPair : stages * kPair;
  }
  static __host__ __device__ constexpr bool fits(size_t q, int stages, int meta) {
    return q + buffers(stages) + mma_meta_bytes(meta) <= kMmaSmemBudget;
  }
  static constexpr bool kQShared = (kF32 || DK > 128) && fits(kQRows, 2, kMetaTiles / 2);
  static constexpr size_t kQ = kQShared ? kQRows : 0;
  static constexpr int kStages = fits(kQ, kMmaStages, kMetaTiles / 2) ? kMmaStages
                                 : fits(kQ, 2, kMetaTiles / 2)      ? 2
                                                                    : 1;
  static constexpr size_t kTiles = (kQuant ? 1 : kStages) * kPair;
  static constexpr size_t kRawBytes = kQuant ? kStages * kRawPair : 0;
  static constexpr int kMeta = fits(kQ, kStages, kMetaTiles) ? kMetaTiles : kMetaTiles / 2;
  static constexpr int kMetaPages = kMeta * kTileLines / 16;
  static constexpr size_t kBytes = kTiles + kRawBytes + kQ + mma_meta_bytes(kMeta);
  static_assert(kBytes <= kMmaSmemBudget, "tensor-core tile over the shared-memory budget");
};

// Bit j set when the mask row mrow attends line s0 + j, for the 64 lines
// from s0 (lines at or past S, a multiple of 16, read as 0). mrow + s0 is
// 16-byte aligned.
__device__ __forceinline__ uint64_t mask_bits(const uint8_t* mrow, int s0, int S) {
  uint64_t bits = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if (s0 + 16 * k >= S) break;
    const uint4 w = *reinterpret_cast<const uint4*>(mrow + s0 + 16 * k);
    const uint32_t v[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      // bytes -> 0/1 per byte -> 4 bits (byte b to bit b)
      const uint32_t nib = ((__vcmpne4(v[i], 0u) & 0x01010101u) * 0x01020408u) >> 24;
      bits |= uint64_t(nib) << (16 * k + 4 * i);
    }
  }
  return bits;
}

// The online softmax update of one warp's 16 query rows over the 8 * NT8
// lines of a tile (64, or a 32-line half). On entry s[nt][e] holds the dot
// product of row g (e < 2) or g + 8 with line 8 nt + 2 t + (e & 1) (an
// m16n8 accumulator); its mask bit is bit 8 nt + 2 t + (e & 1) of ba (row
// g) or bb (row g + 8). The score is the dot times kscale(nt) (the
// softmax scale times log2(e),
// and a quantized page's K scale). On return s holds each line's
// probability (0 on masked lines), with QUANT multiplied by vscale(nt)
// (the page's V scale; the sum l takes it unscaled); o is rescaled to
// the new running maxima m (base 2), and l updated.
template <int DK, bool QUANT, int NT8 = kTileLines / 8, typename KScale, typename VScale>
__device__ __forceinline__ void softmax_tile(float (&s)[NT8][4], uint64_t ba,
                                             uint64_t bb, int t, KScale kscale,
                                             VScale vscale, float (&o)[DK / 8][4],
                                             float (&m)[2], float (&l)[2]) {
  const uint64_t xa = ba >> (2 * t), xb = bb >> (2 * t);
  // the row maxima and sums reduce as trees (short dependency chains:
  // each scheduler runs only two warps)
  float red_a[NT8], red_b[NT8];
#pragma unroll
  for (int nt = 0; nt < NT8; ++nt) {
    const float ksc = kscale(nt);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const bool on = (((e < 2 ? xa : xb) >> (nt * 8 + (e & 1))) & 1ull) != 0ull;
      s[nt][e] = on ? s[nt][e] * ksc : kNegInf;
    }
    red_a[nt] = fmaxf(s[nt][0], s[nt][1]);
    red_b[nt] = fmaxf(s[nt][2], s[nt][3]);
  }
  float mx[2] = {fmaxf(m[0], tree_max<NT8>(red_a)),
                 fmaxf(m[1], tree_max<NT8>(red_b))};
  float corr[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    corr[i] = exp2_ftz(m[i] - mx[i]);
    m[i] = mx[i];
  }
#pragma unroll
  for (int nt = 0; nt < NT8; ++nt) {
    bool on[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      on[e] = (((e < 2 ? xa : xb) >> (nt * 8 + (e & 1))) & 1ull) != 0ull;
      s[nt][e] = on[e] ? exp2_ftz(s[nt][e] - m[e >> 1]) : 0.f;
    }
    red_a[nt] = s[nt][0] + s[nt][1];
    red_b[nt] = s[nt][2] + s[nt][3];
    if constexpr (QUANT) {
      // lines on pages past the chunk's last (past S) have no scale
      // staged: read only on attended lines
      const float vsc = vscale(nt);
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = on[e] ? s[nt][e] * vsc : 0.f;
    }
  }
  l[0] = l[0] * corr[0] + tree_sum<NT8>(red_a);
  l[1] = l[1] * corr[1] + tree_sum<NT8>(red_b);
#pragma unroll
  for (int nt = 0; nt < DK / 8; ++nt) {
    o[nt][0] *= corr[0];
    o[nt][1] *= corr[0];
    o[nt][2] *= corr[1];
    o[nt][3] *= corr[1];
  }
}

// One warp's 16 query rows (A fragments qa(ks, a): k-step ks of rows g and
// g + 8 of the warp; rows g and g + 8 attend the 64 lines of the tile whose
// bits are set in ba and bb, bit j for line j) against the bf16 64-line
// K/V tile sK/sV (row stride DK + 8): the online softmax update of the
// accumulators o, m, l (softmax_tile). Warp-uniform: skips the math when
// neither row of any lane attends a line of the tile. The paged tile
// (attend_tile_mma) and the dense verify kernel (verify_attention.cu)
// share it.
template <int DK, bool QUANT, typename QFrag, typename KScale, typename VScale>
__device__ __forceinline__ void mma_warp_tile_q(QFrag qa, const __nv_bfloat16* sK,
                                                const __nv_bfloat16* sV, uint64_t ba,
                                                uint64_t bb, int lane, KScale kscale,
                                                VScale vscale, float (&o)[DK / 8][4],
                                                float (&m)[2], float (&l)[2]) {
  constexpr int LD = LdH<DK>::kRow;
  if (!__any_sync(0xffffffffu, (ba | bb) != 0ull)) return;  // warp-uniform
  const int t = lane % 4;
  // S = Q K^T of the warp's 16 rows and the tile's 64 lines
  float s[kTileLines / 8][4];
#pragma unroll
  for (int nt = 0; nt < kTileLines / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
  for (int ks = 0; ks < DK / 16; ++ks) {
    uint32_t a[4];
    qa(ks, a);
#pragma unroll
    for (int n2 = 0; n2 < kTileLines / 16; ++n2) {
      uint32_t b[4];
      load_b_x4<LD>(sK, n2 * 16, ks * 16, lane, b);
      mma16816(s[2 * n2], a, b[0], b[1]);
      mma16816(s[2 * n2 + 1], a, b[2], b[3]);
    }
  }
  softmax_tile<DK, QUANT>(s, ba, bb, t, kscale, vscale, o, m, l);
  // O += P V, P as hi + lo bf16 fragments straight from the scores
#pragma unroll
  for (int kt = 0; kt < kTileLines / 16; ++kt) {
    uint32_t ah[4], al[4];
    acc_to_a(s[2 * kt], s[2 * kt + 1], ah, al);
#pragma unroll
    for (int n2 = 0; n2 < DK / 16; ++n2) {
      uint32_t b[4];
      load_b_trans<LD>(sV, kt * 16, n2 * 16, lane, b);
      mma16816(o[2 * n2], ah, b[0], b[1]);
      mma16816(o[2 * n2], al, b[0], b[1]);
      mma16816(o[2 * n2 + 1], ah, b[2], b[3]);
      mma16816(o[2 * n2 + 1], al, b[2], b[3]);
    }
  }
}

// mma_warp_tile_q with the warp's A fragments held in registers, qa.
template <int DK, bool QUANT, typename KScale, typename VScale>
__device__ __forceinline__ void mma_warp_tile(const uint32_t (&qa)[DK / 16][4],
                                              const __nv_bfloat16* sK,
                                              const __nv_bfloat16* sV, uint64_t ba,
                                              uint64_t bb, int lane, KScale kscale,
                                              VScale vscale, float (&o)[DK / 8][4],
                                              float (&m)[2], float (&l)[2]) {
  mma_warp_tile_q<DK, QUANT>(
      [&](int ks, uint32_t (&a)[4]) {
#pragma unroll
        for (int e = 0; e < 4; ++e) a[e] = qa[ks][e];
      },
      sK, sV, ba, bb, lane, kscale, vscale, o, m, l);
}

// mma_warp_tile for f32 q ("tf32x3"): the warp's 16 f32 Q rows sQ
// against the f32 64-line K/V tile sK/sV (all with row stride DK + 4),
// both products in 3xTF32 (mma_3xtf32; with QUANT the tiles hold exact
// codes and only Q and P are split), in two halves of 32 lines, each an
// online softmax step of its own (S of a half takes 16 registers a
// thread: with 64 ptxas spilled at dk 128). Q stays in shared memory (its
// fragments would take 64 more) and is split per k-step. The tensor
// cores' f32 sums lose more than IEEE sums, so each k-step of S and each
// half's PV (NG column tiles at a time, P split again for each group) is
// summed in fresh accumulators and added in f32: summed in O over a whole
// walk (2176 lines at C = 128, LLaMA-7B widths) the output missed 1e-5
// on an H100. The accumulator of S holds lines 2 t, 2 t + 1 of
// each 8-line group where PV's A fragment wants k indices t, t + 4: PV
// takes the group's lines in that order instead (k index t is line 2 t,
// t + 4 is line 2 t + 1), so P enters PV with no shuffle and V's B
// fragment reads lines 2 t and 2 t + 1.
//
// tf32_warp_tile_rows takes the warp's rows g and g + 8 of this lane as
// pointers qg and qg8 to their dim t (shared memory, or the q tensor where
// the rows do not fit in shared memory: f32 at dk 256).
template <int DK, bool QUANT, typename KScale, typename VScale>
__device__ __forceinline__ void tf32_warp_tile_rows(const float* qg, const float* qg8,
                                                    const float* sK, const float* sV,
                                                    uint64_t ba, uint64_t bb, int lane,
                                                    KScale kscale, VScale vscale,
                                                    float (&o)[DK / 8][4], float (&m)[2],
                                                    float (&l)[2]) {
  constexpr int LD = DK + 4, HALF = kTileLines / 2, NT8 = HALF / 8;
  constexpr int NG = (DK / 8) % 4 == 0 ? 4 : 2;  // column tiles of PV at a time
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const uint64_t ha = ba >> (HALF * hf), hb = bb >> (HALF * hf);
    // warp-uniform: skip a half no line of which either row of any lane attends
    if (!__any_sync(0xffffffffu, ((ha | hb) & 0xFFFFFFFFull) != 0ull)) continue;
    const float* kh = sK + HALF * hf * LD;
    const float* vh = sV + HALF * hf * LD;
    float s[NT8][4];
#pragma unroll
    for (int nt = 0; nt < NT8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll 2
    for (int ks = 0; ks < DK / 8; ++ks) {  // A = Q: rows g, g + 8, dims t, t + 4
      uint32_t ah[4], al[4];
      split_tf32(qg[8 * ks], ah[0], al[0]);
      split_tf32(qg8[8 * ks], ah[1], al[1]);
      split_tf32(qg[8 * ks + 4], ah[2], al[2]);
      split_tf32(qg8[8 * ks + 4], ah[3], al[3]);
      const float* k = kh + g * LD + 8 * ks + t;  // B = K^T: line 8 nt + g, dims t, t + 4
#pragma unroll
      for (int nt = 0; nt < NT8; ++nt) {
        float f[4] = {0.f, 0.f, 0.f, 0.f};
        mma_3xtf32<QUANT>(f, ah, al, k[8 * nt * LD], k[8 * nt * LD + 4]);
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nt][e] += f[e];
      }
    }
    softmax_tile<DK, QUANT, NT8>(
        s, ha, hb, t, [&](int nt) { return kscale(NT8 * hf + nt); },
        [&](int nt) { return vscale(NT8 * hf + nt); }, o, m, l);
#pragma unroll
    for (int n0 = 0; n0 < DK / 8; n0 += NG) {
      float acc[NG][4];
#pragma unroll
      for (int n = 0; n < NG; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
#pragma unroll
      for (int kt = 0; kt < NT8; ++kt) {
        uint32_t ah[4], al[4];
        split_tf32(s[kt][0], ah[0], al[0]);  // row g, line 2 t
        split_tf32(s[kt][2], ah[1], al[1]);  // row g + 8, line 2 t
        split_tf32(s[kt][1], ah[2], al[2]);  // row g, line 2 t + 1
        split_tf32(s[kt][3], ah[3], al[3]);  // row g + 8, line 2 t + 1
        const float* v = vh + (8 * kt + 2 * t) * LD + 8 * n0 + g;  // column 8 n + g
#pragma unroll
        for (int n = 0; n < NG; ++n) mma_3xtf32<QUANT>(acc[n], ah, al, v[8 * n], v[8 * n + LD]);
      }
#pragma unroll
      for (int n = 0; n < NG; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[n0 + n][e] += acc[n][e];
    }
  }
}

// tf32_warp_tile_rows of the warp's 16 rows at sQ (row stride DK + 4).
template <int DK, bool QUANT, typename KScale, typename VScale>
__device__ __forceinline__ void tf32_warp_tile(const float* sQ, const float* sK,
                                               const float* sV, uint64_t ba, uint64_t bb,
                                               int lane, KScale kscale, VScale vscale,
                                               float (&o)[DK / 8][4], float (&m)[2],
                                               float (&l)[2]) {
  const float* qg = sQ + (lane / 4) * (DK + 4) + lane % 4;
  tf32_warp_tile_rows<DK, QUANT>(qg, qg + 8 * (DK + 4), sK, sV, ba, bb, lane, kscale, vscale,
                                 o, m, l);
}

// Rows [row0, row0 + 128) of KV head h of slot r on the tensor cores: bf16
// q ("mma", mma_warp_tile) or f32 q ("tf32x3", tf32_warp_tile); smem holds
// MmaSmem<TQ, KIND, DK>::kBytes. Warp w always owns rows row0 + 16 w ..
// row0 + 16 w + 15, and a row's result depends on its own mask bits and
// the tiles it attends alone, taken in one order: the ragged kernel (one
// block a pass) and the fused kernel (every pass in one block) give the
// same bits. All kMmaTileThreads threads of the block call it; it ends
// with a barrier.
template <typename TQ, int KIND, int DK>
__device__ void attend_tile_mma(const PagedArgs& a, int r, int h, int row0,
                                unsigned char* smem) {
  using L = MmaSmem<TQ, KIND, DK>;
  using PT = typename PoolT<TQ, KIND>::T;
  constexpr bool kF32 = L::kF32;
  constexpr int LD = L::kLd, RAW = L::kRaw, META = L::kMeta, STAGES = L::kStages;
  constexpr int kRowBytes = L::kQuant ? RAW : DK * int(sizeof(TQ));  // pool bytes of one line
  // bytes a copy: 16, or 8 for a dk-80 int4 line (40 bytes, 8-byte aligned)
  constexpr int kCopy = kRowBytes % 16 == 0 ? 16 : 8;
  constexpr int kChunks = kRowBytes / kCopy;           // copies of one line
  // Q: bf16 q at dk <= 128 as the warp's A fragments in registers for the
  // whole walk; else the block's rows in shared memory (kQShared), or f32
  // q at dk 256 read from q itself
  constexpr bool kQRegs = !kF32 && !L::kQShared;
  TQ* sKV = reinterpret_cast<TQ*>(smem);               // [stage][K, V][64][LD]
  uint8_t* sRaw = smem + L::kTiles;                    // quantized: [stage][K, V][64][RAW]
  TQ* sQ = reinterpret_cast<TQ*>(sRaw + L::kRawBytes);  // kQShared: [128][LD]
  uint64_t* sBits = reinterpret_cast<uint64_t*>(sRaw + L::kRawBytes + L::kQ);  // [tile][row]
  float* sPk = reinterpret_cast<float*>(sBits + META * kMmaTileRows);
  float* sPv = sPk + L::kMetaPages;
  int* sPid = reinterpret_cast<int*>(sPv + L::kMetaPages);
  uint8_t* sFlag = reinterpret_cast<uint8_t*>(sPid + L::kMetaPages);  // [tile][4 warps]

  const int G = a.H / a.KV, rows = a.C * G, ps = a.ps, S = a.NP * ps;
  const int ps_log = __ffs(ps) - 1;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int ra = row0 + 16 * warp + g, rb = ra + 8;  // this thread's rows
  const TQ* q = static_cast<const TQ*>(a.q);
  auto qrow = [&](int i) {  // query row i (token i / G, head h G + i % G)
    return q + (((size_t)r * a.C + i / G) * a.H + (size_t)h * G + i % G) * DK;
  };

  // Q, zero past the last row (shared rows are read after the barrier that
  // opens the first chunk); q read in place takes a row past the last as
  // the last row's (finite; its output is never written)
  uint32_t qa[kQRegs ? DK / 16 : 1][4];
  const TQ* qg = qrow(min(ra, rows - 1)) + t;
  const TQ* qg8 = qrow(min(rb, rows - 1)) + t;
  if constexpr (L::kQShared) {
    constexpr int V = 16 / int(sizeof(TQ));  // elements of a 16-byte vector
    for (int idx = tid; idx < kMmaTileRows * DK / V; idx += kMmaTileThreads) {
      const int ii = idx / (DK / V), d = idx % (DK / V) * V, i = row0 + ii;
      uint4 x = make_uint4(0u, 0u, 0u, 0u);
      if (i < rows) x = *reinterpret_cast<const uint4*>(qrow(i) + d);
      *reinterpret_cast<uint4*>(sQ + ii * LD + d) = x;
    }
  } else if constexpr (kQRegs) {
    const TQ* pa = ra < rows ? qrow(ra) + 2 * t : nullptr;
    const TQ* pb = rb < rows ? qrow(rb) + 2 * t : nullptr;
#pragma unroll
    for (int ks = 0; ks < DK / 16; ++ks) {
      qa[ks][0] = pa ? ld32(pa + 16 * ks) : 0u;
      qa[ks][1] = pb ? ld32(pb + 16 * ks) : 0u;
      qa[ks][2] = pa ? ld32(pa + 16 * ks + 8) : 0u;
      qa[ks][3] = pb ? ld32(pb + 16 * ks + 8) : 0u;
    }
  }
  float o[DK / 8][4], m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int nt = 0; nt < DK / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[nt][e] = 0.f;

  // copy the K/V lines of tile u into stage st (lines at or past S zero):
  // kChunks threads a line, each line's pool offset computed once for K and V
  auto issue = [&](int u, int p0, int st) {
    constexpr int kLinesPerPass = kMmaTileThreads / kChunks;
    if (tid >= kLinesPerPass * kChunks) return;  // kChunks 5, 10, 20: a few threads idle
    const int c = tid % kChunks;
#pragma unroll
    for (int j = tid / kChunks; j < kTileLines; j += kLinesPerPass) {
      const int s = u * kTileLines + j;
      size_t off = 0;
      int nbytes = 0;
      if (s < S) {
        off = pool_row<KIND, DK>(sPid[(s >> ps_log) - p0], s & (ps - 1), h, ps, a.KV) *
                  sizeof(PT) + kCopy * c;
        nbytes = kCopy;
      }
      const int lk = st * 2 * kTileLines + j, lv = lk + kTileLines;
      cp_async<kCopy>(L::kQuant ? static_cast<void*>(sRaw + lk * RAW + kCopy * c)
                                : static_cast<void*>(sKV + lk * LD + (kCopy / sizeof(TQ)) * c),
                      static_cast<const uint8_t*>(a.k_pool) + off, nbytes);
      cp_async<kCopy>(L::kQuant ? static_cast<void*>(sRaw + lv * RAW + kCopy * c)
                                : static_cast<void*>(sKV + lv * LD + (kCopy / sizeof(TQ)) * c),
                      static_cast<const uint8_t*>(a.v_pool) + off, nbytes);
    }
  };
  // widen the codes of stage st to TQ codes (exact in bf16 and in TF32) in
  // the one K/V tile pair
  auto widen = [&](int st) {
    constexpr int kItems = RAW / 8;  // 8 code bytes an item
    for (int idx = tid; idx < 2 * kTileLines * kItems; idx += kMmaTileThreads) {
      const int kv = idx / (kTileLines * kItems);
      const int j = idx / kItems % kTileLines, c8 = idx % kItems * 8;
      const uint2 w = *reinterpret_cast<const uint2*>(
          sRaw + ((st * 2 + kv) * kTileLines + j) * RAW + c8);
      const uint8_t* b = reinterpret_cast<const uint8_t*>(&w);
      TQ* dst = sKV + (kv * kTileLines + j) * LD + c8;
      if constexpr (kF32) {
        float x[8], y[8];  // dims c8 .. c8 + 7 (int4: and c8 + DK / 2 ..)
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          if constexpr (KIND == kPoolInt8) {
            x[i] = float(int8_t(b[i]));
          } else {
            x[i] = float(int(b[i] & 0xF) - 8);
            y[i] = float(int(b[i] >> 4) - 8);
          }
        }
        store8<float>(dst, x);
        if constexpr (KIND == kPoolInt4) store8<float>(dst + DK / 2, y);
      } else if constexpr (KIND == kPoolInt8) {
        uint4 x;
        x.x = pack_bf16(float(int8_t(b[0])), float(int8_t(b[1])));
        x.y = pack_bf16(float(int8_t(b[2])), float(int8_t(b[3])));
        x.z = pack_bf16(float(int8_t(b[4])), float(int8_t(b[5])));
        x.w = pack_bf16(float(int8_t(b[6])), float(int8_t(b[7])));
        *reinterpret_cast<uint4*>(dst) = x;
      } else {
        uint4 lo, hi;  // dims c8 .. c8 + 7 and c8 + DK / 2 ..
        uint32_t* pl = &lo.x;
        uint32_t* ph = &hi.x;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          pl[i] = pack_bf16(float(int(b[2 * i] & 0xF) - 8), float(int(b[2 * i + 1] & 0xF) - 8));
          ph[i] = pack_bf16(float(int(b[2 * i] >> 4) - 8), float(int(b[2 * i + 1] >> 4) - 8));
        }
        *reinterpret_cast<uint4*>(dst) = lo;
        *reinterpret_cast<uint4*>(dst + DK / 2) = hi;
      }
    }
  };

  const uint8_t* mslot = a.mask + (size_t)r * a.C * S;
  const int ntiles = (S + kTileLines - 1) / kTileLines;
  for (int c0 = 0; c0 < ntiles; c0 += META) {
    const int nct = min(META, ntiles - c0);
    const int p0 = (c0 * kTileLines) >> ps_log;  // the chunk's first page
    const int npc = ((min((c0 + nct) * kTileLines, S) - c0 * kTileLines) + ps - 1) >> ps_log;
    __syncthreads();  // the last chunk's bits, pages and flags are read
    // mask bits of the chunk's tiles for the block's rows; warp w of a
    // pass covers rows 32 (w % 4) .. + 31 of tile 2 k + w / 4
#pragma unroll 4
    for (int idx = tid; idx < nct * kMmaTileRows; idx += kMmaTileThreads) {
      const int tt = idx / kMmaTileRows, ii = idx % kMmaTileRows, i = row0 + ii;
      const uint64_t bits =
          i < rows ? mask_bits(mslot + (size_t)(i / G) * S, (c0 + tt) * kTileLines, S) : 0ull;
      sBits[idx] = bits;
      const bool any = __any_sync(0xffffffffu, bits != 0ull);
      if (lane == 0) sFlag[tt * (kMmaTileRows / 32) + ii / 32] = any;
    }
    for (int j = tid; j < npc; j += kMmaTileThreads) {
      const int page = a.table[(size_t)r * a.NP + p0 + j];
      sPid[j] = page;
      // scores in base 2: dot * (k_scale * scale) * log2(e), then exp2
      sPk[j] = (KIND == kPoolFloat ? 1.f : a.k_scale[(size_t)page * a.KV + h]) * a.scale *
               kLog2e;
      sPv[j] = KIND == kPoolFloat ? 1.f : a.v_scale[(size_t)page * a.KV + h];
    }
    __syncthreads();
    uint32_t todo = 0;  // tiles any row of the block attends (block-uniform)
    for (int tt = 0; tt < nct; ++tt)
      todo |= uint32_t(reinterpret_cast<const uint32_t*>(sFlag)[tt] != 0u) << tt;

    // the attended tiles stream through STAGES buffers, STAGES - 1 copies
    // in flight while one tile is multiplied: one commit group a tile
    // (empty past the last), issued in the order the tiles are taken; with
    // one stage each tile is copied when the last is done, then waited for
    uint32_t pend = todo;
    auto issue_next = [&](int st) {
      if (pend) {
        issue(c0 + __ffs(pend) - 1, p0, st);
        pend &= pend - 1;
      }
      cp_async_commit();
    };
#pragma unroll
    for (int st = 0; st + 1 < STAGES; ++st) issue_next(st);
    for (int st = 0; todo; st = st + 1 == STAGES ? 0 : st + 1) {
      const int tt = __ffs(todo) - 1, u = c0 + tt;
      todo &= todo - 1;
      if constexpr (STAGES == 1) {
        __syncthreads();  // every warp is done with the last tile
        issue_next(0);
        cp_async_wait<0>();
        __syncthreads();  // this tile has landed for every thread
      } else {
        cp_async_wait<STAGES - 2>();  // this tile's group has landed
        __syncthreads();  // ... for every thread, and every warp is done with the last tile
        issue_next(st == 0 ? STAGES - 1 : st - 1);  // into the last tile's buffer
      }
      const TQ* sK = sKV + (L::kQuant ? 0 : st * 2 * L::kTile);
      if constexpr (L::kQuant) {
        widen(st);
        __syncthreads();
      }
      const TQ* sV = sK + L::kTile;

      const uint64_t ba = sBits[tt * kMmaTileRows + 16 * warp + g];
      const uint64_t bb = sBits[tt * kMmaTileRows + 16 * warp + g + 8];
      // lines 8 nt .. 8 nt + 7 of the tile lie on page (u * 64 + 8 nt) / ps
      const int pt = ((u * kTileLines) >> ps_log) - p0;
      auto kscale = [&](int nt) { return sPk[pt + ((nt * 8) >> ps_log)]; };
      auto vscale = [&](int nt) { return sPv[pt + ((nt * 8) >> ps_log)]; };
      if constexpr (kF32 && L::kQShared) {
        tf32_warp_tile<DK, L::kQuant>(sQ + 16 * warp * LD, sK, sV, ba, bb, lane, kscale, vscale,
                                      o, m, l);
      } else if constexpr (kF32) {
        tf32_warp_tile_rows<DK, L::kQuant>(qg, qg8, sK, sV, ba, bb, lane, kscale, vscale, o, m,
                                           l);
      } else if constexpr (kQRegs) {
        mma_warp_tile<DK, L::kQuant>(qa, sK, sV, ba, bb, lane, kscale, vscale, o, m, l);
      } else {
        mma_warp_tile_q<DK, L::kQuant>(
            [&](int ks, uint32_t (&f)[4]) { load_a<LD>(sQ, 16 * warp, 16 * ks, g, t, f); }, sK,
            sV, ba, bb, lane, kscale, vscale, o, m, l);
      }
    }
  }

  TQ* out = static_cast<TQ*>(a.out);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    const int row = i ? rb : ra;
    if (row >= rows) continue;
    const float inv = 1.f / fmaxf(l[i], kMinDenominator);
    TQ* orow = out + (((size_t)r * a.C + row / G) * a.H + (size_t)h * G + row % G) * DK + 2 * t;
#pragma unroll
    for (int nt = 0; nt < DK / 8; ++nt) {
      if constexpr (kF32) {
        *reinterpret_cast<float2*>(orow + nt * 8) =
            make_float2(o[nt][2 * i] * inv, o[nt][2 * i + 1] * inv);
      } else {
        *reinterpret_cast<uint32_t*>(orow + nt * 8) =
            pack_bf16(o[nt][2 * i] * inv, o[nt][2 * i + 1] * inv);
      }
    }
  }
  __syncthreads();  // the shared buffers may be rewritten by the next call
}

}  // namespace fft
