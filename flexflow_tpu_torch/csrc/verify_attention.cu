// verify_attention — C query tokens per request slot against the dense KV
// cache under an explicit mask, for sm_90a.
//
// Replaces the Pallas TPU kernel flexflow_tpu/serve/kernels.py
// verify_attention (body _verify_kernel). Same function: q (R, C, H, dk)
// attends the lines of k/v (R, S1, KV, dk) that the mask allows — the
// causal-by-position mask of chunked prefill and of the mixed
// continuous-batching step, or a speculation tree's bitmask. GQA heads
// h = kv * G + g share KV head kv; f32 online softmax per query row; the
// denominator is clamped at 1e-20, so a fully masked row writes zeros.
// Output in q's dtype (float32 or bfloat16).
//
// The mask arrives packed (serve/kernels.pack_mask_bits): bits (R, C, W)
// 64-bit words, W = ceil(S1 / 64), bit j of word w set when the row
// attends line 64 w + j. The serving step packs it once and every layer's
// launch reads it: it is the same for all layers and KV heads of a step,
// and a word is the mask of one 64-line tile.
//
// Bound on an H100: the larger of
//  * bytes: the K/V lines the mask reaches plus the bits and q/out bytes,
//    over 3.35 TB/s;
//  * operations: 4 * (attended (row, line) pairs) * G * dk FLOP (QK^T and
//    PV), over the rate of the unit that runs them (bf16 tensor cores
//    989 TFLOP/s; f32 q at C * G > 8 three TF32 products for each, at
//    494.7 TFLOP/s; f32 CUDA cores 67 TFLOP/s).
// A bf16 mixed step at C = 128 is bound by bytes: each (slot, KV head)'s
// cache lines are read once for all its rows. On the CUDA cores in f32
// the same FLOP bound it many times over.
//
// Four block designs (verify_design), chosen by the query rows per KV
// head (C * G) and q's dtype:
//  * "mma" (bf16 q, C * G > 8: mixed steps, prefill chunks, wide trees):
//    verify_mma_kernel, one block of 8 warps per (slot, KV head, pass of
//    128 rows numbered c * G + g), the paged kernels' tensor-core tile
//    (mma_warp_tile, paged_attention.cuh) on dense addresses: QK^T and PV
//    as mma.sync.m16n8k16 bf16 with f32 accumulation, P entering PV as
//    hi + lo bf16 (so PV keeps the f32 probabilities), base-2 exponent
//    with the scale folded in. K/V tiles of 64 lines stream through three
//    shared buffers by cp.async, two copies in flight while the third is
//    multiplied; a tile whose word is zero for every row of the pass is
//    never copied. Line s of KV head kv is at ((r * S1 + s) * KV + kv) * dk.
//  * "tf32x3" (f32 q, C * G > 8): verify_tf32_kernel, the same block and
//    cp.async ring on f32 tiles (rows padded to dk + 4 floats) with the
//    block's 128 Q rows in shared memory: the paged kernels' f32 tile
//    (tf32_warp_tile, paged_attention.cuh) on dense addresses, both
//    products as three TF32 products (each f32 operand split hi + lo), each
//    k-step of S and each half tile of PV summed in fresh accumulators and
//    added in f32 (the tensor cores' own f32 sums missed 1e-5 over a
//    2176-line walk). On the CUDA cores ("f32" below) an f32 mixed step at
//    C = 128 ran at 5.2 times its 67 TFLOP/s bound and 1.96 times SDPA;
//    the bound here is three TF32 products at 494.7 TFLOP/s. Two stages and
//    the words of 16 tiles at dk 128 (VerifyTf32Smem), three and 32 at 64.
//  * "rows8" (bf16 q, C * G <= 8: narrow trees) and "f32" (f32 q, C * G
//    <= 8): verify_kernel on the CUDA cores in f32, 32 rows a block, 64-line
//    tiles: it reads the tile's words, skips the tile when no row of the
//    block attends any of its lines (__syncthreads_or), else stages K and
//    V once in shared memory as f32 with 16-byte loads. Each of the 128
//    threads owns 4 query rows: it computes their scores against 4 lines
//    of the tile (a 4 x 4 register block fed by float4 shared-memory
//    reads, each serving 4 FMAs) and accumulates their outputs in dk / 16
//    columns each; the 16 threads that share 4 rows reduce the rows' max
//    and sum with 4 shuffles. K rows are padded by 4 floats so the 8
//    lanes of a quarter-warp read 8 lines from 32 different banks. TF32
//    alone would miss the f32 kernels' 1e-5 tolerance.
#include <type_traits>

#include "paged_attention.cuh"

namespace fft {

enum VerifyDesign : int { kVerifyRows8 = 0, kVerifyMma = 1, kVerifyF32 = 2, kVerifyTf32x3 = 3 };

// The block design of a verify call with ``rows`` = C * G query rows per
// KV head and q of DType ``dtype``; the launcher routes by it and exports
// it to the wrapper.
inline int verify_design(int rows, int dtype) {
  if (dtype != kBFloat16) return rows <= kDecodeRows ? kVerifyF32 : kVerifyTf32x3;
  return rows <= kDecodeRows ? kVerifyRows8 : kVerifyMma;
}

namespace {

constexpr int kRows = 32;                    // query rows per block
constexpr int kTile = 64;                    // cache lines per tile
constexpr int kThreads = 128;
constexpr int kLanesPerRowGroup = 16;        // threads sharing 4 rows
constexpr int kRowsPerThread = kRows / (kThreads / kLanesPerRowGroup);  // 4
constexpr int kLinesPerThread = kTile / kLanesPerRowGroup;              // 4

template <int DK>
struct Smem {
  static constexpr int kStrideK = DK + 4;     // padded: conflict-free reads
  static constexpr int kStrideP = kTile + 4;
  static constexpr size_t kK = size_t(kTile) * kStrideK;
  static constexpr size_t kV = size_t(kTile) * DK;
  static constexpr size_t kQ = size_t(kRows) * kStrideK;
  static constexpr size_t kP = size_t(kRows) * kStrideP;
  static constexpr size_t kBytes = sizeof(float) * (kK + kV + kQ + kP)
                                   + size_t(kRows) * kTile;  // mask, a byte a line
};

template <typename T, int DK>
__global__ void __launch_bounds__(kThreads)
verify_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const uint64_t* __restrict__ bits,
              T* __restrict__ out, int C, int S1, int H, int KV, float scale) {
  using L = Smem<DK>;
  constexpr int kCols = DK / kLanesPerRowGroup;  // output columns per thread
  constexpr int kVec = 16 / int(sizeof(T));      // elements per 16-byte load
  extern __shared__ __align__(16) float smem[];
  float* sK = smem;                // [kTile][DK + 4]
  float* sV = sK + L::kK;          // [kTile][DK]
  float* sQ = sV + L::kV;          // [kRows][DK + 4], pre-scaled
  float* sP = sQ + L::kQ;          // [kRows][kTile + 4]
  uint8_t* sM = reinterpret_cast<uint8_t*>(sP + L::kP);  // [kRows][kTile]

  const int row0 = blockIdx.x * kRows, h = blockIdx.y, r = blockIdx.z;
  const int G = H / KV;
  const int rows = C * G;
  const int tid = threadIdx.x;
  const int tx = tid % kLanesPerRowGroup;  // line / column group
  const int i0 = (tid / kLanesPerRowGroup) * kRowsPerThread;  // first own row

  for (int idx = tid; idx < kRows * DK; idx += kThreads) {
    const int ii = idx / DK, d = idx % DK, rr = row0 + ii;
    float x = 0.f;
    if (rr < rows) {
      const int c = rr / G, g = rr % G;
      x = to_f32<T>(q[(((size_t)r * C + c) * H + (size_t)h * G + g) * DK + d]) * scale;
    }
    sQ[ii * L::kStrideK + d] = x;
  }

  float m[kRowsPerThread], l[kRowsPerThread], acc[kRowsPerThread][kCols];
#pragma unroll
  for (int a = 0; a < kRowsPerThread; ++a) {
    m[a] = kNegInf;
    l[a] = 0.f;
#pragma unroll
    for (int e = 0; e < kCols; ++e) acc[a][e] = 0.f;
  }

  const int W = (S1 + kTile - 1) / kTile;
  const uint64_t* brow = bits + (size_t)r * C * W;
  for (int t0 = 0; t0 < S1; t0 += kTile) {
    int any = 0;
    for (int idx = tid; idx < kRows * kTile; idx += kThreads) {
      const int ii = idx / kTile, j = idx % kTile;
      const int rr = row0 + ii, s = t0 + j;
      uint8_t bit = 0;
      if (rr < rows && s < S1) bit = (brow[(size_t)(rr / G) * W + t0 / kTile] >> j) & 1ull;
      sM[idx] = bit;
      any |= bit;
    }
    // also orders this tile's smem writes after the last tile's reads
    if (!__syncthreads_or(any)) continue;

    for (int idx = tid; idx < kTile * (DK / kVec); idx += kThreads) {
      const int j = idx / (DK / kVec), d = (idx % (DK / kVec)) * kVec;
      const int s = t0 + j;
      float kx[kVec], vx[kVec];
      if (s < S1) {
        const size_t off = (((size_t)r * S1 + s) * KV + h) * DK + d;
        load_f32<T, kVec>(k + off, kx);
        load_f32<T, kVec>(v + off, vx);
      } else {
#pragma unroll
        for (int e = 0; e < kVec; ++e) kx[e] = vx[e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < kVec; e += 4) {
        *reinterpret_cast<float4*>(sK + j * L::kStrideK + d + e) =
            make_float4(kx[e], kx[e + 1], kx[e + 2], kx[e + 3]);
        *reinterpret_cast<float4*>(sV + j * DK + d + e) =
            make_float4(vx[e], vx[e + 1], vx[e + 2], vx[e + 3]);
      }
    }
    __syncthreads();

    // scores of own rows i0 + a against lines tx + 16 b
    float sc[kRowsPerThread][kLinesPerThread];
#pragma unroll
    for (int a = 0; a < kRowsPerThread; ++a)
#pragma unroll
      for (int b = 0; b < kLinesPerThread; ++b) sc[a][b] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DK; d += 4) {
      float4 qv[kRowsPerThread], kv[kLinesPerThread];
#pragma unroll
      for (int a = 0; a < kRowsPerThread; ++a)
        qv[a] = *reinterpret_cast<const float4*>(sQ + (i0 + a) * L::kStrideK + d);
#pragma unroll
      for (int b = 0; b < kLinesPerThread; ++b)
        kv[b] = *reinterpret_cast<const float4*>(
            sK + (tx + kLanesPerRowGroup * b) * L::kStrideK + d);
#pragma unroll
      for (int a = 0; a < kRowsPerThread; ++a)
#pragma unroll
        for (int b = 0; b < kLinesPerThread; ++b) {
          float x = sc[a][b];
          x = fmaf(qv[a].x, kv[b].x, x);
          x = fmaf(qv[a].y, kv[b].y, x);
          x = fmaf(qv[a].z, kv[b].z, x);
          x = fmaf(qv[a].w, kv[b].w, x);
          sc[a][b] = x;
        }
    }

    // online softmax per own row; the row's 16 threads are 16
    // consecutive lanes of one warp
    float corr[kRowsPerThread];
#pragma unroll
    for (int a = 0; a < kRowsPerThread; ++a) {
      const uint8_t* mt = sM + (i0 + a) * kTile;
      float mx = m[a];
#pragma unroll
      for (int b = 0; b < kLinesPerThread; ++b) {
        if (!mt[tx + kLanesPerRowGroup * b]) sc[a][b] = kNegInf;
        mx = fmaxf(mx, sc[a][b]);
      }
#pragma unroll
      for (int off = kLanesPerRowGroup / 2; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      corr[a] = expf(m[a] - mx);
      float psum = 0.f;
      float* prow = sP + (i0 + a) * L::kStrideP;
#pragma unroll
      for (int b = 0; b < kLinesPerThread; ++b) {
        const int j = tx + kLanesPerRowGroup * b;
        const float p = mt[j] ? expf(sc[a][b] - mx) : 0.f;
        prow[j] = p;
        psum += p;
      }
#pragma unroll
      for (int off = kLanesPerRowGroup / 2; off > 0; off >>= 1)
        psum += __shfl_xor_sync(0xffffffffu, psum, off);
      l[a] = l[a] * corr[a] + psum;
      m[a] = mx;
    }
    __syncwarp();  // own rows' probabilities are written and read in-warp

    // PV: own rows x columns tx * 4 + e + 64 * hh
#pragma unroll
    for (int a = 0; a < kRowsPerThread; ++a)
#pragma unroll
      for (int e = 0; e < kCols; ++e) acc[a][e] *= corr[a];
#pragma unroll 4
    for (int j = 0; j < kTile; ++j) {
      float p[kRowsPerThread];
#pragma unroll
      for (int a = 0; a < kRowsPerThread; ++a) p[a] = sP[(i0 + a) * L::kStrideP + j];
#pragma unroll
      for (int hh = 0; hh < kCols / 4; ++hh) {
        const float4 vv = *reinterpret_cast<const float4*>(sV + j * DK + tx * 4 + 64 * hh);
#pragma unroll
        for (int a = 0; a < kRowsPerThread; ++a) {
          acc[a][4 * hh + 0] = fmaf(p[a], vv.x, acc[a][4 * hh + 0]);
          acc[a][4 * hh + 1] = fmaf(p[a], vv.y, acc[a][4 * hh + 1]);
          acc[a][4 * hh + 2] = fmaf(p[a], vv.z, acc[a][4 * hh + 2]);
          acc[a][4 * hh + 3] = fmaf(p[a], vv.w, acc[a][4 * hh + 3]);
        }
      }
    }
    __syncthreads();  // the next tile overwrites sK/sV/sP/sM
  }

#pragma unroll
  for (int a = 0; a < kRowsPerThread; ++a) {
    const int rr = row0 + i0 + a;
    if (rr >= rows) continue;
    const int c = rr / G, g = rr % G;
    const float inv = 1.f / fmaxf(l[a], kMinDenominator);
    T* o = out + (((size_t)r * C + c) * H + (size_t)h * G + g) * DK + tx * 4;
#pragma unroll
    for (int hh = 0; hh < kCols / 4; ++hh)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[64 * hh + e] = from_f32<T>(acc[a][4 * hh + e] * inv);
  }
}

// The mma design: rows [row0, row0 + 128) of KV head h of slot r, bf16
// q. Warp w owns rows row0 + 16 w .. + 15 (its Q fragments in registers
// for the whole walk). The words of up to 32 tiles for the block's rows
// are staged at once; the tiles any row attends stream through
// kMmaStages K/V buffers, two cp.async copies in flight while one tile is
// multiplied (one commit group a tile, one barrier a tile).
template <int DK>
struct VerifyMmaSmem {
  static constexpr int kLd = LdH<DK>::kRow;                  // bf16 row stride
  static constexpr size_t kTile = size_t(kTileLines) * kLd;  // bf16 elements of a K or V tile
  static constexpr size_t kKV = 2 * kMmaStages * kTile * sizeof(__nv_bfloat16);
  static constexpr size_t kBits = sizeof(uint64_t) * kMetaTiles * kMmaTileRows;
  static constexpr size_t kFlags = size_t(kMetaTiles) * (kMmaTileRows / 32);  // per tile, per warp
  static constexpr size_t kBytes = kKV + kBits + kFlags;
};

template <int DK>
__global__ void __launch_bounds__(kMmaTileThreads, 1)
verify_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v, const uint64_t* __restrict__ bits,
                  __nv_bfloat16* __restrict__ out, int C, int S1, int H, int KV,
                  float scale) {
  using bf16 = __nv_bfloat16;
  using L = VerifyMmaSmem<DK>;
  constexpr int LD = L::kLd;
  constexpr int kChunks = DK * 2 / 16;  // 16-byte copies of one line
  extern __shared__ __align__(16) unsigned char smem_mma[];
  bf16* sKV = reinterpret_cast<bf16*>(smem_mma);                      // [stage][K, V][64][LD]
  uint64_t* sBits = reinterpret_cast<uint64_t*>(smem_mma + L::kKV);   // [tile][row]
  uint8_t* sFlag = reinterpret_cast<uint8_t*>(sBits + kMetaTiles * kMmaTileRows);  // [tile][4]

  const int row0 = blockIdx.x * kMmaTileRows, h = blockIdx.y, r = blockIdx.z;
  const int G = H / KV, rows = C * G, W = (S1 + kTileLines - 1) / kTileLines;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int ra = row0 + 16 * warp + g, rb = ra + 8;  // this thread's rows

  // the warp's Q fragments, zero past the last row
  uint32_t qa[DK / 16][4];
  {
    auto at = [&](int i) -> const bf16* {
      return i < rows ? q + (((size_t)r * C + i / G) * H + (size_t)h * G + i % G) * DK + 2 * t
                      : nullptr;
    };
    const bf16* pa = at(ra);
    const bf16* pb = at(rb);
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
  const float kscale = scale * kLog2e;  // scores in base 2

  // copy the K/V lines of tile u into stage st (lines at or past S1 zero)
  auto issue = [&](int u, int st) {
    constexpr int kLinesPerPass = kMmaTileThreads / kChunks;
    const int c = tid % kChunks;
#pragma unroll
    for (int j = tid / kChunks; j < kTileLines; j += kLinesPerPass) {
      const int s = u * kTileLines + j;
      const size_t off = s < S1 ? (((size_t)r * S1 + s) * KV + h) * DK + 8 * c : 0;
      const int nbytes = s < S1 ? 16 : 0;
      const int lk = st * 2 * kTileLines + j, lv = lk + kTileLines;
      cp_async16(sKV + lk * LD + 8 * c, k + off, nbytes);
      cp_async16(sKV + lv * LD + 8 * c, v + off, nbytes);
    }
  };

  const uint64_t* bslot = bits + (size_t)r * C * W;
  for (int c0 = 0; c0 < W; c0 += kMetaTiles) {
    const int nct = min(kMetaTiles, W - c0);
    __syncthreads();  // the last chunk's words and flags are read
    // words of the chunk's tiles for the block's rows; a warp covers 32
    // rows of one tile
#pragma unroll 4
    for (int idx = tid; idx < nct * kMmaTileRows; idx += kMmaTileThreads) {
      const int tt = idx / kMmaTileRows, ii = idx % kMmaTileRows, i = row0 + ii;
      const uint64_t word = i < rows ? bslot[(size_t)(i / G) * W + c0 + tt] : 0ull;
      sBits[idx] = word;
      const bool any = __any_sync(0xffffffffu, word != 0ull);
      if (lane == 0) sFlag[tt * (kMmaTileRows / 32) + ii / 32] = any;
    }
    __syncthreads();
    uint32_t todo = 0;  // tiles any row of the block attends (block-uniform)
    for (int tt = 0; tt < nct; ++tt)
      todo |= uint32_t(reinterpret_cast<const uint32_t*>(sFlag)[tt] != 0u) << tt;

    uint32_t pend = todo;
    auto issue_next = [&](int st) {
      if (pend) {
        issue(c0 + __ffs(pend) - 1, st);
        pend &= pend - 1;
      }
      cp_async_commit();
    };
    issue_next(0);
    issue_next(1);
    for (int st = 0; todo; st = st + 1 == kMmaStages ? 0 : st + 1) {
      const int tt = __ffs(todo) - 1;
      todo &= todo - 1;
      cp_async_wait<kMmaStages - 2>();  // this tile's group has landed
      __syncthreads();  // ... for every thread, and every warp is done with the last tile
      issue_next(st == 0 ? kMmaStages - 1 : st - 1);  // into the last tile's buffer
      const bf16* sK = sKV + st * 2 * L::kTile;
      mma_warp_tile<DK, false>(
          qa, sK, sK + L::kTile, sBits[tt * kMmaTileRows + 16 * warp + g],
          sBits[tt * kMmaTileRows + 16 * warp + g + 8], lane,
          [&](int) { return kscale; }, [&](int) { return 1.f; }, o, m, l);
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    const int row = i ? rb : ra;
    if (row >= rows) continue;
    const float inv = 1.f / fmaxf(l[i], kMinDenominator);
    bf16* orow = out + (((size_t)r * C + row / G) * H + (size_t)h * G + row % G) * DK + 2 * t;
#pragma unroll
    for (int nt = 0; nt < DK / 8; ++nt)
      *reinterpret_cast<uint32_t*>(orow + nt * 8) =
          pack_bf16(o[nt][2 * i] * inv, o[nt][2 * i + 1] * inv);
  }
}

// The tf32x3 design: rows [row0, row0 + 128) of KV head h of slot r, f32
// q. The block's Q rows sit in shared memory (row stride dk + 4, split per
// k-step by tf32_warp_tile); warp w owns rows row0 + 16 w .. + 15. The
// words of kMeta tiles are staged at once; the tiles any row attends
// stream through kStages f32 K/V buffers, kStages - 1 cp.async copies in
// flight while one tile is multiplied.
template <int DK>
struct VerifyTf32Smem {
  static constexpr int kLd = DK + 4;                          // f32 row stride
  static constexpr size_t kTile = size_t(kTileLines) * kLd;   // floats of a K or V tile
  static constexpr size_t kPair = 2 * kTile * sizeof(float);
  static constexpr size_t kQ = size_t(kMmaTileRows) * kLd * sizeof(float);
  static constexpr size_t meta(int tiles) {  // words [tile][row], flags [tile][4]
    return sizeof(uint64_t) * tiles * kMmaTileRows + size_t(tiles) * (kMmaTileRows / 32);
  }
  static constexpr int kStages =
      kQ + kMmaStages * kPair + meta(kMetaTiles / 2) <= kMmaSmemBudget ? kMmaStages : 2;
  static constexpr int kMeta =
      kQ + kStages * kPair + meta(kMetaTiles) <= kMmaSmemBudget ? kMetaTiles : kMetaTiles / 2;
  static constexpr size_t kBytes = kStages * kPair + kQ + meta(kMeta);
  static_assert(kBytes <= kMmaSmemBudget, "tf32x3 verify tile over the shared-memory budget");
};

template <int DK>
__global__ void __launch_bounds__(kMmaTileThreads, 1)
verify_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, const uint64_t* __restrict__ bits,
                   float* __restrict__ out, int C, int S1, int H, int KV, float scale) {
  using L = VerifyTf32Smem<DK>;
  constexpr int LD = L::kLd, STAGES = L::kStages, META = L::kMeta;
  constexpr int kChunks = DK * 4 / 16;  // 16-byte copies of one line
  extern __shared__ __align__(16) unsigned char smem_tf32[];
  float* sKV = reinterpret_cast<float*>(smem_tf32);                  // [stage][K, V][64][LD]
  float* sQ = sKV + STAGES * 2 * L::kTile;                           // [128][LD]
  uint64_t* sBits = reinterpret_cast<uint64_t*>(sQ + kMmaTileRows * LD);  // [tile][row]
  uint8_t* sFlag = reinterpret_cast<uint8_t*>(sBits + META * kMmaTileRows);  // [tile][4]

  const int row0 = blockIdx.x * kMmaTileRows, h = blockIdx.y, r = blockIdx.z;
  const int G = H / KV, rows = C * G, W = (S1 + kTileLines - 1) / kTileLines;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int ra = row0 + 16 * warp + g, rb = ra + 8;  // this thread's rows

  // the block's Q rows, zero past the last (read after the barrier that
  // opens the first chunk)
  for (int idx = tid; idx < kMmaTileRows * DK / 4; idx += kMmaTileThreads) {
    const int ii = idx / (DK / 4), d = idx % (DK / 4) * 4, i = row0 + ii;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (i < rows)
      x = *reinterpret_cast<const float4*>(
          q + (((size_t)r * C + i / G) * H + (size_t)h * G + i % G) * DK + d);
    *reinterpret_cast<float4*>(sQ + ii * LD + d) = x;
  }
  float o[DK / 8][4], m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int nt = 0; nt < DK / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[nt][e] = 0.f;
  const float kscale = scale * kLog2e;  // scores in base 2

  // copy the K/V lines of tile u into stage st (lines at or past S1 zero)
  auto issue = [&](int u, int st) {
    constexpr int kLinesPerPass = kMmaTileThreads / kChunks;
    const int c = tid % kChunks;
#pragma unroll
    for (int j = tid / kChunks; j < kTileLines; j += kLinesPerPass) {
      const int s = u * kTileLines + j;
      const size_t off = s < S1 ? (((size_t)r * S1 + s) * KV + h) * DK + 4 * c : 0;
      const int nbytes = s < S1 ? 16 : 0;
      const int lk = st * 2 * kTileLines + j, lv = lk + kTileLines;
      cp_async16(sKV + lk * LD + 4 * c, k + off, nbytes);
      cp_async16(sKV + lv * LD + 4 * c, v + off, nbytes);
    }
  };

  const uint64_t* bslot = bits + (size_t)r * C * W;
  for (int c0 = 0; c0 < W; c0 += META) {
    const int nct = min(META, W - c0);
    __syncthreads();  // the last chunk's words and flags are read
#pragma unroll 4
    for (int idx = tid; idx < nct * kMmaTileRows; idx += kMmaTileThreads) {
      const int tt = idx / kMmaTileRows, ii = idx % kMmaTileRows, i = row0 + ii;
      const uint64_t word = i < rows ? bslot[(size_t)(i / G) * W + c0 + tt] : 0ull;
      sBits[idx] = word;
      const bool any = __any_sync(0xffffffffu, word != 0ull);
      if (lane == 0) sFlag[tt * (kMmaTileRows / 32) + ii / 32] = any;
    }
    __syncthreads();
    uint32_t todo = 0;  // tiles any row of the block attends (block-uniform)
    for (int tt = 0; tt < nct; ++tt)
      todo |= uint32_t(reinterpret_cast<const uint32_t*>(sFlag)[tt] != 0u) << tt;

    uint32_t pend = todo;
    auto issue_next = [&](int st) {
      if (pend) {
        issue(c0 + __ffs(pend) - 1, st);
        pend &= pend - 1;
      }
      cp_async_commit();
    };
#pragma unroll
    for (int st = 0; st + 1 < STAGES; ++st) issue_next(st);
    for (int st = 0; todo; st = st + 1 == STAGES ? 0 : st + 1) {
      const int tt = __ffs(todo) - 1;
      todo &= todo - 1;
      cp_async_wait<STAGES - 2>();  // this tile's group has landed
      __syncthreads();  // ... for every thread, and every warp is done with the last tile
      issue_next(st == 0 ? STAGES - 1 : st - 1);  // into the last tile's buffer
      const float* sK = sKV + st * 2 * L::kTile;
      tf32_warp_tile<DK, false>(
          sQ + 16 * warp * LD, sK, sK + L::kTile, sBits[tt * kMmaTileRows + 16 * warp + g],
          sBits[tt * kMmaTileRows + 16 * warp + g + 8], lane, [&](int) { return kscale; },
          [&](int) { return 1.f; }, o, m, l);
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    const int row = i ? rb : ra;
    if (row >= rows) continue;
    const float inv = 1.f / fmaxf(l[i], kMinDenominator);
    float* orow = out + (((size_t)r * C + row / G) * H + (size_t)h * G + row % G) * DK + 2 * t;
#pragma unroll
    for (int nt = 0; nt < DK / 8; ++nt)
      *reinterpret_cast<float2*>(orow + nt * 8) =
          make_float2(o[nt][2 * i] * inv, o[nt][2 * i + 1] * inv);
  }
}

template <typename T, int DK>
cudaError_t launch_dk(const void* q, const void* k, const void* v,
                      const uint64_t* bits, void* out, int R, int C, int S1,
                      int H, int KV, float scale, cudaStream_t stream) {
  constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
  const int rows = C * (H / KV);
  if constexpr (kBf16) {
    if (verify_design(rows, kBFloat16) == kVerifyMma) {
      using bf = __nv_bfloat16;
      constexpr size_t kSmem = VerifyMmaSmem<DK>::kBytes;
      cudaError_t err = cudaFuncSetAttribute(
          verify_mma_kernel<DK>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmem);
      if (err != cudaSuccess) return err;
      dim3 grid((rows + kMmaTileRows - 1) / kMmaTileRows, KV, R);
      verify_mma_kernel<DK><<<grid, kMmaTileThreads, kSmem, stream>>>(
          static_cast<const bf*>(q), static_cast<const bf*>(k), static_cast<const bf*>(v),
          bits, static_cast<bf*>(out), C, S1, H, KV, scale);
      return cudaGetLastError();
    }
  } else if (verify_design(rows, kFloat32) == kVerifyTf32x3) {
    constexpr size_t kSmem = VerifyTf32Smem<DK>::kBytes;
    cudaError_t err = cudaFuncSetAttribute(
        verify_tf32_kernel<DK>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmem);
    if (err != cudaSuccess) return err;
    dim3 grid((rows + kMmaTileRows - 1) / kMmaTileRows, KV, R);
    verify_tf32_kernel<DK><<<grid, kMmaTileThreads, kSmem, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), bits, static_cast<float*>(out), C, S1, H, KV, scale);
    return cudaGetLastError();
  }
  constexpr size_t kSmem = Smem<DK>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      verify_kernel<T, DK>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmem);
  if (err != cudaSuccess) return err;
  dim3 grid((rows + kRows - 1) / kRows, KV, R);
  verify_kernel<T, DK><<<grid, kThreads, kSmem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      bits, static_cast<T*>(out), C, S1, H, KV, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_t(const void* q, const void* k, const void* v,
                     const uint64_t* bits, void* out, int R, int C, int S1,
                     int H, int KV, int dk, float scale, cudaStream_t stream) {
  if (dk == 64) return launch_dk<T, 64>(q, k, v, bits, out, R, C, S1, H, KV, scale, stream);
  if (dk == 128) return launch_dk<T, 128>(q, k, v, bits, out, R, C, S1, H, KV, scale, stream);
  return cudaErrorInvalidValue;
}

}  // namespace
}  // namespace fft

extern "C" int verify_attention_launch(const void* q, const void* k,
                                       const void* v, const void* bits,
                                       void* out, int R, int C, int S1, int H,
                                       int KV, int dk, int dtype, float scale,
                                       void* stream) {
  if (R <= 0 || C <= 0 || S1 <= 0 || KV <= 0 || H % KV != 0)
    return (int)cudaErrorInvalidValue;
  const uint64_t* b = static_cast<const uint64_t*>(bits);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == fft::kBFloat16) {
    err = fft::launch_t<__nv_bfloat16>(q, k, v, b, out, R, C, S1, H, KV, dk, scale, s);
  } else if (dtype == fft::kFloat32) {
    err = fft::launch_t<float>(q, k, v, b, out, R, C, S1, H, KV, dk, scale, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return (int)err;
}

// The block design (VerifyDesign) the launcher takes for C query tokens
// per slot, H query and KV key/value heads and q of DType dtype.
extern "C" int verify_attention_design(int C, int H, int KV, int dtype) {
  return fft::verify_design(C * (H / KV), dtype);
}

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
