// The page-tile attention loop shared by ragged_paged_attention.cu and
// fused_rope_paged_attention.cu.
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
// Two block designs, chosen by the number of query rows per KV head:
//  * attend_decode (C * G <= 8: decode steps): one block of 8 warps per
//    (slot, KV head, up to 8 rows), the design of decode_attention.cu.
//    One page is one tile: the block loads the page's mask for its rows,
//    skips the page when no row attends any of its lines, else reads
//    the page id and scales once; warps split the page's lines, every
//    line is read once for all rows of the block.
//  * attend_tile (C * G > 8: mixed and prefill steps): one block of 128
//    threads per (slot, KV head, 32 rows), the register-blocked tiles of
//    verify_attention.cu over tiles of 64 virtual lines (half a 128-line
//    page, one 64-line page, or 2 or 4 smaller pages; their page ids and
//    scales are read once per tile). The tile's mask is loaded first and
//    the tile skipped, K/V unread, when no row of the block attends it.
//
// Pool and q pointers are read with plain loads (never the read-only
// cache): the fused kernel writes them earlier in the same launch.
#pragma once

#include "common.cuh"

namespace fft {

enum PoolKind : int { kPoolFloat = 0, kPoolInt8 = 1, kPoolInt4 = 2 };

constexpr int kMaxPageSize = 128;

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

template <int BYTES>
__device__ __forceinline__ void load_bytes(const uint8_t* p, uint8_t (&b)[BYTES]) {
  if constexpr (BYTES == 8) {
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    const uint8_t* t = reinterpret_cast<const uint8_t*>(&raw);
#pragma unroll
    for (int i = 0; i < 8; ++i) b[i] = t[i];
  } else if constexpr (BYTES == 4) {
    const uint32_t raw = *reinterpret_cast<const uint32_t*>(p);
    const uint8_t* t = reinterpret_cast<const uint8_t*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) b[i] = t[i];
  } else if constexpr (BYTES == 2) {
    const uint16_t raw = *reinterpret_cast<const uint16_t*>(p);
    b[0] = uint8_t(raw & 0xFF);
    b[1] = uint8_t(raw >> 8);
  } else {
#pragma unroll
    for (int i = 0; i < BYTES; ++i) b[i] = p[i];
  }
}

// N consecutive head dims [d0, d0 + N) of one (page, line, KV head) row
// of a pool, as f32 codes (values for a full-precision pool). d0 is a
// multiple of N, and for int4 the N dims lie in one half of the head.
template <typename TQ, int KIND, int DK, int N>
__device__ __forceinline__ void load_dims(const void* row, int d0, float (&o)[N]) {
  if constexpr (KIND == kPoolFloat) {
    load_f32<TQ, N>(static_cast<const TQ*>(row) + d0, o);
  } else if constexpr (KIND == kPoolInt8) {
    uint8_t b[N];
    load_bytes<N>(static_cast<const uint8_t*>(row) + d0, b);
#pragma unroll
    for (int i = 0; i < N; ++i) o[i] = float(int8_t(b[i]));
  } else {
    constexpr int kHalf = DK / 2;
    const bool high = d0 >= kHalf;
    uint8_t b[N];
    load_bytes<N>(static_cast<const uint8_t*>(row) + (high ? d0 - kHalf : d0), b);
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int nib = high ? (b[i] >> 4) & 0xF : b[i] & 0xF;
      o[i] = float(nib - 8);
    }
  }
}

// Element offset of (page, line, KV head) in a pool of row width DK / pack.
template <int KIND, int DK>
__device__ __forceinline__ size_t pool_row(int page, int line, int h, int ps, int KV) {
  return (((size_t)page * ps + line) * KV + h) * (DK / pack_of<KIND>());
}

template <typename TQ, int KIND>
__device__ __forceinline__ const void* pool_at(const void* pool, size_t off) {
  using T = typename PoolT<TQ, KIND>::T;
  return static_cast<const T*>(pool) + off;
}

// ---------------------------------------------------------------------------
// decode design

constexpr int kDecodeWarps = 8;
constexpr int kDecodeThreads = kDecodeWarps * 32;
constexpr int kDecodeLines = 4;   // lines per warp per iteration
constexpr int kDecodeRows = 8;    // most query rows per KV head of a block

// Rows [i0, i0 + GB) of KV head h of slot r. All kDecodeThreads threads
// of the block call it; it ends with a barrier, so it can be called
// again for the next rows.
template <typename TQ, int KIND, int DK, int GB>
__device__ void attend_decode(const PagedArgs& a, int r, int h, int i0) {
  constexpr int E = DK / 32;  // dims per lane
  __shared__ uint8_t sM[GB][kMaxPageSize];
  __shared__ float sm_m[kDecodeWarps][GB];
  __shared__ float sm_l[kDecodeWarps][GB];
  __shared__ float sm_acc[kDecodeWarps][GB][DK];

  const int G = a.H / a.KV;
  const int rows = a.C * G;
  const int gc = min(GB, rows - i0);
  const int S = a.NP * a.ps;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const TQ* q = static_cast<const TQ*>(a.q);

  float qr[GB][E], m[GB], l[GB], acc[GB][E];
#pragma unroll
  for (int g = 0; g < GB; ++g) {
    if (g < gc) {
      const int i = i0 + g, c = i / G, gg = i % G;
      load_f32<TQ, E>(q + (((size_t)r * a.C + c) * a.H + (size_t)h * G + gg) * DK + lane * E, qr[g]);
    } else {
#pragma unroll
      for (int e = 0; e < E; ++e) qr[g][e] = 0.f;
    }
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[g][e] = 0.f;
  }

  for (int p = 0; p < a.NP; ++p) {
    int any = 0;
    for (int idx = tid; idx < GB * a.ps; idx += kDecodeThreads) {
      const int g = idx / a.ps, j = idx % a.ps;
      uint8_t bit = 0;
      if (g < gc) {
        const int c = (i0 + g) / G;
        bit = a.mask[((size_t)r * a.C + c) * S + (size_t)p * a.ps + j] != 0;
      }
      sM[g][j] = bit;
      any |= bit;
    }
    // skip the page, table and K/V unread, when no row attends it (the
    // barrier at the end of a processed page protects sM from these writes)
    if (!__syncthreads_or(any)) continue;

    const int page = a.table[(size_t)r * a.NP + p];
    const float ksc = (KIND == kPoolFloat ? 1.f : a.k_scale[(size_t)page * a.KV + h]) * a.scale;
    const float vsc = KIND == kPoolFloat ? 1.f : a.v_scale[(size_t)page * a.KV + h];
    for (int j0 = warp * kDecodeLines; j0 < a.ps; j0 += kDecodeWarps * kDecodeLines) {
      float kr[kDecodeLines][E], vr[kDecodeLines][E];
#pragma unroll
      for (int u = 0; u < kDecodeLines; ++u) {
        if (j0 + u < a.ps) {
          const size_t off = pool_row<KIND, DK>(page, j0 + u, h, a.ps, a.KV);
          load_dims<TQ, KIND, DK, E>(pool_at<TQ, KIND>(a.k_pool, off), lane * E, kr[u]);
          load_dims<TQ, KIND, DK, E>(pool_at<TQ, KIND>(a.v_pool, off), lane * E, vr[u]);
        } else {
#pragma unroll
          for (int e = 0; e < E; ++e) kr[u][e] = vr[u][e] = 0.f;
        }
      }
#pragma unroll
      for (int g = 0; g < GB; ++g) {
        if (g >= gc) continue;  // block-uniform: the shuffles stay converged
        float sc[kDecodeLines];
        bool on[kDecodeLines];
        float mx = m[g];
#pragma unroll
        for (int u = 0; u < kDecodeLines; ++u) {
          float part = 0.f;
#pragma unroll
          for (int e = 0; e < E; ++e) part = fmaf(qr[g][e], kr[u][e], part);
          part = warp_sum(part) * ksc;
          on[u] = j0 + u < a.ps && sM[g][j0 + u];
          sc[u] = on[u] ? part : kNegInf;
          mx = fmaxf(mx, sc[u]);
        }
        const float corr = expf(m[g] - mx);
        float pw[kDecodeLines];
        float psum = 0.f;
#pragma unroll
        for (int u = 0; u < kDecodeLines; ++u) {
          const float pr = on[u] ? expf(sc[u] - mx) : 0.f;
          psum += pr;
          pw[u] = pr * vsc;
        }
        l[g] = l[g] * corr + psum;
        m[g] = mx;
#pragma unroll
        for (int e = 0; e < E; ++e) {
          float x = acc[g][e] * corr;
#pragma unroll
          for (int u = 0; u < kDecodeLines; ++u) x = fmaf(pw[u], vr[u][e], x);
          acc[g][e] = x;
        }
      }
    }
    __syncthreads();  // sM is rewritten for the next page
  }

  // merge the warps' partial softmax states
#pragma unroll
  for (int g = 0; g < GB; ++g) {
    if (lane == 0) {
      sm_m[warp][g] = m[g];
      sm_l[warp][g] = l[g];
    }
#pragma unroll
    for (int e = 0; e < E; ++e) sm_acc[warp][g][lane * E + e] = acc[g][e];
  }
  __syncthreads();
  TQ* out = static_cast<TQ*>(a.out);
  for (int idx = tid; idx < gc * DK; idx += kDecodeThreads) {
    const int g = idx / DK, d = idx % DK;
    float M = kNegInf;
#pragma unroll
    for (int w = 0; w < kDecodeWarps; ++w) M = fmaxf(M, sm_m[w][g]);
    float L = 0.f, O = 0.f;
#pragma unroll
    for (int w = 0; w < kDecodeWarps; ++w) {
      const float f = expf(sm_m[w][g] - M);
      L = fmaf(sm_l[w][g], f, L);
      O = fmaf(sm_acc[w][g][d], f, O);
    }
    const int i = i0 + g, c = i / G, gg = i % G;
    out[(((size_t)r * a.C + c) * a.H + (size_t)h * G + gg) * DK + d] =
        from_f32<TQ>(O / fmaxf(L, kMinDenominator));
  }
  __syncthreads();  // sm_* may be rewritten by the next call
}

// ---------------------------------------------------------------------------
// tile design

constexpr int kTileRows = 32;                // query rows per block
constexpr int kTileLines = 64;               // virtual lines per tile
constexpr int kTileThreads = 128;
constexpr int kRowGroup = 16;                // threads sharing 4 rows
constexpr int kRowsPerThread = kTileRows / (kTileThreads / kRowGroup);  // 4
constexpr int kLinesPerThread = kTileLines / kRowGroup;                 // 4
constexpr int kTilePages = kTileLines / 16;  // pages per tile at ps = 16
constexpr int kChunk = 8;                    // dims per staging load

template <int DK>
struct TileSmem {
  static constexpr int kStrideK = DK + 4;    // padded: conflict-free reads
  static constexpr int kStrideP = kTileLines + 4;
  static constexpr size_t kK = size_t(kTileLines) * kStrideK;
  static constexpr size_t kV = size_t(kTileLines) * DK;
  static constexpr size_t kQ = size_t(kTileRows) * kStrideK;
  static constexpr size_t kP = size_t(kTileRows) * kStrideP;
  static constexpr size_t kLine = 2 * size_t(kTileLines);   // per-line scales
  static constexpr size_t kPage = 3 * size_t(kTilePages);   // page id, scales
  static constexpr size_t kBytes = sizeof(float) * (kK + kV + kQ + kP + kLine + kPage)
                                   + size_t(kTileRows) * kTileLines;  // mask
};

// Rows [row0, row0 + 32) of KV head h of slot r; smem holds
// TileSmem<DK>::kBytes. All kTileThreads threads call it; it ends with a
// barrier.
template <typename TQ, int KIND, int DK>
__device__ void attend_tile(const PagedArgs& a, int r, int h, int row0, float* smem) {
  using L = TileSmem<DK>;
  constexpr int kCols = DK / kRowGroup;  // output columns per thread
  float* sK = smem;                // [64][DK + 4]
  float* sV = sK + L::kK;          // [64][DK]
  float* sQ = sV + L::kV;          // [32][DK + 4]
  float* sP = sQ + L::kQ;          // [32][64 + 4] probability * v_scale
  float* sLk = sP + L::kP;         // [64] line score factor k_scale * scale
  float* sLv = sLk + kTileLines;   // [64] line v_scale
  float* sPk = sLv + kTileLines;   // [kTilePages] per page of the tile
  float* sPv = sPk + kTilePages;
  int* sPid = reinterpret_cast<int*>(sPv + kTilePages);
  uint8_t* sM = reinterpret_cast<uint8_t*>(sPid + kTilePages);  // [32][64]

  const int G = a.H / a.KV;
  const int rows = a.C * G;
  const int S = a.NP * a.ps;
  const int tid = threadIdx.x;
  const int tx = tid % kRowGroup;                       // line / column group
  const int i0 = (tid / kRowGroup) * kRowsPerThread;    // first own row
  const int npt = a.ps >= kTileLines ? 1 : kTileLines / a.ps;  // pages per tile
  const TQ* q = static_cast<const TQ*>(a.q);

  for (int idx = tid; idx < kTileRows * DK; idx += kTileThreads) {
    const int ii = idx / DK, d = idx % DK, rr = row0 + ii;
    float x = 0.f;
    if (rr < rows) {
      const int c = rr / G, g = rr % G;
      x = to_f32<TQ>(q[(((size_t)r * a.C + c) * a.H + (size_t)h * G + g) * DK + d]);
    }
    sQ[ii * L::kStrideK + d] = x;
  }

  float m[kRowsPerThread], l[kRowsPerThread], acc[kRowsPerThread][kCols];
#pragma unroll
  for (int u = 0; u < kRowsPerThread; ++u) {
    m[u] = kNegInf;
    l[u] = 0.f;
#pragma unroll
    for (int e = 0; e < kCols; ++e) acc[u][e] = 0.f;
  }

  const uint8_t* mrow = a.mask + (size_t)r * a.C * S;
  for (int t0 = 0; t0 < S; t0 += kTileLines) {
    int any = 0;
    for (int idx = tid; idx < kTileRows * kTileLines; idx += kTileThreads) {
      const int ii = idx / kTileLines, j = idx % kTileLines;
      const int rr = row0 + ii, s = t0 + j;
      uint8_t bit = 0;
      if (rr < rows && s < S) bit = mrow[(size_t)(rr / G) * S + s] != 0;
      sM[idx] = bit;
      any |= bit;
    }
    if (tid < npt) {
      const int p = t0 / a.ps + tid;
      if (p < a.NP) {
        const int page = a.table[(size_t)r * a.NP + p];
        sPid[tid] = page;
        sPk[tid] = (KIND == kPoolFloat ? 1.f : a.k_scale[(size_t)page * a.KV + h]) * a.scale;
        sPv[tid] = KIND == kPoolFloat ? 1.f : a.v_scale[(size_t)page * a.KV + h];
      }
    }
    // skip the tile, K/V unread, when no row attends it (the barrier at
    // the end of a processed tile protects the buffers from these writes)
    if (!__syncthreads_or(any)) continue;

    for (int idx = tid; idx < kTileLines * (DK / kChunk); idx += kTileThreads) {
      const int j = idx / (DK / kChunk), d = (idx % (DK / kChunk)) * kChunk;
      const int s = t0 + j;
      float kx[kChunk], vx[kChunk];
      float lk = 0.f, lv = 0.f;
      if (s < S) {
        const int pi = a.ps >= kTileLines ? 0 : j / a.ps;
        const size_t off = pool_row<KIND, DK>(sPid[pi], s % a.ps, h, a.ps, a.KV);
        load_dims<TQ, KIND, DK, kChunk>(pool_at<TQ, KIND>(a.k_pool, off), d, kx);
        load_dims<TQ, KIND, DK, kChunk>(pool_at<TQ, KIND>(a.v_pool, off), d, vx);
        lk = sPk[pi];
        lv = sPv[pi];
      } else {
#pragma unroll
        for (int e = 0; e < kChunk; ++e) kx[e] = vx[e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < kChunk; e += 4) {
        *reinterpret_cast<float4*>(sK + j * L::kStrideK + d + e) =
            make_float4(kx[e], kx[e + 1], kx[e + 2], kx[e + 3]);
        *reinterpret_cast<float4*>(sV + j * DK + d + e) =
            make_float4(vx[e], vx[e + 1], vx[e + 2], vx[e + 3]);
      }
      if (d == 0) {
        sLk[j] = lk;
        sLv[j] = lv;
      }
    }
    __syncthreads();

    // scores of own rows i0 + u against lines tx + 16 b
    float sc[kRowsPerThread][kLinesPerThread];
#pragma unroll
    for (int u = 0; u < kRowsPerThread; ++u)
#pragma unroll
      for (int b = 0; b < kLinesPerThread; ++b) sc[u][b] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DK; d += 4) {
      float4 qv[kRowsPerThread], kv[kLinesPerThread];
#pragma unroll
      for (int u = 0; u < kRowsPerThread; ++u)
        qv[u] = *reinterpret_cast<const float4*>(sQ + (i0 + u) * L::kStrideK + d);
#pragma unroll
      for (int b = 0; b < kLinesPerThread; ++b)
        kv[b] = *reinterpret_cast<const float4*>(sK + (tx + kRowGroup * b) * L::kStrideK + d);
#pragma unroll
      for (int u = 0; u < kRowsPerThread; ++u)
#pragma unroll
        for (int b = 0; b < kLinesPerThread; ++b) {
          float x = sc[u][b];
          x = fmaf(qv[u].x, kv[b].x, x);
          x = fmaf(qv[u].y, kv[b].y, x);
          x = fmaf(qv[u].z, kv[b].z, x);
          x = fmaf(qv[u].w, kv[b].w, x);
          sc[u][b] = x;
        }
    }

    // online softmax per own row; the row's 16 threads are 16
    // consecutive lanes of one warp
    float corr[kRowsPerThread];
#pragma unroll
    for (int u = 0; u < kRowsPerThread; ++u) {
      const uint8_t* mt = sM + (i0 + u) * kTileLines;
      float mx = m[u];
#pragma unroll
      for (int b = 0; b < kLinesPerThread; ++b) {
        const int j = tx + kRowGroup * b;
        sc[u][b] = mt[j] ? sc[u][b] * sLk[j] : kNegInf;
        mx = fmaxf(mx, sc[u][b]);
      }
#pragma unroll
      for (int o = kRowGroup / 2; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      corr[u] = expf(m[u] - mx);
      float psum = 0.f;
      float* prow = sP + (i0 + u) * L::kStrideP;
#pragma unroll
      for (int b = 0; b < kLinesPerThread; ++b) {
        const int j = tx + kRowGroup * b;
        const float pr = mt[j] ? expf(sc[u][b] - mx) : 0.f;
        prow[j] = pr * sLv[j];
        psum += pr;
      }
#pragma unroll
      for (int o = kRowGroup / 2; o > 0; o >>= 1)
        psum += __shfl_xor_sync(0xffffffffu, psum, o);
      l[u] = l[u] * corr[u] + psum;
      m[u] = mx;
    }
    __syncwarp();  // own rows' probabilities are written and read in-warp

    // PV: own rows x columns tx * 4 + e + 64 * hh
#pragma unroll
    for (int u = 0; u < kRowsPerThread; ++u)
#pragma unroll
      for (int e = 0; e < kCols; ++e) acc[u][e] *= corr[u];
#pragma unroll 4
    for (int j = 0; j < kTileLines; ++j) {
      float pw[kRowsPerThread];
#pragma unroll
      for (int u = 0; u < kRowsPerThread; ++u) pw[u] = sP[(i0 + u) * L::kStrideP + j];
#pragma unroll
      for (int hh = 0; hh < kCols / 4; ++hh) {
        const float4 vv = *reinterpret_cast<const float4*>(sV + j * DK + tx * 4 + 64 * hh);
#pragma unroll
        for (int u = 0; u < kRowsPerThread; ++u) {
          acc[u][4 * hh + 0] = fmaf(pw[u], vv.x, acc[u][4 * hh + 0]);
          acc[u][4 * hh + 1] = fmaf(pw[u], vv.y, acc[u][4 * hh + 1]);
          acc[u][4 * hh + 2] = fmaf(pw[u], vv.z, acc[u][4 * hh + 2]);
          acc[u][4 * hh + 3] = fmaf(pw[u], vv.w, acc[u][4 * hh + 3]);
        }
      }
    }
    __syncthreads();  // the next tile overwrites the tile buffers
  }

  TQ* out = static_cast<TQ*>(a.out);
#pragma unroll
  for (int u = 0; u < kRowsPerThread; ++u) {
    const int rr = row0 + i0 + u;
    if (rr >= rows) continue;
    const int c = rr / G, g = rr % G;
    const float inv = 1.f / fmaxf(l[u], kMinDenominator);
    TQ* o = out + (((size_t)r * a.C + c) * a.H + (size_t)h * G + g) * DK + tx * 4;
#pragma unroll
    for (int hh = 0; hh < kCols / 4; ++hh)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[64 * hh + e] = from_f32<TQ>(acc[u][4 * hh + e] * inv);
  }
  __syncthreads();  // sQ may be rewritten by the next call
}

}  // namespace fft
