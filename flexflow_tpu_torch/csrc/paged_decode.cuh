// The one decode walk of the port: attend_split, the split design of
// every decode on the card (C * G <= 8 query rows a KV head) — the paged
// kernels' (ragged_paged_attention.cu, fused_rope_paged_attention.cu,
// design "decode"), the dense decode_attention.cu's and the whole-step
// kernel's attention stage (whole_step_decode.cu). A policy (PagedLines,
// DenseLines) says where a line lives and which lines a row attends.
//
// What bounds it on an H100: the bytes of the lines it attends. A decode
// step reads each attended K/V line once for the G rows of its KV head
// and does 4 G dk FLOP on it, far under the card's ratio of operations to
// bytes. The designs before this one (the whole step's row-at-a-time
// paged walk, the dense kernel's own loop) ran one block per (slot, KV
// head) over all of the slot's lines, a chain of loads and barriers, each lane reading dk / 32
// elements of a line: 7-79% of the byte bound on paged pools, the
// quantized pools (2-4 x fewer bytes) slower than bf16. Here:
//  * Split over the cache. The work unit is (slot, KV head, split), a
//    paged split being split_len consecutive whole pages, a dense one
//    split_len lines; the host sets split_len from the shapes alone
//    (kernels.paged_decode_split, kernels.dense_decode_split), at most
//    kSplitMaxSplits splits, and one split per (slot, KV head) when C > 1
//    (the new lines of a chunk may span pages of two splits). A dense
//    split past the slot's length exits before any load.
//  * The walk's inputs first. A paged block stages the mask bits and page ids of
//    up to kSplitChunk lines at once, behind one barrier, so every K/V
//    load of the walk depends on shared memory alone (the page scales
//    are read while the first loads are in flight). In the same round
//    trip every block scans its slot's mask row (L2 hits) for the splits
//    that attend a line: a split that attends none exits there, reading
//    no K/V line and writing nothing. A dense block stages nothing: the
//    prefix [0, seq_len) is its mask, the slot's own lines its addresses.
//  * Wide loads. A lane loads 16 bytes of a line (8 or 4 at G > 1 on
//    quantized pools, so that q and the accumulator of up to 8 rows stay
//    in registers): a dk-128 line is read by 16 lanes in bf16, 8 in int8,
//    4 in int4, and a warp has 2, 4 or 8 lines in each load instruction,
//    SplitGeom::kInFlight such loads of K and of V in flight a lane.
//    Codes are widened after the load with one byte permute and one f32
//    add each (2^23 + code, minus the bias), not one conversion each.
//    Scores reduce within the line's lanes; exponentials are base 2, the
//    softmax scale times log2(e) folded into the page's K scale.
//  * One merge. Each split writes its partial (m, l, acc) in f32 to a
//    workspace the wrapper keeps for the stream (the whole step: its
//    f32 scratch), indexed (unit, split, row). The last attended split of
//    a unit to finish (a counter it then resets to 0) merges the attended
//    partials in split order, so the output does not depend on which
//    block finished last, and writes the output. One launch does it all;
//    one split writes its output directly.
//  * Block size. The split kernels run blocks of 4 warps; the whole-step
//    kernel runs one item a block of its 8 warps (NW): more line groups
//    a split, the same walk.
// Measured (scripts/decode_split_probe.py, LLaMA-7B decode, 16 slots,
// NVIDIA H100 80GB HBM3 at 700 W): 77-86% of the byte bound on bf16 and
// f32 pools, 56% on int8; int4 and GQA (G = 4) sit at ~0.062 ms, 28-29%:
// there the per-line instructions (widening, the softmax, the lane
// reductions, G rows) and not the bytes bound the kernel.
//
// Invariants: two launches on the same inputs give the same bits (fixed
// line order in a lane group, butterfly merges, splits merged in split
// order, no float atomics); ragged and fused attend through this one
// function with one split rule, so the fused kernel stays bitwise the
// unfused path; a row with nothing to attend gives 0.
//
// The whole-step kernel's policy (PagedLines<true>) reads every K/V line,
// page scale and query row through L2: its other blocks commit them
// earlier in the same launch, and an SM's L1 is not kept coherent with
// other SMs' stores.
#pragma once

#include "paged_commit.cuh"  // rope8, and the fused kernel's commit

namespace fft {

constexpr int kSplitWarps = 4;
constexpr int kSplitThreads = kSplitWarps * 32;
constexpr int kSplitChunk = 256;                  // lines whose inputs a block stages at once
constexpr int kSplitWords = kSplitChunk / 64;     // mask words a row and chunk
constexpr int kSplitChunkPages = kSplitChunk / 16;
constexpr int kSplitMaxSplits = 64;               // splits a (slot, KV head) at most

// Where a split decode launch keeps its partials: ws holds acc (units,
// nsplit, rows, DK) f32, then (m, l) (units, nsplit, rows, 2), a unit
// being a (slot, KV head) of the paged walks and a (slot, KV head, head
// group) of the dense one; counters (units,) int32 are 0 before the
// launch and after it. Both are null when nsplit is 1.
struct SplitArgs {
  float* ws;
  int* counters;
  int split_len;  // pages a split (paged), lines a split (dense)
  int nsplit;     // splits a unit: ceil(NP / split_len), ceil(S1 / split_len)
};

// The most head dims a lane holds for one query row. 8-dim lanes, for
// more blocks an SM, took int8 from 0.076 to 0.094 ms (LLaMA-7B decode,
// 16 slots, 256-line splits, NVIDIA H100 80GB HBM3 at 700 W,
// scripts/decode_split_probe.py); 16 were no faster than 32.
constexpr int kSplitDims1 = 32;
// The bytes of K (and as many of V) a lane has in flight. Twice as many
// took bf16 from 0.104 to 0.113 ms and int8 from 0.076 to 0.087 (same
// probe).
constexpr int kSplitBytes = 64;
// blocks an SM must hold, for __launch_bounds__: at one row 5 (96
// registers a thread: 0.095 against 0.098 ms at bf16, 0.066 against 0.071
// at int8, 256-line splits, scripts/decode_split_probe.py), 3 on int4
// pools (168: at 128 the dk-64 instantiation spills); 2 above (255;
// ptxas's own choice spilled)
constexpr int kSplitMinBlocks1 = 5;

template <int KIND, int GB>
constexpr int kSplitMinBlocks = GB != 1 ? 2 : KIND == kPoolInt4 ? 3 : kSplitMinBlocks1;

// A lane's share of a line: kLoad bytes (one vector load), kDims head
// dims, kLanes lanes a line, kGroups lines a warp loads at once. q and the
// accumulator of GB rows take 2 GB kDims registers, at most 2 DIMS1 at
// GB = 1 (kSplitDims1 but in the whole-step kernel) and 128 above.
template <typename TQ, int KIND, int DK, int GB, int DIMS1 = kSplitDims1>
struct SplitGeom {
  static constexpr int kMaxDims = GB == 1 ? DIMS1 : 8;
  static constexpr int kRowBytes = KIND == kPoolFloat ? DK * int(sizeof(TQ)) : DK / pack_of<KIND>();
  static constexpr int kLoad = KIND == kPoolFloat  ? 16
                               : KIND == kPoolInt8 ? (kMaxDims < 16 ? kMaxDims : 16)
                                                   : (kMaxDims / 2 < 16 ? kMaxDims / 2 : 16);
  static constexpr int kWords = kLoad / 4;
  static constexpr int kDims = KIND == kPoolFloat  ? kLoad / int(sizeof(TQ))
                               : KIND == kPoolInt8 ? kLoad
                                                   : 2 * kLoad;
  static constexpr int kLanes = kRowBytes / kLoad;
  static constexpr int kGroups = 32 / kLanes;
  // lines a lane group loads before it computes
  static constexpr int kInFlight = kSplitBytes / kLoad < (GB == 8 ? 2 : 4)
                                       ? kSplitBytes / kLoad
                                       : (GB == 8 ? 2 : 4);
  static_assert(kRowBytes % kLoad == 0 && kLanes >= 1 && kLanes <= 32, "line split");
  static_assert(kDims <= kMaxDims || KIND == kPoolFloat, "dims a lane");

  // head dim of element e of lane sub's share (int4: the low nibbles are
  // dims sub * kLoad.., the high ones DK / 2 + sub * kLoad..)
  __device__ static __forceinline__ int dim(int sub, int e) {
    if constexpr (KIND == kPoolInt4) {
      return e < kLoad ? sub * kLoad + e : DK / 2 + sub * kLoad + (e - kLoad);
    } else {
      return sub * kDims + e;
    }
  }
};

// W words at p, with plain loads or (L2) through L2 alone.
template <int W, bool L2>
__device__ __forceinline__ void load_words(const uint8_t* p, uint32_t (&w)[W]) {
  if constexpr (W == 4) {
    const uint4 v = L2 ? __ldcg(reinterpret_cast<const uint4*>(p))
                       : *reinterpret_cast<const uint4*>(p);
    w[0] = v.x, w[1] = v.y, w[2] = v.z, w[3] = v.w;
  } else if constexpr (W == 2) {
    const uint2 v = L2 ? __ldcg(reinterpret_cast<const uint2*>(p))
                       : *reinterpret_cast<const uint2*>(p);
    w[0] = v.x, w[1] = v.y;
  } else {
    w[0] = L2 ? __ldcg(reinterpret_cast<const unsigned*>(p))
              : *reinterpret_cast<const uint32_t*>(p);
  }
}

template <bool L2>
__device__ __forceinline__ float load_f32_at(const float* p) {
  return L2 ? __ldcg(p) : *p;
}

// The f32 values (codes for quantized pools, exact) of W words of a line,
// in SplitGeom::dim order.
template <typename TQ, int KIND, int W, int N>
__device__ __forceinline__ void widen_words(const uint32_t (&w)[W], float (&x)[N]) {
  if constexpr (KIND == kPoolFloat && std::is_same<TQ, float>::value) {
#pragma unroll
    for (int i = 0; i < W; ++i) x[i] = __uint_as_float(w[i]);
  } else if constexpr (KIND == kPoolFloat) {  // bf16: element 2 i is the low half
#pragma unroll
    for (int i = 0; i < W; ++i) {
      x[2 * i] = __uint_as_float(w[i] << 16);
      x[2 * i + 1] = __uint_as_float(w[i] & 0xFFFF0000u);
    }
  } else if constexpr (KIND == kPoolInt8) {
    // byte b of (w ^ 0x80) is code + 128: 0x4B0000bb is 2^23 + code + 128
#pragma unroll
    for (int i = 0; i < W; ++i) {
      const uint32_t u = w[i] ^ 0x80808080u;
#pragma unroll
      for (int k = 0; k < 4; ++k)
        x[4 * i + k] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540u + k)) - 8388736.f;
    }
  } else {  // int4: nibbles biased by 8, low ones first
#pragma unroll
    for (int i = 0; i < W; ++i) {
      const uint32_t lo = w[i] & 0x0F0F0F0Fu, hi = (w[i] >> 4) & 0x0F0F0F0Fu;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        x[4 * i + k] = __uint_as_float(__byte_perm(lo, 0x4B000000u, 0x7540u + k)) - 8388616.f;
        x[N / 2 + 4 * i + k] =
            __uint_as_float(__byte_perm(hi, 0x4B000000u, 0x7540u + k)) - 8388616.f;
      }
    }
  }
}

// Query rows i < C * G of KV head h of slot r into sQ (GB * DK, TQ): row
// i is token c = i / G, query head h G + i % G. With cos / sin (R, C, rot)
// rotate-half RoPE as rope8 rounds it (the fused kernel; the ragged
// kernel passes null and copies). No barrier.
template <typename TQ, int DK>
__device__ __forceinline__ void stage_q(const PagedArgs& a, int r, int h, const TQ* q,
                                        const float* cos, const float* sin, int rot, TQ* sQ) {
  const int G = a.H / a.KV, rows = a.C * G;
  constexpr int V = DK / 8;
  for (int idx = threadIdx.x; idx < rows * V; idx += blockDim.x) {
    const int i = idx / V, d0 = idx % V * 8, c = i / G;
    const size_t rc = (size_t)r * a.C + c;
    const float* cs = cos ? cos + rc * rot : nullptr;
    const float* sn = sin ? sin + rc * rot : nullptr;
    rope8<TQ>(q + (rc * a.H + (size_t)h * G + i % G) * DK, sQ + i * DK, d0, cs, sn, rot);
  }
}

// Where the lines of a split walk live and which of them its rows
// attend: the policy of attend_split.
//
// PagedLines: rows [i0, i0 + n) of KV head h of slot r of the paged
// kernels (all C * G of them; the whole-step kernel walks one at a time).
// Line s of the slot's virtual cache lives at line s % ps of page
// table[r, s / ps]; row i (token i / G, query head h G + i % G) attends
// line s where its mask bit is set. A chunk's mask words and page ids are
// staged in shared memory before its lines are read. A unit is (slot, KV
// head, n rows). L2: every K/V, scale and query read goes through L2
// (ld.global.cg), for the whole-step kernel, whose other blocks commit
// those bytes earlier in the same launch.
template <bool L2>
struct PagedLines {
  static constexpr bool kPaged = true;
  static constexpr bool kL2 = L2;
  PagedArgs a;
  int r, h, i0, n;
  __device__ int row0() const { return i0; }
  __device__ int rows() const { return n; }
  __device__ int ws_rows() const { return n; }
  __device__ size_t unit() const {
    return ((size_t)r * a.KV + h) * (a.C * (a.H / a.KV) / n) + i0 / n;
  }
  __device__ size_t units() const { return (size_t)a.R * a.KV * (a.C * (a.H / a.KV) / n); }
  __device__ void* out() const { return a.out; }
  __device__ size_t out_row(int i) const {
    const int G = a.H / a.KV;
    return ((size_t)r * a.C + (i0 + i) / G) * a.H + (size_t)h * G + (i0 + i) % G;
  }
};

// DenseLines: up to kDecodeRows query heads of one KV head of slot r of a
// dense cache (R, S1, KV, dk), one query token a slot (decode_attention.cu).
// Line s is the slot's own line s; every row attends the prefix [0, len).
// Nothing is staged: a line's address and whether it is attended follow
// from its index.
struct DenseLines {
  static constexpr bool kPaged = false;
  static constexpr bool kL2 = false;
  const uint8_t* k;   // line 0 of the slot, at the KV head
  const uint8_t* v;
  size_t line_bytes;  // from one line to the next
  void* o;            // output (R, H, dk)
  size_t orow;        // output row of query row 0
  size_t unit_, units_;
  int rows_, ws_rows_, len;
  float kscale;       // the softmax scale times log2(e)
  __device__ int row0() const { return 0; }
  __device__ int rows() const { return rows_; }
  __device__ int ws_rows() const { return ws_rows_; }
  __device__ size_t unit() const { return unit_; }
  __device__ size_t units() const { return units_; }
  __device__ void* out() const { return o; }
  __device__ size_t out_row(int i) const { return orow + i; }
};

// The walk's block-wide scratch. The split kernels keep it in static shared
// memory; the whole-step kernel in its dynamic shared memory, which its
// attention stage leaves free. A paged walk also stages each chunk's mask
// words, page ids and page scales there; a dense walk stages nothing.
template <bool PAGED>
struct SplitStage {};
template <>
struct SplitStage<true> {
  uint64_t bits[kDecodeRows][kSplitWords];  // [token][word]: C <= 8
  uint64_t any[kSplitWords];                // lines any row attends
  int pid[kSplitChunkPages];
  float pk[kSplitChunkPages], pv[kSplitChunkPages];
};
template <int DK, int GB, int NW, bool PAGED>
struct SplitSmem : SplitStage<PAGED> {
  unsigned long long scan[NW];  // splits each warp saw attend a line
  float m[NW][GB], l[NW][GB];
  float acc[NW][GB][DK];
  float ml[kSplitMaxSplits * GB * 2];  // the merge's (m, l) of every split
  int last;
};

// Split ``split`` of one unit of ln (a (slot, KV head) of the paged
// kernels, a (slot, KV head, head group) of the dense one), all its
// ln.rows() <= GB rows, q in sQ (staged before this is called: the walk's
// first barrier publishes it). All NW * 32 threads of the block call it,
// and it ends without a barrier. With one split it writes the output;
// else the partial, and the last block of the unit merges every split's
// partial into the output.
template <typename TQ, int KIND, int DK, int GB, int NW, int DIMS1 = kSplitDims1, class Lines>
__device__ void attend_split(const Lines& ln, const SplitArgs& sp, int split, const TQ* sQ,
                             SplitSmem<DK, GB, NW, Lines::kPaged>& sm) {
  using Geo = SplitGeom<TQ, KIND, DK, GB, DIMS1>;
  using PT = typename PoolT<TQ, KIND>::T;
  constexpr int kThreads = NW * 32;
  constexpr int ND = Geo::kDims, LB = Geo::kLoad, W = Geo::kWords, LPL = Geo::kLanes;
  constexpr int U = Geo::kInFlight, NG = NW * Geo::kGroups;  // line groups a block
  constexpr bool kPaged = Lines::kPaged;

  const int rows = ln.rows(), wr = ln.ws_rows();
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int sub = lane % LPL, gi = warp * Geo::kGroups + lane / LPL;
  TQ* const out = static_cast<TQ*>(ln.out());
  auto out_at = [&](int i) { return out + ln.out_row(i) * DK; };
  auto zeros = [&]() {
    for (int idx = tid; idx < rows * DK; idx += kThreads)
      out_at(idx / DK)[idx % DK] = from_f32<TQ>(0.f);
  };

  float qr[GB][ND], m[GB], l[GB], acc[GB][ND];
#pragma unroll
  for (int g = 0; g < GB; ++g) {
#pragma unroll
    for (int e = 0; e < ND; ++e) acc[g][e] = 0.f;
    m[g] = kNegInf;
    l[g] = 0.f;
  }

  // The split's lines [s0, s1), walked in chunks of ``chunk`` lines (a
  // dense split is one chunk), and ``live``: bit s set when split s
  // attends a line (with several splits; block-uniform once known).
  int s0, s1, chunk;
  unsigned long long live = 0ull;
  const uint8_t* kb;
  const uint8_t* vb;
  // paged: the slot's geometry, read once
  int G = 1, KV = 1, C = 1, S = 0, ps = 1, ps_log = 0;
  const uint8_t* mslot = nullptr;
  if constexpr (kPaged) {
    const PagedArgs& a = ln.a;
    G = a.H / a.KV, KV = a.KV, C = a.C, S = a.NP * a.ps, ps = a.ps, ps_log = __ffs(ps) - 1;
    mslot = a.mask + (size_t)ln.r * C * S;
    s0 = split * sp.split_len * ps;
    s1 = min(S, s0 + sp.split_len * ps);
    chunk = kSplitChunk;
    kb = static_cast<const uint8_t*>(a.k_pool);
    vb = static_cast<const uint8_t*>(a.v_pool);
    // With several splits (C == 1) every block also scans the slot's whole
    // mask row, in the round trip of its first staging. A split that
    // attends nothing exits after that round trip; the rest count
    // themselves for the merge.
    if (sp.nsplit > 1) {
      const int split_lines = sp.split_len * ps;
      unsigned long long mine = 0ull;
      for (int w = tid; w < S / 16; w += kThreads) {
        const uint4 x = *reinterpret_cast<const uint4*>(mslot + 16 * w);
        if (x.x | x.y | x.z | x.w) mine |= 1ull << (16 * w / split_lines);
      }
      const unsigned lo = __reduce_or_sync(0xffffffffu, unsigned(mine));
      const unsigned hi = __reduce_or_sync(0xffffffffu, unsigned(mine >> 32));
      if (lane == 0) sm.scan[warp] = (unsigned long long)hi << 32 | lo;
    }
  } else {
    // the attended splits are the first ceil(len / split_len): one past
    // them exits before any load
    const int n = ln.len > 0 ? (ln.len + sp.split_len - 1) / sp.split_len : 0;
    if (split >= n) {
      if (n == 0 && split == 0) zeros();
      return;
    }
    live = n >= 64 ? ~0ull : (1ull << n) - 1;
    s0 = split * sp.split_len;
    s1 = min(ln.len, s0 + sp.split_len);
    chunk = s1 - s0;
    kb = ln.k;
    vb = ln.v;
    __syncthreads();  // sQ
  }

  // Paged: per chunk one barrier before the walk, the mask words and page
  // ids read together (and, at the first chunk, sQ, staged by the
  // caller); the page scales are read while the first lines' loads are in
  // flight.
  bool attended = false;  // block-uniform: some row attends a line of the split
  const bool one_token = C == 1;
  for (int cs = s0; cs < s1; cs += chunk) {
    const int n = min(chunk, s1 - cs);  // lines of the chunk (paged: a multiple of 16)
    if constexpr (kPaged) {
      if (cs != s0) __syncthreads();  // the last chunk's inputs are read
      if (tid < kSplitWords) {
        uint64_t any = 0;
        for (int c = 0; c < C; ++c) {
          const uint64_t b = 64 * tid < n ? mask_bits(mslot + (size_t)c * S, cs + 64 * tid, cs + n)
                                          : 0ull;
          sm.bits[c][tid] = b;
          any |= b;
        }
        sm.any[tid] = any;
      } else if (warp == 1 && lane < (n >> ps_log)) {
        sm.pid[lane] = ln.a.table[(size_t)ln.r * ln.a.NP + (cs >> ps_log) + lane];
      }
      __syncthreads();
      if (cs == s0 && sp.nsplit > 1) {
#pragma unroll
        for (int w = 0; w < NW; ++w) live |= sm.scan[w];
        if (!((live >> split) & 1ull)) {  // block-uniform: nothing to attend here
          if (live == 0ull && split == 0) zeros();  // nor anywhere
          return;
        }
      }
      bool any = false;
#pragma unroll
      for (int w = 0; w < kSplitWords; ++w) any |= sm.any[w] != 0ull;
      if (!any) continue;  // block-uniform: no K/V line of the chunk is read
    }
    if (!attended) {  // q, for the first attended chunk
#pragma unroll
      for (int g = 0; g < GB; ++g)
#pragma unroll
        for (int e = 0; e < ND; ++e)
          qr[g][e] = g < rows ? to_f32<TQ>(sQ[g * DK + Geo::dim(sub, e)]) : 0.f;
    }
    attended = true;

    for (int j0 = 0; j0 < n; j0 += NG * U) {
      uint32_t kw[U][W], vw[U][W];
      bool on[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int j = j0 + u * NG + gi;
        if constexpr (kPaged) {
          on[u] = j < n && ((sm.any[j >> 6] >> (j & 63)) & 1ull);
        } else {
          on[u] = j < n;
        }
        if (on[u]) {
          size_t off;
          if constexpr (kPaged) {
            off = pool_row<KIND, DK>(sm.pid[j >> ps_log], j & (ps - 1), ln.h, ps, KV) *
                      sizeof(PT) +
                  size_t(sub) * LB;
          } else {
            off = size_t(cs + j) * ln.line_bytes + size_t(sub) * LB;
          }
          load_words<W, Lines::kL2>(kb + off, kw[u]);
          load_words<W, Lines::kL2>(vb + off, vw[u]);
        } else {
#pragma unroll
          for (int i = 0; i < W; ++i) kw[u][i] = vw[u][i] = 0u;
        }
      }
      if constexpr (kPaged) {
        if (j0 == 0) {  // block-uniform: the chunk's page scales
          const PagedArgs& a = ln.a;
          if (warp == 1 && lane < (n >> ps_log)) {
            const int page = sm.pid[lane];
            // scores in base 2: dot * (k_scale * scale) * log2(e), then exp2
            sm.pk[lane] = (KIND == kPoolFloat ? 1.f : load_f32_at<Lines::kL2>(
                                                          a.k_scale + (size_t)page * a.KV + ln.h)) *
                          a.scale * kLog2e;
            sm.pv[lane] = KIND == kPoolFloat
                              ? 1.f
                              : load_f32_at<Lines::kL2>(a.v_scale + (size_t)page * a.KV + ln.h);
          }
          __syncthreads();
        }
      }
      bool some = false;
#pragma unroll
      for (int u = 0; u < U; ++u) some |= on[u];
      if (!__any_sync(0xffffffffu, some)) continue;  // warp-uniform

      // partial dots of each row with each line, then summed over the
      // line's lanes (xor offsets below LPL stay inside the lane group)
      float dot[GB][U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        float kx[ND];
        widen_words<TQ, KIND, W, ND>(kw[u], kx);
#pragma unroll
        for (int g = 0; g < GB; ++g) {
          float p = 0.f;
#pragma unroll
          for (int e = 0; e < ND; ++e) p = fmaf(qr[g][e], kx[e], p);
          dot[g][u] = p;
        }
      }
#pragma unroll
      for (int o = LPL / 2; o > 0; o /= 2)
#pragma unroll
        for (int g = 0; g < GB; ++g) {
          if (g >= rows) continue;  // block-uniform
#pragma unroll
          for (int u = 0; u < U; ++u) dot[g][u] += __shfl_xor_sync(0xffffffffu, dot[g][u], o);
        }

      // online softmax over the U lines (base 2), then the V lines; with
      // one token every row's mask is the lines' ``on``
      float wgt[GB][U];
      bool onr[GB][U];
#pragma unroll
      for (int g = 0; g < GB; ++g) {
        if (g >= rows) continue;
        const uint64_t* bits = nullptr;
        if constexpr (kPaged) bits = sm.bits[(ln.row0() + g) / G];
        float sc[U], mx = m[g];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int j = j0 + u * NG + gi;
          if constexpr (kPaged) {
            onr[g][u] = on[u] && (one_token || ((bits[j >> 6] >> (j & 63)) & 1ull));
            sc[u] = onr[g][u] ? dot[g][u] * sm.pk[j >> ps_log] : kNegInf;
          } else {
            onr[g][u] = on[u];
            sc[u] = onr[g][u] ? dot[g][u] * ln.kscale : kNegInf;
          }
          mx = fmaxf(mx, sc[u]);
        }
        const float corr = exp2_ftz(m[g] - mx);
        m[g] = mx;
        float psum = 0.f;
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const float p = onr[g][u] ? exp2_ftz(sc[u] - mx) : 0.f;
          psum += p;
          if constexpr (KIND == kPoolFloat) {
            wgt[g][u] = p;
          } else {
            wgt[g][u] = p * sm.pv[(j0 + u * NG + gi) >> ps_log];
          }
        }
        l[g] = l[g] * corr + psum;
#pragma unroll
        for (int e = 0; e < ND; ++e) acc[g][e] *= corr;
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        float vx[ND];
        widen_words<TQ, KIND, W, ND>(vw[u], vx);
#pragma unroll
        for (int g = 0; g < GB; ++g) {
          if (g >= rows) continue;
          // a line another row attends may hold anything (the scratch page)
          if (onr[g][u]) {
#pragma unroll
            for (int e = 0; e < ND; ++e) acc[g][e] = fmaf(wgt[g][u], vx[e], acc[g][e]);
          }
        }
      }
    }
  }

  // (m, l) partials after the acc ones, wr rows a partial; none with one
  // split
  float* const ml0 = sp.nsplit > 1 ? sp.ws + ln.units() * sp.nsplit * wr * DK : nullptr;
  const size_t part = ln.unit() * sp.nsplit + split;
  if (!attended) {  // one split (several: returned above): zeros
    zeros();
  } else {
    // merge the warp's lane groups (butterfly over the groups), then the
    // warps in shared memory
#pragma unroll
    for (int o = LPL; o < 32; o *= 2)
#pragma unroll
      for (int g = 0; g < GB; ++g) {
        if (g >= rows) continue;
        const float mo = __shfl_xor_sync(0xffffffffu, m[g], o);
        const float lo = __shfl_xor_sync(0xffffffffu, l[g], o);
        const float M = fmaxf(m[g], mo), fa = exp2_ftz(m[g] - M), fb = exp2_ftz(mo - M);
        l[g] = l[g] * fa + lo * fb;
#pragma unroll
        for (int e = 0; e < ND; ++e)
          acc[g][e] = acc[g][e] * fa + __shfl_xor_sync(0xffffffffu, acc[g][e], o) * fb;
        m[g] = M;
      }
    if (lane < LPL) {
#pragma unroll
      for (int g = 0; g < GB; ++g) {
        if (g >= rows) continue;
#pragma unroll
        for (int e = 0; e < ND; ++e) sm.acc[warp][g][Geo::dim(lane, e)] = acc[g][e];
        if (lane == 0) {
          sm.m[warp][g] = m[g];
          sm.l[warp][g] = l[g];
        }
      }
    }
    __syncthreads();
    float* const acc0 = sp.nsplit > 1 ? sp.ws + part * wr * DK : nullptr;
    for (int idx = tid; idx < rows * DK; idx += kThreads) {
      const int g = idx / DK, d = idx % DK;
      float M = kNegInf;
#pragma unroll
      for (int w = 0; w < NW; ++w) M = fmaxf(M, sm.m[w][g]);
      float L = 0.f, O = 0.f;
#pragma unroll
      for (int w = 0; w < NW; ++w) {
        const float f = exp2_ftz(sm.m[w][g] - M);
        L = fmaf(sm.l[w][g], f, L);
        O = fmaf(sm.acc[w][g][d], f, O);
      }
      if (sp.nsplit == 1) {
        out_at(g)[d] = from_f32<TQ>(O / fmaxf(L, kMinDenominator));
      } else {
        acc0[idx] = O;
        if (d == 0) {
          ml0[(part * wr + g) * 2] = M;
          ml0[(part * wr + g) * 2 + 1] = L;
        }
      }
    }
  }
  if (sp.nsplit == 1) return;

  // The last of the splits in ``live`` to get here merges them in split
  // order: the barrier orders the block's partial before thread 0's
  // fence, which orders it before the count.
  __syncthreads();
  if (tid == 0) {
    __threadfence();
    sm.last = atomicAdd(sp.counters + ln.unit(), 1) == __popcll(live) - 1;
  }
  __syncthreads();
  if (!sm.last) return;
  __threadfence();
  const size_t first = ln.unit() * sp.nsplit;
  for (int i = tid; i < sp.nsplit * wr * 2; i += kThreads)
    if ((live >> (i / (2 * wr))) & 1ull) sm.ml[i] = __ldcg(ml0 + first * wr * 2 + i);
  __syncthreads();
  for (int idx = tid; idx < rows * DK; idx += kThreads) {
    const int g = idx / DK;
    float M = kNegInf;
    for (int s = 0; s < sp.nsplit; ++s)
      if ((live >> s) & 1ull) M = fmaxf(M, sm.ml[(s * wr + g) * 2]);
    float L = 0.f, O = 0.f;
#pragma unroll 4
    for (int s = 0; s < sp.nsplit; ++s) {
      if (!((live >> s) & 1ull)) continue;  // wrote no partial
      const float f = exp2_ftz(sm.ml[(s * wr + g) * 2] - M);
      L = fmaf(sm.ml[(s * wr + g) * 2 + 1], f, L);
      O = fmaf(__ldcg(sp.ws + (first + s) * wr * DK + idx), f, O);
    }
    out_at(g)[idx % DK] = from_f32<TQ>(O / fmaxf(L, kMinDenominator));
  }
  if (tid == 0) sp.counters[ln.unit()] = 0;
}

}  // namespace fft
