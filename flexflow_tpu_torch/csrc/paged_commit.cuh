// The commit of new K/V lines into their pages, shared by paged_commit.cu,
// fused_rope_paged_attention.cu and whole_step_decode.cu: rotate-half
// RoPE of q and the new K lines, then the in-place write of the new lines
// (a scatter on full-precision pools, the arithmetic of
// kv_quant.quant_line_write on quantized ones).
//
// Pages are slot-private: a KV head's slice of a page (its bytes and its
// scale) is touched by the lines of one slot alone. The scratch page
// (CommitArgs::scratch), where every padding line points, is not written:
// a line on it is not committed, so no block writes a page another block
// reads, and an idle slot costs no commit work.
//
// quant_line_write, restricted to the pages the lines touch: offset-0
// scale reset, running amax scale, codes of a page whose scale grew
// requantized by rint(code * old / new), new lines quantized by
// rint(v / max(s, 1e-30)) clipped to +-qmax. IEEE division and
// round-half-to-even, so pool bytes and scales are bitwise those of the
// plain version. A page's new scale is the amax over all of its lines in
// the step, wherever they sit in the chunk: max over lines of
// fl(amax / qmax) is fl(max amax / qmax), since IEEE division is monotone,
// so the page maximum is taken on the amaxes' bits (non-negative floats
// order as unsigned integers: exact and order-free).
//
// Two forms, both without the serial per-page chain of a block walking
// the pages one after another:
//  * commit_line_warp (the standalone kernel at decode): one warp commits
//    one line that is its page's only line in the step (C = 1): the line
//    read in 16-byte vectors into registers, its amax by shuffles, the old
//    scale read and the new one written by lane 0, the page's other lines
//    rescaled by the warp (eight 16-byte accesses a lane in flight; written
//    as zero codes without a read when the ratio is 0, as at an offset-0
//    reset), the line quantized from the same registers (read again, from
//    L1, after a rescale). No barrier.
//  * commit_quant_block: a block commits the C lines of a slot's KV head
//    (K, V or both): lines loaded once into registers (kHoldBytes a
//    thread in the standalone kernel; lines past that, and in the fused
//    and whole-step kernels all, are loaded a second time, from L2); pages
//    grouped by __match_any_sync over a warp's 32 lines and ballots back
//    through the earlier chunks (no O(C) scan a line); page maxima by a
//    warp reduction and a shared-memory atomicMax on the bits; the moved
//    pages rescaled in parallel across pages, skipping the lines that new
//    lines overwrite (a bitmap of the offsets each page takes); four
//    barriers. Its shared memory (CommitSmem, commit_smem_bytes) is the
//    caller's. The fused and whole-step kernels run it at every C: inlined
//    into their register-bound blocks, the warp form spilled (ptxas -v for
//    sm_90a: the split design's one-row int8 blocks at dk 80, the whole
//    step's commit stage at dk 128), the block form did not.
#pragma once

#include "paged_attention.cuh"

namespace fft {

constexpr int kMaxChunk = 256;  // most lines per slot in a fused or whole-step commit
constexpr int kHoldBytes = 64;  // line bytes a thread of the standalone commit holds in registers
// code vectors a thread of a block rescales with their loads in flight: 4,
// or 1 in the lean form that callers short of registers take (the
// whole-step kernel, whose non-inlined stages share one register budget,
// and the split design's one-row blocks, at 96 registers); a lane of
// commit_line_warp, which rescales a page alone, 8
constexpr int kRescaleBatch = 4;
constexpr int kLineRescaleBatch = 8;

struct CommitArgs {
  PagedArgs a;             // a.q is q_rot; pools and scales are those below
  const void* q_raw;       // (R, C, H, dk) TQ, before RoPE
  const void* k_new;       // (R, C, KV, dk) TQ, before RoPE
  const void* v_new;       // (R, C, KV, dk) TQ
  const float* cos;        // (R, C, rot), or null: no RoPE
  const float* sin;
  void* k_pool;            // (P + 1, ps, KV, dk / pack), written in place
  void* v_pool;
  float* k_scale;          // (P + 1, KV), quantized pools only
  float* v_scale;
  void* q_rot;             // (R, C, H, dk) TQ, written here
  void* k_rot;             // (R, C, KV, dk) TQ, written here
  const int* logical;      // (R, C) logical page of each new line, or null
  const void* phys;        // (R, C) physical page of each new line (with null logical)
  const void* off;         // (R, C) in-page offset of each new line
  bool phys64, off64;      // phys / off are int64 (else int32)
  int scratch;             // the scratch page, whose lines are not committed
  int rot;
  float qmax;
};

__device__ __forceinline__ int load_index(const void* p, bool wide, size_t i) {
  return wide ? int(static_cast<const long long*>(p)[i]) : static_cast<const int*>(p)[i];
}

// The physical page and in-page offset of new line c of slot r.
__device__ __forceinline__ int line_page(const CommitArgs& f, int r, int c) {
  const size_t rc = (size_t)r * f.a.C + c;
  return f.logical != nullptr ? f.a.table[(size_t)r * f.a.NP + f.logical[rc]]
                              : load_index(f.phys, f.phys64, rc);
}
__device__ __forceinline__ int line_off(const CommitArgs& f, int r, int c) {
  return load_index(f.off, f.off64, (size_t)r * f.a.C + c);
}

// Element d of the RoPE of head row x, rounded to TQ. Each element is
// rounded as the unfused PyTorch path rounds it (x * cos and rotated *
// sin each to f32, their sum to f32, then to the model dtype): __fmul_rn
// and __fadd_rn keep nvcc from contracting them into an FMA.
template <typename TQ>
__device__ __forceinline__ TQ rope_at(const TQ* x, int d, const float* cs,
                                      const float* sn, int rot) {
  if (cs == nullptr || d >= rot) return x[d];
  const int half = rot / 2;
  const float xd = to_f32<TQ>(x[d]);
  const float partner = d < half ? -to_f32<TQ>(x[d + half]) : to_f32<TQ>(x[d - half]);
  return from_f32<TQ>(__fadd_rn(__fmul_rn(xd, cs[d]), __fmul_rn(partner, sn[d])));
}

// Dims [d0, d0 + 8) of head row x, RoPE'd as rope_at rounds each, into y.
// x, y and (with a rotary width a multiple of 16, where 8 dims lie on one
// side of rot / 2) cs and sn are read and written in 16-byte vectors.
template <typename TQ>
__device__ __forceinline__ void rope8(const TQ* x, TQ* y, int d0, const float* cs,
                                      const float* sn, int rot) {
  float v[8];
  load_f32<TQ, 8>(x + d0, v);
  if (cs != nullptr && d0 < rot) {
    if (rot % 16 != 0) {
#pragma unroll
      for (int i = 0; i < 8; ++i) y[d0 + i] = rope_at<TQ>(x, d0 + i, cs, sn, rot);
      return;
    }
    const int half = rot / 2;
    float p[8], c[8], s[8];
    load_f32<TQ, 8>(x + (d0 < half ? d0 + half : d0 - half), p);
    load_f32<float, 8>(cs + d0, c);
    load_f32<float, 8>(sn + d0, s);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float partner = d0 < half ? -p[i] : p[i];
      v[i] = __fadd_rn(__fmul_rn(v[i], c[i]), __fmul_rn(partner, s[i]));
    }
  }
  store8<TQ>(y + d0, v);
}

__device__ __forceinline__ uint8_t pack_pair(float lo, float hi) {
  return uint8_t(((int)lo + 8) | (((int)hi + 8) << 4));
}

// A line's code bytes in units of 8: unit j holds values [8 j, 8 j + 8)
// of the line (int8), or those and [DK / 2 + 8 j, DK / 2 + 8 j + 8) (int4:
// byte i of the unit packs value 8 j + i with value DK / 2 + 8 j + i). A
// unit's values are kWords 16-byte words of TQ.
template <typename TQ, int KIND, int DK>
struct LineUnits {
  static constexpr int kCodes = DK / pack_of<KIND>();           // code bytes of a line
  static constexpr int kPerLine = kCodes / 8;                   // units of a line
  static constexpr int kHalf = 8 * int(sizeof(TQ)) / 16;        // words of 8 values
  static constexpr int kWords = kHalf * pack_of<KIND>();
  static constexpr int kVec = kCodes % 16 == 0 ? 16 : 8;        // bytes of a pool access
  static constexpr int kVecs = kCodes / kVec;                   // pool accesses of a line
  static constexpr int kHold = kHoldBytes / (16 * kWords) > 0 ? kHoldBytes / (16 * kWords) : 1;
};

template <typename TQ, int KIND, int DK>
struct RawUnit {
  uint4 w[LineUnits<TQ, KIND, DK>::kWords];
};

template <typename TQ, int KIND, int DK>
__device__ __forceinline__ void load_unit(const TQ* line, int j, RawUnit<TQ, KIND, DK>& u) {
  using U = LineUnits<TQ, KIND, DK>;
#pragma unroll
  for (int i = 0; i < U::kHalf; ++i) u.w[i] = reinterpret_cast<const uint4*>(line + 8 * j)[i];
  if constexpr (KIND == kPoolInt4) {
#pragma unroll
    for (int i = 0; i < U::kHalf; ++i)
      u.w[U::kHalf + i] = reinterpret_cast<const uint4*>(line + DK / 2 + 8 * j)[i];
  }
}

// Word k of a 16-byte vector, and value i of a unit (its words as TQ),
// by shifts and selects on registers: with i and k known at compile time
// no value is addressed through memory, which puts a vector on the stack.
__device__ __forceinline__ uint32_t word_of(const uint4& v, int k) {
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}
template <typename TQ>
__device__ __forceinline__ float unit_value(const uint4* w, int i) {
  if constexpr (sizeof(TQ) == 4) {
    return __uint_as_float(word_of(w[i / 4], i % 4));
  } else {  // bf16: the high half of an f32
    const uint32_t x = word_of(w[i / 8], i % 8 / 2);
    return __uint_as_float(i % 2 ? x & 0xffff0000u : x << 16);
  }
}

template <typename TQ, int KIND, int DK>
__device__ __forceinline__ float unit_amax(const RawUnit<TQ, KIND, DK>& u) {
  float m = 0.f;
#pragma unroll
  for (int i = 0; i < 8 * pack_of<KIND>(); ++i) m = fmaxf(m, fabsf(unit_value<TQ>(u.w, i)));
  return m;
}

// The code byte of q (int8) or of the pair (q, q2) (int4), at bit 8 k.
template <int KIND>
__device__ __forceinline__ uint32_t code_byte(float q, float q2, int k) {
  const uint32_t b = KIND == kPoolInt8 ? uint32_t(uint8_t(int8_t(q))) : uint32_t(pack_pair(q, q2));
  return b << (8 * k);
}

// The unit's 8 code bytes at the page scale's ``den`` = max(s, 1e-30).
template <typename TQ, int KIND, int DK>
__device__ __forceinline__ uint2 quant_unit(const RawUnit<TQ, KIND, DK>& u, float den,
                                            float qmax) {
  uint32_t w[2] = {0u, 0u};
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float qx = fminf(fmaxf(rintf(__fdiv_rn(unit_value<TQ>(u.w, i), den)), -qmax), qmax);
    float qy = 0.f;
    if constexpr (KIND == kPoolInt4)
      qy = fminf(fmaxf(rintf(__fdiv_rn(unit_value<TQ>(u.w, 8 + i), den)), -qmax), qmax);
    w[i / 4] |= code_byte<KIND>(qx, qy, i % 4);
  }
  return make_uint2(w[0], w[1]);
}

// A pool access of the codes of one line (16 or 8 bytes), and its codes
// requantized by rint(code * ratio) (ratio 0: zero codes, int8 byte 0,
// int4 byte 0x88, without reading them), a 32-bit word at a time.
template <int N> struct VecOf;
template <> struct VecOf<16> { using T = uint4; };
template <> struct VecOf<8> { using T = uint2; };

template <int KIND>
__device__ __forceinline__ uint32_t requant_word(uint32_t x, float ratio) {
  if (ratio == 0.f) return KIND == kPoolInt4 ? 0x88888888u : 0u;
  uint32_t out = 0u;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const uint32_t b = (x >> (8 * k)) & 0xffu;
    if constexpr (KIND == kPoolInt8) {
      out |= code_byte<KIND>(rintf(__fmul_rn(float(int8_t(b)), ratio)), 0.f, k);
    } else {
      out |= code_byte<KIND>(rintf(__fmul_rn(float(int(b & 0xF) - 8), ratio)),
                             rintf(__fmul_rn(float(int(b >> 4) - 8), ratio)), k);
    }
  }
  return out;
}

template <int KIND>
__device__ __forceinline__ uint4 requant_vec(uint4 v, float ratio) {
  return make_uint4(requant_word<KIND>(v.x, ratio), requant_word<KIND>(v.y, ratio),
                    requant_word<KIND>(v.z, ratio), requant_word<KIND>(v.w, ratio));
}
template <int KIND>
__device__ __forceinline__ uint2 requant_vec(uint2 v, float ratio) {
  return make_uint2(requant_word<KIND>(v.x, ratio), requant_word<KIND>(v.y, ratio));
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// Line c of slot r, KV head h, committed into one pool by one warp (all 32
// lanes call it). It must be the only line of its page in the step, as at
// C = 1 (pages are slot-private). ``vals`` (R, C, KV, DK) TQ.
template <typename TQ, int KIND, int DK>
__device__ void commit_line_warp(const CommitArgs& f, int r, int c, int h, const TQ* vals,
                                 void* pool, float* scale) {
  using U = LineUnits<TQ, KIND, DK>;
  using Vec = typename VecOf<U::kVec>::T;
  static_assert(U::kPerLine <= 32, "a lane holds at most one unit of the line");
  const PagedArgs& a = f.a;
  const int lane = threadIdx.x % 32;
  const TQ* line = vals + (((size_t)r * a.C + c) * a.KV + h) * DK;
  RawUnit<TQ, KIND, DK> u;
  if (lane < U::kPerLine) load_unit<TQ, KIND, DK>(line, lane, u);  // beside the index loads
  const int page = line_page(f, r, c);
  const int o = line_off(f, r, c);
  if (page == f.scratch) return;
  const float m = warp_max(lane < U::kPerLine ? unit_amax<TQ, KIND, DK>(u) : 0.f);
  float nw = 0.f, ratio = 0.f;
  if (lane == 0) {
    const size_t si = (size_t)page * a.KV + h;
    const float old = o == 0 ? 0.f : scale[si];
    nw = fmaxf(old, __fdiv_rn(m, f.qmax));
    ratio = nw > 0.f ? __fdiv_rn(old, fmaxf(nw, 1e-30f)) : 0.f;
    scale[si] = nw;
  }
  nw = __shfl_sync(0xffffffffu, nw, 0);
  ratio = __shfl_sync(0xffffffffu, ratio, 0);
  uint8_t* base = static_cast<uint8_t*>(pool) + pool_row<KIND, DK>(page, 0, h, a.ps, a.KV);
  const size_t stride = (size_t)a.KV * U::kCodes;  // from one line of the page to the next
  if (ratio != 1.f) {  // rint(code * 1) == code: an unmoved page keeps its bytes
    // the unit is loaded again after the loop (from L1), so that its
    // registers are free during it
    const int n = a.ps * U::kVecs;
    auto at = [&](int idx) {
      return base + idx / U::kVecs * stride + idx % U::kVecs * U::kVec;
    };
    for (int i0 = lane; i0 < n; i0 += kLineRescaleBatch * 32) {
      Vec w[kLineRescaleBatch] = {};
#pragma unroll
      for (int k = 0; k < kLineRescaleBatch; ++k) {
        const int idx = i0 + 32 * k;
        if (idx < n && idx / U::kVecs != o && ratio != 0.f)
          w[k] = *reinterpret_cast<const Vec*>(at(idx));
      }
#pragma unroll
      for (int k = 0; k < kLineRescaleBatch; ++k) {
        const int idx = i0 + 32 * k;
        if (idx < n && idx / U::kVecs != o)
          *reinterpret_cast<Vec*>(at(idx)) = requant_vec<KIND>(w[k], ratio);
      }
    }
    if (lane < U::kPerLine) load_unit<TQ, KIND, DK>(line, lane, u);
  }
  if (lane < U::kPerLine)
    *reinterpret_cast<uint2*>(base + o * stride + 8 * lane) =
        quant_unit<TQ, KIND, DK>(u, fmaxf(nw, 1e-30f), f.qmax);
}

// commit_quant_block's shared memory for C lines of pages of ps lines: per
// line its page (-1: not committed), offset and lead (its page's first
// line); per lead line and tensor the page amax's bits (then the new
// scale) and the ratio, and the bitmap of the offsets the page takes; the
// moved (tensor, lead) pairs and their count.
struct CommitSmem {
  int* page;
  int* off;
  int* lead;
  unsigned* amax;  // [2][C]
  float* ratio;    // [2][C]
  unsigned* bits;  // [C][W]
  int* moved;      // [2 C]
  int* n_moved;
  int words;       // W = ceil(ps / 32)
};

__host__ __device__ constexpr size_t commit_smem_bytes(int C, int ps) {
  return 4 * (size_t(C) * (9 + (ps + 31) / 32) + 1);
}

__device__ __forceinline__ CommitSmem commit_smem(void* base, int C, int ps) {
  int* p = static_cast<int*>(base);
  CommitSmem s;
  s.words = (ps + 31) / 32;
  s.page = p;
  s.off = p + C;
  s.lead = p + 2 * C;
  s.amax = reinterpret_cast<unsigned*>(p + 3 * C);
  s.ratio = reinterpret_cast<float*>(p + 5 * C);
  s.moved = p + 7 * C;
  s.bits = reinterpret_cast<unsigned*>(p + 9 * C);
  s.n_moved = p + (9 + s.words) * C;
  return s;
}

// The page maximum of ``v`` (an amax's bits) into slots[key] for every
// lane of the warp with key >= 0: lanes of one key reduce by a warp
// reduction, their first lane does the atomicMax. All 32 lanes call it.
__device__ __forceinline__ void max_into(unsigned* slots, int key, unsigned v) {
  const unsigned peers = __match_any_sync(0xffffffffu, key);
  const unsigned m = __reduce_max_sync(peers, v);
  if (key >= 0 && (threadIdx.x % 32) == unsigned(__ffs(peers) - 1)) atomicMax(slots + key, m);
}

// The C lines of slot r, KV head h, committed into NTENS pools (tensor t0
// and, with NTENS 2, tensor 1: K is tensor 0, its lines f.k_rot, V tensor
// 1, its lines f.v_new) by all NT threads of the block, in shared memory
// ``s`` for C lines. Each thread holds HOLD units of the lines in
// registers from their one load to their quantization (the standalone
// kernel: LineUnits::kHold); the rest are loaded again to be quantized
// (the fused and whole-step kernels hold none: their lines were just
// written by the block, and their register budgets have no room). No
// barrier after the last write.
template <typename TQ, int KIND, int DK, int NT, int NTENS, int HOLD,
          int BATCH = kRescaleBatch>
__device__ void commit_quant_block(const CommitArgs& f, int r, int h, int t0,
                                   const CommitSmem& s) {
  using U = LineUnits<TQ, KIND, DK>;
  constexpr int kHold = HOLD;
  const PagedArgs& a = f.a;
  const int C = a.C, W = s.words, tid = threadIdx.x, lane = tid % 32;
  const int per_tensor = C * U::kPerLine, nunits = NTENS * per_tensor;
  const size_t stride = (size_t)a.KV * U::kCodes;
  auto vals = [&](int t) {
    return static_cast<const TQ*>(t ? f.v_new : f.k_rot) + ((size_t)r * C * a.KV + h) * DK;
  };
  auto codes = [&](int t) { return static_cast<uint8_t*>(t ? f.v_pool : f.k_pool); };

  // 1. the lines' pages and offsets; an idle slot (every line on the
  // scratch page) commits nothing
  bool live = false;
  for (int c = tid; c < C; c += NT) {
    const int p = line_page(f, r, c);
    s.page[c] = p != f.scratch ? p : -1;
    s.off[c] = line_off(f, r, c);
    live = live || p != f.scratch;
  }
  if (!__syncthreads_or(live)) return;

  // 2. the held units, loaded once: unit u is unit u % kPerLine of line
  // (u / kPerLine) % C of tensor t0 + u / per_tensor
  RawUnit<TQ, KIND, DK> held[kHold > 0 ? kHold : 1];
#pragma unroll
  for (int i = 0; i < kHold; ++i) {
    const int u = tid + i * NT, c = (u / U::kPerLine) % C;
    if (u < nunits && s.page[c] >= 0)
      load_unit<TQ, KIND, DK>(vals(t0 + u / per_tensor) + (size_t)c * a.KV * DK,
                              u % U::kPerLine, held[i]);
  }

  // 3. page groups: a warp matches the pages of its chunk of 32 lines; the
  // chunk's first line of each page looks back through the earlier chunks
  // by ballots for the page's first line in the step, its lead
  for (int base = tid - lane; base < C; base += NT) {  // warp-uniform
    const int c = base + lane;
    const int p = c < C ? s.page[c] : -1;
    const unsigned peers = __match_any_sync(0xffffffffu, p);
    const int first = __ffs(peers) - 1;
    int lead = base + first;
    unsigned heads = __ballot_sync(0xffffffffu, lane == first && p >= 0);
    while (heads != 0) {  // warp-uniform
      const int b = __ffs(heads) - 1;
      heads &= heads - 1;
      const int pb = __shfl_sync(0xffffffffu, p, b);
      int found = -1;
      for (int s0 = 0; s0 < base && found < 0; s0 += 32) {
        const unsigned m = __ballot_sync(0xffffffffu, s.page[s0 + lane] == pb);
        if (m != 0) found = s0 + __ffs(m) - 1;
      }
      if (found >= 0 && first == b) lead = found;
    }
    if (c < C) s.lead[c] = p >= 0 ? lead : -1;
    if (p >= 0 && lead == c) {  // the page's group: its old scales read here, early
      s.amax[c] = s.amax[C + c] = 0u;
      for (int w = 0; w < W; ++w) s.bits[c * W + w] = 0u;
#pragma unroll
      for (int tt = 0; tt < NTENS; ++tt)
        s.ratio[tt * C + c] = (t0 + tt ? f.v_scale : f.k_scale)[(size_t)p * a.KV + h];
    }
  }
  if (tid == 0) *s.n_moved = 0;
  __syncthreads();

  // 4. each page's offsets (bit 0: a line at offset 0, which resets its
  // scale) and amax
  for (int c = tid; c < C; c += NT) {
    const int ld = s.lead[c];
    if (ld >= 0) atomicOr(s.bits + ld * W + s.off[c] / 32, 1u << (s.off[c] % 32));
  }
#pragma unroll
  for (int i = 0; i < kHold; ++i) {
    const int u = tid + i * NT, c = (u / U::kPerLine) % C;
    const int ld = u < nunits ? s.lead[c] : -1;
    const unsigned v = ld >= 0 ? __float_as_uint(unit_amax<TQ, KIND, DK>(held[i])) : 0u;
    max_into(s.amax, ld >= 0 ? (u / per_tensor) * C + ld : -1, v);
  }
#pragma unroll 1
  for (int u0 = tid - lane + kHold * NT; u0 < nunits; u0 += NT) {  // warp-uniform
    const int u = u0 + lane, c = (u / U::kPerLine) % C;
    const int ld = u < nunits ? s.lead[c] : -1;
    unsigned v = 0u;
    if (ld >= 0) {
      RawUnit<TQ, KIND, DK> x;
      load_unit<TQ, KIND, DK>(vals(t0 + u / per_tensor) + (size_t)c * a.KV * DK,
                              u % U::kPerLine, x);
      v = __float_as_uint(unit_amax<TQ, KIND, DK>(x));
    }
    max_into(s.amax, ld >= 0 ? (u / per_tensor) * C + ld : -1, v);
  }
  __syncthreads();

  // 5. each page's new scale (written) and ratio; the pages whose codes move
  for (int c = tid; c < C; c += NT) {
    if (s.lead[c] != c) continue;
    const bool reset = (s.bits[c * W] & 1u) != 0;
#pragma unroll
    for (int tt = 0; tt < NTENS; ++tt) {
      float* scale = t0 + tt ? f.v_scale : f.k_scale;
      const size_t si = (size_t)s.page[c] * a.KV + h;
      const float old = reset ? 0.f : s.ratio[tt * C + c];
      const float nw = fmaxf(old, __fdiv_rn(__uint_as_float(s.amax[tt * C + c]), f.qmax));
      const float ratio = nw > 0.f ? __fdiv_rn(old, fmaxf(nw, 1e-30f)) : 0.f;
      scale[si] = nw;
      s.amax[tt * C + c] = __float_as_uint(nw);
      s.ratio[tt * C + c] = ratio;
      if (ratio != 1.f) s.moved[atomicAdd(s.n_moved, 1)] = tt * C + c;
    }
  }
  __syncthreads();

  // 6. the moved pages' lines that no new line overwrites, requantized in
  // parallel across pages (four 16-byte accesses a thread in flight) ...
  using Vec = typename VecOf<U::kVec>::T;
  const int per_page = a.ps * U::kVecs, n = *s.n_moved * per_page;
  // the code vector ``idx`` of the moved pages' lines, or null where a new
  // line overwrites its line; its ratio in ``ratio``
  auto moved_at = [&](int idx, float& ratio) -> uint8_t* {
    const int g = s.moved[idx / per_page], c = g % C, rem = idx % per_page;
    const int ln = rem / U::kVecs;
    ratio = s.ratio[g];
    if ((s.bits[c * W + ln / 32] >> (ln % 32)) & 1u) return nullptr;
    return codes(t0 + g / C) + pool_row<KIND, DK>(s.page[c], ln, h, a.ps, a.KV) +
           rem % U::kVecs * U::kVec;
  };
  for (int i0 = tid; i0 < n; i0 += BATCH * NT) {
    Vec w[BATCH] = {};
#pragma unroll
    for (int k = 0; k < BATCH; ++k) {
      const int idx = i0 + k * NT;
      float ratio;
      const uint8_t* at = idx < n ? moved_at(idx, ratio) : nullptr;
      if (at != nullptr && ratio != 0.f) w[k] = *reinterpret_cast<const Vec*>(at);
    }
#pragma unroll
    for (int k = 0; k < BATCH; ++k) {
      const int idx = i0 + k * NT;
      float ratio;
      uint8_t* at = idx < n ? moved_at(idx, ratio) : nullptr;
      if (at != nullptr) *reinterpret_cast<Vec*>(at) = requant_vec<KIND>(w[k], ratio);
    }
  }

  // ... and the new lines quantized at their page's final scale
  auto store = [&](int u, int c, int ld, const RawUnit<TQ, KIND, DK>& x) {
    const int tt = u / per_tensor;
    const float den = fmaxf(__uint_as_float(s.amax[tt * C + ld]), 1e-30f);
    *reinterpret_cast<uint2*>(codes(t0 + tt) +
                              pool_row<KIND, DK>(s.page[c], s.off[c], h, a.ps, a.KV) +
                              8 * (u % U::kPerLine)) = quant_unit<TQ, KIND, DK>(x, den, f.qmax);
  };
#pragma unroll
  for (int i = 0; i < kHold; ++i) {
    const int u = tid + i * NT, c = (u / U::kPerLine) % C;
    if (u < nunits && s.lead[c] >= 0) store(u, c, s.lead[c], held[i]);
  }
#pragma unroll 1
  for (int u = tid + kHold * NT; u < nunits; u += NT) {
    const int c = (u / U::kPerLine) % C, ld = s.lead[c];
    if (ld < 0) continue;
    RawUnit<TQ, KIND, DK> x;
    load_unit<TQ, KIND, DK>(vals(t0 + u / per_tensor) + (size_t)c * a.KV * DK,
                            u % U::kPerLine, x);
    store(u, c, ld, x);
  }
}

// RoPE of the new K lines of KV head h of slot r (into k_rot), then the
// commit of its new K/V lines (commit_quant_block, in the shared memory
// ``ws`` of commit_smem_bytes(C, ps); LEAN: one rescaled vector in flight
// a thread). All NT threads of the block call it; it ends with a barrier,
// after which the block may read the committed pages. The split decode
// design (paged_decode.cuh) runs it in the one block whose split holds
// the pages of the new lines.
template <typename TQ, int KIND, int DK, int NT, bool LEAN = false>
__device__ void rope_commit_kv(const CommitArgs& f, int r, int h, void* ws) {
  const PagedArgs& a = f.a;
  const int C = a.C, tid = threadIdx.x;
  const TQ* kin = static_cast<const TQ*>(f.k_new);
  const TQ* vin = static_cast<const TQ*>(f.v_new);
  TQ* ko = static_cast<TQ*>(f.k_rot);

  constexpr int V = DK / 8;  // 8-dim vectors a head row
  for (int idx = tid; idx < C * V; idx += NT) {
    const int d0 = idx % V * 8, c = idx / V;
    const size_t rc = (size_t)r * C + c;
    const size_t row = (rc * a.KV + h) * DK;
    const float* cs = f.cos ? f.cos + rc * f.rot : nullptr;
    const float* sn = f.sin ? f.sin + rc * f.rot : nullptr;
    rope8<TQ>(kin + row, ko + row, d0, cs, sn, f.rot);
  }
  __syncthreads();

  if constexpr (KIND == kPoolFloat) {
    TQ* kp = static_cast<TQ*>(f.k_pool);
    TQ* vp = static_cast<TQ*>(f.v_pool);
    for (int idx = tid; idx < C * V; idx += NT) {
      const int d0 = idx % V * 8, c = idx / V;
      const int page = line_page(f, r, c);
      if (page == f.scratch) continue;
      const size_t rc = (size_t)r * C + c;
      const size_t dst = pool_row<KIND, DK>(page, line_off(f, r, c), h, a.ps, a.KV) + d0;
      const size_t src = (rc * a.KV + h) * DK + d0;
      float x[8];
      load_f32<TQ, 8>(ko + src, x);
      store8<TQ>(kp + dst, x);
      load_f32<TQ, 8>(vin + src, x);
      store8<TQ>(vp + dst, x);
    }
  } else {
    commit_quant_block<TQ, KIND, DK, NT, 2, 0, LEAN ? 1 : kRescaleBatch>(
        f, r, h, 0, commit_smem(ws, C, a.ps));
  }
  __syncthreads();  // the attention reads the committed pages
}

// RoPE of q and the new K lines of KV head h of slot r (into q_rot and
// k_rot), then the commit of its new K/V lines (rope_commit_kv, in the
// shared memory ``ws``, lean with LEAN). All NT threads of the block call
// it; it ends with a barrier, after which the block may attend the
// committed pages through q_rot.
template <typename TQ, int KIND, int DK, int NT, bool LEAN = false>
__device__ void rope_and_commit(const CommitArgs& f, int r, int h, void* ws) {
  const PagedArgs& a = f.a;
  const int G = a.H / a.KV, C = a.C, tid = threadIdx.x;
  const TQ* qin = static_cast<const TQ*>(f.q_raw);
  TQ* qo = static_cast<TQ*>(f.q_rot);

  constexpr int V = DK / 8;  // 8-dim vectors a head row
  for (int idx = tid; idx < C * G * V; idx += NT) {
    const int d0 = idx % V * 8, cg = idx / V, c = cg / G, g = cg % G;
    const size_t rc = (size_t)r * C + c;
    const size_t row = (rc * a.H + (size_t)h * G + g) * DK;
    const float* cs = f.cos ? f.cos + rc * f.rot : nullptr;
    const float* sn = f.sin ? f.sin + rc * f.rot : nullptr;
    rope8<TQ>(qin + row, qo + row, d0, cs, sn, f.rot);
  }
  rope_commit_kv<TQ, KIND, DK, NT, LEAN>(f, r, h, ws);  // its first barrier covers q_rot too
}

}  // namespace fft
