// The commit of new K/V lines into their pages, shared by
// fused_rope_paged_attention.cu and whole_step_decode.cu: rotate-half
// RoPE of q and the new K lines, then the in-place write of the new lines
// (a scatter on full-precision pools, the arithmetic of
// kv_quant.quant_line_write on quantized ones).
//
// One block commits KV head h of slot r: the C lines of that slot and
// head. Pages are slot-private and a KV head's slice of a page (its bytes
// and its scale) is touched by that block alone; the scratch page, which
// every padding line writes, is the one exception (its bytes are
// garbage, and only padding rows read them).
#pragma once

#include "paged_attention.cuh"

namespace fft {

constexpr int kMaxChunk = 256;  // most lines per slot in one commit

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
  const int* phys;         // (R, C) physical page of each new line (with null logical)
  const int* off;          // (R, C) in-page offset of each new line
  int rot;
  float qmax;
};

// The physical page of new line c of slot r.
__device__ __forceinline__ int line_page(const CommitArgs& f, int r, int c) {
  const size_t rc = (size_t)r * f.a.C + c;
  return f.logical != nullptr ? f.a.table[(size_t)r * f.a.NP + f.logical[rc]] : f.phys[rc];
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

// kv_quant.quant_line_write for KV head h of slot r's C lines ``vals``
// (R, C, KV, dk) TQ, restricted to the pages those lines touch: offset-0
// scale reset, running amax scale, codes of a page whose scale grew
// requantized by rint(code * old / new), new lines quantized by
// rint(v / max(s, 1e-30)) clipped to +-qmax. IEEE division and
// round-half-to-even, so pool bytes and scales are bitwise those of the
// unfused path. Lines of one page commit in order: the page's new scale
// is the amax over all of its lines in the step.
//
// The per-line arrays live in shared memory the caller provides
// (CommitLines, C entries each): the fused and whole-step kernels give
// static arrays of kMaxChunk lines (commit_quant), the standalone commit
// kernel (paged_commit.cu) dynamic ones sized from C.
struct CommitLines {
  float* lq;     // line amax / qmax
  int* page;     // physical page of the line
  int* lead;     // first line of the same page
  float* nw;     // the page's new scale, at its first line
  float* ratio;  // old / new, at its first line
};

template <typename TQ, int KIND, int DK, int NT>
__device__ void commit_quant_lines(const CommitArgs& f, int r, int h, const TQ* vals,
                                   void* pool, float* scale, const CommitLines& s) {
  float* sLq = s.lq;
  int* sPage = s.page;
  int* sLead = s.lead;
  float* sNew = s.nw;
  float* sRatio = s.ratio;
  constexpr int kWarps = NT / 32;
  constexpr int DKP = DK / pack_of<KIND>();
  const PagedArgs& a = f.a;
  const int C = a.C, tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const float qmax = f.qmax;
  const TQ* rowv = vals + ((size_t)r * C * a.KV + h) * DK;  // line c at c * KV * DK
  const size_t line_stride = (size_t)a.KV * DK;
  const int* of = f.off + (size_t)r * C;

  for (int c = warp; c < C; c += kWarps) {
    float mx = 0.f;
    for (int d = lane; d < DK; d += 32) mx = fmaxf(mx, fabsf(to_f32<TQ>(rowv[c * line_stride + d])));
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    if (lane == 0) sLq[c] = __fdiv_rn(mx, qmax);
  }
  for (int c = tid; c < C; c += NT) sPage[c] = line_page(f, r, c);
  __syncthreads();
  for (int c = tid; c < C; c += NT) {
    const int page = sPage[c];
    int lead = c;
    for (int c2 = 0; c2 < c; ++c2) {
      if (sPage[c2] == page) {
        lead = c2;
        break;
      }
    }
    sLead[c] = lead;
    if (lead != c) continue;
    bool first = false;
    float pmax = 0.f;
    for (int c2 = c; c2 < C; ++c2) {
      if (sPage[c2] != page) continue;
      first = first || of[c2] == 0;
      pmax = fmaxf(pmax, sLq[c2]);
    }
    const float old = first ? 0.f : scale[(size_t)page * a.KV + h];
    const float nw = fmaxf(old, pmax);
    sNew[c] = nw;
    sRatio[c] = nw > 0.f ? __fdiv_rn(old, fmaxf(nw, 1e-30f)) : 0.f;
  }
  __syncthreads();

  // requantize the codes of every touched page whose scale moved, 8 code
  // bytes a thread at a time
  constexpr int V = DKP / 8;
  for (int c = 0; c < C; ++c) {  // block-uniform
    if (sLead[c] != c || sRatio[c] == 1.f) continue;  // rint(code * 1) == code
    const float ratio = sRatio[c];
    const size_t base = pool_row<KIND, DK>(sPage[c], 0, h, a.ps, a.KV);
    for (int idx = tid; idx < a.ps * V; idx += NT) {
      uint8_t* at = static_cast<uint8_t*>(pool) + base + (size_t)(idx / V) * a.KV * DKP +
                    idx % V * 8;
      uint2 w = *reinterpret_cast<const uint2*>(at);
      uint8_t* b = reinterpret_cast<uint8_t*>(&w);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        if constexpr (KIND == kPoolInt8) {
          b[i] = (uint8_t)(int8_t)rintf(__fmul_rn(float(int8_t(b[i])), ratio));
        } else {
          const float lo = rintf(__fmul_rn(float(int(b[i] & 0xF) - 8), ratio));
          const float hi = rintf(__fmul_rn(float(int((b[i] >> 4) & 0xF) - 8), ratio));
          b[i] = pack_pair(lo, hi);
        }
      }
      *reinterpret_cast<uint2*>(at) = w;
    }
  }
  __syncthreads();

  // quantize the new lines at their page's final scale, 8 code bytes a
  // thread at a time
  for (int idx = tid; idx < C * V; idx += NT) {
    const int c = idx / V, j0 = idx % V * 8;
    const float den = fmaxf(sNew[sLead[c]], 1e-30f);
    const TQ* v = rowv + c * line_stride;
    float x[8], y[8];
    load_f32<TQ, 8>(v + j0, x);
    if constexpr (KIND == kPoolInt4) load_f32<TQ, 8>(v + j0 + DK / 2, y);
    uint2 w;
    uint8_t* b = reinterpret_cast<uint8_t*>(&w);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float qx = fminf(fmaxf(rintf(__fdiv_rn(x[i], den)), -qmax), qmax);
      if constexpr (KIND == kPoolInt8) {
        b[i] = (uint8_t)(int8_t)qx;
      } else {
        const float qy = fminf(fmaxf(rintf(__fdiv_rn(y[i], den)), -qmax), qmax);
        b[i] = pack_pair(qx, qy);
      }
    }
    *reinterpret_cast<uint2*>(static_cast<uint8_t*>(pool) +
                              pool_row<KIND, DK>(sPage[c], of[c], h, a.ps, a.KV) + j0) = w;
  }
  for (int c = tid; c < C; c += NT) {
    if (sLead[c] == c) scale[(size_t)sPage[c] * a.KV + h] = sNew[c];
  }
  __syncthreads();
}

// commit_quant_lines on static arrays of kMaxChunk lines (C <= kMaxChunk)
template <typename TQ, int KIND, int DK, int NT>
__device__ void commit_quant(const CommitArgs& f, int r, int h, const TQ* vals,
                             void* pool, float* scale) {
  __shared__ float sLq[kMaxChunk];
  __shared__ int sPage[kMaxChunk];
  __shared__ int sLead[kMaxChunk];
  __shared__ float sNew[kMaxChunk];
  __shared__ float sRatio[kMaxChunk];
  commit_quant_lines<TQ, KIND, DK, NT>(f, r, h, vals, pool, scale,
                                       CommitLines{sLq, sPage, sLead, sNew, sRatio});
}

// RoPE of the new K lines of KV head h of slot r (into k_rot), then the
// commit of its new K/V lines. All NT threads of the block call it; it
// ends with a barrier, after which the block may read the committed
// pages. The split decode design (paged_decode.cuh) runs it in the one
// block whose split holds the pages of the new lines.
template <typename TQ, int KIND, int DK, int NT>
__device__ void rope_commit_kv(const CommitArgs& f, int r, int h) {
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
    __shared__ size_t sDst[kMaxChunk];  // pool row of each new line
    for (int c = tid; c < C; c += NT)
      sDst[c] = pool_row<KIND, DK>(line_page(f, r, c), f.off[(size_t)r * C + c], h, a.ps, a.KV);
    __syncthreads();
    TQ* kp = static_cast<TQ*>(f.k_pool);
    TQ* vp = static_cast<TQ*>(f.v_pool);
    for (int idx = tid; idx < C * V; idx += NT) {
      const int d0 = idx % V * 8, c = idx / V;
      const size_t rc = (size_t)r * C + c;
      const size_t dst = sDst[c] + d0;
      const size_t src = (rc * a.KV + h) * DK + d0;
      float x[8];
      load_f32<TQ, 8>(ko + src, x);
      store8<TQ>(kp + dst, x);
      load_f32<TQ, 8>(vin + src, x);
      store8<TQ>(vp + dst, x);
    }
  } else {
    commit_quant<TQ, KIND, DK, NT>(f, r, h, ko, f.k_pool, f.k_scale);
    commit_quant<TQ, KIND, DK, NT>(f, r, h, vin, f.v_pool, f.v_scale);
  }
  __syncthreads();  // the attention reads the committed pages
}

// RoPE of q and the new K lines of KV head h of slot r (into q_rot and
// k_rot), then the commit of its new K/V lines. All NT threads of the
// block call it; it ends with a barrier, after which the block may
// attend the committed pages through q_rot.
template <typename TQ, int KIND, int DK, int NT>
__device__ void rope_and_commit(const CommitArgs& f, int r, int h) {
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
  rope_commit_kv<TQ, KIND, DK, NT>(f, r, h);  // its first barrier covers q_rot too
}

}  // namespace fft
