// fused_rope_paged_attention — RoPE, the in-place commit of the new K/V
// lines into their pages, and ragged paged attention, in one launch, for
// sm_90a.
//
// Replaces the Pallas TPU kernel flexflow_tpu/serve/kernels.py
// fused_rope_paged_attention (fused_kernel and _quant_commit of
// _build_ragged_paged_kernel). Same function, in three steps:
//  1. rotate-half RoPE of q (R, C, H, dk) and k_new (R, C, KV, dk) with
//     cos/sin (R, C, rot) f32: dims below rot rotate, the tail passes
//     through; no cos means no RoPE. Each element is rounded as the
//     unfused PyTorch path rounds it (x * cos and rotated * sin each to
//     f32, their sum to f32, then to the model dtype): __fmul_rn and
//     __fadd_rn keep nvcc from contracting them into an FMA;
//  2. the commit of line c of slot r at in-page offset off[r, c] of page
//     table[r, logical[r, c]], in place. Full-precision pools take the
//     rotated K and V as they are. Quantized pools run the arithmetic of
//     kv_quant.quant_line_write on the pages the row's lines touch:
//     offset-0 scale reset, running amax scale, codes of a page whose
//     scale grew requantized by rint(code * old / new), new lines
//     quantized by rint(v / max(s, 1e-30)) clipped to +-qmax; IEEE
//     division and round-half-to-even, so pool bytes and scales are
//     bitwise those of the unfused path;
//  3. the attention of ragged_paged_attention.cu (paged_attention.cuh),
//     over the pages as committed.
//
// Races designed around: one block per (slot, KV head) commits that
// head's slice of the slot's lines and then attends all C * G query rows
// of that head. Pages are slot-private and a KV head's slice of a page
// (its bytes and its scale) is touched by that head's block alone, so no
// block reads a line another block is writing. The one exception is the
// scratch page, which every padding line of every slot writes: its bytes
// are garbage, and only padding rows, whose outputs nobody reads, see
// them.
//
// Bound on an H100: that of ragged_paged_attention plus the q, k_new,
// v_new, cos and sin bytes read and the lines (and, quantized, the
// rescaled pages and scales) written.
//
// Design against that bound: the rotated K/V lines are committed
// straight from the block (the rotated q and K round-trip through two
// small buffers of the wrapper, a few KB per slot at decode), and the
// attention is ragged_paged_attention's. Decode launches R * KV blocks
// of 256 threads; a mixed step at C = 128 has the same R * KV blocks,
// each walking its 4 row tiles in turn: a quarter of the unfused
// kernel's blocks.
#include "paged_attention.cuh"

namespace fft {
namespace {

constexpr int kMaxChunk = 256;  // most lines per slot in one launch

struct FusedArgs {
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
  const int* logical;      // (R, C) logical page of each new line
  const int* off;          // (R, C) in-page offset of each new line
  int rot;
  float qmax;
};

// Element d of the RoPE of head row x, rounded to TQ.
template <typename TQ>
__device__ __forceinline__ TQ rope_at(const TQ* x, int d, const float* cs,
                                      const float* sn, int rot) {
  if (cs == nullptr || d >= rot) return x[d];
  const int half = rot / 2;
  const float xd = to_f32<TQ>(x[d]);
  const float partner = d < half ? -to_f32<TQ>(x[d + half]) : to_f32<TQ>(x[d - half]);
  return from_f32<TQ>(__fadd_rn(__fmul_rn(xd, cs[d]), __fmul_rn(partner, sn[d])));
}

__device__ __forceinline__ uint8_t pack_pair(float lo, float hi) {
  return uint8_t(((int)lo + 8) | (((int)hi + 8) << 4));
}

// kv_quant.quant_line_write for KV head h of slot r's C lines ``vals``
// (R, C, KV, dk) TQ, restricted to the pages those lines touch.
template <typename TQ, int KIND, int DK, int NT>
__device__ void commit_quant(const FusedArgs& f, int r, int h, const TQ* vals,
                             void* pool, float* scale) {
  __shared__ float sLq[kMaxChunk];    // line amax / qmax
  __shared__ int sPage[kMaxChunk];    // physical page of the line
  __shared__ int sLead[kMaxChunk];    // first line of the same page
  __shared__ float sNew[kMaxChunk];   // the page's new scale, at its first line
  __shared__ float sRatio[kMaxChunk]; // old / new, at its first line
  constexpr int kWarps = NT / 32;
  constexpr int DKP = DK / pack_of<KIND>();
  const PagedArgs& a = f.a;
  const int C = a.C, tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const float qmax = f.qmax;
  const TQ* rowv = vals + ((size_t)r * C * a.KV + h) * DK;  // line c at c * KV * DK
  const size_t line_stride = (size_t)a.KV * DK;
  const int* lg = f.logical + (size_t)r * C;
  const int* of = f.off + (size_t)r * C;

  for (int c = warp; c < C; c += kWarps) {
    float mx = 0.f;
    for (int d = lane; d < DK; d += 32) mx = fmaxf(mx, fabsf(to_f32<TQ>(rowv[c * line_stride + d])));
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    if (lane == 0) sLq[c] = __fdiv_rn(mx, qmax);
  }
  for (int c = tid; c < C; c += NT) sPage[c] = a.table[(size_t)r * a.NP + lg[c]];
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

  // requantize the codes of every touched page whose scale moved
  for (int c = 0; c < C; ++c) {  // block-uniform
    if (sLead[c] != c || sRatio[c] == 1.f) continue;  // rint(code * 1) == code
    const float ratio = sRatio[c];
    const size_t base = pool_row<KIND, DK>(sPage[c], 0, h, a.ps, a.KV);
    for (int idx = tid; idx < a.ps * DKP; idx += NT) {
      const size_t at = base + (size_t)(idx / DKP) * a.KV * DKP + idx % DKP;
      if constexpr (KIND == kPoolInt8) {
        int8_t* p = static_cast<int8_t*>(pool);
        p[at] = (int8_t)rintf(__fmul_rn(float(p[at]), ratio));
      } else {
        uint8_t* p = static_cast<uint8_t*>(pool);
        const uint8_t b = p[at];
        const float lo = rintf(__fmul_rn(float(int(b & 0xF) - 8), ratio));
        const float hi = rintf(__fmul_rn(float(int((b >> 4) & 0xF) - 8), ratio));
        p[at] = pack_pair(lo, hi);
      }
    }
  }
  __syncthreads();

  // quantize the new lines at their page's final scale
  for (int idx = tid; idx < C * DKP; idx += NT) {
    const int c = idx / DKP, j = idx % DKP;
    const float den = fmaxf(sNew[sLead[c]], 1e-30f);
    const size_t at = pool_row<KIND, DK>(sPage[c], of[c], h, a.ps, a.KV) + j;
    const TQ* v = rowv + c * line_stride;
    const float x = fminf(fmaxf(rintf(__fdiv_rn(to_f32<TQ>(v[j]), den)), -qmax), qmax);
    if constexpr (KIND == kPoolInt8) {
      static_cast<int8_t*>(pool)[at] = (int8_t)x;
    } else {
      const float y =
          fminf(fmaxf(rintf(__fdiv_rn(to_f32<TQ>(v[j + DK / 2]), den)), -qmax), qmax);
      static_cast<uint8_t*>(pool)[at] = pack_pair(x, y);
    }
  }
  for (int c = tid; c < C; c += NT) {
    if (sLead[c] == c) scale[(size_t)sPage[c] * a.KV + h] = sNew[c];
  }
  __syncthreads();
}

// Steps 1 and 2 for KV head h of slot r.
template <typename TQ, int KIND, int DK, int NT>
__device__ void rope_and_commit(const FusedArgs& f, int r, int h) {
  const PagedArgs& a = f.a;
  const int G = a.H / a.KV, C = a.C, tid = threadIdx.x;
  const TQ* qin = static_cast<const TQ*>(f.q_raw);
  const TQ* kin = static_cast<const TQ*>(f.k_new);
  const TQ* vin = static_cast<const TQ*>(f.v_new);
  TQ* qo = static_cast<TQ*>(f.q_rot);
  TQ* ko = static_cast<TQ*>(f.k_rot);

  for (int idx = tid; idx < C * G * DK; idx += NT) {
    const int d = idx % DK, cg = idx / DK, c = cg / G, g = cg % G;
    const size_t rc = (size_t)r * C + c;
    const size_t row = (rc * a.H + (size_t)h * G + g) * DK;
    const float* cs = f.cos ? f.cos + rc * f.rot : nullptr;
    const float* sn = f.sin ? f.sin + rc * f.rot : nullptr;
    qo[row + d] = rope_at<TQ>(qin + row, d, cs, sn, f.rot);
  }
  for (int idx = tid; idx < C * DK; idx += NT) {
    const int d = idx % DK, c = idx / DK;
    const size_t rc = (size_t)r * C + c;
    const size_t row = (rc * a.KV + h) * DK;
    const float* cs = f.cos ? f.cos + rc * f.rot : nullptr;
    const float* sn = f.sin ? f.sin + rc * f.rot : nullptr;
    ko[row + d] = rope_at<TQ>(kin + row, d, cs, sn, f.rot);
  }
  __syncthreads();

  if constexpr (KIND == kPoolFloat) {
    TQ* kp = static_cast<TQ*>(f.k_pool);
    TQ* vp = static_cast<TQ*>(f.v_pool);
    for (int idx = tid; idx < C * DK; idx += NT) {
      const int d = idx % DK, c = idx / DK;
      const size_t rc = (size_t)r * C + c;
      const int page = a.table[(size_t)r * a.NP + f.logical[rc]];
      const size_t dst = pool_row<KIND, DK>(page, f.off[rc], h, a.ps, a.KV) + d;
      const size_t src = (rc * a.KV + h) * DK + d;
      kp[dst] = ko[src];
      vp[dst] = vin[src];
    }
  } else {
    commit_quant<TQ, KIND, DK, NT>(f, r, h, ko, f.k_pool, f.k_scale);
    commit_quant<TQ, KIND, DK, NT>(f, r, h, vin, f.v_pool, f.v_scale);
  }
  __syncthreads();  // the attention reads the committed pages and q_rot
}

// GB > 0: the decode design with GB rows per call; GB == 0: the tile design.
template <typename TQ, int KIND, int DK, int GB>
__global__ void __launch_bounds__(GB > 0 ? kDecodeThreads : kTileThreads)
fused_kernel(FusedArgs f) {
  constexpr int NT = GB > 0 ? kDecodeThreads : kTileThreads;
  const int h = blockIdx.x, r = blockIdx.y;
  rope_and_commit<TQ, KIND, DK, NT>(f, r, h);
  const int rows = f.a.C * (f.a.H / f.a.KV);
  if constexpr (GB > 0) {
    for (int i0 = 0; i0 < rows; i0 += GB) attend_decode<TQ, KIND, DK, GB>(f.a, r, h, i0);
  } else {
    extern __shared__ __align__(16) float smem[];
    for (int row0 = 0; row0 < rows; row0 += kTileRows)
      attend_tile<TQ, KIND, DK>(f.a, r, h, row0, smem);
  }
}

template <typename TQ, int KIND, int DK>
cudaError_t launch_dk(const FusedArgs& f, cudaStream_t stream) {
  const int rows = f.a.C * (f.a.H / f.a.KV);
  const dim3 grid(f.a.KV, f.a.R);
  if (rows == 1) {
    fused_kernel<TQ, KIND, DK, 1><<<grid, kDecodeThreads, 0, stream>>>(f);
  } else if (rows <= kDecodeRows) {
    fused_kernel<TQ, KIND, DK, kDecodeRows><<<grid, kDecodeThreads, 0, stream>>>(f);
  } else {
    constexpr size_t kSmem = TileSmem<DK>::kBytes;
    cudaError_t err = cudaFuncSetAttribute(
        fused_kernel<TQ, KIND, DK, 0>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmem);
    if (err != cudaSuccess) return err;
    fused_kernel<TQ, KIND, DK, 0><<<grid, kTileThreads, kSmem, stream>>>(f);
  }
  return cudaGetLastError();
}

template <typename TQ, int KIND>
cudaError_t launch_kind(const FusedArgs& f, int dk, cudaStream_t stream) {
  if (dk == 64) return launch_dk<TQ, KIND, 64>(f, stream);
  if (dk == 128) return launch_dk<TQ, KIND, 128>(f, stream);
  return cudaErrorInvalidValue;
}

template <typename TQ>
cudaError_t launch_q(const FusedArgs& f, int dk, int pool_kind, cudaStream_t stream) {
  if (pool_kind == kPoolFloat) return launch_kind<TQ, kPoolFloat>(f, dk, stream);
  if (pool_kind == kPoolInt8) return launch_kind<TQ, kPoolInt8>(f, dk, stream);
  if (pool_kind == kPoolInt4) return launch_kind<TQ, kPoolInt4>(f, dk, stream);
  return cudaErrorInvalidValue;
}

}  // namespace
}  // namespace fft

extern "C" int fused_rope_paged_attention_launch(
    const void* q, const void* k_new, const void* v_new, const void* cos,
    const void* sin, void* k_pool, void* v_pool, void* k_scale, void* v_scale,
    const void* table, const void* logical, const void* off, const void* mask,
    void* out, void* q_rot, void* k_rot, int R, int C, int H, int KV, int dk,
    int ps, int NP, int rot, int dtype, int pool_kind, float scale, float qmax,
    void* stream) {
  if (R <= 0 || C <= 0 || C > fft::kMaxChunk || KV <= 0 || NP <= 0 || H % KV != 0)
    return (int)cudaErrorInvalidValue;
  if (ps != 16 && ps != 32 && ps != 64 && ps != 128) return (int)cudaErrorInvalidValue;
  if ((cos == nullptr) != (sin == nullptr)) return (int)cudaErrorInvalidValue;
  if (cos != nullptr && (rot <= 0 || rot > dk || rot % 2 != 0)) return (int)cudaErrorInvalidValue;
  if (pool_kind != fft::kPoolFloat && (k_scale == nullptr || v_scale == nullptr))
    return (int)cudaErrorInvalidValue;
  fft::FusedArgs f;
  f.a = fft::PagedArgs{q_rot, k_pool, v_pool, static_cast<const float*>(k_scale),
                       static_cast<const float*>(v_scale), static_cast<const int*>(table),
                       static_cast<const uint8_t*>(mask), out, R, C, H, KV, ps, NP, scale};
  f.q_raw = q;
  f.k_new = k_new;
  f.v_new = v_new;
  f.cos = static_cast<const float*>(cos);
  f.sin = static_cast<const float*>(sin);
  f.k_pool = k_pool;
  f.v_pool = v_pool;
  f.k_scale = static_cast<float*>(k_scale);
  f.v_scale = static_cast<float*>(v_scale);
  f.q_rot = q_rot;
  f.k_rot = k_rot;
  f.logical = static_cast<const int*>(logical);
  f.off = static_cast<const int*>(off);
  f.rot = rot;
  f.qmax = qmax;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == fft::kBFloat16) {
    err = fft::launch_q<__nv_bfloat16>(f, dk, pool_kind, s);
  } else if (dtype == fft::kFloat32) {
    err = fft::launch_q<float>(f, dk, pool_kind, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return (int)err;
}

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
