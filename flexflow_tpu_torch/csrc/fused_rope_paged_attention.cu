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
// Steps 1 and 2 live in paged_commit.cuh, shared with whole_step_decode.cu.
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
#include "paged_commit.cuh"

namespace fft {
namespace {

using FusedArgs = CommitArgs;

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
  f.phys = nullptr;
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
