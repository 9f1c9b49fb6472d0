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
// Races designed around: pages are slot-private and a KV head's slice of
// a page (its bytes and its scale) is written by one block alone, which
// is the only block of the launch that reads it. The mixed-step designs
// run one block per (slot, KV head), which commits that head's slice of
// the slot's lines and then attends all C * G query rows of that head.
// The decode design (paged_decode.cuh) runs one block per (slot, KV head,
// split of whole pages); at C = 1 the block whose split holds the page of
// the new line commits it (on quantized pools with the rescale of that
// whole page) before it attends, and no other block reads that page; at
// C > 1 the split rule gives one split per (slot, KV head). Every block
// rotates its own copy of the query rows into shared memory, so no block
// waits on another. No block writes the scratch page, where every
// padding line points: those lines are not committed, so the padding
// rows that read it (their outputs nobody reads) see a page that no block
// of the launch writes. The mma design
// reads the pages by cp.async.cg, through L2: the barrier that ends
// rope_and_commit makes every thread's committed stores visible to the
// whole block, those reads included.
//
// Bound on an H100: that of ragged_paged_attention plus the q, k_new,
// v_new, cos and sin bytes read and the lines (and, quantized, the
// rescaled pages and scales) written.
//
// Design against that bound: the rotated K/V lines are committed
// straight from the block (the rotated K, and on mixed steps q,
// round-trip through small buffers of the wrapper; on quantized pools by
// the block's commit_quant_block, in the tile's dynamic shared memory
// before the tile uses it, or in the split design in at most 420 bytes of
// static shared memory, lean in its one-row blocks), and the attention is
// ragged_paged_attention's, in the design the ragged launcher would take
// (paged_design) with the same split rule. Decode launches R * KV *
// nsplit blocks of 128 threads (attend_split). A mixed step (bf16 q "mma", f32 q "tf32x3") launches
// R * KV blocks of 8 warps that walk ceil(C * G / 128) passes of
// attend_tile_mma (one at C = 128, G = 1): each pass is the ragged
// kernel's row block, its rows on the same warps, so the output of every
// row that reads no scratch line is bitwise the ragged kernel's.
#include <type_traits>

#include "paged_decode.cuh"

namespace fft {
namespace {

using FusedArgs = CommitArgs;

constexpr int kMaxPageLines = 128;  // the launcher's largest page

// The commit's shared memory in the split design of GB rows (C * G <= GB,
// so at most GB lines a slot): static, on quantized pools only.
template <int KIND, int GB>
__device__ __forceinline__ void* split_commit_ws() {
  if constexpr (KIND == kPoolFloat) {
    return nullptr;
  } else {
    __shared__ __align__(16) unsigned char ws[commit_smem_bytes(GB, kMaxPageLines)];
    return ws;
  }
}

// The decode design: split blockIdx.x of KV head blockIdx.y of slot
// blockIdx.z, its C * G <= GB query rows; the block whose split holds the
// pages of the new lines (every block, with one split) commits them first.
template <typename TQ, int KIND, int DK, int GB>
__global__ void __launch_bounds__(kSplitThreads, kSplitMinBlocks<KIND, GB>)
    fused_split_kernel(FusedArgs f, SplitArgs s) {
  __shared__ SplitSmem<DK, GB, kSplitWarps, true> sm;
  TQ* sQ = split_q_rows<TQ, DK, GB>();
  const int r = blockIdx.z, h = blockIdx.y, split = blockIdx.x;
  stage_q<TQ, DK>(f.a, r, h, static_cast<const TQ*>(f.q_raw), f.cos, f.sin, f.rot, sQ);
  bool commits = s.nsplit == 1;
  if (!commits) {  // C == 1
    const int page = f.logical[r];
    commits = page >= split * s.split_len && page < (split + 1) * s.split_len;
  }
  if (commits)
    rope_commit_kv<TQ, KIND, DK, kSplitThreads, GB == 1>(f, r, h, split_commit_ws<KIND, GB>());
  const PagedLines<false> ln{f.a, r, h, 0, f.a.C * (f.a.H / f.a.KV)};
  attend_split<TQ, KIND, DK, GB, kSplitWarps>(ln, s, split, sQ, sm);
}

// The tensor-core designs ("mma": bf16 q, "tf32x3": f32 q): every 128-row
// pass of the slot's KV head.
template <typename TQ, int KIND, int DK>
__global__ void __launch_bounds__(kMmaTileThreads, 1) fused_mma_kernel(FusedArgs f) {
  extern __shared__ __align__(16) unsigned char smem_mma[];
  const int h = blockIdx.x, r = blockIdx.y;
  static_assert(KIND == kPoolFloat ||
                    MmaSmem<TQ, KIND, DK>::kBytes >= commit_smem_bytes(kMaxChunk, kMaxPageLines),
                "the tile's shared memory holds the commit's");
  rope_and_commit<TQ, KIND, DK, kMmaTileThreads>(f, r, h, smem_mma);
  const int rows = f.a.C * (f.a.H / f.a.KV);
  for (int row0 = 0; row0 < rows; row0 += kMmaTileRows)
    attend_tile_mma<TQ, KIND, DK>(f.a, r, h, row0, smem_mma);
}

template <typename TQ, int KIND, int DK, int GB>
cudaError_t launch_split(const FusedArgs& f, const SplitArgs& s, cudaStream_t stream) {
  constexpr int kQBytes = split_q_dyn_bytes<TQ, DK, GB>();
  if (kQBytes > 0) {
    cudaError_t err = cudaFuncSetAttribute(fused_split_kernel<TQ, KIND, DK, GB>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, kQBytes);
    if (err != cudaSuccess) return err;
  }
  const dim3 sgrid(s.nsplit, f.a.KV, f.a.R);
  fused_split_kernel<TQ, KIND, DK, GB><<<sgrid, kSplitThreads, kQBytes, stream>>>(f, s);
  return cudaSuccess;
}

template <typename TQ, int KIND, int DK>
cudaError_t launch_dk(const FusedArgs& f, const SplitArgs& s, cudaStream_t stream) {
  constexpr bool kBf16 = std::is_same<TQ, __nv_bfloat16>::value;
  const int rows = f.a.C * (f.a.H / f.a.KV);
  const int design = paged_design(rows, kBf16 ? kBFloat16 : kFloat32);
  const dim3 grid(f.a.KV, f.a.R);
  if (design == kDesignDecode) {
    cudaError_t err;
    if (rows == 1) {
      err = launch_split<TQ, KIND, DK, 1>(f, s, stream);
    } else if (rows <= 4) {  // G = 2, 4: 1.4-1.8 x faster than at 8 rows (H100)
      err = launch_split<TQ, KIND, DK, 4>(f, s, stream);
    } else {
      err = launch_split<TQ, KIND, DK, kDecodeRows>(f, s, stream);
    }
    if (err != cudaSuccess) return err;
  } else {  // kDesignMma (bf16 q), kDesignTf32x3 (f32 q)
    constexpr size_t kSmem = MmaSmem<TQ, KIND, DK>::kBytes;
    cudaError_t err = cudaFuncSetAttribute(
        fused_mma_kernel<TQ, KIND, DK>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmem);
    if (err != cudaSuccess) return err;
    fused_mma_kernel<TQ, KIND, DK><<<grid, kMmaTileThreads, kSmem, stream>>>(f);
  }
  return cudaGetLastError();
}

template <typename TQ, int KIND>
cudaError_t launch_kind(const FusedArgs& f, const SplitArgs& s, int dk, cudaStream_t stream) {
  if (dk == 64) return launch_dk<TQ, KIND, 64>(f, s, stream);
  if (dk == 80) return launch_dk<TQ, KIND, 80>(f, s, stream);
  if (dk == 128) return launch_dk<TQ, KIND, 128>(f, s, stream);
  if (dk == 256) return launch_dk<TQ, KIND, 256>(f, s, stream);
  return cudaErrorInvalidValue;
}

template <typename TQ>
cudaError_t launch_q(const FusedArgs& f, const SplitArgs& s, int dk, int pool_kind,
                     cudaStream_t stream) {
  if (pool_kind == kPoolFloat) return launch_kind<TQ, kPoolFloat>(f, s, dk, stream);
  if (pool_kind == kPoolInt8) return launch_kind<TQ, kPoolInt8>(f, s, dk, stream);
  if (pool_kind == kPoolInt4) return launch_kind<TQ, kPoolInt4>(f, s, dk, stream);
  return cudaErrorInvalidValue;
}

}  // namespace
}  // namespace fft

// ws and counters: the decode design's workspace (SplitArgs), null when
// it takes one split (split_pages >= NP) or the launch takes another
// design; more than one split needs C == 1.
extern "C" int fused_rope_paged_attention_launch(
    const void* q, const void* k_new, const void* v_new, const void* cos,
    const void* sin, void* k_pool, void* v_pool, void* k_scale, void* v_scale,
    const void* table, const void* logical, const void* off, const void* mask,
    void* out, void* q_rot, void* k_rot, void* ws, void* counters, int R, int C, int H,
    int KV, int dk, int ps, int NP, int P1, int rot, int dtype, int pool_kind, int split_pages,
    float scale, float qmax, void* stream) {
  if (R <= 0 || C <= 0 || C > fft::kMaxChunk || KV <= 0 || NP <= 0 || H % KV != 0)
    return (int)cudaErrorInvalidValue;
  if (ps != 16 && ps != 32 && ps != 64 && ps != fft::kMaxPageLines || P1 <= 0)
    return (int)cudaErrorInvalidValue;
  if ((cos == nullptr) != (sin == nullptr)) return (int)cudaErrorInvalidValue;
  if (cos != nullptr && (rot <= 0 || rot > dk || rot % 2 != 0)) return (int)cudaErrorInvalidValue;
  if (pool_kind != fft::kPoolFloat && (k_scale == nullptr || v_scale == nullptr))
    return (int)cudaErrorInvalidValue;
  if (split_pages <= 0) return (int)cudaErrorInvalidValue;
  const int nsplit = (NP + split_pages - 1) / split_pages;
  if (nsplit > fft::kSplitMaxSplits) return (int)cudaErrorInvalidValue;
  if (nsplit > 1 && (C != 1 || ws == nullptr || counters == nullptr))
    return (int)cudaErrorInvalidValue;
  const fft::SplitArgs sp{static_cast<float*>(ws), static_cast<int*>(counters), split_pages,
                          nsplit};
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
  f.off = off;
  f.phys64 = f.off64 = false;
  f.scratch = P1 - 1;
  f.rot = rot;
  f.qmax = qmax;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == fft::kBFloat16) {
    err = fft::launch_q<__nv_bfloat16>(f, sp, dk, pool_kind, s);
  } else if (dtype == fft::kFloat32) {
    err = fft::launch_q<float>(f, sp, dk, pool_kind, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return (int)err;
}

// The block design (0 decode, 1 mma, 2 tf32x3) the launcher takes for
// these shapes and q dtype.
extern "C" int fused_rope_paged_attention_design(int C, int H, int KV, int dtype) {
  return fft::paged_design(C * (H / (KV > 0 ? KV : 1)), dtype);
}

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
