// paged_commit — the K/V commit of the unfused quantized paged step: the
// new K and V lines of every slot written into their int8 or int4 pages in
// place, in one launch a layer, for sm_90a.
//
// No TPU kernel of its own: the JAX package's unfused paged step commits
// with flexflow_tpu/serve/kv_quant.py quant_line_write, which XLA fuses;
// its fused kernel (serve/kernels.py fused_rope_paged_attention,
// _quant_commit) runs the same arithmetic in Pallas. The port's plain
// version is serve/kv_quant.quant_line_write (run for K, then for V),
// ~20 eager PyTorch operations each. Same function, bitwise: offset-0
// scale reset, running amax scale, codes of a page whose scale grew
// requantized by rint(code * old / new), new lines quantized by
// rint(v / max(s, 1e-30)) clipped to +-qmax (commit_quant_lines of
// paged_commit.cuh, which the fused and whole-step kernels run too).
//
// quant_line_write's two branches:
//  * R * C < P + 1: only the pages the new lines touch are requantized;
//    blocks (h, r) for r < R do that.
//  * R * C >= P + 1: the whole pool is requantized by old / new. Pages no
//    line touches keep their scale, so the ratio is exactly 1 (codes
//    unchanged) unless the scale is 0, where it is 0: their codes become
//    rint(code * 0) = 0 (int8 byte 0, int4 byte 0x88). ``sweep`` blocks
//    (h, R + i) do that for the untouched pages i, i + sweep, ...; a page
//    a line touches is left to its slot's block, so no two blocks write
//    one page.
//
// Pages are slot-private; the scratch page, which every padding line of
// every slot writes, is the one page several blocks write at once (its
// bytes are garbage, and only padding rows read them).
//
// Bound on an H100: bytes. The new lines read once (TQ), their code bytes
// written, and the touched pages' codes read and written when their scale
// grows (every step's first line of a page: offset-0 resets; on a decode
// step a growing scale rewrites one page a (slot, KV head)).
//
// Design: one block of 256 threads a (KV head, slot) commits K and then V
// (one launch a layer instead of ~40 PyTorch operations); the per-line
// arrays (5 x C words) are dynamic shared memory sized from C, so any
// chunk the unfused step takes fits up to kMaxCommitLines lines.
#include "paged_commit.cuh"

namespace fft {
namespace {

constexpr int kCommitThreads = 256;
constexpr int kMaxCommitLines = 232448 / 20;  // 5 words a line in 227 KB

// Zero the codes of KV head h of every page no new line touches and whose
// scale is 0 (quant_line_write's whole-pool branch, ratio 0).
template <int KIND, int DK>
__device__ void sweep_untouched(const CommitArgs& f, int h, int first, int stride, int P1) {
  constexpr int DKP = DK / pack_of<KIND>();
  constexpr uint8_t kZero = KIND == kPoolInt4 ? 0x88 : 0x00;
  const int lines = f.a.R * f.a.C;
  for (int page = first; page < P1; page += stride) {
    int touched = 0;
    for (int i = threadIdx.x; i < lines; i += kCommitThreads) touched |= f.phys[i] == page;
    if (__syncthreads_or(touched)) continue;
    const size_t sidx = (size_t)page * f.a.KV + h;
    for (int which = 0; which < 2; ++which) {
      const float* sc = which ? f.v_scale : f.k_scale;
      if (sc[sidx] != 0.f) continue;  // ratio 1: codes unchanged
      uint8_t* pool = static_cast<uint8_t*>(which ? f.v_pool : f.k_pool);
      for (int idx = threadIdx.x; idx < f.a.ps * DKP; idx += kCommitThreads)
        pool[pool_row<KIND, DK>(page, idx / DKP, h, f.a.ps, f.a.KV) + idx % DKP] = kZero;
    }
  }
}

template <typename TQ, int KIND, int DK>
__global__ void __launch_bounds__(kCommitThreads)
paged_commit_kernel(CommitArgs f, int P1, int sweep) {
  const int h = blockIdx.x, r = blockIdx.y;
  if (r >= f.a.R) {
    sweep_untouched<KIND, DK>(f, h, r - f.a.R, sweep, P1);
    return;
  }
  extern __shared__ __align__(16) unsigned char smem[];
  const int C = f.a.C;
  float* lq = reinterpret_cast<float*>(smem);
  int* page = reinterpret_cast<int*>(lq + C);
  int* lead = page + C;
  float* nw = reinterpret_cast<float*>(lead + C);
  float* ratio = nw + C;
  const CommitLines s{lq, page, lead, nw, ratio};
  commit_quant_lines<TQ, KIND, DK, kCommitThreads>(
      f, r, h, static_cast<const TQ*>(f.k_rot), f.k_pool, f.k_scale, s);
  commit_quant_lines<TQ, KIND, DK, kCommitThreads>(
      f, r, h, static_cast<const TQ*>(f.v_new), f.v_pool, f.v_scale, s);
}

template <typename TQ, int KIND, int DK>
cudaError_t launch(const CommitArgs& f, int P1, int sweep, cudaStream_t stream) {
  const size_t smem = 20 * size_t(f.a.C);
  cudaError_t err = cudaFuncSetAttribute(paged_commit_kernel<TQ, KIND, DK>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(f.a.KV, f.a.R + sweep);
  paged_commit_kernel<TQ, KIND, DK><<<grid, kCommitThreads, smem, stream>>>(f, P1, sweep);
  return cudaGetLastError();
}

template <typename TQ, int KIND>
cudaError_t launch_kind(const CommitArgs& f, int dk, int P1, int sweep, cudaStream_t s) {
  if (dk == 64) return launch<TQ, KIND, 64>(f, P1, sweep, s);
  if (dk == 128) return launch<TQ, KIND, 128>(f, P1, sweep, s);
  return cudaErrorInvalidValue;
}

template <typename TQ>
cudaError_t launch_q(const CommitArgs& f, int dk, int pool_kind, int P1, int sweep,
                     cudaStream_t s) {
  if (pool_kind == kPoolInt8) return launch_kind<TQ, kPoolInt8>(f, dk, P1, sweep, s);
  if (pool_kind == kPoolInt4) return launch_kind<TQ, kPoolInt4>(f, dk, P1, sweep, s);
  return cudaErrorInvalidValue;
}

}  // namespace
}  // namespace fft

// k, v (R, C, KV, dk) TQ; pools (P1, ps, KV, dk / pack) codes and scales
// (P1, KV) f32, written in place; phys, off (R, C) int32. ``whole_pool``:
// quant_line_write's R * C >= P1 branch (the untouched pages swept too).
extern "C" int paged_commit_launch(const void* k, const void* v, void* k_pool, void* v_pool,
                                   void* k_scale, void* v_scale, const void* phys,
                                   const void* off, int R, int C, int KV, int dk, int ps,
                                   int P1, int dtype, int pool_kind, int whole_pool,
                                   float qmax, void* stream) {
  if (R <= 0 || C <= 0 || C > fft::kMaxCommitLines || KV <= 0 || P1 <= 0 || ps <= 0 ||
      KV > 65535)
    return (int)cudaErrorInvalidValue;
  const int sweep = whole_pool ? (P1 < 1024 ? P1 : 1024) : 0;
  if (R + sweep > 65535) return (int)cudaErrorInvalidValue;
  fft::CommitArgs f = {};
  f.a.R = R;
  f.a.C = C;
  f.a.H = KV;
  f.a.KV = KV;
  f.a.ps = ps;
  f.a.NP = 0;
  f.k_rot = const_cast<void*>(k);  // the K lines to commit
  f.v_new = v;
  f.k_pool = k_pool;
  f.v_pool = v_pool;
  f.k_scale = static_cast<float*>(k_scale);
  f.v_scale = static_cast<float*>(v_scale);
  f.logical = nullptr;
  f.phys = static_cast<const int*>(phys);
  f.off = static_cast<const int*>(off);
  f.qmax = qmax;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == fft::kBFloat16) {
    err = fft::launch_q<__nv_bfloat16>(f, dk, pool_kind, P1, sweep, s);
  } else if (dtype == fft::kFloat32) {
    err = fft::launch_q<float>(f, dk, pool_kind, P1, sweep, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return (int)err;
}

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
