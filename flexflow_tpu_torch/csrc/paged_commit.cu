// paged_commit — the K/V commit of the unfused quantized paged step: the
// new K and V lines of every slot written into their int8 or int4 pages in
// place, in one launch a layer, for sm_90a.
//
// No TPU kernel of its own: the JAX package's unfused paged step commits
// with flexflow_tpu/serve/kv_quant.py quant_line_write, which XLA fuses;
// its fused kernel (serve/kernels.py fused_rope_paged_attention,
// _quant_commit) runs the same arithmetic in Pallas. The port's plain
// version is serve/kv_quant.quant_line_write (run for K, then for V),
// ~20 eager PyTorch operations each. Same function, bitwise on every page
// but the scratch page, whose lines are not committed: paged_commit.cuh.
//
// quant_line_write's two branches:
//  * R * C < P + 1: only the pages the new lines touch are requantized.
//  * R * C >= P + 1: the whole pool is requantized by old / new. Pages no
//    line touches keep their scale, so the ratio is exactly 1 (codes
//    unchanged) unless the scale is 0, where it is 0: their codes become
//    rint(code * 0) = 0 (int8 byte 0, int4 byte 0x88). ``sweep`` blocks,
//    each over a run of pages, learn which of their pages a line touches
//    in one pass over the lines (a bitmap in shared memory), then zero
//    the untouched pages' KV heads of scale 0 in 16-byte stores. A touched
//    page is left to the commit blocks, so no two blocks write one page.
//
// Bound on an H100: bytes. The new lines read once (TQ), their code bytes
// written, the touched pages' scales written, and the pages whose scale
// moved read and written (every offset-0 reset writes its page's other
// lines as zero codes, without a read).
//
// Design: one launch for K and V, phys and off read as the caller gives
// them (int64 from the unfused step, or int32).
//  * decode (C = 1): a warp a (slot, KV head, K or V) line,
//    commit_line_warp; eight lines a block of 256 threads, no barrier.
//  * C > 1: commit_quant_block in dynamic shared memory of
//    commit_smem_bytes(C, ps), 256 threads a block at four blocks an SM:
//    at C <= 32 (a tree step) a block a (slot, KV head) for K and V
//    together, above (a prefill chunk) a block a (slot, KV head, K or V),
//    so that K and V of one slot commit in parallel.
#include <algorithm>

#include "paged_commit.cuh"

namespace fft {
namespace {

constexpr int kCommitThreads = 256;
constexpr int kCommitWarps = kCommitThreads / 32;
constexpr int kSweepBlocks = 128;  // most sweep blocks of the whole-pool branch

// The sweep block ``j`` of ``len`` pages from page j * len (below the
// scratch page): the pages of its run that no line touches, in KV heads of
// scale 0, zeroed in K and V.
template <int KIND, int DK, int NT>
__device__ void sweep_untouched(const CommitArgs& f, int j, int len, unsigned* smem) {
  using U = LineUnits<float, KIND, DK>;
  using Vec = typename VecOf<U::kVec>::T;
  const PagedArgs& a = f.a;
  const int first = j * len, last = min(first + len, f.scratch), tid = threadIdx.x;
  const int words = (len + 31) / 32, zwords = (2 * a.KV + 31) / 32;
  unsigned* touched = smem;         // [words]: bit p - first, page p touched
  unsigned* zero = smem + words;    // [zwords]: bit t KV + h, scale of (page, h) in t is 0
  for (int i = tid; i < words; i += NT) touched[i] = 0u;
  __syncthreads();
  for (int i = tid; i < a.R * a.C; i += NT) {
    const int p = load_index(f.phys, f.phys64, i);
    if (p >= first && p < last) atomicOr(touched + (p - first) / 32, 1u << ((p - first) % 32));
  }
  const Vec zv = requant_vec<KIND>(Vec{}, 0.f);  // zero codes
  for (int page = first; page < last; ++page) {
    __syncthreads();  // touched is complete; the previous page's zero mask is read
    if ((touched[(page - first) / 32] >> ((page - first) % 32)) & 1u) continue;
    for (int i = tid; i < zwords; i += NT) zero[i] = 0u;
    __syncthreads();
    bool any = false;
    for (int i = tid; i < 2 * a.KV; i += NT) {
      const float* sc = i >= a.KV ? f.v_scale : f.k_scale;
      if (sc[(size_t)page * a.KV + i % a.KV] == 0.f) {
        atomicOr(zero + i / 32, 1u << (i % 32));
        any = true;
      }
    }
    if (!__syncthreads_or(any)) continue;
    const int per_tensor = a.ps * a.KV * U::kVecs;
    for (int idx = tid; idx < 2 * per_tensor; idx += NT) {
      const int t = idx / per_tensor, rem = idx % per_tensor;
      const int h = (rem / U::kVecs) % a.KV, i = t * a.KV + h;
      if (!((zero[i / 32] >> (i % 32)) & 1u)) continue;
      uint8_t* pool = static_cast<uint8_t*>(t ? f.v_pool : f.k_pool);
      *reinterpret_cast<Vec*>(pool + ((size_t)page * a.ps * a.KV) * U::kCodes +
                              (size_t)(rem / U::kVecs) * U::kCodes +
                              rem % U::kVecs * U::kVec) = zv;
    }
  }
}

// The forms of the kernel, chosen by C: kLines (C = 1), a warp a line,
// with registers to spare for its page rescale; kPair (C <= 32: a tree
// step's few lines), a block a (slot, KV head) commits K and V together,
// so that the grid's blocks are resident at once; kBlock (C > 32: a
// prefill chunk), a block a (slot, KV head, K or V). The block forms take
// 256 threads at four blocks an SM (64 registers a thread), so that a
// block's chain of phases (indices, lines, page maxima, scales, rescale
// and codes) hides behind the others'.
enum CommitForm : int { kLines = 0, kPair = 1, kBlock = 2 };
constexpr int kPairLines = 32;  // most lines a slot of the kPair form

// The form for C lines a slot (exported as paged_commit_design).
constexpr int commit_form(int C) { return C == 1 ? kLines : C <= kPairLines ? kPair : kBlock; }

template <typename TQ, int KIND, int DK, int FORM>
__global__ void __launch_bounds__(kCommitThreads, FORM == kLines ? 1 : 4)
paged_commit_kernel(CommitArgs f, int commit_blocks, int sweep_len) {
  constexpr int NT = kCommitThreads;
  extern __shared__ __align__(16) unsigned char smem[];
  const PagedArgs& a = f.a;
  const int b = blockIdx.x;
  if (b >= commit_blocks) {
    sweep_untouched<KIND, DK, NT>(f, b - commit_blocks, sweep_len,
                                  reinterpret_cast<unsigned*>(smem));
    return;
  }
  if constexpr (FORM == kLines) {  // (t, r, h), h fastest: neighbouring warps, neighbouring lines
    const int g = b * kCommitWarps + threadIdx.x / 32;
    if (g >= 2 * a.R * a.KV) return;
    const int t = g / (a.R * a.KV), r = g % (a.R * a.KV) / a.KV, h = g % a.KV;
    commit_line_warp<TQ, KIND, DK>(f, r, 0, h, static_cast<const TQ*>(t ? f.v_new : f.k_rot),
                                   t ? f.v_pool : f.k_pool, t ? f.v_scale : f.k_scale);
  } else if constexpr (FORM == kPair) {
    commit_quant_block<TQ, KIND, DK, NT, 2, LineUnits<TQ, KIND, DK>::kHold>(
        f, b / a.KV, b % a.KV, 0, commit_smem(smem, a.C, a.ps));
  } else {
    const int t = b % 2, h = b / 2 % a.KV, r = b / (2 * a.KV);
    commit_quant_block<TQ, KIND, DK, NT, 1, LineUnits<TQ, KIND, DK>::kHold>(
        f, r, h, t, commit_smem(smem, a.C, a.ps));
  }
}

template <typename TQ, int KIND, int DK, int FORM>
cudaError_t launch_form(const CommitArgs& f, int commit_blocks, int sweep, int sweep_len,
                        size_t smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(paged_commit_kernel<TQ, KIND, DK, FORM>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  paged_commit_kernel<TQ, KIND, DK, FORM>
      <<<commit_blocks + sweep, kCommitThreads, smem, stream>>>(f, commit_blocks, sweep_len);
  return cudaGetLastError();
}

template <typename TQ, int KIND, int DK>
cudaError_t launch(const CommitArgs& f, int P1, bool whole_pool, cudaStream_t stream) {
  const PagedArgs& a = f.a;
  const int form = commit_form(a.C);
  const int commit_blocks = form == kLines ? (2 * a.R * a.KV + kCommitWarps - 1) / kCommitWarps
                            : form == kPair ? a.R * a.KV
                                            : 2 * a.R * a.KV;
  const int pages = P1 - 1;  // below the scratch page
  const int sweep = whole_pool && pages > 0 ? std::min(pages, kSweepBlocks) : 0;
  const int sweep_len = sweep ? (pages + sweep - 1) / sweep : 0;
  size_t smem = form == kLines ? 0 : commit_smem_bytes(a.C, a.ps);
  if (sweep) smem = std::max(smem, 4 * size_t((sweep_len + 31) / 32 + (2 * a.KV + 31) / 32));
  if (smem > 232448) return cudaErrorInvalidValue;
  if (form == kLines)
    return launch_form<TQ, KIND, DK, kLines>(f, commit_blocks, sweep, sweep_len, smem, stream);
  if (form == kPair)
    return launch_form<TQ, KIND, DK, kPair>(f, commit_blocks, sweep, sweep_len, smem, stream);
  return launch_form<TQ, KIND, DK, kBlock>(f, commit_blocks, sweep, sweep_len, smem, stream);
}

template <typename TQ, int KIND>
cudaError_t launch_kind(const CommitArgs& f, int dk, int P1, bool whole, cudaStream_t s) {
  if (dk == 64) return launch<TQ, KIND, 64>(f, P1, whole, s);
  if (dk == 80) return launch<TQ, KIND, 80>(f, P1, whole, s);
  if (dk == 128) return launch<TQ, KIND, 128>(f, P1, whole, s);
  if (dk == 256) return launch<TQ, KIND, 256>(f, P1, whole, s);
  return cudaErrorInvalidValue;
}

template <typename TQ>
cudaError_t launch_q(const CommitArgs& f, int dk, int pool_kind, int P1, bool whole,
                     cudaStream_t s) {
  if (pool_kind == kPoolInt8) return launch_kind<TQ, kPoolInt8>(f, dk, P1, whole, s);
  if (pool_kind == kPoolInt4) return launch_kind<TQ, kPoolInt4>(f, dk, P1, whole, s);
  return cudaErrorInvalidValue;
}

}  // namespace
}  // namespace fft

// k, v (R, C, KV, dk) TQ; pools (P1, ps, KV, dk / pack) codes and scales
// (P1, KV) f32, written in place; phys, off (R, C), int64 where bit 0
// (phys) or bit 1 (off) of ``wide`` is set, else int32. ``whole_pool``:
// quant_line_write's R * C >= P1 branch (the untouched pages swept too).
// Page P1 - 1 is the scratch page.
extern "C" int paged_commit_launch(const void* k, const void* v, void* k_pool, void* v_pool,
                                   void* k_scale, void* v_scale, const void* phys,
                                   const void* off, int R, int C, int KV, int dk, int ps,
                                   int P1, int dtype, int pool_kind, int whole_pool, int wide,
                                   float qmax, void* stream) {
  if (R <= 0 || C <= 0 || KV <= 0 || P1 <= 0 || ps <= 0) return (int)cudaErrorInvalidValue;
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
  f.phys = phys;
  f.off = off;
  f.phys64 = (wide & 1) != 0;
  f.off64 = (wide & 2) != 0;
  f.scratch = P1 - 1;
  f.qmax = qmax;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == fft::kBFloat16)
    return (int)fft::launch_q<__nv_bfloat16>(f, dk, pool_kind, P1, whole_pool != 0, s);
  if (dtype == fft::kFloat32)
    return (int)fft::launch_q<float>(f, dk, pool_kind, P1, whole_pool != 0, s);
  return (int)cudaErrorInvalidValue;
}

// The form (CommitForm: 0 line-warp, 1 pair, 2 block) that
// paged_commit_launch takes for C lines a slot.
extern "C" int paged_commit_design(int C) { return fft::commit_form(C); }

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
