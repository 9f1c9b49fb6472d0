// ragged_paged_attention — C query tokens per request slot against its KV
// pages, read through the slot's page table, for sm_90a.
//
// Replaces the Pallas TPU kernel flexflow_tpu/serve/kernels.py
// ragged_paged_attention (plain_kernel of _build_ragged_paged_kernel).
// Same function: q (R, C, H, dk) attends the lines of the page pools
// (P + 1, ps, KV, dk / pack) that mask (R, C, NP * ps) allows, line s of
// slot r living at line s % ps of page table[r, s / ps]; pools in q's
// dtype (float32, bf16), int8 codes or packed int4 codes with per-page,
// per-KV-head f32 scales; a row with nothing to attend gives 0. One
// kernel serves decode (C = 1) and the mixed prefill step (C up to
// prefill_chunk). paged_attention.cuh holds the loop and its three block
// designs.
//
// Bound on an H100: the larger of
//  * bytes: the pages the mask opens, 2 * pages * ps * KV * (dk / pack)
//    * itemsize, plus scales, table, mask and q/out, over 3.35 TB/s;
//  * operations: 4 * (attended (row, line) pairs) * G * dk FLOP, over the
//    rate of the unit that runs them: bf16 tensor cores 989 TFLOP/s; for
//    f32 q the TF32 tensor cores' 494.7 TFLOP/s three times over (3xTF32:
//    each f32 product is three TF32 products; the f32 CUDA cores' 67
//    TFLOP/s would be 2.5 times longer).
// Decode steps are bound by bytes. A mixed step at C = 128 is bound by
// bytes on bf16 pools and by operations on int8 and int4 pools (1/2 and
// 1/4 of the bytes, the same FLOP) and f32 ones.
//
// Design against that bound (paged_design picks the block design):
//  * Pages or tiles no row of a block attends are skipped after a look at
//    their mask bits, before their K/V are read. The TPU kernel DMAs
//    every page and skips only the compute.
//  * Decode ("decode", C * G <= 8): the split design of paged_decode.cuh.
//    One block of 4 warps per (slot, KV head, split of whole pages), the
//    split's mask bits, page ids and scales staged first, every K/V line
//    read once for all query rows of its group in 16-byte loads, each
//    split's partial softmax merged in split order by the last block of
//    its (slot, KV head).
//  * bf16 mixed steps ("mma"): one block of 8 warps per (slot, KV head,
//    128 rows), ceil(C * G / 128) row blocks on the grid. Each K/V tile of
//    64 lines is read once for the block's 128 rows, by cp.async into one
//    of three shared buffers, two copies in flight while the tensor cores
//    (mma.sync, bf16 in, f32 accumulators) multiply the third; int8 and
//    int4 codes are widened to bf16 codes in shared memory, so the
//    quantized pools move 1/2 and 1/4 of the bf16 bytes and the page
//    scales multiply the scores and the probabilities, never the K/V
//    elements.
//  * f32 mixed steps ("tf32x3"): the same block on f32 tiles, QK^T and PV
//    on mma.sync m16n8k8 TF32 with every f32 operand split into TF32
//    hi + lo (3xTF32; quantized codes are exact in TF32 and not split).
//    One TF32 product per f32 product misses the f32 tolerance of 1e-5
//    7-12 times over, a split of one of the two products 5-6 times; with
//    both split the result is within ~2e-7 of f32
//    (tests/test_torch_tf32_split.py emulates the three).
//  * The mixed-step tiles take no wgmma, TMA or split over the cache yet:
//    those are later work (wgmma takes TF32 operands from shared memory
//    K-major only, so V would be transposed on the way in).
#include <type_traits>

#include "paged_decode.cuh"

namespace fft {
namespace {

// The decode design: split blockIdx.x of KV head blockIdx.y of slot
// blockIdx.z, its C * G <= GB query rows.
template <typename TQ, int KIND, int DK, int GB>
__global__ void __launch_bounds__(kSplitThreads, kSplitMinBlocks<KIND, GB>)
    ragged_split_kernel(PagedArgs a, SplitArgs s) {
  __shared__ SplitSmem<DK, GB, kSplitWarps, true> sm;
  TQ* sQ = split_q_rows<TQ, DK, GB>();
  const int r = blockIdx.z, h = blockIdx.y;
  stage_q<TQ, DK>(a, r, h, static_cast<const TQ*>(a.q), nullptr, nullptr, 0, sQ);
  const PagedLines<false> ln{a, r, h, 0, a.C * (a.H / a.KV)};
  attend_split<TQ, KIND, DK, GB, kSplitWarps>(ln, s, blockIdx.x, sQ, sm);
}

// The tensor-core designs: "mma" (bf16 q) and "tf32x3" (f32 q).
template <typename TQ, int KIND, int DK>
__global__ void __launch_bounds__(kMmaTileThreads, 1) ragged_mma_kernel(PagedArgs a) {
  extern __shared__ __align__(16) unsigned char smem_mma[];
  attend_tile_mma<TQ, KIND, DK>(a, blockIdx.z, blockIdx.y, blockIdx.x * kMmaTileRows, smem_mma);
}

template <typename TQ, int KIND, int DK, int GB>
cudaError_t launch_split(const PagedArgs& a, const SplitArgs& s, cudaStream_t stream) {
  constexpr int kQBytes = split_q_dyn_bytes<TQ, DK, GB>();
  if (kQBytes > 0) {
    cudaError_t err = cudaFuncSetAttribute(ragged_split_kernel<TQ, KIND, DK, GB>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, kQBytes);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(s.nsplit, a.KV, a.R);
  ragged_split_kernel<TQ, KIND, DK, GB><<<grid, kSplitThreads, kQBytes, stream>>>(a, s);
  return cudaSuccess;
}

template <typename TQ, int KIND, int DK>
cudaError_t launch_dk(const PagedArgs& a, const SplitArgs& s, cudaStream_t stream) {
  constexpr bool kBf16 = std::is_same<TQ, __nv_bfloat16>::value;
  const int rows = a.C * (a.H / a.KV);
  const int design = paged_design(rows, kBf16 ? kBFloat16 : kFloat32);
  if (design == kDesignDecode) {
    cudaError_t err;
    if (rows == 1) {
      err = launch_split<TQ, KIND, DK, 1>(a, s, stream);
    } else if (rows <= 4) {  // G = 2, 4: 1.4-1.8 x faster than at 8 rows (H100)
      err = launch_split<TQ, KIND, DK, 4>(a, s, stream);
    } else {
      err = launch_split<TQ, KIND, DK, kDecodeRows>(a, s, stream);
    }
    if (err != cudaSuccess) return err;
  } else {  // kDesignMma (bf16 q), kDesignTf32x3 (f32 q)
    constexpr size_t kSmem = MmaSmem<TQ, KIND, DK>::kBytes;
    cudaError_t err = cudaFuncSetAttribute(
        ragged_mma_kernel<TQ, KIND, DK>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)kSmem);
    if (err != cudaSuccess) return err;
    dim3 grid((rows + kMmaTileRows - 1) / kMmaTileRows, a.KV, a.R);
    ragged_mma_kernel<TQ, KIND, DK><<<grid, kMmaTileThreads, kSmem, stream>>>(a);
  }
  return cudaGetLastError();
}

template <typename TQ, int KIND>
cudaError_t launch_kind(const PagedArgs& a, const SplitArgs& s, int dk, cudaStream_t stream) {
  if (dk == 64) return launch_dk<TQ, KIND, 64>(a, s, stream);
  if (dk == 80) return launch_dk<TQ, KIND, 80>(a, s, stream);
  if (dk == 128) return launch_dk<TQ, KIND, 128>(a, s, stream);
  if (dk == 256) return launch_dk<TQ, KIND, 256>(a, s, stream);
  return cudaErrorInvalidValue;
}

template <typename TQ>
cudaError_t launch_q(const PagedArgs& a, const SplitArgs& s, int dk, int pool_kind,
                     cudaStream_t stream) {
  if (pool_kind == kPoolFloat) return launch_kind<TQ, kPoolFloat>(a, s, dk, stream);
  if (pool_kind == kPoolInt8) return launch_kind<TQ, kPoolInt8>(a, s, dk, stream);
  if (pool_kind == kPoolInt4) return launch_kind<TQ, kPoolInt4>(a, s, dk, stream);
  return cudaErrorInvalidValue;
}

}  // namespace
}  // namespace fft

// ws and counters: the decode design's workspace (SplitArgs), null when
// it takes one split (split_pages >= NP) or the launch takes another
// design; more than one split needs C == 1.
extern "C" int ragged_paged_attention_launch(
    const void* q, const void* k_pool, const void* v_pool, const void* k_scale,
    const void* v_scale, const void* table, const void* mask, void* out, void* ws,
    void* counters, int R, int C, int H, int KV, int dk, int ps, int NP, int dtype,
    int pool_kind, int split_pages, float scale, void* stream) {
  if (R <= 0 || C <= 0 || KV <= 0 || NP <= 0 || H % KV != 0) return (int)cudaErrorInvalidValue;
  if (ps != 16 && ps != 32 && ps != 64 && ps != 128) return (int)cudaErrorInvalidValue;
  if (pool_kind != fft::kPoolFloat && (k_scale == nullptr || v_scale == nullptr))
    return (int)cudaErrorInvalidValue;
  if (split_pages <= 0) return (int)cudaErrorInvalidValue;
  const int nsplit = (NP + split_pages - 1) / split_pages;
  if (nsplit > fft::kSplitMaxSplits) return (int)cudaErrorInvalidValue;
  if (nsplit > 1 && (C != 1 || ws == nullptr || counters == nullptr))
    return (int)cudaErrorInvalidValue;
  fft::PagedArgs a{q, k_pool, v_pool, static_cast<const float*>(k_scale),
                   static_cast<const float*>(v_scale), static_cast<const int*>(table),
                   static_cast<const uint8_t*>(mask), out, R, C, H, KV, ps, NP, scale};
  const fft::SplitArgs sp{static_cast<float*>(ws), static_cast<int*>(counters), split_pages,
                          nsplit};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == fft::kBFloat16) {
    err = fft::launch_q<__nv_bfloat16>(a, sp, dk, pool_kind, s);
  } else if (dtype == fft::kFloat32) {
    err = fft::launch_q<float>(a, sp, dk, pool_kind, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return (int)err;
}

// The block design (0 decode, 1 mma, 2 tf32x3) the launcher takes for
// these shapes and q dtype.
extern "C" int ragged_paged_attention_design(int C, int H, int KV, int dtype) {
  return fft::paged_design(C * (H / (KV > 0 ? KV : 1)), dtype);
}

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
