// decode_attention — one query token per request slot against its dense
// KV-cache prefix, for sm_90a.
//
// Replaces the Pallas TPU kernel flexflow_tpu/serve/kernels.py
// decode_attention (body _decode_kernel). Same function: q (R, H, dk)
// attends lines [0, seq_len) of k/v (R, S1, KV, dk); grouped-query heads
// h = kv * G + g share KV head kv; f32 online softmax; the denominator is
// clamped at 1e-20, so a slot with seq_len 0 writes zeros. Output in q's
// dtype (float32 or bfloat16).
//
// Bound on an H100: the bytes of the K/V lines read,
// 2 * sum(seq_len) * KV * dk * itemsize, over 3.35 TB/s. With one query
// token per line the arithmetic is ~2 FLOP per byte, far below the ~295
// FLOP/byte where the tensor cores would become the limit.
//
// Design against that bound: the port's one decode walk (attend_split,
// paged_decode.cuh) on dense addresses (DenseLines). One block of 4 warps
// per (slot, KV head, head group, split): a head group is the KV head's
// G query heads, or 8 of them when G > 8 (MQA: H 32 over KV 1 takes four
// groups on the grid's y axis); a split is split_len consecutive lines
// (kernels.dense_decode_split, from the shapes alone). Every K/V line is
// read once for the group's rows in 16-byte loads, several lines in
// flight a lane; the splits' partials merge in split order in the last
// block of a (slot, KV head, group). The walk reads only lines < seq_len:
// a split past them exits before any load, so a slot of length 0 (a
// padding row: models/llama.py gives it 0) costs one block that writes
// zeros. The TPU kernel DMAs every block of the cache and skips only the
// compute of invalid blocks.
#include "paged_decode.cuh"

namespace fft {
namespace {

struct DenseArgs {
  const void* q;         // (R, H, dk)
  const void* k;         // (R, S1, KV, dk)
  const void* v;
  const int* seq_lens;   // (R,)
  void* out;             // (R, H, dk)
  int R, S1, H, KV;
  float scale;
};

// Query heads a block takes for G query heads a KV head: 1, 4 or 8, in
// head groups of 8 when G > 8.
__host__ __device__ inline int dense_rows(int G) {
  return G == 1 ? 1 : G <= 4 ? 4 : kDecodeRows;
}

// Split blockIdx.x of head group blockIdx.y % groups of KV head
// blockIdx.y / groups of slot blockIdx.z.
template <typename TQ, int DK, int GB>
__global__ void __launch_bounds__(kSplitThreads, kSplitMinBlocks<kPoolFloat, GB>)
    dense_split_kernel(DenseArgs d, SplitArgs s) {
  __shared__ __align__(16) unsigned char sQraw[GB * DK * sizeof(TQ)];
  __shared__ SplitSmem<DK, GB, kSplitWarps, false> sm;
  TQ* sQ = reinterpret_cast<TQ*>(sQraw);
  const int G = d.H / d.KV, groups = (G + GB - 1) / GB;
  const int r = blockIdx.z, h = blockIdx.y / groups, hg = blockIdx.y % groups;
  const int split = blockIdx.x;
  const int len = max(0, min(d.seq_lens[r], d.S1));
  if (split > 0 && split * s.split_len >= len) return;  // past the slot's lines
  const int g0 = hg * GB, rows = min(GB, G - g0);
  // the group's rows are consecutive heads: rows * DK elements of q
  constexpr int V = 16 / int(sizeof(TQ));
  const TQ* q = static_cast<const TQ*>(d.q) + ((size_t)r * d.H + (size_t)h * G + g0) * DK;
  for (int idx = threadIdx.x; idx < rows * DK / V; idx += kSplitThreads)
    reinterpret_cast<uint4*>(sQ)[idx] = reinterpret_cast<const uint4*>(q)[idx];
  const size_t base = ((size_t)r * d.S1 * d.KV + h) * DK * sizeof(TQ);
  DenseLines ln;
  ln.k = static_cast<const uint8_t*>(d.k) + base;
  ln.v = static_cast<const uint8_t*>(d.v) + base;
  ln.line_bytes = (size_t)d.KV * DK * sizeof(TQ);
  ln.o = d.out;
  ln.orow = (size_t)r * d.H + (size_t)h * G + g0;
  ln.unit_ = ((size_t)r * d.KV + h) * groups + hg;
  ln.units_ = (size_t)d.R * d.KV * groups;
  ln.rows_ = rows;
  ln.ws_rows_ = min(G, GB);
  ln.len = len;
  ln.kscale = d.scale * kLog2e;
  attend_split<TQ, kPoolFloat, DK, GB, kSplitWarps>(ln, s, split, sQ, sm);
}

template <typename TQ, int DK>
cudaError_t launch_dk(const DenseArgs& d, const SplitArgs& s, cudaStream_t stream) {
  const int G = d.H / d.KV, gb = dense_rows(G);
  const dim3 grid(s.nsplit, d.KV * ((G + gb - 1) / gb), d.R);
  if (gb == 1) {
    dense_split_kernel<TQ, DK, 1><<<grid, kSplitThreads, 0, stream>>>(d, s);
  } else if (gb == 4) {
    dense_split_kernel<TQ, DK, 4><<<grid, kSplitThreads, 0, stream>>>(d, s);
  } else {
    dense_split_kernel<TQ, DK, kDecodeRows><<<grid, kSplitThreads, 0, stream>>>(d, s);
  }
  return cudaGetLastError();
}

template <typename TQ>
cudaError_t launch_t(const DenseArgs& d, const SplitArgs& s, int dk, cudaStream_t stream) {
  if (dk == 64) return launch_dk<TQ, 64>(d, s, stream);
  if (dk == 128) return launch_dk<TQ, 128>(d, s, stream);
  return cudaErrorInvalidValue;
}

}  // namespace
}  // namespace fft

// ws and counters: the split partials' workspace and the merge counters
// (SplitArgs; units R * KV * ceil(G / rows)), null with one split
// (split_len >= S1).
extern "C" int decode_attention_launch(const void* q, const void* k, const void* v,
                                       const void* seq_lens, void* out, void* ws,
                                       void* counters, int R, int S1, int H, int KV, int dk,
                                       int dtype, int split_len, float scale, void* stream) {
  if (R <= 0 || S1 <= 0 || KV <= 0 || H % KV != 0 || split_len <= 0)
    return (int)cudaErrorInvalidValue;
  const int nsplit = (S1 + split_len - 1) / split_len;
  if (nsplit > fft::kSplitMaxSplits) return (int)cudaErrorInvalidValue;
  if (nsplit > 1 && (ws == nullptr || counters == nullptr)) return (int)cudaErrorInvalidValue;
  const fft::DenseArgs d{q, k, v, static_cast<const int*>(seq_lens), out, R, S1, H, KV, scale};
  const fft::SplitArgs sp{static_cast<float*>(ws), static_cast<int*>(counters), split_len,
                          nsplit};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == fft::kBFloat16) return (int)fft::launch_t<__nv_bfloat16>(d, sp, dk, s);
  if (dtype == fft::kFloat32) return (int)fft::launch_t<float>(d, sp, dk, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
