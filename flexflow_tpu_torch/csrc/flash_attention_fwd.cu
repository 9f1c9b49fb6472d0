// flash_attention_fwd — causal or full attention with an online softmax,
// the training forward pass, for sm_90a.
//
// Replaces the Pallas TPU kernel flexflow_tpu/ops/flash_attention.py
// _flash_fwd (body _fwd_kernel). Same function: q (B, S, H, dk) attends
// k/v (B, T, H, dk) (GQA heads repeated by the caller); scores are
// dot(q, k) * scale, causal is the top-left rule qpos >= kpos; f32
// online softmax; out = acc / max(l, 1e-30) in q's dtype and the f32
// log-sum-exp lse = m + log(max(l, 1e-30)), (B, H, S), which the backward
// kernels recompute the probabilities from. The kernel reads the
// (B, S, H, dk) layout through its row stride H * dk, so the JAX
// wrapper's (B*H, S, dk) transposes are gone; m and l are one f32 per
// row in registers, not the TPU's lane-replicated (rows, 128) tiles.
//
// Bound on an H100: operations. 4 * (attended (row, line) pairs) * dk
// FLOP per head (QK^T and PV) — at B*H = 128, S = T = 2048, dk = 128,
// causal, 137 GFLOP — against ~270 MB of q, k, v, out and lse: ~500 FLOP
// per byte, above the bf16 tensor cores' balance point (~295).
//
// Design against that bound:
//  * One block per (b * H + h, tile of 64 query rows); heavy causal tiles
//    (the last rows) are launched first.
//  * The block walks the key tiles of 64 lines and stops at the causal
//    diagonal: a tile whose first line lies past the block's last row is
//    never read (the TPU kernel's pl.when(jnp.any(mask))).
//  * bf16 inputs run on the tensor cores (flash_fwd_mma_kernel, below):
//    QK^T and PV as mma.sync.m16n8k16 with f32 accumulation, P entering
//    PV as hi + lo bf16 operands so it keeps its f32 value to ~2^-16, as
//    the TPU kernel computes PV in f32. wgmma and TMA are the later step.
//  * f32 inputs run on the CUDA cores (flash_fwd_kernel): Q (pre-loaded
//    once), K and V of a tile are staged in shared memory as f32 with
//    16-byte loads; each thread computes a 4 x 4 block of scores from
//    float4 shared reads (4 FMAs per read), keeps its 4 rows' running max
//    and sum in registers, and accumulates its rows' output in dk / 16
//    columns.
//  * Rows past S and lines past T are zero in shared memory and masked
//    out of the softmax (the JAX kernel zeroes padded rows likewise).
#include "flash_attention.cuh"

namespace fft {
namespace {

using namespace flash;

template <int DK>
struct FwdSmem {
  static constexpr int L = Ld<DK>::kRow;
  static constexpr size_t kFloats = size_t(kRows) * L + 2 * size_t(kLines) * L
                                    + size_t(kRows) * kLdP;
  static constexpr size_t kBytes = sizeof(float) * kFloats;
};

template <typename T, int DK>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out,
                 float* __restrict__ lse, int S, int T_, int H, int causal,
                 float scale) {
  constexpr int L = Ld<DK>::kRow;
  constexpr int kCols = DK / kLanes;  // output columns per thread
  extern __shared__ __align__(16) float smem[];
  float* sQ = smem;                   // [kRows][L]
  float* sK = sQ + kRows * L;         // [kLines][L]
  float* sV = sK + kLines * L;        // [kLines][L]
  float* sP = sV + kLines * L;        // [kRows][kLdP]

  const int row0 = (gridDim.x - 1 - blockIdx.x) * kRows;  // heavy tiles first
  const int n = blockIdx.y, b = n / H, h = n % H;
  const size_t rs = (size_t)H * DK;
  const T* qb = q + ((size_t)b * S * H + h) * DK;
  const T* kb = k + ((size_t)b * T_ * H + h) * DK;
  const T* vb = v + ((size_t)b * T_ * H + h) * DK;
  const int tid = threadIdx.x;
  const int tx = tid % kLanes;
  const int i0 = (tid / kLanes) * 4;

  load_rows<T, DK, kRows>(sQ, qb, row0, S, rs);

  float m[4], l[4], acc[4][kCols];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    m[a] = kNegInf;
    l[a] = 0.f;
#pragma unroll
    for (int e = 0; e < kCols; ++e) acc[a][e] = 0.f;
  }

  const int t_end = causal ? min(T_, row0 + kRows) : T_;
  for (int t0 = 0; t0 < t_end; t0 += kLines) {
    __syncthreads();  // the last tile's reads of sK/sV/sP are done
    load_rows<T, DK, kLines>(sK, kb, t0, T_, rs);
    load_rows<T, DK, kLines>(sV, vb, t0, T_, rs);
    __syncthreads();

    float sc[4][4];
    dot_tile<DK>(sQ, sK, i0, tx, sc);

    float corr[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int r = row0 + i0 + a;
      bool ok[4];
      float mx = m[a];
#pragma unroll
      for (int bb = 0; bb < 4; ++bb) {
        ok[bb] = attends(r, t0 + tx + kLanes * bb, S, T_, causal);
        sc[a][bb] = ok[bb] ? sc[a][bb] * scale : kNegInf;
        mx = fmaxf(mx, sc[a][bb]);
      }
#pragma unroll
      for (int off = kLanes / 2; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      corr[a] = expf(m[a] - mx);
      float psum = 0.f;
      float* prow = sP + (i0 + a) * kLdP;
#pragma unroll
      for (int bb = 0; bb < 4; ++bb) {
        const float p = ok[bb] ? expf(sc[a][bb] - mx) : 0.f;
        prow[tx + kLanes * bb] = p;
        psum += p;
      }
#pragma unroll
      for (int off = kLanes / 2; off > 0; off >>= 1)
        psum += __shfl_xor_sync(0xffffffffu, psum, off);
      l[a] = l[a] * corr[a] + psum;
      m[a] = mx;
    }
    __syncwarp();  // a row group's probabilities are written and read in-warp

#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int e = 0; e < kCols; ++e) acc[a][e] *= corr[a];
#pragma unroll 4
    for (int j = 0; j < kLines; ++j) {
      float p[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) p[a] = sP[(i0 + a) * kLdP + j];
#pragma unroll
      for (int hh = 0; hh < kCols / 4; ++hh) {
        const float4 vv = *reinterpret_cast<const float4*>(sV + j * L + tx * 4 + 64 * hh);
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          acc[a][4 * hh + 0] = fmaf(p[a], vv.x, acc[a][4 * hh + 0]);
          acc[a][4 * hh + 1] = fmaf(p[a], vv.y, acc[a][4 * hh + 1]);
          acc[a][4 * hh + 2] = fmaf(p[a], vv.z, acc[a][4 * hh + 2]);
          acc[a][4 * hh + 3] = fmaf(p[a], vv.w, acc[a][4 * hh + 3]);
        }
      }
    }
  }

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int r = row0 + i0 + a;
    if (r >= S) continue;
    const float lc = fmaxf(l[a], 1e-30f);
    T* o = out + ((size_t)b * S + r) * rs + (size_t)h * DK + tx * 4;
#pragma unroll
    for (int hh = 0; hh < kCols / 4; ++hh)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[64 * hh + e] = from_f32<T>(acc[a][4 * hh + e] / lc);
    if (tx == 0) lse[(size_t)n * S + r] = m[a] + logf(lc);
  }
}

// The bf16 forward on the tensor cores: one block of 4 warps per (b * H +
// h, tile of 64 query rows), warp w owning rows 16 w .. 16 w + 15 (its Q
// fragments in registers). Per key tile of 64 lines: S = Q K^T (mma, f32
// accumulators), the online softmax on the accumulators (a row's 4
// threads reduce with two shuffles), O += P V with P as hi + lo bf16
// fragments taken straight from the accumulators and V staged transposed.
template <int DK>
__global__ void __launch_bounds__(kMmaThreads)
flash_fwd_mma_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out,
                     float* __restrict__ lse, int S, int T_, int H, int causal,
                     float scale) {
  constexpr int LQ = LdH<DK>::kRow;
  constexpr int LV = LdH<kLines>::kRow;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [kRows][LQ]
  __nv_bfloat16* sK = sQ + kRows * LQ;                              // [kLines][LQ]
  __nv_bfloat16* sVt = sK + kLines * LQ;                            // [DK][LV]

  const int row0 = (gridDim.x - 1 - blockIdx.x) * kRows;  // heavy tiles first
  const int n = blockIdx.y, b = n / H, h = n % H;
  const size_t rs = (size_t)H * DK;
  const __nv_bfloat16* kb = k + ((size_t)b * T_ * H + h) * DK;
  const __nv_bfloat16* vb = v + ((size_t)b * T_ * H + h) * DK;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int r_a = row0 + warp * 16 + g, r_b = r_a + 8;  // this thread's rows

  load_rows_bf16<DK, kRows, false>(sQ, q + ((size_t)b * S * H + h) * DK, row0, S, rs);
  __syncthreads();
  uint32_t qa[DK / 16][4];
#pragma unroll
  for (int ks = 0; ks < DK / 16; ++ks) load_a<LQ>(sQ, warp * 16, ks * 16, g, t, qa[ks]);

  float o[DK / 8][4], m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int nt = 0; nt < DK / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[nt][e] = 0.f;

  const int t_end = causal ? min(T_, row0 + kRows) : T_;
  for (int t0 = 0; t0 < t_end; t0 += kLines) {
    __syncthreads();  // the last tile's reads of sK/sVt are done
    load_rows_bf16<DK, kLines, false>(sK, kb, t0, T_, rs);
    load_rows_bf16<DK, kLines, true>(sVt, vb, t0, T_, rs);
    __syncthreads();

    float s[kLines / 8][4];
#pragma unroll
    for (int nt = 0; nt < kLines / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < DK / 16; ++ks)
#pragma unroll
      for (int nt = 0; nt < kLines / 8; ++nt) {
        uint32_t b0, b1;
        load_b<LQ>(sK, nt * 8, ks * 16, g, t, b0, b1);
        mma16816(s[nt], qa[ks], b0, b1);
      }

    // c[e] of tile nt: row r_a (e < 2) or r_b, line t0 + 8 nt + 2 t + (e & 1)
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int nt = 0; nt < kLines / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool ok = attends(e < 2 ? r_a : r_b, t0 + nt * 8 + 2 * t + (e & 1), S, T_, causal);
        s[nt][e] = ok ? s[nt][e] * scale : kNegInf;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[nt][e]);
      }
    float corr[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      corr[i] = expf(m[i] - mx[i]);
      m[i] = mx[i];
      l[i] *= corr[i];
    }
#pragma unroll
    for (int nt = 0; nt < kLines / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool ok = attends(e < 2 ? r_a : r_b, t0 + nt * 8 + 2 * t + (e & 1), S, T_, causal);
        const float p = ok ? expf(s[nt][e] - m[e >> 1]) : 0.f;
        s[nt][e] = p;
        l[e >> 1] += p;
      }
#pragma unroll
    for (int nt = 0; nt < DK / 8; ++nt) {
      o[nt][0] *= corr[0];
      o[nt][1] *= corr[0];
      o[nt][2] *= corr[1];
      o[nt][3] *= corr[1];
    }
#pragma unroll
    for (int kt = 0; kt < kLines / 16; ++kt) {
      uint32_t ah[4], al[4];
      acc_to_a(s[2 * kt], s[2 * kt + 1], ah, al);
#pragma unroll
      for (int nt = 0; nt < DK / 8; ++nt) {
        uint32_t b0, b1;
        load_b<LV>(sVt, nt * 8, kt * 16, g, t, b0, b1);
        mma16816(o[nt], ah, b0, b1);
        mma16816(o[nt], al, b0, b1);
      }
    }
  }

  float lc[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    lc[i] = fmaxf(l[i], 1e-30f);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = i ? r_b : r_a;
    if (r >= S) continue;
    __nv_bfloat16* orow = out + ((size_t)b * S + r) * rs + (size_t)h * DK + 2 * t;
#pragma unroll
    for (int nt = 0; nt < DK / 8; ++nt)
      *reinterpret_cast<uint32_t*>(orow + nt * 8) =
          pack_bf16(o[nt][2 * i] / lc[i], o[nt][2 * i + 1] / lc[i]);
    if (t == 0) lse[(size_t)n * S + r] = m[i] + logf(lc[i]);
  }
}

template <int DK>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* out,
                       float* lse, int B, int S, int T_, int H, int causal,
                       float scale, cudaStream_t stream) {
  constexpr size_t kSmem = FwdSmem<DK>::kBytes;
  cudaError_t err = set_smem(flash_fwd_kernel<float, DK>, kSmem);
  if (err != cudaSuccess) return err;
  dim3 grid((S + kRows - 1) / kRows, B * H);
  flash_fwd_kernel<float, DK><<<grid, kThreads, kSmem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), lse, S, T_, H, causal,
      scale);
  return cudaGetLastError();
}

template <int DK>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* out,
                        float* lse, int B, int S, int T_, int H, int causal,
                        float scale, cudaStream_t stream) {
  using bf = __nv_bfloat16;
  constexpr size_t kSmem = sizeof(bf) * (size_t(kRows + kLines) * LdH<DK>::kRow
                                         + size_t(DK) * LdH<kLines>::kRow);
  cudaError_t err = set_smem(flash_fwd_mma_kernel<DK>, kSmem);
  if (err != cudaSuccess) return err;
  dim3 grid((S + kRows - 1) / kRows, B * H);
  flash_fwd_mma_kernel<DK><<<grid, kMmaThreads, kSmem, stream>>>(
      static_cast<const bf*>(q), static_cast<const bf*>(k), static_cast<const bf*>(v),
      static_cast<bf*>(out), lse, S, T_, H, causal, scale);
  return cudaGetLastError();
}

}  // namespace
}  // namespace fft

extern "C" int flash_attention_fwd_launch(const void* q, const void* k,
                                          const void* v, void* out, void* lse,
                                          int B, int S, int T, int H, int dk,
                                          int causal, int dtype, float scale,
                                          void* stream) {
  if (B <= 0 || S <= 0 || T <= 0 || H <= 0 || B * H > 65535)
    return (int)cudaErrorInvalidValue;
  float* l = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == fft::kBFloat16 && dk == 64) {
    err = fft::launch_bf16<64>(q, k, v, out, l, B, S, T, H, causal, scale, s);
  } else if (dtype == fft::kBFloat16 && dk == 128) {
    err = fft::launch_bf16<128>(q, k, v, out, l, B, S, T, H, causal, scale, s);
  } else if (dtype == fft::kFloat32 && dk == 64) {
    err = fft::launch_f32<64>(q, k, v, out, l, B, S, T, H, causal, scale, s);
  } else if (dtype == fft::kFloat32 && dk == 128) {
    err = fft::launch_f32<128>(q, k, v, out, l, B, S, T, H, causal, scale, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return (int)err;
}

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
