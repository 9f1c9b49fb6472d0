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
//  * One block per (b * H + h, tile of query rows: 128 bf16, 64 f32);
//    heavy causal tiles (the last rows) are launched first.
//  * The block walks the key tiles of 64 lines and stops at the causal
//    diagonal: a tile whose first line lies past the block's last row is
//    never read (the TPU kernel's pl.when(jnp.any(mask))).
//  * bf16 inputs run on Hopper's warpgroup products (flash_fwd_wgmma_kernel,
//    below, design "wgmma"): three warpgroups, one producer thread issuing
//    TMA loads into a ring of K/V tiles, two consumer warpgroups of 64
//    rows each running wgmma.mma_async; see its comment.
//  * f32 inputs run on the CUDA cores (flash_fwd_kernel, design "f32"):
//    Q (pre-loaded once), K and V of a tile are staged in shared memory as
//    f32 with 16-byte loads; each thread computes a 4 x 4 block of scores
//    from float4 shared reads (4 FMAs per read), keeps its 4 rows' running
//    max and sum in registers, and accumulates its rows' output in dk / 16
//    columns. Rows past S and lines past T are zero in shared memory and
//    masked out of the softmax (the JAX kernel zeroes padded rows
//    likewise).
#include "flash_attention.cuh"
#include "hopper.cuh"

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
        sc[a][bb] = ok[bb] ? __fmul_rn(sc[a][bb], scale) : kNegInf;
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

// The bf16 forward on the warpgroup products. One block of three
// warpgroups per (b * H + h, 128 query rows), heavy causal tiles first:
//  * warpgroup 0 is the producer. Its registers drop to kProducerRegs
//    (setmaxnreg) and one thread issues TMA loads: the block's Q once (the
//    map's 4-D (dk, H, S, B) box, 128 rows), then K and V tiles of 64
//    lines into a ring of kStages buffers, each guarded by a full and an
//    empty mbarrier. Rows past S and lines past T arrive as zeros (the
//    JAX kernel zeroes padded rows likewise). Tiles past the causal
//    diagonal are never loaded.
//  * warpgroups 1 and 2 are consumers of 64 rows each, their registers
//    raised to kConsumerRegs. Per tile: S = Q K^T as dk / 16 wgmma
//    m64n64k16 with both operands in shared memory (K-major, 128-byte
//    swizzle); the online softmax on the accumulators in base 2 (scale
//    folded in; a row's 4 threads reduce with two shuffles); O += P V as
//    wgmma m64n{dk}k16 with P from registers as a hi + lo pair of bf16
//    (so P keeps its f32 value to ~2^-16, as the TPU kernel computes PV in
//    f32) and V read MN-major from its TMA tile through the descriptor's
//    transpose bit. Then a lane of every consumer warp arrives on the
//    tile's empty barrier. A consumer whose rows all lie before a causal
//    tile waits for it and arrives without the math. The softmax takes an
//    FFMA and an ex2 a score; the masked-line test runs only in the tiles
//    that hold masked lines.
//  * out = acc / max(l, 1e-30) in bf16; lse = m + log(max(l, 1e-30)).
namespace wg {

constexpr int kRows = 128;        // query rows a block
constexpr int kLines = 64;        // key lines a tile
constexpr int kStages = 3;        // K/V tile buffers
constexpr int kThreads = 384;     // producer + two consumer warpgroups
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;  // 40 * 128 + 232 * 256 <= 65536
constexpr int kBoxCols = 64;      // bf16 columns of a 128-byte TMA box

template <int DK>
struct Smem {
  static constexpr int kBoxes = DK / kBoxCols;                // boxes across dk
  static constexpr uint32_t kQBox = kRows * 128;              // bytes of a Q box
  static constexpr uint32_t kKBox = kLines * 128;             // bytes of a K or V box
  static constexpr uint32_t kQ = kBoxes * kQBox;
  static constexpr uint32_t kKV = kBoxes * kKBox;             // K or V of one stage
  static constexpr uint32_t kStage = 2 * kKV;
  static constexpr size_t kBytes = kQ + size_t(kStages) * kStage + 1024;  // + alignment
};

}  // namespace wg

template <int DK>
__global__ void __launch_bounds__(wg::kThreads, 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                       const __grid_constant__ CUtensorMap kmap,
                       const __grid_constant__ CUtensorMap vmap,
                       __nv_bfloat16* __restrict__ out, float* __restrict__ lse, int S,
                       int T_, int H, int causal, float scale) {
  using namespace hopper;
  using L = wg::Smem<DK>;
  constexpr int kNt = wg::kLines / 8;  // 8-line column blocks of a score tile
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[wg::kStages], empty[wg::kStages], qfull;
  // the swizzle pattern follows address bits 7-9: boxes 1024-byte aligned
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* sQ = smem;
  unsigned char* sKV = smem + L::kQ;  // stage st: K at st * kStage, V after it

  const int row0 = (gridDim.x - 1 - blockIdx.x) * wg::kRows;  // heavy tiles first
  const int n = blockIdx.y, b = n / H, h = n % H;
  const int t_end = causal ? min(T_, row0 + wg::kRows) : T_;
  const int ntiles = (t_end + wg::kLines - 1) / wg::kLines;
  const int group = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(&qfull, 1);
    for (int st = 0; st < wg::kStages; ++st) {
      mbar_init(&full[st], 1);
      mbar_init(&empty[st], 8);  // a lane of every consumer warp
    }
    fence_mbar_init();
  }
  __syncthreads();

  if (group == 0) {
    // producer: one thread issues every load; phases of empty[st] start
    // complete (parity 1 passes at once)
    reg_dealloc<wg::kProducerRegs>();
    if (threadIdx.x == 0) {
      mbar_expect_tx(&qfull, L::kQ);
      for (int bx = 0; bx < L::kBoxes; ++bx)
        tma_load_4d(sQ + bx * L::kQBox, &qmap, &qfull, bx * wg::kBoxCols, h, row0, b);
      for (int j = 0; j < ntiles; ++j) {
        const int st = j % wg::kStages;
        mbar_wait(&empty[st], ((j / wg::kStages) & 1) ^ 1);
        mbar_expect_tx(&full[st], L::kStage);
        unsigned char* sK = sKV + st * L::kStage;
        for (int bx = 0; bx < L::kBoxes; ++bx) {
          tma_load_4d(sK + bx * L::kKBox, &kmap, &full[st], bx * wg::kBoxCols, h,
                      j * wg::kLines, b);
          tma_load_4d(sK + L::kKV + bx * L::kKBox, &vmap, &full[st], bx * wg::kBoxCols, h,
                      j * wg::kLines, b);
        }
      }
    }
  } else {
    reg_alloc<wg::kConsumerRegs>();
    const int c = group - 1;  // rows row0 + 64 c .. + 63
    const int tid = threadIdx.x - 128 * group, warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, t = lane % 4;
    const int rbase = row0 + 64 * c;
    const int ra = rbase + 16 * warp + g, rb = ra + 8;  // this thread's rows
    const int my_end = causal ? min(T_, rbase + 64) : T_;  // lines past it unattended
    const float scale2 = scale * kLog2e;                  // scores in base 2

    float o[DK / 8][4], m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
#pragma unroll
    for (int nt = 0; nt < DK / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[nt][e] = 0.f;
    mbar_wait(&qfull, 0);

    for (int j = 0; j < ntiles; ++j) {
      const int st = j % wg::kStages, t0 = j * wg::kLines;
      mbar_wait(&full[st], (j / wg::kStages) & 1);
      if (t0 < my_end) {
        const unsigned char* sK = sKV + st * L::kStage;
        const unsigned char* sV = sK + L::kKV;
        float s[kNt][4];
#pragma unroll
        for (int nt = 0; nt < kNt; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < DK / 16; ++ks) {
          const int bx = ks / 4, kof = (ks % 4) * 32;  // box, byte offset in its rows
          wgmma_ss_n64(s, desc_sw128(sQ + bx * L::kQBox + c * 64 * 128 + kof, 16, 1024),
                       desc_sw128(sK + bx * L::kKBox + kof, 16, 1024), ks > 0);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(s);

        // s[nt][e]: row ra (e < 2) or rb, line t0 + 8 nt + 2 t + (e & 1).
        // Masked lines (past T, or past the row under the causal rule)
        // score kNegInf, only in the tiles that hold such lines. Every row
        // this consumer writes attends a line of every tile it takes (line
        // t0: t0 < T, and t0 <= rbase under the causal rule), so its
        // maximum is a real score and a masked line's probability 2^(kNegInf
        // * scale2 - m) is 0.
        if (t0 + wg::kLines > T_ || (causal && t0 + wg::kLines - 1 > rbase)) {
#pragma unroll
          for (int nt = 0; nt < kNt; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              if (!attends(e < 2 ? ra : rb, t0 + nt * 8 + 2 * t + (e & 1), S, T_, causal))
                s[nt][e] = kNegInf;
        }
        float red_a[kNt], red_b[kNt];
#pragma unroll
        for (int nt = 0; nt < kNt; ++nt) {
          red_a[nt] = fmaxf(s[nt][0], s[nt][1]);
          red_b[nt] = fmaxf(s[nt][2], s[nt][3]);
        }
        float mx[2] = {tree_max<kNt>(red_a), tree_max<kNt>(red_b)};
        float corr[2], neg_m[2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
          mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
          const float m_new = fmaxf(m[i], mx[i] * scale2);  // base 2
          corr[i] = exp2_ftz(m[i] - m_new);
          m[i] = m_new;
          neg_m[i] = -m_new;
        }
        // p = 2^(s * scale2 - m), one FFMA and one ex2 a score
#pragma unroll
        for (int nt = 0; nt < kNt; ++nt) {
#pragma unroll
          for (int e = 0; e < 4; ++e) s[nt][e] = exp2_ftz(fmaf(s[nt][e], scale2, neg_m[e >> 1]));
          red_a[nt] = s[nt][0] + s[nt][1];
          red_b[nt] = s[nt][2] + s[nt][3];
        }
        l[0] = l[0] * corr[0] + tree_sum<kNt>(red_a);
        l[1] = l[1] * corr[1] + tree_sum<kNt>(red_b);
#pragma unroll
        for (int nt = 0; nt < DK / 8; ++nt) {
          o[nt][0] *= corr[0];
          o[nt][1] *= corr[0];
          o[nt][2] *= corr[1];
          o[nt][3] *= corr[1];
        }
        // O += P V: P as hi + lo bf16 A fragments, 16 lines a product
        uint32_t ph[kNt / 2][4], pl[kNt / 2][4];
#pragma unroll
        for (int kt = 0; kt < kNt / 2; ++kt) acc_to_a(s[2 * kt], s[2 * kt + 1], ph[kt], pl[kt]);
        wgmma_fence();
#pragma unroll
        for (int kt = 0; kt < kNt / 2; ++kt) {
          const uint64_t dv = desc_sw128(sV + kt * 16 * 128, L::kKBox, 1024);
          if constexpr (DK == 128) {
            wgmma_rs_n128(o, ph[kt], dv);
            wgmma_rs_n128(o, pl[kt], dv);
          } else {
            wgmma_rs_n64(o, ph[kt], dv);
            wgmma_rs_n64(o, pl[kt], dv);
          }
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(o);
      }
      __syncwarp();  // the warp is done with the stage (its products waited for)
      if (lane == 0) mbar_arrive(&empty[st]);
    }

#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
      const int r = i ? rb : ra;
      if (r >= S) continue;
      const float lc = fmaxf(l[i], 1e-30f);
      __nv_bfloat16* orow = out + ((size_t)b * S + r) * H * DK + (size_t)h * DK + 2 * t;
#pragma unroll
      for (int nt = 0; nt < DK / 8; ++nt)
        *reinterpret_cast<uint32_t*>(orow + nt * 8) =
            pack_bf16(o[nt][2 * i] / lc, o[nt][2 * i + 1] / lc);
      if (t == 0) lse[(size_t)n * S + r] = m[i] * kLn2 + logf(lc);
    }
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
  CUtensorMap qmap, kmap, vmap;
  cudaError_t err = hopper::make_map(&qmap, q, B, S, H, DK, wg::kRows);
  if (err == cudaSuccess) err = hopper::make_map(&kmap, k, B, T_, H, DK, wg::kLines);
  if (err == cudaSuccess) err = hopper::make_map(&vmap, v, B, T_, H, DK, wg::kLines);
  if (err != cudaSuccess) return err;
  constexpr size_t kSmem = wg::Smem<DK>::kBytes;
  err = set_smem(flash_fwd_wgmma_kernel<DK>, kSmem);
  if (err != cudaSuccess) return err;
  dim3 grid((S + wg::kRows - 1) / wg::kRows, B * H);
  flash_fwd_wgmma_kernel<DK><<<grid, wg::kThreads, kSmem, stream>>>(
      qmap, kmap, vmap, static_cast<__nv_bfloat16*>(out), lse, S, T_, H, causal, scale);
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

// The design the launcher takes for q of DType dtype: 0 "f32" (the CUDA
// cores), 1 "wgmma".
extern "C" int flash_attention_fwd_design(int dtype) {
  return dtype == fft::kBFloat16 ? 1 : 0;
}

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
