"""The port's CUDA attention kernels (dense decode; verify, ragged paged
and fused RoPE + KV-write paged attention in each block design; training
flash attention forward and backward) held against their plain PyTorch
versions on the GPU, and bf16 train steps through each attention
path under each remat setting. Every test here needs a CUDA GPU and skips
without one; the file imports neither JAX nor the JAX package, so on a
machine with a GPU and no JAX it runs as

    python -m pytest --noconftest tests/test_torch_cuda.py -q
"""
import dataclasses
import math

import pytest
import torch

from flexflow_tpu_torch.serve import kernels as tk

# bf16: kernel and plain version both compute in f32 and round the output
# once, so they may differ by one bf16 ulp (<= 2^-7 |x|); f32: summation
# order only
TOL = {torch.float32: dict(atol=1e-5, rtol=0.0),
       torch.bfloat16: dict(atol=1e-2, rtol=1e-2)}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("dk", [64, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_kernels_match_plain_versions(cuda_device, dtype, dk):
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    R, S1, H, KV, C = 3, 300, 8, 2, 16

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=cuda_device).to(dtype)

    q, k, v = rnd(R, H, dk), rnd(R, S1, KV, dk), rnd(R, S1, KV, dk)
    sl = torch.tensor([0, 1, 299], dtype=torch.int32, device=cuda_device)
    before = dict(tk.LAUNCHES)
    out = tk.decode_attention(q, k, v, sl)
    torch.testing.assert_close(out, tk.decode_attention_ref(q, k, v, sl), **TOL[dtype])
    assert (out[0] == 0).all()  # a zero-length slot gives zeros
    qc = rnd(R, C, H, dk)
    pos = torch.arange(C, device=cuda_device)[None, :] + torch.tensor(
        [[0], [100], [S1 - 1 - C]], device=cuda_device)
    mask = tk.causal_serve_mask(pos, S1)
    mask[0, 2] = False  # a fully masked row gives zeros
    out = tk.verify_attention(qc, k, v, mask)
    torch.testing.assert_close(out, tk.verify_attention_ref(qc, k, v, mask), **TOL[dtype])
    assert (out[0, 2] == 0).all()
    assert tk.LAUNCHES["decode_attention"] == before["decode_attention"] + 1
    assert tk.LAUNCHES["verify_attention"] == before["verify_attention"] + 1


def test_cuda_wrappers_raise_instead_of_falling_back(cuda_device):
    R, S1, H, KV, dk = 2, 40, 4, 2, 32  # no kernel for head dim 32
    q = torch.zeros(R, H, dk, device=cuda_device)
    kv = torch.zeros(R, S1, KV, dk, device=cuda_device)
    sl = torch.ones(R, dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match="head dim"):
        tk.decode_attention(q, kv, kv, sl)
    q, kv = q[..., :16].to(torch.float16), kv[..., :16].to(torch.float16)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        tk.verify_attention(q[:, None], kv, kv,
                            torch.ones(R, 1, S1, dtype=torch.bool, device=cuda_device))
    # the paged kernels: no head dim 32, and no mask off 16-byte alignment
    C, ps, NP = 20, 16, 2
    before = {**tk.LAUNCHES, **tk.DESIGN_LAUNCHES}
    for dk_, misaligned in ((32, False), (64, True)):
        q = torch.zeros(R, C, H, dk_, dtype=torch.bfloat16, device=cuda_device)
        pool = torch.zeros(R * NP + 1, ps, KV, dk_, dtype=torch.bfloat16, device=cuda_device)
        table = torch.zeros(R, NP, dtype=torch.int32, device=cuda_device)
        n = R * C * NP * ps
        mask = torch.ones(n + 1, dtype=torch.bool, device=cuda_device)
        mask = (mask[1:] if misaligned else mask[:n]).view(R, C, NP * ps)
        i = torch.zeros(R, C, dtype=torch.int32, device=cuda_device)
        kv_new = torch.zeros(R, C, KV, dk_, dtype=torch.bfloat16, device=cuda_device)
        what = "16-byte aligned" if misaligned else "head dim"
        with pytest.raises(ValueError, match=what):
            tk.ragged_paged_attention(q, pool, pool, table, mask)
        with pytest.raises(ValueError, match=what):
            tk.fused_rope_paged_attention(q, kv_new, kv_new, None, None, pool, pool, table,
                                          i, i, mask)
    assert {**tk.LAUNCHES, **tk.DESIGN_LAUNCHES} == before


# ---------------------------------------------------------------------------
# verify attention in each block design


def _verify_case(gen, dev, dtype, C, G, dk, S1, R=3, KV=2):
    """q, caches and the mask of a serving step over a dense cache of S1
    lines (line S1 - 1 the scratch line): slot 0 a prefill chunk ending at
    the scratch line, its columns past the cache padding; slot 1 a random
    tree-like mask whose row 0 attends nothing; slot 2 one decode token,
    every other column padding. Padding columns attend every line but the
    scratch one, as on the serving path."""
    H = KV * G
    q = torch.randn(R, C, H, dk, generator=gen, device=dev).to(dtype)
    k = torch.randn(R, S1, KV, dk, generator=gen, device=dev).to(dtype)
    v = torch.randn(R, S1, KV, dk, generator=gen, device=dev).to(dtype)
    scratch = S1 - 1
    pos = torch.full((R, C), scratch, device=dev)
    n = min(C, scratch)
    pos[0, :n] = torch.arange(scratch - n, scratch, device=dev)
    pos[2, 0] = scratch // 2
    mask = tk.causal_serve_mask(pos, S1)
    mask[1] = torch.rand(C, S1, generator=gen, device=dev) < 0.3
    mask[1, 0] = False
    return q, k, v, mask


@pytest.mark.parametrize("S1", [65, 2113])
@pytest.mark.parametrize("dk", [64, 128])
@pytest.mark.parametrize("G", [1, 4])
@pytest.mark.parametrize("C", [2, 8, 9, 16, 64, 128, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_verify_attention_designs_match_plain_version(cuda_device, dtype, C, G, dk, S1):
    """Every design at the widths the engine sends (prefill chunks, tree
    widths up to 64, 256-wide chunks): the output within the kernel
    tolerance of the plain version, a fully masked row exactly 0, the bits
    entry bitwise the bool entry, one launch counted in the design the
    launcher reports ("mma" and "tf32x3" for bf16 and f32 at C * G > 8,
    "rows8" and "f32" below)."""
    gen = torch.Generator(device=cuda_device).manual_seed(6)
    q, k, v, mask = _verify_case(gen, cuda_device, dtype, C, G, dk, S1)
    if dtype == torch.float32:
        design = "tf32x3" if C * G > 8 else "f32"
    else:
        design = "mma" if C * G > 8 else "rows8"
    before = dict(tk.DESIGN_LAUNCHES)
    out = tk.verify_attention(q, k, v, mask)
    moved = {k_: n - before[k_] for k_, n in tk.DESIGN_LAUNCHES.items() if n != before[k_]}
    assert moved == {f"verify_attention[{design}]": 1}
    bits = tk.pack_mask_bits(mask)
    assert torch.equal(tk.verify_attention_bits(q, k, v, bits, S1), out)
    ref = tk.verify_attention_ref(q, k, v, mask)
    torch.testing.assert_close(out, ref, **TOL[dtype])
    assert (out[1, 0] == 0).all()


@pytest.mark.parametrize("dk", [64, 128])
def test_cuda_verify_mma_ignores_stale_shared_memory(cuda_device, poison_smem, dk):
    """The tensor-core verify tile reads no shared memory it did not
    write: after every SM's shared memory is filled with NaN bits, the
    output is finite and matches the plain version (a last tile past the
    cache's 100 lines, a 128-row pass with 48 rows past the last)."""
    gen = torch.Generator(device=cuda_device).manual_seed(7)
    q, k, v, mask = _verify_case(gen, cuda_device, torch.bfloat16, 20, 4, dk, 100)
    ref = tk.verify_attention_ref(q, k, v, mask)
    poison_smem()
    out = tk.verify_attention(q, k, v, mask)
    assert out.isfinite().all()
    torch.testing.assert_close(out, ref, **TOL[torch.bfloat16])


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dk", [64, 128])
def test_cuda_flash_wgmma_ignores_stale_shared_memory(cuda_device, poison_smem, dk, causal):
    """The wgmma forward and backward kernels read no shared memory they
    did not write (rows past S and lines past T arrive as TMA's zeros):
    after every SM's shared memory is filled with NaN bits, out, lse, dq,
    dk and dv are finite and match the plain versions."""
    from flexflow_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device=cuda_device).manual_seed(8)
    B, H, S, T = 2, 3, 130, 77
    q = torch.randn(B, S, H, dk, generator=gen, device=cuda_device).to(torch.bfloat16)
    k = torch.randn(B, T, H, dk, generator=gen, device=cuda_device).to(torch.bfloat16)
    v = torch.randn(B, T, H, dk, generator=gen, device=cuda_device).to(torch.bfloat16)
    out_ref, lse_ref = fa.flash_fwd_ref(q, k, v, causal, dk ** -0.5)
    poison_smem()
    out, lse = fa.flash_fwd(q, k, v, causal, dk ** -0.5)
    assert out.isfinite().all() and lse.isfinite().all()
    torch.testing.assert_close(out, out_ref, **TOL[torch.bfloat16])
    torch.testing.assert_close(lse, lse_ref, atol=1e-5, rtol=1e-5)
    # both wgmma backward kernels, each after a fresh poisoning (their
    # last tiles hold rows past S and lines past T, and the kv kernel's lse
    # and delta tiles run past the last row)
    do = torch.randn(B, S, H, dk, generator=gen, device=cuda_device).to(torch.bfloat16)
    delta = fa.delta_rows(out, do).contiguous()
    scale = dk ** -0.5
    want_k, want_v = fa.flash_bwd_kv_ref(q, k, v, do, lse, delta, causal, scale)
    want_q = fa.flash_bwd_q_ref(q, k, v, do, lse, delta, causal, scale)
    poison_smem()
    got_k, got_v = fa.flash_bwd_kv(q, k, v, do, lse, delta, causal, scale)
    poison_smem()
    got_q = fa.flash_bwd_q(q, k, v, do, lse, delta, causal, scale)
    for name, g, w in (("dq", got_q, want_q), ("dk", got_k, want_k), ("dv", got_v, want_v)):
        assert g.isfinite().all(), name
        torch.testing.assert_close(g, w, **TOL[torch.bfloat16], msg=name)


# ---------------------------------------------------------------------------
# paged kernels


def _paged_case(gen, dev, dtype, quant, R, C, H, KV, dk, ps, NP):
    """q, pools (q's dtype, or int8/int4 codes quantized from random
    lines with per-page scales), a shuffled table whose last logical page
    is unallocated (the scratch page P), and a mask that opens only
    allocated lines: slot 0 at random (its row 0 attends nothing), slot 1
    nothing at all, slot 2 a causal prefix whose last column is padding
    (it attends every line, scratch page included, as a padding token of a
    serving step does)."""
    from flexflow_tpu_torch.serve import kv_quant as kq

    P = R * NP
    q = torch.randn(R, C, H, dk, generator=gen, device=dev).to(dtype)
    lines = torch.randn(2, P + 1, ps, KV, dk, generator=gen, device=dev)
    table = torch.randperm(P, generator=gen, device=dev).reshape(R, NP).to(torch.int32)
    table[:, NP - 1] = P
    allocated = (table != P).repeat_interleave(ps, dim=1)
    mask = (torch.rand(R, C, NP * ps, generator=gen, device=dev) < 0.5) & allocated[:, None]
    mask[0, 0] = False
    mask[1] = False
    pos = torch.arange(C, device=dev) + (NP - 1) * ps - C
    mask[2] = torch.arange(NP * ps, device=dev)[None, :] <= pos[:, None]
    mask[2, C - 1] = True
    if quant is None:
        return q, lines[0].to(dtype), lines[1].to(dtype), None, None, table, mask
    spec = kq.SPECS[quant]
    s = lines.abs().amax(dim=(2, 4)) / spec.qmax + 1e-3          # (2, P+1, KV)
    codes = torch.round(lines / s[:, :, None, :, None]).clamp(-spec.qmax, spec.qmax)
    pools = kq.pack_codes(codes, spec.dtype, spec.pack)
    return q, pools[0].contiguous(), pools[1].contiguous(), s[0].contiguous(), \
        s[1].contiguous(), table, mask


# (C, H, KV, dk, ps, NP): query rows per KV head C * H / KV at decode
# (<= 8; one row alone at C = 1, G = 1) at dk 64 and 128, 9-16, 128 and
# past 128 (several 128-row blocks, the last one
# partial), at G = 1 and 4; page sizes 16 (four pages a 64-line tile), 64
# and 128; head dims 64 and 128; a cache of 4352 lines (68 tiles: three
# chunks of the 32 whose mask bits the tensor-core tile stages at once)
# and a dk-128 cache of 1280 lines (20 tiles: two chunks of the 16 that
# the f32 tile on f32 pages stages at dk 128); last, LLaMA-7B's longest
# walk at dk 128, a 2048-token context in 17 pages of 128 (the serving
# slices' page count) under a 128-token mixed step at G = 2; then the
# split decode design: LLaMA-7B MHA at page size 128 with 17 pages (17
# one-page splits at R = 3), the same at KV 8 (G = 4), dk 64 at page size
# 16 with 64 pages (16 splits of 4 pages: long walks), 8 rows a KV head
# (C = 2 at G = 4: one split, two mask rows) and C = 4 at G = 1
PAGED_SHAPES = [
    (20, 8, 2, 64, 128, 34),
    (20, 8, 2, 128, 64, 20),
    (1, 8, 2, 64, 16, 3),
    (1, 8, 2, 64, 128, 3),
    (1, 8, 2, 128, 16, 4),
    (1, 2, 2, 128, 128, 3),
    (5, 8, 2, 64, 16, 3),
    (5, 8, 2, 64, 128, 3),
    (5, 8, 2, 128, 16, 4),
    (11, 2, 2, 128, 64, 3),
    (3, 8, 2, 128, 16, 5),
    (128, 2, 2, 128, 64, 4),
    (37, 8, 2, 64, 128, 2),
    (100, 8, 2, 128, 16, 12),
    (128, 4, 2, 128, 128, 17),
    (1, 32, 32, 128, 128, 17),
    (1, 32, 8, 128, 128, 17),
    (1, 8, 2, 64, 16, 64),
    (2, 8, 2, 64, 16, 5),
    (4, 2, 2, 128, 32, 6),
]


def _design(C, H, KV, dtype):
    if C * (H // KV) <= 8:
        return "decode"
    return "mma" if dtype == torch.bfloat16 else "tf32x3"


def _one_launch(before, name, pool, design):
    """The wrapper counted exactly one launch of ``name``, on ``pool``, in
    ``design``."""
    for counts, key in ((tk.LAUNCHES, f"{name}[{tk.pool_type(pool)}]"),
                        (tk.DESIGN_LAUNCHES, f"{name}[{design}]")):
        moved = {k: v - before[k] for k, v in counts.items() if v != before[k]}
        assert moved == {key: 1}


@pytest.mark.parametrize("shape", PAGED_SHAPES, ids=lambda s: "C{}-H{}-KV{}-dk{}-ps{}".format(*s))
@pytest.mark.parametrize("quant", [None, "int8", "int4"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_ragged_paged_attention_matches_plain_version(cuda_device, dtype, quant, shape):
    C, H, KV, dk, ps, NP = shape
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    q, kp, vp, ks, vs, table, mask = _paged_case(gen, cuda_device, dtype, quant,
                                                 3, C, H, KV, dk, ps, NP)
    before = {**tk.LAUNCHES, **tk.DESIGN_LAUNCHES}
    out = tk.ragged_paged_attention(q, kp, vp, table, mask, k_scale=ks, v_scale=vs)
    ref = tk.ragged_paged_attention_ref(q, kp, vp, table, mask, k_scale=ks, v_scale=vs)
    torch.testing.assert_close(out, ref, **TOL[dtype])
    assert (out[0, 0] == 0).all() and (out[1] == 0).all()  # nothing to attend gives zeros
    _one_launch(before, "ragged_paged_attention", kp, _design(C, H, KV, dtype))


@pytest.mark.parametrize("partial", [False, True], ids=["rope-full", "rope-partial"])
@pytest.mark.parametrize("shape", PAGED_SHAPES, ids=lambda s: "C{}-H{}-KV{}-dk{}-ps{}".format(*s))
@pytest.mark.parametrize("quant", [None, "int8", "int4"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_fused_rope_paged_attention_bitwise_vs_unfused(cuda_device, dtype, quant, shape,
                                                            partial):
    """Pools and scales (non-scratch pages) and the outputs of rows that
    never read the scratch page equal the unfused composition (RoPE,
    scatter or quant_line_write, ragged kernel) bit for bit; the output
    is within the kernel tolerance of the plain version. Slot 2's last
    column is a padding token: its line goes to the scratch page. A
    partial rotary width passes the head tails through: dk / 2 at dk 64
    (16-byte RoPE), dk / 2 + 8 at dk 128 (a width the commit rotates one
    dim at a time)."""
    from flexflow_tpu_torch.models import llama as tl
    from flexflow_tpu_torch.serve import kv_quant as kq

    C, H, KV, dk, ps, NP = shape
    gen = torch.Generator(device=cuda_device).manual_seed(2)
    R = 3
    q, kp, vp, ks, vs, table, mask = _paged_case(gen, cuda_device, dtype, quant,
                                                 R, C, H, KV, dk, ps, NP)
    P = R * NP
    k_new = torch.randn(R, C, KV, dk, generator=gen, device=cuda_device).to(dtype)
    v_new = torch.randn(R, C, KV, dk, generator=gen, device=cuda_device).to(dtype)
    top = (NP - 1) * ps - C  # the new lines fill allocated pages
    pos = torch.arange(C, device=cuda_device)[None, :] + torch.tensor(
        [[min(3, top)], [min(17, top)], [top]], device=cuda_device)
    pos[2, C - 1] = NP * ps - 1  # on the scratch page
    cos, sin = tl.rope_freqs(tl.LLaMAConfig(hidden_size=H * dk, num_attention_heads=H,
                                            num_key_value_heads=KV), pos)
    if partial:
        rot = dk // 2 + (8 if dk == 128 else 0)
        cos, sin = cos[..., :rot].contiguous(), sin[..., :rot].contiguous()
    logical = (pos // ps).to(torch.int32)
    off = (pos % ps).to(torch.int32)
    qmax = None if quant is None else kq.SPECS[quant].qmax

    def clones():
        return [None if t is None else t.clone() for t in (kp, vp, ks, vs)]

    def rope(x):
        if partial:
            return tk._rope_rotate(x, cos[:, :, None], sin[:, :, None])
        return tl.apply_rope(x, cos, sin)

    a, b, c = clones(), clones(), clones()
    before = {**tk.LAUNCHES, **tk.DESIGN_LAUNCHES}
    fused = tk.fused_rope_paged_attention(q, k_new, v_new, cos, sin, a[0], a[1], table,
                                          logical, off, mask, k_scale=a[2],
                                          v_scale=a[3], qmax=qmax)
    _one_launch(before, "fused_rope_paged_attention", kp, _design(C, H, KV, dtype))
    qr, kr = rope(q), rope(k_new)
    phys = table.long().gather(1, logical.long())
    tk.commit_paged(b[0], b[1], kr, v_new, phys, off.long(), b[2], b[3], qmax)
    unfused = tk.ragged_paged_attention(qr, b[0], b[1], table, mask, k_scale=b[2],
                                        v_scale=b[3])
    ref = tk.fused_rope_paged_attention_ref(q, k_new, v_new, cos, sin, c[0], c[1], table,
                                            logical, off, mask, k_scale=c[2],
                                            v_scale=c[3], qmax=qmax)
    torch.cuda.synchronize()
    for x, y in zip(a, b):
        if x is not None:
            assert torch.equal(x[:P], y[:P])
    reads_scratch = (mask & (table == P).repeat_interleave(ps, dim=1)[:, None]).any(-1)
    assert reads_scratch[2, C - 1] and (C == 1 or not reads_scratch[2, 0])
    assert torch.equal(fused[~reads_scratch], unfused[~reads_scratch])
    torch.testing.assert_close(fused[~reads_scratch], ref[~reads_scratch], **TOL[dtype])
    assert (fused[1] == 0).all()


_POISON_SRC = r"""
#include <cuda_runtime.h>
// fills the dynamic shared memory of every block with 0xFF bytes (f32 NaN)
__global__ void poison(int words) {
  extern __shared__ unsigned int smem[];
  volatile unsigned int* w = smem;
  for (int i = threadIdx.x; i < words; i += blockDim.x) w[i] = 0xFFFFFFFFu;
}
extern "C" int poison_launch(int blocks, int bytes, void* stream) {
  cudaFuncSetAttribute(poison, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  poison<<<blocks, 256, bytes, static_cast<cudaStream_t>(stream)>>>(bytes / 4);
  return (int)cudaGetLastError();
}
"""


@pytest.fixture
def poison_smem(cuda_device, tmp_path):
    """A callable that fills the shared memory of every SM with NaN bits
    on the current stream, so a kernel launched next that reads shared
    memory it never wrote sees NaN rather than a leftover that happens to
    be harmless."""
    import ctypes
    import subprocess

    from flexflow_tpu_torch.serve import _cuda

    src, lib_path = tmp_path / "poison.cu", tmp_path / "poison.so"
    src.write_text(_POISON_SRC)
    subprocess.run([_cuda._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
                    "-Xcompiler", "-fPIC", "-o", str(lib_path), str(src)], check=True)
    lib = ctypes.CDLL(str(lib_path))
    lib.poison_launch.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    props = torch.cuda.get_device_properties(cuda_device)
    nbytes = 227 * 1024  # the most one block may take on sm_90

    def run():
        err = lib.poison_launch(4 * props.multi_processor_count, nbytes,
                                torch.cuda.current_stream(cuda_device).cuda_stream)
        assert err == 0, f"poison launch failed: CUDA error {err}"

    return run


# (C, H, KV, dk, ps, NP): caches of 80 and 96 lines, whose last 64-line
# tile runs past the last page (ps 16 and 32)
@pytest.mark.parametrize("shape", [(3, 8, 2, 128, 16, 5), (20, 2, 2, 64, 32, 3)],
                         ids=lambda s: "C{}-H{}-KV{}-dk{}-ps{}".format(*s))
@pytest.mark.parametrize("quant", [None, "int8", "int4"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cuda_paged_mma_tile_ignores_stale_shared_memory(cuda_device, poison_smem, dtype,
                                                         quant, shape):
    """The tensor-core tiles ("mma" for bf16 q, "tf32x3" for f32 q) read
    no shared memory they did not write: after every SM's shared memory is
    filled with NaN bits, the ragged and fused kernels' outputs are finite
    and match the plain version."""
    from flexflow_tpu_torch.serve import kv_quant as kq

    C, H, KV, dk, ps, NP = shape
    gen = torch.Generator(device=cuda_device).manual_seed(4)
    q, kp, vp, ks, vs, table, mask = _paged_case(gen, cuda_device, dtype, quant,
                                                 3, C, H, KV, dk, ps, NP)
    assert _design(C, H, KV, dtype) == ("mma" if dtype == torch.bfloat16 else "tf32x3")
    ref = tk.ragged_paged_attention_ref(q, kp, vp, table, mask, k_scale=ks, v_scale=vs)
    poison_smem()
    out = tk.ragged_paged_attention(q, kp, vp, table, mask, k_scale=ks, v_scale=vs)
    assert out.isfinite().all()
    torch.testing.assert_close(out, ref, **TOL[dtype])
    # the fused kernel, with no new line (C lines written back unchanged
    # would move the scales of a quantized page): RoPE off, every line on
    # the scratch page, whose lines no compared row reads
    P = 3 * NP
    logical = torch.full((3, C), NP - 1, dtype=torch.int32, device=cuda_device)
    off = torch.zeros(3, C, dtype=torch.int32, device=cuda_device)
    zeros = torch.zeros(3, C, KV, dk, dtype=dtype, device=cuda_device)
    qmax = None if quant is None else kq.SPECS[quant].qmax
    pools = [None if t is None else t.clone() for t in (kp, vp, ks, vs)]
    poison_smem()
    fused = tk.fused_rope_paged_attention(q, zeros, zeros, None, None, pools[0], pools[1],
                                          table, logical, off, mask, k_scale=pools[2],
                                          v_scale=pools[3], qmax=qmax)
    reads_scratch = (mask & (table == P).repeat_interleave(ps, dim=1)[:, None]).any(-1)
    assert fused[~reads_scratch].isfinite().all()
    torch.testing.assert_close(fused[~reads_scratch], ref[~reads_scratch], **TOL[dtype])


@pytest.mark.parametrize("S1", [100, 4352])
@pytest.mark.parametrize("G", [1, 4])
@pytest.mark.parametrize("dk", [64, 128])
def test_cuda_verify_tf32x3_ignores_stale_shared_memory(cuda_device, poison_smem, dk, G, S1):
    """The f32 tensor-core verify tile ("tf32x3") reads no shared memory it
    did not write, and keeps f32 accuracy over a long walk: after every
    SM's shared memory is filled with NaN bits, the output is finite and
    within the f32 tolerance (1e-5) of the plain version, MHA and GQA,
    on a 100-line cache (a last tile past its end, a 128-row pass with rows
    past the last) and on a 4352-line one."""
    gen = torch.Generator(device=cuda_device).manual_seed(8)
    q, k, v, mask = _verify_case(gen, cuda_device, torch.float32, 20, G, dk, S1)
    ref = tk.verify_attention_ref(q, k, v, mask)
    poison_smem()
    before = dict(tk.DESIGN_LAUNCHES)
    out = tk.verify_attention(q, k, v, mask)
    assert tk.DESIGN_LAUNCHES["verify_attention[tf32x3]"] == (
        before["verify_attention[tf32x3]"] + 1)
    assert out.isfinite().all()
    torch.testing.assert_close(out, ref, **TOL[torch.float32])
    assert (out[1, 0] == 0).all()


# ---------------------------------------------------------------------------
# the split decode design (csrc/paged_decode.cuh)

# (H, KV, dk, ps, NP): LLaMA-7B at page size 128 (MHA and KV 8), dk 64 at
# page size 16 with 64 pages
SPLIT_SHAPES = [(32, 32, 128, 128, 17), (32, 8, 128, 128, 17), (8, 2, 64, 16, 64)]


def _decode_case(gen, dev, dtype, quant, H, KV, dk, ps, NP):
    """A decode step (C = 1) of six slots whose lengths end on and around
    the boundaries of the decode design's splits: 0 (an idle slot: its
    line is padding, written to the scratch page, its row attends
    nothing), 1, one split, one split and a line (its new line is the
    first line of split 1), two splits less a line, and the whole table
    but the scratch page. Returns q, pools, scales, the table (the pages a
    slot holds distinct, the rest on the scratch page P), the causal mask,
    the new lines' positions and the split length in lines."""
    from flexflow_tpu_torch.serve import kv_quant as kq

    R = 6
    pages, n = tk.paged_decode_split(R, 1, KV, NP, ps)
    assert n > 1
    L = pages * ps
    lens = torch.tensor([0, 1, L, L + 1, 2 * L - 1, (NP - 1) * ps], device=dev)
    assert int(lens.max()) <= (NP - 1) * ps and 2 * L - 1 <= (NP - 1) * ps
    P = R * NP
    q = torch.randn(R, 1, H, dk, generator=gen, device=dev).to(dtype)
    lines = torch.randn(2, P + 1, ps, KV, dk, generator=gen, device=dev)
    held = -(-lens // ps)
    table = torch.randperm(P, generator=gen, device=dev).reshape(R, NP).to(torch.int32)
    table[torch.arange(NP, device=dev)[None, :] >= held[:, None]] = P
    mask = (torch.arange(NP * ps, device=dev)[None, :] < lens[:, None])[:, None]
    pos = torch.where(lens > 0, lens - 1, NP * ps - 1)[:, None]
    if quant is None:
        return q, lines[0].to(dtype), lines[1].to(dtype), None, None, table, mask, pos, L
    spec = kq.SPECS[quant]
    s = lines.abs().amax(dim=(2, 4)) / spec.qmax + 1e-3
    codes = torch.round(lines / s[:, :, None, :, None]).clamp(-spec.qmax, spec.qmax)
    pools = kq.pack_codes(codes, spec.dtype, spec.pack)
    return (q, pools[0].contiguous(), pools[1].contiguous(), s[0].contiguous(),
            s[1].contiguous(), table, mask, pos, L)


@pytest.mark.parametrize("shape", SPLIT_SHAPES, ids=lambda s: "H{}-KV{}-dk{}-ps{}-NP{}".format(*s))
@pytest.mark.parametrize("quant", [None, "int8", "int4"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_paged_decode_split_boundaries_and_fused_bitwise(cuda_device, dtype, quant, shape):
    """Decode lengths that end on a split boundary, a line past it and a
    line before it: the ragged kernel within the tolerance of the plain
    version (an idle slot gives zeros); the fused kernel bitwise the
    unfused path (RoPE, commit, ragged kernel) on the outputs of the slots
    that read no scratch line, on the non-scratch pools and on the
    scales, with one slot's new line the first line of a split and, on
    quantized pools, another slot's new line fifty times larger than its
    page's lines, so that the page's scale grows and its codes are
    requantized."""
    from flexflow_tpu_torch.models import llama as tl
    from flexflow_tpu_torch.serve import kv_quant as kq

    H, KV, dk, ps, NP = shape
    gen = torch.Generator(device=cuda_device).manual_seed(9)
    q, kp, vp, ks, vs, table, mask, pos, L = _decode_case(gen, cuda_device, dtype, quant,
                                                          H, KV, dk, ps, NP)
    R, P = q.shape[0], q.shape[0] * NP
    q[4] /= 64  # see slot 4's new line below
    assert int(pos[3, 0]) == L  # the first line of split 1
    before = {**tk.LAUNCHES, **tk.DESIGN_LAUNCHES}
    out = tk.ragged_paged_attention(q, kp, vp, table, mask, k_scale=ks, v_scale=vs)
    _one_launch(before, "ragged_paged_attention", kp, "decode")
    ref = tk.ragged_paged_attention_ref(q, kp, vp, table, mask, k_scale=ks, v_scale=vs)
    torch.testing.assert_close(out, ref, **TOL[dtype])
    assert (out[0] == 0).all()

    k_new = torch.randn(R, 1, KV, dk, generator=gen, device=cuda_device).to(dtype)
    v_new = torch.randn(R, 1, KV, dk, generator=gen, device=cuda_device).to(dtype)
    # slot 4's new line, at in-page offset ps - 2 of a page its other lines
    # fill, grows the page's scales; its query, 64 times smaller, spreads
    # the softmax over the slot's lines, so the output stays near unit
    # scale, where the f32 tolerance is stated
    k_new[4] *= 50
    v_new[4] *= 50
    assert int(pos[4, 0]) % ps != 0
    cos, sin = tl.rope_freqs(tl.LLaMAConfig(hidden_size=H * dk, num_attention_heads=H,
                                            num_key_value_heads=KV), pos)
    logical = (pos // ps).to(torch.int32)
    off = (pos % ps).to(torch.int32)
    qmax = None if quant is None else kq.SPECS[quant].qmax
    a = [None if t is None else t.clone() for t in (kp, vp, ks, vs)]
    b = [None if t is None else t.clone() for t in (kp, vp, ks, vs)]
    before = {**tk.LAUNCHES, **tk.DESIGN_LAUNCHES}
    fused = tk.fused_rope_paged_attention(q, k_new, v_new, cos, sin, a[0], a[1], table,
                                          logical, off, mask, k_scale=a[2], v_scale=a[3],
                                          qmax=qmax)
    _one_launch(before, "fused_rope_paged_attention", kp, "decode")
    qr, kr = tl.apply_rope(q, cos, sin), tl.apply_rope(k_new, cos, sin)
    phys = table.long().gather(1, logical.long())
    tk.commit_paged(b[0], b[1], kr, v_new, phys, off.long(), b[2], b[3], qmax)
    unfused = tk.ragged_paged_attention(qr, b[0], b[1], table, mask, k_scale=b[2],
                                        v_scale=b[3])
    torch.cuda.synchronize()
    for x, y in zip(a, b):
        if x is not None:
            assert torch.equal(x[:P], y[:P])
    if quant is not None:
        page = int(phys[4, 0])
        assert a[2][page].ne(ks[page]).all()  # the page's K scale grew
    assert torch.equal(fused[1:], unfused[1:])  # slot 0 alone wrote the scratch page
    assert (fused[0] == 0).all()
    c = [None if t is None else t.clone() for t in (kp, vp, ks, vs)]
    ref = tk.fused_rope_paged_attention_ref(q, k_new, v_new, cos, sin, c[0], c[1], table,
                                            logical, off, mask, k_scale=c[2], v_scale=c[3],
                                            qmax=qmax)
    torch.testing.assert_close(fused, ref, **TOL[dtype])


@pytest.mark.parametrize("quant", [None, "int8", "int4"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_paged_decode_split_is_deterministic(cuda_device, dtype, quant):
    """Two launches of either kernel on the same inputs give the same bits
    (the splits merge in split order, whichever block finishes last), and
    every launch leaves the merge counters at 0."""
    from flexflow_tpu_torch.serve import kv_quant as kq

    H, KV, dk, ps, NP = SPLIT_SHAPES[0]
    gen = torch.Generator(device=cuda_device).manual_seed(10)
    q, kp, vp, ks, vs, table, mask, pos, _ = _decode_case(gen, cuda_device, dtype, quant,
                                                          H, KV, dk, ps, NP)
    outs = [tk.ragged_paged_attention(q, kp, vp, table, mask, k_scale=ks, v_scale=vs)
            for _ in range(2)]
    assert torch.equal(outs[0], outs[1])
    R = q.shape[0]
    k_new = torch.randn(R, 1, KV, dk, generator=gen, device=cuda_device).to(dtype)
    v_new = torch.randn(R, 1, KV, dk, generator=gen, device=cuda_device).to(dtype)
    logical = (pos // ps).to(torch.int32)
    off = (pos % ps).to(torch.int32)
    qmax = None if quant is None else kq.SPECS[quant].qmax
    runs = []
    for _ in range(2):
        pools = [None if t is None else t.clone() for t in (kp, vp, ks, vs)]
        out = tk.fused_rope_paged_attention(q, k_new, v_new, None, None, pools[0], pools[1],
                                            table, logical, off, mask, k_scale=pools[2],
                                            v_scale=pools[3], qmax=qmax)
        runs.append([out] + [t for t in pools if t is not None])
    torch.cuda.synchronize()
    for x, y in zip(*runs):
        assert torch.equal(x, y)
    for _, counters in tk._SPLIT_SCRATCH.values():
        assert (counters == 0).all()


@pytest.mark.parametrize("shape", SPLIT_SHAPES, ids=lambda s: "H{}-KV{}-dk{}-ps{}-NP{}".format(*s))
@pytest.mark.parametrize("quant", [None, "int8", "int4"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cuda_paged_decode_split_ignores_stale_shared_memory(cuda_device, poison_smem, dtype,
                                                             quant, shape):
    """The split decode design reads no shared memory it did not write:
    after every SM's shared memory is filled with NaN bits, the ragged and
    fused kernels' outputs are finite and match the plain version."""
    from flexflow_tpu_torch.serve import kv_quant as kq

    H, KV, dk, ps, NP = shape
    gen = torch.Generator(device=cuda_device).manual_seed(11)
    q, kp, vp, ks, vs, table, mask, pos, _ = _decode_case(gen, cuda_device, dtype, quant,
                                                          H, KV, dk, ps, NP)
    ref = tk.ragged_paged_attention_ref(q, kp, vp, table, mask, k_scale=ks, v_scale=vs)
    poison_smem()
    out = tk.ragged_paged_attention(q, kp, vp, table, mask, k_scale=ks, v_scale=vs)
    assert out.isfinite().all()
    torch.testing.assert_close(out, ref, **TOL[dtype])
    # the fused kernel with every new line on the scratch page (no RoPE),
    # whose lines no row reads
    R = q.shape[0]
    logical = torch.full((R, 1), NP - 1, dtype=torch.int32, device=cuda_device)
    off = torch.zeros(R, 1, dtype=torch.int32, device=cuda_device)
    zeros = torch.zeros(R, 1, KV, dk, dtype=dtype, device=cuda_device)
    qmax = None if quant is None else kq.SPECS[quant].qmax
    pools = [None if t is None else t.clone() for t in (kp, vp, ks, vs)]
    poison_smem()
    fused = tk.fused_rope_paged_attention(q, zeros, zeros, None, None, pools[0], pools[1],
                                          table, logical, off, mask, k_scale=pools[2],
                                          v_scale=pools[3], qmax=qmax)
    assert fused.isfinite().all()
    torch.testing.assert_close(fused, ref, **TOL[dtype])


# ---------------------------------------------------------------------------
# the dense decode kernel on the split walk (csrc/decode_attention.cu)

# (R, S1, H, KV, dk): LLaMA-7B's cache at 4 slots (MHA, KV 8, and KV 2:
# G = 16, two head groups of 8), MQA (H 32 over KV 1: four groups) and
# dk 64 at a short cache
DENSE_SHAPES = [(6, 2113, 32, 32, 128), (6, 2113, 32, 8, 128), (6, 2113, 32, 2, 128),
                (6, 700, 32, 1, 64), (6, 300, 8, 2, 64)]


def _dense_case(gen, dev, dtype, R, S1, H, KV, dk):
    """q and caches of a decode step whose slot lengths end on and around
    the dense split rule's boundaries: 0 (a padding row), 1, one split,
    one split and a line, two splits less a line, and every line of the
    cache. Returns q, k, v, seq_lens and the split length in lines."""
    split, n = tk.dense_decode_split(R, KV, S1, tk.dense_head_groups(H // KV))
    assert n > 1
    lens = [0, 1, split, split + 1, min(2 * split - 1, S1), S1]
    q = torch.randn(R, H, dk, generator=gen, device=dev).to(dtype)
    k = torch.randn(R, S1, KV, dk, generator=gen, device=dev).to(dtype)
    v = torch.randn(R, S1, KV, dk, generator=gen, device=dev).to(dtype)
    return q, k, v, torch.tensor(lens[:R], dtype=torch.int32, device=dev), split


@pytest.mark.parametrize("shape", DENSE_SHAPES, ids=lambda s: "R{}-S1{}-H{}-KV{}-dk{}".format(*s))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_dense_decode_split_boundaries(cuda_device, dtype, shape):
    """Slot lengths on, one past and one before the dense rule's split
    boundaries, a padding row (length 0) and a full cache, at every head
    grouping (G 1, 4, 16, 32): within the kernel tolerance of the plain
    version, the padding row exactly 0, one launch counted."""
    gen = torch.Generator(device=cuda_device).manual_seed(12)
    q, k, v, sl, _ = _dense_case(gen, cuda_device, dtype, *shape)
    before = tk.LAUNCHES["decode_attention"]
    out = tk.decode_attention(q, k, v, sl)
    assert tk.LAUNCHES["decode_attention"] == before + 1
    torch.testing.assert_close(out, tk.decode_attention_ref(q, k, v, sl), **TOL[dtype])
    assert (out[0] == 0).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_dense_decode_split_is_deterministic(cuda_device, dtype):
    """Two launches on the same inputs give the same bits (the splits merge
    in split order, whichever block finishes last), with G = 16 in two
    head groups, and every launch leaves the merge counters at 0."""
    gen = torch.Generator(device=cuda_device).manual_seed(13)
    q, k, v, sl, _ = _dense_case(gen, cuda_device, dtype, *DENSE_SHAPES[2])
    outs = [tk.decode_attention(q, k, v, sl) for _ in range(2)]
    torch.cuda.synchronize()
    assert torch.equal(outs[0], outs[1])
    for _, counters in tk._SPLIT_SCRATCH.values():
        assert (counters == 0).all()


@pytest.mark.parametrize("shape", DENSE_SHAPES[:3], ids=lambda s: "H{2}-KV{3}".format(*s))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_dense_decode_split_ignores_stale_shared_memory(cuda_device, poison_smem, dtype,
                                                            shape):
    """The dense walk reads no shared memory it did not write: after every
    SM's shared memory is filled with NaN bits, the output is finite and
    matches the plain version."""
    gen = torch.Generator(device=cuda_device).manual_seed(14)
    q, k, v, sl, _ = _dense_case(gen, cuda_device, dtype, *shape)
    ref = tk.decode_attention_ref(q, k, v, sl)
    poison_smem()
    out = tk.decode_attention(q, k, v, sl)
    assert out.isfinite().all()
    torch.testing.assert_close(out, ref, **TOL[dtype])


# ---------------------------------------------------------------------------
# training flash attention


@pytest.mark.parametrize("S,T", [(128, 128), (100, 100), (77, 150), (150, 77)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dk", [64, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_flash_attention_matches_plain_versions(cuda_device, dtype, dk, causal, S, T):
    """Forward and both backward kernels against their plain versions;
    the forward launched in its design ("wgmma" for bf16)."""
    from flexflow_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device=cuda_device).manual_seed(3)
    B, H = 2, 3

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=cuda_device).to(dtype)

    q, k, v, do = rnd(B, S, H, dk), rnd(B, T, H, dk), rnd(B, T, H, dk), rnd(B, S, H, dk)
    scale = dk ** -0.5
    before = dict(fa.LAUNCHES)
    designs = dict(fa.DESIGN_LAUNCHES)
    out, lse = fa.flash_fwd(q, k, v, causal, scale)
    key = "flash_attention_fwd[{}]".format("wgmma" if dtype == torch.bfloat16 else "f32")
    assert {k_: n - designs[k_] for k_, n in fa.DESIGN_LAUNCHES.items()
            if n != designs[k_]} == {key: 1}
    out_ref, lse_ref = fa.flash_fwd_ref(q, k, v, causal, scale)
    torch.testing.assert_close(out, out_ref, **TOL[dtype])
    torch.testing.assert_close(lse, lse_ref, atol=1e-5, rtol=1e-5)
    grads = fa.flash_bwd(q, k, v, out, lse, do, causal, scale)
    want = fa.flash_bwd_ref(q, k, v, out, lse, do, causal, scale)
    torch.cuda.synchronize()
    for name, g, w in zip(("dq", "dk", "dv"), grads, want):
        assert g.dtype == dtype
        torch.testing.assert_close(g, w, **TOL[dtype], msg=name)
    for name in fa.LAUNCHES:
        assert fa.LAUNCHES[name] == before[name] + 1
    design = "wgmma" if dtype == torch.bfloat16 else "f32"
    assert {k_: n - designs[k_] for k_, n in fa.DESIGN_LAUNCHES.items()
            if n != designs[k_]} == {f"{name}[{design}]": 1 for name in fa.LAUNCHES}


# every pair of 1, 63, 65, 130 and 2048 lines (one line, one partial
# 64-line tile, a tile and one line, a 128-row block and two lines, the
# training length)
FLASH_WGMMA_SIZES = [(S, T) for S in (1, 63, 65, 130, 2048) for T in (1, 63, 65, 130, 2048)]


@pytest.mark.parametrize("S,T", FLASH_WGMMA_SIZES)
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dk", [64, 128])
def test_cuda_flash_wgmma_forward_matches_plain_version(cuda_device, dk, causal, S, T):
    """The bf16 forward (design "wgmma": TMA tiles of 128 query rows and
    64 key lines, zeros past S and T) at every pair of ragged and aligned
    lengths, S != T both ways: out within the bf16 tolerance of the plain
    version, lse to 1e-5; both backward kernels, which read that lse,
    within the bf16 tolerance of theirs."""
    from flexflow_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device=cuda_device).manual_seed(9)
    B, H = 2, 3
    dtype = torch.bfloat16

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=cuda_device).to(dtype)

    q, k, v, do = rnd(B, S, H, dk), rnd(B, T, H, dk), rnd(B, T, H, dk), rnd(B, S, H, dk)
    scale = dk ** -0.5
    designs = dict(fa.DESIGN_LAUNCHES)
    out, lse = fa.flash_fwd(q, k, v, causal, scale)
    assert fa.DESIGN_LAUNCHES["flash_attention_fwd[wgmma]"] == (
        designs["flash_attention_fwd[wgmma]"] + 1)
    out_ref, lse_ref = fa.flash_fwd_ref(q, k, v, causal, scale)
    torch.testing.assert_close(out, out_ref, **TOL[dtype])
    torch.testing.assert_close(lse, lse_ref, atol=1e-5, rtol=1e-5)
    grads = fa.flash_bwd(q, k, v, out, lse, do, causal, scale)
    want = fa.flash_bwd_ref(q, k, v, out, lse, do, causal, scale)
    for name, g, w in zip(("dq", "dk", "dv"), grads, want):
        torch.testing.assert_close(g, w, **TOL[dtype], msg=name)


def test_cuda_flash_wrappers_raise_instead_of_falling_back(cuda_device):
    from flexflow_tpu_torch.ops import flash_attention as fa

    q = torch.zeros(1, 8, 2, 32, device=cuda_device)  # no kernel for head dim 32
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_fwd(q, q, q, True, 0.2)
    q = torch.zeros(1, 8, 2, 64, device=cuda_device)
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_fwd(q, q.transpose(1, 2).contiguous().transpose(1, 2), q, True, 0.2)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        fa.flash_fwd(q.half(), q.half(), q.half(), True, 0.2)


@pytest.mark.parametrize("remat,policy,fwd_launches",
                         [(True, None, 4), (True, "dots", 4), (False, None, 2)])
def test_cuda_bf16_train_step_flash_and_torch(cuda_device, remat, policy, fwd_launches):
    """Two bf16 SGD steps at a small width through the flash kernels and
    through the plain attention, under every remat setting: finite losses
    within bf16's reach of each other that fall, gradients within bf16's
    reach of each other, and per 2-layer step the flash forward launched
    twice per layer under remat (the recompute), once without, and each
    backward kernel once per layer, every launch in the "wgmma" design."""
    from flexflow_tpu_torch import optimizers as topt
    from flexflow_tpu_torch.models import llama as tl
    from flexflow_tpu_torch.ops import flash_attention as fa

    cfg = tl.LLaMAConfig(vocab_size=512, hidden_size=256, intermediate_size=512,
                         num_hidden_layers=2, num_attention_heads=4,
                         num_key_value_heads=2, max_position_embeddings=256)
    toks = torch.randint(0, cfg.vocab_size, (2, 129),
                         generator=torch.Generator().manual_seed(0)).to(cuda_device)
    losses, grads = {}, {}
    for attention in ("flash", "torch"):
        init, step = tl.make_train_step(cfg, topt.SGDOptimizer(lr=0.1), device=cuda_device,
                                        remat=remat, remat_policy=policy,
                                        attention=attention)
        params, opt = init(torch.Generator(device=cuda_device).manual_seed(0))
        # the gradients the step takes, through the same loss and remat
        loss = tl.next_token_loss(
            params, toks, cfg, remat=remat, remat_policy=policy,
            attn_fn=tl.make_flash_attention() if attention == "flash" else None)
        grads[attention] = torch.autograd.grad(loss, topt.tree_leaves(params))
        fa.reset_launch_counts()
        params, opt, loss = step(params, opt, toks)
        torch.cuda.synchronize()
        launched = dict(fa.LAUNCHES)
        by_design = {k_: n for k_, n in fa.DESIGN_LAUNCHES.items() if n}
        losses[attention] = [float(loss), float(step(params, opt, toks)[2])]
        if attention == "flash":
            assert launched == {"flash_attention_fwd": fwd_launches,
                                "flash_attention_bwd_kv": 2, "flash_attention_bwd_q": 2}
            assert by_design == {f"{k_}[wgmma]": n for k_, n in launched.items()}
        else:
            assert not any(launched.values())
    for attention, (first, second) in losses.items():
        assert math.isfinite(first) and math.isfinite(second), losses
        assert second < first, (attention, losses)
    for a, b in zip(losses["flash"], losses["torch"]):
        assert abs(a - b) < 2e-2 * b, losses
    num = sum(float((g - w).double().pow(2).sum()) for g, w in zip(grads["flash"],
                                                                 grads["torch"]))
    den = sum(float(w.double().pow(2).sum()) for w in grads["torch"])
    assert math.sqrt(num / den) < 2e-2


# ---------------------------------------------------------------------------
# whole-step serving kernel


def _whole_case(dev, dtype, quant, C, KV, ps, held=(9, 20, 0), NP=4):
    """A 2-layer LLaMA at small widths (D 256, 4 heads of 64, F 512, V
    512) and a paged cache of NP pages a slot warmed by one unfused step:
    slot r holds held[r] lines (by default slot 0 9, slot 1 20, slot 2
    none: idle). The step under test writes C new lines per live slot
    (an idle slot's columns are padding)."""
    from flexflow_tpu_torch.models import llama as tl

    cfg = tl.LLaMAConfig(vocab_size=512, hidden_size=256, intermediate_size=512,
                         num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=KV,
                         max_position_embeddings=512, dtype=dtype)
    params = tl.init_params(torch.Generator(device=dev).manual_seed(4), cfg, device=dev)
    R = len(held)
    cache_len = NP * ps - 1
    P = R * NP
    cache = tl.init_paged_kv_cache(cfg, P, ps, kv_quant=quant, device=dev)
    table = torch.full((R, NP), P, dtype=torch.int32)
    for r, n in enumerate(held):
        pages = -(-(n + C) // ps)
        table[r, :pages] = torch.arange(r * NP, r * NP + pages)
    table = table.to(dev)
    gen = torch.Generator().manual_seed(5)
    width = max(held)
    toks = torch.randint(1, cfg.vocab_size, (R, width), generator=gen)
    pos = torch.full((R, width), cache_len)
    for r, n in enumerate(held):
        pos[r, :n] = torch.arange(n)
    tl.serve_step_paged(params, cache, toks.to(dev), pos.to(dev),
                        torch.zeros(R, dtype=torch.long, device=dev), None, None, table,
                        cfg=cfg, cache_len=cache_len, kv_quant=quant)
    toks = torch.randint(1, cfg.vocab_size, (R, C), generator=gen)
    pos = torch.full((R, C), cache_len)
    li = torch.zeros(R, dtype=torch.long)
    for r, n in enumerate(held):
        if n > 0:
            pos[r] = torch.arange(n, n + C)
            li[r] = C - 1 if r % 2 == 0 else max(C - 2, 0)
    step = (toks.to(dev), pos.to(dev), li.to(dev), table)
    return cfg, params, cache, step, cache_len, P


@pytest.mark.parametrize("ps", [16, 128])
@pytest.mark.parametrize("C,KV", [(1, 4), (1, 2), (8, 2)])
@pytest.mark.parametrize("quant", [None, "int8", "int4"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_whole_step_matches_plain_version(cuda_device, dtype, quant, C, KV, ps):
    """The kernel against the plain walk (kernels="torch" on the card) at
    the smallest and the largest tile count it takes: the live slots'
    logits and tokens and the non-scratch pool bytes and scales bitwise
    equal across the two counts; against the
    plain version, f32 logits to 1e-4 relative with equal tokens and pools
    to one code, bf16 logits and pools within bf16's rounding of each
    other (relative L2 2e-2). Each launch counts the attention design of
    its C * G rows a KV head."""
    _check_whole_step(cuda_device, dtype, quant, C, KV, ps)


@pytest.mark.parametrize("quant", [None, "int8", "int4"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_whole_step_mixed_c128_on_the_tensor_core_tile(cuda_device, poison_smem, dtype,
                                                           quant):
    """A C = 128 mixed step with GQA (256 rows a KV head: two 128-row
    passes of the tensor-core tile, "mma" for bf16 and "tf32x3" for f32;
    bf16 projections on wgmma) after NaN-filled shared memory, held as
    above but for bf16, whose 128 new lines a slot carry the two paths'
    roundings into more quantization codes: its logits and pool values
    within twice the plain bf16 step's distance from the same step in f32
    (chip_smoke.py's rule). Its per-stage timer's stamps rise, and the
    stages sum to the stamped span."""
    _check_whole_step(cuda_device, dtype, quant, 128, 2, 128, poison=poison_smem)


def _check_whole_step(cuda_device, dtype, quant, C, KV, ps, poison=None, held=(9, 20, 0),
                      NP=4):
    from flexflow_tpu_torch.models import llama as tl
    from flexflow_tpu_torch.serve import kv_quant as kq

    cfg, params, cache, step, cache_len, P = _whole_case(cuda_device, dtype, quant, C, KV, ps,
                                                         held, NP)
    live = torch.tensor([n > 0 for n in held], device=cuda_device)
    G = cfg.num_attention_heads // KV
    design = ("decode" if C * G <= 8 else "mma" if dtype == torch.bfloat16 else "tf32x3")
    la, _ = tl.whole_step_weight_layout(params, cfg)
    roles = tl.whole_step_tile_roles(cfg)
    x0 = torch.empty((len(held), C, cfg.hidden_size), dtype=dtype, device="meta")
    legal = [t for t in tk.whole_step_tile_candidates(la, roles)
             if tk.whole_step_kernel_takes(la, tiles=t, tile_roles=roles)]
    assert len(legal) >= 2
    runs = {}
    for name, kernels, tiles in (("lo", "cuda", legal[0]), ("hi", "cuda", legal[-1]),
                                 ("plain", "torch", legal[0])):
        c = {k: v.clone() for k, v in cache.items()}
        before = {**tk.LAUNCHES, **tk.DESIGN_LAUNCHES}
        stamps = None
        if kernels == "cuda" and poison is not None:
            stamps = torch.zeros(tk.whole_step_stamp_count(cfg.num_hidden_layers),
                                 dtype=torch.int64, device=cuda_device)
            poison()
        logits, toks, _ = tl.serve_step_whole(params, c, *step, cfg=cfg, cache_len=cache_len,
                                              kv_quant=quant, tiles=tiles, kernels=kernels,
                                              stamps=stamps)
        torch.cuda.synchronize()
        key = f"whole_step_decode[{tk.pool_type(c['k'])}]"
        assert tk.LAUNCHES[key] == before[key] + (kernels == "cuda")
        dkey = f"whole_step_decode[{design}]"
        assert tk.DESIGN_LAUNCHES[dkey] == before[dkey] + (kernels == "cuda")
        if stamps is not None:
            t = stamps.tolist()
            assert all(x > 0 for x in t) and t == sorted(t)
            stages = tk.whole_step_stage_ms(t, cfg.num_hidden_layers)
            assert sum(stages.values()) == pytest.approx((t[-1] - t[0]) / 1e6, rel=1e-9)
        runs[name] = (logits, toks, c)
    # an idle slot's logits read the scratch page, which every padding
    # line writes in no fixed order
    (lo, tlo, clo), (hi, thi, chi), (pl, tpl, cpl) = (
        (lg[live], tk_[live], c) for lg, tk_, c in (runs["lo"], runs["hi"], runs["plain"]))
    assert torch.equal(lo, hi) and torch.equal(tlo, thi)
    for k in clo:
        assert torch.equal(clo[k][:, :P], chi[k][:, :P]), k
    assert bool(torch.isfinite(lo).all())
    assert torch.equal(tlo, torch.argmax(lo, dim=-1))
    pack = 1 if quant is None else kq.SPECS[quant].pack

    def rel(a, b):
        return float((a.double() - b.double()).norm() / b.double().norm())

    if dtype == torch.float32:
        assert rel(lo, pl) <= 1e-4 and torch.equal(tlo, tpl)
        for k in ("k", "v"):
            d = kq.unpack_codes(clo[k][:, :P], pack) - kq.unpack_codes(cpl[k][:, :P], pack)
            assert float(d.abs().max()) <= (1e-4 if quant is None else 1.0), k
    elif poison is None:
        assert rel(lo, pl) <= 2e-2
        for k in ("k", "v"):
            a, b = clo[k][:, :P], cpl[k][:, :P]
            if quant is not None:
                s = f"{k}_scale"
                a = kq.unpack_codes(a, pack) * clo[s][:, :P, None, :, None]
                b = kq.unpack_codes(b, pack) * cpl[s][:, :P, None, :, None]
            assert rel(a, b) <= 2e-2, k
    else:
        # the plain step in f32: weights upcast, pools upcast (codes kept)
        def f32(tree):
            return ({k: f32(v) for k, v in tree.items()} if isinstance(tree, dict)
                    else tree.to(torch.float32))

        c32 = {k: (v.to(torch.float32) if quant is None or "scale" in k else v.clone())
               for k, v in cache.items()}
        exact = tl.serve_step_whole(f32(params), c32, *step,
                                    cfg=dataclasses.replace(cfg, dtype=torch.float32),
                                    cache_len=cache_len, kv_quant=quant, tiles=legal[0],
                                    kernels="torch")[0][live]
        assert rel(lo, pl) <= 2 * rel(pl, exact)

        def values(c, k):
            v = kq.unpack_codes(c[k][:, :P], pack).to(torch.float32)
            return v * c[f"{k}_scale"][:, :P, None, :, None] if quant is not None else v
        for k in ("k", "v"):
            assert rel(values(clo, k), values(cpl, k)) <= 2 * rel(values(cpl, k),
                                                                  values(c32, k)), k
        if quant is not None:
            for k in ("k_scale", "v_scale"):
                assert rel(clo[k][:, :P], cpl[k][:, :P]) <= 2 * rel(cpl[k][:, :P],
                                                                    c32[k][:, :P]), k
    if quant is not None and (dtype == torch.float32 or poison is None):
        for s in ("k_scale", "v_scale"):
            torch.testing.assert_close(clo[s][:, :P], cpl[s][:, :P],
                                       rtol=1e-4 if dtype == torch.float32 else 2e-2, atol=0)


# slots whose lengths span several splits of the decode design (pages of
# 16, 40 a slot: the split rule cuts them into 10 splits of 4 pages) and
# two idle slots, which take no split item
WHOLE_SPLIT_HELD = (9, 300, 0, 620, 0, 64)


@pytest.mark.parametrize("KV", [4, 1])
@pytest.mark.parametrize("quant", [None, "int8", "int4"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_whole_step_decode_splits_match_plain_version(cuda_device, dtype, quant, KV):
    """A decode step whose slots span several splits of the split walk
    (MHA and G = 4), held as test_cuda_whole_step_matches_plain_version
    holds the short ones; the split rule gives more than one split, and
    every launch leaves the merge counters at 0."""
    R, NP, ps = len(WHOLE_SPLIT_HELD), 40, 16
    assert tk.paged_decode_split(R, 1, KV, NP, ps)[1] > 1
    _check_whole_step(cuda_device, dtype, quant, 1, KV, ps, held=WHOLE_SPLIT_HELD, NP=NP)
    for _, counters in tk._SPLIT_SCRATCH.values():
        assert (counters == 0).all()


@pytest.mark.parametrize("quant", [None, "int8", "int4"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cuda_whole_step_decode_splits_ignore_stale_shared_memory(cuda_device, poison_smem,
                                                                  dtype, quant):
    """The whole step's split walk (its scratch in the kernel's dynamic
    shared memory) after NaN-filled shared memory, GQA (G = 4): held to the
    plain version by the bf16 rule of the C = 128 case, its stamps rising."""
    _check_whole_step(cuda_device, dtype, quant, 1, 1, 16, poison=poison_smem,
                      held=WHOLE_SPLIT_HELD, NP=40)


@pytest.mark.parametrize("C,num_layers", [(7, None), (25, None), (3, 1)])
@pytest.mark.parametrize("quant", [None, "int8", "int4"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_whole_step_fold_matches_plain_version(cuda_device, dtype, quant, C, num_layers):
    """The speculation fold: a tree step (node i of a random tree at line
    prefix + i, across a page boundary; rows that attend no prefix of the
    cache; an idle slot) with the all-positions head, over every layer or
    the first one. Every live row's logits and tokens and the non-scratch
    pools are bitwise equal at two tile counts and held to the plain walk
    as test_cuda_whole_step_matches_plain_version holds them; the layers
    past num_layers keep their pools; the launch counts the "-tree"
    design."""
    from flexflow_tpu_torch.models import llama as tl
    from flexflow_tpu_torch.serve import kv_quant as kq

    held = (9, 20, 0)
    cfg, params, cache, (toks, _, li, table), cache_len, P = _whole_case(
        cuda_device, dtype, quant, C, 2, 16, held, NP=8)
    gen = torch.Generator().manual_seed(9)
    pos = torch.full((3, C), cache_len)
    cpos = torch.full((3, C), cache_len)
    mask = torch.zeros((3, C, cache_len + 1), dtype=torch.bool)
    for r, n in enumerate(held):
        if n == 0:
            continue
        parent = [-1] + [int(torch.randint(0, i, (1,), generator=gen)) for i in range(1, C)]
        for i in range(C):
            depth, j = 0, i
            mask[r, i, :n] = True
            while j >= 0:
                mask[r, i, n + j] = True
                j, depth = parent[j], depth + 1
            pos[r, i], cpos[r, i] = n + depth - 1, n + i
    fold = dict(mask=mask.to(cuda_device), cache_positions=cpos.to(cuda_device),
                all_logits=True, num_layers=num_layers)
    step = (toks, pos.to(cuda_device), li, table)
    live = (cpos < cache_len).to(cuda_device)
    la, _ = tl.whole_step_weight_layout(params, cfg)
    legal = [t for t in tk.whole_step_tile_candidates(la, tl.whole_step_tile_roles(cfg))
             if tk.whole_step_kernel_takes(la, tiles=t, tile_roles=tl.whole_step_tile_roles(cfg))]
    design = ("decode" if C * 2 <= 8 else "mma" if dtype == torch.bfloat16 else "tf32x3")
    runs = {}
    for name, kernels, tiles in (("lo", "cuda", legal[0]), ("hi", "cuda", legal[-1]),
                                 ("plain", "torch", legal[0])):
        c = {k: v.clone() for k, v in cache.items()}
        before = tk.DESIGN_LAUNCHES[f"whole_step_decode[{design}-tree]"]
        logits, greedy, _ = tl.serve_step_whole(params, c, *step, cfg=cfg, cache_len=cache_len,
                                                kv_quant=quant, tiles=tiles, kernels=kernels,
                                                **fold)
        torch.cuda.synchronize()
        assert logits.shape == (3, C, cfg.vocab_size) and greedy.shape == (3, C)
        assert (tk.DESIGN_LAUNCHES[f"whole_step_decode[{design}-tree]"]
                == before + (kernels == "cuda"))
        n = num_layers or cfg.num_hidden_layers
        for k in c:
            assert torch.equal(c[k][n:], cache[k][n:]), k
        runs[name] = (logits[live], greedy[live], {k: v[:, :P] for k, v in c.items()})
    (lo, tlo, clo), (hi, thi, chi), (pl, tpl, cpl) = runs["lo"], runs["hi"], runs["plain"]
    assert torch.equal(lo, hi) and torch.equal(tlo, thi)
    assert all(torch.equal(clo[k], chi[k]) for k in clo)
    assert bool(torch.isfinite(lo).all()) and torch.equal(tlo, torch.argmax(lo, dim=-1))

    def rel(a, b):
        return float((a.double() - b.double()).norm() / b.double().norm())

    pack = 1 if quant is None else kq.SPECS[quant].pack
    if dtype == torch.float32:
        assert rel(lo, pl) <= 1e-4 and torch.equal(tlo, tpl)
        for k in ("k", "v"):
            d = kq.unpack_codes(clo[k], pack) - kq.unpack_codes(cpl[k], pack)
            assert float(d.abs().max()) <= (1e-4 if quant is None else 1.0), k
        return
    # bf16: logits within bf16's rounding of the plain walk's; pool values
    # within twice the plain bf16 pools' distance from the same step in f32
    # (chip_smoke.py's rule, as the C = 128 case: a tree's C new lines a
    # slot carry the two paths' roundings into more quantization codes)
    assert rel(lo, pl) <= 2e-2

    def f32(tree):
        return ({k: f32(v) for k, v in tree.items()} if isinstance(tree, dict)
                else tree.to(torch.float32))

    c32 = {k: (v.to(torch.float32) if quant is None or "scale" in k else v.clone())
           for k, v in cache.items()}
    tl.serve_step_whole(f32(params), c32, *step, cfg=dataclasses.replace(cfg, dtype=torch.float32),
                        cache_len=cache_len, kv_quant=quant, tiles=legal[0], kernels="torch",
                        **fold)
    c32 = {k: v[:, :P] for k, v in c32.items()}

    def values(c, k):
        v = kq.unpack_codes(c[k], pack).to(torch.float32)
        return v * c[f"{k}_scale"][:, :, None, :, None] if quant is not None else v

    for k in ("k", "v"):
        assert rel(values(clo, k), values(cpl, k)) <= 2 * rel(values(cpl, k), values(c32, k)), k


def test_cuda_whole_step_raises_instead_of_falling_back(cuda_device):
    from flexflow_tpu_torch.models import llama as tl

    cfg, params, cache, step, cache_len, _ = _whole_case(cuda_device, torch.bfloat16, None, 1,
                                                          2, 16)
    with pytest.raises(ValueError, match="tiles"):  # a 128 / 32 = 4-wide K/V tile
        tl.serve_step_whole(params, cache, *step, cfg=cfg, cache_len=cache_len, tiles=32,
                            kernels="cuda")
    small = tl.LLaMAConfig.tiny(dtype=torch.float32)  # head dim 16: no kernel
    p = tl.init_params(torch.Generator(device=cuda_device).manual_seed(0), small,
                       device=cuda_device)
    c = tl.init_paged_kv_cache(small, 4, 16, device=cuda_device)
    table = torch.tensor([[0, 1]], dtype=torch.int32, device=cuda_device)
    one = torch.zeros((1, 1), dtype=torch.long, device=cuda_device)
    with pytest.raises(ValueError, match="head dim"):
        tl.serve_step_whole(p, c, one, one, one[0], table, cfg=small, cache_len=31,
                            kernels="cuda")


# ---------------------------------------------------------------------------
# the f32 backward's summation, the train step's LM head and Adam, the
# unfused quantized commit


def _bwd_f64(q, k, v, do, lse, delta, scale):
    """dq, dk, dv recomputed in f64 from the same lse and delta (causal)."""
    q, k, v, do, lse, delta = (t.double() for t in (q, k, v, do, lse, delta))
    s = torch.einsum("bshd,bthd->bhst", q, k) * scale
    S, T = q.shape[1], k.shape[1]
    mask = torch.arange(S, device=q.device)[:, None] >= torch.arange(T, device=q.device)[None]
    p = torch.where(mask, torch.exp(s - lse[..., None]), 0.0)
    ds = p * (torch.einsum("bshd,bthd->bhst", do, v) - delta[..., None]) * scale
    return (torch.einsum("bhst,bthd->bshd", ds, k), torch.einsum("bhst,bshd->bthd", ds, q),
            torch.einsum("bhst,bshd->bthd", p, do))


@pytest.mark.parametrize("dk", [64, 128])
def test_cuda_flash_f32_backward_sums_as_well_as_the_plain_version(cuda_device, dk):
    """f32 at S 2048, T 1 (one key line sums all 2048 rows): each gradient
    of the f32 kernels at most twice as far from an f64 recomputation as
    the plain version's, and within the f32 tolerance of it."""
    from flexflow_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device=cuda_device).manual_seed(3)
    B, H, S, T = 2, 3, 2048, 1
    q, do = (torch.randn(B, S, H, dk, generator=gen, device=cuda_device) for _ in range(2))
    k, v = (torch.randn(B, T, H, dk, generator=gen, device=cuda_device) for _ in range(2))
    scale = dk ** -0.5
    out, lse = fa.flash_fwd(q, k, v, True, scale)
    delta = fa.delta_rows(out, do).contiguous()
    got = (fa.flash_bwd_q(q, k, v, do, lse, delta, True, scale),
           *fa.flash_bwd_kv(q, k, v, do, lse, delta, True, scale))
    plain = (fa.flash_bwd_q_ref(q, k, v, do, lse, delta, True, scale),
             *fa.flash_bwd_kv_ref(q, k, v, do, lse, delta, True, scale))
    exact = _bwd_f64(q, k, v, do, lse, delta, scale)
    for name, a, b, x in zip(("dq", "dk", "dv"), got, plain, exact):
        err_a = float((a.double() - x).abs().max())
        err_b = float((b.double() - x).abs().max())
        assert err_a <= 2 * err_b, (name, err_a, err_b)


@pytest.mark.parametrize("tied", [False, True], ids=["lm_head", "tied-embed"])
def test_cuda_lm_head_bf16_keeps_f32_accuracy(cuda_device, tied):
    """The bf16 head on the card (products of the bf16 operands with f32
    results, the logits' gradient split hi + lo): logits within 1e-5
    relative L2 of the f32 product of the same bf16 values, dx and dW
    within 2^-12 of the f32 backward's (before their bf16 rounding)."""
    from flexflow_tpu_torch.models import llama as tl

    gen = torch.Generator(device=cuda_device).manual_seed(5)
    N, D, V = 512, 1024, 4000
    x = torch.randn(2, N // 2, D, generator=gen, device=cuda_device).to(torch.bfloat16)
    w = (torch.randn(V, D, generator=gen, device=cuda_device) / D ** 0.5).to(torch.bfloat16)
    head = w.T if tied else w.T.contiguous()
    g = torch.randn(2, N // 2, V, generator=gen, device=cuda_device)
    xa = x.clone().requires_grad_(True)
    ha = head.detach().clone().requires_grad_(True)
    logits = tl.lm_head(xa, ha)
    logits.backward(g)
    x32, h32 = x.to(torch.float32), head.to(torch.float32)
    want = torch.matmul(x32, h32)

    def rel(a, b):
        return float((a.double() - b.double()).norm() / b.double().norm())

    assert logits.dtype == torch.float32 and rel(logits.detach(), want) <= 1e-5
    want_dx = torch.matmul(g, h32.T)
    want_dw = torch.matmul(x32.reshape(N, D).T, g.reshape(N, V))
    assert xa.grad.dtype == ha.grad.dtype == torch.bfloat16
    # the gradients themselves are rounded to bf16 (2^-9): the f32 ones
    # from the split products before that rounding
    dx, dw = tl.head_backward_split(x.reshape(N, D), head, g.reshape(N, V))
    assert rel(dx, want_dx.reshape(N, D)) <= 2.0 ** -12
    assert rel(dw, want_dw) <= 2.0 ** -12
    assert rel(xa.grad, want_dx) <= 2.0 ** -8 and rel(ha.grad, want_dw) <= 2.0 ** -8


@pytest.mark.parametrize("wd", [0.0, 0.01], ids=["no-wd", "wd"])
@pytest.mark.parametrize("n", [1000003, 4096, 5])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_adam_kernel_bitwise_plain_version(cuda_device, dtype, n, wd):
    """Ten steps of the Adam kernel equal ten steps of its plain version
    bit for bit in p, m and v (a tail of fewer than 8 elements, a leaf of
    fewer than 8, one a multiple of 8), one launch a step."""
    from flexflow_tpu_torch import optimizers as topt

    gen = torch.Generator(device=cuda_device).manual_seed(6)
    p = torch.randn(n, generator=gen, device=cuda_device).to(dtype)
    a = [p.clone(), torch.zeros(n, device=cuda_device), torch.zeros(n, device=cuda_device)]
    b = [t.clone() for t in a]
    lr = torch.tensor(1e-3, device=cuda_device)
    before = topt.LAUNCHES["adam_update"]
    for t in range(1, 11):
        g = torch.randn(n, generator=gen, device=cuda_device).to(dtype)
        tt = torch.tensor(float(t), device=cuda_device)
        alpha = lr * torch.sqrt(1.0 - torch.pow(0.999, tt)) / (1.0 - torch.pow(0.9, tt))
        topt.adam_update(a[0], g, a[1], a[2], alpha, 0.9, 0.999, 1e-8, wd)
        topt.adam_update_ref(b[0], g, b[1], b[2], alpha, 0.9, 0.999, 1e-8, wd)
    torch.cuda.synchronize()
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert topt.LAUNCHES["adam_update"] == before + 10


def test_cuda_adam_optimizer_launches_once_a_leaf(cuda_device):
    from flexflow_tpu_torch import optimizers as topt

    params = {"a": torch.zeros(10, 3, device=cuda_device, dtype=torch.bfloat16),
              "b": {"c": torch.zeros(7, device=cuda_device)}}
    opt = topt.AdamOptimizer(lr=0.1)
    state = opt.init(params)
    before = topt.LAUNCHES["adam_update"]
    grads = {"a": torch.ones(10, 3, device=cuda_device, dtype=torch.bfloat16),
             "b": {"c": torch.ones(7, device=cuda_device)}}
    opt.update(grads, state, params)
    assert topt.LAUNCHES["adam_update"] == before + 2
    with pytest.raises(ValueError, match="one dtype"):
        topt.adam_update(params["a"], grads["a"].float(), state["m"]["a"], state["v"]["a"],
                         torch.tensor(0.1, device=cuda_device), 0.9, 0.999, 1e-8)


# (C, R, pages a slot owns, pages no slot owns, padding slots): decode, a
# 128-line chunk and a chunk past the fused kernel's 256 lines, each with
# R * C below P + 1 (quant_line_write's per-line branch) and above it (its
# whole-pool branch; at decode, slots of padding lines make it reachable)
COMMIT_CASES = [(1, 4, 3, 2, 0), (1, 16, 1, 1, 4), (128, 2, 3, 260, 0), (128, 3, 3, 2, 0),
                (300, 2, 6, 600, 0), (300, 2, 6, 2, 0)]


def _commit_branch(case):
    C, R, npages, extra, pad = case
    P1 = (R - pad) * npages + extra + 1
    return "per-line" if R * C < P1 else "whole-pool"


@pytest.mark.parametrize("case", COMMIT_CASES,
                         ids=lambda c: f"C{c[0]}-R{c[1]}-{_commit_branch(c)}")
@pytest.mark.parametrize("dk", [64, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("quant", ["int8", "int4"])
def test_cuda_commit_kernel_bitwise_quant_line_write(cuda_device, quant, dtype, dk, case):
    """One launch of the commit kernel writes K and V bitwise as
    quant_line_write does on every page but the scratch page: codes and
    scales, with offset-0 resets, lines of one page written together,
    growing scales and (whole-pool branch) untouched pages of scale 0."""
    from flexflow_tpu_torch.serve import kv_quant as kq

    C, R, npages, extra, pad = case
    ps, KV = 64, 2
    gen = torch.Generator(device=cuda_device).manual_seed(7)
    P = (R - pad) * npages + extra  # the scratch page is P
    P1 = P + 1
    spec = kq.SPECS[quant]
    codes = torch.randint(-127, 128, (2, P1, ps, KV, dk // spec.pack), generator=gen,
                          device=cuda_device)
    pools = [c.to(torch.int8) if quant == "int8" else (c + 128).to(torch.uint8) for c in codes]
    scales = [torch.rand(P1, KV, generator=gen, device=cuda_device) * 0.05 for _ in range(2)]
    for s_ in scales:
        s_[P - 1] = 0.0  # a page no slot owns, never written
    # slot r owns pages r * npages ..; its C new lines continue a prefix
    start = torch.randint(0, ps, (R,), generator=gen, device=cuda_device)
    start[0] = 0  # slot 0's first line resets its page's scale
    pos = start[:, None] + torch.arange(C, device=cuda_device)[None]
    assert int(pos.max()) < npages * ps
    phys = torch.arange(R, device=cuda_device)[:, None] * npages + pos // ps
    phys[R - pad:] = P  # padding slots: every line on the scratch page
    phys[R - 1, C - 1] = P  # and a padding line at the end of the last slot
    off = pos % ps
    k, v = (torch.randn(R, C, KV, dk, generator=gen, device=cuda_device).to(dtype) * 3
            for _ in range(2))
    want = [t.clone() for t in (*pools, *scales)]
    kq.quant_line_write(want[0], want[2], phys, off, k, spec.qmax)
    kq.quant_line_write(want[1], want[3], phys, off, v, spec.qmax)
    got = [t.clone() for t in (*pools, *scales)]
    before = tk.LAUNCHES[f"paged_commit[{quant}]"]
    tk.commit_paged(got[0], got[1], k, v, phys, off, got[2], got[3], spec.qmax)
    torch.cuda.synchronize()
    assert tk.LAUNCHES[f"paged_commit[{quant}]"] == before + 1
    for x, y in zip(got, want):
        assert torch.equal(x[:P], y[:P])
