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
    # head dims 80 (Phi-2) and 256 (Gemma): decode, mixed steps of 80 rows
    # and C = 128, a 2176-line walk at dk 256 (the f32 tile's one stage)
    (1, 8, 2, 80, 16, 3),
    (20, 8, 2, 80, 64, 20),
    (128, 4, 4, 80, 128, 5),
    (1, 8, 1, 256, 16, 3),
    (1, 4, 4, 256, 128, 3),
    (20, 8, 2, 256, 64, 20),
    (128, 2, 2, 256, 128, 17),
    # MQA decode past the decode design's 8 rows: Falcon-7B (G = 71) and
    # StarCoder (G = 48) on the tensor-core tile, one 128-row block
    (1, 71, 1, 64, 128, 17),
    (1, 48, 1, 128, 128, 17),
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


@pytest.mark.parametrize("partial", [False, True, None], ids=["rope-full", "rope-partial",
                                                             "rope-none"])
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
    partial rotary width passes the head tails through: 32 at dk 64 and
    80 (16-byte RoPE; Phi-2 rotates 32 of 80), dk / 2 + 8 at dk 128 and
    256 (a width the commit rotates one dim at a time). ``partial`` None
    passes no cos/sin: the commit alone (learned positions, ALiBi)."""
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
        rot = 32 if dk <= 80 else dk // 2 + 8
        cos, sin = cos[..., :rot].contiguous(), sin[..., :rot].contiguous()
    logical = (pos // ps).to(torch.int32)
    off = (pos % ps).to(torch.int32)
    qmax = None if quant is None else kq.SPECS[quant].qmax

    def clones():
        return [None if t is None else t.clone() for t in (kp, vp, ks, vs)]

    if partial is None:
        cos = sin = None

    def rope(x):
        if partial is None:
            return x
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
SPLIT_SHAPES = [(32, 32, 128, 128, 17), (32, 8, 128, 128, 17), (8, 2, 64, 16, 64),
                (32, 32, 80, 128, 17), (16, 16, 256, 128, 17), (8, 1, 256, 16, 64),
                (8, 1, 80, 16, 64)]


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


#: generic-decoder bodies of the whole-step kernel at small widths, 2
#: layers: (family, config overrides). Phi's head dim 80 with its partial
#: rotary (32 dims), every bias and an untied biased head; Gemma's head dim
#: 256 (H * dk = 512 against D = 384), RMS by 1 + w and GeGLU-tanh, MQA;
#: Falcon-7B's width (71 heads on one KV head: G = 71) with LayerNorm,
#: GELU and a parallel block on one norm; GPT-2 XL's width (1600) with
#: learned positions, no RoPE and V = 50257 on a tied head; a bias on every role with a parallel
#: block on two norms, ReLU and an untied head of V = 517 (rows not
#: 16-byte aligned); OPT's learned positions at offset 2, sequential,
#: ReLU; Qwen2's Q/K/V biases with SwiGLU
GENERIC_WHOLE = {
    "phi-dk80": ("phi", dict(hidden_size=320, intermediate_size=640, num_attention_heads=4,
                             num_key_value_heads=4, rotary_pct=0.4, vocab_size=512)),
    "gemma-dk256": ("gemma", dict(hidden_size=384, intermediate_size=512,
                                  num_attention_heads=2, num_key_value_heads=1,
                                  head_dim_override=256, vocab_size=512)),
    "falcon-G71": ("falcon", dict(hidden_size=4544, intermediate_size=512,
                                  num_attention_heads=71, num_key_value_heads=1,
                                  vocab_size=512)),
    "gpt2-V50257": ("gpt2", dict(hidden_size=1600, intermediate_size=512,
                                 num_attention_heads=25, num_key_value_heads=25,
                                 vocab_size=50257)),
    "biases-two-norms": ("falcon", dict(hidden_size=256, intermediate_size=512,
                                        num_attention_heads=4, num_key_value_heads=2,
                                        parallel_two_norms=True, qkv_bias=True, out_bias=True,
                                        mlp_bias=True, activation="relu", lm_head_bias=True,
                                        vocab_size=517)),
    "opt": ("opt", dict(hidden_size=256, intermediate_size=512, num_attention_heads=4,
                        num_key_value_heads=4, vocab_size=512)),
    "qwen2": ("qwen2", dict(hidden_size=256, intermediate_size=512, num_attention_heads=4,
                            num_key_value_heads=2, vocab_size=512)),
}


def _generic_family(name, dtype):
    """The module and config of a GENERIC_WHOLE case."""
    import flexflow_tpu_torch.models as zoo

    family, kw = GENERIC_WHOLE[name]
    module = getattr(zoo, family)
    return module, module.tiny(num_hidden_layers=2, max_position_embeddings=512, dtype=dtype,
                               **kw)


# f32 logits of the kernel against the plain version on a quantized pool,
# where codes at a rounding tie may part (chip_smoke.py F32_TIE_REL_L2:
# 1.5 times the largest such move measured at LLaMA-7B widths)
F32_TIE_REL_L2 = 7e-3


def _draw_vectors(params, gen):
    """Norm scales at 1 + 0.2 N(0, 1) and biases at 0.2 N(0, 1) (their
    initial ones and zeros would leave a wrong offset unseen), in place."""
    def draw(name, t):
        if t.dim() > 2 or name in ("embed", "pos_embed", "lm_head") or not (
                "norm" in name or name.startswith("b") or name.endswith("_bias")):
            return
        noise = 0.2 * torch.randn(t.shape, generator=gen, device=t.device)
        t.copy_((noise + (1.0 if name.endswith("_scale") else 0.0)).to(t.dtype))

    for name, t in params["layers"].items():
        draw(name, t)
    for name, t in params.items():
        if name != "layers":
            draw(name, t)


def _whole_case(dev, dtype, quant, C, KV, ps, held=(9, 20, 0), NP=4, family=None):
    """A 2-layer LLaMA at small widths (D 256, 4 heads of 64, F 512, V
    512), or the GENERIC_WHOLE case ``family`` (its norms and biases drawn
    at random; KV is the config's), and a paged cache of NP pages a slot
    warmed by one unfused step:
    slot r holds held[r] lines (by default slot 0 9, slot 1 20, slot 2
    none: idle). The step under test writes C new lines per live slot
    (an idle slot's columns are padding). Returns the model module too."""
    from flexflow_tpu_torch.models import llama as tl

    if family is None:
        model = tl
        cfg = tl.LLaMAConfig(vocab_size=512, hidden_size=256, intermediate_size=512,
                             num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=KV,
                             max_position_embeddings=512, dtype=dtype)
    else:
        model, cfg = _generic_family(family, dtype)
    params = model.init_params(torch.Generator(device=dev).manual_seed(4), cfg, device=dev)
    if family is not None:
        _draw_vectors(params, torch.Generator(device=dev).manual_seed(6))
    R = len(held)
    cache_len = NP * ps - 1
    P = R * NP
    cache = model.init_paged_kv_cache(cfg, P, ps, kv_quant=quant, device=dev)
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
    model.serve_step_paged(params, cache, toks.to(dev), pos.to(dev),
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
    return cfg, params, cache, step, cache_len, P, model


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
                      NP=4, family=None):
    from flexflow_tpu_torch.serve import kv_quant as kq

    cfg, params, cache, step, cache_len, P, tl = _whole_case(cuda_device, dtype, quant, C, KV,
                                                             ps, held, NP, family)
    live = torch.tensor([n > 0 for n in held], device=cuda_device)
    G = cfg.num_attention_heads // cfg.num_key_value_heads
    design = ("decode" if C * G <= 8 else "mma" if dtype == torch.bfloat16 else "tf32x3")
    la, _ = tl.whole_step_weight_layout(params, cfg)
    roles = tl.whole_step_tile_roles(cfg)
    x0 = torch.empty((len(held), C, cfg.hidden_size), dtype=dtype, device="meta")
    legal = [t for t in tk.whole_step_tile_candidates(la, roles)
             if tk.whole_step_kernel_takes(la, tiles=t, tile_roles=roles)]
    # the gate's count (the smallest legal one whose items fit the shared
    # memory: at Falcon's width in f32 not the smallest legal) and the largest
    gate, _ = tk.whole_step_pick_tiles(la, cache, x0, cfg.num_attention_heads, tile_roles=roles,
                                       budget=tk.WHOLE_STEP_SMEM_BUDGET)
    assert gate is not None and gate < legal[-1]
    runs = {}
    for name, kernels, tiles in (("lo", "cuda", gate), ("hi", "cuda", legal[-1]),
                                 ("plain", "torch", gate)):
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

    # bf16: a generic body (its biases, LayerNorms and activations round
    # in more places) and the stale-shared-memory runs are held by
    # chip_smoke.py's rule, against the same step in f32
    by_f32 = poison is not None or family is not None
    if dtype == torch.float32:
        # a generic body's f32 lines on quantized pools: a value at a
        # rounding tie may take the other code in the kernel's summation
        # order (chip_smoke.py's F32_TIE_REL_L2); LLaMA's small cases hold
        # summation order alone
        tol = F32_TIE_REL_L2 if family is not None and quant is not None else 1e-4
        assert rel(lo, pl) <= tol and torch.equal(tlo, tpl)
        for k in ("k", "v"):
            d = kq.unpack_codes(clo[k][:, :P], pack) - kq.unpack_codes(cpl[k][:, :P], pack)
            assert float(d.abs().max()) <= (1e-4 if quant is None else 1.0), k
    elif not by_f32:
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
                                    cache_len=cache_len, kv_quant=quant, tiles=gate,
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
    if quant is not None and (dtype == torch.float32 or not by_f32):
        for s in ("k_scale", "v_scale"):
            torch.testing.assert_close(clo[s][:, :P], cpl[s][:, :P],
                                       rtol=1e-4 if dtype == torch.float32 else 2e-2, atol=0)


def _meta_params(cfg):
    """A family's parameter tree as "meta" tensors (shapes alone)."""
    from flexflow_tpu_torch.models import transformer as tt

    specs = tt._param_specs(cfg)
    return {k: ({n: torch.empty(s[0], dtype=cfg.dtype, device="meta") for n, s in v.items()}
                if k == "layers" else torch.empty(v[0], dtype=cfg.dtype, device="meta"))
            for k, v in specs.items()}


def test_layout_check_refusals():
    """What the CUDA kernel does not compute raises before a launch: an
    unknown norm or activation, a sequential block without its second
    norm, a bias on an RMS norm, a layer tensor it does not read, a head
    dim outside its instantiations, a width that is no multiple of 32."""
    import flexflow_tpu_torch.models as tzoo
    from flexflow_tpu_torch.models import transformer as tt

    cfg = tzoo.falcon.tiny(hidden_size=256, num_attention_heads=4, dtype=torch.bfloat16)
    la, ha = tt.whole_step_weight_layout(_meta_params(cfg), cfg)
    roles, body = tt.whole_step_tile_roles(cfg), tt.whole_step_body(cfg)
    assert body.parallel and body.mlp_norm is None and body.norm == "layernorm"
    kw = dict(tile_roles=roles, head_dim=64)
    tk.whole_step_check_layout(la, ha, body=body, **kw)
    for bad, match in (
            (dataclasses.replace(body, norm="group"), "norms"),
            (dataclasses.replace(body, activation="swish"), "activations"),
            (dataclasses.replace(body, parallel=False), "second norm"),
            (dataclasses.replace(body, norm="rms"), "only a LayerNorm takes a bias")):
        with pytest.raises(ValueError, match=match):
            tk.whole_step_check_layout(la, ha, body=bad, **kw)
    with pytest.raises(ValueError, match="reads the layer tensors"):
        tk.whole_step_check_layout({**la, "w_router": la["wq"]}, ha, body=body, **kw)
    with pytest.raises(ValueError, match="reads the head tensors"):
        tk.whole_step_check_layout(la, {**ha, "pos_embed": ha["lm_head"]}, body=body, **kw)
    odd = tzoo.gemma.tiny(head_dim_override=96, dtype=torch.bfloat16)
    la2, ha2 = tt.whole_step_weight_layout(_meta_params(odd), odd)
    with pytest.raises(ValueError, match="no head dim 96"):
        tk.whole_step_check_layout(la2, ha2, tile_roles=tt.whole_step_tile_roles(odd),
                                   body=tt.whole_step_body(odd), head_dim=96)
    narrow = tzoo.falcon.tiny(hidden_size=80, num_attention_heads=1, dtype=torch.bfloat16)
    la3, ha3 = tt.whole_step_weight_layout(_meta_params(narrow), narrow)
    with pytest.raises(ValueError, match="multiples of 32"):
        tk.whole_step_check_layout(la3, ha3, tile_roles=tt.whole_step_tile_roles(narrow),
                                   body=tt.whole_step_body(narrow), head_dim=80)
    with pytest.raises(ValueError, match="no kernel for device cpu"):
        x0 = torch.zeros((1, 1, 256), dtype=torch.bfloat16)
        tk._whole_step_decode_cuda(la, ha, x0, None, None, {}, None, None, None, None, None,
                                   1, roles, body, None)


#: the gate's (decode, C = 128) tile counts at published widths, 16 slots,
#: pages of 128 lines, bf16 and f32 (every pool type alike, the smallest
#: the kernel takes in brackets); Falcon's 64-wide K/V takes 8-column tiles
#: from 16 tiles on
FAMILY_PICKS = {
    ("falcon", "falcon_7b"): {torch.bfloat16: (32, 16), torch.float32: (32, 64)},   # [16]
    ("phi", "phi_2"): {torch.bfloat16: (10, 8), torch.float32: (16, 20)},           # [8]
    ("gemma", "gemma_7b"): {torch.bfloat16: (32, 16), torch.float32: (64, 64)},     # [16]
}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("family,preset", list(FAMILY_PICKS))
def test_whole_step_pricing_at_family_widths(monkeypatch, family, preset, dtype):
    """CPU: the whole-step gate at Falcon-7B's, Phi-2's and Gemma-7B's
    widths (16 slots, on f32/bf16, int8 and int4 pools): the decode and
    the C = 128 step each take the smallest count the kernel takes whose
    price fits the budget; a bf16 C = 128 step prices the wgmma ring and
    every C = 128 step the tensor-core attention tile at the family's
    head dim (Falcon's G = 71 takes the tile at decode too). An engine
    (a faked GPU, meta weights and pools) with the budget monkeypatched
    just below its decode price takes the next count, and below every
    count's price serves on the per-layer path (one fallback)."""
    import flexflow_tpu_torch.models as zoo
    from flexflow_tpu_torch.serve import ServingConfig
    from flexflow_tpu_torch.serve import engine as eng_mod

    model = getattr(zoo, family)
    cfg = getattr(model, preset)(num_hidden_layers=1, dtype=dtype)
    params = _meta_params(cfg)
    la, ha = model.whole_step_weight_layout(params, cfg)
    roles = model.whole_step_tile_roles(cfg)
    tk.whole_step_check_layout(la, ha, tile_roles=roles, body=model.whole_step_body(cfg),
                               head_dim=cfg.head_dim)
    takes = [t for t in tk.whole_step_tile_candidates(la, roles)
             if tk.whole_step_kernel_takes(la, tiles=t, tile_roles=roles)]
    KV, dk = cfg.num_key_value_heads, cfg.head_dim
    G = cfg.num_attention_heads // KV
    f32 = dtype == torch.float32
    for kind, pool_dtype, width in ((0, dtype, dk), (1, torch.int8, dk), (2, torch.uint8, dk // 2)):
        cache = {"k": torch.empty((1, 273, 128, KV, width), dtype=pool_dtype, device="meta")}
        picks = []
        for C in (1, 128):
            x0 = torch.empty((16, C, cfg.hidden_size), dtype=dtype, device="meta")
            t, est = tk.whole_step_pick_tiles(la, cache, x0, cfg.num_attention_heads,
                                              tile_roles=roles, budget=tk.WHOLE_STEP_SMEM_BUDGET)
            picks.append(t)
            assert t in takes and est <= tk.WHOLE_STEP_SMEM_BUDGET
            for smaller in takes[:takes.index(t)]:
                assert tk.whole_step_smem_bytes(la, cache, x0, cfg.num_attention_heads,
                                                tiles=smaller, tile_roles=roles) > est
            if C * G > tk.DECODE_ROWS:
                assert est >= tk.mma_smem_bytes(f32, kind, dk) + tk._WS_STATIC_SMEM
            if C == 128 and not f32:
                assert est >= tk._WS_TC_SMEM + tk._WS_STATIC_SMEM
        assert tuple(picks) == FAMILY_PICKS[(family, preset)][dtype], (kind, picks)
    # the engine's gate on the same widths (int8 pools)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(eng_mod.InferenceEngine, "_alloc_cache", lambda self: {
        "k": torch.empty((1, 273, 128, KV, dk), dtype=torch.int8, device="meta")})
    serving = ServingConfig(kv_layout="paged", kv_quant="int8", fused_decode=("whole_step",))
    eng = eng_mod.InferenceEngine(model, cfg, params, serving, device="cuda")
    decode, mixed = FAMILY_PICKS[(family, preset)][dtype]
    assert (eng.whole_step_on, eng.whole_step_tiles, eng.whole_step_mixed_tiles) == (
        True, decode, mixed)
    monkeypatch.setattr(tk, "WHOLE_STEP_SMEM_BUDGET", eng.whole_step_smem_est - 1)
    eng = eng_mod.InferenceEngine(model, cfg, params, serving, device="cuda")
    assert eng.whole_step_on and eng.whole_step_tiles == takes[takes.index(decode) + 1]
    monkeypatch.setattr(tk, "WHOLE_STEP_SMEM_BUDGET", 1024)
    eng = eng_mod.InferenceEngine(model, cfg, params, serving, device="cuda")
    assert not eng.whole_step_on and eng.whole_step_fallbacks == 1


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


@pytest.mark.parametrize("C", [1, 8])
@pytest.mark.parametrize("quant", [None, "int8", "int4"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("family", list(GENERIC_WHOLE))
def test_cuda_whole_step_generic_matches_plain_version(cuda_device, family, dtype, quant, C):
    """The generic decoder's bodies (GENERIC_WHOLE: head dims 80 and 256,
    G = 71, V = 50257, a bias on every role, both parallel blocks, learned
    positions) at a decode and a C = 8 step, held as
    test_cuda_whole_step_matches_plain_version holds LLaMA's (bf16 by the
    rule against the step in f32)."""
    _check_whole_step(cuda_device, dtype, quant, C, None, 16, family=family)


@pytest.mark.parametrize("quant", [None, "int8"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("family", ["falcon-G71", "gemma-dk256", "phi-dk80", "gpt2-V50257"])
def test_cuda_whole_step_generic_mixed_c128(cuda_device, poison_smem, family, dtype, quant):
    """A C = 128 mixed step of the generic bodies after NaN-filled shared
    memory: bf16 projections on wgmma with H * dk != D (Gemma), a 64-wide
    K/V (Falcon's one KV head), D = 4544 and 1600-wide rows; attention on
    the tensor-core tile at dk 80 and 256 and G = 71."""
    _check_whole_step(cuda_device, dtype, quant, 128, None, 128, poison=poison_smem,
                      family=family)


@pytest.mark.parametrize("quant", [None, "int8", "int4"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cuda_whole_step_decode_splits_ignore_stale_shared_memory(cuda_device, poison_smem,
                                                                  dtype, quant):
    """The whole step's split walk (its scratch in the kernel's dynamic
    shared memory) after NaN-filled shared memory, GQA (G = 4): held to the
    plain version by the bf16 rule of the C = 128 case, its stamps rising."""
    _check_whole_step(cuda_device, dtype, quant, 1, 1, 16, poison=poison_smem,
                      held=WHOLE_SPLIT_HELD, NP=40)


@pytest.mark.parametrize("family", [None, "phi-dk80"])
@pytest.mark.parametrize("C,num_layers", [(7, None), (25, None), (3, 1)])
@pytest.mark.parametrize("quant", [None, "int8", "int4"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_whole_step_fold_matches_plain_version(cuda_device, dtype, quant, C, num_layers,
                                                    family):
    """The speculation fold: a tree step (node i of a random tree at line
    prefix + i, across a page boundary; rows that attend no prefix of the
    cache; an idle slot) with the all-positions head, over every layer or
    the first one. Every live row's logits and tokens and the non-scratch
    pools are bitwise equal at two tile counts and held to the plain walk
    as test_cuda_whole_step_matches_plain_version holds them; the layers
    past num_layers keep their pools; the launch counts the "-tree"
    design."""
    from flexflow_tpu_torch.serve import kv_quant as kq

    held = (9, 20, 0)
    cfg, params, cache, (toks, _, li, table), cache_len, P, tl = _whole_case(
        cuda_device, dtype, quant, C, 2, 16, held, NP=8, family=family)
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
    G = cfg.num_attention_heads // cfg.num_key_value_heads
    design = ("decode" if C * G <= 8 else "mma" if dtype == torch.bfloat16 else "tf32x3")
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

    cfg, params, cache, step, cache_len, _, _ = _whole_case(cuda_device, torch.bfloat16, None, 1,
                                                          2, 16)
    with pytest.raises(ValueError, match="tiles"):  # 3 does not divide the widths
        tl.serve_step_whole(params, cache, *step, cfg=cfg, cache_len=cache_len, tiles=3,
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


# ---------------------------------------------------------------------------
# wq_matmul: the weight-only quantized product (csrc/wq_matmul.cu)

# the kernel and its plain version differ in summation order alone: bf16
# outputs (one rounding each) within 2^-8 relative L2, f32 within 1e-5
WQ_REL_L2 = {torch.bfloat16: 2.0 ** -8, torch.float32: 1e-5}


def _rel_l2(a, b):
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


@pytest.mark.parametrize("M", [1, 3, 16, 17, 64, 200])
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_wq_matmul_designs_match_plain_version(cuda_device, dtype, bits, M):
    from flexflow_tpu_torch.quantization import quantize_tensor

    gen = torch.Generator(device=cuda_device).manual_seed(M * 10 + bits)
    K, N = 512, 208
    w = torch.randn((K, N), generator=gen, device=cuda_device)
    qw = quantize_tensor(w, bits)
    x = torch.randn((M, K), generator=gen, device=cuda_device).to(dtype)
    bf16 = dtype == torch.bfloat16
    want = ("splitk" if bf16 else "rows") if M <= tk.WQ_ROWS_MAX else "wgmma" if bf16 else "f32"
    before = dict(tk.DESIGN_LAUNCHES)
    y = tk.wq_matmul(x, qw["q"], qw["scale"])
    torch.cuda.synchronize()
    assert tk.DESIGN_LAUNCHES[f"wq_matmul[{want}]"] == before[f"wq_matmul[{want}]"] + 1
    ref = tk.wq_matmul_ref(x, qw["q"], qw["scale"])
    assert y.shape == ref.shape and y.dtype == dtype
    assert _rel_l2(y, ref) <= WQ_REL_L2[dtype]


@pytest.mark.parametrize("M", [2, 48])
@pytest.mark.parametrize("bits", [8, 4])
def test_cuda_wq_matmul_expert_stacks_match_plain_version(cuda_device, bits, M):
    """The expert stack's forms: E weights against one x (up and gate),
    against E x's, and the down projection as one K whose scale rows
    group the experts."""
    from flexflow_tpu_torch.quantization import quantize_tensor

    gen = torch.Generator(device=cuda_device).manual_seed(bits + M)
    E, D, F = 3, 256, 96
    up = quantize_tensor(torch.randn((E, D, F), generator=gen, device=cuda_device), bits)
    down = quantize_tensor(torch.randn((E, F, D), generator=gen, device=cuda_device), bits)
    x = torch.randn((M, D), generator=gen, device=cuda_device).to(torch.bfloat16)
    xe = torch.randn((E, M, D), generator=gen, device=cuda_device).to(torch.bfloat16)
    h = torch.randn((M, E * F), generator=gen, device=cuda_device).to(torch.bfloat16)
    cases = [(x, up["q"], up["scale"]), (xe, up["q"], up["scale"]),
             (h, down["q"].reshape(-1, D), down["scale"].reshape(E, D))]
    for xx, q, s in cases:
        y = tk.wq_matmul(xx, q, s)
        torch.cuda.synchronize()
        assert _rel_l2(y, tk.wq_matmul_ref(xx, q, s)) <= WQ_REL_L2[torch.bfloat16]


@pytest.mark.parametrize("K,N", [(512, 64), (4544, 64), (512, 208), (4544, 4544),
                                 (11008, 4096)])
@pytest.mark.parametrize("M", [1, 3, 8, 16])
@pytest.mark.parametrize("bits", [8, 4])
def test_cuda_wq_matmul_decode_edges_match_plain_version(cuda_device, bits, M, K, N):
    """The decode design at the widths of every family's edge tiles: N of
    one KV head (Falcon-7B's 64), a strip's partial tail (208), Falcon's
    D = 4544 = 71 x 64 as K and N, LLaMA's K = 11008; one launch a
    product, its K split inside one cluster."""
    from flexflow_tpu_torch.quantization import quantize_tensor

    gen = torch.Generator(device=cuda_device).manual_seed(M * 7 + bits + K + N)
    qw = quantize_tensor(torch.randn((K, N), generator=gen, device=cuda_device), bits)
    x = torch.randn((M, K), generator=gen, device=cuda_device).to(torch.bfloat16)
    before = dict(tk.DESIGN_LAUNCHES)
    y = tk.wq_matmul(x, qw["q"], qw["scale"])
    torch.cuda.synchronize()
    moved = {k: n - before[k] for k, n in tk.DESIGN_LAUNCHES.items() if n != before[k]}
    assert moved == {"wq_matmul[splitk]": 1}
    assert _rel_l2(y, tk.wq_matmul_ref(x, qw["q"], qw["scale"])) <= WQ_REL_L2[torch.bfloat16]


@pytest.mark.parametrize("M", [1, 16, 48])
@pytest.mark.parametrize("bits", [8, 4])
def test_cuda_wq_matmul_down_groups_match_plain_version(cuda_device, bits, M):
    """The expert stack's down projection (G > 1 scale groups, one K over
    the experts) at decode and at a mixed step, with groups of 96 rows: a
    64-deep wgmma step crosses a group."""
    from flexflow_tpu_torch.quantization import quantize_tensor

    gen = torch.Generator(device=cuda_device).manual_seed(100 + bits + M)
    E, F, D = 8, 96, 4096
    down = quantize_tensor(torch.randn((E, F, D), generator=gen, device=cuda_device), bits)
    q, s = down["q"].reshape(-1, D), down["scale"].reshape(E, D)
    h = torch.randn((M, E * F), generator=gen, device=cuda_device).to(torch.bfloat16)
    y = tk.wq_matmul(h, q, s)
    torch.cuda.synchronize()
    assert _rel_l2(y, tk.wq_matmul_ref(h, q, s)) <= WQ_REL_L2[torch.bfloat16]


@pytest.mark.parametrize("M", [1, 16, 200])
@pytest.mark.parametrize("bits", [8, 4])
def test_cuda_wq_matmul_bf16_is_bitwise_run_to_run(cuda_device, bits, M):
    """Both bf16 designs sum in a fixed order (the cluster's ranks in rank
    order): two runs give the same bits. The plan's design is the one the
    library reports."""
    from flexflow_tpu_torch.quantization import quantize_tensor
    from flexflow_tpu_torch.serve import _cuda

    gen = torch.Generator(device=cuda_device).manual_seed(bits * 1000 + M)
    qw = quantize_tensor(torch.randn((4096, 4096), generator=gen, device=cuda_device), bits)
    x = torch.randn((M, 4096), generator=gen, device=cuda_device).to(torch.bfloat16)
    a = tk.wq_matmul(x, qw["q"], qw["scale"])
    b = tk.wq_matmul(x, qw["q"], qw["scale"])
    torch.cuda.synchronize()
    assert torch.equal(a, b)
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    plan = tk.wq_plan(M, 4096, 4096, 1, bits, torch.bfloat16, sms)
    assert _cuda.design("wq_matmul", M, 1) == plan.design


def test_cuda_wq_matmul_raises_on_what_it_does_not_take(cuda_device):
    from flexflow_tpu_torch.quantization import quantize_tensor

    qw = quantize_tensor(torch.randn((64, 24), device=cuda_device), 8)  # N % 16
    with pytest.raises(ValueError, match="multiples"):
        tk.wq_matmul(torch.randn((2, 64), device=cuda_device), qw["q"], qw["scale"])
    qw = quantize_tensor(torch.randn((64, 32), device=cuda_device), 8)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        tk.wq_matmul(torch.randn((2, 64), device=cuda_device).half(), qw["q"], qw["scale"])
    with pytest.raises(ValueError, match="input dim"):
        tk.wq_matmul(torch.randn((2, 32), device=cuda_device), qw["q"], qw["scale"])
    # a plan the launcher cannot run raises: it never falls back
    from flexflow_tpu_torch.serve import _cuda

    x = torch.randn((2, 64), device=cuda_device).to(torch.bfloat16)
    y = torch.empty((2, 32), dtype=torch.bfloat16, device=cuda_device)
    with pytest.raises(RuntimeError, match="launch failed"):
        _cuda.launch("wq_matmul", [x, qw["q"], qw["scale"], y, None],
                     [1, 2, 64, 32, 1, 0, 8, 1, tk.WQ_DESIGN_CODES["wgmma"], 1, 64, 3], [])


def _tiny_llama(device, dtype=torch.bfloat16):
    from flexflow_tpu_torch.models import llama

    cfg = dataclasses.replace(llama.LLaMAConfig.tiny(dtype=dtype), hidden_size=128,
                              intermediate_size=256, num_attention_heads=2,
                              num_key_value_heads=2)
    gen = torch.Generator(device=device).manual_seed(0)
    return llama, cfg, llama.init_params(gen, cfg, device=device)


@pytest.mark.parametrize("quantization", [None, "int8", "int4"])
def test_cuda_offloaded_serving_is_bitwise_the_resident_run(cuda_device, quantization):
    """Offloaded layers reach the kernels as the same bytes: tokens and
    logits bitwise the resident run's; every layer projection of a
    quantized model ran the wq_matmul kernel, the plain version never."""
    from flexflow_tpu_torch.serve import LLM, ServingConfig

    model, cfg, params = _tiny_llama(cuda_device)
    sc = ServingConfig(max_requests_per_batch=4, max_sequence_length=128, prefill_chunk=32,
                       max_spec_tree_tokens=8, kernels="cuda", cache_dtype=torch.bfloat16)
    prompts = [[3, 17, 91, 42, 7] * 7, [9, 8, 7, 6, 5, 4]]
    outs = []
    for offload in (False, True):
        llm = LLM(model, cfg, {k: (dict(v) if isinstance(v, dict) else v)
                               for k, v in params.items()}, device=cuda_device)
        llm.compile(sc, quantization=quantization, offload=offload)
        tk.reset_launch_counts()
        outs.append([r.output_tokens for r in llm.generate(prompts, max_new_tokens=8)])
        if quantization:
            assert tk.LAUNCHES[f"wq_matmul[{quantization}]"] > 0
            assert tk.PLAIN_CALLS["wq_matmul"] == 0
        assert getattr(llm.params["layers"], "offloaded", False) == offload
    assert outs[0] == outs[1]


def test_cuda_whole_step_refuses_offloaded_params(cuda_device):
    from flexflow_tpu_torch.serve import LLM, ServingConfig

    model, cfg, params = _tiny_llama(cuda_device)
    llm = LLM(model, cfg, params, device=cuda_device)
    with pytest.raises(ValueError, match="offloaded"):
        llm.compile(ServingConfig(max_requests_per_batch=4, max_sequence_length=128,
                                  kv_layout="paged", page_size=16,
                                  fused_decode=("whole_step",)), offload=True)
