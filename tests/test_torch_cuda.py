"""The port's CUDA attention kernels (dense decode and verify, ragged
paged and fused RoPE + KV-write paged attention) held against their
plain PyTorch versions on the GPU. Every test here needs a CUDA GPU and skips without
one; the file imports neither JAX nor the JAX package, so on a machine
with a GPU and no JAX it runs as

    python -m pytest --noconftest tests/test_torch_cuda.py -q
"""
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


# ---------------------------------------------------------------------------
# paged kernels


def _paged_case(gen, dev, dtype, quant, R, C, H, KV, dk, ps, NP):
    """q, pools (q's dtype, or int8/int4 codes quantized from random
    lines with per-page scales), a shuffled table with unallocated
    entries on the scratch page P, and a mask that opens only allocated
    lines (row (0, 0) attends nothing)."""
    from flexflow_tpu_torch.serve import kv_quant as kq

    P = R * NP
    q = torch.randn(R, C, H, dk, generator=gen, device=dev).to(dtype)
    lines = torch.randn(2, P + 1, ps, KV, dk, generator=gen, device=dev)
    table = torch.randperm(P, generator=gen, device=dev).reshape(R, NP).to(torch.int32)
    table[:, NP - 1] = P
    allocated = (table != P).repeat_interleave(ps, dim=1)
    mask = (torch.rand(R, C, NP * ps, generator=gen, device=dev) < 0.5) & allocated[:, None]
    mask[0, 0] = False
    if quant is None:
        return q, lines[0].to(dtype), lines[1].to(dtype), None, None, table, mask
    spec = kq.SPECS[quant]
    s = lines.abs().amax(dim=(2, 4)) / spec.qmax + 1e-3          # (2, P+1, KV)
    codes = torch.round(lines / s[:, :, None, :, None]).clamp(-spec.qmax, spec.qmax)
    pools = kq.pack_codes(codes, spec.dtype, spec.pack)
    return q, pools[0].contiguous(), pools[1].contiguous(), s[0].contiguous(), \
        s[1].contiguous(), table, mask


@pytest.mark.parametrize("ps", [16, 128])
@pytest.mark.parametrize("C", [1, 5])
@pytest.mark.parametrize("quant", [None, "int8", "int4"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_ragged_paged_attention_matches_plain_version(cuda_device, dtype, quant, C, ps):
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    q, kp, vp, ks, vs, table, mask = _paged_case(gen, cuda_device, dtype, quant,
                                                 3, C, 8, 2, 64, ps, 3)
    before = dict(tk.LAUNCHES)
    out = tk.ragged_paged_attention(q, kp, vp, table, mask, k_scale=ks, v_scale=vs)
    ref = tk.ragged_paged_attention_ref(q, kp, vp, table, mask, k_scale=ks, v_scale=vs)
    torch.testing.assert_close(out, ref, **TOL[dtype])
    assert (out[0, 0] == 0).all()  # a row with nothing to attend gives zeros
    name = f"ragged_paged_attention[{tk.pool_type(kp)}]"
    assert tk.LAUNCHES[name] == before[name] + 1


@pytest.mark.parametrize("C", [1, 5])
@pytest.mark.parametrize("quant", [None, "int8", "int4"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_fused_rope_paged_attention_bitwise_vs_unfused(cuda_device, dtype, quant, C):
    """Pools and scales (non-scratch pages) and the outputs of rows that
    never read the scratch page equal the unfused composition (RoPE,
    scatter or quant_line_write, ragged kernel) bit for bit; the output
    is within the kernel tolerance of the plain version."""
    from flexflow_tpu_torch.models import llama as tl
    from flexflow_tpu_torch.serve import kv_quant as kq

    gen = torch.Generator(device=cuda_device).manual_seed(2)
    R, H, KV, dk, ps, NP = 3, 8, 2, 128, 16, 4
    q, kp, vp, ks, vs, table, mask = _paged_case(gen, cuda_device, dtype, quant,
                                                 R, C, H, KV, dk, ps, NP)
    P = R * NP
    k_new = torch.randn(R, C, KV, dk, generator=gen, device=cuda_device).to(dtype)
    v_new = torch.randn(R, C, KV, dk, generator=gen, device=cuda_device).to(dtype)
    pos = torch.arange(C, device=cuda_device)[None, :] + torch.tensor(
        [[3], [17], [30]], device=cuda_device)
    cos, sin = tl.rope_freqs(tl.LLaMAConfig(hidden_size=H * dk, num_attention_heads=H,
                                            num_key_value_heads=KV), pos)
    logical = (pos // ps).to(torch.int32)
    off = (pos % ps).to(torch.int32)
    qmax = None if quant is None else kq.SPECS[quant].qmax

    def clones():
        return [None if t is None else t.clone() for t in (kp, vp, ks, vs)]

    a, b, c = clones(), clones(), clones()
    fused = tk.fused_rope_paged_attention(q, k_new, v_new, cos, sin, a[0], a[1], table,
                                          logical, off, mask, k_scale=a[2],
                                          v_scale=a[3], qmax=qmax)
    qr, kr = tl.apply_rope(q, cos, sin), tl.apply_rope(k_new, cos, sin)
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
    assert torch.equal(fused[~reads_scratch], unfused[~reads_scratch])
    torch.testing.assert_close(fused, ref, **TOL[dtype])
