"""The port's CUDA attention kernels (dense decode and verify, ragged
paged and fused RoPE + KV-write paged attention, training flash attention
forward and backward) held against their plain PyTorch versions on the
GPU, and bf16 train steps through each attention path under each remat
setting. Every test here needs a CUDA GPU and skips without one; the file
imports neither JAX nor the JAX package, so on a machine with a GPU and
no JAX it runs as

    python -m pytest --noconftest tests/test_torch_cuda.py -q
"""
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


# ---------------------------------------------------------------------------
# training flash attention


@pytest.mark.parametrize("S,T", [(128, 128), (100, 100), (77, 150), (150, 77)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dk", [64, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_flash_attention_matches_plain_versions(cuda_device, dtype, dk, causal, S, T):
    from flexflow_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device=cuda_device).manual_seed(3)
    B, H = 2, 3

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=cuda_device).to(dtype)

    q, k, v, do = rnd(B, S, H, dk), rnd(B, T, H, dk), rnd(B, T, H, dk), rnd(B, S, H, dk)
    scale = dk ** -0.5
    before = dict(fa.LAUNCHES)
    out, lse = fa.flash_fwd(q, k, v, causal, scale)
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
    backward kernel once per layer."""
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
        losses[attention] = [float(loss), float(step(params, opt, toks)[2])]
        if attention == "flash":
            assert launched == {"flash_attention_fwd": fwd_launches,
                                "flash_attention_bwd_kv": 2, "flash_attention_bwd_q": 2}
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


def _whole_case(dev, dtype, quant, C, KV, ps):
    """A 2-layer LLaMA at small widths (D 256, 4 heads of 64, F 512, V
    512) and a paged cache warmed by one unfused step: slot 0 holds 9
    lines, slot 1 holds 20, slot 2 is idle. The step under test writes C
    new lines per live slot (slot 2's columns are padding)."""
    from flexflow_tpu_torch.models import llama as tl

    cfg = tl.LLaMAConfig(vocab_size=512, hidden_size=256, intermediate_size=512,
                         num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=KV,
                         max_position_embeddings=512, dtype=dtype)
    params = tl.init_params(torch.Generator(device=dev).manual_seed(4), cfg, device=dev)
    R, NP = 3, 4
    cache_len = NP * ps - 1
    P = R * NP
    cache = tl.init_paged_kv_cache(cfg, P, ps, kv_quant=quant, device=dev)
    held = [9, 20, 0]
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
    for r, n in enumerate(held[:2]):
        pos[r] = torch.arange(n, n + C)
    li = torch.tensor([C - 1, C - 2 if C > 1 else 0, 0])
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
    other (relative L2 2e-2)."""
    from flexflow_tpu_torch.models import llama as tl
    from flexflow_tpu_torch.serve import kv_quant as kq

    cfg, params, cache, step, cache_len, P = _whole_case(cuda_device, dtype, quant, C, KV, ps)
    la, _ = tl.whole_step_weight_layout(params, cfg)
    roles = tl.whole_step_tile_roles(cfg)
    x0 = torch.empty((3, C, cfg.hidden_size), dtype=dtype, device="meta")
    legal = [t for t in tk.whole_step_tile_candidates(la, roles)
             if tk.whole_step_kernel_takes(la, tiles=t, tile_roles=roles)]
    assert len(legal) >= 2
    runs = {}
    for name, kernels, tiles in (("lo", "cuda", legal[0]), ("hi", "cuda", legal[-1]),
                                 ("plain", "torch", legal[0])):
        c = {k: v.clone() for k, v in cache.items()}
        before = dict(tk.LAUNCHES)
        logits, toks, _ = tl.serve_step_whole(params, c, *step, cfg=cfg, cache_len=cache_len,
                                              kv_quant=quant, tiles=tiles, kernels=kernels)
        torch.cuda.synchronize()
        key = f"whole_step_decode[{tk.pool_type(c['k'])}]"
        assert tk.LAUNCHES[key] == before[key] + (kernels == "cuda")
        runs[name] = (logits, toks, c)
    # slot 2 is idle: its logits read the scratch page, which every
    # padding line writes in no fixed order
    (lo, tlo, clo), (hi, thi, chi), (pl, tpl, cpl) = (
        (lg[:2], tk_[:2], c) for lg, tk_, c in (runs["lo"], runs["hi"], runs["plain"]))
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
    else:
        assert rel(lo, pl) <= 2e-2
        for k in ("k", "v"):
            a, b = clo[k][:, :P], cpl[k][:, :P]
            if quant is not None:
                s = f"{k}_scale"
                a = kq.unpack_codes(a, pack) * clo[s][:, :P, None, :, None]
                b = kq.unpack_codes(b, pack) * cpl[s][:, :P, None, :, None]
            assert rel(a, b) <= 2e-2, k
    if quant is not None:
        for s in ("k_scale", "v_scale"):
            torch.testing.assert_close(clo[s][:, :P], cpl[s][:, :P],
                                       rtol=1e-4 if dtype == torch.float32 else 2e-2, atol=0)


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
