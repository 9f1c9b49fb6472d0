"""The port's paged attention kernels (flexflow_tpu_torch/serve/kernels.py).

On the CPU each wrapper runs its plain PyTorch version, held here against
the JAX package's Pallas kernels in interpret mode (as
tests/test_paged_kv.py and tests/test_fused_decode.py run them) and
against its XLA fallback. The CUDA kernels are held against the plain
versions on the GPU by tests/test_torch_cuda.py and chip_smoke.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flexflow_tpu.serve import kernels as jk
from flexflow_tpu.serve import kv_quant as jq
from flexflow_tpu_torch.models import llama as tl
from flexflow_tpu_torch.serve import kernels as tk
from flexflow_tpu_torch.serve import kv_quant as tq

torch.set_num_threads(1)

R, H, KV, dk, ps, NP, P = 3, 4, 2, 16, 8, 4, 9  # pool rows P + 1; row P scratch
# f32 on the CPU: the Pallas kernel's online softmax and the plain
# version's one-pass softmax differ in summation order only
ATOL = 2e-5


def _case(rng, C, quant):
    """q, pools (f32, or int8/int4 codes quantized from f32 lines with
    per-page scales), a table of distinct pages with unallocated entries
    on the scratch page, and a mask that opens only allocated lines."""
    q = rng.normal(size=(R, C, H, dk)).astype(np.float32)
    lines = rng.normal(size=(2, P + 1, ps, KV, dk)).astype(np.float32)
    table = np.full((R, NP), P, np.int32)
    pages = rng.permutation(P)
    table[0, :3], table[1, :2], table[2, :1] = pages[:3], pages[3:5], pages[5:6]
    allocated = np.repeat(table != P, ps, axis=1)                     # (R, S)
    mask = (rng.random((R, C, NP * ps)) < 0.5) & allocated[:, None, :]
    mask[:, :, 0] = True
    mask[2, 0] = False  # a row with nothing to attend
    if quant is None:
        return q, lines[0], lines[1], None, None, table, mask
    spec = jq.SPECS[quant]
    pools, scales = [], []
    for x in lines:
        s = np.abs(x).max(axis=(1, 3)) / spec.qmax + 1e-3               # (P+1, KV)
        codes = np.clip(np.round(x / s[:, None, :, None]), -spec.qmax, spec.qmax)
        stored = (codes.astype(np.int8) if spec.pack == 1
                  else np.array(jq.pack_nibbles(jnp.asarray(codes))))
        pools.append(stored)
        scales.append(s.astype(np.float32))
    return q, pools[0], pools[1], scales[0], scales[1], table, mask


def _jax(args):
    return [None if a is None else jnp.asarray(a) for a in args]


def _torch(args):
    return [None if a is None else torch.from_numpy(np.array(a)) for a in args]


@pytest.mark.parametrize("C", [1, 4])
@pytest.mark.parametrize("quant", [None, "int8", "int4"])
def test_ragged_ref_matches_jax_pallas(quant, C):
    rng = np.random.default_rng(C)
    q, kp, vp, ks, vs, table, mask = _case(rng, C, quant)
    want = jk.ragged_paged_attention(*_jax([q, kp, vp, table, mask]),
                                     k_scale=_jax([ks])[0], v_scale=_jax([vs])[0])
    tq_, tkp, tvp, tks, tvs, tt, tm = _torch([q, kp, vp, ks, vs, table, mask])
    got = tk.ragged_paged_attention_ref(tq_, tkp, tvp, tt, tm, k_scale=tks, v_scale=tvs)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    assert (got[2, 0] == 0).all()  # nothing to attend gives 0, as the kernel


@pytest.mark.parametrize("quant", [None, "int8", "int4"])
def test_ragged_ref_and_torch_path_match_jax_xla(quant):
    """The plain version equals JAX's XLA fallback on every row that
    attends something; the port's torch path equals it on every row
    (a row with nothing to attend gives the mean of V in both)."""
    rng = np.random.default_rng(7)
    q, kp, vp, ks, vs, table, mask = _case(rng, 4, quant)
    want = np.asarray(jk.ragged_paged_attention_xla(
        *_jax([q, kp, vp, table, mask]), k_scale=_jax([ks])[0], v_scale=_jax([vs])[0]))
    tq_, tkp, tvp, tks, tvs, tt, tm = _torch([q, kp, vp, ks, vs, table, mask])
    got = tk.ragged_paged_attention_ref(tq_, tkp, tvp, tt, tm, k_scale=tks, v_scale=tvs)
    live = mask.any(axis=-1)
    np.testing.assert_allclose(got.numpy()[live], want[live], atol=ATOL)
    torch_path = tk.ragged_paged_attention_torch(tq_, tkp, tvp, tt, tm,
                                                 k_scale=tks, v_scale=tvs)
    np.testing.assert_allclose(torch_path.numpy(), want, atol=ATOL)


def _fused_inputs(rng, C, quant, rot=dk):
    q, kp, vp, ks, vs, table, mask = _case(rng, C, quant)
    k_new = rng.normal(size=(R, C, KV, dk)).astype(np.float32)
    v_new = rng.normal(size=(R, C, KV, dk)).astype(np.float32)
    ang = rng.random((R, C, rot)).astype(np.float32) * 6
    cos, sin = np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)
    # new lines at the end of each slot's allocated lines (slot 2's row 0
    # is a padding column, written to the scratch page)
    start = np.array([20, 9, 2])
    cpos = start[:, None] + np.arange(C)[None, :]
    cpos[2, 0] = NP * ps - 1
    logical = (cpos // ps).astype(np.int32)
    off = (cpos % ps).astype(np.int32)
    return q, k_new, v_new, cos, sin, kp, vp, table, logical, off, mask, ks, vs


@pytest.mark.parametrize("quant", [None, "int8", "int4"])
def test_fused_ref_matches_jax_fused(quant):
    """Output (tolerance ATOL) and non-scratch pools and scales against
    the JAX Pallas kernel. Inside that kernel RoPE and the scale division
    round differently from the JAX package's own unfused path (its
    fused-vs-unfused bitwise test fails on the CPU), to which the port's
    write side is bitwise (tests/test_torch_kv_quant.py). So here f32
    pool values agree to 1e-6, scales to 1e-6 relative and codes to one
    quantization step."""
    rng = np.random.default_rng(3)
    C = 2
    (q, k_new, v_new, cos, sin, kp, vp, table, logical, off, mask, ks,
     vs) = _fused_inputs(rng, C, quant)
    qmax = None if quant is None else jq.SPECS[quant].qmax
    want = jk.fused_rope_paged_attention(
        *_jax([q, k_new, v_new, cos, sin, kp, vp, table, logical, off, mask]),
        k_scale=_jax([ks])[0], v_scale=_jax([vs])[0], qmax=qmax)
    t = _torch([q, k_new, v_new, cos, sin, kp, vp, table, logical, off, mask, ks, vs])
    got = tk.fused_rope_paged_attention_ref(*t[:11], k_scale=t[11], v_scale=t[12], qmax=qmax)
    live = mask.any(axis=-1)
    np.testing.assert_allclose(got.numpy()[live], np.asarray(want[0])[live], atol=ATOL)
    pack = 1 if quant is None else tq.SPECS[quant].pack
    for mine, theirs in zip(t[5:7], want[1:3]):
        a = tq.unpack_codes(mine[:P], pack)
        b = tq.unpack_codes(torch.from_numpy(np.array(theirs)[:P]), pack)
        assert float((a - b).abs().max()) <= (1e-6 if quant is None else 1.0)
    if quant is not None:
        for mine, theirs in zip(t[11:13], want[3:5]):
            np.testing.assert_allclose(mine.numpy()[:P], np.array(theirs)[:P],
                                       rtol=1e-6, atol=0)


@pytest.mark.parametrize("rot", [dk, dk // 2])
@pytest.mark.parametrize("quant", [None, "int8", "int4"])
def test_fused_ref_bitwise_equals_unfused_composition(quant, rot):
    """The fused plain version is the port's unfused path bit for bit:
    RoPE, then the scatter or quant_line_write, then ragged attention —
    output, pools and scales (scratch page included: one process, one
    order). A partial rotary width passes the head tails through."""
    rng = np.random.default_rng(4)
    C = 3
    (q, k_new, v_new, cos, sin, kp, vp, table, logical, off, mask, ks,
     vs) = _fused_inputs(rng, C, quant, rot)
    qmax = None if quant is None else tq.SPECS[quant].qmax
    a = _torch([q, k_new, v_new, cos, sin, kp, vp, table, logical, off, mask, ks, vs])
    b = _torch([q, k_new, v_new, cos, sin, kp, vp, table, logical, off, mask, ks, vs])
    fused = tk.fused_rope_paged_attention(*a[:11], k_scale=a[11], v_scale=a[12], qmax=qmax)
    # unfused: apply_rope (full rotary) or the partial-rotary rotate
    tq_, tk_new, tv_new, tcos, tsin, tkp, tvp, tt, tlog, toff, tm, tks, tvs = b
    if rot == dk:
        qr, kr = tl.apply_rope(tq_, tcos, tsin), tl.apply_rope(tk_new, tcos, tsin)
    else:
        qr = tk._rope_rotate(tq_, tcos[:, :, None], tsin[:, :, None])
        kr = tk._rope_rotate(tk_new, tcos[:, :, None], tsin[:, :, None])
        np.testing.assert_array_equal(qr[..., rot:].numpy(), q[..., rot:])
    phys = tt.long().gather(1, tlog.long())
    tk.commit_paged(tkp, tvp, kr, tv_new, phys, toff.long(), tks, tvs, qmax)
    unfused = tk.ragged_paged_attention(qr, tkp, tvp, tt, tm, k_scale=tks, v_scale=tvs)
    assert torch.equal(fused, unfused)
    for x, y in zip(a[5:7] + a[11:13], [tkp, tvp, tks, tvs]):
        if x is not None:
            assert torch.equal(x, y)


def test_wrappers_on_cpu_run_the_plain_versions_and_count_nothing():
    rng = np.random.default_rng(5)
    before = dict(tk.LAUNCHES)
    q, kp, vp, ks, vs, table, mask = _torch(_case(rng, 4, "int8"))
    got = tk.ragged_paged_attention(q, kp, vp, table, mask, k_scale=ks, v_scale=vs)
    assert torch.equal(got, tk.ragged_paged_attention_ref(q, kp, vp, table, mask,
                                                          k_scale=ks, v_scale=vs))
    assert tk.LAUNCHES == before
    assert tk.pool_type(kp) == "int8" and tk.pool_type(kp.view(torch.uint8)) == "int4"


def test_wrappers_reject_bad_inputs():
    rng = np.random.default_rng(6)
    q, kp, vp, ks, vs, table, mask = _torch(_case(rng, 2, "int8"))
    with pytest.raises(ValueError, match="mask"):
        tk.ragged_paged_attention(q, kp, vp, table, mask[..., :-1], k_scale=ks, v_scale=vs)
    with pytest.raises(ValueError, match="page_table"):
        tk.ragged_paged_attention(q, kp, vp, table.long(), mask, k_scale=ks, v_scale=vs)
    with pytest.raises(ValueError, match="k_scale"):
        tk.ragged_paged_attention(q, kp, vp, table, mask, k_scale=ks)
    with pytest.raises(ValueError, match="quantized pools"):
        tk.ragged_paged_attention(q, kp[..., :4], vp[..., :4], table, mask,
                                  k_scale=ks, v_scale=vs)
    with pytest.raises(ValueError, match="qmax"):
        z = torch.zeros(R, 2, KV, dk)
        i = torch.zeros(R, 2, dtype=torch.int32)
        tk.fused_rope_paged_attention(q, z, z, None, None, kp, vp, table, i, i, mask,
                                      k_scale=ks, v_scale=vs)


def test_masks_gathers_and_dequant_match_jax():
    rng = np.random.default_rng(8)
    pos = np.array([[0, 5, 31], [3, 31, 31], [31, 31, 31]], np.int32)
    want = np.asarray(jk.paged_serve_mask(None, jnp.asarray(pos), NP, ps, 31))
    got = tk.paged_serve_mask(None, torch.from_numpy(pos), NP, ps, 31)
    np.testing.assert_array_equal(got.numpy(), want)
    explicit = rng.random((R, 3, 20)) < 0.5
    np.testing.assert_array_equal(
        tk.paged_serve_mask(torch.from_numpy(explicit), None, NP, ps, 19).numpy(),
        np.asarray(jk.paged_serve_mask(jnp.asarray(explicit), None, NP, ps, 19)))
    for quant in ("int8", "int4"):
        _, kp, _, ks, _, table, _ = _case(rng, 1, quant)
        want = np.array(jk.dequant_pages(jnp.asarray(kp), jnp.asarray(ks),
                                         jnp.asarray(table), jnp.float32))
        got = tk.dequant_pages(torch.from_numpy(kp), torch.from_numpy(ks),
                               torch.from_numpy(table), torch.float32)
        np.testing.assert_array_equal(got.numpy(), want)


# (C, H, KV, ps, NP) of the shapes the CUDA tensor-core tile is held to
# (tests/test_torch_cuda.py), at small widths (dk 16): C * G = 148 rows at
# G = 4 (past one 128-row block, the last 16-row warp partial), 18 rows at
# G = 2 (a warp and a bit), 130 rows at G = 1; page size 16 (four pages a
# 64-line tile) and 32
TILE_SHAPES = [(37, 8, 2, 16, 9), (9, 4, 2, 16, 4), (130, 2, 2, 32, 6)]
TILE_DK = 16


def _tile_case(rng, shape, quant):
    """Three slots at ``shape``: slot 0 a causal prefill chunk whose rows
    straddle warps and blocks, slot 1 a decode row followed by padding
    columns (each attends every line below the last, scratch pages
    included, as in a serving step), slot 2 attends nothing. The last
    logical page of every slot is unallocated (the scratch page P)."""
    C, H, KV, ps_, NP_ = shape
    P_ = 3 * NP_
    q = rng.normal(size=(3, C, H, TILE_DK)).astype(np.float32)
    lines = rng.normal(size=(2, P_ + 1, ps_, KV, TILE_DK)).astype(np.float32)
    table = rng.permutation(P_).reshape(3, NP_).astype(np.int32)
    table[:, NP_ - 1] = P_
    S = NP_ * ps_
    key = np.arange(S)
    mask = np.zeros((3, C, S), bool)
    mask[0] = key[None, :] <= (S - ps_ - C + np.arange(C))[:, None]
    mask[1, 0] = key <= 5
    mask[1, 1:] = key[None, :] < S - 1
    if quant is None:
        return q, lines[0], lines[1], None, None, table, mask
    spec = jq.SPECS[quant]
    pools, scales = [], []
    for x in lines:
        s = np.abs(x).max(axis=(1, 3)) / spec.qmax + 1e-3
        codes = np.clip(np.round(x / s[:, None, :, None]), -spec.qmax, spec.qmax)
        pools.append(codes.astype(np.int8) if spec.pack == 1
                     else np.array(jq.pack_nibbles(jnp.asarray(codes))))
        scales.append(s.astype(np.float32))
    return q, pools[0], pools[1], scales[0], scales[1], table, mask


@pytest.mark.parametrize("quant", [None, "int8", "int4"])
@pytest.mark.parametrize("shape", TILE_SHAPES, ids=lambda s: "C{}-H{}-KV{}-ps{}".format(*s[:4]))
def test_ragged_ref_matches_jax_xla_at_tile_shapes(shape, quant):
    """The plain version — the CUDA kernel's yardstick on the card — equals
    JAX's XLA fallback on every row that attends something, at the row
    counts and page sizes of the tensor-core tile."""
    q, kp, vp, ks, vs, table, mask = _tile_case(np.random.default_rng(11), shape, quant)
    want = np.asarray(jk.ragged_paged_attention_xla(
        *_jax([q, kp, vp, table, mask]), k_scale=_jax([ks])[0], v_scale=_jax([vs])[0]))
    tq_, tkp, tvp, tks, tvs, tt, tm = _torch([q, kp, vp, ks, vs, table, mask])
    got = tk.ragged_paged_attention(tq_, tkp, tvp, tt, tm, k_scale=tks, v_scale=tvs)
    live = mask.any(axis=-1)
    np.testing.assert_allclose(got.numpy()[live], want[live], atol=ATOL)
    assert (got[2] == 0).all()  # a slot with nothing to attend gives 0


@pytest.mark.parametrize("quant", [None, "int8", "int4"])
@pytest.mark.parametrize("shape", TILE_SHAPES, ids=lambda s: "C{}-H{}-KV{}-ps{}".format(*s[:4]))
def test_fused_ref_matches_jax_unfused_at_tile_shapes(shape, quant):
    """The fused plain version against JAX's unfused composition (RoPE,
    the scatter or quant_line_write, the XLA fallback) at the tile's
    shapes: output on the rows that attend something and read no scratch
    line to ATOL, non-scratch pools and scales as
    tests/test_torch_kv_quant.py holds the write side (f32 values to
    1e-6, codes to one step, scales to 1e-6 relative). Slot 1's padding
    columns write the scratch page."""
    C, H, KV, ps_, NP_ = shape
    rng = np.random.default_rng(12)
    q, kp, vp, ks, vs, table, mask = _tile_case(rng, shape, quant)
    P_ = 3 * NP_
    k_new = rng.normal(size=(3, C, KV, TILE_DK)).astype(np.float32)
    v_new = rng.normal(size=(3, C, KV, TILE_DK)).astype(np.float32)
    ang = rng.random((3, C, TILE_DK)).astype(np.float32) * 6
    cos, sin = np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)
    S = NP_ * ps_
    cpos = np.stack([S - ps_ - C + np.arange(C), np.full(C, S - 1), 2 + np.arange(C)])
    cpos[1, 0] = 5
    logical = (cpos // ps_).astype(np.int32)
    off = (cpos % ps_).astype(np.int32)
    qmax = None if quant is None else jq.SPECS[quant].qmax

    jqr = jk._rope_rotate(jnp.asarray(q), jnp.asarray(cos)[:, :, None], jnp.asarray(sin)[:, :, None])
    jkr = jk._rope_rotate(jnp.asarray(k_new), jnp.asarray(cos)[:, :, None],
                          jnp.asarray(sin)[:, :, None])
    phys = jnp.take_along_axis(jnp.asarray(table), jnp.asarray(logical), axis=1)
    if quant is None:
        jkp = jnp.asarray(kp).at[phys, jnp.asarray(off)].set(jkr)
        jvp = jnp.asarray(vp).at[phys, jnp.asarray(off)].set(jnp.asarray(v_new))
        jks = jvs = None
    else:
        jkp, jks = jq.quant_line_write(jnp.asarray(kp), jnp.asarray(ks), phys,
                                       jnp.asarray(off), jkr, qmax)
        jvp, jvs = jq.quant_line_write(jnp.asarray(vp), jnp.asarray(vs), phys,
                                       jnp.asarray(off), jnp.asarray(v_new), qmax)
    want = np.asarray(jk.ragged_paged_attention_xla(jqr, jkp, jvp, jnp.asarray(table),
                                                    jnp.asarray(mask), k_scale=jks,
                                                    v_scale=jvs))
    t = _torch([q, k_new, v_new, cos, sin, kp, vp, table, logical, off, mask, ks, vs])
    got = tk.fused_rope_paged_attention(*t[:11], k_scale=t[11], v_scale=t[12], qmax=qmax)
    # the padding lines collide on the scratch page in no fixed order:
    # compare the rows that read none of it
    scratch = np.repeat(table == P_, ps_, axis=1)[:, None, :]
    live = mask.any(axis=-1) & ~(mask & scratch).any(axis=-1)
    assert live[0].all() and live[1, 0] and not live[1, 1:].any()
    np.testing.assert_allclose(got.numpy()[live], want[live], atol=ATOL)
    pack = 1 if quant is None else tq.SPECS[quant].pack
    for mine, theirs in zip(t[5:7], (jkp, jvp)):
        a = tq.unpack_codes(mine[:P_], pack)
        b = tq.unpack_codes(torch.from_numpy(np.array(theirs)[:P_]), pack)
        assert float((a - b).abs().max()) <= (1e-6 if quant is None else 1.0)
    if quant is not None:
        for mine, theirs in zip(t[11:13], (jks, jvs)):
            np.testing.assert_allclose(mine.numpy()[:P_], np.array(theirs)[:P_],
                                       rtol=1e-6, atol=0)
