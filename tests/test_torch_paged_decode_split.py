"""The paged kernels' split decode design (csrc/paged_decode.cuh), on the
CPU: the host's split rule (``kernels.paged_decode_split``), and a plain
emulation of the kernel's split-and-merge held against the port's plain
version ``ragged_paged_attention_ref``, JAX's ``ragged_paged_attention_xla``
and, at the small shapes of tests/test_torch_paged_kernels.py, the Pallas
kernel in interpret mode.

The emulation cuts each (slot, KV head) into the rule's splits of whole
pages, takes each split's partial softmax (m, l, acc) in base 2 with the
softmax scale times log2(e) folded into the page's K scale (the kernel's
arithmetic, with IEEE f32 sums in another order), and merges the splits
in split order, skipping a split no row attends (l == 0), as the last
block of a (slot, KV head) does on the card. The kernel itself is held to
the plain version on a GPU by tests/test_torch_cuda.py.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flexflow_tpu.serve import kernels as jk
from flexflow_tpu.serve import kv_quant as jq
from flexflow_tpu_torch.serve import kernels as tk
from flexflow_tpu_torch.serve import kv_quant as tq

torch.set_num_threads(1)

# f32: the emulation and the plain version differ in summation order only
F32_TOL = 1e-5
# bf16 q and pages: both compute in f32 and round the output once
BF16_TOL = dict(atol=1e-2, rtol=1e-2)
# against JAX (tests/test_torch_paged_kernels.py's ATOL): the Pallas
# kernel's online softmax sums in its own order
JAX_ATOL = 2e-5


def emulate_split_merge(q, k_pool, v_pool, table, mask, *, k_scale=None, v_scale=None,
                        split_pages=None):
    """The decode design's result: q (R, C, H, dk) against the pools
    (P+1, ps, KV, dk/pack) through table (R, NP) under mask (R, C, NP*ps),
    cut into splits of ``split_pages`` pages (default: the host's rule),
    each split's (m, l, acc) in f32, merged in split order. Returns the
    output in q's dtype and the (R, KV, splits) split lengths attended."""
    R, C, H, dk = q.shape
    ps, KV = k_pool.shape[1], k_pool.shape[2]
    NP = table.shape[1]
    G = H // KV
    pages = split_pages or tk.paged_decode_split(R, C, KV, NP, ps)[0]
    nsplit = -(-NP // pages)
    pack = tq.pool_pack(k_pool) if k_scale is not None else 1
    kc = tq.unpack_codes(tk.gather_pages(k_pool, table), pack).float()  # (R, S, KV, dk)
    vc = tq.unpack_codes(tk.gather_pages(v_pool, table), pack).float()
    ksc = torch.ones(R, NP * ps, KV) if k_scale is None else tk._line_scales(k_scale, table, ps)
    vsc = torch.ones(R, NP * ps, KV) if v_scale is None else tk._line_scales(v_scale, table, ps)
    qg = q.float().reshape(R, C, KV, G, dk)
    # base-2 scores: dot * (k_scale * softmax scale * log2(e))
    dots = torch.einsum("rckgd,rskd->rkgcs", qg, kc)
    sc = dots * (ksc * (math.log2(math.e) / math.sqrt(dk))).permute(0, 2, 1)[:, :, None, None]
    on = mask[:, None, None]                                             # (R, 1, 1, C, S)
    out = torch.zeros(R, KV, G, C, dk)
    M = torch.full((R, KV, G, C), tk.NEG_INF)
    L = torch.zeros(R, KV, G, C)
    attended = torch.zeros(R, KV, nsplit, dtype=torch.bool)
    parts = []
    for s in range(nsplit):
        s0, s1 = s * pages * ps, min(NP, (s + 1) * pages) * ps
        o = on[..., s0:s1]
        x = torch.where(o, sc[..., s0:s1], tk.NEG_INF)
        m = x.amax(dim=-1)
        p = torch.where(o, torch.exp2(x - m[..., None]), 0.0)
        l = p.sum(dim=-1)
        w = p * vsc[:, s0:s1].permute(0, 2, 1)[:, :, None, None]
        acc = torch.einsum("rkgcs,rskd->rkgcd", w, vc[:, s0:s1])
        attended[:, :, s] = o.expand(R, KV, G, C, s1 - s0).flatten(2).any(-1)
        parts.append((m, l, acc))
    for m, _, _ in parts:  # split order
        M = torch.maximum(M, m)
    O = torch.zeros(R, KV, G, C, dk)
    for m, l, acc in parts:
        f = torch.exp2(m - M)
        skip = l == 0  # nothing attended: the kernel never reads its acc
        L = L + torch.where(skip, 0.0, l * f)
        O = O + torch.where(skip[..., None], 0.0, acc * f[..., None])
    out = O / L.clamp_min(1e-20)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(R, C, H, dk).to(q.dtype), attended


def _pools(rng, quant, P, ps, KV, dk, dtype=torch.float32):
    """Pools of random lines: float, or int8/int4 codes with per-page,
    per-KV-head scales (numpy arrays, and their torch twins)."""
    lines = rng.normal(size=(2, P + 1, ps, KV, dk)).astype(np.float32)
    if quant is None:
        return [lines[0], lines[1], None, None]
    spec = jq.SPECS[quant]
    out, scales = [], []
    for x in lines:
        s = np.abs(x).max(axis=(1, 3)) / spec.qmax + 1e-3                  # (P+1, KV)
        codes = np.clip(np.round(x / s[:, None, :, None]), -spec.qmax, spec.qmax)
        out.append(codes.astype(np.int8) if spec.pack == 1
                   else np.array(jq.pack_nibbles(jnp.asarray(codes))))
        scales.append(s.astype(np.float32))
    return [out[0], out[1], scales[0], scales[1]]


def _decode_case(rng, quant, R, H, KV, dk, ps, NP, lens, split_lines):
    """A decode step (C = 1): slot r holds lens[r] lines, its pages distinct
    and the rest of its table on the scratch page P; its row attends its
    lines (none at length 0). Every length in ``lens`` is taken relative to
    ``split_lines``: a number, or a (k, d) pair for k splits and d lines."""
    lens = [n if isinstance(n, int) else n[0] * split_lines + n[1] for n in lens]
    assert max(lens) <= (NP - 1) * ps
    P = R * NP
    q = rng.normal(size=(R, 1, H, dk)).astype(np.float32)
    kp, vp, ks, vs = _pools(rng, quant, P, ps, KV, dk)
    perm = rng.permutation(P).reshape(R, NP)
    held = np.array([-(-n // ps) for n in lens])
    table = np.where(np.arange(NP)[None, :] < held[:, None], perm, P).astype(np.int32)
    mask = (np.arange(NP * ps)[None, :] < np.array(lens)[:, None])[:, None, :]
    return q, kp, vp, ks, vs, table, mask, lens


def _torch(args):
    return [None if a is None else torch.from_numpy(np.array(a)) for a in args]


def _jax(args):
    return [None if a is None else jnp.asarray(a) for a in args]


# (R, C, KV, NP, ps): LLaMA-7B decode (16 slots, KV 32 and 8, 17 pages of
# 128), its chunks (C > 1), and small shapes at every page size
RULE_SHAPES = [(16, 1, 32, 17, 128), (16, 1, 8, 17, 128), (16, 4, 32, 17, 128),
               (16, 1, 32, 34, 64), (3, 1, 2, 4, 8), (3, 1, 2, 64, 16), (1, 1, 1, 1, 16),
               (4, 1, 2, 40, 32), (2, 8, 2, 9, 16),
               # a 32K-token cache in pages of 16: splits grow past 64 lines
               (16, 1, 8, 2048, 16), (1, 1, 2, 1000, 16)]


@pytest.mark.parametrize("shape", RULE_SHAPES, ids=lambda s: "R{}-C{}-KV{}-NP{}-ps{}".format(*s))
def test_split_rule_covers_every_line_once_on_page_boundaries(shape):
    R, C, KV, NP, ps = shape
    pages, n = tk.paged_decode_split(R, C, KV, NP, ps)
    assert pages >= 1 and n == -(-NP // pages)
    # the splits of whole pages cover lines [0, NP * ps) once each
    owner = np.full(NP * ps, -1)
    for s in range(n):
        p0, p1 = s * pages, min(NP, (s + 1) * pages)
        assert p0 < p1
        assert (owner[p0 * ps:p1 * ps] == -1).all()
        owner[p0 * ps:p1 * ps] = s
    assert (owner >= 0).all()
    if C > 1:
        assert n == 1  # a chunk's new lines may span two splits' pages
    else:
        # the longest of DECODE_SPLIT_LINES whose grid reaches
        # DECODE_SPLIT_BLOCKS blocks, else the shortest (at least a page)
        least = -(-NP // tk.DECODE_MAX_SPLITS)  # pages a split at most DECODE_MAX_SPLITS
        opts = [max(1, lines // ps, least) for lines in tk.DECODE_SPLIT_LINES]
        fills = [R * KV * -(-NP // p) >= tk.DECODE_SPLIT_BLOCKS for p in opts]
        assert pages == (opts[fills.index(True)] if any(fills) else opts[-1])
        assert n <= tk.DECODE_MAX_SPLITS
        assert pages * ps in tk.DECODE_SPLIT_LINES or pages in (1, least)
    # the shapes alone decide it
    assert tk.paged_decode_split(R, C, KV, NP, ps) == (pages, n)


def test_split_rule_on_llama7b_decode():
    """512-line splits of four pages at LLaMA-7B decode, 16 slots: 16 x 32
    x 5 = 2,560 blocks at MHA, 640 at KV 8; one slot at KV 8 (8 x 5 = 40
    blocks) takes one-page splits (136); chunks take one split."""
    assert tk.paged_decode_split(16, 1, 32, 17, 128) == (4, 5)
    assert tk.paged_decode_split(16, 1, 8, 17, 128) == (4, 5)
    assert tk.paged_decode_split(1, 1, 8, 17, 128) == (1, 17)
    assert tk.paged_decode_split(16, 4, 32, 17, 128) == (17, 1)


# (R, H, KV, dk, ps, NP): GQA at G = 4, the rule's own splits (5 of 8 pages)
MID = (5, 8, 2, 16, 8, 40)
# lengths: idle (its row attends nothing), one line, a split's last line,
# a split and a line (its last line the first line of split 1), and two
# splits and a half (splits 3 and 4 attend nothing)
MID_LENS = [0, 1, (1, 0), (1, 1), (2, 36)]


@pytest.mark.parametrize("quant", [None, "int8", "int4"])
def test_split_merge_matches_plain_version_and_jax_xla(quant):
    R, H, KV, dk, ps, NP = MID
    rng = np.random.default_rng(21)
    pages, n = tk.paged_decode_split(R, 1, KV, NP, ps)
    assert (pages, n) == (8, 5)
    q, kp, vp, ks, vs, table, mask, lens = _decode_case(
        rng, quant, R, H, KV, dk, ps, NP, MID_LENS, pages * ps)
    args = _torch([q, kp, vp, ks, vs, table, mask])
    got, attended = emulate_split_merge(*args[:3], args[5], args[6], k_scale=args[3],
                                        v_scale=args[4])
    # splits no row attends: all of the idle slot's, most of the short ones'
    assert not attended[0].any() and attended[1, :, 0].all() and not attended[1, :, 1:].any()
    assert attended[3, :, 1].all() and not attended[3, :, 2:].any()
    want = tk.ragged_paged_attention_ref(*args[:3], args[5], args[6], k_scale=args[3],
                                         v_scale=args[4])
    assert float((got - want).abs().max()) <= F32_TOL
    assert (got[0] == 0).all()  # a row with nothing to attend gives 0
    xla = np.asarray(jk.ragged_paged_attention_xla(
        *_jax([q, kp, vp, table, mask]), k_scale=_jax([ks])[0], v_scale=_jax([vs])[0]))
    live = np.array(lens) > 0
    np.testing.assert_allclose(got.numpy()[live], xla[live], atol=JAX_ATOL)


@pytest.mark.parametrize("quant", [None, "int8", "int4"])
def test_split_merge_bf16_matches_plain_version(quant):
    """bf16 q and pages: the emulation rounds its f32 result once, as the
    kernel does; held at the kernels' bf16 tolerance."""
    R, H, KV, dk, ps, NP = MID
    rng = np.random.default_rng(22)
    pages = tk.paged_decode_split(R, 1, KV, NP, ps)[0]
    q, kp, vp, ks, vs, table, mask, _ = _decode_case(
        rng, quant, R, H, KV, dk, ps, NP, MID_LENS, pages * ps)
    args = _torch([q, kp, vp, ks, vs, table, mask])
    args[0] = args[0].to(torch.bfloat16)
    if quant is None:
        args[1], args[2] = args[1].to(torch.bfloat16), args[2].to(torch.bfloat16)
    got, _ = emulate_split_merge(*args[:3], args[5], args[6], k_scale=args[3], v_scale=args[4])
    want = tk.ragged_paged_attention_ref(*args[:3], args[5], args[6], k_scale=args[3],
                                         v_scale=args[4])
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got, want, **BF16_TOL)


# the small shapes of tests/test_torch_paged_kernels.py (GQA at G = 2),
# where the rule takes one split: the emulation also forced to one-page
# and two-page splits, against the Pallas kernel in interpret mode
SMALL = (3, 4, 2, 16, 8, 4)


@pytest.mark.parametrize("split_pages", [1, 2, None], ids=["split1", "split2", "rule"])
@pytest.mark.parametrize("quant", [None, "int8", "int4"])
def test_split_merge_matches_jax_pallas(quant, split_pages):
    R, H, KV, dk, ps, NP = SMALL
    rng = np.random.default_rng(23 + (split_pages or 0))
    assert tk.paged_decode_split(R, 1, KV, NP, ps)[1] == 1
    # idle; a split's first line its last; a split's last line its last
    lens = [0, (1, 1), (1, 0)] if split_pages else [0, 1, (NP - 1) * ps]
    q, kp, vp, ks, vs, table, mask, lens = _decode_case(
        rng, quant, R, H, KV, dk, ps, NP, lens, (split_pages or NP) * ps)
    args = _torch([q, kp, vp, ks, vs, table, mask])
    got, _ = emulate_split_merge(*args[:3], args[5], args[6], k_scale=args[3],
                                 v_scale=args[4], split_pages=split_pages)
    want = np.asarray(jk.ragged_paged_attention(
        *_jax([q, kp, vp, table, mask]), k_scale=_jax([ks])[0], v_scale=_jax([vs])[0]))
    np.testing.assert_allclose(got.numpy(), want, atol=JAX_ATOL)
    assert (got[0] == 0).all()
    plain = tk.ragged_paged_attention_ref(*args[:3], args[5], args[6], k_scale=args[3],
                                          v_scale=args[4])
    assert float((got - plain).abs().max()) <= F32_TOL
