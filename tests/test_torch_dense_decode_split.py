"""The one split decode walk on dense addresses and in the whole step, on
the CPU: the dense kernel's host split rule (``kernels.dense_decode_split``),
a plain emulation of its split-and-merge held against the port's plain
version ``decode_attention_ref`` and JAX's ``decode_attention`` (the Pallas
kernel in interpret mode, as tests/test_kernels.py runs it), the dense
step's padding rule (``llama.decode_seq_lens``) against the full walk and
JAX, and the whole-step kernel's split item schedule and its shared-memory
mirror.

The emulation cuts each (slot, KV head) into the rule's splits of
consecutive lines, takes each attended split's partial softmax (m, l, acc)
in base 2 with the softmax scale times log2(e) on the scores (the kernel's
arithmetic, with IEEE f32 sums in another order), and merges the splits in
split order, as the last block of a (slot, KV head, head group) does on
the card. The kernel itself is held to the plain version on a GPU by
tests/test_torch_cuda.py.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flexflow_tpu.models import llama as jl
from flexflow_tpu.serve import kernels as jk
from flexflow_tpu_torch.models import llama as tl
from flexflow_tpu_torch.serve import kernels as tk

torch.set_num_threads(1)

# f32: the emulation and the plain version differ in summation order only
F32_TOL = dict(atol=1e-5, rtol=0.0)
# bf16 inputs: both compute in f32 and round the output once to bf16
BF16_TOL = dict(atol=1e-2, rtol=1e-2)
# against JAX's Pallas kernel (tests/test_torch_kernels.py's ATOL): its
# online softmax sums in its own order
JAX_ATOL = 2e-5


def emulate_dense_split(q, k, v, seq_lens, split_lines):
    """The dense kernel's result: q (R, H, dk) against lines [0, seq_len)
    of k/v (R, S1, KV, dk), cut into splits of ``split_lines`` lines, each
    attended split's (m, l, acc) in f32, merged in split order. Returns the
    output in q's dtype."""
    R, H, dk = q.shape
    KV = k.shape[2]
    G = H // KV
    qg = q.float().reshape(R, KV, G, dk)
    kf, vf = k.float(), v.float()
    out = torch.zeros(R, KV, G, dk)
    for r in range(R):
        n = int(seq_lens[r])
        parts = []
        for s0 in range(0, n, split_lines):
            s1 = min(n, s0 + split_lines)
            sc = torch.einsum("kgd,skd->kgs", qg[r], kf[r, s0:s1]) * (
                math.log2(math.e) / math.sqrt(dk))
            m = sc.amax(dim=-1)
            p = torch.exp2(sc - m[..., None])
            parts.append((m, p.sum(dim=-1), torch.einsum("kgs,skd->kgd", p, vf[r, s0:s1])))
        if not parts:
            continue  # nothing to attend: zeros
        M = parts[0][0]
        for m, _, _ in parts[1:]:
            M = torch.maximum(M, m)
        L = torch.zeros(KV, G)
        O = torch.zeros(KV, G, dk)
        for m, l, acc in parts:  # split order
            f = torch.exp2(m - M)
            L = L + l * f
            O = O + acc * f[..., None]
        out[r] = O / L.clamp_min(1e-20)[..., None]
    return out.reshape(R, H, dk).to(q.dtype)


# (R, KV, S1, head groups): LLaMA-7B decode (16 slots, S1 2113) at KV 32,
# 8, 2 (G 16: two groups) and 1 (MQA: four groups), short and long caches
RULE_SHAPES = [(16, 32, 2113, 1), (16, 8, 2113, 1), (16, 2, 2113, 2), (16, 1, 2113, 4),
               (4, 2, 200, 2), (1, 1, 1, 1), (3, 2, 65, 1), (16, 8, 32769, 1),
               (2, 1, 100000, 1)]


@pytest.mark.parametrize("shape", RULE_SHAPES, ids=lambda s: "R{}-KV{}-S1{}-g{}".format(*s))
def test_dense_split_rule_covers_every_line_once(shape):
    """The splits cover lines [0, S1) once each, at most DECODE_MAX_SPLITS
    of them; the grid reaches DECODE_SPLIT_BLOCKS blocks unless the split
    is the ladder's shortest; and the first ceil(len / split) splits, the
    ones the kernel walks, cover [0, len) once for every length."""
    R, KV, S1, groups = shape
    split, n = tk.dense_decode_split(R, KV, S1, groups)
    assert split >= 1 and n == -(-S1 // split) <= tk.DECODE_MAX_SPLITS
    owner = np.full(S1, -1)
    for s in range(n):
        s0, s1 = s * split, min(S1, (s + 1) * split)
        assert s0 < s1 and (owner[s0:s1] == -1).all()
        owner[s0:s1] = s
    assert (owner >= 0).all()
    assert (R * KV * groups * n >= tk.DECODE_SPLIT_BLOCKS
            or split == max(tk.DECODE_SPLIT_LINES[-1], -(-S1 // tk.DECODE_MAX_SPLITS)))
    for length in sorted(x for x in {0, 1, split - 1, split, split + 1, S1 - 1, S1}
                         if 0 <= x <= S1):
        walked = -(-length // split)
        assert walked <= n
        assert sorted(owner[:length]) == sorted(
            s for s in range(walked) for _ in range(min(length, (s + 1) * split) - s * split))


@pytest.mark.parametrize("dk", [64, 128])
@pytest.mark.parametrize("G", [1, 4, 16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_split_merge_emulation_matches_plain_and_jax(dtype, G, dk):
    """The emulated split-and-merge against the plain version and JAX's
    Pallas kernel (interpret mode), at the rule's split and at a forced
    short one (several splits, a slot ending on a split boundary, one a
    line past it, a padding row of length 0, a full cache)."""
    rng = np.random.default_rng(G * dk)
    R, KV, S1 = 6, 2, 200
    H = KV * G
    q = rng.normal(size=(R, H, dk)).astype(np.float32)
    k = rng.normal(size=(R, S1, KV, dk)).astype(np.float32)
    v = rng.normal(size=(R, S1, KV, dk)).astype(np.float32)
    qt, kt, vt = (torch.from_numpy(x).to(dtype) for x in (q, k, v))
    rule, _ = tk.dense_decode_split(R, KV, S1, tk.dense_head_groups(G))
    for split in (rule, 48):
        lens = np.asarray([0, 1, split, split + 1, S1 - 1, S1], np.int32)
        sl = torch.from_numpy(lens)
        got = emulate_dense_split(qt, kt, vt, sl, split)
        ref = tk.decode_attention_ref(qt, kt, vt, sl)
        torch.testing.assert_close(got, ref, **(F32_TOL if dtype == torch.float32
                                                else BF16_TOL))
        assert (got[0] == 0).all()
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    want = jk.decode_attention(*(jnp.asarray(x.float().numpy(), dtype=jdt) for x in (qt, kt, vt)),
                               jnp.asarray(lens), block_s=64)
    want = torch.from_numpy(np.array(want.astype(jnp.float32)))
    if dtype == torch.float32:
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=JAX_ATOL)
    else:
        torch.testing.assert_close(got.float(), want, **BF16_TOL)


@pytest.fixture(scope="module")
def models():
    cfg_j = jl.LLaMAConfig.tiny(dtype=jnp.float32)
    params_j = jl.init_params(jax.random.PRNGKey(21), cfg_j)
    cfg_t = tl.LLaMAConfig.tiny(dtype=torch.float32)
    params_t = tl.params_from_numpy(jax.tree.map(np.asarray, params_j), device="cpu")
    return cfg_j, params_j, cfg_t, params_t


def _full_walk(mask, positions, S1):
    """The dense step's lengths before the padding rule: every row, padding
    rows too, attends its mask row (a padding row: every line below the
    scratch line)."""
    return mask[:, 0, :].sum(dim=-1).to(torch.int32)


def test_padding_rule_zeroes_only_padding_rows():
    """A padding row (cache position S1 - 1) attends nothing; every other
    row attends its mask row."""
    S1 = 9
    pos = torch.tensor([[3], [S1 - 1], [0], [S1 - 1]])
    mask = tk.causal_serve_mask(pos, S1)
    assert tl.decode_seq_lens(mask, pos, S1).tolist() == [4, 0, 1, 0]
    assert _full_walk(mask, pos, S1).tolist() == [4, S1 - 1, 1, S1 - 1]


def test_serve_step_padding_rows_walk_nothing(models, monkeypatch):
    """serve_step(kernels="cuda") on the CPU over 4 slots, two of them idle
    (their decode tokens padding at the scratch line): a prefill step, then
    greedy decode steps. The live rows' logits are bitwise those of the
    same steps with the padding rows walking the whole cache, and the
    greedy tokens equal JAX's serve_step (Pallas kernels, interpret
    mode)."""
    cfg_j, params_j, cfg_t, params_t = models
    R, max_len = 4, 40
    S1 = max_len + 1
    scratch = S1 - 1
    live = [0, 2]
    tok = np.zeros((R, 4), np.int32)
    pos = np.full((R, 4), scratch, np.int32)
    tok[0], pos[0] = [5, 6, 7, 8], [0, 1, 2, 3]
    tok[2, :2], pos[2, :2] = [9, 10], [0, 1]
    idx = np.asarray([3, 0, 1, 0], np.int32)
    caches = {"rule": tl.init_kv_cache(cfg_t, R, max_len, torch.float32),
              "full": tl.init_kv_cache(cfg_t, R, max_len, torch.float32)}
    cache_j = jl.init_kv_cache(cfg_j, R, max_len, jnp.float32)
    lengths = [4, 2]
    for step in range(4):
        logits = {}
        for name, cache in caches.items():
            with monkeypatch.context() as m:
                if name == "full":
                    m.setattr(tl, "decode_seq_lens", _full_walk)
                logits[name] = tl.serve_step(params_t, cache, *(torch.from_numpy(x) for x in
                                                                (tok, pos, idx)),
                                             None, cfg=cfg_t, kernels="cuda")[0]
        lj, cache_j = jl.serve_step(params_j, cache_j, jnp.asarray(tok), jnp.asarray(pos),
                                    jnp.asarray(idx), None, cfg=cfg_j, kernels="pallas")
        assert torch.equal(logits["rule"][live], logits["full"][live]), step
        greedy = logits["rule"].argmax(dim=-1)
        assert greedy[live].tolist() == np.asarray(lj).argmax(axis=-1)[live].tolist(), step
        # the next decode step: the live slots' greedy tokens, the idle
        # slots' padding at the scratch line
        tok = np.zeros((R, 1), np.int32)
        pos = np.full((R, 1), scratch, np.int32)
        for i, r in enumerate(live):
            tok[r, 0], pos[r, 0] = int(greedy[r]), lengths[i]
            lengths[i] += 1
        idx = np.zeros((R,), np.int32)


def split_items(live_slots, KV, rows, nsplit, blocks):
    """The items each block of the whole-step kernel walks in the attention
    stage of a decode-design step (``rows`` = C * G query rows a KV head),
    as csrc/whole_step_decode.cu enumerates them (attend_row_split): item
    k is (live_slots[k // (KV * rows * nsplit)], k // (rows * nsplit) % KV,
    k // nsplit % rows, k % nsplit), taken by block k % blocks (its loop
    steps by the grid's size). Returns a list of (slot, KV head, row,
    split) lists, one per block."""
    per_block = [[] for _ in range(blocks)]
    for k in range(len(live_slots) * KV * rows * nsplit):
        per_block[k % blocks].append((live_slots[k // (KV * rows * nsplit)],
                                      k // (rows * nsplit) % KV, k // nsplit % rows, k % nsplit))
    return per_block


def _live_slots(phys, scratch):
    """The slots with a line off the scratch page, as the kernel lists them."""
    return [r for r in range(phys.shape[0]) if bool((phys[r] != scratch).any())]


# (R, C, KV, NP, ps, blocks) of a model of 32 query heads: LLaMA-7B
# decode on the paged slice (16 slots, 17 pages of 128, 132 blocks: one an
# SM), GQA (KV 8: 4 rows a KV head), a chunk of C = 2 at KV 8 (8 rows, one
# split) and small shapes with more blocks than items
SCHEDULE_SHAPES = [(16, 1, 32, 17, 128, 132), (16, 1, 8, 17, 128, 132), (16, 2, 8, 17, 128, 132),
                   (6, 1, 16, 40, 16, 132), (3, 1, 32, 4, 16, 264)]


@pytest.mark.parametrize("shape", SCHEDULE_SHAPES,
                         ids=lambda s: "R{}-C{}-KV{}-NP{}-ps{}-b{}".format(*s))
def test_whole_step_split_items_cover_every_live_unit_split_once(shape):
    """The whole step's split walk at decode: items (live slot, KV head,
    query row, split) under the paged kernels' split rule, each taken by
    exactly one block, every (live slot, KV head, row, split) once, no
    idle slot's, and the blocks' item counts within one of each other."""
    R, C, KV, NP, ps, blocks = shape
    rows = C * (32 // KV)
    rng = np.random.default_rng(R * KV + NP)
    scratch = R * NP
    phys = rng.integers(0, scratch, size=(R, C))
    idle = rng.choice(R, size=R // 2, replace=False)
    phys[idle] = scratch  # an idle slot: every line on the scratch page
    live = _live_slots(phys, scratch)
    _, nsplit = tk.paged_decode_split(R, C, KV, NP, ps)
    assert nsplit == 1 or C == 1
    per_block = split_items(live, KV, rows, nsplit, blocks)
    items = [it for b in per_block for it in b]
    want = {(r, h, i, s) for r in live for h in range(KV) for i in range(rows)
            for s in range(nsplit)}
    assert len(items) == len(set(items)) == len(want) and set(items) == want
    assert not {r for r, _, _, _ in items} & set(idle.tolist())
    counts = [len(b) for b in per_block]
    assert max(counts) - min(counts) <= 1


# SplitLayout<T, DK>::kSlots of csrc/whole_step_decode.cu by (f32, dk): the
# walk's SplitSmem for one row and 8 warps (1,128 + 32 dk bytes, rounded
# up to 16) and one query row of dk elements
SPLIT_SMEM = {(False, 64): 3312, (False, 128): 5488, (True, 64): 3440, (True, 128): 5744}


@pytest.mark.parametrize("f32,dk", sorted(SPLIT_SMEM))
def test_whole_step_split_smem_mirror_pins_the_layout(f32, dk, monkeypatch):
    """The gate's mirror of the split walk's dynamic shared memory: the
    layout's bytes plus 4 a slot for the live-slot list; the gate prices
    it for a decode step (at most 8 query rows a KV head) and not for a
    wider one, which prices the tensor-core tile in its place."""
    assert tk.whole_step_split_smem_bytes(f32, dk, 0) == SPLIT_SMEM[(f32, dk)]
    assert tk.whole_step_split_smem_bytes(f32, dk, 16) == SPLIT_SMEM[(f32, dk)] + 64
    dt = torch.float32 if f32 else torch.bfloat16
    meta = dict(dtype=dt, device="meta")
    D = F = 128
    la = {"wq": torch.empty((1, D, D), **meta), "wk": torch.empty((1, D, D), **meta),
          "wv": torch.empty((1, D, D), **meta), "wo": torch.empty((1, D, D), **meta),
          "w1": torch.empty((1, D, F), **meta), "w2": torch.empty((1, F, D), **meta),
          "w3": torch.empty((1, D, F), **meta)}
    roles = {"q": ("wq", None), "k": ("wk", None), "v": ("wv", None), "o": ("wo", None),
             "gate": ("w1", None), "up": ("w3", None), "down": ("w2", None)}
    cache = {"k": torch.empty((1, 9, 16, 1, dk), **meta)}
    seen = []
    big = 200_000  # more than any other term of these shapes

    def split_bytes(f32_, dk_, R):
        seen.append((f32_, dk_, R))
        return big
    monkeypatch.setattr(tk, "whole_step_split_smem_bytes", split_bytes)
    for C in (1, 16):  # 128 // dk query heads, one KV head: 2 or 1 rows a token
        x0 = torch.empty((2, C, D), **meta)
        est = tk.whole_step_smem_bytes(la, cache, x0, D // dk, tiles=1, tile_roles=roles)
        if C == 1:
            assert est == tk._WS_STATIC_SMEM + big and seen == [(f32, dk, 2)]
        else:
            assert seen == [(f32, dk, 2)]  # not priced at C * G > 8
            assert est >= tk._WS_STATIC_SMEM + tk.mma_smem_bytes(f32, 0, dk)
