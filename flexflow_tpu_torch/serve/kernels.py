"""Hand-written CUDA kernels of the serving hot path: attention, the
whole serving step in one kernel (:func:`whole_step_decode`), and the
product of a weight-only quantized weight (:func:`wq_matmul`).

Each kernel here has three parts side by side:

* the **wrapper** (:func:`decode_attention`, :func:`verify_attention`
  and :func:`verify_attention_bits`, :func:`ragged_paged_attention`,
  :func:`fused_rope_paged_attention`, :func:`whole_step_decode`, and
  :func:`commit_paged`, the unfused step's quantized K/V commit, and
  :func:`wq_matmul`, the layer projections of quantized weights):
  checks device, dtype, shape and contiguity, then either runs the plain
  version (the tensors lie on the CPU) or launches the CUDA kernel (the
  tensors lie on a GPU) — never a fallback from a GPU tensor to the plain
  version. Each launch adds one to ``LAUNCHES[name]``; the paged kernels
  and the whole-step kernel count per pool type,
  ``name[bf16|f32|int8|int4]`` (the commit kernel ``paged_commit[int8|int4]``), and the paged and verify kernels also
  per block design, as their launcher reports it, in ``DESIGN_LAUNCHES``
  (``name[decode|mma|tf32x3]``, ``verify_attention[rows8|mma|f32|tf32x3]``).
* the **plain PyTorch version** (``*_ref``) with the kernel's semantics,
  used on the CPU and as the yardstick the kernel is held to on the GPU.
* the **kernel**, CUDA C++ for ``sm_90a`` in ``flexflow_tpu_torch/csrc/``
  (its header says which TPU kernel it replaces, what bounds it on an
  H100 and what its design does about that), built on first use by
  :mod:`._cuda`.

Every kernel computes an f32 online softmax and clamps the softmax
denominator at 1e-20, so a query row with nothing to attend gives 0
(``serve_attention`` and :func:`ragged_paged_attention_torch` give the
mean of V there instead; only padding rows meet that case and their
outputs are never read).

The paged kernels read K/V from page pools ``(P+1, page_size, KV,
dk/pack)`` through a per-slot page table (serve/paging.py); pool row P
is the scratch page. Quantized pools (serve/kv_quant.py) hold int8
codes, or int4 codes packed two per uint8 byte, with one f32 scale per
page and KV head; the kernels multiply the scores by ``k_scale * scale``
and the probabilities by ``v_scale`` (the TPU kernel's order), the torch
path dequantizes the gathered lines first.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch

from ._cuda import DESIGNS
from .kv_quant import pool_pack, quant_line_write, unpack_codes

NEG_INF = -1e30

#: pool types of the paged kernels, as their launch counters name them
POOL_TYPES = ("bf16", "f32", "int8", "int4")
PAGED_KERNELS = ("ragged_paged_attention", "fused_rope_paged_attention")
#: pool types of the commit kernel (:func:`commit_paged` on quantized pools)
QUANT_POOL_TYPES = ("int8", "int4")

#: launches per kernel since the last :func:`reset_launch_counts` — a
#: launch of the CUDA kernel counts, a plain-version call on the CPU not
LAUNCHES: Dict[str, int] = {
    "decode_attention": 0,
    "verify_attention": 0,
    **{f"{k}[{t}]": 0 for k in PAGED_KERNELS + ("whole_step_decode",) for t in POOL_TYPES},
    **{f"paged_commit[{t}]": 0 for t in QUANT_POOL_TYPES},
    **{f"wq_matmul[{t}]": 0 for t in QUANT_POOL_TYPES},
}

#: launches of the paged, verify and whole-step kernels by the block design
#: their launcher took (``_cuda.DESIGNS``; paged, and the whole step's
#: attention stage: "decode" for C * G <= 8 (the paged kernels: split over
#: pages, :func:`paged_decode_split`), else "mma" for bf16 q on the
#: tensor cores, "tf32x3" for f32 q on the TF32 tensor cores, each f32
#: product as three TF32 products; verify: "mma" and "tf32x3" at C * G >
#: 8, "rows8" and "f32" on the CUDA cores below), since the last reset. A
#: launch of the whole-step kernel's speculation fold (``all_logits``: a
#: SpecInfer draft or verify step) counts as ``whole_step_decode[<design>-tree]``.
DESIGN_LAUNCHES: Dict[str, int] = {
    **{f"{k}[{d}]": 0 for k in PAGED_KERNELS + ("verify_attention", "whole_step_decode")
       for d in DESIGNS[k][0]},
    **{f"whole_step_decode[{d}-tree]": 0 for d in DESIGNS["whole_step_decode"][0]},
    **{f"wq_matmul[{d}]": 0 for d in DESIGNS["wq_matmul"][0]},
}

#: calls of a plain version that the card's serving path must never take
#: (:func:`wq_matmul_ref`: dequantize, then the product), since the last
#: reset; a CPU run counts them too
PLAIN_CALLS: Dict[str, int] = {"wq_matmul": 0}

#: head dims, q dtypes and page sizes the CUDA kernels are instantiated
#: for: the dense kernels take _CUDA_HEAD_DIMS, the paged kernels and the
#: commit kernel _PAGED_HEAD_DIMS (Phi-2's 80 and Gemma's 256 too), the
#: whole-step kernel _WHOLE_HEAD_DIMS
_CUDA_HEAD_DIMS = (64, 128)
_PAGED_HEAD_DIMS = (64, 80, 128, 256)
_WHOLE_HEAD_DIMS = (64, 80, 128, 256)
_CUDA_DTYPES = (torch.float32, torch.bfloat16)
_CUDA_PAGE_SIZES = (16, 32, 64, 128)
#: most new lines per slot the fused kernel commits in one launch
_FUSED_MAX_CHUNK = 256


def reset_launch_counts() -> None:
    for counts in (LAUNCHES, DESIGN_LAUNCHES, PLAIN_CALLS):
        for name in counts:
            counts[name] = 0


def _count_design(name: str, q: torch.Tensor, KV: int) -> None:
    """Count one launch of kernel ``name`` (q (R, C, H, dk), KV key/value
    heads) by the block design its launcher took."""
    from . import _cuda

    _, C, H, _ = q.shape
    design = _cuda.design(name, C, H, KV, _dtype_code(q.dtype))
    DESIGN_LAUNCHES[f"{name}[{design}]"] += 1


def _count_paged(name: str, q: torch.Tensor, k_pool: torch.Tensor) -> None:
    """Count one launch of paged kernel ``name``, by pool type and by the
    block design its launcher took."""
    LAUNCHES[f"{name}[{pool_type(k_pool)}]"] += 1
    _count_design(name, q, k_pool.shape[2])


# ---------------------------------------------------------------------------
# decode attention


def decode_attention_ref(q, k_cache, v_cache, seq_lens, *,
                         scale: Optional[float] = None):
    """Plain version: q (R, H, dk) — one query token per slot — against
    cache lines [0, seq_len) of k/v (R, S1, KV, dk). Returns (R, H, dk)
    in q's dtype; a slot with seq_len 0 gives zeros."""
    R, H, dk = q.shape
    S1, KV = k_cache.shape[1], k_cache.shape[2]
    G = H // KV
    scale = scale if scale is not None else 1.0 / math.sqrt(dk)
    qg = q.to(torch.float32).reshape(R, KV, G, dk)
    scores = torch.einsum("rkgd,rskd->rkgs", qg, k_cache.to(torch.float32)) * scale
    valid = (torch.arange(S1, device=q.device)[None, :]
             < seq_lens.to(q.device)[:, None])[:, None, None, :]
    scores = torch.where(valid, scores, NEG_INF)
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.where(valid, torch.exp(scores - m), 0.0)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-20)
    out = torch.einsum("rkgs,rskd->rkgd", p, v_cache.to(torch.float32)) / l
    return out.reshape(R, H, dk).to(q.dtype)


def decode_attention(q, k_cache, v_cache, seq_lens, *,
                     scale: Optional[float] = None):
    """Fused decode attention: one query token per request slot against
    its cache prefix. q (R, H, dk); k/v (R, S1, KV, dk); seq_lens (R,)
    int32 — lines [0, seq_len) are attended. Returns (R, H, dk). On the
    GPU it runs the split decode walk of the paged kernels on dense
    addresses: (slot, KV head, head group of at most DECODE_ROWS query
    heads, split of :func:`dense_decode_split` lines) blocks, a split past
    its slot's seq_len exiting before any load, the partials in a
    workspace kept for the stream, merged inside the one launch."""
    R, H, dk = q.shape
    _check_cache(q, k_cache, v_cache, R, H, dk)
    if seq_lens.shape != (R,):
        raise ValueError(f"seq_lens shape {tuple(seq_lens.shape)} != ({R},)")
    if q.device.type == "cpu":
        return decode_attention_ref(q, k_cache, v_cache, seq_lens, scale=scale)
    _check_cuda(q, k_cache, v_cache, dk)
    if seq_lens.dtype != torch.int32 or seq_lens.device != q.device:
        raise ValueError("seq_lens must be int32 on q's device")
    if not seq_lens.is_contiguous():
        raise ValueError("seq_lens must be contiguous")
    from . import _cuda

    S1, KV = k_cache.shape[1], k_cache.shape[2]
    G = H // KV
    groups = dense_head_groups(G)
    split, n = dense_decode_split(R, KV, S1, groups)
    ws = counters = None
    if n > 1:
        units = R * KV * groups
        ws, counters = _split_scratch(q.device, units * n * min(G, DECODE_ROWS) * (dk + 2),
                                      units)
    out = torch.empty_like(q)
    _cuda.launch(
        "decode_attention",
        [q, k_cache, v_cache, seq_lens, out, ws, counters],
        [R, S1, H, KV, dk, _dtype_code(q.dtype), split],
        [scale if scale is not None else 1.0 / math.sqrt(dk)],
    )
    LAUNCHES["decode_attention"] += 1
    return out


# ---------------------------------------------------------------------------
# verify attention


def verify_attention_ref(q, k_cache, v_cache, mask, *,
                         scale: Optional[float] = None):
    """Plain version: q (R, C, H, dk) — C query tokens per slot — against
    the cache lines of k/v (R, S1, KV, dk) that ``mask`` (R, C, S1) bool
    lets each token attend (causal chunked prefill or a tree bitmask).
    Returns (R, C, H, dk) in q's dtype; a fully masked row gives zeros."""
    R, C, H, dk = q.shape
    KV = k_cache.shape[2]
    G = H // KV
    scale = scale if scale is not None else 1.0 / math.sqrt(dk)
    qg = q.to(torch.float32).reshape(R, C, KV, G, dk)
    scores = torch.einsum("rckgd,rskd->rkgcs", qg, k_cache.to(torch.float32)) * scale
    m_ = mask.to(q.device)[:, None, None]  # (R, 1, 1, C, S1)
    scores = torch.where(m_, scores, NEG_INF)
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.where(m_, torch.exp(scores - m), 0.0)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-20)
    out = torch.einsum("rkgcs,rskd->rkgcd", p, v_cache.to(torch.float32)) / l
    return out.permute(0, 3, 1, 2, 4).reshape(R, C, H, dk).to(q.dtype)


def pack_mask_bits(mask: torch.Tensor) -> torch.Tensor:
    """A bool mask (R, C, S1) as (R, C, W) int64 words, W = ceil(S1 / 64):
    bit j of word w is line 64 w + j (the high bits of the last word are
    0). The serving step packs its mask once for every layer's verify
    launch."""
    R, C, S1 = mask.shape
    W = -(-S1 // 64)
    m = mask.to(torch.uint8).contiguous()
    if W * 64 != S1:
        m = torch.cat([m, m.new_zeros(R, C, W * 64 - S1)], dim=-1)
    weights = torch.tensor([1 << i for i in range(8)], dtype=torch.uint8, device=mask.device)
    # bytes of 8 lines each (little-endian bit order), then 8 bytes a word
    nbytes = (m.view(R, C, W * 8, 8) * weights).sum(dim=-1, dtype=torch.uint8)
    return nbytes.view(torch.int64)


def unpack_mask_bits(bits: torch.Tensor, S1: int) -> torch.Tensor:
    """The bool mask (R, C, S1) that :func:`pack_mask_bits` packed."""
    R, C, W = bits.shape
    shifts = torch.arange(8, dtype=torch.uint8, device=bits.device)
    lines = (bits.contiguous().view(torch.uint8)[..., None] >> shifts) & 1
    return lines.reshape(R, C, W * 64)[..., :S1].bool()


def verify_attention(q, k_cache, v_cache, mask, *,
                     scale: Optional[float] = None):
    """Fused verify attention: every one of the C query tokens per slot
    attends the cache lines its ``mask`` row allows, in one pass over the
    cache. q (R, C, H, dk); k/v (R, S1, KV, dk); mask (R, C, S1) bool.
    Returns (R, C, H, dk). On the GPU the mask is packed
    (:func:`pack_mask_bits`) and :func:`verify_attention_bits` runs."""
    R, C, H, dk = q.shape
    _check_cache(q, k_cache, v_cache, R, H, dk)
    S1 = k_cache.shape[1]
    if mask.shape != (R, C, S1) or mask.dtype != torch.bool:
        raise ValueError(
            f"mask must be bool ({R}, {C}, {S1}); got {mask.dtype} "
            f"{tuple(mask.shape)}"
        )
    if q.device.type == "cpu":
        return verify_attention_ref(q, k_cache, v_cache, mask, scale=scale)
    if mask.device != q.device:
        raise ValueError("mask must lie on q's device")
    return verify_attention_bits(q, k_cache, v_cache, pack_mask_bits(mask), S1,
                                 scale=scale)


def verify_attention_bits(q, k_cache, v_cache, bits, S1: int, *,
                          scale: Optional[float] = None):
    """:func:`verify_attention` with the mask packed by
    :func:`pack_mask_bits`: bits (R, C, ceil(S1 / 64)) int64. On the CPU
    it unpacks the mask and runs the plain version."""
    R, C, H, dk = q.shape
    _check_cache(q, k_cache, v_cache, R, H, dk)
    W = -(-S1 // 64)
    if k_cache.shape[1] != S1:
        raise ValueError(f"S1={S1} != the cache's {k_cache.shape[1]} lines")
    if bits.shape != (R, C, W) or bits.dtype != torch.int64:
        raise ValueError(f"bits must be int64 ({R}, {C}, {W}); got {bits.dtype} "
                         f"{tuple(bits.shape)}")
    if q.device.type == "cpu":
        return verify_attention_ref(q, k_cache, v_cache, unpack_mask_bits(bits, S1),
                                    scale=scale)
    _check_cuda(q, k_cache, v_cache, dk)
    if bits.device != q.device or not bits.is_contiguous():
        raise ValueError("bits must be contiguous on q's device")
    from . import _cuda

    KV = k_cache.shape[2]
    out = torch.empty_like(q)
    _cuda.launch(
        "verify_attention",
        [q, k_cache, v_cache, bits, out],
        [R, C, S1, H, KV, dk, _dtype_code(q.dtype)],
        [scale if scale is not None else 1.0 / math.sqrt(dk)],
    )
    LAUNCHES["verify_attention"] += 1
    _count_design("verify_attention", q, KV)
    return out


# ---------------------------------------------------------------------------
# shared checks


def _check_cache(q, k_cache, v_cache, R, H, dk):
    if k_cache.shape != v_cache.shape or k_cache.dim() != 4:
        raise ValueError(
            f"k/v caches must share one (R, S1, KV, dk) shape; got "
            f"{tuple(k_cache.shape)} and {tuple(v_cache.shape)}"
        )
    if k_cache.shape[0] != R or k_cache.shape[3] != dk:
        raise ValueError(
            f"cache {tuple(k_cache.shape)} does not match q's slots {R} and "
            f"head dim {dk}"
        )
    if H % k_cache.shape[2]:
        raise ValueError(f"H={H} is not a multiple of KV={k_cache.shape[2]}")
    if q.device != k_cache.device or q.device != v_cache.device:
        raise ValueError("q and the caches must lie on one device")


def _check_cuda(q, k_cache, v_cache, dk):
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    if q.dtype not in _CUDA_DTYPES or k_cache.dtype != q.dtype or v_cache.dtype != q.dtype:
        raise ValueError(
            f"CUDA attention takes float32 or bfloat16 q and caches of the "
            f"same dtype; got {q.dtype}, {k_cache.dtype}, {v_cache.dtype}"
        )
    if dk not in _CUDA_HEAD_DIMS:
        raise ValueError(f"CUDA attention has no head dim {dk} (has {_CUDA_HEAD_DIMS})")
    for name, t in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")


def _dtype_code(dtype: torch.dtype) -> int:
    return 1 if dtype == torch.bfloat16 else 0


# ---------------------------------------------------------------------------
# Shared serving-mask construction


def causal_serve_mask(positions: torch.Tensor, S1: int) -> torch.Tensor:
    """Causal-by-position mask over a dense cache: positions (R, C) →
    (R, C, S1) bool. Line S1-1 is the per-slot scratch row and is never
    attended; only positions already written satisfy ``<=``, so stale
    lines from an evicted slot occupant are never read."""
    key_pos = torch.arange(S1, dtype=positions.dtype, device=positions.device)
    mask = key_pos[None, None, :] <= positions[:, :, None]
    return mask & (key_pos[None, None, :] < S1 - 1)


def paged_serve_mask(mask: Optional[torch.Tensor], positions: torch.Tensor,
                     num_logical_pages: int, page_size: int,
                     cache_len: int) -> torch.Tensor:
    """Paged twin of :func:`causal_serve_mask` over the page-aligned
    virtual cache (S_virt = NP * page_size): the causal mask when
    ``mask`` is None, else the explicit (R, C, cache_len+1) mask padded
    with never-attended lines out to S_virt. The scratch line (index
    ``cache_len``, where padding tokens write) is excluded."""
    S_virt = num_logical_pages * page_size
    if mask is None:
        key_pos = torch.arange(S_virt, dtype=positions.dtype, device=positions.device)
        m = key_pos[None, None, :] <= positions[:, :, None]
        return m & (key_pos[None, None, :] < cache_len)
    if mask.shape[-1] < S_virt:
        pad = mask.new_zeros(mask.shape[:-1] + (S_virt - mask.shape[-1],))
        mask = torch.cat([mask, pad], dim=-1)
    return mask


# ---------------------------------------------------------------------------
# Paged KV: gathers through the page table and the torch serving math


def gather_pages(pool: torch.Tensor, page_table: torch.Tensor) -> torch.Tensor:
    """A slot's logical cache from the page pool: pool (P+1, ps, ...) ×
    table (R, NP) → virtual cache (R, NP*ps, ...). Unallocated entries
    point at the scratch page, which the caller's mask never exposes."""
    R, NP = page_table.shape
    ps = pool.shape[1]
    flat = pool[page_table.reshape(-1).long()]
    return flat.reshape((R, NP * ps) + tuple(pool.shape[2:]))


def _line_scales(scale: torch.Tensor, page_table: torch.Tensor, ps: int) -> torch.Tensor:
    """(P+1, KV) per-page scales → (R, NP*ps, KV), one per virtual line."""
    R, NP = page_table.shape
    s = scale[page_table.reshape(-1).long()]
    return s.reshape(R, NP, 1, -1).expand(R, NP, ps, s.shape[-1]).reshape(R, NP * ps, -1)


def dequant_pages(pool: torch.Tensor, scale: torch.Tensor,
                  page_table: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Quantized twin of :func:`gather_pages`: the (R, NP*ps, KV, dk)
    virtual cache in ``dtype``, each line's codes (unpacked from nibbles
    for uint8 pools) times its page's per-KV-head scale."""
    codes = unpack_codes(gather_pages(pool, page_table), pool_pack(pool))
    s = _line_scales(scale, page_table, pool.shape[1])
    return (codes * s[..., None]).to(dtype)


def ragged_paged_attention_torch(q, k_pool, v_pool, page_table, mask, *,
                                 scale: Optional[float] = None,
                                 k_scale=None, v_scale=None):
    """The ``kernels="torch"`` math (the JAX package's
    ``ragged_paged_attention_xla``): gather (and dequantize) the virtual
    cache through the table, then the grouped-query masked softmax of
    ``serve_attention`` with probabilities rounded to q's dtype. A row
    with nothing to attend gives the mean of V. Returns (R, C, H, dk)."""
    R, C, H, dk = q.shape
    KV = k_pool.shape[2]
    G = H // KV
    scale = scale if scale is not None else 1.0 / math.sqrt(dk)
    if k_scale is not None:
        k_virt = dequant_pages(k_pool, k_scale, page_table, q.dtype)
        v_virt = dequant_pages(v_pool, v_scale, page_table, q.dtype)
    else:
        k_virt = gather_pages(k_pool, page_table)
        v_virt = gather_pages(v_pool, page_table)
    qg = q.reshape(R, C, KV, G, dk)
    scores = torch.einsum("rckgd,rskd->rkgcs", qg.to(torch.float32),
                          k_virt.to(torch.float32)) * scale
    scores = torch.where(mask[:, None, None], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    dt = torch.promote_types(q.dtype, v_virt.dtype)
    out = torch.einsum("rkgcs,rskd->rckgd", probs.to(dt), v_virt.to(dt))
    return out.reshape(R, C, H, dk)


def _rope_rotate(x, cos, sin):
    """Rotate-half RoPE on the trailing head dim, op for op the unfused
    ``apply_rope`` (models/llama.py), so the fused path stays bitwise
    the unfused one. ``cos``/``sin`` arrive broadcastable against ``x``;
    a partial rotary width (``cos.shape[-1] < head_dim``) passes the tail
    of each head through."""
    rot = cos.shape[-1]
    xr = x[..., :rot]
    half = rot // 2
    rotated = torch.cat([-xr[..., half:], xr[..., :half]], dim=-1)
    out = xr * cos + rotated * sin
    if x.shape[-1] > rot:
        out = torch.cat([out, x[..., rot:].to(out.dtype)], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# ragged paged attention


def pool_type(pool: torch.Tensor) -> str:
    """The launch-counter name of a page pool's type."""
    if pool.dtype == torch.uint8:
        return "int4"
    if pool.dtype == torch.int8:
        return "int8"
    return {torch.bfloat16: "bf16", torch.float32: "f32"}.get(
        pool.dtype, str(pool.dtype).replace("torch.", ""))


def ragged_paged_attention_ref(q, k_pool, v_pool, page_table, mask, *,
                               scale: Optional[float] = None,
                               k_scale=None, v_scale=None):
    """Plain version: q (R, C, H, dk) against the lines of the pools
    (P+1, ps, KV, dk/pack) that ``mask`` (R, C, NP*ps) lets each token
    attend, line s of slot r at line s % ps of page table[r, s // ps].
    With ``k_scale``/``v_scale`` (P+1, KV) the pools hold codes and, as
    in the kernel, scores are dot(q, codes) * (k_scale * scale) and the
    probabilities weigh the V codes times v_scale. f32 throughout; a row
    with nothing to attend gives 0. Returns (R, C, H, dk) in q's dtype."""
    R, C, H, dk = q.shape
    ps, KV = k_pool.shape[1], k_pool.shape[2]
    G = H // KV
    scale = scale if scale is not None else 1.0 / math.sqrt(dk)
    pack = pool_pack(k_pool) if k_scale is not None else 1
    kc = unpack_codes(gather_pages(k_pool, page_table), pack)  # (R, S, KV, dk)
    vc = unpack_codes(gather_pages(v_pool, page_table), pack)
    qg = q.to(torch.float32).reshape(R, C, KV, G, dk)
    scores = torch.einsum("rckgd,rskd->rkgcs", qg, kc)
    if k_scale is not None:
        ksc = _line_scales(k_scale, page_table, ps) * scale   # (R, S, KV)
        scores = scores * ksc.permute(0, 2, 1)[:, :, None, None, :]
    else:
        scores = scores * scale
    m_ = mask.to(q.device)[:, None, None]                      # (R, 1, 1, C, S)
    scores = torch.where(m_, scores, NEG_INF)
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.where(m_, torch.exp(scores - m), 0.0)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-20)
    if v_scale is not None:
        vsc = _line_scales(v_scale, page_table, ps)
        p = p * vsc.permute(0, 2, 1)[:, :, None, None, :]
    out = torch.einsum("rkgcs,rskd->rkgcd", p, vc) / l
    return out.permute(0, 3, 1, 2, 4).reshape(R, C, H, dk).to(q.dtype)


#: the paged kernels' decode design (``paged_design`` in
#: csrc/paged_attention.cuh) takes at most this many query rows C * G a KV head
DECODE_ROWS = 8
#: lines a split of the decode design streams, longest first: the rule
#: takes the first whose grid reaches DECODE_SPLIT_BLOCKS blocks, else the
#: last (a split is at least one page). At 16 slots of LLaMA-7B decode on
#: an H100, 512-line splits ran faster than 256-line ones (int4 0.073 ->
#: 0.061 ms, bf16 at KV 8 0.085 -> 0.062, the rest within 3%;
#: scripts/decode_split_probe.py): a block's fixed round trips weigh less
DECODE_SPLIT_LINES = (512, 256, 128, 64)
#: blocks (of 4 warps) a grid should have: about one wave of an H100's
#: 132 SMs at 3-5 blocks each
DECODE_SPLIT_BLOCKS = 512
#: most splits a (slot, KV head): longer caches take longer splits
#: (``kSplitMaxSplits``: the merging block stages every split's (m, l))
DECODE_MAX_SPLITS = 64


def dense_head_groups(G: int) -> int:
    """Head groups a KV head's G query heads take in the dense decode
    kernel: one of G <= DECODE_ROWS heads, else groups of DECODE_ROWS (the
    last one shorter), each a block of the grid."""
    return -(-G // DECODE_ROWS)


def dense_decode_split(R: int, KV: int, S1: int, groups: int = 1) -> Tuple[int, int]:
    """(lines a split, splits a (slot, KV head, head group)) of the dense
    decode kernel (csrc/decode_attention.cu) for R slots, KV key/value
    heads of ``groups`` head groups (:func:`dense_head_groups`) and a
    cache of S1 lines: the ladder of :func:`paged_decode_split` without
    its pages, the first of DECODE_SPLIT_LINES whose grid reaches
    DECODE_SPLIT_BLOCKS blocks, at most DECODE_MAX_SPLITS splits. The
    splits cover lines [0, S1) once each, from the shapes alone (the host
    cannot see the slots' lengths without a sync); the kernel walks only
    the splits below a slot's seq_len."""
    for lines in DECODE_SPLIT_LINES:
        split = max(lines, -(-S1 // DECODE_MAX_SPLITS))
        n = -(-S1 // split)
        if R * KV * groups * n >= DECODE_SPLIT_BLOCKS:
            break
    return split, n


def paged_decode_split(R: int, C: int, KV: int, NP: int, ps: int) -> Tuple[int, int]:
    """(pages a split, splits a (slot, KV head)) of the paged kernels'
    decode design (csrc/paged_decode.cuh) for R slots of C query tokens,
    KV key/value heads and tables of NP pages of ps lines. A split is a
    run of consecutive whole pages, and the count depends on these shapes
    alone (the host cannot see the slots' lengths without a sync), and is
    at most DECODE_MAX_SPLITS. C > 1 (a chunk or a tree, whose new lines
    may span two splits' pages) takes one split. Both paged kernels take
    this rule, so they cut a (slot, KV head) alike and the fused kernel
    stays bitwise the unfused path."""
    if C > 1:
        return NP, 1
    for lines in DECODE_SPLIT_LINES:
        pages = max(1, lines // ps, -(-NP // DECODE_MAX_SPLITS))
        n = -(-NP // pages)
        if R * KV * n >= DECODE_SPLIT_BLOCKS:
            break
    return pages, n


#: the split decode walk's scratch by (device, stream): the partials'
#: workspace (f32) and the merge counters (int32, zero; each launch leaves
#: them 0 again), shared by the paged, dense and whole-step kernels.
#: Launches on one stream never overlap, so one stream's launches share
#: them; a larger launch replaces them.
_SPLIT_SCRATCH: Dict[Tuple[torch.device, int], Tuple[Optional[torch.Tensor], torch.Tensor]] = {}


def _split_scratch(device: torch.device, floats: int, units: int):
    """The stream's split workspace of at least ``floats`` f32 (none asked
    for at 0) and zeroed merge counters for ``units`` units."""
    key = (device, torch.cuda.current_stream(device).cuda_stream)
    ws, counters = _SPLIT_SCRATCH.get(key, (None, None))
    if floats and (ws is None or ws.numel() < floats):
        ws = torch.empty(floats, dtype=torch.float32, device=device)
    if counters is None or counters.numel() < units:
        counters = torch.zeros(units, dtype=torch.int32, device=device)
    _SPLIT_SCRATCH[key] = ws, counters
    return ws, counters


def _decode_workspace(q: torch.Tensor, KV: int, NP: int, ps: int):
    """The decode design's split pages and scratch for a launch with q
    (R, C, H, dk) on CUDA: (split_pages, partials, counters); the tensors
    are None with one split or at C * G > DECODE_ROWS (another design)."""
    R, C, H, dk = q.shape
    rows = C * (H // KV)
    if rows > DECODE_ROWS:
        return NP, None, None
    pages, n = paged_decode_split(R, C, KV, NP, ps)
    if n == 1:
        return pages, None, None
    ws, counters = _split_scratch(q.device, R * KV * n * rows * (dk + 2), R * KV)
    return pages, ws, counters


def ragged_paged_attention(q, k_pool, v_pool, page_table, mask, *,
                           scale: Optional[float] = None,
                           k_scale=None, v_scale=None):
    """Ragged paged attention: every one of the C query tokens per slot
    attends the lines its ``mask`` row allows, read through the slot's
    page table. q (R, C, H, dk); pools (P+1, ps, KV, dk/pack) in q's
    dtype, or int8/uint8 codes with ``k_scale``/``v_scale`` (P+1, KV)
    f32; page_table (R, NP) int32; mask (R, C, NP*ps) bool. Returns
    (R, C, H, dk). On the GPU a decode step (C * G <= DECODE_ROWS) runs
    split over pages (:func:`paged_decode_split`), its partials in a
    workspace kept for the stream, merged inside the one launch."""
    kind = _check_paged(q, k_pool, v_pool, page_table, mask, k_scale, v_scale)
    if q.device.type == "cpu":
        return ragged_paged_attention_ref(q, k_pool, v_pool, page_table, mask,
                                          scale=scale, k_scale=k_scale, v_scale=v_scale)
    _check_paged_cuda(q, k_pool, v_pool, page_table, mask, k_scale, v_scale)
    from . import _cuda

    R, C, H, dk = q.shape
    ps, KV = k_pool.shape[1], k_pool.shape[2]
    NP = page_table.shape[1]
    out = torch.empty_like(q)
    pages, ws, counters = _decode_workspace(q, KV, NP, ps)
    _cuda.launch(
        "ragged_paged_attention",
        [q, k_pool, v_pool, k_scale, v_scale, page_table, mask, out, ws, counters],
        [R, C, H, KV, dk, ps, NP, _dtype_code(q.dtype), kind, pages],
        [scale if scale is not None else 1.0 / math.sqrt(dk)],
    )
    _count_paged("ragged_paged_attention", q, k_pool)
    return out


# ---------------------------------------------------------------------------
# fused RoPE + KV write + ragged paged attention


def commit_paged(k_pool, v_pool, k, v, phys, off, k_scale=None, v_scale=None,
                 qmax: Optional[float] = None, *, kernels: str = "cuda"):
    """Write the new K/V lines (R, C, KV, dk) at physical page ``phys``,
    in-page offset ``off`` (each (R, C) int) in place: a scatter, or
    ``kv_quant.quant_line_write`` with ``qmax`` on a quantized pool. The
    unfused paged step's commit, which the fused kernel matches bit for
    bit.

    On a quantized pool with CUDA tensors and ``kernels="cuda"`` one
    launch of the commit kernel (``csrc/paged_commit.cu``) writes K and V,
    bitwise ``quant_line_write``'s result on every page but the scratch
    page (which several slots' padding lines write at once; only padding
    rows read it); it counts in ``LAUNCHES["paged_commit[int8|int4]"]``.
    CPU tensors and ``kernels="torch"`` run ``quant_line_write`` itself,
    the plain version, which is bitwise the JAX package's."""
    if kernels not in ("cuda", "torch"):
        raise ValueError(f"unknown kernels {kernels!r} (expected 'cuda' or 'torch')")
    if qmax is None:
        k_pool[phys, off] = k.to(k_pool.dtype)
        v_pool[phys, off] = v.to(v_pool.dtype)
    elif kernels == "torch" or k.device.type == "cpu":
        quant_line_write(k_pool, k_scale, phys, off, k, qmax)
        quant_line_write(v_pool, v_scale, phys, off, v, qmax)
    else:
        _commit_quant_cuda(k_pool, v_pool, k, v, phys, off, k_scale, v_scale, qmax)


#: most new lines per slot the commit kernel takes (5 shared words a line)
_COMMIT_MAX_LINES = 232448 // 20


def _commit_quant_cuda(k_pool, v_pool, k, v, phys, off, k_scale, v_scale, qmax):
    """The commit kernel's launch (see :func:`commit_paged`): checks, then
    one launch for K and V."""
    R, C, KV, dk = k.shape
    P1 = k_pool.shape[0]
    kind = {torch.int8: 1, torch.uint8: 2}.get(k_pool.dtype)
    if kind is None or v_pool.dtype != k_pool.dtype or v_pool.shape != k_pool.shape:
        raise ValueError("the commit kernel takes int8 or packed int4 pools of one shape")
    for name, t in (("k_scale", k_scale), ("v_scale", v_scale)):
        if t is None or t.shape != (P1, KV) or t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32 ({P1}, {KV})")
    if k_pool.shape[2] != KV or k_pool.shape[3] * pool_pack(k_pool) != dk:
        raise ValueError(f"pools {tuple(k_pool.shape)} do not hold lines {tuple(k.shape)}")
    if k.dtype not in _CUDA_DTYPES or dk not in _PAGED_HEAD_DIMS:
        raise ValueError(f"the commit kernel takes float32 or bfloat16 lines of head dim "
                         f"{_PAGED_HEAD_DIMS}; got {k.dtype}, {dk}")
    if C > _COMMIT_MAX_LINES:
        raise ValueError(f"the commit kernel takes at most {_COMMIT_MAX_LINES} lines a "
                         f"slot; got C={C}")
    if v.shape != k.shape or v.dtype != k.dtype:
        raise ValueError(f"v must be {k.dtype} {tuple(k.shape)}")
    if phys.shape != (R, C) or off.shape != (R, C):
        raise ValueError(f"phys and off must be ({R}, {C})")
    for name, t in (("k", k), ("v", v), ("k_pool", k_pool), ("v_pool", v_pool),
                    ("k_scale", k_scale), ("v_scale", v_scale), ("phys", phys),
                    ("off", off)):
        if t.device != k.device:
            raise ValueError(f"{name} must lie on {k.device}; got {t.device}")
    for name, t in (("k_pool", k_pool), ("v_pool", v_pool), ("k_scale", k_scale),
                    ("v_scale", v_scale)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, t in (("k_pool", k_pool), ("v_pool", v_pool)):
        if t.data_ptr() % 8:  # codes move 8 bytes at a time
            raise ValueError(f"{name} must be 8-byte aligned")
    from . import _cuda

    k, v = k.contiguous(), v.contiguous()
    for name, t in (("k", k), ("v", v)):
        if t.data_ptr() % 16:  # lines are read in 16-byte vectors
            raise ValueError(f"{name} must be 16-byte aligned")
    _cuda.launch("paged_commit",
                 [k, v, k_pool, v_pool, k_scale, v_scale,
                  phys.to(torch.int32).contiguous(), off.to(torch.int32).contiguous()],
                 [R, C, KV, dk, k_pool.shape[1], P1, _dtype_code(k.dtype), kind,
                  int(R * C >= P1)],
                 [qmax])
    LAUNCHES[f"paged_commit[{pool_type(k_pool)}]"] += 1


def fused_rope_paged_attention_ref(q, k_new, v_new, cos, sin, k_pool, v_pool,
                                   page_table, logical, off, mask, *,
                                   scale: Optional[float] = None,
                                   k_scale=None, v_scale=None,
                                   qmax: Optional[float] = None):
    """Plain version, the unfused composition itself: RoPE of q (R, C, H,
    dk) and k_new (R, C, KV, dk) with cos/sin (R, C, rot) f32 (None: no
    RoPE), then the commit of the new K/V lines at in-page offset
    ``off`` of page ``page_table[r, logical]`` — a scatter, or
    ``kv_quant.quant_line_write`` with ``qmax`` on a quantized pool —
    IN PLACE, then :func:`ragged_paged_attention_ref`. Returns the
    attention output (R, C, H, dk)."""
    if cos is not None:
        q = _rope_rotate(q, cos[:, :, None, :], sin[:, :, None, :])
        k_new = _rope_rotate(k_new, cos[:, :, None, :], sin[:, :, None, :])
    phys = page_table.long().gather(1, logical.long())
    commit_paged(k_pool, v_pool, k_new, v_new, phys, off.long(), k_scale, v_scale, qmax,
                 kernels="torch")
    return ragged_paged_attention_ref(q, k_pool, v_pool, page_table, mask,
                                      scale=scale, k_scale=k_scale, v_scale=v_scale)


def fused_rope_paged_attention(q, k_new, v_new, cos, sin, k_pool, v_pool,
                               page_table, logical, off, mask, *,
                               scale: Optional[float] = None,
                               k_scale=None, v_scale=None,
                               qmax: Optional[float] = None):
    """RoPE on q and k_new, the in-place commit of the new K/V lines into
    their pages (quantizing at the page scales when ``qmax`` is set) and
    ragged paged attention, in one kernel. q (R, C, H, dk) and k_new /
    v_new (R, C, KV, dk) before RoPE; cos/sin (R, C, rot) f32 or None;
    logical/off (R, C) int32 logical page and in-page offset of each new
    line; the rest as :func:`ragged_paged_attention`. The pools (and
    scales) are updated in place; returns the attention output
    (R, C, H, dk)."""
    kind = _check_paged(q, k_pool, v_pool, page_table, mask, k_scale, v_scale)
    R, C, H, dk = q.shape
    KV = k_pool.shape[2]
    for name, t in (("k_new", k_new), ("v_new", v_new)):
        if t.shape != (R, C, KV, dk) or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"{name} must be {q.dtype} ({R}, {C}, {KV}, {dk}) on "
                             f"q's device; got {t.dtype} {tuple(t.shape)}")
    if (cos is None) != (sin is None):
        raise ValueError("cos and sin come together or not at all")
    if cos is not None:
        rot = cos.shape[-1]
        for name, t in (("cos", cos), ("sin", sin)):
            if (t.shape != (R, C, rot) or t.dtype != torch.float32
                    or t.device != q.device):
                raise ValueError(f"{name} must be float32 ({R}, {C}, rot) on q's device")
        if rot % 2 or rot > dk:
            raise ValueError(f"rotary width {rot} must be even and at most {dk}")
    for name, t in (("logical", logical), ("off", off)):
        if t.shape != (R, C) or t.dtype != torch.int32 or t.device != q.device:
            raise ValueError(f"{name} must be int32 ({R}, {C}) on q's device")
    if (qmax is None) != (k_scale is None):
        raise ValueError("qmax is given exactly when the pools are quantized")
    if q.device.type == "cpu":
        return fused_rope_paged_attention_ref(
            q, k_new, v_new, cos, sin, k_pool, v_pool, page_table, logical, off,
            mask, scale=scale, k_scale=k_scale, v_scale=v_scale, qmax=qmax)
    _check_paged_cuda(q, k_pool, v_pool, page_table, mask, k_scale, v_scale)
    if C > _FUSED_MAX_CHUNK:
        raise ValueError(f"the fused kernel takes at most {_FUSED_MAX_CHUNK} "
                         f"lines per slot; got C={C}")
    for name, t in (("k_new", k_new), ("v_new", v_new), ("cos", cos), ("sin", sin),
                    ("logical", logical), ("off", off)):
        if t is not None and not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    from . import _cuda

    ps, NP = k_pool.shape[1], page_table.shape[1]
    out = torch.empty_like(q)
    pages, ws, counters = _decode_workspace(q, KV, NP, ps)
    # the rotated q goes through memory on mixed steps only (the decode
    # design rotates each block's own copy in shared memory)
    q_rot = torch.empty_like(q) if C * (H // KV) > DECODE_ROWS else None
    k_rot = torch.empty_like(k_new)
    _cuda.launch(
        "fused_rope_paged_attention",
        [q, k_new, v_new, cos, sin, k_pool, v_pool, k_scale, v_scale, page_table,
         logical, off, mask, out, q_rot, k_rot, ws, counters],
        [R, C, H, KV, dk, ps, NP, cos.shape[-1] if cos is not None else 0,
         _dtype_code(q.dtype), kind, pages],
        [scale if scale is not None else 1.0 / math.sqrt(dk),
         qmax if qmax is not None else 0.0],
    )
    _count_paged("fused_rope_paged_attention", q, k_pool)
    return out


# ---------------------------------------------------------------------------
# paged checks


def _check_paged(q, k_pool, v_pool, page_table, mask, k_scale, v_scale) -> int:
    """Shape, dtype and device checks of the paged kernels' common
    operands; returns the pool kind the CUDA launcher takes (0 full
    precision, 1 int8, 2 int4)."""
    if q.dim() != 4:
        raise ValueError(f"q must be (R, C, H, dk); got {tuple(q.shape)}")
    R, C, H, dk = q.shape
    if k_pool.dim() != 4 or k_pool.shape != v_pool.shape or k_pool.dtype != v_pool.dtype:
        raise ValueError(
            f"k/v pools must share one (P+1, ps, KV, dk/pack) shape and dtype; "
            f"got {k_pool.dtype} {tuple(k_pool.shape)} and {v_pool.dtype} "
            f"{tuple(v_pool.shape)}"
        )
    P1, ps, KV, dkp = k_pool.shape
    if H % KV:
        raise ValueError(f"H={H} is not a multiple of KV={KV}")
    if (k_scale is None) != (v_scale is None):
        raise ValueError("k_scale and v_scale come together or not at all")
    if k_scale is not None:
        pack = 2 if k_pool.dtype == torch.uint8 else 1
        if k_pool.dtype not in (torch.int8, torch.uint8) or dkp * pack != dk:
            raise ValueError(
                f"quantized pools hold int8 codes (dk={dk}) or uint8 nibble "
                f"pairs (dk/2={dk // 2}); got {k_pool.dtype} with {dkp}"
            )
        for name, t in (("k_scale", k_scale), ("v_scale", v_scale)):
            if t.shape != (P1, KV) or t.dtype != torch.float32:
                raise ValueError(f"{name} must be float32 ({P1}, {KV}); got "
                                 f"{t.dtype} {tuple(t.shape)}")
        kind = 1 if pack == 1 else 2
    else:
        if not k_pool.dtype.is_floating_point or dkp != dk:
            raise ValueError(f"full-precision pools must be floating (P+1, ps, KV, "
                             f"{dk}); got {k_pool.dtype} {tuple(k_pool.shape)}")
        kind = 0
    NP = page_table.shape[-1]
    if page_table.shape != (R, NP) or page_table.dtype != torch.int32:
        raise ValueError(f"page_table must be int32 ({R}, NP); got "
                         f"{page_table.dtype} {tuple(page_table.shape)}")
    if mask.shape != (R, C, NP * ps) or mask.dtype != torch.bool:
        raise ValueError(f"mask must be bool ({R}, {C}, {NP * ps}); got "
                         f"{mask.dtype} {tuple(mask.shape)}")
    for t in (k_pool, v_pool, page_table, mask, k_scale, v_scale):
        if t is not None and t.device != q.device:
            raise ValueError("q, the pools, scales, table and mask must lie on one device")
    return kind


def _check_paged_cuda(q, k_pool, v_pool, page_table, mask, k_scale, v_scale):
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    if q.dtype not in _CUDA_DTYPES:
        raise ValueError(f"CUDA paged attention takes float32 or bfloat16 q; got {q.dtype}")
    if k_scale is None and k_pool.dtype != q.dtype:
        raise ValueError(f"full-precision pools must be q's dtype {q.dtype}; got "
                         f"{k_pool.dtype}")
    dk = q.shape[-1]
    if dk not in _PAGED_HEAD_DIMS:
        raise ValueError(f"CUDA paged attention has no head dim {dk} (has {_PAGED_HEAD_DIMS})")
    if k_pool.shape[1] not in _CUDA_PAGE_SIZES:
        raise ValueError(f"CUDA paged attention has no page size {k_pool.shape[1]} "
                         f"(has {_CUDA_PAGE_SIZES})")
    for name, t in (("q", q), ("k_pool", k_pool), ("v_pool", v_pool),
                    ("page_table", page_table), ("mask", mask),
                    ("k_scale", k_scale), ("v_scale", v_scale)):
        if t is not None and not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, t in (("q", q), ("k_pool", k_pool), ("v_pool", v_pool), ("mask", mask)):
        if t.data_ptr() % 16:  # the kernels read them in 16-byte vectors
            raise ValueError(f"{name} must be 16-byte aligned")


# ---------------------------------------------------------------------------
# whole-step decode (ServingConfig.fused_decode=("whole_step",))
#
# The whole serving step of a model family (every layer, the final norm,
# the LM head and the greedy argmax) as one persistent cooperative CUDA
# kernel (csrc/whole_step_decode.cu), the port of the JAX package's
# whole_step_decode and _whole_step_decode_tiled. On the TPU the tile
# count decides how much of a layer's weights one grid step keeps in
# VMEM; here it sets the output-column tile of one block's projection work
# item, and the engine's gate prices that item in shared memory and
# registers (:func:`whole_step_smem_bytes`). Only output columns are
# split and every output element's contraction runs in one order, so the
# kernel's logits, tokens and pool bytes are bitwise equal at every tile
# count it takes.

#: bytes one block of the whole-step kernel may hold on chip: the shared
#: memory a block may opt into on an H100 (227 KB)
WHOLE_STEP_SMEM_BUDGET = 227 * 1024

# geometry of csrc/whole_step_decode.cu
_WS_BK = 32              # K depth of a staged weight chunk
_WS_WARPS = 8            # warps of a block (256 threads)
_WS_MAX_FRAGS = 24       # 16 x 8 f32 accumulator fragments a warp holds
_WS_HEAD_COLS = 256      # most LM-head columns per work item
#: static shared memory of the kernel (attention, commit and reductions;
#: under 10 KB at head dim 128), priced on top of the dynamic part
_WS_STATIC_SMEM = 12 * 1024


def _ws_per_warp(width: int) -> int:
    """Accumulator fragments of 16 rows × 8 columns per warp for a
    column tile of ``width``."""
    return -(-(width // 8) // _WS_WARPS)


def _ws_row_tile(rows: int, width: int) -> int:
    """The kernel's row tile (csrc row_frags): 16 rows for a step of at
    most 16, else the most of 64, 32, 16 whose accumulators for a column
    tile of ``width`` fit a warp."""
    if rows <= 16:
        return 16
    for frags in (4, 2, 1):
        if _ws_per_warp(width) <= _WS_MAX_FRAGS // frags:
            return 16 * frags
    return 16


def _ws_k_slices(rows: int) -> int:
    """Contraction slices of every projection: enough work items to fill
    the card when a step has few rows. Depends on the rows alone, never on
    the tile count."""
    return max(1, 8 // -(-rows // 16))


#: the wgmma projections of bf16 steps of more than _WS_TC_MIN_ROWS rows
#: (csrc tc_path): a ring of 4 stages, each 128 rows x 64 K of the
#: activations and four 64 x 64 weight boxes, 1024 bytes of alignment
_WS_TC_MIN_ROWS = 64
_WS_TC_SMEM = 4 * (128 * 64 * 2 + 4 * 64 * 64 * 2) + 1024


def _ws_tc(rows: int, isz: int, *dims: int) -> bool:
    """Whether the kernel's layer projections run on wgmma (csrc
    tc_path): bf16, more than _WS_TC_MIN_ROWS rows, every contraction
    dim (D, H * dk, F) a multiple of 64."""
    return isz == 2 and rows > _WS_TC_MIN_ROWS and all(d % 64 == 0 for d in dims)


def _ws_item_bytes(rows: int, width: int, isz: int) -> int:
    """A projection work item's double-buffered weight (32 × width) and
    activation (rows × 32) chunks, padded as the kernel pads them, plus
    its f32 accumulators (rows × width, in registers)."""
    bm, pad = _ws_row_tile(rows, width), 16 // isz
    return 2 * (bm * (_WS_BK + pad) + _WS_BK * (width + pad)) * isz + 4 * bm * width


#: the tensor-core attention tile's budget for its dynamic shared bytes
#: (csrc/paged_attention.cuh kMmaSmemBudget)
MMA_SMEM_BUDGET = 232448 - 8192


def mma_smem_bytes(f32: bool, kind: int, dk: int) -> int:
    """Dynamic shared bytes of the tensor-core paged tile, as
    ``MmaSmem<TQ, KIND, DK>::kBytes`` in ``csrc/paged_attention.cuh`` lays
    them out (q bf16, or f32 with ``f32``; pool ``kind`` 0 q's type, 1
    int8, 2 int4): K/V tiles of 64 lines in q's type with rows of dk + 8
    (bf16) or dk + 4 (f32), up to three stages of them, or one that
    quantized codes widen into beside up to three stages of raw codes; the
    block's 128 Q rows in q's type for f32 q and for bf16 q above dk 128,
    where two stages (and 16 tiles) fit beside them (f32 q at dk 256 reads
    its rows in place); then the mask bits, page ids, scales and flags of
    32 tiles. As many stages (3, 2, 1) as fit MMA_SMEM_BUDGET with 16
    tiles, then 32 tiles where they fit, else 16. The whole-step kernel's
    gate and ``chip_smoke.py``'s build line read this one mirror."""
    isz, ld = (4, dk + 4) if f32 else (2, dk + 8)
    pair = 2 * 64 * ld * isz
    raw = 2 * 64 * (dk // kind) if kind else 0  # int8: a byte a value, int4: two
    q_rows = 128 * ld * isz

    def meta(n):  # bits [tile][128 rows], page ids and two scales, flags
        return 8 * n * 128 + 12 * n * 4 + n * 4

    def fits(q, stages, n):
        return q + (pair + stages * raw if kind else stages * pair) + meta(n) <= MMA_SMEM_BUDGET

    q = q_rows if (f32 or dk > 128) and fits(q_rows, 2, 16) else 0
    stages = next(n for n in (3, 2, 1) if n == 1 or fits(q, n, 16))
    fixed = q + (pair + stages * raw if kind else stages * pair)
    return fixed + meta(32 if fits(q, stages, 32) else 16)


def whole_step_split_smem_bytes(f32: bool, dk: int, R: int) -> int:
    """Dynamic shared bytes of the whole-step kernel's split decode walk
    (``SplitLayout`` in csrc/whole_step_decode.cu): the walk's scratch
    (``SplitSmem`` for one row and 8 warps: the staged mask words, page
    ids and scales of a chunk, 480 bytes; each warp's split mask, 64; (m,
    l) and the accumulator of a warp's row; the merge's (m, l) of 64
    splits, 512; the merge flag; 8-byte aligned), rounded up to 16 bytes;
    the item's query row in the model dtype (f32 with ``f32``); the R live
    slots' indices. The gate prices it at decode, in place of the
    tensor-core tile; ``chip_smoke.py``'s build line checks it against the
    library."""
    scratch = -(-(480 + 64 + 2 * 8 * 4 + 8 * dk * 4 + 64 * 2 * 4 + 4) // 8) * 8
    return -(-scratch // 16) * 16 + dk * (4 if f32 else 2) + 4 * R


def _pool_kind(pool: torch.Tensor) -> int:
    """The CUDA launchers' pool kind: 0 q's type, 1 int8, 2 int4."""
    return {torch.int8: 1, torch.uint8: 2}.get(pool.dtype, 0)


def _ws_tile_width(n: int, tiles: int) -> int:
    """The kernel's column tile of a role of ``n`` output columns at
    ``tiles`` (csrc role_width): n / tiles rounded up to whole 8-wide MMA
    columns, so a role narrower than the tiling (Falcon's 64-wide K/V at
    16 tiles) takes 8-column tiles. Tiles only group output columns: the
    rounding changes no output bit."""
    return -(-(n // tiles) // 8) * 8


def _ws_widths(layer_arrays, tile_roles, tiles: int):
    return [_ws_tile_width(int(layer_arrays[w].shape[-1]), tiles)
            for (w, _b) in tile_roles.values()]


def whole_step_smem_bytes(layer_arrays, cache, x0, num_heads: int, *,
                          tiles: int, tile_roles, all_logits: bool = False) -> int:
    """On-chip bytes one block of the whole-step kernel holds for one
    projection work item — one row tile (16 rows, or up to 64 for a step
    of more than 16 rows) by one output-column tile of the widest tiled
    weight: the double-buffered weight chunk (32 × width) and activation
    chunk (rows × 32), padded as the kernel pads them, plus the f32
    accumulators (rows × width, in registers); for a bf16 step of more
    than 64 rows, whose projections run on wgmma in 128 × 256 items
    whatever the tile count, the TMA ring's shared memory (_WS_TC_SMEM,
    the accumulators in registers unpriced); or, when larger, an LM-head
    item (R rows, or R · C with ``all_logits``, × at most 256 columns) or
    the attention stage's: the
    tensor-core tile (:func:`mma_smem_bytes`, a KV head with more than 8
    query rows), else the split decode walk
    (:func:`whole_step_split_smem_bytes`); plus the kernel's static shared
    memory. ``x0`` (R, C, D) gives the step shape and the model dtype (a
    "meta" tensor will do)."""
    R, C, D = x0.shape
    isz = x0.element_size()
    wmax = max(_ws_widths(layer_arrays, tile_roles, tiles))
    Q = int(layer_arrays[tile_roles["q"][0]].shape[-1])
    F = int(layer_arrays[tile_roles["up"][0]].shape[-1])
    layer = (_WS_TC_SMEM if _ws_tc(R * C, isz, D, Q, F)
             else _ws_item_bytes(R * C, wmax, isz))
    head_rows = R * C if all_logits else R
    item = max(layer, _ws_item_bytes(head_rows, min(_WS_HEAD_COLS, wmax), isz))
    dk = Q // num_heads
    kv = int(cache["k"].shape[3])
    rows = C * (num_heads // kv)
    attn = (mma_smem_bytes(isz == 4, _pool_kind(cache["k"]), dk) if rows > DECODE_ROWS
            else whole_step_split_smem_bytes(isz == 4, dk, R))
    return _WS_STATIC_SMEM + max(item, attn)


def whole_step_tile_candidates(layer_arrays, tile_roles):
    """Legal sub-block tile counts for this weight layout, ascending: the
    divisors of the gcd of the tiled weights' output (last) dims, so that
    each role splits into equal column tiles."""
    g = 0
    for wname, _b in tile_roles.values():
        g = math.gcd(g, int(layer_arrays[wname].shape[-1]))
    return tuple(t for t in range(1, g + 1) if g % t == 0)


def whole_step_kernel_takes(layer_arrays, *, tiles: int, tile_roles) -> bool:
    """Whether the CUDA kernel takes this tile count: the widest column
    tile (:func:`_ws_tile_width`: whole 8-wide MMA columns) keeps its
    accumulators for 16 rows within a warp's share (24 fragments of
    16 × 8)."""
    return _ws_per_warp(max(_ws_widths(layer_arrays, tile_roles, tiles))) <= _WS_MAX_FRAGS


def whole_step_pick_tiles(layer_arrays, cache, x0, num_heads: int, *,
                          tile_roles, budget: int, all_logits: bool = False):
    """The SMALLEST candidate tile count the kernel takes whose priced
    block footprint (:func:`whole_step_smem_bytes`, the all-rows head with
    ``all_logits``) fits ``budget``.
    Returns ``(tiles, est_bytes)``, or ``(None, best_est)`` when no legal
    tiling fits (the attention and static floor alone exceed the budget):
    the one condition under which the engine falls back to the per-layer
    path."""
    best = None
    for t in whole_step_tile_candidates(layer_arrays, tile_roles):
        if not whole_step_kernel_takes(layer_arrays, tiles=t, tile_roles=tile_roles):
            continue
        est = whole_step_smem_bytes(layer_arrays, cache, x0, num_heads,
                                    tiles=t, tile_roles=tile_roles, all_logits=all_logits)
        if best is None or est < best:
            best = est
        if est <= budget:
            return t, est
    return None, int(best or 0)


def whole_step_decode_ref(layer_arrays, head_arrays, x0, cos, sin, cache, page_table,
                          phys, off, mask, logits_idx, *, block_fn, head_fn):
    """Plain version of the untiled walk: ``block_fn(p_l, x, cos, sin,
    mask, k_pool, v_pool, k_scale, v_scale, phys, off, page_table) -> x``
    runs layer l on its weights ``p_l`` and its pool views (updated in
    place), then ``head_fn(head_arrays, x, logits_idx)`` gives the (R, V)
    f32 logits, or (R, C, V) from an all-positions head. The walk runs the
    layers the stacks hold (a sliced stack is the early-exit draft).
    Returns ``(logits, greedy tokens (R,) or (R, C) int32, cache)``."""
    quant = "k_scale" in cache
    x = x0
    for l in range(cache["k"].shape[0]):
        p_l = {name: a[l] for name, a in layer_arrays.items()}
        ks, vs = (cache["k_scale"][l], cache["v_scale"][l]) if quant else (None, None)
        x = block_fn(p_l, x, cos, sin, mask, cache["k"][l], cache["v"][l], ks, vs,
                     phys, off, page_table)
    logits = head_fn(head_arrays, x, logits_idx)
    return logits, torch.argmax(logits, dim=-1).to(torch.int32), cache


#: the body kinds the kernel computes, by their code in csrc WholeArgs
#: (norm_kind, act), and the projection roles it streams ("gate" only in
#: a GLU FFN)
_WS_NORMS = ("rms", "rms_plus_one", "layernorm")
_WS_ACTS = ("silu", "gelu", "gelu_tanh", "relu")
_WS_ROLE_NAMES = ("q", "k", "v", "o", "gate", "up", "down")


@dataclasses.dataclass(frozen=True)
class WholeBody:
    """The layer body the whole-step kernel computes, beside the tile
    roles' weights and biases (``tile_roles``: role → (weight, bias or
    None) of ``layer_arrays``; an FFN with a "gate" role is a GLU, the
    activation of the gate times the up projection):

    * ``norm``: "rms" (``x·r`` rounded, times the scale), "rms_plus_one"
      (Gemma: ``(x·r)·(1 + w)`` in f32, rounded once) or "layernorm"
      (``(x − μ)·r`` rounded, times the scale, plus the bias), at ``eps``;
    * ``attn_norm`` / ``mlp_norm``: the (scale, bias or None) layer
      tensors of the block's input norm and of its second norm;
      ``mlp_norm`` None in a parallel block whose FFN reads the input norm
      (Falcon-7B, Phi);
    * ``final_norm``: the (scale, bias or None) head tensors;
    * ``activation``: "silu", "gelu" (erf), "gelu_tanh" or "relu";
    * ``parallel``: x + attn + ffn (the FFN reads the input norm, or
      ``mlp_norm`` of x), else sequential (the FFN reads ``mlp_norm`` of
      x + attn).

    Positions are the wrapper's ``cos``/``sin``: None for none (learned
    positions live in the embedding), else the tables of the rotary
    width, which may be narrower than the head (Phi's partial rotary)."""
    norm: str
    eps: float
    attn_norm: Tuple[str, Optional[str]]
    mlp_norm: Optional[Tuple[str, Optional[str]]]
    final_norm: Tuple[str, Optional[str]]
    activation: str = "silu"
    parallel: bool = False


def whole_step_check_layout(layer_arrays, head_arrays, *, tile_roles, body: WholeBody,
                            head_dim: int):
    """Raise ValueError for a layout the whole-step CUDA kernel does not
    compute: a body kind it lacks, a role or layer tensor it does not
    read, a shape or dtype out of line, a head dim outside
    ``_WHOLE_HEAD_DIMS``, or D, H · dk or F not a multiple of ``_WS_BK``.
    Returns ``(L, D, H, KV, F, V)``. Takes "meta" tensors: the engine
    calls it at construction, so a refused layout never reaches a step."""
    if body.norm not in _WS_NORMS or body.activation not in _WS_ACTS:
        raise ValueError(f"the whole-step kernel has the norms {_WS_NORMS} and the activations "
                         f"{_WS_ACTS}; got {body.norm!r} and {body.activation!r}")
    if body.mlp_norm is None and not body.parallel:
        raise ValueError("a sequential block needs its second norm (WholeBody.mlp_norm)")
    norms = [n for n in (body.attn_norm, body.mlp_norm, body.final_norm) if n is not None]
    if body.norm != "layernorm" and any(b is not None for _, b in norms):
        raise ValueError("only a LayerNorm takes a bias in the whole-step kernel")
    roles = dict(tile_roles)
    if not set(_WS_ROLE_NAMES) - {"gate"} <= set(roles) <= set(_WS_ROLE_NAMES):
        raise ValueError(f"the whole-step kernel takes the roles {_WS_ROLE_NAMES} ('gate' in "
                         f"a GLU FFN alone); got {sorted(roles)}")
    wq = layer_arrays[roles["q"][0]]
    dt = wq.dtype
    if dt not in _CUDA_DTYPES:
        raise ValueError(f"the whole-step kernel takes float32 or bfloat16; got {dt}")
    L, D, Q = wq.shape
    KVd = int(layer_arrays[roles["k"][0]].shape[-1])
    F = int(layer_arrays[roles["up"][0]].shape[-1])
    outs = {"q": (D, Q), "k": (D, KVd), "v": (D, KVd), "o": (Q, D), "gate": (D, F),
            "up": (D, F), "down": (F, D)}
    shapes = {}
    for role, (w, b) in roles.items():
        shapes[w] = (L, *outs[role])
        if b is not None:
            shapes[b] = (L, outs[role][1])
    for scale, bias in norms[:-1]:
        shapes.update({n: (L, D) for n in (scale, bias) if n is not None})
    tied = "lm_head" not in head_arrays
    head = head_arrays["embed"] if tied else head_arrays["lm_head"]
    V = int(head.shape[0] if tied else head.shape[-1])
    head_shapes = {("embed" if tied else "lm_head"): (V, D) if tied else (D, V)}
    head_shapes.update({n: (D,) for n in body.final_norm if n is not None})
    if "lm_head_bias" in head_arrays:
        head_shapes["lm_head_bias"] = (V,)
    for arrays, want, what in ((layer_arrays, shapes, "layer"), (head_arrays, head_shapes, "head")):
        if set(arrays) != set(want):
            raise ValueError(f"the whole-step kernel reads the {what} tensors {sorted(want)}; "
                             f"got {sorted(arrays)}")
        for name, shape in want.items():
            t = arrays[name]
            if tuple(t.shape) != shape or t.dtype != dt:
                raise ValueError(f"{name} must be {dt} {shape}; got {t.dtype} {tuple(t.shape)}")
    dk = head_dim
    if dk not in _WHOLE_HEAD_DIMS or Q % dk or KVd % dk or (Q // dk) % (KVd // dk):
        raise ValueError(f"the whole-step kernel has no head dim {dk} with H*dk={Q}, "
                         f"KV*dk={KVd} (head dims {_WHOLE_HEAD_DIMS})")
    if D % _WS_BK or Q % _WS_BK or F % _WS_BK:
        raise ValueError(f"the whole-step kernel needs D ({D}), H*dk ({Q}) and F ({F}) "
                         f"multiples of {_WS_BK}")
    return L, D, Q // dk, KVd // dk, F, V


#: the stages of one layer of the whole-step kernel, each ended by a grid
#: barrier, then the step's tail (csrc/whole_step_decode.cu stamp()): with
#: ``all_logits`` the tail's stages cover every row of the step (the final
#: norm of R · C rows, the LM head over them, their argmax)
WHOLE_STEP_STAGES = ("norm", "qkv", "attention", "out_proj", "norm2", "w1w3", "act", "w2")
WHOLE_STEP_TAIL = ("final_norm", "head", "argmax")


def whole_step_stamp_count(num_layers: int) -> int:
    """Entries of the ``stamps`` buffer of :func:`whole_step_decode`: the
    kernel's entry, the end of every stage of every layer, and the tail."""
    return 1 + len(WHOLE_STEP_STAGES) * num_layers + len(WHOLE_STEP_TAIL)


def whole_step_stage_ms(stamps, num_layers: int) -> Dict[str, float]:
    """Milliseconds by stage of one whole-step launch from its ``stamps``
    (global-timer nanoseconds, :func:`whole_step_stamp_count` of them):
    each layer stage summed over the layers ("attention" includes the
    RoPE and the K/V commit), then the tail stages."""
    t = [int(x) for x in stamps]
    if len(t) != whole_step_stamp_count(num_layers):
        raise ValueError(f"{len(t)} stamps for {num_layers} layers; want "
                         f"{whole_step_stamp_count(num_layers)}")
    if any(b < a for a, b in zip(t, t[1:])):
        raise ValueError("the stamps do not rise")
    n = len(WHOLE_STEP_STAGES)
    out = {name: sum(t[1 + n * l + i] - t[n * l + i] for l in range(num_layers)) / 1e6
           for i, name in enumerate(WHOLE_STEP_STAGES)}
    base = n * num_layers
    for i, name in enumerate(WHOLE_STEP_TAIL):
        out[name] = (t[base + i + 1] - t[base + i]) / 1e6
    return out


def whole_step_decode(layer_arrays, head_arrays, x0, cos, sin, cache, page_table, phys,
                      off, mask, logits_idx, *, block_fn, head_fn, tile_roles,
                      body: WholeBody, qmax=None, tiles: int = 1,
                      stamps: Optional[torch.Tensor] = None, all_logits: bool = False):
    """The whole serving step of every layer in one kernel. ``layer_arrays``
    are the stacked (L, …) layer weights, ``head_arrays`` the final norm
    and the LM head (``lm_head`` (D, V), or ``embed`` (V, D) when tied,
    and an optional ``lm_head_bias``); x0 (R, C, D) the embedded step
    input; cos/sin (R, C, rot) f32 (rot ≤ dk the rotary width), or None
    for no RoPE; ``cache`` the paged pools (L, P+1, ps, KV, dk/pack) [+
    (L, P+1, KV) scales], updated in place; page_table (R, NP); phys/off
    (R, C) the page and in-page offset of each new line; mask (R, C,
    NP*ps) bool; logits_idx (R,) the row whose logits each slot returns.
    ``tile_roles`` and ``body`` (:class:`WholeBody`) say what the layers
    compute. ``tiles`` must be one of :func:`whole_step_tile_candidates`
    for ``tile_roles``. ``stamps``, an int64 tensor of
    :func:`whole_step_stamp_count` entries on x0's device, asks the kernel
    for its per-stage timer (:func:`whole_step_stage_ms`); only the
    kernel writes it, the plain version leaves it as it is.
    ``all_logits`` (the speculation fold's head; ``head_fn`` is then the
    all-positions head) gives the logits and the argmax of every row.
    The layer count is the stacks' leading dim, the pools' too: a
    leading-dim slice of both is the early-exit draft.
    Returns ``(logits (R, V) f32, greedy tokens (R,) int32, cache)``, with
    ``all_logits`` ``(R, C, V)`` and ``(R, C)``.

    On CPU tensors it runs the plain version, the walk through
    ``block_fn``/``head_fn`` (:func:`whole_step_decode_ref`): the tile
    count only groups output columns, so it gives the same answer at
    every count. On CUDA tensors it launches csrc/whole_step_decode.cu,
    which computes the block ``tile_roles`` and ``body`` describe, pools
    quantized at ``qmax``, or raises on a layout, shape, dtype, head dim
    or tile count it does not take. Each launch adds one to
    ``LAUNCHES["whole_step_decode[<pool>]"]`` and to
    ``DESIGN_LAUNCHES["whole_step_decode[<design>]"]``, the design of its
    attention stage (``[<design>-tree]`` with ``all_logits``)."""
    candidates = whole_step_tile_candidates(layer_arrays, tile_roles)
    if tiles not in candidates:
        raise ValueError(f"whole_step tiles={tiles} is not a legal tile count "
                         f"{candidates} (see whole_step_tile_candidates)")
    if x0.device.type == "cpu":
        return whole_step_decode_ref(layer_arrays, head_arrays, x0, cos, sin, cache,
                                     page_table, phys, off, mask, logits_idx,
                                     block_fn=block_fn, head_fn=head_fn)
    return _whole_step_decode_cuda(layer_arrays, head_arrays, x0, cos, sin, cache,
                                   page_table, phys, off, mask, logits_idx, tiles,
                                   tile_roles, body, qmax, stamps, all_logits)


def _whole_step_decode_cuda(layer_arrays, head_arrays, x0, cos, sin, cache, page_table,
                            phys, off, mask, logits_idx, tiles, tile_roles, body, qmax,
                            stamps=None, all_logits=False):
    if x0.device.type != "cuda":
        raise ValueError(f"no kernel for device {x0.device}")
    k_pool, v_pool = cache["k"], cache["v"]
    if k_pool.dim() != 5 or k_pool.shape != v_pool.shape:
        raise ValueError(f"pools must be (L, P+1, ps, KV, dk/pack); got "
                         f"{tuple(k_pool.shape)} and {tuple(v_pool.shape)}")
    _, P1, ps, KV, dkp = k_pool.shape
    dk = int(layer_arrays[tile_roles["k"][0]].shape[-1]) // KV
    L, D, H, _, Fd, V = whole_step_check_layout(layer_arrays, head_arrays,
                                                tile_roles=tile_roles, body=body, head_dim=dk)
    dt = x0.dtype
    R, C, _ = x0.shape
    if tuple(x0.shape) != (R, C, D) or layer_arrays[tile_roles["q"][0]].dtype != dt:
        raise ValueError(f"x0 must be {layer_arrays[tile_roles['q'][0]].dtype} (R, C, {D})")
    if k_pool.shape[0] != L:
        raise ValueError(f"the pools hold {k_pool.shape[0]} layers, the stacks {L}")
    Q, KVd = H * dk, KV * dk
    if ps not in _CUDA_PAGE_SIZES:
        raise ValueError(f"the whole-step kernel has no page size {ps} "
                         f"(has {_CUDA_PAGE_SIZES})")
    if C > _FUSED_MAX_CHUNK:
        raise ValueError(f"the whole-step kernel commits at most {_FUSED_MAX_CHUNK} lines "
                         f"per slot; got C={C}")
    if not whole_step_kernel_takes(layer_arrays, tiles=tiles, tile_roles=tile_roles):
        raise ValueError(f"the whole-step kernel does not take tiles={tiles} at these "
                         "widths (see whole_step_kernel_takes)")
    quant = "k_scale" in cache
    if quant != (qmax is not None):
        raise ValueError("qmax is given exactly when the pools are quantized")
    if quant:
        pack = 2 if k_pool.dtype == torch.uint8 else 1
        if k_pool.dtype not in (torch.int8, torch.uint8) or dkp * pack != dk:
            raise ValueError(f"quantized pools hold int8 codes or uint8 nibble pairs of "
                             f"head dim {dk}; got {k_pool.dtype} with {dkp}")
        for name in ("k_scale", "v_scale"):
            t = cache[name]
            if tuple(t.shape) != (L, P1, KV) or t.dtype != torch.float32:
                raise ValueError(f"{name} must be float32 ({L}, {P1}, {KV})")
        kind = 1 if pack == 1 else 2
    else:
        if k_pool.dtype != dt or dkp != dk:
            raise ValueError(f"full-precision pools must be {dt} with head dim {dk}; got "
                             f"{k_pool.dtype} {tuple(k_pool.shape)}")
        kind = 0
    NP = page_table.shape[-1]
    if tuple(page_table.shape) != (R, NP) or page_table.dtype != torch.int32:
        raise ValueError(f"page_table must be int32 ({R}, NP)")
    if tuple(mask.shape) != (R, C, NP * ps) or mask.dtype != torch.bool:
        raise ValueError(f"mask must be bool ({R}, {C}, {NP * ps})")
    if (cos is None) != (sin is None):
        raise ValueError("cos and sin are both given (RoPE) or both None")
    rot = 0 if cos is None else int(cos.shape[-1])
    for name, t in (("cos", cos), ("sin", sin)):
        if t is not None and (tuple(t.shape) != (R, C, rot) or t.dtype != torch.float32
                              or rot % 2 or not 0 < rot <= dk):
            raise ValueError(f"{name} must be float32 ({R}, {C}, rot), rot even and at most "
                             f"{dk}; got {t.dtype} {tuple(t.shape)}")
    phys, off = phys.to(torch.int32).contiguous(), off.to(torch.int32).contiguous()
    logits_idx = logits_idx.to(torch.int32).contiguous()
    if tuple(phys.shape) != (R, C) or tuple(off.shape) != (R, C) or logits_idx.shape != (R,):
        raise ValueError(f"phys/off must be ({R}, {C}) and logits_idx ({R},)")

    def layer(role_or_pair, i):
        name = (tile_roles.get(role_or_pair, (None, None)) if isinstance(role_or_pair, str)
                else role_or_pair or (None, None))[i]
        return None if name is None else layer_arrays[name]

    tied = "lm_head" not in head_arrays
    weights = [layer(body.attn_norm, 0), layer(body.attn_norm, 1),
               layer("q", 0), layer("k", 0), layer("v", 0),
               layer("q", 1), layer("k", 1), layer("v", 1), layer("o", 0), layer("o", 1),
               layer(body.mlp_norm, 0), layer(body.mlp_norm, 1),
               layer("gate", 0), layer("gate", 1), layer("up", 0), layer("up", 1),
               layer("down", 0), layer("down", 1),
               head_arrays[body.final_norm[0]],
               None if body.final_norm[1] is None else head_arrays[body.final_norm[1]],
               head_arrays["embed" if tied else "lm_head"], head_arrays.get("lm_head_bias")]
    step = [x0, cos, sin, k_pool, v_pool, cache.get("k_scale"), cache.get("v_scale"),
            page_table, phys, off, mask, logits_idx]
    for t in weights + step:
        if t is None:
            continue
        if t.device != x0.device:
            raise ValueError("every operand of the whole-step kernel must lie on x0's device")
        if not t.is_contiguous():
            raise ValueError("every operand of the whole-step kernel must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError("every operand of the whole-step kernel must be 16-byte aligned")
    if stamps is not None and (stamps.dtype != torch.int64 or stamps.device != x0.device
                               or tuple(stamps.shape) != (whole_step_stamp_count(L),)
                               or not stamps.is_contiguous()):
        raise ValueError(f"stamps must be contiguous int64 ({whole_step_stamp_count(L)},) "
                         "on x0's device")
    from . import _cuda

    M = R * C
    KS = _ws_k_slices(M)
    # the decode design's split walk (C * G <= DECODE_ROWS), a query row an
    # item: the paged kernels' split rule, its partials in ``work`` after
    # the Q/K/V sums are read, the stream's merge counters, one a (slot,
    # KV head, row)
    rows = C * (H // KV)
    split_pages, nsplit = (paged_decode_split(R, C, KV, NP, ps) if rows <= DECODE_ROWS
                           else (NP, 1))
    counters = _split_scratch(x0.device, 0, R * KV * rows)[1] if nsplit > 1 else None
    # the head's rows: one a slot at its logits_idx, or every row (the fold)
    head_rows = M if all_logits else R
    logits = torch.empty((head_rows, V), dtype=torch.float32, device=x0.device)
    tokens = torch.empty((head_rows,), dtype=torch.int32, device=x0.device)
    scratch = torch.empty((M * (4 * D + 3 * Q + 3 * KVd + Fd) + head_rows * D,), dtype=dt,
                          device=x0.device)
    glu = "gate" in tile_roles
    work = torch.empty((max(KS * M * max(Q + 2 * KVd, D, (2 if glu else 1) * Fd),
                            R * KV * nsplit * rows * (dk + 2) if nsplit > 1 else 0),),
                       dtype=torch.float32, device=x0.device)
    parallel = 0 if not body.parallel else 1 if body.mlp_norm is None else 2
    _cuda.launch(
        "whole_step_decode",
        weights + step + [logits, tokens, scratch, work, stamps, counters],
        [L, R, C, D, H, KV, dk, Fd, V, ps, NP, P1, tiles, KS, int(tied), _dtype_code(dt),
         kind, split_pages, int(all_logits), _WS_NORMS.index(body.norm),
         _WS_ACTS.index(body.activation), int(glu), parallel, rot],
        [body.eps, 1.0 / math.sqrt(dk), qmax if qmax is not None else 0.0],
    )
    LAUNCHES[f"whole_step_decode[{pool_type(k_pool)}]"] += 1
    design = _cuda.design("whole_step_decode", C, H, KV, _dtype_code(dt))
    DESIGN_LAUNCHES[f"whole_step_decode[{design}{'-tree' if all_logits else ''}]"] += 1
    if all_logits:
        return logits.view(R, C, V), tokens.view(R, C), cache
    return logits, tokens, cache


# ---------------------------------------------------------------------------
# weight-only quantized matmul (quantization.py): y = x @ dequantize(q, scale)

#: most rows of x the decode designs take ("splitk" for bf16 x, "rows" for
#: f32); wider products run "wgmma" (bf16 x) or "f32" (f32 x)
WQ_ROWS_MAX = 16
#: the kernel's K and N granules (csrc/wq_matmul.cu): a K slice's and a
#: scale group's rows, a thread's 16 code columns
WQ_K_MULTIPLE = 32
WQ_N_MULTIPLE = 16
#: the launcher's design codes (wq_matmul_design; _cuda.DESIGNS order)
WQ_DESIGN_CODES = {d: i for i, d in enumerate(DESIGNS["wq_matmul"][0])}
#: "splitk": a block's column strip, the ring's code rows a stage, the
#: most blocks of a cluster (one K split), the ring depth; blocks an SM
#: the split count aims for (the best of 1-8 splits on an H100 at the
#: families' decode shapes, scripts/wq_probe.py --sweep), and the fewest K
#: rows a slice keeps
WQ_SPLITK_COLS = 128
WQ_SPLITK_BOX_ROWS = 128
WQ_SPLITK_CLUSTER_MAX = 8
WQ_SPLITK_STAGES = 2
WQ_SPLITK_BLOCKS_PER_SM = 1.5
WQ_SPLITK_MIN_SLICE = 256
#: "wgmma": a step's K rows and the ring depth
WQ_WGMMA_BK = 64
WQ_WGMMA_STAGES = 4
#: "rows"/"f32": the column strip, the most K rows of a split (x's f32
#: slice in shared memory), the fewest, and the blocks an SM aimed for
WQ_ROWS_STRIP = 32
WQ_ROWS_SPLIT_MAX = 1024
WQ_ROWS_SPLIT_MIN = 256
WQ_ROWS_BLOCKS_PER_SM = 4


@dataclasses.dataclass(frozen=True)
class WqPlan:
    """How one ``wq_matmul`` launch runs (:func:`wq_plan`).

    ``design``: "splitk", "wgmma", "rows" or "f32". K is cut into
    ``splits`` slices of ``k_slice`` rows (the last may be shorter): for
    "splitk" the blocks of one thread block cluster, reduced inside it; for
    "rows"/"f32" the blocks of one launch whose f32 partial sums a second
    launch adds. ``k_step``: the K rows a thread dequantizes against one
    scale row. ``stage_k``: the K rows of one stage of the code ring,
    ``stages`` deep."""

    design: str
    splits: int
    k_slice: int
    k_step: int
    stage_k: int
    stages: int

    @property
    def cluster(self) -> int:
        """Blocks of a thread block cluster (1: no cluster)."""
        return self.splits if self.design == "splitk" else 1

    @property
    def reduce_launches(self) -> int:
        """Second launches that add K slices' partial sums (0 or 1)."""
        return int(self.design in ("rows", "f32") and self.splits > 1)

    def slices(self, K: int):
        """The K slices ``[lo, hi)``, in order."""
        return [(r * self.k_slice, min(K, (r + 1) * self.k_slice)) for r in range(self.splits)]


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def wq_plan(M: int, K: int, N: int, B: int, bits: int, dtype: torch.dtype, sms: int) -> WqPlan:
    """The launch plan of ``wq_matmul`` for x (M, K) of ``dtype`` against
    B weights (K, N) of ``bits``-bit codes on a card of ``sms`` SMs: the
    design from M and the dtype, the K slices and the ring depth. Pure, so
    the wrapper caches it per shape and the CPU tests check it."""
    bf16 = dtype == torch.bfloat16
    rpc = 2 if bits == 4 else 1
    if M <= WQ_ROWS_MAX and bf16:
        stage_k = WQ_SPLITK_BOX_ROWS * rpc
        strips = _ceil(N, WQ_SPLITK_COLS) * B
        S = max(1, min(WQ_SPLITK_CLUSTER_MAX, round(WQ_SPLITK_BLOCKS_PER_SM * sms / strips),
                       K // WQ_SPLITK_MIN_SLICE))
        k_slice = min(_ceil(_ceil(K, S), stage_k) * stage_k, K)
        return WqPlan("splitk", _ceil(K, k_slice), k_slice, 16, stage_k, WQ_SPLITK_STAGES)
    if bf16:
        return WqPlan("wgmma", 1, K, 16, WQ_WGMMA_BK, WQ_WGMMA_STAGES)
    mt = 1 if M <= 1 else 2 if M <= 2 else 4 if M <= 4 else 8 if M <= 8 else 16
    base = _ceil(N, WQ_ROWS_STRIP) * B * _ceil(M, mt)
    S = min(_ceil(WQ_ROWS_BLOCKS_PER_SM * sms, base), max(1, K // WQ_ROWS_SPLIT_MIN))
    S = max(S, _ceil(K, WQ_ROWS_SPLIT_MAX))
    k_slice = _ceil(_ceil(K, S), WQ_K_MULTIPLE) * WQ_K_MULTIPLE
    return WqPlan("rows" if M <= WQ_ROWS_MAX else "f32", _ceil(K, k_slice), k_slice, rpc,
                  k_slice, 1)


#: the plan of each shape, and each card's SM count
_WQ_PLANS: Dict[tuple, WqPlan] = {}
_SM_COUNTS: Dict[int, int] = {}


def _wq_dense(q: torch.Tensor, scale: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The dense weight of codes ``q`` (…, K or K/2, N) and scales (…, G,
    N), each group of K // G rows at its own scale row."""
    from ..quantization import dequantize

    G = scale.shape[-2]
    if G == 1:
        return dequantize({"q": q, "scale": scale}, dtype)
    CR, N = q.shape[-2:]
    w = dequantize({"q": q.reshape(*q.shape[:-2], G, CR // G, N),
                    "scale": scale.reshape(*scale.shape[:-2], G, 1, N)}, dtype)
    return w.reshape(*w.shape[:-3], -1, N)


def wq_matmul_ref(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """The plain version of :func:`wq_matmul`: :func:`quantization.dequantize`
    to x's dtype, then the product with f32 accumulation rounded once to
    x's dtype (the JAX package's ``_mm`` of a quantized weight)."""
    PLAIN_CALLS["wq_matmul"] += 1
    return torch.matmul(x, _wq_dense(q, scale, x.dtype)).to(x.dtype)


def wq_matmul(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """``x @ dequantize(q, scale)`` with each weight dequantized as
    :func:`quantization.dequantize` does it (the f32 code times the f32
    scale, rounded once to x's dtype) and the products accumulated in f32,
    rounded once to x's dtype.

    * ``x`` (M, K) against ``q`` (K, N) int8 or (K/2, N) packed int4 and
      ``scale`` (G, N) f32 (G = 1: one scale a column; G > 1: row k at
      scale row k // (K // G), the expert stack's down projection summed
      over its experts) → (M, N);
    * ``x`` (M, K) or (E, M, K) against ``E`` stacked weights ``q`` (E, K
      or K/2, N), ``scale`` (E, 1, N) → (E, M, N) (the expert stack's
      up and gate projections).

    CPU tensors run :func:`wq_matmul_ref`. CUDA tensors launch
    ``csrc/wq_matmul.cu`` by the plan of :func:`wq_plan` (counted in
    ``LAUNCHES["wq_matmul[int8|int4]"]`` and, by design, in
    ``DESIGN_LAUNCHES["wq_matmul[splitk|wgmma|rows|f32]"]``) or raise for
    what the kernel does not take, or a launch the card refuses."""
    if x.device.type == "cpu":
        return wq_matmul_ref(x, q, scale)
    bits = {torch.int8: 8, torch.uint8: 4}.get(q.dtype)
    if bits is None:
        raise ValueError(f"wq_matmul takes int8 or packed int4 (uint8) codes; got {q.dtype}")
    if x.dtype not in _CUDA_DTYPES:
        raise ValueError(f"wq_matmul takes float32 or bfloat16 x; got {x.dtype}")
    if scale.dtype != torch.float32:
        raise ValueError(f"wq_matmul takes float32 scales; got {scale.dtype}")
    if q.dim() not in (2, 3) or scale.dim() != q.dim():
        raise ValueError(f"wq_matmul takes (K, N) or (E, K, N) codes with scales of "
                         f"their rank; got {tuple(q.shape)}, {tuple(scale.shape)}")
    B = q.shape[0] if q.dim() == 3 else 1
    CR, N = q.shape[-2:]
    K = CR * (2 if bits == 4 else 1)
    G = scale.shape[-2]
    if scale.shape[-1] != N or (q.dim() == 3 and (scale.shape[0] != B or G != 1)):
        raise ValueError(f"scales {tuple(scale.shape)} do not fit codes {tuple(q.shape)}")
    if x.dim() == 2:
        M, x_batched = x.shape[0], 0
    elif x.dim() == 3 and q.dim() == 3 and x.shape[0] == B:
        M, x_batched = x.shape[1], 1
    else:
        raise ValueError(f"x {tuple(x.shape)} does not fit codes {tuple(q.shape)}")
    if x.shape[-1] != K:
        raise ValueError(f"x's last dim {x.shape[-1]} != the weight's input dim {K}")
    if (K % WQ_K_MULTIPLE or N % WQ_N_MULTIPLE or K % G
            or (K // G) % WQ_K_MULTIPLE):
        raise ValueError(f"wq_matmul takes K and each scale group's rows in multiples of "
                         f"{WQ_K_MULTIPLE} and N in multiples of {WQ_N_MULTIPLE}; got K={K}, "
                         f"N={N}, G={G}")
    for name, t in (("q", q), ("scale", scale)):
        if t.device != x.device:
            raise ValueError(f"{name} must lie on {x.device}; got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:  # TMA and the 16-byte scale loads
            raise ValueError(f"{name} must be 16-byte aligned")
    x = x.contiguous()
    if x.data_ptr() % 16:  # a view's offset: TMA reads 16-byte aligned rows
        x = x.clone()
    y = torch.empty(((B,) if q.dim() == 3 else ()) + (M, N), dtype=x.dtype, device=x.device)
    if M == 0:
        return y
    from . import _cuda

    key = (M, K, N, B, bits, x.dtype, x.device.index)
    plan = _WQ_PLANS.get(key)
    if plan is None:
        sms = _SM_COUNTS.get(x.device.index)
        if sms is None:
            sms = _SM_COUNTS[x.device.index] = torch.cuda.get_device_properties(
                x.device).multi_processor_count
        plan = _WQ_PLANS[key] = wq_plan(M, K, N, B, bits, x.dtype, sms)
    part = (torch.empty((plan.splits * B * M * N,), dtype=torch.float32, device=x.device)
            if plan.reduce_launches else None)
    _cuda.launch("wq_matmul", [x, q, scale, y, part],
                 [B, M, K, N, G, x_batched, bits, _dtype_code(x.dtype),
                  WQ_DESIGN_CODES[plan.design], plan.splits, plan.k_slice, plan.stages], [])
    LAUNCHES[f"wq_matmul[int{bits}]"] += 1
    DESIGN_LAUNCHES[f"wq_matmul[{plan.design}]"] += 1
    return y


def quant_mm(x: torch.Tensor, w: Dict[str, torch.Tensor]) -> torch.Tensor:
    """``x (…, K) @ w`` for a quantized ``{"q", "scale"}`` weight (K, N):
    :func:`wq_matmul` over x's rows flattened."""
    lead = x.shape[:-1]
    y = wq_matmul(x.reshape(-1, x.shape[-1]), w["q"], w["scale"])
    return y.reshape(*lead, y.shape[-1])
