"""Hand-written CUDA kernels of the serving hot path: attention, and the
whole serving step in one kernel (:func:`whole_step_decode`).

Each kernel here has three parts side by side:

* the **wrapper** (:func:`decode_attention`, :func:`verify_attention`,
  :func:`ragged_paged_attention`, :func:`fused_rope_paged_attention`,
  :func:`whole_step_decode`):
  checks device, dtype, shape and contiguity, then either runs the plain
  version (the tensors lie on the CPU) or launches the CUDA kernel (the
  tensors lie on a GPU) — never a fallback from a GPU tensor to the plain
  version. Each launch adds one to ``LAUNCHES[name]``; the paged kernels
  and the whole-step kernel count per pool type,
  ``name[bf16|f32|int8|int4]``.
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

import math
from typing import Dict, Optional

import torch

from .kv_quant import pool_pack, quant_line_write, unpack_codes

NEG_INF = -1e30

#: pool types of the paged kernels, as their launch counters name them
POOL_TYPES = ("bf16", "f32", "int8", "int4")
PAGED_KERNELS = ("ragged_paged_attention", "fused_rope_paged_attention")

#: launches per kernel since the last :func:`reset_launch_counts` — a
#: launch of the CUDA kernel counts, a plain-version call on the CPU not
LAUNCHES: Dict[str, int] = {
    "decode_attention": 0,
    "verify_attention": 0,
    **{f"{k}[{t}]": 0 for k in PAGED_KERNELS + ("whole_step_decode",) for t in POOL_TYPES},
}

#: head dims, q dtypes and page sizes the CUDA kernels are instantiated for
_CUDA_HEAD_DIMS = (64, 128)
_CUDA_DTYPES = (torch.float32, torch.bfloat16)
_CUDA_PAGE_SIZES = (16, 32, 64, 128)
#: most new lines per slot the fused kernel commits in one launch
_FUSED_MAX_CHUNK = 256


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


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
    int32 — lines [0, seq_len) are attended. Returns (R, H, dk)."""
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
    out = torch.empty_like(q)
    _cuda.launch(
        "decode_attention",
        [q, k_cache, v_cache, seq_lens, out],
        [R, S1, H, KV, dk, _dtype_code(q.dtype)],
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


def verify_attention(q, k_cache, v_cache, mask, *,
                     scale: Optional[float] = None):
    """Fused verify attention: every one of the C query tokens per slot
    attends the cache lines its ``mask`` row allows, in one pass over the
    cache. q (R, C, H, dk); k/v (R, S1, KV, dk); mask (R, C, S1) bool.
    Returns (R, C, H, dk)."""
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
    _check_cuda(q, k_cache, v_cache, dk)
    if mask.device != q.device or not mask.is_contiguous():
        raise ValueError("mask must be contiguous on q's device")
    from . import _cuda

    KV = k_cache.shape[2]
    out = torch.empty_like(q)
    _cuda.launch(
        "verify_attention",
        [q, k_cache, v_cache, mask, out],
        [R, C, S1, H, KV, dk, _dtype_code(q.dtype)],
        [scale if scale is not None else 1.0 / math.sqrt(dk)],
    )
    LAUNCHES["verify_attention"] += 1
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


def ragged_paged_attention(q, k_pool, v_pool, page_table, mask, *,
                           scale: Optional[float] = None,
                           k_scale=None, v_scale=None):
    """Ragged paged attention: every one of the C query tokens per slot
    attends the lines its ``mask`` row allows, read through the slot's
    page table. q (R, C, H, dk); pools (P+1, ps, KV, dk/pack) in q's
    dtype, or int8/uint8 codes with ``k_scale``/``v_scale`` (P+1, KV)
    f32; page_table (R, NP) int32; mask (R, C, NP*ps) bool. Returns
    (R, C, H, dk)."""
    kind = _check_paged(q, k_pool, v_pool, page_table, mask, k_scale, v_scale)
    if q.device.type == "cpu":
        return ragged_paged_attention_ref(q, k_pool, v_pool, page_table, mask,
                                          scale=scale, k_scale=k_scale, v_scale=v_scale)
    _check_paged_cuda(q, k_pool, v_pool, page_table, mask, k_scale, v_scale)
    from . import _cuda

    R, C, H, dk = q.shape
    ps, KV = k_pool.shape[1], k_pool.shape[2]
    out = torch.empty_like(q)
    _cuda.launch(
        "ragged_paged_attention",
        [q, k_pool, v_pool, k_scale, v_scale, page_table, mask, out],
        [R, C, H, KV, dk, ps, page_table.shape[1], _dtype_code(q.dtype), kind],
        [scale if scale is not None else 1.0 / math.sqrt(dk)],
    )
    LAUNCHES[f"ragged_paged_attention[{pool_type(k_pool)}]"] += 1
    return out


# ---------------------------------------------------------------------------
# fused RoPE + KV write + ragged paged attention


def commit_paged(k_pool, v_pool, k, v, phys, off, k_scale=None, v_scale=None,
                 qmax: Optional[float] = None):
    """Write the new K/V lines (R, C, KV, dk) at physical page ``phys``,
    in-page offset ``off`` (each (R, C) int64) in place: a scatter, or
    ``kv_quant.quant_line_write`` with ``qmax`` on a quantized pool. The
    unfused paged step's commit, which the fused kernel matches bit for
    bit."""
    if qmax is not None:
        quant_line_write(k_pool, k_scale, phys, off, k, qmax)
        quant_line_write(v_pool, v_scale, phys, off, v, qmax)
    else:
        k_pool[phys, off] = k.to(k_pool.dtype)
        v_pool[phys, off] = v.to(v_pool.dtype)


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
    commit_paged(k_pool, v_pool, k_new, v_new, phys, off.long(), k_scale, v_scale, qmax)
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

    ps = k_pool.shape[1]
    out = torch.empty_like(q)
    q_rot = torch.empty_like(q)
    k_rot = torch.empty_like(k_new)
    _cuda.launch(
        "fused_rope_paged_attention",
        [q, k_new, v_new, cos, sin, k_pool, v_pool, k_scale, v_scale, page_table,
         logical, off, mask, out, q_rot, k_rot],
        [R, C, H, KV, dk, ps, page_table.shape[1],
         cos.shape[-1] if cos is not None else 0, _dtype_code(q.dtype), kind],
        [scale if scale is not None else 1.0 / math.sqrt(dk),
         qmax if qmax is not None else 0.0],
    )
    LAUNCHES[f"fused_rope_paged_attention[{pool_type(k_pool)}]"] += 1
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
    if dk not in _CUDA_HEAD_DIMS:
        raise ValueError(f"CUDA attention has no head dim {dk} (has {_CUDA_HEAD_DIMS})")
    if k_pool.shape[1] not in _CUDA_PAGE_SIZES:
        raise ValueError(f"CUDA paged attention has no page size {k_pool.shape[1]} "
                         f"(has {_CUDA_PAGE_SIZES})")
    for name, t in (("q", q), ("k_pool", k_pool), ("v_pool", v_pool),
                    ("page_table", page_table), ("mask", mask),
                    ("k_scale", k_scale), ("v_scale", v_scale)):
        if t is not None and not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, t in (("q", q), ("k_pool", k_pool), ("v_pool", v_pool)):
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
_WS_ATTN_ROWS = 64       # query rows of the attention tile design


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


def _ws_item_bytes(rows: int, width: int, isz: int) -> int:
    """A projection work item's double-buffered weight (32 × width) and
    activation (rows × 32) chunks, padded as the kernel pads them, plus
    its f32 accumulators (rows × width, in registers)."""
    bm, pad = _ws_row_tile(rows, width), 16 // isz
    return 2 * (bm * (_WS_BK + pad) + _WS_BK * (width + pad)) * isz + 4 * bm * width


def _ws_attn_smem(dk: int) -> int:
    """Bytes of paged_attention.cuh's TileSmem<dk, 64>."""
    floats = (64 * (dk + 4) + 64 * dk + _WS_ATTN_ROWS * (dk + 4)
              + _WS_ATTN_ROWS * 68 + 2 * 64 + 3 * 4)
    return 4 * floats + _WS_ATTN_ROWS * 64


def _ws_widths(layer_arrays, tile_roles, tiles: int):
    return [int(layer_arrays[w].shape[-1]) // tiles for (w, _b) in tile_roles.values()]


def whole_step_smem_bytes(layer_arrays, cache, x0, num_heads: int, *,
                          tiles: int, tile_roles) -> int:
    """On-chip bytes one block of the whole-step kernel holds for one
    projection work item — one row tile (16 rows, or up to 64 for a step
    of more than 16 rows) by one output-column tile of the widest tiled
    weight: the double-buffered weight chunk (32 × width) and activation
    chunk (rows × 32), padded as the kernel pads them, plus the f32
    accumulators (rows × width, in registers); or, when larger, an LM-head
    item (R rows × at most 256 columns) or the attention's tile design (a
    KV head with more than one query row); plus the kernel's static shared
    memory. ``x0`` (R, C, D) gives the step shape and the model dtype (a
    "meta" tensor will do)."""
    R, C, D = x0.shape
    isz = x0.element_size()
    wmax = max(_ws_widths(layer_arrays, tile_roles, tiles))
    item = max(_ws_item_bytes(R * C, wmax, isz),
               _ws_item_bytes(R, min(_WS_HEAD_COLS, wmax), isz))
    dk = int(layer_arrays[tile_roles["q"][0]].shape[-1]) // num_heads
    kv = int(cache["k"].shape[3])
    attn = _ws_attn_smem(dk) if C * (num_heads // kv) > 1 else 0
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
    """Whether the CUDA kernel takes this tile count: every column tile a
    whole number of 8-wide MMA columns, and the widest one's accumulators
    for 16 rows within a warp's share (24 fragments of 16 × 8)."""
    widths = _ws_widths(layer_arrays, tile_roles, tiles)
    if any(w % 8 or w <= 0 for w in widths):
        return False
    return _ws_per_warp(max(widths)) <= _WS_MAX_FRAGS


def whole_step_pick_tiles(layer_arrays, cache, x0, num_heads: int, *,
                          tile_roles, budget: int):
    """The SMALLEST candidate tile count the kernel takes whose priced
    block footprint (:func:`whole_step_smem_bytes`) fits ``budget``.
    Returns ``(tiles, est_bytes)``, or ``(None, best_est)`` when no legal
    tiling fits (the attention and static floor alone exceed the budget):
    the one condition under which the engine falls back to the per-layer
    path."""
    best = None
    for t in whole_step_tile_candidates(layer_arrays, tile_roles):
        if not whole_step_kernel_takes(layer_arrays, tiles=t, tile_roles=tile_roles):
            continue
        est = whole_step_smem_bytes(layer_arrays, cache, x0, num_heads,
                                    tiles=t, tile_roles=tile_roles)
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
    f32 logits. Returns ``(logits, greedy tokens (R,) int32, cache)``."""
    quant = "k_scale" in cache
    x = x0
    for l in range(cache["k"].shape[0]):
        p_l = {name: a[l] for name, a in layer_arrays.items()}
        ks, vs = (cache["k_scale"][l], cache["v_scale"][l]) if quant else (None, None)
        x = block_fn(p_l, x, cos, sin, mask, cache["k"][l], cache["v"][l], ks, vs,
                     phys, off, page_table)
    logits = head_fn(head_arrays, x, logits_idx)
    return logits, torch.argmax(logits, dim=-1).to(torch.int32), cache


#: the layer and head tensors the CUDA kernel takes (the LLaMA layout)
_WS_LAYER_NAMES = ("attn_norm", "wq", "wk", "wv", "wo", "ffn_norm", "w1", "w2", "w3")
_WS_ROLES = {"q": ("wq", None), "k": ("wk", None), "v": ("wv", None), "o": ("wo", None),
             "gate": ("w1", None), "up": ("w3", None), "down": ("w2", None)}


def whole_step_decode(layer_arrays, head_arrays, x0, cos, sin, cache, page_table, phys,
                      off, mask, logits_idx, *, block_fn, head_fn, tile_roles, eps: float,
                      qmax=None, tiles: int = 1):
    """The whole serving step of every layer in one kernel. ``layer_arrays``
    are the stacked (L, …) layer weights, ``head_arrays`` the final norm
    and the LM head (``lm_head`` (D, V), or ``embed`` (V, D) when tied);
    x0 (R, C, D) the embedded step input; cos/sin (R, C, dk) f32; ``cache``
    the paged pools (L, P+1, ps, KV, dk/pack) [+ (L, P+1, KV) scales],
    updated in place; page_table (R, NP); phys/off (R, C) the page and
    in-page offset of each new line; mask (R, C, NP*ps) bool; logits_idx
    (R,) the row whose logits each slot returns. ``tiles`` must be one of
    :func:`whole_step_tile_candidates` for ``tile_roles``. Returns
    ``(logits (R, V) f32, greedy tokens (R,) int32, cache)``.

    On CPU tensors it runs the plain version, the walk through
    ``block_fn``/``head_fn`` (:func:`whole_step_decode_ref`): the tile
    count only groups output columns, so it gives the same answer at
    every count. On CUDA tensors it launches csrc/whole_step_decode.cu,
    which computes the LLaMA block (the layer names of
    ``_WS_LAYER_NAMES``, RMS norms at ``eps``, rotate-half RoPE, SwiGLU,
    pools quantized at ``qmax``), or raises on a layout, shape, dtype,
    head dim or tile count it does not take. Each launch adds one to
    ``LAUNCHES["whole_step_decode[<pool>]"]``."""
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
                                   tile_roles, eps, qmax)


def _whole_step_decode_cuda(layer_arrays, head_arrays, x0, cos, sin, cache, page_table,
                            phys, off, mask, logits_idx, tiles, tile_roles, eps, qmax):
    if x0.device.type != "cuda":
        raise ValueError(f"no kernel for device {x0.device}")
    if tile_roles != _WS_ROLES:
        raise ValueError("the whole-step kernel computes the LLaMA block: it takes the "
                         f"tile roles {_WS_ROLES}")
    if sorted(layer_arrays) != sorted(_WS_LAYER_NAMES):
        raise ValueError(f"the whole-step kernel takes the layer tensors {_WS_LAYER_NAMES}; "
                         f"got {sorted(layer_arrays)}")
    tied = "lm_head" not in head_arrays
    head = head_arrays["embed"] if tied else head_arrays["lm_head"]
    dt = x0.dtype
    if dt not in _CUDA_DTYPES:
        raise ValueError(f"the whole-step kernel takes float32 or bfloat16; got {dt}")
    R, C, D = x0.shape
    L, _, Q = layer_arrays["wq"].shape
    KVd = layer_arrays["wk"].shape[-1]
    Fd = layer_arrays["w1"].shape[-1]
    V = head.shape[0] if tied else head.shape[1]
    k_pool, v_pool = cache["k"], cache["v"]
    if k_pool.dim() != 5 or k_pool.shape != v_pool.shape or k_pool.shape[0] != L:
        raise ValueError(f"pools must be (L={L}, P+1, ps, KV, dk/pack); got "
                         f"{tuple(k_pool.shape)} and {tuple(v_pool.shape)}")
    _, P1, ps, KV, dkp = k_pool.shape
    dk = KVd // KV
    H = Q // dk
    shapes = {"attn_norm": (L, D), "wq": (L, D, H * dk), "wk": (L, D, KV * dk),
              "wv": (L, D, KV * dk), "wo": (L, H * dk, D), "ffn_norm": (L, D),
              "w1": (L, D, Fd), "w2": (L, Fd, D), "w3": (L, D, Fd)}
    for name, shape in shapes.items():
        t = layer_arrays[name]
        if tuple(t.shape) != shape or t.dtype != dt:
            raise ValueError(f"{name} must be {dt} {shape}; got {t.dtype} {tuple(t.shape)}")
    if tuple(head.shape) != ((V, D) if tied else (D, V)) or head.dtype != dt:
        raise ValueError(f"the LM head must be {dt} (D, V) (embed (V, D) when tied); got "
                         f"{head.dtype} {tuple(head.shape)}")
    if tuple(head_arrays["final_norm"].shape) != (D,) or head_arrays["final_norm"].dtype != dt:
        raise ValueError(f"final_norm must be {dt} ({D},)")
    if dk not in _CUDA_HEAD_DIMS or H * dk != Q or H % KV:
        raise ValueError(f"the whole-step kernel has no head dim {dk} with H={H}, KV={KV} "
                         f"(head dims {_CUDA_HEAD_DIMS})")
    if ps not in _CUDA_PAGE_SIZES:
        raise ValueError(f"the whole-step kernel has no page size {ps} "
                         f"(has {_CUDA_PAGE_SIZES})")
    if C > _FUSED_MAX_CHUNK:
        raise ValueError(f"the whole-step kernel commits at most {_FUSED_MAX_CHUNK} lines "
                         f"per slot; got C={C}")
    if D % _WS_BK or Q % _WS_BK or Fd % _WS_BK or V % 8:
        raise ValueError(f"the whole-step kernel needs D ({D}), H*dk ({Q}) and F ({Fd}) "
                         f"multiples of {_WS_BK} and V ({V}) of 8")
    if not whole_step_kernel_takes(layer_arrays, tiles=tiles, tile_roles=_WS_ROLES):
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
    for name, t in (("cos", cos), ("sin", sin)):
        if t is None or tuple(t.shape) != (R, C, dk) or t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32 ({R}, {C}, {dk})")
    phys, off = phys.to(torch.int32).contiguous(), off.to(torch.int32).contiguous()
    logits_idx = logits_idx.to(torch.int32).contiguous()
    if tuple(phys.shape) != (R, C) or tuple(off.shape) != (R, C) or logits_idx.shape != (R,):
        raise ValueError(f"phys/off must be ({R}, {C}) and logits_idx ({R},)")
    tensors = [*(layer_arrays[n] for n in _WS_LAYER_NAMES), head_arrays["final_norm"], head,
               x0, cos, sin, k_pool, v_pool, cache.get("k_scale"), cache.get("v_scale"),
               page_table, phys, off, mask, logits_idx]
    for t in tensors:
        if t is None:
            continue
        if t.device != x0.device:
            raise ValueError("every operand of the whole-step kernel must lie on x0's device")
        if not t.is_contiguous():
            raise ValueError("every operand of the whole-step kernel must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError("every operand of the whole-step kernel must be 16-byte aligned")
    from . import _cuda

    M = R * C
    KS = _ws_k_slices(M)
    logits = torch.empty((R, V), dtype=torch.float32, device=x0.device)
    tokens = torch.empty((R,), dtype=torch.int32, device=x0.device)
    scratch = torch.empty((M * (4 * D + 3 * Q + 3 * KVd + Fd) + R * D,), dtype=dt,
                          device=x0.device)
    work = torch.empty((KS * M * max(Q + 2 * KVd, D, 2 * Fd),), dtype=torch.float32,
                       device=x0.device)
    _cuda.launch(
        "whole_step_decode",
        tensors[:11] + [x0, cos, sin, k_pool, v_pool, cache.get("k_scale"),
                        cache.get("v_scale"), page_table, phys, off, mask, logits_idx,
                        logits, tokens, scratch, work],
        [L, R, C, D, H, KV, dk, Fd, V, ps, NP, P1, tiles, KS, int(tied), _dtype_code(dt),
         kind],
        [eps, 1.0 / math.sqrt(dk), qmax if qmax is not None else 0.0],
    )
    LAUNCHES[f"whole_step_decode[{pool_type(k_pool)}]"] += 1
    return logits, tokens, cache
