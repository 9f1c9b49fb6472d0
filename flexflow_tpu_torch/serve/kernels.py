"""Hand-written CUDA attention kernels of the serving hot path.

Each kernel here has three parts side by side:

* the **wrapper** (:func:`decode_attention`, :func:`verify_attention`):
  checks device, dtype, shape and contiguity, then either runs the plain
  version (the tensors lie on the CPU) or launches the CUDA kernel (the
  tensors lie on a GPU) — never a fallback from a GPU tensor to the plain
  version. Each launch adds one to ``LAUNCHES[name]``.
* the **plain PyTorch version** (``*_ref``) with the kernel's semantics,
  used on the CPU and as the yardstick the kernel is held to on the GPU.
* the **kernel**, CUDA C++ for ``sm_90a`` in ``flexflow_tpu_torch/csrc/``
  (its header says which TPU kernel it replaces, what bounds it on an
  H100 and what its design does about that), built on first use by
  :mod:`._cuda`.

Both kernels compute an f32 online softmax and clamp the softmax
denominator at 1e-20, so a query row with nothing to attend gives 0
(``serve_attention`` gives the mean of V there instead; only padding
rows meet that case and their outputs are never read).
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch

NEG_INF = -1e30

#: launches per kernel since the last :func:`reset_launch_counts` — a
#: launch of the CUDA kernel counts, a plain-version call on the CPU not
LAUNCHES: Dict[str, int] = {"decode_attention": 0, "verify_attention": 0}

#: head dims the CUDA kernels are instantiated for
_CUDA_HEAD_DIMS = (64, 128)
_CUDA_DTYPES = (torch.float32, torch.bfloat16)


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
        scale if scale is not None else 1.0 / math.sqrt(dk),
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
        scale if scale is not None else 1.0 / math.sqrt(dk),
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
