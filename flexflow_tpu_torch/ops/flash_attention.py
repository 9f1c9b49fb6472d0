"""Flash attention, forward and backward, for the training path — the
port of ``flexflow_tpu/ops/flash_attention.py``.

Layout: queries ``(B, S, H, dk)``, keys and values ``(B, T, H, dk)``
(GQA heads repeated by the caller, as ``models/llama.make_flash_attention``
does), the JAX function's public layout. The CUDA kernels read that
layout through its row stride ``H * dk``, so the JAX wrapper's
``(B·H, S, dk)`` transposes are gone. The log-sum-exp is ``(B, H, S)``
f32: the JAX kernel's ``(B·H, S)``, reshaped.

Semantics of the JAX kernels: scores ``dot(q, k) * scale``; ``causal``
is the top-left rule ``qpos >= kpos`` (also when S != T); f32 softmax
with the denominator clamped at 1e-30 and ``lse = m + log l``; the
backward recomputes ``p = exp(s - lse)`` (FlashAttention-2) with
``delta = sum(do * out)`` per row in f32, and returns dq, dk, dv in the
inputs' dtypes.

Each kernel has three parts side by side, as in ``serve/kernels.py``:

* the **wrapper** (:func:`flash_fwd`, :func:`flash_bwd_kv`,
  :func:`flash_bwd_q`; :func:`flash_bwd` runs both): checks, then
  the plain version for tensors on the CPU, or the CUDA kernel for
  tensors on a GPU — never a fallback from a GPU tensor to the plain
  version. Each launch adds one to ``LAUNCHES[name]`` and to
  ``DESIGN_LAUNCHES`` by the design its launcher took ("wgmma" for bf16,
  "f32" for float32).
* the **plain PyTorch version** (:func:`flash_fwd_ref`,
  :func:`flash_bwd_kv_ref`, :func:`flash_bwd_q_ref`; :func:`flash_bwd_ref`
  runs both): the whole score matrix in f32. The backward is
  the recomputation from the LSE, not autograd of the forward, so it is a
  yardstick for the backward kernels in its own right.
* the **kernels**, CUDA C++ for ``sm_90a``:
  ``csrc/flash_attention_fwd.cu`` and ``csrc/flash_attention_bwd.cu``
  (dK/dV and dQ, the JAX package's two-kernel split), bf16 on wgmma fed
  by TMA, f32 on the CUDA cores, built on first use by
  ``serve/_cuda.py``.

:func:`flash_attention` is the differentiable entry point (the JAX
``custom_vjp`` ``_flash`` becomes a ``torch.autograd.Function``).
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch

NEG_INF = -1e30

#: launches per kernel since the last :func:`reset_launch_counts` — a
#: launch of the CUDA kernel counts, a plain-version call on the CPU not
LAUNCHES: Dict[str, int] = {
    "flash_attention_fwd": 0,
    "flash_attention_bwd_kv": 0,
    "flash_attention_bwd_q": 0,
}

#: launches by the design each launcher took ("wgmma" for bf16, "f32"),
#: since the last reset
DESIGN_LAUNCHES: Dict[str, int] = {f"{k}[{d}]": 0 for k in LAUNCHES for d in ("wgmma", "f32")}

#: head dims and dtypes the CUDA kernels are instantiated for
_CUDA_HEAD_DIMS = (64, 128)
_CUDA_DTYPES = (torch.float32, torch.bfloat16)
#: the kernels put b * H + h on the grid's y dimension
_CUDA_MAX_HEADS = 65535


def reset_launch_counts() -> None:
    for counts in (LAUNCHES, DESIGN_LAUNCHES):
        for name in counts:
            counts[name] = 0


def _mask(S: int, T: int, causal: bool, device) -> Optional[torch.Tensor]:
    if not causal:
        return None
    qpos = torch.arange(S, device=device)[:, None]
    return qpos >= torch.arange(T, device=device)[None, :]


def _scores(q, k, causal: bool, scale: float):
    """(B, H, S, T) f32 scores, masked lines at NEG_INF, and the mask."""
    s = torch.einsum("bshd,bthd->bhst", q.to(torch.float32),
                     k.to(torch.float32)) * scale
    mask = _mask(q.shape[1], k.shape[1], causal, q.device)
    if mask is not None:
        s = torch.where(mask, s, NEG_INF)
    return s, mask


# ---------------------------------------------------------------------------
# plain versions


def flash_fwd_ref(q, k, v, causal: bool, scale: float):
    """Plain version of the forward: q (B, S, H, dk), k/v (B, T, H, dk) →
    (out (B, S, H, dk) in q's dtype, lse (B, H, S) f32)."""
    s, mask = _scores(q, k, causal, scale)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    if mask is not None:
        p = torch.where(mask, p, 0.0)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    out = torch.einsum("bhst,bthd->bhsd", p, v.to(torch.float32)) / l
    lse = (m + torch.log(l))[..., 0]
    return out.permute(0, 2, 1, 3).to(q.dtype).contiguous(), lse


def delta_rows(out, do):
    """delta = sum(do * out) over dk per row, f32 (B, H, S): the JAX
    package computes it outside its kernels too."""
    return (do.to(torch.float32) * out.to(torch.float32)).sum(dim=-1).transpose(1, 2)


def _probs_and_dscores(q, k, v, do, lse, delta, causal: bool, scale: float):
    """(B, H, S, T) f32 probabilities recomputed from ``lse`` and the score
    gradients ds = p * (do·v - delta) * scale."""
    s, mask = _scores(q, k, causal, scale)
    p = torch.exp(s - lse[..., None])
    if mask is not None:
        p = torch.where(mask, p, 0.0)
    dp = torch.einsum("bshd,bthd->bhst", do.to(torch.float32), v.to(torch.float32))
    return p, p * (dp - delta[..., None]) * scale


def flash_bwd_kv_ref(q, k, v, do, lse, delta, causal: bool, scale: float):
    """Plain version of the dK/dV kernel: (dk, dv) in k's and v's dtypes."""
    p, ds = _probs_and_dscores(q, k, v, do, lse, delta, causal, scale)
    dv = torch.einsum("bhst,bshd->bthd", p, do.to(torch.float32))
    dk = torch.einsum("bhst,bshd->bthd", ds, q.to(torch.float32))
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_bwd_q_ref(q, k, v, do, lse, delta, causal: bool, scale: float):
    """Plain version of the dQ kernel: dq in q's dtype."""
    _, ds = _probs_and_dscores(q, k, v, do, lse, delta, causal, scale)
    return torch.einsum("bhst,bthd->bshd", ds, k.to(torch.float32)).to(q.dtype)


def flash_bwd_ref(q, k, v, out, lse, do, causal: bool, scale: float):
    """Plain version of the backward: the FlashAttention-2 recomputation
    from ``lse`` (B, H, S). Returns (dq, dk, dv) in the dtypes of q, k,
    v."""
    delta = delta_rows(out, do)
    dk, dv = flash_bwd_kv_ref(q, k, v, do, lse, delta, causal, scale)
    return flash_bwd_q_ref(q, k, v, do, lse, delta, causal, scale), dk, dv


# ---------------------------------------------------------------------------
# wrappers


def _check(q, k, v):
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(
            f"flash attention takes q (B, S, H, dk) and k/v (B, T, H, dk); got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, S, H, dk = q.shape
    if k.shape[0] != B or k.shape[2] != H or k.shape[3] != dk:
        raise ValueError(f"k/v {tuple(k.shape)} do not match q {tuple(q.shape)} "
                         "(repeat GQA heads before the call)")
    if S < 1 or k.shape[1] < 1:
        raise ValueError("flash attention needs at least one query and one key")
    if q.device != k.device or q.device != v.device:
        raise ValueError("q, k and v must lie on one device")


def _check_cuda(named):
    """Device, dtype, head dim, contiguity and alignment of the tensors a
    kernel reads as (B, S|T, H, dk)."""
    q = named[0][1]
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    if q.dtype not in _CUDA_DTYPES:
        raise ValueError(f"CUDA flash attention takes float32 or bfloat16; got {q.dtype}")
    B, _, H, dk = q.shape
    if dk not in _CUDA_HEAD_DIMS:
        raise ValueError(f"CUDA flash attention has no head dim {dk} (has {_CUDA_HEAD_DIMS})")
    if B * H > _CUDA_MAX_HEADS:
        raise ValueError(f"CUDA flash attention takes at most {_CUDA_MAX_HEADS} "
                         f"(batch, head) pairs; got {B * H}")
    for name, t in named:
        if t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"{name} must be {q.dtype} on {q.device}; got "
                             f"{t.dtype} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:  # the kernels read rows in 16-byte vectors
            raise ValueError(f"{name} must be 16-byte aligned")


def _dtype_code(dtype: torch.dtype) -> int:
    return 1 if dtype == torch.bfloat16 else 0


def flash_fwd(q, k, v, causal: bool, scale: float):
    """Flash attention forward: q (B, S, H, dk) over k/v (B, T, H, dk).
    Returns (out (B, S, H, dk) in q's dtype, lse (B, H, S) f32)."""
    _check(q, k, v)
    if q.device.type == "cpu":
        return flash_fwd_ref(q, k, v, causal, scale)
    _check_cuda([("q", q), ("k", k), ("v", v)])
    from ..serve import _cuda

    B, S, H, dk = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    code = _dtype_code(q.dtype)
    _cuda.launch("flash_attention_fwd", [q, k, v, out, lse],
                 [B, S, k.shape[1], H, dk, int(causal), code], [scale])
    _count("flash_attention_fwd", code)
    return out, lse


def _count(name: str, code: int) -> None:
    """Count one launch of kernel ``name`` on q of dtype code ``code``,
    also by the design its launcher took."""
    from ..serve import _cuda

    LAUNCHES[name] += 1
    DESIGN_LAUNCHES[f"{name}[{_cuda.design(name, code)}]"] += 1


def _check_bwd(q, k, v, do, lse, delta):
    """Checks of a backward kernel's operands; the CUDA ones for tensors
    on a GPU."""
    _check(q, k, v)
    B, S, H, _ = q.shape
    if do.shape != q.shape:
        raise ValueError(f"do must be {tuple(q.shape)}; got {tuple(do.shape)}")
    for name, t in (("lse", lse), ("delta", delta)):
        if t.shape != (B, H, S) or t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32 ({B}, {H}, {S}); got {t.dtype} "
                             f"{tuple(t.shape)}")
    if q.device.type == "cpu":
        return
    _check_cuda([("q", q), ("k", k), ("v", v), ("do", do)])
    for name, t in (("lse", lse), ("delta", delta)):
        if t.device != q.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on q's device")


def _bwd_dims(q, k, causal):
    B, S, H, dk = q.shape
    return [B, S, k.shape[1], H, dk, int(causal), _dtype_code(q.dtype)]


def flash_bwd_kv(q, k, v, do, lse, delta, causal: bool, scale: float):
    """The dK/dV half of the backward from the forward's ``lse`` and the
    rows' ``delta`` (both (B, H, S) f32). Returns (dk, dv)."""
    _check_bwd(q, k, v, do, lse, delta)
    if q.device.type == "cpu":
        return flash_bwd_kv_ref(q, k, v, do, lse, delta, causal, scale)
    from ..serve import _cuda

    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _cuda.launch("flash_attention_bwd_kv", [q, k, v, do, lse, delta, dk, dv],
                 _bwd_dims(q, k, causal), [scale])
    _count("flash_attention_bwd_kv", _dtype_code(q.dtype))
    return dk, dv


def flash_bwd_q(q, k, v, do, lse, delta, causal: bool, scale: float):
    """The dQ half of the backward (arguments as :func:`flash_bwd_kv`).
    Returns dq."""
    _check_bwd(q, k, v, do, lse, delta)
    if q.device.type == "cpu":
        return flash_bwd_q_ref(q, k, v, do, lse, delta, causal, scale)
    from ..serve import _cuda

    dq = torch.empty_like(q)
    _cuda.launch("flash_attention_bwd_q", [q, k, v, do, lse, delta, dq],
                 _bwd_dims(q, k, causal), [scale])
    _count("flash_attention_bwd_q", _dtype_code(q.dtype))
    return dq


def flash_bwd(q, k, v, out, lse, do, causal: bool, scale: float):
    """Flash attention backward from the forward's ``out`` and ``lse``
    (B, H, S) and the output gradient ``do`` (B, S, H, dk): delta per row
    (:func:`delta_rows`), then the dK/dV kernel and the dQ kernel.
    Returns (dq, dk, dv)."""
    if out.shape != q.shape or out.dtype != q.dtype:
        raise ValueError(f"out must be {q.dtype} {tuple(q.shape)}; got {out.dtype} "
                         f"{tuple(out.shape)}")
    delta = delta_rows(out, do).contiguous()
    dk, dv = flash_bwd_kv(q, k, v, do, lse, delta, causal, scale)
    return flash_bwd_q(q, k, v, do, lse, delta, causal, scale), dk, dv


# ---------------------------------------------------------------------------
# differentiable entry point


class _Flash(torch.autograd.Function):
    """The JAX package's ``_flash`` custom VJP: the forward saves (q, k, v,
    out, lse), the backward runs :func:`flash_bwd`."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, scale: float):
        out, lse = flash_fwd(q, k, v, causal, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.scale = causal, scale
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_bwd(q, k, v, out, lse, do.contiguous(), ctx.causal, ctx.scale)
        return dq, dk, dv, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """Fused multi-head attention, differentiable, with scores scaled by
    ``1 / sqrt(dk)``. q (B, S, H, dk), k/v (B, T, H, dk) with GQA heads
    already repeated; returns (B, S, H, dk).

    The JAX function's ``block_q``/``block_k`` (its VMEM tile sizes) have
    no counterpart: the CUDA kernels choose their own tiles."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    return _Flash.apply(q.contiguous(), k.contiguous(), v.contiguous(), causal, scale)
