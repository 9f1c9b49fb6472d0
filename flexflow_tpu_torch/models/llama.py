"""LLaMA model family — the port of ``flexflow_tpu/models/llama.py``:
single-device training and serving.

embedding → N × [rms_norm → attention(QKV + RoPE + GQA) → rms_norm →
SwiGLU FFN] → rms_norm → lm_head, trained with :func:`make_train_step`
(full causal attention, ``attention="torch"`` or the hand-written flash
kernels of ``ops/flash_attention.py``, per-block remat) or served over a
dense or a paged KV cache.

Layout kept from the JAX package at every public function so tests
compare like with like: weights are ``(in, out)``, stacked on a leading
layer dim ``L``, under the same dict keys; the dense KV cache is
``(L, slots, max_len + 1, KV, dk)`` with the last line a scratch row,
the paged one ``(L, num_pages + 1, page_size, KV, dk / pack)`` with the
last page a scratch page (plus ``(L, num_pages + 1, KV)`` f32 scales
when quantized).

Differences from the JAX package:
  * the layer stack is a Python loop over per-layer views, not a scan;
  * the KV cache is updated **in place** (the JAX package donates the
    cache buffers and returns new ones; here ``serve_step`` writes into
    the tensors it is given and returns the same dict);
  * ``kernels="cuda"`` routes attention through the hand-written CUDA
    kernels of ``serve/kernels.py`` (the JAX package's ``"pallas"``),
    ``kernels="torch"`` through :func:`serve_attention` (its ``"xla"``);
    in training, ``attention="flash"`` is the JAX package's ``"flash"``
    and ``attention="torch"`` its ``"xla"``;
  * the train step's optimizer updates the parameters in place.

``serve_step_whole`` (``ServingConfig.fused_decode=("whole_step",)``) runs
the whole paged serving step in one persistent CUDA kernel
(serve/kernels.whole_step_decode).

SpecInfer (serve/specinfer.py) and beam search (serve/beam.py) run on
the step functions' ``num_layers`` slice (the early-exit draft) and the
K/V line moves :func:`commit_kv`, :func:`commit_kv_paged`,
:func:`reorder_slots` and :func:`reorder_slots_paged`.

Data, tensor, pipeline, sequence and context parallelism and
microbatching come with later slices.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from ..quantization import OFFLOAD_WHOLE_STEP, is_quantized, layer_params
# the weight bridge, under its old names
from .hf_utils import _array_to_tensor, params_from_numpy  # noqa: F401


@dataclasses.dataclass(frozen=True)
class LLaMAConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: int = 32
    rms_norm_eps: float = 1e-6
    rope_theta: float = 10000.0
    max_position_embeddings: int = 2048
    dtype: torch.dtype = torch.bfloat16
    tie_word_embeddings: bool = False

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @classmethod
    def llama_7b(cls, **kw):
        return cls(**kw)

    @classmethod
    def llama_160m(cls, **kw):
        """The reference's standard SSM speculator (JackFram/llama-160m)."""
        d = dict(
            hidden_size=768,
            intermediate_size=3072,
            num_hidden_layers=12,
            num_attention_heads=12,
            num_key_value_heads=12,
        )
        d.update(kw)
        return cls(**d)

    @classmethod
    def tiny(cls, **kw):
        d = dict(
            vocab_size=256,
            hidden_size=64,
            intermediate_size=128,
            num_hidden_layers=2,
            num_attention_heads=4,
            num_key_value_heads=2,
            max_position_embeddings=128,
        )
        d.update(kw)
        return cls(**d)

    @classmethod
    def from_hf(cls, hf: Dict[str, Any], **kw) -> "LLaMAConfig":
        """The config of an HF ``LlamaForCausalLM`` checkpoint
        (``config.json`` as a dict); ``kw`` overrides (``dtype`` among
        them)."""
        d = dict(
            vocab_size=hf.get("vocab_size", 32000),
            hidden_size=hf.get("hidden_size", 4096),
            intermediate_size=hf.get("intermediate_size", 11008),
            num_hidden_layers=hf.get("num_hidden_layers", 32),
            num_attention_heads=hf.get("num_attention_heads", 32),
            num_key_value_heads=hf.get("num_key_value_heads",
                                       hf.get("num_attention_heads", 32)),
            rms_norm_eps=hf.get("rms_norm_eps", 1e-6),
            rope_theta=hf.get("rope_theta", 10000.0),
            max_position_embeddings=hf.get("max_position_embeddings", 2048),
            tie_word_embeddings=hf.get("tie_word_embeddings", False),
        )
        d.update(kw)
        return cls(**d)


def from_hf(hf: Dict[str, Any], **kw) -> LLaMAConfig:
    """The family's uniform entry point for :meth:`LLaMAConfig.from_hf`."""
    return LLaMAConfig.from_hf(hf, **kw)


def convert_hf_state_dict(sd: Dict[str, torch.Tensor], cfg: LLaMAConfig, *,
                          device: Any = None) -> Dict[str, Any]:
    """An HF ``LlamaForCausalLM`` state dict → this family's parameter
    tree in ``cfg.dtype`` on ``device`` (``"cuda"`` unless the caller names
    another): ``nn.Linear`` weights (out, in) transposed to (in, out), the
    layers stacked on a leading dim, no ``lm_head`` when the embeddings
    are tied. Each stacked tensor is filled a layer at a time on the
    device."""
    from ..serve.engine import resolve_device

    dev, dt, L, pre = resolve_device(device), cfg.dtype, cfg.num_hidden_layers, "model."

    def put(t):
        return t.to(device=dev, dtype=dt).contiguous()

    def stacked(fmt, linear):
        first = sd[pre + fmt.format(0)]
        shape = tuple(first.shape[::-1]) if linear else tuple(first.shape)
        out = torch.empty((L,) + shape, dtype=dt, device=dev)
        for i in range(L):
            w = sd[pre + fmt.format(i)]
            out[i].copy_(w.t() if linear else w)
        return out

    layers = {
        "attn_norm": stacked("layers.{}.input_layernorm.weight", False),
        "wq": stacked("layers.{}.self_attn.q_proj.weight", True),
        "wk": stacked("layers.{}.self_attn.k_proj.weight", True),
        "wv": stacked("layers.{}.self_attn.v_proj.weight", True),
        "wo": stacked("layers.{}.self_attn.o_proj.weight", True),
        "ffn_norm": stacked("layers.{}.post_attention_layernorm.weight", False),
        "w1": stacked("layers.{}.mlp.gate_proj.weight", True),
        "w2": stacked("layers.{}.mlp.down_proj.weight", True),
        "w3": stacked("layers.{}.mlp.up_proj.weight", True),
    }
    params = {"embed": put(sd[pre + "embed_tokens.weight"]), "layers": layers,
              "final_norm": put(sd[pre + "norm.weight"])}
    if not cfg.tie_word_embeddings:
        params["lm_head"] = put(sd["lm_head.weight"].t())
    return params


# ---------------------------------------------------------------------------
# RoPE (HF rotate-half convention)


def rope_freqs(cfg: LLaMAConfig, positions: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """positions (...,) int → cos/sin (..., head_dim) float32."""
    half = cfg.head_dim // 2
    exponent = torch.arange(0, half, dtype=torch.float32, device=positions.device) / half
    inv_freq = 1.0 / (cfg.rope_theta ** exponent)
    angles = positions.to(torch.float32)[..., None] * inv_freq  # (..., half)
    angles = torch.cat([angles, angles], dim=-1)  # (..., head_dim)
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x: (..., heads, head_dim); cos/sin broadcast over the head axis."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    rotated = torch.cat([-x2, x1], dim=-1)
    return (x * cos[..., None, :] + rotated * sin[..., None, :]).to(x.dtype)


# ---------------------------------------------------------------------------
# Parameters


def init_params(generator: torch.Generator, cfg: LLaMAConfig, *,
                device: Any = None) -> Dict[str, Any]:
    """Random weights (normal, std 0.02; output projections scaled by
    1/sqrt(2L)) drawn from ``generator`` on ``device`` (the generator's
    own device when None). The draws cannot reproduce ``jax.random``:
    tests carry JAX weights across with :func:`params_from_numpy`."""
    device = torch.device(device) if device is not None else generator.device
    L, D, Fd = cfg.num_hidden_layers, cfg.hidden_size, cfg.intermediate_size
    H, KV, dk = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    dt = cfg.dtype

    def draw(std, shape):
        return (torch.randn(shape, generator=generator, dtype=torch.float32,
                            device=device) * std).to(dt)

    def norm_init(std, shape):
        if len(shape) == 2:
            return draw(std, shape)
        # stacked layers: one layer at a time bounds the f32 temporary
        return torch.stack([draw(std, shape[1:]) for _ in range(shape[0])])

    def ones(shape):
        return torch.ones(shape, dtype=dt, device=device)

    std = 0.02
    params = {
        "embed": norm_init(std, (cfg.vocab_size, D)),
        "layers": {
            "attn_norm": ones((L, D)),
            "wq": norm_init(std, (L, D, H * dk)),
            "wk": norm_init(std, (L, D, KV * dk)),
            "wv": norm_init(std, (L, D, KV * dk)),
            "wo": norm_init(std / math.sqrt(2 * L), (L, H * dk, D)),
            "ffn_norm": ones((L, D)),
            "w1": norm_init(std, (L, D, Fd)),
            "w2": norm_init(std / math.sqrt(2 * L), (L, Fd, D)),
            "w3": norm_init(std, (L, D, Fd)),
        },
        "final_norm": ones((D,)),
    }
    if not cfg.tie_word_embeddings:
        params["lm_head"] = norm_init(std, (D, cfg.vocab_size))
    return params


# ---------------------------------------------------------------------------
# Forward helpers


def _rms(x, gamma, eps):
    xf = x.to(torch.float32)
    r = torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return (xf * r).to(x.dtype) * gamma


def _mm(x, w):
    # bf16 products accumulate in f32 inside the GEMM and round once to
    # x's dtype, as the JAX package's preferred_element_type=f32 + cast; a
    # weight-only quantized {"q", "scale"} weight goes through
    # kernels.wq_matmul (the dequantizing kernel on the GPU)
    if is_quantized(w):
        from ..serve.kernels import quant_mm

        return quant_mm(x, w)
    return torch.matmul(x, w).to(x.dtype)


# ---------------------------------------------------------------------------
# The LM head: f32 logits from the model-dtype hidden state


def _mm_f32(a, b):
    """a @ b of bf16 operands with an f32 result: cuBLAS with f32
    accumulation, neither operand copied to f32 (the JAX package's
    preferred_element_type=f32 product, which it leaves to XLA)."""
    return torch.mm(a, b, out_dtype=torch.float32)


def split_hi_lo(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """An f32 tensor as a pair of bf16 tensors with ``hi + lo`` equal to
    it to ~2^-16 relative (the split the flash kernels take for p and
    ds)."""
    hi = g.to(torch.bfloat16)
    return hi, (g - hi.to(torch.float32)).to(torch.bfloat16)


def head_backward_split(x, head, g, mm=_mm_f32, need=(True, True)):
    """The LM head's gradients from f32 dlogits ``g`` (N, V), the hidden
    state ``x`` (N, D) and ``head`` (D, V), both bf16: ``g`` split into
    bf16 ``hi + lo`` (:func:`split_hi_lo`), then dx = hi·headᵀ + lo·headᵀ
    and dW = xᵀ·hi + xᵀ·lo, each product of bf16 operands with an f32
    result (``mm``). Returns f32 (dx, dW), None where ``need`` says so.
    The split keeps g to ~2^-16, far below the bf16 rounding of dx and
    dW that follows."""
    hi, lo = split_hi_lo(g)
    dx = mm(hi, head.T) + mm(lo, head.T) if need[0] else None
    dw = mm(x.T, hi) + mm(x.T, lo) if need[1] else None
    return dx, dw


def _head_on_tensor_cores(x, head) -> bool:
    return (x.device.type == "cuda" and x.dtype == torch.bfloat16
            and head.dtype == torch.bfloat16)


class _LMHead(torch.autograd.Function):
    """logits (..., V) f32 = x (..., D) @ head (D, V). bf16 x and head
    on a GPU: products of the bf16 operands with f32 results, forward
    and backward (:func:`head_backward_split`); the (D, V) head is never
    copied to f32. Anything else (an f32 model, CPU tensors): the f32
    product of the operands cast to f32, and its gradients cast back."""

    @staticmethod
    def forward(ctx, x, head):
        ctx.save_for_backward(x, head)
        x2 = x.reshape(-1, x.shape[-1])
        if _head_on_tensor_cores(x, head):
            out = _mm_f32(x2, head)
        else:
            out = torch.mm(x2.to(torch.float32), head.to(torch.float32))
        return out.reshape(*x.shape[:-1], head.shape[1])

    @staticmethod
    def backward(ctx, g):
        x, head = ctx.saved_tensors
        x2, g2 = x.reshape(-1, x.shape[-1]), g.reshape(-1, g.shape[-1]).to(torch.float32)
        need = ctx.needs_input_grad[:2]
        with torch.profiler.record_function("lm_head.backward"):
            if _head_on_tensor_cores(x, head):
                dx, dw = head_backward_split(x2, head, g2, need=need)
            else:
                dx = torch.mm(g2, head.to(torch.float32).T) if need[0] else None
                dw = torch.mm(x2.to(torch.float32).T, g2) if need[1] else None
            return (None if dx is None else dx.to(x.dtype).reshape(x.shape),
                    None if dw is None else dw.to(head.dtype))


def lm_head(x: torch.Tensor, head: torch.Tensor) -> torch.Tensor:
    """f32 logits of the hidden state ``x`` (..., D) under ``head``
    (D, V), differentiable (:class:`_LMHead`)."""
    with torch.profiler.record_function("lm_head"):
        return _LMHead.apply(x, head)


# ---------------------------------------------------------------------------
# Serving path (KV cache). One step function serves prefill (chunk C>1)
# and incremental decode (C=1), all sharing the same KV buffers.


def init_kv_cache(
    cfg: LLaMAConfig, num_slots: int, max_len: int, dtype=None, *, device: Any = None
) -> Dict[str, torch.Tensor]:
    """KV cache: (L, slots, max_len+1, KV, dk). The last position is a
    scratch row — padding tokens scatter there so real cache lines are
    never corrupted. The step functions update these tensors in place."""
    L, KV, dk = cfg.num_hidden_layers, cfg.num_key_value_heads, cfg.head_dim
    dt = dtype or cfg.dtype
    shape = (L, num_slots, max_len + 1, KV, dk)
    return {
        "k": torch.zeros(shape, dtype=dt, device=device),
        "v": torch.zeros(shape, dtype=dt, device=device),
    }


def serve_attention(cfg: LLaMAConfig, q, k_cache, v_cache, mask):
    """Grouped-query attention of q (R, C, H, dk) against the full cache
    (R, S, KV, dk) without materialising the GQA head repeat: q is viewed
    as (R, C, KV, G, dk) and contracted per KV group. A row with nothing
    to attend gives the mean of V (softmax over all -1e30 scores); only
    padding rows meet that case and their outputs are never read."""
    R, C, H, dk = q.shape
    KV = cfg.num_key_value_heads
    G = H // KV
    qg = q.reshape(R, C, KV, G, dk)
    scores = torch.einsum(
        "rckgd,rskd->rkgcs", qg.to(torch.float32), k_cache.to(torch.float32)
    ) / math.sqrt(cfg.head_dim)
    scores = torch.where(mask[:, None, None], scores, -1e30)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    dt = torch.promote_types(q.dtype, v_cache.dtype)
    out = torch.einsum("rkgcs,rskd->rckgd", probs.to(dt), v_cache.to(dt))
    return out.reshape(R, C, H * dk)


def _qkv(cfg: LLaMAConfig, p, x):
    """A block's attention norm and Q/K/V projections, before RoPE:
    (R, C, H, dk), (R, C, KV, dk), (R, C, KV, dk)."""
    R, C, _ = x.shape
    H, KV, dk = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    h = _rms(x, p["attn_norm"], cfg.rms_norm_eps)
    return (_mm(h, p["wq"]).reshape(R, C, H, dk),
            _mm(h, p["wk"]).reshape(R, C, KV, dk),
            _mm(h, p["wv"]).reshape(R, C, KV, dk))


def _out_and_ffn(cfg: LLaMAConfig, p, x, attn):
    """A block's output projection of ``attn`` (R, C, H*dk), residual,
    FFN norm, SwiGLU FFN and residual."""
    x = x + _mm(attn, p["wo"])
    h2 = _rms(x, p["ffn_norm"], cfg.rms_norm_eps)
    ffn = _mm(F.silu(_mm(h2, p["w1"])) * _mm(h2, p["w3"]), p["w2"])
    return x + ffn


def _head(cfg: LLaMAConfig, params, x, logits_idx, all_logits: bool):
    """Final norm and f32 LM head (:func:`lm_head`), at ``logits_idx``
    (R,) or, with ``all_logits``, at every chunk column."""
    x = _rms(x, params["final_norm"], cfg.rms_norm_eps)
    head = params["embed"].T if cfg.tie_word_embeddings else params["lm_head"]
    if not all_logits:
        x = x[torch.arange(x.shape[0], device=x.device), logits_idx.long()]  # (R, D)
    return lm_head(x, head)


def decode_seq_lens(mask, positions, S1: int):
    """The lines each slot's decode token attends, for the dense decode
    kernel: the count of its mask row, and 0 for a padding row (its cache
    position the scratch line S1 - 1). A padding row's output is never
    read, and attention is per slot, so this moves no live row's bits:
    its output is zeros, where the JAX package and ``kernels="torch"``
    walk the whole cache for it. mask (R, 1, S1) bool, positions (R, 1)
    → (R,) int32, computed on the device."""
    lens = mask[:, 0, :].sum(dim=-1)
    return torch.where(positions[:, 0] == S1 - 1, 0, lens).to(torch.int32)


def serve_block(cfg: LLaMAConfig, p, x, cos, sin, mask, k_cache, v_cache,
                positions, kernels: str = "torch", bits=None):
    """One transformer block on a serving step: project, RoPE, write the
    new K/V into ``k_cache``/``v_cache`` (one layer's (R, S1, KV, dk)
    views) IN PLACE at ``positions`` (cache line indices), attend over
    the whole cache. ``kernels="cuda"`` routes attention through the
    hand-written kernels (serve/kernels.py: decode for C == 1, its
    padding rows attending nothing (:func:`decode_seq_lens`), verify
    otherwise, on ``bits``, the step's mask packed by
    ``kernels.pack_mask_bits``, when given). Returns the block's
    output."""
    R, C, _ = x.shape
    H, dk = cfg.num_attention_heads, cfg.head_dim
    q, k, v = _qkv(cfg, p, x)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    bidx = torch.arange(R, device=x.device)[:, None]
    k_cache[bidx, positions] = k.to(k_cache.dtype)
    v_cache[bidx, positions] = v.to(v_cache.dtype)
    if kernels == "cuda":
        from ..serve import kernels as _k

        if C == 1:
            seq_lens = decode_seq_lens(mask, positions, k_cache.shape[1])
            attn = _k.decode_attention(q[:, 0].contiguous(), k_cache, v_cache,
                                       seq_lens)
            attn = attn.reshape(R, 1, H * dk)
        elif bits is not None:
            attn = _k.verify_attention_bits(q, k_cache, v_cache, bits, k_cache.shape[1])
            attn = attn.reshape(R, C, H * dk)
        else:
            attn = _k.verify_attention(q, k_cache, v_cache, mask)
            attn = attn.reshape(R, C, H * dk)
    elif kernels == "torch":
        attn = serve_attention(cfg, q, k_cache, v_cache, mask)
    else:
        raise ValueError(f"unknown kernels {kernels!r} (expected 'cuda' or 'torch')")
    return _out_and_ffn(cfg, p, x, attn)


def serve_step(
    params: Dict[str, Any],
    cache: Dict[str, torch.Tensor],
    tokens: torch.Tensor,     # (R, C) int; padding points at scratch pos
    positions: torch.Tensor,  # (R, C) int RoPE/sequence positions
    logits_idx: torch.Tensor, # (R,) int chunk index whose logits to return
    mask: Optional[torch.Tensor],  # (R, C, S+1) bool, or None => causal
    cache_positions: Optional[torch.Tensor] = None,  # (R, C) cache line idx
    *,
    cfg: LLaMAConfig,
    all_logits: bool = False,
    kernels: str = "torch",
    num_layers: Optional[int] = None,
):
    """One serving step over R request slots × C tokens each.

    ``cache_positions`` defaults to ``positions`` (they differ for tree
    tokens, whose siblings share a position but need distinct lines).

    ``num_layers`` runs a layer-sliced step: only the first
    ``num_layers`` blocks run and commit K/V (the deeper layers' cache is
    left untouched), then the full model's final norm and head read the
    truncated hidden state — SpecInfer's early-exit draft
    (``SpecConfig.draft="early_exit"``). None runs the full stack.

    Returns (logits, cache): logits float32 (R, V) at ``logits_idx``, or
    (R, C, V) when ``all_logits``. ``cache`` is the dict that was passed
    in, its tensors updated in place.
    """
    S1 = cache["k"].shape[2]  # max_len + 1 (scratch row)
    if cache_positions is None:
        cache_positions = positions
    positions = positions.long()
    cache_positions = cache_positions.long()
    x = params["embed"][tokens.long()]
    cos, sin = rope_freqs(cfg, positions)
    if mask is None:
        from ..serve.kernels import causal_serve_mask

        mask = causal_serve_mask(positions, S1)
    bits = None
    if kernels == "cuda" and tokens.shape[1] > 1:
        from ..serve.kernels import pack_mask_bits

        bits = pack_mask_bits(mask)  # once for every layer's verify launch
    layers = params["layers"]
    for l in range(_depth(cfg, num_layers)):
        p_l = layer_params(layers, l)
        x = serve_block(cfg, p_l, x, cos, sin, mask, cache["k"][l],
                        cache["v"][l], cache_positions, kernels, bits)
    return _head(cfg, params, x, logits_idx, all_logits), cache


def _depth(cfg: LLaMAConfig, num_layers: Optional[int]) -> int:
    """The blocks a step runs: all of them, or the first ``num_layers``."""
    if num_layers is None:
        return cfg.num_hidden_layers
    if num_layers < 1:
        raise ValueError(f"num_layers must be >= 1 (got {num_layers})")
    return min(num_layers, cfg.num_hidden_layers)


# ---------------------------------------------------------------------------
# Serving path over the paged KV cache (ServingConfig.kv_layout="paged"):
# K/V live in a page pool read and written through a per-slot page table
# (serve/paging.py). ``kernels="torch"`` gathers the virtual cache and
# runs the exact dense ``serve_attention`` math; ``kernels="cuda"`` runs
# the hand-written ragged paged kernel, which reads the pages in place.

#: decode-step fusions this family's serving step supports
#: (ServingConfig.fused_decode): "rope_kv_write" folds RoPE and the KV
#: page write into the paged attention kernel
#: (serve/kernels.fused_rope_paged_attention); "whole_step" runs the
#: whole step in one kernel (:func:`serve_step_whole`).
FUSED_DECODE = ("rope_kv_write", "whole_step")


def init_paged_kv_cache(cfg: LLaMAConfig, num_pages: int, page_size: int,
                        dtype=None, kv_quant: Optional[str] = None, *,
                        device: Any = None) -> Dict[str, torch.Tensor]:
    """Paged pool: (L, num_pages+1, page_size, KV, dk). Pool row
    ``num_pages`` is the shared scratch page: unallocated table entries
    point there, so padding writes never touch live pages.

    With ``kv_quant`` (serve/kv_quant.py) the pools store int8 codes, or
    int4 codes packed two per uint8 along dk (trailing dim
    ``head_dim // 2``), and the cache gains ``k_scale``/``v_scale``:
    (L, num_pages+1, KV) f32 per-page-per-KV-head scales, zero (a page
    with no committed lines). The step functions update all of it in
    place."""
    L, KV, dk = cfg.num_hidden_layers, cfg.num_key_value_heads, cfg.head_dim
    dt = dtype or cfg.dtype
    spec = None
    if kv_quant is not None:
        from ..serve.kv_quant import resolve_spec

        spec = resolve_spec(kv_quant)
        dt = spec.dtype
        if dk % spec.pack:
            raise ValueError(
                f"kv_quant={kv_quant!r} packs {spec.pack} codes per element "
                f"along head_dim, which needs head_dim ({dk}) divisible by "
                f"{spec.pack}"
            )
        dk //= spec.pack
    shape = (L, num_pages + 1, page_size, KV, dk)
    cache = {"k": torch.zeros(shape, dtype=dt, device=device),
             "v": torch.zeros(shape, dtype=dt, device=device)}
    if spec is not None:
        sshape = (L, num_pages + 1, KV)
        cache["k_scale"] = torch.zeros(sshape, dtype=torch.float32, device=device)
        cache["v_scale"] = torch.zeros(sshape, dtype=torch.float32, device=device)
    return cache


def _page_lookup(page_table: torch.Tensor, cache_positions: torch.Tensor,
                 page_size: int):
    """(R, NP) table × (R, C) cache lines → physical page and in-page
    offset, each (R, C) int64."""
    logical = cache_positions // page_size
    phys = torch.gather(page_table.long(), 1, logical)
    return phys, cache_positions % page_size


def _block_paged_torch(cfg: LLaMAConfig, p, x, cos, sin, mask, k_pool, v_pool,
                       phys, off, page_table, k_scale=None, v_scale=None,
                       qmax=None):
    """One block of the ``kernels="torch"`` paged step (the JAX package's
    ``_block_paged_xla``): project, RoPE, commit K/V at the table-resolved
    (page, offset) in place, gather — and dequantize — the virtual cache
    through the table, attend with :func:`serve_attention`, out-project,
    FFN."""
    from ..serve import kernels as _k

    q, k, v = _qkv(cfg, p, x)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    _k.commit_paged(k_pool, v_pool, k, v, phys, off, k_scale, v_scale, qmax,
                    kernels="torch")
    if qmax is not None:
        k_virt = _k.dequant_pages(k_pool, k_scale, page_table, q.dtype)
        v_virt = _k.dequant_pages(v_pool, v_scale, page_table, q.dtype)
    else:
        k_virt = _k.gather_pages(k_pool, page_table)
        v_virt = _k.gather_pages(v_pool, page_table)
    return _out_and_ffn(cfg, p, x, serve_attention(cfg, q, k_virt, v_virt, mask))


def serve_block_paged(cfg: LLaMAConfig, p, x, cos, sin, mask, k_pool, v_pool,
                      phys, off, page_table, kernels: str = "torch",
                      k_scale=None, v_scale=None, qmax=None, *,
                      fused_rope: bool = False, logical=None):
    """One block on a paged serving step: write the new K/V at the
    table-resolved (physical page, offset) — quantizing at the page
    scales when ``qmax`` is set — and attend over the virtual cache read
    through the page table. Pools and scales (one layer's views) are
    updated in place. Returns the block's output.

    ``kernels="cuda"``: attention runs in the ragged paged kernel; with
    ``fused_rope`` RoPE and the K/V commit move into the same kernel
    (serve/kernels.fused_rope_paged_attention, which takes ``logical``
    and ``off`` as int32). ``kernels="torch"`` ignores ``fused_rope``:
    the unfused step is the reference every fusion is held to."""
    if kernels == "torch":
        return _block_paged_torch(cfg, p, x, cos, sin, mask, k_pool, v_pool,
                                  phys, off, page_table, k_scale, v_scale, qmax)
    if kernels != "cuda":
        raise ValueError(f"unknown kernels {kernels!r} (expected 'cuda' or 'torch')")
    from ..serve import kernels as _k

    R, C, _ = x.shape
    q, k, v = _qkv(cfg, p, x)
    if fused_rope:
        attn = _k.fused_rope_paged_attention(
            q, k, v, cos, sin, k_pool, v_pool, page_table, logical.to(torch.int32),
            off.to(torch.int32), mask, k_scale=k_scale, v_scale=v_scale, qmax=qmax)
    else:
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
        _k.commit_paged(k_pool, v_pool, k, v, phys, off, k_scale, v_scale, qmax)
        attn = _k.ragged_paged_attention(q, k_pool, v_pool, page_table, mask,
                                         k_scale=k_scale, v_scale=v_scale)
    return _out_and_ffn(cfg, p, x, attn.reshape(R, C, -1))


def serve_step_paged(
    params: Dict[str, Any],
    cache: Dict[str, torch.Tensor],
    tokens: torch.Tensor,     # (R, C) int
    positions: torch.Tensor,  # (R, C) int RoPE/sequence positions
    logits_idx: torch.Tensor, # (R,) int
    mask: Optional[torch.Tensor],  # (R, C, cache_len+1) bool, or None => causal
    cache_positions: Optional[torch.Tensor],  # (R, C) cache line idx
    page_table: torch.Tensor,  # (R, NP) int32
    *,
    cfg: LLaMAConfig,
    cache_len: int,
    all_logits: bool = False,
    kernels: str = "torch",
    kv_quant: Optional[str] = None,
    fused_rope: bool = False,
    num_layers: Optional[int] = None,
):
    """Paged twin of :func:`serve_step`: the same contract plus the
    per-slot page table; prefill chunks, decode and explicit-mask steps
    all read and write K/V through the table. ``kv_quant`` selects the
    quantized pool layout (the commit quantizes in the step, attention
    dequantizes at read time); ``fused_rope`` folds RoPE and the K/V
    page write into the CUDA kernel; ``num_layers`` is the early-exit
    slice of :func:`serve_step` (the deeper pools and scales untouched).
    Returns (logits, cache), the cache tensors updated in place."""
    if cache_positions is None:
        cache_positions = positions
    positions = positions.long()
    cache_positions = cache_positions.long()
    ps = cache["k"].shape[2]
    x = params["embed"][tokens.long()]
    cos, sin = rope_freqs(cfg, positions)
    from ..serve.kernels import paged_serve_mask

    mask = paged_serve_mask(mask, positions, page_table.shape[1], ps, cache_len)
    phys, off = _page_lookup(page_table, cache_positions, ps)
    logical = cache_positions // ps
    qmax = None
    if kv_quant is not None:
        from ..serve.kv_quant import resolve_spec

        qmax = resolve_spec(kv_quant).qmax
    layers = params["layers"]
    for l in range(_depth(cfg, num_layers)):
        p_l = layer_params(layers, l)
        scales = ((cache["k_scale"][l], cache["v_scale"][l]) if qmax is not None
                  else (None, None))
        x = serve_block_paged(cfg, p_l, x, cos, sin, mask, cache["k"][l],
                              cache["v"][l], phys, off, page_table, kernels,
                              *scales, qmax, fused_rope=fused_rope, logical=logical)
    return _head(cfg, params, x, logits_idx, all_logits), cache


def serve_debug_activations(
    params: Dict[str, Any],
    cache: Dict[str, torch.Tensor],
    tokens: torch.Tensor,
    positions: torch.Tensor,
    mask: Optional[torch.Tensor],
    cache_positions: Optional[torch.Tensor] = None,
    *,
    cfg: LLaMAConfig,
    kernels: str = "torch",
    page_table: Optional[torch.Tensor] = None,
    cache_len: Optional[int] = None,
    kv_quant: Optional[str] = None,
) -> List[torch.Tensor]:
    """Per-layer hidden states of one serving step, for
    ``inference_debugging`` (the reference's per-op tensor dumps): the
    step's blocks one by one — :func:`serve_block` on the dense layout,
    the unfused :func:`serve_block_paged` through ``page_table`` on the
    paged one (``kv_quant``: the quantized pools) — with ``kernels`` as
    the step runs them, each layer's output kept. The cache is left as it
    was: each layer's block commits its K/V (and, quantized, its page
    scales) into clones of that layer's tensors, made one layer at a time
    so that a capture never holds two caches; the engine's step does the
    real commit after. Slow by design: a triage tool, not a serving
    path. Returns one (R, C, D) tensor a layer."""
    if cache_positions is None:
        cache_positions = positions
    positions = positions.long()
    cache_positions = cache_positions.long()
    x = params["embed"][tokens.long()]
    cos, sin = rope_freqs(cfg, positions)
    layers = params["layers"]
    acts = []
    if page_table is not None:  # the paged layout
        from ..serve.kernels import paged_serve_mask

        ps = cache["k"].shape[2]
        mask = paged_serve_mask(mask, positions, page_table.shape[1], ps, cache_len)
        phys, off = _page_lookup(page_table, cache_positions, ps)
        qmax = None
        if kv_quant is not None:
            from ..serve.kv_quant import resolve_spec

            qmax = resolve_spec(kv_quant).qmax
        for l in range(cfg.num_hidden_layers):
            p_l = layer_params(layers, l)
            scales = ((cache["k_scale"][l].clone(), cache["v_scale"][l].clone())
                      if qmax is not None else (None, None))
            x = serve_block_paged(cfg, p_l, x, cos, sin, mask, cache["k"][l].clone(),
                                  cache["v"][l].clone(), phys, off, page_table, kernels,
                                  *scales, qmax)
            acts.append(x)
        return acts
    S1 = cache["k"].shape[2]
    if mask is None:
        from ..serve.kernels import causal_serve_mask

        mask = causal_serve_mask(positions, S1)
    bits = None
    if kernels == "cuda" and tokens.shape[1] > 1:
        from ..serve.kernels import pack_mask_bits

        bits = pack_mask_bits(mask)
    for l in range(cfg.num_hidden_layers):
        p_l = layer_params(layers, l)
        x = serve_block(cfg, p_l, x, cos, sin, mask, cache["k"][l].clone(),
                        cache["v"][l].clone(), cache_positions, kernels, bits)
        acts.append(x)
    return acts


# ---------------------------------------------------------------------------
# K/V line moves: SpecInfer's commit of an accepted tree path and beam
# search's reorder of hypotheses across slots. Each gathers its source
# lines into a temporary before it writes, so overlapping source and
# destination lines are safe; scratch-to-scratch entries rewrite the
# scratch line with itself. The cache tensors are updated in place: a
# commit moves every layer's lines in one statement (a few lines a slot),
# a reorder copies one layer at a time (the temporary is one layer's slots).
#
# The same functions serve the generic decoder (models/transformer.py),
# whose ALiBi and sliding-window caches carry a buffer "pos": the
# sequence position of every line, (slots, max_len + 1) dense and
# (num_pages + 1, page_size) paged, with no layer dim. It moves with the
# lines it describes.

#: the generic decoder's per-line position buffer (no layer dim)
POS = "pos"


def _layers(name: str, buf: torch.Tensor):
    """The per-layer views of cache buffer ``name``: the position buffer
    is one "layer" of its own."""
    return (buf,) if name == POS else buf


def commit_kv(cache: Dict[str, torch.Tensor], src: torch.Tensor,
              dst: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Move accepted speculative K/V lines to their committed positions
    on the dense cache: slot r's line ``src[r, k]`` goes to ``dst[r, k]``
    (src, dst (R, K) int; unused entries scratch to scratch). Returns
    ``cache``."""
    src, dst = src.long(), dst.long()
    bidx = torch.arange(src.shape[0], device=src.device)[:, None]
    for name, buf in cache.items():
        if name == POS:  # (R, S1)
            buf[bidx, dst] = buf[bidx, src]
        else:            # (L, R, S1, KV, dk)
            buf[:, bidx, dst] = buf[:, bidx, src]
    return cache


def reorder_slots(cache: Dict[str, torch.Tensor],
                  src: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Slot gather of the dense cache: new slot r holds old slot
    ``src[r]``'s lines (beam search's hypothesis reorder). Only the slots
    that change are copied. Returns ``cache``."""
    src = src.long()
    moved = torch.nonzero(src != torch.arange(src.shape[0], device=src.device))[:, 0]
    if moved.numel():
        for name, buf in cache.items():  # (L, R, S1, KV, dk); pos (R, S1)
            for layer in _layers(name, buf):
                layer[moved] = layer[src[moved]]
    return cache


def commit_kv_paged(cache: Dict[str, torch.Tensor], page_table: torch.Tensor,
                    src: torch.Tensor, dst: torch.Tensor, *,
                    kv_quant: Optional[str] = None,
                    kernels: str = "torch") -> Dict[str, torch.Tensor]:
    """:func:`commit_kv` through the page table: the lines move between
    table-resolved (page, offset) pairs. On a quantized pool the codes
    cannot move verbatim (source and destination pages carry different
    scales): the lines are dequantized at their source page's scale and
    committed again as a fresh write would be
    (``serve/kv_quant.quant_commit_lines``; the commit kernel on CUDA
    tensors with ``kernels="cuda"``). Returns ``cache``."""
    ps = cache["k"].shape[2]
    s_phys, s_off = _page_lookup(page_table, src.long(), ps)
    d_phys, d_off = _page_lookup(page_table, dst.long(), ps)
    if kv_quant is not None:
        from ..serve.kv_quant import quant_commit_lines, resolve_spec

        quant_commit_lines(cache["k"], cache["v"], cache["k_scale"], cache["v_scale"],
                           s_phys, s_off, d_phys, d_off, resolve_spec(kv_quant).qmax,
                           kernels=kernels)
        if POS in cache:  # exact metadata: moves verbatim
            cache[POS][d_phys, d_off] = cache[POS][s_phys, s_off]
        return cache
    for name, buf in cache.items():
        if name == POS:  # (P+1, ps)
            buf[d_phys, d_off] = buf[s_phys, s_off]
        else:            # (L, P+1, ps, KV, dk)
            buf[:, d_phys, d_off] = buf[:, s_phys, s_off]
    return cache


def copy_page_kv(cache: Dict[str, torch.Tensor], src: int, dst: int) -> Dict[str, torch.Tensor]:
    """Copy one physical page's content to another page in place, every
    cache buffer (K/V pools and the quantized layout's (L, P+1, KV) scale
    rows): the device half of prefix-cache copy-on-write. Codes and their
    scales move together, byte for byte."""
    for name, buf in cache.items():
        if name == POS:  # (P+1, ps)
            buf[dst].copy_(buf[src])
        else:
            buf[:, dst].copy_(buf[:, src])
    return cache


def gather_page_kv(cache: Dict[str, torch.Tensor], page: int) -> Dict[str, torch.Tensor]:
    """One physical page's content out of every cache buffer, as fresh
    tensors (never views of the pool): the device half of a host-tier
    spill, which must survive the page being freed and reused."""
    return {name: (buf[page] if name == POS else buf[:, page]).clone(
        memory_format=torch.contiguous_format) for name, buf in cache.items()}


def scatter_page_kv(cache: Dict[str, torch.Tensor], page: int,
                    values: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Write a spilled page's content (what :func:`gather_page_kv`
    returned) into pool row ``page`` in place: the device half of a
    host-tier re-admit, byte for byte its inverse."""
    for name, buf in cache.items():
        (buf[page] if name == POS else buf[:, page]).copy_(values[name])
    return cache


def reorder_slots_paged(cache: Dict[str, torch.Tensor], page_table: torch.Tensor,
                        src: torch.Tensor) -> Dict[str, torch.Tensor]:
    """:func:`reorder_slots` for the paged layout: page ownership stays
    with each slot (the host table is untouched) and page content is
    copied — new slot r's pages receive slot ``src[r]``'s, scales
    included. The destination slots must hold at least the source slots'
    pages, which beam search guarantees (equal-length hypotheses). Only
    the slots that change are copied; a table entry past a slot's pages
    points at the scratch page, which may receive any source page's
    content. Returns ``cache``."""
    src = src.long()
    moved = torch.nonzero(src != torch.arange(src.shape[0], device=src.device))[:, 0]
    if moved.numel():
        table = page_table.long()
        src_pages = table[src[moved]].reshape(-1)
        dst_pages = table[moved].reshape(-1)
        for name, buf in cache.items():  # (L, P+1, ...); pos (P+1, ps)
            for layer in _layers(name, buf):
                layer[dst_pages] = layer[src_pages]
    return cache


# ---------------------------------------------------------------------------
# Whole-step serving (ServingConfig.fused_decode=("whole_step",);
# serve/kernels.whole_step_decode carries the kernel's design). The
# family's half: the weight layout the walk streams, and the step entry
# point binding this family's block and head math — the same
# _block_paged_torch body the unfused step runs.


def whole_step_weight_layout(params: Dict[str, Any], cfg: LLaMAConfig):
    """``(layer_arrays, head_arrays)``: every per-layer tensor as its
    stacked (L, …) array (the storage layout already: validated and
    named, nothing copied) and the epilogue params. Raises ValueError for
    a layout the walk cannot stream, so the engine fails at construction
    and never mid-serve."""
    L = cfg.num_hidden_layers
    if getattr(params["layers"], "offloaded", False):
        raise ValueError(OFFLOAD_WHOLE_STEP)
    layer_arrays = {}
    for name, a in params["layers"].items():
        if isinstance(a, dict):
            raise ValueError(
                "whole_step is not composed with weight-only quantization (layer "
                f"tensor {name!r} is a quantized pair): serve full-precision params "
                "or drop the whole_step fusion")
        if a.shape[0] != L:
            raise ValueError(f"layer tensor {name!r} leading dim {a.shape[0]} != "
                             f"num_hidden_layers {L}")
        layer_arrays[name] = a
    head_arrays = {"final_norm": params["final_norm"]}
    if cfg.tie_word_embeddings:
        head_arrays["embed"] = params["embed"]
    else:
        if isinstance(params["lm_head"], dict):
            raise ValueError("whole_step is not composed with a weight-only quantized lm_head")
        head_arrays["lm_head"] = params["lm_head"]
    return layer_arrays, head_arrays


def _whole_head_fn(cfg: LLaMAConfig, head, x, logits_idx):
    """The walk's epilogue, op for op :func:`serve_step_paged`'s tail
    (final norm, the logits_idx row, f32 LM head)."""
    return _head(cfg, head, x, logits_idx, all_logits=False)


def _whole_head_all_fn(cfg: LLaMAConfig, head, x, logits_idx):
    """The all-positions epilogue of the speculation fold, op for op
    :func:`serve_step_paged`'s ``all_logits=True`` tail (final norm, f32 LM
    head over every chunk column; ``logits_idx`` unread): a verify step
    needs logits at every tree node, a draft step at every frontier
    column."""
    return _head(cfg, head, x, logits_idx, all_logits=True)


def whole_step_tile_roles(cfg: LLaMAConfig) -> Dict[str, Tuple[str, Optional[str]]]:
    """The weight (and bias: none in LLaMA) behind each role the kernel
    splits into output-column tiles: w1 gates, w3 lifts, w2 closes."""
    return {"q": ("wq", None), "k": ("wk", None), "v": ("wv", None),
            "o": ("wo", None), "gate": ("w1", None), "up": ("w3", None),
            "down": ("w2", None)}


def whole_step_body(cfg: LLaMAConfig):
    """What the whole-step kernel computes between the roles' projections
    (serve/kernels.WholeBody): RMS norms, SiLU gating, a sequential block."""
    from ..serve.kernels import WholeBody

    return WholeBody(norm="rms", eps=cfg.rms_norm_eps, attn_norm=("attn_norm", None),
                     mlp_norm=("ffn_norm", None), final_norm=("final_norm", None),
                     activation="silu")


def serve_step_whole(
    params: Dict[str, Any],
    cache: Dict[str, torch.Tensor],
    tokens: torch.Tensor,      # (R, C) int — C=1 decode, C>1 mixed
    positions: torch.Tensor,   # (R, C) int
    logits_idx: torch.Tensor,  # (R,) int
    page_table: torch.Tensor,  # (R, NP) int32
    *,
    cfg: LLaMAConfig,
    cache_len: int,
    kv_quant: Optional[str] = None,
    tiles: int = 1,
    kernels: str = "torch",
    stamps: Optional[torch.Tensor] = None,
    mask: Optional[torch.Tensor] = None,             # (R, C, cache_len+1) bool
    cache_positions: Optional[torch.Tensor] = None,  # (R, C) cache lines
    all_logits: bool = False,
    num_layers: Optional[int] = None,
):
    """The whole paged serving step in one kernel: every layer (Q/K/V,
    RoPE and the K/V page commit, paged attention, out-projection, SwiGLU
    MLP), the final norm, the LM head at ``logits_idx`` and the greedy
    argmax. The embedding, RoPE tables, mask and page lookup run before
    the kernel, as in the JAX package. ``kernels="cuda"`` goes through
    serve/kernels.whole_step_decode (the CUDA kernel on a GPU, its plain
    version on the CPU), ``"torch"`` straight to the plain version;
    ``tiles`` is the engine gate's output-column tile count, which the
    kernel's answer does not depend on; ``stamps`` asks the kernel for its
    per-stage timer (serve/kernels.whole_step_stage_ms).

    The speculation fold takes :func:`serve_step_paged`'s four spec
    keywords with their meaning there: an explicit tree ``mask``,
    ``cache_positions`` (the slack lines a tree's nodes write, which need
    not be contiguous), ``all_logits`` (logits and greedy tokens at every
    chunk column) and ``num_layers`` (the early-exit draft: the walk over
    the first layers' weights and pools; the deeper pools untouched). A
    SpecInfer round's draft and verify steps are then launches of this
    one kernel.

    Returns ``(logits (R, V) f32, greedy tokens (R,) int64, cache)`` —
    with ``all_logits`` ``(R, C, V)`` and ``(R, C)`` — the cache updated in
    place. The plain version runs the ops of :func:`serve_step_paged`
    (``kernels="torch"``, the same keywords) at every tile count, so it is
    bitwise that step."""
    if kernels not in ("cuda", "torch"):
        raise ValueError(f"unknown kernels {kernels!r} (expected 'cuda' or 'torch')")
    from ..serve import kernels as _k

    if cache_positions is None:
        cache_positions = positions
    positions = positions.long()
    ps = cache["k"].shape[2]
    x = params["embed"][tokens.long()]
    cos, sin = rope_freqs(cfg, positions)
    mask = _k.paged_serve_mask(mask, positions, page_table.shape[1], ps, cache_len)
    phys, off = _page_lookup(page_table, cache_positions.long(), ps)
    qmax = None
    if kv_quant is not None:
        from ..serve.kv_quant import resolve_spec

        qmax = resolve_spec(kv_quant).qmax
    layer_arrays, head_arrays = whole_step_weight_layout(params, cfg)
    walk_cache = cache
    n = _depth(cfg, num_layers)
    if n < cfg.num_hidden_layers:
        # the early-exit draft: the walk over the first n layers' weights
        # and pools (leading-dim slices, views of the same storage)
        layer_arrays = {k: a[:n] for k, a in layer_arrays.items()}
        walk_cache = {k: a[:n] for k, a in cache.items()}

    def block_fn(p_l, xv, cs, sn, mk, kb, vb, ks, vs, ph, of, pt):
        return _block_paged_torch(cfg, p_l, xv, cs, sn, mk, kb, vb, ph, of, pt, ks, vs, qmax)

    head_fn = functools.partial(_whole_head_all_fn if all_logits else _whole_head_fn, cfg)
    args = (layer_arrays, head_arrays, x, cos, sin, walk_cache, page_table, phys, off, mask,
            logits_idx)
    if kernels == "cuda":
        logits, toks, _ = _k.whole_step_decode(
            *args, block_fn=block_fn, head_fn=head_fn, tile_roles=whole_step_tile_roles(cfg),
            body=whole_step_body(cfg), qmax=qmax, tiles=tiles, stamps=stamps,
            all_logits=all_logits)
    else:
        logits, toks, _ = _k.whole_step_decode_ref(*args, block_fn=block_fn, head_fn=head_fn)
    return logits, toks.long(), cache


# ---------------------------------------------------------------------------
# Training path: full causal attention over the whole sequence


def attention(cfg: LLaMAConfig, q, k, v, mask):
    """Plain attention of q (B, S, H, dk) — RoPE applied — over k/v (B, T,
    KV, dk), GQA heads repeated; ``mask`` (B, S, T) or (S, T) bool, True =
    attend, or None. f32 scores and softmax, probabilities rounded to q's
    dtype before PV, as the JAX package's ``attention`` (its "xla" path)."""
    H, KV = cfg.num_attention_heads, cfg.num_key_value_heads
    if KV != H:
        k = k.repeat_interleave(H // KV, dim=2)
        v = v.repeat_interleave(H // KV, dim=2)
    scores = torch.einsum("bshd,bthd->bhst", q.to(torch.float32),
                          k.to(torch.float32)) / math.sqrt(cfg.head_dim)
    if mask is not None:
        m = mask if mask.dim() == 3 else mask[None]
        scores = torch.where(m[:, None], scores, -1e30)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhst,bthd->bshd", probs, v)


def block(cfg: LLaMAConfig, p, x, cos, sin, mask, attn_fn=None):
    """One transformer block, training path (full local-sequence
    attention): ``p`` one layer's params, x (B, S, D). ``attn_fn``
    overrides :func:`attention` (see :func:`make_flash_attention`).
    Returns the block's output."""
    B, S, _ = x.shape
    q, k, v = _qkv(cfg, p, x)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    attn = (attn_fn or attention)(cfg, q, k, v, mask)
    return _out_and_ffn(cfg, p, x, attn.reshape(B, S, -1))


def causal_mask(S: int, device: Any = None) -> torch.Tensor:
    return torch.ones((S, S), dtype=torch.bool, device=device).tril()


def make_flash_attention():
    """Causal flash-attention ``attn_fn`` for :func:`block`: the
    hand-written CUDA kernels (forward and backward) of
    ``ops/flash_attention.py``, which never materialise the (B, H, S, S)
    scores. GQA heads are repeated before the call, so autograd sums each
    group's gradients."""
    from ..ops.flash_attention import flash_attention

    def attn_fn(cfg, q, k, v, mask):
        # mask is None by construction (forward() builds none when an
        # attn_fn is given); causality is computed in the kernel
        H, KV = cfg.num_attention_heads, cfg.num_key_value_heads
        if KV != H:
            k = k.repeat_interleave(H // KV, dim=2)
            v = v.repeat_interleave(H // KV, dim=2)
        return flash_attention(q, k, v, causal=True)

    return attn_fn


def forward(params: Dict[str, Any], tokens: torch.Tensor, cfg: LLaMAConfig, *,
            remat: bool = False, remat_policy: Optional[str] = None,
            attn_fn=None) -> torch.Tensor:
    """Training/eval forward: full causal attention over tokens (B, S) at
    positions 0..S-1; returns f32 logits (B, S, V). ``remat`` recomputes
    each block's activations in the backward pass under ``remat_policy``
    (None: all; "dots": all but the matmul outputs)."""
    B, S = tokens.shape
    x = params["embed"][tokens.long()]
    cos, sin = rope_freqs(cfg, torch.arange(S, device=tokens.device).expand(B, S))
    mask = None if attn_fn is not None else causal_mask(S, tokens.device)
    blk = functools.partial(block, cfg, attn_fn=attn_fn)
    if remat:
        from ..core.remat import checkpoint

        blk = checkpoint(blk, remat_policy)
    # unbind: one backward node per stacked weight gathers the L layer
    # gradients at once (a per-layer slice would add a full stack each)
    layers = {name: w.unbind(0) for name, w in params["layers"].items()}
    for l in range(cfg.num_hidden_layers):
        x = blk({name: ws[l] for name, ws in layers.items()}, x, cos, sin, mask)
    x = _rms(x, params["final_norm"], cfg.rms_norm_eps)
    head = params["embed"].T if cfg.tie_word_embeddings else params["lm_head"]
    return lm_head(x, head)


def next_token_loss(params, tokens, cfg, **kw) -> torch.Tensor:
    """Causal LM loss: predict tokens[:, 1:] from tokens[:, :-1]."""
    logits = forward(params, tokens[:, :-1], cfg, **kw)
    targets = tokens[:, 1:].long()
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, targets[..., None])[..., 0]
    return nll.mean()


def make_train_step(cfg: LLaMAConfig, optimizer, *, device: Any = "cuda",
                    remat: bool = True, remat_policy: Optional[str] = None,
                    attention: str = "torch", mesh=None, num_microbatches: int = 1):
    """Build ``(init_fn, step_fn)`` for single-device training on
    ``device`` (a GPU unless the caller asks for the CPU).

    * ``init_fn(generator)`` → ``(params, opt_state)``: random weights from
      ``generator`` (on ``device``) as leaf tensors that require grad, and
      the optimizer's state.
    * ``step_fn(params, opt_state, tokens)`` → ``(params, opt_state,
      loss)``: the next-token loss of tokens (B, S + 1) and its gradients,
      then the optimizer's update, which writes params and state in place.

    ``attention="flash"`` runs the hand-written flash-attention kernels
    (the JAX package's "flash"), ``"torch"`` the plain :func:`attention`
    (its "xla"). ``mesh`` and ``num_microbatches > 1`` raise
    ``NotImplementedError``: parallel training is a later slice."""
    if mesh is not None or num_microbatches != 1:
        raise NotImplementedError(
            "make_train_step runs on one device; mesh and num_microbatches wait "
            "for ROADMAP.md queue 1 item 10 (parallel training: mesh, "
            "microbatching, pipeline, sequence and tensor parallelism)")
    if attention == "flash":
        attn_fn = make_flash_attention()
    elif attention == "torch":
        attn_fn = None
    else:
        raise ValueError(f"unknown attention {attention!r} (expected 'flash' or 'torch')")
    from ..core.remat import resolve_remat_policy
    from ..optimizers import tree_leaves, tree_unflatten
    from ..serve.engine import resolve_device

    resolve_remat_policy(remat_policy)  # an unknown name raises here
    dev = resolve_device(device)

    def init_fn(generator: torch.Generator):
        params = init_params(generator, cfg, device=dev)
        for p in tree_leaves(params):
            p.requires_grad_(True)
        return params, optimizer.init(params)

    def step_fn(params, opt_state, tokens):
        leaves = tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        loss = next_token_loss(params, torch.as_tensor(tokens, device=dev), cfg,
                               remat=remat, remat_policy=remat_policy,
                               attn_fn=attn_fn)
        grads = torch.autograd.grad(loss, leaves)
        params, opt_state = optimizer.update(tree_unflatten(params, grads), opt_state,
                                             params)
        return params, opt_state, loss.detach()

    return init_fn, step_fn


def num_params(cfg: LLaMAConfig) -> int:
    L, D, Fd, V = (cfg.num_hidden_layers, cfg.hidden_size, cfg.intermediate_size,
                   cfg.vocab_size)
    H, KV, dk = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    per_layer = D * (H * dk) + 2 * D * (KV * dk) + (H * dk) * D + 3 * D * Fd + 2 * D
    head = 0 if cfg.tie_word_embeddings else D * V
    return V * D + L * per_layer + D + head


def flops_per_token(cfg: LLaMAConfig, seq_len: int) -> int:
    """Forward FLOPs/token ≈ 2*n_params + attention quadratic term."""
    return 2 * num_params(cfg) + 4 * cfg.num_hidden_layers * cfg.hidden_size * seq_len
