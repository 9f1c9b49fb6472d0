"""LLaMA model family — the serving subset of ``flexflow_tpu/models/llama.py``.

embedding → N × [rms_norm → attention(QKV + RoPE + GQA) → rms_norm →
SwiGLU FFN] → rms_norm → lm_head, served over a dense KV cache.

Layout kept from the JAX package at every public function so tests
compare like with like: weights are ``(in, out)``, stacked on a leading
layer dim ``L``, under the same dict keys; the KV cache is
``(L, slots, max_len + 1, KV, dk)`` with the last line a scratch row.

Differences from the JAX package:
  * the layer stack is a Python loop over per-layer views, not a scan;
  * the KV cache is updated **in place** (the JAX package donates the
    cache buffers and returns new ones; here ``serve_step`` writes into
    the tensors it is given and returns the same dict);
  * ``kernels="cuda"`` routes attention through the hand-written CUDA
    kernels of ``serve/kernels.py`` (the JAX package's ``"pallas"``),
    ``kernels="torch"`` through :func:`serve_attention` (its ``"xla"``).

The training path, pipeline parallelism and the early-exit
``num_layers`` slice of ``serve_step`` come with later slices.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F


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


def _array_to_tensor(a: np.ndarray) -> torch.Tensor:
    a = np.require(a, requirements=["C", "W"])  # torch wants writable memory
    # JAX bf16 arrays reach numpy as ml_dtypes.bfloat16, which
    # torch.from_numpy refuses: reinterpret the bits through uint16.
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def params_from_numpy(tree: Any, *, device: Any,
                      dtype: Optional[torch.dtype] = None) -> Any:
    """Carry a JAX ``init_params`` pytree, given as numpy arrays (nested
    dicts), across to the port's params on ``device``. Keys and layouts
    are unchanged; ``dtype`` casts every leaf when given."""
    if isinstance(tree, dict):
        return {
            k: params_from_numpy(v, device=device, dtype=dtype)
            for k, v in tree.items()
        }
    t = _array_to_tensor(np.asarray(tree))
    if dtype is not None:
        t = t.to(dtype)
    return t.to(device)


# ---------------------------------------------------------------------------
# Forward helpers


def _rms(x, gamma, eps):
    xf = x.to(torch.float32)
    r = torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return (xf * r).to(x.dtype) * gamma


def _mm(x, w):
    # bf16 products accumulate in f32 inside the GEMM and round once to
    # x's dtype, as the JAX package's preferred_element_type=f32 + cast
    return torch.matmul(x, w).to(x.dtype)


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


def serve_block(cfg: LLaMAConfig, p, x, cos, sin, mask, k_cache, v_cache,
                positions, kernels: str = "torch"):
    """One transformer block on a serving step: project, RoPE, write the
    new K/V into ``k_cache``/``v_cache`` (one layer's (R, S1, KV, dk)
    views) IN PLACE at ``positions`` (cache line indices), attend over
    the whole cache. ``kernels="cuda"`` routes attention through the
    hand-written kernels (serve/kernels.py: decode for C == 1, verify
    otherwise). Returns the block's output."""
    R, C, D = x.shape
    H, KV, dk = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    h = _rms(x, p["attn_norm"], cfg.rms_norm_eps)
    q = _mm(h, p["wq"]).reshape(R, C, H, dk)
    k = _mm(h, p["wk"]).reshape(R, C, KV, dk)
    v = _mm(h, p["wv"]).reshape(R, C, KV, dk)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    bidx = torch.arange(R, device=x.device)[:, None]
    k_cache[bidx, positions] = k.to(k_cache.dtype)
    v_cache[bidx, positions] = v.to(v_cache.dtype)
    if kernels == "cuda":
        from ..serve import kernels as _k

        if C == 1:
            seq_lens = mask[:, 0, :].sum(dim=-1).to(torch.int32)
            attn = _k.decode_attention(q[:, 0].contiguous(), k_cache, v_cache,
                                       seq_lens)
            attn = attn.reshape(R, 1, H * dk)
        else:
            attn = _k.verify_attention(q, k_cache, v_cache, mask)
            attn = attn.reshape(R, C, H * dk)
    elif kernels == "torch":
        attn = serve_attention(cfg, q, k_cache, v_cache, mask)
    else:
        raise ValueError(f"unknown kernels {kernels!r} (expected 'cuda' or 'torch')")
    x = x + _mm(attn, p["wo"])
    h2 = _rms(x, p["ffn_norm"], cfg.rms_norm_eps)
    ffn = _mm(F.silu(_mm(h2, p["w1"])) * _mm(h2, p["w3"]), p["w2"])
    return x + ffn


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
):
    """One serving step over R request slots × C tokens each.

    ``cache_positions`` defaults to ``positions`` (they differ for tree
    tokens, whose siblings share a position but need distinct lines).

    Returns (logits, cache): logits float32 (R, V) at ``logits_idx``, or
    (R, C, V) when ``all_logits``. ``cache`` is the dict that was passed
    in, its tensors updated in place.
    """
    R, C = tokens.shape
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
    layers = params["layers"]
    for l in range(cfg.num_hidden_layers):
        p_l = {name: w[l] for name, w in layers.items()}
        x = serve_block(cfg, p_l, x, cos, sin, mask, cache["k"][l],
                        cache["v"][l], cache_positions, kernels)
    x = _rms(x, params["final_norm"], cfg.rms_norm_eps)
    head = params["embed"].T if cfg.tie_word_embeddings else params["lm_head"]
    if not all_logits:
        x = x[torch.arange(R, device=x.device), logits_idx.long()]  # (R, D)
    # f32 logits from the model-dtype hidden state, as the JAX package's
    # preferred_element_type=f32 head
    logits = torch.matmul(x.to(torch.float32), head.to(torch.float32))
    return logits, cache
