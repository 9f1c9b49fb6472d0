"""Generic decoder-only transformer — the port of
``flexflow_tpu/models/transformer.py``: one serving engine for the eleven
model families besides LLaMA (models/{opt,falcon,mpt,starcoder,qwen2,
mixtral,mistral,qwen2_moe,gemma,phi,gpt2}.py, each a config mapping and
an HF weight converter). Its config selects, per family:

  * normalisation: LayerNorm (± bias) or RMSNorm (``norm_plus_one``: the
    weight is an offset from 1, Gemma);
  * positions: RoPE (``rotary_pct`` < 1 rotates the first part of each
    head only, Phi), learned absolute embeddings (``learned_pos_offset``,
    OPT), or an ALiBi bias (MPT);
  * attention widths: MHA / GQA / MQA by ``num_key_value_heads``, a
    head dim decoupled from the width (``head_dim_override``, Gemma), a
    sliding window (Mistral);
  * FFN: relu / gelu / gelu_tanh / silu, optionally gated (GLU), or a
    mixture of experts (Mixtral, Qwen2-MoE's shared expert);
  * block topology: sequential, or parallel (x + attn + ffn, Falcon and
    Phi, with one or two input norms);
  * biases, tied embeddings, an LM-head bias, the embedding scale.

Layout kept from the JAX package at every public function (weights
``(in, out)`` stacked on a leading layer dim under the same dict keys;
the caches of models/llama.py), with the port's differences: a Python loop
over the layers, caches updated in place, ``kernels="cuda"`` for the JAX
package's ``"pallas"`` and ``"torch"`` for its ``"xla"``.

ALiBi and sliding-window families (:func:`needs_pos_cache`) add a cache
buffer ``"pos"``, each line's sequence position: (slots, max_len + 1) on
the dense layout, (num_pages + 1, page_size) paged. The bias and the
window are computed from it, so a tree-verify line (at prefix + node
index) is biased and windowed by its true position (prefix + depth). The
line moves of models/llama.py move it with K/V.

Kernels. The paged step (:func:`serve_step_paged`, ``kernels="cuda"``)
attends through the hand-written paged kernels (serve/kernels.py:
``ragged_paged_attention``, or ``fused_rope_paged_attention`` under
``fused_rope``, with the rotary width of ``rotary_pct`` or no RoPE at all
for learned positions), at head dims 64, 80, 128 and 256. A batch that
carries an ALiBi bias takes the plain attention path, as the JAX package
routes it: the kernels take no additive bias (the engine counts those
steps, ``InferenceEngine.plain_attention_steps``). The dense step
reaches no kernel in the JAX package either: here it runs
``kernels="torch"`` only, and ``"cuda"`` raises. The whole-step kernel
(:func:`serve_step_whole`, serve/kernels.whole_step_decode) runs this
decoder's block at head dims 64, 80, 128 and 256, but not for MoE FFNs,
position-buffer families or weight-only quantized params.

Expert FFNs, projections and the LM head are plain large products, left
to ``torch.matmul`` / ``einsum`` as the JAX package leaves them to XLA.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from ..quantization import OFFLOAD_WHOLE_STEP, is_quantized, layer_params
from .hf_utils import params_from_numpy  # noqa: F401  (the weight bridge)
from .llama import (  # noqa: F401  (the K/V line moves carry "pos" too)
    _depth,
    _page_lookup,
    commit_kv,
    commit_kv_paged,
    copy_page_kv,
    gather_page_kv,
    lm_head,
    reorder_slots,
    reorder_slots_paged,
    scatter_page_kv,
)


#: what every family module re-exports (``from .transformer import *``):
#: the config and the serving protocol the engine calls
#: (serve/engine.InferenceEngine)
__all__ = [
    "DENSE_CUDA", "DecoderConfig", "FUSED_DECODE", "commit_kv", "commit_kv_paged",
    "copy_page_kv", "gather_page_kv", "init_kv_cache", "init_paged_kv_cache", "init_params",
    "num_params", "params_from_numpy", "reorder_slots", "reorder_slots_paged",
    "scatter_page_kv", "serve_debug_activations", "serve_step", "serve_step_paged",
    "serve_step_whole", "whole_step_body", "whole_step_tile_roles", "whole_step_weight_layout",
]


@dataclasses.dataclass(frozen=True)
class DecoderConfig:
    vocab_size: int = 32000
    hidden_size: int = 768
    intermediate_size: int = 3072
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    num_key_value_heads: int = 12        # 1 = MQA (Falcon-7B, StarCoder)
    max_position_embeddings: int = 2048
    norm_type: str = "layernorm"         # "layernorm" | "rmsnorm"
    norm_bias: bool = True
    norm_eps: float = 1e-5
    positions: str = "rope"              # "rope" | "learned" | "alibi"
    learned_pos_offset: int = 0          # OPT stores positions at idx+2
    rope_theta: float = 10000.0
    activation: str = "gelu"             # "relu"|"gelu"|"gelu_tanh"|"silu"
    glu: bool = False                    # gated FFN (SwiGLU-style)
    parallel_block: bool = False         # Falcon: x + attn(h) + mlp(h)
    parallel_two_norms: bool = False     # Falcon-40B: ln_attn + ln_mlp
    qkv_bias: bool = False
    out_bias: bool = False
    mlp_bias: bool = False
    tie_word_embeddings: bool = True
    # Mixture of experts (HF MixtralSparseMoeBlock): 0 = dense FFN; E > 0
    # experts behind a linear router taking the top-k per token.
    num_local_experts: int = 0
    num_experts_per_tok: int = 2
    # Qwen2-MoE: the experts' own FFN width (0 = intermediate_size), an
    # always-on shared expert scaled by sigmoid(h @ shared_expert_gate)
    # (0 = none), and moe_norm_topk=False keeping the softmax-over-all
    # weights of the selected k without renormalizing.
    moe_intermediate_size: int = 0
    moe_shared_expert_intermediate_size: int = 0
    moe_norm_topk: bool = True
    # Sliding window (Mistral): a query at position q attends keys in
    # (q - w, q]; 0 = full causal. Lines past the window are masked, not
    # evicted.
    sliding_window: int = 0
    # Gemma: a head dim decoupled from hidden / heads (0 = derived; an
    # override, so dataclasses.replace(cfg, num_attention_heads=...)
    # re-derives it), RMSNorm by (1 + w), sqrt(D) embedding scale.
    head_dim_override: int = 0
    norm_plus_one: bool = False
    embed_scale: bool = False
    # Phi: partial rotary embeddings and an LM-head bias.
    rotary_pct: float = 1.0
    lm_head_bias: bool = False
    dtype: torch.dtype = torch.bfloat16

    def __post_init__(self):
        if self.num_local_experts and self.mlp_bias:
            # the MoE FFN has no bias path: dead b_up/b_down params would
            # silently diverge from the configured architecture
            raise ValueError("mlp_bias is not supported with num_local_experts > 0")
        if self.lm_head_bias and self.tie_word_embeddings:
            # a tied head has no lm_head tensor to bias
            raise ValueError("lm_head_bias requires tie_word_embeddings=False")
        rot = int(self.head_dim * self.rotary_pct)
        if self.positions == "rope" and rot % 2:
            # an odd rotary width would rotate one dim fewer than HF's
            # partial-rope implementations
            raise ValueError(
                f"rotary_pct={self.rotary_pct} gives an odd rotary width {rot} over "
                f"head_dim={self.head_dim}; pick a fraction with an even rotated width")

    @property
    def head_dim(self) -> int:
        return self.head_dim_override or self.hidden_size // self.num_attention_heads

    @property
    def rotary_dim(self) -> int:
        """Dims of each head that RoPE rotates (the first ones)."""
        return int(self.head_dim * self.rotary_pct)


def _activation(cfg: DecoderConfig, x):
    if cfg.activation == "relu":
        return torch.relu(x)
    if cfg.activation == "gelu":
        return F.gelu(x)
    if cfg.activation == "gelu_tanh":
        return F.gelu(x, approximate="tanh")
    if cfg.activation == "silu":
        return F.silu(x)
    raise ValueError(cfg.activation)


def _norm(cfg: DecoderConfig, x, scale, bias):
    xf = x.to(torch.float32)
    if cfg.norm_type == "rmsnorm":
        r = torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + cfg.norm_eps)
        if cfg.norm_plus_one:  # Gemma: the weight is an offset from 1
            return ((xf * r) * (1.0 + scale.to(torch.float32))).to(x.dtype)
        return (xf * r).to(x.dtype) * scale
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean(torch.square(xf - mu), dim=-1, keepdim=True)
    y = ((xf - mu) * torch.rsqrt(var + cfg.norm_eps)).to(x.dtype) * scale
    if bias is not None:
        y = y + bias
    return y


def _mm(x, w):
    # f32 accumulation inside the GEMM, one rounding to x's dtype (the JAX
    # package's preferred_element_type=f32 + cast); a weight-only quantized
    # {"q", "scale"} weight goes through kernels.wq_matmul
    if is_quantized(w):
        from ..serve.kernels import quant_mm

        return quant_mm(x, w)
    return torch.matmul(x, w).to(x.dtype)


def _expert_mm(h, w):
    """``einsum("rcd,edf->rcef", h, w)`` of an expert stack ``w`` (E, D, F),
    rounded once to h's dtype; a quantized stack through
    ``kernels.wq_matmul``'s batched form (E weights against one x)."""
    if not is_quantized(w):
        return torch.einsum("rcd,edf->rcef", h, w).to(h.dtype)
    from ..serve.kernels import wq_matmul

    R, C, D = h.shape
    y = wq_matmul(h.reshape(R * C, D), w["q"], w["scale"])  # (E, R * C, F)
    return y.permute(1, 0, 2).reshape(R, C, *y.shape[::2])


def _experts_down(weighted, w):
    """The down projection of the experts' weighted activations (R, C, E,
    Fe) summed over the experts: (R, C, E * Fe) @ (E * Fe, D) in one f32
    accumulation, rounded once to the activations' dtype; a quantized
    stack as one ``wq_matmul`` whose scale rows group its E experts."""
    R, C = weighted.shape[:2]
    if not is_quantized(w):
        return torch.matmul(weighted.reshape(R, C, -1),
                            w.reshape(-1, w.shape[-1])).to(weighted.dtype)
    from ..serve.kernels import wq_matmul

    E, CR, D = w["q"].shape
    y = wq_matmul(weighted.reshape(R * C, -1), w["q"].reshape(E * CR, D),
                  w["scale"].reshape(E, D))
    return y.reshape(R, C, D)


# ---------------------------------------------------------------------------
# Positions


def rope_freqs(cfg: DecoderConfig, positions: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """positions (...,) int → cos/sin (..., rotary_dim) f32: partial
    rotary (Phi) gives tables of the rotated width, and :func:`apply_rope`
    passes the rest of each head through."""
    half = cfg.rotary_dim // 2
    exponent = torch.arange(0, half, dtype=torch.float32, device=positions.device) / half
    inv_freq = 1.0 / (cfg.rope_theta ** exponent)
    angles = positions.to(torch.float32)[..., None] * inv_freq
    angles = torch.cat([angles, angles], dim=-1)
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate-half RoPE of x (..., heads, head_dim) over the first
    ``cos.shape[-1]`` dims, the op order the fused kernel rounds in
    (serve/kernels._rope_rotate)."""
    from ..serve.kernels import _rope_rotate

    return _rope_rotate(x, cos[..., None, :], sin[..., None, :])


def alibi_slopes(num_heads: int, device: Any = None) -> torch.Tensor:
    """Standard ALiBi head slopes (a power-of-two geometric sequence, with
    the interpolation rule for other head counts), f32."""
    def pow2_slopes(n):
        start = 2.0 ** (-(2.0 ** -(math.log2(n) - 3)))
        return [start * (start ** i) for i in range(n)]

    if math.log2(num_heads).is_integer():
        s = pow2_slopes(num_heads)
    else:
        n = 2 ** math.floor(math.log2(num_heads))
        s = pow2_slopes(n) + pow2_slopes(2 * n)[0::2][: num_heads - n]
    return torch.tensor(s, dtype=torch.float32, device=device)


def _alibi_bias(cfg: DecoderConfig, positions, key_positions):
    """(R, H, C, S) f32: -slope * (query position - key position)."""
    slopes = alibi_slopes(cfg.num_attention_heads, positions.device)
    dist = (positions.to(torch.float32)[:, None, :, None]
            - key_positions.to(torch.float32)[:, None, None, :])
    return -slopes[None, :, None, None] * dist


def needs_pos_cache(cfg: DecoderConfig) -> bool:
    """ALiBi biases and sliding-window masks depend on the keys' sequence
    positions at attention time (RoPE bakes the position into cached K),
    so the cache carries a position buffer. For the window this makes
    tree-verify masking exact: an in-flight tree key's line (prefix + node
    index) is not its position (prefix + depth)."""
    return cfg.positions == "alibi" or cfg.sliding_window > 0


# ---------------------------------------------------------------------------
# Parameters


def _param_specs(cfg: DecoderConfig) -> Dict[str, Any]:
    """The parameter tree as (shape, init) leaves: init is a normal std,
    "ones" or "zeros" — the JAX package's ``init_params`` layout."""
    L, D, Fd = cfg.num_hidden_layers, cfg.hidden_size, cfg.intermediate_size
    H, KV, dk = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    std, out_std = 0.02, 0.02 / math.sqrt(2 * L)
    E = cfg.num_local_experts
    layers: Dict[str, Any] = {
        "attn_norm_scale": ((L, D), "ones"),
        "wq": ((L, D, H * dk), std),
        "wk": ((L, D, KV * dk), std),
        "wv": ((L, D, KV * dk), std),
        "wo": ((L, H * dk, D), out_std),
    }
    if E:
        Fe = cfg.moe_intermediate_size or Fd
        layers["w_router"] = ((L, D, E), std)
        layers["w_up"] = ((L, E, D, Fe), std)
        layers["w_down"] = ((L, E, Fe, D), out_std)
        Fs = cfg.moe_shared_expert_intermediate_size
        if Fs:
            layers["w_shared_up"] = ((L, D, Fs), std)
            layers["w_shared_gate"] = ((L, D, Fs), std)
            layers["w_shared_down"] = ((L, Fs, D), out_std)
            layers["shared_expert_gate"] = ((L, D, 1), std)
    else:
        layers["w_up"] = ((L, D, Fd), std)
        layers["w_down"] = ((L, Fd, D), out_std)
    if cfg.norm_bias:
        layers["attn_norm_bias"] = ((L, D), "zeros")
    # sequential and two-norm parallel blocks have a second norm; a
    # Falcon-7B-style parallel block shares its input norm
    if not cfg.parallel_block or cfg.parallel_two_norms:
        layers["mlp_norm_scale"] = ((L, D), "ones")
        if cfg.norm_bias:
            layers["mlp_norm_bias"] = ((L, D), "zeros")
    if cfg.glu:
        layers["w_gate"] = ((L, E, D, cfg.moe_intermediate_size or Fd) if E else (L, D, Fd),
                            std)
    if cfg.qkv_bias:
        layers["bq"] = ((L, H * dk), "zeros")
        layers["bk"] = ((L, KV * dk), "zeros")
        layers["bv"] = ((L, KV * dk), "zeros")
    if cfg.out_bias:
        layers["bo"] = ((L, D), "zeros")
    if cfg.mlp_bias:
        layers["b_up"] = ((L, Fd), "zeros")
        layers["b_down"] = ((L, D), "zeros")
        if cfg.glu:
            layers["b_gate"] = ((L, Fd), "zeros")
    specs: Dict[str, Any] = {"embed": ((cfg.vocab_size, D), std), "layers": layers,
                             "final_norm_scale": ((D,), "ones")}
    if cfg.norm_bias:
        specs["final_norm_bias"] = ((D,), "zeros")
    if cfg.positions == "learned":
        specs["pos_embed"] = ((cfg.max_position_embeddings + cfg.learned_pos_offset, D), std)
    if not cfg.tie_word_embeddings:
        specs["lm_head"] = ((D, cfg.vocab_size), std)
        if cfg.lm_head_bias:
            specs["lm_head_bias"] = ((cfg.vocab_size,), "zeros")
    return specs


def init_params(generator: torch.Generator, cfg: DecoderConfig, *,
                device: Any = None) -> Dict[str, Any]:
    """Random weights in ``cfg.dtype`` on ``device`` (the generator's own
    device when None): normal with std 0.02 (output projections scaled by
    1/sqrt(2L)), norms at 1, biases at 0. A stacked tensor is drawn a
    layer at a time (one layer's f32 temporary). The draws cannot
    reproduce ``jax.random``: tests carry JAX weights across with
    :func:`params_from_numpy`."""
    device = torch.device(device) if device is not None else generator.device

    def make(spec):
        shape, init = spec
        if init == "ones":
            return torch.ones(shape, dtype=cfg.dtype, device=device)
        if init == "zeros":
            return torch.zeros(shape, dtype=cfg.dtype, device=device)
        out = torch.empty(shape, dtype=cfg.dtype, device=device)
        for part in (out if len(shape) > 2 else (out,)):
            part.copy_(torch.randn(part.shape, generator=generator, dtype=torch.float32,
                                   device=device) * init)
        return out

    specs = _param_specs(cfg)
    return {k: ({n: make(v) for n, v in s.items()} if k == "layers" else make(s))
            for k, s in specs.items()}


def num_params(cfg: DecoderConfig) -> int:
    specs = _param_specs(cfg)
    leaves = list(specs["layers"].values()) + [v for k, v in specs.items() if k != "layers"]
    return sum(math.prod(shape) for shape, _ in leaves)


# ---------------------------------------------------------------------------
# The block


def _project_qkv(cfg: DecoderConfig, p, h):
    R, C, _ = h.shape
    H, KV, dk = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    q, k, v = _mm(h, p["wq"]), _mm(h, p["wk"]), _mm(h, p["wv"])
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    return q.reshape(R, C, H, dk), k.reshape(R, C, KV, dk), v.reshape(R, C, KV, dk)


def _attend(cfg: DecoderConfig, q, k_cache, v_cache, bias, mask):
    """q (R, C, H, dk) against k/v (R, S, KV, dk), GQA groups contracted
    per KV head, f32 scores (plus ``bias`` (R, H, C, S) where given) under
    ``mask`` (R, C, S), probabilities rounded to q's dtype before PV (the
    JAX package's ``_serve_attend``). Returns (R, C, H * dk)."""
    R, C, H, dk = q.shape
    KV = k_cache.shape[2]
    G = H // KV
    qg = q.reshape(R, C, KV, G, dk)
    scores = torch.einsum("rckgd,rskd->rkgcs", qg.to(torch.float32),
                          k_cache.to(torch.float32)) / math.sqrt(cfg.head_dim)
    if bias is not None:
        scores = scores + bias.reshape(R, KV, G, *bias.shape[-2:])
    scores = torch.where(mask[:, None, None], scores, -1e30)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    dt = torch.promote_types(q.dtype, v_cache.dtype)
    out = torch.einsum("rkgcs,rskd->rckgd", probs.to(dt), v_cache.to(dt))
    return out.reshape(R, C, H * dk)


def _moe_ffn(cfg: DecoderConfig, p, h):
    """Sparse-MoE FFN (HF ``MixtralSparseMoeBlock``, Qwen2-MoE's shared
    expert): an f32 linear router, the top k experts per token, their
    weights a softmax over the selected k (``moe_norm_topk``) or the
    selected entries of a softmax over all experts; every expert computed
    for every token (at decode a few tokens: one contraction over the
    expert dim), the combine weights folded into the down projection's
    input so the (tokens, E, D) outputs are never materialized; plus the
    sigmoid-gated shared expert."""
    E, K = cfg.num_local_experts, cfg.num_experts_per_tok
    R, C, D = h.shape
    router = torch.matmul(h.to(torch.float32), p["w_router"].to(torch.float32))  # (R, C, E)
    topv, topi = torch.topk(router, K, dim=-1)
    if cfg.moe_norm_topk:
        gate = torch.softmax(topv, dim=-1)
    else:
        gate = torch.gather(torch.softmax(router, dim=-1), -1, topi)
    combine = torch.zeros_like(router).scatter_add_(-1, topi, gate)        # (R, C, E)
    up = _expert_mm(h, p["w_up"])
    if cfg.glu:
        act = _activation(cfg, _expert_mm(h, p["w_gate"])) * up
    else:
        act = _activation(cfg, up)
    weighted = (act.to(torch.float32) * combine[..., None]).to(h.dtype)   # (R, C, E, Fe)
    out = _experts_down(weighted, p["w_down"])
    if cfg.moe_shared_expert_intermediate_size:
        s_act = _activation(cfg, _mm(h, p["w_shared_gate"])) * _mm(h, p["w_shared_up"])
        s_out = _mm(s_act, p["w_shared_down"])
        s_gate = torch.sigmoid(torch.matmul(
            h.to(torch.float32), p["shared_expert_gate"].to(torch.float32))).to(h.dtype)
        out = out + s_gate * s_out
    return out


def _ffn(cfg: DecoderConfig, p, h):
    if cfg.num_local_experts:
        return _moe_ffn(cfg, p, h)
    up = _mm(h, p["w_up"])
    if cfg.mlp_bias:
        up = up + p["b_up"]
    if cfg.glu:
        gate = _mm(h, p["w_gate"])
        if cfg.mlp_bias:
            gate = gate + p["b_gate"]
        act = _activation(cfg, gate) * up
    else:
        act = _activation(cfg, up)
    out = _mm(act, p["w_down"])
    if cfg.mlp_bias:
        out = out + p["b_down"]
    return out


def _block_out(cfg: DecoderConfig, p, x, h, attn):
    """A block after attention: the output projection (and bias), then the
    parallel (x + attn + ffn(h), h the input norm or a second norm of x) or
    sequential (x + attn, its norm, + ffn) residual."""
    attn = _mm(attn, p["wo"])
    if cfg.out_bias:
        attn = attn + p["bo"]
    if cfg.parallel_block:
        h2 = (_norm(cfg, x, p["mlp_norm_scale"], p.get("mlp_norm_bias"))
              if cfg.parallel_two_norms else h)
        return x + attn + _ffn(cfg, p, h2)
    x = x + attn
    h2 = _norm(cfg, x, p["mlp_norm_scale"], p.get("mlp_norm_bias"))
    return x + _ffn(cfg, p, h2)


def _qkv(cfg: DecoderConfig, p, x, rope):
    """A block's input norm h and q, k, v (RoPE applied when ``rope``)."""
    h = _norm(cfg, x, p["attn_norm_scale"], p.get("attn_norm_bias"))
    q, k, v = _project_qkv(cfg, p, h)
    if rope is not None:
        q, k = apply_rope(q, *rope), apply_rope(k, *rope)
    return h, q, k, v


def _embed_in(cfg: DecoderConfig, params, tokens, positions):
    x = params["embed"][tokens.long()]
    if cfg.embed_scale:  # Gemma scales inputs by sqrt(hidden), in the model dtype
        x = x * torch.tensor(cfg.hidden_size ** 0.5, dtype=x.dtype)
    if cfg.positions == "learned":
        # clipped: padding tokens carry the scratch line's position, past
        # the table
        table = params["pos_embed"]
        idx = (positions.long() + cfg.learned_pos_offset).clamp(0, table.shape[0] - 1)
        x = x + table[idx]
    return x


def _head(cfg: DecoderConfig, params, x, logits_idx, all_logits: bool):
    """Final norm and f32 LM head (plus its bias), at ``logits_idx`` (R,)
    or, with ``all_logits``, at every chunk column."""
    x = _norm(cfg, x, params["final_norm_scale"], params.get("final_norm_bias"))
    if not all_logits:
        x = x[torch.arange(x.shape[0], device=x.device), logits_idx.long()]
    head = params["embed"].T if cfg.tie_word_embeddings else params["lm_head"]
    logits = lm_head(x, head)
    if "lm_head_bias" in params:
        logits = logits + params["lm_head_bias"].to(torch.float32)
    return logits


def _rope(cfg: DecoderConfig, positions):
    return rope_freqs(cfg, positions) if cfg.positions == "rope" else None


# ---------------------------------------------------------------------------
# Serving on the dense KV cache

#: why ``kernels="cuda"`` has no dense step for the generic decoder
DENSE_CUDA = (
    "the generic decoder's dense serving step has no CUDA kernel: the JAX package's "
    "generic dense step reaches none either (ROADMAP.md queue 1 open question: a "
    "kernel path for the generic dense layout); serve with kv_layout='paged' for "
    "the CUDA kernels, or kernels='torch'")


def init_kv_cache(cfg: DecoderConfig, num_slots: int, max_len: int, dtype=None, *,
                  device: Any = None) -> Dict[str, torch.Tensor]:
    """(L, slots, max_len + 1, KV, dk) K and V, the last line a scratch
    row; plus the (slots, max_len + 1) int32 position buffer when
    :func:`needs_pos_cache`."""
    L, KV, dk = cfg.num_hidden_layers, cfg.num_key_value_heads, cfg.head_dim
    dt = dtype or cfg.dtype
    shape = (L, num_slots, max_len + 1, KV, dk)
    cache = {"k": torch.zeros(shape, dtype=dt, device=device),
             "v": torch.zeros(shape, dtype=dt, device=device)}
    if needs_pos_cache(cfg):
        cache["pos"] = torch.zeros((num_slots, max_len + 1), dtype=torch.int32, device=device)
    return cache


def _dense_context(cfg: DecoderConfig, cache, positions, cache_positions, mask):
    """Write the step's positions into the position buffer (in place) and
    derive the ALiBi bias and the sliding-window mask from it; returns
    (mask, bias)."""
    if not needs_pos_cache(cfg):
        return mask, None
    bidx = torch.arange(positions.shape[0], device=positions.device)[:, None]
    pos = cache["pos"]
    pos[bidx, cache_positions] = positions.to(torch.int32)
    bias = _alibi_bias(cfg, positions, pos) if cfg.positions == "alibi" else None
    if cfg.sliding_window:
        # by the keys' true positions; unwritten lines hold 0, which the
        # causal or tree mask already excludes
        mask = mask & (pos[:, None, :] > positions[:, :, None] - cfg.sliding_window)
    return mask, bias


def serve_block(cfg: DecoderConfig, p, x, rope, bias, mask, k_cache, v_cache,
                cache_positions):
    """One block of a dense serving step: project, RoPE, write the new K/V
    into one layer's (R, S1, KV, dk) views in place, attend over the whole
    cache. Returns the block's output."""
    h, q, k, v = _qkv(cfg, p, x, rope)
    bidx = torch.arange(x.shape[0], device=x.device)[:, None]
    k_cache[bidx, cache_positions] = k.to(k_cache.dtype)
    v_cache[bidx, cache_positions] = v.to(v_cache.dtype)
    return _block_out(cfg, p, x, h, _attend(cfg, q, k_cache, v_cache, bias, mask))


def serve_step(params: Dict[str, Any], cache: Dict[str, torch.Tensor],
               tokens: torch.Tensor, positions: torch.Tensor, logits_idx: torch.Tensor,
               mask: Optional[torch.Tensor], cache_positions: Optional[torch.Tensor] = None,
               *, cfg: DecoderConfig, all_logits: bool = False, kernels: str = "torch",
               num_layers: Optional[int] = None):
    """One serving step over R slots × C tokens on the dense cache: the
    contract of models/llama.serve_step (``num_layers`` the early-exit
    slice: the deeper layers' K/V untouched; the position buffer is
    written once a step, in full). ``kernels`` must be "torch" (see
    :data:`DENSE_CUDA`). Returns (logits, cache), updated in place."""
    if kernels == "cuda":
        raise ValueError(DENSE_CUDA)
    if kernels != "torch":
        raise ValueError(f"unknown kernels {kernels!r} (expected 'cuda' or 'torch')")
    from ..serve.kernels import causal_serve_mask

    if cache_positions is None:
        cache_positions = positions
    positions, cache_positions = positions.long(), cache_positions.long()
    x = _embed_in(cfg, params, tokens, positions)
    rope = _rope(cfg, positions)
    if mask is None:
        mask = causal_serve_mask(positions, cache["k"].shape[2])
    mask, bias = _dense_context(cfg, cache, positions, cache_positions, mask)
    layers = params["layers"]
    for l in range(_depth(cfg, num_layers)):
        p_l = layer_params(layers, l)
        x = serve_block(cfg, p_l, x, rope, bias, mask, cache["k"][l], cache["v"][l],
                        cache_positions)
    return _head(cfg, params, x, logits_idx, all_logits), cache


# ---------------------------------------------------------------------------
# Serving on the paged KV cache

#: decode-step fusions this decoder's serving step supports
#: (ServingConfig.fused_decode): "rope_kv_write" folds RoPE (or, with
#: learned positions, just the K/V page write) into the paged kernel;
#: "whole_step" runs the whole step in one kernel (:func:`serve_step_whole`;
#: :func:`whole_step_weight_layout` refuses the families it cannot run)
FUSED_DECODE = ("rope_kv_write", "whole_step")


def init_paged_kv_cache(cfg: DecoderConfig, num_pages: int, page_size: int, dtype=None,
                        kv_quant: Optional[str] = None, *,
                        device: Any = None) -> Dict[str, torch.Tensor]:
    """models/llama.init_paged_kv_cache's pools (and quantized scales),
    plus the (num_pages + 1, page_size) int32 position pool when
    :func:`needs_pos_cache`, paged like K/V."""
    from .llama import init_paged_kv_cache as _pools

    cache = _pools(cfg, num_pages, page_size, dtype, kv_quant, device=device)
    if needs_pos_cache(cfg):
        cache["pos"] = torch.zeros((num_pages + 1, page_size), dtype=torch.int32,
                                   device=device)
    return cache


def _paged_serve_context(cfg: DecoderConfig, cache, positions, cache_positions, mask,
                         page_table, cache_len):
    """A paged step's prologue: the page lookup of the new lines, the
    causal-or-given mask over the virtual cache, and, for position-buffer
    families, the positions written into their pages (in place) with the
    ALiBi bias and the sliding-window mask read back through the table.
    Returns (phys, off, mask, bias)."""
    from ..serve.kernels import gather_pages, paged_serve_mask

    ps = cache["k"].shape[2]
    phys, off = _page_lookup(page_table, cache_positions, ps)
    mask = paged_serve_mask(mask, positions, page_table.shape[1], ps, cache_len)
    bias = None
    if needs_pos_cache(cfg):
        cache["pos"][phys, off] = positions.to(torch.int32)
        pos_virt = gather_pages(cache["pos"], page_table)  # (R, NP * ps)
        if cfg.positions == "alibi":
            bias = _alibi_bias(cfg, positions, pos_virt)
        if cfg.sliding_window:
            mask = mask & (pos_virt[:, None, :] > positions[:, :, None] - cfg.sliding_window)
    return phys, off, mask, bias


def _block_paged_torch(cfg: DecoderConfig, p, x, rope, bias, mask, k_pool, v_pool, phys,
                       off, page_table, k_scale=None, v_scale=None, qmax=None):
    """One block of the plain paged step (the JAX package's
    ``_block_paged_xla``): project, RoPE, commit K/V in place
    (``quant_line_write`` on quantized pools), gather — and dequantize —
    the virtual cache, attend with the bias, out-project, FFN."""
    from ..serve import kernels as _k

    h, q, k, v = _qkv(cfg, p, x, rope)
    _k.commit_paged(k_pool, v_pool, k, v, phys, off, k_scale, v_scale, qmax, kernels="torch")
    if qmax is not None:
        k_virt = _k.dequant_pages(k_pool, k_scale, page_table, q.dtype)
        v_virt = _k.dequant_pages(v_pool, v_scale, page_table, q.dtype)
    else:
        k_virt = _k.gather_pages(k_pool, page_table)
        v_virt = _k.gather_pages(v_pool, page_table)
    return _block_out(cfg, p, x, h, _attend(cfg, q, k_virt, v_virt, bias, mask))


def serve_block_paged(cfg: DecoderConfig, p, x, rope, bias, mask, k_pool, v_pool, phys,
                      off, page_table, kernels: str = "torch", k_scale=None, v_scale=None,
                      qmax=None, *, fused_rope: bool = False, logical=None):
    """One block on a paged step; pools and scales (one layer's views) are
    updated in place. ``kernels="cuda"`` without a bias attends in
    serve/kernels.ragged_paged_attention (the commit by
    ``kernels.commit_paged``: the commit kernel on quantized pools), or,
    with ``fused_rope``, in fused_rope_paged_attention, which takes the
    rotary tables of ``rope`` (the rotary width; None for learned
    positions: the commit alone) and ``logical``/``off``. A batch with an
    ALiBi ``bias`` runs the plain block under either ``kernels``: no kernel
    takes an additive bias (the JAX package routes it the same way).
    ``kernels="torch"`` ignores ``fused_rope``."""
    if kernels not in ("cuda", "torch"):
        raise ValueError(f"unknown kernels {kernels!r} (expected 'cuda' or 'torch')")
    if kernels == "torch" or bias is not None:
        return _block_paged_torch(cfg, p, x, rope, bias, mask, k_pool, v_pool, phys, off,
                                  page_table, k_scale, v_scale, qmax)
    from ..serve import kernels as _k

    R, C, _ = x.shape
    if fused_rope:
        h = _norm(cfg, x, p["attn_norm_scale"], p.get("attn_norm_bias"))
        q, k, v = _project_qkv(cfg, p, h)
        cos, sin = rope if rope is not None else (None, None)
        attn = _k.fused_rope_paged_attention(
            q, k, v, cos, sin, k_pool, v_pool, page_table, logical.to(torch.int32),
            off.to(torch.int32), mask, k_scale=k_scale, v_scale=v_scale, qmax=qmax)
    else:
        h, q, k, v = _qkv(cfg, p, x, rope)
        _k.commit_paged(k_pool, v_pool, k, v, phys, off, k_scale, v_scale, qmax)
        attn = _k.ragged_paged_attention(q, k_pool, v_pool, page_table, mask,
                                         k_scale=k_scale, v_scale=v_scale)
    return _block_out(cfg, p, x, h, attn.reshape(R, C, -1))


def serve_step_paged(params: Dict[str, Any], cache: Dict[str, torch.Tensor],
                     tokens: torch.Tensor, positions: torch.Tensor,
                     logits_idx: torch.Tensor, mask: Optional[torch.Tensor],
                     cache_positions: Optional[torch.Tensor], page_table: torch.Tensor, *,
                     cfg: DecoderConfig, cache_len: int, all_logits: bool = False,
                     kernels: str = "torch", kv_quant: Optional[str] = None,
                     fused_rope: bool = False, num_layers: Optional[int] = None):
    """Paged twin of :func:`serve_step` (the contract of
    models/llama.serve_step_paged): ``kv_quant`` the quantized pools,
    ``fused_rope`` the fused kernel (:func:`serve_block_paged`),
    ``num_layers`` the early-exit slice. Returns (logits, cache), updated
    in place."""
    if cache_positions is None:
        cache_positions = positions
    positions, cache_positions = positions.long(), cache_positions.long()
    x = _embed_in(cfg, params, tokens, positions)
    rope = _rope(cfg, positions)
    phys, off, mask, bias = _paged_serve_context(cfg, cache, positions, cache_positions,
                                                 mask, page_table, cache_len)
    logical = cache_positions // cache["k"].shape[2]
    qmax = None
    if kv_quant is not None:
        from ..serve.kv_quant import resolve_spec

        qmax = resolve_spec(kv_quant).qmax
    layers = params["layers"]
    for l in range(_depth(cfg, num_layers)):
        p_l = layer_params(layers, l)
        scales = ((cache["k_scale"][l], cache["v_scale"][l]) if qmax is not None
                  else (None, None))
        x = serve_block_paged(cfg, p_l, x, rope, bias, mask, cache["k"][l], cache["v"][l],
                              phys, off, page_table, kernels, *scales, qmax,
                              fused_rope=fused_rope, logical=logical)
    return _head(cfg, params, x, logits_idx, all_logits), cache


def serve_debug_activations(params: Dict[str, Any], cache: Dict[str, torch.Tensor],
                            tokens: torch.Tensor, positions: torch.Tensor,
                            mask: Optional[torch.Tensor],
                            cache_positions: Optional[torch.Tensor] = None, *,
                            cfg: DecoderConfig, kernels: str = "torch",
                            page_table: Optional[torch.Tensor] = None,
                            cache_len: Optional[int] = None,
                            kv_quant: Optional[str] = None) -> List[torch.Tensor]:
    """Per-layer hidden states of one serving step of this decoder, for
    ``inference_debugging`` (the contract of
    models/llama.serve_debug_activations). ``kernels`` is accepted for the
    engine's call and ignored: the capture runs the plain blocks, as the
    JAX package's does. The cache is left as it was: the position buffer
    (where the family has one) and each layer's K/V and page scales are
    written as clones, one layer at a time. Returns one (R, C, D) tensor a
    layer."""
    del kernels  # triage runs the plain blocks
    if cache_positions is None:
        cache_positions = positions
    positions, cache_positions = positions.long(), cache_positions.long()
    x = _embed_in(cfg, params, tokens, positions)
    rope = _rope(cfg, positions)
    cache = dict(cache)
    if "pos" in cache:  # the step's prologue writes its positions there
        cache["pos"] = cache["pos"].clone()
    layers = params["layers"]
    acts = []
    if page_table is not None:  # the paged layout
        phys, off, mask, bias = _paged_serve_context(cfg, cache, positions, cache_positions,
                                                     mask, page_table, cache_len)
        qmax = None
        if kv_quant is not None:
            from ..serve.kv_quant import resolve_spec

            qmax = resolve_spec(kv_quant).qmax
        for l in range(cfg.num_hidden_layers):
            p_l = layer_params(layers, l)
            scales = ((cache["k_scale"][l].clone(), cache["v_scale"][l].clone())
                      if qmax is not None else (None, None))
            x = serve_block_paged(cfg, p_l, x, rope, bias, mask, cache["k"][l].clone(),
                                  cache["v"][l].clone(), phys, off, page_table, "torch",
                                  *scales, qmax)
            acts.append(x)
        return acts
    if mask is None:
        from ..serve.kernels import causal_serve_mask

        mask = causal_serve_mask(positions, cache["k"].shape[2])
    mask, bias = _dense_context(cfg, cache, positions, cache_positions, mask)
    for l in range(cfg.num_hidden_layers):
        p_l = layer_params(layers, l)
        x = serve_block(cfg, p_l, x, rope, bias, mask, cache["k"][l].clone(),
                        cache["v"][l].clone(), cache_positions)
        acts.append(x)
    return acts


# ---------------------------------------------------------------------------
# Whole-step serving (ServingConfig.fused_decode=("whole_step",);
# serve/kernels.whole_step_decode carries the kernel's design). The
# generic decoder's half, the twin of models/llama.py's: the weight
# layout the walk streams, the body the kernel computes, and the step
# entry point binding this family's block and head math — the same
# _block_paged_torch body the unfused step runs. The layout hook refuses
# the configs whose block the kernel cannot run, at construction.


def whole_step_weight_layout(params: Dict[str, Any], cfg: DecoderConfig):
    """``(layer_arrays, head_arrays)``: every per-layer tensor as its
    stacked (L, …) array and the epilogue params (the final norm's scale
    and bias, the tied embedding or the LM head and its bias), nothing
    copied. Raises ValueError, in the JAX package's words, for MoE FFNs,
    ALiBi / sliding-window families (their attention reads the position
    buffer) and weight-only quantized params."""
    if cfg.num_local_experts:
        raise ValueError(
            "whole_step is not composed with mixture-of-experts FFNs — the routed expert "
            "contraction has no streamed per-layer weight block yet; drop the whole_step "
            "fusion for this family")
    if needs_pos_cache(cfg):
        raise ValueError(
            "whole_step is not composed with ALiBi / sliding-window families — their "
            "attention reads the per-line position buffer, which the layer walk does not "
            "stream; drop the whole_step fusion for this family")
    L = cfg.num_hidden_layers
    if getattr(params["layers"], "offloaded", False):
        raise ValueError(OFFLOAD_WHOLE_STEP)
    layer_arrays = {}
    for name, a in params["layers"].items():
        if isinstance(a, dict):
            raise ValueError(
                "whole_step is not composed with weight-only quantization (layer tensor "
                f"{name!r} is a quantized {{'q','scale'}} pair) — serve full-precision params "
                "or drop the whole_step fusion")
        if a.shape[0] != L:
            raise ValueError(f"layer tensor {name!r} leading dim {a.shape[0]} != "
                             f"num_hidden_layers {L}")
        layer_arrays[name] = a
    head_arrays = {"final_norm_scale": params["final_norm_scale"]}
    if "final_norm_bias" in params:
        head_arrays["final_norm_bias"] = params["final_norm_bias"]
    if cfg.tie_word_embeddings:
        head_arrays["embed"] = params["embed"]
    else:
        if isinstance(params["lm_head"], dict):
            raise ValueError("whole_step is not composed with a weight-only quantized lm_head")
        head_arrays["lm_head"] = params["lm_head"]
        if "lm_head_bias" in params:
            head_arrays["lm_head_bias"] = params["lm_head_bias"]
    return layer_arrays, head_arrays


def _whole_head_fn(cfg: DecoderConfig, head, x, logits_idx):
    """The walk's epilogue, op for op :func:`serve_step_paged`'s tail
    (final norm, the logits_idx row, f32 LM head and its bias)."""
    return _head(cfg, head, x, logits_idx, all_logits=False)


def _whole_head_all_fn(cfg: DecoderConfig, head, x, logits_idx):
    """The all-positions epilogue of the speculation fold, op for op
    :func:`serve_step_paged`'s ``all_logits=True`` tail (``logits_idx``
    unread)."""
    return _head(cfg, head, x, logits_idx, all_logits=True)


def whole_step_tile_roles(cfg: DecoderConfig) -> Dict[str, Tuple[str, Optional[str]]]:
    """The weight and bias behind each role the kernel splits into
    output-column tiles: biases by the config's flags, "gate" in a GLU FFN
    alone."""
    roles = {
        "q": ("wq", "bq" if cfg.qkv_bias else None),
        "k": ("wk", "bk" if cfg.qkv_bias else None),
        "v": ("wv", "bv" if cfg.qkv_bias else None),
        "o": ("wo", "bo" if cfg.out_bias else None),
        "up": ("w_up", "b_up" if cfg.mlp_bias else None),
        "down": ("w_down", "b_down" if cfg.mlp_bias else None),
    }
    if cfg.glu:
        roles["gate"] = ("w_gate", "b_gate" if cfg.mlp_bias else None)
    return roles


def whole_step_body(cfg: DecoderConfig):
    """What the whole-step kernel computes between the roles' projections
    (serve/kernels.WholeBody): the norm (LayerNorm with or without its
    bias, RMS, or Gemma's RMS by 1 + w), the activation, and the block's
    topology — a parallel block's FFN reads the input norm (``mlp_norm``
    None) or its second norm of x. The JAX package's tiled walk carries the
    same routing in ``_whole_tile_plan``'s closures; here the tile count
    only groups the kernel's output columns, so the plain walk needs no
    counterpart of them."""
    from ..serve.kernels import WholeBody

    ln = cfg.norm_type == "layernorm"

    def norm(prefix):
        return (f"{prefix}_scale", f"{prefix}_bias" if ln and cfg.norm_bias else None)

    two = not cfg.parallel_block or cfg.parallel_two_norms
    return WholeBody(
        norm="layernorm" if ln else "rms_plus_one" if cfg.norm_plus_one else "rms",
        eps=cfg.norm_eps, attn_norm=norm("attn_norm"),
        mlp_norm=norm("mlp_norm") if two else None, final_norm=norm("final_norm"),
        activation=cfg.activation, parallel=cfg.parallel_block)


def serve_step_whole(
    params: Dict[str, Any],
    cache: Dict[str, torch.Tensor],
    tokens: torch.Tensor,      # (R, C) int — C=1 decode, C>1 mixed
    positions: torch.Tensor,   # (R, C) int
    logits_idx: torch.Tensor,  # (R,) int
    page_table: torch.Tensor,  # (R, NP) int32
    *,
    cfg: DecoderConfig,
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
    """The whole paged serving step of this decoder in one kernel — the
    twin of models/llama.serve_step_whole, with its contract: every layer
    (Q/K/V and their biases, RoPE over the rotary width or none, the K/V
    page commit, paged attention, the out-projection, the FFN of the
    family's activation, sequential or parallel), the final norm, the LM
    head (and its bias) at ``logits_idx`` and the greedy argmax. The
    embedding (learned positions and Gemma's scale included), RoPE
    tables, mask and page lookup run before the kernel, as in the JAX
    package. ``kernels="cuda"`` goes through serve/kernels.whole_step_decode
    (the CUDA kernel on a GPU, its plain version on the CPU), ``"torch"``
    straight to the plain version; ``tiles`` is the engine gate's
    output-column tile count, which the answer does not depend on;
    ``stamps`` asks the kernel for its per-stage timer. The speculation
    fold's keywords (``mask``, ``cache_positions``, ``all_logits``,
    ``num_layers``) have their meaning in :func:`serve_step_paged`.

    Returns ``(logits (R, V) f32, greedy tokens (R,) int64, cache)`` —
    with ``all_logits`` ``(R, C, V)`` and ``(R, C)`` — the cache updated in
    place; the plain version is bitwise :func:`serve_step_paged`
    (``kernels="torch"``, the same keywords) at every tile count."""
    if kernels not in ("cuda", "torch"):
        raise ValueError(f"unknown kernels {kernels!r} (expected 'cuda' or 'torch')")
    from ..serve import kernels as _k

    layer_arrays, head_arrays = whole_step_weight_layout(params, cfg)
    if cache_positions is None:
        cache_positions = positions
    positions = positions.long()
    ps = cache["k"].shape[2]
    x = _embed_in(cfg, params, tokens, positions)
    cos, sin = _rope(cfg, positions) or (None, None)
    mask = _k.paged_serve_mask(mask, positions, page_table.shape[1], ps, cache_len)
    phys, off = _page_lookup(page_table, cache_positions.long(), ps)
    qmax = None
    if kv_quant is not None:
        from ..serve.kv_quant import resolve_spec

        qmax = resolve_spec(kv_quant).qmax
    walk_cache = cache
    n = _depth(cfg, num_layers)
    if n < cfg.num_hidden_layers:
        # the early-exit draft: the walk over the first n layers' weights
        # and pools (leading-dim slices, views of the same storage)
        layer_arrays = {k: a[:n] for k, a in layer_arrays.items()}
        walk_cache = {k: a[:n] for k, a in cache.items()}

    def block_fn(p_l, xv, cs, sn, mk, kb, vb, ks, vs, ph, of, pt):
        rope = None if cs is None else (cs, sn)
        return _block_paged_torch(cfg, p_l, xv, rope, None, mk, kb, vb, ph, of, pt, ks, vs,
                                  qmax)

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
