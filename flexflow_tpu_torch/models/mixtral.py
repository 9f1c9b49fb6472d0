"""Mixtral model family — the port of ``flexflow_tpu/models/mixtral.py``:
LLaMA's attention (RoPE, GQA, RMSNorm, no biases) with a sparse
mixture-of-experts FFN (``num_local_experts`` > 0: a linear router takes
the top-k experts per token, their weights a softmax over the selected k,
HF ``MixtralSparseMoeBlock``). Runs on the generic decoder
(:mod:`.transformer`)."""
from __future__ import annotations

from typing import Any, Dict

import torch

from .hf_utils import layer_stackers, linear_w, put, stack
from .transformer import *  # noqa: F401,F403  (the serving protocol, transformer.__all__)
from .transformer import DecoderConfig


def config(**kw) -> DecoderConfig:
    d: Dict[str, Any] = dict(
        vocab_size=32000,
        hidden_size=4096,
        intermediate_size=14336,
        num_hidden_layers=32,
        num_attention_heads=32,
        num_key_value_heads=8,
        max_position_embeddings=4096,
        norm_type="rmsnorm",
        norm_bias=False,
        norm_eps=1e-5,
        positions="rope",
        rope_theta=1e6,
        activation="silu",
        glu=True,
        qkv_bias=False,
        out_bias=False,
        mlp_bias=False,
        tie_word_embeddings=False,
        num_local_experts=8,
        num_experts_per_tok=2,
    )
    d.update(kw)
    return DecoderConfig(**d)


def mixtral_8x7b(**kw) -> DecoderConfig:
    return config(**kw)


def tiny(**kw) -> DecoderConfig:
    d = dict(vocab_size=256, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
             num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=128,
             num_local_experts=4, num_experts_per_tok=2)
    d.update(kw)
    return config(**d)


def from_hf(hf: Dict[str, Any], **kw) -> DecoderConfig:
    d = dict(
        vocab_size=hf["vocab_size"],
        hidden_size=hf["hidden_size"],
        intermediate_size=hf["intermediate_size"],
        num_hidden_layers=hf["num_hidden_layers"],
        num_attention_heads=hf["num_attention_heads"],
        num_key_value_heads=hf.get("num_key_value_heads", hf["num_attention_heads"]),
        max_position_embeddings=hf["max_position_embeddings"],
        norm_eps=hf.get("rms_norm_eps", 1e-5),
        rope_theta=hf.get("rope_theta", 1e6),
        num_local_experts=hf.get("num_local_experts", 8),
        num_experts_per_tok=hf.get("num_experts_per_tok", 2),
        # early mixtral-8x7b configs ship sliding_window=4096, which the
        # decoder enforces (null or absent: full causal)
        sliding_window=hf.get("sliding_window") or 0,
        tie_word_embeddings=hf.get("tie_word_embeddings", False),
    )
    d.update(kw)
    return config(**d)


def expert_stack(sd: Dict[str, torch.Tensor], fmt: str, num_layers: int, num_experts: int,
                 dtype: torch.dtype, device: Any) -> torch.Tensor:
    """(L, E, in, out) from the per-expert HF Linear weights named by
    ``fmt`` (``{l}`` the layer, ``{e}`` the expert), one layer at a time."""
    return stack([torch.stack([linear_w(sd, fmt.format(l=i, e=e)) for e in range(num_experts)])
                  for i in range(num_layers)], dtype, device)


def convert_hf_state_dict(sd: Dict[str, torch.Tensor], cfg: DecoderConfig, *,
                          device: Any = None) -> Dict[str, Any]:
    """HF ``MixtralForCausalLM`` state dict → this family's parameter tree
    in ``cfg.dtype`` on ``device`` (``"cuda"`` unless the caller names
    another). HF's per-expert w1 (gate), w2 (down), w3 (up) become
    w_gate, w_down, w_up, each stacked (L, E, in, out)."""
    from ..serve.engine import resolve_device

    dev, dt, L, pre = resolve_device(device), cfg.dtype, cfg.num_hidden_layers, "model."
    mats, vecs = layer_stackers(sd, pre, L, dt, dev)

    def experts(which):
        return expert_stack(sd, pre + "layers.{l}.block_sparse_moe.experts.{e}." + which
                            + ".weight", L, cfg.num_local_experts, dt, dev)

    layers = {
        "attn_norm_scale": vecs("layers.{}.input_layernorm.weight"),
        "mlp_norm_scale": vecs("layers.{}.post_attention_layernorm.weight"),
        "wq": mats("layers.{}.self_attn.q_proj.weight"),
        "wk": mats("layers.{}.self_attn.k_proj.weight"),
        "wv": mats("layers.{}.self_attn.v_proj.weight"),
        "wo": mats("layers.{}.self_attn.o_proj.weight"),
        "w_router": mats("layers.{}.block_sparse_moe.gate.weight"),
        "w_gate": experts("w1"),
        "w_up": experts("w3"),
        "w_down": experts("w2"),
    }
    params = {"embed": put(sd[pre + "embed_tokens.weight"], dt, dev), "layers": layers,
              "final_norm_scale": put(sd[pre + "norm.weight"], dt, dev)}
    if not cfg.tie_word_embeddings:
        params["lm_head"] = put(linear_w(sd, "lm_head.weight"), dt, dev)
    return params
