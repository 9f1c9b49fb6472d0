"""Mistral model family — the port of ``flexflow_tpu/models/mistral.py``:
LLaMA's architecture with GQA and a sliding attention window (4096 on
Mistral-7B), enforced through the cache's position buffer
(``transformer.needs_pos_cache``). Runs on the generic decoder
(:mod:`.transformer`)."""
from __future__ import annotations

from typing import Any, Dict

import torch

from .hf_utils import layer_stackers, linear_w, put
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
        rope_theta=10000.0,
        activation="silu",
        glu=True,
        qkv_bias=False,
        out_bias=False,
        mlp_bias=False,
        tie_word_embeddings=False,
        sliding_window=4096,
    )
    d.update(kw)
    return DecoderConfig(**d)


def mistral_7b(**kw) -> DecoderConfig:
    return config(**kw)


def tiny(**kw) -> DecoderConfig:
    d = dict(vocab_size=256, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
             num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=128,
             sliding_window=8)
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
        rope_theta=hf.get("rope_theta", 10000.0),
        # a null or absent window (mistral-v0.3-style configs) is full causal
        sliding_window=hf.get("sliding_window") or 0,
        tie_word_embeddings=hf.get("tie_word_embeddings", False),
    )
    d.update(kw)
    return config(**d)


def convert_hf_state_dict(sd: Dict[str, torch.Tensor], cfg: DecoderConfig, *,
                          device: Any = None) -> Dict[str, Any]:
    """HF ``MistralForCausalLM`` state dict (LLaMA's tensor names) → this
    family's parameter tree in ``cfg.dtype`` on ``device`` (``"cuda"``
    unless the caller names another)."""
    from ..serve.engine import resolve_device

    dev, dt, pre = resolve_device(device), cfg.dtype, "model."
    mats, vecs = layer_stackers(sd, pre, cfg.num_hidden_layers, dt, dev)
    layers = {
        "attn_norm_scale": vecs("layers.{}.input_layernorm.weight"),
        "mlp_norm_scale": vecs("layers.{}.post_attention_layernorm.weight"),
        "wq": mats("layers.{}.self_attn.q_proj.weight"),
        "wk": mats("layers.{}.self_attn.k_proj.weight"),
        "wv": mats("layers.{}.self_attn.v_proj.weight"),
        "wo": mats("layers.{}.self_attn.o_proj.weight"),
        "w_gate": mats("layers.{}.mlp.gate_proj.weight"),
        "w_up": mats("layers.{}.mlp.up_proj.weight"),
        "w_down": mats("layers.{}.mlp.down_proj.weight"),
    }
    params = {"embed": put(sd[pre + "embed_tokens.weight"], dt, dev), "layers": layers,
              "final_norm_scale": put(sd[pre + "norm.weight"], dt, dev)}
    if not cfg.tie_word_embeddings:
        params["lm_head"] = put(linear_w(sd, "lm_head.weight"), dt, dev)
    return params
