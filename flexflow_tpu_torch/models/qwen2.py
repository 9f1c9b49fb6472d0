"""Qwen2 model family — the port of ``flexflow_tpu/models/qwen2.py``:
LLaMA's architecture (RoPE, GQA, RMSNorm, SwiGLU) with biases on the Q/K/V
projections. Runs on the generic decoder (:mod:`.transformer`)."""
from __future__ import annotations

from typing import Any, Dict

import torch

from .hf_utils import layer_stackers, linear_w, put
from .transformer import *  # noqa: F401,F403  (the serving protocol, transformer.__all__)
from .transformer import DecoderConfig


def config(**kw) -> DecoderConfig:
    d: Dict[str, Any] = dict(
        vocab_size=151936,
        hidden_size=3584,
        intermediate_size=18944,
        num_hidden_layers=28,
        num_attention_heads=28,
        num_key_value_heads=4,
        max_position_embeddings=32768,
        norm_type="rmsnorm",
        norm_bias=False,
        norm_eps=1e-6,
        positions="rope",
        rope_theta=1000000.0,
        activation="silu",
        glu=True,
        parallel_block=False,
        qkv_bias=True,      # Qwen2's deviation from LLaMA
        out_bias=False,
        mlp_bias=False,
        tie_word_embeddings=False,
    )
    d.update(kw)
    return DecoderConfig(**d)


def qwen2_7b(**kw) -> DecoderConfig:
    return config(**kw)


def tiny(**kw) -> DecoderConfig:
    d = dict(vocab_size=256, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
             num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=128)
    d.update(kw)
    return config(**d)


def from_hf(hf: Dict[str, Any], **kw) -> DecoderConfig:
    if hf.get("model_type", "qwen2") != "qwen2":
        # qwen2_moe has its own family and detect_family matches the longest
        # key first, so only other variants (qwen2_vl, ...) land here: their
        # weights do not fit the dense decoder
        raise NotImplementedError(
            f"model_type {hf['model_type']!r} is not dense Qwen2 "
            "(use the qwen2_moe family for MoE; VL is unsupported)")
    if hf.get("use_sliding_window"):
        # this family runs full causal attention: a sliding-window
        # checkpoint would part from HF past the window
        raise NotImplementedError(
            "Qwen2 sliding-window attention (use_sliding_window=true) is not supported; "
            "load a full-attention checkpoint")
    d = dict(
        vocab_size=hf.get("vocab_size", 151936),
        hidden_size=hf["hidden_size"],
        intermediate_size=hf["intermediate_size"],
        num_hidden_layers=hf["num_hidden_layers"],
        num_attention_heads=hf["num_attention_heads"],
        num_key_value_heads=hf.get("num_key_value_heads", hf["num_attention_heads"]),
        max_position_embeddings=hf.get("max_position_embeddings", 32768),
        norm_eps=hf.get("rms_norm_eps", 1e-6),
        rope_theta=hf.get("rope_theta", 1000000.0),
        tie_word_embeddings=hf.get("tie_word_embeddings", False),
    )
    d.update(kw)
    return config(**d)


def convert_hf_state_dict(sd: Dict[str, torch.Tensor], cfg: DecoderConfig, *,
                          device: Any = None) -> Dict[str, Any]:
    """HF ``Qwen2ForCausalLM`` state dict → this family's parameter tree
    in ``cfg.dtype`` on ``device`` (``"cuda"`` unless the caller names
    another)."""
    from ..serve.engine import resolve_device

    dev, dt, pre = resolve_device(device), cfg.dtype, "model."
    mats, vecs = layer_stackers(sd, pre, cfg.num_hidden_layers, dt, dev)
    layers = {
        "attn_norm_scale": vecs("layers.{}.input_layernorm.weight"),
        "mlp_norm_scale": vecs("layers.{}.post_attention_layernorm.weight"),
        "wq": mats("layers.{}.self_attn.q_proj.weight"),
        "wk": mats("layers.{}.self_attn.k_proj.weight"),
        "wv": mats("layers.{}.self_attn.v_proj.weight"),
        "bq": vecs("layers.{}.self_attn.q_proj.bias"),
        "bk": vecs("layers.{}.self_attn.k_proj.bias"),
        "bv": vecs("layers.{}.self_attn.v_proj.bias"),
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
