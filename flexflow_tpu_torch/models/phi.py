"""Phi model family (HF ``PhiForCausalLM``, Phi-1/1.5/2) — the port of
``flexflow_tpu/models/phi.py``: partial rotary embeddings (``rotary_pct``:
Phi-2 rotates the first 32 of each head's 80 dims), a Falcon-style
parallel block sharing one input LayerNorm, biases everywhere (Q/K/V,
output, MLP, LM head), a gelu_tanh FFN. Runs on the generic decoder
(:mod:`.transformer`); the paged kernels take its head dim of 80."""
from __future__ import annotations

from typing import Any, Dict

import torch

from .hf_utils import layer_stackers, linear_w, put
from .transformer import *  # noqa: F401,F403  (the serving protocol, transformer.__all__)
from .transformer import DecoderConfig


def config(**kw) -> DecoderConfig:
    d: Dict[str, Any] = dict(
        vocab_size=51200,
        hidden_size=2560,
        intermediate_size=10240,
        num_hidden_layers=32,
        num_attention_heads=32,
        num_key_value_heads=32,
        max_position_embeddings=2048,
        norm_type="layernorm",
        norm_bias=True,
        norm_eps=1e-5,
        positions="rope",
        rope_theta=10000.0,
        rotary_pct=0.4,
        activation="gelu_tanh",
        glu=False,
        parallel_block=True,
        parallel_two_norms=False,
        qkv_bias=True,
        out_bias=True,
        mlp_bias=True,
        tie_word_embeddings=False,
        lm_head_bias=True,
    )
    d.update(kw)
    return DecoderConfig(**d)


def phi_2(**kw) -> DecoderConfig:
    return config(**kw)


def tiny(**kw) -> DecoderConfig:
    d = dict(vocab_size=256, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
             num_attention_heads=4, num_key_value_heads=4, max_position_embeddings=128,
             rotary_pct=0.5)
    d.update(kw)
    return config(**d)


_HF_ACTS = {"gelu_new": "gelu_tanh", "gelu_pytorch_tanh": "gelu_tanh",
            "gelu_fast": "gelu_tanh", "gelu": "gelu", "relu": "relu", "silu": "silu"}


def from_hf(hf: Dict[str, Any], **kw) -> DecoderConfig:
    mt = hf.get("model_type", "phi")
    if mt != "phi":
        # detect_family's substring fallback would route phi3/phi4/phimoe
        # here: their fused qkv/gate_up projections and SwiGLU do not fit
        raise NotImplementedError(
            f"model_type {mt!r} is not Phi-1/2; phi3/phi4/phimoe architectures are "
            "unsupported")
    if hf.get("qk_layernorm"):
        # the per-head q/k layernorm weights would be dropped: wrong logits
        raise NotImplementedError("Phi qk_layernorm=True is not supported")
    act = hf.get("hidden_act", "gelu_new")
    d = dict(
        vocab_size=hf["vocab_size"],
        hidden_size=hf["hidden_size"],
        intermediate_size=hf["intermediate_size"],
        num_hidden_layers=hf["num_hidden_layers"],
        num_attention_heads=hf["num_attention_heads"],
        num_key_value_heads=hf.get("num_key_value_heads", hf["num_attention_heads"]),
        max_position_embeddings=hf["max_position_embeddings"],
        norm_eps=hf.get("layer_norm_eps", 1e-5),
        rope_theta=hf.get("rope_theta", 10000.0),
        rotary_pct=hf.get("partial_rotary_factor", 0.5),
        activation=_HF_ACTS.get(act, act),
        tie_word_embeddings=hf.get("tie_word_embeddings", False),
    )
    d.update(kw)
    return config(**d)


def convert_hf_state_dict(sd: Dict[str, torch.Tensor], cfg: DecoderConfig, *,
                          device: Any = None) -> Dict[str, Any]:
    """HF ``PhiForCausalLM`` state dict → this family's parameter tree in
    ``cfg.dtype`` on ``device`` (``"cuda"`` unless the caller names
    another)."""
    from ..serve.engine import resolve_device

    dev, dt, pre = resolve_device(device), cfg.dtype, "model."
    mats, vecs = layer_stackers(sd, pre, cfg.num_hidden_layers, dt, dev)
    layers = {
        "attn_norm_scale": vecs("layers.{}.input_layernorm.weight"),
        "attn_norm_bias": vecs("layers.{}.input_layernorm.bias"),
        "wq": mats("layers.{}.self_attn.q_proj.weight"),
        "wk": mats("layers.{}.self_attn.k_proj.weight"),
        "wv": mats("layers.{}.self_attn.v_proj.weight"),
        "wo": mats("layers.{}.self_attn.dense.weight"),
        "bq": vecs("layers.{}.self_attn.q_proj.bias"),
        "bk": vecs("layers.{}.self_attn.k_proj.bias"),
        "bv": vecs("layers.{}.self_attn.v_proj.bias"),
        "bo": vecs("layers.{}.self_attn.dense.bias"),
        "w_up": mats("layers.{}.mlp.fc1.weight"),
        "b_up": vecs("layers.{}.mlp.fc1.bias"),
        "w_down": mats("layers.{}.mlp.fc2.weight"),
        "b_down": vecs("layers.{}.mlp.fc2.bias"),
    }
    return {"embed": put(sd[pre + "embed_tokens.weight"], dt, dev), "layers": layers,
            "final_norm_scale": put(sd[pre + "final_layernorm.weight"], dt, dev),
            "final_norm_bias": put(sd[pre + "final_layernorm.bias"], dt, dev),
            "lm_head": put(linear_w(sd, "lm_head.weight"), dt, dev),
            "lm_head_bias": put(sd["lm_head.bias"], dt, dev)}
