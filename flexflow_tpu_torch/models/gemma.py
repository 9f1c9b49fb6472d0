"""Gemma model family (HF ``GemmaForCausalLM``) — the port of
``flexflow_tpu/models/gemma.py``: a head dim decoupled from hidden / heads
(Gemma-7B: 16 heads of 256 over a width of 3072), RMSNorm scaling by
(1 + w), sqrt(D) input-embedding scaling, a GeGLU FFN, tied embeddings.
Runs on the generic decoder (:mod:`.transformer`); the paged kernels take
its head dim of 256."""
from __future__ import annotations

from typing import Any, Dict

import torch

from .hf_utils import layer_stackers, linear_w, put
from .transformer import *  # noqa: F401,F403  (the serving protocol, transformer.__all__)
from .transformer import DecoderConfig


def config(**kw) -> DecoderConfig:
    d: Dict[str, Any] = dict(
        vocab_size=256000,
        hidden_size=3072,
        intermediate_size=24576,
        num_hidden_layers=28,
        num_attention_heads=16,
        num_key_value_heads=16,
        head_dim_override=256,
        max_position_embeddings=8192,
        norm_type="rmsnorm",
        norm_bias=False,
        norm_eps=1e-6,
        norm_plus_one=True,
        embed_scale=True,
        positions="rope",
        rope_theta=10000.0,
        activation="gelu_tanh",
        glu=True,
        qkv_bias=False,
        out_bias=False,
        mlp_bias=False,
        tie_word_embeddings=True,
    )
    d.update(kw)
    return DecoderConfig(**d)


def gemma_7b(**kw) -> DecoderConfig:
    return config(**kw)


def gemma_2b(**kw) -> DecoderConfig:
    d = dict(hidden_size=2048, intermediate_size=16384, num_hidden_layers=18,
             num_attention_heads=8, num_key_value_heads=1)
    d.update(kw)
    return config(**d)


def tiny(**kw) -> DecoderConfig:
    d = dict(vocab_size=256, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
             num_attention_heads=4, num_key_value_heads=1, head_dim_override=32,
             max_position_embeddings=128)
    d.update(kw)
    return config(**d)


_HF_ACTS = {"gelu": "gelu_tanh",  # HF Gemma's "gelu" is the tanh approximation
            "gelu_pytorch_tanh": "gelu_tanh", "gelu_fast": "gelu_tanh", "silu": "silu",
            "relu": "relu"}


def from_hf(hf: Dict[str, Any], **kw) -> DecoderConfig:
    mt = hf.get("model_type", "gemma")
    if mt != "gemma":
        # detect_family's substring fallback would route gemma2/gemma3 here:
        # their pre/post-FFN norms, logit softcapping and interleaved local
        # attention do not fit this converter
        raise NotImplementedError(
            f"model_type {mt!r} is not Gemma-1; gemma2/gemma3 architectures are "
            "unsupported")
    act = hf.get("hidden_activation") or hf.get("hidden_act") or "gelu"
    d = dict(
        vocab_size=hf["vocab_size"],
        hidden_size=hf["hidden_size"],
        intermediate_size=hf["intermediate_size"],
        num_hidden_layers=hf["num_hidden_layers"],
        num_attention_heads=hf["num_attention_heads"],
        num_key_value_heads=hf.get("num_key_value_heads", hf["num_attention_heads"]),
        head_dim_override=hf.get("head_dim", 256),
        max_position_embeddings=hf["max_position_embeddings"],
        norm_eps=hf.get("rms_norm_eps", 1e-6),
        rope_theta=hf.get("rope_theta", 10000.0),
        activation=_HF_ACTS.get(act, act),
        tie_word_embeddings=hf.get("tie_word_embeddings", True),
    )
    d.update(kw)
    return config(**d)


def convert_hf_state_dict(sd: Dict[str, torch.Tensor], cfg: DecoderConfig, *,
                          device: Any = None) -> Dict[str, Any]:
    """HF ``GemmaForCausalLM`` state dict (LLaMA's tensor names) → this
    family's parameter tree in ``cfg.dtype`` on ``device`` (``"cuda"``
    unless the caller names another). Norm weights stay HF's offsets from
    1: the decoder adds the 1 (``norm_plus_one``)."""
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
