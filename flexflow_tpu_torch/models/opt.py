"""OPT model family — the port of ``flexflow_tpu/models/opt.py``: learned
absolute positions stored from index 2, pre-LN blocks with biases
everywhere, a ReLU FFN, tied embeddings. Runs on the generic decoder
(:mod:`.transformer`)."""
from __future__ import annotations

from typing import Any, Dict

import torch

from .hf_utils import layer_stackers, put
from .transformer import *  # noqa: F401,F403  (the serving protocol, transformer.__all__)
from .transformer import DecoderConfig


def config(**kw) -> DecoderConfig:
    d: Dict[str, Any] = dict(
        vocab_size=50272,
        hidden_size=768,
        intermediate_size=3072,
        num_hidden_layers=12,
        num_attention_heads=12,
        num_key_value_heads=12,
        max_position_embeddings=2048,
        norm_type="layernorm",
        norm_bias=True,
        norm_eps=1e-5,
        positions="learned",
        learned_pos_offset=2,
        activation="relu",
        glu=False,
        parallel_block=False,
        qkv_bias=True,
        out_bias=True,
        mlp_bias=True,
        tie_word_embeddings=True,
    )
    d.update(kw)
    return DecoderConfig(**d)


def opt_125m(**kw) -> DecoderConfig:
    return config(**kw)


def opt_6_7b(**kw) -> DecoderConfig:
    d = dict(hidden_size=4096, intermediate_size=16384, num_hidden_layers=32,
             num_attention_heads=32, num_key_value_heads=32)
    d.update(kw)
    return config(**d)


def tiny(**kw) -> DecoderConfig:
    d = dict(vocab_size=256, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
             num_attention_heads=4, num_key_value_heads=4, max_position_embeddings=128)
    d.update(kw)
    return config(**d)


def from_hf(hf: Dict[str, Any], **kw) -> DecoderConfig:
    if hf.get("word_embed_proj_dim", hf["hidden_size"]) != hf["hidden_size"]:
        raise NotImplementedError(
            "OPT word_embed_proj_dim != hidden_size (350m-style projection) is not supported")
    if not hf.get("do_layer_norm_before", True):
        raise NotImplementedError("post-norm OPT (do_layer_norm_before=False) is not supported")
    d = dict(
        vocab_size=hf["vocab_size"],
        hidden_size=hf["hidden_size"],
        intermediate_size=hf["ffn_dim"],
        num_hidden_layers=hf["num_hidden_layers"],
        num_attention_heads=hf["num_attention_heads"],
        num_key_value_heads=hf["num_attention_heads"],
        max_position_embeddings=hf["max_position_embeddings"],
        activation=hf.get("activation_function", "relu"),
    )
    d.update(kw)
    return config(**d)


def convert_hf_state_dict(sd: Dict[str, torch.Tensor], cfg: DecoderConfig, *,
                          device: Any = None) -> Dict[str, Any]:
    """HF ``OPTForCausalLM`` state dict → this family's parameter tree in
    ``cfg.dtype`` on ``device`` (``"cuda"`` unless the caller names
    another)."""
    from ..serve.engine import resolve_device

    dev, dt = resolve_device(device), cfg.dtype
    pre = "model.decoder."
    if pre + "embed_tokens.weight" not in sd and "decoder.embed_tokens.weight" in sd:
        pre = "decoder."
    mats, vecs = layer_stackers(sd, pre, cfg.num_hidden_layers, dt, dev)
    layers = {
        "attn_norm_scale": vecs("layers.{}.self_attn_layer_norm.weight"),
        "attn_norm_bias": vecs("layers.{}.self_attn_layer_norm.bias"),
        "wq": mats("layers.{}.self_attn.q_proj.weight"),
        "wk": mats("layers.{}.self_attn.k_proj.weight"),
        "wv": mats("layers.{}.self_attn.v_proj.weight"),
        "wo": mats("layers.{}.self_attn.out_proj.weight"),
        "bq": vecs("layers.{}.self_attn.q_proj.bias"),
        "bk": vecs("layers.{}.self_attn.k_proj.bias"),
        "bv": vecs("layers.{}.self_attn.v_proj.bias"),
        "bo": vecs("layers.{}.self_attn.out_proj.bias"),
        "mlp_norm_scale": vecs("layers.{}.final_layer_norm.weight"),
        "mlp_norm_bias": vecs("layers.{}.final_layer_norm.bias"),
        "w_up": mats("layers.{}.fc1.weight"),
        "b_up": vecs("layers.{}.fc1.bias"),
        "w_down": mats("layers.{}.fc2.weight"),
        "b_down": vecs("layers.{}.fc2.bias"),
    }
    return {"embed": put(sd[pre + "embed_tokens.weight"], dt, dev),
            "pos_embed": put(sd[pre + "embed_positions.weight"], dt, dev), "layers": layers,
            "final_norm_scale": put(sd[pre + "final_layer_norm.weight"], dt, dev),
            "final_norm_bias": put(sd[pre + "final_layer_norm.bias"], dt, dev)}
