"""MPT model family — the port of ``flexflow_tpu/models/mpt.py``: an ALiBi
attention bias (no positional embeddings), bias-free LayerNorms, unbiased
MHA and GELU FFN, a tied LM head. Runs on the generic decoder
(:mod:`.transformer`), whose cache then carries each line's position so
the bias is computed against the keys' true positions
(``transformer.needs_pos_cache``). The paged kernels take no additive
bias: under ``kernels="cuda"`` its steps attend on the plain path, and the
engine counts them (``InferenceEngine.plain_attention_steps``)."""
from __future__ import annotations

from typing import Any, Dict

import torch

from .hf_utils import layer_stackers, linear_w, put, stack
from .transformer import *  # noqa: F401,F403  (the serving protocol, transformer.__all__)
from .transformer import DecoderConfig


def config(**kw) -> DecoderConfig:
    d: Dict[str, Any] = dict(
        vocab_size=50368,
        hidden_size=4096,
        intermediate_size=4 * 4096,
        num_hidden_layers=32,
        num_attention_heads=32,
        num_key_value_heads=32,
        max_position_embeddings=2048,
        norm_type="layernorm",
        norm_bias=False,
        norm_eps=1e-5,
        positions="alibi",
        activation="gelu",
        glu=False,
        parallel_block=False,
        qkv_bias=False,
        out_bias=False,
        mlp_bias=False,
        tie_word_embeddings=True,
    )
    d.update(kw)
    return DecoderConfig(**d)


def mpt_7b(**kw) -> DecoderConfig:
    return config(**kw)


def tiny(**kw) -> DecoderConfig:
    d = dict(vocab_size=256, hidden_size=64, intermediate_size=256, num_hidden_layers=2,
             num_attention_heads=4, num_key_value_heads=4, max_position_embeddings=128)
    d.update(kw)
    return config(**d)


def from_hf(hf: Dict[str, Any], **kw) -> DecoderConfig:
    d = dict(
        vocab_size=hf["vocab_size"],
        hidden_size=hf["d_model"],
        intermediate_size=hf.get("expansion_ratio", 4) * hf["d_model"],
        num_hidden_layers=hf["n_layers"],
        num_attention_heads=hf["n_heads"],
        num_key_value_heads=hf["n_heads"],
        max_position_embeddings=hf.get("max_seq_len", 2048),
    )
    d.update(kw)
    return config(**d)


def convert_hf_state_dict(sd: Dict[str, torch.Tensor], cfg: DecoderConfig, *,
                          device: Any = None) -> Dict[str, Any]:
    """HF ``MptForCausalLM`` state dict → this family's parameter tree in
    ``cfg.dtype`` on ``device`` (``"cuda"`` unless the caller names
    another). The fused ``Wqkv`` (3D, D) splits into equal Q/K/V thirds."""
    from ..serve.engine import resolve_device

    dev, dt, D, L = resolve_device(device), cfg.dtype, cfg.hidden_size, cfg.num_hidden_layers
    pre = "transformer."
    mats, vecs = layer_stackers(sd, pre, L, dt, dev)
    w = [linear_w(sd, f"{pre}blocks.{i}.attn.Wqkv.weight") for i in range(L)]  # (D, 3D)
    layers = {f"w{name}": stack([t[:, s * D:(s + 1) * D] for t in w], dt, dev)
              for s, name in enumerate("qkv")}
    layers.update(
        attn_norm_scale=vecs("blocks.{}.norm_1.weight"),
        wo=mats("blocks.{}.attn.out_proj.weight"),
        mlp_norm_scale=vecs("blocks.{}.norm_2.weight"),
        w_up=mats("blocks.{}.ffn.up_proj.weight"),
        w_down=mats("blocks.{}.ffn.down_proj.weight"),
    )
    return {"embed": put(sd[pre + "wte.weight"], dt, dev), "layers": layers,
            "final_norm_scale": put(sd[pre + "norm_f.weight"], dt, dev)}
