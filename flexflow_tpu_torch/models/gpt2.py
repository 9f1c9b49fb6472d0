"""GPT-2 model family (HF ``GPT2LMHeadModel``) — the port of
``flexflow_tpu/models/gpt2.py``: learned absolute positions, pre-LN
blocks with biases everywhere, a gelu_tanh FFN, MHA, tied embeddings. The
converter splits HF's fused ``c_attn`` and keeps Conv1D's (in, out)
orientation (HF's Conv1D stores weights untransposed, unlike
``nn.Linear``). Runs on the generic decoder (:mod:`.transformer`)."""
from __future__ import annotations

from typing import Any, Dict

import torch

from .hf_utils import layer_stackers, put, stack
from .transformer import *  # noqa: F401,F403  (the serving protocol, transformer.__all__)
from .transformer import DecoderConfig


def config(**kw) -> DecoderConfig:
    d: Dict[str, Any] = dict(
        vocab_size=50257,
        hidden_size=768,
        intermediate_size=3072,
        num_hidden_layers=12,
        num_attention_heads=12,
        num_key_value_heads=12,
        max_position_embeddings=1024,
        norm_type="layernorm",
        norm_bias=True,
        norm_eps=1e-5,
        positions="learned",
        learned_pos_offset=0,
        activation="gelu_tanh",
        glu=False,
        qkv_bias=True,
        out_bias=True,
        mlp_bias=True,
        tie_word_embeddings=True,
    )
    d.update(kw)
    return DecoderConfig(**d)


def gpt2_small(**kw) -> DecoderConfig:
    return config(**kw)


def gpt2_xl(**kw) -> DecoderConfig:
    d = dict(hidden_size=1600, intermediate_size=6400, num_hidden_layers=48,
             num_attention_heads=25, num_key_value_heads=25)
    d.update(kw)
    return config(**d)


def tiny(**kw) -> DecoderConfig:
    d = dict(vocab_size=256, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
             num_attention_heads=4, num_key_value_heads=4, max_position_embeddings=128)
    d.update(kw)
    return config(**d)


_HF_ACTS = {"gelu_new": "gelu_tanh", "gelu_pytorch_tanh": "gelu_tanh",
            "gelu_fast": "gelu_tanh", "gelu": "gelu", "relu": "relu", "silu": "silu"}


def from_hf(hf: Dict[str, Any], **kw) -> DecoderConfig:
    mt = hf.get("model_type", "gpt2")
    if mt != "gpt2":
        raise NotImplementedError(f"model_type {mt!r} is not GPT-2")
    # attention variants this decoder does not implement fail loudly, not
    # as silently wrong tokens
    for knob in ("scale_attn_by_inverse_layer_idx", "reorder_and_upcast_attn"):
        if hf.get(knob):
            raise NotImplementedError(f"GPT-2 {knob}=True is not supported")
    if not hf.get("scale_attn_weights", True):
        raise NotImplementedError("GPT-2 scale_attn_weights=False is not supported")
    act = hf.get("activation_function", "gelu_new")
    d = dict(
        vocab_size=hf["vocab_size"],
        hidden_size=hf["n_embd"],
        intermediate_size=hf.get("n_inner") or 4 * hf["n_embd"],
        num_hidden_layers=hf["n_layer"],
        num_attention_heads=hf["n_head"],
        num_key_value_heads=hf["n_head"],
        max_position_embeddings=hf["n_positions"],
        norm_eps=hf.get("layer_norm_epsilon", 1e-5),
        activation=_HF_ACTS.get(act, act),
    )
    d.update(kw)
    return config(**d)


def convert_hf_state_dict(sd: Dict[str, torch.Tensor], cfg: DecoderConfig, *,
                          device: Any = None) -> Dict[str, Any]:
    """HF ``GPT2LMHeadModel`` state dict → this family's parameter tree in
    ``cfg.dtype`` on ``device`` (``"cuda"`` unless the caller names
    another)."""
    from ..serve.engine import resolve_device

    dev, dt, D, L = resolve_device(device), cfg.dtype, cfg.hidden_size, cfg.num_hidden_layers
    pre = "transformer." if "transformer.wte.weight" in sd else ""
    # Conv1D weights are (in, out) already: the untransposed stacker takes
    # them as it takes the vectors
    _, vecs = layer_stackers(sd, pre, L, dt, dev)
    w = [sd[pre + f"h.{i}.attn.c_attn.weight"] for i in range(L)]  # (D, 3D)
    b = [sd[pre + f"h.{i}.attn.c_attn.bias"] for i in range(L)]
    layers = {f"{kind}{name}": stack([t[..., s * D:(s + 1) * D] for t in ts], dt, dev)
              for kind, ts in (("w", w), ("b", b)) for s, name in enumerate("qkv")}
    layers.update(
        attn_norm_scale=vecs("h.{}.ln_1.weight"),
        attn_norm_bias=vecs("h.{}.ln_1.bias"),
        mlp_norm_scale=vecs("h.{}.ln_2.weight"),
        mlp_norm_bias=vecs("h.{}.ln_2.bias"),
        wo=vecs("h.{}.attn.c_proj.weight"),
        bo=vecs("h.{}.attn.c_proj.bias"),
        w_up=vecs("h.{}.mlp.c_fc.weight"),
        b_up=vecs("h.{}.mlp.c_fc.bias"),
        w_down=vecs("h.{}.mlp.c_proj.weight"),
        b_down=vecs("h.{}.mlp.c_proj.bias"),
    )
    return {"embed": put(sd[pre + "wte.weight"], dt, dev),
            "pos_embed": put(sd[pre + "wpe.weight"], dt, dev), "layers": layers,
            "final_norm_scale": put(sd[pre + "ln_f.weight"], dt, dev),
            "final_norm_bias": put(sd[pre + "ln_f.bias"], dt, dev)}
