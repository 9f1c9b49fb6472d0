"""StarCoder model family (HF ``GPTBigCodeForCausalLM``, also served under
the ``gpt_bigcode`` key) — the port of ``flexflow_tpu/models/starcoder.py``:
learned absolute positions, multi-query attention, biased LayerNorms and
projections, a gelu_tanh FFN, tied embeddings. Runs on the generic
decoder (:mod:`.transformer`)."""
from __future__ import annotations

from typing import Any, Dict

import torch

from .hf_utils import linear_w, put, stack
from .transformer import *  # noqa: F401,F403  (the serving protocol, transformer.__all__)
from .transformer import DecoderConfig


def config(**kw) -> DecoderConfig:
    d: Dict[str, Any] = dict(
        vocab_size=49152,
        hidden_size=6144,
        intermediate_size=4 * 6144,
        num_hidden_layers=40,
        num_attention_heads=48,
        num_key_value_heads=1,  # multi-query
        max_position_embeddings=8192,
        norm_type="layernorm",
        norm_bias=True,
        norm_eps=1e-5,
        positions="learned",
        learned_pos_offset=0,
        activation="gelu_tanh",
        glu=False,
        parallel_block=False,
        qkv_bias=True,
        out_bias=True,
        mlp_bias=True,
        tie_word_embeddings=True,
    )
    d.update(kw)
    return DecoderConfig(**d)


def starcoder_15b(**kw) -> DecoderConfig:
    return config(**kw)


def tiny(**kw) -> DecoderConfig:
    d = dict(vocab_size=256, hidden_size=64, intermediate_size=256, num_hidden_layers=2,
             num_attention_heads=4, num_key_value_heads=1, max_position_embeddings=128)
    d.update(kw)
    return config(**d)


def from_hf(hf: Dict[str, Any], **kw) -> DecoderConfig:
    d = dict(
        vocab_size=hf["vocab_size"],
        hidden_size=hf["n_embd"],
        intermediate_size=hf.get("n_inner") or 4 * hf["n_embd"],
        num_hidden_layers=hf["n_layer"],
        num_attention_heads=hf["n_head"],
        num_key_value_heads=1 if hf.get("multi_query", True) else hf["n_head"],
        max_position_embeddings=hf["n_positions"],
        norm_eps=hf.get("layer_norm_epsilon", 1e-5),
    )
    d.update(kw)
    return config(**d)


def convert_hf_state_dict(sd: Dict[str, torch.Tensor], cfg: DecoderConfig, *,
                          device: Any = None) -> Dict[str, Any]:
    """HF ``GPTBigCodeForCausalLM`` state dict → this family's parameter
    tree in ``cfg.dtype`` on ``device`` (``"cuda"`` unless the caller names
    another). The fused ``c_attn`` packs [H dk query | KV dk key | KV dk
    value] columns."""
    from ..serve.engine import resolve_device

    dev, dt, L, pre = resolve_device(device), cfg.dtype, cfg.num_hidden_layers, "transformer."
    H, KV, dk = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    qd, kvd = H * dk, KV * dk
    w = [linear_w(sd, f"{pre}h.{i}.attn.c_attn.weight") for i in range(L)]  # (D, qd+2kvd)
    b = [sd[f"{pre}h.{i}.attn.c_attn.bias"] for i in range(L)]

    def cols(ts, lo, hi):
        return stack([t[..., lo:hi] for t in ts], dt, dev)

    def vec(fmt):
        return stack([sd[pre + fmt.format(i)] for i in range(L)], dt, dev)

    def mat(fmt):
        return stack([linear_w(sd, pre + fmt.format(i)) for i in range(L)], dt, dev)

    layers = {
        "attn_norm_scale": vec("h.{}.ln_1.weight"),
        "attn_norm_bias": vec("h.{}.ln_1.bias"),
        "wq": cols(w, 0, qd), "wk": cols(w, qd, qd + kvd), "wv": cols(w, qd + kvd, qd + 2 * kvd),
        "bq": cols(b, 0, qd), "bk": cols(b, qd, qd + kvd), "bv": cols(b, qd + kvd, qd + 2 * kvd),
        "wo": mat("h.{}.attn.c_proj.weight"),
        "bo": vec("h.{}.attn.c_proj.bias"),
        "mlp_norm_scale": vec("h.{}.ln_2.weight"),
        "mlp_norm_bias": vec("h.{}.ln_2.bias"),
        "w_up": mat("h.{}.mlp.c_fc.weight"),
        "b_up": vec("h.{}.mlp.c_fc.bias"),
        "w_down": mat("h.{}.mlp.c_proj.weight"),
        "b_down": vec("h.{}.mlp.c_proj.bias"),
    }
    return {"embed": put(sd[pre + "wte.weight"], dt, dev),
            "pos_embed": put(sd[pre + "wpe.weight"], dt, dev), "layers": layers,
            "final_norm_scale": put(sd[pre + "ln_f.weight"], dt, dev),
            "final_norm_bias": put(sd[pre + "ln_f.bias"], dt, dev)}
