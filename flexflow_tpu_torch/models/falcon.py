"""Falcon model family — the port of ``flexflow_tpu/models/falcon.py``:
RoPE with MQA/GQA, *parallel* attention + MLP blocks (one shared input
LayerNorm on 7B, ln_attn/ln_mlp on the 40B "new decoder architecture"),
an unbiased GELU FFN. Runs on the generic decoder (:mod:`.transformer`)."""
from __future__ import annotations

from typing import Any, Dict

import torch

from .hf_utils import linear_w, put, stack
from .transformer import *  # noqa: F401,F403  (the serving protocol, transformer.__all__)
from .transformer import DecoderConfig


def config(**kw) -> DecoderConfig:
    d: Dict[str, Any] = dict(
        vocab_size=65024,
        hidden_size=4544,
        intermediate_size=4 * 4544,
        num_hidden_layers=32,
        num_attention_heads=71,
        num_key_value_heads=1,  # falcon-7b is MQA
        max_position_embeddings=2048,
        norm_type="layernorm",
        norm_bias=True,
        norm_eps=1e-5,
        positions="rope",
        activation="gelu",
        glu=False,
        parallel_block=True,
        parallel_two_norms=False,
        qkv_bias=False,
        out_bias=False,
        mlp_bias=False,
        tie_word_embeddings=False,
    )
    d.update(kw)
    return DecoderConfig(**d)


def falcon_7b(**kw) -> DecoderConfig:
    return config(**kw)


def tiny(**kw) -> DecoderConfig:
    d = dict(vocab_size=256, hidden_size=64, intermediate_size=256, num_hidden_layers=2,
             num_attention_heads=4, num_key_value_heads=1, max_position_embeddings=128)
    d.update(kw)
    return config(**d)


def from_hf(hf: Dict[str, Any], **kw) -> DecoderConfig:
    new_arch = hf.get("new_decoder_architecture", False)
    heads = hf.get("num_attention_heads", hf.get("n_head"))
    if new_arch:
        kv = hf.get("num_kv_heads", hf.get("n_head_kv", heads))
    elif hf.get("multi_query", True):
        kv = 1
    else:
        kv = heads
    d = dict(
        vocab_size=hf["vocab_size"],
        hidden_size=hf["hidden_size"],
        intermediate_size=hf.get("ffn_hidden_size", 4 * hf["hidden_size"]),
        num_hidden_layers=hf.get("num_hidden_layers", hf.get("n_layer")),
        num_attention_heads=heads,
        num_key_value_heads=kv,
        norm_eps=hf.get("layer_norm_epsilon", 1e-5),
        rope_theta=hf.get("rope_theta", 10000.0),
        parallel_two_norms=new_arch,
        # HF's FalconConfig ties by default, and a checkpoint's config.json
        # leaves a default out
        tie_word_embeddings=hf.get("tie_word_embeddings", True),
    )
    d.update(kw)
    return config(**d)


def _split_fused_qkv(w: torch.Tensor, cfg: DecoderConfig, new_arch: bool):
    """HF Falcon fuses QKV into one matmul. The old (7B, MQA) layout stacks
    all H query heads, then the KV key heads, then the KV value heads; the
    new (40B) one interleaves per KV group: [G query heads, k, v] × KV.
    ``w`` is already (in, out)."""
    D = cfg.hidden_size
    H, KV, dk = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    if new_arch:
        g = w.reshape(D, KV, H // KV + 2, dk)
        return (g[:, :, :-2, :].reshape(D, H * dk), g[:, :, -2, :].reshape(D, KV * dk),
                g[:, :, -1, :].reshape(D, KV * dk))
    g = w.reshape(D, H + 2 * KV, dk)
    return (g[:, :H, :].reshape(D, H * dk), g[:, H:H + KV, :].reshape(D, KV * dk),
            g[:, H + KV:, :].reshape(D, KV * dk))


def convert_hf_state_dict(sd: Dict[str, torch.Tensor], cfg: DecoderConfig, *,
                          device: Any = None) -> Dict[str, Any]:
    """HF ``FalconForCausalLM`` state dict → this family's parameter tree
    in ``cfg.dtype`` on ``device`` (``"cuda"`` unless the caller names
    another)."""
    from ..serve.engine import resolve_device

    dev, dt, L, pre = resolve_device(device), cfg.dtype, cfg.num_hidden_layers, "transformer."
    new_arch = cfg.parallel_two_norms
    qkv = [_split_fused_qkv(linear_w(sd, f"{pre}h.{i}.self_attention.query_key_value.weight"),
                            cfg, new_arch) for i in range(L)]

    def vec(fmt):
        return stack([sd[pre + fmt.format(i)] for i in range(L)], dt, dev)

    def mat(fmt):
        return stack([linear_w(sd, pre + fmt.format(i)) for i in range(L)], dt, dev)

    norms = (("attn_norm", "ln_attn"), ("mlp_norm", "ln_mlp")) if new_arch else (
        ("attn_norm", "input_layernorm"),)
    layers = {f"{ours}_{kind}": vec(f"h.{{}}.{theirs}.{hf_kind}")
              for ours, theirs in norms for kind, hf_kind in (("scale", "weight"),
                                                               ("bias", "bias"))}
    layers.update(
        wq=stack([t[0] for t in qkv], dt, dev),
        wk=stack([t[1] for t in qkv], dt, dev),
        wv=stack([t[2] for t in qkv], dt, dev),
        wo=mat("h.{}.self_attention.dense.weight"),
        w_up=mat("h.{}.mlp.dense_h_to_4h.weight"),
        w_down=mat("h.{}.mlp.dense_4h_to_h.weight"),
    )
    params = {"embed": put(sd[pre + "word_embeddings.weight"], dt, dev), "layers": layers,
              "final_norm_scale": put(sd[pre + "ln_f.weight"], dt, dev),
              "final_norm_bias": put(sd[pre + "ln_f.bias"], dt, dev)}
    if not cfg.tie_word_embeddings:
        params["lm_head"] = put(linear_w(sd, "lm_head.weight"), dt, dev)
    return params
