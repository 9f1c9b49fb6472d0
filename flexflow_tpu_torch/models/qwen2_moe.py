"""Qwen2-MoE model family (HF ``Qwen2MoeForCausalLM``, e.g.
Qwen1.5-MoE-A2.7B) — the port of ``flexflow_tpu/models/qwen2_moe.py``:
the generic decoder's MoE FFN with routed experts of their own width, a
softmax over all experts whose selected top-k weights are kept without
renormalization (``norm_topk_prob=False``), and an always-on
sigmoid-gated shared expert; Qwen2's attention (RoPE, GQA, RMSNorm, Q/K/V
biases). Runs on the generic decoder (:mod:`.transformer`)."""
from __future__ import annotations

from typing import Any, Dict

import torch

from .hf_utils import layer_stackers, linear_w, put
from .mixtral import expert_stack
from .transformer import *  # noqa: F401,F403  (the serving protocol, transformer.__all__)
from .transformer import DecoderConfig


def config(**kw) -> DecoderConfig:
    d: Dict[str, Any] = dict(
        vocab_size=151936,
        hidden_size=2048,
        intermediate_size=5632,
        num_hidden_layers=24,
        num_attention_heads=16,
        num_key_value_heads=16,
        max_position_embeddings=8192,
        norm_type="rmsnorm",
        norm_bias=False,
        norm_eps=1e-6,
        positions="rope",
        rope_theta=1e6,
        activation="silu",
        glu=True,
        qkv_bias=True,
        out_bias=False,
        mlp_bias=False,
        tie_word_embeddings=False,
        num_local_experts=60,
        num_experts_per_tok=4,
        moe_intermediate_size=1408,
        moe_shared_expert_intermediate_size=5632,
        moe_norm_topk=False,
    )
    d.update(kw)
    return DecoderConfig(**d)


def tiny(**kw) -> DecoderConfig:
    d = dict(vocab_size=256, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
             num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=128,
             num_local_experts=4, num_experts_per_tok=2, moe_intermediate_size=96,
             moe_shared_expert_intermediate_size=112)
    d.update(kw)
    return config(**d)


def from_hf(hf: Dict[str, Any], **kw) -> DecoderConfig:
    if hf.get("decoder_sparse_step", 1) != 1 or hf.get("mlp_only_layers"):
        # every-Nth-layer MoE or forced-dense layers would need per-layer
        # FFN shapes in the stack
        raise NotImplementedError(
            "Qwen2-MoE with decoder_sparse_step != 1 or mlp_only_layers is not supported "
            "(non-uniform layer stacks)")
    if hf.get("use_sliding_window"):
        raise NotImplementedError("Qwen2-MoE sliding-window attention is not supported")
    d = dict(
        vocab_size=hf["vocab_size"],
        hidden_size=hf["hidden_size"],
        intermediate_size=hf["intermediate_size"],
        num_hidden_layers=hf["num_hidden_layers"],
        num_attention_heads=hf["num_attention_heads"],
        num_key_value_heads=hf.get("num_key_value_heads", hf["num_attention_heads"]),
        max_position_embeddings=hf["max_position_embeddings"],
        norm_eps=hf.get("rms_norm_eps", 1e-6),
        rope_theta=hf.get("rope_theta", 1e6),
        num_local_experts=hf.get("num_experts", 60),
        num_experts_per_tok=hf.get("num_experts_per_tok", 4),
        moe_intermediate_size=hf.get("moe_intermediate_size", 1408),
        moe_shared_expert_intermediate_size=hf.get("shared_expert_intermediate_size", 5632),
        moe_norm_topk=hf.get("norm_topk_prob", False),
        tie_word_embeddings=hf.get("tie_word_embeddings", False),
    )
    d.update(kw)
    return config(**d)


def convert_hf_state_dict(sd: Dict[str, torch.Tensor], cfg: DecoderConfig, *,
                          device: Any = None) -> Dict[str, Any]:
    """HF ``Qwen2MoeForCausalLM`` state dict → this family's parameter tree
    in ``cfg.dtype`` on ``device`` (``"cuda"`` unless the caller names
    another)."""
    from ..serve.engine import resolve_device

    dev, dt, L, pre = resolve_device(device), cfg.dtype, cfg.num_hidden_layers, "model."
    mats, vecs = layer_stackers(sd, pre, L, dt, dev)

    def experts(which):
        return expert_stack(sd, pre + "layers.{l}.mlp.experts.{e}." + which + ".weight", L,
                            cfg.num_local_experts, dt, dev)

    layers = {
        "attn_norm_scale": vecs("layers.{}.input_layernorm.weight"),
        "mlp_norm_scale": vecs("layers.{}.post_attention_layernorm.weight"),
        "wq": mats("layers.{}.self_attn.q_proj.weight"),
        "wk": mats("layers.{}.self_attn.k_proj.weight"),
        "wv": mats("layers.{}.self_attn.v_proj.weight"),
        "wo": mats("layers.{}.self_attn.o_proj.weight"),
        "bq": vecs("layers.{}.self_attn.q_proj.bias"),
        "bk": vecs("layers.{}.self_attn.k_proj.bias"),
        "bv": vecs("layers.{}.self_attn.v_proj.bias"),
        "w_router": mats("layers.{}.mlp.gate.weight"),
        "w_gate": experts("gate_proj"),
        "w_up": experts("up_proj"),
        "w_down": experts("down_proj"),
        "w_shared_up": mats("layers.{}.mlp.shared_expert.up_proj.weight"),
        "w_shared_gate": mats("layers.{}.mlp.shared_expert.gate_proj.weight"),
        "w_shared_down": mats("layers.{}.mlp.shared_expert.down_proj.weight"),
        "shared_expert_gate": mats("layers.{}.mlp.shared_expert_gate.weight"),
    }
    params = {"embed": put(sd[pre + "embed_tokens.weight"], dt, dev), "layers": layers,
              "final_norm_scale": put(sd[pre + "norm.weight"], dt, dev)}
    if not cfg.tie_word_embeddings:
        params["lm_head"] = put(linear_w(sd, "lm_head.weight"), dt, dev)
    return params
