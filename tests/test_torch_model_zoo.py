"""The port's model families against HuggingFace ``transformers``: tiny
randomly initialised HF models built in the test (no download), their
state dicts converted by each family's ``convert_hf_state_dict``, the
port's ``serve_step(all_logits=True)`` over a prompt held to HF's logits
(at the JAX package's tolerance, tests/test_model_zoo.py), and each family
served from a checkpoint directory through ``LLM.from_pretrained`` to HF's
greedy tokens; then the ``from_hf`` guards the JAX package tests."""
import dataclasses

import numpy as np
import pytest
import torch

import flexflow_tpu_torch.models as tzoo
from flexflow_tpu_torch.models import (falcon, gemma, gpt2, llama, mistral, mixtral, mpt, opt,
                                       phi, qwen2, qwen2_moe, starcoder)
from flexflow_tpu_torch.models.transformer import DecoderConfig
from flexflow_tpu_torch.serve import LLM, ServingConfig

transformers = pytest.importorskip("transformers")

torch.set_num_threads(1)

B, S, V = 2, 17, 256
# the JAX package's HF alignment tolerance (tests/test_model_zoo.py)
HF_TOL = dict(atol=3e-4, rtol=3e-4)


def _hf_llama():
    return transformers.LlamaForCausalLM(transformers.LlamaConfig(
        vocab_size=V, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=128)), llama


def _hf_opt():
    return transformers.OPTForCausalLM(transformers.OPTConfig(
        vocab_size=V, hidden_size=64, ffn_dim=128, num_hidden_layers=2, num_attention_heads=4,
        max_position_embeddings=128, word_embed_proj_dim=64, do_layer_norm_before=True)), opt


def _hf_falcon():
    return transformers.FalconForCausalLM(transformers.FalconConfig(
        vocab_size=V, hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
        multi_query=True, parallel_attn=True, new_decoder_architecture=False, bias=False,
        alibi=False, max_position_embeddings=128)), falcon


def _hf_mpt():
    return transformers.MptForCausalLM(transformers.MptConfig(
        d_model=64, n_heads=4, n_layers=2, vocab_size=V, max_seq_len=128,
        expansion_ratio=4)), mpt


def _hf_starcoder():
    return transformers.GPTBigCodeForCausalLM(transformers.GPTBigCodeConfig(
        vocab_size=V, n_embd=64, n_layer=2, n_head=4, n_positions=128, multi_query=True,
        activation_function="gelu_pytorch_tanh")), starcoder


def _hf_qwen2():
    return transformers.Qwen2ForCausalLM(transformers.Qwen2Config(
        vocab_size=V, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=128,
        rope_theta=10000.0)), qwen2


def _hf_mistral():
    # a window of 8 < S: the window binds in the comparison
    return transformers.MistralForCausalLM(transformers.MistralConfig(
        vocab_size=V, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=128,
        sliding_window=8)), mistral


def _hf_gpt2():
    return transformers.GPT2LMHeadModel(transformers.GPT2Config(
        vocab_size=V, n_embd=64, n_layer=2, n_head=4, n_positions=128)), gpt2


def _hf_phi():
    # partial_rotary_factor 0.5: the pass-through half of each head
    return transformers.PhiForCausalLM(transformers.PhiConfig(
        vocab_size=V, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=4, partial_rotary_factor=0.5,
        max_position_embeddings=128)), phi


def _hf_gemma():
    return transformers.GemmaForCausalLM(transformers.GemmaConfig(
        vocab_size=V, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=1, head_dim=32,
        max_position_embeddings=128)), gemma


def _hf_qwen2_moe(norm_topk_prob=False):
    return transformers.Qwen2MoeForCausalLM(transformers.Qwen2MoeConfig(
        vocab_size=V, hidden_size=64, intermediate_size=128, moe_intermediate_size=96,
        shared_expert_intermediate_size=112, num_hidden_layers=2, num_attention_heads=4,
        num_key_value_heads=2, num_experts=4, num_experts_per_tok=2,
        norm_topk_prob=norm_topk_prob, max_position_embeddings=128,
        decoder_sparse_step=1)), qwen2_moe


def _hf_mixtral():
    return transformers.MixtralForCausalLM(transformers.MixtralConfig(
        vocab_size=V, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2, num_local_experts=4,
        num_experts_per_tok=2, max_position_embeddings=128, rope_theta=10000.0)), mixtral


BUILDERS = {
    "llama": _hf_llama, "qwen2": _hf_qwen2, "mixtral": _hf_mixtral,
    "qwen2_moe": _hf_qwen2_moe, "gemma": _hf_gemma, "phi": _hf_phi, "gpt2": _hf_gpt2,
    "mistral": _hf_mistral, "opt": _hf_opt, "falcon": _hf_falcon, "mpt": _hf_mpt,
    "starcoder": _hf_starcoder,
}


def _build(name, **kw):
    torch.manual_seed(0)
    hf_model, mod = BUILDERS[name](**kw)
    hf_model = hf_model.eval()
    cfg = mod.from_hf(hf_model.config.to_dict(), dtype=torch.float32)
    return hf_model, mod, cfg


def _prompt_logits(mod, cfg, params, tokens):
    """The port's serve_step over the whole prompt at once, logits at every
    position."""
    Bq, Sq = tokens.shape
    cache = mod.init_kv_cache(cfg, Bq, Sq + 7, dtype=torch.float32)
    pos = torch.arange(Sq).expand(Bq, Sq)
    logits, _ = mod.serve_step(params, cache, tokens, pos, torch.full((Bq,), Sq - 1), None,
                               cfg=cfg, all_logits=True)
    return logits


@pytest.mark.parametrize("name", sorted(BUILDERS))
def test_hf_alignment(name):
    """Every family's converted weights give HF's logits at every prompt
    position, through the port's serving step."""
    hf_model, mod, cfg = _build(name)
    params = mod.convert_hf_state_dict(hf_model.state_dict(), cfg, device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(0).integers(0, V, size=(B, S)))
    with torch.no_grad():
        want = hf_model(tokens).logits.float()
    torch.testing.assert_close(_prompt_logits(mod, cfg, params, tokens), want, **HF_TOL)


def test_qwen2_moe_norm_topk_variant():
    """norm_topk_prob=True renormalizes the selected experts' weights: both
    router semantics match HF."""
    hf_model, mod, cfg = _build("qwen2_moe", norm_topk_prob=True)
    assert cfg.moe_norm_topk
    params = mod.convert_hf_state_dict(hf_model.state_dict(), cfg, device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(3).integers(0, V, size=(2, 11)))
    with torch.no_grad():
        want = hf_model(tokens).logits.float()
    torch.testing.assert_close(_prompt_logits(mod, cfg, params, tokens), want, **HF_TOL)


@pytest.mark.parametrize("name", sorted(BUILDERS))
def test_from_pretrained_serves_hf_greedy_tokens(name, tmp_path):
    """Every family builds from a checkpoint directory written by HF
    (``LLM.from_pretrained``, family by ``detect_family``) and serves HF's
    greedy tokens on the paged layout under kernels="torch"."""
    hf_model, mod, _ = _build(name)
    hf_model.save_pretrained(tmp_path / name)
    llm = LLM.from_pretrained(str(tmp_path / name), dtype=torch.float32, tokenizer=None,
                              device="cpu")
    assert llm.family is mod
    llm.compile(ServingConfig(max_requests_per_batch=2, max_sequence_length=32,
                              prefill_chunk=4, page_size=8, kv_layout="paged",
                              kernels="torch", cache_dtype=torch.float32))
    prompts = [[5, 6, 7, 8, 9, 10, 11], [9, 10, 11, 12]]
    got = [r.output_tokens for r in llm.generate(prompts, max_new_tokens=5)]
    hf_model.generation_config.eos_token_id = None  # the port's manager has no EOS here
    with torch.no_grad():
        for p, out in zip(prompts, got):
            want = hf_model.generate(torch.tensor([p]), max_new_tokens=5, do_sample=False,
                                     pad_token_id=0)[0, len(p):].tolist()
            assert out == want


BASE = dict(vocab_size=128, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
            num_attention_heads=4, max_position_embeddings=128)


def test_family_registry_and_qwen2_guard():
    assert set(tzoo.FAMILIES) == {"llama", "opt", "falcon", "mpt", "starcoder", "gpt_bigcode",
                                  "qwen2", "mixtral", "mistral", "qwen2_moe", "gemma", "phi",
                                  "gpt2"}
    # non-dense Qwen2 variants are refused, not converted as dense
    with pytest.raises(NotImplementedError, match="qwen2_moe"):
        qwen2.from_hf({"model_type": "qwen2_moe", **BASE})
    with pytest.raises(NotImplementedError, match="sliding"):
        qwen2.from_hf({"model_type": "qwen2", "use_sliding_window": True, **BASE})


def test_mixtral_guards():
    """A sliding window carries through (null or absent: full causal); the
    MoE FFN refuses mlp_bias."""
    assert mixtral.from_hf({**BASE, "max_position_embeddings": 4096,
                            "sliding_window": 1024}).sliding_window == 1024
    assert mixtral.from_hf({**BASE, "sliding_window": None}).sliding_window == 0
    with pytest.raises(ValueError, match="mlp_bias"):
        mixtral.config(mlp_bias=True)


def test_qwen2_moe_guards():
    with pytest.raises(NotImplementedError, match="sparse_step"):
        qwen2_moe.from_hf({**BASE, "decoder_sparse_step": 2})
    with pytest.raises(NotImplementedError, match="sparse_step"):
        qwen2_moe.from_hf({**BASE, "mlp_only_layers": [0]})
    with pytest.raises(NotImplementedError, match="sliding"):
        qwen2_moe.from_hf({**BASE, "use_sliding_window": True})


def test_gemma_guards_and_replace_safety():
    """gemma2/gemma3 are refused; dataclasses.replace re-derives the head
    dim without an override and keeps an explicit one."""
    with pytest.raises(NotImplementedError, match="gemma2"):
        gemma.from_hf({"model_type": "gemma2", **BASE})
    cfg = DecoderConfig(hidden_size=768, num_attention_heads=12)
    assert cfg.head_dim == 64
    assert dataclasses.replace(cfg, num_attention_heads=8).head_dim == 96
    assert dataclasses.replace(gemma.tiny(), num_hidden_layers=1).head_dim == 32
    assert gemma.gemma_7b().head_dim == 256


def test_phi_guards():
    with pytest.raises(NotImplementedError, match="phi3"):
        phi.from_hf({**BASE, "model_type": "phi3"})
    with pytest.raises(NotImplementedError, match="qk_layernorm"):
        phi.from_hf({**BASE, "qk_layernorm": True})
    with pytest.raises(ValueError, match="odd rotary"):
        phi.tiny(rotary_pct=0.45)  # head dim 16: a rotary width of 7
    assert phi.phi_2().head_dim == 80 and phi.phi_2().rotary_dim == 32


def test_gpt2_guards_and_activation():
    base = dict(model_type="gpt2", vocab_size=128, n_embd=64, n_layer=2, n_head=4,
                n_positions=128)
    with pytest.raises(NotImplementedError, match="scale_attn_by"):
        gpt2.from_hf({**base, "scale_attn_by_inverse_layer_idx": True})
    with pytest.raises(NotImplementedError, match="scale_attn_weights"):
        gpt2.from_hf({**base, "scale_attn_weights": False})
    assert gpt2.from_hf({**base, "activation_function": "relu"}).activation == "relu"
    assert gpt2.from_hf(base).activation == "gelu_tanh"


def test_opt_guards():
    with pytest.raises(NotImplementedError, match="word_embed_proj_dim"):
        opt.from_hf({**BASE, "ffn_dim": 128, "word_embed_proj_dim": 32})
    with pytest.raises(NotImplementedError, match="post-norm"):
        opt.from_hf({**BASE, "ffn_dim": 128, "do_layer_norm_before": False})
    assert opt.opt_6_7b().learned_pos_offset == 2


def test_falcon_splits_both_fused_qkv_layouts():
    """The old (MQA) layout stacks the query heads, then K, then V; the new
    one interleaves [G queries, k, v] per KV head."""
    D, dk = 8, 2
    for new_arch, (H, KV) in ((False, (4, 1)), (True, (4, 2))):
        cfg = falcon.config(hidden_size=D, num_attention_heads=H, num_key_value_heads=KV,
                            parallel_two_norms=new_arch, vocab_size=16, num_hidden_layers=1)
        assert cfg.head_dim == dk
        cols = torch.arange((H + 2 * KV) * dk, dtype=torch.float32).expand(D, -1)
        wq, wk, wv = falcon._split_fused_qkv(cols, cfg, new_arch)
        head = (cols[0].reshape(-1, dk)[:, 0] // dk).long()  # each column's fused head
        if new_arch:
            G = H // KV
            fused = head.reshape(KV, G + 2)
            want_q, want_k, want_v = fused[:, :G].reshape(-1), fused[:, G], fused[:, G + 1]
        else:
            want_q, want_k, want_v = head[:H], head[H:H + KV], head[H + KV:]
        for w, want in ((wq, want_q), (wk, want_k), (wv, want_v)):
            assert torch.equal((w[0].reshape(-1, dk)[:, 0] // dk).long(), want)
