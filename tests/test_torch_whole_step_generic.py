"""The generic decoder's whole step (``fused_decode=("whole_step",)`` on the
families of models/transformer.py) on the CPU: ``serve_step_whole``'s
plain version against the JAX package's unfused paged step (its XLA path,
which JAX's own tests hold its whole step to) and, in one slow case,
against JAX's ``serve_step_whole`` in interpret mode; against the port's
own unfused step, bitwise at every tile count and in the speculation fold;
and the layouts the whole step refuses, in JAX's words."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flexflow_tpu.models as jzoo
import flexflow_tpu_torch.models as tzoo
from flexflow_tpu.models import transformer as jt
from flexflow_tpu_torch.models import hf_utils
from flexflow_tpu_torch.models import transformer as tt
from flexflow_tpu_torch.serve import kernels as tk
from flexflow_tpu_torch.serve import kv_quant as tq

torch.set_num_threads(1)

# f32 logits of two implementations of the same step: summation order only
LOGIT_ATOL = 1e-4
# f32 pool values written by the two frameworks' projections and RoPE
POOL_ATOL = 1e-5

BASE = dict(vocab_size=128, hidden_size=64, intermediate_size=96, num_hidden_layers=2,
            num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=64)
#: the bodies: JAX's "spicy" generic config (tests/test_whole_step.py:
#: LayerNorm with bias, every bias, partial rotary, an untied biased head);
#: Falcon's parallel block on one norm with MQA and GELU; a parallel block
#: on two norms with ReLU; OPT's learned positions at offset 2 on a tied
#: head; Gemma's RMS by 1 + w, GeGLU-tanh, the sqrt(D) embedding scale at
#: head dim 256; StarCoder's MQA with learned positions
CONFIGS = {
    "spicy": dict(norm_type="layernorm", norm_bias=True, activation="gelu_tanh",
                  rotary_pct=0.5, qkv_bias=True, out_bias=True, mlp_bias=True,
                  tie_word_embeddings=False, lm_head_bias=True),
    "parallel-one-norm": dict(num_key_value_heads=1, norm_type="layernorm", norm_bias=True,
                              activation="gelu", parallel_block=True,
                              tie_word_embeddings=False),
    "parallel-two-norms": dict(norm_type="layernorm", norm_bias=True, activation="relu",
                               parallel_block=True, parallel_two_norms=True, out_bias=True),
    "learned-offset": dict(norm_type="layernorm", norm_bias=True, positions="learned",
                           learned_pos_offset=2, activation="relu", qkv_bias=True,
                           out_bias=True, mlp_bias=True),
    "gemma-dk256": dict(num_attention_heads=2, num_key_value_heads=1, head_dim_override=256,
                        norm_type="rmsnorm", norm_bias=False, norm_plus_one=True,
                        embed_scale=True, activation="gelu_tanh", glu=True),
    "mqa-learned": dict(num_key_value_heads=1, norm_type="layernorm", norm_bias=True,
                        positions="learned", activation="gelu_tanh", qkv_bias=True,
                        out_bias=True, mlp_bias=True),
}


def _perturbed(tree, rng):
    """Norm scales at 1 + 0.2 N(0, 1) and biases at 0.2 N(0, 1) (the
    initial ones and zeros would hide a wrong offset)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _perturbed(v, rng)
        elif "norm" in k or k.startswith("b") or k.endswith("_bias"):
            out[k] = (rng.standard_normal(v.shape) * 0.2
                      + (1.0 if k.endswith("_scale") else 0.0)).astype(v.dtype)
        else:
            out[k] = v
    return out


@functools.lru_cache(maxsize=None)
def _weights(name):
    """(JAX config, JAX params, port config, port params): f32 weights of
    JAX's init_params, norms and biases perturbed, carried across."""
    kw = {**BASE, **CONFIGS[name]}
    cfg_j = jt.DecoderConfig(**kw, dtype=jnp.float32)
    cfg_t = tt.DecoderConfig(**kw, dtype=torch.float32)
    tree = jax.tree.map(np.asarray, jt.init_params(jax.random.PRNGKey(3), cfg_j))
    tree = _perturbed(tree, np.random.default_rng(5))
    return (cfg_j, jax.tree.map(jnp.asarray, tree), cfg_t,
            hf_utils.params_from_numpy(tree, device="cpu"))


# two slots of 4 pages of 8 lines over a pool of 6 pages (+ the scratch
# page); a warm-up prefill of slot 1's lines [0, 4) through the unfused
# step, then a mixed step (slot 0 prefills 4 lines, slot 1 takes 2 and a
# padding column) and a decode step through the whole step
PS, P, NP = 8, 6, 4
CACHE_LEN = NP * PS - 1
TABLE = np.array([[0, 1, P, P], [2, 3, P, P]], np.int32)
WARM = (np.array([[0, 0, 0, 0], [13, 14, 15, 16]], np.int32),
        np.array([[CACHE_LEN] * 4, [0, 1, 2, 3]], np.int32),
        np.zeros((2,), np.int32))
STEPS = [
    (np.array([[5, 9, 3, 7], [11, 2, 0, 0]], np.int32),
     np.array([[0, 1, 2, 3], [4, 5, CACHE_LEN, CACHE_LEN]], np.int32),
     np.array([3, 1], np.int32)),
    (np.array([[4], [6]], np.int32), np.array([[4], [6]], np.int32), np.zeros((2,), np.int32)),
]


def _jax_steps(cfg, params, kv_quant, whole=False):
    cache = jt.init_paged_kv_cache(cfg, P, PS, kv_quant=kv_quant)
    table = jnp.asarray(TABLE)
    paged = jax.jit(functools.partial(jt.serve_step_paged, cfg=cfg, cache_len=CACHE_LEN,
                                      kernels="xla", kv_quant=kv_quant))
    toks, pos, li = (jnp.asarray(a) for a in WARM)
    _, cache = paged(params, cache, toks, pos, li, None, None, table)
    if whole:
        step = jax.jit(functools.partial(jt.serve_step_whole, cfg=cfg, cache_len=CACHE_LEN,
                                         kv_quant=kv_quant))
    out = []
    for toks, pos, li in STEPS:
        toks, pos, li = (jnp.asarray(a) for a in (toks, pos, li))
        if whole:
            logits, _, cache = step(params, cache, toks, pos, li, table)
        else:
            logits, cache = paged(params, cache, toks, pos, li, None, None, table)
        out.append(np.asarray(logits))
    return out, {k: np.array(v) for k, v in cache.items()}


def _port_steps(cfg, params, kv_quant, tiles=1, kernels="torch", whole=True):
    cache = tt.init_paged_kv_cache(cfg, P, PS, kv_quant=kv_quant)
    table = torch.from_numpy(TABLE)
    toks, pos, li = (torch.from_numpy(a) for a in WARM)
    tt.serve_step_paged(params, cache, toks, pos, li, None, None, table, cfg=cfg,
                        cache_len=CACHE_LEN, kv_quant=kv_quant)
    out = []
    for toks, pos, li in STEPS:
        toks, pos, li = (torch.from_numpy(a) for a in (toks, pos, li))
        if whole:
            logits, greedy, same = tt.serve_step_whole(
                params, cache, toks, pos, li, table, cfg=cfg, cache_len=CACHE_LEN,
                kv_quant=kv_quant, tiles=tiles, kernels=kernels)
            assert same is cache and greedy.dtype == torch.int64
        else:
            logits, _ = tt.serve_step_paged(params, cache, toks, pos, li, None, None, table,
                                            cfg=cfg, cache_len=CACHE_LEN, kv_quant=kv_quant)
            greedy = torch.argmax(logits, dim=-1)
        out.append((logits, greedy))
    return out, cache


def _assert_near_jax(got, tcache, want, jcache, kv_quant):
    """Logits within LOGIT_ATOL, greedy tokens equal, non-scratch pools
    within POOL_ATOL (f32) or one quantization step (codes), scales within
    1e-6 relative."""
    for (gl, gt), wl in zip(got, want):
        np.testing.assert_allclose(gl.numpy(), wl, atol=LOGIT_ATOL)
        assert gt.tolist() == np.argmax(wl, axis=-1).tolist()
    pack = 1 if kv_quant is None else tq.SPECS[kv_quant].pack
    for name in ("k", "v"):
        a = tq.unpack_codes(tcache[name][:, :P], pack)
        b = tq.unpack_codes(torch.from_numpy(jcache[name][:, :P]), pack)
        assert float((a - b).abs().max()) <= (POOL_ATOL if kv_quant is None else 1.0), name
    if kv_quant is not None:
        for name in ("k_scale", "v_scale"):
            np.testing.assert_allclose(tcache[name].numpy()[:, :P], jcache[name][:, :P],
                                       rtol=1e-6, atol=0)


QUANTS = [None, "int8", pytest.param("int4", marks=pytest.mark.slow)]


@pytest.mark.parametrize("kv_quant", QUANTS)
@pytest.mark.parametrize("name", list(CONFIGS))
def test_whole_step_matches_jax(name, kv_quant):
    """A mixed and a decode step through the port's whole step (the kernel
    wrapper's CPU path, at tile count 2) against JAX's unfused XLA step on
    the same weights."""
    cfg_j, params_j, cfg_t, params_t = _weights(name)
    want, jcache = _jax_steps(cfg_j, params_j, kv_quant)
    got, tcache = _port_steps(cfg_t, params_t, kv_quant, tiles=2, kernels="cuda")
    _assert_near_jax(got, tcache, want, jcache, kv_quant)


@pytest.mark.slow  # JAX's Pallas walk in interpret mode
def test_whole_step_matches_jax_whole_step_in_interpret_mode():
    """The spicy config against JAX's own serve_step_whole (the Pallas
    walk, interpret mode) on f32 and int8 pools."""
    cfg_j, params_j, cfg_t, params_t = _weights("spicy")
    for kv_quant in (None, "int8"):
        want, jcache = _jax_steps(cfg_j, params_j, kv_quant, whole=True)
        got, tcache = _port_steps(cfg_t, params_t, kv_quant)
        _assert_near_jax(got, tcache, want, jcache, kv_quant)


def _model(name, pool):
    """Port config and params in the pool's model dtype: bf16 weights for
    "bf16" pools, else f32 (int8/int4 pools quantize f32 lines)."""
    cfg, params = _weights(name)[2:]
    if pool == "bf16":
        cfg = dataclasses.replace(cfg, dtype=torch.bfloat16)
        params = hf_utils.params_from_numpy(
            jax.tree.map(np.asarray, _weights(name)[1]), device="cpu", dtype=torch.bfloat16)
    return cfg, params, (pool if pool in ("int8", "int4") else None)


POOLS = ["f32", "bf16", "int8", "int4"]


@pytest.mark.parametrize("pool", POOLS)
@pytest.mark.parametrize("name", list(CONFIGS))
def test_whole_step_bitwise_unfused_port(name, pool):
    """Against the port's unfused paged step (kernels="torch"): logits,
    greedy tokens and every non-scratch pool byte bitwise at tile counts
    1, 2 and 4 (the tile count only groups the kernel's output columns),
    through the plain walk and the kernel wrapper's CPU path alike."""
    cfg, params, kv_quant = _model(name, pool)
    want, ucache = _port_steps(cfg, params, kv_quant, whole=False)
    for tiles in (1, 2, 4):
        for kernels in ("torch", "cuda"):
            got, wcache = _port_steps(cfg, params, kv_quant, tiles, kernels)
            for (gl, gt), (wl, wt) in zip(got, want):
                assert torch.equal(gl, wl) and torch.equal(gt, wt), (tiles, kernels)
            for k in wcache:
                assert torch.equal(wcache[k][:, :P], ucache[k][:, :P]), (k, tiles, kernels)


def _tree_step(C, rng):
    """A tree step over the warmed pool: slot 0 writes nodes at lines
    4 + i, slot 1 at lines 10 + 2 i (skipping lines), node i a child of an
    earlier node, RoPE position prefix + depth."""
    toks = rng.integers(1, 128, size=(2, C))
    pos = np.zeros((2, C), np.int64)
    cpos = np.zeros((2, C), np.int64)
    mask = np.zeros((2, C, CACHE_LEN + 1), bool)
    for s, (prefix, first, stride) in enumerate(((0, 0, 1), (4, 10, 2))):
        parents = [-1] + [int(rng.integers(0, i)) for i in range(1, C)]
        for i in range(C):
            depth, j = 0, i
            mask[s, i, :prefix] = True
            while j >= 0:
                mask[s, i, first + stride * j] = True
                j, depth = parents[j], depth + 1
            pos[s, i], cpos[s, i] = prefix + depth - 1, first + stride * i
    return [torch.from_numpy(a) for a in (toks, pos, cpos, mask)]


@pytest.mark.parametrize("pool", ["f32", "int8"])
@pytest.mark.parametrize("num_layers", [1, None])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_whole_step_fold_bitwise_unfused_port(name, num_layers, pool):
    """The speculation fold (a tree mask, slack cache lines, the
    all-positions head, the early-exit draft) against serve_step_paged
    with the same keywords: logits, greedy tokens and every pool byte,
    the deeper layers' untouched by the draft."""
    cfg, params, kv_quant = _model(name, pool)
    toks, pos, cpos, mask = _tree_step(5, np.random.default_rng(2))
    table = torch.from_numpy(TABLE)
    li = torch.zeros(2, dtype=torch.long)
    kw = dict(cfg=cfg, cache_len=CACHE_LEN, kv_quant=kv_quant, all_logits=True,
              num_layers=num_layers)

    def warmed():
        cache = tt.init_paged_kv_cache(cfg, P, PS, kv_quant=kv_quant)
        w = [torch.from_numpy(a) for a in WARM]
        tt.serve_step_paged(params, cache, *w, None, None, table, cfg=cfg,
                            cache_len=CACHE_LEN, kv_quant=kv_quant)
        return cache

    want_cache = warmed()
    before = {k: v.clone() for k, v in want_cache.items()}
    want, _ = tt.serve_step_paged(params, want_cache, toks, pos, li, mask, cpos, table, **kw)
    assert want.shape == (2, 5, cfg.vocab_size)
    for kernels, tiles in (("torch", 1), ("cuda", 2)):
        cache = warmed()
        logits, greedy, _ = tt.serve_step_whole(params, cache, toks, pos, li, table,
                                                tiles=tiles, kernels=kernels, mask=mask,
                                                cache_positions=cpos, **{
                                                    k: v for k, v in kw.items()})
        assert torch.equal(logits, want) and torch.equal(greedy, torch.argmax(want, dim=-1))
        for k in cache:
            assert torch.equal(cache[k], want_cache[k]), k
            if num_layers is not None:
                assert torch.equal(cache[k][num_layers:], before[k][num_layers:]), k


# ---------------------------------------------------------------------------
# the refusals and the family modules


@pytest.mark.parametrize("family", ["mixtral", "qwen2_moe", "mpt", "mistral"])
def test_refusals_match_jax(family):
    """MoE FFNs, ALiBi and the sliding window: the port's layout hook
    raises with the JAX package's message."""
    jm, tm = getattr(jzoo, family), getattr(tzoo, family)
    cfg_j, cfg_t = jm.tiny(dtype=jnp.float32), tm.tiny(dtype=torch.float32)
    params_j = jm.init_params(jax.random.PRNGKey(0), cfg_j)
    params_t = hf_utils.params_from_numpy(jax.tree.map(np.asarray, params_j), device="cpu")
    with pytest.raises(ValueError) as want:
        jm.whole_step_weight_layout(params_j, cfg_j)
    with pytest.raises(ValueError) as got:
        tm.whole_step_weight_layout(params_t, cfg_t)
    assert str(got.value) == str(want.value)


def test_weight_only_quantized_refusal_matches_jax():
    """A quantized {'q', 'scale'} layer tensor or LM head: JAX's words."""
    cfg_j, params_j, cfg_t, params_t = _weights("spicy")
    for where in ("layer", "head"):
        pj, pt = dict(params_j), dict(params_t)
        if where == "layer":
            pj["layers"] = {**pj["layers"], "wq": {"q": pj["layers"]["wq"], "scale": 1.0}}
            pt["layers"] = {**pt["layers"], "wq": {"q": pt["layers"]["wq"], "scale": 1.0}}
        else:
            pj["lm_head"] = {"q": pj["lm_head"], "scale": 1.0}
            pt["lm_head"] = {"q": pt["lm_head"], "scale": 1.0}
        with pytest.raises(ValueError) as want:
            jt.whole_step_weight_layout(pj, cfg_j)
        with pytest.raises(ValueError) as got:
            tt.whole_step_weight_layout(pt, cfg_t)
        assert str(got.value) == str(want.value)


FAMILIES = ["falcon", "phi", "gemma", "gpt2", "opt", "starcoder", "qwen2"]


@pytest.mark.parametrize("family", FAMILIES)
def test_families_reach_the_whole_step(family):
    """Each of the seven families advertises the whole step, re-exports
    the generic functions, and its published layout is one the CUDA
    kernel computes (meta tensors: the check reads shapes alone); its
    tile roles and body match JAX's roles."""
    tm, jm = getattr(tzoo, family), getattr(jzoo, family)
    assert "whole_step" in tm.FUSED_DECODE
    for fn in ("serve_step_whole", "whole_step_weight_layout", "whole_step_tile_roles",
               "whole_step_body"):
        assert getattr(tm, fn) is getattr(tt, fn)
    preset = {"falcon": "falcon_7b", "phi": "phi_2", "gemma": "gemma_7b", "gpt2": "gpt2_xl",
              "opt": "opt_6_7b", "starcoder": "starcoder_15b", "qwen2": "qwen2_7b"}[family]
    cfg = getattr(tm, preset)(num_hidden_layers=1)
    params = _meta_params(cfg)
    la, ha = tm.whole_step_weight_layout(params, cfg)
    L, D, H, KV, F, V = tk.whole_step_check_layout(
        la, ha, tile_roles=tm.whole_step_tile_roles(cfg), body=tm.whole_step_body(cfg),
        head_dim=cfg.head_dim)
    assert (L, D, H, KV, F, V) == (1, cfg.hidden_size, cfg.num_attention_heads,
                                   cfg.num_key_value_heads, cfg.intermediate_size,
                                   cfg.vocab_size)
    jcfg = getattr(jm, preset)(num_hidden_layers=1)
    assert tm.whole_step_tile_roles(cfg) == jm.whole_step_tile_roles(jcfg)


def _meta_params(cfg):
    specs = tt._param_specs(cfg)
    return {k: ({n: torch.empty(s[0], dtype=cfg.dtype, device="meta") for n, s in v.items()}
                if k == "layers" else torch.empty(v[0], dtype=cfg.dtype, device="meta"))
            for k, v in specs.items()}
