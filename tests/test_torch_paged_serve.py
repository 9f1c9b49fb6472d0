"""The port's serving stack on the paged KV cache: ``serve_step_paged``
logits and ``LLM.generate`` greedy tokens against the JAX package on the
same weights (f32 on the CPU), preemption under a tight page budget, the
fused RoPE + KV-write step against the unfused one, and the paged
configuration checks."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flexflow_tpu.models import llama as jl
from flexflow_tpu.serve import InferenceEngine as JaxInferenceEngine
from flexflow_tpu.serve import LLM as JaxLLM
from flexflow_tpu.serve import ServingConfig as JaxServingConfig
from flexflow_tpu_torch.models import llama as tl
from flexflow_tpu_torch.serve import LLM, InferenceEngine, ServingConfig
from flexflow_tpu_torch.serve import kernels as tk

torch.set_num_threads(1)

# f32 logits of two implementations of the same step: summation order
# only (the CUDA path's plain attention differs from the torch path's in
# how it applies the page scales)
LOGIT_ATOL = 1e-4


@pytest.fixture(scope="module")
def weights():
    cfg_j = jl.LLaMAConfig.tiny(dtype=jnp.float32)
    params_j = jl.init_params(jax.random.PRNGKey(5), cfg_j)
    cfg_t = tl.LLaMAConfig.tiny(dtype=torch.float32)
    params_t = tl.params_from_numpy(jax.tree.map(np.asarray, params_j), device="cpu")
    return cfg_j, params_j, cfg_t, params_t


@pytest.mark.parametrize("kv_quant", [None, "int8", "int4"])
@pytest.mark.parametrize("jax_kernels,port_kernels", [("xla", "torch"), ("pallas", "cuda")])
def test_serve_step_paged_logits_match_jax(weights, kv_quant, jax_kernels, port_kernels):
    """A prefill step (C=4, slot 2 idle) then a decode step, on the same
    pool and page table: f32 logits within LOGIT_ATOL of JAX's."""
    cfg_j, params_j, cfg_t, params_t = weights
    ps, P, NP = 8, 6, 4
    cache_len = NP * ps - 1
    table = np.array([[0, 1, P, P], [2, 3, P, P], [P, P, P, P]], np.int32)
    steps = [
        (np.array([[5, 9, 3, 7], [11, 2, 8, 1], [0, 0, 0, 0]], np.int32),
         np.array([[0, 1, 2, 3], [6, 7, 8, 9], [cache_len] * 4], np.int32),
         np.array([3, 3, 0], np.int32)),
        (np.array([[4], [6], [0]], np.int32),
         np.array([[4], [10], [cache_len]], np.int32),
         np.array([0, 0, 0], np.int32)),
    ]
    jcache = jl.init_paged_kv_cache(cfg_j, P, ps, kv_quant=kv_quant)
    tcache = tl.init_paged_kv_cache(cfg_t, P, ps, kv_quant=kv_quant)
    # slot 1's earlier lines [0, 6) are already in the cache
    warm = (np.array([[0] * 4, [13, 14, 15, 16], [0] * 4], np.int32),
            np.array([[cache_len] * 4, [0, 1, 2, 3], [cache_len] * 4], np.int32),
            np.zeros((3,), np.int32))
    for tokens, pos, lidx in [warm] + steps:
        want, jcache = jl.serve_step_paged(
            params_j, jcache, jnp.asarray(tokens), jnp.asarray(pos), jnp.asarray(lidx),
            None, None, jnp.asarray(table), cfg=cfg_j, cache_len=cache_len,
            kernels=jax_kernels, kv_quant=kv_quant)
        got, out_cache = tl.serve_step_paged(
            params_t, tcache, torch.from_numpy(tokens), torch.from_numpy(pos),
            torch.from_numpy(lidx), None, None, torch.from_numpy(table), cfg=cfg_t,
            cache_len=cache_len, kernels=port_kernels, kv_quant=kv_quant)
        assert out_cache is tcache  # updated in place
        live = [0, 1]
        np.testing.assert_allclose(got.numpy()[live], np.asarray(want)[live],
                                   atol=LOGIT_ATOL)


SERVE = dict(max_requests_per_batch=3, max_sequence_length=32, prefill_chunk=4,
             max_spec_tree_tokens=8, page_size=8)
# cache_len 40 → 6 pages per slot; a 48-token budget is 6 pages, one
# slot's worst case, against ~9 that the requests hold at their ends
TIGHT = dict(kv_layout="paged", max_cached_tokens=48, **SERVE)
PROMPTS = [list(range(3, 13)), [20, 21, 22, 23, 24, 25], list(range(40, 49)),
           [7, 8, 9], list(range(60, 71))]


def _port(weights, **serve):
    cfg_t, params_t = weights[2], weights[3]
    p = LLM(tl, cfg_t, params_t, device="cpu")
    p.compile(ServingConfig(cache_dtype=torch.float32, **serve))
    return p


@pytest.mark.parametrize("kv_quant", [None, "int8"])
def test_generate_paged_with_preemption_matches_jax(weights, kv_quant):
    """Greedy tokens under a budget that forces recompute preemption are
    exactly JAX's (its XLA path), on both port kernels paths; every page
    returns to the pool. The int8 budget is priced at bf16 (cache_dtype
    only prices a quantized pool), so it buys 11 pages; with 4 slots the
    requests hold up to 16 at their ends."""
    cfg_j, params_j = weights[:2]
    dt = (jnp.float32, torch.float32) if kv_quant is None else (jnp.bfloat16, torch.bfloat16)
    serve = dict(TIGHT, kv_quant=kv_quant,
                 max_requests_per_batch=3 if kv_quant is None else 4)
    m = JaxLLM(jl, cfg_j, params_j)
    m.compile(JaxServingConfig(cache_dtype=dt[0], kernels="xla", **serve))
    want = [r.output_tokens for r in m.generate(PROMPTS, max_new_tokens=20)]
    for kernels in ("torch", "cuda"):
        cfg_t, params_t = weights[2], weights[3]
        p = LLM(tl, cfg_t, params_t, device="cpu")
        p.compile(ServingConfig(cache_dtype=dt[1], kernels=kernels, **serve))
        got = [r.output_tokens for r in p.generate(PROMPTS, max_new_tokens=20)]
        assert got == want, kernels
        assert p.rm.stats.preemptions > 0
        assert p.rm.stats.snapshot()["preemptions"] == p.rm.stats.preemptions
        pager = p.engine.pager
        pager.check_no_leaks()
        assert pager.free_pages == pager.num_pages
        assert all(s is None for s in p.rm.slots)


@pytest.mark.parametrize("kv_quant", [None, "int8", "int4"])
def test_fused_rope_kv_write_tokens_equal_unfused(weights, kv_quant):
    outs = []
    for fused in ((), ("rope_kv_write",)):
        p = _port(weights, kernels="cuda", kv_quant=kv_quant, fused_decode=fused, **TIGHT)
        outs.append([r.output_tokens for r in p.generate(PROMPTS, max_new_tokens=8)])
    assert outs[0] == outs[1]


def test_paged_equals_dense_and_reset_repeats(weights):
    dense = _port(weights, **SERVE)
    want = [r.output_tokens for r in dense.generate(PROMPTS, max_new_tokens=6)]
    p = _port(weights, kv_layout="paged", **SERVE)
    assert [r.output_tokens for r in p.generate(PROMPTS, max_new_tokens=6)] == want
    cache = p.engine.cache
    p.engine.reset()
    assert p.engine.cache is cache and not any(bool(t.any()) for t in cache.values())
    assert p.engine.pager.free_pages == p.engine.pager.num_pages
    assert [r.output_tokens for r in p.generate(PROMPTS, max_new_tokens=6)] == want


@pytest.mark.parametrize("kv_quant", [None, "int8", "int4"])
def test_engine_paged_accounting_matches_jax(weights, kv_quant):
    cfg_j, params_j, cfg_t, params_t = weights
    serve = dict(kv_layout="paged", max_cached_tokens=100, kv_quant=kv_quant, **SERVE)
    je = JaxInferenceEngine(jl, cfg_j, params_j, JaxServingConfig(cache_dtype=jnp.bfloat16, **serve))
    te = InferenceEngine(tl, cfg_t, params_t, ServingConfig(cache_dtype=torch.bfloat16, **serve),
                         device="cpu")
    assert te.pager.num_pages == je.pager.num_pages
    assert te.kv_cache_bytes() == je.kv_cache_bytes()
    assert te.kv_bytes_per_line() == je.kv_bytes_per_line()
    assert te.pager.ensure(0, 20) and je.pager.ensure(0, 20)
    assert te.kv_allocated_bytes() == je.kv_allocated_bytes() > 0
    table = te.page_table_device()
    assert table.dtype == torch.int32 and table is te.page_table_device()  # cached
    assert te.pager.ensure(1, 3)
    assert te.page_table_device() is not table  # re-shipped after a change


def test_a_request_the_pool_can_never_hold_fails_like_jax(weights):
    """A prompt longer than the page budget ends with an error; the
    others are served."""
    prompts = [list(range(1, 50)), [5, 6, 7]]
    serve = dict(kv_layout="paged", max_cached_tokens=48, max_requests_per_batch=2,
                 max_sequence_length=64, prefill_chunk=4, max_spec_tree_tokens=8,
                 page_size=8)
    cfg_j, params_j = weights[:2]
    m = JaxLLM(jl, cfg_j, params_j)
    m.compile(JaxServingConfig(cache_dtype=jnp.float32, kernels="xla", **serve))
    want = m.generate(prompts, max_new_tokens=4)
    p = _port(weights, **serve)
    got = p.generate(prompts, max_new_tokens=4)
    assert [r.output_tokens for r in got] == [r.output_tokens for r in want]
    assert got[0].error is not None and want[0].error is not None
    assert "max_cached_tokens" in got[0].error
    assert got[1].error is None and p.rm.stats.failed == 1


@pytest.mark.parametrize("serve,exc", [
    (dict(kv_quant="int8"), ValueError),                                # dense layout
    (dict(fused_decode=("rope_kv_write",)), ValueError),                # dense layout
    (dict(kv_layout="paged", kv_quant="int3"), ValueError),
    (dict(kv_layout="paged", fused_decode=("bogus",)), ValueError),
])
def test_paged_validation_errors_match_jax(weights, serve, exc):
    cfg_j, params_j, cfg_t, params_t = weights
    with pytest.raises(exc):
        JaxInferenceEngine(jl, cfg_j, params_j, JaxServingConfig(**SERVE_NO_PS, **serve))
    with pytest.raises(exc):
        InferenceEngine(tl, cfg_t, params_t, ServingConfig(**SERVE_NO_PS, **serve),
                        device="cpu")


SERVE_NO_PS = {k: v for k, v in SERVE.items() if k != "page_size"}


def test_later_slice_fields_still_raise_and_head_dim_pack_is_checked(weights):
    cfg_t, params_t = weights[2], weights[3]
    for serve in (dict(prefix_caching=True), dict(fused_decode=("sampling",)),
                  dict(fused_decode=("whole_step",))):
        with pytest.raises(NotImplementedError, match="slice"):
            InferenceEngine(tl, cfg_t, params_t,
                            ServingConfig(kv_layout="paged", **SERVE, **serve), device="cpu")
    odd = dataclasses.replace(cfg_t, hidden_size=60)  # head_dim 15
    with pytest.raises(ValueError, match="head_dim"):
        tl.init_paged_kv_cache(odd, 4, 8, kv_quant="int4")
    with pytest.raises(ValueError, match="head_dim"):
        jl.init_paged_kv_cache(dataclasses.replace(weights[0], hidden_size=60), 4, 8,
                               kv_quant="int4")


def test_cpu_serving_launches_no_kernel(weights):
    before = dict(tk.LAUNCHES)
    _port(weights, kernels="cuda", fused_decode=("rope_kv_write",), **TIGHT).generate(
        PROMPTS[:2], max_new_tokens=3)
    assert tk.LAUNCHES == before
