"""The port's serving stack end to end (flexflow_tpu_torch/serve): greedy
tokens from ``LLM.generate`` equal the JAX package's on the same
weights, f32 on the CPU, with and without continuous batching."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flexflow_tpu.models import llama as jl
from flexflow_tpu.serve import LLM as JaxLLM
from flexflow_tpu.serve import ServingConfig as JaxServingConfig
from flexflow_tpu_torch.models import llama as tl
from flexflow_tpu_torch.serve import LLM, InferenceEngine, ServingConfig

torch.set_num_threads(1)

# tests/test_kernels.py's prompts, one prompt spanning three prefill
# chunks (prefill_chunk=4), and more requests than the 2 slots
PROMPTS = [[7, 8, 9], [20, 21, 22, 23], list(range(30, 41)), [5, 6]]
SERVE = dict(max_requests_per_batch=2, max_sequence_length=64, prefill_chunk=4)


@pytest.fixture(scope="module")
def weights():
    cfg_j = jl.LLaMAConfig.tiny(dtype=jnp.float32)
    params_j = jl.init_params(jax.random.PRNGKey(3), cfg_j)
    cfg_t = tl.LLaMAConfig.tiny(dtype=torch.float32)
    params_t = tl.params_from_numpy(jax.tree.map(np.asarray, params_j), device="cpu")
    return cfg_j, params_j, cfg_t, params_t


def _generate_both(weights, jax_kernels, port_kernels, eos=None, **serve):
    cfg_j, params_j, cfg_t, params_t = weights
    m = JaxLLM(jl, cfg_j, params_j)
    m.compile(JaxServingConfig(cache_dtype=jnp.float32, kernels=jax_kernels,
                               **SERVE, **serve), eos_token_id=eos)
    want = [r.output_tokens for r in m.generate(PROMPTS, max_new_tokens=6)]
    p = LLM(tl, cfg_t, params_t, device="cpu")
    p.compile(ServingConfig(cache_dtype=torch.float32, kernels=port_kernels,
                            **SERVE, **serve), eos_token_id=eos)
    got = [r.output_tokens for r in p.generate(PROMPTS, max_new_tokens=6)]
    return got, want, p


@pytest.mark.parametrize("continuous_batching", [True, False])
@pytest.mark.parametrize("jax_kernels,port_kernels",
                         [("pallas", "cuda"), ("xla", "torch")])
def test_generate_matches_jax(weights, jax_kernels, port_kernels,
                              continuous_batching):
    got, want, p = _generate_both(weights, jax_kernels, port_kernels,
                                  continuous_batching=continuous_batching)
    assert got == want
    assert all(len(t) == 6 for t in got)
    stats = p.rm.stats
    if continuous_batching:
        assert stats.mixed_steps > 0 and stats.sync_steps == 0
    else:
        assert stats.sync_steps > 0 and stats.mixed_steps == 0
    assert all(s is None for s in p.rm.slots)  # every slot released


def test_generate_eos_matches_jax(weights):
    # token 170 is the first greedy output of the first prompt on these
    # weights: that request stops at once, the others when they meet it
    got, want, _ = _generate_both(weights, "pallas", "cuda", eos=170)
    assert got == want
    assert got[0] == [170]


def test_generate_dispatch_ahead_depth_does_not_change_tokens(weights):
    cfg_t, params_t = weights[2], weights[3]
    outs = []
    for depth in (1, 4):
        p = LLM(tl, cfg_t, params_t, device="cpu")
        p.compile(ServingConfig(cache_dtype=torch.float32, dispatch_ahead=depth,
                                max_tokens_per_step=3, **SERVE))
        outs.append([r.output_tokens for r in p.generate(PROMPTS, max_new_tokens=5)])
    assert outs[0] == outs[1]


def test_engine_reset_zeroes_the_cache_and_serving_repeats(weights):
    cfg_t, params_t = weights[2], weights[3]
    p = LLM(tl, cfg_t, params_t, device="cpu")
    p.compile(ServingConfig(cache_dtype=torch.float32, **SERVE))
    first = [r.output_tokens for r in p.generate(PROMPTS, max_new_tokens=4)]
    cache = p.engine.cache
    assert any(bool(t.any()) for t in cache.values())
    p.engine.reset()
    assert p.engine.cache is cache  # zeroed in place, not reallocated
    assert not any(bool(t.any()) for t in cache.values())
    assert [r.output_tokens for r in p.generate(PROMPTS, max_new_tokens=4)] == first


def test_sampled_generation_is_seeded(weights):
    from flexflow_tpu_torch.serve import GenerationConfig

    cfg_t, params_t = weights[2], weights[3]
    gen = GenerationConfig(do_sample=True, temperature=1.0, topp=0.9, topk=20,
                           max_new_tokens=5)
    outs = []
    for _ in range(2):
        p = LLM(tl, cfg_t, params_t, device="cpu")
        p.compile(ServingConfig(cache_dtype=torch.float32, **SERVE), seed=7)
        outs.append([r.output_tokens for r in p.generate(PROMPTS, gen)])
    assert outs[0] == outs[1]
    assert all(0 <= t < cfg_t.vocab_size for o in outs[0] for t in o)


def test_entry_points_default_to_cuda_and_raise_without_it(weights, monkeypatch):
    cfg_t, params_t = weights[2], weights[3]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        LLM(tl, cfg_t, params_t)
    with pytest.raises(RuntimeError, match="CUDA"):
        LLM(tl, cfg_t)
    with pytest.raises(RuntimeError, match="CUDA"):
        InferenceEngine(tl, cfg_t, params_t, ServingConfig(**SERVE))


@pytest.mark.parametrize("field,value,exc", [
    pytest.param("kv_shard", "context", NotImplementedError, id="kv_shard-context"),
    # fused_decode "sampling" and "whole_step" are ported; an unknown entry
    # raises, and "whole_step" needs the paged layout
    pytest.param("fused_decode", ("sampling", "bogus"), ValueError, id="fused_decode-value1"),
    pytest.param("fused_decode", ("whole_step",), ValueError, id="fused_decode-value2"),
    pytest.param("prefix_caching", True, NotImplementedError, id="prefix_caching-True"),
    pytest.param("replicas", 2, NotImplementedError, id="replicas-2"),
    pytest.param("inference_debugging", "/nonexistent", NotImplementedError,
                 id="inference_debugging-/nonexistent"),
])
def test_unported_serving_fields_raise(weights, field, value, exc):
    """A field of a later slice raises NotImplementedError naming it; a
    ported one raises the JAX engine's ValueError on a bad layout."""
    cfg_t, params_t = weights[2], weights[3]
    sc = ServingConfig(**{field: value}, **SERVE)
    with pytest.raises(exc, match="slice" if exc is NotImplementedError else "paged"):
        InferenceEngine(tl, cfg_t, params_t, sc, device="cpu")


def test_unknown_kernels_value_raises():
    with pytest.raises(ValueError, match="kernels"):
        ServingConfig(kernels="pallas").validate()


def test_long_prompt_truncates_and_stops_like_jax(weights):
    """A prompt past max_sequence_length is cut to max_len - 1 tokens and
    its generation stops at max_sequence_length, as in the JAX package."""
    cfg_j, params_j, cfg_t, params_t = weights
    prompt = [int(t) for t in np.arange(70) % 200 + 1]
    m = JaxLLM(jl, cfg_j, params_j)
    m.compile(JaxServingConfig(cache_dtype=jnp.float32, kernels="xla", **SERVE))
    want, = m.generate([prompt], max_new_tokens=6)
    p = LLM(tl, cfg_t, params_t, device="cpu")
    p.compile(ServingConfig(cache_dtype=torch.float32, **SERVE))
    got, = p.generate([prompt], max_new_tokens=6)
    assert got.input_tokens == want.input_tokens == prompt[:63]
    assert got.output_tokens == want.output_tokens
    assert len(got.output_tokens) == 1 and got.error is None
