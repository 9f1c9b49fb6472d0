"""Beam search on the port (flexflow_tpu_torch/serve/beam.py) against the
JAX package's ``beam_generate`` on the same weights, f32 on the CPU, on
the dense and the paged KV cache."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flexflow_tpu.models import llama as jl
from flexflow_tpu.serve import InferenceEngine as JaxInferenceEngine
from flexflow_tpu.serve import ServingConfig as JaxServingConfig
from flexflow_tpu.serve.batch_config import GenerationConfig as JaxGenerationConfig
from flexflow_tpu.serve.beam import beam_generate as jax_beam_generate
from flexflow_tpu_torch.models import llama as tl
from flexflow_tpu_torch.serve import LLM, GenerationConfig, InferenceEngine, ServingConfig
from flexflow_tpu_torch.serve.beam import beam_generate

torch.set_num_threads(1)

SERVE = dict(max_requests_per_batch=4, max_sequence_length=64, prefill_chunk=8,
             max_spec_tree_tokens=8)
PROMPTS = [[3, 17, 91, 42], list(range(40, 53))]


@pytest.fixture(scope="module")
def weights():
    cfg_j = jl.LLaMAConfig.tiny(dtype=jnp.float32)
    params_j = jl.init_params(jax.random.PRNGKey(2), cfg_j)
    cfg_t = tl.LLaMAConfig.tiny(dtype=torch.float32)
    params_t = tl.params_from_numpy(jax.tree.map(np.asarray, params_j), device="cpu")
    return cfg_j, params_j, cfg_t, params_t


LAYOUTS = {"dense": {}, "paged": dict(kv_layout="paged", page_size=16),
           "int8": dict(kv_layout="paged", page_size=16, kv_quant="int8")}


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("num_beams,eos", [(3, None), (2, 40), (4, None)])
def test_beam_generate_matches_jax(weights, layout, num_beams, eos):
    cfg_j, params_j, cfg_t, params_t = weights
    kw = LAYOUTS[layout]
    jeng = JaxInferenceEngine(jl, cfg_j, params_j,
                              JaxServingConfig(cache_dtype=jnp.float32, **SERVE, **kw))
    peng = InferenceEngine(tl, cfg_t, params_t,
                           ServingConfig(cache_dtype=torch.float32, **SERVE, **kw), device="cpu")
    for prompt in PROMPTS:
        want = jax_beam_generate(jeng, prompt, JaxGenerationConfig(num_beams=num_beams,
                                                                   max_new_tokens=10), eos)
        got = beam_generate(peng, prompt, GenerationConfig(num_beams=num_beams,
                                                           max_new_tokens=10), eos)
        assert got == want
        assert 1 <= len(got) <= 10
    if peng.paged:  # every beam slot's pages went back to the pool
        assert peng.pager.free_pages == peng.pager.num_pages


def test_llm_generate_with_beams(weights):
    """``num_beams > 1`` goes through beam search; one beam is greedy
    decoding; sampling knobs are refused."""
    cfg_t, params_t = weights[2], weights[3]
    m = LLM(tl, cfg_t, params_t, device="cpu")
    m.compile(ServingConfig(cache_dtype=torch.float32, **SERVE))
    greedy = [r.output_tokens for r in m.generate(PROMPTS, max_new_tokens=8)]
    one = beam_generate(m.engine, PROMPTS[0], GenerationConfig(num_beams=1, max_new_tokens=8))
    assert one == greedy[0]
    res = m.generate(PROMPTS, GenerationConfig(num_beams=3), max_new_tokens=8)
    assert [r.request_id for r in res] == [0, 1]
    assert [r.output_tokens for r in res] == [
        beam_generate(m.engine, p, GenerationConfig(num_beams=3, max_new_tokens=8))
        for p in PROMPTS]
    assert all(r.input_tokens == p for r, p in zip(res, PROMPTS))
    with pytest.raises(ValueError, match="greedy-scored"):
        m.generate(PROMPTS, GenerationConfig(num_beams=2, do_sample=True))


def test_reorder_moves_only_the_hypotheses(weights):
    """``engine.reorder`` on the dense cache: slot r takes slot src[r]'s
    lines; slots that keep their own are untouched."""
    cfg_t, params_t = weights[2], weights[3]
    eng = InferenceEngine(tl, cfg_t, params_t,
                          ServingConfig(cache_dtype=torch.float32, **SERVE), device="cpu")
    g = torch.Generator().manual_seed(0)
    for t in eng.cache.values():
        t.copy_(torch.randn(t.shape, generator=g))
    before = {k: v.clone() for k, v in eng.cache.items()}
    eng.reorder(np.array([2, 2, 0, 3], np.int32))
    for k, v in eng.cache.items():
        for r, s in enumerate((2, 2, 0, 3)):
            assert torch.equal(v[:, r], before[k][:, s])
