"""Two serving repairs of the port, on the CPU: shapes the CUDA kernels do
not take are refused when the engine is built, and steps wider than the
fused kernels' commit run the unfused step (``fused_decode`` with
``prefill_chunk > 256``); ``fused_decode=("sampling",)`` picks the
sampling head per batch as the JAX engine does, with the JAX engine's
greedy tokens on the same weights."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flexflow_tpu.models import llama as jl
from flexflow_tpu.serve import LLM as JaxLLM
from flexflow_tpu.serve import ServingConfig as JaxServingConfig
from flexflow_tpu.serve import sampling as js
from flexflow_tpu_torch.models import llama as tl
from flexflow_tpu_torch.serve import LLM, InferenceEngine, ServingConfig
from flexflow_tpu_torch.serve import engine as te
from flexflow_tpu_torch.serve import kernels as tk
from flexflow_tpu_torch.serve import sampling as ts
from flexflow_tpu_torch.serve.batch_config import GenerationConfig

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def weights():
    cfg_j = jl.LLaMAConfig.tiny(dtype=jnp.float32, max_position_embeddings=512)
    params_j = jl.init_params(jax.random.PRNGKey(11), cfg_j)
    cfg_t = tl.LLaMAConfig.tiny(dtype=torch.float32, max_position_embeddings=512)
    params_t = tl.params_from_numpy(jax.tree.map(np.asarray, params_j), device="cpu")
    return cfg_j, params_j, cfg_t, params_t


def _port(weights, **serve):
    p = LLM(tl, weights[2], weights[3], device="cpu")
    p.compile(ServingConfig(cache_dtype=torch.float32, **serve))
    return p


# ---------------------------------------------------------------------------
# chunks wider than the fused kernels' commit

WIDE = dict(max_requests_per_batch=3, max_sequence_length=448, prefill_chunk=384,
            max_spec_tree_tokens=8, page_size=16, kv_layout="paged")
# one prompt longer than the chunk (two mixed steps), two shorter ones
WIDE_PROMPTS = [[int(t) for t in np.arange(400) % 250 + 1], list(range(3, 40)),
                [7, 8, 9, 10]]


@pytest.mark.parametrize("fused", ["rope_kv_write", "whole_step"])
def test_wide_chunk_fusions_serve_the_unfused_tokens(weights, fused):
    """prefill_chunk=384 > the 256-line commit: the fused engine serves
    the unfused engine's greedy tokens; rope_kv_write counts its rerouted
    steps, whole_step counts one gate fallback and keeps mixed steps on the
    per-layer path."""
    assert WIDE["prefill_chunk"] > tk._FUSED_MAX_CHUNK
    want = [r.output_tokens for r in _port(weights, kernels="cuda", **WIDE).generate(
        WIDE_PROMPTS, max_new_tokens=4)]
    p = _port(weights, kernels="cuda", fused_decode=(fused,), **WIDE)
    got = [r.output_tokens for r in p.generate(WIDE_PROMPTS, max_new_tokens=4)]
    assert got == want
    eng = p.engine
    if fused == "rope_kv_write":
        assert eng.fused_reroutes >= 2  # the long prompt's two chunks at least
    else:
        assert eng.fused_reroutes == 0
        assert eng.whole_step_on and not eng.whole_step_mixed_on
        assert eng.whole_step_fallbacks == 1 == p.rm.stats.whole_step_fallbacks


def test_narrow_chunk_fusion_is_not_rerouted(weights):
    p = _port(weights, kernels="cuda", fused_decode=("rope_kv_write",),
              **dict(WIDE, prefill_chunk=32))
    p.generate(WIDE_PROMPTS[1:], max_new_tokens=3)
    assert p.engine.fused_reroutes == 0


@pytest.mark.parametrize("serve,what", [
    (dict(kv_layout="paged", page_size=256), "page size 256"),
    (dict(kv_layout="paged", page_size=8), "page size 8"),
    (dict(kv_layout="paged", page_size=64, head_dim=16), "head dim 16"),
    (dict(head_dim=32), "head dim 32"),
])
def test_cuda_engine_refuses_shapes_without_kernels(monkeypatch, serve, what):
    """kernels="cuda" on a GPU raises at construction, naming the limit,
    for a page size or head dim the CUDA kernels are not built for — before
    any cache is allocated (a CPU-only torch could not allocate one on
    "cuda"). On the CPU the plain versions take them."""
    serve = dict(serve)
    dk = serve.pop("head_dim", 64)
    cfg = tl.LLaMAConfig.tiny(dtype=torch.float32, hidden_size=4 * dk)
    sc = dict(max_requests_per_batch=2, max_sequence_length=64, prefill_chunk=4, **serve)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(ValueError, match=what):
        InferenceEngine(tl, cfg, {}, ServingConfig(kernels="cuda", **sc), device="cuda")
    eng = InferenceEngine(tl, cfg, {}, ServingConfig(kernels="cuda", **sc), device="cpu")
    assert eng.device.type == "cpu"


# ---------------------------------------------------------------------------
# fused_decode=("sampling",)

SAMPLE = dict(max_requests_per_batch=3, max_sequence_length=64, prefill_chunk=4)
PROMPTS = [[7, 8, 9], [20, 21, 22, 23], list(range(30, 41)), [5, 6]]


@pytest.mark.parametrize("kv_layout", ["dense", "paged"])
@pytest.mark.parametrize("continuous_batching", [True, False])
def test_sampling_fusion_greedy_tokens_match_jax(weights, continuous_batching, kv_layout):
    """Greedy tokens are the same with and without the flag and equal the
    JAX engine's with the flag, on the same weights."""
    cfg_j, params_j = weights[:2]
    serve = dict(SAMPLE, continuous_batching=continuous_batching, kv_layout=kv_layout,
                 page_size=8)
    m = JaxLLM(jl, cfg_j, params_j)
    m.compile(JaxServingConfig(cache_dtype=jnp.float32, kernels="xla",
                               fused_decode=("sampling",), **serve))
    want = [r.output_tokens for r in m.generate(PROMPTS, max_new_tokens=6)]
    for fused in ((), ("sampling",)):
        p = _port(weights, kernels="torch", fused_decode=fused, **serve)
        assert [r.output_tokens for r in p.generate(PROMPTS, max_new_tokens=6)] == want


HEADS = {  # per-slot (greedy, topp, topk): a greedy slot beside sampling ones
    "greedy": ([True, True, True], [2.0] * 3, [0] * 3),
    "sample": ([True, False, False], [2.0] * 3, [0] * 3),
    "topk": ([True, False, False], [2.0] * 3, [0, 5, 3]),
    "full": ([True, False, False], [2.0, 0.9, 0.5], [0, 4, 0]),
}


@pytest.mark.parametrize("head", sorted(HEADS))
def test_sampling_fusion_picks_the_batch_mode(weights, monkeypatch, head):
    """On a mixed step the engine samples in the mode choose_sample_mode
    picks for the batch with the flag (equal to the JAX package's choice),
    in the full-sort mode without it; the filtered logits of the chosen
    mode equal the full-sort head's on the sampling rows, and the JAX
    package's filter in the same mode."""
    greedy, topp, topk = (np.asarray(a) for a in HEADS[head])
    R, V = 3, weights[2].vocab_size
    temp = np.full((R,), 0.7, np.float32)
    want = ts.choose_sample_mode(greedy, topp, topk, V)
    assert want == js.choose_sample_mode(greedy, topp, topk, V)
    assert want[0] == head
    seen = []
    real = te.sample_tokens

    def spy(logits, generator, **kw):
        seen.append((logits, kw["mode"], kw["topk_cap"]))
        return real(logits, generator, **kw)

    monkeypatch.setattr(te, "sample_tokens", spy)
    for fused, mode in (((), ("full", 0)), (("sampling",), want)):
        eng = InferenceEngine(tl, weights[2], weights[3],
                              ServingConfig(cache_dtype=torch.float32, kernels="torch",
                                            fused_decode=fused, **SAMPLE), device="cpu")
        toks = np.array([[5, 6, 7, 8], [9, 10, 0, 0], [11, 0, 0, 0]])
        pos = np.array([[0, 1, 2, 3], [0, 1, eng.scratch_pos, eng.scratch_pos],
                        [0] + [eng.scratch_pos] * 3])
        eng.run_mixed(torch.zeros(R, dtype=torch.long), toks, np.zeros(R, bool), pos,
                      np.array([3, 1, 0]), torch.Generator().manual_seed(0), greedy, temp,
                      topp, topk)
        logits, m_, cap = seen[-1]
        assert (m_, cap) == mode
    if head == "greedy":
        return
    rows = ~greedy
    args = dict(temperature=torch.from_numpy(temp), topp=torch.from_numpy(topp.astype(np.float32)),
                topk_arr=torch.from_numpy(topk.astype(np.int64)))
    chosen = ts.filter_logits(logits, mode=want[0], topk_cap=want[1], **args)
    full = ts.filter_logits(logits, mode="full", **args)
    assert torch.equal(chosen[rows], full[rows])
    jl_ = jnp.asarray(logits.numpy())
    jt = jnp.asarray(temp)
    scaled = jl_ / jnp.maximum(jt, 1e-6)[:, None]
    if want[0] == "sample":
        jf = scaled
    elif want[0] == "topk":
        jf = js._topk_filter(scaled, jnp.asarray(topk))[0]
    else:
        sd = js._sorted_desc(scaled)
        scaled, sd = js._topk_filter(scaled, jnp.asarray(topk), sd)
        jf = js._topp_filter(scaled, jnp.asarray(topp), sd)
    np.testing.assert_allclose(chosen.numpy()[rows], np.asarray(jf)[rows], rtol=1e-6)
