"""The port's serving stack on the generic decoder's families (tiny f32
models on the CPU): ``LLM.generate`` greedy tokens against the JAX
package's on both KV layouts (Falcon's MQA, Mistral's window across the
prompts, MPT's ALiBi, Qwen2-MoE's experts), SpecInfer with a draft of the
same family and prefix caching with copy-on-write over Mistral's
position buffer, the engine's refusals, and the family modules' serving
protocol (the port's twin of scripts/check_family_reexports.py)."""
import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flexflow_tpu.models as jzoo
import flexflow_tpu_torch.models as tzoo
from flexflow_tpu.serve import LLM as JaxLLM
from flexflow_tpu.serve import ServingConfig as JaxServingConfig
from flexflow_tpu_torch.models import hf_utils
from flexflow_tpu_torch.serve import LLM, InferenceEngine, ServingConfig
from flexflow_tpu_torch.serve import specinfer as ts

torch.set_num_threads(1)

SERVE = dict(max_requests_per_batch=3, max_sequence_length=40, prefill_chunk=4,
             max_spec_tree_tokens=8, page_size=8)
# Mistral's tiny window is 8: every prompt here crosses it
PROMPTS = [list(range(3, 17)), [20, 21, 22, 23, 24, 25, 26, 27, 28, 29], list(range(40, 52)),
           [7, 8, 9, 10, 11, 12, 13, 14, 15]]
NEW = 8


def _weights(name, seed=11, **cfg_kw):
    jm, tm = getattr(jzoo, name), getattr(tzoo, name)
    cfg_j = jm.tiny(dtype=jnp.float32, **cfg_kw)
    params_j = jm.init_params(jax.random.PRNGKey(seed), cfg_j)
    params_t = hf_utils.params_from_numpy(jax.tree.map(np.asarray, params_j), device="cpu")
    return jm, tm, cfg_j, tm.tiny(dtype=torch.float32, **cfg_kw), params_j, params_t


def _port(tm, cfg, params, **serve):
    llm = LLM(tm, cfg, params, device="cpu")
    llm.compile(ServingConfig(cache_dtype=torch.float32, **serve))
    return llm


def _tokens(llm, prompts=PROMPTS, new=NEW):
    return [r.output_tokens for r in llm.generate(prompts, max_new_tokens=new)]


@pytest.mark.parametrize("name", [pytest.param("falcon", marks=pytest.mark.slow), "mistral",
                                  "mpt", pytest.param("qwen2_moe", marks=pytest.mark.slow)])
def test_generate_matches_jax_on_both_layouts(name):
    """Greedy tokens equal JAX's (its XLA path) on the dense layout
    (kernels="torch") and the paged one (kernels="torch", and "cuda": on
    the CPU the kernel wrappers' plain versions). MPT's ALiBi batches
    attend on the plain path under "cuda", each step counted."""
    jm, tm, cfg_j, cfg_t, params_j, params_t = _weights(name)
    for layout in ("dense", "paged"):
        m = JaxLLM(jm, cfg_j, params_j)
        m.compile(JaxServingConfig(cache_dtype=jnp.float32, kernels="xla", kv_layout=layout,
                                   **SERVE))
        want = _tokens(m)
        for kernels in (("torch",) if layout == "dense" else ("torch", "cuda")):
            p = _port(tm, cfg_t, params_t, kv_layout=layout, kernels=kernels, **SERVE)
            assert _tokens(p) == want, (layout, kernels)
            steps = p.engine.plain_attention_steps
            assert (steps > 0) == (name == "mpt" and kernels == "cuda"), steps


def test_spec_infer_and_prefix_caching_over_the_position_pool():
    """Mistral (window 8, the position pool): SpecInfer with a 1-layer
    Mistral draft serves the incremental tokens (the tree's lines and
    positions committed through commit_kv_paged), and prefix caching with a
    prompt that parts from a cached one mid-page (a copy-on-write of the
    tail page, its positions with it) serves the tokens caching off
    serves."""
    jm, tm, cfg_j, cfg_t, params_j, params_t = _weights("mistral")
    serve = dict(kv_layout="paged", kernels="torch", **SERVE)
    want = _tokens(_port(tm, cfg_t, params_t, **serve))
    ssm = _weights("mistral", seed=12, num_hidden_layers=1)
    target = InferenceEngine(tm, cfg_t, params_t, ServingConfig(cache_dtype=torch.float32,
                                                                **serve), device="cpu")
    draft = InferenceEngine(tm, ssm[3], ssm[5], ServingConfig(cache_dtype=torch.float32,
                                                              **serve), device="cpu")
    mgr = ts.SpecInferManager(target, [draft], ts.SpecConfig(beam_width=2, beam_depth=3))
    got = [r.output_tokens for r in mgr.generate(PROMPTS, max_new_tokens=NEW)]
    assert got == want
    assert mgr.stats.spec_rounds > 0

    shared = [(j * 7 + 3) % 256 for j in range(20)]  # 2.5 pages of 8
    a, b = shared + [9, 9, 9], shared + [5, 5, 5, 5]
    off = _port(tm, cfg_t, params_t, **serve)
    want = [_tokens(off, [p], 5) for p in (a, b, a)]
    on = _port(tm, cfg_t, params_t, prefix_caching=True, **serve)
    assert [_tokens(on, [p], 5) for p in (a, b, a)] == want
    assert on.rm.stats.prefix_cows >= 1 and on.rm.stats.prefix_hits >= 1


@pytest.mark.parametrize("name", ["falcon", "phi"])
def test_whole_step_and_dense_cuda_raise_at_construction(name):
    """fused_decode=("whole_step",) constructs for the generic decoder and
    serves the unfused engine's greedy tokens (the whole step's plain walk
    on the CPU, through the pipelined step), its decode and mixed steps
    both on the whole step; dense kernels="cuda" still names the paged
    layout and kernels="torch", raising before anything is allocated."""
    _, tm, _, cfg_t, _, params_t = _weights(name)
    serve = dict(kv_layout="paged", kernels="cuda", **SERVE)
    want = _tokens(_port(tm, cfg_t, params_t, **serve))
    whole = _port(tm, cfg_t, params_t, fused_decode=("whole_step",), **serve)
    assert whole.engine.whole_step_on and whole.engine.whole_step_mixed_on
    assert _tokens(whole) == want
    with pytest.raises(ValueError, match="kv_layout='paged'.*kernels='torch'"):
        InferenceEngine(tm, cfg_t, params_t, ServingConfig(kernels="cuda", **SERVE),
                        device="cpu")
    InferenceEngine(tm, cfg_t, params_t, ServingConfig(kernels="torch", **SERVE),
                    device="cpu")


@pytest.mark.parametrize("name", ["mixtral", "mpt", "mistral"])
def test_whole_step_refusals_at_construction(name):
    """MoE FFNs (Mixtral), ALiBi (MPT) and the sliding window (Mistral):
    fused_decode=("whole_step",) raises at construction with the JAX
    package's reason."""
    jm, tm, cfg_j, cfg_t, params_j, params_t = _weights(name)
    with pytest.raises(ValueError) as want:
        jm.whole_step_weight_layout(params_j, cfg_j)
    with pytest.raises(ValueError) as got:
        InferenceEngine(tm, cfg_t, params_t, ServingConfig(
            kv_layout="paged", fused_decode=("whole_step",), **SERVE), device="cpu")
    assert str(got.value) == str(want.value)


def _meta_params(cfg):
    """The family's parameter tree as "meta" tensors (shapes alone)."""
    from flexflow_tpu_torch.models import transformer as tt

    specs = tt._param_specs(cfg)
    return {k: ({n: torch.empty(s[0], dtype=cfg.dtype, device="meta") for n, s in v.items()}
                if k == "layers" else torch.empty(v[0], dtype=cfg.dtype, device="meta"))
            for k, v in specs.items()}


def test_head_dims_are_checked_per_kernel_family(monkeypatch):
    """On a GPU (faked: the check runs before any allocation) kernels="cuda"
    takes head dims 80 and 256 on the paged layout (Phi-2, Gemma), the
    whole step too (its own head dims, and its layout check on the
    published weights), and a head dim the paged kernels lack is refused
    there."""
    from flexflow_tpu_torch.serve import engine as eng_mod
    from flexflow_tpu_torch.serve import kernels as tk

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    seen = []
    monkeypatch.setattr(eng_mod.InferenceEngine, "_alloc_cache",
                        lambda self: seen.append(self.cfg.head_dim) or {})
    monkeypatch.setattr(eng_mod.InferenceEngine, "_whole_step_smem_gate", lambda self: None)
    for cfg in (tzoo.phi.phi_2(num_hidden_layers=1), tzoo.gemma.gemma_7b(num_hidden_layers=1)):
        InferenceEngine(tzoo.phi, cfg, {}, ServingConfig(kv_layout="paged"), device="cuda")
        eng = InferenceEngine(tzoo.phi, cfg, _meta_params(cfg), ServingConfig(
            kv_layout="paged", fused_decode=("whole_step",)), device="cuda")
        assert eng.whole_step_on
    assert seen == [80, 80, 256, 256]
    assert 80 in tk._WHOLE_HEAD_DIMS and 256 in tk._WHOLE_HEAD_DIMS
    assert tk._CUDA_HEAD_DIMS == (64, 128)  # the dense kernels keep theirs
    odd = tzoo.gemma.tiny(head_dim_override=96)
    with pytest.raises(ValueError, match="no head dim 96 in the paged kernels"):
        InferenceEngine(tzoo.gemma, odd, {}, ServingConfig(kv_layout="paged"), device="cuda")
    # a whole step whose layout the kernel does not compute raises at
    # construction on a GPU, never at a step (RMS norms with bias tensors,
    # which the kernel does not read)
    rms = tzoo.qwen2.tiny(hidden_size=256, num_attention_heads=4, norm_bias=True)
    with pytest.raises(ValueError, match="reads the layer tensors"):
        InferenceEngine(tzoo.qwen2, rms, _meta_params(rms), ServingConfig(
            kv_layout="paged", fused_decode=("whole_step",)), device="cuda")


def _engine_hooks():
    """Every attribute the port's serving package pulls off a model module
    (``self.model.X``, ``engine.model.X``, ...)."""
    serve = pathlib.Path(tzoo.__file__).resolve().parent.parent / "serve"
    hooks = set()
    for path in sorted(serve.glob("*.py")):
        hooks.update(re.findall(r"\bmodel\.(\w+)", path.read_text()))
    hooks.discard("__name__")
    return sorted(hooks)


#: the hooks the engine calls only when the family's FUSED_DECODE lists
#: "whole_step" (after it refused the fusion otherwise)
WHOLE_STEP_HOOKS = ("serve_step_whole", "whole_step_weight_layout", "whole_step_tile_roles")


@pytest.mark.parametrize("key", sorted(tzoo.FAMILIES))
def test_families_expose_the_engine_hooks(key):
    """Every family module exposes each hook the port's engine calls (the
    port's twin of scripts/check_family_reexports.py): a hook added to the
    engine and missed in a family fails here, not mid-serve."""
    hooks = _engine_hooks()
    assert {"serve_step_paged", "init_paged_kv_cache", "commit_kv_paged",
            "copy_page_kv", *WHOLE_STEP_HOOKS} <= set(hooks)
    mod = tzoo.FAMILIES[key]
    if "whole_step" not in mod.FUSED_DECODE:
        hooks = [h for h in hooks if h not in WHOLE_STEP_HOOKS]
    missing = [h for h in hooks if not hasattr(mod, h)]
    assert not missing, f"{mod.__name__} lacks {missing}"
    for fn in ("config" if key != "llama" else "LLaMAConfig", "from_hf",
               "convert_hf_state_dict", "init_params"):
        assert hasattr(mod, fn), (key, fn)
