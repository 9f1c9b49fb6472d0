"""Serving triage on the port (``ServingConfig.inference_debugging`` /
``FF_INFERENCE_DEBUGGING``; the models' ``serve_debug_activations``):
the per-layer dumps of a run equal the JAX package's for the same run —
same files, same shapes, same values within f32 summation order — for
LLaMA on both layouts (f32 and int8 pages) and one generic family per
body feature; a capture leaves the engine's cache bitwise as it was and
its last layer gives the step's token; the switch changes no token; one
dump a step on every path; the environment variable; a model without the
hook."""
import glob
import logging
import os
import re
import types

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import flexflow_tpu.models as jzoo
import flexflow_tpu_torch.models as tzoo
from flexflow_tpu.serve import InferenceEngine as JaxEngine
from flexflow_tpu.serve import RequestManager as JaxRM
from flexflow_tpu.serve import ServingConfig as JaxServingConfig
from flexflow_tpu_torch import obs as tobs
from flexflow_tpu_torch.models import hf_utils
from flexflow_tpu_torch.models import llama as tl
from flexflow_tpu_torch.models import transformer as tt
from flexflow_tpu_torch.serve import InferenceEngine, RequestManager, ServingConfig
from flexflow_tpu_torch.serve.specinfer import SpecConfig, SpecInferManager

torch.set_num_threads(1)

PROMPTS = [[3, 17, 91, 42, 7], [9, 8, 7, 6, 5, 4, 3, 2, 1, 11, 12]]
NEW = 4
SERVE = dict(max_requests_per_batch=2, max_sequence_length=48, prefill_chunk=4,
             max_spec_tree_tokens=8, page_size=8)
# f32 on the CPU: the two packages' blocks differ in summation order only
ATOL = RTOL = 1e-5


def _weights(name, dtype="f32", seed=0):
    jm, tm = getattr(jzoo, name), getattr(tzoo, name)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "f32" else (jnp.bfloat16,
                                                                    torch.bfloat16)
    cfg_j = (jm.LLaMAConfig.tiny if name == "llama" else jm.tiny)(dtype=jdt)
    cfg_t = (tm.LLaMAConfig.tiny if name == "llama" else tm.tiny)(dtype=tdt)
    params_j = jm.init_params(jax.random.PRNGKey(seed), cfg_j)
    params_t = hf_utils.params_from_numpy(jax.tree.map(np.asarray, params_j), device="cpu")
    return jm, tm, cfg_j, cfg_t, params_j, params_t


def _dumps(root):
    """{(engine dir without its id, file name): array}; JAX's bf16 files
    read through ml_dtypes."""
    out = {}
    for f in sorted(glob.glob(os.path.join(root, "*", "*.npy"))):
        sub = re.sub(r"-[0-9a-f]{4}$", "", os.path.basename(os.path.dirname(f)))
        a = np.load(f)
        if a.dtype.kind == "V" and a.dtype.itemsize == 2:
            a = a.view(ml_dtypes.bfloat16)
        out[(sub, os.path.basename(f))] = a
    return out


def _port_rm(tm, cfg, params, tmp, **serve):
    eng = InferenceEngine(tm, cfg, params, ServingConfig(
        cache_dtype=cfg.dtype, inference_debugging=tmp, **serve), device="cpu")
    return RequestManager(eng)


def _both(tmp_path, name, jax_kernels="xla", port_kernels="torch", dtype="f32", **serve):
    jm, tm, cfg_j, cfg_t, params_j, params_t = _weights(name, dtype)
    dj, dt = str(tmp_path / "jax"), str(tmp_path / "port")
    jrm = JaxRM(JaxEngine(jm, cfg_j, params_j, JaxServingConfig(
        cache_dtype=cfg_j.dtype, kernels=jax_kernels, inference_debugging=dj, **SERVE,
        **serve)))
    want = [o.output_tokens for o in jrm.generate(PROMPTS, max_new_tokens=NEW)]
    trm = _port_rm(tm, cfg_t, params_t, dt, kernels=port_kernels, **SERVE, **serve)
    got = [o.output_tokens for o in trm.generate(PROMPTS, max_new_tokens=NEW)]
    return got, want, _dumps(dt), _dumps(dj), trm, cfg_t


def _hold(got_files, want_files, trm, cfg, atol=ATOL, rtol=RTOL):
    assert sorted(got_files) == sorted(want_files)
    steps = [k for k in got_files if k[1].endswith("_tokens.npy")]
    assert len(steps) == trm.stats.sync_steps == trm.engine._debug_step > 0
    layers = [k for k in got_files if "_layer" in k[1]]
    assert len(layers) == len(steps) * cfg.num_hidden_layers
    scratch = trm.engine.scratch_pos
    for k, want in want_files.items():
        got = got_files[k]
        assert got.shape == want.shape, k
        if "_layer" in k[1]:
            assert got.dtype == np.float32, k  # bf16 dumps are written as f32
            # live entries only: a padding row's output is never read, and
            # the dense decode kernel gives it an empty walk (zeros)
            live = want_files[(k[0], k[1].split("_")[0] + "_positions.npy")] != scratch
            np.testing.assert_allclose(got[live], want[live].astype(np.float32), atol=atol,
                                       rtol=rtol, err_msg=str(k))
        else:
            np.testing.assert_array_equal(got, want, err_msg=str(k))


@pytest.mark.parametrize("serve", [
    dict(kv_layout="dense"), dict(kv_layout="paged"),
    dict(kv_layout="paged", kv_quant="int8"),
], ids=["dense", "paged-f32", "paged-int8"])
def test_llama_capture_matches_jax_layer_by_layer(tmp_path, serve):
    """LLaMA served with the switch on by both packages (the port with
    ``kernels="cuda"``: on the CPU its wrappers' plain versions; JAX's
    XLA path): the same tokens and the same dump files, values within
    ATOL/RTOL."""
    got, want, fg, fw, trm, cfg = _both(tmp_path, "llama", port_kernels="cuda", **serve)
    assert got == want
    _hold(fg, fw, trm, cfg)


@pytest.mark.parametrize("name,layout", [
    ("falcon", "paged"),                                       # parallel block, MQA
    pytest.param("phi", "paged", marks=pytest.mark.slow),      # partial rotary, biases
    ("mpt", "paged"),                                          # ALiBi, the position pool
    pytest.param("mpt", "dense", marks=pytest.mark.slow),      # the dense position buffer
    pytest.param("mistral", "paged", marks=pytest.mark.slow),  # sliding window
    pytest.param("gpt2", "paged", marks=pytest.mark.slow),     # learned positions
    pytest.param("mixtral", "dense", marks=pytest.mark.slow),  # mixture of experts
])
def test_generic_capture_matches_jax_layer_by_layer(tmp_path, name, layout):
    """One generic family per body feature: the same tokens and dump files
    as JAX's (both capture on their plain blocks)."""
    got, want, fg, fw, trm, cfg = _both(tmp_path, name, kv_layout=layout)
    assert got == want
    _hold(fg, fw, trm, cfg)


def test_bf16_dumps_are_f32_and_match_jax(tmp_path):
    """bf16 activations are written as f32 (numpy has no bf16); JAX's
    ml_dtypes files hold the same values within bf16's rounding of two
    different summation orders (a few bf16 ulps of the largest value)."""
    got, want, fg, fw, trm, cfg = _both(tmp_path, "llama", dtype="bf16", kv_layout="dense")
    assert sorted(fg) == sorted(fw)
    for k, a in fw.items():
        if "_layer" in k[1]:
            assert a.dtype == ml_dtypes.bfloat16 and fg[k].dtype == np.float32
            live = fw[(k[0], k[1].split("_")[0] + "_positions.npy")] != trm.engine.scratch_pos
            a = a.astype(np.float32)[live]
            scale = float(np.abs(a).max())
            np.testing.assert_allclose(fg[k][live], a, atol=4 * 2 ** -8 * scale, rtol=0,
                                       err_msg=str(k))


# the engine configurations of the cache and token checks: (family, serving)
ARMS = {
    "llama-dense-cuda": ("llama", dict(kv_layout="dense", kernels="cuda")),
    "llama-paged-cuda": ("llama", dict(kv_layout="paged", kernels="cuda")),
    "llama-paged-int8": ("llama", dict(kv_layout="paged", kernels="cuda", kv_quant="int8")),
    "llama-whole-step": ("llama", dict(kv_layout="paged", kernels="cuda",
                                       fused_decode=("whole_step",))),
    "mpt-dense": ("mpt", dict(kv_layout="dense", kernels="torch")),
    "mpt-paged": ("mpt", dict(kv_layout="paged", kernels="torch")),
}


def _head(name, params, cfg, x, logits_idx):
    mod = tl if name == "llama" else tt
    return mod._head(cfg, params, x, logits_idx, False)


@pytest.mark.parametrize("arm", list(ARMS))
def test_capture_leaves_the_cache_bitwise_and_gives_the_steps_token(tmp_path, arm):
    """Mid-run (prefill done, decode under way), one capture leaves every
    cache tensor — K/V, page scales, the position buffer — bitwise as it
    was, and its last layer through the final norm and the LM head at
    ``logits_idx`` gives the tokens the step then serves."""
    name, serve = ARMS[arm]
    _, tm, _, cfg, _, params = _weights(name)
    rm = _port_rm(tm, cfg, params, str(tmp_path), **SERVE, **serve)
    eng = rm.engine
    for p in PROMPTS:
        rm.register_request(p)
    for _ in range(5):
        rm.step()
    bc = rm._prepare_batch()
    assert bc is not None and bc.chunk == 1  # a decode step
    before = {k: v.clone() for k, v in eng.cache.items()}
    eng._dump_debug(bc)
    assert set(eng.cache) == set(before)
    for k, v in before.items():
        assert torch.equal(eng.cache[k], v), k
    extra = {"k_scale", "v_scale"} if "kv_quant" in serve else {"pos"} if name == "mpt" else set()
    assert set(before) == {"k", "v"} | extra
    step = eng._debug_step - 1
    last = np.load(glob.glob(os.path.join(
        str(tmp_path), "*", f"step{step:05d}_layer{cfg.num_hidden_layers - 1:03d}.npy"))[0])
    logits_idx = torch.from_numpy(bc.logits_idx).long()
    want = _head(name, params, cfg, torch.from_numpy(last), logits_idx).argmax(-1)
    greedy = np.ones(2, bool), np.ones(2, np.float32), np.full(2, 2.0, np.float32), \
        np.zeros(2, np.int32)
    served = eng.run_sampled(bc, rm._generator, *greedy) if "fused_decode" in serve else \
        eng.run(bc).argmax(-1)
    live = bc.active
    assert torch.equal(want[live], served[live])


@pytest.mark.parametrize("arm", ["llama-dense-cuda", "llama-paged-int8", "llama-whole-step",
                                 "mpt-paged"])
def test_tokens_are_the_same_with_the_switch_on_and_off(tmp_path, arm):
    name, serve = ARMS[arm]
    _, tm, _, cfg, _, params = _weights(name)
    on = _port_rm(tm, cfg, params, str(tmp_path), **SERVE, **serve)
    off = RequestManager(InferenceEngine(tm, cfg, params, ServingConfig(
        cache_dtype=cfg.dtype, **SERVE, **serve), device="cpu"))
    got = [o.output_tokens for o in on.generate(PROMPTS, max_new_tokens=NEW)]
    assert got == [o.output_tokens for o in off.generate(PROMPTS, max_new_tokens=NEW)]
    assert not on.supports_fast_decode and off.supports_fast_decode
    assert on.stats.sync_steps > 0 and on.stats.decode_steps == on.stats.mixed_steps == 0


@pytest.mark.parametrize("fused", [(), ("sampling",), ("whole_step",)],
                         ids=["per-layer", "sampling", "whole-step"])
def test_one_dump_per_step_on_every_path(tmp_path, fused):
    """The per-layer step (engine.run), the fused sampling head
    (run_sampled's per-layer branch) and the whole step (run_sampled
    through run_mixed) each dump once a step: the step files count the
    sync steps, and the dispatches name the path taken."""
    _, tm, _, cfg, _, params = _weights("llama")
    rm = _port_rm(tm, cfg, params, str(tmp_path), kv_layout="paged", kernels="cuda",
                  fused_decode=fused, **SERVE)
    buf = tobs.attach_observability(rm)
    rm.generate(PROMPTS, max_new_tokens=NEW)
    steps = glob.glob(os.path.join(str(tmp_path), "llama-L2-*", "step*_tokens.npy"))
    assert len(steps) == rm.stats.sync_steps == rm.engine._debug_step > 0
    kinds = {e["attrs"]["kind"] for e in buf.events if e["name"] == "dispatch"}
    assert kinds == {(): {"step", "host_sample"}, ("sampling",): {"step_sampled"},
                     ("whole_step",): {"whole_step", "whole_step_mixed"}}[fused]


def test_the_environment_variable_turns_it_on(tmp_path, monkeypatch):
    _, tm, _, cfg, _, params = _weights("llama")
    monkeypatch.setenv("FF_INFERENCE_DEBUGGING", str(tmp_path))
    eng = InferenceEngine(tm, cfg, params, ServingConfig(cache_dtype=cfg.dtype, **SERVE),
                          device="cpu")
    assert eng.serving.inference_debugging == str(tmp_path)
    rm = RequestManager(eng)
    assert not rm.supports_fast_decode
    rm.generate(PROMPTS, max_new_tokens=2)
    assert glob.glob(os.path.join(str(tmp_path), "llama-L2-*", "step00000_layer001.npy"))
    monkeypatch.setenv("FF_INFERENCE_DEBUGGING", "")
    eng = InferenceEngine(tm, cfg, params, ServingConfig(cache_dtype=cfg.dtype, **SERVE),
                          device="cpu")
    assert eng.serving.inference_debugging is None


def test_a_model_without_the_hook_warns_once_and_keeps_fast_decode(tmp_path, caplog):
    _, tm, _, cfg, _, params = _weights("llama")
    nohook = types.ModuleType("nohook")
    for k in dir(tl):
        if not k.startswith("__") and k != "serve_debug_activations":
            setattr(nohook, k, getattr(tl, k))
    rm = _port_rm(nohook, cfg, params, str(tmp_path), kv_layout="dense",
                  continuous_batching=False, **SERVE)
    assert rm.supports_fast_decode
    with caplog.at_level(logging.WARNING):
        outs = rm.generate(PROMPTS, max_new_tokens=NEW)
    assert all(len(o.output_tokens) == NEW for o in outs)
    warned = [r for r in caplog.records if "serve_debug_activations" in r.getMessage()]
    assert len(warned) == 1 and rm.stats.sync_steps > 1
    assert not os.listdir(str(tmp_path))


def test_specinfer_engines_dump_into_their_own_directories(tmp_path):
    """A SpecInfer pair shares the directory: each engine dumps into its
    own subdirectory; the prefill phase takes the sync batch (every engine
    dumps each step) and the tokens are those with the switch off."""
    _, tm, _, cfg, _, params = _weights("llama")
    dcfg = tm.LLaMAConfig.tiny(dtype=torch.float32, num_hidden_layers=1)
    dparams = dict(params, layers={k: v[:1] for k, v in params["layers"].items()})

    def mgr(debug):
        sc = ServingConfig(cache_dtype=cfg.dtype, inference_debugging=debug, **SERVE)
        return SpecInferManager(InferenceEngine(tm, cfg, params, sc, device="cpu"),
                                [InferenceEngine(tm, dcfg, dparams, sc, device="cpu")],
                                SpecConfig(beam_width=2, beam_depth=2))

    on = mgr(str(tmp_path))
    got = [o.output_tokens for o in on.generate(PROMPTS, max_new_tokens=NEW)]
    assert got == [o.output_tokens for o in mgr(None).generate(PROMPTS, max_new_tokens=NEW)]
    subs = sorted(re.sub(r"-[0-9a-f]{4}$", "", d) for d in os.listdir(str(tmp_path)))
    assert subs == ["llama-L1", "llama-L2"]
    assert on.stats.mixed_steps == 0 and on.stats.spec_rounds > 0
    assert on.engine._debug_step > 0 and on.ssms[0]._debug_step > 0
