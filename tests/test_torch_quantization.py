"""Weight-only int8/int4 quantization and offload in the port
(flexflow_tpu_torch/quantization.py, serve/kernels.wq_matmul's plain
version, LLM.compile(quantization=, offload=)) held against the JAX
package: codes and scales bitwise, the quantized leaves and footprint,
the plain product against JAX's ``_mm``, tiny quantized LLaMA and
Mixtral served by both packages (f32, the CPU), and the CUDA kernel's
launch plan (``kernels.wq_plan``) at the families' published shapes."""
import dataclasses
import warnings

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from flexflow_tpu import quantization as jq
from flexflow_tpu.core.mesh import MachineSpec
from flexflow_tpu.models import llama as jl
from flexflow_tpu.models import mixtral as jmix
from flexflow_tpu.models import transformer as jtr
from flexflow_tpu.serve import ServingConfig as JaxServingConfig
from flexflow_tpu.serve.llm import LLM as JaxLLM
from flexflow_tpu_torch import quantization as tq
from flexflow_tpu_torch.models import falcon as tfal
from flexflow_tpu_torch.models import gemma as tgem
from flexflow_tpu_torch.models import llama as tl
from flexflow_tpu_torch.models import mixtral as tmix
from flexflow_tpu_torch.models import phi as tphi
from flexflow_tpu_torch.models import transformer as ttr
from flexflow_tpu_torch.serve import InferenceEngine, ServingConfig
from flexflow_tpu_torch.serve import kernels as tk
from flexflow_tpu_torch.serve.llm import LLM

torch.set_num_threads(1)

# f32 logits of the same quantized 2-layer model in two frameworks: the
# dequantized weights are bitwise equal, so only GEMM summation order
# differs (~1e-6 relative on O(1) logits)
LOGIT_ATOL = 1e-4
# the plain product against JAX's _mm of the same quantized weight
MM_ATOL = 1e-5


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(a):
    a = np.asarray(a)
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.uint16).astype(np.int32)).to(torch.int16).view(
            torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(a))


def _bits(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy()
    return t.numpy()


@pytest.mark.parametrize("shape", [(2, 16, 24), (2, 3, 16, 24)], ids=["3d", "4d-experts"])
@pytest.mark.parametrize("bits", [8, 4])
def test_quantize_tensor_bitwise_jax(bits, shape):
    rng = np.random.default_rng(bits + len(shape))
    w = rng.normal(size=shape).astype(np.float32)
    w[..., 5] = 0.0  # an all-zero column: the scale clamps at 1e-12
    w[0, ..., 3, 7] = 2.5 * np.abs(w).max()  # a column dominated by one weight
    jw = jq.quantize_tensor(jnp.asarray(w), bits)
    tw = tq.quantize_tensor(torch.from_numpy(w), bits)
    assert tw["q"].dtype == (torch.int8 if bits == 8 else torch.uint8)
    np.testing.assert_array_equal(tw["q"].numpy(), np.asarray(jw["q"]))
    np.testing.assert_array_equal(tw["scale"].numpy(), np.asarray(jw["scale"]))
    for dt_t, dt_j in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        np.testing.assert_array_equal(
            _bits(tq.dequantize(tw, dt_t)),
            np.asarray(jq.dequantize(jw, dt_j)).view(
                np.int16 if dt_t == torch.bfloat16 else np.float32))


def test_quantize_tensor_int4_odd_input_dim_raises():
    w = np.ones((2, 15, 8), np.float32)
    with pytest.raises(AssertionError):
        jq.quantize_tensor(jnp.asarray(w), 4)
    with pytest.raises(ValueError, match="even input dim"):
        tq.quantize_tensor(torch.from_numpy(w), 4)
    assert tq.quantize_tensor(torch.from_numpy(w), 8)["q"].shape == (2, 15, 8)


def test_dequantize_bitwise_jax_from_bf16_weights():
    """Quantizing bf16 weights (the 7B path) goes through f32 in both."""
    rng = np.random.default_rng(3)
    w = rng.normal(size=(2, 32, 16)).astype(ml_dtypes.bfloat16)
    for bits in (8, 4):
        jw = jq.quantize_tensor(jnp.asarray(w), bits)
        tw = tq.quantize_tensor(_t(w), bits)
        np.testing.assert_array_equal(tw["q"].numpy(), np.asarray(jw["q"]))
        np.testing.assert_array_equal(tw["scale"].numpy(), np.asarray(jw["scale"]))
        np.testing.assert_array_equal(
            _bits(tq.dequantize(tw, torch.bfloat16)),
            np.asarray(jq.dequantize(jw, jnp.bfloat16)).view(np.int16))


@pytest.fixture(scope="module")
def llama_weights():
    cfg_j = jl.LLaMAConfig.tiny(dtype=jnp.float32)
    params_j = jl.init_params(jax.random.PRNGKey(0), cfg_j)
    cfg_t = tl.LLaMAConfig.tiny(dtype=torch.float32)
    params_t = tl.params_from_numpy(_np(params_j), device="cpu")
    return cfg_j, params_j, cfg_t, params_t


@pytest.fixture(scope="module")
def mixtral_weights():
    cfg_j = jmix.tiny(dtype=jnp.float32)
    params_j = jmix.init_params(jax.random.PRNGKey(1), cfg_j)
    cfg_t = tmix.tiny(dtype=torch.float32)
    params_t = tl.params_from_numpy(_np(params_j), device="cpu")
    return cfg_j, params_j, cfg_t, params_t


@pytest.mark.parametrize("family", ["llama", "mixtral"])
@pytest.mark.parametrize("bits", [8, 4])
def test_quantize_params_touches_jax_leaves_and_bytes(llama_weights, mixtral_weights,
                                                      family, bits):
    _, params_j, _, params_t = llama_weights if family == "llama" else mixtral_weights
    qj = jq.quantize_params(params_j, bits)
    qt = tq.quantize_params(params_t, bits)
    quant_j = sorted(k for k, v in qj["layers"].items() if jq.is_quantized(v))
    quant_t = sorted(k for k, v in qt["layers"].items() if tq.is_quantized(v))
    assert quant_t == quant_j and quant_t
    if family == "mixtral":
        assert not tq.is_quantized(qt["layers"]["w_router"])
        assert qt["layers"]["w_up"]["q"].dim() == 4
    for name in quant_t:
        np.testing.assert_array_equal(qt["layers"][name]["q"].numpy(),
                                      np.asarray(qj["layers"][name]["q"]))
        np.testing.assert_array_equal(qt["layers"][name]["scale"].numpy(),
                                      np.asarray(qj["layers"][name]["scale"]))
    assert tq.quantized_nbytes(qt) == jq.quantized_nbytes(qj)
    assert tq.quantized_nbytes(qt["layers"]) < tq.quantized_nbytes(params_t["layers"])


@pytest.mark.parametrize("bits", [8, 4])
def test_plain_wq_matmul_matches_jax_mm(bits):
    rng = np.random.default_rng(bits)
    w = rng.normal(size=(64, 48)).astype(np.float32)
    x = rng.normal(size=(2, 5, 64)).astype(np.float32)
    jw = jq.quantize_tensor(jnp.asarray(w), bits)
    tw = tq.quantize_tensor(torch.from_numpy(w), bits)
    want = np.asarray(jl._mm(jnp.asarray(x), jw))
    before = tk.PLAIN_CALLS["wq_matmul"]
    got = tk.quant_mm(torch.from_numpy(x), tw)
    assert tk.PLAIN_CALLS["wq_matmul"] == before + 1  # a CPU tensor: the plain version
    assert got.shape == (2, 5, 48)
    np.testing.assert_allclose(got.numpy(), want, atol=MM_ATOL)
    # the generic decoder's _mm resolves the same weight the same way
    np.testing.assert_allclose(ttr._mm(torch.from_numpy(x), tw).numpy(),
                               np.asarray(jtr._mm(jnp.asarray(x), jw)), atol=MM_ATOL)


@pytest.mark.parametrize("bits", [8, 4])
def test_plain_wq_matmul_expert_forms_match_dequantized_products(bits):
    """The expert stack's forms of the plain version: E weights against
    one x, and the down projection's grouped scales, against products of
    JAX's dequantized weights."""
    rng = np.random.default_rng(10 + bits)
    E, D, F, M = 3, 32, 16, 4
    up = rng.normal(size=(E, D, F)).astype(np.float32)
    down = rng.normal(size=(E, F, D)).astype(np.float32)
    x = rng.normal(size=(M, D)).astype(np.float32)
    h = rng.normal(size=(M, E * F)).astype(np.float32)
    jup, jdown = jq.quantize_tensor(jnp.asarray(up), bits), jq.quantize_tensor(
        jnp.asarray(down), bits)
    tup, tdown = (tq.quantize_tensor(torch.from_numpy(a), bits) for a in (up, down))
    want = np.einsum("md,edf->emf", x, np.asarray(jq.dequantize(jup, jnp.float32)))
    np.testing.assert_allclose(
        tk.wq_matmul(torch.from_numpy(x), tup["q"], tup["scale"]).numpy(), want, atol=1e-5)
    want = h @ np.asarray(jq.dequantize(jdown, jnp.float32)).reshape(E * F, D)
    got = tk.wq_matmul(torch.from_numpy(h), tdown["q"].reshape(-1, D),
                       tdown["scale"].reshape(E, D))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def _projection_shapes(cfg):
    """(K, N, B, G) of every layer projection of a family at its published
    widths: attention q, k, v and o, the FFN's up (and gate) and down, and
    an expert stack's up against E weights and its down as one K over E
    scale groups."""
    D, F = cfg.hidden_size, cfg.intermediate_size
    dk = cfg.head_dim
    Q, KVd = cfg.num_attention_heads * dk, cfg.num_key_value_heads * dk
    shapes = [(D, Q, 1, 1), (D, KVd, 1, 1), (Q, D, 1, 1)]
    E = getattr(cfg, "num_local_experts", 0)
    if E:
        shapes += [(D, F, E, 1), (E * F, D, 1, E)]
    else:
        shapes += [(D, F, 1, 1), (F, D, 1, 1)]
    return shapes


WQ_FAMILIES = {"llama_7b": tl.LLaMAConfig.llama_7b, "mixtral_8x7b": tmix.mixtral_8x7b,
               "falcon_7b": tfal.falcon_7b, "phi_2": tphi.phi_2, "gemma_7b": tgem.gemma_7b}


@pytest.mark.parametrize("family", sorted(WQ_FAMILIES))
def test_wq_plan_slices_cover_k_in_whole_steps(family):
    """Every launch plan of wq_matmul at a family's projection shapes, at
    decode (M 1-16) and a mixed step (M 2048), both code widths and x
    types, on an H100's 132 SMs: K slices multiples of 32 that cover K
    exactly, in order; a cluster of at most 8 blocks; no K step (rows
    dequantized against one scale row) crossing a scale group; the design
    the launcher takes for M and the dtype."""
    cfg = WQ_FAMILIES[family]()
    n_plans = 0
    for K, N, B, G in _projection_shapes(cfg):
        Kg = K // G
        assert K % tk.WQ_K_MULTIPLE == 0 and N % tk.WQ_N_MULTIPLE == 0 and Kg % 32 == 0
        for bits in (8, 4):
            for dtype in (torch.bfloat16, torch.float32):
                for M in (*range(1, 17), 2048):
                    plan = tk.wq_plan(M, K, N, B, bits, dtype, 132)
                    want = ({torch.bfloat16: "splitk", torch.float32: "rows"} if M <= 16 else
                            {torch.bfloat16: "wgmma", torch.float32: "f32"})[dtype]
                    assert plan.design == want
                    assert 1 <= plan.cluster <= tk.WQ_SPLITK_CLUSTER_MAX
                    slices = plan.slices(K)
                    assert slices[0][0] == 0 and slices[-1][1] == K
                    assert all(a[1] == b[0] for a, b in zip(slices, slices[1:]))
                    for lo, hi in slices:
                        assert hi > lo and (hi - lo) % 32 == 0
                        assert (hi - lo) % plan.k_step == 0
                        for k in range(lo, hi, plan.k_step):
                            assert k // Kg == (k + plan.k_step - 1) // Kg
                    if plan.design == "splitk":
                        assert plan.stage_k % 32 == 0 and plan.k_slice % 32 == 0
                        # a slice of whole stages, the last of K's own rows
                        assert all((hi - lo) % plan.stage_k == 0 or hi == K
                                   for lo, hi in slices)
                    if plan.design in ("rows", "f32"):
                        assert plan.k_slice <= tk.WQ_ROWS_SPLIT_MAX
                    n_plans += 1
    assert n_plans == len(_projection_shapes(cfg)) * 2 * 2 * 17


def test_wq_plan_fills_the_card_at_decode():
    """LLaMA-7B's decode projections: K split into clusters until the grid
    holds about 1.5 blocks an SM (w1's 86 strips take 2 slices, wq's 32
    take 6 of whole 256-row int4 stages), one launch each, no partial-sum
    pass; the mixed step's tiles alone fill the card (no split)."""
    w1 = tk.wq_plan(16, 4096, 11008, 1, 8, torch.bfloat16, 132)
    wq = tk.wq_plan(1, 4096, 4096, 1, 4, torch.bfloat16, 132)
    assert (w1.design, w1.splits, w1.k_slice, w1.reduce_launches) == ("splitk", 2, 2048, 0)
    assert (wq.design, wq.splits, wq.k_slice, wq.reduce_launches) == ("splitk", 6, 768, 0)
    mixed = tk.wq_plan(2048, 4096, 11008, 1, 8, torch.bfloat16, 132)
    assert (mixed.design, mixed.splits, mixed.cluster) == ("wgmma", 1, 1)
    # the f32 decode path keeps its second launch
    assert tk.wq_plan(16, 4096, 4096, 1, 8, torch.float32, 132).reduce_launches == 1


SERVE = dict(max_requests_per_batch=4, max_sequence_length=48, prefill_chunk=8,
             max_spec_tree_tokens=8, page_size=8)
PROMPTS = [[3, 17, 91, 42, 7], [9, 8, 7, 6, 5, 4], [1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11]]


def _jax_llm(family, cfg, params, layout, quantization):
    m = JaxLLM(family, cfg, params, mesh=MachineSpec().make_mesh(jax.devices()[:1]))
    m.compile(JaxServingConfig(kv_layout=layout, cache_dtype=jnp.float32, kernels="xla",
                               **SERVE), quantization=quantization)
    return m


def _port_llm(family, cfg, params, layout, quantization, **kw):
    m = LLM(family, cfg, params, device="cpu")
    m.compile(ServingConfig(kv_layout=layout, cache_dtype=torch.float32, kernels="torch",
                            **SERVE), quantization=quantization, **kw)
    return m


def _first_logits(family_t, family_j, m_t, m_j):
    """The first prefill step's logits of both engines over PROMPTS[2]."""
    toks = np.asarray([PROMPTS[2][:8]], np.int32)
    pos = np.arange(8, dtype=np.int32)[None]
    idx = np.asarray([7], np.int32)
    cache_j = family_j.init_kv_cache(m_j.cfg, 1, 16, jnp.float32)
    cache_t = family_t.init_kv_cache(m_t.cfg, 1, 16, torch.float32)
    lj, _ = family_j.serve_step(m_j.params, cache_j, jnp.asarray(toks), jnp.asarray(pos),
                                jnp.asarray(idx), None, None, cfg=m_j.cfg,
                                all_logits=False)
    lt, _ = family_t.serve_step(m_t.params, cache_t, torch.from_numpy(toks),
                                torch.from_numpy(pos), torch.from_numpy(idx), None, None,
                                cfg=m_t.cfg, all_logits=False, kernels="torch")
    return lt.numpy(), np.asarray(lj)


@pytest.mark.parametrize("layout", ["dense", "paged"])
@pytest.mark.parametrize("quantization", ["int8", "int4"])
def test_quantized_llama_serves_jax_tokens(llama_weights, quantization, layout):
    cfg_j, params_j, cfg_t, params_t = llama_weights
    m_j = _jax_llm(jl, cfg_j, params_j, layout, quantization)
    m_t = _port_llm(tl, cfg_t, params_t, layout, quantization)
    for name, w in m_t.params["layers"].items():
        if tq.is_quantized(w):
            np.testing.assert_array_equal(w["q"].numpy(),
                                          np.asarray(m_j.params["layers"][name]["q"]))
    tk.reset_launch_counts()
    got = [r.output_tokens for r in m_t.generate(PROMPTS, max_new_tokens=8)]
    assert tk.PLAIN_CALLS["wq_matmul"] > 0  # every projection on the plain version
    want = [r.output_tokens for r in m_j.generate(PROMPTS, max_new_tokens=8)]
    assert got == want
    lt, lj = _first_logits(tl, jl, m_t, m_j)
    np.testing.assert_allclose(lt, lj, atol=LOGIT_ATOL)


def test_quantized_mixtral_serves_jax_tokens(mixtral_weights):
    cfg_j, params_j, cfg_t, params_t = mixtral_weights
    m_j = _jax_llm(jmix, cfg_j, params_j, "paged", "int8")
    m_t = _port_llm(tmix, cfg_t, params_t, "paged", "int8")
    got = [r.output_tokens for r in m_t.generate(PROMPTS, max_new_tokens=6)]
    want = [r.output_tokens for r in m_j.generate(PROMPTS, max_new_tokens=6)]
    assert got == want
    lt, lj = _first_logits(tmix, jmix, m_t, m_j)
    np.testing.assert_allclose(lt, lj, atol=LOGIT_ATOL)


def test_quantized_footprint_bounds(llama_weights):
    """JAX's footprint bounds: int8 layers under 0.3 x their f32 bytes,
    int4 codes under 0.15 x the f32 matmul weights."""
    _, _, cfg_t, params_t = llama_weights
    dense = tq.quantized_nbytes(params_t["layers"])
    q8 = tq.quantize_params(params_t, 8)
    assert tq.quantized_nbytes(q8["layers"]) < 0.3 * dense
    q4 = tq.quantize_params(params_t, 4)
    codes = sum(v["q"].numel() for v in q4["layers"].values() if tq.is_quantized(v))
    weights = sum(v.numel() * 4 for k, v in params_t["layers"].items() if k.startswith("w"))
    assert codes < 0.15 * weights


@pytest.mark.parametrize("params_kind", ["quantized", "offloaded"])
def test_whole_step_refuses_quantized_and_offloaded_params(llama_weights, params_kind):
    """The capability gate refuses at engine construction, in its own
    words: the JAX package's for quantized weights, the port's for
    offloaded ones (one persistent kernel reads every layer at once)."""
    _, _, cfg_t, params_t = llama_weights
    sc = ServingConfig(kv_layout="paged", fused_decode=("whole_step",),
                       cache_dtype=torch.float32, **SERVE)
    if params_kind == "quantized":
        params = tq.quantize_params(params_t, 8)
        match = "weight-only quantization"
    else:
        # an OffloadedLayers needs a GPU to build; the gate reads its marker
        class Offloaded(dict):
            offloaded = True

        params = dict(params_t, layers=Offloaded(params_t["layers"]))
        match = "offloaded"
    with pytest.raises(ValueError, match=match):
        InferenceEngine(tl, cfg_t, params, sc, device="cpu")


def test_offload_on_cpu_warns_and_leaves_tokens_bitwise(llama_weights):
    _, _, cfg_t, params_t = llama_weights
    want = [r.output_tokens
            for r in _port_llm(tl, cfg_t, params_t, "paged", "int8").generate(
                PROMPTS, max_new_tokens=6)]
    with pytest.warns(UserWarning, match="no effect"):
        m = _port_llm(tl, cfg_t, params_t, "paged", "int8", offload=True)
    assert not getattr(m.params["layers"], "offloaded", False)
    assert [r.output_tokens for r in m.generate(PROMPTS, max_new_tokens=6)] == want


def test_layer_params_slices_quantized_pairs(llama_weights):
    _, _, _, params_t = llama_weights
    q = tq.quantize_params(params_t, 4)
    p1 = tq.layer_params(q["layers"], 1)
    assert torch.equal(p1["wq"]["q"], q["layers"]["wq"]["q"][1])
    assert torch.equal(p1["wq"]["scale"], q["layers"]["wq"]["scale"][1])
    assert torch.equal(p1["attn_norm"], q["layers"]["attn_norm"][1])


def test_serve_command_quantization_and_offload_reach_compile(monkeypatch):
    from flexflow_tpu_torch import __main__ as cli
    from flexflow_tpu_torch.serve import llm as llm_mod

    seen = {}
    real = llm_mod.LLM.compile

    def spy(self, serving=None, **kw):
        seen.update(kw)
        return real(self, serving, **kw)

    monkeypatch.setattr(llm_mod.LLM, "compile", spy)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        cli.main(["serve", "--device", "cpu", "--kernels", "torch", "--quantization", "int4",
                  "--offload", "--max-new-tokens", "2", "--prompt", "3,17,91"])
    assert seen["quantization"] == "int4" and seen["offload"] is True


def test_unknown_quantization_raises(llama_weights):
    _, _, cfg_t, params_t = llama_weights
    with pytest.raises(ValueError, match="quantization"):
        _port_llm(tl, cfg_t, params_t, "dense", "int2")


def test_quantized_early_exit_layers_serve(llama_weights):
    """The per-layer loops' num_layers slice (the early-exit draft) takes
    quantized layers as it takes dense ones."""
    _, _, cfg_t, params_t = llama_weights
    q = tq.quantize_params(params_t, 8)
    cache = tl.init_kv_cache(cfg_t, 1, 16, torch.float32)
    toks = torch.tensor([[5, 6, 7]])
    pos = torch.arange(3)[None]
    full, _ = tl.serve_step(q, cache, toks, pos, torch.tensor([2]), None, None, cfg=cfg_t,
                            all_logits=False, kernels="torch", num_layers=1)
    one = dataclasses.replace(cfg_t, num_hidden_layers=1)
    sliced = dict(q, layers={k: ({n: t[:1] for n, t in v.items()} if isinstance(v, dict)
                                 else v[:1]) for k, v in q["layers"].items()})
    cache1 = tl.init_kv_cache(one, 1, 16, torch.float32)
    ref, _ = tl.serve_step(sliced, cache1, toks, pos, torch.tensor([2]), None, None,
                           cfg=one, all_logits=False, kernels="torch")
    torch.testing.assert_close(full, ref, atol=0, rtol=0)
