"""The port's whole-step serving path (``fused_decode=("whole_step",)``) on
the CPU: ``serve_step_whole``'s plain version against the JAX package's
``serve_step_whole`` (its
Pallas walk in interpret mode) and against the port's own unfused paged
step, the tile rules and the engine's gate, ``LLM.generate`` through the
walk (pipelined and sync), and the configuration checks."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flexflow_tpu.models import llama as jl
from flexflow_tpu.serve import LLM as JaxLLM
from flexflow_tpu.serve import InferenceEngine as JaxInferenceEngine
from flexflow_tpu.serve import ServingConfig as JaxServingConfig
from flexflow_tpu_torch.models import llama as tl
from flexflow_tpu_torch.serve import LLM, InferenceEngine, ServingConfig
from flexflow_tpu_torch.serve import kernels as tk
from flexflow_tpu_torch.serve import kv_quant as tq

torch.set_num_threads(1)

# f32 logits of two implementations of the same step: summation order only
LOGIT_ATOL = 1e-4
# f32 pool values written by the two frameworks' projections and RoPE
POOL_ATOL = 1e-5


@pytest.fixture(scope="module")
def weights():
    cfg_j = jl.LLaMAConfig.tiny(dtype=jnp.float32)
    params_j = jl.init_params(jax.random.PRNGKey(7), cfg_j)
    cfg_t = tl.LLaMAConfig.tiny(dtype=torch.float32)
    params_t = tl.params_from_numpy(jax.tree.map(np.asarray, params_j), device="cpu")
    return cfg_j, params_j, cfg_t, params_t


# two slots of 4 pages of 8 lines over a pool of 6 pages (+ the scratch page)
PS, P, NP = 8, 6, 4
CACHE_LEN = NP * PS - 1
TABLE = np.array([[0, 1, P, P], [2, 3, P, P]], np.int32)
# a warm-up prefill of slot 1's lines [0, 4) through the unfused step, then
# a mixed step (slot 0 prefills 4 lines, slot 1 takes 2 and a padding
# column) and a decode step through the walk
WARM = (np.array([[0, 0, 0, 0], [13, 14, 15, 16]], np.int32),
        np.array([[CACHE_LEN] * 4, [0, 1, 2, 3]], np.int32),
        np.zeros((2,), np.int32))
STEPS = [
    (np.array([[5, 9, 3, 7], [11, 2, 0, 0]], np.int32),
     np.array([[0, 1, 2, 3], [4, 5, CACHE_LEN, CACHE_LEN]], np.int32),
     np.array([3, 1], np.int32)),
    (np.array([[4], [6]], np.int32), np.array([[4], [6]], np.int32), np.zeros((2,), np.int32)),
]


def _jax_steps(cfg, params, kv_quant, tiles):
    cache = jl.init_paged_kv_cache(cfg, P, PS, kv_quant=kv_quant)
    table = jnp.asarray(TABLE)
    paged = jax.jit(functools.partial(jl.serve_step_paged, cfg=cfg, cache_len=CACHE_LEN,
                                      kernels="xla", kv_quant=kv_quant))
    whole = jax.jit(functools.partial(jl.serve_step_whole, cfg=cfg, cache_len=CACHE_LEN,
                                      kv_quant=kv_quant, tiles=tiles))
    toks, pos, li = (jnp.asarray(a) for a in WARM)
    _, cache = paged(params, cache, toks, pos, li, None, None, table)
    out = []
    for toks, pos, li in STEPS:
        logits, greedy, cache = whole(params, cache, jnp.asarray(toks), jnp.asarray(pos),
                                      jnp.asarray(li), table)
        out.append((np.asarray(logits), np.asarray(greedy)))
    return out, {k: np.array(v) for k, v in cache.items()}


def _port_steps(cfg, params, kv_quant, tiles, kernels="torch", whole=True):
    cache = tl.init_paged_kv_cache(cfg, P, PS, kv_quant=kv_quant)
    table = torch.from_numpy(TABLE)
    toks, pos, li = (torch.from_numpy(a) for a in WARM)
    tl.serve_step_paged(params, cache, toks, pos, li, None, None, table, cfg=cfg,
                        cache_len=CACHE_LEN, kv_quant=kv_quant)
    out = []
    for toks, pos, li in STEPS:
        toks, pos, li = (torch.from_numpy(a) for a in (toks, pos, li))
        if whole:
            logits, greedy, same = tl.serve_step_whole(
                params, cache, toks, pos, li, table, cfg=cfg, cache_len=CACHE_LEN,
                kv_quant=kv_quant, tiles=tiles, kernels=kernels)
            assert same is cache and greedy.dtype == torch.int64
        else:
            logits, _ = tl.serve_step_paged(params, cache, toks, pos, li, None, None, table,
                                            cfg=cfg, cache_len=CACHE_LEN, kv_quant=kv_quant)
            greedy = torch.argmax(logits, dim=-1)
        out.append((logits, greedy))
    return out, cache


QUANTS = [None, "int8", pytest.param("int4", marks=pytest.mark.slow)]


@pytest.mark.parametrize("kv_quant", QUANTS)
@pytest.mark.parametrize("tiles", [1, 2])
def test_serve_step_whole_matches_jax(weights, kv_quant, tiles):
    """A mixed and a decode step through the walk: logits within
    LOGIT_ATOL of JAX's, greedy tokens equal, non-scratch pools within
    POOL_ATOL (f32) or one quantization step (codes), scales within 1e-6
    relative. JAX's tiled walk is held to a tolerance, never bitwise (its
    own bitwise test against its unfused step fails on the CPU)."""
    cfg_j, params_j, cfg_t, params_t = weights
    want, jcache = _jax_steps(cfg_j, params_j, kv_quant, tiles)
    got, tcache = _port_steps(cfg_t, params_t, kv_quant, tiles)
    for (gl, gt), (wl, wt) in zip(got, want):
        np.testing.assert_allclose(gl.numpy(), wl, atol=LOGIT_ATOL)
        assert gt.tolist() == wt.tolist()
    pack = 1 if kv_quant is None else tq.SPECS[kv_quant].pack
    for name in ("k", "v"):
        a = tq.unpack_codes(tcache[name][:, :P], pack)
        b = tq.unpack_codes(torch.from_numpy(jcache[name][:, :P]), pack)
        assert float((a - b).abs().max()) <= (POOL_ATOL if kv_quant is None else 1.0)
    if kv_quant is not None:
        for name in ("k_scale", "v_scale"):
            np.testing.assert_allclose(tcache[name].numpy()[:, :P], jcache[name][:, :P],
                                       rtol=1e-6, atol=0)


@pytest.mark.parametrize("kv_quant", [None, "int8", "int4"])
@pytest.mark.parametrize("tiles", [1, 2, 4])
def test_serve_step_whole_vs_unfused_port(weights, kv_quant, tiles):
    """Against the port's unfused paged step (kernels="torch"): bitwise at
    every tile count (the same ops; the tile count only groups the
    kernel's output columns); the kernel wrapper's CPU path is bitwise the
    plain walk."""
    cfg_t, params_t = weights[2], weights[3]
    want, ucache = _port_steps(cfg_t, params_t, kv_quant, 1, whole=False)
    got, wcache = _port_steps(cfg_t, params_t, kv_quant, tiles)
    via_wrapper, ccache = _port_steps(cfg_t, params_t, kv_quant, tiles, kernels="cuda")
    for (gl, gt), (wl, wt), (cl, ct) in zip(got, want, via_wrapper):
        assert torch.equal(gl, cl) and torch.equal(gt, ct)
        assert torch.equal(gl, wl) and torch.equal(gt, wt)
    for name in wcache:
        assert torch.equal(wcache[name], ccache[name])
        assert torch.equal(wcache[name][:, :P], ucache[name][:, :P]), name


def test_whole_step_wrapper_rejects_an_illegal_tile_count(weights):
    """A tile count that does not divide every tiled width raises, on the
    CPU as on the card."""
    cfg_t, params_t = weights[2], weights[3]
    with pytest.raises(ValueError, match="tiles=3"):
        _port_steps(cfg_t, params_t, None, 3, kernels="cuda")


# ---------------------------------------------------------------------------
# tile rules and the engine's gate


def _layout(weights, R=2, C=1):
    cfg_t, params_t = weights[2], weights[3]
    la, _ = tl.whole_step_weight_layout(params_t, cfg_t)
    roles = tl.whole_step_tile_roles(cfg_t)
    cache = tl.init_paged_kv_cache(cfg_t, P, PS)
    x0 = torch.empty((R, C, cfg_t.hidden_size), dtype=torch.float32, device="meta")
    return la, roles, cache, x0, cfg_t.num_attention_heads


def test_tile_candidates_are_gcd_divisors(weights):
    la, roles, _, _, _ = _layout(weights)
    cands = tk.whole_step_tile_candidates(la, roles)
    assert cands == (1, 2, 4, 8, 16, 32)  # gcd(64, 32, 32, 64, 128, 128, 64) = 32
    for t in cands:
        for wname, _b in roles.values():
            assert la[wname].shape[-1] % t == 0
    # at LLaMA-7B widths the gcd is gcd(4096, 11008) = 256
    sizes = {"wq": 4096, "wk": 4096, "wv": 4096, "wo": 4096, "w1": 11008, "w3": 11008,
             "w2": 4096}
    seven = {n: torch.empty((1, 8, w), device="meta") for n, w in sizes.items()}
    assert tk.whole_step_tile_candidates(seven, roles) == (1, 2, 4, 8, 16, 32, 64, 128, 256)


@pytest.mark.parametrize("C", [1, 4])
def test_pick_tiles_smallest_that_fits_squeezed_and_floor(weights, C):
    la, roles, cache, x0, H = _layout(weights, C=C)
    args = (la, cache, x0, H)
    legal = [t for t in tk.whole_step_tile_candidates(la, roles)
             if tk.whole_step_kernel_takes(la, tiles=t, tile_roles=roles)]
    est = {t: tk.whole_step_smem_bytes(*args, tiles=t, tile_roles=roles) for t in legal}
    # a 32-wide K/V role at 32 tiles takes one 8-column tile (the kernel
    # rounds a tile up to whole 8-wide MMA columns)
    assert legal[0] == 1 and 32 in legal and tk._ws_tile_width(32, 32) == 8
    t1, e1 = tk.whole_step_pick_tiles(*args, tile_roles=roles, budget=1 << 40)
    assert (t1, e1) == (1, est[1])
    # squeezed between the untiled item and the next tiling: that tiling
    force = legal[1]
    assert est[force] < est[1]
    tf, ef = tk.whole_step_pick_tiles(*args, tile_roles=roles,
                                      budget=(est[force] + est[1]) // 2)
    assert tf == force > 1 and ef == est[force]
    for budget in (est[force], est[legal[-1]], max(est.values()) + 1):
        t, _ = tk.whole_step_pick_tiles(*args, tile_roles=roles, budget=budget)
        assert t == min(x for x in legal if est[x] <= budget)
    # below the static + attention floor no tiling fits
    tn, floor_est = tk.whole_step_pick_tiles(*args, tile_roles=roles, budget=1024)
    assert tn is None and floor_est == min(est.values()) > 1024


def test_pricing_at_llama_7b_widths():
    """The gate's picks at LLaMA-7B widths, 16 slots, bf16: 16 column tiles
    for the decode step (16-row tiles) and 8 for the C = 128 mixed step,
    whose projections run on wgmma in 128 × 256 items at any tile count
    (the TMA ring, 197,632 bytes, priced alone); the kernel takes 8 to 256
    — at 64 it rounds F = 11008's 172-wide tiles up to 176 columns (whole
    8-wide MMA columns), and 4 would need more accumulators than a warp
    holds at decode. On every pool type (bf16, int8, int4) the C =
    128 step prices the tensor-core attention tile (MmaSmem) too, and so
    does an f32 model (projections on the CUDA cores) on f32, int8 and
    int4 pools, which picks 32 tiles at both steps: its 219,968-byte tile
    on f32 pages and the 12 KB static price leave 192 bytes of the
    budget."""
    cfg = tl.LLaMAConfig.llama_7b()
    D, Fd, dk = cfg.hidden_size, cfg.intermediate_size, cfg.head_dim
    roles = tl.whole_step_tile_roles(cfg)
    for dtype, want in ((torch.bfloat16, {1: 16, 128: 8}), (torch.float32, {1: 32, 128: 32})):
        meta = dict(dtype=dtype, device="meta")
        la = {"wq": torch.empty((1, D, D), **meta), "wk": torch.empty((1, D, D), **meta),
              "wv": torch.empty((1, D, D), **meta), "wo": torch.empty((1, D, D), **meta),
              "w1": torch.empty((1, D, Fd), **meta), "w2": torch.empty((1, Fd, D), **meta),
              "w3": torch.empty((1, D, Fd), **meta)}
        takes = [t for t in tk.whole_step_tile_candidates(la, roles)
                 if tk.whole_step_kernel_takes(la, tiles=t, tile_roles=roles)]
        assert takes == [8, 16, 32, 64, 128, 256]
        f32 = dtype == torch.float32
        for kind, pool_dtype, width in ((0, dtype, dk), (1, torch.int8, dk),
                                        (2, torch.uint8, dk // 2)):
            cache = {"k": torch.empty((1, 273, 128, 32, width), dtype=pool_dtype,
                                      device="meta")}
            for C in (1, 128):
                x0 = torch.empty((16, C, D), **meta)
                t, est = tk.whole_step_pick_tiles(la, cache, x0, 32, tile_roles=roles,
                                                  budget=tk.WHOLE_STEP_SMEM_BUDGET)
                assert t == want[C] and est <= tk.WHOLE_STEP_SMEM_BUDGET
                tile = tk.mma_smem_bytes(f32, kind, dk)
                if C == 128:  # the tile, with the static price on top, is priced
                    assert est >= tile + tk._WS_STATIC_SMEM
                    if not f32:  # the wgmma ring, the most of the three
                        assert est == tk._WS_TC_SMEM + tk._WS_STATIC_SMEM == 209920
                    for smaller in takes[:takes.index(t)]:
                        assert tk.whole_step_smem_bytes(la, cache, x0, 32, tiles=smaller,
                                                        tile_roles=roles) > est
        if f32:
            cache = {"k": torch.empty((1, 273, 128, 32, dk), **meta)}
            x0 = torch.empty((16, 128, D), **meta)
            assert tk.WHOLE_STEP_SMEM_BUDGET - tk.whole_step_smem_bytes(
                la, cache, x0, 32, tiles=32, tile_roles=roles) == 192


# MmaSmem<TQ, KIND, DK>::kBytes at dk 64 and 128, by (q f32, pool kind 0 q's
# type / 1 int8 / 2 int4): the ragged kernels' shared bytes in the ptxas
# table of PERF.md (the ragged kernels hold no static shared memory)
MMA_SMEM = {(False, 0): (89728, 138880), (False, 1): (77440, 118400),
            (False, 2): (65152, 93824), (True, 0): (173696, 219968),
            (True, 1): (128640, 218752), (True, 2): (116352, 194176)}


@pytest.mark.parametrize("f32,kind", sorted(MMA_SMEM))
def test_mma_smem_mirror_pins_the_tile_layout(f32, kind):
    """The port's one Python mirror of the tensor-core tile's shared
    memory, which the whole-step gate prices, gives the bytes ptxas and
    the kernels' layout gave on the card, within the tile's budget."""
    for dk, want in zip((64, 128), MMA_SMEM[(f32, kind)]):
        assert tk.mma_smem_bytes(f32, kind, dk) == want <= tk.MMA_SMEM_BUDGET


def test_whole_step_stage_ms_on_synthetic_stamps():
    """The kernel's stamps to milliseconds by stage: the entry, 8 stage
    ends a layer, the tail's 3; each layer stage summed over the layers,
    exactly, in ns / 1e6. A wrong count or a falling stamp raises."""
    L = 3
    n = tk.whole_step_stamp_count(L)
    assert n == 1 + 8 * L + 3
    stages = tk.WHOLE_STEP_STAGES
    steps, want = [], dict.fromkeys(stages + tk.WHOLE_STEP_TAIL, 0)
    for l in range(L):
        for i, name in enumerate(stages):
            steps.append(1000 * (i + 1) + 7 * l)
            want[name] += 1000 * (i + 1) + 7 * l
    for i, name in enumerate(tk.WHOLE_STEP_TAIL):
        steps.append(500_000 * (i + 1))
        want[name] = 500_000 * (i + 1)
    t0 = 1_700_000_000_000_000_000  # a global-timer reading in ns
    stamps = [t0]
    for d in steps:
        stamps.append(stamps[-1] + d)
    got = tk.whole_step_stage_ms(torch.tensor(stamps, dtype=torch.int64), L)
    assert list(got) == list(stages + tk.WHOLE_STEP_TAIL)
    assert got == {k: v / 1e6 for k, v in want.items()}
    assert sum(got.values()) == pytest.approx((stamps[-1] - stamps[0]) / 1e6, rel=1e-12)
    with pytest.raises(ValueError, match="stamps for"):
        tk.whole_step_stage_ms(stamps[:-1], L)
    stamps[5] = stamps[4] - 1
    with pytest.raises(ValueError, match="do not rise"):
        tk.whole_step_stage_ms(stamps, L)


SERVE = dict(max_requests_per_batch=3, max_sequence_length=32, prefill_chunk=4,
             max_spec_tree_tokens=8, page_size=8, kv_layout="paged")
TIGHT = dict(SERVE, max_cached_tokens=48)  # 6 pages: forces preemption
PROMPTS = [list(range(3, 13)), [20, 21, 22, 23, 24, 25], list(range(40, 49)),
           [7, 8, 9], list(range(60, 71))]


def _port(weights, dtype=torch.float32, **serve):
    cfg_t, params_t = weights[2], weights[3]
    p = LLM(tl, cfg_t, params_t, device="cpu")
    p.compile(ServingConfig(cache_dtype=dtype, **serve))
    return p


def test_engine_gate_squeezed_and_below_the_floor(weights, monkeypatch):
    cfg_t, params_t = weights[2], weights[3]
    serve = dict(TIGHT, fused_decode=("whole_step",))
    want = [r.output_tokens for r in _port(weights, kernels="torch", **TIGHT).generate(
        PROMPTS, max_new_tokens=6)]
    roomy = InferenceEngine(tl, cfg_t, params_t, ServingConfig(**serve), device="cpu")
    assert roomy.whole_step_on and roomy.whole_step_mixed_on
    assert roomy.whole_step_tiles == roomy.whole_step_mixed_tiles == 1
    assert roomy.whole_step_fallbacks == 0 and roomy.whole_step_smem_est > 0
    # squeezed just below the untiled price: the gate tiles instead
    monkeypatch.setattr(tk, "WHOLE_STEP_SMEM_BUDGET", roomy.whole_step_smem_est - 1)
    p = _port(weights, **serve)
    assert p.engine.whole_step_on and p.engine.whole_step_tiles > 1
    assert [r.output_tokens for r in p.generate(PROMPTS, max_new_tokens=6)] == want
    # below the floor: the walk is off, one fallback, the unfused path serves
    monkeypatch.setattr(tk, "WHOLE_STEP_SMEM_BUDGET", 1024)
    p = _port(weights, **serve)
    assert not p.engine.whole_step_on and p.engine.whole_step_fallbacks == 1
    got = [r.output_tokens for r in p.generate(PROMPTS, max_new_tokens=6)]
    assert got == want
    assert p.rm.stats.whole_step_fallbacks == 1
    assert p.rm.stats.snapshot()["whole_step_fallbacks"] == 1


# ---------------------------------------------------------------------------
# LLM.generate through the walk


@pytest.mark.parametrize("kv_quant", [None, "int8"])
@pytest.mark.parametrize("continuous_batching", [True, False])
def test_generate_whole_step_matches_unfused_and_jax(weights, kv_quant, continuous_batching):
    """Greedy tokens through the walk (pipelined, or the sync run_sampled
    path) equal the port's unfused paged run and JAX's LLM.generate with
    whole_step, under a budget that preempts; every page returns."""
    cfg_j, params_j = weights[:2]
    dt = (jnp.float32, torch.float32) if kv_quant is None else (jnp.bfloat16, torch.bfloat16)
    serve = dict(TIGHT, kv_quant=kv_quant, continuous_batching=continuous_batching)
    whole = dict(serve, fused_decode=("whole_step",))
    m = JaxLLM(jl, cfg_j, params_j)
    m.compile(JaxServingConfig(cache_dtype=dt[0], **whole))
    want = [r.output_tokens for r in m.generate(PROMPTS, max_new_tokens=8)]
    unfused = _port(weights, dt[1], kernels="torch", **serve)
    assert [r.output_tokens for r in unfused.generate(PROMPTS, max_new_tokens=8)] == want
    p = _port(weights, dt[1], **whole)
    before = dict(tk.LAUNCHES)
    got = [r.output_tokens for r in p.generate(PROMPTS, max_new_tokens=8)]
    assert got == want
    assert tk.LAUNCHES == before  # CPU tensors: the plain version, no launch
    st = p.rm.stats
    # the int8 budget, priced at bf16, buys pages enough for every request
    assert (st.preemptions > 0) == (kv_quant is None) and st.whole_step_fallbacks == 0
    assert st.whole_step_smem_est == p.engine.whole_step_smem_est > 0
    if not continuous_batching:
        assert st.sync_steps > 0
    p.engine.pager.check_no_leaks()
    assert p.engine.pager.free_pages == p.engine.pager.num_pages


def test_sampled_decode_through_the_walk_equals_unfused(weights):
    """Non-greedy rows sample from the walk's logits with the scheduler's
    generator: the same draws as the unfused kernels="torch" step (bitwise
    logits at tiles=1), on both the pipelined and the sync path."""
    from flexflow_tpu_torch.serve.batch_config import GenerationConfig

    gen = GenerationConfig(do_sample=True, temperature=0.8, topk=5, topp=0.9)
    for cb in (True, False):
        outs = []
        for fused in ((), ("whole_step",)):
            p = _port(weights, fused_decode=fused, continuous_batching=cb, kernels="torch",
                      **SERVE)
            outs.append([r.output_tokens for r in p.generate(PROMPTS[:3], gen=gen,
                                                              max_new_tokens=6)])
        assert outs[0] == outs[1]


def test_run_sampled_with_logits_equals_unfused(weights):
    """run_sampled on a mixed batch returns the walk's greedy tokens and
    its logits, bitwise the unfused kernels="torch" run's logits."""
    from flexflow_tpu_torch.serve.batch_config import BatchConfig

    cfg_t, params_t = weights[2], weights[3]
    engines = [InferenceEngine(tl, cfg_t, params_t,
                               ServingConfig(cache_dtype=torch.float32, kernels="torch",
                                             fused_decode=fused, **SERVE), device="cpu")
               for fused in ((), ("whole_step",))]
    R = 3
    bc = BatchConfig.empty(R, 4, engines[0].scratch_pos)
    bc.tokens[0, :3] = [5, 6, 7]
    bc.positions[0, :3] = [0, 1, 2]
    bc.logits_idx[0] = 2
    head = (np.ones((R,), bool), np.ones((R,), np.float32), np.full((R,), 2.0, np.float32),
            np.zeros((R,), np.int32))
    outs = []
    for e in engines:
        assert e.pager.ensure(0, 3)
        toks, logits = e.run_sampled(bc, torch.Generator(), *head, with_logits=True)
        outs.append((toks, logits))
    assert torch.equal(outs[0][1], outs[1][1])
    assert torch.equal(outs[0][0], outs[1][0])
    assert torch.equal(outs[1][0], torch.argmax(outs[1][1], dim=-1))


# ---------------------------------------------------------------------------
# configuration checks


SERVE_NO_PS = {k: v for k, v in SERVE.items() if k not in ("page_size", "kv_layout")}


@pytest.mark.parametrize("serve", [
    dict(fused_decode=("whole_step",)),                       # dense layout
    dict(kv_layout="paged", fused_decode=("whole_step", "bogus")),
])
def test_whole_step_validation_errors_match_jax(weights, serve):
    cfg_j, params_j, cfg_t, params_t = weights
    with pytest.raises(ValueError):
        JaxInferenceEngine(jl, cfg_j, params_j, JaxServingConfig(**SERVE_NO_PS, **serve))
    with pytest.raises(ValueError):
        InferenceEngine(tl, cfg_t, params_t, ServingConfig(**SERVE_NO_PS, **serve),
                        device="cpu")


def test_quantized_allreduce_waits_for_parallel_serving(weights):
    cfg_t, params_t = weights[2], weights[3]
    with pytest.raises(NotImplementedError, match="parallel-serving"):
        InferenceEngine(tl, cfg_t, params_t,
                        ServingConfig(fused_decode=("whole_step",), quantized_allreduce="int8",
                                      **SERVE), device="cpu")


def test_whole_step_weight_layout_names_and_validates(weights):
    cfg_t, params_t = weights[2], weights[3]
    la, ha = tl.whole_step_weight_layout(params_t, cfg_t)
    assert sorted(la) == sorted(params_t["layers"])
    assert all(la[n] is params_t["layers"][n] for n in la)  # nothing copied
    assert sorted(ha) == ["final_norm", "lm_head"]
    bad = dict(params_t, layers=dict(params_t["layers"], wq=params_t["layers"]["wq"][:1]))
    with pytest.raises(ValueError, match="leading dim"):
        tl.whole_step_weight_layout(bad, cfg_t)
    tied = tl.LLaMAConfig.tiny(dtype=torch.float32, tie_word_embeddings=True)
    assert sorted(tl.whole_step_weight_layout(params_t, tied)[1]) == ["embed", "final_norm"]
