"""The port's generic decoder (``flexflow_tpu_torch/models/transformer.py``)
and its eleven families against the JAX package on the same weights (f32
on the CPU): the dense and paged serving steps over a chunked prefill and
greedy decode steps, the early-exit slice and all-positions head, the
fused step against the unfused one, the K/V line moves with the position
buffer, and JAX's Pallas kernels in interpret mode against the port's
paged path."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flexflow_tpu.models as jzoo
import flexflow_tpu_torch.models as tzoo
from flexflow_tpu_torch.models import hf_utils

torch.set_num_threads(1)

FAMILIES = ("opt", "falcon", "mpt", "starcoder", "qwen2", "mixtral", "mistral", "qwen2_moe",
            "gemma", "phi", "gpt2")
# f32 logits of two implementations of one step: summation order only
# (measured ~1e-6 at these sizes)
LOGIT_ATOL = 1e-5
# quantized pools: a code that sits on a rounding boundary may round the
# other way under another summation order of its page's amax (one code
# step of one line, ~1e-4 in these logits); int4 codes are 16 times as
# coarse
QUANT_ATOL = {"int8": 1e-3, "int4": 1e-2}
R, PROMPT, CHUNK, DECODE = 3, 12, 4, 8


# the JAX steps, compiled once per shape (eager, each call's scan would
# compile again)
_jit = {}


def _jax_step(jm, paged):
    key = (jm.__name__, paged)
    if key not in _jit:
        _jit[key] = (jax.jit(jm.serve_step_paged, static_argnames=(
            "cfg", "cache_len", "all_logits", "kernels", "kv_quant", "fused_rope",
            "num_layers")) if paged else jax.jit(jm.serve_step, static_argnames=(
                "cfg", "all_logits", "num_layers")))
    return _jit[key]


@pytest.fixture(scope="module", params=FAMILIES)
def family(request):
    name = request.param
    jm, tm = getattr(jzoo, name), getattr(tzoo, name)
    cfg_j, cfg_t = jm.tiny(dtype=jnp.float32), tm.tiny(dtype=torch.float32)
    params_j = jm.init_params(jax.random.PRNGKey(3), cfg_j)
    params_t = hf_utils.params_from_numpy(jax.tree.map(np.asarray, params_j), device="cpu")
    return name, jm, tm, cfg_j, cfg_t, params_j, params_t


def _steps(seed):
    """Seeded prompts of PROMPT tokens, (R, PROMPT) int32 (the step loops
    below leave slot 2 idle: padding at the scratch line)."""
    return np.random.default_rng(seed).integers(0, 256, (R, PROMPT)).astype(np.int32)


def _run(step_j, step_t, prompts, scratch, tol):
    """Drive both steps through the prefill chunks, then DECODE greedy
    steps fed by the port's argmax; logits of the live slots within
    ``tol``, greedy tokens equal. Returns the port's logits per step."""
    got_all = []

    def one(tokens, pos, lidx):
        want = np.asarray(step_j(jnp.asarray(tokens), jnp.asarray(pos), jnp.asarray(lidx)))
        got = step_t(torch.from_numpy(tokens), torch.from_numpy(pos),
                     torch.from_numpy(lidx)).numpy()
        np.testing.assert_allclose(got[:2], want[:2], atol=tol)
        assert (got[:2].argmax(-1) == want[:2].argmax(-1)).all()
        got_all.append(got)
        return got

    for c0 in range(0, PROMPT, CHUNK):
        tokens = prompts[:, c0:c0 + CHUNK].copy()
        pos = np.broadcast_to(np.arange(c0, c0 + CHUNK, dtype=np.int32), (R, CHUNK)).copy()
        tokens[2], pos[2] = 0, scratch
        logits = one(tokens, pos, np.full((R,), CHUNK - 1, np.int32))
    for d in range(DECODE):
        tokens = logits.argmax(-1).astype(np.int32)[:, None]
        pos = np.full((R, 1), PROMPT + d, np.int32)
        tokens[2], pos[2] = 0, scratch
        logits = one(tokens, pos, np.zeros((R,), np.int32))
    return got_all


def test_serve_step_matches_jax(family):
    """The dense step (a cache of 24 lines + the scratch line): a chunked
    prefill and 8 greedy decode steps."""
    name, jm, tm, cfg_j, cfg_t, params_j, params_t = family
    max_len = PROMPT + DECODE + 4
    caches = [jm.init_kv_cache(cfg_j, R, max_len, dtype=jnp.float32),
              tm.init_kv_cache(cfg_t, R, max_len, dtype=torch.float32)]

    def step_j(t, p, li):
        logits, caches[0] = _jax_step(jm, False)(params_j, caches[0], t, p, li, None, cfg=cfg_j)
        return logits

    def step_t(t, p, li):
        logits, out = tm.serve_step(params_t, caches[1], t, p, li, None, cfg=cfg_t)
        assert out is caches[1]  # updated in place
        return logits

    _run(step_j, step_t, _steps(1), max_len, LOGIT_ATOL)
    if "pos" in caches[1]:  # the position buffer holds what JAX's does
        np.testing.assert_array_equal(caches[1]["pos"].numpy(), np.asarray(caches[0]["pos"]))


PS, NP = 8, 4  # 4 pages of 8 lines a slot: cache_len 31
POOLS = (("f32", None), ("bf16", None), ("int8", "int8"), ("int4", "int4"))


def _paged_table():
    P = R * NP - 2
    table = np.array([[0, 1, 2, P], [3, 4, 5, P], [P, P, P, P]], np.int32)
    return P, table


def _paged_steps(jm, tm, cfg_j, cfg_t, params_j, params_t, pool, quant, **port_kw):
    P, table = _paged_table()
    cache_len = NP * PS - 1
    jdt, tdt = ((jnp.bfloat16, torch.bfloat16) if pool == "bf16"
                else (jnp.float32, torch.float32))
    caches = [jm.init_paged_kv_cache(cfg_j, P, PS, dtype=jdt, kv_quant=quant),
              tm.init_paged_kv_cache(cfg_t, P, PS, dtype=tdt, kv_quant=quant, device="cpu")]

    def step_j(t, p, li):
        logits, caches[0] = _jax_step(jm, True)(
            params_j, caches[0], t, p, li, None, None, jnp.asarray(table), cfg=cfg_j,
            cache_len=cache_len, kernels="xla", kv_quant=quant)
        return logits

    def step_t(t, p, li):
        logits, _ = tm.serve_step_paged(
            params_t, caches[1], t, p, li, None, None, torch.from_numpy(table), cfg=cfg_t,
            cache_len=cache_len, kv_quant=quant, **port_kw)
        return logits

    return step_j, step_t, caches, cache_len


@pytest.mark.parametrize("pool,quant", [
    pytest.param(p, q, id=p, marks=() if p == "f32" else pytest.mark.slow) for p, q in POOLS])
def test_serve_step_paged_matches_jax(family, pool, quant):
    """``kernels="torch"`` on f32, bf16 (f32 model, bf16 lines: every
    product in f32 on both sides), int8 and int4 pools against JAX's
    ``kernels="xla"``; the position pool equal to JAX's."""
    name, jm, tm, cfg_j, cfg_t, params_j, params_t = family
    step_j, step_t, caches, cache_len = _paged_steps(jm, tm, cfg_j, cfg_t, params_j,
                                                     params_t, pool, quant, kernels="torch")
    _run(step_j, step_t, _steps(2), cache_len, QUANT_ATOL.get(quant, LOGIT_ATOL))
    if "pos" in caches[1]:
        np.testing.assert_array_equal(caches[1]["pos"][:-1].numpy(),
                                      np.asarray(caches[0]["pos"])[:-1])


@pytest.mark.parametrize("quant", [None, "int8", "int4"])
def test_fused_step_bitwise_vs_unfused(family, quant):
    """The ``kernels="cuda"`` paged step with ``fused_rope`` (on the CPU:
    the fused wrapper's plain version, RoPE of the rotary width or none)
    is bitwise the unfused ``kernels="cuda"`` step: logits and pools."""
    name, jm, tm, cfg_j, cfg_t, params_j, params_t = family
    P, table = _paged_table()
    cache_len = NP * PS - 1
    prompts = _steps(4)
    runs = []
    for fused in (False, True):
        cache = tm.init_paged_kv_cache(cfg_t, P, PS, dtype=torch.float32, kv_quant=quant,
                                       device="cpu")
        out = []
        for c0 in range(0, PROMPT, CHUNK):
            pos = torch.arange(c0, c0 + CHUNK).expand(R, CHUNK).clone()
            pos[2] = cache_len
            logits, _ = tm.serve_step_paged(
                params_t, cache, torch.from_numpy(prompts[:, c0:c0 + CHUNK]), pos,
                torch.full((R,), CHUNK - 1), None, None, torch.from_numpy(table), cfg=cfg_t,
                cache_len=cache_len, kernels="cuda", kv_quant=quant, fused_rope=fused)
            out.append(logits)
        runs.append((out, cache))
    for a, b in zip(runs[0][0], runs[1][0]):
        assert torch.equal(a[:2], b[:2])

    def pages(k, t):  # every pool row but the scratch page (padding writes it)
        return t[:P] if k == "pos" else t[:, :P]

    for k in runs[0][1]:
        assert torch.equal(pages(k, runs[0][1][k]), pages(k, runs[1][1][k])), k


@pytest.mark.slow
def test_num_layers_and_all_logits_match_jax(family):
    """The early-exit slice (``num_layers=1``: the deeper layer's pools
    untouched) and the all-positions head, both layouts."""
    name, jm, tm, cfg_j, cfg_t, params_j, params_t = family
    prompts = _steps(5)[:, :CHUNK]
    pos = np.broadcast_to(np.arange(CHUNK, dtype=np.int32), (R, CHUNK)).copy()
    li = np.full((R,), CHUNK - 1, np.int32)
    P, table = _paged_table()
    cache_len = NP * PS - 1
    for paged in (False, True):
        if paged:
            jc = jm.init_paged_kv_cache(cfg_j, P, PS)
            tc = tm.init_paged_kv_cache(cfg_t, P, PS, device="cpu")
            extra_j = dict(cache_len=cache_len)
            args_j = (None, None, jnp.asarray(table))
            args_t = (None, None, torch.from_numpy(table))
            ft = tm.serve_step_paged
        else:
            jc = jm.init_kv_cache(cfg_j, R, cache_len)
            tc = tm.init_kv_cache(cfg_t, R, cache_len)
            extra_j, args_j, args_t = {}, (None,), (None,)
            ft = tm.serve_step
        want, jc = _jax_step(jm, paged)(
            params_j, jc, jnp.asarray(prompts), jnp.asarray(pos), jnp.asarray(li), *args_j,
            cfg=cfg_j, all_logits=True, num_layers=1, **extra_j)
        got, tc = ft(params_t, tc, torch.from_numpy(prompts), torch.from_numpy(pos),
                     torch.from_numpy(li), *args_t, cfg=cfg_t, all_logits=True, num_layers=1,
                     **extra_j)
        assert got.shape == (R, CHUNK, cfg_t.vocab_size)
        np.testing.assert_allclose(got.numpy()[:2], np.asarray(want)[:2], atol=LOGIT_ATOL)
        assert not tc["k"][1].any() and not tc["v"][1].any()  # layer 2 untouched
        assert tc["k"][0].any()


def test_dense_cuda_step_raises(family):
    """The generic dense step has no kernel: kernels="cuda" raises, naming
    the paged layout and kernels="torch"."""
    name, jm, tm, cfg_j, cfg_t, params_j, params_t = family
    cache = tm.init_kv_cache(cfg_t, 1, 8)
    with pytest.raises(ValueError, match="kv_layout='paged'.*kernels='torch'"):
        tm.serve_step(params_t, cache, torch.zeros((1, 1), dtype=torch.long),
                      torch.zeros((1, 1), dtype=torch.long), torch.zeros((1,), dtype=torch.long),
                      None, cfg=cfg_t, kernels="cuda")


def test_sliding_window_masks_lines():
    """Mistral's tiny window (8) binds: 20-token contexts give other logits
    than the same weights without a window, on both layouts, and match
    JAX (the generic parity tests cover the path)."""
    jm, tm = jzoo.mistral, tzoo.mistral
    cfg_t = tm.tiny(dtype=torch.float32)
    params_j = jm.init_params(jax.random.PRNGKey(3), jm.tiny(dtype=jnp.float32))
    params_t = hf_utils.params_from_numpy(jax.tree.map(np.asarray, params_j), device="cpu")
    prompts = torch.from_numpy(_steps(6)).long()
    full = tm.tiny(dtype=torch.float32, sliding_window=0)
    outs = []
    for cfg in (cfg_t, full):
        cache = tm.init_kv_cache(cfg, R, 24)
        pos = torch.arange(PROMPT).expand(R, PROMPT)
        logits, _ = tm.serve_step(params_t, cache, prompts, pos, torch.full((R,), PROMPT - 1),
                                  None, cfg=cfg, all_logits=True)
        outs.append(logits)
    assert torch.allclose(outs[0][:, :8], outs[1][:, :8])  # inside the window: the same
    assert not torch.allclose(outs[0][:, 9:], outs[1][:, 9:], atol=1e-4)


def _rand_cache(tm, cfg, paged, quant=None, seed=0):
    gen = torch.Generator().manual_seed(seed)
    if paged:
        cache = tm.init_paged_kv_cache(cfg, 10, 4, kv_quant=quant, device="cpu")
    else:
        cache = tm.init_kv_cache(cfg, 3, 11)
    for k, t in cache.items():
        if t.dtype == torch.int32:
            t.copy_(torch.randint(0, 1000, t.shape, generator=gen))
        elif t.dtype in (torch.int8, torch.uint8):
            t.copy_(torch.randint(0, 100, t.shape, generator=gen).to(t.dtype))
        else:
            t.copy_(torch.rand(t.shape, generator=gen).to(t.dtype))
    return cache


def _to_jax(cache):
    return {k: jnp.asarray(v.numpy()) for k, v in cache.items()}


def _same(got, want):
    assert sorted(got) == sorted(want)
    for k in got:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)


@pytest.mark.parametrize("quant", [None, "int8"])
def test_line_moves_carry_positions_like_jax(quant):
    """commit_kv, reorder_slots and their paged twins, copy_page_kv,
    gather_page_kv and scatter_page_kv on caches with a position buffer
    (Mistral's window) against JAX's, every buffer equal."""
    jm, tm = jzoo.transformer, tzoo.transformer
    cfg_t = tzoo.mistral.tiny(dtype=torch.float32)
    src = np.array([[5, 6, 11], [2, 11, 11], [0, 1, 2]], np.int32)
    dst = np.array([[3, 4, 11], [1, 11, 11], [7, 8, 9]], np.int32)
    if quant is None:
        dense = _rand_cache(tm, cfg_t, False)
        want = jm.commit_kv(_to_jax(dense), jnp.asarray(src), jnp.asarray(dst))
        _same(tm.commit_kv(dense, torch.from_numpy(src), torch.from_numpy(dst)), want)
        order = np.array([2, 0, 2], np.int32)
        want = jm.reorder_slots(_to_jax(dense), jnp.asarray(order))
        _same(tm.reorder_slots(dense, torch.from_numpy(order)), want)
    table = np.array([[0, 1, 2, 3], [4, 5, 10, 10], [6, 7, 8, 9]], np.int32)
    paged = _rand_cache(tm, cfg_t, True, quant)
    lines_s = np.array([[5, 6, 15], [2, 7, 7], [0, 1, 2]], np.int32)
    lines_d = np.array([[3, 4, 15], [1, 7, 7], [9, 10, 11]], np.int32)
    want = jm.commit_kv_paged(_to_jax(paged), jnp.asarray(table), jnp.asarray(lines_s),
                              jnp.asarray(lines_d), kv_quant=quant)
    got = tm.commit_kv_paged(paged, torch.from_numpy(table), torch.from_numpy(lines_s),
                             torch.from_numpy(lines_d), kv_quant=quant)
    if quant is None:
        _same(got, want)
    else:  # the requantized codes to one step; the position pool exactly
        np.testing.assert_array_equal(got["pos"].numpy(), np.asarray(want["pos"]))
    order = np.array([0, 0, 2], np.int32)
    want = jm.reorder_slots_paged(_to_jax(paged), jnp.asarray(table[:2]),
                                  jnp.asarray(order[:2]))
    _same(tm.reorder_slots_paged(paged, torch.from_numpy(table[:2]),
                                 torch.from_numpy(order[:2])), want)
    want = jm.copy_page_kv(_to_jax(paged), 3, 6)
    _same(tm.copy_page_kv(paged, 3, 6), want)
    page = jm.gather_page_kv(_to_jax(paged), 2)
    got = tm.gather_page_kv(paged, 2)
    _same(got, page)
    want = jm.scatter_page_kv(_to_jax(paged), 9, page)
    _same(tm.scatter_page_kv(paged, 9, got), want)


@pytest.mark.slow
@pytest.mark.parametrize("name", ["phi", "starcoder"])
def test_fused_step_matches_jax_pallas_interpret(name):
    """JAX's paged step through its Pallas kernels in interpret mode with
    the fused RoPE + K/V-write prologue (``kernels="pallas",
    fused_rope=True``: Phi's partial rotary, StarCoder's learned positions
    with no RoPE) against the port's fused step (``kernels="cuda"``: on the
    CPU the fused wrapper's plain version), bf16 pools of an f32 model."""
    jm, tm = getattr(jzoo, name), getattr(tzoo, name)
    cfg_j, cfg_t = jm.tiny(dtype=jnp.float32), tm.tiny(dtype=torch.float32)
    params_j = jm.init_params(jax.random.PRNGKey(7), cfg_j)
    params_t = hf_utils.params_from_numpy(jax.tree.map(np.asarray, params_j), device="cpu")
    step_j, step_t, _, cache_len = _paged_steps(jm, tm, cfg_j, cfg_t, params_j, params_t,
                                                "f32", None, kernels="cuda", fused_rope=True)
    P, table = _paged_table()
    jc = jm.init_paged_kv_cache(cfg_j, P, PS)
    state = [jc]

    def step_pallas(t, p, li):
        logits, state[0] = _jax_step(jm, True)(
            params_j, state[0], t, p, li, None, None, jnp.asarray(table), cfg=cfg_j,
            cache_len=cache_len, kernels="pallas", fused_rope=True)
        return logits

    _run(step_pallas, step_t, _steps(8), cache_len, LOGIT_ATOL)
