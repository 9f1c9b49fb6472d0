"""The whole-step speculation fold on the CPU: ``serve_step_whole`` with a
tree mask, non-contiguous cache positions, the all-positions head and the
early-exit layer slice, held bitwise to the port's unfused paged step
(``serve_step_paged(kernels="torch")`` with the same keywords) and, within
a tolerance, to the JAX package's unfused step; the engine's fold gate;
and SpecInfer managers over whole-step engines, token for token against
the port's unfused manager and JAX's."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flexflow_tpu.models import llama as jl
from flexflow_tpu.serve import InferenceEngine as JaxInferenceEngine
from flexflow_tpu.serve import ServingConfig as JaxServingConfig
from flexflow_tpu.serve import specinfer as js
from flexflow_tpu_torch.models import llama as tl
from flexflow_tpu_torch.serve import InferenceEngine, ServingConfig
from flexflow_tpu_torch.serve import kernels as tk
from flexflow_tpu_torch.serve import specinfer as ts

torch.set_num_threads(1)

# f32 logits of the two frameworks' unfused steps: summation order only
ATOL = 1e-5
LAYERS = 3


def _weights(seed, layers):
    cfg_j = jl.LLaMAConfig.tiny(dtype=jnp.float32, num_hidden_layers=layers)
    params_j = jl.init_params(jax.random.PRNGKey(seed), cfg_j)
    cfg_t = tl.LLaMAConfig.tiny(dtype=torch.float32, num_hidden_layers=layers)
    params_t = tl.params_from_numpy(jax.tree.map(np.asarray, params_j), device="cpu")
    return cfg_j, params_j, cfg_t, params_t


@pytest.fixture(scope="module")
def weights():
    return _weights(3, LAYERS)


def _bf16(cfg, params):
    return (tl.LLaMAConfig.tiny(dtype=torch.bfloat16, num_hidden_layers=cfg.num_hidden_layers),
            {k: ({n: a.to(torch.bfloat16) for n, a in v.items()} if isinstance(v, dict)
                 else v.to(torch.bfloat16)) for k, v in params.items()})


# two slots of 6 pages of 16 lines, their pages scattered over a pool of 13
# (+ the scratch page); slot 0 holds 14 committed lines, slot 1 holds 5
PS, P, NP = 16, 13, 6
CACHE_LEN = NP * PS - 1
TABLE = np.array([[0, 3, 5, 8, 10, 12], [1, 2, 4, 6, 7, 9]], np.int32)
PREFIX = (14, 5)


def _tree_step(C, seed=0):
    """A tree step of C columns a slot: node 0 the root, each later node a
    child of an earlier one (rows that are no prefix), RoPE position
    prefix + depth, cache lines prefix + a random increasing choice that
    skips lines and crosses pages; slot 1's last column is padding (no
    line attended, its line the scratch line) when C > 2."""
    rng = np.random.default_rng(seed + C)
    tokens = rng.integers(0, 256, size=(2, C)).astype(np.int64)
    positions = np.full((2, C), CACHE_LEN, np.int64)
    cpos = np.full((2, C), CACHE_LEN, np.int64)
    mask = np.zeros((2, C, CACHE_LEN + 1), bool)
    for s, prefix in enumerate(PREFIX):
        n = C - 1 if (s == 1 and C > 2) else C
        parents = [-1] + [int(rng.integers(0, i)) for i in range(1, n)]
        depth = [0] * n
        for i in range(1, n):
            depth[i] = depth[parents[i]] + 1
        lines = prefix + np.sort(rng.choice(np.arange(1, C + 10), size=n - 1, replace=False))
        lines = np.concatenate([[prefix], lines])
        for i in range(n):
            positions[s, i] = prefix + depth[i]
            cpos[s, i] = lines[i]
            mask[s, i, :prefix] = True
            j = i
            while j >= 0:
                mask[s, i, lines[j]] = True
                j = parents[j]
    return tokens, positions, cpos, mask


def _prefilled(cfg, params, kv_quant):
    """A pool with each slot's committed lines, written by the unfused step."""
    cache = tl.init_paged_kv_cache(cfg, P, PS, kv_quant=kv_quant)
    table = torch.from_numpy(TABLE)
    C = max(PREFIX)
    toks = torch.arange(2 * C).reshape(2, C) % 256
    pos = torch.tensor([[i if i < p else CACHE_LEN for i in range(C)] for p in PREFIX])
    tl.serve_step_paged(params, cache, toks, pos, torch.zeros(2, dtype=torch.long), None, None,
                        table, cfg=cfg, cache_len=CACHE_LEN, kv_quant=kv_quant)
    return cache


POOLS = ["f32", "bf16", "int8", "int4"]


@pytest.mark.parametrize("pool", POOLS)
@pytest.mark.parametrize("C", [2, 3, 7, 25])
@pytest.mark.parametrize("num_layers", [1, None])
def test_fold_bitwise_unfused_port(weights, pool, C, num_layers):
    """serve_step_whole's fold (plain version, and the kernel wrapper's CPU
    path at two tile counts) against serve_step_paged(kernels="torch")
    with the same keywords: logits, greedy tokens (the first maximal
    index of each row) and every pool and scale byte, the deeper layers'
    untouched by a sliced draft."""
    cfg, params = weights[2], weights[3]
    if pool == "bf16":
        cfg, params = _bf16(cfg, params)
    kv_quant = pool if pool in ("int8", "int4") else None
    toks, pos, cpos, mask = (torch.from_numpy(a) for a in _tree_step(C))
    table = torch.from_numpy(TABLE)
    li = torch.zeros(2, dtype=torch.long)
    kw = dict(cfg=cfg, cache_len=CACHE_LEN, kv_quant=kv_quant, all_logits=True,
              num_layers=num_layers)
    want_cache = _prefilled(cfg, params, kv_quant)
    before = {k: v.clone() for k, v in want_cache.items()}
    want, _ = tl.serve_step_paged(params, want_cache, toks, pos, li, mask, cpos, table,
                                  kernels="torch", **kw)
    assert want.shape == (2, C, cfg.vocab_size)
    runs = [("torch", 1), ("cuda", 1), ("cuda", 2)]
    for kernels, tiles in runs:
        cache = _prefilled(cfg, params, kv_quant)
        logits, greedy, same = tl.serve_step_whole(params, cache, toks, pos, li, table,
                                                   mask=mask, cache_positions=cpos,
                                                   kernels=kernels, tiles=tiles, **kw)
        assert same is cache
        assert torch.equal(logits, want)
        assert greedy.shape == (2, C) and torch.equal(greedy, torch.argmax(want, dim=-1))
        for name in cache:
            assert torch.equal(cache[name], want_cache[name]), name
    n = LAYERS if num_layers is None else num_layers
    for name in want_cache:  # the slice wrote its layers' lines, no deeper ones
        assert torch.equal(want_cache[name][n:], before[name][n:]), name
        assert not torch.equal(want_cache[name][:n], before[name][:n]), name


@pytest.mark.parametrize("kv_quant", [None, "int8"])
@pytest.mark.parametrize("C,num_layers", [(7, None), (25, None), (3, 1)])
def test_fold_matches_jax_unfused(weights, kv_quant, C, num_layers):
    """The fold against JAX's serve_step_paged(kernels="xla") with the same
    keywords on the same weights (JAX's fold is bitwise that step): f32
    logits within ATOL at the live rows, equal argmax."""
    cfg_j, params_j, cfg_t, params_t = weights
    toks, pos, cpos, mask = _tree_step(C)
    jcache = jl.init_paged_kv_cache(cfg_j, P, PS, kv_quant=kv_quant)
    table = jnp.asarray(TABLE)
    step = jax.jit(functools.partial(jl.serve_step_paged, cfg=cfg_j, cache_len=CACHE_LEN,
                                     kernels="xla", kv_quant=kv_quant))
    Cp = max(PREFIX)
    ptoks = np.arange(2 * Cp).reshape(2, Cp) % 256
    ppos = np.array([[i if i < p else CACHE_LEN for i in range(Cp)] for p in PREFIX])
    _, jcache = step(params_j, jcache, jnp.asarray(ptoks, jnp.int32),
                     jnp.asarray(ppos, jnp.int32), jnp.zeros(2, jnp.int32), None, None, table)
    tree = jax.jit(functools.partial(jl.serve_step_paged, cfg=cfg_j, cache_len=CACHE_LEN,
                                     kernels="xla", kv_quant=kv_quant, all_logits=True,
                                     num_layers=num_layers))
    want, _ = tree(params_j, jcache, jnp.asarray(toks, jnp.int32), jnp.asarray(pos, jnp.int32),
                   jnp.zeros(2, jnp.int32), jnp.asarray(mask), jnp.asarray(cpos, jnp.int32),
                   table)
    want = np.asarray(want)
    cache = _prefilled(cfg_t, params_t, kv_quant)
    got, greedy, _ = tl.serve_step_whole(
        params_t, cache, torch.from_numpy(toks), torch.from_numpy(pos),
        torch.zeros(2, dtype=torch.long), torch.from_numpy(TABLE), cfg=cfg_t,
        cache_len=CACHE_LEN, kv_quant=kv_quant, mask=torch.from_numpy(mask),
        cache_positions=torch.from_numpy(cpos), all_logits=True, num_layers=num_layers,
        kernels="cuda")
    live = mask.any(-1)  # padding columns attend nothing: their outputs differ by design
    np.testing.assert_allclose(got.numpy()[live], want[live], atol=ATOL, rtol=0)
    assert (greedy.numpy()[live] == want.argmax(-1)[live]).all()


# ---------------------------------------------------------------------------
# the engine's gate

SERVE = dict(max_requests_per_batch=4, max_sequence_length=96, prefill_chunk=8,
             max_spec_tree_tokens=16, kv_layout="paged", page_size=16)


def _engine(w, kernels="cuda", **kw):
    return InferenceEngine(tl, w[2], w[3], ServingConfig(cache_dtype=torch.float32,
                                                         kernels=kernels,
                                                         **dict(SERVE, **kw)),
                           device="cpu")


def test_spec_fold_on_at_every_tile_count(weights, monkeypatch):
    """whole_step_spec_on holds with the walk at the gate's tile count, 1
    or more: the gate prices each SpecInfer chunk width at its own legal
    count (the kernel's answer does not depend on it)."""
    eng = _engine(weights, fused_decode=("whole_step",))
    assert eng.whole_step_tiles == 1 and eng.whole_step_spec_on
    assert eng.whole_step_spec_gate([2, 7, 25])
    assert eng.whole_step_spec_tiles == {2: 1, 7: 1, 25: 1}
    layer_arrays, _ = tl.whole_step_weight_layout(weights[3], weights[2])
    roles = tl.whole_step_tile_roles(weights[2])
    x0 = torch.empty((4, 7, weights[2].hidden_size), device="meta")
    one = tk.whole_step_smem_bytes(layer_arrays, eng.cache, x0, 4, tiles=1, tile_roles=roles,
                                   all_logits=True)
    assert one >= tk.whole_step_smem_bytes(layer_arrays, eng.cache, x0, 4, tiles=1,
                                           tile_roles=roles)  # the all-rows head
    assert one >= eng.whole_step_smem_est
    # squeezed just below the untiled decode price: every shape tiles
    monkeypatch.setattr(tk, "WHOLE_STEP_SMEM_BUDGET", eng.whole_step_smem_est - 1)
    tiled = _engine(weights, fused_decode=("whole_step",))
    assert tiled.whole_step_tiles > 1
    fallbacks = tiled.whole_step_fallbacks  # the mixed step's, priced at construction
    # a draft width (G C <= 8 rows a KV head: the split walk's small price)
    assert tiled.whole_step_spec_gate([3]) and tiled.whole_step_spec_tiles[3] > 1
    assert tiled.whole_step_fallbacks == fallbacks
    assert not _engine(weights).whole_step_spec_on  # no walk, no fold


def test_spec_fold_gate_refusal_is_counted(weights, monkeypatch, caplog):
    """A chunk width no legal tiling fits (or wider than the kernel's
    commit) turns the fold off for that engine, once, counted and logged;
    its SpecInfer steps then run on the per-layer path."""
    eng = _engine(weights, fused_decode=("whole_step",))
    assert not eng.whole_step_spec_gate([tk._FUSED_MAX_CHUNK + 1])
    assert eng.whole_step_fallbacks == 1 and not eng.whole_step_spec_on
    assert eng.whole_step_on  # decode and mixed steps keep the walk
    assert not eng.whole_step_spec_gate([2])
    assert eng.whole_step_fallbacks == 1
    eng = _engine(weights, fused_decode=("whole_step",))
    monkeypatch.setattr(tk, "WHOLE_STEP_SMEM_BUDGET", 0)
    with caplog.at_level("WARNING"):
        assert not eng.whole_step_spec_gate([7])
    assert eng.whole_step_fallbacks == 1 and "SpecInfer" in caplog.text
    calls = []
    step = tl.serve_step_whole
    monkeypatch.setattr(tl, "serve_step_whole",
                        lambda *a, **k: calls.append(k) or step(*a, **k))
    eng.run_speculate(np.array([1, 2, 3, 4]), np.array([0, 0, 0, 0]),
                      np.array([True, True, False, False]), 2, 2)
    assert calls == []


# ---------------------------------------------------------------------------
# SpecInfer managers over whole-step engines

PROMPTS = [[3, 17, 91, 42, 7], list(range(20, 31)), [5, 6]]


@pytest.fixture(scope="module")
def draft():
    return _weights(7, 1)


def _jax_engine(w, **kw):
    return JaxInferenceEngine(jl, w[0], w[1], JaxServingConfig(cache_dtype=jnp.float32,
                                                               kernels="xla",
                                                               **dict(SERVE, **kw)))


KINDS = {
    "early_exit": dict(beam_width=2, beam_depth=3, draft="early_exit", draft_layers=1),
    "ssm": dict(beam_width=2, beam_depth=3),
}


@pytest.mark.parametrize("kv_quant", [None, "int8"])
@pytest.mark.parametrize("kind", list(KINDS))
def test_whole_step_spec_manager_tokens(weights, draft, kind, kv_quant, monkeypatch):
    """A SpecInferManager whose target (and SSM) run fused_decode=
    ("whole_step",) serves the tokens of the port's unfused manager and
    of JAX's unfused SpecInferManager (JAX's
    test_megakernel_fold_bitwise_unfused), with the same acceptance
    counters; every draft and verify step goes through the walk (the
    spy), and no tree step through the per-layer step."""
    spec = KINDS[kind]
    ssms = [draft] if kind == "ssm" else []
    kw = dict(kv_quant=kv_quant)
    jm = js.SpecInferManager(_jax_engine(weights, **kw), [_jax_engine(s, **kw) for s in ssms],
                             js.SpecConfig(**spec))
    want = [r.output_tokens for r in jm.generate(PROMPTS, max_new_tokens=8)]
    um = ts.SpecInferManager(_engine(weights, **kw), [_engine(s, **kw) for s in ssms],
                             ts.SpecConfig(**spec))
    unfused = um.generate(PROMPTS, max_new_tokens=8)
    assert [r.output_tokens for r in unfused] == want

    whole = dict(kw, fused_decode=("whole_step",))
    folds, trees = [], []
    step_whole, step_paged = tl.serve_step_whole, tl.serve_step_paged
    monkeypatch.setattr(tl, "serve_step_whole",
                        lambda *a, **k: folds.append(k.get("all_logits"))
                        or step_whole(*a, **k))
    monkeypatch.setattr(tl, "serve_step_paged",
                        lambda *a, **k: trees.append(a[5] is not None) or step_paged(*a, **k))
    fm = ts.SpecInferManager(_engine(weights, **whole), [_engine(s, **whole) for s in ssms],
                             ts.SpecConfig(**spec))
    assert all(e.whole_step_spec_on for e in fm._engines())
    got = fm.generate(PROMPTS, max_new_tokens=8)
    assert [r.output_tokens for r in got] == want
    assert ([(r.profile.accepted_tokens, r.profile.speculated_tokens, r.profile.spec_rounds)
             for r in got]
            == [(r.profile.accepted_tokens, r.profile.speculated_tokens, r.profile.spec_rounds)
                for r in unfused])
    rounds = fm.stats.spec_rounds
    assert rounds > 0 and folds.count(True) >= 4 * fm.stats.spec_rounds // len(PROMPTS)
    assert not any(trees)  # no tree step left the walk
    assert all(e.whole_step_fallbacks == 0 for e in fm._engines())
