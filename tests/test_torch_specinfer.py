"""SpecInfer on the port (flexflow_tpu_torch/serve/specinfer.py) against
the JAX package on the same weights, f32 on the CPU: the host-side tree
logic exactly, the K/V line moves bitwise, the layer-sliced step and the
device tree expansion to 1e-5, and whole managers token for token (the
port's incremental decoding and JAX's SpecInferManager) with JAX's
acceptance counters."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flexflow_tpu.models import llama as jl
from flexflow_tpu.serve import InferenceEngine as JaxInferenceEngine
from flexflow_tpu.serve import ServingConfig as JaxServingConfig
from flexflow_tpu.serve import specinfer as js
from flexflow_tpu.serve.batch_config import BatchConfig as JaxBatchConfig
from flexflow_tpu.serve.kv_quant import quant_commit_lines as jax_quant_commit_lines
from flexflow_tpu_torch.models import llama as tl
from flexflow_tpu_torch.serve import LLM, InferenceEngine, RequestManager, ServingConfig
from flexflow_tpu_torch.serve import specinfer as ts
from flexflow_tpu_torch.serve.batch_config import BatchConfig

torch.set_num_threads(1)

# f32 logits and log-probabilities of two implementations of one step:
# summation order only
ATOL = 1e-5
SERVE = dict(max_requests_per_batch=4, max_sequence_length=96, prefill_chunk=8,
             max_spec_tree_tokens=16)
PROMPTS = [[3, 17, 91, 42, 7], list(range(20, 31)), [5, 6]]


def _jax_params(seed, **kw):
    cfg_j = jl.LLaMAConfig.tiny(dtype=jnp.float32, **kw)
    params_j = jl.init_params(jax.random.PRNGKey(seed), cfg_j)
    cfg_t = tl.LLaMAConfig.tiny(dtype=torch.float32, **kw)
    params_t = tl.params_from_numpy(jax.tree.map(np.asarray, params_j), device="cpu")
    return cfg_j, params_j, cfg_t, params_t


@pytest.fixture(scope="module")
def target():
    return _jax_params(0)


@pytest.fixture(scope="module")
def draft():
    # a different 1-layer model: partial acceptance (tests/test_specinfer.py)
    return _jax_params(7, num_hidden_layers=1)


@pytest.fixture(scope="module")
def draft2():
    return _jax_params(11, num_hidden_layers=1)


def _layouts(layout):
    return {"dense": {}, "paged": dict(kv_layout="paged", page_size=16),
            "int8": dict(kv_layout="paged", page_size=16, kv_quant="int8"),
            "int4": dict(kv_layout="paged", page_size=16, kv_quant="int4")}[layout]


def _port_engine(w, kernels="cuda", **kw):
    return InferenceEngine(tl, w[2], w[3], ServingConfig(cache_dtype=torch.float32,
                                                         kernels=kernels, **SERVE, **kw),
                           device="cpu")


_JAX_ENGINES = {}


def _jax_engine(w, **kw):
    """A JAX engine of these weights and serving fields, reset: engines are
    kept across tests so that their compiled step programs are reused."""
    key = (id(w), repr(sorted(kw.items())))
    eng = _JAX_ENGINES.get(key)
    if eng is None:
        eng = _JAX_ENGINES[key] = JaxInferenceEngine(
            jl, w[0], w[1], JaxServingConfig(cache_dtype=jnp.float32, kernels="xla", **SERVE,
                                             **kw))
    else:
        eng.reset()
    return eng


# ---------------------------------------------------------------------------
# host-side tree logic: equal to JAX's exactly


def _random_tree(mod, rng, n=12):
    t = mod.TokenTree(int(rng.integers(0, 50)))
    for _ in range(n):
        parent = int(rng.integers(0, len(t)))
        t.add(int(rng.integers(0, 6)), parent, float(rng.normal()))
    return t


def _tree_state(t):
    return (t.tokens, t.parents, t.depths, t.logprobs,
            [t.children(i) for i in range(len(t))], t.ancestor_matrix().tolist())


@pytest.mark.parametrize("seed", range(4))
def test_token_tree_and_merge_match_jax(seed):
    trees = []
    for mod in (ts, js):
        rng = np.random.default_rng(seed)
        a, b = _random_tree(mod, rng), _random_tree(mod, rng)
        b.tokens[0] = a.tokens[0]
        raw = mod.TokenTree(a.tokens[0])
        for d in range(3):  # the device layout: duplicates kept
            for w in range(2):
                raw.append_raw(int(rng.integers(0, 3)), 0 if d == 0 else 1 + (d - 1) * 2 + w % 2,
                               d + 1, float(rng.normal()))
        merged = mod.merge_trees([a, b, raw])
        greedy = rng.integers(0, 6, size=len(merged))
        path, bonus = merged.accept_greedy(greedy)
        trees.append([_tree_state(t) for t in (a, b, raw, merged)]
                     + [path, bonus, merged.used_width(path)])
    assert trees[0] == trees[1]


@pytest.mark.parametrize("shape", [(1, 1), (1, 8), (2, 3), (3, 8), (4, 5), (8, 1)])
def test_default_buckets_match_jax(shape):
    assert ts.default_buckets(*shape) == js.default_buckets(*shape)


SPEC_CONFIGS = [
    {}, dict(beam_width=0), dict(beam_depth=0), dict(draft="bogus"),
    dict(draft="early_exit"), dict(draft="early_exit", draft_layers=1),
    dict(ema_alpha=0.0), dict(ema_alpha=1.5), dict(shrink_threshold=0.9),
    dict(width_threshold=1.5), dict(verify_skip=True), dict(adaptive=True, verify_skip=True),
    dict(skip_threshold=1.0), dict(adaptive=True, skip_threshold=0.35),
    dict(reprobe_every=0), dict(buckets=()), dict(buckets=((1, 1), (1, 1), (2, 4))),
    dict(buckets=((3, 1), (2, 4))), dict(buckets=((1, 1), (1, 2))),
    dict(buckets=((2, 2), (1, 4), (2, 4))), dict(buckets=((1, 2), (2, 4)), adaptive=True),
    dict(adaptive=True), dict(beam_width=3, beam_depth=8, adaptive=True),
]


@pytest.mark.parametrize("kw", SPEC_CONFIGS, ids=lambda kw: repr(kw)[:60])
def test_spec_config_validation_matches_jax(kw):
    out = []
    for mod in (ts, js):
        try:
            c = mod.SpecConfig(**kw)
            out.append(("ok", c.bucket_ladder, c.max_tree_tokens))
        except ValueError as e:
            out.append(("ValueError", str(e)))
    assert out[0] == out[1]


@pytest.mark.parametrize("kw", [dict(beam_width=3, beam_depth=8, adaptive=True),
                                dict(beam_width=2, beam_depth=4, adaptive=True,
                                     verify_skip=True, reprobe_every=3),
                                dict(beam_width=4, beam_depth=4, adaptive=True,
                                     width_threshold=0.6)])
def test_tree_controller_trajectories_match_jax(kw):
    rng = np.random.default_rng(1)
    seq = [(int(rng.integers(0, 9)) if rng.random() < 0.4 else 0, bool(rng.random() < 0.3))
           for _ in range(200)]
    runs = []
    for mod in (ts, js):
        ctrl = mod.TreeController(mod.SpecConfig(**kw))
        traj = []
        for acc, wide in seq:
            action = ctrl.next_action()
            moved = ctrl.observe(min(acc, ctrl.bucket[1]), wide) if action != "skip" else None
            traj.append((action, moved, ctrl.bucket, ctrl.ema, ctrl.width_ema, ctrl.resizes,
                         ctrl.skipped_rounds, ctrl.reprobes))
        runs.append(traj)
    assert runs[0] == runs[1]
    assert len({t[2] for t in runs[0]}) > 1  # the ladder was walked


# ---------------------------------------------------------------------------
# K/V line moves: bitwise JAX's commit_kv*/reorder_slots* on the same arrays

L, R, S1, KV, DK, PS, NP, P = 2, 4, 40, 2, 8, 8, 5, 17


def _line_moves(rng, K=4, scratch=S1 - 1):
    """(R, K) src/dst: accepted tree lines moved down onto the committed
    suffix (overlapping ranges) and scratch-to-scratch padding."""
    src = np.full((R, K), scratch, np.int32)
    dst = np.full((R, K), scratch, np.int32)
    for r in range(R - 1):
        prefix = int(rng.integers(0, 20))
        n = int(rng.integers(1, K + 1))
        nodes = np.sort(rng.choice(np.arange(1, 9), size=n - 1, replace=False))
        src[r, :n] = prefix + np.concatenate([[0], nodes])
        dst[r, :n] = prefix + np.arange(n)
    return src, dst


def _to_torch(tree):
    return {k: tl._array_to_tensor(np.asarray(v).copy()) for k, v in tree.items()}


def _dense_cache(rng):
    return {n: rng.normal(size=(L, R, S1, KV, DK)).astype(np.float32) for n in ("k", "v")}


def _paged_cache(rng, quant):
    shape = (L, P + 1, PS, KV, DK)
    if quant is None:
        return {n: rng.normal(size=shape).astype(np.float32) for n in ("k", "v")}
    cache = {}
    for n in ("k", "v"):
        if quant == "int8":
            cache[n] = rng.integers(-127, 128, size=shape).astype(np.int8)
        else:
            cache[n] = rng.integers(0, 256, size=shape[:-1] + (DK // 2,)).astype(np.uint8)
        cache[n + "_scale"] = rng.uniform(0.01, 0.1, size=(L, P + 1, KV)).astype(np.float32)
    return cache


def _page_table(rng):
    """Every slot holds NP pages of a shuffled pool but slot 3, which holds
    two (the rest point at the scratch page P)."""
    perm = rng.permutation(P)
    table = np.full((R, NP), P, np.int32)
    table[:2] = perm[: 2 * NP].reshape(2, NP)
    table[2, :NP - 1] = perm[2 * NP: 3 * NP - 1]
    table[3, :2] = perm[3 * NP - 1: 3 * NP + 1]
    return table


def _assert_same(got, want, skip_page=None):
    for name in want:
        a, b = got[name].numpy(), np.asarray(want[name])
        if skip_page is not None:
            a, b = np.delete(a, skip_page, axis=1), np.delete(b, skip_page, axis=1)
        np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.mark.parametrize("seed", range(3))
def test_dense_commit_and_reorder_bitwise_jax(seed):
    rng = np.random.default_rng(seed)
    cache = _dense_cache(rng)
    src, dst = _line_moves(rng)
    want = jl.commit_kv({k: jnp.asarray(v) for k, v in cache.items()}, jnp.asarray(src),
                        jnp.asarray(dst))
    got = tl.commit_kv(_to_torch(cache), torch.from_numpy(src), torch.from_numpy(dst))
    _assert_same(got, want)
    slots = rng.integers(0, R, size=R).astype(np.int32)
    want = jl.reorder_slots({k: jnp.asarray(v) for k, v in cache.items()}, jnp.asarray(slots))
    got = tl.reorder_slots(_to_torch(cache), torch.from_numpy(slots))
    _assert_same(got, want)


@pytest.mark.parametrize("quant", [None, "int8", "int4"])
@pytest.mark.parametrize("kernels", ["torch", "cuda"])
def test_paged_commit_bitwise_jax(quant, kernels):
    """Every pool type, both kernel routes (on CPU tensors "cuda" takes the
    plain version): the f32 move and the quantized dequantize-and-commit
    (``quant_commit_lines``) are JAX's bit for bit, scratch page
    included."""
    rng = np.random.default_rng(3)
    cache = _paged_cache(rng, quant)
    table = _page_table(rng)
    src, dst = _line_moves(rng, scratch=NP * PS - 1)
    jc = {k: jnp.asarray(v) for k, v in cache.items()}
    want = jl.commit_kv_paged(jc, jnp.asarray(table), jnp.asarray(src), jnp.asarray(dst),
                              kv_quant=quant)
    got = tl.commit_kv_paged(_to_torch(cache), torch.from_numpy(table), torch.from_numpy(src),
                             torch.from_numpy(dst), kv_quant=quant, kernels=kernels)
    _assert_same(got, want)


@pytest.mark.parametrize("quant", ["int8", "int4"])
def test_quant_commit_lines_bitwise_jax(quant):
    """The layer-vectorized JAX function against the port's
    layer-at-a-time loop, with row 0's destination page one of row 1's
    source pages: every source line of a layer is read before its first
    write."""
    from flexflow_tpu_torch.serve.kv_quant import quant_commit_lines, resolve_spec

    rng = np.random.default_rng(5)
    cache = _paged_cache(rng, quant)
    s_phys = np.array([[0, 0, 1], [2, 2, 3]], np.int32)
    s_off = np.array([[5, 7, 2], [1, 6, 3]], np.int32)
    d_phys = np.array([[2, 2, 2], [3, 3, 3]], np.int32)
    d_off = np.array([[0, 1, 2], [4, 5, 6]], np.int32)
    qmax = resolve_spec(quant).qmax
    want = {}
    for n in ("k", "v"):
        want[n], want[n + "_scale"] = jax_quant_commit_lines(
            jnp.asarray(cache[n]), jnp.asarray(cache[n + "_scale"]), jnp.asarray(s_phys),
            jnp.asarray(s_off), jnp.asarray(d_phys), jnp.asarray(d_off), qmax)
    got = _to_torch(cache)
    quant_commit_lines(got["k"], got["v"], got["k_scale"], got["v_scale"],
                       *(torch.from_numpy(a) for a in (s_phys, s_off, d_phys, d_off)), qmax)
    _assert_same(got, want)


@pytest.mark.parametrize("quant", [None, "int8", "int4"])
def test_paged_reorder_bitwise_jax(quant):
    """Page content follows the slot gather; page ownership stays put. The
    scratch page, which several slots' unallocated entries write at once,
    is left out."""
    rng = np.random.default_rng(4)
    cache = _paged_cache(rng, quant)
    table = _page_table(rng)
    slots = np.array([1, 1, 0, 3], np.int32)
    jc = {k: jnp.asarray(v) for k, v in cache.items()}
    want = jl.reorder_slots_paged(jc, jnp.asarray(table), jnp.asarray(slots))
    got = tl.reorder_slots_paged(_to_torch(cache), torch.from_numpy(table),
                                 torch.from_numpy(slots))
    _assert_same(got, want, skip_page=P)


# ---------------------------------------------------------------------------
# the layer-sliced step and the device tree expansion, against JAX


def _step_inputs(rng, C=3):
    tokens = rng.integers(0, 256, size=(R, C)).astype(np.int32)
    positions = np.tile(np.arange(C, dtype=np.int32), (R, 1)) + 4
    logits_idx = np.full((R,), C - 1, np.int32)
    return tokens, positions, logits_idx


@pytest.mark.parametrize("layout", ["dense", "paged", "int8"])
@pytest.mark.parametrize("num_layers", [1, None])
def test_serve_step_num_layers_matches_jax(target, layout, num_layers):
    """Only the first ``num_layers`` blocks run and commit K/V (the deeper
    layers' cache untouched), then the full head: logits to 1e-5."""
    cfg_j, params_j, cfg_t, params_t = target
    rng = np.random.default_rng(0)
    tokens, positions, logits_idx = _step_inputs(rng)
    quant = {"dense": None, "paged": None, "int8": "int8"}[layout]
    if layout == "dense":
        cj = jl.init_kv_cache(cfg_j, R, S1 - 1, jnp.float32)
        ct = tl.init_kv_cache(cfg_t, R, S1 - 1, torch.float32)
        lj, _ = jl.serve_step(params_j, cj, jnp.asarray(tokens), jnp.asarray(positions),
                              jnp.asarray(logits_idx), None, cfg=cfg_j, num_layers=num_layers)
        lt, ct = tl.serve_step(params_t, ct, *(torch.from_numpy(a) for a in
                                               (tokens, positions, logits_idx)), None,
                               cfg=cfg_t, num_layers=num_layers)
    else:
        table = _page_table(rng)
        cj = jl.init_paged_kv_cache(cfg_j, P, PS, jnp.float32, quant)
        ct = tl.init_paged_kv_cache(cfg_t, P, PS, torch.float32, quant)
        kw = dict(cache_len=NP * PS - 1, kv_quant=quant, num_layers=num_layers)
        lj, _ = jl.serve_step_paged(params_j, cj, jnp.asarray(tokens), jnp.asarray(positions),
                                    jnp.asarray(logits_idx), None, None, jnp.asarray(table),
                                    cfg=cfg_j, **kw)
        lt, ct = tl.serve_step_paged(params_t, ct, *(torch.from_numpy(a) for a in
                                                     (tokens, positions, logits_idx)),
                                     None, None, torch.from_numpy(table), cfg=cfg_t, **kw)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=ATOL, rtol=0)
    for name, buf in ct.items():
        written = [bool(buf[l].any()) for l in range(cfg_t.num_hidden_layers)]
        assert written == [num_layers is None or l < num_layers
                           for l in range(cfg_t.num_hidden_layers)], name


def _prefill_both(jeng, peng, prompts):
    """The same prompts prefilled into slots 0.. of both engines (pages
    granted first on paged ones)."""
    sc = peng.serving
    for k in range(0, max(len(p) for p in prompts), sc.prefill_chunk):
        bcs = [JaxBatchConfig.empty(peng.num_slots, sc.prefill_chunk, peng.scratch_pos),
               BatchConfig.empty(peng.num_slots, sc.prefill_chunk, peng.scratch_pos)]
        for s, p in enumerate(prompts):
            toks = p[k:k + sc.prefill_chunk]
            if not toks:
                continue
            for bc in bcs:
                bc.tokens[s, :len(toks)] = toks
                bc.positions[s, :len(toks)] = np.arange(k, k + len(toks))
                bc.logits_idx[s] = len(toks) - 1
                bc.active[s] = True
        for eng, bc in zip((jeng, peng), bcs):
            if eng.paged:
                for s, p in enumerate(prompts):
                    assert eng.pager.ensure(s, len(p) + 20)
            eng.run(bc)


@pytest.mark.parametrize("layout", ["dense", "paged", "int8"])
@pytest.mark.parametrize("W,D,num_layers", [(2, 3, None), (1, 4, None), (3, 2, 1)])
def test_run_speculate_matches_jax(target, layout, W, D, num_layers):
    """Tokens and parents equal to JAX's speculate scan, log-probabilities
    to 1e-5, on a batch with an idle slot; the cache's tree lines too."""
    kw = _layouts(layout)
    jeng, peng = _jax_engine(target, **kw), _port_engine(target, **kw)
    prompts = PROMPTS
    _prefill_both(jeng, peng, prompts)
    root = np.array([p[-1] for p in prompts] + [0], np.int32)
    prefix = np.array([len(p) for p in prompts] + [peng.scratch_pos], np.int32)
    active = np.array([True, True, True, False])
    want = jax.device_get(jeng.run_speculate(root, prefix, active, W, D, num_layers=num_layers))
    got = peng.run_speculate(root, prefix, active, W, D, num_layers=num_layers)
    live = slice(0, 3)
    for a, b in zip(got[:2], want[:2]):
        np.testing.assert_array_equal(a.numpy()[:, live], np.asarray(b)[:, live])
    np.testing.assert_allclose(got[2].numpy()[:, live], np.asarray(want[2])[:, live],
                               atol=ATOL, rtol=0)
    if layout != "int8":  # codes may round differently within 1e-5
        for name in ("k", "v"):
            jc, pc = np.asarray(jeng.cache[name]), peng.cache[name].numpy()
            if layout == "dense":
                for s, p in enumerate(prompts):
                    lines = slice(len(p), len(p) + 1 + W * D)
                    np.testing.assert_allclose(pc[:, s, lines], jc[:, s, lines], atol=ATOL)
            else:
                np.testing.assert_allclose(pc[:, :-1], jc[:, :-1], atol=ATOL)


@pytest.mark.parametrize("rung", [(1, 1), (1, 2), (1, 4)])
@pytest.mark.parametrize("num_layers", [None, 1])
def test_w1_draft_steps_attend_a_prefix(target, rung, num_layers, monkeypatch):
    """Every C = 1 draft step of a W = 1 rung (the default ladder's (1,1),
    (1,2), (1,4)) hands the dense step a mask that is a prefix of the
    cache, [0, n), with the new node at line n - 1: the dense decode
    kernel, which attends ``seq_len`` lines from 0
    (``llama.decode_seq_lens``), reads the mask's lines and no other."""
    eng = _port_engine(target)
    _prefill_both(_jax_engine(target), eng, PROMPTS)
    seen = []
    step = tl.serve_step

    def spy(params, cache, tokens, positions, logits_idx, mask, cache_positions=None, **kw):
        if tokens.shape[1] == 1:
            seen.append((mask.clone(), cache_positions.clone()))
        return step(params, cache, tokens, positions, logits_idx, mask, cache_positions, **kw)

    monkeypatch.setattr(tl, "serve_step", spy)
    W, D = rung
    root = np.array([p[-1] for p in PROMPTS] + [0], np.int32)
    prefix = np.array([len(p) for p in PROMPTS] + [eng.scratch_pos], np.int32)
    eng.run_speculate(root, prefix, np.array([True, True, True, False]), W, D,
                      num_layers=num_layers)
    assert len(seen) == D
    for d, (mask, cpos) in enumerate(seen):
        for s, p in enumerate(PROMPTS):
            n = int(mask[s, 0].sum())
            assert n == len(p) + d + 1
            assert bool(mask[s, 0, :n].all()) and not bool(mask[s, 0, n:].any())
            assert int(cpos[s, 0]) == n - 1
        # the idle slot: nothing attended, its line the scratch line
        assert not bool(mask[3].any()) and int(cpos[3, 0]) == eng.scratch_pos


# ---------------------------------------------------------------------------
# whole managers against the port's incremental decoding and JAX's manager

DRAFTS = {
    "ssm": lambda d, d2: ([d], dict(beam_width=2, beam_depth=3)),
    "two_ssms": lambda d, d2: ([d, d2], dict(beam_width=2, beam_depth=2)),
    "early_exit": lambda d, d2: ([], dict(beam_width=2, beam_depth=3, draft="early_exit",
                                          draft_layers=1)),
    "adaptive_skip": lambda d, d2: ([d], dict(beam_width=2, beam_depth=4, adaptive=True,
                                              verify_skip=True, reprobe_every=2)),
}


def _spec_runs(target, draft, draft2, layout, kind, new=8, prompts=PROMPTS, **extra):
    ssms, spec = DRAFTS[kind](draft, draft2)
    kw = dict(_layouts(layout), **extra)
    out = {}
    jm = js.SpecInferManager(_jax_engine(target, **kw), [_jax_engine(s, **kw) for s in ssms],
                             js.SpecConfig(**spec))
    jr = jm.generate(prompts, max_new_tokens=new)
    out["jax"] = ([r.output_tokens for r in jr],
                  [(r.profile.accepted_tokens, r.profile.speculated_tokens,
                    r.profile.spec_rounds) for r in jr])
    pm = ts.SpecInferManager(_port_engine(target, **kw), [_port_engine(s, **kw) for s in ssms],
                             ts.SpecConfig(**spec))
    pr = pm.generate(prompts, max_new_tokens=new)
    out["port"] = ([r.output_tokens for r in pr],
                   [(r.profile.accepted_tokens, r.profile.speculated_tokens,
                     r.profile.spec_rounds) for r in pr])
    inc = RequestManager(_port_engine(target, **kw))
    out["incremental"] = [r.output_tokens for r in inc.generate(prompts, max_new_tokens=new)]
    if kw.get("kv_quant"):
        from flexflow_tpu.serve import RequestManager as JaxRequestManager

        jinc = JaxRequestManager(_jax_engine(target, **kw))
        out["jax_incremental"] = [r.output_tokens
                                  for r in jinc.generate(prompts, max_new_tokens=new)]
    return out, pm, jm


def _holds_incremental(out):
    """The spec run's tokens equal the incremental run's. On a quantized
    pool a tree's slack lines raise its pages' amax scales, which
    requantizes the committed codes there, so the cache differs from the
    incremental run's and a token may part: there the port must part as
    JAX's SpecInferManager parts from JAX's incremental decoding (the
    tokens themselves are held equal to JAX's by the caller)."""
    if out["port"][0] == out["incremental"]:
        return True
    return ("jax_incremental" in out and out["jax_incremental"] == out["incremental"]
            and out["jax"][0] != out["jax_incremental"])


@pytest.mark.parametrize("kind", list(DRAFTS))
@pytest.mark.parametrize("layout", ["dense", "paged", "int8"])
def test_spec_manager_matches_incremental_and_jax(target, draft, draft2, layout, kind):
    out, pm, jm = _spec_runs(target, draft, draft2, layout, kind)
    assert out["port"][0] == out["jax"][0]
    if layout == "int8":
        assert _holds_incremental(out)
    else:
        assert out["port"][0] == out["incremental"]
    assert out["port"][1] == out["jax"][1]  # accepted, drafted, rounds per request
    for name in ("spec_rounds", "spec_drafted", "spec_accepted", "spec_resizes",
                 "verify_skipped_rounds", "spec_reprobes"):
        assert getattr(pm.stats, name) == getattr(jm.stats, name), name
    assert pm.stats.spec_rounds > 0
    if kind == "adaptive_skip":
        assert pm.stats.verify_skipped_rounds > 0 and pm.stats.spec_resizes > 0
    assert all(s is None for s in pm.slots)


@pytest.mark.slow  # int4 pools and preemption churn: the heavy cases
@pytest.mark.parametrize("kind", ["ssm", "adaptive_skip"])
@pytest.mark.parametrize("layout,extra", [("int4", {}),
                                          ("paged", dict(max_cached_tokens=48)),
                                          ("int8", dict(max_cached_tokens=48))])
def test_spec_manager_heavy_cases_match_jax(target, draft, draft2, layout, extra, kind):
    # four requests of 27-50 lines: 16 pages of 16 at their ends, against a
    # pool of 8 under the 48-token budget (one slot's worst case)
    prompts = PROMPTS + [list(range(100, 125))]
    prompts[0] = list(range(1, 30))
    out, pm, jm = _spec_runs(target, draft, draft2, layout, kind, new=20, prompts=prompts,
                             **extra)
    assert out["port"] == out["jax"]
    assert pm.stats.preemptions == jm.stats.preemptions
    # (the int8 pool buys four times the f32 pages of the same budget)
    assert (pm.stats.preemptions > 0) == (layout == "paged")
    assert _holds_incremental(out)


def test_spec_sync_scheduler_matches_incremental(target, draft):
    """continuous_batching=False: prefill runs the blocking sync batch
    through every engine (``_run_batch``)."""
    out, pm, _ = _spec_runs(target, draft, None, "dense", "ssm",
                            continuous_batching=False)
    assert out["port"][0] == out["incremental"] == out["jax"][0]
    assert pm.stats.sync_steps > 0 and pm.stats.mixed_steps == 0


def test_mirror_takes_no_draw_from_the_generator(target, draft):
    """The draft mirrors of the prefill phase's pipelined steps run no
    head: the manager's generator, from which the LLM's own head draws,
    is where it was before each mirrored step."""
    pm = ts.SpecInferManager(_port_engine(target), [_port_engine(draft)], ts.SpecConfig(2, 3))
    calls = []
    run_mixed = pm.ssm.run_mixed

    def spy(*a, **kw):
        before = pm._generator.get_state().clone()
        out = run_mixed(*a, **kw)
        calls.append((kw.get("sample"), out, torch.equal(pm._generator.get_state(), before)))
        return out

    pm.ssm.run_mixed = spy
    pm.generate(PROMPTS, max_new_tokens=6)
    assert calls and all(c == (False, None, True) for c in calls)


def test_llm_compile_with_ssms_and_early_exit(target, draft):
    m = LLM(tl, target[2], target[3], device="cpu")
    d = LLM(tl, draft[2], draft[3], device="cpu")
    serving = ServingConfig(cache_dtype=torch.float32, **SERVE)
    m.compile(serving, ssms=[d], spec=ts.SpecConfig(2, 3))
    assert isinstance(m.rm, ts.SpecInferManager) and d.engine is m.rm.ssm
    got = [r.output_tokens for r in m.generate(PROMPTS, max_new_tokens=8)]
    m.compile(serving, spec=ts.SpecConfig(2, 3, draft="early_exit", draft_layers=1))
    assert isinstance(m.rm, ts.SpecInferManager) and not m.rm.ssms
    assert [r.output_tokens for r in m.generate(PROMPTS, max_new_tokens=8)] == got
    m.compile(serving)
    assert type(m.rm) is RequestManager
    assert [r.output_tokens for r in m.generate(PROMPTS, max_new_tokens=8)] == got


def test_spec_refusals(target, draft):
    """A field of a later slice (context sharding) raises; sampling is
    refused as in JAX. (Prefix caching composes: the tests below;
    whole-step engines are served: tests/test_torch_whole_spec.py.)"""
    m = LLM(tl, target[2], target[3], device="cpu")
    with pytest.raises(NotImplementedError, match="long-context"):
        m.compile(ServingConfig(cache_dtype=torch.float32, kv_shard="context", **SERVE),
                  spec=ts.SpecConfig(draft="early_exit", draft_layers=1))
    pm = ts.SpecInferManager(_port_engine(target), [_port_engine(draft)])
    from flexflow_tpu_torch.serve import GenerationConfig

    with pytest.raises(ValueError, match="greedy-only"):
        pm.register_request([1, 2], GenerationConfig(do_sample=True))
    with pytest.raises(ValueError, match="early_exit"):
        ts.SpecInferManager(_port_engine(target), [_port_engine(draft)],
                            ts.SpecConfig(draft="early_exit", draft_layers=1))
    with pytest.raises(ValueError, match="draft_layers"):
        ts.SpecInferManager(_port_engine(target), None,
                            ts.SpecConfig(draft="early_exit", draft_layers=2))


def test_spec_stats_report(target, draft):
    out, pm, _ = _spec_runs(target, draft, None, "dense", "ssm", new=6)
    snap = pm.stats.snapshot()
    assert snap["spec_accept_rate"] == round(pm.stats.spec_accepted / pm.stats.spec_drafted, 4)
    assert f"spec={snap['spec_accepted']}/{snap['spec_drafted']}" in pm.stats.report()
    assert pm.draft_flops_per_token == js.SpecInferManager(
        _jax_engine(target), [_jax_engine(draft)]).draft_flops_per_token


# ---------------------------------------------------------------------------
# the composition with prefix caching (tests/test_adaptive_spec.py's
# TestPrefixCacheComposition, on the port)


@pytest.fixture(scope="module")
def draft_2layer():
    return _jax_params(7, num_hidden_layers=2)


PREFIX = dict(kv_layout="paged", page_size=8, prefix_caching=True)
PREFIX_PROMPT = [(i * 7 + 3) % 256 for i in range(20)]


def _prefix_manager(target, ssms, spec, **kw):
    return ts.SpecInferManager(_port_engine(target, **PREFIX, **kw),
                               [_port_engine(s, **PREFIX, **kw) for s in ssms], spec)


def _audit_pools(mgr):
    mgr.drain()
    for eng, pc in zip(mgr._engines(), mgr._prefix_caches()):
        eng.pager.check_no_leaks(external=pc.page_refs())


@pytest.mark.parametrize("fused", [(), ("whole_step",)])
@pytest.mark.parametrize("kind", ["ssm", "early_exit"])
def test_prefix_cold_vs_warm_bitwise_and_incremental(target, draft_2layer, kind, fused):
    """A hit jumps the target and every SSM past the cached prefix: warm
    tokens equal the cold run's, which equal incremental decoding, with a
    2-layer SSM (its pool has a tree of its own) and with the early-exit
    draft (it shares the target's pool and tree), on per-layer and on
    whole-step engines (the fold reads the spliced table)."""
    ssms = [draft_2layer] if kind == "ssm" else []
    spec = (ts.SpecConfig(2, 3, adaptive=True) if kind == "ssm"
            else ts.SpecConfig(2, 3, draft="early_exit", draft_layers=1))
    kw = dict(fused_decode=fused)
    ref = [r.output_tokens for r in RequestManager(_port_engine(
        target, kv_layout="paged", page_size=8, **kw)).generate([PREFIX_PROMPT],
                                                               max_new_tokens=10)]
    mgr = _prefix_manager(target, ssms, spec, **kw)
    assert len(mgr._prefix_caches()) == 1 + len(ssms)
    cold = mgr.generate([PREFIX_PROMPT], max_new_tokens=10)[0]
    warm = mgr.generate([PREFIX_PROMPT], max_new_tokens=10)[0]
    assert [cold.output_tokens] == ref and warm.output_tokens == cold.output_tokens
    assert warm.profile.cached_prefix_len == 19 and mgr.stats.prefix_hits == 1
    assert mgr.stats.spec_rounds > 0
    if fused:
        assert all(e.whole_step_spec_on for e in mgr._engines())
    _audit_pools(mgr)


@pytest.mark.parametrize("kind", ["ssm", "early_exit"])
def test_prefix_next_turn_reads_the_committed_lines(target, kind):
    """The next turn of a conversation resends the whole transcript: its
    hit covers lines that the finished request's last verify round
    committed, which must have moved to their positions before the
    completion published them (the SSM is the target's own weights, so
    its trees are accepted whole; 9 new tokens end the early-exit run in
    a round that commits lines). Warm tokens equal incremental decoding."""
    ssms = [target] if kind == "ssm" else []
    spec = (ts.SpecConfig(2, 3) if kind == "ssm"
            else ts.SpecConfig(2, 3, draft="early_exit", draft_layers=1))
    mgr = _prefix_manager(target, ssms, spec)
    first = mgr.generate([PREFIX_PROMPT], max_new_tokens=9)[0]
    assert first.profile.accepted_tokens > 0
    # the target's published lines hold the transcript's K/V: those of a
    # plain chunked prefill of it, up to summation order. (An SSM pool's
    # lines are drafts: a committed node of the tree's last depth was
    # never run through the SSM, here as in the JAX package.)
    valid = PREFIX_PROMPT + first.output_tokens[:-1]
    pages, n = mgr.prefix_cache.match(valid + [0])
    assert n == len(valid)
    ref = _port_engine(target, kernels="torch", kv_layout="paged", page_size=8)
    assert ref.pager.ensure(0, n)
    for off in range(0, n, 8):
        bc = BatchConfig.empty(ref.num_slots, 8, ref.scratch_pos)
        bc.tokens[0, :min(8, n - off)] = valid[off:off + 8]
        bc.positions[0, :min(8, n - off)] = np.arange(off, min(off + 8, n))
        bc.active[0] = True
        ref.run(bc)
    for k in ("k", "v"):
        got = mgr.engine.cache[k][:, pages].flatten(1, 2)[:, :n]
        want = ref.cache[k][:, ref.pager.table[0][:len(pages)]].flatten(1, 2)[:, :n]
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5)
    turn = PREFIX_PROMPT + first.output_tokens + [5, 9, 2]
    inc = RequestManager(_port_engine(target, kv_layout="paged", page_size=8))
    want = inc.generate([turn], max_new_tokens=10)[0].output_tokens
    got = mgr.generate([turn], max_new_tokens=10)[0]
    assert got.profile.cached_prefix_len == len(PREFIX_PROMPT) + len(first.output_tokens) - 1
    assert got.output_tokens == want
    _audit_pools(mgr)


def test_prefix_pool_mismatch_falls_back_cold(target, draft):
    """One pool's tree cleared behind the manager's back: the common match
    is 0, a cold admission, never a half-spliced prefix."""
    mgr = _prefix_manager(target, [draft], ts.SpecConfig(2, 3))
    ref = mgr.generate([PREFIX_PROMPT], max_new_tokens=10)[0].output_tokens
    mgr.ssm_prefix_caches[0].clear()
    warm = mgr.generate([PREFIX_PROMPT], max_new_tokens=10)[0]
    assert warm.output_tokens == ref and warm.profile.cached_prefix_len == 0
    _audit_pools(mgr)


def test_prefix_rollback_when_an_ssm_pool_cannot_materialize(target, draft):
    """Every pool matches 20 tokens, which end inside a page; the SSM pool
    has no page left for the tail's copy (its free list is held by
    other slots, and its only idle cached pages are the matched path
    itself): its attach comes back short and every pool rolls back to a
    cold admission, its references released. With the page back, the
    same prompt hits on every pool."""
    # 45 pages a pool: three slots' worst case
    mgr = _prefix_manager(target, [draft], ts.SpecConfig(2, 3), max_cached_tokens=360)
    seed = PREFIX_PROMPT[:20]
    mgr.generate([seed], max_new_tokens=5)  # publishes 24 lines: 3 full pages
    ssm = mgr.ssm
    assert mgr.ssm_prefix_caches[0].cached_pages == 3
    pps = ssm.pager.pages_per_slot
    for slot in (1, 2, 3):  # slot 0 stays empty for the admission
        assert ssm.pager.ensure(slot, min(ssm.pager.free_pages, pps) * 8)
    assert ssm.pager.free_pages == 0
    prompt = seed + [77]
    assert all(pc.match_len(prompt) == 20 for pc in mgr._prefix_caches())
    assert mgr._cache_attach(0, prompt) == 0
    for eng, pc in zip(mgr._engines(), mgr._prefix_caches()):
        assert eng.pager.slot_pages(0) == 0
        eng.pager.check_no_leaks(external=pc.page_refs())
    for slot in (1, 2, 3):
        ssm.pager.release(slot)
    ref = RequestManager(_port_engine(target, kv_layout="paged", page_size=8)).generate(
        [prompt], max_new_tokens=8)[0].output_tokens
    got = mgr.generate([prompt], max_new_tokens=8)[0]
    assert got.profile.cached_prefix_len == 20 and got.output_tokens == ref
    assert mgr.stats.prefix_cows >= 1
    _audit_pools(mgr)
