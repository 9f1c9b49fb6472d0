"""The port's automatic prefix caching (flexflow_tpu_torch/serve/
prefix_cache.py and the sharing half of serve/paging.py) against the JAX
package: the radix tree's unit behaviour on both packages, one random
sequence of allocator and tree operations driven on both in lockstep (a
hypothesis property test), and serving parity on a tiny LLaMA: the
port's warm (cache-hit) tokens equal JAX's cold ones on f32, int8 and
int4 pools, unfused, with ``rope_kv_write`` and with ``whole_step``, the
warm run leaves the published pages' bytes as the cold run wrote them,
and an engine-level hit's f32 logits are bitwise the port's cold prefill
and within LOGIT_ATOL of JAX's."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from flexflow_tpu.metrics import SchedulerStats as JaxSchedulerStats
from flexflow_tpu.models import llama as jl
from flexflow_tpu.serve import InferenceEngine as JaxInferenceEngine
from flexflow_tpu.serve import RequestManager as JaxRequestManager
from flexflow_tpu.serve import ServingConfig as JaxServingConfig
from flexflow_tpu.serve.batch_config import BatchConfig as JaxBatchConfig
from flexflow_tpu.serve.paging import PageAllocator as JaxPageAllocator
from flexflow_tpu.serve.prefix_cache import PrefixCache as JaxPrefixCache
from flexflow_tpu_torch.metrics import SchedulerStats
from flexflow_tpu_torch.models import llama as tl
from flexflow_tpu_torch.serve import (
    InferenceEngine,
    PageAllocator,
    PrefixCache,
    RequestManager,
    ServingConfig,
)
from flexflow_tpu_torch.serve.batch_config import BatchConfig, GenerationConfig

torch.set_num_threads(1)

# f32 logits of two implementations of the same step: summation order only
LOGIT_ATOL = 1e-4

PACKAGES = {"jax": (JaxPageAllocator, JaxPrefixCache),
            "port": (PageAllocator, PrefixCache)}


@pytest.fixture(scope="module")
def weights():
    cfg_j = jl.LLaMAConfig.tiny(dtype=jnp.float32)
    params_j = jl.init_params(jax.random.PRNGKey(0), cfg_j)
    cfg_t = tl.LLaMAConfig.tiny(dtype=torch.float32)
    params_t = tl.params_from_numpy(jax.tree.map(np.asarray, params_j), device="cpu")
    return cfg_j, params_j, cfg_t, params_t


SERVE = dict(max_requests_per_batch=4, max_sequence_length=64, prefill_chunk=8,
             max_spec_tree_tokens=8, kv_layout="paged", page_size=8)


def _jax_rm(weights, **kw):
    cfg_j, params_j = weights[:2]
    dt = jnp.float32 if kw.get("kv_quant") is None else jnp.bfloat16
    sc = JaxServingConfig(**dict(SERVE, cache_dtype=dt, kernels="xla", **kw))
    return JaxRequestManager(JaxInferenceEngine(jl, cfg_j, params_j, sc))


def _port_rm(weights, **kw):
    cfg_t, params_t = weights[2:]
    dt = torch.float32 if kw.get("kv_quant") is None else torch.bfloat16
    sc = ServingConfig(**dict(SERVE, cache_dtype=dt, kernels="torch", **kw))
    return RequestManager(InferenceEngine(tl, cfg_t, params_t, sc, device="cpu"))


def _prompts(V, n, shared_len=20, tail_len=5):
    shared = [(j * 7 + 3) % V for j in range(shared_len)]
    return [shared + [(i * 13 + j * 3 + 1) % V for j in range(tail_len)] for i in range(n)]


def _tokens(rm, prompts, new=6):
    return [o.output_tokens for o in rm.generate(prompts, max_new_tokens=new)]


def _audit(rm):
    rm.engine.pager.check_no_leaks(
        external=rm.prefix_cache.page_refs() if rm.prefix_cache else None)


# ---------------------------------------------------------------------------
# the radix tree on both packages (bare allocator, no engine)


@pytest.fixture(params=sorted(PACKAGES))
def pkg(request):
    return PACKAGES[request.param]


def _cache(pkg, num_pages=32, ps=4, slots=8):
    Pager, Cache = pkg
    pa = Pager(num_pages, 8, slots, ps)
    cache = Cache(pa, copy_page=None)
    pa.reclaim_cb = cache.reclaim
    return pa, cache


class TestRadixTree:
    def test_empty_tree_misses(self, pkg):
        _, cache = _cache(pkg)
        assert cache.match([1, 2, 3, 4, 5]) == ([], 0)
        assert cache.attach(0, [1, 2, 3, 4, 5]) == 0

    def test_insert_then_match_full_and_partial(self, pkg):
        pa, cache = _cache(pkg)
        toks = [1, 2, 3, 4, 5, 6, 7, 8, 9, 10]  # 2.5 pages of 4
        assert pa.ensure(0, len(toks))
        cache.insert(0, toks, len(toks))
        pa.release(0)
        pages, m = cache.match(toks)            # capped at len - 1
        assert m == 9 and len(pages) == 3
        pages, m = cache.match(toks + [11, 12])
        assert m == 10 and len(pages) == 3
        pages, m = cache.match([1, 2, 3, 4, 5, 6, 99])
        assert m == 6 and len(pages) == 2
        pages, m = cache.match([1, 9, 9, 9, 9])
        assert m == 1 and len(pages) == 1
        assert cache.match_len(toks + [11], limit=5) == 5
        pa.check_no_leaks(external=cache.page_refs())

    def test_attach_cow_on_partial_tail(self, pkg):
        pa, cache = _cache(pkg)
        toks = list(range(10, 20))
        assert pa.ensure(0, len(toks))
        cache.insert(0, toks, len(toks))
        tail_page = int(pa.table[0][2])
        pa.release(0)
        v0 = pa.version
        assert cache.attach(1, toks + [77]) == 10
        assert int(pa.table[1][2]) != tail_page  # private COW copy
        assert [int(p) for p in pa.table[1][:2]] == [int(n) for n in cache.match(toks)[0][:2]]
        assert pa.version > v0  # the splice ships a new table
        pa.check_no_leaks(external=cache.page_refs())

    def test_lru_eviction_spares_in_use_pages(self, pkg):
        pa, cache = _cache(pkg, num_pages=8, ps=4)
        a, b = [1] * 8, [2] * 8
        for slot, toks in ((0, a), (1, b)):
            assert pa.ensure(slot, len(toks))
            cache.insert(slot, toks, len(toks))
        pa.release(0)
        cache.match(b)
        assert cache.attach(2, b + [9]) == 8
        pa.release(1)
        assert cache.reclaim(8) == 2   # a's chain peels; b is spliced into slot 2
        assert cache.match(a)[1] == 0
        assert cache.match(b + [9])[1] == 8
        pa.check_no_leaks(external=cache.page_refs())

    def test_ensure_and_cow_reclaim_before_they_fail(self, pkg):
        pa, cache = _cache(pkg, num_pages=8, ps=4)
        assert pa.ensure(0, 16)
        cache.insert(0, list(range(16)), 16)
        pa.release(0)                  # 4 idle cached pages, 4 free
        assert pa.ensure(1, 32)        # needs all 8: reclaim evicts the tree
        assert cache.cached_pages == 0
        pa.release(1)
        assert pa.ensure(0, 28) and pa.ensure(1, 4)
        cache.insert(1, [5, 6, 7, 8], 4)
        pa.release(1)                  # one idle cached page, the pool dry
        assert pa.cow(0, 0) is not None  # evicts it for the private copy
        pa.check_no_leaks(external=cache.page_refs())

    def test_clear_returns_pool_to_free(self, pkg):
        pa, cache = _cache(pkg)
        toks = list(range(12))
        assert pa.ensure(0, len(toks))
        cache.insert(0, toks, len(toks))
        pa.release(0)
        assert pa.free_pages < pa.num_pages
        assert cache.clear() == 3
        pa.check_no_leaks()
        assert pa.free_pages == pa.num_pages


def test_claim_and_take_free_page_match_jax():
    """take_free_page pops the same page with refcount 0, claim_free_page
    the same page with refcount 1; both reclaim when the list is dry."""
    pages = {}
    for name, (Pager, Cache) in PACKAGES.items():
        pa = Pager(4, 4, 2, 4)
        cache = Cache(pa, copy_page=None)
        pa.reclaim_cb = cache.reclaim
        got = [pa.take_free_page()]
        pa.acquire(got[0])
        got.append(pa.claim_free_page())
        assert pa.refcount[got[1]] == 1
        assert pa.ensure(0, 8)
        cache.insert(0, list(range(8)), 8)
        pa.release(0)                  # the pool holds 2 cached pages only
        got.append(pa.claim_free_page())
        got.append(pa.claim_free_page())
        got.append(pa.claim_free_page())  # None: nothing left to reclaim
        assert cache.cached_pages == 0
        pages[name] = got
    assert pages["port"] == pages["jax"]
    assert pages["port"][-1] is None


# ---------------------------------------------------------------------------
# the property test: one random sequence of operations on both packages


def _fake_movers(log):
    def fetch(page):
        log.append(("fetch", int(page)))
        return {"k": np.full((2, 2), page), "v": np.full((3,), -page)}

    def upload(page, values):
        log.append(("upload", int(page), int(np.asarray(values["k"])[0, 0]),
                    int(np.asarray(values["v"])[0])))

    return fetch, upload


def _tree_state(cache):
    out, stack = [], [((), cache._root)]
    while stack:
        path, node = stack.pop()
        for bucket, kind in ((node.children, "full"), (node.partials, "tail")):
            for blk in sorted(bucket):
                c = bucket[blk]
                out.append((kind, path + blk, c.page, c.key, c.last_used, c.host is not None,
                            None if c.host is None else int(np.asarray(c.host["k"])[0, 0])))
                stack.append((path + blk, c))
    return sorted(out)


COUNTERS = ("prefix_inserts", "prefix_evictions", "prefix_cows", "spills", "readmits",
            "host_hit_tokens", "host_bytes")
OPS = ("ensure", "ensure", "release", "insert", "insert", "attach", "attach", "reclaim",
       "cow", "harvest", "clear")
BASES = ([1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14], [1, 2, 3, 4, 9, 9, 9, 9, 9],
         [5, 5, 5, 5, 5, 5, 5, 5, 6, 6, 6])


def _run_ops(ops, spill):
    mgrs = {}
    for name, (Pager, Cache) in PACKAGES.items():
        pa = Pager(10, 4, 4, 4)
        stats = JaxSchedulerStats() if name == "jax" else SchedulerStats()
        log = []
        kw = {}
        if spill:
            fetch, upload = _fake_movers(log)
            kw = dict(fetch_page=fetch, upload_page=upload, host_cache_bytes=3 * 64,
                      page_bytes=64)
        cache = Cache(pa, copy_page=lambda s, d, log=log: log.append(("copy", s, d)),
                      stats=stats, **kw)
        pa.reclaim_cb = cache.reclaim
        mgrs[name] = (pa, cache, stats, log)
    for op, slot, a, b in ops:
        base = BASES[b % len(BASES)]
        toks = base[: 1 + a % len(base)] + [b] * (a % 3)
        results = {}
        for name, (pa, cache, stats, log) in mgrs.items():
            if op == "ensure":
                results[name] = pa.ensure(slot, a % 17)
            elif op == "release":
                results[name] = pa.release(slot)
            elif op == "insert":
                results[name] = cache.insert(slot, toks, min(len(toks), a % 16))
            elif op == "attach":
                if pa.slot_pages(slot):
                    pa.release(slot)
                results[name] = cache.attach(slot, toks, limit=None if b % 2 else a % 12)
            elif op == "reclaim":
                results[name] = cache.reclaim(1 + b % 3)
            elif op == "cow":
                mapped = np.flatnonzero(pa.table[slot] != pa.scratch_page)
                results[name] = (pa.cow(slot, int(mapped[a % len(mapped)]))
                                 if len(mapped) else None)
            elif op == "harvest":
                results[name] = cache.harvest()
            else:
                results[name] = cache.clear()
        (jpa, jcache, jstats, jlog), (ppa, pcache, pstats, plog) = mgrs["jax"], mgrs["port"]
        assert results["port"] == results["jax"], (op, results)
        np.testing.assert_array_equal(ppa.table, jpa.table)
        np.testing.assert_array_equal(ppa.refcount, jpa.refcount)
        assert ppa._free_by_shard == jpa._free_by_shard
        assert ppa.version == jpa.version
        assert _tree_state(pcache) == _tree_state(jcache)
        assert pcache.host_bytes == jcache.host_bytes
        assert [getattr(pstats, c) for c in COUNTERS] == [getattr(jstats, c) for c in COUNTERS]
        assert plog == jlog
        ppa.check_no_leaks(external=pcache.page_refs())
        jpa.check_no_leaks(external=jcache.page_refs())


OP_LISTS = st.lists(st.tuples(st.sampled_from(OPS), st.integers(0, 3), st.integers(0, 40),
                              st.integers(0, 5)), min_size=1, max_size=60)


@settings(max_examples=60, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(ops=OP_LISTS, spill=st.booleans())
def test_allocator_and_tree_follow_jax_operation_for_operation(ops, spill):
    _run_ops(ops, spill)


# ---------------------------------------------------------------------------
# serving parity on a tiny LLaMA (kernels="torch"; the JAX manager on XLA)


VARIANTS = {"unfused": (), "rope_kv_write": ("rope_kv_write",), "whole_step": ("whole_step",)}


def _published_bytes(rm):
    """The bytes of every page the radix tree holds, by page, every cache
    buffer's slice of it."""
    cache = rm.engine.cache
    return {p: [cache[k][:, p].contiguous().view(torch.uint8).clone() for k in sorted(cache)]
            for p in rm.prefix_cache.page_refs()}


def _check_parity(weights, kv_quant, fused, prompts, new=6):
    """The port's cold run (caching off), its seeding run (caching on, a
    cold tree) and its warm run (the same prompts again, hits) all give
    JAX's cold tokens; the warm run leaves every page the seeding run
    published byte for byte as it was (hits read shared pages, and a
    request writes only into its own copies)."""
    kw = dict(kv_quant=kv_quant, fused_decode=fused)
    want = _tokens(_jax_rm(weights, kv_quant=kv_quant), prompts, new)
    assert _tokens(_port_rm(weights, **kw), prompts, new) == want
    rm = _port_rm(weights, prefix_caching=True, **kw)
    assert _tokens(rm, prompts, new) == want
    published = _published_bytes(rm)
    assert _tokens(rm, prompts, new) == want
    assert rm.stats.prefix_hits > 0 and rm.stats.prefix_hit_tokens > 0
    after = _published_bytes(rm)
    for page, chunks in published.items():
        assert all(torch.equal(a, b) for a, b in zip(chunks, after[page])), page
    _audit(rm)
    return rm


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_warm_tokens_equal_jax_cold_f32(weights, variant):
    """f32 pages, 26-token prompts: the second pass matches 25 tokens of
    each one's own transcript (three pages and a partial tail, a COW on
    every hit): warm == cold == JAX's tokens."""
    rm = _check_parity(weights, None, VARIANTS[variant],
                       _prompts(weights[2].vocab_size, 3, tail_len=6))
    assert rm.stats.prefix_cows > 0


@pytest.mark.parametrize("kv_quant", ["int8", "int4"])
def test_warm_tokens_equal_jax_cold_quantized(weights, kv_quant):
    """Quantized pages, unfused, a page-aligned 24-token prefix (a
    partial-tail COW would append at a scale whose history holds the
    seeder's later lines; int4's grid is too coarse for that to keep
    greedy tokens, as the JAX package's own tests note)."""
    _check_parity(weights, kv_quant, (), _prompts(weights[2].vocab_size, 3, shared_len=24,
                                                  tail_len=1))


@pytest.mark.slow
@pytest.mark.parametrize("kv_quant", ["int8", "int4"])
@pytest.mark.parametrize("variant", ["rope_kv_write", "whole_step"])
def test_warm_tokens_equal_jax_cold_quantized_fused(weights, kv_quant, variant):
    _check_parity(weights, kv_quant, VARIANTS[variant],
                  _prompts(weights[2].vocab_size, 3, shared_len=24, tail_len=1))


def test_int8_cow_warm_is_bitwise_cold(weights):
    """The JAX package's quantized COW case (tests/test_kv_quant.py): a
    20-token prefix ends mid-page, so every hit copies the int8 tail page
    with its scales; warm tokens equal cold ones and JAX's."""
    V = weights[2].vocab_size
    shared = [(j * 11 + 3) % V for j in range(20)]
    prompts = [shared + [i * 7 + 1, i * 3 + 2, 9] for i in range(6)]
    kw = dict(kv_quant="int8", prefix_caching=True, max_cached_tokens=512, page_size=16)
    jrm = _jax_rm(weights, **kw)
    want = _tokens(jrm, prompts)
    rm = _port_rm(weights, **kw)
    cold = _tokens(rm, prompts)
    warm = _tokens(rm, prompts)
    assert cold == want and warm == cold == _tokens(jrm, prompts)
    assert rm.stats.prefix_cows > 0 and rm.stats.prefix_cows == jrm.stats.prefix_cows
    _audit(rm)


def _jax_prefill_logits(eng, tokens, start, slot):
    logits, off = None, start
    while off < len(tokens):
        n = min(8, len(tokens) - off)
        bc = JaxBatchConfig.empty(eng.num_slots, 8, eng.scratch_pos)
        bc.tokens[slot, :n] = tokens[off:off + n]
        bc.positions[slot, :n] = np.arange(off, off + n)
        bc.logits_idx[slot] = n - 1
        bc.active[slot] = True
        logits = np.asarray(jax.device_get(eng.run(bc)))[slot]
        off += n
    return logits


def _port_prefill_logits(eng, tokens, start, slot):
    logits, off = None, start
    while off < len(tokens):
        n = min(8, len(tokens) - off)
        bc = BatchConfig.empty(eng.num_slots, 8, eng.scratch_pos)
        bc.tokens[slot, :n] = tokens[off:off + n]
        bc.positions[slot, :n] = np.arange(off, off + n)
        bc.logits_idx[slot] = n - 1
        bc.active[slot] = True
        logits = eng.run(bc).numpy()[slot]
        off += n
    return logits


@pytest.mark.parametrize("fused", [(), ("rope_kv_write",)])
def test_hit_logits_bitwise_cold_and_within_atol_of_jax(weights, fused):
    """Prefilling only the uncached suffix over spliced and COW'd pages
    gives bitwise the final-position logits of the port's cold full
    prefill, and JAX's cold logits within LOGIT_ATOL."""
    cfg_j, params_j, cfg_t, params_t = weights
    prompt = [(j * 11 + 5) % 256 for j in range(21)]  # 2 full pages + 5
    sc = dict(SERVE, prefix_caching=True, fused_decode=fused)
    jeng = JaxInferenceEngine(jl, cfg_j, params_j, JaxServingConfig(
        cache_dtype=jnp.float32, kernels="xla", **dict(sc, fused_decode=())))
    assert jeng.pager.ensure(0, len(prompt))
    want = _jax_prefill_logits(jeng, prompt, 0, slot=0)
    eng = InferenceEngine(tl, cfg_t, params_t, ServingConfig(
        cache_dtype=torch.float32, kernels="torch", **sc), device="cpu")
    pa = eng.pager
    cache = PrefixCache(pa, copy_page=eng.copy_page)
    pa.reclaim_cb = cache.reclaim
    assert pa.ensure(0, len(prompt))
    cold = _port_prefill_logits(eng, prompt, 0, slot=0)
    cache.insert(0, prompt, len(prompt))
    pa.release(0)
    matched = cache.attach(2, prompt)
    assert matched == 20 and matched % 8 == 4  # mid-page: the tail was copied
    hit = _port_prefill_logits(eng, prompt, matched, slot=2)
    np.testing.assert_array_equal(hit, cold)
    np.testing.assert_allclose(hit, want, atol=LOGIT_ATOL)
    pa.check_no_leaks(external=cache.page_refs())


# ---------------------------------------------------------------------------
# smaller cases


def test_cow_divergent_tail(weights):
    """A prompt diverging mid-page from a cached one copies the tail page:
    the cached original stays intact."""
    V = weights[2].vocab_size
    shared = [(j * 7 + 3) % V for j in range(20)]
    pa_prompt, pb_prompt = shared + [9, 9, 9], shared + [5, 5, 5, 5]
    jrm = _jax_rm(weights)
    want_a, want_b = _tokens(jrm, [pa_prompt], 5), _tokens(jrm, [pb_prompt], 5)
    rm = _port_rm(weights, prefix_caching=True)
    assert _tokens(rm, [pa_prompt], 5) == want_a
    assert _tokens(rm, [pb_prompt], 5) == want_b
    assert rm.stats.prefix_cows >= 1
    assert _tokens(rm, [pa_prompt], 5) == want_a
    _audit(rm)


@pytest.mark.parametrize("continuous", [True, False])
def test_cache_policy_prefill_publishes_early(weights, continuous):
    """policy="prefill" publishes the prompt when its last chunk is
    dispatched, in the pipelined and the sync scheduler: the same inserts
    and hits as JAX's manager, and the same tokens."""
    prompts = _prompts(weights[2].vocab_size, 2)
    kw = dict(prefix_caching=True, cache_policy="prefill", continuous_batching=continuous)
    jrm, rm = _jax_rm(weights, **kw), _port_rm(weights, **kw)
    for _ in range(2):
        got = rm.generate(prompts, max_new_tokens=5)
        assert [o.output_tokens for o in got] == _tokens(jrm, prompts, 5)
    assert all(o.profile.cached_prefix_len > 0 for o in got)
    for k in ("prefix_inserts", "prefix_hits", "prefix_misses", "prefix_hit_tokens",
              "prefill_tokens"):
        assert getattr(rm.stats, k) == getattr(jrm.stats, k), k
    _audit(rm)


def test_dense_passthrough(weights):
    """prefix_caching=True on the dense layout does nothing: no cache, the
    same tokens."""
    prompts = _prompts(weights[2].vocab_size, 3)
    dense = dict(kv_layout="dense")
    want = _tokens(_port_rm(weights, **dense), prompts)
    rm = _port_rm(weights, prefix_caching=True, **dense)
    assert rm.prefix_cache is None
    for _ in range(2):
        assert _tokens(rm, prompts) == want
    assert _tokens(_jax_rm(weights, **dense), prompts) == want


def test_hit_skips_prefill_work(weights):
    prompts = _prompts(weights[2].vocab_size, 2)
    rm = _port_rm(weights, prefix_caching=True)
    rm.generate(prompts, max_new_tokens=4)
    cold = rm.stats.prefill_tokens
    rm.generate(prompts, max_new_tokens=4)
    assert rm.stats.prefill_tokens - cold <= cold - rm.stats.prefix_hit_tokens
    _audit(rm)


def test_eviction_under_pressure_no_extra_preemption(weights):
    """An oversubscribed pool with a warm cache: admissions evict idle
    cached pages, never preempt more than the cold pool, and serve JAX's
    tokens (tests/test_prefix_cache.py's regression, on the port)."""
    V = weights[2].vocab_size
    batches = [_prompts(V, 2, shared_len=18 + 2 * b, tail_len=5) for b in range(3)]
    cold = _port_rm(weights, max_cached_tokens=80)
    rm = _port_rm(weights, max_cached_tokens=80, prefix_caching=True)
    jrm = _jax_rm(weights, max_cached_tokens=80, prefix_caching=True)
    for batch in batches:
        want = _tokens(cold, batch, 5)
        assert _tokens(rm, batch, 5) == want == _tokens(jrm, batch, 5)
        _audit(rm)
    assert rm.stats.prefix_evictions > 0
    assert rm.stats.prefix_evictions == jrm.stats.prefix_evictions
    assert rm.stats.preemptions <= cold.stats.preemptions
    assert rm.stats.failed == 0


def test_export_import_round_trip(weights):
    """export_tree ships every block's tokens and page bytes; importing
    it into a fresh engine's cache gives the same tree, the same page
    bytes and the same warm tokens."""
    prompts = _prompts(weights[2].vocab_size, 2)
    rm = _port_rm(weights, prefix_caching=True)
    want = _tokens(rm, prompts)
    entries = rm.prefix_cache.export_tree(fetch_page=rm.engine.fetch_page)
    assert entries and all(e["payload"] is not None for e in entries)
    other = _port_rm(weights, prefix_caching=True)
    assert other.prefix_cache.import_tree(entries, upload_page=other.engine.upload_page) == len(
        entries)
    assert other.prefix_cache.export_tree(fetch_page=other.engine.fetch_page)[0]["tokens"] == (
        entries[0]["tokens"])
    for a, b in zip(entries, other.prefix_cache.export_tree(fetch_page=other.engine.fetch_page)):
        assert a["parent"] == b["parent"] and a["tokens"] == b["tokens"]
        for k in a["payload"]:
            assert torch.equal(a["payload"][k], b["payload"][k]), k
    assert _tokens(other, prompts) == want
    assert other.stats.prefix_hits == len(prompts)
    _audit(other)
    with pytest.raises(ValueError, match="upload_page"):
        PrefixCache(PageAllocator(4, 4, 2, 4)).import_tree(entries)


@pytest.mark.parametrize("kv_quant", [None, "int8", "int4"])
def test_page_host_bytes_equals_jax(weights, kv_quant):
    cfg_j, params_j, cfg_t, params_t = weights
    sc = dict(SERVE, kv_quant=kv_quant)
    jeng = JaxInferenceEngine(jl, cfg_j, params_j, JaxServingConfig(cache_dtype=jnp.bfloat16, **sc))
    eng = InferenceEngine(tl, cfg_t, params_t, ServingConfig(cache_dtype=torch.bfloat16, **sc),
                          device="cpu")
    assert eng.page_host_bytes() == jeng.page_host_bytes()


def test_validation_matches_jax(weights):
    cfg_j, params_j, cfg_t, params_t = weights
    for kw, exc in ((dict(cache_policy="lru"), ValueError),
                    (dict(host_cache_bytes=1 << 20), ValueError),
                    (dict(host_cache_bytes=1 << 20, prefix_caching=True, kv_layout="dense"),
                     ValueError)):
        serve = dict(SERVE, **kw)
        with pytest.raises(exc):
            JaxInferenceEngine(jl, cfg_j, params_j, JaxServingConfig(**serve))
        with pytest.raises(exc):
            InferenceEngine(tl, cfg_t, params_t, ServingConfig(**serve), device="cpu")
    # accepted: the paged tier, and the dense pass-through
    InferenceEngine(tl, cfg_t, params_t, ServingConfig(**dict(
        SERVE, prefix_caching=True, host_cache_bytes=1 << 20, cache_policy="prefill")),
        device="cpu")
    InferenceEngine(tl, cfg_t, params_t, ServingConfig(**dict(
        SERVE, kv_layout="dense", prefix_caching=True)), device="cpu")


def test_snapshot_has_jax_prefix_keys(weights):
    keys = ("prefix_hits", "prefix_misses", "prefix_hit_tokens", "prefix_hit_rate",
            "prefix_inserts", "prefix_evictions", "prefix_cows", "spills", "readmits",
            "host_hit_tokens", "host_hit_rate", "host_bytes")
    rm = _port_rm(weights, prefix_caching=True)
    jrm = _jax_rm(weights, prefix_caching=True)
    prompts = _prompts(weights[2].vocab_size, 2)
    for _ in range(2):
        _tokens(rm, prompts, 3)
        _tokens(jrm, prompts, 3)
    got, want = rm.stats.snapshot(), jrm.stats.snapshot()
    assert {k: got[k] for k in keys} == {k: want[k] for k in keys}
    assert got["prefix_hit_rate"] == 0.5


@pytest.mark.slow
def test_poisson_shared_system_prompt_parity(weights):
    """Poisson arrivals of a shared system prompt: caching on and off give
    the same tokens, and the cache hits."""
    V = weights[2].vocab_size
    rng = np.random.default_rng(7)
    system = [(j * 7 + 3) % V for j in range(24)]
    prompts = [system + [int(t) for t in rng.integers(0, V, size=6)] for _ in range(24)]
    outs, gen = {}, GenerationConfig(max_new_tokens=6)
    for caching in (False, True):
        arrivals = np.random.default_rng(11)
        rm = _port_rm(weights, **dict(max_requests_per_batch=8, max_sequence_length=96,
                                      prefix_caching=caching))
        rids, due = [], list(prompts)
        while due or any(rm.requests[r].status.value not in ("completed", "error")
                         for r in rids):
            for _ in range(int(arrivals.integers(0, 3))):
                if due:
                    rids.append(rm.register_request(due.pop(0), gen))
            if not rm.step() and due:
                rids.append(rm.register_request(due.pop(0), gen))
        rm.drain()
        outs[caching] = [rm.requests[r].output_tokens for r in rids]
        if caching:
            assert rm.stats.prefix_hit_tokens > 0
            _audit(rm)
    assert outs[True] == outs[False]

