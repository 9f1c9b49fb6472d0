"""The port's host KV tier (ServingConfig.host_cache_bytes) against the
JAX package: the spill bookkeeping of serve/prefix_cache.py on both
packages (tests/test_kv_hierarchy.py's TestSpillBookkeeping), the
engine's page movers (a spill is a fresh clone, a re-admit restores the
page byte for byte), and serving: under pool pressure idle cached pages
spill instead of being evicted, and cold, warm and spilled-then-
re-admitted runs serve the same tokens, JAX's, on f32, int8 and int4
pools, unfused, with ``rope_kv_write`` and with ``whole_step``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flexflow_tpu.models import llama as jl
from flexflow_tpu.serve import InferenceEngine as JaxInferenceEngine
from flexflow_tpu.serve import RequestManager as JaxRequestManager
from flexflow_tpu.serve import ServingConfig as JaxServingConfig
from flexflow_tpu.serve.paging import PageAllocator as JaxPageAllocator
from flexflow_tpu.serve.prefix_cache import HOST_PAGE as JAX_HOST_PAGE
from flexflow_tpu.serve.prefix_cache import PrefixCache as JaxPrefixCache
from flexflow_tpu_torch.models import llama as tl
from flexflow_tpu_torch.serve import InferenceEngine, PageAllocator, RequestManager, ServingConfig
from flexflow_tpu_torch.serve.engine import PageSpill
from flexflow_tpu_torch.serve.prefix_cache import HOST_PAGE, PrefixCache

torch.set_num_threads(1)

PACKAGES = {"jax": (JaxPageAllocator, JaxPrefixCache, JAX_HOST_PAGE),
            "port": (PageAllocator, PrefixCache, HOST_PAGE)}


@pytest.fixture(scope="module")
def weights():
    cfg_j = jl.LLaMAConfig.tiny(dtype=jnp.float32)
    params_j = jl.init_params(jax.random.PRNGKey(0), cfg_j)
    cfg_t = tl.LLaMAConfig.tiny(dtype=torch.float32)
    params_t = tl.params_from_numpy(jax.tree.map(np.asarray, params_j), device="cpu")
    return cfg_j, params_j, cfg_t, params_t


SERVE = dict(max_requests_per_batch=4, max_sequence_length=64, prefill_chunk=8,
             max_spec_tree_tokens=8, kv_layout="paged", page_size=16)


def _port_engine(weights, **kw):
    cfg_t, params_t = weights[2:]
    dt = torch.float32 if kw.get("kv_quant") is None else torch.bfloat16
    return InferenceEngine(tl, cfg_t, params_t, ServingConfig(
        **dict(SERVE, cache_dtype=dt, kernels="torch", **kw)), device="cpu")


def _jax_rm(weights, **kw):
    cfg_j, params_j = weights[:2]
    dt = jnp.float32 if kw.get("kv_quant") is None else jnp.bfloat16
    return JaxRequestManager(JaxInferenceEngine(jl, cfg_j, params_j, JaxServingConfig(
        **dict(SERVE, cache_dtype=dt, kernels="xla", **kw))))


def family_prompts(V, fam, n=4, shared_len=32):
    """One page-aligned shared prefix a family and one token of its own a
    request: the match ends at the aligned prefix (no partial-tail COW)."""
    shared = [(j * 11 + fam * 41 + 3) % V for j in range(shared_len)]
    return [shared + [(fam * 31 + i * 7 + 1) % V] for i in range(n)]


def generate(rm, prompts, n_new=6):
    return [o.output_tokens for o in rm.generate(prompts, max_new_tokens=n_new)]


# ---------------------------------------------------------------------------
# spill bookkeeping on both packages (fake movers: the "content" is the
# page index recorded at spill time)


@pytest.fixture(params=sorted(PACKAGES))
def pkg(request):
    return PACKAGES[request.param]


def _fake_pages():
    log = {"fetched": [], "uploaded": []}

    def fetch(page):
        log["fetched"].append(page)
        return {"k": np.full((2, 2), page)}

    def upload(page, values):
        log["uploaded"].append((page, int(np.asarray(values["k"])[0, 0])))

    return fetch, upload, log


def _spill_cache(pkg, pa, host_bytes=1 << 20, page_bytes=100):
    _, Cache, _ = pkg
    fetch, upload, log = _fake_pages()
    cache = Cache(pa, copy_page=None, fetch_page=fetch, upload_page=upload,
                  host_cache_bytes=host_bytes, page_bytes=page_bytes)
    pa.reclaim_cb = cache.reclaim
    return cache, log


class TestSpillBookkeeping:
    def test_spill_frees_page_and_keeps_node(self, pkg):
        pa = pkg[0](4, 4, 2, 4)
        cache, log = _spill_cache(pkg, pa)
        assert pa.ensure(0, 8)
        cache.insert(0, list(range(8)), 8)
        pa.release(0)
        assert cache.cached_pages == 2 and pa.free_pages == 2
        assert pa.ensure(1, 16)  # reclaim spills, never drops
        assert cache.cached_pages == 2 and cache.host_pages == 2
        assert len(log["fetched"]) == 2
        assert all(n.page == pkg[2] for n in cache._nodes())
        pa.check_no_leaks(external=cache.page_refs())
        pa.release(1)
        pa.check_no_leaks(external=cache.page_refs())

    def test_readmit_restores_content_and_refs(self, pkg):
        pa = pkg[0](4, 4, 2, 4)
        cache, log = _spill_cache(pkg, pa)
        assert pa.ensure(0, 8)
        orig = [int(p) for p in pa.table[0][:2]]
        toks = list(range(8))
        cache.insert(0, toks, 8)
        pa.release(0)
        assert pa.ensure(1, 16) and pa.release(1) == 4
        assert cache.host_pages == 2
        cache.harvest()
        assert cache.attach(0, toks + [99]) == 8
        assert cache.host_pages == 0
        assert {src for _, src in log["uploaded"]} == set(orig)
        for p in pa.table[0][:2]:
            assert int(pa.refcount[int(p)]) == 2
        pa.check_no_leaks(external=cache.page_refs())

    def test_host_budget_lru_drops_cold_leaves(self, pkg):
        pa = pkg[0](4, 4, 2, 4)
        cache, _ = _spill_cache(pkg, pa, host_bytes=100, page_bytes=100)
        assert pa.ensure(0, 8)
        cache.insert(0, list(range(8)), 8)
        pa.release(0)
        assert pa.ensure(1, 16)
        assert cache.host_pages == 1 and cache.host_bytes == 100
        pa.release(1)
        pa.check_no_leaks(external=cache.page_refs())

    def test_spill_not_leaf_restricted(self, pkg):
        pa = pkg[0](6, 6, 2, 4)
        cache, _ = _spill_cache(pkg, pa)
        toks = list(range(12))
        assert pa.ensure(0, 12)
        cache.insert(0, toks, 12)
        pa.release(0)
        pa._reclaim(3)
        assert cache.host_pages >= 1
        assert cache._walk(toks + [99])[1] == 12
        pa.check_no_leaks(external=cache.page_refs())

    def test_attach_truncates_when_no_page_for_readmit(self, pkg):
        pa = pkg[0](4, 4, 2, 4)
        cache, _ = _spill_cache(pkg, pa)
        assert pa.ensure(0, 8)
        toks = list(range(8))
        cache.insert(0, toks, 8)
        pa.release(0)
        assert pa.ensure(1, 16) and cache.host_pages == 2
        assert cache.attach(0, toks + [99]) == 0
        assert int((pa.table[0] != pa.scratch_page).sum()) == 0
        pa.check_no_leaks(external=cache.page_refs())

    def test_attach_never_reclaims_its_own_matched_path(self, pkg):
        pa = pkg[0](4, 4, 2, 4)
        cache, _ = _spill_cache(pkg, pa)
        toks = list(range(8))
        assert pa.ensure(0, 8)
        cache.insert(0, toks, 8)
        pa.release(0)
        assert pa.ensure(1, 8)  # slot 1 holds the other two pages
        # a partial-tail prompt: the COW wants a page, the only idle pages
        # are the matched chain itself, pinned: the tail is dropped
        assert cache.attach(0, toks[:6] + [99, 98]) == 4
        assert cache.host_pages == 0
        pa.check_no_leaks(external=cache.page_refs())
        pa.release(0)
        pa.release(1)
        pa.check_no_leaks(external=cache.page_refs())

    def test_clear_discards_host_tier(self, pkg):
        pa = pkg[0](4, 4, 2, 4)
        cache, _ = _spill_cache(pkg, pa)
        assert pa.ensure(0, 8)
        cache.insert(0, list(range(8)), 8)
        pa.release(0)
        assert pa.ensure(1, 16) and pa.release(1) == 4
        assert cache.host_pages == 2 and cache.host_bytes > 0
        cache.clear()
        assert cache.cached_pages == 0 and cache.host_bytes == 0
        pa.check_no_leaks()
        assert pa.free_pages == pa.num_pages


# ---------------------------------------------------------------------------
# the engine's page movers


@pytest.mark.parametrize("kv_quant", [None, "int8", "int4"])
def test_fetch_is_a_fresh_clone_and_upload_restores_bytes(weights, kv_quant):
    """fetch_page returns content that survives the page being
    overwritten; upload_page writes it back byte for byte (codes and
    scales), from the harvested host values and from an unharvested
    handle alike; copy_page copies every buffer."""
    eng = _port_engine(weights, kv_quant=kv_quant)
    g = torch.Generator().manual_seed(3)
    for t in eng.cache.values():
        t.copy_((torch.rand(t.shape, generator=g) * 100).to(t.dtype))
    before = {k: t[:, 2].clone() for k, t in eng.cache.items()}
    spill = eng.fetch_page(2)
    assert isinstance(spill, PageSpill)
    for k, t in spill.host.items():
        assert t.untyped_storage().data_ptr() != eng.cache[k].untyped_storage().data_ptr()
    eng.copy_page(5, 2)                      # the page is reused
    for k, t in eng.cache.items():
        assert torch.equal(t[:, 2], t[:, 5])
    eng.upload_page(7, spill)                # never harvested
    host = spill.host_values()
    eng.upload_page(3, host)                 # harvested
    for k in eng.cache:
        for p in (3, 7):
            assert torch.equal(eng.cache[k][:, p].view(torch.uint8),
                               before[k].view(torch.uint8)), (k, p)
    assert spill.device is None


def test_host_cache_requires_prefix_caching(weights):
    with pytest.raises(ValueError, match="host_cache_bytes"):
        _port_engine(weights, host_cache_bytes=1 << 20)


# ---------------------------------------------------------------------------
# serving: spill, then re-admit, bitwise the warm path


def _spill_scenario(weights, kv_quant, budget, fused=()):
    """(cold, warm, spilled, stats): family 0 on a roomy pool twice (cold,
    then warm), and on a tight pool where other families spill family
    0's pages to the host before it is served again (re-admitted)."""
    V = weights[2].vocab_size
    kw = dict(kv_quant=kv_quant, fused_decode=fused, prefix_caching=True,
              host_cache_bytes=1 << 22)

    def make(b):
        return RequestManager(_port_engine(weights, max_cached_tokens=b, **kw))

    roomy = make(4096)
    cold = generate(roomy, family_prompts(V, 0))
    warm = generate(roomy, family_prompts(V, 0))
    rm = make(budget)
    assert generate(rm, family_prompts(V, 0)) == cold
    fam = 1
    while not (rm.stats.spills and rm.prefix_cache.host_pages) and fam < 24:
        generate(rm, family_prompts(V, fam))
        fam += 1
    spilled = generate(rm, family_prompts(V, 0))
    rm.drain()
    rm.engine.pager.check_no_leaks(external=rm.prefix_cache.page_refs())
    return cold, warm, spilled, rm.stats


@pytest.mark.parametrize("kv_quant,budget", [(None, 160), ("int8", 42), ("int4", 22)])
def test_spilled_readmit_is_bitwise_warm(weights, kv_quant, budget):
    cold, warm, spilled, stats = _spill_scenario(weights, kv_quant, budget)
    assert stats.spills > 0 and stats.readmits > 0 and stats.host_hit_tokens > 0
    assert warm == cold and spilled == warm
    want = generate(_jax_rm(weights, kv_quant=kv_quant), family_prompts(weights[2].vocab_size, 0))
    assert cold == want


@pytest.mark.slow
@pytest.mark.parametrize("kv_quant,budget", [(None, 160), ("int8", 42), ("int4", 22)])
@pytest.mark.parametrize("fused", [("rope_kv_write",), ("whole_step",)])
def test_spilled_readmit_is_bitwise_warm_fused(weights, kv_quant, budget, fused):
    cold, warm, spilled, stats = _spill_scenario(weights, kv_quant, budget, fused)
    assert stats.spills > 0 and stats.readmits > 0
    assert warm == cold and spilled == warm


def test_eviction_vs_spill_pressure_matches_jax(weights):
    """The same tight-pool churn with the host tier off (eviction) and on
    (spill): the same tokens, JAX's counters, no leak."""
    V = weights[2].vocab_size
    for host in (None, 1 << 22):
        kw = dict(prefix_caching=True, host_cache_bytes=host, max_cached_tokens=160)
        rm = RequestManager(_port_engine(weights, **kw))
        jrm = _jax_rm(weights, **kw)
        for fam in (0, 1, 2, 3, 0, 1):
            assert generate(rm, family_prompts(V, fam)) == generate(jrm, family_prompts(V, fam))
        for k in ("prefix_evictions", "spills", "readmits", "host_hit_tokens", "host_bytes",
                  "prefix_hit_tokens", "preemptions"):
            assert getattr(rm.stats, k) == getattr(jrm.stats, k), (host, k)
        rm.engine.pager.check_no_leaks(external=rm.prefix_cache.page_refs())
        if host:
            assert rm.stats.spills > 0 and rm.stats.prefix_evictions == 0
            assert rm.stats.host_hit_rate > 0
        else:
            assert rm.stats.prefix_evictions > 0 and rm.stats.spills == 0


def test_profile_records_host_hit_tokens(weights):
    V = weights[2].vocab_size
    rm = RequestManager(_port_engine(weights, prefix_caching=True, host_cache_bytes=1 << 22,
                                     max_cached_tokens=160))
    rm.generate(family_prompts(V, 0), max_new_tokens=6)
    fam = 1
    while not rm.prefix_cache.host_pages and fam < 24:
        rm.generate(family_prompts(V, fam), max_new_tokens=6)
        fam += 1
    assert rm.prefix_cache.host_pages > 0
    res = rm.generate(family_prompts(V, 0), max_new_tokens=6)
    assert any(r.profile.host_hit_tokens > 0 for r in res)
    assert all(r.profile.host_hit_tokens <= r.profile.cached_prefix_len for r in res)
    # every pending spill was harvested at a flush: host values, no device clone
    assert not rm.prefix_cache._pending_spills
    assert all(isinstance(n.host, dict) for n in rm.prefix_cache._nodes() if n.host is not None)
