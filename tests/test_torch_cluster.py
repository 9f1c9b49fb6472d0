"""In-process cluster serving in the port (flexflow_tpu_torch/serve/
cluster/) held against the JAX package's (flexflow_tpu/serve/cluster/):
the router's units over fake replicas fed identical inputs in both
packages; end-to-end, the same tiny LLaMA and workload through JAX's
ClusterManager (``kernels="xla"``) and the port's (``kernels="torch"``),
with per-request greedy tokens, ``ProfileInfo.replica_id`` and the
ClusterStats counters equal, and the port's own contracts (1 replica
bitwise its bare engine, migration byte-exact, no page leaks) on top."""
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flexflow_tpu.metrics import ClusterStats as JaxClusterStats
from flexflow_tpu.models import llama as jl
from flexflow_tpu.serve import ClusterManager as JaxClusterManager
from flexflow_tpu.serve import InferenceEngine as JaxInferenceEngine
from flexflow_tpu.serve import RequestManager as JaxRequestManager
from flexflow_tpu.serve import ServingConfig as JaxServingConfig
from flexflow_tpu.serve.cluster import Router as JaxRouter
from flexflow_tpu.serve.llm import LLM as JaxLLM
from flexflow_tpu_torch import obs as tobs
from flexflow_tpu_torch.metrics import ClusterStats, SchedulerStats
from flexflow_tpu_torch.models import llama as tl
from flexflow_tpu_torch.serve import (
    ClusterManager,
    GenerationConfig,
    InferenceEngine,
    RequestManager,
    RequestStatus,
    ServingConfig,
)
from flexflow_tpu_torch.serve.cluster import Router, migrate_request
from flexflow_tpu_torch.serve.llm import LLM

torch.set_num_threads(1)

PROMPTS = [
    [3, 17, 91, 42, 7],
    [9, 8, 7, 6, 5, 4],
    [1, 2, 3, 4, 5, 6, 7, 8, 9],
    [11, 22, 33],
]
#: the ClusterStats counters held equal across the packages
COUNTERS = ("placements", "sheds", "migrations", "migrated_pages", "failovers",
            "standby_adoptions", "replica_down", "retries", "failover_errors",
            "migration_failures", "migration_queue_overflows")


@pytest.fixture(scope="module")
def tiny():
    cfg_j = jl.LLaMAConfig.tiny(dtype=jnp.float32)
    params_j = jl.init_params(jax.random.PRNGKey(0), cfg_j)
    cfg_t = tl.LLaMAConfig.tiny(dtype=torch.float32)
    params_t = tl.params_from_numpy(jax.tree.map(np.asarray, params_j), device="cpu")
    return {"jax": (cfg_j, params_j), "port": (cfg_t, params_t)}


def sc(pkg, **kw):
    base = dict(max_requests_per_batch=4, max_sequence_length=96, prefill_chunk=8,
                max_spec_tree_tokens=8, kv_layout="paged", page_size=16)
    base.update(kw)
    if pkg == "jax":
        return JaxServingConfig(cache_dtype=jnp.float32, kernels="xla", **base)
    return ServingConfig(cache_dtype=torch.float32, kernels="torch", **base)


def build(tiny, pkg, health_config=None, **kw):
    cfg, params = tiny[pkg]
    if pkg == "jax":
        return JaxClusterManager.build(jl, cfg, params, sc(pkg, **kw),
                                       health_config=health_config)
    return ClusterManager.build(tl, cfg, params, sc(pkg, **kw), device="cpu",
                                health_config=health_config)


def bare_outputs(tiny, pkg="port", n_new=8, prompts=PROMPTS, **kw):
    cfg, params = tiny[pkg]
    if pkg == "jax":
        rm = JaxRequestManager(JaxInferenceEngine(jl, cfg, params, sc(pkg, **kw)))
    else:
        rm = RequestManager(InferenceEngine(tl, cfg, params, sc(pkg, **kw), device="cpu"))
    return [r.output_tokens for r in rm.generate(prompts, max_new_tokens=n_new)]


def summary(cm, outs):
    """What the packages must agree on: per-request tokens, errors and
    replica ids, and the cluster counters."""
    s = cm.cluster_stats()
    return {
        "tokens": [list(r.output_tokens) for r in outs],
        "errored": [r.error is not None for r in outs],
        "replica_id": [r.profile.replica_id for r in outs],
        **{k: s[k] for k in COUNTERS},
    }


def both(tiny, run):
    """``run(pkg)`` → (cm, outs) in each package; their summaries equal.
    Returns the port's (cm, outs)."""
    got = {pkg: run(pkg) for pkg in ("jax", "port")}
    assert summary(*got["port"]) == summary(*got["jax"])
    return got["port"]


# ---------------------------------------------------------------------------
# config validation (fails at construction, as in JAX)


def test_cluster_config_validation(tiny):
    cfg, params = tiny["port"]
    with pytest.raises(ValueError, match="replicas"):
        InferenceEngine(tl, cfg, params, sc("port", replicas=0), device="cpu")
    with pytest.raises(ValueError, match="router_policy"):
        InferenceEngine(tl, cfg, params, sc("port", router_policy="nope"), device="cpu")
    for pkg in ("jax", "port"):
        with pytest.raises(ValueError, match="BOTH pools"):
            sc(pkg, replicas=2, prefill_replicas=1).validate_cluster()
        with pytest.raises(ValueError, match="must equal"):
            sc(pkg, replicas=3, prefill_replicas=1, decode_replicas=1).validate_cluster()
        with pytest.raises(ValueError, match="paged"):
            sc(pkg, kv_layout="dense", replicas=2, prefill_replicas=1,
               decode_replicas=1).validate_cluster()
        with pytest.raises(ValueError, match="slo_queue_delay_s"):
            sc(pkg, slo_queue_delay_s=-1.0).validate_cluster()
        with pytest.raises(ValueError, match="warm standbys"):
            sc(pkg, replicas=2, prefill_replicas=1, decode_replicas=1,
               standby_replicas=1).validate_cluster()
        sc(pkg, replicas=2, prefill_replicas=1, decode_replicas=1).validate_cluster()


@pytest.mark.parametrize("field,value", [
    ("replica_transport", "loopback"), ("replica_endpoints", ("127.0.0.1:1",)),
    ("rpc_deadline_s", 1.0), ("rpc_retries", 0), ("rpc_backoff_s", 0.5),
    ("concurrent_stepping", False), ("journal_dir", "/nonexistent"),
    ("heartbeat_interval_steps", 2), ("heartbeat_gap_steps", 8),
])
def test_transport_fields_name_the_cluster_transport_slice(tiny, field, value):
    cfg, params = tiny["port"]
    with pytest.raises(NotImplementedError, match="cluster transport slice"):
        ClusterManager.build(tl, cfg, params, sc("port", replicas=2, **{field: value}),
                             device="cpu")


def test_autoscale_fields_name_queue_1_item_11():
    with pytest.raises(NotImplementedError, match="queue 1 item 11"):
        sc("port", autoscale="drive").validate()


# ---------------------------------------------------------------------------
# router units over fake replicas, identical inputs in both packages


class FakeReplica:
    def __init__(self, index, *, score=0, delay=0.0, load=0.0):
        self.index = index
        self._score = score
        self._delay = delay
        self._load = load

    def prefix_score(self, tokens):
        return self._score

    def queue_delay_s(self):
        return self._delay

    def load(self):
        return self._load


PACKAGES = {"jax": (JaxRouter, JaxClusterStats), "port": (Router, ClusterStats)}


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_router_prefix_routes_to_longest_match(pkg):
    R, CS = PACKAGES[pkg]
    stats = CS()
    r = R([FakeReplica(0, score=0), FakeReplica(1, score=32), FakeReplica(2, score=16)],
          "prefix", stats=stats)
    assert r.route(list(range(40))) == (1, "prefix")
    assert stats.placements == {"prefix": 1}


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_router_prefix_miss_falls_back_to_least_loaded(pkg):
    R, CS = PACKAGES[pkg]
    r = R([FakeReplica(0, delay=2.0), FakeReplica(1, delay=0.1), FakeReplica(2, delay=1.0)],
          "prefix", stats=CS())
    assert r.route([1, 2, 3]) == (1, "least_loaded")


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_router_prefix_tie_breaks_by_load(pkg):
    R, _ = PACKAGES[pkg]
    r = R([FakeReplica(0, score=16, delay=5.0), FakeReplica(1, score=16, delay=0.0)],
          "prefix")
    assert r.route([1] * 20) == (1, "prefix")


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_router_round_robin_cycles(pkg):
    R, CS = PACKAGES[pkg]
    r = R([FakeReplica(i) for i in range(3)], "round_robin", stats=CS())
    assert [r.route([1])[0] for _ in range(6)] == [0, 1, 2, 0, 1, 2]


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_router_least_loaded_picks_min_delay(pkg):
    R, _ = PACKAGES[pkg]
    r = R([FakeReplica(0, delay=0.5, load=3), FakeReplica(1, delay=0.5, load=1),
           FakeReplica(2, delay=0.9)], "least_loaded")
    assert r.route([1])[0] == 1


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_router_session_affinity(pkg):
    R, CS = PACKAGES[pkg]
    stats = CS()
    reps = [FakeReplica(0, score=99), FakeReplica(1)]
    r = R(reps, "prefix", stats=stats)
    assert r.route([1] * 8, session_id="chat") == (0, "prefix")
    reps[1]._score = 10 ** 6
    assert r.route([1] * 8, session_id="chat") == (0, "affinity")
    assert stats.affinity_hits == 1
    reps[0]._delay = 99.0
    r.slo_queue_delay_s = 1.0
    pos, how = r.route([1] * 8, session_id="chat")
    assert pos == 1 and how != "affinity"


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_router_sheds_when_every_replica_over_slo(pkg):
    R, CS = PACKAGES[pkg]
    stats = CS()
    reps = [FakeReplica(0, delay=5.0), FakeReplica(1, delay=9.0)]
    r = R(reps, "prefix", slo_queue_delay_s=1.0, stats=stats)
    assert r.route([1, 2, 3]) == (None, "shed")
    assert stats.sheds == 1
    reps[1]._delay = 0.2
    assert r.route([1, 2, 3])[0] == 1
    assert stats.sheds == 1


def test_cluster_stats_aggregates_scheduler_stats():
    a, b = SchedulerStats(), SchedulerStats()
    a.prefix_hits, a.prefix_misses, a.admitted = 3, 1, 4
    b.prefix_hits, b.prefix_misses, b.admitted = 1, 3, 4
    cs = ClusterStats()
    cs.record_placement("prefix")
    cs.record_placement("affinity")
    cs.migrations, cs.migrated_bytes = 2, 1024
    snap = cs.snapshot([a, b])
    assert snap["replicas"]["admitted"] == 8
    assert snap["replicas"]["prefix_hit_rate"] == 0.5
    assert snap["placements"] == {"prefix": 1, "affinity": 1}
    assert snap["affinity_hits"] == 1
    assert "cluster" in cs.report([a, b])


# ---------------------------------------------------------------------------
# end to end: the router never changes the tokens


def test_single_replica_router_bitwise_vs_bare_engine(tiny):
    base = bare_outputs(tiny)
    assert base == bare_outputs(tiny, "jax")
    cm = build(tiny, "port", replicas=1)
    outs = cm.generate(PROMPTS, max_new_tokens=8)
    assert [r.output_tokens for r in outs] == base
    assert all(r.error is None and r.profile.replica_id == 0 for r in outs)
    assert all(r.profile.router_queue_delay_s >= 0.0 for r in outs)
    cm.check_no_leaks()


def test_single_replica_router_bitwise_sampling(tiny):
    """Same-seed sampling: the routed scheduler replays the bare engine's
    dispatch sequence, so its generator draws the same tokens (the port's
    draws come from a torch.Generator, so they are held to the port's
    bare engine, not to JAX's)."""
    cfg, params = tiny["port"]
    gen = GenerationConfig(do_sample=True, temperature=0.7, topk=8)
    rm = RequestManager(InferenceEngine(tl, cfg, params, sc("port"), device="cpu"))
    base = [r.output_tokens for r in rm.generate(PROMPTS, gen, max_new_tokens=8)]
    outs = build(tiny, "port", replicas=1).generate(PROMPTS, gen, max_new_tokens=8)
    assert [r.output_tokens for r in outs] == base


def test_round_robin_two_replicas_output_parity(tiny):
    cm, outs = both(tiny, lambda pkg: (lambda cm: (cm, cm.generate(PROMPTS, max_new_tokens=8)))(
        build(tiny, pkg, replicas=2, router_policy="round_robin")))
    assert [r.output_tokens for r in outs] == bare_outputs(tiny)
    assert {r.profile.replica_id for r in outs} == {0, 1}
    assert cm.cluster_stats()["placements"] == {"round_robin": 4}
    cm.check_no_leaks()


def test_prefix_routing_partitions_families(tiny):
    """Two prefix families over two prefix-cached replicas: each family
    seeds on one replica and every relative follows it by radix-tree
    match; tokens stay those of a cold engine."""
    sysA, sysB = [5] * 16, [7] * 16
    fam = [sysA + [i, i + 1] for i in range(3)] + [sysB + [i, i + 9] for i in range(3)]
    kw = dict(max_sequence_length=64, prefix_caching=True)
    base = [bare_outputs(tiny, n_new=4, prompts=[p], **kw)[0] for p in fam]

    def run(pkg):
        cm = build(tiny, pkg, replicas=2, **kw)
        return cm, [cm.generate([p], max_new_tokens=4)[0] for p in fam]

    cm, outs = both(tiny, run)
    assert [r.output_tokens for r in outs] == base
    s = cm.cluster_stats()
    assert s["placements"].get("prefix", 0) >= 4
    byrep = {}
    for p, r in zip(fam, outs):
        byrep.setdefault(tuple(p[:16]), set()).add(r.profile.replica_id)
    assert all(len(v) == 1 for v in byrep.values())
    assert s["replicas"]["prefix_hits"] >= 4
    cm.check_no_leaks()


# ---------------------------------------------------------------------------
# disaggregated prefill→decode migration


@pytest.mark.parametrize("kv_quant", [None, "int8", "int4"])
def test_migrated_prefill_bitwise_vs_local(tiny, kv_quant):
    """A request prefilled on the prefill pool and decoded on the decode
    pool after page migration generates the single-replica tokens
    bitwise, over fp, int8 and int4 pools; nothing leaks."""
    kw = {} if kv_quant is None else {"kv_quant": kv_quant}

    def run(pkg):
        cm = build(tiny, pkg, replicas=2, prefill_replicas=1, decode_replicas=1, **kw)
        return cm, cm.generate(PROMPTS, max_new_tokens=8)

    cm, outs = both(tiny, run)
    assert [r.output_tokens for r in outs] == bare_outputs(tiny, **kw)
    s = cm.cluster_stats()
    assert s["migrations"] == len(PROMPTS)
    assert s["migrated_pages"] >= len(PROMPTS) and s["migrated_bytes"] > 0
    assert all(r.profile.replica_id == 1 for r in outs)
    cm.check_no_leaks()
    assert cm.replicas[0].rm.hold_finished == set()
    assert cm.replicas[0].engine.pager.used_pages == 0


def test_migration_single_token_budget_finishes_on_prefill_pool(tiny):
    def run(pkg):
        cm = build(tiny, pkg, replicas=2, prefill_replicas=1, decode_replicas=1)
        return cm, cm.generate(PROMPTS, max_new_tokens=1)

    cm, outs = both(tiny, run)
    assert [r.output_tokens for r in outs] == bare_outputs(tiny, n_new=1)
    assert cm.cluster_stats()["migrations"] == 0
    assert cm.replicas[0].rm.hold_finished == set()
    cm.check_no_leaks()


@pytest.mark.parametrize("kv_quant", [None, "int8"])
def test_migrate_request_helper_moves_pages_exactly(tiny, kv_quant):
    """One prefill pass by hand, a migration, and the destination's page
    bytes (codes and scale rows) against the source's."""
    kw = {} if kv_quant is None else {"kv_quant": kv_quant}
    cm = build(tiny, "port", replicas=2, prefill_replicas=1, decode_replicas=1, **kw)
    src, dst = cm.replicas
    rid = src.rm.submit(list(range(1, 20)), GenerationConfig(max_new_tokens=1))
    src.rm.hold_on_finish(rid)
    while src.rm.step():
        pass
    src.rm.drain()
    req = src.rm.requests[rid]
    assert req.status is RequestStatus.COMPLETED and req.slot >= 0
    src_pages = [int(p) for p in src.engine.pager.table[req.slot][:2]]
    src_bytes = [src.engine.fetch_page(p).host_values() for p in src_pages]
    rid2 = migrate_request(src, dst, rid, GenerationConfig(max_new_tokens=4), stats=cm.stats)
    assert rid2 is not None
    dst_pages = [int(p) for p in dst.engine.pager.table[dst.rm.requests[rid2].slot][:2]]
    for sp, dp in zip(src_bytes, dst_pages):
        got = dst.engine.fetch_page(dp).host_values()
        assert sorted(got) == sorted(sp)
        for k in sp:
            assert torch.equal(sp[k], got[k]), k
    src.rm.release_held(rid)
    cm.check_no_leaks()


def test_adopt_prefilled_rolls_back_without_capacity(tiny):
    cfg, params = tiny["port"]
    rm = RequestManager(InferenceEngine(tl, cfg, params, sc("port"), device="cpu"))
    for i in range(4):
        rm.submit([1 + i, 2, 3], max_new_tokens=32)
    rm.step()
    assert all(s is not None for s in rm.slots)
    before = rm.engine.pager.used_pages
    assert rm.adopt_prefilled([9, 9, 9, 9], 3, GenerationConfig(max_new_tokens=4)) is None
    assert rm.engine.pager.used_pages == before
    for _ in range(200):
        if not rm.step():
            break
    rm.drain()


# ---------------------------------------------------------------------------
# shed and error paths: terminal, never a hang


def test_shed_surfaces_error_not_hang(tiny):
    def run(pkg):
        cm = build(tiny, pkg, replicas=2, slo_queue_delay_s=0.05)
        for rep in cm.replicas:
            rep.queue_delay_s = lambda: 10.0
        return cm, cm.generate(PROMPTS[:2], max_new_tokens=4)

    cm, outs = both(tiny, run)
    assert all(r.error is not None and "shed" in r.error for r in outs)
    assert all(r.output_tokens == [] for r in outs)
    assert cm.stats.sheds == 2
    assert all(cm.requests[c].status is RequestStatus.ERROR for c in cm.requests)


def test_unservable_prompt_errors_through_cluster(tiny):
    def run(pkg):
        cm = build(tiny, pkg, replicas=2, max_cached_tokens=32)
        return cm, cm.generate([[1, 2, 3, 4], list(range(80))], max_new_tokens=4)

    cm, outs = both(tiny, run)
    assert outs[0].error is None and len(outs[0].output_tokens) == 4
    assert outs[1].error is not None
    cm.check_no_leaks()


def _stream(cm, n_new):
    got, done = {}, set()
    for ev in cm.generate_stream(PROMPTS, max_new_tokens=n_new):
        if ev.done:
            assert ev.error is None and ev.request_id not in done
            done.add(ev.request_id)
        else:
            got.setdefault(ev.request_id, []).append(ev.token)
    assert len(done) == len(PROMPTS)
    return [got[c] for c in sorted(got)]


def test_cluster_stream_delivers_every_token_and_terminals(tiny):
    base = bare_outputs(tiny, n_new=6)
    for pkg in ("jax", "port"):
        cm = build(tiny, pkg, replicas=2, router_policy="round_robin")
        assert _stream(cm, 6) == base


def test_cluster_stream_disaggregated_no_duplicate_tokens(tiny):
    base = bare_outputs(tiny, n_new=6)
    for pkg in ("jax", "port"):
        cm = build(tiny, pkg, replicas=2, prefill_replicas=1, decode_replicas=1)
        assert _stream(cm, 6) == base
        assert cm.cluster_stats()["migrations"] == len(PROMPTS)


# ---------------------------------------------------------------------------
# entry points and observability


def _llm_cluster(tiny, pkg, serving_kw, prompts, n_new, **compile_kw):
    cfg, params = tiny[pkg]
    llm = JaxLLM(jl, cfg, params) if pkg == "jax" else LLM(tl, cfg, params, device="cpu")
    llm.compile(sc(pkg, **serving_kw), **compile_kw)
    return llm.rm, llm.generate(prompts, max_new_tokens=n_new)


# JAX's LLM.compile places params on its mesh's first device while its
# ClusterManager.build spreads replicas over every visible device; on this
# multi-device CPU host JAX's replica 1 then fails its first step and its
# requests fail over to replica 0. Tokens still agree (recompute
# re-admission is bitwise); the counters are held to the port's own
# expectations instead.


def test_llm_compile_builds_cluster(tiny):
    kw = dict(replicas=2, router_policy="round_robin")
    cm, outs = _llm_cluster(tiny, "port", kw, PROMPTS[:2], 4)
    _, want = _llm_cluster(tiny, "jax", kw, PROMPTS[:2], 4)
    assert isinstance(cm, ClusterManager)
    assert [o.output_tokens for o in outs] == [o.output_tokens for o in want]
    assert all(len(o.output_tokens) == 4 for o in outs)
    assert [o.profile.replica_id for o in outs] == [0, 1]
    assert cm.cluster_stats()["failovers"] == 0


def test_llm_compile_quantized_disaggregated_cluster_serves_jax_tokens(tiny):
    """quantization= and the cluster compose: int8 weights shared by
    reference across a prefill and a decode replica."""
    kw = dict(replicas=2, prefill_replicas=1, decode_replicas=1)
    cm, outs = _llm_cluster(tiny, "port", kw, PROMPTS, 6, quantization="int8")
    _, want = _llm_cluster(tiny, "jax", kw, PROMPTS, 6, quantization="int8")
    assert [o.output_tokens for o in outs] == [o.output_tokens for o in want]
    assert cm.replicas[0].engine.params is cm.replicas[1].engine.params
    assert cm.cluster_stats()["migrations"] == len(PROMPTS)
    assert all(o.profile.replica_id == 1 for o in outs)


def test_attach_observability_traces_router_and_replica_lanes(tiny):
    cm = build(tiny, "port", replicas=2, router_policy="round_robin")
    buf = tobs.attach_observability(cm)
    cm.generate(PROMPTS, max_new_tokens=4)
    lanes = {ev["lane"] for ev in buf.events}
    assert {"router", "replica0", "replica1"} <= lanes
    names = {ev["name"] for ev in buf.events if ev["lane"] == "router"}
    assert "place" in names
    # a placement's trace id stitches the router's event with the replica's
    place = [ev for ev in buf.events if ev["name"] == "place"]
    admits = {ev["trace_id"] for ev in buf.events if ev["name"] == "admit"}
    assert {ev["trace_id"] for ev in place} <= admits
    assert tobs.attach_observability(cm.replicas[0]) is not None


def test_serve_command_cluster_flags_reach_the_cluster(tiny, capsys):
    from flexflow_tpu_torch import __main__ as cli

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        cli.main(["serve", "--device", "cpu", "--kernels", "torch", "--kv-layout", "paged",
                  "--page-size", "16", "--replicas", "2", "--prefill-replicas", "1",
                  "--decode-replicas", "1", "--migration-queue-budget", "2",
                  "--max-new-tokens", "3", "--prompt", "3,17,91", "--prompt", "5,6,7,8"])
    out = capsys.readouterr().out
    assert out.count("[steps=") == 2
    with pytest.raises(SystemExit, match="requires a cluster"):
        cli.main(["serve", "--device", "cpu", "--kernels", "torch", "--max-new-tokens", "1",
                  "--fault-plan", '[{"kind": "crash", "replica": 0, "step": 1}]'])
