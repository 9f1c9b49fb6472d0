"""Fault-tolerant in-process cluster serving in the port
(flexflow_tpu_torch/serve/cluster/{health,faults}.py and the manager's
failover, migration back-pressure and warm standbys) held against the
JAX package's: the health machine and FaultPlan units fed identical
inputs in both packages; end to end, the same tiny LLaMA, workload and
FaultPlan through both packages' ClusterManager, with per-request greedy
tokens, ``ProfileInfo.replica_id`` and the ClusterStats counters equal,
and the port's contracts (every request terminal, failover bitwise the
fault-free run, no leaked page or held slot on a survivor) on top."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flexflow_tpu.models import llama as jl
from flexflow_tpu.serve import ClusterManager as JaxClusterManager
from flexflow_tpu.serve import ServingConfig as JaxServingConfig
from flexflow_tpu.serve import cluster as jc
from flexflow_tpu_torch.models import llama as tl
from flexflow_tpu_torch.serve import (
    ClusterManager,
    GenerationConfig,
    InferenceEngine,
    RequestManager,
    RequestStatus,
    ServingConfig,
)
from flexflow_tpu_torch.serve import cluster as tc
from flexflow_tpu_torch.serve.cluster.faults import InjectedFault
from flexflow_tpu_torch.serve.llm import LLM, SSM

torch.set_num_threads(1)

PROMPTS = [
    [3, 17, 91, 42, 7],
    [9, 8, 7, 6, 5, 4],
    [1, 2, 3, 4, 5, 6, 7, 8, 9],
    [11, 22, 33],
]
COUNTERS = ("placements", "sheds", "migrations", "migrated_pages", "failovers",
            "standby_adoptions", "replica_down", "retries", "failover_errors",
            "migration_failures", "migration_queue_overflows", "step_faults")
CLUSTER = {"jax": jc, "port": tc}


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


def build(tiny, pkg, health=None, **kw):
    cfg, params = tiny[pkg]
    hc = None if health is None else CLUSTER[pkg].HealthConfig(**health)
    if pkg == "jax":
        return JaxClusterManager.build(jl, cfg, params, sc(pkg, **kw), health_config=hc)
    return ClusterManager.build(tl, cfg, params, sc(pkg, **kw), device="cpu",
                                health_config=hc)


def plan(pkg, *faults):
    """A FaultPlan of ``(kind, replica, step, extra)`` tuples in ``pkg``."""
    C = CLUSTER[pkg]
    return C.FaultPlan([C.Fault(k, replica=r, step=s, **x) for k, r, s, x in faults])


def bare_outputs(tiny, n_new=8, **kw):
    cfg, params = tiny["port"]
    rm = RequestManager(InferenceEngine(tl, cfg, params, sc("port", **kw), device="cpu"))
    return [r.output_tokens for r in rm.generate(PROMPTS, max_new_tokens=n_new)]


def summary(cm, outs):
    s = cm.cluster_stats()
    return {
        "tokens": [list(r.output_tokens) for r in outs],
        "errored": [r.error is not None for r in outs],
        "replica_id": [r.profile.replica_id for r in outs],
        "health": cm.health_snapshot(),
        **{k: s[k] for k in COUNTERS},
    }


def both(tiny, run):
    got = {pkg: run(pkg) for pkg in ("jax", "port")}
    assert summary(*got["port"]) == summary(*got["jax"])
    return got["port"]


def faulted(tiny, faults, n_new=8, health=None, **kw):
    """``run(pkg)`` for :func:`both`: a cluster with ``faults`` attached,
    generating PROMPTS."""
    def run(pkg):
        cm = build(tiny, pkg, health=health, **kw)
        cm.attach_faults(plan(pkg, *faults))
        return cm, cm.generate(PROMPTS, max_new_tokens=n_new)
    return run


def no_held_slots(cm):
    for pos, rep in enumerate(cm.replicas):
        if cm.health[pos].state is not tc.HealthState.DOWN:
            assert rep.rm.hold_finished == set(), rep.index


RR2 = dict(replicas=2, router_policy="round_robin")
DISAGG = dict(replicas=2, prefill_replicas=1, decode_replicas=1)


# ---------------------------------------------------------------------------
# health machine and fault plan units, both packages


def _health_trace(C, events, **cfg):
    h = C.ReplicaHealth(0, C.HealthConfig(**cfg))
    out = []
    for ev, arg, step in events:
        if ev == "fail":
            out.append(h.record_failure(RuntimeError("boom"), step_no=step))
        elif ev == "ok":
            out.append(h.record_success(arg, step))
        else:
            out.append(h.maybe_probe(step_no=step))
        out.append((h.state.value, h.routable, h.backoff_steps, h.trips))
    return out


def test_health_exception_path_to_down_and_probe():
    events = ([("fail", None, 1), ("fail", None, 2), ("probe", None, 5), ("probe", None, 6),
               ("fail", None, 7), ("probe", None, 14), ("probe", None, 15)]
              + [("ok", 0.01, 16 + i) for i in range(8)])
    cfg = dict(failure_threshold=2, probe_backoff_steps=4)
    got = _health_trace(tc, events, **cfg)
    assert got == _health_trace(jc, events, **cfg)
    assert got[0::2][:2] == ["suspect", "down"] and "recovered" in got
    assert got[0::2][2:4] == [False, True]  # the probe waits out the backoff


def test_health_suspect_recovers_on_clean_streak():
    events = [("fail", None, 1)] + [("ok", 0.01, i) for i in (2, 3, 4)]
    got = _health_trace(tc, events, recovery_steps=3)
    assert got == _health_trace(jc, events, recovery_steps=3)
    assert got[-2] == "recovered"


def test_health_latency_spikes_suspect_then_down():
    events = [("ok", 0.01, i) for i in range(3)] + [("ok", 1.0, i) for i in range(10, 14)]
    cfg = dict(min_latency_samples=2, latency_spike_factor=4.0, latency_spike_steps=2,
               spike_down_steps=4)
    got = _health_trace(tc, events, **cfg)
    assert got == _health_trace(jc, events, **cfg)
    assert got[8] == "suspect" and got[12] == "down"


def test_fault_plan_seeded_reproducible_and_json_roundtrip():
    a = tc.FaultPlan.random(1234, n_replicas=3, horizon=50)
    assert a.faults == tc.FaultPlan.random(1234, n_replicas=3, horizon=50).faults
    # the same seed draws the JAX package's plan
    j = jc.FaultPlan.random(1234, n_replicas=3, horizon=50)
    assert a.to_json() == j.to_json()
    assert tc.FaultPlan.from_json(a.to_json()).faults == a.faults
    with pytest.raises(ValueError, match="unknown fault kind"):
        tc.Fault(kind="meteor", replica=0, step=1)
    with pytest.raises(ValueError, match="step >= 1"):
        tc.Fault(kind="crash", replica=0, step=0)


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_attach_faults_refuses_transport_kinds_in_process(tiny, pkg):
    cm = build(tiny, pkg, replicas=2)
    with pytest.raises(ValueError, match="transport kinds"):
        cm.attach_faults(plan(pkg, ("partition", 0, 1, {})))
    with pytest.raises(ValueError, match="sigkill"):
        cm.attach_faults(plan(pkg, ("sigkill", 0, 1, {})))
    if pkg == "port":  # recovered from the journal, which the port lacks yet
        with pytest.raises(ValueError, match="manager_crash"):
            cm.attach_faults(plan(pkg, ("manager_crash", 0, 1, {})))


def test_injected_crash_raises_at_replica_surface(tiny):
    cm = build(tiny, "port", replicas=1)
    inj = cm.attach_faults(plan("port", ("crash", 0, 2, {})))
    rep = cm.replicas[0]
    rep.rm.submit(PROMPTS[0], max_new_tokens=4)
    rep.step()
    with pytest.raises(InjectedFault, match="injected crash"):
        rep.step()
    assert inj.fired and inj.fired[0]["kind"] == "crash"


# ---------------------------------------------------------------------------
# failover: replica death -> recompute re-admission on survivors


def test_single_replica_death_failover_bitwise(tiny):
    base = [r.output_tokens for r in build(tiny, "port", **RR2).generate(
        PROMPTS, max_new_tokens=8)]
    cm, outs = both(tiny, faulted(tiny, [("crash", 1, 3, {})], **RR2))
    assert all(r.error is None for r in outs)
    assert [r.output_tokens for r in outs] == base
    s = cm.cluster_stats()
    assert s["replica_down"] == 1 and s["failovers"] >= 1
    moved = [r for r in outs if r.profile.retries > 0]
    assert moved and all(r.profile.failover_replica_id == 0 for r in moved)
    assert cm.health_snapshot()[1] in ("down", "probing")
    cm.check_no_leaks()
    no_held_slots(cm)


def test_transient_fault_absorbed_without_failover(tiny):
    cm, outs = both(tiny, faulted(tiny, [("transient", 1, 3, {})], **RR2))
    assert [r.output_tokens for r in outs] == bare_outputs(tiny)
    s = cm.cluster_stats()
    assert s["replica_down"] == 0 and s["failovers"] == 0
    assert s["replica_suspect"] >= 1 and s["step_faults"] == 1
    cm.check_no_leaks()


def test_probe_readmission_recovers_replica(tiny):
    def run(pkg):
        cm = build(tiny, pkg, **RR2)
        cm.attach_faults(plan(pkg, ("transient", 1, 2, {"count": 2})))
        outs = cm.generate(PROMPTS, max_new_tokens=6)
        for _ in range(2 * cm.health.cfg.probe_backoff_steps):
            cm.step()
        assert cm.health_snapshot()[1] == "probing"
        return cm, outs + cm.generate(PROMPTS, max_new_tokens=6)

    cm, outs = both(tiny, run)
    assert all(r.error is None for r in outs)
    assert [r.output_tokens for r in outs[4:]] == bare_outputs(tiny, n_new=6)
    assert cm.health_snapshot()[1] == "healthy" and cm.stats.replica_recoveries == 1
    assert any(r.profile.replica_id == 1 for r in outs[4:])
    cm.check_no_leaks()
    no_held_slots(cm)


def test_latency_spike_trips_breaker_and_fails_over(tiny):
    health = dict(min_latency_samples=2, latency_spike_factor=5.0, latency_spike_steps=2,
                  spike_down_steps=3)
    cm, outs = both(tiny, faulted(tiny, [("latency", 1, 4, {"count": 8, "seconds": 60.0})],
                                  health=health, **RR2))
    assert [r.output_tokens for r in outs] == bare_outputs(tiny)
    s = cm.cluster_stats()
    assert s["replica_suspect"] >= 1 and s["replica_down"] == 1 and s["failovers"] >= 1
    cm.check_no_leaks()
    no_held_slots(cm)


def test_all_replicas_down_terminal_error_never_hangs(tiny):
    def run(pkg):
        cm = build(tiny, pkg, **RR2)
        cm.attach_faults(plan(pkg, ("crash", 0, 1, {}), ("crash", 1, 1, {})))
        outs = cm.generate(PROMPTS[:2], max_new_tokens=4)
        return cm, outs + [cm.result(cm.submit(PROMPTS[2], max_new_tokens=4))]

    cm, outs = both(tiny, run)
    assert all(r.error is not None for r in outs)
    assert "healthy" in outs[-1].error
    assert all(cm.requests[c].status is RequestStatus.ERROR for c in cm.requests)


def test_stream_across_failover_monotone_tokens(tiny):
    for pkg in ("jax", "port"):
        cm = build(tiny, pkg, **RR2)
        cm.attach_faults(plan(pkg, ("crash", 1, 4, {})))
        got, done = {}, set()
        for ev in cm.generate_stream(PROMPTS, max_new_tokens=8):
            if ev.done:
                assert ev.error is None and ev.request_id not in done
                done.add(ev.request_id)
            else:
                got.setdefault(ev.request_id, []).append(ev.token)
        assert len(done) == len(PROMPTS)
        assert [got[c] for c in sorted(got)] == bare_outputs(tiny)
    cm.check_no_leaks()


def test_oom_fault_pressures_pool_without_leaks(tiny):
    kw = dict(RR2, max_cached_tokens=160)

    def run(pkg):
        cm = build(tiny, pkg, **kw)
        inj = cm.attach_faults(plan(pkg, ("oom", 0, 3, {"count": 4, "pages": 6})))
        outs = cm.generate(PROMPTS, max_new_tokens=8)
        assert any(f["kind"] == "oom" for f in inj.fired)
        inj.release_all()
        return cm, outs

    cm, outs = both(tiny, run)
    assert [r.output_tokens for r in outs] == bare_outputs(tiny, max_cached_tokens=160)
    cm.check_no_leaks()


# ---------------------------------------------------------------------------
# disaggregated faults: migration retry/rollback and pool fallbacks


def test_migration_failure_retries_then_succeeds(tiny):
    cm, outs = both(tiny, faulted(tiny, [("migration", 0, 1, {"count": 1})], **DISAGG))
    assert [r.output_tokens for r in outs] == bare_outputs(tiny)
    s = cm.cluster_stats()
    assert s["migration_failures"] == 1 and s["migrations"] == len(PROMPTS)
    cm.check_no_leaks()
    no_held_slots(cm)


def test_migration_rollback_on_midtransfer_failure(tiny):
    cm = build(tiny, "port", **DISAGG)
    src, dst = cm.replicas
    rid = src.rm.submit(list(range(1, 20)), GenerationConfig(max_new_tokens=1))
    src.rm.hold_on_finish(rid)
    while src.rm.step():
        pass
    src.rm.drain()
    orig_upload = dst.engine.upload_page

    def boom(*a, **k):
        raise RuntimeError("mid-transfer failure")

    dst.engine.upload_page = boom
    with pytest.raises(RuntimeError, match="mid-transfer"):
        tc.migrate_request(src, dst, rid, GenerationConfig(max_new_tokens=4), stats=cm.stats)
    assert dst.rm.requests == {}
    assert all(s is None for s in dst.rm.slots)
    assert dst.engine.pager.used_pages == 0
    dst.engine.upload_page = orig_upload
    assert tc.migrate_request(src, dst, rid, GenerationConfig(max_new_tokens=4),
                              stats=cm.stats) is not None
    src.rm.release_held(rid)
    cm.check_no_leaks()


def test_migration_queue_budget_drains_via_recompute(tiny):
    prompts = [[(i * 13 + j * 3 + 5) % 64 + 2 for j in range(6)] for i in range(10)]

    def run(budget):
        def go(pkg):
            cm = build(tiny, pkg, migration_queue_budget=budget, **DISAGG)
            outs = cm.generate(prompts, max_new_tokens=12)
            return cm, outs
        cm, outs = both(tiny, go)
        assert all(r.error is None and len(r.output_tokens) == 12 for r in outs)
        cm.check_no_leaks()
        no_held_slots(cm)
        return [r.output_tokens for r in outs], cm.cluster_stats()

    base, _ = run(None)
    outs, s = run(1)
    assert outs == base
    assert s["migration_queue_overflows"] >= 1 and s["migration_queue_peak"] <= 1
    assert s["migration_queue_depth"] == 0


def test_decode_pool_death_falls_back_to_surviving_pool(tiny):
    cm, outs = both(tiny, faulted(tiny, [("crash", 1, 1, {})], **DISAGG))
    assert [r.output_tokens for r in outs] == bare_outputs(tiny)
    assert cm.cluster_stats()["replica_down"] == 1
    assert all(r.profile.replica_id == 0 for r in outs)
    cm.check_no_leaks()
    no_held_slots(cm)


def test_prefill_pool_death_routes_to_decode_pool(tiny):
    def run(pkg):
        cm = build(tiny, pkg, **DISAGG)
        cm.attach_faults(plan(pkg, ("crash", 0, 2, {})))
        outs = cm.generate(PROMPTS, max_new_tokens=8)
        cid = cm.submit(PROMPTS[0], max_new_tokens=4)
        while not cm._terminal(cid):
            if not cm.step():
                break
        cm.drain()
        return cm, outs + [cm.result(cid)]

    cm, outs = both(tiny, run)
    assert [r.output_tokens for r in outs[:4]] == bare_outputs(tiny)
    assert all(r.profile.replica_id == 1 for r in outs)
    assert cm.cluster_stats()["placements"].get("pool_fallback", 0) >= 1
    cm.check_no_leaks()
    no_held_slots(cm)


# ---------------------------------------------------------------------------
# warm standbys


def test_standby_adopts_dead_replicas_prefix_families_warm(tiny):
    """A crash of replica 1 with a standby: the standby takes position 1
    with replica 1's radix tree imported (it scores > 0 on that family
    at once), its requests fail over, and tokens stay the fault-free
    run's."""
    fam = [[5] * 16 + [i, i + 1] for i in range(2)] + [[7] * 16 + [i, i + 9]
                                                       for i in range(2)]
    kw = dict(replicas=2, router_policy="round_robin", prefix_caching=True,
              standby_replicas=1)

    def run(pkg):
        cm = build(tiny, pkg, **kw)
        outs = [cm.generate([p], max_new_tokens=4)[0] for p in fam]
        cm.attach_faults(plan(pkg, ("crash", 1, 1, {})))
        outs += cm.generate(fam, max_new_tokens=4)
        return cm, outs

    cm, outs = both(tiny, run)
    assert all(r.error is None for r in outs)
    assert [r.output_tokens for r in outs[4:]] == [r.output_tokens for r in outs[:4]]
    s = cm.cluster_stats()
    assert s["standby_adoptions"] == 1 and s["replica_down"] == 1
    standby = cm.replicas[1]
    assert standby.index == 2 and cm.standbys == []
    assert standby.prefix_score(fam[1]) > 0  # replica 1 served fam[1] cold
    cm.check_no_leaks()
    no_held_slots(cm)


# ---------------------------------------------------------------------------
# seeded chaos: every request terminal, zero leaks on survivors


@pytest.mark.parametrize("seed,n_rep,kv_quant", [
    (11, 2, None),
    # three quantized engines a package: kept out of the tier-1 time budget
    pytest.param(23, 3, "int8", marks=pytest.mark.slow),
    pytest.param(31, 2, "int4", marks=pytest.mark.slow),
])
def test_chaos_plan_every_request_terminal(tiny, seed, n_rep, kv_quant):
    """A seeded random FaultPlan over the pool: whatever fires, every
    request reaches a terminal state — a result or an error, never a hang
    — with clean pools on every survivor. The port is held to these
    invariants (placements here read wall-clock rates, so its counters
    may legitimately differ from JAX's run)."""
    kw = dict(replicas=n_rep, router_policy="prefix", prefix_caching=True)
    if kv_quant:
        kw["kv_quant"] = kv_quant
    cm = build(tiny, "port", **kw)
    inj = cm.attach_faults(tc.FaultPlan.random(seed, n_rep, horizon=25))
    prompts = [[(i * 7 + j * 5 + 3) % 64 + 2 for j in range(4 + i % 6)] for i in range(9)]
    cids = [cm.submit(p, max_new_tokens=6, session_id=f"chat-{i % 3}")
            for i, p in enumerate(prompts)]
    steps = 0
    while any(not cm._terminal(c) for c in cids):
        steps += 1
        assert steps < 3000, f"hang: health={cm.health_snapshot()}"
        cm.step()
        if steps == 8:
            cids.append(cm.submit([5, 9, 2, 7], max_new_tokens=4))
    cm.drain()
    for c in cids:
        assert cm._terminal(c)
        res = cm.result(c)
        if res.error is None:
            assert 1 <= len(res.output_tokens) <= 6
    inj.release_all()
    cm.check_no_leaks()
    no_held_slots(cm)


def test_chaos_same_seed_same_fired_sequence(tiny):
    """The same seed over the same round-robin workload fires the same
    faults at the same replica-local steps, with the same outcomes — in
    each package and across them."""
    def run(pkg):
        cm = build(tiny, pkg, **RR2)
        inj = cm.attach_faults(CLUSTER[pkg].FaultPlan.random(77, 2, horizon=12))
        outs = cm.generate(PROMPTS, max_new_tokens=6)
        inj.release_all()
        return list(inj.fired), [(r.output_tokens, r.error is None) for r in outs]

    port = run("port")
    assert port == run("port") == run("jax")


# ---------------------------------------------------------------------------
# the SLO cold-rate guard and SpecInfer x cluster validation


def test_queue_delay_guards_cold_and_reset_rate(tiny):
    cm = build(tiny, "port", replicas=1)
    rep = cm.replicas[0]
    rep.rm.submit(PROMPTS[2], max_new_tokens=4)
    assert rep.backlog_tokens() > 0 and rep.queue_delay_s() == 0.0
    rep._rate, rep._rate_samples = 5.0, 1
    assert rep.queue_delay_s() == 0.0
    rep._rate_samples = 2
    assert rep.queue_delay_s() > 0.0
    rep.reset_rate()
    assert rep.queue_delay_s() == 0.0
    while rep.rm.step():
        pass
    rep.rm.drain()


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_validate_cluster_specinfer_rejects_disagg_only(pkg):
    sc(pkg, replicas=2).validate_cluster(specinfer=True)
    with pytest.raises(ValueError, match="SpecInfer"):
        sc(pkg, **DISAGG).validate_cluster(specinfer=True)
    sc(pkg).validate_cluster(specinfer=True)
    with pytest.raises(ValueError, match="failover_retries"):
        sc(pkg, failover_retries=-1).validate_cluster()
    with pytest.raises(ValueError, match="migration_queue_budget"):
        sc(pkg, migration_queue_budget=-2).validate_cluster()


def test_llm_compile_specinfer_disagg_fails_at_construction(tiny):
    cfg, params = tiny["port"]
    llm = LLM(tl, cfg, params, device="cpu")
    with pytest.raises(ValueError, match="SpecInfer"):
        llm.compile(sc("port", **DISAGG), ssms=[SSM(tl, cfg, params, device="cpu")])
    assert llm.rm is None


def test_specinfer_replicated_cluster_serves_incremental_tokens(tiny):
    """SpecInfer composes with replicated clusters: each replica runs its
    own SSM mirror; greedy tokens equal incremental decoding's."""
    cfg, params = tiny["port"]
    llm = LLM(tl, cfg, params, device="cpu")
    llm.compile(sc("port", max_spec_tree_tokens=64, **RR2),
                ssms=[SSM(tl, cfg, params, device="cpu")])
    assert isinstance(llm.rm, ClusterManager)
    outs = llm.generate(PROMPTS, max_new_tokens=6)
    assert [r.output_tokens for r in outs] == bare_outputs(tiny, n_new=6)
    assert {r.profile.replica_id for r in outs} == {0, 1}


def test_flight_recorder_dumps_the_dead_replicas_lane(tiny, tmp_path):
    from flexflow_tpu_torch import obs as tobs

    cm = build(tiny, "port", **RR2)
    rec = tobs.FlightRecorder(out_dir=str(tmp_path))
    tobs.attach_observability(cm, recorder=rec)
    cm.attach_faults(plan("port", ("crash", 1, 3, {})))
    assert all(r.error is None for r in cm.generate(PROMPTS, max_new_tokens=6))
    assert any("replica1" in p and "replica_down" in p for p in rec.paths), rec.paths
