"""The port's observability layer (flexflow_tpu_torch/obs, metrics.ClusterStats,
profiling.StepTimes, the engine's dispatch count, the output file and the
serve command's export flags) against the JAX package's on the same
inputs: unit parity of the tracer, the flight recorder, the exporters and
the stats; lifecycle parity of a tiny f32 LLaMA served by both (JAX's XLA
path, the port's plain path on the CPU) — event streams, ProfileInfo,
dispatch kinds and counts, the Prometheus text, the output file; disabled
tracing is free; no event argument reads a device tensor."""
import ast
import collections
import dataclasses
import json
import pathlib
import re
import subprocess
import sys
import tracemalloc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flexflow_tpu import metrics as jmetrics
from flexflow_tpu import obs as jobs
from flexflow_tpu import profiling as jprofiling
from flexflow_tpu.models import llama as jl
from flexflow_tpu.obs import flight_recorder as jfr
from flexflow_tpu.serve import InferenceEngine as JaxEngine
from flexflow_tpu.serve import RequestManager as JaxRM
from flexflow_tpu.serve import ServingConfig as JaxServingConfig
from flexflow_tpu.serve import SpecConfig as JaxSpecConfig
from flexflow_tpu.serve import SpecInferManager as JaxSpecInferManager
from flexflow_tpu.serve.batch_config import ProfileInfo as JaxProfileInfo
from flexflow_tpu_torch import metrics as tmetrics
from flexflow_tpu_torch import obs as tobs
from flexflow_tpu_torch import profiling as tprofiling
from flexflow_tpu_torch.models import llama as tl
from flexflow_tpu_torch.obs import export as texport
from flexflow_tpu_torch.obs import flight_recorder as tfr
from flexflow_tpu_torch.obs.tracer import NullTracer
from flexflow_tpu_torch.serve import InferenceEngine, RequestManager, ServingConfig
from flexflow_tpu_torch.serve.batch_config import ProfileInfo
from flexflow_tpu_torch.serve.specinfer import SpecConfig, SpecInferManager

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent
PROMPTS = [[3, 17, 91, 42, 7], [9, 8, 7, 6, 5, 4], [1, 2, 3, 4, 5, 6, 7, 8, 9], [11, 22, 33]]
NEW = 6
#: metrics the JAX package exports and the port does not have yet (the
#: long-context and analysis slices' SchedulerStats fields), and the
#: wall-clock figures, which two runs never share
JAX_ONLY = ("ring_steps", "compiles", "retraces", "cp_shards", "shard_balance")
WALL = ("decode_step_ms_p50", "decode_step_ms_p99", "latency_seconds_sum",
        "ttft_seconds_sum")
#: ProfileInfo's wall-clock stamps
TIMES = ("start_time", "finish_time", "first_token_time")


@pytest.fixture(scope="module")
def weights():
    cfg_j = jl.LLaMAConfig.tiny(dtype=jnp.float32)
    params_j = jl.init_params(jax.random.PRNGKey(0), cfg_j)
    cfg_t = tl.LLaMAConfig.tiny(dtype=torch.float32)
    params_t = tl.params_from_numpy(jax.tree.map(np.asarray, params_j), device="cpu")
    return cfg_j, params_j, cfg_t, params_t


def _serve_kw(**kw):
    base = dict(max_requests_per_batch=4, max_sequence_length=96, prefill_chunk=8,
                max_spec_tree_tokens=8, kv_layout="paged", page_size=16)
    base.update(kw)
    return base


# ---------------------------------------------------------------------------
# unit parity: one case list through both packages


def _strip(events):
    """Events without their wall stamp (the half of the dual clock two
    runs never share); a span's duration becomes whether it is >= 0."""
    out = []
    for e in events:
        e = dict(e)
        e.pop("t", None)
        e["dur"] = e["dur"] >= 0.0 if e["name"].startswith("span") else e["dur"]
        out.append(e)
    return out


def _tracer_case(obs):
    steps = [7]
    buf = obs.TraceBuffer(capacity=4)
    tr = buf.tracer("laneA", clock=lambda: steps[0])
    tr.event("admit", trace_id=3, rid=9, slot=1)
    steps[0] = 8
    with tr.span("span_ok", trace_id=3, lane="laneB", n=2):
        pass
    try:
        with tr.span("span_err", trace_id=4):
            raise KeyError("x")
    except KeyError:
        pass
    tr.event("explicit", step=42, t=1.5, dur=0.25)
    for i in range(3):
        tr.event(f"e{i}", k=i)
    kept, dropped = _strip(buf.events), buf.dropped
    shipped = _strip(buf.drain())
    buf.extend([{"name": "r", "lane": "", "trace_id": 1, "t": 0.0, "step": 0, "dur": 0.0},
                {"name": "s", "lane": "keep", "trace_id": 2, "t": 0.0, "step": 1, "dur": 0.0}],
               lane="replica9")
    null = obs.NULL_TRACER
    null.event("anything", x=1)
    with null.span("s"):
        pass
    return {"kept": kept, "dropped": dropped, "shipped": shipped, "after_drain": buf.events,
            "enabled": (buf.enabled, tr.enabled, null.enabled, null.lane),
            "lanes": (tr.lane, buf.capacity)}


def test_tracer_and_buffer_match_jax():
    """Capacity bound, drain, extend's lane re-tagging, lanes, spans (with
    and without an error), explicit stamps and the null tracer: the same
    events, wall stamps aside."""
    got, want = _tracer_case(tobs), _tracer_case(jobs)
    assert got == want
    assert got["dropped"] == 3 and len(got["kept"]) == 4


def _recorder_case(obs, fr, out_dir):
    rec = obs.FlightRecorder(capacity=4, out_dir=str(out_dir))
    buf = obs.TraceBuffer()
    buf.recorder = rec
    tr = buf.tracer("engine", clock=lambda: 5)
    for i in range(10):
        tr.event(f"e{i}", trace_id=i, tokens=[1, 2, 3], prompt="secret", text="t", n=i)
    tr.event("boom", lane="other", output_text="x", rid=3)
    tr.event("plain", k=1)
    doc = rec.dump("engine", "request_error", step=12, extra={"rid": 7, "error": "e"})
    other = rec.dump("other", "replica_down")
    files = sorted(p.name for p in out_dir.iterdir())
    contents = [json.loads((out_dir / f).read_text()) for f in files]
    plain = {"name": "x", "lane": "l", "trace_id": 1, "t": 0.0, "step": 0, "dur": 0.0}
    return {"ring": _strip(rec.events("engine")), "doc": _strip_doc(doc),
            "other": _strip_doc(other), "files": files,
            "contents": [_strip_doc(c) for c in contents],
            "for_engine": len(rec.dumps_for("engine")), "redacted_attrs": sorted(fr.REDACTED_ATTRS),
            "plain": fr.redact_event(plain) == plain}


def _strip_doc(doc):
    return dict(doc, events=_strip(doc["events"]))


def test_flight_recorder_matches_jax(tmp_path):
    """The per-lane ring bound, redaction (user content stripped, the
    marker set, other attributes kept), dumps in memory and on disk."""
    (tmp_path / "t").mkdir()
    (tmp_path / "j").mkdir()
    got = _recorder_case(tobs, tfr, tmp_path / "t")
    want = _recorder_case(jobs, jfr, tmp_path / "j")
    assert got == want
    assert [e["name"] for e in got["doc"]["events"]] == ["e7", "e8", "e9", "plain"]
    for ev in got["doc"]["events"][:3]:
        assert ev["attrs"]["redacted"] is True and "tokens" not in ev["attrs"]
        assert ev["attrs"]["n"] >= 7


EVENTS = [
    {"name": "a", "lane": "engine", "trace_id": 5, "t": 1.0, "step": 2, "dur": 0.5,
     "attrs": {"k": 1}},
    {"name": "b", "lane": "wire", "trace_id": -1, "t": 2.0, "step": 3, "dur": 0.0},
    {"name": "c", "lane": "", "trace_id": 5, "t": 2.5, "step": 4, "dur": 0.125,
     "attrs": {"s": "x"}},
]


def test_chrome_trace_matches_jax(tmp_path):
    assert tobs.chrome_trace(EVENTS, dropped=3) == jobs.chrome_trace(EVENTS, dropped=3)
    buf_t, buf_j = tobs.TraceBuffer(), jobs.TraceBuffer()
    buf_t.events, buf_j.events = list(EVENTS), list(EVENTS)
    got = tobs.write_chrome_trace(str(tmp_path / "t.json"), buf_t)
    want = jobs.write_chrome_trace(str(tmp_path / "j.json"), buf_j)
    assert got == want
    assert json.loads((tmp_path / "t.json").read_text()) == json.loads(
        (tmp_path / "j.json").read_text())


def _drop_metrics(text, names):
    """Prometheus text without the samples (and TYPE headers) of metrics
    whose name holds any of ``names``."""
    def metric(line):
        return line.split()[2] if line.startswith("#") else line.split("{")[0].split()[0]
    return "\n".join(line for line in text.splitlines()
                     if not any(n in metric(line) for n in names))


#: a value for every field of the port's SchedulerStats
SCHED_VALUES = {
    f.name: ([1.5, 0.25, 3.0, 2.0] if f.name == "decode_step_ms_samples"
             else (i + 1) * 0.5 if f.type == "float" else i + 1)
    for i, f in enumerate(dataclasses.fields(tmetrics.SchedulerStats))}


def _sched_stats(cls):
    """A SchedulerStats of either package holding SCHED_VALUES (the JAX
    package's whole-step VMEM estimate holding the port's shared-memory
    one)."""
    s = cls()
    for name, v in SCHED_VALUES.items():
        if name == "whole_step_smem_est" and not hasattr(s, name):
            name = "whole_step_vmem_est"
        setattr(s, name, list(v) if isinstance(v, list) else v)
    return s


def _cluster_stats(cls):
    c = cls()
    c.submitted, c.migrations, c.rpc_inflight_peak = 7, 2, 3
    c.autoscale_predicted_tps = 12.5
    for how in ("prefix", "affinity", "prefix", "round_robin"):
        c.record_placement(how)
    for ms in (4.0, 1.0, 2.5):
        c.note_cluster_step_ms(ms)
    for r, ms in ((0, 1.0), (1, 3.0), (0, 2.0)):
        c.note_rpc_rtt_ms(r, ms)
    c.note_arrival(0)
    c.note_arrival(1)
    c.note_completion(0)
    c.note_queue_delay_s(-1.0)
    c.note_queue_delay_s(0.5)
    return c


PROFILES = [dict(start_time=1.0, first_token_time=1.5, finish_time=2.0, llm_decoding_steps=4,
                 cached_prefix_len=3, speculated_tokens=5, accepted_tokens=2),
            dict(start_time=2.0, first_token_time=0.0, finish_time=2.25, retries=1)]


def test_prometheus_text_and_cluster_stats_match_jax():
    """The same counters give the JAX package's Prometheus text, minus the
    metrics of fields the port has not yet (JAX_ONLY); the port exports
    its whole-step shared-memory estimate under JAX's
    ``whole_step_vmem_est`` name. ClusterStats' snapshot and report are
    JAX's."""
    sched_t, sched_j = _sched_stats(tmetrics.SchedulerStats), _sched_stats(
        jmetrics.SchedulerStats)
    clus_t, clus_j = _cluster_stats(tmetrics.ClusterStats), _cluster_stats(
        jmetrics.ClusterStats)
    prof_t = [ProfileInfo(**p) for p in PROFILES]
    prof_j = [JaxProfileInfo(**p) for p in PROFILES]
    got = tobs.prometheus_text(scheduler={"0": sched_t}, cluster=clus_t, profiles=prof_t)
    want = jobs.prometheus_text(scheduler={"0": sched_j}, cluster=clus_j, profiles=prof_j)
    assert got == _drop_metrics(want, JAX_ONLY) + "\n"
    assert f'flexflow_scheduler_whole_step_vmem_est{{replica="0"}} ' \
           f'{sched_t.whole_step_smem_est}' in got
    assert "smem" not in got
    # ClusterStats over the port's own scheduler stats
    snap_t = clus_t.snapshot([sched_t])
    snap_j = clus_j.snapshot([sched_j])
    for key in ("replicas", "per_replica"):
        snap_t.pop(key), snap_j.pop(key)
    assert snap_t == snap_j
    assert clus_t.report() == clus_j.report()
    agg_t = clus_t.snapshot([sched_t, sched_t])["replicas"]
    agg_j = clus_j.snapshot([sched_j, sched_j])["replicas"]
    agg_j["whole_step_smem_est"] = agg_j.pop("whole_step_vmem_est")
    assert agg_t == {k: v for k, v in agg_j.items() if k not in JAX_ONLY}


def test_step_times_match_jax():
    got, want = tprofiling.StepTimes(), jprofiling.StepTimes()
    assert got.report() == want.report() == "no steps recorded"
    for dt in (0.002, 0.0005, 0.004, 0.001, 0.0031):
        got.record(dt)
        want.record(dt)
    assert got.summary() == want.summary() and got.report() == want.report()


def test_trace_capture_writes_a_chrome_trace(tmp_path):
    with tprofiling.trace(str(tmp_path)):
        torch.ones(4).sum()
    with tprofiling.trace(str(tmp_path)):
        torch.ones(4).sum()
    names = sorted(p.name for p in tmp_path.iterdir())
    assert names == ["trace_0.json", "trace_1.json"]
    assert "traceEvents" in json.loads((tmp_path / names[0]).read_text())


def test_export_drift_guard_passes_on_the_port_fields():
    texport.check_export_coverage()
    exported = texport.SCHED_COUNTERS | texport.SCHED_GAUGES | set(texport.SCHED_EXCLUDED)
    assert exported == {f.name for f in dataclasses.fields(tmetrics.SchedulerStats)}


def test_export_drift_guard_catches_missing_and_stale(monkeypatch):
    monkeypatch.setattr(texport, "SCHED_COUNTERS",
                        frozenset(texport.SCHED_COUNTERS - {"admitted"}))
    with pytest.raises(texport.ExportDriftError, match="admitted"):
        texport.check_export_coverage()
    monkeypatch.setattr(texport, "SCHED_COUNTERS",
                        frozenset(texport.SCHED_COUNTERS | {"admitted", "bogus_field"}))
    with pytest.raises(texport.ExportDriftError, match="bogus_field"):
        texport.check_export_coverage()


def test_export_drift_guard_catches_a_new_port_field(monkeypatch):
    """A counter added to the port's SchedulerStats without teaching the
    exporter fails the guard (and so every Prometheus export)."""
    grown = dataclasses.make_dataclass("SchedulerStats", [("new_counter", int, 0)],
                                       bases=(tmetrics.SchedulerStats,))
    monkeypatch.setattr(texport, "_stats_classes",
                        lambda: (grown, tmetrics.ClusterStats, ProfileInfo))
    with pytest.raises(texport.ExportDriftError, match="new_counter"):
        texport.check_export_coverage()
    with pytest.raises(texport.ExportDriftError):
        texport.prometheus_text(scheduler={"0": tmetrics.SchedulerStats()})


def test_attach_observability_cluster_targets_raise(weights):
    """Cluster targets attach since the cluster slice: the manager's router
    lane and a replica's own lane; an unknown target still raises."""
    class Engine:
        tracer = None

    class Manager:
        _step_counter = 0

        def __init__(self):
            self.engine = Engine()

        def _engines(self):
            return [self.engine]

    class Replica:
        index = 3

        def __init__(self):
            self.rm = Manager()

    class Cluster:
        _step_counter = 0
        router = None

        def __init__(self):
            self.replicas, self.standbys = [Replica()], [Replica()]

    cluster = Cluster()
    tobs.attach_observability(cluster)
    assert cluster.tracer.lane == "router"
    for rep in cluster.replicas + cluster.standbys:
        assert rep.rm.tracer.lane == "replica3" and rep.rm.engine.tracer is rep.rm.tracer
    replica = Replica()
    tobs.attach_observability(replica)
    assert replica.rm.tracer.lane == "replica3"
    with pytest.raises(TypeError, match="unsupported target"):
        tobs.attach_observability(object())


# ---------------------------------------------------------------------------
# lifecycle parity: the same tiny LLaMA served by both packages


RUNS = {
    "dense-sync": dict(kv_layout="dense", continuous_batching=False),
    "dense-continuous": dict(kv_layout="dense"),
    # 9 pages of 4 tokens (one slot's worst case) against the ~16 the four
    # requests hold at their ends: preemption
    "paged-preempt": dict(max_sequence_length=24, page_size=4, max_cached_tokens=36),
    "paged-prefix": dict(prefix_caching=True),
    "specinfer": dict(kv_layout="dense", spec=True),
}


def _serve(pkg, weights, run, tmp_path):
    kw = dict(RUNS[run])
    spec = kw.pop("spec", False)
    cfg_j, params_j, cfg_t, params_t = weights
    out = str(tmp_path / f"{pkg}.txt")
    prompts = PROMPTS + [PROMPTS[0] + [5, 5]] if run == "paged-prefix" else PROMPTS
    if pkg == "jax":
        eng = JaxEngine(jl, cfg_j, params_j, JaxServingConfig(
            cache_dtype=jnp.float32, kernels="xla", **_serve_kw(**kw)))
        rm = (JaxSpecInferManager(eng, None, JaxSpecConfig(2, 3, draft="early_exit",
                                                           draft_layers=1), output_file=out)
              if spec else JaxRM(eng, output_file=out))
        buf = jobs.attach_observability(rm)
    else:
        eng = InferenceEngine(tl, cfg_t, params_t, ServingConfig(
            cache_dtype=torch.float32, kernels="torch", **_serve_kw(**kw)), device="cpu")
        rm = (SpecInferManager(eng, None, SpecConfig(2, 3, draft="early_exit", draft_layers=1),
                               output_file=out)
              if spec else RequestManager(eng, output_file=out))
        buf = tobs.attach_observability(rm)
    outs = rm.generate(prompts, max_new_tokens=NEW)
    text = (tobs if pkg == "torch" else jobs).prometheus_text(
        scheduler={"0": rm.stats}, profiles=[o.profile for o in outs])
    return dict(outs=outs, events=buf.events, dispatch=eng.dispatch_count, prom=text,
                file=re.sub(r"latency\([0-9.]+\)", "latency()", open(out).read()))


def _key(e):
    return (e["name"], e["lane"], e["trace_id"], e["step"],
            tuple(sorted((e.get("attrs") or {}).items())))


@pytest.mark.parametrize("run", list(RUNS))
def test_lifecycle_matches_jax(weights, run, tmp_path):
    """Both packages serve the same tokens and trace the same run: every
    request's events in the same order on the same step stamps with the
    same attributes, the same dispatches by kind (the engine's
    ``dispatch_count`` as JAX's), the same ProfileInfo (wall stamps
    aside), the same Prometheus text (JAX_ONLY and wall figures aside)
    and the same output file (latencies aside). A SpecInfer round
    interleaves differently across requests: the port commits the round's
    accepted lines before it appends their tokens (so that a request that
    completes publishes committed pages), JAX appends first; so there the
    whole stream is held as a multiset and each request's own events in
    order."""
    got, want = _serve("torch", weights, run, tmp_path), _serve("jax", weights, run, tmp_path)
    assert [o.output_tokens for o in got["outs"]] == [o.output_tokens for o in want["outs"]]
    g, w = [_key(e) for e in got["events"]], [_key(e) for e in want["events"]]
    if run == "specinfer":
        assert collections.Counter(g) == collections.Counter(w)
    else:
        assert g == w
    for tid in {e["trace_id"] for e in want["events"] if e["trace_id"] >= 0}:
        assert [k for k in g if k[2] == tid] == [k for k in w if k[2] == tid], tid
    kinds = collections.Counter(e["attrs"]["kind"] for e in got["events"]
                                if e["name"] == "dispatch")
    assert kinds == collections.Counter(e["attrs"]["kind"] for e in want["events"]
                                        if e["name"] == "dispatch")
    assert got["dispatch"] == want["dispatch"] == sum(kinds.values())
    names = {e["name"] for e in got["events"]}
    assert {"admit", "first_token", "terminal", "dispatch"} <= names
    if run == "paged-preempt":
        assert "preempt" in names
    if run == "paged-prefix":
        assert "prefix_lookup" in names and got["outs"][-1].profile.cached_prefix_len > 0
    if run == "specinfer":
        assert {"spec_draft", "spec_verify"} <= names
    for a, b in zip(got["outs"], want["outs"]):
        pa, pb = dataclasses.asdict(a.profile), dataclasses.asdict(b.profile)
        for t in TIMES:
            pa.pop(t), pb.pop(t)
        assert pa == pb
        assert 0 < a.profile.start_time <= a.profile.first_token_time <= a.profile.finish_time
    assert _drop_metrics(got["prom"], WALL) == _drop_metrics(want["prom"], JAX_ONLY + WALL)
    assert got["file"] == want["file"]
    assert got["file"].count("[Profile]") == len(got["outs"])


# ---------------------------------------------------------------------------
# disabled tracing is free


@pytest.mark.parametrize("kw", [dict(kv_layout="dense", continuous_batching=False), {}],
                         ids=["sync", "pipelined"])
def test_disabled_tracing_is_free(weights, kw):
    """With tracing off no tracer method runs (every emission site guards
    on ``.enabled``: NullTracer made to raise), the step loop allocates
    nothing from obs/ frames, and a traced run dispatches the same engine
    calls and serves the same tokens."""
    cfg_t, params_t = weights[2], weights[3]

    def make():
        return RequestManager(InferenceEngine(tl, cfg_t, params_t, ServingConfig(
            cache_dtype=torch.float32, kernels="torch", **_serve_kw(**kw)), device="cpu"))

    def boom(self, *a, **k):
        raise AssertionError("tracer invoked while disabled: an emission site lacks "
                             "its `.enabled` guard")

    rm_off = make()
    old = NullTracer.event, NullTracer.span
    NullTracer.event = NullTracer.span = boom
    try:
        tracemalloc.start()
        outs_off = rm_off.generate(PROMPTS, max_new_tokens=NEW)
        snap = tracemalloc.take_snapshot()
    finally:
        tracemalloc.stop()
        NullTracer.event, NullTracer.span = old
    obs_allocs = snap.filter_traces(
        [tracemalloc.Filter(True, "*flexflow_tpu_torch*obs*")]).statistics("filename")
    assert not obs_allocs, f"disabled tracing allocated host memory: {obs_allocs}"
    rm_on = make()
    buf = tobs.attach_observability(rm_on)
    outs_on = rm_on.generate(PROMPTS, max_new_tokens=NEW)
    assert [o.output_tokens for o in outs_on] == [o.output_tokens for o in outs_off]
    assert rm_on.engine.dispatch_count == rm_off.engine.dispatch_count > 0
    assert sum(e["name"] == "dispatch" for e in buf.events) == rm_on.engine.dispatch_count


def test_request_error_dumps_one_redacted_flight_record(weights, tmp_path):
    """A request that fails admission (its prompt over the KV budget)
    ends in an error and leaves one redacted dump; the others finish and
    each leaves one output-file record."""
    cfg_t, params_t = weights[2], weights[3]
    eng = InferenceEngine(tl, cfg_t, params_t, ServingConfig(
        cache_dtype=torch.float32, kernels="torch",
        **_serve_kw(max_cached_tokens=64, page_size=16)), device="cpu")
    rm = RequestManager(eng, output_file=str(tmp_path / "out.txt"))
    rec = tobs.FlightRecorder(out_dir=str(tmp_path / "fr"))
    tobs.attach_observability(rm, recorder=rec)
    outs = rm.generate(PROMPTS[:2] + [list(range(1, 81))], max_new_tokens=NEW)
    assert [o.error is None for o in outs] == [True, True, False]
    assert len(rec.dumps) == 1 and len(rec.paths) == 1
    doc = json.loads(pathlib.Path(rec.paths[0]).read_text())
    assert doc["reason"] == "request_error" and doc["rid"] == outs[2].request_id
    assert doc["events"][-1]["name"] == "terminal"
    assert all(not (tfr.REDACTED_ATTRS & (e.get("attrs") or {}).keys())
               for e in doc["events"])
    assert (tmp_path / "out.txt").read_text().count("[Profile]") == 2


# ---------------------------------------------------------------------------
# the serve command's export flags


def test_serve_command_writes_the_four_exports(tmp_path):
    """``serve --trace-out --metrics-out --flight-recorder --output-file``
    on the CPU: a Chrome trace, a Prometheus snapshot whose every sample
    parses, one flight-recorder dump (the request over the KV budget) and
    one output record for the request that finished."""
    long_prompt = ",".join(str(t) for t in range(1, 101))
    cmd = [sys.executable, "-m", "flexflow_tpu_torch", "serve", "--device", "cpu",
           "--kernels", "torch", "--kv-layout", "paged", "--page-size", "16",
           "--max-cached-tokens", "64", "--max-new-tokens", "3",
           "--prompt", "3,17,91", "--prompt", long_prompt,
           "--trace-out", str(tmp_path / "trace.json"),
           "--metrics-out", str(tmp_path / "metrics.prom"),
           "--flight-recorder", str(tmp_path / "fr"),
           "-output-file", str(tmp_path / "out.txt")]
    res = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=240)
    assert res.returncode == 0, res.stderr[-2000:]
    trace = json.loads((tmp_path / "trace.json").read_text())
    assert {e["name"] for e in trace["traceEvents"]} >= {"admit", "terminal", "dispatch"}
    samples = [line for line in (tmp_path / "metrics.prom").read_text().splitlines()
               if not line.startswith("#")]
    assert samples and all(re.fullmatch(r"flexflow_\w+(\{[^}]*\})? -?[0-9.e+-]+", s)
                           for s in samples)
    assert 'flexflow_scheduler_failed{replica="0"} 1' in samples
    dumps = list((tmp_path / "fr").iterdir())
    assert len(dumps) == 1 and json.loads(dumps[0].read_text())["reason"] == "request_error"
    out = (tmp_path / "out.txt").read_text()
    assert out.count("[Profile]") == 1 and "tokens(3 17 91 " in out


# ---------------------------------------------------------------------------
# event arguments are host values: the port's twin of JAX's FF108 rule

#: calls that read a device tensor to the host, or make one
SYNC_METHODS = {"item", "tolist", "cpu", "numpy", "to", "synchronize"}
SYNC_NAMES = {"np", "numpy", "torch"}


def _emissions(tree):
    """Every ``<tracer>.event(...)`` / ``<tracer>.span(...)`` call (a
    receiver named tr or tracer, or an attribute ``.tracer``), with
    whether an enclosing ``if`` tests ``.enabled``."""
    out = []

    def walk(node, guarded):
        if isinstance(node, ast.If):
            test = ast.dump(node.test)
            g = guarded or "attr='enabled'" in test
            walk(node.test, guarded)
            for child in node.body:
                walk(child, g)
            for child in node.orelse:
                walk(child, guarded)
            return
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute) and \
                node.func.attr in ("event", "span"):
            recv = node.func.value
            name = recv.id if isinstance(recv, ast.Name) else (
                recv.attr if isinstance(recv, ast.Attribute) else None)
            if name in ("tr", "tracer"):
                out.append((node, guarded))
        for child in ast.iter_child_nodes(node):
            walk(child, guarded)

    walk(tree, False)
    return out


def _sync_calls(call):
    bad = []
    for arg in list(call.args) + [kw.value for kw in call.keywords]:
        for node in ast.walk(arg):
            if not isinstance(node, ast.Call):
                continue
            f = node.func
            if isinstance(f, ast.Attribute) and f.attr in SYNC_METHODS:
                bad.append(f.attr)
            elif isinstance(f, ast.Attribute) and isinstance(f.value, ast.Name) and \
                    f.value.id in SYNC_NAMES:
                bad.append(f"{f.value.id}.{f.attr}")
    return bad


def _port_sources():
    pkg = REPO / "flexflow_tpu_torch"
    return sorted(p for p in pkg.rglob("*.py")
                  if "_build" not in p.parts and "obs" not in p.relative_to(pkg).parts)


def test_event_arguments_never_read_a_device_tensor():
    """Every emission site of the port (outside obs/ itself) is guarded by
    ``tracer.enabled`` and builds its arguments from host values: no
    ``.item()``, ``.tolist()``, ``.cpu()``, ``.numpy()``, ``.to()`` and no
    numpy or torch call inside an argument (each would sync the pipelined
    decode path it traces)."""
    sites = 0
    for path in _port_sources():
        for call, guarded in _emissions(ast.parse(path.read_text())):
            sites += 1
            where = f"{path.relative_to(REPO)}:{call.lineno}"
            assert guarded, f"{where}: emission without an `.enabled` guard"
            assert not _sync_calls(call), f"{where}: {_sync_calls(call)} in an event argument"
    # the serve stack's sites: admit, prefix_lookup, preempt, terminal,
    # first_token, decode_step, prefill_chunk, mixed_step, flush,
    # sync_step, dispatch, spec_draft, spec_verify, adopt; the cluster's:
    # place, place_failed, health, request_error, failover,
    # recompute_readmit, probe, migrate, abandon
    assert sites == 23


def test_walk_catches_unguarded_and_syncing_events():
    bad = ast.parse("def f(self, toks):\n"
                    "    tr = self.tracer\n"
                    "    if tr.enabled:\n"
                    "        tr.event('x', tok=toks.item(), n=np.asarray(toks).sum())\n"
                    "    self.tracer.event('y', rows=3)\n")
    (first, g1), (second, g2) = _emissions(bad)
    assert g1 and _sync_calls(first) == ["item", "np.asarray"]
    assert not g2 and not _sync_calls(second)
