"""Trace + metrics exporters (counterpart of
``flexflow_tpu/obs/export.py``; the metric names are the JAX package's,
letter for letter, so one scrape config reads either).

Two output formats, zero dependencies:

* **Chrome/Perfetto trace_event JSON** (:func:`chrome_trace` /
  :func:`write_chrome_trace`): every :class:`~.tracer.TraceBuffer` lane
  becomes one process row (``pid`` + a ``process_name`` metadata
  record), every event a complete ``"X"`` slice whose ``tid`` is its
  trace id — so one request's lifecycle reads as one row. Load the file
  in ``ui.perfetto.dev`` or ``chrome://tracing``.

* **Prometheus text format** (:func:`prometheus_text` /
  :func:`write_prometheus`): mechanically derived from the port's
  counter dataclasses — :class:`~flexflow_tpu_torch.metrics.SchedulerStats`
  (per-replica, labeled), :class:`~flexflow_tpu_torch.metrics.ClusterStats`,
  and per-request :class:`~flexflow_tpu_torch.serve.batch_config.ProfileInfo`
  aggregated to ``_sum`` series. The **drift guard**
  (:func:`check_export_coverage`) asserts every dataclass field is
  either exported or explicitly excluded (with the excluded set naming
  its replacement) — adding a counter to ``metrics.py`` without
  teaching the exporter fails tests/test_torch_obs.py, so the scrape
  surface can never silently fall behind the stats.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, Iterable, List, Mapping, Optional, Sequence

__all__ = [
    "ExportDriftError",
    "chrome_trace",
    "write_chrome_trace",
    "prometheus_text",
    "write_prometheus",
    "check_export_coverage",
]


# ---------------------------------------------------------------------------
# Chrome / Perfetto trace_event JSON

def chrome_trace(events: Iterable[Dict[str, Any]],
                 *, dropped: int = 0) -> Dict[str, Any]:
    """Render tracer events (see obs/tracer.py for the schema) as a
    ``{"traceEvents": [...]}`` document. Lanes map to pids in
    first-seen order; timestamps are microseconds of the wall clock
    half of the dual stamp (the deterministic ``step`` rides in
    ``args`` for tooling and tests)."""
    lanes: Dict[str, int] = {}
    out: List[Dict[str, Any]] = []
    for ev in events:
        lane = str(ev.get("lane", ""))
        pid = lanes.get(lane)
        if pid is None:
            pid = len(lanes) + 1
            lanes[lane] = pid
            out.append({
                "name": "process_name", "ph": "M", "pid": pid, "tid": 0,
                "args": {"name": lane or "untagged"},
            })
        tid = int(ev.get("trace_id", -1))
        args = {"step": ev.get("step", 0), "trace_id": tid}
        args.update(ev.get("attrs") or {})
        out.append({
            "name": str(ev.get("name", "event")),
            "ph": "X",
            "pid": pid,
            "tid": tid if tid >= 0 else 0,
            "ts": float(ev.get("t", 0.0)) * 1e6,
            "dur": float(ev.get("dur", 0.0)) * 1e6,
            "args": args,
        })
    doc: Dict[str, Any] = {"traceEvents": out, "displayTimeUnit": "ms"}
    if dropped:
        doc["flexflow_dropped_events"] = int(dropped)
    return doc


def write_chrome_trace(path: str, source) -> Dict[str, Any]:
    """Write ``source`` (a TraceBuffer or an event list) as a Chrome
    trace JSON file; returns the document."""
    events = getattr(source, "events", source)
    dropped = getattr(source, "dropped", 0)
    doc = chrome_trace(events, dropped=dropped)
    with open(path, "w") as f:
        json.dump(doc, f)
    return doc


# ---------------------------------------------------------------------------
# Prometheus text format — mechanically derived + drift-guarded

class ExportDriftError(AssertionError):
    """A stats dataclass field is neither exported nor explicitly
    excluded (or the exporter names a field that no longer exists) —
    the metrics surface drifted from the code."""


#: SchedulerStats fields exported verbatim as counters.
SCHED_COUNTERS = frozenset({
    "steps", "mixed_steps", "decode_steps", "sync_steps", "flushes",
    "pipeline_drains", "admitted", "preemptions", "failed",
    "prefill_tokens", "decode_tokens",
    "prefix_hits", "prefix_misses", "prefix_hit_tokens", "prefix_inserts",
    "prefix_evictions", "prefix_cows",
    "spills", "readmits", "host_hit_tokens",
    "spec_rounds", "spec_drafted", "spec_accepted", "spec_resizes",
    "verify_skipped_rounds", "spec_reprobes", "whole_step_fallbacks",
    # ring_steps (context-parallel ring hops) comes back with the
    # long-context slice (ROADMAP.md queue 1 item 9); compiles and
    # retraces (the retrace sentinel) with the analysis slice (item 12)
})
#: SchedulerStats fields exported as gauges. ``whole_step_smem_est`` is
#: the whole-step kernel's priced on-chip footprint in bytes (shared
#: memory a block on the card, VMEM a step on the TPU): the same figure,
#: so it keeps the JAX package's exported name (SCHED_EXPORT_NAMES).
#: cp_shards and shard_balance (the sequence-sharded pool) come back
#: with the long-context slice (item 9).
SCHED_GAUGES = frozenset({
    "host_bytes", "whole_step_smem_est",
})
#: SchedulerStats fields exported under another metric name.
SCHED_EXPORT_NAMES = {"whole_step_smem_est": "whole_step_vmem_est"}
#: SchedulerStats fields NOT exported verbatim — each maps to the
#: derived snapshot() gauge that replaces it on the scrape surface.
SCHED_EXCLUDED = {
    "occupancy_sum": "mean_occupancy",
    "budget_fill_sum": "mean_budget_fill",
    # the raw reservoir is host-side sample storage; the scrape surface
    # carries its derived percentiles
    "decode_step_ms_samples": "decode_step_ms_p50",
}
#: Derived snapshot() rates exported as gauges alongside the counters.
SCHED_DERIVED = (
    "mean_occupancy", "mean_budget_fill", "prefix_hit_rate",
    "host_hit_rate", "spec_accept_rate",
    "decode_step_ms_p50", "decode_step_ms_p99",
)

CLUSTER_COUNTERS = frozenset({
    "submitted", "affinity_hits", "sheds", "migrations", "migrated_pages",
    "migrated_bytes", "step_faults", "replica_down", "replica_suspect",
    "probes", "replica_recoveries", "failovers", "retries",
    "failover_errors", "migration_failures", "migration_queue_overflows",
    "rpc_errors", "rpc_retries", "heartbeat_gaps", "reconnects",
    "standby_adoptions", "wire_bytes_sent", "wire_bytes_received",
    "scale_outs", "scale_ins", "pool_flips", "journal_records",
    "journal_bytes", "journal_compactions", "manager_recoveries",
    "journal_replayed", "autoscale_decisions", "retunes",
})
CLUSTER_GAUGES = frozenset({
    "migration_queue_depth", "migration_queue_peak", "rpc_inflight_peak",
    "autoscale_predicted_tps", "autoscale_measured_tps",
})
#: ``placements`` is a by-how dict — exported as ONE labeled counter
#: series rather than a scalar field. The RTT/step-time reservoirs are
#: host-side sample storage; the scrape surface carries their derived
#: percentile properties (and per-replica RTT rides the labeled
#: ``flexflow_cluster_rpc_rtt_ms`` series).
CLUSTER_EXCLUDED = {
    "placements": "flexflow_cluster_placements{how=...}",
    "cluster_step_ms_samples": "cluster_step_ms_p50",
    "rpc_rtt_ms_samples": "rpc_rtt_ms_p50",
    # per-replica maps ride the snapshot's reconciliation dict; the
    # scalar scrape surface carries the summed counters + percentiles
    "arrivals_per_replica": "arrivals_completions_per_replica",
    "completions_per_replica": "arrivals_completions_per_replica",
    "queue_delay_s_samples": "queue_delay_s_p50",
}
#: Derived ClusterStats properties exported as gauges alongside the
#: raw counters (the percentile halves of the excluded reservoirs).
CLUSTER_DERIVED = (
    "cluster_step_ms_p50", "cluster_step_ms_p99",
    "rpc_rtt_ms_p50", "rpc_rtt_ms_p99",
    "queue_delay_s_p50", "queue_delay_s_p99",
)

#: ProfileInfo numeric fields aggregated to ``_sum`` counters over the
#: finished requests handed to the exporter.
PROFILE_SUMS = frozenset({
    "cached_prefix_len", "host_hit_tokens", "llm_decoding_steps",
    "ssm_decoding_steps", "speculated_tokens", "accepted_tokens",
    "spec_rounds", "tree_resizes", "retries", "transport_retries",
    "router_queue_delay_s",
})
#: ProfileInfo fields NOT aggregated — wall-clock stamps fold into the
#: derived latency/TTFT sums; identity/shape fields are per-request
#: routing facts with no meaningful sum.
PROFILE_EXCLUDED = {
    "start_time": "flexflow_request_latency_seconds_sum",
    "finish_time": "flexflow_request_latency_seconds_sum",
    "first_token_time": "flexflow_request_ttft_seconds_sum",
    "tree_width": "per-request shape, no meaningful sum",
    "tree_depth": "per-request shape, no meaningful sum",
    "draft_flops_per_token": "per-request draft pricing, no meaningful sum",
    "context_shards": "per-request layout fact, no meaningful sum",
    "replica_id": "per-request placement fact, no meaningful sum",
    "failover_replica_id": "per-request placement fact, no meaningful sum",
}


def _stats_classes():
    from ..metrics import ClusterStats, SchedulerStats
    from ..serve.batch_config import ProfileInfo

    return SchedulerStats, ClusterStats, ProfileInfo


def check_export_coverage() -> None:
    """The drift guard: every ``SchedulerStats`` / ``ClusterStats`` /
    ``ProfileInfo`` dataclass field must be exported or explicitly
    excluded, exactly once, and the exporter must not name fields that
    no longer exist. Raises :class:`ExportDriftError` naming the
    drifted fields."""
    SchedulerStats, ClusterStats, ProfileInfo = _stats_classes()
    specs = (
        ("SchedulerStats", SchedulerStats,
         SCHED_COUNTERS | SCHED_GAUGES, set(SCHED_EXCLUDED)),
        ("ClusterStats", ClusterStats,
         CLUSTER_COUNTERS | CLUSTER_GAUGES, set(CLUSTER_EXCLUDED)),
        ("ProfileInfo", ProfileInfo, set(PROFILE_SUMS),
         set(PROFILE_EXCLUDED)),
    )
    problems: List[str] = []
    for name, cls, exported, excluded in specs:
        fields = {f.name for f in dataclasses.fields(cls)}
        missing = fields - exported - excluded
        stale = (exported | excluded) - fields
        overlap = exported & excluded
        if missing:
            problems.append(
                f"{name}: field(s) {sorted(missing)} are neither "
                "exported nor excluded — add them to the exporter maps "
                "in obs/export.py (or the excluded set, naming the "
                "replacement)"
            )
        if stale:
            problems.append(
                f"{name}: exporter names field(s) {sorted(stale)} that "
                "no longer exist on the dataclass"
            )
        if overlap:
            problems.append(
                f"{name}: field(s) {sorted(overlap)} are both exported "
                "and excluded"
            )
    if problems:
        raise ExportDriftError("\n".join(problems))


def _fmt(value: Any) -> str:
    v = float(value)
    return repr(int(v)) if v == int(v) else repr(v)


def _labels(labels: Dict[str, str]) -> str:
    if not labels:
        return ""
    body = ",".join(f'{k}="{v}"' for k, v in sorted(labels.items()))
    return "{" + body + "}"


class _Lines:
    """Prometheus text assembler: one ``# TYPE`` header per metric, in
    first-emission order."""

    def __init__(self):
        self.lines: List[str] = []
        self._typed: set = set()

    def add(self, metric: str, mtype: str, value: Any,
            labels: Optional[Dict[str, str]] = None) -> None:
        if metric not in self._typed:
            self._typed.add(metric)
            self.lines.append(f"# TYPE {metric} {mtype}")
        self.lines.append(f"{metric}{_labels(labels or {})} {_fmt(value)}")

    def text(self) -> str:
        return "\n".join(self.lines) + "\n"


def prometheus_text(
    *,
    scheduler: Optional[Mapping[str, Any]] = None,
    cluster: Any = None,
    profiles: Sequence[Any] = (),
) -> str:
    """Render a Prometheus text-format snapshot.

    ``scheduler`` maps a replica label to a SchedulerStats-shaped
    object (anything with ``snapshot()``); ``cluster`` is a ClusterStats; ``profiles`` are finished
    requests' ProfileInfo objects. The drift guard runs first, so a
    snapshot can never be produced from a drifted exporter."""
    check_export_coverage()
    out = _Lines()
    for label, stats in (scheduler or {}).items():
        snap = stats.snapshot()
        labels = {"replica": str(label)}
        for field in sorted(SCHED_COUNTERS):
            out.add(f"flexflow_scheduler_{field}", "counter",
                    snap.get(field, 0), labels)
        for field in sorted(SCHED_GAUGES) + list(SCHED_DERIVED):
            name = SCHED_EXPORT_NAMES.get(field, field)
            out.add(f"flexflow_scheduler_{name}", "gauge",
                    snap.get(field, 0), labels)
    if cluster is not None:
        for field in sorted(CLUSTER_COUNTERS):
            out.add(f"flexflow_cluster_{field}", "counter",
                    getattr(cluster, field))
        for field in sorted(CLUSTER_GAUGES) + list(CLUSTER_DERIVED):
            out.add(f"flexflow_cluster_{field}", "gauge",
                    getattr(cluster, field))
        for how, n in sorted(cluster.placements.items()):
            out.add("flexflow_cluster_placements", "counter", n,
                    {"how": str(how)})
        for idx, pcts in cluster.rpc_rtt_ms_per_replica().items():
            for q, v in sorted(pcts.items()):
                out.add("flexflow_cluster_rpc_rtt_ms", "gauge", v,
                        {"replica": str(idx), "quantile": q})
    if profiles:
        out.add("flexflow_requests_total", "counter", len(profiles))
        for field in sorted(PROFILE_SUMS):
            out.add(
                f"flexflow_request_{field}_sum", "counter",
                sum(getattr(p, field) for p in profiles),
            )
        out.add("flexflow_request_latency_seconds_sum", "counter",
                sum(p.latency_s for p in profiles))
        out.add("flexflow_request_ttft_seconds_sum", "counter",
                sum(p.ttft_s for p in profiles))
        out.add(
            "flexflow_request_first_token_observed_total", "counter",
            sum(1 for p in profiles if p.first_token_time),
        )
    return out.text()


def write_prometheus(path: str, **kw) -> str:
    text = prometheus_text(**kw)
    with open(path, "w") as f:
        f.write(text)
    return text
