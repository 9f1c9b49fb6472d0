"""Serving telemetry: the scheduler's :class:`SchedulerStats` (a subset
of ``flexflow_tpu/metrics.py:SchedulerStats``) and the cluster's
:class:`ClusterStats` (copied; the cluster slice drives it, the
Prometheus exporter obs/export.py reads it).

The counters of context parallelism and the retrace sentinel come with
the slices that port those features; ``compute_metrics`` and
``PerfMetrics`` (the training metrics) wait for the training-API slice.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence

#: decode_step_ms reservoir bound (SchedulerStats.note_decode_step_ms)
_DECODE_MS_CAP = 4096


@dataclasses.dataclass
class SchedulerStats:
    """Host-side continuous-batching telemetry aggregated per scheduler
    step: slot occupancy, prefill token-budget fill, pipeline behavior
    (drains = full flushes, the sync points continuous batching exists
    to avoid), and request lifecycle counters. The RequestManager
    updates it on every dispatch/flush."""

    steps: int = 0
    mixed_steps: int = 0          # pipelined mixed prefill+decode steps
    decode_steps: int = 0         # pipelined pure-decode steps
    sync_steps: int = 0           # blocking host-round-trip steps
    flushes: int = 0              # in-flight entries drained to host
    pipeline_drains: int = 0      # full _flush_all with work in flight
    admitted: int = 0
    preemptions: int = 0          # paged pool exhausted: recompute preemptions
    failed: int = 0               # requests ended with an error
    prefill_tokens: int = 0       # chunk tokens dispatched
    decode_tokens: int = 0        # decode tokens dispatched
    occupancy_sum: float = 0.0    # active slots / total, summed per step
    budget_fill_sum: float = 0.0  # prefill tokens / budget, per mixed step
    # Automatic prefix caching (serve/prefix_cache.py): admissions that
    # reused cached KV pages and cold admissions, tokens whose prefill the
    # cache skipped, pages published to and evicted from the radix tree,
    # and copy-on-write page copies of partially matched tails.
    prefix_hits: int = 0
    prefix_misses: int = 0
    prefix_hit_tokens: int = 0
    prefix_inserts: int = 0
    prefix_evictions: int = 0
    prefix_cows: int = 0
    # The host tier (ServingConfig.host_cache_bytes): pages spilled to
    # host memory instead of evicted, pages re-admitted on a later match,
    # prompt tokens whose prefill a host hit skipped (also per request in
    # ProfileInfo.host_hit_tokens), and the tier's bytes now (a gauge).
    spills: int = 0
    readmits: int = 0
    host_hit_tokens: int = 0
    host_bytes: int = 0
    # Host wall time of each decode step's engine call, in ms: on the
    # pipelined path the dispatch cost (the device runs ahead and no sync
    # is added), on the sync path the full blocking step. Bounded
    # reservoir (newest _DECODE_MS_CAP samples).
    decode_step_ms_samples: List[float] = dataclasses.field(
        default_factory=list
    )
    # Whole-step kernel gate (serve/engine._whole_step_smem_gate): step
    # shapes the gate sent back to the per-layer path because no legal
    # tiling fit the budget (healthy serving keeps it 0), and its priced
    # decode footprint in bytes. Mirrored from the engine at every
    # dispatch.
    whole_step_fallbacks: int = 0
    whole_step_smem_est: int = 0
    # SpecInfer (serve/specinfer.py): per-request verify rounds, tree
    # tokens the draft proposed, drafted tokens the verifier accepted
    # (root and bonus tokens in neither; ProfileInfo.speculated_tokens),
    # and the W×D ladder moves of the adaptive tree controllers.
    spec_rounds: int = 0
    spec_drafted: int = 0
    spec_accepted: int = 0
    spec_resizes: int = 0
    # Verify-skip (SpecConfig.verify_skip): request-rounds that rode the
    # incremental decode step instead of a tree (cold draft), and the
    # periodic smallest-rung rounds that measure the draft again.
    verify_skipped_rounds: int = 0
    spec_reprobes: int = 0

    def record_step(
        self,
        kind: str,                # "mixed" | "decode" | "sync"
        *,
        active_slots: int,
        num_slots: int,
        prefill_tokens: int = 0,
        decode_tokens: int = 0,
        budget: int = 0,
    ) -> None:
        self.steps += 1
        if kind == "mixed":
            self.mixed_steps += 1
            if budget > 0:
                self.budget_fill_sum += prefill_tokens / budget
        elif kind == "decode":
            self.decode_steps += 1
        else:
            self.sync_steps += 1
        self.prefill_tokens += int(prefill_tokens)
        self.decode_tokens += int(decode_tokens)
        if num_slots > 0:
            self.occupancy_sum += active_slots / num_slots

    def note_decode_step_ms(self, ms: float) -> None:
        """Record one decode-step wall sample (bounded reservoir)."""
        s = self.decode_step_ms_samples
        s.append(float(ms))
        if len(s) > _DECODE_MS_CAP:
            del s[: len(s) - _DECODE_MS_CAP]

    def _decode_ms_pct(self, q: float) -> float:
        s = self.decode_step_ms_samples
        if not s:
            return 0.0
        ordered = sorted(s)
        idx = min(len(ordered) - 1, int(round(q * (len(ordered) - 1))))
        return ordered[idx]

    @property
    def decode_step_ms_p50(self) -> float:
        return self._decode_ms_pct(0.50)

    @property
    def decode_step_ms_p99(self) -> float:
        return self._decode_ms_pct(0.99)

    @property
    def prefix_hit_rate(self) -> float:
        """Fraction of admissions that reused at least one cached page."""
        n = self.prefix_hits + self.prefix_misses
        return self.prefix_hits / n if n else 0.0

    @property
    def host_hit_rate(self) -> float:
        """Fraction of the prefix cache's hit tokens served from the host
        tier (re-admitted spilled pages) rather than live device pages."""
        if not self.prefix_hit_tokens:
            return 0.0
        return self.host_hit_tokens / self.prefix_hit_tokens

    @property
    def spec_accept_rate(self) -> float:
        """Drafted tokens the verifier accepted over drafted tokens (the
        free root and bonus tokens on neither side)."""
        if not self.spec_drafted:
            return 0.0
        return self.spec_accepted / self.spec_drafted

    @property
    def mean_occupancy(self) -> float:
        return self.occupancy_sum / self.steps if self.steps else 0.0

    @property
    def mean_budget_fill(self) -> float:
        return (
            self.budget_fill_sum / self.mixed_steps if self.mixed_steps else 0.0
        )

    def snapshot(self) -> Dict[str, float]:
        return {
            "steps": self.steps,
            "mixed_steps": self.mixed_steps,
            "decode_steps": self.decode_steps,
            "sync_steps": self.sync_steps,
            "flushes": self.flushes,
            "pipeline_drains": self.pipeline_drains,
            "admitted": self.admitted,
            "preemptions": self.preemptions,
            "failed": self.failed,
            "prefill_tokens": self.prefill_tokens,
            "decode_tokens": self.decode_tokens,
            "mean_occupancy": round(self.mean_occupancy, 4),
            "mean_budget_fill": round(self.mean_budget_fill, 4),
            "prefix_hits": self.prefix_hits,
            "prefix_misses": self.prefix_misses,
            "prefix_hit_tokens": self.prefix_hit_tokens,
            "prefix_hit_rate": round(self.prefix_hit_rate, 4),
            "prefix_inserts": self.prefix_inserts,
            "prefix_evictions": self.prefix_evictions,
            "prefix_cows": self.prefix_cows,
            "spills": self.spills,
            "readmits": self.readmits,
            "host_hit_tokens": self.host_hit_tokens,
            "host_hit_rate": round(self.host_hit_rate, 4),
            "host_bytes": self.host_bytes,
            "decode_step_ms_p50": round(self.decode_step_ms_p50, 3),
            "decode_step_ms_p99": round(self.decode_step_ms_p99, 3),
            "whole_step_fallbacks": self.whole_step_fallbacks,
            "whole_step_smem_est": self.whole_step_smem_est,
            "spec_rounds": self.spec_rounds,
            "spec_drafted": self.spec_drafted,
            "spec_accepted": self.spec_accepted,
            "spec_resizes": self.spec_resizes,
            "verify_skipped_rounds": self.verify_skipped_rounds,
            "spec_reprobes": self.spec_reprobes,
            "spec_accept_rate": round(self.spec_accept_rate, 4),
        }

    def report(self) -> str:
        s = self.snapshot()
        return (
            f"[serve {s['steps']} steps] "
            f"mixed={s['mixed_steps']} decode={s['decode_steps']} "
            f"sync={s['sync_steps']} drains={s['pipeline_drains']} "
            f"occ={s['mean_occupancy']:.2f} fill={s['mean_budget_fill']:.2f} "
            f"prefill_toks={s['prefill_tokens']} "
            f"decode_toks={s['decode_tokens']} adm={s['admitted']} "
            f"preempt={s['preemptions']} failed={s['failed']} "
            f"pfx_hit={s['prefix_hits']}/{s['prefix_hits'] + s['prefix_misses']}"
            f" pfx_toks={s['prefix_hit_tokens']} "
            f"pfx_evict={s['prefix_evictions']} pfx_cow={s['prefix_cows']} "
            f"spill={s['spills']} readmit={s['readmits']} "
            f"host_toks={s['host_hit_tokens']} host_B={s['host_bytes']} "
            f"spec={s['spec_accepted']}/{s['spec_drafted']}"
            f"@{s['spec_rounds']}r resize={s['spec_resizes']} "
            f"vskip={s['verify_skipped_rounds']} "
            f"reprobe={s['spec_reprobes']} "
            f"dstep_ms={s['decode_step_ms_p50']:.2f}/"
            f"{s['decode_step_ms_p99']:.2f}"
        )


@dataclasses.dataclass
class ClusterStats:
    """Cluster-level serving telemetry (serve/cluster/): the front-end
    router's own counters plus an aggregation hook over every replica's
    :class:`SchedulerStats`. The ClusterManager updates the router
    counters at placement/shed/migration time and passes the per-replica
    stats as CALLABLES (the same indirection SchedulerStats uses for the
    prefix cache and retrace guard), so bench-style stat swaps
    (``rm.stats = SchedulerStats()``) keep counting."""

    submitted: int = 0
    # placements by HOW the router decided: "prefix" (longest radix-tree
    # match), "affinity" (session stickiness), "round_robin",
    # "least_loaded" (policy or prefix-miss fallback)
    placements: Dict[str, int] = dataclasses.field(default_factory=dict)
    affinity_hits: int = 0
    sheds: int = 0                 # SLO admission rejections (ERROR, not hangs)
    migrations: int = 0            # prefill→decode page hand-offs
    migrated_pages: int = 0
    migrated_bytes: int = 0
    # Fault tolerance (serve/cluster/health.py + manager failover):
    # step exceptions observed, replica state transitions (DOWN trips /
    # half-open probes / closed circuits), requests re-admitted off a
    # dead replica through recompute, total re-admission attempts
    # (failovers + migration-drain recomputes), and requests that ended
    # in a terminal error because retries exhausted or no healthy
    # replica remained (the bounded alternative to a hang).
    step_faults: int = 0
    replica_down: int = 0
    replica_suspect: int = 0
    probes: int = 0
    replica_recoveries: int = 0
    failovers: int = 0
    retries: int = 0
    failover_errors: int = 0
    # Migration back-pressure (ServingConfig.migration_queue_budget):
    # failed migrate attempts (exceptions, retried with backoff), the
    # bounded queue's current depth (gauge) and high-water mark, and
    # held prefills that overflowed the budget and drained through
    # recompute re-admission instead of parking with their pages.
    migration_failures: int = 0
    migration_queue_depth: int = 0
    migration_queue_peak: int = 0
    migration_queue_overflows: int = 0
    # Replica RPC transport (serve/cluster/transport.py + remote.py):
    # RPCs that exhausted their retries (each one is also a health
    # observation), retry attempts the deadline/backoff machinery
    # spent (absorbed losses — no health impact), cluster steps on
    # which a remote replica had had no successful exchange for
    # heartbeat_gap_steps (each one a SUSPECT observation), transport
    # reconnects after a disconnect, standby replicas that adopted a
    # DOWN replica's routing position (+ prefix families), and raw
    # frame bytes both ways (requests+responses; migrated page bytes
    # and shipped radix trees dominate).
    rpc_errors: int = 0
    rpc_retries: int = 0
    heartbeat_gaps: int = 0
    reconnects: int = 0
    standby_adoptions: int = 0
    wire_bytes_sent: int = 0
    wire_bytes_received: int = 0
    # Concurrent cluster stepping (serve/cluster/manager.py): the
    # high-water mark of RPCs in flight inside one step's fan-out
    # (gauge — 0 under the serial reference loop), plus bounded
    # reservoirs of whole-cluster-step wall time and per-replica
    # step-RPC round-trip time in milliseconds. The raw sample lists
    # stay out of Prometheus; the derived ``cluster_step_ms_p50/p99``
    # and ``rpc_rtt_ms_p50/p99`` properties export as gauges, and
    # per-replica RTT percentiles ride the snapshot under
    # ``rpc_rtt_ms_per_replica``.
    rpc_inflight_peak: int = 0
    cluster_step_ms_samples: List[float] = dataclasses.field(
        default_factory=list
    )
    rpc_rtt_ms_samples: Dict[int, List[float]] = dataclasses.field(
        default_factory=dict
    )
    # Elastic control plane (serve/cluster/{journal,reconfigure}.py):
    # committed reconfigurations by kind (replicas added live, replicas
    # drained + retired, prefill/decode pool flips), journal traffic
    # (records + raw frame bytes appended; compactions that rewrote the
    # log to the live set), manager restarts recovered from the journal,
    # and unfinished requests a recovery re-admitted through recompute.
    scale_outs: int = 0
    scale_ins: int = 0
    pool_flips: int = 0
    journal_records: int = 0
    journal_bytes: int = 0
    journal_compactions: int = 0
    manager_recoveries: int = 0
    journal_replayed: int = 0
    # Self-driving serving (serve/autotune): policy decisions taken
    # (applied or advisory), speculation-bucket retunes advised, and
    # the predicted-vs-measured throughput gauges the autoscaler
    # refreshes every evaluation (tokens/sec — how far off the cost
    # model is on this box). Per-replica arrival/completion counters
    # and the bounded admission-time queue-delay reservoir feed the
    # TrafficEstimator; the dict fields stay out of Prometheus (the
    # derived ``queue_delay_s_p50/p99`` and the per-replica snapshot
    # maps ride along instead).
    autoscale_decisions: int = 0
    retunes: int = 0
    autoscale_predicted_tps: float = 0.0
    autoscale_measured_tps: float = 0.0
    arrivals_per_replica: Dict[int, int] = dataclasses.field(
        default_factory=dict
    )
    completions_per_replica: Dict[int, int] = dataclasses.field(
        default_factory=dict
    )
    queue_delay_s_samples: List[float] = dataclasses.field(
        default_factory=list
    )

    def record_placement(self, how: str) -> None:
        self.placements[how] = self.placements.get(how, 0) + 1
        if how == "affinity":
            self.affinity_hits += 1

    def note_cluster_step_ms(self, ms: float) -> None:
        """Record one whole-cluster-step wall sample (bounded
        reservoir, same trim discipline as decode_step_ms)."""
        s = self.cluster_step_ms_samples
        s.append(float(ms))
        if len(s) > _DECODE_MS_CAP:
            del s[: len(s) - _DECODE_MS_CAP]

    def note_arrival(self, replica: int) -> None:
        """Count one first-time placement onto ``replica`` (failover
        re-admissions are NOT arrivals — the request already counted)."""
        r = int(replica)
        self.arrivals_per_replica[r] = self.arrivals_per_replica.get(r, 0) + 1

    def note_completion(self, replica: int) -> None:
        """Count one successfully finished request against the replica
        that first homed it (profile.replica_id — stable across
        failovers, so arrivals and completions reconcile per home)."""
        r = int(replica)
        self.completions_per_replica[r] = (
            self.completions_per_replica.get(r, 0) + 1
        )

    def note_queue_delay_s(self, delay_s: float) -> None:
        """Record one admission-time queue-delay estimate (bounded
        reservoir). Pre-envelope/cold-replica placements report 0.0 —
        a real sample ("no estimated wait"), kept, not dropped: the
        percentiles must reflect what admission actually saw."""
        s = self.queue_delay_s_samples
        s.append(max(0.0, float(delay_s)))
        if len(s) > _DECODE_MS_CAP:
            del s[: len(s) - _DECODE_MS_CAP]

    def note_rpc_rtt_ms(self, replica: int, ms: float) -> None:
        """Record one step-RPC round-trip sample for ``replica``
        (bounded per-replica reservoir)."""
        s = self.rpc_rtt_ms_samples.setdefault(int(replica), [])
        s.append(float(ms))
        if len(s) > _DECODE_MS_CAP:
            del s[: len(s) - _DECODE_MS_CAP]

    @staticmethod
    def _pct(samples: Sequence[float], q: float) -> float:
        if not samples:
            return 0.0
        ordered = sorted(samples)
        idx = min(len(ordered) - 1, int(round(q * (len(ordered) - 1))))
        return ordered[idx]

    @property
    def cluster_step_ms_p50(self) -> float:
        return self._pct(self.cluster_step_ms_samples, 0.50)

    @property
    def cluster_step_ms_p99(self) -> float:
        return self._pct(self.cluster_step_ms_samples, 0.99)

    @property
    def queue_delay_s_p50(self) -> float:
        return self._pct(self.queue_delay_s_samples, 0.50)

    @property
    def queue_delay_s_p99(self) -> float:
        return self._pct(self.queue_delay_s_samples, 0.99)

    def arrivals_completions_per_replica(self) -> Dict[int, Dict[str, int]]:
        """Per-replica arrival/completion reconciliation map — the
        difference is the replica's live (or lost-to-error) load."""
        out: Dict[int, Dict[str, int]] = {}
        for idx in sorted(
            set(self.arrivals_per_replica) | set(self.completions_per_replica)
        ):
            out[idx] = {
                "arrivals": self.arrivals_per_replica.get(idx, 0),
                "completions": self.completions_per_replica.get(idx, 0),
            }
        return out

    def _all_rtt(self) -> List[float]:
        return [
            ms for s in self.rpc_rtt_ms_samples.values() for ms in s
        ]

    @property
    def rpc_rtt_ms_p50(self) -> float:
        return self._pct(self._all_rtt(), 0.50)

    @property
    def rpc_rtt_ms_p99(self) -> float:
        return self._pct(self._all_rtt(), 0.99)

    def rpc_rtt_ms_per_replica(self) -> Dict[int, Dict[str, float]]:
        """Per-replica RTT p50/p99 over the bounded reservoirs."""
        return {
            idx: {
                "p50": round(self._pct(s, 0.50), 3),
                "p99": round(self._pct(s, 0.99), 3),
            }
            for idx, s in sorted(self.rpc_rtt_ms_samples.items())
        }

    def snapshot(
        self, replicas: Sequence["SchedulerStats"] = ()
    ) -> Dict[str, object]:
        """Router counters + the SUM over every replica's scheduler
        counters (numeric fields only; per-replica snapshots ride along
        under ``per_replica`` so nothing is averaged away)."""
        per = [r.snapshot() for r in replicas]
        agg: Dict[str, float] = {}
        for snap in per:
            for k, v in snap.items():
                if isinstance(v, (int, float)):
                    agg[k] = agg.get(k, 0) + v
        # rates do not sum — recompute them over the summed counters
        if per:
            hits = agg.get("prefix_hits", 0)
            misses = agg.get("prefix_misses", 0)
            agg["prefix_hit_rate"] = round(
                hits / (hits + misses), 4
            ) if hits + misses else 0.0
            hit_toks = agg.get("prefix_hit_tokens", 0)
            agg["host_hit_rate"] = round(
                agg.get("host_hit_tokens", 0) / hit_toks, 4
            ) if hit_toks else 0.0
            drafted = agg.get("spec_drafted", 0)
            agg["spec_accept_rate"] = round(
                agg.get("spec_accepted", 0) / drafted, 4
            ) if drafted else 0.0
            # remote replicas mirror their stats from heartbeats — a
            # snapshot taken before the first envelope is empty
            agg["mean_occupancy"] = round(
                sum(s.get("mean_occupancy", 0.0) for s in per) / len(per), 4
            )
            agg["mean_budget_fill"] = round(
                sum(s.get("mean_budget_fill", 0.0) for s in per) / len(per),
                4,
            )
            # percentiles do not sum either — report the replica mean
            for k in ("decode_step_ms_p50", "decode_step_ms_p99"):
                agg[k] = round(
                    sum(s.get(k, 0.0) for s in per) / len(per), 3
                )
        return {
            "submitted": self.submitted,
            "placements": dict(self.placements),
            "affinity_hits": self.affinity_hits,
            "sheds": self.sheds,
            "migrations": self.migrations,
            "migrated_pages": self.migrated_pages,
            "migrated_bytes": self.migrated_bytes,
            "step_faults": self.step_faults,
            "replica_down": self.replica_down,
            "replica_suspect": self.replica_suspect,
            "probes": self.probes,
            "replica_recoveries": self.replica_recoveries,
            "failovers": self.failovers,
            "retries": self.retries,
            "failover_errors": self.failover_errors,
            "migration_failures": self.migration_failures,
            "migration_queue_depth": self.migration_queue_depth,
            "migration_queue_peak": self.migration_queue_peak,
            "migration_queue_overflows": self.migration_queue_overflows,
            "rpc_errors": self.rpc_errors,
            "rpc_retries": self.rpc_retries,
            "heartbeat_gaps": self.heartbeat_gaps,
            "reconnects": self.reconnects,
            "standby_adoptions": self.standby_adoptions,
            "wire_bytes_sent": self.wire_bytes_sent,
            "wire_bytes_received": self.wire_bytes_received,
            "rpc_inflight_peak": self.rpc_inflight_peak,
            "cluster_step_ms_p50": round(self.cluster_step_ms_p50, 3),
            "cluster_step_ms_p99": round(self.cluster_step_ms_p99, 3),
            "rpc_rtt_ms_p50": round(self.rpc_rtt_ms_p50, 3),
            "rpc_rtt_ms_p99": round(self.rpc_rtt_ms_p99, 3),
            "rpc_rtt_ms_per_replica": self.rpc_rtt_ms_per_replica(),
            "scale_outs": self.scale_outs,
            "scale_ins": self.scale_ins,
            "pool_flips": self.pool_flips,
            "journal_records": self.journal_records,
            "journal_bytes": self.journal_bytes,
            "journal_compactions": self.journal_compactions,
            "manager_recoveries": self.manager_recoveries,
            "journal_replayed": self.journal_replayed,
            "autoscale_decisions": self.autoscale_decisions,
            "retunes": self.retunes,
            "autoscale_predicted_tps": self.autoscale_predicted_tps,
            "autoscale_measured_tps": self.autoscale_measured_tps,
            "queue_delay_s_p50": round(self.queue_delay_s_p50, 6),
            "queue_delay_s_p99": round(self.queue_delay_s_p99, 6),
            "arrivals_completions_per_replica": (
                self.arrivals_completions_per_replica()
            ),
            "replicas": agg,
            "per_replica": per,
        }

    def report(self, replicas: Sequence["SchedulerStats"] = ()) -> str:
        s = self.snapshot(replicas)
        place = " ".join(
            f"{k}={v}" for k, v in sorted(s["placements"].items())
        ) or "none"
        agg = s["replicas"]
        return (
            f"[cluster {len(replicas)} replicas] sub={s['submitted']} "
            f"place[{place}] affinity={s['affinity_hits']} "
            f"shed={s['sheds']} migr={s['migrations']} "
            f"migrB={s['migrated_bytes']} "
            f"faults={s['step_faults']} down={s['replica_down']} "
            f"failover={s['failovers']} migq={s['migration_queue_depth']} "
            f"rpc_err={s['rpc_errors']} rpc_retry={s['rpc_retries']} "
            f"hb_gaps={s['heartbeat_gaps']} reconn={s['reconnects']} "
            f"inflight^={s['rpc_inflight_peak']} "
            f"cstep_ms={s['cluster_step_ms_p50']:.2f}/"
            f"{s['cluster_step_ms_p99']:.2f} "
            f"rtt_ms={s['rpc_rtt_ms_p50']:.2f}/{s['rpc_rtt_ms_p99']:.2f} "
            f"standby={s['standby_adoptions']} "
            f"scale+{s['scale_outs']}/-{s['scale_ins']} "
            f"flip={s['pool_flips']} jrnl={s['journal_records']}r/"
            f"{s['journal_bytes']}B recov={s['manager_recoveries']} "
            f"autoscale={s['autoscale_decisions']}d/{s['retunes']}rt "
            f"qdelay_s={s['queue_delay_s_p50']:.3f}/"
            f"{s['queue_delay_s_p99']:.3f} "
            f"wireB={s['wire_bytes_sent']}/{s['wire_bytes_received']} "
            f"pfx_hit_rate={agg.get('prefix_hit_rate', 0.0)} "
            f"adm={agg.get('admitted', 0)} "
            f"preempt={agg.get('preemptions', 0)} "
            f"retraces={agg.get('retraces', 0)}"
        )
