"""Serving scheduler telemetry (a subset of
``flexflow_tpu/metrics.py:SchedulerStats``).

The counters of context parallelism and the retrace sentinel come with
the slices that port those features.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

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
