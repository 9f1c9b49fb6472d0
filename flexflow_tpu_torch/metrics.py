"""Serving scheduler telemetry (a subset of
``flexflow_tpu/metrics.py:SchedulerStats``).

The counters of the prefix cache, the host tier, speculation, context
parallelism, the retrace sentinel and the whole-step megakernel come
with the slices that port those features.
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
    # Host wall time of each decode step's engine call, in ms: on the
    # pipelined path the dispatch cost (the device runs ahead and no sync
    # is added), on the sync path the full blocking step. Bounded
    # reservoir (newest _DECODE_MS_CAP samples).
    decode_step_ms_samples: List[float] = dataclasses.field(
        default_factory=list
    )

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
            "decode_step_ms_p50": round(self.decode_step_ms_p50, 3),
            "decode_step_ms_p99": round(self.decode_step_ms_p99, 3),
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
            f"dstep_ms={s['decode_step_ms_p50']:.2f}/"
            f"{s['decode_step_ms_p99']:.2f}"
        )
