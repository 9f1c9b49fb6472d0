"""Replica health — per-replica state machine + circuit breaker (the JAX
package's ``serve/cluster/health.py``, copied: host code).

Every cluster replica carries a :class:`ReplicaHealth` driven by two
observation streams the :class:`~.manager.ClusterManager` feeds it from
the drive loop: step EXCEPTIONS (``record_failure``) and step LATENCIES
(``record_success`` — wall seconds per ``Replica.step``, plus any
fault-injected extra, compared against the replica's own latency EMA).
The state machine::

    HEALTHY ──exception──────────────→ SUSPECT ──threshold──→ DOWN
        │                                 │ clean streak          │
        └──sustained latency spikes──→ SUSPECT                    │ backoff
                                          │ MORE spikes           ▼ (steps)
    HEALTHY ←──probe_successes──────── PROBING ←──────────────────┘
                                          │ any failure → DOWN, backoff ×2

* **HEALTHY** — normal rotation.
* **SUSPECT** — still routable (in rotation), but on watch: one more
  consecutive exception (``failure_threshold``) circuit-breaks it, and
  ``recovery_steps`` clean steps return it to HEALTHY. Entered on a
  first exception or on ``latency_spike_steps`` consecutive step
  latencies above ``latency_spike_factor`` × the replica's EMA.
* **DOWN** — the circuit is OPEN: the replica is excluded from
  ``Router.route`` scoring, its session affinities are dropped (they
  re-pin on survivors), and every in-flight request it held is
  re-admitted elsewhere through recompute (manager failover). A
  sustained spike run (``spike_down_steps``) also trips the breaker —
  a stalled replica is as dead as a crashed one to its requests.
* **PROBING** — the circuit is HALF-OPEN: after an exponential backoff
  (``probe_backoff_steps`` × 2^(trips-1) CLUSTER steps, capped) the
  replica re-enters routing; ``probe_successes`` clean steps that
  actually carried work close the circuit (→ HEALTHY, backoff reset),
  any failure re-opens it with the backoff doubled.

Everything here is DETERMINISTIC given the observation stream: backoff
is counted in cluster steps (not wall time) and spike detection only
compares latencies the manager reports — which is what lets the
fault-injection harness (:mod:`.faults`) script exact failure scenarios
and the chaos tests replay them bit-for-bit.

The machine consumes an OBSERVATION STREAM, not a failure mechanism —
which is why remote replicas (the cluster transport slice) plug in
unchanged: a step RPC that exhausted its retries and a heartbeat GAP
(no successful exchange for ``heartbeat_gap_steps`` cluster steps)
both arrive as ``record_failure`` observations, deduplicated by the
manager to at most ONE per replica per cluster step (a replica that is
simultaneously gapped and RPC-erroring must not burn
``failure_threshold`` twice as fast), and an injected transport
``delay`` under the RPC deadline arrives as reported step latency the
spike detector prices exactly like the in-process "latency" fault.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import List, Optional


class HealthState(enum.Enum):
    HEALTHY = "healthy"
    SUSPECT = "suspect"
    DOWN = "down"
    PROBING = "probing"


@dataclasses.dataclass(frozen=True)
class HealthConfig:
    """Knobs of the per-replica state machine (defaults sized for the
    in-process cluster's step cadence; a multi-host deployment with RPC
    heartbeats would widen the backoffs, not change the machine)."""

    # consecutive step exceptions that trip the breaker (the FIRST
    # exception always demotes to SUSPECT)
    failure_threshold: int = 2
    # a step latency above factor × the replica's own EMA is a spike …
    latency_spike_factor: float = 8.0
    # … this many CONSECUTIVE spikes demote HEALTHY → SUSPECT …
    latency_spike_steps: int = 3
    # … and this many trip the breaker outright (a stalled replica)
    spike_down_steps: int = 6
    # EMA warmup: no spike verdicts before this many clean samples
    min_latency_samples: int = 8
    # DOWN → PROBING after probe_backoff_steps × 2^(trips-1) cluster
    # steps, capped at probe_backoff_max_steps
    probe_backoff_steps: int = 8
    probe_backoff_max_steps: int = 256
    # clean PROBING steps (that carried work) to close the circuit
    probe_successes: int = 3
    # clean SUSPECT steps to return to HEALTHY
    recovery_steps: int = 5


class ReplicaHealth:
    """One replica's health record. All transitions are returned to the
    caller ("suspect"/"down"/"recovered"/None) so the manager can count
    them and run failover on "down"."""

    def __init__(self, index: int, config: Optional[HealthConfig] = None):
        self.index = int(index)
        self.cfg = config or HealthConfig()
        self.state = HealthState.HEALTHY
        self.consecutive_failures = 0
        self.trips = 0                # times the breaker opened
        self.down_at_step = -1        # cluster step of the last trip
        self.backoff_steps = self.cfg.probe_backoff_steps
        self.last_error: Optional[str] = None
        self._ema = 0.0               # step-latency EMA (clean samples)
        self._samples = 0
        self._spike_run = 0
        self._clean_run = 0           # SUSPECT recovery streak
        self._probe_ok = 0

    # ------------------------------------------------------------------

    @property
    def routable(self) -> bool:
        """May the router place (or keep) traffic here? DOWN is the only
        excluded state — PROBING traffic IS the probe."""
        return self.state is not HealthState.DOWN

    def _trip(self, step_no: int, why: str) -> str:
        self.trips += 1
        self.state = HealthState.DOWN
        self.down_at_step = int(step_no)
        self.backoff_steps = min(
            self.cfg.probe_backoff_steps * (2 ** (self.trips - 1)),
            self.cfg.probe_backoff_max_steps,
        )
        self.last_error = why
        self._probe_ok = 0
        self._spike_run = 0
        self._clean_run = 0
        return "down"

    def record_failure(self, exc: BaseException, step_no: int) -> str:
        """A step (or drain) raised. Returns the transition taken:
        "down" when the breaker tripped, else "suspect"."""
        why = f"{type(exc).__name__}: {exc}"
        self.consecutive_failures += 1
        self._spike_run = 0
        self._clean_run = 0
        if (
            self.state is HealthState.PROBING
            or self.consecutive_failures >= self.cfg.failure_threshold
        ):
            # half-open circuits re-open on ANY failure
            return self._trip(step_no, why)
        self.state = HealthState.SUSPECT
        self.last_error = why
        return "suspect"

    def record_success(
        self, latency_s: float, step_no: int, had_work: bool = True
    ) -> Optional[str]:
        """A step completed in ``latency_s`` (fault-injected extra
        included — the harness reports, this machine only compares).
        Returns "suspect"/"down"/"recovered" on a transition."""
        self.consecutive_failures = 0
        spike = (
            self._samples >= self.cfg.min_latency_samples
            and self._ema > 0.0
            and latency_s > self.cfg.latency_spike_factor * self._ema
        )
        if spike:
            self._spike_run += 1
        else:
            self._spike_run = 0
            # only clean samples feed the EMA: a spike must not
            # legitimize the next one by dragging the baseline up
            self._ema = (
                latency_s if self._samples == 0
                else 0.8 * self._ema + 0.2 * latency_s
            )
            self._samples += 1
        if self.state is HealthState.PROBING:
            if spike and self._spike_run >= self.cfg.spike_down_steps:
                return self._trip(step_no, "sustained step-latency spike "
                                           "while probing")
            if not spike and had_work:
                self._probe_ok += 1
                if self._probe_ok >= self.cfg.probe_successes:
                    return self._close()
            return None
        if spike:
            if self._spike_run >= self.cfg.spike_down_steps:
                return self._trip(
                    step_no,
                    f"sustained step-latency spike ({latency_s:.3f}s vs "
                    f"EMA {self._ema:.3f}s)",
                )
            if (
                self.state is HealthState.HEALTHY
                and self._spike_run >= self.cfg.latency_spike_steps
            ):
                self.state = HealthState.SUSPECT
                self._clean_run = 0
                return "suspect"
            return None
        if self.state is HealthState.SUSPECT:
            self._clean_run += 1
            if self._clean_run >= self.cfg.recovery_steps:
                self.state = HealthState.HEALTHY
                return "recovered"
        return None

    def maybe_probe(self, step_no: int) -> bool:
        """DOWN → PROBING once the backoff expired (half-open: the
        router may place traffic again). Returns True on transition."""
        if (
            self.state is HealthState.DOWN
            and step_no - self.down_at_step >= self.backoff_steps
        ):
            self.state = HealthState.PROBING
            self._probe_ok = 0
            return True
        return False

    def _close(self) -> str:
        """Close the circuit: PROBING proved itself. The backoff resets
        — a later, unrelated trip starts the schedule over — and the
        latency EMA re-warms so pre-outage timings don't spike-flag the
        recovered replica's first steps."""
        self.state = HealthState.HEALTHY
        self.trips = 0
        self.backoff_steps = self.cfg.probe_backoff_steps
        self._probe_ok = 0
        self._ema = 0.0
        self._samples = 0
        self.last_error = None
        return "recovered"


class HealthMonitor:
    """The cluster's health records, indexed by replica position."""

    def __init__(self, n_replicas: int,
                 config: Optional[HealthConfig] = None):
        self.cfg = config or HealthConfig()
        self.replicas: List[ReplicaHealth] = [
            ReplicaHealth(i, self.cfg) for i in range(n_replicas)
        ]

    def __getitem__(self, pos: int) -> ReplicaHealth:
        return self.replicas[pos]

    def __len__(self) -> int:
        return len(self.replicas)

    def add(self) -> ReplicaHealth:
        """A fresh HEALTHY record for a replica joining the cluster
        (live scale_out — serve/cluster/reconfigure.py)."""
        h = ReplicaHealth(len(self.replicas), self.cfg)
        self.replicas.append(h)
        return h

    def remove(self, pos: int) -> None:
        """Drop the record at ``pos`` (a retired replica leaves the
        membership) and re-index the survivors to their new positions."""
        del self.replicas[pos]
        for i, h in enumerate(self.replicas):
            h.index = i

    def routable(self, pos: int) -> bool:
        return self.replicas[pos].routable

    def snapshot(self) -> List[str]:
        return [h.state.value for h in self.replicas]
