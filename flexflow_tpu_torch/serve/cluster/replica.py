"""Replica — one engine + scheduler pair inside a cluster (the JAX
package's ``serve/cluster/replica.py`` over the port's engine and
manager).

A :class:`Replica` wraps one :class:`InferenceEngine` (its own KV pool and
its own prefix-cache radix tree) plus the :class:`RequestManager` that
drives it, and exposes exactly the surface the front-end router needs to
place work:

* ``prefix_score(tokens)`` — how many leading prompt tokens this
  replica's radix tree already holds (a READ-ONLY probe,
  ``PrefixCache.match_len``: scoring N replicas must not touch the N-1
  losers' LRU state);
* ``queue_delay_s()`` — an admission-delay estimate: backlog tokens
  (undispatched prompt tokens of queued and prefilling requests, plus
  one token per decode row) over the replica's OBSERVED token rate (an
  EMA over ``SchedulerStats`` deltas, updated by :meth:`step`). 0 before
  two rate samples exist: SLO shedding (``ServingConfig.
  slo_queue_delay_s``) acts on measured load, never on a cold start;
* ``load()`` — queued + active requests, the least-loaded tiebreak.

Replicas here are IN-PROCESS: every replica's engine lives on the same
device (one card holds several independent engines, their params shared
by reference). The router never reaches past these methods, so a
multi-host deployment can put a process behind the same surface (the
cluster transport slice).
"""
from __future__ import annotations

import time
from typing import Any, Optional, Sequence

from ...logging_utils import get_logger
from ..engine import InferenceEngine, ServingConfig
from ..request_manager import TERMINAL_STATUSES, RequestManager, RequestStatus

#: Pool roles under disaggregated serving (ServingConfig.prefill_replicas
#: / decode_replicas). "mixed" replicas serve both phases.
ROLES = ("mixed", "prefill", "decode")


class Replica:
    """One cluster member: engine + request manager + routing telemetry."""

    def __init__(self, index: int, rm: RequestManager, role: str = "mixed"):
        if role not in ROLES:
            raise ValueError(f"unknown replica role {role!r} "
                             f"(expected one of {ROLES})")
        self.index = int(index)
        self.rm = rm
        self.role = role
        # token-rate EMA (tokens/sec the scheduler actually retired) —
        # the denominator of the queue-delay estimate. ``_rate_samples``
        # gates the estimate: a single (or stale) observation is not a
        # denominator — SLO shedding must never act on a cold rate.
        self._rate = 0.0
        self._rate_samples = 0
        self._last_tokens = 0
        self._last_t: Optional[float] = None
        # fault-injection harness (serve/cluster/faults.py): consulted
        # at the top of step(); injected latency accumulates here per
        # step and is read by the manager's health monitor.
        self.fault_injector = None
        self.steps_taken = 0
        self.injected_latency_s = 0.0
        self._log = get_logger("serve")

    @classmethod
    def build(
        cls,
        index: int,
        model: Any,
        cfg: Any,
        params: Any,
        serving: ServingConfig,
        *,
        role: str = "mixed",
        device: Any = None,
        tokenizer: Any = None,
        eos_token_id: Optional[int] = None,
        seed: int = 0,
        ssms: Sequence[Any] = (),
        spec: Any = None,
    ) -> "Replica":
        """Construct a replica: its own engine (and so its own KV pool) on
        ``device``. Params are shared by reference across replicas: on one
        card that costs nothing; per-host processes would each load their
        own copy behind the same constructor.

        ``ssms`` — (model, cfg, params) triples — are this replica's OWN
        SpecInfer draft mirrors: each builds a fresh SSM engine (draft
        params shared by reference like the target's) and the replica
        runs a SpecInferManager instead of a plain RequestManager.
        ``spec`` alone with ``SpecConfig.draft="early_exit"``
        self-speculates with no mirror engine."""
        engine = InferenceEngine(model, cfg, params, serving, device=device)
        early_exit = getattr(spec, "draft", "ssm") == "early_exit"
        if ssms or early_exit:
            from ..specinfer import SpecInferManager

            ssm_engines = [InferenceEngine(m, c, p, serving, device=device)
                           for (m, c, p) in ssms]
            rm: RequestManager = SpecInferManager(
                engine, ssm_engines, spec, tokenizer=tokenizer,
                eos_token_id=eos_token_id, seed=seed,
            )
        else:
            rm = RequestManager(engine, tokenizer=tokenizer, eos_token_id=eos_token_id,
                                seed=seed)
        return cls(index, rm, role=role)

    # ------------------------------------------------------------------
    # router-facing telemetry

    @property
    def engine(self) -> InferenceEngine:
        return self.rm.engine

    @property
    def stats(self):
        return self.rm.stats

    def prefix_score(self, tokens: Sequence[int]) -> int:
        """Leading prompt tokens this replica's radix tree would serve
        from cache (0 without prefix caching) — read-only."""
        pc = self.rm.prefix_cache
        if pc is None or len(tokens) < 2:
            return 0
        return pc.match_len(tokens)

    def active_requests(self) -> int:
        return sum(
            1 for r in self.rm.requests.values()
            if r.status not in TERMINAL_STATUSES
        )

    def load(self) -> float:
        """Least-loaded tiebreak: live requests (queued + in slots)."""
        return float(self.active_requests())

    def backlog_tokens(self) -> int:
        """Tokens of work already accepted but not yet dispatched:
        undispatched prompt tokens (queued requests count their whole
        prompt) plus one pending token per decode row."""
        n = 0
        for req in self.rm.requests.values():
            if req.status in TERMINAL_STATUSES:
                continue
            if req.status is RequestStatus.DECODING:
                n += 1
            else:  # PENDING / PREFILLING
                n += max(0, req.prompt_len - req.n_sched)
        return n

    def queue_delay_s(self) -> float:
        """Estimated seconds before NEW work would start executing:
        backlog over the observed token rate. 0 until at least two rate
        samples exist (cold replicas — first steps after start, after
        ``abandon``, or after probe re-admission — are never shed on a
        guess or a stale denominator, and the division cannot see a
        zero/near-zero rate)."""
        if self._rate_samples < 2 or self._rate <= 0.0:
            return 0.0
        return self.backlog_tokens() / self._rate

    # ------------------------------------------------------------------
    # scheduling passthrough

    def has_work(self) -> bool:
        return bool(self.rm.pending) or self.active_requests() > 0 or bool(
            self.rm._inflight
        )

    def step(self) -> bool:
        """One scheduler step + a rate-EMA update from the stats delta.
        The fault injector (when attached) runs FIRST — an injected
        crash/transient raises here, at the replica surface, exactly
        where a remote replica's RPC failure would surface."""
        self.steps_taken += 1
        self.injected_latency_s = 0.0
        if self.fault_injector is not None:
            self.fault_injector.on_step(self)  # may raise InjectedFault
        progressed = self.rm.step()
        now = time.perf_counter()
        done = self.rm.stats.prefill_tokens + self.rm.stats.decode_tokens
        if self._last_t is not None:
            dt = now - self._last_t
            delta = done - self._last_tokens
            if dt > 0 and delta > 0:
                inst = delta / dt
                self._rate = (
                    inst if self._rate == 0.0
                    else 0.8 * self._rate + 0.2 * inst
                )
                self._rate_samples += 1
        self._last_t = now
        self._last_tokens = done
        return progressed

    def drain(self) -> None:
        self.rm.drain()

    # ------------------------------------------------------------------
    # fault tolerance (serve/cluster/health.py drives these)

    def reset_rate(self) -> None:
        """Forget the token-rate EMA (and its wall-clock anchor). Called
        when the replica goes DOWN so probe re-admission starts with a
        cold, optimistic estimate instead of a stale denominator — the
        dt across the outage would otherwise read as a near-zero rate
        and SLO-shed everything routed at the recovered replica."""
        self._rate = 0.0
        self._rate_samples = 0
        self._last_t = None
        self._last_tokens = (
            self.rm.stats.prefill_tokens + self.rm.stats.decode_tokens
        )

    def abandon(self) -> int:
        """Tear the scheduler state down after the replica was declared
        DOWN: drop every in-flight dispatch WITHOUT flushing (the device
        results are suspect and nothing may block on them), mark every
        live request ERROR (the manager has already captured their
        flushed tokens for recompute re-admission elsewhere), and
        release every slot's pages so a later probe re-admission starts
        from a clean pool. The prefix-cache radix tree is KEPT — its
        pages were written by completed, flushed dispatches and survive
        the fault, so a recovered replica rejoins with its prefix
        families warm. Returns the number of live requests dropped."""
        rm = self.rm
        rm._inflight.clear()
        rm._prev_dispatch_slots = set()
        rm.pending.clear()
        rm.hold_finished.clear()
        dropped = 0
        for req in rm.requests.values():
            req.pipeline_refs = 0
            req.inflight = 0
            if req.status not in TERMINAL_STATUSES:
                req.status = RequestStatus.ERROR
                req.error = "replica down — failed over"
                dropped += 1
        for slot, rid in enumerate(rm.slots):
            if rid is None:
                continue
            if rm._paged:
                rm._release_pages(slot)
            rm.slots[slot] = None
            rm.requests[rid].slot = -1
        self.reset_rate()
        tr = rm.tracer
        if tr.enabled:
            tr.event("abandon", dropped=dropped)
        return dropped

    # ------------------------------------------------------------------
    # warm-standby adoption (serve/cluster/manager.py _adopt_standby)

    def export_prefix_tree(self):
        """Serialize this replica's prefix radix tree — block keys plus
        page content bytes (``PrefixCache.export_tree``) — for a warm
        standby to adopt. Empty without prefix caching. Works on a
        circuit-broken replica: ``abandon`` keeps the tree (its pages
        hold only flushed completed writes)."""
        pc = self.rm.prefix_cache
        if pc is None:
            return []
        return pc.export_tree(fetch_page=self.engine.fetch_page)

    def import_prefix_tree(self, entries) -> int:
        """Adopt an exported tree into this replica's prefix cache
        (``PrefixCache.import_tree``); returns blocks adopted. 0
        without prefix caching — the standby still replaces the dead
        replica's capacity, just cold."""
        pc = self.rm.prefix_cache
        if pc is None:
            return 0
        return pc.import_tree(entries, upload_page=self.engine.upload_page)

    # ------------------------------------------------------------------
    # audits

    def check_no_leaks(self) -> None:
        """Page-pool refcount audit for THIS replica (paged layout):
        slot tables + this replica's own radix tree must account for
        every reference — run by tests after migrations to prove no
        page leaked on either side of a hand-off."""
        pager = getattr(self.engine, "pager", None)
        if pager is None:
            return
        external = None
        if self.rm.prefix_cache is not None:
            external = self.rm.prefix_cache.page_refs()
        pager.check_no_leaks(external=external)
