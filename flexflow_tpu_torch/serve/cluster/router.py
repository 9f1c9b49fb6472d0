"""Router — prefix-aware placement, session affinity, SLO admission (the
JAX package's ``serve/cluster/router.py``, copied: host code).

The cluster front-end's placement brain. Given the candidate replicas
(the whole cluster, or the prefill pool under disaggregation), each
:meth:`route` call answers "which replica takes this prompt — or do we
shed it":

* **prefix** (default): score every candidate by how many leading
  prompt tokens its radix tree already holds
  (``Replica.prefix_score`` → ``PrefixCache.match_len``, a read-only
  probe) and place on the longest match — the request then prefills
  only its uncached suffix, and same-prefix traffic naturally
  PARTITIONS across replicas instead of duplicating every prefix
  family into every replica's limited tree. A universal miss falls
  back to least-loaded (which is also what seeds the partition: the
  first request of a new prefix family lands on the coldest replica,
  and every later relative follows it by match).
* **round_robin**: cycle the candidates — the ablation baseline.
* **least_loaded**: smallest queue-delay estimate (ties: fewest live
  requests, then lowest index for determinism).

**Session affinity** overrides the policy: a ``session_id`` seen before
routes to the replica that served it last (multi-turn chat keeps
hitting the replica whose tree holds the transcript). Affinity is
recorded on every placement, hit or miss.

**SLO admission** (``ServingConfig.slo_queue_delay_s``): when every
candidate's queue-delay estimate exceeds the bound, the request is
SHED — :meth:`route` returns ``(None, "shed")`` and the ClusterManager
surfaces it as ``RequestStatus.ERROR`` / ``GenerationResult.error``,
the scheduler's unservable-request contract (terminal, never a hang). With
room anywhere, the delay bound also REDIRECTS: an over-SLO preferred
replica loses the request to the best under-SLO one.

Counters land in :class:`flexflow_tpu_torch.metrics.ClusterStats` through
the callable-stats pattern (a zero-arg callable, so a caller swapping the
stats object mid-run keeps counting).
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

from ...logging_utils import get_logger
from ...metrics import ClusterStats

POLICIES = ("prefix", "round_robin", "least_loaded")


class Router:
    """Placement over ``replicas`` (Replica-shaped: ``prefix_score`` /
    ``queue_delay_s`` / ``load`` / ``index``). ``stats`` is a
    ClusterStats or a zero-arg callable returning one.

    The entries may be in-process :class:`~.replica.Replica` or
    :class:`~.remote.RemoteReplica` — for a remote one,
    ``prefix_score`` is a read-only RPC, broadcast CONCURRENTLY across
    the candidates (one round-trip per placement, not N serial peeks;
    an unreachable replica scores 0 and the health machinery owns the
    outage) while
    ``queue_delay_s``/``load`` read the heartbeat-fed client mirror,
    so a scoring pass never blocks on a slow link. The list is LIVE:
    the manager swaps a warm standby into a dead replica's position
    (``ClusterManager._adopt_standby``), and the router scores
    whatever currently occupies it."""

    def __init__(
        self,
        replicas: Sequence,
        policy: str = "prefix",
        *,
        slo_queue_delay_s: Optional[float] = None,
        stats=None,
        health=None,
    ):
        if policy not in POLICIES:
            raise ValueError(
                f"unknown router_policy {policy!r} (expected one of "
                f"{POLICIES})"
            )
        if not replicas:
            raise ValueError("router needs at least one replica")
        self.replicas = list(replicas)
        self.policy = policy
        self.slo_queue_delay_s = slo_queue_delay_s
        self._stats_src = stats
        # Health filter (serve/cluster/health.py): a zero-arg-per-pos
        # callable ``health(pos) -> bool`` — False (circuit-broken DOWN
        # replica) excludes the position from every scoring pass. None =
        # every replica is always routable.
        self.health = health
        self._rr_next = 0
        self.sessions: Dict[object, int] = {}  # session_id -> replica pos
        self._log = get_logger("serve")

    @property
    def stats(self) -> Optional[ClusterStats]:
        return (
            self._stats_src() if callable(self._stats_src)
            else self._stats_src
        )

    # ------------------------------------------------------------------

    def _routable(self, pos: int) -> bool:
        return self.health is None or bool(self.health(pos))

    def _under_slo(self, pos: int) -> bool:
        if self.slo_queue_delay_s is None:
            return True
        return self.replicas[pos].queue_delay_s() <= self.slo_queue_delay_s

    def drop_replica_sessions(self, pos: int) -> int:
        """Forget every session pinned to ``pos`` (the replica went
        DOWN): each session re-pins on its next turn — which is also
        what re-seeds a dead replica's prefix families on survivors
        (the next relative misses everywhere and lands least-loaded,
        exactly like a brand-new family). Returns sessions dropped."""
        stale = [k for k, v in self.sessions.items() if v == pos]
        for k in stale:
            del self.sessions[k]
        return len(stale)

    def _least_loaded(self, positions: Sequence[int]) -> int:
        return min(
            positions,
            key=lambda p: (
                self.replicas[p].queue_delay_s(),
                self.replicas[p].load(),
                p,
            ),
        )

    def _prefix_scores(self, tokens: Sequence[int],
                       positions: Sequence[int]) -> list:
        """Score every candidate's cached-prefix match, CONCURRENTLY
        where the replica speaks the async RPC surface: all peek RPCs
        are issued first, then harvested in position order — a
        placement over N remote replicas costs one round-trip, not N
        serial peeks, and the scored list is identical to the serial
        broadcast's (issue/harvest order is position order, and each
        score is position-local)."""
        issued = []
        for p in positions:
            rep = self.replicas[p]
            if hasattr(rep, "prefix_score_async"):
                issued.append((p, rep, rep.prefix_score_async(tokens)))
            else:  # in-process replica: the probe is a local tree read
                issued.append((p, rep, None))
        scored = []
        for p, rep, call in issued:
            if hasattr(rep, "finish_prefix_score"):
                scored.append((rep.finish_prefix_score(call), p))
            else:
                scored.append((rep.prefix_score(tokens), p))
        return scored

    def route(
        self,
        tokens: Sequence[int],
        session_id: Optional[object] = None,
        *,
        ignore_slo: bool = False,
    ) -> Tuple[Optional[int], str]:
        """Place one prompt. Returns ``(position, how)`` — a position
        into ``self.replicas`` and the decision kind ("affinity",
        "prefix", "round_robin", "least_loaded") — or ``(None, "shed")``
        when SLO admission rejects it, or ``(None, "down")`` when every
        replica is circuit-broken (the caller surfaces a terminal
        error, never a hang). ``ignore_slo`` bypasses SLO admission —
        failover re-admissions were already admitted once and must not
        be shed on their second landing. Records the placement (and the
        session) in the stats."""
        st = self.stats
        alive = [
            p for p in range(len(self.replicas)) if self._routable(p)
        ]
        if not alive:
            self._log.debug("router: every replica is DOWN")
            return None, "down"
        eligible = [
            p for p in alive if ignore_slo or self._under_slo(p)
        ]
        if not eligible:
            if st is not None:
                st.sheds += 1
            self._log.debug(
                "router shed: every healthy replica over "
                "slo_queue_delay_s=%s (delays: %s)",
                self.slo_queue_delay_s,
                [round(r.queue_delay_s(), 3) for r in self.replicas],
            )
            return None, "shed"

        pos, how = None, self.policy
        if session_id is not None and session_id in self.sessions:
            cand = self.sessions[session_id]
            if cand in eligible:
                pos, how = cand, "affinity"
        if pos is None:
            if self.policy == "prefix":
                scored = self._prefix_scores(tokens, eligible)
                best_score = max(s for s, _ in scored)
                if best_score > 0:
                    ties = [p for s, p in scored if s == best_score]
                    pos = (
                        ties[0] if len(ties) == 1
                        else self._least_loaded(ties)
                    )
                else:
                    pos, how = self._least_loaded(eligible), "least_loaded"
            elif self.policy == "round_robin":
                # next eligible at or after the cursor, cursor advances
                # past the chosen one — a full cycle over a healthy
                # cluster touches every replica exactly once
                n = len(self.replicas)
                for off in range(n):
                    cand = (self._rr_next + off) % n
                    if cand in eligible:
                        pos = cand
                        self._rr_next = (cand + 1) % n
                        break
            else:  # least_loaded
                pos = self._least_loaded(eligible)
        if session_id is not None:
            self.sessions[session_id] = pos
        if st is not None:
            st.record_placement(how)
        self._log.debug(
            "router place: replica %d via %s (prompt %d tokens)",
            self.replicas[pos].index, how, len(tokens),
        )
        return pos, how
