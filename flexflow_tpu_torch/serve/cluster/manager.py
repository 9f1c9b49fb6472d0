"""ClusterManager — one process driving N engine replicas (the JAX
package's ``serve/cluster/manager.py``, in process: its replicas are
engines on this process's device, driven by direct calls).

The cluster front end: a RequestManager-shaped API (``submit`` /
``step`` / ``drain`` / ``generate`` / ``generate_stream`` / ``result``)
over a pool of :class:`Replica` (each its own engine and KV pool, params
shared by reference) behind a :class:`Router`. The manager owns
cluster-level request identity (cluster ids are independent of any
replica's ids), the per-step drive loop over every replica's scheduler,
and — under disaggregation — the prefill→decode page migrations.

Request lifecycle::

    submit ──router──┬── shed / all DOWN ──→ ERROR (terminal)
                     ├── mixed replica ─────→ prefill+decode there ("single")
                     └── prefill replica ───→ prefill, max_new_tokens=1
                             │ held slot        ("prefill")
                             └─ COMPLETED → migration queue → decode replica
                                             adopts into DECODING ("decode")

Sheds come from SLO admission (``ServingConfig.slo_queue_delay_s``): a
shed request is terminal the moment it is submitted
(``GenerationResult.error``) and never hangs a ``generate`` or a stream.

**Fault tolerance** (health.py): every replica step runs under the
health monitor — a step exception or a sustained latency spike demotes
the replica (HEALTHY → SUSPECT → DOWN); a DOWN replica leaves routing,
its session pins drop, and every request it held is re-admitted to a
healthy replica through recompute (prompt + the flushed generated
tokens resubmitted as a prompt), so greedy generations stay those of the
fault-free run. Retries are bounded (``failover_retries``, exponential
cluster-step backoff); past them, or with no healthy replica left, the
request ends with ``GenerationResult.error`` — never a hang. A warm
standby (``standby_replicas``) adopts a dead replica's position and its
prefix families (``PrefixCache.export_tree`` / ``import_tree``).

**Migration back-pressure** (``migration_queue_budget``): finished
prefills waiting for decode-pool capacity sit in a bounded FIFO, holding
their pages; past the budget they release them and drain through
recompute re-admission. A dead decode pool makes the surviving pool
serve both phases; a dead prefill pool routes new requests single-phase
onto the decode pool.

With ``replicas=1`` and no faults every request goes to replica 0, whose
scheduler runs the single-engine step sequence: the router adds
bookkeeping, never a different step.

The RPC transports, remote replicas and their heartbeats, concurrent
stepping, the durable journal (``recover``), live reconfiguration and
the autoscaler come with the cluster transport and autotune slices.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, Iterator, List, Optional, Sequence, Set, Union

from ...logging_utils import get_logger
from ...metrics import ClusterStats
from ...obs.tracer import NULL_TRACER
from ..batch_config import GenerationConfig, GenerationResult, ProfileInfo, StreamEvent
from ..engine import ServingConfig, resolve_device
from ..request_manager import TERMINAL_STATUSES, RequestStatus
from .health import HealthConfig, HealthMonitor, HealthState, ReplicaHealth
from .migration import migrate_request
from .replica import Replica
from .router import Router


@dataclasses.dataclass
class ClusterRequest:
    """Cluster-level view of one request: where it lives now (replica
    position + replica-local rid) and which phase of the disaggregated
    lifecycle it is in. ``rid is None`` means the request is on no
    replica right now: shed / terminally failed (``error`` set) or
    between homes awaiting a failover re-admission (``error`` None)."""

    cluster_id: int
    tokens: List[int]
    prompt_text: str
    gen: GenerationConfig
    session_id: Optional[object] = None
    replica: Optional[int] = None       # position into manager.replicas
    rid: Optional[int] = None           # replica-local request id
    phase: str = "single"               # "single" | "prefill" | "decode"
    error: Optional[str] = None         # terminal failure (shed/failover)
    profile: ProfileInfo = dataclasses.field(default_factory=ProfileInfo)
    # ORIGINAL prompt length (the output-token baseline): a failover
    # re-admission's home sees prompt + generated as its prompt
    prompt_len: int = 0
    retries: int = 0                    # re-admissions so far
    mig_attempts: int = 0               # failed page-migration attempts

    _manager: Any = dataclasses.field(default=None, repr=False)
    # prompt + flushed generated tokens captured when the home replica
    # went DOWN: the recompute re-admission's submission
    _known: Optional[List[int]] = dataclasses.field(default=None, repr=False)
    _retry_at_step: int = 0             # failover/migration backoff gate

    @property
    def status(self) -> RequestStatus:
        if self.rid is None:
            # shed / failed: terminal; between homes: PENDING, so nothing
            # treats an in-flight recovery as done
            return RequestStatus.ERROR if self.error else RequestStatus.PENDING
        home = self._manager.replicas[self.replica].rm
        st = home.requests[self.rid].status
        if self.phase == "prefill" and st in TERMINAL_STATUSES:
            # completed on the prefill pool means "awaiting migration"
            return st if st is RequestStatus.ERROR else RequestStatus.DECODING
        return st

    @property
    def output_tokens(self) -> List[int]:
        if self.rid is None:
            return list(self._known[self.prompt_len:]) if self._known else []
        home = self._manager.replicas[self.replica].rm
        # the ORIGINAL prompt boundary: a failover home's own prompt_len
        # includes carried-over generated tokens
        return home.requests[self.rid].tokens[self.prompt_len:]


class ClusterManager:
    """Drive ``replicas`` behind a router (see the module docstring)."""

    def __init__(
        self,
        replicas: Sequence[Replica],
        serving: ServingConfig,
        *,
        router: Optional[Router] = None,
        tokenizer: Any = None,
        eos_token_id: Optional[int] = None,
        health_config: Optional[HealthConfig] = None,
        standbys: Sequence[Replica] = (),
    ):
        serving.validate()
        if len(replicas) != serving.replicas:
            raise ValueError(f"ServingConfig.replicas={serving.replicas} but "
                             f"{len(replicas)} replicas were built")
        if len(standbys) != serving.standby_replicas:
            raise ValueError(f"ServingConfig.standby_replicas={serving.standby_replicas} "
                             f"but {len(standbys)} standbys were built")
        self.serving = serving
        self.replicas = list(replicas)
        # warm standbys: built engines outside routing; on a DOWN
        # transition one adopts the dead replica's position and its
        # prefix families (_adopt_standby)
        self.standbys = list(standbys)
        self.tokenizer = tokenizer
        self.eos_token_id = eos_token_id
        if eos_token_id is None and tokenizer is not None:
            self.eos_token_id = getattr(tokenizer, "eos_token_id", None)
        self.stats = ClusterStats()
        self.health = HealthMonitor(len(self.replicas), health_config)
        self.fault_injector = None
        # positions already observed failing this cluster step (one
        # failure observation per replica per step)
        self._failed_obs: Set[int] = set()
        self.prefill_pool = [r for r in self.replicas if r.role == "prefill"]
        self.decode_pool = [r for r in self.replicas if r.role == "decode"]
        self.disaggregated = bool(self.prefill_pool)
        if self.disaggregated and not self.decode_pool:
            raise ValueError("prefill pool without a decode pool")
        routing = self.prefill_pool if self.disaggregated else self.replicas
        # router positions index the ROUTING pool; map back to cluster
        # positions so ClusterRequest.replica is always cluster-wide
        self._routing_pos = [self.replicas.index(r) for r in routing]
        health_cb = lambda pos: self._routable_pos(self._routing_pos[pos])  # noqa: E731
        self.router = router or Router(
            routing, serving.router_policy, slo_queue_delay_s=serving.slo_queue_delay_s,
            stats=lambda: self.stats, health=health_cb)
        if router is not None and self.router.health is None:
            self.router.health = health_cb
        self.requests: Dict[int, ClusterRequest] = {}
        self._next_cid = 1
        self._step_counter = 0
        # failover re-admissions pending their backoff (cluster ids)
        self._failovers: List[int] = []
        # finished prefills awaiting decode-pool capacity (cluster ids,
        # FIFO; bounded by ServingConfig.migration_queue_budget)
        self._migration_queue: List[int] = []
        self._mig_queued: Set[int] = set()
        self._log = get_logger("serve")
        # Observability (obs/): the router lane of the cluster timeline
        # (placements, migrations, failovers, health transitions) and the
        # flight recorder's dump triggers; obs.attach_observability wires
        # live ones in
        self.tracer = NULL_TRACER
        self.flight_recorder = None
        # cluster ids not yet swept terminal (completion accounting)
        self._open_cids: Set[int] = set()

    # ------------------------------------------------------------------
    # construction

    @classmethod
    def build(
        cls,
        model: Any,
        cfg: Any,
        params: Any,
        serving: Optional[ServingConfig] = None,
        *,
        tokenizer: Any = None,
        eos_token_id: Optional[int] = None,
        seed: int = 0,
        device: Any = None,
        health_config: Optional[HealthConfig] = None,
        ssms: Sequence[Any] = (),
        spec: Any = None,
    ) -> "ClusterManager":
        """Build ``serving.replicas`` in-process replicas (and
        ``serving.standby_replicas`` standbys) on ``device`` (``"cuda"``
        unless the caller names another), params shared by reference.

        ``ssms`` ((model, cfg, params) triples) + ``spec`` turn every
        replica into a SpecInfer pair with its own draft mirror engines;
        disaggregated pools refuse the combination (``validate_cluster``)."""
        serving = serving or ServingConfig()
        serving.validate()
        serving.validate_cluster(
            specinfer=bool(ssms) or getattr(spec, "draft", "ssm") == "early_exit")
        dev = resolve_device(device)
        roles = ["mixed"] * serving.replicas
        if serving.prefill_replicas:
            roles = (["prefill"] * serving.prefill_replicas
                     + ["decode"] * serving.decode_replicas)

        def member(index: int, role: str) -> Replica:
            return Replica.build(index, model, cfg, params, serving, role=role, device=dev,
                                 tokenizer=tokenizer, eos_token_id=eos_token_id, seed=seed,
                                 ssms=ssms, spec=spec)

        replicas = [member(i, roles[i]) for i in range(serving.replicas)]
        standbys = [member(serving.replicas + j, "mixed")
                    for j in range(serving.standby_replicas)]
        return cls(replicas, serving, tokenizer=tokenizer, eos_token_id=eos_token_id,
                   health_config=health_config, standbys=standbys)

    def attach_faults(self, plan):
        """Wire a :class:`~.faults.FaultPlan` (or a built injector, or its
        JSON) into every replica (standbys included) and the migration
        path. Transport kinds (drop/delay/disconnect/partition) are
        injected at an RPC transport, which in-process replicas do not
        have; ``sigkill`` kills a subprocess replica server and
        ``manager_crash`` exercises the journal's recovery: aiming any of
        them at this cluster is a loud error (the JAX package refuses the
        transport kinds and ``sigkill`` in process too). Returns the
        :class:`~.faults.FaultInjector`."""
        from .faults import TRANSPORT_KINDS, FaultInjector, FaultPlan

        if isinstance(plan, str):
            plan = FaultPlan.from_json(plan)
        injector = plan if isinstance(plan, FaultInjector) else FaultInjector(plan)
        if any(f.kind == "sigkill" for f in injector.plan):
            raise ValueError(
                "the 'sigkill' fault kind kills a real subprocess replica server — it "
                "needs replica_transport='socket' (the cluster transport slice); use "
                "'crash' to script surface-level death in process")
        if any(f.kind == "manager_crash" for f in injector.plan):
            raise ValueError(
                "the 'manager_crash' fault kind is recovered from the request journal "
                "(ClusterManager.recover), which comes with the cluster transport slice")
        transport_faults = [f.kind for f in injector.plan if f.kind in TRANSPORT_KINDS]
        if transport_faults:
            raise ValueError(
                f"fault plan contains transport kinds {transport_faults} but this "
                "cluster drives IN-PROCESS replicas (replica_transport='inproc') — "
                "transport faults are injected at the RPC layer, which comes with the "
                "cluster transport slice")
        self.fault_injector = injector
        for rep in list(self.replicas) + self.standbys:
            rep.fault_injector = injector
        return injector

    # ------------------------------------------------------------------
    # submission + placement

    def _tokenize(self, prompt: Union[str, Sequence[int]]):
        if isinstance(prompt, str):
            if self.tokenizer is None:
                raise ValueError("string prompt requires a tokenizer")
            return list(self.tokenizer.encode(prompt)), prompt
        return [int(t) for t in prompt], ""

    def _routable_pos(self, pos: int) -> bool:
        """May the router, failover and migration paths place work at
        this cluster position? DOWN (circuit open) is excluded."""
        return self.health[pos].routable

    def _routable_rep(self, rep: Replica) -> bool:
        return self._routable_pos(self.replicas.index(rep))

    def _drop_sessions(self, pos: int) -> int:
        """Re-home the sessions pinned to the replica at ``pos``: each
        re-pins on its next turn (which re-seeds the replica's prefix
        families on survivors)."""
        rep = self.replicas[pos]
        try:
            rpos = self.router.replicas.index(rep)
        except ValueError:
            return 0  # not in the routing pool (a decode replica)
        dropped = self.router.drop_replica_sessions(rpos)
        if dropped:
            self._log.debug("replica %d: %d session affinities dropped (re-pin on "
                            "survivors)", rep.index, dropped)
        return dropped

    def submit(
        self,
        prompt: Union[str, Sequence[int]],
        gen: Optional[GenerationConfig] = None,
        max_new_tokens: Optional[int] = None,
        session_id: Optional[object] = None,
    ) -> int:
        """Route and queue one request; returns its CLUSTER id at once
        (drive with :meth:`step`). A shed (or no-healthy-replica) request
        is terminal on return (``result`` carries the error)."""
        gen = gen or GenerationConfig()
        if max_new_tokens is not None:
            gen = dataclasses.replace(gen, max_new_tokens=max_new_tokens)
        tokens, text = self._tokenize(prompt)
        cid = self._next_cid
        self._next_cid += 1
        self.stats.submitted += 1
        cr = ClusterRequest(cluster_id=cid, tokens=tokens, prompt_text=text, gen=gen,
                            session_id=session_id, prompt_len=len(tokens), _manager=self)
        self.requests[cid] = cr
        self._open_cids.add(cid)
        self._place(cr, tokens)
        return cid

    def _place_failed(self, cr: ClusterRequest, how: str) -> bool:
        cr.rid = None
        cr.replica = None
        if how == "shed":
            cr.error = ("shed by SLO admission: every replica's queue-delay estimate "
                        f"exceeds slo_queue_delay_s={self.serving.slo_queue_delay_s}")
        else:  # "down"
            cr.error = ("no healthy replica: every replica is circuit-broken (DOWN) — "
                        "the request fails terminally instead of waiting for a probe "
                        "that may never succeed")
        tr = self.tracer
        if tr.enabled:
            tr.event("place_failed", trace_id=cr.cluster_id, how=how)
        if self.flight_recorder is not None:
            self.flight_recorder.dump(self.tracer.lane or "router", "request_error",
                                      step=self._step_counter,
                                      extra={"cluster_id": cr.cluster_id, "how": how})
        return False

    def _place(self, cr: ClusterRequest, known: Sequence[int], *,
               ignore_slo: bool = False) -> bool:
        """Route ``known`` (the prompt, or prompt + tokens generated so far
        on a failover re-admission) and submit it to the chosen replica.
        Returns True when placed; False is TERMINAL — shed, or no healthy
        replica (``cr.error`` set). Re-admissions pass ``ignore_slo``: a
        request admitted once is never shed on its second landing."""
        produced = max(0, len(known) - cr.prompt_len)
        remaining = cr.gen.max_new_tokens - produced
        gen_home = (cr.gen if produced == 0
                    else dataclasses.replace(cr.gen, max_new_tokens=remaining))
        first = cr.retries == 0
        phase = "single"
        if self.disaggregated and any(self._routable_rep(r) for r in self.prefill_pool):
            pos, how = self.router.route(known, cr.session_id, ignore_slo=ignore_slo)
            if pos is None:
                return self._place_failed(cr, how)
            rep = self.replicas[self._routing_pos[pos]]
            if any(self._routable_rep(r) for r in self.decode_pool):
                phase = "prefill"
            else:
                # the decode pool is DOWN: the chosen prefill replica
                # serves both phases (no hold, no doomed migration)
                self._log.warning("decode pool is DOWN — request %d served single-phase "
                                  "on prefill replica %d", cr.cluster_id, rep.index)
        elif self.disaggregated:
            # the prefill pool is DOWN: the decode pool prefills too
            cands = [r for r in self.decode_pool if self._routable_rep(r)]
            if not cands:
                return self._place_failed(cr, "down")
            rep = min(cands, key=lambda r: (r.queue_delay_s(), r.load(), r.index))
            self.stats.record_placement("pool_fallback")
            self._log.warning("prefill pool is DOWN — request %d served single-phase on "
                              "decode replica %d", cr.cluster_id, rep.index)
        else:
            pos, how = self.router.route(known, cr.session_id, ignore_slo=ignore_slo)
            if pos is None:
                return self._place_failed(cr, how)
            rep = self.replicas[self._routing_pos[pos]]
        delay = rep.queue_delay_s()
        if first:
            self.stats.note_arrival(rep.index)
            self.stats.note_queue_delay_s(delay)
        cr.replica = self.replicas.index(rep)
        cr.phase = phase
        if phase == "prefill":
            # the prefill pass only: max_new_tokens=1 makes the prefill-final
            # step (which samples the first output token) the request's last
            # there, and the held slot keeps its pages for the migration
            cr.rid = rep.rm.submit(known, dataclasses.replace(gen_home, max_new_tokens=1),
                                   trace_id=cr.cluster_id)
            rep.rm.hold_on_finish(cr.rid)
        else:
            cr.rid = rep.rm.submit(known, gen_home, trace_id=cr.cluster_id)
        req = rep.rm.requests[cr.rid]
        if first:
            req.profile.replica_id = rep.index
            req.profile.router_queue_delay_s = delay
            cr.profile = req.profile
            # the home may have cut an over-long prompt: its prompt_len is
            # the output boundary
            cr.prompt_len = req.prompt_len
        else:
            # re-admission: the ORIGINAL profile (start time, TTFT) moves
            # to the new home and records the move
            req.profile = cr.profile
            cr.profile.retries = cr.retries
            cr.profile.failover_replica_id = rep.index
            cr.profile.replica_id = rep.index
            cr.profile.router_queue_delay_s = delay
        cr._known = None
        tr = self.tracer
        if tr.enabled:
            tr.event("place", trace_id=cr.cluster_id, replica=rep.index, phase=phase,
                     retries=cr.retries)
        return True

    # ------------------------------------------------------------------
    # fault handling: health transitions and failover re-admission

    def _note_transition(self, pos: int, transition: Optional[str],
                         exc: Optional[BaseException] = None) -> None:
        if transition is None:
            return
        rep = self.replicas[pos]
        tr = self.tracer
        if tr.enabled:
            # on the AFFECTED replica's lane, so a flight-recorder dump of
            # that lane ends with it
            tr.event("health", lane=f"replica{rep.index}", replica=rep.index,
                     state=transition, error=str(self.health[pos].last_error or "")[:200])
        if transition == "suspect":
            self.stats.replica_suspect += 1
            self._log.warning("replica %d SUSPECT: %s", rep.index,
                              self.health[pos].last_error)
        elif transition == "recovered":
            self.stats.replica_recoveries += 1
            self._log.warning("replica %d recovered (circuit closed)", rep.index)
        elif transition == "down":
            self.stats.replica_down += 1
            # the recorded trip, read before failover (_adopt_standby may
            # replace the health record)
            down_at = self.health[pos].down_at_step
            self._on_replica_down(pos, exc)
            if self.flight_recorder is not None:
                self.flight_recorder.dump(
                    f"replica{rep.index}", "replica_down", step=self._step_counter,
                    extra={"replica_index": rep.index,
                           "health_state": HealthState.DOWN.value, "down_at_step": down_at})

    def _on_replica_down(self, pos: int, exc: Optional[BaseException]) -> None:
        """The breaker opened: fail every request on the replica over to
        survivors (recompute re-admission), drop its session pins, and
        tear its scheduler state down so a later probe starts clean."""
        rep = self.replicas[pos]
        self._log.warning("replica %d DOWN (%s) — failing over its requests", rep.index,
                          exc if exc is not None else self.health[pos].last_error)
        self._drop_sessions(pos)
        victims = [cr for cr in self.requests.values()
                   if cr.rid is not None and cr.replica == pos
                   and cr.status not in TERMINAL_STATUSES]
        for cr in victims:
            req = rep.rm.requests[cr.rid]
            # the host token list holds FLUSHED tokens only: the recompute
            # re-admission regenerates anything in flight
            cr._known = list(req.tokens)
            cr.rid = None
            cr.replica = None
            cr.phase = "single"
            self._schedule_failover(cr)
        # queued migrations whose source died are failover victims now
        self._migration_queue = [c for c in self._migration_queue
                                 if self.requests[c].rid is not None]
        self._mig_queued = set(self._migration_queue)
        try:
            rep.abandon()
        except Exception as abandon_exc:  # the pool may be torn mid-step
            self._log.warning("replica %d abandon() failed (%s) — its pool is excluded "
                              "from audits until it recovers", rep.index, abandon_exc)
        if self.standbys:
            self._adopt_standby(pos)

    def _adopt_standby(self, pos: int) -> None:
        """A warm standby takes the dead replica's routing position: the
        dead replica's prefix radix tree (block keys and page bytes) is
        exported and imported on the standby (best effort: a failure
        means a COLD join), then the standby enters routing at ``pos``.
        The dead replica retires for good: its health record is replaced
        by the standby's fresh one."""
        dead = self.replicas[pos]
        standby = self.standbys.pop(0)
        blocks = 0
        try:
            entries = dead.export_prefix_tree()
            if entries:
                blocks = standby.import_prefix_tree(entries)
        except Exception as exc:
            self._log.warning("standby adoption: prefix-tree export from dead replica %d "
                              "failed (%s) — standby %d joins COLD", dead.index, exc,
                              standby.index)
        self.replicas[pos] = standby
        try:
            rpos = self._routing_pos.index(pos)
        except ValueError:
            rpos = None
        if rpos is not None:
            self.router.replicas[rpos] = standby
        self.health.replicas[pos] = ReplicaHealth(pos, self.health.cfg)
        self.stats.standby_adoptions += 1
        self._log.warning("standby replica %d adopted position %d (%d prefix blocks warm; "
                          "%d standbys remain)", standby.index, pos, blocks,
                          len(self.standbys))

    def _schedule_failover(self, cr: ClusterRequest) -> None:
        """Bounded retries with exponential (cluster-step) backoff; past
        the bound the request fails terminally — never a hang."""
        cr.retries += 1
        self.stats.retries += 1
        if cr.retries > self.serving.failover_retries:
            cr.error = (f"replica failed and failover retries exhausted "
                        f"({cr.retries - 1} re-admissions, failover_retries="
                        f"{self.serving.failover_retries})")
            self.stats.failover_errors += 1
            tr = self.tracer
            if tr.enabled:
                tr.event("request_error", trace_id=cr.cluster_id,
                         reason="failover_exhausted")
            if self.flight_recorder is not None:
                self.flight_recorder.dump(self.tracer.lane or "router", "request_error",
                                          step=self._step_counter,
                                          extra={"cluster_id": cr.cluster_id,
                                                 "error": cr.error[:500]})
            return
        backoff = (0 if cr.retries == 1
                   else self.serving.failover_backoff_steps * (2 ** (cr.retries - 2)))
        cr._retry_at_step = self._step_counter + backoff
        self._failovers.append(cr.cluster_id)

    def _run_failovers(self) -> bool:
        """Re-admit requests whose backoff expired. A request that cannot
        be placed (no healthy replica) fails terminally."""
        if not self._failovers:
            return False
        progressed = False
        still: List[int] = []
        for cid in self._failovers:
            cr = self.requests[cid]
            if cr.error is not None or cr.rid is not None:
                continue
            if self._step_counter < cr._retry_at_step:
                still.append(cid)
                continue
            try:
                placed = self._place(cr, cr._known, ignore_slo=True)
            except Exception as exc:
                # the chosen home refused the submission: a health
                # observation and another bounded retry, never an
                # exception out of the drive loop
                pos = cr.replica
                cr.rid = None
                cr.replica = None
                if pos is not None:
                    self._observe_failure(pos, exc, self._step_counter)
                self._schedule_failover(cr)
                progressed = True
                continue
            progressed = True
            if placed:
                self.stats.failovers += 1
                tr = self.tracer
                if tr.enabled:
                    tr.event("failover", trace_id=cid,
                             replica=cr.profile.failover_replica_id, retry=cr.retries)
                self._log.warning("failover: request %d re-admitted on replica %d (retry "
                                  "%d, %d tokens recomputed)", cid,
                                  cr.profile.failover_replica_id, cr.retries, len(cr.tokens))
            else:
                self.stats.failover_errors += 1
        self._failovers = still
        return progressed

    # ------------------------------------------------------------------
    # prefill→decode migration (bounded queue + back-pressure)

    def _queue_migrations(self) -> None:
        """Move newly completed held prefills into the migration FIFO
        (finishing those that owe no decode phase), then apply the
        back-pressure budget: entries past it release their held pages
        and drain through recompute re-admission instead of parking."""
        for cid, cr in list(self.requests.items()):
            if cr.phase != "prefill" or cr.rid is None or cid in self._mig_queued:
                continue
            src = self.replicas[cr.replica]
            req = src.rm.requests[cr.rid]
            if req.status not in TERMINAL_STATUSES or req.pipeline_refs:
                continue
            if req.status is RequestStatus.ERROR:
                # unservable on the prefill pool: terminal with that error
                src.rm.release_held(cr.rid)
                cr.phase = "single"
                continue
            done = len(req.tokens) >= self.serving.max_sequence_length
            if req.tokens[req.prompt_len:]:
                last = req.tokens[-1]
                stops = set(cr.gen.stop_token_ids)
                if self.eos_token_id is not None:
                    stops.add(self.eos_token_id)
                remaining = cr.gen.max_new_tokens - (len(req.tokens) - cr.prompt_len)
                done = done or last in stops or remaining <= 0
            if done:
                # a 1-token budget, a stop token or the length limit: no
                # decode phase owed, it finished on the prefill replica
                src.rm.release_held(cr.rid)
                cr.phase = "single"
                continue
            self._migration_queue.append(cid)
            self._mig_queued.add(cid)
        budget = self.serving.migration_queue_budget
        if budget is not None:
            while len(self._migration_queue) > budget:
                # the newest entries overflow (the FIFO heads keep their
                # pages: they hand off next); the overflow recomputes
                cid = self._migration_queue.pop()
                self._mig_queued.discard(cid)
                self.stats.migration_queue_overflows += 1
                self._recompute_readmit(cid)
        depth = len(self._migration_queue)
        self.stats.migration_queue_depth = depth
        self.stats.migration_queue_peak = max(self.stats.migration_queue_peak, depth)

    def _drain_migration_queue(self) -> bool:
        """Hand queued prefills to the decode pool: page migration when a
        healthy decode replica has capacity; recompute re-admission when
        the decode pool is gone or a migration keeps failing."""
        if not self._migration_queue:
            return False
        progressed = False
        remaining_q: List[int] = []
        for cid in self._migration_queue:
            cr = self.requests[cid]
            if cr.rid is None or cr.error is not None:
                continue  # the source died: the failover path owns it
            if self._step_counter < cr._retry_at_step:
                remaining_q.append(cid)  # migration-failure backoff
                continue
            src = self.replicas[cr.replica]
            req = src.rm.requests[cr.rid]
            dsts = [r for r in self.decode_pool if self._routable_rep(r)]
            if not dsts:
                # the decode pool is DOWN: recompute re-admission frees the
                # held pages and a survivor serves the decode phase
                self._recompute_readmit(cid)
                progressed = True
                continue
            dst = min(dsts, key=lambda r: (r.queue_delay_s(), r.load(), r.index))
            # the decode side runs the REMAINING budget, counted from its
            # own adopted baseline (= the home's prompt_len)
            gen_dst = dataclasses.replace(
                cr.gen, max_new_tokens=cr.gen.max_new_tokens - (req.prompt_len - cr.prompt_len))
            try:
                rid_dst = migrate_request(src, dst, cr.rid, gen_dst, stats=self.stats,
                                          injector=self.fault_injector,
                                          trace_id=cr.cluster_id, tracer=self.tracer)
            except Exception as exc:
                self.stats.migration_failures += 1
                cr.mig_attempts += 1
                self._log.warning("migration of request %d -> replica %d failed (attempt "
                                  "%d): %s", cid, dst.index, cr.mig_attempts, exc)
                if cr.mig_attempts > self.serving.failover_retries:
                    self._recompute_readmit(cid)
                else:
                    cr._retry_at_step = self._step_counter + (
                        self.serving.failover_backoff_steps * (2 ** (cr.mig_attempts - 1)))
                    remaining_q.append(cid)
                progressed = True
                continue
            if rid_dst is None:
                remaining_q.append(cid)  # dst full right now: waits
                continue
            src.rm.release_held(cr.rid)
            cr.replica = self.replicas.index(dst)
            cr.rid = rid_dst
            cr.phase = "decode"
            cr.profile.replica_id = dst.index
            progressed = True
        self._migration_queue = remaining_q
        self._mig_queued = set(remaining_q)
        self.stats.migration_queue_depth = len(remaining_q)
        return progressed

    def _recompute_readmit(self, cid: int) -> None:
        """Drain one held prefill WITHOUT moving pages: release the hold
        and resubmit prompt + first token through the recompute path on
        the best surviving replica (the decode pool when any of it is
        healthy, else any healthy replica)."""
        cr = self.requests[cid]
        src = self.replicas[cr.replica]
        req = src.rm.requests[cr.rid]
        known = list(req.tokens)
        src.rm.release_held(cr.rid)
        cr.rid = None
        cr.replica = None
        cr.phase = "single"
        cr.retries += 1
        self.stats.retries += 1
        cands = ([r for r in self.decode_pool if self._routable_rep(r)]
                 or [r for r in self.replicas if self._routable_rep(r)])
        if not cands:
            cr._known = known
            cr.error = ("no healthy replica to drain the held prefill to — the request "
                        "fails terminally instead of parking")
            self.stats.failover_errors += 1
            return
        rep = min(cands, key=lambda r: (r.queue_delay_s(), r.load(), r.index))
        produced = len(known) - cr.prompt_len
        gen_home = dataclasses.replace(cr.gen, max_new_tokens=cr.gen.max_new_tokens - produced)
        cr.rid = rep.rm.submit(known, gen_home, trace_id=cr.cluster_id)
        cr.replica = self.replicas.index(rep)
        rep.rm.requests[cr.rid].profile = cr.profile
        cr.profile.retries = cr.retries
        cr.profile.failover_replica_id = rep.index
        cr.profile.replica_id = rep.index
        tr = self.tracer
        if tr.enabled:
            tr.event("recompute_readmit", trace_id=cid, replica=rep.index,
                     n_tokens=len(known))
        self._log.debug("migration back-pressure: request %d drained to replica %d via "
                        "recompute (%d tokens re-prefill)", cid, rep.index, len(known))

    # ------------------------------------------------------------------
    # the drive loop

    def _observe_failure(self, pos: int, exc: BaseException, step_no: int) -> None:
        """ONE health failure observation per replica per cluster step."""
        if pos in self._failed_obs:
            return
        self._failed_obs.add(pos)
        self._note_transition(pos, self.health[pos].record_failure(exc, step_no), exc)

    def _step_replicas(self, step_no: int) -> bool:
        """Step every steppable replica in index order under the health
        monitor: a DOWN replica only when its backoff lets it probe."""
        progressed = False
        for pos in range(len(self.replicas)):
            rep = self.replicas[pos]
            h = self.health[pos]
            if h.state is HealthState.DOWN:
                if not h.maybe_probe(step_no):
                    continue
                self.stats.probes += 1
                if self.tracer.enabled:
                    self.tracer.event("probe", replica=rep.index, backoff=h.backoff_steps)
                self._log.warning("replica %d probing (circuit half-open after %d-step "
                                  "backoff)", rep.index, h.backoff_steps)
                progressed = True
            if not rep.has_work():
                continue
            t0 = time.perf_counter()
            try:
                stepped = rep.step()
            except Exception as exc:
                self.stats.step_faults += 1
                self._observe_failure(pos, exc, step_no)
                progressed = True
                continue
            latency = (time.perf_counter() - t0) + rep.injected_latency_s
            self._note_transition(pos, h.record_success(latency, step_no, had_work=True))
            progressed = stepped or progressed
        return progressed

    def step(self) -> bool:
        """One cluster step: advance every steppable replica under the
        health monitor, settle prefill→decode migrations, then run any
        due failover re-admissions. Returns False when no replica has
        work left and nothing is pending recovery."""
        t_step = time.perf_counter()
        self._step_counter += 1
        step_no = self._step_counter
        self._failed_obs = set()
        progressed = self._step_replicas(step_no)
        if self.disaggregated:
            self._queue_migrations()
            progressed = self._drain_migration_queue() or progressed
        progressed = self._run_failovers() or progressed
        if self._failovers or self._migration_queue:
            # pending recoveries keep the drive loop alive through their
            # backoff windows: a generate must never strand a request
            # between homes
            progressed = True
        self._sweep_completions()
        self.stats.note_cluster_step_ms((time.perf_counter() - t_step) * 1000.0)
        if step_no % 200 == 0:
            self._log.debug("%s", self.stats.report([r.rm.stats for r in self.replicas]))
        return progressed

    def drain(self) -> None:
        """Flush every live replica's pipeline, then settle the migrations
        those flushes unblocked. A flush failure is a replica failure —
        the same health path as a step exception."""
        for pos, rep in enumerate(self.replicas):
            if self.health[pos].state is HealthState.DOWN:
                continue
            try:
                rep.drain()
            except Exception as exc:
                self.stats.step_faults += 1
                self._note_transition(
                    pos, self.health[pos].record_failure(exc, self._step_counter), exc)
        if self.disaggregated:
            self._queue_migrations()
            self._drain_migration_queue()
        self._run_failovers()
        self._sweep_completions()

    def _sweep_completions(self) -> None:
        """Count each request that went terminal since the last sweep as a
        completion of the replica that finished it (errors excluded)."""
        closed = []
        for cid in self._open_cids:
            cr = self.requests[cid]
            st = cr.status
            if st not in TERMINAL_STATUSES:
                continue
            closed.append(cid)
            rep_idx = int(cr.profile.replica_id)
            if st is not RequestStatus.ERROR and rep_idx >= 0:
                self.stats.note_completion(rep_idx)
        for cid in closed:
            self._open_cids.discard(cid)

    # ------------------------------------------------------------------
    # results

    def cluster_stats(self) -> Dict[str, object]:
        """ClusterStats snapshot over the live per-replica stats."""
        return self.stats.snapshot([r.rm.stats for r in self.replicas])

    def health_snapshot(self) -> List[str]:
        return self.health.snapshot()

    def check_no_leaks(self) -> None:
        """Page-pool audits on every replica that is not circuit-broken (a
        DOWN replica's pool re-enters the audit when it probes back)."""
        for pos, rep in enumerate(self.replicas):
            if self.health[pos].state is HealthState.DOWN:
                continue
            rep.check_no_leaks()

    def result(self, cid: int) -> GenerationResult:
        cr = self.requests[cid]
        out = cr.output_tokens
        text = self.tokenizer.decode(out) if self.tokenizer is not None else ""
        error = cr.error
        if error is None and cr.rid is not None:
            error = self.replicas[cr.replica].rm.requests[cr.rid].error
        return GenerationResult(request_id=cid, prompt=cr.prompt_text,
                                input_tokens=list(cr.tokens), output_tokens=list(out),
                                output_text=text, profile=cr.profile, error=error)

    def _terminal(self, cid: int) -> bool:
        return self.requests[cid].status in TERMINAL_STATUSES

    def generate(
        self,
        prompts: Union[str, Sequence[Union[str, Sequence[int]]]],
        gen: Optional[GenerationConfig] = None,
        max_new_tokens: Optional[int] = None,
        session_ids: Optional[Sequence[object]] = None,
    ) -> List[GenerationResult]:
        """Blocking generate across the cluster (router-placed)."""
        if isinstance(prompts, str):
            prompts = [prompts]
        cids = [self.submit(p, gen, max_new_tokens,
                            session_id=session_ids[i] if session_ids else None)
                for i, p in enumerate(prompts)]
        while any(not self._terminal(c) for c in cids):
            if not self.step():
                break
        self.drain()
        return [self.result(c) for c in cids]

    def generate_stream(
        self,
        prompts: Union[str, Sequence[Union[str, Sequence[int]]]],
        gen: Optional[GenerationConfig] = None,
        max_new_tokens: Optional[int] = None,
        session_ids: Optional[Sequence[object]] = None,
    ) -> Iterator[StreamEvent]:
        """Streaming generate across the cluster: one StreamEvent per
        drained token (``request_id`` is the CLUSTER id) and a terminal
        event per request (``error`` set for sheds and failures). Token
        counts are monotone across a migration (the first output token is
        visible on both sides of the hand-off) and across a failover (the
        re-admission's known tokens are exactly the streamed prefix)."""
        if isinstance(prompts, str):
            prompts = [prompts]
        cids = [self.submit(p, gen, max_new_tokens,
                            session_id=session_ids[i] if session_ids else None)
                for i, p in enumerate(prompts)]
        sent = {c: 0 for c in cids}
        finished: set = set()

        def drain_events():
            for c in cids:
                if c in finished:
                    continue
                cr = self.requests[c]
                out = cr.output_tokens
                while sent[c] < len(out):
                    tok = out[sent[c]]
                    sent[c] += 1
                    yield StreamEvent(c, int(tok))
                if self._terminal(c):
                    finished.add(c)
                    err = cr.error
                    if err is None and cr.rid is not None:
                        err = self.replicas[cr.replica].rm.requests[cr.rid].error
                    yield StreamEvent(c, None, done=True, error=err)

        while len(finished) < len(cids):
            progressed = self.step()
            yield from drain_events()
            if not progressed and len(finished) < len(cids):
                self.drain()
                yield from drain_events()
                if len(finished) < len(cids):
                    break  # nothing schedulable remains
        self.drain()
        yield from drain_events()
