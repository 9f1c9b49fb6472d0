"""Cluster serving, in process — N engine replicas behind a prefix-aware
router, with optional disaggregated prefill/decode pools (counterpart of
``flexflow_tpu/serve/cluster``).

One process drives N :class:`Replica` — each its own
:class:`~flexflow_tpu_torch.serve.InferenceEngine` (its own KV page pool
and prefix-cache radix tree; params shared by reference on the one
device) — behind a :class:`Router` that places each request by
prefix-cache affinity (longest radix-tree match), session affinity and
SLO-aware admission with load shedding. Disaggregation
(``ServingConfig.prefill_replicas`` / ``decode_replicas``) ships
prefilled KV PAGES from a prefill replica to a decode replica
(:mod:`.migration`, byte-exact over fp/int8/int4 pools).

Entry points::

    cm = ClusterManager.build(llama, cfg, params, serving)
    cm.generate(prompts, max_new_tokens=32)      # blocking
    cid = cm.submit(prompt, session_id="chat-7") # non-blocking
    for ev in cm.generate_stream(prompts): ...   # per-token events

or ``LLM.compile(ServingConfig(replicas=2, ...))``.

Fault tolerance (:mod:`.health`, :mod:`.faults`): a per-replica health
state machine with a circuit breaker; a DOWN replica's requests re-admit
to survivors through recompute (bounded retries, a terminal
``GenerationResult.error`` past them — never a hang); warm standbys
(``ServingConfig.standby_replicas``) adopt a dead replica's position and
prefix families. Failure scenarios are scripted with :class:`FaultPlan`
(``ClusterManager.attach_faults``).

Telemetry: :class:`flexflow_tpu_torch.metrics.ClusterStats` through
``ClusterManager.cluster_stats()``; per-request
``ProfileInfo.replica_id`` / ``router_queue_delay_s`` / ``retries`` /
``failover_replica_id``.

The RPC transports, remote replicas, the replica server, the durable
journal and live reconfiguration come with the cluster transport slice.
"""
from .faults import (
    KINDS,
    PROCESS_KINDS,
    REPLICA_KINDS,
    TRANSPORT_KINDS,
    Fault,
    FaultInjector,
    FaultPlan,
    InjectedFault,
    InjectedMigrationFault,
)
from .health import HealthConfig, HealthMonitor, HealthState, ReplicaHealth
from .manager import ClusterManager, ClusterRequest
from .migration import migrate_request
from .replica import ROLES, Replica
from .router import POLICIES, Router

__all__ = [
    "ClusterManager",
    "ClusterRequest",
    "Replica",
    "ROLES",
    "Router",
    "POLICIES",
    "migrate_request",
    "HealthConfig",
    "HealthMonitor",
    "HealthState",
    "ReplicaHealth",
    "Fault",
    "FaultPlan",
    "FaultInjector",
    "InjectedFault",
    "InjectedMigrationFault",
    "KINDS",
    "REPLICA_KINDS",
    "TRANSPORT_KINDS",
    "PROCESS_KINDS",
]
