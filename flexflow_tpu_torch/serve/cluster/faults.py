"""Deterministic fault injection for cluster serving (the JAX package's
``serve/cluster/faults.py``, copied: host code).

A failover that only reproduces under a real outage was never tested, so
the harness ships with the feature: a :class:`FaultPlan` scripts exactly
which replica fails, how, and at which replica-local step, and the same
plan replays the same scenario bit for bit.

Faults are wired at the :class:`~.replica.Replica` surface, the same
boundary a multi-host deployment puts RPC behind, so every injected
failure looks to the manager like a remote replica failing:

=============  ==========================================================
kind           effect (at replica-local step ``step``, 1-based)
=============  ==========================================================
``crash``      every step from ``step`` on raises :class:`InjectedFault`
               — a permanently dead replica (probes keep failing)
``transient``  steps ``[step, step+count)`` raise, later steps succeed —
               a blip the health machine should absorb (or, past the
               failure threshold, a trip that PROBING later recovers)
``latency``    steps ``[step, step+count)`` report ``seconds`` of extra
               latency to the health monitor (no real sleep)
``migration``  the next ``count`` prefill→decode migrations OFF this
               replica raise :class:`InjectedMigrationFault` before any
               page moves (the manager retries with backoff, then falls
               back to recompute re-admission)
``oom``        at ``step``, up to ``pages`` free pages are taken out of
               the replica's pool for ``count`` steps — page pressure
               that must surface as preemptions or held admissions,
               never as a leak or a hang. Call :meth:`FaultInjector.
               release_all` before auditing pools.
=============  ==========================================================

The transport kinds (``drop``, ``delay``, ``disconnect``, ``partition``,
injected at an RPC transport) and the process kinds (``sigkill`` of a
subprocess replica server, ``manager_crash`` for journal recovery) are
kept in the plan format, so plans round-trip with the JAX package's, but
nothing here injects them: their transport, servers and journal come
with the cluster transport slice, and ``ClusterManager.attach_faults``
refuses them on the in-process cluster (the JAX package refuses the
transport kinds and ``sigkill`` there too).

``FaultPlan.random(seed, n_replicas)`` draws a reproducible plan for
chaos tests; ``from_json``/``to_json`` round-trip plans for the serve
command's ``--fault-plan``.
"""
from __future__ import annotations

import dataclasses
import json
import random
from typing import Dict, List, Optional, Sequence, Tuple

from ...logging_utils import get_logger


#: faults injected at the Replica surface
REPLICA_KINDS = ("crash", "transient", "latency", "migration", "oom")
#: faults injected at the RPC transport (remote replicas only)
TRANSPORT_KINDS = ("drop", "delay", "disconnect", "partition")
#: PROCESS-level faults: real process death, not surface-level
#: raises — "sigkill" SIGKILLs a registered subprocess replica server
#: at the replica's client-side step (socket clusters only; the RPC
#: layer then sees a REAL dead peer), "manager_crash" raises
#: :class:`InjectedManagerCrash` at a scripted CLUSTER step so the
#: caller can drop the manager and exercise journal recovery
#: (``ClusterManager.recover``) where a real SIGKILL would restart
#: the process.
PROCESS_KINDS = ("sigkill", "manager_crash")
KINDS = REPLICA_KINDS + TRANSPORT_KINDS + PROCESS_KINDS


class InjectedFault(RuntimeError):
    """An injected replica failure (crash/transient step exception)."""


class InjectedMigrationFault(InjectedFault):
    """An injected prefill→decode migration failure."""


@dataclasses.dataclass(frozen=True)
class Fault:
    """One scripted failure. ``step`` is REPLICA-LOCAL (that replica's
    Nth ``step()`` call), which keeps plans deterministic no matter how
    the cluster interleaves its replicas."""

    kind: str
    replica: int
    step: int
    count: int = 1        # transient/latency/oom: steps; migration: fails
    seconds: float = 1.0  # latency: injected extra seconds per step
    pages: int = 4        # oom: free pages taken out of the pool

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(
                f"unknown fault kind {self.kind!r} (expected one of "
                f"{KINDS})"
            )
        if self.replica < 0 or self.step < 1 or self.count < 1:
            raise ValueError(
                f"fault needs replica >= 0, step >= 1, count >= 1 "
                f"(got {self})"
            )


class FaultPlan:
    """An ordered, immutable set of :class:`Fault` — the whole scenario."""

    def __init__(self, faults: Sequence[Fault] = ()):
        self.faults: Tuple[Fault, ...] = tuple(faults)

    def __iter__(self):
        return iter(self.faults)

    def __len__(self):
        return len(self.faults)

    def __repr__(self):
        return f"FaultPlan({list(self.faults)!r})"

    def to_json(self) -> str:
        return json.dumps([dataclasses.asdict(f) for f in self.faults])

    @classmethod
    def from_json(cls, text: str) -> "FaultPlan":
        """Parse a plan from a JSON list of fault dicts, e.g.
        ``[{"kind": "crash", "replica": 1, "step": 20}]``."""
        spec = json.loads(text)
        if isinstance(spec, dict):
            spec = [spec]
        return cls([Fault(**f) for f in spec])

    @classmethod
    def random(
        cls,
        seed: int,
        n_replicas: int,
        *,
        horizon: int = 120,
        n_faults: Optional[int] = None,
        kinds: Sequence[str] = REPLICA_KINDS,
        include_transport: bool = False,
        include_process: bool = False,
    ) -> "FaultPlan":
        """A reproducible random plan: same seed → same plan, always
        (stdlib ``random.Random`` — no global RNG state touched).
        Defaults to the replica kinds;
        ``include_transport=True`` adds the wire kinds (remote replicas
        only) and ``include_process=True`` adds the process kinds
        (sigkill needs a socket cluster + registered pids;
        manager_crash needs journal recovery) — or pass
        ``kinds`` explicitly for full control."""
        kinds = tuple(kinds)
        if include_transport:
            kinds += tuple(k for k in TRANSPORT_KINDS if k not in kinds)
        if include_process:
            kinds += tuple(k for k in PROCESS_KINDS if k not in kinds)
        rng = random.Random(seed)
        n = n_faults if n_faults is not None else rng.randint(1, 3)
        faults = []
        for _ in range(n):
            faults.append(Fault(
                kind=rng.choice(list(kinds)),
                replica=rng.randrange(n_replicas),
                step=rng.randint(2, max(2, horizon)),
                count=rng.randint(1, 4),
                seconds=round(rng.uniform(0.5, 3.0), 3),
                pages=rng.randint(1, 6),
            ))
        return cls(faults)


class FaultInjector:
    """Executes a :class:`FaultPlan` against live replicas.

    One injector serves the whole cluster: ``Replica.step`` calls
    :meth:`on_step` (which may raise, report latency, or squeeze the
    page pool) and ``migration.migrate_request`` calls
    :meth:`migration_fault`. ``fired`` records every injection
    ``(kind, replica, step)`` for tests and timelines.
    """

    def __init__(self, plan: FaultPlan):
        self.plan = plan
        self.fired: List[Dict[str, object]] = []
        self._logged_crash: set = set()
        # per-fault consumed migration failures (Fault is frozen)
        self._mig_left: Dict[int, int] = {
            i: f.count for i, f in enumerate(plan) if f.kind == "migration"
        }
        # replica index -> (release_at_step, [held pages], pager)
        self._held: Dict[int, Tuple[int, List[int], object]] = {}
        self._log = get_logger("serve")

    # ------------------------------------------------------------------

    def _fire(self, fault: Fault, step_no: int, **extra) -> None:
        rec = {"kind": fault.kind, "replica": fault.replica,
               "step": int(step_no), **extra}
        self.fired.append(rec)
        self._log.debug("fault injected: %s", rec)

    def on_step(self, replica) -> None:
        """Consulted at the top of ``Replica.step``. May raise
        :class:`InjectedFault`; otherwise accumulates any scripted
        latency into ``replica.injected_latency_s`` and applies/releases
        page-pool pressure."""
        idx, sn = replica.index, replica.steps_taken
        self._tick_oom(replica)
        for fault in self.plan:
            if fault.replica != idx:
                continue
            if fault.kind == "crash" and sn >= fault.step:
                if idx not in self._logged_crash:
                    self._logged_crash.add(idx)
                    self._fire(fault, sn)
                raise InjectedFault(
                    f"injected crash (replica {idx}, step {sn})"
                )
            if (
                fault.kind == "transient"
                and fault.step <= sn < fault.step + fault.count
            ):
                self._fire(fault, sn)
                raise InjectedFault(
                    f"injected transient step exception (replica {idx}, "
                    f"step {sn})"
                )
            if (
                fault.kind == "latency"
                and fault.step <= sn < fault.step + fault.count
            ):
                replica.injected_latency_s += fault.seconds
                self._fire(fault, sn, seconds=fault.seconds)
            if fault.kind == "oom" and sn == fault.step:
                self._grab_pages(replica, fault)

    def migration_fault(self, src) -> None:
        """Consulted at the top of ``migrate_request`` (before any
        adoption or page movement, so a failure leaves nothing to roll
        back on THIS side — exceptions later in the hand-off exercise
        the destination rollback path instead)."""
        for i, fault in enumerate(self.plan):
            if fault.kind != "migration" or fault.replica != src.index:
                continue
            if src.steps_taken >= fault.step and self._mig_left.get(i, 0) > 0:
                self._mig_left[i] -= 1
                self._fire(fault, src.steps_taken)
                raise InjectedMigrationFault(
                    f"injected migration failure (source replica "
                    f"{src.index})"
                )

    # ------------------------------------------------------------------
    # oom: hold free pages as an external owner for a step window

    def _grab_pages(self, replica, fault: Fault) -> None:
        pager = getattr(replica.engine, "pager", None)
        if pager is None:
            return  # dense layout: nothing to squeeze
        held: List[int] = []
        for _ in range(fault.pages):
            page = pager.take_free_page()
            if page is None:
                break
            pager.acquire(page)
            held.append(page)
        if held:
            self._held[replica.index] = (
                replica.steps_taken + fault.count, held, pager
            )
            self._fire(fault, replica.steps_taken, pages=len(held))

    def _tick_oom(self, replica) -> None:
        entry = self._held.get(replica.index)
        if entry is not None and replica.steps_taken >= entry[0]:
            self._release(replica.index)

    def _release(self, idx: int) -> None:
        release_at, held, pager = self._held.pop(idx)
        for page in held:
            pager.release_ref(page)

    def release_all(self) -> None:
        """Return every page the oom faults still hold — call before a
        pool leak audit (``check_no_leaks``) or at the end of a run
        whose window outlived the workload."""
        for idx in list(self._held):
            self._release(idx)

    def held_pages(self, idx: int) -> int:
        entry = self._held.get(idx)
        return len(entry[1]) if entry else 0
