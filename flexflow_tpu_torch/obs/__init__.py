"""flexflow_tpu_torch.obs — request tracing, metrics export and the
failure flight recorder (counterpart of ``flexflow_tpu/obs``).

* :mod:`.tracer` — a low-overhead span/event recorder with a DUAL
  clock: wall time for humans and exports, the scheduler's step count
  for tests. Request-lifecycle events (admit → prefix_lookup →
  prefill_chunk* → decode/mixed/sync steps → spec draft/verify →
  flush → first_token → terminal) flow from the RequestManager, the
  engine's dispatch chokepoint (``InferenceEngine.count_dispatch``) and
  SpecInfer. Disabled (the default, :data:`NULL_TRACER`) the layer costs
  one attribute read per emission site.
* :mod:`.export` — Chrome/Perfetto ``trace_event`` JSON and a Prometheus
  text snapshot derived from ``SchedulerStats``/``ClusterStats``/
  ``ProfileInfo``, with a drift guard asserting every counter is
  exported or explicitly excluded.
* :mod:`.flight_recorder` — a bounded per-lane ring of recent events
  that dumps a REDACTED post-mortem on a terminal request error.

Entry point: :func:`attach_observability` wires a tracer (and
optionally a recorder) onto a RequestManager, a SpecInferManager, a
cluster :class:`~flexflow_tpu_torch.serve.cluster.Replica` or a
:class:`~flexflow_tpu_torch.serve.cluster.ClusterManager` (one lane a
replica plus the router's lane; the flight recorder dumps a replica's
lane when it circuit-breaks); the CLI exposes ``--trace-out`` /
``--metrics-out`` / ``--flight-recorder`` on ``python -m
flexflow_tpu_torch serve``.
"""
from __future__ import annotations

from typing import Optional

from .export import (
    ExportDriftError,
    check_export_coverage,
    chrome_trace,
    prometheus_text,
    write_chrome_trace,
    write_prometheus,
)
from .flight_recorder import REDACTED_ATTRS, FlightRecorder
from .tracer import NULL_TRACER, NullTracer, TraceBuffer, Tracer

__all__ = [
    "TraceBuffer",
    "Tracer",
    "NullTracer",
    "NULL_TRACER",
    "FlightRecorder",
    "REDACTED_ATTRS",
    "chrome_trace",
    "write_chrome_trace",
    "prometheus_text",
    "write_prometheus",
    "check_export_coverage",
    "ExportDriftError",
    "attach_observability",
]


def _attach_rm(rm, buffer: TraceBuffer, lane: str, recorder) -> None:
    """Wire one scheduler (RequestManager or SpecInferManager): the
    manager and every engine it keeps in sync share ONE lane-tagged
    tracer whose deterministic clock is the scheduler step counter."""
    tr = buffer.tracer(lane, clock=lambda: rm._step_counter)
    rm.tracer = tr
    rm.flight_recorder = recorder
    for eng in rm._engines():
        eng.tracer = tr


def _attach_replica(rep, buffer: TraceBuffer, recorder) -> None:
    _attach_rm(rep.rm, buffer, f"replica{rep.index}", recorder)


def attach_observability(
    target,
    *,
    buffer: Optional[TraceBuffer] = None,
    recorder: Optional[FlightRecorder] = None,
    capacity: int = 200_000,
) -> TraceBuffer:
    """Enable tracing on ``target`` — a ClusterManager, a Replica, or a
    bare RequestManager/SpecInferManager — and return the
    :class:`TraceBuffer` that collects the run's events (export it with
    :func:`write_chrome_trace` / :func:`prometheus_text`). A cluster
    traces its router and manager on the ``router`` lane (clocked by
    cluster steps) and each replica, standbys included, on its own
    ``replica<index>`` lane. ``recorder`` additionally arms the flight
    recorder's per-lane ring and its dumps (a terminal request error; a
    replica's DOWN trip dumps that replica's lane). Duck-typed, so the
    serve stack never imports this package on its hot path."""
    if buffer is None:
        buffer = TraceBuffer(capacity)
    if recorder is not None:
        buffer.recorder = recorder
    if hasattr(target, "replicas") and hasattr(target, "router"):
        target.tracer = buffer.tracer("router", clock=lambda: target._step_counter)
        target.flight_recorder = recorder
        for rep in list(target.replicas) + list(getattr(target, "standbys", ())):
            _attach_replica(rep, buffer, recorder)
        return buffer
    if hasattr(target, "rm") and hasattr(target, "index"):
        _attach_replica(target, buffer, recorder)
        return buffer
    if hasattr(target, "engine") and hasattr(target, "_engines"):
        _attach_rm(target, buffer, "engine", recorder)
        return buffer
    raise TypeError(
        f"attach_observability: unsupported target {type(target).__name__}"
        " (expected a ClusterManager, a Replica, a RequestManager or a "
        "SpecInferManager)"
    )
