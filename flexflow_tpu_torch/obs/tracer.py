"""Structured tracing — the span/event recorder of the port's
observability layer (counterpart of ``flexflow_tpu/obs/tracer.py``,
copied: it is host code and imports nothing of either framework).

Design constraints, in order:

1. **Disabled mode must be free.** Every emission site in the serve
   stack guards on ``tracer.enabled`` (a plain bool attribute read)
   before building ANY argument, and the module-level
   :data:`NULL_TRACER` never records — with tracing off, the scheduler
   step loop does no observability work beyond that attribute check
   (tests/test_torch_obs.py proves it: zero obs-frame allocations,
   identical engine dispatch counts).
2. **Dual clock.** Every event carries BOTH a wall-clock stamp
   (``time.perf_counter()``, what the Chrome/Perfetto export renders)
   and a deterministic step stamp (the owner's scheduler step counter,
   what tests assert on). Nothing in the trace pipeline ever *decides*
   anything off wall time.
3. **Flat events.** An event is one flat dict of primitives
   (str/int/float/None), so it serializes to JSON unchanged and a
   cluster's replicas can ship theirs home to one timeline.

One :class:`TraceBuffer` holds the run's events; components record
through per-lane :class:`Tracer` views (``buffer.tracer("engine",
clock=...)``). Lanes become Perfetto process rows in the Chrome export
(obs/export.py); the optional :class:`~.flight_recorder.FlightRecorder`
observes every append for its bounded per-lane ring.
"""
from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Optional

__all__ = ["TraceBuffer", "Tracer", "NullTracer", "NULL_TRACER"]


def _zero() -> int:
    return 0


class NullTracer:
    """The disabled tracer: ``enabled`` is False and stays False.

    Emission sites check ``tracer.enabled`` BEFORE building event
    arguments, so on the hot path a disabled run costs one attribute
    read and one branch — the record methods below exist only so that
    an unguarded call is still safe (and so tests can monkeypatch them
    to raise, proving the guards hold)."""

    __slots__ = ()
    enabled = False
    lane = ""

    def event(self, name: str, **kw: Any) -> None:
        return None

    def span(self, name: str, **kw: Any) -> "_NullSpan":
        return _NULL_SPAN


class _NullSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()

#: The process-wide disabled tracer every serve component starts with.
NULL_TRACER = NullTracer()


class TraceBuffer:
    """The run's event store (append-only, bounded).

    ``capacity`` bounds host memory on long runs: past it the oldest
    events drop and ``dropped`` counts them — an export of a bounded
    buffer says how much history it lost instead of silently
    truncating."""

    def __init__(self, capacity: int = 200_000):
        self.capacity = int(capacity)
        self.events: List[Dict[str, Any]] = []
        self.dropped = 0
        #: optional FlightRecorder observing every append
        self.recorder = None

    @property
    def enabled(self) -> bool:
        return True

    def append(self, ev: Dict[str, Any]) -> None:
        self.events.append(ev)
        if len(self.events) > self.capacity:
            overflow = len(self.events) - self.capacity
            del self.events[:overflow]
            self.dropped += overflow
        rec = self.recorder
        if rec is not None:
            rec.observe(ev)

    def extend(self, events, lane: Optional[str] = None) -> None:
        """Merge events shipped from another buffer. ``lane`` re-tags
        them when the shipper did not know its lane; events are appended
        one by one so the flight recorder observes each."""
        for ev in events:
            if lane is not None and not ev.get("lane"):
                ev = dict(ev)
                ev["lane"] = lane
            self.append(ev)

    def drain(self) -> List[Dict[str, Any]]:
        """Take (and clear) the buffered events."""
        out = self.events
        self.events = []
        return out

    def tracer(self, lane: str, clock: Optional[Callable[[], int]] = None
               ) -> "Tracer":
        """A per-lane recording view over this buffer."""
        return Tracer(self, lane, clock)


class Tracer:
    """A lane-tagged, clock-bound view over a :class:`TraceBuffer`.

    ``clock`` is the DETERMINISTIC half of the dual clock — a zero-arg
    callable returning the owner's step counter (scheduler steps for a
    RequestManager or SpecInferManager). Wall time is stamped alongside
    on every event.
    """

    __slots__ = ("buffer", "lane", "clock")

    enabled = True

    def __init__(self, buffer: TraceBuffer, lane: str,
                 clock: Optional[Callable[[], int]] = None):
        self.buffer = buffer
        self.lane = lane
        self.clock = clock or _zero

    def event(
        self,
        name: str,
        *,
        trace_id: int = -1,
        dur: float = 0.0,
        t: Optional[float] = None,
        step: Optional[int] = None,
        lane: Optional[str] = None,
        **attrs: Any,
    ) -> None:
        """Record one instant (``dur`` 0) or completed span. ``attrs``
        must be host primitives (never a device tensor) — they ride the
        JSON exports verbatim."""
        ev: Dict[str, Any] = {
            "name": name,
            "lane": self.lane if lane is None else lane,
            "trace_id": int(trace_id),
            "t": time.perf_counter() if t is None else t,
            "step": self.clock() if step is None else int(step),
            "dur": float(dur),
        }
        if attrs:
            ev["attrs"] = attrs
        self.buffer.append(ev)

    def span(self, name: str, *, trace_id: int = -1,
             lane: Optional[str] = None, **attrs: Any) -> "_Span":
        """Context manager recording ``name`` with its measured wall
        duration (step stamped at ENTRY — the deterministic clock of a
        span is when it began)."""
        return _Span(self, name, trace_id, lane, attrs)


class _Span:
    __slots__ = ("_tr", "_name", "_tid", "_lane", "_attrs", "_t0", "_s0")

    def __init__(self, tracer: Tracer, name: str, trace_id: int,
                 lane: Optional[str], attrs: Dict[str, Any]):
        self._tr = tracer
        self._name = name
        self._tid = trace_id
        self._lane = lane
        self._attrs = attrs

    def __enter__(self):
        self._t0 = time.perf_counter()
        self._s0 = self._tr.clock()
        return self

    def __exit__(self, exc_type, exc, tb):
        self._tr.event(
            self._name,
            trace_id=self._tid,
            t=self._t0,
            dur=time.perf_counter() - self._t0,
            step=self._s0,
            lane=self._lane,
            **(
                dict(self._attrs, error=type(exc).__name__)
                if exc_type is not None else self._attrs
            ),
        )
        return False
