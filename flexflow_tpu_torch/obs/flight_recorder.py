"""Failure flight recorder — a bounded ring of recent trace events that
dumps a redacted post-mortem when something dies (counterpart of
``flexflow_tpu/obs/flight_recorder.py``, copied: host code).

The recorder observes every event entering a
:class:`~.tracer.TraceBuffer` (``buffer.recorder = recorder``) and
keeps the last ``capacity`` events PER LANE, so a dump is that lane's
final moments, not a run-wide haystack. Dumps fire on a **terminal
request error** (a request the KV pool or the cache can never hold,
RequestManager._finish; a shed or a request past its failover retries,
ClusterManager) and on a cluster replica's **DOWN trip** (that replica's
lane, from the ClusterManager's health-transition hook).

Every dump is **redacted** before it leaves the process: attribute keys
carrying user content (token ids, prompt text) are stripped, so a
post-mortem can be attached to a bug report without shipping the
prompt. What remains is structure: event names, lanes, trace ids, the
dual clock stamps, counters.
"""
from __future__ import annotations

import collections
import json
import os
from typing import Any, Deque, Dict, List, Optional

__all__ = ["FlightRecorder", "REDACTED_ATTRS"]

#: attribute keys stripped from dumped events — user content never
#: rides a post-mortem.
REDACTED_ATTRS = frozenset({"tokens", "prompt", "text", "output_text"})


def redact_event(ev: Dict[str, Any]) -> Dict[str, Any]:
    """A copy of ``ev`` with user-content attribute keys removed (and
    a marker recording that redaction happened)."""
    attrs = ev.get("attrs")
    if not attrs or not (REDACTED_ATTRS & attrs.keys()):
        return dict(ev)
    out = dict(ev)
    out["attrs"] = {
        k: v for k, v in attrs.items() if k not in REDACTED_ATTRS
    }
    out["attrs"]["redacted"] = True
    return out


class FlightRecorder:
    """Bounded per-lane event ring + dump sink (see module docstring).

    ``out_dir`` (optional) writes each dump as
    ``flightrec_<lane>_<reason>_<step>.json``; every dump is also kept
    on ``self.dumps`` (tests and the CLI read it back)."""

    def __init__(self, capacity: int = 256,
                 out_dir: Optional[str] = None):
        self.capacity = int(capacity)
        self.out_dir = out_dir
        self._rings: Dict[str, Deque[Dict[str, Any]]] = {}
        self.dumps: List[Dict[str, Any]] = []
        self.paths: List[str] = []

    # ------------------------------------------------------------------

    def observe(self, ev: Dict[str, Any]) -> None:
        """One event entering the trace buffer (called per append)."""
        lane = str(ev.get("lane", ""))
        ring = self._rings.get(lane)
        if ring is None:
            ring = self._rings[lane] = collections.deque(
                maxlen=self.capacity
            )
        ring.append(ev)

    def events(self, lane: str) -> List[Dict[str, Any]]:
        return list(self._rings.get(lane, ()))

    # ------------------------------------------------------------------

    def dump(self, lane: str, reason: str, *, step: int = 0,
             extra: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
        """Snapshot ``lane``'s ring as a redacted post-mortem document
        (written to ``out_dir`` when configured)."""
        doc: Dict[str, Any] = {
            "reason": str(reason),
            "lane": str(lane),
            "step": int(step),
            "events": [redact_event(e) for e in self._rings.get(lane, ())],
        }
        if extra:
            doc.update(extra)
        self.dumps.append(doc)
        if self.out_dir:
            os.makedirs(self.out_dir, exist_ok=True)
            path = os.path.join(
                self.out_dir,
                f"flightrec_{lane or 'untagged'}_{reason}_{int(step)}.json",
            )
            with open(path, "w") as f:
                json.dump(doc, f, indent=1)
            self.paths.append(path)
        return doc

    def dumps_for(self, lane: str) -> List[Dict[str, Any]]:
        return [d for d in self.dumps if d["lane"] == lane]
