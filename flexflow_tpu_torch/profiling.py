"""Profiling — per-step wall timing and a device trace capture
(counterpart of ``flexflow_tpu/profiling.py``).

:class:`StepTimes` is the JAX package's, copied (host code).
:func:`trace` is its ``jax.profiler`` capture as a ``torch.profiler``
capture that writes a Chrome trace (kernels on the card's stream
included) into a directory.

``profile_ops`` (per-op on-device timing of a compiled ``FFModel`` graph
through the Unity simulator's measured mode) waits for the training-API
and search slices that port ``FFModel`` and the simulator (ROADMAP.md
queue 1 items 10-11).
"""
from __future__ import annotations

import contextlib
import dataclasses
import glob
import os
from typing import Dict, List

import numpy as np
import torch


@dataclasses.dataclass
class StepTimes:
    """Per-step wall times of a training/serving loop."""

    times_ms: List[float] = dataclasses.field(default_factory=list)

    def record(self, dt_s: float) -> None:
        self.times_ms.append(dt_s * 1e3)

    def summary(self) -> Dict[str, float]:
        if not self.times_ms:
            return {}
        a = np.asarray(self.times_ms)
        return {
            "steps": len(a),
            "mean_ms": round(float(a.mean()), 3),
            "p50_ms": round(float(np.percentile(a, 50)), 3),
            "p90_ms": round(float(np.percentile(a, 90)), 3),
            # the SLO figure soak/latency work quotes (p90 alone hides
            # the tail a stall or recompile puts there)
            "p99_ms": round(float(np.percentile(a, 99)), 3),
            "max_ms": round(float(a.max()), 3),
            # total recorded wall time: the denominator of
            # throughput-per-step-loop comparisons
            "total_ms": round(float(a.sum()), 3),
        }

    def report(self) -> str:
        s = self.summary()
        if not s:
            return "no steps recorded"
        return (
            f"{s['steps']} steps: mean {s['mean_ms']}ms, "
            f"p50 {s['p50_ms']}ms, p90 {s['p90_ms']}ms, "
            f"p99 {s['p99_ms']}ms, max {s['max_ms']}ms, "
            f"total {s['total_ms']}ms"
        )


@contextlib.contextmanager
def trace(logdir: str):
    """``torch.profiler`` capture of the block (host ops, and the CUDA
    kernels when a GPU is present), written as a Chrome trace
    ``trace_<n>.json`` into ``logdir`` on exit — open it in
    ``ui.perfetto.dev``. Yields the profiler."""
    os.makedirs(logdir, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    n = len(glob.glob(os.path.join(logdir, "trace_*.json")))
    prof.export_chrome_trace(os.path.join(logdir, f"trace_{n}.json"))
