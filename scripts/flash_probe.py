#!/usr/bin/env python3
"""Two measurements of the port's flash-attention kernels on one GPU.

    python3 scripts/flash_probe.py            # both
    python3 scripts/flash_probe.py timing     # the forward timed three ways
    python3 scripts/flash_probe.py f32-backward

``timing``: the bf16 forward at the train shape (B 4, S = T = 2048, 32
heads of 128, causal) timed by CUDA events around each call, by the
profiler's kernel sums and by events around 20 launches back to back,
each after a warm-up, after the plain version ran, and again, with the
card's SM clock, power and temperature from ``nvidia-smi`` beside them.

``f32-backward``: the f32 backward kernels (dQ, dK, dV) and their plain
versions, each against an f64 recomputation from the same forward's lse,
causal, at shapes where one key line sums every query row (T = 1).

Imports nothing of JAX; needs a CUDA GPU and fails without one.
"""
from __future__ import annotations

import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from flexflow_tpu_torch.ops import flash_attention as fa  # noqa: E402


def _clocks() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,temperature.gpu",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60).stdout.strip()


def _events_per_call(fn, iters=20):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return sorted(times)[iters // 2]


def _profiler(fn, iters=10):
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    ns = sum(ev.duration_ns() for ev in prof.profiler.kineto_results.events()
             if ev.device_type() == torch.autograd.DeviceType.CUDA)
    return ns / 1e6 / iters


def _back_to_back(fn, iters=20):
    fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / iters


def timing(dev):
    gen = torch.Generator(device=dev).manual_seed(0)
    B, H, S, dk = 4, 32, 2048, 128
    q, k, v = (torch.randn(B, S, H, dk, generator=gen, device=dev).to(torch.bfloat16)
               for _ in range(3))
    scale = dk ** -0.5

    def fwd():
        return fa.flash_fwd(q, k, v, True, scale)

    for ctx in ("warm", "after-plain", "again"):
        if ctx == "after-plain":
            for _ in range(3):
                fa.flash_fwd_ref(q, k, v, True, scale)
        before = _clocks()
        print(f"forward {ctx}: events/call {_events_per_call(fwd):.4f} ms, profiler "
              f"{_profiler(fwd):.4f} ms, back to back {_back_to_back(fwd):.4f} ms; "
              f"clocks before [{before}] after [{_clocks()}]", flush=True)


def _bwd_f64(q, k, v, do, lse, delta, scale):
    q, k, v, do, lse, delta = (t.double() for t in (q, k, v, do, lse, delta))
    s = torch.einsum("bshd,bthd->bhst", q, k) * scale
    S, T = q.shape[1], k.shape[1]
    mask = torch.arange(S, device=q.device)[:, None] >= torch.arange(T, device=q.device)[None, :]
    p = torch.where(mask, torch.exp(s - lse[..., None]), 0.0)
    ds = p * (torch.einsum("bshd,bthd->bhst", do, v) - delta[..., None]) * scale
    return (torch.einsum("bhst,bthd->bshd", ds, k), torch.einsum("bhst,bshd->bthd", ds, q),
            torch.einsum("bhst,bshd->bthd", p, do))


def f32_backward(dev):
    gen = torch.Generator(device=dev).manual_seed(3)
    B, H = 2, 3
    for dk in (64, 128):
        for S, T in ((130, 1), (2048, 1), (2048, 63), (150, 77)):
            q, do = (torch.randn(B, S, H, dk, generator=gen, device=dev) for _ in range(2))
            k, v = (torch.randn(B, T, H, dk, generator=gen, device=dev) for _ in range(2))
            scale = dk ** -0.5
            out, lse = fa.flash_fwd(q, k, v, True, scale)
            delta = fa.delta_rows(out, do).contiguous()
            got = (fa.flash_bwd_q(q, k, v, do, lse, delta, True, scale),
                   *fa.flash_bwd_kv(q, k, v, do, lse, delta, True, scale))
            plain = (fa.flash_bwd_q_ref(q, k, v, do, lse, delta, True, scale),
                     *fa.flash_bwd_kv_ref(q, k, v, do, lse, delta, True, scale))
            exact = _bwd_f64(q, k, v, do, lse, delta, scale)
            for name, a, b, x in zip(("dq", "dk", "dv"), got, plain, exact):
                print(f"f32 backward dk {dk} S {S} T {T} {name}: kernel vs f64 "
                      f"{float((a.double() - x).abs().max()):.2e}, plain vs f64 "
                      f"{float((b.double() - x).abs().max()):.2e}, max |f64| "
                      f"{float(x.abs().max()):.1f}", flush=True)


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA GPU", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    what = argv[1:] or ["timing", "f32-backward"]
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip(), flush=True)
    for w in what:
        {"timing": timing, "f32-backward": f32_backward}[w](dev)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
