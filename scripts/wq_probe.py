#!/usr/bin/env python3
"""wq_matmul alone on one GPU: build its source, print each compiled
function's registers and spills, hold LLaMA-7B's projection shapes at
decode (M 16) and at a mixed step (M 2048), and the edge widths of the
other families, against the plain version (relative L2 within 2^-8,
bf16 bitwise from run to run), and time each shape warm (a CUDA graph of
20 calls on one weight) and cold (the calls cycle over copies of the
weight until the graph's working set passes 150 MB) beside the bf16
``torch.matmul`` of the dequantized weight.

    python3 scripts/wq_probe.py [--root TREE] [--skip-edges]

``--root`` imports ``flexflow_tpu_torch`` from another tree (a parent's
``git archive`` unpacked into a git-ignored directory), so two trees run
in one call, in turns. It prints the card's name and power limit, then
one JSON line per function of the build and per case. Needs a CUDA GPU.
"""
from __future__ import annotations

import argparse
import json
import math
import re
import statistics
import subprocess
import sys
from pathlib import Path

COLD_BYTES = 150e6
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
#: (M, K, N): LLaMA-7B's q/o, w1/w3 and w2 at decode and at a 16-slot C =
#: 128 mixed step
CASES = tuple((M, K, N) for M in (16, 2048)
              for K, N in ((4096, 4096), (4096, 11008), (11008, 4096)))
#: edge widths at decode: Falcon-7B's K/V (N 64) and D 4544, M 1 and 3
EDGES = ((1, 4544, 64), (3, 4544, 4544), (8, 4544, 18176), (16, 18176, 4544))
#: decode shapes of the plan sweep: LLaMA-7B's q, w1 and w2, Falcon-7B's
#: dense and MLP, Mixtral-8x7B's k (8 KV heads)
SWEEP_SHAPES = ((16, 4096, 4096), (16, 4096, 11008), (16, 11008, 4096), (16, 4544, 4544),
                (16, 4544, 18176), (16, 18176, 4544), (16, 4096, 1024))


def graph_ms(torch, fns, calls=20, replays=5):
    """Median time of one call from a CUDA graph of max(calls, len(fns))
    calls cycling over ``fns``, by CUDA events around each replay."""
    n = max(calls, len(fns))
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        fns[0]()
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        for i in range(n):
            fns[i % len(fns)]()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(replays):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / n)
    return statistics.median(times)


def build_report(text):
    """Registers and spill bytes of each wq function in a ptxas -v report."""
    rows, fn, spill = [], None, 0
    for line in text.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            fn, spill = m.group(1), 0
            continue
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            spill = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and fn and "wq_" in fn:
            name = re.search(r"(wq_\w+?_kernel)", fn)
            rows.append({"function": name.group(1) if name else fn,
                         "template": [int(x) for x in re.findall(r"Li(\d+)E", fn)],
                         "registers": int(m.group(1)), "spill_store_bytes": spill})
            fn = None
    return rows


def host_cost(torch, K, quantize_tensor, dev, gen, calls=2000):
    """Host microseconds a call of the wrapper and of the bf16 product at
    LLaMA-7B's decode w1 (wall clock over back-to-back calls whose device
    work is shorter than their host work, before one synchronize)."""
    import time

    qw = quantize_tensor(torch.randn((4096, 11008), generator=gen, device=dev), 8)
    x = torch.randn((16, 4096), generator=gen, device=dev).to(torch.bfloat16)
    dense = K._wq_dense(qw["q"], qw["scale"], torch.bfloat16)
    small = quantize_tensor(torch.randn((4096, 64), generator=gen, device=dev), 8)
    row = {"host_us": True}
    for name, fn in (("wq_matmul_w1", lambda: K.wq_matmul(x, qw["q"], qw["scale"])),
                     ("wq_matmul_n64", lambda: K.wq_matmul(x, small["q"], small["scale"])),
                     ("bf16_matmul_w1", lambda: torch.matmul(x, dense))):
        for _ in range(50):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        row[name] = (t1 - t0) / calls * 1e6
    print(json.dumps(row), flush=True)


def sweep(torch, K, _cuda, quantize_tensor, dev, gen):
    """The decode design's warm graph time at hand-made plans: K split
    over 1-8 cluster ranks (slices of whole stages), ring depth 2 or 4."""
    for bits in (8, 4):
        for M, Kd, N in SWEEP_SHAPES:
            qw = quantize_tensor(torch.randn((Kd, N), generator=gen, device=dev), bits)
            q, s = qw["q"], qw["scale"]
            x = torch.randn((M, Kd), generator=gen, device=dev).to(torch.bfloat16)
            y = torch.empty((M, N), dtype=torch.bfloat16, device=dev)
            stage_k = K.wq_plan(M, Kd, N, 1, bits, torch.bfloat16, 132).stage_k
            for S in (1, 2, 3, 4, 6, 8):
                k_slice = -(-(-(-Kd // S)) // stage_k) * stage_k
                splits = -(-Kd // k_slice)
                for stages in (2, 4):
                    ints = [1, M, Kd, N, 1, 0, bits, 1, K.WQ_DESIGN_CODES["splitk"], splits,
                            k_slice, stages]
                    ms = graph_ms(torch, [lambda: _cuda.launch(
                        "wq_matmul", [x, q, s, y, None], ints, [])])
                    print(json.dumps({"sweep": True, "bits": bits, "M": M, "K": Kd, "N": N,
                                      "splits": splits, "k_slice": k_slice, "stages": stages,
                                      "ms": ms}), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parent.parent))
    ap.add_argument("--skip-edges", action="store_true")
    ap.add_argument("--sweep", action="store_true",
                    help="also time the decode design at other plans: K splits 1-8 and "
                         "ring depths 2 and 4, at SWEEP_SHAPES")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(args.root).resolve()))
    import torch
    from flexflow_tpu_torch.quantization import quantize_tensor
    from flexflow_tpu_torch.serve import _cuda
    from flexflow_tpu_torch.serve import kernels as K

    if not torch.cuda.is_available():
        print("needs a CUDA GPU", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip(), flush=True)
    reports = _cuda.build(["wq_matmul"])
    for row in build_report(reports.get("wq_matmul", "")):
        print(json.dumps({"root": args.root, "build": row}), flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    cases = [(c, False) for c in CASES] + ([] if args.skip_edges else [(c, True) for c in EDGES])
    ok = True
    for bits in (8, 4):
        for (M, Kd, N), edge in cases:
            qw = quantize_tensor(torch.randn((Kd, N), generator=gen, device=dev), bits)
            q, s = qw["q"], qw["scale"]
            x = torch.randn((M, Kd), generator=gen, device=dev).to(torch.bfloat16)
            before = dict(K.DESIGN_LAUNCHES)
            y = K.wq_matmul(x, q, s)
            again = K.wq_matmul(x, q, s)
            torch.cuda.synchronize()
            design = [k for k, v in K.DESIGN_LAUNCHES.items() if v != before.get(k, 0)]
            ref = K.wq_matmul_ref(x, q, s)
            rel = float((y.double() - ref.double()).norm() / ref.double().norm())
            row = {"root": args.root, "bits": bits, "M": M, "K": Kd, "N": N,
                   "design": design, "rel_l2": rel, "bitwise": bool(torch.equal(y, again))}
            ok &= rel <= 2.0 ** -8 and row["bitwise"] and bool(torch.isfinite(y).all())
            if not edge:
                dense = K._wq_dense(q, s, torch.bfloat16)
                nbytes = q.numel() + s.numel() * 4
                copies = max(1, math.ceil(COLD_BYTES / nbytes))
                qs = [(q, s)] + [(q.clone(), s.clone()) for _ in range(copies - 1)]
                ds = [dense] + [dense.clone() for _ in range(
                    max(1, math.ceil(COLD_BYTES / (dense.numel() * 2))) - 1)]
                row.update(
                    ms=graph_ms(torch, [lambda: K.wq_matmul(x, q, s)]),
                    cold_ms=graph_ms(torch, [lambda a=a, b=b: K.wq_matmul(x, a, b)
                                             for a, b in qs]),
                    bf16_ms=graph_ms(torch, [lambda: torch.matmul(x, dense)]),
                    bf16_cold_ms=graph_ms(torch, [lambda d=d: torch.matmul(x, d) for d in ds]),
                    bound_ms=max((nbytes + M * Kd * 2 + M * N * 2) / HBM_BYTES_PER_S,
                                 2 * M * Kd * N / BF16_FLOPS) * 1e3, copies=copies)
                del qs, ds, dense
                torch.cuda.empty_cache()
            print(json.dumps(row), flush=True)
    host_cost(torch, K, quantize_tensor, dev, gen)
    if args.sweep:
        sweep(torch, K, _cuda, quantize_tensor, dev, gen)
    print(json.dumps({"root": args.root, "ok": ok}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
