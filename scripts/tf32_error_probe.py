#!/usr/bin/env python3
"""The error of the paged kernels' f32 tensor-core tile ("tf32x3") on one
GPU, by walk length and by the part of its arithmetic that sets it.

    python3 scripts/tf32_error_probe.py [--lines 2176,4352,8192] [--seeds 2]

One mixed step of C = 128 query rows a slot (the cache's last 128 lines,
causal: row c attends lines 0 .. S - 128 + c) at LLaMA-7B's head dim 128,
2 slots x 8 heads, f32 pools in shuffled pages of 128. Three f32 results
are held against an f64 recomputation of the same attention: the ragged
kernel (``tf32x3``), its plain version (cuBLAS f32 sums) and the dense
verify kernel's f32 variant on the same lines (CUDA-core f32 FMAs, the
yardstick of an f32 kernel without tensor cores). Each input construction
removes one source of error:

* ``f32``: q, K, V standard normal, as the kernel checks draw them;
* ``qk-tf32``: q and K rounded to TF32: QK^T's lo parts are 0, its
  products exact; what S loses is the tensor cores' sums alone;
* ``v-tf32``: V rounded to TF32: V's lo parts are 0;
* ``tf32``: all three rounded: only P still splits;
* ``q0``: q = 0: every attended line's probability is exp2(0) = 1, so
  no exp2 error enters and the output is V's mean over the row's lines:
  PV's split and sums alone;
* ``q0-v-tf32``: q = 0, V in TF32: PV's tensor-core sums of exact
  products alone;
* ``v1``: V = 1: the output is 1 exactly when PV's sum of P (tensor
  cores) equals the softmax's sum l (f32 on the CUDA cores); the exp2
  error cancels.

Prints one JSON line a construction and walk length (max abs errors over
the seeds, and the largest |f64 output|). Imports nothing of JAX; needs a
CUDA GPU and fails without one.
"""
from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from flexflow_tpu_torch.serve import kernels as K  # noqa: E402

R, C, H, DK, PS = 2, 128, 8, 128, 128
VARIANTS = ("f32", "qk-tf32", "v-tf32", "tf32", "q0", "q0-v-tf32", "v1")


def tf32(x: torch.Tensor) -> torch.Tensor:
    """f32 x rounded to TF32 as cvt.rna.tf32.f32 rounds it (10 mantissa
    bits, ties away from zero)."""
    i = x.contiguous().view(torch.int32)
    return ((i + 0x1000) & ~0x1FFF).view(torch.float32)


def _inputs(gen, dev, lines, variant):
    q = torch.randn(R, C, H, DK, generator=gen, device=dev)
    k = torch.randn(R, lines, H, DK, generator=gen, device=dev)
    v = torch.randn(R, lines, H, DK, generator=gen, device=dev)
    if variant in ("qk-tf32", "tf32"):
        q, k = tf32(q), tf32(k)
    if variant in ("v-tf32", "tf32", "q0-v-tf32"):
        v = tf32(v)
    if variant.startswith("q0"):
        q = torch.zeros_like(q)
    if variant == "v1":
        v = torch.ones_like(v)
    return q, k, v


def _paged(gen, dev, k, v):
    """k, v (R, S, H, dk) on shuffled pages of PS (P + 1 pages, the last
    the unused scratch page) and the slots' page table."""
    NP = k.shape[1] // PS
    P = R * NP
    table = torch.randperm(P, generator=gen, device=dev).reshape(R, NP).to(torch.int32)
    pools = []
    for x in (k, v):
        pool = torch.zeros(P + 1, PS, H, DK, device=dev)
        pool[table.reshape(-1).long()] = x.reshape(P, PS, H, DK)
        pools.append(pool)
    return pools[0], pools[1], table


def _f64(q, k, v, mask, scale):
    s = torch.einsum("rchd,rshd->rhcs", q.double(), k.double()) * scale
    s = s.masked_fill(~mask[:, None], float("-inf"))
    return torch.einsum("rhcs,rshd->rchd", torch.softmax(s, dim=-1), v.double())


def probe(dev, lines_list, seeds):
    scale = 1.0 / math.sqrt(DK)
    for lines in lines_list:
        mask = (torch.arange(lines, device=dev)[None, :]
                <= (lines - C + torch.arange(C, device=dev))[:, None])
        mask = mask[None].expand(R, C, lines).contiguous()
        for variant in VARIANTS:
            err = {"kernel": 0.0, "plain": 0.0, "verify_f32": 0.0, "kernel_vs_plain": 0.0}
            top = 0.0
            for seed in range(seeds):
                gen = torch.Generator(device=dev).manual_seed(seed)
                q, k, v = _inputs(gen, dev, lines, variant)
                kp, vp, table = _paged(gen, dev, k, v)
                before = dict(K.DESIGN_LAUNCHES)
                got = K.ragged_paged_attention(q, kp, vp, table, mask)
                if dev.type == "cuda":
                    took = [n for n, c in K.DESIGN_LAUNCHES.items() if c != before[n]]
                    assert took == ["ragged_paged_attention[tf32x3]"], took
                plain = K.ragged_paged_attention_ref(q, kp, vp, table, mask)
                dense = K.verify_attention(q, k, v, mask)
                exact = _f64(q, k, v, mask, scale)
                for name, x in (("kernel", got), ("plain", plain), ("verify_f32", dense)):
                    err[name] = max(err[name], float((x.double() - exact).abs().max()))
                err["kernel_vs_plain"] = max(err["kernel_vs_plain"],
                                             float((got - plain).abs().max()))
                top = max(top, float(exact.abs().max()))
                del q, k, v, kp, vp, got, plain, dense, exact
            print(json.dumps({"lines": lines, "inputs": variant, "seeds": seeds,
                              "max_abs_err_vs_f64": err, "max_abs_f64": top}), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--lines", default="2176,4352,8192",
                    help="cache lengths, multiples of 128")
    ap.add_argument("--seeds", type=int, default=2)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA GPU", file=sys.stderr)
        return 1
    assert not torch.backends.cuda.matmul.allow_tf32  # the plain version sums in f32
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip(), flush=True)
    probe(torch.device("cuda"), [int(x) for x in args.lines.split(",")], args.seeds)
    return 0


if __name__ == "__main__":
    sys.exit(main())
