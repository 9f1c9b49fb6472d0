#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``flexflow_tpu_torch``) on one GPU.

    python3 chip_smoke.py            # every phase, on cuda:0

Builds the port's CUDA kernels from ``flexflow_tpu_torch/csrc/`` (nvcc,
sm_90a, into ``flexflow_tpu_torch/_build/``, one nvcc per source, all
started together), holds each kernel against its plain PyTorch version
at the shapes the serving paths give it, then drives the two serving
paths of LLaMA-7B (full width, all 32 layers, random bf16 weights from
the seed) through ``LLM.generate``: the dense KV cache, and the paged KV
cache under a 17-page budget that forces preemption, with bf16, int8
and int4 pages, unfused and with ``fused_decode=("rope_kv_write",)``.
Each path's served logits are held against its plain
``kernels="torch"`` twin, and an f32 2-layer case checks tokens for
equality across kernels, pool types, fusion and layouts. Each phase
prints one JSON line; the line before the last lists every kernel (per
pool type for the paged ones) with its launches on the serving paths,
its error against the plain version, its times and its bound; the last
line is ``{"ok": true, "device": {...}}``. Any failure raises: the
script then exits non-zero without that line. It needs a CUDA GPU and
fails without one. It imports nothing of JAX or of the JAX package.

Whole-step serving (slice 4): the whole-step kernel (every layer, the LM
head and the greedy argmax of a serving step in one persistent CUDA
kernel) against its plain version at LLaMA-7B width cut to 2 layers, on
decode and C = 128 mixed steps over bf16, f32, int8 and int4 pools and a
GQA case, bitwise equal at two tile counts; ``whole`` serves the paged
slice's 8 requests at full depth with ``fused_decode=("whole_step",)``
on bf16, int8 and int4 pools (no paged attention kernel may run), holds
the teacher-forced logits of each arm to its plain twin, and the f32
phase checks its greedy tokens against the unfused runs.

Training (slice 3): the flash-attention kernels, forward and backward,
against their plain versions at the training shape (B·H = 128, S = T =
2048, dk = 128, bf16, causal) and at an f32 non-aligned and a dk = 64
shape; ``train_parity`` holds one full-width step with
``attention="flash"`` against ``attention="torch"`` under the bf16 rule,
and an f32 2-layer step and three SGD steps to 1e-5; ``train`` takes ten
Adam steps of LLaMA-7B at full width cut to 8 layers (bf16, remat, flash
attention) on one seeded (4, 2049) batch, whose loss must fall.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from flexflow_tpu_torch import optimizers as O
from flexflow_tpu_torch.metrics import SchedulerStats
from flexflow_tpu_torch.models import llama
from flexflow_tpu_torch.ops import flash_attention as FA
from flexflow_tpu_torch.serve import kernels as K
from flexflow_tpu_torch.serve import _cuda
from flexflow_tpu_torch.serve.batch_config import BatchConfig
from flexflow_tpu_torch.serve import kv_quant as KQ
from flexflow_tpu_torch.serve.engine import InferenceEngine, ServingConfig
from flexflow_tpu_torch.serve.llm import LLM

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
# Kernel vs plain version. bf16: both compute in f32 and round the
# output once to bf16, so they may differ by one bf16 ulp (<= 2^-7 |x|);
# f32: summation order only.
TOL = {torch.bfloat16: dict(atol=1e-2, rtol=1e-2),
       torch.float32: dict(atol=1e-5, rtol=0.0)}
# Served bf16 logits, teacher-forced over the same tokens. The two bf16
# paths round attention differently (the plain path rounds probabilities
# to bf16 before PV, the kernels keep them f32) and 32 random-weight
# layers amplify any such difference, so the yardstick is bf16's own
# error: the distance of the plain bf16 path from the same computation
# in f32. Two paths each that far from the f32 result can be up to twice
# that far apart (triangle inequality); the kernels path must also be no
# further from the f32 result than the plain path, give or take 25%.
SLICE_PATHS = 2.0
SLICE_VS_EXACT = 1.25

DEV = torch.device("cuda", 0)
DENSE_KERNELS = ("decode_attention", "verify_attention")
# the paged slice: 17 pages of 128 tokens, the least one slot's worst
# case allows (cache_len 2112 + the scratch line), against ~25 that the
# 8 requests hold at their ends
PAGED_BUDGET = 17 * 128
# arms of the paged slice: (label, kv_quant, fused_decode)
PAGED_ARMS = (("bf16", None, ()), ("int8", "int8", ()), ("int4", "int4", ()),
              ("bf16-fused", None, ("rope_kv_write",)),
              ("int8-fused", "int8", ("rope_kv_write",)),
              ("int4-fused", "int4", ("rope_kv_write",)))
# arms of the whole-step slice, under the same budget
WHOLE_ARMS = (("bf16-whole", None, ("whole_step",)), ("int8-whole", "int8", ("whole_step",)),
              ("int4-whole", "int4", ("whole_step",)))


def one_card(visible):
    """The CUDA_VISIBLE_DEVICES value that exposes only the first card of
    ``visible`` (all cards when None): the run drives one card, so
    ``torch.cuda.device_count()`` then counts the devices it used. A
    value that lists no card hides them all and is kept as it is."""
    if visible is None:
        return "0"
    if not visible.strip():
        return visible
    return visible.split(",")[0].strip()


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Median device time of one call of ``fn``, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


# ---------------------------------------------------------------------------
# phases


def phase_device():
    check(torch.cuda.is_available(), "no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    emit({"phase": "device", "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "nvidia_smi": smi})
    print(smi, flush=True)
    return smi


def phase_build():
    t0 = time.perf_counter()
    reports = _cuda.build()
    seconds = time.perf_counter() - t0
    info = {}
    for name, text in reports.items():
        regs = [int(x) for x in re.findall(r"Used (\d+) registers", text)]
        spills = [int(x) for x in re.findall(r"(\d+) bytes spill stores", text)]
        info[name] = {"max_registers": max(regs, default=None),
                      "max_spill_store_bytes": max(spills, default=None)}
    for name in _cuda.SIGNATURES:
        _cuda._lib(name)  # loads, or raises
    sources = dict.fromkeys(_cuda.source(n) for n in _cuda.SIGNATURES)
    emit({"phase": "build", "seconds": round(seconds, 3), "arch": "sm_90a",
          "sources": [f"flexflow_tpu_torch/csrc/{n}.cu" for n in sources],
          "ptxas": info})


def _rand(shape, dtype, gen):
    return torch.randn(shape, generator=gen, device=DEV, dtype=torch.float32).to(dtype)


def _decode_case(gen, dtype, R, S1, H, KV, dk, seq_lens):
    q = _rand((R, H, dk), dtype, gen)
    k = _rand((R, S1, KV, dk), dtype, gen)
    v = _rand((R, S1, KV, dk), dtype, gen)
    sl = torch.tensor(seq_lens, dtype=torch.int32, device=DEV)
    return q, k, v, sl


def _decode_bound(q, k, sl):
    R, H, dk = q.shape
    KV = k.shape[2]
    isz = q.element_size()
    lines = int(sl.sum())
    nbytes = 2 * q.numel() * isz + sl.numel() * 4 + 2 * lines * KV * dk * isz
    flops = 4 * lines * H * dk
    t_b, t_f = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[q.dtype]
    return max(t_b, t_f) * 1e3, ("bytes" if t_b >= t_f else "operations")


def _verify_bound(q, k, mask):
    R, C, H, dk = q.shape
    KV = k.shape[2]
    isz = q.element_size()
    lines = int(mask.any(dim=1).sum())  # lines some row of the slot attends
    nbytes = (2 * q.numel() * isz + mask.numel()
              + 2 * lines * KV * dk * isz)
    flops = 4 * int(mask.sum()) * H * dk
    t_b, t_f = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[q.dtype]
    return max(t_b, t_f) * 1e3, ("bytes" if t_b >= t_f else "operations")


def _sdpa_inputs(q, k, v, mask):
    """q (R, C, H, dk), k/v (R, S1, KV, dk), mask (R, C, S1) → SDPA's
    (R, H, C, dk) / (R, H, S1, dk) layout, KV heads repeated for GQA."""
    G = q.shape[2] // k.shape[2]
    kk = k.repeat_interleave(G, dim=2) if G > 1 else k
    vv = v.repeat_interleave(G, dim=2) if G > 1 else v
    return (q.transpose(1, 2).contiguous(), kk.transpose(1, 2).contiguous(),
            vv.transpose(1, 2).contiguous(), mask[:, None])


def _compare(name, out, ref, dtype, tol=None):
    err = (out.float() - ref.float()).abs()
    tol = tol or TOL[dtype]
    ok = bool((err <= tol["atol"] + tol["rtol"] * ref.float().abs()).all())
    check(bool(torch.isfinite(out.float()).all()), f"{name}: non-finite output")
    check(ok, f"{name}: max abs err {float(err.max())} outside {tol}")
    return float(err.max())


def run_decode_check(label, gen, dtype, R, S1, H, KV, dk, seq_lens, timed):
    q, k, v, sl = _decode_case(gen, dtype, R, S1, H, KV, dk, seq_lens)
    out = K.decode_attention(q, k, v, sl)
    torch.cuda.synchronize()
    ref = K.decode_attention_ref(q, k, v, sl)
    err = _compare(f"decode_attention[{label}]", out, ref, dtype)
    zero_rows = [i for i, n in enumerate(seq_lens) if n == 0]
    if zero_rows:
        check(bool((out[zero_rows] == 0).all()), "decode: zero-length slot not zero")
    row = {"phase": "kernels", "kernel": "decode_attention", "case": label,
           "dtype": str(dtype).replace("torch.", ""),
           "shape": {"R": R, "S1": S1, "H": H, "KV": KV, "dk": dk},
           "max_abs_err": err, "tol": TOL[dtype]}
    if timed:
        bound_ms, bound_by = _decode_bound(q, k, sl)
        valid = (torch.arange(S1, device=DEV)[None, :] < sl[:, None])[:, None, :]
        sq, sk, svv, smask = _sdpa_inputs(q[:, None], k, v, valid)
        row.update(
            ms=cuda_ms(lambda: K.decode_attention(q, k, v, sl)),
            plain_ms=cuda_ms(lambda: K.decode_attention_ref(q, k, v, sl), iters=5),
            library_ms=cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
                sq, sk, svv, attn_mask=smask)),
            bound_ms=bound_ms, bound_by=bound_by,
        )
    emit(row)
    return row


def _mixed_step_mask(rng, R, C, S1):
    """The causal-by-position mask of a mixed continuous-batching step:
    prefill rows carry a chunk at some offset, decode rows one token,
    idle rows none; padding columns sit at the scratch position and
    attend every line below it, as on the serving path."""
    scratch = S1 - 1
    pos = np.full((R, C), scratch, np.int64)
    for r in range(R):
        kind = r % 4
        if kind in (0, 1):   # prefill chunk
            off = int(rng.integers(0, scratch - C))
            pos[r] = np.arange(off, off + C)
        elif kind == 2:      # decode row
            pos[r, 0] = int(rng.integers(0, scratch))
    return K.causal_serve_mask(torch.from_numpy(pos).to(DEV), S1)


def _tree_mask(rng, R, C, S1):
    """A speculation-tree mask: a committed prefix per slot plus random
    tree edges; the last slot's row 0 attends nothing."""
    m = np.zeros((R, C, S1), bool)
    for r in range(R):
        pref = int(rng.integers(1, S1 - C - 1))
        m[r, :, :pref] = True
        for c in range(C):
            m[r, c, pref + rng.integers(0, C, size=2)] = True
    m[R - 1, 0] = False
    return torch.from_numpy(m).to(DEV)


def run_verify_check(label, gen, dtype, R, S1, H, KV, dk, mask, timed):
    C = mask.shape[1]
    q = _rand((R, C, H, dk), dtype, gen)
    k = _rand((R, S1, KV, dk), dtype, gen)
    v = _rand((R, S1, KV, dk), dtype, gen)
    out = K.verify_attention(q, k, v, mask)
    torch.cuda.synchronize()
    ref = K.verify_attention_ref(q, k, v, mask)
    err = _compare(f"verify_attention[{label}]", out, ref, dtype)
    empty = ~mask.any(dim=-1)  # (R, C) fully masked rows
    if bool(empty.any()):
        check(bool((out[empty] == 0).all()), "verify: fully masked row not zero")
    row = {"phase": "kernels", "kernel": "verify_attention", "case": label,
           "dtype": str(dtype).replace("torch.", ""),
           "shape": {"R": R, "C": C, "S1": S1, "H": H, "KV": KV, "dk": dk},
           "attended_pairs": int(mask.sum()), "max_abs_err": err, "tol": TOL[dtype]}
    del ref
    if timed:
        bound_ms, bound_by = _verify_bound(q, k, mask)
        sq, sk, svv, smask = _sdpa_inputs(q, k, v, mask)
        row.update(
            ms=cuda_ms(lambda: K.verify_attention(q, k, v, mask)),
            plain_ms=cuda_ms(lambda: K.verify_attention_ref(q, k, v, mask), iters=5),
            library_ms=cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
                sq, sk, svv, attn_mask=smask)),
            bound_ms=bound_ms, bound_by=bound_by,
        )
    emit(row)
    return row


def phase_kernels(seed):
    """Each kernel against its plain version; the LLaMA-7B rows (the
    serving path's shapes: 16 slots, S1 = cache_len + 1) are timed."""
    sc = ServingConfig()
    R, S1 = sc.max_requests_per_batch, sc.cache_len + 1
    gen = torch.Generator(device=DEV)
    gen.manual_seed(seed)
    rng = np.random.default_rng(seed)
    lens = [0, 1, 2048, 3, 17, 129, 255, 511, 777, 1023, 1025, 1501, 1999, 2047, 2048, 5]
    bf16, f32 = torch.bfloat16, torch.float32
    main = {}
    main["decode_attention"] = run_decode_check(
        "llama7b", gen, bf16, R, S1, 32, 32, 128, lens, timed=True)
    run_decode_check("llama7b-gqa", gen, bf16, R, S1, 32, 8, 128, lens, timed=True)
    run_decode_check("llama7b-f32", gen, f32, R, S1, 32, 32, 128, lens, timed=False)
    run_decode_check("llama160m", gen, bf16, R, S1, 12, 12, 64, lens, timed=False)
    mixed = _mixed_step_mask(rng, R, sc.prefill_chunk, S1)
    main["verify_attention"] = run_verify_check(
        "llama7b-mixed-c128", gen, bf16, R, S1, 32, 32, 128, mixed, timed=True)
    # the same step with its padding columns attending nothing: what the
    # causal-by-position mask's padding costs the kernel
    pad = torch.zeros_like(mixed)
    pad[0::4], pad[1::4] = mixed[0::4], mixed[1::4]  # prefill rows
    pad[2::4, 0] = mixed[2::4, 0]                     # decode rows' token
    run_verify_check("llama7b-mixed-c128-padding-off", gen, bf16, R, S1, 32, 32,
                     128, pad, timed=True)
    run_verify_check("llama7b-tree-c8", gen, bf16, R, S1, 32, 32, 128,
                     _tree_mask(rng, R, 8, S1), timed=True)
    run_verify_check("llama7b-gqa-mixed-c128", gen, bf16, R, S1, 32, 8, 128,
                     mixed, timed=True)
    run_verify_check("llama7b-f32-mixed-c128", gen, f32, R, S1, 32, 32, 128,
                     mixed, timed=False)
    run_verify_check("llama160m-tree-c16", gen, bf16, R, S1, 12, 12, 64,
                     _tree_mask(rng, R, 16, S1), timed=False)
    torch.cuda.empty_cache()
    return main


# paged kernels at the shapes of the paged slice: 16 slots, 17 logical
# pages of 128 lines (S_virt = 2176 > cache_len 2112), a pool of 272 pages
# plus the scratch page, shuffled into the slots' tables

DECODE_LENS = [0, 1, 2048, 3, 17, 129, 255, 511, 777, 1023, 1025, 1501, 1999, 2047, 2048, 5]


def _paged_positions(rng, kind, R, C, cache_len, ps):
    """Positions (R, C) of a decode step (C == 1: slot r holds
    DECODE_LENS[r] lines, the last one new; empty slots are padding) or
    of a mixed step (prefill chunks, decode rows, idle slots): padding
    columns sit at cache_len, as on the serving path. Every position
    stays below the page of the scratch line (2048 at the default
    configuration), so that page is never allocated and padding lines
    land on the scratch page."""
    top = (cache_len // ps) * ps
    pos = np.full((R, C), cache_len, np.int64)
    for r in range(R):
        if kind == "decode":
            n = min(DECODE_LENS[r % len(DECODE_LENS)], top)
            if n > 0:
                pos[r, 0] = n - 1
        elif r % 4 in (0, 1):   # prefill chunk
            off = int(rng.integers(0, top - C))
            pos[r] = np.arange(off, off + C)
        elif r % 4 == 2:        # decode row
            pos[r, 0] = int(rng.integers(0, top))
    return pos


def _paged_case(gen, rng, dtype, quant, KV, kind):
    """Inputs of one paged attention call at LLaMA-7B widths: q, pools
    (q's dtype, or int8/int4 codes quantized from random lines at
    per-page amax scales), the shuffled page table (slots' unused
    logical pages on the scratch page P) and the causal paged mask."""
    sc = ServingConfig()
    cfg = llama.LLaMAConfig.llama_7b()
    R, H, dk = sc.max_requests_per_batch, cfg.num_attention_heads, cfg.head_dim
    ps, NP = sc.page_size, sc.pages_per_slot
    C = 1 if kind == "decode" else sc.prefill_chunk
    P = R * NP
    pos = _paged_positions(rng, kind, R, C, sc.cache_len, ps)
    held = np.where(pos < sc.cache_len, pos + 1, 0).max(axis=1)
    perm = rng.permutation(P).reshape(R, NP)
    table = np.where(np.arange(NP)[None, :] < -(-held[:, None] // ps), perm, P)
    lines = torch.randn((2, P + 1, ps, KV, dk), generator=gen, device=DEV)
    if quant is None:
        kp, vp, ks, vs = lines[0].to(dtype), lines[1].to(dtype), None, None
    else:
        spec = KQ.SPECS[quant]
        s = lines.abs().amax(dim=(2, 4)) / spec.qmax + 1e-3     # (2, P+1, KV)
        codes = torch.round(lines / s[:, :, None, :, None]).clamp(-spec.qmax, spec.qmax)
        pools = KQ.pack_codes(codes, spec.dtype, spec.pack)
        kp, vp, ks, vs = pools[0].contiguous(), pools[1].contiguous(), s[0].contiguous(), \
            s[1].contiguous()
        del codes, pools
    del lines
    post = torch.from_numpy(pos).to(DEV)
    return dict(q=_rand((R, C, H, dk), dtype, gen), kp=kp, vp=vp, ks=ks, vs=vs,
                table=torch.from_numpy(table.astype(np.int32)).to(DEV), pos=post,
                mask=K.paged_serve_mask(None, post, NP, ps, sc.cache_len),
                R=R, C=C, H=H, KV=KV, dk=dk, ps=ps, NP=NP, P=P,
                cache_len=sc.cache_len)


def _paged_bound(case, q_dtype, extra_bytes=0):
    """Least time for the paged attention call: the distinct physical
    pages the mask opens (K and V, plus their scales; the scratch page
    that many slots open through their unallocated entries counts once),
    table, mask and q/out bytes over the HBM rate, or 4 * pairs * H * dk
    FLOP over the q dtype's peak."""
    kp, mask, table, ps = case["kp"], case["mask"], case["table"], case["ps"]
    R, C, NP = case["R"], case["C"], case["NP"]
    opened = mask.reshape(R, C, NP, ps).any(dim=3).any(dim=1)  # (R, NP)
    pages = int(table[opened].unique().numel())
    row_bytes = ps * kp.shape[2] * kp.shape[3] * kp.element_size()
    nbytes = 2 * pages * row_bytes + table.numel() * 4 + mask.numel()
    nbytes += 2 * case["q"].numel() * case["q"].element_size() + extra_bytes
    if case["ks"] is not None:
        nbytes += 2 * pages * kp.shape[2] * 4
    flops = 4 * int(mask.sum()) * case["H"] * case["dk"]
    t_b, t_f = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[q_dtype]
    return max(t_b, t_f) * 1e3, ("bytes" if t_b >= t_f else "operations")


def _paged_library_ms(case, q, quant):
    """SDPA over the virtual cache gathered beforehand (the gather is not
    timed); None for quantized pools, which no single PyTorch call
    attends."""
    if quant is not None:
        return None
    kv = K.gather_pages(case["kp"], case["table"])
    vv = K.gather_pages(case["vp"], case["table"])
    sq, sk, svv, smask = _sdpa_inputs(q, kv, vv, case["mask"])
    ms = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        sq, sk, svv, attn_mask=smask))
    del kv, vv, sq, sk, svv, smask
    return ms


def _paged_row(kernel, label, case, dtype, quant, err):
    return {"phase": "kernels", "kernel": kernel, "case": label,
            "dtype": str(dtype).replace("torch.", ""), "pool": quant or str(dtype).replace("torch.", ""),
            "shape": {k: case[k] for k in ("R", "C", "H", "KV", "dk", "ps", "NP", "P")},
            "attended_pairs": int(case["mask"].sum()), "max_abs_err": err,
            "tol": TOL[dtype]}


def run_ragged_check(label, case, dtype, quant):
    q, kp, vp, ks, vs, table = (case[k] for k in ("q", "kp", "vp", "ks", "vs", "table"))
    mask = case["mask"].clone()
    mask[case["R"] - 1, 0] = False  # a row with nothing to attend
    out = K.ragged_paged_attention(q, kp, vp, table, mask, k_scale=ks, v_scale=vs)
    torch.cuda.synchronize()
    ref = K.ragged_paged_attention_ref(q, kp, vp, table, mask, k_scale=ks, v_scale=vs)
    err = _compare(f"ragged_paged_attention[{label}]", out, ref, dtype)
    check(bool((out[case["R"] - 1, 0] == 0).all()), "ragged: empty row not zero")
    del ref
    row = _paged_row("ragged_paged_attention", label, case, dtype, quant, err)
    mask = case["mask"]
    row["bound_ms"], row["bound_by"] = _paged_bound(case, dtype)
    row.update(
        ms=cuda_ms(lambda: K.ragged_paged_attention(q, kp, vp, table, mask,
                                                    k_scale=ks, v_scale=vs)),
        plain_ms=cuda_ms(lambda: K.ragged_paged_attention_ref(
            q, kp, vp, table, mask, k_scale=ks, v_scale=vs), iters=5),
        library_ms=_paged_library_ms(case, q, quant))
    emit(row)
    return row


def run_fused_check(label, case, dtype, quant):
    """The fused kernel against the port's unfused composition on the card
    (RoPE, then the scatter or quant_line_write, then the ragged kernel):
    non-scratch pool bytes and scales bit for bit, and the outputs of rows
    that never read the scratch page compared bit for bit (reported) and
    within the kernel tolerance of the plain version (required)."""
    R, C, KV, dk, ps, P = (case[k] for k in ("R", "C", "KV", "dk", "ps", "P"))
    q, table, mask, pos = case["q"], case["table"], case["mask"], case["pos"]
    gen = torch.Generator(device=DEV)
    gen.manual_seed(R * C + KV)
    k_new = _rand((R, C, KV, dk), dtype, gen)
    v_new = _rand((R, C, KV, dk), dtype, gen)
    cos, sin = llama.rope_freqs(llama.LLaMAConfig.llama_7b(), pos)  # (R, C, dk) f32
    logical = (pos // ps).to(torch.int32)
    off = (pos % ps).to(torch.int32)
    qmax = None if quant is None else KQ.SPECS[quant].qmax

    def pools():
        return [None if case[k] is None else case[k].clone() for k in ("kp", "vp", "ks", "vs")]

    a, b = pools(), pools()
    out = K.fused_rope_paged_attention(q, k_new, v_new, cos, sin, a[0], a[1], table,
                                       logical, off, mask, k_scale=a[2], v_scale=a[3],
                                       qmax=qmax)
    qr, kr = llama.apply_rope(q, cos, sin), llama.apply_rope(k_new, cos, sin)
    phys = table.long().gather(1, logical.long())
    K.commit_paged(b[0], b[1], kr, v_new, phys, off.long(), b[2], b[3], qmax)
    unfused = K.ragged_paged_attention(qr, b[0], b[1], table, mask, k_scale=b[2],
                                       v_scale=b[3])
    torch.cuda.synchronize()
    for name, x, y in zip(("k_pool", "v_pool", "k_scale", "v_scale"), a, b):
        if x is not None:
            check(torch.equal(x[:P], y[:P]),
                  f"fused[{label}]: non-scratch {name} differs from the unfused path")
    live = ~(mask & (table == P).repeat_interleave(ps, dim=1)[:, None]).any(dim=-1)
    c = pools()
    ref = K.fused_rope_paged_attention_ref(q, k_new, v_new, cos, sin, c[0], c[1], table,
                                           logical, off, mask, k_scale=c[2],
                                           v_scale=c[3], qmax=qmax)
    err = _compare(f"fused_rope_paged_attention[{label}]", out[live], ref[live], dtype)
    row = _paged_row("fused_rope_paged_attention", label, case, dtype, quant, err)
    row.update(pools_bitwise_vs_unfused=True, live_rows=int(live.sum()),
               out_bitwise_vs_unfused=bool(torch.equal(out[live], unfused[live])))
    del ref, c, unfused
    isz = q.element_size()
    dkp, pisz = case["kp"].shape[3], case["kp"].element_size()
    # inputs read once; the distinct lines written (every padding line
    # lands on the one scratch line)
    written = int((phys * ps + off.long()).unique().numel())
    extra = (2 * k_new.numel() * isz + 2 * cos.numel() * 4 + 2 * R * C * 4
             + 2 * written * KV * dkp * pisz)
    if quant is not None:
        # scale rows of the touched pages, and the pages whose scale moved
        moved = sum(int((x[:P] != case[k][:P]).sum()) for x, k in zip(a[2:], ("ks", "vs")))
        touched = int(phys.unique().numel())
        extra += 2 * touched * KV * 4 + moved * ps * dkp * pisz
    row["bound_ms"], row["bound_by"] = _paged_bound(case, dtype, extra)
    row.update(
        ms=cuda_ms(lambda: K.fused_rope_paged_attention(
            q, k_new, v_new, cos, sin, a[0], a[1], table, logical, off, mask,
            k_scale=a[2], v_scale=a[3], qmax=qmax)),
        plain_ms=cuda_ms(lambda: K.fused_rope_paged_attention_ref(
            q, k_new, v_new, cos, sin, b[0], b[1], table, logical, off, mask,
            k_scale=b[2], v_scale=b[3], qmax=qmax), iters=5),
        library_ms=_paged_library_ms(case, qr, quant))
    emit(row)
    return row


# (label, q dtype, pool quantization, KV heads, step kind); every case is timed
PAGED_CASES = (
    ("bf16-decode", torch.bfloat16, None, 32, "decode"),
    ("bf16-mixed-c128", torch.bfloat16, None, 32, "mixed"),
    ("int8-decode", torch.bfloat16, "int8", 32, "decode"),
    ("int8-mixed-c128", torch.bfloat16, "int8", 32, "mixed"),
    ("int4-decode", torch.bfloat16, "int4", 32, "decode"),
    ("int4-mixed-c128", torch.bfloat16, "int4", 32, "mixed"),
    ("f32-decode", torch.float32, None, 32, "decode"),
    ("f32-mixed-c128", torch.float32, None, 32, "mixed"),
    ("bf16-gqa-decode", torch.bfloat16, None, 8, "decode"),
    ("bf16-gqa-mixed-c128", torch.bfloat16, None, 8, "mixed"),
)


def phase_paged_kernels(seed):
    """Both paged kernels against their plain versions in every pool
    type; the rows of the kernels line are the mixed C = 128 cases."""
    gen = torch.Generator(device=DEV)
    gen.manual_seed(seed + 2)
    rng = np.random.default_rng(seed + 2)
    main = {}
    for label, dtype, quant, KV, kind in PAGED_CASES:
        case = _paged_case(gen, rng, dtype, quant, KV, kind)
        ragged = run_ragged_check(label, case, dtype, quant)
        fused = run_fused_check(label, case, dtype, quant)
        if kind == "mixed" and "gqa" not in label:
            pool = quant or ("bf16" if dtype == torch.bfloat16 else "f32")
            main[f"ragged_paged_attention[{pool}]"] = ragged
            main[f"fused_rope_paged_attention[{pool}]"] = fused
        del case
        gc.collect()
        torch.cuda.empty_cache()
    return main


# the whole-step kernel at LLaMA-7B width cut to 2 layers, 16 slots, on
# the paged slice's table and page shapes: (label, model dtype, pool
# quantization, KV heads, step kind)
WHOLE_CHECK_LAYERS = 2
WHOLE_CASES = (
    ("bf16-decode", torch.bfloat16, None, 32, "decode"),
    ("bf16-mixed-c128", torch.bfloat16, None, 32, "mixed"),
    ("f32-decode", torch.float32, None, 32, "decode"),
    ("f32-mixed-c128", torch.float32, None, 32, "mixed"),
    ("int8-decode", torch.bfloat16, "int8", 32, "decode"),
    ("int8-mixed-c128", torch.bfloat16, "int8", 32, "mixed"),
    ("int4-decode", torch.bfloat16, "int4", 32, "decode"),
    ("int4-mixed-c128", torch.bfloat16, "int4", 32, "mixed"),
    ("f32-int4-mixed-c128", torch.float32, "int4", 32, "mixed"),
    ("bf16-gqa-decode", torch.bfloat16, None, 8, "decode"),
    ("bf16-gqa-mixed-c128", torch.bfloat16, None, 8, "mixed"),
)
# f32 kernel vs plain version: summation order only
WHOLE_F32_RTOL = 1e-4
# f32 logits of the kernel against a plain or unfused path on an int4
# pool: the kernel projects in its own summation order, so a K/V value at a
# rounding tie may take the other code (~560 of 143M code bytes in one
# mixed step on LLaMA-7B widths, measured on an H100), which moves the
# logits by 1.2e-3 to 2.1e-3 in that step and by 4.4e-3 to 4.8e-3 over 16
# served tokens (relative L2); the limit is 1.5 times the largest, two
# thirds of bf16's own distance from f32 (1.07e-2 to 1.25e-2)
F32_TIE_REL_L2 = 7e-3


def _whole_case(gen, rng, dtype, quant, KV, kind):
    """Inputs of one whole-step call: random weights, a paged cache whose
    every page holds random lines (int8/int4 codes at per-page amax
    scales), the paged slice's shuffled table and the step's tokens,
    positions and logits_idx (decode: DECODE_LENS; mixed: prefill chunks,
    decode rows and idle slots)."""
    sc = ServingConfig()
    cfg = llama.LLaMAConfig.llama_7b(num_hidden_layers=WHOLE_CHECK_LAYERS,
                                     num_key_value_heads=KV, dtype=dtype)
    R, ps, NP = sc.max_requests_per_batch, sc.page_size, sc.pages_per_slot
    L, dk = cfg.num_hidden_layers, cfg.head_dim
    C = 1 if kind == "decode" else sc.prefill_chunk
    P = R * NP
    params = llama.init_params(gen, cfg, device=DEV)
    pos = _paged_positions(rng, kind, R, C, sc.cache_len, ps)
    held = np.where(pos < sc.cache_len, pos + 1, 0).max(axis=1)
    perm = rng.permutation(P).reshape(R, NP)
    table = np.where(np.arange(NP)[None, :] < -(-held[:, None] // ps), perm, P)
    cache = {}
    for name in ("k", "v"):
        lines = torch.randn((L, P + 1, ps, KV, dk), generator=gen, device=DEV)
        if quant is None:
            cache[name] = lines.to(dtype)
            continue
        spec = KQ.SPECS[quant]
        s = lines.abs().amax(dim=(2, 4)) / spec.qmax + 1e-3          # (L, P+1, KV)
        codes = torch.round(lines / s[:, :, None, :, None]).clamp(-spec.qmax, spec.qmax)
        cache[name] = KQ.pack_codes(codes, spec.dtype, spec.pack).contiguous()
        cache[f"{name}_scale"] = s.contiguous()
        del codes
    del lines
    li = np.zeros((R,), np.int64)
    if kind == "mixed":
        li[[r for r in range(R) if r % 4 in (0, 1)]] = C - 1
    toks = torch.from_numpy(rng.integers(1, cfg.vocab_size, size=(R, C))).to(DEV)
    return dict(cfg=cfg, params=params, cache=cache, tokens=toks,
                pos=torch.from_numpy(pos).to(DEV), li=torch.from_numpy(li).to(DEV),
                table=torch.from_numpy(table.astype(np.int32)).to(DEV), quant=quant,
                R=R, C=C, ps=ps, NP=NP, P=P, cache_len=sc.cache_len)


def _whole_bound(case):
    """Least time of one step on these inputs: the larger of its bytes
    (every weight, the LM head included, read once; the distinct K/V pages
    the mask opens in every layer, with their scales; the live rows' new
    lines written) over the HBM rate, and its operations (2 * live rows *
    the layer projections' weights, 2 * live slots * D * V for the head,
    4 * attended pairs * H * dk per layer for attention) over the model
    dtype's peak. A live row is one whose position is in the cache (the
    rest are padding the step need not compute), a live slot one whose
    logits_idx row is live: counted as the attention term counts the
    mask's pairs."""
    cfg, p, cache = case["cfg"], case["params"], case["cache"]
    L, D, V = cfg.num_hidden_layers, cfg.hidden_size, cfg.vocab_size
    H, dk = cfg.num_attention_heads, cfg.head_dim
    R, ps, NP = case["R"], case["ps"], case["NP"]
    isz = p["embed"].element_size()
    layer_params = sum(w[0].numel() for w in p["layers"].values())
    proj_params = sum(p["layers"][n][0].numel() for n in ("wq", "wk", "wv", "wo", "w1", "w2", "w3"))
    mask = K.paged_serve_mask(None, case["pos"], NP, ps, case["cache_len"])
    opened = mask.reshape(R, -1, NP, ps).any(dim=3).any(dim=1)
    pages = int(case["table"][opened].unique().numel())
    rows = int((case["pos"] < case["cache_len"]).sum())
    slots = int((case["pos"].gather(1, case["li"][:, None]) < case["cache_len"]).sum())
    kp = cache["k"]
    page_bytes = ps * kp.shape[3] * kp.shape[4] * kp.element_size()
    nbytes = isz * (L * layer_params + D * V + D) + 2 * L * pages * page_bytes
    nbytes += 2 * L * rows * kp.shape[3] * kp.shape[4] * kp.element_size()
    if "k_scale" in cache:
        nbytes += 2 * L * pages * kp.shape[3] * 4
    flops = (2 * rows * L * proj_params + 2 * slots * D * V
             + 4 * L * int(mask.sum()) * H * dk)
    t_b, t_f = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[p["embed"].dtype]
    return max(t_b, t_f) * 1e3, ("bytes" if t_b >= t_f else "operations"), nbytes, flops


def cuda_ms_restored(fn, restore, iters: int = 20, warmup: int = 2) -> float:
    """Median device time of ``fn`` by CUDA events, ``restore()`` (not
    timed) before each call: the step writes the pools it reads."""
    for _ in range(warmup):
        restore()
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        restore()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def _rel(a, b) -> float:
    return float((a.double() - b.double()).norm() / b.double().norm())


def run_whole_check(label, case):
    """The kernel against its plain version (kernels="torch") on one case:
    at the gate's tile count and at another count the kernel takes, which
    must agree bit for bit (the live rows' logits and tokens, non-scratch
    pools and scales).
    f32: logits within WHOLE_F32_RTOL (relative L2; F32_TIE_REL_L2 on
    quantized pools, where a value at a rounding tie may take the other
    code), tokens equal (on int4 pools, or differing at a tie), pools to
    1e-4 / one code, scales within F32_TIE_REL_L2. bf16: logits, pool values (codes
    times scales) and scales no further from the plain version than
    SLICE_PATHS times the plain bf16 path's distance from the same step in
    f32. Times: the kernel, its plain
    version and the unfused kernels="cuda" step (cuBLAS + the ragged
    kernel) on the same inputs, pools restored before each run."""
    cfg, params, cache = case["cfg"], case["params"], case["cache"]
    quant, P, dtype = case["quant"], case["P"], cfg.dtype
    step = (case["tokens"], case["pos"], case["li"], case["table"])
    kw = dict(cfg=cfg, cache_len=case["cache_len"], kv_quant=quant)
    la, _ = llama.whole_step_weight_layout(params, cfg)
    roles = llama.whole_step_tile_roles(cfg)
    x0 = torch.empty((case["R"], case["C"], cfg.hidden_size), dtype=dtype, device="meta")
    gate, est = K.whole_step_pick_tiles(la, cache, x0, cfg.num_attention_heads,
                                        tile_roles=roles, budget=K.WHOLE_STEP_SMEM_BUDGET)
    check(gate is not None, f"whole[{label}]: no tile count fits the budget")
    takes = [t for t in K.whole_step_tile_candidates(la, roles)
             if K.whole_step_kernel_takes(la, tiles=t, tile_roles=roles)]
    other = max(t for t in takes if t != gate)
    work = {k: v.clone() for k, v in cache.items()}

    def restore():
        for k, v in cache.items():
            work[k].copy_(v)

    def run(kernels, tiles, prm=params, c=None, cf=cfg):
        c = c if c is not None else work
        return llama.serve_step_whole(prm, c, *step, cfg=cf, cache_len=case["cache_len"],
                                      kv_quant=quant, tiles=tiles, kernels=kernels)

    outs = {}
    for name, kernels, tiles in (("gate", "cuda", gate), ("other", "cuda", other),
                                 ("plain", "torch", gate)):
        restore()
        logits, toks, _ = run(kernels, tiles)
        torch.cuda.synchronize()
        outs[name] = (logits.clone(), toks.clone(), {k: v[:, :P].clone() for k, v in work.items()})
    # slots whose logits_idx column is padding read the scratch page, which
    # every padding line writes in no fixed order: only live rows count
    live = case["pos"].gather(1, case["li"][:, None])[:, 0] < case["cache_len"]
    (lg, tg, cg), (lo, to_, co), (lp, tp, cp) = (
        (lgt[live], tk[live], c) for lgt, tk, c in (outs["gate"], outs["other"], outs["plain"]))
    bitwise = (torch.equal(lg, lo) and torch.equal(tg, to_)
               and all(torch.equal(cg[k], co[k]) for k in cg))
    check(bitwise, f"whole[{label}]: tiles {gate} and {other} differ")
    check(bool(torch.isfinite(lg).all()), f"whole[{label}]: non-finite logits")
    check(torch.equal(tg, torch.argmax(lg, dim=-1)), f"whole[{label}]: tokens are not the argmax")
    pack = 1 if quant is None else KQ.SPECS[quant].pack

    def values(c, k):
        """A pool's values: codes times their page scale when quantized."""
        v = KQ.unpack_codes(c[k], pack)
        return v * c[f"{k}_scale"][:, :, None, :, None] if quant else v

    row = {"phase": "kernels", "kernel": "whole_step_decode", "case": label,
           "dtype": str(dtype).replace("torch.", ""), "pool": quant or str(dtype).replace("torch.", ""),
           "shape": {"L": cfg.num_hidden_layers, "R": case["R"], "C": case["C"],
                     "D": cfg.hidden_size, "H": cfg.num_attention_heads,
                     "KV": cfg.num_key_value_heads, "F": cfg.intermediate_size,
                     "V": cfg.vocab_size, "ps": case["ps"], "NP": case["NP"], "P": P},
           "live_slots": int(live.sum()),
           "live_rows": int((case["pos"] < case["cache_len"]).sum()), "tiles": gate, "tiles_other": other,
           "smem_est": est, "bitwise_across_tiles": bitwise,
           "max_abs_err": float((lg - lp).abs().max()),
           "logits_rel_l2_vs_plain": _rel(lg, lp),
           "tokens_equal_plain": f"{int((tg == tp).sum())}/{tg.numel()}"}
    if dtype == torch.float32:
        # summation order only: codes one step apart at a rounding tie. A
        # code that took the other side of a tie moves the logits by far
        # more than f32 rounding (F32_TIE_REL_L2), and a token may then
        # differ only where the plain version's top two logits are closer
        # than that move
        pool_err = {k: (float((KQ.unpack_codes(cg[k], pack) - KQ.unpack_codes(cp[k], pack))
                              .abs().max()) if quant else _rel(cg[k], cp[k]))
                    for k in ("k", "v")}
        row["pool_err_vs_plain"] = pool_err
        if quant:  # how many codes took the other side of a tie
            row["codes_differ"] = {k: f"{int((cg[k] != cp[k]).sum())}/{cg[k].numel()} bytes"
                                   for k in ("k", "v")}
        rtol = F32_TIE_REL_L2 if quant else WHOLE_F32_RTOL
        check(row["logits_rel_l2_vs_plain"] <= rtol,
              f"whole[{label}]: f32 logits {row['logits_rel_l2_vs_plain']} from the plain version")
        flips = tg != tp
        top2 = lp.topk(2, dim=-1).values
        margin, diff = top2[:, 0] - top2[:, 1], (lg - lp).abs().amax(dim=-1)
        check(bool((margin[flips] <= 2 * diff[flips]).all()) if quant == "int4"
              else not bool(flips.any()),
              f"whole[{label}]: f32 tokens differ from the plain version")
        for k, e in pool_err.items():
            check(e <= (1.0 if quant else 1e-4), f"whole[{label}]: {k} pool error {e}")
        if quant:  # a second layer's scales follow the first layer's ties
            row["scale_rel_l2_vs_plain"] = max(_rel(cg[k], cp[k]) for k in ("k_scale", "v_scale"))
            check(row["scale_rel_l2_vs_plain"] <= rtol, f"whole[{label}]: scales differ")
    else:
        # the same step in f32: weights and pools upcast, the plain version
        p32 = _to_f32(params)
        c32 = {k: (v.to(torch.float32) if quant is None or "scale" in k else v.clone())
               for k, v in cache.items()}
        exact = run("torch", gate, p32, c32, dataclasses.replace(cfg, dtype=torch.float32))[0]
        exact = exact[live]
        c32 = {k: v[:, :P] for k, v in c32.items()}
        del p32
        d_kernel, d_plain = _rel(lg, exact), _rel(lp, exact)
        row.update(logits_rel_l2_vs_f32=d_kernel, plain_rel_l2_vs_f32=d_plain)
        check(d_kernel <= SLICE_PATHS * d_plain,
              f"whole[{label}]: kernel logits {d_kernel} from f32, plain {d_plain}")
        # pools by the same rule: kernel vs plain within twice the plain
        # bf16 pool's distance from the f32 one (a second layer's K/V carry
        # the first layer's rounding, so codes move by more than one step)
        row["pool_rel_l2_vs_plain"], row["plain_pool_rel_l2_vs_f32"] = {}, {}
        for k in ("k", "v") + (("k_scale", "v_scale") if quant else ()):
            if "scale" in k:
                e, e_plain = _rel(cg[k], cp[k]), _rel(cp[k], c32[k])
            else:
                e, e_plain = _rel(values(cg, k), values(cp, k)), _rel(values(cp, k), values(c32, k))
            row["pool_rel_l2_vs_plain"][k], row["plain_pool_rel_l2_vs_f32"][k] = e, e_plain
            check(e <= SLICE_PATHS * e_plain,
                  f"whole[{label}]: {k} pool {e} from the plain one, plain {e_plain} from f32")
        del c32
    del outs
    row["bound_ms"], row["bound_by"], row["bytes"], row["flop"] = _whole_bound(case)
    unfused_kw = dict(kw, kernels="cuda")
    mask_args = (None, None, case["table"])
    row.update(
        ms=cuda_ms_restored(lambda: run("cuda", gate), restore),
        ms_tiles_other=cuda_ms_restored(lambda: run("cuda", other), restore),
        plain_ms=cuda_ms_restored(lambda: run("torch", gate), restore, iters=5),
        unfused_ms=cuda_ms_restored(lambda: llama.serve_step_paged(
            params, work, case["tokens"], case["pos"], case["li"], *mask_args,
            **unfused_kw), restore),
        library_ms=None)
    emit(row)
    del work
    return row


def phase_whole_kernels(seed):
    """The whole-step kernel against its plain version in every
    WHOLE_CASES case; the rows of the kernels line are the decode cases
    (MHA) of each pool type."""
    gen = torch.Generator(device=DEV)
    gen.manual_seed(seed + 4)
    rng = np.random.default_rng(seed + 4)
    main = {}
    for label, dtype, quant, KV, kind in WHOLE_CASES:
        case = _whole_case(gen, rng, dtype, quant, KV, kind)
        row = run_whole_check(label, case)
        if kind == "decode" and KV == 32:
            pool = quant or ("bf16" if dtype == torch.bfloat16 else "f32")
            main[f"whole_step_decode[{pool}]"] = row
        del case
        gc.collect()
        torch.cuda.empty_cache()
    return main


def _teacher_forced_logits(cfg, params, sc, seqs, prompt_lens):
    """Replay ``seqs`` (prompt + fed output tokens) through a fresh engine:
    lockstep chunked prefill, then one decode step per fed token, each
    through ``run_mixed(..., with_logits=True)`` — the serving step itself
    (the whole-step kernel where the engine runs it; ``engine.run`` is
    always the per-layer step). Returns each step's logits of the rows
    active in it, on the host. A paged engine gets each slot's pages as
    its lines arrive (its pool is the default worst case: nothing is
    preempted)."""
    eng = InferenceEngine(llama, cfg, params, sc, device=DEV)
    R, C, S = eng.num_slots, sc.prefill_chunk, eng.scratch_pos
    n = len(seqs)
    head = (np.ones((R,), bool), np.ones((R,), np.float32), np.full((R,), 2.0, np.float32),
            np.zeros((R,), np.int32))
    last = torch.zeros((R,), dtype=torch.int64, device=DEV)

    def step(bc):
        return eng.run_mixed(last, bc.tokens, np.zeros((R,), bool), bc.positions,
                             bc.logits_idx, None, *head, with_logits=True)[1]

    out = []
    for k in range(math.ceil(max(prompt_lens) / C)):
        bc = BatchConfig.empty(R, C, S)
        rows = []
        for i in range(n):
            off = k * C
            m = min(C, prompt_lens[i] - off)
            if m <= 0:
                continue
            bc.tokens[i, :m] = seqs[i][off:off + m]
            bc.positions[i, :m] = np.arange(off, off + m)
            bc.logits_idx[i] = m - 1
            rows.append(i)
            if eng.paged:
                check(eng.pager.ensure(i, off + m), "teacher-forced run out of pages")
        out.append(step(bc)[rows].cpu())
    for t in range(max(len(s) for s in seqs) - min(prompt_lens)):
        bc = BatchConfig.empty(R, 1, S)
        rows = []
        for i in range(n):
            p = prompt_lens[i] + t
            if p >= len(seqs[i]):
                continue
            bc.tokens[i, 0] = seqs[i][p]
            bc.positions[i, 0] = p
            rows.append(i)
            if eng.paged:
                check(eng.pager.ensure(i, p + 1), "teacher-forced run out of pages")
        if rows:
            out.append(step(bc)[rows].cpu())
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _to_f32(tree):
    if isinstance(tree, dict):
        return {k: _to_f32(v) for k, v in tree.items()}
    return tree.to(torch.float32)


def _logit_diff(a_steps, b_steps):
    """Differences of two runs' per-step logits (lists of (rows, V)):
    relative L2 over all steps, worst step's relative L2, max abs, and
    how often the argmax agrees."""
    a, b = torch.cat(a_steps), torch.cat(b_steps)
    per_row = (a - b).norm(dim=-1) / b.norm(dim=-1)
    return {"rel_l2": float((a - b).norm() / b.norm()),
            "worst_row_rel_l2": float(per_row.max()),
            "max_abs": float((a - b).abs().max()),
            "argmax_agree": f"{int((a.argmax(-1) == b.argmax(-1)).sum())}/{a.shape[0]}"}


def _kernel_class(name: str) -> str:
    n = name.lower()
    for kernel in ("flash_fwd", "flash_bwd_kv", "flash_bwd_q"):  # f32 and mma kernels
        if kernel in n:
            return kernel
    if "ragged_decode_kernel" in n or "ragged_tile_kernel" in n:
        return "ragged_paged_attention"
    if "fused_kernel" in n:
        return "fused_rope_paged_attention"
    if "decode_kernel" in n:
        return "decode_attention"
    if "verify_kernel" in n:
        return "verify_attention"
    if "memcpy" in n or "memset" in n:
        return "copy"
    if any(w in n for w in ("gemm", "gemv", "xmma", "cutlass", "nvjet")):  # cuBLAS
        return "matmul"
    return "other"


def _profile(run, path):
    """``run()`` under torch.profiler: device time by kernel class and the
    device's idle share of the wall time. The profiler slows the host, so
    the idle share is an upper bound."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_class, kernels = {}, []
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        ms = ev.self_device_time_total / 1e3
        c = _kernel_class(ev.key)
        by_class[c] = by_class.get(c, 0.0) + ms
        kernels.append((ms, ev.key[:100], ev.count))
    busy_s = sum(by_class.values()) / 1e3
    kernels.sort(reverse=True)
    return {"phase": "profile", "path": path, "wall_s": wall, "device_busy_s": busy_s,
            "device_idle_share": 1.0 - busy_s / wall,
            "device_ms_by_class": by_class,
            "top_kernels": [{"name": n, "ms": ms, "count": k} for ms, n, k in kernels[:10]]}


def profile_slice(llm, prompts, new, path):
    """The slice workload once more under the profiler."""
    return _profile(lambda: llm.generate(prompts, max_new_tokens=new), path)


def _slice_prompts(seed, cfg):
    """The 8 seeded requests of the serving slices (prompt lengths 16 to
    1000) and their new-token count."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(16, 1001, size=8)
    lens[0], lens[1] = 1000, 16
    return [rng.integers(1, cfg.vocab_size, size=int(n)).tolist() for n in lens], 64


# device-memory peaks of the script before each reset of the peak mark
_PEAKS = []


def _serve(llm, prompts, new):
    """One measured LLM.generate: warm-up first, then the counts, the
    stats and the peak-memory mark set to 0 just before the run and read
    just after."""
    llm.generate([[1, 2, 3]], max_new_tokens=2)  # warm-up (allocator, libraries)
    torch.cuda.synchronize()
    _PEAKS.append(torch.cuda.max_memory_allocated())
    llm.rm.stats = SchedulerStats()
    K.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    results = llm.generate(prompts, max_new_tokens=new)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: v for k, v in K.LAUNCHES.items() if v}
    for r in results:
        check(r.error is None, f"request {r.request_id} failed: {r.error}")
        check(len(r.output_tokens) == new, f"request {r.request_id}: "
              f"{len(r.output_tokens)} tokens, want {new}")
        check(all(0 <= t < llm.cfg.vocab_size for t in r.output_tokens), "token out of range")
    ttft = [r.profile.ttft_s for r in results]
    stats = llm.rm.stats.snapshot()
    line = {"requests": len(prompts), "prompt_lens": [len(p) for p in prompts],
            "new_tokens": new, "wall_s": wall,
            "tokens_per_s": len(prompts) * new / wall,
            "ttft_s_mean": statistics.mean(ttft), "ttft_s_max": max(ttft),
            "peak_memory_bytes": torch.cuda.max_memory_allocated(),
            "kv_cache_bytes": llm.engine.kv_cache_bytes(),
            "preemptions": stats["preemptions"], "launches": launches,
            "steps": {k: stats[k] for k in ("mixed_steps", "decode_steps", "sync_steps")},
            # host wall ms of each pipelined decode dispatch (the device runs ahead)
            "decode_dispatch_ms": {"p50": stats["decode_step_ms_p50"],
                                   "p99": stats["decode_step_ms_p99"]}}
    return results, line


def _free(llm):
    llm.engine = llm.rm = None
    gc.collect()
    torch.cuda.empty_cache()


def _hold_to_plain(label, got, want, exact):
    """Slice 1's rule for served bf16 logits, teacher-forced over the same
    tokens: the kernels path within SLICE_PATHS times the plain path's
    distance from the f32 computation of the plain path, and within
    SLICE_VS_EXACT times that distance of the f32 computation itself."""
    for a in got:
        check(bool(torch.isfinite(a).all()), f"{label}: non-finite served logits")
    d_paths, d_cuda, d_plain = (_logit_diff(got, want), _logit_diff(got, exact),
                                _logit_diff(want, exact))
    emit({"phase": "slice_vs_plain", "path": label, "steps": len(got),
          "cuda_vs_torch": d_paths, "cuda_vs_f32": d_cuda, "torch_vs_f32": d_plain,
          "tol": {"cuda_vs_torch_rel_l2": f"<= {SLICE_PATHS} * torch_vs_f32",
                  "cuda_vs_f32_rel_l2": f"<= {SLICE_VS_EXACT} * torch_vs_f32"}})
    check(d_paths["rel_l2"] <= SLICE_PATHS * d_plain["rel_l2"],
          f"{label}: kernels path further from the plain path than bf16 allows")
    check(d_cuda["rel_l2"] <= SLICE_VS_EXACT * d_plain["rel_l2"],
          f"{label}: kernels path further from the f32 computation than the plain "
          "bf16 path")


def phase_slice(seed):
    """The dense slice: LLaMA-7B served through LLM.generate on the dense
    KV cache. Returns the launches of its run and the bf16 params, which
    the paged slice reuses."""
    cfg = llama.LLaMAConfig.llama_7b()
    t0 = time.perf_counter()
    llm = LLM(llama, cfg, device=DEV, seed=seed)
    llm.compile(ServingConfig())
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    prompts, new = _slice_prompts(seed, cfg)
    results, line = _serve(llm, prompts, new)
    emit({"phase": "slice", "path": "dense", "model": "llama_7b",
          "layers": cfg.num_hidden_layers, "dtype": "bfloat16",
          "init_s": round(init_s, 3), **line})
    launches = line["launches"]
    for name in DENSE_KERNELS:
        check(launches.get(name, 0) > 0, f"{name} was never launched on the serving path")
    emit(profile_slice(llm, prompts, new, "dense"))

    # hold the served path against the plain one, teacher-forced, and
    # both against the same computation in f32 (the bf16 weights upcast)
    seqs = [r.input_tokens + r.output_tokens[:-1] for r in results]
    plens = [len(r.input_tokens) for r in results]
    params = llm.params
    _free(llm)
    sc = dict(max_requests_per_batch=len(seqs))
    got = _teacher_forced_logits(cfg, params, ServingConfig(kernels="cuda", **sc),
                                 seqs, plens)
    want = _teacher_forced_logits(cfg, params, ServingConfig(kernels="torch", **sc),
                                  seqs, plens)
    params32 = _to_f32(params)
    exact = _teacher_forced_logits(
        dataclasses.replace(cfg, dtype=torch.float32), params32,
        ServingConfig(kernels="torch", cache_dtype=torch.float32, **sc), seqs, plens)
    del params32
    _hold_to_plain("dense", got, want, exact)
    del got, want, exact
    gc.collect()
    torch.cuda.empty_cache()
    return params, {k: launches.get(k, 0) for k in DENSE_KERNELS}


def phase_paged(seed, holder, arms):
    """The paged slices: the same 8 requests through LLM.generate on the
    paged KV cache under a 17-page budget, in every arm of ``arms``
    (PAGED_ARMS and/or WHOLE_ARMS; one params object, each engine freed
    before the next). Each arm's kernel must launch (a whole-step arm's
    and no paged attention kernel, with no gate fallback and the mixed
    step on the walk), the bf16 arms must preempt, and each arm's
    teacher-forced logits are held to its kernels="torch" twin under
    slice 1's rule. Returns the launches of the arms' runs. ``holder`` is
    a list holding the bf16 params, emptied here so that they are freed
    before the f32 runs."""
    params = holder.pop()
    cfg = llama.LLaMAConfig.llama_7b()
    prompts, new = _slice_prompts(seed, cfg)
    launches, seqs = {}, None
    tf = {}
    for label, quant, fused in arms:
        llm = LLM(llama, cfg, params, device=DEV)
        llm.compile(ServingConfig(kv_layout="paged", max_cached_tokens=PAGED_BUDGET,
                                  kv_quant=quant, fused_decode=fused))
        eng = llm.engine
        whole = "whole_step" in fused
        results, line = _serve(llm, prompts, new)
        kind = ("whole_step_decode" if whole else "fused_rope_paged_attention" if fused
                else "ragged_paged_attention")
        variant = f"{kind}[{quant or 'bf16'}]"
        path = f"whole-{label[:-6]}" if whole else f"paged-{label}"
        extra = {}
        if whole:
            extra = {"tiles": eng.whole_step_tiles, "mixed_tiles": eng.whole_step_mixed_tiles,
                     "smem_est": eng.whole_step_smem_est,
                     "fallbacks": llm.rm.stats.whole_step_fallbacks}
        emit({"phase": "slice", "path": path, "model": "llama_7b",
              "layers": cfg.num_hidden_layers, "dtype": "bfloat16",
              "kv_quant": quant, "fused_decode": list(fused),
              "max_cached_tokens": PAGED_BUDGET, "num_pages": eng.pager.num_pages,
              **extra, **line})
        check(line["launches"].get(variant, 0) > 0,
              f"{variant} was never launched on the {path} arm")
        if whole:
            check(extra["fallbacks"] == 0 and eng.whole_step_mixed_on,
                  f"{path}: the whole-step gate fell back ({extra})")
            paged = [k for k in line["launches"] if k.split("[")[0] in K.PAGED_KERNELS]
            check(not paged, f"{path}: paged attention kernels ran: {paged}")
        if quant is None:
            check(line["preemptions"] > 0, f"{path}: the 17-page budget caused no preemption")
        if label in ("bf16", "bf16-whole"):
            emit(profile_slice(llm, prompts, new, path))
        if seqs is None:
            # every arm is teacher-forced over the first bf16 arm's tokens
            seqs = [r.input_tokens + r.output_tokens[:-1] for r in results]
        for k, v in line["launches"].items():
            launches[k] = launches.get(k, 0) + v
        _free(llm)
        sc = dict(max_requests_per_batch=len(seqs), kv_layout="paged", kv_quant=quant,
                  fused_decode=fused)
        plens = [len(p) for p in prompts]
        tf[label] = [_teacher_forced_logits(cfg, params, ServingConfig(kernels=k, **sc),
                                            seqs, plens) for k in ("cuda", "torch")]
    # the f32 computation of each pool type, its weights upcast
    params32 = _to_f32(params)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    plens = [len(p) for p in prompts]
    for quant in (None, "int8", "int4"):
        exact = _teacher_forced_logits(
            cfg32, params32,
            ServingConfig(kernels="torch", cache_dtype=torch.float32, kv_layout="paged",
                          kv_quant=quant, max_requests_per_batch=len(seqs)), seqs, plens)
        for label, q, fused in arms:
            if q == quant:
                got, want = tf.pop(label)
                whole = "whole_step" in fused
                _hold_to_plain(f"whole-{label[:-6]}" if whole else f"paged-{label}", got,
                               want, exact)
        del exact
    del params32
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def _record_steps(eng):
    """Keep the logits of every step the engine serves, by (slot, sampled
    position), on the host: wraps ``eng.run_mixed``, which the pipelined
    decode and mixed steps both go through."""
    rec, run, scratch = {}, eng.run_mixed, eng.scratch_pos

    def run_mixed(last, host, use_last, positions, logits_idx, *head, with_logits=False):
        toks, logits = run(last, host, use_last, positions, logits_idx, *head, with_logits=True)
        at = np.asarray(positions)[np.arange(len(logits_idx)), np.asarray(logits_idx)]
        live = np.flatnonzero(at < scratch)
        for s, lg in zip(live, logits[torch.from_numpy(live).to(logits.device)].cpu()):
            rec[(int(s), int(at[s]))] = lg
        return (toks, logits) if with_logits else toks

    eng.run_mixed = run_mixed
    return rec


def _divergence(plens, got, want, rec_got, rec_want):
    """Where two greedy runs part, read from the logits they served
    (request i sits in slot i of a fresh engine): for each request whose
    tokens differ, its first differing step t, the reference's top-two
    margin and the largest logit difference there, and the relative L2 of
    the two runs' logits over the request's steps 0..t (the same inputs
    up to there). A token may part only at a tie: the margin within twice
    the difference, and the logits within F32_TIE_REL_L2."""
    out = []
    for i, (a_toks, b_toks) in enumerate(zip(got, want)):
        if a_toks == b_toks:
            continue
        t = next(k for k, (x, y) in enumerate(zip(a_toks, b_toks)) if x != y)
        keys = [(i, plens[i] - 1 + k) for k in range(t + 1)]
        a = torch.stack([rec_got[k] for k in keys])
        b = torch.stack([rec_want[k] for k in keys])
        check(a.argmax(-1).tolist() == a_toks[:t + 1] and b.argmax(-1).tolist() == b_toks[:t + 1],
              f"request {i}: the recorded logits are not the ones its tokens came from")
        top2 = b[-1].topk(2).values
        d = {"request": i, "step": t, "margin": float(top2[0] - top2[1]),
             "max_abs_diff": float((a[-1] - b[-1]).abs().max()), "rel_l2": _rel(a, b)}
        check(d["margin"] <= 2 * d["max_abs_diff"], f"f32 token parts at no tie: {d}")
        check(d["rel_l2"] <= F32_TIE_REL_L2, f"f32 whole-step logits off: {d}")
        out.append(d)
    return out


def phase_f32(seed):
    """Full width, 2 layers, f32: greedy tokens equal across kernels
    ("cuda" and "torch") on the dense layout and on f32, int8 and int4
    pools; fused, whole-step and unfused (f32, int8 and int4 pools); paged
    and dense. The int4 whole-step run alone may part from the unfused
    runs, and only at a rounding tie (:func:`_divergence`). Returns the
    launches of its paged runs."""
    cfg = llama.LLaMAConfig.llama_7b(num_hidden_layers=2, dtype=torch.float32)
    rng = np.random.default_rng(seed + 1)
    prompts = [rng.integers(1, cfg.vocab_size, size=int(n)).tolist()
               for n in (300, 16, 129, 77)]
    llm = LLM(llama, cfg, device=DEV, seed=seed)
    paged = dict(kv_layout="paged")
    fused = dict(fused_decode=("rope_kv_write",))
    whole = dict(fused_decode=("whole_step",))
    runs = {
        "dense-cuda": {}, "dense-torch": dict(kernels="torch"),
        "paged-cuda": paged, "paged-torch": dict(paged, kernels="torch"),
        "paged-fused": dict(paged, **fused),
        "int8-cuda": dict(paged, kv_quant="int8"),
        "int8-torch": dict(paged, kv_quant="int8", kernels="torch"),
        "int8-fused": dict(paged, kv_quant="int8", **fused),
        "int4-cuda": dict(paged, kv_quant="int4"),
        "int4-torch": dict(paged, kv_quant="int4", kernels="torch"),
        "int4-fused": dict(paged, kv_quant="int4", **fused),
        "paged-whole": dict(paged, **whole),
        "int8-whole": dict(paged, kv_quant="int8", **whole),
        "int4-whole": dict(paged, kv_quant="int4", **whole),
    }
    outs, launches, recs = {}, {}, {}
    for name, kw in runs.items():
        llm.compile(ServingConfig(cache_dtype=torch.float32, **kw))
        recs[name] = _record_steps(llm.engine)
        K.reset_launch_counts()
        outs[name] = [r.output_tokens for r in llm.generate(prompts, max_new_tokens=16)]
        for k, v in K.LAUNCHES.items():
            if v and "[f32]" in k:
                launches[k] = launches.get(k, 0) + v
        _free(llm)
    pairs = [("dense-cuda", "dense-torch"), ("paged-cuda", "paged-torch"),
             ("int8-cuda", "int8-torch"), ("int4-cuda", "int4-torch"),
             ("paged-fused", "paged-cuda"),
             ("int8-fused", "int8-cuda"), ("int4-fused", "int4-cuda"),
             ("paged-cuda", "dense-cuda"),
             ("paged-whole", "paged-cuda"), ("paged-whole", "paged-torch"),
             ("int8-whole", "int8-cuda"), ("int8-whole", "int8-torch"),
             ("int4-whole", "int4-cuda"), ("int4-whole", "int4-torch")]
    ties = {}
    for a, b in pairs:
        if outs[a] == outs[b]:
            continue
        # the whole-step kernel projects in its own summation order: on an
        # int4 pool a K/V value at a rounding tie may take the other code
        # (one code step is 1/7 of the page's amax). A greedy token may
        # then part only where the reference's top two logits are closer
        # than the logits moved; every other pair is equal token for token
        check(a == "int4-whole", f"f32 greedy tokens differ: {a} {outs[a]} vs {b} {outs[b]}")
        ties[f"{a} vs {b}"] = _divergence([len(p) for p in prompts], outs[a], outs[b],
                                          recs[a], recs[b])
    emit({"phase": "f32_tokens", "layers": 2, "requests": len(prompts),
          "new_tokens": 16, "equal": [f"{a} == {b}" for a, b in pairs
                                      if f"{a} vs {b}" not in ties],
          "parted_at_ties": ties, "launches": launches})
    for k in ("ragged_paged_attention[f32]", "fused_rope_paged_attention[f32]",
              "whole_step_decode[f32]"):
        check(launches.get(k, 0) > 0, f"{k} was never launched on the f32 paged runs")
    return launches


# ---------------------------------------------------------------------------
# training: flash-attention kernels, train-step parity, the train slice

FLASH_KERNELS = ("flash_attention_fwd", "flash_attention_bwd_kv", "flash_attention_bwd_q")
# the train slice: LLaMA-7B at full width, depth cut to 8 layers (32 with
# bf16 params and grads and f32 Adam moments is 80.9 GB, over the card's
# 80), one seeded batch of 4 sequences of max_position_embeddings tokens
TRAIN_LAYERS = 8
TRAIN_BATCH = (4, 2049)
TRAIN_STEPS = 10
TRAIN_LR = 1e-4
# the f32 parity case: flash = torch to this relative error (summation
# order of f32 math in the kernels and in cuBLAS)
F32_TRAIN_RTOL = 1e-5
# Flash kernels vs plain versions. The bf16 kernels split p and ds into
# bf16 hi + lo halves for the mma, so they keep f32 precision to ~2^-16
# and differ from the plain version by the last rounding to bf16 only;
# atol 1e-3 (not TOL's 1e-2) catches an error of a few thousandths that
# TOL would pass. Each output's relative L2 distance must also stay
# within FLASH_REL_L2.
FLASH_TOL = {torch.bfloat16: dict(atol=1e-3, rtol=1e-2), torch.float32: TOL[torch.float32]}
FLASH_REL_L2 = {torch.bfloat16: 2.0 ** -8, torch.float32: 1e-5}
# (label, dtype, B, H, S, T, dk, causal); the first is the train slice's
FLASH_CASES = (
    ("llama7b-train", torch.bfloat16, 4, 32, 2048, 2048, 128, True),
    ("f32-full-s1000", torch.float32, 2, 32, 1000, 1000, 128, False),
    ("llama160m-dk64", torch.bfloat16, 4, 12, 2048, 2048, 64, True),
)


def _flash_pairs(S, T, causal):
    """(row, line) pairs attended per head: the causal top-left rule
    stops row r at line r."""
    if not causal:
        return S * T
    full = max(0, S - T)  # rows that see every line
    part = S - full
    return part * (part + 1) // 2 + full * T


def _flash_bounds(dtype, B, H, S, T, dk, causal):
    """Least time of each kernel on these inputs: its operations (fwd: QK^T
    and PV; bwd_kv: s, dp, dV, dK; bwd_q: s, dp, dQ, each 2 * pairs * dk
    FLOP a head) over the dtype's peak, or its bytes (inputs read once,
    outputs written once; lse/delta f32) over the HBM rate."""
    isz = torch.tensor([], dtype=dtype).element_size()
    pairs = B * H * _flash_pairs(S, T, causal)
    qb, kb, st = B * S * H * dk * isz, B * T * H * dk * isz, B * H * S * 4
    work = {"flash_attention_fwd": (4, 2 * qb + 2 * kb + st),
            "flash_attention_bwd_kv": (8, 2 * qb + 4 * kb + 2 * st),
            "flash_attention_bwd_q": (6, 3 * qb + 2 * kb + 2 * st)}
    out = {}
    for name, (per_pair, nbytes) in work.items():
        flops = per_pair * pairs * dk
        t_b, t_f = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype]
        out[name] = (max(t_b, t_f) * 1e3, "bytes" if t_b >= t_f else "operations", flops)
    return out


def _flash_library_ms(q, k, v, do, causal):
    """SDPA forward and its autograd backward on the same inputs, in its
    (B, H, S, dk) layout made beforehand (not timed)."""
    F = torch.nn.functional
    sq, sk, sv = (t.transpose(1, 2).contiguous().requires_grad_(True) for t in (q, k, v))
    sdo = do.transpose(1, 2).contiguous()
    fwd = cuda_ms(lambda: F.scaled_dot_product_attention(sq, sk, sv, is_causal=causal))
    out = F.scaled_dot_product_attention(sq, sk, sv, is_causal=causal)
    bwd = cuda_ms(lambda: torch.autograd.grad(out, (sq, sk, sv), sdo, retain_graph=True))
    del out, sq, sk, sv, sdo
    return fwd, bwd


def run_flash_check(label, gen, dtype, B, H, S, T, dk, causal):
    """The three flash kernels against their plain versions on one case;
    returns a row per kernel with its error, times and bound."""
    q, k, v = _rand((B, S, H, dk), dtype, gen), _rand((B, T, H, dk), dtype, gen), \
        _rand((B, T, H, dk), dtype, gen)
    do = _rand((B, S, H, dk), dtype, gen)
    scale = 1.0 / math.sqrt(dk)
    out, lse = FA.flash_fwd(q, k, v, causal, scale)
    delta = FA.delta_rows(out, do).contiguous()
    dk_, dv = FA.flash_bwd_kv(q, k, v, do, lse, delta, causal, scale)
    dq = FA.flash_bwd_q(q, k, v, do, lse, delta, causal, scale)
    torch.cuda.synchronize()
    name = f"[{label}]"
    err, rel = {}, {}

    def compare(kname, what, got, want):
        """FLASH_TOL pointwise and FLASH_REL_L2 on the whole output."""
        e = _compare(f"{kname}[{what}]{name}", got, want, dtype, FLASH_TOL[dtype])
        r = _rel_l2([got], [want])
        check(r <= FLASH_REL_L2[dtype],
              f"{kname}[{what}]{name}: relative L2 error {r} over {FLASH_REL_L2[dtype]}")
        err[kname] = max(err.get(kname, 0.0), e)
        rel[kname] = max(rel.get(kname, 0.0), r)

    out_ref, lse_ref = FA.flash_fwd_ref(q, k, v, causal, scale)
    compare("flash_attention_fwd", "out", out, out_ref)
    # lse is f32 in both: summation order only
    lse_err = float((lse - lse_ref).abs().max())
    check(bool(torch.allclose(lse, lse_ref, atol=1e-5, rtol=1e-5)),
          f"flash_attention_fwd{name}: lse max abs err {lse_err}")
    del out_ref, lse_ref
    dk_ref, dv_ref = FA.flash_bwd_kv_ref(q, k, v, do, lse, delta, causal, scale)
    compare("flash_attention_bwd_kv", "dk", dk_, dk_ref)
    compare("flash_attention_bwd_kv", "dv", dv, dv_ref)
    del dk_ref, dv_ref
    compare("flash_attention_bwd_q", "dq", dq,
            FA.flash_bwd_q_ref(q, k, v, do, lse, delta, causal, scale))
    gc.collect()
    torch.cuda.empty_cache()
    lib_fwd, lib_bwd = _flash_library_ms(q, k, v, do, causal)
    calls = {
        "flash_attention_fwd": (lambda: FA.flash_fwd(q, k, v, causal, scale),
                                lambda: FA.flash_fwd_ref(q, k, v, causal, scale), lib_fwd),
        "flash_attention_bwd_kv": (
            lambda: FA.flash_bwd_kv(q, k, v, do, lse, delta, causal, scale),
            lambda: FA.flash_bwd_kv_ref(q, k, v, do, lse, delta, causal, scale), lib_bwd),
        "flash_attention_bwd_q": (
            lambda: FA.flash_bwd_q(q, k, v, do, lse, delta, causal, scale),
            lambda: FA.flash_bwd_q_ref(q, k, v, do, lse, delta, causal, scale), lib_bwd),
    }
    bounds = _flash_bounds(dtype, B, H, S, T, dk, causal)
    rows = {}
    for kname, (kernel, plain, lib) in calls.items():
        bound_ms, bound_by, flops = bounds[kname]
        row = {"phase": "kernels", "kernel": kname, "case": label,
               "dtype": str(dtype).replace("torch.", ""),
               "shape": {"B": B, "H": H, "S": S, "T": T, "dk": dk, "causal": causal},
               "max_abs_err": err[kname], "tol": FLASH_TOL[dtype],
               "rel_l2": rel[kname], "rel_l2_tol": FLASH_REL_L2[dtype], "flop": flops,
               "ms": cuda_ms(kernel), "plain_ms": cuda_ms(plain, iters=5),
               "library_ms": lib, "bound_ms": bound_ms, "bound_by": bound_by}
        if kname == "flash_attention_fwd":
            row["lse_max_abs_err"] = lse_err
        gc.collect()
        torch.cuda.empty_cache()
        emit(row)
        rows[kname] = row
    return rows


def phase_flash_kernels(seed):
    """The flash kernels against their plain versions in every FLASH_CASES
    case; the rows of the kernels line are the train slice's shape. SDPA's
    backward computes dq, dk and dv in one call: both backward rows carry
    its time."""
    gen = torch.Generator(device=DEV)
    gen.manual_seed(seed + 3)
    main = {}
    for i, case in enumerate(FLASH_CASES):
        rows = run_flash_check(*case[:1], gen, *case[1:])
        if i == 0:
            main.update(rows)
    return main


def _rel_l2(a, b) -> float:
    """||a - b|| / ||b|| over lists of tensors, in f64."""
    num = sum(float((x.double() - y.double()).pow(2).sum()) for x, y in zip(a, b))
    den = sum(float(y.double().pow(2).sum()) for y in b)
    return math.sqrt(num / den)


def _loss_and_grads(cfg, params, toks, attention):
    """The next-token loss of ``toks`` under full remat, its per-token
    values and the gradients of the mean, as the train step takes them."""
    attn_fn = llama.make_flash_attention() if attention == "flash" else None
    leaves = O.tree_leaves(params)
    logits = llama.forward(params, toks[:, :-1], cfg, remat=True, attn_fn=attn_fn)
    logp = torch.log_softmax(logits, dim=-1)
    del logits
    nll = -torch.gather(logp, -1, toks[:, 1:].long()[..., None])[..., 0]
    del logp
    loss = nll.mean()
    grads = torch.autograd.grad(loss, leaves)
    return float(loss.detach()), nll.detach(), grads


def _train_params(cfg, seed):
    gen = torch.Generator(device=DEV)
    gen.manual_seed(seed)
    params = llama.init_params(gen, cfg, device=DEV)
    for p in O.tree_leaves(params):
        p.requires_grad_(True)
    return params


def _train_tokens(seed, cfg, shape):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, cfg.vocab_size, size=shape)).to(DEV)


def phase_train_parity(seed):
    """One full-width step (the train slice's model and batch) with
    attention="flash" against attention="torch", both bf16, each held to
    bf16's own error — the distance of the plain bf16 step from the same
    step in f32 — on the per-token losses and the gradients (slice 1's
    rule, SLICE_PATHS and SLICE_VS_EXACT). Then an f32 2-layer case at
    batch (2, 513): loss and gradients flash = torch to F32_TRAIN_RTOL, and
    equal loss trajectories over three SGD steps through make_train_step."""
    cfg = llama.LLaMAConfig.llama_7b(num_hidden_layers=TRAIN_LAYERS)
    toks = _train_tokens(seed + 7, cfg, TRAIN_BATCH)
    params = _train_params(cfg, seed)
    FA.reset_launch_counts()
    res = {"flash": _loss_and_grads(cfg, params, toks, "flash")}
    flash_launches = dict(FA.LAUNCHES)
    res["torch"] = _loss_and_grads(cfg, params, toks, "torch")
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    with torch.no_grad():
        params32 = _to_f32(params)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    for p in O.tree_leaves(params32):
        p.requires_grad_(True)
    res["f32"] = _loss_and_grads(cfg32, params32, toks, "torch")
    del params32
    d = {}
    for what, vals in (("nll", {k: [r[1]] for k, r in res.items()}),
                       ("grads", {k: list(r[2]) for k, r in res.items()})):
        d[what] = {f"{a}_vs_{b}": _rel_l2(vals[a], vals[b])
                   for a, b in (("flash", "torch"), ("flash", "f32"), ("torch", "f32"))}
    losses = {k: r[0] for k, r in res.items()}
    del res
    gc.collect()
    torch.cuda.empty_cache()
    emit({"phase": "train_parity", "case": "bf16-full-width", "layers": TRAIN_LAYERS,
          "batch": list(TRAIN_BATCH), "loss": losses, "rel_l2": d,
          "flash_launches": flash_launches,
          "tol": {"flash_vs_torch": f"<= {SLICE_PATHS} * torch_vs_f32",
                  "flash_vs_f32": f"<= {SLICE_VS_EXACT} * torch_vs_f32"}})
    for what, x in d.items():
        check(x["flash_vs_torch"] <= SLICE_PATHS * x["torch_vs_f32"],
              f"train parity: flash {what} further from torch than bf16 allows: {x}")
        check(x["flash_vs_f32"] <= SLICE_VS_EXACT * x["torch_vs_f32"],
              f"train parity: flash {what} further from f32 than the plain bf16 step: {x}")
    for name in FLASH_KERNELS:
        check(flash_launches[name] > 0, f"{name} was not launched by the flash step")

    # f32: flash = torch to F32_TRAIN_RTOL
    cfg2 = llama.LLaMAConfig.llama_7b(num_hidden_layers=2, dtype=torch.float32)
    toks2 = _train_tokens(seed + 8, cfg2, (2, 513))
    params2 = _train_params(cfg2, seed + 1)
    FA.reset_launch_counts()
    lf, _, gf = _loss_and_grads(cfg2, params2, toks2, "flash")
    launched = dict(FA.LAUNCHES)
    lt, _, gt = _loss_and_grads(cfg2, params2, toks2, "torch")
    g_rel = _rel_l2(list(gf), list(gt))
    del gf, gt
    traj = {}
    for attention in ("flash", "torch"):
        _, step = llama.make_train_step(cfg2, O.SGDOptimizer(lr=1e-2), device=DEV,
                                        attention=attention)
        p = _train_params(cfg2, seed + 1)
        opt = O.SGDOptimizer(lr=1e-2).init(p)
        traj[attention] = []
        for _ in range(3):
            p, opt, loss = step(p, opt, toks2)
            traj[attention].append(float(loss))
        del p, opt
    del params2
    gc.collect()
    torch.cuda.empty_cache()
    emit({"phase": "train_parity", "case": "f32-2-layers", "batch": [2, 513],
          "loss": {"flash": lf, "torch": lt}, "grads_rel_l2": g_rel,
          "sgd_losses": traj, "flash_launches": launched, "rtol": F32_TRAIN_RTOL})
    check(abs(lf - lt) <= F32_TRAIN_RTOL * abs(lt), f"f32 loss flash {lf} vs torch {lt}")
    check(g_rel <= F32_TRAIN_RTOL, f"f32 grads flash vs torch rel L2 {g_rel}")
    for a, b in zip(traj["flash"], traj["torch"]):
        check(abs(a - b) <= F32_TRAIN_RTOL * abs(b), f"f32 SGD losses differ: {traj}")
    for name in FLASH_KERNELS:
        check(launched[name] > 0, f"{name} was not launched by the f32 flash step")


def phase_train(seed):
    """The train slice through make_train_step: ten Adam steps with
    attention="flash" and full remat on one seeded batch; the loss must be
    finite and fall. Returns the flash launches of the ten steps."""
    cfg = llama.LLaMAConfig.llama_7b(num_hidden_layers=TRAIN_LAYERS)
    toks = _train_tokens(seed + 7, cfg, TRAIN_BATCH)
    init, step = llama.make_train_step(cfg, O.AdamOptimizer(lr=TRAIN_LR), device=DEV,
                                       remat=True, attention="flash")
    gen = torch.Generator(device=DEV)
    gen.manual_seed(seed)
    t0 = time.perf_counter()
    params, opt = init(gen)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    FA.reset_launch_counts()
    losses, step_s, per_step = [], [], []
    for _ in range(TRAIN_STEPS):
        before = dict(FA.LAUNCHES)
        t0 = time.perf_counter()
        params, opt, loss = step(params, opt, toks)
        losses.append(float(loss))
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        per_step.append({k: FA.LAUNCHES[k] - before[k] for k in FA.LAUNCHES})
    launches = dict(FA.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    _PEAKS.append(peak)
    B, S1 = TRAIN_BATCH
    tokens = B * (S1 - 1)
    steady = statistics.median(step_s[1:])
    flops = 3 * llama.flops_per_token(cfg, S1 - 1) * tokens
    emit({"phase": "train", "model": "llama_7b", "layers": TRAIN_LAYERS, "dtype": "bfloat16",
          "num_params": llama.num_params(cfg), "batch": list(TRAIN_BATCH),
          "optimizer": f"adam lr={TRAIN_LR}", "remat": "full", "attention": "flash",
          "init_s": init_s, "losses": losses, "step_s": step_s, "step_ms_median": steady * 1e3,
          "tokens_per_s": tokens / steady, "mfu": flops / steady / PEAK_FLOPS[torch.bfloat16],
          "model_flop_per_step": flops, "peak_memory_bytes": peak,
          "flash_launches_per_step": per_step[-1], "launches": launches})
    check(all(math.isfinite(x) for x in losses), f"non-finite training loss: {losses}")
    check(losses[-1] < losses[0], f"the training loss did not fall: {losses}")
    for name in FLASH_KERNELS:
        check(all(p[name] > 0 for p in per_step), f"{name} missed a train step: {per_step}")
    # one more step under the profiler
    emit(_profile(lambda: float(step(params, opt, toks)[2]), "train"))
    del params, opt
    gc.collect()
    torch.cuda.empty_cache()
    return launches


SOURCES = {
    "decode_attention": ("flexflow_tpu_torch/csrc/decode_attention.cu",
                         "flexflow_tpu/serve/kernels.py:166"),
    "verify_attention": ("flexflow_tpu_torch/csrc/verify_attention.cu",
                         "flexflow_tpu/serve/kernels.py:279"),
    **{f"ragged_paged_attention[{t}]": ("flexflow_tpu_torch/csrc/ragged_paged_attention.cu",
                                        "flexflow_tpu/serve/kernels.py:713")
       for t in K.POOL_TYPES},
    **{f"fused_rope_paged_attention[{t}]": (
        "flexflow_tpu_torch/csrc/fused_rope_paged_attention.cu",
        "flexflow_tpu/serve/kernels.py:1067") for t in K.POOL_TYPES},
    "flash_attention_fwd": ("flexflow_tpu_torch/csrc/flash_attention_fwd.cu",
                            "flexflow_tpu/ops/flash_attention.py:101"),
    "flash_attention_bwd_kv": ("flexflow_tpu_torch/csrc/flash_attention_bwd.cu",
                               "flexflow_tpu/ops/flash_attention.py:142"),
    "flash_attention_bwd_q": ("flexflow_tpu_torch/csrc/flash_attention_bwd.cu",
                              "flexflow_tpu/ops/flash_attention.py:203"),
    # one kernel replaces both TPU kernels of the whole-step walk
    **{f"whole_step_decode[{t}]": (
        "flexflow_tpu_torch/csrc/whole_step_decode.cu",
        "flexflow_tpu/serve/kernels.py:1385 (whole_step_decode) and "
        "flexflow_tpu/serve/kernels.py:1612 (_whole_step_decode_tiled)") for t in K.POOL_TYPES},
}
PHASES = ("kernels", "slice", "paged", "whole", "f32", "train_parity", "train")


def main(argv=None) -> int:
    # the run drives one card: expose only it before CUDA starts
    os.environ["CUDA_VISIBLE_DEVICES"] = one_card(os.environ.get("CUDA_VISIBLE_DEVICES"))
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma list of kernels, slice, paged, whole, f32, train_parity, "
                         "train (device and build always run; paged and whole need slice)")
    args = ap.parse_args(argv)
    phases = set(args.phases.split(","))
    t_start = time.perf_counter()
    marks = []

    def mark(name):
        marks.append((name, time.perf_counter()))
    phase_device()
    phase_build()
    mark("build")
    main_rows, launches = {}, {}
    if "kernels" in phases:
        main_rows = phase_kernels(args.seed)
        main_rows.update(phase_paged_kernels(args.seed))
        main_rows.update(phase_whole_kernels(args.seed))
        main_rows.update(phase_flash_kernels(args.seed))
        mark("kernels")
    if "slice" in phases:
        holder = [None]
        holder[0], dense = phase_slice(args.seed)
        launches.update(dense)
        mark("slice")
        arms = ((PAGED_ARMS if "paged" in phases else ())
                + (WHOLE_ARMS if "whole" in phases else ()))
        if arms:
            launches.update({k: v for k, v in phase_paged(args.seed, holder, arms).items()
                             if "[f32]" not in k})
        del holder
        gc.collect()
        torch.cuda.empty_cache()
        mark("paged+whole")
    if "f32" in phases:
        launches.update(phase_f32(args.seed))
        mark("f32")
    if "train_parity" in phases:
        phase_train_parity(args.seed)
        mark("train_parity")
    if "train" in phases:
        launches.update(phase_train(args.seed))
        mark("train")
    rows = []
    for name, (src, replaces) in SOURCES.items():
        m = main_rows.get(name, {})
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": replaces, "launches": launches.get(name, 0),
                     "max_abs_err": m.get("max_abs_err"), "ms": m.get("ms"),
                     "plain_ms": m.get("plain_ms"), "bound_ms": m.get("bound_ms"),
                     "bound_by": m.get("bound_by"), "library_ms": m.get("library_ms")})
    emit({"phase": "done", "seconds": time.perf_counter() - t_start,
          "phase_seconds": {name: t - (marks[i - 1][1] if i else t_start)
                            for i, (name, t) in enumerate(marks)},
          "peak_memory_bytes": max(_PEAKS + [torch.cuda.max_memory_allocated()])})
    print(json.dumps({"kernels": rows}), flush=True)
    if phases != set(PHASES):
        return 0  # a partial run proves nothing: no ok line
    for r in rows:
        check(r["launches"] > 0, f"{r['name']} was never launched on its path")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
