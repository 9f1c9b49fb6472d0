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

from flexflow_tpu_torch.metrics import SchedulerStats
from flexflow_tpu_torch.models import llama
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
    emit({"phase": "build", "seconds": round(seconds, 3), "arch": "sm_90a",
          "sources": [f"flexflow_tpu_torch/csrc/{n}.cu" for n in _cuda.SIGNATURES],
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


def _compare(name, out, ref, dtype):
    err = (out.float() - ref.float()).abs()
    tol = TOL[dtype]
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


def _teacher_forced_logits(cfg, params, sc, seqs, prompt_lens):
    """Replay ``seqs`` (prompt + fed output tokens) through a fresh engine:
    lockstep chunked prefill, then one decode step per fed token.
    Returns each step's logits of the rows active in it, on the host. A
    paged engine gets each slot's pages as its lines arrive (its pool is
    the default worst case: nothing is preempted)."""
    eng = InferenceEngine(llama, cfg, params, sc, device=DEV)
    R, C, S = eng.num_slots, sc.prefill_chunk, eng.scratch_pos
    n = len(seqs)
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
        out.append(eng.run(bc)[rows].cpu())
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
            out.append(eng.run(bc)[rows].cpu())
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


def profile_slice(llm, prompts, new, path):
    """The slice workload once more under torch.profiler: device time by
    kernel class and the device's idle share of the wall time. The
    profiler slows the host, so the idle share is an upper bound."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        llm.generate(prompts, max_new_tokens=new)
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


def phase_paged(seed, holder):
    """The paged slice: the same 8 requests through LLM.generate on the
    paged KV cache under a 17-page budget, in every arm of PAGED_ARMS
    (one params object, each engine freed before the next). Each arm's
    kernel variant must launch, the bf16 arm must preempt, and each arm's
    teacher-forced logits are held to its kernels="torch" twin under
    slice 1's rule. Returns the launches of the arms' runs. ``holder`` is
    a list holding the bf16 params, emptied here so that they are freed
    before the f32 runs."""
    params = holder.pop()
    cfg = llama.LLaMAConfig.llama_7b()
    prompts, new = _slice_prompts(seed, cfg)
    launches, seqs = {}, None
    tf = {}
    for label, quant, fused in PAGED_ARMS:
        llm = LLM(llama, cfg, params, device=DEV)
        llm.compile(ServingConfig(kv_layout="paged", max_cached_tokens=PAGED_BUDGET,
                                  kv_quant=quant, fused_decode=fused))
        results, line = _serve(llm, prompts, new)
        kind = "fused_rope_paged_attention" if fused else "ragged_paged_attention"
        variant = f"{kind}[{quant or 'bf16'}]"
        emit({"phase": "slice", "path": f"paged-{label}", "model": "llama_7b",
              "layers": cfg.num_hidden_layers, "dtype": "bfloat16",
              "kv_quant": quant, "fused_decode": list(fused),
              "max_cached_tokens": PAGED_BUDGET, "num_pages": llm.engine.pager.num_pages,
              **line})
        check(line["launches"].get(variant, 0) > 0,
              f"{variant} was never launched on the paged-{label} arm")
        if label == "bf16":
            check(line["preemptions"] > 0, "the 17-page budget caused no preemption")
            emit(profile_slice(llm, prompts, new, "paged-bf16"))
            # every arm is teacher-forced over the bf16 arm's tokens
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
        for label, q, _ in PAGED_ARMS:
            if q == quant:
                got, want = tf.pop(label)
                _hold_to_plain(f"paged-{label}", got, want, exact)
        del exact
    del params32
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def phase_f32(seed):
    """Full width, 2 layers, f32: greedy tokens equal across kernels
    ("cuda" and "torch") on the dense layout and on f32, int8 and int4
    pools; fused and unfused (f32, int8 and int4 pools); paged and dense.
    Returns the launches of its paged runs."""
    cfg = llama.LLaMAConfig.llama_7b(num_hidden_layers=2, dtype=torch.float32)
    rng = np.random.default_rng(seed + 1)
    prompts = [rng.integers(1, cfg.vocab_size, size=int(n)).tolist()
               for n in (300, 16, 129, 77)]
    llm = LLM(llama, cfg, device=DEV, seed=seed)
    paged = dict(kv_layout="paged")
    fused = dict(fused_decode=("rope_kv_write",))
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
    }
    outs, launches = {}, {}
    for name, kw in runs.items():
        llm.compile(ServingConfig(cache_dtype=torch.float32, **kw))
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
             ("paged-cuda", "dense-cuda")]
    for a, b in pairs:
        check(outs[a] == outs[b], f"f32 greedy tokens differ: {a} {outs[a]} vs {b} {outs[b]}")
    emit({"phase": "f32_tokens", "layers": 2, "requests": len(prompts),
          "new_tokens": 16, "equal": [f"{a} == {b}" for a, b in pairs],
          "launches": launches})
    for k in ("ragged_paged_attention[f32]", "fused_rope_paged_attention[f32]"):
        check(launches.get(k, 0) > 0, f"{k} was never launched on the f32 paged runs")
    return launches


def unported_bounds():
    """Bounds of the TPU kernels still to port, at stated shapes (no
    kernel runs): the whole-step decode walk (both of its TPU kernels
    compute one step) at R = 16 decode slots holding DECODE_LENS lines
    of LLaMA-7B: its weights (the LM head included, the embedding rows
    aside) and the K/V lines read once over the HBM rate; training flash
    attention forward (4 * B * H * S^2 / 2 * dk FLOP, causal) and backward
    (2.5 times that: scores recomputed, dV, dP, dQ, dK) at B = 1, H = 32,
    S = 2048, dk = 128 over the bf16 peak."""
    cfg = llama.LLaMAConfig.llama_7b()
    D, Fd, L = cfg.hidden_size, cfg.intermediate_size, cfg.num_hidden_layers
    kvd = cfg.num_key_value_heads * cfg.head_dim
    weights = L * (D * (D + 2 * kvd) + D * D + 3 * D * Fd + 2 * D) + D * cfg.vocab_size + D
    kv_lines = sum(DECODE_LENS)
    step_bytes = 2 * weights + kv_lines * L * 2 * kvd * 2
    B, H, S, dk = 1, 32, 2048, 128
    fwd = 4 * B * H * (S * S // 2) * dk
    return {"phase": "unported_bounds",
            "whole_step_decode": {"bytes": step_bytes, "bound_ms": step_bytes / HBM_BYTES_PER_S * 1e3,
                                  "bound_by": "bytes", "R": 16, "kv_lines": kv_lines},
            "flash_fwd": {"flop": fwd, "bound_ms": fwd / PEAK_FLOPS[torch.bfloat16] * 1e3,
                          "bound_by": "operations"},
            "flash_bwd": {"flop": 5 * fwd // 2,
                          "bound_ms": 2.5 * fwd / PEAK_FLOPS[torch.bfloat16] * 1e3,
                          "bound_by": "operations"}}


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
}
PHASES = ("kernels", "slice", "paged", "f32")


def main(argv=None) -> int:
    # the run drives one card: expose only it before CUDA starts
    os.environ["CUDA_VISIBLE_DEVICES"] = one_card(os.environ.get("CUDA_VISIBLE_DEVICES"))
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma list of kernels, slice, paged, f32 (device and "
                         "build always run; paged needs slice)")
    args = ap.parse_args(argv)
    phases = set(args.phases.split(","))
    t_start = time.perf_counter()
    phase_device()
    phase_build()
    emit(unported_bounds())
    main_rows, launches = {}, {}
    if "kernels" in phases:
        main_rows = phase_kernels(args.seed)
        main_rows.update(phase_paged_kernels(args.seed))
    if "slice" in phases:
        holder = [None]
        holder[0], dense = phase_slice(args.seed)
        launches.update(dense)
        if "paged" in phases:
            launches.update({k: v for k, v in phase_paged(args.seed, holder).items()
                             if "[f32]" not in k})
        del holder
        gc.collect()
        torch.cuda.empty_cache()
    if "f32" in phases:
        launches.update(phase_f32(args.seed))
    rows = []
    for name, (src, replaces) in SOURCES.items():
        m = main_rows.get(name, {})
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": replaces, "launches": launches.get(name, 0),
                     "max_abs_err": m.get("max_abs_err"), "ms": m.get("ms"),
                     "plain_ms": m.get("plain_ms"), "bound_ms": m.get("bound_ms"),
                     "bound_by": m.get("bound_by"), "library_ms": m.get("library_ms")})
    emit({"phase": "done", "seconds": time.perf_counter() - t_start,
          "peak_memory_bytes": max(_PEAKS + [torch.cuda.max_memory_allocated()])})
    print(json.dumps({"kernels": rows}), flush=True)
    if phases != set(PHASES):
        return 0  # a partial run proves nothing: no ok line
    for r in rows:
        check(r["launches"] > 0, f"{r['name']} was never launched on a serving path")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
