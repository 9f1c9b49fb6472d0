#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``flexflow_tpu_torch``) on one GPU.

    python3 chip_smoke.py            # every phase, on cuda:0

Builds the port's CUDA kernels from ``flexflow_tpu_torch/csrc/`` (nvcc,
sm_90a, into ``flexflow_tpu_torch/_build/``), holds each kernel against
its plain PyTorch version at the shapes the serving path gives it,
serves LLaMA-7B (full width, all 32 layers, random bf16 weights from the
seed) through ``LLM.generate``, holds the served logits against the
plain ``kernels="torch"`` path, and checks an f32 2-layer case token for
token. Each phase prints one JSON line; the line before the last lists
every kernel with its launches on the serving run, its error against
the plain version and its times; the last line is
``{"ok": true, "device": {...}}``. Any failure raises: the script then
exits non-zero without that line. It needs a CUDA GPU and fails without
one. It imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import math
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


def _teacher_forced_logits(cfg, params, sc, seqs, prompt_lens):
    """Replay ``seqs`` (prompt + fed output tokens) through a fresh engine:
    lockstep chunked prefill, then one decode step per fed token.
    Returns each step's logits of the rows active in it, on the host."""
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
    if "decode_kernel" in n:
        return "decode_attention"
    if "verify_kernel" in n:
        return "verify_attention"
    if "memcpy" in n or "memset" in n:
        return "copy"
    if any(w in n for w in ("gemm", "gemv", "xmma", "cutlass", "nvjet")):  # cuBLAS
        return "matmul"
    return "other"


def profile_slice(llm, prompts, new):
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
    return {"phase": "profile", "wall_s": wall, "device_busy_s": busy_s,
            "device_idle_share": 1.0 - busy_s / wall,
            "device_ms_by_class": by_class,
            "top_kernels": [{"name": n, "ms": ms, "count": k} for ms, n, k in kernels[:10]]}


def phase_slice(seed):
    cfg = llama.LLaMAConfig.llama_7b()
    t0 = time.perf_counter()
    llm = LLM(llama, cfg, device=DEV, seed=seed)
    llm.compile(ServingConfig())
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    rng = np.random.default_rng(seed)
    lens = rng.integers(16, 1001, size=8)
    lens[0], lens[1] = 1000, 16
    prompts = [rng.integers(1, cfg.vocab_size, size=int(n)).tolist() for n in lens]
    new = 64
    llm.generate([[1, 2, 3]], max_new_tokens=2)  # warm-up (allocator, libraries)
    torch.cuda.synchronize()
    llm.rm.stats = SchedulerStats()
    K.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    results = llm.generate(prompts, max_new_tokens=new)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(K.LAUNCHES)
    for r in results:
        check(r.error is None, f"request {r.request_id} failed: {r.error}")
        check(len(r.output_tokens) == new, f"request {r.request_id}: "
              f"{len(r.output_tokens)} tokens, want {new}")
        check(all(0 <= t < cfg.vocab_size for t in r.output_tokens), "token out of range")
    ttft = [r.profile.ttft_s for r in results]
    stats = llm.rm.stats.snapshot()
    emit({"phase": "slice", "model": "llama_7b", "layers": cfg.num_hidden_layers,
          "dtype": "bfloat16", "requests": len(prompts), "prompt_lens": lens.tolist(),
          "new_tokens": new, "init_s": round(init_s, 3), "wall_s": wall,
          "tokens_per_s": len(prompts) * new / wall,
          "ttft_s_mean": statistics.mean(ttft), "ttft_s_max": max(ttft),
          "peak_memory_bytes": torch.cuda.max_memory_allocated(),
          "launches": launches,
          "steps": {k: stats[k] for k in ("mixed_steps", "decode_steps", "sync_steps")},
          # host wall ms of each pipelined decode dispatch (the device runs ahead)
          "decode_dispatch_ms": {"p50": stats["decode_step_ms_p50"],
                                 "p99": stats["decode_step_ms_p99"]}})
    for name, n in launches.items():
        check(n > 0, f"{name} was never launched on the serving path")
    emit(profile_slice(llm, prompts, new))

    # hold the served path against the plain one, teacher-forced, and
    # both against the same computation in f32 (the bf16 weights upcast)
    seqs = [r.input_tokens + r.output_tokens[:-1] for r in results]
    plens = [len(r.input_tokens) for r in results]
    params = llm.params
    llm.engine = llm.rm = llm.params = None
    gc.collect()
    torch.cuda.empty_cache()
    sc = dict(max_requests_per_batch=len(seqs))
    got = _teacher_forced_logits(cfg, params, ServingConfig(kernels="cuda", **sc),
                                 seqs, plens)
    want = _teacher_forced_logits(cfg, params, ServingConfig(kernels="torch", **sc),
                                  seqs, plens)
    params = _to_f32(params)
    exact = _teacher_forced_logits(
        dataclasses.replace(cfg, dtype=torch.float32), params,
        ServingConfig(kernels="torch", cache_dtype=torch.float32, **sc), seqs, plens)
    for a in got:
        check(bool(torch.isfinite(a).all()), "non-finite served logits")
    d_paths, d_cuda, d_plain = (_logit_diff(got, want), _logit_diff(got, exact),
                                _logit_diff(want, exact))
    emit({"phase": "slice_vs_plain", "steps": len(got),
          "cuda_vs_torch": d_paths, "cuda_vs_f32": d_cuda, "torch_vs_f32": d_plain,
          "tol": {"cuda_vs_torch_rel_l2": f"<= {SLICE_PATHS} * torch_vs_f32",
                  "cuda_vs_f32_rel_l2": f"<= {SLICE_VS_EXACT} * torch_vs_f32"}})
    check(d_paths["rel_l2"] <= SLICE_PATHS * d_plain["rel_l2"],
          "served logits: kernels path further from the plain path than bf16 allows")
    check(d_cuda["rel_l2"] <= SLICE_VS_EXACT * d_plain["rel_l2"],
          "served logits: kernels path further from the f32 computation than "
          "the plain bf16 path")
    del params, got, want, exact
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def phase_f32(seed):
    """Full width, 2 layers, f32: the kernels path and the plain path
    must give the same greedy tokens."""
    cfg = llama.LLaMAConfig.llama_7b(num_hidden_layers=2, dtype=torch.float32)
    rng = np.random.default_rng(seed + 1)
    prompts = [rng.integers(1, cfg.vocab_size, size=int(n)).tolist()
               for n in (300, 16, 129, 77)]
    llm = LLM(llama, cfg, device=DEV, seed=seed)
    outs = {}
    for kern in ("cuda", "torch"):
        llm.compile(ServingConfig(cache_dtype=torch.float32, kernels=kern))
        outs[kern] = [r.output_tokens for r in llm.generate(prompts, max_new_tokens=16)]
        llm.engine = llm.rm = None
        gc.collect()
        torch.cuda.empty_cache()
    check(outs["cuda"] == outs["torch"], f"f32 greedy tokens differ: {outs}")
    emit({"phase": "f32_tokens", "layers": 2, "requests": len(prompts),
          "new_tokens": 16, "equal": True})


SOURCES = {
    "decode_attention": ("flexflow_tpu_torch/csrc/decode_attention.cu",
                         "flexflow_tpu/serve/kernels.py:166"),
    "verify_attention": ("flexflow_tpu_torch/csrc/verify_attention.cu",
                         "flexflow_tpu/serve/kernels.py:279"),
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--phases", default="kernels,slice,f32",
                    help="comma list of kernels, slice, f32 (device and "
                         "build always run)")
    args = ap.parse_args(argv)
    phases = set(args.phases.split(","))
    phase_device()
    phase_build()
    main_rows = phase_kernels(args.seed) if "kernels" in phases else {}
    launches = phase_slice(args.seed) if "slice" in phases else {}
    if "f32" in phases:
        phase_f32(args.seed)
    rows = []
    for name, (src, replaces) in SOURCES.items():
        m = main_rows.get(name, {})
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": replaces, "launches": launches.get(name),
                     "max_abs_err": m.get("max_abs_err"), "ms": m.get("ms"),
                     "plain_ms": m.get("plain_ms"), "bound_ms": m.get("bound_ms"),
                     "bound_by": m.get("bound_by"), "library_ms": m.get("library_ms")})
    print(json.dumps({"kernels": rows}), flush=True)
    if phases != {"kernels", "slice", "f32"}:
        return 0  # a partial run proves nothing: no ok line
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
