#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``flexflow_tpu_torch``) on one GPU.

    python3 chip_smoke.py            # every phase, on cuda:0

Builds the port's CUDA kernels from ``flexflow_tpu_torch/csrc/`` (nvcc,
sm_90a, into ``flexflow_tpu_torch/_build/``, one nvcc per source, all
started together), holds each kernel against its plain PyTorch version
at the shapes the serving paths give it, then drives the two serving
paths of LLaMA-7B (full width, random bf16 weights from the seed) through
``LLM.generate``: the dense KV cache (all 32 layers), and the paged KV
cache (``PAGED_LAYERS`` layers) under a 17-page budget that forces
preemption, with bf16, int8 and int4 pages, unfused and with
``fused_decode=("rope_kv_write",)``.
Each path's served logits are held against its plain
``kernels="torch"`` twin, and an f32 2-layer case checks tokens for
equality across kernels, pool types, fusion and layouts. Each phase
prints one JSON line; the line before the last lists every kernel (per
pool type for the paged ones) with its launches on the serving paths,
its error against the plain version, its times and its bound; the last
line is ``{"ok": true, "device": {...}}``. Any failure raises: the
script then exits non-zero without that line. It needs a CUDA GPU and
fails without one. It imports nothing of JAX or of the JAX package.

Mixed-step tiles on the tensor cores (slice 5): the paged kernels' rows
name the block design their launcher took (``design``: "decode", "mma"
for bf16 q, "tf32x3" for f32 q) and their time over the library call's
(``vs_library``); the fused kernel's live-row output must equal the
ragged kernel's bit for bit, and its ``commit_ms`` times the launch with
a mask that attends nothing (RoPE and the commit alone), as the ragged
rows' ``empty_graph_ms`` does for the ragged kernel. The build line
lists the registers, spills, shared memory and resident blocks of every
mma kernel instantiation (from ``ptxas -v``), and every paged arm is profiled (each kernel
class's share of busy device time; launches by design).

Dense verify and the flash forward redesigned (slice 6): verify rows
carry the design their launcher took ("mma" for bf16 q at C * G > 8 on
the tensor cores, "rows8" below, "f32"), ``device_ms`` and ``pack_ms``
(the mask packed to 64-bit words once a step); the bits entry must equal
the bool entry bit for bit, and the dense arm's verify launches must all
be "mma". The flash forward rows carry "wgmma" (bf16: TMA tiles, warp-
specialised warpgroup products) or "f32" and ``device_ms``; the train
steps' forward launches must all be "wgmma". The build line reports the
registers, spills and shared bytes of both new instantiations.

Whole-step serving (slice 4): the whole-step kernel (every layer, the LM
head and the greedy argmax of a serving step in one persistent CUDA
kernel) against its plain version at LLaMA-7B width cut to 2 layers, on
decode and C = 128 mixed steps over bf16, f32, int8 and int4 pools and a
GQA case, bitwise equal at two tile counts; ``whole`` serves the paged
slice's 8 requests at full depth with ``fused_decode=("whole_step",)``
on bf16, int8 and int4 pools (no paged attention kernel may run), holds
the teacher-forced logits of each arm to its plain twin, and the f32
phase checks its greedy tokens against the unfused runs.

Slice 7: the train step's LM head runs bf16 products with f32 results
(``llama.lm_head``; the head is never copied to f32), its Adam update one
kernel launch a leaf (``adam_update``, bitwise its plain version), the
flash backward's bf16 pair on ``wgmma`` fed by TMA (design "wgmma",
rows carry ``design`` and ``device_ms``; the build line reports both
instantiations; an untimed f32 S 2048, T 1 case holds the f32 kernels'
summation to twice the plain version's error from f64), and the unfused
quantized paged step commits K and V in one launch a layer
(``paged_commit[int8|int4]``, bitwise ``quant_line_write``). Their rows
carry ``bitwise``; the train profile line splits the step's device time
into the LM head, Adam, the flash forward and the flash backward.

Slice 9: the whole-step kernel's per-stage timer (one ``whole_stages``
line a whole-step case: milliseconds by stage from the kernel's own
global-timer stamps, beside the launch's event time); its attention stage
on the paged kernels' designs (rows and slice lines name the design:
"mma" or "tf32x3" on mixed steps, "decode" at decode) and its bf16 mixed
projections on wgmma fed by TMA; the build line lists every whole-step
instantiation's registers, spills and shared bytes (the run fails at its
end if one spills), checks the library's tile bytes against the gate's
mirror (``K.mma_smem_bytes``) and the static bytes against the gate's
price. Dense verify with f32 q at C * G > 8 runs "tf32x3" (3xTF32 on the
tensor cores): its rows carry ``err_vs_f64``, and the f32 phase fails
unless the dense mixed steps took it.

The paged kernels' decode design, split over pages
(``csrc/paged_decode.cuh``). The kernels line gains a decode row of each
paged kernel per pool type (``name[pool/decode]``, launches from the
serving arms' decode steps; the bf16 rows carry the GQA case as
``gqa_kv8``), with the split count and the grid's blocks, and a bound
that counts the lines the mask attends (the design reads no other). The
paged rows' device time is ``graph_ms`` (a CUDA graph of 20 calls: the
device's time without the host's, which events around one decode call
are not, and which the profiler's sums gave bimodally), SDPA's too
(``library_graph_ms``). The build line lists every split instantiation
(``split_kernels``) and fails if one spills; each paged arm's profile
line reports its decode launches' device time
(``paged_decode_device_ms``).

One decode walk (slice 11): the dense ``decode_attention`` and the
whole-step kernel's decode stage run the paged kernels' split walk
(``csrc/paged_decode.cuh``). The decode rows are timed by ``graph_ms``,
SDPA's too, and carry the split length, count and grid
(``kernels.dense_decode_split``); a G = 16 (KV 2) case is timed at a
small size and an MQA case (KV 1, four head groups) is checked. The
build line lists the dense split instantiations among ``split_kernels``
and checks the whole step's split scratch against the gate's mirror
(``K.whole_step_split_smem_bytes``). The dense slice's padding rows
(their token at the scratch line) launch with seq_len 0: its served
tokens and teacher-forced logits must equal, bit for bit, those of the
same runs with the padding rows walking the whole cache
(``llama.decode_seq_lens`` replaced by the mask count), and its profile
line reports the decode launches' device time. The whole bf16 arm adds a
``whole_stages`` line of one stamped decode step at full depth (its
engine's weights and tile count, ``DECODE_LENS`` over a fresh pool).

SpecInfer and beam search (slice 12; no new kernel): ``spec`` serves
the dense slice's 8 requests with LLaMA-7B (width 4096, cut to
``SPEC_LAYERS`` layers) incrementally,
beam-searches one of them (3 beams), and serves them through five
SpecInfer arms (``SPEC_ARMS``: a 2-layer layer-skip SSM over the same
weights with SpecConfig(2, 3); a 1-layer one with the adaptive ladder and
verify-skip from (3, 8); the early-exit self-draft; the paged cache at 17
pages with ``rope_kv_write``; int8 pages). Each arm's line gives
speculation's numbers (``spec_step_reduction`` against the incremental
arm, ``drafted_accept_rate``, ``tokens_per_verify_step``, rounds, skipped
rounds) beside tokens/s, TTFT, preemptions and launches by kernel and
design, and a profile line (every profile line now lists each attention
kernel's device time, ``attention_kernels``). Each arm's served tokens
must be greedy over their own prefix (``spec_greedy``: teacher-forced
through the arm's kernels="cuda" engine, near-ties against bf16's own
error counted), and the fused arm's first tree-verify steps must equal
the unfused paged step bit for bit (``spec_fused_bitwise``). The f32
phase adds spec runs on every layout and pool type and beam runs.

SpecInfer on the whole-step kernel and the entry points (slice 13): the
kernel checks add the speculation fold (``WHOLE_FOLD_CASES``: verify at C
= 7 and 25, the early-exit draft at C = 2 and 3 over the first layer;
every pool type and GQA; a tree mask, slack lines across pages, the head
over every row; bitwise at two tile counts and held to the plain version
as the other whole-step cases; the design counted as ``<design>-tree``)
and SpecInfer's tree shapes on the per-layer kernels (dense verify at C =
2, 3, 7 on "rows8", both paged kernels at C = 7 and 2 on the one-split
walk) with their bounds and SDPA times. ``spec`` adds two whole-step arms
(``paged-bf16-whole``: early exit, 17 pages; ``paged-int8-whole``: a
2-layer SSM whose engine runs the walk too, 33 pages): no per-layer paged
attention may run, every tree step is a fold launch
(``whole_step_decode[<pool>/tree]`` rows of the kernels line), and a
stamped ``whole_stages`` line times one verify and one draft launch. The
f32 phase holds whole-step spec runs to their ``kernels="torch"`` twins.
``entry`` writes a checkpoint in HF naming and serves it through
``LLM.from_pretrained``, ``generate_stream`` and ``python -m
flexflow_tpu_torch serve``.

Prefix caching and the host tier (slice 14; no new kernel): ``prefix``
serves 32 requests of LLaMA-7B (``PREFIX_LAYERS`` layers) that share a 1000-token system
prompt through five arms, each against its twin (``PREFIX_ARMS``: bf16
unfused, int8 ``rope_kv_write`` under ``cache_policy="prefill"``, bf16
``whole_step``, int8 whole-step SpecInfer with a 2-layer SSM, each against
the same engine with caching off; and int4 with the host tier, four
families of system prompt in a pool that spills them, against a roomy
warm twin). Each arm's line gives tokens/s, TTFT (the second wave's and
all), prefill tokens, hits, copies, evictions, spills, re-admits and
host bytes beside its twin's; a warm arm must dispatch fewer prefill
tokens than a cold run by at least its hit tokens, leak no page after its
drain, launch its kernels, and serve its twin's tokens or, where a
copied int8 tail page parts them, tokens greedy over their own prefix;
a chunk-aligned probe's first row must equal the cold run's bit for bit.
``prefix_movers`` times ``copy_page``, ``fetch_page`` and ``upload_page``
on one page (bf16 and int4) and checks a spilled page uploads byte for
byte; ``prefix_f32`` holds cold, warm and spilled runs at 2 layers on
every pool, fusion and SpecInfer to each other and to their
``kernels="torch"`` twins, and a tight pool's preemptions with caching on
to those with it off.

The generic decoder and the other families: the kernel checks
add the paged kernels (and the commit kernel) at head dims 80 (Phi-2) and
256 (Gemma-7B) on every pool type at C = 128 and at decode, and Falcon-7B's
MQA decode (G = 71, the tensor-core tile at C = 1), as rows
``name[dk80|dk256|mqa-g71]`` of the kernels line, every case under
``cases``. ``families`` serves Falcon-7B (``FALCON_LAYERS`` layers; the paged slice's
8 requests; bf16, bf16 ``rope_kv_write``, int8 ``rope_kv_write``) and ten
families at their published widths cut to 2 layers (OPT-6.7B,
StarCoder-15B, Qwen2-7B, Mistral-7B across its 4096-token window,
Mixtral-8x7B, Qwen1.5-MoE, Gemma-7B, Phi-2, GPT-2 XL, MPT-7B), each arm held
to its ``kernels="torch"`` twin (teacher-forced logits under slice 1's
rule, the first step's logits, tokens greedy over their prefix); MPT's
ALiBi batches launch no paged kernel, each step counted on the plain path
(``plain_attention_steps``). ``entry`` also serves a 2-layer Falcon
checkpoint in HF naming (the fused ``query_key_value``) through
``from_pretrained``, ``generate``, ``generate_stream`` and ``serve``.

The generic decoder's whole step (slice 16): the whole-step kernel's
checks add the generic body (``WHOLE_GENERIC_CASES``: Falcon-7B's MQA at
G = 71 with a parallel block, Phi-2's head dim 80 with partial RoPE and
every bias, Gemma-7B's head dim 256 with RMS by 1 + w and GeGLU-tanh,
GPT-2 XL's learned positions and V = 50257; Phi-2 and Gemma on every
pool type; ``WHOLE_GENERIC_FOLD_CASES``: Phi-2's fold), held as LLaMA's,
rows ``whole_step_decode[<family>]`` of the kernels line. ``families``
adds Falcon-7B's ``bf16-whole`` and ``int8-whole`` arms (a
stamped ``whole_stages`` line of the bf16 arm's decode step) and a
``bf16-whole`` arm to each 2-layer family the whole step takes; Mistral,
Mixtral, Qwen1.5-MoE and MPT must refuse it at construction. The build
line lists every whole-step function that spills (``whole_step_spills``:
the dk-256 attention functions); one below dk 256 fails the run.

Weight-only quantization, offload and clusters (slice 18): the kernel
checks add ``wq_matmul[int8|int4]`` (``csrc/wq_matmul.cu``: y = x @
dequantize(q, scale) without a bf16 copy of the weight) against its plain
version at LLaMA-7B's projection shapes at decode (M 16, design
"splitk": tensor cores, K split over a thread block cluster) and at a
16-slot C = 128 mixed step (M 2048, "wgmma"), f32 cases ("rows", "f32")
and Mixtral-8x7B's expert stack, each beside the bf16 ``torch.matmul`` of
the dequantized weight (and, where the card's PyTorch has a CUDA kernel
for it, ``aten._weight_int8pack_mm`` at the int8 shapes); bf16 cases
bitwise from run to run; decode cases also timed cold, over enough
copies of the weights that a graph's working set passes 150 MB.
``quant`` serves the paged slice's 8 requests with bf16, int8 and int4
weights and int8 with ``rope_kv_write`` (LLaMA-7B, 32 layers, 72 pages:
no preemption): every
projection of a quantized arm runs wq_matmul (the plain dequantize path
never; every decode step 7 launches a layer of "splitk", every mixed step
"wgmma"), tokens greedy over their own teacher-forced prefix, first-step
logits against the bf16 arm, param bytes, a profile of the quantized
arms. ``offload`` serves 2 requests x 8 tokens with the layers in pinned
host memory against the same weights resident (bf16 and int8): tokens
and first-step logits bitwise, device memory lower by at least 90% of the
layer bytes, the step beside the pinned copy rate. ``cluster`` drives
in-process clusters: prefix routing against round robin at 32 layers,
then at 8 layers 1 replica against the bare engine (bitwise),
disaggregated 1 + 1 pools on bf16 and int8 pages (every migrated page
byte-exact), a scripted crash (failover) and a warm standby's adoption.

The quantized commit redesigned (slice 20): each ``paged_commit`` row
(int8 and int4 at decode and C = 128, SpecInfer's tree steps, head dims 80
and 256) carries ``graph_ms`` (a CUDA graph of 20 restore-and-commit pairs
less a graph of the 20 restores; each restore copies back the pages the
commit can write and reads 64 MB to evict L2) beside the event ``ms``,
the kernel's ``design`` as its library names it ("line-warp" at C = 1;
"pair", K and V in one block, at C <= 32; "block" above) and, under
``serial``, the first design's times and bits
(``scripts/paged_commit_serial.cu``, built and launched by this script
alone), timed in turns on the same card. Two more cases a pool type:
decode with 8 live slots of 16 (the others' lines on the scratch page,
which the commit skips) and a C = 128 step whose lines are shuffled
within each slot (a page's lines neither contiguous nor sorted); the
kernels line's commit rows list every case, the tree steps too, under
``cases``. The bound counts the lines off the scratch page and, of the
pages whose codes change, only the lines no new line overwrites
(``bound_all_lines_ms`` PR 7's count). The build line lists each commit
instantiation's registers and spills (``commit_kernels``).

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
import collections
import contextlib
import ctypes
import dataclasses
import functools
import gc
import glob
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from flexflow_tpu_torch import obs as OBS
from flexflow_tpu_torch import optimizers as O
from flexflow_tpu_torch.metrics import SchedulerStats
from flexflow_tpu_torch.models import (falcon, gemma, gpt2, llama, mistral, mixtral, mpt, opt,
                                       phi, qwen2, qwen2_moe, starcoder)
from flexflow_tpu_torch.models import transformer as TD
from flexflow_tpu_torch.obs import export as OBS_EXPORT
from flexflow_tpu_torch.ops import flash_attention as FA
from flexflow_tpu_torch.serve import kernels as K
from flexflow_tpu_torch.serve import _cuda
from flexflow_tpu_torch.serve.batch_config import BatchConfig, GenerationConfig
from flexflow_tpu_torch.serve import kv_quant as KQ
from flexflow_tpu_torch.serve.engine import InferenceEngine, ServingConfig
from flexflow_tpu_torch.serve.llm import LLM
from flexflow_tpu_torch.serve.request_manager import RequestManager
from flexflow_tpu_torch.serve.specinfer import SpecConfig, SpecInferManager

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
# TF32 tensor cores, dense: the rate of the f32 paged tile ("tf32x3"),
# which runs each f32 product as three TF32 products (two on quantized
# pools, whose codes are exact in TF32)
TF32_FLOPS = 494.7e12
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
# the depth of the paged, whole and obs phases: LLaMA-7B's width cut to 8
# of its 32 layers (the whole run took 1180.7 s of its 1200 s with them at
# full depth and 1069 s at 16, the quant, offload and cluster phases
# added; the dense slice, quant, offload and the cluster's placement pair
# keep all 32)
PAGED_LAYERS = 8
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


# H100 (sm_90): registers an SM, allocated per warp in units of 256;
# shared memory an SM, of which 1 KB a block is reserved; threads an SM
SM_REGISTERS, SM_SMEM, SM_THREADS = 65536, 233472, 2048


def _verify_mma_smem(dk):
    """Dynamic shared bytes of ``verify_mma_kernel<DK>``
    (``VerifyMmaSmem`` in ``csrc/verify_attention.cu``): three stages of
    bf16 K/V tiles of 64 lines, the words of 32 tiles x 128 rows, tile
    flags."""
    return 3 * 2 * 64 * (dk + 8) * 2 + 8 * 32 * 128 + 32 * 4


def _verify_tf32_smem(dk):
    """Dynamic shared bytes of ``verify_tf32_kernel<DK>``
    (``VerifyTf32Smem``): f32 K/V tiles of 64 lines with rows of dk + 4
    floats, the block's 128 Q rows, the words and flags of the staged
    tiles; three stages and 32 tiles, or two and 16 where those pass the
    tile budget (dk 128)."""
    pair, q = 2 * 64 * (dk + 4) * 4, 128 * (dk + 4) * 4

    def meta(n):
        return 8 * n * 128 + n * 4
    stages = 3 if q + 3 * pair + meta(16) <= K.MMA_SMEM_BUDGET else 2
    fixed = q + stages * pair
    return fixed + meta(32 if fixed + meta(32) <= K.MMA_SMEM_BUDGET else 16)


def _flash_bwd_kv_smem(dk):
    """Dynamic shared bytes of ``flash_bwd_kv_wgmma_kernel<DK>``
    (``bwg::KvSmem`` in ``csrc/flash_attention_bwd.cu``): K and V boxes of
    128 lines, three stages of Q and dO boxes of 64 rows, two buffers of a
    tile's lse and delta for each consumer, 1024 bytes of alignment
    slack."""
    return 2 * (dk // 64) * 128 * 128 + 3 * 2 * (dk // 64) * 64 * 128 + 2 * 2 * 512 + 1024


def _flash_bwd_q_smem(dk):
    """Dynamic shared bytes of ``flash_bwd_q_wgmma_kernel<DK>``
    (``bwg::QSmem``): Q and dO boxes of 128 rows, three stages of K and V
    boxes of 64 lines, 1024 bytes of alignment slack."""
    return 2 * (dk // 64) * 128 * 128 + 3 * 2 * (dk // 64) * 64 * 128 + 1024


def _flash_wgmma_smem(dk):
    """Dynamic shared bytes of ``flash_fwd_wgmma_kernel<DK>``
    (``wg::Smem`` in ``csrc/flash_attention_fwd.cu``): Q boxes of 128 rows,
    three stages of K and V boxes of 64 lines (128 bytes a row of a box),
    1024 bytes of alignment slack."""
    return (dk // 64) * 128 * 128 + 3 * 2 * (dk // 64) * 64 * 128 + 1024


# the tensor-core instantiations the build line reports: (source, name
# pattern of the entry function, its fields, threads a block, dynamic
# shared bytes from the fields); the paged kernels' by q type: bf16 "mma",
# f32 "tf32x3"
MMA_KERNELS = (
    *((src, r"_mma_kernelI13__nv_bfloat16Li(\d)ELi(\d+)E", ("pool", "dk"), 256,
       lambda kind, dk: K.mma_smem_bytes(False, kind, dk))
      for src in K.PAGED_KERNELS),
    *((src, r"_mma_kernelIfLi(\d)ELi(\d+)E", ("pool", "dk"), 256,
       lambda kind, dk: K.mma_smem_bytes(True, kind, dk))
      for src in K.PAGED_KERNELS),
    ("verify_attention", r"verify_mma_kernelILi(\d+)E", ("dk",), 256, _verify_mma_smem),
    ("verify_attention", r"verify_tf32_kernelILi(\d+)E", ("dk",), 256, _verify_tf32_smem),
    ("flash_attention_fwd", r"flash_fwd_wgmma_kernelILi(\d+)E", ("dk",), 384,
     _flash_wgmma_smem),
    ("flash_attention_bwd", r"flash_bwd_kv_wgmma_kernelILi(\d+)E", ("dk",), 384,
     _flash_bwd_kv_smem),
    ("flash_attention_bwd", r"flash_bwd_q_wgmma_kernelILi(\d+)E", ("dk",), 384,
     _flash_bwd_q_smem),
)


def _mma_report(reports):
    """Each tensor-core kernel instantiation (the paged kernels' by pool
    and dk, verify's and the flash kernels' by dk) from its ``ptxas -v``
    report: registers and spill bytes a thread (the wgmma flash kernels'
    registers are their launch count; setmaxnreg moves them between their
    warpgroups), shared bytes a block (ptxas's static bytes plus the
    dynamic layout) and the blocks an SM holds, by threads, registers and
    shared memory."""
    rows = []
    for src, pattern, fields, threads, smem_of in MMA_KERNELS:
        for fn in reports.get(src, "").split("Compiling entry function '")[1:]:
            m = re.search(pattern, fn.split("'")[0])
            if not m:
                continue
            vals = [int(x) for x in m.groups()]
            regs = int(re.search(r"Used (\d+) registers", fn)[1])
            spills = int(re.search(r"(\d+) bytes spill stores", fn)[1])
            static = re.search(r"(\d+) bytes smem", fn)
            smem = (int(static[1]) if static else 0) + smem_of(*vals)
            warp_regs = -(-regs * 32 // 256) * 256
            blocks = min(SM_THREADS // threads, SM_REGISTERS // (threads // 32 * warp_regs),
                         SM_SMEM // (smem + 1024))
            name = src if src != "flash_attention_bwd" else (
                "flash_attention_bwd_kv" if "_kv_" in pattern else "flash_attention_bwd_q")
            row = {"kernel": name, **dict(zip(fields, vals)), "registers": regs,
                   "spill_store_bytes": spills, "smem_bytes": smem, "blocks_per_sm": blocks}
            if "pool" in row:
                f32 = "_mma_kernelIf" in pattern
                row["design"] = "tf32x3" if f32 else "mma"
                row["pool"] = (("f32" if f32 else "bf16"), "int8", "int4")[row["pool"]]
            elif src == "verify_attention":
                row["design"] = "tf32x3" if "tf32" in pattern else "mma"
            rows.append(row)
    return sorted(rows, key=lambda x: (x["kernel"], x.get("design", ""), x.get("pool", ""),
                                       x["dk"]))


# the split decode walk's kernels (csrc/paged_decode.cuh): q type, pool
# kind, dk and GB (most query rows a KV head) of each paged instantiation;
# q type, dk and GB of each dense one (csrc/decode_attention.cu)
SPLIT_KERNEL = r"(ragged|fused)_split_kernelI(13__nv_bfloat16|f)Li(\d)ELi(\d+)ELi(\d)E"
DENSE_SPLIT_KERNEL = r"(dense)_split_kernelI(13__nv_bfloat16|f)()Li(\d+)ELi(\d)E"


def _split_report(reports):
    """Each split decode instantiation of the two paged kernels (q dtype x
    pool x dk x rows) and of the dense one (q dtype x dk x rows) from its
    ``ptxas -v`` report: registers, spill bytes and static shared bytes a
    block of 128 threads, and the blocks an SM holds by threads, registers
    and shared memory."""
    rows = []
    for src, pattern in ([(k, SPLIT_KERNEL) for k in K.PAGED_KERNELS]
                         + [("decode_attention", DENSE_SPLIT_KERNEL)]):
        for fn in reports.get(src, "").split("Compiling entry function '")[1:]:
            m = re.search(pattern, fn.split("'")[0])
            if not m:
                continue
            f32, kind = m[2] == "f", int(m[3] or 0)
            regs = int(re.search(r"Used (\d+) registers", fn)[1])
            static = re.search(r"(\d+) bytes smem", fn)
            smem = int(static[1]) if static else 0
            warp_regs = -(-regs * 32 // 256) * 256
            rows.append({"kernel": src, "dtype": "f32" if f32 else "bf16",
                         "pool": (("f32" if f32 else "bf16"), "int8", "int4")[kind],
                         "dk": int(m[4]), "rows": int(m[5]), "registers": regs,
                         "spill_store_bytes": int(re.search(r"(\d+) bytes spill stores", fn)[1]),
                         "smem_bytes": smem,
                         "blocks_per_sm": min(SM_THREADS // 128, SM_REGISTERS // (4 * warp_regs),
                                              SM_SMEM // (smem + 1024))})
    return sorted(rows, key=lambda x: (x["kernel"], x["dtype"], x["pool"], x["dk"], x["rows"]))


def _whole_report(report):
    """Each whole-step kernel instantiation (q dtype x pool x dk) from its
    ``ptxas -v`` report (registers, spill bytes, static shared bytes) and
    from its library (``_cuda.whole_step_smem``: the tensor-core tile's
    dynamic bytes, the static bytes the runtime gives); checks that the
    library's tile bytes are the gate's mirror (``K.mma_smem_bytes``), and
    so are its split walk's (``K.whole_step_split_smem_bytes``), that the
    gate's static price covers the static bytes, that the tile and the
    static bytes fit one block. Spills are listed (:func:`_whole_spills`)."""
    rows = []
    for fn in report.split("Compiling entry function '")[1:]:
        m = re.search(r"whole_step_kernelI(13__nv_bfloat16|f)Li(\d)ELi(\d+)E", fn.split("'")[0])
        if not m:
            continue
        f32, kind, dk = m[1] == "f", int(m[2]), int(m[3])
        static_ptxas = re.search(r"(\d+) bytes smem", fn)
        mma, static, split = _cuda.whole_step_smem(0 if f32 else 1, kind, dk)
        row = {"dtype": "f32" if f32 else "bf16",
               "pool": (("f32" if f32 else "bf16"), "int8", "int4")[kind], "dk": dk,
               "registers": int(re.search(r"Used (\d+) registers", fn)[1]),
               "spill_store_bytes": int(re.search(r"(\d+) bytes spill stores", fn)[1]),
               "static_smem_ptxas": int(static_ptxas[1]) if static_ptxas else 0,
               "static_smem_runtime": static, "mma_smem_bytes": mma,
               "mma_smem_mirror": K.mma_smem_bytes(f32, kind, dk),
               "split_smem_bytes": split,
               "split_smem_mirror": K.whole_step_split_smem_bytes(f32, dk, 0)}
        rows.append(row)
        what = f"whole_step_kernel[{row['dtype']}, {row['pool']}, dk {dk}]"
        check(mma == row["mma_smem_mirror"], f"{what}: tile {mma} bytes, mirror "
                                             f"{row['mma_smem_mirror']}")
        check(split == row["split_smem_mirror"], f"{what}: split walk {split} bytes, mirror "
                                                 f"{row['split_smem_mirror']}")
        check(static <= K._WS_STATIC_SMEM, f"{what}: {static} static bytes over the gate's "
                                           f"{K._WS_STATIC_SMEM}")
        check(mma + static <= K.WHOLE_STEP_SMEM_BUDGET, f"{what}: {mma} + {static} bytes")
    check(len(rows) == 24, f"whole-step instantiations in the ptxas report: {len(rows)}")
    return sorted(rows, key=lambda r: (r["dtype"], r["pool"], r["dk"]))


def _whole_spills(report):
    """Every function of the whole-step library that spills, from its
    ``ptxas -v`` report: (function, stack frame, spill store and load
    bytes). The dk-256 instantiations' attention functions spill a few
    words at 255 registers, as the paged kernels' dk-256 tiles do."""
    out, fn = [], None
    for line in report.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            fn = m[1]
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and fn is not None and int(m[2]):
            name = re.search(r"([a-z][a-z_]+I(?:13__nv_bfloat16|f)(?:Li\d+E)*)", fn)
            out.append({"function": name[1] if name else fn, "dk256": "Li256E" in fn,
                        "stack_frame": int(m[1]), "spill_store_bytes": int(m[2]),
                        "spill_load_bytes": int(m[3])})
            fn = None
    return out


# record_function ranges of the port (``llama.lm_head``); a trace shows
# each also as a device-side span over its kernels, which is no kernel
RANGES = ("lm_head", "lm_head.backward")


def _kernel_events(prof):
    """The device's kernel and copy events of a profile: its CUDA events
    but the device-side spans of RANGES."""
    return [ev for ev in prof.profiler.kineto_results.events()
            if ev.device_type() == torch.autograd.DeviceType.CUDA and ev.name() not in RANGES]


def device_ms(fn, iters: int = 10) -> float:
    """Mean device time of one call of ``fn``: the summed durations of the
    kernels it launched, from a trace of ``iters`` calls (host gaps between
    them, which ``cuda_ms`` counts, excluded)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    ns = sum(ev.duration_ns() for ev in _kernel_events(prof))
    return ns / 1e6 / iters


_CAPTURE_STREAM = []


def graph_ms(fn, calls: int = 20, replays: int = 5) -> float:
    """Median time of one call of ``fn`` from a CUDA graph of ``calls``
    calls, by CUDA events around each of ``replays`` replays: the device's
    time alone (with the gaps between launches), which events around one
    call do not give when the host takes longer than the device. ``fn``
    runs once first on the capture stream, one for the whole run (the
    wrappers keep scratch per stream)."""
    if not _CAPTURE_STREAM:
        _CAPTURE_STREAM.append(torch.cuda.Stream())
    stream = _CAPTURE_STREAM[0]
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        fn()
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(replays):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / calls)
    del graph
    return statistics.median(times)


def back_to_back_ms(fn, iters: int = 20) -> float:
    """Mean time of one call of ``fn`` from CUDA events around ``iters``
    calls launched back to back: the device's time alone when the host
    enqueues a call faster than the device runs one. The flash forward's
    rows use it for ``device_ms``: late in this script the profiler's
    kernel sums read ~30% under it for that kernel, where in a fresh
    process profiler, per-call events and this agree
    (``scripts/flash_probe.py timing``; PERF.md)."""
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / iters


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


def _wq_report(text):
    """Registers and spill bytes of each wq_matmul function (its template
    arguments: bits, then rows) in a ptxas -v report."""
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


COMMIT_KERNEL = r"paged_commit_kernelI(13__nv_bfloat16|f)Li(\d)ELi(\d+)ELi(\d)E"


def _commit_report(text):
    """Each instantiation of the commit kernel (q dtype x pool x dk x
    form) from its ``ptxas -v`` report: registers and spill bytes a
    thread. The "pair" and "block" forms are held to 64 registers (four
    blocks of 256 threads an SM), where some spill a few bytes; the build
    line lists them."""
    rows = []
    for fn in text.split("Compiling entry function '")[1:]:
        m = re.search(COMMIT_KERNEL, fn.split("'")[0])
        if m:
            rows.append({"dtype": "f32" if m[1] == "f" else "bf16",
                         "pool": ("f32", "int8", "int4")[int(m[2])], "dk": int(m[3]),
                         "design": _cuda.DESIGNS["paged_commit"][0][int(m[4])],
                         "registers": int(re.search(r"Used (\d+) registers", fn)[1]),
                         "spill_store_bytes": int(re.search(r"(\d+) bytes spill stores",
                                                            fn)[1])})
    return sorted(rows, key=lambda x: (x["design"], x["dtype"], x["pool"], x["dk"]))


#: the commit's first design, the yardstick of the commit rows
#: (``_serial_commit``): a source outside the package, built by this script
#: beside the package's sources with their flags and headers, and launched
#: by it alone
SERIAL_COMMIT_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "scripts",
                                 "paged_commit_serial.cu")
_SERIAL_COMMIT = {}


def _build_serial_commit():
    """Start ``nvcc`` on SERIAL_COMMIT_SRC; returns a function that waits
    for it, loads the library into ``_SERIAL_COMMIT`` and returns the
    ``ptxas`` report (raises if the build failed)."""
    _cuda.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    target = str(_cuda.BUILD_DIR / "paged_commit_serial.so")
    proc = subprocess.Popen([_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-I", str(_cuda.SRC_DIR),
                             "-o", target, SERIAL_COMMIT_SRC],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)

    def finish():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"paged_commit_serial build failed (nvcc exit "
                               f"{proc.returncode}):\n{out}")
        lib = ctypes.CDLL(target)
        lib.paged_commit_serial_launch.argtypes = (
            [ctypes.c_void_p] * 8 + [ctypes.c_int] * 9 + [ctypes.c_float, ctypes.c_void_p])
        lib.paged_commit_serial_launch.restype = ctypes.c_int
        lib.error_string.argtypes = [ctypes.c_int]
        lib.error_string.restype = ctypes.c_char_p
        _SERIAL_COMMIT["lib"] = lib
        return out
    return finish


def phase_build():
    t0 = time.perf_counter()
    serial = _build_serial_commit()
    try:
        reports = _cuda.build()
    finally:
        serial_report = serial()
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
    mma = _mma_report(reports)
    whole = _whole_report(reports["whole_step_decode"]) if "whole_step_decode" in reports else []
    whole_spills = _whole_spills(reports.get("whole_step_decode", ""))
    split = _split_report(reports)
    commit = _commit_report(reports.get("paged_commit", ""))
    emit({"phase": "build", "seconds": round(seconds, 3), "arch": "sm_90a",
          "sources": [f"flexflow_tpu_torch/csrc/{n}.cu" for n in sources],
          "ptxas": info, "mma_kernels": mma, "split_kernels": split,
          "whole_step_kernels": whole, "whole_step_spills": whole_spills,
          "wq_kernels": _wq_report(reports.get("wq_matmul", "")),
          "commit_kernels": commit,
          "commit_spills": [f"{r['design']} {r['dtype']}/{r['pool']}/dk{r['dk']}: "
                            f"{r['spill_store_bytes']} bytes" for r in commit
                            if r["spill_store_bytes"]],
          "serial_commit": {"source": "scripts/paged_commit_serial.cu",
                            "max_registers": max(map(int, re.findall(
                                r"Used (\d+) registers", serial_report)), default=None)}})
    # the commit: 2 q types x 2 pool types x 4 head dims x 3 forms, when
    # this run compiled its source
    want = 48 * ("paged_commit" in reports)
    check(len(commit) == want, f"commit instantiations in the ptxas report: {len(commit)}, "
                               f"want {want}")
    # the split decode walk: 2 q types x 3 pool types x 4 head dims x 3 row
    # counts in each paged source compiled by this run, 2 x 2 x 3 in the
    # dense one, none spilling
    want = (72 * sum(src in reports for src in K.PAGED_KERNELS)
            + 12 * ("decode_attention" in reports))
    check(len(split) == want, f"split decode instantiations in the ptxas report: {len(split)}, "
                              f"want {want}")
    check(all(r["spill_store_bytes"] == 0 for r in split),
          "a split decode instantiation spills: " + str(
              [r for r in split if r["spill_store_bytes"]]))
    # the f32 tensor-core tile: 3 pool types x 4 head dims in each paged
    # source compiled by this run, none spilling below dk 256 (there the
    # 128-register accumulator of a warp's 16 rows x 256 dims spills a few
    # words: the build line lists them)
    tf32 = [r for r in mma if r.get("design") == "tf32x3" and r["kernel"] in K.PAGED_KERNELS]
    want = 12 * sum(src in reports for src in K.PAGED_KERNELS)
    check(len(tf32) == want, f"tf32x3 instantiations in the ptxas report: {len(tf32)}, "
                             f"want {want}")
    check(all(r["spill_store_bytes"] == 0 for r in tf32 if r["dk"] != 256),
          "a tf32x3 instantiation below dk 256 spills")
    # a whole-step function below dk 256 that spills fails the run at its
    # end, after every phase has printed its measurements; the dk-256
    # instantiations' spills are on the build line (their attention holds a
    # warp's 16 x 256 accumulator at 255 registers, as the paged tiles do)
    return [f"{r['dtype']}/{r['pool']}/dk{r['dk']}: {r['spill_store_bytes']} bytes"
            for r in whole if r["spill_store_bytes"] and r["dk"] != 256] + [
        f"{r['function']}: {r['spill_store_bytes']} bytes" for r in whole_spills
        if not r["dk256"]]


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


def _verify_bound(q, k, mask, design):
    """The serving path's call, the bits entry: q, the packed mask words
    and out once, the K/V lines some row of a slot attends; or its
    operations over the rate of the unit that runs them ("tf32x3": three
    TF32 products for each f32 one). Returns the bound, what bounds it
    and, for "tf32x3", the operations' time on the f32 CUDA cores."""
    R, C, H, dk = q.shape
    KV = k.shape[2]
    isz = q.element_size()
    lines = int(mask.any(dim=1).sum())  # lines some row of the slot attends
    nbytes = (2 * q.numel() * isz + 8 * R * C * -(-mask.shape[2] // 64)
              + 2 * lines * KV * dk * isz)
    flops = 4 * int(mask.sum()) * H * dk
    t_b, t_f = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[q.dtype]
    cuda_core_ms = None
    if design == "tf32x3":
        cuda_core_ms = max(t_b, t_f) * 1e3
        t_f = 3 * flops / TF32_FLOPS
    return max(t_b, t_f) * 1e3, ("bytes" if t_b >= t_f else "operations"), cuda_core_ms


def _verify_f64(q, k, v, mask):
    """``verify_attention_ref``'s attention recomputed in f64; a row with
    nothing to attend gives 0."""
    R, C, H, dk = q.shape
    KV = k.shape[2]
    qg = q.double().reshape(R, C, KV, H // KV, dk)
    s = torch.einsum("rckgd,rskd->rkgcs", qg, k.double()) / math.sqrt(dk)
    p = torch.softmax(s.masked_fill(~mask[:, None, None], -math.inf), dim=-1).nan_to_num(0.0)
    return torch.einsum("rkgcs,rskd->rkgcd", p, v.double()).permute(0, 3, 1, 2, 4).reshape(
        R, C, H, dk)


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
    """The dense kernel against its plain version (a slot of length 0
    exactly 0), with its split walk's grid: split length, splits, blocks
    launched and blocks that walk lines (a split past its slot's length
    exits before any load). Timed: ``ms`` by CUDA events around a call,
    ``graph_ms`` (the device's time; a decode call's events time the
    host), the plain version, and SDPA (``library_ms``,
    ``library_graph_ms``) over the same lines; the bound counts the lines
    attended."""
    q, k, v, sl = _decode_case(gen, dtype, R, S1, H, KV, dk, seq_lens)
    out = K.decode_attention(q, k, v, sl)
    torch.cuda.synchronize()
    ref = K.decode_attention_ref(q, k, v, sl)
    err = _compare(f"decode_attention[{label}]", out, ref, dtype)
    zero_rows = [i for i, n in enumerate(seq_lens) if n == 0]
    if zero_rows:
        check(bool((out[zero_rows] == 0).all()), "decode: zero-length slot not zero")
    groups = K.dense_head_groups(H // KV)
    split, n = K.dense_decode_split(R, KV, S1, groups)
    walking = sum(max(1, -(-min(x, S1) // split)) for x in seq_lens) * KV * groups
    row = {"phase": "kernels", "kernel": "decode_attention", "case": label,
           "dtype": str(dtype).replace("torch.", ""), "design": "split",
           "shape": {"R": R, "S1": S1, "H": H, "KV": KV, "dk": dk},
           "split_lines": split, "splits": n, "blocks": R * KV * groups * n,
           "walking_blocks": walking, "max_abs_err": err, "tol": TOL[dtype]}
    if timed:
        bound_ms, bound_by = _decode_bound(q, k, sl)
        valid = (torch.arange(S1, device=DEV)[None, :] < sl[:, None])[:, None, :]
        sq, sk, svv, smask = _sdpa_inputs(q[:, None], k, v, valid)

        def sdpa():
            return torch.nn.functional.scaled_dot_product_attention(sq, sk, svv, attn_mask=smask)
        row.update(
            ms=cuda_ms(lambda: K.decode_attention(q, k, v, sl)),
            graph_ms=graph_ms(lambda: K.decode_attention(q, k, v, sl)),
            plain_ms=cuda_ms(lambda: K.decode_attention_ref(q, k, v, sl), iters=5),
            library_ms=cuda_ms(sdpa), library_graph_ms=graph_ms(sdpa),
            bound_ms=bound_ms, bound_by=bound_by,
        )
    emit(row)
    return row


# what the decode_attention row of the kernels line carries of its GQA cases
DECODE_GQA_KEYS = ("max_abs_err", "ms", "graph_ms", "plain_ms", "bound_ms", "bound_by",
                   "library_ms", "library_graph_ms", "split_lines", "splits", "blocks",
                   "walking_blocks", "shape")


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
    """The kernel against its plain version in the design its launcher
    takes ("mma" and "tf32x3" for bf16 and f32 q at C * G > 8, "rows8" and
    "f32" below), the bits entry bitwise the bool entry; f32 results also
    against f64 (``err_vs_f64``, kernel and plain; the kernel within the
    f32 tolerance). Timed: ``ms`` and ``device_ms`` of the bits entry (the
    serving path's per-layer call), ``pack_ms`` of the once-a-step
    packing."""
    C = mask.shape[1]
    q = _rand((R, C, H, dk), dtype, gen)
    k = _rand((R, S1, KV, dk), dtype, gen)
    v = _rand((R, S1, KV, dk), dtype, gen)
    out, design = _design_of("verify_attention", lambda: K.verify_attention(q, k, v, mask))
    wide = C * H // KV > 8
    want = (("tf32x3" if wide else "f32") if dtype == torch.float32
            else ("mma" if wide else "rows8"))
    check(design == want, f"verify_attention[{label}]: design {design}, want {want}")
    bits = K.pack_mask_bits(mask)
    check(torch.equal(K.verify_attention_bits(q, k, v, bits, S1), out),
          f"verify_attention[{label}]: the bits entry differs from the bool entry")
    torch.cuda.synchronize()
    ref = K.verify_attention_ref(q, k, v, mask)
    err = _compare(f"verify_attention[{label}]", out, ref, dtype)
    empty = ~mask.any(dim=-1)  # (R, C) fully masked rows
    if bool(empty.any()):
        check(bool((out[empty] == 0).all()), "verify: fully masked row not zero")
    row = {"phase": "kernels", "kernel": "verify_attention", "case": label,
           "dtype": str(dtype).replace("torch.", ""), "design": design,
           "shape": {"R": R, "C": C, "S1": S1, "H": H, "KV": KV, "dk": dk},
           "attended_pairs": int(mask.sum()), "max_abs_err": err, "tol": TOL[dtype]}
    if dtype == torch.float32:
        exact = _verify_f64(q, k, v, mask)
        row["err_vs_f64"] = {name: float((x.double() - exact).abs().max())
                             for name, x in (("kernel", out), ("plain", ref))}
        check(row["err_vs_f64"]["kernel"] <= TOL[dtype]["atol"],
              f"verify_attention[{label}]: {row['err_vs_f64']['kernel']} from f64")
        del exact
    del ref
    if timed:
        bound_ms, bound_by, row["bound_cuda_core_ms"] = _verify_bound(q, k, mask, design)
        sq, sk, svv, smask = _sdpa_inputs(q, k, v, mask)
        row.update(
            ms=cuda_ms(lambda: K.verify_attention_bits(q, k, v, bits, S1)),
            device_ms=device_ms(lambda: K.verify_attention_bits(q, k, v, bits, S1)),
            pack_ms=cuda_ms(lambda: K.pack_mask_bits(mask)),
            plain_ms=cuda_ms(lambda: K.verify_attention_ref(q, k, v, mask), iters=5),
            library_ms=cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
                sq, sk, svv, attn_mask=smask)),
            bound_ms=bound_ms, bound_by=bound_by,
        )
        row["vs_library"] = _vs_library(row)
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
    gqa = run_decode_check("llama7b-gqa", gen, bf16, R, S1, 32, 8, 128, lens, timed=True)
    # G = 16 (KV 2): two head groups of 8 a KV head, at a small size
    g16 = run_decode_check("gqa-g16-small", gen, bf16, 4, 513, 32, 2, 128, [0, 17, 256, 512],
                           timed=True)
    main["decode_attention"]["gqa_kv8"] = {k: gqa.get(k) for k in DECODE_GQA_KEYS}
    main["decode_attention"]["gqa_g16"] = {k: g16.get(k) for k in DECODE_GQA_KEYS}
    f32_row = run_decode_check("llama7b-f32", gen, f32, R, S1, 32, 32, 128, lens, timed=True)
    main["decode_attention"]["f32"] = {k: f32_row.get(k) for k in DECODE_GQA_KEYS}
    run_decode_check("llama7b-mqa", gen, bf16, R, S1, 32, 1, 128, lens, timed=False)
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
                     mixed, timed=True)
    run_verify_check("llama160m-tree-c16", gen, bf16, R, S1, 12, 12, 64,
                     _tree_mask(rng, R, 16, S1), timed=False)
    # SpecInfer's tree steps of the dense spec arms (slice 12): the draft's
    # C = W = 2 and 3 and the (2, 3) verify's C = 7, on "rows8"
    for kind, C in (("draft", 2), ("draft", 3), ("verify", 7)):
        tree = _tree_positions(rng, kind, R, C, sc.cache_len, sc.page_size)[2]
        run_verify_check(f"llama7b-spec-{kind}-c{C}", gen, bf16, R, S1, 32, 32, 128,
                         torch.from_numpy(tree).to(DEV), timed=True)
    # SpecInfer's widest tree (ServingConfig.max_spec_tree_tokens)
    run_verify_check("llama7b-tree-c64", gen, bf16, R, S1, 32, 32, 128,
                     _tree_mask(rng, R, sc.max_spec_tree_tokens, S1), timed=True)
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


def _paged_case(gen, rng, dtype, quant, KV, kind, cfg=None):
    """Inputs of one paged attention call at the widths of ``cfg`` (heads
    and head dim; LLaMA-7B's when None): q, pools (q's dtype, or int8/int4
    codes quantized from random lines at per-page amax scales), the
    shuffled page table (slots' unused logical pages on the scratch page
    P), the causal paged mask, and the model's RoPE tables (``rope``: the
    rotary width of ``cfg``)."""
    sc = ServingConfig()
    if cfg is None:
        cfg = llama.LLaMAConfig.llama_7b()
        rope = functools.partial(llama.rope_freqs, cfg)
    else:
        rope = functools.partial(TD.rope_freqs, cfg)
    R, H, dk = sc.max_requests_per_batch, cfg.num_attention_heads, cfg.head_dim
    ps, NP = sc.page_size, sc.pages_per_slot
    tree, spec = None, re.fullmatch(r"(verify|draft)(\d+)", kind)
    if spec:  # a SpecInfer tree step, "verify7" or "draft2"
        C = int(spec.group(2))
        pos, cpos, tree = _tree_positions(rng, spec.group(1), R, C, sc.cache_len, ps)
    else:
        C = 1 if kind == "decode" else sc.prefill_chunk
        pos = cpos = _paged_positions(rng, kind, R, C, sc.cache_len, ps)
    P = R * NP
    held = np.where(cpos < sc.cache_len, cpos + 1, 0).max(axis=1)
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
    tree = None if tree is None else torch.from_numpy(tree).to(DEV)
    return dict(q=_rand((R, C, H, dk), dtype, gen), kp=kp, vp=vp, ks=ks, vs=vs,
                table=torch.from_numpy(table.astype(np.int32)).to(DEV), pos=post,
                cpos=torch.from_numpy(cpos).to(DEV),
                mask=K.paged_serve_mask(tree, post, NP, ps, sc.cache_len),
                R=R, C=C, H=H, KV=KV, dk=dk, ps=ps, NP=NP, P=P,
                cache_len=sc.cache_len, rope=rope)


def _paged_bound(case, q_dtype, extra_bytes=0):
    """Least time for the paged attention call: the K and V bytes it must
    read (plus their pages' scales), table, mask and q/out bytes over the
    HBM rate, or 4 * pairs * H * dk FLOP over the rate of the unit that
    runs them: bf16 q the bf16 tensor cores; f32 q the TF32 tensor cores,
    three TF32 products for each f32 one (two on quantized pools). The K/V
    bytes: at C * G <= DECODE_ROWS (the decode design, which loads a line
    only where a row's mask bit is set) the distinct physical lines the
    mask attends; above, the distinct physical pages it opens, whole (the
    tiles' unit). Either way the scratch page, which many slots reach
    through their unallocated entries, counts once. Returns the bound,
    what bounds it and, for f32 q, the operations' time on the f32 CUDA
    cores (67 TFLOP/s)."""
    kp, mask, table, ps = case["kp"], case["mask"], case["table"], case["ps"]
    R, C, NP = case["R"], case["C"], case["NP"]
    line_bytes = kp.shape[2] * kp.shape[3] * kp.element_size()
    if C * (case["H"] // case["KV"]) <= K.DECODE_ROWS:
        read = mask.any(dim=1)  # (R, NP * ps): lines some row of the slot attends
        phys = (table.long().repeat_interleave(ps, dim=1) * ps
                + torch.arange(NP * ps, device=table.device) % ps)
        lines = phys[read].unique()
        n_lines, pages = int(lines.numel()), int((lines // ps).unique().numel())
    else:
        opened = mask.reshape(R, C, NP, ps).any(dim=3).any(dim=1)  # (R, NP)
        pages = int(table[opened].unique().numel())
        n_lines = pages * ps
    nbytes = 2 * n_lines * line_bytes + table.numel() * 4 + mask.numel()
    nbytes += 2 * case["q"].numel() * case["q"].element_size() + extra_bytes
    if case["ks"] is not None:
        nbytes += 2 * pages * kp.shape[2] * 4
    flops = 4 * int(mask.sum()) * case["H"] * case["dk"]
    t_b = nbytes / HBM_BYTES_PER_S
    cuda_core_ms = None
    if q_dtype == torch.float32:
        t_f = (2 if case["ks"] is not None else 3) * flops / TF32_FLOPS
        cuda_core_ms = max(t_b, flops / PEAK_FLOPS[torch.float32]) * 1e3
    else:
        t_f = flops / PEAK_FLOPS[q_dtype]
    return max(t_b, t_f) * 1e3, ("bytes" if t_b >= t_f else "operations"), cuda_core_ms


def _paged_library_ms(case, q, quant):
    """SDPA over the virtual cache gathered beforehand (the gather is not
    timed): its cuda_ms and graph_ms; None for quantized pools, which no
    single PyTorch call attends."""
    if quant is not None:
        return None, None
    kv = K.gather_pages(case["kp"], case["table"])
    vv = K.gather_pages(case["vp"], case["table"])
    sq, sk, svv, smask = _sdpa_inputs(q, kv, vv, case["mask"])

    def sdpa():
        return torch.nn.functional.scaled_dot_product_attention(sq, sk, svv, attn_mask=smask)
    ms = cuda_ms(sdpa), graph_ms(sdpa)
    del kv, vv, sq, sk, svv, smask
    return ms


def _paged_row(kernel, label, case, dtype, quant, err):
    row = {"phase": "kernels", "kernel": kernel, "case": label,
           "dtype": str(dtype).replace("torch.", ""), "pool": quant or str(dtype).replace("torch.", ""),
           "shape": {k: case[k] for k in ("R", "C", "H", "KV", "dk", "ps", "NP", "P")},
           "attended_pairs": int(case["mask"].sum()), "max_abs_err": err,
           "tol": TOL[dtype]}
    if case["C"] * (case["H"] // case["KV"]) <= K.DECODE_ROWS:
        # the decode design's grid: (splits, KV heads, slots) blocks
        pages, n = K.paged_decode_split(case["R"], case["C"], case["KV"], case["NP"], case["ps"])
        row.update(split_pages=pages, splits=n, blocks=case["R"] * case["KV"] * n)
    return row


def _design_of(kernel, call):
    """``call()`` once; the block design the wrapper counted for it."""
    before = dict(K.DESIGN_LAUNCHES)
    out = call()
    took = [k for k, v in K.DESIGN_LAUNCHES.items() if v != before[k]]
    check(len(took) == 1 and took[0].startswith(kernel + "["),
          f"{kernel}: one launch counted no single design: {took}")
    return out, took[0][len(kernel) + 1:-1]


def _vs_library(row):
    return row["ms"] / row["library_ms"] if row.get("library_ms") else None


def _paged_f64(q, kp, vp, ks, vs, table, mask):
    """``ragged_paged_attention_ref``'s attention recomputed in f64 (codes
    times their page's scale); a row with nothing to attend gives 0."""
    R, C, H, dk = q.shape
    ps, KV = kp.shape[1], kp.shape[2]
    pack = K.pool_pack(kp) if ks is not None else 1
    k, v = (K.unpack_codes(K.gather_pages(x, table), pack).double() for x in (kp, vp))
    if ks is not None:
        for x, sc in ((k, ks), (v, vs)):
            x *= sc[table.long()].repeat_interleave(ps, dim=1).double()[..., None]
    qg = q.double().reshape(R, C, KV, H // KV, dk)
    s = torch.einsum("rckgd,rskd->rkgcs", qg, k) / math.sqrt(dk)
    p = torch.softmax(s.masked_fill(~mask[:, None, None], -math.inf), dim=-1).nan_to_num(0.0)
    return torch.einsum("rkgcs,rskd->rkgcd", p, v).permute(0, 3, 1, 2, 4).reshape(R, C, H, dk)


def run_ragged_check(label, case, dtype, quant, timed=True):
    q, kp, vp, ks, vs, table = (case[k] for k in ("q", "kp", "vp", "ks", "vs", "table"))
    mask = case["mask"].clone()
    mask[case["R"] - 1, 0] = False  # a row with nothing to attend
    out, design = _design_of("ragged_paged_attention", lambda: K.ragged_paged_attention(
        q, kp, vp, table, mask, k_scale=ks, v_scale=vs))
    torch.cuda.synchronize()
    ref = K.ragged_paged_attention_ref(q, kp, vp, table, mask, k_scale=ks, v_scale=vs)
    err = _compare(f"ragged_paged_attention[{label}]", out, ref, dtype)
    check(bool((out[case["R"] - 1, 0] == 0).all()), "ragged: empty row not zero")
    row = _paged_row("ragged_paged_attention", label, case, dtype, quant, err)
    row["design"] = design
    if dtype == torch.float32:
        # both f32 results against f64: how much of their distance is the
        # plain version's own (its cuBLAS sums run the whole walk in f32)
        exact = _paged_f64(q, kp, vp, ks, vs, table, mask)
        row["err_vs_f64"] = {name: float((x.double() - exact).abs().max())
                             for name, x in (("kernel", out), ("plain", ref))}
        check(row["err_vs_f64"]["kernel"] <= TOL[dtype]["atol"],
              f"ragged_paged_attention[{label}]: {row['err_vs_f64']['kernel']} from f64")
        del exact
    del ref
    if not timed:
        emit(row)
        return row
    mask = case["mask"]
    row["bound_ms"], row["bound_by"], row["bound_cuda_core_ms"] = _paged_bound(case, dtype)
    row.update(
        ms=cuda_ms(lambda: K.ragged_paged_attention(q, kp, vp, table, mask,
                                                    k_scale=ks, v_scale=vs)),
        graph_ms=graph_ms(lambda: K.ragged_paged_attention(q, kp, vp, table, mask,
                                                           k_scale=ks, v_scale=vs)),
        plain_ms=cuda_ms(lambda: K.ragged_paged_attention_ref(
            q, kp, vp, table, mask, k_scale=ks, v_scale=vs), iters=5),
    )
    row["library_ms"], row["library_graph_ms"] = _paged_library_ms(case, q, quant)
    row["vs_library"] = _vs_library(row)
    # the same launch under a mask that attends nothing: the launch, the
    # mask's bits, the Q loads and the zero outputs, no tile read
    none = torch.zeros_like(mask)
    row["empty_graph_ms"] = graph_ms(lambda: K.ragged_paged_attention(
        q, kp, vp, table, none, k_scale=ks, v_scale=vs))
    emit(row)
    return row


def run_fused_check(label, case, dtype, quant, timed=True):
    """The fused kernel against the port's unfused composition on the card
    (RoPE, then the scatter or quant_line_write, then the ragged kernel):
    non-scratch pool bytes and scales bit for bit, and the outputs of rows
    that never read the scratch page bit for bit and within the kernel
    tolerance of the plain version. ``commit_ms`` times the launch under a
    mask that attends nothing: RoPE and the commit, no tile read."""
    R, C, KV, dk, ps, P = (case[k] for k in ("R", "C", "KV", "dk", "ps", "P"))
    q, table, mask, pos = case["q"], case["table"], case["mask"], case["pos"]
    gen = torch.Generator(device=DEV)
    gen.manual_seed(R * C + KV)
    k_new = _rand((R, C, KV, dk), dtype, gen)
    v_new = _rand((R, C, KV, dk), dtype, gen)
    cos, sin = case["rope"](pos)  # (R, C, rotary width) f32
    lines = case["cpos"]  # a tree step's lines are not its positions
    logical = (lines // ps).to(torch.int32)
    off = (lines % ps).to(torch.int32)
    qmax = None if quant is None else KQ.SPECS[quant].qmax

    def pools():
        return [None if case[k] is None else case[k].clone() for k in ("kp", "vp", "ks", "vs")]

    a, b = pools(), pools()
    out, design = _design_of("fused_rope_paged_attention", lambda: K.fused_rope_paged_attention(
        q, k_new, v_new, cos, sin, a[0], a[1], table, logical, off, mask, k_scale=a[2],
        v_scale=a[3], qmax=qmax))
    qr, kr = TD.apply_rope(q, cos, sin), TD.apply_rope(k_new, cos, sin)
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
    bitwise = bool(torch.equal(out[live], unfused[live]))
    row.update(design=design, pools_bitwise_vs_unfused=True, live_rows=int(live.sum()),
               out_bitwise_vs_unfused=bitwise)
    check(bitwise, f"fused[{label}]: live-row output differs from the unfused path's")
    del ref, c, unfused
    if not timed:
        emit(row)
        return row
    isz = q.element_size()
    dkp, pisz = case["kp"].shape[3], case["kp"].element_size()
    # inputs read once; the distinct lines written (every padding line
    # lands on the one scratch line)
    written = int((phys * ps + off.long()).unique().numel())
    extra = (2 * k_new.numel() * isz + 2 * cos.numel() * 4 + 2 * R * C * 4
             + 2 * written * KV * dkp * pisz)
    if quant is not None:
        # scale rows of the touched pages, and the old lines that change
        touched = int(phys.unique().numel())
        extra += 2 * touched * KV * 4 + _requant_bytes(
            phys, off.long(), zip((case["ks"], case["vs"]), a[2:]), P, ps, dkp * pisz,
            R * C >= P + 1)[0]
    row["bound_ms"], row["bound_by"], row["bound_cuda_core_ms"] = _paged_bound(case, dtype, extra)
    row.update(
        ms=cuda_ms(lambda: K.fused_rope_paged_attention(
            q, k_new, v_new, cos, sin, a[0], a[1], table, logical, off, mask,
            k_scale=a[2], v_scale=a[3], qmax=qmax)),
        plain_ms=cuda_ms(lambda: K.fused_rope_paged_attention_ref(
            q, k_new, v_new, cos, sin, b[0], b[1], table, logical, off, mask,
            k_scale=b[2], v_scale=b[3], qmax=qmax), iters=5),
    )
    row["library_ms"], row["library_graph_ms"] = _paged_library_ms(case, qr, quant)
    row["vs_library"] = _vs_library(row)
    none = torch.zeros_like(mask)

    def fused(m):
        return lambda: K.fused_rope_paged_attention(
            q, k_new, v_new, cos, sin, a[0], a[1], table, logical, off, m,
            k_scale=a[2], v_scale=a[3], qmax=qmax)
    row.update(graph_ms=graph_ms(fused(mask)), commit_ms=cuda_ms(fused(none)),
               commit_graph_ms=graph_ms(fused(none)))
    emit(row)
    return row


#: bytes read before each timed commit to evict the pools from L2 (50 MB)
COMMIT_FLUSH_BYTES = 64 << 20
_COMMIT_FLUSH = []


def _commit_restore(dst, start, pages):
    """The restore before each timed commit: the scales, and the pool pages
    the commit can write (``pages``), copied back from ``start``; then
    COMMIT_FLUSH_BYTES read (a read leaves no dirty lines to drain during
    the commit), so that each commit finds its lines and pages in device
    memory, as a layer's commit does."""
    if not _COMMIT_FLUSH:
        _COMMIT_FLUSH.append(torch.ones(COMMIT_FLUSH_BYTES // 4, dtype=torch.int32, device=DEV))
    saved = [start[i].index_select(0, pages) for i in (0, 1)]

    def run():
        for i in (0, 1):
            dst[i].index_copy_(0, pages, saved[i])
            dst[2 + i].copy_(start[2 + i])
        _COMMIT_FLUSH[0].amax()
    return run


def _serial_commit(pools, k, v, phys32, off32, qmax):
    """The commit's first design (SERIAL_COMMIT_SRC, built by
    phase_build), one launch for K and V, with int32 phys and off: the
    yardstick of the commit rows, never launched by a serving path."""
    R, C, KV, dk = k.shape
    kp = pools[0]
    lib = _SERIAL_COMMIT["lib"]
    err = lib.paged_commit_serial_launch(
        *[t.data_ptr() for t in (k, v, *pools, phys32, off32)],
        R, C, KV, dk, kp.shape[1], kp.shape[0], K._dtype_code(k.dtype),
        1 if kp.dtype == torch.int8 else 2, int(R * C >= kp.shape[0]), qmax,
        torch.cuda.current_stream(k.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"paged_commit_serial launch failed: CUDA error {err} "
                           f"({lib.error_string(err).decode()})")


def _requant_bytes(phys, off, scales, P, ps, line_bytes, whole_pool):
    """The bytes that quant_line_write must move for the codes already in
    the pools, K and V: in each (page, KV head) whose codes change, the
    lines that no new line overwrites, written alone where the ratio is 0
    (the page reset by a line at offset 0, or its old scale 0; in the
    whole-pool branch also an untouched page of scale 0) and read and
    written where the scale grew. Lines on the scratch page (page P) are
    not committed and not counted. ``scales``: (old, new) of K's and of
    V's (P + 1, KV) scales. Returns the bytes and the counts of (page, KV
    head, K or V) written alone and read and written."""
    on = phys != P
    lines = (phys[on] * ps + off[on]).unique()
    kept = ps - torch.bincount(lines // ps, minlength=P + 1)[:P, None]
    touched = torch.zeros(P + 1, dtype=torch.bool, device=phys.device)
    touched[phys[on]] = True
    reset = torch.zeros_like(touched)
    reset[phys[on & (off == 0)]] = True
    touched, reset = touched[:P, None], reset[:P, None]
    zeroed = grown = nbytes = 0
    for old, new in scales:
        old, new = old[:P], new[:P]
        z = (touched & (reset | (old == 0))) | (~touched & (old == 0) & whole_pool)
        g = touched & ~z & (new != old)
        zeroed, grown = zeroed + int(z.sum()), grown + int(g.sum())
        nbytes += int((z * kept).sum() + 2 * (g * kept).sum()) * line_bytes
    return nbytes, zeroed, grown


def run_commit_check(label, case, dtype, quant, live=None, spread=False):
    """The commit kernel (``K.commit_paged`` on CUDA tensors) against its
    plain version, quant_line_write on K and on V, at the paged slice's
    shapes: pools and scales of every page but the scratch page bitwise
    equal, one launch a call; the first design (``_serial_commit``, under
    ``serial``) the same. ``live``: only the first ``live`` slots' lines
    commit (the others' on the scratch page, as idle slots'); ``spread``:
    each slot's lines in a random order, so a page's lines are neither
    contiguous nor sorted. ``ms`` times a call by CUDA events,
    ``graph_ms`` the device's time of one: a CUDA graph of 20 restore-and-
    commit pairs less a graph of 20 restores (``_commit_restore``); the
    plain version by events alone. Bound: the lines off the scratch page
    read and their code bytes written, phys and off read, the touched
    pages' scales read and written, and the old lines that change
    (:func:`_requant_bytes`); ``bound_all_lines_ms`` is PR 7's count:
    every line, padding lines too, and every (page, KV head) whose scale
    moved read and written whole."""
    R, C, KV, dk, ps, P = (case[k] for k in ("R", "C", "KV", "dk", "ps", "P"))
    table, lines = case["table"], case["cpos"]  # the lines the step writes
    gen = torch.Generator(device=DEV)
    gen.manual_seed(R * C + KV + 1)
    k_new, v_new = _rand((R, C, KV, dk), dtype, gen), _rand((R, C, KV, dk), dtype, gen)
    phys = table.long().gather(1, (lines // ps).long())
    off = lines % ps
    if live is not None:
        phys[live:] = P
    if spread:
        order = torch.argsort(torch.rand((R, C), generator=gen, device=DEV), dim=1)
        phys, off = phys.gather(1, order), off.gather(1, order)
    qmax = KQ.SPECS[quant].qmax
    start = [case[k] for k in ("kp", "vp", "ks", "vs")]
    a, b, c = ([t.clone() for t in start] for _ in range(3))
    before = K.LAUNCHES[f"paged_commit[{quant}]"]
    K.commit_paged(a[0], a[1], k_new, v_new, phys, off, a[2], a[3], qmax)
    torch.cuda.synchronize()
    check(K.LAUNCHES[f"paged_commit[{quant}]"] == before + 1,
          f"paged_commit[{label}]: not one launch")
    K.commit_paged(b[0], b[1], k_new, v_new, phys, off, b[2], b[3], qmax, kernels="torch")
    phys32, off32 = phys.int(), off.int()
    _serial_commit(c, k_new, v_new, phys32, off32, qmax)
    torch.cuda.synchronize()
    bitwise = all(bool(torch.equal(x[:P], y[:P])) for x, y in zip(a, b))
    check(bitwise, f"paged_commit[{label}]: non-scratch pools or scales differ from "
                   "quant_line_write")
    serial_bitwise = all(bool(torch.equal(x[:P], y[:P])) for x, y in zip(c, b))
    check(serial_bitwise, f"paged_commit_serial[{label}]: differs from quant_line_write")
    dkp, pisz, isz = start[0].shape[3], start[0].element_size(), k_new.element_size()
    on = phys != P
    n_live = int(on.sum())
    written = int((phys[on] * ps + off[on]).unique().numel())
    touched = phys[on].unique()
    old_lines, zeroed, grown = _requant_bytes(phys, off, zip(start[2:], a[2:]), P, ps,
                                              dkp * pisz, R * C >= P + 1)
    nbytes = (2 * n_live * KV * dk * isz + 2 * R * C * 8 + 2 * written * KV * dkp * pisz
              + 2 * 2 * int(touched.numel()) * KV * 4 + old_lines)
    moved = sum(int((x[:P] != y[:P]).sum()) for x, y in zip(a[2:], start[2:]))
    all_lines = (2 * k_new.numel() * isz + 2 * R * C * 8
                 + 2 * int((phys * ps + off).unique().numel()) * KV * dkp * pisz
                 + 2 * 2 * int(phys.unique().numel()) * KV * 4
                 + 2 * moved * ps * dkp * pisz)
    # the pages a commit can write: those its lines touch and (whole-pool
    # branch) those with a zero scale
    zero = ((start[2] == 0) | (start[3] == 0)).any(dim=1).nonzero().flatten()
    pages = torch.cat([phys.flatten(), zero]).unique()

    def kernel(dst):
        return lambda: K.commit_paged(dst[0], dst[1], k_new, v_new, phys, off, dst[2], dst[3],
                                      qmax)

    def serial(dst):
        return lambda: _serial_commit(dst, k_new, v_new, phys32, off32, qmax)

    def graph_pairs_ms(fn, restore):
        return graph_ms(lambda: (restore(), fn())) - graph_ms(restore)

    ra, rc = _commit_restore(a, start, pages), _commit_restore(c, start, pages)
    row = {"phase": "kernels", "kernel": f"paged_commit[{quant}]", "case": label,
           "dtype": str(dtype).replace("torch.", ""), "pool": quant,
           "shape": {k: case[k] for k in ("R", "C", "KV", "dk", "ps", "P")},
           "branch": "per-line" if R * C < P + 1 else "whole-pool",
           "design": _cuda.design("paged_commit", C),
           "live_lines": n_live, "spread": spread,
           "bitwise": bitwise, "max_abs_err": 0.0,
           "pages_requantized": {"zeroed": zeroed, "grown": grown},
           "ms": cuda_ms_restored(kernel(a), ra),
           "plain_ms": cuda_ms_restored(lambda: K.commit_paged(
               b[0], b[1], k_new, v_new, phys, off, b[2], b[3], qmax, kernels="torch"),
               _commit_restore(b, start, pages), iters=5),
           "library_ms": None, "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
           "bound_by": "bytes", "bound_all_lines_ms": all_lines / HBM_BYTES_PER_S * 1e3}
    # graphs in turns on one card: kernel, first design, first design, kernel
    row["graph_ms"] = graph_pairs_ms(kernel(a), ra)
    row["serial"] = {"bitwise": serial_bitwise, "ms": cuda_ms_restored(serial(c), rc),
                     "graph_ms": graph_pairs_ms(serial(c), rc),
                     "graph_ms_again": graph_pairs_ms(serial(c), rc)}
    row["graph_ms_again"] = graph_pairs_ms(kernel(a), ra)
    emit(row)
    return row


#: the commit rows' extra cases (on the int8 and int4 decode and C = 128
#: cases): 8 live slots of 16, and a mixed step's lines spread
COMMIT_VARIANTS = {"decode": (("8-live", dict(live=8)),),
                   "mixed": (("spread", dict(spread=True)),)}
COMMIT_CASE_KEYS = ("design", "branch", "live_lines", "ms", "graph_ms", "graph_ms_again",
                    "plain_ms", "bound_ms", "bound_all_lines_ms", "pages_requantized", "serial")


# (label, q dtype, pool quantization, KV heads, step kind, timed); the
# untimed case holds the f32 tile's two-product arm (codes exact in TF32)
# to the f32 tolerance
PAGED_CASES = (
    ("bf16-decode", torch.bfloat16, None, 32, "decode", True),
    ("bf16-mixed-c128", torch.bfloat16, None, 32, "mixed", True),
    ("int8-decode", torch.bfloat16, "int8", 32, "decode", True),
    ("int8-mixed-c128", torch.bfloat16, "int8", 32, "mixed", True),
    ("int4-decode", torch.bfloat16, "int4", 32, "decode", True),
    ("int4-mixed-c128", torch.bfloat16, "int4", 32, "mixed", True),
    ("f32-decode", torch.float32, None, 32, "decode", True),
    ("f32-mixed-c128", torch.float32, None, 32, "mixed", True),
    ("bf16-gqa-decode", torch.bfloat16, None, 8, "decode", True),
    ("bf16-gqa-mixed-c128", torch.bfloat16, None, 8, "mixed", True),
    ("f32-int8-mixed-c128", torch.float32, "int8", 32, "mixed", False),
    # SpecInfer's tree steps (slice 12's spec arms: the fused kernel on bf16
    # pages, the ragged one on int8): verify at C = 7 and the draft at C =
    # 2, each on the one-split walk of the decode design
    ("bf16-tree-verify-c7", torch.bfloat16, None, 32, "verify7", True),
    ("bf16-tree-draft-c2", torch.bfloat16, None, 32, "draft2", True),
    ("int8-tree-verify-c7", torch.bfloat16, "int8", 32, "verify7", True),
    ("int8-tree-draft-c2", torch.bfloat16, "int8", 32, "draft2", True),
)


# what the bf16 decode rows of the kernels line carry of the GQA (KV 8)
# decode case, which no serving arm runs
GQA_KEYS = ("max_abs_err", "ms", "graph_ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "library_graph_ms", "split_pages", "splits", "blocks")


def phase_paged_kernels(seed):
    """Both paged kernels against their plain versions in every pool
    type, and the commit kernel in the quantized ones; the rows of the
    kernels line are the mixed C = 128 cases (``name[pool]``) and the
    decode cases (``name[pool/decode]``, with the GQA case's numbers on
    the bf16 row)."""
    gen = torch.Generator(device=DEV)
    gen.manual_seed(seed + 2)
    rng = np.random.default_rng(seed + 2)
    main, commits = {}, {}
    for label, dtype, quant, KV, kind, timed in PAGED_CASES:
        case = _paged_case(gen, rng, dtype, quant, KV, kind)
        ragged = run_ragged_check(label, case, dtype, quant, timed)
        fused = run_fused_check(label, case, dtype, quant, timed)
        want = ("decode" if case["C"] * (case["H"] // case["KV"]) <= K.DECODE_ROWS
                else "mma" if dtype == torch.bfloat16 else "tf32x3")
        check(ragged["design"] == fused["design"] == want,
              f"paged[{label}]: designs {ragged['design']}, {fused['design']}, want {want}")
        commit = run_commit_check(label, case, dtype, quant) if quant and timed else None
        if commit:
            commits.setdefault(quant, {})[label] = commit
            for name, kw in COMMIT_VARIANTS.get(kind, ()):
                commits[quant][f"{label}-{name}"] = run_commit_check(
                    f"{label}-{name}", case, dtype, quant, **kw)
        pool = quant or ("bf16" if dtype == torch.bfloat16 else "f32")
        if kind == "mixed" and "gqa" not in label and timed:
            main[f"ragged_paged_attention[{pool}]"] = ragged
            main[f"fused_rope_paged_attention[{pool}]"] = fused
            if commit:
                main[f"paged_commit[{quant}]"] = commit
        elif kind == "decode" and timed:
            for name, row in (("ragged_paged_attention", ragged),
                              ("fused_rope_paged_attention", fused)):
                if "gqa" in label:  # no serving arm: beside the bf16 decode row
                    main[f"{name}[bf16/decode]"]["gqa_kv8"] = {k: row.get(k) for k in GQA_KEYS}
                else:
                    main[f"{name}[{pool}/decode]"] = row
        del case
        gc.collect()
        torch.cuda.empty_cache()
    for quant, rows in commits.items():  # the commit row's every case
        main[f"paged_commit[{quant}]"]["cases"] = {
            label: {k: row.get(k) for k in COMMIT_CASE_KEYS} for label, row in rows.items()}
    return main


# the paged kernels at the other families' shapes: head dims 80
# (Phi-2: 32 heads, RoPE over the first 32 of each 80) and 256 (Gemma-7B: 16
# heads) on every pool type at C = 128 and at decode, and Falcon-7B's MQA
# decode on every pool type (71 query heads on one KV head: past the decode
# design's 8 rows, one 128-row block of the tensor-core tile, 57 rows idle).
# (group, label, model config, q dtype, pool quantization, step kind); each
# group is a row of the kernels line (``name[group]``, its main numbers the
# first case's, every case's under ``cases``)
FAMILY_POOLS = (("bf16", torch.bfloat16, None), ("f32", torch.float32, None),
                ("int8", torch.bfloat16, "int8"), ("int4", torch.bfloat16, "int4"))
FAMILY_KERNEL_CASES = tuple(
    (group, f"{group}-{pool}-{kind}", cfg_fn, dtype, quant, kind)
    for group, cfg_fn, kinds in (("dk80", phi.phi_2, ("mixed", "decode")),
                                 ("dk256", gemma.gemma_7b, ("mixed", "decode")),
                                 ("mqa-g71", falcon.falcon_7b, ("decode",)))
    for pool, dtype, quant in FAMILY_POOLS for kind in kinds)
# what a row keeps of each of its cases
CASE_KEYS = ("design", "max_abs_err", "ms", "graph_ms", "plain_ms", "bound_ms", "bound_by",
             "library_ms", "library_graph_ms", "splits", "blocks")


def phase_family_kernels(seed):
    """Both paged kernels (and the commit kernel on quantized pools)
    against their plain versions at FAMILY_KERNEL_CASES, as
    phase_paged_kernels holds them at LLaMA-7B's; returns the kernels
    line's rows ``name[group]``."""
    gen = torch.Generator(device=DEV)
    gen.manual_seed(seed + 15)
    rng = np.random.default_rng(seed + 15)
    main = {}
    for group, label, cfg_fn, dtype, quant, kind in FAMILY_KERNEL_CASES:
        cfg = cfg_fn()
        case = _paged_case(gen, rng, dtype, quant, cfg.num_key_value_heads, kind, cfg)
        rows = {"ragged_paged_attention": run_ragged_check(label, case, dtype, quant),
                "fused_rope_paged_attention": run_fused_check(label, case, dtype, quant)}
        want = ("decode" if case["C"] * (case["H"] // case["KV"]) <= K.DECODE_ROWS
                else "mma" if dtype == torch.bfloat16 else "tf32x3")
        check(all(r["design"] == want for r in rows.values()),
              f"paged[{label}]: designs {[r['design'] for r in rows.values()]}, want {want}")
        if quant and group.startswith("dk"):  # the commit kernel's new head dims
            rows["paged_commit"] = run_commit_check(label, case, dtype, quant)
        for name, row in rows.items():
            key = f"{name}[{group}]"
            if key not in main:  # the group's first case gives the row's numbers
                main[key] = dict(row, cases={})
            main[key]["cases"][label[len(group) + 1:]] = {k: row.get(k) for k in CASE_KEYS
                                                          if k in row}
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
# the speculation fold (slice 13): SpecInfer's tree steps through the same
# kernel at 2 layers: verify at C = 7 ((2, 3): the split walk at G = 1) and
# C = 25 ((3, 8): the tensor-core tile), and the early-exit draft's last
# depth at C = W = 2, 3 over the first layer (num_layers 1); every pool
# type and GQA. (label, dtype, pool, KV, kind, C, num_layers)
WHOLE_FOLD_CASES = (
    ("bf16-verify-c7", torch.bfloat16, None, 32, "verify", 7, None),
    ("bf16-verify-c25", torch.bfloat16, None, 32, "verify", 25, None),
    ("bf16-draft-c2", torch.bfloat16, None, 32, "draft", 2, 1),
    ("bf16-draft-c3", torch.bfloat16, None, 32, "draft", 3, 1),
    ("f32-verify-c7", torch.float32, None, 32, "verify", 7, None),
    ("f32-verify-c25", torch.float32, None, 32, "verify", 25, None),
    ("f32-draft-c3", torch.float32, None, 32, "draft", 3, 1),
    ("int8-verify-c7", torch.bfloat16, "int8", 32, "verify", 7, None),
    ("int8-verify-c25", torch.bfloat16, "int8", 32, "verify", 25, None),
    ("int8-draft-c2", torch.bfloat16, "int8", 32, "draft", 2, 1),
    ("int4-verify-c7", torch.bfloat16, "int4", 32, "verify", 7, None),
    ("int4-verify-c25", torch.bfloat16, "int4", 32, "verify", 25, None),
    ("int4-draft-c3", torch.bfloat16, "int4", 32, "draft", 3, 1),
    ("bf16-gqa-verify-c7", torch.bfloat16, None, 8, "verify", 7, None),
    ("bf16-gqa-draft-c2", torch.bfloat16, None, 8, "draft", 2, 1),
)
# the generic decoder's bodies on the same kernel (slice 16), at published
# widths cut to 2 layers: Falcon-7B (MQA at G = 71, a parallel block on
# one LayerNorm, GELU, an untied head), Phi-2 (head dim 80, RoPE over 32
# of its dims, every bias, an untied biased head, gelu_tanh), Gemma-7B
# (head dim 256, RMS by 1 + w, GeGLU-tanh, H * dk 4096 against D 3072, V
# 256000) and GPT-2 XL (learned positions, no RoPE, V 50257 on a tied
# head); Phi-2 and Gemma on every pool type. (label, family module, preset,
# model dtype, pool quantization, step kind); a row of the kernels line
# each family, its bf16 decode case
WHOLE_GENERIC_CASES = (
    ("falcon-7b-bf16-decode", falcon, falcon.falcon_7b, torch.bfloat16, None, "decode"),
    ("falcon-7b-bf16-mixed-c128", falcon, falcon.falcon_7b, torch.bfloat16, None, "mixed"),
    *((f"{name}-{pool}-{kind}", family, preset,
       torch.float32 if pool == "f32" else torch.bfloat16,
       pool if pool in ("int8", "int4") else None, kind.split("-")[0])
      for name, family, preset in (("phi-2", phi, phi.phi_2), ("gemma-7b", gemma, gemma.gemma_7b))
      for pool in ("bf16", "int8", "int4", "f32") for kind in ("decode", "mixed-c128")),
    ("gpt2-xl-bf16-decode", gpt2, gpt2.gpt2_xl, torch.bfloat16, None, "decode"),
    ("gpt2-xl-bf16-mixed-c128", gpt2, gpt2.gpt2_xl, torch.bfloat16, None, "mixed"),
)
# the fold on a generic body: Phi-2, a verify at C = 7 and a 1-layer
# early-exit draft at C = 3 (label, family, preset, kind, C, num_layers)
WHOLE_GENERIC_FOLD_CASES = (
    ("phi-2-bf16-verify-c7", phi, phi.phi_2, "verify", 7, None),
    ("phi-2-bf16-draft-c3", phi, phi.phi_2, "draft", 3, 1),
)
# the kernels line's rows of the generic body: each family's bf16 decode
# case, with the launches of its families-phase whole-step arms
WHOLE_GENERIC_ROWS = ("falcon-7b", "phi-2", "gemma-7b", "gpt2-xl")
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


def _tree_positions(rng, kind, R, C, cache_len, ps):
    """A SpecInfer tree step over R slots: each live slot holds a random
    tree of 1 + W D nodes (W = 2 for C of 2 or 7, else 3; D = 3, or 8 at
    C = 25), node i at cache line prefix + i and RoPE position prefix +
    its depth, with prefixes of at most 1,023 lines (the spec phase's
    prompts are 16-1,000 tokens), half of them putting the tree across a
    page boundary. A verify step feeds every node; a draft step the W
    nodes of the last depth, and in slot 3 only its first (the others are
    padding, as the draft's first depth pads). Every eighth slot is idle.
    Returns
    (positions, cache lines, mask (R, C, cache_len + 1)): a node attends
    the committed prefix and its ancestors-or-self, which are no prefix."""
    W = 2 if C in (2, 7) else 3
    D = 8 if C == 25 else 3
    T = 1 + W * D
    pos = np.full((R, C), cache_len, np.int64)
    cpos = np.full((R, C), cache_len, np.int64)
    mask = np.zeros((R, C, cache_len + 1), bool)
    top = (cache_len // ps) * ps
    for r in range(R):
        if r % 8 == 7:
            continue
        prefix = ((r % 8 + 1) * ps - 1 - r % 3 if r % 2
                  else int(rng.integers(0, min(top - T, 1000))))
        parent = [-1] + [0 if i <= W else 1 + ((i - 1) // W - 1) * W + int(rng.integers(0, W))
                         for i in range(1, T)]
        depth = [0] + [(i - 1) // W + 1 for i in range(1, T)]
        nodes = list(range(T)) if kind == "verify" else list(range(T - W, T))
        if kind == "draft" and r == 3:
            nodes = nodes[:1]
        for c, i in enumerate(nodes):
            pos[r, c] = prefix + depth[i]
            cpos[r, c] = prefix + i
            mask[r, c, :prefix] = True
            while i >= 0:
                mask[r, c, prefix + i] = True
                i = parent[i]
    return pos, cpos, mask


def _draw_vectors(params, gen):
    """A generic decoder's norm scales at 1 + 0.2 N(0, 1) and biases at
    0.2 N(0, 1), in place: their initial ones and zeros would leave a
    wrong offset unseen."""
    for tree in (params["layers"], params):
        for name, t in tree.items():
            if isinstance(t, dict) or name in ("embed", "pos_embed", "lm_head"):
                continue
            if "norm" in name or name.startswith("b") or name.endswith("_bias"):
                noise = 0.2 * torch.randn(t.shape, generator=gen, device=t.device)
                t.copy_((noise + (1.0 if name.endswith("_scale") else 0.0)).to(t.dtype))


def _whole_case(gen, rng, dtype, quant, KV, kind, C=None, num_layers=None, family=None):
    """Inputs of one whole-step call: random weights, a paged cache whose
    every page holds random lines (int8/int4 codes at per-page amax
    scales), the paged slice's shuffled table and the step's tokens,
    positions and logits_idx (decode: DECODE_LENS; mixed: prefill chunks,
    decode rows and idle slots; "verify" and "draft": a SpecInfer tree
    step of C columns, :func:`_tree_positions`, through the first
    ``num_layers`` layers). LLaMA-7B with KV heads by default; ``family``
    (module, preset) a generic decoder at its published width (its KV
    heads), its norms and biases drawn (:func:`_draw_vectors`)."""
    sc = ServingConfig()
    if family is None:
        model = llama
        cfg = llama.LLaMAConfig.llama_7b(num_hidden_layers=WHOLE_CHECK_LAYERS,
                                         num_key_value_heads=KV, dtype=dtype)
    else:
        model, preset = family
        cfg = preset(num_hidden_layers=WHOLE_CHECK_LAYERS, dtype=dtype)
        KV = cfg.num_key_value_heads
    R, ps, NP = sc.max_requests_per_batch, sc.page_size, sc.pages_per_slot
    L, dk = cfg.num_hidden_layers, cfg.head_dim
    tree = kind in ("verify", "draft")
    if not tree:
        C = 1 if kind == "decode" else sc.prefill_chunk
    P = R * NP
    params = model.init_params(gen, cfg, device=DEV)
    if family is not None:
        _draw_vectors(params, gen)
    mask = None
    if tree:
        pos, cpos, mask = _tree_positions(rng, kind, R, C, sc.cache_len, ps)
    else:
        pos = cpos = _paged_positions(rng, kind, R, C, sc.cache_len, ps)
    held = np.where(cpos < sc.cache_len, cpos + 1, 0).max(axis=1)
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
    return dict(model=model, cfg=cfg, params=params, cache=cache, tokens=toks,
                pos=torch.from_numpy(pos).to(DEV), li=torch.from_numpy(li).to(DEV),
                table=torch.from_numpy(table.astype(np.int32)).to(DEV), quant=quant,
                R=R, C=C, ps=ps, NP=NP, P=P, cache_len=sc.cache_len,
                cpos=torch.from_numpy(cpos).to(DEV),
                mask=None if mask is None else torch.from_numpy(mask).to(DEV),
                num_layers=num_layers if tree else None, fold=tree)


def _fold_kw(case):
    """The speculation fold's keywords of a tree case (none otherwise)."""
    if not case["fold"]:
        return {}
    return dict(mask=case["mask"], cache_positions=case["cpos"], all_logits=True,
                num_layers=case["num_layers"])


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
    mask's pairs. A fold case counts its tree mask, its layers
    (``num_layers``) and a head over every live row; the f32 logits are
    written once."""
    cfg, p, cache = case["cfg"], case["params"], case["cache"]
    L, D, V = cfg.num_hidden_layers, cfg.hidden_size, cfg.vocab_size
    L = case["num_layers"] or L
    H, dk = cfg.num_attention_heads, cfg.head_dim
    R, ps, NP = case["R"], case["ps"], case["NP"]
    isz = p["embed"].element_size()
    layer_params = sum(w[0].numel() for w in p["layers"].values())
    proj_params = sum(p["layers"][w][0].numel()
                      for w, _ in case["model"].whole_step_tile_roles(cfg).values())
    mask = K.paged_serve_mask(case["mask"], case["pos"], NP, ps, case["cache_len"])
    opened = mask.reshape(R, -1, NP, ps).any(dim=3).any(dim=1)
    pages = int(case["table"][opened].unique().numel())
    rows = int((case["cpos"] < case["cache_len"]).sum())
    slots = (rows if case["fold"] else
             int((case["pos"].gather(1, case["li"][:, None]) < case["cache_len"]).sum()))
    kp = cache["k"]
    page_bytes = ps * kp.shape[3] * kp.shape[4] * kp.element_size()
    nbytes = isz * (L * layer_params + D * V + D) + 2 * L * pages * page_bytes
    nbytes += 2 * L * rows * kp.shape[3] * kp.shape[4] * kp.element_size() + 4 * slots * V
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
    kernel) on the same inputs, pools restored before each run.
    A fold case (SpecInfer's tree steps) runs the same checks at every
    live row of the step (every row's logits and argmax), its layers
    ``num_layers``, the deeper layers' pools untouched; its design is
    counted as ``<design>-tree``."""
    model, cfg, params, cache = case["model"], case["cfg"], case["params"], case["cache"]
    quant, P, dtype = case["quant"], case["P"], cfg.dtype
    step = (case["tokens"], case["pos"], case["li"], case["table"])
    fold = _fold_kw(case)
    kw = dict(cfg=cfg, cache_len=case["cache_len"], kv_quant=quant)
    la, _ = model.whole_step_weight_layout(params, cfg)
    roles = model.whole_step_tile_roles(cfg)
    x0 = torch.empty((case["R"], case["C"], cfg.hidden_size), dtype=dtype, device="meta")
    gate, est = K.whole_step_pick_tiles(la, cache, x0, cfg.num_attention_heads,
                                        tile_roles=roles, budget=K.WHOLE_STEP_SMEM_BUDGET,
                                        all_logits=case["fold"])
    check(gate is not None, f"whole[{label}]: no tile count fits the budget")
    takes = [t for t in K.whole_step_tile_candidates(la, roles)
             if K.whole_step_kernel_takes(la, tiles=t, tile_roles=roles)]
    # the next count the kernel takes (the one below at the largest)
    other = takes[takes.index(gate) + 1] if gate != takes[-1] else takes[-2]
    work = {k: v.clone() for k, v in cache.items()}

    def restore():
        for k, v in cache.items():
            work[k].copy_(v)

    def run(kernels, tiles, prm=params, c=None, cf=cfg, stamps=None):
        c = c if c is not None else work
        return model.serve_step_whole(prm, c, *step, cfg=cf, cache_len=case["cache_len"],
                                      kv_quant=quant, tiles=tiles, kernels=kernels,
                                      stamps=stamps, **fold)

    outs = {}
    G = cfg.num_attention_heads // cfg.num_key_value_heads
    want = ("decode" if case["C"] * G <= 8
            else "mma" if dtype == torch.bfloat16 else "tf32x3") + ("-tree" if fold else "")
    for name, kernels, tiles in (("gate", "cuda", gate), ("other", "cuda", other),
                                 ("plain", "torch", gate)):
        restore()
        if kernels == "cuda":
            (logits, toks, _), design = _design_of("whole_step_decode",
                                                   lambda: run(kernels, tiles))
            check(design == want, f"whole[{label}]: attention design {design}, want {want}")
        else:
            logits, toks, _ = run(kernels, tiles)
        torch.cuda.synchronize()
        outs[name] = (logits.clone(), toks.clone(), {k: v[:, :P].clone() for k, v in work.items()})
    # slots whose logits_idx column is padding read the scratch page, which
    # every padding line writes in no fixed order: only live rows count
    live = case["pos"].gather(1, case["li"][:, None])[:, 0] < case["cache_len"]
    if fold:  # every row's logits: the rows whose line is off the scratch page
        live = case["cpos"] < case["cache_len"]
        n = case["num_layers"] or cfg.num_hidden_layers
        check(all(torch.equal(work[k][n:], cache[k][n:]) for k in cache),
              f"whole[{label}]: the draft wrote layers past its {n}")
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
           "model": model.__name__.split(".")[-1],
           "dtype": str(dtype).replace("torch.", ""), "pool": quant or str(dtype).replace("torch.", ""),
           "shape": {"L": cfg.num_hidden_layers, "R": case["R"], "C": case["C"],
                     "D": cfg.hidden_size, "H": cfg.num_attention_heads,
                     "KV": cfg.num_key_value_heads, "F": cfg.intermediate_size,
                     "V": cfg.vocab_size, "ps": case["ps"], "NP": case["NP"], "P": P},
           "live_slots": int((case["pos"].gather(1, case["li"][:, None]) < case["cache_len"])
                             .sum()) if not fold else None,
           "live_rows": int((case["cpos"] < case["cache_len"]).sum()), "design": design,
           "num_layers": case["num_layers"] or cfg.num_hidden_layers,
           "tiles": gate, "tiles_other": other,
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
    unfused_kw = dict(kw, kernels="cuda", **{k: v for k, v in fold.items()
                                             if k in ("all_logits", "num_layers")})
    mask_args = (case["mask"], case["cpos"] if fold else None, case["table"])
    row.update(
        ms=cuda_ms_restored(lambda: run("cuda", gate), restore),
        ms_tiles_other=cuda_ms_restored(lambda: run("cuda", other), restore),
        plain_ms=cuda_ms_restored(lambda: run("torch", gate), restore, iters=5),
        unfused_ms=cuda_ms_restored(lambda: model.serve_step_paged(
            params, work, case["tokens"], case["pos"], case["li"], *mask_args,
            **unfused_kw), restore),
        library_ms=None)
    emit(row)
    emit(_whole_stages(label, row, lambda stamps: run("cuda", gate, stamps=stamps), restore,
                       case["num_layers"] or cfg.num_hidden_layers))
    del work
    return row


def _whole_stages(label, row, launch, restore, layers):
    """One more launch at the gate's tile count with the kernel's per-stage
    timer: milliseconds by stage (K.whole_step_stage_ms) beside the event
    time of the same launch and the case's median ``ms``."""
    stamps = torch.zeros(K.whole_step_stamp_count(layers), dtype=torch.int64, device=DEV)
    restore()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    launch(stamps)
    b.record()
    b.synchronize()
    t = stamps.tolist()
    check(all(x > 0 for x in t) and t == sorted(t), f"whole[{label}]: stamps do not rise: {t}")
    stages = K.whole_step_stage_ms(t, layers)
    return {"phase": "whole_stages", "case": label, "layers": layers, "tiles": row["tiles"],
            "design": row["design"],
            "event_ms": a.elapsed_time(b), "ms": row["ms"], "stages_ms": stages,
            "stages_sum_ms": sum(stages.values())}


#: the kernels line's rows of the fold: the pool types of the whole-step
#: spec arms, at their verify width
FOLD_ROWS = {"bf16": "bf16-verify-c7", "int8": "int8-verify-c7"}


def phase_whole_kernels(seed):
    """The whole-step kernel against its plain version in every
    WHOLE_CASES and WHOLE_FOLD_CASES case; the rows of the kernels line are
    the decode cases (MHA) of each pool type and the fold's verify cases of
    the spec arms' pools (``whole_step_decode[<pool>/tree]``)."""
    gen = torch.Generator(device=DEV)
    gen.manual_seed(seed + 4)
    rng = np.random.default_rng(seed + 4)
    main = {}
    cases = ([c + (None, None, None) for c in WHOLE_CASES]
             + [c + (None,) for c in WHOLE_FOLD_CASES]
             + [(label, dtype, quant, None, kind, None, None, (family, preset))
                for label, family, preset, dtype, quant, kind in WHOLE_GENERIC_CASES]
             + [(label, torch.bfloat16, None, None, kind, C, n, (family, preset))
                for label, family, preset, kind, C, n in WHOLE_GENERIC_FOLD_CASES])
    for label, dtype, quant, KV, kind, C, num_layers, family in cases:
        case = _whole_case(gen, rng, dtype, quant, KV, kind, C, num_layers, family)
        row = run_whole_check(label, case)
        pool = quant or ("bf16" if dtype == torch.bfloat16 else "f32")
        if family is None and kind == "decode" and KV == 32:
            main[f"whole_step_decode[{pool}]"] = row
        if label in FOLD_ROWS.values():  # the spec arms' pools, at C = 7
            main[f"whole_step_decode[{pool}/tree]"] = row
        for name in WHOLE_GENERIC_ROWS:  # a family's bf16 decode case
            if label == f"{name}-bf16-decode":
                main[f"whole_step_decode[{name}]"] = row
        del case
        gc.collect()
        torch.cuda.empty_cache()
    return main


def _teacher_forced_logits(cfg, params, sc, seqs, prompt_lens, family=llama):
    """Replay ``seqs`` (prompt + fed output tokens) through a fresh engine:
    lockstep chunked prefill, then one decode step per fed token, each
    through ``run_mixed(..., with_logits=True)`` — the serving step itself
    (the whole-step kernel where the engine runs it; ``engine.run`` is
    always the per-layer step). Returns each step's logits of the rows
    active in it, on the host. A paged engine gets each slot's pages as
    its lines arrive (its pool is the default worst case: nothing is
    preempted). ``family`` is the model's family module."""
    eng = InferenceEngine(family, cfg, params, sc, device=DEV)
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
    for kernel in ("flash_fwd", "flash_bwd_kv", "flash_bwd_q"):  # f32 and wgmma kernels
        if kernel in n:
            return kernel
    if "adam_kernel" in n:
        return "adam_update"
    if "paged_commit_kernel" in n:
        return "paged_commit"
    if any(k in n for k in ("wq_splitk_kernel", "wq_wgmma_kernel", "wq_rows_kernel",
                            "wq_reduce_kernel")):
        return "wq_matmul"
    if "dense_split_kernel" in n:
        return "decode_attention"
    if any(k in n for k in ("ragged_split_kernel", "ragged_mma_kernel")):
        return "ragged_paged_attention"
    if "fused_split_kernel" in n or "fused_mma_kernel" in n:
        return "fused_rope_paged_attention"
    if "verify_kernel" in n or "verify_mma_kernel" in n:
        return "verify_attention"
    if "memcpy" in n or "memset" in n:
        return "copy"
    if any(w in n for w in ("gemm", "gemv", "xmma", "cutlass", "nvjet")):  # cuBLAS
        return "matmul"
    return "other"


ATTENTION_CLASSES = ("decode_attention", "verify_attention", "ragged_paged_attention",
                     "fused_rope_paged_attention")


def _profile(run, path):
    """``run()`` under torch.profiler: device time by kernel class and the
    device's idle share of the wall time. Only the device is traced, and
    its kernel events are summed straight from the trace (the profiler's
    own event tree takes minutes to build for a serving run); the
    profiler still slows the host, so the idle share is an upper bound.
    ``reduce_s`` is the host time the sums took."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    t1 = time.perf_counter()
    by_name = {}
    for ev in _kernel_events(prof):
        ms, count = by_name.get(ev.name(), (0.0, 0))
        by_name[ev.name()] = (ms + ev.duration_ns() / 1e6, count + 1)
    by_class, kernels = {}, []
    for name, (ms, count) in by_name.items():
        c = _kernel_class(name)
        by_class[c] = by_class.get(c, 0.0) + ms
        kernels.append((ms, name[:100], count))
    busy_s = sum(by_class.values()) / 1e3
    kernels.sort(reverse=True)
    # the decode launches of the split walk: the paged kernels', the dense one's
    split = [(ms, count) for ms, name, count in kernels
             if "ragged_split_kernel" in name or "fused_split_kernel" in name]
    dense = [(ms, count) for ms, name, count in kernels if "dense_split_kernel" in name]
    # every attention kernel instantiation's device time and launches (the
    # kernel names carry the block design: split, mma, verify rows/f32)
    attention = {}
    for name, (ms, count) in by_name.items():
        if _kernel_class(name) in ATTENTION_CLASSES:
            bare = name.replace("(anonymous namespace)::", "")
            key = bare[:bare.find("(")].removeprefix("void ").split("::")[-1][:90]
            ms0, count0 = attention.get(key, (0.0, 0))
            attention[key] = (ms0 + ms, count0 + count)
    attention = {k: {"ms": ms, "count": n, "ms_a_launch": ms / n}
                 for k, (ms, n) in attention.items()}
    return {"phase": "profile", "path": path, "wall_s": wall, "device_busy_s": busy_s,
            "device_idle_share": 1.0 - busy_s / wall, "attention_kernels": attention,
            "paged_decode_device_ms": sum(ms for ms, _ in split),
            "paged_decode_launches": sum(count for _, count in split),
            "dense_decode_device_ms": sum(ms for ms, _ in dense),
            "dense_decode_launches": sum(count for _, count in dense),
            "device_ms_by_class": by_class,
            "share_of_busy": {c: ms / 1e3 / busy_s for c, ms in by_class.items()},
            "reduce_s": time.perf_counter() - t1,
            "top_kernels": [{"name": n, "ms": ms, "count": k} for ms, n, k in kernels[:10]]}


def _profile_train(run, head_shape):
    """One train step ``run()`` under torch.profiler, host and device, with
    input shapes: ``_profile``'s device time by kernel class, plus the
    device time of the LM head (its "lm_head" and "lm_head.backward"
    ranges, ``llama.lm_head``), and the bf16 to f32 copies of a tensor of
    the head's shape (``head_f32_copies``: neither the head nor its
    gradient is copied to f32; the plain Adam update would copy the
    gradient)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_class, by_name = {}, {}
    for ev in _kernel_events(prof):
        c = _kernel_class(ev.name())
        by_class[c] = by_class.get(c, 0.0) + ev.duration_ns() / 1e6
        ms, count = by_name.get(ev.name(), (0.0, 0))
        by_name[ev.name()] = (ms + ev.duration_ns() / 1e6, count + 1)
    shapes = (list(head_shape), list(head_shape)[::-1])
    copies = sum(1 for ev in prof.profiler.kineto_results.events()
                 if ev.name() == "aten::copy_" and ev.shapes()
                 and list(ev.shapes()[0]) in shapes
                 and ev.dtypes()[:2] == ["float", "c10::BFloat16"])
    busy_ms = sum(by_class.values())
    head_ms = {}
    for ev in prof.key_averages():
        if ev.key in RANGES:
            head_ms[ev.key] = getattr(ev, "device_time_total",
                                      getattr(ev, "cuda_time_total", 0.0)) / 1e3
    split = {"lm_head": sum(head_ms.values()), "adam": by_class.get("adam_update", 0.0),
             "flash_forward": by_class.get("flash_fwd", 0.0),
             "flash_backward": by_class.get("flash_bwd_kv", 0.0)
             + by_class.get("flash_bwd_q", 0.0)}
    split["rest"] = busy_ms - sum(split.values())
    return {"phase": "profile", "path": "train", "wall_s": wall, "device_busy_s": busy_ms / 1e3,
            "device_idle_share": 1.0 - busy_ms / 1e3 / wall, "device_ms_by_class": by_class,
            "device_ms_split": split, "lm_head_ms": head_ms, "head_f32_copies": copies,
            "top_kernels": [{"name": n[:100], "ms": ms, "count": k} for n, (ms, k) in
                            sorted(by_name.items(), key=lambda x: -x[1][0])[:12]]}


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
    llm.engine.plain_attention_steps = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    results = llm.generate(prompts, max_new_tokens=new)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: v for k, v in K.LAUNCHES.items() if v}
    design_launches = {k: v for k, v in K.DESIGN_LAUNCHES.items() if v}
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
            "design_launches": design_launches,
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
    # the bf16 mixed steps (C * G = 128 rows a KV head) verify on the tensor cores
    check(line["design_launches"].get("verify_attention[mma]", 0) == launches["verify_attention"],
          f"dense: verify launches not all mma: {line['design_launches']}")
    prof = profile_slice(llm, prompts, new, "dense")
    prof["dense_decode_ms_a_launch"] = (prof["dense_decode_device_ms"]
                                        / max(1, prof["dense_decode_launches"]))
    emit(prof)
    # the padding rule: the same requests with every padding row walking
    # the whole cache (the lengths before the rule) serve the same tokens
    full_walk = _full_walk_lengths()
    with full_walk:
        full = llm.generate(prompts, max_new_tokens=new)
    same = [a.output_tokens == b.output_tokens for a, b in zip(results, full)]
    check(all(same), f"dense: the padding rule changed served tokens: {same}")

    # hold the served path against the plain one, teacher-forced, and
    # both against the same computation in f32 (the bf16 weights upcast)
    seqs = [r.input_tokens + r.output_tokens[:-1] for r in results]
    plens = [len(r.input_tokens) for r in results]
    params = llm.params
    _free(llm)
    sc = dict(max_requests_per_batch=len(seqs))
    got = _teacher_forced_logits(cfg, params, ServingConfig(kernels="cuda", **sc),
                                 seqs, plens)
    with full_walk:
        walked = _teacher_forced_logits(cfg, params, ServingConfig(kernels="cuda", **sc),
                                        seqs, plens)
    bitwise = all(torch.equal(a, b) for a, b in zip(got, walked))
    emit({"phase": "padding_rule", "path": "dense", "served_tokens_equal": all(same),
          "teacher_forced_steps": len(got), "live_logits_bitwise": bitwise})
    check(bitwise, "dense: the padding rule changed live rows' logits")
    del walked
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


class _full_walk_lengths:
    """Within it, the dense step's padding rows attend their whole mask row
    (every line below the scratch line), as before the padding rule: the
    plain version of ``llama.decode_seq_lens``, the mask count."""

    def __enter__(self):
        self.rule = llama.decode_seq_lens
        llama.decode_seq_lens = lambda mask, positions, S1: (
            mask[:, 0, :].sum(dim=-1).to(torch.int32))

    def __exit__(self, *exc):
        llama.decode_seq_lens = self.rule


def whole_stages_full_depth(llm, seed, case="bf16-decode-full-depth"):
    """One stamped decode step of a whole-step arm's engine at its depth:
    its weights and its gate's tile count, 16 slots of ``DECODE_LENS``
    lines (slot 0 idle) over a fresh pool of random bf16 lines, the new
    lines committed in place. Warmed once, then stamped; milliseconds by
    stage beside the event time of the stamped launch. The arm's family
    module is ``llm.family`` (LLaMA or a generic decoder)."""
    eng, cfg, model = llm.engine, llm.cfg, llm.family
    sc = ServingConfig()
    R, ps, NP = eng.num_slots, sc.page_size, sc.pages_per_slot
    rng = np.random.default_rng(seed + 6)
    pos = _paged_positions(rng, "decode", R, 1, sc.cache_len, ps)
    held = [-(-(int(p) + 1) // ps) if p < sc.cache_len else 0 for p in pos[:, 0]]
    P = sum(held)
    table = np.full((R, NP), P, np.int32)
    first = 0
    for r, n in enumerate(held):
        table[r, :n] = np.arange(first, first + n)
        first += n
    cache = model.init_paged_kv_cache(cfg, P, ps, device=DEV)
    gen = torch.Generator(device=DEV)
    gen.manual_seed(seed + 6)
    for name in ("k", "v"):
        for layer in cache[name]:
            layer.copy_(torch.randn(layer.shape, generator=gen, device=DEV))
    step = (torch.from_numpy(rng.integers(1, cfg.vocab_size, size=(R, 1))).to(DEV),
            torch.from_numpy(pos).to(DEV), torch.zeros(R, dtype=torch.long, device=DEV),
            torch.from_numpy(table).to(DEV))
    L = cfg.num_hidden_layers

    def launch(stamps=None):
        return model.serve_step_whole(llm.params, cache, *step, cfg=cfg, cache_len=sc.cache_len,
                                      tiles=eng.whole_step_tiles, kernels="cuda", stamps=stamps)
    _, design = _design_of("whole_step_decode", launch)
    stamps = torch.zeros(K.whole_step_stamp_count(L), dtype=torch.int64, device=DEV)
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    a.record()
    launch(stamps)
    b.record()
    b.synchronize()
    t = stamps.tolist()
    check(all(x > 0 for x in t) and t == sorted(t), f"whole full depth: stamps do not rise: {t}")
    stages = K.whole_step_stage_ms(t, L)
    row = {"phase": "whole_stages", "case": case, "layers": L,
           "tiles": eng.whole_step_tiles, "design": design, "live_slots": sum(n > 0 for n in held),
           "pages": P, "event_ms": a.elapsed_time(b), "stages_ms": stages,
           "stages_sum_ms": sum(stages.values()),
           "attention_ms_a_layer": stages["attention"] / L}
    del cache
    torch.cuda.empty_cache()
    return row


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
    cfg, params = layer_skip_draft(llama.LLaMAConfig.llama_7b(), holder.pop(), PAGED_LAYERS)
    prompts, new = _slice_prompts(seed, cfg)
    launches, seqs = {}, None
    tf = {}
    for label, quant, fused in arms:
        t_arm = time.perf_counter()
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
            took = {k: v for k, v in line["design_launches"].items()
                    if k.startswith("whole_step_decode[")}
            emit({"phase": "whole_designs", "path": path, "design_launches": took,
                  "steps": line["steps"]})
            check(set(took) == {"whole_step_decode[mma]", "whole_step_decode[decode]"},
                  f"{path}: the whole step's attention took {took}, want mma on its mixed "
                  "steps and decode on the rest")
        if quant is not None and not fused:
            check(line["launches"].get(f"paged_commit[{quant}]", 0) > 0,
                  f"{path}: the commit kernel was never launched")
        if quant is None:
            check(line["preemptions"] > 0, f"{path}: the 17-page budget caused no preemption")
        t_prof = time.perf_counter()
        if not whole or label == "bf16-whole":
            emit(profile_slice(llm, prompts, new, path))
        if label == "bf16-whole":
            emit(whole_stages_full_depth(llm, seed,
                                         case=f"bf16-decode-{PAGED_LAYERS}-layers"))
        t_tf = time.perf_counter()
        if seqs is None:
            # every arm is teacher-forced over the first bf16 arm's tokens
            seqs = [r.input_tokens + r.output_tokens[:-1] for r in results]
        for k, v in line["launches"].items():
            launches[k] = launches.get(k, 0) + v
        if not whole:  # the arm's decode launches, on its one pool type
            key = f"{kind}[{quant or 'bf16'}/decode]"
            launches[key] = launches.get(key, 0) + line["design_launches"].get(f"{kind}[decode]", 0)
        _free(llm)
        sc = dict(max_requests_per_batch=len(seqs), kv_layout="paged", kv_quant=quant,
                  fused_decode=fused)
        plens = [len(p) for p in prompts]
        tf[label] = [_teacher_forced_logits(cfg, params, ServingConfig(kernels=k, **sc),
                                            seqs, plens) for k in ("cuda", "torch")]
        # host seconds of the arm's parts: build and serve, profile, teacher-forced runs
        emit({"phase": "arm_seconds", "path": path, "serve_s": t_prof - t_arm,
              "profile_s": t_tf - t_prof, "teacher_forced_s": time.perf_counter() - t_tf})
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


def _record_spec(mgr):
    """:func:`_record_steps` for a SpecInferManager: the logits of its
    pipelined steps (the prefill phase) as there, plus every tree-verify
    step's rows, kept until the run's tokens say which rows lay on the
    served path. Returns ``(rec, resolve)``; ``resolve(prompts, outputs)``
    (request i in slot i) adds the path rows to ``rec`` by (slot, position
    of the row's token) and returns it."""
    eng = mgr.engine
    rec, run, trees = _record_steps(eng), eng.run, []

    def run_tree(bc, all_logits=False):
        logits = run(bc, all_logits=all_logits)
        if all_logits and bc.mask is not None:
            live = np.flatnonzero(bc.active)
            trees.append((bc, live, logits[torch.from_numpy(live).to(logits.device)].cpu()))
        return logits

    def resolve(prompts, outputs):
        for bc, live, lg in trees:
            for j, s in enumerate(live):
                seq, prefix = prompts[s] + outputs[s], int(bc.cache_positions[s, 0])
                n = int(bc.spec_nodes[s])
                for c in range(n):
                    anc = np.flatnonzero(bc.mask[s, c, prefix:prefix + n])
                    if all(bc.positions[s, a] < len(seq)
                           and bc.tokens[s, a] == seq[bc.positions[s, a]] for a in anc):
                        rec[(int(s), int(bc.positions[s, c]))] = lg[j, c]
        return rec

    eng.run = run_tree
    return rec, resolve


def _parting(plens, got, want, rec_got, rec_want):
    """Where two greedy runs part, read from the logits they served
    (request i sits in slot i of a fresh engine): for each request whose
    tokens differ, its first differing step t, the reference's top-two
    margin and the largest logit difference there, and the relative L2 of
    the two runs' logits over the request's steps 0..t (the same inputs
    up to there)."""
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
        out.append({"request": i, "step": t, "margin": float(top2[0] - top2[1]),
                    "max_abs_diff": float((a[-1] - b[-1]).abs().max()), "rel_l2": _rel(a, b)})
    return out


def _divergence(plens, got, want, rec_got, rec_want):
    """:func:`_parting`, held to the tie rule: a token may part only at a
    tie, the margin within twice the difference, and the logits within
    F32_TIE_REL_L2."""
    out = _parting(plens, got, want, rec_got, rec_want)
    for d in out:
        check(d["margin"] <= 2 * d["max_abs_diff"], f"f32 token parts at no tie: {d}")
        check(d["rel_l2"] <= F32_TIE_REL_L2, f"f32 logits off: {d}")
    return out


def phase_f32(seed):
    """Full width, 2 layers, f32: greedy tokens equal across kernels
    ("cuda" and "torch") on the dense layout and on f32, int8 and int4
    pools; fused, whole-step and unfused (f32, int8 and int4 pools); paged
    and dense. SpecInfer (a 1-layer layer-skip SSM, SpecConfig(2, 3)) on
    the dense layout and on f32 (unfused and fused) pools against the
    incremental run of the same cache, on int8 and int4 pools against the
    same spec run with kernels="torch"; whole-step SpecInfer (the
    speculation fold: the early-exit draft on f32 pools, the SSM on f32,
    int8 and int4 pools) against the same manager with kernels="torch";
    and beam search (SPEC_BEAMS) equal across kernels and layouts. The
    int4 whole-step runs and the quantized spec runs alone may part from
    their references, and only at a rounding tie (:func:`_divergence`). The quantized spec runs' distance
    from the incremental runs is printed, not held: their tree lines
    raise their pages' scales, which requantizes the committed codes
    there (the JAX package's manager does the same). Every paged launch
    with f32 q takes the "decode" or the "tf32x3" design, and each paged
    kernel takes "tf32x3" on the runs' mixed steps. Returns the launches
    of its paged runs."""
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
    outs, launches, designs, recs = {}, {}, {}, {}
    for name, kw in runs.items():
        llm.compile(ServingConfig(cache_dtype=torch.float32, **kw))
        recs[name] = _record_steps(llm.engine)
        K.reset_launch_counts()
        outs[name] = [r.output_tokens for r in llm.generate(prompts, max_new_tokens=16)]
        for k, v in K.LAUNCHES.items():
            if v and "[f32]" in k:
                launches[k] = launches.get(k, 0) + v
        for k, v in K.DESIGN_LAUNCHES.items():
            if v:
                designs[k] = designs.get(k, 0) + v
        if kw.get("kv_layout") == "paged" and "kv_quant" not in kw:  # f32 pools
            for k in K.PAGED_KERNELS:
                launches[f"{k}[f32/decode]"] = (launches.get(f"{k}[f32/decode]", 0)
                                                + K.DESIGN_LAUNCHES[f"{k}[decode]"])
        _free(llm)
    # SpecInfer at 2 layers: a 1-layer layer-skip SSM, SpecConfig(2, 3),
    # against the incremental run of the same cache
    dcfg, dparams = layer_skip_draft(cfg, llm.params, 1)
    spec_runs = {"spec-dense": {}, "spec-paged": paged, "spec-paged-fused": dict(paged, **fused),
                 "spec-int8": dict(paged, kv_quant="int8"),
                 "spec-int8-torch": dict(paged, kv_quant="int8", kernels="torch"),
                 "spec-int4": dict(paged, kv_quant="int4"),
                 "spec-int4-torch": dict(paged, kv_quant="int4", kernels="torch")}
    # the speculation fold: whole-step spec runs (the early-exit draft's
    # first layer, and the 1-layer SSM with its own walk) against the same
    # managers with kernels="torch"
    early = SpecConfig(2, 3, draft="early_exit", draft_layers=1)
    for pool in ("f32", "int8", "int4"):
        q = {} if pool == "f32" else dict(kv_quant=pool)
        for draft in (("ee", "ssm") if pool == "f32" else ("ssm",)):
            for kernels in ("cuda", "torch"):
                spec_runs[f"spec-whole-{pool}-{draft}-{kernels}"] = (
                    dict(paged, kernels=kernels, **q, **whole), early if draft == "ee" else None)
    spec_stats = {}
    for name, kw in spec_runs.items():
        kw, spec = kw if isinstance(kw, tuple) else (kw, None)
        ssms = [] if spec is not None else [LLM(llama, dcfg, dparams, device=DEV)]
        llm.compile(ServingConfig(cache_dtype=torch.float32, **kw), ssms=ssms,
                    spec=spec or SpecConfig(2, 3))
        if kw.get("fused_decode") == ("whole_step",) and kw.get("kernels") != "torch":
            check(all(e.whole_step_spec_on for e in llm.rm._engines()),
                  f"{name}: the speculation fold is off")
        rec, resolve = _record_spec(llm.rm)
        K.reset_launch_counts()
        res = llm.generate(prompts, max_new_tokens=16)
        outs[name] = [r.output_tokens for r in res]
        recs[name] = resolve(prompts, outs[name])
        spec_stats[name] = {"rounds": llm.rm.stats.spec_rounds,
                            "accepted": llm.rm.stats.spec_accepted,
                            "drafted": llm.rm.stats.spec_drafted}
        for k, v in K.LAUNCHES.items():
            if v and "[f32]" in k:
                launches[k] = launches.get(k, 0) + v
        for k, v in K.DESIGN_LAUNCHES.items():
            if v:
                designs[k] = designs.get(k, 0) + v
        _free(llm)
    # beam search: equal tokens across kernels and layouts
    beams = {}
    for name, kw in (("dense-cuda", {}), ("dense-torch", dict(kernels="torch")),
                     ("paged-cuda", paged)):
        llm.compile(ServingConfig(cache_dtype=torch.float32, **kw))
        beams[name] = llm.generate([prompts[0]], GenerationConfig(num_beams=SPEC_BEAMS),
                                   max_new_tokens=16)[0].output_tokens
        _free(llm)
    check(len({tuple(b) for b in beams.values()}) == 1, f"f32 beam tokens differ: {beams}")
    pairs = [("dense-cuda", "dense-torch"), ("paged-cuda", "paged-torch"),
             ("int8-cuda", "int8-torch"), ("int4-cuda", "int4-torch"),
             ("paged-fused", "paged-cuda"),
             ("int8-fused", "int8-cuda"), ("int4-fused", "int4-cuda"),
             ("paged-cuda", "dense-cuda"),
             ("paged-whole", "paged-cuda"), ("paged-whole", "paged-torch"),
             ("int8-whole", "int8-cuda"), ("int8-whole", "int8-torch"),
             ("int4-whole", "int4-cuda"), ("int4-whole", "int4-torch"),
             ("spec-dense", "dense-cuda"), ("spec-paged", "paged-cuda"),
             ("spec-paged-fused", "paged-fused"), ("spec-int8", "spec-int8-torch"),
             ("spec-int4", "spec-int4-torch")]
    pairs += [(a, a[:-4] + "torch") for a in spec_runs if a.startswith("spec-whole-")
              and a.endswith("-cuda")]
    plens = [len(p) for p in prompts]
    ties = {}
    for a, b in pairs:
        if outs[a] == outs[b]:
            continue
        # the whole-step kernel projects in its own summation order, and a
        # quantized spec run's tree lines set its pages' scales: on a
        # quantized pool a K/V value at a rounding tie may take the other
        # code (one int4 code step is 1/7 of the page's amax). A greedy
        # token may then part only where the reference's top two logits
        # are closer than the logits moved; every other pair is equal
        # token for token
        check(a in ("int4-whole", "spec-int4", "spec-int8", "spec-whole-int4-ssm-cuda"),
              f"f32 greedy tokens differ: {a} {outs[a]} vs {b} {outs[b]}")
        ties[f"{a} vs {b}"] = _divergence(plens, outs[a], outs[b], recs[a], recs[b])
    # a reading, not held: the quantized spec runs against the incremental
    # runs of the same pool (requantized committed codes, above)
    requantized = {f"{a} vs {b}": _parting(plens, outs[a], outs[b], recs[a], recs[b])
                   for a, b in (("spec-int8", "int8-cuda"), ("spec-int4", "int4-cuda"))}
    emit({"phase": "f32_tokens", "layers": 2, "requests": len(prompts),
          "new_tokens": 16, "equal": [f"{a} == {b}" for a, b in pairs
                                      if f"{a} vs {b}" not in ties],
          "parted_at_ties": ties, "quantized_spec_vs_incremental": requantized,
          "spec": spec_stats, "beam_tokens_equal": list(beams),
          "launches": launches, "design_launches": designs,
          "verify_designs": {k: v for k, v in designs.items()
                             if k.startswith("verify_attention[")}})
    for k in ("ragged_paged_attention[f32]", "fused_rope_paged_attention[f32]",
              "whole_step_decode[f32]", "ragged_paged_attention[f32/decode]",
              "fused_rope_paged_attention[f32/decode]"):
        check(launches.get(k, 0) > 0, f"{k} was never launched on the f32 paged runs")
    check(designs.get("whole_step_decode[decode-tree]", 0) > 0,
          f"the f32 whole-step spec runs launched no fold: {designs}")
    for k in K.PAGED_KERNELS + ("whole_step_decode",):
        took = {d for d in K.DESIGNS[k][0] if designs.get(f"{k}[{d}]")}
        check(took == {"decode", "tf32x3"},
              f"{k} took designs {sorted(took)} with f32 q, want decode and tf32x3")
    # the dense f32 runs' mixed steps verify on the TF32 tensor cores
    check(designs.get("verify_attention[tf32x3]", 0) > 0,
          f"dense f32 mixed steps took no tf32x3 verify: {designs}")
    return launches


# ---------------------------------------------------------------------------
# SpecInfer and beam search on LLaMA-7B (slice 12)

# arms of the spec phase, on the dense slice's 16 slots and 8 requests:
# (label, ServingConfig fields, SpecConfig fields, layers of the
# layer-skip SSM that drafts over the target's own weights, or None for
# the early-exit self-draft)
# the depths of the spec and prefix phases: LLaMA-7B's width cut to 4 of
# its 32 layers (their arms were the run's largest after the paged slice's;
# with the families phase, the generic whole-step checks and the quant,
# offload and cluster phases the whole run must stay well inside its 1200 s
# on a slower machine too)
SPEC_LAYERS = 4
PREFIX_LAYERS = 4
SPEC_PAGED = dict(kv_layout="paged", max_cached_tokens=PAGED_BUDGET)
SPEC_ARMS = (
    ("dense", {}, dict(beam_width=2, beam_depth=3), 2),
    # reaches the W = 1 rungs and the verify-skip rows
    ("dense-adaptive", {}, dict(beam_width=3, beam_depth=8, adaptive=True, verify_skip=True),
     1),
    ("dense-early-exit", {}, dict(beam_width=2, beam_depth=3, draft="early_exit",
                                  draft_layers=2), None),
    # speculation under preemption, the tree committed by the fused kernel
    ("paged-bf16-fused", dict(SPEC_PAGED, fused_decode=("rope_kv_write",)),
     dict(beam_width=2, beam_depth=3), 2),
    # the quantized commit (kv_quant.quant_commit_lines on the commit kernel)
    ("paged-int8", dict(SPEC_PAGED, kv_quant="int8"), dict(beam_width=2, beam_depth=3), 2),
    # the speculation fold (slice 13): every step one whole-step launch; the
    # early-exit draft the first 2 layers of the same kernel (bf16, 17
    # pages: preemption), and a 2-layer SSM whose engine runs the walk too
    # (int8, 33 pages)
    ("paged-bf16-whole", dict(SPEC_PAGED, fused_decode=("whole_step",)),
     dict(beam_width=2, beam_depth=3, draft="early_exit", draft_layers=2), None),
    ("paged-int8-whole", dict(SPEC_PAGED, kv_quant="int8", fused_decode=("whole_step",)),
     dict(beam_width=2, beam_depth=3), 2),
)
# controls of the greedy check: the same manager over plain attention
# (kernels="torch") at the same tree shapes, so its served tokens part
# from the teacher-forced argmax by bf16's own noise alone; (label,
# ServingConfig fields, SpecConfig fields, draft layers, the SPEC_ARMS
# whose near-ties it bounds)
SPEC_CONTROLS = (
    ("dense-torch", dict(kernels="torch"), dict(beam_width=2, beam_depth=3), 2,
     ("dense", "dense-adaptive", "dense-early-exit", "paged-bf16-fused", "paged-bf16-whole")),
    ("paged-int8-torch", dict(SPEC_PAGED, kv_quant="int8", kernels="torch"),
     dict(beam_width=2, beam_depth=3), 2, ("paged-int8", "paged-int8-whole")),
)
# the per-layer paged attention kernels, none of which a whole-step arm may launch
PER_LAYER_PAGED = tuple(f"{k}[{t}]" for k in K.PAGED_KERNELS for t in K.POOL_TYPES)
# a spec arm may count at most this many times its control's near-ties
SPEC_TIE_FACTOR = 2
SPEC_BEAMS = 3
# tree-verify steps of the fused arm held bitwise against the unfused step
FUSED_TWIN_STEPS = 4


def layer_skip_draft(cfg, params, k):
    """The target's first ``k`` blocks as an SSM: the config cut to ``k``
    layers, views of the stacked layer weights (nothing copied), the
    embedding, final norm and head shared."""
    dparams = dict(params)
    dparams["layers"] = {n: w[:k] for n, w in params["layers"].items()}
    return dataclasses.replace(cfg, num_hidden_layers=k), dparams


def _next_token_logits(cfg, params, sc, prompts, outputs, family=llama):
    """Teacher-forced logits of every served token: prompt plus outputs
    replayed through ``_teacher_forced_logits`` (one slot a request, a
    fresh engine); a (requests, tokens, V) host tensor whose row (i, k)
    predicts ``outputs[i][k]``."""
    seqs = [p + o[:-1] for p, o in zip(prompts, outputs)]
    steps = _teacher_forced_logits(cfg, params, sc, seqs, [len(p) for p in prompts], family)
    return _next_rows(steps, prompts, outputs, sc.prefill_chunk)


def _next_rows(steps, prompts, outputs, C):
    """The rows of teacher-forced ``steps`` (``_teacher_forced_logits`` over
    prompts plus outputs) that predict each served token: (requests,
    tokens, V)."""
    seqs = [p + o[:-1] for p, o in zip(prompts, outputs)]
    plens = [len(p) for p in prompts]
    n_pre = math.ceil(max(plens) / C)
    out = []
    for i, (pl, o) in enumerate(zip(plens, outputs)):
        k = (pl - 1) // C  # the chunk that ends the prompt
        rows = [j for j in range(len(prompts)) if plens[j] > k * C]
        picked = [steps[k][rows.index(i)]]
        for t in range(len(o) - 1):
            rows = [j for j in range(len(prompts)) if plens[j] + t < len(seqs[j])]
            picked.append(steps[n_pre + t][rows.index(i)])
        out.append(torch.stack(picked))
    return torch.stack(out)


def _greedy_over_prefix(label, outputs, got, exact):
    """Each served token against the argmax of the teacher-forced logits
    ``got`` at its position (the model's greedy token over the served
    prefix). Where they differ, the served token's logit must lie within
    twice bf16's own error there of the argmax's: the served token came
    from another bf16 evaluation of the same function (a tree-verify
    row), and each such evaluation lies within that error of ``exact``,
    the same computation in f32 (the dense slice's yardstick). Returns
    the line's counts (the controls of the count: the incremental arm's
    tokens, and SPEC_CONTROLS)."""
    served = torch.tensor(outputs)
    gap = got.amax(-1) - got.gather(-1, served[..., None])[..., 0]
    err = (got - exact).abs().amax(-1)
    mismatch = got.argmax(-1) != served
    ties = mismatch & (gap <= 2 * err)
    bad = mismatch & ~ties
    row = {"positions": served.numel(), "argmax_equal": int((~mismatch).sum()),
           "near_ties": int(ties.sum()), "not_greedy": int(bad.sum()),
           "bf16_err_median": float(err.median()), "bf16_err_max": float(err.max())}
    if bool(ties.any()):
        row["tie_gaps"] = [float(g) for g in gap[ties]]
        row["tie_bounds"] = [2 * float(e) for e in err[ties]]
    check(not bool(bad.any()), f"{label}: served tokens that are not greedy over their "
          f"prefix: {torch.nonzero(bad).tolist()[:8]}")
    return row


class _record_fold:
    """Within it, each engine keeps the inputs of its speculation-fold
    launch of each width with the most live rows (the step's tokens,
    positions, logits_idx, spec keywords and page table), so that
    :func:`_fold_stages` can time those launches stage by stage
    afterwards."""

    def __init__(self, engines):
        self.engines, self.calls, self.live = engines, {}, {}

    def __enter__(self):
        self.orig = [e._step_whole for e in self.engines]
        for eng, orig in zip(self.engines, self.orig):
            def rec(tokens, positions, logits_idx, _eng=eng, _orig=orig, **spec):
                key = (id(_eng), tokens.shape[1], spec.get("num_layers"))
                live = int((spec["cache_positions"] < _eng.scratch_pos).sum()) if spec else 0
                if spec and live > self.live.get(key, 0):
                    self.live[key] = live
                    self.calls[key] = (_eng, tokens.clone(), positions.clone(),
                                       logits_idx.clone(),
                                       {k: v.clone() if torch.is_tensor(v) else v
                                        for k, v in spec.items()},
                                       _eng.page_table_device().clone())
                return _orig(tokens, positions, logits_idx, **spec)
            eng._step_whole = rec
        return self

    def __exit__(self, *exc):
        for eng, orig in zip(self.engines, self.orig):
            eng._step_whole = orig


def _fold_stages(label, calls):
    """One stamped launch of each recorded fold width (a whole_stages line
    each, :func:`_whole_stages`), on a copy of its engine's pools that is
    put back after."""
    lines = []
    for (_, C, num_layers), (eng, toks, pos, li, spec, table) in sorted(
            calls.items(), key=lambda kv: (kv[0][1], kv[0][2] or 0)):
        saved = {k: v.clone() for k, v in eng.cache.items()}
        tiles = eng.whole_step_spec_tiles[C]
        layers = spec.get("num_layers") or eng.cfg.num_hidden_layers
        sc = eng.serving

        def restore():
            for k, v in eng.cache.items():
                v.copy_(saved[k])

        def launch(stamps):
            return llama.serve_step_whole(eng.params, eng.cache, toks, pos, li, table,
                                          cfg=eng.cfg, cache_len=sc.cache_len,
                                          kv_quant=sc.kv_quant, tiles=tiles, kernels="cuda",
                                          stamps=stamps, **spec)

        G = eng.cfg.num_attention_heads // eng.cfg.num_key_value_heads
        row = {"tiles": tiles, "design": ("decode" if C * G <= 8 else "mma") + "-tree",
               "ms": None}
        kind = "verify" if num_layers is None and eng.cfg.num_hidden_layers > 2 else "draft"
        line = _whole_stages(f"{label}-{kind}-c{C}", row, launch, restore, layers)
        restore()
        line["live_rows"] = int((spec["cache_positions"] < sc.cache_len).sum())
        lines.append(line)
        del saved
    return lines


class _fused_verify_twin:
    """Within it, the engine's first FUSED_TWIN_STEPS tree-verify steps
    (all-positions logits under an explicit mask) run twice from the same
    cache: the fused step (served), then the unfused paged step on a copy
    of the cache as it was before. The live rows' logits and the pools
    (the scratch page aside, which padding rows write) must be equal bit
    for bit; the served step's cache is then put back."""

    def __init__(self, eng):
        self.eng, self.rows = eng, []

    def __enter__(self):
        eng, step = self.eng, self.eng._step
        self.step = step

        def twin(tokens, positions, logits_idx, mask=None, cache_positions=None,
                 all_logits=False, num_layers=None):
            args = (tokens, positions, logits_idx, mask, cache_positions, all_logits, num_layers)
            if not (all_logits and mask is not None and len(self.rows) < FUSED_TWIN_STEPS):
                return step(*args)
            before = {k: v.clone() for k, v in eng.cache.items()}
            fused = step(*args)
            after = {k: v.clone() for k, v in eng.cache.items()}
            for k, v in eng.cache.items():
                v.copy_(before[k])
            sc = eng.serving
            eng.serving = dataclasses.replace(sc, fused_decode=())
            try:
                plain = step(*args)
            finally:
                eng.serving = sc
            live = mask.any(-1)
            P = eng.pager.num_pages
            self.rows.append({
                "C": tokens.shape[1], "live_rows": int(live.sum()),
                "logits_bitwise": torch.equal(fused[live], plain[live]),
                "pools_bitwise": all(torch.equal(v[:, :P], after[k][:, :P])
                                     for k, v in eng.cache.items())})
            for k, v in eng.cache.items():
                v.copy_(after[k])
            return fused

        eng._step = twin
        return self

    def __exit__(self, *exc):
        self.eng._step = self.step


def _spec_line(label, results, line, stats, incr_steps):
    """The spec arm's line: _serve's, plus speculation's own numbers
    (bench.py's serve_bench definitions)."""
    steps = sum(r.profile.llm_decoding_steps for r in results)
    accepted = sum(r.profile.accepted_tokens for r in results)
    drafted = sum(r.profile.speculated_tokens for r in results)
    tokens = sum(len(r.output_tokens) for r in results)
    return {"phase": "spec", "path": label, "model": "llama_7b", "layers": SPEC_LAYERS,
            "dtype": "bfloat16", "spec_step_reduction": incr_steps / max(1, steps),
            "drafted_accept_rate": accepted / max(1, drafted),
            "tokens_per_verify_step": tokens / max(1, steps),
            "llm_steps": steps, "spec_rounds": stats.spec_rounds,
            "spec_resizes": stats.spec_resizes,
            "verify_skipped_rounds": stats.verify_skipped_rounds,
            "spec_reprobes": stats.spec_reprobes, **line}


def phase_spec(seed):
    """SpecInfer and beam search on LLaMA-7B at full width cut to
    SPEC_LAYERS layers (random bf16 weights from the seed, the dense
    slice's 16 slots and 8
    requests x 64 greedy tokens): the incremental arm, beam search on one
    request, and the SPEC_ARMS through LLM.generate, each profiled. Every
    arm's served tokens must be greedy over their own prefix
    (:func:`_greedy_over_prefix`, teacher-forced through the arm's own
    kernels="cuda" engine), and the near-ties an arm counts may be at
    most SPEC_TIE_FACTOR times those of its SPEC_CONTROLS run, which
    verifies the same trees through plain attention; the fused arm's tree
    verify must equal the unfused paged step bit for bit. Returns the
    launches of the arms' runs."""
    cfg = llama.LLaMAConfig.llama_7b(num_hidden_layers=SPEC_LAYERS)
    llm = LLM(llama, cfg, device=DEV, seed=seed)
    params = llm.params
    prompts, new = _slice_prompts(seed, cfg)
    llm.compile(ServingConfig())
    results, line = _serve(llm, prompts, new)
    incr_steps = sum(r.profile.llm_decoding_steps for r in results)
    emit({"phase": "spec", "path": "incremental", "model": "llama_7b", "layers": SPEC_LAYERS,
          "dtype": "bfloat16", "llm_steps": incr_steps, **line})
    launches = dict(line["launches"])
    served = {"incremental": [r.output_tokens for r in results]}

    # beam search: one request, SPEC_BEAMS hypotheses in slots 0..2
    K.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    beam = llm.generate([prompts[1]], GenerationConfig(num_beams=SPEC_BEAMS),
                        max_new_tokens=new)[0]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check(len(beam.output_tokens) == new and all(0 <= t < cfg.vocab_size
                                                 for t in beam.output_tokens),
          f"beam: {len(beam.output_tokens)} tokens, want {new} in range")
    beam_launches = {k: v for k, v in K.LAUNCHES.items() if v}
    emit({"phase": "spec", "path": "beam", "num_beams": SPEC_BEAMS, "requests": 1,
          "prompt_len": len(prompts[1]), "new_tokens": new, "wall_s": wall,
          "tokens_per_s": new / wall, "launches": beam_launches,
          "design_launches": {k: v for k, v in K.DESIGN_LAUNCHES.items() if v},
          "same_as_greedy": beam.output_tokens == results[1].output_tokens})
    for k, v in beam_launches.items():
        launches[k] = launches.get(k, 0) + v
    _free(llm)

    for label, kw, spec_kw, draft_layers in SPEC_ARMS:
        t_arm = time.perf_counter()
        llm = LLM(llama, cfg, params, device=DEV)
        ssms = []
        if draft_layers:
            dcfg, dparams = layer_skip_draft(cfg, params, draft_layers)
            ssms = [LLM(llama, dcfg, dparams, device=DEV)]
        llm.compile(ServingConfig(**kw), ssms=ssms, spec=SpecConfig(**spec_kw))
        whole = "whole_step" in kw.get("fused_decode", ())
        engines = llm.rm._engines()
        with _record_fold(engines if whole else []) as folds:
            results, line = _serve(llm, prompts, new)
        stats = llm.rm.stats
        emit(_spec_line(label, results, line, stats, incr_steps))
        check(stats.spec_rounds > 0, f"spec {label}: no speculation round ran")
        quant = kw.get("kv_quant")
        if whole:
            # every step one whole-step launch: no per-layer paged attention,
            # every draft and verify step the fold (all engines' gates held)
            pool = quant or "bf16"
            per_layer = {k: line["launches"][k] for k in PER_LAYER_PAGED
                         if line["launches"].get(k)}
            tree = sum(v for k, v in line["design_launches"].items()
                       if k.startswith("whole_step_decode[") and k.endswith("-tree]"))
            check(not per_layer, f"spec {label}: per-layer paged launches {per_layer}")
            check(tree > 0 and all(e.whole_step_spec_on and e.whole_step_fallbacks == 0
                                   for e in engines),
                  f"spec {label}: the fold did not serve the tree steps ({tree} launches, "
                  f"fallbacks {[e.whole_step_fallbacks for e in engines]})")
            launches[f"whole_step_decode[{pool}/tree]"] = (
                launches.get(f"whole_step_decode[{pool}/tree]", 0) + tree)
            emit({"phase": "spec_whole", "path": label, "fold_launches": tree,
                  "spec_tiles": [e.whole_step_spec_tiles for e in engines],
                  "decode_tiles": [e.whole_step_tiles for e in engines],
                  "mixed_tiles": [e.whole_step_mixed_tiles if e.whole_step_mixed_on else None
                                  for e in engines]})
            for stage_line in _fold_stages(label, folds.calls):
                emit(stage_line)
            if quant:
                check(line["launches"].get(f"paged_commit[{quant}]", 0) > 0,
                      f"spec {label}: the commit kernel was never launched")
            else:
                check(line["preemptions"] > 0, f"spec {label}: the 17-page budget caused "
                      "no preemption")
        elif kw.get("kv_layout") == "paged":
            kind = ("fused_rope_paged_attention" if kw.get("fused_decode")
                    else "ragged_paged_attention")
            check(line["launches"].get(f"{kind}[{quant or 'bf16'}]", 0) > 0,
                  f"spec {label}: {kind} was never launched")
            key = f"{kind}[{quant or 'bf16'}/decode]"
            launches[key] = launches.get(key, 0) + line["design_launches"].get(f"{kind}[decode]", 0)
            if quant:
                check(line["launches"].get(f"paged_commit[{quant}]", 0) > 0,
                      f"spec {label}: the commit kernel was never launched")
            else:
                check(line["preemptions"] > 0, f"spec {label}: the 17-page budget caused "
                      "no preemption")
        else:
            # trees of C = W and 1 + W * D rows verify on the small-C design
            check(line["design_launches"].get("verify_attention[rows8]", 0) > 0,
                  f"spec {label}: no tree step took verify's rows8 design")
        if spec_kw.get("verify_skip"):
            # the W = 1 rungs and the verify-skip rows decode
            check(stats.verify_skipped_rounds > 0 and stats.spec_resizes > 0
                  and line["launches"].get("decode_attention", 0) > 0,
                  f"spec {label}: the ladder never reached its W = 1 and verify-skip rows")
        for k, v in line["launches"].items():
            launches[k] = launches.get(k, 0) + v
        t_prof = time.perf_counter()
        emit(profile_slice(llm, prompts, new, f"spec-{label}"))
        if "rope_kv_write" in kw.get("fused_decode", ()):
            with _fused_verify_twin(llm.engine) as twin:
                llm.generate(prompts[:4], max_new_tokens=8)
            emit({"phase": "spec_fused_bitwise", "path": label, "steps": twin.rows})
            check(len(twin.rows) == FUSED_TWIN_STEPS
                  and all(r["logits_bitwise"] and r["pools_bitwise"] for r in twin.rows),
                  f"spec {label}: fused tree verify differs from the unfused step: "
                  f"{twin.rows}")
        served[label] = [r.output_tokens for r in results]
        emit({"phase": "arm_seconds", "path": f"spec-{label}", "serve_s": t_prof - t_arm,
              "profile_s": time.perf_counter() - t_prof})
        _free(llm)
        del ssms

    # the controls: served, not profiled; their launches are not the path's
    for label, kw, spec_kw, draft_layers, _ in SPEC_CONTROLS:
        llm = LLM(llama, cfg, params, device=DEV)
        dcfg, dparams = layer_skip_draft(cfg, params, draft_layers)
        llm.compile(ServingConfig(**kw), ssms=[LLM(llama, dcfg, dparams, device=DEV)],
                    spec=SpecConfig(**spec_kw))
        results, line = _serve(llm, prompts, new)
        emit({"phase": "spec_control", "path": label, "wall_s": line["wall_s"],
              "spec_rounds": llm.rm.stats.spec_rounds,
              "drafted_accept_rate": llm.rm.stats.spec_accept_rate,
              "preemptions": line["preemptions"]})
        served[label] = [r.output_tokens for r in results]
        _free(llm)

    # greedy over the served prefix: the tokens of the arms, the controls
    # and the incremental arm teacher-forced through the kernels="cuda"
    # engine of their layout and pool, then the f32 computation of each
    # pool type (runs that served the same tokens share them)
    t_tf = time.perf_counter()
    R = len(prompts)
    checked = ([(label, kw) for label, kw, _, _ in SPEC_ARMS]
               + [(label, kw) for label, kw, *_ in SPEC_CONTROLS] + [("incremental", {})])
    tf_cuda, tf_sc = {}, {}
    for label, kw in checked:
        sc = {k: v for k, v in kw.items() if k not in ("max_cached_tokens", "kernels")}
        key = (repr(sorted(sc.items())), repr(served[label]))
        if key not in tf_cuda:
            tf_cuda[key] = _next_token_logits(
                cfg, params, ServingConfig(kernels="cuda", max_requests_per_batch=R, **sc),
                prompts, served[label])
        tf_sc[label] = key
    params32 = _to_f32(params)
    del params, llm
    gc.collect()
    torch.cuda.empty_cache()
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    exact, rows = {}, {}
    for label, kw in checked:
        quant = kw.get("kv_quant")
        key = (quant, repr(served[label]))
        if key not in exact:
            pool = dict(kv_layout="paged", kv_quant=quant) if quant else {}
            exact[key] = _next_token_logits(
                cfg32, params32, ServingConfig(kernels="torch", cache_dtype=torch.float32,
                                               max_requests_per_batch=R, **pool),
                prompts, served[label])
        rows[label] = _greedy_over_prefix(label, served[label], tf_cuda[tf_sc[label]],
                                          exact[key])
    control = {a: c for c, *_, arms in SPEC_CONTROLS for a in arms}
    for label, _ in checked:
        extra = {"incremental_near_ties": rows["incremental"]["near_ties"]}
        c = control.get(label)
        if c:
            extra.update(control=c, control_near_ties=rows[c]["near_ties"],
                         tie_factor=SPEC_TIE_FACTOR)
        emit({"phase": "spec_greedy", "path": label, **rows[label], **extra})
        check(not c or rows[label]["near_ties"] <= SPEC_TIE_FACTOR * rows[c]["near_ties"],
              f"spec {label}: {rows[label]['near_ties']} near-ties, over {SPEC_TIE_FACTOR} "
              f"times its control {c}'s")
    del params32, exact, tf_cuda
    gc.collect()
    torch.cuda.empty_cache()
    emit({"phase": "arm_seconds", "path": "spec-greedy-checks",
          "teacher_forced_s": time.perf_counter() - t_tf})
    return launches


# ---------------------------------------------------------------------------
# the serving entry points (slice 13): a local HF checkpoint, streaming, the
# command line

ENTRY_LAYERS = 2
ENTRY_PROMPTS = ([3, 17, 91, 42, 7], [20, 21, 22])
ENTRY_NEW = 8


def _hf_state_dict(cfg, params):
    """The parameters in HF ``LlamaForCausalLM`` naming on the host:
    Linear weights (out, in), one tensor a layer."""
    names = {"wq": "self_attn.q_proj", "wk": "self_attn.k_proj", "wv": "self_attn.v_proj",
             "wo": "self_attn.o_proj", "w1": "mlp.gate_proj", "w2": "mlp.down_proj",
             "w3": "mlp.up_proj"}
    sd = {"model.embed_tokens.weight": params["embed"].cpu(),
          "model.norm.weight": params["final_norm"].cpu(),
          "lm_head.weight": params["lm_head"].t().contiguous().cpu()}
    for i in range(cfg.num_hidden_layers):
        lp = {n: w[i] for n, w in params["layers"].items()}
        sd[f"model.layers.{i}.input_layernorm.weight"] = lp["attn_norm"].cpu()
        sd[f"model.layers.{i}.post_attention_layernorm.weight"] = lp["ffn_norm"].cpu()
        for n, hf in names.items():
            sd[f"model.layers.{i}.{hf}.weight"] = lp[n].t().contiguous().cpu()
    return sd


def _falcon_hf_state_dict(cfg, params):
    """Falcon parameters in HF ``FalconForCausalLM`` naming (the old
    decoder architecture) on the host: Q, K and V fused into one
    ``query_key_value`` weight ([H query heads | KV key heads | KV value
    heads] × dk rows), Linear weights (out, in), one tensor a layer."""
    pre = "transformer."
    sd = {pre + "word_embeddings.weight": params["embed"].cpu(),
          pre + "ln_f.weight": params["final_norm_scale"].cpu(),
          pre + "ln_f.bias": params["final_norm_bias"].cpu(),
          "lm_head.weight": params["lm_head"].t().contiguous().cpu()}
    for i in range(cfg.num_hidden_layers):
        lp = {n: w[i] for n, w in params["layers"].items()}
        h = f"{pre}h.{i}."
        sd[h + "input_layernorm.weight"] = lp["attn_norm_scale"].cpu()
        sd[h + "input_layernorm.bias"] = lp["attn_norm_bias"].cpu()
        sd[h + "self_attention.query_key_value.weight"] = torch.cat(
            [lp["wq"], lp["wk"], lp["wv"]], dim=1).t().contiguous().cpu()
        for ours, hf in (("wo", "self_attention.dense"), ("w_up", "mlp.dense_h_to_4h"),
                         ("w_down", "mlp.dense_4h_to_h")):
            sd[h + hf + ".weight"] = lp[ours].t().contiguous().cpu()
    return sd


def _entry_falcon(seed):
    """The entry points on a generic-decoder family: a Falcon checkpoint in
    HF naming (Falcon-7B widths cut to ENTRY_LAYERS layers, the fused
    ``query_key_value``, random bf16 weights from the seed) served on the
    paged layout through ``LLM.from_pretrained`` (its tensors given back
    bit for bit), ``generate`` and ``generate_stream`` (the same tokens) and
    ``python -m flexflow_tpu_torch serve --kv-layout paged`` (exit 0, the
    same tokens)."""
    cfg = falcon.falcon_7b(num_hidden_layers=ENTRY_LAYERS)
    gen = torch.Generator(device=DEV)
    gen.manual_seed(seed + 17)
    params = falcon.init_params(gen, cfg, device=DEV)
    d = tempfile.mkdtemp(prefix="flexflow_tpu_torch_entry_falcon_")
    try:
        with open(os.path.join(d, "config.json"), "w") as f:
            json.dump({"model_type": "falcon", "architectures": ["FalconForCausalLM"],
                       "vocab_size": cfg.vocab_size, "hidden_size": cfg.hidden_size,
                       "ffn_hidden_size": cfg.intermediate_size,
                       "num_hidden_layers": cfg.num_hidden_layers,
                       "num_attention_heads": cfg.num_attention_heads, "multi_query": True,
                       "new_decoder_architecture": False, "parallel_attn": True,
                       "bias": False, "alibi": False, "layer_norm_epsilon": cfg.norm_eps,
                       "tie_word_embeddings": False, "torch_dtype": "bfloat16"}, f)
        torch.save(_falcon_hf_state_dict(cfg, params), os.path.join(d, "pytorch_model.bin"))
        llm = LLM.from_pretrained(d, device=DEV)
        check(llm.family is falcon and llm.cfg == cfg,
              f"from_pretrained(falcon): family {llm.family.__name__}, config {llm.cfg}")
        got = dict(llm.params, **{f"layers.{k}": v for k, v in llm.params["layers"].items()})
        want = dict(params, **{f"layers.{k}": v for k, v in params["layers"].items()})
        same = {k: bool(got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]))
                for k in want if k != "layers"}
        check(all(same.values()), f"from_pretrained(falcon): tensors not bitwise {same}")
        del params
        llm.compile(ServingConfig(max_requests_per_batch=4, max_sequence_length=512,
                                  kv_layout="paged"))
        prompts = [list(p) for p in ENTRY_PROMPTS]
        K.reset_launch_counts()
        tokens = [r.output_tokens for r in llm.generate(prompts, max_new_tokens=ENTRY_NEW)]
        check(K.LAUNCHES["ragged_paged_attention[bf16]"] > 0,
              "entry(falcon): generate launched no paged kernel")
        streamed = {}
        for ev in llm.rm.generate_stream(prompts, max_new_tokens=ENTRY_NEW):
            if not ev.done:
                streamed.setdefault(ev.request_id, []).append(ev.token)
        check([streamed[r] for r in sorted(streamed)] == tokens,
              f"entry(falcon): generate_stream {streamed} != generate {tokens}")
        _free(llm)
        cmd = [sys.executable, "-m", "flexflow_tpu_torch", "serve", "--model-dir", d,
               "--kv-layout", "paged", "--max-new-tokens", str(ENTRY_NEW)]
        for p in ENTRY_PROMPTS:
            cmd += ["--prompt", ",".join(map(str, p))]
        out = subprocess.run(cmd, cwd=os.path.dirname(os.path.abspath(__file__)),
                             capture_output=True, text=True, timeout=600)
        check(out.returncode == 0,
              f"entry(falcon): serve exited {out.returncode}: {out.stderr[-2000:]}")
        cli = [json.loads(line) for line in out.stdout.strip().splitlines()[0::2]]
        check(cli == tokens, f"entry(falcon): serve printed {cli}, generate gave {tokens}")
        emit({"phase": "entry", "model": "falcon", "layers": ENTRY_LAYERS,
              "tensors_bitwise": len(same), "tokens": tokens})
    finally:
        shutil.rmtree(d, ignore_errors=True)


def phase_entry(seed):
    """The serving entry points on the card: a checkpoint in HF naming
    (``config.json`` and ``pytorch_model.bin``, LLaMA-7B widths cut to
    ENTRY_LAYERS layers, random bf16 weights from the seed) written to a
    temporary directory; ``LLM.from_pretrained`` must give back those
    tensors bit for bit, ``generate`` and ``rm.generate_stream`` the same
    tokens, and ``python -m flexflow_tpu_torch serve --model-dir ...`` in a
    subprocess must exit 0 and print them. No ``transformers`` or
    ``safetensors`` is needed."""
    cfg = llama.LLaMAConfig.llama_7b(num_hidden_layers=ENTRY_LAYERS)
    gen = torch.Generator(device=DEV)
    gen.manual_seed(seed + 13)
    params = llama.init_params(gen, cfg, device=DEV)
    d = tempfile.mkdtemp(prefix="flexflow_tpu_torch_entry_")
    try:
        t0 = time.perf_counter()
        with open(os.path.join(d, "config.json"), "w") as f:
            json.dump({"model_type": "llama", "architectures": ["LlamaForCausalLM"],
                       "vocab_size": cfg.vocab_size, "hidden_size": cfg.hidden_size,
                       "intermediate_size": cfg.intermediate_size,
                       "num_hidden_layers": cfg.num_hidden_layers,
                       "num_attention_heads": cfg.num_attention_heads,
                       "num_key_value_heads": cfg.num_key_value_heads,
                       "rms_norm_eps": cfg.rms_norm_eps, "rope_theta": cfg.rope_theta,
                       "max_position_embeddings": cfg.max_position_embeddings,
                       "tie_word_embeddings": False, "torch_dtype": "bfloat16"}, f)
        torch.save(_hf_state_dict(cfg, params), os.path.join(d, "pytorch_model.bin"))
        ckpt_bytes = os.path.getsize(os.path.join(d, "pytorch_model.bin"))
        t_write = time.perf_counter() - t0
        t0 = time.perf_counter()
        llm = LLM.from_pretrained(d, device=DEV)
        t_load = time.perf_counter() - t0
        got = dict(llm.params, **{f"layers.{k}": v for k, v in llm.params["layers"].items()})
        want = dict(params, **{f"layers.{k}": v for k, v in params["layers"].items()})
        same = {k: bool(got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]))
                for k in want if k != "layers"}
        check(all(same.values()), f"from_pretrained: tensors not bitwise the written ones {same}")
        check(llm.cfg == cfg, f"from_pretrained: config {llm.cfg}, written {cfg}")
        # no tokenizer files: no tokenizer, and nothing of transformers or
        # safetensors loaded
        loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("transformers",
                                                                        "safetensors"))
        check(llm.tokenizer is None and not loaded,
              f"from_pretrained: tokenizer {type(llm.tokenizer)}, loaded {loaded[:5]}")
        del params
        serving = ServingConfig(max_requests_per_batch=4, max_sequence_length=512)
        llm.compile(serving)
        prompts = [list(p) for p in ENTRY_PROMPTS]
        K.reset_launch_counts()
        tokens = [r.output_tokens for r in llm.generate(prompts, max_new_tokens=ENTRY_NEW)]
        check(K.LAUNCHES["decode_attention"] > 0, "entry: generate launched no decode kernel")
        events = list(llm.rm.generate_stream(prompts, max_new_tokens=ENTRY_NEW))
        streamed, done = {}, []
        for ev in events:
            check(ev.request_id not in done, f"entry: an event after request "
                  f"{ev.request_id}'s terminal event")
            if ev.done:
                check(ev.error is None, f"entry: request {ev.request_id} failed: {ev.error}")
                done.append(ev.request_id)
            else:
                streamed.setdefault(ev.request_id, []).append(ev.token)
        check([streamed.get(r, []) for r in sorted(done)] == tokens and len(done) == len(prompts),
              f"entry: generate_stream {streamed} != generate {tokens}")
        llm.engine = llm.rm = None
        del llm
        gc.collect()
        torch.cuda.empty_cache()
        cmd = [sys.executable, "-m", "flexflow_tpu_torch", "serve", "--model-dir", d,
               "--max-new-tokens", str(ENTRY_NEW)]
        for p in ENTRY_PROMPTS:
            cmd += ["--prompt", ",".join(map(str, p))]
        t0 = time.perf_counter()
        out = subprocess.run(cmd, cwd=os.path.dirname(os.path.abspath(__file__)),
                             capture_output=True, text=True, timeout=600)
        t_cli = time.perf_counter() - t0
        check(out.returncode == 0, f"entry: serve exited {out.returncode}: {out.stderr[-2000:]}")
        lines = out.stdout.strip().splitlines()
        cli = [json.loads(line) for line in lines[0::2]]
        check(cli == tokens, f"entry: serve printed {cli}, generate gave {tokens}")
        emit({"phase": "entry", "layers": ENTRY_LAYERS, "checkpoint_bytes": ckpt_bytes,
              "write_s": t_write, "from_pretrained_s": t_load, "tensors_bitwise": len(same),
              "tokens": tokens, "stream_events": len(events), "serve_cli_s": t_cli,
              "serve_cli_profile_lines": lines[1::2]})
    finally:
        shutil.rmtree(d, ignore_errors=True)
    _entry_falcon(seed)


# ---------------------------------------------------------------------------
# the generic decoder and the other families: Falcon-7B at full
# depth on the paged slice's traffic, and ten more families at their
# published widths cut to two layers, through the paged kernels at their
# head dims (64, 80, 128, 256) and MQA widths (G = 71, 48)

# the Falcon-7B slice's depth: its width cut to 4 of its 32 layers (its
# five arms took ~140 s of a 1158 s run at full depth with the quant,
# offload and cluster phases)
FALCON_LAYERS = 4
# arms of the Falcon-7B slice: (label, kv_quant, fused_decode)
FALCON_ARMS = (("bf16", None, ()), ("bf16-fused", None, ("rope_kv_write",)),
               ("int8-fused", "int8", ("rope_kv_write",)))
# its whole-step arms (slice 16): the generic body, one kernel a step
FALCON_WHOLE_ARMS = (("bf16-whole", None, ("whole_step",)),
                     ("int8-whole", "int8", ("whole_step",)))
# the ten families at their published widths cut to FAMILY_LAYERS layers
# (depth the only cut): (label, family module, preset)
FAMILY_LAYERS = 2
FAMILY_CHECKS = (("opt-6.7b", opt, opt.opt_6_7b), ("starcoder-15b", starcoder,
                                                   starcoder.starcoder_15b),
                 ("qwen2-7b", qwen2, qwen2.qwen2_7b), ("mistral-7b", mistral, mistral.mistral_7b),
                 ("mixtral-8x7b", mixtral, mixtral.mixtral_8x7b),
                 ("qwen1.5-moe-a2.7b", qwen2_moe, qwen2_moe.config),
                 ("gemma-7b", gemma, gemma.gemma_7b), ("phi-2", phi, phi.phi_2),
                 ("gpt2-xl", gpt2, gpt2.gpt2_xl), ("mpt-7b", mpt, mpt.mpt_7b))
# their arms: bf16 pages on the ragged kernel, int8 pages on the fused
# kernel; at head dims 80 and 256 also int8 pages with the commit kernel
FAMILY_ARMS = (("bf16", None, ()), ("int8-fused", "int8", ("rope_kv_write",)))
FAMILY_COMMIT_ARM = (("int8", "int8", ()),)
# the whole step's arm of every family that takes it (slice 16); the
# others raise at construction, with the JAX package's reason
FAMILY_WHOLE_ARM = (("bf16-whole", None, ("whole_step",)),)
WHOLE_REFUSED = {"mistral-7b": "ALiBi / sliding-window", "mixtral-8x7b": "mixture-of-experts",
                 "qwen1.5-moe-a2.7b": "mixture-of-experts", "mpt-7b": "ALiBi / sliding-window"}
FAMILY_PROMPT_LENS = (1000, 16, 300, 700)
FAMILY_NEW = 16
# Mistral's published window (4096) masks lines only past 4096 tokens: its
# prompts cross it in a cache of 4608 + 64 lines
MISTRAL_PROMPT_LENS = (4500, 16, 4200, 700)
MISTRAL_MAX_SEQ = 4608
FAMILY_SLOTS = 4


class _count_mqa_decode:
    """Within it, each kernels="cuda" paged attention call of one query
    token a slot (a decode step) counts in ``self.calls`` by kernel name:
    the MQA decode launches (C * G > 8) that DESIGN_LAUNCHES counts under
    "mma" beside the mixed steps."""

    NAMES = ("ragged_paged_attention", "fused_rope_paged_attention")

    def __init__(self):
        self.calls = dict.fromkeys(self.NAMES, 0)

    def __enter__(self):
        self.orig = {}
        for name in self.NAMES:
            fn = self.orig[name] = getattr(K, name)

            def wrapped(q, *a, _name=name, _fn=fn, **kw):
                if q.device.type == DEV.type and q.shape[1] == 1:
                    self.calls[_name] += 1
                return _fn(q, *a, **kw)
            setattr(K, name, wrapped)
        return self

    def __exit__(self, *exc):
        for name, fn in self.orig.items():
            setattr(K, name, fn)


def _family_prompts(seed, vocab, lens):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, vocab, size=int(n)).tolist() for n in lens]


def _gb(n):
    return round(n / 2 ** 30, 3)


def _first_step_rule(label, first):
    """The first step's logits (each request's last prompt position) of
    the kernels path within bf16's own error of the plain path: their
    relative L2 distance at most SLICE_PATHS times the plain path's from
    the same computation in f32."""
    d = {"cuda_vs_torch": float((first["cuda"] - first["torch"]).norm()
                                / first["torch"].norm()),
         "torch_vs_f32": float((first["torch"] - first["f32"]).norm() / first["f32"].norm())}
    check(d["cuda_vs_torch"] <= SLICE_PATHS * d["torch_vs_f32"],
          f"{label}: first-step logits {d}")
    return d


class _FamilyArm:
    """One arm of the families phase: LLM.generate with kernels="cuda"
    (measured by ``_serve``, inside the context ``during``), then its
    served sequences teacher-forced through the arm's kernels="cuda" and
    kernels="torch" engines (host logits kept); :meth:`hold` adds the f32
    run and the rules, once the f32 weights exist (after every arm of the
    model has served, so that they do not count in the arms' peaks)."""

    def __init__(self, label, family, cfg, params, serving, prompts, new,
                 during=contextlib.nullcontext(), after=None):
        self.label, self.family, self.cfg, self.prompts = label, family, cfg, prompts
        t0 = time.perf_counter()
        llm = LLM(family, cfg, params, device=DEV)
        llm.compile(serving)
        with during:
            results, self.line = _serve(llm, prompts, new)
        self.line["plain_attention_steps"] = llm.engine.plain_attention_steps
        # ``after(llm)``: more of the arm's figures, outside the measured run
        self.extra = after(llm) if after is not None else {}
        _free(llm)
        t1 = time.perf_counter()
        self.sc = dataclasses.replace(serving, max_requests_per_batch=len(prompts))
        self.outputs = [r.output_tokens for r in results]
        self.seqs = [p + o[:-1] for p, o in zip(prompts, self.outputs)]
        self.steps = {k: self._forced(params, dataclasses.replace(self.sc, kernels=k), cfg)
                      for k in ("cuda", "torch")}
        self.line["seconds"] = {"serve": t1 - t0, "teacher_forced": time.perf_counter() - t1}

    def _forced(self, params, sc, cfg):
        return _teacher_forced_logits(cfg, params, sc, self.seqs,
                                      [len(p) for p in self.prompts], self.family)

    def hold(self, params32):
        """The arm against its kernels="torch" twin: the teacher-forced
        logits under slice 1's rule (``_hold_to_plain``), the first step's
        logits within bf16's own error (``_first_step_rule``), and each
        served token greedy over its prefix under the arm's own
        teacher-forced logits or at a near-tie (``_greedy_over_prefix``,
        the spec phase's rule: a mixture of experts' router may part two
        bf16 paths at a near-tie of its own, which no logit gap shows).
        Returns the arm's line."""
        cfg32 = dataclasses.replace(self.cfg, dtype=torch.float32)
        self.steps["f32"] = self._forced(
            params32, dataclasses.replace(self.sc, kernels="torch",
                                          cache_dtype=torch.float32), cfg32)
        _hold_to_plain(self.label, self.steps["cuda"], self.steps["torch"], self.steps["f32"])
        nxt = {k: _next_rows(v, self.prompts, self.outputs, self.sc.prefill_chunk)
               for k, v in self.steps.items()}
        self.line.update(tokens=_greedy_over_prefix(self.label, self.outputs, nxt["cuda"],
                                                    nxt["f32"]),
                         first_step=_first_step_rule(self.label,
                                                     {k: v[:, 0] for k, v in nxt.items()}),
                         peak_memory_gb=_gb(self.line.pop("peak_memory_bytes")))
        self.steps = None
        return self.line


def _steps_of(line):
    return sum(line["steps"].values())


def _whole_info(llm, seed=None, stages=None):
    """A whole-step arm's gate (tile counts, priced bytes, fallbacks, the
    mixed step on the kernel) and, with ``stages``, a stamped decode step
    at full depth (:func:`whole_stages_full_depth`, that case label)."""
    eng = llm.engine
    info = {"tiles": eng.whole_step_tiles, "mixed_tiles": eng.whole_step_mixed_tiles,
            "smem_est": eng.whole_step_smem_est, "fallbacks": llm.rm.stats.whole_step_fallbacks,
            "mixed_on": eng.whole_step_mixed_on}
    if stages is not None:
        info["stages"] = whole_stages_full_depth(llm, seed, stages)
    return info


def _check_whole_arm(label, line, extra, pool, designs):
    """A whole-step arm ran the kernel on every step: its launches on
    ``pool``, no paged attention kernel, no gate fallback, the mixed step
    on the kernel, and the attention designs ``designs`` (a set of
    ``whole_step_decode[<design>]``) and no other. Returns its launches."""
    n = line["launches"].get(f"whole_step_decode[{pool}]", 0)
    check(n > 0, f"{label}: whole_step_decode[{pool}] was never launched ({line['launches']})")
    paged = [k for k in line["launches"] if k.split("[")[0] in K.PAGED_KERNELS]
    check(not paged, f"{label}: paged attention kernels ran: {paged}")
    check(extra["fallbacks"] == 0 and extra["mixed_on"],
          f"{label}: the whole-step gate fell back ({extra})")
    took = {k for k in line["design_launches"] if k.startswith("whole_step_decode[")}
    check(took == designs, f"{label}: the whole step's attention took {took}, want {designs}")
    return n


def phase_families(seed):
    """Falcon-7B at FALCON_LAYERS layers (width 4544, 71 heads on one KV
    head, random bf16 weights from the seed, made on the card) serving the
    paged slice's 8 requests in FALCON_ARMS, then the ten FAMILY_CHECKS at
    two layers in their FAMILY_ARMS on FAMILY_PROMPT_LENS (Mistral's
    crossing its window). Every arm is held to its kernels="torch" twin
    (``_FamilyArm.hold``); every family's kernels must launch, MPT's ALiBi
    batches none (each of its steps counted on the plain path). Returns
    the launches by the kernels line's rows."""
    launches = {}

    def add(key, n):
        launches[key] = launches.get(key, 0) + n

    def weights(family, cfg, offset):
        t0 = time.perf_counter()
        gen = torch.Generator(device=DEV)
        gen.manual_seed(seed + offset)
        params = family.init_params(gen, cfg, device=DEV)
        torch.cuda.synchronize()
        return params, time.perf_counter() - t0

    # Falcon-7B: MQA decode on the tensor-core tile; its whole step (G =
    # 71: every step's attention on the tile, "mma")
    t_model = time.perf_counter()
    cfg = falcon.falcon_7b(num_hidden_layers=FALCON_LAYERS)
    params, init_s = weights(falcon, cfg, 21)
    prompts, new = _slice_prompts(seed, cfg)
    arms = []
    for label, quant, fused in FALCON_ARMS + FALCON_WHOLE_ARMS:
        mqa = _count_mqa_decode()
        after = None
        if "whole_step" in fused:
            after = functools.partial(_whole_info, seed=seed, stages=(
                f"falcon-7b-{label}-decode-{FALCON_LAYERS}-layers" if quant is None
                else None))
        arm = _FamilyArm(f"falcon-7b-{label}", falcon, cfg, params,
                         ServingConfig(kv_layout="paged", kv_quant=quant, fused_decode=fused),
                         prompts, new, during=mqa, after=after)
        arms.append((label, quant, fused, arm, mqa.calls))
    params32 = _to_f32(params)
    del params
    for label, quant, fused, arm, calls in arms:
        line = arm.hold(params32)
        extra = arm.extra
        stages = extra.pop("stages", None)
        emit({"phase": "families", "model": "falcon_7b", "arm": label,
              "layers": cfg.num_hidden_layers, "init_s": init_s, "kv_quant": quant,
              "fused_decode": list(fused), "mqa_decode_launches": calls, **extra, **line})
        if stages is not None:
            emit(stages)
        if "whole_step" in fused:
            add("whole_step_decode[falcon-7b]", _check_whole_arm(
                f"falcon-7b-{label}", line, extra, quant or "bf16", {"whole_step_decode[mma]"}))
            continue
        kind = "fused_rope_paged_attention" if fused else "ragged_paged_attention"
        check(calls[kind] > 0 and line["design_launches"].get(f"{kind}[decode]", 0) == 0,
              f"falcon-7b-{label}: MQA decode not on the tensor-core tile "
              f"({calls}, {line['design_launches']})")
        add(f"{kind}[mqa-g71]", calls[kind])
    del params32, arms
    gc.collect()
    torch.cuda.empty_cache()
    emit({"phase": "families_seconds", "model": "falcon_7b",
          "seconds": time.perf_counter() - t_model})

    # ten families at published widths, two layers
    group = {80: "dk80", 256: "dk256"}
    for label, family, preset in FAMILY_CHECKS:
        t_model = time.perf_counter()
        cfg = preset(num_hidden_layers=FAMILY_LAYERS)
        params, init_s = weights(family, cfg, 22)
        mistral_like = cfg.sliding_window > 0
        lens = MISTRAL_PROMPT_LENS if mistral_like else FAMILY_PROMPT_LENS
        prompts = _family_prompts(seed, cfg.vocab_size, lens)
        base = dict(kv_layout="paged", max_requests_per_batch=FAMILY_SLOTS)
        if mistral_like:
            base["max_sequence_length"] = MISTRAL_MAX_SEQ
        # the commit kernel's rows need int8 pages unfused at dk 80 and 256;
        # the whole step serves every family whose layout it takes
        fam_arms = (FAMILY_ARMS + (FAMILY_COMMIT_ARM if cfg.head_dim in group else ())
                    + (FAMILY_WHOLE_ARM if label not in WHOLE_REFUSED else ()))
        arms = [(arm, quant, fused,
                 _FamilyArm(f"{label}-{arm}", family, cfg, params,
                            ServingConfig(kv_quant=quant, fused_decode=fused, **base),
                            prompts, FAMILY_NEW,
                            after=_whole_info if "whole_step" in fused else None))
                for arm, quant, fused in fam_arms]
        params32 = _to_f32(params)
        del params
        if label in WHOLE_REFUSED:
            # the whole step raises at construction, before any allocation
            try:
                InferenceEngine(family, cfg, params32, ServingConfig(
                    fused_decode=("whole_step",), **base), device=DEV)
                refused = None
            except ValueError as err:
                refused = str(err)
            emit({"phase": "families_whole_refused", "model": label, "reason": refused})
            check(refused is not None and refused.startswith(
                f"whole_step is not composed with {WHOLE_REFUSED[label]}"),
                f"{label}: fused_decode=('whole_step',) was not refused: {refused}")
        for arm_label, quant, fused, arm in arms:
            line = arm.hold(params32)
            emit({"phase": "families", "model": label, "arm": arm_label,
                  "layers": FAMILY_LAYERS, "head_dim": cfg.head_dim,
                  "heads": cfg.num_attention_heads, "kv_heads": cfg.num_key_value_heads,
                  "init_s": init_s, "kv_quant": quant, "fused_decode": list(fused),
                  **arm.extra, **line})
            if "whole_step" in fused:
                G = cfg.num_attention_heads // cfg.num_key_value_heads
                add(f"whole_step_decode[{label}]", _check_whole_arm(
                    f"{label}-{arm_label}", line, arm.extra, "bf16",
                    {"whole_step_decode[mma]"} | (
                        {"whole_step_decode[decode]"} if G <= K.DECODE_ROWS else set())))
                continue
            kind = "fused_rope_paged_attention" if fused else "ragged_paged_attention"
            used = {k: v for k, v in line["launches"].items()
                    if k.split("[")[0] in K.PAGED_KERNELS + ("paged_commit",)}
            if cfg.positions == "alibi":
                # no kernel takes the additive bias: every step on the plain path
                check(not used and line["plain_attention_steps"] == _steps_of(line),
                      f"{label}-{arm_label}: ALiBi launches {used}, plain steps "
                      f"{line['plain_attention_steps']} of {_steps_of(line)}")
                continue
            check(line["launches"].get(f"{kind}[{quant or 'bf16'}]", 0) > 0
                  and line["plain_attention_steps"] == 0,
                  f"{label}-{arm_label}: {kind} not launched ({line['launches']})")
            if quant and not fused:
                check(line["launches"].get(f"paged_commit[{quant}]", 0) > 0,
                      f"{label}-{arm_label}: the commit kernel was never launched")
            if cfg.head_dim in group:
                for k, v in used.items():
                    add(f"{k.split('[')[0]}[{group[cfg.head_dim]}]", v)
        if mistral_like:
            # the window binds: the same weights with no window give the
            # 4500-token prompt's last prefill chunk other logits
            sc = ServingConfig(kernels="torch", cache_dtype=torch.float32, kv_layout="paged",
                               max_requests_per_batch=len(prompts),
                               max_sequence_length=MISTRAL_MAX_SEQ)
            last = [_teacher_forced_logits(dataclasses.replace(cfg, dtype=torch.float32,
                                                               sliding_window=w),
                                           params32, sc, prompts, list(lens), family)[-1]
                    for w in (cfg.sliding_window, 0)]
            diff = float((last[0] - last[1]).norm() / last[1].norm())
            emit({"phase": "families_window", "model": label, "window": cfg.sliding_window,
                  "prompt_lens": list(lens), "last_chunk_rel_diff_vs_no_window": diff})
            check(diff > 1e-5, f"{label}: the window masked no line ({diff})")
        del params32, arms
        gc.collect()
        torch.cuda.empty_cache()
        emit({"phase": "families_seconds", "model": label,
              "seconds": time.perf_counter() - t_model})
    return launches


# ---------------------------------------------------------------------------
# prefix caching and the host tier (slice 14): no new kernel; a hit gives the
# paged and whole-step kernels rows that start mid-sequence over spliced and
# copied pages

PREFIX_SYSTEM = 1000   # tokens of the shared system prompt
PREFIX_OWN = 64        # tokens of each request's own after it
PREFIX_REQUESTS = 32
PREFIX_NEW = 32
PREFIX_SERVE = dict(kv_layout="paged", page_size=128, prefill_chunk=128,
                    max_requests_per_batch=16)
# arms at full width and depth: (label, ServingConfig fields, SpecConfig
# fields or None, layers of the layer-skip SSM); each against its cold twin,
# the same engine with caching off. The pool is every slot's worst case:
# no pressure.
PREFIX_ARMS = (
    ("prefix-bf16", dict(prefix_caching=True), None, None),
    ("prefix-int8-fused", dict(prefix_caching=True, kv_quant="int8",
                               fused_decode=("rope_kv_write",), cache_policy="prefill"),
     None, None),
    ("prefix-whole-bf16", dict(prefix_caching=True, fused_decode=("whole_step",)), None, None),
    ("prefix-spec-int8-whole", dict(prefix_caching=True, kv_quant="int8",
                                    fused_decode=("whole_step",)),
     dict(beam_width=2, beam_depth=3), 2),
)
# the host arm: 4 families of system prompt, 4 requests of a family after
# another's (8 slots: two families live at a time), a pool of the live
# slots' worst case plus 12 pages (int4): the first wave's two families
# spill while the next two prefill cold, and come back as host hits. Its
# sequences (1096 lines) fit max_sequence_length 1200, which keeps one
# slot's worst case (the pool's floor) under that pool.
PREFIX_HOST_FAMILIES = 4
PREFIX_HOST_BLOCK = 4
PREFIX_HOST_SERVE = dict(kv_layout="paged", page_size=128, prefill_chunk=128,
                         max_requests_per_batch=8, max_sequence_length=1200, kv_quant="int4",
                         prefix_caching=True)
PREFIX_HOST_SPARE = 4
# the f32 sub-check: 2 layers, 8 requests, a 256-token system prompt a family
PREFIX_F32_SERVE = dict(kv_layout="paged", page_size=128, prefill_chunk=128,
                        max_requests_per_batch=8, max_sequence_length=512,
                        cache_dtype=torch.float32)


def _prefix_prompts(rng, cfg, systems, n, own, block=1):
    """``n`` requests round-robin over the ``systems`` prompts, ``block``
    requests at a time, each with ``own`` tokens of its own after it."""
    return [systems[i // block % len(systems)]
            + rng.integers(1, cfg.vocab_size, size=own).tolist() for i in range(n)]


def _quant_budget(cfg, serve, pages):
    """The max_cached_tokens whose pool (priced at cache_dtype, converted
    to quantized pages) holds at least ``pages`` pages."""
    sc = ServingConfig(**serve)
    if sc.kv_quant is None:
        return pages * sc.page_size
    item = torch.empty((), dtype=sc.cache_dtype).element_size()
    n = sc.pages_per_slot
    while KQ.quantized_pool_pages(n, sc.page_size, cfg.num_key_value_heads, cfg.head_dim,
                                  item, KQ.resolve_spec(sc.kv_quant)) < pages:
        n += 1
    return n * sc.page_size


def _audit_pools(rm):
    """No page leaks on any engine of the manager, after its drain: every
    refcount is its table references plus its radix tree's."""
    rm.drain()
    caches = rm._prefix_caches() or [None] * len(rm._engines())
    for eng, pc in zip(rm._engines(), caches):
        eng.pager.check_no_leaks(external=pc.page_refs() if pc else None)


def _prefix_figures(results, line, stats, wave, num_pages):
    """An arm's figures: _serve's line, the TTFT of the second wave
    (requests ``wave`` on) and of all, the cache's counters and the pool's
    pages."""
    def summary(xs):
        return {"mean": statistics.mean(xs), "p50": statistics.median(xs), "max": max(xs)}

    ttft = [r.profile.ttft_s for r in results]
    return {"tokens_per_s": line["tokens_per_s"], "wall_s": line["wall_s"],
            "ttft_s": summary(ttft), "ttft_s_second_wave": summary(ttft[wave:]),
            "prefill_tokens": stats.prefill_tokens,
            **{k: getattr(stats, k) for k in (
                "prefix_hits", "prefix_misses", "prefix_hit_tokens", "prefix_cows",
                "prefix_evictions", "spills", "readmits", "host_hit_tokens", "host_bytes",
                "preemptions")},
            "decode_dispatch_ms_p50": line["decode_dispatch_ms"]["p50"],
            "peak_gb": line["peak_memory_bytes"] / 1e9, "num_pages": num_pages,
            "launches": line["launches"], "design_launches": line["design_launches"]}


def _first_row(llm, prompt):
    """The logits of ``prompt``'s first sampled token through the
    manager's serving step (a hit starts its prefill at the matched
    length)."""
    rec = _record_steps(llm.engine)
    try:
        res = llm.generate([prompt], max_new_tokens=1)[0]
    finally:
        del llm.engine.run_mixed
    return rec[(0, len(prompt) - 1)], res.profile.cached_prefix_len


def _prefix_arm(cfg, params, serve, spec_kw, draft_layers, prompts, new, wave, probes=()):
    """One served run of ``prompts`` through a fresh manager of these
    fields; returns (llm, tokens, figures, each of ``probes``' first-row
    logits and matched length, run in turn after the measured run)."""
    llm = LLM(llama, cfg, params, device=DEV)
    ssms = []
    if draft_layers:
        dcfg, dparams = layer_skip_draft(cfg, params, draft_layers)
        ssms = [LLM(llama, dcfg, dparams, device=DEV)]
    llm.compile(ServingConfig(**serve), ssms=ssms,
                spec=SpecConfig(**spec_kw) if spec_kw else None)
    results, line = _serve(llm, prompts, new)
    fig = _prefix_figures(results, line, llm.rm.stats, wave, llm.engine.pager.num_pages)
    _audit_pools(llm.rm)
    rows = [_first_row(llm, probe) for probe in probes]
    _audit_pools(llm.rm)
    return llm, [r.output_tokens for r in results], fig, rows


def _tokens_explained(label, cfg, params, serve, prompts, got, want):
    """Warm tokens against the cold twin's: equal, or the warm tokens of
    each request that parts held to :func:`_greedy_over_prefix`
    (teacher-forced through the arm's kernels="cuda" engine, the f32
    computation of its pool as the yardstick). Returns the line's entry."""
    differ = [i for i, (a, b) in enumerate(zip(got, want)) if a != b]
    if not differ:
        return {"tokens_equal": True}
    layout = {k: v for k, v in serve.items()
              if k in ("kv_layout", "kv_quant", "page_size", "prefill_chunk", "fused_decode")}
    quant = serve.get("kv_quant")
    pool = dict(kv_layout="paged", kv_quant=quant) if quant else {}
    rows = []
    for j in range(0, len(differ), 8):  # eight requests a teacher-forced run
        part = differ[j:j + 8]
        sub, served = [prompts[i] for i in part], [got[i] for i in part]
        tf = _next_token_logits(cfg, params, ServingConfig(
            kernels="cuda", max_requests_per_batch=len(sub), **layout), sub, served)
        params32 = _to_f32(params)
        exact = _next_token_logits(dataclasses.replace(cfg, dtype=torch.float32), params32,
                                   ServingConfig(kernels="torch", cache_dtype=torch.float32,
                                                 max_requests_per_batch=len(sub), **pool),
                                   sub, served)
        rows.append(_greedy_over_prefix(label, served, tf, exact))
        del params32, tf, exact
        gc.collect()
        torch.cuda.empty_cache()
    return {"tokens_equal": False, "requests_parted": differ,
            "first_parting": [next(k for k, (x, y) in enumerate(zip(got[i], want[i])) if x != y)
                              for i in differ], "greedy_over_prefix": rows}


def _movers(eng):
    """The host tier's page movers on one page of ``eng``'s pool: copy_page
    against its byte bound, fetch_page issued and landed (after the
    harvest), upload_page, and the page spilled then uploaded byte for
    byte."""
    nbytes = eng.page_host_bytes()
    src, a, b = (eng.pager.claim_free_page() for _ in range(3))
    gen = torch.Generator(device=DEV).manual_seed(1)
    for t in eng.cache.values():  # a page of random bytes
        t[:, src].view(torch.uint8).copy_(torch.randint(
            0, 256, t[:, src].view(torch.uint8).shape, generator=gen, device=DEV,
            dtype=torch.uint8))
    copy_ms = cuda_ms(lambda: eng.copy_page(src, a))
    eng.fetch_page(a).host_values()  # the pinned host allocator's first blocks
    times = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        spill = eng.fetch_page(a)
        t1 = time.perf_counter()
        host = spill.host_values()
        times.append((t1 - t0, time.perf_counter() - t0))
    issue_ms = statistics.median(t for t, _ in times) * 1e3
    land_ms = statistics.median(t for _, t in times) * 1e3
    upload_ms = cuda_ms(lambda: eng.upload_page(b, host))
    before = {k: t[:, a].clone() for k, t in eng.cache.items()}
    spill = eng.fetch_page(a)
    eng.copy_page(b, a)      # the page is reused before the harvest
    eng.upload_page(a, spill.host_values())
    same = all(torch.equal(t[:, a].view(torch.uint8), before[k].view(torch.uint8))
               for k, t in eng.cache.items())
    for page in (src, a, b):
        eng.pager.release_ref(page)
    torch.cuda.synchronize()
    return {"page_bytes": nbytes, "copy_page_ms": copy_ms,
            "copy_page_bound_ms": 2 * nbytes / HBM_BYTES_PER_S * 1e3,
            "fetch_issue_ms": issue_ms, "fetch_land_ms": land_ms, "upload_page_ms": upload_ms,
            "d2h_gb_s": nbytes / land_ms / 1e6, "h2d_gb_s": nbytes / upload_ms / 1e6,
            "spill_upload_byte_equal": same}


def _check_arm(label, serve, fig, cold, cold_prefill):
    """The warm arm's checks against its twin (``cold``): hits, fewer
    prefill tokens than a cold run's ``cold_prefill`` by at least its hit
    tokens, and the kernels of both runs launched (whole-step arms: no
    per-layer paged attention)."""
    check(fig["prefix_hits"] > 0 and fig["prefix_hit_tokens"] > 0, f"{label}: no cache hit")
    check(fig["prefill_tokens"] <= cold_prefill - fig["prefix_hit_tokens"],
          f"{label}: {fig['prefill_tokens']} prefill tokens, cold {cold_prefill} less "
          f"{fig['prefix_hit_tokens']} hit tokens")
    pool = serve.get("kv_quant") or "bf16"
    fused = serve.get("fused_decode", ())
    kind = ("whole_step_decode" if "whole_step" in fused else "fused_rope_paged_attention"
            if fused else "ragged_paged_attention")
    for f in (fig, cold):
        check(f["launches"].get(f"{kind}[{pool}]", 0) > 0, f"{label}: {kind}[{pool}] never ran")
        if "whole_step" in fused:
            per_layer = [k for k in f["launches"] if k in PER_LAYER_PAGED]
            check(not per_layer, f"{label}: per-layer paged launches {per_layer}")
        if pool != "bf16" and "whole_step" not in fused and not fused:
            check(f["launches"].get(f"paged_commit[{pool}]", 0) > 0,
                  f"{label}: paged_commit[{pool}] never ran")


def _prefix_f32(seed):
    """2 layers, f32, 8 requests: cold, warm and spilled-then-re-admitted
    runs of one family of prompts give equal tokens on f32, int8 and int4
    pools, unfused, rope_kv_write and whole_step, and for SpecInfer with
    an SSM on whole-step engines; each run equals its kernels="torch" twin
    (int4 within the f32 phase's tie rule, :func:`_divergence`). A tight
    pool counts preemptions with caching on and off."""
    cfg = llama.LLaMAConfig.llama_7b(num_hidden_layers=2, dtype=torch.float32)
    llm = LLM(llama, cfg, device=DEV, seed=seed)
    rng = np.random.default_rng(seed + 4)
    systems = [rng.integers(1, cfg.vocab_size, size=256).tolist() for _ in range(6)]
    # 8 tokens of a request's own: a warm request matches 263 lines of its
    # own cold transcript, two pages and a copied tail. On int4 pools one
    # token of its own: the match ends on a page boundary (a copied int4
    # tail keeps the seeding run's amax scale, and a code step of 1/7 of it
    # parts the tokens; the JAX package's tests align these matches too)
    fams_by_own = {own: [_prefix_prompts(rng, cfg, [s], 8, own) for s in systems]
                   for own in (8, 1)}
    new = 16
    dcfg, dparams = layer_skip_draft(cfg, llm.params, 1)
    runs, ties, stats = {}, {}, {}
    configs = [(pool, fused, None) for pool in (None, "int8", "int4")
               for fused in ((), ("rope_kv_write",), ("whole_step",))]
    configs.append((None, ("whole_step",), "ssm"))
    for pool, fused, spec in configs:
        serve = dict(PREFIX_F32_SERVE, kv_quant=pool, fused_decode=fused)
        budget = _quant_budget(cfg, serve, 28)
        name = f"{pool or 'f32'}-{'+'.join(fused) or 'unfused'}{'-spec' if spec else ''}"
        fams = fams_by_own[1 if pool == "int4" else 8]
        plens = [len(p) for p in fams[0]]
        for kernels in ("cuda", "torch"):
            sc = ServingConfig(**serve, kernels=kernels, prefix_caching=True,
                               host_cache_bytes=1 << 34, max_cached_tokens=budget)
            eng = InferenceEngine(llama, cfg, llm.params, sc, device=DEV)
            # the SSM pool has no host tier: it gets every slot's worst case,
            # so that its tree keeps the family the target's tier spills
            rm = (SpecInferManager(eng, [InferenceEngine(
                llama, dcfg, dparams, dataclasses.replace(sc, max_cached_tokens=None),
                device=DEV)], SpecConfig(2, 3)) if spec else RequestManager(eng))
            rec = {} if spec else _record_steps(eng)

            def leg(fam):
                rec.clear()
                toks = [r.output_tokens for r in rm.generate(fams[fam], max_new_tokens=new)]
                return toks, dict(rec)

            out = {"cold": leg(0), "warm": leg(0)}
            for fam in range(1, len(fams)):  # other families until family 0's
                # prefix lies (in part) in the host tier
                if any(n.host is not None
                       for n in rm.prefix_cache._walk(fams[0][0], peek=True)[0]):
                    break
                leg(fam)
            out["spilled"] = leg(0)
            st = rm.stats
            check(st.prefix_hits > 0 and st.spills > 0 and st.readmits > 0,
                  f"prefix f32 {name}-{kernels}: hits {st.prefix_hits}, spills {st.spills}, "
                  f"readmits {st.readmits}")
            _audit_pools(rm)
            stats[f"{name}-{kernels}"] = {k: getattr(st, k) for k in (
                "prefix_hits", "prefix_cows", "spills", "readmits", "host_hit_tokens",
                "preemptions")}
            runs[f"{name}-{kernels}"] = out
            del rm, eng
            gc.collect()
            torch.cuda.empty_cache()
        pairs = [("cuda", "warm", "cuda", "cold"), ("cuda", "spilled", "cuda", "warm"),
                 ("torch", "warm", "torch", "cold"), ("torch", "spilled", "torch", "warm"),
                 *[("cuda", x, "torch", x) for x in ("cold", "warm", "spilled")]]
        for ka, la, kb, lb in pairs:
            (a, rec_a), (b, rec_b) = runs[f"{name}-{ka}"][la], runs[f"{name}-{kb}"][lb]
            if a == b:
                continue
            # int4: one code step is 1/7 of a page's amax, so a K/V value at a
            # rounding tie may take the other code (the f32 phase's rule);
            # an int8 warm run against its cold one: the copied tail page
            # keeps the seeding run's amax scale, so the warm request's lines
            # there take other codes
            allowed = pool == "int4" or (pool == "int8" and "cold" in (la, lb) and la != lb)
            ties[f"{name} {ka}-{la} vs {kb}-{lb}"] = (
                allowed, _parting(plens, a, b, rec_a, rec_b) if rec_a else [])
    # a tight pool, one slot's worst case plus a page: caching may not add
    # preemptions (reclaim runs before an allocation fails)
    tight = {}
    for caching in (False, True):
        serve = dict(PREFIX_F32_SERVE, prefix_caching=caching)
        sc = ServingConfig(**serve)
        llm.compile(ServingConfig(**serve, max_cached_tokens=(sc.pages_per_slot + 1) * 128))
        toks = [[r.output_tokens for r in llm.generate(fams_by_own[8][0], max_new_tokens=new)]
                for _ in range(2)]
        tight[caching] = (toks, llm.rm.stats.preemptions, llm.rm.stats.prefix_hits)
        _audit_pools(llm.rm)
        _free(llm)
    emit({"phase": "prefix_f32", "layers": 2, "requests": 8, "new_tokens": new,
          "runs": sorted(runs), "parted": {k: d for k, (_, d) in ties.items()},
          "stats": stats,
          "tight_pool": {"preemptions_off": tight[False][1], "preemptions_on": tight[True][1],
                         "hits_on": tight[True][2]}})
    for key, (allowed, parts) in ties.items():
        check(allowed, f"prefix f32 tokens differ: {key}: {parts}")
        for d in parts:  # :func:`_divergence`'s rule
            check(d["margin"] <= 2 * d["max_abs_diff"], f"{key}: parts at no tie: {d}")
            check(d["rel_l2"] <= F32_TIE_REL_L2, f"{key}: logits off: {d}")
    check(tight[True][0] == tight[False][0], "prefix f32 tight pool: caching changed tokens")
    check(tight[False][1] > 0, "prefix f32 tight pool: no preemption with caching off")
    check(tight[True][1] <= tight[False][1],
          f"prefix f32 tight pool: {tight[True][1]} preemptions with caching, "
          f"{tight[False][1]} without")
    del llm
    gc.collect()
    torch.cuda.empty_cache()


def phase_prefix(seed):
    """Prefix caching and the host tier on LLaMA-7B at full width cut to
    PREFIX_LAYERS layers (random bf16 weights from the seed): 32 requests, a
    1000-token system
    prompt and 64 tokens of their own each, 32 greedy tokens, through each
    of PREFIX_ARMS and its cold twin (16 slots: the second wave hits), and
    the host arm (4 families, 8 slots, int4, a pool that spills); the page
    movers' line; the f32 sub-check. Returns the launches of the arms' runs."""
    cfg = llama.LLaMAConfig.llama_7b(num_hidden_layers=PREFIX_LAYERS)
    llm = LLM(llama, cfg, device=DEV, seed=seed)
    params = llm.params
    del llm
    rng = np.random.default_rng(seed + 5)
    system = rng.integers(1, cfg.vocab_size, size=PREFIX_SYSTEM).tolist()
    prompts = _prefix_prompts(rng, cfg, [system], PREFIX_REQUESTS, PREFIX_OWN)
    # the first rows of two probes after the measured run: one matches the
    # whole system prompt (a copied 104-line tail; its first chunk starts at
    # line 1000, which the cold run computed inside its 896-1023 chunk), one
    # its first 896 lines (7 pages: no copy, chunk-aligned)
    def fresh(n, avoid):  # n tokens whose first one parts from ``avoid``
        while True:
            toks = rng.integers(1, cfg.vocab_size, size=n).tolist()
            if toks[0] not in avoid:
                return toks

    probes = [system + fresh(PREFIX_OWN, {p[PREFIX_SYSTEM] for p in prompts}),
              system[:896] + fresh(PREFIX_SYSTEM + PREFIX_OWN - 896, {system[896]})]
    wave = PREFIX_SERVE["max_requests_per_batch"]
    launches = {}

    def count(fig):
        for k, v in fig["launches"].items():
            launches[k] = launches.get(k, 0) + v

    for label, kw, spec_kw, draft_layers in PREFIX_ARMS:
        t_arm = time.perf_counter()
        serve = dict(PREFIX_SERVE, **kw)
        cold_serve = dict(serve, prefix_caching=False)
        llm, cold, cold_fig, cold_rows = _prefix_arm(cfg, params, cold_serve, spec_kw,
                                                     draft_layers, prompts, PREFIX_NEW, wave,
                                                     probes)
        _free(llm)
        llm, warm, fig, warm_rows = _prefix_arm(cfg, params, serve, spec_kw, draft_layers,
                                                prompts, PREFIX_NEW, wave, probes)
        if label == "prefix-bf16":
            movers = {"bf16": _movers(llm.engine)}
        _free(llm)
        _check_arm(label, serve, fig, cold_fig, cold_fig["prefill_tokens"])
        first = [{"match": w[1], "bitwise": bool(torch.equal(w[0], c[0])),
                  "max_abs": float((w[0] - c[0]).abs().max()), "rel_l2": _rel(w[0], c[0])}
                 for w, c in zip(warm_rows, cold_rows)]
        check([f["match"] for f in first] == [PREFIX_SYSTEM, 896]
              and [c[1] for c in cold_rows] == [0, 0],
              f"{label}: the probes matched {[f['match'] for f in first]}")
        # a chunk-aligned match over whole pages: the warm first row is the cold one
        check(first[1]["bitwise"], f"{label}: the aligned probe's first row parts: {first[1]}")
        explained = _tokens_explained(label, cfg, params, serve, prompts, warm, cold)
        count(fig)
        count(cold_fig)
        emit({"phase": "prefix", "path": label, "model": "llama_7b", "layers": PREFIX_LAYERS,
              "requests": PREFIX_REQUESTS, "system_prompt": PREFIX_SYSTEM, "own": PREFIX_OWN,
              "new_tokens": PREFIX_NEW, "serving": {k: v for k, v in serve.items()},
              "warm": fig, "cold": cold_fig, "first_rows": first, **explained,
              "arm_s": time.perf_counter() - t_arm})

    # the host arm: families round-robin, a pool that spills idle families,
    # against a warm run whose pool holds every family
    t_arm = time.perf_counter()
    systems = [rng.integers(1, cfg.vocab_size, size=PREFIX_SYSTEM).tolist()
               for _ in range(PREFIX_HOST_FAMILIES)]
    host_prompts = _prefix_prompts(rng, cfg, systems, PREFIX_REQUESTS, PREFIX_OWN,
                                   PREFIX_HOST_BLOCK)
    sc = ServingConfig(**PREFIX_HOST_SERVE)
    per_req = -(-(PREFIX_SYSTEM + PREFIX_OWN + PREFIX_NEW + 1) // sc.page_size)
    pages = sc.max_requests_per_batch * per_req + PREFIX_HOST_SPARE
    host_serve = dict(PREFIX_HOST_SERVE, max_cached_tokens=_quant_budget(
        cfg, PREFIX_HOST_SERVE, pages))
    # the twin's pool holds every request's pages: nothing is evicted
    twin_serve = dict(PREFIX_HOST_SERVE, max_cached_tokens=_quant_budget(
        cfg, PREFIX_HOST_SERVE, (PREFIX_REQUESTS + 8) * per_req))
    twin, twin_toks, twin_fig, _ = _prefix_arm(cfg, params, twin_serve, None, None,
                                               host_prompts, PREFIX_NEW, 8)
    _free(twin)
    # the host tier holds twice the families' pages (an int4 page: K and V
    # codes and scales of every layer; 16,785,408 bytes at LLaMA-7B's 32)
    kv, dk = cfg.num_key_value_heads, cfg.head_dim
    page_bytes = cfg.num_hidden_layers * 2 * (PREFIX_HOST_SERVE["page_size"] * kv * dk // 2
                                              + kv * 4)
    host_serve["host_cache_bytes"] = 2 * PREFIX_HOST_FAMILIES * per_req * page_bytes
    llm, toks, fig, _ = _prefix_arm(cfg, params, host_serve, None, None, host_prompts,
                                    PREFIX_NEW, 8)
    movers["int4"] = _movers(llm.engine)
    emit({"phase": "prefix_movers", **movers})
    for pool, row in movers.items():
        check(row["spill_upload_byte_equal"],
              f"prefix movers ({pool}): the page spilled then uploaded is not byte-equal")
    _free(llm)
    # a cold run dispatches every prompt token (the pools hold every live
    # slot: nothing is preempted)
    check(fig["preemptions"] == 0, f"prefix-host-int4: {fig['preemptions']} preemptions")
    _check_arm("prefix-host-int4", host_serve, fig, twin_fig, sum(map(len, host_prompts)))
    check(fig["spills"] > 0 and fig["readmits"] > 0 and fig["host_hit_tokens"] > 0,
          f"prefix-host-int4: spills {fig['spills']}, readmits {fig['readmits']}, "
          f"host hit tokens {fig['host_hit_tokens']}")
    check(twin_fig["spills"] == 0 and twin_fig["prefix_evictions"] == 0,
          "prefix-host-int4: the roomy twin evicted")
    explained = _tokens_explained("prefix-host-int4", cfg, params, host_serve, host_prompts,
                                  toks, twin_toks)
    count(fig)
    emit({"phase": "prefix", "path": "prefix-host-int4", "model": "llama_7b",
          "layers": PREFIX_LAYERS,
          "requests": PREFIX_REQUESTS, "families": PREFIX_HOST_FAMILIES,
          "system_prompt": PREFIX_SYSTEM, "own": PREFIX_OWN, "new_tokens": PREFIX_NEW,
          "block": PREFIX_HOST_BLOCK, "serving": host_serve, "twin_serving": twin_serve,
          "warm": fig, "twin": twin_fig, **explained,
          "arm_s": time.perf_counter() - t_arm})
    del params
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    _prefix_f32(seed)
    emit({"phase": "arm_seconds", "path": "prefix-f32", "seconds": time.perf_counter() - t0})
    return launches

# ---------------------------------------------------------------------------
# training: flash-attention kernels, train-step parity, the train slice

# ---------------------------------------------------------------------------
# the obs phase (slice 17): tracing, the Prometheus export, the flight
# recorder, the output file and inference_debugging's per-layer capture,
# on LLaMA-7B at full width and depth (the slice phase's weights)

#: the traced arms over bf16 pages under the paged slice's budget:
#: (label, fused_decode), each served untraced and traced
OBS_TRACED_ARMS = (("bf16-fused", ("rope_kv_write",)), ("bf16-whole", ("whole_step",)))
#: the capture arms, kernels="cuda", 2 slots: (label, serving). The
#: paged-bf16 arm's token budget is below OBS_FAIL_LEN: a third request of
#: that length fails admission (the flight recorder's dump)
OBS_FAIL_BUDGET = 256
OBS_FAIL_LEN = 300
OBS_DEBUG_ARMS = (("dense", dict(kv_layout="dense")),
                  ("paged-bf16", dict(kv_layout="paged", max_cached_tokens=OBS_FAIL_BUDGET)),
                  ("paged-int8", dict(kv_layout="paged", kv_quant="int8")),
                  ("bf16-whole", dict(kv_layout="paged", fused_decode=("whole_step",))))
OBS_DEBUG_LENS = (200, 16)
OBS_DEBUG_NEW = 8


#: the traced arms' run order (traced or not): untraced, traced, traced,
#: untraced, so that neither side gains from running later
OBS_ORDER = (False, True, True, False)


def _obs_traced_arm(label, cfg, params, fused, prompts, new):
    """One traced arm: the same requests served by one engine in
    OBS_ORDER, untraced and traced (``obs.attach_observability``, a fresh
    buffer a run), each run with the counts, stats and dispatch count set
    to 0 just before it. Checks: the same tokens and ``dispatch_count``
    every time; in each traced run every request's events run admit →
    first_token → terminal in step order, the dispatch events are
    ``dispatch_count``, and the Prometheus text passes the drift guard
    with its counters the SchedulerStats'. Returns the arm's line."""
    llm = LLM(llama, cfg, params, device=DEV)
    llm.compile(ServingConfig(kv_layout="paged", max_cached_tokens=PAGED_BUDGET,
                              fused_decode=fused))
    llm.generate([[1, 2, 3]], max_new_tokens=2)  # warm-up
    runs = []
    for traced in OBS_ORDER:
        buf = None
        if traced:
            buf = OBS.attach_observability(llm.rm)
        else:
            llm.rm.tracer = llm.engine.tracer = OBS.NULL_TRACER
        llm.rm.stats = SchedulerStats()
        llm.engine.dispatch_count = 0
        K.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        results = llm.generate(prompts, max_new_tokens=new)
        torch.cuda.synchronize()
        runs.append(dict(traced=traced, results=results, wall_s=time.perf_counter() - t0,
                         dispatch=llm.engine.dispatch_count, stats=llm.rm.stats, buf=buf,
                         launches={k: v for k, v in K.LAUNCHES.items() if v}))
    first = runs[0]
    kernel = "whole_step_decode[bf16]" if "whole_step" in fused else \
        "fused_rope_paged_attention[bf16]"
    for i, run in enumerate(runs):
        for r in run["results"]:
            check(r.error is None and len(r.output_tokens) == new,
                  f"obs {label}: request {r.request_id}: {r.error}")
        same = [a.output_tokens == b.output_tokens
                for a, b in zip(first["results"], run["results"])]
        check(all(same), f"obs {label}: run {i} served other tokens: {same}")
        check(run["dispatch"] == first["dispatch"] > 0,
              f"obs {label}: dispatch_count {[r['dispatch'] for r in runs]}")
        check(run["launches"].get(kernel, 0) > 0, f"obs {label}: {kernel} never launched")
    on = runs[1]
    for run in runs:
        if not run["traced"]:
            continue
        events = run["buf"].events
        for r in run["results"]:
            mine = [e for e in events if e["trace_id"] == r.request_id]
            names = [e["name"] for e in mine]
            check(names and names[0] == "admit" and names[-1] == "terminal"
                  and names.count("terminal") == 1 and names.count("first_token") == 1,
                  f"obs {label}: request {r.request_id} events {names}")
            check(names.index("first_token") < len(names) - 1,
                  f"obs {label}: request {r.request_id}: first_token after terminal")
            steps = [e["step"] for e in mine]
            check(steps == sorted(steps), f"obs {label}: request {r.request_id} steps {steps}")
        kinds = collections.Counter(e["attrs"]["kind"] for e in events
                                    if e["name"] == "dispatch")
        check(sum(kinds.values()) == run["dispatch"],
              f"obs {label}: {sum(kinds.values())} dispatch events, dispatch_count "
              f"{run['dispatch']}")
        stats = run["stats"]
        text = OBS.prometheus_text(scheduler={"0": stats},
                                   profiles=[r.profile for r in run["results"]])
        OBS.check_export_coverage()
        samples = dict(line.rsplit(" ", 1) for line in text.splitlines()
                       if not line.startswith("#"))
        for field in sorted(OBS_EXPORT.SCHED_COUNTERS):
            got = float(samples[f'flexflow_scheduler_{field}{{replica="0"}}'])
            check(got == getattr(stats, field),
                  f"obs {label}: exported {field} {got}, SchedulerStats {getattr(stats, field)}")

    def by(traced, key):
        return [r[key] for r in runs if r["traced"] == traced]
    line = {"phase": "obs", "arm": label, "model": "llama_7b", "layers": cfg.num_hidden_layers,
            "requests": len(prompts), "new_tokens": new, "fused_decode": list(fused),
            "order": ["traced" if t else "untraced" for t in OBS_ORDER],
            "tokens_equal": True, "dispatch_count": on["dispatch"],
            "dispatch_kinds": dict(kinds), "events": len(on["buf"].events),
            "preemptions": on["stats"].preemptions,
            "decode_dispatch_ms": {k: {"p50": [s.decode_step_ms_p50 for s in by(t, "stats")],
                                       "p99": [s.decode_step_ms_p99 for s in by(t, "stats")],
                                       "decode_steps": on["stats"].decode_steps}
                                   for k, t in (("untraced", False), ("traced", True))},
            "wall_s": {k: by(t, "wall_s") for k, t in (("untraced", False), ("traced", True))},
            "prometheus_samples": len(samples), "launches": on["launches"]}
    _free(llm)
    return line


def _obs_debug_arm(label, family, cfg, params, params32, serve, prompts, new, root, head):
    """One inference_debugging arm, ``kernels`` as ``serve`` gives it, 2
    slots: the requests served with the switch off, then on (the flight
    recorder and the output file attached). Each step's capture is the
    engine's own (its files read back); the wrapper around it also
    captures the step with kernels="torch" and, with ``params32``, in f32
    (the cache upcast), and checks once, at the first decode step, that
    the capture left the cache bitwise as it was. Checks: the same tokens
    on and off; one dump a step; the cache unchanged; each served token
    the argmax of the step's last-layer dump through ``head`` (the final
    norm and LM head at ``logits_idx``) or a near-tie within twice bf16's
    own error there (``_greedy_over_prefix``'s rule; exact without
    ``params32``); with ``params32``, every layer's kernels capture within
    SLICE_PATHS times the plain capture's distance from the f32 one; one
    redacted dump a failed request, one output record a finished one.
    Returns the arm's line."""
    sc = ServingConfig(max_requests_per_batch=2, **serve)
    llm = LLM(family, cfg, params, device=DEV)
    llm.compile(sc)
    off = llm.generate(prompts, max_new_tokens=new)
    _free(llm)
    d = os.path.join(root, label)
    out_file = os.path.join(root, f"{label}.out")
    llm = LLM(family, cfg, params, device=DEV)
    llm.compile(dataclasses.replace(sc, inference_debugging=d), output_file=out_file)
    eng, rm = llm.engine, llm.rm
    check(not rm.supports_fast_decode, f"obs {label}: debugging left the pipelined path on")
    rec = OBS.FlightRecorder(out_dir=os.path.join(root, f"{label}-flightrec"))
    OBS.attach_observability(rm, recorder=rec)
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    L = cfg.num_hidden_layers
    sums = torch.zeros((L, 4), dtype=torch.float64)
    steps, cache_checks = [], []
    orig = eng._dump_debug

    def dump(bc):
        kw = {}
        if eng.paged:
            kw = dict(page_table=eng.page_table_device(), cache_len=eng.serving.cache_len,
                      kv_quant=eng.serving.kv_quant)
        args = (eng._tensor(bc.tokens, torch.int64), eng._tensor(bc.positions, torch.int64),
                None if bc.mask is None else eng._tensor(bc.mask, torch.bool),
                None if bc.cache_positions is None else eng._tensor(bc.cache_positions,
                                                                    torch.int64))
        plain = exact = None
        if params32 is not None:
            with torch.inference_mode():
                plain = family.serve_debug_activations(params, eng.cache, *args, cfg=cfg,
                                                       kernels="torch", **kw)
                cache32 = {k: v.float() if v.dtype == torch.bfloat16 else v
                           for k, v in eng.cache.items()}
                exact = family.serve_debug_activations(params32, cache32, *args, cfg=cfg32,
                                                       kernels="torch", **kw)
                del cache32
        before = None
        if bc.chunk == 1 and not cache_checks:
            before = {k: v.clone() for k, v in eng.cache.items()}
        orig(bc)
        if before is not None:
            cache_checks.append(set(before) == set(eng.cache) and all(
                torch.equal(eng.cache[k], v) for k, v in before.items()))
            del before
        files = sorted(glob.glob(os.path.join(d, "*", f"step{eng._debug_step - 1:05d}_layer*")))
        check(len(files) == L, f"obs {label}: {len(files)} layer files, want {L}")
        live = torch.from_numpy(bc.positions != eng.scratch_pos).to(DEV)
        idx = torch.from_numpy(bc.logits_idx).long().to(DEV)
        with torch.inference_mode():
            last = torch.from_numpy(np.load(files[-1])).to(DEV)
            logits = head(cfg, params, last.to(cfg.dtype), idx, False).float()
            row = {"positions": bc.positions.copy(), "logits_idx": bc.logits_idx.copy(),
                   "logits": logits.cpu()}
            if params32 is not None:
                for l in range(L):
                    c = torch.from_numpy(np.load(files[l])).to(DEV)[live].double()
                    t, f = plain[l].double()[live], exact[l].double()[live]
                    sums[l] += torch.stack([(c - t).square().sum(), t.square().sum(),
                                            (t - f).square().sum(), f.square().sum()]).cpu()
                row["err"] = (logits - head(cfg32, params32, exact[-1], idx, False)
                              ).abs().amax(-1).cpu()
        steps.append(row)

    eng._dump_debug = dump
    K.reset_launch_counts()
    on = llm.generate(prompts, max_new_tokens=new)
    torch.cuda.synchronize()
    launches = {k: v for k, v in K.LAUNCHES.items() if v}
    n_files = len(glob.glob(os.path.join(d, "*", "step*_tokens.npy")))
    finished = [r for r in on if r.error is None]
    same = [a.output_tokens == b.output_tokens and a.error == b.error for a, b in zip(off, on)]
    check(all(same), f"obs {label}: inference_debugging changed served tokens: {same}")
    check(n_files == rm.stats.sync_steps == len(steps) > 0 and rm.stats.decode_steps == 0,
          f"obs {label}: {n_files} dumps for {rm.stats.sync_steps} sync steps "
          f"({rm.stats.decode_steps} pipelined)")
    check(cache_checks == [True], f"obs {label}: a capture changed the engine's cache")
    # each sampled row's token against the argmax of its step's last dump
    seqs = [p + r.output_tokens for p, r in zip(prompts, on)]
    served, argmax_eq, ties, bad, gaps = 0, 0, 0, [], []
    for k, row in enumerate(steps):
        for r in range(2):
            pos = int(row["positions"][r, row["logits_idx"][r]])
            if pos == eng.scratch_pos or not len(prompts[r]) <= pos + 1 < len(seqs[r]):
                continue
            tok, lg = seqs[r][pos + 1], row["logits"][r]
            served += 1
            if int(lg.argmax()) == tok:
                argmax_eq += 1
                continue
            gap = float(lg.max() - lg[tok])
            if "err" in row and gap <= 2 * float(row["err"][r]):
                ties += 1
                gaps.append(gap)
            else:
                bad.append((k, r))
    check(served == sum(len(r.output_tokens) for r in finished),
          f"obs {label}: {served} sampled rows for {sum(len(r.output_tokens) for r in finished)} "
          "served tokens")
    check(not bad, f"obs {label}: served tokens that are not the argmax of their step's "
          f"last dump: {bad[:8]}")
    line = {"phase": "obs_debug", "arm": label, "model": family.__name__.rsplit(".", 1)[-1],
            "layers": L, "kernels": sc.kernels, **{k: v for k, v in serve.items()
                                                   if k != "fused_decode"},
            "fused_decode": list(serve.get("fused_decode", ())), "requests": len(prompts),
            "finished": len(finished), "sync_steps": rm.stats.sync_steps, "dumps": n_files,
            "cache_bitwise": cache_checks == [True], "tokens_equal": all(same),
            "tokens": {"served": served, "argmax_equal": argmax_eq, "near_ties": ties,
                       "tie_gaps": gaps},
            "launches": launches}
    if params32 is not None:
        ct = (sums[:, 0] / sums[:, 1]).sqrt()
        tf = (sums[:, 2] / sums[:, 3]).sqrt()
        ratio = ct / tf
        line["layers_rel_l2"] = {"cuda_vs_torch_max": float(ct.max()),
                                 "torch_vs_f32_min": float(tf.min()),
                                 "worst_ratio": float(ratio.max()),
                                 "worst_layer": int(ratio.argmax()),
                                 "tol": f"cuda_vs_torch <= {SLICE_PATHS} * torch_vs_f32 "
                                        "at every layer"}
        check(bool((ratio <= SLICE_PATHS).all()),
              f"obs {label}: layers whose kernels capture is further from the plain one than "
              f"bf16 allows: {torch.nonzero(ratio > SLICE_PATHS).flatten().tolist()}")
    failed = [r for r in on if r.error is not None]
    check(len(rec.paths) == len(failed), f"obs {label}: {len(rec.paths)} flight-recorder dumps "
          f"for {len(failed)} failed requests")
    for path in rec.paths:
        with open(path) as f:
            doc = json.load(f)
        check(doc["reason"] == "request_error" and doc["events"][-1]["name"] == "terminal"
              and not any(OBS.REDACTED_ATTRS & (e.get("attrs") or {}).keys()
                          for e in doc["events"]),
              f"obs {label}: flight-recorder dump {doc['reason']}")
    with open(out_file) as f:
        records = f.read().count("[Profile] guid(")
    check(records == len(finished), f"obs {label}: {records} output records for "
          f"{len(finished)} finished requests")
    line.update(failed=len(failed), flight_recorder_dumps=len(rec.paths), output_records=records)
    _free(llm)
    shutil.rmtree(d, ignore_errors=True)
    return line


def phase_obs(seed, params, smi):
    """Serving triage and observability on LLaMA-7B (full width, cut to
    PAGED_LAYERS layers of the slice phase's bf16 weights ``params``): the
    traced arms
    (OBS_TRACED_ARMS, the paged slice's 8 requests), the decode dispatch
    p50 traced and untraced beside the card's name and power limit
    (``smi``), inference_debugging's capture on OBS_DEBUG_ARMS with
    kernels="cuda" (2 requests, OBS_DEBUG_NEW new tokens; the paged-bf16
    arm adds a third request that fails admission), then Falcon-7B's
    capture on the paged layout (the plain path, served plain). Returns
    the launches of its runs."""
    cfg, params = layer_skip_draft(llama.LLaMAConfig.llama_7b(), params, PAGED_LAYERS)
    prompts, new = _slice_prompts(seed, cfg)
    lines = [_obs_traced_arm(label, cfg, params, fused, prompts, new)
             for label, fused in OBS_TRACED_ARMS]
    for line in lines:
        emit(line)
    emit({"phase": "obs_dispatch", "card": smi,
          "decode_dispatch_ms_p50": {line["arm"]: {k: statistics.mean(v["p50"]) for k, v in
                                                   line["decode_dispatch_ms"].items()}
                                     for line in lines},
          "note": "host wall ms of each pipelined decode dispatch (not a gate)"})
    launches = collections.Counter()
    for line in lines:
        launches.update(line["launches"])
    rng = np.random.default_rng(seed + 17)
    debug_prompts = [rng.integers(1, cfg.vocab_size, size=n).tolist() for n in OBS_DEBUG_LENS]
    root = tempfile.mkdtemp(prefix="flexflow_tpu_torch_obs_")
    try:
        params32 = _to_f32(params)
        for label, serve in OBS_DEBUG_ARMS:
            extra = ([rng.integers(1, cfg.vocab_size, size=OBS_FAIL_LEN).tolist()]
                     if "max_cached_tokens" in serve else [])
            line = _obs_debug_arm(label, llama, cfg, params, params32, serve,
                                  debug_prompts + extra, OBS_DEBUG_NEW, root, llama._head)
            emit(line)
            launches.update(line["launches"])
            for k in {"dense": ("decode_attention", "verify_attention"),
                      "paged-bf16": ("ragged_paged_attention[bf16]",),
                      "paged-int8": ("ragged_paged_attention[int8]", "paged_commit[int8]"),
                      "bf16-whole": ("whole_step_decode[bf16]",
                                     "ragged_paged_attention[bf16]")}[label]:
                check(line["launches"].get(k, 0) > 0, f"obs {label}: {k} never launched")
            if extra:
                check(line["failed"] == 1 and line["flight_recorder_dumps"] == 1,
                      f"obs {label}: the request over the budget: {line['failed']} failed, "
                      f"{line['flight_recorder_dumps']} dumps")
        del params32
        gc.collect()
        torch.cuda.empty_cache()
        fcfg = falcon.falcon_7b()
        gen = torch.Generator(device=DEV)
        gen.manual_seed(seed + 21)
        fparams = falcon.init_params(gen, fcfg, device=DEV)
        fprompts = [rng.integers(1, fcfg.vocab_size, size=n).tolist() for n in OBS_DEBUG_LENS]
        emit(_obs_debug_arm("falcon-paged", falcon, fcfg, fparams, None,
                            dict(kv_layout="paged", kernels="torch"), fprompts,
                            OBS_DEBUG_NEW, root, TD._head))
        del fparams
    finally:
        shutil.rmtree(root, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    return dict(launches)


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
# The f32 backward kernels at S 2048, T 1 against an f64 recomputation:
# at most this many times the plain version's error (its cuBLAS sums)
F32_BWD_VS_PLAIN = 2.0
# (label, dtype, B, H, S, T, dk, causal, timed); the first is the train
# slice's; the last holds the wgmma forward at T != S, full attention
FLASH_CASES = (
    ("llama7b-train", torch.bfloat16, 4, 32, 2048, 2048, 128, True, True),
    ("f32-full-s1000", torch.float32, 2, 32, 1000, 1000, 128, False, True),
    ("llama160m-dk64", torch.bfloat16, 4, 12, 2048, 2048, 64, True, True),
    ("dk64-full-s1000-t1500", torch.bfloat16, 2, 12, 1000, 1500, 64, False, False),
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


def run_flash_check(label, gen, dtype, B, H, S, T, dk, causal, timed=True):
    """The three flash kernels against their plain versions on one case;
    returns a row per kernel with its error and, ``timed``, its times and
    bound (the forward's also its device time, back to back). The forward
    must take its dtype's design ("wgmma" for bf16)."""
    q, k, v = _rand((B, S, H, dk), dtype, gen), _rand((B, T, H, dk), dtype, gen), \
        _rand((B, T, H, dk), dtype, gen)
    do = _rand((B, S, H, dk), dtype, gen)
    scale = 1.0 / math.sqrt(dk)
    before = dict(FA.DESIGN_LAUNCHES)
    out, lse = FA.flash_fwd(q, k, v, causal, scale)
    took = [k_[len("flash_attention_fwd["):-1] for k_, n in FA.DESIGN_LAUNCHES.items()
            if n != before[k_]]
    want = "wgmma" if dtype == torch.bfloat16 else "f32"
    check(took == [want], f"flash_attention_fwd[{label}]: designs {took}, want {want}")
    delta = FA.delta_rows(out, do).contiguous()
    before = dict(FA.DESIGN_LAUNCHES)
    dk_, dv = FA.flash_bwd_kv(q, k, v, do, lse, delta, causal, scale)
    dq = FA.flash_bwd_q(q, k, v, do, lse, delta, causal, scale)
    took = sorted(k_ for k_, n in FA.DESIGN_LAUNCHES.items() if n != before[k_])
    check(took == [f"flash_attention_bwd_kv[{want}]", f"flash_attention_bwd_q[{want}]"],
          f"flash backward[{label}]: designs {took}, want {want}")
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
    if not timed:
        rows = {}
        for kname in FLASH_KERNELS:
            rows[kname] = {"phase": "kernels", "kernel": kname, "case": label,
                           "dtype": str(dtype).replace("torch.", ""),
                           "shape": {"B": B, "H": H, "S": S, "T": T, "dk": dk,
                                     "causal": causal},
                           "max_abs_err": err[kname], "tol": FLASH_TOL[dtype],
                           "rel_l2": rel[kname], "rel_l2_tol": FLASH_REL_L2[dtype]}
            rows[kname]["design"] = want
            if kname == "flash_attention_fwd":
                rows[kname]["lse_max_abs_err"] = lse_err
            emit(rows[kname])
        return rows
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
        row.update(design=want, device_ms=back_to_back_ms(kernel))
        if kname == "flash_attention_fwd":
            row.update(lse_max_abs_err=lse_err, vs_library=row["ms"] / lib)
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
        rows = run_flash_check(case[0], gen, *case[1:])
        if i == 0:
            main.update(rows)
    # SDPA's one backward call computes dq, dk and dv: the pair against it
    kv, q = main["flash_attention_bwd_kv"], main["flash_attention_bwd_q"]
    emit({"phase": "kernels", "kernel": "flash_attention_bwd", "case": FLASH_CASES[0][0],
          "pair_ms": kv["ms"] + q["ms"], "library_ms": kv["library_ms"],
          "pair_vs_library": (kv["ms"] + q["ms"]) / kv["library_ms"],
          "pair_bound_ms": kv["bound_ms"] + q["bound_ms"]})
    for dk in (64, 128):
        run_flash_f32_accuracy(gen, dk)
    return main


def _bwd_f64(q, k, v, do, lse, delta, scale):
    """dq, dk, dv of the causal backward recomputed in f64 from the same
    lse and delta."""
    q, k, v, do, lse, delta = (t.double() for t in (q, k, v, do, lse, delta))
    s = torch.einsum("bshd,bthd->bhst", q, k) * scale
    S, T = q.shape[1], k.shape[1]
    mask = torch.arange(S, device=DEV)[:, None] >= torch.arange(T, device=DEV)[None, :]
    p = torch.where(mask, torch.exp(s - lse[..., None]), 0.0)
    ds = p * (torch.einsum("bshd,bthd->bhst", do, v) - delta[..., None]) * scale
    return (torch.einsum("bhst,bthd->bshd", ds, k), torch.einsum("bhst,bshd->bthd", ds, q),
            torch.einsum("bhst,bshd->bthd", p, do))


def run_flash_f32_accuracy(gen, dk, B=2, H=3, S=2048, T=1):
    """The f32 backward kernels at S 2048, T 1 (one key line sums every
    row), untimed: each gradient's largest error from an f64 recomputation
    at most F32_BWD_VS_PLAIN times the plain version's."""
    q, do = _rand((B, S, H, dk), torch.float32, gen), _rand((B, S, H, dk), torch.float32, gen)
    k, v = _rand((B, T, H, dk), torch.float32, gen), _rand((B, T, H, dk), torch.float32, gen)
    scale = 1.0 / math.sqrt(dk)
    out, lse = FA.flash_fwd(q, k, v, True, scale)
    delta = FA.delta_rows(out, do).contiguous()
    got = (FA.flash_bwd_q(q, k, v, do, lse, delta, True, scale),
           *FA.flash_bwd_kv(q, k, v, do, lse, delta, True, scale))
    plain = (FA.flash_bwd_q_ref(q, k, v, do, lse, delta, True, scale),
             *FA.flash_bwd_kv_ref(q, k, v, do, lse, delta, True, scale))
    exact = _bwd_f64(q, k, v, do, lse, delta, scale)
    err = {}
    for name, a, b, x in zip(("dq", "dk", "dv"), got, plain, exact):
        err[name] = {"kernel": float((a.double() - x).abs().max()),
                     "plain": float((b.double() - x).abs().max()),
                     "max_abs": float(x.abs().max())}
    emit({"phase": "kernels", "kernel": "flash_attention_bwd", "case": f"f32-accuracy-dk{dk}",
          "shape": {"B": B, "H": H, "S": S, "T": T, "dk": dk, "causal": True},
          "err_vs_f64": err, "tol": f"kernel <= {F32_BWD_VS_PLAIN} * plain"})
    for name, e in err.items():
        check(e["kernel"] <= F32_BWD_VS_PLAIN * e["plain"],
              f"f32 backward {name} (dk {dk}): {e['kernel']} from f64, plain {e['plain']}")


ADAM_STEPS = 3


def run_adam_check(seed):
    """The Adam kernel against its plain version on the train slice's
    largest leaf (the stacked w1 of TRAIN_LAYERS layers at LLaMA-7B width,
    bf16, with f32 moments): ADAM_STEPS steps bitwise equal in p, m and
    v, then both timed (each call updates in place). Bound: the bytes one
    update must move, p and g read and p written in bf16, m and v read and
    written in f32 (22 bytes a parameter). No single PyTorch call computes
    this update (torch.optim's fused Adam places eps elsewhere)."""
    cfg = llama.LLaMAConfig.llama_7b(num_hidden_layers=TRAIN_LAYERS)
    shape = (TRAIN_LAYERS, cfg.hidden_size, cfg.intermediate_size)
    gen = torch.Generator(device=DEV)
    gen.manual_seed(seed + 11)
    p = _rand(shape, torch.bfloat16, gen)
    kern = [p, torch.zeros(shape, device=DEV), torch.zeros(shape, device=DEV)]
    plain = [t.clone() for t in kern]
    lr = torch.tensor(TRAIN_LR, device=DEV)
    bitwise = True
    for t in range(1, ADAM_STEPS + 1):
        g = _rand(shape, torch.bfloat16, gen)
        tt = torch.tensor(float(t), device=DEV)
        alpha = lr * torch.sqrt(1.0 - torch.pow(0.999, tt)) / (1.0 - torch.pow(0.9, tt))
        O.adam_update(kern[0], g, kern[1], kern[2], alpha, 0.9, 0.999, 1e-8)
        O.adam_update_ref(plain[0], g, plain[1], plain[2], alpha, 0.9, 0.999, 1e-8)
        bitwise = bitwise and all(bool(torch.equal(x, y)) for x, y in zip(kern, plain))
    err = max(float((x.float() - y.float()).abs().max()) for x, y in zip(kern, plain))
    check(bitwise, f"adam_update: the kernel differs from its plain version by {err}")
    n = p.numel()
    nbytes = n * (2 + 2 + 2 + 4 * 4)
    row = {"phase": "kernels", "kernel": "adam_update", "case": "llama7b-w1-stack",
           "dtype": "bfloat16", "shape": list(shape), "steps": ADAM_STEPS,
           "bitwise": bitwise, "max_abs_err": err, "bytes": nbytes,
           "ms": cuda_ms(lambda: O.adam_update(kern[0], g, kern[1], kern[2], alpha,
                                               0.9, 0.999, 1e-8)),
           "plain_ms": cuda_ms(lambda: O.adam_update_ref(plain[0], g, plain[1], plain[2],
                                                         alpha, 0.9, 0.999, 1e-8), iters=5),
           "library_ms": None, "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes"}
    emit(row)
    del kern, plain, g, p
    gc.collect()
    torch.cuda.empty_cache()
    return {"adam_update": row}


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
    finite and fall, every flash launch take "wgmma", the Adam kernel
    launch once a leaf a step, and a profiled step copy no LM head to
    f32. Returns the flash and Adam launches of the ten steps."""
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
    O.reset_launch_counts()
    counts = lambda: {**FA.LAUNCHES, **O.LAUNCHES}  # noqa: E731
    losses, step_s, per_step = [], [], []
    for _ in range(TRAIN_STEPS):
        before = counts()
        t0 = time.perf_counter()
        params, opt, loss = step(params, opt, toks)
        losses.append(float(loss))
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        per_step.append({k: n - before[k] for k, n in counts().items()})
    launches = counts()
    design_launches = {k: v for k, v in FA.DESIGN_LAUNCHES.items() if v}
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
          "launches_per_step": per_step[-1], "launches": launches,
          "design_launches": design_launches})
    check(all(math.isfinite(x) for x in losses), f"non-finite training loss: {losses}")
    check(losses[-1] < losses[0], f"the training loss did not fall: {losses}")
    for name in FLASH_KERNELS:
        check(all(p[name] > 0 for p in per_step), f"{name} missed a train step: {per_step}")
    check(design_launches == {f"{k}[wgmma]": launches[k] for k in FLASH_KERNELS},
          f"the train steps' flash launches were not all wgmma: {design_launches}")
    leaves = len(O.tree_leaves(params))
    check(all(p["adam_update"] == leaves for p in per_step),
          f"the Adam kernel did not launch once a leaf ({leaves}) each step: {per_step}")
    # one more step under the profiler: the LM head is never copied to f32
    prof = _profile_train(lambda: float(step(params, opt, toks)[2]),
                          (cfg.hidden_size, cfg.vocab_size))
    emit(prof)
    check(prof["head_f32_copies"] == 0, f"the LM head was copied: {prof['head_f32_copies']}")
    check(prof["lm_head_ms"].get("lm_head", 0) > 0, "the profile shows no LM head time")
    del params, opt
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# slice 18: weight-only quantization (the wq_matmul kernel), parameter
# offload and in-process cluster serving

#: (M, K, N) of the wq_matmul checks: LLaMA-7B's projections at decode (16
#: slots, C = 1) and at a mixed step (16 slots x C = 128)
WQ_CASES = tuple((M, K, N) for M in (16, 2048)
                 for K, N in ((4096, 4096), (4096, 11008), (11008, 4096)))
#: the f32 cases ("rows" and "f32"), test-sized f32 models' shapes
WQ_F32_CASES = ((16, 4096, 4096), (256, 4096, 4096))
#: Mixtral-8x7B's expert stack at decode: D 4096, F 14336, E 8
WQ_EXPERT = (16, 4096, 14336, 8)
WQ_REL_L2 = {torch.bfloat16: 2.0 ** -8, torch.float32: 1e-5}
#: the row of each wq_matmul line in the kernels line: decode, w1's shape
WQ_ROW_CASE = (16, 4096, 11008)
#: a cold graph's working set: above three times the H100's 50 MB L2, as
#: serving finds each of a step's 224 distinct weights
WQ_COLD_BYTES = 150e6


def _wq_bound(M, K, N, bits, dtype, E=1, x_batched=False):
    """The least time of y = x @ dequantize(q, scale): codes, scales, x and
    y moved once, or 2 M K N operations a weight matrix at the dtype's
    peak (the tensor cores for bf16, the CUDA cores for f32)."""
    isz = 2 if dtype == torch.bfloat16 else 4
    nbytes = (E * K * N * bits // 8 + E * N * 4 + (E if x_batched else 1) * M * K * isz
              + E * M * N * isz)
    ops = 2 * M * K * N * E
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def cold_graph_ms(make, nbytes):
    """graph_ms of ``make(copy)()`` cycling over enough copies of its
    operands (``nbytes`` a copy) that the graph's working set passes
    WQ_COLD_BYTES: every call finds its weight out of L2, as serving does."""
    copies = max(1, math.ceil(WQ_COLD_BYTES / nbytes))
    fns = [make(i) for i in range(copies)]
    turn = iter(range(1 << 30))
    ms = graph_ms(lambda: fns[next(turn) % copies](), calls=max(20, copies))
    del fns
    return ms, copies


def _has_cuda_kernel(op):
    """Whether this PyTorch registers a CUDA kernel for aten ``op``."""
    return torch._C._dispatch_has_kernel_for_dispatch_key(f"aten::{op}", "CUDA")


def run_wq_check(label, gen, bits, dtype, M, Kd, N, E=None, form=None):
    """One wq_matmul case against its plain version (dequantize, then the
    product) on the same inputs: relative L2 within WQ_REL_L2, bf16 outputs
    bitwise from run to run, the design the launcher took, kernel and plain
    graph ms, the bound, the bf16 ``torch.matmul`` of the dequantized
    weight (the figure a quantized decode must beat; no one PyTorch call
    computes this function) and, at the int8 shapes of one weight, the
    card's ``aten._weight_int8pack_mm`` where it has one (bf16 scales
    applied after the product: a yardstick only). Decode cases (M <= 16)
    also time the kernel and the bf16 product cold."""
    from flexflow_tpu_torch.quantization import quantize_tensor

    shape = (Kd, N) if E is None else (E, Kd, N) if form != "down" else (E, N, Kd)
    qw = quantize_tensor(torch.randn(shape, generator=gen, device=DEV), bits)
    q, s = qw["q"], qw["scale"]
    if form == "down":  # (M, E * F) @ (E * F, D), each expert's rows at its scale
        q, s = q.reshape(-1, Kd), s.reshape(E, Kd)
        x = _rand((M, E * N), dtype, gen)
        M_, K_, N_, E_ = M, E * N, Kd, 1
    else:
        x = _rand((M, Kd), dtype, gen)
        M_, K_, N_, E_ = M, Kd, N, (E or 1)
    before = dict(K.DESIGN_LAUNCHES)
    out = K.wq_matmul(x, q, s)
    torch.cuda.synchronize()
    took = [k for k, v in K.DESIGN_LAUNCHES.items() if v != before[k]]
    check(len(took) == 1, f"wq_matmul {label}: designs {took} for one call")
    ref = K.wq_matmul_ref(x, q, s)
    err = _rel(out, ref)
    check(bool(torch.isfinite(out).all()), f"wq_matmul {label}: non-finite output")
    check(err <= WQ_REL_L2[dtype], f"wq_matmul {label}: rel. L2 {err} > {WQ_REL_L2[dtype]}")
    bitwise = None
    if dtype == torch.bfloat16:
        again = K.wq_matmul(x, q, s)
        torch.cuda.synchronize()
        bitwise = bool(torch.equal(out, again))
        check(bitwise, f"wq_matmul {label}: two runs differ")
        del again
    dense = K._wq_dense(q, s, dtype)
    bound, by = _wq_bound(M_, K_, N_, bits, dtype, E_)
    row = {"phase": "kernel", "kernel": f"wq_matmul[int{bits}]", "case": label,
           "M": M_, "K": K_, "N": N_, "E": E_, "dtype": str(dtype).split(".")[-1],
           "design": took[0][len("wq_matmul["):-1] if took else None,
           "max_abs_err": float((out.float() - ref.float()).abs().max()), "rel_l2": err,
           "bitwise_run_to_run": bitwise,
           "graph_ms": graph_ms(lambda: K.wq_matmul(x, q, s)),
           "plain_graph_ms": graph_ms(lambda: K.wq_matmul_ref(x, q, s)),
           "bf16_matmul_graph_ms": graph_ms(lambda: torch.matmul(x, dense)),
           "bound_ms": bound, "bound_by": by, "library_ms": None}
    if bits == 8 and q.dim() == 2 and s.shape[0] == 1 and dtype == torch.bfloat16:
        if _has_cuda_kernel("_weight_int8pack_mm"):
            qt, sl = q.t().contiguous(), s[0].to(dtype)
            # ~0.1 s a call at M 2048 on the H100: a short graph there
            row["library_ms"] = graph_ms(
                lambda: torch.ops.aten._weight_int8pack_mm(x, qt, sl),
                *((20, 5) if M_ <= K.WQ_ROWS_MAX else (2, 2)))
            row["library"] = "aten._weight_int8pack_mm"
            del qt, sl
        else:
            row["library"] = "no such call (aten._weight_int8pack_mm has no CUDA kernel)"
    if M_ <= K.WQ_ROWS_MAX:
        def copy_of(i):
            qi, si = (q, s) if i == 0 else (q.clone(), s.clone())
            return lambda: K.wq_matmul(x, qi, si)

        def dense_of(i):
            di = dense if i == 0 else dense.clone()
            return lambda: torch.matmul(x, di)

        row["cold_graph_ms"], row["cold_copies"] = cold_graph_ms(
            copy_of, q.numel() * q.element_size() + s.numel() * 4)
        row["bf16_matmul_cold_graph_ms"], _ = cold_graph_ms(
            dense_of, dense.numel() * dense.element_size())
        torch.cuda.empty_cache()
    row["ms"], row["plain_ms"] = row["graph_ms"], row["plain_graph_ms"]
    emit(row)
    return row


def phase_wq_kernels(seed):
    """wq_matmul[int8|int4] against its plain version: LLaMA-7B's
    projection shapes at decode (M 16: design "splitk") and a 16-slot C =
    128 mixed step (M 2048: "wgmma"), the f32 cases ("rows", "f32"), and
    Mixtral-8x7B's expert stack at decode (E weights against one x; the
    down projection as one K over the experts). The kernels line's rows
    carry the decode w1 case, and every case under ``cases``."""
    gen = torch.Generator(device=DEV)
    gen.manual_seed(seed)
    rows = {}
    for bits in (8, 4):
        cases = []
        for M, Kd, N in WQ_CASES:
            cases.append(run_wq_check(f"M{M}-{Kd}x{N}", gen, bits, torch.bfloat16, M, Kd, N))
        for M, Kd, N in WQ_F32_CASES:
            cases.append(run_wq_check(f"f32-M{M}-{Kd}x{N}", gen, bits, torch.float32, M, Kd, N))
        M, D, F, E = WQ_EXPERT
        cases.append(run_wq_check("mixtral-up", gen, bits, torch.bfloat16, M, D, F, E))
        cases.append(run_wq_check("mixtral-down", gen, bits, torch.bfloat16, M, D, F, E,
                                  form="down"))
        designs = {c["design"] for c in cases}
        check(designs == {"splitk", "wgmma", "rows", "f32"},
              f"wq_matmul[int{bits}] designs: {designs}")
        main = next(c for c in cases if (c["M"], c["K"], c["N"]) == WQ_ROW_CASE
                    and c["dtype"] == "bfloat16")
        rows[f"wq_matmul[int{bits}]"] = dict(main, cases=[
            {k: c.get(k) for k in ("case", "design", "rel_l2", "graph_ms", "cold_graph_ms",
                                   "plain_graph_ms", "bf16_matmul_graph_ms",
                                   "bf16_matmul_cold_graph_ms", "library_ms", "bound_ms",
                                   "bound_by", "bitwise_run_to_run")}
            for c in cases])
    return rows


#: the quant phase: the paged slice's 8 requests at a budget with no
#: preemption (>= 72 pages of 128), per-layer kernels, four weight arms
QUANT_BUDGET = 72 * 128
QUANT_ARMS = (("bf16", None, ()), ("int8", "int8", ()), ("int4", "int4", ()),
              ("int8-fused", "int8", ("rope_kv_write",)))


def _served_rows(rec, prompts, outputs):
    """The logits each served token came from (``_record_steps``: request
    i in slot i): (requests, tokens, V)."""
    return torch.stack([torch.stack([rec[(i, len(p) - 1 + k)] for k in range(len(o))])
                        for i, (p, o) in enumerate(zip(prompts, outputs))])


def _count_wq_steps(eng):
    """Per step the engine serves (``eng.run_mixed``: the pipelined
    decode and mixed steps): its query width and the wq_matmul launches it
    made, by design."""
    steps, run = [], eng.run_mixed

    def run_mixed(last, host, use_last, positions, *rest, **kw):
        before = {k: v for k, v in K.DESIGN_LAUNCHES.items() if k.startswith("wq_matmul[")}
        out = run(last, host, use_last, positions, *rest, **kw)
        steps.append((int(np.asarray(host).shape[1]),
                      {k: K.DESIGN_LAUNCHES[k] - v for k, v in before.items()
                       if K.DESIGN_LAUNCHES[k] != v}))
        return out

    eng.run_mixed = run_mixed
    return steps


def phase_quant(seed):
    """LLaMA-7B, 32 layers, random bf16 weights (seed): the paged slice's
    8 requests served with bf16, int8 and int4 weights and int8 with
    ``rope_kv_write`` (``LLM.compile(quantization=)``). Every layer
    projection of a quantized arm runs wq_matmul (launches by design; the
    plain dequantize path never), its tokens are greedy over their own
    teacher-forced prefix (near-ties within twice the distance of the two
    bf16 evaluations), and its first-step logits are read against the
    bf16-weights arm. Returns the launches of the arms' runs."""
    from flexflow_tpu_torch.quantization import quantized_nbytes

    cfg = llama.LLaMAConfig.llama_7b()
    gen = torch.Generator(device=DEV)
    gen.manual_seed(seed)
    params = llama.init_params(gen, cfg, device=DEV)
    prompts, new = _slice_prompts(seed, cfg)
    launches, first = {}, {}
    for label, quant, fused in QUANT_ARMS:
        t0 = time.perf_counter()
        llm = LLM(llama, cfg, params, device=DEV)
        llm.compile(ServingConfig(kv_layout="paged", max_cached_tokens=QUANT_BUDGET,
                                  fused_decode=fused), quantization=quant)
        qparams = llm.params
        rec = _record_steps(llm.engine)
        steps = _count_wq_steps(llm.engine)
        results, line = _serve(llm, prompts, new)
        plain = K.PLAIN_CALLS["wq_matmul"]
        outputs = [r.output_tokens for r in results]
        first[label] = torch.stack([rec[(i, len(p) - 1)] for i, p in enumerate(prompts)])
        check(line["preemptions"] == 0, f"quant-{label}: the budget preempted")
        check(plain == 0, f"quant-{label}: the plain dequantize path ran {plain} times")
        wq = {k: v for k, v in line["design_launches"].items() if k.startswith("wq_matmul[")}
        if quant:
            check(line["launches"].get(f"wq_matmul[{quant}]", 0) > 0,
                  f"quant-{label}: wq_matmul never launched")
            check(set(wq) == {"wq_matmul[splitk]", "wq_matmul[wgmma]"},
                  f"quant-{label}: wq_matmul designs {wq}, want splitk (decode) and wgmma "
                  "(mixed)")
            per_step = 7 * cfg.num_hidden_layers
            for width, took in steps:
                want = "wq_matmul[splitk]" if width == 1 else "wq_matmul[wgmma]"
                check(took == {want: per_step},
                      f"quant-{label}: a step of width {width} launched {took}, want "
                      f"{{{want!r}: {per_step}}}")
            line["wq_launches_per_decode_step"] = sorted(
                {sum(t.values()) for w, t in steps if w == 1})
        else:
            check(not wq, f"quant-{label}: wq_matmul ran on dense weights")
        prof = profile_slice(llm, prompts, new, f"quant-{label}") if quant and not fused else None
        t1 = time.perf_counter()
        served = _served_rows(rec, prompts, outputs)
        _free(llm)
        sc = ServingConfig(max_requests_per_batch=len(prompts), kv_layout="paged",
                           fused_decode=fused)
        forced = _next_token_logits(cfg, qparams, sc, prompts, outputs)
        tokens = _greedy_over_prefix(f"quant-{label}", outputs, forced, served)
        line.update(tokens=tokens, param_bytes=quantized_nbytes(qparams),
                    layer_param_bytes=quantized_nbytes(qparams["layers"]),
                    plain_dequantize_calls=plain,
                    seconds={"serve": t1 - t0, "teacher_forced": time.perf_counter() - t1})
        if prof is not None:
            line["profile"] = {k: prof[k] for k in ("wall_s", "device_busy_s",
                                                     "device_idle_share")}
            line["profile"]["wq_matmul_device_ms"] = prof["device_ms_by_class"].get(
                "wq_matmul", 0.0)
            line["profile"]["matmul_device_ms"] = prof["device_ms_by_class"].get("matmul", 0.0)
        if label != "bf16":
            line["first_step_vs_bf16_rel_l2"] = _rel(first[label], first["bf16"])
        check(all(bool(torch.isfinite(f).all()) for f in first.values()),
              f"quant-{label}: non-finite first-step logits")
        emit({"phase": "quant", "path": label, "model": "llama_7b",
              "layers": cfg.num_hidden_layers, "quantization": quant,
              "fused_decode": list(fused), "max_cached_tokens": QUANT_BUDGET, **line})
        for k, v in line["launches"].items():
            launches[k] = launches.get(k, 0) + v
        del qparams, served, forced, rec
        gc.collect()
        torch.cuda.empty_cache()
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return launches


OFFLOAD_PROMPT_LENS = (16, 40)
OFFLOAD_NEW = 8


def _h2d_gbps(nbytes=2 ** 30):
    """The pinned host-to-device copy rate, by CUDA events around a copy
    of ``nbytes`` (warm)."""
    host = torch.empty((nbytes,), dtype=torch.uint8, pin_memory=True)
    dev = torch.empty((nbytes,), dtype=torch.uint8, device=DEV)
    dev.copy_(host, non_blocking=True)
    ms = cuda_ms(lambda: dev.copy_(host, non_blocking=True), iters=5, warmup=1)
    del host, dev
    return nbytes / (ms / 1e3) / 1e9


def _host(tree):
    if isinstance(tree, dict):
        return {k: _host(v) for k, v in tree.items()}
    return tree.to("cpu")


def _offload_arm(cfg, host_params, prompts, offload):
    """One arm: LLM.compile(offload=) of host params, the device memory it
    took, then LLM.generate with each step's logits recorded."""
    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    llm = LLM(llama, cfg, host_params, device=DEV)
    sc = ServingConfig(kv_layout="paged", max_requests_per_batch=len(prompts),
                       max_sequence_length=256)
    t0 = time.perf_counter()
    llm.compile(sc, offload=offload)
    torch.cuda.synchronize()
    compile_s = time.perf_counter() - t0
    took = torch.cuda.memory_allocated() - base
    rec = _record_steps(llm.engine)
    llm.rm.stats = SchedulerStats()
    t0 = time.perf_counter()
    results = llm.generate(prompts, max_new_tokens=OFFLOAD_NEW)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    for r in results:
        check(r.error is None and len(r.output_tokens) == OFFLOAD_NEW,
              f"offload arm: request {r.request_id} failed: {r.error}")
    stats = llm.rm.stats.snapshot()
    steps = sum(stats[k] for k in ("mixed_steps", "decode_steps", "sync_steps"))
    out = {"tokens": [r.output_tokens for r in results],
           "first": torch.stack([rec[(i, len(p) - 1)] for i, p in enumerate(prompts)]),
           "device_bytes_after_compile": took, "compile_s": compile_s, "wall_s": wall,
           "steps": steps, "ms_per_step": wall / steps * 1e3,
           "copies": getattr(llm.params["layers"], "copies", 0)}
    _free(llm)
    return out


def phase_offload(seed):
    """LLaMA-7B, 32 layers, bf16 and int8 weights: 2 requests x 8 tokens
    served with the layers in pinned host memory (``offload=True``: each
    layer copied to one of two device buffers while the one before
    computes) against the same weights resident. Tokens and first-step
    logits bitwise equal; device memory after compile lower by at least
    90% of the layer weights' bytes; the offloaded step's ms beside its
    bound, the layer bytes over the pinned copy rate this phase
    measures."""
    from flexflow_tpu_torch.quantization import quantize_params, quantized_nbytes

    cfg = llama.LLaMAConfig.llama_7b()
    gen = torch.Generator(device=DEV)
    gen.manual_seed(seed)
    params = llama.init_params(gen, cfg, device=DEV)
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(1, cfg.vocab_size, size=n).tolist() for n in OFFLOAD_PROMPT_LENS]
    hosts = {"int8": _host(quantize_params(params, 8)), "bf16": _host(params)}
    del params
    gc.collect()
    torch.cuda.empty_cache()
    gbps = _h2d_gbps()
    emit({"phase": "offload_h2d", "pinned_h2d_gb_per_s": gbps, "bytes": 2 ** 30})
    for label in ("bf16", "int8"):
        host = hosts.pop(label)
        layer_bytes = quantized_nbytes(host["layers"])
        arms = {name: _offload_arm(cfg, host, prompts, off)
                for name, off in (("resident", False), ("offloaded", True))}
        res, off = arms["resident"], arms["offloaded"]
        saved = res["device_bytes_after_compile"] - off["device_bytes_after_compile"]
        check(res["tokens"] == off["tokens"], f"offload-{label}: tokens differ")
        check(torch.equal(res["first"], off["first"]),
              f"offload-{label}: first-step logits not bitwise")
        check(saved >= 0.9 * layer_bytes,
              f"offload-{label}: device memory lower by {saved} bytes, want >= 90% of "
              f"{layer_bytes}")
        emit({"phase": "offload", "path": label, "model": "llama_7b",
              "layers": cfg.num_hidden_layers, "prompt_lens": list(OFFLOAD_PROMPT_LENS),
              "new_tokens": OFFLOAD_NEW, "layer_bytes": layer_bytes,
              "device_bytes_saved": saved, "saved_share_of_layers": saved / layer_bytes,
              "tokens_bitwise": True, "first_logits_bitwise": True,
              "step_bound_ms": layer_bytes / (gbps * 1e9) * 1e3,
              **{f"{name}_{k}": v for name, arm in arms.items()
                 for k, v in arm.items() if k not in ("tokens", "first")}})
        del host, arms, res, off
        gc.collect()
        torch.cuda.empty_cache()


#: the cluster phase's placement pair: 11 prefix families x 3 requests,
#: a 512-token family prefix and 16-64 own tokens, 32 new tokens, two
#: replicas of 16 slots at 32 layers; the other arms at 8 layers
CLUSTER_FAMILIES = 11
CLUSTER_PREFIX = 512
CLUSTER_NEW = 32
CLUSTER_SMALL_LAYERS = 8
CLUSTER_SMALL_NEW = 16
CLUSTER_SERVE = dict(kv_layout="paged", max_sequence_length=1024, prefix_caching=True)


def _cluster_prompts(rng, cfg):
    fams = [rng.integers(1, cfg.vocab_size, size=CLUSTER_PREFIX).tolist()
            for _ in range(CLUSTER_FAMILIES)]
    return [[f + rng.integers(1, cfg.vocab_size, size=int(rng.integers(16, 65))).tolist()
             for _ in range(3)] for f in fams]


def _cluster_run(cm, waves, new):
    """Each wave of prompts through ``cm.generate`` in turn (a family's
    first request publishes its prefix before its relatives arrive);
    returns the results and the figures of the run."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results = []
    for wave in waves:
        results += cm.generate(wave, max_new_tokens=new)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    for r in results:
        check(r.error is None and len(r.output_tokens) == new,
              f"cluster: request {r.request_id} failed: {r.error}")
    s = cm.cluster_stats()
    ttft = [r.profile.ttft_s for r in results]
    return results, {
        "requests": len(results), "wall_s": wall,
        "tokens_per_s": len(results) * new / wall, "ttft_s_mean": statistics.mean(ttft),
        "ttft_s_max": max(ttft), "placements": s["placements"],
        "prefix_hit_rate": s["replicas"]["prefix_hit_rate"],
        "prefix_hits": s["replicas"]["prefix_hits"],
        "by_replica": dict(collections.Counter(r.profile.replica_id for r in results))}


def _hold_cluster_tokens(label, cfg, params, prompts, outputs, want, serving):
    """Tokens of a cluster arm against the reference run's: bitwise where
    the card gives that; otherwise each served token greedy over its own
    prefix under the teacher-forced logits (near-ties within twice the
    kernels and plain paths' distance there). Returns the contract that
    held."""
    if outputs == want:
        return {"contract": "bitwise"}
    sc = dataclasses.replace(serving, max_requests_per_batch=len(prompts), prefix_caching=False)
    got = _next_token_logits(cfg, params, sc, prompts, outputs)
    plain = _next_token_logits(cfg, params, dataclasses.replace(sc, kernels="torch"), prompts,
                               outputs)
    row = _greedy_over_prefix(label, outputs, got, plain)
    return {"contract": "greedy under the tie rule", **row}


class _record_migrations:
    """Within it, every migration the cluster runs compares the source's
    page bytes fetched before the source releases them with the
    destination's after adoption (codes, quantized scale rows), and times
    the hand-off."""

    def __init__(self):
        from flexflow_tpu_torch.serve.cluster import manager as CM

        self.mod, self.orig, self.rows = CM, CM.migrate_request, []

    def __enter__(self):
        def wrapped(src, dst, rid, gen, **kw):
            req = src.rm.requests[rid]
            n = src.engine.pager.pages_for(req.prompt_len)
            pages = [int(p) for p in src.engine.pager.table[req.slot][:n]]
            before = [src.engine.fetch_page(p).host_values() for p in pages]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rid2 = self.orig(src, dst, rid, gen, **kw)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            if rid2 is not None:
                slot = dst.rm.requests[rid2].slot
                for b, p in zip(before, dst.engine.pager.table[slot][:n]):
                    after = dst.engine.fetch_page(int(p)).host_values()
                    check(sorted(after) == sorted(b) and all(torch.equal(after[k], b[k])
                                                             for k in b),
                          "cluster: a migrated page is not byte-exact")
                self.rows.append({"pages": n, "ms": ms})
            return rid2
        self.mod.migrate_request = wrapped
        return self

    def __exit__(self, *exc):
        self.mod.migrate_request = self.orig


def phase_cluster(seed):
    """In-process clusters of LLaMA-7B replicas (full width, random bf16
    weights from the seed, paged bf16, kernels="cuda"): the placement pair
    at 32 layers (prefix routing against round robin: two replicas of 16
    slots, CLUSTER_FAMILIES prefix families of three); then at
    CLUSTER_SMALL_LAYERS layers the 1-replica cluster against the bare
    engine (tokens and logits bitwise), disaggregated 1 + 1 pools on bf16
    and int8 pages (every page byte-exact across the hand-off), a
    scripted crash of replica 1 (failover: every request terminal with no
    error, no leak or held slot on the survivor) and a warm standby's
    adoption. Returns the launches of the placement pair's runs."""
    from flexflow_tpu_torch.serve.cluster import ClusterManager, FaultPlan
    from flexflow_tpu_torch.serve.cluster import Fault

    cfg = llama.LLaMAConfig.llama_7b()
    gen = torch.Generator(device=DEV)
    gen.manual_seed(seed)
    params = llama.init_params(gen, cfg, device=DEV)
    rng = np.random.default_rng(seed)
    fams = _cluster_prompts(rng, cfg)
    waves = ([f[0] for f in fams], [p for f in fams for p in f[1:]])
    K.reset_launch_counts()
    pair = {}
    for policy in ("prefix", "round_robin"):
        cm = ClusterManager.build(llama, cfg, params,
                                  ServingConfig(replicas=2, router_policy=policy,
                                                **CLUSTER_SERVE), device=DEV)
        cm.generate([[1, 2, 3]], max_new_tokens=2)  # warm-up
        cm.stats = type(cm.stats)()
        _, pair[policy] = _cluster_run(cm, waves, CLUSTER_NEW)
        cm.check_no_leaks()
        emit({"phase": "cluster", "path": f"placement-{policy}", "model": "llama_7b",
              "layers": cfg.num_hidden_layers, "replicas": 2, "slots": 16,
              "families": CLUSTER_FAMILIES, "prefix_tokens": CLUSTER_PREFIX, **pair[policy]})
        del cm
        gc.collect()
        torch.cuda.empty_cache()
    check(pair["prefix"]["placements"].get("prefix", 0) > 0,
          "cluster: prefix routing placed nothing by match")
    launches = {k: v for k, v in K.LAUNCHES.items() if v}

    small = dataclasses.replace(cfg, num_hidden_layers=CLUSTER_SMALL_LAYERS)
    sparams = dict(params, layers={n: w[:CLUSTER_SMALL_LAYERS]
                                   for n, w in params["layers"].items()})
    prompts, _ = _slice_prompts(seed, cfg)
    new = CLUSTER_SMALL_NEW
    serving = ServingConfig(kv_layout="paged")
    # the bare engine, its logits recorded
    llm = LLM(llama, small, sparams, device=DEV)
    llm.compile(serving)
    rec_bare = _record_steps(llm.engine)
    bare = [r.output_tokens for r in llm.generate(prompts, max_new_tokens=new)]
    _free(llm)
    cm = ClusterManager.build(llama, small, sparams, dataclasses.replace(serving, replicas=1),
                              device=DEV)
    rec_one = _record_steps(cm.replicas[0].engine)
    one = [r.output_tokens for r in cm.generate(prompts, max_new_tokens=new)]
    check(one == bare, "cluster: 1 replica's tokens are not the bare engine's")
    check(sorted(rec_one) == sorted(rec_bare)
          and all(torch.equal(rec_one[k], rec_bare[k]) for k in rec_bare),
          "cluster: 1 replica's logits are not bitwise the bare engine's")
    emit({"phase": "cluster", "path": "one-replica", "layers": CLUSTER_SMALL_LAYERS,
          "requests": len(prompts), "new_tokens": new, "tokens_bitwise": True,
          "logits_bitwise": True, "logit_rows": len(rec_bare)})
    del cm, rec_one, rec_bare
    for quant in (None, "int8"):
        sv = dataclasses.replace(serving, kv_quant=quant, replicas=2, prefill_replicas=1,
                                 decode_replicas=1)
        want = bare
        if quant is not None:
            llm = LLM(llama, small, sparams, device=DEV)
            llm.compile(dataclasses.replace(serving, kv_quant=quant))
            want = [r.output_tokens for r in llm.generate(prompts, max_new_tokens=new)]
            _free(llm)
        cm = ClusterManager.build(llama, small, sparams, sv, device=DEV)
        with _record_migrations() as mig:
            outs = cm.generate(prompts, max_new_tokens=new)
        s = cm.cluster_stats()
        check(all(r.error is None for r in outs), "cluster: a disaggregated request failed")
        check(s["migrations"] == len(prompts) == len(mig.rows),
              f"cluster: {s['migrations']} migrations for {len(prompts)} requests")
        cm.check_no_leaks()
        check(cm.replicas[0].rm.hold_finished == set(), "cluster: prefill pool holds slots")
        got = [r.output_tokens for r in outs]
        held = _hold_cluster_tokens(f"disagg-{quant or 'bf16'}", small, sparams, prompts, got,
                                    want, dataclasses.replace(serving, kv_quant=quant))
        emit({"phase": "cluster", "path": f"disaggregated-{quant or 'bf16'}",
              "layers": CLUSTER_SMALL_LAYERS, "kv_quant": quant, "requests": len(prompts),
              "migrations": s["migrations"], "migrated_pages": s["migrated_pages"],
              "migrated_bytes": s["migrated_bytes"], "pages_byte_exact": True,
              "migration_ms": {"mean": statistics.mean(r["ms"] for r in mig.rows),
                               "max": max(r["ms"] for r in mig.rows)},
              "tokens": held})
        del cm
        gc.collect()
        torch.cuda.empty_cache()
    # failover: a crash of replica 1 about a third of the way through its steps
    rr = dataclasses.replace(serving, replicas=2, router_policy="round_robin")
    cm = ClusterManager.build(llama, small, sparams, rr, device=DEV)
    free_run = [r.output_tokens for r in cm.generate(prompts, max_new_tokens=new)]
    crash_at = max(2, cm.replicas[1].steps_taken // 3)
    del cm
    cm = ClusterManager.build(llama, small, sparams, rr, device=DEV)
    cm.attach_faults(FaultPlan([Fault("crash", replica=1, step=crash_at)]))
    outs = cm.generate(prompts, max_new_tokens=new)
    s = cm.cluster_stats()
    check(all(r.error is None and len(r.output_tokens) == new for r in outs),
          "cluster: a request failed across the failover")
    check(all(cm._terminal(c) for c in cm.requests), "cluster: a request is not terminal")
    check(s["failovers"] > 0 and s["replica_down"] == 1, f"cluster: failover counters {s}")
    cm.check_no_leaks()
    check(cm.replicas[0].rm.hold_finished == set(), "cluster: the survivor holds slots")
    held = _hold_cluster_tokens("failover", small, sparams, prompts,
                                [r.output_tokens for r in outs], free_run, serving)
    emit({"phase": "cluster", "path": "failover", "layers": CLUSTER_SMALL_LAYERS,
          "crash_at_step": crash_at, "failovers": s["failovers"], "retries": s["retries"],
          "replica_down": s["replica_down"], "health": cm.health_snapshot(),
          "moved": sum(r.profile.retries > 0 for r in outs), "tokens": held})
    del cm
    # a warm standby adopts the dead replica's position and prefix families
    sb = dataclasses.replace(serving, replicas=2, router_policy="round_robin",
                             prefix_caching=True, standby_replicas=1)
    cm = ClusterManager.build(llama, small, sparams, sb, device=DEV)
    first = [cm.generate([f[0]], max_new_tokens=4)[0].profile.replica_id for f in fams[:2]]
    check(first == [0, 1], f"cluster: the two families landed on {first}")
    cm.attach_faults(FaultPlan([Fault("crash", replica=1,
                                      step=cm.replicas[1].steps_taken + 1)]))
    cids = [cm.submit(f[1], max_new_tokens=4) for f in fams[:2]]
    score = None
    for _ in range(100):
        cm.step()
        if cm.stats.standby_adoptions:
            score = cm.replicas[1].prefix_score(fams[1][1])
            break
    check(score is not None and score > 0,
          f"cluster: the adopted standby scores {score} on the dead replica's family")
    while not all(cm._terminal(c) for c in cids):
        if not cm.step():
            break
    cm.drain()
    res = [cm.result(c) for c in cids]
    check(all(r.error is None and len(r.output_tokens) == 4 for r in res),
          f"cluster: {[r.error for r in res]}")
    check(cm.stats.standby_adoptions == 1, "cluster: standby adoptions != 1")
    cm.check_no_leaks()
    emit({"phase": "cluster", "path": "standby", "layers": CLUSTER_SMALL_LAYERS,
          "standby_adoptions": cm.stats.standby_adoptions, "adopted_prefix_score": score,
          "prefix_tokens": CLUSTER_PREFIX, "replica_ids": [r.index for r in cm.replicas],
          "served_by": [r.profile.replica_id for r in res],
          "failovers": cm.stats.failovers})
    del cm, params, sparams
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
    # the decode design (csrc/paged_decode.cuh) of each, by pool type
    **{f"ragged_paged_attention[{t}/decode]": (
        "flexflow_tpu_torch/csrc/ragged_paged_attention.cu", "flexflow_tpu/serve/kernels.py:713")
       for t in K.POOL_TYPES},
    **{f"fused_rope_paged_attention[{t}/decode]": (
        "flexflow_tpu_torch/csrc/fused_rope_paged_attention.cu",
        "flexflow_tpu/serve/kernels.py:1067") for t in K.POOL_TYPES},
    "flash_attention_fwd": ("flexflow_tpu_torch/csrc/flash_attention_fwd.cu",
                            "flexflow_tpu/ops/flash_attention.py:101"),
    "flash_attention_bwd_kv": ("flexflow_tpu_torch/csrc/flash_attention_bwd.cu",
                               "flexflow_tpu/ops/flash_attention.py:142"),
    "flash_attention_bwd_q": ("flexflow_tpu_torch/csrc/flash_attention_bwd.cu",
                              "flexflow_tpu/ops/flash_attention.py:203"),
    # no Pallas kernel: XLA fuses these in the JAX package
    "adam_update": ("flexflow_tpu_torch/csrc/adam_update.cu",
                    "flexflow_tpu/optimizers.py:94 (AdamOptimizer.update, no TPU kernel)"),
    **{f"paged_commit[{t}]": ("flexflow_tpu_torch/csrc/paged_commit.cu",
                              "flexflow_tpu/serve/kv_quant.py:147 (quant_line_write, "
                              "no TPU kernel)") for t in K.QUANT_POOL_TYPES},
    # one kernel replaces both TPU kernels of the whole-step walk
    **{f"whole_step_decode[{t}]": (
        "flexflow_tpu_torch/csrc/whole_step_decode.cu",
        "flexflow_tpu/serve/kernels.py:1385 (whole_step_decode) and "
        "flexflow_tpu/serve/kernels.py:1612 (_whole_step_decode_tiled)") for t in K.POOL_TYPES},
    # the speculation fold's launches (all_logits: SpecInfer's draft and
    # verify steps) of the whole-step spec arms, by pool type
    **{f"whole_step_decode[{t}/tree]": (
        "flexflow_tpu_torch/csrc/whole_step_decode.cu",
        "flexflow_tpu/serve/kernels.py:1385 (whole_step_decode, with the spec fold of "
        "flexflow_tpu/models/llama.py:1327 serve_step_whole)") for t in FOLD_ROWS},
    # the generic decoder's body (slice 16): each family's bf16 decode case,
    # its launches from the families phase's whole-step arms
    **{f"whole_step_decode[{name}]": (
        "flexflow_tpu_torch/csrc/whole_step_decode.cu",
        "flexflow_tpu/serve/kernels.py:1385 (whole_step_decode) and "
        "flexflow_tpu/serve/kernels.py:1612 (_whole_step_decode_tiled), with the body of "
        "flexflow_tpu/models/transformer.py:1521 serve_step_whole")
       for name in WHOLE_GENERIC_ROWS},
    # the paged kernels at the other families' head dims and MQA width
    # (FAMILY_KERNEL_CASES; launches from the families phase)
    **{f"{k}[{g}]": (f"flexflow_tpu_torch/csrc/{k}.cu", line)
       for g in ("dk80", "dk256", "mqa-g71")
       for k, line in (("ragged_paged_attention", "flexflow_tpu/serve/kernels.py:713"),
                       ("fused_rope_paged_attention", "flexflow_tpu/serve/kernels.py:1067"))},
    **{f"paged_commit[{g}]": ("flexflow_tpu_torch/csrc/paged_commit.cu",
                              "flexflow_tpu/serve/kv_quant.py:147 (quant_line_write, "
                              "no TPU kernel)") for g in ("dk80", "dk256")},
    # weight-only quantized projections (slice 18): XLA fuses dequantize
    # into the dot in the JAX package
    **{f"wq_matmul[{t}]": ("flexflow_tpu_torch/csrc/wq_matmul.cu",
                           "flexflow_tpu/quantization.py:66 (dequantize) in "
                           "flexflow_tpu/models/llama.py:197 (_mm), no TPU kernel")
       for t in K.QUANT_POOL_TYPES},
}
PHASES = ("kernels", "slice", "obs", "paged", "whole", "spec", "f32", "entry", "families",
          "prefix", "quant", "offload", "cluster", "train_parity", "train")


def main(argv=None) -> int:
    # the run drives one card: expose only it before CUDA starts
    os.environ["CUDA_VISIBLE_DEVICES"] = one_card(os.environ.get("CUDA_VISIBLE_DEVICES"))
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma list of kernels, slice, obs, paged, whole, spec, f32, entry, "
                         "families, prefix, quant, offload, cluster, train_parity, train "
                         "(device and build always run; "
                         "paged and whole need slice; obs makes the slice's weights itself "
                         "without it)")
    args = ap.parse_args(argv)
    phases = set(args.phases.split(","))
    t_start = time.perf_counter()
    marks = []

    def mark(name):
        marks.append((name, time.perf_counter()))
    smi = phase_device()
    spills = phase_build()
    mark("build")
    main_rows, launches = {}, {}
    if "kernels" in phases:
        main_rows = phase_kernels(args.seed)
        main_rows.update(phase_paged_kernels(args.seed))
        main_rows.update(phase_family_kernels(args.seed))
        main_rows.update(phase_whole_kernels(args.seed))
        main_rows.update(phase_flash_kernels(args.seed))
        main_rows.update(run_adam_check(args.seed))
        main_rows.update(phase_wq_kernels(args.seed))
        mark("kernels")
    if "slice" in phases:
        holder = [None]
        holder[0], dense = phase_slice(args.seed)
        launches.update(dense)
        mark("slice")
        if "obs" in phases:
            phase_obs(args.seed, holder[0], smi)
            mark("obs")
        arms = ((PAGED_ARMS if "paged" in phases else ())
                + (WHOLE_ARMS if "whole" in phases else ()))
        if arms:
            launches.update({k: v for k, v in phase_paged(args.seed, holder, arms).items()
                             if "[f32]" not in k})
        del holder
        gc.collect()
        torch.cuda.empty_cache()
        mark("paged+whole")
    elif "obs" in phases:  # the slice's weights, made from the seed
        gen = torch.Generator(device=DEV)
        gen.manual_seed(args.seed)
        phase_obs(args.seed, llama.init_params(gen, llama.LLaMAConfig.llama_7b(), device=DEV),
                  smi)
        gc.collect()
        torch.cuda.empty_cache()
        mark("obs")
    if "spec" in phases:
        for k, v in phase_spec(args.seed).items():
            launches[k] = launches.get(k, 0) + v
        mark("spec")
    if "f32" in phases:
        launches.update(phase_f32(args.seed))
        mark("f32")
    if "entry" in phases:
        phase_entry(args.seed)
        mark("entry")
    if "families" in phases:
        launches.update(phase_families(args.seed))
        mark("families")
    if "prefix" in phases:
        for k, v in phase_prefix(args.seed).items():
            launches[k] = launches.get(k, 0) + v
        mark("prefix")
    for name, run in (("quant", phase_quant), ("offload", phase_offload),
                      ("cluster", phase_cluster)):
        if name in phases:
            for k, v in (run(args.seed) or {}).items():
                launches[k] = launches.get(k, 0) + v
            mark(name)
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
        if name.split("[")[0] in K.PAGED_KERNELS:
            rows[-1].update(design=m.get("design"), graph_ms=m.get("graph_ms"),
                            library_graph_ms=m.get("library_graph_ms"))
        elif name.split("[")[0] in ("verify_attention",) + FLASH_KERNELS:
            rows[-1].update(design=m.get("design"), device_ms=m.get("device_ms"))
        if name.endswith("/decode]") or name == "decode_attention":
            rows[-1].update(splits=m.get("splits"), blocks=m.get("blocks"))
            for extra in ("gqa_kv8", "gqa_g16", "f32", "graph_ms", "library_graph_ms",
                          "design", "split_lines"):
                if extra in m:
                    rows[-1][extra] = m[extra]
        if name.split("[")[0] in ("adam_update", "paged_commit"):
            rows[-1]["bitwise"] = m.get("bitwise")
        if name.startswith("paged_commit["):  # the device time beside the first design's
            rows[-1].update(design=m.get("design"), graph_ms=m.get("graph_ms"),
                            serial=m.get("serial"))
        if "cases" in m:  # the other families' shapes: every case of the row's group
            rows[-1]["cases"] = m["cases"]
        if name.startswith("wq_matmul["):
            rows[-1].update(design=m.get("design"), graph_ms=m.get("graph_ms"),
                            bf16_matmul_graph_ms=m.get("bf16_matmul_graph_ms"))
    emit({"phase": "done", "seconds": time.perf_counter() - t_start,
          "phase_seconds": {name: t - (marks[i - 1][1] if i else t_start)
                            for i, (name, t) in enumerate(marks)},
          "peak_memory_bytes": max(_PEAKS + [torch.cuda.max_memory_allocated()])})
    print(json.dumps({"kernels": rows}), flush=True)
    check(not spills, f"whole-step functions spill (ptxas -v): {spills}")
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
