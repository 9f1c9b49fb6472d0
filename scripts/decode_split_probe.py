#!/usr/bin/env python3
"""The paged kernels at the serving slices' shapes on one GPU, timed by
CUDA-graph replay, under split lengths of the decode design other than
the rule's, and in another tree.

    python3 scripts/decode_split_probe.py [--lines 64,128,256,512,1024]
    python3 scripts/decode_split_probe.py --root _proof/parent --lines ""
    python3 scripts/decode_split_probe.py --kv 8 --lines "" [--build-only]

For each case of ``chip_smoke.PAGED_CASES`` that chip_smoke times (16
slots, 17 pages of 128, LLaMA-7B widths; decode: ``DECODE_LENS``; mixed:
C = 128) it times the ragged and the fused kernel by ``chip_smoke.graph_ms``
(a CUDA graph of 20 calls: the device's time without the host's), and a
decode case again under every split length in ``--lines`` forced; it
prints one JSON line per case and setting (the split pages, count and
blocks where the tree's kernels split). The card's name and power limit
come first. ``--root`` takes the package and chip_smoke's cases from
another checkout (a parent tree, whose own chip_smoke may lack graph_ms:
the timer is this tree's). ``--build-only`` builds the tree's paged
kernels, prints each split decode instantiation's registers and spills
(``chip_smoke._split_report``) and stops, so that two trees can build at
once. ``--lens N`` gives every decode slot N lines in place of
``DECODE_LENS``; ``--kv N`` times the decode cases alone, each at N
key/value heads (G = 32 / N query rows a KV head). Each line carries the
case's bound (``chip_smoke._paged_bound``). Imports nothing of JAX;
needs a CUDA GPU (``--build-only`` only nvcc).
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch

THIS = Path(__file__).resolve().parent.parent


def _load(root: Path):
    """chip_smoke and the port's modules from checkout ``root``, and this
    tree's graph timer."""
    sys.path.insert(0, str(THIS))
    import chip_smoke

    timer = chip_smoke.graph_ms
    if root != THIS:
        for name in list(sys.modules):
            if name == "chip_smoke" or name.startswith("flexflow_tpu_torch"):
                del sys.modules[name]
        sys.path[0] = str(root)
        import chip_smoke
    from flexflow_tpu_torch.models import llama
    from flexflow_tpu_torch.serve import kernels
    from flexflow_tpu_torch.serve import kv_quant
    return chip_smoke, llama, kernels, kv_quant, timer


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--lines", default="64,128,256,512,1024")
    ap.add_argument("--root", default=str(THIS))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--build-only", action="store_true")
    ap.add_argument("--lens", type=int, default=None,
                    help="every decode slot holds this many lines (default DECODE_LENS)")
    ap.add_argument("--kv", type=int, default=None,
                    help="time the decode cases alone, at this many KV heads")
    args = ap.parse_args(argv)
    root = Path(args.root).resolve()
    cs, llama, K, KQ, graph_ms = _load(root)
    if args.lens is not None:
        cs.DECODE_LENS = [args.lens] * len(cs.DECODE_LENS)
    if args.build_only:  # and each split decode instantiation's registers and spills
        from flexflow_tpu_torch.serve import _cuda

        for row in cs._split_report(_cuda.build(list(K.PAGED_KERNELS))):
            print(json.dumps({"tree": str(root), **row}), flush=True)
        return 0
    print(cs.phase_device(), flush=True)
    gen = torch.Generator(device=cs.DEV)
    gen.manual_seed(args.seed + 2)
    rng = np.random.default_rng(args.seed + 2)
    split = hasattr(K, "paged_decode_split")
    settings = [("rule", None)] + [(int(x), ((int(x),), 0)) for x in args.lines.split(",") if x]
    for label, dtype, quant, KV, kind, timed in cs.PAGED_CASES:
        if not timed or (args.kv is not None and kind != "decode"):
            continue
        if args.kv is not None:
            if "gqa" in label:  # the bf16 case at KV 8 already
                continue
            KV = args.kv
        case = cs._paged_case(gen, rng, dtype, quant, KV, kind)
        q, table, mask, pos = case["q"], case["table"], case["mask"], case["pos"]
        R, C, ps = case["R"], case["C"], case["ps"]
        k_new = cs._rand((R, C, KV, case["dk"]), dtype, gen)
        v_new = cs._rand((R, C, KV, case["dk"]), dtype, gen)
        cos, sin = llama.rope_freqs(llama.LLaMAConfig.llama_7b(), pos)
        logical, off = (pos // ps).to(torch.int32), (pos % ps).to(torch.int32)
        qmax = None if quant is None else KQ.SPECS[quant].qmax
        pools = [None if case[k] is None else case[k].clone() for k in ("kp", "vp", "ks", "vs")]

        def ragged():
            return K.ragged_paged_attention(q, case["kp"], case["vp"], table, mask,
                                            k_scale=case["ks"], v_scale=case["vs"])

        def fused():
            return K.fused_rope_paged_attention(q, k_new, v_new, cos, sin, pools[0], pools[1],
                                                table, logical, off, mask, k_scale=pools[2],
                                                v_scale=pools[3], qmax=qmax)

        want = K.ragged_paged_attention_ref(q, case["kp"], case["vp"], table, mask,
                                            k_scale=case["ks"], v_scale=case["vs"])
        tol = cs.TOL[dtype]
        for name, forced in settings if (split and kind == "decode") else settings[:1]:
            line = {"tree": str(root), "case": label, "kv": KV,
                    "split_lines": name, "lens": args.lens,
                    "bound_ms": cs._paged_bound(case, dtype)[0]}
            if split:
                rule = K.DECODE_SPLIT_LINES, K.DECODE_SPLIT_BLOCKS
                if forced:
                    K.DECODE_SPLIT_LINES, K.DECODE_SPLIT_BLOCKS = forced
                pages, n = K.paged_decode_split(R, C, KV, case["NP"], ps)
                line.update(split_pages=pages, splits=n, blocks=R * KV * n)
            got = ragged()
            err = float((got.float() - want.float()).abs().max())
            cs.check(bool(torch.isclose(got.float(), want.float(), atol=tol["atol"],
                                        rtol=tol["rtol"]).all()), f"{label} at {name}: {err}")
            line.update(max_abs_err=err, ragged_graph_ms=graph_ms(ragged),
                        fused_graph_ms=graph_ms(fused))
            if split:
                K.DECODE_SPLIT_LINES, K.DECODE_SPLIT_BLOCKS = rule
            print(json.dumps(line), flush=True)
        del case, pools, want
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
