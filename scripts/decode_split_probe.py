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
case's bound (``chip_smoke._paged_bound``); a decode case under the rule
also carries a digest of the ragged kernel's output and of the fused
kernel's output and pools (one call on fresh pools), so that two trees'
lines show whether a change kept the paged decode bits. The digests
leave out the scratch page and the rows that read it (the idle slot's
padding row, whose fused output races its own commit to that page and is
never read), as ``chip_smoke.run_fused_check`` compares. Unless ``--kv``
is given, the dense decode kernel follows at chip_smoke's decode cases
(``dense_graph_ms`` beside SDPA's ``sdpa_graph_ms`` and the bound, which
counts the lines attended). Imports nothing of JAX; needs a CUDA GPU
(``--build-only`` only nvcc).
"""
from __future__ import annotations

import argparse
import hashlib
import json
import sys
from pathlib import Path

import numpy as np
import torch

THIS = Path(__file__).resolve().parent.parent

# the dense decode cases of chip_smoke.phase_kernels: (label, dtype, R, S1,
# H, KV, dk, lens; None: chip_smoke's 16 decode lengths)
DENSE_CASES = (("llama7b", torch.bfloat16, 16, 2113, 32, 32, 128, None),
               ("llama7b-gqa", torch.bfloat16, 16, 2113, 32, 8, 128, None),
               ("llama7b-f32", torch.float32, 16, 2113, 32, 32, 128, None),
               ("gqa-g16-small", torch.bfloat16, 4, 513, 32, 2, 128, [0, 17, 256, 512]))


def digest(*tensors) -> str:
    """The first 16 hex digits of the sha256 of the tensors' bytes."""
    h = hashlib.sha256()
    for t in tensors:
        if t is not None:
            h.update(t.contiguous().view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()[:16]


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
            if name == "rule" and kind == "decode":
                fresh = [None if case[k] is None else case[k].clone()
                         for k in ("kp", "vp", "ks", "vs")]
                out = K.fused_rope_paged_attention(q, k_new, v_new, cos, sin, fresh[0], fresh[1],
                                                   table, logical, off, mask, k_scale=fresh[2],
                                                   v_scale=fresh[3], qmax=qmax)
                P = case["P"]
                live = ~(mask & (table == P).repeat_interleave(ps, dim=1)[:, None]).any(-1)
                line.update(ragged_sha=digest(got[live]), fused_sha=digest(
                    out[live], *(None if t is None else t[:P] for t in fresh)))
                del fresh, out
            line.update(max_abs_err=err, ragged_graph_ms=graph_ms(ragged),
                        fused_graph_ms=graph_ms(fused))
            if split:
                K.DECODE_SPLIT_LINES, K.DECODE_SPLIT_BLOCKS = rule
            print(json.dumps(line), flush=True)
        del case, pools, want
        torch.cuda.empty_cache()
    if args.kv is not None:
        return 0
    gen.manual_seed(args.seed + 3)
    for label, dtype, R, S1, H, KV, dk, lens in DENSE_CASES:
        q, k, v, sl = cs._decode_case(gen, dtype, R, S1, H, KV, dk, lens or cs.DECODE_LENS)
        want = K.decode_attention_ref(q, k, v, sl)
        got = K.decode_attention(q, k, v, sl)
        err = float((got.float() - want.float()).abs().max())
        tol = cs.TOL[dtype]
        cs.check(bool(torch.isclose(got.float(), want.float(), atol=tol["atol"],
                                    rtol=tol["rtol"]).all()), f"dense {label}: {err}")
        valid = (torch.arange(S1, device=cs.DEV)[None, :] < sl[:, None])[:, None, :]
        sq, sk, svv, smask = cs._sdpa_inputs(q[:, None], k, v, valid)
        line = {"tree": str(root), "case": f"dense-{label}", "max_abs_err": err,
                "bound_ms": cs._decode_bound(q, k, sl)[0],
                "dense_graph_ms": graph_ms(lambda: K.decode_attention(q, k, v, sl)),
                "sdpa_graph_ms": graph_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
                    sq, sk, svv, attn_mask=smask))}
        if hasattr(K, "dense_decode_split"):
            line["split_lines"], line["splits"] = K.dense_decode_split(
                R, KV, S1, K.dense_head_groups(H // KV))
        print(json.dumps(line), flush=True)
        del q, k, v, sq, sk, svv
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
