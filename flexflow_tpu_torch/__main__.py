"""Command line — ``python -m flexflow_tpu_torch <cmd>``.

Counterpart of ``flexflow_tpu/__main__.py``. One command so far:

  serve   incremental decoding, SpecInfer or beam search over a local HF
          checkpoint directory (``--model-dir``), or over a tiny model of
          random weights when it is omitted; prints each request's output
          and a profile line.

It runs on the GPU (``--device cuda``, the default; it raises without
one) with the hand-written kernels (``--kernels cuda``, the default; the
JAX package's ``--pallas``); ``--device cpu --kernels torch`` runs the
plain PyTorch path. A prompt is text (it needs the checkpoint's
tokenizer) or token ids, comma- or space-separated (``--prompt
"3,17,91"``).

The JAX command's parallelism degrees, prefix caching and the host tier,
clusters and autoscaling, observability, weight quantization and offload
come with later slices (ROADMAP.md queue 1).
"""
from __future__ import annotations

import argparse
import dataclasses
import re
from typing import List, Sequence, Union


def _prompt(text: str) -> Union[str, List[int]]:
    """A ``--prompt``: token ids when it is integers separated by commas
    or spaces, else text."""
    parts = [p for p in re.split(r"[,\s]+", text.strip()) if p]
    if parts and all(re.fullmatch(r"\d+", p) for p in parts):
        return [int(p) for p in parts]
    return text


def cmd_serve(args) -> None:
    import torch

    from .models import llama
    from .serve import GenerationConfig, ServingConfig, SpecConfig
    from .serve.llm import LLM, SSM

    if args.model_dir:
        llm = LLM.from_pretrained(args.model_dir, device=args.device)
    else:  # the JAX command's tiny random model
        cfg = llama.LLaMAConfig(
            vocab_size=512, hidden_size=128, intermediate_size=344,
            num_hidden_layers=4, num_attention_heads=8,
            num_key_value_heads=4, max_position_embeddings=512,
            dtype=torch.float32,
        )
        llm = LLM(llama, cfg, device=args.device)
    sc = ServingConfig(
        max_requests_per_batch=args.max_requests_per_batch,
        max_sequence_length=args.max_sequence_length,
        kernels=args.kernels,
        kv_layout=args.kv_layout,
        page_size=args.page_size,
        max_cached_tokens=args.max_cached_tokens,
        kv_quant=args.kv_quant,
        fused_decode=tuple(s for s in (args.fused_decode or "").split(",") if s),
        cache_dtype=llm.cfg.dtype,
    )
    ssms: Sequence[LLM] = []
    spec = None
    if args.ssm_dir or args.spec:
        if args.ssm_dir:
            ssms = [SSM.from_pretrained(args.ssm_dir, device=args.device)]
        else:  # layer-skip self-draft: the target's first quarter of layers
            k = max(1, llm.cfg.num_hidden_layers // 4)
            dcfg = dataclasses.replace(llm.cfg, num_hidden_layers=k)
            dparams = dict(llm.params)
            dparams["layers"] = {n: v[:k] for n, v in llm.params["layers"].items()}
            ssms = [SSM(llm.family, dcfg, dparams, device=args.device)]
        spec = SpecConfig(beam_width=2, beam_depth=4)
    llm.compile(sc, ssms=ssms, spec=spec)
    prompts = [_prompt(p) for p in args.prompt] if args.prompt else [[3, 17, 91, 42, 7]]
    gen = GenerationConfig(num_beams=args.num_beams)
    outs = llm.generate(prompts, gen=gen if args.num_beams > 1 else None,
                        max_new_tokens=args.max_new_tokens)
    for o in outs:
        p = o.profile
        print(o.output_text or o.output_tokens)
        print(f"  [steps={p.llm_decoding_steps} accepted={p.accepted_tokens} "
              f"latency={p.latency_s:.2f}s]")


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="flexflow_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)
    s = sub.add_parser("serve", help="incremental / speculative serving")
    s.add_argument("--model-dir", default=None,
                   help="a local HF checkpoint directory (config.json and "
                        "*.safetensors or pytorch_model*.bin); a tiny random "
                        "model when omitted")
    s.add_argument("--ssm-dir", default=None,
                   help="a local HF checkpoint of the SpecInfer draft model")
    s.add_argument("--spec", action="store_true",
                   help="SpecInfer with a layer-skip self-draft")
    s.add_argument("--prompt", action="append", default=None,
                   help="a prompt: text, or token ids separated by commas or "
                        "spaces (repeat for several requests)")
    s.add_argument("--max-new-tokens", type=int, default=32)
    s.add_argument("--max-requests-per-batch", type=int, default=4)
    s.add_argument("--max-sequence-length", type=int, default=512)
    s.add_argument("--num-beams", type=int, default=1)
    s.add_argument("--kv-layout", choices=["dense", "paged"], default="dense",
                   help="paged = block-paged KV cache")
    s.add_argument("--page-size", type=int, default=128)
    s.add_argument("--max-cached-tokens", type=int, default=None,
                   help="paged KV pool budget in tokens (default: every slot's "
                        "worst case; smaller preempts and recomputes)")
    s.add_argument("--kv-quant", choices=["int8", "int4"], default=None,
                   help="quantized paged KV pages (requires --kv-layout paged)")
    s.add_argument("--fused-decode", default=None,
                   help="decode-step fusions, comma-separated (rope_kv_write, "
                        "sampling, whole_step; the first and last need "
                        "--kv-layout paged)")
    s.add_argument("--kernels", choices=["cuda", "torch"], default="cuda",
                   help="cuda: the hand-written kernels (the JAX command's "
                        "--pallas); torch: the plain PyTorch path")
    s.add_argument("--device", default="cuda",
                   help="the device to serve on (cuda, or cpu with --kernels torch "
                        "to run the plain path)")
    s.set_defaults(fn=cmd_serve)
    args = p.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
