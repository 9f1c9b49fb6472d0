"""Command line — ``python -m flexflow_tpu_torch <cmd>``.

Counterpart of ``flexflow_tpu/__main__.py``. One command so far:

  serve   incremental decoding, SpecInfer or beam search over a local HF
          checkpoint directory (``--model-dir``), or over a tiny model of
          random weights when it is omitted; prints each request's output
          and a profile line. ``--output-file`` appends each finished
          request's record, ``--trace-out`` writes a Chrome trace of the
          run, ``--metrics-out`` a Prometheus snapshot, and
          ``--flight-recorder DIR`` dumps a redacted post-mortem of a
          request that ends in an error. ``--quantization {int8,int4}``
          serves weight-only quantized layer weights, ``--offload`` keeps
          them in pinned host memory, ``--replicas N`` (or
          ``--prefill-replicas``/``--decode-replicas``) serves an
          in-process cluster behind the router (``--router-policy``,
          ``--slo-queue-delay-s``, ``--migration-queue-budget``,
          ``--standby-replicas``, ``--fault-plan``).

It runs on the GPU (``--device cuda``, the default; it raises without
one) with the hand-written kernels (``--kernels cuda``, the default; the
JAX package's ``--pallas``); ``--device cpu --kernels torch`` runs the
plain PyTorch path. A prompt is text (it needs the checkpoint's
tokenizer) or token ids, comma- or space-separated (``--prompt
"3,17,91"``).

The JAX command's parallelism degrees, the cluster's RPC transports and
journal (``--replica-transport``, ``--replica-endpoints``,
``--journal-dir``) and autoscaling come with later slices (ROADMAP.md
queue 1).
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
        prefix_caching=args.prefix_caching,
        host_cache_bytes=args.host_cache_bytes,
        cache_policy=args.cache_policy,
        fused_decode=tuple(s for s in (args.fused_decode or "").split(",") if s),
        cache_dtype=llm.cfg.dtype,
        replicas=args.replicas,
        router_policy=args.router_policy,
        prefill_replicas=args.prefill_replicas,
        decode_replicas=args.decode_replicas,
        slo_queue_delay_s=args.slo_queue_delay_s,
        migration_queue_budget=args.migration_queue_budget,
        standby_replicas=args.standby_replicas,
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
    llm.compile(sc, ssms=ssms, spec=spec, quantization=args.quantization,
                offload=args.offload, output_file=args.output_file)
    from .serve.cluster import ClusterManager, FaultPlan

    clustered = isinstance(llm.rm, ClusterManager)
    if args.fault_plan:
        if not clustered:
            raise SystemExit("--fault-plan requires a cluster (--replicas > 1 or "
                             "disaggregated pools) — faults inject at the Replica surface")
        llm.rm.attach_faults(FaultPlan.from_json(args.fault_plan))
    obs_buf = recorder = None
    if args.trace_out or args.metrics_out or args.flight_recorder:
        # tracing and the flight recorder attach to the manager compile
        # built; the exports are written after the run
        from .obs import FlightRecorder, attach_observability

        if args.flight_recorder:
            recorder = FlightRecorder(out_dir=args.flight_recorder)
        obs_buf = attach_observability(llm.rm, recorder=recorder)
    prompts = [_prompt(p) for p in args.prompt] if args.prompt else [[3, 17, 91, 42, 7]]
    gen = GenerationConfig(num_beams=args.num_beams)
    outs = llm.generate(prompts, gen=gen if args.num_beams > 1 else None,
                        max_new_tokens=args.max_new_tokens)
    if obs_buf is not None:
        from .obs import write_chrome_trace, write_prometheus

        if args.trace_out:
            doc = write_chrome_trace(args.trace_out, obs_buf)
            print(f"trace: {len(doc['traceEvents'])} events -> {args.trace_out} "
                  "(load in ui.perfetto.dev)")
        if args.metrics_out:
            if clustered:
                sched = {str(r.index): r.rm.stats for r in llm.rm.replicas}
                cluster = llm.rm.stats
            else:
                sched, cluster = {"0": llm.rm.stats}, None
            write_prometheus(args.metrics_out, scheduler=sched, cluster=cluster,
                             profiles=[o.profile for o in outs])
            print(f"metrics: prometheus snapshot -> {args.metrics_out}")
        if recorder is not None and recorder.paths:
            print(f"flight recorder: {len(recorder.paths)} dump(s) -> {args.flight_recorder}")
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
    s.add_argument("--quantization", choices=["int8", "int4"], default=None,
                   help="weight-only quantized layer weights (per output channel; "
                        "their products run the dequantizing wq_matmul kernel)")
    s.add_argument("--offload", action="store_true",
                   help="keep the layer weights in pinned host memory and stream "
                        "them to the GPU a layer at a time (no effect on the CPU)")
    s.add_argument("--kv-layout", choices=["dense", "paged"], default="dense",
                   help="paged = block-paged KV cache")
    s.add_argument("--page-size", type=int, default=128)
    s.add_argument("--max-cached-tokens", type=int, default=None,
                   help="paged KV pool budget in tokens (default: every slot's "
                        "worst case; smaller preempts and recomputes)")
    s.add_argument("--kv-quant", choices=["int8", "int4"], default=None,
                   help="quantized paged KV pages (requires --kv-layout paged)")
    s.add_argument("--prefix-caching", action="store_true",
                   help="automatic prefix caching (paged layout only): "
                        "reuse cached KV pages for shared prompt "
                        "prefixes, prefilling only the uncached suffix")
    s.add_argument("--host-cache-bytes", type=int, default=None,
                   help="hierarchical KV cache: spill cold prefix-"
                        "cache pages to host RAM (async DMA) instead "
                        "of evicting, up to this many bytes, and "
                        "re-admit them on a later prompt match — a "
                        "host hit instead of a prefill recompute "
                        "(requires --prefix-caching; re-admitted pages "
                        "generate bitwise the warm path)")
    s.add_argument("--cache-policy", choices=["complete", "prefill"],
                   default="complete",
                   help="when prompt blocks enter the prefix cache: at "
                        "request completion incl. generated tokens "
                        "(complete) or as soon as prefill ends (prefill)")
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
    # reference -output-file: append each finished request's latency,
    # decoding steps and token ids
    s.add_argument("--output-file", "-output-file", default=None)
    s.add_argument("--trace-out", default=None,
                   help="write a Chrome/Perfetto trace_event JSON of the run "
                        "(load in ui.perfetto.dev)")
    s.add_argument("--metrics-out", default=None,
                   help="write a Prometheus text-format metrics snapshot "
                        "(SchedulerStats/ProfileInfo, drift-guarded)")
    s.add_argument("--flight-recorder", default=None, metavar="DIR",
                   help="arm the failure flight recorder: a bounded event ring "
                        "dumping a redacted JSON post-mortem into DIR when a "
                        "request ends in an error")
    s.add_argument("--replicas", type=int, default=1,
                   help="cluster serving (serve/cluster/): drive this many engine "
                        "replicas — each its own KV pool — behind the router")
    s.add_argument("--router-policy", choices=["prefix", "round_robin", "least_loaded"],
                   default="prefix",
                   help="replica placement: longest prefix-cache match (prefix; "
                        "least-loaded on a miss), round_robin, or the smallest "
                        "queue-delay estimate (least_loaded)")
    s.add_argument("--prefill-replicas", type=int, default=0,
                   help="disaggregated serving: the first N replicas only prefill; "
                        "finished prefills migrate their KV pages to a decode-pool "
                        "replica (needs --kv-layout paged; pairs with "
                        "--decode-replicas, the two summing to --replicas)")
    s.add_argument("--decode-replicas", type=int, default=0,
                   help="disaggregated serving: the last N replicas only decode")
    s.add_argument("--slo-queue-delay-s", type=float, default=None,
                   help="SLO admission: shed a request (a terminal error, never a "
                        "hang) when every replica's queue-delay estimate exceeds "
                        "this many seconds")
    s.add_argument("--migration-queue-budget", type=int, default=None,
                   help="disaggregated back-pressure: at most this many finished "
                        "prefills wait for decode-pool capacity holding their pages; "
                        "the overflow drains through recompute re-admission")
    s.add_argument("--fault-plan", default=None,
                   help="deterministic fault injection (serve/cluster/faults.py; needs "
                        "a cluster): a JSON list of faults, e.g. '[{\"kind\": "
                        "\"crash\", \"replica\": 1, \"step\": 20}]' — kinds crash, "
                        "transient, latency, migration, oom")
    s.add_argument("--standby-replicas", type=int, default=0,
                   help="warm standbys: built engines outside routing that adopt a "
                        "circuit-broken replica's position and prefix families")
    s.set_defaults(fn=cmd_serve)
    args = p.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
