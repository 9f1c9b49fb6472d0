"""InferenceEngine — the serving step on the dense KV cache.

Counterpart of ``flexflow_tpu/serve/engine.py`` for the dense layout.
The JAX engine jits one step program per static signature and donates
the cache through every call; here the step runs eagerly (no jit, no
step keys) and the KV cache is updated **in place**, so steady-state
decoding allocates no new cache.

The step contract is the JAX engine's: :meth:`InferenceEngine.run`
takes a :class:`BatchConfig` and returns logits on the device;
:meth:`InferenceEngine.run_mixed` (the continuous-batching step: first-
column token select, ``serve_step``, on-device sampling) returns the
sampled tokens as a device tensor that the scheduler reads up to
``dispatch_ahead`` steps later.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from .batch_config import BatchConfig


def resolve_device(device: Any = None) -> torch.device:
    """The device an entry point runs on: ``"cuda"`` unless the caller
    names another. Raises when a GPU is asked for and none is present —
    never a silent move to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "flexflow_tpu_torch runs on a CUDA GPU and none is available; "
            "pass device='cpu' to run the plain PyTorch path on the CPU"
        )
    return dev


#: ServingConfig fields this slice does not serve, with the later slice
#: that brings each. A value other than the field's default raises.
_LATER_SLICES = {
    "inference_debugging": "the serving-triage slice",
    "page_size": "the paged-KV slice",
    "max_cached_tokens": "the paged-KV slice",
    "kv_quant": "the paged-KV slice (int8/int4 pages)",
    "prefix_caching": "the prefix-caching slice",
    "host_cache_bytes": "the prefix-caching slice (host tier)",
    "kv_shard": "the long-context slice",
    "context_shards": "the long-context slice",
    "cache_policy": "the prefix-caching slice",
    "fused_decode": "the megakernel step-fusion slice",
    "quantized_allreduce": "the megakernel step-fusion slice",
    "replicas": "the cluster slice",
    "router_policy": "the cluster slice",
    "prefill_replicas": "the cluster slice",
    "decode_replicas": "the cluster slice",
    "slo_queue_delay_s": "the cluster slice",
    "failover_retries": "the cluster slice",
    "failover_backoff_steps": "the cluster slice",
    "migration_queue_budget": "the cluster slice",
    "replica_transport": "the cluster slice",
    "replica_endpoints": "the cluster slice",
    "standby_replicas": "the cluster slice",
    "rpc_deadline_s": "the cluster slice",
    "rpc_retries": "the cluster slice",
    "rpc_backoff_s": "the cluster slice",
    "concurrent_stepping": "the cluster slice",
    "journal_dir": "the cluster slice",
    "heartbeat_interval_steps": "the cluster slice",
    "heartbeat_gap_steps": "the cluster slice",
    "sanitizers": "the analysis slice",
    "autoscale": "the autotune slice",
    "slo_ttft_s": "the autotune slice",
    "slo_tpot_s": "the autotune slice",
    "autoscale_cooldown_steps": "the autotune slice",
    "autoscale_min_replicas": "the autotune slice",
    "autoscale_max_replicas": "the autotune slice",
}


@dataclasses.dataclass
class ServingConfig:
    """Serving limits, with the field names of the JAX package's
    ``ServingConfig``. This slice serves the dense KV layout; every field
    listed in ``_LATER_SLICES`` must keep its default (see
    :meth:`validate`)."""

    max_requests_per_batch: int = 16
    max_sequence_length: int = 2048
    prefill_chunk: int = 128
    max_spec_tree_tokens: int = 64
    cache_dtype: Any = torch.bfloat16
    # "cuda" (default): the hand-written attention kernels of
    # serve/kernels.py (the JAX package's "pallas"); "torch": the plain
    # serve_attention math (its "xla").
    kernels: str = "cuda"
    # Steady-state decode keeps up to this many steps in flight: sampled
    # tokens feed the next step on the device, the host reads results
    # this many steps behind.
    dispatch_ahead: int = 4
    # Iteration-level continuous batching: prefill chunks ride in the
    # same pipelined mixed step as decode rows. False restores the
    # flush-on-admit scheduler (any prefilling request forces the
    # blocking sync path).
    continuous_batching: bool = True
    # Per-row chunked-prefill token budget of the mixed step (its row
    # width is min(prefill_chunk, max_tokens_per_step)); 0 = a full
    # prefill_chunk per row.
    max_tokens_per_step: int = 0
    inference_debugging: Optional[str] = None
    # KV cache layout: only "dense" — (slots, max_len + 1) lines per slot.
    kv_layout: str = "dense"
    page_size: int = 128
    max_cached_tokens: Optional[int] = None
    kv_quant: Optional[str] = None
    prefix_caching: bool = False
    host_cache_bytes: Optional[int] = None
    kv_shard: str = "none"
    context_shards: int = 0
    cache_policy: str = "complete"
    fused_decode: Tuple[str, ...] = ()
    quantized_allreduce: Optional[str] = None
    replicas: int = 1
    router_policy: str = "prefix"
    prefill_replicas: int = 0
    decode_replicas: int = 0
    slo_queue_delay_s: Optional[float] = None
    failover_retries: int = 2
    failover_backoff_steps: int = 4
    migration_queue_budget: Optional[int] = None
    replica_transport: str = "inproc"
    replica_endpoints: Tuple[str, ...] = ()
    standby_replicas: int = 0
    rpc_deadline_s: float = 5.0
    rpc_retries: int = 2
    rpc_backoff_s: float = 0.02
    concurrent_stepping: bool = True
    journal_dir: Optional[str] = None
    heartbeat_interval_steps: int = 1
    heartbeat_gap_steps: int = 4
    sanitizers: Tuple[str, ...] = ()
    autoscale: Optional[str] = None
    slo_ttft_s: Optional[float] = None
    slo_tpot_s: Optional[float] = None
    autoscale_cooldown_steps: int = 64
    autoscale_min_replicas: int = 1
    autoscale_max_replicas: int = 0

    def validate(self) -> None:
        """Raise on a configuration this slice cannot serve."""
        if self.kv_layout == "paged":
            raise NotImplementedError(
                "kv_layout='paged' is not ported yet: it comes with the "
                "paged-KV slice"
            )
        if self.kv_layout != "dense":
            raise ValueError(f"unknown kv_layout {self.kv_layout!r}")
        if self.kernels not in ("cuda", "torch"):
            raise ValueError(
                f"unknown kernels {self.kernels!r} (expected 'cuda' — the "
                "hand-written kernels — or 'torch')"
            )
        for f in dataclasses.fields(self):
            slice_ = _LATER_SLICES.get(f.name)
            if slice_ is None:
                continue
            default = (f.default if f.default is not dataclasses.MISSING
                       else f.default_factory())
            if getattr(self, f.name) != default:
                raise NotImplementedError(
                    f"ServingConfig.{f.name}={getattr(self, f.name)!r} is not "
                    f"ported yet: it comes with {slice_}"
                )

    @property
    def cache_len(self) -> int:
        # Committed tokens + in-flight speculative tree slack.
        return self.max_sequence_length + self.max_spec_tree_tokens

    @property
    def mixed_chunk(self) -> int:
        """Per-row chunk width of the mixed continuous-batching step."""
        if self.max_tokens_per_step <= 0:
            return self.prefill_chunk
        return max(1, min(self.prefill_chunk, self.max_tokens_per_step))


class InferenceEngine:
    """Owns the params and the dense KV cache on ``device`` and runs the
    serving step.

    ``model`` is a model-family module exposing the serving protocol
    (see models/llama.py): ``init_kv_cache(cfg, slots, max_len, dtype,
    device=)`` and ``serve_step(params, cache, tokens, positions,
    logits_idx, mask, cache_positions, *, cfg, all_logits, kernels)``.
    """

    def __init__(
        self,
        model: Any,
        cfg: Any,
        params: Dict[str, Any],
        serving: Optional[ServingConfig] = None,
        *,
        device: Any = None,
    ):
        self.model = model
        self.cfg = cfg
        self.serving = serving or ServingConfig()
        self.serving.validate()
        self.device = resolve_device(device)
        self.params = params
        self.cache = self._alloc_cache()

    def _alloc_cache(self):
        sc = self.serving
        return self.model.init_kv_cache(
            self.cfg, sc.max_requests_per_batch, sc.cache_len, sc.cache_dtype,
            device=self.device,
        )

    @property
    def scratch_pos(self) -> int:
        return self.serving.cache_len

    @property
    def num_slots(self) -> int:
        return self.serving.max_requests_per_batch

    def _tensor(self, a, dtype: torch.dtype) -> torch.Tensor:
        """Host array → tensor on the engine's device. On a GPU the copy
        goes through pinned memory without blocking, so the host keeps
        running ahead of the device (a pageable copy would wait for every
        step already queued)."""
        t = torch.from_numpy(np.ascontiguousarray(np.asarray(a))).to(dtype)
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t

    def _step(self, tokens, positions, logits_idx, mask=None,
              cache_positions=None, all_logits=False):
        with torch.inference_mode():
            logits, self.cache = self.model.serve_step(
                self.params, self.cache, tokens, positions, logits_idx, mask,
                cache_positions, cfg=self.cfg, all_logits=all_logits,
                kernels=self.serving.kernels,
            )
        return logits

    def run(self, bc: BatchConfig, all_logits: bool = False):
        """Run one step (reference ``InferenceManager::inference``).
        Returns float32 logits on the device; the cache advances in
        place."""
        args = (
            self._tensor(bc.tokens, torch.int64),
            self._tensor(bc.positions, torch.int64),
            self._tensor(bc.logits_idx, torch.int64),
            self._tensor(bc.mask, torch.bool) if bc.mask is not None else None,
            self._tensor(bc.cache_positions, torch.int64)
            if bc.cache_positions is not None else None,
        )
        return self._step(*args, all_logits=all_logits)

    def run_mixed(self, last_tokens, host_tokens, use_last, positions,
                  logits_idx, generator, greedy, temperature, topp, topk,
                  with_logits: bool = False):
        """Run one mixed step over (R, C) host data: column 0 takes the
        previous step's sampled token (a device tensor) where
        ``use_last`` is set, else the host token; then ``serve_step`` and
        per-slot sampling at each row's ``logits_idx``, drawing from
        ``generator``. Returns the sampled tokens (R,) as a device
        tensor — the caller reads them up to ``dispatch_ahead`` steps
        later; ``with_logits`` also returns the (R, V) logits."""
        from .sampling import choose_sample_mode, sample_tokens

        host_tokens = np.asarray(host_tokens)
        mode, cap = choose_sample_mode(greedy, topp, topk, self.cfg.vocab_size)
        host = self._tensor(host_tokens, torch.int64)
        use = self._tensor(use_last, torch.bool)
        first = torch.where(use, last_tokens.to(torch.int64), host[:, 0])
        tokens = torch.cat([first[:, None], host[:, 1:]], dim=1)
        logits = self._step(tokens, self._tensor(positions, torch.int64),
                            self._tensor(logits_idx, torch.int64))
        with torch.inference_mode():
            toks = sample_tokens(
                logits, generator,
                greedy=self._tensor(greedy, torch.bool),
                temperature=self._tensor(temperature, torch.float32),
                topp=self._tensor(topp, torch.float32),
                topk_arr=self._tensor(topk, torch.int64),
                mode=mode, topk_cap=cap,
            )
        if with_logits:
            return toks, logits
        return toks

    def run_decode(self, last_tokens, host_tokens, use_last, positions,
                   generator, greedy, temperature, topp, topk=None):
        """Run one decode step (the C == 1 mixed step); returns the
        sampled tokens as a device tensor (R,)."""
        R = self.num_slots
        if topk is None:
            topk = np.zeros((R,), np.int32)
        return self.run_mixed(
            last_tokens, host_tokens, use_last, positions,
            np.zeros((R,), np.int32), generator, greedy, temperature, topp,
            topk,
        )

    def reset(self):
        """Drop all cached sequences (a fresh, zeroed KV cache)."""
        for t in self.cache.values():
            t.zero_()
