"""InferenceEngine — the serving step on the dense or the paged KV cache.

Counterpart of ``flexflow_tpu/serve/engine.py`` on one device. The JAX
engine jits one step program per static signature and donates the cache
through every call; here the step runs eagerly (no jit, no step keys)
and the KV cache is updated **in place**, so steady-state decoding
allocates no new cache. The paged layout (``kv_layout="paged"``) keeps
a host-side :class:`PageAllocator` whose table reaches the device
through a pinned, non-blocking copy, re-shipped only when the table
changed.

The step contract is the JAX engine's: :meth:`InferenceEngine.run`
takes a :class:`BatchConfig` and returns logits on the device;
:meth:`InferenceEngine.run_mixed` (the continuous-batching step: first-
column token select, ``serve_step``, on-device sampling) returns the
sampled tokens as a device tensor that the scheduler reads up to
``dispatch_ahead`` steps later.

SpecInfer and beam search drive three more entry points:
:meth:`InferenceEngine.run_speculate` (a whole token-tree expansion on
the device, its tree fetched by the caller in one transfer),
:meth:`InferenceEngine.commit` (accepted tree lines moved to their
committed positions) and :meth:`InferenceEngine.reorder` (beam
hypotheses gathered across slots).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from .batch_config import BatchConfig
from .paging import PageAllocator
from .sampling import beam_topk, choose_sample_mode, log_softmax, sample_tokens


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
    "prefix_caching": "the prefix-caching slice",
    "host_cache_bytes": "the prefix-caching slice (host tier)",
    "kv_shard": "the long-context slice",
    "context_shards": "the long-context slice",
    "cache_policy": "the prefix-caching slice",
    "quantized_allreduce": "the parallel-serving slice",
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
    ``ServingConfig``. The port serves the dense and the paged KV
    layouts; every field listed in ``_LATER_SLICES`` must keep its
    default (see :meth:`validate`)."""

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
    # KV cache layout. "dense": (slots, max_len + 1) lines per slot.
    # "paged": fixed-size token pages and a per-slot page table
    # (serve/paging.py): memory follows the pages actually allocated.
    kv_layout: str = "dense"
    page_size: int = 128                    # tokens per KV page
    # Page-pool budget in tokens (rounded up to whole pages, at least one
    # slot's worst case). None = every slot's worst case. Below that the
    # scheduler preempts (recompute on re-admission) when pages run out.
    max_cached_tokens: Optional[int] = None
    # Quantized pages (paged layout only; serve/kv_quant.py): "int8"
    # codes or "int4" nibble pairs with per-page-per-KV-head f32 scales.
    # max_cached_tokens stays a memory budget priced at cache_dtype, so
    # the same budget buys ~2x (int8) or ~4x (int4) the pages.
    kv_quant: Optional[str] = None
    prefix_caching: bool = False
    host_cache_bytes: Optional[int] = None
    kv_shard: str = "none"
    context_shards: int = 0
    cache_policy: str = "complete"
    # Decode-step fusions. "sampling": the pipelined step samples with the
    # head mode the batch needs (sampling.choose_sample_mode) instead of
    # the full-sort head. "rope_kv_write" (paged layout): RoPE and the
    # K/V page write run inside the paged attention kernel
    # (serve/kernels.fused_rope_paged_attention); a step wider than the
    # kernel's commit (kernels._FUSED_MAX_CHUNK lines a slot) runs the
    # unfused step, its bitwise twin. "whole_step" (paged
    # layout): the whole decode step — and the mixed step when the gate
    # prices it — runs as one persistent kernel
    # (serve/kernels.whole_step_decode, model.serve_step_whole), with the
    # output-column tile count the engine's gate picks; below the gate's
    # floor, and for a mixed step wider than the kernel's commit, the
    # engine falls back to the per-layer path.
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
        """Raise on a configuration the port cannot serve: ValueError for
        a bad value (as the JAX engine raises at construction),
        NotImplementedError for a feature of a later slice."""
        if self.kv_layout not in ("dense", "paged"):
            raise ValueError(
                f"unknown kv_layout {self.kv_layout!r} (expected 'dense' or 'paged')")
        for name in self.fused_decode:
            if name not in ("rope_kv_write", "sampling", "whole_step"):
                raise ValueError(
                    f"unknown fused_decode entry {name!r} (expected 'sampling', or "
                    "on the paged layout 'rope_kv_write' and/or 'whole_step')"
                )
        paged = self.kv_layout == "paged"
        if "whole_step" in self.fused_decode and not paged:
            raise ValueError(
                "fused_decode='whole_step' requires kv_layout='paged' — the layer "
                "walk commits and gathers K/V through the page table"
            )
        if "rope_kv_write" in self.fused_decode and not paged:
            raise ValueError(
                "fused_decode='rope_kv_write' requires kv_layout='paged' — the "
                "fused prologue commits K/V through the page table inside the "
                "ragged paged kernel"
            )
        if self.kv_quant is not None:
            if not paged:
                raise ValueError(
                    "kv_quant requires kv_layout='paged' — the dense layout "
                    "has no per-page scale granularity"
                )
            from .kv_quant import resolve_spec

            resolve_spec(self.kv_quant)
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

    @property
    def pages_per_slot(self) -> int:
        """Logical pages covering one slot's worst case (cache_len lines
        plus the scratch line)."""
        return -(-(self.cache_len + 1) // self.page_size)

    @property
    def num_pages(self) -> int:
        """Physical pages in the pool, the scratch page excluded: every
        slot's worst case, or the ``max_cached_tokens`` budget (never
        below one slot's worst case)."""
        if self.max_cached_tokens is None:
            return self.max_requests_per_batch * self.pages_per_slot
        return max(self.pages_per_slot,
                   -(-self.max_cached_tokens // self.page_size))


class InferenceEngine:
    """Owns the params and the KV cache on ``device`` and runs the
    serving step.

    ``model`` is a model-family module exposing the serving protocol
    (see models/llama.py): ``init_kv_cache(cfg, slots, max_len, dtype,
    device=)`` and ``serve_step(params, cache, tokens, positions,
    logits_idx, mask, cache_positions, *, cfg, all_logits, kernels)``;
    for the paged layout also ``init_paged_kv_cache(cfg, num_pages,
    page_size, dtype, kv_quant, device=)``, ``serve_step_paged`` (the
    same arguments plus the page table, ``cache_len``, ``kv_quant`` and
    ``fused_rope``) and ``FUSED_DECODE``; for ``fused_decode=("whole_step",)``
    also ``serve_step_whole`` (with the spec keywords ``mask``,
    ``cache_positions``, ``all_logits`` and ``num_layers``: the
    speculation fold), ``whole_step_weight_layout`` and
    ``whole_step_tile_roles``.
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
        self.paged = self.serving.kv_layout == "paged"
        if ("rope_kv_write" in self.serving.fused_decode
                and "rope_kv_write" not in getattr(model, "FUSED_DECODE", ())):
            raise ValueError(
                "fused_decode='rope_kv_write' requested but "
                f"{getattr(model, '__name__', repr(model))} does not advertise "
                "it (model.FUSED_DECODE)"
            )
        # Whole-step kernel: the gate below picks an output-column tile
        # count per step shape (the C = 1 decode step; the C =
        # prefill_chunk mixed step); whole_step_on turns False only when
        # no legal tiling fits the budget (whole_step_fallbacks counts
        # those, mirrored into SchedulerStats).
        self.whole_step_on = False
        self.whole_step_tiles = 1
        self.whole_step_mixed_on = False
        self.whole_step_mixed_tiles = 1
        self.whole_step_fallbacks = 0
        self.whole_step_smem_est = 0
        # the speculation fold (whole_step_spec_on): tile counts of the
        # SpecInfer chunk widths priced so far, and whether a pricing
        # refused the fold
        self.whole_step_spec_tiles: Dict[int, int] = {}
        self.whole_step_spec_refused = False
        if "whole_step" in self.serving.fused_decode:
            if "whole_step" not in getattr(model, "FUSED_DECODE", ()):
                raise ValueError(
                    "fused_decode='whole_step' requested but "
                    f"{getattr(model, '__name__', repr(model))} does not advertise "
                    "it (model.FUSED_DECODE)"
                )
            # an unstreamable layout raises here, never mid-serve
            model.whole_step_weight_layout(params, cfg)
            self.whole_step_on = True
        self.device = resolve_device(device)
        self._check_cuda_shapes()
        # steps of fused_decode=("rope_kv_write",) wider than the fused
        # kernel's commit, served by the unfused step instead
        self.fused_reroutes = 0
        self.params = params
        self.pager: Optional[PageAllocator] = None  # host-side page tables
        self.cache = self._alloc_cache()
        if self.whole_step_on:
            self._whole_step_smem_gate()

    def _check_cuda_shapes(self):
        """Raise ValueError at construction for a shape the CUDA kernels
        are not built for (``kernels="cuda"`` on a GPU): a head dim
        outside ``kernels._CUDA_HEAD_DIMS`` or, paged, a page size outside
        ``kernels._CUDA_PAGE_SIZES``. On the CPU the plain versions take
        any shape."""
        if self.serving.kernels != "cuda" or self.device.type != "cuda":
            return
        from . import kernels as _k

        if self.cfg.head_dim not in _k._CUDA_HEAD_DIMS:
            raise ValueError(
                f"kernels='cuda' has no head dim {self.cfg.head_dim} (the CUDA kernels "
                f"take {_k._CUDA_HEAD_DIMS}); serve with kernels='torch'")
        if self.paged and self.serving.page_size not in _k._CUDA_PAGE_SIZES:
            raise ValueError(
                f"kernels='cuda' has no page size {self.serving.page_size} (the CUDA "
                f"paged kernels take {_k._CUDA_PAGE_SIZES})")

    def _whole_step_smem_gate(self):
        """Pick the whole-step kernel's output-column tile count for each
        step shape it serves — the C = 1 decode step and the C =
        prefill_chunk mixed step — as the SMALLEST legal count whose
        priced block footprint (serve/kernels.whole_step_smem_bytes) fits
        ``kernels.WHOLE_STEP_SMEM_BUDGET``. A shape no tiling fits stays
        on the per-layer path and counts one ``whole_step_fallbacks``;
        the decode shape failing turns the walk off altogether. A mixed
        step wider than the kernel's commit (``kernels._FUSED_MAX_CHUNK``
        lines a slot) is unpriceable and falls back the same way."""
        from ..logging_utils import get_logger
        from . import kernels as _k

        budget = _k.WHOLE_STEP_SMEM_BUDGET
        log = get_logger("serve")
        tiles, est = self._whole_step_pick(1)
        self.whole_step_smem_est = int(est)
        if tiles is None:
            self.whole_step_fallbacks += 1
            self.whole_step_on = False
            log.warning("whole_step: every legal tiling prices %d bytes or more against "
                        "the %d-byte budget; serving on the per-layer path", est, budget)
            return
        self.whole_step_tiles = int(tiles)
        C = self.serving.prefill_chunk
        if C <= 1:
            self.whole_step_mixed_on = True
            self.whole_step_mixed_tiles = self.whole_step_tiles
            return
        if C > _k._FUSED_MAX_CHUNK:
            self.whole_step_fallbacks += 1
            log.warning("whole_step: the C=%d mixed step is wider than the kernel's %d-line "
                        "commit; mixed steps stay on the per-layer path", C,
                        _k._FUSED_MAX_CHUNK)
            return
        mtiles, mest = self._whole_step_pick(C)
        if mtiles is None:
            self.whole_step_fallbacks += 1
            log.warning("whole_step: the C=%d mixed step prices %d bytes or more against "
                        "the %d-byte budget; mixed steps stay on the per-layer path",
                        C, mest, budget)
            return
        self.whole_step_mixed_on = True
        self.whole_step_mixed_tiles = int(mtiles)

    def _whole_step_pick(self, C: int, all_logits: bool = False):
        """The gate's ``(tiles, priced bytes)`` for a step of C columns a
        slot (``tiles`` None when no legal tiling fits the budget)."""
        from . import kernels as _k

        layer_arrays, _ = self.model.whole_step_weight_layout(self.params, self.cfg)
        x0 = torch.empty((self.num_slots, C, self.cfg.hidden_size),
                         dtype=self.params["embed"].dtype, device="meta")
        return _k.whole_step_pick_tiles(
            layer_arrays, self.cache, x0, self.cfg.num_attention_heads,
            tile_roles=self.model.whole_step_tile_roles(self.cfg),
            budget=_k.WHOLE_STEP_SMEM_BUDGET, all_logits=all_logits)

    @property
    def whole_step_spec_on(self) -> bool:
        """Whether SpecInfer steps fold into the whole-step kernel: the
        draft steps (the early-exit ``num_layers`` slice, or an SSM
        engine's own walk) and the verify step (tree mask, slack-line
        cache positions, all-positions head) launch the one kernel
        instead of the per-layer step. On with the walk; off only after
        :meth:`whole_step_spec_gate` refused a chunk width (counted in
        ``whole_step_fallbacks``). The tile count is the gate's for each
        chunk width, any legal one: the kernel's answer does not depend
        on it."""
        return self.whole_step_on and not self.whole_step_spec_refused

    def whole_step_spec_gate(self, chunks) -> bool:
        """Price the speculation fold's chunk widths (SpecInfer's draft
        widths W and verify widths 1 + n W D) at the all-positions head:
        each gets the smallest legal tile count that fits
        ``kernels.WHOLE_STEP_SMEM_BUDGET``. A width that no tiling fits,
        or one wider than the kernel's commit, turns the fold off for
        this engine, counts one ``whole_step_fallbacks`` and logs it:
        SpecInfer steps then run on the per-layer path. Returns
        :attr:`whole_step_spec_on`."""
        from ..logging_utils import get_logger
        from . import kernels as _k

        for C in sorted({int(c) for c in chunks}):
            if not self.whole_step_spec_on:
                break
            if C in self.whole_step_spec_tiles:
                continue
            tiles, est = (None, 0) if C > _k._FUSED_MAX_CHUNK else self._whole_step_pick(
                C, all_logits=True)
            if tiles is None:
                self.whole_step_fallbacks += 1
                self.whole_step_spec_refused = True
                get_logger("serve").warning(
                    "whole_step: the C=%d SpecInfer step (all-positions head) prices %d "
                    "bytes or more against the %d-byte budget, or is wider than the "
                    "kernel's %d-line commit; SpecInfer steps run on the per-layer path",
                    C, est, _k.WHOLE_STEP_SMEM_BUDGET, _k._FUSED_MAX_CHUNK)
                break
            self.whole_step_spec_tiles[C] = int(tiles)
        return self.whole_step_spec_on

    def _num_pages(self) -> int:
        """Pages of the pool: ``ServingConfig.num_pages``, converted by
        bytes per page when the pages are quantized under a budget."""
        sc = self.serving
        if sc.kv_quant is None or sc.max_cached_tokens is None:
            return sc.num_pages
        from .kv_quant import quantized_pool_pages, resolve_spec

        return quantized_pool_pages(
            sc.num_pages, sc.page_size, self.cfg.num_key_value_heads,
            self.cfg.head_dim,
            torch.empty((), dtype=sc.cache_dtype).element_size(),
            resolve_spec(sc.kv_quant),
        )

    def _alloc_cache(self):
        sc = self.serving
        if not self.paged:
            return self.model.init_kv_cache(
                self.cfg, sc.max_requests_per_batch, sc.cache_len, sc.cache_dtype,
                device=self.device,
            )
        num_pages = self._num_pages()
        self.pager = PageAllocator(num_pages, sc.pages_per_slot,
                                   sc.max_requests_per_batch, sc.page_size)
        self._table_cache = None
        return self.model.init_paged_kv_cache(
            self.cfg, num_pages, sc.page_size, sc.cache_dtype, sc.kv_quant,
            device=self.device,
        )

    # ------------------------------------------------------------------
    # paged-layout accounting

    def page_table_device(self) -> torch.Tensor:
        """The allocator's page table on the device (R, NP) int32 — every
        paged step's read-only indices. Cached against the allocator's
        version: steady-state decode re-ships nothing."""
        cached = self._table_cache
        if cached is not None and cached[0] == self.pager.version:
            return cached[1]
        dev = self._tensor(self.pager.table.copy(), torch.int32)
        self._table_cache = (self.pager.version, dev)
        return dev

    def kv_cache_bytes(self) -> int:
        """Device bytes held by the cache tensors (dense: every slot's
        lines; paged: the page pool and its scales)."""
        return sum(t.numel() * t.element_size() for t in self.cache.values())

    def kv_bytes_per_line(self) -> float:
        """K+V bytes one cached token line costs across all layers, the
        quantized pools' scale rows amortized into it."""
        k = self.cache["k"]
        lines = k.shape[1] * k.shape[2]  # slots × (len+1) or pages × page_size
        return self.kv_cache_bytes() / lines

    def kv_allocated_bytes(self) -> int:
        """Bytes of KV memory backing allocated pages (paged layout; the
        whole cache on the dense one)."""
        if not self.paged:
            return self.kv_cache_bytes()
        return int(self.pager.used_pages * self.serving.page_size
                   * self.kv_bytes_per_line())

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
              cache_positions=None, all_logits=False, num_layers=None):
        sc = self.serving
        if (all_logits and mask is not None and cache_positions is not None
                and self.whole_step_spec_gate([tokens.shape[1]])):
            # the speculation fold: a SpecInfer draft or verify step
            return self._step_whole(tokens, positions, logits_idx, mask=mask,
                                    cache_positions=cache_positions, all_logits=True,
                                    num_layers=num_layers)[0]
        kw = {} if num_layers is None else {"num_layers": num_layers}
        with torch.inference_mode():
            if self.paged:
                from .kernels import _FUSED_MAX_CHUNK

                fused = "rope_kv_write" in sc.fused_decode
                if fused and tokens.shape[1] > _FUSED_MAX_CHUNK:
                    fused = False  # the unfused step is the fused one's bitwise twin
                    self.fused_reroutes += 1
                logits, self.cache = self.model.serve_step_paged(
                    self.params, self.cache, tokens, positions, logits_idx, mask,
                    cache_positions, self.page_table_device(), cfg=self.cfg,
                    cache_len=sc.cache_len, all_logits=all_logits,
                    kernels=sc.kernels, kv_quant=sc.kv_quant, fused_rope=fused, **kw,
                )
            else:
                logits, self.cache = self.model.serve_step(
                    self.params, self.cache, tokens, positions, logits_idx, mask,
                    cache_positions, cfg=self.cfg, all_logits=all_logits,
                    kernels=sc.kernels, **kw,
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
                  with_logits: bool = False, sample: bool = True):
        """Run one mixed step over (R, C) host data: column 0 takes the
        previous step's sampled token (a device tensor) where
        ``use_last`` is set, else the host token; then ``serve_step`` and
        per-slot sampling at each row's ``logits_idx``, drawing from
        ``generator``. Returns the sampled tokens (R,) as a device
        tensor — the caller reads them up to ``dispatch_ahead`` steps
        later; ``with_logits`` also returns the (R, V) logits.
        ``sample=False`` runs the step alone (no head, no draw) and
        returns None: SpecInfer's draft mirrors, whose caches follow the
        target's tokens."""
        host_tokens = np.asarray(host_tokens)
        host = self._tensor(host_tokens, torch.int64)
        use = self._tensor(use_last, torch.bool)
        first = torch.where(use, last_tokens.to(torch.int64), host[:, 0])
        tokens = torch.cat([first[:, None], host[:, 1:]], dim=1)
        positions = self._tensor(positions, torch.int64)
        logits_idx = self._tensor(logits_idx, torch.int64)
        whole = self.whole_step_on and (host_tokens.shape[1] == 1 or self.whole_step_mixed_on)
        if not sample:
            if whole:
                self._step_whole(tokens, positions, logits_idx)
            else:
                self._step(tokens, positions, logits_idx)
            return None
        if whole:
            # the whole-step kernel owns the decode step and, when the gate
            # priced it, the mixed step; greedy rows take its argmax
            logits, gtoks = self._step_whole(tokens, positions, logits_idx)
            toks = self._sample(logits, generator, greedy, temperature, topp, topk, gtoks)
        else:
            logits = self._step(tokens, positions, logits_idx)
            # the full-sort head unless the "sampling" fusion picks the
            # batch's mode, as the JAX engine's mixed step does
            toks = self._sample(logits, generator, greedy, temperature, topp, topk,
                                choose="sampling" in self.serving.fused_decode)
        if with_logits:
            return toks, logits
        return toks

    def _sample(self, logits, generator, greedy, temperature, topp, topk, greedy_toks=None,
                choose: bool = True):
        """Each slot's decode head on (R, V) logits, in the cheapest mode
        the batch allows (``choose``) or the full-sort head; an all-greedy
        batch takes ``greedy_toks`` (the whole-step kernel's argmax) when
        given."""
        mode, cap = (choose_sample_mode(greedy, topp, topk, self.cfg.vocab_size) if choose
                     else ("full", 0))
        if mode == "greedy" and greedy_toks is not None:
            return greedy_toks
        with torch.inference_mode():
            return sample_tokens(
                logits, generator,
                greedy=self._tensor(greedy, torch.bool),
                temperature=self._tensor(temperature, torch.float32),
                topp=self._tensor(topp, torch.float32),
                topk_arr=self._tensor(topk, torch.int64),
                mode=mode, topk_cap=cap,
            )

    def _step_whole(self, tokens, positions, logits_idx, **spec):
        """One step through ``model.serve_step_whole`` at the gate's tile
        count for its shape; returns (logits, greedy tokens). ``spec``
        (``mask``, ``cache_positions``, ``all_logits``, ``num_layers``) is
        the speculation fold, at the tile count priced for its width."""
        sc = self.serving
        C = tokens.shape[1]
        if spec:
            tiles = self.whole_step_spec_tiles[C]
        else:
            tiles = self.whole_step_tiles if C == 1 else self.whole_step_mixed_tiles
        with torch.inference_mode():
            logits, toks, self.cache = self.model.serve_step_whole(
                self.params, self.cache, tokens, positions, logits_idx,
                self.page_table_device(), cfg=self.cfg, cache_len=sc.cache_len,
                kv_quant=sc.kv_quant, tiles=tiles, kernels=sc.kernels, **spec)
        return logits, toks

    def run_sampled(self, bc: BatchConfig, generator, greedy, temperature, topp, topk,
                    with_logits: bool = False):
        """The sync step with its sampling in the same call (the
        ``"sampling"`` and ``"whole_step"`` fusions' sync path): the
        whole-step kernel when it owns the step's shape (no explicit mask
        or cache positions), else the per-layer step; then each slot's
        head, drawing from ``generator``. Returns the sampled tokens (R,)
        on the device, and the (R, V) logits with ``with_logits``."""
        R = self.num_slots
        if (self.whole_step_on and (bc.chunk == 1 or self.whole_step_mixed_on)
                and bc.mask is None and bc.cache_positions is None):
            # use_last all False: the host tokens go through the token select
            return self.run_mixed(
                torch.zeros((R,), dtype=torch.int64, device=self.device), bc.tokens,
                np.zeros((R,), bool), bc.positions, bc.logits_idx, generator, greedy,
                temperature, topp, topk, with_logits=with_logits)
        logits = self.run(bc)
        toks = self._sample(logits, generator, greedy, temperature, topp, topk)
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

    def run_speculate(self, root_tokens, prefix, active, W: int, D: int,
                      num_layers: Optional[int] = None):
        """One whole token-tree expansion (the JAX engine's speculate
        scan, here a loop of D steps on the device): the frontier of up
        to W nodes a slot runs through the step in tree-mask mode (RoPE
        position ``prefix + d``; node (d, w) writes cache line ``prefix +
        1 + d·W + w``, the root line ``prefix``), then the top W of its
        W·V children by cumulative log-probability become the next
        frontier. ``num_layers`` drafts through the first layers of this
        engine's own model (the early-exit self-draft). The cache holds
        every node's K/V at its line afterwards. Nothing leaves the
        device: returns (tokens, parents, logprobs), each (D, R, W) —
        ``parents`` index the previous depth's W nodes."""
        R = self.num_slots
        S1 = self.serving.cache_len + 1
        scratch = self.scratch_pos
        NEG = -1e30
        dev = self.device
        root = self._tensor(root_tokens, torch.int64)
        prefix = self._tensor(prefix, torch.int64)
        active = self._tensor(active, torch.bool)
        key_pos = torch.arange(S1, device=dev)
        w_iota = torch.arange(W, device=dev)
        zeros = torch.zeros((R,), dtype=torch.int64, device=dev)
        # the frontier: only node 0 (the root) is live at depth 0
        f_valid = (w_iota == 0)[None, :] & active[:, None]              # (R, W)
        f_tok = torch.where(f_valid, root[:, None], 0)
        f_cum = torch.where(f_valid, 0.0, NEG).to(torch.float32)
        f_line = torch.where(f_valid, prefix[:, None], scratch)
        committed = key_pos[None, :] < prefix[:, None]                   # (R, S1)
        f_mask = ((committed[:, None, :] | (key_pos == f_line[:, :, None]))
                  & f_valid[:, :, None])                                 # (R, W, S1)
        out_tok, out_par, out_lp = [], [], []
        with torch.inference_mode():
            for d in range(D):
                pos = torch.where(f_valid, prefix[:, None] + d, scratch)
                logits = self._step(f_tok, pos, zeros, f_mask, f_line, all_logits=True,
                                    num_layers=num_layers)               # (R, W, V)
                V = logits.shape[-1]
                logp = log_softmax(logits) + f_cum[:, :, None]
                logp = torch.where(f_valid[:, :, None], logp, NEG)
                vals, flat = beam_topk(logp.reshape(R, W * V), W)
                parent = flat // V
                token = flat % V
                child_valid = (vals > NEG / 2) & active[:, None]
                new_line = torch.where(child_valid, prefix[:, None] + 1 + d * W + w_iota,
                                       scratch)
                parent_mask = torch.gather(f_mask, 1, parent[:, :, None].expand(-1, -1, S1))
                f_mask = ((parent_mask | (key_pos == new_line[:, :, None]))
                          & child_valid[:, :, None])
                f_tok, f_cum, f_valid, f_line = token, vals, child_valid, new_line
                out_tok.append(token)
                out_par.append(parent)
                out_lp.append(vals)
        return torch.stack(out_tok), torch.stack(out_par), torch.stack(out_lp)

    def commit(self, src, dst):
        """Move accepted speculative cache lines to their committed
        positions: slot r's line ``src[r, k]`` to ``dst[r, k]`` ((R, K)
        host arrays; unused entries scratch to scratch). Dense, paged
        and quantized paged caches (``model.commit_kv``,
        ``model.commit_kv_paged``)."""
        src = self._tensor(src, torch.int64)
        dst = self._tensor(dst, torch.int64)
        with torch.inference_mode():
            if self.paged:
                self.cache = self.model.commit_kv_paged(
                    self.cache, self.page_table_device(), src, dst,
                    kv_quant=self.serving.kv_quant, kernels=self.serving.kernels)
            else:
                self.cache = self.model.commit_kv(self.cache, src, dst)

    def reorder(self, src_slots):
        """Slot gather of the whole cache (beam search's hypothesis
        reorder): new slot r holds old slot ``src_slots[r]``. Paged: page
        ownership stays put and page content is copied through the table
        (``model.reorder_slots_paged``)."""
        src = self._tensor(src_slots, torch.int64)
        with torch.inference_mode():
            if self.paged:
                self.cache = self.model.reorder_slots_paged(
                    self.cache, self.page_table_device(), src)
            else:
                self.cache = self.model.reorder_slots(self.cache, src)

    def reset(self):
        """Drop all cached sequences: the KV cache is zeroed in place and,
        paged, a fresh allocator puts every page back on the free list."""
        for t in self.cache.values():
            t.zero_()
        if self.paged:
            sc = self.serving
            self.pager = PageAllocator(self.pager.num_pages, sc.pages_per_slot,
                                       sc.max_requests_per_batch, sc.page_size)
            self._table_cache = None
