"""Batch descriptors — host-side PODs shipped to the device each step.

A copy of ``flexflow_tpu/serve/batch_config.py`` (it imports only
numpy), which mirrors the reference's ``BatchConfig`` family (reference
``include/flexflow/batch_config.h:39-201``): fixed-size padded arrays
describing which request slot each token belongs to and where it lands
in the KV cache. Padding to the configured maxima keeps every step's
shapes fixed.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional

import numpy as np

# Reference limits (batch_config.h:58-60,157-161). Ours are configurable
# via ServingConfig; these are the defaults.
MAX_NUM_REQUESTS = 16
MAX_NUM_TOKENS = 1024
MAX_SPEC_TREE_TOKEN_NUM = 64
MAX_BEAM_WIDTH = 3
MAX_BEAM_DEPTH = 8


@dataclasses.dataclass
class BatchConfig:
    """One step's device inputs, padded to (num_slots, chunk).

    ``positions`` of padding tokens point at the cache's scratch row so
    their K/V writes are harmless (models/llama.py init_kv_cache). The
    paged, prefix-cache and speculation fields are carried for the later
    slices that fill them.
    """

    tokens: np.ndarray        # (R, C) int32
    positions: np.ndarray     # (R, C) int32 RoPE/sequence positions
    logits_idx: np.ndarray    # (R,) int32 — which chunk index to sample from
    active: np.ndarray        # (R,) bool — slots participating this step
    mask: Optional[np.ndarray] = None  # (R, C, S+1) bool; None => causal
    # Cache line indices when they differ from sequence positions (tree
    # tokens: siblings share a position but need distinct lines).
    cache_positions: Optional[np.ndarray] = None
    # Paged-KV metadata (Ragged Paged Attention layout, serve/paging.py).
    # page_table: (R, pages_per_slot) int32 physical page per logical
    # page — a snapshot of the batch-building engine's allocator table
    # (each engine dispatches with its OWN authoritative table; this
    # copy is host-side metadata for telemetry and tests).
    page_table: Optional[np.ndarray] = None
    # Ragged per-slot lengths: committed cache lines + this step's new
    # tokens for each active slot (0 for idle slots) — the kernel-side
    # sequence-length metadata of the ragged batch.
    seq_lens: Optional[np.ndarray] = None  # (R,) int32
    # Ragged per-row QUERY lengths: how many of this row's chunk columns
    # carry real tokens this step (decode rows 1, prefill rows up to the
    # chunk, idle rows 0). The mixed continuous-batching step pads every
    # row to the static chunk; qlens is the ragged truth the scheduler
    # and tests reason about.
    qlens: Optional[np.ndarray] = None  # (R,) int32
    # Per-row prefill START offset: the first prompt token position this
    # dispatch carries for each prefilling row (0 for cold prefills;
    # past the cached prefix on a prefix-cache hit — serve/
    # prefix_cache.py). ``positions`` already encode it on the device
    # side (the kernels handle ragged rows unchanged); this field
    # carries it explicitly for telemetry and tests.
    prefill_offsets: Optional[np.ndarray] = None  # (R,) int32
    # SpecInfer verify metadata: how many token-tree nodes (root
    # included) this verify dispatch carries per slot. With adaptive
    # tree shaping (serve/specinfer.py TreeController) slots in the
    # same W×D bucket dispatch together and slots outside it carry 0 —
    # the ragged truth of the padded (R, C) verify step, for telemetry
    # and tests (the device side already ignores padding columns via
    # the tree mask).
    spec_nodes: Optional[np.ndarray] = None  # (R,) int32

    @property
    def num_slots(self) -> int:
        return self.tokens.shape[0]

    @property
    def chunk(self) -> int:
        return self.tokens.shape[1]

    @classmethod
    def empty(cls, num_slots: int, chunk: int, scratch_pos: int) -> "BatchConfig":
        return cls(
            tokens=np.zeros((num_slots, chunk), np.int32),
            positions=np.full((num_slots, chunk), scratch_pos, np.int32),
            logits_idx=np.zeros((num_slots,), np.int32),
            active=np.zeros((num_slots,), bool),
        )


@dataclasses.dataclass
class GenerationConfig:
    """Per-request decode head parameters (reference ``GenerationConfig``
    in inference/models/* and the sampling/argmax decode ops)."""

    do_sample: bool = False
    temperature: float = 0.8
    topp: float = 0.95
    topk: int = 0  # 0 = disabled
    max_new_tokens: int = 128
    stop_token_ids: tuple = ()
    # Beam-search decode head (reference beam_topk.cc); >1 routes
    # generation through serve.beam.beam_generate.
    num_beams: int = 1
    length_penalty: float = 1.0


@dataclasses.dataclass
class ProfileInfo:
    """Per-request profiling (reference ``ProfileInfo``,
    request_manager.h:271-277: llm_decoding_steps + start/finish).
    ``first_token_time`` is stamped when the host observes the request's
    first sampled token (TTFT as a client would measure it — with the
    dispatch-ahead pipeline that is the flush, not the device sample)."""

    start_time: float = 0.0
    finish_time: float = 0.0
    first_token_time: float = 0.0
    # Prompt tokens served from the prefix cache at admission (prefill
    # started past them); 0 on a miss or with caching off.
    cached_prefix_len: int = 0
    # Of those, tokens whose pages were re-admitted from the HOST spill
    # tier (hierarchical KV cache, ServingConfig.host_cache_bytes) —
    # a host hit instead of the prefill recompute plain eviction would
    # have cost; 0 with the tier off.
    host_hit_tokens: int = 0
    llm_decoding_steps: int = 0
    ssm_decoding_steps: int = 0
    # Speculation accounting (serve/specinfer.py). ``speculated_tokens``
    # counts DRAFTED tree nodes (root excluded — the root is the
    # previous round's committed token, never a drafted one) and
    # ``accepted_tokens`` the drafted tokens the verifier accepted —
    # the free root/bonus tokens appear in NEITHER, so
    # accepted/speculated is the honest drafted-accept rate
    # (``drafted_accept_rate``). Committed output per verify dispatch —
    # accepted + the verifier's own bonus sample — is the separate
    # tokens-per-verify-step figure (output tokens / llm_decoding_steps).
    speculated_tokens: int = 0
    accepted_tokens: int = 0
    # Adaptive tree shaping (SpecConfig.adaptive): verify rounds this
    # request ran, ladder moves its controller made, and the tree shape
    # it ended on (the configured W×D when the controller is off).
    spec_rounds: int = 0
    tree_resizes: int = 0
    tree_width: int = 0
    tree_depth: int = 0
    # Draft pricing (serve/spec_distill.py accept-rate-per-draft-FLOP):
    # dense FLOPs one drafted token cost in the draft stack that served
    # this request — the cost model's 2×params forward pricing, summed
    # over the SSMs (0.0 outside speculation).
    draft_flops_per_token: float = 0.0
    # Context-parallel long-context serving (ServingConfig.kv_shard=
    # "context"): how many sequence shards this request's KV pages
    # striped over (1 = the single-pool layout).
    context_shards: int = 1
    # Cluster serving (serve/cluster/): which engine replica served the
    # request's decode phase (-1 outside a cluster), and the router's
    # queue-delay estimate for that replica at placement time — the
    # figure SLO admission sheds on (ServingConfig.slo_queue_delay_s).
    replica_id: int = -1
    router_queue_delay_s: float = 0.0
    # Fault tolerance: how many times this request was RE-ADMITTED
    # (replica death failover or migration-queue recompute drain — each
    # re-prefills prompt + tokens generated so far, the vLLM-style
    # recompute path), and the replica that received the most recent
    # failover re-admission (-1 when the request never moved).
    retries: int = 0
    failover_replica_id: int = -1
    # Replica RPC transport (serve/cluster/remote.py): transport-level
    # retry attempts spent on RPCs that carried this request's work
    # (its submit, plus every step/drain retried while it was live on
    # a remote replica) — the per-request mirror of
    # ClusterStats.rpc_retries. 0 outside a transported cluster.
    transport_retries: int = 0

    @property
    def latency_s(self) -> float:
        return max(0.0, self.finish_time - self.start_time)

    @property
    def ttft_s(self) -> float:
        """Time to first token (0 when no token was ever produced)."""
        if not self.first_token_time:
            return 0.0
        return max(0.0, self.first_token_time - self.start_time)

    def tpot_s(self, n_output_tokens: int) -> float:
        """Time per output token over the decode phase (first token →
        finish; 0 with fewer than two output tokens)."""
        if n_output_tokens < 2 or not self.first_token_time:
            return 0.0
        span = max(0.0, self.finish_time - self.first_token_time)
        return span / (n_output_tokens - 1)


@dataclasses.dataclass
class GenerationResult:
    """reference ``GenerationResult`` (request_manager.h): token ids in +
    out, detokenized text, profiling. ``error`` is set (and the token
    lists may be empty/partial) when the request failed instead of
    completing — e.g. it could never be admitted under the configured
    KV budget."""

    request_id: int
    prompt: str
    input_tokens: List[int]
    output_tokens: List[int]
    output_text: str
    profile: ProfileInfo
    error: Optional[str] = None


@dataclasses.dataclass
class StreamEvent:
    """One ``generate_stream`` event: a newly drained token for
    ``request_id``, or (``done=True``, ``token=None``) the request's
    terminal event — with ``error`` set when it failed rather than
    completed."""

    request_id: int
    token: Optional[int]
    done: bool = False
    error: Optional[str] = None
