"""RequestManager — request queue + continuous batching + decoding loops.

Counterpart of ``flexflow_tpu/serve/request_manager.py``: queue incoming
requests, admit them into free batch slots, run chunked prefill and
incremental decoding, and free slots on completion.

Scheduling is iteration-level continuous batching: a prompt enters the
batch in fixed-size chunks, and — with
``ServingConfig.continuous_batching`` (the default) — prefill chunks
ride in the same dispatch-ahead pipelined step as decode rows. The
sampled tokens stay on the GPU and feed the next dispatch; the host
reads them ``dispatch_ahead`` steps later (the flush), so admissions,
chunk progression and completions never drain the pipeline.
``continuous_batching=False`` restores the flush-on-admit scheduler
(any prefilling request forces the blocking sync path).

On the paged layout every step first grows the active slots' page
tables to cover the lines it will touch. When the pool runs out, the
pipeline is drained and the newest admission is preempted: its pages
return to the pool and it goes back to the front of the queue, to be
prefilled again (prompt plus the tokens generated so far) on
re-admission. A request that alone exceeds the pool fails with an
error instead.

With ``ServingConfig.prefix_caching`` on the paged layout, admission
first walks the radix tree (serve/prefix_cache.py): matched pages are
spliced into the slot's table (the tail page copied on write when the
match ends inside it) and prefill starts at the matched length. A
request's blocks are published at completion (``cache_policy``
"complete") or when its prompt's last chunk is dispatched ("prefill");
the host tier's spills are harvested at each flush, after its blocking
read.

Managers that keep a second engine's cache in step with the target's
(SpecInfer, serve/specinfer.py) override the hooks :meth:`_run_batch`,
:meth:`_mirror_dispatch` and :meth:`_cache_attach` and turn off
``supports_fast_decode`` and ``supports_fused_sampling``.

Observability (obs/): every emission site below guards on
``tracer.enabled`` before it builds an event, whose arguments are host
values the scheduler already holds (never a read of a device tensor);
``obs.attach_observability`` turns tracing on. A terminal request error
dumps the flight recorder's ring. ``output_file`` appends one record a
finished request in the reference's format. With
``ServingConfig.inference_debugging`` the scheduler serves every step on
its sync path, where the engine dumps it.

Cluster hooks (serve/cluster/): :meth:`submit` binds a cluster-wide
trace id; :meth:`hold_on_finish` keeps a finished request's slot and
pages for the prefill→decode migration until :meth:`release_held`;
:meth:`adopt_prefilled` admits a request prefilled on another replica
straight into decoding, and :meth:`rollback_adopt` undoes that when the
page hand-off fails.
"""
from __future__ import annotations

import dataclasses
import enum
import time
from typing import Dict, Iterator, List, Optional, Sequence, Union

import numpy as np
import torch

from ..logging_utils import get_logger
from ..metrics import SchedulerStats
from ..obs.tracer import NULL_TRACER
from .batch_config import (
    BatchConfig,
    GenerationConfig,
    GenerationResult,
    ProfileInfo,
    StreamEvent,
)
from .engine import InferenceEngine


class RequestStatus(enum.Enum):
    PENDING = "pending"
    PREFILLING = "prefilling"
    DECODING = "decoding"
    COMPLETED = "completed"
    # Terminal failure, surfaced via GenerationResult.error: a request the
    # paged KV pool can never hold (register_request cuts a prompt to
    # max_sequence_length - 1 tokens, which the dense cache always holds).
    ERROR = "error"


TERMINAL_STATUSES = (RequestStatus.COMPLETED, RequestStatus.ERROR)


@dataclasses.dataclass
class Request:
    """reference ``Request`` (request_manager.h:92-278)."""

    request_id: int
    prompt: str
    tokens: List[int]                 # prompt + generated so far
    prompt_len: int
    gen: GenerationConfig
    status: RequestStatus = RequestStatus.PENDING
    slot: int = -1
    n_cached: int = 0                 # tokens whose K/V commit was flushed
    n_sched: int = 0                  # prompt tokens dispatched (may run
    # ahead of n_cached while prefill chunks are in flight)
    inflight: int = 0                 # dispatched sampling steps not yet
    # read (decode rows + the prefill-final chunk)
    pipeline_refs: int = 0            # in-flight dispatches touching this
    # request's slot — the slot may only be released once this drains to
    # 0, or later writes from already-dispatched steps would scribble on a
    # reassigned slot
    admit_seq: int = -1               # admission order
    error: Optional[str] = None
    profile: ProfileInfo = dataclasses.field(default_factory=ProfileInfo)

    @property
    def output_tokens(self) -> List[int]:
        return self.tokens[self.prompt_len :]


class RequestManager:
    # Subclasses that keep a second engine's cache in sync (SpecInfer)
    # must not use the target-only pipelined decode step.
    supports_fast_decode = True
    # The "sampling"/"whole_step" fusions' sync path (engine.run_sampled)
    # bypasses the _run_batch hook; managers that override _run_batch opt
    # out and keep the step plus the host-side head.
    supports_fused_sampling = True
    # Automatic prefix caching: managers that mirror slot state across
    # engines (SpecInfer) keep one radix tree a page pool and align the
    # matched lengths through the _cache_attach/_cache_insert hooks.
    supports_prefix_cache = True

    def __init__(
        self,
        engine: InferenceEngine,
        tokenizer=None,
        eos_token_id: Optional[int] = None,
        seed: int = 0,
        output_file: Optional[str] = None,
    ):
        self.engine = engine
        if engine.serving.inference_debugging and getattr(
                engine.model, "serve_debug_activations", None) is not None:
            # the engine dumps a step in run / run_sampled, which the
            # pipelined steps do not go through: triage serves every step
            # on the sync path. A model without the hook keeps fast decode
            # (nothing could be dumped; the engine warns instead).
            self.supports_fast_decode = False
        self.tokenizer = tokenizer
        self.eos_token_id = eos_token_id
        # Per-request telemetry sink (reference -output-file): one record
        # appended per finished request (_write_output_record).
        self.output_file = output_file
        if eos_token_id is None and tokenizer is not None:
            self.eos_token_id = getattr(tokenizer, "eos_token_id", None)
        self.requests: Dict[int, Request] = {}
        self.pending: List[int] = []
        self.slots: List[Optional[int]] = [None] * engine.num_slots
        self._next_id = 1000000  # reference starts guids at 1000000
        self._admit_counter = 0
        # the draws of non-greedy sampling, on the engine's device
        self._generator = torch.Generator(device=engine.device)
        self._generator.manual_seed(seed)
        self._step_counter = 0
        # Dispatch-ahead pipeline: entries are
        # (device_tokens, [(rid, slot, ntoks, samples), ...]) oldest-first;
        # ``ntoks`` is the row's cache lines this dispatch wrote,
        # ``samples`` whether its sampled token is meaningful (decode rows
        # and prefill-final rows).
        self._inflight: List[tuple] = []
        # Slots whose sampled token in the NEWEST dispatch is their next
        # input (device feedback instead of a host token).
        self._prev_dispatch_slots: set = set()
        self.stats = SchedulerStats()
        self._log = get_logger("serve")
        # Observability (obs/): request-lifecycle tracing and the failure
        # flight recorder, off by default. obs.attach_observability wires a
        # live tracer in and shares it with the engines.
        self.tracer = NULL_TRACER
        self.flight_recorder = None
        # rid -> trace id (bound by a cluster front end; a local run falls
        # back to the rid itself — see trace_of)
        self._trace_ids: Dict[int, int] = {}
        # finished requests whose slot and pages stay allocated until
        # release_held (cluster migration sources)
        self.hold_finished: set = set()
        # Automatic prefix caching (paged layout only: on the dense layout
        # prefix_caching passes through, there are no pages to share). The
        # radix tree holds one reference a cached page; the allocator's
        # reclaim hook frees idle cached pages before an allocation fails.
        self.prefix_cache = None
        sc = engine.serving
        if self.supports_prefix_cache and sc.prefix_caching and engine.paged:
            from .prefix_cache import PrefixCache

            # the host tier: with a host_cache_bytes budget the cache spills
            # cold pages to pinned host memory instead of evicting them, and
            # harvests the spills at the flush (the scheduler's sync point)
            host_kw = {}
            if sc.host_cache_bytes:
                host_kw = dict(
                    fetch_page=engine.fetch_page,
                    upload_page=engine.upload_page,
                    host_cache_bytes=sc.host_cache_bytes,
                    page_bytes=engine.page_host_bytes(),
                )
            self.prefix_cache = PrefixCache(
                engine.pager,
                copy_page=engine.copy_page,
                policy=sc.cache_policy,
                stats=lambda: self.stats,
                **host_kw,
            )
            engine.pager.reclaim_cb = self.prefix_cache.reclaim

    # ------------------------------------------------------------------
    # registration (reference register_new_request, request_manager.cc:137)

    def register_request(
        self,
        prompt: Union[str, Sequence[int]],
        gen: Optional[GenerationConfig] = None,
    ) -> int:
        gen = gen or GenerationConfig()
        if isinstance(prompt, str):
            if self.tokenizer is None:
                raise ValueError("string prompt requires a tokenizer")
            tokens = list(self.tokenizer.encode(prompt))
            text = prompt
        else:
            tokens = [int(t) for t in prompt]
            text = ""
        if not tokens:
            raise ValueError("empty prompt")
        max_len = self.engine.serving.max_sequence_length
        if len(tokens) >= max_len:
            tokens = tokens[: max_len - 1]
        rid = self._next_id
        self._next_id += 1
        req = Request(
            request_id=rid,
            prompt=text,
            tokens=list(tokens),
            prompt_len=len(tokens),
            gen=gen,
        )
        req.profile.start_time = time.perf_counter()
        self.requests[rid] = req
        self.pending.append(rid)
        return rid

    def submit(
        self,
        prompt: Union[str, Sequence[int]],
        gen: Optional[GenerationConfig] = None,
        max_new_tokens: Optional[int] = None,
        trace_id: Optional[int] = None,
    ) -> int:
        """Non-blocking submission: queue one request and return its id.
        Drive the scheduler with :meth:`step`. ``trace_id`` binds a
        cluster-wide trace id, so the request's events stitch with the
        router's and the other replicas' (obs/tracer.py)."""
        gen = gen or GenerationConfig()
        if max_new_tokens is not None:
            gen = dataclasses.replace(gen, max_new_tokens=max_new_tokens)
        rid = self.register_request(prompt, gen)
        if trace_id is not None:
            self._trace_ids[rid] = int(trace_id)
        return rid

    def bind_trace(self, rid: int, trace_id: int) -> None:
        """Bind ``rid``'s events to a cluster-wide trace id."""
        self._trace_ids[int(rid)] = int(trace_id)

    def trace_of(self, rid: int) -> int:
        """The trace id this request's events carry: the bound one, else
        the rid itself (single-engine runs)."""
        return self._trace_ids.get(rid, rid)

    # ------------------------------------------------------------------
    # cluster hooks (serve/cluster/): hold-for-migration and adoption of
    # a request prefilled elsewhere

    def hold_on_finish(self, rid: int) -> None:
        """Keep ``rid``'s slot and pages when it finishes: the prefill→
        decode migration reads them from the pool afterwards. Pair with
        :meth:`release_held`."""
        self.hold_finished.add(rid)

    def release_held(self, rid: int) -> None:
        """Release the slot and pages of a finished held request (its
        pages were shipped, or the hold is abandoned)."""
        self.hold_finished.discard(rid)
        req = self.requests.get(rid)
        if (req is not None and req.status in TERMINAL_STATUSES and req.slot >= 0
                and req.pipeline_refs == 0):
            self._release_slot(req)

    def adopt_prefilled(
        self,
        tokens: Sequence[int],
        prompt_len: int,
        gen: GenerationConfig,
        *,
        profile: Optional[ProfileInfo] = None,
        prompt_text: str = "",
        trace_id: Optional[int] = None,
    ) -> Optional[int]:
        """Admit a request prefilled on another replica straight into
        DECODING: ``tokens`` is the prompt and the first sampled token,
        and cache lines [0, prompt_len) are about to be filled by page
        uploads into the slot this allocates. Returns the new id, or None
        when no slot (or no pages) can be had now (the caller retries;
        a page shortfall gives the slot back)."""
        assert len(tokens) > prompt_len, "adopt needs the first output token"
        slot = next((i for i, occ in enumerate(self.slots) if occ is None), None)
        if slot is None:
            return None
        if self._paged:
            for eng in self._engines():
                if not eng.pager.ensure(slot, prompt_len):
                    self._release_pages(slot)
                    return None
        rid = self._next_id
        self._next_id += 1
        req = Request(request_id=rid, prompt=prompt_text, tokens=[int(t) for t in tokens],
                      prompt_len=int(prompt_len), gen=gen)
        req.slot = slot
        req.status = RequestStatus.DECODING
        req.n_cached = int(prompt_len)
        req.n_sched = int(prompt_len)
        req.admit_seq = self._admit_counter
        self._admit_counter += 1
        if profile is not None:
            req.profile = profile
        self.requests[rid] = req
        self.slots[slot] = rid
        self.stats.admitted += 1
        if trace_id is not None:
            self._trace_ids[rid] = int(trace_id)
        tr = self.tracer
        if tr.enabled:
            tr.event("adopt", trace_id=self.trace_of(rid), rid=rid, slot=slot,
                     prompt_len=int(prompt_len))
        return rid

    def rollback_adopt(self, rid: int) -> None:
        """Undo :meth:`adopt_prefilled` before any step ran (the page
        hand-off failed after the adoption): release the slot and pages
        and forget the request. The source still holds the original."""
        req = self.requests.pop(rid)
        assert req.status is RequestStatus.DECODING, (
            f"rollback_adopt of request {rid} in state {req.status}")
        assert req.pipeline_refs == 0 and req.n_cached == req.prompt_len, (
            "rollback_adopt after the adopted request already stepped")
        if req.slot >= 0:
            if self._paged:
                self._release_pages(req.slot)
            self.slots[req.slot] = None
        self.stats.admitted -= 1

    # ------------------------------------------------------------------
    # paged-KV page management (serve/paging.py PageAllocator)

    @property
    def _paged(self) -> bool:
        return self.engine.paged

    def _engines(self) -> List[InferenceEngine]:
        """Every engine whose cache this manager keeps in sync (SpecInfer
        adds its draft models' engines)."""
        return [self.engine]

    def _ensure_pages(self, req: Request, num_lines: int) -> bool:
        """Cover cache lines [0, num_lines) for ``req`` on every engine;
        all-or-nothing per engine (``ensure`` is idempotent, so a retry
        after a partial cross-engine grant is safe)."""
        return all(eng.pager.ensure(req.slot, num_lines) for eng in self._engines())

    def _release_pages(self, slot: int):
        for eng in self._engines():
            eng.pager.release(slot)

    def _prefix_caches(self):
        """Every prefix cache this manager keeps (SpecInfer adds one radix
        tree a draft pool)."""
        return [] if self.prefix_cache is None else [self.prefix_cache]

    def _cache_attach(self, slot: int, tokens: Sequence[int]) -> int:
        """Hook: the admission's prefix-cache attach. SpecInfer attaches
        the same matched length on every pool, or none at all."""
        return self.prefix_cache.attach(slot, tokens)

    def _cache_insert(self, slot: int, tokens: Sequence[int], valid: int) -> None:
        """Hook: publish a slot's blocks into every radix tree this
        manager keeps (SpecInfer's draft pools hold the same tokens' K/V
        at the same lines, paged on their own)."""
        for cache in self._prefix_caches():
            cache.insert(slot, tokens, valid)

    def _mirror_dispatch(self, last, host_tokens, use_last, positions, logits_idx,
                         generator, greedy, temperature, topp, topk) -> None:
        """Hook: a manager that keeps secondary engines' caches in sync
        (SpecInfer's drafts) dispatches the same pipelined step there,
        with the arguments the target engine got, so every cache advances
        in lockstep without a host round trip. The base manager has no
        secondary engine."""

    def _preempt(self, req: Request):
        """Evict an admitted request back to the front of the queue and
        reclaim its pages. Its lines are recomputed on re-admission
        (prompt plus the tokens generated so far prefill again), so
        generation goes on where it stopped. Only called with the pipeline
        drained, so no dispatched step can write the reclaimed pages."""
        assert req.pipeline_refs == 0, "preempting a request with work in flight"
        self._release_pages(req.slot)
        self.slots[req.slot] = None
        req.slot = -1
        req.status = RequestStatus.PENDING
        req.n_cached = 0
        req.n_sched = 0
        req.inflight = 0
        self.pending.insert(0, req.request_id)
        self.stats.preemptions += 1
        tr = self.tracer
        if tr.enabled:
            tr.event("preempt", trace_id=self.trace_of(req.request_id), rid=req.request_id)

    def _lines_needed(self, req: Request, chunk: Optional[int] = None) -> int:
        """The cache lines the next step may touch, bounded from above."""
        if req.status is RequestStatus.PREFILLING:
            chunk = chunk or self.engine.serving.prefill_chunk
            return min(len(req.tokens), max(req.n_cached, req.n_sched) + chunk)
        # decode: reads lines [0, len-1], writes len-1, plus the lines of
        # the dispatch-ahead steps in flight
        return len(req.tokens) + req.inflight + 1

    def _reserve_active_pages(self, lines_fn=None):
        """Grow every active slot's page table to cover this step's reads
        and writes; when the pool runs out, drain the pipeline, preempt
        the newest admission and retry. A request that alone exceeds the
        pool fails with an error instead of stalling everyone else."""
        if not self._paged:
            return
        lines_fn = lines_fn or self._lines_needed
        while True:
            active = sorted(
                (self.requests[rid] for rid in self.slots
                 if rid is not None and self.requests[rid].status
                 in (RequestStatus.PREFILLING, RequestStatus.DECODING)),
                key=lambda r: r.admit_seq,
            )
            for req in active:
                if self._ensure_pages(req, lines_fn(req)):
                    continue
                # drain before touching slot ownership; completions the
                # flush lands may already free enough pages
                self._flush_all()
                if req.status not in (
                    RequestStatus.PREFILLING, RequestStatus.DECODING
                ) or self._ensure_pages(req, lines_fn(req)):
                    break  # the active set changed; derive it again
                victims = [
                    r for r in active
                    if r is not req and r.status
                    in (RequestStatus.PREFILLING, RequestStatus.DECODING)
                ]
                if not victims:
                    self._fail_request(
                        req,
                        "KV page pool exhausted by this request alone — raise "
                        "ServingConfig.max_cached_tokens (or lower "
                        "max_sequence_length/page_size)",
                    )
                    break
                self._preempt(victims[-1])
                break
            else:
                return

    # ------------------------------------------------------------------
    # slot management

    def _admission_error(self, req: Request) -> Optional[str]:
        """A reason this request can never be admitted under the
        configured limits, or None (without the check it would wait in
        the queue forever)."""
        sc = self.engine.serving
        need = len(req.tokens) + 1  # prompt lines + the first output's line
        if need > sc.cache_len + 1:
            return (f"prompt ({len(req.tokens)} tokens) exceeds the cache "
                    f"capacity ({sc.cache_len} lines)")
        if not self._paged:
            return None
        # with kv_quant the budget buys more pages: the allocator's own
        # capacity below is the bound then
        if (sc.max_cached_tokens is not None and sc.kv_quant is None
                and need > sc.max_cached_tokens):
            return (f"prompt ({len(req.tokens)} tokens) can never fit the "
                    f"configured KV budget (max_cached_tokens="
                    f"{sc.max_cached_tokens})")
        for eng in self._engines():
            cap = eng.pager.num_pages * eng.pager.page_size
            if need > cap:
                return (f"prompt ({len(req.tokens)} tokens) exceeds the KV "
                        f"page pool ({cap} tokens)")
        return None

    def _admit_pending(self):
        for i, occupant in enumerate(self.slots):
            if occupant is not None:
                continue
            # fail unservable heads at once instead of parking them
            while self.pending:
                head = self.requests[self.pending[0]]
                err = self._admission_error(head)
                if err is None:
                    break
                self._fail_request(head, err)
            if not self.pending:
                return
            rid = self.pending[0]
            req = self.requests[rid]
            req.slot = i
            # the prefix cache's hit path: splice cached prompt pages into
            # the (empty) slot table and start prefill past them. A rolled
            # back admission releases the spliced references with the slot.
            matched = 0
            host_before = self.stats.host_hit_tokens
            if self.prefix_cache is not None:
                matched = self._cache_attach(i, req.tokens)
            if self._paged and not self._ensure_pages(
                req, min(len(req.tokens), matched + self.engine.serving.prefill_chunk)
            ):
                # the pool cannot take the first chunk: stop admitting
                # (a flush frees pages) and undo any partial grant
                self._release_pages(i)
                req.slot = -1
                return
            self.pending.pop(0)
            req.status = RequestStatus.PREFILLING
            req.n_cached = matched
            req.n_sched = matched
            req.inflight = 0
            req.pipeline_refs = 0
            req.admit_seq = self._admit_counter
            self._admit_counter += 1
            req.profile.cached_prefix_len = matched
            # the prefix's tokens that came back from the host tier (the
            # counter moved inside attach's re-admissions)
            req.profile.host_hit_tokens = self.stats.host_hit_tokens - host_before
            if self.prefix_cache is not None:
                if matched:
                    self.stats.prefix_hits += 1
                    self.stats.prefix_hit_tokens += matched
                else:
                    self.stats.prefix_misses += 1
            self.slots[i] = rid
            self.stats.admitted += 1
            tr = self.tracer
            if tr.enabled:
                tid = self.trace_of(rid)
                if self.prefix_cache is not None:
                    tr.event("prefix_lookup", trace_id=tid, rid=rid, matched=matched)
                tr.event("admit", trace_id=tid, rid=rid, slot=i,
                         prompt_len=req.prompt_len, cached_prefix=matched)

    def _active(self, status: RequestStatus) -> List[Request]:
        out = []
        for rid in self.slots:
            if rid is None:
                continue
            r = self.requests[rid]
            if r.status is status:
                out.append(r)
        return out

    def _release_slot(self, req: Request):
        """Return the request's slot (and, paged, its pages) to the free
        pool. Callers guarantee no in-flight dispatch still references it
        (pipeline_refs == 0)."""
        if req.slot < 0:
            return
        if self._paged:
            self._release_pages(req.slot)
        self.slots[req.slot] = None
        req.slot = -1

    def _finish(self, req: Request, error: Optional[str] = None):
        req.status = RequestStatus.ERROR if error else RequestStatus.COMPLETED
        req.error = error
        req.profile.finish_time = time.perf_counter()
        tr = self.tracer
        if tr.enabled:
            tr.event("terminal", trace_id=self.trace_of(req.request_id),
                     rid=req.request_id, status=req.status.value, error=(error or "")[:200])
        if error and self.flight_recorder is not None:
            # a terminal request error dumps this lane's recent ring
            self.flight_recorder.dump(
                self.tracer.lane, "request_error", step=self._step_counter,
                extra={"rid": req.request_id, "error": error[:500]})
        if (self.prefix_cache is not None and error is None and req.slot >= 0
                and self.prefix_cache.policy == "complete"):
            # publish the finished sequence's blocks (prompt and generated:
            # the next turn of a conversation extends this transcript).
            # Only lines written on the device count: the final sampled
            # token's K/V never was.
            self._cache_insert(req.slot, req.tokens, len(req.tokens) - 1)
        # With dispatches still in flight for this slot, defer the release
        # to the flush that drains the last of them: they keep writing
        # (garbage) K/V through the slot's table, so handing the slot or
        # its pages to another request now would corrupt that request's
        # cache. Held requests (cluster migration sources) keep slot and
        # pages until release_held.
        if (req.slot >= 0 and req.pipeline_refs == 0
                and req.request_id not in self.hold_finished):
            self._release_slot(req)
        if self.output_file and error is None:
            self._write_output_record(req)

    def _write_output_record(self, req: Request):
        """Append one finished request's telemetry in the reference's
        output-file format (request_manager.cc: ``[Profile] guid(%d)
        llm_decoding_steps(%d) latency(%.1lf)``, then the token ids and
        the decoded output)."""
        p = req.profile
        latency_us = (p.finish_time - p.start_time) * 1e6
        text = (self.tokenizer.decode(req.output_tokens)
                if self.tokenizer is not None else "")
        with open(self.output_file, "a") as f:
            f.write(f"[Profile] guid({req.request_id}) "
                    f"llm_decoding_steps({p.llm_decoding_steps}) "
                    f"latency({latency_us:.1f})\n")
            f.write(f"guid({req.request_id}) tokens("
                    + " ".join(str(t) for t in req.tokens)
                    + f") output({text})\n")

    def _fail_request(self, req: Request, reason: str):
        self.stats.failed += 1
        self._log.warning("request %d failed: %s", req.request_id, reason)
        if req.request_id in self.pending:
            self.pending.remove(req.request_id)
        self._finish(req, error=reason)

    # ------------------------------------------------------------------
    # batch building (reference prepare_next_batch, request_manager.cc:350)

    def _fill_prefill_row(self, bc: BatchConfig, req: Request, chunk: int):
        off = req.n_cached
        toks = req.tokens[off : off + chunk]
        n = len(toks)
        bc.tokens[req.slot, :n] = toks
        bc.positions[req.slot, :n] = np.arange(off, off + n)
        bc.active[req.slot] = True
        bc.logits_idx[req.slot] = n - 1
        bc.qlens[req.slot] = n
        bc.prefill_offsets[req.slot] = off

    def _prepare_batch(self) -> Optional[BatchConfig]:
        """Build one blocking mixed prefill+decode batch (the sync path).
        Decoding slots always contribute their one pending token, so
        decode never stalls behind a long prompt's prefill; the chunk is
        1 when nobody is prefilling."""
        prefilling = self._active(RequestStatus.PREFILLING)
        decoding = self._active(RequestStatus.DECODING)
        if not prefilling and not decoding:
            return None
        sc = self.engine.serving
        chunk = sc.prefill_chunk if prefilling else 1
        R = self.engine.num_slots
        bc = BatchConfig.empty(R, chunk, self.engine.scratch_pos)
        bc.qlens = np.zeros((R,), np.int32)
        bc.prefill_offsets = np.zeros((R,), np.int32)
        for req in prefilling:
            self._fill_prefill_row(bc, req, chunk)
        for req in decoding:
            bc.tokens[req.slot, 0] = req.tokens[-1]
            bc.positions[req.slot, 0] = len(req.tokens) - 1
            bc.active[req.slot] = True
            bc.logits_idx[req.slot] = 0
            bc.qlens[req.slot] = 1
        return bc

    def _run_batch(self, bc: BatchConfig):
        """Hook: run one prepared sync batch through the engine(s);
        returns the target's logits. SpecInferManager overrides it to
        feed the same batch to its drafts."""
        return self.engine.run(bc)

    # ------------------------------------------------------------------
    # sampling glue

    def _decode_head_params(self, reqs: Sequence[Request]):
        """Per-slot decode-head arrays for ``reqs`` (greedy/temperature/
        top-k/top-p; top-p >= 1 and top-k <= 0 disable the filters)."""
        R = self.engine.num_slots
        greedy = np.ones((R,), bool)
        temp = np.ones((R,), np.float32)
        topp = np.full((R,), 2.0, np.float32)  # disabled
        topk = np.zeros((R,), np.int32)        # disabled
        for req in reqs:
            greedy[req.slot] = not req.gen.do_sample
            temp[req.slot] = req.gen.temperature
            topp[req.slot] = req.gen.topp if req.gen.do_sample else 2.0
            topk[req.slot] = req.gen.topk if req.gen.do_sample else 0
        return greedy, temp, topp, topk

    def _sample(self, logits) -> np.ndarray:
        """Sample one token per slot from (R, V) logits using each slot's
        GenerationConfig (the sync path's decode head)."""
        head = self._decode_head_params(
            [self.requests[r] for r in self.slots if r is not None])
        toks = self.engine._sample(logits, self._generator, *head)
        # the host-side decode head is its own dispatch (the JAX engine's
        # "host_sample" program), the one the fused heads save
        self.engine.count_dispatch("host_sample")
        return toks.cpu().numpy()

    def _append_token(self, req: Request, token: int):
        if len(req.tokens) == req.prompt_len and not req.profile.first_token_time:
            # the request's first generated token, as the host observes it
            # (TTFT the way a streaming client would measure it)
            req.profile.first_token_time = time.perf_counter()
            tr = self.tracer
            if tr.enabled:
                tr.event("first_token", trace_id=self.trace_of(req.request_id),
                         rid=req.request_id)
        done = self._completes(req, token)
        req.tokens.append(int(token))
        if done:
            self._finish(req)

    def _completes(self, req: Request, token: int) -> bool:
        """Whether appending ``token`` ends ``req``: a stop token, its
        ``max_new_tokens`` reached, or ``max_sequence_length``."""
        stops = set(req.gen.stop_token_ids)
        if self.eos_token_id is not None:
            stops.add(self.eos_token_id)
        n = len(req.tokens) + 1
        return (int(token) in stops or n - req.prompt_len >= req.gen.max_new_tokens
                or n >= self.engine.serving.max_sequence_length)

    # ------------------------------------------------------------------
    # dispatch-ahead pipeline (reference request_manager.cc:2310)

    def _sched_exhausted(self, req: Request) -> bool:
        """Everything this request will ever need is already dispatched."""
        gen_dispatched = len(req.tokens) - req.prompt_len + req.inflight
        return (
            gen_dispatched >= req.gen.max_new_tokens
            or len(req.tokens) + req.inflight
            >= self.engine.serving.max_sequence_length
        )

    def _last_tokens(self):
        if self._inflight:
            return self._inflight[-1][0]
        return torch.zeros((self.engine.num_slots,), dtype=torch.int64,
                           device=self.engine.device)

    def _dispatch_decode(self, decoding: List[Request]):
        """Dispatch one decode step WITHOUT waiting for the previous one:
        rows that sampled in the previous dispatch take their input token
        from the on-device sampled tokens; rows entering the pipeline
        take it from host state. Positions advance deterministically, so
        no host sync is needed."""
        R = self.engine.num_slots
        scratch = self.engine.scratch_pos
        host_tokens = np.zeros((R, 1), np.int32)
        use_last = np.zeros((R,), bool)
        positions = np.full((R, 1), scratch, np.int32)
        greedy, temp, topp, topk = self._decode_head_params(decoding)
        snapshot = []
        have_last = bool(self._inflight)
        for req in decoding:
            s = req.slot
            positions[s, 0] = len(req.tokens) - 1 + req.inflight
            if s in self._prev_dispatch_slots and have_last:
                use_last[s] = True
            else:
                host_tokens[s, 0] = req.tokens[-1]
            req.inflight += 1
            req.pipeline_refs += 1
            snapshot.append((req.request_id, s, 1, True))
        t0 = time.perf_counter()
        last = self._last_tokens()
        toks = self.engine.run_decode(
            last, host_tokens, use_last, positions,
            self._generator, greedy, temp, topp, topk,
        )
        self._mirror_dispatch(last, host_tokens, use_last, positions,
                              np.zeros((R,), np.int32), self._generator, greedy, temp,
                              topp, topk)
        # the engine call's host wall time — the dispatch cost on this
        # pipelined path (the device runs ahead; no sync is added)
        self.stats.note_decode_step_ms((time.perf_counter() - t0) * 1e3)
        self._inflight.append((toks, snapshot))
        self._prev_dispatch_slots = {s for _, s, _, _ in snapshot}
        self._step_counter += 1
        self.stats.record_step(
            "decode", active_slots=len(decoding), num_slots=R,
            decode_tokens=len(decoding),
        )
        tr = self.tracer
        if tr.enabled:
            tr.event("decode_step", rows=len(decoding))
        self._maybe_log_stats()

    def _dispatch_mixed(self, prefilling: List[Request],
                        decoding: List[Request]):
        """Dispatch one pipelined MIXED step: every decode row's single
        token plus chunked prefill under the per-step token budget, in
        ONE (R, mixed_chunk) ragged dispatch (padding columns sit at the
        scratch position). Prefill rows whose final chunk is in this
        dispatch turn DECODING at once: their sampled token is on the
        device, so the next iteration schedules them as decode rows fed
        by device feedback."""
        eng = self.engine
        sc = eng.serving
        R = eng.num_slots
        C = sc.mixed_chunk
        bc = BatchConfig.empty(R, C, eng.scratch_pos)
        bc.qlens = np.zeros((R,), np.int32)
        bc.prefill_offsets = np.zeros((R,), np.int32)
        use_last = np.zeros((R,), bool)
        snapshot = []
        sampled_slots = set()
        have_last = bool(self._inflight)
        greedy, temp, topp, topk = self._decode_head_params(
            list(decoding) + list(prefilling)
        )
        for req in decoding:
            s = req.slot
            bc.positions[s, 0] = len(req.tokens) - 1 + req.inflight
            if s in self._prev_dispatch_slots and have_last:
                use_last[s] = True
            else:
                bc.tokens[s, 0] = req.tokens[-1]
            bc.logits_idx[s] = 0
            bc.active[s] = True
            bc.qlens[s] = 1
            req.inflight += 1
            req.pipeline_refs += 1
            snapshot.append((req.request_id, s, 1, True))
            sampled_slots.add(s)
        spent = 0
        tr = self.tracer
        for req in sorted(prefilling, key=lambda r: r.admit_seq):
            n = min(C, len(req.tokens) - req.n_sched)
            if n <= 0:
                continue
            s = req.slot
            off = req.n_sched
            bc.tokens[s, :n] = req.tokens[off : off + n]
            bc.positions[s, :n] = np.arange(off, off + n)
            bc.logits_idx[s] = n - 1
            bc.active[s] = True
            bc.qlens[s] = n
            bc.prefill_offsets[s] = off
            final = off + n >= len(req.tokens)
            req.n_sched += n
            req.pipeline_refs += 1
            spent += n
            if final:
                # prompt fully dispatched: this step samples the first
                # output token on the device — decode from the next step on
                req.status = RequestStatus.DECODING
                req.inflight += 1
                sampled_slots.add(s)
                if self.prefix_cache is not None and self.prefix_cache.policy == "prefill":
                    # every prompt line's write is dispatched: publish the
                    # prompt now, so that same-prefix admissions hit before
                    # this request finishes
                    self._cache_insert(s, req.tokens[: req.prompt_len], req.prompt_len)
            snapshot.append((req.request_id, s, n, final))
            if tr.enabled:
                tr.event("prefill_chunk", trace_id=self.trace_of(req.request_id),
                         rid=req.request_id, n=n, offset=off, final=final)
        last = self._last_tokens()
        toks = eng.run_mixed(
            last, bc.tokens, use_last, bc.positions,
            bc.logits_idx, self._generator, greedy, temp, topp, topk,
        )
        self._mirror_dispatch(last, bc.tokens, use_last, bc.positions, bc.logits_idx,
                              self._generator, greedy, temp, topp, topk)
        self._inflight.append((toks, snapshot))
        self._prev_dispatch_slots = sampled_slots
        self._step_counter += 1
        self.stats.record_step(
            "mixed", active_slots=int(bc.active.sum()), num_slots=R,
            prefill_tokens=spent, decode_tokens=len(decoding),
            budget=C * max(1, len(prefilling)),
        )
        if tr.enabled:
            tr.event("mixed_step", prefill_tokens=spent, decode_rows=len(decoding))
        self._maybe_log_stats()

    def _flush_one(self):
        """Read the oldest in-flight step's tokens and do the deferred
        host bookkeeping: advance each row's committed-line count, and for
        sampling rows append the token (EOS/length checks). A request
        finished by an earlier flush skips the bookkeeping but still
        drains its pipeline refs — its slot is released at the flush that
        drains the last reference."""
        toks, snapshot = self._inflight.pop(0)
        # the pipeline flush is the designed sync point: it reads a step
        # the device finished dispatch_ahead steps ago
        toks = toks.cpu().numpy()
        self.stats.flushes += 1
        tr = self.tracer
        if tr.enabled:
            tr.event("flush", entries=len(snapshot))
        for rid, slot, ntoks, samples in snapshot:
            req = self.requests.get(rid)
            if req is None:
                continue
            req.pipeline_refs = max(0, req.pipeline_refs - 1)
            if samples:
                req.inflight = max(0, req.inflight - 1)
            alive = (
                req.status
                in (RequestStatus.PREFILLING, RequestStatus.DECODING)
                and req.slot == slot
            )
            if alive:
                req.n_cached += ntoks
                if samples:
                    req.profile.llm_decoding_steps += 1
                    self._append_token(req, toks[slot])
            if (
                req.status in TERMINAL_STATUSES
                and req.slot == slot
                and req.pipeline_refs == 0
                and req.request_id not in self.hold_finished
            ):
                self._release_slot(req)
        # the read above blocked on the device: every spill copy enqueued
        # before it has landed, so the handles become host buffers and
        # their device clones are released
        for cache in self._prefix_caches():
            cache.harvest()

    def drain(self):
        """Flush every in-flight dispatch: appends the outstanding tokens
        and releases the slots and pages of finished requests whose last
        dispatches were still in the pipeline."""
        self._flush_all()

    def _flush_all(self):
        if self._inflight:
            self.stats.pipeline_drains += 1
        while self._inflight:
            self._flush_one()
        self._prev_dispatch_slots = set()

    def _trim_pipeline(self):
        depth = max(1, self.engine.serving.dispatch_ahead)
        while len(self._inflight) >= depth:
            self._flush_one()

    def _slots_reclaimable(self) -> bool:
        """Some slot is held by a request that only needs flushes to
        leave: already terminal (refs in flight) or with its whole
        generation budget dispatched."""
        for rid in self.slots:
            if rid is None:
                continue
            req = self.requests[rid]
            if req.status in TERMINAL_STATUSES:
                # held slots (cluster migration sources) leave through
                # release_held alone: flushing cannot reclaim them
                if rid not in self.hold_finished:
                    return True
                continue
            if (
                req.status is RequestStatus.DECODING
                and self._sched_exhausted(req)
            ):
                return True
        return False

    def _reclaim_slots_for_admission(self):
        """Under saturation (pending queue non-empty, no free slot),
        flush ahead of the dispatch_ahead cadence to reclaim slots held
        by finished or fully-dispatched requests, then admit."""
        if not self.pending or any(s is None for s in self.slots):
            return
        while (
            self._inflight
            and self.pending
            and not any(s is None for s in self.slots)
            and self._slots_reclaimable()
        ):
            self._flush_one()
        self._admit_pending()

    def _maybe_log_stats(self):
        # the whole-step gate's telemetry, mirrored from the engine
        self.stats.whole_step_fallbacks = self.engine.whole_step_fallbacks
        self.stats.whole_step_smem_est = self.engine.whole_step_smem_est
        if self._step_counter % 200 == 0:
            self._log.debug("%s", self.stats.report())

    # ------------------------------------------------------------------

    def step(self) -> bool:
        """One scheduling step. Returns False when no work remains.

        Pure-decode iterations go through the pipelined C == 1 step and —
        with ``continuous_batching`` — iterations with prefilling slots
        through the pipelined mixed step. The blocking sync path serves
        prefill under the flush-on-admit scheduler and the idle drain."""
        self._admit_pending()
        sc = self.engine.serving
        if self.supports_fast_decode:
            self._reclaim_slots_for_admission()
            prefilling = self._active(RequestStatus.PREFILLING)
            decoding = self._active(RequestStatus.DECODING)
            if decoding and not prefilling:
                self._reserve_active_pages()
                return self._step_pipelined(mixed=False)
            if sc.continuous_batching and (prefilling or decoding):
                self._reserve_active_pages(
                    lambda r: self._lines_needed(r, sc.mixed_chunk))
                return self._step_pipelined(mixed=True)
        return self._step_sync()

    def _step_pipelined(self, mixed: bool) -> bool:
        # page reservation may have preempted or failed requests: derive
        # the schedulable set again
        prefilling = self._active(RequestStatus.PREFILLING) if mixed else []
        decoding = [
            r for r in self._active(RequestStatus.DECODING)
            if not self._sched_exhausted(r)
        ]
        if prefilling:
            self._dispatch_mixed(prefilling, decoding)
        elif decoding:
            self._dispatch_decode(decoding)
        elif self._inflight:
            # every row is fully dispatched: make flush progress so the
            # pending completions land
            self._flush_one()
            return True
        else:
            return bool(self.pending)
        self._trim_pipeline()
        return True

    def _step_sync(self) -> bool:
        self._flush_all()
        self._reserve_active_pages()
        bc = self._prepare_batch()
        if bc is None:
            return bool(self.pending)
        prefilling = self._active(RequestStatus.PREFILLING)
        decoding = self._active(RequestStatus.DECODING)
        decode_only = bool(decoding) and not prefilling
        t0 = time.perf_counter()
        fused = self.engine.serving.fused_decode
        if ("sampling" in fused or "whole_step" in fused) and self.supports_fused_sampling:
            # the fusions' sync path: the step and its sampling in one call
            greedy, temp, topp, topk = self._decode_head_params(
                [self.requests[r] for r in self.slots if r is not None])
            sampled = self.engine.run_sampled(bc, self._generator, greedy, temp, topp,
                                              topk).cpu().numpy()
        else:
            sampled = self._sample(self._run_batch(bc))
        if decode_only:
            # the full blocking step wall time (this path syncs by design)
            self.stats.note_decode_step_ms((time.perf_counter() - t0) * 1e3)
        for req in decoding:
            req.n_cached += 1
            req.n_sched = req.n_cached
            req.profile.llm_decoding_steps += 1
            self._append_token(req, sampled[req.slot])
        for req in prefilling:
            n = int(bc.logits_idx[req.slot]) + 1  # tokens cached this chunk
            req.n_cached += n
            req.n_sched = req.n_cached
            if req.n_cached >= len(req.tokens):
                # prompt fully cached: first output token sampled now
                req.status = RequestStatus.DECODING
                if self.prefix_cache is not None and self.prefix_cache.policy == "prefill":
                    self._cache_insert(req.slot, req.tokens[: req.prompt_len],
                                       req.prompt_len)
                req.profile.llm_decoding_steps += 1
                self._append_token(req, sampled[req.slot])
        self._step_counter += 1
        self.stats.record_step(
            "sync",
            active_slots=len(prefilling) + len(decoding),
            num_slots=self.engine.num_slots,
            prefill_tokens=int(
                sum(bc.qlens[r.slot] for r in prefilling)
            ) if prefilling else 0,
            decode_tokens=len(decoding),
        )
        tr = self.tracer
        if tr.enabled:
            tr.event("sync_step", prefill_rows=len(prefilling), decode_rows=len(decoding))
        self._maybe_log_stats()
        return True

    # ------------------------------------------------------------------
    # blocking frontend

    def result(self, rid: int) -> GenerationResult:
        """The GenerationResult of a (terminal or in-flight) request."""
        req = self.requests[rid]
        out = req.output_tokens
        text = (
            self.tokenizer.decode(out) if self.tokenizer is not None else ""
        )
        return GenerationResult(
            request_id=rid,
            prompt=req.prompt,
            input_tokens=req.tokens[: req.prompt_len],
            output_tokens=list(out),
            output_text=text,
            profile=req.profile,
            error=req.error,
        )

    def generate(
        self,
        prompts: Union[str, Sequence[Union[str, Sequence[int]]]],
        gen: Optional[GenerationConfig] = None,
        max_new_tokens: Optional[int] = None,
    ) -> List[GenerationResult]:
        """Blocking generate over a batch of prompts (reference
        ``FFModel::generate`` → ``generate_incr_decoding``)."""
        if isinstance(prompts, str):
            prompts = [prompts]
        gen = gen or GenerationConfig()
        if max_new_tokens is not None:
            gen = dataclasses.replace(gen, max_new_tokens=max_new_tokens)
        rids = [self.register_request(p, gen) for p in prompts]
        while any(
            self.requests[r].status not in TERMINAL_STATUSES for r in rids
        ):
            if not self.step():
                break
        # the tail of the pipeline may still hold finished requests'
        # dispatches (and their slots)
        self._flush_all()
        return [self.result(rid) for rid in rids]

    def generate_stream(
        self,
        prompts: Union[str, Sequence[Union[str, Sequence[int]]]],
        gen: Optional[GenerationConfig] = None,
        max_new_tokens: Optional[int] = None,
    ) -> Iterator[StreamEvent]:
        """Streaming generate: a :class:`StreamEvent` per token as soon as
        the host holds it (the pipeline delivers tokens up to
        ``dispatch_ahead`` steps behind the device; a SpecInfer round
        several at once), then one terminal event per request
        (``done=True``; ``error`` set if the request failed). Events of
        different requests interleave."""
        if isinstance(prompts, str):
            prompts = [prompts]
        gen = gen or GenerationConfig()
        if max_new_tokens is not None:
            gen = dataclasses.replace(gen, max_new_tokens=max_new_tokens)
        rids = [self.register_request(p, gen) for p in prompts]
        sent = {r: 0 for r in rids}
        finished: set = set()

        def drain_events():
            for r in rids:
                if r in finished:
                    continue
                req = self.requests[r]
                out = req.output_tokens
                while sent[r] < len(out):
                    tok = out[sent[r]]
                    sent[r] += 1
                    yield StreamEvent(r, int(tok))
                if req.status in TERMINAL_STATUSES:
                    finished.add(r)
                    yield StreamEvent(r, None, done=True, error=req.error)

        while len(finished) < len(rids):
            progressed = self.step()
            yield from drain_events()
            if not progressed and len(finished) < len(rids):
                self._flush_all()
                yield from drain_events()
                if len(finished) < len(rids):
                    break  # nothing schedulable remains
        self._flush_all()
        yield from drain_events()
