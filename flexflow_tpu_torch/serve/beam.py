"""Beam-search decoding (non-speculative).

Counterpart of ``flexflow_tpu/serve/beam.py`` (reference
``src/ops/beam_topk.cc`` and the beam bookkeeping of
``BeamSearchBatchConfig``), applied to plain generation: the W live
hypotheses occupy W request slots of the engine's KV cache, one decode
step advances all of them, and hypothesis reordering is a slot gather
(``engine.reorder``) instead of the reference's sub-request KV forking.

Scoring follows the standard (HF-compatible) rule: a hypothesis ending
in EOS banks with score ``logprob / len**length_penalty``; at the end
the best of banked + live wins, so greedy (W=1, no EOS) degenerates to
argmax decoding.
"""
from __future__ import annotations

from typing import Any, List, Optional, Sequence

import numpy as np

from .batch_config import BatchConfig, GenerationConfig, GenerationResult, ProfileInfo
from .engine import InferenceEngine
from .sampling import log_softmax


def _topk_np(x: np.ndarray, k: int):
    idx = np.argpartition(-x, k - 1)[:k]
    idx = idx[np.argsort(-x[idx])]
    return x[idx], idx


def _ensure_beam_pages(engine: InferenceEngine, num_slots: int, lines: int):
    """Paged KV: every beam slot needs its own pages covering ``lines``
    BEFORE the cache-content reorder copies hypotheses across slots
    (reorder moves content between table-resolved pages; equal-length
    beams guarantee equal allocations)."""
    if not getattr(engine, "paged", False):
        return
    for s in range(num_slots):
        if not engine.pager.ensure(s, lines):
            raise RuntimeError(
                f"KV page pool exhausted during beam search (slot {s}, "
                f"{lines} lines) — raise ServingConfig.max_cached_tokens"
            )


def _release_beam_pages(engine: InferenceEngine, num_slots: int):
    if not getattr(engine, "paged", False):
        return
    for s in range(num_slots):
        engine.pager.release(s)


def beam_generate(
    engine: InferenceEngine,
    prompt: Sequence[int],
    gen: GenerationConfig,
    eos_token_id: Optional[int] = None,
) -> List[int]:
    """Beam-search one request; returns the best hypothesis' generated
    tokens. Uses slots [0, W) of the engine's cache."""
    W = gen.num_beams
    R = engine.num_slots
    assert 1 <= W <= R, f"num_beams {W} exceeds {R} cache slots"
    sc = engine.serving
    scratch = engine.scratch_pos
    prompt = list(prompt)
    if not prompt:
        raise ValueError("empty prompt")
    max_total = sc.max_sequence_length
    if len(prompt) >= max_total:
        prompt = prompt[: max_total - 1]
    stops = set(gen.stop_token_ids)
    if eos_token_id is not None:
        stops.add(eos_token_id)

    # --- chunked prefill into slot 0 ---
    n = 0
    logits = None
    _ensure_beam_pages(engine, 1, len(prompt))
    while n < len(prompt):
        toks = prompt[n : n + sc.prefill_chunk]
        bc = BatchConfig.empty(R, sc.prefill_chunk, scratch)
        bc.tokens[0, : len(toks)] = toks
        bc.positions[0, : len(toks)] = np.arange(n, n + len(toks))
        bc.logits_idx[0] = len(toks) - 1
        bc.active[0] = True
        logits = engine.run(bc)
        n += len(toks)
    logp0 = log_softmax(logits).cpu().numpy()[0]  # (V,)

    banked: List[tuple] = []  # (normalized score, tokens)

    def norm(score: float, length: int) -> float:
        return score / (max(1, length) ** gen.length_penalty)

    def select(cand_scores, cand_tokens, parent_of):
        """HF beam rule over 2W sorted candidates: an EOS candidate
        banks only at rank < W; non-EOS fill the live set to W."""
        new_live, parents = [], []
        for rank, (v, t) in enumerate(zip(cand_scores, cand_tokens)):
            toks = parent_of(int(t), rank)
            if int(t) in stops:
                if rank < W:
                    banked.append((norm(float(v), len(toks)), toks))
            else:
                new_live.append((float(v), toks))
                parents.append(rank)
            if len(new_live) == W:
                break
        return new_live, parents

    # --- seed beams from the prefill logits; clone slot 0's cache ---
    try:
        vals, idxs = _topk_np(logp0, min(2 * W, logp0.size))
        seeds, _ = select(vals, idxs, lambda t, rank: [t])
        live = seeds
        _ensure_beam_pages(engine, W, len(prompt))
        src = np.arange(R, dtype=np.int32)
        src[:W] = 0
        engine.reorder(src)

        max_new = min(gen.max_new_tokens, max_total - len(prompt))
        for step in range(1, max_new):
            if not live:
                break
            if len(banked) >= W:
                # early_stopping=False rule: stop once no live hypothesis
                # can still beat the W-th banked score.
                banked.sort(key=lambda x: -x[0])
                del banked[W:]
                best_live = max(s for s, _ in live)
                if banked[-1][0] >= norm(best_live, len(live[0][1])):
                    break
            _ensure_beam_pages(engine, W, len(prompt) + step)
            bc = BatchConfig.empty(R, 1, scratch)
            for b, (score, toks) in enumerate(live):
                bc.tokens[b, 0] = toks[-1]
                bc.positions[b, 0] = len(prompt) + len(toks) - 1
                bc.active[b] = True
            logits = engine.run(bc)
            logp = log_softmax(logits).cpu().numpy()[: len(live)]
            V = logp.shape[-1]
            cand = np.asarray(
                [score for score, _ in live], np.float32
            )[:, None] + logp  # (w, V)
            vals, flat = _topk_np(cand.reshape(-1), min(2 * W, cand.size))
            beam_of = (flat // V).astype(int)
            live_prev = live
            live, parent_ranks = select(
                vals, flat % V,
                lambda t, rank: live_prev[beam_of[rank]][1] + [t],
            )
            parents = [int(beam_of[r]) for r in parent_ranks]
            src = np.arange(R, dtype=np.int32)
            src[: len(parents)] = parents
            engine.reorder(src)

        finals = banked + [(norm(s, len(t)), t) for s, t in live]
        finals.sort(key=lambda x: -x[0])
        return finals[0][1]
    finally:
        _release_beam_pages(engine, W)


def generate_with_beams(
    engine: InferenceEngine,
    prompts: Sequence[Any],
    gen: GenerationConfig,
    eos_token_id: Optional[int] = None,
    tokenizer: Any = None,
) -> List[GenerationResult]:
    """Beam-decode a list of prompts (sequential per request — the
    reference's beam path is also per-request, MAX_BEAM_WIDTH=3)."""
    import time

    results = []
    for i, p in enumerate(prompts):
        if isinstance(p, str):
            assert tokenizer is not None, "string prompt requires a tokenizer"
            toks, text = list(tokenizer.encode(p)), p
        else:
            toks, text = [int(t) for t in p], ""
        prof = ProfileInfo(start_time=time.perf_counter())
        out = beam_generate(engine, toks, gen, eos_token_id)
        prof.finish_time = time.perf_counter()
        prof.llm_decoding_steps = len(out)
        results.append(
            GenerationResult(
                request_id=i,
                prompt=text,
                input_tokens=toks,
                output_tokens=out,
                output_text=tokenizer.decode(out) if tokenizer else "",
                profile=prof,
            )
        )
    return results
