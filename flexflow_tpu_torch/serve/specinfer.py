"""SpecInfer — speculative inference with token-tree verification.

Counterpart of ``flexflow_tpu/serve/specinfer.py`` (reference
``src/runtime/request_manager.cc`` ``generate_spec_infer``, the
``BeamSearchBatchConfig``/``TreeVerifyBatchConfig`` of ``batch_config.h``
and the spec/tree attention kernels):

* A small speculative model (SSM) grows a **token tree** per request by
  beam expansion (``InferenceEngine.run_speculate``). Tree nodes live in
  the speculative slack lines of the SSM's own KV cache: siblings share a
  RoPE position ``prefix + depth`` but occupy distinct cache lines
  ``prefix + node``, so beams fork without copying any cache.
* The LLM **verifies the whole tree in one step** with an
  ancestors-or-self mask (the ported ``verify_attention`` or paged
  kernels at C = 1 + n·W·D, or — the speculation fold, on engines with
  ``fused_decode=("whole_step",)`` — one launch of the whole-step kernel,
  whose draft steps are launches of the same kernel).
* The longest accepted root path is **committed** by moving its K/V lines
  inside both caches (``InferenceEngine.commit``), so the SSM never
  prefills committed tokens again.

Greedy verification: the output is token-identical to incremental greedy
decoding. Speculation is adaptive (``SpecConfig.adaptive``: per-request
:class:`TreeController` on a bucketed W×D ladder; ``verify_skip`` lets a
cold draft ride the incremental decode step), composes with continuous
batching (prefill-phase steps are mirrored into every SSM,
:meth:`SpecInferManager._mirror_dispatch`), and can self-speculate
(``SpecConfig.draft="early_exit"``: the target's own first
``draft_layers`` blocks draft over the same params and cache), and
composes with prefix caching: a hit jumps the target and every SSM past
the same cached prefix (one radix tree a pool, the matched lengths
aligned across them, :meth:`SpecInferManager._cache_attach`); the
early-exit draft shares the target's pool and tree.

Tracing: a round emits ``spec_draft`` (its W×D bucket) and one
``spec_verify`` a request (drafted and accepted tokens) on the
manager's tracer (obs/). With ``inference_debugging`` the prefill phase
takes the sync batch, where every engine dumps its step.

Not ported yet: the distillation sink (``logit_sink``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from .batch_config import BatchConfig, GenerationConfig
from .engine import InferenceEngine
from .request_manager import Request, RequestManager, RequestStatus


def _greedy_host(logits: torch.Tensor) -> np.ndarray:
    """The argmax over the vocab, fetched to the host in one transfer."""
    return torch.argmax(logits, dim=-1).cpu().numpy()


def _param_count(model: Any, cfg: Any) -> float:
    """The dense parameter count the JAX package's serving cost model
    prices (``ModelGeometry.param_count``): the model's own count
    (``num_params``) without its norm weights, the LM head counted even
    where it is tied to the embedding."""
    D = cfg.hidden_size
    n = model.num_params(cfg) - (2 * cfg.num_hidden_layers + 1) * D
    return float(n + (cfg.vocab_size * D if cfg.tie_word_embeddings else 0))


class TokenTree:
    """Host-side speculative token tree (reference ``BeamTree``,
    batch_config.h:157-190 + RequestManager::traverse_beam_tree)."""

    def __init__(self, root_token: int):
        self.tokens: List[int] = [int(root_token)]
        self.parents: List[int] = [-1]
        self.depths: List[int] = [0]
        self.logprobs: List[float] = [0.0]
        # O(1) dedup + child lookup: at reference scale (64 requests x
        # 64-token trees, request_manager.h MAX_NUM_REQUESTS) the per-
        # insert linear scan was O(n^2) per speculation round
        self._index: dict = {}
        self._children: List[List[int]] = [[]]

    def __len__(self) -> int:
        return len(self.tokens)

    def add(self, token: int, parent: int, logprob: float) -> Tuple[int, bool]:
        """Add a child; duplicate (parent, token) pairs are merged (the
        analog of the reference's merge_dfs_trees dedup). Returns
        (node index, is_new)."""
        key = (int(parent), int(token))
        hit = self._index.get(key)
        if hit is not None:
            return hit, False
        self.tokens.append(int(token))
        self.parents.append(int(parent))
        self.depths.append(self.depths[parent] + 1)
        self.logprobs.append(float(logprob))
        idx = len(self.tokens) - 1
        self._index[key] = idx
        self._children.append([])
        self._children[parent].append(idx)
        return idx, True

    def append_raw(self, token: int, parent: int, depth: int,
                   logprob: float) -> int:
        """Append WITHOUT dedup — the device-side growth has a fixed
        (D, W) node layout where duplicate (parent, token) pairs are
        legitimate (dedup happens later in merge_trees). Maintains the
        child lists accept_greedy walks."""
        self.tokens.append(int(token))
        self.parents.append(int(parent))
        self.depths.append(int(depth))
        self.logprobs.append(float(logprob))
        idx = len(self.tokens) - 1
        self._index.setdefault((int(parent), int(token)), idx)
        self._children.append([])
        self._children[parent].append(idx)
        return idx

    def children(self, node: int) -> List[int]:
        return self._children[node]

    def ancestor_matrix(self) -> np.ndarray:
        """anc[i, j] = node j is an ancestor of i or i itself — the causal
        BitMask of the reference (batch_config.h:85-99)."""
        n = len(self.tokens)
        anc = np.zeros((n, n), bool)
        for i in range(n):
            j = i
            while j >= 0:
                anc[i, j] = True
                j = self.parents[j]
        return anc

    def accept_greedy(self, greedy_next: np.ndarray) -> Tuple[List[int], int]:
        """Walk from the root accepting children that match the LLM's
        greedy prediction (reference traverse_verify_tree). Returns
        (accepted node indices incl. root, bonus token)."""
        path = [0]
        cur = 0
        while True:
            target = int(greedy_next[cur])
            nxt = None
            for c in self.children(cur):
                if self.tokens[c] == target:
                    nxt = c
                    break
            if nxt is None:
                return path, target
            path.append(nxt)
            cur = nxt

    def used_width(self, path: List[int]) -> bool:
        """True when some accepted step took a child a WIDTH-1 tree
        would not have drafted — i.e. the accepted child was not its
        parent's highest-logprob candidate. The TreeController's
        width-utility signal: rounds where every accepted step is the
        draft's top pick would have committed identically from a
        narrow tree at a fraction of the drafted tokens."""
        for parent, node in zip(path, path[1:]):
            kids = self._children[parent]
            if len(kids) > 1 and node != max(
                kids, key=lambda c: self.logprobs[c]
            ):
                return True
        return False


def merge_trees(trees: List["TokenTree"]) -> "TokenTree":
    """Merge per-SSM token trees into one deduplicated tree — the
    reference's ``merge_dfs_trees`` (request_manager.h:178-189): shared
    (parent, token) branches collapse so the LLM verifies each distinct
    continuation once, keeping the max logprob of merged duplicates."""
    assert trees and all(
        t.tokens[0] == trees[0].tokens[0] for t in trees
    ), "trees must share the root (last committed) token"
    merged = TokenTree(trees[0].tokens[0])
    for tree in trees:
        remap = {0: 0}
        for i in range(1, len(tree)):
            parent = remap[tree.parents[i]]
            idx, is_new = merged.add(tree.tokens[i], parent, tree.logprobs[i])
            if not is_new:
                merged.logprobs[idx] = max(
                    merged.logprobs[idx], tree.logprobs[i]
                )
            remap[i] = idx
    return merged


def default_buckets(width: int, depth: int) -> Tuple[Tuple[int, int], ...]:
    """Deterministic W×D ladder from (1, 1) up to (width, depth): depth
    doubles first at width 1 (narrow deep chains are the cheap way to
    keep multi-token commits when the draft is good), then width steps
    up at full depth."""
    ladder: List[Tuple[int, int]] = [(1, 1)]
    d = 1
    while d < depth:
        d = min(depth, d * 2)
        ladder.append((1, d))
    w = 1
    while w < width:
        w = min(width, w * 2)
        ladder.append((w, depth))
    out: List[Tuple[int, int]] = []
    for b in ladder:
        if b not in out:
            out.append(b)
    return tuple(out)


@dataclasses.dataclass
class SpecConfig:
    """Speculation shape + adaptivity (reference MAX_BEAM_WIDTH=3 /
    MAX_BEAM_DEPTH=8, batch_config.h:157-161).

    ``beam_width``/``beam_depth`` bound the token tree; with
    ``adaptive=False`` (default) every round drafts that full shape.

    ``adaptive=True`` turns on acceptance-driven tree shaping: each
    request carries a :class:`TreeController` that EMA-tracks its
    accepted path length and moves it along ``bucket_ladder`` — shrink
    toward (1, 1) when acceptance is poor, grow back when paths accept
    at full depth. ``buckets`` overrides the default ladder (must stay
    within the configured bounds and end at the full shape — the cache
    slack region is sized for it).

    ``draft`` selects the draft source: ``"ssm"`` (external draft
    engines, the reference's SSMs) or ``"early_exit"`` — self-
    speculation from the target's own first ``draft_layers`` blocks
    (LayerSkip-style): a layer-sliced ``serve_step`` over the SAME
    params and KV cache drafts the tree, the full stack verifies it.
    Zero extra model, zero extra cache — the verify pass re-writes
    every tree line anyway, so the shallow draft's K/V never leaks
    into committed state.

    ``verify_skip`` (requires ``adaptive``) is the acceptance-weighted
    escape hatch below the ladder's floor: a request whose controller
    sits at the SMALLEST rung with a near-zero acceptance EMA (≤
    ``skip_threshold`` × depth) skips the speculate+verify dispatches
    entirely and rides the incremental decode path — a cold draft then
    costs ~zero, so speculation is strictly never worse than
    non-speculative continuous batching. Every ``reprobe_every``
    skipped rounds ONE cheap smallest-rung round runs to re-measure
    the draft; an accepting re-probe warms the EMA back over the
    threshold and the request resumes speculating.
    """

    beam_width: int = 2
    beam_depth: int = 4
    # acceptance-driven tree shaping (TreeController)
    adaptive: bool = False
    buckets: Optional[Tuple[Tuple[int, int], ...]] = None
    ema_alpha: float = 0.5
    grow_threshold: float = 0.8
    shrink_threshold: float = 0.3
    # width-utility gate: the EMA of "did some accepted step take a
    # non-top sibling" (TokenTree.used_width) must be at least this to
    # grow into — or stay on — a wider-same-depth rung; below it the
    # controller drops width a narrow tree would have matched for free
    width_threshold: float = 0.1
    # draft source: "ssm" | "early_exit"
    draft: str = "ssm"
    draft_layers: int = 0
    # acceptance-weighted verify-skip (cold drafts ride the
    # incremental decode path; periodic re-probe at the smallest rung)
    verify_skip: bool = False
    skip_threshold: float = 0.1
    reprobe_every: int = 8

    def __post_init__(self):
        if self.beam_width < 1 or self.beam_depth < 1:
            raise ValueError(
                f"beam_width/beam_depth must be >= 1 (got "
                f"{self.beam_width}x{self.beam_depth})"
            )
        if self.draft not in ("ssm", "early_exit"):
            raise ValueError(
                f"unknown draft {self.draft!r} (expected 'ssm' or "
                "'early_exit')"
            )
        if self.draft == "early_exit" and self.draft_layers < 1:
            raise ValueError(
                "draft='early_exit' needs draft_layers >= 1 — the layer "
                "count of the target's truncated draft stack"
            )
        if not 0.0 < self.ema_alpha <= 1.0:
            raise ValueError(
                f"ema_alpha must be in (0, 1] (got {self.ema_alpha})"
            )
        if not 0.0 <= self.shrink_threshold < self.grow_threshold <= 1.0:
            raise ValueError(
                "thresholds must satisfy 0 <= shrink < grow <= 1 (got "
                f"shrink={self.shrink_threshold}, "
                f"grow={self.grow_threshold})"
            )
        if not 0.0 <= self.width_threshold <= 1.0:
            raise ValueError(
                f"width_threshold must be in [0, 1] (got "
                f"{self.width_threshold})"
            )
        if self.verify_skip and not self.adaptive:
            raise ValueError(
                "verify_skip requires adaptive=True — the skip decision "
                "reads the TreeController's rung and acceptance EMA"
            )
        if not 0.0 <= self.skip_threshold < 1.0:
            raise ValueError(
                f"skip_threshold must be in [0, 1) (got "
                f"{self.skip_threshold})"
            )
        if self.skip_threshold > self.shrink_threshold:
            raise ValueError(
                "skip_threshold must not exceed shrink_threshold — the "
                "skip regime sits BELOW the ladder's floor (got "
                f"skip={self.skip_threshold} > "
                f"shrink={self.shrink_threshold})"
            )
        if self.reprobe_every < 1:
            raise ValueError(
                f"reprobe_every must be >= 1 (got {self.reprobe_every})"
            )
        if self.buckets is not None:
            ladder = tuple(
                (int(w), int(d)) for w, d in self.buckets
            )
            if not ladder:
                raise ValueError("buckets must be non-empty")
            if len(set(ladder)) != len(ladder):
                raise ValueError(f"duplicate buckets in {ladder}")
            for w, d in ladder:
                if not (1 <= w <= self.beam_width
                        and 1 <= d <= self.beam_depth):
                    raise ValueError(
                        f"bucket {w}x{d} outside the configured bounds "
                        f"{self.beam_width}x{self.beam_depth}"
                    )
            if ladder[-1] != (self.beam_width, self.beam_depth):
                raise ValueError(
                    "the bucket ladder must end at the configured "
                    f"{self.beam_width}x{self.beam_depth} — the cache "
                    "slack region is sized for the full tree"
                )
            if any(
                ladder[i][0] * ladder[i][1]
                >= ladder[i + 1][0] * ladder[i + 1][1]
                for i in range(len(ladder) - 1)
            ):
                raise ValueError(
                    f"buckets must grow strictly in tree tokens: {ladder}"
                )
            self.buckets = ladder

    @property
    def bucket_ladder(self) -> Tuple[Tuple[int, int], ...]:
        """The W×D rungs adaptive shaping moves along (smallest first;
        the single full shape when ``adaptive`` is off)."""
        if self.buckets is not None:
            return self.buckets
        if not self.adaptive:
            return ((self.beam_width, self.beam_depth),)
        return default_buckets(self.beam_width, self.beam_depth)

    @property
    def max_tree_tokens(self) -> int:
        return 1 + self.beam_width * self.beam_depth


class TreeController:
    """Per-request acceptance-driven tree shaping.

    Folds each verify round's accepted path length (drafted tokens the
    verifier accepted) into an EMA and moves the request one rung along
    the bucket ladder when the EMA leaves the hysteresis band: EMA ≤
    ``shrink_threshold``·D shrinks, EMA ≥ ``grow_threshold``·D grows —
    but only depth earns growth for free. WIDTH is gated on its own
    utility EMA (``TokenTree.used_width``: did an accepted step take a
    non-top sibling?): a request whose fully-accepted chains never
    touch a second branch will not grow into a wider rung, and when it
    is already sitting on one it steps DOWN to the narrow same-depth
    rung — the narrow tree would have committed the identical path at
    a fraction of the drafted tokens, which is exactly the drafted-
    accept-rate waste this controller exists to cut.

    On a resize the EMA is clamped INTO the new rung's band so one
    stale average cannot chain resizes — the trajectory is a pure,
    deterministic function of the acceptance sequence, and the
    acceptance sequence itself comes from the greedy tokens the verify
    round already fetched (no extra transfer from the device).

    Starts at the FULL tree (the fixed-shape baseline's behavior) and
    earns its way down: a cold request speculates exactly like the
    non-adaptive manager until its own acceptance says otherwise.
    """

    def __init__(self, spec: SpecConfig):
        self.spec = spec
        self.ladder = spec.bucket_ladder
        self.idx = len(self.ladder) - 1
        # mid-band prior: "good enough to stay" — not "perfect". A
        # perfect-acceptance prior would make a hard prompt pay several
        # full-size rounds just to walk the EMA down; mid-band keeps the
        # cold request at the baseline shape yet lets ONE bad round
        # start the descent.
        depth = float(self.ladder[self.idx][1])
        self.ema = 0.5 * (
            spec.shrink_threshold + spec.grow_threshold
        ) * depth
        self.width_ema = 1.0                        # width presumed useful
        self.resizes = 0
        # acceptance-weighted verify-skip (SpecConfig.verify_skip):
        # rounds skipped since the last spec/re-probe round, plus
        # lifetime counters the manager mirrors into SchedulerStats
        self._skip_streak = 0
        self.skipped_rounds = 0
        self.reprobes = 0

    @property
    def bucket(self) -> Tuple[int, int]:
        return self.ladder[self.idx]

    def next_action(self) -> str:
        """One verify-skip state-machine transition — call exactly once
        per scheduling round for a DECODING request. Returns ``"spec"``
        (run a normal speculate+verify round), ``"skip"`` (ride the
        incremental decode path: the draft is cold and a tree would be
        pure overhead) or ``"reprobe"`` (the skip cadence came due —
        run the cheap smallest-rung round so a draft that warmed back
        up can exit the skip regime through :meth:`observe`).

        The skip regime engages only BELOW the ladder's floor: the
        controller must sit on rung 0 — (1, 1) on the default ladder —
        with its acceptance EMA at or under ``skip_threshold`` × depth.
        Any other state resets the streak, so a request that resizes
        upward or warms its EMA flows straight back to "spec"."""
        spec = self.spec
        if not spec.verify_skip or self.idx != 0:
            self._skip_streak = 0
            return "spec"
        _, depth = self.bucket
        if self.ema > spec.skip_threshold * depth:
            self._skip_streak = 0
            return "spec"
        if self._skip_streak >= spec.reprobe_every:
            self._skip_streak = 0
            self.reprobes += 1
            return "reprobe"
        self._skip_streak += 1
        self.skipped_rounds += 1
        return "skip"

    def observe(self, accepted_len: int, used_width: bool = False) -> bool:
        """Record one round's accepted path length (and whether tree
        width contributed to it); returns True when the bucket
        changed."""
        a = self.spec.ema_alpha
        width, depth = self.bucket
        self.ema = (1.0 - a) * self.ema + a * float(accepted_len)
        self.width_ema = (1.0 - a) * self.width_ema + a * float(
            bool(used_width)
        )
        frac = self.ema / depth
        move = 0
        if frac <= self.spec.shrink_threshold and self.idx > 0:
            move = -1
        elif frac >= self.spec.grow_threshold:
            nxt = (
                self.ladder[self.idx + 1]
                if self.idx + 1 < len(self.ladder) else None
            )
            prv = self.ladder[self.idx - 1] if self.idx > 0 else None
            if nxt is not None and (
                nxt[1] > depth
                or self.width_ema >= self.spec.width_threshold
            ):
                move = 1
            elif (
                prv is not None and prv[1] == depth and prv[0] < width
                and self.width_ema < self.spec.width_threshold
            ):
                # fully-accepting chains that never used a sibling:
                # drop the width, keep the depth
                move = -1
        if move == 0:
            return False
        self.idx += move
        self.resizes += 1
        _, new_depth = self.bucket
        lo = self.spec.shrink_threshold * new_depth
        hi = self.spec.grow_threshold * new_depth
        self.ema = min(max(self.ema, lo), hi)
        return True


class SpecInferManager(RequestManager):
    """Request manager driving the SSM-speculate → LLM-verify loop.

    The LLM engine and SSM engines share slot assignment and serving
    limits; all caches always hold the same committed prefix per slot.
    With ``SpecConfig.draft="early_exit"`` there are no SSM engines at
    all — the LLM drafts off its own truncated layer stack.
    """

    # The target-only pipelined decode step would advance the LLM cache
    # without the SSMs'; pure-decode iterations run speculation rounds
    # instead, and prefill churn goes through the pipelined mixed step
    # with the SSM mirror (_mirror_dispatch).
    supports_fast_decode = False
    # run_sampled bypasses the _run_batch hook that keeps the SSM caches
    # in step with the LLM's: spec managers keep the step + host head.
    supports_fused_sampling = False

    def __init__(
        self,
        llm_engine: InferenceEngine,
        ssm_engines=None,  # engine | [engines] | None (early-exit draft)
        spec: Optional[SpecConfig] = None,
        tokenizer: Any = None,
        eos_token_id: Optional[int] = None,
        seed: int = 0,
        output_file: Optional[str] = None,
    ):
        if isinstance(ssm_engines, InferenceEngine):
            ssm_engines = [ssm_engines]
        self.ssms: List[InferenceEngine] = list(ssm_engines or [])
        self.spec = spec or SpecConfig()
        if self.spec.draft == "early_exit":
            if self.ssms:
                raise ValueError(
                    "draft='early_exit' self-speculates off the target's "
                    "own truncated layer stack — external SSM engines "
                    "cannot be combined with it (drop ssms or use "
                    "draft='ssm')"
                )
            L = llm_engine.cfg.num_hidden_layers
            if not 1 <= self.spec.draft_layers < L:
                raise ValueError(
                    f"draft_layers={self.spec.draft_layers} must be in "
                    f"[1, {L - 1}] for this target ({L} layers): the "
                    "draft must be a strict prefix of the verifier's "
                    "stack"
                )
        elif not self.ssms:
            raise ValueError(
                "SpecInferManager needs at least one SSM engine (or "
                "SpecConfig(draft='early_exit') to self-speculate)"
            )
        super().__init__(llm_engine, tokenizer, eos_token_id, seed, output_file)
        for ssm_engine in self.ssms:
            assert (
                ssm_engine.num_slots == llm_engine.num_slots
                and ssm_engine.serving.cache_len == llm_engine.serving.cache_len
            ), "LLM and SSM engines must share serving limits"
            assert llm_engine.cfg.vocab_size == ssm_engine.cfg.vocab_size, (
                "LLM/SSM vocab mismatch: draft tokens would be silently "
                "clipped at the verifier's embedding"
            )
        # A merged multi-SSM tree is at worst the concatenation of the
        # per-SSM trees (dedup only shrinks it) at the ladder's max shape.
        assert (
            self.max_merged_tokens <= llm_engine.serving.max_spec_tree_tokens
        ), "merged tree larger than the cache's speculative slack region"
        assert all(
            s.paged == llm_engine.paged for s in self.ssms
        ), "LLM and SSM engines must agree on kv_layout"
        # per-request adaptive tree controllers (SpecConfig.adaptive)
        self._controllers: Dict[int, TreeController] = {}
        # verify-skip SSM cache debt: cache lines ending at n_cached that
        # the skipped rounds advanced on the LLM only (a skipped round
        # costs one engine step, not one per engine). Repaid through
        # _sync_ssm_caches before anything next touches the mirrors.
        self._ssm_lag: Dict[int, int] = {}
        # the dense FLOPs one drafted token costs in the draft stack
        # (2 × params), stamped into ProfileInfo.draft_flops_per_token
        self.draft_flops_per_token = self._price_draft_flops()
        # prefix caching: one radix tree an SSM pool, kept in step with the
        # target's through the _cache_attach/_cache_insert hooks. The SSM
        # trees have no stats sink (the target pool's counters are the
        # telemetry) and no host tier (a miss on an SSM pool only shortens
        # the common match).
        self.ssm_prefix_caches: List[Any] = []
        if self.prefix_cache is not None:
            from .prefix_cache import PrefixCache

            for ssm_engine in self.ssms:
                pc = PrefixCache(ssm_engine.pager, copy_page=ssm_engine.copy_page,
                                 policy=llm_engine.serving.cache_policy)
                ssm_engine.pager.reclaim_cb = pc.reclaim
                self.ssm_prefix_caches.append(pc)
        # the whole-step speculation fold: each whole-step engine's gate
        # prices the chunk widths it will see (the draft widths on the
        # drafting engine, the verify widths on the target); a refusal
        # sends that engine's SpecInfer steps to the per-layer path
        ladder = self.spec.bucket_ladder
        drafts = {W for W, _ in ladder}
        verifies = {1 + self.n_drafts * W * D for W, D in ladder}
        if self.spec.draft == "early_exit":
            llm_engine.whole_step_spec_gate(drafts | verifies)
        else:
            llm_engine.whole_step_spec_gate(verifies)
            for ssm_engine in self.ssms:
                ssm_engine.whole_step_spec_gate(drafts)

    def _price_draft_flops(self) -> float:
        """Dense FLOPs one drafted token costs in the draft stack (2 ×
        params), summed over every SSM; the early-exit draft prices the
        target's first ``draft_layers`` blocks."""
        if self.spec.draft == "early_exit":
            cfg = dataclasses.replace(
                self.engine.cfg, num_hidden_layers=self.spec.draft_layers)
            return 2.0 * _param_count(self.engine.model, cfg)
        return sum(2.0 * _param_count(s.model, s.cfg) for s in self.ssms)

    @property
    def n_drafts(self) -> int:
        """Independent draft trees per round: the SSM count, or one for
        the early-exit self-draft."""
        return max(1, len(self.ssms))

    @property
    def max_merged_tokens(self) -> int:
        return 1 + self.n_drafts * (
            self.spec.beam_width * self.spec.beam_depth
        )

    @property
    def ssm(self) -> InferenceEngine:
        """Primary SSM (kept for single-SSM callers/tests)."""
        return self.ssms[0]

    def _engines(self):
        """Page allocation and reclaim happen on the LLM and every SSM in
        lockstep (shared slots and serving limits; pools sized per
        engine)."""
        return [self.engine, *self.ssms]

    def _prefix_caches(self):
        return super()._prefix_caches() + self.ssm_prefix_caches

    def _cache_attach(self, slot: int, tokens) -> int:
        """Attach the same matched prefix on the target's pool and every
        SSM pool, or none at all: the engines must jump past the same
        prefix, or an SSM would draft over lines it never computed. The
        common match is the least of the pools' probes; if a pool then
        fails to materialize it (no page to copy a tail into), every pool
        rolls back to a cold admission."""
        caches = [self.prefix_cache, *self.ssm_prefix_caches]
        m = min(pc.match_len(tokens) for pc in caches)
        if m <= 0:
            return 0
        got = self.prefix_cache.attach(slot, tokens, limit=m)
        ok = got > 0
        for pc in self.ssm_prefix_caches:
            if not ok:
                break
            ok = pc.attach(slot, tokens, limit=got) == got
        if not ok:
            self._release_pages(slot)
            return 0
        return got

    # ------------------------------------------------------------------
    # adaptive tree shaping

    def _ctrl(self, req: Request) -> TreeController:
        ctrl = self._controllers.get(req.request_id)
        if ctrl is None:
            ctrl = self._controllers[req.request_id] = TreeController(
                self.spec
            )
        return ctrl

    def _bucket(self, req: Request) -> Tuple[int, int]:
        """This request's current tree shape."""
        if not self.spec.adaptive:
            return (self.spec.beam_width, self.spec.beam_depth)
        return self._ctrl(req).bucket

    def _tree_tokens(self, req: Request) -> int:
        W, D = self._bucket(req)
        return 1 + self.n_drafts * W * D

    def _spec_lines(self, req: Request) -> int:
        """Cache lines a speculate→verify→commit round touches for this
        request: the committed prefix plus its current tree's slack lines
        (node i writes line prefix + i)."""
        return req.n_cached + self._tree_tokens(req) + 1

    # ------------------------------------------------------------------
    # batches

    def _tree_chunk_batch(
        self,
        engine: InferenceEngine,
        reqs: List[Request],
        trees: Dict[int, TokenTree],
        node_lists: Dict[int, List[int]],
        chunk: int,
    ) -> BatchConfig:
        """Batch feeding, per request, the tree nodes in ``node_lists``.
        RoPE position = prefix + depth; cache line = prefix + node index;
        mask = committed prefix + ancestors-or-self. ``spec_nodes``
        records the per-slot node count (ragged under adaptive
        shaping)."""
        S1 = engine.serving.cache_len + 1
        R = engine.num_slots
        bc = BatchConfig.empty(R, chunk, engine.scratch_pos)
        bc.cache_positions = np.full((R, chunk), engine.scratch_pos, np.int32)
        bc.mask = np.zeros((R, chunk, S1), bool)
        bc.spec_nodes = np.zeros((R,), np.int32)
        for req in reqs:
            tree = trees[req.request_id]
            nodes = node_lists[req.request_id]
            anc = tree.ancestor_matrix()
            prefix = req.n_cached
            for c, node in enumerate(nodes):
                bc.tokens[req.slot, c] = tree.tokens[node]
                bc.positions[req.slot, c] = prefix + tree.depths[node]
                bc.cache_positions[req.slot, c] = prefix + node
                bc.mask[req.slot, c, :prefix] = True
                bc.mask[req.slot, c, prefix : prefix + len(tree)] = anc[node]
            bc.spec_nodes[req.slot] = len(nodes)
            bc.active[req.slot] = True
        return bc

    # ------------------------------------------------------------------
    # the SpecInfer round

    def _grow_trees_one_ssm(
        self, ssm: InferenceEngine, reqs: List[Request], W: int, D: int,
        num_layers: Optional[int] = None,
    ) -> Dict[int, TokenTree]:
        """One draft's beam expansion: the whole depth × top-W expansion
        runs on the device (``engine.run_speculate``) and the host
        fetches the finished tree in one transfer. ``num_layers`` routes
        the expansion through the layer-sliced early-exit step (``ssm``
        is then the LLM engine itself).

        Trees are built without (parent, token) dedup so node index i
        stays the cache slack line prefix + i the device wrote."""
        R = self.engine.num_slots
        root = np.zeros((R,), np.int32)
        prefix = np.full((R,), self.engine.scratch_pos, np.int32)
        active = np.zeros((R,), bool)
        for req in reqs:
            root[req.slot] = req.tokens[-1]
            prefix[req.slot] = req.n_cached
            active[req.slot] = True
        toks, parents, logps = ssm.run_speculate(root, prefix, active, W, D,
                                                 num_layers=num_layers)
        # one transfer for the three (D, R, W) arrays: token ids and
        # parent indices are exact in float32
        tree_host = torch.stack([toks.to(torch.float32), parents.to(torch.float32),
                                 logps]).cpu().numpy()
        toks = tree_host[0].astype(np.int64)
        parents = tree_host[1].astype(np.int64)
        logps = tree_host[2]

        trees: Dict[int, TokenTree] = {}
        for req in reqs:
            s = req.slot
            tree = TokenTree(int(root[s]))
            for d in range(D):
                for w in range(W):
                    tree.append_raw(
                        int(toks[d, s, w]),
                        0 if d == 0 else 1 + (d - 1) * W + int(parents[d, s, w]),
                        d + 1,
                        float(logps[d, s, w]),
                    )
            trees[req.request_id] = tree
            req.profile.ssm_decoding_steps += D
        return trees

    def _grow_trees(
        self, reqs: List[Request], W: int, D: int
    ) -> Dict[int, TokenTree]:
        """All drafts speculate independently at this round's W×D; their
        trees merge with dedup (reference ``merge_dfs_trees``). The
        early-exit draft is the LLM engine itself through the
        layer-sliced step — one tree, nothing to merge."""
        tr = self.tracer
        if tr.enabled:
            tr.event("spec_draft", width=W, depth=D, rows=len(reqs), draft=self.spec.draft)
        if self.spec.draft == "early_exit":
            return self._grow_trees_one_ssm(
                self.engine, reqs, W, D,
                num_layers=self.spec.draft_layers,
            )
        per_ssm = [
            self._grow_trees_one_ssm(ssm, reqs, W, D) for ssm in self.ssms
        ]
        if len(per_ssm) == 1:
            return per_ssm[0]
        return {
            r.request_id: merge_trees(
                [trees[r.request_id] for trees in per_ssm]
            )
            for r in reqs
        }

    def _verify_and_commit(
        self, reqs: List[Request], trees: Dict[int, TokenTree],
        W: int, D: int,
    ):
        """LLM tree-verify step + greedy acceptance + KV commit on all
        caches (reference prepare_next_batch_verify + tree attention +
        commit_tokens). The verify chunk is the round's bucket size; the
        commit src/dst keep the ladder-max path shape."""
        C = 1 + self.n_drafts * (W * D)
        node_lists = {
            r.request_id: list(range(len(trees[r.request_id]))) for r in reqs
        }
        bc = self._tree_chunk_batch(self.engine, reqs, trees, node_lists, C)
        logits = self.engine.run(bc, all_logits=True)  # (R, C, V)
        # the host acceptance walk needs the greedy tokens: one transfer
        greedy = _greedy_host(logits)  # (R, C)
        accepted: Dict[int, Tuple[int, List[int]]] = {}  # rid -> (slot, path tokens)

        R = self.engine.num_slots
        K = self.spec.beam_depth + 1  # ladder-max acceptable path
        scratch = self.engine.scratch_pos
        src = np.full((R, K), scratch, np.int32)
        dst = np.full((R, K), scratch, np.int32)
        for req in reqs:
            tree = trees[req.request_id]
            path, bonus = tree.accept_greedy(greedy[req.slot])
            prefix = req.n_cached
            for k, node in enumerate(path):
                src[req.slot, k] = prefix + node
                dst[req.slot, k] = prefix + k
            drafted = len(tree) - 1
            n_accepted = len(path) - 1
            req.profile.speculated_tokens += drafted
            req.profile.accepted_tokens += n_accepted
            req.profile.llm_decoding_steps += 1
            req.profile.spec_rounds += 1
            self.stats.spec_rounds += 1
            self.stats.spec_drafted += drafted
            self.stats.spec_accepted += n_accepted
            tr = self.tracer
            if tr.enabled:
                tr.event("spec_verify", trace_id=self.trace_of(req.request_id),
                         rid=req.request_id, drafted=drafted, accepted=n_accepted)
            if self.spec.adaptive:
                # the controller reads acceptance from the greedy walk
                # already fetched — no extra transfer
                ctrl = self._ctrl(req)
                if ctrl.observe(n_accepted, tree.used_width(path)):
                    self.stats.spec_resizes += 1
                    self._log.debug(
                        "spec resize: request %d %dx%d -> %dx%d "
                        "(ema %.2f, accepted %d)",
                        req.request_id, W, D, ctrl.bucket[0],
                        ctrl.bucket[1], ctrl.ema, n_accepted,
                    )
                req.profile.tree_resizes = ctrl.resizes
                req.profile.tree_width, req.profile.tree_depth = ctrl.bucket
            else:
                req.profile.tree_width, req.profile.tree_depth = W, D
            req.profile.draft_flops_per_token = self.draft_flops_per_token
            # path nodes beyond the root are newly committed outputs; the
            # bonus token is the LLM's own next sample
            accepted[req.request_id] = (req.slot, [tree.tokens[n] for n in path], bonus)
            req.n_cached += len(path)
        # commit before the tokens land: a request that completes here
        # publishes its pages to the prefix cache and releases its slot,
        # so the accepted lines must already sit at their committed
        # positions (a commit through a released slot's table would write
        # the scratch page and leave the published lines holding tree
        # nodes)
        self.engine.commit(src, dst)
        if self.spec.draft == "early_exit":
            # self-draft: one cache — the commit above already moved the
            # verifier's (and therefore the draft's) lines
            pass
        elif len(self.ssms) == 1:
            # single SSM: the merged tree is its own tree, so the
            # accepted nodes sit at the same slack lines
            self.ssms[0].commit(src, dst)
        else:
            # several SSMs: each SSM's slack lines follow its own
            # pre-merge tree indices, so feed the accepted tokens through
            # every SSM at their committed positions instead
            self._refeed_accepted(reqs, accepted)
        for req in reqs:
            _, toks, bonus = accepted[req.request_id]
            for t in toks[1:] + [bonus]:
                if req.status is RequestStatus.DECODING:
                    self._append_token(req, t)
            if req.status is not RequestStatus.DECODING:
                self._controllers.pop(req.request_id, None)

    def _refeed_accepted(self, reqs, accepted):
        """Write the accepted tokens' K/V into every SSM cache by running
        them as ordinary causal inputs at committed positions."""
        K = self.spec.beam_depth + 1
        R = self.engine.num_slots
        scratch = self.engine.scratch_pos
        bc = BatchConfig.empty(R, K, scratch)
        for req in reqs:
            slot, toks, _ = accepted[req.request_id]
            start = req.n_cached - len(toks)  # n_cached already advanced
            bc.tokens[slot, : len(toks)] = toks
            bc.positions[slot, : len(toks)] = np.arange(
                start, start + len(toks)
            )
            bc.logits_idx[slot] = len(toks) - 1
            bc.active[slot] = True
        for ssm in self.ssms:
            ssm.run(bc)

    # ------------------------------------------------------------------
    # scheduling

    def _preempt(self, req: Request):
        # recompute preemption prefills prompt + generated tokens through
        # every engine on re-admission: the skip debt is void
        self._ssm_lag.pop(req.request_id, None)
        super()._preempt(req)

    def register_request(self, prompt, gen: Optional[GenerationConfig] = None):
        gen = gen or GenerationConfig()
        if gen.do_sample:
            # greedy tree verification cannot honour sampling configs
            raise ValueError(
                "SpecInferManager is greedy-only; use RequestManager for "
                "sampling requests"
            )
        return super().register_request(prompt, gen)

    def _run_batch(self, bc):
        logits = self.engine.run(bc)
        for ssm in self.ssms:
            ssm.run(bc)  # same tokens into every SSM cache
        return logits

    def _decode_skipped(self, reqs: List[Request]) -> None:
        """The verify-skip arm (SpecConfig.verify_skip): one C = 1
        incremental decode step for every request whose draft is cold —
        the decode-row batch and greedy argmax of the sync scheduler, so
        the skip arm is the incremental decode path. Only the target
        engine steps; the SSM mirrors fall behind, and the per-request
        debt in ``_ssm_lag`` is repaid by :meth:`_sync_ssm_caches` before
        anything next feeds them."""
        R = self.engine.num_slots
        bc = BatchConfig.empty(R, 1, self.engine.scratch_pos)
        bc.qlens = np.zeros((R,), np.int32)
        for req in reqs:
            bc.tokens[req.slot, 0] = req.tokens[-1]
            bc.positions[req.slot, 0] = len(req.tokens) - 1
            bc.active[req.slot] = True
            bc.logits_idx[req.slot] = 0
            bc.qlens[req.slot] = 1
        sampled = _greedy_host(self.engine.run(bc))  # (R,); the LLM alone
        for req in reqs:
            req.n_cached += 1
            req.n_sched = req.n_cached
            req.profile.llm_decoding_steps += 1
            req.profile.draft_flops_per_token = self.draft_flops_per_token
            self.stats.verify_skipped_rounds += 1
            if self.ssms:
                self._ssm_lag[req.request_id] = (
                    self._ssm_lag.get(req.request_id, 0) + 1
                )
            if self.prefix_cache is not None and self._completes(req, int(sampled[req.slot])):
                # completion publishes this slot's blocks on every pool:
                # the SSM pools' lines must hold real K/V, not the skipped
                # rounds' holes
                self._sync_ssm_caches([req])
            self._append_token(req, int(sampled[req.slot]))
            if req.status is not RequestStatus.DECODING:
                self._controllers.pop(req.request_id, None)
                self._ssm_lag.pop(req.request_id, None)

    def _sync_ssm_caches(self, reqs: List[Request]) -> None:
        """Repay the verify-skip SSM cache debt: replay the cache lines
        [n_cached - lag, n_cached) — tokens the skipped rounds ran through
        the LLM only — as ordinary causal inputs through every SSM,
        chunked at ``prefill_chunk``. Their pages were reserved in
        lockstep all along (_ensure_pages covers every engine)."""
        if not self.ssms:
            return
        reqs = [r for r in reqs if self._ssm_lag.get(r.request_id)]
        if not reqs:
            return
        C = self.engine.serving.prefill_chunk
        R = self.engine.num_slots
        while reqs:
            bc = BatchConfig.empty(R, C, self.engine.scratch_pos)
            bc.qlens = np.zeros((R,), np.int32)
            bc.prefill_offsets = np.zeros((R,), np.int32)
            rest: List[Request] = []
            for req in reqs:
                lag = self._ssm_lag[req.request_id]
                off = req.n_cached - lag
                toks = req.tokens[off : off + min(lag, C)]
                n = len(toks)
                bc.tokens[req.slot, :n] = toks
                bc.positions[req.slot, :n] = np.arange(off, off + n)
                bc.active[req.slot] = True
                bc.logits_idx[req.slot] = n - 1
                bc.qlens[req.slot] = n
                bc.prefill_offsets[req.slot] = off
                if lag > n:
                    self._ssm_lag[req.request_id] = lag - n
                    rest.append(req)
                else:
                    self._ssm_lag.pop(req.request_id, None)
            for ssm in self.ssms:
                ssm.run(bc)
            reqs = rest

    def _mirror_dispatch(self, last, host_tokens, use_last, positions, logits_idx,
                         generator, greedy, temperature, topp, topk) -> None:
        """Continuous-batching composition: dispatch the same pipelined
        step into every SSM. The LLM's previous sampled tokens (``last``)
        feed the ``use_last`` rows of both, so each SSM writes K/V for
        exactly the token sequence the LLM is decoding. The SSM runs no
        head (``sample=False``): its output is not read, and the LLM's
        generator takes no draw from it. The early-exit self-draft has
        no SSMs (one cache): nothing to mirror."""
        for ssm in self.ssms:
            ssm.run_mixed(last, host_tokens, use_last, positions, logits_idx,
                          None, greedy, temperature, topp, topk, sample=False)

    def step(self) -> bool:
        """One SpecInfer scheduling step. While anyone is prefilling, the
        mixed batch (prefill chunks + decode tokens) runs through every
        engine — pipelined with the SSM mirror under
        ``continuous_batching``, or the blocking sync batch otherwise —
        so decoding slots keep making one-token progress with the caches
        in sync. Once nobody is prefilling, the pipeline is drained and
        one speculate→verify→commit round runs per W×D bucket present
        among the decoding requests."""
        self._admit_pending()
        sc = self.engine.serving
        if self._active(RequestStatus.PREFILLING):
            # the prefill phase mirrors decode rows into every SSM:
            # skip-lagged requests replay their missed lines first
            self._sync_ssm_caches(self._active(RequestStatus.DECODING))
            # triage dumps a step in engine.run, which the pipelined mixed
            # step does not go through: debugging takes the sync batch
            if sc.continuous_batching and not sc.inference_debugging:
                self._reclaim_slots_for_admission()
                self._reserve_active_pages(
                    lambda r: self._lines_needed(r, sc.mixed_chunk)
                )
                return self._step_pipelined(mixed=True)
            return self._step_sync()
        # speculation rounds read host-side roots (req.tokens[-1]): drain
        # whatever the pipelined prefill phase left in flight
        self._flush_all()
        decoding = self._active(RequestStatus.DECODING)
        # verify-skip: decide each request's round before reserving pages
        # (a skipped row prices one decode line, not a tree's slack)
        actions: Dict[int, str] = {}
        if self.spec.verify_skip:
            for req in decoding:
                action = self._ctrl(req).next_action()
                actions[req.request_id] = action
                if action == "reprobe":
                    self.stats.spec_reprobes += 1
        # paged KV: a spec round writes the whole tree's slack lines —
        # reserve prefix + tree pages on the LLM and every SSM
        self._reserve_active_pages(
            lambda r: (
                self._lines_needed(r)
                if actions.get(r.request_id) == "skip"
                else self._spec_lines(r)
            )
        )
        decoding = [r for r in decoding if r.status is RequestStatus.DECODING]
        if not decoding:
            return bool(self.pending)
        skipped = [
            r for r in decoding if actions.get(r.request_id) == "skip"
        ]
        if skipped:
            self._decode_skipped(skipped)
        groups: Dict[Tuple[int, int], List[Request]] = {}
        for req in decoding:
            if actions.get(req.request_id) == "skip":
                continue
            groups.setdefault(self._bucket(req), []).append(req)
        for bucket in sorted(groups):
            reqs = [
                r for r in groups[bucket]
                if r.status is RequestStatus.DECODING
            ]
            if not reqs:
                continue  # an earlier bucket's round completed them
            # a re-probing request's SSM mirrors missed every skipped
            # round: replay those lines before the draft reads them
            self._sync_ssm_caches(reqs)
            trees = self._grow_trees(reqs, *bucket)
            self._verify_and_commit(reqs, trees, *bucket)
        self._step_counter += 1
        self._maybe_log_stats()
        return True
