"""Automatic prefix caching: radix-tree KV reuse over the paged pool.

Host code, copied from ``flexflow_tpu/serve/prefix_cache.py``. Serving
traffic is dominated by shared prompt prefixes: system prompts, few-shot
templates, multi-turn conversations that resend the whole history.
Prefilling those tokens again recomputes K/V the pool already holds.
This module keeps a **token-block radix tree** mapping page-aligned
prompt blocks to live physical KV pages over serve/paging.py's
refcounted pool: on admission the RequestManager walks the tree with the
new prompt, splices every matched page into the request's page table,
and starts prefill at the first uncached token.

* **Blocks are page-sized** (one tree node per physical page) and keys
  are hash-chained, ``node.key = hash((parent.key, block_tokens))``, so
  a block's identity pins the whole prefix behind it. Lookup walks the
  tree by exact block tuples.
* **Pages are shared, never copied, on the hit path.** A matched page is
  spliced by reference (``PageAllocator.splice``); attention only reads
  the shared prefix.
* **Copy-on-write for partial tails.** When the match ends inside a page
  the request will append K/V lines into that page, so it gets a private
  copy first (``PageAllocator.cow`` and the engine's ``copy_page``, on
  the engine's stream: the copy reads the source after every write
  dispatched before it).
* **The cache never causes preemption.** Tree-held pages with no slot
  reference are idle; the allocator's ``reclaim_cb`` points at
  :meth:`PrefixCache.reclaim`, which frees LRU idle pages before any
  allocation fails.
* **Host tier.** With ``ServingConfig.host_cache_bytes`` set, reclaim
  SPILLS instead of dropping: ``engine.fetch_page`` clones the page on
  the engine's stream and starts a copy into pinned host memory on a
  side stream; the node stays in the tree, host-resident. The handle is
  harvested at the scheduler's flush (its blocking read), never in the
  middle of a step. A later match through a host-resident node
  re-admits it in :meth:`attach`: a fresh page, an upload on the
  engine's stream (ordered before the prefill that reads it), byte for
  byte. Past the byte budget, cold host leaves are dropped for real.
* **Insertion is bookkeeping.** At completion (``cache_policy``
  "complete": prompt and generated tokens) or when the prompt's last
  chunk is dispatched ("prefill"), the request's valid blocks are
  published; only lines written on the device count (``valid``
  excludes the final sampled token).

Cache hits change only the page table and the prefill start offset,
never the step: the kernels already take ragged rows at any offset.
"""
from __future__ import annotations

import itertools
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..logging_utils import get_logger
from .paging import PageAllocator


#: ``_Node.page`` sentinel for HOST-resident nodes (spilled to the
#: hierarchical host tier; ``host`` holds the page content).
HOST_PAGE = -1


class _Node:
    """One cached token block: ``tokens`` (≤ page_size; shorter only for
    tail blocks) backed by physical ``page`` whose first ``len(tokens)``
    lines hold those tokens' K/V. ``key`` is the hash chain identifying
    the whole prefix ending at this block. A spilled node has
    ``page == HOST_PAGE`` and carries the page's content in ``host``
    (a spill handle until harvested, host buffers afterwards)."""

    __slots__ = ("tokens", "page", "key", "parent", "children", "partials",
                 "last_used", "host")

    def __init__(self, tokens: Tuple[int, ...], page: int, key: int,
                 parent: "_Node"):
        self.tokens = tokens
        self.page = page
        self.key = key
        self.parent = parent
        self.children: Dict[Tuple[int, ...], _Node] = {}  # full blocks
        self.partials: Dict[Tuple[int, ...], _Node] = {}  # tail blocks
        self.last_used = 0
        self.host = None  # device/host page content when spilled

    @property
    def is_leaf(self) -> bool:
        return not self.children and not self.partials


def _host_values(handle) -> dict:
    """The host content of a spill handle: an engine handle
    (``engine.PageSpill``) waits for its copy and drops its device clone;
    a plain mapping of arrays (a test's stand-in mover) is kept as
    numpy."""
    if hasattr(handle, "host_values"):
        return handle.host_values()
    return {k: np.asarray(v) for k, v in handle.items()}


def _chain(parent_key: int, tokens: Tuple[int, ...]) -> int:
    return hash((parent_key, tokens))


def _common_prefix(a: Sequence[int], b: Sequence[int]) -> int:
    n = 0
    for x, y in zip(a, b):
        if x != y:
            break
        n += 1
    return n


class PrefixCache:
    """Radix tree of cached prompt blocks over a :class:`PageAllocator`.

    ``copy_page(src, dst)`` is the device-side page copy used by COW
    (engine.copy_page); None skips the data movement (allocator-level
    tests that only exercise the bookkeeping invariants). ``stats`` is
    a SchedulerStats or a zero-arg callable returning one — the
    RequestManager passes a callable so event counters follow when a
    bench swaps ``rm.stats`` for a fresh object mid-run.

    The hierarchical host tier activates when ``host_cache_bytes`` > 0
    and both page movers are supplied: ``fetch_page(page)`` starts a
    copy of one physical page's content to pinned host memory and returns
    a handle (engine.fetch_page), ``upload_page(page, values)`` writes
    a handle back into a pool row (engine.upload_page);
    ``page_bytes`` prices one spilled page against the byte budget.
    """

    def __init__(
        self,
        pager: PageAllocator,
        *,
        copy_page: Optional[Callable[[int, int], None]] = None,
        policy: str = "complete",
        stats=None,
        fetch_page: Optional[Callable[[int], dict]] = None,
        upload_page: Optional[Callable[[int, dict], None]] = None,
        host_cache_bytes: int = 0,
        page_bytes: int = 1,
    ):
        if policy not in ("complete", "prefill"):
            raise ValueError(
                f"unknown cache_policy {policy!r} "
                "(expected 'complete' or 'prefill')"
            )
        self.pager = pager
        self.page_size = pager.page_size
        self.copy_page = copy_page
        self.policy = policy
        self._stats_src = stats
        self.fetch_page = fetch_page
        self.upload_page = upload_page
        self.host_cache_bytes = int(host_cache_bytes or 0)
        self.page_bytes = max(1, int(page_bytes))
        self.host_bytes = 0          # current host-tier occupancy
        self._pending_spills: List[_Node] = []  # un-harvested handles
        self._pinned: set = set()    # nodes mid-attach: never spill/drop
        self._root = _Node((), pager.scratch_page, hash(()), parent=None)
        self._tick = itertools.count(1)
        self._log = get_logger("serve")

    @property
    def spill_enabled(self) -> bool:
        return (
            self.host_cache_bytes > 0
            and self.fetch_page is not None
            and self.upload_page is not None
        )

    @property
    def stats(self):
        return self._stats_src() if callable(self._stats_src) else self._stats_src

    # ------------------------------------------------------------------
    # accounting

    def _nodes(self) -> List[_Node]:
        out, stack = [], [self._root]
        while stack:
            n = stack.pop()
            for c in n.children.values():
                out.append(c)
                stack.append(c)
            for c in n.partials.values():
                out.append(c)
                stack.append(c)
        return out

    @property
    def cached_pages(self) -> int:
        return len(self._nodes())

    @property
    def host_pages(self) -> int:
        """Nodes currently resident in the host tier (spilled)."""
        return sum(1 for n in self._nodes() if n.host is not None)

    def page_refs(self) -> Dict[int, int]:
        """References the tree holds per physical page (each page lives
        in exactly one node; HOST-resident nodes hold no device page,
        so they contribute nothing) — feeds
        ``PageAllocator.check_no_leaks(external=...)``."""
        refs: Dict[int, int] = {}
        for n in self._nodes():
            if n.page != HOST_PAGE:
                refs[n.page] = refs.get(n.page, 0) + 1
        return refs

    # ------------------------------------------------------------------
    # lookup

    def _walk(
        self, tokens: Sequence[int], *, peek: bool = False,
        limit: Optional[int] = None,
    ) -> Tuple[List[_Node], int]:
        """Longest cached prefix of ``tokens`` as tree NODES (device- or
        host-resident) plus the matched token count. Capped at
        ``len(tokens) - 1`` — the last prompt token is always
        recomputed so its logit exists to sample the first output from
        — and additionally at ``limit`` when given (SpecInfer aligns
        the LLM's and every SSM pool's matches to their common minimum,
        serve/specinfer.py: the engines' caches must jump past the SAME
        prefix or verification would desync). ``peek`` leaves the LRU
        ticks untouched — a read-only probe (the cluster router scores
        every replica's tree but places on at most one; a scoring walk
        must not make a losing replica's blocks look recently used)."""
        cap = len(tokens) - 1
        if limit is not None:
            cap = min(cap, int(limit))
        limit = cap
        node, nodes, matched = self._root, [], 0
        tick = None if peek else next(self._tick)
        ps = self.page_size
        while matched < limit:
            rem = limit - matched
            if rem >= ps:
                child = node.children.get(tuple(tokens[matched:matched + ps]))
                if child is not None:
                    if tick is not None:
                        child.last_used = tick
                    nodes.append(child)
                    matched += ps
                    node = child
                    continue
            # no full-block descent: best partial overlap with any block
            # hanging off this node (a full block used partially, or a
            # cached tail block)
            want = tokens[matched:limit]
            best, best_len = None, 0
            for cand in itertools.chain(
                node.children.values(), node.partials.values()
            ):
                n = _common_prefix(cand.tokens, want)
                if n > best_len:
                    best, best_len = cand, n
            if best is not None:
                if tick is not None:
                    best.last_used = tick
                nodes.append(best)
                matched += best_len
            break
        return nodes, matched

    def match(self, tokens: Sequence[int]) -> Tuple[List[int], int]:
        """Longest cached prefix of ``tokens``: the physical pages
        covering it (``HOST_PAGE`` = -1 for spilled blocks whose
        content lives in the host tier — :meth:`attach` re-admits them
        before splicing) and the matched token count."""
        nodes, matched = self._walk(tokens)
        return [n.page for n in nodes], matched

    def match_len(self, tokens: Sequence[int],
                  limit: Optional[int] = None) -> int:
        """Read-only probe: how many leading tokens a fresh admission
        of ``tokens`` would find cached (device OR host tier), WITHOUT
        touching LRU state. The cluster router's prefix-aware placement
        score (serve/cluster/router.py) and SpecInfer's cross-pool
        match alignment (serve/specinfer.py)."""
        _, matched = self._walk(tokens, peek=True, limit=limit)
        return matched

    # ------------------------------------------------------------------
    # admission: splice + COW

    def _readmit(self, node: _Node, logical: int = 0) -> bool:
        """Bring one HOST-resident node back to the device: take a free
        page — from logical page ``logical``'s owning shard under
        context parallelism, so re-admitted pages land back on the
        striped layout — upload the spilled content into it (async
        host→device, ordered before any step that reads it) and hand
        the tree's reference over to the new page. Byte-exact — codes
        and scales land exactly as spilled, so generation over the
        re-admitted prefix is bitwise the warm path's. False when no
        page could be freed even by further spilling (the match
        truncates there)."""
        fresh = self.pager.claim_free_page(
            self.pager.shard_of_logical(logical)
        )
        if fresh is None:
            return False
        self.upload_page(fresh, node.host)
        if node in self._pending_spills:
            self._pending_spills.remove(node)
        node.page = fresh
        node.host = None
        self.host_bytes -= self.page_bytes
        st = self.stats
        if st is not None:
            st.readmits += 1
            st.host_hit_tokens += len(node.tokens)
            st.host_bytes = self.host_bytes
        self._log.debug(
            "prefix readmit: host page -> %d (%d tokens, chain %x)",
            fresh, len(node.tokens), node.key & 0xFFFFFFFF,
        )
        return True

    def attach(self, slot: int, tokens: Sequence[int],
               limit: Optional[int] = None) -> int:
        """Admission-time hit path: match ``tokens`` (never past
        ``limit`` when given — SpecInfer's cross-pool alignment),
        re-admit any HOST-resident blocks on the matched path (host
        tier → device, async upload), splice the matched pages into
        ``slot``'s (empty) table, COW the tail page when the match ends
        mid-page, and return the matched token count — the request's
        prefill start offset. Falls back block-by-block when a page
        cannot be had (truncates the match / drops the partial tail
        rather than fail the admission); returns 0 on a miss."""
        nodes, matched = self._walk(tokens, limit=limit)
        # Pin the whole matched path for the rest of the admission:
        # BOTH the re-admissions and the COW below may take free pages,
        # and a dry free list triggers reclaim — which must not spill,
        # evict or host-drop a block this admission is about to splice
        # (an evicted node's page would land on the free list while
        # still listed here, and splicing it would alias a page another
        # slot can be handed).
        self._pinned = set(map(id, nodes))
        try:
            for i, n in enumerate(nodes):
                if n.host is not None and not self._readmit(n, logical=i):
                    # nodes[:-1] are full blocks: i full blocks match
                    nodes = nodes[:i]
                    matched = i * self.page_size
                    break
            pages = [n.page for n in nodes]
            cow_src = None
            if matched % self.page_size:
                # request appends K/V into the tail page → private copy
                # (from the tail's owning shard — logical page index
                # len(pages)-1 — so the striping invariant holds)
                fresh = self.pager.take_free_page(
                    self.pager.shard_of_logical(len(pages) - 1)
                )
                if fresh is None:
                    matched -= matched % self.page_size
                    pages = pages[:-1]
                else:
                    cow_src = pages[-1]
                    pages[-1] = fresh
            if not matched:
                return 0
            self.pager.splice(slot, pages)
        finally:
            self._pinned = set()
        if cow_src is not None:
            if self.stats is not None:
                self.stats.prefix_cows += 1
            if self.copy_page is not None:
                self.copy_page(cow_src, pages[-1])
            self._log.debug(
                "prefix COW: slot %d page %d -> %d (tail at %d)",
                slot, cow_src, pages[-1], matched,
            )
        self._log.debug(
            "prefix hit: slot %d matched %d/%d tokens (%d pages)",
            slot, matched, len(tokens), len(pages),
        )
        return matched

    # ------------------------------------------------------------------
    # insertion

    def _adopt(self, node: _Node, blk: Tuple[int, ...], page: int,
               tick: int, full: bool) -> Optional[_Node]:
        """Insert/refresh one block under ``node``; returns the child to
        descend into (full blocks only). A physical page lives in at
        most ONE node: re-inserting the page this slot spliced from the
        tree refreshes in place, and a tail block the owner has since
        extended (same page, longer tokens) is re-keyed rather than
        duplicated."""
        bucket = node.children if full else node.partials
        hit = bucket.get(blk)
        if hit is not None:
            hit.last_used = tick
            return hit
        # same page already cached here under a shorter tail? The owner
        # extended the block in place (decode grew the page) — re-key.
        for key, cand in list(node.partials.items()):
            if cand.page == page:
                if _common_prefix(cand.tokens, blk) == len(cand.tokens):
                    del node.partials[key]
                    cand.tokens = blk
                    cand.key = _chain(node.key, blk)
                    cand.last_used = tick
                    bucket[blk] = cand
                    return cand
                return None  # diverged content on one page — stale; skip
        child = _Node(blk, page, _chain(node.key, blk), parent=node)
        child.last_used = tick
        self.pager.acquire(page)
        bucket[blk] = child
        if self.stats is not None:
            self.stats.prefix_inserts += 1
        return child

    def insert(self, slot: int, tokens: Sequence[int], valid: int) -> None:
        """Publish ``slot``'s pages for ``tokens[:valid]`` into the tree
        (``valid`` = cache lines actually written on device). Existing
        nodes are refreshed (LRU) and kept — the tree's page wins over
        the slot's duplicate, which simply drains with the slot. The
        pages keep serving this slot unchanged; the tree just holds an
        extra reference from here on."""
        ps = self.page_size
        valid = min(int(valid), len(tokens))
        row = self.pager.table[slot]
        node = self._root
        tick = next(self._tick)
        for d in range(-(-valid // ps)):
            lo = d * ps
            blk = tuple(int(t) for t in tokens[lo:min(lo + ps, valid)])
            if not blk:
                break
            page = int(row[d])
            if page == self.pager.scratch_page:
                break  # lines beyond the slot's materialized pages
            child = self._adopt(node, blk, page, tick, full=len(blk) == ps)
            if child is None or len(blk) < ps:
                break
            node = child
        self._log.debug(
            "prefix insert: slot %d published %d tokens (%d blocks, "
            "%d cached pages total)",
            slot, valid, -(-valid // ps), self.cached_pages,
        )

    # ------------------------------------------------------------------
    # eviction (the allocator's reclaim_cb)

    def _unlink(self, victim: _Node) -> None:
        parent = victim.parent
        bucket = (
            parent.children if victim.tokens in parent.children
            and parent.children[victim.tokens] is victim else parent.partials
        )
        del bucket[victim.tokens]

    def _evict_one(self, shard: Optional[int] = None) -> bool:
        """Free the least-recently-used idle leaf (refcount 1 — held
        only by the tree, no slot references, no children pinning it as
        interior) — on ``shard`` when given (context parallelism:
        reclaim for a striped allocation must free a page the SHORT
        shard owns). Returns False when nothing is evictable."""
        victim = None
        for n in self._nodes():
            if not n.is_leaf or n.host is not None or id(n) in self._pinned:
                continue
            if int(self.pager.refcount[n.page]) != 1:
                continue  # spliced into a live slot — not idle
            if shard is not None and (
                self.pager.shard_of_page(n.page) != shard
            ):
                continue  # another shard's page cannot cover this need
            if victim is None or n.last_used < victim.last_used:
                victim = n
        if victim is None:
            return False
        self._unlink(victim)
        self.pager.release_ref(victim.page)
        if self.stats is not None:
            self.stats.prefix_evictions += 1
        self._log.debug(
            "prefix evict: page %d (chain %x, lru %d)",
            victim.page, victim.key & 0xFFFFFFFF, victim.last_used,
        )
        return True

    def _spill_one(self, shard: Optional[int] = None) -> bool:
        """Spill the LRU idle (refcount-1) DEVICE-resident node to the
        host tier: async device→host content copy, page freed, node
        kept in the tree as host-resident. Unlike :meth:`_evict_one`
        this needs no leaf restriction — the node stays in place, so
        interior chains remain walkable. ``shard`` filters victims to
        one shard's pages (context parallelism) — which is also what
        keeps the HOT TAIL resident while cold MIDDLE pages spill: a
        long request's tail pages are the recently-used ones on every
        shard, so per-shard LRU never picks them first. Returns False
        when nothing is spillable."""
        victim = None
        for n in self._nodes():
            if n.host is not None or id(n) in self._pinned:
                continue
            if int(self.pager.refcount[n.page]) != 1:
                continue  # spliced into a live slot — not idle
            if shard is not None and (
                self.pager.shard_of_page(n.page) != shard
            ):
                continue  # reclaim must free the short shard's pages
            if victim is None or n.last_used < victim.last_used:
                victim = n
        if victim is None:
            return False
        page = victim.page
        victim.host = self.fetch_page(page)   # the copy to the host starts here
        self._pending_spills.append(victim)
        victim.page = HOST_PAGE
        self.pager.release_ref(page)
        self.host_bytes += self.page_bytes
        st = self.stats
        if st is not None:
            st.spills += 1
            st.host_bytes = self.host_bytes
        self._log.debug(
            "prefix spill: page %d -> host (%d tokens, chain %x, "
            "host %d/%d bytes)",
            page, len(victim.tokens), victim.key & 0xFFFFFFFF,
            self.host_bytes, self.host_cache_bytes,
        )
        # host-tier LRU: past the byte budget, cold host LEAVES drop
        # for real (interior host nodes are skipped — removing one
        # would orphan device-resident descendants; best-effort
        # overshoot until their subtrees peel)
        while self.host_bytes > self.host_cache_bytes:
            if not self._drop_host_one():
                break
        return True

    def _drop_host_one(self) -> bool:
        """Truly evict the LRU host-resident leaf (host-tier LRU).
        Returns False when no droppable host leaf exists."""
        victim = None
        for n in self._nodes():
            if n.host is None or not n.is_leaf or id(n) in self._pinned:
                continue
            if victim is None or n.last_used < victim.last_used:
                victim = n
        if victim is None:
            return False
        self._unlink(victim)
        if victim in self._pending_spills:
            self._pending_spills.remove(victim)
        self.host_bytes -= self.page_bytes
        st = self.stats
        if st is not None:
            st.prefix_evictions += 1
            st.host_bytes = self.host_bytes
        self._log.debug(
            "prefix host drop: %d tokens (chain %x, lru %d)",
            len(victim.tokens), victim.key & 0xFFFFFFFF, victim.last_used,
        )
        return True

    def harvest(self) -> None:
        """Turn pending spill handles (device clones with their copies to
        pinned host memory in flight) into host buffers, releasing the
        clones. Called from the RequestManager's flush, right after its
        blocking read, by which time the copies enqueued before it have
        landed: the step itself never waits on a transfer."""
        for node in self._pending_spills:
            if node.host is not None:
                node.host = _host_values(node.host)
        self._pending_spills.clear()

    def reclaim(self, shortfall: int, shard: Optional[int] = None) -> int:
        """Free ``shortfall`` pages: spill LRU idle cached pages to the
        host tier when it is enabled (content survives, the device page frees),
        else evict LRU idle leaves outright. Evicting a leaf can expose
        its parent as the next leaf, so deep idle chains peel
        bottom-up. Under context parallelism the allocator passes the
        SHORT shard — only that shard's pages are candidates (freeing
        another shard's pages cannot satisfy a striped allocation).
        Returns the number of pages freed."""
        freed = 0
        while freed < shortfall:
            ok = (
                self._spill_one(shard) if self.spill_enabled
                else self._evict_one(shard)
            )
            if not ok:
                break
            freed += 1
        return freed

    # ------------------------------------------------------------------
    # tree export/import (cluster warm-standby adoption, serve/cluster/)

    def export_tree(self, fetch_page=None) -> List[dict]:
        """Serialize the whole tree: preorder entries ``{"parent": <entry
        index, -1 = root>, "tokens": [...], "payload": {buffer: host
        values}}``, the block keys plus every page's content (codes and
        quantized scale rows), host-spilled nodes included. Device pages
        start their copies first and are then harvested together, off
        every step. ``fetch_page`` defaults to the spill tier's mover
        (pass the engine's when the tier is off). Nothing in serving
        calls it yet: the cluster's warm-standby adoption does, in the
        cluster slice."""
        fetch = fetch_page or self.fetch_page
        entries: List[dict] = []
        pending: List[Tuple[int, object]] = []  # (entry index, spill handle)
        stack = [
            (child, -1)
            for child in itertools.chain(
                reversed(list(self._root.partials.values())),
                reversed(list(self._root.children.values())),
            )
        ]
        while stack:
            node, parent_pos = stack.pop()
            pos = len(entries)
            entry = {
                "parent": parent_pos,
                "tokens": [int(t) for t in node.tokens],
                "payload": None,
            }
            if node.host is not None:
                entry["payload"] = dict(_host_values(node.host))
            elif fetch is not None:
                pending.append((pos, fetch(node.page)))
            entries.append(entry)
            for child in itertools.chain(
                reversed(list(node.partials.values())),
                reversed(list(node.children.values())),
            ):
                stack.append((child, pos))
        for pos, handle in pending:
            entries[pos]["payload"] = dict(_host_values(handle))
        self._log.debug(
            "prefix export: %d blocks (%d shipped from the host tier)",
            len(entries), len(entries) - len(pending),
        )
        return entries

    def import_tree(self, entries: Sequence[dict],
                    upload_page=None) -> int:
        """Adopt an exported tree: for each entry (parents first) take
        a page the tree owns (:meth:`PageAllocator.claim_free_page` —
        reclaim may evict/spill this cache's own cold blocks to make
        room), upload the shipped content and link the node under its
        parent. Blocks already present are kept (the standby's copy
        wins — it may be mid-splice); a block that cannot get a page is
        skipped WITH its subtree (children without K/V behind them
        would serve garbage), so adoption under pool pressure is
        partial, never corrupt. Returns the number of blocks adopted."""
        up = upload_page or self.upload_page
        if up is None:
            raise ValueError(
                "import_tree needs an upload_page mover (engine."
                "upload_page) — adopted blocks carry page CONTENT"
            )
        nodes_by_pos: Dict[int, Tuple[_Node, int]] = {
            -1: (self._root, 0)
        }
        tick = next(self._tick)
        adopted = 0
        for i, entry in enumerate(entries):
            parent_entry = nodes_by_pos.get(int(entry["parent"]))
            if parent_entry is None:
                continue  # parent was skipped — skip the subtree
            parent, depth = parent_entry
            blk = tuple(int(t) for t in entry["tokens"])
            if not blk or entry["payload"] is None:
                continue
            full = len(blk) == self.page_size
            bucket = parent.children if full else parent.partials
            existing = bucket.get(blk)
            if existing is not None:
                existing.last_used = tick
                nodes_by_pos[i] = (existing, depth + 1)
                continue
            page = self.pager.claim_free_page(
                self.pager.shard_of_logical(depth)
            )
            if page is None:
                continue  # pool full — partial adoption, subtree skipped
            up(page, entry["payload"])
            node = _Node(blk, page, _chain(parent.key, blk), parent=parent)
            node.last_used = tick
            bucket[blk] = node
            nodes_by_pos[i] = (node, depth + 1)
            adopted += 1
            if self.stats is not None:
                self.stats.prefix_inserts += 1
        self._log.debug(
            "prefix import: adopted %d/%d blocks", adopted, len(entries),
        )
        return adopted

    def clear(self) -> int:
        """Drop every cached page (tree refs released; pages with no
        slot references return to the free list; host-tier content is
        discarded). Returns the number of nodes released."""
        nodes = self._nodes()
        for n in nodes:
            if n.page != HOST_PAGE:
                self.pager.release_ref(n.page)
        self._root.children.clear()
        self._root.partials.clear()
        self._pending_spills.clear()
        self.host_bytes = 0
        return len(nodes)
