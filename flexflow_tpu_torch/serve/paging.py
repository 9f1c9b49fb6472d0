"""Paged KV cache — refcounted page allocator and per-slot page tables.

Host-only numpy, copied from ``flexflow_tpu/serve/paging.py``. K/V live
in a pool of fixed-size token pages; each request slot owns a page
table mapping logical pages (line // page_size) to physical pages, so
device memory is proportional to the pages actually allocated rather
than to every slot's worst case.

Physical page ``num_pages`` (one past the pool) is the shared scratch
page: unallocated table entries point at it, so padding tokens' K/V
writes and reads through unallocated entries land on a real buffer that
no mask exposes to a live row.

Pages are reference counted so that the prefix cache
(serve/prefix_cache.py) can keep a finished request's prompt pages alive
and splice them into later requests' tables: a physical page may be
referenced by several slot tables at once plus one reference held by the
radix tree. Tree-held pages with no slot reference are idle, and
``reclaim_cb`` frees them (evicts, or spills to the host tier) before an
allocation fails, so the cache never causes a preemption that a cold
pool would not.

The ``shard`` parameters keep the JAX allocator's signatures over one
shard: the context-parallel striping (``cp_shards``) comes with the
long-context slice.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import numpy as np


class PageAllocator:
    """Refcounted free-list allocator over a physical KV page pool.

    Invariants (tests/test_torch_paging.py and
    tests/test_torch_prefix_cache.py drive them against the JAX
    allocator):
      * ``refcount[p]`` equals the number of slot-table entries pointing
        at physical page ``p``, plus the external references (the prefix
        cache's radix tree) the caller reports to :meth:`check_no_leaks`;
      * a page is on the free list iff its refcount is zero;
      * ``ensure`` either covers the requested lines fully or changes
        nothing;
      * releasing never double-frees.
    """

    def __init__(self, num_pages: int, pages_per_slot: int, num_slots: int,
                 page_size: int):
        if num_pages < pages_per_slot:
            raise ValueError(
                f"page pool ({num_pages} pages) smaller than one request's "
                f"worst case ({pages_per_slot} pages) — no request could "
                "ever run to max_sequence_length"
            )
        self.num_pages = int(num_pages)
        self.page_size = int(page_size)
        self.pages_per_slot = int(pages_per_slot)
        self.scratch_page = int(num_pages)  # pool row num_pages is scratch
        # pop() takes from the end: keep ascending ids there
        self._free: List[int] = list(range(self.num_pages - 1, -1, -1))
        self.refcount = np.zeros((num_pages,), np.int32)
        self.table = np.full((num_slots, pages_per_slot), self.scratch_page,
                             np.int32)
        # bumped on every table mutation: the engine caches the device
        # copy of the table against it
        self.version = 0
        # last-resort page supplier: called with the shortfall (pages)
        # when the free list cannot cover a request; it frees idle cached
        # pages (the prefix cache's reclaim) and returns how many
        self.reclaim_cb: Optional[Callable[[int], int]] = None

    # ------------------------------------------------------------------
    # the one shard (the JAX allocator's context-parallel partition)

    @property
    def _free_by_shard(self) -> List[List[int]]:
        return [self._free]

    def shard_of_logical(self, logical: int) -> int:
        """Owning shard of a logical page: 0, the one shard."""
        return 0

    def shard_of_page(self, page: int) -> int:
        """Owning shard of a physical page: 0, the one shard."""
        return 0

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def used_pages(self) -> int:
        return self.num_pages - self.free_pages

    def pages_for(self, num_lines: int) -> int:
        """Logical pages needed to cover cache lines [0, num_lines)."""
        return -(-int(num_lines) // self.page_size)

    def slot_pages(self, slot: int) -> int:
        """Physical pages currently mapped by ``slot``'s table."""
        return int((self.table[slot] != self.scratch_page).sum())

    # ------------------------------------------------------------------
    # reference counting (shared pages: prefix-cache splicing)

    def acquire(self, page: int) -> None:
        """Add one reference to ``page`` (a slot table or the prefix cache
        now also points at it). The page must not be on the free list:
        either it already has references, or it was just taken with
        :meth:`take_free_page`."""
        assert 0 <= page < self.num_pages, f"acquire of page {page}"
        self.refcount[page] += 1

    def release_ref(self, page: int) -> bool:
        """Drop one reference; the page returns to the free list when its
        count drains to zero. Returns True iff the page was freed."""
        assert self.refcount[page] > 0, f"double free of physical page {page}"
        self.refcount[page] -= 1
        if self.refcount[page] == 0:
            self._free.append(int(page))
            return True
        return False

    def _reclaim(self, shortfall: int, shard: int = 0) -> None:
        """Ask the reclaim hook (prefix-cache LRU eviction or spill) to
        free at least ``shortfall`` pages. Best effort: the free list
        after the call is the only truth."""
        if shortfall > 0 and self.reclaim_cb is not None:
            self.reclaim_cb(shortfall)

    def take_free_page(self, shard: int = 0) -> Optional[int]:
        """Pop one page off the free list (reclaiming idle cached pages
        first if it is dry), its refcount still zero: the caller follows
        up with :meth:`acquire` or :meth:`splice` before control returns
        to the scheduler. None when nothing can be freed."""
        if not self._free:
            self._reclaim(1, shard)
        if not self._free:
            return None
        return self._free.pop()

    def claim_free_page(self, shard: int = 0) -> Optional[int]:
        """:meth:`take_free_page` plus the caller's own single reference
        (refcount 1): the prefix cache's adoption of a page the tree owns
        (host-tier re-admits, tree imports). None when nothing can be
        freed."""
        page = self.take_free_page(shard)
        if page is not None:
            self.refcount[page] = 1
        return page

    # ------------------------------------------------------------------

    def ensure(self, slot: int, num_lines: int) -> bool:
        """Grow ``slot``'s table to cover cache lines [0, num_lines).
        Already-covered prefixes are kept; growth pages get refcount 1.
        When the free list cannot cover the growth even after
        ``reclaim_cb``, returns False with nothing allocated (the caller
        preempts a victim and retries)."""
        need = min(self.pages_for(num_lines), self.pages_per_slot)
        row = self.table[slot]
        have = int((row[:need] != self.scratch_page).sum())
        if need - have <= 0:
            return True
        self._reclaim(need - have - len(self._free))
        if need - have > len(self._free):
            return False
        for j in range(have, need):
            assert row[j] == self.scratch_page, (
                f"slot {slot} page table has a hole before logical page {j}"
            )
            page = self._free.pop()
            assert self.refcount[page] == 0, f"free list held referenced page {page}"
            self.refcount[page] = 1
            row[j] = page
        self.version += 1
        return True

    def splice(self, slot: int, pages: Sequence[int]) -> None:
        """Map ``slot``'s leading logical pages to ``pages`` (a cached
        prompt prefix), one reference per entry. The slot's table must be
        empty: splicing is the first thing that happens to a slot's table
        at admission, before :meth:`ensure` grows the uncached suffix
        behind it."""
        row = self.table[slot]
        assert int((row != self.scratch_page).sum()) == 0, (
            f"splice into non-empty slot {slot}"
        )
        assert len(pages) <= self.pages_per_slot
        for j, page in enumerate(pages):
            self.acquire(int(page))
            row[j] = int(page)
        if len(pages):
            self.version += 1

    def cow(self, slot: int, logical: int) -> Optional[int]:
        """Copy-on-write bookkeeping for ``slot``'s logical page: allocate
        a private page, swap it into the table and drop this slot's
        reference on the shared one. Returns the new page (the caller
        copies the content, engine.copy_page), or None with the table
        unchanged when no page can be had even after reclaim."""
        row = self.table[slot]
        old = int(row[logical])
        assert old != self.scratch_page, "COW of an unmapped logical page"
        fresh = self.take_free_page(self.shard_of_logical(logical))
        if fresh is None:
            return None
        self.refcount[fresh] = 1
        row[logical] = fresh
        self.release_ref(old)
        self.version += 1
        return fresh

    def release(self, slot: int) -> int:
        """Drop ``slot``'s reference on every page its table maps and
        reset the row to scratch. Returns the number of pages freed;
        releasing a clean slot is a no-op."""
        row = self.table[slot]
        freed = 0
        changed = False
        for j in range(self.pages_per_slot):
            page = int(row[j])
            if page == self.scratch_page:
                continue
            freed += int(self.release_ref(page))
            row[j] = self.scratch_page
            changed = True
        if changed:
            self.version += 1
        return freed

    def check_no_leaks(self, external: Optional[Dict[int, int]] = None) -> None:
        """Full refcount audit: every page's refcount equals its table
        references plus ``external`` ones (the prefix cache's
        ``page_refs()``), and a page is free iff that count is zero."""
        counts = np.zeros((self.num_pages,), np.int64)
        for row in self.table:
            for page in row:
                if int(page) != self.scratch_page:
                    counts[int(page)] += 1
        for page, n in (external or {}).items():
            counts[int(page)] += int(n)
        free = set(self._free)
        assert len(free) == len(self._free), "free list holds duplicates"
        for page in range(self.num_pages):
            rc = int(self.refcount[page])
            assert rc == int(counts[page]), (
                f"page {page}: refcount {rc} != {int(counts[page])} live "
                "references (leak or double-free)"
            )
            assert (rc == 0) == (page in free), (
                f"page {page}: refcount {rc} but "
                f"{'on' if page in free else 'off'} the free list"
            )
