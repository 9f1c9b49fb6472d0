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

The prefix cache's page sharing (``acquire``, ``splice``, the reclaim
hook, external references in the audit) and the context-parallel
striping (``cp_shards``) come with the slices that port those features.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np


class PageAllocator:
    """Refcounted free-list allocator over a physical KV page pool.

    Invariants (tests/test_torch_paging.py drives them against the JAX
    allocator):
      * ``refcount[p]`` equals the number of slot-table entries pointing
        at physical page ``p``;
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

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def used_pages(self) -> int:
        return self.num_pages - self.free_pages

    def pages_for(self, num_lines: int) -> int:
        """Logical pages needed to cover cache lines [0, num_lines)."""
        return -(-int(num_lines) // self.page_size)

    def release_ref(self, page: int) -> bool:
        """Drop one reference; the page returns to the free list when its
        count drains to zero. Returns True iff the page was freed."""
        assert self.refcount[page] > 0, f"double free of physical page {page}"
        self.refcount[page] -= 1
        if self.refcount[page] == 0:
            self._free.append(int(page))
            return True
        return False

    def ensure(self, slot: int, num_lines: int) -> bool:
        """Grow ``slot``'s table to cover cache lines [0, num_lines).
        Already-covered prefixes are kept; growth pages get refcount 1.
        Returns False with nothing allocated when the free list cannot
        cover the growth (the caller preempts a victim and retries)."""
        need = min(self.pages_for(num_lines), self.pages_per_slot)
        row = self.table[slot]
        have = int((row[:need] != self.scratch_page).sum())
        if need - have <= 0:
            return True
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

    def cow(self, slot: int, logical: int) -> Optional[int]:
        """Copy-on-write bookkeeping for ``slot``'s logical page: allocate
        a private page, swap it into the table and drop this slot's
        reference on the shared one. Returns the new page (the caller
        copies the content), or None with the table unchanged when the
        pool is dry."""
        row = self.table[slot]
        old = int(row[logical])
        assert old != self.scratch_page, "COW of an unmapped logical page"
        if not self._free:
            return None
        fresh = self._free.pop()
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

    def check_no_leaks(self) -> None:
        """Full refcount audit: every page's refcount equals its table
        references, and a page is free iff that count is zero."""
        counts = np.zeros((self.num_pages,), np.int64)
        for row in self.table:
            for page in row:
                if int(page) != self.scratch_page:
                    counts[int(page)] += 1
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
