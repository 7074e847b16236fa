"""Host-side physical page allocator for the paged KV pool (port of
``repro/serve/pool.py``).

The device side (``models/layers/attention.init_paged_kv_pool``) is a flat
(P, pg, ...) buffer per layer; this allocator owns which physical pages
are live and who owns them.  Physical page 0 is RESERVED as the trash
page: inactive-slot writes are routed there and its ``pos`` stays -1, so
it must never be handed to a request.

Allocation is reservation-at-admission: the scheduler asks for every page
a request can ever need (prompt + max_new) before admitting it, so a live
request can never run out of pages mid-flight (no preemption / swapping —
the vLLM failure mode this sidesteps at small scale).
"""
from __future__ import annotations

from typing import Dict, List

__all__ = ["PagePool"]


class PagePool:
    """Free-list allocator over physical pages 1..n_pages-1."""

    def __init__(self, n_pages: int):
        if n_pages < 2:
            raise ValueError("need at least 2 pages (page 0 is reserved)")
        self.n_pages = n_pages
        # LIFO free list: retired pages are reused first, which keeps the
        # working set of touched pages small under churn.
        self._free: List[int] = list(range(n_pages - 1, 0, -1))
        self._owner: Dict[int, int] = {}  # physical page -> request id

    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def n_live(self) -> int:
        return len(self._owner)

    def can_alloc(self, n: int) -> bool:
        return n <= len(self._free)

    def alloc(self, n: int, owner: int) -> List[int]:
        """Hand ``n`` pages to ``owner``; raises if the pool is short."""
        if n < 0:
            raise ValueError(f"negative page count {n}")
        if not self.can_alloc(n):
            raise RuntimeError(
                f"page pool exhausted: want {n}, have {len(self._free)}")
        pages = [self._free.pop() for _ in range(n)]
        for p in pages:
            self._owner[p] = owner
        return pages

    def free(self, pages: List[int]) -> None:
        for p in pages:
            if p not in self._owner:
                raise RuntimeError(f"double free / foreign page {p}")
            del self._owner[p]
            self._free.append(p)

    def free_owner(self, owner: int) -> int:
        """Free every page owned by ``owner``; returns the count."""
        pages = [p for p, o in self._owner.items() if o == owner]
        self.free(pages)
        return len(pages)

    def owners(self) -> Dict[int, int]:
        """Snapshot of page -> owner (for invariant checks)."""
        return dict(self._owner)

    def check_invariants(self) -> None:
        """No page both free and live; page 0 never tracked; conservation."""
        free = set(self._free)
        live = set(self._owner)
        assert 0 not in free and 0 not in live, "trash page leaked"
        assert not (free & live), f"aliased pages {free & live}"
        assert len(free) == len(self._free), "duplicate in free list"
        assert free | live == set(range(1, self.n_pages)), "pages lost"
