"""Paged KV-cache accounting: page allocator + hash-chained prefix index.

A copy of ``repro/serve/paged.py`` (numpy and the standard library only);
``tests/test_torch_paged.py`` holds it against the reference.

This module is the *host-side* half of the prefix cache (DESIGN.md §12):
pure bookkeeping over integer page ids and token arrays, with no device
dependency, so recycling/aliasing/eviction invariants are unit-testable
without a device.  The device-resident page pools (one per k/v cache
tensor) and the snapshot/restore copies live in
:mod:`repro_torch.serve.engine`, which consumes the page ids this module
hands out.

Key scheme
----------
A snapshot of prefix ``tokens[:L]`` (``L`` a multiple of the page size
``P``) is an :class:`PrefixEntry` holding one *page chain*: page ``j``
is keyed by the digest of ``tokens[: (j + 1) * P]`` — so two entries
sharing a token prefix share the underlying pages (refcounted in the
allocator), vLLM-style.  Because every entry registers its whole chain,
the set of registered page keys is prefix-closed: a new chain matches
existing pages on a contiguous leading run and diverges once, which is
why :meth:`PrefixIndex.prepare` can report the new pages as a single
``[first_new, n_pages)`` suffix for the copy program.

Exactness is **not** delegated to the hash: every entry stores its
token prefix and :meth:`PrefixIndex.lookup` only returns an entry after
an exact token-id comparison — a near-miss prefix (same length, one id
different) can never reuse pages.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Dict, List, Optional, Tuple

import numpy as np

__all__ = ["PageAllocator", "PrefixEntry", "PrefixIndex", "SnapshotPlan"]


def _digest(tokens: np.ndarray) -> bytes:
    return hashlib.sha1(
        np.ascontiguousarray(tokens, dtype=np.int32).tobytes()).digest()


class PageAllocator:
    """Fixed pool of ``n_pages`` refcounted pages with a free list.

    A page id is only ever handed out by :meth:`alloc` while its
    refcount is zero, so recycling can never alias a live page — the
    invariant ``tests/test_torch_paged.py`` pins.  ``release`` returns a page
    to the free list when its last reference drops.
    """

    def __init__(self, n_pages: int):
        if n_pages < 1:
            raise ValueError(f"n_pages must be >= 1, got {n_pages}")
        self.n_pages = n_pages
        self._free: List[int] = list(range(n_pages - 1, -1, -1))
        self._refs: Dict[int, int] = {}

    def alloc(self) -> Optional[int]:
        """Take a free page (refcount 1); None when the pool is full."""
        if not self._free:
            return None
        p = self._free.pop()
        self._refs[p] = 1
        return p

    def retain(self, page: int) -> None:
        self._refs[page] += 1

    def release(self, page: int) -> None:
        n = self._refs[page] - 1
        if n < 0:
            raise ValueError(f"page {page} released more than retained")
        if n == 0:
            del self._refs[page]
            self._free.append(page)
        else:
            self._refs[page] = n

    def refcount(self, page: int) -> int:
        return self._refs.get(page, 0)

    @property
    def in_use(self) -> int:
        return self.n_pages - len(self._free)


@dataclasses.dataclass
class PrefixEntry:
    """One cached prefix: ``length`` tokens across ``page_ids`` plus one
    side-slab row (``entry_slot``) for the non-paged leaves (rings,
    recurrent state) at exactly this boundary."""
    tokens: np.ndarray            # [length] int32 — the exactness gate
    length: int
    page_ids: Tuple[int, ...]
    entry_slot: int
    stamp: int = 0                # logical LRU clock, not wall time


@dataclasses.dataclass
class SnapshotPlan:
    """What the device copy program must write for a new entry: pages
    ``page_ids[first_new:]`` (the shared prefix ``page_ids[:first_new]``
    is already resident) plus the side row ``entry_slot``."""
    entry: PrefixEntry
    first_new: int


class PrefixIndex:
    """Hash-chained prefix entries over a :class:`PageAllocator`.

    ``prepare(tokens)`` reserves pages (sharing any existing chain
    prefix) and returns a :class:`SnapshotPlan`; the caller performs the
    device copy and then calls :meth:`commit`.  ``lookup(prompt,
    max_len)`` returns the longest token-id-exact entry usable for a
    prompt.  Entries are evicted LRU when pages or entry slots run out;
    eviction releases the chain's page references, and a page is only
    recycled once no surviving entry references it.
    """

    def __init__(self, allocator: PageAllocator, n_entries: int,
                 page_tokens: int):
        if n_entries < 1:
            raise ValueError(f"n_entries must be >= 1, got {n_entries}")
        if page_tokens < 1:
            raise ValueError(f"page_tokens must be >= 1, got {page_tokens}")
        self.alloc = allocator
        self.page_tokens = page_tokens
        self._entries: Dict[bytes, PrefixEntry] = {}
        self._page_by_key: Dict[bytes, int] = {}
        self._key_by_page: Dict[int, bytes] = {}
        self._free_slots: List[int] = list(range(n_entries - 1, -1, -1))
        self._clock = 0
        # lifetime accounting (the engine mirrors these into metrics)
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def __len__(self) -> int:
        return len(self._entries)

    @property
    def entries(self) -> List[PrefixEntry]:
        return list(self._entries.values())

    def has(self, tokens: np.ndarray) -> bool:
        return _digest(tokens) in self._entries

    # ------------------------------------------------------------- lookup
    def lookup(self, prompt: np.ndarray,
               max_len: int) -> Optional[PrefixEntry]:
        """Longest entry whose tokens exactly equal ``prompt[:L]`` with
        ``L <= max_len`` (callers pass ``len(prompt) - 1`` so at least
        one prompt token is always recomputed for first-token logits)."""
        prompt = np.asarray(prompt, np.int32)
        lengths = sorted({e.length for e in self._entries.values()
                          if e.length <= max_len}, reverse=True)
        for ln in lengths:
            ent = self._entries.get(_digest(prompt[:ln]))
            if ent is not None and ent.length == ln \
                    and np.array_equal(ent.tokens, prompt[:ln]):
                self._clock += 1
                ent.stamp = self._clock
                self.hits += 1
                return ent
        self.misses += 1
        return None

    # ----------------------------------------------------------- snapshot
    def prepare(self, tokens: np.ndarray) -> Optional[SnapshotPlan]:
        """Reserve a page chain + entry slot for prefix ``tokens``.

        Returns None when the prefix is already cached or resources
        cannot be freed (every reservation is rolled back on failure).
        ``tokens`` must be a multiple of ``page_tokens`` long.
        """
        tokens = np.asarray(tokens, np.int32)
        if len(tokens) == 0 or len(tokens) % self.page_tokens:
            raise ValueError(
                f"snapshot length {len(tokens)} is not a positive "
                f"multiple of page_tokens={self.page_tokens}")
        if _digest(tokens) in self._entries:
            return None
        n_pages = len(tokens) // self.page_tokens
        page_ids: List[int] = []
        taken: List[int] = []          # rollback list (retains + allocs)
        first_new = n_pages
        for j in range(n_pages):
            pk = _digest(tokens[: (j + 1) * self.page_tokens])
            pid = self._page_by_key.get(pk)
            if pid is not None and first_new == n_pages:
                self.alloc.retain(pid)
                taken.append(pid)
                page_ids.append(pid)
                continue
            if first_new == n_pages:
                first_new = j
            pid = self._alloc_evicting()
            if pid is None:
                for p in taken:
                    self._release_page(p)
                return None
            taken.append(pid)
            page_ids.append(pid)
            self._page_by_key[pk] = pid
            self._key_by_page[pid] = pk
        slot = self._take_entry_slot()
        if slot is None:
            for p in taken:
                self._release_page(p)
            # drop key registrations for the pages we just created
            return None
        self._clock += 1
        ent = PrefixEntry(tokens=tokens.copy(), length=len(tokens),
                          page_ids=tuple(page_ids), entry_slot=slot,
                          stamp=self._clock)
        return SnapshotPlan(entry=ent, first_new=first_new)

    def commit(self, plan: SnapshotPlan) -> None:
        """Publish a prepared entry (after the device copy succeeded)."""
        self._entries[_digest(plan.entry.tokens)] = plan.entry

    def abort(self, plan: SnapshotPlan) -> None:
        """Roll back a prepared entry without publishing it."""
        for p in plan.entry.page_ids:
            self._release_page(p)
        self._free_slots.append(plan.entry.entry_slot)

    # ----------------------------------------------------------- internal
    def _release_page(self, page: int) -> None:
        self.alloc.release(page)
        if self.alloc.refcount(page) == 0:
            pk = self._key_by_page.pop(page, None)
            if pk is not None and self._page_by_key.get(pk) == page:
                self._page_by_key.pop(pk)

    def _evict_lru(self) -> bool:
        if not self._entries:
            return False
        key, ent = min(self._entries.items(), key=lambda kv: kv[1].stamp)
        del self._entries[key]
        for p in ent.page_ids:
            self._release_page(p)
        self._free_slots.append(ent.entry_slot)
        self.evictions += 1
        return True

    def _alloc_evicting(self) -> Optional[int]:
        while True:
            pid = self.alloc.alloc()
            if pid is not None:
                return pid
            if not self._evict_lru():
                return None

    def _take_entry_slot(self) -> Optional[int]:
        while not self._free_slots:
            if not self._evict_lru():
                return None
        return self._free_slots.pop()
