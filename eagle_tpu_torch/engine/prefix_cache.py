"""Automatic prefix caching for the paged server (vLLM-style).

Port of eagle_tpu/engine/prefix_cache.py (host-side bookkeeping; the draft
rows an entry keeps are torch tensors on the engine's device). Finished
requests donate their full KV pages to a store keyed by the token prefix
they cover; a new request whose prompt starts with a cached prefix adopts
those pages read-only instead of prefilling them again.

Why sharing gives the same output:
- Target KV rows are a function of the token prefix, so any request with
  the same prefix would compute them (on the card an f32 engine's rows are
  bit-equal whichever prefill computed them: the row-exact tree kernel).
- Entries cover FULL pages only (R = npre * page_size rows). An adopter's
  committed length is >= R at all times and a round writes only rows >=
  its length, so adopters never write shared pages. (The recomputed
  boundary row R - 1 is not scattered back: engine/paged.py.)
- EAGLE needs the draft KV of the prefix too: each entry keeps the draft
  rows [0, R) as a small device slab; an adopter takes the rows below its
  boundary row, whose draft pair (its input token differs per
  continuation) is recomputed at adoption, as in engine/session.py.

Ownership: an entry owns the pages it added beyond its parent entry
(entries form chains when a request that adopted prefix E finishes and
donates a deeper one). `borrowers` counts live adoptions plus child
entries; eviction marks an entry dead and frees its own pages once its
borrowers are gone (parents are released recursively).
"""

from __future__ import annotations

import hashlib
from typing import Dict, List, Optional

import numpy as np


def _digest(tokens: np.ndarray) -> bytes:
    return hashlib.sha1(np.ascontiguousarray(tokens, np.int32)
                        .tobytes()).digest()


class PrefixEntry:
    __slots__ = ("rows", "tokens", "pages_own", "parent", "parent_take",
                 "dk", "dv", "borrowers", "dead", "last_used")

    def __init__(self, rows: int, tokens: np.ndarray, pages_own: List[int],
                 parent: Optional["PrefixEntry"], parent_take: int,
                 dk, dv, stamp: int):
        self.rows = rows            # R: logical rows covered (page multiple)
        self.tokens = tokens        # the R prefix tokens (collision guard)
        self.pages_own = pages_own  # pages beyond the adopted coverage
        self.parent = parent
        # pages borrowed from the parent chain. Usually the parent's full
        # coverage, but a PARTIAL adoption (page-granular match at an
        # interior boundary) that later donates a deeper prefix extends the
        # parent at that shallower point — all_pages must splice there, not
        # at the parent's full depth.
        self.parent_take = parent_take
        self.dk, self.dv = dk, dv   # draft KV rows [0, R) (device)
        self.borrowers = 0          # live adopters + child entries
        self.dead = False
        self.last_used = stamp

    def all_pages(self) -> List[int]:
        if self.parent is None:
            return list(self.pages_own)
        return self.parent.all_pages()[: self.parent_take] + self.pages_own


class PrefixStore:
    """Host-side prefix → (entry, rows) map with LRU eviction. Page frees
    go through `release_pages` (the server's allocator).

    Matching is PAGE-GRANULAR (vLLM block-hash style): every page boundary
    an entry covers is indexed, so a request sharing only the first k pages
    of a cached 5-page prefix still adopts those k pages — whole-entry
    matching would miss every shared-system-prompt workload whose requests
    diverge before the donor's full context."""

    def __init__(self, page_size: int, release_pages,
                 max_entries: int = 32):
        self.P = page_size
        self.release_pages = release_pages
        self.max_entries = max_entries
        # digest(tokens[:R]) → (owning entry, R); one slot per page
        # boundary, owned by the shallowest live entry covering it
        self._by_hash: Dict[bytes, tuple] = {}
        self._clock = 0
        self.hits = 0
        self.reused_tokens = 0

    def __len__(self):
        """Distinct live entries (not boundary slots)."""
        return len({id(e) for e, _ in self._by_hash.values() if not e.dead})

    def _tick(self) -> int:
        self._clock += 1
        return self._clock

    def lookup(self, prompt: np.ndarray) -> Optional[tuple]:
        """Deepest page-boundary match: returns (entry, R) where the
        prompt's first R tokens equal rows [0, R) of `entry` (R ≤
        entry.rows), or None."""
        for npre in range(len(prompt) // self.P, 0, -1):
            R = npre * self.P
            v = self._by_hash.get(_digest(prompt[:R]))
            if v is not None and not v[0].dead and \
                    np.array_equal(v[0].tokens[:R], prompt[:R]):
                v[0].last_used = self._tick()
                return v
        return None

    def acquire(self, entry: PrefixEntry):
        entry.borrowers += 1

    def release(self, entry: PrefixEntry):
        entry.borrowers -= 1
        assert entry.borrowers >= 0
        if entry.dead and entry.borrowers == 0:
            self._free(entry)

    def insert(self, tokens: np.ndarray, pages_own: List[int],
               parent: Optional[PrefixEntry], dk, dv,
               parent_take: Optional[int] = None) -> Optional[PrefixEntry]:
        """Register a prefix of len(tokens) rows (page multiple). Returns
        the entry, or None if this prefix depth is already cached (caller
        keeps ownership of pages_own). Takes ownership of pages_own and a
        borrower hold on `parent`. `parent_take`: pages borrowed from the
        parent chain (defaults to the parent's full coverage — pass the
        adoption depth for entries donated by partial adopters)."""
        h = _digest(tokens)
        cur = self._by_hash.get(h)
        if cur is not None and not cur[0].dead:
            return None
        take = 0
        if parent is not None:
            take = parent.rows // self.P if parent_take is None \
                else parent_take
        e = PrefixEntry(len(tokens), np.asarray(tokens, np.int32).copy(),
                        list(pages_own), parent, take, dk, dv, self._tick())
        if parent is not None:
            self.acquire(parent)
        # index every NEW page boundary this entry covers (boundaries
        # ≤ take·P stay owned by the parent chain's registrations); a live
        # deeper entry already registered at a boundary keeps it
        npre = len(tokens) // self.P
        for i in range(take + 1, npre + 1):
            bh = h if i == npre else _digest(tokens[: i * self.P])
            cur = self._by_hash.get(bh)
            if cur is None or cur[0].dead:
                self._by_hash[bh] = (e, i * self.P)
        if len(self) > self.max_entries:
            self.evict(1)
        return e

    # ------------------------------------------------------------------

    def _free(self, entry: PrefixEntry):
        """Free a dead, borrower-less entry's own pages; drop the parent
        hold (cascading if the parent was already dead)."""
        self.release_pages(entry.pages_own)
        entry.pages_own = []
        entry.dk = entry.dv = None
        if entry.parent is not None:
            self.release(entry.parent)
            entry.parent = None

    def evict(self, want_pages: int) -> int:
        """Mark LRU borrower-less entries dead until `want_pages` of their
        own pages have been freed (or nothing evictable remains). Returns
        pages freed immediately.

        Re-scans candidates after every eviction rather than snapshotting
        them once: freeing a child entry drops its parent's borrower count,
        and a parent whose only borrower WAS that child must become
        evictable within the same pass — otherwise callers see a shortfall
        and abort ("page pool too small") with reclaimable pages still
        held by the chain."""
        freed = 0
        while freed < want_pages:
            cands = {id(e): e for e, _ in self._by_hash.values()
                     if not e.dead and e.borrowers == 0}
            if not cands:
                break
            e = min(cands.values(), key=lambda c: c.last_used)
            e.dead = True
            freed += len(e.pages_own)
            self._free(e)
        self._by_hash = {h: v for h, v in self._by_hash.items()
                         if not v[0].dead}
        # re-register boundaries orphaned by the dead entries: a deeper
        # live entry's interior boundaries were masked by a (now dead)
        # shallower owner and must become matchable again. Registering a
        # boundary ≤ parent_take·P to a child is also correct — all_pages
        # splices the parent chain, whose pages a child borrower keeps
        # alive even when the parent entry is dead.
        live = sorted({id(v[0]): v[0] for v in self._by_hash.values()
                       }.values(), key=lambda e: e.rows)
        for e in live:
            for i in range(1, e.rows // self.P + 1):
                bh = _digest(e.tokens[: i * self.P])
                cur = self._by_hash.get(bh)
                if cur is None or cur[0].dead:
                    self._by_hash[bh] = (e, i * self.P)
        return freed
