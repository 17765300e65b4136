"""PagedEagleServer — continuous batching over a shared KV page pool.

Port of eagle_tpu/engine/paged.py. `EagleServer` gives every slot a dense
max_len-row target KV slab; this subclass keeps the target KV in a shared
page pool (ops/paged_kv.py): per-slot block tables map logical rows to
pages, pages are allocated as sequences grow and recycled when they finish,
so memory scales with the sum of live contexts. A served round is gather ->
round -> scatter: each slot's window of logical rows is gathered into the
batched dense layout, `EagleEngine._round_rows` runs on it unmodified, and
the `path_len` rows a slot's round wrote go back to its pages. The block
tables reach the card by a non-blocking copy from pinned memory, so a round
still never waits on the host. The draft KV and the token buffers stay
dense per slot.

Preemption: when the pool cannot cover a running slot's growth, the
youngest request is evicted (arrival order is kept across resumes): its
pages are freed and its context so far is requeued as a fresh prompt.
Greedy decoding is Markov in the committed tokens, so a resumed request
gives the same output; a sampled one resumes with a fresh generator from
its seed.

Chunked prefill (`prefill_chunk`): a long prompt prefills one chunk a
scheduler step, between decode rounds, on `_extend`'s arithmetic: each chunk
forwards its rows against the pool window below it and writes its K/V rows
and its draft pairs; the final chunk draws the root token and builds the
first tree. On the card an f32 engine attends through the row-exact tree
kernel, so a chunked prompt's rows equal an unchunked prefill's.

Prefix cache (`prefix_cache`, engine/prefix_cache.py): a finished request
donates its full pages and their draft rows; a later prompt that starts
with a cached prefix adopts those pages read-only and prefills only the
rest. Two defects of the JAX reference are not inherited:
- a deep prefix hit that cannot be placed (its recomputed window would pass
  the cache's rows) goes to the chunker or a full prefill; the JAX server
  keeps retrying it and never admits the request (eagle_tpu/engine/
  paged.py:476);
- the adoption prefill takes the donor's draft rows below the boundary row
  only (R - 1 of them), not the donor's whole slab (paged.py:592), so what
  it reads does not depend on how deep the donor's entry is.
"""

from __future__ import annotations

import collections
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..models import draft as draft_mod
from ..models import transformer
from ..ops.kv_cache import KVCache, with_length
from ..ops.masks import prefill_mask
from ..ops.paged_kv import gather_windows, init_pool, scatter_prefix, scatter_rows
from .engine import EagleEngine, EngineState, _target_feats, upload
from .prefix_cache import PrefixEntry, PrefixStore
from .server import EagleServer, _Request, _Slot


@dataclass
class _PrefillJob:
    """A chunked prefill in flight: the prompt's K/V rows reach the pool one
    chunk a scheduler step."""
    req: _Request
    dcache: KVCache                  # the job's own dense draft KV, grown a chunk at a time
    pages: List[int] = field(default_factory=list)
    bt: np.ndarray = None            # [pages_per_slot] block-table row
    rows_done: int = 0               # prompt rows already in the pool
    state: Optional[EngineState] = None  # set by the final chunk


class PageAllocator:
    """Host free list of physical page ids. Page 0 is the trash page."""

    def __init__(self, num_pages: int):
        if num_pages < 2:
            raise ValueError("need at least one real page and the trash page")
        self.num_pages = num_pages
        self._free: List[int] = list(range(num_pages - 1, 0, -1))

    @property
    def free_pages(self) -> int:
        return len(self._free)

    def alloc(self, n: int) -> Optional[List[int]]:
        if len(self._free) < n:
            return None
        return [self._free.pop() for _ in range(n)]

    def release(self, pages: List[int]):
        self._free.extend(pages)


class PagedEagleServer(EagleServer):
    def __init__(self, engine: EagleEngine, max_batch: int = 4, groups: int = 1,
                 max_admit_per_step: Optional[int] = None, page_size: int = 128,
                 num_pages: Optional[int] = None, total_tokens: Optional[int] = None,
                 depth: Optional[int] = None, top_k: Optional[int] = None,
                 prefix_cache: bool = True, prefix_entries: int = 32,
                 prefill_chunk: Optional[int] = None, async_schedule: int = 0):
        """`page_size`: KV rows a page; it must divide the prompt bucket
        quantum (min(128, max_len)) so prefilled buckets scatter as whole
        pages. `num_pages`: pool capacity (default: every slot at full
        max_len, plus the trash page). `prefix_cache`: finished requests
        donate their full pages to a prefix store (`prefix_entries`
        entries). `prefill_chunk`: rows a chunked-prefill step (a multiple of
        page_size); longer prompts prefill one chunk a scheduler step."""
        super().__init__(engine, max_batch, groups, max_admit_per_step,
                         total_tokens=total_tokens, depth=depth, top_k=top_k,
                         async_schedule=async_schedule)
        eng = self.engine
        quantum = min(128, eng.ecfg.max_len)
        if quantum % page_size:
            raise ValueError(f"page_size {page_size} must divide the prompt bucket "
                             f"quantum {quantum}")
        if prefill_chunk is not None and prefill_chunk % page_size:
            raise ValueError(f"prefill_chunk {prefill_chunk} must be a multiple of "
                             f"page_size {page_size}")
        self.P = page_size
        self._S_tok = eng._tgt_len()
        self.pages_per_slot = -(-self._S_tok // page_size)
        if num_pages is None:
            num_pages = max_batch * self.pages_per_slot + 1      # + the trash page
        self.allocator = PageAllocator(num_pages)
        c = eng.cfg
        self._pool = init_pool(c.num_layers, c.num_kv_heads, num_pages, page_size,
                               c.head_dim, dtype=c.dtype, kv_quant=eng.ecfg.kv_quant,
                               device=eng.device)
        self._bt = [np.zeros((self.Bg, self.pages_per_slot), np.int64)
                    for _ in range(groups)]
        self._pages: Dict[Tuple[int, int], List[int]] = {}
        self.preemptions = 0
        # prefix caching (engine/prefix_cache.py)
        self.store = (PrefixStore(page_size, self.allocator.release,
                                  max_entries=prefix_entries) if prefix_cache else None)
        self._borrowed: Dict[Tuple[int, int], int] = {}   # shared pages of a slot
        self._adopted: Dict[Tuple[int, int], PrefixEntry] = {}
        # chunked prefill
        self.C = prefill_chunk
        self._job: Optional[_PrefillJob] = None      # at most one chunking
        self._ready: collections.deque = collections.deque()  # waiting for a slot
        self.chunked_prefills = 0       # requests admitted through the chunker
        self.cancelled_prefills = 0     # jobs abandoned under pool pressure

    @property
    def pool_bytes(self) -> int:
        return self._pool.nbytes

    def submit(self, prompt_ids, max_new_tokens: int = 512, seed: int = 0,
               temperature=None) -> int:
        """Refuse at once a request the pool can never serve: it would block
        admission and end the serve loop later."""
        eng = self.engine
        Lp = len(prompt_ids)
        self._validate_prompt(Lp)   # an overlong prompt reports max_len first
        worst_rows = max(eng._bucket(Lp),
                         min(self._S_tok, Lp + max_new_tokens + eng.path_len))
        need = -(-worst_rows // self.P)
        usable = self.allocator.num_pages - 1
        if need > usable:
            raise ValueError(
                f"request needs up to {need} pages over its lifetime (prompt {Lp} + "
                f"max_new {max_new_tokens}); pool holds only {usable} usable pages — "
                "raise num_pages or shorten the request")
        return super().submit(prompt_ids, max_new_tokens, seed, temperature)

    # ------------------------------------------------------------------
    # shared steps
    # ------------------------------------------------------------------

    def _window(self, bt_row: np.ndarray, W: int, length: int) -> KVCache:
        """One slot's logical rows [0, W) gathered from the pool, as a
        batch-of-one cache of that length."""
        k, v, ks, vs = gather_windows(self._pool, upload(bt_row[None], self.engine.device),
                                      W, self.P)
        dev = self.engine.device
        return KVCache(k=k, v=v, length=torch.full((1,), length, dtype=torch.long, device=dev),
                       ks=ks, vs=vs)

    def _scatter(self, bt_row: np.ndarray, cache: KVCache, start: int, n: int):
        """Rows [start, start + n) of a batch-of-one window back to its pages."""
        dev = self.engine.device
        scatter_rows(self._pool, upload(bt_row[None], dev), cache.k, cache.v,
                     torch.full((1,), start, dtype=torch.long, device=dev), n, self.P,
                     torch.ones(1, dtype=torch.bool, device=dev), cache.ks, cache.vs)

    def _forward(self, tokens: np.ndarray, cache: KVCache, start: int):
        """The target forward of a window of fresh rows [1, T] at `start`."""
        eng = self.engine
        T = tokens.shape[1]
        dev = eng.device
        pos = (start + torch.arange(T, device=dev))[None]
        return transformer.forward(eng.params, eng.cfg, upload(tokens, dev), cache, pos,
                                   eng._fresh_mask(T, cache.max_len, cache.length))

    def _finish_prefill(self, req: _Request, res, tokens: np.ndarray, m: int, start: int,
                        dcache: KVCache) -> EngineState:
        """The tail of a prefill whose last fresh rows `tokens` [1, T] (m
        valid, the first at `start`) were just forwarded: draw the root token
        from row m - 1, extend the draft cache on the window's pairs and build
        the first tree; the returned batch-of-one state has no target cache.
        A sampled request draws the root, then the draft's noise, from a
        generator seeded with its seed, as `_prefill_rows` does."""
        eng = self.engine
        dev = eng.device
        temps, gens = eng._requests(req.temperature, req.seed, 1)
        root = eng._pick_tokens(transformer.lm_head(eng.params, eng.cfg,
                                                    res.hidden[:, m - 1]), temps, gens)
        ext = np.zeros_like(tokens)
        ext[0, : tokens.shape[1] - 1] = tokens[0, 1:]
        ext_tokens = upload(ext, dev)
        ext_tokens[:, m - 1] = root
        dr = eng._draft_round(ext_tokens, _target_feats(res, eng.dcfg.version),
                              torch.full((1,), m, dtype=torch.long, device=dev), dcache,
                              temps, gens)
        full = np.zeros((1, self._S_tok), np.int64)
        full[0, : len(req.prompt)] = req.prompt
        return EngineState(tokens=upload(full, dev),
                           length=torch.full((1,), start + m, dtype=torch.long, device=dev),
                           cache=None, dcache=dr.dcache, tree=dr.tree,
                           done=torch.zeros(1, dtype=torch.bool, device=dev),
                           temperature=temps, gen=gens)

    def _bind_pages(self, g: int, slot_idx: int, pages: List[int], st: EngineState,
                    req: _Request):
        self._pages[(g, slot_idx)] = pages
        self._bt[g][slot_idx, :] = 0
        self._bt[g][slot_idx, : len(pages)] = pages
        self._ensure_state(g, st)
        self._insert(g, slot_idx, st)
        self._bind_slot(req, g, slot_idx)

    # ------------------------------------------------------------------
    # admission
    # ------------------------------------------------------------------

    def _alloc_pages(self, n: int) -> Optional[List[int]]:
        """n pages, evicting least recently used prefix entries if needed."""
        got = self.allocator.alloc(n)
        if got is None and self.store is not None:
            self.store.evict(n - self.allocator.free_pages)
            got = self.allocator.alloc(n)
        return got

    def _usable_hit(self, req: _Request) -> Optional[tuple]:
        """The deepest cached prefix of `req` that adoption can take: its
        recomputed window (the boundary row + the bucketed rest) fits the
        cache's rows, and, with chunking on, the rest is at most one chunk
        (a longer one would be a giant unchunked prefill, the stall chunking
        prevents). None otherwise, and the request then takes the chunker or
        a full prefill (the JAX server admits the first kind never)."""
        if self.store is None:
            return None
        hit = self.store.lookup(req.prompt)
        if hit is None:
            return None
        R = hit[1]
        rest = len(req.prompt) - (R - 1)
        if R + self.engine._bucket(rest) > self._S_tok:
            return None
        if self.C is not None and rest > self.C:
            return None
        return hit

    def _place(self, req: _Request, g: int, slot_idx: int) -> bool:
        hit = self._usable_hit(req)
        if hit is not None and self._place_prefix(req, g, slot_idx, *hit):
            return True
        if self.C is not None and len(req.prompt) > self.C:
            return False  # long prompts go through the chunker, one at a time,
            # so admission keeps arrival order
        eng = self.engine
        Lp = len(req.prompt)
        Tp = eng._bucket(Lp)
        npg = Tp // self.P
        pages = self._alloc_pages(npg)
        if pages is None:
            if not any(s.active for grp in self.slots for s in grp):
                raise RuntimeError(f"page pool too small: prompt needs {npg} pages, pool "
                                   f"has {self.allocator.num_pages - 1} usable total")
            return False  # wait for running requests to free pages
        # prefill into a prompt-sized dense scratch, scatter it into the pages
        st = self._request_state(req, eng.init_target_cache(rows=Tp), eng.init_draft_cache())
        scatter_prefix(self._pool, upload(np.asarray(pages), eng.device), st.cache.k,
                       st.cache.v, self.P, st.cache.ks, st.cache.vs)
        full = torch.zeros((1, self._S_tok), dtype=torch.long, device=eng.device)
        full[:, :Tp] = st.tokens
        self._bind_pages(g, slot_idx, pages, st._replace(cache=None, tokens=full), req)
        return True

    # ------------------------------------------------------------------
    # chunked prefill
    # ------------------------------------------------------------------

    def _wbucket(self, n: int) -> int:
        """Gather window of a chunk: multiples of 2 C (few distinct shapes,
        reads within two chunks of the live rows)."""
        q = 2 * self.C
        return min(-(-n // q) * q, self._S_tok)

    def _chunk(self, job: _PrefillJob, R: int, C: int):
        """An intermediate chunk: forward prompt rows [R, R + C) against the
        pool window below them, scatter their K/V rows and extend the job's
        draft cache on the chunk's (feature, next token) pairs (the whole
        prompt is known, so no token is drawn and no tree is built)."""
        eng = self.engine
        dev = eng.device
        prompt = job.req.prompt
        W = self._wbucket(R + C)
        cache = self._window(job.bt, W, R)
        with torch.no_grad():
            res = self._forward(prompt[None, R: R + C], cache, R)
            self._scatter(job.bt, res.cache, R, C)
            pos = (R + torch.arange(C, device=dev))[None]
            dc = job.dcache
            dres = draft_mod.forward(eng.dparams, eng.dcfg,
                                     upload(prompt[None, R + 1: R + C + 1], dev),
                                     _target_feats(res, eng.dcfg.version), dc, pos,
                                     prefill_mask(C, dc.max_len, dc.length))
        job.dcache = with_length(dres.cache, torch.full((1,), R + C, dtype=torch.long,
                                                        device=dev))

    def _chunk_final(self, job: _PrefillJob, R: int, Cf: int) -> EngineState:
        """The final chunk: forward the last m prompt rows (padded to Cf),
        draw the root token and build the first draft tree, the tail of a
        prefill, against the pool pages."""
        prompt = job.req.prompt
        m = len(prompt) - R
        win = np.zeros((1, Cf), np.int64)
        win[0, :m] = prompt[R:]
        cache = self._window(job.bt, self._wbucket(R + Cf), R)
        with torch.no_grad():
            res = self._forward(win, cache, R)
            self._scatter(job.bt, res.cache, R, Cf)
            return self._finish_prefill(job.req, res, win, m, R, job.dcache)

    def _start_job(self, req: _Request):
        self._job = _PrefillJob(req=req, dcache=self.engine.init_draft_cache(),
                                bt=np.zeros((self.pages_per_slot,), np.int64))
        self.chunked_prefills += 1

    def _install_job(self, job: _PrefillJob, g: int, slot_idx: int):
        self._bind_pages(g, slot_idx, job.pages, job.state, job.req)

    def _advance_prefill(self):
        """One chunked-prefill step: place finished jobs waiting for a slot,
        then run ONE chunk of the job in flight (chunks interleave 1:1 with
        decode rounds)."""
        while self._ready:
            pos = self._pick_free_slot(len(self._ready[0].req.prompt))
            if pos is None:
                break
            self._install_job(self._ready.popleft(), *pos)
        job = self._job
        if job is None:
            return
        eng, P, C = self.engine, self.P, self.C
        Lp, R = len(job.req.prompt), job.rows_done
        final = Lp - R <= C
        rows_end = min(R + (eng._bucket(Lp - R) if final else C), self._S_tok)
        need = -(-rows_end // P)
        if len(job.pages) < need:
            got = self._alloc_pages(need - len(job.pages))
            if got is None:
                if not any(s.active for grp in self.slots for s in grp) and not self._ready:
                    raise RuntimeError(
                        "page pool exhausted mid-chunked-prefill with no running requests "
                        "to drain — size num_pages for at least one full-length request")
                return  # wait for running requests to free pages
            job.bt[len(job.pages): need] = got
            job.pages.extend(got)
        if not final:
            self._chunk(job, R, C)
            job.rows_done = R + C
            return
        job.state = self._chunk_final(job, R, rows_end - R)
        self._job = None
        pos = self._pick_free_slot(Lp)
        if pos is not None:
            self._install_job(job, *pos)
        else:
            self._ready.append(job)

    def _cancel_one_job(self) -> bool:
        """Abandon a chunked prefill under pool pressure (running requests
        outrank waiting prefills): its pages return to the pool and its
        request to the queue's head; it restarts with the same draws."""
        if self._job is not None:
            job, self._job = self._job, None
        elif self._ready:
            job = self._ready.pop()   # newest first: the least sunk cost
        else:
            return False
        self.allocator.release(job.pages)
        self.queue.appendleft(job.req)
        self.chunked_prefills -= 1
        self.cancelled_prefills += 1
        return True

    def _admit(self):
        self._advance_prefill()
        # start chunking the queue's head if it is long, even with no free
        # slot (its prefill then overlaps running decode), unless adoption
        # of a cached prefix can take it
        if self.C is not None and self.queue and self._job is None and not self._ready:
            req = self.queue[0]
            if len(req.prompt) > self.C and self._usable_hit(req) is None:
                self._start_job(req)
                self.queue.popleft()
        super()._admit()

    def _idle(self) -> bool:
        return super()._idle() and self._job is None and not self._ready

    def cancel(self, request_id: int) -> bool:
        """Also covers a request in chunked prefill (running or waiting)."""
        job = None
        if self._job is not None and self._job.req.request_id == request_id:
            job, self._job = self._job, None
        else:
            for k, j in enumerate(self._ready):
                if j.req.request_id == request_id:
                    job = j
                    del self._ready[k]
                    break
        if job is not None:
            self.allocator.release(job.pages)
            self.outputs.pop(request_id, None)
            self.chunked_prefills -= 1
            return True
        return super().cancel(request_id)

    # ------------------------------------------------------------------
    # prefix caching (engine/prefix_cache.py)
    # ------------------------------------------------------------------

    def _adoption_dcache(self, entry: PrefixEntry, R: int) -> KVCache:
        """A fresh draft cache holding the entry's draft rows [0, R - 1), of
        length R - 1: the rows below the recomputed boundary row, whatever
        the entry's depth."""
        dc = self.engine.init_draft_cache()
        dc.k[:, :, :, : R - 1].copy_(entry.dk[:, :, :, : R - 1])
        dc.v[:, :, :, : R - 1].copy_(entry.dv[:, :, :, : R - 1])
        return with_length(dc, torch.full((1,), R - 1, dtype=torch.long,
                                          device=self.engine.device))

    def _place_prefix(self, req: _Request, g: int, slot_idx: int, entry: PrefixEntry,
                      R: int) -> bool:
        """Admit `req` by adopting rows [0, R) of a cached prefix (R <= the
        entry's rows: a page-granular match takes the shared pages only),
        and prefill the window [R - 1, R - 1 + Te): the boundary row R - 1 is
        recomputed, since its draft pair's input token differs per
        continuation, but its K/V row is not scattered back, so shared pages
        stay read-only. False when the suffix's pages are not there."""
        eng, P = self.engine, self.P
        npre = R // P
        m = len(req.prompt) - (R - 1)        # the boundary row + the rest
        Te = eng._bucket(m)
        # pin the entry before allocating: _alloc_pages may evict entries,
        # and an unpinned one could be freed mid-adoption
        self.store.acquire(entry)
        suffix = self._alloc_pages(Te // P)
        if suffix is None:
            self.store.release(entry)
            return False
        pages = entry.all_pages()[:npre] + suffix
        bt_row = np.zeros((self.pages_per_slot,), np.int64)
        bt_row[: len(pages)] = pages
        win = np.zeros((1, Te), np.int64)
        win[0, :m] = req.prompt[R - 1:]
        cache = self._window(bt_row, R + Te, R - 1)
        with torch.no_grad():
            res = self._forward(win, cache, R - 1)
            self._scatter(bt_row, res.cache, R, Te - 1)   # rows [R, R - 1 + Te)
            st = self._finish_prefill(req, res, win, m, R - 1,
                                      self._adoption_dcache(entry, R))
        self._borrowed[(g, slot_idx)] = npre
        self._adopted[(g, slot_idx)] = entry    # holds the acquire above
        self._bind_pages(g, slot_idx, pages, st, req)
        self.store.hits += 1
        self.store.reused_tokens += R - 1
        return True

    def _donate_prefix(self, g: int, slot_idx: int, slot: _Slot, pages: List[int],
                       borrowed: int, entry: Optional[PrefixEntry],
                       own: List[int]) -> List[int]:
        """On finish, donate the slot's full-page prefix (its pages and the
        draft rows they cover) to the store. Returns the pages the slot still
        owns (to be freed)."""
        ctx = self.finished[slot.request_id]
        npre_f = min(len(ctx) // self.P, len(pages))
        if npre_f <= borrowed or npre_f < 1:
            return own  # nothing cacheable past the adopted prefix
        R = npre_f * self.P
        dc = self._states[g].dcache
        dk = dc.k[:, slot_idx: slot_idx + 1, :, :R].clone()
        dv = dc.v[:, slot_idx: slot_idx + 1, :, :R].clone()
        # parent_take = the slot's adoption depth: a page-granular adopter
        # extends its parent there, not at the parent's full coverage
        e = self.store.insert(ctx[:R], pages[borrowed:npre_f], entry, dk, dv,
                              parent_take=borrowed)
        if e is None:
            return own  # this prefix is cached already
        return pages[npre_f:]  # the store owns [borrowed, npre_f)

    # ------------------------------------------------------------------
    # growth, preemption, rounds
    # ------------------------------------------------------------------

    def _grow(self, g: int):
        """Every active slot's pages cover this round's scatter window
        [length, length + path_len), from exact host bookkeeping (prompt +
        emitted, plus the async lag): no device sync."""
        eng = self.engine
        for i, slot in enumerate(self.slots[g]):
            if not slot.active:
                continue
            committed = slot.prompt_len + slot.emitted + self._lag
            need = min(-(-(committed + eng.path_len) // self.P), self.pages_per_slot)
            pages = self._pages[(g, i)]
            while len(pages) < need:
                got = self._alloc_pages(need - len(pages))
                if got is not None:
                    self._bt[g][i, len(pages): need] = got
                    pages.extend(got)
                    break
                if self._cancel_one_job():
                    continue
                if not self._preempt_one(protect=(g, i)):
                    raise RuntimeError(
                        "page pool exhausted: a single request needs more pages than "
                        "the pool holds — size num_pages for at least one full-length "
                        "request")

    def _preempt_one(self, protect: Tuple[int, int]) -> bool:
        """Evict the youngest active request (not `protect`): free its pages
        and requeue its context so far as a fresh prompt (prefill-resume)."""
        cands = [(grp, j, s) for grp in range(self.G) for j, s in enumerate(self.slots[grp])
                 if s.active and (grp, j) != protect]
        if not cands:
            return False
        g, i, s = max(cands, key=lambda t: t[2].admit_seq)
        ctx = np.asarray(self.outputs[s.request_id], np.int64)
        self.queue.appendleft(_Request(s.request_id, ctx, s.max_new - s.emitted, s.seed,
                                       s.temperature, admit_seq=s.admit_seq))
        self._release_slot(g, i)
        self.preemptions += 1
        return True

    def _dispatch_round(self, g: int):
        """gather -> round -> scatter for group g: the batched round runs on
        the slots' gathered windows (their group bucket, or the full rows),
        and the path_len rows each live slot's round wrote from its length go
        back to its pages (free slots' rows to the trash page)."""
        self._grow(g)
        eng, state = self.engine, self._states[g]
        window = self._group_bucket(g) or self._S_tok
        bt = upload(self._bt[g], eng.device)
        k, v, ks, vs = gather_windows(self._pool, bt, window, self.P)
        with torch.no_grad():
            new, r = eng._round_rows(state._replace(cache=KVCache(k, v, state.length, ks, vs)),
                                     None, None, batched=True)
            c = new.cache
            scatter_rows(self._pool, bt, c.k, c.v, state.length, eng.path_len, self.P,
                         ~state.done, c.ks, c.vs)
        self._states[g] = new._replace(cache=None)
        return r

    def _release_slot(self, g: int, slot_idx: int):
        slot = self.slots[g][slot_idx]
        pages = self._pages.pop((g, slot_idx), None)
        borrowed = self._borrowed.pop((g, slot_idx), 0)
        entry = self._adopted.pop((g, slot_idx), None)
        if pages:
            own = pages[borrowed:]  # shared prefix pages belong to the store
            if self.store is not None and slot.active and slot.request_id in self.finished:
                own = self._donate_prefix(g, slot_idx, slot, pages, borrowed, entry, own)
            self.allocator.release(own)
        if entry is not None:
            self.store.release(entry)
        self._bt[g][slot_idx, :] = 0
        super()._release_slot(g, slot_idx)
