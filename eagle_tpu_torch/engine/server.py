"""EagleServer — continuous batching of speculative decoding.

Port of eagle_tpu/engine/server.py. The server keeps a fixed number of
slots in `groups` groups. Each group holds ONE batched EngineState (every
tensor with a leading row per slot, a generator per row on a sampled
engine), and a scheduler step runs one batched round per live group:
`EagleEngine._round_rows(state, None, kv_limit, batched=True)`, the round
that `generate_batch_fused` runs, one launch of the tree-verify kernel per
layer for the whole group. Requests join and leave the running batch:

- Admission prefills the request alone (a batch of one) and copies its
  state into row i of the group's tensors and its generator into row i of
  the group's generators. A finished request's row gets done = True and
  commits nothing from then on. No Python loop over the slots runs on a
  round's path, and a round never waits on the host.
- Slots are placed by KV bucket (EngineConfig.kv_buckets): a group's bucket
  comes from host bookkeeping (prompt + emitted tokens), so one
  long-context request only widens its own group's reads.
- Admission is paced: at most `max_admit_per_step` prefills a step.
- `async_schedule` = depth: each step dispatches its rounds BEFORE draining
  results, and drains only the steps older than `depth`. A round's outputs
  go to pinned host memory by a non-blocking copy behind a CUDA event, so
  the device runs ahead while the host processes tokens and admits.
  Results of a slot rebound since dispatch are dropped by `bind_id`.

The one host sync of a scheduler step is its drain of results. Greedy
outputs equal the one-sequence `generate` of each request, whatever the
batch around it; a sampled request draws from its own generator (seeded
with `seed=`) in the one-sequence order, so it equals `generate(prompt,
seed=seed, temperature=t)` too, sync or async.
"""

from __future__ import annotations

import collections
from dataclasses import dataclass
from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch

from ..ops.kv_cache import KVCache
from .engine import EagleEngine, EngineState, calibrate_total_tokens, upload


@dataclass
class _Slot:
    active: bool = False
    request_id: int = -1
    prompt_len: int = 0
    emitted: int = 0
    max_new: int = 0
    done_reason: Optional[str] = None
    # request parameters kept for paged preemption (prefill-resume)
    seed: int = 0
    temperature: Optional[float] = None
    admit_seq: int = -1
    # unique per (request, slot) binding: async scheduling matches a drained
    # round's results to the binding live at dispatch
    bind_id: int = -1


@dataclass
class _Request:
    request_id: int
    prompt: np.ndarray
    max_new: int
    seed: int
    temperature: Optional[float] = None  # None: the engine's
    # admission order, kept across paged preemption-resume (-1: never admitted)
    admit_seq: int = -1


class _Pending(NamedTuple):
    """One group's dispatched round: its outputs on their way to the host."""
    g: int
    host: torch.Tensor        # [Bg, 2 + P]: accept_len, done, committed tokens
    event: Optional[torch.cuda.Event]
    snap: list                # bind_id per slot at dispatch (-1: free)


def _rows_of(state: EngineState, fn) -> EngineState:
    """`fn(x, axis)` on every per-row tensor of a state (the batch axis of a
    cache buffer is 1, of everything else 0); generators are left alone. A
    paged group's state has no target cache."""
    def cache(c: Optional[KVCache]) -> Optional[KVCache]:
        if c is None:            # a paged group: its target KV lives in the pool
            return None
        return KVCache(*(None if x is None else fn(x, 0 if name == "length" else 1)
                         for name, x in zip(KVCache._fields, c)))
    opt = lambda x: None if x is None else fn(x, 0)
    return state._replace(tokens=fn(state.tokens, 0), length=fn(state.length, 0),
                          cache=cache(state.cache), dcache=cache(state.dcache),
                          tree=state.tree.map(lambda x: fn(x, 0)), done=fn(state.done, 0),
                          temperature=opt(state.temperature))


def _per_row(state: EngineState) -> list:
    """(tensor, batch axis) of each per-row tensor of a state, in one fixed
    order (`_rows_of`'s)."""
    out = []
    _rows_of(state, lambda x, ax: out.append((x, ax)) or x)
    return out


class EagleServer:
    def __init__(self, engine: EagleEngine, max_batch: int = 4, groups: int = 1,
                 max_admit_per_step: Optional[int] = None,
                 total_tokens: Optional[int] = None, depth: Optional[int] = None,
                 top_k: Optional[int] = None, async_schedule: int = 0):
        """`total_tokens` / `depth` / `top_k` re-point the engine at another
        speculation tree (a sibling sharing the parameters, `with_tree`);
        total_tokens = -1 calibrates it here at the serving batch
        (`calibrate_total_tokens(batch=max_batch)`). Outputs do not change.
        `async_schedule`: the lookahead depth (0: sync; True: 1)."""
        if max_batch % groups:
            raise ValueError(f"max_batch {max_batch} must be a multiple of groups {groups}")
        if total_tokens == -1:
            total_tokens = calibrate_total_tokens(
                engine.params, engine.cfg, max_len=engine.ecfg.max_len, batch=max_batch,
                kv_quant=engine.ecfg.kv_quant, device=engine.device)
        engine = engine.with_tree(total_tokens=total_tokens, depth=depth, top_k=top_k)
        self.engine = engine
        self.B, self.G, self.Bg = max_batch, groups, max_batch // groups
        self.slots: List[List[_Slot]] = [[_Slot() for _ in range(self.Bg)]
                                         for _ in range(groups)]
        self.queue: collections.deque = collections.deque()
        self.outputs: Dict[int, list] = {}
        self.finished: Dict[int, np.ndarray] = {}
        self.finish_reasons: Dict[int, str] = {}  # eos | length | capacity
        self._next_id = 0
        self._states: List[Optional[EngineState]] = [None] * groups
        self.max_admit = max_admit_per_step or max_batch
        self._admit_seq = 0          # admission order, for paged preemption
        self.async_schedule = int(async_schedule)
        # bucket and page margin: host bookkeeping lags the in-flight rounds
        # by at most `depth` commit windows
        self._lag = engine.path_len * self.async_schedule
        self._inflight: List[list] = []   # steps of [_Pending]
        self._bind_seq = 0
        self.rounds = 0              # batched rounds dispatched
        self.drains = 0              # host syncs of the result drains

    # ------------------------------------------------------------------

    def _validate_prompt(self, n_tokens: int):
        """Refuse a prompt that leaves no room for one decode round within
        max_len (the guard generate and the session apply)."""
        limit = self.engine.ecfg.max_len
        if n_tokens + self.engine.path_len + 1 >= limit:
            raise ValueError(
                f"prompt of {n_tokens} tokens leaves no generation room within "
                f"max_len {limit} (needs prompt + path_len + 1 = "
                f"{n_tokens + self.engine.path_len + 1} rows)")

    def submit(self, prompt_ids, max_new_tokens: int = 512, seed: int = 0,
               temperature: Optional[float] = None) -> int:
        """Queue a request. `temperature` (t > 0) needs a sampled engine and
        rides as the row's own device value; `seed` seeds the request's
        generator."""
        self._validate_prompt(len(prompt_ids))
        if temperature is not None and not self.engine.sampled:
            # a greedy engine never reads a request temperature: silently
            # returning argmax output would be a trap
            raise ValueError("per-request temperature requires a sampled-mode engine "
                             "(EngineConfig.temperature > 0)")
        rid = self._next_id
        self._next_id += 1
        prompt = np.asarray(prompt_ids, np.int64).ravel()
        self.queue.append(_Request(rid, prompt, max_new_tokens, seed, temperature))
        self.outputs[rid] = list(prompt)
        return rid

    def _ensure_state(self, g: int, template: EngineState):
        """Allocate group g's batched state from a batch-of-one template:
        every slot starts done (inert until a request is copied in), each row
        with a generator of its own on a sampled engine."""
        if self._states[g] is not None:
            return
        st = _rows_of(template, lambda x, ax: x.repeat(
            *(self.Bg if i == ax else 1 for i in range(x.dim()))))
        gens = None
        if template.gen is not None:
            gens = tuple(torch.Generator(device=self.engine.device) for _ in range(self.Bg))
        self._states[g] = st._replace(done=torch.ones_like(st.done), gen=gens)

    def _request_state(self, req: _Request, cache: KVCache, dcache: KVCache) -> EngineState:
        """The request's prefill (its prompt zero-padded to its bucket), a
        batch of one, into the given caches."""
        eng = self.engine
        Lp = len(req.prompt)
        padded = np.zeros((1, eng._bucket(Lp)), np.int64)
        padded[0, :Lp] = req.prompt
        padded = upload(padded, eng.device)
        temps, gens = eng._requests(req.temperature, req.seed, 1)
        with torch.no_grad():
            return eng._prefill_rows(padded, upload(np.array([Lp]), eng.device), cache,
                                     dcache, temperature=temps, gens=gens)

    def _insert(self, g: int, slot_idx: int, st: EngineState):
        """Copy a batch-of-one state into row slot_idx of group g (device
        copies, stream-ordered after every round already dispatched)."""
        full = self._states[g]
        with torch.no_grad():
            for (dst, ax), (src, _) in zip(_per_row(full), _per_row(st)):
                dst.select(ax, slot_idx).copy_(src.select(ax, 0))
        if full.gen is not None:
            gens = list(full.gen)
            gens[slot_idx] = st.gen[0]
            self._states[g] = full._replace(gen=tuple(gens))

    def _mark_done(self, g: int, slot_idx: int):
        # fill_ of a slice: an element assignment copies a host scalar and
        # waits on the host
        self._states[g].done[slot_idx: slot_idx + 1].fill_(True)

    # ------------------------------------------------------------------

    def _group_bucket(self, g: int) -> Optional[int]:
        """Group g's KV bucket (None: no buckets configured, or no live slot),
        from host bookkeeping: reading state.length would wait on the device."""
        eng = self.engine
        buckets = eng._kv_buckets()
        if buckets is None or self._states[g] is None:
            return None
        live = [s.prompt_len + s.emitted for s in self.slots[g] if s.active]
        if not live:
            return None
        need = max(live) + self._lag + eng.ecfg.tree_size + eng._tail
        return next((b for b in buckets if need <= b), buckets[-1])

    def _pick_free_slot(self, prompt_rows: int) -> Optional[tuple]:
        """A free slot for a request of `prompt_rows` context, preferring the
        group whose bucket already covers it (an empty group counts as a
        fit; among equal fits the fullest); None when every slot is busy."""
        eng = self.engine
        free = [(g, i) for g in range(self.G)
                for i, s in enumerate(self.slots[g]) if not s.active]
        if not free:
            return None
        buckets = eng._kv_buckets()
        if buckets is not None:
            need = prompt_rows + self._lag + eng.ecfg.tree_size + eng._tail
            req_bucket = next((b for b in buckets if need <= b), buckets[-1])

            def fit(gi):
                g, _ = gi
                gb = self._group_bucket(g)
                occupied = sum(s.active for s in self.slots[g])
                return (0 if gb is None else abs(gb - req_bucket), -occupied)

            free.sort(key=fit)
        return free[0]

    def _admit(self):
        """Place queued requests into free slots, at most max_admit a step."""
        admitted = 0
        while self.queue and admitted < self.max_admit:
            req = self.queue[0]
            pos = self._pick_free_slot(len(req.prompt))
            if pos is None:
                break
            if not self._place(req, *pos):
                break  # the backend cannot take it now (the paged pool is full)
            self.queue.popleft()
            admitted += 1

    def _place(self, req: _Request, g: int, slot_idx: int) -> bool:
        """Prefill `req` and bind it to slot (g, slot_idx); False when the
        backend cannot admit it now (here: never)."""
        st = self._request_state(req, *self.engine.init_caches())
        self._ensure_state(g, st)
        self._insert(g, slot_idx, st)
        self._bind_slot(req, g, slot_idx)
        return True

    def _bind_slot(self, req: _Request, g: int, slot_idx: int):
        # a preempted-and-resumed request keeps its first admit_seq, or the
        # paged preemptor would evict it again before it runs a round
        if req.admit_seq < 0:
            req.admit_seq = self._admit_seq
            self._admit_seq += 1
        self.slots[g][slot_idx] = _Slot(
            active=True, request_id=req.request_id, prompt_len=len(req.prompt),
            max_new=req.max_new, seed=req.seed, temperature=req.temperature,
            admit_seq=req.admit_seq, bind_id=self._bind_seq)
        self._bind_seq += 1

    def _dispatch_all(self) -> List[_Pending]:
        """One batched round per live group, each with its bind snapshot."""
        out = []
        for g in range(self.G):
            if self._states[g] is None or not any(s.active for s in self.slots[g]):
                continue
            snap = [s.bind_id if s.active else -1 for s in self.slots[g]]
            r = self._dispatch_round(g)
            self.rounds += 1
            packed = torch.cat([r.accept_len[:, None], r.done[:, None].to(torch.long),
                                r.new_tokens], 1)
            cuda = packed.is_cuda
            host = torch.empty(packed.shape, dtype=packed.dtype, pin_memory=cuda)
            host.copy_(packed, non_blocking=cuda)
            event = None
            if cuda:
                event = torch.cuda.Event()
                event.record()
            out.append(_Pending(g, host, event, snap))
        return out

    def _process_results(self, results: List[_Pending], emitted: Dict[int, np.ndarray]):
        """Drain round results (the step's host sync), append each slot's
        accepted tokens, flag EOS / length / capacity finishes and release
        finished slots. A result whose slot was rebound or released since
        dispatch is dropped: its tokens belong to a binding that is gone."""
        eng = self.engine
        for res in results:
            if res.event is not None:
                res.event.synchronize()
            self.drains += 1
            rows = res.host.numpy()
            for i, slot in enumerate(self.slots[res.g]):
                if not slot.active or slot.bind_id != res.snap[i]:
                    continue
                new = []
                for t in rows[i, 2: rows[i, 0] + 3]:
                    new.append(int(t))
                    self.outputs[slot.request_id].append(int(t))
                    slot.emitted += 1
                    if eng.eos_token_id is not None and t == eng.eos_token_id:
                        slot.done_reason = "eos"
                        break
                    if slot.emitted >= slot.max_new:
                        slot.done_reason = "length"
                        break
                if slot.done_reason is None and rows[i, 1]:
                    slot.done_reason = "capacity"
                if new:
                    emitted[slot.request_id] = np.asarray(new, np.int64)
                if slot.done_reason is not None:
                    self.finished[slot.request_id] = np.asarray(
                        self.outputs.pop(slot.request_id), np.int64)
                    self.finish_reasons[slot.request_id] = slot.done_reason
                    self._release_slot(res.g, i)

    def step(self) -> Dict[int, np.ndarray]:
        """One scheduler iteration; returns {request_id: tokens emitted this
        step}. Sync: admit, run one round per live group, drain. Async:
        dispatch this step's rounds first, drain the steps older than the
        depth (the device computes meanwhile), then admit."""
        emitted: Dict[int, np.ndarray] = {}
        if not self.async_schedule:
            self._admit()
            self._process_results(self._dispatch_all(), emitted)
            return emitted
        if not any(s.active for grp in self.slots for s in grp):
            self._admit()  # bootstrap, or a restart after a full drain
        pending = self._dispatch_all()
        if pending:
            self._inflight.append(pending)
        # keep `depth` steps in flight; drain everything once nothing was
        # dispatched, so run() ends
        target = self.async_schedule if pending else 0
        while len(self._inflight) > target:
            self._process_results(self._inflight.pop(0), emitted)
        self._admit()
        return emitted

    def _dispatch_round(self, g: int):
        """Group g's batched round; updates the group's state and returns
        the batched RoundOutput."""
        with torch.no_grad():
            self._states[g], r = self.engine._round_rows(
                self._states[g], None, self._group_bucket(g), batched=True)
        return r

    def _release_slot(self, g: int, slot_idx: int):
        """Free a slot after its request finished or was cancelled."""
        self.slots[g][slot_idx] = _Slot()
        self._mark_done(g, slot_idx)

    def cancel(self, request_id: int) -> bool:
        """Abort a queued or running request; its pending output is dropped.
        False when the request is unknown or already finished."""
        for k, req in enumerate(self.queue):
            if req.request_id == request_id:
                del self.queue[k]
                self.outputs.pop(request_id, None)
                return True
        for g in range(self.G):
            for i, s in enumerate(self.slots[g]):
                if s.active and s.request_id == request_id:
                    self.outputs.pop(request_id, None)
                    self._release_slot(g, i)
                    return True
        return False

    def _idle(self) -> bool:
        """Nothing queued, running or in flight (subclasses: or prefilling)."""
        return (not self.queue and not self._inflight
                and not any(s.active for grp in self.slots for s in grp))

    def run(self, max_steps: int = 100000) -> Dict[int, np.ndarray]:
        """Step until the queue and the slots drain; all finished outputs."""
        for _ in range(max_steps):
            if self._idle():
                break
            self.step()
        return dict(self.finished)
