"""EagleSession — multi-turn generation with KV reuse (incremental prefill).

Port of eagle_tpu/engine/session.py. The session keeps the committed
context's target KV, draft KV and token buffer between turns and prefills
only the delta:

- `send(full_prompt_ids)` finds the longest common prefix of the new prompt
  and the stored context, rewinds to it and runs `EagleEngine._extend` over
  `prompt[prefix - 1:]` (one overlap row: see `_extend`). A fresh context
  (no common prefix) takes a full prefill.
- A rewind costs nothing: `_extend(start=p - 1)` overwrites the stale rows
  past the prefix, so edited histories and host-side trimming (the device
  may commit past the host's budget) both resume correctly.
- Greedy turns equal a from-scratch `generate` over the same full context.
  On the card an f32 engine attends through the row-exact tree kernel, so an
  incremental row computes what a monolithic prefill computes for it.

Sampled turns draw from a fresh generator each turn: turn k of a session
built with `seed` is seeded from (seed, k), the counterpart of the JAX
session's `fold_in(PRNGKey(seed), k)` (the streams differ from JAX's; see
engine.py).
"""

from __future__ import annotations

from typing import Iterator, Optional, Tuple

import numpy as np
import torch


def _common_prefix(a: np.ndarray, b: np.ndarray) -> int:
    n = min(len(a), len(b))
    if n == 0:
        return 0
    neq = np.nonzero(a[:n] != b[:n])[0]
    return int(neq[0]) if len(neq) else n


def turn_seed(seed: int, turn: int) -> int:
    """The generator seed of a session's turn: (seed, turn) folded into 63
    bits."""
    return int(np.random.SeedSequence([seed, turn]).generate_state(2, np.uint64)[0] >> 1)


class EagleSession:
    """One conversation's engine state. Not thread-safe: callers serialize
    turns."""

    def __init__(self, engine, seed: int = 0):
        self.engine = engine
        self._seed = seed
        self._turn = 0
        self._state = None
        self._ctx = np.zeros((0,), np.int64)

    @property
    def context(self) -> np.ndarray:
        """Committed tokens (prompt + replies) as of the last turn."""
        return self._ctx.copy()

    def reset(self):
        self._state = None
        self._ctx = np.zeros((0,), np.int64)

    def _prepare(self, ids: np.ndarray, temperature: Optional[float]) -> Tuple[object, int]:
        """Prefill (full or incremental) for this turn's context `ids`.
        Returns (a batch-of-one state, reused prefix length)."""
        eng = self.engine
        seed = turn_seed(self._seed, self._turn)
        self._turn += 1
        p = _common_prefix(ids, self._ctx) if self._state is not None else 0
        if p >= 1 and (p - 1) + eng._bucket(len(ids) - (p - 1)) > eng._tgt_len():
            # the extension window (resume row + bucketed delta) would pass
            # the cache's end although the context fits (max_len not a
            # multiple of the bucket quantum): a full prefill always fits
            p = 0
        with torch.no_grad():
            if p >= 1:
                start = p - 1
                m = len(ids) - start
                padded = np.zeros((1, eng._bucket(m)), np.int64)
                padded[0, :m] = ids[start:]
                temps, gens = eng._requests(temperature, seed, 1)
                state = eng._extend(torch.from_numpy(padded).to(eng.device), m, start,
                                    self._state, temps, gens)
                reused = start
            else:
                _, state = eng._start_batch([ids], temperature, None, seed)
                reused = 0
        self._state = state
        return state, reused

    def stream(self, prompt_ids, max_new_tokens: int = 512,
               eos_token_id: Optional[int] = None,
               temperature: Optional[float] = None) -> Iterator[Tuple[np.ndarray, dict]]:
        """Reply to the FULL prompt `prompt_ids` (context + latest turn),
        yielding (all ids so far, stats) after every round: `generate_stream`
        semantics plus `reused_prefix` in the stats. One host sync a round."""
        eng = self.engine
        ids = np.asarray(prompt_ids, np.int64).reshape(-1)
        if len(ids) == 0:
            raise ValueError("empty prompt")
        if len(ids) + eng.path_len + 1 >= eng.ecfg.max_len:
            raise ValueError(f"context ({len(ids)} tokens) leaves no generation room "
                             f"within max_len {eng.ecfg.max_len}")
        state, reused = self._prepare(ids, temperature)
        out = list(ids)
        new_tokens = rounds = 0
        while new_tokens < max_new_tokens:
            with torch.no_grad():
                state, r = eng._round_rows(state, None, None, batched=False)
            self._state = state
            row = torch.cat([r.accept_len, r.new_tokens[0]]).cpu().numpy()
            alen = int(row[0])
            if alen < 0:          # device-side finish flag tripped
                break
            rounds += 1
            stop = False
            for t in row[1: alen + 2]:
                out.append(int(t))
                new_tokens += 1
                if (eos_token_id is not None and t == eos_token_id) or \
                        new_tokens >= max_new_tokens:
                    stop = True
                    break
            self._ctx = np.asarray(out, np.int64)
            yield np.asarray(out), {"new_tokens": new_tokens, "rounds": rounds,
                                    "accept_len": alen, "reused_prefix": reused}
            if stop or len(out) + eng.path_len + 1 >= eng.ecfg.max_len:
                break
        self._ctx = np.asarray(out, np.int64)

    def send(self, prompt_ids, max_new_tokens: int = 512,
             eos_token_id: Optional[int] = None,
             temperature: Optional[float] = None, log: bool = False):
        """Non-streaming turn: the full ids (context + reply); with log=True
        also the last round's stats."""
        stats = {"new_tokens": 0, "rounds": 0, "reused_prefix": 0}
        for _, stats in self.stream(prompt_ids, max_new_tokens, eos_token_id, temperature):
            pass
        if log:
            return self.context, stats
        return self.context
