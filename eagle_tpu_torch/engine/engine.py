"""EagleEngine — speculative decoding on one device, greedy or sampled, one
sequence or a batch.

Port of eagle_tpu/engine/engine.py: `_prefill`, `_round` (tree verify →
acceptance → KV compaction → next draft tree), `generate`, `generate_fused`,
`generate_stream`, the batched `generate_batch` and `generate_batch_fused`,
the vanilla baseline and its stream, `calibrate_total_tokens` and
`from_pretrained`. The JAX engine jits each round into one XLA program; here
PyTorch runs eagerly and a round keeps every offset on the device, so it
never waits on the host. `generate_fused` is a host loop whose only
per-round sync reads the stop flag and the committed length in one transfer.

Batches: the JAX engine vmaps its one-sequence `_prefill` and `_round` over
the batch. Here the round is written once over a leading batch dimension
(`_prefill_rows`, `_round_rows`): every cache write, the tree-verify
attention kernel, the draft forwards and the fused scorer run once for the
whole batch, and a one-sequence state is its batch of one. As in JAX, the
compaction kernel runs only for one sequence (a batch takes the plain row
moves), a finished row commits nothing, the capacity stop is per row, and a
batch picks one `kv_buckets` bucket from its longest row.

Ported operating points: bf16/fp32, int8 and int4 targets (params from
ops/quant.quantize_target_params / ops/quant4.quantize_target_params4),
`draft_quant` "int8" / "int4", `fuse_scoring` (the fused score+top-k kernel
in the drafter's beam loop), dynamic trees and static ones (`tree_paths`),
`kv_buckets` (length-bucketed decode reads) and `kv_quant="int8"` (int8
target KV; runs no hand-written kernel, as in the JAX package). A quantized
draft never changes the output; a quantized target or KV cache is bit-exact
against its own vanilla decode.

`kv_buckets`: the JAX engine picks the bucket on the device (`lax.switch`
inside its while loop). `generate_fused` and the fused vanilla loop pick it
on the host, from a length they already hold, with the same formula
(`_bucket_index`), and add no sync for it.

Sampling: an engine built at temperature > 0 runs the sampled round (as in
JAX, `ecfg.temperature` chooses greedy or sampled; a request's
`temperature=` is data on a sampled engine and ignored on a greedy one).
The three acceptance branches are JAX's: greedy; true-q when the draft
tree carries `node_probs` (sampled candidates: acceptance "true_q" on
static trees, "true_q_dynamic" on any); q(x) = 1 otherwise. The request's
temperature rides in EngineState as a device scalar, floored at 1e-4 where
it divides, and its noise comes from one `torch.Generator` per request on
the engine's device, seeded from `seed=`: every round draws, in this order,
the acceptance uniforms, the bonus token's, then the draft's (JAX's
`split(state.key, 4)` order). No draw syncs with the host. The streams
differ from `jax.random`'s, so the sampled functions take their noise as an
argument and are held against JAX on the same uniforms.

A batch's request draws from one generator per row: row i's is seeded
with `seed + i`, so row i of a batched sampled request draws what the
one-sequence request with seed `seed + i` draws, whatever the batch size.
Each row's temperature rides in EngineState as its own device value.

Incremental prefill (`_extend`) appends context to a committed state: the
sessions, the servers' chunked prefill and prefix adoption run on it. On
the card an f32 engine with the tree kernel and a float cache runs every
target attention (verify, prefill, `_extend`, the vanilla step) through the
kernel's row-exact f32 route (`_fresh_mask`), so a row's attention bits do
not depend on the other rows of its call: a quantized target then stays
bit-exact against its own vanilla decode however its context was prefilled.

Options not ported yet raise NotImplementedError: sp_mesh, a mesh in
from_pretrained, MoE and sliding-window targets.
"""

from __future__ import annotations

import dataclasses
import time
from typing import NamedTuple, Optional

import numpy as np
import torch
from torch.profiler import record_function

from .. import resolve_device
from ..config import DraftConfig, EngineConfig, ModelConfig
from ..models import draft as draft_mod
from ..models import transformer
from ..ops.attn_kernels import compact_rows
from ..ops.kv_cache import (KVCache, compact_accepted, init_cache,
                            merge_rows_window, slice_rows, windows, with_length)
from ..ops.masks import TreeMaskSpec, prefill_mask
from ..ops.quant import quantize_draft_params, quantize_target_params
from ..ops.quant4 import quantize_draft_params4, quantize_target_params4
from ..ops.tree import Tree
from . import accept as accept_mod
from .drafter import StaticTreeSpec, _rows, draft_round, draft_round_static
from .sampling import U_MIN, categorical, process_logits, uniform


class EngineState(NamedTuple):
    """One sequence's state, or a batch's: then `length`, `done` and
    `temperature` are [B], the tree has a leading B, and `gen` is a tuple of
    B generators."""
    tokens: torch.Tensor   # [B, S] committed tokens (+ scratch tail); B = 1 alone
    length: torch.Tensor   # committed length: scalar, or [B]
    cache: KVCache         # target KV
    dcache: KVCache        # draft KV (pairs)
    tree: Tree             # next tree to verify
    done: torch.Tensor     # bool, sequence finished: scalar, or [B]
    # the request's sampling temperature on the device (read only by a
    # sampled engine) and its noise generator (None on a greedy engine)
    temperature: Optional[torch.Tensor] = None
    gen: Optional[torch.Generator] = None

    @property
    def batched(self) -> bool:
        return self.done.dim() == 1


class RoundOutput(NamedTuple):
    """One sequence's round, or a batch's with a leading B on each."""
    new_tokens: torch.Tensor  # [PATH] committed this round (first n_acc valid)
    accept_len: torch.Tensor  # scalar (-1 when the sequence is done)
    done: torch.Tensor        # scalar bool
    live_match: torch.Tensor  # forced replay: live-argmax agreements


def _as_batch(state: EngineState) -> EngineState:
    """A one-sequence state as a batch of one (views: nothing is copied)."""
    one = lambda x: None if x is None else x.reshape(1)
    return state._replace(length=one(state.length), tree=state.tree.map(lambda x: x[None]),
                          done=one(state.done), temperature=one(state.temperature),
                          gen=None if state.gen is None else (state.gen,))


def _as_single(state: EngineState) -> EngineState:
    """The batch of one back as a one-sequence state (views)."""
    first = lambda x: None if x is None else x[0]
    return state._replace(length=first(state.length), tree=state.tree.map(first),
                          done=first(state.done), temperature=first(state.temperature),
                          gen=first(state.gen))


def _target_feats(res: transformer.ForwardResult, version: int) -> torch.Tensor:
    """Draft input features: v3 = fused 3-tap, v1 = post-final-norm hidden."""
    return res.taps if version == 3 else res.hidden


def upload(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array on `device` without a host sync: through pinned memory
    and a non-blocking copy on the card (the caching host allocator keeps
    the pinned block until the copy has run)."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


def _to_device(tree, device):
    """A parameter tree on `device`; the tree itself when it is there already
    (an engine's siblings share its parameter dicts)."""
    if isinstance(tree, dict):
        out = {k: _to_device(v, device) for k, v in tree.items()}
    elif isinstance(tree, list):
        out = [_to_device(v, device) for v in tree]
    else:
        return tree.to(device)
    items = zip(out.values(), tree.values()) if isinstance(tree, dict) else zip(out, tree)
    return tree if all(a is b for a, b in items) else out


class EagleEngine:
    """Owns params + configs and runs greedy speculative decoding."""

    def __init__(self, params: dict, cfg: ModelConfig, dparams: dict,
                 dcfg: DraftConfig, ecfg: EngineConfig,
                 eos_token_id: Optional[int] = None, sp_mesh=None,
                 device=None):
        self.device = resolve_device(device)
        if ecfg.kv_quant not in ("none", "int8"):
            raise ValueError(f"unknown kv_quant {ecfg.kv_quant!r} "
                             "(expected 'none' | 'int8')")
        if ecfg.draft_quant not in ("none", "int8", "int4"):
            # a typo here would silently serve the unquantized draft while
            # reporting a quantized operating point
            raise ValueError(f"unknown draft_quant {ecfg.draft_quant!r} "
                             "(expected 'none' | 'int8' | 'int4')")
        if ecfg.acceptance not in ("q1", "true_q", "true_q_dynamic"):
            raise ValueError(f"unknown acceptance {ecfg.acceptance!r} "
                             "(expected 'q1' | 'true_q' | 'true_q_dynamic')")
        if sp_mesh is not None:
            raise NotImplementedError("sequence-parallel prefill (sp_mesh) is "
                                      "not ported yet")
        transformer.check_supported(cfg)
        self.params, self.cfg = _to_device(params, self.device), cfg
        self.eos_token_id = eos_token_id
        dparams = _to_device(dparams, self.device)
        if ecfg.fuse_draft:
            # concat q|k|v and gate|up before (possible) quantization: the
            # beam loop then streams one tensor per group of projections
            dparams = draft_mod.fuse_projections(dparams)
        if ecfg.draft_quant == "int8":
            dparams = quantize_draft_params(dparams)
        elif ecfg.draft_quant == "int4":
            dparams = quantize_draft_params4(dparams, group=ecfg.draft_quant_group)
        self.dparams, self.dcfg, self.ecfg = dparams, dcfg, ecfg
        if ecfg.tree_paths is not None:
            self.static_spec = StaticTreeSpec(ecfg.tree_paths)
            self.path_len = self.static_spec.max_depth + 2
        else:
            self.static_spec = None
            self.path_len = ecfg.depth + 2
        # rows that must stay free past the committed context for one round:
        # the commit window, plus a 16-row margin under compact_impl="pallas".
        # The margin was inherited from the TPU kernel's 8-row Mosaic staging;
        # the CUDA kernel does not need it, but keeping the formula keeps both
        # engines' capacity stops (and so their output lengths) the same.
        self._tail = (max(self.path_len + 1, 16) if ecfg.compact_impl == "pallas"
                      else self.path_len + 1)
        # a v1 draft scores with the target's lm_head, which may be a
        # quantized dict
        if dcfg.version == 1:
            self._lm_head_w = (self.params["embed"]["w"].t() if cfg.tie_embeddings
                               else self.params["lm_head"])
        else:
            self._lm_head_w = None
        # the row-exact route (fault C6): on the card an f32 engine with the
        # tree kernel and a float cache runs every target attention through
        # it, so a row's attention never depends on the other rows of its call
        self._row_exact = (self.device.type == "cuda" and cfg.dtype == torch.float32
                           and cfg.attn_impl == "pallas_tree" and ecfg.kv_quant == "none")
        self._causal_masks: dict = {}

    @classmethod
    def from_pretrained(cls, base_model_path: str, ea_model_path: str,
                        use_eagle3: bool = False, total_tokens: int = 60,
                        depth: int = 5, top_k: int = 10, max_len: int = 2048,
                        temperature: float = 0.0,
                        eos_token_id: Optional[int] = None,
                        dtype=torch.bfloat16,
                        target_quant: Optional[str] = None,
                        draft_quant: Optional[str] = None,
                        kv_quant: Optional[str] = None,
                        quant_group: int = 128, mesh=None,
                        device=None) -> "EagleEngine":
        """Load target and draft checkpoints from local HF directories and
        build an engine on `device` ("cuda" unless the caller passes "cpu").

        target_quant: None | "int8" | "int4", weight-only target quantization
        on load (outputs are bit-exact against the quantized target's own
        vanilla decode). draft_quant: the same choices for the draft head
        (lossless). kv_quant: None | "int8". quant_group: int4 scale-group
        size along K. total_tokens = -1 tunes the tree size with
        `calibrate_total_tokens`. temperature > 0 builds a sampled engine. A
        mesh raises."""
        from ..models.hf_loader import load_draft, load_target

        if mesh is not None:
            raise NotImplementedError("tensor-parallel loading (mesh) is not "
                                      "ported yet")
        device = resolve_device(device)
        params, cfg = load_target(base_model_path, dtype=dtype, device=device)
        dparams, dcfg = load_draft(ea_model_path, version=3 if use_eagle3 else 1,
                                   dtype=dtype, target_embed=params["embed"]["w"],
                                   device=device)
        if target_quant == "int8":
            params = quantize_target_params(params)
        elif target_quant == "int4":
            params = quantize_target_params4(params, group=quant_group)
        if total_tokens == -1:
            total_tokens = calibrate_total_tokens(
                params, cfg, max_len=max_len, kv_quant=kv_quant or "none",
                device=device)
        ecfg = EngineConfig(total_tokens=total_tokens, depth=depth, top_k=top_k,
                            max_len=max_len, temperature=temperature,
                            draft_quant=draft_quant or "none",
                            kv_quant=kv_quant or "none")
        return cls(params, cfg, dparams, dcfg, ecfg, eos_token_id=eos_token_id,
                   device=device)

    def _sibling(self, **ecfg_changes) -> "EagleEngine":
        """New engine that shares every parameter tensor, with an
        EngineConfig delta. dparams were quantized by our own __init__: the
        sibling must not quantize them again."""
        ecfg = dataclasses.replace(self.ecfg, draft_quant="none", **ecfg_changes)
        return EagleEngine(self.params, self.cfg, self.dparams, self.dcfg, ecfg,
                           eos_token_id=self.eos_token_id, device=self.device)

    def with_sampling(self, sampled: bool) -> "EagleEngine":
        """Sibling engine sharing all params, greedy (sampled=False) or
        sampled at temperature 1.0 (sampled=True); `self` when it already is.
        A sampled engine takes any request temperature t > 0 as data."""
        if (self.ecfg.temperature > 0) == bool(sampled):
            return self
        return self._sibling(temperature=1.0 if sampled else 0.0)

    def with_tree(self, total_tokens: Optional[int] = None,
                  depth: Optional[int] = None,
                  top_k: Optional[int] = None) -> "EagleEngine":
        """Sibling engine sharing all params at another speculation-tree
        operating point. Greedy output does not depend on the tree size, so
        swapping trees changes throughput only."""
        changes = {k: v for k, v in dict(total_tokens=total_tokens, depth=depth,
                                         top_k=top_k).items() if v is not None}
        if not changes:
            return self
        if self.static_spec is not None:
            raise ValueError(
                "with_tree tunes dynamic trees; static topologies are fixed "
                "by EngineConfig.tree_paths — build a new engine instead")
        return self._sibling(**changes)

    # ------------------------------------------------------------------
    # cache allocation
    # ------------------------------------------------------------------

    def _bucket(self, n: int) -> int:
        """Prompt padding bucket (quantum capped by max_len), as in JAX."""
        quantum = min(128, self.ecfg.max_len)
        return max(quantum, -(-n // quantum) * quantum)

    def _tgt_len(self) -> int:
        """Target KV rows: max_len + tree scratch (+ the compaction margin),
        rounded up to a multiple of 128 (the JAX formula, kept as it is)."""
        e = self.ecfg
        margin = 16 if e.compact_impl == "pallas" else 0
        return -(-(e.max_len + e.tree_size + margin) // 128) * 128

    def init_target_cache(self, batch: int = 1, rows: Optional[int] = None) -> KVCache:
        """Target KV of the full size, or of `rows` rows (the paged server's
        prompt scratch, which holds only the prefill before its page scatter)."""
        c = self.cfg
        return init_cache(c.num_layers, batch, c.num_kv_heads,
                          self._tgt_len() if rows is None else rows,
                          c.head_dim, dtype=c.dtype, device=self.device,
                          kv_quant=self.ecfg.kv_quant)

    def init_draft_cache(self, batch: int = 1) -> KVCache:
        """The draft cache stays in the draft's dtype whatever kv_quant is."""
        e, d = self.ecfg, self.dcfg
        # draft scratch past the committed pairs: beam rows (dynamic) or tree
        # rows (static), + extension-window padding
        scratch = (e.tree_size if self.static_spec is not None
                   else max((e.depth + 1) * e.top_k, e.tree_size))
        dft_len = e.max_len + scratch + self.path_len
        return init_cache(d.num_layers if d.version == 1 else 1, batch,
                          d.num_kv_heads, dft_len, d.head_dim, dtype=d.dtype,
                          device=self.device)

    def init_caches(self, batch: int = 1) -> tuple[KVCache, KVCache]:
        return self.init_target_cache(batch), self.init_draft_cache(batch)

    # ------------------------------------------------------------------
    # speculative path
    # ------------------------------------------------------------------

    @property
    def sampled(self) -> bool:
        return self.ecfg.temperature > 0

    def _fresh_mask(self, T: int, S: int, start: torch.Tensor):
        """The mask of T fresh rows appended at `start` ([B]) to a cache of S
        rows: the dense causal mask, or, on the row-exact route, a causal
        TreeMaskSpec over the T fresh keys, which the tree kernel takes as it
        takes a verify's tree. Each row then sees the cache rows below its
        start and the fresh keys up to its own, as a verify row sees its
        ancestors, so prefills in any chunks, one-token steps and verifies
        give a row the same attention bits."""
        if not self._row_exact:
            return prefill_mask(T, S, start)
        B = start.shape[0]
        m = self._causal_masks.get((B, T))
        if m is None:
            m = torch.ones((T, T), dtype=torch.bool, device=self.device).tril()
            m = self._causal_masks[(B, T)] = m.expand(B, T, T).contiguous()
        return TreeMaskSpec(tree_mask=m, start=start)

    def _draws(self, gens, shape, low: float = 0.0) -> torch.Tensor:
        """[B, *shape] uniforms in [low, 1): row b's from its own generator,
        in the shape a one-sequence request draws (the one loop over the
        batch on a round's path)."""
        return torch.stack([uniform(g, shape, self.device, low) for g in gens])

    def _noise(self, gens):
        """The drafter's noise for a batch: Gumbel uniforms from each row's
        generator (None on a greedy engine)."""
        if gens is None:
            return None
        return lambda shape: self._draws(gens, shape[1:], U_MIN)

    def _draft_round(self, ext_tokens, ext_feats, n_new, dcache, temperature=None,
                     gens=None):
        """The next draft tree of every row of a batch."""
        noise = self._noise(gens)
        if self.static_spec is not None:
            return draft_round_static(self.dparams, self.dcfg, self.static_spec,
                                      ext_tokens, ext_feats, n_new, dcache,
                                      self._lm_head_w, ecfg=self.ecfg, noise=noise,
                                      temperature=temperature)
        return draft_round(self.dparams, self.dcfg, self.ecfg, ext_tokens,
                           ext_feats, n_new, dcache, self._lm_head_w, noise=noise,
                           temperature=temperature)

    def _pick_tokens(self, logits: torch.Tensor, temperature=None, gens=None) -> torch.Tensor:
        """logits [B, V] → one token a row. Greedy: the argmax. Sampled: a
        draw from the processed distribution at the row's temperature
        (floored at 1e-4), from the row's generator."""
        if not self.sampled:
            return torch.argmax(logits, dim=-1)
        e = self.ecfg
        p = torch.softmax(process_logits(logits, temperature.clamp_min(1e-4)[:, None],
                                         e.sampling_top_k, e.top_p), dim=-1)
        return categorical(p, self._draws(gens, p.shape[1:], U_MIN))

    def _requests(self, temperature, seed: int, batch: int):
        """A sampled request's (temperatures [B] on the device, one generator
        a row on the engine's device, row i's seeded with `seed + i`);
        (None, None) on a greedy engine. `temperature`: None (the engine's),
        one value for every row, or one a row."""
        if not self.sampled:
            return None, None
        t = self.ecfg.temperature if temperature is None else temperature
        t = np.asarray(t, np.float32).reshape(-1)
        if t.size not in (1, batch):
            raise ValueError(f"need one temperature, or one per row ({batch}), got {t.size}")
        gens = []
        for i in range(batch):
            gen = torch.Generator(device=self.device)
            gen.manual_seed(int(seed) + i)
            gens.append(gen)
        return upload(np.broadcast_to(t, (batch,)).copy(), self.device), tuple(gens)

    def _prefill_rows(self, tokens: torch.Tensor, prompt_lens: torch.Tensor,
                      cache: KVCache, dcache: KVCache,
                      ref: Optional[torch.Tensor] = None,
                      temperature: Optional[torch.Tensor] = None,
                      gens=None) -> EngineState:
        """Prompt prefill + first draft tree of a batch. tokens: [B, Tp],
        prompts padded to one bucket; prompt_lens: [B] on the device (row b
        reads only its first prompt_lens[b] rows: the mask is causal and the
        draft's pending root sits at prompt_lens[b] - 1); ref: [B, S] forced
        replay; temperature: [B]; gens: one generator a row. A sampled engine
        draws each row's root token, then the draft's noise."""
        dev = self.device
        B, Tp = tokens.shape
        S = cache.max_len
        pos = torch.arange(Tp, device=dev)[None].expand(B, Tp)
        res = transformer.forward(self.params, self.cfg, tokens, cache, pos,
                                  self._fresh_mask(Tp, S, cache.length))
        last = _rows(res.hidden, (prompt_lens - 1)[:, None])[:, 0]
        root = self._pick_tokens(transformer.lm_head(self.params, self.cfg, last),
                                 temperature, gens)
        if ref is not None:  # forced replay: the first token is pinned too
            root = ref.gather(1, prompt_lens[:, None])[:, 0]
        cache = with_length(res.cache, prompt_lens)
        feats = _target_feats(res, self.dcfg.version)
        ext_tokens = torch.cat([tokens[:, 1:], torch.zeros((B, 1), dtype=torch.long,
                                                           device=dev)], 1)
        ext_tokens.scatter_(1, (prompt_lens - 1)[:, None], root[:, None])
        dr = self._draft_round(ext_tokens, feats, prompt_lens, dcache, temperature, gens)
        tokens_buf = torch.zeros((B, S), dtype=torch.long, device=dev)
        tokens_buf[:, :Tp] = tokens
        return EngineState(tokens=tokens_buf, length=prompt_lens, cache=cache,
                           dcache=dr.dcache, tree=dr.tree,
                           done=torch.zeros(B, dtype=torch.bool, device=dev),
                           temperature=temperature, gen=gens)

    def _extend(self, tokens: torch.Tensor, n_new: int, start: int, state: EngineState,
                temperature: Optional[torch.Tensor] = None, gens=None) -> EngineState:
        """Incremental prefill: append context to a committed batch-of-one
        state (multi-turn KV reuse, chunked prefill).

        tokens: [1, Te] padded window on the device whose row 0 is the
        already-committed token at position `start` (the resume point - 1)
        and rows 1 .. n_new - 1 the appended context. Re-running the
        boundary row reproduces its target features (its draft pair's input
        token was the previous turn's uncommitted bonus, not the new
        context's first token) and rewrites its target K/V row with the same
        values. `start` may be below state.length (a rewind: rows past it
        are overwritten or masked by length). A sampled engine draws the
        root token, then the draft's noise, from `gens` at `temperature`
        ([1]). Returns a state of length start + n_new whose next round
        continues as a prefill of the whole context would."""
        dev = self.device
        Te = tokens.shape[1]
        st = torch.full((1,), start, dtype=torch.long, device=dev)
        cache = with_length(state.cache, st)
        pos = (start + torch.arange(Te, device=dev))[None]
        res = transformer.forward(self.params, self.cfg, tokens, cache, pos,
                                  self._fresh_mask(Te, cache.max_len, st))
        root = self._pick_tokens(transformer.lm_head(self.params, self.cfg,
                                                     res.hidden[:, n_new - 1]),
                                 temperature, gens)
        new_len = st + n_new
        ext_tokens = torch.cat([tokens[:, 1:], torch.zeros((1, 1), dtype=torch.long,
                                                           device=dev)], 1)
        ext_tokens[:, n_new - 1] = root
        dr = self._draft_round(ext_tokens, _target_feats(res, self.dcfg.version),
                               new_len - st, with_length(state.dcache, st), temperature,
                               gens)
        state.tokens[:, start: start + Te] = tokens
        return EngineState(tokens=state.tokens, length=new_len,
                           cache=with_length(res.cache, new_len), dcache=dr.dcache,
                           tree=dr.tree, done=torch.zeros(1, dtype=torch.bool, device=dev),
                           temperature=temperature, gen=gens)

    def _round(self, state: EngineState, ref: Optional[torch.Tensor] = None,
               kv_limit: Optional[int] = None):
        """One speculative decode round, with no host sync, of one sequence
        or of a batch (EngineState.batched).

        ref (optional): forced-replay reference, a [S] token buffer ([B, S]
        for a batch); acceptance and the bonus token follow it instead of
        the live argmax.

        kv_limit: run the round against only the first `kv_limit` KV rows,
        valid whenever committed length + tree + commit window fit inside it
        (EngineConfig.kv_buckets). The plain attention then reads the bucket
        and not the whole preallocated cache; the tree-attention kernel only
        ever reads the committed rows. The small cache is a view, so nothing
        is copied back.
        """
        if state.batched:
            return self._round_rows(state, ref, kv_limit, batched=True)
        new, out = self._round_rows(_as_batch(state), None if ref is None else ref[None],
                                    kv_limit, batched=False)
        return _as_single(new), RoundOutput(*(x[0] for x in out))

    def _round_rows(self, state: EngineState, ref: Optional[torch.Tensor],
                    kv_limit: Optional[int], batched: bool):
        """`_round` over the batch's B rows. `batched` (as in JAX): the
        compaction kernel runs only when it is False, for one sequence's
        request held as a batch of one (the host loops of `generate`,
        `generate_stream` and `generate_fused`)."""
        if kv_limit is not None and kv_limit < state.cache.max_len:
            small = state._replace(cache=slice_rows(state.cache, kv_limit))
            new_small, out = self._round_rows(small, ref, None, batched)
            merged = merge_rows_window(state.cache, new_small.cache,
                                       state.cache.length,
                                       self.ecfg.tree_size + self._tail)
            return new_small._replace(cache=merged), out
        e, tree = self.ecfg, state.tree
        dev = self.device
        Lc = state.length
        B = Lc.shape[0]
        P = self.path_len

        # --- target tree verification (the mask goes in as metadata)
        with record_function("round.verify"):
            vmask = TreeMaskSpec(tree_mask=tree.mask, start=state.cache.length)
            pos = Lc[:, None] + tree.positions
            res = transformer.forward(self.params, self.cfg, tree.tokens,
                                      state.cache, pos, vmask)
            logits = transformer.lm_head(self.params, self.cfg, res.hidden)   # [B, N, V]
            feats = _target_feats(res, self.dcfg.version)

        # --- acceptance
        with record_function("round.accept"):
            if self.sampled:
                # each row's draws, in order: acceptance, bonus, draft
                temp = state.temperature.clamp_min(1e-4)
                u = self._draws(state.gen, (P - 1, tree.children.shape[-1]))
                rule = (accept_mod.accept_sampled if tree.node_probs is None
                        else accept_mod.accept_sampled_true_q)
                acc = rule(tree, logits, u, e, P, temperature=temp[:, None, None])
                bonus = categorical(acc.sample_p,
                                    self._draws(state.gen, acc.sample_p.shape[1:], U_MIN))
            elif ref is not None:
                ref_next = ref.gather(1, windows(Lc + 1, P, ref.shape[1]))
                acc = accept_mod.accept_greedy(tree, logits, P, ref_next=ref_next)
                bonus = ref_next.gather(1, acc.accept_len[:, None])[:, 0]
            else:
                acc = accept_mod.accept_greedy(tree, logits, P)
                # the vanilla rule, argmax of the final node's logits (path
                # repeats it past the accepted length): an argmax after the
                # softmax would tie two logits one ulp apart
                bonus = torch.argmax(_rows(logits, acc.path[:, -1:])[:, 0], dim=-1)

        # --- commit tokens + compact KV
        with record_function("round.commit"):
            path_tokens = tree.tokens.gather(1, acc.path)           # [B, P]
            n_acc = torch.where(state.done, 0, acc.accept_len + 1)
            state.tokens.scatter_(1, windows(Lc, P, state.tokens.shape[1]), path_tokens)
            # the compaction kernel moves raw float rows of one sequence: an
            # int8 cache and a batch take the plain version, which moves
            # payload and scales
            if e.compact_impl == "pallas" and e.kv_quant == "none" and not batched:
                ck, cv = compact_rows(res.cache.k, res.cache.v, acc.path[0], Lc[0])
                cache = KVCache(k=ck, v=cv, length=Lc + n_acc)
            else:
                cache = compact_accepted(with_length(res.cache, Lc), acc.path, n_acc)
            done = state.done
            if self.eos_token_id is not None:
                in_window = torch.arange(P, device=dev) < n_acc[:, None]
                done = done | ((path_tokens == self.eos_token_id) & in_window).any(-1)
            # capacity stop: no room for another round's tree + commit window
            done = done | (Lc + n_acc + self._tail + e.tree_size >= self._tgt_len())

        # --- next draft tree
        with record_function("round.draft"):
            ext_tokens = torch.cat([path_tokens[:, 1:],
                                    torch.zeros((B, 1), dtype=torch.long, device=dev)], 1)
            ext_tokens = torch.where(torch.arange(P, device=dev) == acc.accept_len[:, None],
                                     bonus[:, None], ext_tokens)
            dr = self._draft_round(ext_tokens, _rows(feats, acc.path), n_acc,
                                   state.dcache, state.temperature, state.gen)

        new_state = state._replace(length=Lc + n_acc, cache=cache, dcache=dr.dcache,
                                   tree=dr.tree, done=done)
        return new_state, RoundOutput(new_tokens=path_tokens,
                                      accept_len=n_acc - 1, done=done,
                                      live_match=acc.live_match)

    def _start(self, prompt_ids, temperature=None, ref=None, seed: int = 0):
        """One sequence's prefill as a one-sequence state, for `_round`:
        (prompt [1, Lp], Lp, state). The host loops hold it as a batch of
        one (`_start_batch`) instead."""
        lens, state = self._start_batch([prompt_ids], temperature,
                                        None if ref is None else ref[None], seed)
        return np.asarray(prompt_ids, np.int64).reshape(1, -1), lens[0], _as_single(state)

    def _host_rounds(self, prompt_ids, max_new_tokens, eos_token_id, temperature,
                     seed):
        """The per-round host loop behind `generate` and `generate_stream`:
        yields (all ids so far as a list, this round's accept_len) after every
        round, one sync per round."""
        _, state = self._start_batch([prompt_ids], temperature, None, seed)
        out = list(np.asarray(prompt_ids, np.int64).ravel())
        new_tokens = 0
        with torch.no_grad():
            while new_tokens < max_new_tokens:
                state, r = self._round_rows(state, None, None, batched=False)
                alen = int(r.accept_len)
                if alen < 0:      # device-side finish flag tripped
                    break
                stop = False
                for t in r.new_tokens[0, : alen + 1].cpu().numpy():
                    out.append(int(t))
                    new_tokens += 1
                    if (eos_token_id is not None and t == eos_token_id) or \
                            new_tokens >= max_new_tokens:
                        stop = True
                        break
                yield out, alen
                if stop or len(out) + self.path_len + 1 >= self.ecfg.max_len:
                    break

    def generate(self, prompt_ids, max_new_tokens: int = 512,
                 eos_token_id: Optional[int] = None, seed: int = 0,
                 log: bool = False, details: bool = False,
                 temperature: Optional[float] = None):
        """Speculative generation with a per-round host loop. Returns np token
        ids (prompt + completion); log=True also (new_tokens, rounds);
        details=True returns (ids, stats-dict). A sampled engine draws from
        a generator seeded with `seed` at `temperature` (default: the
        engine's)."""
        out = list(np.asarray(prompt_ids, np.int64).ravel())
        accept_lens = []
        for out, alen in self._host_rounds(prompt_ids, max_new_tokens,
                                           eos_token_id, temperature, seed):
            accept_lens.append(alen)
        new_tokens = len(out) - np.asarray(prompt_ids).size
        rounds = len(accept_lens)
        if details:
            return np.asarray(out), {"new_tokens": new_tokens, "rounds": rounds,
                                     "accept_lens": accept_lens}
        if log:
            return np.asarray(out), new_tokens, rounds
        return np.asarray(out)

    def generate_stream(self, prompt_ids, max_new_tokens: int = 512,
                        eos_token_id: Optional[int] = None, seed: int = 0,
                        temperature: Optional[float] = None):
        """Streaming speculative generation: yields (all_ids_so_far,
        round_stats) after every decode round, for token-streaming front
        ends. One host sync per yielded round. `seed` and `temperature` as in
        `generate`."""
        n_prompt = np.asarray(prompt_ids).size
        rounds = 0
        for out, alen in self._host_rounds(prompt_ids, max_new_tokens,
                                           eos_token_id, temperature, seed):
            rounds += 1
            yield np.asarray(out), {"new_tokens": len(out) - n_prompt,
                                    "rounds": rounds, "accept_len": alen}

    # ------------------------------------------------------------------
    # length-bucketed decode reads (EngineConfig.kv_buckets)
    # ------------------------------------------------------------------

    def _kv_buckets(self):
        """Ascending KV-row buckets ending at the full cache size."""
        if not self.ecfg.kv_buckets:
            return None
        full = self._tgt_len()
        bs = sorted(b for b in self.ecfg.kv_buckets if b < full)
        return tuple(bs) + (full,)

    def _bucket_index(self, length: int, buckets) -> int:
        """Smallest bucket holding the committed context + one round's tree
        and commit window. The same formula gates the fused vanilla loop, so
        both paths see the same attention extents at the same lengths (greedy
        bit-exactness is preserved under bucketing). `length` is a host int."""
        need = length + self.ecfg.tree_size + self._tail
        return sum(need > b for b in buckets[:-1])

    def _kv_limit(self, length: int) -> Optional[int]:
        buckets = self._kv_buckets()
        return None if buckets is None else buckets[self._bucket_index(length, buckets)]

    def _trim_overshoot(self, seq: np.ndarray, prompt_len: int,
                        max_new_tokens: int) -> np.ndarray:
        limit = prompt_len + max_new_tokens
        if self.eos_token_id is not None:
            hits = np.nonzero(seq[prompt_len:] == self.eos_token_id)[0]
            if hits.size:
                limit = min(limit, prompt_len + int(hits[0]) + 1)
        return seq[:limit]

    def _make_ref_buf(self, ft, prompt_row, max_new_tokens: int,
                      label: str = "force_tokens") -> np.ndarray:
        """Validate one forced-replay reference and zero-pad it to the full
        cache length."""
        if self.ecfg.temperature != 0.0:
            raise ValueError(f"{label} requires a greedy engine")
        ft = np.asarray(ft, np.int64).ravel()
        Lp = len(prompt_row)
        if not np.array_equal(ft[:Lp], np.asarray(prompt_row, np.int64)):
            raise ValueError(f"{label} must start with the prompt")
        need = Lp + max_new_tokens + self.path_len + 1
        if ft.size < need:
            raise ValueError(f"{label} too short: {ft.size} < {need} "
                             "(prompt + budget + one round's commit window)")
        buf = np.zeros((self._tgt_len(),), np.int64)
        n = min(ft.size, buf.size)
        buf[:n] = ft[:n]
        return buf

    def generate_fused(self, prompt_ids, max_new_tokens: int = 512,
                       seed: int = 0, log: bool = False,
                       temperature: Optional[float] = None,
                       force_tokens=None):
        """Speculative generation whose host loop syncs once per round (the
        stop flag and the committed length, one transfer). May overshoot
        max_new_tokens by up to one round's window, trimmed host-side. With
        `kv_buckets` every round runs against the smallest bucket that holds
        its context. force_tokens: forced-replay reference starting with the
        prompt (greedy engines only); with log=True returns (ids, committed,
        rounds, live_match), else with log=True (ids, committed, rounds).
        `seed` and `temperature` as in `generate`: sampling adds no sync."""
        ref = None
        if force_tokens is not None:
            prompt_row = np.asarray(prompt_ids, np.int64).ravel()
            ref = torch.from_numpy(self._make_ref_buf(
                force_tokens, prompt_row, max_new_tokens))[None].to(self.device)
        (Lp,), state = self._start_batch([prompt_ids], temperature, ref, seed)
        rounds = 0
        hits = torch.zeros((1,), dtype=torch.long, device=self.device)
        with torch.no_grad():
            while True:
                # the round's one sync: the stop flag and the length together
                done, length = torch.cat(
                    [state.done.to(torch.long), state.length]).tolist()
                if done or length - Lp >= max_new_tokens:
                    break
                state, r = self._round_rows(state, ref, self._kv_limit(length),
                                            batched=False)
                rounds += 1
                hits = hits + r.live_match
            toks = state.tokens[0, :length].cpu().numpy()
        out = self._trim_overshoot(toks, Lp, max_new_tokens)
        if log and ref is not None:
            return out, length - Lp, rounds, int(hits)
        if log:
            return out, length - Lp, rounds
        return out

    # ------------------------------------------------------------------
    # batched speculative generation
    # ------------------------------------------------------------------

    def _start_batch(self, prompts, temperature, refs=None, seed: int = 0):
        """Prefill of a batch: ragged prompts padded to the bucket of the
        longest. Returns (prompt lengths, the batch's EngineState)."""
        if len(prompts) == 0:
            raise ValueError("need at least one prompt")
        lens = [len(np.asarray(p).ravel()) for p in prompts]
        Tp = self._bucket(max(lens))
        padded = np.zeros((len(prompts), Tp), np.int64)
        for i, p in enumerate(prompts):
            padded[i, : lens[i]] = np.asarray(p, np.int64).ravel()
        cache, dcache = self.init_caches(len(prompts))
        temps, gens = self._requests(temperature, seed, len(prompts))
        with torch.no_grad():
            state = self._prefill_rows(
                torch.from_numpy(padded).to(self.device),
                torch.tensor(lens, dtype=torch.long, device=self.device), cache, dcache,
                ref=refs, temperature=temps, gens=gens)
        return lens, state

    def generate_batch_fused(self, prompts, max_new_tokens: int = 512,
                             seed: int = 0, temperature=None,
                             force_tokens=None, log: bool = False):
        """Batched speculative generation whose host loop syncs once per round
        (whether any row is live and the longest row's length, one transfer):
        every round runs all rows, finished ones committing nothing, until
        each has met its budget, EOS or the capacity stop; each row's
        overshoot past max_new_tokens is trimmed host-side. With `kv_buckets`
        a round runs against the bucket of the longest row.

        prompts: list of 1-D token arrays (ragged). temperature: None, one
        value, or one per row (sampled engines); row i draws from a generator
        seeded with `seed + i`. force_tokens (greedy engines only): one
        forced-replay reference per prompt, each starting with its prompt.
        log=True returns (outs, committed, rounds): per-row committed token
        counts (untrimmed) and the number of batch rounds."""
        B = len(prompts)
        refs = None
        if force_tokens is not None:
            if len(force_tokens) != B:
                raise ValueError("need one force_tokens row per prompt")
            refs = torch.from_numpy(np.stack([
                self._make_ref_buf(ft, np.asarray(prompts[i]).ravel(), max_new_tokens,
                                   label=f"force_tokens[{i}]")
                for i, ft in enumerate(force_tokens)])).to(self.device)
        lens, state = self._start_batch(prompts, temperature, refs, seed)
        L0 = state.length
        rounds = 0
        with torch.no_grad():
            while True:
                # the round's one sync: any row live, and the longest row
                live, longest = torch.stack([(~state.done).any().to(torch.long),
                                             state.length.max()]).tolist()
                if not live:
                    break
                state, _ = self._round(state, ref=refs, kv_limit=self._kv_limit(longest))
                rounds += 1
                state = state._replace(done=state.done | (state.length - L0 >= max_new_tokens))
            toks = state.tokens.cpu().numpy()
            lengths = state.length.tolist()
        outs = [self._trim_overshoot(toks[i, : lengths[i]], lens[i], max_new_tokens)
                for i in range(B)]
        if log:
            return outs, [lengths[i] - lens[i] for i in range(B)], rounds
        return outs

    def generate_batch(self, prompts, max_new_tokens: int = 512, seed: int = 0,
                       temperature=None):
        """Batched speculative generation with a per-round host loop and
        per-row finish flags: every row keeps its own ragged accept lengths
        and KV length, and finished rows stop committing. Early finish on
        EOS needs the engine's `eos_token_id`. Each row's in-round overshoot
        past max_new_tokens is trimmed, so a row equals its one-sequence
        `generate`. `seed`, `temperature` as in `generate_batch_fused`.
        Returns a list of np arrays (prompt + completion)."""
        B = len(prompts)
        lens, state = self._start_batch(prompts, temperature, None, seed)
        outs = [list(np.asarray(p, np.int64).ravel()) for p in prompts]
        new_counts = [0] * B
        done = [False] * B
        eos = self.eos_token_id
        with torch.no_grad():
            while not all(done):
                state, r = self._round(state)
                # one transfer: accept lengths, device finish flags, tokens
                rows = torch.cat([r.accept_len[:, None], r.done[:, None].to(torch.long),
                                  r.new_tokens], 1).cpu().numpy()
                for i in range(B):
                    if done[i]:
                        continue
                    for t in rows[i, 2: rows[i, 0] + 3]:
                        if new_counts[i] >= max_new_tokens:
                            done[i] = True
                            break
                        outs[i].append(int(t))
                        new_counts[i] += 1
                        if eos is not None and t == eos:
                            done[i] = True
                            break
                    if new_counts[i] >= max_new_tokens or rows[i, 1] or \
                            len(outs[i]) + self.path_len + 1 >= self.ecfg.max_len:
                        done[i] = True
        return [np.asarray(o) for o in outs]

    # ------------------------------------------------------------------
    # vanilla baseline
    # ------------------------------------------------------------------

    def _vanilla_step(self, cache: KVCache, token: torch.Tensor,
                      kv_limit: Optional[int] = None, temperature=None, gens=None):
        """One token of the baseline: (cache, next token as a device scalar);
        temperature [1] and gens (one generator) as `_requests` gives them."""
        if kv_limit is not None and kv_limit < cache.max_len:
            new_small, nxt = self._vanilla_step(slice_rows(cache, kv_limit), token,
                                                temperature=temperature, gens=gens)
            # a vanilla step appends one row at `length`, through the view
            return merge_rows_window(cache, new_small, cache.length, 1), nxt
        S = cache.max_len
        pos = cache.length.reshape(1, 1)
        res = transformer.forward(self.params, self.cfg, token.reshape(1, 1),
                                  cache, pos, self._fresh_mask(1, S, cache.length))
        logits = transformer.lm_head(self.params, self.cfg, res.hidden[:, 0])
        return res.cache, self._pick_tokens(logits, temperature, gens)[0]

    def _vanilla_prefill(self, prompt_ids, temperature, seed):
        """Prompt forward of the baseline: (prompt [1, Lp], Lp, cache, first
        token as a device scalar, the request's (temperature [1], generators)
        from `_requests`)."""
        request = self._requests(temperature, seed, 1)
        prompt = np.asarray(prompt_ids, np.int64).reshape(1, -1)
        Lp = prompt.shape[1]
        Tp = self._bucket(Lp)
        padded = np.zeros((1, Tp), np.int64)
        padded[0, :Lp] = prompt
        dev = self.device
        cache = self.init_target_cache()
        toks = torch.from_numpy(padded).to(dev)
        res = transformer.forward(self.params, self.cfg, toks, cache,
                                  torch.arange(Tp, device=dev)[None],
                                  self._fresh_mask(Tp, cache.max_len, cache.length))
        logits = transformer.lm_head(self.params, self.cfg, res.hidden[:, Lp - 1])
        token = self._pick_tokens(logits, *request)[0]
        cache = with_length(res.cache, torch.full((1,), Lp, dtype=torch.long, device=dev))
        return prompt, Lp, cache, token, request

    def generate_vanilla_stream(self, prompt_ids, max_new_tokens: int = 512,
                                eos_token_id: Optional[int] = None, seed: int = 0,
                                temperature: Optional[float] = None):
        """Streaming vanilla decoding: yields (all_ids_so_far, stats) per
        token, one host sync each. `seed` and `temperature` as in `generate`."""
        with torch.no_grad():
            prompt, _, cache, token, request = self._vanilla_prefill(prompt_ids,
                                                                     temperature, seed)
            out = list(prompt[0])
            for n in range(max_new_tokens):
                t = int(token)
                out.append(t)
                yield np.asarray(out), {"new_tokens": n + 1, "rounds": n + 1,
                                        "accept_len": 0}
                if eos_token_id is not None and t == eos_token_id:
                    break
                if len(out) + 1 >= self.ecfg.max_len:
                    break
                cache, token = self._vanilla_step(cache, token, None, *request)

    def generate_vanilla(self, prompt_ids, max_new_tokens: int = 512,
                         eos_token_id: Optional[int] = None, seed: int = 0,
                         fused: bool = False,
                         temperature: Optional[float] = None):
        """Plain autoregressive decoding (the baseline), greedy or, on a
        sampled engine, sampled (`seed` and `temperature` as in `generate`).
        fused=True keeps every token on the device until the end (no
        per-token sync) and, with `kv_buckets`, runs each step against the
        bucket that `_bucket_index` gives for its length, as `generate_fused`
        does."""
        if not fused:
            out = np.asarray(prompt_ids, np.int64).ravel()
            for out, _ in self.generate_vanilla_stream(
                    prompt_ids, max_new_tokens, eos_token_id, seed, temperature):
                pass
            return out
        with torch.no_grad():
            prompt, Lp, cache, token, request = self._vanilla_prefill(
                prompt_ids, temperature, seed)
            out = list(prompt[0])
            steps = [token][:max_new_tokens]
            for i in range(max_new_tokens - 1):
                cache, token = self._vanilla_step(cache, token, self._kv_limit(Lp + i),
                                                  *request)
                steps.append(token)
            for t in (torch.stack(steps).cpu().numpy() if steps else ()):
                out.append(int(t))
                if eos_token_id is not None and t == eos_token_id:
                    break
        return np.asarray(out)


def calibrate_total_tokens(params: dict, cfg: ModelConfig,
                           candidates=(40, 48, 50, 56, 60),
                           weights=(1.0, 1.05, 1.07, 1.1, 1.13),
                           max_len: int = 2048, reps: int = 20,
                           batch: int = 1, kv_quant: str = "none",
                           _debug_timings: Optional[list] = None,
                           device=None) -> int:
    """Auto-tune the tree size: time a target forward at each candidate
    token count and pick the weighted argmin. Larger trees raise the accepted
    length but lengthen the verify forward; the weights encode the gain per
    size step. batch > 1 calibrates a batched verify (B·n tokens through the
    target).

    `params` live on `device` ("cuda" unless the caller passes "cpu"). Each
    candidate is warmed once, then `reps` forwards are timed on the host
    clock between two device syncs."""
    device = resolve_device(device)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    timings = []
    with torch.no_grad():
        for n in candidates:
            cache = init_cache(cfg.num_layers, batch, cfg.num_kv_heads, max_len,
                               cfg.head_dim, dtype=cfg.dtype, device=device,
                               kv_quant=kv_quant)
            tokens = torch.zeros((batch, n), dtype=torch.long, device=device)
            pos = torch.arange(n, device=device)[None].expand(batch, n)

            def fwd():
                mask = prefill_mask(n, cache.max_len, cache.length)
                res = transformer.forward(params, cfg, tokens, cache, pos, mask)
                return transformer.lm_head(params, cfg, res.hidden[:, -1])

            fwd()                      # warm up
            sync()
            t0 = time.perf_counter()
            for _ in range(reps):
                fwd()
            sync()
            timings.append((time.perf_counter() - t0) / reps)
    if _debug_timings is not None:
        _debug_timings.extend(timings)
    scores = [t * w for t, w in zip(timings, weights)]
    return candidates[int(np.argmin(scores))]
