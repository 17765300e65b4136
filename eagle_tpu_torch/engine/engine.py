"""EagleEngine — speculative decoding, B = 1, on one device, greedy or sampled.

Port of eagle_tpu/engine/engine.py for the single-sequence engine:
`_prefill`, `_round` (tree verify → acceptance → KV compaction → next draft
tree), `generate`, `generate_fused`, `generate_stream`, the vanilla baseline
and its stream, `calibrate_total_tokens` and `from_pretrained`.
The JAX engine jits each round into one XLA program; here PyTorch runs
eagerly and a round keeps every offset on the device, so it never waits on
the host. `generate_fused` is a host loop whose only per-round sync reads
the stop flag and the committed length in one transfer.

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

Options not ported yet raise NotImplementedError: batched generation,
sp_mesh, a mesh in from_pretrained, MoE and sliding-window targets.
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
                            merge_rows_window, slice_rows, window, with_length)
from ..ops.masks import TreeMaskSpec, prefill_mask
from ..ops.quant import quantize_draft_params, quantize_target_params
from ..ops.quant4 import quantize_draft_params4, quantize_target_params4
from ..ops.tree import Tree
from . import accept as accept_mod
from .drafter import StaticTreeSpec, draft_round, draft_round_static
from .sampling import U_MIN, categorical, process_logits, uniform


class EngineState(NamedTuple):
    tokens: torch.Tensor   # [1, S] committed tokens (+ scratch tail)
    length: torch.Tensor   # scalar committed length
    cache: KVCache         # target KV
    dcache: KVCache        # draft KV (pairs)
    tree: Tree             # next tree to verify
    done: torch.Tensor     # scalar bool — sequence finished
    # the request's sampling temperature as a device scalar (read only by a
    # sampled engine) and its noise generator (None on a greedy engine)
    temperature: Optional[torch.Tensor] = None
    gen: Optional[torch.Generator] = None


class RoundOutput(NamedTuple):
    new_tokens: torch.Tensor  # [PATH] committed this round (first n_acc valid)
    accept_len: torch.Tensor  # scalar (-1 when the sequence is done)
    done: torch.Tensor        # scalar bool
    live_match: torch.Tensor  # forced replay: live-argmax agreements


def _target_feats(res: transformer.ForwardResult, version: int) -> torch.Tensor:
    """Draft input features: v3 = fused 3-tap, v1 = post-final-norm hidden."""
    return res.taps if version == 3 else res.hidden


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_device(v, device) for v in tree]
    return tree.to(device)


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

    def init_target_cache(self) -> KVCache:
        c = self.cfg
        return init_cache(c.num_layers, 1, c.num_kv_heads, self._tgt_len(),
                          c.head_dim, dtype=c.dtype, device=self.device,
                          kv_quant=self.ecfg.kv_quant)

    def init_draft_cache(self) -> KVCache:
        """The draft cache stays in the draft's dtype whatever kv_quant is."""
        e, d = self.ecfg, self.dcfg
        # draft scratch past the committed pairs: beam rows (dynamic) or tree
        # rows (static), + extension-window padding
        scratch = (e.tree_size if self.static_spec is not None
                   else max((e.depth + 1) * e.top_k, e.tree_size))
        dft_len = e.max_len + scratch + self.path_len
        return init_cache(d.num_layers if d.version == 1 else 1, 1,
                          d.num_kv_heads, dft_len, d.head_dim, dtype=d.dtype,
                          device=self.device)

    def init_caches(self) -> tuple[KVCache, KVCache]:
        return self.init_target_cache(), self.init_draft_cache()

    # ------------------------------------------------------------------
    # speculative path
    # ------------------------------------------------------------------

    @property
    def sampled(self) -> bool:
        return self.ecfg.temperature > 0

    def _noise(self, gen: Optional[torch.Generator]):
        """The drafter's noise: Gumbel uniforms from the request's generator
        (None on a greedy engine)."""
        if gen is None:
            return None
        return lambda shape: uniform(gen, shape, self.device, U_MIN)

    def _draft_round(self, ext_tokens, ext_feats, n_new, dcache, temperature=None,
                     gen=None):
        noise = self._noise(gen)
        if self.static_spec is not None:
            return draft_round_static(self.dparams, self.dcfg, self.static_spec,
                                      ext_tokens, ext_feats, n_new, dcache,
                                      self._lm_head_w, ecfg=self.ecfg, noise=noise,
                                      temperature=temperature)
        return draft_round(self.dparams, self.dcfg, self.ecfg, ext_tokens,
                           ext_feats, n_new, dcache, self._lm_head_w, noise=noise,
                           temperature=temperature)

    def _pick_token(self, logits: torch.Tensor, temperature=None,
                    gen: Optional[torch.Generator] = None) -> torch.Tensor:
        """Greedy: the argmax. Sampled: a draw from the processed
        distribution at the request's temperature (floored at 1e-4)."""
        if not self.sampled:
            return torch.argmax(logits)
        e = self.ecfg
        p = torch.softmax(process_logits(logits, temperature.clamp_min(1e-4),
                                         e.sampling_top_k, e.top_p), dim=-1)
        return categorical(p, uniform(gen, p.shape, self.device, U_MIN))

    def _request(self, temperature: Optional[float], seed: int):
        """A sampled request's (temperature as a device scalar, generator on
        the engine's device seeded with `seed`); (None, None) on a greedy
        engine."""
        if not self.sampled:
            return None, None
        t = self.ecfg.temperature if temperature is None else temperature
        gen = torch.Generator(device=self.device)
        gen.manual_seed(int(seed))
        return torch.tensor(float(t), dtype=torch.float32, device=self.device), gen

    def _prefill(self, tokens: torch.Tensor, prompt_len: int, cache: KVCache,
                 dcache: KVCache, ref: Optional[torch.Tensor] = None,
                 temperature: Optional[torch.Tensor] = None,
                 gen: Optional[torch.Generator] = None) -> EngineState:
        """Prompt prefill + first draft tree. tokens: [1, Tp] padded. A
        sampled engine draws the root token, then the draft's noise."""
        dev = self.device
        Tp = tokens.shape[1]
        S = cache.max_len
        pos = torch.arange(Tp, device=dev)[None]
        res = transformer.forward(self.params, self.cfg, tokens, cache, pos,
                                  prefill_mask(Tp, S, cache.length))
        last_logits = transformer.lm_head(self.params, self.cfg,
                                          res.hidden[0, prompt_len - 1])
        root = self._pick_token(last_logits, temperature, gen)
        if ref is not None:  # forced replay: the first token is pinned too
            root = ref[prompt_len]
        plen = torch.tensor(prompt_len, dtype=torch.long, device=dev)
        cache = with_length(res.cache, plen.reshape(1))
        feats = _target_feats(res, self.dcfg.version)[0]
        ext_tokens = torch.cat([tokens[0, 1:], torch.zeros(1, dtype=torch.long, device=dev)])
        ext_tokens[prompt_len - 1] = root
        dr = self._draft_round(ext_tokens, feats, plen, dcache, temperature, gen)
        tokens_buf = torch.zeros((1, S), dtype=torch.long, device=dev)
        tokens_buf[:, :Tp] = tokens
        return EngineState(tokens=tokens_buf, length=plen, cache=cache,
                           dcache=dr.dcache, tree=dr.tree,
                           done=torch.zeros((), dtype=torch.bool, device=dev),
                           temperature=temperature, gen=gen)

    def _round(self, state: EngineState, ref: Optional[torch.Tensor] = None,
               kv_limit: Optional[int] = None):
        """One speculative decode round, with no host sync.

        ref (optional): forced-replay reference, a [S] token buffer;
        acceptance and the bonus token follow it instead of the live argmax.

        kv_limit: run the round against only the first `kv_limit` KV rows,
        valid whenever committed length + tree + commit window fit inside it
        (EngineConfig.kv_buckets). The plain attention then reads the bucket
        and not the whole preallocated cache; the tree-attention kernel only
        ever reads the committed rows. The small cache is a view, so nothing
        is copied back.
        """
        if kv_limit is not None and kv_limit < state.cache.max_len:
            small = state._replace(cache=slice_rows(state.cache, kv_limit))
            new_small, out = self._round(small, ref=ref)
            merged = merge_rows_window(state.cache, new_small.cache,
                                       state.cache.length,
                                       self.ecfg.tree_size + self._tail)
            return new_small._replace(cache=merged), out
        e, tree = self.ecfg, state.tree
        dev = self.device
        Lc = state.length
        P = self.path_len

        # --- target tree verification (the mask goes in as metadata)
        with record_function("round.verify"):
            vmask = TreeMaskSpec(tree_mask=tree.mask[None], start=state.cache.length)
            pos = (Lc + tree.positions)[None]
            res = transformer.forward(self.params, self.cfg, tree.tokens[None],
                                      state.cache, pos, vmask)
            logits = transformer.lm_head(self.params, self.cfg, res.hidden[0])
            feats = _target_feats(res, self.dcfg.version)[0]

        # --- acceptance
        with record_function("round.accept"):
            if self.sampled:
                # the round's draws, in order: acceptance, bonus, draft
                temp = state.temperature.clamp_min(1e-4)
                u = uniform(state.gen, (P - 1, tree.children.shape[1]), dev)
                rule = (accept_mod.accept_sampled if tree.node_probs is None
                        else accept_mod.accept_sampled_true_q)
                acc = rule(tree, logits, u, e, P, temperature=temp)
                bonus = categorical(acc.sample_p,
                                    uniform(state.gen, acc.sample_p.shape, dev, U_MIN))
            elif ref is not None:
                ref_next = ref[window(Lc + 1, P, ref.shape[0])]
                acc = accept_mod.accept_greedy(tree, logits, P, ref_next=ref_next)
                bonus = ref_next.index_select(0, acc.accept_len.reshape(1))[0]
            else:
                acc = accept_mod.accept_greedy(tree, logits, P)
                # the vanilla rule, argmax of the final node's logits (path
                # repeats it past the accepted length): an argmax after the
                # softmax would tie two logits one ulp apart
                bonus = torch.argmax(logits.index_select(0, acc.path[-1:])[0])

        # --- commit tokens + compact KV
        with record_function("round.commit"):
            path_tokens = tree.tokens[acc.path]
            n_acc = torch.where(state.done, 0, acc.accept_len + 1)
            S_tok = state.tokens.shape[1]
            state.tokens[0, window(Lc, P, S_tok)] = path_tokens
            # the compaction kernel moves raw float rows only: an int8 cache
            # takes the plain version, which moves payload and scales
            if e.compact_impl == "pallas" and e.kv_quant == "none":
                ck, cv = compact_rows(res.cache.k, res.cache.v, acc.path, Lc)
                cache = KVCache(k=ck, v=cv, length=(Lc + n_acc).reshape(1))
            else:
                cache = compact_accepted(with_length(res.cache, Lc.reshape(1)),
                                         acc.path[None], n_acc.reshape(1))
            done = state.done
            if self.eos_token_id is not None:
                in_window = torch.arange(P, device=dev) < n_acc
                done = done | ((path_tokens == self.eos_token_id) & in_window).any()
            # capacity stop: no room for another round's tree + commit window
            done = done | (Lc + n_acc + self._tail + e.tree_size >= self._tgt_len())

        # --- next draft tree
        with record_function("round.draft"):
            ext_tokens = torch.cat([path_tokens[1:],
                                    torch.zeros(1, dtype=torch.long, device=dev)])
            ext_tokens = torch.where(torch.arange(P, device=dev) == acc.accept_len,
                                     bonus, ext_tokens)
            ext_feats = feats[acc.path]
            dr = self._draft_round(ext_tokens, ext_feats, n_acc, state.dcache,
                                   state.temperature, state.gen)

        new_state = state._replace(length=Lc + n_acc, cache=cache, dcache=dr.dcache,
                                   tree=dr.tree, done=done)
        return new_state, RoundOutput(new_tokens=path_tokens,
                                      accept_len=n_acc - 1, done=done,
                                      live_match=acc.live_match)

    def _start(self, prompt_ids, temperature=None, ref=None, seed: int = 0):
        prompt = np.asarray(prompt_ids, np.int64).reshape(1, -1)
        Lp = prompt.shape[1]
        Tp = self._bucket(Lp)
        padded = np.zeros((1, Tp), np.int64)
        padded[0, :Lp] = prompt
        cache, dcache = self.init_caches()
        toks = torch.from_numpy(padded).to(self.device)
        temp, gen = self._request(temperature, seed)
        with torch.no_grad():
            state = self._prefill(toks, Lp, cache, dcache, ref=ref, temperature=temp,
                                  gen=gen)
        return prompt, Lp, state

    def _host_rounds(self, prompt_ids, max_new_tokens, eos_token_id, temperature,
                     seed):
        """The per-round host loop behind `generate` and `generate_stream`:
        yields (all ids so far as a list, this round's accept_len) after every
        round, one sync per round."""
        prompt, Lp, state = self._start(prompt_ids, temperature, seed=seed)
        out = list(prompt[0])
        new_tokens = 0
        with torch.no_grad():
            while new_tokens < max_new_tokens:
                state, r = self._round(state)
                alen = int(r.accept_len)
                if alen < 0:      # device-side finish flag tripped
                    break
                stop = False
                for t in r.new_tokens[: alen + 1].cpu().numpy():
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
                force_tokens, prompt_row, max_new_tokens)).to(self.device)
        prompt, Lp, state = self._start(prompt_ids, temperature, ref=ref, seed=seed)
        rounds = 0
        hits = torch.zeros((), dtype=torch.long, device=self.device)
        with torch.no_grad():
            while True:
                # the round's one sync: the stop flag and the length together
                done, length = torch.stack(
                    [state.done.to(torch.long), state.length]).tolist()
                if done or length - Lp >= max_new_tokens:
                    break
                state, r = self._round(state, ref=ref,
                                       kv_limit=self._kv_limit(length))
                rounds += 1
                hits = hits + r.live_match
            toks = state.tokens[0, :length].cpu().numpy()
        out = self._trim_overshoot(toks, Lp, max_new_tokens)
        if log and ref is not None:
            return out, length - Lp, rounds, int(hits)
        if log:
            return out, length - Lp, rounds
        return out

    def generate_batch(self, *args, **kwargs):
        raise NotImplementedError("batched generation is not ported yet")

    generate_batch_fused = generate_batch

    # ------------------------------------------------------------------
    # vanilla baseline
    # ------------------------------------------------------------------

    def _vanilla_step(self, cache: KVCache, token: torch.Tensor,
                      kv_limit: Optional[int] = None, temperature=None, gen=None):
        if kv_limit is not None and kv_limit < cache.max_len:
            new_small, nxt = self._vanilla_step(slice_rows(cache, kv_limit), token,
                                                temperature=temperature, gen=gen)
            # a vanilla step appends one row at `length`, through the view
            return merge_rows_window(cache, new_small, cache.length, 1), nxt
        S = cache.max_len
        pos = cache.length.reshape(1, 1)
        res = transformer.forward(self.params, self.cfg, token.reshape(1, 1),
                                  cache, pos, prefill_mask(1, S, cache.length))
        logits = transformer.lm_head(self.params, self.cfg, res.hidden[0, 0])
        return res.cache, self._pick_token(logits, temperature, gen)

    def _vanilla_prefill(self, prompt_ids, temperature, seed):
        """Prompt forward of the baseline: (prompt [1, Lp], Lp, cache, first
        token as a device scalar, the request's (temperature, generator))."""
        request = self._request(temperature, seed)
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
                                  prefill_mask(Tp, cache.max_len, cache.length))
        logits = transformer.lm_head(self.params, self.cfg, res.hidden[0, Lp - 1])
        token = self._pick_token(logits, *request)
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
