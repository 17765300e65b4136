"""Draft-tree construction: the dynamic EAGLE-2/3 beam (`draft_round`) and
the static EAGLE-1 topology (`StaticTreeSpec`, `draft_round_static`), greedy
or sampled.

Port of eagle_tpu/engine/drafter.py. The accepted suffix arrives as a padded
window with a valid count `n_new` (a device tensor); the beam loop runs
`depth` static steps; the final rerank is top-k + sort + searchsorted, all
on the device, feeding ops.tree.build_tree. A static tree expands its fixed
topology level by level.

Sampled modes (temperature > 0): candidates are drawn without replacement
from the processed draft distribution by Gumbel top-k
(`_gumbel_topk_candidates`), and each node's distribution rides along in
Tree.node_probs for the true-q acceptance rule: static trees under
acceptance "true_q" or "true_q_dynamic", dynamic trees under
"true_q_dynamic" (the deterministic beam fixes the tree's shape, then
`_expand_sampled_shape` re-expands it with sampled candidates). The noise
is an argument: `noise(shape)` returns fp32 uniforms in [1e-20, 1) on the
device, drawn in a fixed order (the engine's request generator; the tests
hand in the JAX package's uniforms).

Tie rule: every top-k here orders by value descending, then index ascending,
as `jax.lax.top_k` and the JAX package's `topk_rows` do. `torch.topk` does
not promise that, so `topk_rows` (ops/score_topk.py) is a stable descending
sort.

Draft-sequence convention: draft position i holds the token at target
position i+1 paired with the target feature at position i.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..config import DraftConfig, EngineConfig
from ..models import draft as draft_mod
from ..ops.kv_cache import KVCache
from ..ops.masks import place_slab, prefill_mask
from ..ops.score_topk import score_topk_quant, topk_rows
from ..ops.tree import (Tree, ancestor_mask, build_tree, depths_from_mask,
                        max_children, paths_to_parents)
from .sampling import process_logits

# noise(shape) -> fp32 uniforms in [1e-20, 1) on the drafting device
Noise = Callable[[tuple], torch.Tensor]


def score_topk(dparams: dict, dcfg: DraftConfig, ecfg: EngineConfig,
               hidden: torch.Tensor, target_lm_head, k: int):
    """Log-softmax top-k (scores [M, k] fp32, draft-vocab ids [M, k]) of the
    draft scoring head over [M, H] hidden rows.

    With `fuse_scoring` and a quantized head the fused kernel
    (ops/score_topk.score_topk_quant) does the matmul, the log-softmax and
    the top-k in one call; on the CPU that wrapper takes its plain version.
    Candidate ids are the same either way; scores differ by the order of
    the logsumexp sum, which never affects greedy == vanilla (acceptance
    only commits tokens the target verifies)."""
    w = target_lm_head if dcfg.version == 1 else dparams["lm_head"]
    if ecfg.fuse_scoring and isinstance(w, dict):
        h = (hidden if dcfg.version == 1
             else draft_mod.rms_norm(hidden, dparams["norm"], dcfg.rms_eps))
        return score_topk_quant(h, w, k)
    logits = draft_mod.draft_logits(dparams, dcfg, hidden, target_lm_head)
    return topk_rows(torch.log_softmax(logits, dim=-1), k)


class DraftRound(NamedTuple):
    tree: Tree
    dcache: KVCache  # committed draft cache (length excludes beam scratch)


def _sampling_temperature(ecfg: Optional[EngineConfig], noise, temperature,
                          modes: tuple):
    """The temperature of a sampled drafting mode, or None for greedy
    drafting: an engine at temperature > 0 whose acceptance is one of `modes`,
    with noise given. A request's temperature is floored at 1e-4."""
    if ecfg is None or noise is None or ecfg.temperature <= 0 \
            or ecfg.acceptance not in modes:
        return None
    if temperature is None:
        return ecfg.temperature
    return (temperature.clamp_min(1e-4) if torch.is_tensor(temperature)
            else max(temperature, 1e-4))


def _gumbel_topk_candidates(dparams: dict, dcfg: DraftConfig, ecfg: EngineConfig,
                            logits_rows: torch.Tensor, u: torch.Tensor, temp, k: int):
    """k candidates per row drawn WITHOUT replacement from the processed
    draft distribution, by Gumbel top-k (the draw order is the sequential
    without-replacement order the true-q rule assumes).

    logits_rows: [n, dV]; u: [n, dV] uniforms in [1e-20, 1). Returns (tokens
    [n, k] target-vocab ids in draw order, probs [n, V_target]: the
    distribution each row's candidates were drawn from, a reduced draft
    vocabulary scattered to its target ids)."""
    probs = torch.softmax(process_logits(logits_rows, temp, ecfg.sampling_top_k,
                                         ecfg.top_p), dim=-1)        # [n, dV]
    g = -torch.log(-torch.log(u))
    _, tk = topk_rows(torch.log(probs.clamp_min(1e-30)) + g, k)
    toks = draft_mod.map_draft_to_target(dparams, dcfg, tk)
    dV = probs.shape[-1]
    if dV != dcfg.vocab_size:
        ids = draft_mod.map_draft_to_target(
            dparams, dcfg, torch.arange(dV, device=probs.device))
        full = torch.zeros(probs.shape[:-1] + (dcfg.vocab_size,), dtype=torch.float32,
                           device=probs.device)
        full[..., ids] = probs
        probs = full
    return toks, probs


class StaticTreeSpec:
    """Host-side static tree topology (EAGLE-1 style), built from a
    choices-style path list such as ops.tree.MC_SIM_7B_63. All members are
    numpy constants."""

    def __init__(self, paths):
        self.paths = tuple(tuple(p) for p in paths)
        parents = paths_to_parents(self.paths)
        self.parents = parents                       # np [N]
        self.num_nodes = len(parents)
        self.k = max_children(parents)
        depth = np.zeros(len(parents), np.int64)
        for i in range(1, len(parents)):
            depth[i] = depth[parents[i]] + 1
        self.depths = depth
        self.max_depth = int(depth.max())
        # rank of each node among its parent's children (= which top-k token)
        rank = np.zeros(len(parents), np.int64)
        seen = {}
        for i in range(1, len(parents)):
            p = int(parents[i])
            rank[i] = seen.get(p, 0)
            seen[p] = rank[i] + 1
        self.ranks = rank
        # per-level node lists (level d >= 1)
        self.levels = [
            np.nonzero(depth == d)[0] for d in range(1, self.max_depth + 1)
        ]
        # KV row offset of each tree node within the draft scratch region:
        # nodes are written level by level in node order
        order = np.concatenate(self.levels) if self.levels else np.zeros(0, np.int64)
        self.kv_slot = np.zeros(len(parents), np.int64)
        self.kv_slot[order] = np.arange(len(order))
        # static ancestor-or-self mask among the nodes (row = node, col = node)
        anc = np.zeros((self.num_nodes, self.num_nodes), bool)
        for i in range(self.num_nodes):
            j = i
            anc[i, j] = True
            while j != 0:
                j = int(parents[j])
                anc[i, j] = True
        self.anc = anc
        self._device_consts: dict = {}

    def on_device(self, device):
        """(parents [N], [(level ids, parent ids, ranks, ancestor slab
        [n_d, N-1] over the tree rows in KV-slot order) per level]) as tensors
        on `device`, made once per device so a round copies nothing from the
        host."""
        key = str(device)
        if key not in self._device_consts:
            tree_rows = np.concatenate(self.levels)
            to = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
            levels = [(to(level), to(self.parents[level].astype(np.int64)),
                       to(self.ranks[level]), to(self.anc[np.ix_(level, tree_rows)]))
                      for level in self.levels]
            self._device_consts[key] = (to(self.parents.astype(np.int64)), levels)
        return self._device_consts[key]


def draft_round_static(dparams: dict, dcfg: DraftConfig, spec: StaticTreeSpec,
                       ext_tokens: torch.Tensor, ext_feats: torch.Tensor,
                       n_new: torch.Tensor, dcache: KVCache,
                       target_lm_head=None,
                       ecfg: Optional[EngineConfig] = None,
                       noise: Optional[Noise] = None,
                       temperature=None) -> DraftRound:
    """EAGLE-1 static-tree drafting: expand the fixed topology level by
    level. The draft cache is written in place; tree rows past the committed
    length are scratch.

    Greedy: a node's token is the `rank`-th top-k token of its parent's draft
    logits. Sampled (ecfg.temperature > 0, acceptance "true_q" or
    "true_q_dynamic", `noise` given): a node's children are drawn without
    replacement from its processed draft distribution, which goes to
    Tree.node_probs. Draws: [1, dV] for the root, then [n_d, dV] for each
    level that has children, in level order."""
    temp = _sampling_temperature(ecfg, noise, temperature, ("true_q", "true_q_dynamic"))
    sampled = temp is not None
    k = spec.k
    T = ext_tokens.shape[0]
    S = dcache.max_len
    dev = ext_tokens.device
    dlen0 = dcache.length[0]
    n_new = n_new.to(torch.long)
    dlen = dlen0 + n_new

    # ---- extend on the accepted suffix
    pos = (dlen0 + torch.arange(T, device=dev))[None]
    mask = prefill_mask(T, S, dcache.length)
    dres = draft_mod.forward(dparams, dcfg, ext_tokens[None], ext_feats[None],
                             dcache, pos, mask)
    last = torch.remainder(n_new - 1, T)      # JAX wraps a -1 index
    root_hidden = dres.hidden[0].index_select(0, last.reshape(1))[0]
    root_token = ext_tokens.index_select(0, last.reshape(1))[0]
    kc, vc = dres.cache.k, dres.cache.v

    def candidate_topk(hidden_rows: torch.Tensor):
        """[n, H] hidden rows -> (tokens [n, k] target-vocab, probs
        [n, V_target] or None)."""
        logits = draft_mod.draft_logits(dparams, dcfg, hidden_rows, target_lm_head)
        if sampled:
            return _gumbel_topk_candidates(dparams, dcfg, ecfg, logits,
                                           noise(tuple(logits.shape)), temp, k)
        _, tk = topk_rows(logits, k)
        return draft_mod.map_draft_to_target(dparams, dcfg, tk), None

    N = spec.num_nodes
    node_tokens = torch.zeros((N,), dtype=torch.long, device=dev)
    node_hidden = torch.zeros((N, root_hidden.shape[-1]), dtype=dcfg.dtype, device=dev)
    node_hidden[0] = root_hidden
    topk_per_node = torch.zeros((N, k), dtype=torch.long, device=dev)
    root_topk, root_probs = candidate_topk(root_hidden[None])
    topk_per_node[0] = root_topk[0]
    node_probs = None
    if sampled:
        node_probs = torch.zeros((N, dcfg.vocab_size), dtype=torch.float32, device=dev)
        node_probs[0] = root_probs[0]

    parents, levels = spec.on_device(dev)
    committed = torch.arange(S, device=dev)[None, :] < dlen
    written = 0  # tree-scratch rows written so far (a host counter)
    for d, (lvl, par, rnk, anc_slab) in enumerate(levels):
        n_d = lvl.shape[0]
        toks = topk_per_node[par, rnk]                             # [n_d]
        node_tokens[lvl] = toks
        hid = node_hidden[par]                                     # [n_d, H]
        lvl_cache = KVCache(k=kc, v=vc, length=(dlen + written).reshape(1))
        lvl_pos = (dlen + d).reshape(1, 1).expand(1, n_d)
        # mask: committed columns + the static ancestors' tree rows
        m = committed.expand(n_d, S) | place_slab(anc_slab[None], S, dlen.reshape(1))[0]
        res = draft_mod.forward(dparams, dcfg, toks[None], hid[None], lvl_cache,
                                lvl_pos, m[None])
        h = res.hidden[0]
        node_hidden[lvl] = h
        if d + 1 < spec.max_depth:
            topk_per_node[lvl], pr = candidate_topk(h)
            if sampled:
                node_probs[lvl] = pr
        written += n_d

    node_tokens[0] = root_token
    tree = build_tree(node_tokens, parents, k, max_depth=spec.max_depth + 1,
                      node_probs=node_probs)
    return DraftRound(tree=tree, dcache=KVCache(k=kc, v=vc, length=dlen.reshape(1)))


def _beam_mask(anc: torch.Tensor, S: int, dlen: torch.Tensor) -> torch.Tensor:
    """[k, depth*k] beam-ancestor slab → [1, k, S] mask: committed pairs at
    columns < dlen, beam rows at [dlen, dlen + depth*k)."""
    k = anc.shape[0]
    committed = torch.arange(S, device=anc.device)[None, :] < dlen
    placed = place_slab(anc[None], S, dlen.reshape(1))[0]
    return (committed.expand(k, S) | placed)[None]


def draft_round(dparams: dict, dcfg: DraftConfig, ecfg: EngineConfig,
                ext_tokens: torch.Tensor, ext_feats: torch.Tensor,
                n_new: torch.Tensor, dcache: KVCache,
                target_lm_head: Optional[torch.Tensor] = None,
                noise: Optional[Noise] = None, temperature=None) -> DraftRound:
    """Extend the draft cache with the accepted pairs, then grow a new tree.

    ext_tokens: [T] padded pair tokens (row n_new-1 is the pending root);
    ext_feats: [T, F] padded pair features; n_new: device scalar, number of
    valid pairs; dcache: draft KV, written in place (beam rows past the
    committed length are scratch and never committed).

    Sampled mode (acceptance "true_q_dynamic", temperature > 0, `noise`
    given): the deterministic beam below still runs in full and fixes the
    tree's SHAPE, a function of the committed context alone (pruning sampled
    candidates by their own scores would bias the true-q law);
    `_expand_sampled_shape` then re-expands that shape with sampled
    candidates and fills Tree.node_probs.
    """
    k, depth, total = ecfg.top_k, ecfg.depth, ecfg.total_tokens
    T = ext_tokens.shape[0]
    S = dcache.max_len
    dev = ext_tokens.device
    dlen0 = dcache.length[0]
    n_new = n_new.to(torch.long)
    dlen = dlen0 + n_new

    # ---- 1. extend on the accepted suffix
    pos = (dlen0 + torch.arange(T, device=dev))[None]
    mask = prefill_mask(T, S, dcache.length)
    dres = draft_mod.forward(dparams, dcfg, ext_tokens[None], ext_feats[None],
                             dcache, pos, mask)
    last = torch.remainder(n_new - 1, T)      # JAX wraps a -1 index
    root_hidden = dres.hidden[0].index_select(0, last.reshape(1))[0]
    root_token = ext_tokens.index_select(0, last.reshape(1))[0]
    kc, vc = dres.cache.k, dres.cache.v

    # ---- 2. root candidates
    root_p, root_i = score_topk(dparams, dcfg, ecfg, root_hidden[None],
                                target_lm_head, k)
    root_p, root_i = root_p[0], root_i[0]
    root_tok = draft_mod.map_draft_to_target(dparams, dcfg, root_i)

    # ---- 3. beam expansion
    eye = torch.eye(k, dtype=torch.bool, device=dev)
    anc = torch.zeros((k, depth * k), dtype=torch.bool, device=dev)
    anc[:, :k] = eye
    tokens = root_tok
    hidden = root_hidden.expand(k, root_hidden.shape[-1])
    scores = root_p
    prev_flat = torch.arange(k, device=dev)
    beam_ids_all, cu_all, cand_all = [], [], []
    for i in range(depth):
        write_at = dlen + i * k
        beam_cache = KVCache(k=kc, v=vc, length=write_at.reshape(1))
        bpos = (dlen + i).reshape(1, 1).expand(1, k)
        bmask = _beam_mask(anc, S, dlen)
        res = draft_mod.forward(dparams, dcfg, tokens[None], hidden[None],
                                beam_cache, bpos, bmask)
        hid = res.hidden[0]                                   # [k, H]
        tk_p, tk_i = score_topk(dparams, dcfg, ecfg, hid, target_lm_head, k)
        cand_tok = draft_mod.map_draft_to_target(dparams, dcfg, tk_i)
        cu = tk_p + scores[:, None]                           # [k, k]
        cs_p, cs_i = topk_rows(cu.reshape(-1), k)             # beam rerank
        out_ids = cs_i // k
        # node ids of this step's beam rows in flat-score space (+1 for root)
        if i == 0:
            beam_ids = torch.arange(k, device=dev) + 1
        else:
            beam_ids = k + (i - 1) * k * k + prev_flat + 1
        new_anc = anc[out_ids]
        blk = min(i + 1, depth - 1) * k    # the last step's anc is unused
        new_anc[:, blk:blk + k] = eye
        tokens = cand_tok.reshape(-1)[cs_i]
        hidden = hid[out_ids]
        scores = cs_p
        anc = new_anc
        prev_flat = cs_i
        beam_ids_all.append(beam_ids)
        cu_all.append(cu)
        cand_all.append(cand_tok)

    # ---- 4. global rerank to total_tokens nodes
    scores_flat = torch.cat([root_p, torch.stack(cu_all).reshape(-1)])
    tokens_flat = torch.cat([root_tok, torch.stack(cand_all).reshape(-1)])
    parents_flat = torch.cat([torch.zeros(1, dtype=torch.long, device=dev),
                              torch.stack(beam_ids_all).reshape(-1)])
    _, sel = topk_rows(scores_flat, total)
    sel, _ = torch.sort(sel)                  # ascending → parents precede
    draft_parents = parents_flat[sel // k]
    parent_rank = torch.searchsorted(sel, draft_parents - 1, right=False)
    tree_parents = torch.where(draft_parents == 0, 0, parent_rank + 1)

    tokens_full = torch.cat([root_token.reshape(1), tokens_flat[sel]])
    parents_full = torch.cat([torch.zeros(1, dtype=torch.long, device=dev), tree_parents])
    dcache_out = KVCache(k=kc, v=vc, length=dlen.reshape(1))
    temp = _sampling_temperature(ecfg, noise, temperature, ("true_q_dynamic",))
    if temp is not None:
        return _expand_sampled_shape(dparams, dcfg, ecfg, parents_full, dcache_out,
                                     dlen, root_hidden, root_token, target_lm_head,
                                     noise, temp)
    tree = build_tree(tokens_full, parents_full, k, max_depth=depth + 2)
    return DraftRound(tree=tree, dcache=dcache_out)


def _expand_sampled_shape(dparams: dict, dcfg: DraftConfig, ecfg: EngineConfig,
                          parents: torch.Tensor, cache: KVCache, dlen: torch.Tensor,
                          root_hidden: torch.Tensor, root_token: torch.Tensor,
                          target_lm_head, noise: Noise, temp) -> DraftRound:
    """Pass 2 of sampled dynamic drafting: re-expand the tree shape `parents`
    (from the deterministic beam) with per-node Gumbel without-replacement
    draws; a node's children take the first draws of its parent, in node
    order (prefix-closed).

    Level-synchronous, fixed shapes: every level forwards ALL N-1 non-root
    rows (tree rows at draft-cache rows [dlen, dlen + N - 1), node order);
    only rows at the current depth take fresh inputs. Shallower rows recompute
    the same K/V (a row's K/V depends only on its own token and its parent's
    hidden), deeper rows hold values that the ancestor masks never open, so
    the last level leaves every row's K/V right. Draws: [1, dV] for the
    root, then [N - 1, dV] per level that has children."""
    k, depth = ecfg.top_k, ecfg.depth
    N = parents.shape[0]
    S = cache.max_len
    dev = parents.device
    max_depth = depth + 2  # node depths span [0, depth + 1]

    anc = ancestor_mask(parents, max_depth)                # [N, N]
    depths = depths_from_mask(anc)                         # [N]
    # sibling rank in node order == draw rank (the shape keeps the first
    # m_n draws of each node)
    idx = torch.arange(N, device=dev)
    onehot = F.one_hot(parents, N) * (idx > 0)[:, None]
    rank = torch.cumsum(onehot, dim=0) - onehot
    sib_rank = rank.gather(1, parents[:, None])[:, 0]

    node_tokens = torch.zeros((N,), dtype=torch.long, device=dev)
    node_tokens[0] = root_token
    node_hidden = torch.zeros((N, root_hidden.shape[-1]), dtype=dcfg.dtype, device=dev)
    node_hidden[0] = root_hidden
    node_probs = torch.zeros((N, dcfg.vocab_size), dtype=torch.float32, device=dev)

    root_logits = draft_mod.draft_logits(dparams, dcfg, root_hidden[None], target_lm_head)
    root_draws, root_q = _gumbel_topk_candidates(
        dparams, dcfg, ecfg, root_logits, noise(tuple(root_logits.shape)), temp, k)
    draws = torch.zeros((N, k), dtype=torch.long, device=dev)
    draws[0] = root_draws[0]
    node_probs[0] = root_q[0]

    # rows 1..N-1 ride at draft-cache columns [dlen, dlen + N - 1)
    committed = torch.arange(S, device=dev)[None, :] < dlen
    mask = (committed.expand(N - 1, S)
            | place_slab(anc[None, 1:, 1:], S, dlen.reshape(1))[0])[None]
    pos = (dlen + depths[1:] - 1)[None]                    # [1, N-1]
    kc, vc = cache.k, cache.v
    for d in range(1, max_depth):
        at_d = (depths == d) & (idx > 0)                   # [N]
        node_tokens = torch.where(at_d, draws[parents, sib_rank], node_tokens)
        feats = node_hidden[parents[1:]]                   # [N-1, H]
        res = draft_mod.forward(dparams, dcfg, node_tokens[None, 1:], feats[None],
                                KVCache(k=kc, v=vc, length=dlen.reshape(1)), pos, mask)
        kc, vc = res.cache.k, res.cache.v
        hid = torch.cat([node_hidden[:1], res.hidden[0]])  # [N, H]
        node_hidden = torch.where(at_d[:, None], hid, node_hidden)
        if d < max_depth - 1:  # leaf draws are never used
            logits = draft_mod.draft_logits(dparams, dcfg, res.hidden[0], target_lm_head)
            tk, q = _gumbel_topk_candidates(dparams, dcfg, ecfg, logits,
                                            noise(tuple(logits.shape)), temp, k)
            draws = torch.where(at_d[:, None], torch.cat([draws[:1], tk]), draws)
            node_probs = torch.where(at_d[:, None], torch.cat([node_probs[:1], q]),
                                     node_probs)

    tree = build_tree(node_tokens, parents, k, max_depth=max_depth, node_probs=node_probs)
    return DraftRound(tree=tree, dcache=KVCache(k=kc, v=vc, length=dlen.reshape(1)))
