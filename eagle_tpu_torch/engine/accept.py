"""Acceptance rules as walks down the tree, on the device (no host sync).

Port of eagle_tpu/engine/accept.py. Retrieve rows of the reference are the
root→leaf paths, and the first matching child in node-index order is the one
the reference's row order selects.

- `accept_greedy`: the argmax walk.
- `accept_sampled`: the multi-round rejection walk under temperature for
  deterministic (top-k) candidates, q(x) = 1: child j of a node is accepted
  with probability p_j / (1 - sum_{l<j} p_l), which telescopes to p_j; when
  every child is rejected the bonus comes from the residual distribution.
- `accept_sampled_true_q`: the true-q rule for candidates *sampled* without
  replacement from the draft distribution carried in `Tree.node_probs`.

The sampled rules take their uniforms as an argument, `u: [path_len - 1, K]`
(one row per level, one uniform per sibling), so they can be held against
the JAX package on the same numbers. They also take a leading batch of
independent trials (`u: [B, path_len - 1, K]`, the tree's tensors and the
logits with a leading dimension of B or 1), which the Monte-Carlo checks use.
A candidate is accepted when u < ratio: a zero-probability candidate is never
accepted (the JAX package's u <= ratio accepts one when its uniform is
exactly 0).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import EngineConfig
from ..ops.tree import Tree
from .sampling import process_logits


class AcceptResult(NamedTuple):
    path: torch.Tensor        # [PATH] node ids; path[0] = 0; repeats past accept
    accept_len: torch.Tensor  # scalar — accepted nodes beyond the root
    sample_p: torch.Tensor    # [V] fp32 — the bonus token's distribution
                              # (greedy: softmax of the final node's logits)
    live_match: torch.Tensor  # scalar — forced replay: live argmax == reference


def accept_greedy(tree: Tree, logits: torch.Tensor, path_len: int,
                  ref_next: torch.Tensor | None = None) -> AcceptResult:
    """Greedy argmax walk. logits: [N, V] fp32 target logits per node.

    ref_next ([path_len], optional): forced replay — the token that must
    follow the path node at depth d is ref_next[d] instead of the live
    argmax; `live_match` counts where the live argmax agreed.
    """
    dev = logits.device
    argmax_tok = torch.argmax(logits, dim=-1)                  # [N]
    # rows are picked with index_select / gather: indexing by a 0-d tensor
    # reads the index on the host, which waits for the device
    row = lambda x, i: x.index_select(0, i.reshape(1))[0]
    cur = torch.zeros((), dtype=torch.long, device=dev)
    alen = torch.zeros((), dtype=torch.long, device=dev)
    done = torch.zeros((), dtype=torch.bool, device=dev)
    hits = torch.zeros((), dtype=torch.long, device=dev)
    rest = []
    for d in range(path_len - 1):
        t_live = row(argmax_tok, cur)
        t_star = t_live if ref_next is None else ref_next[d]
        ch = row(tree.children, cur)                           # [K]
        ctok = tree.tokens[ch.clamp(min=0)]
        match = (ctok == t_star) & (ch >= 0)
        has = match.any() & ~done
        nxt = row(ch, torch.argmax(match.to(torch.int32)))     # first match
        cur = torch.where(has, nxt, cur)
        hits = hits + ((t_live == t_star) & ~done).to(torch.long)
        alen = alen + has.to(torch.long)
        done = done | ~has
        rest.append(cur)
    path = torch.stack([torch.zeros((), dtype=torch.long, device=dev)] + rest)
    sample_p = torch.softmax(row(logits, cur).to(torch.float32), dim=-1)
    return AcceptResult(path=path, accept_len=alen, sample_p=sample_p,
                        live_match=hits)


# ---------------------------------------------------------------------------
# sampled rules (temperature > 0)
# ---------------------------------------------------------------------------

def _batched(tree: Tree, logits: torch.Tensor, u: torch.Tensor):
    """The walk's operands with a leading trial dimension B: (B, tokens
    [B', N], children [B', N, K], node_probs [B', N, V] or None, logits
    [B', N, V], u [B, P-1, K]), B' in {1, B}; `single` when u had none."""
    single = u.dim() == 2
    lead = lambda x, nd: None if x is None else (x[None] if x.dim() == nd else x)
    u = u[None] if single else u
    return (single, u.shape[0], lead(tree.tokens, 1), lead(tree.children, 2),
            lead(tree.node_probs, 2), lead(logits, 2), u)


def _row(x: torch.Tensor, b: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x[b, idx[b]] for a leading dimension of 1 or B (b = arange(B))."""
    return x[b if x.shape[0] > 1 else 0, idx]


def _result(single, rest, alen, sample_p, dev) -> AcceptResult:
    B = alen.shape[0]
    path = torch.stack([torch.zeros(B, dtype=torch.long, device=dev)] + rest, dim=-1)
    live = torch.zeros(B, dtype=torch.long, device=dev)
    if single:
        return AcceptResult(path=path[0], accept_len=alen[0], sample_p=sample_p[0],
                            live_match=live[0])
    return AcceptResult(path=path, accept_len=alen, sample_p=sample_p, live_match=live)


def accept_sampled(tree: Tree, logits: torch.Tensor, u: torch.Tensor,
                   ecfg: EngineConfig, path_len: int,
                   temperature=None) -> AcceptResult:
    """Multi-round rejection walk under temperature, q(x) = 1.

    logits: [N, V] target logits per node; u: [path_len - 1, K] uniforms in
    [0, 1) (one per level and sibling). `temperature` (a device scalar or a
    float) overrides ecfg.temperature: per-request temperatures."""
    single, B, tokens, children, _, logits, u = _batched(tree, logits, u)
    dev = logits.device
    t = ecfg.temperature if temperature is None else temperature
    probs = torch.softmax(process_logits(logits, t, ecfg.sampling_top_k, ecfg.top_p),
                          dim=-1)                                     # [B', N, V]
    V = probs.shape[-1]
    b = torch.arange(B, device=dev)
    cur = torch.zeros(B, dtype=torch.long, device=dev)
    alen = torch.zeros(B, dtype=torch.long, device=dev)
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    sample_p = torch.zeros(B, V, dtype=torch.float32, device=dev)
    rest = []
    for i in range(path_len - 1):
        p = _row(probs, b, cur)                                       # [B, V]
        ch = _row(children, b, cur)                                   # [B, K]
        valid = ch >= 0
        ctok = _row(tokens, b[:, None], ch.clamp(min=0))              # [B, K]
        pv = torch.where(valid, p.gather(1, ctok), 0.0)
        cum_excl = torch.cumsum(pv, dim=-1) - pv
        denom = (1.0 - cum_excl).clamp_min(1e-20)
        acc = (u[:, i] < pv / denom) & valid
        any_acc = acc.any(dim=-1) & ~done
        nxt = ch.gather(1, torch.argmax(acc.to(torch.int32), dim=-1, keepdim=True))[:, 0]
        # every child tried and rejected: the bonus comes from the residual
        removed = torch.zeros_like(p).scatter_add_(1, ctok, pv)
        resid = (p - removed).clamp_min(0.0)
        rsum = resid.sum(dim=-1, keepdim=True)
        resid = torch.where(rsum > 0, resid / rsum, p)
        sample_p = torch.where((~done & ~any_acc)[:, None], resid, sample_p)
        cur = torch.where(any_acc, nxt, cur)
        alen = alen + any_acc.to(torch.long)
        done = done | ~any_acc
        rest.append(cur)
    # accepted down to the last level: a fresh draw at the final node
    sample_p = torch.where(done[:, None], sample_p, _row(probs, b, cur))
    return _result(single, rest, alen, sample_p, dev)


def accept_sampled_true_q(tree: Tree, logits: torch.Tensor, u: torch.Tensor,
                          ecfg: EngineConfig, path_len: int,
                          temperature=None) -> AcceptResult:
    """True-q multi-round rejection for trees whose candidates were sampled
    without replacement from the draft distribution `tree.node_probs`
    ([N, V], target-vocab ids).

    Candidate j of a node is accepted with probability
    min(1, p_res(x_j) / q_res(x_j)), q_res the draft distribution with the
    earlier siblings removed and renormalised; on a rejection the target
    residual becomes p_res <- norm(max(p_res - q_res, 0)). u: [path_len - 1,
    K] uniforms in [0, 1)."""
    if tree.node_probs is None:
        raise ValueError("accept_sampled_true_q needs a sampled tree (node_probs)")
    single, B, tokens, children, node_probs, logits, u = _batched(tree, logits, u)
    dev = logits.device
    K = children.shape[-1]
    t = ecfg.temperature if temperature is None else temperature
    probs = torch.softmax(process_logits(logits, t, ecfg.sampling_top_k, ecfg.top_p),
                          dim=-1)                                     # [B', N, V]
    V = probs.shape[-1]
    b = torch.arange(B, device=dev)
    cur = torch.zeros(B, dtype=torch.long, device=dev)
    alen = torch.zeros(B, dtype=torch.long, device=dev)
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    sample_p = torch.zeros(B, V, dtype=torch.float32, device=dev)
    sib = torch.arange(K, device=dev)
    rest = []
    for i in range(path_len - 1):
        p_res = _row(probs, b, cur)                                   # target at node
        qb = _row(node_probs, b, cur)                                 # draft at node
        ch = _row(children, b, cur)
        valid = ch >= 0
        ctok = _row(tokens, b[:, None], ch.clamp(min=0))
        cum_q = torch.zeros(B, dtype=torch.float32, device=dev)
        acc_idx = torch.full((B,), -1, dtype=torch.long, device=dev)
        stopped = done
        for j in range(K):
            x = ctok[:, j:j + 1]
            ok = valid[:, j] & ~stopped
            qx_base = qb.gather(1, x)[:, 0]
            denom_q = (1.0 - cum_q).clamp_min(1e-20)
            qx = qx_base / denom_q
            px = p_res.gather(1, x)[:, 0]
            live = ok & (qx_base > 0)
            accept = live & (u[:, i, j] < px / qx.clamp_min(1e-20))
            # q_res: the draft distribution with the earlier valid siblings
            # zeroed, renormalised
            earlier = ((sib < j)[None] & valid).to(torch.float32)
            gone = torch.zeros_like(qb).scatter_add_(1, ctok, earlier) > 0
            q_vec = torch.where(gone, 0.0, qb) / denom_q[:, None]
            p_new = (p_res - q_vec).clamp_min(0.0)
            p_sum = p_new.sum(dim=-1, keepdim=True)
            p_new = torch.where(p_sum > 0, p_new / p_sum, p_res)
            p_res = torch.where((live & ~accept)[:, None], p_new, p_res)
            cum_q = cum_q + torch.where(live, qx_base, 0.0)
            acc_idx = torch.where(accept & (acc_idx < 0), j, acc_idx)
            stopped = stopped | accept
        any_acc = (acc_idx >= 0) & ~done
        nxt = ch.gather(1, acc_idx.clamp(min=0)[:, None])[:, 0]
        sample_p = torch.where((~done & ~any_acc)[:, None], p_res, sample_p)
        cur = torch.where(any_acc, nxt, cur)
        alen = alen + any_acc.to(torch.long)
        done = done | ~any_acc
        rest.append(cur)
    sample_p = torch.where(done[:, None], sample_p, _row(probs, b, cur))
    return _result(single, rest, alen, sample_p, dev)
