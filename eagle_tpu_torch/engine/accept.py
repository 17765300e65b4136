"""Greedy acceptance as a walk down the tree, on the device (no host sync).

Port of eagle_tpu/engine/accept.py:accept_greedy. Retrieve rows of the
reference are the root→leaf paths, and the first matching child in
node-index order is the one the reference's row order selects.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops.tree import Tree


class AcceptResult(NamedTuple):
    path: torch.Tensor        # [PATH] node ids; path[0] = 0; repeats past accept
    accept_len: torch.Tensor  # scalar — accepted nodes beyond the root
    sample_p: torch.Tensor    # [V] fp32 — softmax of the final node's logits
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
    cur = torch.zeros((), dtype=torch.long, device=dev)
    alen = torch.zeros((), dtype=torch.long, device=dev)
    done = torch.zeros((), dtype=torch.bool, device=dev)
    hits = torch.zeros((), dtype=torch.long, device=dev)
    rest = []
    for d in range(path_len - 1):
        t_live = argmax_tok[cur]
        t_star = t_live if ref_next is None else ref_next[d]
        ch = tree.children[cur]                                # [K]
        ctok = tree.tokens[ch.clamp(min=0)]
        match = (ctok == t_star) & (ch >= 0)
        has = match.any() & ~done
        nxt = ch[torch.argmax(match.to(torch.int32))]          # first match
        cur = torch.where(has, nxt, cur)
        hits = hits + ((t_live == t_star) & ~done).to(torch.long)
        alen = alen + has.to(torch.long)
        done = done | ~has
        rest.append(cur)
    path = torch.stack([torch.zeros((), dtype=torch.long, device=dev)] + rest)
    sample_p = torch.softmax(logits[cur].to(torch.float32), dim=-1)
    return AcceptResult(path=path, accept_len=alen, sample_p=sample_p,
                        live_match=hits)
