"""Tree-topology math on tensors: a [N] parent vector determines the tree,
and every derived structure is computed with fixed-shape ops on the device.
Each function also takes a batch of trees, parents [B, N] (the JAX
package's batched rounds vmap them); a `Tree` then has a leading B on every
field.

Conventions (as in the JAX package): node 0 is the root, parents[0] == 0,
parents[i] < i for i > 0. Index tensors are int64.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F


class Tree(NamedTuple):
    """One tree, or a batch of B trees with a leading B on every field."""
    tokens: torch.Tensor     # [N] target-vocab token per node (node 0 = root)
    parents: torch.Tensor    # [N] parent index; parents[0] = 0
    mask: torch.Tensor       # [N, N] bool ancestor-or-self
    positions: torch.Tensor  # [N] node depth (root = 0)
    children: torch.Tensor   # [N, K] child ids in node order, -1 padded
    node_probs: Optional[torch.Tensor] = None

    @property
    def num_nodes(self) -> int:
        return self.tokens.shape[-1]

    def map(self, fn) -> "Tree":
        """The tree with `fn` applied to every tensor field."""
        return Tree(*(None if x is None else fn(x) for x in self))


def ancestor_mask(parents: torch.Tensor, max_depth: int) -> torch.Tensor:
    """[.., N] parents → [.., N, N] ancestor-or-self bool, by repeated
    squaring of the parent-step relation (fp32 products of 0/1 entries are
    exact)."""
    N = parents.shape[-1]
    eye = torch.eye(N, dtype=torch.bool, device=parents.device)
    step = eye | F.one_hot(parents.to(torch.long), N).bool()
    step[..., 0, :] = eye[0]
    closure = step
    hops = 1
    while hops < max_depth:
        c = closure.to(torch.float32)
        closure = (c @ c) > 0
        hops *= 2
    return closure


def depths_from_mask(mask: torch.Tensor) -> torch.Tensor:
    return mask.sum(dim=-1) - 1


def sibling_rank(parents: torch.Tensor) -> torch.Tensor:
    """[.., N] parents → each node's rank among its parent's children, in
    node-index order (0 for the root)."""
    N = parents.shape[-1]
    idx = torch.arange(N, device=parents.device)
    onehot = F.one_hot(parents, N) * (idx > 0)[:, None]
    rank = torch.cumsum(onehot, dim=-2) - onehot         # exclusive cumsum
    return torch.gather(rank, -1, parents[..., None])[..., 0]


def children_table(parents: torch.Tensor, k: int) -> torch.Tensor:
    """[.., N] parents → [.., N, k] children ids (-1 padded), in node-index
    order."""
    N = parents.shape[-1]
    parents = parents.to(torch.long)
    idx = torch.arange(N, device=parents.device)
    sib_rank = sibling_rank(parents)
    valid = (idx > 0) & (sib_rank < k)
    rows = parents.reshape(-1, N)
    children = torch.full((rows.shape[0], N, k + 1), -1, dtype=torch.long,
                          device=parents.device)
    col = torch.where(valid, sib_rank, k).reshape(rows.shape)
    tree = torch.arange(rows.shape[0], device=parents.device)[:, None]
    # invalid rows all write -1 into the dump column k, sliced off below
    children[tree, rows, col] = torch.where(valid, idx, -1).reshape(rows.shape)
    return children[..., :k].reshape(parents.shape + (k,))


def paths_from_mask(mask: torch.Tensor, depths: torch.Tensor, max_path: int) -> torch.Tensor:
    """[N, N] ancestor mask → [N, max_path] root→node paths, -1 padded:
    path[i, d] = the ancestor of i at depth d, for d <= depth(i)."""
    N = mask.shape[0]
    idx = torch.arange(N, device=mask.device, dtype=torch.float32)
    depth_onehot = F.one_hot(depths.to(torch.long), max_path).to(torch.float32)
    path = (mask.to(torch.float32) @ (depth_onehot * idx[:, None])).round().to(torch.long)
    valid = torch.arange(max_path, device=mask.device)[None, :] <= depths[:, None]
    return torch.where(valid, path, -1)


def build_tree(tokens: torch.Tensor, parents: torch.Tensor, k: int, max_depth: int,
               node_probs: Optional[torch.Tensor] = None) -> Tree:
    """The Tree of `tokens` / `parents` ([N], or [B, N] for a batch)."""
    mask = ancestor_mask(parents, max_depth)
    return Tree(tokens=tokens.to(torch.long), parents=parents.to(torch.long),
                mask=mask, positions=depths_from_mask(mask),
                children=children_table(parents, k), node_probs=node_probs)


# ---------------------------------------------------------------------------
# Static tree topologies (EAGLE-1 style), host-side numpy
# ---------------------------------------------------------------------------

def paths_to_parents(paths: Sequence[Sequence[int]]) -> np.ndarray:
    """choices-style path list -> parent vector. Node 0 is the root; path i
    creates node i+1. Each path is a tuple of child ranks from the root, and
    every prefix must precede its extensions."""
    index = {(): 0}
    parents = [0]
    for p in paths:
        key = tuple(p)
        if key in index:
            continue
        prefix = key[:-1]
        if prefix not in index:
            raise ValueError(f"path {p} appears before its prefix")
        index[key] = len(parents)
        parents.append(index[prefix])
    return np.asarray(parents, dtype=np.int32)


def chain_paths(depth: int) -> List[List[int]]:
    """A depth-d chain."""
    return [[0] * (i + 1) for i in range(depth)]


def max_children(parents: np.ndarray) -> int:
    if len(parents) <= 1:
        return 1
    return int(np.max(np.bincount(parents[1:], minlength=len(parents))))


# The published EAGLE-1 static topology for 7B models (25 paths / 26 nodes,
# `mc_sim_7b_63`, figure 3 of arXiv:2401.15077). Each path is a chain of
# child ranks from the root.
MC_SIM_7B_63 = (
    (0,), (1,), (2,), (3,),
    (0, 0), (0, 1), (0, 2), (1, 0), (1, 1), (2, 0), (2, 1), (3, 0),
    (0, 0, 0), (0, 0, 1), (0, 0, 2), (0, 1, 0), (0, 1, 1), (0, 2, 0),
    (0, 2, 1), (1, 0, 0),
    (0, 0, 0, 0), (0, 0, 0, 1), (0, 0, 0, 2),
    (0, 0, 0, 0, 0), (0, 0, 0, 0, 1),
)

# Depth-5 chain.
CHAIN_5 = tuple(tuple([0] * (i + 1)) for i in range(5))
