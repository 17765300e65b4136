"""Tree-topology math on tensors: a [N] parent vector determines the tree,
and every derived structure is computed with fixed-shape ops on the device.

Conventions (as in the JAX package): node 0 is the root, parents[0] == 0,
parents[i] < i for i > 0. Index tensors are int64.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F


class Tree(NamedTuple):
    tokens: torch.Tensor     # [N] target-vocab token per node (node 0 = root)
    parents: torch.Tensor    # [N] parent index; parents[0] = 0
    mask: torch.Tensor       # [N, N] bool ancestor-or-self
    positions: torch.Tensor  # [N] node depth (root = 0)
    children: torch.Tensor   # [N, K] child ids in node order, -1 padded
    node_probs: Optional[torch.Tensor] = None

    @property
    def num_nodes(self) -> int:
        return self.tokens.shape[0]


def ancestor_mask(parents: torch.Tensor, max_depth: int) -> torch.Tensor:
    """[N] parents → [N, N] ancestor-or-self bool, by repeated squaring of
    the parent-step relation (fp32 products of 0/1 entries are exact)."""
    N = parents.shape[0]
    eye = torch.eye(N, dtype=torch.bool, device=parents.device)
    step = eye | F.one_hot(parents.to(torch.long), N).bool()
    step[0] = eye[0]
    closure = step
    hops = 1
    while hops < max_depth:
        c = closure.to(torch.float32)
        closure = (c @ c) > 0
        hops *= 2
    return closure


def depths_from_mask(mask: torch.Tensor) -> torch.Tensor:
    return mask.sum(dim=1) - 1


def children_table(parents: torch.Tensor, k: int) -> torch.Tensor:
    """[N] parents → [N, k] children ids (-1 padded), in node-index order."""
    N = parents.shape[0]
    parents = parents.to(torch.long)
    idx = torch.arange(N, device=parents.device)
    onehot = F.one_hot(parents, N) * (idx > 0)[:, None]
    rank = torch.cumsum(onehot, dim=0) - onehot          # exclusive cumsum
    sib_rank = torch.gather(rank, 1, parents[:, None])[:, 0]
    valid = (idx > 0) & (sib_rank < k)
    children = torch.full((N, k + 1), -1, dtype=torch.long, device=parents.device)
    col = torch.where(valid, sib_rank, k)
    # invalid rows all write -1 into the dump column k, sliced off below
    children[parents, col] = torch.where(valid, idx, -1)
    return children[:, :k]


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
