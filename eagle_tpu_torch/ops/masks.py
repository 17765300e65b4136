"""Attention masks as data: explicit [B, T, S] booleans, or a TreeMaskSpec
that the tree-attention kernel consumes without expanding it."""

from __future__ import annotations

from typing import NamedTuple

import torch


class TreeMaskSpec(NamedTuple):
    """Structured tree-attention mask: expanded to the dense mask by the plain
    path, passed as-is to the tree-attention kernel."""

    tree_mask: torch.Tensor  # [B, T, Tk] ancestor-or-self
    start: torch.Tensor      # [B] committed prefix length


def prefill_mask(T: int, S: int, start: torch.Tensor) -> torch.Tensor:
    """Causal mask for T tokens appended at `start` ([B]) → [B, T, S] bool:
    query row i may attend to columns <= start + i."""
    dev = start.device
    row = torch.arange(T, device=dev)[:, None]
    col = torch.arange(S, device=dev)[None, :]
    return col[None] <= (row[None] + start.to(torch.long)[:, None, None])


def place_slab(slab: torch.Tensor, S: int, start: torch.Tensor) -> torch.Tensor:
    """Place a [B, T, W] bool slab at columns [start_b, start_b + W) of an
    all-False [B, T, S] buffer. Like `jax.lax.dynamic_update_slice`, the
    start is clamped to [0, S - W] so the slab always lies inside."""
    B, T, W = slab.shape
    st = start.to(torch.long).clamp(0, S - W)                 # [B]
    rel = torch.arange(S, device=slab.device)[None, :] - st[:, None]   # [B, S]
    inside = (rel >= 0) & (rel < W)
    idx = rel.clamp(0, W - 1)[:, None, :].expand(B, T, S)
    return torch.gather(slab, 2, idx) & inside[:, None, :]


def tree_mask_full(tree_mask: torch.Tensor, S: int, start: torch.Tensor) -> torch.Tensor:
    """Expand a [B, T, Tk] tree ancestor mask placed at `start` into a full
    [B, T, S] mask: the committed prefix (col < start) plus the tree window."""
    B, T, _ = tree_mask.shape
    col = torch.arange(S, device=tree_mask.device)
    prefix = col[None, None, :] < start.to(torch.long)[:, None, None]
    return prefix | place_slab(tree_mask, S, start)
