"""Preallocated KV cache `[L, B, n_kv, max_len, head_dim]` (bf16 or fp32).

The JAX package's caches are immutable arrays that XLA aliases under
donation. Here the cache tensors are updated IN PLACE: `update_layer` and
`compact_accepted` write into the buffers they are given and hand the same
buffers back. Offsets are device tensors (no host sync), and every window
start is clamped as `jax.lax.dynamic_update_slice` clamps it.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import resolve_device


class KVCache(NamedTuple):
    k: torch.Tensor        # [L, B, n_kv, max_len, head_dim]
    v: torch.Tensor        # [L, B, n_kv, max_len, head_dim]
    length: torch.Tensor   # [B] int64 — number of valid positions

    @property
    def max_len(self) -> int:
        return self.k.shape[3]

    @property
    def num_layers(self) -> int:
        return self.k.shape[0]


def init_cache(num_layers: int, batch: int, num_kv_heads: int, max_len: int,
               head_dim: int, dtype=torch.bfloat16, device=None,
               kv_quant: str = "none") -> KVCache:
    if kv_quant != "none":
        raise NotImplementedError(
            f"kv_quant={kv_quant!r}: the int8 KV cache is not ported yet")
    shape = (num_layers, batch, num_kv_heads, max_len, head_dim)
    device = resolve_device(device)
    return KVCache(
        k=torch.zeros(shape, dtype=dtype, device=device),
        v=torch.zeros(shape, dtype=dtype, device=device),
        length=torch.zeros((batch,), dtype=torch.long, device=device),
    )


def window(start: torch.Tensor, n: int, size: int) -> torch.Tensor:
    """Row indices [start, start + n) with start clamped to [0, size - n]."""
    st = start.to(torch.long).clamp(0, size - n)
    return st + torch.arange(n, device=start.device)


def update_layer(k_cache: torch.Tensor, v_cache: torch.Tensor,
                 k_new: torch.Tensor, v_new: torch.Tensor,
                 start: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Write T new rows at per-sequence offsets, in place.

    k_cache/v_cache: [B, n_kv, S, d]; k_new/v_new: [B, T, n_kv, d]; start: [B].
    """
    B, T = k_new.shape[:2]
    S = k_cache.shape[2]
    for b in range(B):
        idx = window(start[b], T, S)
        k_cache[b].index_copy_(1, idx, k_new[b].transpose(0, 1).to(k_cache.dtype))
        v_cache[b].index_copy_(1, idx, v_new[b].transpose(0, 1).to(v_cache.dtype))
    return k_cache, v_cache


def compact_rows_plain(k: torch.Tensor, v: torch.Tensor, path: torch.Tensor,
                       start: torch.Tensor, b: int = 0) -> None:
    """Move rows start + path[i] → start + i (i < P) of sequence b in every
    layer and kv head, in place. All P rows are gathered before any is
    written, since source and destination windows overlap."""
    S = k.shape[3]
    P = path.shape[0]
    src = (start.to(torch.long) + path.to(torch.long)).clamp(0, S - 1)
    dst = window(start, P, S)
    for t in (k, v):
        rows = t[:, b].index_select(2, src)          # [L, n_kv, P, d] copy
        t[:, b].index_copy_(2, dst, rows)


def compact_accepted(cache: KVCache, path: torch.Tensor,
                     accept_len: torch.Tensor) -> KVCache:
    """Compact the accepted tree branch to the contiguous tail of the cache.

    After a tree-verify forward wrote the tree at offset `length`, rows
    `length + path[b, i]` move to `length + i`. path: [B, P] node indices;
    accept_len: [B]. Returns the same buffers with length += accept_len.
    This is the plain version of the compaction kernel
    (ops/attn_kernels.compact_rows).
    """
    for b in range(path.shape[0]):
        compact_rows_plain(cache.k, cache.v, path[b], cache.length[b], b)
    return KVCache(k=cache.k, v=cache.v,
                   length=cache.length + accept_len.to(torch.long))


def with_length(cache: KVCache, length: torch.Tensor) -> KVCache:
    return cache._replace(length=length)
