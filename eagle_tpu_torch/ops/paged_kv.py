"""Paged KV storage: a shared page pool with per-slot block tables.

Port of eagle_tpu/ops/paged_kv.py. KV rows live in a pool of fixed-size
pages shared by every slot; a slot's block table maps its logical row i to
the physical row `bt[i // P] * P + i % P`, pages are allocated as sequences
grow and recycled when they finish, so capacity scales with the sum of live
context lengths rather than batch x max_len.

- The pool is `[L, R, n_kv, d]` (R = pages x P rows), row before heads as
  the JAX package argues: a physical row's (n_kv, d) values are contiguous,
  the layout the page gather and scatter move. An int8 pool adds fp32
  `[L, R, n_kv]` row scales, moved with their rows.
- A served round runs gather -> round -> scatter: each slot's logical rows
  [0, W) are gathered into the batched dense layout the round reads
  (`[L, B, n_kv, W, d]`), the unmodified round runs on it, and only the rows
  it wrote (`path_len` a slot from its length) are scattered back.
- Page 0 is the trash page: free block-table entries point at it, so the
  fixed-shape gather and scatter never branch; its rows are masked by
  length on read, and inactive slots' writes land there.

The JAX package does this with XLA gathers and scatters, no Pallas kernel,
so here it is plain indexing: `index_select` and `index_copy_` over the
pool's flattened rows, in place. Allocation lives on the host
(engine/paged.py).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .. import resolve_device


class PagePool(NamedTuple):
    k: torch.Tensor  # [L, R, n_kv, d], R = num_pages * page_size rows
    v: torch.Tensor  # [L, R, n_kv, d]
    # int8-KV row scales (None for float pools): fp32 [L, R, n_kv]
    ks: Optional[torch.Tensor] = None
    vs: Optional[torch.Tensor] = None

    @property
    def rows(self) -> int:
        return self.k.shape[1]

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in self if t is not None)


def init_pool(num_layers: int, num_kv_heads: int, num_pages: int, page_size: int,
              head_dim: int, dtype=torch.bfloat16, kv_quant: str = "none",
              device=None) -> PagePool:
    shape = (num_layers, num_pages * page_size, num_kv_heads, head_dim)
    dev = resolve_device(device)
    if kv_quant == "int8":
        return PagePool(k=torch.zeros(shape, dtype=torch.int8, device=dev),
                        v=torch.zeros(shape, dtype=torch.int8, device=dev),
                        ks=torch.zeros(shape[:-1], dtype=torch.float32, device=dev),
                        vs=torch.zeros(shape[:-1], dtype=torch.float32, device=dev))
    if kv_quant != "none":
        raise ValueError(f"unknown kv_quant {kv_quant!r}")
    return PagePool(k=torch.zeros(shape, dtype=dtype, device=dev),
                    v=torch.zeros(shape, dtype=dtype, device=dev))


def _window_rows(block_tables: torch.Tensor, window: int, page_size: int) -> torch.Tensor:
    """Physical rows of each slot's logical rows [0, window): [B, window]."""
    P = page_size
    npg = -(-window // P)
    pages = block_tables[:, :npg].to(torch.long)
    rows = pages[:, :, None] * P + torch.arange(P, device=pages.device)
    return rows.reshape(pages.shape[0], npg * P)[:, :window]


def _to_slab(x: torch.Tensor, B: int, n: int) -> torch.Tensor:
    """[L, B * n, n_kv(, d)] pool rows -> the cache layout [L, B, n_kv, n(, d)]."""
    x = x.reshape(x.shape[0], B, n, *x.shape[2:])
    return x.transpose(2, 3).contiguous()


def _from_slab(x: torch.Tensor) -> torch.Tensor:
    """[L, B, n_kv, n(, d)] cache rows -> [L, B * n, n_kv(, d)] pool rows."""
    x = x.transpose(2, 3)
    return x.reshape(x.shape[0], x.shape[1] * x.shape[2], *x.shape[3:])


def gather_windows(pool: PagePool, block_tables: torch.Tensor, window: int,
                   page_size: int):
    """Each slot's logical rows [0, window) as a contiguous dense cache.

    block_tables: [B, max_pages] physical page ids (0: the trash page, for
    rows never allocated; their values are garbage, masked by length
    downstream). Returns (k, v, ks, vs): k/v [L, B, n_kv, window, d], the
    batched cache layout of ops/kv_cache.py; ks/vs [L, B, n_kv, window], or
    None for a float pool. (The JAX function returns [B, L, 1, n_kv,
    window, d], the per-slot layout its vmapped round takes.)"""
    rows = _window_rows(block_tables, window, page_size)
    B = rows.shape[0]
    flat = rows.reshape(-1)
    out = [None if t is None else _to_slab(t.index_select(1, flat), B, window)
           for t in pool]
    return tuple(out)


def scatter_rows(pool: PagePool, block_tables: torch.Tensor, window_k: torch.Tensor,
                 window_v: torch.Tensor, starts: torch.Tensor, n_rows: int,
                 page_size: int, active: torch.Tensor, window_ks=None,
                 window_vs=None) -> PagePool:
    """Write each slot's window rows [starts_b, starts_b + n_rows) back to the
    pool, in place (the rows a round or a chunk wrote). `active`: [B] bool;
    inactive slots write to rows [0, n_rows) of the trash page (their block
    tables may be stale). Active slots never share a page, so their writes
    do not collide.

    window_k/v: [L, B, n_kv, W, d]; starts: [B]; window_ks/vs: [L, B, n_kv, W]
    (int8 pools)."""
    P = page_size
    B, W = window_k.shape[1], window_k.shape[3]
    dev = window_k.device
    ar = torch.arange(n_rows, device=dev)
    logical = starts.to(torch.long)[:, None] + ar                      # [B, n]
    page = (logical // P).clamp(0, block_tables.shape[1] - 1)
    phys = block_tables.to(torch.long).gather(1, page) * P + logical % P
    phys = torch.where(active[:, None], phys, (ar % P)[None])
    src = logical.clamp(0, W - 1)
    flat = phys.reshape(-1)
    windows = (window_k, window_v, window_ks, window_vs)
    for dst, win in zip(pool, windows):
        if dst is None:
            continue
        idx = src.reshape(1, B, 1, n_rows, *([1] * (win.dim() - 4)))
        rows = win.gather(3, idx.expand(*win.shape[:3], n_rows, *win.shape[4:]))
        dst.index_copy_(1, flat, _from_slab(rows).to(dst.dtype))
    return pool


def scatter_prefix(pool: PagePool, pages: torch.Tensor, cache_k: torch.Tensor,
                   cache_v: torch.Tensor, page_size: int, cache_ks=None,
                   cache_vs=None) -> PagePool:
    """Whole-page scatter of a freshly prefilled dense cache into the pool,
    in place.

    cache_k/v: [L, 1, n_kv, Tp, d] with Tp % page_size == 0 (prompt buckets
    are whole pages); pages: [Tp / P] physical page ids covering logical rows
    [0, Tp). Rows past the prompt are garbage, masked by length.
    cache_ks/vs: [L, 1, n_kv, Tp] (int8 pools)."""
    P = page_size
    Tp = cache_k.shape[3]
    if Tp % P:
        raise ValueError(f"scatter_prefix: {Tp} rows are not whole pages of {P}")
    phys = (pages.to(torch.long)[:, None] * P
            + torch.arange(P, device=pages.device)).reshape(-1)
    for dst, src in zip(pool, (cache_k, cache_v, cache_ks, cache_vs)):
        if dst is not None:
            dst.index_copy_(1, phys, _from_slab(src).to(dst.dtype))
    return pool
