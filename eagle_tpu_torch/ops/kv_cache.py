"""Preallocated KV cache `[L, B, n_kv, max_len, head_dim]` (bf16, fp32 or
int8 with row scales).

The JAX package's caches are immutable arrays that XLA aliases under
donation. Here the cache tensors are updated IN PLACE: `update_layer`,
`update_layer_q` and `compact_accepted` write into the buffers they are
given and hand the same buffers back. Offsets are device tensors (no host
sync), and every window start is clamped as `jax.lax.dynamic_update_slice`
clamps it.

`kv_quant="int8"`: values are stored as int8 with one fp32 absmax scale per
(layer, batch, kv head, row) in `ks` / `vs`. `update_layer_q` quantizes on
write; attention folds the scales into its fp32 scores and probabilities
(models/transformer.attention), so a dequantized cache never exists. Row
moves (compaction, slicing) carry payload and scale verbatim.

Because updates are in place, `slice_rows` (length-bucketed decoding) is a
VIEW of the first n rows, and whatever a step writes through the view is
already in the full buffers: `merge_rows` / `merge_rows_window` copy
nothing, they check that the small cache is such a view and hand back the
full buffers with the new length.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .. import resolve_device
from .quant import true_div


class KVCache(NamedTuple):
    k: torch.Tensor        # [L, B, n_kv, max_len, head_dim] (float or int8)
    v: torch.Tensor        # [L, B, n_kv, max_len, head_dim]
    length: torch.Tensor   # [B] int64 — number of valid positions
    # int8-KV row scales (None for float caches): fp32 [L, B, n_kv, max_len]
    ks: Optional[torch.Tensor] = None
    vs: Optional[torch.Tensor] = None

    @property
    def max_len(self) -> int:
        return self.k.shape[3]

    @property
    def num_layers(self) -> int:
        return self.k.shape[0]

    @property
    def quantized(self) -> bool:
        return self.ks is not None


def init_cache(num_layers: int, batch: int, num_kv_heads: int, max_len: int,
               head_dim: int, dtype=torch.bfloat16, device=None,
               kv_quant: str = "none") -> KVCache:
    shape = (num_layers, batch, num_kv_heads, max_len, head_dim)
    device = resolve_device(device)
    if kv_quant == "int8":
        return KVCache(
            k=torch.zeros(shape, dtype=torch.int8, device=device),
            v=torch.zeros(shape, dtype=torch.int8, device=device),
            length=torch.zeros((batch,), dtype=torch.long, device=device),
            ks=torch.zeros(shape[:-1], dtype=torch.float32, device=device),
            vs=torch.zeros(shape[:-1], dtype=torch.float32, device=device),
        )
    if kv_quant != "none":
        raise ValueError(f"unknown kv_quant {kv_quant!r} (expected 'none' | 'int8')")
    return KVCache(
        k=torch.zeros(shape, dtype=dtype, device=device),
        v=torch.zeros(shape, dtype=dtype, device=device),
        length=torch.zeros((batch,), dtype=torch.long, device=device),
    )


def windows(start: torch.Tensor, n: int, size: int) -> torch.Tensor:
    """Row indices [start_b, start_b + n) of every sequence, start [B] →
    [B, n], each start clamped to [0, size - n]."""
    st = start.to(torch.long).clamp(0, size - n)
    return st[:, None] + torch.arange(n, device=start.device)


def window(start: torch.Tensor, n: int, size: int) -> torch.Tensor:
    """`windows` of one sequence: a scalar start → [n]."""
    return windows(start.reshape(1), n, size)[0]


def _scatter_rows(cache: torch.Tensor, rows: torch.Tensor, idx: torch.Tensor) -> None:
    """cache[b, :, idx[b, i]] = rows[b, :, i] for every b and i, in place, in
    one scatter. cache: [B, n_kv, S(, d)]; rows: [B, n_kv, n(, d)]; idx:
    [B, n]."""
    shape = (rows.shape[0], rows.shape[1], idx.shape[1]) + rows.shape[3:]
    full = idx.reshape(idx.shape[0], 1, idx.shape[1], *([1] * (rows.dim() - 3)))
    cache.scatter_(2, full.expand(shape), rows.to(cache.dtype))


def update_layer(k_cache: torch.Tensor, v_cache: torch.Tensor,
                 k_new: torch.Tensor, v_new: torch.Tensor,
                 start: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Write T new rows at per-sequence offsets, in place, one scatter for
    the whole batch.

    k_cache/v_cache: [B, n_kv, S, d]; k_new/v_new: [B, T, n_kv, d]; start: [B].
    """
    idx = windows(start, k_new.shape[1], k_cache.shape[2])
    _scatter_rows(k_cache, k_new.transpose(1, 2), idx)
    _scatter_rows(v_cache, v_new.transpose(1, 2), idx)
    return k_cache, v_cache


def quantize_kv_rows(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row absmax int8 quantization over the trailing head_dim.

    x: [..., d] → (int8 [..., d], fp32 scale [...]). Dequant is
    `q.float() * scale[..., None]`. The scale is a true division by 127 on
    either device (ops/quant.true_div)."""
    xf = x.to(torch.float32)
    amax = torch.amax(torch.abs(xf), dim=-1)
    scale = true_div(amax, 127.0)
    q = torch.round(xf / torch.clamp(scale, min=1e-30)[..., None])
    return q.to(torch.int8), scale


def update_layer_q(k_cache: torch.Tensor, v_cache: torch.Tensor,
                   ks_cache: torch.Tensor, vs_cache: torch.Tensor,
                   k_new: torch.Tensor, v_new: torch.Tensor, start: torch.Tensor):
    """int8 variant of `update_layer`: quantize the T new rows and write
    values and per-row scales, in place. ks_cache/vs_cache: [B, n_kv, S]."""
    kq, ks = quantize_kv_rows(k_new)        # [B, T, n_kv, d], [B, T, n_kv]
    vq, vs = quantize_kv_rows(v_new)
    update_layer(k_cache, v_cache, kq, vq, start)
    idx = windows(start, ks.shape[1], ks_cache.shape[2])
    _scatter_rows(ks_cache, ks.transpose(1, 2), idx)
    _scatter_rows(vs_cache, vs.transpose(1, 2), idx)
    return k_cache, v_cache, ks_cache, vs_cache


def _move_rows(tensors, path: torch.Tensor, start: torch.Tensor) -> None:
    """Move rows start[b] + path[b, i] → start[b] + i (i < P) of every
    sequence b, layer and kv head of each [L, B, n_kv, S(, d)] tensor (K/V
    payloads or int8 row scales), in place: per tensor one gather of all the
    rows (a copy, since source and destination windows overlap) and one
    scatter."""
    S = tensors[0].shape[3]
    P = path.shape[1]
    start = start.to(torch.long)
    src = (start[:, None] + path.to(torch.long)).clamp(0, S - 1)      # [B, P]
    dst = windows(start, P, S)
    for t in tensors:
        lead = t.shape[0]
        flat = t.view(lead * t.shape[1], *t.shape[2:])    # layers x sequences
        rows = _gather_rows(flat, src.repeat(lead, 1))
        _scatter_rows(flat, rows, dst.repeat(lead, 1))


def compact_rows_plain(k: torch.Tensor, v: torch.Tensor, path: torch.Tensor,
                       start: torch.Tensor) -> None:
    """The compaction kernel's plain version: move rows start + path[i] →
    start + i (i < P) of k and v [L, 1, n_kv, S, d] in every layer and kv
    head, in place."""
    _move_rows((k, v), path[None], start.reshape(1))


def compact_accepted(cache: KVCache, path: torch.Tensor,
                     accept_len: torch.Tensor) -> KVCache:
    """Compact the accepted tree branch to the contiguous tail of the cache.

    After a tree-verify forward wrote the tree at offset `length`, rows
    `length + path[b, i]` move to `length + i` (i < P), for every sequence
    and layer at once. path: [B, P] node indices; accept_len: [B]. Returns
    the same buffers with length += accept_len. For one sequence this is
    the plain version of the compaction kernel (ops/attn_kernels.compact_rows);
    a batch always takes it, as in the JAX package. An int8 cache moves its
    quantized payload and its row scales verbatim (lossless).
    """
    scales = (cache.ks, cache.vs) if cache.ks is not None else ()
    _move_rows((cache.k, cache.v) + scales, path, cache.length)
    return cache._replace(length=cache.length + accept_len.to(torch.long))


def _gather_rows(cache: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """cache[b, :, idx[b, i]] → [B, n_kv, n(, d)], a copy."""
    shape = (cache.shape[0], cache.shape[1], idx.shape[1]) + cache.shape[3:]
    full = idx.reshape(idx.shape[0], 1, idx.shape[1], *([1] * (cache.dim() - 3)))
    return cache.gather(2, full.expand(shape))


def with_length(cache: KVCache, length: torch.Tensor) -> KVCache:
    return cache._replace(length=length)


def slice_rows(cache: KVCache, n: int) -> KVCache:
    """The first n KV rows (length-bucketed decode reads), as VIEWS of the
    cache's buffers: what is written through them lands in the full cache."""
    return KVCache(
        k=cache.k[:, :, :, :n, :], v=cache.v[:, :, :, :n, :], length=cache.length,
        ks=None if cache.ks is None else cache.ks[:, :, :, :n],
        vs=None if cache.vs is None else cache.vs[:, :, :, :n])


def _check_view(full: KVCache, small: KVCache) -> None:
    pairs = [(full.k, small.k), (full.v, small.v)]
    if full.ks is not None:
        pairs += [(full.ks, small.ks), (full.vs, small.vs)]
    for f, s in pairs:
        if s is None or s.data_ptr() != f.data_ptr() or s.stride() != f.stride():
            raise ValueError("merge_rows: the small cache must be a slice_rows "
                             "view of the full one (caches are updated in place)")


def merge_rows(full: KVCache, small: KVCache, n: int) -> KVCache:
    """The other half of `slice_rows`. The JAX package copies the small
    cache's first n rows back; here `small` is a view of `full`, its writes
    are already there, so this checks that and returns the full buffers with
    the small cache's length. No copy."""
    del n
    _check_view(full, small)
    return full._replace(length=small.length)


def merge_rows_window(full: KVCache, small: KVCache, start: torch.Tensor,
                      n: int) -> KVCache:
    """As `merge_rows` (the JAX package writes back only rows [start,
    start + n), the rows a step can modify; here nothing is copied)."""
    del start
    return merge_rows(full, small, n)
