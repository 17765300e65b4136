"""The attention-side CUDA kernels (two of the port's five), with their plain
PyTorch versions.

- `tree_attention` (csrc/tree_attention.cu) replaces the Pallas kernel
  eagle_tpu/ops/pallas_attn.py:_tree_attn_kernel; its plain version is
  `tree_attention_ref`, a port of pallas_attn.tree_attention_xla. In bf16
  it runs on tensor cores, split over the prefix in chunks of `TREE_CHUNK`
  keys, and merges the chunks' partials in the same launch; `tree_plan`
  gives the launch its grid and the padded head width it runs at (any
  head_dim up to `TREE_MAX_HEAD_DIM`).
- `compact_rows` (csrc/compact_rows.cu) replaces
  pallas_attn.py:_compact_kernel; its plain version is
  ops/kv_cache.compact_accepted (`compact_rows_plain`).

The w4a8 matmul kernels live in ops/quant4.py and the fused score+top-k
kernel in ops/score_topk.py.

Each wrapper takes its plain version only for CPU tensors. A CUDA tensor goes
to the kernel, or the wrapper raises. `LAUNCHES` (ops/_launch.py, shared by
all five wrappers) counts kernel launches per wrapper, a plain integer each,
so a run can show the path went through them.
"""

from __future__ import annotations

import ctypes

import torch

from . import _launch
from ._launch import (LAUNCHES, check_launch as _check_launch,
                      entry_point as _lib, require_cuda as _require_cuda,
                      reset_launch_counts, stream as _stream)
from .kv_cache import compact_rows_plain

__all__ = ["LAUNCHES", "reset_launch_counts", "tree_attention",
           "tree_attention_ref", "tree_plan", "compact_rows"]

NEG_INF = -1e30

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _row_stride(t: torch.Tensor, d: int, name: str) -> int:
    """Rows between two kv heads of a cache slab [.., n_kv, S, d]: S for a
    contiguous buffer, the full buffer's S for a view of its first rows
    (ops/kv_cache.slice_rows, length-bucketed decoding). Any other layout is
    refused. Both kernels take this number as the head stride; B2 also
    clamps its window starts to it (a round that fits its bucket never
    reaches the clamp), and B1 clamps `start` to the view's own rows."""
    S = t.shape[-2]
    strides = t.stride()
    head = strides[-3]
    ok = strides[-1] == 1 and strides[-2] == d and head % d == 0 and head >= S * d
    for i in range(t.ndim - 3):      # leading dims are packed over the heads
        ok = ok and (t.shape[i] == 1 or strides[i] == strides[i + 1] * t.shape[i + 1])
    if not ok:
        raise ValueError(f"{name}: the cache must be contiguous, or a view of the "
                         f"first rows of a contiguous cache (strides {strides})")
    return head // d


def _device_int32(x, device) -> torch.Tensor:
    """A one-element int32 tensor on `device` (a device scalar stays there:
    no host sync)."""
    if not torch.is_tensor(x):
        x = torch.tensor(int(x), device=device)
    return x.reshape(1).to(device=device, dtype=torch.int32)


# ---------------------------------------------------------------------------
# B1: tree-verify attention
# ---------------------------------------------------------------------------

def tree_attention_ref(q, k_cache, v_cache, k_tree, v_tree, tree_mask, start):
    """Plain version: the same math as transformer.attention over the
    concatenated prefix + tree key space.

    q: [T, nq, d]; k/v_cache: [n_kv, S, d] (rows < start attended);
    k/v_tree: [Tk, n_kv, d]; tree_mask: [T, Tk] bool; start: scalar.
    Returns [T, nq*d] in q.dtype.
    """
    T, nq, d = q.shape
    n_kv, S, _ = k_cache.shape
    g = nq // n_kv
    start = torch.as_tensor(start, device=q.device).reshape(())
    mask_p = torch.arange(S, device=q.device) < start                  # [S]
    qh = q.reshape(T, n_kv, g, d).permute(1, 2, 0, 3).float()          # [h,g,T,d]
    kt = k_tree.transpose(0, 1).float()                                # [h,Tk,d]
    vt = v_tree.transpose(0, 1).float()
    scale = d ** -0.5
    sp = torch.einsum("hgtd,hsd->hgts", qh, k_cache.float()) * scale
    sp = torch.where(mask_p[None, None, None, :], sp, NEG_INF)
    st = torch.einsum("hgtd,hsd->hgts", qh, kt) * scale
    st = torch.where(tree_mask[None, None], st, NEG_INF)
    p = torch.softmax(torch.cat([sp, st], dim=-1), dim=-1)
    v_all = torch.cat([v_cache.float(), vt], dim=1)
    o = torch.einsum("hgts,hsd->hgtd", p, v_all).to(q.dtype)
    return o.permute(2, 0, 1, 3).reshape(T, nq * d)


# query rows and prefix keys a block of the bf16 kernel: its geometry, which
# the launch checks against its own; the padded head widths the kernels are
# built at (a head_dim runs at the smallest that holds it)
TREE_ROWS, TREE_CHUNK = 64, 256
TREE_HEAD_PADS = (64, 128, 256)
TREE_MAX_HEAD_DIM = TREE_HEAD_PADS[-1]


def tree_plan(T: int, nq: int, n_kv: int, S_rows: int, d: int) -> dict:
    """Grid of the bf16 kernel from host-known numbers only: (row tiles of
    the T*g query rows of a kv head, prefix chunks + 1 for the tree's own
    keys, n_kv heads), and `head_pad`, the padded head width both kernels
    run at for head_dim `d` (zeros past d in shared memory; the partials
    are laid out by it). S_rows is the cache's row count (a view's, for a
    row-sliced cache), not its head stride. Prefix chunk c covers keys
    [c*TREE_CHUNK, min((c+1)*TREE_CHUNK, start)); a chunk with no key below
    the device's `start` exits at once."""
    if not 1 <= d <= TREE_MAX_HEAD_DIM:
        raise ValueError(f"tree_attention: head_dim {d} is not built; the kernels take "
                         f"head_dim 1 .. {TREE_MAX_HEAD_DIM}")
    return {"row_tiles": -(-T * (nq // n_kv) // TREE_ROWS),
            "chunks": -(-S_rows // TREE_CHUNK),
            "head_pad": next(p for p in TREE_HEAD_PADS if d <= p)}


# CUDA stream -> the bf16 kernel's merge counters, one per (kv head, row
# tile): zero, and left zero by every launch
_COUNTERS: dict = {}

_TREE_ARGS = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 13 + [ctypes.c_float, ctypes.c_void_p]


def tree_attention(q, k_cache, v_cache, k_tree, v_tree, tree_mask, start):
    """Fused tree-verify attention for one sequence (layouts as
    `tree_attention_ref`). CUDA tensors run csrc/tree_attention.cu; CPU
    tensors run the plain version."""
    if q.device.type == "cpu":
        return tree_attention_ref(q, k_cache, v_cache, k_tree, v_tree,
                                  tree_mask, start)
    _require_cuda("tree_attention", q)
    T, nq, d = q.shape
    n_kv, S, d2 = k_cache.shape
    Tk = k_tree.shape[0]
    dev = q.device
    tensors = (q, k_cache, v_cache, k_tree, v_tree, tree_mask)
    if any(t.device != dev for t in tensors):
        raise ValueError("tree_attention: all tensors must be on one device")
    if q.dtype not in _DTYPE_CODE or any(t.dtype != q.dtype for t in tensors[1:5]):
        raise TypeError(f"tree_attention: q/k/v must share one dtype of "
                        f"float32/bfloat16, got {[t.dtype for t in tensors[:5]]}")
    if tree_mask.dtype != torch.bool:
        raise TypeError("tree_attention: tree_mask must be bool")
    if (d2 != d or nq % n_kv != 0
            or v_cache.shape != k_cache.shape
            or k_tree.shape != (Tk, n_kv, d) or v_tree.shape != k_tree.shape
            or tree_mask.shape != (T, Tk)):
        raise ValueError(
            f"tree_attention: bad shapes q{tuple(q.shape)} "
            f"k_cache{tuple(k_cache.shape)} k_tree{tuple(k_tree.shape)} "
            f"mask{tuple(tree_mask.shape)}")
    if not all(t.is_contiguous() for t in (q, k_tree, v_tree, tree_mask)):
        raise ValueError("tree_attention: inputs must be contiguous")
    head_stride = _row_stride(k_cache, d, "tree_attention")
    if _row_stride(v_cache, d, "tree_attention") != head_stride:
        raise ValueError("tree_attention: k_cache and v_cache must share one layout")
    if (d * q.element_size()) % 16 == 0 and any(t.data_ptr() % 16 for t in tensors[:5]):
        # rows of a whole number of 16-byte chunks load by 16-byte copies
        raise ValueError("tree_attention: q/k/v must be 16-byte aligned")
    # temporaries passed by pointer (st, the partials, p32 below) may be freed
    # when the wrapper returns: the caching allocator reuses their memory only
    # for work queued later on the same stream, so the kernel still has them
    st = _device_int32(start, dev)
    out = torch.empty((T, nq * d), dtype=q.dtype, device=dev)
    plan = tree_plan(T, nq, n_kv, S, d)
    slots = n_kv * plan["row_tiles"] * (plan["chunks"] + 1)
    if q.dtype == torch.bfloat16:
        part_acc = torch.empty(slots * TREE_ROWS * plan["head_pad"], dtype=torch.float32,
                               device=dev)
        part_ml = torch.empty(slots * 2 * TREE_ROWS, dtype=torch.float32, device=dev)
        counters = _launch.zeroed_counters(_COUNTERS, torch.cuda.current_stream(dev),
                                           n_kv * plan["row_tiles"])
        scratch = (part_acc.data_ptr(), part_ml.data_ptr(), counters.data_ptr())
    else:
        scratch = (None, None, None)
    fn = _lib("tree_attention", _TREE_ARGS)
    err = fn(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
             k_tree.data_ptr(), v_tree.data_ptr(), tree_mask.data_ptr(),
             st.data_ptr(), out.data_ptr(), *scratch, _DTYPE_CODE[q.dtype], T, Tk,
             nq, n_kv, S, head_stride, d, plan["head_pad"], TREE_ROWS, TREE_CHUNK,
             plan["row_tiles"], plan["chunks"], d ** -0.5, _stream())
    _check_launch("tree_attention", err)
    LAUNCHES["tree_attention"] += 1
    return out


# ---------------------------------------------------------------------------
# B2: in-place accepted-branch KV compaction
# ---------------------------------------------------------------------------

_COMPACT_ARGS = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
# the P rows of one slab a block holds in registers: 128 threads x 16 words
# of 16 bytes (csrc/compact_rows.cu)
COMPACT_MAX_BYTES = 128 * 16 * 16


def compact_rows(k, v, path, start):
    """Move rows start + path[i] → start + i (i < P) of every layer and kv
    head of k/v [L, 1, n_kv, S, d], in place; returns (k, v).

    path: [P] node indices within the tree window; start: scalar prefix
    length (a device tensor stays on the device). Only the P accepted rows
    move. CUDA tensors run csrc/compact_rows.cu; CPU tensors run the plain
    version (ops/kv_cache.compact_accepted's row moves).
    """
    if k.device.type == "cpu":
        compact_rows_plain(k, v, path, torch.as_tensor(start, device=k.device))
        return k, v
    _require_cuda("compact_rows", k)
    L, B, n_kv, S, d = k.shape
    P = path.shape[0]
    dev = k.device
    if v.shape != k.shape or v.dtype != k.dtype or B != 1:
        raise ValueError(f"compact_rows: k/v must share one [L, 1, n_kv, S, d] "
                         f"shape and dtype, got {tuple(k.shape)}, {tuple(v.shape)}")
    if v.device != dev or path.device != dev:
        raise ValueError("compact_rows: all tensors must be on one device")
    S = _row_stride(k, d, "compact_rows")
    if _row_stride(v, d, "compact_rows") != S:
        raise ValueError("compact_rows: k and v must share one layout")
    row_bytes = d * k.element_size()
    if row_bytes % 16 or P < 1 or P > S or P * row_bytes > COMPACT_MAX_BYTES:
        raise ValueError(f"compact_rows: unsupported P={P}, row of {row_bytes} bytes "
                         f"(rows must be a multiple of 16 bytes, P rows at most "
                         f"{COMPACT_MAX_BYTES} bytes)")
    if k.data_ptr() % 16 or v.data_ptr() % 16:
        raise ValueError("compact_rows: k/v must be 16-byte aligned")
    p32 = path.to(torch.int32).contiguous()
    st = _device_int32(start, dev)
    fn = _lib("compact_rows", _COMPACT_ARGS)
    err = fn(k.data_ptr(), v.data_ptr(), p32.data_ptr(), st.data_ptr(),
             L * B * n_kv, P, S, row_bytes, _stream())
    _check_launch("compact_rows", err)
    LAUNCHES["compact_rows"] += 1
    return k, v
