"""Fused draft scoring: quantized lm_head matmul + log-softmax + exact top-k
in one kernel call, with its plain PyTorch version.

Port of eagle_tpu/ops/score_topk.py. `score_topk_quant` (kernel B5,
csrc/score_topk.cu) replaces the Pallas kernel _score_topk_kernel;
`score_topk_ref` is the plain version: the unfused chain through
`qdense` / `qdense4_ref`, the cast through the hidden dtype, `log_softmax`
and the stable-sort `topk_rows`. For an int4 head the kernel runs B3/B4's
main loop on int8 tensor cores and merges its column tiles in the same
launch, as `score_plan` plans it (`w4_score_kernel` launches it on rows
already quantized); an int8 head keeps a tile kernel and a merge kernel.
Past `MAX_K` (one column tile) both heads take a second route in the same
wrapper: the tile pass writes the logits, and a selection kernel picks each
row's k best by an exact radix select (two launches).

Contract: candidate ids are bit-identical to the unfused chain (the same
logit values, the same order: value descending, then index ascending);
scores are log-softmax values that differ from the unfused ones only by the
order of the logsumexp sum (SCORE_TOL). Weight formats: int8 {"q8", "scale"}
and packed int4 {"q4", "scale"} in the single-block layout.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from . import _launch
from .quant import qdense, quantize_rows
from .quant4 import (W4_STAGE_ROWS, W4_STAGES, W4_SMEM_MAX, _blocks_of, _k_of,
                     qdense4_ref, quantize_for_w4)

# fused vs unfused scores: the logsumexp is summed per column tile (128
# columns for w4, 64 for w8) and then over the tiles, instead of along the
# row; a few f32 ulp of a value of magnitude ~10
SCORE_TOL = dict(rtol=1e-5, atol=1e-5)
# k the fused route takes (one column tile; past it the select route), and k
# up to which the w4 merge holds its candidates in registers (past it: a
# k-way merge over the tiles)
MAX_K, SMALL_K = 128, 16
# candidates the select route sorts in shared memory (past it: in workspace)
SORT_SMEM = 8192


def topk_rows(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k along the last axis: values descending, ties broken by
    ascending index (a stable sort keeps equal values in index order)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _kind(qw: dict) -> str:
    if "q4" in qw:
        if _blocks_of(qw["q4"]) != 1:
            raise ValueError("fused scoring takes the single-block int4 layout only")
        return "w4"
    return "w8"


def score_topk_ref(h2d: torch.Tensor, qw: dict, k: int):
    """Plain version of `score_topk_quant`: (log-softmax top-k scores [M, k]
    f32, ids [M, k] int64) of h2d [M, K] against a quantized lm_head."""
    dense = qdense4_ref if _kind(qw) == "w4" else qdense
    logits = dense(h2d, qw).to(torch.float32)     # rounded through h2d.dtype
    return topk_rows(torch.log_softmax(logits, dim=-1), k)


# ---------------------------------------------------------------------------
# the w4 kernel's geometry (csrc/score_topk.cu checks every plan against its
# own): B3/B4's main loop (ring of 4 stages of 32 word rows) over row tiles of
# 16 or 32 rows and 128 columns, 8 warps a block
# ---------------------------------------------------------------------------

SCORE_ROW_TILES = (16, 32)
SCORE_NTILE, SCORE_WARPS = 128, 8
W8_TILE = 64          # columns per block of the w8 tile kernel


class ScorePlan(NamedTuple):
    """How csrc/score_topk.cu runs one w4 call."""

    bm: int               # rows per block (16 or 32; more rows: more row tiles)
    vec: bool             # 16-byte copies (aligned rows, groups, halves, columns)
    grid: tuple           # (row tiles, column tiles)
    smem: int             # dynamic shared memory, bytes


def score_plan(M: int, K: int, V: int, G: int, k: int) -> ScorePlan:
    """The launch plan of the w4 scoring kernel, from host-known shapes only:
    the narrowest row tile that holds all M rows (every block reads the
    head's words once for all of them), 32-row tiles on the grid past 32
    rows, 128 columns a block. Its shared memory holds, one after the other
    in time, the main loop's ring, the tile's logits and the merge's state
    per warp: the T tile heads, and for k > SMALL_K also each tile's next
    candidate and its position. Past MAX_K (the select route) the tiles
    write their logits out and the shared memory is the ring alone."""
    if M < 1:
        raise ValueError(f"score_plan: M={M} rows (at least 1)")
    if not 1 <= k <= V:
        raise ValueError(f"score_plan: k={k} (1 .. V={V})")
    bm = next((b for b in SCORE_ROW_TILES if M <= b), SCORE_ROW_TILES[-1])
    T = -(-V // SCORE_NTILE)
    group = K // G
    vec = K % 16 == 0 and group % 16 == 0 and (K // 2) % 16 == 0 and V % 4 == 0
    ring = W4_STAGES * (bm * (4 * W4_STAGE_ROWS + 16) + bm * 4 + SCORE_NTILE * 4
                        + W4_STAGE_ROWS * (SCORE_NTILE + 8) * 4)
    if k > MAX_K:
        return ScorePlan(bm, vec, (-(-M // bm), T), ring)
    logits = bm * (SCORE_NTILE + 8) * 4
    heads = SCORE_WARPS * T * (20 if k > SMALL_K else 8)
    return ScorePlan(bm, vec, (-(-M // bm), T), max(ring, logits, heads))


def workspace_words(M: int, V: int, k: int, tiles: int) -> int:
    """4-byte words of a launch's workspace: per (row, tile) its max, sum and
    k candidates up to MAX_K; past it, the logits [M, V] (rounded up to an
    even count) and, when k rounded up to a power of two exceeds SORT_SMEM,
    the sort's [M, n2] 8-byte keys."""
    if k <= MAX_K:
        return M * tiles * (2 + 2 * k)
    n2 = 1 << (k - 1).bit_length()
    return (M * V + 1) // 2 * 2 + (2 * M * n2 if n2 > SORT_SMEM else 0)


# CUDA stream -> the w4 kernel's merge counters (one per row tile), zero
_COUNTERS: dict = {}

# xq, rs, sx, q4, scale, ws, counters, scores, ids | M, K, V, G, k, cast |
# plan (bm, vec, smem, row tiles, column tiles) | stream
_W4_ARGS = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 11 + [ctypes.c_void_p]
# xq, sx, q8, scale, ws, scores, ids | M, K, V, k, cast | stream
_W8_ARGS = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
_CAST = {torch.float32: 0, torch.bfloat16: 1}


def w4_score_kernel(xq: torch.Tensor, sx: torch.Tensor, rs: torch.Tensor,
                    q4: torch.Tensor, scale: torch.Tensor, k: int, cast: int):
    """Launch the w4 kernel on quantized rows (int8 xq [M, K], f32 sx [M, 1],
    int32 rs [M, G]) as `score_plan` plans it: (scores [M, k] f32, ids
    [M, k] int64). Counts the launch."""
    M, K = xq.shape
    V, G = q4.shape[-1], rs.shape[1]
    p = score_plan(M, K, V, G, k)
    if p.smem > W4_SMEM_MAX:
        raise ValueError(f"score_topk_quant: V={V} needs {p.smem} B of shared memory")
    dev = xq.device
    T = p.grid[1]
    ws = torch.empty(workspace_words(M, V, k, T), dtype=torch.int32, device=dev)
    counters = _launch.zeroed_counters(_COUNTERS, torch.cuda.current_stream(dev), p.grid[0])
    scores = torch.empty((M, k), dtype=torch.float32, device=dev)
    ids = torch.empty((M, k), dtype=torch.int64, device=dev)
    fn = _launch.entry_point("score_topk", _W4_ARGS)
    err = fn(xq.data_ptr(), rs.data_ptr(), sx.data_ptr(), q4.data_ptr(), scale.data_ptr(),
             ws.data_ptr(), counters.data_ptr(), scores.data_ptr(), ids.data_ptr(),
             M, K, V, G, k, cast, p.bm, int(p.vec), p.smem, *p.grid, _launch.stream())
    _launch.check_launch("score_topk_quant", err)
    _launch.LAUNCHES["score_topk_quant"] += 1
    return scores, ids


def _w8_score(h2d: torch.Tensor, q8: torch.Tensor, scale: torch.Tensor, k: int):
    M, K = h2d.shape
    V = q8.shape[-1]
    dev = h2d.device
    xq, sx = quantize_rows(h2d)
    xq = xq.contiguous()
    T = -(-V // W8_TILE)
    ws = torch.empty(workspace_words(M, V, k, T), dtype=torch.int32, device=dev)
    scores = torch.empty((M, k), dtype=torch.float32, device=dev)
    ids = torch.empty((M, k), dtype=torch.int64, device=dev)
    fn = _launch.entry_point("score_topk", _W8_ARGS, "score_topk_w8_launch")
    err = fn(xq.data_ptr(), sx.data_ptr(), q8.data_ptr(), scale.data_ptr(), ws.data_ptr(),
             scores.data_ptr(), ids.data_ptr(), M, K, V, k, _CAST[h2d.dtype],
             _launch.stream())
    _launch.check_launch("score_topk_quant", err)
    _launch.LAUNCHES["score_topk_quant"] += 1
    return scores, ids


def score_topk_quant(h2d: torch.Tensor, qw: dict, k: int):
    """[M, K] float rows x quantized lm_head -> (log-softmax top-k scores
    [M, k] f32, ids [M, k] int64), any k <= V. CUDA tensors run
    csrc/score_topk.cu (k <= MAX_K: one launch for int4, two for int8; past
    it, two for either); CPU tensors run `score_topk_ref`. The
    rows are quantized in plain torch (the one rule, ops/quant.quantize_rows);
    the kernel rounds its logits through h2d's dtype as the unfused chain
    does."""
    if h2d.device.type == "cpu":
        return score_topk_ref(h2d, qw, k)
    name = "score_topk_quant"
    _launch.require_cuda(name, h2d)
    kind = _kind(qw)
    q = qw["q4"] if kind == "w4" else qw["q8"]
    scale = qw["scale"]
    M, K = h2d.shape
    V = q.shape[-1]
    if h2d.dtype not in _CAST:
        raise TypeError(f"{name}: rows must be float32 or bfloat16, got {h2d.dtype}")
    if q.device != h2d.device or scale.device != h2d.device:
        raise ValueError(f"{name}: all tensors must be on one device")
    if q.dtype != (torch.int32 if kind == "w4" else torch.int8) \
            or scale.dtype != torch.float32:
        raise TypeError(f"{name}: bad weight types {q.dtype}, {scale.dtype}")
    if not (q.is_contiguous() and scale.is_contiguous()):
        raise ValueError(f"{name}: weights must be contiguous")
    if (_k_of(qw) if kind == "w4" else q.shape[0]) != K or K % 8:
        raise ValueError(f"{name}: rows have K={K}, the head {tuple(q.shape)}")
    if not (M >= 1 and 1 <= k <= V):
        raise ValueError(f"{name}: M={M} (>= 1), k={k} (1 .. V={V})")
    if kind == "w8":
        return _w8_score(h2d, q, scale, k)
    G = scale.shape[0]
    if K % G or (K // G) % 4 or (K // 2) % (K // G):
        raise ValueError(f"{name}: K={K} does not fit {G} scale groups")
    xq, sx, rs = quantize_for_w4(h2d, G)
    return w4_score_kernel(xq, sx, rs, q, scale, k, _CAST[h2d.dtype])
