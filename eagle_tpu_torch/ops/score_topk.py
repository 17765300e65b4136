"""Fused draft scoring: quantized lm_head matmul + log-softmax + exact top-k
in one kernel call, with its plain PyTorch version.

Port of eagle_tpu/ops/score_topk.py. `score_topk_quant` (kernel B5,
csrc/score_topk.cu) replaces the Pallas kernel _score_topk_kernel;
`score_topk_ref` is the plain version: the unfused chain through
`qdense` / `qdense4_ref`, the cast through the hidden dtype, `log_softmax`
and the stable-sort `topk_rows`.

Contract: candidate ids are bit-identical to the unfused chain (the same
logit values, the same order: value descending, then index ascending);
scores are log-softmax values that differ from the unfused ones only by the
order of the logsumexp sum (SCORE_TOL). Weight formats: int8 {"q8", "scale"}
and packed int4 {"q4", "scale"} in the single-block layout.
"""

from __future__ import annotations

import ctypes

import torch

from . import _launch
from .quant import qdense, quantize_rows
from .quant4 import _blocks_of, _k_of, _rowsums8, qdense4_ref

# fused vs unfused scores: the logsumexp is summed per 64-column tile and then
# over the tiles, instead of along the row; a few f32 ulp of a value of
# magnitude ~10
SCORE_TOL = dict(rtol=1e-5, atol=1e-5)
MAX_ROWS, MAX_K = 32, 16
_TILE = 64   # columns per block of csrc/score_topk.cu


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


# xq, rs, sx, q, scale, stat, cval, cidx, scores, ids | M, K, V, G, k, kind, cast | stream
_ARGS = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
_CAST = {torch.float32: 0, torch.bfloat16: 1}


def score_topk_quant(h2d: torch.Tensor, qw: dict, k: int):
    """[M, K] float rows x quantized lm_head -> (log-softmax top-k scores
    [M, k] f32, ids [M, k] int64). CUDA tensors run csrc/score_topk.cu; CPU
    tensors run `score_topk_ref`. The rows are quantized in plain torch (the
    one rule, ops/quant.quantize_rows); the kernel rounds its logits through
    h2d's dtype as the unfused chain does."""
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
    if not (1 <= M <= MAX_ROWS and 1 <= k <= min(MAX_K, V)):
        raise ValueError(f"{name}: M={M} (<= {MAX_ROWS}), k={k} (<= {MAX_K}, <= V={V})")
    dev = h2d.device
    xq, sx = quantize_rows(h2d)
    xq = xq.contiguous()
    if kind == "w4":
        G = scale.shape[0]
        if K % G or (K // G) % 4 or (K // 2) % (K // G):
            raise ValueError(f"{name}: K={K} does not fit {G} scale groups")
        rs = _rowsums8(xq, G).contiguous()
        rs_ptr = rs.data_ptr()
    else:
        G, rs_ptr = 1, None
    T = -(-V // _TILE)
    stat = torch.empty((M, T, 2), dtype=torch.float32, device=dev)
    cval = torch.empty((M, T, k), dtype=torch.float32, device=dev)
    cidx = torch.empty((M, T, k), dtype=torch.int32, device=dev)
    scores = torch.empty((M, k), dtype=torch.float32, device=dev)
    ids = torch.empty((M, k), dtype=torch.int32, device=dev)
    sx = sx.reshape(M).contiguous()
    fn = _launch.entry_point("score_topk", _ARGS)
    err = fn(xq.data_ptr(), rs_ptr, sx.data_ptr(), q.data_ptr(), scale.data_ptr(),
             stat.data_ptr(), cval.data_ptr(), cidx.data_ptr(), scores.data_ptr(),
             ids.data_ptr(), M, K, V, G, k, 0 if kind == "w4" else 1,
             _CAST[h2d.dtype], _launch.stream())
    _launch.check_launch(name, err)
    _launch.LAUNCHES[name] += 1
    return scores, ids.to(torch.long)
