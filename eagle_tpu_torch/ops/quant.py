"""Weight-only int8 quantization (w8a8): the activation rule every quantized
path shares, the int8 dense product, and the tree-level converters.

Port of eagle_tpu/ops/quant.py (the straight-through `fake_quantize_*`
functions belong to training and are not ported yet). Weights keep the
[in, out] layout; a quantized leaf is {"q8": int8 [.., K, N], "scale": f32
[.., N]} with symmetric per-output-channel scales.

Quantizing the draft never changes what the engine emits (acceptance only
commits tokens the target verifies); quantizing the target is a serving
operating point whose invariant is bit-exactness against its own vanilla
decode.
"""

from __future__ import annotations

from typing import Optional

import torch

_QUANT_KEYS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")
# drafts may carry fused projections (models/draft.fuse_projections);
# per-output-column scales make quantize(concat) == concat(quantize)
_DRAFT_QUANT_KEYS = _QUANT_KEYS + ("wqkv", "wgu")
_EXPERT_QUANT_KEYS = ("we_gate", "we_up", "we_down")

# an fp32 dot of int8 values is exact while |sum| < 2**24: 127 * 127 * 1024
_EXACT_K_CHUNK = 1024

_CONSTS: dict = {}


def true_div(x: torch.Tensor, value: float) -> torch.Tensor:
    """x / value, correctly rounded on every device. PyTorch's CUDA kernel
    for a division by a Python scalar multiplies by the rounded reciprocal,
    which differs from the division in the last bit for some inputs; the
    scales must be the same f32 numbers on the CPU, on the card and in the JAX
    package, so the divisor is a (cached) f32 tensor on x's device."""
    key = (value, x.device)
    if key not in _CONSTS:
        _CONSTS[key] = torch.tensor(value, dtype=torch.float32, device=x.device)
    return x / _CONSTS[key]


def quantize_rows(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row dynamic symmetric int8 activation quantization over the last
    axis, the single definition of the rule (qdense, qdense4 and the fused
    scorer all route here): x [.., K] -> (int8 [.., K], f32 scales [.., 1])."""
    xf = x.to(torch.float32)
    xmax = torch.clamp(torch.amax(torch.abs(xf), dim=-1, keepdim=True), min=1e-12)
    sx = true_div(xmax, 127.0)
    xq = torch.clamp(torch.round(xf / sx), -127, 127).to(torch.int8)
    return xq, sx


def quantize_linear(w: torch.Tensor) -> dict:
    """[K, N] or stacked [L, K, N] weight -> {"q8": int8, "scale": f32 [.., N]}
    (symmetric per-output-channel; one function for what the JAX package
    splits into quantize_linear and _quantize_linear_host)."""
    wf = w.to(torch.float32)
    amax = torch.amax(torch.abs(wf), dim=-2)
    scale = torch.clamp(true_div(amax, 127.0), min=1e-12)
    q = torch.clamp(torch.round(wf / scale.unsqueeze(-2)), -127, 127).to(torch.int8)
    return {"q8": q, "scale": scale}


def int8_matmul(xq: torch.Tensor, q8: torch.Tensor) -> torch.Tensor:
    """Exact int8 [M, K] x int8 [K, N] -> int32 [M, N] on any device.

    K is cut into chunks of 1024: within a chunk every partial sum is an
    integer below 2**24, so an fp32 matmul computes it exactly in any order
    (int8 values also fit TF32's 10-bit mantissa, so the result does not
    depend on the TF32 switch either); the chunk sums are added as int32.
    At K = 4096 a single fp32 dot could reach 127 * 127 * 4096 > 2**24 and
    would round."""
    K = xq.shape[-1]
    acc = None
    for k0 in range(0, K, _EXACT_K_CHUNK):
        part = torch.matmul(xq[:, k0:k0 + _EXACT_K_CHUNK].to(torch.float32),
                            q8[k0:k0 + _EXACT_K_CHUNK].to(torch.float32)).to(torch.int32)
        acc = part if acc is None else acc + part
    return acc


def qdense(x: torch.Tensor, qw: dict, b: Optional[torch.Tensor] = None,
           out_dtype=None) -> torch.Tensor:
    """x [.., K] @ int8 weights -> [.., N] in x.dtype (or out_dtype): per-row
    int8 activations, exact int32 dots, rescaled as (acc * sx) * scale."""
    shape = x.shape
    xq, sx = quantize_rows(x.reshape(-1, shape[-1]))
    acc = int8_matmul(xq, qw["q8"])
    y = acc.to(torch.float32) * sx * qw["scale"][None, :]
    y = y.to(out_dtype or x.dtype).reshape(*shape[:-1], qw["q8"].shape[1])
    if b is not None:
        y = y + b.to(y.dtype)
    return y


def quantize_draft_params(dparams: dict) -> dict:
    """Quantize every large matrix of a draft-head tree (the layers'
    projections, fc, lm_head); embeddings, norms and vocab maps stay."""
    out = dict(dparams)
    layers = []
    for lp in dparams["layers"]:
        nlp = dict(lp)
        for k in _DRAFT_QUANT_KEYS:
            if k in nlp:
                nlp[k] = quantize_linear(nlp[k])
        layers.append(nlp)
    out["layers"] = layers
    if "fc" in out:
        fc = dict(out["fc"])
        fc["w"] = quantize_linear(fc["w"])
        out["fc"] = fc
    if "lm_head" in out:
        out["lm_head"] = quantize_linear(out["lm_head"])
    return out


def quantize_target_params(params: dict) -> dict:
    """Weight-only int8 for a target tree (the port's: "layers" is a list of
    per-layer dicts). Dense projections and lm_head are quantized;
    embeddings, norms and biases stay. Outputs match the int8 target's own
    vanilla decode bit for bit, not the bf16 target's."""
    out = dict(params)
    layers = []
    for lp in params["layers"]:
        if any(k in lp for k in _EXPERT_QUANT_KEYS):
            raise NotImplementedError("MoE targets are not ported yet")
        nlp = dict(lp)
        for k in _QUANT_KEYS:
            if k in nlp and not isinstance(nlp[k], dict):
                nlp[k] = quantize_linear(nlp[k])
        layers.append(nlp)
    out["layers"] = layers
    if "lm_head" in out and not isinstance(out["lm_head"], dict):
        out["lm_head"] = quantize_linear(out["lm_head"])
    return out
