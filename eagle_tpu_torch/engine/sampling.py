"""Logits processing and sampling on the device, in fp32.

Port of eagle_tpu/engine/sampling.py. The filters run in HF's order
(temperature, then top-k, then top-p). `categorical` draws by the
Gumbel-max trick from uniforms it is given: `torch.Generator` streams cannot
equal `jax.random`'s, so every function that draws takes its noise as an
argument, and `uniform` draws that noise on the engine's device from one
generator per request (no host sync).
"""

from __future__ import annotations

import torch

NEG_INF = -1e30
# the smallest uniform a Gumbel draw takes, as jax.random.uniform(..., 1e-20, 1)
U_MIN = 1e-20


def process_logits(logits: torch.Tensor, temperature=1.0, top_k: int = 0,
                   top_p: float = 0.0) -> torch.Tensor:
    """Temperature, top-k and top-p filters on fp32 logits [..., V].

    `top_k = 0` and `top_p` in {0, 1} turn the filters off. `temperature`
    must be > 0: a Python float or a device scalar (a request's temperature
    stays on the device). top-p removes the tokens whose exclusive
    cumulative probability exceeds `top_p`, and always keeps one."""
    if torch.is_tensor(temperature):
        temperature = temperature.to(torch.float32)
    logits = logits.to(torch.float32) / temperature
    if top_k and top_k > 0:
        kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = torch.where(logits < kth, NEG_INF, logits)
    if top_p and 0.0 < top_p < 1.0:
        sorted_desc = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(sorted_desc, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        keep = (cum - probs) <= top_p
        # the smallest logit kept
        thresh = torch.where(keep, sorted_desc, torch.inf).amin(dim=-1, keepdim=True)
        logits = torch.where(logits < thresh, NEG_INF, logits)
    return logits


def categorical(probs: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """An index drawn from the (unnormalised) probabilities [..., V] by
    Gumbel-max: argmax(log p + G), G = -log(-log u), u in [U_MIN, 1) of the
    same shape. Zero-probability entries are never drawn."""
    g = -torch.log(-torch.log(u))
    score = torch.where(probs > 0, torch.log(probs.clamp_min(1e-38)) + g, -torch.inf)
    return torch.argmax(score, dim=-1)


def uniform(gen: torch.Generator, shape, device, low: float = 0.0) -> torch.Tensor:
    """fp32 uniforms in [low, 1) on `device`, drawn from `gen` (a generator on
    that device): `low = 0` for acceptance tests, `U_MIN` for Gumbel draws."""
    u = torch.rand(shape, generator=gen, device=device, dtype=torch.float32)
    return u.clamp_min(low) if low else u
