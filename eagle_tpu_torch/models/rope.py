"""Rotary position embeddings (default, linear, dynamic NTK, llama3 warping).

Tables are computed in float32 and applied with the rotate-half layout, as in
the JAX package and HF.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import RopeConfig


def rope_inv_freq(cfg: RopeConfig, head_dim: int, seq_len: int | None = None) -> np.ndarray:
    """Inverse frequencies [head_dim//2], float32 (host-side, static)."""
    base = cfg.theta
    if cfg.scaling_type == "dynamic" and seq_len is not None and seq_len > cfg.original_max_position:
        base = cfg.theta * (
            (cfg.scaling_factor * seq_len / cfg.original_max_position) - (cfg.scaling_factor - 1)
        ) ** (head_dim / (head_dim - 2))
    inv_freq = 1.0 / (base ** (np.arange(0, head_dim, 2, dtype=np.float32) / head_dim))
    if cfg.scaling_type == "llama3":
        low_wl = cfg.original_max_position / cfg.low_freq_factor
        high_wl = cfg.original_max_position / cfg.high_freq_factor
        wavelen = 2.0 * np.pi / inv_freq
        scaled = inv_freq / cfg.scaling_factor
        smooth = (cfg.original_max_position / wavelen - cfg.low_freq_factor) / (
            cfg.high_freq_factor - cfg.low_freq_factor
        )
        mid = (1.0 - smooth) * scaled + smooth * inv_freq
        inv_freq = np.where(wavelen > low_wl, scaled, np.where(wavelen < high_wl, inv_freq, mid))
    return inv_freq.astype(np.float32)


# (cfg, head_dim, device) -> inverse frequencies on that device: copied from
# the host once, since a copy from pageable host memory waits for the device
_INV_FREQ: dict = {}


def rope_tables(cfg: RopeConfig, head_dim: int,
                positions: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables for integer positions [...] → ([..., head_dim],)*2 fp32."""
    key = (cfg, head_dim, str(positions.device))
    inv_freq = _INV_FREQ.get(key)
    if inv_freq is None:
        inv_freq = _INV_FREQ[key] = torch.from_numpy(
            rope_inv_freq(cfg, head_dim)).to(positions.device)
    pos = positions.to(torch.float32)
    if cfg.scaling_type == "linear":
        pos = pos / cfg.scaling_factor
    freqs = pos[..., None] * inv_freq
    emb = torch.cat([freqs, freqs], dim=-1)
    return torch.cos(emb), torch.sin(emb)


def _rotate_half(x: torch.Tensor) -> torch.Tensor:
    h = x.shape[-1] // 2
    return torch.cat([-x[..., h:], x[..., :h]], dim=-1)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x: [..., T, n_heads, head_dim]; cos/sin: [..., T, head_dim]. Computed in
    fp32, cast back to x.dtype."""
    xf = x.to(torch.float32)
    c = cos[..., :, None, :]
    s = sin[..., :, None, :]
    return (xf * c + _rotate_half(xf) * s).to(x.dtype)
