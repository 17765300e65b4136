"""Convert the JAX package's configs and parameter pytrees for the port.

The JAX target stacks every per-layer leaf on a leading [L] axis (for
`lax.scan`); the port keeps a list of per-layer dicts. Draft params are
already a list of layers; fused `wqkv`/`wgu` leaves pass through as they
are. Leaves may be numpy arrays or anything `np.asarray` accepts, so the
port needs no JAX import: a caller hands over `np.asarray` views.
Weights keep the [in, out] layout on both sides.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import resolve_device
from .config import DraftConfig, EngineConfig, ModelConfig, RopeConfig
from .models.transformer import check_dense


def to_tensor(x, dtype=None, device=None) -> torch.Tensor:
    """One array leaf → tensor on `device` ("cuda" unless the caller passes
    "cpu"). Float leaves are cast to `dtype` when given; integer leaves become
    int64 (torch indexes with int64); bfloat16 numpy arrays (ml_dtypes) are
    reinterpreted bit for bit."""
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a, copy=True))
    if t.dtype.is_floating_point:
        if dtype is not None:
            t = t.to(dtype)
    elif t.dtype != torch.bool:
        t = t.to(torch.long)
    return t.to(resolve_device(device))


def _tree(x, dtype, device):
    if isinstance(x, dict):
        return {k: _tree(v, dtype, device) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_tree(v, dtype, device) for v in x]
    return to_tensor(x, dtype, device)


def target_params(jparams: dict, dtype=None, device=None) -> dict:
    """JAX transformer params (stacked `layers`) → port params (list)."""
    check_dense(jparams)
    stacked = jparams["layers"]
    n_layers = int(np.asarray(next(iter(stacked.values()))).shape[0])
    layers = [{name: to_tensor(np.asarray(leaf)[i], dtype, device)
               for name, leaf in stacked.items()} for i in range(n_layers)]
    out = {"embed": {"w": to_tensor(jparams["embed"]["w"], dtype, device)},
           "layers": layers,
           "final_norm": to_tensor(jparams["final_norm"], dtype, device)}
    if "lm_head" in jparams:
        out["lm_head"] = to_tensor(jparams["lm_head"], dtype, device)
    return out


def draft_params(jdparams: dict, dtype=None, device=None) -> dict:
    """JAX draft params (fused or unfused) → port draft params. d2t becomes
    int64, t2d stays bool."""
    check_dense(jdparams)
    return _tree(jdparams, dtype, device)


def _fields(cfg, cls) -> dict:
    """Field values of a config object with the same field names as `cls`
    (the JAX package's twin dataclass), minus dtype and rope."""
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cls)
            if f.name not in ("dtype", "rope")}


def rope_config(rope):
    return RopeConfig(**_fields(rope, RopeConfig))


def model_config(cfg, dtype=torch.float32):
    """The JAX package's ModelConfig (any object with its fields) → the
    port's ModelConfig with a torch dtype."""
    return ModelConfig(**_fields(cfg, ModelConfig), rope=rope_config(cfg.rope),
                       dtype=dtype)


def draft_config(dcfg, dtype=torch.float32):
    return DraftConfig(**_fields(dcfg, DraftConfig), rope=rope_config(dcfg.rope),
                       dtype=dtype)


def engine_config(ecfg):
    return EngineConfig(**_fields(ecfg, EngineConfig))
