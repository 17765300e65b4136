"""Convert the JAX package's configs and parameter pytrees for the port.

The JAX target stacks every per-layer leaf on a leading [L] axis (for
`lax.scan`); the port keeps a list of per-layer dicts. Draft params are
already a list of layers; fused `wqkv`/`wgu` leaves pass through as they
are. Leaves may be numpy arrays or anything `np.asarray` accepts, so the
port needs no JAX import: a caller hands over `np.asarray` views.
Weights keep the [in, out] layout on both sides.

Quantized leaves cross bit for bit: packed int4 words ({"q4"}) stay int32,
int8 weights ({"q8"}) stay int8, and their "scale" stays float32 whatever
`dtype` the float leaves are cast to. Stacked int4 target leaves
([L, K/8, N]) stay whole under `params["stacked4"]`; blocked ([L, blocks,
..]) and int8 leaves go to the per-layer dicts like any other leaf.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import resolve_device
from .config import DraftConfig, EngineConfig, ModelConfig, RopeConfig


def to_tensor(x, dtype=None, device=None, keep_int: bool = False) -> torch.Tensor:
    """One array leaf → tensor on `device` ("cuda" unless the caller passes
    "cpu"). Float leaves are cast to `dtype` when given; index leaves (int32 /
    int64: tokens, d2t) become int64, since torch indexes with int64; int8
    leaves, and any integer leaf with `keep_int` (packed int4 words), keep
    their type and bits; bfloat16 numpy arrays (ml_dtypes) are reinterpreted
    bit for bit."""
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a, copy=True))
    if t.dtype.is_floating_point:
        if dtype is not None:
            t = t.to(dtype)
    elif t.dtype not in (torch.bool, torch.int8) and not keep_int:
        t = t.to(torch.long)
    return t.to(resolve_device(device))


def _is_quant(x) -> bool:
    return isinstance(x, dict) and ("q4" in x or "q8" in x)


def quant_leaf(qw: dict, device=None, index=None) -> dict:
    """A {"q4" | "q8", "scale"} leaf, bit for bit (scale stays float32);
    `index` picks one layer of a stacked leaf."""
    pick = (lambda a: np.asarray(a)) if index is None else (lambda a: np.asarray(a)[index])
    return {k: to_tensor(pick(v), torch.float32 if k == "scale" else None, device,
                         keep_int=True) for k, v in qw.items()}


def _tree(x, dtype, device):
    if _is_quant(x):
        return quant_leaf(x, device)
    if isinstance(x, dict):
        return {k: _tree(v, dtype, device) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_tree(v, dtype, device) for v in x]
    return to_tensor(x, dtype, device)


def target_params(jparams: dict, dtype=None, device=None) -> dict:
    """JAX transformer params (stacked `layers`, dense or from
    quantize_target_params / quantize_target_params4) → port params."""
    stacked = jparams["layers"]
    n_layers = int(np.asarray(stacked["ln1"]).shape[0])
    stacked4 = {name: quant_leaf(leaf, device) for name, leaf in stacked.items()
                if _is_quant(leaf) and "q4" in leaf and np.ndim(leaf["q4"]) == 3}
    layers = []
    for i in range(n_layers):
        lp = {}
        for name, leaf in stacked.items():
            if name in stacked4:
                continue
            lp[name] = (quant_leaf(leaf, device, index=i) if _is_quant(leaf)
                        else to_tensor(np.asarray(leaf)[i], dtype, device))
        layers.append(lp)
    out = {"embed": {"w": to_tensor(jparams["embed"]["w"], dtype, device)},
           "layers": layers,
           "final_norm": to_tensor(jparams["final_norm"], dtype, device)}
    if stacked4:
        out["stacked4"] = stacked4
    if "lm_head" in jparams:
        out["lm_head"] = _tree(jparams["lm_head"], dtype, device)
    return out


def draft_params(jdparams: dict, dtype=None, device=None) -> dict:
    """JAX draft params (fused or unfused, dense or already quantized by a
    JAX engine) → port draft params. d2t becomes int64, t2d stays bool."""
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
    """The JAX package's EngineConfig → the port's, every field carried
    across (kv_quant, draft_quant, compact_impl, ...). `tree_paths` and
    `kv_buckets` may arrive as lists: they become the tuples the frozen
    dataclass promises."""
    fields = _fields(ecfg, EngineConfig)
    if fields["tree_paths"] is not None:
        fields["tree_paths"] = tuple(tuple(int(r) for r in p) for p in fields["tree_paths"])
    if fields["kv_buckets"] is not None:
        fields["kv_buckets"] = tuple(int(b) for b in fields["kv_buckets"])
    return EngineConfig(**fields)
