"""HuggingFace checkpoint → the port's parameter trees.

Port of eagle_tpu/models/hf_loader.py. Loads target models (Llama / Qwen2 /
Qwen3 safetensors or pytorch_model.bin shards) and EAGLE draft-head
checkpoints from local directories into the layouts of
models/transformer.py and models/draft.py, directly on the asked device.

Linear weights are transposed from torch's [out, in] to [in, out]. The
target's layers become a list of per-layer dicts (the JAX package stacks
them on a leading axis). `safetensors` is imported only where a
.safetensors file is read; .bin files go through `torch.load`.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional

import torch

from .. import resolve_device
from ..config import DraftConfig, ModelConfig
from .transformer import check_supported


# ---------------------------------------------------------------------------
# Raw state-dict loading
# ---------------------------------------------------------------------------

def _checkpoint_files(path: str) -> list[str]:
    if os.path.isfile(path):
        return [path]
    for index, single in (("model.safetensors.index.json", "model.safetensors"),
                          ("pytorch_model.bin.index.json", "pytorch_model.bin")):
        index_path = os.path.join(path, index)
        if os.path.exists(index_path):
            with open(index_path) as f:
                shards = sorted(set(json.load(f)["weight_map"].values()))
            return [os.path.join(path, s) for s in shards]
        if os.path.exists(os.path.join(path, single)):
            return [os.path.join(path, single)]
    raise FileNotFoundError(f"no recognized checkpoint in {path}")


def load_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """All tensors of a local HF checkpoint directory (or single file), on
    the CPU, in the types they were stored in.

    Handles model.safetensors, sharded safetensors via the index json, and
    pytorch_model.bin (single or sharded), in that order of preference."""
    out: Dict[str, torch.Tensor] = {}
    for f in _checkpoint_files(path):
        if f.endswith(".safetensors"):
            from safetensors import safe_open

            with safe_open(f, framework="pt", device="cpu") as sf:
                for k in sf.keys():
                    out[k] = sf.get_tensor(k)
        else:
            out.update(torch.load(f, map_location="cpu", weights_only=True))
    return out


# ---------------------------------------------------------------------------
# Conversion
# ---------------------------------------------------------------------------

class _Getter:
    """Reads state-dict entries onto the device in the target dtype."""

    def __init__(self, sd, dtype, device):
        self.sd, self.dtype, self.device = sd, dtype, resolve_device(device)

    def vec(self, name: str) -> torch.Tensor:
        return self.sd[name].to(device=self.device, dtype=self.dtype)

    def lin(self, name: str) -> torch.Tensor:
        """A linear weight, [out, in] → [in, out]."""
        return self.vec(name).t().contiguous()


def convert_target(sd: Dict[str, torch.Tensor], cfg: ModelConfig, dtype=None,
                   device=None) -> dict:
    """An HF causal-LM state dict → the transformer parameter tree."""
    check_supported(cfg)
    g = _Getter(sd, dtype or cfg.dtype, device)
    layers = []
    for i in range(cfg.num_layers):
        p = f"model.layers.{i}."
        lp = {
            "ln1": g.vec(p + "input_layernorm.weight"),
            "ln2": g.vec(p + "post_attention_layernorm.weight"),
            "wq": g.lin(p + "self_attn.q_proj.weight"),
            "wk": g.lin(p + "self_attn.k_proj.weight"),
            "wv": g.lin(p + "self_attn.v_proj.weight"),
            "wo": g.lin(p + "self_attn.o_proj.weight"),
        }
        if cfg.attn_qkv_bias:
            for name, proj in (("bq", "q_proj"), ("bk", "k_proj"), ("bv", "v_proj")):
                lp[name] = g.vec(p + f"self_attn.{proj}.bias")
        if cfg.qk_norm:
            lp["q_norm"] = g.vec(p + "self_attn.q_norm.weight")
            lp["k_norm"] = g.vec(p + "self_attn.k_norm.weight")
        lp["w_gate"] = g.lin(p + "mlp.gate_proj.weight")
        lp["w_up"] = g.lin(p + "mlp.up_proj.weight")
        lp["w_down"] = g.lin(p + "mlp.down_proj.weight")
        layers.append(lp)
    params = {"embed": {"w": g.vec("model.embed_tokens.weight")}, "layers": layers,
              "final_norm": g.vec("model.norm.weight")}
    if not cfg.tie_embeddings:
        params["lm_head"] = g.lin("lm_head.weight")
    return params


def _draft_layer(g: _Getter, p: str, sd) -> dict:
    lp = {"wq": g.lin(p + "self_attn.q_proj.weight"),
          "wk": g.lin(p + "self_attn.k_proj.weight"),
          "wv": g.lin(p + "self_attn.v_proj.weight"),
          "wo": g.lin(p + "self_attn.o_proj.weight")}
    if p + "self_attn.q_proj.bias" in sd:
        for name, proj in (("bq", "q_proj"), ("bk", "k_proj"), ("bv", "v_proj")):
            lp[name] = g.vec(p + f"self_attn.{proj}.bias")
    lp["ln2"] = g.vec(p + "post_attention_layernorm.weight")
    lp["w_gate"] = g.lin(p + "mlp.gate_proj.weight")
    lp["w_up"] = g.lin(p + "mlp.up_proj.weight")
    lp["w_down"] = g.lin(p + "mlp.down_proj.weight")
    return lp


def convert_draft(sd: Dict[str, torch.Tensor], cfg: DraftConfig, dtype=None,
                  target_embed: Optional[torch.Tensor] = None, device=None) -> dict:
    """An EAGLE draft checkpoint (cnets / cnets1 naming) → the draft
    parameter tree. EAGLE checkpoints often leave out embed_tokens (it is
    the base model's): pass `target_embed` then."""
    g = _Getter(sd, dtype or cfg.dtype, device)
    if "embed_tokens.weight" in sd:
        embed = g.vec("embed_tokens.weight")
    elif target_embed is not None:
        embed = target_embed.to(device=g.device, dtype=g.dtype)
    else:
        raise ValueError("the draft checkpoint lacks embed_tokens: pass target_embed")
    params: dict = {"embed": {"w": embed}}

    if cfg.version == 3:
        p = "midlayer."
        lp = _draft_layer(g, p, sd)
        lp["hidden_norm"] = g.vec(p + "hidden_norm.weight")
        lp["ln1"] = g.vec(p + "input_layernorm.weight")
        params["layers"] = [lp]
        params["fc"] = {"w": g.lin("fc.weight")}
        params["norm"] = g.vec("norm.weight")
        params["lm_head"] = g.lin("lm_head.weight")
        if "d2t" in sd:
            params["d2t"] = sd["d2t"].to(device=g.device, dtype=torch.long)
        if "t2d" in sd:
            params["t2d"] = sd["t2d"].to(device=g.device, dtype=torch.bool)
        return params

    # version 1: cnets1 naming
    layers = []
    i = 0
    while f"layers.{i}.self_attn.q_proj.weight" in sd:
        p = f"layers.{i}."
        lp = _draft_layer(g, p, sd)
        if i != 0:
            lp["ln1"] = g.vec(p + "input_layernorm.weight")
        layers.append(lp)
        i += 1
    params["layers"] = layers
    params["fc"] = {"w": g.lin("fc.weight")}
    if "fc.bias" in sd:
        params["fc"]["b"] = g.vec("fc.bias")
    return params


def load_target(path: str, dtype=torch.bfloat16, device=None) -> tuple[dict, ModelConfig]:
    cfg = ModelConfig.from_hf_json(path, dtype=dtype)
    return convert_target(load_state_dict(path), cfg, dtype=dtype, device=device), cfg


def load_draft(path: str, version: Optional[int] = None, dtype=torch.bfloat16,
               target_embed=None, device=None) -> tuple[dict, DraftConfig]:
    cfg = DraftConfig.from_hf_json(path, version=version, dtype=dtype)
    return convert_draft(load_state_dict(path), cfg, dtype=dtype,
                         target_embed=target_embed, device=device), cfg
