"""The port's full-width configuration: a Llama-3.1-8B-Instruct-shaped target
with the EAGLE-3 LLaMA3.1-8B draft head, random weights made on the device
from seeds (no checkpoints are in the repository). `engine` is the bf16
path; `engine_int4` the int4 serving path (w4a8 target, int4 draft, fused
draft scoring) over the same random weights; `engine_static` (the published
26-node static tree with length-bucketed decode reads) and `engine_kv8`
(int8 target KV cache) are siblings of a bf16 engine and share its
parameter tensors.

Widths come from configs/llama3_8B_target.json (the public
Llama-3.1-8B-Instruct config.json values) and configs/llama3_8B_eagle3_config.json.
The target's lm_head is multiplied by 8 so the random head has argmax
margins, and the draft shares the target's embedding, as EAGLE-3 does.

`engine_hd64` is the other configuration: the Llama-3.2-1B-class shape of
the repository's entry point (`__graft_entry__._flagship_cfg`: hidden 2048,
FFN 8192, 16 layers, 32 q / 8 kv heads of head_dim 64, vocab 32000, rope
theta 500000), with an EAGLE-3 head at the target's widths, so that the
tree-verify attention kernel runs at head_dim 64.
"""

from __future__ import annotations

import dataclasses
import itertools
import os
from typing import Optional

import torch

from .config import CONFIG_DIR, DraftConfig, EngineConfig, ModelConfig, RopeConfig
from .engine.engine import EagleEngine
from .models import draft as draft_mod
from .models import transformer
from .ops.quant import _QUANT_KEYS
from .ops.quant4 import GROUP, pack_w4, stack_layer
from .ops.tree import MC_SIM_7B_63

LM_HEAD_SHARPEN = 8.0
SEED = 0


def configs() -> tuple[ModelConfig, DraftConfig]:
    cfg = ModelConfig.from_hf_json(os.path.join(CONFIG_DIR, "llama3_8B_target.json"))
    dcfg = DraftConfig.from_hf_json(
        os.path.join(CONFIG_DIR, "llama3_8B_eagle3_config.json"), version=3)
    return dataclasses.replace(cfg, attn_impl="pallas_tree"), dcfg


def engine(device=None) -> EagleEngine:
    """EagleEngine at full width with both kernels on, at the README's
    operating point: total_tokens=60, depth=5, top_k=10, max_len=2048."""
    return _engine_of(*configs(), device)


def configs_hd64() -> tuple[ModelConfig, DraftConfig]:
    """The entry point's flagship numbers (copied: that module imports JAX)
    and an EAGLE-3 head of one layer at the same widths; the draft's
    vocabulary is the target's 32000, so it needs no d2t map."""
    rope = RopeConfig(theta=500000.0)
    cfg = ModelConfig(vocab_size=32000, hidden_size=2048, intermediate_size=8192,
                      num_layers=16, num_q_heads=32, num_kv_heads=8, head_dim=64,
                      rope=rope, dtype=torch.bfloat16, attn_impl="pallas_tree")
    dcfg = DraftConfig(version=3, hidden_size=2048, intermediate_size=8192,
                       num_q_heads=32, num_kv_heads=8, head_dim=64, vocab_size=32000,
                       num_layers=1, rope=rope, dtype=torch.bfloat16)
    return cfg, dcfg


def _engine_of(cfg: ModelConfig, dcfg: DraftConfig, device) -> EagleEngine:
    ecfg = EngineConfig(total_tokens=60, depth=5, top_k=10, max_len=2048,
                        compact_impl="pallas")
    params = transformer.init_params(cfg, seed=SEED, device=device)
    params["lm_head"].mul_(LM_HEAD_SHARPEN)
    dparams = draft_mod.init_params(dcfg, seed=SEED + 1, device=device)
    dparams["embed"]["w"] = params["embed"]["w"]
    return EagleEngine(params, cfg, dparams, dcfg, ecfg, device=device)


def engine_hd64(device=None) -> EagleEngine:
    """The bf16 path at the Llama-3.2-1B-class flagship shape (head_dim 64),
    both attention-side kernels on, at `engine()`'s operating point: B1 runs
    at head_dim 64 (16 launches a round) and B2 moves 128-byte rows. About
    2.3 GB of bf16 weights."""
    return _engine_of(*configs_hd64(), device)


def engine_static(device=None, base: Optional[EagleEngine] = None) -> EagleEngine:
    """The static-tree path at full width: the EAGLE-1 `mc_sim_7b_63` tree (26
    nodes) drafted by the same EAGLE-3 head, `kv_buckets=(512, 1024)`, both
    attention-side kernels on. Shares the parameter tensors of `base` (a bf16
    `engine()`, made here when not given): no second copy of the weights."""
    base = base if base is not None else engine(device)
    return base._sibling(tree_paths=MC_SIM_7B_63, kv_buckets=(512, 1024))


def engine_kv8(device=None, base: Optional[EagleEngine] = None) -> EagleEngine:
    """`engine()`'s dynamic tree with an int8 target KV cache. With int8 rows
    the verify attention and the compaction take their plain versions, as in
    the JAX package, so this path launches neither kernel. Shares `base`'s
    parameter tensors."""
    base = base if base is not None else engine(device)
    return base._sibling(kv_quant="int8")


def int4_target_params(cfg: ModelConfig, device=None) -> dict:
    """The int4 tree of `transformer.init_params(cfg, SEED)` (with its lm_head
    times LM_HEAD_SHARPEN), the same words and scales as
    `quantize_target_params4` of that tree gives, without ever holding the
    float tree: each layer is packed on the device as soon as it is made, into
    stacked [L, K/8, N] / [L, G, N] tensors allocated once."""
    stacked: dict = {}
    layer_ids = itertools.count()

    def pack_layer(lp: dict) -> dict:
        layer = next(layer_ids)
        for name in _QUANT_KEYS:
            stack_layer(stacked, name, pack_w4(lp.pop(name), GROUP), layer,
                        cfg.num_layers)
        return lp

    params = transformer.init_params(cfg, seed=SEED, device=device,
                                     layer_fn=pack_layer)
    params["stacked4"] = stacked
    params["lm_head"] = pack_w4(params["lm_head"].mul_(LM_HEAD_SHARPEN), GROUP)
    return params


def engine_int4(device=None) -> EagleEngine:
    """The int4 serving path at full width: w4a8 target (seven stacked
    launches per layer, the unfused layout), int4 draft, fused draft scoring,
    tree-verify attention and in-place compaction kernels on."""
    cfg, dcfg = configs()
    ecfg = EngineConfig(total_tokens=60, depth=5, top_k=10, max_len=2048,
                        compact_impl="pallas", draft_quant="int4",
                        fuse_scoring=True)
    params = int4_target_params(cfg, device=device)
    dparams = draft_mod.init_params(dcfg, seed=SEED + 1, device=device)
    dparams["embed"]["w"] = params["embed"]["w"]
    return EagleEngine(params, cfg, dparams, dcfg, ecfg, device=device)
