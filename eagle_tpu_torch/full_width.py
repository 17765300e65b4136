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
"""

from __future__ import annotations

import dataclasses
import itertools
import os

from typing import Optional

from .config import CONFIG_DIR, DraftConfig, EngineConfig, ModelConfig
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
    cfg, dcfg = configs()
    ecfg = EngineConfig(total_tokens=60, depth=5, top_k=10, max_len=2048,
                        compact_impl="pallas")
    params = transformer.init_params(cfg, seed=SEED, device=device)
    params["lm_head"].mul_(LM_HEAD_SHARPEN)
    dparams = draft_mod.init_params(dcfg, seed=SEED + 1, device=device)
    dparams["embed"]["w"] = params["embed"]["w"]
    return EagleEngine(params, cfg, dparams, dcfg, ecfg, device=device)


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
