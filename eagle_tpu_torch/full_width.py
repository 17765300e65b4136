"""The slice's full-width configuration: a Llama-3.1-8B-Instruct-shaped bf16
target with the EAGLE-3 LLaMA3.1-8B draft head, random weights made on the
device from seeds (no checkpoints are in the repository).

Widths come from configs/llama3_8B_target.json (the public
Llama-3.1-8B-Instruct config.json values) and configs/llama3_8B_eagle3_config.json.
The target's lm_head is multiplied by 8 so the random head has argmax
margins, and the draft shares the target's embedding, as EAGLE-3 does.
"""

from __future__ import annotations

import dataclasses
import os

from .config import CONFIG_DIR, DraftConfig, EngineConfig, ModelConfig
from .engine.engine import EagleEngine
from .models import draft as draft_mod
from .models import transformer

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
