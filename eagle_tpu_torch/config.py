"""Typed configuration for the PyTorch port.

A twin of the JAX package's `config.py`: the same frozen dataclasses, field
names, defaults and HF-JSON parsing, with torch dtypes in place of
`jax.numpy` ones, so one configuration means the same thing on both sides.
`attn_impl="pallas_tree"` and `compact_impl="pallas"` keep their names: here
they select the hand-written CUDA kernels of `ops/attn_kernels.py`.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Optional, Tuple

import torch

CONFIG_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "configs")


@dataclasses.dataclass(frozen=True)
class RopeConfig:
    """Rotary embedding settings (default, linear, dynamic NTK, llama3)."""

    theta: float = 10000.0
    # one of: "default", "linear", "dynamic", "llama3"
    scaling_type: str = "default"
    scaling_factor: float = 1.0
    # llama3-only knobs
    low_freq_factor: float = 1.0
    high_freq_factor: float = 4.0
    original_max_position: int = 8192

    @staticmethod
    def from_hf(rope_theta: float, rope_scaling: Optional[dict]) -> "RopeConfig":
        if not rope_scaling:
            return RopeConfig(theta=rope_theta)
        stype = rope_scaling.get("rope_type", rope_scaling.get("type", "default"))
        if stype in ("default", None):
            return RopeConfig(theta=rope_theta)
        if stype == "llama3":
            return RopeConfig(
                theta=rope_theta,
                scaling_type="llama3",
                scaling_factor=float(rope_scaling.get("factor", 8.0)),
                low_freq_factor=float(rope_scaling.get("low_freq_factor", 1.0)),
                high_freq_factor=float(rope_scaling.get("high_freq_factor", 4.0)),
                original_max_position=int(
                    rope_scaling.get("original_max_position_embeddings", 8192)
                ),
            )
        if stype in ("linear", "dynamic"):
            return RopeConfig(
                theta=rope_theta,
                scaling_type=stype,
                scaling_factor=float(rope_scaling.get("factor", 1.0)),
            )
        raise ValueError(f"unsupported rope scaling type: {stype}")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Target-model architecture (Llama / Qwen2 / Qwen3 flags)."""

    vocab_size: int
    hidden_size: int
    intermediate_size: int
    num_layers: int
    num_q_heads: int
    num_kv_heads: int
    head_dim: int
    rms_eps: float = 1e-5
    rope: RopeConfig = dataclasses.field(default_factory=RopeConfig)
    max_position_embeddings: int = 4096

    attn_qkv_bias: bool = False
    qk_norm: bool = False
    tie_embeddings: bool = False
    # MoE is parsed for parity with the JAX config; the port raises on it
    num_experts: int = 0
    experts_per_token: int = 0
    moe_impl: str = "dense"
    moe_capacity_factor: float = 2.0
    sliding_window: Optional[int] = None
    sliding_layer_flags: Optional[Tuple[bool, ...]] = None

    dtype: Any = torch.bfloat16
    # tree-verify attention: "xla" = dense-mask plain PyTorch attention;
    # "pallas_tree" = the CUDA tree-attention kernel (ops/attn_kernels.py)
    attn_impl: str = "xla"

    @property
    def q_dim(self) -> int:
        return self.num_q_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    @property
    def tap_layers(self) -> Tuple[int, int, int]:
        """EAGLE-3 feature taps: hidden-state inputs of layers {2, L//2, L-3}."""
        return (2, self.num_layers // 2, self.num_layers - 3)

    @staticmethod
    def from_hf_dict(d: dict, dtype=torch.bfloat16) -> "ModelConfig":
        arch = (d.get("architectures") or [""])[0] + "/" + d.get("model_type", "llama")
        num_q = d["num_attention_heads"]
        head_dim = d.get("head_dim") or d["hidden_size"] // num_q
        arch_l = arch.lower()
        is_qwen2 = "qwen2" in arch_l
        is_qwen3 = "qwen3" in arch_l
        is_mixtral = "mixtral" in arch_l
        sw = None
        sw_flags = None
        L = d["num_hidden_layers"]
        if d.get("use_sliding_window") and d.get("sliding_window"):
            sw = int(d["sliding_window"])
            if d.get("layer_types"):
                sw_flags = tuple(t == "sliding_attention" for t in d["layer_types"])
            else:
                mwl = int(d.get("max_window_layers", L))
                sw_flags = tuple(i < mwl for i in range(L))
            if not any(sw_flags):
                sw = None
                sw_flags = None
        return ModelConfig(
            vocab_size=d["vocab_size"],
            hidden_size=d["hidden_size"],
            intermediate_size=d["intermediate_size"],
            num_layers=d["num_hidden_layers"],
            num_q_heads=num_q,
            num_kv_heads=d.get("num_key_value_heads", num_q),
            head_dim=head_dim,
            rms_eps=d.get("rms_norm_eps", 1e-5),
            rope=RopeConfig.from_hf(d.get("rope_theta", 10000.0), d.get("rope_scaling")),
            max_position_embeddings=d.get("max_position_embeddings", 4096),
            attn_qkv_bias=is_qwen2,
            qk_norm=is_qwen3,
            tie_embeddings=d.get("tie_word_embeddings", False),
            num_experts=d.get("num_local_experts", 0) if is_mixtral else 0,
            experts_per_token=d.get("num_experts_per_tok", 0) if is_mixtral else 0,
            sliding_window=sw,
            sliding_layer_flags=sw_flags,
            dtype=dtype,
        )

    @staticmethod
    def from_hf_json(path: str, dtype=torch.bfloat16) -> "ModelConfig":
        with open(os.path.join(path, "config.json") if os.path.isdir(path) else path) as f:
            return ModelConfig.from_hf_dict(json.load(f), dtype=dtype)


@dataclasses.dataclass(frozen=True)
class DraftConfig:
    """Draft-head config: version 1 (EAGLE-1/2) or 3 (EAGLE-3)."""

    version: int
    hidden_size: int
    intermediate_size: int
    num_q_heads: int
    num_kv_heads: int
    head_dim: int
    vocab_size: int
    draft_vocab_size: int = 0  # 0 → same as vocab_size (no d2t/t2d)
    target_hidden_size: int = 0  # 0 → same as hidden_size
    num_layers: int = 1
    rms_eps: float = 1e-5
    rope: RopeConfig = dataclasses.field(default_factory=RopeConfig)
    max_position_embeddings: int = 4096
    attn_qkv_bias: bool = False
    dtype: Any = torch.bfloat16

    @property
    def q_dim(self) -> int:
        return self.num_q_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    @property
    def effective_draft_vocab(self) -> int:
        return self.draft_vocab_size or self.vocab_size

    @property
    def fuse_in_dim(self) -> int:
        """Input width of the feature-fusion fc."""
        t = self.target_hidden_size or self.hidden_size
        return (3 * t) if self.version == 3 else (2 * self.hidden_size)

    @staticmethod
    def from_hf_dict(d: dict, version: Optional[int] = None,
                     dtype=torch.bfloat16) -> "DraftConfig":
        if version is None:
            version = 3 if "draft_vocab_size" in d else 1
        num_q = d["num_attention_heads"]
        head_dim = d.get("head_dim") or d["hidden_size"] // num_q
        return DraftConfig(
            version=version,
            hidden_size=d["hidden_size"],
            intermediate_size=d["intermediate_size"],
            num_q_heads=num_q,
            num_kv_heads=d.get("num_key_value_heads", num_q),
            head_dim=head_dim,
            vocab_size=d["vocab_size"],
            draft_vocab_size=d.get("draft_vocab_size", 0),
            target_hidden_size=d.get("target_hidden_size", 0),
            num_layers=d.get("num_hidden_layers", 1),
            rms_eps=d.get("rms_norm_eps", 1e-5),
            rope=RopeConfig.from_hf(d.get("rope_theta", 10000.0), d.get("rope_scaling")),
            max_position_embeddings=d.get("max_position_embeddings", 4096),
            attn_qkv_bias=bool(d.get("attention_bias", False) or d.get("bias", False)),
            dtype=dtype,
        )

    @staticmethod
    def from_hf_json(path: str, version: Optional[int] = None,
                     dtype=torch.bfloat16) -> "DraftConfig":
        with open(os.path.join(path, "config.json") if os.path.isdir(path) else path) as f:
            return DraftConfig.from_hf_dict(json.load(f), version=version, dtype=dtype)


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Speculation-engine operating point (same fields and defaults as the
    JAX package; options this slice does not port raise in EagleEngine)."""

    total_tokens: int = 60   # tree nodes excluding root
    depth: int = 5           # draft expansion steps
    top_k: int = 10          # beam width / children per node
    max_len: int = 2048      # preallocated KV slots
    acceptance: str = "true_q"
    draft_quant: str = "none"
    draft_quant_group: int = 128
    kv_quant: str = "none"
    # accepted-branch KV compaction: "xla" = plain gather + copy
    # (ops/kv_cache.compact_accepted); "pallas" = the in-place CUDA kernel
    # (ops/attn_kernels.compact_rows), B=1 rounds only
    compact_impl: str = "xla"
    temperature: float = 0.0
    top_p: float = 0.0
    sampling_top_k: int = 0
    kv_buckets: Optional[Tuple[int, ...]] = None
    tree_paths: Optional[Tuple[Tuple[int, ...], ...]] = None
    fuse_draft: bool = True
    fuse_scoring: bool = False

    @property
    def tree_size(self) -> int:
        if self.tree_paths is not None:
            return len(self.tree_paths) + 1  # paths + root
        return self.total_tokens + 1  # + root
