"""EAGLE draft heads (version 1: EAGLE-1/2; version 3: EAGLE-3).

Port of eagle_tpu/models/draft.py. v1: `fc(concat(embed, feature))` then N
decoder layers (layer 0 without input norm), scored by the target's lm_head.
v3: the fused 3-tap feature goes through `fc(3h→h)` when it is wider than
the hidden; the single layer's QKV projects from
`concat(norm(emb), norm(hidden))`; the head is the draft's own reduced-vocab
`lm_head(norm(h))` with the d2t map. The draft KV cache is the same KVCache
as the target's and is written in place.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from .. import resolve_device
from ..config import DraftConfig
from ..ops.kv_cache import KVCache, update_layer
from ..ops.quant4 import _k_of
from .rope import apply_rope, rope_tables
from .transformer import _dense, attention, matmul_f32, rms_norm


def _quant_in_dim(w: dict) -> int:
    """Contraction dim of a quantized leaf ({"q8"} or packed {"q4"})."""
    return w["q8"].shape[-2] if "q8" in w else _k_of(w)


def _mlp(h: torch.Tensor, lp: dict) -> torch.Tensor:
    if "wgu" in lp:  # fused gate|up (fuse_projections)
        wd = lp["w_down"]
        Fi = _quant_in_dim(wd) if isinstance(wd, dict) else wd.shape[-2]
        gu = _dense(h, lp["wgu"])
        gate, up = gu[..., :Fi], gu[..., Fi:]
    else:
        gate, up = _dense(h, lp["w_gate"]), _dense(h, lp["w_up"])
    return _dense(F.silu(gate) * up, lp["w_down"])


def _attn_block(x, lp, cfg: DraftConfig, k_cache, v_cache, cos, sin, mask, start):
    """QKV → rope → cache write (in place) → masked attention → o_proj."""
    B, T, _ = x.shape
    if "wqkv" in lp:
        qd, kvd = cfg.q_dim, cfg.kv_dim
        qkv = _dense(x, lp["wqkv"], lp.get("bqkv"))
        q = qkv[..., :qd].reshape(B, T, cfg.num_q_heads, cfg.head_dim)
        k = qkv[..., qd:qd + kvd].reshape(B, T, cfg.num_kv_heads, cfg.head_dim)
        v = qkv[..., qd + kvd:].reshape(B, T, cfg.num_kv_heads, cfg.head_dim)
    else:
        q = _dense(x, lp["wq"], lp.get("bq")).reshape(B, T, cfg.num_q_heads, cfg.head_dim)
        k = _dense(x, lp["wk"], lp.get("bk")).reshape(B, T, cfg.num_kv_heads, cfg.head_dim)
        v = _dense(x, lp["wv"], lp.get("bv")).reshape(B, T, cfg.num_kv_heads, cfg.head_dim)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    update_layer(k_cache, v_cache, k, v, start)
    return _dense(attention(q, k_cache, v_cache, mask), lp["wo"])


def fuse_projections(dparams: dict) -> dict:
    """Concatenate each layer's q/k/v (and gate/up) weights along the output
    axis: wqkv [in, q_dim + 2*kv_dim], wgu [H, 2F]. Idempotent; layers that
    are already fused or quantized are left as they are."""
    if all("wqkv" in lp or isinstance(lp.get("wq"), dict) for lp in dparams["layers"]):
        return dparams            # nothing to fuse: the same dict
    out = dict(dparams)
    layers = []
    for lp in dparams["layers"]:
        if "wqkv" in lp or isinstance(lp.get("wq"), dict):
            layers.append(lp)
            continue
        nlp = dict(lp)
        nlp["wqkv"] = torch.cat([nlp.pop("wq"), nlp.pop("wk"), nlp.pop("wv")], dim=-1)
        n_bias = sum(k in nlp for k in ("bq", "bk", "bv"))
        if n_bias == 3:
            nlp["bqkv"] = torch.cat([nlp.pop("bq"), nlp.pop("bk"), nlp.pop("bv")], dim=-1)
        elif n_bias:
            raise ValueError("fuse_projections: layer has a partial q/k/v bias set "
                             f"({n_bias}/3)")
        if not isinstance(nlp.get("w_gate"), dict):
            nlp["wgu"] = torch.cat([nlp.pop("w_gate"), nlp.pop("w_up")], dim=-1)
        layers.append(nlp)
    out["layers"] = layers
    return out


class DraftResult(NamedTuple):
    hidden: torch.Tensor  # [B, T, H]
    cache: KVCache


def forward(params: dict, cfg: DraftConfig, tokens: torch.Tensor,
            feature: torch.Tensor, cache: KVCache, positions: torch.Tensor,
            mask: torch.Tensor) -> DraftResult:
    """Draft forward over T positions.

    tokens: [B, T]; feature: [B, T, F] (v1: H-wide target hidden; v3: 3H taps
    on the extension call, H-wide draft hidden on beam steps);
    positions: [B, T]; mask: [B, T, S] bool.
    """
    emb = params["embed"]["w"][tokens].to(cfg.dtype)
    cos, sin = rope_tables(cfg.rope, cfg.head_dim, positions)
    start = cache.length
    feature = feature.to(cfg.dtype)
    new_cache = KVCache(k=cache.k, v=cache.v, length=cache.length + tokens.shape[1])

    if cfg.version == 1:
        h = _dense(torch.cat([emb, feature], dim=-1), params["fc"]["w"],
                   params["fc"].get("b"))
        for i in range(cfg.num_layers):
            lp = params["layers"][i]
            x = h if i == 0 else rms_norm(h, lp["ln1"], cfg.rms_eps)
            h = h + _attn_block(x, lp, cfg, cache.k[i], cache.v[i], cos, sin,
                                mask, start)
            h = h + _mlp(rms_norm(h, lp["ln2"], cfg.rms_eps), lp)
        return DraftResult(hidden=h, cache=new_cache)

    lp = params["layers"][0]
    h = feature
    if feature.shape[-1] != cfg.hidden_size:
        h = _dense(feature, params["fc"]["w"])
    hn = rms_norm(h, lp["hidden_norm"], cfg.rms_eps)
    en = rms_norm(emb, lp["ln1"], cfg.rms_eps)
    x2 = torch.cat([en, hn], dim=-1)
    h = h + _attn_block(x2, lp, cfg, cache.k[0], cache.v[0], cos, sin, mask, start)
    h = h + _mlp(rms_norm(h, lp["ln2"], cfg.rms_eps), lp)
    return DraftResult(hidden=h, cache=new_cache)


def draft_logits(params: dict, cfg: DraftConfig, hidden: torch.Tensor,
                 target_lm_head=None) -> torch.Tensor:
    """Draft scoring head → fp32 logits over the draft vocab (v1: the
    target's lm_head on the raw hidden; v3: own lm_head over norm(h)). A
    quantized head (a dict) gives its result in the hidden dtype, then fp32."""
    if cfg.version == 1:
        if target_lm_head is None:
            raise ValueError("an EAGLE-1 draft scores with the target's lm_head")
        w, h = target_lm_head, hidden
    else:
        w, h = params["lm_head"], rms_norm(hidden, params["norm"], cfg.rms_eps)
    if isinstance(w, dict):
        return _dense(h, w).to(torch.float32)
    return matmul_f32(h, w)


def map_draft_to_target(params: dict, cfg: DraftConfig, draft_ids: torch.Tensor) -> torch.Tensor:
    """Reduced-draft-vocab ids → target-vocab ids via the d2t offsets."""
    if cfg.version == 3 and cfg.draft_vocab_size and cfg.draft_vocab_size != cfg.vocab_size:
        return draft_ids + params["d2t"][draft_ids]
    return draft_ids


# ---------------------------------------------------------------------------
# Initialization (random params from a seed)
# ---------------------------------------------------------------------------

def init_params(cfg: DraftConfig, seed: int = 1, device=None, dtype=None) -> dict:
    """Random params on `device` ("cuda" unless the caller passes "cpu")."""
    dtype = dtype or cfg.dtype
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    H, Fi = cfg.hidden_size, cfg.intermediate_size

    def rnd(*shape):
        w = torch.randn(shape, generator=gen, device=dev, dtype=torch.float32)
        return w.mul_(0.02).to(dtype)

    def ones(*shape):
        return torch.ones(shape, device=dev, dtype=dtype)

    def layer(i: int) -> dict:
        in_w = 2 * H if cfg.version == 3 else H
        lp = {"wq": rnd(in_w, cfg.q_dim), "wk": rnd(in_w, cfg.kv_dim),
              "wv": rnd(in_w, cfg.kv_dim), "wo": rnd(cfg.q_dim, H),
              "ln2": ones(H), "w_gate": rnd(H, Fi), "w_up": rnd(H, Fi),
              "w_down": rnd(Fi, H)}
        if cfg.attn_qkv_bias:
            for name, n in (("bq", cfg.q_dim), ("bk", cfg.kv_dim), ("bv", cfg.kv_dim)):
                lp[name] = torch.zeros(n, device=dev, dtype=dtype)
        if cfg.version == 3:
            lp["hidden_norm"] = ones(H)
            lp["ln1"] = ones(H)
        elif i != 0:
            lp["ln1"] = ones(H)
        return lp

    params = {"embed": {"w": rnd(cfg.vocab_size, H)},
              "layers": [layer(i) for i in range(cfg.num_layers if cfg.version == 1 else 1)],
              "fc": {"w": rnd(cfg.fuse_in_dim, H)}}
    if cfg.version == 1:
        params["fc"]["b"] = torch.zeros(H, device=dev, dtype=dtype)
    if cfg.version == 3:
        params["norm"] = ones(H)
        params["lm_head"] = rnd(H, cfg.effective_draft_vocab)
        if cfg.draft_vocab_size and cfg.draft_vocab_size != cfg.vocab_size:
            params["d2t"] = torch.zeros(cfg.draft_vocab_size, dtype=torch.long, device=dev)
            t2d = torch.zeros(cfg.vocab_size, dtype=torch.bool, device=dev)
            t2d[: cfg.draft_vocab_size] = True
            params["t2d"] = t2d
    return params
