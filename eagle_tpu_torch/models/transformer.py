"""Target-model transformer (Llama; Qwen2 qkv bias and Qwen3 qk_norm flags).

Port of eagle_tpu/models/transformer.py for dense targets in bf16/fp32,
int8 ({"q8", "scale"} leaves, ops/quant.py) and int4 ({"q4", "scale"}
leaves, ops/quant4.py). Params are a plain dict whose "layers" entry is a
list of per-layer dicts (the JAX package stacks them on a leading axis for
`lax.scan`; here a Python loop walks the list). Stacked int4 weights stay
whole under params["stacked4"] ({name: {"q4": [L, K/8, N], "scale":
[L, G, N]}}) and each layer gets a `Stacked4(q4, scale, layer)`, so the
kernel reads its layer in place. Weights keep the JAX layout [in, out], so
`x @ w`. Attention scores and softmax run in fp32; matmuls accumulate in
fp32 and cast to the activation dtype.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from .. import resolve_device
from ..config import ModelConfig
from ..ops.attn_kernels import tree_attention
from ..ops.kv_cache import KVCache, update_layer, update_layer_q
from ..ops.masks import TreeMaskSpec, tree_mask_full
from ..ops.quant import qdense
from ..ops.quant4 import Stacked4, qdense4, qdense4_stacked
from .rope import apply_rope, rope_tables

NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    """HF-exact RMSNorm: fp32 variance, scale applied in the input dtype."""
    dtype = x.dtype
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    xf = xf * torch.rsqrt(var + eps)
    return (xf.to(dtype) * weight.to(dtype)).to(dtype)


def _dense(x: torch.Tensor, w, b=None) -> torch.Tensor:
    """x @ w, result in x.dtype: a stacked int4 weight with its layer, a
    packed int4 or int8 dict, or a bf16/fp32 tensor (fp32 accumulation)."""
    if isinstance(w, Stacked4):
        return qdense4_stacked(x, w, b)
    if isinstance(w, dict):
        return qdense4(x, w, b) if "q4" in w else qdense(x, w, b)
    y = torch.matmul(x, w.to(x.dtype))
    if b is not None:
        y = y + b.to(y.dtype)
    return y


def matmul_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [..., K] @ w [K, N] with fp32 accumulation and an fp32 result (the
    JAX package's preferred_element_type=float32). bf16 products are exact
    in fp32, so on the card a bf16 GEMM with an fp32 output computes it
    without widening the weights."""
    if x.dtype == torch.float32:
        return torch.matmul(x, w.to(torch.float32))
    if x.is_cuda:
        x2 = x.reshape(-1, x.shape[-1])
        y = torch.mm(x2, w.to(x.dtype), out_dtype=torch.float32)
        return y.reshape(*x.shape[:-1], w.shape[-1])
    return torch.matmul(x.to(torch.float32), w.to(torch.float32))


def attention(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
              mask: torch.Tensor, ks: Optional[torch.Tensor] = None,
              vs: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Masked attention against the full KV buffer.

    q: [B, T, nq, d]; k/v_cache: [B, n_kv, S, d]; mask: [B, T, S] bool.
    fp32 scores and softmax; probs cast to q.dtype, then an fp32-accumulated
    product with V. Returns [B, T, nq*d].

    ks/vs: optional int8-KV row scales [B, n_kv, S] (ops/kv_cache.py). The
    int8 payload converts exactly to q.dtype; the K scale multiplies the
    fp32 scores per column and the V scale the fp32 probabilities per
    column, before their cast. A row's math is the same in the one-token
    vanilla step and in the tree verify, so greedy == vanilla holds within
    the int8-KV operating point.
    """
    B, T, nq, d = q.shape
    n_kv = k_cache.shape[1]
    g = nq // n_kv
    qh = q.transpose(1, 2).reshape(B, n_kv, g, T, d)
    scores = torch.einsum("bhgtd,bhsd->bhgts", qh.float(),
                          k_cache.to(q.dtype).float())
    if ks is not None:
        scores = scores * ks[:, :, None, None, :]
    scores = scores * (d ** -0.5)
    scores = torch.where(mask[:, None, None, :, :], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    if vs is not None:
        probs = probs * vs[:, :, None, None, :]
    probs = probs.to(q.dtype)
    out = torch.einsum("bhgts,bhsd->bhgtd", probs.float(),
                       v_cache.to(q.dtype).float()).to(q.dtype)
    return out.reshape(B, nq, T, d).transpose(1, 2).reshape(B, T, nq * d)


def _mlp_dense(h: torch.Tensor, lp: dict) -> torch.Tensor:
    if "w_gateup" in lp:   # fused gate|up (quantize_target_params4 fuse=True)
        gu = _dense(h, lp["w_gateup"])
        Fi = gu.shape[-1] // 2
        gate, up = gu[..., :Fi], gu[..., Fi:]
    else:
        gate = _dense(h, lp["w_gate"])
        up = _dense(h, lp["w_up"])
    return _dense(F.silu(gate) * up, lp["w_down"])


def _layer(h, lp, cfg: ModelConfig, k_cache, v_cache, cos, sin, mask, start,
           ks_cache=None, vs_cache=None):
    """One decoder layer; writes its K/V rows into k/v_cache in place and
    returns the new hidden states. ks_cache/vs_cache: int8-KV row scales
    [B, n_kv, S] (None for float caches): rows are quantized on write and
    attention reads fold the scales in."""
    B, T, _ = h.shape
    x = rms_norm(h, lp["ln1"], cfg.rms_eps)
    if "wqkv" in lp:   # fused q|k|v (quantize_target_params4 fuse=True)
        qkv = _dense(x, lp["wqkv"], lp.get("bqkv"))
        q = qkv[..., : cfg.q_dim]
        k = qkv[..., cfg.q_dim: cfg.q_dim + cfg.kv_dim]
        v = qkv[..., cfg.q_dim + cfg.kv_dim:]
    else:
        q = _dense(x, lp["wq"], lp.get("bq"))
        k = _dense(x, lp["wk"], lp.get("bk"))
        v = _dense(x, lp["wv"], lp.get("bv"))
    q = q.reshape(B, T, cfg.num_q_heads, cfg.head_dim)
    k = k.reshape(B, T, cfg.num_kv_heads, cfg.head_dim)
    v = v.reshape(B, T, cfg.num_kv_heads, cfg.head_dim)
    if cfg.qk_norm:
        q = rms_norm(q, lp["q_norm"], cfg.rms_eps)
        k = rms_norm(k, lp["k_norm"], cfg.rms_eps)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    # the tree K/V land in the cache at `start` before attention; the tree
    # kernel still reads them from the fresh k/v, and only rows < start of
    # the cache
    if ks_cache is not None:
        update_layer_q(k_cache, v_cache, ks_cache, vs_cache, k, v, start)
    else:
        update_layer(k_cache, v_cache, k, v, start)
    if isinstance(mask, TreeMaskSpec):
        # the tree kernel reads raw float KV; an int8 cache takes the plain
        # dense-mask path with scale-folded reads (as in the JAX package)
        if cfg.attn_impl == "pallas_tree" and ks_cache is None:
            # one launch for the whole batch, each row at its own start
            attn_out = tree_attention(q, k_cache, v_cache, k, v, mask.tree_mask,
                                      mask.start)
        else:
            dense = tree_mask_full(mask.tree_mask, k_cache.shape[2], mask.start)
            attn_out = attention(q, k_cache, v_cache, dense, ks=ks_cache, vs=vs_cache)
    else:
        attn_out = attention(q, k_cache, v_cache, mask, ks=ks_cache, vs=vs_cache)
    h = h + _dense(attn_out, lp["wo"])
    x = rms_norm(h, lp["ln2"], cfg.rms_eps)
    return h + _mlp_dense(x, lp)


class ForwardResult(NamedTuple):
    hidden: torch.Tensor           # [B, T, H] final-norm'd hidden states
    pre_norm_hidden: torch.Tensor  # [B, T, H] last-layer output before final norm
    taps: torch.Tensor             # [B, T, 3*H] EAGLE-3 fused features
    cache: KVCache


def check_supported(cfg: ModelConfig) -> None:
    if cfg.num_experts > 0:
        raise NotImplementedError("MoE targets are not ported yet")
    if cfg.sliding_window:
        raise NotImplementedError("sliding-window attention is not ported yet")


def forward(params: dict, cfg: ModelConfig, tokens: torch.Tensor, cache: KVCache,
            positions: torch.Tensor, mask) -> ForwardResult:
    """Run the transformer over tokens [B, T], writing K/V at cache.length.

    positions: [B, T] rope ids. mask: [B, T, S] bool over the full KV buffer,
    or a TreeMaskSpec for tree verification.
    """
    check_supported(cfg)
    h = params["embed"]["w"][tokens].to(cfg.dtype)
    B, T, H = h.shape
    cos, sin = rope_tables(cfg.rope, cfg.head_dim, positions)
    start = cache.length
    taps = [torch.zeros_like(h) for _ in range(3)]
    stacked4 = params.get("stacked4", {})
    for i, lp in enumerate(params["layers"]):
        if stacked4:
            lp = dict(lp)
            for name, qw in stacked4.items():
                lp[name] = Stacked4(qw["q4"], qw["scale"], i)
        for slot, tap in enumerate(cfg.tap_layers):
            if tap == i:
                taps[slot] = h
        h = _layer(h, lp, cfg, cache.k[i], cache.v[i], cos, sin, mask, start,
                   ks_cache=None if cache.ks is None else cache.ks[i],
                   vs_cache=None if cache.vs is None else cache.vs[i])
    new_cache = cache._replace(length=cache.length + T)
    hidden = rms_norm(h, params["final_norm"], cfg.rms_eps)
    return ForwardResult(hidden=hidden, pre_norm_hidden=h,
                         taps=torch.cat(taps, dim=-1), cache=new_cache)


def lm_head(params: dict, cfg: ModelConfig, hidden: torch.Tensor) -> torch.Tensor:
    """hidden [.., H] → fp32 logits [.., V]."""
    w = params["embed"]["w"].t() if cfg.tie_embeddings else params["lm_head"]
    if isinstance(w, dict):   # quantized target (ops/quant.py, ops/quant4.py)
        dense = qdense4 if "q4" in w else qdense
        return dense(hidden, w, out_dtype=torch.float32)
    return matmul_f32(hidden, w)


# ---------------------------------------------------------------------------
# Initialization (random params from a seed)
# ---------------------------------------------------------------------------

def init_params(cfg: ModelConfig, seed: int = 0, device=None, dtype=None,
                layer_fn=None) -> dict:
    """Random params (normal * 0.02, unit norms), generated on `device`
    ("cuda" unless the caller passes "cpu") from an explicit torch.Generator
    seeded with `seed`. `layer_fn` (optional) maps each layer's dict as soon
    as it is made."""
    check_supported(cfg)
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

    def layer() -> dict:
        lp = {"ln1": ones(H), "ln2": ones(H),
              "wq": rnd(H, cfg.q_dim), "wk": rnd(H, cfg.kv_dim),
              "wv": rnd(H, cfg.kv_dim), "wo": rnd(cfg.q_dim, H),
              "w_gate": rnd(H, Fi), "w_up": rnd(H, Fi), "w_down": rnd(Fi, H)}
        if cfg.attn_qkv_bias:
            lp["bq"] = torch.zeros(cfg.q_dim, device=dev, dtype=dtype)
            lp["bk"] = torch.zeros(cfg.kv_dim, device=dev, dtype=dtype)
            lp["bv"] = torch.zeros(cfg.kv_dim, device=dev, dtype=dtype)
        if cfg.qk_norm:
            lp["q_norm"] = ones(cfg.head_dim)
            lp["k_norm"] = ones(cfg.head_dim)
        return lp

    # each layer goes through `layer_fn` as soon as it is made (an int4
    # target packs it and drops the float weights), then the embedding and
    # the head are drawn: the same random stream whatever `layer_fn` does
    layers = [layer_fn(layer()) if layer_fn else layer()
              for _ in range(cfg.num_layers)]
    params = {"embed": {"w": rnd(cfg.vocab_size, H)}, "layers": layers,
              "final_norm": ones(H)}
    if not cfg.tie_embeddings:
        params["lm_head"] = rnd(H, cfg.vocab_size)
    return params
