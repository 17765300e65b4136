"""The int8 KV cache of the port (`kv_quant="int8"`) against the JAX package:
row quantization, quantize-on-write, scale-folded attention, the target
forward, compaction of payload and scales, and engines whose tokens equal
the JAX engine's and the port's own vanilla decode. CPU, fp32, same numpy
inputs on both sides."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eagle_tpu.models import transformer as jtr
from eagle_tpu.ops import kv_cache as jkv
from eagle_tpu.ops.masks import prefill_mask as j_prefill_mask
from eagle_tpu_torch import convert
from eagle_tpu_torch.engine import engine as engine_mod
from eagle_tpu_torch.models import transformer as ttr
from eagle_tpu_torch.ops import kv_cache as tkv
from eagle_tpu_torch.ops.masks import prefill_mask

from test_engine_greedy import PROMPT, make_engine
from torch_port_util import np_tree, port_engine, t

PROMPT2 = np.array([77, 3, 3, 120, 9, 64, 31, 2, 100, 45, 6], np.int32)


def test_quantize_kv_rows_bit_equal():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 3, 16)).astype(np.float32)
    x[0, 0, 0] = 0.0                               # an all-zero row: scale 0
    jq, js = jkv.quantize_kv_rows(jnp.asarray(x))
    q, s = tkv.quantize_kv_rows(t(x))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    assert float(s[0, 0, 0]) == 0.0 and int(q[0, 0, 0].abs().max()) == 0


def test_init_cache_int8_layout():
    c = tkv.init_cache(3, 1, 2, 24, 8, device="cpu", kv_quant="int8")
    j = jkv.init_cache(3, 1, 2, 24, 8, kv_quant="int8")
    assert c.quantized and c.k.dtype == torch.int8 and c.ks.dtype == torch.float32
    assert tuple(c.k.shape) == j.k.shape and tuple(c.ks.shape) == j.ks.shape
    assert not tkv.init_cache(1, 1, 1, 8, 4, device="cpu").quantized
    with pytest.raises(ValueError, match="kv_quant"):
        tkv.init_cache(1, 1, 1, 8, 4, device="cpu", kv_quant="int4")


def test_update_layer_q_and_compaction_match_jax():
    rng = np.random.default_rng(1)
    L, B, H, S, d, T = 2, 1, 2, 24, 8, 5
    c = tkv.init_cache(L, B, H, S, d, device="cpu", kv_quant="int8")
    j = jkv.init_cache(L, B, H, S, d, kv_quant="int8")
    start = np.array([6])
    jk, jv, jks, jvs = [], [], [], []
    for layer in range(L):
        kn = rng.normal(size=(B, T, H, d)).astype(np.float32)
        vn = rng.normal(size=(B, T, H, d)).astype(np.float32)
        tkv.update_layer_q(c.k[layer], c.v[layer], c.ks[layer], c.vs[layer],
                           t(kn), t(vn), t(start))
        out = jkv.update_layer_q(j.k[layer], j.v[layer], j.ks[layer], j.vs[layer],
                                 jnp.asarray(kn), jnp.asarray(vn),
                                 jnp.asarray(start, jnp.int32))
        for acc, a in zip((jk, jv, jks, jvs), out):
            acc.append(np.asarray(a))
    for got, want in ((c.k, jk), (c.v, jv), (c.ks, jks), (c.vs, jvs)):
        np.testing.assert_array_equal(got.numpy(), np.stack(want))
    # compaction moves payload and scales verbatim
    j = jkv.KVCache(k=jnp.asarray(np.stack(jk)), v=jnp.asarray(np.stack(jv)),
                    length=jnp.asarray(start, jnp.int32),
                    ks=jnp.asarray(np.stack(jks)), vs=jnp.asarray(np.stack(jvs)))
    path = np.array([[0, 2, 4, 4]])
    jc = jkv.compact_accepted(j, jnp.asarray(path, jnp.int32), jnp.asarray([3], jnp.int32))
    cc = tkv.compact_accepted(c._replace(length=t(start)), t(path), t(np.array([3])))
    assert int(cc.length[0]) == int(jc.length[0]) == 9
    for name in ("k", "v", "ks", "vs"):
        np.testing.assert_array_equal(getattr(cc, name).numpy(),
                                      np.asarray(getattr(jc, name)), err_msg=name)


def test_attention_with_scales_matches_jax():
    """rtol = atol = 1e-5: the fp32 sums of the two einsums run in another
    order."""
    rng = np.random.default_rng(2)
    B, T, nq, H, S, d = 1, 4, 4, 2, 16, 8
    q = rng.normal(size=(B, T, nq, d)).astype(np.float32)
    kq = rng.integers(-127, 128, (B, H, S, d)).astype(np.int8)
    vq = rng.integers(-127, 128, (B, H, S, d)).astype(np.int8)
    ks = rng.uniform(0.001, 0.02, (B, H, S)).astype(np.float32)
    vs = rng.uniform(0.001, 0.02, (B, H, S)).astype(np.float32)
    mask = np.tril(np.ones((T, S), bool), k=8)[None]
    want = jtr.attention(jnp.asarray(q), jnp.asarray(kq), jnp.asarray(vq),
                         jnp.asarray(mask), ks=jnp.asarray(ks), vs=jnp.asarray(vs))
    got = ttr.attention(t(q), t(kq), t(vq), t(mask), ks=t(ks), vs=t(vs))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    # the scales really enter: without them the result differs
    plain = ttr.attention(t(q), t(kq), t(vq), t(mask))
    assert float((plain - got).abs().max()) > 1e-2


def test_forward_int8_cache_matches_jax():
    je = make_engine(3)
    cfg = convert.model_config(je.cfg)
    params = convert.target_params(np_tree(je.params), device="cpu")
    rng = np.random.default_rng(3)
    S, T = 32, 6
    toks = rng.integers(0, 128, (1, T))
    pos = np.arange(T)[None]
    jc = jkv.init_cache(cfg.num_layers, 1, cfg.num_kv_heads, S, cfg.head_dim,
                        dtype=jnp.float32, kv_quant="int8")
    c = tkv.init_cache(cfg.num_layers, 1, cfg.num_kv_heads, S, cfg.head_dim,
                       dtype=torch.float32, device="cpu", kv_quant="int8")
    jres = jtr.forward(je.params, je.cfg, jnp.asarray(toks, jnp.int32), jc,
                       jnp.asarray(pos, jnp.int32), j_prefill_mask(T, S, jc.length))
    res = ttr.forward(params, cfg, t(toks), c, t(pos), prefill_mask(T, S, c.length))
    np.testing.assert_allclose(res.hidden.numpy(), np.asarray(jres.hidden), atol=1e-4)
    np.testing.assert_allclose(res.taps.numpy(), np.asarray(jres.taps), atol=1e-4)
    assert res.cache.k.dtype == torch.int8 and int(res.cache.length[0]) == T
    # quantized rows may differ by one step where a value sits on a rounding edge
    assert int((res.cache.k.numpy().astype(np.int32)
                - np.asarray(jres.cache.k).astype(np.int32)).__abs__().max()) <= 1
    np.testing.assert_allclose(res.cache.ks.numpy(), np.asarray(jres.cache.ks), rtol=1e-4)


@pytest.mark.parametrize("version", [1, 3])
def test_int8_kv_engine_tokens_equal_jax_and_vanilla(version):
    je = make_engine(version, kv_quant="int8")
    pe = port_engine(je)
    assert pe.init_target_cache().k.dtype == torch.int8
    assert pe.init_draft_cache().k.dtype == torch.float32     # the draft's dtype
    for prompt in (PROMPT, PROMPT2):
        jref = je.generate(prompt, max_new_tokens=32)
        np.testing.assert_array_equal(pe.generate(prompt, max_new_tokens=32), jref)
        np.testing.assert_array_equal(pe.generate_fused(prompt, max_new_tokens=32), jref)
        np.testing.assert_array_equal(pe.generate_vanilla(prompt, max_new_tokens=32), jref)


def test_int8_kv_runs_no_kernel_wrapper(monkeypatch):
    """With an int8 cache the verify takes the plain attention and the commit
    the plain compaction even when both kernel options are on, as in the JAX
    package; buckets and a static tree work on top of it."""
    def refuse(*a, **k):
        raise AssertionError("a kernel wrapper was called with an int8 KV cache")

    monkeypatch.setattr(engine_mod, "compact_rows", refuse)
    monkeypatch.setattr(ttr, "tree_attention", refuse)
    je = make_engine(3)
    pe = port_engine(je, attn_impl="pallas_tree", compact_impl="pallas",
                     kv_quant="int8", kv_buckets=(64, 128))
    ref = pe.generate_vanilla(PROMPT, max_new_tokens=30, fused=True)
    np.testing.assert_array_equal(pe.generate_fused(PROMPT, max_new_tokens=30), ref)
    static = pe._sibling(tree_paths=((0,), (1,), (0, 0), (0, 1), (0, 0, 0)))
    np.testing.assert_array_equal(static.generate(PROMPT, max_new_tokens=25),
                                  static.generate_vanilla(PROMPT, max_new_tokens=25))
    with pytest.raises(AssertionError):          # the float cache does call them
        pe._sibling(kv_quant="none").generate(PROMPT, max_new_tokens=4)
