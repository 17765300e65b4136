"""The port's target transformer (eagle_tpu_torch/models/transformer.py)
against the JAX forward: a causal prefill, then a tree verify under a
TreeMaskSpec (dense mask and tree-attention kernel paths), with llama3 rope.
CPU, fp32; the JAX side interprets its Pallas tree kernel."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eagle_tpu.config import ModelConfig as JModelConfig
from eagle_tpu.config import RopeConfig as JRopeConfig
from eagle_tpu.models import transformer as jtr
from eagle_tpu.ops.kv_cache import init_cache as j_init_cache
from eagle_tpu.ops.masks import TreeMaskSpec as JTreeMaskSpec
from eagle_tpu.ops.masks import prefill_mask as j_prefill_mask
from eagle_tpu.ops.tree import ancestor_mask as j_ancestor_mask
from eagle_tpu_torch import convert
from eagle_tpu_torch.models import rope as trope
from eagle_tpu_torch.models import transformer as ttr
from eagle_tpu_torch.ops.kv_cache import init_cache
from eagle_tpu_torch.ops.masks import TreeMaskSpec, prefill_mask

from torch_port_util import np_tree, t

ATOL = 1e-4
LLAMA3 = JRopeConfig(theta=500000.0, scaling_type="llama3", scaling_factor=8.0,
                     original_max_position=64)


def _cfg(variant):
    kw = dict(vocab_size=128, hidden_size=32, intermediate_size=64,
              num_layers=5, num_q_heads=4, num_kv_heads=2, head_dim=8,
              dtype=jnp.float32, rope=LLAMA3)
    if variant == "qwen2":
        kw["attn_qkv_bias"] = True
    elif variant == "qwen3":
        kw["qk_norm"] = True
    return JModelConfig(**kw)


def _random_biases(params, rng):
    """init_params zeroes biases and unit-initialises norms; perturb them so
    the flags are exercised."""
    layers = dict(params["layers"])
    for name in ("bq", "bk", "bv", "q_norm", "k_norm"):
        if name in layers:
            layers[name] = layers[name] + jnp.asarray(
                rng.normal(size=layers[name].shape) * 0.1, jnp.float32)
    return {**params, "layers": layers}


@pytest.mark.parametrize("variant", ["llama31", "qwen2", "qwen3"])
@pytest.mark.parametrize("attn_impl", ["xla", "pallas_tree"])
def test_forward_prefill_then_tree_verify(variant, attn_impl):
    jcfg = dataclasses.replace(_cfg(variant), attn_impl=attn_impl)
    rng = np.random.default_rng(7)
    jparams = _random_biases(jtr.init_params(jcfg, jax.random.PRNGKey(3)), rng)
    cfg = convert.model_config(jcfg)
    params = convert.target_params(np_tree(jparams), device="cpu")
    S, Tp, T = 64, 11, 9
    jcache = j_init_cache(jcfg.num_layers, 1, jcfg.num_kv_heads, S,
                          jcfg.head_dim, dtype=jnp.float32)
    cache = init_cache(cfg.num_layers, 1, cfg.num_kv_heads, S, cfg.head_dim,
                       dtype=torch.float32, device="cpu")

    # 1. prefill
    toks = rng.integers(0, 128, (1, Tp))
    pos = np.arange(Tp)[None]
    jres = jtr.forward(jparams, jcfg, jnp.asarray(toks, jnp.int32), jcache,
                       jnp.asarray(pos, jnp.int32),
                       j_prefill_mask(Tp, S, jcache.length))
    res = ttr.forward(params, cfg, t(toks), cache, t(pos),
                      prefill_mask(Tp, S, cache.length))
    _compare(jres, res, jparams, jcfg, params, cfg)

    # 2. tree verify at start = Tp under an ancestor mask
    parents = np.array([0] + [rng.integers(0, i) for i in range(1, T)])
    tm = np.asarray(j_ancestor_mask(jnp.asarray(parents, jnp.int32), T))
    depth = tm.sum(1) - 1
    vt = rng.integers(0, 128, (1, T))
    vpos = (Tp + depth)[None]
    jres2 = jtr.forward(jparams, jcfg, jnp.asarray(vt, jnp.int32), jres.cache,
                        jnp.asarray(vpos, jnp.int32),
                        JTreeMaskSpec(tree_mask=jnp.asarray(tm)[None],
                                      start=jres.cache.length))
    res2 = ttr.forward(params, cfg, t(vt), res.cache, t(vpos),
                       TreeMaskSpec(tree_mask=t(tm)[None], start=res.cache.length))
    _compare(jres2, res2, jparams, jcfg, params, cfg)


def _compare(jres, res, jparams, jcfg, params, cfg):
    np.testing.assert_allclose(res.hidden.numpy(), np.asarray(jres.hidden), atol=ATOL)
    np.testing.assert_allclose(res.taps.numpy(), np.asarray(jres.taps), atol=ATOL)
    np.testing.assert_allclose(res.pre_norm_hidden.numpy(),
                               np.asarray(jres.pre_norm_hidden), atol=ATOL)
    n = int(jres.cache.length[0])
    assert int(res.cache.length[0]) == n
    for got, exp in ((res.cache.k, jres.cache.k), (res.cache.v, jres.cache.v)):
        np.testing.assert_allclose(got.numpy()[..., :n, :],
                                   np.asarray(exp)[..., :n, :], atol=ATOL)
    np.testing.assert_allclose(
        ttr.lm_head(params, cfg, res.hidden).numpy(),
        np.asarray(jtr.lm_head(jparams, jcfg, jres.hidden)), atol=ATOL)


def test_rope_tables_match_jax():
    from eagle_tpu.models import rope as jrope

    cfg = convert.rope_config(LLAMA3)
    np.testing.assert_array_equal(trope.rope_inv_freq(cfg, 128),
                                  jrope.rope_inv_freq(LLAMA3, 128))
    pos = np.arange(0, 3000, 7)[None]
    jc, js = jrope.rope_tables(LLAMA3, 128, jnp.asarray(pos, jnp.int32))
    c, s = trope.rope_tables(cfg, 128, t(pos))
    np.testing.assert_allclose(c.numpy(), np.asarray(jc), atol=2e-6)
    np.testing.assert_allclose(s.numpy(), np.asarray(js), atol=2e-6)


def test_rms_norm_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, 5, 32)).astype(np.float32)
    w = rng.normal(size=(32,)).astype(np.float32)
    np.testing.assert_allclose(
        ttr.rms_norm(t(x), t(w), 1e-5).numpy(),
        np.asarray(jtr.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5)),
        rtol=1e-6, atol=1e-6)


def test_unported_target_options_raise():
    base = convert.model_config(_cfg("llama31"))
    for change in (dict(num_experts=4, experts_per_token=2),
                   dict(sliding_window=8, sliding_layer_flags=(True,) * 5)):
        with pytest.raises(NotImplementedError):
            ttr.init_params(dataclasses.replace(base, **change))
