"""Sampled drafting in the port (eagle_tpu_torch/engine/drafter.py) against
eagle_tpu/engine/drafter.py on the same noise: Gumbel candidates (a reduced
draft vocabulary too), sampled static trees (`draft_round_static`,
acceptance "true_q") and sampled dynamic trees (`draft_round`, acceptance
"true_q_dynamic"). The JAX drafters draw from the key they get; the test
draws the same uniforms in the same order and hands them to the port.
Tokens, parents and children must be identical, node_probs within atol
1e-6. CPU, fp32, inputs from numpy seeds."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from eagle_tpu.config import EngineConfig as JEngineConfig
from eagle_tpu.engine import drafter as jdrafter
from eagle_tpu.models import draft as jdraft
from eagle_tpu.ops.kv_cache import init_cache as j_init_cache
from eagle_tpu_torch import convert
from eagle_tpu_torch.engine import drafter as tdrafter
from eagle_tpu_torch.ops import tree as ttree
from eagle_tpu_torch.ops.kv_cache import init_cache

from test_engine_greedy import tiny_dcfg
from torch_port_util import np_tree, t

SAMPLED = dict(total_tokens=15, depth=3, top_k=4, max_len=64, temperature=0.8,
               top_p=0.9)


def _setup(version, draft_vocab, seed):
    jdcfg = tiny_dcfg(version, draft_vocab=draft_vocab)
    jdp = jdraft.init_params(jdcfg, jax.random.PRNGKey(seed))
    if draft_vocab:
        jdp["d2t"] = jnp.arange(draft_vocab, dtype=jnp.int32) % 7
    dcfg, dp = convert.draft_config(jdcfg), convert.draft_params(np_tree(jdp), device="cpu")
    rng = np.random.default_rng(seed)
    lm = (rng.normal(size=(dcfg.hidden_size, 128)) * 0.3).astype(np.float32)
    jlm, tlm = (jnp.asarray(lm), t(lm)) if version == 1 else (None, None)
    return jdcfg, jdp, dcfg, dp, jlm, tlm, rng


def _replay(uniforms):
    """The port's noise: the given arrays, in order, each checked for shape."""
    it = iter(uniforms)

    def noise(shape):
        u = next(it)
        assert tuple(u.shape) == tuple(shape), (u.shape, shape)
        return torch.from_numpy(np.array(u))
    return noise


def _uniforms(key, shapes):
    return [jax.random.uniform(k, s, jnp.float32, 1e-20, 1.0) for k, s in zip(key, shapes)]


def _assert_same(jr, r, atol_cache=1e-4):
    for name in ("tokens", "parents", "mask", "positions", "children"):
        np.testing.assert_array_equal(getattr(r.tree, name).numpy(),
                                      np.asarray(getattr(jr.tree, name)), err_msg=name)
    np.testing.assert_allclose(r.tree.node_probs.numpy(), np.asarray(jr.tree.node_probs),
                               rtol=0, atol=1e-6)
    n = int(jr.dcache.length[0])
    assert int(r.dcache.length[0]) == n
    np.testing.assert_allclose(r.dcache.k.numpy()[..., :n, :],
                               np.asarray(jr.dcache.k)[..., :n, :], atol=atol_cache)


@pytest.mark.parametrize("draft_vocab", [0, 64], ids=["full_vocab", "reduced_vocab"])
@pytest.mark.parametrize("setting", [dict(temperature=1.0), dict(temperature=0.5, top_p=0.9),
                                     dict(temperature=1.3, sampling_top_k=6)],
                         ids=["t1", "t0.5-p0.9", "t1.3-k6"])
def test_gumbel_candidates_match_jax(setting, draft_vocab):
    jdcfg, jdp, dcfg, dp, *_ = _setup(3, draft_vocab, seed=4)
    dV = draft_vocab or 128
    rng = np.random.default_rng(5)
    rows = rng.normal(0, 2, size=(9, dV)).astype(np.float32)
    rows[0, :3] = rows[0].max()                     # tied leaders
    key = jax.random.PRNGKey(8)
    jecfg = JEngineConfig(**setting)
    jtok, jprobs = jdrafter._gumbel_topk_candidates(jdp, jdcfg, jecfg, jnp.asarray(rows),
                                                    key, setting["temperature"], 5)
    u = jax.random.uniform(key, rows.shape, jnp.float32, 1e-20, 1.0)
    tok, probs = tdrafter._gumbel_topk_candidates(dp, dcfg, convert.engine_config(jecfg),
                                                  t(rows), torch.from_numpy(np.array(u)),
                                                  setting["temperature"], 5)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
    np.testing.assert_allclose(probs.numpy(), np.asarray(jprobs), rtol=0, atol=1e-6)
    assert probs.shape == (9, 128)
    if draft_vocab:        # the mass sits on the d2t-mapped target ids only
        assert int((probs[0] > 0).sum()) <= draft_vocab
        ids = np.arange(draft_vocab) + np.arange(draft_vocab) % 7
        assert set(tok.flatten().tolist()) <= set(ids.tolist())


@pytest.mark.parametrize("version,draft_vocab", [(1, 0), (3, 0), (3, 64)])
def test_sampled_static_trees_match_jax(version, draft_vocab):
    """Two sampled static rounds (prefill-sized, then round-sized) through
    both drafters on the JAX keys' uniforms."""
    jdcfg, jdp, dcfg, dp, jlm, tlm, rng = _setup(version, draft_vocab, seed=7)
    jecfg = JEngineConfig(acceptance="true_q", **SAMPLED)
    jspec = jdrafter.StaticTreeSpec(ttree.MC_SIM_7B_63)
    spec = tdrafter.StaticTreeSpec(ttree.MC_SIM_7B_63)
    S = 64 + spec.num_nodes + 7
    jc = j_init_cache(1, 1, jdcfg.num_kv_heads, S, jdcfg.head_dim, dtype=jnp.float32)
    c = init_cache(1, 1, dcfg.num_kv_heads, S, dcfg.head_dim, dtype=torch.float32,
                   device="cpu")
    F = dcfg.fuse_in_dim // 2 if version == 1 else dcfg.fuse_in_dim
    dV = draft_vocab or 128
    shapes = [(1, dV)] + [(len(lv), dV) for d, lv in enumerate(spec.levels)
                          if d + 1 < spec.max_depth]
    jround = jax.jit(lambda toks, feats, n, cache, key: jdrafter.draft_round_static(
        jdp, jdcfg, jspec, toks, feats, n, cache, jlm, ecfg=jecfg, key=key,
        temperature=jnp.float32(0.7)))
    T = 12
    for n_new, seed in ((9, 1), (3, 2)):
        toks = rng.integers(0, 128, T)
        feats = rng.normal(size=(T, F)).astype(np.float32)
        key = jax.random.PRNGKey(seed)
        jr = jround(jnp.asarray(toks, jnp.int32), jnp.asarray(feats), jnp.int32(n_new), jc,
                    key)
        noise = _replay(_uniforms(jax.random.split(key, spec.max_depth + 1), shapes))
        r = tdrafter.draft_round_static(dp, dcfg, spec, t(toks), t(feats),
                                        torch.tensor(n_new), c, tlm,
                                        ecfg=convert.engine_config(jecfg), noise=noise,
                                        temperature=torch.tensor(0.7))
        _assert_same(jr, r)
        jc, c = jr.dcache, r.dcache


@pytest.mark.parametrize("version,draft_vocab", [(1, 0), (3, 0), (3, 64)])
def test_true_q_dynamic_trees_match_jax(version, draft_vocab):
    """Two sampled dynamic rounds: the deterministic beam's shape, re-expanded
    on the JAX keys' uniforms ([1, dV] at the root, then [N - 1, dV] per
    level)."""
    jdcfg, jdp, dcfg, dp, jlm, tlm, rng = _setup(version, draft_vocab, seed=5)
    jecfg = JEngineConfig(acceptance="true_q_dynamic", **SAMPLED)
    ecfg = convert.engine_config(jecfg)
    S = 64 + max((jecfg.depth + 1) * jecfg.top_k, jecfg.tree_size) + 5
    jc = j_init_cache(1, 1, jdcfg.num_kv_heads, S, jdcfg.head_dim, dtype=jnp.float32)
    c = init_cache(1, 1, dcfg.num_kv_heads, S, dcfg.head_dim, dtype=torch.float32,
                   device="cpu")
    F = dcfg.fuse_in_dim // 2 if version == 1 else dcfg.fuse_in_dim
    dV, N = draft_vocab or 128, jecfg.tree_size
    shapes = [(1, dV)] + [(N - 1, dV)] * jecfg.depth
    jround = jax.jit(lambda toks, feats, n, cache, key: jdrafter.draft_round(
        jdp, jdcfg, jecfg, toks, feats, n, cache, jlm, key=key,
        temperature=jnp.float32(0.9)))                  # one shape, one compile
    T = 12
    for n_new, seed in ((9, 3), (3, 4)):
        toks = rng.integers(0, 128, T)
        feats = rng.normal(size=(T, F)).astype(np.float32)
        key = jax.random.PRNGKey(seed)
        jr = jround(jnp.asarray(toks, jnp.int32), jnp.asarray(feats), jnp.int32(n_new), jc,
                    key)
        noise = _replay(_uniforms(jax.random.split(key, jecfg.depth + 2), shapes))
        r = tdrafter.draft_round(dp, dcfg, ecfg, t(toks), t(feats), torch.tensor(n_new), c,
                                 tlm, noise=noise, temperature=torch.tensor(0.9))
        _assert_same(jr, r)
        jc, c = jr.dcache, r.dcache


def test_sampled_dynamic_shares_deterministic_shape():
    """true_q_dynamic: the sampled tree's SHAPE equals the deterministic
    beam's (a function of the committed context alone, which keeps true-q
    acceptance lossless on dynamic trees); the root is the pending token in
    both; a node's draft distribution is normalised and gives its drawn
    children positive mass; two noise streams give the same shape."""
    jdcfg, jdp, dcfg, dp, jlm, tlm, rng = _setup(1, 0, seed=5)
    T = 6
    ext_tokens = t(rng.integers(0, dcfg.vocab_size, T))
    ext_feats = t(rng.normal(size=(T, dcfg.hidden_size)).astype(np.float32))
    head_w = t((rng.normal(size=(dcfg.hidden_size, dcfg.vocab_size)) * 0.3).astype(np.float32))
    det_cfg = convert.engine_config(JEngineConfig(total_tokens=14, depth=3, top_k=4,
                                                  max_len=64))
    smp_cfg = dataclasses.replace(det_cfg, temperature=0.8, acceptance="true_q_dynamic")

    def fresh():
        return init_cache(dcfg.num_layers, 1, dcfg.num_kv_heads, 128, dcfg.head_dim,
                          dtype=torch.float32, device="cpu")

    def noise_from(seed):
        gen = torch.Generator().manual_seed(seed)
        return lambda shape: torch.rand(shape, generator=gen).clamp_min(1e-20)

    det = tdrafter.draft_round(dp, dcfg, det_cfg, ext_tokens, ext_feats, torch.tensor(T),
                               fresh(), head_w)
    smp = tdrafter.draft_round(dp, dcfg, smp_cfg, ext_tokens, ext_feats, torch.tensor(T),
                               fresh(), head_w, noise=noise_from(42),
                               temperature=torch.tensor(0.8))
    assert torch.equal(det.tree.parents, smp.tree.parents)
    assert det.tree.node_probs is None and smp.tree.node_probs is not None
    assert int(det.tree.tokens[0]) == int(smp.tree.tokens[0])
    probs, ch, toks = smp.tree.node_probs.numpy(), smp.tree.children.numpy(), smp.tree.tokens.numpy()
    for n in range(len(toks)):
        kids = ch[n][ch[n] >= 0]
        if len(kids):
            np.testing.assert_allclose(probs[n].sum(), 1.0, atol=1e-4)
            assert np.all(probs[n][toks[kids]] > 0)
    smp2 = tdrafter.draft_round(dp, dcfg, smp_cfg, ext_tokens, ext_feats, torch.tensor(T),
                                fresh(), head_w, noise=noise_from(7),
                                temperature=torch.tensor(0.8))
    assert torch.equal(smp.tree.parents, smp2.tree.parents)
    assert not torch.equal(smp.tree.tokens, smp2.tree.tokens)
