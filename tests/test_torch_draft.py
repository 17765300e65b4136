"""The port's draft heads and dynamic drafter (eagle_tpu_torch/models/draft.py,
engine/drafter.py) against the JAX package: draft forward v1/v3, and
draft_round trees (tokens, parents, ancestor mask) that must be identical,
including rounds whose candidate scores tie exactly. CPU, fp32."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eagle_tpu.config import EngineConfig as JEngineConfig
from eagle_tpu.engine import drafter as jdrafter
from eagle_tpu.models import draft as jdraft
from eagle_tpu.ops.kv_cache import init_cache as j_init_cache
from eagle_tpu.ops.masks import prefill_mask as j_prefill_mask
from eagle_tpu_torch import convert
from eagle_tpu_torch.engine import drafter as tdrafter
from eagle_tpu_torch.models import draft as tdraft
from eagle_tpu_torch.ops.kv_cache import init_cache
from eagle_tpu_torch.ops.masks import prefill_mask

from test_engine_greedy import tiny_dcfg
from torch_port_util import np_tree, t

ATOL = 1e-4


def _setup(version, draft_vocab=0, fused=False, seed=5):
    jdcfg = tiny_dcfg(version, draft_vocab=draft_vocab)
    jdp = jdraft.init_params(jdcfg, jax.random.PRNGKey(seed))
    if draft_vocab:  # a non-trivial d2t map
        jdp["d2t"] = jnp.arange(draft_vocab, dtype=jnp.int32) % 7
    if fused:
        jdp = jdraft.fuse_projections(jdp)
    return jdcfg, jdp, convert.draft_config(jdcfg), convert.draft_params(np_tree(jdp), device="cpu")


@pytest.mark.parametrize("version,fused", [(1, False), (3, False), (3, True)])
def test_draft_forward_matches_jax(version, fused):
    jdcfg, jdp, dcfg, dp = _setup(version, fused=fused)
    rng = np.random.default_rng(1)
    S, T = 32, 6
    F = dcfg.fuse_in_dim // 2 if version == 1 else dcfg.fuse_in_dim
    toks = rng.integers(0, 128, (1, T))
    feats = rng.normal(size=(1, T, F)).astype(np.float32)
    pos = np.arange(3, 3 + T)[None]
    jc = j_init_cache(1, 1, jdcfg.num_kv_heads, S, jdcfg.head_dim, dtype=jnp.float32)
    jc = jc._replace(length=jnp.asarray([3], jnp.int32))
    c = init_cache(1, 1, dcfg.num_kv_heads, S, dcfg.head_dim, dtype=torch.float32,
                   device="cpu")
    c = c._replace(length=torch.tensor([3]))
    jres = jdraft.forward(jdp, jdcfg, jnp.asarray(toks, jnp.int32), jnp.asarray(feats),
                          jc, jnp.asarray(pos, jnp.int32), j_prefill_mask(T, S, jc.length))
    res = tdraft.forward(dp, dcfg, t(toks), t(feats), c, t(pos),
                         prefill_mask(T, S, c.length))
    np.testing.assert_allclose(res.hidden.numpy(), np.asarray(jres.hidden), atol=ATOL)
    np.testing.assert_allclose(res.cache.k.numpy(), np.asarray(jres.cache.k), atol=ATOL)
    np.testing.assert_allclose(res.cache.v.numpy(), np.asarray(jres.cache.v), atol=ATOL)
    lm = rng.normal(size=(dcfg.hidden_size, 128)).astype(np.float32) * 0.1
    np.testing.assert_allclose(
        tdraft.draft_logits(dp, dcfg, res.hidden, t(lm)).numpy(),
        np.asarray(jdraft.draft_logits(jdp, jdcfg, jres.hidden, jnp.asarray(lm))),
        atol=ATOL)


def _two_rounds(version, draft_vocab=0, tie=False, seed=5):
    """Run a prefill-sized extension and then a round-sized one through both
    drafters; return the pair of (JAX, port) trees per call."""
    jdcfg, jdp, dcfg, dp = _setup(version, draft_vocab=draft_vocab, seed=seed)
    rng = np.random.default_rng(seed)
    lm = (rng.normal(size=(dcfg.hidden_size, 128)) * 0.3).astype(np.float32)
    if tie:  # every candidate score ties exactly
        lm[:] = 0.0
        if version == 3:
            dp["lm_head"].zero_()
            jdp = {**jdp, "lm_head": jnp.zeros_like(jdp["lm_head"])}
    jecfg = JEngineConfig(total_tokens=15, depth=3, top_k=4, max_len=64)
    ecfg = convert.engine_config(jecfg)
    S = 64 + max((jecfg.depth + 1) * jecfg.top_k, jecfg.tree_size) + 5
    jc = j_init_cache(1, 1, jdcfg.num_kv_heads, S, jdcfg.head_dim, dtype=jnp.float32)
    c = init_cache(1, 1, dcfg.num_kv_heads, S, dcfg.head_dim, dtype=torch.float32,
                   device="cpu")
    F = dcfg.fuse_in_dim // 2 if version == 1 else dcfg.fuse_in_dim
    jlm = jnp.asarray(lm) if version == 1 else None
    tlm = t(lm) if version == 1 else None
    out = []
    for T, n_new in ((12, 9), (5, 3)):
        toks = rng.integers(0, 128, T)
        feats = rng.normal(size=(T, F)).astype(np.float32)
        jr = jdrafter.draft_round(jdp, jdcfg, jecfg, jnp.asarray(toks, jnp.int32),
                                  jnp.asarray(feats), jnp.int32(n_new), jc, jlm)
        r = tdrafter.draft_round(dp, dcfg, ecfg, t(toks), t(feats),
                                 torch.tensor(n_new), c, tlm)
        jc, c = jr.dcache, r.dcache
        out.append((jr, r))
    return out


def _assert_same_tree(jr, r):
    for name in ("tokens", "parents", "mask", "positions", "children"):
        np.testing.assert_array_equal(getattr(r.tree, name).numpy(),
                                      np.asarray(getattr(jr.tree, name)), err_msg=name)
    n = int(jr.dcache.length[0])
    assert int(r.dcache.length[0]) == n
    np.testing.assert_allclose(r.dcache.k.numpy()[..., :n, :],
                               np.asarray(jr.dcache.k)[..., :n, :], atol=ATOL)


@pytest.mark.parametrize("version,draft_vocab", [(1, 0), (3, 0), (3, 64)])
def test_draft_round_trees_identical(version, draft_vocab):
    for jr, r in _two_rounds(version, draft_vocab):
        _assert_same_tree(jr, r)


@pytest.mark.parametrize("version", [1, 3])
def test_draft_round_tie_rule(version):
    """With a zero scoring head every candidate ties: both drafters must
    break ties by ascending index (jax.lax.top_k's rule)."""
    for jr, r in _two_rounds(version, tie=True):
        _assert_same_tree(jr, r)
        # ties → the lowest draft ids, in order, under the root
        kids = r.tree.children[0].numpy()
        assert (r.tree.tokens[kids].numpy() == np.arange(4)).all()


def test_topk_rows_tie_rule_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.integers(0, 4, size=(6, 50)).astype(np.float32)   # many ties
    jv, ji = jdrafter.topk_rows(jnp.asarray(x), 7)
    v, i = tdrafter.topk_rows(t(x), 7)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
    lv, li = jax.lax.top_k(jnp.asarray(x[0]), 20)
    v1, i1 = tdrafter.topk_rows(t(x[0]), 20)
    np.testing.assert_array_equal(i1.numpy(), np.asarray(li))
