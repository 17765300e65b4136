"""Static (EAGLE-1 style) trees in the port against the JAX package: the path
helpers of ops/tree.py, StaticTreeSpec, draft_round_static trees, and engines
built with `tree_paths`: tokens equal to the JAX engine's and to the port's
own vanilla decode, for v1 and v3 drafts. CPU, fp32, same numpy inputs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eagle_tpu.engine import drafter as jdrafter
from eagle_tpu.models import draft as jdraft
from eagle_tpu.ops import tree as jtree
from eagle_tpu.ops.kv_cache import init_cache as j_init_cache
from eagle_tpu_torch import convert
from eagle_tpu_torch.engine import drafter as tdrafter
from eagle_tpu_torch.ops import tree as ttree
from eagle_tpu_torch.ops.kv_cache import init_cache

from test_engine_greedy import PROMPT, make_engine, tiny_dcfg
from torch_port_util import np_tree, port_engine, t

PROMPT2 = np.array([77, 3, 3, 120, 9, 64, 31, 2, 100, 45, 6], np.int32)
SMALL = ((0,), (1,), (0, 0), (0, 1), (0, 0, 0))


def test_path_helpers_match_jax():
    assert ttree.MC_SIM_7B_63 == jtree.MC_SIM_7B_63 and ttree.CHAIN_5 == jtree.CHAIN_5
    for paths in (ttree.MC_SIM_7B_63, ttree.CHAIN_5, SMALL, ()):
        a, b = ttree.paths_to_parents(paths), jtree.paths_to_parents(paths)
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype
        assert ttree.max_children(a) == jtree.max_children(b)
    assert ttree.chain_paths(4) == jtree.chain_paths(4)
    with pytest.raises(ValueError, match="prefix"):
        ttree.paths_to_parents(((0, 0), (0,)))


@pytest.mark.parametrize("paths", [ttree.MC_SIM_7B_63, ttree.CHAIN_5, SMALL],
                         ids=["mc_sim_7b_63", "chain_5", "small"])
def test_static_tree_spec_fields_equal(paths):
    a, b = tdrafter.StaticTreeSpec(paths), jdrafter.StaticTreeSpec(paths)
    assert (a.paths, a.num_nodes, a.k, a.max_depth) == (b.paths, b.num_nodes, b.k, b.max_depth)
    for name in ("parents", "depths", "ranks", "kv_slot", "anc"):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name), err_msg=name)
    assert len(a.levels) == len(b.levels)
    for la, lb in zip(a.levels, b.levels):
        np.testing.assert_array_equal(la, lb)
    parents, levels = a.on_device("cpu")
    assert a.on_device("cpu")[0] is parents          # made once per device
    np.testing.assert_array_equal(parents.numpy(), b.parents)
    assert sum(lv[0].shape[0] for lv in levels) == a.num_nodes - 1


@pytest.mark.parametrize("version,draft_vocab", [(1, 0), (3, 0), (3, 64)])
def test_draft_round_static_trees_identical(version, draft_vocab):
    """A prefill-sized extension, then a round-sized one, through both static
    drafters: the trees are identical and the draft caches agree (atol 1e-4,
    fp32 sums in another order)."""
    seed = 7
    jdcfg = tiny_dcfg(version, draft_vocab=draft_vocab)
    jdp = jdraft.init_params(jdcfg, jax.random.PRNGKey(seed))
    if draft_vocab:
        jdp["d2t"] = jnp.arange(draft_vocab, dtype=jnp.int32) % 7
    dcfg, dp = convert.draft_config(jdcfg), convert.draft_params(np_tree(jdp), device="cpu")
    jspec = jdrafter.StaticTreeSpec(ttree.MC_SIM_7B_63)
    spec = tdrafter.StaticTreeSpec(ttree.MC_SIM_7B_63)
    rng = np.random.default_rng(seed)
    lm = (rng.normal(size=(dcfg.hidden_size, 128)) * 0.3).astype(np.float32)
    S = 64 + spec.num_nodes + 7
    jc = j_init_cache(1, 1, jdcfg.num_kv_heads, S, jdcfg.head_dim, dtype=jnp.float32)
    c = init_cache(1, 1, dcfg.num_kv_heads, S, dcfg.head_dim, dtype=torch.float32,
                   device="cpu")
    F = dcfg.fuse_in_dim // 2 if version == 1 else dcfg.fuse_in_dim
    jlm, tlm = (jnp.asarray(lm), t(lm)) if version == 1 else (None, None)
    jround = jax.jit(lambda toks, feats, n, cache: jdrafter.draft_round_static(
        jdp, jdcfg, jspec, toks, feats, n, cache, jlm))   # one shape, one compile
    T = 12
    for n_new in (9, 3):
        toks = rng.integers(0, 128, T)
        feats = rng.normal(size=(T, F)).astype(np.float32)
        jr = jround(jnp.asarray(toks, jnp.int32), jnp.asarray(feats), jnp.int32(n_new), jc)
        r = tdrafter.draft_round_static(dp, dcfg, spec, t(toks), t(feats),
                                        torch.tensor(n_new), c, tlm)
        for name in ("tokens", "parents", "mask", "positions", "children"):
            np.testing.assert_array_equal(getattr(r.tree, name).numpy(),
                                          np.asarray(getattr(jr.tree, name)), err_msg=name)
        assert r.tree.node_probs is None
        n = int(jr.dcache.length[0])
        assert int(r.dcache.length[0]) == n
        np.testing.assert_allclose(r.dcache.k.numpy()[..., :n, :],
                                   np.asarray(jr.dcache.k)[..., :n, :], atol=1e-4)
        jc, c = jr.dcache, r.dcache


@pytest.mark.parametrize("version", [1, 3])
def test_static_engine_tokens_equal_jax_and_vanilla(version):
    je = make_engine(version, tree_paths=ttree.MC_SIM_7B_63)
    pe = port_engine(je)
    assert pe.static_spec is not None and pe.path_len == je.path_len == 7
    assert pe.ecfg.tree_size == je.ecfg.tree_size == 26
    assert pe.init_draft_cache().max_len == je.init_draft_cache().max_len
    for prompt in (PROMPT, PROMPT2):
        jref, jn, jr = je.generate(prompt, max_new_tokens=32, log=True)
        out, n, r = pe.generate(prompt, max_new_tokens=32, log=True)
        np.testing.assert_array_equal(out, jref)
        assert (n, r) == (jn, jr)
        np.testing.assert_array_equal(pe.generate_fused(prompt, max_new_tokens=32), jref)
        np.testing.assert_array_equal(pe.generate_vanilla(prompt, max_new_tokens=32), jref)


@pytest.mark.parametrize("paths,kernels", [(ttree.CHAIN_5, True), (SMALL, False),
                                           (ttree.MC_SIM_7B_63, True)],
                         ids=["chain_5", "small", "mc_sim_7b_63"])
def test_static_port_greedy_equals_port_vanilla(paths, kernels):
    """The port's own invariant, also with the kernel options on (on the CPU
    their wrappers take the plain versions)."""
    je = make_engine(1, seed=2)
    kw = dict(attn_impl="pallas_tree", compact_impl="pallas") if kernels else {}
    pe = port_engine(je, tree_paths=paths, **kw)
    ref = pe.generate_vanilla(PROMPT, max_new_tokens=32)
    np.testing.assert_array_equal(pe.generate(PROMPT, max_new_tokens=32), ref)
    out, n, rounds = pe.generate_fused(PROMPT, max_new_tokens=32, log=True)
    np.testing.assert_array_equal(out, ref)
    assert n / rounds >= 1.0


def test_with_tree_and_siblings():
    je = make_engine(1)
    pe = port_engine(je)
    assert pe.with_tree() is pe and pe.with_sampling(False) is pe
    small = pe.with_tree(total_tokens=7, depth=2)
    assert small.ecfg.total_tokens == 7 and small.ecfg.depth == 2
    assert small.params["embed"]["w"] is pe.params["embed"]["w"]
    assert small.params["layers"][0]["wq"] is pe.params["layers"][0]["wq"]
    assert small.dparams["layers"][0]["wqkv"] is pe.dparams["layers"][0]["wqkv"]
    np.testing.assert_array_equal(small.generate(PROMPT, max_new_tokens=16),
                                  pe.generate(PROMPT, max_new_tokens=16))
    static = pe._sibling(tree_paths=SMALL)
    assert static.params["lm_head"] is pe.params["lm_head"]
    with pytest.raises(ValueError, match="static"):
        static.with_tree(depth=2)
    with pytest.raises(NotImplementedError):
        pe.with_sampling(True)
    # a quantized draft is not quantized again by its sibling
    q = port_engine(je, draft_quant="int8")
    sib = q._sibling(total_tokens=7)
    assert sib.dparams["layers"][0]["wqkv"]["q8"] is q.dparams["layers"][0]["wqkv"]["q8"]


def test_sampled_static_drafting_raises():
    je = make_engine(1)
    pe = port_engine(je, tree_paths=SMALL)
    hot = convert.engine_config(je.ecfg).__class__(temperature=0.9)
    with pytest.raises(NotImplementedError):
        tdrafter.draft_round_static(pe.dparams, pe.dcfg, pe.static_spec,
                                    torch.zeros(4, dtype=torch.long), torch.zeros(4, 32),
                                    torch.tensor(2), pe.init_draft_cache(), pe._lm_head_w,
                                    ecfg=hot)
