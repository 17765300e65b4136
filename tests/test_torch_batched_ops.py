"""The batched pieces of the port's round against the JAX package's
functions under `jax.vmap` (the JAX engine's batched rounds vmap its
one-sequence functions), CPU, fp32:

- tree-verify attention (B1's plain version) over a batch with a start per
  row, against vmap of the interpreted Pallas kernel and of
  tree_attention_xla; and at head_dim > 256 (the wide route's widths);
- the KV cache writes and the accepted-branch compaction for all rows at once;
- the greedy acceptance walk over a batch of trees;
- the batched drafters (dynamic, static, sampled) against one-sequence calls
  row by row, each row drawing its own noise in the one-sequence shapes.
Tolerances: attention rtol = atol = 2e-5 (the order of f32 sums, as
tests/test_torch_attn_kernels.py); a sampled tree's node_probs rtol = 1e-6,
atol = 1e-9 (a batch's head matmul has B rows where one sequence's root has
one, and the CPU's f32 GEMM sums a one-row product in another order: one or
two ulp); everything else exact."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eagle_tpu.engine import accept as jaccept
from eagle_tpu.ops import kv_cache as jkv
from eagle_tpu.ops import pallas_attn
from eagle_tpu.ops import tree as jtree
from eagle_tpu_torch import convert
from eagle_tpu_torch.engine import accept as taccept
from eagle_tpu_torch.engine import drafter as tdrafter
from eagle_tpu_torch.ops import attn_kernels as ak
from eagle_tpu_torch.ops import kv_cache as tkv
from eagle_tpu_torch.ops import tree as ttree
from eagle_tpu_torch.ops.tree import MC_SIM_7B_63

from test_engine_greedy import make_engine
from test_torch_attn_kernels import TOL, _inputs
from torch_port_util import np_tree, t


def _batch(B, T, nq, nkv, d, S, seed):
    rows = [_inputs(T, T, nq, nkv, d, S, seed=seed + b) for b in range(B)]
    return [np.stack([r[i] for r in rows]) for i in range(6)]


@pytest.mark.parametrize("starts", [(0, 37, 100, 127), (128, 5, 64, 0)])
def test_batched_tree_attention_matches_vmapped_jax_kernel(starts):
    """B = 4 rows, each at its own start (a prefix chunk live for one row is
    empty for another), against jax.vmap of the interpreted kernel."""
    args = _batch(4, 13, 8, 2, 32, 128, seed=sum(starts))
    st = np.asarray(starts, np.int32)
    jargs = [jnp.asarray(a) for a in args]
    want = np.asarray(jax.vmap(pallas_attn.tree_attention_xla)(*jargs, jnp.asarray(st)))
    pallas = np.asarray(jax.vmap(lambda *a: pallas_attn.tree_attention(
        *a, blk=64, interpret=True))(*jargs, jnp.asarray(st)))
    targs = [t(a) for a in args]
    got = ak.tree_attention(*targs, torch.from_numpy(st))       # CPU → plain
    assert got.shape == (4, 13, 8 * 32)
    for ref in (want, pallas):
        np.testing.assert_allclose(got.numpy(), ref, **TOL)
    for b in range(4):   # row b of the batch is the one-sequence call
        one = ak.tree_attention_ref(*(a[b] for a in targs), torch.tensor(starts[b]))
        np.testing.assert_array_equal(got[b].numpy(), one.numpy())
    # a row-sliced view of the batch's cache (kv_buckets) reads the same rows
    view = ak.tree_attention_ref(targs[0], targs[1][:, :, :100], targs[2][:, :, :100],
                                 *targs[3:], torch.tensor([min(s, 100) for s in starts]))
    np.testing.assert_allclose(view.numpy(), np.asarray(jax.vmap(
        pallas_attn.tree_attention_xla)(*jargs[:1], jargs[1][:, :, :100],
                                        jargs[2][:, :, :100], *jargs[3:],
                                        jnp.minimum(jnp.asarray(st), 100))), **TOL)


@pytest.mark.parametrize("d,start", [(320, 0), (320, 200), (512, 77), (512, 256)])
def test_wide_head_matches_jax_kernel(d, start):
    """head_dim 320 and 512 (C3c: past the tiled kernels' 256): the plain
    version, which the wide route is held to on the card, gives the
    interpreted Pallas kernel's output and tree_attention_xla's; the plan
    names the wide route."""
    args = _inputs(13, 13, 8, 2, d, 256, seed=d + start)
    st = jnp.int32(start)
    jargs = [jnp.asarray(a) for a in args]
    want = np.asarray(pallas_attn.tree_attention_xla(*jargs, st))
    pallas = np.asarray(pallas_attn.tree_attention(*jargs, st, blk=64, interpret=True))
    got = ak.tree_attention(*[t(a) for a in args], torch.tensor(start))
    for ref in (want, pallas):
        np.testing.assert_allclose(got.numpy(), ref, **TOL)
    assert ak.tree_plan(13, 8, 2, 256, d)["route"] == "wide"


def test_batched_cache_writes_and_compaction_match_vmapped_jax():
    """update_layer (float and int8) writes each row's T rows at its own
    offset, clamped as dynamic_update_slice clamps; compact_accepted moves
    every row's accepted branch at once."""
    rng = np.random.default_rng(3)
    L, B, H, S, d, T = 2, 3, 2, 40, 8, 6
    starts = np.array([0, 17, 37], np.int64)          # 37 + 6 > 40: clamped
    kn = rng.normal(size=(B, T, H, d)).astype(np.float32)
    vn = rng.normal(size=(B, T, H, d)).astype(np.float32)
    for quant in ("none", "int8"):
        c = tkv.init_cache(L, B, H, S, d, dtype=torch.float32, device="cpu",
                           kv_quant=quant)
        j = jkv.init_cache(L, 1, H, S, d, dtype=jnp.float32, kv_quant=quant)
        if quant == "none":
            tkv.update_layer(c.k[1], c.v[1], t(kn), t(vn), torch.from_numpy(starts))
            jk, jv = jax.vmap(lambda k_, v_, s: jkv.update_layer(
                j.k[1], j.v[1], k_[None], v_[None], s[None]))(
                jnp.asarray(kn), jnp.asarray(vn), jnp.asarray(starts, jnp.int32))
            got, want = (c.k[1], c.v[1]), (jk[:, 0], jv[:, 0])
        else:
            tkv.update_layer_q(c.k[1], c.v[1], c.ks[1], c.vs[1], t(kn), t(vn),
                               torch.from_numpy(starts))
            out = jax.vmap(lambda k_, v_, s: jkv.update_layer_q(
                j.k[1], j.v[1], j.ks[1], j.vs[1], k_[None], v_[None], s[None]))(
                jnp.asarray(kn), jnp.asarray(vn), jnp.asarray(starts, jnp.int32))
            got, want = (c.k[1], c.v[1], c.ks[1], c.vs[1]), [o[:, 0] for o in out]
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    k = rng.normal(size=(L, B, H, S, d)).astype(np.float32)
    v = rng.normal(size=(L, B, H, S, d)).astype(np.float32)
    paths = np.array([[0, 3, 7, 7], [0, 1, 2, 5], [0, 0, 0, 0]], np.int64)
    alens = np.array([2, 3, 0], np.int64)
    lens = np.array([20, 0, 33], np.int64)
    pc = tkv.compact_accepted(tkv.KVCache(k=t(k), v=t(v), length=torch.from_numpy(lens)),
                              torch.from_numpy(paths), torch.from_numpy(alens))
    jc = jax.vmap(lambda k_, v_, n, p, a: jkv.compact_accepted(
        jkv.KVCache(k=k_[:, None], v=v_[:, None], length=n[None]), p[None], a[None]))(
        jnp.asarray(k).swapaxes(0, 1), jnp.asarray(v).swapaxes(0, 1),
        jnp.asarray(lens, jnp.int32), jnp.asarray(paths, jnp.int32),
        jnp.asarray(alens, jnp.int32))
    np.testing.assert_array_equal(pc.k.numpy(), np.asarray(jc.k[:, :, 0]).swapaxes(0, 1))
    np.testing.assert_array_equal(pc.v.numpy(), np.asarray(jc.v[:, :, 0]).swapaxes(0, 1))
    np.testing.assert_array_equal(pc.length.numpy(), lens + alens)


@pytest.mark.parametrize("forced", [False, True])
def test_batched_greedy_walk_matches_vmapped_jax(forced):
    rng = np.random.default_rng(5 + forced)
    B, N, V, k, P = 3, 31, 40, 4, 7
    parents = np.stack([np.array([0] + [rng.integers(0, i) for i in range(1, N)])
                        for _ in range(B)])
    tokens = rng.integers(0, V, (B, N))
    logits = rng.normal(size=(B, N, V)).astype(np.float32)
    for b in range(B):
        for i in range(1, N):   # roughly half the nodes are their parent's argmax
            if rng.random() < 0.5:
                logits[b, parents[b, i], tokens[b, i]] = 10.0 + rng.random()
    ref = rng.integers(0, V, (B, P)) if forced else None
    jt = jax.vmap(lambda tk, pa: jtree.build_tree(tk, pa, k, max_depth=N))(
        jnp.asarray(tokens, jnp.int32), jnp.asarray(parents, jnp.int32))
    ja = jax.vmap(lambda tr, lg, r: jaccept.accept_greedy(tr, lg, P, ref_next=r),
                  in_axes=(0, 0, None if ref is None else 0))(
        jt, jnp.asarray(logits), None if ref is None else jnp.asarray(ref, jnp.int32))
    tt = ttree.build_tree(t(tokens), t(parents), k, max_depth=N)
    for field in ("mask", "positions", "children"):
        np.testing.assert_array_equal(getattr(tt, field).numpy(),
                                      np.asarray(getattr(jt, field)), err_msg=field)
    ta = taccept.accept_greedy(tt, t(logits), P, ref_next=None if ref is None else t(ref))
    np.testing.assert_array_equal(ta.path.numpy(), np.asarray(ja.path))
    np.testing.assert_array_equal(ta.accept_len.numpy(), np.asarray(ja.accept_len))
    np.testing.assert_array_equal(ta.live_match.numpy(), np.asarray(ja.live_match))
    np.testing.assert_allclose(ta.sample_p.numpy(), np.asarray(ja.sample_p),
                               rtol=1e-6, atol=1e-7)


def _draft_setup(version, **ecfg_kw):
    je = make_engine(version, **ecfg_kw)
    dp = convert.draft_params(np_tree(je.dparams), device="cpu")
    return dp, convert.draft_config(je.dcfg), convert.engine_config(je.ecfg)


def _noise_streams(B, seed):
    """One numpy stream per row: noise(shape) of a one-sequence call draws
    the next `shape` uniforms of its row's stream."""
    rngs = [np.random.default_rng(seed + b) for b in range(B)]
    single = [lambda shape, r=r: torch.from_numpy(
        r.uniform(1e-20, 1.0, shape).astype(np.float32)) for r in rngs]
    return single


@pytest.mark.parametrize("kind", ["dynamic", "static", "dynamic-sampled", "static-sampled"])
def test_batched_drafters_equal_row_by_row_calls(kind):
    """One batched draft round (one forward a step, B x top_k rows a scoring
    call) gives each row's one-sequence tree and draft cache, with each
    row's noise drawn in the one-sequence order and shapes."""
    sampled = kind.endswith("sampled")
    static = kind.startswith("static")
    kw = dict(temperature=0.8, acceptance="true_q_dynamic") if sampled else {}
    if static:
        kw["tree_paths"] = MC_SIM_7B_63
    dp, dcfg, ecfg = _draft_setup(3, **kw)
    spec = tdrafter.StaticTreeSpec(MC_SIM_7B_63) if static else None
    B, T, S = 3, 9, 160
    rng = np.random.default_rng(11)
    toks = t(rng.integers(0, 128, (B, T)))
    feats = t(rng.normal(size=(B, T, 3 * dcfg.hidden_size)).astype(np.float32))
    n_new = torch.tensor([9, 4, 1])
    temps = torch.tensor([0.7, 1.0, 1.4]) if sampled else None

    def run(tk, ft, n, cache, noise, temp):
        if static:
            return tdrafter.draft_round_static(dp, dcfg, spec, tk, ft, n, cache, ecfg=ecfg,
                                               noise=noise, temperature=temp)
        return tdrafter.draft_round(dp, dcfg, ecfg, tk, ft, n, cache, noise=noise,
                                    temperature=temp)

    cache = tkv.init_cache(1, B, dcfg.num_kv_heads, S, dcfg.head_dim,
                           dtype=torch.float32, device="cpu")
    cache = cache._replace(length=torch.tensor([5, 0, 17]))
    rows = _noise_streams(B, 40)
    noise = (lambda shape: torch.stack([rows[b](shape[1:]) for b in range(B)])) \
        if sampled else None
    got = run(toks, feats, n_new, cache, noise, temps)
    singles = _noise_streams(B, 40)
    for b in range(B):
        c1 = tkv.init_cache(1, 1, dcfg.num_kv_heads, S, dcfg.head_dim,
                            dtype=torch.float32, device="cpu")
        c1 = c1._replace(length=cache.length[b:b + 1].clone())
        one = run(toks[b], feats[b], n_new[b], c1, singles[b] if sampled else None,
                  None if temps is None else temps[b])
        for name, g, w in zip(ttree.Tree._fields, got.tree, one.tree):
            if name == "node_probs" and w is not None:
                np.testing.assert_allclose(g[b].numpy(), w.numpy(), rtol=1e-6, atol=1e-9)
            elif w is not None:
                np.testing.assert_array_equal(g[b].numpy(), w.numpy(), err_msg=name)
        assert int(got.dcache.length[b]) == int(one.dcache.length[0])
        n = int(one.dcache.length[0])
        np.testing.assert_array_equal(got.dcache.k[:, b, :, :n].numpy(),
                                      one.dcache.k[:, 0, :, :n].numpy())
