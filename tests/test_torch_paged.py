"""The port's paged server (eagle_tpu_torch/engine/paged.py) and page pool
(ops/paged_kv.py) on the CPU: the cases of tests/test_paged_server.py and
the paged cases of tests/test_async_server.py but chunked prefill's
(tests/test_torch_chunked_prefill.py), each request held bit for bit to the port's
own greedy decode (itself held to the JAX engine); the page gather and
scatters against the JAX functions on the same pool, exactly; and one case
against the JAX package's PagedEagleServer. Card tests (`cuda`): a paged
served round waits on the host zero times, and an int4 paged server's
requests equal their generate_vanilla in fp32."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from eagle_tpu.engine.paged import PagedEagleServer as JaxPaged
from eagle_tpu.ops import paged_kv as jpk
from eagle_tpu_torch.engine.paged import PagedEagleServer
from eagle_tpu_torch.engine.server import EagleServer
from eagle_tpu_torch.ops import paged_kv as pk

from torch_port_util import engine_pair, greedy_ref

PROMPTS = [np.array([5, 17, 92, 3]), np.array([7, 1]), np.array([44, 8, 21, 9]),
           np.array([2, 9, 6])]
BUDGETS = [18, 25, 11, 21]


def _check(eng, outs, rids, prompts, budgets):
    for rid, p, b in zip(rids, prompts, budgets):
        np.testing.assert_array_equal(outs[rid], greedy_ref(eng, p, b, longest=b))


# ---------------------------------------------------------------------------
# the page pool against the JAX functions
# ---------------------------------------------------------------------------

def _pools(kv_quant, dtype, L=2, n_kv=2, d=8, pages=9, P=4, seed=0):
    r = np.random.default_rng(seed)
    shape = (L, pages * P, n_kv, d)
    if kv_quant == "int8":
        arrs = [r.integers(-127, 128, shape).astype(np.int8) for _ in range(2)]
        arrs += [r.random(shape[:-1]).astype(np.float32) for _ in range(2)]
    else:
        arrs = [r.standard_normal(shape).astype(np.float32) for _ in range(2)]
    tp = pk.PagePool(*(torch.from_numpy(a) if a.dtype != np.float32 or i >= 2
                       else torch.from_numpy(a).to(dtype) for i, a in enumerate(arrs)))
    jdt = {torch.bfloat16: jnp.bfloat16, torch.float32: jnp.float32}[dtype]
    jp = jpk.PagePool(*(jnp.asarray(a) if a.dtype != np.float32 or i >= 2
                        else jnp.asarray(a).astype(jdt) for i, a in enumerate(arrs)))
    return tp, jp


def _same(t, j):
    if t is None:
        assert j is None
        return
    np.testing.assert_array_equal(t.float().numpy(), np.asarray(j, np.float32))


@pytest.mark.parametrize("kv_quant,dtype", [("none", torch.bfloat16), ("none", torch.float32),
                                            ("int8", torch.float32)])
def test_page_ops_match_jax(kv_quant, dtype):
    """gather_windows, scatter_rows (one slot inactive, routed to the trash
    page) and scatter_prefix leave the same pool and windows as the JAX
    functions, bit for bit; bf16 payloads and int8 payloads with their
    scales."""
    P, W = 4, 10
    tp, jp = _pools(kv_quant, dtype)
    bt = np.array([[3, 1, 7, 0, 0], [2, 5, 4, 8, 0], [6, 0, 0, 0, 0]], np.int64)
    got = pk.gather_windows(tp, torch.from_numpy(bt), W, P)
    ref = jpk.gather_windows(jp, jnp.asarray(bt, jnp.int32), W, P)
    for t, j in zip(got, ref):       # JAX: [B, L, 1, n_kv, W(, d)]
        _same(t, None if j is None else jnp.moveaxis(j[:, :, 0], 0, 1))
    # a round's writes: new values in each window, then rows [start, start + 3)
    r = np.random.default_rng(1)
    noise = lambda w: torch.from_numpy(r.standard_normal(w.shape).astype(np.float32))
    wins = [None if w is None else w.float() + noise(w) for w in got]
    wins = [None if w is None else (w.round().clamp(-127, 127) if t.dtype == torch.int8
                                    else w).to(t.dtype) for w, t in zip(wins, got)]
    starts = np.array([5, 7, 2])
    active = np.array([True, True, False])
    pk.scatter_rows(tp, torch.from_numpy(bt), wins[0], wins[1], torch.from_numpy(starts),
                    3, P, torch.from_numpy(active), wins[2], wins[3])
    jw = [None if w is None else jnp.moveaxis(jnp.asarray(w.float().numpy()).astype(
        jp.k.dtype if i < 2 else jnp.float32), 1, 0)[:, :, None] for i, w in enumerate(wins)]
    jp = jpk.scatter_rows(jp, jnp.asarray(bt, jnp.int32), jw[0], jw[1],
                          jnp.asarray(starts, jnp.int32), 3, P, jnp.asarray(active),
                          jw[2], jw[3])
    for t, j in zip(tp, jp):
        _same(t, j)
    # a prefill of 8 rows (2 pages) into pages 6 and 1
    pages = np.array([6, 1])
    cache = [None if w is None else w[:, :1, :, :8].contiguous() for w in wins]
    pk.scatter_prefix(tp, torch.from_numpy(pages), cache[0], cache[1], P, cache[2], cache[3])
    jc = [None if c is None else jnp.asarray(c.float().numpy()).astype(
        jp.k.dtype if i < 2 else jnp.float32) for i, c in enumerate(cache)]
    jp = jpk.scatter_prefix(jp, jnp.asarray(pages, jnp.int32), jc[0], jc[1], P, jc[2], jc[3])
    for t, j in zip(tp, jp):
        _same(t, j)


# ---------------------------------------------------------------------------
# the paged server
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("depth", [0, 1])
def test_paged_staggered_bit_exact(depth):
    """Mixed lengths and staggered joins through a paged pool, sync and
    async: every request equals its greedy decode, no preemption."""
    _, eng = engine_pair(1)
    srv = PagedEagleServer(eng, max_batch=2, page_size=16, async_schedule=depth)
    r0 = srv.submit(PROMPTS[0], BUDGETS[0])
    r1 = srv.submit(PROMPTS[1], BUDGETS[1])
    srv.step()
    srv.step()
    r2 = srv.submit(PROMPTS[2], BUDGETS[2])
    srv.step()
    r3 = srv.submit(PROMPTS[3], BUDGETS[3])
    outs = srv.run()
    _check(eng, outs, [r0, r1, r2, r3], PROMPTS, BUDGETS)
    assert srv.preemptions == 0


def test_paged_matches_jax_paged_server():
    """The staggered run of 4 requests through 2 paged slots gives the JAX
    package's PagedEagleServer's tokens."""
    jeng, eng = engine_pair(1)
    srv = PagedEagleServer(eng, max_batch=2, page_size=16)
    jsrv = JaxPaged(jeng, max_batch=2, page_size=16)
    rids = [srv.submit(p, b) for p, b in zip(PROMPTS, BUDGETS)]
    jrids = [jsrv.submit(p.astype(np.int32), b) for p, b in zip(PROMPTS, BUDGETS)]
    outs, jouts = srv.run(), jsrv.run()
    for r, jr in zip(rids, jrids):
        np.testing.assert_array_equal(outs[r], jouts[jr])


def test_paged_matches_dense_server_under_buckets():
    """Paged vs dense server over one engine with kv_buckets: the same
    tokens; page growth crosses several page edges."""
    _, eng0 = engine_pair(3)
    eng = eng0._sibling(kv_buckets=(64, 128))
    budgets = [30, 24, 36, 20]
    dense = EagleServer(eng, max_batch=2)
    rids = [dense.submit(p, b) for p, b in zip(PROMPTS, budgets)]
    ref = dense.run()
    paged = PagedEagleServer(eng, max_batch=2, page_size=16)
    rids_p = [paged.submit(p, b) for p, b in zip(PROMPTS, budgets)]
    got = paged.run()
    for rd, rp in zip(rids, rids_p):
        np.testing.assert_array_equal(got[rp], ref[rd])


def test_paged_pool_smaller_than_dense_capacity():
    """A pool far smaller than batch x max_len serves every request
    (queuing on pages): 20 usable pages, 8 per prompt bucket."""
    _, eng = engine_pair(1)
    budgets = [14, 19, 9, 16]
    srv = PagedEagleServer(eng, max_batch=4, page_size=16, num_pages=21)
    probe = PagedEagleServer(eng, max_batch=4, page_size=16)
    assert srv.pool_bytes < probe.pool_bytes // 2
    rids = [srv.submit(p, b) for p, b in zip(PROMPTS, budgets)]
    _check(eng, srv.run(), rids, PROMPTS, budgets)


@pytest.mark.parametrize("depth", [0, 1])
def test_paged_preemption_resume_bit_exact(depth):
    """A tiny pool and two long generations force growth-driven preemption
    (async: with a round in flight, whose stale result is dropped); the
    resumed request's output is unchanged."""
    _, eng = engine_pair(1)
    srv = PagedEagleServer(eng, max_batch=2, page_size=16, num_pages=17,
                           async_schedule=depth)
    rids = [srv.submit(p, 140) for p in PROMPTS[:2]]
    outs = srv.run()
    assert srv.preemptions >= 1
    _check(eng, outs, rids, PROMPTS[:2], [140, 140])


def test_paged_pool_too_small_rejects_at_submit():
    _, eng = engine_pair(1)
    srv = PagedEagleServer(eng, max_batch=1, page_size=16, num_pages=2)
    with pytest.raises(ValueError, match="pages"):
        srv.submit(PROMPTS[0], 40)
    srv2 = PagedEagleServer(eng, max_batch=1, page_size=16, num_pages=17)
    rid = srv2.submit(PROMPTS[0], 40)
    _check(eng, srv2.run(), [rid], PROMPTS[:1], [40])


def test_preemption_preserves_arrival_order():
    """A preempted-and-resumed request keeps its first admit_seq."""
    _, eng = engine_pair(1)
    srv = PagedEagleServer(eng, max_batch=2, page_size=16, num_pages=17)
    ra = srv.submit(PROMPTS[0], 140)
    rb = srv.submit(PROMPTS[1], 140)
    srv.step()
    by_rid = {s.request_id: s for grp in srv.slots for s in grp if s.active}
    assert set(by_rid) == {ra, rb}
    seq_b = by_rid[rb].admit_seq
    assert by_rid[ra].admit_seq < seq_b
    ga, ia = next((g, i) for g in range(srv.G)
                  for i, s in enumerate(srv.slots[g]) if s.request_id == ra)
    assert srv._preempt_one(protect=(ga, ia))
    assert srv.queue[0].request_id == rb and srv.queue[0].admit_seq == seq_b
    srv.step()
    by_rid = {s.request_id: s for grp in srv.slots for s in grp if s.active}
    assert by_rid[rb].admit_seq == seq_b
    _check(eng, srv.run(), [ra, rb], PROMPTS[:2], [140, 140])


def test_page_size_and_chunk_checks():
    _, eng = engine_pair(1)
    with pytest.raises(ValueError, match="page_size"):
        PagedEagleServer(eng, max_batch=2, page_size=24)    # 128 % 24 != 0
    with pytest.raises(ValueError, match="prefill_chunk"):
        PagedEagleServer(eng, max_batch=1, page_size=16, prefill_chunk=24)


def test_paged_int4_target_matches_singles():
    """Paged serving over a stacked int4 target: each request equals the
    same engine's greedy decode."""
    from eagle_tpu_torch.ops.quant4 import quantize_target_params4
    from eagle_tpu_torch.engine.engine import EagleEngine

    _, eng0 = engine_pair(3)
    eng = EagleEngine(quantize_target_params4(eng0.params), eng0.cfg, eng0.dparams,
                      eng0.dcfg, eng0.ecfg, device="cpu")
    srv = PagedEagleServer(eng, max_batch=2, page_size=16)
    rids = [srv.submit(p, b) for p, b in zip(PROMPTS[:2], [18, 14])]
    _check(eng, srv.run(), rids, PROMPTS[:2], [18, 14])


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

def _card_engine(int4=False):
    from eagle_tpu_torch.config import DraftConfig, EngineConfig, ModelConfig
    from eagle_tpu_torch.engine.engine import EagleEngine
    from eagle_tpu_torch.models import draft as draft_mod
    from eagle_tpu_torch.models import transformer
    from eagle_tpu_torch.ops.quant4 import quantize_target_params4

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (sm_90a) and nvcc")
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = ModelConfig(vocab_size=1024, hidden_size=512, intermediate_size=1024,
                      num_layers=4, num_q_heads=8, num_kv_heads=2, head_dim=128,
                      dtype=torch.float32, attn_impl="pallas_tree")
    dcfg = DraftConfig(version=3, hidden_size=512, intermediate_size=1024, num_q_heads=8,
                       num_kv_heads=2, head_dim=128, vocab_size=1024, draft_vocab_size=512,
                       target_hidden_size=512, dtype=torch.float32)
    ecfg = EngineConfig(total_tokens=60, depth=5, top_k=10, max_len=512,
                        compact_impl="pallas")
    params = transformer.init_params(cfg, seed=10, device="cuda")
    if int4:
        params = quantize_target_params4(params)
        ecfg = EngineConfig(total_tokens=60, depth=5, top_k=10, max_len=512,
                            compact_impl="pallas", draft_quant="int4", fuse_scoring=True)
    return EagleEngine(params, cfg, draft_mod.init_params(dcfg, seed=11, device="cuda"),
                       dcfg, ecfg, device="cuda")


@pytest.mark.cuda
def test_paged_round_never_waits_on_the_host():
    """gather -> round -> scatter of a served paged round waits on the host
    zero times (torch's sync debug mode "error")."""
    eng = _card_engine()
    srv = PagedEagleServer(eng, max_batch=2, page_size=16)
    for n in (40, 130):
        srv.submit(np.random.default_rng(n).integers(0, 1024, n), 64)
    srv.step()
    srv.step()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(2):
            srv._dispatch_round(0)
    finally:
        torch.cuda.set_sync_debug_mode("default")


@pytest.mark.cuda
def test_paged_int4_server_equals_vanilla_on_the_card():
    """fp32 int4 target + int4 draft + fused scoring behind the paged server
    with chunked prefill and a pool that forces a preemption: every request
    equals its generate_vanilla (the row-exact tree kernel carries prefill,
    chunks, verify and the vanilla step alike)."""
    eng = _card_engine(int4=True)
    r = np.random.default_rng(4)
    prompts = [r.integers(0, 1024, n) for n in (5, 40, 130)]
    budgets = [140, 100, 64]
    srv = PagedEagleServer(eng, max_batch=2, page_size=16, prefill_chunk=64,
                           num_pages=17, async_schedule=1)
    rids = [srv.submit(p, b) for p, b in zip(prompts, budgets)]
    outs = srv.run()
    assert srv.preemptions >= 1
    for rid, p, b in zip(rids, prompts, budgets):
        np.testing.assert_array_equal(outs[rid], eng.generate_vanilla(p, max_new_tokens=b))
