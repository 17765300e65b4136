"""The port's continuous-batching server (eagle_tpu_torch/engine/server.py)
on the CPU: the cases of tests/test_server.py, the dense cases of
tests/test_async_server.py and test_temperature.py's mixed-temperature
server, each request held bit for bit to the port's own `generate` /
`generate_vanilla` (themselves held to the JAX engine), and one case against
the JAX package's EagleServer. Sampled requests: top_k = 1 engines emit the
greedy tokens, sync and async scheduling give the same tokens for the same
seeds, and a served request equals its one-sequence `generate` with its
seed."""

import numpy as np
import pytest

from eagle_tpu.engine.server import EagleServer as JaxServer
from eagle_tpu_torch.engine.server import EagleServer
from eagle_tpu_torch.ops.tree import CHAIN_5

from torch_port_util import engine_pair, greedy_ref

PROMPTS = [np.array([5, 17, 92, 3]), np.array([7, 1]), np.array([44, 8, 21, 9]),
           np.array([2, 9, 6])]
BUDGETS = [18, 25, 11, 21]


def _staggered(srv):
    """4 requests through the server's slots, two joining mid-flight."""
    r0 = srv.submit(PROMPTS[0], BUDGETS[0])
    r1 = srv.submit(PROMPTS[1], BUDGETS[1])
    srv.step()
    srv.step()
    r2 = srv.submit(PROMPTS[2], BUDGETS[2])
    srv.step()
    r3 = srv.submit(PROMPTS[3], BUDGETS[3])
    outs = srv.run()
    assert set(outs) == {r0, r1, r2, r3}
    return [outs[r] for r in (r0, r1, r2, r3)]


@pytest.mark.parametrize("depth", [0, 1, 4])
def test_server_staggered_admission_bit_exact(depth):
    """Staggered joins through 2 slots, sync and async (a refill after a
    finish runs up to `depth` rounds whose results are dropped): every
    request equals its one-sequence generate."""
    _, eng = engine_pair(1)
    outs = _staggered(EagleServer(eng, max_batch=2, async_schedule=depth))
    for out, p, b in zip(outs, PROMPTS, BUDGETS):
        np.testing.assert_array_equal(out, greedy_ref(eng, p, b))


def test_server_matches_jax_server():
    """The same staggered run through the JAX package's EagleServer gives
    the same tokens."""
    jeng, eng = engine_pair(1)
    ours = _staggered(EagleServer(eng, max_batch=2))
    jsrv = JaxServer(jeng, max_batch=2)
    r0 = jsrv.submit(PROMPTS[0].astype(np.int32), BUDGETS[0])
    r1 = jsrv.submit(PROMPTS[1].astype(np.int32), BUDGETS[1])
    jsrv.step()
    jsrv.step()
    r2 = jsrv.submit(PROMPTS[2].astype(np.int32), BUDGETS[2])
    jsrv.step()
    r3 = jsrv.submit(PROMPTS[3].astype(np.int32), BUDGETS[3])
    theirs = jsrv.run()
    for out, r in zip(ours, (r0, r1, r2, r3)):
        np.testing.assert_array_equal(out, theirs[r])


@pytest.mark.parametrize("depth", [0, 1])
def test_server_eos_and_streaming(depth):
    """EOS finishes a request, and the union of the per-step emissions is
    its completion (async: one step later, nothing lost or doubled)."""
    _, eng0 = engine_pair(1)
    p = PROMPTS[0]
    ref = eng0.generate_vanilla(p, max_new_tokens=30)
    eos = int(ref[len(p) + 8])
    eng = eng0._sibling()
    eng.eos_token_id = eos
    srv = EagleServer(eng, max_batch=2, async_schedule=depth)
    rid = srv.submit(p, 30)
    streamed = []
    for _ in range(200):
        got = srv.step()
        streamed.extend(got.get(rid, ()))
        if rid in srv.finished and srv._idle():
            break
    exp = eng0.generate_vanilla(p, max_new_tokens=30, eos_token_id=eos)
    np.testing.assert_array_equal(srv.finished[rid], exp)
    np.testing.assert_array_equal(np.asarray(streamed), srv.finished[rid][len(p):])
    assert srv.finish_reasons[rid] == "eos"


def test_server_with_kv_buckets_bit_exact():
    _, eng0 = engine_pair(1)
    eng = eng0._sibling(kv_buckets=(64, 128))
    srv = EagleServer(eng, max_batch=2)
    rids = [srv.submit(p, 22) for p in PROMPTS[:2]]
    outs = srv.run()
    for rid, p in zip(rids, PROMPTS[:2]):
        np.testing.assert_array_equal(outs[rid], greedy_ref(eng0, p, 22))
    assert set(srv.finish_reasons.values()) == {"length"}


def test_server_grouped_buckets_bit_exact():
    """groups=2 with mixed lengths: the long request lands in a group of its
    own, the short group keeps a smaller bucket, outputs stay exact."""
    _, eng0 = engine_pair(1)
    rng = np.random.default_rng(0)
    short = [np.array([5, 17, 92]), np.array([7, 1])]
    long = [rng.integers(0, 128, size=(150,))]
    eng = eng0._sibling(kv_buckets=(64, 128))
    srv = EagleServer(eng, max_batch=4, groups=2)
    rids = [srv.submit(p, 14) for p in short + long]
    srv.step()
    by_group = [{s.request_id for s in grp if s.active} for grp in srv.slots]
    g_long = next(g for g, ids in enumerate(by_group) if rids[2] in ids)
    g_short = next(g for g, ids in enumerate(by_group) if rids[0] in ids)
    assert g_long != g_short
    assert srv._group_bucket(g_short) < srv._group_bucket(g_long)
    outs = srv.run()
    for rid, p in zip(rids, short + long):
        np.testing.assert_array_equal(outs[rid], greedy_ref(eng0, p, 14))


def test_async_matches_sync_with_buckets_and_groups():
    """Async (depth 2) vs sync under kv_buckets and 2 groups: the same
    tokens; the async bucket margin changes only bucket sizes."""
    _, eng0 = engine_pair(3)
    eng = eng0._sibling(kv_buckets=(64, 128))
    budgets = [30, 24, 36, 20]
    outs = []
    for depth in (0, 2):
        srv = EagleServer(eng, max_batch=4, groups=2, async_schedule=depth)
        rids = [srv.submit(p, b) for p, b in zip(PROMPTS, budgets)]
        got = srv.run()
        outs.append([got[r] for r in rids])
    for a, b, p, n in zip(*outs, PROMPTS, budgets):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, greedy_ref(eng0, p, n))


def test_server_admission_pacing():
    """max_admit_per_step caps the prefills of a step; the rest wait."""
    _, eng = engine_pair(1)
    prompts = [np.array([i + 1, 9, 3]) for i in range(4)]
    srv = EagleServer(eng, max_batch=4, max_admit_per_step=1)
    rids = [srv.submit(p, 10) for p in prompts]
    srv.step()
    assert sum(s.active for grp in srv.slots for s in grp) == 1
    assert len(srv.queue) == 3
    srv.step()
    assert sum(s.active for grp in srv.slots for s in grp) == 2
    outs = srv.run()
    for rid, p in zip(rids, prompts):
        np.testing.assert_array_equal(outs[rid], greedy_ref(eng, p, 10))


def test_server_rejects_temperature_on_greedy_engine():
    _, eng = engine_pair(1)
    with pytest.raises(ValueError, match="sampled-mode"):
        EagleServer(eng, max_batch=2).submit(np.array([5, 17, 92]), 8, temperature=0.7)


def test_server_rejects_prompt_without_room():
    _, eng = engine_pair(1)
    with pytest.raises(ValueError, match="max_len"):
        EagleServer(eng, max_batch=2).submit(np.arange(250) % 100, 8)


def test_server_cancel():
    """A cancelled queued or running request frees its slot and never
    finishes; the others are unaffected."""
    _, eng = engine_pair(1)
    srv = EagleServer(eng, max_batch=1)
    r0 = srv.submit(PROMPTS[0], 20)
    r1 = srv.submit(PROMPTS[1], 20)
    r2 = srv.submit(PROMPTS[2], 12)
    srv.step()
    assert srv.cancel(r1) and srv.cancel(r0)
    assert not srv.cancel(r0) and not srv.cancel(99)
    outs = srv.run()
    assert set(outs) == {r2}
    np.testing.assert_array_equal(outs[r2], greedy_ref(eng, PROMPTS[2], 12))


def test_server_serving_tree_bit_exact():
    """A smaller serving tree changes throughput only: outputs equal
    generate_vanilla."""
    _, eng0 = engine_pair(1)
    srv = EagleServer(eng0, max_batch=2, total_tokens=7, depth=2, top_k=3)
    assert srv.engine is not eng0 and srv.engine.ecfg.tree_size == 8
    assert srv.engine.params is eng0.params
    rids = [srv.submit(p, 16) for p in PROMPTS[:3]]
    outs = srv.run()
    for rid, p in zip(rids, PROMPTS[:3]):
        np.testing.assert_array_equal(outs[rid], eng0.generate_vanilla(p, max_new_tokens=16))


def test_server_auto_calibrated_tree():
    """total_tokens=-1 calibrates the tree at the serving batch."""
    _, eng0 = engine_pair(1)
    p = PROMPTS[0]
    srv = EagleServer(eng0, max_batch=2, total_tokens=-1)
    assert srv.engine.ecfg.total_tokens in (40, 48, 50, 56, 60)
    rid = srv.submit(p, 12)
    np.testing.assert_array_equal(srv.run()[rid], eng0.generate_vanilla(p, max_new_tokens=12))


def test_with_tree_sibling_semantics():
    _, eng = engine_pair(3)
    p = PROMPTS[0]
    small = eng.with_tree(total_tokens=5, depth=2, top_k=2)
    assert small.dparams is eng.dparams
    np.testing.assert_array_equal(small.generate(p, max_new_tokens=20),
                                  eng.generate_vanilla(p, max_new_tokens=20))
    assert eng.with_tree() is eng
    with pytest.raises(ValueError):
        eng._sibling(tree_paths=CHAIN_5).with_tree(total_tokens=5)


def test_async_sampled_matches_sync():
    """Sampled, per-request temperature and seed: async == sync token for
    token (each row draws from its own generator), and each request equals
    its one-sequence generate with that seed and temperature."""
    _, eng = engine_pair(1, temperature=0.8)
    budgets = [15, 19, 12]
    outs = []
    for depth in (0, 1):
        srv = EagleServer(eng, max_batch=2, async_schedule=depth)
        rids = [srv.submit(p, b, seed=i + 1, temperature=0.5 + 0.3 * i)
                for i, (p, b) in enumerate(zip(PROMPTS[:3], budgets))]
        got = srv.run()
        outs.append([got[r] for r in rids])
    for i, (a, b) in enumerate(zip(*outs)):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, eng.generate(PROMPTS[i], max_new_tokens=budgets[i],
                                                      seed=i + 1, temperature=0.5 + 0.3 * i))


def test_server_sampled_top_k_one_is_greedy():
    """At sampling_top_k = 1 every draw is one-hot: a sampled server emits
    the greedy tokens, whatever the seeds and temperatures."""
    _, eng = engine_pair(1, temperature=0.8, sampling_top_k=1)
    _, greedy = engine_pair(1)
    srv = EagleServer(eng, max_batch=2, async_schedule=1)
    rids = [srv.submit(p, 14, seed=i, temperature=0.3 + i)
            for i, p in enumerate(PROMPTS[:3])]
    outs = srv.run()
    for rid, p in zip(rids, PROMPTS[:3]):
        np.testing.assert_array_equal(outs[rid], greedy_ref(greedy, p, 14))


def test_server_mixed_temperatures():
    """Two requests of different temperatures share one batched round; the
    near-zero one gives the greedy output."""
    _, eng = engine_pair(3, temperature=1.0)
    greedy_out = eng.with_sampling(False).generate(PROMPTS[0], max_new_tokens=16)
    srv = EagleServer(eng, max_batch=2)
    r_cold = srv.submit(PROMPTS[0], max_new_tokens=16, temperature=1e-4)
    r_hot = srv.submit(PROMPTS[0], max_new_tokens=16, seed=9, temperature=4.0)
    outs = srv.run()
    np.testing.assert_array_equal(outs[r_cold], greedy_out)
    assert not np.array_equal(outs[r_hot], outs[r_cold])
