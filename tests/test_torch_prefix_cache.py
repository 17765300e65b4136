"""Prefix caching in the port's paged server (eagle_tpu_torch/engine/
prefix_cache.py, paged.py) on the CPU: the cases of
tests/test_prefix_cache.py, each request held bit for bit to the port's own
greedy decode (itself held to the JAX engine), one case against the JAX
package's PagedEagleServer, and the two reference defects the port does not
inherit (eagle_tpu/engine/paged.py:476 and :592)."""

import numpy as np

from eagle_tpu.engine.paged import PagedEagleServer as JaxPaged
from eagle_tpu_torch.engine.paged import PagedEagleServer
from eagle_tpu_torch.engine.prefix_cache import PrefixStore
from eagle_tpu_torch.engine.server import _Request

from torch_port_util import engine_pair, greedy_ref, port_engine

SYS = np.arange(1, 49) % 90 + 1        # a 48-token shared stem
REQ_A = np.concatenate([SYS, np.array([7, 3, 9])])
REQ_B = np.concatenate([SYS, np.array([11, 5])])


def test_store_lookup_insert_evict():
    freed = []
    st = PrefixStore(4, freed.extend, max_entries=2)
    toks = np.arange(16)
    e1 = st.insert(toks[:8], [3, 4], None, "dk1", "dv1")
    assert st.insert(toks[:8], [9, 9], None, "x", "x") is None  # duplicate
    e2 = st.insert(toks[:12], [5], e1, "dk2", "dv2")
    assert e2.parent is e1 and e1.borrowers == 1
    assert st.lookup(toks) == (e2, 12)
    assert st.lookup(toks[:11]) == (e1, 8)
    assert st.lookup(toks[:7]) == (e1, 4)      # page-granular
    other = toks.copy()
    other[2] = 77
    assert st.lookup(other) is None
    mid = toks[:12].copy()
    mid[9] = 77
    assert st.lookup(mid) == (e1, 8)
    assert st.evict(1) == 1                    # the LRU child's one page
    assert sorted(freed) == [5]
    assert len(st) == 1 and st.lookup(toks[:8]) == (e1, 8)
    e2b = st.insert(toks[:12], [6], e1, "dk2", "dv2")
    assert e2b.parent is e1 and e1.borrowers == 1
    assert st.evict(10) == 3                   # the child, then its parent, one pass
    assert sorted(freed) == [3, 4, 5, 6]
    assert len(st) == 0


def test_store_boundary_reregistration_after_evict():
    freed = []
    st = PrefixStore(4, freed.extend, max_entries=8)
    toks = np.arange(16)
    e1 = st.insert(toks[:8], [1, 2], None, "dk1", "dv1")
    e3 = st.insert(toks, [5, 6, 7, 8], None, "dk3", "dv3")
    assert st.lookup(toks[:8]) == (e1, 8)
    assert st.lookup(toks) == (e3, 16)
    assert st.evict(2) == 2
    assert sorted(freed) == [1, 2]
    assert st.lookup(toks[:8]) == (e3, 8)      # re-registered to e3
    assert st.lookup(toks[:5]) == (e3, 4)


def test_prefix_adoption_bit_exact():
    """A second request sharing a 48-token stem adopts the first's pages;
    both equal their greedy decodes."""
    _, eng = engine_pair(1)
    srv = PagedEagleServer(eng, max_batch=2, page_size=16)
    ra = srv.submit(REQ_A, 12)
    srv.run()
    assert len(srv.store) == 1
    rb = srv.submit(REQ_B, 12)
    outs = srv.run()
    assert srv.store.hits == 1 and srv.store.reused_tokens > 0
    np.testing.assert_array_equal(srv.finished[ra], greedy_ref(eng, REQ_A, 12))
    np.testing.assert_array_equal(outs[rb], greedy_ref(eng, REQ_B, 12))


def test_prefix_adoption_matches_jax_server():
    """The same donor-then-adopter run through the JAX package's
    PagedEagleServer: the same tokens, hits and reused tokens."""
    jeng, eng = engine_pair(1)
    outs = []
    for cls, conv in ((PagedEagleServer, lambda p: p), (JaxPaged, lambda p: p.astype(np.int32))):
        srv = cls(jeng if cls is JaxPaged else eng, max_batch=2, page_size=16)
        ra = srv.submit(conv(REQ_A), 12)
        srv.run()
        rb = srv.submit(conv(REQ_B), 12)
        srv.run()
        outs.append((srv.finished[ra], srv.finished[rb], srv.store.hits,
                     srv.store.reused_tokens))
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)


def test_prefix_partial_adoption_bit_exact():
    """Page-granular matching: the donor's entry is deeper than the shared
    stem; the adopter takes its first 3 pages; the adopter's own finish
    donates a chain entry spliced there, which a third request adopts."""
    _, eng = engine_pair(1)
    donor = np.concatenate([SYS, (np.arange(20) % 80) + 5])
    adopter = np.concatenate([SYS, np.array([71, 72, 73, 74, 75])])
    srv = PagedEagleServer(eng, max_batch=2, page_size=16)
    rd = srv.submit(donor, 12)
    srv.run()
    entries = {id(e): e for e, _ in srv.store._by_hash.values()}
    assert len(entries) == 1
    entry = next(iter(entries.values()))
    assert entry.rows > len(SYS)
    ra = srv.submit(adopter, 12)
    outs = srv.run()
    assert srv.store.hits == 1
    assert srv.store.reused_tokens == len(SYS) - 1     # 3 pages, the boundary row
    np.testing.assert_array_equal(srv.finished[rd], greedy_ref(eng, donor, 12))
    np.testing.assert_array_equal(outs[ra], greedy_ref(eng, adopter, 12))
    p3 = np.concatenate([srv.finished[ra], np.array([9])])
    r3 = srv.submit(p3, 10)
    out3 = srv.run()[r3]
    assert srv.store.hits == 2
    np.testing.assert_array_equal(out3, greedy_ref(eng, p3, 10))


def test_adoption_reads_the_rows_below_the_boundary_only():
    """Reference defect paged.py:592 (not inherited): the adoption prefill
    takes the donor entry's draft rows [0, R - 1) and nothing past them,
    whatever the entry's depth: the draft cache it starts from holds those
    rows, zeros after them, and has length R - 1."""
    _, eng = engine_pair(1)
    donor = np.concatenate([SYS, (np.arange(20) % 80) + 5])
    srv = PagedEagleServer(eng, max_batch=2, page_size=16)
    srv.submit(donor, 12)
    srv.run()
    entry, R = srv.store.lookup(np.concatenate([SYS, np.array([71, 72])]))
    assert R == len(SYS) < entry.rows
    dc = srv._adoption_dcache(entry, R)
    assert int(dc.length[0]) == R - 1
    np.testing.assert_array_equal(dc.k[:, :, :, : R - 1].numpy(),
                                  entry.dk[:, :, :, : R - 1].numpy())
    assert not dc.k[:, :, :, R - 1:].any() and not dc.v[:, :, :, R - 1:].any()


def test_unplaceable_deep_hit_goes_to_the_chunker():
    """Reference defect paged.py:476 (not inherited): a prompt near max_len
    whose deepest cached prefix leaves a rest that fits one chunk, but whose
    recomputed window (boundary row + bucketed rest) passes the cache's rows,
    cannot be adopted. The JAX server then neither chunks nor places it and
    admission stalls; here it is chunked and served, equal to its greedy
    decode."""
    jeng, _ = engine_pair(1)
    eng = port_engine(jeng, attn_impl="pallas_tree", max_len=200)
    srv = PagedEagleServer(eng, max_batch=1, page_size=16, prefill_chunk=64)
    donor = np.random.default_rng(3).integers(1, 128, 150)
    rd = srv.submit(donor, 10)
    srv.run()
    prompt = np.concatenate([donor, np.arange(35) % 50 + 3])      # 185 tokens
    entry, R = srv.store.lookup(prompt)
    rest = len(prompt) - (R - 1)
    # the JAX gate admits adoption (the rest fits a chunk), its placement
    # refuses it (the window passes the rows)
    assert rest <= srv.C and R + eng._bucket(rest) > srv._S_tok
    assert srv._usable_hit(_Request(0, prompt, 8, 0)) is None
    r = srv.submit(prompt, 8)
    outs = srv.run(max_steps=500)
    assert r in outs and srv.store.hits == 0 and srv.chunked_prefills == 2
    np.testing.assert_array_equal(srv.finished[rd], greedy_ref(eng, donor, 10))
    np.testing.assert_array_equal(outs[r], greedy_ref(eng, prompt, 8))


def test_prefix_chain_multiturn_bit_exact():
    """Each turn's prompt extends the last turn's output and adopts an ever
    deeper cached prefix (entry chains)."""
    _, eng = engine_pair(3)
    srv = PagedEagleServer(eng, max_batch=2, page_size=16)
    r1 = srv.submit(REQ_A, 14)
    out1 = srv.run()[r1]
    p2 = np.concatenate([out1, np.array([2, 8])])
    r2 = srv.submit(p2, 14)
    out2 = srv.run()[r2]
    assert srv.store.hits >= 1
    np.testing.assert_array_equal(out2, greedy_ref(eng, p2, 14))
    p3 = np.concatenate([out2, np.array([4])])
    r3 = srv.submit(p3, 10)
    out3 = srv.run()[r3]
    assert srv.store.hits >= 2
    np.testing.assert_array_equal(out3, greedy_ref(eng, p3, 10))


def test_prefix_adoption_mixed_batch():
    _, eng = engine_pair(1)
    fresh = np.array([60, 61, 62, 63, 64])
    srv = PagedEagleServer(eng, max_batch=3, page_size=16)
    ra = srv.submit(REQ_A, 10)
    srv.run()
    rb = srv.submit(REQ_B, 10)
    rf = srv.submit(fresh, 10)
    outs = srv.run()
    np.testing.assert_array_equal(srv.finished[ra], greedy_ref(eng, REQ_A, 10))
    np.testing.assert_array_equal(outs[rb], greedy_ref(eng, REQ_B, 10))
    np.testing.assert_array_equal(outs[rf], greedy_ref(eng, fresh, 10))


def test_prefix_eviction_under_pool_pressure():
    """A tight pool evicts cached prefixes instead of refusing admission."""
    _, eng = engine_pair(1)
    srv = PagedEagleServer(eng, max_batch=2, page_size=16, num_pages=21, prefix_entries=8)
    prompts = [REQ_A, REQ_B, np.concatenate([SYS, np.array([17])]),
               np.array([91, 92, 93, 94])]
    budgets = [10, 12, 9, 11]
    rids = [srv.submit(p, b) for p, b in zip(prompts, budgets)]
    outs = srv.run()
    for rid, p, b in zip(rids, prompts, budgets):
        np.testing.assert_array_equal(outs[rid], greedy_ref(eng, p, b))


def test_prefix_cache_off():
    _, eng = engine_pair(1)
    srv = PagedEagleServer(eng, max_batch=2, page_size=16, prefix_cache=False)
    assert srv.store is None
    srv.submit(REQ_A, 10)
    srv.run()
    rb = srv.submit(REQ_B, 10)
    np.testing.assert_array_equal(srv.run()[rb], greedy_ref(eng, REQ_B, 10))


def test_prefix_adoption_sampled_mode():
    """Sampled engines: adoption runs end to end, the prompt is kept and
    generation goes past it; at sampling_top_k = 1 the adopter's tokens are
    the greedy ones."""
    _, eng = engine_pair(1, temperature=1.0)
    srv = PagedEagleServer(eng, max_batch=2, page_size=16)
    srv.submit(REQ_A, 10, seed=1)
    srv.run()
    rb = srv.submit(REQ_B, 10, seed=2)
    out = srv.run()[rb]
    assert srv.store.hits == 1
    np.testing.assert_array_equal(out[: len(REQ_B)], REQ_B)
    assert len(out) > len(REQ_B)
    _, one_hot = engine_pair(1, temperature=0.8, sampling_top_k=1)
    _, greedy = engine_pair(1)
    srv = PagedEagleServer(one_hot, max_batch=2, page_size=16)
    srv.submit(REQ_A, 10, seed=1)
    srv.run()
    rb = srv.submit(REQ_B, 10, seed=2)
    out = srv.run()[rb]
    assert srv.store.hits == 1
    np.testing.assert_array_equal(out, greedy_ref(greedy, REQ_B, 10))
