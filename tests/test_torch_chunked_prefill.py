"""Chunked prefill in the port's paged server (eagle_tpu_torch/engine/
paged.py) on the CPU: the cases of tests/test_chunked_prefill.py and the
chunked case of tests/test_async_server.py, each request held bit for bit
to the port's own greedy decode (itself held to the JAX engine), and one
case against the JAX package's PagedEagleServer with chunking on."""

import numpy as np
import pytest

from eagle_tpu.engine.paged import PagedEagleServer as JaxPaged
from eagle_tpu_torch.engine.paged import PagedEagleServer

from torch_port_util import engine_pair, greedy_ref

rng = np.random.default_rng(7)
LONG_A = rng.integers(1, 128, size=90)    # 2 chunks + a tail
LONG_B = rng.integers(1, 128, size=129)   # crosses a prompt bucket
SHORT = np.array([5, 17, 92, 3])


def _check(eng, outs, rids, prompts, budgets):
    for rid, p, b in zip(rids, prompts, budgets):
        np.testing.assert_array_equal(outs[rid], greedy_ref(eng, p, b, longest=b))


def test_chunked_matches_jax_paged_server():
    """A paged run with a chunked prompt and a short one gives the JAX
    package's PagedEagleServer's tokens."""
    jeng, eng = engine_pair(1)
    prompts, budgets = [SHORT, LONG_A], [14, 12]
    srv = PagedEagleServer(eng, max_batch=2, page_size=16, prefill_chunk=32)
    jsrv = JaxPaged(jeng, max_batch=2, page_size=16, prefill_chunk=32)
    rids = [srv.submit(p, b) for p, b in zip(prompts, budgets)]
    jrids = [jsrv.submit(p.astype(np.int32), b) for p, b in zip(prompts, budgets)]
    outs, jouts = srv.run(), jsrv.run()
    assert srv.chunked_prefills == jsrv.chunked_prefills == 1
    for r, jr in zip(rids, jrids):
        np.testing.assert_array_equal(outs[r], jouts[jr])


# ---------------------------------------------------------------------------

@pytest.mark.parametrize("depth", [0, 1])
def test_chunked_bit_exact_vs_single(depth):
    """Chunked admission of a chunk-aligned-ish and a bucket-crossing prompt
    equals unchunked greedy decoding, sync and async."""
    _, eng = engine_pair(1)
    srv = PagedEagleServer(eng, max_batch=2, page_size=16, prefill_chunk=32,
                           async_schedule=depth)
    rids = [srv.submit(p, b) for p, b in zip([LONG_A, LONG_B], [20, 16])]
    outs = srv.run()
    assert srv.chunked_prefills == 2
    _check(eng, outs, rids, [LONG_A, LONG_B], [20, 16])


def test_chunked_mixed_with_short_prompts():
    _, eng = engine_pair(3)
    prompts, budgets = [SHORT, LONG_A, SHORT + 1], [18, 14, 11]
    srv = PagedEagleServer(eng, max_batch=2, page_size=16, prefill_chunk=32)
    rids = [srv.submit(p, b) for p, b in zip(prompts, budgets)]
    outs = srv.run()
    assert srv.chunked_prefills == 1
    _check(eng, outs, rids, prompts, budgets)


def test_chunked_overlaps_running_decode():
    """A long prompt joining a busy batch chunks in the background while the
    running request keeps emitting tokens."""
    _, eng = engine_pair(1)
    srv = PagedEagleServer(eng, max_batch=1, page_size=16, prefill_chunk=32)
    r0 = srv.submit(SHORT, 40)
    srv.step()
    r1 = srv.submit(LONG_B, 12)
    emitted_during_chunking, saw_job = 0, False
    while srv._job is not None or not saw_job:
        out = srv.step()
        if srv._job is not None:
            saw_job = True
            emitted_during_chunking += len(out.get(r0, ()))
        if srv._idle():
            break
    assert saw_job and emitted_during_chunking > 0
    _check(eng, srv.run(), [r0, r1], [SHORT, LONG_B], [40, 12])


def test_chunked_sampled_matches_unchunked():
    """The final chunk draws the root token, then the draft's noise, as an
    unchunked prefill does: sampled outputs match at the same seed."""
    _, eng = engine_pair(1, temperature=0.8)
    srv_a = PagedEagleServer(eng, max_batch=1, page_size=16)
    ra = srv_a.submit(LONG_A, 15, seed=11)
    ref = srv_a.run()[ra]
    srv_b = PagedEagleServer(eng, max_batch=1, page_size=16, prefill_chunk=32)
    rb = srv_b.submit(LONG_A, 15, seed=11)
    got = srv_b.run()[rb]
    assert srv_b.chunked_prefills == 1
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, eng.generate(LONG_A, max_new_tokens=15, seed=11))


def test_chunked_prefix_cache_preempts_chunking():
    """A prompt whose prefix is cached adopts the pages instead of chunking."""
    _, eng = engine_pair(1)
    srv = PagedEagleServer(eng, max_batch=1, page_size=16, prefill_chunk=32)
    r0 = srv.submit(LONG_B, 10)
    srv.run()
    assert srv.chunked_prefills == 1
    r1 = srv.submit(LONG_B, 10)
    outs = srv.run()
    assert srv.chunked_prefills == 1 and srv.store.hits == 1
    np.testing.assert_array_equal(outs[r1], srv.finished[r0])


def test_chunked_job_cancelled_under_pool_pressure():
    """A running request's growth and a chunk job compete for the last
    pages: the job is cancelled (running requests outrank waiting
    prefills) and restarts later; both outputs are unchanged."""
    _, eng = engine_pair(1)
    srv = PagedEagleServer(eng, max_batch=1, page_size=16, prefill_chunk=32,
                           num_pages=17, prefix_cache=False)
    r0 = srv.submit(SHORT, 130)
    srv.step()
    r1 = srv.submit(LONG_B, 12)
    outs = srv.run()
    assert srv.cancelled_prefills >= 1 and srv.preemptions == 0
    _check(eng, outs, [r0, r1], [SHORT, LONG_B], [130, 12])


def test_paged_cancel_chunking_request():
    """cancel() takes a request out of chunked prefill and frees its pages."""
    _, eng = engine_pair(1)
    srv = PagedEagleServer(eng, max_batch=1, page_size=16, prefill_chunk=32)
    r0 = srv.submit(SHORT, 30)
    srv.step()
    r1 = srv.submit(LONG_B, 12)
    while srv._job is None or not srv._job.pages:
        srv.step()
    assert srv._job.req.request_id == r1
    free = srv.allocator.free_pages
    assert srv.cancel(r1) and srv.allocator.free_pages > free
    outs = srv.run()
    assert set(outs) == {r0}
    _check(eng, outs, [r0], [SHORT], [30])
