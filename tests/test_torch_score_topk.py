"""The port's fused draft scoring (eagle_tpu_torch/ops/score_topk.py) against
the JAX package (eagle_tpu/ops/score_topk.py) on the CPU. The same numpy
inputs go through `score_topk_ref` (the plain version the port's wrapper takes
on the CPU), the JAX Pallas kernel in interpret mode, and the JAX unfused
chain. Tolerance: candidate ids equal; scores rtol = atol = 1e-5 (the
logsumexp is summed in another order on each side; against the interpreted
kernel the w4 logits also differ by XLA's fused multiply-adds, see
test_torch_quant4.INTERPRET_TOL)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eagle_tpu.engine import drafter as jdrafter
from eagle_tpu.ops import quant as jq
from eagle_tpu.ops import quant4 as jq4
from eagle_tpu.ops import score_topk as jstk
from eagle_tpu_torch.engine import drafter as tdrafter
from eagle_tpu_torch.ops import _launch
from eagle_tpu_torch.ops import quant as tq
from eagle_tpu_torch.ops import quant4 as tq4
from eagle_tpu_torch.ops import score_topk as tstk

from torch_port_util import t

TOL = dict(rtol=1e-5, atol=1e-5)


def _heads(w, kind):
    if kind == "w4":
        return jq4.pack_w4(jnp.asarray(w)), tq4.pack_w4(t(w))
    return jq.quantize_linear(jnp.asarray(w)), tq.quantize_linear(t(w))


def _jax_unfused(h, jqw, k):
    dense = jq4.qdense4_xla if "q4" in jqw else jq.qdense
    logits = dense(h, jqw).astype(jnp.float32)        # rounded through h.dtype
    return jdrafter.topk_rows(jax.nn.log_softmax(logits, axis=-1), k)


@pytest.mark.parametrize("kind", ["w8", "w4"])
@pytest.mark.parametrize("V", [512, 448])             # 448: a ragged last block
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_score_topk_ref_matches_jax(kind, V, dtype):
    rng = np.random.default_rng(0)
    M, K, k = 10, 256, 4
    hn = rng.normal(size=(M, K)).astype(np.float32)
    w = (rng.normal(size=(K, V)) * 0.1).astype(np.float32)
    jqw, tqw = _heads(w, kind)
    jh = jnp.asarray(hn, jnp.bfloat16 if dtype == "bf16" else jnp.float32)
    th = t(hn, torch.bfloat16 if dtype == "bf16" else torch.float32)
    lp, ids = tstk.score_topk_quant(th, tqw, k)       # CPU: the plain version
    assert lp.dtype == torch.float32 and ids.dtype == torch.long
    assert lp.shape == ids.shape == (M, k)
    # the unfused JAX chain: the same logits bit for bit, so the same ids
    ulp, uids = _jax_unfused(jh, jqw, k)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(uids))
    np.testing.assert_allclose(lp.numpy(), np.asarray(ulp), **TOL)
    # the Pallas kernel through the interpreter
    klp, kids = jstk.score_topk_quant(jh, jqw, k, interpret=True)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(kids))
    np.testing.assert_allclose(lp.numpy(), np.asarray(klp), **TOL)
    assert np.all(np.diff(lp.numpy(), axis=1) <= 0)


@pytest.mark.parametrize("kind", ["w8", "w4"])
def test_score_topk_ref_forced_ties(kind):
    """Exactly equal logits resolve by ascending index, as in the JAX kernel."""
    M, K, V, k = 2, 64, 256, 5
    h = np.ones((M, K), np.float32)
    w = np.zeros((K, V), np.float32)
    w[:, 100] = w[:, 7] = w[:, 200] = 0.5
    jqw, tqw = _heads(w, kind)
    _, ids = tstk.score_topk_quant(t(h), tqw, k)
    _, kids = jstk.score_topk_quant(jnp.asarray(h), jqw, k, interpret=True)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(kids))
    assert ids[0, :3].tolist() == [7, 100, 200]
    assert ids[0, 3:].tolist() == [0, 1]              # the zero logits, in index order


def test_score_topk_ref_is_the_unfused_port_chain():
    rng = np.random.default_rng(1)
    h = t(rng.normal(size=(6, 128)).astype(np.float32), torch.bfloat16)
    w = t((rng.normal(size=(128, 200)) * 0.1).astype(np.float32))
    for qw, dense in ((tq4.pack_w4(w), tq4.qdense4_ref), (tq.quantize_linear(w), tq.qdense)):
        lp, ids = tstk.score_topk_ref(h, qw, 7)
        ref = tdrafter.topk_rows(torch.log_softmax(dense(h, qw).float(), dim=-1), 7)
        assert torch.equal(lp, ref[0]) and torch.equal(ids, ref[1])


def test_score_topk_quant_refuses_what_the_kernel_does_not_take():
    before = dict(_launch.LAUNCHES)
    w = torch.zeros((64, 32))
    with pytest.raises(ValueError, match="single-block"):
        tstk.score_topk_quant(torch.zeros((2, 64)), tq4.pack_w4(w, blocks=2), 4)
    meta = {"q8": torch.empty((64, 32), dtype=torch.int8, device="meta"),
            "scale": torch.empty((32,), device="meta")}
    with pytest.raises(ValueError, match="CUDA"):
        tstk.score_topk_quant(torch.empty((2, 64), device="meta"), meta, 4)
    assert _launch.LAUNCHES == before


# ---------------------------------------------------------------------------
# the w4 kernel's plan and its tile-then-merge arithmetic
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("M,K,V,G,k", [
    (1, 4096, 32000, 32, 1), (2, 4096, 32000, 32, 10), (10, 4096, 32000, 32, 10),
    (16, 4096, 32000, 32, 16), (17, 4096, 32000, 32, 10), (32, 4096, 128256, 32, 16),
    (3, 64, 9, 2, 4), (7, 256, 1000, 16, 7), (1, 64, 70, 8, 3), (32, 512, 130, 16, 10),
    (33, 4096, 32000, 32, 17), (64, 4096, 32000, 32, 32), (10, 4096, 32000, 32, 128),
    (80, 4096, 128256, 32, 128), (1, 256, 130, 2, 128),
    (10, 4096, 32000, 32, 129), (1, 4096, 32000, 32, 1024), (33, 256, 1000, 16, 1000),
    (10, 4096, 128256, 32, 128256)])
def test_score_plan_covers_every_column_once(M, K, V, G, k):
    """The plan's column tiles cover [0, V) once and its grid matches them;
    the narrowest row tile holds M <= 32 rows, 32-row tiles cover more;
    shared memory holds the ring, the logits tile and the merge's state
    (the heads; past SMALL_K also each tile's next candidate and its
    position), within the card's 227 KB; up to SMALL_K the merge's
    candidates fit its 8 per lane. Past MAX_K (the select route) shared
    memory is the ring alone."""
    p = tstk.score_plan(M, K, V, G, k)
    nt = tstk.SCORE_NTILE
    assert p.bm == min((b for b in tstk.SCORE_ROW_TILES if b >= M), default=32)
    assert p.grid[0] == -(-M // p.bm) and (p.grid[0] - 1) * p.bm < M <= p.grid[0] * p.bm
    T = p.grid[1]
    cols = [c for t in range(T) for c in range(t * nt, min((t + 1) * nt, V))]
    assert cols == list(range(V)) and (T - 1) * nt < V
    ring = tq4.W4_STAGES * (p.bm * (4 * tq4.W4_STAGE_ROWS + 16) + p.bm * 4 + nt * 4
                            + tq4.W4_STAGE_ROWS * (nt + 8) * 4)
    merge = tstk.SCORE_WARPS * T * (20 if k > tstk.SMALL_K else 8)
    assert p.smem == (ring if k > tstk.MAX_K else max(ring, p.bm * (nt + 8) * 4, merge))
    assert p.smem <= tq4.W4_SMEM_MAX
    group = K // G
    assert p.vec == (K % 16 == 0 and group % 16 == 0 and V % 4 == 0)
    assert all(min(j, T) * j <= 8 * 32 for j in range(1, tstk.SMALL_K + 1))


def test_score_plan_refuses_what_the_kernel_does_not_take():
    with pytest.raises(ValueError, match="rows"):
        tstk.score_plan(0, 4096, 32000, 32, 10)
    for k in (0, 32001):
        with pytest.raises(ValueError, match="k="):
            tstk.score_plan(10, 4096, 32000, 32, k)



def _ordered(vals, idx):
    """(value desc, index asc) order of 1-D candidates: a stable sort by
    index, then a stable descending sort by value."""
    o = torch.sort(idx, stable=True)[1]
    o = o[torch.sort(vals[o], descending=True, stable=True)[1]]
    return vals[o], idx[o]


def _tile_merge(logits, k, nt):
    """The w4 kernel's arithmetic in plain f32 torch: per column tile its
    max, sum of exp and k best; then the global max and rescaled sum (per
    lane of the merging warp, then across the lanes), the min(k, T) tiles
    whose best candidates lead, and the k best of their candidates."""
    M, V = logits.shape
    T = -(-V // nt)
    big = 2**31 - 1
    pad = torch.full((M, T * nt), float("-inf"))
    pad[:, :V] = logits
    tiles = pad.reshape(M, T, nt)
    cols = torch.arange(T * nt).reshape(T, nt)
    cols = torch.where(cols < V, cols, torch.tensor(big))
    tmax = tiles.amax(-1)
    tsum = torch.exp(tiles - tmax[..., None]).sum(-1)
    scores, ids = [], []
    for m in range(M):
        heads, lists = [], []
        for t in range(T):
            v, i = _ordered(tiles[m, t], cols[t])
            lists.append((v[:k], i[:k]))
            heads.append((v[0], i[0]))
        # lane l of the merging warp: tiles l, l + 32, .. in one chunk, its
        # sum rescaled to the chunk's max; then across the lanes
        lm, ls = torch.full((32,), float("-inf")), torch.zeros(32)
        for l in range(min(32, T)):
            tm, ts = tmax[m, l::32], tsum[m, l::32]
            lm[l] = tm.max()
            ls[l] = (ts * torch.exp(tm - lm[l])).sum()
        gmax = lm.max()
        lse = gmax + torch.log((ls * torch.exp(lm - gmax)).sum())
        hv, hi = _ordered(torch.stack([h[0] for h in heads]), torch.stack([h[1] for h in heads]))
        chosen = [int(i) // nt for i in hi[:min(k, T)]]
        v, i = _ordered(torch.cat([lists[t][0] for t in chosen]),
                        torch.cat([lists[t][1] for t in chosen]))
        scores.append(v[:k] - lse)
        ids.append(i[:k])
    return torch.stack(scores), torch.stack(ids)


@pytest.mark.parametrize("V,k,ties", [
    (1000, 10, False), (1000, 16, True), (130, 10, True), (9, 4, True),
    (700, 1, True), (2000, 16, False)])
def test_tile_merge_arithmetic_matches_jax(V, k, ties):
    """Tile partials and their pruned merge give the unfused JAX chain's ids
    exactly and its scores within TOL. `ties` rounds the logits to quarters,
    so that many equal values sit in one tile and across far-apart tiles."""
    rng = np.random.default_rng(V + k)
    x = (rng.normal(size=(3, V)) * 2).astype(np.float32)
    if ties:
        x = np.round(x * 4) / 4
    lp, ids = _tile_merge(t(x), k, tstk.SCORE_NTILE)
    jlp, jids = jdrafter.topk_rows(jax.nn.log_softmax(jnp.asarray(x), axis=-1), k)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    np.testing.assert_allclose(lp.numpy(), np.asarray(jlp), **TOL)


def _kway_merge(logits, k, nt):
    """The w4 kernel's rule past SMALL_K, in plain f32 torch: rows in row
    tiles of 32 (each row on its own), per column tile its max, sum of exp
    and k best; then a k-way merge of the tiles' sorted lists, each round
    taking the best head (value desc, index asc) and moving that tile's head
    on. The logsumexp is `_tile_merge`'s."""
    M, V = logits.shape
    T = -(-V // nt)
    big = 2**31 - 1
    scores, ids = [], []
    for r0 in range(0, M, 32):                     # row tiles: rows are independent
        for m in range(r0, min(r0 + 32, M)):
            row = logits[m:m + 1]
            lse = row.max() - _tile_merge(row, 1, nt)[0][0, 0]    # its best score is max - lse
            pad = torch.full((T * nt,), float("-inf"))
            pad[:V] = row[0]
            cols = torch.arange(T * nt)
            cols = torch.where(cols < V, cols, torch.tensor(big))
            lists = [_ordered(pad[t * nt:(t + 1) * nt], cols[t * nt:(t + 1) * nt])
                     for t in range(T)]
            lists = [(v[:k], i[:k]) for v, i in lists]
            pos = [0] * T
            sv, si = [], []
            for _ in range(k):
                heads = [(lists[t][0][pos[t]], lists[t][1][pos[t]]) if pos[t] < k
                         else (torch.tensor(float("-inf")), torch.tensor(big + 1))
                         for t in range(T)]
                best = min(range(T), key=lambda t: (-float(heads[t][0]), int(heads[t][1])))
                sv.append(heads[best][0])
                si.append(heads[best][1])
                pos[best] += 1
            scores.append(torch.stack(sv) - lse)
            ids.append(torch.stack(si))
    return torch.stack(scores), torch.stack(ids)


@pytest.mark.parametrize("M,k", [(33, 17), (64, 32), (33, 128)])
def test_row_tiles_and_kway_merge_match_jax_kernel(M, k):
    """Past 32 rows and past k = 16, which the kernel once refused: the
    kernel's rule replayed on the port's w4 logits gives the interpreted JAX
    kernel's ids exactly and its scores within TOL, with heavy ties (weights
    of -1, 0 or 1 step, half the rows constant: many equal logits in one tile
    and across tiles)."""
    rng = np.random.default_rng(M + k)
    K, V = 64, 700
    # every product and sum of the w4 logits is exact in f32 (power-of-two
    # scales: each scale group of each column holds a 7, each row a 127), so
    # XLA's fused multiply-adds in the interpreted kernel keep the same ties
    w = rng.integers(-1, 2, size=(K, V)).astype(np.float32)
    w[::32] = 7.0
    w *= 2.0 ** -4
    h = rng.integers(-127, 128, size=(M, K)).astype(np.float32)
    h[:, 0] = 127.0
    h[::2] = 127.0
    h *= 2.0 ** -6
    jqw, tqw = _heads(w, "w4")
    logits = tq4.qdense4_ref(t(h), tqw).to(torch.float32)
    plan = tstk.score_plan(M, K, V, 2, k)          # the kernel takes these shapes
    assert plan.bm == 32 and plan.grid == (-(-M // 32), -(-V // tstk.SCORE_NTILE))
    lp, ids = _kway_merge(logits, k, tstk.SCORE_NTILE)
    klp, kids = jstk.score_topk_quant(jnp.asarray(h), jqw, k, interpret=True)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(kids))
    np.testing.assert_allclose(lp.numpy(), np.asarray(klp), **TOL)
    rlp, rids = tstk.score_topk_quant(t(h), tqw, k)      # CPU: the plain version
    assert torch.equal(rids, ids)
    assert len(set(np.round(logits.numpy()[0], 6))) < V // 4     # the ties are there


def _select_route(logits, k):
    """The select route's rule in plain torch: per row the 64-bit keys
    (value's order key << 32 | ~index), a radix select of the k-th key 8
    bits a pass from the top (stopping when every key under the prefix is
    taken), the gather of the keys at or above the prefix, a descending
    sort, and value - logsumexp."""
    bits = logits.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    bits = torch.where(bits == 0x80000000, 0, bits)            # -0 as +0
    okey = torch.where(bits >= 0x80000000, (~bits) & 0xFFFFFFFF, bits | 0x80000000)
    V = logits.shape[1]
    idx = (~torch.arange(V, dtype=torch.int64)) & 0xFFFFFFFF
    out_ids, out_scores = [], []
    lse = torch.logsumexp(logits, dim=-1)
    for m in range(logits.shape[0]):
        row = [(int(okey[m, i]) << 32) | int(idx[i]) for i in range(V)]
        prefix, pmask, kk = 0, 0, k
        for shift in range(56, -1, -8):
            hist = [0] * 256
            for key in row:
                if key & pmask == prefix:
                    hist[(key >> shift) & 255] += 1
            above, b = 0, 255
            while above + hist[b] < kk:
                above += hist[b]
                b -= 1
            prefix |= b << shift
            pmask |= 255 << shift
            kk -= above
            if hist[b] == kk:
                break
        sel = sorted((key for key in row if key & pmask >= prefix), reverse=True)
        assert len(sel) == k
        ids = [(~key) & 0xFFFFFFFF for key in sel]
        out_ids.append(ids)
        out_scores.append(logits[m, ids] - lse[m])
    return torch.stack(out_scores), torch.tensor(out_ids)


@pytest.mark.parametrize("kind", ["w4", "w8"])
@pytest.mark.parametrize("k", [129, 256, 700])
def test_select_route_matches_jax_kernel(kind, k):
    """k past one column tile: the select route's rule gives the JAX
    package's ids (identical) and scores (TOL), on logits with heavy exact
    ties (within and across tiles), up to k = V: the interpreted JAX kernel
    at k = 129, its unfused chain (the interpreted kernel runs k passes a
    block) past it; the wrapper on the CPU (the plain version) agrees."""
    rng = np.random.default_rng(k)
    K, V, M = 64, 700, 3
    w = rng.integers(-1, 2, size=(K, V)).astype(np.float32)
    w[::32] = 7.0
    w *= 2.0 ** -4
    h = rng.integers(-127, 128, size=(M, K)).astype(np.float32)
    h[:, 0] = 127.0
    h[1] = 127.0
    h *= 2.0 ** -6
    jqw, tqw = _heads(w, kind)
    dense = tq4.qdense4_ref if kind == "w4" else tq.qdense
    logits = dense(t(h), tqw).to(torch.float32)
    lp, ids = _select_route(logits, k)
    if k == 129:
        klp, kids = jstk.score_topk_quant(jnp.asarray(h), jqw, k, interpret=True)
    else:
        klp, kids = _jax_unfused(jnp.asarray(h), jqw, k)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(kids))
    np.testing.assert_allclose(lp.numpy(), np.asarray(klp), **TOL)
    rlp, rids = tstk.score_topk_quant(t(h), tqw, k)      # CPU: the plain version
    assert torch.equal(rids, ids)
    np.testing.assert_allclose(rlp.numpy(), lp.numpy(), **TOL)
    assert len(set(np.round(logits.numpy()[1], 6))) < V // 4     # the ties are there
    p = tstk.score_plan(M, K, V, 2, k)
    assert tstk.workspace_words(M, V, k, p.grid[1]) == (M * V + 1) // 2 * 2
    assert tstk.workspace_words(M, 128256, 16384, 1) == M * 128256 + 2 * M * 16384

