"""The port's CUDA kernels against their plain versions on the card. Marked
`cuda`: they skip where there is no NVIDIA GPU (the kernels are built for
sm_90a with nvcc at first use). Run on a Hopper machine with
`python -m pytest tests/test_torch_cuda_kernels.py -q -m cuda`."""

import numpy as np
import pytest
import torch

from eagle_tpu_torch.ops import _launch
from eagle_tpu_torch.ops import attn_kernels as ak
from eagle_tpu_torch.ops import quant as tq
from eagle_tpu_torch.ops import quant4 as tq4
from eagle_tpu_torch.ops import score_topk as stk
from eagle_tpu_torch.ops import w4_ablate as wab
from eagle_tpu_torch.ops.kv_cache import compact_rows_plain
from eagle_tpu_torch.ops.tree import ancestor_mask

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (sm_90a) and nvcc")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


# bf16: one bf16 ulp (2**-7 relative) against the plain bf16 output, half an
# ulp against the plain version's f32 output before its cast; the atol covers
# the order of f32 sums on outputs near zero
@pytest.mark.parametrize("dtype,tol", [
    (torch.float32, dict(rtol=1e-5, atol=1e-5)),
    (torch.bfloat16, dict(rtol=2.0 ** -7, atol=1e-5))])
@pytest.mark.parametrize("start", [0, 1, 777, 2048])
def test_tree_attention_kernel(dev, dtype, tol, start):
    g = torch.Generator(device=dev).manual_seed(start)
    r = lambda *s: torch.randn(s, generator=g, device=dev).to(dtype)
    rng = np.random.default_rng(start)
    parents = torch.tensor([0] + [int(rng.integers(0, i)) for i in range(1, 61)],
                           device=dev)
    args = (r(61, 32, 128), r(8, 2176, 128), r(8, 2176, 128), r(61, 8, 128),
            r(61, 8, 128), ancestor_mask(parents, 61).contiguous())
    st = torch.tensor(start, device=dev)
    before = ak.LAUNCHES["tree_attention"]
    got = ak.tree_attention(*args, st)
    torch.testing.assert_close(got, ak.tree_attention_ref(*args, st), **tol)
    if dtype == torch.bfloat16:
        ref32 = ak.tree_attention_ref(*(a.float() if a.is_floating_point() else a
                                        for a in args), st)
        torch.testing.assert_close(got.float(), ref32, rtol=2.0 ** -8, atol=1e-5)
    assert ak.LAUNCHES["tree_attention"] == before + 1


# the tolerances above, by dtype; bf16 is also held to half an ulp of the
# plain version's f32 output
B1_TOL = {torch.float32: dict(rtol=1e-5, atol=1e-5),
          torch.bfloat16: dict(rtol=2.0 ** -7, atol=1e-5)}


def _b1_check(got, args, st):
    ref = ak.tree_attention_ref(*args, st)
    torch.testing.assert_close(got, ref, **B1_TOL[got.dtype])
    if got.dtype == torch.bfloat16:
        ref32 = ak.tree_attention_ref(*(a.float() if a.is_floating_point() else a
                                        for a in args), st)
        torch.testing.assert_close(got.float(), ref32, rtol=2.0 ** -8, atol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T", [26, 61])
def test_tree_attention_kernel_chunk_edges(dev, dtype, T):
    """`start` one below, on and one above every prefix chunk edge of a
    1024-row view of a 2176-row cache (kv_buckets), at the static tree's T
    and the dynamic tree's: every split of the prefix between blocks."""
    g = torch.Generator(device=dev).manual_seed(T)
    r = lambda *s: torch.randn(s, generator=g, device=dev).to(dtype)
    rng = np.random.default_rng(T)
    parents = torch.tensor([0] + [int(rng.integers(0, i)) for i in range(1, T)],
                           device=dev)
    kc, vc = r(8, 2176, 128), r(8, 2176, 128)
    args = (r(T, 32, 128), kc[:, :1024], vc[:, :1024], r(T, 8, 128), r(T, 8, 128),
            ancestor_mask(parents, T).contiguous())
    ch = ak.TREE_CHUNK
    for start in [0] + [e + o for e in range(ch, 1025, ch) for o in (-1, 0, 1)]:
        st = torch.tensor(start, device=dev)
        _b1_check(ak.tree_attention(*args, st), args, st)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_tree_attention_kernel_odd_shape(dev, dtype):
    """g = 1, T = 13 queries against a non-square Tk = 40 slab under a
    random mask (T*g not a multiple of the 64-row tile)."""
    g = torch.Generator(device=dev).manual_seed(13)
    r = lambda *s: torch.randn(s, generator=g, device=dev).to(dtype)
    bm = torch.rand((13, 40), generator=g, device=dev) < 0.3
    bm[:, 0] = True
    args = (r(13, 8, 128), r(8, 256, 128), r(8, 256, 128), r(40, 8, 128), r(40, 8, 128),
            bm.contiguous())
    for start in (0, 77, 128, 256):
        st = torch.tensor(start, device=dev)
        _b1_check(ak.tree_attention(*args, st), args, st)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T", [26, 61])
def test_tree_attention_kernel_head_dim_64(dev, dtype, T):
    """head_dim 64 (the Llama-3.2-1B class: 32 q / 8 kv heads): start one
    below, on and one above every prefix chunk edge of a 1024-row view of a
    2176-row cache, and the full cache, within the B1 tolerances."""
    g = torch.Generator(device=dev).manual_seed(64 + T)
    r = lambda *s: torch.randn(s, generator=g, device=dev).to(dtype)
    rng = np.random.default_rng(64 + T)
    parents = torch.tensor([0] + [int(rng.integers(0, i)) for i in range(1, T)],
                           device=dev)
    kc, vc = r(8, 2176, 64), r(8, 2176, 64)
    mask = ancestor_mask(parents, T).contiguous()
    q, kt, vt = r(T, 32, 64), r(T, 8, 64), r(T, 8, 64)
    ch = ak.TREE_CHUNK
    before = ak.LAUNCHES["tree_attention"]
    n = 0
    for start in [0] + [e + o for e in range(ch, 1025, ch) for o in (-1, 0, 1)]:
        args = (q, kc[:, :1024], vc[:, :1024], kt, vt, mask)
        st = torch.tensor(start, device=dev)
        _b1_check(ak.tree_attention(*args, st), args, st)
        n += 1
    for start in (1500, 2176):
        args = (q, kc, vc, kt, vt, mask)
        st = torch.tensor(start, device=dev)
        _b1_check(ak.tree_attention(*args, st), args, st)
        n += 1
    assert ak.LAUNCHES["tree_attention"] == before + n


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [80, 96, 256, 100, 40, 1])
def test_tree_attention_kernel_other_head_dims(dev, dtype, d):
    """Head widths run at a padded width (80, 96 at 128; 256 at 256; 100
    and 40: bf16 rows that are not whole 16-byte chunks, loaded element by
    element): T = 61, 32 q / 8 kv heads, start one below, on and one above
    every chunk edge of a 1024-row view and the full cache, within the B1
    tolerances."""
    g = torch.Generator(device=dev).manual_seed(d)
    r = lambda *s: torch.randn(s, generator=g, device=dev).to(dtype)
    rng = np.random.default_rng(d)
    T = 61
    parents = torch.tensor([0] + [int(rng.integers(0, i)) for i in range(1, T)],
                           device=dev)
    kc, vc = r(8, 2176, d), r(8, 2176, d)
    mask = ancestor_mask(parents, T).contiguous()
    q, kt, vt = r(T, 32, d), r(T, 8, d), r(T, 8, d)
    ch = ak.TREE_CHUNK
    for view, starts in ((1024, [0] + [e + o for e in range(ch, 1025, ch) for o in (-1, 0, 1)]),
                         (2176, [1500, 2176])):
        args = (q, kc[:, :view], vc[:, :view], kt, vt, mask)
        for start in starts:
            st = torch.tensor(start, device=dev)
            _b1_check(ak.tree_attention(*args, st), args, st)


def test_tree_attention_kernel_refuses_other_head_dims(dev):
    """Every head_dim >= 1 runs (past 256 on the wide route); an empty head
    and a batch whose starts do not match its rows are refused before a
    launch."""
    r = lambda *s: torch.zeros(s, device=dev, dtype=torch.bfloat16)
    mask = torch.ones((4, 4), dtype=torch.bool, device=dev)
    before = ak.LAUNCHES["tree_attention"]
    with pytest.raises(ValueError, match="head_dim 0"):
        ak.tree_attention(r(4, 4, 0), r(2, 64, 0), r(2, 64, 0), r(4, 2, 0), r(4, 2, 0),
                          mask, torch.tensor(8, device=dev))
    with pytest.raises(ValueError, match="bad shapes"):
        ak.tree_attention(r(2, 4, 4, 320), r(2, 2, 64, 320), r(2, 2, 64, 320),
                          r(2, 4, 2, 320), r(2, 4, 2, 320), mask.expand(2, 4, 4).contiguous(),
                          torch.tensor([8, 9, 10], device=dev))
    assert ak.LAUNCHES["tree_attention"] == before


def _batch_inputs(dev, dtype, B, T, d, S, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    r = lambda *s: torch.randn(s, generator=g, device=dev).to(dtype)
    rng = np.random.default_rng(seed)
    masks = torch.stack([ancestor_mask(torch.tensor(
        [0] + [int(rng.integers(0, i)) for i in range(1, T)], device=dev), T)
        for _ in range(B)]).contiguous()
    return r(B, T, 32, d), r(B, 8, S, d), r(B, 8, S, d), r(B, T, 8, d), r(B, T, 8, d), masks


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("view", [2176, 2048])
def test_tree_attention_kernel_batched(dev, dtype, view):
    """One launch for B = 4 rows at starts 0, 300, 1024 and 2000 (a chunk
    live for one row is empty for another), on the full cache and on a
    row-sliced view of it: within the B1 tolerances of the batched plain
    version, each row bit-identical to a launch for that row alone, and the
    merge counters left zero."""
    q, kc, vc, kt, vt, tm = _batch_inputs(dev, dtype, 4, 61, 128, 2176, seed=view)
    args = (q, kc[:, :, :view], vc[:, :, :view], kt, vt, tm)
    st = torch.tensor([0, 300, 1024, 2000], device=dev)
    before = ak.LAUNCHES["tree_attention"]
    got = ak.tree_attention(*args, st)
    assert ak.LAUNCHES["tree_attention"] == before + 1 and got.shape == (4, 61, 32 * 128)
    _b1_check(got, args, st)
    for b in range(4):
        one = ak.tree_attention(*(a[b] for a in args), st[b])
        assert torch.equal(got[b], one), b
    torch.cuda.synchronize()
    assert all(int(c.abs().sum()) == 0 for c in ak._COUNTERS.values())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [320, 512])
def test_tree_attention_kernel_wide_head(dev, dtype, d):
    """head_dim > 256 (the wide route): B = 2, T = 61, 32 q / 8 kv heads,
    starts around a chunk edge of a 1024-row view and on the full cache,
    within the B1 tolerances."""
    q, kc, vc, kt, vt, tm = _batch_inputs(dev, dtype, 2, 61, d, 2176, seed=d)
    assert ak.tree_plan(61, 32, 8, 1024, d, B=2)["route"] == "wide"
    for view, starts in ((1024, [(0, 255), (256, 1023)]), (2176, [(2176, 1500)])):
        args = (q, kc[:, :, :view], vc[:, :, :view], kt, vt, tm)
        for pair in starts:
            st = torch.tensor(pair, device=dev)
            _b1_check(ak.tree_attention(*args, st), args, st)


def _row_exact_inputs(dev, T, d, seed, S=2112, nq=8, nkv=2, B=3):
    g = torch.Generator(device=dev).manual_seed(seed)
    r = lambda *s: torch.randn(s, generator=g, device=dev)
    rng = np.random.default_rng(seed)
    masks = torch.stack([ancestor_mask(torch.tensor(
        [0] + [int(rng.integers(0, i)) for i in range(1, T)], device=dev), T)
        for _ in range(B)]).contiguous()
    return r(B, T, nq, d), r(B, nkv, S, d), r(B, nkv, S, d), r(B, T, nkv, d), r(B, T, nkv, d), masks


@pytest.mark.parametrize("starts", [(0, 31, 32), (1000, 1023, 2047)])
@pytest.mark.parametrize("T", [1, 26, 61])
@pytest.mark.parametrize("d", [64, 128, 256, 320])
def test_tree_attention_f32_row_exact(dev, starts, T, d):
    """The f32 route is row-exact (fault C6): each row of a batched verify
    (B = 3, random parent-first trees, three starts) is bit-identical to a
    one-token launch at start + depth on a cache that holds its ancestors
    in order; and a 300-row causal prefill is bit-identical to the same
    rows prefilled in chunks of 64 and of 37."""
    q, kc, vc, kt, vt, tm = _row_exact_inputs(dev, T, d, seed=T * 1000 + d + starts[0])
    st = torch.tensor(starts, device=dev)
    got = ak.tree_attention(q, kc, vc, kt, vt, tm, st)
    one = torch.ones((T, 1, 1), dtype=torch.bool, device=dev)
    for b in range(3):
        # row t alone: its ancestors (mask row, index order) at start..start+depth-1
        kc1, vc1 = kc[b].repeat(T, 1, 1, 1), vc[b].repeat(T, 1, 1, 1)
        depth = tm[b].sum(-1) - 1
        for t in range(T):
            anc = torch.nonzero(tm[b, t])[:, 0]
            rows = slice(starts[b], starts[b] + len(anc) - 1)
            kc1[t, :, rows] = kt[b, anc[:-1]].transpose(0, 1)
            vc1[t, :, rows] = vt[b, anc[:-1]].transpose(0, 1)
        step = ak.tree_attention(q[b][:, None].contiguous(), kc1, vc1,
                                 kt[b][:, None].contiguous(), vt[b][:, None].contiguous(),
                                 one, starts[b] + depth)
        assert torch.equal(step[:, 0], got[b]), (b, starts[b])
    if T != 61:
        return
    # a causal prefill of 300 rows at start 0, whole and in chunks
    n = 300
    q, kc, vc, kt, vt, _ = _row_exact_inputs(dev, n, d, seed=d, B=1)
    causal = lambda m: torch.ones((1, m, m), dtype=torch.bool, device=dev).tril()
    whole = ak.tree_attention(q, kc, vc, kt, vt, causal(n), torch.zeros(1, device=dev))
    for chunk in (64, 37):
        cache_k, cache_v = torch.zeros_like(kc), torch.zeros_like(vc)
        for s0 in range(0, n, chunk):
            m = min(chunk, n - s0)
            part = ak.tree_attention(q[:, s0:s0 + m].contiguous(), cache_k, cache_v,
                                     kt[:, s0:s0 + m].contiguous(),
                                     vt[:, s0:s0 + m].contiguous(), causal(m),
                                     torch.full((1,), s0, device=dev))
            assert torch.equal(part, whole[:, s0:s0 + m]), (chunk, s0)
            cache_k[0, :, s0:s0 + m] = kt[0, s0:s0 + m].transpose(0, 1)
            cache_v[0, :, s0:s0 + m] = vt[0, s0:s0 + m].transpose(0, 1)


def test_tree_attention_merge_counters_left_zero(dev):
    """The bf16 kernel's merge counters are zero after every launch, and a
    second stream gets a buffer of its own."""
    g = torch.Generator(device=dev).manual_seed(5)
    r = lambda *s: torch.randn(s, generator=g, device=dev).to(torch.bfloat16)
    args = (r(61, 32, 128), r(8, 2176, 128), r(8, 2176, 128), r(61, 8, 128),
            r(61, 8, 128), torch.ones((61, 61), dtype=torch.bool, device=dev).tril())
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    for start in (0, 1000, 2176):
        st = torch.tensor(start, device=dev)
        ak.tree_attention(*args, st)
        with torch.cuda.stream(side):
            _b1_check(ak.tree_attention(*args, st), args, st)
    torch.cuda.synchronize()
    assert {torch.cuda.current_stream(dev), side} <= set(ak._COUNTERS)
    assert all(int(c.abs().sum()) == 0 for c in ak._COUNTERS.values())


def test_compact_rows_kernel(dev):
    g = torch.Generator(device=dev).manual_seed(0)
    k = torch.randn((32, 1, 8, 2176, 128), generator=g, device=dev).to(torch.bfloat16)
    v = torch.randn_like(k)
    path = torch.tensor([0, 3, 7, 7, 7, 7, 7], device=dev)
    st = torch.tensor(1000, device=dev)
    k2, v2 = k.clone(), v.clone()
    ak.compact_rows(k, v, path, st)
    compact_rows_plain(k2, v2, path, st)
    assert torch.equal(k, k2) and torch.equal(v, v2)


# the overlapping path at three starts (the last clamps the window at the
# end of the cache), an all-identity path, an identity prefix followed by
# moves, P = 1 (in place and moving)
@pytest.mark.parametrize("path,start", [
    ([0, 3, 7, 7, 7, 7, 7], 0), ([0, 3, 7, 7, 7, 7, 7], 1000),
    ([0, 3, 7, 7, 7, 7, 7], 2173), (list(range(7)), 1000),
    ([0, 1, 2, 5, 9, 12, 14], 1000), ([0], 1000), ([4], 1000)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_compact_rows_kernel_paths(dev, path, start, dtype):
    """Bit-identical to compact_rows_plain, every row of the cache included."""
    g = torch.Generator(device=dev).manual_seed(start)
    k = torch.randn((32, 1, 8, 2176, 128), generator=g, device=dev).to(dtype)
    v = torch.randn_like(k)
    pt, st = torch.tensor(path, device=dev), torch.tensor(start, device=dev)
    k2, v2 = k.clone(), v.clone()
    before = ak.LAUNCHES["compact_rows"]
    ak.compact_rows(k, v, pt, st)
    compact_rows_plain(k2, v2, pt, st)
    assert torch.equal(k, k2) and torch.equal(v, v2)
    assert ak.LAUNCHES["compact_rows"] == before + 1


def test_compact_rows_kernel_row_sliced_view(dev):
    """A view of the first 1024 rows (kv_buckets) moves the same rows as the
    full cache and touches nothing past the view."""
    g = torch.Generator(device=dev).manual_seed(3)
    k = torch.randn((32, 1, 8, 2176, 128), generator=g, device=dev).to(torch.bfloat16)
    v = torch.randn_like(k)
    path, st = torch.tensor([0, 3, 7, 7, 7, 7, 7], device=dev), torch.tensor(700, device=dev)
    k2, v2 = k.clone(), v.clone()
    ak.compact_rows(k[:, :, :, :1024], v[:, :, :, :1024], path, st)
    compact_rows_plain(k2, v2, path, st)
    assert torch.equal(k, k2) and torch.equal(v, v2)


def test_compact_rows_kernel_refuses_what_it_cannot_take(dev):
    k = torch.zeros((2, 1, 2, 64, 4), dtype=torch.bfloat16, device=dev)   # 8-byte rows
    with pytest.raises(ValueError, match="multiple of 16"):
        ak.compact_rows(k, k.clone(), torch.zeros(3, dtype=torch.long, device=dev), 2)
    big = torch.zeros((1, 1, 1, 4096, 128), dtype=torch.float32, device=dev)
    with pytest.raises(ValueError, match="at most"):    # 65 rows of 512 bytes
        ak.compact_rows(big, big.clone(), torch.arange(65, device=dev), 0)


# ---------------------------------------------------------------------------
# B3 / B4: w4a8 matmul, bit-identical to qdense4_ref
# ---------------------------------------------------------------------------

def _w4_case(dev, M, K, N, seed, blocks=1, group=128, dtype=torch.float32):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((M, K), generator=g, device=dev).to(dtype)
    w = torch.randn((K, N), generator=g, device=dev) * 0.05
    import warnings
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return x, tq4.pack_w4(w, group, blocks)


@pytest.mark.parametrize("M,K,N,blocks,group,dtype", [
    (1, 4096, 4096, 1, 128, torch.bfloat16), (10, 8192, 6144, 1, 128, torch.bfloat16),
    (61, 4096, 1024, 1, 128, torch.float32), (5, 512, 100, 1, 128, torch.float32),
    (7, 64, 40, 1, 16, torch.float32), (3, 32, 9, 1, 128, torch.float32),
    (9, 1024, 96, 2, 128, torch.float32), (33, 512, 72, 4, 128, torch.float32),
    (2, 256, 64, 1, 128, torch.float32), (300, 256, 384, 1, 128, torch.bfloat16)])
def test_qdense4_kernel_bit_identical(dev, M, K, N, blocks, group, dtype):
    x, qw = _w4_case(dev, M, K, N, M + K, blocks, group, dtype)
    b = torch.randn(N, device=dev)
    before = _launch.LAUNCHES["qdense4"]
    got = tq4.qdense4(x, qw, b)
    torch.cuda.synchronize()
    assert _launch.LAUNCHES["qdense4"] == before + 1
    assert torch.equal(got, tq4.qdense4_ref(x, qw, b))          # tolerance: none
    got32 = tq4.qdense4(x, qw, out_dtype=torch.float32)
    assert torch.equal(got32, tq4.qdense4_ref(x, qw, out_dtype=torch.float32))
    # a row's bits do not depend on how many rows go with it
    i = M // 2
    assert torch.equal(tq4.qdense4(x[i:i + 1], qw, out_dtype=torch.float32), got32[i:i + 1])


def test_qdense4_stacked_kernel_bit_identical(dev):
    g = torch.Generator(device=dev).manual_seed(0)
    L, K, N = 3, 4096, 1024
    st = tq4.pack_w4(torch.randn((L, K, N), generator=g, device=dev) * 0.05)
    x = torch.randn((61, K), generator=g, device=dev).to(torch.bfloat16)
    for layer in range(L):
        w = tq4.Stacked4(st["q4"], st["scale"], layer)
        before = _launch.LAUNCHES["qdense4_stacked"]
        got = tq4.qdense4_stacked(x, w)
        assert _launch.LAUNCHES["qdense4_stacked"] == before + 1
        assert torch.equal(got, tq4.qdense4_stacked_ref(x, w))
        one = tq4.qdense4_stacked(x[7:8], w)
        assert torch.equal(one, got[7:8])
    with pytest.raises(IndexError):
        tq4.qdense4_stacked(x, tq4.Stacked4(st["q4"], st["scale"], L))


@pytest.mark.parametrize("group", [16, 32, 64, 128])
@pytest.mark.parametrize("blocks", [1, 2, 4])
def test_qdense4_kernel_rows_groups_blocks(dev, group, blocks):
    """Every M edge of the 64-row tile and of the m16 tiles, each group
    size and blocked layout: bit-identical to qdense4_ref, and each row the
    same bits as in the M = 1024 call."""
    x, qw = _w4_case(dev, 1024, 1024, 200, group + blocks, blocks, group, torch.bfloat16)
    full = tq4.qdense4(x, qw, out_dtype=torch.float32)
    for M in (1, 15, 16, 17, 63, 64, 65, 1024):
        got = tq4.qdense4(x[:M], qw, out_dtype=torch.float32)
        assert torch.equal(got, tq4.qdense4_ref(x[:M], qw, out_dtype=torch.float32)), M
        assert torch.equal(got, full[:M]), M


@pytest.mark.parametrize("K,stacked", [(14336, True), (12288, False)])
def test_w4_kernel_long_k(dev, K, stacked):
    """The down projection's K (B4) and the draft fc's K (B3), N = 4096."""
    x, qw = _w4_case(dev, 65, K, 4096, K, dtype=torch.bfloat16)
    if stacked:
        w = tq4.Stacked4(qw["q4"][None], qw["scale"][None], 0)
        run = lambda a: tq4.qdense4_stacked(a, w, out_dtype=torch.float32)
        ref = lambda a: tq4.qdense4_stacked_ref(a, w, out_dtype=torch.float32)
    else:
        run = lambda a: tq4.qdense4(a, qw, out_dtype=torch.float32)
        ref = lambda a: tq4.qdense4_ref(a, qw, out_dtype=torch.float32)
    full = run(x)
    for M in (1, 61, 64, 65):
        assert torch.equal(run(x[:M]), ref(x[:M])), M
        assert torch.equal(run(x[:M]), full[:M]), M


# (M, K, N, group, blocks, (column tile, cluster split, 16-byte copies) that
# ops/quant4.w4_plan picks): every instantiation of csrc/w4_matmul.cu. One
# block per SM needs 132 column tiles at M <= 64, so N = 132 * tile picks
# that tile with 16-byte copies, and N = 132 * tile + 2 (not a multiple of
# 4 columns) with 4-byte copies; under 132 tiles of 8 columns the halves
# split over a cluster
W4_TILE_CASES = [
    *[(61, 256, 132 * n + pad, 128, 1, (n, False, pad == 0))
      for n in (128, 64, 32, 16, 8) for pad in (0, 2)],
    (61, 256, 1024, 128, 1, (8, True, True)),
    (70, 64, 40, 16, 1, (8, True, True)),       # two row tiles, groups of 16
    (5, 96, 37, 12, 1, (8, True, False)),       # groups of 12: 4-byte copies
    (9, 32, 9, 128, 1, (8, True, False)),       # K = 32: one group of 16 a half
    (33, 512, 72, 128, 4, (8, False, True)),    # blocked: never split
]


@pytest.mark.parametrize("M,K,N,group,blocks,want", W4_TILE_CASES)
def test_w4_kernel_every_instantiation_bit_identical(dev, M, K, N, group, blocks, want):
    """Each column tile with 16-byte and 4-byte copies, and the cluster
    split, reached through w4_plan at shapes that pick it: bit-identical to
    qdense4_ref and invariant in the number of rows."""
    x, qw = _w4_case(dev, M, K, N, M + N, blocks, group)
    G = qw["scale"].numel() // N
    plan = tq4.w4_plan(M, K, N, G, blocks)
    assert (plan.ntile, plan.split, plan.vec) == want
    got = tq4.qdense4(x, qw, out_dtype=torch.float32)
    assert torch.equal(got, tq4.qdense4_ref(x, qw, out_dtype=torch.float32))
    assert torch.equal(tq4.qdense4(x[-1:], qw, out_dtype=torch.float32), got[-1:])


def test_pack_w4_same_words_on_the_card_and_the_cpu(dev):
    g = torch.Generator().manual_seed(1)
    w = torch.randn((2, 512, 136), generator=g) * 0.1
    for blocks in (1, 2):
        a, b = tq4.pack_w4(w, blocks=blocks), tq4.pack_w4(w.to(dev), blocks=blocks)
        assert torch.equal(a["q4"], b["q4"].cpu()) and torch.equal(a["scale"], b["scale"].cpu())


# ---------------------------------------------------------------------------
# B5: fused score + top-k. ids identical; scores within stk.SCORE_TOL (the
# logsumexp is summed per tile, then over tiles)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["w4", "w8"])
@pytest.mark.parametrize("M,K,V,k,dtype", [
    (10, 4096, 32000, 10, torch.bfloat16), (1, 4096, 32000, 10, torch.float32),
    (32, 256, 448, 16, torch.float32), (7, 128, 70, 5, torch.bfloat16),
    (3, 64, 9, 4, torch.float32)])
def test_score_topk_kernel(dev, kind, M, K, V, k, dtype):
    g = torch.Generator(device=dev).manual_seed(V + M)
    h = torch.randn((M, K), generator=g, device=dev).to(dtype)
    w = torch.randn((K, V), generator=g, device=dev) * 0.05
    qw = tq4.pack_w4(w) if kind == "w4" else tq.quantize_linear(w)
    before = _launch.LAUNCHES["score_topk_quant"]
    lp, ids = stk.score_topk_quant(h, qw, k)
    torch.cuda.synchronize()
    assert _launch.LAUNCHES["score_topk_quant"] == before + 1
    ref_lp, ref_ids = stk.score_topk_ref(h, qw, k)
    assert torch.equal(ids, ref_ids)
    torch.testing.assert_close(lp, ref_lp, **stk.SCORE_TOL)


@pytest.mark.parametrize("kind", ["w4", "w8"])
def test_score_topk_kernel_forced_ties(dev, kind):
    """Equal logits in far-apart tiles resolve by ascending index."""
    M, K, V, k = 2, 256, 1000, 6
    h = torch.ones((M, K), device=dev)
    w = torch.zeros((K, V), device=dev)
    for c in (900, 7, 450, 64, 63):
        w[:, c] = 0.5
    w[:, 300] = 0.25
    qw = tq4.pack_w4(w) if kind == "w4" else tq.quantize_linear(w)
    _, ids = stk.score_topk_quant(h, qw, k)
    _, ref_ids = stk.score_topk_ref(h, qw, k)
    assert torch.equal(ids, ref_ids)
    assert ids[0].tolist() == [7, 63, 64, 450, 900, 300]


# the w4 kernel at every row tile edge (16 / 32 rows), at V a multiple of
# its 128-column tile and not, at groups of 128 and shorter ones (a group of
# 8 takes the 4-byte copies, as does V = 130)
@pytest.mark.parametrize("M", [1, 2, 10, 16, 17, 32])
@pytest.mark.parametrize("K,V,group", [
    (4096, 32000, 128), (4096, 1000, 128), (256, 1000, 16), (64, 130, 8)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_score_topk_w4_kernel_shapes(dev, M, K, V, group, dtype):
    g = torch.Generator(device=dev).manual_seed(V + M + K)
    h = torch.randn((M, K), generator=g, device=dev).to(dtype)
    qw = tq4.pack_w4(torch.randn((K, V), generator=g, device=dev) * 0.05, group)
    before = _launch.LAUNCHES["score_topk_quant"]
    lp, ids = stk.score_topk_quant(h, qw, 10)
    torch.cuda.synchronize()
    assert _launch.LAUNCHES["score_topk_quant"] == before + 1
    assert ids.dtype == torch.int64 and lp.shape == ids.shape == (M, 10)
    ref_lp, ref_ids = stk.score_topk_ref(h, qw, 10)
    assert torch.equal(ids, ref_ids)
    torch.testing.assert_close(lp, ref_lp, **stk.SCORE_TOL)


@pytest.mark.parametrize("kind", ["w4", "w8"])
def test_score_topk_kernel_ties_across_the_vocabulary(dev, kind):
    """Equal logits in one tile and in far-apart tiles at V = 32000 resolve
    by ascending index: the merge keeps the tiles whose heads lead and then
    their candidates, and loses none of the ties."""
    M, K, V, k = 2, 256, 32000, 10
    h = torch.ones((M, K), device=dev)
    w = torch.zeros((K, V), device=dev)
    for c in (31999, 5, 12800, 6, 127, 128, 7):
        w[:, c] = 0.5
    w[:, 300] = 0.25
    qw = tq4.pack_w4(w) if kind == "w4" else tq.quantize_linear(w)
    _, ids = stk.score_topk_quant(h, qw, k)
    _, ref_ids = stk.score_topk_ref(h, qw, k)
    assert torch.equal(ids, ref_ids)
    assert ids[0].tolist() == [5, 6, 7, 127, 128, 12800, 31999, 300, 0, 1]


# past 32 rows (row tiles on the grid) and past k = 16 (the k-way merge), w4
# and w8, random and with heavy ties (weights on three levels, constant rows)
@pytest.mark.parametrize("kind", ["w4", "w8"])
@pytest.mark.parametrize("M,k", [(33, 17), (64, 32), (10, 128), (33, 128), (64, 10), (1, 17)])
@pytest.mark.parametrize("ties", [False, True])
def test_score_topk_kernel_many_rows_large_k(dev, kind, M, k, ties):
    K, V = 4096, 32000 if kind == "w4" else 3000
    g = torch.Generator(device=dev).manual_seed(M * 131 + k)
    h = torch.randn((M, K), generator=g, device=dev).to(torch.bfloat16)
    w = torch.randn((K, V), generator=g, device=dev) * 0.05
    if ties:
        w = torch.randint(-1, 2, (K, V), generator=g, device=dev) * 0.05
        h[::2] = 1.0
    qw = tq4.pack_w4(w) if kind == "w4" else tq.quantize_linear(w)
    before = _launch.LAUNCHES["score_topk_quant"]
    lp, ids = stk.score_topk_quant(h, qw, k)
    torch.cuda.synchronize()
    assert _launch.LAUNCHES["score_topk_quant"] == before + 1
    ref_lp, ref_ids = stk.score_topk_ref(h, qw, k)
    assert torch.equal(ids, ref_ids)
    torch.testing.assert_close(lp, ref_lp, **stk.SCORE_TOL)
    assert all(int(c.abs().sum()) == 0 for c in stk._COUNTERS.values())


def test_score_topk_merge_counters_left_zero(dev):
    """The w4 kernel's merge counters are zero after a launch, and after two
    launches on two streams, each with a buffer of its own."""
    g = torch.Generator(device=dev).manual_seed(9)
    qw = tq4.pack_w4(torch.randn((4096, 32000), generator=g, device=dev) * 0.05)
    h = torch.randn((10, 4096), generator=g, device=dev).to(torch.bfloat16)
    ref = stk.score_topk_ref(h, qw, 10)
    stk.score_topk_quant(h, qw, 10)
    torch.cuda.synchronize()
    assert all(int(c.abs().sum()) == 0 for c in stk._COUNTERS.values())
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    main_out = stk.score_topk_quant(h, qw, 10)
    with torch.cuda.stream(side):
        side_out = stk.score_topk_quant(h, qw, 10)
    torch.cuda.synchronize()
    assert {torch.cuda.current_stream(dev), side} <= set(stk._COUNTERS)
    assert all(int(c.abs().sum()) == 0 for c in stk._COUNTERS.values())
    for lp, ids in (main_out, side_out):
        assert torch.equal(ids, ref[1])
        torch.testing.assert_close(lp, ref[0], **stk.SCORE_TOL)


def test_score_topk_kernel_refuses_a_foreign_plan(dev):
    """The launch checks the plan against its kernel's geometry: a plan with
    the wrong shared memory or grid is refused and nothing runs."""
    M, K, V, k = 10, 256, 1000, 10
    g = torch.Generator(device=dev).manual_seed(2)
    qw = tq4.pack_w4(torch.randn((K, V), generator=g, device=dev) * 0.05)
    xq, sx, rs = tq4.quantize_for_w4(torch.randn((M, K), generator=g, device=dev), K // 128)
    p = stk.score_plan(M, K, V, K // 128, k)
    fn = _launch.entry_point("score_topk", stk._W4_ARGS)
    ws = torch.empty(M * p.grid[1] * (2 + 2 * k), dtype=torch.int32, device=dev)
    cnt = torch.zeros(1, dtype=torch.int32, device=dev)
    out = torch.empty((M, k), device=dev), torch.empty((M, k), dtype=torch.int64, device=dev)
    bad = [(p.bm, p.smem + 16, *p.grid), (p.bm, p.smem, p.grid[0], p.grid[1] + 1),
           (32 if p.bm == 16 else 16, p.smem, *p.grid), (48, p.smem, *p.grid)]
    for bm, smem, gm, gn in bad:
        err = fn(xq.data_ptr(), rs.data_ptr(), sx.data_ptr(), qw["q4"].data_ptr(),
                 qw["scale"].data_ptr(), ws.data_ptr(), cnt.data_ptr(), out[0].data_ptr(),
                 out[1].data_ptr(), M, K, V, K // 128, k, 0, bm, int(p.vec), smem, gm, gn,
                 _launch.stream())
        assert err != 0, (bm, smem, gm, gn)
    with pytest.raises(ValueError, match="V=1000"):
        stk.score_topk_quant(torch.zeros((33, K), device=dev), qw, V + 1)


@pytest.mark.parametrize("kind", ["w4", "w8"])
@pytest.mark.parametrize("M,K,V,k", [(10, 4096, 32000, 129), (10, 4096, 32000, 256),
                                     (1, 4096, 32000, 1024), (33, 256, 1000, 1000),
                                     (3, 256, 20000, 9000)])
@pytest.mark.parametrize("ties", [False, True])
def test_score_topk_kernel_select_route(dev, kind, M, K, V, k, ties):
    """k past one column tile (the logits pass, then the radix select; 9000
    sorts in the workspace): ids identical to score_topk_ref, scores within
    SCORE_TOL, random and heavily tied logits, one counted call."""
    g = torch.Generator(device=dev).manual_seed(k + M)
    if ties:
        w = torch.randint(-1, 2, (K, V), generator=g, device=dev).float().mul_(0.05)
    else:
        w = torch.randn((K, V), generator=g, device=dev).mul_(0.05)
    qw = tq4.pack_w4(w) if kind == "w4" else tq.quantize_linear(w)
    h = torch.randn((M, K), generator=g, device=dev).to(torch.bfloat16)
    if ties:
        h[::2] = 1.0
    before = _launch.LAUNCHES["score_topk_quant"]
    lp, ids = stk.score_topk_quant(h, qw, k)
    assert _launch.LAUNCHES["score_topk_quant"] == before + 1
    ref_lp, ref_ids = stk.score_topk_ref(h, qw, k)
    assert torch.equal(ids, ref_ids)
    torch.testing.assert_close(lp, ref_lp, **stk.SCORE_TOL)


def test_quantize_rows_same_scales_on_the_card_and_the_cpu(dev):
    """x / 127 is a true division on both devices (ops/quant.true_div)."""
    g = torch.Generator().manual_seed(2)
    x = torch.randn((64, 4096), generator=g)
    (xq, sx), (cq, cs) = tq.quantize_rows(x), tq.quantize_rows(x.to(dev))
    assert torch.equal(xq, cq.cpu()) and torch.equal(sx, cs.cpu())


# ---------------------------------------------------------------------------
# B6: the nine ablation variants of the w4a8 body, bit-identical to ablate_ref
# (every kernel keeps its plain version's order of f32 sums)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", wab.MODES)
@pytest.mark.parametrize("M,K,N,group,block_n", [
    (32, 4096, 4096, 128, 256), (32, 4096, 4096, 128, 1536), (512, 1024, 512, 128, 512),
    (5, 256, 200, 32, 128), (7, 512, 64, 16, 64), (61, 4096, 4096, 128, 16),
    (512, 4096, 4096, 128, 256), (5, 256, 200, 4, 8), (32, 4096, 4096, 1024, 256),
    (61, 4096, 1024, 256, 24), (32, 2048, 512, 512, 64)])
def test_w4_ablate_kernel_bit_identical(dev, mode, M, K, N, group, block_n):
    g = torch.Generator(device=dev).manual_seed(M + N)
    G = K // group
    xq = torch.randint(-127, 128, (M, K), dtype=torch.int8, generator=g, device=dev)
    rs = (8 * xq.reshape(M, G, group).sum(dim=2, dtype=torch.int32)).contiguous()
    if mode in wab.I32_MODES:
        p = torch.randint(-2**31, 2**31 - 1, (K // 8, N), dtype=torch.int32,
                          generator=g, device=dev)
    else:
        p = torch.randint(0, 256, (K // 2, N), dtype=torch.uint8, generator=g, device=dev)
    s = torch.rand((G, N), generator=g, device=dev) * 1e-3 + 5e-4
    name = f"w4_ablate.{mode}"
    before = _launch.LAUNCHES[name]
    got = wab.ablate(mode, xq, rs, p, s, group, block_n)
    torch.cuda.synchronize()
    assert _launch.LAUNCHES[name] == before + 1
    assert torch.equal(got, wab.ablate_ref(mode, xq, rs, p, s, group))   # tolerance: none


def test_w4_ablate_kernel_refuses_what_it_cannot_take(dev):
    xq = torch.zeros((4, 256), dtype=torch.int8, device=dev)
    rs = torch.zeros((4, 8), dtype=torch.int32, device=dev)
    p = torch.zeros((128, 64), dtype=torch.uint8, device=dev)
    s = torch.ones((8, 64), device=dev)
    with pytest.raises(ValueError, match="block_n"):
        wab.ablate("full", xq, rs, p, s, 32, block_n=100)
    with pytest.raises(ValueError, match="weights"):
        wab.ablate("i32_storage", xq, rs, p, s, 32)
    with pytest.raises(ValueError, match="one device"):
        wab.ablate("full", xq, rs, p.cpu(), s, 32)


@pytest.mark.parametrize("M,N", [(1, 4096), (32, 4096), (61, 4096), (61, 1024), (512, 4096),
                                 (61, 14336)])
def test_w4_ablate_i32_storage_is_b3(dev, M, N):
    """`i32_storage` at `ablate_plan`'s tile with block_n = that tile is the
    engines' loop: B3's kernel alone gives the same bits."""
    K, group = 4096, 128
    g = torch.Generator(device=dev).manual_seed(M + N)
    qw = tq4.pack_w4(torch.randn((K, N), generator=g, device=dev) * 0.05, group)
    xq, _, rs = tq4.quantize_for_w4(torch.randn((M, K), generator=g, device=dev), K // group)
    tile = wab.ablate_plan("i32_storage", M, K, N, K // group, 128).ntile
    got = wab.ablate("i32_storage", xq, rs, qw["q4"], qw["scale"], group, block_n=tile)
    want = tq4.w4_kernel("qdense4", xq, rs, qw["q4"], qw["scale"], 1, None)
    assert tile == tq4.w4_plan(M, K, N, K // group, 1).ntile
    assert torch.equal(got, want)

