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
    (5, 256, 200, 32, 128), (7, 512, 64, 16, 64)])
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
