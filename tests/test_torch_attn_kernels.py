"""The port's kernel module (eagle_tpu_torch/ops/attn_kernels.py) against the
JAX package: plain tree attention vs pallas_attn.tree_attention_xla and the
interpreted Pallas kernel, plain compaction vs compact_accepted and the
interpreted compact_rows, and the wrappers' device rules. CPU, fp32."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eagle_tpu.ops import pallas_attn
from eagle_tpu.ops.kv_cache import KVCache as JKVCache
from eagle_tpu.ops.kv_cache import compact_accepted as j_compact_accepted
from eagle_tpu.ops.tree import ancestor_mask as j_ancestor_mask
from eagle_tpu_torch.ops import _build
from eagle_tpu_torch.ops import attn_kernels as ak
from eagle_tpu_torch.ops.kv_cache import KVCache, compact_accepted

from torch_port_util import t

TOL = dict(rtol=2e-5, atol=2e-5)


def _inputs(T, Tk, nq, nkv, d, S, seed, square=True):
    rng = np.random.default_rng(seed)
    arr = lambda *s: rng.normal(size=s).astype(np.float32)
    q, k, v = arr(T, nq, d), arr(nkv, S, d), arr(nkv, S, d)
    kt, vt = arr(Tk, nkv, d), arr(Tk, nkv, d)
    if square:
        parents = np.array([0] + [rng.integers(0, i) for i in range(1, T)])
        tm = np.asarray(j_ancestor_mask(jnp.asarray(parents, jnp.int32), T))
    else:  # draft-beam shape: k queries against a depth*k ancestor slab
        tm = rng.random((T, Tk)) < 0.3
        tm[:, 0] = True
    return q, k, v, kt, vt, tm


@pytest.mark.parametrize("T,Tk,nq,nkv,d,S,start", [
    (16, 16, 4, 2, 8, 128, 37),
    (61, 61, 8, 4, 64, 512, 0),
    (61, 61, 8, 8, 64, 512, 500),
    (26, 26, 4, 4, 32, 256, 100),
    (10, 40, 4, 2, 16, 128, 77),     # non-square beam shape
    (13, 40, 4, 4, 16, 128, 77),     # g = 1, non-square
])
def test_tree_attention_ref_matches_jax(T, Tk, nq, nkv, d, S, start):
    args = _inputs(T, Tk, nq, nkv, d, S, seed=T + S, square=T == Tk)
    st = jnp.int32(start)
    jargs = [jnp.asarray(a) for a in args]
    ref_xla = np.asarray(pallas_attn.tree_attention_xla(*jargs, st))
    ref_pallas = np.asarray(pallas_attn.tree_attention(
        *jargs, st, blk=64, interpret=True))
    targs = [t(a) for a in args]
    out_ref = ak.tree_attention_ref(*targs, torch.tensor(start))
    out_wrap = ak.tree_attention(*targs, torch.tensor(start))   # CPU → plain
    assert out_ref.shape == (T, nq * d)
    for out in (out_ref, out_wrap):
        np.testing.assert_allclose(out.numpy(), ref_xla, **TOL)
        np.testing.assert_allclose(out.numpy(), ref_pallas, **TOL)
    assert ak.LAUNCHES["tree_attention"] == 0 and ak.LAUNCHES["compact_rows"] == 0


def _key_ranges(plan: dict, start: int, S_rows: int) -> list:
    """(chunk, first key, end key) of every prefix block of `plan` that
    attends, as csrc/tree_attention.cu computes them from the device's
    `start`: start clamps to [0, S_rows], chunk c covers [c*TREE_CHUNK,
    min((c+1)*TREE_CHUNK, start)), and a chunk with no key below start exits
    at once."""
    start = min(max(int(start), 0), S_rows)
    ch = ak.TREE_CHUNK
    return [(c, c * ch, min((c + 1) * ch, start)) for c in range(-(-start // ch))]


@pytest.mark.parametrize("T,S_rows,head_rows", [
    (61, 2176, 2176),    # contiguous cache
    (26, 1024, 2176),    # a 1024-row view of a 2176-row cache (kv_buckets)
    (61, 1024, 2176),
    (13, 300, 300)])     # a prefix shorter than two chunks
def test_tree_plan_covers_every_prefix_row_once(T, S_rows, head_rows):
    """The bf16 kernel's grid comes from the view's rows, not the head
    stride; for every start in [0, S] (and past it, where start clamps) the
    prefix blocks that attend cover rows [0, start) exactly once, each inside
    its own chunk, and their chunk indices lie inside the grid."""
    nq, n_kv = 32, 8
    plan = ak.tree_plan(T, nq, n_kv, S_rows, 128)
    rows = T * nq // n_kv
    assert (plan["row_tiles"] - 1) * ak.TREE_ROWS < rows <= plan["row_tiles"] * ak.TREE_ROWS
    ch = ak.TREE_CHUNK
    assert (plan["chunks"] - 1) * ch < S_rows <= plan["chunks"] * ch
    assert ak.tree_plan(T, nq, n_kv, head_rows, 128)["chunks"] >= plan["chunks"]
    for start in list(range(S_rows + 1)) + [S_rows + 7]:
        covered = []
        for c, k0, k1 in _key_ranges(plan, start, S_rows):
            assert 0 <= c < plan["chunks"] and k0 < k1
            assert c * ch == k0 and k1 <= (c + 1) * ch
            covered.extend(range(k0, k1))
        assert covered == list(range(min(start, S_rows))), start


def _split_merge(q, kc, vc, kt, vt, tm, start, scale=None):
    """The bf16 kernel's arithmetic in plain f32 torch: one partial (row max m,
    row sum l, unnormalised acc) per prefix chunk below `start` and one for
    the tree's keys, merged in chunk order. `scale` defaults to d^-0.5 of
    q's width (a zero-padded q passes its true width's)."""
    T, nq, d = q.shape
    n_kv, S, _ = kc.shape
    g = nq // n_kv
    scale = d ** -0.5 if scale is None else scale
    qh = q.reshape(T, n_kv, g, d).permute(1, 2, 0, 3)                   # [h, g, T, d]
    plan = ak.tree_plan(T, nq, n_kv, S, 128)     # the grid does not depend on d
    parts = []
    for _, k0, k1 in _key_ranges(plan, start, S):
        parts.append((torch.einsum("hgtd,hsd->hgts", qh, kc[:, k0:k1]) * scale,
                      vc[:, k0:k1]))
    st = torch.einsum("hgtd,hsd->hgts", qh, kt.transpose(0, 1)) * scale
    parts.append((torch.where(tm[None, None], st, torch.tensor(ak.NEG_INF)),
                  vt.transpose(0, 1)))
    ms, ls, accs = [], [], []
    for s, v in parts:
        m = s.amax(-1, keepdim=True)
        p = torch.exp(s - m)
        ms.append(m)
        ls.append(p.sum(-1, keepdim=True))
        accs.append(torch.einsum("hgts,hsd->hgtd", p, v))
    M = torch.stack(ms).amax(0)
    w = [torch.exp(m - M) for m in ms]
    l = sum(wi * li for wi, li in zip(w, ls))
    o = sum(wi * ai for wi, ai in zip(w, accs)) / torch.clamp(l, min=1e-30)
    return o.permute(2, 0, 1, 3).reshape(T, nq * d)


@pytest.mark.parametrize("start", [0, 1, 255, 256, 257, 511, 600])
def test_split_merge_arithmetic_matches_jax(start):
    """Chunk partials and their merge give tree_attention_xla's output in f32.
    Tolerance rtol = atol = 1e-5: the sums run in another order (per chunk,
    then across chunks) and exp(s - m_c) * exp(m_c - M) rounds twice where
    exp(s - M) rounds once."""
    args = _inputs(13, 13, 8, 2, 32, 600, seed=start)
    want = np.asarray(pallas_attn.tree_attention_xla(
        *[jnp.asarray(a) for a in args], jnp.int32(start)))
    got = _split_merge(*[t(a) for a in args], start)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("start", [0, 255, 256, 700])
def test_head_dim_64_matches_jax_kernel(start):
    """B1 at the Llama-3.2-1B class's head layout (32 q / 8 kv heads,
    head_dim 64): the plain version and the bf16 kernel's split-and-merge
    arithmetic give the interpreted Pallas kernel's output and
    tree_attention_xla's in f32 (TOL; the split-and-merge sums in another
    order, rtol = atol = 1e-5 as above)."""
    args = _inputs(26, 26, 32, 8, 64, 768, seed=start)
    st = jnp.int32(start)
    jargs = [jnp.asarray(a) for a in args]
    want = np.asarray(pallas_attn.tree_attention_xla(*jargs, st))
    pallas = np.asarray(pallas_attn.tree_attention(*jargs, st, blk=64, interpret=True))
    targs = [t(a) for a in args]
    got = ak.tree_attention(*targs, torch.tensor(start))       # CPU → plain
    for ref in (want, pallas):
        np.testing.assert_allclose(got.numpy(), ref, **TOL)
    np.testing.assert_allclose(_split_merge(*targs, start).numpy(), want,
                               rtol=1e-5, atol=1e-5)


def test_tree_plan_takes_head_dims_64_and_128():
    """Every head_dim from 1 to 256 is taken (64 and 128 among them), at the
    smallest padded width of 64, 128 and 256 that holds it; the grid does
    not depend on it; past 256 the plan refuses before a launch."""
    base = ak.tree_plan(61, 32, 8, 2176, 128)
    assert ak.TREE_HEAD_PADS == (64, 128, 256) and ak.TREE_MAX_HEAD_DIM == 256
    for d in range(1, 257):
        plan = ak.tree_plan(61, 32, 8, 2176, d)
        pad = 64 if d <= 64 else 128 if d <= 128 else 256
        assert plan == dict(base, head_pad=pad), d
    for d in (0, 257, 512):
        with pytest.raises(ValueError, match="head_dim 1 .. 256"):
            ak.tree_plan(61, 32, 8, 2176, d)


@pytest.mark.parametrize("d,start", [(80, 300), (96, 0), (256, 520), (100, 257), (40, 600)])
def test_padded_head_widths_match_jax_kernel(d, start):
    """B1 at head widths the Llama-3.2-1B / Llama-3.1-8B pair does not use
    (80, 96: Phi / StableLM-class; 256: Gemma-2/3; 100 and 40, rows that are
    not whole 16-byte chunks in bf16): the plain version gives the
    interpreted Pallas kernel's output, and the kernel's arithmetic at the
    padded width (q, k and v zero-padded to `head_pad` columns, the true
    width's scale) gives tree_attention_xla's in its first d columns of
    each head (rtol = atol = 1e-5, the split-and-merge's sum order)."""
    args = _inputs(13, 13, 8, 2, d, 640, seed=d + start)
    st = jnp.int32(start)
    jargs = [jnp.asarray(a) for a in args]
    want = np.asarray(pallas_attn.tree_attention_xla(*jargs, st))
    pallas = np.asarray(pallas_attn.tree_attention(*jargs, st, blk=64, interpret=True))
    targs = [t(a) for a in args]
    got = ak.tree_attention(*targs, torch.tensor(start))       # CPU → plain
    for ref in (want, pallas):
        np.testing.assert_allclose(got.numpy(), ref, **TOL)
    pad = ak.tree_plan(13, 8, 2, 640, d)["head_pad"]
    padded = [torch.nn.functional.pad(a, (0, pad - d)) for a in targs[:5]]
    out = _split_merge(*padded, targs[5], start, scale=d ** -0.5)
    out = out.reshape(13, 8, pad)[..., :d].reshape(13, 8 * d)
    np.testing.assert_allclose(out.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("start,path,alen", [
    (20, [0, 3, 7, 7, 7, 7, 7], 3),      # repeats its last node: overlap
    (0, [0, 1, 2, 5, 9, 12, 14], 6),
    (41, [0, 0, 0, 0, 0, 0, 0], 0),
])
def test_compact_matches_jax(start, path, alen):
    rng = np.random.default_rng(4)
    L, n_kv, S, d = 3, 2, 64, 8
    k = rng.normal(size=(L, 1, n_kv, S, d)).astype(np.float32)
    v = rng.normal(size=(L, 1, n_kv, S, d)).astype(np.float32)
    P = len(path)
    jcache = JKVCache(k=jnp.asarray(k), v=jnp.asarray(v),
                      length=jnp.asarray([start], jnp.int32))
    jref = j_compact_accepted(jcache, jnp.asarray([path], jnp.int32),
                              jnp.asarray([alen], jnp.int32))
    jk, jv = pallas_attn.compact_rows(jnp.asarray(k), jnp.asarray(v),
                                      jnp.asarray(path, jnp.int32),
                                      jnp.int32(start), tree_size=16,
                                      interpret=True)
    # port: plain compaction, and the wrapper on CPU tensors (both in place)
    pcache = compact_accepted(KVCache(k=t(k), v=t(v), length=torch.tensor([start])),
                              torch.tensor([path]), torch.tensor([alen]))
    assert int(pcache.length[0]) == int(jref.length[0]) == start + alen
    wk, wv = t(k), t(v)
    ak.compact_rows(wk, wv, torch.tensor(path), torch.tensor(start))
    for got in ((pcache.k, pcache.v), (wk, wv)):
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(jref.k))
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(jref.v))
        # the Pallas kernel writes an 8-row padded window: rows past
        # start + 8 and below start + P are the defined ones
        for g, j in ((got[0], jk), (got[1], jv)):
            np.testing.assert_array_equal(g.numpy()[..., : start + P, :],
                                          np.asarray(j)[..., : start + P, :])
            np.testing.assert_array_equal(g.numpy()[..., start + 8:, :],
                                          np.asarray(j)[..., start + 8:, :])


def _compact_moving_rows_only(k, v, path, start):
    """csrc/compact_rows.cu's rule in plain torch: a row whose clamped source
    is its clamped destination is neither read nor written, every other row
    is read before any is written."""
    S, P = k.shape[3], len(path)
    dst0 = min(max(start, 0), S - P)
    moves = [(min(max(start + p, 0), S - 1), dst0 + i) for i, p in enumerate(path)]
    moves = [(s, d) for s, d in moves if s != d]
    for x in (k, v):
        rows = [x[:, :, :, s].clone() for s, _ in moves]
        for (_, d), r in zip(moves, rows):
            x[:, :, :, d] = r
    return len(moves)


@pytest.mark.parametrize("start,path,moved", [
    (20, [0, 3, 7, 7, 7, 7, 7], 6),
    (20, [0, 1, 2, 3, 4, 5, 6], 0),     # all identity
    (20, [0, 1, 2, 5, 9, 12, 14], 4),   # an identity prefix, then moves
    (20, [0], 0), (20, [5], 1),         # P = 1
    (60, [0, 3, 7, 7, 7, 7, 7], 6),     # the window clamps at the end (S = 64)
    (62, [0, 1, 2, 3, 4, 5, 6], 6),
    (-3, [0, 1, 2, 3], 3),              # and at the start
])
def test_compact_skipping_rows_in_place_is_exact(start, path, moved):
    """Leaving out the rows that are already in place gives the plain
    version's bytes, clamped windows included."""
    rng = np.random.default_rng(7)
    k = t(rng.normal(size=(2, 1, 2, 64, 8)).astype(np.float32))
    v = t(rng.normal(size=(2, 1, 2, 64, 8)).astype(np.float32))
    k2, v2 = k.clone(), v.clone()
    assert _compact_moving_rows_only(k, v, path, start) == moved
    ak.compact_rows(k2, v2, torch.tensor(path), torch.tensor(start))
    assert torch.equal(k, k2) and torch.equal(v, v2)


def test_wrappers_refuse_non_cuda_devices():
    """Tensors that are neither on the CPU nor on a CUDA device cannot take
    the plain path: the wrappers raise instead of falling back."""
    m = lambda *s: torch.empty(s, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        ak.tree_attention(m(4, 2, 8), m(1, 16, 8), m(1, 16, 8), m(4, 1, 8),
                          m(4, 1, 8), torch.empty(4, 4, dtype=torch.bool,
                                                  device="meta"), 3)
    with pytest.raises(ValueError, match="CUDA"):
        ak.compact_rows(m(2, 1, 1, 16, 8), m(2, 1, 1, 16, 8),
                        torch.zeros(3, dtype=torch.long, device="meta"), 2)
    assert ak.LAUNCHES["tree_attention"] == 0 and ak.LAUNCHES["compact_rows"] == 0


def test_kernel_build_raises_without_nvcc(monkeypatch, tmp_path):
    """Asking for a kernel where no CUDA toolkit exists raises; nothing is
    silently replaced by the plain version."""
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(_build, "NVCC_DEFAULT", str(tmp_path / "no-nvcc"))
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setattr(_build, "_LIBS", {})
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.load("tree_attention")


def test_cuda_sources_present_and_named():
    """Every CUDA source of the build is in the package and exposes the
    C entry point its wrapper binds."""
    import os
    assert _build.SOURCES == ("tree_attention", "compact_rows", "w4_matmul",
                              "score_topk", "w4_ablate")
    headers = sorted(n for n in os.listdir(_build.CSRC_DIR) if n.endswith(".cuh"))
    assert headers == ["ptx.cuh", "w4_mma.cuh"]
    for name in _build.SOURCES:
        path = os.path.join(_build.CSRC_DIR, name + ".cu")
        src = open(path).read()
        assert f'extern "C" int {name}_launch(' in src
        # the probe's kernel replaces a Pallas kernel under tools/
        assert ("Replaces: tools/probe_w4_ablate.py" if name == "w4_ablate"
                else "Replaces: eagle_tpu/ops/") in src
    assert 'extern "C" int w4_matmul_stacked_launch(' in open(
        os.path.join(_build.CSRC_DIR, "w4_matmul.cu")).read()
    assert 'extern "C" int score_topk_w8_launch(' in open(
        os.path.join(_build.CSRC_DIR, "score_topk.cu")).read()
    # B3/B4, B5 and B6 share one main loop
    for name in ("w4_matmul", "score_topk", "w4_ablate"):
        src = open(os.path.join(_build.CSRC_DIR, name + ".cu")).read()
        assert '#include "w4_mma.cuh"' in src and "w4_dot.cuh\"" not in src
    assert "w4mma::run<TL, VEC, Store<TL>, B>" in open(
        os.path.join(_build.CSRC_DIR, "w4_ablate.cu")).read()
