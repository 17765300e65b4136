"""The port's int4 (w4a8) path (eagle_tpu_torch/ops/quant4.py) against the JAX
package (eagle_tpu/ops/quant4.py) on the CPU: the same numpy inputs go through
both. Packers, unpackers, tree converters and the plain matmul `qdense4_ref`
are held to bit equality with the JAX package (tolerance: none); only the
Pallas kernel run through the interpreter gets a tolerance, stated below
with its reason."""

import dataclasses
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eagle_tpu.models import transformer as jtransformer
from eagle_tpu.ops import quant4 as jq4
from eagle_tpu.ops.kv_cache import init_cache as jinit_cache
from eagle_tpu.ops.masks import prefill_mask as jprefill_mask
from eagle_tpu_torch import convert, full_width
from eagle_tpu_torch.models import transformer
from eagle_tpu_torch.ops import _launch
from eagle_tpu_torch.ops import quant4 as tq4
from eagle_tpu_torch.ops.kv_cache import init_cache
from eagle_tpu_torch.ops.masks import prefill_mask

from test_engine_greedy import make_engine, tiny_cfg
from test_torch_quant import assert_trees_equal
from torch_port_util import np_tree, t

# qdense4_ref against the Pallas kernel in interpret mode. XLA's CPU backend
# compiles the interpreted kernel body as one program and contracts its
# `acc + corr * scale` into fused multiply-adds, so one product per group is
# not rounded there; qdense4_xla (separate XLA ops) and the port round every
# product, as the TPU kernel and the CUDA kernel do. The difference is a few
# f32 ulp of the largest partial sum; the JAX package's own test of the same
# pair (tests/test_quant4.py::test_pallas_kernel_matches_xla_path) uses this
# tolerance too.
INTERPRET_TOL = dict(rtol=1e-5, atol=1e-5)


def _pair(M, K, N, seed, blocks=1, group=128):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(M, K)).astype(np.float32)
    w = (rng.normal(size=(K, N)) * 0.1).astype(np.float32)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jqw = jq4.pack_w4(jnp.asarray(w), group, blocks)
        tqw = tq4.pack_w4(t(w), group, blocks)
    return x, w, jqw, tqw


def _same_packed(tqw, jqw):
    assert tqw["q4"].dtype == torch.int32 and tqw["scale"].dtype == torch.float32
    np.testing.assert_array_equal(tqw["q4"].numpy(), np.asarray(jqw["q4"]))
    np.testing.assert_array_equal(tqw["scale"].numpy(), np.asarray(jqw["scale"]))


@pytest.mark.parametrize("K,N,group,blocks", [
    (512, 384, 128, 1), (256, 100, 128, 1), (32, 64, 128, 1), (64, 40, 16, 1),
    (512, 96, 128, 2), (64, 48, 128, 4)])
def test_pack_w4_bit_equal(K, N, group, blocks):
    _, w, jqw, tqw = _pair(1, K, N, 0, blocks, group)
    _same_packed(tqw, jqw)
    _same_packed(tqw, jq4._pack_w4_host(w, group, blocks))
    assert tq4._k_of(tqw) == jq4._k_of(jqw) == K
    assert tq4._group_of(tqw) == jq4._group_of(jqw)
    assert tq4._blocks_of(tqw["q4"]) == blocks
    np.testing.assert_array_equal(tq4._nibbles_korder(tqw["q4"]).numpy(),
                                  np.asarray(jq4._nibbles_korder(jqw["q4"])))
    np.testing.assert_array_equal(tq4.unpack_w4(tqw).numpy(),
                                  np.asarray(jq4.unpack_w4(jqw)))


@pytest.mark.parametrize("blocks", [1, 2])
def test_pack_w4_stacked_bit_equal(blocks):
    rng = np.random.default_rng(1)
    w = (rng.normal(size=(3, 512, 40)) * 0.1).astype(np.float32)
    want = jq4._pack_w4_host(w, blocks=blocks)
    got = tq4.pack_w4(t(w), blocks=blocks)
    _same_packed(got, want)
    assert got["q4"].shape == ((3, 64, 40) if blocks == 1 else (3, 2, 32, 40))
    _same_packed(tq4.pack_w4(t(w[1]), blocks=blocks),
                 {k: v[1] for k, v in want.items()})


def test_pack_w4_words_cover_the_sign_bit_and_bf16_input():
    """A high nibble >= 8 in byte 3 makes a negative int32 word; bf16 weights
    are widened exactly as on the JAX side."""
    _, w, jqw, tqw = _pair(1, 256, 64, 2)
    assert (tqw["q4"] < 0).any()
    wb = jnp.asarray(w, jnp.bfloat16)
    _same_packed(tq4.pack_w4(t(w, torch.bfloat16)), jq4.pack_w4(wb))


def test_pack_w4_rejects_bad_k_and_eff_group():
    with pytest.raises(ValueError):
        tq4.pack_w4(torch.zeros(12, 4))
    with pytest.raises(ValueError):
        tq4.pack_w4(torch.zeros(32, 4), blocks=8)
    with pytest.raises(ValueError):
        tq4._eff_group(7, 128)
    for K, g in [(32, 128), (4096, 128), (14336, 128), (64, 16), (96, 128)]:
        assert tq4._eff_group(K, g) == jq4._eff_group(K, g)
    with pytest.warns(UserWarning, match="shrinks"):
        tq4.pack_w4(torch.zeros(256, 4), blocks=2)


@pytest.mark.parametrize("M,K,N,group,blocks,dtype,bias", [
    (5, 512, 384, 128, 1, "f32", True), (1, 256, 128, 128, 1, "f32", False),
    (33, 256, 640, 128, 1, "f32", False), (7, 64, 100, 16, 1, "f32", True),
    (9, 512, 96, 128, 2, "f32", False), (10, 256, 72, 128, 1, "bf16", True)])
def test_qdense4_ref_bit_equal_to_xla_path(M, K, N, group, blocks, dtype, bias):
    x, _, jqw, tqw = _pair(M, K, N, 3, blocks, group)
    b = np.random.default_rng(4).normal(size=(N,)).astype(np.float32) if bias else None
    jd, td = ((jnp.bfloat16, torch.bfloat16) if dtype == "bf16"
              else (jnp.float32, torch.float32))
    ref = jq4.qdense4_xla(jnp.asarray(x, jd), jqw, None if b is None else jnp.asarray(b))
    got = tq4.qdense4_ref(t(x, td), tqw, None if b is None else t(b))
    assert got.dtype == td
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(ref.astype(jnp.float32)))
    got32 = tq4.qdense4(t(x, td), tqw, out_dtype=torch.float32)   # CPU: the plain version
    ref32 = jq4.qdense4_xla(jnp.asarray(x, jd), jqw, out_dtype=jnp.float32)
    np.testing.assert_array_equal(got32.numpy(), np.asarray(ref32))
    # a leading batch axis flattens into M
    x3 = t(np.stack([x, x[::-1]]), td)
    np.testing.assert_array_equal(
        tq4.qdense4(x3, tqw, out_dtype=torch.float32)[0].numpy(), got32.numpy())


@pytest.mark.parametrize("M,K,N,blocks", [(5, 512, 384, 1), (1, 256, 128, 1),
                                          (33, 256, 640, 1), (6, 512, 128, 2)])
def test_qdense4_ref_close_to_interpreted_pallas_kernel(M, K, N, blocks):
    x, _, jqw, tqw = _pair(M, K, N, 5, blocks)
    y_pl = jq4.qdense4(jnp.asarray(x), jqw, out_dtype=jnp.float32, interpret=True)
    got = tq4.qdense4_ref(t(x), tqw, out_dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(y_pl), **INTERPRET_TOL)


def test_qdense4_stacked_ref_matches_jax_stacked():
    rng = np.random.default_rng(6)
    L, K, N = 3, 256, 384
    w = (rng.normal(size=(L, K, N)) * 0.1).astype(np.float32)
    x = rng.normal(size=(5, K)).astype(np.float32)
    jst = jq4._pack_w4_host(w)
    tst = tq4.pack_w4(t(w))
    for layer in range(L):
        got = tq4.qdense4_stacked(t(x), tq4.Stacked4(tst["q4"], tst["scale"], layer))
        one = {"q4": tst["q4"][layer], "scale": tst["scale"][layer]}
        assert torch.equal(got, tq4.qdense4_ref(t(x), one))
        # off the TPU the JAX call slices and takes qdense4_xla: bit-equal
        jw = jq4.Stacked4(jnp.asarray(jst["q4"]), jnp.asarray(jst["scale"]),
                          jnp.int32(layer))
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(jq4.qdense4_stacked(jnp.asarray(x), jw)))
        y_pl = jq4.qdense4_stacked(jnp.asarray(x), jw, interpret=True)
        np.testing.assert_allclose(got.numpy(), np.asarray(y_pl), **INTERPRET_TOL)


@pytest.mark.parametrize("blocks", [1, 2])
def test_rows_do_not_depend_on_m(blocks):
    """Row i of an M = 33 call equals the M = 1 call on that row, bitwise:
    what "int4 target == its own vanilla decode" rests on."""
    x, _, _, tqw = _pair(33, 512, 200, 7, blocks)
    full = tq4.qdense4_ref(t(x), tqw)
    for i in (0, 13, 32):
        assert torch.equal(full[i:i + 1], tq4.qdense4_ref(t(x[i:i + 1]), tqw))


def test_blocked_packing_is_bit_identical_when_the_group_is_the_same():
    x, w, _, tqw = _pair(6, 1024, 48, 8)
    blocked = tq4.pack_w4(t(w), blocks=2)        # (K/2)/2 = 256: group stays 128
    assert tq4._group_of(blocked) == tq4._group_of(tqw) == 128
    assert torch.equal(tq4.qdense4_ref(t(x), blocked), tq4.qdense4_ref(t(x), tqw))


@pytest.mark.parametrize("version", [1, 3])
def test_quantize_draft_params4_bit_equal(version):
    je = make_engine(version)
    for group in (128, 8):
        want = convert.draft_params(
            np_tree(jq4.quantize_draft_params4(je.dparams, group=group)), device="cpu")
        got = tq4.quantize_draft_params4(
            convert.draft_params(np_tree(je.dparams), device="cpu"), group=group)
        assert_trees_equal(got, want)
    assert got["layers"][0]["wqkv"]["q4"].dtype == torch.int32
    assert got["embed"]["w"].dtype == torch.float32


@pytest.mark.parametrize("tp,fuse", [(1, False), (1, True), (2, False)])
def test_quantize_target_params4_bit_equal(tp, fuse):
    je = make_engine(1)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jq = jq4.quantize_target_params4(je.params, group=16, tp=tp, fuse=fuse)
        got = tq4.quantize_target_params4(
            convert.target_params(np_tree(je.params), device="cpu"),
            group=16, tp=tp, fuse=fuse)
    want = convert.target_params(np_tree(jq), device="cpu")
    assert_trees_equal(got, want)
    L = je.cfg.num_layers
    if fuse:
        assert set(got["stacked4"]) == {"wqkv", "wo", "w_gateup", "w_down"}
    elif tp == 2:
        assert set(got["stacked4"]) == {"wq", "wk", "wv", "w_gate", "w_up"}
        assert got["layers"][0]["wo"]["q4"].ndim == 3
    else:
        assert set(got["stacked4"]) == {"wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"}
    assert got["stacked4"]["w_down"if tp == 1 else "wq"]["q4"].shape[0] == L
    with pytest.raises(ValueError):
        tq4.quantize_target_params4(got, fuse=True, tp=2)


def _logits(params, cfg, tokens):
    T = tokens.shape[1]
    cache = init_cache(cfg.num_layers, 1, cfg.num_kv_heads, 64, cfg.head_dim,
                       dtype=torch.float32, device="cpu")
    res = transformer.forward(params, cfg, t(tokens), cache, torch.arange(T)[None],
                              prefill_mask(T, 64, cache.length))
    return transformer.lm_head(params, cfg, res.hidden)


@pytest.mark.parametrize("tp", [1, 2])
def test_int4_target_forward_fused_and_blocked_bit_identical(tp):
    """fuse=True (wqkv, w_gateup: 4 calls per layer instead of 7) and the
    blocked tp layout give the unfused tp=1 logits bit for bit; and those
    equal the JAX forward's within the tolerance of a 4-layer fp32 model."""
    je = make_engine(3)
    cfg = convert.model_config(je.cfg)
    params = convert.target_params(np_tree(je.params), device="cpu")
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, (1, 8))
    # group 8 divides (K/tp)/2 for every K here, so tp=2 keeps the groups
    base = _logits(tq4.quantize_target_params4(params, group=8), cfg, tokens)
    other = tq4.quantize_target_params4(params, group=8, tp=tp, fuse=(tp == 1))
    assert ("wqkv" in other["stacked4"]) == (tp == 1)
    assert ("wo" in other["layers"][0]) == (tp == 2)
    assert torch.equal(_logits(other, cfg, tokens), base)
    jqp = jq4.quantize_target_params4(je.params, group=8)
    jc = jinit_cache(cfg.num_layers, 1, cfg.num_kv_heads, 64, cfg.head_dim,
                     dtype=jnp.float32)
    jres = jtransformer.forward(jqp, je.cfg, jnp.asarray(tokens, jnp.int32), jc,
                                jnp.arange(8, dtype=jnp.int32)[None],
                                jprefill_mask(8, 64, jc.length))
    jlog = np.asarray(jtransformer.lm_head(jqp, je.cfg, jres.hidden))
    # fp32 attention/softmax sums run in another order on the two sides; where
    # that moves an activation across an int8 rounding boundary, the row's
    # quantized value steps by 1/127 of its largest entry, so single logits
    # (|logit| ~ 0.1) may differ by a few 1e-3 while most agree closely
    diff = np.abs(base.numpy() - jlog)
    assert diff.max() < 5e-3 and np.median(diff) < 1e-6


def test_layerwise_device_packer_matches_quantizing_the_float_tree():
    """full_width.int4_target_params packs each layer as it is made; it gives
    the words and scales of quantize_target_params4 over init_params."""
    cfg = dataclasses.replace(convert.model_config(tiny_cfg()), dtype=torch.bfloat16)
    got = full_width.int4_target_params(cfg, device="cpu")
    ref = transformer.init_params(cfg, seed=full_width.SEED, device="cpu")
    ref["lm_head"].mul_(full_width.LM_HEAD_SHARPEN)
    assert_trees_equal(got, tq4.quantize_target_params4(ref))
    assert got["stacked4"]["w_down"]["q4"].shape == (4, 8, 32)


def test_wrappers_refuse_non_cuda_devices():
    """Neither CPU nor CUDA: the wrappers raise instead of taking the plain
    version, and count no launch."""
    before = dict(_launch.LAUNCHES)
    x = torch.empty((2, 64), device="meta")
    qw = {"q4": torch.empty((8, 16), dtype=torch.int32, device="meta"),
          "scale": torch.empty((2, 16), device="meta")}
    with pytest.raises(ValueError, match="CUDA"):
        tq4.qdense4(x, qw)
    st = tq4.Stacked4(qw["q4"][None], qw["scale"][None], 0)
    with pytest.raises(ValueError, match="CUDA"):
        tq4.qdense4_stacked(x, st)
    assert _launch.LAUNCHES == before


# ---------------------------------------------------------------------------
# the launch plan of kernels B3/B4 (csrc/w4_matmul.cu), from shapes alone
# ---------------------------------------------------------------------------

# (K, N) of every w4a8 product of the int4 serving path: target q/o, k/v,
# gate/up, down, lm_head; draft wqkv, gate|up, fc
MAIN_W4_SHAPES = [(4096, 4096), (4096, 1024), (4096, 14336), (14336, 4096),
                  (4096, 128256), (8192, 6144), (4096, 28672), (12288, 4096)]


@pytest.mark.parametrize("M", [1, 10, 61, 1024])
def test_w4_plan_covers_n_fits_shared_memory_and_fills_the_card(M):
    for K, N in MAIN_W4_SHAPES:
        G = K // tq4.GROUP
        plan = tq4.w4_plan(M, K, N, G, 1)
        rt, ct, ranks = plan.grid
        assert (ct - 1) * plan.ntile < N <= ct * plan.ntile
        assert (rt - 1) * tq4.W4_BM < M <= rt * tq4.W4_BM
        assert plan.vec and not plan.short_groups and plan.steps_per_group == 4
        assert rt * ct * ranks >= tq4.SM_COUNT, (K, N, plan)
        assert plan.smem <= tq4.W4_SMEM_MAX and plan.split == (ranks == 2)
        assert not plan.split or plan.ntile == 8      # the kernel splits 8 columns only
    for K in (4096, 8192, 12288, 14336):
        assert tq4._w4_smem(64, K // tq4.GROUP // 2, False) <= 227 * 1024


def test_w4_plan_reaches_every_kernel_instantiation():
    """The card tests' shapes (tests/test_torch_cuda_kernels.W4_TILE_CASES)
    make w4_plan pick each instantiation of csrc/w4_matmul.cu: every column
    tile with 16-byte and with 4-byte copies, and the cluster split."""
    from test_torch_cuda_kernels import W4_TILE_CASES

    picked = set()
    for M, K, N, group, blocks, want in W4_TILE_CASES:
        G = K // tq4._eff_group(K // blocks, group)
        plan = tq4.w4_plan(M, K, N, G, blocks)
        assert (plan.ntile, plan.split, plan.vec) == want, (M, K, N, group, plan)
        picked.add(want)
    assert picked == {(n, False, v) for n in tq4.W4_NTILES for v in (True, False)} | {
        (8, True, True), (8, True, False)}


@pytest.mark.parametrize("K,group,short,steps,vec", [
    (64, 16, True, 1, True),       # group 16: half of a k32 step is zero
    (32, 128, True, 1, True),      # K = 32: the group shrinks to 16
    (96, 48, True, 2, True),       # group 48: a step and a half
    (96, 12, True, 1, False),      # group 12: 4-byte copies
    (4096, 32, False, 1, True),
    (4096, 256, False, 8, True),   # two stages per group
    (512, 128, False, 4, True)])
def test_w4_plan_marks_groups_shorter_than_a_step(K, group, short, steps, vec):
    g = tq4._eff_group(K, group)
    plan = tq4.w4_plan(7, K, 64, K // g, 1)
    assert (plan.short_groups, plan.steps_per_group, plan.vec) == (short, steps, vec)
