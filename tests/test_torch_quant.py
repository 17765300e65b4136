"""The port's int8 path (eagle_tpu_torch/ops/quant.py) against the JAX package
(eagle_tpu/ops/quant.py) on the CPU: the same numpy inputs go through both.
Quantizers and the dense product are integer-exact up to the final f32
rescale, which both sides compute in the same order: everything here is held
to bit equality (tolerance: none)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eagle_tpu.ops import quant as jq
from eagle_tpu_torch import convert
from eagle_tpu_torch.ops import quant as tq

from test_engine_greedy import make_engine
from torch_port_util import np_tree, t


def _same(a, b):
    a = a.float().numpy() if a.dtype == torch.bfloat16 else a.numpy()
    np.testing.assert_array_equal(a, np.asarray(b, a.dtype))


def assert_trees_equal(port, jax_tree):
    """A port tree equals the conversion of a JAX tree, leaf for leaf, in
    type and in bits."""
    if isinstance(port, dict):
        assert set(port) == set(jax_tree), (set(port), set(jax_tree))
        for k in port:
            assert_trees_equal(port[k], jax_tree[k])
    elif isinstance(port, (list, tuple)):
        assert len(port) == len(jax_tree)
        for a, b in zip(port, jax_tree):
            assert_trees_equal(a, b)
    else:
        assert port.dtype == jax_tree.dtype, (port.dtype, jax_tree.dtype)
        assert torch.equal(port, jax_tree)


@pytest.mark.parametrize("shape,dtype", [((5, 256), np.float32), ((1, 64), np.float32),
                                         ((3, 7, 96), np.float32), ((10, 128), "bf16")])
def test_quantize_rows_bit_equal(shape, dtype):
    x = np.random.default_rng(0).normal(size=shape).astype(np.float32)
    x[..., 0, :] = 0.0                                   # an all-zero row: the 1e-12 floor
    jx = jnp.asarray(x, jnp.bfloat16 if dtype == "bf16" else jnp.float32)
    tx = t(x, torch.bfloat16 if dtype == "bf16" else torch.float32)
    jxq, jsx = jq.quantize_rows(jx)
    xq, sx = tq.quantize_rows(tx)
    assert xq.dtype == torch.int8 and sx.dtype == torch.float32
    _same(xq, jxq)
    _same(sx, jsx)


@pytest.mark.parametrize("stacked", [False, True])
def test_quantize_linear_bit_equal(stacked):
    rng = np.random.default_rng(1)
    w = (rng.normal(size=(3, 64, 48) if stacked else (64, 48)) * 0.1).astype(np.float32)
    w[..., :, 5] = 0.0                                   # an all-zero column
    ref = jq._quantize_linear_host(w) if stacked else jq.quantize_linear(jnp.asarray(w))
    got = tq.quantize_linear(t(w))
    assert got["q8"].dtype == torch.int8 and got["scale"].dtype == torch.float32
    _same(got["q8"], ref["q8"])
    _same(got["scale"], ref["scale"])


@pytest.mark.parametrize("M,K,N,dtype,bias", [
    (5, 256, 96, "f32", True), (1, 64, 40, "f32", False), (33, 128, 200, "bf16", True)])
def test_qdense_bit_equal(M, K, N, dtype, bias):
    rng = np.random.default_rng(2)
    x = rng.normal(size=(M, K)).astype(np.float32)
    w = (rng.normal(size=(K, N)) * 0.1).astype(np.float32)
    b = rng.normal(size=(N,)).astype(np.float32) if bias else None
    jd, td = ((jnp.bfloat16, torch.bfloat16) if dtype == "bf16"
              else (jnp.float32, torch.float32))
    jqw = jq.quantize_linear(jnp.asarray(w))
    tqw = tq.quantize_linear(t(w))
    ref = jq.qdense(jnp.asarray(x, jd), jqw, None if b is None else jnp.asarray(b))
    got = tq.qdense(t(x, td), tqw, None if b is None else t(b))
    assert got.dtype == td
    _same(got, np.asarray(ref.astype(jnp.float32)))
    ref32 = jq.qdense(jnp.asarray(x, jd), jqw, out_dtype=jnp.float32)
    got32 = tq.qdense(t(x, td), tqw, out_dtype=torch.float32)
    assert got32.dtype == torch.float32
    _same(got32, ref32)


def test_int8_matmul_exact_at_the_edge():
    """All-(+-127) rows at K = 4096: |dot| = 127 * 127 * 4096 > 2**24, where a
    single fp32 dot rounds. The chunked product is exact."""
    K, N = 4096, 8
    xq = torch.full((3, K), 127, dtype=torch.int8)
    xq[1] = -127
    xq[2, ::2] = -127
    q8 = torch.full((K, N), 127, dtype=torch.int8)
    q8[:, 1] = -127
    q8[1::2, 2] = 126
    want = xq.to(torch.int64) @ q8.to(torch.int64)
    got = tq.int8_matmul(xq, q8)
    assert got.dtype == torch.int32
    assert torch.equal(got.to(torch.int64), want)
    assert int(want[0, 0]) == 127 * 127 * 4096 > 2 ** 24
    # the single fp32 dot this guards against is indeed off
    odd = xq.clone()
    odd[0, 0] = 126
    single = (odd.float() @ q8.float()).to(torch.int64)
    assert not torch.equal(single, odd.to(torch.int64) @ q8.to(torch.int64))
    assert torch.equal(tq.int8_matmul(odd, q8).to(torch.int64),
                       odd.to(torch.int64) @ q8.to(torch.int64))


@pytest.mark.parametrize("version", [1, 3])
def test_quantize_draft_params_bit_equal(version):
    je = make_engine(version)                            # fused by the engine
    want = convert.draft_params(np_tree(jq.quantize_draft_params(je.dparams)),
                                device="cpu")
    got = tq.quantize_draft_params(convert.draft_params(np_tree(je.dparams),
                                                        device="cpu"))
    assert_trees_equal(got, want)
    assert got["layers"][0]["wqkv"]["q8"].dtype == torch.int8


def test_quantize_target_params_bit_equal():
    je = make_engine(1)
    want = convert.target_params(np_tree(jq.quantize_target_params(je.params)),
                                 device="cpu")
    got = tq.quantize_target_params(convert.target_params(np_tree(je.params),
                                                          device="cpu"))
    assert_trees_equal(got, want)
    assert got["layers"][2]["w_down"]["q8"].dtype == torch.int8
    assert got["lm_head"]["scale"].dtype == torch.float32
    # idempotent on a quantized tree, as on the JAX side
    assert_trees_equal(tq.quantize_target_params(got), want)
    with pytest.raises(NotImplementedError):
        tq.quantize_target_params({"layers": [{"we_gate": torch.zeros(2, 8, 8)}]})


def test_convert_keeps_quantized_leaves_bit_for_bit():
    """int8 weights stay int8, packed words int32, scales float32 even when
    the float leaves are cast; index leaves still widen to int64."""
    rng = np.random.default_rng(3)
    q8 = rng.integers(-127, 128, (2, 8, 6)).astype(np.int8)
    q4 = rng.integers(-2 ** 31, 2 ** 31, (2, 4, 6)).astype(np.int32)
    sc = rng.random((2, 6)).astype(np.float32)
    jparams = {"embed": {"w": rng.normal(size=(5, 4)).astype(np.float32)},
               "final_norm": np.ones(4, np.float32),
               "layers": {"ln1": np.ones((2, 4), np.float32),
                          "wq": {"q8": q8, "scale": sc},
                          "wo": {"q4": q4, "scale": np.stack([sc, sc], 1)}},
               "lm_head": {"q8": q8[0], "scale": sc[0]}}
    p = convert.target_params(jparams, dtype=torch.bfloat16, device="cpu")
    assert p["embed"]["w"].dtype == torch.bfloat16
    for i in range(2):
        lp = p["layers"][i]
        assert lp["wq"]["q8"].dtype == torch.int8 and lp["wq"]["scale"].dtype == torch.float32
        np.testing.assert_array_equal(lp["wq"]["q8"].numpy(), q8[i])
        np.testing.assert_array_equal(lp["wq"]["scale"].numpy(), sc[i])
        assert "wo" not in lp
    st = p["stacked4"]["wo"]
    assert st["q4"].dtype == torch.int32 and st["scale"].dtype == torch.float32
    np.testing.assert_array_equal(st["q4"].numpy(), q4)
    np.testing.assert_array_equal(p["lm_head"]["q8"].numpy(), q8[0])
    d = convert.draft_params({"layers": [{"wq": {"q4": q4[0], "scale": sc}}],
                              "d2t": np.arange(3, dtype=np.int32)},
                             dtype=torch.bfloat16, device="cpu")
    assert d["layers"][0]["wq"]["q4"].dtype == torch.int32
    assert d["layers"][0]["wq"]["scale"].dtype == torch.float32
    assert d["d2t"].dtype == torch.long
