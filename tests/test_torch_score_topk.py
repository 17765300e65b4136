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
