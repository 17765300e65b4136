"""Kernel B6's plain version (eagle_tpu_torch/ops/w4_ablate.ablate_ref)
against the Pallas probe kernel tools/probe_w4_ablate.py:make_kernel, run in
interpret mode on the CPU at a small size, for all nine modes. The same
numpy inputs go to both sides.

Tolerance: rtol = atol = 1e-5. Both sides sum the same f32 terms in the same
order, but XLA's CPU backend may contract the interpreted kernel's
`acc + corr * scale` into fused multiply-adds (as found for B3). `no_dots`
sums integers and is held exactly."""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from eagle_tpu_torch.ops import _launch
from eagle_tpu_torch.ops import w4_ablate as wa

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
K, N, M, GROUP = 256, 128, 8, 32


@pytest.fixture(scope="module")
def probe():
    """tools/probe_w4_ablate.py loaded by path (tools/ is no package), with
    its module globals set to the small size. The compilation-cache setting it
    makes at import is put back."""
    cache_dir = jax.config.jax_compilation_cache_dir
    spec = importlib.util.spec_from_file_location(
        "probe_w4_ablate_jax", os.path.join(ROOT, "tools", "probe_w4_ablate.py"))
    mod = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(mod)
    finally:
        jax.config.update("jax_compilation_cache_dir", cache_dir)
    mod.K, mod.N, mod.M = K, N, M
    return mod


def _inputs(mode, seed=0):
    rng = np.random.default_rng(seed)
    xq = rng.integers(-127, 128, (M, K)).astype(np.int8)
    G = K // GROUP
    rs = (8 * xq.reshape(M, G, GROUP).astype(np.int32).sum(axis=2)).astype(np.int32)
    if mode in wa.I32_MODES:
        p = rng.integers(-2**31, 2**31, (K // 8, N)).astype(np.int32)
    else:
        p = rng.integers(0, 256, (K // 2, N)).astype(np.uint8)
    s = rng.uniform(1e-3, 2e-3, (G, N)).astype(np.float32)
    return xq, rs, p, s


@pytest.mark.parametrize("mode", wa.MODES)
def test_ablate_ref_equals_pallas_probe_kernel(probe, mode):
    xq, rs, p, s = _inputs(mode, seed=wa.MODES.index(mode))
    ref = pl.pallas_call(
        probe.make_kernel(mode, GROUP),
        out_shape=jax.ShapeDtypeStruct((M, N), jnp.float32), interpret=True,
    )(jnp.asarray(xq), jnp.asarray(rs), jnp.asarray(p), jnp.asarray(s))
    got = wa.ablate_ref(mode, *(torch.from_numpy(a) for a in (xq, rs, p, s)), GROUP)
    assert got.dtype == torch.float32 and tuple(got.shape) == (M, N)
    if mode == "no_dots":
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    else:
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
    assert float(np.abs(np.asarray(ref)).max()) > 0


def test_modes_relate_as_documented():
    """bf16_dots == full and batched_dot == i32_storage bit for bit (same
    terms, same order); the i32 layout is pack_w4's (byte b of word w = byte
    row 4w + b), so i32_storage on the re-laid bytes == full; fused_unpack
    differs from full only by its sum order; on the CPU the wrapper takes the
    plain version."""
    xq, rs, p8, s = (torch.from_numpy(a) for a in _inputs("full", seed=3))
    full = wa.ablate_ref("full", xq, rs, p8, s, GROUP)
    assert torch.equal(wa.ablate_ref("bf16_dots", xq, rs, p8, s, GROUP), full)
    words = (p8.reshape(K // 8, 4, N).transpose(1, 2).contiguous()
             .view(torch.int32).squeeze(-1))
    i32 = wa.ablate_ref("i32_storage", xq, rs, words, s, GROUP)
    assert torch.equal(i32, full)
    assert torch.equal(wa.ablate_ref("batched_dot", xq, rs, words, s, GROUP), i32)
    fused = wa.ablate_ref("fused_unpack", xq, rs, words, s, GROUP)
    torch.testing.assert_close(fused, full, rtol=1e-5, atol=1e-5)
    assert torch.equal(wa.ablate_ref("one_dot_bf16", xq, rs, p8, s, GROUP),
                       wa.ablate_ref("one_dot", xq, rs, p8, s, GROUP))
    before = dict(_launch.LAUNCHES)
    assert torch.equal(wa.ablate("full", xq, rs, p8, s, GROUP), full)
    assert _launch.LAUNCHES == before          # the plain version counts nothing
    # dots8 of the probe's docstring: `full` with one group per half
    one_group = wa.ablate_ref("full", xq, rs[:, :2].contiguous(), p8,
                              s[:2].contiguous(), K // 2)
    assert tuple(one_group.shape) == (M, N)


def test_ablate_rejects_bad_input():
    xq, rs, p8, s = (torch.from_numpy(a) for a in _inputs("full"))
    with pytest.raises(ValueError, match="unknown mode"):
        wa.ablate("dots8", xq, rs, p8, s, GROUP)
    with pytest.raises(ValueError, match="unknown mode"):
        wa.ablate_ref("dots8", xq, rs, p8, s, GROUP)
    assert set(f"w4_ablate.{m}" for m in wa.MODES) <= set(_launch.LAUNCHES)
