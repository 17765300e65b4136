"""The port's slice as a whole (eagle_tpu_torch/engine/engine.py) on the JAX
package's tiny engine configs: converted parameters, greedy tokens equal to
the JAX engine's with both Pallas kernels on (interpreted), and the port's
own invariant, greedy speculative == vanilla. CPU, fp32."""

import dataclasses

import numpy as np
import pytest

from eagle_tpu.engine.engine import EagleEngine as JEngine
from eagle_tpu_torch.config import EngineConfig
from eagle_tpu_torch.engine.engine import EagleEngine

from test_engine_greedy import PROMPT, make_engine
from torch_port_util import port_engine

PROMPT2 = np.array([77, 3, 3, 120, 9, 64, 31, 2, 100, 45, 6], np.int32)


def _jax_kernel_engine(version, **kw):
    je = make_engine(version, compact_impl="pallas", **kw)
    return JEngine(je.params, dataclasses.replace(je.cfg, attn_impl="pallas_tree"),
                   je.dparams, je.dcfg, je.ecfg)


@pytest.mark.parametrize("version", [1, 3])
def test_port_tokens_equal_jax_engine_with_kernels(version):
    je = _jax_kernel_engine(version)
    pe = port_engine(je)
    assert pe.cfg.attn_impl == "pallas_tree" and pe.ecfg.compact_impl == "pallas"
    for prompt in (PROMPT, PROMPT2):
        jref = je.generate(prompt, max_new_tokens=32)
        np.testing.assert_array_equal(pe.generate(prompt, max_new_tokens=32), jref)
        np.testing.assert_array_equal(pe.generate_fused(prompt, max_new_tokens=32), jref)


@pytest.mark.parametrize("version,draft_vocab,kernels", [
    (1, 0, True), (3, 0, True), (3, 64, True), (3, 64, False), (1, 0, False)])
def test_port_greedy_equals_port_vanilla(version, draft_vocab, kernels):
    je = make_engine(version, draft_vocab=draft_vocab, seed=version + draft_vocab)
    kw = dict(attn_impl="pallas_tree", compact_impl="pallas") if kernels else {}
    pe = port_engine(je, **kw)
    for prompt in (PROMPT, PROMPT2):
        ref = pe.generate_vanilla(prompt, max_new_tokens=32)
        np.testing.assert_array_equal(pe.generate(prompt, max_new_tokens=32), ref)
        out, n, rounds = pe.generate_fused(prompt, max_new_tokens=32, log=True)
        np.testing.assert_array_equal(out, ref)
        assert rounds >= 1 and n >= 32
    np.testing.assert_array_equal(
        pe.generate_vanilla(PROMPT, max_new_tokens=32, fused=True),
        pe.generate_vanilla(PROMPT, max_new_tokens=32))


def test_port_eos_stop_matches_vanilla():
    je = make_engine(1)
    pe = port_engine(je, attn_impl="pallas_tree", compact_impl="pallas")
    ref = pe.generate_vanilla(PROMPT2, max_new_tokens=40)
    eos = int(ref[len(PROMPT2) + 9])
    a = pe.generate_vanilla(PROMPT2, max_new_tokens=40, eos_token_id=eos)
    b = pe.generate(PROMPT2, max_new_tokens=40, eos_token_id=eos)
    np.testing.assert_array_equal(a, b)
    pe.eos_token_id = eos   # device-side finish in the fused loop
    np.testing.assert_array_equal(pe.generate_fused(PROMPT2, max_new_tokens=40), a)


def test_port_forced_replay():
    pe = port_engine(make_engine(1), attn_impl="pallas_tree", compact_impl="pallas")
    free, n_free, r_free = pe.generate_fused(PROMPT, max_new_tokens=24, log=True)
    full = pe.generate_vanilla(PROMPT, max_new_tokens=64)
    out, n, rounds, live = pe.generate_fused(PROMPT, max_new_tokens=24, log=True,
                                             force_tokens=full)
    np.testing.assert_array_equal(out, free)
    assert rounds == r_free and live == n
    # a corrupted reference is followed, not the live target
    ref = full.copy()
    flip = len(PROMPT) + 5
    ref[flip] = (ref[flip] + 1) % pe.cfg.vocab_size
    out2, _, _, live2 = pe.generate_fused(PROMPT, max_new_tokens=24, log=True,
                                          force_tokens=ref)
    np.testing.assert_array_equal(out2, ref[: len(out2)])
    assert live2 < n
    with pytest.raises(ValueError):   # too short
        pe.generate_fused(PROMPT, max_new_tokens=60, force_tokens=full[:30])
    bad = full.copy()
    bad[0] += 1
    with pytest.raises(ValueError):   # prompt mismatch
        pe.generate_fused(PROMPT, max_new_tokens=8, force_tokens=bad)


def test_port_capacity_stop_matches_jax():
    """A budget larger than the cache: both engines stop at the same length
    (the _tgt_len/_tail formulas are kept as they are)."""
    je = _jax_kernel_engine(1)
    je = JEngine(je.params, je.cfg, je.dparams, je.dcfg,
                 dataclasses.replace(je.ecfg, max_len=64))
    pe = port_engine(je)
    jout, jn, jr = je.generate_fused(PROMPT, max_new_tokens=200, log=True)
    out, n, r = pe.generate_fused(PROMPT, max_new_tokens=200, log=True)
    assert pe._tgt_len() == je._tgt_len() and pe._tail == je._tail
    assert (n, r) == (int(jn), int(jr))
    np.testing.assert_array_equal(out, jout)


@pytest.mark.parametrize("change,error", [
    (dict(kv_quant="int4"), ValueError),
    (dict(draft_quant="int7"), ValueError),
    (dict(acceptance="bogus"), ValueError)])
def test_unported_engine_options_raise(change, error):
    """An unknown value of a ported option (kv_quant, draft_quant,
    acceptance) raises ValueError as in JAX. (kv_quant, kv_buckets,
    tree_paths and temperature are ported: tests/test_torch_kv_int8.py,
    test_torch_kv_buckets.py, test_torch_static_tree.py,
    test_torch_engine_sampled.py.)"""
    je = make_engine(1)
    with pytest.raises(error):
        port_engine(je, **change)


def test_unported_entry_points_raise():
    pe = port_engine(make_engine(1))
    with pytest.raises(NotImplementedError):
        pe.generate_batch([PROMPT, PROMPT])
    with pytest.raises(NotImplementedError):
        pe.generate_batch_fused([PROMPT, PROMPT])
    window = dataclasses.replace(pe.cfg, sliding_window=16)
    with pytest.raises(NotImplementedError):
        EagleEngine(pe.params, window, pe.dparams, pe.dcfg, EngineConfig(), device="cpu")
    with pytest.raises(NotImplementedError):
        EagleEngine(pe.params, pe.cfg, pe.dparams, pe.dcfg, EngineConfig(),
                    sp_mesh=object(), device="cpu")
    moe = dataclasses.replace(pe.cfg, num_experts=4, experts_per_token=2)
    with pytest.raises(NotImplementedError):
        EagleEngine(pe.params, moe, pe.dparams, pe.dcfg, EngineConfig(),
                    device="cpu")
