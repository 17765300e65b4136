"""Length-bucketed decode reads (`EngineConfig.kv_buckets`) in the port
against the JAX package: slice_rows / merge_rows, the bucket formula, and
engines whose generation crosses a bucket edge: tokens equal to the JAX
engine's, to the unbucketed engine's, and bucketed speculative == bucketed
vanilla bit for bit. CPU, fp32."""

import numpy as np
import pytest
import torch

from eagle_tpu.config import EngineConfig as JEngineConfig
from eagle_tpu.engine.engine import EagleEngine as JEngine
from eagle_tpu_torch.ops.kv_cache import (init_cache, merge_rows, merge_rows_window,
                                          slice_rows)

from test_engine_greedy import PROMPT, make_engine
from torch_port_util import port_engine

BUCKETS = (64, 128)


def _bucketed_jax(je, **kw):
    ecfg = JEngineConfig(total_tokens=15, depth=3, top_k=4, max_len=256,
                         kv_buckets=BUCKETS, **kw)
    return JEngine(je.params, je.cfg, je.dparams, je.dcfg, ecfg)


@pytest.mark.parametrize("kv_quant", ["none", "int8"])
def test_slice_rows_is_a_view_and_merge_copies_nothing(kv_quant):
    full = init_cache(2, 1, 2, 32, 8, dtype=torch.float32, device="cpu",
                      kv_quant=kv_quant)
    small = slice_rows(full, 16)
    assert small.max_len == 16 and small.k.data_ptr() == full.k.data_ptr()
    assert (small.ks is None) == (kv_quant == "none")
    small.k[:, :, :, 3] = 7                      # a write through the view
    assert bool((full.k[:, :, :, 3] == 7).all())
    grown = small._replace(length=small.length + 5)
    for merged in (merge_rows(full, grown, 16),
                   merge_rows_window(full, grown, full.length, 4)):
        assert merged.k is full.k and merged.v is full.v and merged.ks is full.ks
        assert merged.max_len == 32 and int(merged.length[0]) == 5
    stranger = init_cache(2, 1, 2, 16, 8, dtype=torch.float32, device="cpu",
                          kv_quant=kv_quant)
    with pytest.raises(ValueError, match="view"):
        merge_rows(full, stranger, 16)


def test_bucket_formula_matches_jax():
    je = _bucketed_jax(make_engine(1))
    pe = port_engine(je)
    assert pe._kv_buckets() == je._kv_buckets() == (64, 128, je._tgt_len())
    for length in (0, 7, 31, 32, 33, 95, 96, 97, 200):
        assert pe._bucket_index(length, pe._kv_buckets()) == int(
            je._bucket_index(np.int32(length), je._kv_buckets())), length
    assert port_engine(make_engine(1))._kv_limit(50) is None
    # a bucket at or above the full size is dropped
    assert port_engine(make_engine(1), kv_buckets=(64, 4096))._kv_buckets() == (
        64, pe._tgt_len())


@pytest.mark.parametrize("version,kernels", [(1, False), (3, True)])
def test_bucketed_tokens_equal_jax_unbucketed_and_vanilla(version, kernels, monkeypatch):
    je0 = make_engine(version, compact_impl="pallas" if kernels else "xla")
    je = _bucketed_jax(je0, compact_impl=je0.ecfg.compact_impl)
    kw = dict(attn_impl="pallas_tree") if kernels else {}
    pe, pe0 = port_engine(je, **kw), port_engine(je0, **kw)
    used = []
    limit_of = pe._kv_limit
    monkeypatch.setattr(pe, "_kv_limit", lambda n: used.append(limit_of(n)) or used[-1])

    jref = je.generate_fused(PROMPT, max_new_tokens=48)
    out = pe.generate_fused(PROMPT, max_new_tokens=48)
    np.testing.assert_array_equal(out, jref)
    # 7 prompt + 48 new + tree and commit window: the 64-row bucket is left
    assert used[0] == 64 and used[-1] == 128 and sorted(set(used)) == [64, 128]
    np.testing.assert_array_equal(out, pe0.generate_fused(PROMPT, max_new_tokens=48))

    used.clear()
    van_b = pe.generate_vanilla(PROMPT, max_new_tokens=48, fused=True)
    assert sorted(set(used)) == [64, 128]
    np.testing.assert_array_equal(van_b, out)          # bit for bit, same length
    np.testing.assert_array_equal(
        van_b, np.asarray(je.generate_vanilla(PROMPT, max_new_tokens=48, fused=True)))
    np.testing.assert_array_equal(
        van_b, pe0.generate_vanilla(PROMPT, max_new_tokens=48, fused=True))
    # the per-round and per-token host loops stay unbucketed, as in JAX
    used.clear()
    np.testing.assert_array_equal(pe.generate(PROMPT, max_new_tokens=48), out)
    np.testing.assert_array_equal(pe.generate_vanilla(PROMPT, max_new_tokens=48), out)
    assert used == []


def test_bucketed_forced_replay_and_eos():
    je = _bucketed_jax(make_engine(1))
    pe = port_engine(je)
    full = pe.generate_vanilla(PROMPT, max_new_tokens=80, fused=True)
    out, n, rounds, live = pe.generate_fused(PROMPT, max_new_tokens=48, log=True,
                                             force_tokens=full)
    np.testing.assert_array_equal(out, full[: len(out)])
    assert live == n and rounds >= 1
    pe.eos_token_id = int(full[len(PROMPT) + 20])
    cut = pe.generate_fused(PROMPT, max_new_tokens=48)
    assert cut[-1] == pe.eos_token_id and len(cut) <= len(PROMPT) + 21
    np.testing.assert_array_equal(cut, full[: len(cut)])
