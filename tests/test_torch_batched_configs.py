"""Batched generation of the port over the engine options of the
single-sequence slices, against the JAX package's `generate_batch_fused` on
the CPU in fp32: a static tree, `kv_buckets` across a bucket edge (one
bucket for the batch, from its longest row), the int8 KV cache, and ragged
prompts padded to the bucket of a prompt longer than the first. Tolerance:
none, tokens and committed counts must be equal; every row also equals the
port's own one-sequence decode."""

import numpy as np
import pytest

from eagle_tpu.config import EngineConfig as JEngineConfig
from eagle_tpu.engine.engine import EagleEngine as JEngine
from eagle_tpu_torch.ops.tree import MC_SIM_7B_63

from test_engine_greedy import make_engine
from torch_port_util import port_engine

PROMPTS = [np.array([5, 17, 92, 3, 44, 8, 21], np.int32), np.array([7, 1], np.int32),
           np.array([44, 8, 21, 9, 62, 13, 3, 3, 120], np.int32)]


def _check_rows(je, pe, prompts, new, vanilla_fused=False):
    jouts, jn, jr = je.generate_batch_fused(prompts, max_new_tokens=new, log=True)
    outs, n, r = pe.generate_batch_fused(prompts, max_new_tokens=new, log=True)
    assert (n, r) == ([int(x) for x in jn], int(jr))
    for prompt, j, o in zip(prompts, jouts, outs):
        np.testing.assert_array_equal(o, j)
        np.testing.assert_array_equal(o, pe.generate_fused(prompt, max_new_tokens=new))
        np.testing.assert_array_equal(
            o, pe.generate_vanilla(prompt, max_new_tokens=new, fused=vanilla_fused))
    return outs


@pytest.mark.parametrize("version", [1, 3])
def test_batch_static_tree_matches_jax(version):
    je = make_engine(version, tree_paths=MC_SIM_7B_63)
    pe = port_engine(je, attn_impl="pallas_tree", compact_impl="pallas")
    assert pe.static_spec is not None and pe.ecfg.tree_size == 26
    _check_rows(je, pe, PROMPTS, 20)


def test_batch_kv_buckets_cross_a_bucket_edge(monkeypatch):
    """Buckets (64, 128): the longest row leaves the 64-row bucket while
    decoding, and every round of the batch runs against one bucket."""
    j0 = make_engine(1)
    je = JEngine(j0.params, j0.cfg, j0.dparams, j0.dcfg,
                 JEngineConfig(total_tokens=15, depth=3, top_k=4, max_len=256,
                               kv_buckets=(64, 128)))
    pe = port_engine(je, attn_impl="pallas_tree", compact_impl="pallas")
    used = []
    limit_of = pe._kv_limit
    monkeypatch.setattr(pe, "_kv_limit", lambda n: used.append(limit_of(n)) or used[-1])
    outs = _check_rows(je, pe, PROMPTS, 40, vanilla_fused=True)
    assert used[0] == 64 and sorted(set(used)) == [64, 128]
    assert all(len(o) == len(p) + 40 for o, p in zip(outs, PROMPTS))


def test_batch_int8_kv_matches_jax():
    je = make_engine(1, kv_quant="int8")
    pe = port_engine(je, attn_impl="pallas_tree", compact_impl="pallas")
    assert pe.init_target_cache(3).ks.shape[1] == 3
    _check_rows(je, pe, PROMPTS, 20)


def test_batch_ragged_prompts_across_a_prompt_bucket():
    """A 140-token prompt pads the whole batch to 256 rows: the short rows'
    prefill reads only their own prompts, and each row equals its
    one-sequence decode (padded to 128 there) and the JAX batch."""
    je = make_engine(3)
    pe = port_engine(je, attn_impl="pallas_tree", compact_impl="pallas")
    rng = np.random.default_rng(8)
    prompts = [rng.integers(0, 128, 140).astype(np.int32), PROMPTS[1]]
    assert pe._bucket(140) == 256 and pe._bucket(2) == 128
    _check_rows(je, pe, prompts, 16)
