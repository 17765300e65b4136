"""Engine faults of the port fixed against the JAX package and the port's own
vanilla decode (CPU, fp32):

- the bonus token follows the vanilla rule, the argmax of the final node's
  logits, also where two logits one f32 ulp apart tie after a softmax;
- `generate_vanilla(max_new_tokens=0)` returns the prompt alone on both
  vanilla paths, as the JAX engine does;
- a head_dim-64 target (the Llama-3.2-1B class) with both attention-side
  kernels' paths on gives the JAX engine's tokens, whose Pallas kernels run
  interpreted. Tolerance: none (token ids);
- on the card (marked `cuda`, skipped elsewhere), a decode round, greedy or
  sampled, never waits on the host."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eagle_tpu.config import DraftConfig, EngineConfig, ModelConfig
from eagle_tpu.engine.engine import EagleEngine as JEngine
from eagle_tpu.models import draft as jdraft
from eagle_tpu.models import transformer as jtransformer
from eagle_tpu_torch.models import transformer

from test_engine_greedy import PROMPT, make_engine
from torch_port_util import port_engine


def test_bonus_token_is_the_argmax_of_the_logits(monkeypatch):
    """Every target logit row is -30 except [0.1, nextafter(0.1)] at tokens 0
    and 1: the argmax is 1 everywhere, while the softmax rounds both to 0.5
    (an argmax after it picks 0). Speculative output must equal vanilla's."""
    pe = port_engine(make_engine(3, seed=5), attn_impl="pallas_tree", compact_impl="pallas")
    lo = np.float32(0.1)
    hi = np.nextafter(lo, np.float32(1.0))
    p = torch.softmax(torch.tensor([float(lo), float(hi)]), dim=0)
    assert p[0] == p[1]                       # the tie the softmax makes
    orig = transformer.lm_head

    def tied(params, cfg, h):
        x = torch.full_like(orig(params, cfg, h), -30.0)
        x[..., 0] = float(lo)
        x[..., 1] = float(hi)
        return x

    monkeypatch.setattr(transformer, "lm_head", tied)
    ref = pe.generate_vanilla(PROMPT, max_new_tokens=12)
    assert (ref[len(PROMPT):] == 1).all()
    np.testing.assert_array_equal(pe.generate(PROMPT, max_new_tokens=12), ref)
    np.testing.assert_array_equal(pe.generate_fused(PROMPT, max_new_tokens=12), ref)


@pytest.mark.parametrize("fused", [False, True])
def test_vanilla_with_no_new_tokens_returns_the_prompt(fused):
    je = make_engine(1)
    pe = port_engine(je)
    jref = je.generate_vanilla(PROMPT, max_new_tokens=0, fused=fused)
    np.testing.assert_array_equal(jref, PROMPT)
    np.testing.assert_array_equal(
        pe.generate_vanilla(PROMPT, max_new_tokens=0, fused=fused), jref)
    assert len(pe.generate_vanilla(PROMPT, max_new_tokens=1, fused=fused)) == len(PROMPT) + 1


def _hd64_jax_engine(version: int) -> JEngine:
    """A tiny target and draft at head_dim 64 (2 q / 1 kv heads, hidden 128),
    with tree attention and compaction on their Pallas kernels."""
    cfg = ModelConfig(vocab_size=128, hidden_size=128, intermediate_size=256,
                      num_layers=2, num_q_heads=2, num_kv_heads=1, head_dim=64,
                      dtype=jnp.float32, attn_impl="pallas_tree")
    dcfg = DraftConfig(version=version, hidden_size=128, intermediate_size=256,
                       num_q_heads=2, num_kv_heads=1, head_dim=64, vocab_size=128,
                       num_layers=1, dtype=jnp.float32,
                       target_hidden_size=128 if version == 3 else 0)
    k1, k2 = jax.random.split(jax.random.PRNGKey(64 + version))
    ecfg = EngineConfig(total_tokens=15, depth=3, top_k=4, max_len=256,
                        compact_impl="pallas")
    return JEngine(jtransformer.init_params(cfg, k1), cfg,
                   jdraft.init_params(dcfg, k2), dcfg, ecfg)


@pytest.mark.parametrize("version", [1, 3])
def test_head_dim_64_engine_equals_jax_engine(version):
    je = _hd64_jax_engine(version)
    pe = port_engine(je)
    assert pe.cfg.head_dim == 64 and pe.cfg.attn_impl == "pallas_tree"
    jref = je.generate(PROMPT, max_new_tokens=20)
    np.testing.assert_array_equal(pe.generate_fused(PROMPT, max_new_tokens=20), jref)
    np.testing.assert_array_equal(pe.generate_vanilla(PROMPT, max_new_tokens=20),
                                  jref[:len(PROMPT) + 20])


@pytest.mark.cuda
@pytest.mark.parametrize("change", [
    dict(), dict(tree_paths=((0,), (1,), (0, 0))), dict(kv_buckets=(256,)),
    dict(temperature=0.7, top_p=0.9), dict(temperature=0.7, acceptance="true_q_dynamic"),
    dict(temperature=0.7, tree_paths=((0,), (1,), (0, 0)))],
    ids=["greedy", "static", "kv_buckets", "sampled-q1", "sampled-true_q_dynamic",
         "sampled-static-true_q"])
def test_a_round_never_waits_on_the_host(change):
    """A decode round reads no device value on the host and copies nothing
    from pageable host memory (the greedy walk once indexed by 0-d tensors
    and every forward copied RoPE's frequencies from the host): two rounds
    run under torch's sync debug mode "error". Needs the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (sm_90a) and nvcc")
    je = make_engine(3)
    pe = port_engine(je, attn_impl="pallas_tree", compact_impl="pallas", **change)
    eng = pe.__class__(pe.params, pe.cfg, pe.dparams, pe.dcfg,
                       dataclasses.replace(pe.ecfg, draft_quant="none"), device="cuda")
    _, _, st = eng._start(PROMPT, None, seed=0)
    kv_limit = eng._kv_limit(len(PROMPT) + 3 * eng.path_len)
    with torch.no_grad():
        st, _ = eng._round(st, kv_limit=kv_limit)      # first use: builds, caches
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            for _ in range(2):
                st, _ = eng._round(st, kv_limit=kv_limit)
        finally:
            torch.cuda.set_sync_debug_mode("default")
