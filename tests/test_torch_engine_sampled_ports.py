"""Ports of the JAX package's sampled engine tests to the port's engine
(eagle_tpu_torch/engine/engine.py): tests/test_engine_sampled.py,
tests/test_temperature.py (its server and batched cases wait for those
modules) and tests/test_static_tree.py's sampled tests. CPU, fp32."""

import dataclasses

import numpy as np
import pytest
import torch

from eagle_tpu_torch.engine.engine import EagleEngine
from eagle_tpu_torch.engine.sampling import process_logits
from eagle_tpu_torch.models import transformer
from eagle_tpu_torch.ops.kv_cache import init_cache
from eagle_tpu_torch.ops.masks import prefill_mask
from eagle_tpu_torch.ops.tree import MC_SIM_7B_63

from test_engine_greedy import PROMPT, make_engine
from torch_port_util import port_engine


def _target_probs(eng, ctx, temperature):
    """The processed target distribution after `ctx`, by a direct forward."""
    cfg = eng.cfg
    cache = init_cache(cfg.num_layers, 1, cfg.num_kv_heads, 64, cfg.head_dim,
                       dtype=cfg.dtype, device="cpu")
    T = len(ctx)
    res = transformer.forward(eng.params, cfg, torch.as_tensor(ctx).long()[None], cache,
                              torch.arange(T)[None], prefill_mask(T, 64, cache.length))
    logits = transformer.lm_head(eng.params, cfg, res.hidden[0, T - 1])
    return torch.softmax(process_logits(logits, temperature), dim=-1).numpy()


# ---------------------------------------------------------------------------
# ports of tests/test_engine_sampled.py
# ---------------------------------------------------------------------------

def test_sampled_generation_runs():
    eng = port_engine(make_engine(3, temperature=0.9, top_p=0.9))
    out, new_tok, rounds = eng.generate(PROMPT, max_new_tokens=32, log=True, seed=7)
    assert new_tok == 32 and rounds >= 1
    assert np.all(out >= 0) and np.all(out < eng.cfg.vocab_size)
    assert not np.array_equal(out, eng.generate(PROMPT, max_new_tokens=32, seed=8))
    np.testing.assert_array_equal(eng.generate(PROMPT, max_new_tokens=32, seed=7), out)


def test_engine_first_token_marginal():
    eng = port_engine(make_engine(1, temperature=1.0, seed=5))
    n = 400
    firsts = np.array([eng.generate(PROMPT, max_new_tokens=1, seed=1000 + i)[len(PROMPT)]
                       for i in range(n)])
    p = _target_probs(eng, PROMPT, eng.ecfg.temperature)
    emp = np.bincount(firsts, minlength=eng.cfg.vocab_size) / n
    t = int(p.argmax())
    sigma = np.sqrt(p[t] * (1 - p[t]) / n)
    assert abs(emp[t] - p[t]) < 5 * sigma + 0.02


def test_engine_second_token_conditional():
    je = make_engine(1, temperature=1.0, seed=5)
    eng0 = port_engine(je)
    params = dict(eng0.params)
    params["lm_head"] = params["lm_head"] * 8.0     # concentrated conditionals
    eng = EagleEngine(params, eng0.cfg, eng0.dparams, eng0.dcfg,
                      dataclasses.replace(eng0.ecfg, draft_quant="none"), device="cpu")
    n = 500
    seqs = np.stack([eng.generate(PROMPT, max_new_tokens=2, seed=2000 + i)[len(PROMPT):]
                     for i in range(n)])
    p1 = _target_probs(eng, PROMPT, 1.0)
    t1 = int(np.bincount(seqs[:, 0], minlength=eng.cfg.vocab_size).argmax())
    sel = seqs[:, 0] == t1
    assert sel.sum() >= 30
    sigma1 = np.sqrt(p1[t1] * (1 - p1[t1]) / n)
    assert abs(sel.mean() - p1[t1]) < 5 * sigma1 + 0.03
    p2 = _target_probs(eng, np.concatenate([PROMPT, [t1]]), 1.0)
    t2 = int(p2.argmax())
    emp = (seqs[sel, 1] == t2).mean()
    sigma = np.sqrt(p2[t2] * (1 - p2[t2]) / sel.sum())
    assert abs(emp - p2[t2]) < 5 * sigma + 0.03, (emp, p2[t2], sel.sum())


def test_fused_sampled_generation_runs():
    eng = port_engine(make_engine(3, temperature=0.9, top_p=0.9))
    out, ntok, rounds = eng.generate_fused(PROMPT, max_new_tokens=24, seed=3, log=True)
    assert ntok >= 24 and rounds >= 1 and len(out) == len(PROMPT) + 24
    assert not np.array_equal(out, eng.generate_fused(PROMPT, max_new_tokens=24, seed=4))
    # the fused loop and the per-round loop draw the same stream
    np.testing.assert_array_equal(eng.generate(PROMPT, max_new_tokens=24, seed=3), out)


def test_true_q_dynamic_reduced_draft_vocab():
    eng = port_engine(make_engine(3, draft_vocab=64, temperature=0.9,
                                  acceptance="true_q_dynamic"))
    out, st = eng.generate(PROMPT, max_new_tokens=16, details=True)
    assert st["rounds"] >= 1 and len(out) > len(PROMPT)
    _, _, state = eng._start(PROMPT, 0.9, seed=0)
    probs0 = state.tree.node_probs[0]
    assert state.tree.node_probs.shape[-1] == eng.cfg.vocab_size
    np.testing.assert_allclose(float(probs0.sum()), 1.0, atol=1e-4)
    assert int((probs0 > 0).sum()) <= 64     # mass only on d2t-mapped target ids


# ---------------------------------------------------------------------------
# ports of tests/test_temperature.py (single-sequence cases)
# ---------------------------------------------------------------------------

def test_temperatures_share_one_engine():
    """Different t > 0 on one sampled engine: nothing is rebuilt (the
    parameters stay the same tensors), and the temperature is data."""
    eng = port_engine(make_engine(3, temperature=0.9))
    before = (eng.params["lm_head"], eng.dparams["layers"][0]["wqkv"], eng.ecfg)
    o1 = eng.generate(PROMPT, max_new_tokens=16, seed=3, temperature=0.5)
    o2 = eng.generate(PROMPT, max_new_tokens=16, seed=3, temperature=5.0)
    assert not np.array_equal(o1, o2)
    after = (eng.params["lm_head"], eng.dparams["layers"][0]["wqkv"], eng.ecfg)
    assert all(a is b for a, b in zip(before, after))
    np.testing.assert_array_equal(eng.generate(PROMPT, max_new_tokens=16, seed=3,
                                               temperature=0.5), o1)


def test_high_vs_low_temperature_distributions():
    eng = port_engine(make_engine(3, temperature=1.0))
    ref = eng.with_sampling(False).generate(PROMPT, max_new_tokens=24)
    out = eng.generate(PROMPT, max_new_tokens=24, seed=11, temperature=1e-4)
    np.testing.assert_array_equal(out[: len(ref)], ref[: len(out)])


def test_with_sampling_roundtrip():
    eng = port_engine(make_engine(1))
    assert eng.with_sampling(False) is eng
    samp = eng.with_sampling(True)
    assert samp.params["lm_head"] is eng.params["lm_head"]
    assert samp.dparams["layers"][0]["wqkv"] is eng.dparams["layers"][0]["wqkv"]
    assert samp.ecfg.temperature == 1.0
    assert samp.with_sampling(True) is samp
    assert samp.with_sampling(False).ecfg.temperature == 0.0
    out = samp.generate(PROMPT, max_new_tokens=8, seed=2, temperature=2.0)
    assert len(out) == len(PROMPT) + 8
    # a greedy engine ignores a request temperature, as the JAX engine does
    np.testing.assert_array_equal(eng.generate(PROMPT, max_new_tokens=8, temperature=2.0),
                                  eng.generate(PROMPT, max_new_tokens=8))


def test_vanilla_temperature_plumbed():
    eng = port_engine(make_engine(3, temperature=1.0))
    ref = eng.with_sampling(False).generate_vanilla(PROMPT, max_new_tokens=16)
    np.testing.assert_array_equal(
        eng.generate_vanilla(PROMPT, max_new_tokens=16, temperature=1e-4), ref)
    hot = eng.generate_vanilla(PROMPT, max_new_tokens=16, seed=5, temperature=5.0)
    assert not np.array_equal(hot, ref)
    np.testing.assert_array_equal(
        eng.generate_vanilla(PROMPT, max_new_tokens=16, seed=5, temperature=5.0, fused=True),
        hot)


def test_static_tree_true_q_per_request_temperature():
    eng = port_engine(make_engine(3, tree_paths=MC_SIM_7B_63, temperature=0.9,
                                  acceptance="true_q"))
    ref = eng.with_sampling(False).generate(PROMPT, max_new_tokens=20)
    cold = eng.generate(PROMPT, max_new_tokens=20, seed=4, temperature=1e-4)
    np.testing.assert_array_equal(cold[: len(ref)], ref[: len(cold)])
    h1 = eng.generate(PROMPT, max_new_tokens=20, seed=4, temperature=1.0)
    h2 = eng.generate(PROMPT, max_new_tokens=20, seed=4, temperature=6.0)
    assert not np.array_equal(h1, h2)


def test_dynamic_sampled_per_request_temperature():
    eng = port_engine(make_engine(3, temperature=0.9, acceptance="true_q_dynamic"))
    a = eng.generate(PROMPT, max_new_tokens=12, seed=7, temperature=0.7)
    np.testing.assert_array_equal(eng.generate(PROMPT, max_new_tokens=12, seed=7,
                                               temperature=0.7), a)
    assert not np.array_equal(a, eng.generate(PROMPT, max_new_tokens=12, seed=7,
                                              temperature=5.0))
    with pytest.raises(ValueError, match="greedy"):     # forced replay is greedy only
        eng.generate_fused(PROMPT, max_new_tokens=4, force_tokens=np.arange(64))


# ---------------------------------------------------------------------------
# ports of tests/test_static_tree.py's sampled tests
# ---------------------------------------------------------------------------

def test_static_tree_sampled_runs():
    eng = port_engine(make_engine(1, tree_paths=MC_SIM_7B_63, temperature=0.9))
    assert len(eng.generate(PROMPT, max_new_tokens=16, seed=3)) == len(PROMPT) + 16


def test_static_tree_true_q_sampled_runs():
    eng = port_engine(make_engine(1, tree_paths=MC_SIM_7B_63, temperature=0.9,
                                  acceptance="true_q"))
    out, ntok, rounds = eng.generate(PROMPT, max_new_tokens=24, log=True, seed=11)
    assert ntok == 24
    _, _, state = eng._start(PROMPT, None, seed=11)
    assert state.tree.node_probs is not None
    assert not np.array_equal(out, eng.generate(PROMPT, max_new_tokens=24, seed=12))
