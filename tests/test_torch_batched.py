"""Batched speculative generation in the port (`generate_batch`,
`generate_batch_fused`) against the JAX package's batched functions on the
CPU in fp32: ports of tests/test_batched.py's six cases. Tolerance: none,
every row's tokens must equal the JAX engine's and the port's own
one-sequence output. The port runs its kernel options (tree-verify
attention, compaction), which take their plain versions on the CPU."""

import dataclasses

import numpy as np
import pytest

from eagle_tpu.engine.engine import EagleEngine as JEngine
from eagle_tpu.ops import quant4 as jq4

from test_engine_greedy import make_engine
from torch_port_util import port_engine

PROMPTS = [np.array([5, 17, 92, 3], np.int32), np.array([7, 1], np.int32),
           np.array([44, 8, 21, 9, 62, 13], np.int32)]


@pytest.fixture(scope="module")
def engines():
    je = make_engine(1)
    return je, port_engine(je, attn_impl="pallas_tree", compact_impl="pallas")


def _with_eos(je, pe, eos):
    jeos = JEngine(je.params, je.cfg, je.dparams, je.dcfg, je.ecfg, eos_token_id=eos)
    peos = pe._sibling()
    peos.eos_token_id = eos
    return jeos, peos


def test_batch_matches_single(engines):
    je, pe = engines
    jb = je.generate_batch(PROMPTS, max_new_tokens=24)
    pb = pe.generate_batch(PROMPTS, max_new_tokens=24)
    assert len(pb) == 3
    for prompt, j, p in zip(PROMPTS, jb, pb):
        np.testing.assert_array_equal(p, j)
        np.testing.assert_array_equal(p, pe.generate(prompt, max_new_tokens=24))


def test_batch_eos_per_sequence(engines):
    je, pe = engines
    refs = [pe.generate_vanilla(p, max_new_tokens=30) for p in PROMPTS[:2]]
    # an EOS that appears early in sequence 0's continuation
    eos = int(refs[0][len(PROMPTS[0]) + 4])
    jeos, peos = _with_eos(je, pe, eos)
    jouts = jeos.generate_batch_fused(PROMPTS[:2], max_new_tokens=30)
    for name, outs in (("generate_batch", peos.generate_batch(PROMPTS[:2], max_new_tokens=30)),
                       ("generate_batch_fused",
                        peos.generate_batch_fused(PROMPTS[:2], max_new_tokens=30))):
        for i, p in enumerate(PROMPTS[:2]):
            exp = pe.generate_vanilla(p, max_new_tokens=30, eos_token_id=eos)
            np.testing.assert_array_equal(outs[i], exp, err_msg=f"{name} row {i}")
            np.testing.assert_array_equal(outs[i], jouts[i], err_msg=f"{name} row {i}")
    assert jouts[0][-1] == eos and len(jouts[0]) == len(PROMPTS[0]) + 5


def test_batch_fused_matches_batch(engines):
    je, pe = engines
    jouts, jn, jr = je.generate_batch_fused(PROMPTS, max_new_tokens=20, log=True)
    outs, n, r = pe.generate_batch_fused(PROMPTS, max_new_tokens=20, log=True)
    assert (n, r) == ([int(x) for x in jn], int(jr))
    batch = pe.generate_batch(PROMPTS, max_new_tokens=20)
    for prompt, j, o, b in zip(PROMPTS, jouts, outs, batch):
        np.testing.assert_array_equal(o, j)
        np.testing.assert_array_equal(o, b)
        np.testing.assert_array_equal(o, pe.generate_vanilla(prompt, max_new_tokens=20))


def test_batch_fused_forced_replay(engines):
    """Every row walks exactly its own reference (also where it leaves the
    live argmax), as the JAX engine's batched replay does, with the same
    committed counts and rounds."""
    je, pe = engines
    prompts = PROMPTS[:2]
    fulls = [pe.generate_fused(p, max_new_tokens=64) for p in prompts]
    refs = [fulls[0].copy(), fulls[1].copy()]
    flip = len(prompts[1]) + 5
    refs[1][flip] = (refs[1][flip] + 1) % pe.cfg.vocab_size
    outs, committed, rounds = pe.generate_batch_fused(prompts, max_new_tokens=24,
                                                      force_tokens=refs, log=True)
    jouts, jcommitted, jrounds = je.generate_batch_fused(prompts, max_new_tokens=24,
                                                         force_tokens=refs, log=True)
    for r, o, j in zip(refs, outs, jouts):
        np.testing.assert_array_equal(o, r[: len(o)])
        np.testing.assert_array_equal(o, j)
    assert outs[1][flip] == refs[1][flip] != fulls[1][flip]
    assert (committed, rounds) == ([int(c) for c in jcommitted], int(jrounds))
    assert rounds >= 1 and all(c >= 24 for c in committed)


def test_batch_fused_forced_replay_rejects_bad_inputs(engines):
    _, pe = engines
    prompts = PROMPTS[:1]
    full = pe.generate_fused(prompts[0], max_new_tokens=64)
    with pytest.raises(ValueError, match="too short"):
        pe.generate_batch_fused(prompts, max_new_tokens=60, force_tokens=[full[:30]])
    with pytest.raises(ValueError, match="one force_tokens row per prompt"):
        pe.generate_batch_fused(prompts, max_new_tokens=8, force_tokens=[full, full])
    with pytest.raises(ValueError, match="must start with the prompt"):
        pe.generate_batch_fused(prompts, max_new_tokens=8, force_tokens=[full[1:]])
    sampled = port_engine(make_engine(1, temperature=0.8))
    with pytest.raises(ValueError, match="greedy engine"):
        sampled.generate_batch_fused(prompts, max_new_tokens=8, force_tokens=[full])


def test_batch_int4_target_stacked_matches_single():
    """Batched rounds over a stacked int4 target with an int4 draft and fused
    scoring (the w4a8 wrappers see B*T and B*top_k rows): each row equals
    the JAX engine's batched output and the port's one-sequence output."""
    e0 = make_engine(3)
    ecfg = dataclasses.replace(e0.ecfg, draft_quant="int4", fuse_scoring=True)
    je = JEngine(jq4.quantize_target_params4(e0.params), e0.cfg, e0.dparams, e0.dcfg, ecfg)
    # the JAX engine quantized the draft: its words cross as they are
    pe = port_engine(je, attn_impl="pallas_tree", compact_impl="pallas",
                     draft_quant="none")
    assert "stacked4" in pe.params and "q4" in pe.dparams["lm_head"]
    jouts = je.generate_batch_fused(PROMPTS, max_new_tokens=16)
    outs = pe.generate_batch_fused(PROMPTS, max_new_tokens=16)
    for prompt, j, o in zip(PROMPTS, jouts, outs):
        np.testing.assert_array_equal(o, j)
        np.testing.assert_array_equal(o, pe.generate(prompt, max_new_tokens=16))


@pytest.mark.cuda
@pytest.mark.parametrize("change", [
    dict(), dict(tree_paths=((0,), (1,), (0, 0))), dict(kv_buckets=(256,)),
    dict(temperature=0.7, top_p=0.9), dict(temperature=0.7, acceptance="true_q_dynamic")],
    ids=["greedy", "static", "kv_buckets", "sampled-q1", "sampled-true_q_dynamic"])
def test_a_batched_round_never_waits_on_the_host(change):
    """Two batched rounds (B = 3 ragged prompts) run under torch's sync debug
    mode "error", and launch B1 once per layer and round. Needs the card."""
    import torch

    from eagle_tpu_torch.ops import attn_kernels as ak

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (sm_90a) and nvcc")
    pe = port_engine(make_engine(3), attn_impl="pallas_tree", compact_impl="pallas",
                     **change)
    eng = pe.__class__(pe.params, pe.cfg, pe.dparams, pe.dcfg,
                       dataclasses.replace(pe.ecfg, draft_quant="none"), device="cuda")
    _, st = eng._start_batch(PROMPTS, None, seed=0)
    kv_limit = eng._kv_limit(6 + 3 * eng.path_len)
    with torch.no_grad():
        st, _ = eng._round(st, kv_limit=kv_limit)      # first use: builds, caches
        torch.cuda.synchronize()
        before = ak.LAUNCHES["tree_attention"]
        torch.cuda.set_sync_debug_mode("error")
        try:
            for _ in range(2):
                st, _ = eng._round(st, kv_limit=kv_limit)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    assert ak.LAUNCHES["tree_attention"] == before + 2 * eng.cfg.num_layers
