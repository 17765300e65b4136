"""Batched sampled decoding (temperature > 0) in the port's engine, on the
CPU in fp32.

- At `sampling_top_k = 1` every processed distribution is one-hot, so every
  acceptance rule is deterministic: each row of a batched sampled request
  must emit the greedy tokens (the JAX package's greedy engine's, and the
  port's greedy vanilla), under the q(x) = 1, true-q and two-pass dynamic
  rules.
- Row i of a batch draws from a generator seeded with `seed + i`, in the
  one-sequence order and shapes: it equals the one-sequence request with
  that seed and that row's temperature, whatever the batch size.
- The port of tests/test_temperature.py's batched case.
JAX's random streams cannot be matched (tests/test_torch_accept_sampled.py
and test_torch_drafter_sampled.py hold the sampled functions to JAX on the
same uniforms), so sampled tokens are not compared with the JAX engine's."""

import numpy as np
import pytest

from eagle_tpu_torch.ops.tree import MC_SIM_7B_63

from test_engine_greedy import PROMPT, make_engine
from torch_port_util import port_engine

PROMPTS = [PROMPT, np.array([7, 1], np.int32), np.array([44, 8, 21, 9, 62, 13], np.int32)]
N_NEW = 16


@pytest.mark.parametrize("acceptance,static", [
    ("q1", False), ("true_q", True), ("true_q_dynamic", False)],
    ids=["dynamic-q1", "static-true_q", "dynamic-true_q_dynamic"])
def test_batched_top_k_1_rows_emit_the_greedy_tokens(acceptance, static):
    kw = dict(tree_paths=MC_SIM_7B_63) if static else {}
    greedy = make_engine(3, **kw)
    jref = greedy.generate_batch_fused(PROMPTS, max_new_tokens=N_NEW)
    je = make_engine(3, temperature=0.8, sampling_top_k=1, acceptance=acceptance, **kw)
    pe = port_engine(je, attn_impl="pallas_tree", compact_impl="pallas")
    fused = pe.generate_batch_fused(PROMPTS, max_new_tokens=N_NEW, seed=3)
    batch = pe.generate_batch(PROMPTS, max_new_tokens=N_NEW, seed=4,
                              temperature=[0.5, 0.8, 1.2])
    for i, prompt in enumerate(PROMPTS):
        van = pe.with_sampling(False).generate_vanilla(prompt, max_new_tokens=N_NEW)
        np.testing.assert_array_equal(jref[i], van)
        np.testing.assert_array_equal(fused[i], van)
        np.testing.assert_array_equal(batch[i], van)


@pytest.mark.parametrize("acceptance", ["q1", "true_q_dynamic"])
def test_batched_row_equals_the_single_request_with_its_seed(acceptance):
    pe = port_engine(make_engine(3, temperature=0.9, acceptance=acceptance),
                     attn_impl="pallas_tree", compact_impl="pallas")
    temps = [0.7, 1.3, 0.9]
    fused = pe.generate_batch_fused(PROMPTS, max_new_tokens=N_NEW, seed=5,
                                    temperature=temps)
    batch = pe.generate_batch(PROMPTS, max_new_tokens=N_NEW, seed=5, temperature=temps)
    for i, prompt in enumerate(PROMPTS):
        np.testing.assert_array_equal(
            fused[i], pe.generate_fused(prompt, max_new_tokens=N_NEW, seed=5 + i,
                                        temperature=temps[i]))
        np.testing.assert_array_equal(
            batch[i], pe.generate(prompt, max_new_tokens=N_NEW, seed=5 + i,
                                  temperature=temps[i]))
    # a row's draws do not depend on the batch around it
    two = pe.generate_batch_fused(PROMPTS[:2], max_new_tokens=N_NEW, seed=5,
                                  temperature=temps[:2])
    for a, b in zip(two, fused):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="one temperature"):
        pe.generate_batch_fused(PROMPTS, max_new_tokens=4, temperature=[0.5, 0.6])


def test_dynamic_sampled_batched_and_per_request_temperature():
    """true_q_dynamic: batched-fused generation runs (batched two-pass
    drafting + true-q walks), per-request temperatures ride as data, and
    seeds reproduce."""
    eng = port_engine(make_engine(3, temperature=0.9, acceptance="true_q_dynamic"))
    outs = eng.generate_batch_fused([PROMPT, PROMPT[:4]], max_new_tokens=10, seed=2)
    assert len(outs) == 2 and all(len(o) > 4 for o in outs)
    again = eng.generate_batch_fused([PROMPT, PROMPT[:4]], max_new_tokens=10, seed=2)
    for a, b in zip(outs, again):
        np.testing.assert_array_equal(a, b)     # same seed reproduces
    a = eng.generate(PROMPT, max_new_tokens=12, seed=7, temperature=0.7)
    b = eng.generate(PROMPT, max_new_tokens=12, seed=7, temperature=0.7)
    np.testing.assert_array_equal(a, b)
    c = eng.generate(PROMPT, max_new_tokens=12, seed=7, temperature=5.0)
    assert not np.array_equal(a, c)              # temperature actually plumbs
    hot = eng.generate_batch_fused([PROMPT, PROMPT], max_new_tokens=12, seed=7,
                                   temperature=[0.7, 5.0])
    np.testing.assert_array_equal(hot[0], eng.generate_fused(PROMPT, max_new_tokens=12,
                                                             seed=7, temperature=0.7))
    assert not np.array_equal(hot[0], hot[1])
