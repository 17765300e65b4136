"""Sampled decoding (temperature > 0) in the port's engine
(eagle_tpu_torch/engine/engine.py) against the JAX package.

The slice as a whole: at `sampling_top_k=1` the processed distribution is
one-hot, so every acceptance rule and every draw is deterministic, and a
sampled engine must emit the greedy tokens. The port's sampled engines and
the JAX package's emit the JAX greedy engine's tokens, for every acceptance
mode and tree kind, through generate, generate_fused, generate_stream and
generate_vanilla. The ports of the JAX package's sampled engine tests are
in test_torch_engine_sampled_ports.py, the engine-level Monte Carlo in
test_torch_engine_mc.py. CPU, fp32."""

import functools

import numpy as np
import pytest

from eagle_tpu_torch.ops.tree import MC_SIM_7B_63

from test_engine_greedy import PROMPT, make_engine
from torch_port_util import port_engine

PROMPT2 = np.array([77, 3, 3, 120, 9, 64, 31, 2, 100, 45, 6], np.int32)
N_NEW = 20


@functools.lru_cache(maxsize=None)
def _jax_greedy(version, static):
    kw = dict(tree_paths=MC_SIM_7B_63) if static else {}
    je = make_engine(version, **kw)
    return {i: je.generate(p, max_new_tokens=N_NEW) for i, p in enumerate((PROMPT, PROMPT2))}


@pytest.mark.parametrize("version,acceptance,static,kernels", [
    (3, "q1", False, True), (3, "true_q", False, False), (3, "true_q_dynamic", False, True),
    (1, "true_q_dynamic", False, False), (3, "q1", True, False), (3, "true_q", True, True),
    (1, "true_q", True, False)],
    ids=["v3-dynamic-q1", "v3-dynamic-true_q", "v3-dynamic-true_q_dynamic",
         "v1-dynamic-true_q_dynamic", "v3-static-q1", "v3-static-true_q", "v1-static-true_q"])
def test_top_k_1_sampling_emits_the_jax_greedy_tokens(version, acceptance, static, kernels):
    kw = dict(tree_paths=MC_SIM_7B_63) if static else {}
    je = make_engine(version, temperature=0.8, sampling_top_k=1, acceptance=acceptance, **kw)
    pe = port_engine(je, **(dict(attn_impl="pallas_tree", compact_impl="pallas")
                            if kernels else {}))
    greedy = _jax_greedy(version, static)
    for i, prompt in enumerate((PROMPT, PROMPT2)):
        ref = greedy[i]
        if i == 0:
            np.testing.assert_array_equal(je.generate(prompt, max_new_tokens=N_NEW, seed=3),
                                          ref)
        np.testing.assert_array_equal(pe.generate(prompt, max_new_tokens=N_NEW, seed=3), ref)
        np.testing.assert_array_equal(
            pe.generate_fused(prompt, max_new_tokens=N_NEW, seed=4), ref)
        for ids, _ in pe.generate_stream(prompt, max_new_tokens=N_NEW, seed=5):
            pass
        np.testing.assert_array_equal(ids, ref)
        np.testing.assert_array_equal(
            pe.generate_vanilla(prompt, max_new_tokens=N_NEW, seed=6), ref)
    np.testing.assert_array_equal(
        pe.generate_vanilla(PROMPT, max_new_tokens=N_NEW, seed=6, fused=True), greedy[0])
