"""Full-engine Monte-Carlo losslessness of the port's sampled dynamic-tree
engines with a fake target (test_torch_engine_mc.py sets it up): the
dynamic-tree cases of tests/test_engine_fake_backend_mc.py. CPU, fp32."""

import numpy as np
import pytest

from test_torch_engine_mc import _check_chains, _engine


@pytest.mark.parametrize("acceptance", ["true_q_dynamic", "q1"])
def test_full_engine_chain_distribution_dynamic_sampled(monkeypatch, acceptance):
    """true_q_dynamic routes dynamic trees through two-pass drafting
    (sampled candidates, Tree.node_probs, the true-q walk); q1 is the
    control."""
    eng, table = _engine(monkeypatch, 3, seed=2, table_seed=11, acceptance=acceptance)
    _check_chains(eng, table, 7000)
    if acceptance == "true_q_dynamic":
        # the sampled path is exercised: true-q accepts beyond the root
        _, st = eng.generate(np.asarray([3]), max_new_tokens=24, seed=1, details=True)
        assert max(st["accept_lens"]) >= 1
