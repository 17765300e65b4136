"""The port's multi-turn session (eagle_tpu_torch/engine/session.py) on the
CPU: the cases of tests/test_session.py, each turn held bit for bit to the
port's own `generate` over the full context (itself held to the JAX
engine), and one case against the JAX package's EagleSession."""

import numpy as np
import pytest

from eagle_tpu.engine.session import EagleSession as JaxSession
from eagle_tpu_torch.engine.session import EagleSession, _common_prefix, turn_seed

from torch_port_util import engine_pair

P1 = np.array([5, 17, 92, 3, 44, 8, 21])
TURN2 = np.array([9, 4, 30, 2])
TURN3 = np.array([61, 7])


def test_common_prefix():
    a = np.array([1, 2, 3, 4])
    assert _common_prefix(a, a) == 4
    assert _common_prefix(a, np.array([1, 2, 9, 4])) == 2
    assert _common_prefix(a, np.zeros((0,), np.int64)) == 0
    assert _common_prefix(a, np.array([1, 2])) == 2


@pytest.mark.parametrize("version", [1, 3])
def test_session_multiturn_bit_exact(version):
    """Three turns through one session == three from-scratch generations over
    the growing context; max_new_tokens=11 trims mid-path, so turns 2 and 3
    rewind (start < the state's length)."""
    _, eng = engine_pair(version)
    sess = EagleSession(eng)
    out1, st1 = sess.send(P1, max_new_tokens=11, log=True)
    assert st1["reused_prefix"] == 0
    np.testing.assert_array_equal(out1, eng.generate(P1, max_new_tokens=11))
    p2 = np.concatenate([out1, TURN2])
    out2, st2 = sess.send(p2, max_new_tokens=11, log=True)
    assert st2["reused_prefix"] == len(out1) - 1
    np.testing.assert_array_equal(out2, eng.generate(p2, max_new_tokens=11))
    p3 = np.concatenate([out2, TURN3])
    out3, st3 = sess.send(p3, max_new_tokens=11, log=True)
    assert st3["reused_prefix"] == len(out2) - 1
    np.testing.assert_array_equal(out3, eng.generate(p3, max_new_tokens=11))


def test_session_matches_jax_session():
    """Two turns of the port's session equal the JAX package's EagleSession
    token for token, and report the same reused prefixes."""
    jeng, eng = engine_pair(1)
    ours, theirs = EagleSession(eng), JaxSession(jeng)
    prompt = P1
    for _ in range(2):
        a, sa = ours.send(prompt, max_new_tokens=10, log=True)
        b, sb = theirs.send(prompt.astype(np.int32), max_new_tokens=10, log=True)
        np.testing.assert_array_equal(a, b)
        assert sa["reused_prefix"] == sb["reused_prefix"]
        prompt = np.concatenate([a, TURN2])


def test_session_reduced_draft_vocab():
    _, eng = engine_pair(3, draft_vocab=64)
    sess = EagleSession(eng)
    out1 = sess.send(P1, max_new_tokens=10)
    p2 = np.concatenate([out1, TURN2])
    np.testing.assert_array_equal(sess.send(p2, max_new_tokens=10),
                                  eng.generate(p2, max_new_tokens=10))


def test_session_edited_history_rewinds():
    """An edit inside the committed context shrinks the reusable prefix: the
    session rewinds to the true common prefix and still matches."""
    _, eng = engine_pair(1)
    sess = EagleSession(eng)
    out1 = sess.send(P1, max_new_tokens=10)
    edited = np.concatenate([out1, TURN2])
    edited[3] = 77
    out2, st = sess.send(edited, max_new_tokens=10, log=True)
    assert st["reused_prefix"] == 2       # common prefix 3 -> resume row 2
    np.testing.assert_array_equal(out2, eng.generate(edited, max_new_tokens=10))


def test_session_fresh_context_full_prefill():
    _, eng = engine_pair(1)
    sess = EagleSession(eng)
    sess.send(P1, max_new_tokens=8)
    other = np.array([50, 51, 52, 53, 54])
    out, st = sess.send(other, max_new_tokens=8, log=True)
    assert st["reused_prefix"] == 0
    np.testing.assert_array_equal(out, eng.generate(other, max_new_tokens=8))


def test_session_sampled_turns_run():
    """Sampled turns run end to end past the context; turn k draws from a
    generator seeded from (seed, k), so a second session with the same seed
    gives the same turns."""
    _, eng = engine_pair(1, temperature=1.0)
    outs = []
    for _ in range(2):
        sess = EagleSession(eng, seed=3)
        out1 = sess.send(P1, max_new_tokens=9, temperature=0.8)
        assert len(out1) > len(P1)
        p2 = np.concatenate([out1, TURN2])
        out2, st = sess.send(p2, max_new_tokens=9, log=True, temperature=0.8)
        assert st["reused_prefix"] == len(out1) - 1
        assert len(out2) > len(p2)
        np.testing.assert_array_equal(out2[: len(p2)], p2)
        outs.append((out1, out2))
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)
    assert turn_seed(3, 0) != turn_seed(3, 1) != turn_seed(4, 1)


def test_session_sampled_top_k_one_is_greedy():
    """A sampled engine at sampling_top_k = 1 draws from one-hot
    distributions: its turns, incremental ones included, are the greedy
    tokens."""
    _, eng = engine_pair(1, temperature=0.8, sampling_top_k=1)
    _, greedy = engine_pair(1)
    sess = EagleSession(eng, seed=5)
    out1 = sess.send(P1, max_new_tokens=10)
    np.testing.assert_array_equal(out1, greedy.generate(P1, max_new_tokens=10))
    p2 = np.concatenate([out1, TURN2])
    np.testing.assert_array_equal(sess.send(p2, max_new_tokens=10),
                                  greedy.generate(p2, max_new_tokens=10))


def test_session_streaming_matches_send():
    _, eng = engine_pair(1)
    ref = EagleSession(eng).send(P1, max_new_tokens=10)
    last = None
    for all_ids, _ in EagleSession(eng).stream(P1, max_new_tokens=10):
        last = all_ids
    np.testing.assert_array_equal(last, ref)


def test_session_context_too_long_raises():
    _, eng = engine_pair(1)
    with pytest.raises(ValueError, match="max_len"):
        EagleSession(eng).send(np.arange(eng.ecfg.max_len) % 100)
