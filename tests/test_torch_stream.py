"""Streaming generation and `calibrate_total_tokens` in the port against the
JAX package: `generate_stream` and `generate_vanilla_stream` yield the same
ids and stats round by round, the stream ends on `generate_fused`'s ids, and
the tree-size tuner returns one of its candidates. CPU, fp32."""

import types

import numpy as np
import pytest

from eagle_tpu.engine.engine import calibrate_total_tokens as j_calibrate
from eagle_tpu_torch import convert
from eagle_tpu_torch.engine.engine import calibrate_total_tokens

from test_engine_greedy import PROMPT, make_engine
from torch_port_util import np_tree, port_engine

PROMPT2 = np.array([77, 3, 3, 120, 9, 64, 31, 2, 100, 45, 6], np.int32)


def _same_yields(jgen, pgen):
    n = 0
    for (jids, jstats), (ids, stats) in zip(jgen, pgen, strict=True):
        np.testing.assert_array_equal(ids, np.asarray(jids))
        assert stats == {k: int(v) for k, v in jstats.items()}
        n += 1
    return n, ids


@pytest.mark.parametrize("version,kw", [(1, {}), (3, {}),
                                        (1, dict(tree_paths=((0,), (1,), (0, 0)))),
                                        (3, dict(kv_quant="int8"))],
                         ids=["v1", "v3", "v1-static", "v3-kv8"])
def test_generate_stream_yields_equal_jax(version, kw):
    je = make_engine(version, **kw)
    pe = port_engine(je)
    gen = pe.generate_stream(PROMPT, max_new_tokens=24)
    assert isinstance(gen, types.GeneratorType)
    rounds, last = _same_yields(je.generate_stream(PROMPT, max_new_tokens=24), gen)
    assert rounds >= 1 and len(last) == len(PROMPT) + 24
    np.testing.assert_array_equal(last, pe.generate_fused(PROMPT, max_new_tokens=24))
    np.testing.assert_array_equal(last, pe.generate(PROMPT, max_new_tokens=24))


def test_generate_stream_eos_and_stats():
    je = make_engine(1)
    pe = port_engine(je)
    ref = pe.generate_vanilla(PROMPT2, max_new_tokens=40)
    eos = int(ref[len(PROMPT2) + 9])
    _, last = _same_yields(je.generate_stream(PROMPT2, max_new_tokens=40, eos_token_id=eos),
                           pe.generate_stream(PROMPT2, max_new_tokens=40, eos_token_id=eos))
    assert last[-1] == eos
    np.testing.assert_array_equal(
        last, pe.generate_vanilla(PROMPT2, max_new_tokens=40, eos_token_id=eos))
    seen = [(len(ids), st["new_tokens"], st["rounds"], st["accept_len"])
            for ids, st in pe.generate_stream(PROMPT, max_new_tokens=20)]
    assert [r for _, _, r, _ in seen] == list(range(1, len(seen) + 1))
    for (n0, t0, _, _), (n1, t1, _, a1) in zip(seen, seen[1:]):
        assert n1 - n0 == t1 - t0 and 1 <= t1 - t0 <= a1 + 1
    out, stats = pe.generate(PROMPT, max_new_tokens=20, details=True)
    assert stats["accept_lens"] == [a for *_, a in seen] and len(out) == seen[-1][0]
    # sampled: the stream draws what generate_fused draws for the same seed
    hot = pe.with_sampling(True)
    for ids, _ in hot.generate_stream(PROMPT, max_new_tokens=20, seed=4, temperature=0.5):
        pass
    np.testing.assert_array_equal(
        ids, hot.generate_fused(PROMPT, max_new_tokens=20, seed=4, temperature=0.5))


@pytest.mark.parametrize("version", [1, 3])
def test_generate_vanilla_stream_yields_equal_jax(version):
    je = make_engine(version)
    pe = port_engine(je)
    n, last = _same_yields(je.generate_vanilla_stream(PROMPT, max_new_tokens=12),
                           pe.generate_vanilla_stream(PROMPT, max_new_tokens=12))
    assert n == 12
    np.testing.assert_array_equal(last, pe.generate_vanilla(PROMPT, max_new_tokens=12))
    eos = int(last[len(PROMPT) + 4])
    cut = list(pe.generate_vanilla_stream(PROMPT, max_new_tokens=12, eos_token_id=eos))
    assert len(cut) == 5 and cut[-1][0][-1] == eos


@pytest.mark.parametrize("batch,kv_quant", [(1, "none"), (4, "none"), (1, "int8")])
def test_calibrate_total_tokens(batch, kv_quant):
    je = make_engine(1)
    cfg = convert.model_config(je.cfg)
    params = convert.target_params(np_tree(je.params), device="cpu")
    timings = []
    n = calibrate_total_tokens(params, cfg, candidates=(8, 16), weights=(1.0, 1.05),
                               max_len=64, reps=2, batch=batch, kv_quant=kv_quant,
                               _debug_timings=timings, device="cpu")
    assert n in (8, 16) and len(timings) == 2 and all(t > 0 for t in timings)
    # the weighted argmin: a weight that prices a candidate out excludes it
    assert calibrate_total_tokens(params, cfg, candidates=(8, 16), weights=(1e9, 1.0),
                                  max_len=64, reps=1, device="cpu") == 16
    if batch == 1 and kv_quant == "none":
        assert j_calibrate(je.params, je.cfg, candidates=(8, 16), weights=(1e9, 1.0),
                           max_len=64, reps=1) == 16
