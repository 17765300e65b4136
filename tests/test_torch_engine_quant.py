"""The port's quantized engines (int4 / int8 targets, int4 / int8 drafts,
fused draft scoring) against the JAX engines on the CPU in fp32. Tolerance:
none: emitted tokens must be equal, and every quantized engine must equal its
own `generate_vanilla`. On the CPU the port's kernel wrappers take their
plain versions; the JAX engines take their XLA paths (bit-identical to the
port's plain versions, tests/test_torch_quant4.py)."""

import dataclasses

import numpy as np
import pytest
import torch

from eagle_tpu.engine.engine import EagleEngine as JEngine
from eagle_tpu.ops import quant as jq
from eagle_tpu.ops import quant4 as jq4
from eagle_tpu_torch import convert
from eagle_tpu_torch.config import EngineConfig
from eagle_tpu_torch.engine.engine import EagleEngine
from eagle_tpu_torch.ops import quant as tq
from eagle_tpu_torch.ops import quant4 as tq4

from test_engine_greedy import PROMPT, make_engine
from test_torch_engine import PROMPT2
from test_torch_quant import assert_trees_equal
from torch_port_util import np_tree, port_engine

NEW = 24


def _check_greedy_equals_vanilla(pe, prompts=(PROMPT, PROMPT2)):
    for prompt in prompts:
        ref = pe.generate_vanilla(prompt, max_new_tokens=NEW)
        np.testing.assert_array_equal(pe.generate(prompt, max_new_tokens=NEW), ref)
        out, n, rounds = pe.generate_fused(prompt, max_new_tokens=NEW, log=True)
        np.testing.assert_array_equal(out, ref)
        assert rounds >= 1 and n >= NEW


@pytest.mark.parametrize("version,kernels", [(1, False), (3, True)])
def test_int4_target_tokens_equal_jax_and_own_vanilla(version, kernels):
    e0 = make_engine(version, **(dict(compact_impl="pallas") if kernels else {}))
    cfg = dataclasses.replace(e0.cfg, attn_impl="pallas_tree") if kernels else e0.cfg
    je = JEngine(jq4.quantize_target_params4(e0.params), cfg, e0.dparams, e0.dcfg,
                 e0.ecfg)
    pe = port_engine(je)
    assert set(pe.params["stacked4"]) >= {"wq", "w_down"}
    assert pe.params["lm_head"]["q4"].dtype == torch.int32
    for prompt in (PROMPT, PROMPT2):
        jref = je.generate(prompt, max_new_tokens=NEW)
        np.testing.assert_array_equal(pe.generate(prompt, max_new_tokens=NEW), jref)
        np.testing.assert_array_equal(
            pe.generate_vanilla(prompt, max_new_tokens=NEW),
            je.generate_vanilla(prompt, max_new_tokens=NEW))
    _check_greedy_equals_vanilla(pe)


def test_int4_target_quantized_by_the_port_fused_layout():
    """The port quantizes the converted float tree itself (fuse=True: wqkv and
    w_gateup): the same tokens as the JAX engine on its own fused tree."""
    e0 = make_engine(3)
    je = JEngine(jq4.quantize_target_params4(e0.params, group=16, fuse=True), e0.cfg,
                 e0.dparams, e0.dcfg, e0.ecfg)
    p0 = port_engine(e0)
    qparams = tq4.quantize_target_params4(p0.params, group=16, fuse=True)
    pe = EagleEngine(qparams, p0.cfg, p0.dparams, p0.dcfg, p0.ecfg, device="cpu")
    np.testing.assert_array_equal(pe.generate(PROMPT, max_new_tokens=NEW),
                                  je.generate(PROMPT, max_new_tokens=NEW))
    _check_greedy_equals_vanilla(pe, (PROMPT2,))


def test_int8_target_tokens_equal_jax_and_own_vanilla():
    e0 = make_engine(3)
    je = JEngine(jq.quantize_target_params(e0.params), e0.cfg, e0.dparams, e0.dcfg,
                 e0.ecfg)
    pe = port_engine(je)
    assert pe.params["layers"][0]["wq"]["q8"].dtype == torch.int8
    np.testing.assert_array_equal(pe.generate(PROMPT, max_new_tokens=NEW),
                                  je.generate(PROMPT, max_new_tokens=NEW))
    _check_greedy_equals_vanilla(pe, (PROMPT2,))


@pytest.mark.parametrize("dq,version,fuse_scoring", [
    ("int4", 3, True), ("int8", 3, True), ("int4", 1, False), ("int8", 1, False)])
def test_quantized_draft_engine_matches_jax(dq, version, fuse_scoring):
    """The port fuses and quantizes the draft at init exactly as the JAX engine
    does (same words and scales); a quantized draft never changes the output,
    and with the same trees the two engines take the same number of rounds.
    On the CPU the JAX engine scores through its unfused chain, the port
    through score_topk_ref: the same candidate ids."""
    e0 = make_engine(version)
    ecfg = dataclasses.replace(e0.ecfg, draft_quant=dq)
    je = JEngine(e0.params, e0.cfg, e0.dparams, e0.dcfg, ecfg)
    pe = port_engine(e0, draft_quant=dq, fuse_scoring=fuse_scoring)
    assert_trees_equal(pe.dparams, convert.draft_params(np_tree(je.dparams), device="cpu"))
    key = "q4" if dq == "int4" else "q8"
    assert key in pe.dparams["layers"][0]["wqkv"] and key in pe.dparams["fc"]["w"]
    for prompt in (PROMPT, PROMPT2):
        ref = pe.generate_vanilla(prompt, max_new_tokens=NEW)
        jout, jn, jr = je.generate(prompt, max_new_tokens=NEW, log=True)
        out, n, r = pe.generate(prompt, max_new_tokens=NEW, log=True)
        np.testing.assert_array_equal(out, ref)
        np.testing.assert_array_equal(out, jout)
        assert (n, r) == (int(jn), int(jr))
        np.testing.assert_array_equal(pe.generate_fused(prompt, max_new_tokens=NEW), ref)


def test_converted_quantized_draft_runs_as_it_is():
    """A JAX engine's already-quantized dparams cross through convert and run
    with draft_quant="none": nothing is quantized twice."""
    e0 = make_engine(3)
    je = JEngine(e0.params, e0.cfg, e0.dparams, e0.dcfg,
                 dataclasses.replace(e0.ecfg, draft_quant="int4"))
    pe = port_engine(je, draft_quant="none", fuse_scoring=True)
    assert "q4" in pe.dparams["lm_head"]
    jout, jn, jr = je.generate(PROMPT, max_new_tokens=NEW, log=True)
    out, n, r = pe.generate(PROMPT, max_new_tokens=NEW, log=True)
    np.testing.assert_array_equal(out, jout)
    assert (n, r) == (int(jn), int(jr))


def test_v1_draft_scores_with_a_quantized_target_head():
    """An EAGLE-1 draft scores with the target's lm_head; with an int8 target
    that head is a quantized dict and fused scoring applies to it."""
    e0 = make_engine(1)
    je = JEngine(jq.quantize_target_params(e0.params), e0.cfg, e0.dparams, e0.dcfg,
                 e0.ecfg)
    pe = port_engine(je, fuse_scoring=True)
    assert isinstance(pe._lm_head_w, dict) and "q8" in pe._lm_head_w
    np.testing.assert_array_equal(pe.generate(PROMPT, max_new_tokens=20),
                                  je.generate(PROMPT, max_new_tokens=20))
    _check_greedy_equals_vanilla(pe, (PROMPT,))


def test_int4_serving_point_all_on():
    """The int4 serving path as a whole at small size: int4 target, int4 draft, fused
    scoring, tree-attention and compaction paths on."""
    e0 = make_engine(3, draft_vocab=64, compact_impl="pallas")
    p0 = port_engine(e0, attn_impl="pallas_tree")
    qparams = tq4.quantize_target_params4(p0.params)
    ecfg = dataclasses.replace(p0.ecfg, draft_quant="int4", fuse_scoring=True,
                               draft_quant_group=8)
    pe = EagleEngine(qparams, p0.cfg, p0.dparams, p0.dcfg, ecfg, device="cpu")
    assert tq4._group_of(pe.dparams["layers"][0]["wo"]) == 8
    _check_greedy_equals_vanilla(pe)


def test_unknown_draft_quant_raises_and_int8_draft_params_are_int8():
    e0 = make_engine(3)
    with pytest.raises(ValueError, match="draft_quant"):
        port_engine(e0, draft_quant="int7")
    pe = port_engine(e0, draft_quant="int8")
    want = tq.quantize_draft_params(port_engine(e0).dparams)
    assert_trees_equal(pe.dparams, want)
    # a quantized draft goes with an int8 target KV cache (the draft cache
    # stays in the draft's dtype); an unknown kv_quant raises as in JAX
    kv8 = port_engine(e0, draft_quant="int8", kv_quant="int8")
    assert_trees_equal(kv8.dparams, want)
    cache, dcache = kv8.init_caches()
    assert cache.k.dtype == torch.int8 and cache.ks.dtype == torch.float32
    assert dcache.k.dtype == pe.dcfg.dtype and dcache.ks is None
    with pytest.raises(ValueError, match="kv_quant"):
        EagleEngine(pe.params, pe.cfg, pe.dparams, pe.dcfg,
                    EngineConfig(kv_quant="int4"), device="cpu")
