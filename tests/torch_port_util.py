"""Shared helpers for the tests of the PyTorch port (eagle_tpu_torch) against
the JAX package: inputs are numpy arrays, handed to both sides."""

import jax
import numpy as np
import torch

from eagle_tpu_torch import convert
from eagle_tpu_torch.engine.engine import EagleEngine as TorchEngine

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
# the tests' tensors are tiny: one intra-op thread per test worker keeps
# six xdist workers from oversubscribing the CPU
torch.set_num_threads(1)


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def t(x, dtype=None):
    """numpy / JAX array → CPU tensor (integers as int64)."""
    return convert.to_tensor(np.asarray(x), dtype, device="cpu")


def port_engine(jeng, attn_impl=None, **ecfg_changes):
    """A port EagleEngine on the CPU with the JAX engine's configs and
    parameters (fp32)."""
    import dataclasses

    cfg = convert.model_config(jeng.cfg)
    if attn_impl is not None:
        cfg = dataclasses.replace(cfg, attn_impl=attn_impl)
    ecfg = dataclasses.replace(convert.engine_config(jeng.ecfg), **ecfg_changes)
    params = convert.target_params(np_tree(jeng.params), device="cpu")
    dparams = convert.draft_params(np_tree(jeng.dparams), device="cpu")
    return TorchEngine(params, cfg, dparams, convert.draft_config(jeng.dcfg),
                       ecfg, device="cpu")


_PAIRS: dict = {}


def engine_pair(version=1, attn_impl="pallas_tree", **make_kw):
    """(JAX engine, port engine on the CPU) of `test_engine_greedy.make_engine`
    (version, **make_kw), built once per process and shared by every test
    that asks for the same arguments: a serving test file builds its engines
    once."""
    key = (version, attn_impl, tuple(sorted(make_kw.items())))
    if key not in _PAIRS:
        from test_engine_greedy import make_engine

        jeng = make_engine(version, **make_kw)
        _PAIRS[key] = (jeng, port_engine(jeng, attn_impl=attn_impl))
    return _PAIRS[key]


_REFS: dict = {}


def greedy_ref(eng, prompt, max_new_tokens: int, longest: int = 40):
    """The port engine's greedy decode of `prompt` (its `generate_vanilla`,
    which its speculative paths equal) to `max_new_tokens`, cut from one
    decode of at least `longest` new tokens per (engine, prompt): a greedy
    output with a smaller budget is a prefix of it."""
    prompt = np.asarray(prompt, np.int64).ravel()
    key = (id(eng), prompt.tobytes())
    n = max(longest, max_new_tokens)
    if key not in _REFS or _REFS[key][0] < n:
        _REFS[key] = (n, eng.generate_vanilla(prompt, max_new_tokens=n, fused=True))
    return _REFS[key][1][: len(prompt) + max_new_tokens]
