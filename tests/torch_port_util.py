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
