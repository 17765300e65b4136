"""The port's tree math, masks and greedy acceptance (eagle_tpu_torch/ops/tree.py,
ops/masks.py, engine/accept.py) against the JAX package on random trees."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eagle_tpu.engine import accept as jaccept
from eagle_tpu.ops import masks as jmasks
from eagle_tpu.ops import tree as jtree
from eagle_tpu_torch.engine import accept as taccept
from eagle_tpu_torch.ops import masks as tmasks
from eagle_tpu_torch.ops import tree as ttree

from torch_port_util import t


def _parents(N, rng):
    parents = [0]
    for i in range(1, N):
        parents.append(int(rng.integers(0, i)))
    return np.asarray(parents, np.int32)


@pytest.mark.parametrize("N,k,seed", [(16, 4, 0), (61, 10, 1), (26, 3, 2)])
def test_tree_structures_match_jax(N, k, seed):
    rng = np.random.default_rng(seed)
    parents = _parents(N, rng)
    tokens = rng.integers(0, 100, N)
    jt = jtree.build_tree(jnp.asarray(tokens, jnp.int32), jnp.asarray(parents), k,
                          max_depth=N)
    tt = ttree.build_tree(t(tokens), t(parents), k, max_depth=N)
    for name in ("tokens", "parents", "mask", "positions", "children"):
        np.testing.assert_array_equal(getattr(tt, name).numpy(),
                                      np.asarray(getattr(jt, name)), err_msg=name)
    jp = jtree.paths_from_mask(jt.mask, jt.positions, 9)
    tp = ttree.paths_from_mask(tt.mask, tt.positions, 9)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))


@pytest.mark.parametrize("T,S,start", [(5, 32, 0), (5, 32, 20), (7, 32, 30)])
def test_masks_match_jax(T, S, start):
    """Includes a window that runs past the buffer (start + T > S), where
    both sides clamp the tree placement as dynamic_update_slice does."""
    rng = np.random.default_rng(start)
    tm = rng.random((2, T, T)) < 0.5
    st = np.array([start, max(0, start - 3)], np.int32)
    np.testing.assert_array_equal(
        tmasks.prefill_mask(T, S, t(st)).numpy(),
        np.asarray(jmasks.prefill_mask(T, S, jnp.asarray(st))))
    np.testing.assert_array_equal(
        tmasks.tree_mask_full(t(tm), S, t(st)).numpy(),
        np.asarray(jmasks.tree_mask_full(jnp.asarray(tm), S, jnp.asarray(st))))


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("forced", [False, True])
def test_accept_greedy_matches_jax(seed, forced):
    """Logits are built so the walk accepts a few levels deep."""
    rng = np.random.default_rng(seed)
    N, V, k, P = 31, 40, 4, 7
    parents = _parents(N, rng)
    tokens = rng.integers(0, V, N)
    logits = rng.normal(size=(N, V)).astype(np.float32)
    for i in range(1, N):   # make roughly half the nodes the parent's argmax
        if rng.random() < 0.5:
            logits[parents[i], tokens[i]] = 10.0 + rng.random()
    jt = jtree.build_tree(jnp.asarray(tokens, jnp.int32), jnp.asarray(parents), k,
                          max_depth=N)
    tt = ttree.build_tree(t(tokens), t(parents), k, max_depth=N)
    ref = rng.integers(0, V, P).astype(np.int32) if forced else None
    ja = jaccept.accept_greedy(jt, jnp.asarray(logits), P,
                               ref_next=None if ref is None else jnp.asarray(ref))
    ta = taccept.accept_greedy(tt, t(logits), P,
                               ref_next=None if ref is None else t(ref))
    np.testing.assert_array_equal(ta.path.numpy(), np.asarray(ja.path))
    assert int(ta.accept_len) == int(ja.accept_len)
    assert int(ta.live_match) == int(ja.live_match)
    np.testing.assert_allclose(ta.sample_p.numpy(), np.asarray(ja.sample_p),
                               rtol=1e-6, atol=1e-7)
