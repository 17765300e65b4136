"""eagle_tpu_torch/engine/sampling.py against eagle_tpu/engine/sampling.py:
the logits filters over a grid of temperature, top-k and top-p (ties
included), and Gumbel-max draws on the uniforms the JAX function draws from
its key. CPU, fp32, inputs from numpy seeds."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from eagle_tpu.engine import sampling as jsampling
from eagle_tpu_torch.engine import sampling as tsampling

V = 50


def _logits(seed, ties):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 2.0, size=(3, V)).astype(np.float32)
    if ties:   # repeated values, at the top and around the filters' edges
        x[:, 5] = x[:, 9] = x[:, 30] = x.max(axis=1)
        x[:, 11] = x[:, 12] = x[:, 13] = np.sort(x, axis=1)[:, -6]
        x[2] = np.round(x[2])
    return x


@pytest.mark.parametrize("ties", [False, True], ids=["distinct", "ties"])
@pytest.mark.parametrize("top_k", [0, 1, 3, 10])
@pytest.mark.parametrize("top_p", [0.0, 0.3, 0.9, 1.0])
@pytest.mark.parametrize("temperature", [0.25, 0.7, 1.0, 3.0])
def test_process_logits_matches_jax(temperature, top_p, top_k, ties):
    x = _logits(int(temperature * 100) + top_k, ties)
    ref = np.asarray(jsampling.process_logits(jnp.asarray(x), temperature, top_k, top_p))
    got = tsampling.process_logits(torch.from_numpy(x), temperature, top_k, top_p)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-6)
    # a device-scalar temperature gives the same numbers
    got_t = tsampling.process_logits(torch.from_numpy(x), torch.tensor(temperature),
                                     top_k, top_p)
    np.testing.assert_array_equal(got_t.numpy(), got.numpy())
    assert (got > -1e29).sum(dim=-1).min() >= 1      # at least one token kept


@pytest.mark.parametrize("seed", range(6))
def test_categorical_matches_jax_on_its_uniforms(seed):
    rng = np.random.default_rng(seed)
    p = rng.dirichlet(np.full(V, 0.3), size=64).astype(np.float32)
    p[:, rng.integers(0, V, 10)] = 0.0          # zero-probability entries
    p[0] = 0.0
    p[0, 17] = 1.0                              # one-hot: always that index
    key = jax.random.PRNGKey(seed)
    ref = np.asarray(jsampling.categorical(key, jnp.asarray(p)))
    u = jax.random.uniform(key, p.shape, jnp.float32, 1e-20, 1.0)
    got = tsampling.categorical(torch.from_numpy(p), torch.from_numpy(np.array(u)))
    np.testing.assert_array_equal(got.numpy(), ref)
    assert got[0] == 17 and all(p[i, got[i]] > 0 for i in range(len(p)))


def test_uniform_draws_on_the_generator_device():
    gen = torch.Generator().manual_seed(3)
    u = tsampling.uniform(gen, (4, 1000), "cpu", tsampling.U_MIN)
    assert u.dtype == torch.float32 and u.shape == (4, 1000)
    assert float(u.min()) >= tsampling.U_MIN and float(u.max()) < 1.0
    again = tsampling.uniform(torch.Generator().manual_seed(3), (4, 1000), "cpu",
                              tsampling.U_MIN)
    assert torch.equal(u, again)                # a seed reproduces its stream
