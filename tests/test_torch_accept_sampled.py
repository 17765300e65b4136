"""The sampled acceptance rules of the port (eagle_tpu_torch/engine/
accept.py) against eagle_tpu/engine/accept.py, and the port's ports of
tests/test_losslessness_mc.py.

Equality with JAX: the JAX rule draws its uniforms from the key it gets
(`split(key, path_len - 1)`, one `uniform(key_i, (K,))` per level); the test
draws the same numbers and hands them to the port. Paths, accepted lengths
and bonus tokens must be identical; sample_p within atol 1e-6. Random trees
with K up to 10; the draft distributions hold zeros.

Monte Carlo: 200k trials batched over a leading trial dimension, noise from
a torch generator, under the JAX tests' tolerances. CPU, fp32."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from eagle_tpu.config import EngineConfig as JEngineConfig
from eagle_tpu.engine import accept as jaccept
from eagle_tpu.engine.sampling import categorical as jcategorical
from eagle_tpu.ops.tree import build_tree as jbuild_tree
from eagle_tpu_torch.config import EngineConfig
from eagle_tpu_torch.engine import accept as taccept
from eagle_tpu_torch.engine.sampling import U_MIN, categorical, process_logits
from eagle_tpu_torch.ops.tree import Tree, build_tree, children_table

SETTINGS = [dict(temperature=1.0), dict(temperature=0.6),
            dict(temperature=1.0, top_p=0.8), dict(temperature=0.9, sampling_top_k=5)]


def _random_tree(rng, N, K, V):
    """parents[i] < i with at most K children a node; sibling tokens distinct."""
    parents = [0]
    kids = {0: 0}
    for i in range(1, N):
        cands = [p for p in range(i) if kids.get(p, 0) < K]
        p = int(rng.choice(cands[-4:] if rng.random() < 0.6 else cands))
        parents.append(p)
        kids[p] = kids.get(p, 0) + 1
        kids[i] = 0
    tokens = np.zeros(N, np.int32)
    tokens[0] = rng.integers(0, V)
    for p in range(N):
        ch = [i for i in range(1, N) if parents[i] == p]
        tokens[ch] = rng.choice(V, size=len(ch), replace=False)
    return tokens, np.asarray(parents, np.int32)


def _case(seed, K, V=24):
    """A random tree of 3K + 6 nodes, target logits that put real mass on the
    children (so walks go deep), and draft distributions with zeros."""
    rng = np.random.default_rng(seed)
    N = 3 * K + 6
    tokens, parents = _random_tree(rng, N, K, V)
    logits = rng.normal(0, 1.5, size=(N, V)).astype(np.float32)
    for i in range(1, N):
        logits[parents[i], tokens[i]] += rng.uniform(1, 4)
    q = rng.dirichlet(np.full(V, 0.5), size=N).astype(np.float32)
    q[rng.random((N, V)) < 0.25] = 0.0               # zeros, children's too
    q[:, 0] = np.maximum(q[:, 0], 1e-3)
    return tokens, parents, logits, q / q.sum(axis=1, keepdims=True)


@pytest.mark.parametrize("setting", SETTINGS, ids=["t1", "t0.6", "p0.8", "k5"])
@pytest.mark.parametrize("K", [1, 3, 10])
@pytest.mark.parametrize("sampled_tree", [False, True], ids=["q1", "true_q"])
def test_rules_match_jax_on_its_uniforms(sampled_tree, K, setting):
    """12 random trees a case, the JAX rule vmapped over them (one compile),
    the port's batched walk on the same uniforms."""
    cases = [_case(seed * 7 + K, K) for seed in range(12)]
    tokens, parents, logits, q = (np.stack(x) for x in zip(*cases))
    N = tokens.shape[1]
    path_len = N if K == 1 else 7                     # deep enough for every walk
    node_probs = q if sampled_tree else None
    jrule = jaccept.accept_sampled_true_q if sampled_tree else jaccept.accept_sampled
    trule = taccept.accept_sampled_true_q if sampled_tree else taccept.accept_sampled
    jecfg = JEngineConfig(**setting)

    def one(tok, par, lg, npb, key):
        tree = jbuild_tree(tok, par, K, N, node_probs=npb if sampled_tree else None)
        return jrule(tree, lg, key, jecfg, path_len)

    keys = jax.random.split(jax.random.PRNGKey(K), len(cases))
    jres = jax.jit(jax.vmap(one))(jnp.asarray(tokens), jnp.asarray(parents),
                                  jnp.asarray(logits), jnp.asarray(q), keys)
    u = np.stack([np.stack([np.asarray(jax.random.uniform(k, (K,), jnp.float32))
                            for k in jax.random.split(key, path_len - 1)])
                  for key in keys])
    tt = [build_tree(torch.from_numpy(tokens[i]).long(), torch.from_numpy(parents[i]).long(),
                     K, N) for i in range(len(cases))]
    tree = Tree(tokens=torch.stack([x.tokens for x in tt]), parents=None, mask=None,
                positions=None, children=torch.stack([x.children for x in tt]),
                node_probs=None if node_probs is None else torch.from_numpy(node_probs))
    tres = trule(tree, torch.from_numpy(logits), torch.from_numpy(u),
                 EngineConfig(**setting), path_len)
    np.testing.assert_array_equal(tres.path.numpy(), np.asarray(jres.path))
    np.testing.assert_array_equal(tres.accept_len.numpy(), np.asarray(jres.accept_len))
    np.testing.assert_allclose(tres.sample_p.numpy(), np.asarray(jres.sample_p),
                               rtol=0, atol=1e-6)
    assert int(tres.accept_len.sum()) > 0             # the walks do accept
    # the bonus token on the JAX bonus keys' uniforms
    kb = jax.random.split(jax.random.PRNGKey(100 + K), len(cases))
    jb = jax.vmap(jcategorical)(kb, jres.sample_p)
    ub = jax.vmap(lambda k: jax.random.uniform(k, (logits.shape[-1],), jnp.float32,
                                               1e-20, 1.0))(kb)
    np.testing.assert_array_equal(
        categorical(tres.sample_p, torch.from_numpy(np.array(ub))).numpy(), np.asarray(jb))


def test_a_batch_of_trials_equals_the_single_walks():
    tokens, parents, logits, node_probs = _case(3, 4)
    tree = build_tree(torch.from_numpy(tokens).long(), torch.from_numpy(parents).long(),
                      4, len(tokens), node_probs=torch.from_numpy(node_probs))
    ecfg = EngineConfig(temperature=0.8)
    P = 7
    u = torch.rand((6, P - 1, 4), generator=torch.Generator().manual_seed(0))
    for rule in (taccept.accept_sampled, taccept.accept_sampled_true_q):
        batch = rule(tree, torch.from_numpy(logits), u, ecfg, P)
        for b in range(6):
            one = rule(tree, torch.from_numpy(logits), u[b], ecfg, P)
            assert torch.equal(batch.path[b], one.path)
            assert torch.equal(batch.accept_len[b], one.accept_len)
            assert torch.equal(batch.sample_p[b], one.sample_p)


# ---------------------------------------------------------------------------
# Monte Carlo (ports of tests/test_losslessness_mc.py)
# ---------------------------------------------------------------------------

V = 16
N_TRIALS = 200_000
MC_PARENTS = torch.tensor([0, 0, 0, 0, 1, 1, 2, 4])


def _setup(seed=0):
    """Tree: root(tok 3) → {5, 1, 7}; 5 → {2, 9}; 1 → {4}; 7 leaf; 2 → {11}."""
    tokens = torch.tensor([3, 5, 1, 7, 2, 9, 4, 11])
    tree = build_tree(tokens, MC_PARENTS, k=3, max_depth=4)
    rng = np.random.default_rng(seed)
    table = torch.from_numpy(rng.normal(0, 1.5, size=(V, V)).astype(np.float32))
    return tree, table, table[tokens]


def _run_trials(tree, logits, ecfg, path_len, n=N_TRIALS, seed=123):
    gen = torch.Generator().manual_seed(seed)
    K = tree.children.shape[1]
    acc = taccept.accept_sampled(tree, logits, torch.rand((n, path_len - 1, K),
                                                          generator=gen), ecfg, path_len)
    u = torch.rand((n, V), generator=gen).clamp_min(U_MIN)
    bonus = categorical(acc.sample_p, u)
    toks = tree.tokens[acc.path]                       # [n, PATH]
    seq = torch.cat([toks[:, 1:], torch.zeros((n, 1), dtype=torch.long)], dim=1)
    seq[torch.arange(n), acc.accept_len] = bonus
    return seq.numpy(), acc.accept_len.numpy()


def _true_probs(table, ecfg, prev_tok):
    p = process_logits(table[prev_tok], ecfg.temperature, ecfg.sampling_top_k, ecfg.top_p)
    return torch.softmax(p, dim=-1).numpy()


@pytest.mark.parametrize("ecfg", [
    EngineConfig(temperature=1.0),
    EngineConfig(temperature=0.7),
    EngineConfig(temperature=1.0, top_p=0.8),
    EngineConfig(temperature=0.9, sampling_top_k=8),
], ids=["t1.0", "t0.7", "t1.0-p0.8", "t0.9-k8"])
def test_first_token_distribution(ecfg):
    tree, table, logits = _setup()
    seqs, _ = _run_trials(tree, logits, ecfg, 5)
    true_p = _true_probs(table, ecfg, 3)
    emp = np.bincount(seqs[:, 0], minlength=V) / len(seqs)
    tol = 3 * np.sqrt(np.maximum(true_p * (1 - true_p), 1e-12) / len(seqs))
    assert np.all(np.abs(emp - true_p) <= tol + 1e-3), (
        f"max dev {np.max(np.abs(emp - true_p)):.4f}")


def test_second_token_conditional_distribution():
    ecfg = EngineConfig(temperature=1.0)
    tree, table, logits = _setup()
    seqs, _ = _run_trials(tree, logits, ecfg, 5)
    checked = 0
    for t1 in [5, 1, 7]:                # in-tree children of the root
        sel = seqs[:, 0] == t1
        if sel.sum() < 5000:
            continue
        emp = np.bincount(seqs[sel, 1], minlength=V) / sel.sum()
        true_p = _true_probs(table, ecfg, t1)
        tol = 4 * np.sqrt(np.maximum(true_p * (1 - true_p), 1e-12) / sel.sum())
        assert np.all(np.abs(emp - true_p) <= tol + 2e-3), (
            f"t1={t1}: max dev {np.max(np.abs(emp - true_p)):.4f}")
        checked += 1
    assert checked >= 1


def test_acceptance_actually_accepts():
    tree, table, logits = _setup()
    _, alens = _run_trials(tree, logits, EngineConfig(temperature=1.0), 5, n=20_000)
    assert alens.mean() > 0.1
    assert alens.max() >= 2


def test_true_q_sampled_candidates_lossless():
    """True-q acceptance over sampled candidate trees: with a draft Q != P
    the emitted tokens still follow the target chain P."""
    ecfg = EngineConfig(temperature=1.0, acceptance="true_q")
    rng = np.random.default_rng(7)
    Ptab = torch.from_numpy(rng.normal(0, 1.5, size=(V, V)).astype(np.float32))
    Qtab = torch.softmax(torch.from_numpy(rng.normal(0, 1.0, size=(V, V)).astype(np.float32)),
                         dim=-1)
    expand = [(0, [1, 2, 3]), (1, [4, 5]), (2, [6]), (4, [7])]
    K, path_len, root_tok, n = 3, 5, 3, N_TRIALS
    gen = torch.Generator().manual_seed(99)
    rows = torch.arange(n)
    tokens = torch.zeros((n, 8), dtype=torch.long)
    tokens[:, 0] = root_tok
    node_probs = torch.zeros((n, 8, V))
    for node, childs in expand:
        q = Qtab[tokens[:, node]]                                    # [n, V]
        g = -torch.log(-torch.log(torch.rand((n, V), generator=gen).clamp_min(U_MIN)))
        samp = torch.topk(torch.log(q) + g, len(childs), dim=-1).indices
        node_probs[:, node] = q
        tokens[:, childs] = samp
    tree = Tree(tokens=tokens, parents=MC_PARENTS, mask=None, positions=None,
                children=children_table(MC_PARENTS, K), node_probs=node_probs)
    logits = Ptab[tokens]                                            # [n, 8, V]
    acc = taccept.accept_sampled_true_q(
        tree, logits, torch.rand((n, path_len - 1, K), generator=gen), ecfg, path_len)
    bonus = categorical(acc.sample_p, torch.rand((n, V), generator=gen).clamp_min(U_MIN))
    toks = tokens.gather(1, acc.path)
    seq = torch.cat([toks[:, 1:], torch.zeros((n, 1), dtype=torch.long)], dim=1)
    seq[rows, acc.accept_len] = bonus
    # past this round's emission, exact ancestral samples from P (what later
    # lossless rounds produce), so every position's conditional is defined
    for j in range(1, path_len - 1):
        u = torch.rand((n, V), generator=gen).clamp_min(U_MIN)
        nxt = categorical(torch.softmax(Ptab[seq[:, j - 1]], dim=-1), u)
        seq[:, j] = torch.where(j <= acc.accept_len, seq[:, j], nxt)
    seqs = seq.numpy()

    true_p = torch.softmax(Ptab[root_tok], dim=-1).numpy()
    emp = np.bincount(seqs[:, 0], minlength=V) / n
    tol = 4 * np.sqrt(np.maximum(true_p * (1 - true_p), 1e-12) / n)
    assert np.all(np.abs(emp - true_p) <= tol + 1e-3), (
        f"max dev {np.max(np.abs(emp - true_p)):.4f}")
    for t1 in range(V):
        sel = seqs[:, 0] == t1
        if sel.sum() < 5000:
            continue
        emp2 = np.bincount(seqs[sel, 1], minlength=V) / sel.sum()
        true2 = torch.softmax(Ptab[t1], dim=-1).numpy()
        tol2 = 5 * np.sqrt(np.maximum(true2 * (1 - true2), 1e-12) / sel.sum())
        assert np.all(np.abs(emp2 - true2) <= tol2 + 3e-3), (
            f"t1={t1}: max dev {np.max(np.abs(emp2 - true2)):.4f}")
    assert acc.accept_len.float().mean() > 0.05
