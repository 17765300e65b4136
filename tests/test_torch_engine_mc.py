"""Full-engine Monte-Carlo losslessness of the port's sampled engine, with a
fake target: a port of tests/test_engine_fake_backend_mc.py.

The target forward is monkeypatched so that a position's logits depend only
on the previous token (a [V, V] conditional table), while the draft stays a
real draft net. Every engine code path runs (prefill root sampling, tree
verify plumbing, the rejection walks, bonus sampling, KV compaction, round
chaining) and the emitted chains must follow the table's Markov
distribution, under the JAX test's tolerances (4 sigma + 0.01 / 0.02).
Each request draws from its own generator (`seed=`). The dynamic-tree
sampled cases are in test_torch_engine_mc_dynamic.py. CPU, fp32."""

import numpy as np
import pytest
import torch

from eagle_tpu_torch.config import DraftConfig, EngineConfig, ModelConfig
from eagle_tpu_torch.engine.engine import EagleEngine
from eagle_tpu_torch.models import draft as draft_mod
from eagle_tpu_torch.models import transformer
from eagle_tpu_torch.ops.kv_cache import KVCache

import torch_port_util  # noqa: F401  (one intra-op thread per worker)

V = 16
H = V  # hidden = one-hot(token), so the fake lm_head reads the table row
N_GEN, L = 1500, 3


def _install_fake_target(monkeypatch, table):
    def fake_forward(params, cfg, tokens, cache, positions, mask):
        onehot = torch.nn.functional.one_hot(tokens, H).to(cfg.dtype)     # [B, T, H]
        return transformer.ForwardResult(
            hidden=onehot, pre_norm_hidden=onehot, taps=torch.cat([onehot] * 3, dim=-1),
            cache=KVCache(k=cache.k, v=cache.v, length=cache.length + tokens.shape[1]))

    def fake_lm_head(params, cfg, hidden):
        return hidden.to(torch.float32) @ table

    monkeypatch.setattr(transformer, "forward", fake_forward)
    monkeypatch.setattr(transformer, "lm_head", fake_lm_head)


def _engine(monkeypatch, version, seed, table_seed, **ecfg_kw):
    rng = np.random.default_rng(table_seed)
    table = torch.from_numpy(rng.normal(0, 1.5, size=(V, V)).astype(np.float32))
    _install_fake_target(monkeypatch, table)
    cfg = ModelConfig(vocab_size=V, hidden_size=H, intermediate_size=32, num_layers=2,
                      num_q_heads=2, num_kv_heads=2, head_dim=4, dtype=torch.float32)
    dcfg = DraftConfig(version=version, hidden_size=H, intermediate_size=32, num_q_heads=2,
                       num_kv_heads=2, head_dim=4, vocab_size=V,
                       target_hidden_size=H if version == 3 else 0, dtype=torch.float32)
    dparams = draft_mod.init_params(dcfg, seed=seed, device="cpu")
    params = {"embed": {"w": torch.zeros(V, H)}, "lm_head": torch.zeros(H, V)}
    ecfg = EngineConfig(total_tokens=7, depth=2, top_k=3, max_len=64, temperature=1.0,
                        **ecfg_kw)
    return EagleEngine(params, cfg, dparams, dcfg, ecfg, device="cpu"), table


def _check_chains(eng, table, seed0):
    prompt = np.asarray([3])
    seqs = np.stack([eng.generate(prompt, max_new_tokens=L, seed=seed0 + i)[1:]
                     for i in range(N_GEN)])
    assert seqs.shape == (N_GEN, L)
    p1 = torch.softmax(table[3], dim=-1).numpy()
    emp1 = np.bincount(seqs[:, 0], minlength=V) / N_GEN
    tol1 = 4 * np.sqrt(np.maximum(p1 * (1 - p1), 1e-12) / N_GEN)
    assert np.all(np.abs(emp1 - p1) <= tol1 + 0.01), (
        f"pos0 max dev {np.max(np.abs(emp1 - p1)):.4f}")
    t1 = int(emp1.argmax())
    sel = seqs[:, 0] == t1
    p2 = torch.softmax(table[t1], dim=-1).numpy()
    emp2 = np.bincount(seqs[sel, 1], minlength=V) / sel.sum()
    tol2 = 4 * np.sqrt(np.maximum(p2 * (1 - p2), 1e-12) / sel.sum())
    assert np.all(np.abs(emp2 - p2) <= tol2 + 0.02), (
        f"pos1|{t1} max dev {np.max(np.abs(emp2 - p2)):.4f}")


@pytest.mark.parametrize("version", [1, 3])
def test_full_engine_chain_distribution(monkeypatch, version):
    eng, table = _engine(monkeypatch, version, seed=1, table_seed=9)
    _check_chains(eng, table, 5000)
