"""The port's checkpoint loader (eagle_tpu_torch/models/hf_loader.py) against
the JAX package's: tiny Llama-shaped and EAGLE-shaped checkpoints, written
here with safetensors and with torch.save, are loaded by both packages; the
port's tree equals `convert` of the JAX tree bit for bit. Then
`from_pretrained` on those directories."""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from safetensors.torch import save_file

from eagle_tpu.engine.engine import EagleEngine as JEngine
from eagle_tpu.models import hf_loader as jloader
from eagle_tpu_torch import convert
from eagle_tpu_torch.engine.engine import EagleEngine
from eagle_tpu_torch.models import hf_loader as tloader

from torch_port_util import np_tree

H, F, L, V, NQ, NKV, DV = 32, 64, 3, 96, 4, 2, 48
TARGET_JSON = {"architectures": ["LlamaForCausalLM"], "model_type": "llama",
               "vocab_size": V, "hidden_size": H, "intermediate_size": F,
               "num_hidden_layers": L, "num_attention_heads": NQ,
               "num_key_value_heads": NKV, "rms_norm_eps": 1e-5,
               "rope_theta": 10000.0, "max_position_embeddings": 256}
PROMPT = np.array([5, 17, 92, 3, 44, 8, 21], np.int32)


def _rand(gen, *shape):
    return torch.randn(shape, generator=gen) * 0.05


def _attn_mlp(gen, prefix, in_w, bias=False):
    kv = NKV * (H // NQ)
    sd = {prefix + "self_attn.q_proj.weight": _rand(gen, H, in_w),
          prefix + "self_attn.k_proj.weight": _rand(gen, kv, in_w),
          prefix + "self_attn.v_proj.weight": _rand(gen, kv, in_w),
          prefix + "self_attn.o_proj.weight": _rand(gen, H, H),
          prefix + "post_attention_layernorm.weight": 1 + _rand(gen, H),
          prefix + "mlp.gate_proj.weight": _rand(gen, F, H),
          prefix + "mlp.up_proj.weight": _rand(gen, F, H),
          prefix + "mlp.down_proj.weight": _rand(gen, H, F)}
    if bias:
        for proj, n in (("q_proj", H), ("k_proj", kv), ("v_proj", kv)):
            sd[prefix + f"self_attn.{proj}.bias"] = _rand(gen, n)
    return sd


def _target_sd(gen, qwen2=False):
    sd = {"model.embed_tokens.weight": _rand(gen, V, H),
          "model.norm.weight": 1 + _rand(gen, H), "lm_head.weight": _rand(gen, V, H)}
    for i in range(L):
        p = f"model.layers.{i}."
        sd.update(_attn_mlp(gen, p, H, bias=qwen2))
        sd[p + "input_layernorm.weight"] = 1 + _rand(gen, H)
    return sd


def _draft_sd(gen, version):
    if version == 3:
        sd = _attn_mlp(gen, "midlayer.", 2 * H)
        sd.update({"midlayer.hidden_norm.weight": 1 + _rand(gen, H),
                   "midlayer.input_layernorm.weight": 1 + _rand(gen, H),
                   "fc.weight": _rand(gen, H, 3 * H), "norm.weight": 1 + _rand(gen, H),
                   "lm_head.weight": _rand(gen, DV, H),
                   "d2t": torch.arange(DV) % 5, "t2d": torch.arange(V) < DV})
        return sd
    sd = _attn_mlp(gen, "layers.0.", H, bias=True)
    sd.update({"embed_tokens.weight": _rand(gen, V, H), "fc.weight": _rand(gen, H, 2 * H),
               "fc.bias": _rand(gen, H)})
    return sd


def _write(path, sd, config, fmt):
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(config, f)
    sd = {k: v.contiguous() for k, v in sd.items()}
    keys = sorted(sd)
    halves = [{k: sd[k] for k in keys[::2]}, {k: sd[k] for k in keys[1::2]}]
    if fmt == "safetensors":
        save_file(sd, os.path.join(path, "model.safetensors"))
    elif fmt == "bin":
        torch.save(sd, os.path.join(path, "pytorch_model.bin"))
    else:
        ext = "safetensors" if fmt == "sharded_safetensors" else "bin"
        stem = "model" if ext == "safetensors" else "pytorch_model"
        names = [f"{stem}-0000{i + 1}-of-00002.{ext}" for i in range(2)]
        for name, part in zip(names, halves):
            (save_file if ext == "safetensors" else torch.save)(
                part, os.path.join(path, name))
        index = {"weight_map": {k: names[i] for i, part in enumerate(halves) for k in part}}
        with open(os.path.join(path, f"{stem}.{ext}.index.json"), "w") as f:
            json.dump(index, f)


def _draft_json(version):
    d = dict(TARGET_JSON, num_hidden_layers=1)
    if version == 3:
        d.update(draft_vocab_size=DV, target_hidden_size=H)
    else:
        d["bias"] = True
    return d


def _assert_trees_equal(got, want, path=""):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), path
        for k in want:
            _assert_trees_equal(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_trees_equal(g, w, f"{path}[{i}]")
    else:
        assert got.dtype == want.dtype and got.shape == want.shape, path
        assert got.is_contiguous(), path
        assert torch.equal(got, want), path


@pytest.mark.parametrize("fmt", ["safetensors", "bin", "sharded_safetensors", "sharded_bin"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_load_target_equals_convert_of_jax_tree(tmp_path, fmt, dtype):
    gen = torch.Generator().manual_seed(0)
    qwen2 = fmt == "bin"          # one format also carries the q/k/v biases
    config = dict(TARGET_JSON)
    if qwen2:
        config.update(architectures=["Qwen2ForCausalLM"], model_type="qwen2")
    _write(str(tmp_path), _target_sd(gen, qwen2), config, fmt)
    jdtype = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jparams, jcfg = jloader.load_target(str(tmp_path), dtype=jdtype)
    params, cfg = tloader.load_target(str(tmp_path), dtype=dtype, device="cpu")
    assert cfg == convert.model_config(jcfg, dtype=dtype) and cfg.attn_qkv_bias == qwen2
    _assert_trees_equal(params, convert.target_params(np_tree(jparams), device="cpu"))
    assert params["layers"][0]["wq"].dtype == dtype
    sd, jsd = tloader.load_state_dict(str(tmp_path)), jloader.load_state_dict(str(tmp_path))
    assert sorted(sd) == sorted(jsd)
    np.testing.assert_array_equal(sd["lm_head.weight"].numpy(), jsd["lm_head.weight"])


@pytest.mark.parametrize("version,fmt", [(3, "safetensors"), (3, "bin"),
                                         (1, "safetensors"), (1, "sharded_bin")])
def test_load_draft_equals_convert_of_jax_tree(tmp_path, version, fmt):
    gen = torch.Generator().manual_seed(version)
    _write(str(tmp_path), _draft_sd(gen, version), _draft_json(version), fmt)
    embed = _rand(gen, V, H)
    jdp, jdcfg = jloader.load_draft(str(tmp_path), version=version, dtype=jnp.float32,
                                    target_embed=embed.numpy())
    dp, dcfg = tloader.load_draft(str(tmp_path), version=version, dtype=torch.float32,
                                  target_embed=embed, device="cpu")
    assert dcfg == convert.draft_config(jdcfg)
    _assert_trees_equal(dp, convert.draft_params(np_tree(jdp), device="cpu"))
    if version == 3:
        assert dp["d2t"].dtype == torch.long and dp["t2d"].dtype == torch.bool
        assert torch.equal(dp["embed"]["w"], embed)        # taken from the target
        with pytest.raises(ValueError, match="target_embed"):
            tloader.load_draft(str(tmp_path), version=3, device="cpu")
    else:
        assert "b" in dp["fc"] and "bq" in dp["layers"][0] and "ln1" not in dp["layers"][0]


def test_loader_errors_and_single_file(tmp_path):
    with pytest.raises(FileNotFoundError):
        tloader.load_state_dict(str(tmp_path))
    gen = torch.Generator().manual_seed(5)
    _write(str(tmp_path), _target_sd(gen), TARGET_JSON, "safetensors")
    one = tloader.load_state_dict(os.path.join(str(tmp_path), "model.safetensors"))
    assert len(one) == 3 + 9 * L
    moe = dict(TARGET_JSON, architectures=["MixtralForCausalLM"], model_type="mixtral",
               num_local_experts=4, num_experts_per_tok=2)
    with open(os.path.join(str(tmp_path), "config.json"), "w") as f:
        json.dump(moe, f)
    with pytest.raises(NotImplementedError):
        tloader.load_target(str(tmp_path), device="cpu")


@pytest.mark.parametrize("eagle3,kw", [(True, {}), (False, {}),
                                       (True, dict(target_quant="int4", draft_quant="int8",
                                                   kv_quant="int8", quant_group=16))],
                         ids=["eagle3", "eagle1", "eagle3-quantized"])
def test_from_pretrained_tokens_equal_jax(tmp_path, eagle3, kw):
    gen = torch.Generator().manual_seed(11)
    base, ea = str(tmp_path / "base"), str(tmp_path / "ea")
    version = 3 if eagle3 else 1
    _write(base, _target_sd(gen), TARGET_JSON, "safetensors")
    _write(ea, _draft_sd(gen, version), _draft_json(version), "bin")
    common = dict(use_eagle3=eagle3, total_tokens=15, depth=3, top_k=4, max_len=128, **kw)
    pe = EagleEngine.from_pretrained(base, ea, dtype=torch.float32, device="cpu", **common)
    je = JEngine.from_pretrained(base, ea, dtype=jnp.float32, **common)
    assert pe.ecfg == convert.engine_config(je.ecfg) and pe.device.type == "cpu"
    out = pe.generate(PROMPT, max_new_tokens=24)
    np.testing.assert_array_equal(out, je.generate(PROMPT, max_new_tokens=24))
    np.testing.assert_array_equal(out, pe.generate_vanilla(PROMPT, max_new_tokens=24))
    if kw:
        assert "stacked4" in pe.params and pe.init_target_cache().k.dtype == torch.int8


def test_from_pretrained_options(tmp_path, monkeypatch):
    gen = torch.Generator().manual_seed(12)
    base, ea = str(tmp_path / "base"), str(tmp_path / "ea")
    _write(base, _target_sd(gen), TARGET_JSON, "bin")
    _write(ea, _draft_sd(gen, 3), _draft_json(3), "safetensors")
    tuned = EagleEngine.from_pretrained(base, ea, use_eagle3=True, total_tokens=-1,
                                        max_len=128, dtype=torch.float32, device="cpu",
                                        eos_token_id=2)
    assert tuned.ecfg.total_tokens in (40, 48, 50, 56, 60) and tuned.eos_token_id == 2
    with pytest.raises(NotImplementedError):
        EagleEngine.from_pretrained(base, ea, use_eagle3=True, device="cpu", mesh=object())
    hot = EagleEngine.from_pretrained(base, ea, use_eagle3=True, device="cpu",
                                      max_len=128, dtype=torch.float32, temperature=0.7)
    assert hot.ecfg.temperature == 0.7 and hot.sampled
    out = hot.generate(PROMPT, max_new_tokens=8, seed=1)
    assert len(out) == len(PROMPT) + 8
    np.testing.assert_array_equal(hot.generate(PROMPT, max_new_tokens=8, seed=1), out)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):      # the card unless asked
        EagleEngine.from_pretrained(base, ea, use_eagle3=True)
