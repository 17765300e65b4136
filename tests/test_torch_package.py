"""Package rules of the PyTorch port: no JAX and nothing of eagle_tpu in
eagle_tpu_torch/ or chip_smoke.py, CUDA by default, configs that mean the same
thing on both sides, and a chip smoke script that fails without a card."""

import ast
import dataclasses
import filecmp
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import eagle_tpu_torch
from eagle_tpu import config as jconfig
from eagle_tpu_torch import convert
from eagle_tpu_torch.config import CONFIG_DIR, DraftConfig, EngineConfig, ModelConfig
from eagle_tpu_torch import probe_w4_ablate
from eagle_tpu_torch.engine.engine import EagleEngine, calibrate_total_tokens
from eagle_tpu_torch.models import hf_loader
from eagle_tpu_torch.models import draft as draft_mod
from eagle_tpu_torch.models import transformer
from eagle_tpu_torch.ops.kv_cache import init_cache
from eagle_tpu_torch.ops import paged_kv

from test_engine_greedy import make_engine
from torch_port_util import np_tree, port_engine

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.dirname(os.path.abspath(eagle_tpu_torch.__file__))
FORBIDDEN = {"jax", "jaxlib", "eagle_tpu"}


def _port_sources(suffixes=(".py",)):
    files = [os.path.join(ROOT, "chip_smoke.py")] if ".py" in suffixes else []
    for dirpath, _, names in os.walk(PKG):
        if os.path.basename(dirpath) in ("_build", "__pycache__"):
            continue
        files += [os.path.join(dirpath, n) for n in names if n.endswith(suffixes)]
    return sorted(files)


def _imported_top_levels(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_or_eagle_tpu_imports(path):
    bad = sorted(set(_imported_top_levels(path)) & FORBIDDEN)
    assert not bad, f"{os.path.relpath(path, ROOT)} imports {bad}"


def test_walk_covers_the_quantized_modules_and_kernels():
    rel = {os.path.relpath(p, PKG) for p in _port_sources((".py", ".cu", ".cuh"))}
    assert {"ops/quant.py", "ops/quant4.py", "ops/score_topk.py", "ops/_launch.py",
            "csrc/w4_matmul.cu", "csrc/score_topk.cu", "csrc/w4_mma.cuh",
            "csrc/tree_attention.cu", "csrc/compact_rows.cu", "csrc/w4_ablate.cu",
            "ops/w4_ablate.py", "probe_w4_ablate.py", "models/hf_loader.py"} <= rel


# a kernel of the port is written by hand: no library GEMM, sort or top-k, and
# no PyTorch header (which would also make each build take minutes)
_NO_LIBRARY = ("cublas", "cutlass", "cub/", "cub::", "thrust", "torch/", "ATen",
               "cudnn", "jax", "eagle_tpu/engine")


@pytest.mark.parametrize("path", _port_sources((".cu", ".cuh")),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_cuda_sources_are_hand_written(path):
    src = open(path).read()
    includes = [ln for ln in src.splitlines() if ln.lstrip().startswith("#include")]
    for ln in includes:
        assert not any(word in ln for word in _NO_LIBRARY), ln
    code = "\n".join(ln.split("//")[0] for ln in src.splitlines())
    assert not any(word in code for word in ("cublas", "cub::", "thrust::")), path


def test_forbidden_names_are_matched_exactly():
    """`eagle_tpu_torch` starts with `eagle_tpu`: the scan compares whole
    top-level names, so the port's own imports are allowed."""
    names = set(_imported_top_levels(os.path.join(ROOT, "chip_smoke.py")))
    assert "eagle_tpu_torch" in names and not names & FORBIDDEN


def test_engine_defaults_to_cuda(monkeypatch):
    pe = port_engine(make_engine(1))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        EagleEngine(pe.params, pe.cfg, pe.dparams, pe.dcfg, pe.ecfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        eagle_tpu_torch.resolve_device("cuda")
    assert eagle_tpu_torch.resolve_device("cpu").type == "cpu"


_ENTRY_POINTS = {
    "transformer.init_params": lambda j: transformer.init_params(convert.model_config(j.cfg)),
    "draft.init_params": lambda j: draft_mod.init_params(convert.draft_config(j.dcfg)),
    "convert.to_tensor": lambda j: convert.to_tensor(np.zeros(3)),
    "convert.target_params": lambda j: convert.target_params(np_tree(j.params)),
    "convert.draft_params": lambda j: convert.draft_params(np_tree(j.dparams)),
    "init_cache": lambda j: init_cache(1, 1, 1, 8, 4),
    "init_cache[int8]": lambda j: init_cache(1, 1, 1, 8, 4, kv_quant="int8"),
    "paged_kv.init_pool": lambda j: paged_kv.init_pool(1, 1, 2, 4, 4),
    "calibrate_total_tokens": lambda j: calibrate_total_tokens(
        {}, convert.model_config(j.cfg), candidates=(4,), weights=(1.0,), reps=1),
    "hf_loader.convert_target": lambda j: hf_loader.convert_target(
        {}, convert.model_config(j.cfg)),
    "hf_loader.convert_draft": lambda j: hf_loader.convert_draft(
        {}, convert.draft_config(j.dcfg)),
    "probe_w4_ablate.run_mode": lambda j: probe_w4_ablate.run_mode("full"),
    "probe_w4_ablate.main": lambda j: probe_w4_ablate.main([]),
}


@pytest.mark.parametrize("name", sorted(_ENTRY_POINTS))
def test_entry_points_default_to_cuda(monkeypatch, name):
    """Without device="cpu" every entry point that makes tensors asks for the
    card, and raises when CUDA is absent instead of running on the CPU."""
    jeng = make_engine(1)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        _ENTRY_POINTS[name](jeng)


def test_probe_sweeps_keep_the_jax_lists():
    """The sweeps' names and their (mode, group, block_n) lists are those of
    tools/probe_w4_ablate.py, minus r4b's `parallel=True` run, plus `all`."""
    s = probe_w4_ablate.SWEEPS
    assert s["default"] == [(m, 128, bn) for m in ("full", "i32_storage", "no_unpack")
                            for bn in (256, 1024)]
    assert s["r4"] == [("i32_storage", 128, 1024), ("fused_unpack", 128, 1024),
                       ("fused_unpack", 128, 2048), ("batched_dot", 128, 1024),
                       ("batched_dot", 128, 512)]
    assert s["m512"] == [("fused_unpack", 128, 2048), ("bf16_dots", 128, 1024),
                         ("one_dot_bf16", 128, 1024), ("one_dot", 128, 2048)]
    assert s["r4b"] == [("no_unpack", 128, 1024), ("no_unpack", 128, 2048),
                        ("fused_unpack", 128, 2048), ("fused_unpack", 256, 2048),
                        ("fused_unpack", 512, 2048), ("fused_unpack", 128, 1536)]
    assert {m for m, _, _ in s["all"]} == set(probe_w4_ablate.ablate.__globals__["MODES"])
    assert (probe_w4_ablate.S, probe_w4_ablate.K, probe_w4_ablate.N) == (24, 4096, 4096)
    assert probe_w4_ablate.PEAK_BW == 3.35e12
    with pytest.raises(ValueError, match="sweep"):
        probe_w4_ablate.run_sweep("r5")


def test_chip_smoke_fails_without_cuda():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def test_draft_config_copy_is_the_published_one():
    assert filecmp.cmp(os.path.join(CONFIG_DIR, "llama3_8B_eagle3_config.json"),
                       os.path.join(ROOT, "eagle_tpu", "train", "configs",
                                    "llama3_8B_eagle3_config.json"), shallow=False)


@pytest.mark.parametrize("name", ["llama3_8B_target.json",
                                  "llama3_8B_eagle3_config.json"])
def test_configs_parse_the_same_on_both_sides(name):
    path = os.path.join(CONFIG_DIR, name)
    if "eagle3" in name:
        j, p = (jconfig.DraftConfig.from_hf_json(path, version=3),
                DraftConfig.from_hf_json(path, version=3))
        assert p == convert.draft_config(j, dtype=torch.bfloat16)
    else:
        j, p = jconfig.ModelConfig.from_hf_json(path), ModelConfig.from_hf_json(path)
        assert p == convert.model_config(j, dtype=torch.bfloat16)
        assert (p.hidden_size, p.intermediate_size, p.num_layers, p.num_q_heads,
                p.num_kv_heads, p.head_dim, p.vocab_size) == (
            4096, 14336, 32, 32, 8, 128, 128256)
        assert p.rope.scaling_type == "llama3" and p.rope.theta == 500000.0
        assert p.tap_layers == j.tap_layers == (2, 16, 29)
    assert j.dtype == jnp.bfloat16 and p.dtype == torch.bfloat16


def test_engine_config_defaults_match():
    j, p = jconfig.EngineConfig(), EngineConfig()
    for f in dataclasses.fields(j):
        assert getattr(p, f.name) == getattr(j, f.name), f.name
    assert p.tree_size == j.tree_size


def test_convert_keeps_bf16_bits_and_index_types():
    import ml_dtypes

    rng = np.random.default_rng(0)
    w = rng.normal(size=(4, 6)).astype(ml_dtypes.bfloat16)
    tw = convert.to_tensor(w, device="cpu")
    assert tw.dtype == torch.bfloat16
    np.testing.assert_array_equal(tw.view(torch.int16).numpy(), w.view(np.int16))
    assert convert.to_tensor(np.arange(3, dtype=np.int32), device="cpu").dtype == torch.long
    assert convert.to_tensor(np.ones(3, bool), device="cpu").dtype == torch.bool
    # quantized leaves keep their integer types (tests/test_torch_quant.py)
    assert convert.to_tensor(np.ones(3, np.int8), device="cpu").dtype == torch.int8
    assert convert.to_tensor(np.arange(3, dtype=np.int32), device="cpu",
                             keep_int=True).dtype == torch.int32
