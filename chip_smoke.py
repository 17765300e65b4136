"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Phases (any failure exits non-zero):
  1. print the card's name and power limit (nvidia-smi); build the CUDA
     kernels from eagle_tpu_torch/csrc (one nvcc per source, in parallel);
  2. hold each kernel against its plain PyTorch version on the card at the
     main path's shapes, and time kernel / plain / library call / bound;
  3. exactness: a small fp32 model with both kernels on — greedy speculative
     output (generate, generate_fused) equals generate_vanilla;
  4. the main path at full width: a Llama-3.1-8B-wide bf16 target and an
     EAGLE-3 draft (seeded random weights made on the card) answer three
     requests with generate_fused; then forced replay of a vanilla trajectory;
  5. print {"kernels": [...]} and, as the last line,
     {"ok": true, "device": {...}}.

Exits non-zero without a result when CUDA is unavailable.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

from eagle_tpu_torch import full_width
from eagle_tpu_torch.config import DraftConfig, EngineConfig, ModelConfig
from eagle_tpu_torch.engine.engine import EagleEngine
from eagle_tpu_torch.models import draft as draft_mod
from eagle_tpu_torch.models import transformer
from eagle_tpu_torch.ops import _build
from eagle_tpu_torch.ops import attn_kernels as ak
from eagle_tpu_torch.ops.kv_cache import compact_rows_plain, window
from eagle_tpu_torch.ops.tree import ancestor_mask

HBM_BYTES_PER_S = 3.35e12       # H100 SXM HBM3 (NVIDIA data sheet)
BF16_FLOPS_PER_S = 989e12       # H100 SXM dense bf16 tensor-core peak
FP32_TOL = dict(rtol=1e-5, atol=1e-5)   # fp32 kernel vs plain: order of sums only
# bf16: kernel and plain version both compute in f32 from the same bf16 inputs
# and differ only in the order of sums and the final rounding to bf16. Against
# the plain version's f32 output (before the cast) the kernel is held to half a
# bf16 ulp (2**-8 relative); against its bf16 output, to one ulp (2**-7). The
# atol covers f32 summation order on outputs near zero.
BF16_TOL_F32 = dict(rtol=2.0 ** -8, atol=1e-5)
BF16_TOL = dict(rtol=2.0 ** -7, atol=1e-5)
T_TREE, NQ, NKV, HD, S_CACHE = 61, 32, 8, 128, 2176   # slice shapes (layer view)
L_TGT, PATH = 32, [0, 3, 7, 7, 7, 7, 7]
HOST_LEAD_CYCLES = 2_000_000     # ~1 ms of device spin ahead of each timed call


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def fail(msg: str) -> None:
    log(f"FAILED: {msg}")
    sys.exit(1)


def device_time_ms(fn, reps: int = 30, flush: torch.Tensor | None = None) -> float:
    """Median device time of one call (CUDA events) after warm-up. With
    `flush`, a write over a buffer larger than L2 precedes every timed call,
    so the call finds its inputs in device memory, as the main path does.
    A device-side spin of ~1 ms before the start event keeps the card busy
    while the host enqueues the call, so the events bracket device work and
    not host launch gaps."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        if flush is not None:
            flush.zero_()
        torch.cuda._sleep(HOST_LEAD_CYCLES)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def rand_tree_mask(T: int, rng: np.random.Generator, dev) -> torch.Tensor:
    parents = np.zeros(T, np.int64)
    for i in range(1, T):
        parents[i] = rng.integers(0, i)
    return ancestor_mask(torch.from_numpy(parents).to(dev), T).contiguous()


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max())


def tol_used(a: torch.Tensor, b: torch.Tensor, tol: dict) -> float:
    """max |a - b| / (atol + rtol |b|): the share of assert_close's limit used."""
    b = b.float()
    return float(((a.float() - b).abs() / (tol["atol"] + tol["rtol"] * b.abs())).max())


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def check_tree_attention(dev, flush) -> dict:
    rng = np.random.default_rng(0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)

    def inputs(T, Tk, nq, nkv, S, dtype, mask=None):
        r = lambda *s: torch.randn(s, generator=gen, device=dev).to(dtype)
        tm = rand_tree_mask(T, rng, dev) if mask is None else mask
        return (r(T, nq, HD), r(nkv, S, HD), r(nkv, S, HD), r(Tk, nkv, HD),
                r(Tk, nkv, HD), tm)

    worst_bf16 = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        args = inputs(T_TREE, T_TREE, NQ, NKV, S_CACHE, dtype)
        for start in (0, 1, 777, 2048):
            st = torch.tensor(start, device=dev)
            got = ak.tree_attention(*args, st)
            ref = ak.tree_attention_ref(*args, st)
            torch.cuda.synchronize()
            err = max_err(got, ref)
            if dtype == torch.float32:
                log(f"[B1] float32  start={start:5d} max_abs_err={err:.3e} "
                    f"(tolerance {FP32_TOL})")
                torch.testing.assert_close(got, ref, **FP32_TOL)
                continue
            ref32 = ak.tree_attention_ref(*(a.float() if a.is_floating_point() else a
                                            for a in args), st)
            log(f"[B1] bfloat16 start={start:5d} max_abs_err={err:.3e}, "
                f"{tol_used(got, ref, BF16_TOL):.3f} of the tolerance {BF16_TOL} "
                f"vs plain bf16; {max_err(got, ref32):.3e}, "
                f"{tol_used(got, ref32, BF16_TOL_F32):.3f} of {BF16_TOL_F32} vs "
                f"plain f32; mean |ref| {float(ref32.abs().mean()):.3e}")
            torch.testing.assert_close(got, ref, **BF16_TOL)
            torch.testing.assert_close(got.float(), ref32, **BF16_TOL_F32)
            worst_bf16 = max(worst_bf16, err)
    # odd shape: g = 1, T = 13 queries against a non-square Tk = 40 slab
    bm = torch.from_numpy(rng.random((13, 40)) < 0.3).to(dev)
    bm[:, 0] = True
    args = inputs(13, 40, 8, 8, 256, torch.float32, mask=bm.contiguous())
    st = torch.tensor(77, device=dev)
    got, ref = ak.tree_attention(*args, st), ak.tree_attention_ref(*args, st)
    torch.testing.assert_close(got, ref, **FP32_TOL)
    log(f"[B1] odd shape g=1 T=13 Tk=40 max_abs_err={max_err(got, ref):.3e} "
        f"(tolerance {FP32_TOL})")

    # timing at the main path's shape: bf16, start = 1024
    start = 1024
    args = inputs(T_TREE, T_TREE, NQ, NKV, S_CACHE, torch.bfloat16)
    st = torch.tensor([start], dtype=torch.int32, device=dev)  # as the kernel reads it
    q, kc, vc, kt, vt, tm = args
    ms = device_time_ms(lambda: ak.tree_attention(*args, st), flush=flush)
    plain_ms = device_time_ms(lambda: ak.tree_attention_ref(*args, st), flush=flush)
    # library yardstick: one SDPA call over the concatenated prefix+tree keys
    kcat = torch.cat([kc[:, :start], kt.transpose(0, 1)], dim=1)[None]
    vcat = torch.cat([vc[:, :start], vt.transpose(0, 1)], dim=1)[None]
    lmask = torch.cat([torch.ones(T_TREE, start, dtype=torch.bool, device=dev), tm], 1)
    qs = q.transpose(0, 1)[None]
    sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(
        qs, kcat, vcat, attn_mask=lmask[None, None], enable_gqa=True)
    lib_err = max_err(sdpa()[0].transpose(0, 1).reshape(T_TREE, NQ * HD),
                      ak.tree_attention_ref(*args, st))
    library_ms = device_time_ms(sdpa, flush=flush)
    es = 2
    nbytes = (2 * T_TREE * NQ * HD * es + 2 * NKV * start * HD * es
              + 2 * T_TREE * NKV * HD * es + T_TREE * T_TREE)
    flops = 4 * T_TREE * NQ * (start + T_TREE) * HD
    bound_ms = max(nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS_PER_S) * 1e3
    bound_by = "bytes" if nbytes / HBM_BYTES_PER_S >= flops / BF16_FLOPS_PER_S else "operations"
    log(f"[B1] bf16 start={start}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"sdpa {library_ms:.4f} ms (err vs plain {lib_err:.2e}), bound {bound_ms:.5f} ms "
        f"({bound_by}; {nbytes} B, {flops} flop)")
    return {"name": "tree_attention", "route": "cuda",
            "source": "eagle_tpu_torch/csrc/tree_attention.cu",
            "replaces": "eagle_tpu/ops/pallas_attn.py:32",
            "max_abs_err": worst_bf16, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms}


def check_compact_rows(dev, flush) -> dict:
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    shape = (L_TGT, 1, NKV, S_CACHE, HD)
    k0 = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
    v0 = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
    path = torch.tensor(PATH, device=dev)
    P = len(PATH)
    worst = 0.0
    for start in (0, 1000, S_CACHE - 64):
        st = torch.tensor(start, device=dev)
        k1, v1 = k0.clone(), v0.clone()
        k2, v2 = k0.clone(), v0.clone()
        ak.compact_rows(k1, v1, path, st)
        compact_rows_plain(k2, v2, path, st)
        torch.cuda.synchronize()
        for got, exp in ((k1, k2), (v1, v2)):
            if not torch.equal(got, exp):
                fail(f"compact_rows start={start}: differs from compact_accepted")
            worst = max(worst, max_err(got[..., : start + P, :], exp[..., : start + P, :]))
        log(f"[B2] start={start:5d}: identical to compact_accepted, all rows "
            "(tolerance: exact)")
    st = torch.tensor([1000], dtype=torch.int32, device=dev)  # as the kernel reads them
    path = path.to(torch.int32)
    k1, v1 = k0.clone(), v0.clone()
    ms = device_time_ms(lambda: ak.compact_rows(k1, v1, path, st), flush=flush)
    plain_ms = device_time_ms(lambda: compact_rows_plain(k1, v1, path, st), flush=flush)
    src = (st + path).long()
    dst = window(st[0], P, S_CACHE)

    def library():
        for t in (k1, v1):
            t[:, 0].index_copy_(2, dst, t[:, 0].index_select(2, src))

    library_ms = device_time_ms(library, flush=flush)
    nbytes = 2 * 2 * L_TGT * NKV * P * HD * 2 + 4 * P
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    log(f"[B2] kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, index_select+index_copy_ "
        f"{library_ms:.4f} ms, bound {bound_ms:.5f} ms ({nbytes} B)")
    return {"name": "compact_rows", "route": "cuda",
            "source": "eagle_tpu_torch/csrc/compact_rows.cu",
            "replaces": "eagle_tpu/ops/pallas_attn.py:187",
            "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": "bytes", "library_ms": library_ms}


# ---------------------------------------------------------------------------
# phase 3: greedy speculative == vanilla in fp32 with both kernels on
# ---------------------------------------------------------------------------

def check_exactness(dev) -> None:
    cfg = ModelConfig(vocab_size=1024, hidden_size=512, intermediate_size=1024,
                      num_layers=4, num_q_heads=8, num_kv_heads=2, head_dim=128,
                      dtype=torch.float32, attn_impl="pallas_tree")
    dcfg = DraftConfig(version=3, hidden_size=512, intermediate_size=1024,
                       num_q_heads=8, num_kv_heads=2, head_dim=128,
                       vocab_size=1024, draft_vocab_size=512,
                       target_hidden_size=512, dtype=torch.float32)
    ecfg = EngineConfig(total_tokens=60, depth=5, top_k=10, max_len=512,
                        compact_impl="pallas")
    params = transformer.init_params(cfg, seed=10, device=dev)
    dparams = draft_mod.init_params(dcfg, seed=11, device=dev)
    eng = EagleEngine(params, cfg, dparams, dcfg, ecfg, device=dev)
    rng = np.random.default_rng(2)
    ak.reset_launch_counts()
    for n in (5, 40, 130):
        prompt = rng.integers(0, cfg.vocab_size, n)
        van = eng.generate_vanilla(prompt, max_new_tokens=64)
        spec = eng.generate(prompt, max_new_tokens=64)
        fused = eng.generate_fused(prompt, max_new_tokens=64)
        for name, out in (("generate", spec), ("generate_fused", fused)):
            if len(out) != len(van) or not np.array_equal(out, van):
                bad = int(np.argmax(out[: len(van)] != van[: len(out)]))
                fail(f"fp32 {name} != generate_vanilla (prompt {n}, index {bad})")
        log(f"[exact] prompt {n:3d}: generate == generate_fused == vanilla "
            f"({len(van) - n} tokens)")
    if min(ak.LAUNCHES.values()) == 0:
        fail(f"fp32 phase did not launch every kernel: {ak.LAUNCHES}")


# ---------------------------------------------------------------------------
# phase 4: the main path at full width
# ---------------------------------------------------------------------------

def main_path(dev) -> tuple[dict, dict]:
    t0 = time.time()
    eng = full_width.engine(dev)
    cfg = eng.cfg
    torch.cuda.synchronize()
    log(f"[main] random bf16 weights on the card in {time.time() - t0:.1f} s; "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in (24, 311, 977)]
    new = 128
    eng.generate_fused(prompts[0][:8], max_new_tokens=16)     # warm-up
    eng.generate_vanilla(prompts[0][:8], max_new_tokens=4)
    torch.cuda.synchronize()

    # three requests through the speculative main path
    ak.reset_launch_counts()
    t0 = time.time()
    outs, committed, rounds = [], 0, 0
    for p in prompts:
        out, n, r = eng.generate_fused(p, max_new_tokens=new, log=True)
        outs.append(out)
        committed += n
        rounds += r
    torch.cuda.synchronize()
    spec_s = time.time() - t0
    launches = dict(ak.LAUNCHES)
    for p, out in zip(prompts, outs):
        if len(out) != len(p) + new or not np.array_equal(out[: len(p)], p):
            fail(f"request of {len(p)} tokens returned {len(out)} tokens")
    if launches["tree_attention"] != cfg.num_layers * rounds:
        fail(f"tree_attention launched {launches['tree_attention']} times, "
             f"expected {cfg.num_layers} x {rounds} verify forwards")
    if launches["compact_rows"] != rounds:
        fail(f"compact_rows launched {launches['compact_rows']} times for {rounds} rounds")

    # vanilla baseline on request 0, then forced replay of its trajectory
    P = eng.path_len
    torch.cuda.synchronize()
    t0 = time.time()
    van = eng.generate_vanilla(prompts[0], max_new_tokens=new + P + 1)
    torch.cuda.synchronize()
    van_s = time.time() - t0
    ak.reset_launch_counts()
    fout, fn, frounds, live = eng.generate_fused(prompts[0], max_new_tokens=new,
                                                 log=True, force_tokens=van)
    if not np.array_equal(fout, van[: len(fout)]) or len(fout) != len(prompts[0]) + new:
        fail("forced replay did not reproduce the vanilla trajectory")
    if (ak.LAUNCHES["tree_attention"] != cfg.num_layers * frounds
            or ak.LAUNCHES["compact_rows"] != frounds):
        fail(f"forced replay launch counts {ak.LAUNCHES} for {frounds} rounds")
    Lp = len(prompts[0])
    diff = np.nonzero(outs[0][Lp:] != van[Lp: Lp + new])[0]
    stats = {
        "prompt_lens": [len(p) for p in prompts], "new_tokens_each": new,
        "spec_tokens_per_s": 3 * new / spec_s, "spec_rounds": rounds,
        "tau": committed / rounds,
        "vanilla_tokens_per_s": (new + P + 1) / van_s,
        "forced_replay_tau": fn / frounds,
        "forced_replay_live_agreement": live / fn,
        "first_free_running_divergence": int(diff[0]) if diff.size else None,
        "weights": "random (seeded), lm_head x8",
    }
    log(f"[main] {json.dumps(stats)}")
    return launches, stats


def main() -> None:
    if not torch.cuda.is_available():
        fail("CUDA is not available")
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "nvidia-smi failed"
    print(card, flush=True)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")

    t0 = time.time()
    _build.build()
    log(f"[build] {len(_build.SOURCES)} CUDA sources built in {time.time() - t0:.1f} s")
    for name, out in _build.BUILD_LOG.items():
        for line in out.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")

    flush = torch.empty(128 * 2**20, dtype=torch.uint8, device=dev)
    kernels = [check_tree_attention(dev, flush), check_compact_rows(dev, flush)]
    del flush
    check_exactness(dev)
    launches, _ = main_path(dev)
    for k in kernels:
        k["launches"] = launches[k["name"]]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
