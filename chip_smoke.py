"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Phases (any failure exits non-zero):
  1. print the card's name and power limit (nvidia-smi); build the CUDA
     kernels from eagle_tpu_torch/csrc (one nvcc per source, in parallel);
  2. hold each kernel against its plain PyTorch version on the card at its
     path's shapes (tree attention within a stated tolerance, also at the
     static tree's T = 26, at head_dim 64 and at start one below, on and one
     above every prefix chunk edge of a 1024-row cache view; compaction
     exactly, on the overlapping path, an identity path, an identity prefix
     with moves, P = 1, a window clamped at the cache's end, a row-sliced
     view and 128-byte rows; the w4a8 matmuls bit for bit and invariant in
     the number of rows, at every M edge of their tiles, group size and
     blocked layout, and at shapes that make ops/quant4.w4_plan pick each
     kernel instantiation; the fused scorer with identical ids at M = 1, 10,
     17, 32, and at M = 33, 64 with k = 17, 32, 128, random and tied, w4 and
     w8, and past one column tile at k = 129, 256, 1024 and k = V; tree
     attention also at head_dim 80, 96 and 256, over a batch of 4 rows in one
     launch (starts 0, 300, 1024, 2000, the full cache and a 2048-row view,
     each row bit-identical to its own launch) and past head_dim 256 on the
     wide route (320, 512); the f32 route row-exact: verify rows of three
     batched trees bit-identical to one-token steps at start + depth, a
     300-row prefill to its chunks of 64 and 37; the nine ablation variants
     of the w4a8 body bit for bit at M = 5, 32, 61, 512, every block_n of
     the probe's sweeps, groups 4 to 1024 and a ragged N, `i32_storage`
     against B3's kernel alone), and time kernel /
     plain / library call / bound, with the kernel/library ratios (the fused
     scorer: wrapper, kernel alone and the unfused chain the drafter runs
     without fused scoring, at M = 1, 10, 32 and past them, and at a batch
     of 4's M = 4 and 40; B3/B4 also at M = 244; tree attention batched
     beside one SDPA call with a dense batched mask; the f32 route at the
     main path's shape beside one f32 SDPA call; the ablation variants
     beside one bf16 torch.mm at M = 32, 61 and 512);
  3. exactness: small fp32 models with the kernels on: greedy speculative
     output (generate, generate_fused) equals generate_vanilla, for the
     dense target, for an int4 target + int4 draft + fused scoring, for an
     int8 draft + fused scoring, for a static-tree engine, for kv_buckets
     across a bucket edge, for an int8 KV cache and for a head_dim-64
     target; generate_stream ends on generate_fused's ids; with two logits
     one ulp apart in every row; generate_vanilla(max_new_tokens=0) returns
     the prompt; sampled engines at sampling_top_k = 1 (one-hot
     distributions, so every rule is deterministic) equal the greedy
     vanilla decode under every acceptance rule and tree kind; a round of
     each of these engines waits on no host sync (torch's sync debug mode
     "error"); batched (B = 3 ragged prompts), every row of
     generate_batch_fused equals its generate_vanilla for the dense, int4,
     static-tree, kv_buckets and int8-KV engines, with forced replay and
     EOS per row, B1 once per layer for the prefill and once per layer
     and round and no B2, and a batched round waits on no host sync; every
     row of every engine is held, the int4 rows of the prompts where fault
     C6 showed included; sessions and servers (fp32, dense and int4): a
     3-turn EagleSession, EagleServer over 5 staggered requests (async)
     and PagedEagleServer (chunked prefill, a pool that forces a
     preemption, a 200-token prefix adopted) equal every request's
     generate_vanilla; the sampled
     acceptance rules over 200k trials on the card's generator follow the
     target's first- and second-token distributions;
  4. the paths at full width (Llama-3.1-8B widths, EAGLE-3 draft, seeded
     random weights made on the card): (a) the bf16 path answers one request
     with generate_fused; (b) over the same weights, the static-tree +
     kv_buckets engine answers one request through generate_stream and two
     through generate_fused, the int8-KV engine answers one (and launches
     neither attention-side kernel), and calibrate_total_tokens times the
     target; (c) the int4 serving path (w4a8 target, int4 draft, fused draft
     scoring) answers two requests; (d) the Llama-3.2-1B-class path at
     head_dim 64 (full_width.engine_hd64, bf16) answers two requests; (e) the
     ablation probe runs its `all` sweep with short chains. (a), (c) and (d)
     then run the vanilla baseline and a forced replay of its trajectory.
     Sampled requests (temperature 0.7, top_p 0.9, 64 new tokens): the bf16
     path under "true_q" (its dynamic tree takes the q(x) = 1 rule), the
     static path under "true_q" (sampled candidates), the int4 path under
     "true_q_dynamic". Batched (B = 4, prompts of 24, 311, 977 and 150
     tokens, 128 new tokens each, generate_batch_fused) on the bf16 and
     int4 paths: aggregate tok/s, round time, launches per round (B1 = the
     layer count) and peak memory. Served on the bf16 and int4 paths:
     PagedEagleServer (B = 4, 16-row pages, chunks of 256, async, prefix
     cache) over 8 requests (24, 311, 977, 150, 311 sharing 300 tokens
     with the first 311, 24, 500, 977 tokens, 128 new each): lengths and
     finish reasons, aggregate tok/s, rounds, B1 a round, pool bytes, peak
     memory, preemptions, prefix hits and host syncs a scheduler step. Every path starts with the launch
     counts at 0, and its counts are checked against the run's own numbers;
  5. print {"kernels": [...]} and, as the last line,
     {"ok": true, "device": {...}}; the run's own wall time goes to stderr.

Exits non-zero without a result when CUDA is unavailable.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import os
import subprocess
import sys
import time
import warnings

import numpy as np
import torch

from eagle_tpu_torch import full_width, probe_w4_ablate
from eagle_tpu_torch.compare_kernels import device_time_ms
from eagle_tpu_torch.config import DraftConfig, EngineConfig, ModelConfig
from eagle_tpu_torch.engine.engine import EagleEngine, calibrate_total_tokens
from eagle_tpu_torch.engine.paged import PagedEagleServer
from eagle_tpu_torch.engine.server import EagleServer
from eagle_tpu_torch.engine.session import EagleSession
from eagle_tpu_torch.models import draft as draft_mod
from eagle_tpu_torch.models import transformer
from eagle_tpu_torch.ops import _build
from eagle_tpu_torch.ops import attn_kernels as ak
from eagle_tpu_torch.ops import quant as tq
from eagle_tpu_torch.ops import quant4 as tq4
from eagle_tpu_torch.ops import score_topk as stk
from eagle_tpu_torch.ops import w4_ablate as wab
from eagle_tpu_torch.ops.kv_cache import compact_rows_plain, window
from eagle_tpu_torch.ops.tree import MC_SIM_7B_63, ancestor_mask, paths_to_parents

HBM_BYTES_PER_S = 3.35e12       # H100 SXM HBM3 (NVIDIA data sheet)
BF16_FLOPS_PER_S = 989e12       # H100 SXM dense bf16 tensor-core peak
FP32_FLOPS_PER_S = 67e12        # H100 SXM float32 outside the tensor cores (data sheet)
INT8_OPS_PER_S = 1979e12        # H100 SXM dense int8 tensor-core peak (data sheet)
FP32_TOL = dict(rtol=1e-5, atol=1e-5)   # fp32 kernel vs plain: order of sums only
# bf16: kernel and plain version both compute in f32 from the same bf16 inputs
# and differ only in the order of sums and the final rounding to bf16. Against
# the plain version's f32 output (before the cast) the kernel is held to half a
# bf16 ulp (2**-8 relative); against its bf16 output, to one ulp (2**-7). The
# atol covers f32 summation order on outputs near zero.
BF16_TOL_F32 = dict(rtol=2.0 ** -8, atol=1e-5)
BF16_TOL = dict(rtol=2.0 ** -7, atol=1e-5)
T_TREE, NQ, NKV, HD, S_CACHE = 61, 32, 8, 128, 2176   # slice shapes (layer view)
HD64 = 64                                             # the hd64 path's head_dim
OTHER_HEAD_DIMS = (80, 96, 256)    # head widths of other families, at padded widths
L_TGT, PATH = 32, [0, 3, 7, 7, 7, 7, 7]
T_STATIC = len(MC_SIM_7B_63) + 1                      # the static tree's 26 nodes
# the kernels an engine can launch (the w4_ablate variants belong to the probe)
ENGINE_KERNELS = ("tree_attention", "compact_rows", "qdense4", "qdense4_stacked",
                  "score_topk_quant")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def fail(msg: str) -> None:
    log(f"FAILED: {msg}")
    sys.exit(1)


def rand_tree_mask(T: int, rng: np.random.Generator, dev) -> torch.Tensor:
    parents = np.zeros(T, np.int64)
    for i in range(1, T):
        parents[i] = rng.integers(0, i)
    return ancestor_mask(torch.from_numpy(parents).to(dev), T).contiguous()


def _nonzero(counts: dict) -> dict:
    return {k: v for k, v in counts.items() if v}


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

    def inputs(T, Tk, nq, nkv, S, dtype, mask=None, hd=HD):
        r = lambda *s: torch.randn(s, generator=gen, device=dev).to(dtype)
        tm = rand_tree_mask(T, rng, dev) if mask is None else mask
        return (r(T, nq, hd), r(nkv, S, hd), r(nkv, S, hd), r(Tk, nkv, hd),
                r(Tk, nkv, hd), tm)

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

    # the static-tree path's shape: T = 26 under the published topology's mask,
    # against a row-sliced view of the cache (kv_buckets: the first 1024 rows)
    sm = ancestor_mask(torch.from_numpy(paths_to_parents(MC_SIM_7B_63)).to(dev).long(),
                       T_STATIC).contiguous()
    for dtype, tol in ((torch.float32, FP32_TOL), (torch.bfloat16, BF16_TOL)):
        q, kc, vc, kt, vt, _ = inputs(T_STATIC, T_STATIC, NQ, NKV, S_CACHE, dtype, mask=sm)
        st = torch.tensor(700, device=dev)
        got = ak.tree_attention(q, kc[:, :1024], vc[:, :1024], kt, vt, sm, st)
        ref = ak.tree_attention_ref(q, kc, vc, kt, vt, sm, st)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, ref, **tol)
        log(f"[B1] static tree T={T_STATIC}, 1024-row view, {dtype}: max_abs_err="
            f"{max_err(got, ref):.3e} (tolerance {tol})")

    # every split of the prefix between blocks: start one below, on and one
    # above each chunk edge of a 1024-row view, at T = 26 and 61; and the odd
    # shape in bf16 (g = 1: 13 rows of a 64-row tile)
    ch = ak.TREE_CHUNK
    starts = [0] + [e + o for e in range(ch, 1025, ch) for o in (-1, 0, 1)]
    for dtype, tol in ((torch.float32, FP32_TOL), (torch.bfloat16, BF16_TOL)):
        used = 0.0
        for T, mask in ((T_STATIC, sm), (T_TREE, None)):
            q, kc, vc, kt, vt, tm = inputs(T, T, NQ, NKV, S_CACHE, dtype, mask=mask)
            args = (q, kc[:, :1024], vc[:, :1024], kt, vt, tm)
            for start in starts:
                st = torch.tensor(start, device=dev)
                got, ref = ak.tree_attention(*args, st), ak.tree_attention_ref(*args, st)
                torch.testing.assert_close(got, ref, **tol)
                used = max(used, tol_used(got, ref, tol))
                if dtype == torch.bfloat16:
                    ref32 = ak.tree_attention_ref(*(a.float() if a.is_floating_point() else a
                                                    for a in args), st)
                    torch.testing.assert_close(got.float(), ref32, **BF16_TOL_F32)
                    used = max(used, tol_used(got, ref32, BF16_TOL_F32))
        log(f"[B1] {dtype}: starts {starts[1:4]}..{starts[-3:]} around every {ch}-key chunk "
            f"edge, 1024-row view, T = {T_STATIC} and {T_TREE}: within {tol}"
            + (f" and {BF16_TOL_F32} vs plain f32" if dtype == torch.bfloat16 else "")
            + f"; at most {used:.3f} of a limit used")
    args = inputs(13, 40, 8, 8, 256, torch.bfloat16, mask=bm.contiguous())
    for start in (0, 77, 128, 256):
        st = torch.tensor(start, device=dev)
        got, ref = ak.tree_attention(*args, st), ak.tree_attention_ref(*args, st)
        torch.testing.assert_close(got, ref, **BF16_TOL)
    log(f"[B1] odd shape g=1 T=13 Tk=40 bf16, start 0 / 77 / 128 / 256: within {BF16_TOL}")

    # head_dim 64 (the hd64 path's Llama-3.2-1B-class layout, 32 q / 8 kv
    # heads): every chunk edge of a 1024-row view and the full cache
    for dtype, tol in ((torch.float32, FP32_TOL), (torch.bfloat16, BF16_TOL)):
        used = 0.0
        for T, mask in ((T_STATIC, sm), (T_TREE, None)):
            q, kc, vc, kt, vt, tm = inputs(T, T, NQ, NKV, S_CACHE, dtype, mask=mask, hd=HD64)
            for view, sts in ((1024, starts), (S_CACHE, [1500, S_CACHE])):
                args = (q, kc[:, :view], vc[:, :view], kt, vt, tm)
                for start in sts:
                    st = torch.tensor(start, device=dev)
                    got, ref = ak.tree_attention(*args, st), ak.tree_attention_ref(*args, st)
                    torch.testing.assert_close(got, ref, **tol)
                    used = max(used, tol_used(got, ref, tol))
                    if dtype == torch.bfloat16:
                        ref32 = ak.tree_attention_ref(
                            *(a.float() if a.is_floating_point() else a for a in args), st)
                        torch.testing.assert_close(got.float(), ref32, **BF16_TOL_F32)
                        used = max(used, tol_used(got, ref32, BF16_TOL_F32))
                        worst_bf16 = max(worst_bf16, max_err(got, ref))
        log(f"[B1] head_dim {HD64} {dtype}: every chunk edge of a 1024-row view and the "
            f"full cache, T = {T_STATIC} and {T_TREE}: within {tol}"
            + (f" and {BF16_TOL_F32} vs plain f32" if dtype == torch.bfloat16 else "")
            + f"; at most {used:.3f} of a limit used")

    # other head widths (80, 96: run at the padded 128; 256 at 256), the bf16
    # path's T = 61 and 32 q / 8 kv heads, every chunk edge and the full cache
    for hd in OTHER_HEAD_DIMS:
        for dtype, tol in ((torch.float32, FP32_TOL), (torch.bfloat16, BF16_TOL)):
            used = 0.0
            q, kc, vc, kt, vt, tm = inputs(T_TREE, T_TREE, NQ, NKV, S_CACHE, dtype, hd=hd)
            for view, sts in ((1024, starts), (S_CACHE, [1500, S_CACHE])):
                args = (q, kc[:, :view], vc[:, :view], kt, vt, tm)
                for start in sts:
                    st = torch.tensor(start, device=dev)
                    got, ref = ak.tree_attention(*args, st), ak.tree_attention_ref(*args, st)
                    torch.testing.assert_close(got, ref, **tol)
                    used = max(used, tol_used(got, ref, tol))
                    if dtype == torch.bfloat16:
                        ref32 = ak.tree_attention_ref(
                            *(a.float() if a.is_floating_point() else a for a in args), st)
                        torch.testing.assert_close(got.float(), ref32, **BF16_TOL_F32)
                        used = max(used, tol_used(got, ref32, BF16_TOL_F32))
                        worst_bf16 = max(worst_bf16, max_err(got, ref))
            log(f"[B1] head_dim {hd} (padded {ak.tree_plan(T_TREE, NQ, NKV, 1024, hd)['head_pad']})"
                f" {dtype}: every chunk edge of a 1024-row view and the full cache, T = "
                f"{T_TREE}: within {tol}"
                + (f" and {BF16_TOL_F32} vs plain f32" if dtype == torch.bfloat16 else "")
                + f"; at most {used:.3f} of a limit used")

    # timing at the main path's shape (bf16, start = 1024) and at the static
    # tree's T = 26, against one SDPA call over the same keys
    start = 1024
    st = torch.tensor([start], dtype=torch.int32, device=dev)  # as the kernel reads it
    res = {}
    for T, hd in ((T_TREE, HD), (T_STATIC, HD), (T_TREE, HD64),
                  *((T_TREE, d) for d in OTHER_HEAD_DIMS)):
        args = inputs(T, T, NQ, NKV, S_CACHE, torch.bfloat16, hd=hd)
        q, kc, vc, kt, vt, tm = args
        ms = device_time_ms(lambda: ak.tree_attention(*args, st), flush=flush)
        plain_ms = device_time_ms(lambda: ak.tree_attention_ref(*args, st), flush=flush)
        kcat = torch.cat([kc[:, :start], kt.transpose(0, 1)], dim=1)[None]
        vcat = torch.cat([vc[:, :start], vt.transpose(0, 1)], dim=1)[None]
        lmask = torch.cat([torch.ones(T, start, dtype=torch.bool, device=dev), tm], 1)
        qs = q.transpose(0, 1)[None]
        sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(
            qs, kcat, vcat, attn_mask=lmask[None, None], enable_gqa=True)
        lib_err = max_err(sdpa()[0].transpose(0, 1).reshape(T, NQ * hd),
                          ak.tree_attention_ref(*args, st))
        library_ms = device_time_ms(sdpa, flush=flush)
        es = 2
        nbytes = (2 * T * NQ * hd * es + 2 * NKV * start * hd * es
                  + 2 * T * NKV * hd * es + T * T)
        flops = 4 * T * NQ * (start + T) * hd
        bound_ms = max(nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS_PER_S) * 1e3
        bound_by = "bytes" if nbytes / HBM_BYTES_PER_S >= flops / BF16_FLOPS_PER_S else "operations"
        log(f"[B1] bf16 T={T} head_dim={hd} start={start} chunk={ch}: kernel {ms:.4f} ms, "
            f"plain {plain_ms:.4f} ms, sdpa {library_ms:.4f} ms (err vs plain {lib_err:.2e}), "
            f"kernel/sdpa {ms / library_ms:.3f}, bound {bound_ms:.5f} ms "
            f"({bound_by}; {nbytes} B, {flops} flop), kernel/bound {ms / bound_ms:.1f}")
        res[T, hd] = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                          bound_ms=bound_ms, bound_by=bound_by,
                          library_ratio=ms / library_ms)
    r = res[T_TREE, HD]
    return {"name": "tree_attention", "route": "cuda",
            "source": "eagle_tpu_torch/csrc/tree_attention.cu",
            "replaces": "eagle_tpu/ops/pallas_attn.py:32",
            "max_abs_err": worst_bf16, **r, "at_T26": res[T_STATIC, HD],
            "at_head_dim_64": res[T_TREE, HD64],
            **{f"at_head_dim_{d}": res[T_TREE, d] for d in OTHER_HEAD_DIMS}}


def _b1_bound(T, nq, nkv, hd, starts, es=2):
    """B1's least time for a batch whose rows read `starts` prefix rows:
    q, out, the tree's K/V and mask once each, each row's prefix K/V once;
    4 T nq (start + T) hd flop a row."""
    nbytes = sum(2 * T * nq * hd * es + 2 * nkv * s * hd * es + 2 * T * nkv * hd * es + T * T
                 for s in starts)
    flops = sum(4 * T * nq * (s + T) * hd for s in starts)
    t_b, t_o = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS_PER_S
    return max(t_b, t_o) * 1e3, "bytes" if t_b >= t_o else "operations", nbytes, flops


def _sdpa_batched(args, starts):
    """One SDPA call over the same keys as B1 for a batch: each row's prefix
    padded to the longest and masked, then its tree keys under the tree mask."""
    q, kc, vc, kt, vt, tm = args
    B, T = q.shape[:2]
    dev = q.device
    smax = max(starts)
    kcat = torch.cat([kc[:, :, :smax], kt.transpose(1, 2)], dim=2)
    vcat = torch.cat([vc[:, :, :smax], vt.transpose(1, 2)], dim=2)
    pre = torch.arange(smax, device=dev)[None, None] < torch.tensor(starts, device=dev)[:, None, None]
    mask = torch.cat([pre.expand(B, T, smax), tm], dim=2)[:, None]
    qs = q.transpose(1, 2)
    return lambda: torch.nn.functional.scaled_dot_product_attention(
        qs, kcat, vcat, attn_mask=mask, enable_gqa=True)


def check_tree_attention_batched(dev, flush) -> dict:
    """B1 over a batch in one launch (B = 4, starts 0, 300, 1024, 2000: a
    prefix chunk live for one row is empty for another), on the full cache
    and on a 2048-row view of it, f32 and bf16, within B1's tolerances of
    the batched plain version and each row bit-identical to a launch of that
    row alone; and the head_dim > 256 route (320, 512) at every chunk edge of
    a view. Timed beside the plain version and one SDPA call with a dense
    batched mask."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(8)
    rng = np.random.default_rng(8)
    B, starts = 4, [0, 300, 1024, 2000]

    def inputs(B, T, hd, dtype):
        r = lambda *s: torch.randn(s, generator=gen, device=dev).to(dtype)
        tm = torch.stack([rand_tree_mask(T, rng, dev) for _ in range(B)]).contiguous()
        return (r(B, T, NQ, hd), r(B, NKV, S_CACHE, hd), r(B, NKV, S_CACHE, hd),
                r(B, T, NKV, hd), r(B, T, NKV, hd), tm)

    def held(got, args, st, tol):
        ref = ak.tree_attention_ref(*args, st)
        torch.testing.assert_close(got, ref, **tol)
        used = tol_used(got, ref, tol)
        if got.dtype == torch.bfloat16:
            ref32 = ak.tree_attention_ref(*(a.float() if a.is_floating_point() else a
                                            for a in args), st)
            torch.testing.assert_close(got.float(), ref32, **BF16_TOL_F32)
            used = max(used, tol_used(got, ref32, BF16_TOL_F32))
        return used, max_err(got, ref)

    worst = 0.0
    for dtype, tol in ((torch.float32, FP32_TOL), (torch.bfloat16, BF16_TOL)):
        q, kc, vc, kt, vt, tm = inputs(B, T_TREE, HD, dtype)
        for view in (S_CACHE, 2048):
            args = (q, kc[:, :, :view], vc[:, :, :view], kt, vt, tm)
            st = torch.tensor(starts, device=dev)
            before = ak.LAUNCHES["tree_attention"]
            got = ak.tree_attention(*args, st)
            if ak.LAUNCHES["tree_attention"] != before + 1:
                fail("[B1 batched] a batch of 4 took more than one launch")
            used, err = held(got, args, st, tol)
            for b in range(B):
                if not torch.equal(got[b], ak.tree_attention(*(a[b] for a in args), st[b])):
                    fail(f"[B1 batched] {dtype} row {b} differs from its own launch")
            if dtype == torch.bfloat16:
                worst = max(worst, err)
            log(f"[B1 batched] B={B} starts {starts}, {view}-row view, {dtype}: within {tol}"
                + (f" and {BF16_TOL_F32} vs plain f32" if dtype == torch.bfloat16 else "")
                + f", at most {used:.3f} of a limit used; every row == its own launch")
    torch.cuda.synchronize()
    if any(int(c.abs().sum()) for c in ak._COUNTERS.values()):
        fail("[B1 batched] merge counters left non-zero")

    res = {}
    for hd in (320, 512):
        for dtype, tol in ((torch.float32, FP32_TOL), (torch.bfloat16, BF16_TOL)):
            q, kc, vc, kt, vt, tm = inputs(2, T_TREE, hd, dtype)
            used = 0.0
            ch = ak.TREE_CHUNK
            for view, pairs in ((1024, [(0, ch - 1), (ch, ch + 1), (1023, 1024)]),
                                (S_CACHE, [(1500, S_CACHE)])):
                args = (q, kc[:, :, :view], vc[:, :, :view], kt, vt, tm)
                for pair in pairs:
                    st = torch.tensor(pair, device=dev)
                    got = ak.tree_attention(*args, st)
                    u, err = held(got, args, st, tol)
                    used = max(used, u)
                    if dtype == torch.bfloat16:
                        worst = max(worst, err)
            log(f"[B1 wide] head_dim {hd} ({ak.tree_plan(T_TREE, NQ, NKV, 1024, hd)}) "
                f"{dtype}: chunk edges of a 1024-row view and the full cache, B = 2: "
                f"within {tol}, at most {used:.3f} of a limit used")

    # timing: the batch at one start (1024, the single-sequence shape four
    # times) and at the mixed starts; the wide route at one row, start 1024
    for label, B_, sts, hd in (("batch4_start1024", 4, [1024] * 4, HD),
                               ("batch4_mixed", 4, starts, HD),
                               ("head_dim_320", 1, [1024], 320),
                               ("head_dim_512", 1, [1024], 512)):
        args = inputs(B_, T_TREE, hd, torch.bfloat16)
        st = torch.tensor(sts, dtype=torch.int32, device=dev)
        ms = device_time_ms(lambda: ak.tree_attention(*args, st), flush=flush)
        plain_ms = device_time_ms(lambda: ak.tree_attention_ref(*args, st), flush=flush)
        sdpa = _sdpa_batched(args, sts)
        lib_err = max_err(sdpa().transpose(1, 2).reshape(B_, T_TREE, NQ * hd),
                          ak.tree_attention_ref(*args, st))
        library_ms = device_time_ms(sdpa, flush=flush)
        bound_ms, bound_by, nbytes, flops = _b1_bound(T_TREE, NQ, NKV, hd, sts)
        log(f"[B1 {label}] bf16 B={B_} T={T_TREE} head_dim={hd} starts {sts}: kernel "
            f"{ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa (dense batched mask) "
            f"{library_ms:.4f} ms (err vs plain {lib_err:.2e}), kernel/sdpa "
            f"{ms / library_ms:.3f}, bound {bound_ms:.5f} ms ({bound_by}; {nbytes} B, "
            f"{flops} flop), kernel/bound {ms / bound_ms:.1f}")
        res[f"at_{label}"] = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                                  bound_ms=bound_ms, bound_by=bound_by, starts=sts,
                                  library_ratio=ms / library_ms)
    res["max_abs_err_batched_and_wide"] = worst
    return res


def check_tree_attention_row_exact(dev, flush) -> dict:
    """B1's f32 route is row-exact (fault C6): every row of a batched verify
    (B = 3 random parent-first trees of 61 nodes at starts 0, 31 and 1023,
    head_dim 128 and 64) is bit-identical to a one-token launch at start +
    its depth on a cache that holds its ancestors in order; a 300-row causal
    prefill is bit-identical to the same rows in chunks of 64 and of 37.
    Timed at the main path's shape (T = 61, start 1024, head_dim 128, 32 q /
    8 kv heads) beside its plain version, one f32 SDPA call over the same
    keys and its bound at the float32 rates."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(9)
    rng = np.random.default_rng(9)
    r = lambda *s: torch.randn(s, generator=gen, device=dev)
    starts = [0, 31, 1023]
    for hd in (HD, HD64):
        B, T = len(starts), T_TREE
        tm = torch.stack([rand_tree_mask(T, rng, dev) for _ in range(B)]).contiguous()
        q, kc, vc, kt, vt = (r(B, T, NQ, hd), r(B, NKV, S_CACHE, hd), r(B, NKV, S_CACHE, hd),
                             r(B, T, NKV, hd), r(B, T, NKV, hd))
        got = ak.tree_attention(q, kc, vc, kt, vt, tm, torch.tensor(starts, device=dev))
        one = torch.ones((T, 1, 1), dtype=torch.bool, device=dev)
        for b in range(B):
            kc1, vc1 = kc[b].repeat(T, 1, 1, 1), vc[b].repeat(T, 1, 1, 1)
            for t in range(T):
                anc = torch.nonzero(tm[b, t])[:, 0]
                rows = slice(starts[b], starts[b] + len(anc) - 1)
                kc1[t, :, rows] = kt[b, anc[:-1]].transpose(0, 1)
                vc1[t, :, rows] = vt[b, anc[:-1]].transpose(0, 1)
            step = ak.tree_attention(q[b][:, None].contiguous(), kc1, vc1,
                                     kt[b][:, None].contiguous(), vt[b][:, None].contiguous(),
                                     one, starts[b] + tm[b].sum(-1) - 1)
            if not torch.equal(step[:, 0], got[b]):
                fail(f"[B1 f32 row-exact] head_dim {hd}: a verify row at start {starts[b]} "
                     f"differs from its one-token step")
        n = 300
        q, kc, vc, kt, vt = r(1, n, NQ, hd), r(1, NKV, 512, hd), r(1, NKV, 512, hd), \
            r(1, n, NKV, hd), r(1, n, NKV, hd)
        causal = lambda m: torch.ones((1, m, m), dtype=torch.bool, device=dev).tril()
        whole = ak.tree_attention(q, kc, vc, kt, vt, causal(n), torch.zeros(1, device=dev))
        for chunk in (64, 37):
            ck, cv = torch.zeros_like(kc), torch.zeros_like(vc)
            for s0 in range(0, n, chunk):
                m = min(chunk, n - s0)
                part = ak.tree_attention(q[:, s0:s0 + m].contiguous(), ck, cv,
                                         kt[:, s0:s0 + m].contiguous(),
                                         vt[:, s0:s0 + m].contiguous(), causal(m),
                                         torch.full((1,), s0, device=dev))
                if not torch.equal(part, whole[:, s0:s0 + m]):
                    fail(f"[B1 f32 row-exact] head_dim {hd}: prefill rows {s0}.. in chunks "
                         f"of {chunk} differ from the whole prefill")
                ck[0, :, s0:s0 + m] = kt[0, s0:s0 + m].transpose(0, 1)
                cv[0, :, s0:s0 + m] = vt[0, s0:s0 + m].transpose(0, 1)
        log(f"[B1 f32 row-exact] head_dim {hd}: B = {B} verify rows (T = {T}, starts {starts}) "
            f"== their one-token steps at start + depth; a {n}-row prefill == its chunks of "
            f"64 and of 37, bit for bit")

    start, T = 1024, T_TREE
    tm = rand_tree_mask(T, rng, dev)
    args = (r(T, NQ, HD), r(NKV, S_CACHE, HD), r(NKV, S_CACHE, HD), r(T, NKV, HD),
            r(T, NKV, HD), tm)
    q, kc, vc, kt, vt, _ = args
    st = torch.tensor([start], dtype=torch.int32, device=dev)
    got = ak.tree_attention(*args, st)
    ref = ak.tree_attention_ref(*args, st)
    torch.testing.assert_close(got, ref, **FP32_TOL)
    ms = device_time_ms(lambda: ak.tree_attention(*args, st), flush=flush)
    plain_ms = device_time_ms(lambda: ak.tree_attention_ref(*args, st), flush=flush)
    kcat = torch.cat([kc[:, :start], kt.transpose(0, 1)], dim=1)[None]
    vcat = torch.cat([vc[:, :start], vt.transpose(0, 1)], dim=1)[None]
    lmask = torch.cat([torch.ones(T, start, dtype=torch.bool, device=dev), tm], 1)
    qs = q.transpose(0, 1)[None]
    sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(
        qs, kcat, vcat, attn_mask=lmask[None, None], enable_gqa=True)
    library_ms = device_time_ms(sdpa, flush=flush)
    nbytes = 2 * T * NQ * HD * 4 + 2 * NKV * start * HD * 4 + 2 * T * NKV * HD * 4 + T * T
    flops = 4 * T * NQ * (start + T) * HD
    t_b, t_o = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS_PER_S
    bound_ms, bound_by = max(t_b, t_o) * 1e3, "bytes" if t_b >= t_o else "operations"
    log(f"[B1 f32 row-exact] T={T} head_dim={HD} start={start}: kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, f32 sdpa {library_ms:.4f} ms, kernel/sdpa {ms / library_ms:.3f}, "
        f"bound {bound_ms:.5f} ms ({bound_by}; {nbytes} B, {flops} flop at "
        f"{FP32_FLOPS_PER_S / 1e12:.0f} TFLOP/s), kernel/bound {ms / bound_ms:.1f}; "
        f"max_abs_err vs plain {max_err(got, ref):.3e}")
    return {"at_f32_row_exact": dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                                     bound_ms=bound_ms, bound_by=bound_by,
                                     max_abs_err=max_err(got, ref),
                                     library_ratio=ms / library_ms)}


def check_compact_rows(dev, flush) -> dict:
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    shape = (L_TGT, 1, NKV, S_CACHE, HD)
    k0 = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
    v0 = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
    path = torch.tensor(PATH, device=dev)
    P = len(PATH)
    worst = 0.0
    # the overlapping path at three starts (the last clamps the window at the
    # end), an all-identity path, an identity prefix followed by moves, P = 1
    cases = [(PATH, 0), (PATH, 1000), (PATH, S_CACHE - 64), (PATH, S_CACHE - 3),
             (list(range(P)), 1000), ([0, 1, 2, 5, 9, 12, 14], 1000), ([0], 1000),
             ([4], 1000)]
    for p, start in cases:
        st = torch.tensor(start, device=dev)
        pt = torch.tensor(p, device=dev)
        k1, v1 = k0.clone(), v0.clone()
        k2, v2 = k0.clone(), v0.clone()
        ak.compact_rows(k1, v1, pt, st)
        compact_rows_plain(k2, v2, pt, st)
        torch.cuda.synchronize()
        for got, exp in ((k1, k2), (v1, v2)):
            if not torch.equal(got, exp):
                fail(f"compact_rows path={p} start={start}: differs from compact_accepted")
            worst = max(worst, max_err(got, exp))
        log(f"[B2] path={p} start={start:5d}: identical to compact_accepted, all rows "
            "(tolerance: exact)")
    # through a row-sliced view (kv_buckets), as the static-tree path calls it
    st = torch.tensor(700, device=dev)
    k1, v1, k2, v2 = k0.clone(), v0.clone(), k0.clone(), v0.clone()
    ak.compact_rows(k1[:, :, :, :1024], v1[:, :, :, :1024], path, st)
    compact_rows_plain(k2, v2, path, st)
    torch.cuda.synchronize()
    if not (torch.equal(k1, k2) and torch.equal(v1, v2)):
        fail("compact_rows on a 1024-row view differs from compact_accepted")
    log("[B2] 1024-row view, start=700: identical to compact_accepted (tolerance: exact)")
    # the hd64 path's cache: 16 layers of 128-byte rows (head_dim 64, bf16)
    shape64 = (16, 1, NKV, S_CACHE, HD64)
    k64 = torch.randn(shape64, generator=gen, device=dev).to(torch.bfloat16)
    v64 = torch.randn(shape64, generator=gen, device=dev).to(torch.bfloat16)
    for p, start in cases:
        st, pt = torch.tensor(start, device=dev), torch.tensor(p, device=dev)
        k1, v1, k2, v2 = k64.clone(), v64.clone(), k64.clone(), v64.clone()
        ak.compact_rows(k1, v1, pt, st)
        compact_rows_plain(k2, v2, pt, st)
        torch.cuda.synchronize()
        if not (torch.equal(k1, k2) and torch.equal(v1, v2)):
            fail(f"compact_rows 128-byte rows path={p} start={start}: differs")
    log(f"[B2] 128-byte rows {list(shape64)}: identical to compact_accepted on the "
        f"{len(cases)} paths above (tolerance: exact)")

    st = torch.tensor([1000], dtype=torch.int32, device=dev)  # as the kernel reads them
    path = path.to(torch.int32)
    res = {}
    for tag, (kk, vv) in (("128", (k0, v0)), ("64", (k64, v64))):
        k1, v1 = kk.clone(), vv.clone()
        L, d = k1.shape[0], k1.shape[-1]
        ms = device_time_ms(lambda: ak.compact_rows(k1, v1, path, st), flush=flush)
        plain_ms = device_time_ms(lambda: compact_rows_plain(k1, v1, path, st), flush=flush)
        src = (st + path).long()
        dst = window(st[0], P, S_CACHE)

        def library():
            for t in (k1, v1):
                t[:, 0].index_copy_(2, dst, t[:, 0].index_select(2, src))

        library_ms = device_time_ms(library, flush=flush)
        nbytes = 2 * 2 * L * NKV * P * d * 2 + 4 * P
        bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
        log(f"[B2] {list(k1.shape)}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"index_select+index_copy_ {library_ms:.4f} ms, kernel/library "
            f"{ms / library_ms:.3f}, bound {bound_ms:.5f} ms ({nbytes} B)")
        res[tag] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by="bytes",
                        library_ms=library_ms)
    return {"name": "compact_rows", "route": "cuda",
            "source": "eagle_tpu_torch/csrc/compact_rows.cu",
            "replaces": "eagle_tpu/ops/pallas_attn.py:187",
            "max_abs_err": worst, **res["128"], "at_128B_rows": res["64"]}



def _w4_bound(M, K, N, G):
    """Least time for one w4a8 matmul: the bytes it must move (packed words,
    scales, int8 rows, row sums, f32 output) against HBM, its integer
    operations against the int8 tensor-core peak."""
    nbytes = K * N // 2 + 4 * G * N + M * K + 4 * M * G + 4 * M * N
    t_b, t_o = nbytes / HBM_BYTES_PER_S, 2 * M * K * N / INT8_OPS_PER_S
    return max(t_b, t_o) * 1e3, "bytes" if t_b >= t_o else "operations", nbytes


def _ablate_bound(mode, M, K, N, G):
    """Least time for one variant of the w4a8 body, from what that variant
    needs: `no_dots` reads the packed bytes only and adds each nibble once;
    `one_dot*` read xq[:, :K/2] and s[0] and contract it with both planes; the
    other modes read and do what the full body does."""
    if mode == "no_dots":
        nbytes, ops = K * N // 2 + 4 * M * N, K * N
    elif mode in ("one_dot", "one_dot_bf16"):
        nbytes = K * N // 2 + 4 * N + M * K // 2 + 4 * M * N
        ops = 2 * (2 * M * (K // 2) * N)
    else:
        return _w4_bound(M, K, N, G)
    t_b, t_o = nbytes / HBM_BYTES_PER_S, ops / INT8_OPS_PER_S
    return max(t_b, t_o) * 1e3, "bytes" if t_b >= t_o else "operations", nbytes


def _rand_packed(dev, gen, K, N, group=128, blocks=1):
    w = torch.randn((K, N), generator=gen, device=dev).mul_(0.02)
    return tq4.pack_w4(w, group, blocks)


def check_w4_matmul(dev, flush) -> list[dict]:
    """B3 (qdense4) and B4 (qdense4_stacked) against qdense4_ref: bit for bit
    (tolerance: none) at the full-width shapes, and row-invariant in M."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(4)
    L = L_TGT
    rows = lambda M, K: torch.randn((M, K), generator=gen, device=dev).to(torch.bfloat16)

    worst = {"B3": 0.0, "B4": 0.0}     # max |kernel - qdense4_ref| over every comparison

    def same(tag, got, ref):
        torch.cuda.synchronize()
        worst[tag[1:3]] = max(worst[tag[1:3]], max_err(got, ref))
        if not torch.equal(got, ref):
            fail(f"{tag}: differs from qdense4_ref, max abs "
                 f"{max_err(got, ref):.3e} (tolerance: bit-identical)")

    # B4: every per-layer shape of the target, stacked [32, K/8, N]; only
    # layers 0 and 31 are filled and used. gate/up and down at four M, the
    # attention projections at the verify's and the vanilla step's M.
    stacked = {}
    for (K, N), Ms in (((4096, 14336), (256, 61, 10, 1)), ((14336, 4096), (256, 61, 10, 1)),
                       ((4096, 4096), (61, 1)), ((4096, 1024), (61, 1))):
        st: dict = {}
        for layer in (0, L - 1):
            tq4.stack_layer(st, "w", _rand_packed(dev, gen, K, N), layer, L)
        stacked[(K, N)] = st["w"]
        for layer in (0, L - 1):
            w = tq4.Stacked4(st["w"]["q4"], st["w"]["scale"], layer)
            x = rows(Ms[0], K)
            full = None
            for M in Ms:
                got = tq4.qdense4_stacked(x[:M], w, out_dtype=torch.float32)
                same(f"[B4] {K}x{N} layer {layer} M={M}", got,
                     tq4.qdense4_stacked_ref(x[:M], w, out_dtype=torch.float32))
                full = got if full is None else full
                if not torch.equal(got, full[:M]):
                    fail(f"[B4] {K}x{N} layer {layer}: rows of the M={M} call differ "
                         f"from the same rows of the M={Ms[0]} call")
            log(f"[B4] {K}x{N} layer {layer:2d}: bit-identical to qdense4_ref at "
                f"M = {sorted(Ms)}; rows invariant in M")
    # B3: the target's lm_head and the draft's wqkv at four M; the draft's wo,
    # wgu, w_down and fc at the extension forward's largest M and at M = 1
    heads = {}
    for (K, N), Ms in (((4096, 128256), (256, 61, 10, 1)), ((8192, 6144), (256, 61, 10, 1)),
                       ((4096, 4096), (61, 1)), ((4096, 28672), (61, 1)),
                       ((14336, 4096), (61, 1)), ((12288, 4096), (61, 1))):
        qw = heads[(K, N)] = _rand_packed(dev, gen, K, N)
        x = rows(Ms[0], K)
        for M in Ms:
            same(f"[B3] {K}x{N} M={M}", tq4.qdense4(x[:M], qw, out_dtype=torch.float32),
                 tq4.qdense4_ref(x[:M], qw, out_dtype=torch.float32))
        y61 = tq4.qdense4(x[:61], qw)
        for i in (0, 17, 60):
            if not torch.equal(tq4.qdense4(x[i:i + 1], qw), y61[i:i + 1]):
                fail(f"[B3] {K}x{N}: row {i} of the M=61 call differs from the M=1 call")
        log(f"[B3] {K}x{N}: bit-identical to qdense4_ref at M = {sorted(Ms)}; "
            "row i of M=61 == the M=1 call, bitwise")
        if (K, N) != (4096, 128256):
            del heads[(K, N)]
    # blocked (blocks=2, same group: bit-identical to blocks=1 too), a tiny
    # group with ragged N, and a bias with an fp32 row
    w = torch.randn((1024, 200), generator=gen, device=dev).mul_(0.02)
    x = torch.randn((9, 1024), generator=gen, device=dev)
    b = torch.randn(200, generator=gen, device=dev)
    one, two = tq4.pack_w4(w), tq4.pack_w4(w, blocks=2)
    same("[B3] blocks=2", tq4.qdense4(x, two, b), tq4.qdense4_ref(x, two, b))
    same("[B3] blocks=2 vs blocks=1", tq4.qdense4(x, two, b), tq4.qdense4(x, one, b))
    tiny = tq4.pack_w4(torch.randn((64, 37), generator=gen, device=dev), group=16)
    xt = torch.randn((7, 64), generator=gen, device=dev)
    same("[B3] group=16, N=37", tq4.qdense4(xt, tiny), tq4.qdense4_ref(xt, tiny))
    log("[B3] blocks=2 (== blocks=1), group=16 with ragged N=37: bit-identical")
    # every M edge of the 64-row and m16 tiles at each group size and blocked
    # layout; then every launch plan the shapes allow (column tile, cluster
    # split) at bulk-copy and 4-byte-copy shapes
    for group in (16, 32, 64, 128):
        for blocks in (1, 2, 4):
            w = torch.randn((1024, 200), generator=gen, device=dev).mul_(0.05)
            qw = tq4.pack_w4(w, group, blocks)
            x = rows(1024, 1024)
            full = tq4.qdense4(x, qw, out_dtype=torch.float32)
            for M in (1, 15, 16, 17, 63, 64, 65, 1024):
                got = tq4.qdense4(x[:M], qw, out_dtype=torch.float32)
                same(f"[B3] group={group} blocks={blocks} M={M}", got,
                     tq4.qdense4_ref(x[:M], qw, out_dtype=torch.float32))
                if not torch.equal(got, full[:M]):
                    fail(f"[B3] group={group} blocks={blocks}: rows of M={M} differ from M=1024")
    log("[B3] groups 16/32/64/128 x blocks 1/2/4 at M = 1, 15, 16, 17, 63, 64, 65, 1024: "
        "bit-identical, rows invariant in M")
    # every kernel instantiation, through the plan w4_plan picks: N = 132
    # column tiles picks that tile (16-byte copies; 4-byte ones 2 columns
    # later), fewer than 132 tiles of 8 columns the cluster split
    picked = set()
    for M, K, N, group in ([(61, 256, 132 * n + pad, 128) for n in tq4.W4_NTILES
                            for pad in (0, 2)] + [(61, 256, 1024, 128), (5, 96, 37, 12)]):
        qw = tq4.pack_w4(torch.randn((K, N), generator=gen, device=dev).mul_(0.05), group)
        plan = tq4.w4_plan(M, K, N, qw["scale"].shape[0], 1)
        picked.add((plan.ntile, plan.split, plan.vec))
        x = rows(M, K)
        same(f"[B3] [{M},{K}]x[{K},{N}] group {group} {plan}",
             tq4.qdense4(x, qw, out_dtype=torch.float32),
             tq4.qdense4_ref(x, qw, out_dtype=torch.float32))
    if len(picked) != 2 * len(tq4.W4_NTILES) + 2:
        fail(f"[B3] the shapes reached {sorted(picked)}, not every instantiation")
    log(f"[B3] every kernel instantiation (column tile, split, 16-byte copies) "
        f"{sorted(picked)}: bit-identical")
    # the packer gives the same words and scales on the card and on the host
    for blocks in (1, 2):
        a, c = tq4.pack_w4(w.cpu(), blocks=blocks), tq4.pack_w4(w, blocks=blocks)
        if not (torch.equal(a["q4"], c["q4"].cpu()) and torch.equal(a["scale"], c["scale"].cpu())):
            fail(f"pack_w4(blocks={blocks}) differs between the card and the CPU")
    log("[B3] pack_w4 on the card == pack_w4 on the CPU (words and scales)")

    # timing at the main path's shapes (L2 flushed before every call)
    out = []
    for name, tag, (K, N), entry in (
            ("qdense4_stacked", "B4", (4096, 14336), "eagle_tpu/ops/quant4.py:442"),
            ("qdense4", "B3", (4096, 128256), "eagle_tpu/ops/quant4.py:343")):
        G = K // 128
        wb = torch.randn((K, N), generator=gen, device=dev).to(torch.bfloat16)
        # M = 244: a batched round's verify of B = 4 rows (B * T)
        for M in ((1, 61, 244, 1024) if tag == "B4" else (1, 61, 244)):
            x = rows(M, K)
            if tag == "B4":
                st = stacked[(K, N)]
                w = tq4.Stacked4(st["q4"], st["scale"], L - 1)
                run, plain = (lambda: tq4.qdense4_stacked(x, w)), (lambda: tq4.qdense4_stacked_ref(x, w))
            else:
                qw = heads[(K, N)]
                run, plain = (lambda: tq4.qdense4(x, qw)), (lambda: tq4.qdense4_ref(x, qw))
            ms = device_time_ms(run, flush=flush)
            xq, _, rs = tq4.quantize_for_w4(x, G)
            q4, sc, lay = ((w.q4, w.scale, w.layer) if tag == "B4"
                           else (qw["q4"], qw["scale"], None))
            kernel_ms = device_time_ms(
                lambda: tq4.w4_kernel(name, xq, rs, q4, sc, 1, lay), flush=flush)
            plain_ms = device_time_ms(plain, reps=5, flush=flush)
            mm_ms = device_time_ms(lambda: torch.mm(x, wb), flush=flush)
            bound_ms, bound_by, nbytes = _w4_bound(M, K, N, G)
            plan = tq4.w4_plan(M, K, N, G, 1)
            log(f"[{tag}] [{M},{K}]x[{K},{N}]: wrapper (row quantization + kernel) "
                f"{ms:.4f} ms, kernel alone {kernel_ms:.4f} ms, plain {plain_ms:.3f} ms, bound {bound_ms:.5f} ms "
                f"({bound_by}; {nbytes} B); bf16 torch.mm {mm_ms:.4f} ms, kernel/mm "
                f"{kernel_ms / mm_ms:.3f}; {plan}")
            if M == 244:
                out[-1]["at_M244_batch4"] = dict(ms=ms, kernel_only_ms=kernel_ms,
                                                 plain_ms=plain_ms, bound_ms=bound_ms,
                                                 bound_by=bound_by, bf16_mm_ms=mm_ms)
            if M == 61:
                out.append({"name": name, "route": "cuda",
                            "source": "eagle_tpu_torch/csrc/w4_matmul.cu",
                            "replaces": entry, "max_abs_err": worst[tag], "ms": ms,
                            "kernel_only_ms": kernel_ms,
                            "plain_ms": plain_ms, "bound_ms": bound_ms,
                            "bound_by": bound_by, "library_ms": None,
                            "library_note": "no one PyTorch call computes this function",
                            "bf16_mm_ms": mm_ms, "kernel_over_bf16_mm": kernel_ms / mm_ms,
                            "shape": f"[{M},{K}]x[{K},{N}] bf16 rows"})
        del wb

    # every per-layer shape of the int4 target at the vanilla step's, the
    # verify's and a padded prompt's M (layer 31 of the stack), for PERF.md
    for (K, N), st in stacked.items():
        for M in (1, 61, 1024):
            xq, _, rs = tq4.quantize_for_w4(rows(M, K), K // 128)
            ms = device_time_ms(lambda: tq4.w4_kernel(
                "qdense4_stacked", xq, rs, st["q4"], st["scale"], 1, L - 1),
                reps=10, flush=flush)
            bound_ms, bound_by, _ = _w4_bound(M, K, N, K // 128)
            log(f"[B4] [{M},{K}]x[{K},{N}]: kernel alone {ms:.4f} ms, bound "
                f"{bound_ms:.5f} ms ({bound_by})")
    return out[::-1]


def check_score_topk(dev, flush) -> dict:
    """B5 against score_topk_ref: ids identical, scores within stk.SCORE_TOL.
    Times the wrapper, the w4 kernel alone and the unfused chain the drafter
    runs with fuse_scoring=False, at the root's M = 1 and a beam stage's M = 10."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    worst = 0.0
    K, V, k = 4096, 32000, 10
    heads = {}
    for kind in ("w4", "w8"):
        for (Kc, Vc, kc) in ((K, V, k), (256, 1000, 16)):     # 1000: ragged tiles
            w = torch.randn((Kc, Vc), generator=gen, device=dev).mul_(0.05)
            qw = tq4.pack_w4(w) if kind == "w4" else tq.quantize_linear(w)
            if Vc == V:
                heads[kind] = qw
            for dtype in (torch.float32, torch.bfloat16):
                for M in (1, 10, 17, 32):
                    h = torch.randn((M, Kc), generator=gen, device=dev).to(dtype)
                    lp, ids = stk.score_topk_quant(h, qw, kc)
                    ref_lp, ref_ids = stk.score_topk_ref(h, qw, kc)
                    torch.cuda.synchronize()
                    if not torch.equal(ids, ref_ids):
                        fail(f"[B5] {kind} V={Vc} M={M} {dtype}: ids differ from score_topk_ref")
                    torch.testing.assert_close(lp, ref_lp, **stk.SCORE_TOL)
                    worst = max(worst, max_err(lp, ref_lp))
        # forced ties across far-apart tiles resolve by ascending index
        w = torch.zeros((256, 1000), device=dev)
        for c in (900, 7, 450, 64, 63):
            w[:, c] = 0.5
        qw = tq4.pack_w4(w) if kind == "w4" else tq.quantize_linear(w)
        _, ids = stk.score_topk_quant(torch.ones((2, 256), device=dev), qw, 5)
        if ids[0].tolist() != [7, 63, 64, 450, 900] or not torch.equal(
                ids, stk.score_topk_ref(torch.ones((2, 256), device=dev), qw, 5)[1]):
            fail(f"[B5] {kind}: forced ties gave {ids[0].tolist()}")
        log(f"[B5] {kind}: ids identical at V = 32000 and 1000, M = 1, 10, 17, 32, f32 and "
            f"bf16 rows, forced ties in index order; scores max abs err so far "
            f"{worst:.3e} (tolerance {stk.SCORE_TOL})")

    # past 32 rows (row tiles on the grid) and past k = 16 (the k-way merge),
    # w4 and w8, random rows and heavy ties (weights on three levels, half the
    # rows constant: equal logits within a tile and across tiles)
    for kind in ("w4", "w8"):
        tw = torch.randint(-1, 2, (K, V), generator=gen, device=dev).float().mul_(0.05)
        tied = tq4.pack_w4(tw) if kind == "w4" else tq.quantize_linear(tw)
        for M in (33, 64):
            for kk in (17, 32, 128):
                for qw, ties in ((heads[kind], False), (tied, True)):
                    h = torch.randn((M, K), generator=gen, device=dev).to(torch.bfloat16)
                    if ties:
                        h[::2] = 1.0
                    lp, ids = stk.score_topk_quant(h, qw, kk)
                    ref_lp, ref_ids = stk.score_topk_ref(h, qw, kk)
                    torch.cuda.synchronize()
                    if not torch.equal(ids, ref_ids):
                        fail(f"[B5] {kind} M={M} k={kk} ties={ties}: ids differ from "
                             f"score_topk_ref")
                    torch.testing.assert_close(lp, ref_lp, **stk.SCORE_TOL)
                    worst = max(worst, max_err(lp, ref_lp))
        log(f"[B5] {kind}: ids identical at M = 33, 64 x k = 17, 32, 128, random and "
            f"tied logits; scores max abs err so far {worst:.3e} (tolerance "
            f"{stk.SCORE_TOL})")

    # past one column tile (k > 128: the logits pass and the radix select):
    # k = 129, 256, 1024 at V = 32000, and k = V of a small head (V = 1000),
    # w4 and w8, random and tied logits
    for kind in ("w4", "w8"):
        pack = tq4.pack_w4 if kind == "w4" else tq.quantize_linear
        tw = torch.randint(-1, 2, (K, V), generator=gen, device=dev).float().mul_(0.05)
        sw = torch.randn((256, 1000), generator=gen, device=dev).mul_(0.05)
        cases = [(heads[kind], K, kk, False) for kk in (129, 256, 1024)]
        cases += [(pack(tw), K, kk, True) for kk in (129, 1024)]
        cases += [(pack(sw), 256, 1000, False)]
        for qw, Kc, kk, ties in cases:
            for M in (1, 10, 33):
                h = torch.randn((M, Kc), generator=gen, device=dev).to(torch.bfloat16)
                if ties:
                    h[::2] = 1.0
                lp, ids = stk.score_topk_quant(h, qw, kk)
                ref_lp, ref_ids = stk.score_topk_ref(h, qw, kk)
                torch.cuda.synchronize()
                if not torch.equal(ids, ref_ids):
                    fail(f"[B5] {kind} M={M} k={kk} ties={ties}: ids differ from "
                         f"score_topk_ref")
                torch.testing.assert_close(lp, ref_lp, **stk.SCORE_TOL)
                worst = max(worst, max_err(lp, ref_lp))
        log(f"[B5] {kind}: select route ids identical at M = 1, 10, 33 x k = 129, 256, 1024 "
            f"(V = 32000, random; 129, 1024 tied) and k = V = 1000; scores max abs err so "
            f"far {worst:.3e} (tolerance {stk.SCORE_TOL})")

    def unfused(h, qw, kk=k):
        # what drafter.score_topk runs with fuse_scoring=False: B3, the cast,
        # log_softmax and the stable top-k
        return stk.topk_rows(torch.log_softmax(tq4.qdense4(h, qw).to(torch.float32), dim=-1),
                             kk)

    res = {}
    # M = 4 and 40: a batched round's root and beam stages at B = 4 (B and
    # B * top_k rows)
    for kind, M, k in (("w8", 10, 10), ("w4", 1, 10), ("w4", 10, 10), ("w4", 4, 10),
                       ("w4", 40, 10), ("w4", 32, 16),
                       ("w4", 64, 32), ("w4", 10, 128), ("w4", 10, 129), ("w4", 10, 256),
                       ("w4", 10, 1024)):
        qw = heads[kind]
        h = torch.randn((M, K), generator=gen, device=dev).to(torch.bfloat16)
        ms = device_time_ms(lambda: stk.score_topk_quant(h, qw, k), flush=flush)
        plain_ms = device_time_ms(lambda: stk.score_topk_ref(h, qw, k), reps=10, flush=flush)
        wbytes = K * V // 2 + 4 * (K // 128) * V if kind == "w4" else K * V + 4 * V
        rs_bytes = 4 * M * (K // 128) if kind == "w4" else 0
        nbytes = wbytes + M * K + rs_bytes + 4 * M + 12 * M * k
        t_b, t_o = nbytes / HBM_BYTES_PER_S, 2 * M * K * V / INT8_OPS_PER_S
        bound_ms, bound_by = max(t_b, t_o) * 1e3, "bytes" if t_b >= t_o else "operations"
        r = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by)
        if kind == "w8":
            log(f"[B5] w8 [{M},{K}]x[{K},{V}] k={k} bf16 rows: wrapper (row quantization "
                f"+ two kernels) {ms:.4f} ms, plain {plain_ms:.3f} ms, bound "
                f"{bound_ms:.5f} ms ({bound_by}; {nbytes} B)")
            res["w8"] = r
            continue
        xq, sx, rs = tq4.quantize_for_w4(h, K // 128)
        kernel_ms = device_time_ms(lambda: stk.w4_score_kernel(
            xq, sx, rs, qw["q4"], qw["scale"], k, 1), flush=flush)
        unfused_ms = device_time_ms(lambda: unfused(h, qw, k), flush=flush)
        u_lp, u_ids = unfused(h, qw, k)
        lp, ids = stk.score_topk_quant(h, qw, k)
        torch.cuda.synchronize()
        if not torch.equal(ids, u_ids):
            fail(f"[B5] w4 M={M}: ids differ from the unfused chain")
        torch.testing.assert_close(lp, u_lp, **stk.SCORE_TOL)
        route = "one kernel" if k <= stk.MAX_K else "logits pass + select"
        log(f"[B5] w4 [{M},{K}]x[{K},{V}] k={k} bf16 rows: wrapper (row quantization + "
            f"{route}) {ms:.4f} ms, kernel alone {kernel_ms:.4f} ms, unfused chain "
            f"(qdense4, cast, log_softmax, topk_rows) {unfused_ms:.4f} ms, wrapper/unfused "
            f"{ms / unfused_ms:.3f}, plain {plain_ms:.3f} ms, bound {bound_ms:.5f} ms "
            f"({bound_by}; {nbytes} B); {stk.score_plan(M, K, V, K // 128, k)}")
        res[M, k] = dict(r, kernel_ms=kernel_ms, unfused_ms=unfused_ms)
    return {"name": "score_topk_quant", "route": "cuda",
            "source": "eagle_tpu_torch/csrc/score_topk.cu",
            "replaces": "eagle_tpu/ops/score_topk.py:238", "max_abs_err": worst,
            **res[10, 10], "library_ms": None,
            "library_note": "no one PyTorch call computes this function; unfused_ms is "
                            "the drafter's unfused chain (qdense4, cast, log_softmax, "
                            "topk_rows)",
            "shape": f"w4 [10,{K}]x[{K},{V}] k=10 bf16 rows",
            "at_M1": res[1, 10], "at_M4_batch4_root": res[4, 10],
            "at_M40_batch4_beam": res[40, 10],
            "at_M32_k16": res[32, 16], "at_M64_k32": res[64, 32],
            "at_M10_k128": res[10, 128], "at_M10_k129": res[10, 129],
            "at_M10_k256": res[10, 256], "at_M10_k1024": res[10, 1024], "w8": res["w8"]}


def check_w4_ablate(dev, flush) -> list[dict]:
    """B6: every variant of the w4a8 body (each a change of B3's main loop)
    against ablate_ref, bit for bit (tolerance: none; every kernel keeps its
    plain version's sum order), at M = 5, 32, 61 and 512 against [4096, 4096]
    weights, at every block_n the probe's sweeps use and at ablate_plan's
    tile, at groups of 4, 128, 256, 512 and 1024 and a ragged N = 200.
    `i32_storage` at the plan's tile is held to B3's kernel alone, bit for
    bit and in time. One timed entry per mode (M = 32, also M = 61 and 512),
    beside one bf16 torch.mm of the same shape."""
    K, N, group = probe_w4_ablate.K, probe_w4_ablate.N, probe_w4_ablate.GROUP
    gen = torch.Generator(device=dev)
    gen.manual_seed(6)

    def case(mode, M, group=group, N=N, K=K):
        G = K // group
        xq = torch.randint(-127, 128, (M, K), dtype=torch.int8, generator=gen, device=dev)
        rs = (8 * xq.reshape(M, G, group).sum(dim=2, dtype=torch.int32)).contiguous()
        if mode in wab.I32_MODES:
            p = torch.randint(-2**31, 2**31 - 1, (K // 8, N), dtype=torch.int32,
                              generator=gen, device=dev)
        else:
            p = torch.randint(0, 256, (K // 2, N), dtype=torch.uint8, generator=gen,
                              device=dev)
        s = torch.rand((G, N), generator=gen, device=dev) * 1e-3 + 5e-4
        return xq, rs, p, s

    def tile(mode, M, K=K, N=N, group=group):
        return wab.ablate_plan(mode, M, K, N, K // group, 128).ntile

    worst = {}

    def same(mode, args, group, block_n, tag):
        got = wab.ablate(mode, *args, group, block_n)
        ref = wab.ablate_ref(mode, *args, group)
        torch.cuda.synchronize()
        err = max_err(got, ref)
        worst[mode] = max(worst.get(mode, 0.0), err)
        if not torch.equal(got, ref):
            fail(f"[B6] {mode} {tag}: differs from ablate_ref, max abs {err:.3e} "
                 f"(tolerance: bit-identical), mean |ref| {float(ref.abs().mean()):.3e}")

    sweep_bns = sorted({bn for runs in probe_w4_ablate.SWEEPS.values() for _, _, bn in runs})
    for mode in wab.MODES:
        args = case(mode, 32)
        for bn in sweep_bns + [tile(mode, 32)]:      # 1536 leaves a ragged last block
            same(mode, args, group, bn, f"M=32 bn={bn}")
        same(mode, case(mode, 5), group, 2048, "M=5 bn=2048")
        same(mode, case(mode, 5), group, tile(mode, 5), "M=5 at the plan's tile")
        same(mode, case(mode, 61), group, tile(mode, 61), "M=61 at the plan's tile")
        args = case(mode, 512)
        for bn in (256, tile(mode, 512)):
            same(mode, args, group, bn, f"M=512 bn={bn}")
        for g in (256, 512, 1024):
            same(mode, case(mode, 32, group=g), g, 512, f"group={g}")
        same(mode, case(mode, 32, group=4, K=256), 4, 64, "K=256 group=4")
        same(mode, case(mode, 7, N=200), group, 40, "N=200")
        log(f"[B6] {mode:12s}: bit-identical to ablate_ref at M = 5, 32, 61, 512, block_n "
            f"{sweep_bns} and the plan's tile, groups 4, 128, 256, 512, 1024, N = 200 "
            f"(tolerance: exact; max_abs_err {worst[mode]:.1e})")

    out = []
    for mode in wab.MODES:
        entry = {"name": f"w4_ablate.{mode}", "route": "cuda",
                 "source": "eagle_tpu_torch/csrc/w4_ablate.cu",
                 "replaces": "tools/probe_w4_ablate.py:37", "max_abs_err": worst[mode],
                 "library_ms": None,
                 "library_note": "no one PyTorch call computes this function; mm_ms is "
                                 "one bf16 torch.mm of the same shape"}
        for M in (32, 61, 512):
            args = case(mode, M)
            bn = tile(mode, M)
            ms = device_time_ms(lambda: wab.ablate(mode, *args, group, bn), flush=flush)
            a = torch.randn((M, K), generator=gen, device=dev).to(torch.bfloat16)
            b = torch.randn((K, N), generator=gen, device=dev).to(torch.bfloat16)
            mm_ms = device_time_ms(lambda: torch.mm(a, b), flush=flush)
            bound_ms, bound_by, nbytes = _ablate_bound(mode, M, K, N, K // group)
            r = dict(ms=ms, bound_ms=bound_ms, bound_by=bound_by, mm_ms=mm_ms,
                     block_n=bn, shape=f"[{M},{K}]x[{K},{N}] group {group}")
            b3 = ""
            if mode == "i32_storage":
                xq, rs, q4, sc = args
                want = tq4.w4_kernel("qdense4", xq, rs, q4, sc, 1, None)
                got = wab.ablate(mode, *args, group, bn)
                torch.cuda.synchronize()
                if not torch.equal(got, want):
                    fail(f"[B6] i32_storage M={M}: differs from B3's kernel alone")
                r["b3_ms"] = device_time_ms(
                    lambda: tq4.w4_kernel("qdense4", xq, rs, q4, sc, 1, None), flush=flush)
                b3 = f", B3 kernel alone {r['b3_ms']:.4f} ms (same bits)"
            if M == 32:
                r["plain_ms"] = device_time_ms(lambda: wab.ablate_ref(mode, *args, group),
                                               reps=5, flush=flush)
                entry.update(r)
            else:
                entry[f"at_M{M}"] = r
            log(f"[B6] {mode:12s} [{M},{K}]x[{K},{N}] group {group} block_n {bn}: kernel "
                f"{ms:.4f} ms, bf16 torch.mm {mm_ms:.4f} ms, bound {bound_ms:.5f} ms "
                f"({bound_by}; {nbytes} B){b3}")
        out.append(entry)
    return out


# ---------------------------------------------------------------------------
# phase 3: greedy speculative == vanilla in fp32 with the kernels on
# ---------------------------------------------------------------------------

def check_round_without_sync(label: str, eng: EagleEngine, prompt) -> None:
    """Two rounds of `eng` after a warm-up one, under torch's sync debug mode
    "error": any op of a round that waits on the host (a device value read
    there, a copy from pageable host memory) raises. `prompt`: one prompt
    (its round as generate_fused runs it, on a batch of one), or a list of
    prompts for a batched round."""
    batched = isinstance(prompt, list)
    prompts = prompt if batched else [prompt]
    _, st = eng._start_batch(prompts, None, seed=0)
    kv_limit = eng._kv_limit(max(len(p) for p in prompts) + 3 * eng.path_len)
    step = lambda st: eng._round_rows(st, None, kv_limit, batched=batched)
    with torch.no_grad():
        st, _ = step(st)       # first use: builds, caches
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            for _ in range(2):
                st, _ = step(st)
        except RuntimeError as e:
            fail(f"{label}: a round waits on the host: {e}")
        finally:
            torch.cuda.set_sync_debug_mode("default")


def fp32_configs() -> tuple[ModelConfig, DraftConfig]:
    """Phase 3's small fp32 target and EAGLE-3 draft (a reduced draft
    vocabulary), tree-verify attention on."""
    cfg = ModelConfig(vocab_size=1024, hidden_size=512, intermediate_size=1024,
                      num_layers=4, num_q_heads=8, num_kv_heads=2, head_dim=128,
                      dtype=torch.float32, attn_impl="pallas_tree")
    dcfg = DraftConfig(version=3, hidden_size=512, intermediate_size=1024,
                       num_q_heads=8, num_kv_heads=2, head_dim=128,
                       vocab_size=1024, draft_vocab_size=512,
                       target_hidden_size=512, dtype=torch.float32)
    return cfg, dcfg


def check_exactness(dev) -> None:
    """fp32: generate == generate_fused == generate_vanilla for (a) the dense
    target, (b) an int4 target + int4 draft + fused scoring, (c) the dense
    target with an int8 draft + fused scoring. Every kernel must launch."""
    cfg, dcfg = fp32_configs()
    ecfg = EngineConfig(total_tokens=60, depth=5, top_k=10, max_len=512,
                        compact_impl="pallas")
    params = transformer.init_params(cfg, seed=10, device=dev)
    dparams = draft_mod.init_params(dcfg, seed=11, device=dev)
    q4 = dict(draft_quant="int4", fuse_scoring=True)
    q8 = dict(draft_quant="int8", fuse_scoring=True)
    cases = (
        ("dense target, dense draft", params, ecfg,
         ("tree_attention", "compact_rows")),
        ("int4 target, int4 draft, fused scoring",
         tq4.quantize_target_params4(params), dataclasses.replace(ecfg, **q4),
         ENGINE_KERNELS),
        ("dense target, int8 draft, fused scoring", params,
         dataclasses.replace(ecfg, **q8),
         ("tree_attention", "compact_rows", "score_topk_quant")))
    rng = np.random.default_rng(2)
    # 5 and 40 tokens: the 130-token prompt, drawn third, is left out to make
    # room for the serving checks (check_batched_exactness keeps 130 and 400)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in (5, 40, 130)][:2]
    for label, tparams, e, must_launch in cases:
        eng = EagleEngine(tparams, cfg, dparams, dcfg, e, device=dev)
        ak.reset_launch_counts()
        for prompt in prompts:
            n = len(prompt)
            van = eng.generate_vanilla(prompt, max_new_tokens=64)
            spec = eng.generate(prompt, max_new_tokens=64)
            fused = eng.generate_fused(prompt, max_new_tokens=64)
            for name, out in (("generate", spec), ("generate_fused", fused)):
                if len(out) != len(van) or not np.array_equal(out, van):
                    bad = int(np.argmax(out[: len(van)] != van[: len(out)]))
                    fail(f"fp32 {label}: {name} != generate_vanilla "
                         f"(prompt {n}, index {bad})")
            log(f"[exact] {label}, prompt {n:3d}: generate == generate_fused == "
                f"vanilla ({len(van) - n} tokens)")
        idle = [k for k in must_launch if ak.LAUNCHES[k] == 0]
        if idle:
            fail(f"fp32 {label}: kernels never launched: {idle} ({ak.LAUNCHES})")
        check_round_without_sync(f"fp32 {label}", eng, prompts[1])
        log(f"[exact] {label}: launches {_nonzero(ak.LAUNCHES)}; a round waits on no host "
            f"sync")

    # this slice's engine options, over the dense target (kernel options on)
    long_prompt = rng.integers(0, cfg.vocab_size, 400)
    base = EagleEngine(params, cfg, dparams, dcfg, ecfg, device=dev)
    attn = ("tree_attention", "compact_rows")
    for label, eng, prompt_set, must_launch in (
            ("static tree mc_sim_7b_63", base._sibling(tree_paths=MC_SIM_7B_63), prompts, attn),
            # 400 prompt tokens + 64 new + the tree and commit window leave the
            # 512-row bucket while decoding
            ("kv_buckets (256, 512)", base._sibling(kv_buckets=(256, 512)),
             [prompts[1], long_prompt], attn),
            ("int8 KV cache", base._sibling(kv_quant="int8"), prompts, ())):
        ak.reset_launch_counts()
        used = set()
        limit_of = eng._kv_limit
        eng._kv_limit = lambda n, f=limit_of: used.add(f(n)) or f(n)
        bucketed = eng.ecfg.kv_buckets is not None
        for prompt in prompt_set:
            n = len(prompt)
            van = eng.generate_vanilla(prompt, max_new_tokens=64, fused=bucketed)
            outs = {"generate": eng.generate(prompt, max_new_tokens=64),
                    "generate_fused": eng.generate_fused(prompt, max_new_tokens=64)}
            for ids, _ in eng.generate_stream(prompt, max_new_tokens=64):
                outs["generate_stream"] = ids
            for name, out in outs.items():
                if len(out) != len(van) or not np.array_equal(out, van):
                    fail(f"fp32 {label}: {name} != generate_vanilla (prompt {n})")
            log(f"[exact] {label}, prompt {n:3d}: generate == generate_fused == "
                f"generate_stream's last ids == vanilla ({len(van) - n} tokens)")
        if bucketed and used != {256, 512, eng._tgt_len()}:
            fail(f"fp32 {label}: buckets used {sorted(used)}; no bucket edge was crossed")
        idle = [k for k in must_launch if ak.LAUNCHES[k] == 0]
        busy = [k for k in attn if ak.LAUNCHES[k] != 0] if not must_launch else []
        if idle or busy:
            fail(f"fp32 {label}: launches {_nonzero(ak.LAUNCHES)}; never launched {idle}, "
                 f"launched against an int8 cache {busy}")
        check_round_without_sync(f"fp32 {label}", eng, prompts[1])
        log(f"[exact] {label}: launches {_nonzero(ak.LAUNCHES)}"
            + (f", buckets used {sorted(used)}" if bucketed else "")
            + "; a round waits on no host sync")

    # no new tokens: both vanilla paths return the prompt alone
    for fused in (False, True):
        out = base.generate_vanilla(prompts[0], max_new_tokens=0, fused=fused)
        if not np.array_equal(out, prompts[0]):
            fail(f"fp32 generate_vanilla(max_new_tokens=0, fused={fused}) returned "
                 f"{len(out)} tokens for a prompt of {len(prompts[0])}")
    log("[exact] generate_vanilla(max_new_tokens=0) returns the prompt, fused and not")

    # the bonus token takes the vanilla rule: with two logits one f32 ulp apart
    # (0.1 and the next float) in every row, the argmax is the larger one while
    # a softmax rounds both to 0.5
    orig = transformer.lm_head
    lo = np.float32(0.1)
    hi = np.nextafter(lo, np.float32(1.0))

    def tied(p, c, h):
        x = torch.full_like(orig(p, c, h), -30.0)
        x[..., 0], x[..., 1] = float(lo), float(hi)
        return x

    transformer.lm_head = tied
    try:
        van = base.generate_vanilla(prompts[0], max_new_tokens=24)
        outs = {"generate": base.generate(prompts[0], max_new_tokens=24),
                "generate_fused": base.generate_fused(prompts[0], max_new_tokens=24)}
    finally:
        transformer.lm_head = orig
    if not (van[len(prompts[0]):] == 1).all():
        fail("fp32 one-ulp tie: vanilla did not take the larger logit")
    for name, out in outs.items():
        if not np.array_equal(out, van):
            fail(f"fp32 one-ulp tie at the final node: {name} != generate_vanilla")
    log("[exact] one-ulp logit tie in every row: generate == generate_fused == vanilla")

    # head_dim 64, the hd64 path's head width, both attention kernels on
    cfg64 = dataclasses.replace(cfg, num_q_heads=8, num_kv_heads=2, head_dim=64,
                                intermediate_size=2048)
    dcfg64 = dataclasses.replace(dcfg, num_q_heads=8, num_kv_heads=2, head_dim=64)
    eng = EagleEngine(transformer.init_params(cfg64, seed=12, device=dev), cfg64,
                      draft_mod.init_params(dcfg64, seed=13, device=dev), dcfg64, ecfg,
                      device=dev)
    ak.reset_launch_counts()
    for prompt in prompts:
        van = eng.generate_vanilla(prompt, max_new_tokens=64)
        for name, out in (("generate", eng.generate(prompt, max_new_tokens=64)),
                          ("generate_fused", eng.generate_fused(prompt, max_new_tokens=64))):
            if not np.array_equal(out, van):
                fail(f"fp32 head_dim 64: {name} != generate_vanilla (prompt {len(prompt)})")
    if not (ak.LAUNCHES["tree_attention"] and ak.LAUNCHES["compact_rows"]):
        fail(f"fp32 head_dim 64: launches {_nonzero(ak.LAUNCHES)}")
    log(f"[exact] head_dim 64 target and draft, prompts {[len(p) for p in prompts]}: "
        f"generate == generate_fused == vanilla; launches {_nonzero(ak.LAUNCHES)}")


def check_batched_exactness(dev) -> None:
    """fp32, batched: every row of generate_batch_fused (B = 3 ragged prompts,
    one bucket of 256 prompt rows) equals, token for token, its own
    one-sequence generate_fused and its generate_vanilla, for the dense
    target, an int4 target + int4 draft + fused scoring, a static tree,
    kv_buckets across a bucket edge and an int8 KV cache; forced replay and
    EOS per row on the dense target; generate_batch too. No row of any
    engine is exempt: the int4 rows of the prompts where fault C6 showed (40
    and 130 tokens, `default_rng(4)`) included, one sequence and batched. A
    batch runs B1 once per layer for its prefill (the row-exact f32 route)
    and once per layer and round, and never B2; a batched round of
    each engine waits on no host sync."""
    cfg, dcfg = fp32_configs()
    ecfg = EngineConfig(total_tokens=60, depth=5, top_k=10, max_len=512,
                        compact_impl="pallas")
    params = transformer.init_params(cfg, seed=10, device=dev)
    dparams = draft_mod.init_params(dcfg, seed=11, device=dev)
    base = EagleEngine(params, cfg, dparams, dcfg, ecfg, device=dev)
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in (5, 40, 130)]
    long_prompt = rng.integers(0, cfg.vocab_size, 400)
    L, new = cfg.num_layers, 64
    int4 = EagleEngine(tq4.quantize_target_params4(params), cfg, dparams, dcfg,
                       dataclasses.replace(ecfg, draft_quant="int4", fuse_scoring=True),
                       device=dev)
    cases = (("dense", base, prompts, ("tree_attention",)),
             ("int4 target, int4 draft, fused scoring", int4, prompts,
              ("tree_attention", "qdense4", "qdense4_stacked", "score_topk_quant")),
             ("static tree mc_sim_7b_63", base._sibling(tree_paths=MC_SIM_7B_63), prompts,
              ("tree_attention",)),
             # the 400-token row leaves the 512-row bucket while decoding
             ("kv_buckets (256, 512)", base._sibling(kv_buckets=(256, 512)),
              [prompts[1], long_prompt, prompts[0]], ("tree_attention",)),
             ("int8 KV cache", base._sibling(kv_quant="int8"), prompts, ()))
    for label, eng, ps, must_launch in cases:
        bucketed = eng.ecfg.kv_buckets is not None
        van = [eng.generate_vanilla(p, max_new_tokens=new, fused=bucketed) for p in ps]
        used = set()
        limit_of = eng._kv_limit
        eng._kv_limit = lambda n, f=limit_of: used.add(f(n)) or f(n)
        ak.reset_launch_counts()
        outs, committed, rounds = eng.generate_batch_fused(ps, max_new_tokens=new, log=True)
        launches = dict(ak.LAUNCHES)
        eng._kv_limit = limit_of       # the buckets of the batch alone
        for i, (o, v) in enumerate(zip(outs, van)):
            one = eng.generate_fused(ps[i], max_new_tokens=new)
            for name, out in (("generate_batch_fused", o), ("one-sequence generate_fused", one)):
                if len(out) != len(v) or not np.array_equal(out, v):
                    bad = int(np.argmax(out[: len(v)] != v[: len(out)])) - len(ps[i])
                    fail(f"fp32 batched {label}: {name}, row {i} (prompt {len(ps[i])}), "
                         f"leaves its generate_vanilla at new token {bad}")
        idle = [k for k in must_launch if launches[k] == 0]
        # B1 once per layer for the batch's prefill (the row-exact f32 route)
        # and once per layer and round
        want_b1 = L * (rounds + 1) if eng._row_exact else 0
        if idle or launches["compact_rows"] or launches["tree_attention"] != want_b1:
            fail(f"fp32 batched {label}: launches {_nonzero(launches)} for {rounds} rounds "
                 f"(B1 must launch {L} times for the prefill and {L} times a round for the "
                 f"whole batch, B2 never)")
        # one bucket for the batch, from its longest row (400 prompt tokens:
        # 512, then the full cache)
        if bucketed and used != {512, eng._tgt_len()}:
            fail(f"fp32 batched {label}: buckets used {sorted(used)}; no edge crossed")
        check_round_without_sync(f"fp32 batched {label}", eng, ps)
        log(f"[exact batched] {label}, prompts {[len(p) for p in ps]}: every row of "
            f"generate_batch_fused == its one-sequence generate_fused == its vanilla"
            f" ({rounds} rounds, committed {committed}); "
            f"launches {_nonzero(launches)}"
            + (f", buckets {sorted(used)}" if bucketed else "")
            + "; a batched round waits on no host sync")

    van = [base.generate_vanilla(p, max_new_tokens=new + base.path_len + 1) for p in prompts]
    outs = base.generate_batch(prompts, max_new_tokens=new)
    if any(not np.array_equal(o, v[: len(p) + new]) for o, v, p in zip(outs, van, prompts)):
        fail("fp32 generate_batch: a row differs from its generate_vanilla")
    refs = [v.copy() for v in van]
    flip = len(prompts[1]) + 7
    refs[1][flip] = (refs[1][flip] + 1) % cfg.vocab_size
    outs, committed, rounds = base.generate_batch_fused(prompts, max_new_tokens=new,
                                                        force_tokens=refs, log=True)
    if any(not np.array_equal(o, r[: len(o)]) or len(o) != len(p) + new
           for o, r, p in zip(outs, refs, prompts)):
        fail("fp32 batched forced replay: a row left its reference")
    eos = int(van[0][len(prompts[0]) + 10])
    eng = base._sibling()
    eng.eos_token_id = eos
    for name, outs in (("generate_batch_fused", eng.generate_batch_fused(prompts, max_new_tokens=new)),
                       ("generate_batch", eng.generate_batch(prompts, max_new_tokens=new))):
        for o, p in zip(outs, prompts):
            if not np.array_equal(o, base.generate_vanilla(p, max_new_tokens=new,
                                                           eos_token_id=eos)):
                fail(f"fp32 batched EOS per row: {name} row of prompt {len(p)} differs")
    log(f"[exact batched] dense: generate_batch rows == vanilla; forced replay walks each "
        f"row's reference (a flipped token in row 1); EOS {eos} per row (generate_batch and "
        f"generate_batch_fused) == vanilla with that EOS")


def check_serving_exactness(dev) -> None:
    """fp32 with the kernels on, on the dense engine and on the int4 engine
    (int4 target + int4 draft + fused scoring): a 3-turn EagleSession equals
    generate_vanilla of each turn's full context; EagleServer(max_batch=2,
    async_schedule=1) over 5 staggered requests gives each request its
    generate_vanilla; PagedEagleServer(page_size=16, prefill_chunk=64) with
    a pool that forces a preemption (two long generations and a chunked
    prompt in 18 pages), and one with a request that adopts a donated
    200-token prefix beside a fresh one, give each request its
    generate_vanilla. Every attention of these engines runs B1's row-exact
    f32 route: prefills, chunks, session extensions, verifies and vanilla
    steps."""
    cfg, dcfg = fp32_configs()
    ecfg = EngineConfig(total_tokens=60, depth=5, top_k=10, max_len=512,
                        compact_impl="pallas")
    params = transformer.init_params(cfg, seed=10, device=dev)
    dparams = draft_mod.init_params(dcfg, seed=11, device=dev)
    V = cfg.vocab_size
    engines = (("dense", EagleEngine(params, cfg, dparams, dcfg, ecfg, device=dev)),
               ("int4 target, int4 draft, fused scoring",
                EagleEngine(tq4.quantize_target_params4(params), cfg, dparams, dcfg,
                            dataclasses.replace(ecfg, draft_quant="int4", fuse_scoring=True),
                            device=dev)))
    for label, eng in engines:
        rng = np.random.default_rng(5)
        ak.reset_launch_counts()

        def held(what, out, prompt, new):
            van = eng.generate_vanilla(prompt, max_new_tokens=new)
            if len(out) != len(van) or not np.array_equal(out, van):
                bad = int(np.argmax(out[: len(van)] != van[: len(out)])) - len(prompt)
                fail(f"fp32 serving {label}: {what} (prompt {len(prompt)}) leaves its "
                     f"generate_vanilla at new token {bad}")

        sess = EagleSession(eng)
        ctx, reused = rng.integers(0, V, 30), []
        for turn in range(3):
            out, st = sess.send(ctx, max_new_tokens=24, log=True)
            held(f"session turn {turn}", out, ctx, 24)
            reused.append(st["reused_prefix"])
            ctx = np.concatenate([out, rng.integers(0, V, 9)])
        if reused[0] != 0 or not all(reused[1:]):
            fail(f"fp32 serving {label}: session reused prefixes {reused}")

        prompts = [rng.integers(0, V, n) for n in (5, 40, 130, 17, 64)]
        budgets = (32, 48, 24, 40, 32)
        srv = EagleServer(eng, max_batch=2, async_schedule=1)
        rids = [srv.submit(prompts[i], budgets[i]) for i in (0, 1)]
        srv.step()
        srv.step()
        rids.append(srv.submit(prompts[2], budgets[2]))
        srv.step()
        rids += [srv.submit(prompts[i], budgets[i]) for i in (3, 4)]
        outs = srv.run()
        for i, rid in enumerate(rids):
            held(f"EagleServer request {i}", outs[rid], prompts[i], budgets[i])

        tight = PagedEagleServer(eng, max_batch=2, page_size=16, prefill_chunk=64,
                                 num_pages=19, async_schedule=1)
        paged = [(prompts[0], 140), (prompts[1], 130), (prompts[2], 24)]
        rids = [tight.submit(p, b) for p, b in paged]
        outs = tight.run()
        if tight.preemptions < 1:
            fail(f"fp32 serving {label}: the 18-page pool forced no preemption")
        for (p, b), rid in zip(paged, rids):
            held("PagedEagleServer (tight pool) request", outs[rid], p, b)

        donor = rng.integers(0, V, 200)
        adopter = np.concatenate([donor, rng.integers(0, V, 20)])
        px = PagedEagleServer(eng, max_batch=2, page_size=16, prefill_chunk=64,
                              async_schedule=1)
        rd = px.submit(donor, 16)
        px.run()
        ra, rf = px.submit(adopter, 40), px.submit(prompts[3], 40)
        outs = px.run()
        if px.store.hits != 1 or px.store.reused_tokens < 191:
            fail(f"fp32 serving {label}: the adopter reused {px.store.reused_tokens} rows "
                 f"({px.store.hits} hits)")
        held("PagedEagleServer donor", px.finished[rd], donor, 16)
        held("PagedEagleServer adopter", outs[ra], adopter, 40)
        held("PagedEagleServer fresh request", outs[rf], prompts[3], 40)
        log(f"[exact serving] {label}: 3-turn session (reused {reused}), EagleServer "
            f"(5 staggered, async), PagedEagleServer (tight pool: {tight.preemptions} "
            f"preemptions, {tight.cancelled_prefills} cancelled chunk jobs, "
            f"{tight.chunked_prefills} chunked; prefix: {px.store.reused_tokens} rows "
            f"adopted) == generate_vanilla for every request; launches "
            f"{_nonzero(ak.LAUNCHES)}")


def check_sampled_exactness(dev) -> None:
    """Sampled engines at sampling_top_k = 1 (temperature 0.8): the processed
    distributions are one-hot, so every acceptance rule and every draw is
    deterministic and the output must be the greedy vanilla decode, in fp32
    with the kernels on: the dense target under "true_q" (dynamic tree: the
    q(x) = 1 rule) and "q1", the int4 target + int4 draft + fused scoring
    under "true_q_dynamic", the static tree under "true_q" (sampled
    candidates, the true-q rule) and the dynamic tree under
    "true_q_dynamic". An engine built without `device` runs on the card and
    draws its noise there."""
    cfg, dcfg = fp32_configs()
    greedy = EngineConfig(total_tokens=60, depth=5, top_k=10, max_len=512,
                          compact_impl="pallas")
    hot = dict(temperature=0.8, sampling_top_k=1)
    params = transformer.init_params(cfg, seed=10, device=dev)
    dparams = draft_mod.init_params(dcfg, seed=11, device=dev)
    params4 = tq4.quantize_target_params4(params)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in (5, 130)]
    van = {}
    for tag, tparams in (("dense", params), ("int4", params4)):
        eng = EagleEngine(tparams, cfg, dparams, dcfg, greedy, device=dev)
        van[tag] = [eng.generate_vanilla(p, max_new_tokens=48) for p in prompts]
    attn = ("tree_attention", "compact_rows")
    cases = (
        ("dense target, dynamic tree, true_q (the q1 rule)", "dense",
         dict(acceptance="true_q"), attn),
        ("dense target, dynamic tree, q1", "dense", dict(acceptance="q1"), attn),
        ("dense target, dynamic tree, true_q_dynamic", "dense",
         dict(acceptance="true_q_dynamic"), attn),
        ("dense target, static tree, true_q", "dense",
         dict(acceptance="true_q", tree_paths=MC_SIM_7B_63), attn),
        ("int4 target, int4 draft, fused scoring, true_q_dynamic", "int4",
         dict(acceptance="true_q_dynamic", draft_quant="int4", fuse_scoring=True),
         ENGINE_KERNELS))
    for label, tag, kw, must_launch in cases:
        e = dataclasses.replace(greedy, **hot, **kw)
        eng = EagleEngine(params4 if tag == "int4" else params, cfg, dparams, dcfg, e)
        if eng.device.type != "cuda" or eng._requests(None, 0, 1)[1][0].device.type != "cuda":
            fail(f"sampled {label}: the engine or its generator is not on the card")
        ak.reset_launch_counts()
        for i, prompt in enumerate(prompts):
            want = van[tag][i]
            outs = {"generate": eng.generate(prompt, max_new_tokens=48, seed=i),
                    "generate_fused": eng.generate_fused(prompt, max_new_tokens=48,
                                                         seed=i + 7)}
            for name, out in outs.items():
                if not np.array_equal(out, want):
                    bad = int(np.argmax(out[: len(want)] != want[: len(out)]))
                    fail(f"sampled top_k=1 {label}: {name} != greedy vanilla (prompt "
                         f"{len(prompt)}, index {bad})")
        idle = [k for k in must_launch if ak.LAUNCHES[k] == 0]
        if idle:
            fail(f"sampled {label}: kernels never launched: {idle} ({ak.LAUNCHES})")
        check_round_without_sync(f"sampled {label}", eng, prompts[1])
        log(f"[sampled] top_k=1, t=0.8, {label}: generate == generate_fused == greedy "
            f"vanilla at prompts {[len(p) for p in prompts]}; launches "
            f"{_nonzero(ak.LAUNCHES)}; a round waits on no host sync")


MC_V, MC_TRIALS = 16, 200_000


def check_sampled_mc(dev) -> None:
    """The acceptance rules on the card's own generator, 200k trials batched
    over a leading trial dimension (the tree and the tolerances of
    tests/test_losslessness_mc.py): accept_sampled's first token (3 sigma +
    1e-3 a bin) and second token given each in-tree first token (4 sigma +
    2e-3) follow the target; accept_sampled_true_q over trees sampled from a
    draft Q != P gives P's first token (4 sigma + 1e-3) and second token
    (5 sigma + 3e-3)."""
    from eagle_tpu_torch.engine import accept as accept_mod
    from eagle_tpu_torch.engine.sampling import U_MIN, categorical, process_logits
    from eagle_tpu_torch.ops.tree import Tree, build_tree, children_table

    V, n = MC_V, MC_TRIALS
    gen = torch.Generator(device=dev)
    gen.manual_seed(123)
    rand = lambda *shape: torch.rand(shape, generator=gen, device=dev)
    parents = torch.tensor([0, 0, 0, 0, 1, 1, 2, 4], device=dev)
    rows = torch.arange(n, device=dev)

    def emitted(tokens, acc, path_len):
        toks = tokens.gather(1, acc.path) if tokens.dim() == 2 else tokens[acc.path]
        seq = torch.cat([toks[:, 1:], torch.zeros((n, 1), dtype=torch.long, device=dev)], 1)
        seq[rows, acc.accept_len] = categorical(acc.sample_p, rand(n, V).clamp_min(U_MIN))
        return seq

    def check(seq, table, first, t1s, tol1, tol2, ecfg, label):
        probs = lambda tok: torch.softmax(process_logits(table[tok], ecfg.temperature,
                                                         ecfg.sampling_top_k, ecfg.top_p),
                                          dim=-1).cpu().numpy()
        seqs = seq.cpu().numpy()
        p = probs(first)
        emp = np.bincount(seqs[:, 0], minlength=V) / n
        dev1 = np.abs(emp - p) - (tol1[0] * np.sqrt(np.maximum(p * (1 - p), 1e-12) / n)
                                  + tol1[1])
        worst = float(dev1.max())
        for t1 in t1s:
            sel = seqs[:, 0] == t1
            if sel.sum() < 5000:
                continue
            p2 = probs(t1)
            emp2 = np.bincount(seqs[sel, 1], minlength=V) / sel.sum()
            dev2 = np.abs(emp2 - p2) - (tol2[0] * np.sqrt(np.maximum(p2 * (1 - p2), 1e-12)
                                                          / sel.sum()) + tol2[1])
            worst = max(worst, float(dev2.max()))
        if worst > 0:
            fail(f"[mc] {label}: an empirical frequency is {worst:.4f} past its tolerance")
        log(f"[mc] {label}: {n} trials on the card, first token and second token given "
            f"the first within tolerance (margin {-worst:.4f})")

    # q(x) = 1 over a fixed tree: root(3) -> {5, 1, 7}; 5 -> {2, 9}; 1 -> {4}; 2 -> {11}
    rng = np.random.default_rng(0)
    table = torch.from_numpy(rng.normal(0, 1.5, size=(V, V)).astype(np.float32)).to(dev)
    tokens = torch.tensor([3, 5, 1, 7, 2, 9, 4, 11], device=dev)
    tree = build_tree(tokens, parents, k=3, max_depth=4)
    for ecfg in (EngineConfig(temperature=1.0), EngineConfig(temperature=0.7),
                 EngineConfig(temperature=1.0, top_p=0.8),
                 EngineConfig(temperature=0.9, sampling_top_k=8)):
        acc = accept_mod.accept_sampled(tree, table[tokens], rand(n, 4, 3), ecfg, 5)
        check(emitted(tokens, acc, 5), table, 3, [5, 1, 7], (3, 1e-3), (4, 2e-3), ecfg,
              f"accept_sampled t={ecfg.temperature} top_p={ecfg.top_p} "
              f"top_k={ecfg.sampling_top_k}")

    # true q over trees sampled without replacement from a draft Q != P
    rng = np.random.default_rng(7)
    ptab = torch.from_numpy(rng.normal(0, 1.5, size=(V, V)).astype(np.float32)).to(dev)
    qtab = torch.softmax(torch.from_numpy(
        rng.normal(0, 1.0, size=(V, V)).astype(np.float32)).to(dev), dim=-1)
    ecfg = EngineConfig(temperature=1.0, acceptance="true_q")
    toks = torch.zeros((n, 8), dtype=torch.long, device=dev)
    toks[:, 0] = 3
    node_probs = torch.zeros((n, 8, V), device=dev)
    for node, childs in ((0, [1, 2, 3]), (1, [4, 5]), (2, [6]), (4, [7])):
        q = qtab[toks[:, node]]
        g = -torch.log(-torch.log(rand(n, V).clamp_min(U_MIN)))
        node_probs[:, node] = q
        toks[:, childs] = torch.topk(torch.log(q) + g, len(childs), dim=-1).indices
    tree = Tree(tokens=toks, parents=parents, mask=None, positions=None,
                children=children_table(parents, 3), node_probs=node_probs)
    acc = accept_mod.accept_sampled_true_q(tree, ptab[toks], rand(n, 4, 3), ecfg, 5)
    seq = emitted(toks, acc, 5)
    for j in range(1, 4):      # past the emission: ancestral samples from P
        nxt = categorical(torch.softmax(ptab[seq[:, j - 1]], dim=-1),
                          rand(n, V).clamp_min(U_MIN))
        seq[:, j] = torch.where(j <= acc.accept_len, seq[:, j], nxt)
    if float(acc.accept_len.float().mean()) <= 0.05:
        fail("[mc] accept_sampled_true_q accepts almost nothing")
    check(seq, ptab, 3, range(V), (4, 1e-3), (5, 3e-3), ecfg, "accept_sampled_true_q")


# ---------------------------------------------------------------------------
# phase 4: the main paths at full width
# ---------------------------------------------------------------------------

def expected_launches(eng, requests: int, rounds: int, batched: bool = False) -> dict:
    """Launch counts of a speculative run, from its own numbers: `requests`
    prefills (one target forward and one draft round each) and `rounds`
    rounds (one verify forward and one draft round each). A batch is one
    request: its prefill, verify and draft rounds launch once for all rows,
    and it runs no compaction kernel."""
    L, depth = eng.cfg.num_layers, eng.ecfg.depth
    exp = {k: 0 for k in ak.LAUNCHES}
    exp["tree_attention"] = L * rounds
    exp["compact_rows"] = 0 if batched else rounds
    if "stacked4" in eng.params:
        forwards, draft_rounds = requests + rounds, requests + rounds
        exp["qdense4_stacked"] = len(eng.params["stacked4"]) * L * forwards
        # lm_head once per target forward; a draft round is one extension
        # forward (fc, wqkv, wo, wgu, w_down) and `depth` beam forwards (no fc)
        per_draft = 5 + 4 * depth
        if eng.sampled and eng.ecfg.acceptance == "true_q_dynamic":
            # two-pass drafting: the root's head, then depth + 1 level
            # forwards of the whole tree (4 each) and the head at `depth` of them
            per_draft += 1 + 4 * (depth + 1) + depth
        exp["qdense4"] = forwards + per_draft * draft_rounds
        exp["score_topk_quant"] = (depth + 1) * draft_rounds
    return exp


def main_path(dev, label: str, build, prompt_lens) -> tuple[dict, dict, EagleEngine]:
    # an earlier path's engines may sit in reference cycles (a `_kv_limit`
    # wrapper holds its engine): free them, so the peak is this path's own
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    eng = build(dev)
    cfg = eng.cfg
    torch.cuda.synchronize()
    log(f"[{label}] random weights on the card in {time.time() - t0:.1f} s; "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    rng = np.random.default_rng(3)
    all_prompts = [rng.integers(0, cfg.vocab_size, n) for n in (24, 311, 977)]
    prompts = [p for p in all_prompts if len(p) in prompt_lens]
    all_prompts = prompts if len(prompts) > 1 else all_prompts
    new = 128
    eng.generate_fused(prompts[0][:8], max_new_tokens=16)     # warm-up
    eng.generate_vanilla(prompts[0][:8], max_new_tokens=4)
    torch.cuda.synchronize()

    # the requests through the speculative main path
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
            fail(f"[{label}] request of {len(p)} tokens returned {len(out)} tokens")
        if out.min() < 0 or out.max() >= cfg.vocab_size:
            fail(f"[{label}] tokens outside the vocabulary")
    exp = expected_launches(eng, len(prompts), rounds)
    if launches != exp:
        fail(f"[{label}] launches {launches}, expected {exp} for {len(prompts)} "
             f"requests and {rounds} rounds")

    # vanilla baseline on request 0, then forced replay of its trajectory
    P = eng.path_len
    ak.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.time()
    van = eng.generate_vanilla(prompts[0], max_new_tokens=new + P + 1)
    torch.cuda.synchronize()
    van_s = time.time() - t0
    if "stacked4" in eng.params:
        # one prefill and one step per token (the last step's token is unused)
        steps = 1 + new + P + 1
        want = {"qdense4_stacked": 7 * cfg.num_layers * steps, "qdense4": steps}
        got = {k: ak.LAUNCHES[k] for k in want}
        if got != want:
            fail(f"[{label}] vanilla launches {got}, expected {want}")
    ak.reset_launch_counts()
    fout, fn, frounds, live = eng.generate_fused(prompts[0], max_new_tokens=new,
                                                 log=True, force_tokens=van)
    if not np.array_equal(fout, van[: len(fout)]) or len(fout) != len(prompts[0]) + new:
        fail(f"[{label}] forced replay did not reproduce the vanilla trajectory")
    if dict(ak.LAUNCHES) != expected_launches(eng, 1, frounds):
        fail(f"[{label}] forced replay launches {ak.LAUNCHES} for {frounds} rounds")
    # what a request pays before its first round: the target's forward over
    # the padded prompt and the first draft round
    for p in all_prompts:
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.time()
            eng._start(p, None)
            torch.cuda.synchronize()
            times.append((time.time() - t0) * 1e3)
        log(f"[{label}] prefill of {len(p)} tokens (padded to {eng._bucket(len(p))}): "
            f"{np.median(times):.1f} ms, host clock with sync, median of 3")
    Lp = len(prompts[0])
    diff = np.nonzero(outs[0][Lp:] != van[Lp: Lp + new])[0]
    stats = {
        "path": label,
        "prompt_lens": [len(p) for p in prompts], "new_tokens_each": new,
        "spec_tokens_per_s": len(prompts) * new / spec_s, "spec_rounds": rounds,
        "tau": committed / rounds,
        "vanilla_tokens_per_s": (new + P + 1) / van_s,
        "forced_replay_tau": fn / frounds,
        "forced_replay_live_agreement": live / fn,
        "first_free_running_divergence": int(diff[0]) if diff.size else None,
        "peak_GiB_allocated": torch.cuda.max_memory_allocated() / 2**30,
        "weights": "random (seeded), lm_head x8",
    }
    log(f"[{label}] {json.dumps(stats)}")
    return launches, stats, eng


SAMPLED = dict(temperature=0.7, top_p=0.9)


def sampled_path(dev, label: str, eng: EagleEngine, acceptance: str, card: str,
                 repeat: bool = False) -> dict:
    """One sampled request (SAMPLED, 64 new tokens, a 311-token prompt)
    through generate_fused on a sibling of `eng` with `acceptance`, after a
    warm-up; its launch counts against the path's own expected numbers;
    `repeat`: the same seed again gives the same tokens. Logs its rate beside
    `card` (nvidia-smi's name and power limit). Returns the counts."""
    eng = eng._sibling(acceptance=acceptance, **SAMPLED)
    rng = np.random.default_rng(6)
    prompt = rng.integers(0, eng.cfg.vocab_size, 311)
    new = 64
    eng.generate_fused(prompt[:8], max_new_tokens=8, seed=1)          # warm-up
    torch.cuda.synchronize()
    ak.reset_launch_counts()
    t0 = time.time()
    out, n, rounds = eng.generate_fused(prompt, max_new_tokens=new, log=True, seed=7)
    torch.cuda.synchronize()
    spec_s = time.time() - t0
    launches = dict(ak.LAUNCHES)
    if len(out) != len(prompt) + new or not np.array_equal(out[:311], prompt) \
            or out.min() < 0 or out.max() >= eng.cfg.vocab_size:
        fail(f"[{label}] sampled request returned {len(out)} tokens or ids outside the "
             f"vocabulary")
    exp = (_attn_launches(eng, rounds) if "stacked4" not in eng.params
           else expected_launches(eng, 1, rounds))
    if launches != exp:
        fail(f"[{label}] sampled launches {_nonzero(launches)}, expected {_nonzero(exp)} "
             f"for {rounds} rounds")
    log(f"[{label}] " + json.dumps({
        "card": card, "path": label, "acceptance": acceptance, **SAMPLED,
        "prompt": len(prompt), "new_tokens": new, "tokens_per_s": new / spec_s,
        "rounds": rounds, "tau": n / rounds, "launches": _nonzero(launches),
        "weights": "random (seeded), lm_head x8"}))
    if repeat and not np.array_equal(eng.generate_fused(prompt, max_new_tokens=new, seed=7),
                                     out):
        fail(f"[{label}] the same seed gave other tokens")
    return launches


def _attn_launches(eng, rounds: int) -> dict:
    exp = {k: 0 for k in ak.LAUNCHES}
    exp["tree_attention"] = eng.cfg.num_layers * rounds
    exp["compact_rows"] = rounds
    return exp


BATCH_PROMPTS = (24, 311, 977, 150)


def batched_path(dev, label: str, eng: EagleEngine, card: str) -> dict:
    """B = 4 requests (prompts of BATCH_PROMPTS tokens, 128 new tokens each)
    through generate_batch_fused on a full-width engine: every row's tokens
    in range, launch counts against the run's own numbers (B1 once per layer
    and round for the whole batch, B2 never), aggregate tok/s, round time
    (host clock with sync, median of 10 batched rounds at the same
    context), launches per round and peak memory, beside `card`."""
    rng = np.random.default_rng(9)
    prompts = [rng.integers(0, eng.cfg.vocab_size, n) for n in BATCH_PROMPTS]
    new, L = 128, eng.cfg.num_layers
    eng.generate_batch_fused([p[:8] for p in prompts], max_new_tokens=8)   # warm-up
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ak.reset_launch_counts()
    t0 = time.time()
    outs, committed, rounds = eng.generate_batch_fused(prompts, max_new_tokens=new, log=True)
    torch.cuda.synchronize()
    batch_s = time.time() - t0
    launches = dict(ak.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2**30
    for p, out in zip(prompts, outs):
        if len(out) != len(p) + new or not np.array_equal(out[: len(p)], p) \
                or out.min() < 0 or out.max() >= eng.cfg.vocab_size:
            fail(f"[{label} batched] a row of {len(p)} tokens returned {len(out)} tokens")
    exp = expected_launches(eng, 1, rounds, batched=True)
    if launches != exp or launches["tree_attention"] != L * rounds:
        fail(f"[{label} batched] launches {_nonzero(launches)}, expected {_nonzero(exp)} "
             f"for {rounds} rounds (B1 {L} a round)")
    _, st = eng._start_batch(prompts, None)
    round_ms = []
    with torch.no_grad():
        for i in range(13):
            torch.cuda.synchronize()
            t0 = time.time()
            st, _ = eng._round(st)
            torch.cuda.synchronize()
            if i >= 3:
                round_ms.append((time.time() - t0) * 1e3)
    stats = {
        "card": card, "path": f"{label}, batched B = {len(prompts)}",
        "prompt_lens": list(BATCH_PROMPTS), "new_tokens_each": new,
        "aggregate_tokens_per_s": len(prompts) * new / batch_s,
        "wall_s": batch_s, "rounds": rounds,
        "committed_per_row": committed, "tau_per_row": [c / rounds for c in committed],
        "round_ms_median_of_10": float(np.median(round_ms)),
        "launches_per_round": {k: v / rounds for k, v in _nonzero(launches).items()},
        "peak_GiB_allocated": peak, "weights": "random (seeded), lm_head x8"}
    log(f"[{label} batched] {json.dumps(stats)}")
    return launches


SERVE_PROMPTS = (24, 311, 977, 150, 311, 24, 500, 977)


def served_path(dev, label: str, eng: EagleEngine, card: str) -> dict:
    """PagedEagleServer(max_batch=4, page_size=16, prefill_chunk=256,
    async_schedule=1, prefix_cache=True) on a full-width engine over 8
    requests (prompts of SERVE_PROMPTS tokens, the second 311-token prompt
    sharing its first 300 tokens with the first; 128 new tokens each),
    served to the end: the first four arrive at once, the other four when
    the first 311-token request has finished, so that its pages are in the
    prefix store when the second one arrives. bf16 rows are not held to their
    vanilla decode (cuBLAS picks its GEMM per M; fp32 serving is held in
    phase 3): each request must finish by length with 128 new tokens in the
    vocabulary after its prompt, and B1 must launch once per layer and
    served round. Logs aggregate tok/s, rounds, B1 launches a round, pool
    bytes, peak memory, preemptions, prefix hits, host syncs per scheduler
    step (the result drains, plus any other sync torch's sync debug mode
    "warn" reports) and the finish reasons, beside `card`."""
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, eng.cfg.vocab_size, n) for n in SERVE_PROMPTS]
    prompts[4][:300] = prompts[1][:300]
    new, L = 128, eng.cfg.num_layers
    warm = PagedEagleServer(eng, max_batch=4, page_size=16, prefill_chunk=256)
    for p in (prompts[0], prompts[3][:40]):
        warm.submit(p, 8)
    warm.run()
    del warm
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    srv = PagedEagleServer(eng, max_batch=4, page_size=16, prefill_chunk=256,
                           async_schedule=1, prefix_cache=True)
    ak.reset_launch_counts()
    steps = 0

    def serve(until):
        nonlocal steps
        while not until():
            if steps == 4000:
                fail(f"[{label} served] not done after {steps} scheduler steps")
            srv.step()
            steps += 1

    t0 = time.time()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            rids = [srv.submit(p, new) for p in prompts[:4]]
            serve(lambda: rids[1] in srv.finished)
            rids += [srv.submit(p, new) for p in prompts[4:]]
            serve(srv._idle)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = dict(ak.LAUNCHES)
    syncs = [w for w in caught if "called a synchronizing CUDA operation" in str(w.message)]
    other_syncs = len(syncs)
    sync_sites = sorted({f"{os.path.relpath(w.filename)}:{w.lineno}" for w in syncs})
    for rid, p in zip(rids, prompts):
        out = srv.finished.get(rid)
        if out is None or len(out) != len(p) + new or not np.array_equal(out[: len(p)], p) \
                or out.min() < 0 or out.max() >= eng.cfg.vocab_size \
                or srv.finish_reasons[rid] != "length":
            fail(f"[{label} served] request of {len(p)} tokens: "
                 f"{None if out is None else len(out)} tokens, "
                 f"finish {srv.finish_reasons.get(rid)}")
    if launches["tree_attention"] != L * srv.rounds or launches["compact_rows"]:
        fail(f"[{label} served] launches {_nonzero(launches)} for {srv.rounds} served rounds "
             f"(B1 {L} a round, B2 never)")
    reasons = {}
    for r in srv.finish_reasons.values():
        reasons[r] = reasons.get(r, 0) + 1
    stats = {
        "card": card, "path": f"{label}, PagedEagleServer B = 4, 16-row pages, chunks of "
        f"256, async depth 1, prefix cache", "prompt_lens": list(SERVE_PROMPTS),
        "new_tokens_each": new, "aggregate_tokens_per_s": len(prompts) * new / wall,
        "wall_s": wall, "scheduler_steps": steps, "rounds": srv.rounds,
        "b1_launches_per_round": launches["tree_attention"] / srv.rounds,
        "pool_bytes": srv.pool_bytes,
        "peak_GiB_allocated": torch.cuda.max_memory_allocated() / 2**30,
        "preemptions": srv.preemptions, "prefix_hits": srv.store.hits,
        "prefix_reused_tokens": srv.store.reused_tokens,
        "chunked_prefills": srv.chunked_prefills,
        "host_syncs_per_step": (srv.drains + other_syncs) / steps,
        "drains_per_step": srv.drains / steps, "other_syncs": other_syncs,
        "other_sync_sites": sync_sites,
        "finish_reasons": reasons,
        "launches_per_round": {k: v / srv.rounds for k, v in _nonzero(launches).items()},
        "weights": "random (seeded), lm_head x8"}
    log(f"[{label} served] {json.dumps(stats)}")
    return launches


def static_path(dev, base: EagleEngine) -> dict:
    """This slice's path at full width: the static-tree + kv_buckets engine
    over the bf16 engine's weights answers one request through
    generate_stream (its per-round host loop is unbucketed, as in the JAX
    package) and two through generate_fused (bucketed). B1 launches once per
    layer and round at T = 26, B2 once per round."""
    eng = full_width.engine_static(dev, base=base)
    if eng.ecfg.tree_size != T_STATIC or eng.params["lm_head"] is not base.params["lm_head"]:
        fail("[static] engine_static must share the bf16 weights and use the 26-node tree")
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, eng.cfg.vocab_size, n) for n in (24, 311, 977)][1:]
    new = 128
    eng.generate_fused(prompts[0][:8], max_new_tokens=16)     # warm-up
    torch.cuda.synchronize()

    ak.reset_launch_counts()
    t0 = time.time()
    rounds, ids = 0, None
    for ids, st in eng.generate_stream(prompts[0], max_new_tokens=new):
        rounds = st["rounds"]
    torch.cuda.synchronize()
    stream_s = time.time() - t0
    launches = dict(ak.LAUNCHES)
    if len(ids) != len(prompts[0]) + new or not np.array_equal(ids[:311], prompts[0]):
        fail(f"[static] generate_stream returned {len(ids)} tokens")
    if launches != _attn_launches(eng, rounds):
        fail(f"[static] stream launches {_nonzero(launches)} for {rounds} rounds")

    used = []
    limit_of = eng._kv_limit
    eng._kv_limit = lambda n: used.append(limit_of(n)) or used[-1]
    want_buckets = ([512], [1024, eng._tgt_len()])
    fused_s, fused_rounds = 0.0, 0
    for p, want in zip(prompts, want_buckets):
        used.clear()
        ak.reset_launch_counts()
        t0 = time.time()
        out, n, r = eng.generate_fused(p, max_new_tokens=new, log=True)
        torch.cuda.synchronize()
        fused_s += time.time() - t0
        fused_rounds += r
        if len(out) != len(p) + new or out.min() < 0 or out.max() >= eng.cfg.vocab_size:
            fail(f"[static] generate_fused of {len(p)} tokens returned {len(out)}")
        if dict(ak.LAUNCHES) != _attn_launches(eng, r):
            fail(f"[static] fused launches {_nonzero(ak.LAUNCHES)} for {r} rounds")
        if sorted(set(used)) != want:
            fail(f"[static] prompt {len(p)}: buckets {sorted(set(used))}, expected {want}")
        for k in launches:
            launches[k] += ak.LAUNCHES[k]
        if len(p) == 311:
            same = bool(np.array_equal(out, ids))
            log(f"[static] generate_fused (bucketed) == generate_stream's ids: {same}")
    log("[static] " + json.dumps({
        "path": "static tree (26 nodes) + kv_buckets (512, 1024), bf16",
        "stream_tokens_per_s": new / stream_s, "stream_rounds": rounds,
        "fused_tokens_per_s": 2 * new / fused_s, "fused_rounds": fused_rounds,
        "buckets_used": {"311": want_buckets[0], "977": want_buckets[1]},
        "launches": _nonzero(launches)}))
    return launches


def kv8_path(dev, base: EagleEngine) -> None:
    """The int8-KV engine over the same weights answers one request through
    generate_fused; it must launch neither attention-side kernel."""
    eng = full_width.engine_kv8(dev, base=base)
    rng = np.random.default_rng(3)
    prompt = [rng.integers(0, eng.cfg.vocab_size, n) for n in (24, 311)][1]
    new = 128
    eng.generate_fused(prompt[:8], max_new_tokens=16)         # warm-up
    torch.cuda.synchronize()
    ak.reset_launch_counts()
    t0 = time.time()
    out, n, rounds = eng.generate_fused(prompt, max_new_tokens=new, log=True)
    torch.cuda.synchronize()
    spec_s = time.time() - t0
    if len(out) != len(prompt) + new or out.min() < 0 or out.max() >= eng.cfg.vocab_size:
        fail(f"[kv8] request returned {len(out)} tokens")
    if any(ak.LAUNCHES.values()):
        fail(f"[kv8] an int8 KV cache must run no kernel: {_nonzero(ak.LAUNCHES)}")
    cache = eng.init_target_cache()
    if cache.k.dtype != torch.int8 or cache.ks is None:
        fail("[kv8] the target cache is not int8 with row scales")
    t0 = time.time()
    van = eng.generate_vanilla(prompt, max_new_tokens=32, fused=True)
    torch.cuda.synchronize()
    van_s = time.time() - t0
    log("[kv8] " + json.dumps({
        "path": "int8 KV cache, bf16 weights, dynamic tree", "rounds": rounds,
        "tau": n / rounds, "spec_tokens_per_s": new / spec_s,
        "vanilla_tokens_per_s": 32 / van_s,
        "first_free_running_divergence": int(np.argmax(
            out[311:311 + 32] != van[311:311 + 32])) if not np.array_equal(
            out[311:311 + 32], van[311:311 + 32]) else None,
        "launches": _nonzero(ak.LAUNCHES)}))


def calibrate_path(dev, base: EagleEngine) -> None:
    timings: list = []
    t0 = time.time()
    n = calibrate_total_tokens(base.params, base.cfg, max_len=base.ecfg.max_len,
                               _debug_timings=timings, device=dev)
    cands = (40, 48, 50, 56, 60)
    if n not in cands or len(timings) != len(cands) or not all(t > 0 for t in timings):
        fail(f"[calibrate] returned {n} with timings {timings}")
    log(f"[calibrate] total_tokens={n}; target forward ms at {cands} tokens: "
        f"{[round(t * 1e3, 3) for t in timings]} (host clock between syncs, 20 reps "
        f"each; {time.time() - t0:.1f} s in all)")


def probe_path() -> dict:
    """The probe's entry point with short chains: its `all` sweep launches
    every variant of B6."""
    ak.reset_launch_counts()
    probe_w4_ablate.CHAIN = (1, 2)
    rows = probe_w4_ablate.run_sweep("all")
    launches = dict(ak.LAUNCHES)
    for row in rows:
        if not (row["us_per_matmul"] > 0 and np.isfinite(row["us_per_matmul"])):
            fail(f"[probe] {row['mode']}: no time measured ({row})")
    idle = [m for m in wab.MODES if launches[f"w4_ablate.{m}"] == 0]
    if idle:
        fail(f"[probe] modes never launched by the `all` sweep: {idle}")
    return launches


def main() -> None:
    if not torch.cuda.is_available():
        fail("CUDA is not available")
    started = time.time()
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
            if "registers" in line or "spill" in line or "entry function" in line:
                log(f"[build] {name}: {line.strip()}")

    phase_s = {"1: build": round(time.time() - t0, 1)}

    def timed(name, fn, *args, **kw):
        t = time.time()
        out = fn(*args, **kw)
        phase_s[name] = round(phase_s.get(name, 0.0) + time.time() - t, 1)
        return out

    flush = torch.empty(128 * 2**20, dtype=torch.uint8, device=dev)
    kernels = [timed("2: B1", check_tree_attention, dev, flush),
               timed("2: B2", check_compact_rows, dev, flush),
               *timed("2: B3/B4", check_w4_matmul, dev, flush),
               timed("2: B5", check_score_topk, dev, flush),
               *timed("2: B6", check_w4_ablate, dev, flush)]
    kernels[0].update(timed("2: B1 batched and wide", check_tree_attention_batched, dev, flush))
    kernels[0].update(timed("2: B1 f32 row-exact", check_tree_attention_row_exact, dev, flush))
    del flush
    torch.cuda.empty_cache()
    timed("3: exact", check_exactness, dev)
    timed("3: exact batched", check_batched_exactness, dev)
    timed("3: exact serving", check_serving_exactness, dev)
    timed("3: exact sampled", check_sampled_exactness, dev)
    timed("3: sampled rules", check_sampled_mc, dev)
    bf16_launches, _, eng = timed("4: bf16", main_path, dev, "bf16", full_width.engine, (24,))
    sampled = {"bf16": timed("4: sampled bf16", sampled_path, dev, "sampled bf16", eng,
                             "true_q", card, repeat=True)}
    batched = {"bf16": timed("4: batched bf16", batched_path, dev, "bf16", eng, card)}
    served = {"bf16": timed("4: served bf16", served_path, dev, "bf16", eng, card)}
    static_launches = timed("4: static", static_path, dev, eng)
    sampled["static"] = timed("4: sampled static", sampled_path, dev, "sampled static",
                              full_width.engine_static(dev, base=eng), "true_q", card)
    timed("4: kv8", kv8_path, dev, eng)
    timed("4: calibrate", calibrate_path, dev, eng)
    del eng
    torch.cuda.empty_cache()
    launches, _, eng = timed("4: int4", main_path, dev, "int4", full_width.engine_int4,
                             (24, 977))
    sampled["int4"] = timed("4: sampled int4", sampled_path, dev, "sampled int4", eng,
                            "true_q_dynamic", card)
    batched["int4"] = timed("4: batched int4", batched_path, dev, "int4", eng, card)
    served["int4"] = timed("4: served int4", served_path, dev, "int4", eng, card)
    del eng
    torch.cuda.empty_cache()
    hd64_launches, _, eng = timed("4: hd64", main_path, dev, "hd64", full_width.engine_hd64,
                                  (24, 977))
    del eng
    torch.cuda.empty_cache()
    probe_launches = timed("4: probe", probe_path)
    for k in kernels:
        # the int4 serving path runs B1-B5; the bf16, static-tree and hd64
        # paths B1 and B2; the probe's path every variant of B6
        if k["name"].startswith("w4_ablate."):
            k["launches"] = probe_launches[k["name"]]
            k["path"] = "probe_w4_ablate `all` sweep, short chains"
        else:
            k["launches"] = launches[k["name"]]
            k["launches_bf16_path"] = bf16_launches[k["name"]]
            k["launches_static_path"] = static_launches[k["name"]]
            k["launches_hd64_path"] = hd64_launches[k["name"]]
            for path, counts in sampled.items():
                k[f"launches_sampled_{path}_path"] = counts[k["name"]]
            for path, counts in batched.items():
                k[f"launches_batched_{path}_path"] = counts[k["name"]]
            for path, counts in served.items():
                k[f"launches_served_{path}_path"] = counts[k["name"]]
        if k["launches"] == 0:
            fail(f"{k['name']} was never launched on its path")
    for name in ("tree_attention", "compact_rows"):
        if bf16_launches[name] == 0 or static_launches[name] == 0 or hd64_launches[name] == 0:
            fail(f"{name} was never launched on the bf16, static-tree or hd64 path")
        if any(counts[name] == 0 for counts in sampled.values()):
            fail(f"{name} was never launched on a sampled path")
    idle = [k for k in ENGINE_KERNELS if sampled["int4"][k] == 0]
    if idle:
        fail(f"the sampled int4 path never launched {idle}")
    for kind, paths in (("batched", batched), ("served", served)):
        idle = [k for k in ENGINE_KERNELS if k != "compact_rows" and paths["int4"][k] == 0]
        if idle or paths["bf16"]["tree_attention"] == 0:
            fail(f"the {kind} paths never launched {idle or ['tree_attention']}")
    log(f"[smoke] seconds a phase (host clock): {json.dumps(phase_s)}")
    log(f"[smoke] whole run, kernels' build included: {time.time() - started:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
