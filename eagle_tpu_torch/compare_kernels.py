"""Kernel-alone times of B1, B2, B3, B4 and B5 on one NVIDIA GPU, to compare
two trees of this repository on one card.

    python -m eagle_tpu_torch.compare_kernels [--trees DIR [DIR ...]]

Without --trees it times the kernels of the package it runs from and prints
one JSON line. With --trees it runs itself once per tree, in the order given,
each time in a process of its own that imports that tree's package, and
prints one JSON line per run: `--trees OLD . . OLD` takes two versions in
turns on one card.

Shapes are the main path's: B1 bf16, T = 61 queries (and the static
tree's 26) of 32 q / 8 kv heads against a 2176-row cache at start 1024,
head_dim 128 and 64 (and, where the tree takes it, 96 and 256); B2
[32,1,8,2176,128] bf16, P = 7 (the
overlapping path [0,3,7,7,7,7,7], and the identity path, which moves no row
in this tree), beside the harness's floor (one launch of a one-element
`zero_`); B3 lm_head
[M,4096]x[4096,128256] and B4 gate/up [M,4096]x[4096,14336] (layer 31 of
32) at M = 1 and 61, on rows already quantized; B5 w4 [M,4096]x[4096,32000],
k = 10, bf16 rows, at M = 1 and 10 and (k = 16) 32: the wrapper (row
quantization included) and, where the tree has `score_topk.w4_score_kernel`,
the kernel alone; where the tree takes more than 32 rows and k > 16
(`score_topk.SMALL_K`), also M = 64 at k = 32 and M = 10 at k = 128, beside
the drafter's unfused chain (qdense4, cast, log_softmax, topk_rows).
Weights are random words (their values do not change the work). Times are
taken by `device_time_ms`, which chip_smoke.py uses too: median of 30 single
calls, CUDA events, each after a 128 MiB write that evicts L2 and a ~1 ms
device spin.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np
import torch

HOST_LEAD_CYCLES = 2_000_000     # ~1 ms of device spin ahead of each timed call


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


def time_kernels() -> dict:
    from eagle_tpu_torch.ops import _build
    from eagle_tpu_torch.ops import attn_kernels as ak
    from eagle_tpu_torch.ops import quant4 as tq4
    from eagle_tpu_torch.ops import score_topk as stk

    dev = torch.device("cuda")
    _build.build()
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    flush = torch.empty(128 * 2**20, dtype=torch.uint8, device=dev)
    out = {"tree": os.path.dirname(os.path.dirname(os.path.abspath(_build.__file__))),
           "device": torch.cuda.get_device_name(0)}

    def time_ms(fn):
        return device_time_ms(fn, flush=flush)

    def words(*shape):
        return torch.randint(-2**31, 2**31 - 1, shape, dtype=torch.int32, generator=gen,
                             device=dev)

    def scales(*shape):
        return torch.rand(shape, generator=gen, device=dev) * 1e-3 + 5e-4

    def rows(M, K):
        return torch.randn((M, K), generator=gen, device=dev).to(torch.bfloat16)

    # B1: random ancestor masks
    from eagle_tpu_torch.ops.tree import ancestor_mask
    rng = np.random.default_rng(0)
    st = torch.tensor([1024], dtype=torch.int32, device=dev)
    widths = [(61, 128), (26, 128), (61, 64)]
    if hasattr(ak, "TREE_MAX_HEAD_DIM"):
        widths += [(61, 96), (61, 256)]
    for T, hd in widths:
        parents = torch.tensor([0] + [int(rng.integers(0, i)) for i in range(1, T)],
                               device=dev)
        a = [rows(T * 32, hd).reshape(T, 32, hd), rows(8 * 2176, hd).reshape(8, 2176, hd),
             rows(8 * 2176, hd).reshape(8, 2176, hd), rows(T * 8, hd).reshape(T, 8, hd),
             rows(T * 8, hd).reshape(T, 8, hd), ancestor_mask(parents, T).contiguous()]
        out[f"B1 T={T} d={hd}"] = time_ms(lambda: ak.tree_attention(*a, st))

    # B2
    shape = (32, 1, 8, 2176, 128)
    k = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
    v = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
    path = torch.tensor([0, 3, 7, 7, 7, 7, 7], dtype=torch.int32, device=dev)
    st = torch.tensor([1000], dtype=torch.int32, device=dev)
    out["B2 compact_rows"] = time_ms(lambda: ak.compact_rows(k, v, path, st))
    ident = torch.arange(7, dtype=torch.int32, device=dev)
    out["B2 compact_rows, identity path"] = time_ms(
        lambda: ak.compact_rows(k, v, ident, st))
    del k, v
    # the harness's floor: one launch of a one-element elementwise kernel
    one = torch.zeros(1, device=dev)
    out["launch floor (one-element zero_)"] = time_ms(one.zero_)

    # B3 (lm_head) and B4 (stacked gate/up, last layer), kernel alone
    K = 4096
    lm = (words(K // 8, 128256), scales(K // 128, 128256))
    stacked = (words(32, K // 8, 14336), scales(32, K // 128, 14336))
    for M in (1, 61):
        xq, _, rs = tq4.quantize_for_w4(rows(M, K), K // 128)
        out[f"B3 lm_head M={M}"] = time_ms(
            lambda: tq4.w4_kernel("qdense4", xq, rs, *lm, 1, None))
        out[f"B4 gate/up M={M}"] = time_ms(
            lambda: tq4.w4_kernel("qdense4_stacked", xq, rs, *stacked, 1, 31))
    del lm, stacked

    # B5, w4 head
    qw = {"q4": words(K // 8, 32000), "scale": scales(K // 128, 32000)}
    cases = [(1, 10), (10, 10), (32, 16)]
    if hasattr(stk, "SMALL_K"):
        cases += [(64, 32), (10, 128)]
    for M, k in cases:
        h = rows(M, K)
        tag = f"M={M}" + ("" if k == 10 else f" k={k}")
        out[f"B5 wrapper {tag}"] = time_ms(lambda: stk.score_topk_quant(h, qw, k))
        if hasattr(stk, "w4_score_kernel"):
            xq, sx, rs = tq4.quantize_for_w4(h, K // 128)
            out[f"B5 kernel {tag}"] = time_ms(
                lambda: stk.w4_score_kernel(xq, sx, rs, qw["q4"], qw["scale"], k, 1))
        if M * k > 160:
            out[f"B5 unfused chain {tag}"] = time_ms(lambda: stk.topk_rows(
                torch.log_softmax(tq4.qdense4(h, qw).to(torch.float32), dim=-1), k))
    return out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--trees", nargs="+", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("compare_kernels: needs a CUDA device")
    if args.trees is None:
        print(json.dumps(time_kernels()), flush=True)
        return
    me = os.path.abspath(__file__)
    code = ("import runpy, sys; sys.path.insert(0, sys.argv[1]); sys.argv = sys.argv[:1]; "
            f"runpy.run_path({me!r}, run_name='__main__')")
    for tree in args.trees:
        tree = os.path.abspath(tree)
        proc = subprocess.run([sys.executable, "-c", code, tree], cwd=tree,
                              capture_output=True, text=True)
        if proc.returncode != 0:
            sys.exit(f"compare_kernels: the run on {tree} failed:\n{proc.stderr[-4000:]}")
        print(proc.stdout.strip().splitlines()[-1], flush=True)


if __name__ == "__main__":
    main()
