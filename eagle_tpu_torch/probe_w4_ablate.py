"""Ablate the w4a8 kernel's cost on the card: unpack vs group dots vs storage
format vs scale accumulation (kernel B6, ops/w4_ablate.py).

    python -m eagle_tpu_torch.probe_w4_ablate [r4|m512|r4b|all] [--m 32]

Port of tools/probe_w4_ablate.py. Each run streams 24 banks of packed
[4096, 4096] int4 weights (192 MiB, above the card's 50 MB L2, so every
matmul reads its weights from device memory) through one variant, as a
chain of launches on one stream that cycles the banks. The chain is timed
with CUDA events at two lengths and the slope is taken, which cancels the
cost of starting and ending a chain. A run whose chain took the host about
as long to enqueue as the card to run is marked HOST-BOUND: its time is the
wrapper's, not the kernel's. One `[ablate]` line per run gives the
time of one matmul, the rate of packed bytes (K * N / 2 per matmul) and its
share of the H100's 3.35 TB/s. Variants compute wrong math on purpose; only
time matters here (ops/w4_ablate.ablate_ref says what each computes, and
chip_smoke.py holds each against it).

Sweeps (the lists of the JAX probe, same names):
  (default)  full, i32_storage, no_unpack at block_n 256 and 1024
  r4         i32_storage, fused_unpack, batched_dot at large block_n
  m512       the batched-verify regime (M = 512 unless --m says otherwise):
             fused_unpack, bf16_dots, one_dot_bf16, one_dot
  r4b        no_unpack against fused_unpack at block_n 1024 .. 2048 and
             groups of 128, 256, 512
  all        every mode once at block_n 256, and `full` at group 1024
             (`dots8` of the JAX probe's docstring)

Differences from the JAX probe: `block_n` is the number of columns one
thread block owns; its `parallel=True` has no counterpart (CUDA blocks are
independent), so r4b's last run is left out; ABLATE_M is the argument --m.
Needs the card: it raises without CUDA.
"""

from __future__ import annotations

import argparse
import subprocess
import time

import torch

from .ops.w4_ablate import I32_MODES, ablate

S, K, N = 24, 4096, 4096        # weight banks, contraction and output widths
GROUP = 128
CHAIN = (2, 6)                  # the two chain lengths, in cycles of the S banks
PEAK_BW = 3.35e12               # H100 SXM HBM3 (NVIDIA data sheet)

SWEEPS = {
    "default": [(mode, GROUP, bn) for mode in ("full", "i32_storage", "no_unpack")
                for bn in (256, 1024)],
    "r4": [("i32_storage", GROUP, 1024), ("fused_unpack", GROUP, 1024),
           ("fused_unpack", GROUP, 2048), ("batched_dot", GROUP, 1024),
           ("batched_dot", GROUP, 512)],
    "m512": [("fused_unpack", GROUP, 2048), ("bf16_dots", GROUP, 1024),
             ("one_dot_bf16", GROUP, 1024), ("one_dot", GROUP, 2048)],
    "r4b": [("no_unpack", GROUP, 1024), ("no_unpack", GROUP, 2048),
            ("fused_unpack", GROUP, 2048), ("fused_unpack", 256, 2048),
            ("fused_unpack", 512, 2048), ("fused_unpack", GROUP, 1536)],
    "all": [(mode, GROUP, 256) for mode in
            ("full", "bf16_dots", "no_unpack", "no_dots", "one_dot", "one_dot_bf16",
             "i32_storage", "fused_unpack", "batched_dot")] + [("full", 1024, 256)],
}


def make_inputs(mode: str, group: int, m: int, device, seed: int = 0):
    """The probe's operands on `device`: int8 rows, 8 x their group sums, S
    banks of packed weights and of 1e-3 scales, from a seeded generator."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    G = K // group
    if mode in I32_MODES:
        bank_p = torch.randint(-2**31, 2**31 - 1, (S, K // 8, N), dtype=torch.int32,
                               generator=gen, device=device)
    else:
        bank_p = torch.randint(0, 255, (S, K // 2, N), dtype=torch.uint8,
                               generator=gen, device=device)
    bank_s = torch.full((S, G, N), 1e-3, dtype=torch.float32, device=device)
    xq = torch.randint(-127, 127, (m, K), dtype=torch.int8, generator=gen,
                       device=device)
    rs = 8 * xq.reshape(m, G, group).sum(dim=2, dtype=torch.int32)
    return xq, rs.contiguous(), bank_p, bank_s


def run_mode(mode: str, group: int = GROUP, block_n: int = 256, m: int = 32,
             device="cuda") -> dict:
    """Time one variant and print its `[ablate]` line; returns the numbers."""
    if not torch.cuda.is_available():
        raise RuntimeError("probe_w4_ablate times CUDA kernels: it needs the card")
    xq, rs, bank_p, bank_s = make_inputs(mode, group, m, device)

    def t(cycles: int) -> tuple[float, float]:
        """Best of 3: device ms of a chain of cycles * S launches (CUDA
        events), and the host ms it took to enqueue that chain."""
        best = (float("inf"), 0.0)
        for _ in range(3):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            t0 = time.perf_counter()
            for i in range(cycles * S):
                ablate(mode, xq, rs, bank_p[i % S], bank_s[i % S], group, block_n)
            host = (time.perf_counter() - t0) * 1e3
            b.record()
            b.synchronize()
            best = min(best, (a.elapsed_time(b), host))
        return best

    t(1)                                        # build and warm up
    lo, hi = CHAIN
    (t_lo, _), (t_hi, host_hi) = t(lo), t(hi)
    per = (t_hi - t_lo) * 1e-3 / ((hi - lo) * S)
    bw = K * N * 0.5 / per
    # a chain the host enqueues no faster than the card runs it times the host
    host_bound = host_hi > 0.8 * t_hi
    print(f"[ablate] {mode:12s} group={group:5d} {per * 1e6:8.1f} us/mm | "
          f"{bw / 1e9:6.0f} GB/s real ({bw / PEAK_BW * 100:5.1f}% of 3.35 TB/s) "
          f"bn={block_n} M={m}" + (" HOST-BOUND" if host_bound else ""), flush=True)
    return {"mode": mode, "group": group, "block_n": block_n, "m": m,
            "us_per_matmul": per * 1e6, "gb_per_s": bw / 1e9,
            "share_of_peak": bw / PEAK_BW, "host_bound": host_bound}


def run_sweep(name: str = "default", m: int | None = None,
              device="cuda") -> list[dict]:
    if name not in SWEEPS:
        raise ValueError(f"unknown sweep {name!r} (expected one of {sorted(SWEEPS)})")
    if m is None:
        m = 512 if name == "m512" else 32
    print(f"[ablate] S={S} K={K} N={N} M={m}", flush=True)
    return [run_mode(mode, group, bn, m, device)
            for mode, group, bn in SWEEPS[name]]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("sweep", nargs="?", default="default", choices=sorted(SWEEPS))
    ap.add_argument("--m", type=int, default=None,
                    help="rows of activations (default 32; 512 for the m512 sweep)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("probe_w4_ablate times CUDA kernels: it needs the card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip() if smi.returncode == 0 else "nvidia-smi failed", flush=True)
    run_sweep(args.sweep, args.m)


if __name__ == "__main__":
    main()
