"""Where the time of the main path goes, on one NVIDIA GPU.

    python -m eagle_tpu_torch.profile_main_path [--path bf16|int4|static|kv8|hd64 ...]
        [--temperature T] [--out DIR]

Builds a full-width engine (eagle_tpu_torch/full_width.py: the bf16 path;
`int4`, the int4 serving path: w4a8 target, int4 draft, fused draft scoring;
`static`, the 26-node static tree with kv_buckets; `kv8`, the int8 target KV
cache; `hd64`, the bf16 path at the Llama-3.2-1B-class shape, head_dim 64),
prefills a prompt of CONTEXT = 1000 tokens, then, for each path
given (several paths run in turn in one process, the bf16, static and kv8
engines over one set of weights, so that `--path bf16 static static bf16`
compares two of them on one card under one host):
  - times vanilla decode steps and speculative rounds on the host clock, each
    ending in torch.cuda.synchronize();
  - profiles ROUNDS = 12 speculative rounds with torch.profiler (CPU + CUDA):
    device busy time per round, the device's idle share (in the profiled
    window, and against the unprofiled round time, since the profiler slows
    the host), kernel launches per round, the four round steps
    (round.verify / accept / commit / draft spans, host and device ms) and
    the kernels by device time.
With --temperature T > 0 each path runs sampled rounds instead, on a sibling
engine at temperature T with top_p 0.9 and the path's sampled acceptance
(SAMPLED_ACCEPTANCE: the static tree's sampled candidates and the int4
path's two-pass dynamic drafting take the true-q rule, the other dynamic
trees the q(x) = 1 rule), so the profile shows what sampling adds to a round.
Writes the profiler tables to DIR/profile_main_path[_PATH].txt (default
profile_out/) and prints one JSON line of results per path. Needs CUDA.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from . import full_width
from .ops import attn_kernels as ak

ROUNDS = 12
CONTEXT = 1000
PATHS = ("bf16", "int4", "static", "kv8", "hd64")
# the acceptance a path's sampled rounds run under --temperature
SAMPLED_ACCEPTANCE = {"bf16": "true_q", "int4": "true_q_dynamic", "static": "true_q",
                      "kv8": "true_q", "hd64": "true_q"}
SAMPLED_TOP_P = 0.9


def _dev_total(evt) -> float:
    return getattr(evt, "device_time_total", None) or getattr(evt, "cuda_time_total", 0.0)


def _dev_self(evt) -> float:
    return (getattr(evt, "self_device_time_total", None)
            or getattr(evt, "self_cuda_time_total", 0.0))


def profile_path(path: str, eng, card: str, out_dir: str) -> dict:
    """Time and profile ROUNDS rounds of `eng`; writes the profiler tables and
    returns the results."""
    # a bucketed engine runs each round against the bucket of its length; the
    # CONTEXT and the few rounds here stay inside one bucket
    kv_limit = eng._kv_limit(CONTEXT + (ROUNDS + 3) * eng.path_len)
    rng = np.random.default_rng(0)
    prompt = rng.integers(0, eng.cfg.vocab_size, CONTEXT)

    # host-clock step times (each ends in a sync)
    _, _, state = eng._start(prompt, None)
    with torch.no_grad():
        for _ in range(3):
            state, _ = eng._round(state, kv_limit=kv_limit)
        torch.cuda.synchronize()
        round_ms = []
        for _ in range(ROUNDS):
            t0 = time.perf_counter()
            state, _ = eng._round(state, kv_limit=kv_limit)
            torch.cuda.synchronize()
            round_ms.append((time.perf_counter() - t0) * 1e3)
        cache = state.cache
        token = state.tree.tokens[0]
        step_ms = []
        for i in range(ROUNDS + 3):
            t0 = time.perf_counter()
            cache, token = eng._vanilla_step(cache, token, None, state.temperature,
                                             state.gen)
            torch.cuda.synchronize()
            if i >= 3:
                step_ms.append((time.perf_counter() - t0) * 1e3)

        # profiled window of speculative rounds
        _, _, state = eng._start(prompt, None)
        for _ in range(3):
            state, _ = eng._round(state, kv_limit=kv_limit)
        torch.cuda.synchronize()
        ak.reset_launch_counts()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(ROUNDS):
                state, _ = eng._round(state, kv_limit=kv_limit)
            torch.cuda.synchronize()
            window_ms = (time.perf_counter() - t0) * 1e3

    avgs = prof.key_averages()
    n = ROUNDS
    # device-side entries: kernels and copies; the round.* spans also show
    # up there as GPU annotations and are kept apart
    kernels = [e for e in avgs if e.device_type == DeviceType.CUDA
               and not e.key.startswith("round.")]
    busy_ms = sum(_dev_self(e) for e in kernels) / 1e3
    spans = {}
    for e in avgs:
        if e.key.startswith("round."):
            s = spans.setdefault(e.key, {"host_ms_per_round": 0.0,
                                         "device_ms_per_round": 0.0})
            if e.device_type == DeviceType.CUDA:
                s["device_ms_per_round"] += _dev_total(e) / 1e3 / n
            else:
                s["host_ms_per_round"] += e.cpu_time_total / 1e3 / n
    # every launch API: cudaLaunchKernelExC is how a cluster launch (B3/B4's
    # split) shows up
    launches = [e for e in avgs if e.key.startswith(("cudaLaunchKernel", "cuLaunchKernel"))]
    top = sorted(kernels, key=_dev_self, reverse=True)[:14]
    round_med = float(np.median(round_ms))
    result = {
        "card": card, "path": path, "context": CONTEXT,
        "temperature": eng.ecfg.temperature, "acceptance": eng.ecfg.acceptance,
        "rounds": n, "tree_nodes": eng.ecfg.tree_size, "kv_limit": kv_limit,
        "round_ms_median": round_med,
        "vanilla_step_ms_median": float(np.median(step_ms)),
        "profiled_window_ms_per_round": window_ms / n,
        "device_busy_ms_per_round": busy_ms / n,
        "device_idle_share_profiled_window": 1.0 - busy_ms / window_ms,
        "device_idle_share_unprofiled_round": 1.0 - busy_ms / n / round_med,
        "kernel_launches_per_round": sum(e.count for e in launches) / n,
        "spans": spans,
        "top_kernels_ms_per_round": {e.key[:80]: _dev_self(e) / 1e3 / n
                                     for e in top},
        "launches_per_round": {k: v / n for k, v in ak.LAUNCHES.items() if v},
    }
    os.makedirs(out_dir, exist_ok=True)
    suffix = ("" if path == "bf16" else "_" + path) + (
        f"_t{eng.ecfg.temperature:g}" if eng.sampled else "")
    with open(os.path.join(out_dir, f"profile_main_path{suffix}.txt"), "w") as f:
        f.write(avgs.table(sort_by="self_device_time_total", row_limit=60))
        f.write("\n\n")
        f.write(avgs.table(sort_by="self_cpu_time_total", row_limit=40))
    return result


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="profile_out")
    ap.add_argument("--path", choices=PATHS, nargs="+", default=["bf16"])
    ap.add_argument("--temperature", type=float, default=0.0)
    args = ap.parse_args()
    paths = args.path
    if not torch.cuda.is_available():
        raise SystemExit("needs CUDA")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    engines: dict = {}
    siblings = {"static": full_width.engine_static, "kv8": full_width.engine_kv8}
    own = {"int4": full_width.engine_int4, "hd64": full_width.engine_hd64}
    for path in paths:
        if path not in engines and path in own:
            engines[path] = own[path](dev)
        elif path not in engines:
            # static and kv8 are siblings of the bf16 engine: one set of weights
            base = engines["bf16"] = engines.get("bf16") or full_width.engine(dev)
            if path in siblings:
                engines[path] = siblings[path](dev, base=base)
        eng = engines[path]
        if args.temperature > 0:
            eng = eng._sibling(temperature=args.temperature, top_p=SAMPLED_TOP_P,
                               acceptance=SAMPLED_ACCEPTANCE[path])
        print(json.dumps(profile_path(path, eng, smi.stdout.strip(), args.out)), flush=True)


if __name__ == "__main__":
    main()
