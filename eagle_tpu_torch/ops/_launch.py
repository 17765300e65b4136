"""What every CUDA kernel wrapper of the port shares: the launch counts, the
ctypes binding of a `*_launch` entry point, and the checks around a launch.

`LAUNCHES` holds one plain integer per wrapper. A wrapper adds one where it
launches its kernel and nowhere else, so a run can show that a path went
through the kernels.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

# the probe's wrapper (ops/w4_ablate.ablate) counts each of its modes apart
ABLATE_MODES = ("full", "bf16_dots", "no_unpack", "no_dots", "one_dot",
                "one_dot_bf16", "i32_storage", "fused_unpack", "batched_dot")
LAUNCHES = {"tree_attention": 0, "compact_rows": 0, "qdense4": 0,
            "qdense4_stacked": 0, "score_topk_quant": 0,
            **{f"w4_ablate.{mode}": 0 for mode in ABLATE_MODES}}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def entry_point(source: str, argtypes, fn_name: str | None = None):
    """The C entry point `fn_name` (default `<source>_launch`) of
    csrc/<source>.cu, built and loaded on first use."""
    lib = _build.load(source)
    fn = getattr(lib, fn_name or source + "_launch")
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def check_launch(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")


def require_cuda(name: str, t: torch.Tensor) -> None:
    """Tensors off the CPU go to the kernel: they must be CUDA tensors."""
    if not t.is_cuda:
        raise ValueError(f"{name}: the CUDA kernel needs CUDA tensors, got "
                         f"{t.device} (CPU tensors take the plain version)")


def stream() -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
