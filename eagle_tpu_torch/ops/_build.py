"""Build the CUDA sources under `eagle_tpu_torch/csrc/` and load them.

Each `csrc/<name>.cu` exposes a plain C interface and is compiled by `nvcc`
into its own shared library for `sm_90a`, loaded with `ctypes`. Libraries go
to `eagle_tpu_torch/_build/` (git-ignored), named by a hash of the source,
the shared headers (`csrc/*.cuh`) and the flags, so an edited source is
rebuilt and an unchanged one is reused. `build()` starts one `nvcc` per
missing library, all at once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
SOURCES = ("tree_attention", "compact_rows", "w4_matmul", "score_topk",
           "w4_ablate")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# the w4a8 sources promise one rounded multiply and one rounded add per scale
# group, so nvcc must not contract them into fused multiply-adds
EXTRA_FLAGS = {"w4_matmul": ("-fmad=false",), "score_topk": ("-fmad=false",),
               "w4_ablate": ("-fmad=false",)}

_LIBS: dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()
BUILD_LOG: dict[str, str] = {}   # nvcc output per source (-Xptxas -v report)


NVCC_DEFAULT = "/usr/local/cuda/bin/nvcc"


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ((os.path.join(home, "bin", "nvcc") if home else None),
                 shutil.which("nvcc"), NVCC_DEFAULT):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built with the "
                       "CUDA toolkit (set CUDA_HOME or put nvcc on PATH)")


def _flags(name: str) -> tuple[str, ...]:
    return NVCC_FLAGS + EXTRA_FLAGS.get(name, ())


def _lib_path(name: str) -> tuple[str, str]:
    src = os.path.join(CSRC_DIR, name + ".cu")
    h = hashlib.sha1(" ".join(_flags(name)).encode())
    headers = sorted(n for n in os.listdir(CSRC_DIR) if n.endswith(".cuh"))
    for path in [src] + [os.path.join(CSRC_DIR, n) for n in headers]:
        with open(path, "rb") as f:
            h.update(f.read())
    return src, os.path.join(BUILD_DIR, f"lib{name}_{h.hexdigest()[:12]}.so")


def build(names=SOURCES) -> None:
    """Compile every missing library of `names`, one nvcc process each, in
    parallel. Raises with the compiler's output if any build fails."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = []
    for name in names:
        src, so = _lib_path(name)
        if os.path.exists(so):
            continue
        tmp = f"{so}.{os.getpid()}.tmp"
        cmd = [nvcc_path(), *_flags(name), "-o", tmp, src]
        procs.append((name, so, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for name, so, tmp, proc in procs:
        out, _ = proc.communicate()
        BUILD_LOG[name] = out
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name}.cu:\n{out}")
        else:
            os.replace(tmp, so)
    if failed:
        raise RuntimeError("\n".join(failed))


def load(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, building it on first use."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(_lib_path(name)[1])
            _LIBS[name] = lib
        return lib
