"""PyTorch/CUDA port of eagle_tpu: EAGLE speculative decoding on one NVIDIA H100.

Plain tensor code is PyTorch; the five TPU kernels on the greedy main path
and the int4 serving path (tree-verify attention, accepted-branch KV
compaction, the w4a8 matmul with and without in-launch layer selection, and
the fused draft score + top-k) are hand-written CUDA C++ under `csrc/`,
built at first use (`ops/_build.py`). Entry points run on "cuda" unless the
caller passes `device="cpu"`, where every kernel wrapper takes its plain
PyTorch version.
"""

import torch


def resolve_device(device=None) -> torch.device:
    """"cuda" by default; raises when CUDA is missing and the CPU was not asked
    for explicitly."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "PyTorch versions on the CPU")
    return dev
