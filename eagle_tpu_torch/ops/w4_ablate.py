"""Ablation variants of the w4a8 matmul body (kernel B6), with their plain
PyTorch versions.

`ablate(mode, ...)` (csrc/w4_ablate.cu) replaces the Pallas kernel
tools/probe_w4_ablate.py:make_kernel: the main loop that B3, B4 and B5 run
(csrc/w4_mma.cuh: int8 tensor cores, a cp.async ring, the f32 chain after
each group) with one part swapped or taken away in each of nine variants,
so that timing them tells what the storage format, the nibble unpack, the
integer dots, the second pass over the words and the f32 scale chain cost
that loop. `ablate_plan` gives a launch its tile and grid. Some variants
compute "wrong math" on purpose; each is still a well-defined function of
its inputs, and `ablate_ref(mode, ...)` is its plain version.

Inputs: xq int8 [M, K]; rs int32 [M, G] (the probe passes 8 x the group row
sums); s f32 [G, N]; p either uint8 [K/2, N] (byte r = K-row r in its low
nibble, K-row K/2 + r in its high nibble) or, for `I32_MODES`, int32
[K/8, N] (byte b of word w is byte row 4w + b: the word layout of
ops/quant4.pack_w4). The result is f32 [M, N], not rescaled per row.

With hg = G / 2 and term(g) = float(dot_g - rs[:, g]) * s[g] (dot_g the exact
integer dot of group g's activations with its plane rows: low-half planes
for g < hg, high-half for g >= hg), one rounded multiply and one rounded add
per term:

  full, i32_storage   acc += term(g), g = 0 .. G-1 in order
  bf16_dots           the same sum, dots as bf16 products with f32 sums (exact)
  no_unpack           the same loop on the raw bytes read as int8, both halves
  no_dots             every row = f32 column sum of the low nibbles + that of
                      the high nibbles
  one_dot, one_dot_bf16   per half one dot of xq[:, :K/2] over all K/2 rows,
                      times s[0]
  fused_unpack        terms added in the order 0, hg, 1, hg + 1, ..
  batched_dot         all G dots first, then one f32 reduction in the order
                      g = 0 .. G-1 (the JAX probe leaves that order to XLA;
                      the port fixes it, so the result equals i32_storage's)

The kernels keep these orders, so each is bit-identical to `ablate_ref`.
`dots8` of the JAX probe's docstring is `full` with group = 1024.

A CUDA tensor goes to the kernel or the wrapper raises; only a CPU tensor
takes the plain version.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from . import _launch
from .quant4 import W4_BM, W4_SMEM_MAX, W4_STAGES, W4_STAGE_ROWS, w4_plan

MODES = _launch.ABLATE_MODES          # the order of csrc/w4_ablate.cu's enum
I32_MODES = ("i32_storage", "fused_unpack", "batched_dot")
_FLOAT_DOT_MODES = ("bf16_dots", "one_dot_bf16")


def _planes(mode: str, p: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Low and high planes [K/2, N] as float64 integers."""
    if mode in I32_MODES:
        by = p.contiguous().view(torch.uint8).reshape(p.shape[0], p.shape[1], 4)
        by = by.transpose(1, 2).reshape(4 * p.shape[0], p.shape[1])
    else:
        by = p
    if mode == "no_unpack":
        raw = by.view(torch.int8).to(torch.float64)
        return raw, raw
    return (by & 0xF).to(torch.float64), (by >> 4).to(torch.float64)


def ablate_ref(mode: str, xq: torch.Tensor, rs: torch.Tensor, p: torch.Tensor,
               s: torch.Tensor, group: int) -> torch.Tensor:
    """Plain version of `ablate`. Integer dots are float64 matmuls (exact);
    the f32 sum follows the mode's order, one multiply and one add a term."""
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r} (expected one of {MODES})")
    M, K = xq.shape
    N = p.shape[1]
    hg = K // 2 // group
    G = 2 * hg
    lo, hi = _planes(mode, p)
    xd = xq.to(torch.float64)
    acc = torch.zeros((M, N), dtype=torch.float32, device=xq.device)
    if mode == "no_dots":
        acc = acc + lo.sum(dim=0).to(torch.float32)[None, :]
        return acc + hi.sum(dim=0).to(torch.float32)[None, :]
    if mode in ("one_dot", "one_dot_bf16"):
        for plane in (lo, hi):
            d = torch.matmul(xd[:, : K // 2], plane).to(torch.float32)
            acc = acc + d * s[0][None, :]
        return acc
    order = range(G)
    if mode == "fused_unpack":
        order = [g for pair in zip(range(hg), range(hg, G)) for g in pair]
    for g in order:
        plane = lo if g < hg else hi
        r0 = (g % hg) * group
        d = torch.matmul(xd[:, g * group:(g + 1) * group], plane[r0:r0 + group])
        corr = (d - rs[:, g:g + 1].to(torch.float64)).to(torch.float32)
        acc = acc + corr * s[g][None, :]
    return acc


class AblatePlan(NamedTuple):
    """How csrc/w4_ablate.cu runs one mode."""

    ntile: int            # columns of one column tile (B3's tile, 64 rows)
    vec: bool             # 16-byte copies
    grid: tuple           # (row tiles, column blocks of block_n columns)
    smem: int             # dynamic shared memory, bytes


def _ablate_smem(mode: str, ntile: int, G: int) -> int:
    """The ring of csrc/w4_mma.cuh under the mode's body (w4mma::Slot), and
    batched_dot's staged group dots behind it."""
    a_bytes = W4_BM * (4 * W4_STAGE_ROWS + 16)
    rs_bytes = W4_BM * 4 + ntile * 4
    if mode in I32_MODES:
        w_bytes = W4_STAGE_ROWS * (ntile + 8) * 4
    else:          # byte rows, an odd multiple of 16 B apart, + 16 B of shift
        w_bytes = 4 * W4_STAGE_ROWS * (48 if ntile <= 32 else ntile + 16) + 16
    sets = 2 if mode == "fused_unpack" else 1
    staged = G * W4_BM * ntile * 4 if mode == "batched_dot" else 0
    return W4_STAGES * (sets * (a_bytes + rs_bytes) + w_bytes) + staged


def ablate_plan(mode: str, M: int, K: int, N: int, G: int, block_n: int) -> AblatePlan:
    """The launch plan of a mode, from host-known shapes only: B3's column
    tile for the shapes (`w4_plan`, blocks = 1, without its cluster split),
    halved until it divides `block_n` and, for batched_dot, until the staged
    dots fit shared memory. A block owns `block_n` columns and walks them one
    tile at a time."""
    ntile = w4_plan(M, K, N, G, 1).ntile
    while block_n % ntile or (mode == "batched_dot" and ntile > 8
                              and _ablate_smem(mode, ntile, G) > W4_SMEM_MAX):
        ntile //= 2
    smem = _ablate_smem(mode, ntile, G)
    if smem > W4_SMEM_MAX:
        raise ValueError(f"w4_ablate.{mode}: {G} groups of staged dots do not fit "
                         f"shared memory ({smem} B)")
    group = K // G
    vec = K % 16 == 0 and group % 16 == 0 and (K // 2) % 16 == 0 and N % 4 == 0
    if mode not in I32_MODES:      # byte rows in 16-byte pieces
        vec = vec and N % 16 == 0 and ntile >= 16
    return AblatePlan(ntile, vec, (-(-M // W4_BM), -(-N // block_n)), smem)


# mode | xq, rs, p, scale, out | M, K, N, G, block_n | plan (ntile, vec, smem,
# row tiles, column blocks) | stream
_ARGS = ([ctypes.c_int] + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 10
         + [ctypes.c_void_p])


def ablate(mode: str, xq: torch.Tensor, rs: torch.Tensor, p: torch.Tensor,
           s: torch.Tensor, group: int, block_n: int = 256) -> torch.Tensor:
    """One variant of the w4a8 body: f32 [M, N]. `block_n` is the number of
    columns one thread block owns (a multiple of 8; the probe's sweeps use
    256 .. 2048, and `ablate_plan`'s tile makes `i32_storage` B3's launch).
    CUDA tensors run csrc/w4_ablate.cu; CPU tensors run `ablate_ref`."""
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r} (expected one of {MODES})")
    if xq.device.type == "cpu":
        return ablate_ref(mode, xq, rs, p, s, group)
    name = f"w4_ablate.{mode}"
    _launch.require_cuda(name, xq)
    M, K = xq.shape
    if K % 8 or group % 4 or group <= 0 or (K // 2) % group:
        raise ValueError(f"{name}: group={group} must be a multiple of 4 that "
                         f"divides K/2={K // 2}")
    G = K // group
    i32 = mode in I32_MODES
    want_rows, want_dtype = (K // 8, torch.int32) if i32 else (K // 2, torch.uint8)
    if p.ndim != 2 or p.shape[0] != want_rows or p.dtype != want_dtype:
        raise ValueError(f"{name}: weights must be {want_dtype} [{want_rows}, N], "
                         f"got {p.dtype} {tuple(p.shape)}")
    N = p.shape[1]
    if (xq.dtype != torch.int8 or rs.dtype != torch.int32 or s.dtype != torch.float32
            or rs.shape != (M, G) or s.shape != (G, N)):
        raise ValueError(f"{name}: need xq int8 [M, K], rs int32 [M, {G}] and s f32 "
                         f"[{G}, {N}], got {xq.dtype} {tuple(xq.shape)}, {rs.dtype} "
                         f"{tuple(rs.shape)}, {s.dtype} {tuple(s.shape)}")
    if any(t.device != xq.device for t in (rs, p, s)):
        raise ValueError(f"{name}: all tensors must be on one device")
    if not all(t.is_contiguous() for t in (xq, rs, p, s)):
        raise ValueError(f"{name}: inputs must be contiguous")
    if block_n <= 0 or block_n % 8:
        raise ValueError(f"{name}: block_n={block_n} must be a multiple of 8")
    if not i32 and N % 4:
        raise ValueError(f"{name}: byte-row weights need N % 4 == 0, got N={N}")
    # float dots stay exact while every partial sum is below 2**24
    span = K // 2 if mode == "one_dot_bf16" else group
    if mode in _FLOAT_DOT_MODES and span * 127 * 15 >= 2 ** 24:
        raise ValueError(f"{name}: a dot over {span} rows is not exact in float32")
    plan = ablate_plan(mode, M, K, N, G, block_n)
    out = torch.empty((M, N), dtype=torch.float32, device=xq.device)
    fn = _launch.entry_point("w4_ablate", _ARGS)
    err = fn(MODES.index(mode), xq.data_ptr(), rs.data_ptr(), p.data_ptr(),
             s.data_ptr(), out.data_ptr(), M, K, N, G, block_n, plan.ntile,
             int(plan.vec), plan.smem, *plan.grid, _launch.stream())
    _launch.check_launch(name, err)
    _launch.LAUNCHES[name] += 1
    return out
