"""Ablation variants of the w4a8 matmul body (kernel B6), with their plain
PyTorch versions.

`ablate(mode, ...)` (csrc/w4_ablate.cu) replaces the Pallas kernel
tools/probe_w4_ablate.py:make_kernel: the `__dp4a` w4a8 body (csrc/w4_dot.cuh,
the first body; B3/B4 and B5 now run on tensor cores) taken apart into nine
variants that stream the same packed bytes and differ in the work they do
on them, so that timing them tells the cost of the nibble unpack, of the
per-group dots, of the storage format and of the f32 scale accumulation
apart. Some variants compute "wrong math" on purpose; each is still a
well-defined function of its inputs, and `ablate_ref(mode, ...)` is its plain
version.

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
  bf16_dots           the same sum, dots as float multiply-adds (exact)
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

import torch

from . import _launch

MODES = _launch.ABLATE_MODES          # the order of csrc/w4_ablate.cu's enum
I32_MODES = ("i32_storage", "fused_unpack", "batched_dot")
_FLOAT_DOT_MODES = ("bf16_dots", "one_dot_bf16")
_MT, _COLS = 16, 64                   # rows and columns of one block pass
_MAX_SMEM = 227 * 1024


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


# mode | xq, rs, p, scale, out | M, K, N, G, block_n | stream
_ARGS = ([ctypes.c_int] + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
         + [ctypes.c_void_p])


def ablate(mode: str, xq: torch.Tensor, rs: torch.Tensor, p: torch.Tensor,
           s: torch.Tensor, group: int, block_n: int = 256) -> torch.Tensor:
    """One variant of the w4a8 body: f32 [M, N]. `block_n` is the number of
    columns one thread block owns (a multiple of 64; the probe's values are
    256, 512, 1024, 1536 and 2048). CUDA tensors run csrc/w4_ablate.cu; CPU
    tensors run `ablate_ref`."""
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
    if block_n <= 0 or block_n % _COLS:
        raise ValueError(f"{name}: block_n={block_n} must be a multiple of {_COLS}")
    # float dots stay exact while every partial sum is below 2**24
    span = K // 2 if mode == "one_dot_bf16" else group
    if mode in _FLOAT_DOT_MODES and span * 127 * 15 >= 2 ** 24:
        raise ValueError(f"{name}: a dot over {span} rows is not exact in float32")
    if mode == "batched_dot" and 4 * G * _MT * _COLS > _MAX_SMEM:
        raise ValueError(f"{name}: {G} groups of staged dots do not fit shared memory")
    out = torch.empty((M, N), dtype=torch.float32, device=xq.device)
    fn = _launch.entry_point("w4_ablate", _ARGS)
    err = fn(MODES.index(mode), xq.data_ptr(), rs.data_ptr(), p.data_ptr(),
             s.data_ptr(), out.data_ptr(), M, K, N, G, block_n, _launch.stream())
    _launch.check_launch(name, err)
    _launch.LAUNCHES[name] += 1
    return out
