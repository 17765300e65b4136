"""Weight-only int4 (w4a8) quantization with hand-written CUDA matmul kernels.

Port of eagle_tpu/ops/quant4.py (the straight-through `fake_quantize4_*`
functions belong to training and are not ported yet). The packed layout is
the JAX package's, bit for bit:

  pack_w4(w)   float [K, N] -> {"q4": int32 words [K/8, N],
                                "scale": f32 [K/group, N]}

Nibbles are stored biased by +8 (q in [-7, 7] -> 1..15) and half-split along
K: byte k of little-endian word j holds row 4j+k of the low half [0, K/2) in
its low nibble and row 4j+k of the high half [K/2, K) in its high nibble.
`blocks > 1` packs `blocks` contiguous K ranges, each half-split on its own:
q4 [blocks, K/(8 blocks), N], scale [blocks, K/(blocks group), N].

The matmul (activations quantized per row to int8 by ops/quant.quantize_rows):
per scale group an exact int32 dot of int8 activations and raw nibbles, minus
8 * rowsum (the folded zero point), times the group's f32 scale; the groups
are summed in f32 in K-ascending order, one rounded multiply and one rounded
add each. That order is the contract: a row's result does not depend on the
number of rows, so the tree-verify forward and the one-token vanilla step
give the same bits, which is what keeps an int4 target bit-exact against its
own vanilla decode.

- `qdense4` (kernel B3, csrc/w4_matmul.cu) replaces the Pallas kernel
  eagle_tpu/ops/quant4.py:_w4_kernel; `qdense4_stacked` (kernel B4, same
  source) replaces _w4_kernel_stacked: the layer is chosen inside the launch
  from stacked [L, K/8, N] words, never sliced into a copy. The kernel runs
  the integer dots on int8 tensor cores and the f32 chain after them;
  `w4_plan` picks its column tile and cluster split from the shapes.
- `qdense4_ref` / `qdense4_stacked_ref` are the plain PyTorch versions
  (a port of qdense4_xla), bit-identical to the kernels.

A wrapper takes its plain version only for CPU tensors; a CUDA tensor goes
to the kernel, or the wrapper raises. There is no FORCE_INTERPRET switch,
no pad of M to 32 and no custom_vmap / custom_partitioning wrapper here: a
batched caller flattens to [M, K] itself.
"""

from __future__ import annotations

import ctypes
import math
import warnings
from typing import NamedTuple, Optional

import torch

from . import _launch
from .quant import _DRAFT_QUANT_KEYS, _QUANT_KEYS, quantize_rows, true_div

GROUP = 128  # scale-group size along the contraction axis

_ROW_PARALLEL_KEYS = ("wo", "w_down")


def _eff_group(K: int, group: int) -> int:
    """Largest usable group <= `group`: it must divide K/2 so that no scale
    group straddles the low/high packing halves."""
    if K % 2:
        raise ValueError(f"int4 packing needs even K, got {K}")
    return math.gcd(K // 2, group)


def _blocks_of(q4: torch.Tensor) -> int:
    """2-D [K/8, N] is the single-block layout; 3-D [blocks, K/(8 blocks), N]
    the blocked one."""
    return 1 if q4.ndim == 2 else q4.shape[0]


def _k_of(qw: dict) -> int:
    q4 = qw["q4"]
    return 8 * q4.shape[-2] * _blocks_of(q4)


def _group_of(qw: dict) -> int:
    """Group size recovered from the shapes (scale is [K/group, N],
    block-split like q4)."""
    scale = qw["scale"]
    groups = scale.shape[-2] * (1 if scale.ndim == 2 else scale.shape[0])
    return _k_of(qw) // groups


def pack_w4(w: torch.Tensor, group: int = GROUP, blocks: int = 1) -> dict:
    """[.., K, N] float -> {"q4": int32 [.., K/8, N], "scale": f32 [.., K/group, N]}
    (blocks > 1: q4 [.., blocks, K/(8 blocks), N], scale [.., blocks, G/blocks, N]).

    One function for the JAX package's pack_w4 (2-D) and _pack_w4_host
    (leading layer axes); it runs on the device `w` is on and gives the same
    words and scales on the CPU and on the card."""
    K, N = w.shape[-2], w.shape[-1]
    if K % (8 * blocks):
        raise ValueError(f"int4 packing needs 8*blocks={8 * blocks} | K={K}")
    Kb = K // blocks
    if blocks > 1 and _eff_group(Kb, group) != _eff_group(K, group):
        warnings.warn(
            f"pack_w4: blocks={blocks} shrinks the effective scale group "
            f"({_eff_group(K, group)} -> {_eff_group(Kb, group)} at K={K}); "
            "outputs will differ from the blocks=1 packing", stacklevel=2)
    group = _eff_group(Kb, group)
    lead = tuple(w.shape[:-2])
    wg = w.to(torch.float32).reshape(*lead, K // group, group, N)
    amax = torch.amax(torch.abs(wg), dim=-2)                       # [.., G, N]
    scale = torch.clamp(true_div(amax, 7.0), min=1e-12)
    q = torch.clamp(torch.round(wg / scale.unsqueeze(-2)), -7, 7)
    nib = (q + 8.0).to(torch.uint8).reshape(*lead, blocks, Kb, N)  # 1..15
    by = nib[..., : Kb // 2, :] | (nib[..., Kb // 2:, :] << 4)     # [.., b, Kb/2, N]
    by = by.reshape(*lead, blocks, Kb // 8, 4, N)
    # four bytes -> one little-endian int32 word, reinterpreted bit for bit
    words = by.transpose(-1, -2).contiguous().view(torch.int32).squeeze(-1)
    if blocks == 1:
        return {"q4": words.reshape(*lead, K // 8, N), "scale": scale}
    return {"q4": words,
            "scale": scale.reshape(*lead, blocks, K // group // blocks, N)}


def _nibbles_korder(q4: torch.Tensor) -> torch.Tensor:
    """Packed words (2-D or blocked 3-D) -> biased nibbles [K, N] uint8 in K
    order (per block: low-half rows, then high-half rows)."""
    blocks = _blocks_of(q4)
    N = q4.shape[-1]
    p = q4.reshape(-1, N).contiguous()
    by = p.view(torch.uint8).reshape(p.shape[0], N, 4).transpose(1, 2)
    by = by.reshape(4 * p.shape[0], N)                             # [K/2, N]
    lo = (by & 0xF).reshape(blocks, -1, N)
    hi = (by >> 4).reshape(blocks, -1, N)
    return torch.cat([lo, hi], dim=1).reshape(-1, N)


def unpack_w4(qw: dict, dtype=torch.float32) -> torch.Tensor:
    """Dequantize back to [K, N] float (materializes the matrix)."""
    if qw["q4"].ndim not in (2, 3):
        raise ValueError(f"packed q4 must be 2-D or blocked 3-D, got "
                         f"{tuple(qw['q4'].shape)}")
    N = qw["q4"].shape[-1]
    q = _nibbles_korder(qw["q4"]).to(torch.int32) - 8
    scale = qw["scale"].reshape(-1, N)
    return (q.reshape(scale.shape[0], -1, N).to(torch.float32)
            * scale[:, None, :]).reshape(-1, N).to(dtype)


def _finish(y: torch.Tensor, x: torch.Tensor, b, out_dtype) -> torch.Tensor:
    y = y.to(out_dtype or x.dtype).reshape(*x.shape[:-1], y.shape[-1])
    if b is not None:
        y = y + b.to(y.dtype)
    return y


def _rowsums8(xq: torch.Tensor, G: int) -> torch.Tensor:
    """8 * per-group row sums of the int8 activations, int32 [M, G]."""
    M, K = xq.shape
    return 8 * xq.reshape(M, G, K // G).sum(dim=2, dtype=torch.int32)


def _acc_ref(xq: torch.Tensor, q4: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """int8 [M, K] x packed words -> f32 [M, N] before the activation scale:
    the arithmetic both matmul kernels and the fused scorer repeat.

    Each group's dot is an fp32 matmul of integer values: |dot| <= 15 * 127 *
    group < 2**24, so it is exact in any summation order, and int8 values and
    nibbles fit TF32's mantissa, so it does not depend on the TF32 switch."""
    M, K = xq.shape
    N = q4.shape[-1]
    scf = scale.reshape(-1, N).to(torch.float32)                   # [G, N] K order
    G = scf.shape[0]
    group = K // G
    nib = _nibbles_korder(q4)                                      # [K, N]
    rs = _rowsums8(xq, G).to(torch.float32)
    acc = torch.zeros((M, N), dtype=torch.float32, device=xq.device)
    for g in range(G):
        ks = slice(g * group, (g + 1) * group)
        dot = torch.matmul(xq[:, ks].to(torch.float32), nib[ks].to(torch.float32))
        term = (dot - rs[:, g:g + 1]) * scf[g][None, :]            # rounded multiply
        acc = acc + term                                           # rounded add
    return acc


def qdense4_ref(x: torch.Tensor, qw: dict, b: Optional[torch.Tensor] = None,
                out_dtype=None) -> torch.Tensor:
    """Plain version of `qdense4` (a port of qdense4_xla): an explicit loop
    over the scale groups in K order. Bit-identical to the kernel."""
    if qw["q4"].ndim not in (2, 3):
        raise ValueError(f"packed q4 must be 2-D or blocked 3-D, got "
                         f"{tuple(qw['q4'].shape)}")
    xq, sx = quantize_rows(x.reshape(-1, x.shape[-1]))
    return _finish(_acc_ref(xq, qw["q4"], qw["scale"]) * sx, x, b, out_dtype)


class Stacked4(NamedTuple):
    """A stacked int4 layer weight and the layer to use: `_dense` routes it
    to `qdense4_stacked`, which reads that layer in place."""

    q4: torch.Tensor      # [L, K/8, N] packed words
    scale: torch.Tensor   # [L, G, N]
    layer: int


def qdense4_stacked_ref(x: torch.Tensor, w: Stacked4,
                        b: Optional[torch.Tensor] = None,
                        out_dtype=None) -> torch.Tensor:
    """Plain version of `qdense4_stacked`: index the layer, then qdense4_ref."""
    layer = int(w.layer)
    return qdense4_ref(x, {"q4": w.q4[layer], "scale": w.scale[layer]}, b, out_dtype)


# ---------------------------------------------------------------------------
# kernels B3 / B4 (csrc/w4_matmul.cu)
# ---------------------------------------------------------------------------

# xq, rs, q4, scale, out | M, K, N, G, blocks | plan (ntile, split, vec, smem,
# row tiles, column tiles) | stream
_W4_ARGS = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 11 + [ctypes.c_void_p]
# xq, rs, q4, scale, out | M, K, N, G, L, layer | plan | stream
_W4_STACKED_ARGS = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 12 + [ctypes.c_void_p]

# the kernel's geometry (csrc/w4_matmul.cu checks every plan against its own):
# 64-row tiles, a ring of 4 stages of up to four k32 steps (32 word rows),
# 227 KB of shared memory a block
W4_BM, W4_STAGES, W4_STAGE_ROWS, W4_SMEM_MAX = 64, 4, 32, 232448
W4_NTILES = (128, 64, 32, 16, 8)     # columns per block, widest first
SM_COUNT = 132                  # H100 SXM: the blocks one wave needs


class W4Plan(NamedTuple):
    """How csrc/w4_matmul.cu runs one [M, K] x [K, N] product."""

    ntile: int            # columns per block (8, 16, 32, 64 or 128)
    split: bool           # the two halves on a cluster of two blocks (8 columns only)
    vec: bool             # 16-byte copies (aligned rows, groups, halves, columns)
    grid: tuple           # (row tiles, column tiles, 1 or 2)
    smem: int             # dynamic shared memory, bytes
    steps_per_group: int  # k32 steps of one scale group
    short_groups: bool    # group % 32 != 0: a step zero-fills A outside its group


def _w4_smem(ntile: int, hgb: int, split: bool) -> int:
    stage = (W4_BM * (4 * W4_STAGE_ROWS + 16) + W4_BM * 4 + ntile * 4   # rows, rs, scales
             + W4_STAGE_ROWS * (ntile + 8) * 4)                         # words
    return W4_STAGES * stage + (hgb * W4_BM * ntile * 4 if split else 0)   # + rank 1's terms


def w4_plan(M: int, K: int, N: int, G: int, blocks: int) -> W4Plan:
    """The launch plan of kernels B3/B4, from host-known shapes only: the
    widest column tile that still gives one block per SM (wider tiles read
    the int8 rows fewer times); where even 8 columns give fewer (N = 1024 at
    M <= 64), the two halves go to a cluster of two blocks. The high half
    always reads the words again (PERF.md: keeping them in shared memory
    measured slower at every shape)."""
    mt = -(-M // W4_BM)
    ntile = next((n for n in W4_NTILES if mt * -(-N // n) >= SM_COUNT), W4_NTILES[-1])
    hgb = G // blocks // 2
    split = (blocks == 1 and mt * -(-N // ntile) < SM_COUNT
             and _w4_smem(ntile, hgb, True) <= W4_SMEM_MAX)
    group = K // G
    vec = (K % 16 == 0 and group % 16 == 0 and (K // blocks // 2) % 16 == 0
           and N % 4 == 0)
    return W4Plan(ntile, split, vec, (mt, -(-N // ntile), 2 if split else 1),
                  _w4_smem(ntile, hgb, split), -(-group // 32), group % 32 != 0)


def _check_w4(name: str, x2d, q4, scale, K: int) -> None:
    _launch.require_cuda(name, x2d)
    if q4.device != x2d.device or scale.device != x2d.device:
        raise ValueError(f"{name}: all tensors must be on one device")
    if q4.dtype != torch.int32 or scale.dtype != torch.float32:
        raise TypeError(f"{name}: q4 must be int32 and scale float32, got "
                        f"{q4.dtype}, {scale.dtype}")
    if not (q4.is_contiguous() and scale.is_contiguous()):
        raise ValueError(f"{name}: q4 and scale must be contiguous")
    if x2d.shape[-1] != K:
        raise ValueError(f"{name}: x has K={x2d.shape[-1]}, the weight K={K}")


def w4_kernel(name: str, xq: torch.Tensor, rs: torch.Tensor, q4: torch.Tensor,
              scale: torch.Tensor, blocks: int, layer: Optional[int]) -> torch.Tensor:
    """Launch B3 (layer None) or B4 on quantized rows: int8 xq [M, K] and
    int32 rs [M, G] -> f32 [M, N], before the row scales, as `w4_plan`
    plans it. Counts the launch."""
    M, K = xq.shape
    N = q4.shape[-1]
    G = rs.shape[1]
    p = w4_plan(M, K, N, G, blocks)
    plan = (p.ntile, int(p.split), int(p.vec), p.smem, *p.grid[:2], _launch.stream())
    out = torch.empty((M, N), dtype=torch.float32, device=xq.device)
    if layer is None:
        fn = _launch.entry_point("w4_matmul", _W4_ARGS)
        err = fn(xq.data_ptr(), rs.data_ptr(), q4.data_ptr(), scale.data_ptr(),
                 out.data_ptr(), M, K, N, G, blocks, *plan)
    else:
        fn = _launch.entry_point("w4_matmul", _W4_STACKED_ARGS,
                                 "w4_matmul_stacked_launch")
        err = fn(xq.data_ptr(), rs.data_ptr(), q4.data_ptr(), scale.data_ptr(),
                 out.data_ptr(), M, K, N, G, q4.shape[0], layer, *plan)
    _launch.check_launch(name, err)
    _launch.LAUNCHES[name] += 1
    return out


def quantize_for_w4(x2d: torch.Tensor, G: int) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """What the JAX package computes outside its kernel, in plain torch: int8
    rows, their scales, and 8 * per-group row sums."""
    xq, sx = quantize_rows(x2d)
    xq = xq.contiguous()
    return xq, sx, _rowsums8(xq, G).contiguous()


def _w4_launch(name: str, x2d: torch.Tensor, q4: torch.Tensor,
               scale: torch.Tensor, blocks: int, layer: Optional[int]) -> torch.Tensor:
    K = x2d.shape[-1]
    G = scale.shape[-2] * blocks
    if K % (8 * blocks) or K % G or (K // G) % 4 or (K // blocks // 2) % (K // G):
        raise ValueError(f"{name}: K={K} does not fit {G} groups in {blocks} blocks")
    xq, sx, rs = quantize_for_w4(x2d, G)
    return w4_kernel(name, xq, rs, q4, scale, blocks, layer) * sx


def qdense4(x: torch.Tensor, qw: dict, b: Optional[torch.Tensor] = None,
            out_dtype=None) -> torch.Tensor:
    """x [.., K] @ packed int4 weights (2-D or blocked 3-D) -> [.., N] in
    x.dtype (or out_dtype). CUDA tensors run csrc/w4_matmul.cu; CPU tensors
    run `qdense4_ref`."""
    if x.device.type == "cpu":
        return qdense4_ref(x, qw, b, out_dtype)
    q4, scale = qw["q4"], qw["scale"]
    if q4.ndim not in (2, 3) or scale.ndim != q4.ndim:
        raise ValueError(f"qdense4: packed q4 must be 2-D or blocked 3-D, got "
                         f"{tuple(q4.shape)} with scale {tuple(scale.shape)}")
    x2d = x.reshape(-1, x.shape[-1])
    _check_w4("qdense4", x2d, q4, scale, _k_of(qw))
    y = _w4_launch("qdense4", x2d, q4, scale, _blocks_of(q4), None)
    return _finish(y, x, b, out_dtype)


def qdense4_stacked(x: torch.Tensor, w: Stacked4,
                    b: Optional[torch.Tensor] = None, out_dtype=None) -> torch.Tensor:
    """x [.., K] @ layer `w.layer` of stacked packed int4 weights, read in
    place. CUDA tensors run csrc/w4_matmul.cu; CPU tensors run
    `qdense4_stacked_ref`."""
    if x.device.type == "cpu":
        return qdense4_stacked_ref(x, w, b, out_dtype)
    layer = int(w.layer)
    if w.q4.ndim != 3 or w.scale.ndim != 3 or w.scale.shape[0] != w.q4.shape[0]:
        raise ValueError(f"qdense4_stacked: q4 must be [L, K/8, N] and scale "
                         f"[L, G, N], got {tuple(w.q4.shape)}, {tuple(w.scale.shape)}")
    if not 0 <= layer < w.q4.shape[0]:
        raise IndexError(f"qdense4_stacked: layer {layer} of {w.q4.shape[0]}")
    x2d = x.reshape(-1, x.shape[-1])
    _check_w4("qdense4_stacked", x2d, w.q4, w.scale, 8 * w.q4.shape[1])
    y = _w4_launch("qdense4_stacked", x2d, w.q4, w.scale, 1, layer)
    return _finish(y, x, b, out_dtype)


# ---------------------------------------------------------------------------
# tree-level conversion (same coverage as ops/quant.py)
# ---------------------------------------------------------------------------

def _packable(w: torch.Tensor) -> bool:
    return w.shape[-2] % 8 == 0   # 8 nibbles per word; the group adapts


def quantize_draft_params4(dparams: dict, group: int = GROUP) -> dict:
    """int4-pack every matrix quantize_draft_params would make int8; a matrix
    whose contraction dim cannot be packed stays as it is."""
    out = dict(dparams)
    layers = []
    for lp in dparams["layers"]:
        nlp = dict(lp)
        for k in _DRAFT_QUANT_KEYS:
            if k in nlp and not isinstance(nlp[k], dict) and _packable(nlp[k]):
                nlp[k] = pack_w4(nlp[k], group)
        layers.append(nlp)
    out["layers"] = layers
    if "fc" in out and not isinstance(out["fc"].get("w"), dict) \
            and _packable(out["fc"]["w"]):
        fc = dict(out["fc"])
        fc["w"] = pack_w4(fc["w"], group)
        out["fc"] = fc
    if "lm_head" in out and not isinstance(out["lm_head"], dict) \
            and _packable(out["lm_head"]):
        out["lm_head"] = pack_w4(out["lm_head"], group)
    return out


def stack_layer(stacked: dict, name: str, qw: dict, layer: int,
                num_layers: int) -> None:
    """Copy one layer's packed {"q4", "scale"} into `stacked[name]`, the
    preallocated {"q4": [L, K/8, N], "scale": [L, G, N]} (made at the first
    layer), so a tree is packed one layer at a time."""
    if name not in stacked:
        stacked[name] = {k: torch.empty((num_layers, *qw[k].shape), dtype=qw[k].dtype,
                                        device=qw[k].device) for k in ("q4", "scale")}
    for k in ("q4", "scale"):
        stacked[name][k][layer] = qw[k]


def quantize_target_params4(params: dict, group: int = GROUP, tp: int = 1,
                            fuse: bool = False) -> dict:
    """Weight-only int4 for a target tree (the port's: "layers" is a list of
    per-layer dicts). Outputs match the int4 target's own vanilla decode bit
    for bit, not the bf16 target's.

    Packed layer weights leave the per-layer dicts for `out["stacked4"]`:
    one {"q4": [L, K/8, N], "scale": [L, G, N]} per name, which
    transformer.forward hands to each layer as a `Stacked4`. tp > 1 packs
    the row-parallel weights (wo, w_down) with blocks=tp; those stay in the
    per-layer dicts as blocked 3-D leaves and run unsharded, bit-identical to
    tp=1 when the effective group is the same.

    fuse=True (tp == 1 only) concatenates wq|wk|wv -> "wqkv" and
    w_gate|w_up -> "w_gateup" before packing: seven launches per layer become
    four, bit-identical per column."""
    if fuse and tp != 1:
        raise ValueError("fuse=True is a single-chip (tp=1) layout")
    out = dict(params)
    layers, stacked = [], dict(params.get("stacked4", {}))
    n_layers = len(params["layers"])
    for i, lp in enumerate(params["layers"]):
        if any(k.startswith("we_") for k in lp):
            raise NotImplementedError("MoE targets are not ported yet")
        nlp = dict(lp)
        if fuse and "wq" in nlp and not isinstance(nlp["wq"], dict):
            nlp["wqkv"] = torch.cat([nlp.pop(k) for k in ("wq", "wk", "wv")], dim=-1)
            if "bq" in nlp:
                nlp["bqkv"] = torch.cat([nlp.pop(k) for k in ("bq", "bk", "bv")], dim=-1)
        if fuse and "w_gate" in nlp and not isinstance(nlp["w_gate"], dict):
            nlp["w_gateup"] = torch.cat([nlp.pop("w_gate"), nlp.pop("w_up")], dim=-1)
        for k in _QUANT_KEYS + ("wqkv", "w_gateup"):
            if k in nlp and not isinstance(nlp[k], dict):
                blocks = tp if k in _ROW_PARALLEL_KEYS else 1
                qw = pack_w4(nlp[k], group, blocks=blocks)
                if blocks == 1:
                    stack_layer(stacked, k, qw, i, n_layers)
                    del nlp[k]
                else:
                    nlp[k] = qw
        layers.append(nlp)
    out["layers"] = layers
    if stacked:
        out["stacked4"] = stacked
    if "lm_head" in out and not isinstance(out["lm_head"], dict):
        out["lm_head"] = pack_w4(out["lm_head"], group)
    return out
