// The w4a8 column accumulation on `__dp4a` that csrc/score_topk.cu (kernel
// B5) and csrc/w4_ablate.cu (kernel B6, mode i32_storage) run: the CUDA
// counterpart of eagle_tpu/ops/quant4.py:_w4_block_acc. Kernels B3/B4
// (csrc/w4_matmul.cu) compute the same sum, in the same order, on int8
// tensor cores.
//
// Layout of the packed weights (ops/quant4.py:pack_w4): q4 is int32
// [K/8, N] (blocked layouts flattened along the word axis). Byte b of word
// row j holds, biased by +8, row 4j+b of the block's low half in its low
// nibble and row 4j+b of the block's high half in its high nibble. scale is
// f32 [G, N] with the groups in K order.
//
// The contract is the order of the f32 sum: one accumulator per output,
// groups visited in K-ascending order (block -> half -> group), each term
// float(dot - rs) * scale rounded, then added and rounded. No fused
// multiply-add, no split of K between accumulators. The integer dot of one
// group is exact in any order, so the lanes of a warp may share it.
//
// Work split: a warp covers 8 adjacent columns; the 4 lanes that share a
// column (lane >> 3 = k-slice) each take every fourth word row of a group
// (four consecutive rows in every sixteen where the group allows 16-byte
// activation loads) and add their int32 partial dots with two shuffles. All
// 4 then hold the same dot and run the same f32 chain, so any of them may
// store the result.
// A warp-wide load of one k-slice step reads four 32-byte sectors.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace w4 {

constexpr int COLS_PER_WARP = 8;
constexpr int KSLICES = 4;

// acc[m] (m < MT) for rows m0 .. m0+MT-1 (clamped to M-1: the caller skips
// the stores of rows >= M) and column n (already clamped to N-1 by the
// caller, which skips its store). xw: int8 activations [M, K] read as int32
// words [M, K/4]; rs: int32 [M, G] = 8 * per-group row sums.
template <int MT>
__device__ __forceinline__ void column_acc(
    const int* __restrict__ xw, const int* __restrict__ rs,
    const uint32_t* __restrict__ q4, const float* __restrict__ scale,
    int M, int K, int N, int G, int blocks, int m0, int n, int kslice,
    float (&acc)[MT]) {
  const int group = K / G;
  const int wpg = group / 4;               // word rows per group
  const int kb8 = K / blocks / 8;          // word rows per block
  const int hgb = G / blocks / 2;          // groups per half block
  const int kw = K / 4;                    // activation words per row
  // 16-byte activation loads need groups of a multiple of 16 word rows (64
  // values: every real width) and rows that start on 16 bytes
  const bool vec = wpg % (4 * KSLICES) == 0 && kw % 4 == 0 &&
                   (reinterpret_cast<uintptr_t>(xw) & 15) == 0;
  int row[MT], xo[MT];                     // clamped row, its word offset
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    row[m] = min(m0 + m, M - 1);
    xo[m] = row[m] * kw;
    acc[m] = 0.0f;
  }
  int gi = 0;                              // group index in K order
  for (int blk = 0; blk < blocks; ++blk) {
    for (int half = 0; half < 2; ++half) {
      const int shift = half * 4;
      for (int g = 0; g < hgb; ++g, ++gi) {
        const uint32_t* wp = q4 + (size_t)(blk * kb8 + g * wpg) * N + n;
        const int xoff = gi * wpg;
        int dot[MT];
#pragma unroll
        for (int m = 0; m < MT; ++m) dot[m] = 0;
        if (vec) {
          // four consecutive word rows per step: one 16-byte activation load
          // feeds four dp4a
          for (int i = 4 * kslice; i < wpg; i += 4 * KSLICES) {
            int nib[4];
#pragma unroll
            for (int j = 0; j < 4; ++j)
              nib[j] = (int)((__ldg(wp + (size_t)(i + j) * N) >> shift) & 0x0F0F0F0Fu);
#pragma unroll
            for (int m = 0; m < MT; ++m) {
              const int4 xv = __ldg(reinterpret_cast<const int4*>(xw + xo[m] + xoff + i));
              dot[m] = __dp4a(nib[0], xv.x, dot[m]);
              dot[m] = __dp4a(nib[1], xv.y, dot[m]);
              dot[m] = __dp4a(nib[2], xv.z, dot[m]);
              dot[m] = __dp4a(nib[3], xv.w, dot[m]);
            }
          }
        } else {
#pragma unroll 4
          for (int i = kslice; i < wpg; i += KSLICES) {
            const uint32_t word = __ldg(wp + (size_t)i * N);
            const int nib = (int)((word >> shift) & 0x0F0F0F0Fu);
#pragma unroll
            for (int m = 0; m < MT; ++m)
              dot[m] = __dp4a(nib, __ldg(xw + xo[m] + xoff + i), dot[m]);
          }
        }
        const float s = __ldg(scale + (size_t)gi * N + n);
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          int d = dot[m];
          d += __shfl_xor_sync(0xffffffffu, d, 8);
          d += __shfl_xor_sync(0xffffffffu, d, 16);
          const float corr = (float)(d - __ldg(rs + (size_t)row[m] * G + gi));
          acc[m] = __fadd_rn(acc[m], __fmul_rn(corr, s));
        }
      }
    }
  }
}

}  // namespace w4
