// Fused draft scoring, hand-written for Hopper (sm_90a): kernel B5.
//
// Replaces: eagle_tpu/ops/score_topk.py:_score_topk_kernel (wrapper
// _score_topk_call, public score_topk_quant), the Pallas TPU kernel that
// the drafter's beam loop runs once per scoring stage when
// EngineConfig.fuse_scoring is on and the draft's lm_head is quantized.
//
// Computes, for M <= 32 hidden rows against a quantized lm_head [K, V]:
//   logits = w4: acc * sx (the arithmetic of csrc/w4_dot.cuh)
//            w8: (float(int32 dot) * sx) * scale      (ops/quant.qdense's order)
//   rounded through the hidden dtype (bf16) when the rows are bf16;
//   scores[m, j] = j-th largest logit - logsumexp(logits[m]), ids[m, j] its
//   column: ordered by value descending, then index ascending (exactly
//   topk_rows(log_softmax(logits))). The logits never reach device memory.
//
// What bounds it on the H100: the lm_head's bytes read once (K * V / 2 for
// w4: 65.5 MB at 4096 x 32000, about 20 us at 3.35 TB/s).
//
// What the design does about it. The TPU kernel walks the vocabulary blocks
// in order on one core and carries running max / sum / top-k in scratch.
// Hopper blocks run in parallel and carry nothing, so the work is two
// kernels launched back to back by one C call:
//   1. `score_tile_kernel`: one block per (M tile, 64 columns). It computes
//      the tile's logits for its rows (8 warps x 8 columns, 4 k-slices per
//      column), masks columns >= V, parks them in shared memory, and one warp
//      per row reduces them to the tile's max, its sum of exp(logit - max)
//      and its k best (value, index) pairs, written to a small workspace.
//   2. `score_merge_kernel`: one block per row merges the tiles: global max,
//      rescaled sum, and k rounds of "best candidate after the previous
//      winner" over the T * k candidates. Indices are unique, so the order
//      (value desc, index asc) is total and the result does not depend on
//      how the tiles were cut.
// The w4 pass reads the words twice (see csrc/w4_matmul.cu); the w8 pass
// gathers four rows' bytes per dp4a (8-byte pieces per row and warp
// quarter), which wastes sectors: the int8 head runs at small sizes only.

#include <cuda_bf16.h>
#include <math_constants.h>

#include "w4_dot.cuh"

namespace {

constexpr int NT = 256;
constexpr int TILE = (NT / 32) * w4::COLS_PER_WARP;       // 64 columns
constexpr int BIG_I = 0x7fffffff;

// (value desc, index asc): is (v, i) ahead of (bv, bi)?
__device__ __forceinline__ bool ahead(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

__device__ __forceinline__ void warp_best(float& bv, int& bi) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, bv, off);
    const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
    if (ahead(ov, oi, bv, bi)) { bv = ov; bi = oi; }
  }
}

template <int MT>
__device__ __forceinline__ void w8_column_dot(
    const int* __restrict__ xw, const int8_t* __restrict__ q8, int M, int K, int V,
    int m0, int n, int kslice, int (&dot)[MT]) {
  const int kw = K / 4;
  int xo[MT];
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    xo[m] = min(m0 + m, M - 1) * kw;
    dot[m] = 0;
  }
  const uint8_t* col = (const uint8_t*)q8 + n;
#pragma unroll 2
  for (int i = kslice; i < kw; i += w4::KSLICES) {
    const uint8_t* p = col + (size_t)(4 * i) * V;
    const uint32_t word = (uint32_t)__ldg(p) | ((uint32_t)__ldg(p + V) << 8) |
                          ((uint32_t)__ldg(p + 2 * (size_t)V) << 16) |
                          ((uint32_t)__ldg(p + 3 * (size_t)V) << 24);
#pragma unroll
    for (int m = 0; m < MT; ++m)
      dot[m] = __dp4a((int)word, __ldg(xw + xo[m] + i), dot[m]);
  }
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    dot[m] += __shfl_xor_sync(0xffffffffu, dot[m], 8);
    dot[m] += __shfl_xor_sync(0xffffffffu, dot[m], 16);
  }
}

// kind: 0 = w4 (q: int32 words [K/8, V], scale f32 [G, V], rs int32 [M, G]),
//       1 = w8 (q: int8 [K, V], scale f32 [V], rs unused).
// Workspace: stat [M, T, 2] (tile max, tile sum), cval / cidx [M, T, k].
template <int MT>
__global__ void __launch_bounds__(NT) score_tile_kernel(
    const int* __restrict__ xw, const int* __restrict__ rs,
    const float* __restrict__ sx, const void* __restrict__ q,
    const float* __restrict__ scale, float* __restrict__ stat,
    float* __restrict__ cval, int* __restrict__ cidx, int M, int K, int V, int G,
    int k, int kind, int cast_bf16) {
  __shared__ float sl[MT][TILE];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int tile = blockIdx.y, T = gridDim.y;
  const int c = warp * w4::COLS_PER_WARP + (lane & 7);
  const int col = tile * TILE + c;
  const int kslice = lane >> 3;
  const int m0 = blockIdx.x * MT;
  const int n = min(col, V - 1);

  float logit[MT];
  if (kind == 0) {
    w4::column_acc<MT>(xw, rs, (const uint32_t*)q, scale, M, K, V, G, 1, m0, n,
                       kslice, logit);
#pragma unroll
    for (int m = 0; m < MT; ++m)
      logit[m] = __fmul_rn(logit[m], __ldg(sx + min(m0 + m, M - 1)));
  } else {
    int dot[MT];
    w8_column_dot<MT>(xw, (const int8_t*)q, M, K, V, m0, n, kslice, dot);
    const float s = __ldg(scale + n);
#pragma unroll
    for (int m = 0; m < MT; ++m)
      logit[m] = __fmul_rn(
          __fmul_rn(__int2float_rn(dot[m]), __ldg(sx + min(m0 + m, M - 1))), s);
  }
  if (kslice == 0) {
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      float v = logit[m];
      if (cast_bf16) v = __bfloat162float(__float2bfloat16_rn(v));
      sl[m][c] = col < V ? v : -CUDART_INF_F;
    }
  }
  __syncthreads();

  for (int m = warp; m < MT; m += NT / 32) {
    if (m0 + m >= M) break;
    float v0 = sl[m][lane], v1 = sl[m][lane + 32];
    int i0 = tile * TILE + lane, i1 = i0 + 32;
    if (i0 >= V) i0 = BIG_I;
    if (i1 >= V) i1 = BIG_I;
    float tmax = fmaxf(v0, v1);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, off));
    float tsum = expf(v0 - tmax) + expf(v1 - tmax);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      tsum += __shfl_xor_sync(0xffffffffu, tsum, off);
    const size_t slot = (size_t)(m0 + m) * T + tile;
    if (lane == 0) {
      stat[2 * slot] = tmax;
      stat[2 * slot + 1] = tsum;
    }
    for (int j = 0; j < k; ++j) {
      float bv = v0;
      int bi = i0;
      if (ahead(v1, i1, bv, bi)) { bv = v1; bi = i1; }
      warp_best(bv, bi);
      if (lane == 0) {
        cval[slot * k + j] = bv;
        cidx[slot * k + j] = bi;
      }
      // the winner leaves the pool (a masked or spent slot has index BIG_I)
      if (bi != BIG_I && bi == i0) { v0 = -CUDART_INF_F; i0 = BIG_I; }
      if (bi != BIG_I && bi == i1) { v1 = -CUDART_INF_F; i1 = BIG_I; }
    }
  }
}

__global__ void __launch_bounds__(NT) score_merge_kernel(
    const float* __restrict__ stat, const float* __restrict__ cval,
    const int* __restrict__ cidx, float* __restrict__ scores,
    int* __restrict__ ids, int T, int k) {
  __shared__ float sv[NT / 32];
  __shared__ int si[NT / 32];
  __shared__ float bcast_v;
  __shared__ int bcast_i;
  const int m = blockIdx.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float* st = stat + (size_t)m * T * 2;

  // global max over the tiles
  float gmax = -CUDART_INF_F;
  for (int t = tid; t < T; t += NT) gmax = fmaxf(gmax, st[2 * t]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    gmax = fmaxf(gmax, __shfl_xor_sync(0xffffffffu, gmax, off));
  if (lane == 0) sv[warp] = gmax;
  __syncthreads();
  gmax = sv[0];
#pragma unroll
  for (int w = 1; w < NT / 32; ++w) gmax = fmaxf(gmax, sv[w]);
  __syncthreads();

  // sum of exp(logit - gmax): tile sums rescaled to the global max
  float sum = 0.0f;
  for (int t = tid; t < T; t += NT) sum += st[2 * t + 1] * expf(st[2 * t] - gmax);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    sum += __shfl_xor_sync(0xffffffffu, sum, off);
  if (lane == 0) sv[warp] = sum;
  __syncthreads();
  sum = sv[0];
#pragma unroll
  for (int w = 1; w < NT / 32; ++w) sum += sv[w];
  __syncthreads();
  const float lse = gmax + logf(sum);

  // k rounds: the best candidate strictly after the previous winner
  const int C = T * k;
  const float* cv = cval + (size_t)m * C;
  const int* ci = cidx + (size_t)m * C;
  float pv = CUDART_INF_F;
  int pi = -1;
  for (int j = 0; j < k; ++j) {
    float bv = -CUDART_INF_F;
    int bi = BIG_I;
    for (int e = tid; e < C; e += NT) {
      const float v = cv[e];
      const int i = ci[e];
      if (ahead(pv, pi, v, i) && ahead(v, i, bv, bi)) { bv = v; bi = i; }
    }
    warp_best(bv, bi);
    if (lane == 0) { sv[warp] = bv; si[warp] = bi; }
    __syncthreads();
    if (tid == 0) {
      bv = sv[0];
      bi = si[0];
      for (int w = 1; w < NT / 32; ++w)
        if (ahead(sv[w], si[w], bv, bi)) { bv = sv[w]; bi = si[w]; }
      bcast_v = bv;
      bcast_i = bi;
      scores[(size_t)m * k + j] = bv - lse;
      ids[(size_t)m * k + j] = bi;
    }
    __syncthreads();
    pv = bcast_v;
    pi = bcast_i;
  }
}

template <int MT>
void launch_tiles(const void* xq, const void* rs, const void* sx, const void* q,
                  const void* scale, void* stat, void* cval, void* cidx, int M,
                  int K, int V, int G, int k, int kind, int cast_bf16, int T,
                  cudaStream_t st) {
  dim3 grid((M + MT - 1) / MT, T);
  score_tile_kernel<MT><<<grid, NT, 0, st>>>(
      (const int*)xq, (const int*)rs, (const float*)sx, q, (const float*)scale,
      (float*)stat, (float*)cval, (int*)cidx, M, K, V, G, k, kind, cast_bf16);
}

}  // namespace

// xq: int8 [M, K]; rs: int32 [M, G] (w4) or null (w8); sx: f32 [M];
// q / scale: see score_tile_kernel; workspace stat f32 [M, T, 2], cval f32
// and cidx int32 [M, T, k] with T = ceil(V / 64); scores f32 [M, k],
// ids int32 [M, k]. Returns cudaGetLastError() after the launches.
extern "C" int score_topk_launch(const void* xq, const void* rs, const void* sx,
                                 const void* q, const void* scale, void* stat,
                                 void* cval, void* cidx, void* scores, void* ids,
                                 int M, int K, int V, int G, int k, int kind,
                                 int cast_bf16, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int T = (V + TILE - 1) / TILE;
  if (M <= 0 || M > 32 || k <= 0 || k > 16 || k > V || K % 8 != 0 || T > 65535 ||
      (kind != 0 && kind != 1))
    return (int)cudaErrorInvalidValue;
  if (kind == 0 && (G <= 0 || G % 2 != 0 || K % G != 0 || (K / G) % 4 != 0))
    return (int)cudaErrorInvalidValue;
#define TILES(MT) launch_tiles<MT>(xq, rs, sx, q, scale, stat, cval, cidx, M, K, \
                                   V, G, k, kind, cast_bf16, T, st)
  if (M == 1) TILES(1);
  else if (M == 2) TILES(2);
  else if (M <= 4) TILES(4);
  else if (M <= 8) TILES(8);
  else TILES(16);
#undef TILES
  int err = (int)cudaGetLastError();
  if (err != 0) return err;
  score_merge_kernel<<<M, NT, 0, st>>>((const float*)stat, (const float*)cval,
                                       (const int*)cidx, (float*)scores, (int*)ids,
                                       T, k);
  return (int)cudaGetLastError();
}
