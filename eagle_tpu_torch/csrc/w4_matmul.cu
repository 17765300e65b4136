// w4a8 matmul, hand-written for Hopper (sm_90a): kernels B3 and B4.
//
// Replaces: eagle_tpu/ops/quant4.py:_w4_kernel (wrapper _qdense4_pallas_2d,
// public qdense4) and eagle_tpu/ops/quant4.py:_w4_kernel_stacked (wrapper
// _qdense4_pallas_stacked, public qdense4_stacked), the Pallas TPU kernels
// behind every dense projection of an int4 target or draft.
//
// Computes out[m, n] = sum over scale groups g, in K order, of
//   float(dot_g(xq[m], nibbles[:, n]) - rs[m, g]) * scale[g, n]
// with int8 activations xq [M, K], rs = 8 * per-group row sums (the folded
// -8 zero point), packed int4 words q4 [K/8, N] (or blocked, flattened) and
// f32 scales [G, N]. The activation row scale is applied by the caller.
// The stacked entry point reads layer `layer` of q4 [L, K/8, N] and scale
// [L, G, N] in place: the offset is added to the pointers at launch, the
// stacked tensors are never sliced into a copy.
//
// What bounds it on the H100: at decode shapes (M = 1 .. 61) the packed
// weights, K * N / 2 bytes, read once: 8.4 MB for 4096 x 4096, 29 MB for
// 4096 x 14336. At prefill (M ~ 1000) the integer multiply-adds bind.
//
// What the design does about it (a first version that is right; see
// csrc/w4_dot.cuh for the arithmetic and its order):
//  - The half-split layout needs every word at two far-apart points of the
//    one accumulation chain. This kernel reads the words twice (low-half
//    pass, then high-half pass) rather than staging a column tile in shared
//    memory: the second pass of a block follows its first closely, so it is
//    mostly served by the 50 MB L2. The kernel therefore requests 2x the
//    packed bytes from the memory system (more with several M tiles).
//  - One block is 8 warps = 64 columns; a tile of MT rows (1, 2, 4, 8 or 16,
//    chosen from M) shares each weight word. M tiles are the fast grid axis
//    so that blocks that share a column tile run together and share L2.
//  - Integer dots are __dp4a on raw nibbles; no tensor cores, no TMA.
//  - Ragged N and M are guarded by clamping the loads and skipping the store.

#include "w4_dot.cuh"

namespace {

constexpr int NT = 256;                                   // 8 warps
constexpr int COLS_PER_BLOCK = (NT / 32) * w4::COLS_PER_WARP;

template <int MT>
__global__ void __launch_bounds__(NT) w4_matmul_kernel(
    const int* __restrict__ xw, const int* __restrict__ rs,
    const uint32_t* __restrict__ q4, const float* __restrict__ scale,
    float* __restrict__ out, int M, int K, int N, int G, int blocks) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int col = blockIdx.y * COLS_PER_BLOCK + warp * w4::COLS_PER_WARP + (lane & 7);
  const int kslice = lane >> 3;
  const int m0 = blockIdx.x * MT;
  float acc[MT];
  w4::column_acc<MT>(xw, rs, q4, scale, M, K, N, G, blocks, m0, min(col, N - 1),
                     kslice, acc);
  if (kslice == 0 && col < N) {
#pragma unroll
    for (int m = 0; m < MT; ++m)
      if (m0 + m < M) out[(size_t)(m0 + m) * N + col] = acc[m];
  }
}

template <int MT>
int launch(const void* xq, const void* rs, const void* q4, const void* scale,
           void* out, int M, int K, int N, int G, int blocks, cudaStream_t st) {
  dim3 grid((M + MT - 1) / MT, (N + COLS_PER_BLOCK - 1) / COLS_PER_BLOCK);
  w4_matmul_kernel<MT><<<grid, NT, 0, st>>>(
      (const int*)xq, (const int*)rs, (const uint32_t*)q4, (const float*)scale,
      (float*)out, M, K, N, G, blocks);
  return (int)cudaGetLastError();
}

int dispatch(const void* xq, const void* rs, const void* q4, const void* scale,
             void* out, int M, int K, int N, int G, int blocks, cudaStream_t st) {
  if (M <= 0 || N <= 0 || blocks <= 0 || G <= 0 || K % (8 * blocks) != 0 ||
      G % (2 * blocks) != 0 || K % G != 0 || (K / G) % 4 != 0)
    return (int)cudaErrorInvalidValue;
  if ((N + COLS_PER_BLOCK - 1) / COLS_PER_BLOCK > 65535)
    return (int)cudaErrorInvalidValue;
  if (M == 1) return launch<1>(xq, rs, q4, scale, out, M, K, N, G, blocks, st);
  if (M == 2) return launch<2>(xq, rs, q4, scale, out, M, K, N, G, blocks, st);
  if (M <= 4) return launch<4>(xq, rs, q4, scale, out, M, K, N, G, blocks, st);
  if (M <= 8) return launch<8>(xq, rs, q4, scale, out, M, K, N, G, blocks, st);
  return launch<16>(xq, rs, q4, scale, out, M, K, N, G, blocks, st);
}

}  // namespace

// B3. xq: int8 [M, K]; rs: int32 [M, G]; q4: int32 [K/8, N] (blocked layouts
// flattened); scale: f32 [G, N]; out: f32 [M, N]. Returns cudaGetLastError()
// after the launch (0 = launched).
extern "C" int w4_matmul_launch(const void* xq, const void* rs, const void* q4,
                                const void* scale, void* out, int M, int K, int N,
                                int G, int blocks, void* stream) {
  return dispatch(xq, rs, q4, scale, out, M, K, N, G, blocks, (cudaStream_t)stream);
}

// B4. As B3 with blocks = 1, reading layer `layer` of q4 [L, K/8, N] and
// scale [L, G, N] in place.
extern "C" int w4_matmul_stacked_launch(const void* xq, const void* rs,
                                        const void* q4, const void* scale, void* out,
                                        int M, int K, int N, int G, int L, int layer,
                                        void* stream) {
  if (layer < 0 || layer >= L) return (int)cudaErrorInvalidValue;
  const uint32_t* q = (const uint32_t*)q4 + (size_t)layer * (K / 8) * N;
  const float* s = (const float*)scale + (size_t)layer * G * N;
  return dispatch(xq, rs, q, s, out, M, K, N, G, 1, (cudaStream_t)stream);
}
