// w4a8 matmul on Hopper's int8 tensor cores (sm_90a): kernels B3 and B4.
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
// [L, G, N] in place: the offset is added to the pointers at launch.
//
// The order of the f32 sum is the contract (as csrc/w4_mma.cuh states it):
// one accumulator per output, groups in K order (block -> half -> group),
// each term float(dot - rs) * scale rounded, then added and rounded
// (__fmul_rn, __fadd_rn, built with -fmad=false). The integer dot of a group
// is exact in any order, so the tensor cores produce it.
//
// What bounds it on the H100: at decode shapes (M = 1 .. 61) the packed
// weights, K * N / 2 bytes, read once (8.4 MB for 4096 x 4096, 29 MB for
// 4096 x 14336); at prefill (M ~ 1000) the integer multiply-adds.
//
// What the design does about it:
//  - The main loop is csrc/w4_mma.cuh's, shared with B5: integer products on
//    int8 tensor cores (mma.sync m16n8k32 s8 x u8, the nibbles unpacked by
//    one AND and shift), a cp.async ring of group-sized stages, the f32
//    chain after each group's last mma. This file adds the store epilogue
//    and the launch.
//  - A block is 4 warps (8 for 32- and 64-column tiles, measured faster;
//    at most 4 across the columns) over a tile of 64 rows x NTILE (8 .. 128)
//    columns. Bulk copies (TMA, one per word row, completing on an mbarrier)
//    measured slower than cp.async at every shape: the loop's instructions,
//    not the copy path, bound a stage. Keeping a column tile's words in
//    shared memory across both halves (one block an SM at K = 4096 and 64
//    columns) measured slower at every shape of the int4 path (PERF.md), so
//    the high half reads the words again, mostly from the 50 MB L2.
//  - At least 132 blocks where the shapes allow: ops/quant4.w4_plan narrows
//    NTILE as N shrinks, and where 8 columns still give fewer blocks (N =
//    1024 at M <= 64) it splits the two passes over a cluster of two blocks
//    (8-column tiles only): rank 1 keeps its high-half terms in shared
//    memory, rank 0 runs the low chain and then adds them in order through
//    distributed shared memory.
//  - The plan (column tile, split, 16-byte copies, shared memory, grid) is
//    the wrapper's (ops/quant4.w4_plan); a launch only checks that it is
//    this layout's and refuses any other.

#include "w4_mma.cuh"

namespace {

using w4mma::NS;
using w4mma::SMEM_MAX;

constexpr int BM = w4mma::MAT_BM;   // rows per block: 4 m16 tiles

template <int NTILE>
constexpr int threads_of() { return w4mma::mat_threads<NTILE>(); }

// the tile (csrc/w4_mma.cuh: MatTile) B6's `i32_storage` mode runs too
template <int NTILE>
using Tile = w4mma::MatTile<NTILE>;

// the store epilogue: rows < M and columns < N of the block's tile
template <class TL>
struct Store {
  float* out;
  int M, N;
  __device__ __forceinline__ void operator()(float (&acc)[TL::MPW][TL::NPW][4],
                                             bool (&live)[TL::MPW],
                                             const w4mma::Frag<TL>& fr) const {
    const int m0 = blockIdx.x * BM, n0 = blockIdx.y * TL::NTILE;
#pragma unroll
    for (int mi = 0; mi < TL::MPW; ++mi) {
      if (!live[mi]) continue;
#pragma unroll
      for (int ni = 0; ni < TL::NPW; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = m0 + fr.row0(mi) + 8 * (e >> 1);
          const int col = n0 + fr.col0(ni) + (e & 1);
          if (row < M && col < N) out[(size_t)row * N + col] = acc[mi][ni][e];
        }
    }
  }
};

template <int NTILE, bool VEC, int NT = threads_of<NTILE>()>
__global__ void __launch_bounds__(NT) w4_mma_kernel(const __grid_constant__ w4mma::Args a) {
  using TL = Tile<NTILE>;
  extern __shared__ __align__(16) unsigned char smem[];
  Store<TL> epi = {a.out, a.M, a.N};
  w4mma::run<TL, VEC>(a, smem, epi);
}

template <int NTILE>
int smem_bytes(const w4mma::Args& a) {
  using TL = Tile<NTILE>;
  size_t b = (size_t)NS * TL::SLOT;
  if (a.split) b += (size_t)a.hgb * TL::ELEMS * TL::NT * 4;
  return b > (size_t)SMEM_MAX ? -1 : (int)b;
}

template <int NTILE, bool VEC>
int launch(const w4mma::Args& a, cudaStream_t st) {
  constexpr int NT = threads_of<NTILE>();
  static bool smem_attr = false;
  // the wrapper's plan must be this layout's
  const int smem = a.smem;
  if (smem != smem_bytes<NTILE>(a) || a.grid_m != (a.M + BM - 1) / BM ||
      a.grid_n != (a.N + NTILE - 1) / NTILE || a.grid_n > 65535)
    return (int)cudaErrorInvalidValue;
  if (!smem_attr) {
    cudaError_t e = cudaFuncSetAttribute(w4_mma_kernel<NTILE, VEC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
    if (e != cudaSuccess) return (int)e;
    smem_attr = true;
  }
  const dim3 grid(a.grid_m, a.grid_n, a.split ? 2 : 1);
  if (!a.split) {
    w4_mma_kernel<NTILE, VEC><<<grid, NT, smem, st>>>(a);
    return (int)cudaGetLastError();
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 2;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, w4_mma_kernel<NTILE, VEC>, a);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

int dispatch(const void* xq, const void* rs, const void* q4, const void* scale,
             void* out, int M, int K, int N, int G, int blocks, int ntile, int split,
             int vec, int smem, int grid_m, int grid_n, cudaStream_t st) {
  w4mma::Args a;
  const int err = w4mma::make_args(a, xq, rs, q4, scale, out, M, K, N, G, blocks, split,
                                   vec, smem, grid_m, grid_n);
  if (err != 0) return err;
  if (a.split && (blocks != 1 || ntile != 8)) return (int)cudaErrorInvalidValue;
  switch (ntile) {
    case 8: return a.vec ? launch<8, true>(a, st) : launch<8, false>(a, st);
    case 16: return a.vec ? launch<16, true>(a, st) : launch<16, false>(a, st);
    case 32: return a.vec ? launch<32, true>(a, st) : launch<32, false>(a, st);
    case 64: return a.vec ? launch<64, true>(a, st) : launch<64, false>(a, st);
    case 128: return a.vec ? launch<128, true>(a, st) : launch<128, false>(a, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// B3. xq: int8 [M, K]; rs: int32 [M, G]; q4: int32 [K/8, N] (blocked layouts
// flattened); scale: f32 [G, N]; out: f32 [M, N]. ntile, split, vec, smem
// (dynamic shared memory, bytes) and the grid's row and column tiles are
// ops/quant4.w4_plan's. Returns cudaGetLastError() after the launch (0 =
// launched).
extern "C" int w4_matmul_launch(const void* xq, const void* rs, const void* q4,
                                const void* scale, void* out, int M, int K, int N,
                                int G, int blocks, int ntile, int split, int vec,
                                int smem, int grid_m, int grid_n, void* stream) {
  return dispatch(xq, rs, q4, scale, out, M, K, N, G, blocks, ntile, split, vec, smem,
                  grid_m, grid_n, (cudaStream_t)stream);
}

// B4. As B3 with blocks = 1, reading layer `layer` of q4 [L, K/8, N] and
// scale [L, G, N] in place.
extern "C" int w4_matmul_stacked_launch(const void* xq, const void* rs,
                                        const void* q4, const void* scale, void* out,
                                        int M, int K, int N, int G, int L, int layer,
                                        int ntile, int split, int vec, int smem,
                                        int grid_m, int grid_n, void* stream) {
  if (layer < 0 || layer >= L) return (int)cudaErrorInvalidValue;
  const uint32_t* q = (const uint32_t*)q4 + (size_t)layer * (K / 8) * N;
  const float* s = (const float*)scale + (size_t)layer * G * N;
  return dispatch(xq, rs, q, s, out, M, K, N, G, 1, ntile, split, vec, smem, grid_m,
                  grid_n, (cudaStream_t)stream);
}
