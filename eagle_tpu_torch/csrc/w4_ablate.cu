// Ablation variants of the w4a8 matmul body, hand-written for Hopper
// (sm_90a): kernel B6, the probe behind `python -m
// eagle_tpu_torch.probe_w4_ablate`.
//
// Replaces: tools/probe_w4_ablate.py:make_kernel (its pallas_call sits in
// run_mode), the Pallas TPU kernel that takes the B3 body apart into nine
// variants to tell the cost of the nibble unpack, of the per-group dots, of
// the storage format and of the f32 scale accumulation from each other.
//
// Every variant is a well-defined function of its inputs (the "wrong math"
// ones too) and has a plain version, ops/w4_ablate.py:ablate_ref. Inputs:
// int8 activations xq [M, K]; rs int32 [M, G] (the probe passes 8 x the group
// row sums); f32 scales [G, N]; weights either
//   u8  [K/2, N]: byte r = K-row r in its low nibble, K-row K/2 + r in its
//                 high nibble, or
//   i32 [K/8, N]: byte b of word w = byte row 4w + b of the u8 layout (the
//                 layout of ops/quant4.py:pack_w4).
// out is f32 [M, N], not rescaled per row. With hg = G / 2, dot_g the exact
// integer dot of group g's activations and its plane rows, and
// term(g) = float(dot_g - rs[:, g]) * scale[g, :] (one rounded multiply), acc
// summed with one rounded add per term:
//   full          u8   g = 0 .. G-1 in order (low-half groups, then high)
//   bf16_dots     u8   the same sum, each dot as bf16 mma with f32 sums
//                      (every partial sum is an integer below 2^24: exact)
//   no_unpack     u8   the same loop on the raw bytes read as int8, both halves
//   no_dots       u8   every row = f32 column sum of the low nibbles plus that
//                      of the high nibbles; no dot, no scale
//   one_dot       u8   per half one dot of xq[:, :K/2] over all K/2 rows,
//                      times scale[0, :]
//   one_dot_bf16  u8   the same with bf16 mma
//   i32_storage   i32  `full`'s sum: the engines' loop itself
//   fused_unpack  i32  each word read once: low group g and high group hg + g
//                      come from the same words; terms added g, hg+g, g+1, ..
//   batched_dot   i32  all G integer dots first, staged in shared memory;
//                      then one f32 reduction, g = 0 .. G-1 in order (the JAX
//                      probe leaves that order to XLA)
//
// What bounds it on the H100: the packed weights, K * N / 2 bytes, read once
// (8.4 MB at 4096 x 4096, 2.5 us at 3.35 TB/s); at M = 512 the integer
// multiply-adds against the int8 tensor-core peak.
//
// The design: every mode is the main loop of B3, B4 and B5 (csrc/w4_mma.cuh:
// mma.sync m16n8k32 s8 x u8, the cp.async ring of group-sized stages, the
// f32 chain after each group) with one part swapped or taken away through
// the loop's `Body` parameter, on B3's tile (w4mma::MatTile, 64 rows). So
// the gap between a mode and `i32_storage` is what that part costs the
// engines' loop:
//   - u8 modes: a stage holds byte rows; a B fragment (four K-consecutive
//     bytes of one column) is gathered with four byte loads and two byte
//     permutes (`full` against `i32_storage`: the storage format);
//   - no_unpack: no AND and shift, s8 x s8 mma;
//   - no_dots: the copies, the barrier and the unpack, then column sums
//     (dp4a with ones) instead of mma;
//   - one_dot: no chain after each group, one per half;
//   - bf16 modes: the int8 fragments converted to bf16 pairs, two m16n8k16
//     mma per k32 step;
//   - fused_unpack: one pass over the words instead of two (each stage also
//     carries the high half's activations, rs and scales);
//   - batched_dot: the chain taken out of the loop.
//
// Launch shape: `block_n` is the number of columns one block owns (a multiple
// of 8); the block walks them one column tile at a time, the tile being
// ops/quant4.w4_plan's for the shapes (the widest that divides block_n; for
// batched_dot the widest whose staged dots fit shared memory; never the
// cluster split). At block_n = w4_plan's tile, `i32_storage` is B3's launch.
// The plan is the wrapper's (ops/w4_ablate.ablate_plan); the launch checks it.

#include "w4_mma.cuh"

namespace {

using w4mma::Body;
using w4mma::MatTile;
using w4mma::NS;
using w4mma::SMEM_MAX;

enum Mode { FULL = 0, BF16_DOTS, NO_UNPACK, NO_DOTS, ONE_DOT, ONE_DOT_BF16,
            I32_STORAGE, FUSED_UNPACK, BATCHED_DOT };

// Body<U8, UNPACK, FLOAT, FUSED, A_LOW, CHAIN> of each mode
template <int MODE> struct ModeBody;
template <> struct ModeBody<FULL> { using B = Body<true, true, false, false, false, w4mma::PER_GROUP>; };
template <> struct ModeBody<BF16_DOTS> { using B = Body<true, true, true, false, false, w4mma::PER_GROUP>; };
template <> struct ModeBody<NO_UNPACK> { using B = Body<true, false, false, false, false, w4mma::PER_GROUP>; };
template <> struct ModeBody<NO_DOTS> { using B = Body<true, true, false, false, false, w4mma::COLSUM>; };
template <> struct ModeBody<ONE_DOT> { using B = Body<true, true, false, false, true, w4mma::PER_HALF>; };
template <> struct ModeBody<ONE_DOT_BF16> { using B = Body<true, true, true, false, true, w4mma::PER_HALF>; };
template <> struct ModeBody<I32_STORAGE> { using B = w4mma::Engine; };
template <> struct ModeBody<FUSED_UNPACK> { using B = Body<false, true, false, true, false, w4mma::PER_GROUP>; };
template <> struct ModeBody<BATCHED_DOT> { using B = Body<false, true, false, false, false, w4mma::STAGED>; };

// B3's store epilogue, for the column tile starting at n0
template <class TL>
struct Store {
  float* out;
  int M, N, n0;
  __device__ __forceinline__ void operator()(float (&acc)[TL::MPW][TL::NPW][4],
                                             bool (&live)[TL::MPW],
                                             const w4mma::Frag<TL>& fr) const {
    const int m0 = blockIdx.x * TL::BM;
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

template <int MODE, int NTILE, bool VEC, int NT = w4mma::mat_threads<NTILE>()>
__global__ void __launch_bounds__(NT) ablate_kernel(
    const __grid_constant__ w4mma::Args a, int tiles_per_block) {
  using TL = MatTile<NTILE>;
  using B = typename ModeBody<MODE>::B;
  extern __shared__ __align__(16) unsigned char smem[];
  const int t0 = blockIdx.y * tiles_per_block;
  const int t1 = min(t0 + tiles_per_block, (a.N + NTILE - 1) / NTILE);
#pragma unroll 1
  for (int ct = t0; ct < t1; ++ct) {
    if (ct > t0) __syncthreads();   // the previous tile's ring is fully read
    Store<TL> epi = {a.out, a.M, a.N, ct * NTILE};
    w4mma::run<TL, VEC, Store<TL>, B>(a, smem, epi, ct);
  }
}

template <int MODE, int NTILE>
size_t smem_of(const w4mma::Args& a) {
  using TL = MatTile<NTILE>;
  using B = typename ModeBody<MODE>::B;
  const size_t staged = B::CHAIN == w4mma::STAGED ? (size_t)a.G * TL::BM * NTILE * 4 : 0;
  return (size_t)NS * w4mma::Slot<TL, B>::SLOT + staged;
}

template <int MODE, int NTILE, bool VEC>
int launch(const w4mma::Args& a, int tiles_per_block, cudaStream_t st) {
  using TL = MatTile<NTILE>;
  static bool smem_attr = false;
  // the wrapper's plan must be this layout's
  const size_t smem = smem_of<MODE, NTILE>(a);
  if (smem > (size_t)SMEM_MAX || (int)smem != a.smem ||
      a.grid_m != (a.M + TL::BM - 1) / TL::BM ||
      a.grid_n != (a.N + tiles_per_block * NTILE - 1) / (tiles_per_block * NTILE))
    return (int)cudaErrorInvalidValue;
  if (!smem_attr) {
    const cudaError_t e = cudaFuncSetAttribute(ablate_kernel<MODE, NTILE, VEC>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               SMEM_MAX);
    if (e != cudaSuccess) return (int)e;
    smem_attr = true;
  }
  ablate_kernel<MODE, NTILE, VEC><<<dim3(a.grid_m, a.grid_n), TL::NT, smem, st>>>(
      a, tiles_per_block);
  return (int)cudaGetLastError();
}

// u8 modes copy byte rows 16 bytes at a time only where a tile row has 16
template <int MODE, int NTILE>
int by_vec(const w4mma::Args& a, int tiles_per_block, cudaStream_t st) {
  if constexpr (ModeBody<MODE>::B::U8 && NTILE < 16)
    return a.vec ? (int)cudaErrorInvalidValue : launch<MODE, NTILE, false>(a, tiles_per_block, st);
  else
    return a.vec ? launch<MODE, NTILE, true>(a, tiles_per_block, st)
                 : launch<MODE, NTILE, false>(a, tiles_per_block, st);
}

template <int MODE>
int by_tile(w4mma::Args& a, int ntile, int tiles_per_block, cudaStream_t st) {
  using B = typename ModeBody<MODE>::B;
  if (B::U8 && (a.N % 4 != 0 || (a.vec && a.N % 16 != 0))) return (int)cudaErrorInvalidValue;
  if (B::FUSED) a.nstages /= 2;     // one pass over the words
  switch (ntile) {
    case 8: return by_vec<MODE, 8>(a, tiles_per_block, st);
    case 16: return by_vec<MODE, 16>(a, tiles_per_block, st);
    case 32: return by_vec<MODE, 32>(a, tiles_per_block, st);
    case 64: return by_vec<MODE, 64>(a, tiles_per_block, st);
    case 128: return by_vec<MODE, 128>(a, tiles_per_block, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// B6. mode: the Mode enum above (ops/w4_ablate.py:MODES in the same order).
// xq: int8 [M, K]; rs: int32 [M, G]; p: u8 [K/2, N] (modes 0-5, N % 4 == 0)
// or int32 [K/8, N] (modes 6-8); scale: f32 [G, N]; out: f32 [M, N];
// block_n: columns per block, a multiple of ntile. ntile, vec, smem and the
// grid are ops/w4_ablate.ablate_plan's. Returns cudaGetLastError() after the
// launch (0 = launched).
extern "C" int w4_ablate_launch(int mode, const void* xq, const void* rs, const void* p,
                                const void* scale, void* out, int M, int K, int N, int G,
                                int block_n, int ntile, int vec, int smem, int grid_m,
                                int grid_n, void* stream) {
  if (ntile <= 0 || block_n <= 0 || block_n % ntile != 0 || grid_n > 65535)
    return (int)cudaErrorInvalidValue;
  w4mma::Args a;
  const int err = w4mma::make_args(a, xq, rs, p, scale, out, M, K, N, G, 1, 0, vec, smem,
                                   grid_m, grid_n);
  if (err != 0) return err;
  const int tpb = block_n / ntile;
  cudaStream_t st = (cudaStream_t)stream;
  switch (mode) {
    case FULL: return by_tile<FULL>(a, ntile, tpb, st);
    case BF16_DOTS: return by_tile<BF16_DOTS>(a, ntile, tpb, st);
    case NO_UNPACK: return by_tile<NO_UNPACK>(a, ntile, tpb, st);
    case NO_DOTS: return by_tile<NO_DOTS>(a, ntile, tpb, st);
    case ONE_DOT: return by_tile<ONE_DOT>(a, ntile, tpb, st);
    case ONE_DOT_BF16: return by_tile<ONE_DOT_BF16>(a, ntile, tpb, st);
    case I32_STORAGE: return by_tile<I32_STORAGE>(a, ntile, tpb, st);
    case FUSED_UNPACK: return by_tile<FUSED_UNPACK>(a, ntile, tpb, st);
    case BATCHED_DOT: return by_tile<BATCHED_DOT>(a, ntile, tpb, st);
  }
  return (int)cudaErrorInvalidValue;
}
