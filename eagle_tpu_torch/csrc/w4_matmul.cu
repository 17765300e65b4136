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
// The order of the f32 sum is the contract (as csrc/w4_dot.cuh states it):
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
//  - Integer products on tensor cores: mma.sync m16n8k32 s8 x u8 -> s32. A
//    is the int8 rows; B is the biased nibbles: (word >> shift) & 0x0F0F0F0F
//    already is B's fragment (four K-consecutive nibbles of one column, as
//    ops/quant4.pack_w4 lays them out), so the unpack is one AND and shift.
//  - A block is 4 warps (8 for 32- and 64-column tiles, measured faster;
//    at most 4 across the columns) over a tile of 64 rows x NTILE (8 .. 128)
//    columns. The int8 rows of m16 tiles past M are neither copied nor
//    read, rows >= M of a live tile are zero-filled (no bytes read), and
//    tiles past M skip their mma and chain.
//  - The bytes stream through a ring of NS stages in shared memory. A stage
//    is up to SUB = 4 k32 steps of one scale group (a whole group of 128):
//    32 word rows x NTILE columns, the 64 x 128 int8 rows of the same K
//    range and, in a group's last stage, the group's 64 rs values and NTILE
//    scales, all by cp.async (16-byte copies; 4-byte ones where rows,
//    groups or columns are not 16-byte aligned). Bulk copies (TMA, one per
//    word row, completing on an mbarrier) measured slower at every shape: the loop's
//    instructions, not the copy path, bound a stage. So each thread works
//    out the sources and destinations of its copies once, before the loop,
//    and a stage only adds its offsets (recomputing the addresses of every
//    copy was most of the loop's instructions); the 4-byte path is a
//    separate instantiation. One barrier per stage; the stage's position is
//    a cursor advanced by additions, not divisions.
//  - Stages never straddle a scale group: in a group shorter than 32 K
//    values (group 4 .. 28) or a last step that the group does not fill,
//    the A bytes outside the group are zero. The f32 chain runs after the
//    group's last mma, per C-fragment element, reading rs and scale from
//    the stage once per group.
//  - The half-split layout (every high-half group comes after every
//    low-half group) is taken as two passes over the words: low nibbles,
//    then high nibbles; the high pass reads them again, mostly from the 50 MB
//    L2. Keeping a column tile's words in shared memory across both passes
//    (one block an SM at K = 4096 and 64 columns) measured slower at every
//    shape of the int4 path (PERF.md), so no shape takes it.
//  - At least 132 blocks where the shapes allow: ops/quant4.w4_plan narrows
//    NTILE as N shrinks, and where 8 columns still give fewer blocks (N =
//    1024 at M <= 64) it splits the two passes over a cluster of two blocks
//    (8-column tiles only): rank 1 keeps its high-half terms in shared
//    memory, rank 0 runs the low chain and then adds them in order through
//    distributed shared memory.
//  - The plan (column tile, split, 16-byte copies, shared memory, grid) is
//    the wrapper's (ops/quant4.w4_plan); a launch only checks that it is
//    this layout's and refuses any other.

#include <cooperative_groups.h>

#include "ptx.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int BM = 64;              // rows per block: 4 m16 tiles
constexpr int KW = 8;               // word rows per k32 step
constexpr int SUB = 4;              // k32 steps per stage (one group of 128)
constexpr int SW = KW * SUB;        // word rows per stage
constexpr int A_STRIDE = 4 * SW + 16;   // bytes per int8 row in a stage (+ pad)
constexpr int NS = 4;               // ring stages
constexpr int SMEM_MAX = 232448;    // 227 KB of dynamic shared memory a block

// 8 warps for the 32- and 64-column tiles, 4 for the others (measured)
template <int NTILE>
constexpr int threads_of() { return NTILE == 32 || NTILE == 64 ? 256 : 128; }

// at most 4 warps across the columns, the rest across the m16 tiles: every
// warp reads the int8 fragments of its own m16 tiles from shared memory, so
// fewer warps per row tile read them fewer times (measured faster)
template <int NTILE, int NT = threads_of<NTILE>()>
struct Tile {
  static constexpr int WARPS = NT / 32;
  static constexpr int WARPS_N = NTILE / 8 < 4 ? NTILE / 8 : 4;
  static constexpr int WARPS_M = WARPS / WARPS_N;
  static constexpr int NPW = NTILE / 8 / WARPS_N;     // n8 tiles per warp
  static constexpr int MPW = 4 / WARPS_M;             // m16 tiles per warp
  static constexpr int WSTRIDE = NTILE + 8;           // words per row (pad)
  static constexpr int A_BYTES = BM * A_STRIDE;
  static constexpr int RS_BYTES = BM * 4 + NTILE * 4; // the group's rs and scales
  static constexpr int WORD_BYTES = SW * WSTRIDE * 4;
  static constexpr int ELEMS = MPW * NPW * 4;         // outputs per thread
};

struct Args {
  const int8_t* xq;
  const int* rs;
  const uint32_t* q4;
  const float* scale;
  float* out;
  int M, K, N, G, blocks;
  int hgb, wpg, spg, kb8, nstages;  // groups per half block, word rows per
                                    // group, k32 steps per group, word rows
                                    // per block, stages per block
  int split, vec;
  int smem, grid_m, grid_n;         // the plan's shared memory and grid (host side)
};

// a stage: k32 steps [s0, s0 + min(SUB, spg - s0)) of group g of half `half`
// of block `blk`; stages run block -> half -> group -> s0 (K order)
struct Cursor {
  int s0, g, half, blk;
};

__device__ __forceinline__ void advance(const Args& a, Cursor& c) {
  c.s0 += SUB;
  if (c.s0 < a.spg) return;
  c.s0 = 0;
  if (++c.g < a.hgb) return;
  c.g = 0;
  if (!a.split && ++c.half < 2) return;
  if (!a.split) c.half = 0;
  ++c.blk;
}

template <int NTILE, bool VEC, int NT = threads_of<NTILE>()>
__global__ void __launch_bounds__(NT) w4_mma_kernel(const Args a) {
  using TL = Tile<NTILE, NT>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int wn = warp % TL::WARPS_N, wm = warp / TL::WARPS_N;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * NTILE;
  const bool split = NTILE == 8 && a.split;    // the cluster code exists for 8 columns only
  const int rank = split ? (int)blockIdx.z : 0;
  constexpr int SLOT = TL::A_BYTES + TL::RS_BYTES + TL::WORD_BYTES;
  float* terms = reinterpret_cast<float*>(smem + NS * SLOT);   // split: rank 1's terms
  const int Kb = a.K / a.blocks;
  // int8 rows of the live m16 tiles only (the others are never read)
  const int arows = min(BM, (a.M - m0 + 15) / 16 * 16);

  // 16-byte path: each thread copies the same chunks of every stage, so its
  // sources and destinations are worked out once; a stage adds its offsets
  constexpr int C4 = NTILE / 4;                          // 16-byte chunks per word row
  constexpr int A_ITERS = (BM * SW / 4 + NT - 1) / NT;
  constexpr int W_ITERS = (SW * C4 + NT - 1) / NT;
  const int8_t* a_src[A_ITERS];
  int a_dst[A_ITERS], a_p[A_ITERS];
  bool a_on[A_ITERS], a_ok[A_ITERS];
  const uint32_t* w_src[W_ITERS];
  int w_dst[W_ITERS], w_row[W_ITERS];
  bool w_on[W_ITERS];
  const int* rs_src = a.rs;
  const float* sc_src = a.scale;
  bool rs_on = false, sc_on = false;
  if constexpr (VEC) {
#pragma unroll
    for (int k = 0; k < A_ITERS; ++k) {
      const int e = tid + k * NT, r = e / (SW / 4), row = m0 + r;
      a_p[k] = e % (SW / 4);
      a_on[k] = e < BM * SW / 4 && r < arows;
      a_ok[k] = row < a.M;
      a_src[k] = a_ok[k] ? a.xq + (size_t)row * a.K + 16 * a_p[k] : a.xq;
      a_dst[k] = r * A_STRIDE + 16 * a_p[k];
    }
#pragma unroll
    for (int k = 0; k < W_ITERS; ++k) {
      const int e = tid + k * NT, i = e / C4, c = (e % C4) * 4;
      w_on[k] = e < SW * C4 && n0 + c < a.N;
      w_row[k] = i;
      w_src[k] = a.q4 + (size_t)i * a.N + n0 + c;
      w_dst[k] = TL::A_BYTES + TL::RS_BYTES + (i * TL::WSTRIDE + c) * 4;
    }
    rs_on = tid < BM && m0 + tid < a.M;
    rs_src = a.rs + (size_t)(m0 + tid) * a.G;
    sc_on = tid >= BM && 4 * (tid - BM) < NTILE && n0 + 4 * (tid - BM) < a.N;
    sc_src = a.scale + n0 + 4 * (tid - BM);
  }

  Cursor pc = {0, 0, rank, 0};      // the producer's next stage
  auto produce = [&](int t) {
    if (t < a.nstages) {
      unsigned char* slot = smem + (t % NS) * SLOT;
      const int j0 = pc.blk * a.kb8 + pc.g * a.wpg + KW * pc.s0;   // first word row
      const int nv = min(SW, a.wpg - KW * pc.s0);                  // rows in the group
      const int k0 = pc.blk * Kb + pc.half * (Kb / 2) + 4 * (j0 - pc.blk * a.kb8);
      const int gi = (pc.blk * 2 + pc.half) * a.hgb + pc.g;        // group in K order
      const bool last = pc.s0 + SUB >= a.spg;   // the group ends in this stage
      int* rs_s = reinterpret_cast<int*>(slot + TL::A_BYTES);
      float* sc_s = reinterpret_cast<float*>(slot + TL::A_BYTES + BM * 4);
      if constexpr (VEC) {
        // rows >= M of a live tile are zero-filled; word rows >= nv and
        // columns >= N are left as they are (their A bytes are zero, their
        // outputs are not stored)
#pragma unroll
        for (int k = 0; k < A_ITERS; ++k) {
          if (!a_on[k]) continue;
          const int bytes = a_ok[k] ? 4 * min(max(nv - 4 * a_p[k], 0), 4) : 0;
          ptx::cp_async16(slot + a_dst[k], bytes ? a_src[k] + k0 : a.xq, bytes);
        }
        const size_t woff = (size_t)j0 * a.N;
#pragma unroll
        for (int k = 0; k < W_ITERS; ++k)
          if (w_on[k] && w_row[k] < nv) ptx::cp_async16(slot + w_dst[k], w_src[k] + woff, 16);
        if (last && rs_on) ptx::cp_async4(rs_s + tid, rs_src + gi, 4);
        if (last && sc_on) ptx::cp_async16(sc_s + 4 * (tid - BM), sc_src + (size_t)gi * a.N, 16);
      } else {
        for (int e = tid; e < arows * SW; e += NT) {
          const int r = e / SW, w = e % SW, row = m0 + r;
          const bool ok = row < a.M && w < nv;
          ptx::cp_async4(slot + r * A_STRIDE + 4 * w,
                         ok ? a.xq + (size_t)row * a.K + k0 + 4 * w : a.xq, ok ? 4 : 0);
        }
        if (last) {
          if (tid < BM && m0 + tid < a.M)
            ptx::cp_async4(rs_s + tid, a.rs + (size_t)(m0 + tid) * a.G + gi, 4);
          for (int c = tid; c < NTILE; c += NT)
            if (n0 + c < a.N) ptx::cp_async4(sc_s + c, a.scale + (size_t)gi * a.N + n0 + c, 4);
        }
        uint32_t* wd = reinterpret_cast<uint32_t*>(slot + TL::A_BYTES + TL::RS_BYTES);
        for (int e = tid; e < SW * NTILE; e += NT) {
          const int i = e / NTILE, c = e % NTILE;
          if (i < nv && n0 + c < a.N)
            ptx::cp_async4(wd + i * TL::WSTRIDE + c, a.q4 + (size_t)(j0 + i) * a.N + n0 + c, 4);
        }
      }
      advance(a, pc);
    }
    ptx::cp_commit();   // one group per stage, empty past the end
  };

  int dot[TL::MPW][TL::NPW][4];
  float acc[TL::MPW][TL::NPW][4];
  bool live[TL::MPW];
#pragma unroll
  for (int mi = 0; mi < TL::MPW; ++mi) {
    live[mi] = m0 + 16 * (wm * TL::MPW + mi) < a.M;
#pragma unroll
    for (int ni = 0; ni < TL::NPW; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        dot[mi][ni][e] = 0;
        acc[mi][ni][e] = 0.0f;
      }
  }

  Cursor cc = {0, 0, rank, 0};      // the consumer's stage
  auto consume = [&](int t) {
    const unsigned char* slot = smem + (t % NS) * SLOT;
    const uint32_t* W = reinterpret_cast<const uint32_t*>(slot + TL::A_BYTES + TL::RS_BYTES);
    const int nsub = min(SUB, a.spg - cc.s0);
    const int shift = 4 * cc.half;
#pragma unroll
    for (int sub = 0; sub < SUB; ++sub) {
      if (sub < nsub) {
        uint32_t b[TL::NPW][2];
#pragma unroll
        for (int ni = 0; ni < TL::NPW; ++ni) {
          const int c = (wn * TL::NPW + ni) * 8 + gid;
          b[ni][0] = (W[(KW * sub + tig) * TL::WSTRIDE + c] >> shift) & 0x0F0F0F0Fu;
          b[ni][1] = (W[(KW * sub + tig + 4) * TL::WSTRIDE + c] >> shift) & 0x0F0F0F0Fu;
        }
#pragma unroll
        for (int mi = 0; mi < TL::MPW; ++mi) {
          if (!live[mi]) continue;
          uint32_t af[4];
          ptx::ldsm_x4(af, slot + (16 * (wm * TL::MPW + mi) + (lane & 15)) * A_STRIDE +
                               32 * sub + (lane >> 4) * 16);
#pragma unroll
          for (int ni = 0; ni < TL::NPW; ++ni) ptx::mma_s8u8(dot[mi][ni], af, b[ni][0], b[ni][1]);
        }
      }
    }
    if (cc.s0 + SUB >= a.spg) {
      // the f32 chain of this group, after its last mma
      const int* rs_s = reinterpret_cast<const int*>(slot + TL::A_BYTES);
      const float* sc_s = reinterpret_cast<const float*>(slot + TL::A_BYTES + BM * 4);
      const bool keep = split && rank == 1;
#pragma unroll
      for (int mi = 0; mi < TL::MPW; ++mi) {
        if (!live[mi]) continue;
        const int r = 16 * (wm * TL::MPW + mi) + gid;
        const int rs0 = rs_s[r], rs1 = rs_s[r + 8];
#pragma unroll
        for (int ni = 0; ni < TL::NPW; ++ni) {
          const int c = (wn * TL::NPW + ni) * 8 + 2 * tig;
          const float s0 = sc_s[c], s1 = sc_s[c + 1];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float term = __fmul_rn((float)(dot[mi][ni][e] - (e < 2 ? rs0 : rs1)),
                                         (e & 1) ? s1 : s0);
            if (keep)
              terms[((size_t)cc.g * TL::ELEMS + (mi * TL::NPW + ni) * 4 + e) * NT + tid] = term;
            else
              acc[mi][ni][e] = __fadd_rn(acc[mi][ni][e], term);
            dot[mi][ni][e] = 0;
          }
        }
      }
    }
    advance(a, cc);
  };

#pragma unroll 1
  for (int t = 0; t < NS - 1; ++t) produce(t);
#pragma unroll 1
  for (int t = 0; t < a.nstages; ++t) {
    ptx::cp_wait<NS - 2>();   // stage t has landed (this thread's copies)
    __syncthreads();          // everyone's copies; stage t - 1 fully consumed
    produce(t + NS - 1);      // refills stage t - 1's slot
    consume(t);
  }
  ptx::cp_wait<0>();

  if (split) {
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();           // rank 1's high-half terms are in its shared memory
    if (rank == 0) {
      const float* rt = cluster.map_shared_rank(terms, 1);
#pragma unroll 1
      for (int g = 0; g < a.hgb; ++g)
#pragma unroll
        for (int mi = 0; mi < TL::MPW; ++mi) {
          if (!live[mi]) continue;
#pragma unroll
          for (int ni = 0; ni < TL::NPW; ++ni)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              acc[mi][ni][e] = __fadd_rn(
                  acc[mi][ni][e],
                  rt[((size_t)g * TL::ELEMS + (mi * TL::NPW + ni) * 4 + e) * NT + tid]);
        }
    }
    cluster.sync();           // rank 1 keeps its shared memory until read
    if (rank == 1) return;
  }

#pragma unroll
  for (int mi = 0; mi < TL::MPW; ++mi) {
    if (!live[mi]) continue;
#pragma unroll
    for (int ni = 0; ni < TL::NPW; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = m0 + 16 * (wm * TL::MPW + mi) + gid + 8 * (e >> 1);
        const int col = n0 + (wn * TL::NPW + ni) * 8 + 2 * tig + (e & 1);
        if (row < a.M && col < a.N) a.out[(size_t)row * a.N + col] = acc[mi][ni][e];
      }
  }
}

template <int NTILE>
int smem_bytes(const Args& a) {
  using TL = Tile<NTILE>;
  constexpr int NT = threads_of<NTILE>();
  size_t b = (size_t)NS * (TL::A_BYTES + TL::RS_BYTES + TL::WORD_BYTES);
  if (a.split) b += (size_t)a.hgb * TL::ELEMS * NT * 4;
  return b > (size_t)SMEM_MAX ? -1 : (int)b;
}

template <int NTILE, bool VEC>
int launch(const Args& a, cudaStream_t st) {
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
  if (M <= 0 || N <= 0 || blocks <= 0 || G <= 0 || K % (8 * blocks) != 0 ||
      G % (2 * blocks) != 0 || K % G != 0 || (K / G) % 4 != 0 ||
      (K / blocks / 2) % (K / G) != 0)
    return (int)cudaErrorInvalidValue;
  Args a;
  a.xq = (const int8_t*)xq;
  a.rs = (const int*)rs;
  a.q4 = (const uint32_t*)q4;
  a.scale = (const float*)scale;
  a.out = (float*)out;
  a.M = M; a.K = K; a.N = N; a.G = G; a.blocks = blocks;
  const int group = K / G;
  a.hgb = G / blocks / 2;
  a.wpg = group / 4;
  a.spg = (a.wpg + KW - 1) / KW;
  a.kb8 = K / blocks / 8;
  a.split = split != 0;
  a.vec = vec != 0;
  a.smem = smem;
  a.grid_m = grid_m;
  a.grid_n = grid_n;
  a.nstages = blocks * (a.split ? 1 : 2) * a.hgb * ((a.spg + SUB - 1) / SUB);
  // 16-byte copies need 16-byte aligned rows, groups and half blocks
  const bool aligned = K % 16 == 0 && group % 16 == 0 && (K / blocks / 2) % 16 == 0 &&
                       N % 4 == 0 && ((uintptr_t)xq & 15) == 0 && ((uintptr_t)q4 & 15) == 0;
  if ((a.vec && !aligned) || (a.split && (blocks != 1 || ntile != 8)))
    return (int)cudaErrorInvalidValue;
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
