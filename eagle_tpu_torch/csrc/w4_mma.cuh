// The w4a8 main loop on Hopper's int8 tensor cores, shared by kernels B3/B4
// (csrc/w4_matmul.cu, which store the sums) and B5 (csrc/score_topk.cu,
// which reduces them to a tile's log-softmax statistics and top-k). Each
// kernel passes its own epilogue; the loop and its order of f32 sums are one.
//
// A block computes, for its row tile m0 .. m0+BM-1 and column tile n0 ..
// n0+NTILE-1,
//   acc[m, n] = sum over scale groups g, in K order, of
//               float(dot_g(xq[m], nibbles[:, n]) - rs[m, g]) * scale[g, n]
// with int8 activations xq [M, K], rs = 8 * per-group row sums (the folded
// -8 zero point), packed int4 words q4 [K/8, N] (or blocked, flattened) and
// f32 scales [G, N]. The order of that f32 sum is the contract: one
// accumulator per output, groups in K order (block -> half -> group), each
// term rounded, then added and rounded (__fmul_rn, __fadd_rn, built with
// -fmad=false). The integer dot of a group is exact in any order, so the
// tensor cores produce it.
//
//  - mma.sync m16n8k32 s8 x u8 -> s32. A is the int8 rows; B is the biased
//    nibbles: (word >> shift) & 0x0F0F0F0F already is B's fragment (four
//    K-consecutive nibbles of one column, as ops/quant4.pack_w4 lays them
//    out), so the unpack is one AND and shift.
//  - The int8 rows of m16 tiles past M are neither copied nor read, rows >= M
//    of a live tile are zero-filled (no bytes read), and tiles past M skip
//    their mma and chain.
//  - The bytes stream through a ring of NS stages in shared memory. A stage
//    is up to SUB = 4 k32 steps of one scale group (a whole group of 128):
//    32 word rows x NTILE columns, the BM x 128 int8 rows of the same K range
//    and, in a group's last stage, the group's BM rs values and NTILE
//    scales, all by cp.async (16-byte copies; 4-byte ones where rows, groups
//    or columns are not 16-byte aligned: a separate instantiation). Each
//    thread works out the sources and destinations of its copies once,
//    before the loop, and a stage only adds its offsets. One barrier per
//    stage; the stage's position is a cursor advanced by additions.
//  - Stages never straddle a scale group: in a group shorter than 32 K
//    values or a last step that the group does not fill, the A bytes outside
//    the group are zero. The f32 chain runs after the group's last mma, per
//    C-fragment element, reading rs and scale from the stage once per group.
//  - The half-split layout (every high-half group comes after every
//    low-half group) is taken as two passes over the words: low nibbles,
//    then high nibbles. With a cluster split (B3/B4, 8-column tiles only)
//    the two passes go to two blocks: rank 1 keeps its high-half terms in
//    shared memory, rank 0 runs the low chain and then adds them in order
//    through distributed shared memory.
//
// The loop takes a `Body` as a template parameter: what a stage holds and
// what is done with it. The engines run `Engine`, whose every compile-time
// branch is the loop as B3, B4 and B5 have it. The ablation probe (B6,
// csrc/w4_ablate.cu) swaps or takes away one part at a time: the storage
// format (byte rows [K/2, N] gathered into B fragments with byte permutes),
// the unpack (raw bytes as s8), the math (bf16 mma, or column sums and no
// mma), the second pass over the words (one pass feeding both halves), and
// the f32 chain (one chain per half, or all group dots staged first).

#pragma once

#include <cooperative_groups.h>

#include "ptx.cuh"

namespace w4mma {

namespace cg = cooperative_groups;

constexpr int KW = 8;               // word rows per k32 step
constexpr int SUB = 4;              // k32 steps per stage (one group of 128)
constexpr int SW = KW * SUB;        // word rows per stage
constexpr int A_STRIDE = 4 * SW + 16;   // bytes per int8 row in a stage (+ pad)
constexpr int NS = 4;               // ring stages
constexpr int SMEM_MAX = 232448;    // 227 KB of dynamic shared memory a block

// A block of NT threads over BM rows x NTILE columns: WARPS_N warps across
// the columns, the rest across the m16 tiles.
template <int BM_, int NTILE_, int NT_, int WARPS_N_>
struct Tile {
  static constexpr int BM = BM_, NTILE = NTILE_, NT = NT_;
  static constexpr int WARPS = NT / 32;
  static constexpr int WARPS_N = WARPS_N_;
  static constexpr int WARPS_M = WARPS / WARPS_N;
  static constexpr int NPW = NTILE / 8 / WARPS_N;     // n8 tiles per warp
  static constexpr int MPW = BM / 16 / WARPS_M;       // m16 tiles per warp
  static constexpr int WSTRIDE = NTILE + 8;           // words per row (pad)
  static constexpr int A_BYTES = BM * A_STRIDE;
  static constexpr int RS_BYTES = BM * 4 + NTILE * 4; // the group's rs and scales
  static constexpr int WORD_BYTES = SW * WSTRIDE * 4;
  static constexpr int SLOT = A_BYTES + RS_BYTES + WORD_BYTES;
  static constexpr int ELEMS = MPW * NPW * 4;         // outputs per thread
  static_assert(WARPS_M * WARPS_N == WARPS && NPW * WARPS_N * 8 == NTILE &&
                    MPW * WARPS_M * 16 == BM,
                "warps must tile the block's rows and columns exactly");
  static_assert(NT >= BM + NTILE / 4, "one thread per rs value and per 4 scales");
};

// B3/B4's tile, which B6 shares: 64 rows; 8 warps for the 32- and 64-column
// tiles, 4 for the others (measured); at most 4 warps across the columns, the
// rest across the m16 tiles: every warp reads the int8 fragments of its own
// m16 tiles from shared memory, so fewer warps per row tile read them fewer
// times (measured faster)
constexpr int MAT_BM = 64;
template <int NTILE>
__host__ __device__ constexpr int mat_threads() { return NTILE == 32 || NTILE == 64 ? 256 : 128; }
template <int NTILE>
using MatTile = Tile<MAT_BM, NTILE, mat_threads<NTILE>(), (NTILE / 8 < 4 ? NTILE / 8 : 4)>;

// How the f32 chain runs: after each group (the engines'), once per half
// with scale[0] and no row sums, after the loop over every group's staged
// dot, or not at all (column sums of the nibbles, no mma).
enum Chain { PER_GROUP = 0, PER_HALF, STAGED, COLSUM };

template <bool U8_, bool UNPACK_, bool FLOAT_, bool FUSED_, bool A_LOW_, int CHAIN_>
struct Body {
  static constexpr bool U8 = U8_;          // weights as byte rows [K/2, N], not words
  static constexpr bool UNPACK = UNPACK_;  // AND and shift (false: raw bytes, s8 x s8)
  static constexpr bool FLOAT = FLOAT_;    // mma m16n8k16 bf16 -> f32 on converted operands
  static constexpr bool FUSED = FUSED_;    // one pass: low nibbles to g, high to hg + g
  static constexpr bool A_LOW = A_LOW_;    // both halves read the low half's activations
  static constexpr int CHAIN = CHAIN_;
};
using Engine = Body<false, true, false, false, false, PER_GROUP>;

// A stage under a body. `Engine`'s is TL's.
template <class TL, class B>
struct Slot {
  static constexpr int SETS = B::FUSED ? 2 : 1;          // activation ranges a stage holds
  static constexpr int A_BYTES = SETS * TL::A_BYTES;
  static constexpr int RS_BYTES = SETS * TL::RS_BYTES;
  // byte rows: the stride is an odd multiple of 16 B and rows 8..15 of every
  // 16 sit 16 B further on, so the byte loads of one B fragment (rows 4 tig
  // + j, 8 adjacent columns) fall in four different pairs of banks
  static constexpr int RSB = TL::NTILE <= 32 ? 48 : TL::NTILE + 16;
  static constexpr int W_BYTES = B::U8 ? 4 * SW * RSB + 16 : TL::WORD_BYTES;
  static constexpr int SLOT = A_BYTES + RS_BYTES + W_BYTES;
};

template <int RSB>
__device__ __forceinline__ int byte_row(int r) { return r * RSB + ((r >> 3) & 1) * 16; }

// byte rows r .. r+3 (r a multiple of 4) of column c: one B register of four
// K-consecutive bytes, put together with byte permutes
template <int RSB>
__device__ __forceinline__ uint32_t gather4(const unsigned char* w8, int r, int c) {
  const unsigned char* p = w8 + byte_row<RSB>(r) + c;
  const uint32_t x0 = p[0], x1 = p[RSB], x2 = p[2 * RSB], x3 = p[3 * RSB];
  return __byte_perm(__byte_perm(x0, x1, 0x0040), __byte_perm(x2, x3, 0x0040), 0x5410);
}

// signed bytes b, b+1 of x as a bf16 pair (exact: |value| <= 128)
__device__ __forceinline__ uint32_t bf16_pair(uint32_t x, int b) {
  __nv_bfloat162 v = __floats2bfloat162_rn((float)(int8_t)(x >> (8 * b)),
                                           (float)(int8_t)(x >> (8 * b + 8)));
  return *reinterpret_cast<uint32_t*>(&v);
}

template <bool F> struct DotOf { using T = int; };
template <> struct DotOf<true> { using T = float; };

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

// Fills `a` from the shapes and the plan; cudaErrorInvalidValue for shapes the
// loop does not take (groups straddling a half block, 16-byte copies of
// unaligned rows).
inline int make_args(Args& a, const void* xq, const void* rs, const void* q4,
                     const void* scale, void* out, int M, int K, int N, int G,
                     int blocks, int split, int vec, int smem, int grid_m, int grid_n) {
  if (M <= 0 || N <= 0 || blocks <= 0 || G <= 0 || K % (8 * blocks) != 0 ||
      G % (2 * blocks) != 0 || K % G != 0 || (K / G) % 4 != 0 ||
      (K / blocks / 2) % (K / G) != 0)
    return (int)cudaErrorInvalidValue;
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
  if (a.vec && !aligned) return (int)cudaErrorInvalidValue;
  return 0;
}

// a stage: k32 steps [s0, s0 + min(SUB, spg - s0)) of group g of half `half`
// of block `blk`; stages run block -> half -> group -> s0 (K order)
struct Cursor {
  int s0, g, half, blk;
};

// ONE_PASS: a body that takes both halves from one read of the words
template <bool ONE_PASS = false>
__device__ __forceinline__ void advance(const Args& a, Cursor& c) {
  c.s0 += SUB;
  if (c.s0 < a.spg) return;
  c.s0 = 0;
  if (++c.g < a.hgb) return;
  c.g = 0;
  const bool one = ONE_PASS || a.split;
  if (!one && ++c.half < 2) return;
  if (!one) c.half = 0;
  ++c.blk;
}

// Where a thread's C-fragment elements lie: element e of (mi, ni) is row
// row0(mi) + 8 * (e >> 1) and column col0(ni) + (e & 1) of the block's tile.
template <class TL>
struct Frag {
  int wm, wn, gid, tig;
  __device__ __forceinline__ int row0(int mi) const { return 16 * (wm * TL::MPW + mi) + gid; }
  __device__ __forceinline__ int col0(int ni) const { return (wn * TL::NPW + ni) * 8 + 2 * tig; }
};

// The main loop of one block (row tile blockIdx.x, column tile `ct`,
// cluster rank blockIdx.z when a.split), then `epi(acc, live, frag)` with the
// f32 sums in registers. Rank 1 of a split hands its terms to rank 0 and
// calls no epilogue. `smem` holds the ring (NS * Slot::SLOT bytes) and, with
// a split, rank 1's terms behind it (a STAGED body: its group dots); the
// epilogue may reuse the ring after a barrier.
template <class TL, bool VEC, class Epilogue, class B>
__device__ __forceinline__ void run(const Args& a, unsigned char* smem, Epilogue& epi, int ct) {
  constexpr int NT = TL::NT, BM = TL::BM, NTILE = TL::NTILE;
  using SL = Slot<TL, B>;
  using DotT = typename DotOf<B::FLOAT>::T;
  static_assert(!(B::U8 && VEC && NTILE < 16), "16-byte copies of byte rows need 16 columns");
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const Frag<TL> fr = {warp / TL::WARPS_N, warp % TL::WARPS_N, lane >> 2, lane & 3};
  const int wn = fr.wn, wm = fr.wm, gid = fr.gid, tig = fr.tig;
  const int m0 = blockIdx.x * BM, n0 = ct * NTILE;
  const bool split = NTILE == 8 && a.split;    // the cluster code exists for 8 columns only
  const int rank = split ? (int)blockIdx.z : 0;
  constexpr int SLOT = SL::SLOT;
  float* terms = reinterpret_cast<float*>(smem + NS * SLOT);   // split: rank 1's terms
  int* staged = reinterpret_cast<int*>(smem + NS * SLOT);      // STAGED: [G][ELEMS][NT] dots
  const int Kb = a.K / a.blocks;
  // int8 rows of the live m16 tiles only (the others are never read)
  const int arows = min(BM, (a.M - m0 + 15) / 16 * 16);

  // 16-byte path: each thread copies the same chunks of every stage, so its
  // sources and destinations are worked out once; a stage adds its offsets
  constexpr int C4 = NTILE / 4;                          // 16-byte chunks per word row
  constexpr int CB = NTILE >= 16 ? NTILE / 16 : 1;       // 16-byte chunks per byte row
  constexpr int A_ITERS = (BM * SW / 4 + NT - 1) / NT;
  constexpr int W_ITERS = (SW * C4 + NT - 1) / NT;
  constexpr int B_ITERS = (4 * SW * CB + NT - 1) / NT;
  const int8_t* a_src[A_ITERS];
  int a_dst[A_ITERS], a_p[A_ITERS];
  bool a_on[A_ITERS], a_ok[A_ITERS];
  const uint32_t* w_src[W_ITERS];
  int w_dst[W_ITERS], w_row[W_ITERS];
  bool w_on[W_ITERS];
  const unsigned char* b_src[B_ITERS];
  int b_dst[B_ITERS], b_row[B_ITERS];
  bool b_on[B_ITERS];
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
    if constexpr (B::U8) {
#pragma unroll
      for (int k = 0; k < B_ITERS; ++k) {
        const int e = tid + k * NT, i = e / CB, c = (e % CB) * 16;
        b_on[k] = e < 4 * SW * CB && n0 + c < a.N;
        b_row[k] = i;
        b_src[k] = reinterpret_cast<const unsigned char*>(a.q4) + (size_t)i * a.N + n0 + c;
        b_dst[k] = SL::A_BYTES + SL::RS_BYTES + byte_row<SL::RSB>(i) + c;
      }
    } else {
#pragma unroll
      for (int k = 0; k < W_ITERS; ++k) {
        const int e = tid + k * NT, i = e / C4, c = (e % C4) * 4;
        w_on[k] = e < SW * C4 && n0 + c < a.N;
        w_row[k] = i;
        w_src[k] = a.q4 + (size_t)i * a.N + n0 + c;
        w_dst[k] = SL::A_BYTES + SL::RS_BYTES + (i * TL::WSTRIDE + c) * 4;
      }
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
      const int k0 = pc.blk * Kb + (B::A_LOW ? 0 : pc.half * (Kb / 2)) +
                     4 * (j0 - pc.blk * a.kb8);
      const int gi = (pc.blk * 2 + pc.half) * a.hgb + pc.g;        // group in K order
      const bool last = pc.s0 + SUB >= a.spg;   // the group ends in this stage
      int* rs_s = reinterpret_cast<int*>(slot + SL::A_BYTES);
      float* sc_s = reinterpret_cast<float*>(slot + SL::A_BYTES + BM * 4);
      // FUSED: the high half's rows, rs and scales (group hg + g) beside them
      int* rs_h = reinterpret_cast<int*>(slot + SL::A_BYTES + TL::RS_BYTES);
      float* sc_h = reinterpret_cast<float*>(slot + SL::A_BYTES + TL::RS_BYTES + BM * 4);
      if constexpr (VEC) {
        // rows >= M of a live tile are zero-filled; word rows >= nv and
        // columns >= N are left as they are (their A bytes are zero, their
        // outputs are not used)
#pragma unroll
        for (int k = 0; k < A_ITERS; ++k) {
          if (!a_on[k]) continue;
          const int bytes = a_ok[k] ? 4 * min(max(nv - 4 * a_p[k], 0), 4) : 0;
          ptx::cp_async16(slot + a_dst[k], bytes ? a_src[k] + k0 : a.xq, bytes);
          if constexpr (B::FUSED)
            ptx::cp_async16(slot + TL::A_BYTES + a_dst[k],
                            bytes ? a_src[k] + k0 + Kb / 2 : a.xq, bytes);
        }
        if constexpr (B::U8) {
          const size_t boff = (size_t)4 * j0 * a.N;
#pragma unroll
          for (int k = 0; k < B_ITERS; ++k)
            if (b_on[k] && b_row[k] < 4 * nv) ptx::cp_async16(slot + b_dst[k], b_src[k] + boff, 16);
        } else {
          const size_t woff = (size_t)j0 * a.N;
#pragma unroll
          for (int k = 0; k < W_ITERS; ++k)
            if (w_on[k] && w_row[k] < nv) ptx::cp_async16(slot + w_dst[k], w_src[k] + woff, 16);
        }
        if (last && rs_on) ptx::cp_async4(rs_s + tid, rs_src + gi, 4);
        if (last && sc_on) ptx::cp_async16(sc_s + 4 * (tid - BM), sc_src + (size_t)gi * a.N, 16);
        if constexpr (B::FUSED) {
          if (last && rs_on) ptx::cp_async4(rs_h + tid, rs_src + gi + a.hgb, 4);
          if (last && sc_on)
            ptx::cp_async16(sc_h + 4 * (tid - BM), sc_src + (size_t)(gi + a.hgb) * a.N, 16);
        }
      } else {
        for (int e = tid; e < arows * SW; e += NT) {
          const int r = e / SW, w = e % SW, row = m0 + r;
          const bool ok = row < a.M && w < nv;
          ptx::cp_async4(slot + r * A_STRIDE + 4 * w,
                         ok ? a.xq + (size_t)row * a.K + k0 + 4 * w : a.xq, ok ? 4 : 0);
          if constexpr (B::FUSED)
            ptx::cp_async4(slot + TL::A_BYTES + r * A_STRIDE + 4 * w,
                           ok ? a.xq + (size_t)row * a.K + k0 + Kb / 2 + 4 * w : a.xq,
                           ok ? 4 : 0);
        }
        if (last) {
          if (tid < BM && m0 + tid < a.M)
            ptx::cp_async4(rs_s + tid, a.rs + (size_t)(m0 + tid) * a.G + gi, 4);
          for (int c = tid; c < NTILE; c += NT)
            if (n0 + c < a.N) ptx::cp_async4(sc_s + c, a.scale + (size_t)gi * a.N + n0 + c, 4);
          if constexpr (B::FUSED) {
            if (tid < BM && m0 + tid < a.M)
              ptx::cp_async4(rs_h + tid, a.rs + (size_t)(m0 + tid) * a.G + gi + a.hgb, 4);
            for (int c = tid; c < NTILE; c += NT)
              if (n0 + c < a.N)
                ptx::cp_async4(sc_h + c, a.scale + (size_t)(gi + a.hgb) * a.N + n0 + c, 4);
          }
        }
        if constexpr (B::U8) {
          // byte rows in 4-byte pieces (the wrapper asks N % 4 == 0)
          unsigned char* wd8 = slot + SL::A_BYTES + SL::RS_BYTES;
          const unsigned char* src8 = reinterpret_cast<const unsigned char*>(a.q4);
          for (int e = tid; e < 4 * SW * C4; e += NT) {
            const int i = e / C4, c = (e % C4) * 4;
            if (i < 4 * nv && n0 + c < a.N)
              ptx::cp_async4(wd8 + byte_row<SL::RSB>(i) + c,
                             src8 + (size_t)(4 * j0 + i) * a.N + n0 + c, 4);
          }
        } else {
          uint32_t* wd = reinterpret_cast<uint32_t*>(slot + SL::A_BYTES + SL::RS_BYTES);
          for (int e = tid; e < SW * NTILE; e += NT) {
            const int i = e / NTILE, c = e % NTILE;
            if (i < nv && n0 + c < a.N)
              ptx::cp_async4(wd + i * TL::WSTRIDE + c, a.q4 + (size_t)(j0 + i) * a.N + n0 + c, 4);
          }
        }
      }
      advance<B::FUSED>(a, pc);
    }
    ptx::cp_commit();   // one group per stage, empty past the end
  };

  DotT dot[TL::MPW][TL::NPW][4];
  int doth[B::FUSED ? TL::MPW : 1][B::FUSED ? TL::NPW : 1][4];   // FUSED: high half
  int cs[TL::NPW], cl[TL::NPW];                                  // COLSUM: column sums
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
        if constexpr (B::FUSED) doth[mi][ni][e] = 0;
      }
  }
  if constexpr (B::CHAIN == COLSUM) {
#pragma unroll
    for (int ni = 0; ni < TL::NPW; ++ni) cs[ni] = cl[ni] = 0;
  }

  Cursor cc = {0, 0, rank, 0};      // the consumer's stage
  auto consume = [&](int t) {
    const unsigned char* slot = smem + (t % NS) * SLOT;
    const uint32_t* W = reinterpret_cast<const uint32_t*>(slot + SL::A_BYTES + SL::RS_BYTES);
    const unsigned char* W8 = slot + SL::A_BYTES + SL::RS_BYTES;
    const int nsub = min(SUB, a.spg - cc.s0);
    const int shift = 4 * cc.half;
#pragma unroll
    for (int sub = 0; sub < SUB; ++sub) {
      if (sub < nsub) {
        uint32_t b[TL::NPW][2], bh[TL::NPW][2];
#pragma unroll
        for (int ni = 0; ni < TL::NPW; ++ni) {
          const int c = (wn * TL::NPW + ni) * 8 + gid;
          uint32_t r0, r1;
          if constexpr (B::U8) {
            r0 = gather4<SL::RSB>(W8, 4 * (KW * sub + tig), c);
            r1 = gather4<SL::RSB>(W8, 4 * (KW * sub + tig + 4), c);
          } else {
            r0 = W[(KW * sub + tig) * TL::WSTRIDE + c];
            r1 = W[(KW * sub + tig + 4) * TL::WSTRIDE + c];
          }
          if constexpr (B::FUSED) {
            b[ni][0] = r0 & 0x0F0F0F0Fu;
            b[ni][1] = r1 & 0x0F0F0F0Fu;
            bh[ni][0] = (r0 >> 4) & 0x0F0F0F0Fu;
            bh[ni][1] = (r1 >> 4) & 0x0F0F0F0Fu;
          } else if constexpr (B::UNPACK) {
            b[ni][0] = (r0 >> shift) & 0x0F0F0F0Fu;
            b[ni][1] = (r1 >> shift) & 0x0F0F0F0Fu;
          } else {
            b[ni][0] = r0;
            b[ni][1] = r1;
          }
        }
        if constexpr (B::CHAIN == COLSUM) {
          // the group's word rows from this step on; rows past them are stale
          const int left = a.wpg - KW * (cc.s0 + sub);
#pragma unroll
          for (int ni = 0; ni < TL::NPW; ++ni) {
            if (tig < left) cs[ni] = __dp4a((int)b[ni][0], 0x01010101, cs[ni]);
            if (tig + 4 < left) cs[ni] = __dp4a((int)b[ni][1], 0x01010101, cs[ni]);
          }
        } else {
#pragma unroll
          for (int mi = 0; mi < TL::MPW; ++mi) {
            if (!live[mi]) continue;
            const int arow = (16 * (wm * TL::MPW + mi) + (lane & 15)) * A_STRIDE +
                             32 * sub + (lane >> 4) * 16;
            uint32_t af[4];
            ptx::ldsm_x4(af, slot + arow);
            if constexpr (B::FLOAT) {
              // k32 as two k16 steps: the int8 fragment's bytes 4 tig + {0,1}
              // and {2,3} are the bf16 fragment's K 2 tig + {0,1} and 8 + 2
              // tig + {0,1} (one permutation of K for A and B alike)
              const uint32_t f0[4] = {bf16_pair(af[0], 0), bf16_pair(af[1], 0),
                                      bf16_pair(af[0], 2), bf16_pair(af[1], 2)};
              const uint32_t f1[4] = {bf16_pair(af[2], 0), bf16_pair(af[3], 0),
                                      bf16_pair(af[2], 2), bf16_pair(af[3], 2)};
#pragma unroll
              for (int ni = 0; ni < TL::NPW; ++ni) {
                ptx::mma_bf16(dot[mi][ni], f0, bf16_pair(b[ni][0], 0), bf16_pair(b[ni][0], 2));
                ptx::mma_bf16(dot[mi][ni], f1, bf16_pair(b[ni][1], 0), bf16_pair(b[ni][1], 2));
              }
            } else if constexpr (B::UNPACK) {
#pragma unroll
              for (int ni = 0; ni < TL::NPW; ++ni) ptx::mma_s8u8(dot[mi][ni], af, b[ni][0], b[ni][1]);
            } else {
#pragma unroll
              for (int ni = 0; ni < TL::NPW; ++ni) ptx::mma_s8s8(dot[mi][ni], af, b[ni][0], b[ni][1]);
            }
            if constexpr (B::FUSED) {
              uint32_t ah[4];
              ptx::ldsm_x4(ah, slot + TL::A_BYTES + arow);
#pragma unroll
              for (int ni = 0; ni < TL::NPW; ++ni) ptx::mma_s8u8(doth[mi][ni], ah, bh[ni][0], bh[ni][1]);
            }
          }
        }
      }
    }
    if (cc.s0 + SUB >= a.spg) {
      if constexpr (B::CHAIN == PER_GROUP) {
        // the f32 chain of this group, after its last mma
        const int* rs_s = reinterpret_cast<const int*>(slot + SL::A_BYTES);
        const float* sc_s = reinterpret_cast<const float*>(slot + SL::A_BYTES + BM * 4);
        const int* rs_h = reinterpret_cast<const int*>(slot + SL::A_BYTES + TL::RS_BYTES);
        const float* sc_h = reinterpret_cast<const float*>(slot + SL::A_BYTES + TL::RS_BYTES + BM * 4);
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
              float term;
              if constexpr (B::FLOAT)
                term = __fmul_rn(__fsub_rn(dot[mi][ni][e], (float)(e < 2 ? rs0 : rs1)),
                                 (e & 1) ? s1 : s0);
              else
                term = __fmul_rn((float)(dot[mi][ni][e] - (e < 2 ? rs0 : rs1)),
                                 (e & 1) ? s1 : s0);
              if (keep)
                terms[((size_t)cc.g * TL::ELEMS + (mi * TL::NPW + ni) * 4 + e) * NT + tid] = term;
              else
                acc[mi][ni][e] = __fadd_rn(acc[mi][ni][e], term);
              dot[mi][ni][e] = 0;
              if constexpr (B::FUSED) {
                // group hg + g right after group g
                const float th = __fmul_rn(
                    (float)(doth[mi][ni][e] - (e < 2 ? rs_h[r] : rs_h[r + 8])),
                    (e & 1) ? sc_h[c + 1] : sc_h[c]);
                acc[mi][ni][e] = __fadd_rn(acc[mi][ni][e], th);
                doth[mi][ni][e] = 0;
              }
            }
          }
        }
      } else if constexpr (B::CHAIN == STAGED) {
        const int gi = (cc.blk * 2 + cc.half) * a.hgb + cc.g;
#pragma unroll
        for (int mi = 0; mi < TL::MPW; ++mi)
#pragma unroll
          for (int ni = 0; ni < TL::NPW; ++ni)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              staged[((size_t)gi * TL::ELEMS + (mi * TL::NPW + ni) * 4 + e) * NT + tid] =
                  dot[mi][ni][e];
              dot[mi][ni][e] = 0;
            }
      } else if constexpr (B::CHAIN == PER_HALF) {
        if (cc.g == a.hgb - 1) {     // the half's one dot is complete: times scale[0]
#pragma unroll
          for (int ni = 0; ni < TL::NPW; ++ni) {
            const int c = n0 + (wn * TL::NPW + ni) * 8 + 2 * tig;
            const float s0 = __ldg(a.scale + min(c, a.N - 1));
            const float s1 = __ldg(a.scale + min(c + 1, a.N - 1));
#pragma unroll
            for (int mi = 0; mi < TL::MPW; ++mi)
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                acc[mi][ni][e] = __fadd_rn(acc[mi][ni][e],
                                           __fmul_rn((float)dot[mi][ni][e], (e & 1) ? s1 : s0));
                dot[mi][ni][e] = 0;
              }
          }
        }
      } else {   // COLSUM: the low half's sums are complete
        if (cc.g == a.hgb - 1 && cc.half == 0) {
#pragma unroll
          for (int ni = 0; ni < TL::NPW; ++ni) {
            cl[ni] = cs[ni];
            cs[ni] = 0;
          }
        }
      }
    }
    advance<B::FUSED>(a, cc);
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

  if constexpr (B::CHAIN == STAGED) {
    // one f32 reduction over the staged dots, groups in K order
#pragma unroll 1
    for (int g = 0; g < a.G; ++g)
#pragma unroll
      for (int mi = 0; mi < TL::MPW; ++mi) {
        if (!live[mi]) continue;
#pragma unroll
        for (int ni = 0; ni < TL::NPW; ++ni)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int row = min(m0 + fr.row0(mi) + 8 * (e >> 1), a.M - 1);
            const int col = min(n0 + fr.col0(ni) + (e & 1), a.N - 1);
            const int d = staged[((size_t)g * TL::ELEMS + (mi * TL::NPW + ni) * 4 + e) * NT + tid];
            acc[mi][ni][e] = __fadd_rn(
                acc[mi][ni][e], __fmul_rn((float)(d - __ldg(a.rs + (size_t)row * a.G + g)),
                                          __ldg(a.scale + (size_t)g * a.N + col)));
          }
      }
  }
  if constexpr (B::CHAIN == COLSUM) {
    // every row = f32(low column sum) + f32(high column sum); lane 4 gid + tig
    // holds part of column gid's sums, the C fragment wants columns 2 tig + {0,1}
#pragma unroll
    for (int ni = 0; ni < TL::NPW; ++ni) {
      int l = cl[ni], h = cs[ni];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      h += __shfl_xor_sync(0xffffffffu, h, 1);
      h += __shfl_xor_sync(0xffffffffu, h, 2);
      const float v = __fadd_rn(__fadd_rn(0.0f, (float)l), (float)h);
      const float v0 = __shfl_sync(0xffffffffu, v, 8 * tig);
      const float v1 = __shfl_sync(0xffffffffu, v, 8 * tig + 4);
#pragma unroll
      for (int mi = 0; mi < TL::MPW; ++mi)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][ni][e] = (e & 1) ? v1 : v0;
    }
  }

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
  epi(acc, live, fr);
}

// The engines' loop over column tile blockIdx.y.
template <class TL, bool VEC, class Epilogue>
__device__ __forceinline__ void run(const Args& a, unsigned char* smem, Epilogue& epi) {
  run<TL, VEC, Epilogue, Engine>(a, smem, epi, blockIdx.y);
}

}  // namespace w4mma
