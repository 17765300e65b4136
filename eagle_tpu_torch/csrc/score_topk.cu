// Fused draft scoring, hand-written for Hopper (sm_90a): kernel B5.
//
// Replaces: eagle_tpu/ops/score_topk.py:_score_topk_kernel (wrapper
// _score_topk_call, public score_topk_quant), the Pallas TPU kernel that
// the drafter's beam loop runs once per scoring stage when
// EngineConfig.fuse_scoring is on and the draft's lm_head is quantized.
//
// Computes, for M hidden rows against a quantized lm_head [K, V], any k <= V:
//   logits = w4: acc * sx, acc the w4a8 sum of csrc/w4_mma.cuh (ops/quant4's
//                order of f32 sums, bit for bit)
//            w8: (float(int32 dot) * sx) * scale      (ops/quant.qdense's order)
//   rounded through the hidden dtype (bf16) when the rows are bf16;
//   scores[m, j] = j-th largest logit - logsumexp(logits[m]), ids[m, j] its
//   column (int64): ordered by value descending, then index ascending
//   (exactly topk_rows(log_softmax(logits))). The logits never reach device
//   memory.
//
// What bounds it on the H100: the lm_head's bytes read once (K * V / 2 for
// w4: 65.5 MB at 4096 x 32000, about 20 us at 3.35 TB/s).
//
// What the design does about it. The TPU kernel walks the vocabulary blocks
// in order on one core and carries running max / sum / top-k in scratch.
// Hopper blocks run in parallel and carry nothing, so each block reduces its
// own column tile and the last block to finish merges the tiles, in one
// launch (w4):
//   1. `score_mma_kernel`: one block per (row tile of 16 or 32 rows, 128
//      columns) runs the main loop of B3/B4 (csrc/w4_mma.cuh: mma.sync
//      m16n8k32 s8 x u8, the cp.async ring, the f32 chain after each group),
//      8 warps across the columns. Its epilogue scales the sums by the row
//      scales, rounds them through bf16 where the rows are bf16, masks
//      columns >= V and parks the tile's logits in shared memory. One warp
//      per row then reduces them to the tile's max, its sum of
//      exp(logit - max) and its k best (value, index) pairs, written to a
//      workspace. The winners are picked with the warp's integer reductions
//      (__reduce_max_sync / __reduce_min_sync) on order-preserving keys of
//      the values, not with shuffles.
//   2. The last block of a row tile to finish (an atomic counter per row
//      tile, which it resets) merges, one warp per row: the global max and
//      the rescaled sum over the tiles (each lane issues the loads of eight
//      tiles before it uses any), then the top-k. A tile whose best
//      candidate is not among the k best tiles' best candidates holds
//      nothing of the top-k (k tiles have a candidate ahead of all of its
//      own), so the merge first picks the k leading tiles by their heads,
//      then the k best of those tiles' k * k candidates (k <= 16: at most
//      256, eight a lane, in registers). For 16 < k <= 128 the warp runs a
//      k-way merge of the T tiles' sorted lists instead: each round takes
//      the best of the tiles' heads, and the winning tile's head moves to
//      its next candidate, which its owning lane loaded in an earlier round
//      (a tile's head and next candidate sit in the warp's shared memory, so
//      the load of the one after is off the round's path). Indices are
//      unique, so the order (value desc, index asc) is total and the result
//      does not depend on how the tiles were cut or in which order they
//      finished.
//   Rows past 32 take more row tiles on the grid (each with its own merge
//   counter); every row tile reads the head once.
// The plan (row tile, 16-byte copies, merge, shared memory, grid) is the wrapper's
// (ops/score_topk.score_plan); a launch checks it and refuses any other.
//
// k > 128 (past one column tile's candidates) takes a second route, in the
// same entry points, with two launches:
//   1. the tile pass writes the M x V logits (rounded as above) to a
//      workspace instead of reducing them: `score_logits_kernel` runs the w4
//      main loop with a store epilogue; the w8 tile kernel stores its tile;
//   2. `select_kernel`, one block of 1024 threads a row: the row's
//      logsumexp (max, then sum of exp), then an exact radix select of the
//      k-th best (key, index) pair, 8 bits a pass from the top of a 64-bit
//      key (the value's order-preserving key, then the complement of the
//      index: ties go to the lower index), stopping as soon as every
//      candidate left is taken; the k winners are gathered (an atomic
//      counter in shared memory) and put in order by a bitonic sort, in
//      shared memory up to 8192 of them, past that in a workspace.
//   What bounds it: the logits' round trip (8 bytes a logit) and the
//   selection's passes over each row (in L2 at V = 32000).
//
// The w8 head keeps its first body: a tile kernel of 64 columns (byte
// gathers with stride V, four rows' bytes per dp4a) and a merge kernel of
// one block per row (k rounds over every tile's k candidates, for any M and
// k <= 128). It runs at small sizes only.

#include <cuda_bf16.h>
#include <math_constants.h>

#include "w4_mma.cuh"

namespace {

constexpr int BIG_I = 0x7fffffff;       // the column of a masked slot
constexpr unsigned NONE = 0xffffffffu;  // the column of an empty slot (key 0)
constexpr unsigned FULL = 0xffffffffu;

// ---------------------------------------------------------------------------
// w4: the tile pass on int8 tensor cores, the merge in the same launch
// ---------------------------------------------------------------------------

constexpr int S_NTILE = 128;            // columns per block
constexpr int S_NT = 256;               // 8 warps, all across the columns
constexpr int S_WARPS = S_NT / 32;
constexpr int LD = S_NTILE + 8;         // floats per row of the logits tile
constexpr int MERGE_CHUNK = 8;          // tiles a merging lane loads at once
constexpr int SMALL_K = 16;             // k up to which the merge holds its candidates in registers
constexpr int MAX_K = 128;              // one column tile; past it, the select route
constexpr int SEL_NT = 1024;            // threads of a select block (one row)
constexpr int SORT_SMEM = 8192;         // candidates the select sorts in shared memory

template <int BM>
using STile = w4mma::Tile<BM, S_NTILE, S_NT, S_WARPS>;

// an unsigned key that orders like the float (-0 and +0 get one key)
__device__ __forceinline__ unsigned key_of(float v) {
  const unsigned b = __float_as_uint(v + 0.0f);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__device__ __forceinline__ float value_of(unsigned key) {
  return __uint_as_float((key & 0x80000000u) ? (key & 0x7fffffffu) : ~key);
}

// (key desc, index asc): is (k, i) ahead of (bk, bi)?
__device__ __forceinline__ bool ahead(unsigned k, unsigned i, unsigned bk, unsigned bi) {
  return k > bk || (k == bk && i < bi);
}

// the warp's best (key, index) of every lane's, in every lane
__device__ __forceinline__ void warp_best(unsigned& key, unsigned& idx) {
  const unsigned kmax = __reduce_max_sync(FULL, key);
  idx = __reduce_min_sync(FULL, key == kmax ? idx : NONE);
  key = kmax;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL, v, off));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(FULL, v, off);
  return v;
}

struct Score {
  const float* sx;    // [M] row scales
  float* stat;        // [M, T, 2]: tile max, tile sum of exp(logit - max)
  unsigned* ckey;     // [M, T, k]: a tile's k best, as keys
  int* cidx;          // [M, T, k]: their columns
  int* counters;      // [row tiles], zero on entry and on exit
  float* scores;      // [M, k]
  long long* ids;     // [M, k]
  int V, k, cast_bf16, T;
};

struct ScoreParams {
  w4mma::Args a;      // the main loop's (a.N = V, a.out unused)
  Score s;
};

// the epilogue of the main loop: the tile's logits into shared memory
// [BM][LD], masked columns as -inf
template <class TL>
struct Logits {
  float* sl;
  const float* sx;
  int M, V, cast_bf16;
  __device__ __forceinline__ void operator()(float (&acc)[TL::MPW][TL::NPW][4],
                                             bool (&live)[TL::MPW],
                                             const w4mma::Frag<TL>& fr) const {
    const int m0 = blockIdx.x * TL::BM, n0 = blockIdx.y * TL::NTILE;
    __syncthreads();    // the ring's last stage is fully read: its memory takes the logits
#pragma unroll
    for (int mi = 0; mi < TL::MPW; ++mi) {
      if (!live[mi]) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int rl = fr.row0(mi) + 8 * h, row = m0 + rl;
        const float s = row < M ? __ldg(sx + row) : 0.0f;
#pragma unroll
        for (int ni = 0; ni < TL::NPW; ++ni) {
          const int cl = fr.col0(ni);
          float v[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            v[e] = -CUDART_INF_F;
            if (row < M && n0 + cl + e < V) {
              v[e] = __fmul_rn(acc[mi][ni][2 * h + e], s);
              if (cast_bf16) v[e] = __bfloat162float(__float2bfloat16_rn(v[e]));
            }
          }
          *reinterpret_cast<float2*>(sl + rl * LD + cl) = make_float2(v[0], v[1]);
        }
      }
    }
  }
};

// one warp: row `rl` of the tile's logits -> its max, sum of exp and k best
__device__ __forceinline__ void tile_topk(const Score& s, const float* sl, int rl, int m,
                                          int tile, int lane) {
  const int n0 = tile * S_NTILE, k = s.k;
  float v[4];
  unsigned key[4], idx[4], kmax = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int c = lane + 32 * j;
    v[j] = sl[rl * LD + c];
    key[j] = key_of(v[j]);
    idx[j] = n0 + c < s.V ? (unsigned)(n0 + c) : (unsigned)BIG_I;
    kmax = max(kmax, key[j]);
  }
  const float tmax = value_of(__reduce_max_sync(FULL, kmax));
  float tsum = 0.0f;
#pragma unroll
  for (int j = 0; j < 4; ++j) tsum += expf(v[j] - tmax);
  tsum = warp_sum(tsum);
  const size_t slot = (size_t)m * s.T + tile;
  if (lane == 0) {
    s.stat[2 * slot] = tmax;
    s.stat[2 * slot + 1] = tsum;
  }
  for (int j = 0; j < k; ++j) {
    unsigned bk = key[0], bi = idx[0];
#pragma unroll
    for (int q = 1; q < 4; ++q)
      if (ahead(key[q], idx[q], bk, bi)) { bk = key[q]; bi = idx[q]; }
    warp_best(bk, bi);
    if (lane == 0) {
      s.ckey[slot * k + j] = bk;
      s.cidx[slot * k + j] = (int)bi;
    }
    // the winner leaves the pool (masked slots are alike and leave together)
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (key[q] == bk && idx[q] == bi) { key[q] = 0; idx[q] = NONE; }
  }
}

// is (k, i) strictly behind (pk, pi)?
__device__ __forceinline__ bool behind(unsigned k, unsigned i, unsigned pk, unsigned pi) {
  return k < pk || (k == pk && i > pi);
}

// one warp: the row's log-sum-exp over the tiles' max and sum, and every
// tile's head (BIG: and the candidate after it) into the warp's shared memory
template <bool BIG>
__device__ __forceinline__ float row_lse(const Score& s, int m, unsigned* hk, unsigned* hi,
                                         unsigned* nk, unsigned* ni, int lane) {
  const int T = s.T, k = s.k;
  const float* st = s.stat + (size_t)m * T * 2;
  const size_t base = (size_t)m * T * k;
  // the tiles' max and sum and their heads, MERGE_CHUNK tiles a lane at a
  // time: all of a chunk's loads are issued before any is used
  float lm = -CUDART_INF_F, ls = 0.0f;   // this lane's max, sum of exp(. - lm)
  for (int t0 = lane; t0 < T; t0 += 32 * MERGE_CHUNK) {
    float tm[MERGE_CHUNK], ts[MERGE_CHUNK];
    unsigned kk[MERGE_CHUNK], ii[MERGE_CHUNK], k2[MERGE_CHUNK], i2[MERGE_CHUNK];
#pragma unroll
    for (int q = 0; q < MERGE_CHUNK; ++q) {
      const int t = t0 + 32 * q;
      tm[q] = -CUDART_INF_F;
      ts[q] = 0.0f;
      if (t < T) {
        tm[q] = __ldcg(st + 2 * t);
        ts[q] = __ldcg(st + 2 * t + 1);
        kk[q] = __ldcg(s.ckey + base + (size_t)t * k);
        ii[q] = (unsigned)__ldcg(s.cidx + base + (size_t)t * k);
        if constexpr (BIG) {
          k2[q] = __ldcg(s.ckey + base + (size_t)t * k + 1);
          i2[q] = (unsigned)__ldcg(s.cidx + base + (size_t)t * k + 1);
        }
      }
    }
    float cm = lm;                       // finite: tile t0 exists
#pragma unroll
    for (int q = 0; q < MERGE_CHUNK; ++q) cm = fmaxf(cm, tm[q]);
    ls *= expf(lm - cm);
#pragma unroll
    for (int q = 0; q < MERGE_CHUNK; ++q) {
      const int t = t0 + 32 * q;
      ls += ts[q] * expf(tm[q] - cm);
      if (t < T) {
        hk[t] = kk[q];
        hi[t] = ii[q];
        if constexpr (BIG) {
          nk[t] = k2[q];
          ni[t] = i2[q];
        }
      }
    }
    lm = cm;
  }
  const float gmax = warp_max(lm);
  return gmax + logf(warp_sum(ls * expf(lm - gmax)));
}

// one warp, k <= SMALL_K: the tiles' partials of row m -> scores and ids.
// hk / hi: T unsigned each of shared memory, the warp's own.
__device__ __forceinline__ void merge_row(const Score& s, int m, unsigned* hk,
                                          unsigned* hi, int lane) {
  const int T = s.T, k = s.k;
  const size_t base = (size_t)m * T * k;
  const float lse = row_lse<false>(s, m, hk, hi, nullptr, nullptr, lane);
  __syncwarp();

  // the nsel tiles whose heads lead: lane j < nsel holds the j-th
  const int nsel = min(k, T);
  unsigned pk = FULL, pi = 0;
  int mine = 0;
  for (int j = 0; j < nsel; ++j) {
    unsigned bk = 0, bi = NONE;
#pragma unroll 8
    for (int t = lane; t < T; t += 32) {
      const unsigned kk = hk[t], ii = hi[t];
      if (behind(kk, ii, pk, pi) && ahead(kk, ii, bk, bi)) { bk = kk; bi = ii; }
    }
    warp_best(bk, bi);
    if (lane == j) mine = (int)(bi / S_NTILE);
    pk = bk;
    pi = bi;
  }
  // their nsel * k <= 256 candidates, 8 a lane
  unsigned ck[8], ci[8];
  const int C = nsel * k;
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    const int e = lane + 32 * q;
    const int tile = __shfl_sync(FULL, mine, (e / k) & 31);
    ck[q] = 0;
    ci[q] = NONE;
    if (e < C) {
      const size_t off = base + (size_t)tile * k + e % k;
      ck[q] = __ldcg(s.ckey + off);
      ci[q] = (unsigned)__ldcg(s.cidx + off);
    }
  }
  pk = FULL;
  pi = 0;
  for (int j = 0; j < k; ++j) {
    unsigned bk = 0, bi = NONE;
#pragma unroll
    for (int q = 0; q < 8; ++q)
      if (behind(ck[q], ci[q], pk, pi) && ahead(ck[q], ci[q], bk, bi)) { bk = ck[q]; bi = ci[q]; }
    warp_best(bk, bi);
    if (lane == 0) {
      s.scores[(size_t)m * k + j] = value_of(bk) - lse;
      s.ids[(size_t)m * k + j] = (long long)bi;
    }
    pk = bk;
    pi = bi;
  }
}

// one warp, SMALL_K < k <= MAX_K: a k-way merge of the T tiles' sorted lists
// of k. `sh`: 5 T words of shared memory, the warp's own: each tile's head
// and next candidate (key, index) and the position of that next one. Tile t
// belongs to lane t % 32, which alone reads and writes its entries (a round
// needs no barrier, which would wait for the lane's loads in flight): it
// moves its head on when it wins and loads the candidate after into
// registers, written to shared memory only when one of its tiles wins again.
__device__ __forceinline__ void merge_row_big(const Score& s, int m, unsigned* sh, int lane) {
  const int T = s.T, k = s.k;
  unsigned *hk = sh, *hi = sh + T, *nk = sh + 2 * T, *ni = sh + 3 * T;
  int* pos = reinterpret_cast<int*>(sh + 4 * T);
  const size_t base = (size_t)m * T * k;
  const float lse = row_lse<true>(s, m, hk, hi, nk, ni, lane);
  for (int t = lane; t < T; t += 32) pos[t] = 1;
  bool pend = false;            // a loaded candidate not yet in shared memory
  int pt = 0;
  unsigned pk = 0, pi = 0;
  for (int j = 0; j < k; ++j) {
    unsigned bk = 0, bi = NONE;
#pragma unroll 4
    for (int t = lane; t < T; t += 32) {
      const unsigned kk = hk[t], ii = hi[t];
      if (ahead(kk, ii, bk, bi)) { bk = kk; bi = ii; }
    }
    warp_best(bk, bi);
    if (lane == 0) {
      s.scores[(size_t)m * k + j] = value_of(bk) - lse;
      s.ids[(size_t)m * k + j] = (long long)bi;
    }
    const int t = (int)(bi / S_NTILE);   // a real column: k <= V
    if ((t & 31) == lane) {
      if (pend) {
        nk[pt] = pk;
        ni[pt] = pi;
        pend = false;
      }
      hk[t] = nk[t];
      hi[t] = ni[t];
      const int p = ++pos[t];
      if (p < k) {
        pk = __ldcg(s.ckey + base + (size_t)t * k + p);
        pi = (unsigned)__ldcg(s.cidx + base + (size_t)t * k + p);
        pt = t;
        pend = true;
      } else {
        nk[t] = 0;
        ni[t] = NONE;
      }
    }
  }
}

template <int BM, bool VEC, bool BIG>
__global__ void __launch_bounds__(S_NT) score_mma_kernel(const __grid_constant__ ScoreParams p) {
  using TL = STile<BM>;
  extern __shared__ __align__(16) unsigned char smem[];
  const Score& s = p.s;
  float* sl = reinterpret_cast<float*>(smem);
  Logits<TL> epi = {sl, s.sx, p.a.M, s.V, s.cast_bf16};
  w4mma::run<TL, VEC>(p.a, smem, epi);
  __syncthreads();      // the tile's logits are in shared memory

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int m0 = blockIdx.x * BM, rows = min(BM, p.a.M - m0);
  for (int r = warp; r < rows; r += S_WARPS) tile_topk(s, sl, r, m0 + r, blockIdx.y, lane);

  __threadfence();
  __syncthreads();
  int last = 0;
  if (threadIdx.x == 0) {
    int* cnt = s.counters + blockIdx.x;
    last = atomicAdd(cnt, 1) == (int)gridDim.y - 1;
    if (last) *cnt = 0;                        // ready for the next launch
  }
  if (!__syncthreads_or(last)) return;
  __threadfence();
  if constexpr (BIG) {
    unsigned* sh = reinterpret_cast<unsigned*>(smem) + (size_t)warp * 5 * s.T;
    for (int r = warp; r < rows; r += S_WARPS) merge_row_big(s, m0 + r, sh, lane);
  } else {
    unsigned* hk = reinterpret_cast<unsigned*>(smem) + (size_t)warp * 2 * s.T;
    for (int r = warp; r < rows; r += S_WARPS) merge_row(s, m0 + r, hk, hk + s.T, lane);
  }
}

// ---------------------------------------------------------------------------
// k > MAX_K: the logits to a workspace, then an exact select per row
// ---------------------------------------------------------------------------

// the epilogue of the select route: the tile's logits (as Logits rounds
// them) to out [M, V]
template <class TL>
struct LogitsOut {
  float* out;
  const float* sx;
  int M, V, cast_bf16;
  __device__ __forceinline__ void operator()(float (&acc)[TL::MPW][TL::NPW][4],
                                             bool (&live)[TL::MPW],
                                             const w4mma::Frag<TL>& fr) const {
    const int m0 = blockIdx.x * TL::BM, n0 = blockIdx.y * TL::NTILE;
#pragma unroll
    for (int mi = 0; mi < TL::MPW; ++mi) {
      if (!live[mi]) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + fr.row0(mi) + 8 * h;
        if (row >= M) continue;
        const float s = __ldg(sx + row);
#pragma unroll
        for (int ni = 0; ni < TL::NPW; ++ni)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = n0 + fr.col0(ni) + e;
            if (col >= V) continue;
            float v = __fmul_rn(acc[mi][ni][2 * h + e], s);
            if (cast_bf16) v = __bfloat162float(__float2bfloat16_rn(v));
            out[(size_t)row * V + col] = v;
          }
      }
    }
  }
};

template <int BM, bool VEC>
__global__ void __launch_bounds__(S_NT) score_logits_kernel(const __grid_constant__ ScoreParams p,
                                                            float* __restrict__ logits) {
  using TL = STile<BM>;
  extern __shared__ __align__(16) unsigned char smem[];
  LogitsOut<TL> epi = {logits, p.s.sx, p.a.M, p.s.V, p.s.cast_bf16};
  w4mma::run<TL, VEC>(p.a, smem, epi);
}

// the block's reduction of one float (max or sum) into every thread
template <bool MAX>
__device__ __forceinline__ float block_reduce(float v, float* red) {
  v = MAX ? warp_max(v) : warp_sum(v);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();                      // red is free
  if (lane == 0) red[warp] = v;
  __syncthreads();
  v = lane < SEL_NT / 32 ? red[lane] : (MAX ? -CUDART_INF_F : 0.0f);
  return MAX ? warp_max(v) : warp_sum(v);
}

// (the value's key, the complement of the index): ordered like (value desc,
// index asc), unique per row
__device__ __forceinline__ unsigned long long sel_key(float v, int i) {
  return ((unsigned long long)key_of(v) << 32) | (unsigned)~i;
}

// One block per row of logits [M, V]: scores [M, k] = the k best logits in
// (value desc, index asc) order minus the row's logsumexp, ids [M, k] their
// columns. gbuf: [M, n2] 8-byte scratch, read only when n2 > SORT_SMEM.
__global__ void __launch_bounds__(SEL_NT) select_kernel(
    const float* __restrict__ logits, unsigned long long* __restrict__ gbuf,
    float* __restrict__ scores, long long* __restrict__ ids, int V, int k, int n2) {
  extern __shared__ __align__(16) unsigned long long sbuf[];
  __shared__ int hist[256];
  __shared__ float red[SEL_NT / 32];
  __shared__ int digit, left, taken, count;
  const int tid = threadIdx.x, m = blockIdx.x;
  const float* row = logits + (size_t)m * V;

  // the row's logsumexp
  float mx = -CUDART_INF_F;
  for (int i = tid; i < V; i += SEL_NT) mx = fmaxf(mx, row[i]);
  mx = block_reduce<true>(mx, red);
  float sum = 0.0f;
  for (int i = tid; i < V; i += SEL_NT) sum += expf(row[i] - mx);
  const float lse = mx + logf(block_reduce<false>(sum, red));

  // radix select of the k-th best key: `prefix` holds its top bits so far,
  // `kk` how many of the keys under the prefix are still to take
  unsigned long long prefix = 0, pmask = 0;
  int kk = k;
  for (int shift = 56; shift >= 0; shift -= 8) {
    for (int b = tid; b < 256; b += SEL_NT) hist[b] = 0;
    __syncthreads();
    for (int i = tid; i < V; i += SEL_NT) {
      const unsigned long long key = sel_key(row[i], i);
      if ((key & pmask) == prefix) atomicAdd(&hist[(key >> shift) & 255], 1);
    }
    __syncthreads();
    if (tid == 0) {
      int above = 0, b = 255;
      while (above + hist[b] < kk) above += hist[b--];
      digit = b;
      left = kk - above;          // to take among the keys of this digit
      taken = hist[b];
    }
    __syncthreads();
    prefix |= (unsigned long long)digit << shift;
    pmask |= 255ull << shift;
    kk = left;
    if (taken == kk) break;       // every key under the prefix is taken
  }

  // gather the k winners (key >= the prefix under the mask), then sort them
  unsigned long long* buf = n2 <= SORT_SMEM ? sbuf : gbuf + (size_t)m * n2;
  if (tid == 0) count = 0;
  __syncthreads();
  for (int i = tid; i < V; i += SEL_NT) {
    const unsigned long long key = sel_key(row[i], i);
    if ((key & pmask) >= prefix) buf[atomicAdd(&count, 1)] = key;
  }
  for (int i = k + tid; i < n2; i += SEL_NT) buf[i] = 0;   // below every key
  __syncthreads();
  for (int size = 2; size <= n2; size <<= 1)
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = tid; i < n2 / 2; i += SEL_NT) {
        const int lo = 2 * i - (i & (stride - 1)), hi = lo + stride;
        const unsigned long long a = buf[lo], b = buf[hi];
        if (((lo & size) == 0) == (a < b)) {     // descending runs where lo & size == 0
          buf[lo] = b;
          buf[hi] = a;
        }
      }
      __syncthreads();
    }
  for (int j = tid; j < k; j += SEL_NT) {
    const unsigned long long key = buf[j];
    scores[(size_t)m * k + j] = value_of((unsigned)(key >> 32)) - lse;
    ids[(size_t)m * k + j] = (long long)(unsigned)~(unsigned)key;
  }
}

int select_smem(int n2) { return n2 <= SORT_SMEM ? n2 * 8 : 0; }

int launch_select(const float* logits, unsigned long long* gbuf, void* scores, void* ids,
                  int M, int V, int k, cudaStream_t st) {
  static bool smem_attr = false;
  int n2 = 1;
  while (n2 < k) n2 <<= 1;
  if (!smem_attr) {
    const cudaError_t e = cudaFuncSetAttribute(
        select_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SORT_SMEM * 8);
    if (e != cudaSuccess) return (int)e;
    smem_attr = true;
  }
  select_kernel<<<M, SEL_NT, select_smem(n2), st>>>(logits, gbuf, (float*)scores,
                                                    (long long*)ids, V, k, n2);
  return (int)cudaGetLastError();
}

template <int BM>
int ring_smem() { return w4mma::NS * STile<BM>::SLOT; }

template <int BM, bool VEC>
int launch_logits(const ScoreParams& p, float* logits, cudaStream_t st) {
  static bool smem_attr = false;
  if (p.a.smem != ring_smem<BM>() || p.a.grid_m != (p.a.M + BM - 1) / BM ||
      p.a.grid_n != p.s.T)
    return (int)cudaErrorInvalidValue;
  if (!smem_attr) {
    cudaError_t e = cudaFuncSetAttribute(score_logits_kernel<BM, VEC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         w4mma::SMEM_MAX);
    if (e != cudaSuccess) return (int)e;
    smem_attr = true;
  }
  score_logits_kernel<BM, VEC><<<dim3(p.a.grid_m, p.a.grid_n), S_NT, p.a.smem, st>>>(p, logits);
  return (int)cudaGetLastError();
}

// the kernel's shared memory: the ring, the logits tile, then the merge's
// heads (BIG: heads, next candidates and positions), one region after the
// other in time
template <int BM, bool BIG>
int score_smem(int T) {
  const size_t ring = (size_t)w4mma::NS * STile<BM>::SLOT;
  const size_t logits = (size_t)BM * LD * 4;
  const size_t heads = (size_t)S_WARPS * T * (BIG ? 20 : 8);
  const size_t b = ring > logits ? (ring > heads ? ring : heads) : (logits > heads ? logits : heads);
  return b > (size_t)w4mma::SMEM_MAX ? -1 : (int)b;
}

template <int BM, bool VEC, bool BIG>
int launch_score(const ScoreParams& p, cudaStream_t st) {
  static bool smem_attr = false;
  // the wrapper's plan must be this layout's
  if (p.a.smem != score_smem<BM, BIG>(p.s.T) || p.a.grid_m != (p.a.M + BM - 1) / BM ||
      p.a.grid_n != p.s.T)
    return (int)cudaErrorInvalidValue;
  if (!smem_attr) {
    cudaError_t e = cudaFuncSetAttribute(score_mma_kernel<BM, VEC, BIG>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         w4mma::SMEM_MAX);
    if (e != cudaSuccess) return (int)e;
    smem_attr = true;
  }
  score_mma_kernel<BM, VEC, BIG><<<dim3(p.a.grid_m, p.a.grid_n), S_NT, p.a.smem, st>>>(p);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// w8: a dp4a tile kernel and a merge kernel
// ---------------------------------------------------------------------------

constexpr int NT8 = 256;
constexpr int COLS_PER_WARP = 8;
constexpr int KSLICES = 4;
constexpr int TILE8 = (NT8 / 32) * COLS_PER_WARP;       // 64 columns

__device__ __forceinline__ bool ahead_f(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

__device__ __forceinline__ void warp_best_f(float& bv, int& bi) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(FULL, bv, off);
    const int oi = __shfl_xor_sync(FULL, bi, off);
    if (ahead_f(ov, oi, bv, bi)) { bv = ov; bi = oi; }
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
  for (int i = kslice; i < kw; i += KSLICES) {
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
    dot[m] += __shfl_xor_sync(FULL, dot[m], 8);
    dot[m] += __shfl_xor_sync(FULL, dot[m], 16);
  }
}

// q8: int8 [K, V], scale f32 [V]. Workspace: stat [M, T, 2] (tile max, tile
// sum), cval / cidx [M, T, k].
template <int MT>
__global__ void __launch_bounds__(NT8) score_tile_kernel(
    const int* __restrict__ xw, const float* __restrict__ sx,
    const int8_t* __restrict__ q8, const float* __restrict__ scale,
    float* __restrict__ stat, float* __restrict__ cval, int* __restrict__ cidx, int M,
    int K, int V, int k, int cast_bf16, float* __restrict__ logits) {
  __shared__ float sl[MT][TILE8];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int tile = blockIdx.y, T = gridDim.y;
  const int c = warp * COLS_PER_WARP + (lane & 7);
  const int col = tile * TILE8 + c;
  const int kslice = lane >> 3;
  const int m0 = blockIdx.x * MT;
  const int n = min(col, V - 1);

  float logit[MT];
  int dot[MT];
  w8_column_dot<MT>(xw, q8, M, K, V, m0, n, kslice, dot);
  const float s = __ldg(scale + n);
#pragma unroll
  for (int m = 0; m < MT; ++m)
    logit[m] = __fmul_rn(
        __fmul_rn(__int2float_rn(dot[m]), __ldg(sx + min(m0 + m, M - 1))), s);
  if (kslice == 0) {
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      float v = logit[m];
      if (cast_bf16) v = __bfloat162float(__float2bfloat16_rn(v));
      sl[m][c] = col < V ? v : -CUDART_INF_F;
      // the select route (k > MAX_K) takes the logits themselves
      if (logits != nullptr && col < V && m0 + m < M) logits[(size_t)(m0 + m) * V + col] = v;
    }
  }
  if (logits != nullptr) return;
  __syncthreads();

  for (int m = warp; m < MT; m += NT8 / 32) {
    if (m0 + m >= M) break;
    float v0 = sl[m][lane], v1 = sl[m][lane + 32];
    int i0 = tile * TILE8 + lane, i1 = i0 + 32;
    if (i0 >= V) i0 = BIG_I;
    if (i1 >= V) i1 = BIG_I;
    float tmax = fmaxf(v0, v1);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      tmax = fmaxf(tmax, __shfl_xor_sync(FULL, tmax, off));
    float tsum = expf(v0 - tmax) + expf(v1 - tmax);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      tsum += __shfl_xor_sync(FULL, tsum, off);
    const size_t slot = (size_t)(m0 + m) * T + tile;
    if (lane == 0) {
      stat[2 * slot] = tmax;
      stat[2 * slot + 1] = tsum;
    }
    for (int j = 0; j < k; ++j) {
      float bv = v0;
      int bi = i0;
      if (ahead_f(v1, i1, bv, bi)) { bv = v1; bi = i1; }
      warp_best_f(bv, bi);
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

__global__ void __launch_bounds__(NT8) score_merge_kernel(
    const float* __restrict__ stat, const float* __restrict__ cval,
    const int* __restrict__ cidx, float* __restrict__ scores,
    long long* __restrict__ ids, int T, int k) {
  __shared__ float sv[NT8 / 32];
  __shared__ int si[NT8 / 32];
  __shared__ float bcast_v;
  __shared__ int bcast_i;
  const int m = blockIdx.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float* st = stat + (size_t)m * T * 2;

  // global max over the tiles
  float gmax = -CUDART_INF_F;
  for (int t = tid; t < T; t += NT8) gmax = fmaxf(gmax, st[2 * t]);
  gmax = warp_max(gmax);
  if (lane == 0) sv[warp] = gmax;
  __syncthreads();
  gmax = sv[0];
#pragma unroll
  for (int w = 1; w < NT8 / 32; ++w) gmax = fmaxf(gmax, sv[w]);
  __syncthreads();

  // sum of exp(logit - gmax): tile sums rescaled to the global max
  float sum = 0.0f;
  for (int t = tid; t < T; t += NT8) sum += st[2 * t + 1] * expf(st[2 * t] - gmax);
  sum = warp_sum(sum);
  if (lane == 0) sv[warp] = sum;
  __syncthreads();
  sum = sv[0];
#pragma unroll
  for (int w = 1; w < NT8 / 32; ++w) sum += sv[w];
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
    for (int e = tid; e < C; e += NT8) {
      const float v = cv[e];
      const int i = ci[e];
      if (ahead_f(pv, pi, v, i) && ahead_f(v, i, bv, bi)) { bv = v; bi = i; }
    }
    warp_best_f(bv, bi);
    if (lane == 0) { sv[warp] = bv; si[warp] = bi; }
    __syncthreads();
    if (tid == 0) {
      bv = sv[0];
      bi = si[0];
      for (int w = 1; w < NT8 / 32; ++w)
        if (ahead_f(sv[w], si[w], bv, bi)) { bv = sv[w]; bi = si[w]; }
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
void launch_w8_tiles(const void* xq, const void* sx, const void* q8, const void* scale,
                     float* stat, float* cval, int* cidx, int M, int K, int V, int k,
                     int cast_bf16, int T, float* logits, cudaStream_t st) {
  dim3 grid((M + MT - 1) / MT, T);
  score_tile_kernel<MT><<<grid, NT8, 0, st>>>((const int*)xq, (const float*)sx,
                                               (const int8_t*)q8, (const float*)scale, stat,
                                               cval, cidx, M, K, V, k, cast_bf16, logits);
}

// the select route's workspace: the logits [M, V] f32, then (k past
// SORT_SMEM) the sort's [M, n2] 8-byte keys, 8-byte aligned
size_t select_ws_logits(int M, int V) { return ((size_t)M * V + 1) / 2 * 2; }

}  // namespace

// w4. xq: int8 [M, K]; rs: int32 [M, G]; sx: f32 [M]; q4: int32 [K/8, V];
// scale: f32 [G, V]; ws: 4-byte workspace, [M * T * (2 + 2k)] with T the
// column tiles for k <= 128, else the select route's (select_ws_logits(M, V)
// words, then 2 M n2 words when n2 = k rounded up to a power of two exceeds
// 8192); counters: int32 [row tiles], zero (and left zero); scores: f32
// [M, k]; ids: int64 [M, k]; any k <= V; any M. bm (rows per block), vec
// (16-byte copies), smem (dynamic shared memory, bytes; the merge it holds
// follows k; the select route's is the ring alone) and the grid's row and
// column tiles are ops/score_topk.score_plan's. Returns cudaGetLastError()
// after the launches (0 = launched).
extern "C" int score_topk_launch(const void* xq, const void* rs, const void* sx,
                                 const void* q4, const void* scale, void* ws,
                                 void* counters, void* scores, void* ids, int M, int K,
                                 int V, int G, int k, int cast_bf16, int bm, int vec,
                                 int smem, int grid_m, int grid_n, void* stream) {
  if (M <= 0 || k <= 0 || k > V || grid_n > 65535)
    return (int)cudaErrorInvalidValue;
  ScoreParams p;
  const int err = w4mma::make_args(p.a, xq, rs, q4, scale, nullptr, M, K, V, G, 1, 0, vec,
                                   smem, grid_m, grid_n);
  if (err != 0) return err;
  const int T = (V + S_NTILE - 1) / S_NTILE;
  p.s.sx = (const float*)sx;
  p.s.stat = (float*)ws;
  p.s.ckey = (unsigned*)ws + (size_t)M * T * 2;
  p.s.cidx = (int*)ws + (size_t)M * T * (2 + k);
  p.s.counters = (int*)counters;
  p.s.scores = (float*)scores;
  p.s.ids = (long long*)ids;
  p.s.V = V;
  p.s.k = k;
  p.s.cast_bf16 = cast_bf16;
  p.s.T = T;
  cudaStream_t st = (cudaStream_t)stream;
  if (k > MAX_K) {
    float* lg = (float*)ws;
    unsigned long long* gbuf = (unsigned long long*)(lg + select_ws_logits(M, V));
#define LOGITS(BM) \
  (p.a.vec ? launch_logits<BM, true>(p, lg, st) : launch_logits<BM, false>(p, lg, st))
    const int e = bm == 16 ? LOGITS(16) : bm == 32 ? LOGITS(32) : (int)cudaErrorInvalidValue;
#undef LOGITS
    return e != 0 ? e : launch_select(lg, gbuf, scores, ids, M, V, k, st);
  }
#define SCORE(BM, BIG) (p.a.vec ? launch_score<BM, true, BIG>(p, st) : launch_score<BM, false, BIG>(p, st))
  const bool big = k > SMALL_K;
  switch (bm) {
    case 16: return big ? SCORE(16, true) : SCORE(16, false);
    case 32: return big ? SCORE(32, true) : SCORE(32, false);
    default: return (int)cudaErrorInvalidValue;
  }
#undef SCORE
}

// w8. xq: int8 [M, K]; sx: f32 [M]; q8: int8 [K, V]; scale: f32 [V]; ws:
// 4-byte workspace, [M * T * (2 + 2k)] with T = ceil(V / 64) for k <= 128,
// else the select route's (as for w4); scores f32 [M, k], ids int64 [M, k];
// any k <= V. Two launches (tiles, then merge or select); returns
// cudaGetLastError() after them.
extern "C" int score_topk_w8_launch(const void* xq, const void* sx, const void* q8,
                                    const void* scale, void* ws, void* scores, void* ids,
                                    int M, int K, int V, int k, int cast_bf16,
                                    void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int T = (V + TILE8 - 1) / TILE8;
  if (M <= 0 || k <= 0 || k > V || K % 8 != 0 || T > 65535)
    return (int)cudaErrorInvalidValue;
  const bool select = k > MAX_K;
  float* stat = (float*)ws;
  float* cval = stat + (size_t)M * T * 2;
  int* cidx = (int*)(cval + (size_t)M * T * k);
  float* lg = select ? (float*)ws : nullptr;
#define TILES(MT) launch_w8_tiles<MT>(xq, sx, q8, scale, stat, cval, cidx, M, K, V, k, \
                                      cast_bf16, T, lg, st)
  if (M == 1) TILES(1);
  else if (M == 2) TILES(2);
  else if (M <= 4) TILES(4);
  else if (M <= 8) TILES(8);
  else TILES(16);
#undef TILES
  int err = (int)cudaGetLastError();
  if (err != 0) return err;
  if (select)
    return launch_select(lg, (unsigned long long*)(lg + select_ws_logits(M, V)), scores, ids,
                         M, V, k, st);
  score_merge_kernel<<<M, NT8, 0, st>>>(stat, cval, cidx, (float*)scores, (long long*)ids,
                                        T, k);
  return (int)cudaGetLastError();
}
