// Tree-verify attention over a batch of sequences, hand-written for Hopper
// (sm_90a).
//
// Replaces: eagle_tpu/ops/pallas_attn.py:_tree_attn_kernel (wrapper
// tree_attention), the Pallas TPU kernel that the JAX engine runs for every
// layer's verify attention when ModelConfig.attn_impl == "pallas_tree", and
// which its batched rounds vmap over the batch.
//
// Computes what pallas_attn.tree_attention_xla computes, for each batch row:
//   q [T, nq, d] attends to the committed prefix k/v_cache [n_kv, S, d]
//   (rows < start) and to the tree's fresh k/v_tree [Tk, n_kv, d] under the
//   [T, Tk] ancestor mask; out [T, nq*d]. Scores in f32 with scale d^-0.5,
//   masked entries at -1e30, softmax in f32, out = acc / max(l, 1e-30).
//   A launch takes B rows, each with its own start (an int32 [B] on the
//   device): the batch is one more grid axis, so a batched round launches
//   once per layer whatever B is.
//
// What bounds it on the H100: at the main path's shapes (T = Tk = 61, nq = 32,
// n_kv = 8, d = 128) one launch reads the prefix K/V once, 4 KiB per row and
// head pair, and does 4*T*nq*(start+Tk)*d flops: ~1.1 GFLOP against ~4 MB at
// start = 1024, about 270 flop/byte, just under the bf16 tensor-core ridge
// (~295): the bytes bound it, 1.6 us.
//
// Head widths: every kernel here is built at a padded width HD of 64, 128 or
// 256 and takes the true width d <= HD at launch (80 and 96 run at 128, 160
// to 256 at 256); the bf16 kernel has a second instantiation for d == HD
// (the widths of the main paths) with d known at compile time. Loads past d
// fill shared memory with zeros, which changes no score and no output
// column; stores write d columns. Rows of a width that is not a multiple of
// 16 bytes are not 16-byte aligned, and load element by element instead of
// by 16-byte copies.
//
// bf16 (the serving path), `tree_attn_mma_kernel`:
//  - Products on tensor cores: mma.sync m16n8k16 bf16 with f32 accumulators
//    for Q.K^T and for P.V. The TPU kernel keeps P in f32 and contracts it
//    with V cast to f32; P rounded once to bf16 would be off by ~2^-9 per
//    weight, so P goes in as a hi + lo pair of bf16 values (two P.V mma per
//    tile), which carries ~16 bits of P's 24.
//  - A block is 64 query rows (4 warps x m16) of one kv head: the T*g rows
//    of a kv head are t-major (t, group) rows, so the g query heads that
//    share a kv head share each K/V tile.
//  - A split over the prefix: grid (row tiles, prefix chunks + 1, n_kv), one
//    block per chunk of CHUNK keys and one for the tree's own keys; the row
//    tiles are the fast axis, so the blocks that read one chunk run together
//    and share it in L2. The grid comes from host-known numbers only: the
//    wrapper's plan (ops/attn_kernels.tree_plan) passes it, and the launch
//    only checks it. `start` stays on the device (no host sync). A block
//    whose chunk lies wholly at or past `start` exits at once, before any
//    load or store.
//  - K/V tiles of 64 keys reach shared memory through cp.async in two
//    stages (the next tile loads while this one is used).
//  - Each block writes its partial (row max m, row sum l, unnormalised acc)
//    to scratch the wrapper allocates; the last block of a (head, row tile)
//    to finish, found by an atomic counter in a wrapper-held int32 buffer
//    that it resets to 0, merges the partials in chunk order and writes
//    out: one launch per call.
//
//  - At HD = 256 the Q fragments (64 registers a thread) are read from
//    shared memory at each key tile instead of held, so the 128 f32
//    accumulators fit, and key tiles are 32 keys (the score fragments take
//    16 registers, not 32): with both, ptxas spills nothing; the merge walks
//    the columns in slices of 64. Shared memory: (64 + 4 * 32) rows of 264
//    bf16 = 99 KiB.
//
// f32 (every attention of an f32 engine on the card, and every head_dim >
// 256), `tree_attn_kernel`: FP32 FMA products (TF32 tensor cores would not
// hold an f32 tolerance of 1e-5), one block per (kv head, 16 query rows),
// products from shared memory (dynamic: 83.5 KiB at HD = 256). It is
// row-exact: a row's output depends only on its query and its key sequence
// (the cache rows below start, then the fresh keys its mask row selects, at
// virtual positions start, start + 1, ...), summed in 32-position groups at
// multiples of 32, so a tree verify, a one-token step and a prefill in any
// chunks give a row the same bits (see the kernel). Past 256 columns (either
// stored type, run at HD = 256) Q.K is summed over the head in passes of 256
// columns and a block keeps one 256-column slice of the output (grid.z = the
// slice), so registers and shared memory do not grow with d.

#include "ptx.cuh"

namespace {

constexpr int R = 16;      // query rows per block
constexpr int BK = 32;     // keys per tile (one per lane in the score phase)
constexpr int NT = 128;    // threads per block (4 warps x 4 rows each)
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store_f(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// Copy the 16-byte chunk at column c of a source row (VEC elements) into f32
// shared memory: zeros when row is null and past the row's d columns; one
// 16-byte load when the row is 16-byte aligned (vec) and the chunk lies
// inside it, else element by element.
template <typename T>
__device__ __forceinline__ void load_chunk(float* dst, const T* row, int c, int d, bool vec) {
  constexpr int VEC = 16 / sizeof(T);
  if (row != nullptr && vec && c + VEC <= d) {
    uint4 raw = *reinterpret_cast<const uint4*>(row + c);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < VEC; i += 4)
      *reinterpret_cast<float4*>(dst + i) =
          make_float4(to_f(e[i]), to_f(e[i + 1]), to_f(e[i + 2]), to_f(e[i + 3]));
    return;
  }
#pragma unroll
  for (int i = 0; i < VEC; ++i)
    dst[i] = (row != nullptr && c + i < d) ? to_f(row[c + i]) : 0.f;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <int D>
__host__ __device__ constexpr int f32_smem() {   // Qs, Ks, Vs, Ps, m / l / a
  return ((R + 2 * BK) * (D + 4) + R * (BK + 1) + 3 * R) * 4;
}

// One group of BK virtual positions for query row r, one warp, lane = the
// position mod BK. x: the lane's scaled score, or NEG_INF where the row has
// no key. Updates the row's max, sum and rescale factor (lane 0) and parks
// its weights in Ps. Every rounding is explicit, so no call site can
// contract a product into a sum: a group's arithmetic depends only on its
// scores and on the row's (m, l) before it.
__device__ __forceinline__ void group_softmax(float x, int r, int lane, float* m_s, float* l_s,
                                              float* a_s, float* Ps) {
  const float m_prev = m_s[r];
  const float m_new = fmaxf(m_prev, warp_max(x));
  const float p = expf(__fsub_rn(x, m_new));
  Ps[r * (BK + 1) + lane] = p;
  const float psum = warp_sum(p);
  __syncwarp();
  if (lane == 0) {
    const float a = expf(__fsub_rn(m_prev, m_new));
    a_s[r] = a;
    l_s[r] = __fadd_rn(__fmul_rn(a, l_s[r]), psum);
    m_s[r] = m_new;
  }
}

// columns c .. c + 3 of a source row as f32 (zeros past d; a null row is
// all zeros): one 16-byte load for aligned f32 rows, else element by element
template <typename T>
__device__ __forceinline__ float4 load4(const T* row, int c, int d, bool vec4) {
  if (row == nullptr) return make_float4(0.f, 0.f, 0.f, 0.f);
  if constexpr (sizeof(T) == 4) {
    if (vec4 && c + 4 <= d) return *reinterpret_cast<const float4*>(row + c);
  }
  float e[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) e[i] = c + i < d ? to_f(row[c + i]) : 0.f;
  return make_float4(e[0], e[1], e[2], e[3]);
}

__device__ __forceinline__ float dot4(float4 q, float4 k, float s) {
  s = fmaf(q.x, k.x, s);
  s = fmaf(q.y, k.y, s);
  s = fmaf(q.z, k.z, s);
  return fmaf(q.w, k.w, s);
}

// The f32 body, row-exact: a query row's output depends only on q and on
// its key sequence, the cache rows [0, start) in order and then the fresh
// keys its mask row selects in index order, at virtual positions start,
// start + 1, ... (its rank among them). Keys are taken in groups of BK
// virtual positions at multiples of BK, lane = position mod BK, with an
// online softmax per group; a group past a row's last key changes nothing
// (its weights are exactly 0 and its rescale exactly 1). So a verify row
// at depth j reproduces, bit for bit, the one-token step at position
// start + j on a cache holding its ancestors, and a prefill row the same
// row of a prefill in other chunks, whatever T, Tk, start, the batch or
// the row's place in its block are.
//
// Groups wholly below the block's shared boundary are read once for all R
// rows from shared tiles: the full groups of cache rows, or, when every
// row's mask row is a prefix of the fresh keys (a causal prefill, a
// one-token step), every group, fresh keys included, since rank is then
// the key index. Past it (a tree verify) each row walks its own groups:
// its warp finds the fresh keys of each group by ballots over its mask row,
// and each lane reads its key's K and V rows from global memory.
template <typename T, int D>
__global__ void __launch_bounds__(NT) tree_attn_kernel(
    const T* __restrict__ q, const T* __restrict__ kc, const T* __restrict__ vc,
    const T* __restrict__ kt, const T* __restrict__ vt,
    const uint8_t* __restrict__ mask, const int* __restrict__ start_ptr,
    T* __restrict__ out, int Tq, int Tk, int nq, int nkv, int S_rows, int S, int d,
    float scale) {
  // batch row b, kv head h; move every pointer to row b
  const int b = blockIdx.x / nkv, h = blockIdx.x % nkv;
  q += (size_t)b * Tq * nq * d;
  out += (size_t)b * Tq * nq * d;
  kc += (size_t)b * nkv * S * d;
  vc += (size_t)b * nkv * S * d;
  kt += (size_t)b * Tk * nkv * d;
  vt += (size_t)b * Tk * nkv * d;
  mask += (size_t)b * Tq * Tk;
  constexpr int DP = D + 4;          // padded f32 row: 16B-aligned, conflict-free
  constexpr int VEC = 16 / sizeof(T);
  constexpr int CH = D / VEC;        // 16-byte chunks per row
  constexpr int NC = D / 32;         // float4 output chunks per thread

  extern __shared__ __align__(16) float fsm[];
  float* Qs = fsm;
  float* Ks = Qs + R * DP;
  float* Vs = Ks + BK * DP;
  float* Ps = Vs + BK * DP;
  float* m_s = Ps + R * (BK + 1);
  float* l_s = m_s + R;
  float* a_s = l_s + R;
  __shared__ int cnt_s[R], pre_s[R];  // fresh keys a row sees; its mask row is a prefix
  __shared__ int key_s[R * BK];       // per-row walk: the key at each position
  const bool vec = (d * (int)sizeof(T)) % 16 == 0;   // rows 16-byte aligned
  const bool vec4 = d % 4 == 0;

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = nq / nkv;
  const int rows = Tq * g;
  const int r0 = blockIdx.y * R;
  const int c0 = blockIdx.z * D;     // this block's output columns: c0 .. c0 + D
  const bool q_kept = d <= D;        // one pass covers the head: Q loads once
  int start = start_ptr[b];
  start = start < 0 ? 0 : (start > S_rows ? S_rows : start);

  // each warp counts the fresh keys of its 4 rows (block rows 4w..4w+3)
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = warp * 4 + i, gr = r0 + r;
    int cnt = 0, last = -1;
    if (gr < rows) {
      const uint8_t* mrow = mask + (size_t)(gr / g) * Tk;
      for (int kb = 0; kb < Tk; kb += BK) {
        const unsigned bits = __ballot_sync(0xffffffffu, kb + lane < Tk && mrow[kb + lane] != 0);
        cnt += __popc(bits);
        if (bits) last = kb + 31 - __clz(bits);
      }
    }
    if (lane == 0) { cnt_s[r] = cnt; pre_s[r] = last + 1 == cnt; }
  }

  // Q tile, columns cp .. cp + D: block row r is global row r0 + r = (t, j)
  // -> q head h*g + j
  auto q_row = [&](int r) -> const T* {
    const int gr = r0 + r;
    return gr < rows ? q + ((size_t)(gr / g) * nq + h * g + gr % g) * d : nullptr;
  };
  auto load_q = [&](int cp) {
    for (int e = tid; e < R * CH; e += NT) {
      const int r = e / CH, c = (e % CH) * VEC;
      load_chunk<T>(Qs + r * DP + c, q_row(r), cp + c, d, vec);
    }
  };
  if (q_kept) load_q(0);
  if (tid < R) { m_s[tid] = NEG_INF; l_s[tid] = 0.f; }
  __syncthreads();
  int max_cnt = 0;
  bool all_prefix = true;
#pragma unroll
  for (int r = 0; r < R; ++r) { max_cnt = max(max_cnt, cnt_s[r]); all_prefix &= pre_s[r] != 0; }
  const int vend = start + max_cnt;                       // past every row's last key
  const int shared_end = all_prefix ? vend : start / BK * BK;

  // PV-phase ownership: row pr, float4 column chunks pc + 32*i
  const int pr = tid >> 3;
  const int pc = (tid & 7) * 4;
  float4 acc[NC];
#pragma unroll
  for (int i = 0; i < NC; ++i) acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  // acc = acc * a + sum over the group's positions, in order, of P * V; vrow
  // gives position kk's V row at column cc
  auto accumulate = [&](auto vrow) {
    const float a = a_s[pr];
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      acc[i].x = __fmul_rn(acc[i].x, a); acc[i].y = __fmul_rn(acc[i].y, a);
      acc[i].z = __fmul_rn(acc[i].z, a); acc[i].w = __fmul_rn(acc[i].w, a);
    }
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      const float p = Ps[pr * (BK + 1) + kk];
#pragma unroll
      for (int i = 0; i < NC; ++i) {
        const float4 vv = vrow(kk, pc + 32 * i);
        acc[i].x = fmaf(p, vv.x, acc[i].x);
        acc[i].y = fmaf(p, vv.y, acc[i].y);
        acc[i].z = fmaf(p, vv.z, acc[i].z);
        acc[i].w = fmaf(p, vv.w, acc[i].w);
      }
    }
  };

  // shared groups: position v is cache row v below start, else fresh key
  // v - start (reached only when every row's mask is a prefix)
  for (int v0 = 0; v0 < shared_end; v0 += BK) {
    // scores: warp w owns rows 4w..4w+3, lane owns position v0 + lane; summed
    // over the head in passes of D columns, the first of which also loads
    // the block's V columns
    float s[4] = {0.f, 0.f, 0.f, 0.f};
    for (int cp = 0; cp < d; cp += D) {
      __syncthreads();  // previous tile / pass fully consumed
      if (!q_kept) load_q(cp);
      for (int e = tid; e < BK * CH; e += NT) {
        const int r = e / CH, c = (e % CH) * VEC;
        const int v = v0 + r;
        const T* ks = nullptr;
        const T* vs = nullptr;
        if (v < start) {
          ks = kc + ((size_t)h * S + v) * d;
          vs = vc + ((size_t)h * S + v) * d;
        } else if (v < vend) {
          ks = kt + ((size_t)(v - start) * nkv + h) * d;
          vs = vt + ((size_t)(v - start) * nkv + h) * d;
        }
        load_chunk<T>(Ks + r * DP + c, ks, cp + c, d, vec);
        if (cp == 0) load_chunk<T>(Vs + r * DP + c, vs, c0 + c, d, vec);
      }
      __syncthreads();
#pragma unroll 8
      for (int c = 0; c < D; c += 4) {
        const float4 kv = *reinterpret_cast<const float4*>(Ks + lane * DP + c);
#pragma unroll
        for (int i = 0; i < 4; ++i)
          s[i] = dot4(*reinterpret_cast<const float4*>(Qs + (warp * 4 + i) * DP + c), kv, s[i]);
      }
    }
    const int v = v0 + lane;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = warp * 4 + i;
      const bool ok = v < start + cnt_s[r];
      group_softmax(ok ? __fmul_rn(s[i], scale) : NEG_INF, r, lane, m_s, l_s, a_s, Ps);
    }
    __syncthreads();
    accumulate([&](int kk, int cc) {
      return *reinterpret_cast<const float4*>(Vs + kk * DP + cc);
    });
  }

  // per-row groups: position v of row r is cache row v below start, else
  // the fresh key of rank v - start in its mask row (key_s; -1: none). Each
  // warp keeps, for each of its rows, where its ballots over the mask row
  // stand: the 32-key chunk and the rank of its first key.
  int cur_c[4] = {0, 0, 0, 0}, cur_base[4] = {0, 0, 0, 0};
  for (int v0 = shared_end; v0 < vend; v0 += BK) {
    const int v = v0 + lane;
    const int jlo = v0 - start;                  // rank at lane 0 (may be < 0)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = warp * 4 + i, gr = r0 + r;
      const int cnt = cnt_s[r];
      key_s[r * BK + lane] = -1;
      __syncwarp();
      if (gr < rows) {
        const uint8_t* mrow = mask + (size_t)(gr / g) * Tk;
        const int need = min(jlo + BK, cnt);   // ranks below this are due by now
        while (cur_base[i] < need) {
          const int k = cur_c[i] * BK + lane;
          const bool sel = k < Tk && mrow[k] != 0;
          const unsigned bits = __ballot_sync(0xffffffffu, sel);
          const int rank = cur_base[i] + __popc(bits & ((1u << lane) - 1u));
          if (sel && rank >= jlo && rank < jlo + BK) key_s[r * BK + rank - jlo] = k;
          const int n = __popc(bits);
          if (cur_base[i] + n > jlo + BK) break;   // the chunk reaches the next group
          cur_base[i] += n;
          ++cur_c[i];
        }
      }
      __syncwarp();
      const int key = key_s[r * BK + lane];
      const T* krow = v < start ? kc + ((size_t)h * S + v) * d
                    : (gr < rows && v - start < cnt && key >= 0)
                        ? kt + ((size_t)key * nkv + h) * d : nullptr;
      float sc = 0.f;
      const T* qg = q_row(r);
      for (int cp = 0; cp < d; cp += D) {
#pragma unroll 8
        for (int c = 0; c < D; c += 4) {
          const float4 qv = q_kept ? *reinterpret_cast<const float4*>(Qs + r * DP + c)
                                   : load4<T>(qg, cp + c, d, vec4);
          sc = dot4(qv, load4<T>(krow, cp + c, d, vec4), sc);
        }
      }
      // the V row each position reads, for the accumulation below
      key_s[r * BK + lane] = krow == nullptr ? -1 : v < start ? -2 - v : key;
      group_softmax(krow != nullptr ? __fmul_rn(sc, scale) : NEG_INF, r, lane, m_s, l_s,
                    a_s, Ps);
    }
    __syncthreads();
    accumulate([&](int kk, int cc) {
      const int code = key_s[pr * BK + kk];
      const T* vrow = code == -1 ? nullptr
                    : code <= -2 ? vc + ((size_t)h * S + (-2 - code)) * d
                                 : vt + ((size_t)code * nkv + h) * d;
      return load4<T>(vrow, c0 + cc, d, vec4);
    });
    __syncthreads();  // key_s and Ps fully read before the next group
  }
  __syncthreads();

  const int gr = r0 + pr;
  if (gr < rows) {
    const float inv = 1.f / fmaxf(l_s[pr], 1e-30f);
    T* o = out + (size_t)(gr / g) * nq * d + (size_t)(h * g + gr % g) * d;
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      const int c = c0 + pc + 32 * i;
      const float v[4] = {__fmul_rn(acc[i].x, inv), __fmul_rn(acc[i].y, inv),
                          __fmul_rn(acc[i].z, inv), __fmul_rn(acc[i].w, inv)};
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (c + e < d) store_f(o + c + e, v[e]);
    }
  }
}

template <typename T, int D>
int launch(const void* q, const void* kc, const void* vc, const void* kt,
           const void* vt, const void* mask, const void* start, void* out,
           int B, int Tq, int Tk, int nq, int nkv, int S_rows, int S, int d, int slices,
           float scale, cudaStream_t stream) {
  static bool smem_attr = false;
  if (!smem_attr) {
    const cudaError_t e = cudaFuncSetAttribute(
        tree_attn_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, f32_smem<D>());
    if (e != cudaSuccess) return (int)e;
    smem_attr = true;
  }
  const int rows = Tq * (nq / nkv);
  const dim3 grid(B * nkv, (rows + R - 1) / R, slices);
  tree_attn_kernel<T, D><<<grid, NT, f32_smem<D>(), stream>>>(
      (const T*)q, (const T*)kc, (const T*)vc, (const T*)kt, (const T*)vt,
      (const uint8_t*)mask, (const int*)start, (T*)out, Tq, Tk, nq, nkv, S_rows, S, d,
      scale);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16: tensor cores, split over the prefix, merge by the last block
// ---------------------------------------------------------------------------

constexpr int BR = 64;                 // query rows per block: 4 warps x m16
constexpr int CHUNK = 256;             // prefix keys per block
// keys per tile (one cp.async stage): 64, and 32 at HD = 256, where the
// score fragments of 64 keys (32 registers) would push the 128 f32
// accumulators into spills
template <int HD>
__host__ __device__ constexpr int key_tile() { return HD > 128 ? 32 : 64; }
// bf16 per shared row: HD + 8 (144, 272 and 528 B at 64, 128 and 256) keeps
// rows 16-byte aligned and puts the 8 rows an ldmatrix reads 16 bytes apart
// mod 128 B, so they hit eight different bank groups at every width
template <int HD>
__host__ __device__ constexpr int row_stride() { return HD + 8; }
template <int HD>
__host__ __device__ constexpr int mma_smem() {   // Q + two stages of K and V
  return (BR + 4 * key_tile<HD>()) * row_stride<HD>() * 2;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// the 8 bf16 at column ch of a global row into shared memory: a 16-byte
// cp.async when the row is 16-byte aligned (vec) or the chunk is wholly
// absent (zero fill; `any` is a valid address that is not read), else
// element by element with zeros past the row's d columns
__device__ __forceinline__ void load8(__nv_bfloat16* dst, const __nv_bfloat16* row, int ch,
                                      int d, bool vec, const __nv_bfloat16* any) {
  if (row == nullptr || ch >= d || vec) {
    const bool in = row != nullptr && ch < d;
    ptx::cp_async16(dst, in ? row + ch : any, in ? 16 : 0);
    return;
  }
#pragma unroll
  for (int e = 0; e < 8; ++e) dst[e] = ch + e < d ? row[ch + e] : __float2bfloat16(0.f);
}

// p -> bf16 hi + bf16 lo with hi + lo = p to ~2^-17 relative
__device__ __forceinline__ void split_bf16(float p0, float p1, uint32_t& hi, uint32_t& lo) {
  __nv_bfloat162 h = __floats2bfloat162_rn(p0, p1);
  hi = *reinterpret_cast<uint32_t*>(&h);
  lo = pack_bf16(p0 - __low2float(h), p1 - __high2float(h));
}

template <int HD, bool EXACT>
__global__ void __launch_bounds__(NT) tree_attn_mma_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ kc,
    const __nv_bfloat16* __restrict__ vc, const __nv_bfloat16* __restrict__ kt,
    const __nv_bfloat16* __restrict__ vt, const uint8_t* __restrict__ mask,
    const int* __restrict__ start_ptr, __nv_bfloat16* __restrict__ out,
    float* __restrict__ part_acc, float* __restrict__ part_ml, int* __restrict__ counters,
    int Tq, int Tk, int nq, int nkv, int S_rows, int head_stride, int d_in, float scale) {
  // EXACT: the head width is the padded one (64, 128, 256), known at compile
  // time, so row offsets are shifts and no load or store takes a ragged path
  const int d = EXACT ? HD : d_in;
  constexpr int RS = row_stride<HD>();
  // the Q fragments stay in registers up to HD = 128; at 256 they are read
  // from shared memory each key tile (the accumulators take 128 registers)
  constexpr bool QREG = HD <= 128;
  constexpr int KT = key_tile<HD>();
  static_assert(HD % 16 == 0 && (RS * 2) % 16 == 0, "rows of whole ldmatrix tiles, 16-byte aligned");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int is_last;
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Ks = Qs + BR * RS;
  __nv_bfloat16* Vs = Ks + 2 * KT * RS;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  // blockIdx.z = b * nkv + h: batch row b, kv head h; every pointer moves to row b
  const int rt = blockIdx.x, c = blockIdx.y, bh = blockIdx.z;
  const int b = bh / nkv, h = bh % nkv;
  const int n_rt = gridDim.x, n_chunks = gridDim.y - 1;
  const int g = nq / nkv, rows = Tq * g, r0 = rt * BR;
  q += (size_t)b * Tq * nq * d;
  out += (size_t)b * Tq * nq * d;
  kc += (size_t)b * nkv * head_stride * d;
  vc += (size_t)b * nkv * head_stride * d;
  kt += (size_t)b * Tk * nkv * d;
  vt += (size_t)b * Tk * nkv * d;
  mask += (size_t)b * Tq * Tk;
  int start = start_ptr[b];
  start = start < 0 ? 0 : (start > S_rows ? S_rows : start);
  const int n_act = (start + CHUNK - 1) / CHUNK;       // prefix chunks with keys
  const bool tree = c == n_chunks;
  if (!tree && c >= n_act) return;
  const bool vec = d % 8 == 0;                         // rows 16-byte aligned
  const int kbeg = tree ? 0 : c * CHUNK;
  const int kend = tree ? Tk : min(kbeg + CHUNK, start);
  const int ntiles = (kend - kbeg + KT - 1) / KT;

  // Q tile: block row r is global row r0 + r = (t, j) -> q head h*g + j
  for (int e = tid; e < BR * (HD / 8); e += NT) {
    const int r = e / (HD / 8), ch = (e % (HD / 8)) * 8, gr = r0 + r;
    const __nv_bfloat16* row =
        gr < rows ? q + ((size_t)(gr / g) * nq + h * g + gr % g) * d : nullptr;
    load8(Qs + r * RS + ch, row, ch, d, vec, q);
  }
  auto load_tile = [&](int i) {
    if (i < ntiles) {
      __nv_bfloat16* kd = Ks + (i & 1) * KT * RS;
      __nv_bfloat16* vd = Vs + (i & 1) * KT * RS;
      for (int e = tid; e < KT * (HD / 8); e += NT) {
        const int r = e / (HD / 8), ch = (e % (HD / 8)) * 8, key = kbeg + i * KT + r;
        const bool ok = key < kend;
        const size_t off = tree ? ((size_t)key * nkv + h) * d
                                : ((size_t)h * head_stride + key) * d;
        load8(kd + r * RS + ch, ok ? (tree ? kt : kc) + off : nullptr, ch, d, vec, kc);
        load8(vd + r * RS + ch, ok ? (tree ? vt : vc) + off : nullptr, ch, d, vec, vc);
      }
    }
    ptx::cp_commit();
  };
  load_tile(0);     // in one group with Q
  load_tile(1);

  const int wrow = warp * 16;
  uint32_t qf[QREG ? HD / 16 : 1][4];
  float m_r[2] = {NEG_INF, NEG_INF}, l_r[2] = {0.f, 0.f};
  float acc[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

#pragma unroll 1
  for (int i = 0; i < ntiles; ++i) {
    ptx::cp_wait<1>();
    __syncthreads();
    if (QREG && i == 0) {
#pragma unroll
      for (int kk = 0; kk < (QREG ? HD / 16 : 0); ++kk)
        ptx::ldsm_x4(qf[kk], Qs + (wrow + (lane & 15)) * RS + kk * 16 + (lane >> 4) * 8);
    }
    const __nv_bfloat16* Kt = Ks + (i & 1) * KT * RS;
    const __nv_bfloat16* Vt = Vs + (i & 1) * KT * RS;

    // S = Q K^T for 16 rows x 64 keys per warp
    float s[KT / 8][4];
#pragma unroll
    for (int j = 0; j < KT / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      uint32_t qa[4];
      if constexpr (!QREG)
        ptx::ldsm_x4(qa, Qs + (wrow + (lane & 15)) * RS + kk * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int jp = 0; jp < KT / 16; ++jp) {
        uint32_t b[4];
        ptx::ldsm_x4(b, Kt + (jp * 16 + (lane & 7) + (lane >> 4) * 8) * RS + kk * 16 +
                            ((lane >> 3) & 1) * 8);
        if constexpr (QREG) {
          ptx::mma_bf16(s[2 * jp], qf[kk], b[0], b[1]);
          ptx::mma_bf16(s[2 * jp + 1], qf[kk], b[2], b[3]);
        } else {
          ptx::mma_bf16(s[2 * jp], qa, b[0], b[1]);
          ptx::mma_bf16(s[2 * jp + 1], qa, b[2], b[3]);
        }
      }
    }

    // mask, scale, online softmax (rows gid and gid + 8 of the warp's 16)
    const int kb = kbeg + i * KT;
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int j = 0; j < KT / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = kb + 8 * j + 2 * tig + (e & 1);
        bool ok = key < kend;
        if (tree) {
          const int gr = r0 + wrow + gid + 8 * (e >> 1);
          ok = ok && gr < rows && mask[(size_t)(gr / g) * Tk + key] != 0;
        }
        s[j][e] = ok ? s[j][e] * scale : NEG_INF;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
      }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m_r[r], mx[r]);
      alpha[r] = expf(m_r[r] - m_new);
      m_r[r] = m_new;
      l_r[r] *= alpha[r];
    }
#pragma unroll
    for (int j = 0; j < KT / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = expf(s[j][e] - m_r[e >> 1]);
        l_r[e >> 1] += s[j][e];
      }
#pragma unroll
    for (int n = 0; n < HD / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] *= alpha[e >> 1];

    // acc += P V, P as bf16 hi + lo; the S accumulators of key tiles 2k, 2k+1
    // are the A fragment of key step k
#pragma unroll
    for (int k = 0; k < KT / 16; ++k) {
      uint32_t ph[4], pl[4];
      split_bf16(s[2 * k][0], s[2 * k][1], ph[0], pl[0]);
      split_bf16(s[2 * k][2], s[2 * k][3], ph[1], pl[1]);
      split_bf16(s[2 * k + 1][0], s[2 * k + 1][1], ph[2], pl[2]);
      split_bf16(s[2 * k + 1][2], s[2 * k + 1][3], ph[3], pl[3]);
#pragma unroll
      for (int np = 0; np < HD / 16; ++np) {
        uint32_t b[4];
        ptx::ldsm_x4_trans(b, Vt + (k * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * RS +
                                  np * 16 + (lane >> 4) * 8);
        ptx::mma_bf16(acc[2 * np], ph, b[0], b[1]);
        ptx::mma_bf16(acc[2 * np], pl, b[0], b[1]);
        ptx::mma_bf16(acc[2 * np + 1], ph, b[2], b[3]);
        ptx::mma_bf16(acc[2 * np + 1], pl, b[2], b[3]);
      }
    }
    __syncthreads();    // this stage fully read before it is refilled
    load_tile(i + 2);
  }
  ptx::cp_wait<0>();

  // partial of this chunk: m, l (summed over the quad), unnormalised acc
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 1);
    l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 2);
  }
  const size_t base = (size_t)(bh * n_rt + rt) * (n_chunks + 1);
  float* pa = part_acc + (base + c) * BR * HD;
  float* pm = part_ml + (base + c) * 2 * BR;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int lr = wrow + gid + 8 * r;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n)
      *reinterpret_cast<float2*>(pa + lr * HD + 8 * n + 2 * tig) =
          make_float2(acc[n][2 * r], acc[n][2 * r + 1]);
    if (tig == 0) {
      pm[lr] = m_r[r];
      pm[BR + lr] = l_r[r];
    }
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    int* cnt = counters + bh * n_rt + rt;
    is_last = atomicAdd(cnt, 1) == n_act;     // n_act prefix blocks + the tree block
    if (is_last) *cnt = 0;                     // ready for the next launch
  }
  __syncthreads();
  if (!is_last) return;
  __threadfence();

  // merge, in chunk order: thread -> row tid / 2, HD / 2 dims, in slices of
  // at most 64 (one slice up to HD = 128; at 256 the chunk weights and the
  // row sum are computed again for the second)
  constexpr int MS = HD / 2 < 64 ? HD / 2 : 64;
  const int lr = tid >> 1, d0 = (tid & 1) * (HD / 2), gr = r0 + lr;
  if (gr >= rows) return;
  float M = NEG_INF;
  for (int k = 0; k <= n_act; ++k) {
    const int cs = k < n_act ? k : n_chunks;
    M = fmaxf(M, __ldcg(part_ml + (base + cs) * 2 * BR + lr));
  }
  __nv_bfloat16* dst = out + (size_t)(gr / g) * nq * d + (size_t)(h * g + gr % g) * d;
  const bool vec4 = d % 4 == 0;                        // 8-byte aligned stores
#pragma unroll 1
  for (int c0 = d0; c0 < d0 + HD / 2 && c0 < d; c0 += MS) {
    float l = 0.f;
    float4 o[MS / 4];
#pragma unroll
    for (int i = 0; i < MS / 4; ++i) o[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int k = 0; k <= n_act; ++k) {
      const int cs = k < n_act ? k : n_chunks;
      const float w = expf(__ldcg(part_ml + (base + cs) * 2 * BR + lr) - M);
      l += w * __ldcg(part_ml + (base + cs) * 2 * BR + BR + lr);
      const float4* src =
          reinterpret_cast<const float4*>(part_acc + (base + cs) * BR * HD + lr * HD + c0);
#pragma unroll
      for (int i = 0; i < MS / 4; ++i) {
        const float4 v = __ldcg(src + i);
        o[i].x += w * v.x; o[i].y += w * v.y; o[i].z += w * v.z; o[i].w += w * v.w;
      }
    }
    const float inv = 1.f / fmaxf(l, 1e-30f);
#pragma unroll
    for (int i = 0; i < MS / 4; ++i) {
      const int col = c0 + 4 * i;
      if (vec4 && col + 4 <= d) {
        uint2 v;
        v.x = pack_bf16(o[i].x * inv, o[i].y * inv);
        v.y = pack_bf16(o[i].z * inv, o[i].w * inv);
        *reinterpret_cast<uint2*>(dst + col) = v;
      } else {
        const float v[4] = {o[i].x * inv, o[i].y * inv, o[i].z * inv, o[i].w * inv};
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (col + e < d) dst[col + e] = __float2bfloat16(v[e]);
      }
    }
  }
}

template <int HD, bool EXACT>
int launch_mma(const void* q, const void* kc, const void* vc, const void* kt,
               const void* vt, const void* mask, const void* start, void* out,
               void* part_acc, void* part_ml, void* counters, int B, int Tq, int Tk, int nq,
               int nkv, int S_rows, int head_stride, int d, int rows_per_tile, int chunk,
               int row_tiles, int chunks, float scale, cudaStream_t stream) {
  static bool smem_attr = false;
  // the wrapper's plan must be this kernel's geometry, and cover the rows
  const int rows = Tq * (nq / nkv);
  if (rows_per_tile != BR || chunk != CHUNK || row_tiles != (rows + BR - 1) / BR ||
      chunks != (S_rows + CHUNK - 1) / CHUNK || B < 1 || B * nkv > 65535)
    return (int)cudaErrorInvalidValue;
  if (!smem_attr) {
    const cudaError_t e = cudaFuncSetAttribute(
        tree_attn_mma_kernel<HD, EXACT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        mma_smem<HD>());
    if (e != cudaSuccess) return (int)e;
    smem_attr = true;
  }
  const dim3 grid(row_tiles, chunks + 1, B * nkv);
  tree_attn_mma_kernel<HD, EXACT><<<grid, NT, mma_smem<HD>(), stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)kc, (const __nv_bfloat16*)vc,
      (const __nv_bfloat16*)kt, (const __nv_bfloat16*)vt, (const uint8_t*)mask,
      (const int*)start, (__nv_bfloat16*)out, (float*)part_acc, (float*)part_ml,
      (int*)counters, Tq, Tk, nq, nkv, S_rows, head_stride, d, scale);
  return (int)cudaGetLastError();
}

// the padded width a head width runs at: 64, 128 or 256, and 256 past 256,
// which the f32 body covers in 256-column slices (0: no width)
int head_pad(int d) { return d < 1 ? 0 : d <= 64 ? 64 : d <= 128 ? 128 : 256; }

}  // namespace

// Every launch takes B batch rows: q [B, T, nq, d], k/v_cache rows of
// [B, n_kv, head_stride, d] (a cache, or a view of its first S_rows rows),
// k/v_tree [B, Tk, n_kv, d], tree_mask [B, T, Tk], start int32 [B] (each
// row's prefix length, clamped to [0, S_rows]), out [B, T, nq*d].
//
// dtype: 0 = float32, 1 = bfloat16. d: head_dim >= 1; the kernels run at
// the padded width head_pad (64 for d <= 64, 128 for d <= 128, else 256) in
// slices = ceil(d / head_pad) column slices (1 up to 256), which the plan
// gives and the launch checks. Past 256 either dtype runs the f32 body. S_rows:
// the cache's (or view's) rows; head_stride: rows between two kv heads of
// the buffer. bf16 up to 256 only: the plan of ops/attn_kernels.tree_plan
// (rows_per_tile = 64 query rows and chunk = 256 prefix keys a block,
// row_tiles, chunks; refused unless it is this kernel's), part_acc f32
// [B, n_kv, row tiles, chunks + 1, 64, head_pad], part_ml f32 [B, n_kv, row
// tiles, chunks + 1, 2, 64], counters int32 [B * n_kv * row tiles], zero on
// entry and left zero. Returns cudaGetLastError() after the launch
// (0 = launched).
extern "C" int tree_attention_launch(
    const void* q, const void* k_cache, const void* v_cache, const void* k_tree,
    const void* v_tree, const void* tree_mask, const void* start, void* out,
    void* part_acc, void* part_ml, void* counters, int dtype, int B, int T, int Tk, int nq,
    int nkv, int S_rows, int head_stride, int d, int hd_pad, int slices, int rows_per_tile,
    int chunk, int row_tiles, int chunks, float scale, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int hp = head_pad(d);
  if (hp == 0 || hd_pad != hp || slices != (d + hp - 1) / hp || slices > 65535 ||
      (dtype != 0 && dtype != 1) || B < 1)
    return (int)cudaErrorInvalidValue;
#define F32(T_, HD) launch<T_, HD>(q, k_cache, v_cache, k_tree, v_tree, tree_mask, start, out, \
                                   B, T, Tk, nq, nkv, S_rows, head_stride, d, slices, scale, st)
#define MMA(HD) (d == HD ? launch_mma<HD, true>(MMA_ARGS) : launch_mma<HD, false>(MMA_ARGS))
#define MMA_ARGS q, k_cache, v_cache, k_tree, v_tree, tree_mask, start, out, \
                 part_acc, part_ml, counters, B, T, Tk, nq, nkv, S_rows, head_stride, d, \
                 rows_per_tile, chunk, row_tiles, chunks, scale, st
  if (slices > 1) return dtype == 0 ? F32(float, 256) : F32(__nv_bfloat16, 256);
  if (dtype == 0) return hp == 64 ? F32(float, 64) : hp == 128 ? F32(float, 128) : F32(float, 256);
  return hp == 64 ? MMA(64) : hp == 128 ? MMA(128) : MMA(256);
#undef F32
#undef MMA
#undef MMA_ARGS
}
