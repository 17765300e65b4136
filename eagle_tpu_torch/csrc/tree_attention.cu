// Tree-verify attention for one sequence, hand-written for Hopper (sm_90a).
//
// Replaces: eagle_tpu/ops/pallas_attn.py:_tree_attn_kernel (wrapper
// tree_attention), the Pallas TPU kernel that the JAX engine runs for every
// layer's verify attention when ModelConfig.attn_impl == "pallas_tree".
//
// Computes what pallas_attn.tree_attention_xla computes:
//   q [T, nq, d] attends to the committed prefix k/v_cache [n_kv, S, d]
//   (rows < start) and to the tree's fresh k/v_tree [Tk, n_kv, d] under the
//   [T, Tk] ancestor mask; out [T, nq*d]. Scores in f32 with scale d^-0.5,
//   masked entries at -1e30, softmax in f32, out = acc / max(l, 1e-30).
//
// What bounds it on the H100: at the main path's shapes (T = Tk = 61, nq = 32,
// n_kv = 8, d = 128) one launch reads the prefix K/V once, 4 KiB per row and
// head pair, and does 4*T*nq*(start+Tk)*d flops: ~1.1 GFLOP against ~4 MB at
// start = 1024, about 270 flop/byte, just under the bf16 tensor-core ridge
// (~295): the bytes bound it, 1.6 us.
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
// f32 (the exactness checks), `tree_attn_kernel`: the first version's FP32
// FMA body (TF32 tensor cores would not hold an f32 tolerance of 1e-5): one
// block per (kv head, 16 query rows) walks the prefix to `start`, then the
// tree's keys, with products from shared memory.

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

// Copy one 16-byte chunk of a source row (VEC elements) into f32 shared
// memory, or zeros when src is null.
template <typename T>
__device__ __forceinline__ void load_chunk(float* dst, const T* src) {
  constexpr int VEC = 16 / sizeof(T);
  if (src == nullptr) {
#pragma unroll
    for (int i = 0; i < VEC; i += 4)
      *reinterpret_cast<float4*>(dst + i) = make_float4(0.f, 0.f, 0.f, 0.f);
    return;
  }
  uint4 raw = *reinterpret_cast<const uint4*>(src);
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int i = 0; i < VEC; i += 4)
    *reinterpret_cast<float4*>(dst + i) =
        make_float4(to_f(e[i]), to_f(e[i + 1]), to_f(e[i + 2]), to_f(e[i + 3]));
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

template <typename T, int D>
__global__ void __launch_bounds__(NT) tree_attn_kernel(
    const T* __restrict__ q, const T* __restrict__ kc, const T* __restrict__ vc,
    const T* __restrict__ kt, const T* __restrict__ vt,
    const uint8_t* __restrict__ mask, const int* __restrict__ start_ptr,
    T* __restrict__ out, int Tq, int Tk, int nq, int nkv, int S_rows, int S, float scale) {
  constexpr int DP = D + 4;          // padded f32 row: 16B-aligned, conflict-free
  constexpr int VEC = 16 / sizeof(T);
  constexpr int CH = D / VEC;        // 16-byte chunks per row
  constexpr int NC = D / 32;         // float4 output chunks per thread

  __shared__ __align__(16) float Qs[R * DP];
  __shared__ __align__(16) float Ks[BK * DP];
  __shared__ __align__(16) float Vs[BK * DP];
  __shared__ float Ps[R * (BK + 1)];
  __shared__ float m_s[R], l_s[R], a_s[R];

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int h = blockIdx.x;
  const int g = nq / nkv;
  const int rows = Tq * g;
  const int r0 = blockIdx.y * R;
  int start = *start_ptr;
  start = start < 0 ? 0 : (start > S_rows ? S_rows : start);

  // Q tile: block row r is global row r0 + r = (t, j) → q head h*g + j
  for (int e = tid; e < R * CH; e += NT) {
    const int r = e / CH, c = (e % CH) * VEC;
    const int gr = r0 + r;
    const T* src = nullptr;
    if (gr < rows) src = q + ((size_t)(gr / g) * nq + h * g + gr % g) * D + c;
    load_chunk<T>(Qs + r * DP + c, src);
  }
  if (tid < R) { m_s[tid] = NEG_INF; l_s[tid] = 0.f; }

  // PV-phase ownership: row pr, float4 column chunks pc + 32*i
  const int pr = tid >> 3;
  const int pc = (tid & 7) * 4;
  float4 acc[NC];
#pragma unroll
  for (int i = 0; i < NC; ++i) acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);

  // two phases: 0 = committed prefix (cols < start), 1 = fresh tree K/V
  for (int phase = 0; phase < 2; ++phase) {
    const int nkeys = phase == 0 ? start : Tk;
    for (int kb = 0; kb < nkeys; kb += BK) {
      __syncthreads();  // previous tile fully consumed (and Q / m / l ready)
      for (int e = tid; e < BK * CH; e += NT) {
        const int r = e / CH, c = (e % CH) * VEC;
        const int key = kb + r;
        const T* ks = nullptr;
        const T* vs = nullptr;
        if (key < nkeys) {
          const size_t off = phase == 0 ? ((size_t)h * S + key) * D + c
                                        : ((size_t)key * nkv + h) * D + c;
          ks = (phase == 0 ? kc : kt) + off;
          vs = (phase == 0 ? vc : vt) + off;
        }
        load_chunk<T>(Ks + r * DP + c, ks);
        load_chunk<T>(Vs + r * DP + c, vs);
      }
      __syncthreads();

      // scores: warp w owns rows 4w..4w+3, lane owns key kb + lane
      float s[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 8
      for (int c = 0; c < D; c += 4) {
        const float4 kv = *reinterpret_cast<const float4*>(Ks + lane * DP + c);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float4 qv = *reinterpret_cast<const float4*>(Qs + (warp * 4 + i) * DP + c);
          s[i] = fmaf(qv.x, kv.x, s[i]);
          s[i] = fmaf(qv.y, kv.y, s[i]);
          s[i] = fmaf(qv.z, kv.z, s[i]);
          s[i] = fmaf(qv.w, kv.w, s[i]);
        }
      }
      const int key = kb + lane;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = warp * 4 + i;
        const int gr = r0 + r;
        bool ok;
        if (phase == 0) ok = key < start;
        else ok = gr < rows && key < Tk && mask[(size_t)(gr / g) * Tk + key] != 0;
        const float x = ok ? s[i] * scale : NEG_INF;
        const float m_prev = m_s[r];
        const float m_new = fmaxf(m_prev, warp_max(x));
        const float p = expf(x - m_new);
        Ps[r * (BK + 1) + lane] = p;
        const float psum = warp_sum(p);
        __syncwarp();
        if (lane == 0) {
          const float a = expf(m_prev - m_new);
          a_s[r] = a;
          l_s[r] = a * l_s[r] + psum;
          m_s[r] = m_new;
        }
      }
      __syncthreads();

      // acc = acc * alpha + P @ V
      const float a = a_s[pr];
#pragma unroll
      for (int i = 0; i < NC; ++i) {
        acc[i].x *= a; acc[i].y *= a; acc[i].z *= a; acc[i].w *= a;
      }
#pragma unroll 4
      for (int kk = 0; kk < BK; ++kk) {
        const float p = Ps[pr * (BK + 1) + kk];
#pragma unroll
        for (int i = 0; i < NC; ++i) {
          const float4 vv = *reinterpret_cast<const float4*>(Vs + kk * DP + pc + 32 * i);
          acc[i].x = fmaf(p, vv.x, acc[i].x);
          acc[i].y = fmaf(p, vv.y, acc[i].y);
          acc[i].z = fmaf(p, vv.z, acc[i].z);
          acc[i].w = fmaf(p, vv.w, acc[i].w);
        }
      }
    }
  }
  __syncthreads();

  const int gr = r0 + pr;
  if (gr < rows) {
    const float inv = 1.f / fmaxf(l_s[pr], 1e-30f);
    T* o = out + (size_t)(gr / g) * nq * D + (size_t)(h * g + gr % g) * D;
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      const int c = pc + 32 * i;
      store_f(o + c, acc[i].x * inv);
      store_f(o + c + 1, acc[i].y * inv);
      store_f(o + c + 2, acc[i].z * inv);
      store_f(o + c + 3, acc[i].w * inv);
    }
  }
}

template <typename T, int D>
void launch(const void* q, const void* kc, const void* vc, const void* kt,
            const void* vt, const void* mask, const void* start, void* out,
            int Tq, int Tk, int nq, int nkv, int S_rows, int S, float scale,
            cudaStream_t stream) {
  const int rows = Tq * (nq / nkv);
  dim3 grid(nkv, (rows + R - 1) / R);
  tree_attn_kernel<T, D><<<grid, NT, 0, stream>>>(
      (const T*)q, (const T*)kc, (const T*)vc, (const T*)kt, (const T*)vt,
      (const uint8_t*)mask, (const int*)start, (T*)out, Tq, Tk, nq, nkv, S_rows, S, scale);
}

// ---------------------------------------------------------------------------
// bf16: tensor cores, split over the prefix, merge by the last block
// ---------------------------------------------------------------------------

constexpr int BR = 64;                 // query rows per block: 4 warps x m16
constexpr int CHUNK = 256;             // prefix keys per block
constexpr int BKT = 64;                // keys per tile (one cp.async stage)
constexpr int HD = 128;                // head_dim
constexpr int RS = HD + 8;             // bf16 per shared row (272 B): conflict-free ldmatrix
constexpr int MMA_SMEM = (BR + 4 * BKT) * RS * 2;   // Q + two stages of K and V

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// p -> bf16 hi + bf16 lo with hi + lo = p to ~2^-17 relative
__device__ __forceinline__ void split_bf16(float p0, float p1, uint32_t& hi, uint32_t& lo) {
  __nv_bfloat162 h = __floats2bfloat162_rn(p0, p1);
  hi = *reinterpret_cast<uint32_t*>(&h);
  lo = pack_bf16(p0 - __low2float(h), p1 - __high2float(h));
}

__global__ void __launch_bounds__(NT) tree_attn_mma_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ kc,
    const __nv_bfloat16* __restrict__ vc, const __nv_bfloat16* __restrict__ kt,
    const __nv_bfloat16* __restrict__ vt, const uint8_t* __restrict__ mask,
    const int* __restrict__ start_ptr, __nv_bfloat16* __restrict__ out,
    float* __restrict__ part_acc, float* __restrict__ part_ml, int* __restrict__ counters,
    int Tq, int Tk, int nq, int nkv, int S_rows, int head_stride, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int is_last;
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Ks = Qs + BR * RS;
  __nv_bfloat16* Vs = Ks + 2 * BKT * RS;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int rt = blockIdx.x, c = blockIdx.y, h = blockIdx.z;
  const int n_rt = gridDim.x, n_chunks = gridDim.y - 1;
  const int g = nq / nkv, rows = Tq * g, r0 = rt * BR;
  int start = *start_ptr;
  start = start < 0 ? 0 : (start > S_rows ? S_rows : start);
  const int n_act = (start + CHUNK - 1) / CHUNK;       // prefix chunks with keys
  const bool tree = c == n_chunks;
  if (!tree && c >= n_act) return;
  const int kbeg = tree ? 0 : c * CHUNK;
  const int kend = tree ? Tk : min(kbeg + CHUNK, start);
  const int ntiles = (kend - kbeg + BKT - 1) / BKT;

  // Q tile: block row r is global row r0 + r = (t, j) -> q head h*g + j
  for (int e = tid; e < BR * (HD / 8); e += NT) {
    const int r = e / (HD / 8), ch = (e % (HD / 8)) * 8, gr = r0 + r;
    const bool ok = gr < rows;
    const __nv_bfloat16* src = ok ? q + ((size_t)(gr / g) * nq + h * g + gr % g) * HD + ch : q;
    ptx::cp_async16(Qs + r * RS + ch, src, ok ? 16 : 0);
  }
  auto load_tile = [&](int i) {
    if (i < ntiles) {
      __nv_bfloat16* kd = Ks + (i & 1) * BKT * RS;
      __nv_bfloat16* vd = Vs + (i & 1) * BKT * RS;
      for (int e = tid; e < BKT * (HD / 8); e += NT) {
        const int r = e / (HD / 8), ch = (e % (HD / 8)) * 8, key = kbeg + i * BKT + r;
        const bool ok = key < kend;
        const size_t off = tree ? ((size_t)key * nkv + h) * HD + ch
                                : ((size_t)h * head_stride + key) * HD + ch;
        ptx::cp_async16(kd + r * RS + ch, ok ? (tree ? kt : kc) + off : kc, ok ? 16 : 0);
        ptx::cp_async16(vd + r * RS + ch, ok ? (tree ? vt : vc) + off : vc, ok ? 16 : 0);
      }
    }
    ptx::cp_commit();
  };
  load_tile(0);     // in one group with Q
  load_tile(1);

  const int wrow = warp * 16;
  uint32_t qf[HD / 16][4];
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
    if (i == 0) {
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        ptx::ldsm_x4(qf[kk], Qs + (wrow + (lane & 15)) * RS + kk * 16 + (lane >> 4) * 8);
    }
    const __nv_bfloat16* Kt = Ks + (i & 1) * BKT * RS;
    const __nv_bfloat16* Vt = Vs + (i & 1) * BKT * RS;

    // S = Q K^T for 16 rows x 64 keys per warp
    float s[BKT / 8][4];
#pragma unroll
    for (int j = 0; j < BKT / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
#pragma unroll
      for (int jp = 0; jp < BKT / 16; ++jp) {
        uint32_t b[4];
        ptx::ldsm_x4(b, Kt + (jp * 16 + (lane & 7) + (lane >> 4) * 8) * RS + kk * 16 +
                            ((lane >> 3) & 1) * 8);
        ptx::mma_bf16(s[2 * jp], qf[kk], b[0], b[1]);
        ptx::mma_bf16(s[2 * jp + 1], qf[kk], b[2], b[3]);
      }

    // mask, scale, online softmax (rows gid and gid + 8 of the warp's 16)
    const int kb = kbeg + i * BKT;
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int j = 0; j < BKT / 8; ++j)
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
    for (int j = 0; j < BKT / 8; ++j)
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
    for (int k = 0; k < BKT / 16; ++k) {
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
  const size_t base = (size_t)(h * n_rt + rt) * (n_chunks + 1);
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
    int* cnt = counters + h * n_rt + rt;
    is_last = atomicAdd(cnt, 1) == n_act;     // n_act prefix blocks + the tree block
    if (is_last) *cnt = 0;                     // ready for the next launch
  }
  __syncthreads();
  if (!is_last) return;
  __threadfence();

  // merge, in chunk order: thread -> row tid / 2, 64 dims
  const int lr = tid >> 1, d0 = (tid & 1) * (HD / 2), gr = r0 + lr;
  if (gr >= rows) return;
  float M = NEG_INF;
  for (int k = 0; k <= n_act; ++k) {
    const int cs = k < n_act ? k : n_chunks;
    M = fmaxf(M, __ldcg(part_ml + (base + cs) * 2 * BR + lr));
  }
  float l = 0.f;
  float4 o[HD / 8];
#pragma unroll
  for (int i = 0; i < HD / 8; ++i) o[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int k = 0; k <= n_act; ++k) {
    const int cs = k < n_act ? k : n_chunks;
    const float w = expf(__ldcg(part_ml + (base + cs) * 2 * BR + lr) - M);
    l += w * __ldcg(part_ml + (base + cs) * 2 * BR + BR + lr);
    const float4* src = reinterpret_cast<const float4*>(part_acc + (base + cs) * BR * HD + lr * HD + d0);
#pragma unroll
    for (int i = 0; i < HD / 8; ++i) {
      const float4 v = __ldcg(src + i);
      o[i].x += w * v.x; o[i].y += w * v.y; o[i].z += w * v.z; o[i].w += w * v.w;
    }
  }
  const float inv = 1.f / fmaxf(l, 1e-30f);
  __nv_bfloat16* dst = out + (size_t)(gr / g) * nq * HD + (size_t)(h * g + gr % g) * HD + d0;
#pragma unroll
  for (int i = 0; i < HD / 8; ++i) {
    uint2 v;
    v.x = pack_bf16(o[i].x * inv, o[i].y * inv);
    v.y = pack_bf16(o[i].z * inv, o[i].w * inv);
    *reinterpret_cast<uint2*>(dst + 4 * i) = v;
  }
}

int launch_mma(const void* q, const void* kc, const void* vc, const void* kt,
               const void* vt, const void* mask, const void* start, void* out,
               void* part_acc, void* part_ml, void* counters, int Tq, int Tk, int nq,
               int nkv, int S_rows, int head_stride, int rows_per_tile, int chunk,
               int row_tiles, int chunks, float scale, cudaStream_t stream) {
  static bool smem_attr = false;
  // the wrapper's plan must be this kernel's geometry, and cover the rows
  const int rows = Tq * (nq / nkv);
  if (rows_per_tile != BR || chunk != CHUNK || row_tiles != (rows + BR - 1) / BR ||
      chunks != (S_rows + CHUNK - 1) / CHUNK)
    return (int)cudaErrorInvalidValue;
  if (!smem_attr) {
    const cudaError_t e = cudaFuncSetAttribute(
        tree_attn_mma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, MMA_SMEM);
    if (e != cudaSuccess) return (int)e;
    smem_attr = true;
  }
  const dim3 grid(row_tiles, chunks + 1, nkv);
  tree_attn_mma_kernel<<<grid, NT, MMA_SMEM, stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)kc, (const __nv_bfloat16*)vc,
      (const __nv_bfloat16*)kt, (const __nv_bfloat16*)vt, (const uint8_t*)mask,
      (const int*)start, (__nv_bfloat16*)out, (float*)part_acc, (float*)part_ml,
      (int*)counters, Tq, Tk, nq, nkv, S_rows, head_stride, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. head_dim must be 128 (Llama-3.1-8B's).
// S_rows: the cache's (or view's) rows; head_stride: rows between two kv
// heads of the buffer. bf16 only: the plan of ops/attn_kernels.tree_plan
// (rows_per_tile = 64 query rows and chunk = 256 prefix keys a block,
// row_tiles, chunks; refused unless it is this kernel's), part_acc f32
// [n_kv, row tiles, chunks + 1, 64, 128], part_ml f32 [n_kv, row tiles,
// chunks + 1, 2, 64], counters int32 [n_kv * row tiles], zero on entry and
// left zero. Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int tree_attention_launch(
    const void* q, const void* k_cache, const void* v_cache, const void* k_tree,
    const void* v_tree, const void* tree_mask, const void* start, void* out,
    void* part_acc, void* part_ml, void* counters, int dtype, int T, int Tk, int nq,
    int nkv, int S_rows, int head_stride, int d, int rows_per_tile, int chunk, int row_tiles,
    int chunks, float scale, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (d != 128) return (int)cudaErrorInvalidValue;
  if (dtype == 0) {
    launch<float, 128>(q, k_cache, v_cache, k_tree, v_tree, tree_mask, start, out, T, Tk,
                       nq, nkv, S_rows, head_stride, scale, st);
    return (int)cudaGetLastError();
  }
  if (dtype == 1)
    return launch_mma(q, k_cache, v_cache, k_tree, v_tree, tree_mask, start, out, part_acc,
                      part_ml, counters, T, Tk, nq, nkv, S_rows, head_stride, rows_per_tile,
                      chunk, row_tiles, chunks, scale, st);
  return (int)cudaErrorInvalidValue;
}
