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
//   masked entries at -1e30, online softmax in f32, out = acc / max(l, 1e-30).
//
// What bounds it on the H100: at the main path's shapes (T = Tk = 61, nq = 32,
// n_kv = 8, d = 128) one launch reads the prefix K/V once, 4 KiB per row and
// head pair, and does 4*T*nq*(start+Tk)*d flops: ~1.1 GFLOP against ~4 MB at
// start = 1024, about 270 flop/byte, just under the bf16 tensor-core ridge
// (~295). This first version does its products with FP32 FMAs from shared
// memory, so it is bound by the FMA and shared-memory issue rate, well above
// the roofline bound.
//
// What the design does about it:
//  - One block per (kv head, tile of R = 16 query rows). The T*g query rows
//    of a kv head are t-major (t, group) rows, so all g query heads that share
//    a kv head read each K/V tile from shared memory once per block.
//  - The TPU kernel's sequential KV grid axis becomes a loop inside the block
//    (Hopper blocks run in parallel and carry nothing between them).
//  - `start` is read from device memory (no host sync) and the prefix loop
//    stops at `start`: rows >= start are never read (the TPU kernel walks all
//    of S and masks).
//  - The tree phase streams k/v_tree under the [T, Tk] mask; no [T, S] mask
//    or score matrix ever exists in device memory.
//  - The output is written straight into [T, nq*d]: no transposes, and no
//    8-row padding of T/Tk (that was a Mosaic tiling constraint).
//  - K/V/Q tiles are converted to f32 in shared memory, so bf16 and f32
//    inputs share one code path.
//
// Left for later: bf16 tensor-core products (mma.sync, then wgmma with TMA
// loads and an mbarrier ring), double-buffered tiles, and a split over the
// prefix (split-K / flash-decoding) so that long prefixes fill all 132 SMs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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
    T* __restrict__ out, int Tq, int Tk, int nq, int nkv, int S, float scale) {
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
  start = start < 0 ? 0 : (start > S ? S : start);

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
            int Tq, int Tk, int nq, int nkv, int S, float scale,
            cudaStream_t stream) {
  const int rows = Tq * (nq / nkv);
  dim3 grid(nkv, (rows + R - 1) / R);
  tree_attn_kernel<T, D><<<grid, NT, 0, stream>>>(
      (const T*)q, (const T*)kc, (const T*)vc, (const T*)kt, (const T*)vt,
      (const uint8_t*)mask, (const int*)start, (T*)out, Tq, Tk, nq, nkv, S, scale);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. head_dim must be 128 (Llama-3.1-8B's).
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int tree_attention_launch(
    const void* q, const void* k_cache, const void* v_cache, const void* k_tree,
    const void* v_tree, const void* tree_mask, const void* start, void* out,
    int dtype, int T, int Tk, int nq, int nkv, int S, int d, float scale,
    void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (d != 128) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    launch<float, 128>(q, k_cache, v_cache, k_tree, v_tree, tree_mask, start, out, T, Tk, nq, nkv, S, scale, st);
  else if (dtype == 1)
    launch<__nv_bfloat16, 128>(q, k_cache, v_cache, k_tree, v_tree, tree_mask, start, out, T, Tk, nq, nkv, S, scale, st);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
