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
//   bf16_dots     u8   the same sum, each dot as float multiply-adds of
//                      bf16-exact operands (every partial sum < 2^24: exact)
//   no_unpack     u8   the same loop on the raw bytes read as int8, both halves
//   no_dots       u8   every row = f32 column sum of the low nibbles plus that
//                      of the high nibbles; no dot, no scale
//   one_dot       u8   per half one dot of xq[:, :K/2] over all K/2 rows,
//                      times scale[0, :]
//   one_dot_bf16  u8   the same with float multiply-adds
//   i32_storage   i32  `full`'s sum through w4::column_acc (csrc/w4_dot.cuh)
//   fused_unpack  i32  each word read once: low group g and high group hg + g
//                      come from the same words; terms added g, hg+g, g+1, ..
//   batched_dot   i32  all G integer dots first, staged in shared memory as
//                      int32 [G, 16, 64]; then one f32 reduction, g = 0 .. G-1
//                      in order (the JAX probe leaves that order to XLA)
//
// What bounds it on the H100: the packed weights, K * N / 2 bytes, read once
// (8.4 MB at 4096 x 4096, 2.5 us at 3.35 TB/s); at M = 512 the integer
// multiply-adds against the int8 tensor-core peak. No variant uses tensor
// cores: they are B3's __dp4a body and its lane layout (csrc/w4_dot.cuh: a
// warp covers 8 adjacent columns, the 4 lanes of a column split each dot
// over K and add their partial sums with two shuffles), so that what a
// variant gains or loses here is what B3 would.
//
// Launch shape: `block_n` is the number of columns one thread block owns (a
// multiple of 64): a block of 256 threads walks its columns 64 at a time.
// Rows go in tiles of 16 on the fast grid axis, so blocks that share weight
// columns run together and share L2. A small block_n gives many blocks, a
// large one few: at block_n = 2048 and M = 32 only four blocks run.
//
// The u8 variants read their bytes with stride N: neighbouring lanes take
// neighbouring columns, so a warp's load covers 8 bytes of each of 4 rows,
// and four byte loads replace one word load. They read every byte twice (low
// pass, high pass) as B3 reads every word twice.

#include <cuda_bf16.h>

#include "w4_dot.cuh"

namespace {

constexpr int NT = 256;                                   // 8 warps
constexpr int COLS = (NT / 32) * w4::COLS_PER_WARP;       // 64 columns per pass
constexpr int MT = 16;                                    // rows per block
constexpr uint32_t NIB = 0x0F0F0F0Fu;

enum Mode { FULL = 0, BF16_DOTS, NO_UNPACK, NO_DOTS, ONE_DOT, ONE_DOT_BF16,
            I32_STORAGE, FUSED_UNPACK, BATCHED_DOT };
enum Plane { LO = 0, HI, RAW, BOTH };

// What one thread needs for its column.
struct Col {
  const int* xw;        // activations as int32 words [M, K/4]
  const int* rs;        // [M, G]
  const void* p;        // weights
  const float* scale;   // [G, N]
  int N, G, kw, kslice, n;
  bool vec;             // 16-byte activation loads allowed
  int row[MT], xo[MT];  // clamped rows and their word offsets
};

// The four bytes of byte rows 4*wrow .. 4*wrow+3 at the thread's column.
template <bool U8>
__device__ __forceinline__ uint32_t fetch(const Col& c, int wrow) {
  if constexpr (U8) {
    const uint8_t* b = (const uint8_t*)c.p + (size_t)(4 * wrow) * c.N + c.n;
    const size_t N = (size_t)c.N;
    return (uint32_t)__ldg(b) | ((uint32_t)__ldg(b + N) << 8) |
           ((uint32_t)__ldg(b + 2 * N) << 16) | ((uint32_t)__ldg(b + 3 * N) << 24);
  } else {
    return __ldg((const uint32_t*)c.p + (size_t)wrow * c.N + c.n);
  }
}

template <int PL>
__device__ __forceinline__ int plane(uint32_t raw) {
  return PL == LO ? (int)(raw & NIB) : PL == HI ? (int)((raw >> 4) & NIB) : (int)raw;
}

__device__ __forceinline__ int warp_share(int d) {
  d += __shfl_xor_sync(0xffffffffu, d, 8);
  d += __shfl_xor_sync(0xffffffffu, d, 16);
  return d;
}

// Integer dots of word rows [w0, w0 + nw) against activation words starting
// at xa (and, for BOTH, the high nibbles against those starting at xb).
// After the call all 4 lanes of a column hold the full dots.
template <bool U8, int PL>
__device__ __forceinline__ void int_dots(const Col& c, int w0, int nw, int xa, int xb,
                                         int (&da)[MT], int (&db)[MT]) {
#pragma unroll
  for (int m = 0; m < MT; ++m) da[m] = db[m] = 0;
  if (c.vec && nw % (4 * w4::KSLICES) == 0) {
    for (int i = 4 * c.kslice; i < nw; i += 4 * w4::KSLICES) {
      uint32_t raw[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) raw[j] = fetch<U8>(c, w0 + i + j);
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        const int4 xv = __ldg(reinterpret_cast<const int4*>(c.xw + c.xo[m] + xa + i));
        if constexpr (PL == BOTH) {
          const int4 xh = __ldg(reinterpret_cast<const int4*>(c.xw + c.xo[m] + xb + i));
          da[m] = __dp4a(plane<LO>(raw[0]), xv.x, da[m]);
          da[m] = __dp4a(plane<LO>(raw[1]), xv.y, da[m]);
          da[m] = __dp4a(plane<LO>(raw[2]), xv.z, da[m]);
          da[m] = __dp4a(plane<LO>(raw[3]), xv.w, da[m]);
          db[m] = __dp4a(plane<HI>(raw[0]), xh.x, db[m]);
          db[m] = __dp4a(plane<HI>(raw[1]), xh.y, db[m]);
          db[m] = __dp4a(plane<HI>(raw[2]), xh.z, db[m]);
          db[m] = __dp4a(plane<HI>(raw[3]), xh.w, db[m]);
        } else {
          da[m] = __dp4a(plane<PL>(raw[0]), xv.x, da[m]);
          da[m] = __dp4a(plane<PL>(raw[1]), xv.y, da[m]);
          da[m] = __dp4a(plane<PL>(raw[2]), xv.z, da[m]);
          da[m] = __dp4a(plane<PL>(raw[3]), xv.w, da[m]);
        }
      }
    }
  } else {
    for (int i = c.kslice; i < nw; i += w4::KSLICES) {
      const uint32_t raw = fetch<U8>(c, w0 + i);
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        if constexpr (PL == BOTH) {
          da[m] = __dp4a(plane<LO>(raw), __ldg(c.xw + c.xo[m] + xa + i), da[m]);
          db[m] = __dp4a(plane<HI>(raw), __ldg(c.xw + c.xo[m] + xb + i), db[m]);
        } else {
          da[m] = __dp4a(plane<PL>(raw), __ldg(c.xw + c.xo[m] + xa + i), da[m]);
        }
      }
    }
  }
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    da[m] = warp_share(da[m]);
    if constexpr (PL == BOTH) db[m] = warp_share(db[m]);
  }
}

// The same dots as float multiply-adds of bf16-exact operands (u8 storage).
// Every partial sum is an integer below 2^24, so the result is exact.
template <int PL>
__device__ __forceinline__ void float_dots(const Col& c, int w0, int nw, int xa,
                                           float (&d)[MT]) {
#pragma unroll
  for (int m = 0; m < MT; ++m) d[m] = 0.0f;
  for (int i = c.kslice; i < nw; i += w4::KSLICES) {
    const uint32_t nib = (uint32_t)plane<PL>(fetch<true>(c, w0 + i));
    float w[4];
#pragma unroll
    for (int b = 0; b < 4; ++b)
      w[b] = __bfloat162float(__uint2bfloat16_rn((nib >> (8 * b)) & 0xFFu));
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      const int xv = __ldg(c.xw + c.xo[m] + xa + i);
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const float a = __bfloat162float(__int2bfloat16_rn((int)(int8_t)(xv >> (8 * b))));
        d[m] = fmaf(a, w[b], d[m]);
      }
    }
  }
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    d[m] += __shfl_xor_sync(0xffffffffu, d[m], 8);
    d[m] += __shfl_xor_sync(0xffffffffu, d[m], 16);
  }
}

// acc += float(d - rs[:, g]) * scale[g]: one rounded multiply, one rounded add.
__device__ __forceinline__ void add_term(const Col& c, int g, const int (&d)[MT],
                                         float (&acc)[MT]) {
  const float s = __ldg(c.scale + (size_t)g * c.N + c.n);
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    const float corr = (float)(d[m] - __ldg(c.rs + (size_t)c.row[m] * c.G + g));
    acc[m] = __fadd_rn(acc[m], __fmul_rn(corr, s));
  }
}

__device__ __forceinline__ void add_term_f(const Col& c, int g, const float (&d)[MT],
                                           float (&acc)[MT]) {
  const float s = __ldg(c.scale + (size_t)g * c.N + c.n);
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    const float corr = __fsub_rn(d[m], (float)__ldg(c.rs + (size_t)c.row[m] * c.G + g));
    acc[m] = __fadd_rn(acc[m], __fmul_rn(corr, s));
  }
}

__device__ __forceinline__ int byte_sum(uint32_t x) {
  return (int)((x & 0xFFu) + ((x >> 8) & 0xFFu) + ((x >> 16) & 0xFFu) + (x >> 24));
}

template <int MODE>
__global__ void __launch_bounds__(NT) ablate_kernel(
    const int* __restrict__ xw, const int* __restrict__ rs, const void* __restrict__ p,
    const float* __restrict__ scale, float* __restrict__ out, int M, int K, int N, int G,
    int block_n) {
  extern __shared__ int stage[];            // batched_dot: int32 [G, MT, COLS]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int ci = warp * w4::COLS_PER_WARP + (lane & 7);   // column within a pass
  const int m0 = blockIdx.x * MT;
  const int wpg = K / G / 4;                // word rows per group
  const int hg = G / 2;                     // groups per half
  const int hw = K / 8;                     // word rows per half

  Col c;
  c.xw = xw; c.rs = rs; c.p = p; c.scale = scale;
  c.N = N; c.G = G; c.kw = K / 4; c.kslice = lane >> 3;
  c.vec = c.kw % 4 == 0 && (reinterpret_cast<uintptr_t>(xw) & 15) == 0;
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    c.row[m] = min(m0 + m, M - 1);
    c.xo[m] = c.row[m] * c.kw;
  }

  for (int c0 = 0; c0 < block_n; c0 += COLS) {
    const int col = blockIdx.y * block_n + c0 + ci;
    c.n = min(col, N - 1);
    float acc[MT];
#pragma unroll
    for (int m = 0; m < MT; ++m) acc[m] = 0.0f;
    int d[MT], e[MT];

    if constexpr (MODE == I32_STORAGE) {
      w4::column_acc<MT>(xw, rs, (const uint32_t*)p, scale, M, K, N, G, 1, m0, c.n,
                         c.kslice, acc);
    } else if constexpr (MODE == FULL || MODE == NO_UNPACK) {
      for (int g = 0; g < hg; ++g) {
        int_dots<true, MODE == FULL ? LO : RAW>(c, g * wpg, wpg, g * wpg, 0, d, e);
        add_term(c, g, d, acc);
      }
      for (int g = 0; g < hg; ++g) {
        int_dots<true, MODE == FULL ? HI : RAW>(c, g * wpg, wpg, (hg + g) * wpg, 0, d, e);
        add_term(c, hg + g, d, acc);
      }
    } else if constexpr (MODE == BF16_DOTS) {
      float f[MT];
      for (int g = 0; g < hg; ++g) {
        float_dots<LO>(c, g * wpg, wpg, g * wpg, f);
        add_term_f(c, g, f, acc);
      }
      for (int g = 0; g < hg; ++g) {
        float_dots<HI>(c, g * wpg, wpg, (hg + g) * wpg, f);
        add_term_f(c, hg + g, f, acc);
      }
    } else if constexpr (MODE == NO_DOTS) {
      int sl = 0, sh = 0;
      for (int i = c.kslice; i < hw; i += w4::KSLICES) {
        const uint32_t raw = fetch<true>(c, i);
        sl += byte_sum(raw & NIB);
        sh += byte_sum((raw >> 4) & NIB);
      }
      sl = warp_share(sl);
      sh = warp_share(sh);
      const float v = __fadd_rn(__fadd_rn(0.0f, (float)sl), (float)sh);
#pragma unroll
      for (int m = 0; m < MT; ++m) acc[m] = v;
    } else if constexpr (MODE == ONE_DOT) {
      const float s = __ldg(scale + c.n);
      int_dots<true, LO>(c, 0, hw, 0, 0, d, e);
#pragma unroll
      for (int m = 0; m < MT; ++m) acc[m] = __fadd_rn(acc[m], __fmul_rn((float)d[m], s));
      int_dots<true, HI>(c, 0, hw, 0, 0, d, e);
#pragma unroll
      for (int m = 0; m < MT; ++m) acc[m] = __fadd_rn(acc[m], __fmul_rn((float)d[m], s));
    } else if constexpr (MODE == ONE_DOT_BF16) {
      const float s = __ldg(scale + c.n);
      float f[MT];
      float_dots<LO>(c, 0, hw, 0, f);
#pragma unroll
      for (int m = 0; m < MT; ++m) acc[m] = __fadd_rn(acc[m], __fmul_rn(f[m], s));
      float_dots<HI>(c, 0, hw, 0, f);
#pragma unroll
      for (int m = 0; m < MT; ++m) acc[m] = __fadd_rn(acc[m], __fmul_rn(f[m], s));
    } else if constexpr (MODE == FUSED_UNPACK) {
      for (int g = 0; g < hg; ++g) {
        int_dots<false, BOTH>(c, g * wpg, wpg, g * wpg, (hg + g) * wpg, d, e);
        add_term(c, g, d, acc);
        add_term(c, hg + g, e, acc);
      }
    } else {  // BATCHED_DOT
      for (int g = 0; g < hg; ++g) {
        int_dots<false, BOTH>(c, g * wpg, wpg, g * wpg, (hg + g) * wpg, d, e);
        if (c.kslice == 0) {
#pragma unroll
          for (int m = 0; m < MT; ++m) {
            stage[(g * MT + m) * COLS + ci] = d[m];
            stage[((hg + g) * MT + m) * COLS + ci] = e[m];
          }
        }
      }
      __syncwarp();        // the 4 lanes of a column read what lane kslice 0 wrote
      for (int g = 0; g < G; ++g) {
#pragma unroll
        for (int m = 0; m < MT; ++m) d[m] = stage[(g * MT + m) * COLS + ci];
        add_term(c, g, d, acc);
      }
      __syncwarp();        // before the next pass overwrites the stage
    }

    if (c.kslice == 0 && col < N) {
#pragma unroll
      for (int m = 0; m < MT; ++m)
        if (m0 + m < M) out[(size_t)(m0 + m) * N + col] = acc[m];
    }
  }
}

template <int MODE>
int launch(const void* xq, const void* rs, const void* p, const void* scale, void* out,
           int M, int K, int N, int G, int block_n, cudaStream_t st) {
  size_t smem = 0;
  if (MODE == BATCHED_DOT) {
    smem = (size_t)G * MT * COLS * sizeof(int);
    if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
    if (smem > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          ablate_kernel<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return (int)err;
    }
  }
  dim3 grid((M + MT - 1) / MT, (N + block_n - 1) / block_n);
  ablate_kernel<MODE><<<grid, NT, smem, st>>>(
      (const int*)xq, (const int*)rs, p, (const float*)scale, (float*)out, M, K, N, G,
      block_n);
  return (int)cudaGetLastError();
}

}  // namespace

// B6. mode: the Mode enum above (ops/w4_ablate.py:MODES in the same order).
// xq: int8 [M, K]; rs: int32 [M, G]; p: u8 [K/2, N] (modes 0-5) or int32
// [K/8, N] (modes 6-8); scale: f32 [G, N]; out: f32 [M, N]; block_n: columns
// per thread block, a multiple of 64. Returns cudaGetLastError() after the
// launch (0 = launched).
extern "C" int w4_ablate_launch(int mode, const void* xq, const void* rs, const void* p,
                                const void* scale, void* out, int M, int K, int N, int G,
                                int block_n, void* stream) {
  if (M <= 0 || N <= 0 || G <= 0 || G % 2 != 0 || K % 8 != 0 || K % G != 0 ||
      (K / G) % 4 != 0 || block_n <= 0 || block_n % COLS != 0 ||
      (N + block_n - 1) / block_n > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (mode) {
    case FULL: return launch<FULL>(xq, rs, p, scale, out, M, K, N, G, block_n, st);
    case BF16_DOTS: return launch<BF16_DOTS>(xq, rs, p, scale, out, M, K, N, G, block_n, st);
    case NO_UNPACK: return launch<NO_UNPACK>(xq, rs, p, scale, out, M, K, N, G, block_n, st);
    case NO_DOTS: return launch<NO_DOTS>(xq, rs, p, scale, out, M, K, N, G, block_n, st);
    case ONE_DOT: return launch<ONE_DOT>(xq, rs, p, scale, out, M, K, N, G, block_n, st);
    case ONE_DOT_BF16:
      return launch<ONE_DOT_BF16>(xq, rs, p, scale, out, M, K, N, G, block_n, st);
    case I32_STORAGE:
      return launch<I32_STORAGE>(xq, rs, p, scale, out, M, K, N, G, block_n, st);
    case FUSED_UNPACK:
      return launch<FUSED_UNPACK>(xq, rs, p, scale, out, M, K, N, G, block_n, st);
    case BATCHED_DOT:
      return launch<BATCHED_DOT>(xq, rs, p, scale, out, M, K, N, G, block_n, st);
  }
  return (int)cudaErrorInvalidValue;
}
