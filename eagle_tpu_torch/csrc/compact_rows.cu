// In-place accepted-branch KV compaction, hand-written for Hopper (sm_90a).
//
// Replaces: eagle_tpu/ops/pallas_attn.py:_compact_kernel (wrapper
// compact_rows), the Pallas TPU kernel that the JAX engine runs once per
// decode round when EngineConfig.compact_impl == "pallas".
//
// Computes, for every layer and kv head of k and v [L, B, n_kv, S, d]:
//   row start + path[i]  →  row start + i,   i < P,
// which is what ops/kv_cache.compact_accepted does. Source and destination
// windows overlap (path is ascending, path[i] >= i), so each block gathers all
// P source rows into shared memory before it writes any.
//
// What bounds it on the H100: pure data movement. One launch reads and writes
// 2 * L * n_kv * P * d elements (K and V): at the main path's shapes
// (L = 32, n_kv = 8, P = 7, d = 128, bf16) that is 0.9 MB read plus 0.9 MB
// written, about 0.5 us at 3.35 TB/s. At that size the launch itself
// (a few us) dominates.
//
// What the design does about it:
//  - One block per (layer, batch row, kv head) slab: the L * n_kv blocks touch
//    disjoint memory, so the update is truly in place with no second buffer
//    and no grid-wide barrier (JAX arrays are immutable; XLA needed donation
//    and input/output aliasing for the same effect).
//  - `path` and `start` are read from device memory: no host sync.
//  - Exactly P rows are written. The TPU kernel's 8-aligned staging window
//    and one-hot MXU shuffle were Mosaic constraints and are not ported, nor
//    is its head_dim % 128 guard.
//  - Rows move as 16-byte words (the row size must be a multiple of 16 bytes;
//    a bf16 or f32 row of head_dim 128 is 256 or 512 bytes).
//
// Left for later: fusing the move into the next verify forward's KV write, or
// into the tree-attention kernel's epilogue, which would remove the launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 128;

using W = uint4;  // one 16-byte word

__global__ void __launch_bounds__(NT) compact_kernel(
    W* __restrict__ k, W* __restrict__ v, const int* __restrict__ path,
    const int* __restrict__ start_ptr, int P, int S, int row_words) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  W* sk = reinterpret_cast<W*>(smem_raw);
  W* sv = sk + (size_t)P * row_words;
  const size_t slab = (size_t)blockIdx.x * S * row_words;
  const int start = *start_ptr;
  // destination window clamped into the cache like dynamic_update_slice
  const int dst0 = min(max(start, 0), S - P);
  const int n = P * row_words;

  for (int e = threadIdx.x; e < n; e += NT) {
    const int i = e / row_words, c = e % row_words;
    const int src = min(max(start + path[i], 0), S - 1);
    const size_t off = slab + (size_t)src * row_words + c;
    sk[e] = k[off];
    sv[e] = v[off];
  }
  __syncthreads();
  for (int e = threadIdx.x; e < n; e += NT) {
    const int i = e / row_words, c = e % row_words;
    const size_t off = slab + (size_t)(dst0 + i) * row_words + c;
    k[off] = sk[e];
    v[off] = sv[e];
  }
}

}  // namespace

// k, v: [slabs, S, row_bytes] in place; path: [P] int32; start: [1] int32.
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int compact_rows_launch(void* k, void* v, const void* path,
                                   const void* start, int slabs, int P, int S,
                                   int row_bytes, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (P <= 0 || P > S || row_bytes % 16 != 0) return (int)cudaErrorInvalidValue;
  const size_t smem = 2 * (size_t)P * row_bytes;
  compact_kernel<<<slabs, NT, smem, st>>>(
      (W*)k, (W*)v, (const int*)path, (const int*)start, P, S, row_bytes / 16);
  return (int)cudaGetLastError();
}
