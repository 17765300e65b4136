// In-place accepted-branch KV compaction, hand-written for Hopper (sm_90a).
//
// Replaces: eagle_tpu/ops/pallas_attn.py:_compact_kernel (wrapper
// compact_rows), the Pallas TPU kernel that the JAX engine runs once per
// decode round when EngineConfig.compact_impl == "pallas".
//
// Computes, for every layer and kv head of k and v [L, B, n_kv, S, d]:
//   row start + path[i]  →  row start + i,   i < P,
// which is what ops/kv_cache.compact_accepted does. Source and destination
// windows overlap (path is ascending, path[i] >= i), so a block reads every
// source row of its slab before it writes any.
//
// What bounds it on the H100: pure data movement. One launch reads and writes
// 2 * L * n_kv * P * d elements (K and V): at the main path's shapes
// (L = 32, n_kv = 8, P = 7, d = 128, bf16) that is 0.9 MB read plus 0.9 MB
// written, about 0.5 us at 3.35 TB/s. At that size the launch itself and
// the chain of dependent steps inside it set the time, not the bytes.
//
// What the design does about it:
//  - One block per (layer, batch row, kv head) slab and tensor: K and V of a
//    slab move in parallel, in separate blocks. The blocks touch disjoint
//    memory, so the update is truly in place with no second buffer and no
//    grid-wide barrier (JAX arrays are immutable; XLA needed donation and
//    input/output aliasing for the same effect).
//  - Two dependent steps before the writes: every warp loads `path` (lane i,
//    path[i]) and `start` at once, hands path[i] to the lanes by shuffle,
//    then loads its 16-byte words; no load waits on another load of the
//    same kind. `path` and `start` stay on the device: no host sync.
//  - Each thread keeps its words in registers across the one barrier (P = 7
//    bf16 rows of head_dim 128 are 112 words): no shared memory.
//  - A row whose source is its destination (path[i] == i inside the cache:
//    the root, and any identity prefix of the accepted path) is neither read
//    nor written; its bytes are already in place, and no other row writes it.
//  - Exactly P rows are written. The destination window is clamped into the
//    cache as dynamic_update_slice clamps it, the sources to [0, S). The TPU
//    kernel's 8-aligned staging window and one-hot MXU shuffle were Mosaic
//    constraints and are not ported, nor is its head_dim % 128 guard.
//  - Rows move as 16-byte words (the row size must be a multiple of 16 bytes;
//    a bf16 or f32 row of head_dim 128 is 256 or 512 bytes).
//
// Left for later: fusing the move into the next verify forward's KV write, or
// into the tree-attention kernel's epilogue, which would remove the launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 128;
constexpr int MAX_WPT = 16;      // words a thread: P * row_words <= NT * MAX_WPT

using W = uint4;  // one 16-byte word

template <int WPT>
__global__ void __launch_bounds__(NT) compact_kernel(
    W* __restrict__ k, W* __restrict__ v, const int* __restrict__ path,
    const int* __restrict__ start_ptr, int P, int S, int row_words) {
  W* t = blockIdx.y ? v : k;
  const size_t slab = (size_t)blockIdx.x * S * row_words;
  const int lane = threadIdx.x & 31;
  const int pl = lane < P ? __ldg(path + lane) : 0;
  const int start = __ldg(start_ptr);
  // destination window clamped into the cache like dynamic_update_slice
  const int dst0 = min(max(start, 0), S - P);
  const int n = P * row_words;

  W w[WPT];
  int dst[WPT];
#pragma unroll
  for (int j = 0; j < WPT; ++j) {
    const int e = threadIdx.x + j * NT, i = e / row_words, c = e - i * row_words;
    int pi = __shfl_sync(0xffffffffu, pl, i & 31);
    if (i >= 32 && e < n) pi = __ldg(path + i);
    const int src = min(max(start + pi, 0), S - 1);
    dst[j] = -1;
    if (e < n && src != dst0 + i) {
      w[j] = t[slab + (size_t)src * row_words + c];
      dst[j] = (dst0 + i) * row_words + c;
    }
  }
  __syncthreads();     // every source word of the slab is read
#pragma unroll
  for (int j = 0; j < WPT; ++j)
    if (dst[j] >= 0) t[slab + dst[j]] = w[j];
}

}  // namespace

// k, v: [slabs, S, row_bytes] in place; path: [P] int32; start: [1] int32.
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int compact_rows_launch(void* k, void* v, const void* path,
                                   const void* start, int slabs, int P, int S,
                                   int row_bytes, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int row_words = row_bytes / 16;
  const long n = (long)P * row_words;
  if (P <= 0 || P > S || row_bytes <= 0 || row_bytes % 16 != 0 || n > NT * MAX_WPT ||
      slabs <= 0)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(slabs, 2);
#define LAUNCH(WPT) compact_kernel<WPT><<<grid, NT, 0, st>>>( \
    (W*)k, (W*)v, (const int*)path, (const int*)start, P, S, row_words)
  if (n <= NT) LAUNCH(1);
  else if (n <= 2 * NT) LAUNCH(2);
  else if (n <= 4 * NT) LAUNCH(4);
  else if (n <= 8 * NT) LAUNCH(8);
  else LAUNCH(16);
#undef LAUNCH
  return (int)cudaGetLastError();
}
