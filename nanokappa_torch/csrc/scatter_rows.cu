// Kernel D — sorted-unique row scatter: pool[c, idx[e]] = rows[c, e] for
// every row c of the (C, N) pool and every update lane e with 0 <= idx[e] < N;
// the other lanes (the sentinel N of a compaction's unused tail) are dropped.
// Replaces the Pallas kernel nanokappa_tpu/ops/scatter_rows.py
// (scatter_rows_sorted :80 / _kernel :41). Python wrapper and plain twin:
// nanokappa_torch/ops/scatter_rows.py.
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int D_BLOCK = 256;

// One thread per (update lane, row): blockIdx.y is the row, so a warp reads
// 32 consecutive update lanes of one row (coalesced) and their indices. The
// indices are unique, so no two threads write one address: no atomics, no
// ordering. Rows move as uint32 bits (the pool's bitcast integer rows).
__global__ void __launch_bounds__(D_BLOCK)
scatter_rows(uint32_t* __restrict__ pool, const uint32_t* __restrict__ rows,
             const int* __restrict__ idx, int N, int E) {
  const int e = blockIdx.x * D_BLOCK + threadIdx.x;
  if (e >= E) return;
  const int i = idx[e];
  if (static_cast<unsigned>(i) >= static_cast<unsigned>(N)) return;
  const size_t c = blockIdx.y;
  pool[c * N + i] = rows[c * E + e];
}

}  // namespace

extern "C" int nk_scatter_rows(void* pool, const void* rows, const void* idx, int C,
                               int N, int E, void* stream) {
  if (C > 0 && E > 0) {
    const dim3 grid((E + D_BLOCK - 1) / D_BLOCK, C);
    scatter_rows<<<grid, D_BLOCK, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<uint32_t*>(pool), static_cast<const uint32_t*>(rows),
        static_cast<const int*>(idx), N, E);
  }
  return static_cast<int>(cudaGetLastError());
}
