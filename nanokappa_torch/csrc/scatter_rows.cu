// Kernel D — sorted-unique row scatter: pool[c, idx[e]] = rows[c, e] for
// every row c of the (C, N) pool and every update lane e with 0 <= idx[e] < N;
// the other lanes (the sentinel N of a compaction's unused tail) are dropped.
// Replaces the Pallas kernel nanokappa_tpu/ops/scatter_rows.py
// (scatter_rows_sorted :80 / _kernel :41). Python wrapper and plain twin:
// nanokappa_torch/ops/scatter_rows.py.
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int D_BLOCK = 64;  // small blocks spread the valid prefix over every SM
constexpr int D_CHUNK = 16;  // rows a thread loads before it stores them

// One thread per update lane: it reads its index once, then moves its
// lane's C rows D_CHUNK at a time (every load of a chunk issued before its
// stores), each row read coalesced across the warp. idx ascends, so the
// sentinel tail is a suffix: a thread whose index is >= N holds a sentinel,
// and so does every later one; it leaves at once (a warp past the valid
// prefix does no more than its index load). The per-lane 0 <= i < N test
// drops any other lane outside the pool. The indices are unique, so no two
// threads write one address: no atomics, no ordering. Rows move as uint32
// bits (the pool's bitcast integer rows).
__global__ void __launch_bounds__(D_BLOCK)
scatter_lanes(uint32_t* __restrict__ pool, const uint32_t* __restrict__ rows,
              const int* __restrict__ idx, int C, int N, int E) {
  const int e = blockIdx.x * D_BLOCK + threadIdx.x;
  if (e >= E) return;
  const int i = idx[e];
  if (static_cast<unsigned>(i) >= static_cast<unsigned>(N)) return;
  for (int c0 = 0; c0 < C; c0 += D_CHUNK) {
    uint32_t v[D_CHUNK];
#pragma unroll
    for (int c = 0; c < D_CHUNK; ++c)
      if (c0 + c < C) v[c] = rows[(size_t)(c0 + c) * E + e];
#pragma unroll
    for (int c = 0; c < D_CHUNK; ++c)
      if (c0 + c < C) pool[(size_t)(c0 + c) * N + i] = v[c];
  }
}

}  // namespace

extern "C" int nk_scatter_rows(void* pool, const void* rows, const void* idx, int C, int N, int E,
                               void* stream) {
  if (C > 0 && E > 0)
    scatter_lanes<<<(E + D_BLOCK - 1) / D_BLOCK, D_BLOCK, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<uint32_t*>(pool), static_cast<const uint32_t*>(rows),
        static_cast<const int*>(idx), C, N, E);
  return static_cast<int>(cudaGetLastError());
}
