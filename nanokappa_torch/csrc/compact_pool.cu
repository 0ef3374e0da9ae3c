// Kernel B — pool defragmentation: every alive lane of the (C, N) float32
// pool, in order, moved to a dense prefix [0, tail) of a second pool; every
// row of every lane at or past the tail is zeroed. Replaces the Pallas kernel
// nanokappa_tpu/ops/compact_pool.py (compact_pool :118 / _kernel :50).
// Python wrapper and plain twin: nanokappa_torch/ops/compact_pool.py.
#include "scan.cuh"

namespace {

constexpr int C_ALIVE = 14;

__device__ __forceinline__ bool lane_alive(const uint32_t* pool, int N, int i) {
  return i < N && __uint_as_float(pool[(size_t)C_ALIVE * N + i]) > 0.5f;
}

__global__ void __launch_bounds__(NK_BLOCK)
count_alive(const uint32_t* __restrict__ pool, int N, int* __restrict__ counts) {
  const int i = blockIdx.x * NK_BLOCK + threadIdx.x;
  nk::store_block_count(lane_alive(pool, N, i), counts);
}

// Rows move as uint32 bits: no float arithmetic touches the bitcast ids.
__global__ void __launch_bounds__(NK_BLOCK)
move_lanes(const uint32_t* __restrict__ src, uint32_t* __restrict__ dst, int C,
           int N, const int* __restrict__ offsets, const int* __restrict__ tail) {
  const int i = blockIdx.x * NK_BLOCK + threadIdx.x;
  const bool a = lane_alive(src, N, i);
  int total;
  const int r = nk::block_rank(a, &total);
  if (a) {
    const size_t g = (size_t)offsets[blockIdx.x] + r;
    for (int c = 0; c < C; ++c) dst[(size_t)c * N + g] = src[(size_t)c * N + i];
  }
  if (i < N && i >= *tail)
    for (int c = 0; c < C; ++c) dst[(size_t)c * N + i] = 0u;
}

}  // namespace

// scratch: 2 * ceil(N / NK_BLOCK) + 1 ints (block counts, offsets, spare)
extern "C" int nk_compact_pool(const void* pool, void* out, int C, int N,
                               void* tail, void* scratch, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nb = (N + NK_BLOCK - 1) / NK_BLOCK;
  int* counts = static_cast<int*>(scratch);
  int* offsets = counts + nb;
  const uint32_t* src = static_cast<const uint32_t*>(pool);
  uint32_t* dst = static_cast<uint32_t*>(out);
  int* t = static_cast<int*>(tail);
  if (nb > 0) count_alive<<<nb, NK_BLOCK, 0, s>>>(src, N, counts);
  nk::scan_runs<<<1, NK_SCAN, 0, s>>>(counts, nb, offsets, t, N, nullptr);
  if (nb > 0) move_lanes<<<nb, NK_BLOCK, 0, s>>>(src, dst, C, N, offsets, t);
  return static_cast<int>(cudaGetLastError());
}
