// Kernel C — stream compaction: indices of a mask's True lanes, in ascending
// order, packed to the front of a cap-wide buffer; the sentinel n fills the
// rest. Replaces the Pallas kernel nanokappa_tpu/ops/compact.py
// (compact_indices_pallas :68 / _kernel :36). Python wrapper and plain twin:
// nanokappa_torch/ops/compact.py.
#include "scan.cuh"

namespace {

__global__ void __launch_bounds__(NK_BLOCK)
count_mask(const uint8_t* __restrict__ mask, int n, int* __restrict__ counts) {
  const int i = blockIdx.x * NK_BLOCK + threadIdx.x;
  nk::store_block_count(i < n && mask[i] != 0, counts);
}

__global__ void __launch_bounds__(NK_BLOCK)
scatter_indices(const uint8_t* __restrict__ mask, int n,
                const int* __restrict__ offsets, int cap, int* __restrict__ idx) {
  const int i = blockIdx.x * NK_BLOCK + threadIdx.x;
  const bool p = i < n && mask[i] != 0;
  int total;
  const int r = nk::block_rank(p, &total);
  if (p) {
    const int g = offsets[blockIdx.x] + r;
    if (g < cap) idx[g] = i;
  }
}

__global__ void __launch_bounds__(NK_BLOCK)
fill_sentinel(int* __restrict__ idx, int cap, const int* __restrict__ n_valid,
              int sentinel) {
  const int j = blockIdx.x * NK_BLOCK + threadIdx.x;
  if (j < cap && j >= *n_valid) idx[j] = sentinel;
}

}  // namespace

// scratch: 2 * ceil(n / NK_BLOCK) + 1 ints (block counts, offsets, total)
extern "C" int nk_compact_indices(const void* mask, int n, int cap, void* idx,
                                  void* n_valid, void* scratch, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nb = (n + NK_BLOCK - 1) / NK_BLOCK;
  int* counts = static_cast<int*>(scratch);
  int* offsets = counts + nb;
  int* total = offsets + nb;
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  int* out = static_cast<int*>(idx);
  int* nv = static_cast<int*>(n_valid);
  if (nb > 0) count_mask<<<nb, NK_BLOCK, 0, s>>>(m, n, counts);
  nk::scan_counts<<<1, NK_SCAN, 0, s>>>(counts, nb, offsets, total, cap, nv);
  if (nb > 0) scatter_indices<<<nb, NK_BLOCK, 0, s>>>(m, n, offsets, cap, out);
  if (cap > 0)
    fill_sentinel<<<(cap + NK_BLOCK - 1) / NK_BLOCK, NK_BLOCK, 0, s>>>(out, cap, nv, n);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* nk_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
