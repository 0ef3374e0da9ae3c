// Block-scan building blocks shared by the three kernels (compact.cu,
// compact_pool.cu, megastep.cu): a per-block rank of a predicate, the
// exclusive scan of per-block counts, and fixed-order per-block segment sums.
// Every helper assumes blockDim.x == NK_BLOCK and is called by all threads
// of the block (lanes past the end of the data pass a false predicate).
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

constexpr int NK_BLOCK = 256;  // threads (= lanes) per block
constexpr int NK_SCAN = 1024;  // threads of the single-block count scan

namespace nk {
namespace {  // internal linkage: every .cu file includes these

// Exclusive rank of this thread's predicate among the block's threads (in
// thread order) and, in *total, the block's count. Warp ballots + one pass
// over the per-warp counts in shared memory.
__device__ __forceinline__ int block_rank(bool pred, int* total) {
  __shared__ int warp_base[NK_BLOCK / 32];
  __shared__ int block_total;
  const unsigned lane = threadIdx.x & 31u;
  const unsigned warp = threadIdx.x >> 5;
  const unsigned ballot = __ballot_sync(0xffffffffu, pred);
  if (lane == 0) warp_base[warp] = __popc(ballot);
  __syncthreads();
  if (threadIdx.x == 0) {
    int acc = 0;
    for (int w = 0; w < NK_BLOCK / 32; ++w) {
      const int c = warp_base[w];
      warp_base[w] = acc;
      acc += c;
    }
    block_total = acc;
  }
  __syncthreads();
  const int r = warp_base[warp] + __popc(ballot & ((1u << lane) - 1u));
  *total = block_total;
  __syncthreads();  // the shared words may be reused by the next call
  return r;
}

// Inclusive scan of one int per thread over a block of NK_SCAN threads.
__device__ __forceinline__ int scan_inclusive(int v) {
  __shared__ int warp_sum[NK_SCAN / 32];
  const unsigned lane = threadIdx.x & 31u;
  const unsigned warp = threadIdx.x >> 5;
  for (int d = 1; d < 32; d <<= 1) {
    const int t = __shfl_up_sync(0xffffffffu, v, d);
    if (lane >= (unsigned)d) v += t;
  }
  if (lane == 31) warp_sum[warp] = v;
  __syncthreads();
  if (warp == 0) {
    int w = warp_sum[lane];  // NK_SCAN / 32 == 32 warps
    for (int d = 1; d < 32; d <<= 1) {
      const int t = __shfl_up_sync(0xffffffffu, w, d);
      if (lane >= (unsigned)d) w += t;
    }
    warp_sum[lane] = w;
  }
  __syncthreads();
  if (warp > 0) v += warp_sum[warp - 1];
  __syncthreads();
  return v;
}

// Exclusive scan of nb per-block counts into offsets (one block of NK_SCAN
// threads walks the counts in chunks, carrying the running total). Writes
// the grand total to *total and min(total, cap) to *capped (either may be
// null).
__global__ void __launch_bounds__(NK_SCAN) scan_counts(
    const int* __restrict__ counts, int nb, int* __restrict__ offsets,
    int* total, int cap, int* capped) {
  __shared__ int carry;
  if (threadIdx.x == 0) carry = 0;
  __syncthreads();
  for (int base = 0; base < nb; base += NK_SCAN) {
    const int i = base + threadIdx.x;
    const int v = i < nb ? counts[i] : 0;
    const int incl = scan_inclusive(v);
    const int c0 = carry;
    if (i < nb) offsets[i] = c0 + incl - v;
    __syncthreads();
    if (threadIdx.x == NK_SCAN - 1) carry = c0 + incl;
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    if (total) *total = carry;
    if (capped) *capped = carry < cap ? carry : cap;
  }
}

// Per-block count of a predicate (`__syncthreads_count`).
__device__ __forceinline__ void store_block_count(bool pred, int* counts) {
  const int c = __syncthreads_count(pred);
  if (threadIdx.x == 0) counts[blockIdx.x] = c;
}

// Fixed-order per-block sums of lane records (seg, v[0..4]): output
// o = s * 5 + k is the sum, in thread order, of v[k] over the block's lanes
// with seg == s (seg < 0 contributes nothing), written to
// part[o * nb + blockIdx.x]. The same inputs give the same bits every run.
__device__ void block_segment_sums(int seg, const float v[5], int nseg,
                                   float* __restrict__ part, int nb) {
  __shared__ int s_seg[NK_BLOCK];
  __shared__ float s_val[5][NK_BLOCK + 1];  // +1: no bank conflicts
  s_seg[threadIdx.x] = seg;
#pragma unroll
  for (int k = 0; k < 5; ++k) s_val[k][threadIdx.x] = v[k];
  __syncthreads();
  for (int o = threadIdx.x; o < nseg * 5; o += NK_BLOCK) {
    const int s = o / 5;
    const int k = o - 5 * s;
    float acc = 0.0f;
    for (int j = 0; j < NK_BLOCK; ++j)
      if (s_seg[j] == s) acc += s_val[k][j];
    part[(size_t)o * nb + blockIdx.x] = acc;
  }
  __syncthreads();
}

// out[o] = sum over blocks b of a[o * nb + b] (+ b2[o * nb + b]), added in
// double in a fixed order (strided per thread, then a shared-memory tree).
// One block of NK_BLOCK threads per output.
__global__ void __launch_bounds__(NK_BLOCK) reduce_partials(
    const float* __restrict__ a, const float* __restrict__ b2, int nb,
    float* __restrict__ out) {
  __shared__ double sh[NK_BLOCK];
  const int o = blockIdx.x;
  double s = 0.0;
  for (int j = threadIdx.x; j < nb; j += NK_BLOCK) {
    s += (double)a[(size_t)o * nb + j];
    if (b2) s += (double)b2[(size_t)o * nb + j];
  }
  sh[threadIdx.x] = s;
  __syncthreads();
  for (int w = NK_BLOCK / 2; w > 0; w >>= 1) {
    if (threadIdx.x < w) sh[threadIdx.x] += sh[threadIdx.x + w];
    __syncthreads();
  }
  if (threadIdx.x == 0) out[o] = (float)sh[0];
}

}  // namespace
}  // namespace nk
