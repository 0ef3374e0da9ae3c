// Block-scan building blocks shared by the kernels (compact.cu,
// compact_pool.cu, megastep.cu): a per-block rank of a predicate or of a
// word of predicates, the exclusive scan of per-block counts, fixed-order
// per-block segment sums and the fixed-order reductions of per-block
// partials.
// Every helper assumes blockDim.x == NK_BLOCK and is called by all threads
// of the block (lanes past the end of the data pass a false predicate).
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

constexpr int NK_BLOCK = 256;  // threads (= lanes) per block
constexpr int NK_SCAN = 1024;  // threads of the single-block count scan (scan_runs)

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

// Inclusive scan of one int per thread over a block of T threads (T a
// multiple of 32, at most 1,024): warp shuffles, then warp 0 scans the
// warps' sums.
template <int T>
__device__ __forceinline__ int block_scan(int v) {
  static_assert(T % 32 == 0 && T <= 1024, "block_scan: 32 to 1,024 threads in whole warps");
  constexpr int WARPS = T / 32;
  __shared__ int warp_sum[WARPS];
  const unsigned lane = threadIdx.x & 31u;
  const unsigned warp = threadIdx.x >> 5;
  for (int d = 1; d < 32; d <<= 1) {
    const int t = __shfl_up_sync(0xffffffffu, v, d);
    if (lane >= (unsigned)d) v += t;
  }
  if (lane == 31) warp_sum[warp] = v;
  __syncthreads();
  if (warp == 0) {
    int w = lane < (unsigned)WARPS ? warp_sum[lane] : 0;
    for (int d = 1; d < WARPS; d <<= 1) {
      const int t = __shfl_up_sync(0xffffffffu, w, d);
      if (lane >= (unsigned)d) w += t;
    }
    if (lane < (unsigned)WARPS) warp_sum[lane] = w;
  }
  __syncthreads();
  if (warp > 0) v += warp_sum[warp - 1];
  __syncthreads();  // the shared words may be reused by the next call
  return v;
}

// Exclusive scan of nb per-block counts into offsets, in one block of
// NK_SCAN threads (kernels A and B): thread t sums its run of consecutive
// counts, one block scan of the runs, then each thread writes its run's
// offsets. Writes the grand total to *total and min(total, cap) to *capped
// (either may be null).
__global__ void __launch_bounds__(NK_SCAN) scan_runs(
    const int* __restrict__ counts, int nb, int* __restrict__ offsets,
    int* total, int cap, int* capped) {
  const int per = (nb + NK_SCAN - 1) / NK_SCAN;
  const int b0 = threadIdx.x * per;
  int run = 0;
  for (int j = 0; j < per && b0 + j < nb; ++j) run += counts[b0 + j];
  const int incl = block_scan<NK_SCAN>(run);
  int off = incl - run;
  for (int j = 0; j < per && b0 + j < nb; ++j) {
    const int v = counts[b0 + j];
    offsets[b0 + j] = off;
    off += v;
  }
  if (threadIdx.x == NK_SCAN - 1) {
    if (total) *total = incl;
    if (capped) *capped = incl < cap ? incl : cap;
  }
}

// block_rank for a word of predicates a thread (kernel C: 16 lanes a
// thread): the exclusive rank of this thread's bit 0 among the block's set
// bits, counted in thread order and, within a thread, from bit 0 up; the
// block's count in *total. One block scan of the threads' popcounts.
__device__ __forceinline__ int block_rank_bits(unsigned bits, int* total) {
  __shared__ int block_total;
  const int c = __popc(bits);
  const int incl = block_scan<NK_BLOCK>(c);
  if (threadIdx.x == NK_BLOCK - 1) block_total = incl;
  __syncthreads();
  *total = block_total;
  __syncthreads();  // the shared word may be reused by the next call
  return incl - c;
}

// Per-block count of a predicate (`__syncthreads_count`).
__device__ __forceinline__ void store_block_count(bool pred, int* counts) {
  const int c = __syncthreads_count(pred);
  if (threadIdx.x == 0) counts[blockIdx.x] = c;
}

constexpr int NK_SEG_MAX = 2 * NK_BLOCK;  // segments block_segment_sums takes

// Fixed-order per-block sums of lane records (seg, v[0..4]): output
// o = s * 5 + k is the sum, in thread order, of v[k] over the block's lanes
// with seg == s (seg < 0 contributes nothing), written to
// part[o * nb + blockIdx.x]; nseg <= NK_SEG_MAX. The same inputs give the
// same bits every run.
//
// A stable counting sort of the block's lanes by segment, all in integers —
// per-warp counts of each segment (__match_any_sync), their exclusive
// prefix over the warps, a block scan of the segments' totals, a scatter of
// the lane ids — puts each segment's lanes in one run in thread order; each
// output then adds its own run from 0.0f. Every sum adds the same values in
// the same order as a loop over all lanes would, in O(NK_BLOCK + 5 nseg)
// work a block. A block without a contributing lane writes zeros.
__device__ void block_segment_sums(int seg, const float v[5], int nseg,
                                   float* __restrict__ part, int nb) {
  __shared__ float s_val[5][NK_BLOCK];
  __shared__ short s_order[NK_BLOCK];
  __shared__ int s_off[NK_SEG_MAX + 1];
  __shared__ int s_wc[NK_BLOCK / 32][NK_SEG_MAX / 4];  // byte counts, 4 a word
  unsigned char* wc = reinterpret_cast<unsigned char*>(s_wc);
  const bool has = seg >= 0 && seg < nseg;
  if (!__syncthreads_or(has)) {
    for (int o = threadIdx.x; o < nseg * 5; o += NK_BLOCK) part[(size_t)o * nb + blockIdx.x] = 0.0f;
    return;
  }
  const unsigned lane = threadIdx.x & 31u;
  const unsigned warp = threadIdx.x >> 5;
  for (int o = threadIdx.x; o < (NK_BLOCK / 32) * (NK_SEG_MAX / 4); o += NK_BLOCK)
    (&s_wc[0][0])[o] = 0;
#pragma unroll
  for (int k = 0; k < 5; ++k) s_val[k][threadIdx.x] = v[k];
  const unsigned peers = __match_any_sync(0xffffffffu, has ? seg : -1);
  const int rank = __popc(peers & ((1u << lane) - 1u));  // among its warp's lanes of seg
  __syncthreads();
  if (has && rank == 0) wc[warp * NK_SEG_MAX + seg] = (unsigned char)__popc(peers);
  __syncthreads();
  // segments 2t and 2t + 1: the warps' counts become their exclusive prefix
  int tot[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int s = 2 * threadIdx.x + j;
    int acc = 0;
    if (s < nseg) {
      for (int w = 0; w < NK_BLOCK / 32; ++w) {
        const int c = wc[w * NK_SEG_MAX + s];
        wc[w * NK_SEG_MAX + s] = (unsigned char)acc;  // <= 224
        acc += c;
      }
    }
    tot[j] = acc;
  }
  const int incl = block_scan<NK_BLOCK>(tot[0] + tot[1]);
  const int excl = incl - tot[0] - tot[1];
  if (2 * (int)threadIdx.x < nseg) s_off[2 * threadIdx.x] = excl;
  if (2 * (int)threadIdx.x + 1 < nseg) s_off[2 * threadIdx.x + 1] = excl + tot[0];
  if (threadIdx.x == NK_BLOCK - 1) s_off[nseg] = incl;
  __syncthreads();
  if (has) s_order[s_off[seg] + wc[warp * NK_SEG_MAX + seg] + rank] = (short)threadIdx.x;
  __syncthreads();
  for (int o = threadIdx.x; o < nseg * 5; o += NK_BLOCK) {
    const int s = o / 5;
    const int k = o - 5 * s;
    float acc = 0.0f;
    for (int j = s_off[s]; j < s_off[s + 1]; ++j) acc += s_val[k][s_order[j]];
    part[(size_t)o * nb + blockIdx.x] = acc;
  }
  __syncthreads();
}

// out[o] = sum over blocks b of a[o * nb + b] (+ b2[o * nb + b]), added in
// double in a fixed order (strided per thread, then a shared-memory tree),
// by the calling block for its output o.
__device__ __forceinline__ void reduce_partials(const float* __restrict__ a,
                                                const float* __restrict__ b2, int nb, int o,
                                                float* __restrict__ out) {
  __shared__ double sh[NK_BLOCK];
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

// *out = the sum of a[0 .. nb) (integer counts), strided per thread then a
// shared-memory tree.
__device__ __forceinline__ void reduce_counts(const int* __restrict__ a, int nb,
                                              int* __restrict__ out) {
  __shared__ long long sh[NK_BLOCK];
  long long s = 0;
  for (int j = threadIdx.x; j < nb; j += NK_BLOCK) s += a[j];
  sh[threadIdx.x] = s;
  __syncthreads();
  for (int w = NK_BLOCK / 2; w > 0; w >>= 1) {
    if (threadIdx.x < w) sh[threadIdx.x] += sh[threadIdx.x + w];
    __syncthreads();
  }
  if (threadIdx.x == 0) *out = (int)sh[0];
}

}  // namespace
}  // namespace nk
