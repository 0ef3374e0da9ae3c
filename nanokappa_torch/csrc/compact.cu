// Kernel C — stream compaction: indices of a mask's True lanes, in ascending
// order, packed to the front of a cap-wide buffer; the sentinel n fills the
// rest. Replaces the Pallas kernel nanokappa_tpu/ops/compact.py
// (compact_indices_pallas :68 / _kernel :36). Python wrapper and plain twin:
// nanokappa_torch/ops/compact.py.
//
// One launch a call: a single-pass chained scan with decoupled look-back.
// A tile is NK_BLOCK threads x 16 mask bytes (one 16-byte load a thread);
// its id comes from an atomic ticket, so a tile only ever waits on tiles that
// are already running. Each tile publishes its count, then its inclusive
// prefix, in a 64-bit status word (flag | count), and finds its own
// exclusive prefix by reading its predecessors' words a warp's width at a
// time, nearest first, down to the nearest inclusive one. The tile with the
// last id writes n_valid and the sentinel tail; the last tile to finish
// clears the scratch (ticket, status words, finished count), so the next
// call, or a CUDA graph's replay, finds it zeroed: no host-side epoch, no
// memset launch.
#include "scan.cuh"

namespace {

constexpr int C_LANES = 16;                  // mask bytes a thread: one 16-byte load
constexpr int C_TILE = NK_BLOCK * C_LANES;   // 4,096 lanes a tile
constexpr unsigned long long ST_AGG = 1ull << 32;   // status: the tile's own count
constexpr unsigned long long ST_INCL = 2ull << 32;  // status: the count through the tile
constexpr unsigned FULL = 0xffffffffu;

// bit k set when byte k of u is non-zero
__device__ __forceinline__ unsigned nonzero4(unsigned u) {
  const unsigned r = __vcmpne4(u, 0u);  // 0xff in each non-zero byte
  return (r & 1u) | ((r >> 7) & 2u) | ((r >> 14) & 4u) | ((r >> 21) & 8u);
}

// The predicates of 16 lanes as bits: lane i = v0 - head + k is bit k, set
// when 0 <= i < n and mask[i] != 0. Lanes are counted from the 16-byte
// boundary at or below the mask's start (head = its address mod 16), so a
// chunk that lies wholly inside the mask is one aligned 16-byte load; the
// ragged head and tail take byte loads, and nothing outside [0, n) is read.
__device__ __forceinline__ unsigned load_bits(const uint8_t* __restrict__ mask, long long n,
                                              int head, long long v0) {
  const long long i0 = v0 - head;
  if (i0 >= 0 && i0 + C_LANES <= n) {
    const uint4 q = *reinterpret_cast<const uint4*>(mask + i0);
    return nonzero4(q.x) | nonzero4(q.y) << 4 | nonzero4(q.z) << 8 | nonzero4(q.w) << 12;
  }
  unsigned bits = 0;
  for (int k = 0; k < C_LANES; ++k) {
    const long long i = i0 + k;
    if (i >= 0 && i < n && mask[i] != 0) bits |= 1u << k;
  }
  return bits;
}

__device__ __forceinline__ unsigned long long load_status(const unsigned long long* p) {
  return *reinterpret_cast<const volatile unsigned long long*>(p);
}

__device__ __forceinline__ void store_status(unsigned long long* p, unsigned long long w) {
  *reinterpret_cast<volatile unsigned long long*>(p) = w;
}

// The exclusive prefix of tile t >= 1, by warp 0: each lane reads one of 32
// predecessors (nearest first), the warp waits until every one of them holds
// a count, then adds the counts down to the nearest inclusive prefix (before
// tile 0: an inclusive 0), or all 32 aggregates and moves on.
__device__ int look_back(const unsigned long long* status, int t) {
  const int lane = threadIdx.x & 31;
  int excl = 0;
  for (int j = t - 1;; j -= 32) {
    const int k = j - lane;
    unsigned long long w = k >= 0 ? load_status(status + k) : ST_INCL;
    while (__any_sync(FULL, (w >> 32) == 0ull))
      if ((w >> 32) == 0ull) w = load_status(status + k);
    const unsigned incl = __ballot_sync(FULL, (w >> 32) == 2ull);
    const int stop = incl ? __ffs(incl) - 1 : 31;
    int v = lane <= stop ? static_cast<int>(static_cast<unsigned>(w)) : 0;
    for (int d = 16; d > 0; d >>= 1) v += __shfl_xor_sync(FULL, v, d);
    excl += v;
    if (incl) return excl;
  }
}

// scratch: [0] the ticket (low word) and the finished count (high word),
// then one status word a tile; all zero between calls.
__global__ void __launch_bounds__(NK_BLOCK)
compact_lookback(const uint8_t* __restrict__ mask, long long n, int head, int tiles, int cap,
                 int* __restrict__ out, unsigned long long* __restrict__ scratch) {
  __shared__ int s_tile, s_excl;
  __shared__ bool s_last;
  unsigned* ctrl = reinterpret_cast<unsigned*>(scratch);
  unsigned long long* status = scratch + 1;
  if (threadIdx.x == 0) s_tile = static_cast<int>(atomicAdd(ctrl, 1u));
  __syncthreads();
  const int t = s_tile;
  const long long v0 = static_cast<long long>(t) * C_TILE + threadIdx.x * C_LANES;
  const unsigned bits = load_bits(mask, n, head, v0);
  int agg;
  const int rank = nk::block_rank_bits(bits, &agg);
  if (threadIdx.x < 32) {
    int excl = 0;
    if (t == 0) {
      if (threadIdx.x == 0) store_status(status, ST_INCL | static_cast<unsigned>(agg));
    } else {
      if (threadIdx.x == 0) store_status(status + t, ST_AGG | static_cast<unsigned>(agg));
      excl = look_back(status, t);
      if (threadIdx.x == 0) store_status(status + t, ST_INCL | static_cast<unsigned>(excl + agg));
    }
    if (threadIdx.x == 0) s_excl = excl;
  }
  __syncthreads();
  const int excl = s_excl;
  // this thread's True lanes, in lane order, at their global ranks below cap
  const long long i0 = v0 - head;
  int g = excl + rank;
  for (unsigned b = bits; b && g < cap; b &= b - 1, ++g) out[g] = static_cast<int>(i0 + __ffs(b) - 1);
  if (t == tiles - 1) {
    const int total = excl + agg;
    const int nv = total < cap ? total : cap;
    // the sentinel tail [nv, cap): 16-byte stores between its aligned ends
    const int lo = min((nv + 3) & ~3, cap), hi = max(cap & ~3, lo);
    const int s = static_cast<int>(n);
    for (int j = nv + threadIdx.x; j < lo; j += NK_BLOCK) out[j] = s;
    for (int j = lo + 4 * threadIdx.x; j < hi; j += 4 * NK_BLOCK)
      *reinterpret_cast<int4*>(out + j) = make_int4(s, s, s, s);
    for (int j = hi + threadIdx.x; j < cap; j += NK_BLOCK) out[j] = s;
    if (threadIdx.x == 0) out[cap] = nv;
  }
  // every read of the status words is done: count this tile finished, and
  // let the last one clear the scratch for the next call
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    s_last = atomicAdd(ctrl + 1, 1u) == static_cast<unsigned>(tiles - 1);
  }
  __syncthreads();
  if (s_last) {
    for (int j = threadIdx.x; j < tiles; j += NK_BLOCK) status[j] = 0ull;
    if (threadIdx.x == 0) scratch[0] = 0ull;
  }
}

}  // namespace

// out: cap + 1 ints, 16-byte aligned (the indices, then n_valid =
// min(count, cap)). scratch: 1 + ceil((n + 15) / 4096) zeroed 64-bit words,
// left zeroed.
extern "C" int nk_compact_indices(const void* mask, long long n, int cap, void* out,
                                  void* scratch, void* stream) {
  if (reinterpret_cast<uintptr_t>(out) & 15u) return static_cast<int>(cudaErrorMisalignedAddress);
  const int head = static_cast<int>(reinterpret_cast<uintptr_t>(mask) & 15u);
  const long long t = (n + head + C_TILE - 1) / C_TILE;
  const int tiles = t > 0 ? static_cast<int>(t) : 1;
  compact_lookback<<<tiles, NK_BLOCK, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(mask), n, head, tiles, cap, static_cast<int*>(out),
      static_cast<unsigned long long*>(scratch));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* nk_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
