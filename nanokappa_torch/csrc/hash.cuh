// The counter-based random numbers of kernel A's in-kernel draws: each
// uniform is a pure function of (pool lane, step seed, round, draw index),
// so the kernel and its plain torch twin (nanokappa_torch/ops/megastep.py
// lowbias32 / uniform24, int64 arithmetic masked to 32 bits) draw the same
// numbers. Two rounds of the lowbias32 finaliser give full avalanche; the
// low 24 bits make the uniform (exact in float32).
#pragma once

#include <cstdint>

namespace nk {
namespace {

__host__ __device__ __forceinline__ uint32_t lowbias32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7feb352du;
  x ^= x >> 15;
  x *= 0x846ca68bu;
  x ^= x >> 16;
  return x;
}

// draw k of round `round` of pool lane `lane` under the step seed, in [0, 1)
__device__ __forceinline__ float uniform24(uint32_t lane, uint32_t seed, int round, int k) {
  const uint32_t key = lowbias32(seed + 0x9e3779b9u * (uint32_t)(4 * round + k + 1));
  const uint32_t h = lowbias32(lowbias32(lane ^ key));
  return (float)(h & 0xffffffu) * (1.0f / 16777216.0f);
}

}  // namespace
}  // namespace nk
