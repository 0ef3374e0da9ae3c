// Kernel E — the large-mesh ray cast: for each ray (pos, vel, excluded
// facet), the nearest hit over a triangle mesh sorted in Morton order into
// 128-triangle chunks. Replaces the Pallas kernel
// nanokappa_tpu/ops/raycast_pallas.py (raycast_pallas :255 / _kernel :150).
// Python wrapper, host table build, launch shape and plain twin:
// nanokappa_torch/ops/raycast_large.py.
//
// The function: within a chunk the smallest t wins and, among the triangles
// at that t, the smallest facet id; across chunks only a strictly smaller t
// replaces the best hit. That rule is the lexicographic minimum of the key
// (t, chunk, facet) over the valid hits of finite t, so any partition of the
// (chunk, triangle) pairs among threads, each keeping its own minimum of the
// key, combines (in any order) to the twin's answer bit for bit.
//
// Launch shape: G threads share one ray (raycast_large.py launch_shape
// picks G = 16, 8 or 1 from the ray count; those are the instantiations),
// each solving the triangles k = g, g + G, ... of every chunk the ray
// reaches; a block has 256 threads and 256 / G rays. A few thousand rays
// fill the card only when threads share them (3,304 rays at G = 16 are 207
// blocks on 132 SMs); the pool width takes G = 1.
// The G partial minima combine by __shfl_xor_sync on the key. (R rays a
// thread, each record read serving R rays, was measured slower at every
// width and is not kept: the solve, not the loads, bounds the kernel.)
//
// Per chunk, every thread runs the slab test of its ray against the
// chunk's REACH box (the chunk's box widened by the barycentric tolerance's
// spill, so no accepted hit lies outside it) while the ray could still beat
// the thread's running best t; a block stages a chunk only when one of its
// rays reaches it (__syncthreads_or), and a thread solves it only when its
// ray does. The thread's own best is never better than the ray's final hit,
// and a later chunk's hit at an equal t loses on the key, so the skip never
// changes a result: the twin, which solves every chunk for every ray, is the
// exact oracle.
//
// Triangle records: 16 floats a triangle (T1, T2, n, d, c1, c2, facet bits,
// pad), staged with cp.async into shared memory as four float4 planes (plane
// j holds float4 j of every record: neighbouring threads read neighbouring
// 16-byte words), double-buffered: the next reached chunk loads while the
// current one is solved. The per-pair arithmetic and its order are the
// twin's (explicit three-term dot products, an IEEE division, --fmad=false).
// What bounds it: about 46 float32 operations per (ray, triangle) pair of a
// reached chunk; without fused multiply-adds (--fmad=false, for bit parity)
// each is one instruction.
#include <math.h>

#include "scan.cuh"

namespace {

constexpr int BF = 128;  // triangles per chunk
constexpr int REC4 = 4;  // float4 words per triangle record
constexpr float EPS_DET = 1e-12f;
constexpr float BARY_TOL = 1e-4f;
constexpr float T_BACK = -1e-4f;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// (t, chunk, facet) lexicographic order
__device__ __forceinline__ bool key_less(float t, int c, int f, float bt, int bc, int bf) {
  return t < bt || (t == bt && (c < bc || (c == bc && f < bf)));
}

// rec: (Fp, 16) triangle records; frame: (16, nc) chunk table, rows 6-8 the
// chunk frame's origin; reach: (6, nc) [lo x3, hi x3] of the reach boxes;
// staged: (grid,) chunks each block staged (may be null)
template <int G>
__global__ void __launch_bounds__(NK_BLOCK)
cast_chunks(const float* __restrict__ pos, const float* __restrict__ vel, long long ps_n,
            long long ps_k, long long vs_n, long long vs_k, const int* __restrict__ exclude,
            int n, const float4* __restrict__ rec, const float* __restrict__ frame,
            const float* __restrict__ reach, int nc, float* __restrict__ t_out,
            int* __restrict__ f_out, int* __restrict__ staged) {
  constexpr int RAYS = NK_BLOCK / G;  // rays a block
  __shared__ float4 s_rec[2][REC4][BF];
  const int g = threadIdx.x % G;
  const long long i = (long long)blockIdx.x * RAYS + threadIdx.x / G;
  const bool live = i < n;
  float x[3], v[3], inv[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    x[k] = live ? pos[i * ps_n + k * ps_k] : 0.0f;
    v[k] = live ? vel[i * vs_n + k * vs_k] : 0.0f;
    // robust slab reciprocal: an exact-zero component becomes 1e-30
    inv[k] = 1.0f / (fabsf(v[k]) > 1e-30f ? v[k] : 1e-30f);
  }
  const int ex = live ? exclude[i] : -1;
  float bt = INFINITY;
  int bc = 0x7fffffff, bf = 0x7fffffff;

  // the ray reaches chunk c's box before the thread's best hit
  auto reaches = [&](int c) -> bool {
    float tmin = -INFINITY, tmax = INFINITY;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float nr = (reach[k * nc + c] - x[k]) * inv[k];
      const float fr = (reach[(3 + k) * nc + c] - x[k]) * inv[k];
      tmin = fmaxf(tmin, fminf(nr, fr));
      tmax = fminf(tmax, fmaxf(nr, fr));
    }
    return live && tmax >= fmaxf(tmin, T_BACK) && tmin < bt;
  };
  auto stage = [&](int buf, int c) {
    const float4* src = rec + (size_t)c * BF * REC4;
    for (int o = threadIdx.x; o < BF * REC4; o += NK_BLOCK)
      cp_async16(&s_rec[buf][o % REC4][o / REC4], src + o);
    cp_async_commit();
  };

  int n_staged = 0;
  int cur = 0;
  bool r_cur = false;
  for (; cur < nc; ++cur) {
    r_cur = reaches(cur);
    if (__syncthreads_or(r_cur)) break;
  }
  int buf = 0;
  if (cur < nc) stage(0, cur);
  while (cur < nc) {
    // the next chunk a ray of the block reaches (tested against the best
    // before this chunk: conservative), staged while this one is solved
    int nxt = cur + 1;
    bool r_nxt = false;
    for (; nxt < nc; ++nxt) {
      r_nxt = reaches(nxt);
      if (__syncthreads_or(r_nxt)) break;
    }
    if (nxt < nc) {
      stage(buf ^ 1, nxt);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    ++n_staged;
    if (r_cur) {
      const float xl0 = x[0] - frame[6 * nc + cur];
      const float xl1 = x[1] - frame[7 * nc + cur];
      const float xl2 = x[2] - frame[8 * nc + cur];
      const float4* s0 = s_rec[buf][0];
      const float4* s1 = s_rec[buf][1];
      const float4* s2 = s_rec[buf][2];
      const float4* s3 = s_rec[buf][3];
      for (int k = g; k < BF; k += G) {
        const float4 a = s0[k], b = s1[k], q = s2[k];
        const int fid = __float_as_int(s3[k].x);
        const float t1x = a.x, t1y = a.y, t1z = a.z, t2x = a.w, t2y = b.x, t2z = b.y;
        const float nx = b.z, ny = b.w, nz = q.x, d = q.y, c1 = q.z, c2 = q.w;
        const float vn = (v[0] * nx + v[1] * ny) + v[2] * nz;
        const bool den_ok = fabsf(vn) > EPS_DET;
        const float xn = (xl0 * nx + xl1 * ny) + xl2 * nz;
        const float t_raw = (d - xn) / (den_ok ? vn : 1.0f);
        const float xt1 = (xl0 * t1x + xl1 * t1y) + xl2 * t1z;
        const float vt1 = (v[0] * t1x + v[1] * t1y) + v[2] * t1z;
        const float u = (xt1 + t_raw * vt1) - c1;
        const float xt2 = (xl0 * t2x + xl1 * t2y) + xl2 * t2z;
        const float vt2 = (v[0] * t2x + v[1] * t2y) + v[2] * t2z;
        const float w = (xt2 + t_raw * vt2) - c2;
        const float t = t_raw > T_BACK ? (t_raw > 0.0f ? t_raw : 0.0f) : INFINITY;
        const bool valid = den_ok && u >= -BARY_TOL && w >= -BARY_TOL &&
                           u + w <= 1.0f + BARY_TOL && fid != ex && fid >= 0 && t < INFINITY;
        // chunks run in ascending order, so cur >= bc here
        if (valid && (t < bt || (t == bt && cur == bc && fid < bf))) {
          bt = t;
          bc = cur;
          bf = fid;
        }
      }
    }
    __syncthreads();  // every read of this buffer is done before it is restaged
    cur = nxt;
    r_cur = r_nxt;
    buf ^= 1;
  }

#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1) {
    const float ot = __shfl_xor_sync(0xffffffffu, bt, off, G);
    const int oc = __shfl_xor_sync(0xffffffffu, bc, off, G);
    const int of = __shfl_xor_sync(0xffffffffu, bf, off, G);
    if (key_less(ot, oc, of, bt, bc, bf)) {
      bt = ot;
      bc = oc;
      bf = of;
    }
  }
  if (live && g == 0) {
    t_out[i] = bt;
    f_out[i] = bt < INFINITY ? bf : -1;
  }
  if (staged != nullptr && threadIdx.x == 0) staged[blockIdx.x] = n_staged;
}

template <int G>
void launch(int nb, cudaStream_t s, const float* pos, const float* vel, long long ps_n,
            long long ps_k, long long vs_n, long long vs_k, const int* exclude, int n,
            const float4* rec, const float* frame, const float* reach, int nc, float* t_out,
            int* f_out, int* staged) {
  cast_chunks<G><<<nb, NK_BLOCK, 0, s>>>(pos, vel, ps_n, ps_k, vs_n, vs_k, exclude, n, rec,
                                         frame, reach, nc, t_out, f_out, staged);
}

}  // namespace

// pos, vel: float32 with element strides (ps_n, ps_k) / (vs_n, vs_k) of ray
// and component; exclude: (n,) int32; rec: (nc * 128, 16) float32 records;
// t_out (n,) float32, f_out (n,) int32; staged: one int32 per block (may be
// null). g: threads per ray, 1, 8 or 16 (raycast_large.py launch_shape).
extern "C" int nk_raycast_large(const void* pos, const void* vel, long long ps_n,
                                long long ps_k, long long vs_n, long long vs_k,
                                const void* exclude, int n, const void* rec,
                                const void* frame, const void* reach, int nc, int g,
                                void* t_out, void* f_out, void* staged, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 0) return 0;
  if (nc <= 0 || (g != 1 && g != 8 && g != 16)) return static_cast<int>(cudaErrorInvalidValue);
  const int rays = NK_BLOCK / g;
  const int nb = (int)(((long long)n + rays - 1) / rays);
  const float* p = static_cast<const float*>(pos);
  const float* v = static_cast<const float*>(vel);
  const int* e = static_cast<const int*>(exclude);
  const float4* rc = static_cast<const float4*>(rec);
  const float* fr = static_cast<const float*>(frame);
  const float* re = static_cast<const float*>(reach);
  float* to = static_cast<float*>(t_out);
  int* fo = static_cast<int*>(f_out);
  int* st = static_cast<int*>(staged);
#define NK_E_LAUNCH(G_) launch<G_>(nb, s, p, v, ps_n, ps_k, vs_n, vs_k, e, n, rc, fr, re, nc, to, fo, st)
  switch (g) {
    case 1: NK_E_LAUNCH(1); break;
    case 8: NK_E_LAUNCH(8); break;
    default: NK_E_LAUNCH(16); break;
  }
#undef NK_E_LAUNCH
  return static_cast<int>(cudaGetLastError());
}
