// Kernel E — the large-mesh ray cast: for each ray (pos, vel, excluded
// facet), the nearest hit over a triangle mesh sorted in Morton order into
// 128-triangle chunks. Replaces the Pallas kernel
// nanokappa_tpu/ops/raycast_pallas.py (raycast_pallas :255 / _kernel :150).
// Python wrapper, host table build and plain twin:
// nanokappa_torch/ops/raycast_large.py.
//
// One thread per ray, 256 rays per block. For each chunk, every lane runs a
// slab test of its ray against the chunk's REACH box (the chunk's AABB
// widened by the barycentric tolerance's spill, so no accepted hit lies
// outside it) while the ray could still beat its running best t; when no
// lane of the block reaches the chunk (__syncthreads_or) the block skips it.
// Otherwise the block stages the chunk's 13 x 128 table words in shared
// memory and every lane solves all 128 triangles: the plane solve in the
// chunk-local frame and the dual-basis barycentrics, as explicit three-term
// dot products in a fixed order (the twin's order). Within a chunk the
// smallest t wins and, among the triangles at that t, the smallest facet id;
// across chunks only a strictly smaller t replaces the best hit. Because the
// skip is conservative, the result equals the twin's, which solves every
// chunk for every ray.
#include <math.h>

#include "scan.cuh"

namespace {

constexpr int BF = 128;   // triangles per chunk
constexpr int TAB_ROWS = 13;  // T1 (3), T2 (3), n (3), d, c1, c2, facet bits
constexpr float EPS_DET = 1e-12f;
constexpr float BARY_TOL = 1e-4f;
constexpr float T_BACK = -1e-4f;

// tab: (16, Fp) rows [T1 x3, T2 x3, n x3, d, c1, c2, facet (int32 bits)];
// frame: (16, nc) chunk table, rows 6-8 the chunk frame's origin;
// reach: (6, nc) [lo x3, hi x3] of the reach boxes; solved: (nb,) chunks
// each block solved (may be null)
__global__ void __launch_bounds__(NK_BLOCK)
cast_chunks(const float* __restrict__ pos, const float* __restrict__ vel, long long ps_n,
            long long ps_k, long long vs_n, long long vs_k, const int* __restrict__ exclude,
            int n, const float* __restrict__ tab, const float* __restrict__ frame,
            const float* __restrict__ reach, int nc, int fp, float* __restrict__ t_out,
            int* __restrict__ f_out, int* __restrict__ solved) {
  __shared__ float s_tab[TAB_ROWS][BF];
  const int i = blockIdx.x * NK_BLOCK + threadIdx.x;
  const bool live = i < n;
  float x[3] = {0.f, 0.f, 0.f}, v[3] = {0.f, 0.f, 0.f}, inv[3];
  int ex = -1;
  if (live) {
    for (int k = 0; k < 3; ++k) {
      x[k] = pos[i * ps_n + k * ps_k];
      v[k] = vel[i * vs_n + k * vs_k];
    }
    ex = exclude[i];
  }
  // robust slab reciprocal: an exact-zero component becomes 1e-30
  for (int k = 0; k < 3; ++k) inv[k] = 1.0f / (fabsf(v[k]) > 1e-30f ? v[k] : 1e-30f);
  float bt = INFINITY;
  int bf = -1;
  int n_solved = 0;
  for (int c = 0; c < nc; ++c) {
    bool r = false;
    if (live) {
      float tmin = -INFINITY, tmax = INFINITY;
      for (int k = 0; k < 3; ++k) {
        const float nr = (reach[k * nc + c] - x[k]) * inv[k];
        const float fr = (reach[(3 + k) * nc + c] - x[k]) * inv[k];
        tmin = fmaxf(tmin, fminf(nr, fr));
        tmax = fminf(tmax, fmaxf(nr, fr));
      }
      r = tmax >= fmaxf(tmin, T_BACK) && tmin < bt;
    }
    if (!__syncthreads_or(r)) continue;  // also the barrier before restaging
    ++n_solved;
    for (int o = threadIdx.x; o < TAB_ROWS * BF; o += NK_BLOCK) {
      const int row = o / BF, k = o % BF;
      s_tab[row][k] = tab[(size_t)row * fp + (size_t)c * BF + k];
    }
    __syncthreads();
    if (!live) continue;
    const float xl0 = x[0] - frame[6 * nc + c];
    const float xl1 = x[1] - frame[7 * nc + c];
    const float xl2 = x[2] - frame[8 * nc + c];
    float tmin_c = INFINITY;
    int fmin_c = 0x7fffffff;
    for (int k = 0; k < BF; ++k) {
      const float t1x = s_tab[0][k], t1y = s_tab[1][k], t1z = s_tab[2][k];
      const float t2x = s_tab[3][k], t2y = s_tab[4][k], t2z = s_tab[5][k];
      const float nx = s_tab[6][k], ny = s_tab[7][k], nz = s_tab[8][k];
      const int fid = __float_as_int(s_tab[12][k]);
      const float vn = (v[0] * nx + v[1] * ny) + v[2] * nz;
      const bool den_ok = fabsf(vn) > EPS_DET;
      const float xn = (xl0 * nx + xl1 * ny) + xl2 * nz;
      const float t_raw = (s_tab[9][k] - xn) / (den_ok ? vn : 1.0f);
      const float xt1 = (xl0 * t1x + xl1 * t1y) + xl2 * t1z;
      const float vt1 = (v[0] * t1x + v[1] * t1y) + v[2] * t1z;
      const float u = (xt1 + t_raw * vt1) - s_tab[10][k];
      const float xt2 = (xl0 * t2x + xl1 * t2y) + xl2 * t2z;
      const float vt2 = (v[0] * t2x + v[1] * t2y) + v[2] * t2z;
      const float w = (xt2 + t_raw * vt2) - s_tab[11][k];
      const float t = t_raw > T_BACK ? (t_raw > 0.0f ? t_raw : 0.0f) : INFINITY;
      const bool valid = den_ok && u >= -BARY_TOL && w >= -BARY_TOL &&
                         u + w <= 1.0f + BARY_TOL && fid != ex && fid >= 0;
      if (valid && (t < tmin_c || (t == tmin_c && fid < fmin_c))) {
        tmin_c = t;
        fmin_c = fid;
      }
    }
    if (tmin_c < bt) {  // only a strictly closer chunk replaces the best hit
      bt = tmin_c;
      bf = fmin_c;
    }
  }
  if (live) {
    t_out[i] = bt;
    f_out[i] = bf;
  }
  if (solved != nullptr && threadIdx.x == 0) solved[blockIdx.x] = n_solved;
}

}  // namespace

// pos, vel: float32 with element strides (ps_n, ps_k) / (vs_n, vs_k) of ray
// and component; exclude: (n,) int32; t_out (n,) float32, f_out (n,) int32.
extern "C" int nk_raycast_large(const void* pos, const void* vel, long long ps_n,
                                long long ps_k, long long vs_n, long long vs_k,
                                const void* exclude, int n, const void* tab,
                                const void* frame, const void* reach, int nc, int fp,
                                void* t_out, void* f_out, void* solved, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 0) return 0;
  if (fp != nc * BF) return static_cast<int>(cudaErrorInvalidValue);
  const int nb = (n + NK_BLOCK - 1) / NK_BLOCK;
  cast_chunks<<<nb, NK_BLOCK, 0, s>>>(
      static_cast<const float*>(pos), static_cast<const float*>(vel), ps_n, ps_k, vs_n, vs_k,
      static_cast<const int*>(exclude), n, static_cast<const float*>(tab),
      static_cast<const float*>(frame), static_cast<const float*>(reach), nc, fp,
      static_cast<float*>(t_out), static_cast<int*>(f_out), static_cast<int*>(solved));
  return static_cast<int>(cudaGetLastError());
}
