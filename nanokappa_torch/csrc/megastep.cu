// Kernel A — the drift megastep: one thread per lane of the (C, N) SoA pool,
// updated in place. C = 18 on the "slim" layout (16 particle rows + the
// slim-mirror partner mode and lifetime slope), 24 on the "full" layout
// (16 particle rows + the whole mirror cache: partner mode, omega,
// velocity, lifetime intercept, the main and the partner's slopes), 16 on
// the "plain" layout (full cached lifetimes; rough walls diffuse
// in-kernel). Replaces the Pallas kernel nanokappa_tpu/ops/megastep.py
// (drift_megastep :1067 / _kernel :298) for the box and triangle casts
// (_tri_raycast :244), slice subvolumes with nearest or linear
// temperatures (_T_interp :496-528), grid/voronoi subvolumes by nearest
// centre (_sv_of :436-481), the slim and the full mirror (:414-428,
// :689-707), in-kernel diffuse reflection (:382-402, :709-845, :883-888)
// and the export of pending lanes (:890-944), and its kernel_cast-off
// branch for large meshes (:548-570, :862-864, :1183-1190). Python wrapper,
// plain twin and the per-lane algorithm: nanokappa_torch/ops/megastep.py.
//
// Templates: TRI (triangle cast, else the box slab cast) x LAY (the pool
// layout: plain, slim or full mirror) x PRECAST (kernel_cast off: no cast
// and no event round; injections arrive pre-cast with t_enc = -t/dt - 1 in C_TCOLL
// and the real facet in C_CF, and every lane whose flight ends in the step
// exports) x SVM (the subvolume and temperature mode: slice/nearest,
// slice/linear, centre/nearest), so each path pays only for its own
// registers. PRECAST is its own instantiation because the in-kernel-diffuse
// one reads C_TCOLL < -1.5 as "already flagged" and the two encodings
// collide. The full mirror keeps six more floats than the slim one live
// across the rounds (the partner's omega, velocity, intercept and slope);
// it runs on the box and triangle casts (21 instantiations in all).
//
// Tables: the centre table [x, y, z, |c|^2] (centre mode; padded to a
// multiple of eight with rows whose key is +inf, never nearest), the facet
// table, T_sv, the lifetime grid and the triangle table (three float4 words
// a triangle) are staged in shared memory per block; the diffuse tables
// (diff2, omega_vel, |k|^2, the partner bitmask, the lifetime table) are
// gathered from global memory (they fit in the 50 MB L2) at a rough-wall
// hit only. The nearest-centre loop walks every centre (up to 256), eight
// a step with one 16-byte broadcast read a centre, twice per lane — before
// and after the drift — keeping the first minimum of |c|^2 - 2 q.c, with
// |c|^2 rounded on the host (geometry/device.py center_sq_norms). (The
// constant bank was measured slower for the centres, with indexed loads and
// with the loop unrolled in full: it is not used.)
//
// Triangle casts go through a block-local queue: the lanes that need one
// (fresh lanes, and lanes moved by an event round) post their ray to shared
// memory, and the block's threads solve the queued rays densely, G threads
// a ray (G = 32 down to 1 as the queue fills the block), each thread the
// triangles k = g, g + G, ..., the partial results combined by warp
// shuffles on the key (t, k) — the lexicographic minimum is the serial
// cast's first-minimum rule, so the answer is the same bits. A lane whose
// flight ends at a wall is a few percent of the pool, but one is enough to
// make its whole warp run a serial 32-triangle cast; the queue runs only
// the casts that exist. The triangle instantiations are held to 64
// registers (four blocks an SM), which measured faster than their own
// choice of ~80 despite a few spilled words (min_blocks).
//
// Launches: lanes (physics, pool write, pending flags, per-block counts
// and partial sums) -> scan of the per-block pending counts -> export
// (pending lanes below ecap copy their rows and pool index to their global
// rank and leave the pool; the clamped rest is binned) -> one launch of
// fixed-order reductions of the partials and counts, one block an output.
// Per-block sums use a stable counting sort of the block's lanes by
// segment (scan.cuh block_segment_sums). Integer rows are read and written
// as int32/uint32 bits only.
#include <math.h>

#include "hash.cuh"
#include "scan.cuh"

struct MegaCfg {  // mirrored by _CCfg in ops/megastep.py, field for field
  int n, n_rows, tri, sv, sv8, rta_on, flip_axis, slice_axis, ecap;
  int n_facets, n_tris, rounds, n_modes, n_tau, precast, sv_mode, cmask_w;
  unsigned int seed;
  float dt, t_ref, hbar, kb, x_ref, lo_b, inv_len, tau_tmin, tau_tmax, c0, dc;
  const float* facets;     // (n_facets, FT_W) facet table, ints as bits
  const float* tris;       // (n_tris, TRI_W) [origin, e1, e2, facet bits]
  const float* diff2;      // (NU, n_modes, 2) [alias prob, alias mode bits]
  const float* omega_vel;  // (n_modes, 4)
  const float* k2;         // (n_modes,) |k|^2
  const int* cmask;        // (n_modes, cmask_w) bit r & 31 of word r >> 5: a
                           // specular partner at row r
  const float* tau;        // (n_tau, n_modes) lifetime table
  const float* tau_T;      // (n_tau,) its temperatures
  const float* centers;    // (sv8, 4) [x, y, z, |c|^2] (centre mode only), padded
                           // with rows [0, 0, 0, +inf] that are never nearest
};

namespace {

constexpr int C_OMEGA = 6, C_TAU = 7, C_DEV = 8, C_MODE = 9, C_CF = 10,
              C_TCOLL = 11, C_ONF = 12, C_REM = 13, C_ALIVE = 14, C_SV = 15,
              R_MMODE = 16, R_TAUB = 17;
// the full mirror cache's rows, 16 + X_* (sim/state.py)
constexpr int R_XOMEGA = 17, R_XVEL = 18, R_XTAU = 21, R_XTAUB = 22, R_XMTAUB = 23;
// pool layouts (sim/state.py LAYOUT_ROWS): 16, 18 and 24 rows
constexpr int L_PLAIN = 0, L_SLIM = 1, L_FULL = 2;
// facet-table columns (ops/megastep.py FT_*)
constexpr int FT_KIND = 0, FT_RES = 1, FT_PAIR = 2, FT_VALUE = 3, FT_NORMAL = 4,
              FT_SHIFT = 7, FT_AXIS = 10, FT_SIGN = 11, FT_PLANE = 12, FT_ETA = 13,
              FT_ROW = 14, FT_ROWB = 15, FT_W = 16;
constexpr int TRI_W = 10;
constexpr int STALE = -2;
constexpr int R8 = 8;
constexpr int MAX_SV = 512;  // slice subvolumes the kernel takes (shared T_sv)
constexpr int MAX_CEN = 256;  // grid/voronoi centres its nearest-centre loop walks
// subvolume and temperature modes (ops/megastep.py SV_*)
constexpr int SV_SLICE = 0, SV_LINEAR = 1, SV_CENTER = 2;
constexpr int K_ABSORB = 1, K_PERIODIC = 2, K_ROUGH = 3;
constexpr float REMAIN_EPS = 1e-5f;
constexpr float T_BACK = -1e-4f;
constexpr float EPS_DET = 1e-12f;
constexpr float BARY_TOL = 1e-5f;
constexpr float X_MAX = 80.0f;

// NaN-propagating min/max: torch.minimum / torch.maximum / torch.clamp
// semantics (fminf/fmaxf would drop a NaN)
__device__ __forceinline__ float min_p(float a, float b) {
  return (a != a) ? a : ((b != b) ? b : (a < b ? a : b));
}
__device__ __forceinline__ float max_p(float a, float b) {
  return (a != a) ? a : ((b != b) ? b : (a > b ? a : b));
}
__device__ __forceinline__ float clamp_max(float x, float hi) { return x > hi ? hi : x; }
__device__ __forceinline__ float clamp_min(float x, float lo) { return x < lo ? lo : x; }
// a[k] for a runtime k without a dynamically indexed (local-memory) array
__device__ __forceinline__ float sel3(const float a[3], int k) {
  return k == 0 ? a[0] : (k == 1 ? a[1] : a[2]);
}

// g = n0(T, omega) - n0(T_ref, omega) (ops/kmath.py occupation_delta_T_k)
__device__ __forceinline__ float occ_delta(float T, float omega, const MegaCfg& c) {
  const bool okT = (T > 0.0f) && (omega > 0.0f);
  const bool okR = omega > 0.0f;
  float xT = okT ? (omega * c.hbar) / ((okT ? T : 1.0f) * c.kb) : 1.0f;
  xT = clamp_max(xT, X_MAX);
  float xR = okR ? omega * c.x_ref : 1.0f;
  xR = clamp_max(xR, X_MAX);
  const float eT = expm1f(xT);
  const float eR = expm1f(xR);
  const float nT = okT ? 1.0f / eT : 0.0f;
  const float nR = okR ? 1.0f / eR : 0.0f;
  return (okT && okR) ? (eR - eT) / (eT * eR) : nT - nR;
}

// n0(T_ref, a) - n0(T_ref, b) (ops/kmath.py occupation_delta_omega_k)
__device__ __forceinline__ float occ_delta_omega(float a, float b, const MegaCfg& c) {
  const bool okA = a > 0.0f;
  const bool okB = b > 0.0f;
  const float xA = clamp_max(okA ? a * c.x_ref : 1.0f, X_MAX);
  const float xB = clamp_max(okB ? b * c.x_ref : 1.0f, X_MAX);
  const float eA = expm1f(xA);
  const float eB = expm1f(xB);
  const float nA = okA ? 1.0f / eA : 0.0f;
  const float nB = okB ? 1.0f / eB : 0.0f;
  return (okA && okB) ? (eB - eA) / (eA * eB) : nA - nB;
}

// centre k's distance key |c|^2 - 2 q.c: the product by 2 is exact, so
// the fused multiply-add rounds once, as the twin's subtraction does
__device__ __forceinline__ float cen_key(const float p[3], const float4 q) {
  return __fmaf_rn(-2.0f, (p[0] * q.x + p[1] * q.y) + p[2] * q.z, q.w);
}

// the subvolume of position p: slice index arithmetic, or the first centre
// with the least |c|^2 - 2 q.c (strict < from +inf: a NaN never wins); the
// shared table is padded to sv8 rows with keys of +inf, eight centres a step
template <int SVM>
__device__ __forceinline__ int sv_of(const float p[3], const MegaCfg& c, const float4* s_cen) {
  if (SVM == SV_CENTER) {
    int best = 0;
    float bd = INFINITY;
    for (int k = 0; k < c.sv8; k += 8) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float d = cen_key(p, s_cen[k + j]);
        if (d < bd) {
          bd = d;
          best = k + j;
        }
      }
    }
    return best;
  }
  const int i = (int)((sel3(p, c.slice_axis) - c.lo_b) * c.inv_len);  // truncation
  return i < 0 ? 0 : (i > c.sv - 1 ? c.sv - 1 : i);
}

// the particle temperature at p in subvolume sv: T_sv[sv] (nearest), or the
// lerp between the slice centres around p, extrapolated past the end ones
// (linear; truncation with a fpos < 0 fix-up is floor)
template <int SVM>
__device__ __forceinline__ float T_at(const float p[3], int sv, const MegaCfg& c,
                                      const float* s_T) {
  if (SVM == SV_LINEAR) {
    const float fpos = (sel3(p, c.slice_axis) - c.c0) / c.dc;
    int lo = (int)fpos;
    lo = lo < 0 ? 0 : (lo > c.sv - 2 ? c.sv - 2 : lo);
    if (fpos < 0.0f) lo = 0;
    const float w = fpos - (float)lo;
    return s_T[lo] * (1.0f - w) + s_T[lo + 1] * w;
  }
  return s_T[sv];
}

// slab cast against the six box walls, skipping facet `exclude`
__device__ __forceinline__ void box_cast(const float p[3], const float v[3], int exclude,
                                         const float* fac, float* t_out, int* f_out) {
  float best_t = INFINITY;
  int best_f = -1;
#pragma unroll
  for (int f = 0; f < 6; ++f) {
    const float* r = fac + f * FT_W;
    const int a = __float_as_int(r[FT_AXIS]);
    const float va = sel3(v, a);
    const bool toward = va * r[FT_SIGN] > 0.0f;
    const float t_raw = (r[FT_PLANE] - sel3(p, a)) / (fabsf(va) > 1e-30f ? va : 1e-30f);
    const float t = clamp_min(t_raw, 0.0f);
    if (toward && t_raw > T_BACK && t < best_t && exclude != f) {
      best_t = t;
      best_f = f;
    }
  }
  *t_out = best_t;
  *f_out = best_f;
}

// Möller–Trumbore against triangle k of the shared table (three float4
// words a triangle: [o, e1.x], [e1.yz, e2.xy], [e2.z, facet bits, -, -]):
// ops/raycast.py tri_cast's operations in its order. True when the hit is
// valid (and not on facet `exclude`); *t the clamped hit time
__device__ __forceinline__ bool tri_hit(const float p[3], const float v[3], int exclude,
                                        const float4* tri4, int k, float* t, int* fid) {
  const float4 a = tri4[3 * k], b = tri4[3 * k + 1], q = tri4[3 * k + 2];
  const float e1x = a.w, e1y = b.x, e1z = b.y;
  const float e2x = b.z, e2y = b.w, e2z = q.x;
  *fid = __float_as_int(q.y);
  const float hx = v[1] * e2z - v[2] * e2y;
  const float hy = v[2] * e2x - v[0] * e2z;
  const float hz = v[0] * e2y - v[1] * e2x;
  const float det = (e1x * hx + e1y * hy) + e1z * hz;
  const bool okd = fabsf(det) > EPS_DET;
  const float inv = okd ? 1.0f / det : 0.0f;
  const float sx = p[0] - a.x, sy = p[1] - a.y, sz = p[2] - a.z;
  const float u = ((sx * hx + sy * hy) + sz * hz) * inv;
  const float qx = sy * e1z - sz * e1y;
  const float qy = sz * e1x - sx * e1z;
  const float qz = sx * e1y - sy * e1x;
  const float w = ((v[0] * qx + v[1] * qy) + v[2] * qz) * inv;
  const float t_raw = ((e2x * qx + e2y * qy) + e2z * qz) * inv;
  *t = clamp_min(t_raw, 0.0f);
  return okd && u >= -BARY_TOL && w >= -BARY_TOL && u + w <= 1.0f + BARY_TOL &&
         t_raw > T_BACK && exclude != *fid;
}

// The triangle cast of the block's lanes that `need` one, through a shared
// queue: every thread of the block calls it (it synchronises). The queued
// rays are solved G threads a ray (G = 32, halved until the queue fits the
// block), thread g taking triangles g, g + G, ... and keeping the nearest
// valid hit, the first of its triangles on a tie; the G partial hits
// combine by xor shuffles on the key (t, triangle): the nearest, then the
// first triangle — the serial cast's answer. Lanes that need no cast keep
// *t_out and *f_out.
__device__ void queued_cast(bool need, const float p[3], const float v[3], int exclude,
                            const float4* tri4, int n_tris, float* t_out, int* f_out) {
  __shared__ float4 q_in[2][NK_BLOCK];
  __shared__ float q_t[NK_BLOCK];
  __shared__ int q_f[NK_BLOCK];
  int total;
  const int pos = nk::block_rank(need, &total);
  if (total == 0) return;  // block-uniform
  if (need) {
    q_in[0][pos] = make_float4(p[0], p[1], p[2], v[0]);
    q_in[1][pos] = make_float4(v[1], v[2], __int_as_float(exclude), 0.0f);
  }
  __syncthreads();
  int lg = 5;  // G = 1 << lg threads a queued ray
  while (lg > 0 && (total << lg) > NK_BLOCK) --lg;
  const int G = 1 << lg;
  const int g = threadIdx.x & (G - 1);
  for (int base = 0; base < total; base += NK_BLOCK >> lg) {
    const int item = base + (threadIdx.x >> lg);
    float bt = INFINITY;
    int bk = 0x7fffffff, bf = -1;
    if (item < total) {
      const float4 a = q_in[0][item], b = q_in[1][item];
      const float qp[3] = {a.x, a.y, a.z};
      const float qv[3] = {a.w, b.x, b.y};
      const int ex = __float_as_int(b.z);
      for (int k = g; k < n_tris; k += G) {
        float t;
        int fid;
        if (tri_hit(qp, qv, ex, tri4, k, &t, &fid) && t < bt) {
          bt = t;
          bk = k;
          bf = fid;
        }
      }
    }
    for (int off = G >> 1; off > 0; off >>= 1) {
      const float ot = __shfl_xor_sync(0xffffffffu, bt, off, G);
      const int ok = __shfl_xor_sync(0xffffffffu, bk, off, G);
      const int of = __shfl_xor_sync(0xffffffffu, bf, off, G);
      if (ot < bt || (ot == bt && ok < bk)) {
        bt = ot;
        bk = ok;
        bf = of;
      }
    }
    if (item < total && g == 0) {
      q_t[item] = bt;
      q_f[item] = bf;
    }
  }
  __syncthreads();
  if (need) {
    *t_out = q_t[pos];
    *f_out = q_f[pos];
  }
}

// the ray cast of the lanes that `need` one: the box slab cast per lane, or
// the queued triangle cast (every thread of the block calls it)
template <bool TRI>
__device__ __forceinline__ void cast(bool need, const float p[3], const float v[3], int exclude,
                                     const float* fac, const float4* tri4, int n_tris,
                                     float* t_out, int* f_out) {
  if (TRI)
    queued_cast(need, p, v, exclude, tri4, n_tris, t_out, f_out);
  else if (need)
    box_cast(p, v, exclude, fac, t_out, f_out);
}

// the lifetime table's T-lerp (sim/scatter.py blend_tau_sv's arithmetic)
__device__ __forceinline__ float tau_at(float T, int m, const MegaCfg& c, const float* tT) {
  const int nT = c.n_tau;
  int cnt = 0;  // searchsorted(tau_T, T, side="left")
  for (int k = 0; k < nT; ++k) cnt += tT[k] < T ? 1 : 0;
  const int top = nT - 2 > 0 ? nT - 2 : 0;
  int i = cnt - 1;
  i = i < 0 ? 0 : (i > top ? top : i);
  const int hi = i + 1 > nT - 1 ? nT - 1 : i + 1;
  float w = (T - tT[i]) / max_p(tT[hi] - tT[i], 1e-30f);
  w = w < 0.0f ? 0.0f : (w > 1.0f ? 1.0f : w);
  return c.tau[(size_t)i * c.n_modes + m] * (1.0f - w) +
         c.tau[(size_t)hi * c.n_modes + m] * w;
}

__device__ __forceinline__ float e_bin(float omega, float dev, float T, const MegaCfg& c) {
  return (c.hbar * omega) * (dev - occ_delta(T, omega, c));
}

// blk: per-block counts [pending | alive | diffused | flagged], nb each.
// Every thread runs to the end (the queued cast and the block sums
// synchronise the block); threads past the pool's end carry a dead lane.
// blocks an SM the compiler must fit (registers): four for the triangle
// casts, five for the box casts on slices, free for the full mirror and the
// centre mode (whose extra live state would spill)
template <bool TRI, int LAY, int SVM>
constexpr int min_blocks() {
  return TRI ? 4 : (LAY == L_FULL || SVM == SV_CENTER ? 1 : 5);
}

template <bool TRI, int LAY, bool PRECAST, int SVM>
__global__ void __launch_bounds__(NK_BLOCK, (min_blocks<TRI, LAY, SVM>()))
mega_lanes(const MegaCfg c, float* __restrict__ pool, const float* __restrict__ T_sv,
           uint8_t* __restrict__ pend_flag, int* __restrict__ blk,
           float* __restrict__ part_bins, float* __restrict__ part_led) {
  extern __shared__ float4 s_dyn4[];
  const int n_cen = SVM == SV_CENTER ? c.sv8 : 0;
  float4* s_cen = s_dyn4;                                           // n_cen centres
  float4* s_tri4 = s_dyn4 + n_cen;                                  // 3 * n_tris words
  float* s_fac = reinterpret_cast<float*>(s_tri4 + 3 * c.n_tris);  // n_facets * FT_W
  for (int k = threadIdx.x; k < n_cen; k += NK_BLOCK)
    s_cen[k] = reinterpret_cast<const float4*>(c.centers)[k];
  float* s_T = s_fac + c.n_facets * FT_W;                           // sv
  float* s_tT = s_T + c.sv;                                         // n_tau
  for (int k = threadIdx.x; k < c.n_tris; k += NK_BLOCK) {
    const float* r = c.tris + (size_t)k * TRI_W;
    s_tri4[3 * k] = make_float4(r[0], r[1], r[2], r[3]);
    s_tri4[3 * k + 1] = make_float4(r[4], r[5], r[6], r[7]);
    s_tri4[3 * k + 2] = make_float4(r[8], r[9], 0.0f, 0.0f);
  }
  for (int k = threadIdx.x; k < c.n_facets * FT_W; k += NK_BLOCK) s_fac[k] = c.facets[k];
  for (int k = threadIdx.x; k < c.sv; k += NK_BLOCK) s_T[k] = T_sv[k];
  for (int k = threadIdx.x; k < c.n_tau; k += NK_BLOCK) s_tT[k] = c.tau_T[k];
  __syncthreads();
  const int N = c.n;
  const int nb = gridDim.x;
  const int i = blockIdx.x * NK_BLOCK + threadIdx.x;
  const bool live = i < N;
  constexpr bool SLIM = LAY == L_SLIM;
  constexpr bool FULL = LAY == L_FULL;
  constexpr bool SLOPE = SLIM || FULL;  // slope-form lifetimes
  const bool dkern = LAY == L_PLAIN && !PRECAST && c.n_modes > 0;  // the diffuse tables are present
  bool pend = false, sflag = false;
  int n_diff = 0;
  int seg_bin = -1, seg_led = -1;
  float bv[5] = {0.f, 0.f, 0.f, 0.f, 0.f};
  float led[5] = {0.f, 0.f, 0.f, 0.f, 0.f};

  auto row = [&](int r) -> float& { return pool[(size_t)r * N + i]; };
  float p[3] = {0.f, 0.f, 0.f}, v[3] = {0.f, 0.f, 0.f};
  float omega = 0.0f, tau = 0.0f, dev = 0.0f, t_coll = 0.0f, rem_col = 0.0f;
  int mode = 0, cf = -1, onf = -1;
  bool alive = false;
  int m_mode = 0;
  float tau_b = 0.0f;
  float m_omega = 0.0f, m_tau = 0.0f, m_tau_b = 0.0f;
  float m_v[3] = {0.f, 0.f, 0.f};
  if (live) {
    for (int k = 0; k < 3; ++k) {
      p[k] = row(k);
      v[k] = row(3 + k);
    }
    omega = row(C_OMEGA);
    tau = row(C_TAU);
    dev = row(C_DEV);
    mode = __float_as_int(row(C_MODE));
    cf = __float_as_int(row(C_CF));
    t_coll = row(C_TCOLL);
    onf = __float_as_int(row(C_ONF));
    rem_col = row(C_REM);
    alive = row(C_ALIVE) > 0.5f;
    if (SLOPE) {
      m_mode = __float_as_int(row(R_MMODE));
      tau_b = row(SLIM ? R_TAUB : R_XTAUB);
    }
    if (FULL) {
      m_omega = row(R_XOMEGA);
      for (int k = 0; k < 3; ++k) m_v[k] = row(R_XVEL + k);
      m_tau = row(R_XTAU);
      m_tau_b = row(R_XMTAUB);
    }
  }
  // a lane that won its specular draw in an earlier step but was frozen
  // by the export clamp re-enters flagged, already decided
  if (dkern && alive && t_coll < -1.5f) {
    sflag = true;
    t_coll = 0.0f;
  }

  // ---- 1. deferred RTA ----------------------------------------------------
  const int sv = sv_of<SVM>(p, c, s_cen);
  float rem = rem_col > REMAIN_EPS ? rem_col : (alive ? 1.0f : 0.0f);
  const float T_p = T_at<SVM>(p, sv, c, s_T);
  const float g = occ_delta(T_p, omega, c);
  float tau_ev = tau;
  if (SLOPE) {  // slope-form lifetime
    const float T_c = T_p < c.tau_tmin ? c.tau_tmin : (T_p > c.tau_tmax ? c.tau_tmax : T_p);
    tau_ev = tau + tau_b * T_c;
  }
  const float decay = tau_ev > 0.0f ? expf((-c.dt) / max_p(tau_ev, 1e-12f)) : 0.0f;
  // fresh: injected this step (it predates the deferred RTA)
  const bool fresh = PRECAST ? t_coll < -0.5f : cf == STALE;
  if (alive && !fresh && c.rta_on) dev = g + (dev - g) * decay;

  // ---- 2. stale-lane ray cast, or the pre-cast flight time decoded ---------
  if (PRECAST) {
    if (fresh) t_coll = -t_coll - 1.0f;
  } else {
    const bool need = alive && fresh;
    float tb = 0.0f;
    int fb = 0;
    cast<TRI>(need, p, v, onf, s_fac, s_tri4, c.n_tris, &tb, &fb);
    if (need) {
      t_coll = tb / c.dt;
      cf = fb;
    }
  }

  // ---- 3. drift --------------------------------------------------------------
  float sf = alive ? min_p(t_coll, rem) : 0.0f;
  sf = sf < 1e30f ? sf : rem;
  for (int k = 0; k < 3; ++k) p[k] = p[k] + v[k] * (c.dt * sf);
  t_coll = t_coll - sf;
  rem = alive ? max_p(rem - sf, 0.0f) : 0.0f;

  // ---- 4. in-kernel event rounds (none with PRECAST) --------------------------
  for (int round = 0; round < (PRECAST ? 0 : c.rounds); ++round) {
    const bool pd = alive && rem > REMAIN_EPS && cf >= 0 && t_coll <= 1e-9f;
    bool mv = false;
    if (pd) {
      const float* fr = s_fac + cf * FT_W;
      const int kind = __float_as_int(fr[FT_KIND]);
      const float n[3] = {fr[FT_NORMAL], fr[FT_NORMAL + 1], fr[FT_NORMAL + 2]};
      if (kind == K_ABSORB) {
        const float dn_abs = dev - occ_delta(fr[FT_VALUE], omega, c);
        const float e_abs = (c.hbar * omega) * dn_abs;
        const float vdn = (v[0] * n[0] + v[1] * n[1]) + v[2] * n[2];
        const float vmag = sqrtf((v[0] * v[0] + v[1] * v[1]) + v[2] * v[2]);
        const float vdn_safe = (vdn >= 0.0f ? 1.0f : -1.0f) * max_p(fabsf(vdn), 1e-3f * vmag);
        const float flux_w = fabsf(vdn_safe) > 1e-30f ? e_abs / vdn_safe : 0.0f;
        led[0] = led[0] + e_abs;
        led[1] = led[1] + flux_w * v[0];
        led[2] = led[2] + flux_w * v[1];
        led[3] = led[3] + flux_w * v[2];
        led[4] = led[4] + 1.0f;
        seg_led = __float_as_int(fr[FT_RES]);
        alive = false;
        rem = 0.0f;
      } else if (kind == K_PERIODIC) {
        for (int k = 0; k < 3; ++k) p[k] = p[k] + fr[FT_SHIFT + k];
        onf = __float_as_int(fr[FT_PAIR]);
        mv = true;
      } else if (kind == K_ROUGH) {
        if (SLIM) {
          if (m_mode >= 0) {  // slim-mirror swap: the partner is the exact crystal mirror
            if (c.flip_axis == 0) v[0] = -v[0];
            else if (c.flip_axis == 1) v[1] = -v[1];
            else v[2] = -v[2];
            const int t = mode;
            mode = m_mode;
            m_mode = t;
            onf = cf;
            mv = true;
          }
        } else if (FULL) {
          if (m_mode >= 0) {
            // the full mirror swap: the occupation re-referenced to the
            // partner's frequency, then mode, omega, velocity, intercept
            // and slope trade places with the cache
            dev = dev + occ_delta_omega(omega, m_omega, c);
            float t = omega;
            omega = m_omega;
            m_omega = t;
            t = tau;
            tau = m_tau;
            m_tau = t;
            t = tau_b;
            tau_b = m_tau_b;
            m_tau_b = t;
            for (int k = 0; k < 3; ++k) {
              t = v[k];
              v[k] = m_v[k];
              m_v[k] = t;
            }
            const int tm = mode;
            mode = m_mode;
            m_mode = tm;
            onf = cf;
            mv = true;
          }
        } else if (dkern && !sflag) {
          // the Bernoulli against the Ziman specularity, zero without a
          // specular partner at this wall's table row
          const float vdn = (v[0] * n[0] + v[1] * n[1]) + v[2] * n[2];
          const int r = __float_as_int(vdn < 0.0f ? fr[FT_ROWB] : fr[FT_ROW]);
          const float eta = fr[FT_ETA];
          const float v2 = (v[0] * v[0] + v[1] * v[1]) + v[2] * v[2];
          const float cos2 = (vdn * vdn) / max_p(v2, 1e-30f);
          float ps = expf((((-4.0f * eta) * eta) * cos2) * c.k2[mode]);
          const uint32_t word = (uint32_t)c.cmask[(size_t)mode * c.cmask_w + (r >> 5)];
          if (((word >> (r & 31)) & 1u) == 0u) ps = 0.0f;
          const uint32_t lane = (uint32_t)i;
          if (nk::uniform24(lane, c.seed, round, 0) >= ps) {
            // diffuse: a new mode by Walker alias over the row's creation
            // weights, occupation and lifetime at the wall temperature
            int j = (int)(nk::uniform24(lane, c.seed, round, 1) * (float)c.n_modes);
            j = j > c.n_modes - 1 ? c.n_modes - 1 : j;
            const float2 pa = reinterpret_cast<const float2*>(c.diff2)[(size_t)r * c.n_modes + j];
            const int nm = nk::uniform24(lane, c.seed, round, 2) < pa.x ? j : __float_as_int(pa.y);
            const float4 ov = reinterpret_cast<const float4*>(c.omega_vel)[nm];
            const float T_w = T_at<SVM>(p, sv_of<SVM>(p, c, s_cen), c, s_T);
            dev = occ_delta(T_w, ov.x, c);
            tau = tau_at(T_w, nm, c, s_tT);
            mode = nm;
            omega = ov.x;
            v[0] = ov.y;
            v[1] = ov.z;
            v[2] = ov.w;
            onf = cf;
            mv = true;
            ++n_diff;
          } else {
            sflag = true;  // specular: exported flagged, decided
          }
        }
      }
    }
    // moved lanes re-cast and drift on
    float tb = 0.0f;
    int fb = 0;
    cast<TRI>(mv, p, v, onf, s_fac, s_tri4, c.n_tris, &tb, &fb);
    if (mv) {
      t_coll = tb / c.dt;
      cf = fb;
      float s2 = min_p(t_coll, rem);
      s2 = s2 < 1e30f ? s2 : rem;
      for (int k = 0; k < 3; ++k) p[k] = p[k] + v[k] * (c.dt * s2);
      t_coll = t_coll - s2;
      rem = max_p(rem - s2, 0.0f);
    }
  }
  if (sflag) t_coll = -2.0f;  // the flag rides C_TCOLL out

  // ---- 5/6. pending flag, pool write, sums of the lanes that stay ------------
  pend = alive && rem > REMAIN_EPS && cf >= 0 && t_coll <= 1e-9f;
  const int sv2 = sv_of<SVM>(p, c, s_cen);
  if (live) {
    for (int k = 0; k < 3; ++k) {
      row(k) = p[k];
      row(3 + k) = v[k];
    }
    if (!SLIM) {  // a diffuse re-emission or a full swap changes the mode's properties
      row(C_OMEGA) = omega;
      row(C_TAU) = tau;
    }
    row(C_DEV) = dev;
    row(C_MODE) = __int_as_float(mode);
    row(C_CF) = __int_as_float(cf);
    row(C_TCOLL) = t_coll;
    row(C_ONF) = __int_as_float(onf);
    row(C_REM) = rem;
    row(C_ALIVE) = alive ? 1.0f : 0.0f;
    row(C_SV) = __int_as_float(sv2);
    if (SLOPE) row(R_MMODE) = __int_as_float(m_mode);
    if (FULL) {
      row(R_XOMEGA) = m_omega;
      for (int k = 0; k < 3; ++k) row(R_XVEL + k) = m_v[k];
      row(R_XTAU) = m_tau;
      row(R_XTAUB) = tau_b;
      row(R_XMTAUB) = m_tau_b;
    }
    pend_flag[i] = pend ? 1 : 0;
  }
  if (alive && !pend) {
    const float e = e_bin(omega, dev, s_T[sv2], c);
    seg_bin = sv2;
    bv[0] = e;
    bv[1] = e * v[0];
    bv[2] = e * v[1];
    bv[3] = e * v[2];
    bv[4] = 1.0f;
  }
  const int n_pend = __syncthreads_count(pend);
  const int n_alive = __syncthreads_count(alive);
  const int n_dff = __syncthreads_count(n_diff >= 1) + __syncthreads_count(n_diff >= 2);
  const int n_flag = __syncthreads_count(pend && sflag);
  if (threadIdx.x == 0) {
    blk[blockIdx.x] = n_pend;
    blk[nb + blockIdx.x] = n_alive;
    blk[2 * nb + blockIdx.x] = n_dff;
    blk[3 * nb + blockIdx.x] = n_flag;
  }
  nk::block_segment_sums(seg_bin, bv, c.sv8, part_bins, nb);
  nk::block_segment_sums(seg_led, led, R8, part_led, nb);
}

__global__ void __launch_bounds__(NK_BLOCK)
mega_export(const MegaCfg c, float* __restrict__ pool, const float* __restrict__ T_sv,
            const uint8_t* __restrict__ pend_flag, const int* __restrict__ pend_off,
            float* __restrict__ rows, int* __restrict__ idx,
            float* __restrict__ part_frozen, const int* __restrict__ cnt) {
  const int N = c.n;
  const int nb = gridDim.x;
  const int i = blockIdx.x * NK_BLOCK + threadIdx.x;
  __shared__ float s_T[MAX_SV];
  for (int k = threadIdx.x; k < c.sv; k += NK_BLOCK) s_T[k] = T_sv[k];
  const bool p = i < N && pend_flag[i] != 0;
  int total;
  const int r = nk::block_rank(p, &total);
  // with no lane frozen anywhere (pending <= ecap) the frozen partials are
  // neither written nor read (mega_reduce)
  const bool any_frozen = cnt[0] > cnt[2];
  if (total == 0) {  // block-uniform: no pending lane here
    if (any_frozen)
      for (int o = threadIdx.x; o < c.sv8 * 5; o += NK_BLOCK)
        part_frozen[(size_t)o * nb + blockIdx.x] = 0.0f;
    return;
  }
  int seg = -1;
  float bv[5] = {0.f, 0.f, 0.f, 0.f, 0.f};
  if (p) {
    const int g = pend_off[blockIdx.x] + r;
    const uint32_t* src = reinterpret_cast<const uint32_t*>(pool);
    if (g < c.ecap) {  // exported: the row leaves the pool
      // eight rows loaded before they are stored: the loads overlap
      uint32_t* dst = reinterpret_cast<uint32_t*>(rows);
      for (int k0 = 0; k0 < c.n_rows; k0 += 8) {
        uint32_t w[8];
#pragma unroll
        for (int k = 0; k < 8; ++k)
          w[k] = k0 + k < c.n_rows ? src[(size_t)(k0 + k) * N + i] : 0u;
#pragma unroll
        for (int k = 0; k < 8; ++k)
          if (k0 + k < c.n_rows) dst[(size_t)(k0 + k) * c.ecap + g] = k0 + k == C_ALIVE ? 0u : w[k];
      }
      idx[g] = i;
      pool[(size_t)C_ALIVE * N + i] = 0.0f;
    } else {  // frozen by the clamp: stays (pending) and is binned here
      const float omega = pool[(size_t)C_OMEGA * N + i];
      const int sv = __float_as_int(pool[(size_t)C_SV * N + i]);
      const float e = e_bin(omega, pool[(size_t)C_DEV * N + i], s_T[sv], c);
      seg = sv;
      bv[0] = e;
      for (int k = 0; k < 3; ++k) bv[1 + k] = e * pool[(size_t)(3 + k) * N + i];
      bv[4] = 1.0f;
    }
  }
  if (any_frozen) nk::block_segment_sums(seg, bv, c.sv8, part_frozen, nb);
}

// One block an output, in this order: the bins (the staying lanes' and the
// frozen lanes' partials), the ledger, then the alive, diffused and flagged
// counts; every sum in its fixed order (scan.cuh reduce_partials /
// reduce_counts).
__global__ void __launch_bounds__(NK_BLOCK)
mega_reduce(const float* __restrict__ part_bins, const float* __restrict__ part_frozen,
            const float* __restrict__ part_led, const int* __restrict__ blk, int nb, int nbins,
            float* __restrict__ bins, float* __restrict__ ledger, int* __restrict__ cnt) {
  const int o = blockIdx.x;
  if (o < nbins) {  // counts: [pending, alive, kept, ...]; frozen = pending - kept
    nk::reduce_partials(part_bins, cnt[0] > cnt[2] ? part_frozen : nullptr, nb, o, bins);
  } else if (o < nbins + R8 * 5) {
    nk::reduce_partials(part_led, nullptr, nb, o - nbins, ledger);
  } else {  // alive -> counts[1], diffused -> counts[3], flagged -> counts[4]
    const int j = o - nbins - R8 * 5;
    nk::reduce_counts(blk + (size_t)(1 + j) * nb, nb, cnt + (j == 0 ? 1 : j + 2));
  }
}

template <bool TRI, int LAY, bool PRECAST, int SVM>
void launch_lanes(const MegaCfg& c, int nb, size_t smem, cudaStream_t s, float* pool,
                  const float* T, uint8_t* flag, int* blk, float* part_bins,
                  float* part_led) {
  mega_lanes<TRI, LAY, PRECAST, SVM><<<nb, NK_BLOCK, smem, s>>>(c, pool, T, flag, blk,
                                                                part_bins, part_led);
}

template <bool TRI, int SVM>
void launch_layout(int lay, const MegaCfg& c, int nb, size_t smem, cudaStream_t s, float* pool,
                   const float* T, uint8_t* flag, int* blk, float* part_bins, float* part_led) {
  if (lay == L_SLIM)
    launch_lanes<TRI, L_SLIM, false, SVM>(c, nb, smem, s, pool, T, flag, blk, part_bins, part_led);
  else if (lay == L_FULL)
    launch_lanes<TRI, L_FULL, false, SVM>(c, nb, smem, s, pool, T, flag, blk, part_bins, part_led);
  else
    launch_lanes<TRI, L_PLAIN, false, SVM>(c, nb, smem, s, pool, T, flag, blk, part_bins, part_led);
}

// the instantiations a gate can reach: every cast/layout branch (the
// cast-off one on the plain layout only) in each subvolume/temperature mode
template <int SVM>
int dispatch_lanes(const MegaCfg& c, int nb, size_t smem, cudaStream_t s, float* pool,
                   const float* T, uint8_t* flag, int* blk, float* part_bins,
                   float* part_led) {
  const int lay = c.n_rows == 18 ? L_SLIM : (c.n_rows == 24 ? L_FULL : L_PLAIN);
  if (c.precast) {  // the plain pool only; no facet or triangle table
    if (lay != L_PLAIN || c.n_facets != 0 || c.n_tris != 0 || c.rounds != 0)
      return static_cast<int>(cudaErrorInvalidValue);
    launch_lanes<false, L_PLAIN, true, SVM>(c, nb, smem, s, pool, T, flag, blk, part_bins, part_led);
  } else if (c.tri) {
    launch_layout<true, SVM>(lay, c, nb, smem, s, pool, T, flag, blk, part_bins, part_led);
  } else {
    launch_layout<false, SVM>(lay, c, nb, smem, s, pool, T, flag, blk, part_bins, part_led);
  }
  return 0;
}

}  // namespace

// scratch_f: nb * (2 * sv8 + 8) * 5 floats; scratch_i: 5 * nb + 4 ints;
// pend: N bytes (nb = ceil(N / NK_BLOCK)). counts = [pending, alive, kept,
// diffused, flagged]; idx must arrive filled with N (the lanes past kept).
extern "C" int nk_megastep(const void* cfg, void* pool, const void* T_sv, void* rows,
                           void* idx, void* counts, void* ledger, void* bins,
                           void* scratch_f, void* scratch_i, void* pend, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const MegaCfg c = *static_cast<const MegaCfg*>(cfg);
  const int nb = (c.n + NK_BLOCK - 1) / NK_BLOCK;
  if (nb == 0 || c.sv > MAX_SV || (c.n_rows != 16 && c.n_rows != 18 && c.n_rows != 24) ||
      (c.sv_mode == SV_CENTER && (c.sv8 > MAX_CEN || c.centers == nullptr)) ||
      (c.sv_mode == SV_LINEAR && c.sv < 2))
    return static_cast<int>(cudaErrorInvalidValue);
  float* part_bins = static_cast<float*>(scratch_f);
  float* part_frozen = part_bins + (size_t)nb * c.sv8 * 5;
  float* part_led = part_frozen + (size_t)nb * c.sv8 * 5;
  int* blk = static_cast<int*>(scratch_i);  // pending | alive | diffused | flagged
  int* pend_off = blk + 4 * nb;
  int* cnt = static_cast<int*>(counts);
  float* p = static_cast<float*>(pool);
  const float* T = static_cast<const float*>(T_sv);
  uint8_t* flag = static_cast<uint8_t*>(pend);
  const size_t n_cen = c.sv_mode == SV_CENTER ? c.sv8 : 0;
  const size_t smem = sizeof(float4) * (n_cen + 3 * (size_t)c.n_tris) +
                      sizeof(float) * ((size_t)c.n_facets * FT_W + c.sv + c.n_tau);

  int bad;
  if (c.sv_mode == SV_SLICE)
    bad = dispatch_lanes<SV_SLICE>(c, nb, smem, s, p, T, flag, blk, part_bins, part_led);
  else if (c.sv_mode == SV_LINEAR)
    bad = dispatch_lanes<SV_LINEAR>(c, nb, smem, s, p, T, flag, blk, part_bins, part_led);
  else if (c.sv_mode == SV_CENTER)
    bad = dispatch_lanes<SV_CENTER>(c, nb, smem, s, p, T, flag, blk, part_bins, part_led);
  else
    bad = static_cast<int>(cudaErrorInvalidValue);
  if (bad) return bad;
  nk::scan_runs<<<1, NK_SCAN, 0, s>>>(blk, nb, pend_off, cnt + 0, c.ecap, cnt + 2);
  mega_export<<<nb, NK_BLOCK, 0, s>>>(c, p, T, flag, pend_off, static_cast<float*>(rows),
                                      static_cast<int*>(idx), part_frozen, cnt);
  mega_reduce<<<c.sv8 * 5 + R8 * 5 + 3, NK_BLOCK, 0, s>>>(
      part_bins, part_frozen, part_led, blk, nb, c.sv8 * 5, static_cast<float*>(bins),
      static_cast<float*>(ledger), cnt);
  return static_cast<int>(cudaGetLastError());
}
