// Kernel A — the drift megastep on the film's branch: one thread per lane of
// the (18, N) SoA pool (16 particle rows + the slim-mirror partner mode and
// lifetime slope), updated in place. Replaces the Pallas kernel
// nanokappa_tpu/ops/megastep.py (drift_megastep :1067 / _kernel :298) for
// the box cast, slice subvolumes, nearest temperatures, the slim mirror and
// row export. Python wrapper, plain twin and the per-lane algorithm:
// nanokappa_torch/ops/megastep.py.
//
// Launches: lanes (physics, pool write, pending flags, per-block partial
// sums) -> scan of the per-block pending counts -> export (pending lanes
// below ecap copy their rows to their global rank and leave the pool; the
// clamped rest is binned) -> fixed-order reductions of the partials.
// Integer rows are read and written as int32/uint32 bits only.
#include <math.h>

#include "scan.cuh"

struct MegaCfg {  // mirrored by _CCfg in ops/megastep.py, field for field
  int n, sv, sv8, rta_on, flip_axis, slice_axis, ecap;
  float dt, t_ref, hbar, kb, x_ref, lo_b, inv_len, tau_tmin, tau_tmax;
  int kind[6], box_axis[6];
  float box_sign[6], box_plane[6], value[6];
  int res[6];
  float normal[18], shift[18];
  int pair[6];
};

namespace {

constexpr int C_OMEGA = 6, C_TAU = 7, C_DEV = 8, C_MODE = 9, C_CF = 10,
              C_TCOLL = 11, C_ONF = 12, C_REM = 13, C_ALIVE = 14, C_SV = 15,
              R_MMODE = 16, R_TAUB = 17, N_ROWS = 18;
constexpr int STALE = -2;
constexpr int R8 = 8;
constexpr int MAX_SV = 512;  // slice subvolumes the kernel takes (shared T_sv)
constexpr int K_ABSORB = 1, K_PERIODIC = 2, K_ROUGH = 3;
constexpr float REMAIN_EPS = 1e-5f;
constexpr float T_BACK = -1e-4f;
constexpr float X_MAX = 80.0f;

// NaN-propagating min/max/clamp: torch.minimum / torch.maximum /
// torch.clamp semantics (fminf/fmaxf would drop a NaN)
__device__ __forceinline__ float min_p(float a, float b) {
  return (a != a) ? a : ((b != b) ? b : (a < b ? a : b));
}
__device__ __forceinline__ float max_p(float a, float b) {
  return (a != a) ? a : ((b != b) ? b : (a > b ? a : b));
}
__device__ __forceinline__ float clamp_max(float x, float hi) { return x > hi ? hi : x; }
__device__ __forceinline__ float clamp_min(float x, float lo) { return x < lo ? lo : x; }

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

__device__ __forceinline__ int sv_of(const float p[3], const MegaCfg& c) {
  const int i = (int)((p[c.slice_axis] - c.lo_b) * c.inv_len);  // truncation
  return i < 0 ? 0 : (i > c.sv - 1 ? c.sv - 1 : i);
}

// slab cast against the six box walls, skipping facet `exclude`
__device__ __forceinline__ void box_cast(const float p[3], const float v[3], int exclude,
                                         const MegaCfg& c, float* t_out, int* f_out) {
  float best_t = INFINITY;
  int best_f = -1;
#pragma unroll
  for (int f = 0; f < 6; ++f) {
    const int a = c.box_axis[f];
    const float va = v[a];
    const bool toward = va * c.box_sign[f] > 0.0f;
    const float t_raw = (c.box_plane[f] - p[a]) / (fabsf(va) > 1e-30f ? va : 1e-30f);
    const float t = clamp_min(t_raw, 0.0f);
    if (toward && t_raw > T_BACK && t < best_t && exclude != f) {
      best_t = t;
      best_f = f;
    }
  }
  *t_out = best_t;
  *f_out = best_f;
}

__device__ __forceinline__ float e_bin(float omega, float dev, float T, const MegaCfg& c) {
  return (c.hbar * omega) * (dev - occ_delta(T, omega, c));
}

__global__ void __launch_bounds__(NK_BLOCK)
mega_lanes(const MegaCfg c, float* __restrict__ pool, const float* __restrict__ T_sv,
           uint8_t* __restrict__ pend_flag, int* __restrict__ pend_cnt,
           int* __restrict__ alive_cnt, float* __restrict__ part_bins,
           float* __restrict__ part_led) {
  const int N = c.n;
  const int nb = gridDim.x;
  const int i = blockIdx.x * NK_BLOCK + threadIdx.x;
  __shared__ float s_T[MAX_SV];  // the subvolume temperatures, per block
  for (int k = threadIdx.x; k < c.sv; k += NK_BLOCK) s_T[k] = T_sv[k];
  __syncthreads();
  bool alive = false, pend = false;
  int seg_bin = -1, seg_led = -1;
  float bv[5] = {0.f, 0.f, 0.f, 0.f, 0.f};
  float led[5] = {0.f, 0.f, 0.f, 0.f, 0.f};

  if (i < N) {
    auto row = [&](int r) -> float& { return pool[(size_t)r * N + i]; };
    float p[3] = {row(0), row(1), row(2)};
    float v[3] = {row(3), row(4), row(5)};
    const float omega = row(C_OMEGA);
    const float tau = row(C_TAU);
    float dev = row(C_DEV);
    uint32_t mode_b = __float_as_uint(row(C_MODE));
    int cf = __float_as_int(row(C_CF));
    float t_coll = row(C_TCOLL);
    int onf = __float_as_int(row(C_ONF));
    const float rem_col = row(C_REM);
    alive = row(C_ALIVE) > 0.5f;
    uint32_t m_mode_b = __float_as_uint(row(R_MMODE));
    const float tau_b = row(R_TAUB);

    // ---- 1. deferred RTA, slope-form lifetime ---------------------------
    const int sv = sv_of(p, c);
    float rem = rem_col > REMAIN_EPS ? rem_col : (alive ? 1.0f : 0.0f);
    const float T_p = s_T[sv];
    const float g = occ_delta(T_p, omega, c);
    const float T_c = T_p < c.tau_tmin ? c.tau_tmin : (T_p > c.tau_tmax ? c.tau_tmax : T_p);
    const float tau_ev = tau + tau_b * T_c;
    const float decay = tau_ev > 0.0f ? expf((-c.dt) / max_p(tau_ev, 1e-12f)) : 0.0f;
    const bool fresh = cf == STALE;
    if (alive && !fresh && c.rta_on) dev = g + (dev - g) * decay;

    // ---- 2. stale-lane ray cast ------------------------------------------
    if (alive && fresh) {
      float tb;
      int fb;
      box_cast(p, v, onf, c, &tb, &fb);
      t_coll = tb / c.dt;
      cf = fb;
    }

    // ---- 3. drift ------------------------------------------------------------
    float sf = alive ? min_p(t_coll, rem) : 0.0f;
    sf = sf < 1e30f ? sf : rem;
    for (int k = 0; k < 3; ++k) p[k] = p[k] + v[k] * (c.dt * sf);
    t_coll = t_coll - sf;
    rem = alive ? max_p(rem - sf, 0.0f) : 0.0f;

    // ---- 4. in-kernel absorb / periodic / specular rounds -----------------
    for (int round = 0; round < 2; ++round) {
      const bool pd = alive && rem > REMAIN_EPS && cf >= 0 && t_coll <= 1e-9f;
      if (!pd) continue;
      const int kind = c.kind[cf];
      bool mv = false;
      if (kind == K_ABSORB) {
        const float* n = c.normal + 3 * cf;
        const float dn_abs = dev - occ_delta(c.value[cf], omega, c);
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
        seg_led = c.res[cf];
        alive = false;
        rem = 0.0f;
      } else if (kind == K_PERIODIC) {
        for (int k = 0; k < 3; ++k) p[k] = p[k] + c.shift[3 * cf + k];
        onf = c.pair[cf];
        mv = true;
      } else if (kind == K_ROUGH && (int)m_mode_b >= 0) {
        // slim-mirror swap: the partner is the exact crystal mirror
        v[c.flip_axis] = -v[c.flip_axis];
        const uint32_t t = mode_b;
        mode_b = m_mode_b;
        m_mode_b = t;
        onf = cf;
        mv = true;
      }
      if (mv) {
        float tb;
        int fb;
        box_cast(p, v, onf, c, &tb, &fb);
        t_coll = tb / c.dt;
        cf = fb;
        float s2 = min_p(t_coll, rem);
        s2 = s2 < 1e30f ? s2 : rem;
        for (int k = 0; k < 3; ++k) p[k] = p[k] + v[k] * (c.dt * s2);
        t_coll = t_coll - s2;
        rem = max_p(rem - s2, 0.0f);
      }
    }

    // ---- 5/6. pending flag, pool write, sums of the lanes that stay --------
    pend = alive && rem > REMAIN_EPS && cf >= 0 && t_coll <= 1e-9f;
    const int sv2 = sv_of(p, c);
    for (int k = 0; k < 3; ++k) {
      row(k) = p[k];
      row(3 + k) = v[k];
    }
    row(C_DEV) = dev;
    row(C_MODE) = __uint_as_float(mode_b);
    row(C_CF) = __int_as_float(cf);
    row(C_TCOLL) = t_coll;
    row(C_ONF) = __int_as_float(onf);
    row(C_REM) = rem;
    row(C_ALIVE) = alive ? 1.0f : 0.0f;
    row(C_SV) = __int_as_float(sv2);
    row(R_MMODE) = __uint_as_float(m_mode_b);
    pend_flag[i] = pend ? 1 : 0;
    if (alive && !pend) {
      const float e = e_bin(omega, dev, s_T[sv2], c);
      seg_bin = sv2;
      bv[0] = e;
      bv[1] = e * v[0];
      bv[2] = e * v[1];
      bv[3] = e * v[2];
      bv[4] = 1.0f;
    }
  }
  const int n_pend = __syncthreads_count(pend);
  const int n_alive = __syncthreads_count(alive);
  if (threadIdx.x == 0) {
    pend_cnt[blockIdx.x] = n_pend;
    alive_cnt[blockIdx.x] = n_alive;
  }
  nk::block_segment_sums(seg_bin, bv, c.sv8, part_bins, nb);
  if (__syncthreads_count(seg_led >= 0) > 0) {
    nk::block_segment_sums(seg_led, led, R8, part_led, nb);
  } else {
    for (int o = threadIdx.x; o < R8 * 5; o += NK_BLOCK)
      part_led[(size_t)o * nb + blockIdx.x] = 0.0f;
  }
}

__global__ void __launch_bounds__(NK_BLOCK)
mega_export(const MegaCfg c, float* __restrict__ pool, const float* __restrict__ T_sv,
            const uint8_t* __restrict__ pend_flag, const int* __restrict__ pend_off,
            float* __restrict__ rows, float* __restrict__ part_frozen) {
  const int N = c.n;
  const int nb = gridDim.x;
  const int i = blockIdx.x * NK_BLOCK + threadIdx.x;
  __shared__ float s_T[MAX_SV];
  for (int k = threadIdx.x; k < c.sv; k += NK_BLOCK) s_T[k] = T_sv[k];
  const bool p = i < N && pend_flag[i] != 0;
  int total;
  const int r = nk::block_rank(p, &total);
  if (total == 0) {  // block-uniform: no pending lane here
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
      uint32_t* dst = reinterpret_cast<uint32_t*>(rows);
      for (int k = 0; k < N_ROWS; ++k) dst[(size_t)k * c.ecap + g] = src[(size_t)k * N + i];
      rows[(size_t)C_ALIVE * c.ecap + g] = 0.0f;
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
  nk::block_segment_sums(seg, bv, c.sv8, part_frozen, nb);
}

__global__ void __launch_bounds__(NK_BLOCK)
sum_ints(const int* __restrict__ a, int n, int* __restrict__ out) {
  __shared__ long long sh[NK_BLOCK];
  long long s = 0;
  for (int j = threadIdx.x; j < n; j += NK_BLOCK) s += a[j];
  sh[threadIdx.x] = s;
  __syncthreads();
  for (int w = NK_BLOCK / 2; w > 0; w >>= 1) {
    if (threadIdx.x < w) sh[threadIdx.x] += sh[threadIdx.x + w];
    __syncthreads();
  }
  if (threadIdx.x == 0) *out = (int)sh[0];
}

}  // namespace

// scratch_f: nb * (2 * sv8 + 8) * 5 floats; scratch_i: 3 * nb + 4 ints;
// pend: N bytes (nb = ceil(N / NK_BLOCK)). counts = [pending, alive, kept].
extern "C" int nk_megastep(const void* cfg, void* pool, const void* T_sv, void* rows,
                           void* counts, void* ledger, void* bins, void* scratch_f,
                           void* scratch_i, void* pend, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const MegaCfg c = *static_cast<const MegaCfg*>(cfg);
  const int nb = (c.n + NK_BLOCK - 1) / NK_BLOCK;
  if (nb == 0) return static_cast<int>(cudaErrorInvalidValue);
  float* part_bins = static_cast<float*>(scratch_f);
  float* part_frozen = part_bins + (size_t)nb * c.sv8 * 5;
  float* part_led = part_frozen + (size_t)nb * c.sv8 * 5;
  int* pend_cnt = static_cast<int*>(scratch_i);
  int* alive_cnt = pend_cnt + nb;
  int* pend_off = alive_cnt + nb;
  int* cnt = static_cast<int*>(counts);
  float* p = static_cast<float*>(pool);
  const float* T = static_cast<const float*>(T_sv);
  uint8_t* flag = static_cast<uint8_t*>(pend);

  mega_lanes<<<nb, NK_BLOCK, 0, s>>>(c, p, T, flag, pend_cnt, alive_cnt, part_bins, part_led);
  nk::scan_counts<<<1, NK_SCAN, 0, s>>>(pend_cnt, nb, pend_off, cnt + 0, c.ecap, cnt + 2);
  mega_export<<<nb, NK_BLOCK, 0, s>>>(c, p, T, flag, pend_off, static_cast<float*>(rows),
                                      part_frozen);
  sum_ints<<<1, NK_BLOCK, 0, s>>>(alive_cnt, nb, cnt + 1);
  nk::reduce_partials<<<c.sv8 * 5, NK_BLOCK, 0, s>>>(part_bins, part_frozen, nb,
                                                      static_cast<float*>(bins));
  nk::reduce_partials<<<R8 * 5, NK_BLOCK, 0, s>>>(part_led, nullptr, nb,
                                                   static_cast<float*>(ledger));
  return static_cast<int>(cudaGetLastError());
}
